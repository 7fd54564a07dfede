"""PyTorch port, the uniform-grid CLI: both packages' `cli.main` on the
same files (the synthetic galaxy at 16^3, angular level 1, 12 sources),
each in its own directory, the port with --platform cpu.  In --x64 the
`time` logs agree within 1e-10 (mode 9) and 1e-9 (mode 8) relative, the
last snapshots' fields within 1e-6 of each field's peak (they are float32
files), the `weight` files byte for byte, `cosmicSpectrum.npz` within
1e-9; the diagnostic modes print the same numbers; a restart of either
CLI from the same snapshot agrees within 1e-10; the f32 runs within 2e-4.
Every refusal of what the port does not run yet is hit once, and each flag
refused until this slice runs one iteration."""

import contextlib
import importlib.util
import io
import os
import re
import shutil

import numpy as np
import pytest
import torch

import chip_smoke
from radiativetransfer_tpu import cli as jcli
from radiativetransfer_tpu_torch import cli as tcli
from radiativetransfer_tpu_torch.core import rays as trays
from radiativetransfer_tpu_torch.io import convert, grid_io
from test_torch_host import jax_compile_cache


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the port's eager ops are small CPU ops, on
    which more threads only spin beside the other test workers (module-
    scoped, so that the module's fixtures run pinned too)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _jax_cache(tmp_path_factory):
    """The JAX package's compiles shared by the port's parity modules of
    this test process (test_torch_host.jax_compile_cache)."""
    with jax_compile_cache(tmp_path_factory.getbasetemp() / "jax_cache"):
        yield


N = 16
# the port's common flags: the CPU, and the JAX CLI's test sizes
_LEVEL = ("--angular-level", "1")
_PIXEL = ("--max-pixel-level", "2")


def _inputs(directory, **kw) -> str:
    os.makedirs(directory, exist_ok=True)
    return chip_smoke.write_cli_inputs(str(directory), N, **kw)


def _run(pkg: str, config: str, outdir, *flags) -> str:
    """One CLI run; its standard output."""
    os.makedirs(outdir, exist_ok=True)
    argv = [config, "--snapshot-dir", str(outdir), *_LEVEL, *flags]
    main = jcli.main
    if pkg == "torch":
        main = tcli.main
        argv += ["--platform", "cpu"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def _time_log(outdir) -> dict[int, float]:
    out = {}
    with open(os.path.join(outdir, "time")) as fh:
        for line in fh:
            m = re.fullmatch(r"itime =\s*(\d+)\s+(\S+)\n", line)
            if m:
                out[int(m.group(1))] = float(m.group(2))
    return out


def _assert_logs_close(a, b, rtol):
    assert a.keys() == b.keys() and a
    for k in a:
        assert abs(a[k] - b[k]) <= rtol * abs(b[k]), (k, a[k], b[k])


def _assert_snapshots_close(pa, pb, tol=1e-6):
    with np.load(pa) as fa, np.load(pb) as fb:
        assert list(fa.keys()) == list(fb.keys())
        for k in fb:
            a, b = fa[k], fb[k]
            assert a.dtype == b.dtype, k
            if a.dtype.kind == "f" and k != "physical_box_size":
                peak = float(np.max(np.abs(b)))
                assert np.max(np.abs(a - b)) <= tol * peak, k
            else:
                np.testing.assert_array_equal(a, b, err_msg=k)


def _fesc(stdout) -> list[str]:
    return re.findall(r"fesc=(\S+)", stdout)


class _Runs:
    """Each (package, mode, flags) run once for the whole module."""

    def __init__(self, root):
        self.root = root
        self.cache = {}

    def __call__(self, pkg, mode, *flags):
        key = (pkg, mode, flags)
        if key not in self.cache:
            d = self.root / f"{pkg}_{mode}_{len(self.cache)}"
            config = _inputs(d, mode=mode)
            self.cache[key] = (_run(pkg, config, d, *flags), d)
        return self.cache[key]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _Runs(tmp_path_factory.mktemp("cli"))


def test_inputs_match_make_test_data(tmp_path):
    """chip_smoke.write_cli_inputs writes what examples/make_test_data.py
    writes (that script imports the JAX package)."""
    spec = importlib.util.spec_from_file_location(
        "make_test_data", os.path.join(os.path.dirname(chip_smoke.__file__),
                                       "examples", "make_test_data.py"))
    mtd = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mtd)
    levels, box = mtd.make_grid(n=N, path=str(tmp_path / "ref"))
    mtd.make_sources(levels, box, path=str(tmp_path / "ref.dat"))
    _inputs(tmp_path / "port")
    got = grid_io.read_level_npz(str(tmp_path / "port" /
                                     "testgrid_velmet.npz"))
    ref = grid_io.read_level_npz(str(tmp_path / "ref.npz"))
    for name in ("pos", "lT", "lnH", "lx", "vel", "abun"):
        a, b = getattr(got[0], name), getattr(ref[0], name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (tmp_path / "port" / "testsources.dat").read_bytes() == \
        (tmp_path / "ref.dat").read_bytes()


def test_mode9_x64_matches_jax(runs):
    flags = ("--iters", "3", "--x64", "--dump-rates")
    (out_t, dt), (out_j, dj) = (runs("torch", 9, *flags),
                                runs("jax", 9, *flags))
    _assert_logs_close(_time_log(dt), _time_log(dj), 1e-10)
    assert len(_time_log(dt)) == 3
    for line in ("mode = 9", "grid: 16^3, box = 300.0 kpc",
                 "wrote rates.out, cool_rates.out"):
        assert line in out_t and line in out_j
    eq = [re.search(r"ionization equilibrium: (\S+)", o).group(1)
          for o in (out_t, out_j)]
    assert abs(float(eq[0]) - float(eq[1])) <= 1e-10 * float(eq[1])
    for name in ("cellArray0001.npz", "cellArray0003.npz"):
        _assert_snapshots_close(dt / name, dj / name)
    for name in ("rates.out", "cool_rates.out"):
        assert (dt / name).read_bytes() == (dj / name).read_bytes()


@pytest.mark.parametrize("mode", [8, 1])
def test_point_source_modes_x64_match_jax(runs, mode):
    flags = ("--iters", "2", "--x64", *_PIXEL)
    (out_t, dt), (out_j, dj) = (runs("torch", mode, *flags),
                                runs("jax", mode, *flags))
    _assert_logs_close(_time_log(dt), _time_log(dj), 1e-9)
    assert (dt / "weight").read_bytes() == (dj / "weight").read_bytes()
    assert len((dt / "weight").read_text().splitlines()) == 12
    assert "nStars/specificAge/non-degenerate = 12 12 12" in out_t
    assert _fesc(out_t) == _fesc(out_j) and len(_fesc(out_t)) == 2
    with np.load(dt / "cosmicSpectrum.npz") as ft, \
            np.load(dj / "cosmicSpectrum.npz") as fj:
        np.testing.assert_array_equal(ft["freq"], fj["freq"])
        np.testing.assert_allclose(ft["spectrum"], fj["spectrum"],
                                   rtol=1e-9, atol=0)
    _assert_snapshots_close(dt / "cellArray0002.npz",
                            dj / "cellArray0002.npz")


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_restart_from_the_same_snapshot(runs, tmp_path, writer):
    """Both CLIs restart from one package's cellArray0003.npz (the latest
    in the directory) for one more iteration."""
    _, src = runs(writer, 9, "--iters", "3", "--x64", "--dump-rates")
    logs, outs = {}, {}
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg
        config = _inputs(d, mode=9, restart=1)
        shutil.copy(src / "cellArray0003.npz", d)
        outs[pkg] = _run(pkg, config, d, "--iters", "1", "--x64")
        logs[pkg] = _time_log(d)
        assert f"restarted from {d}/cellArray0003.npz at itime=3" in \
            outs[pkg]
    assert list(logs["torch"]) == [4]
    _assert_logs_close(logs["torch"], logs["jax"], 1e-10)


@pytest.mark.parametrize("mode,flags", [(2, ("--x64",)), (3, ()), (4, ()),
                                        (7, ())])
def test_diagnostic_modes_match_jax(runs, mode, flags):
    (out_t, dt), (out_j, dj) = runs("torch", mode, *flags), runs("jax", mode,
                                                                 *flags)
    assert out_t == out_j
    assert len(out_t.splitlines()) >= 2
    if mode == 3:
        with np.load(dt / "map.npz") as ft, np.load(dj / "map.npz") as fj:
            np.testing.assert_array_equal(ft["map"], fj["map"])
            assert ft["map"].shape == (N, N)
    if mode == 2:
        assert (dt / "weight").read_bytes() == (dj / "weight").read_bytes()


def test_mode2_f32_bins_as_f64(runs):
    """The density PDFs of an f32 run are binned in float64 (the JAX
    package's f32 run bins no cell: rho / MSUN underflows float32)."""
    out32, _ = runs("torch", 2)
    out64, _ = runs("torch", 2, "--x64")
    assert out32 == out64
    rows = [line.split() for line in out32.splitlines()[3:]]
    assert len(rows) == 50 and sum(float(r[1]) for r in rows) == N ** 3


def test_mode9_f32_matches_jax(runs):
    (_, dt), (_, dj) = runs("torch", 9, "--iters", "2"), runs("jax", 9,
                                                             "--iters", "2")
    _assert_logs_close(_time_log(dt), _time_log(dj), 2e-4)


def test_mode6_unbounded_stops_converged(runs):
    """--iters 0: no bound; the thin-UVB step is a fixed point, so both
    stop at the convergence break on the second iteration."""
    (out_t, dt), (out_j, dj) = (runs("torch", 6, "--iters", "0", "--x64"),
                                runs("jax", 6, "--iters", "0", "--x64"))
    assert out_t.rstrip().endswith("converged")
    assert out_j.rstrip().endswith("converged")
    _assert_logs_close(_time_log(dt), _time_log(dj), 1e-10)


def test_anchor_through_a_restart(tmp_path):
    """The 24^3 mode-9 anchor (one f32 step from the fully neutral uniform
    box, 0.044220) through the CLI: the grid written by the port's
    grid_io, the neutral state restored from cellArray0000.npz after the
    CLI's equilibrium."""
    config = chip_smoke.write_anchor_inputs(str(tmp_path))
    out = _run("torch", config, tmp_path, "--iters", "1")
    assert f"restarted from {tmp_path}/cellArray0000.npz at itime=0" in out
    nf = _time_log(tmp_path)[1]
    assert nf == pytest.approx(chip_smoke.ANCHOR_NF,
                               rel=chip_smoke.ANCHOR_RTOL)


@pytest.mark.parametrize("strategy", ["rdma", "zones", "pipelined"])
def test_mesh_strategies_match_one_device(runs, strategy):
    """--mesh-shape 4: 4 ranks on the one device (the port's P; the JAX
    CLI takes every device), against the run without a mesh."""
    out, d = runs("torch", 9, "--iters", "2", "--x64", "--sweep-strategy",
                  strategy, "--mesh-shape", "4")
    assert f"device mesh: {{'gz': 4}} strategy = {strategy}" in out
    _, one = runs("torch", 9, "--iters", "2", "--x64", "--sweep-logmean",
                  "exact")
    _assert_logs_close(_time_log(d), _time_log(one), 1e-10)


@pytest.mark.parametrize("mode", [7, 4])
def test_fortran_binary_grid(tmp_path, mode):
    """The reference's Fortran level binary (`.dat`) in place of the
    `.npz`: both CLIs print what they print on the `.npz`."""
    from test_torch_io import _write_fortran_levels
    outs = {}
    for pkg in ("torch", "jax"):
        d = tmp_path / pkg
        config = _inputs(d, mode=mode)
        outs[pkg, "npz"] = _run(pkg, config, d)
        levels = grid_io.read_level_npz(str(d / "testgrid_velmet.npz"))
        _write_fortran_levels(str(d / "testgrid_velmet.dat"), levels,
                              metals=True, kinematics=True, empty_tail=0)
        os.remove(d / "testgrid_velmet.npz")
        outs[pkg, "dat"] = _run(pkg, config, d)
    assert outs["torch", "dat"] == outs["jax", "dat"] == \
        outs["torch", "npz"] == outs["jax", "npz"]


def _two_level_grid(directory):
    levels = grid_io.read_level_npz(str(directory / "testgrid_velmet.npz"))
    fine = grid_io.LevelData(pos=levels[0].pos[:8] + 1.0,
                             lT=levels[0].lT[:8], lnH=levels[0].lnH[:8],
                             lx=levels[0].lx[:8])
    grid_io.write_level_npz(str(directory / "testgrid_velmet.npz"),
                            levels + [fine])


def _h4_grid(directory):
    """The grid as the reference's HDF4 container only."""
    npz = directory / "testgrid_velmet.npz"
    with contextlib.redirect_stdout(io.StringIO()):
        convert.npz2h4(str(npz), str(directory / "testgrid_velmet.h4"))
    os.remove(npz)


def _ran_one_iteration(directory, out, flags):
    """A flag the port once refused, run: one iteration, and its mark."""
    assert "itime=1 " in out and list(_time_log(directory)) == [1]
    if "orbax" in flags:
        assert (directory / "ckpt0001" / "ftte_meta.json").exists()
        assert not (directory / "cellArray0001.npz").exists()
    if "--debug-checkify" in flags:
        assert ("checkify pre-flight passed (bounds/NaN/division clean on "
                "the ingested data)") in out.splitlines()
    if "--tracer-compact" in flags:
        assert trays.LAST_COMPACT_BUCKETS[0] == 12 * 48
    if "--mesh-shape" in flags:
        assert "device mesh: {'gz': " in out


# the flags refused until the port ran them keep their ids and run now
# (match None): --ckpt-format orbax, --debug-checkify, --tracer-compact,
# the .h4 grid and point sources on a mesh (a uniform and a two-level
# grid); tests/test_torch_cli_slice.py, test_torch_hdf4.py and
# test_torch_cli_mesh.py hold them to the JAX CLI
@pytest.mark.parametrize("flags,mode,edit,match", [
    pytest.param(("--chemistry", "noneq", "--ckpt-format", "orbax"), 9,
                 None, None, id="flags0-9-None-Remaining I/O"),
    pytest.param(("--chemistry", "noneq", "--mesh-shape", "4"), 8, None,
                 None, id="flags1-8-None-Distribution"),
    pytest.param(("--ckpt-format", "orbax"), 9, None, None,
                 id="flags2-9-None-Remaining I/O"),
    pytest.param(("--debug-checkify",), 9, None, None,
                 id="flags3-9-None-core/debug.py"),
    pytest.param(("--tracer-compact",), 8, None, None,
                 id="flags4-8-None-compacting tracer"),
    (("--coordinator", "localhost:1234"), 9, None, "Distribution"),
    (("--num-processes", "2"), 9, None, "Distribution"),
    (("--mesh-shape", "2,2"), 9, None, "Distribution"),
    pytest.param(("--mesh-shape", "4"), 8, None, None,
                 id="flags8-8-None-Distribution"),
    pytest.param(("--chemistry", "noneq", "--mesh-shape", "2"), 8,
                 _two_level_grid, None,
                 id="flags9-8-_two_level_grid-a mesh on a two-level AMR "
                    "grid"),
    pytest.param((), 9, _h4_grid, None,
                 id="flags10-9-_h4_grid-Remaining I/O"),
])
def test_not_ported_raise_before_any_step(tmp_path, flags, mode, edit,
                                          match):
    config = _inputs(tmp_path, mode=mode)
    if edit is not None:
        edit(tmp_path)
    if match is None:
        trays.LAST_COMPACT_BUCKETS.clear()
        out = _run("torch", config, tmp_path, "--iters", "1", *_PIXEL,
                   *flags)
        _ran_one_iteration(tmp_path, out, flags)
        return
    with pytest.raises(NotImplementedError, match=match):
        _run("torch", config, tmp_path, "--iters", "1", *_PIXEL, *flags)
    assert not (tmp_path / "time").exists()


def test_no_cuda_device_fails_without_platform_cpu(tmp_path, monkeypatch):
    config = _inputs(tmp_path, mode=9)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tcli.main([config, "--snapshot-dir", str(tmp_path), "--iters", "1"])
    assert tcli._parser().parse_args([]).platform == "cuda"
    assert not (tmp_path / "time").exists()


def test_debug_nans_names_the_field(tmp_path):
    config = _inputs(tmp_path, mode=9)
    levels = grid_io.read_level_npz(str(tmp_path / "testgrid_velmet.npz"))
    levels[0].lT[5] = np.nan
    grid_io.write_level_npz(str(tmp_path / "testgrid_velmet.npz"), levels)
    with pytest.raises(FloatingPointError, match=r"state\.\w+ after itime=1"):
        _run("torch", config, tmp_path, "--iters", "2", "--debug-nans")
    assert not (tmp_path / "cellArray0001.npz").exists()


def test_profile_writes_a_trace(tmp_path):
    config = _inputs(tmp_path, mode=9)
    out = _run("torch", config, tmp_path, "--iters", "1", "--profile",
               str(tmp_path / "prof"))
    assert "profiler trace written to" in out
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
