"""PyTorch port, the CLI on two-level AMR grids: both packages' `cli.main`
on the same files, the synthetic galaxy of examples/make_test_data.py at
12^3 with its refined centre (216 parents, a 24^3 fine level), angular
level 1, each package in its own directory, the port with --platform cpu.

In --x64 mode 9 the `time` logs agree within 1e-10 relative and the two
iterations' snapshots (cellArray leaf streams, float32) within 1e-10 of
each array's peak; a snapshot of either package restarts the other within
1e-10; modes 8 and 1 (the 12 sources traced through both levels, at 16^3,
where the fine grid keeps the JAX tracer's float32 cell faces exact, and
maxPixelLevel 3) the same, with the `fesc=` lines equal, the `weight`
files identical and `cosmicSpectrum.npz` within 1e-9, and a mode-8
snapshot restarts the other package; mode 6 stops converged on both
sides; the diagnostic modes 2, 4 and 7 print the same lines; a 3-level
grid under --amr-depth 2 runs two-level, as in JAX.  Every refusal on a
nested grid raises before any work, naming its ROADMAP item."""

import contextlib
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
from test_torch_host import jax_compile_cache

N = 12
_LEVEL = ("--angular-level", "1")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the eager two-level sweep is ~10^5 small CPU
    ops an iteration, on which more threads only spin.  Module-scoped, so
    that it also holds for the module's fixtures (mode9, point_runs),
    which a function-scoped one would only follow: run with 8 threads,
    point_runs' mode-8 port run took 4x the CPU time for the same wall
    time alone, and 273 s beside the other test workers."""
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


def _inputs(directory, n=N, core=False, **kw) -> str:
    os.makedirs(directory, exist_ok=True)
    return chip_smoke.write_cli_inputs(str(directory), n, refine_center=True,
                                       refine_core=core, **kw)


def _run(pkg: str, config: str, outdir, *flags) -> str:
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


def _assert_logs_close(a, b, rtol=1e-10):
    assert a.keys() == b.keys() and a
    for k in a:
        assert abs(a[k] - b[k]) <= rtol * abs(b[k]), (k, a[k], b[k])


@pytest.fixture(scope="module")
def mode9(tmp_path_factory):
    """Each package's mode-9 run, 2 iterations in --x64: (stdout, dir)."""
    root = tmp_path_factory.mktemp("amr_cli")
    out = {}
    for pkg in ("torch", "jax"):
        d = root / pkg
        out[pkg] = (_run(pkg, _inputs(d), d, "--iters", "2", "--x64"), d)
    return out


def _assert_snapshots_close(path_t, path_j, n=N):
    """Two cellArray leaf streams: the same keys and dtypes, the float
    arrays within 1e-10 of each array's peak, the rest equal."""
    parents = (n // 2) ** 3
    with np.load(path_t) as ft, np.load(path_j) as fj:
        assert list(ft.keys()) == list(fj.keys())
        assert len(ft["level"]) == n ** 3 - parents + 8 * parents
        for k in fj:
            a, b = ft[k], fj[k]
            assert a.dtype == b.dtype, k
            if a.dtype.kind == "f" and a.ndim:
                peak = float(np.abs(b).max())
                assert np.abs(a - b).max() <= 1e-10 * peak, k
            else:
                np.testing.assert_array_equal(a, b, err_msg=k)


def test_mode9_x64_matches_jax(mode9):
    (out_t, dt), (out_j, dj) = mode9["torch"], mode9["jax"]
    _assert_logs_close(_time_log(dt), _time_log(dj))
    assert list(_time_log(dt)) == [1, 2]
    for line in ("grid: 12^3 + refined level (216 parents)",
                 "grid: 12^3, box = 300.0 kpc"):
        assert line in out_t and line in out_j
    eq = [float(re.search(r"ionization equilibrium: (\S+)", o).group(1))
          for o in (out_t, out_j)]
    assert abs(eq[0] - eq[1]) <= 1e-10 * eq[1]
    for name in ("cellArray0001.npz", "cellArray0002.npz"):
        _assert_snapshots_close(dt / name, dj / name)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_restart_across_packages(mode9, tmp_path, writer):
    """The other package restarts from the writer's itime-1 snapshot; its
    itime 2 is the writer's within 1e-10."""
    reader = "torch" if writer == "jax" else "jax"
    _, src = mode9[writer]
    d = tmp_path / reader
    config = _inputs(d, restart=1)
    shutil.copy(src / "cellArray0001.npz", d)
    out = _run(reader, config, d, "--iters", "1", "--x64")
    assert f"restarted from {d}/cellArray0001.npz at itime=1" in out
    log = _time_log(d)
    assert list(log) == [2]
    _assert_logs_close(log, {2: _time_log(src)[2]})


N_STARS = 16
_STARS = ("--x64", "--max-pixel-level", "3")


@pytest.fixture(scope="module")
def point_runs(tmp_path_factory):
    """Each package's mode-8 and mode-1 runs at 16^3, 2 iterations:
    {(pkg, mode): (stdout, dir)}."""
    root = tmp_path_factory.mktemp("amr_cli_stars")
    out = {}
    for mode in (8, 1):
        for pkg in ("torch", "jax"):
            d = root / f"{pkg}{mode}"
            out[pkg, mode] = (_run(pkg, _inputs(d, n=N_STARS, mode=mode), d,
                                   "--iters", "2", *_STARS), d)
    return out


def _fesc(stdout) -> list[str]:
    return re.findall(r"fesc=(\S+)", stdout)


@pytest.mark.parametrize("mode", [8, 1])
def test_point_source_modes_x64_match_jax(point_runs, mode):
    (out_t, dt), (out_j, dj) = point_runs["torch", mode], point_runs["jax",
                                                                     mode]
    _assert_logs_close(_time_log(dt), _time_log(dj))
    assert list(_time_log(dt)) == [1, 2]
    assert "grid: 16^3 + refined level (512 parents)" in out_t
    assert (dt / "weight").read_bytes() == (dj / "weight").read_bytes()
    assert "nStars/specificAge/non-degenerate = 12 12 12" in out_t
    assert _fesc(out_t) == _fesc(out_j) and len(_fesc(out_t)) == 2
    with np.load(dt / "cosmicSpectrum.npz") as ft, \
            np.load(dj / "cosmicSpectrum.npz") as fj:
        np.testing.assert_array_equal(ft["freq"], fj["freq"])
        assert float(np.abs(fj["spectrum"]).max()) > 0.0
        np.testing.assert_allclose(
            ft["spectrum"], fj["spectrum"], rtol=0,
            atol=1e-9 * float(np.abs(fj["spectrum"]).max()))
    _assert_snapshots_close(dt / "cellArray0002.npz",
                            dj / "cellArray0002.npz", n=N_STARS)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_mode8_restart_across_packages(point_runs, tmp_path, writer):
    """The other package restarts mode 8 from the writer's itime-1
    snapshot; its itime 2 is the writer's within 1e-10."""
    reader = "torch" if writer == "jax" else "jax"
    _, src = point_runs[writer, 8]
    d = tmp_path / reader
    config = _inputs(d, n=N_STARS, mode=8, restart=1)
    shutil.copy(src / "cellArray0001.npz", d)
    out = _run(reader, config, d, "--iters", "1", *_STARS)
    assert f"restarted from {d}/cellArray0001.npz at itime=1" in out
    assert len(_fesc(out)) == 1
    log = _time_log(d)
    assert list(log) == [2]
    _assert_logs_close(log, {2: _time_log(src)[2]})


def test_mode6_x64_matches_jax(tmp_path):
    """The thin UVB on both levels (no sweep): a fixed point, so both stop
    at the convergence break on the second iteration."""
    logs, outs = {}, {}
    for pkg in ("torch", "jax"):
        d = tmp_path / pkg
        outs[pkg] = _run(pkg, _inputs(d, n=8, mode=6), d, "--iters", "3",
                         "--x64")
        logs[pkg] = _time_log(d)
    assert outs["torch"].rstrip().endswith("converged")
    assert outs["jax"].rstrip().endswith("converged")
    _assert_logs_close(logs["torch"], logs["jax"])


def test_debug_nans_and_profile_on_two_levels(tmp_path):
    config = _inputs(tmp_path, n=8)
    out = _run("torch", config, tmp_path, "--iters", "1", "--debug-nans",
               "--profile", str(tmp_path / "prof"))
    assert "profiler trace written to" in out
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert (tmp_path / "cellArray0001.npz").exists()


@pytest.mark.parametrize("mode", [2, 4, 7])
def test_diagnostic_modes_match_jax(tmp_path, mode):
    outs = {}
    for pkg in ("torch", "jax"):
        d = tmp_path / pkg
        outs[pkg] = _run(pkg, _inputs(d, mode=mode), d, "--x64")
    assert outs["torch"] == outs["jax"]
    assert len(outs["torch"].splitlines()) >= 3
    if mode == 4:
        assert f"level = 2  cells = {8 * 216}" in outs["torch"]
    else:
        assert "grid: 12^3 + refined level (216 parents)" in outs["torch"]
    if mode == 2:
        assert (tmp_path / "torch" / "weight").read_bytes() == \
            (tmp_path / "jax" / "weight").read_bytes()


def test_three_levels_under_amr_depth_2_run_two_level(tmp_path):
    logs, outs = {}, {}
    for pkg in ("torch", "jax"):
        d = tmp_path / pkg
        outs[pkg] = _run(pkg, _inputs(d, n=8, core=True), d, "--iters", "1",
                         "--x64", "--amr-depth", "2")
        logs[pkg] = _time_log(d)
    for out in outs.values():
        assert "grid: 8^3 + refined level (64 parents)" in out
    _assert_logs_close(logs["torch"], logs["jax"])


_MESH_ID = (r"a mesh on a two-level AMR grid \(shard_amr_state\) is not "
            r"ported yet: ROADMAP, Distribution$")


@pytest.mark.parametrize("flags,mode,core,match", [
    # refused until the port ran them: their ids kept, each runs one
    # iteration on the two-level grid (match None)
    pytest.param(("--chemistry", "noneq", "--mesh-shape", "4"), 9, False,
                 None, id="flags0-9-False-" + _MESH_ID),
    pytest.param(("--mesh-shape", "4"), 9, False, None,
                 id="flags1-9-False-" + _MESH_ID),
    pytest.param(("--sweep-strategy", "zones"), 6, False, None,
                 id="flags2-6-False-" + _MESH_ID),
    pytest.param(("--debug-checkify",), 9, False, None,
                 id="flags3-9-False---debug-checkify is not ported yet: "
                    "ROADMAP, core/debug\\.py$"),
    pytest.param(("--ckpt-format", "orbax"), 9, False, None,
                 id="flags4-9-False---ckpt-format orbax is not ported yet: "
                    "ROADMAP, Remaining I/O \\(io/checkpoint\\.py\\)$"),
    # what stays refused on a mesh
    (("--mesh-shape", "4", "--tracer-strategy", "domain"), 8, False,
     r"--tracer-strategy domain .*rays_domain.*ROADMAP, Distribution$"),
    (("--mesh-shape", "2,2"), 9, False,
     r"2-D meshes are not ported yet: ROADMAP, Distribution$"),
])
def test_refusals_raise_before_any_work(tmp_path, monkeypatch, flags, mode,
                                        core, match):
    """Each raises NotImplementedError naming the ROADMAP item that refuses
    the run, before the grid is ingested and before any step; the flags
    once refused run an iteration on the two-level grid (a mesh of P
    ranks: the tracer source-parallel, the rest as on one device)."""
    from radiativetransfer_tpu_torch.core import amr, amr_sparse
    config = _inputs(tmp_path, n=8, core=core, mode=mode)
    if match is None:
        out = _run("torch", config, tmp_path, "--iters", "1", *flags)
        assert "grid: 8^3 + refined level (64 parents)" in out
        assert list(_time_log(tmp_path)) == [1]
        if "--debug-checkify" in flags:
            assert ("checkify pre-flight passed on two-level AMR storage"
                    in out.splitlines())
        elif "--ckpt-format" in flags:
            assert (tmp_path / "ckpt0001" / "ftte_meta.json").exists()
        else:
            assert "device mesh: {'gz': " in out
        if "noneq" in flags:
            assert ("non-equilibrium chemistry (2 levels): dt = 1.0 Myr, "
                    "evolve_energy = False, mesh = (4,)") in out.splitlines()
        return

    def no_ingestion(*args, **kwargs):
        raise AssertionError("the grid was ingested")
    monkeypatch.setattr(amr, "amr_from_levels", no_ingestion)
    monkeypatch.setattr(amr, "multilevel_from_levels", no_ingestion)
    monkeypatch.setattr(amr_sparse, "sparse_from_level_lists",
                        no_ingestion)
    with pytest.raises(NotImplementedError, match=match):
        _run("torch", config, tmp_path, "--iters", "1", *flags)
    assert not (tmp_path / "time").exists()
