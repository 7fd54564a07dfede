"""PyTorch port, the CLI on block-sparse L-level AMR grids: both packages'
`cli.main` with `--amr-storage sparse` on the same files, the synthetic
galaxy of examples/make_test_data.py at 8^3 with its refined centre and
core (3 data levels: 64 parents refined on each of the base and the 16^3
level, a 32^3 finest level; blocks of 8 cells a side), angular level 1,
each package in its own directory, the port with --platform cpu.

In --x64 mode 9 (2 iterations) the block-sparse `grid:` line and the
`coupling depth:` line (the depth validated on the ingested grid) are
identical, the `time` logs agree within 1e-10 relative and the two
iterations' snapshots (leaf streams with `storage`, `origin_{l}` and
`refined_digest_{l}`) key for key and dtype for dtype, the floats within
1e-10 of each array's peak; each package restarts the other's itime-1
snapshot within 1e-9 (float32 species); mode 6 (2 iterations) and the
diagnostic modes 2 and 7 agree the same way; `--block-edge 4` with
`--sweep-window off` runs the same iterations within 1e-12.  At the
coupling depth mode 9 validated, modes 8 (1 iteration) and 1 (2
iterations) with the galaxy's 12 sources at maxPixelLevel 3: the logs
within 1e-10, the `fesc=` lines and the `weight` files identical,
cosmicSpectrum.npz within 1e-9 of its peak, the snapshots as mode 9's
(the port's mode 8 under --split-compile: the same log, and the JAX
CLI's `  phases:` and `  final-phase alive/chunk:` lines);
`--chemistry noneq` in mode 9 (2 iterations): the `non-equilibrium
chemistry (block-sparse, 3 levels)` line, the logs within 1e-10, the
snapshots with each level's species (`species{l}_*`, level 0 dense, the
refined levels in blocks) within 1e-10 of each array's peak; each
package restarts the other's itime-1 noneq snapshot, fields and species,
within 1e-10.  A mesh on block-sparse storage raises
NotImplementedError naming its ROADMAP item before the grid is
ingested."""

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

N = 8
_FLAGS = ("--angular-level", "1", "--amr-storage", "sparse")
_GRID = ("grid: 8^3 + 2 refined levels, block-sparse (be=8): 1408 leaves, "
         "0.00 GB (dense would be 0.0 GB)")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the eager sweep's small ops, module-scoped
    so that it holds for the module fixtures too."""
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


def _inputs(directory, **kw) -> str:
    os.makedirs(directory, exist_ok=True)
    return chip_smoke.write_cli_inputs(str(directory), N, refine_center=True,
                                       refine_core=True, **kw)


def _run(pkg: str, config: str, outdir, *flags) -> str:
    os.makedirs(outdir, exist_ok=True)
    argv = [config, "--snapshot-dir", str(outdir), *_FLAGS, *flags]
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


def _assert_snapshots_close(path_t, path_j, species=False):
    with np.load(path_t) as ft, np.load(path_j) as fj:
        assert list(ft.keys()) == list(fj.keys())
        assert int(ft["n_levels"]) == 3 and str(ft["storage"]) == "sparse"
        assert len(ft["level"]) == 1408
        assert ("species2_H2I" in ft) == species
        if species:
            assert ft["species0_HI"].shape == (N,) * 3
            assert ft["species1_HI"].shape == ft["species2_HI"].shape == (
                len(ft["origin_1"]) + 1, 8, 8, 8)
            assert ft["species2_HI"].dtype == np.float64
        for k in fj:
            a, b = ft[k], fj[k]
            assert a.dtype == b.dtype, k
            if a.dtype.kind == "f" and a.ndim:
                peak = float(np.abs(b).max())
                assert np.abs(a - b).max() <= 1e-10 * peak, k
            else:
                np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.fixture(scope="module")
def mode9(tmp_path_factory):
    """Each package's mode-9 run, 2 iterations in --x64: (stdout, dir)."""
    root = tmp_path_factory.mktemp("sparse_cli")
    out = {}
    for pkg in ("torch", "jax"):
        d = root / pkg
        out[pkg] = (_run(pkg, _inputs(d), d, "--iters", "2", "--x64"), d)
    return out


def test_mode9_x64_matches_jax(mode9):
    (out_t, dt), (out_j, dj) = mode9["torch"], mode9["jax"]
    _assert_logs_close(_time_log(dt), _time_log(dj))
    assert list(_time_log(dt)) == [1, 2]
    for prefix in ("grid:", "coupling depth:"):
        lines = [[x for x in o.splitlines() if x.startswith(prefix)]
                 for o in (out_t, out_j)]
        assert lines[0] and lines[0] == lines[1], prefix
    assert _GRID in out_t.splitlines()
    assert re.search(r"^coupling depth: [1-6] \(validated on the ingested "
                     r"grid, residual < 1e-8\)$", out_t, re.M)
    eq = [float(re.search(r"ionization equilibrium: (\S+)", o).group(1))
          for o in (out_t, out_j)]
    assert abs(eq[0] - eq[1]) <= 1e-10 * eq[1]
    for name in ("cellArray0001.npz", "cellArray0002.npz"):
        _assert_snapshots_close(dt / name, dj / name)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_restart_across_packages(mode9, tmp_path, writer):
    """The other package restarts from the writer's itime-1 snapshot at the
    writer's validated depth; its itime 2 is the writer's within 1e-9 (the
    snapshot's species are float32)."""
    reader = "torch" if writer == "jax" else "jax"
    out_w, src = mode9[writer]
    depth = re.search(r"coupling depth: (\d+)", out_w).group(1)
    d = tmp_path / reader
    config = _inputs(d, restart=1)
    shutil.copy(src / "cellArray0001.npz", d)
    out = _run(reader, config, d, "--iters", "1", "--x64",
               "--coupling-depth", depth)
    assert f"coupling depth: {depth} (fixed)" in out.splitlines()
    assert f"restarted from {d}/cellArray0001.npz at itime=1" in out
    log = _time_log(d)
    assert list(log) == [2]
    _assert_logs_close(log, {2: _time_log(src)[2]}, rtol=1e-9)
    assert (d / "cellArray0002.npz").exists()


def test_block_edge_and_window_flags(mode9, tmp_path):
    """Blocks of 4 cells a side and the full-plane stack: the same
    iterations as the default run's."""
    out_t, dt = mode9["torch"]
    depth = re.search(r"coupling depth: (\d+)", out_t).group(1)
    out = _run("torch", _inputs(tmp_path), tmp_path, "--iters", "2", "--x64",
               "--block-edge", "4", "--sweep-window", "off",
               "--coupling-depth", depth)
    assert "block-sparse (be=4): 1408 leaves" in out
    _assert_logs_close(_time_log(tmp_path), _time_log(dt), rtol=1e-12)


def test_mode6_x64_matches_jax(tmp_path):
    """The thin UVB on every level (no sweep, no coupling depth)."""
    logs, outs = {}, {}
    for pkg in ("torch", "jax"):
        d = tmp_path / pkg
        outs[pkg] = _run(pkg, _inputs(d, mode=6), d, "--iters", "2", "--x64")
        logs[pkg] = _time_log(d)
        assert _GRID in outs[pkg].splitlines()
        assert "coupling depth" not in outs[pkg]
    _assert_logs_close(logs["torch"], logs["jax"])
    _assert_snapshots_close(tmp_path / "torch" / "cellArray0002.npz",
                            tmp_path / "jax" / "cellArray0002.npz")


@pytest.mark.parametrize("mode", [2, 7])
def test_diagnostic_modes_match_jax(tmp_path, mode):
    outs = {}
    for pkg in ("torch", "jax"):
        d = tmp_path / pkg
        outs[pkg] = _run(pkg, _inputs(d, mode=mode), d, "--x64")
    assert outs["torch"] == outs["jax"]
    assert _GRID in outs["torch"].splitlines()


_STARS = ("--x64", "--max-pixel-level", "3")
_NONEQ = ("--x64", "--chemistry", "noneq")
# the runs with sources or the noneq network: name -> (mode, iterations,
# flags)
_RUNS = {"mode8": (8, 1, _STARS), "mode1": (1, 2, _STARS),
         "noneq9": (9, 2, _NONEQ)}


@pytest.fixture(scope="module")
def runs(mode9, tmp_path_factory):
    """Each package's _RUNS at the coupling depth mode 9 validated (the
    JAX CLI's validation takes ~40 s a run): {(pkg, name): (stdout,
    dir)}."""
    depth = re.search(r"coupling depth: (\d+)", mode9["jax"][0]).group(1)
    root = tmp_path_factory.mktemp("sparse_cli_runs")
    out = {}
    for name, (mode, iters, flags) in _RUNS.items():
        for pkg in ("torch", "jax"):
            d = root / f"{pkg}_{name}"
            out[pkg, name] = (_run(pkg, _inputs(d, mode=mode), d, "--iters",
                                   str(iters), "--coupling-depth", depth,
                                   *flags), d)
    return out


@pytest.mark.parametrize("name", ["mode8", "mode1"])
def test_point_source_modes_x64_match_jax(runs, name):
    (out_t, dt), (out_j, dj) = runs["torch", name], runs["jax", name]
    iters = _RUNS[name][1]
    _assert_logs_close(_time_log(dt), _time_log(dj))
    assert list(_time_log(dt)) == list(range(1, iters + 1))
    assert _GRID in out_t.splitlines()
    assert ("coupling depth: " in out_t) == (name == "mode8")
    assert "nStars/specificAge/non-degenerate = 12 12 12" in out_t
    assert (dt / "weight").read_bytes() == (dj / "weight").read_bytes()
    fesc = [re.findall(r"fesc=(\S+)", o) for o in (out_t, out_j)]
    assert fesc[0] == fesc[1] and len(fesc[0]) == iters
    with np.load(dt / "cosmicSpectrum.npz") as ft, \
            np.load(dj / "cosmicSpectrum.npz") as fj:
        np.testing.assert_array_equal(ft["freq"], fj["freq"])
        peak = float(np.abs(fj["spectrum"]).max())
        assert peak > 0.0
        np.testing.assert_allclose(ft["spectrum"], fj["spectrum"], rtol=0,
                                   atol=1e-9 * peak)
    name_it = f"cellArray{iters:04d}.npz"
    _assert_snapshots_close(dt / name_it, dj / name_it)


def test_split_compile_prints_phases(runs, tmp_path):
    """--split-compile (host-driven tracer phases, each phase waited for)
    runs mode 8's iteration to the same log, and prints the JAX CLI's
    phase lines: the tracer, sweep and chemistry_sync seconds, the
    tracer's by phase, its last phase's alive counts."""
    out_t, dt = runs["torch", "mode8"]
    depth = re.search(r"coupling depth: (\d+)", out_t).group(1)
    out = _run("torch", _inputs(tmp_path, mode=8), tmp_path, "--iters", "1",
               "--coupling-depth", depth, "--split-compile", *_STARS)
    _assert_logs_close(_time_log(tmp_path), _time_log(dt), rtol=1e-12)
    lines = out.splitlines()
    phases = [x for x in lines if x.startswith("  phases: ")]
    assert len(phases) == 1 and re.fullmatch(
        r"  phases: tracer=\S+s sweep=\S+s chemistry_sync=\S+s "
        r"level1=\S+s level2=\S+s level3=\S+s", phases[0]), phases
    alive = [x for x in lines if x.startswith("  final-phase alive/chunk: ")]
    assert len(alive) == 1 and re.fullmatch(
        r"  final-phase alive/chunk: ([1-9]\d*/)*0", alive[0]), alive
    assert lines.index(phases[0]) < lines.index(alive[0]) < next(
        i for i, x in enumerate(lines) if x.startswith("itime=1 "))


def test_noneq_x64_matches_jax(runs):
    (out_t, dt), (out_j, dj) = runs["torch", "noneq9"], runs["jax", "noneq9"]
    _assert_logs_close(_time_log(dt), _time_log(dj))
    assert list(_time_log(dt)) == [1, 2]
    line = ("non-equilibrium chemistry (block-sparse, 3 levels): dt = 1.0 "
            "Myr, evolve_energy = False")
    assert line in out_t.splitlines() and line in out_j.splitlines()
    assert _GRID in out_t.splitlines()
    for it in (1, 2):
        name = f"cellArray{it:04d}.npz"
        _assert_snapshots_close(dt / name, dj / name, species=True)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_noneq_restart_across_packages(runs, tmp_path, writer):
    """The other package restarts the writer's itime-1 noneq snapshot,
    fields and species, at the writer's coupling depth: its itime 2 is the
    writer's within 1e-10."""
    reader = "torch" if writer == "jax" else "jax"
    out_w, src = runs[writer, "noneq9"]
    depth = re.search(r"coupling depth: (\d+)", out_w).group(1)
    d = tmp_path / reader
    config = _inputs(d, restart=1)
    shutil.copy(src / "cellArray0001.npz", d)
    out = _run(reader, config, d, "--iters", "1", *_NONEQ,
               "--coupling-depth", depth)
    assert f"restarted from {d}/cellArray0001.npz at itime=1" in out
    assert "restored 9-species noneq state from snapshot" in out
    log = _time_log(d)
    assert list(log) == [2]
    _assert_logs_close(log, {2: _time_log(src)[2]})


# the mesh case keeps the id it had beside the point-source and noneq
# refusals: all three run now
@pytest.mark.parametrize("flags,mode,match", [
    pytest.param(
        ("--mesh-shape", "2"), 9, None,
        id="flags3-9-^a mesh on a block-sparse AMR grid \\(shard_sparse_"
           "state, diffuse_sweep_sparse_zones\\) is not ported yet: "
           "ROADMAP, Distribution$"),
    (("--mesh-shape", "2", "--tracer-strategy", "domain"), 8,
     r"--tracer-strategy domain .*rays_domain.*ROADMAP, Distribution$"),
])
def test_refusals_raise_before_any_work(tmp_path, monkeypatch, flags, mode,
                                        match):
    """Each raises NotImplementedError naming the ROADMAP item that refuses
    the run, before the grid is ingested and before any step (modes 8 and
    1 and --chemistry noneq, refused here until they were ported, run in
    the tests above); a mesh, once refused, runs an iteration (the zones
    sweep on 2 ranks)."""
    from radiativetransfer_tpu_torch.core import amr_sparse
    if match is None:
        out = _run("torch", _inputs(tmp_path, mode=mode), tmp_path,
                   "--iters", "1", *flags)
        assert _GRID in out.splitlines()
        assert ("block-sparse deep AMR distributed over 2 devices: zones "
                "sweep (direction chunks + psum) + source-parallel tracer"
                in out.splitlines())
        assert list(_time_log(tmp_path)) == [1]
        return

    def no_ingestion(*args, **kwargs):
        raise AssertionError("the grid was ingested")
    monkeypatch.setattr(amr_sparse, "sparse_from_level_lists", no_ingestion)
    config = _inputs(tmp_path, mode=mode)
    with pytest.raises(NotImplementedError, match=match):
        _run("torch", config, tmp_path, "--iters", "1", *flags)
    assert not (tmp_path / "time").exists()
