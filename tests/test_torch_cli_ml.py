"""PyTorch port, the CLI on L-level AMR grids: both packages' `cli.main` on
the same files, the synthetic galaxy of examples/make_test_data.py at 8^3
with its refined centre and core (3 data levels: 64 cells refined on each
of the base and the 16^3 level, a 32^3 finest level), angular level 1,
each package in its own directory, the port with --platform cpu.

In --x64 mode 9 the `grid:` and `coupling depth:` lines are identical (the
depth validated on the ingested grid), the `time` logs agree within 1e-10
relative and the two iterations' snapshots (cellArray leaf streams with
`n_levels` and `refined_{l}`) key for key and dtype for dtype, the floats
within 1e-10 of each array's peak; a snapshot of either package restarts
the other within 1e-9 (float32 species; under --coupling-depth, the depth
the writer validated); mode 6 runs on both; the diagnostic modes 2 and 7 print the
same lines.  Modes 8 and 1 (maxPixelLevel 3, the galaxy's 12 sources):
logs within 1e-10, the `fesc=` lines and `weight` files identical,
cosmicSpectrum.npz within 1e-9.  `--chemistry noneq` on the L-level grid
(at the coupling depth mode 9 validated) and on the two-level one (the
galaxy without its core; MultiLevelModel(2) at the default coupling
depth, no `coupling depth:` line): mode 9 (2
iterations) and mode 8 (1 iteration, the 12 sources at maxPixelLevel 3:
the `fesc=` lines identical, cosmicSpectrum.npz within 1e-9), logs
within 1e-10, the snapshots (with each level's species,
`species{l}_*`) key for key within 1e-10 of each array's peak; the port
restarts either package's noneq snapshot, and the JAX CLI the port's
L-level one, within 1e-10 (the JAX CLI cannot restart a two-level noneq
run: ROADMAP section 3).  The storage choice (dense, or block-sparse above 4e9 bytes)
follows the JAX CLI's formula, and every refusal on an L-level grid
raises before the grid is ingested, naming its ROADMAP item.  The JAX
CLI's sweeps run compiled (its coupling-depth validation runs them op by
op otherwise, ~5 s a sweep)."""

import contextlib
import io
import os
import re
import shutil
import types

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from radiativetransfer_tpu import cli as jcli
from radiativetransfer_tpu.core import sweep_multilevel as jsm
from radiativetransfer_tpu_torch import cli as tcli
from test_torch_host import jax_compile_cache

N = 8
_LEVEL = ("--angular-level", "1")
_GRID = "grid: 8^3 + 2 refined levels (refined parents per level: [64, 64])"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the eager L-level sweep is ~10^5 small CPU ops
    an iteration, on which more threads only spin.  Module-scoped, so that
    it also holds for the mode9 fixture (with 8 threads it took 904 s of a
    whole test run beside the other workers)."""
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


@pytest.fixture(scope="module", autouse=True)
def _jax_sweeps_compiled():
    """The JAX package's L-level sweep compiled once per coupling depth
    and plan (the same code, run as XLA programs), shared by the runs'
    equal plans: build_ml_sweep_plan's are a function of the directions,
    the base's width and the depth."""
    sweep, cache = jsm.diffuse_sweep_multilevel, {}

    def compiled(kappas, refined, plan, uvb, cell_size, n_coupling_iters=4):
        key = (plan.n_directions, plan.nslab, plan.n_levels,
               n_coupling_iters)
        if key not in cache:
            cache[key] = (plan, jax.jit(lambda ks, rs, u, c: sweep(
                ks, rs, plan, u, c, n_coupling_iters)))
        return cache[key][1](kappas, refined, uvb, cell_size)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsm, "diffuse_sweep_multilevel", compiled)
        yield


def _inputs(directory, n=N, refine_core=True, **kw) -> str:
    os.makedirs(directory, exist_ok=True)
    return chip_smoke.write_cli_inputs(str(directory), n, refine_center=True,
                                       refine_core=refine_core, **kw)


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
    root = tmp_path_factory.mktemp("ml_cli")
    out = {}
    for pkg in ("torch", "jax"):
        d = root / pkg
        out[pkg] = (_run(pkg, _inputs(d), d, "--iters", "2", "--x64"), d)
    return out


def _assert_snapshots_close(path_t, path_j):
    with np.load(path_t) as ft, np.load(path_j) as fj:
        assert list(ft.keys()) == list(fj.keys())
        assert int(ft["n_levels"]) == 3
        r0, r1 = (int(ft[f"refined_{ell}"].sum()) for ell in (0, 1))
        assert (r0, r1) == (64, 64)
        assert len(ft["level"]) == N ** 3 - r0 + 8 * r0 - r1 + 8 * r1
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
    for prefix in ("grid:", "coupling depth:", "ionization"):
        lines = [[x for x in o.splitlines() if x.startswith(prefix)]
                 for o in (out_t, out_j)]
        assert lines[0] and len(lines[0]) == len(lines[1])
        if prefix != "ionization":
            assert lines[0] == lines[1], prefix
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
    snapshot's species are float32: the run that continued in float64
    differs by 3e-10 of the neutral fraction either way)."""
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


def test_mode6_x64_matches_jax(tmp_path):
    """The thin UVB on every level (no sweep, no coupling depth)."""
    logs, outs = {}, {}
    for pkg in ("torch", "jax"):
        d = tmp_path / pkg
        outs[pkg] = _run(pkg, _inputs(d, mode=6), d, "--iters", "2",
                         "--x64")
        logs[pkg] = _time_log(d)
        assert _GRID in outs[pkg].splitlines()
        assert "coupling depth" not in outs[pkg]
    _assert_logs_close(logs["torch"], logs["jax"])


@pytest.mark.parametrize("mode", [2, 7])
def test_diagnostic_modes_match_jax(tmp_path, mode):
    outs = {}
    for pkg in ("torch", "jax"):
        d = tmp_path / pkg
        outs[pkg] = _run(pkg, _inputs(d, mode=mode), d, "--x64")
    assert outs["torch"] == outs["jax"]
    assert _GRID in outs["torch"].splitlines()


def test_storage_choice_follows_the_jax_formula():
    """Dense while the levels' 17 fields fit in 4e9 bytes (8 bytes each
    under --x64, 4 else), block-sparse above it or when asked, whatever
    the chemistry; two levels, or --amr-depth 2, take the two-level
    path."""
    def levels(*ncells):
        return [types.SimpleNamespace(ncell=c) for c in ncells]

    def args(**kw):
        return tcli._parser().parse_args(["cfg", *kw.pop("flags", [])])

    # 80^3 + 160^3 + 320^3 cells of 17 fields: 2.54e9 bytes in f32, under
    # the limit, 5.08e9 in f64, over it
    deep = levels(80 ** 3, 8, 8)
    assert tcli._nesting(deep, args()) == "ml"
    assert tcli._nesting(deep, args(flags=["--x64"])) == "sparse"
    assert tcli._nesting(deep, args(flags=["--x64", "--chemistry",
                                           "noneq"])) == "sparse"
    assert tcli._nesting(deep, args(flags=["--x64", "--amr-storage",
                                           "dense"])) == "ml"
    assert tcli._nesting(levels(8, 8, 8), args(flags=["--amr-storage",
                                                      "sparse"])) \
        == "sparse"
    assert tcli._nesting(deep, args(flags=["--amr-depth", "2"])) == "amr"
    assert tcli._nesting(levels(8, 8), args()) == "amr"
    assert tcli._nesting(levels(8, 0, 0), args()) == "uniform"


_MESH = (r"a mesh on an L-level AMR grid \(shard_multilevel_state\) is not "
         r"ported yet: ROADMAP, Distribution$")


@pytest.mark.parametrize("flags,mode,match", [
    # refused until the port ran them: their ids kept, each runs one
    # iteration on the L-level grid (match None)
    pytest.param(("--mesh-shape", "2"), 8, None, id="flags0-8-" + _MESH),
    pytest.param(("--mesh-shape", "2"), 1, None, id="flags1-1-" + _MESH),
    pytest.param(("--chemistry", "noneq", "--mesh-shape", "2"), 9, None,
                 id="flags2-9-" + _MESH),
    pytest.param(("--mesh-shape", "4"), 9, None, id="flags3-9-" + _MESH),
    pytest.param(("--sweep-strategy", "zones"), 6, None,
                 id="flags4-6-" + _MESH),
    # what stays refused on a mesh
    (("--mesh-shape", "2", "--tracer-strategy", "domain"), 1,
     r"--tracer-strategy domain .*rays_domain.*ROADMAP, Distribution$"),
    (("--mesh-shape", "2,4"), 8,
     r"2-D meshes are not ported yet: ROADMAP, Distribution$"),
    (("--coordinator", "localhost:1234"), 9,
     r"--coordinator .*ROADMAP, Distribution \(ranks on several cards\)$"),
])
def test_refusals_raise_before_any_work(tmp_path, monkeypatch, flags, mode,
                                        match):
    """Each raises NotImplementedError naming the ROADMAP item that refuses
    the run, before the grid is ingested and before any step; the flags
    once refused run an iteration on the L-level grid (a mesh: the tracer
    source-parallel, the sweep and the chemistry as on one device)."""
    from radiativetransfer_tpu_torch.core import amr, amr_sparse
    if match is None:
        out = _run("torch", _inputs(tmp_path, n=8, mode=mode), tmp_path,
                   "--iters", "1", "--max-pixel-level", "2", *flags)
        assert _GRID in out.splitlines()
        assert "device mesh: {'gz': " in out
        assert list(_time_log(tmp_path)) == [1]
        return

    def no_ingestion(*args, **kwargs):
        raise AssertionError("the grid was ingested")
    monkeypatch.setattr(amr, "multilevel_from_levels", no_ingestion)
    monkeypatch.setattr(amr_sparse, "sparse_from_level_lists",
                        no_ingestion)
    monkeypatch.setattr(amr, "amr_from_levels", no_ingestion)
    config = _inputs(tmp_path, n=8, mode=mode)
    with pytest.raises(NotImplementedError, match=match):
        _run("torch", config, tmp_path, "--iters", "1", *flags)
    assert not (tmp_path / "time").exists()


_STARS = ("--x64", "--max-pixel-level", "3")


@pytest.fixture(scope="module")
def point_runs(tmp_path_factory):
    """Each package's mode-8 and mode-1 runs on the L-level grid, 2
    iterations: {(pkg, mode): (stdout, dir)}."""
    root = tmp_path_factory.mktemp("ml_cli_stars")
    out = {}
    for mode in (8, 1):
        for pkg in ("torch", "jax"):
            d = root / f"{pkg}{mode}"
            out[pkg, mode] = (_run(pkg, _inputs(d, mode=mode), d, "--iters",
                                   "2", *_STARS), d)
    return out


@pytest.mark.parametrize("mode", [8, 1])
def test_point_source_modes_x64_match_jax(point_runs, mode):
    (out_t, dt), (out_j, dj) = point_runs["torch", mode], point_runs["jax",
                                                                     mode]
    _assert_logs_close(_time_log(dt), _time_log(dj))
    assert list(_time_log(dt)) == [1, 2]
    assert _GRID in out_t.splitlines()
    assert "nStars/specificAge/non-degenerate = 12 12 12" in out_t
    assert (dt / "weight").read_bytes() == (dj / "weight").read_bytes()
    fesc = [re.findall(r"fesc=(\S+)", o) for o in (out_t, out_j)]
    assert fesc[0] == fesc[1] and len(fesc[0]) == 2
    with np.load(dt / "cosmicSpectrum.npz") as ft, \
            np.load(dj / "cosmicSpectrum.npz") as fj:
        np.testing.assert_array_equal(ft["freq"], fj["freq"])
        peak = float(np.abs(fj["spectrum"]).max())
        assert peak > 0.0
        np.testing.assert_allclose(ft["spectrum"], fj["spectrum"], rtol=0,
                                   atol=1e-9 * peak)
    _assert_snapshots_close(dt / "cellArray0002.npz",
                            dj / "cellArray0002.npz")


_NONEQ = ("--x64", "--chemistry", "noneq")
# the noneq runs: (grid, mode) -> (the grid refines its core, iterations,
# extra flags); mode 8 with the galaxy's 12 sources, one iteration (the
# restarts start from mode 9's itime-1 snapshots)
_NONEQ_RUNS = {("ml", 9): (True, 2, ()), ("two", 9): (False, 2, ()),
               ("ml", 8): (True, 1, _STARS[1:]),
               ("two", 8): (False, 1, _STARS[1:])}


@pytest.fixture(scope="module")
def noneq_runs(mode9, tmp_path_factory):
    """Each package's --chemistry noneq runs in --x64 (_NONEQ_RUNS):
    {(pkg, grid, mode): (stdout, dir)}; on the L-level grid at the
    coupling depth mode 9 validated there (the same grid; the validation
    is mode9's cases')."""
    depth = re.search(r"coupling depth: (\d+)", mode9["jax"][0]).group(1)
    root = tmp_path_factory.mktemp("ml_cli_noneq")
    out = {}
    for (grid, mode), (core, iters, flags) in _NONEQ_RUNS.items():
        if grid == "ml":
            flags = flags + ("--coupling-depth", depth)
        for pkg in ("torch", "jax"):
            d = root / f"{pkg}_{grid}{mode}"
            out[pkg, grid, mode] = (_run(
                pkg, _inputs(d, mode=mode, refine_core=core), d, "--iters",
                str(iters), *_NONEQ, *flags), d)
    return out


def _assert_noneq_snapshots_close(path_t, path_j, n_levels):
    with np.load(path_t) as ft, np.load(path_j) as fj:
        assert list(ft.keys()) == list(fj.keys())
        assert int(ft["n_levels"]) == n_levels
        for ell in range(n_levels):
            assert f"species{ell}_H2I" in ft, ell
            assert ft[f"species{ell}_HI"].shape == ((N * 2 ** ell,) * 3)
            assert ft[f"species{ell}_HI"].dtype == np.float64
        for k in fj:
            a, b = ft[k], fj[k]
            assert a.dtype == b.dtype, k
            if a.dtype.kind == "f" and a.ndim:
                peak = float(np.abs(b).max())
                assert np.abs(a - b).max() <= 1e-10 * peak, k
            else:
                np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("grid,mode", list(_NONEQ_RUNS))
def test_noneq_x64_matches_jax(noneq_runs, grid, mode):
    (out_t, dt), (out_j, dj) = (noneq_runs["torch", grid, mode],
                                noneq_runs["jax", grid, mode])
    iters = _NONEQ_RUNS[grid, mode][1]
    _assert_logs_close(_time_log(dt), _time_log(dj))
    assert list(_time_log(dt)) == list(range(1, iters + 1))
    n_levels = 3 if grid == "ml" else 2
    assert (f"non-equilibrium chemistry ({n_levels} levels): dt = 1.0 Myr, "
            f"evolve_energy = False") in out_t.splitlines()
    if grid == "two":
        assert "grid: 8^3 + refined level (64 parents)" in out_t.splitlines()
        assert "coupling depth" not in out_t + out_j
    else:
        assert _GRID in out_t.splitlines()
        assert re.search(r"^coupling depth: \d \(fixed\)$", out_t, re.M)
    if mode == 8:
        assert ("nStars/specificAge/non-degenerate = 12 12 12"
                in out_t.splitlines())
        fesc = [re.findall(r"fesc=(\S+)", o) for o in (out_t, out_j)]
        assert fesc[0] == fesc[1] and len(fesc[0]) == iters
        with np.load(dt / "cosmicSpectrum.npz") as ft, \
                np.load(dj / "cosmicSpectrum.npz") as fj:
            peak = float(np.abs(fj["spectrum"]).max())
            assert peak > 0.0
            np.testing.assert_allclose(ft["spectrum"], fj["spectrum"],
                                       rtol=0, atol=1e-9 * peak)
    for it in range(1, iters + 1):
        name = f"cellArray{it:04d}.npz"
        _assert_noneq_snapshots_close(dt / name, dj / name, n_levels)


@pytest.mark.parametrize("grid,writer,reader", [
    ("ml", "jax", "torch"), ("ml", "torch", "jax"), ("two", "jax", "torch")])
def test_noneq_restart_across_packages(noneq_runs, tmp_path, grid, writer,
                                       reader):
    """The reader restarts the writer's itime-1 noneq snapshot, fields and
    species (at the writer's coupling depth on the L-level grid): its itime
    2 is the writer's within 1e-10."""
    out_w, src = noneq_runs[writer, grid, 9]
    d = tmp_path / reader
    config = _inputs(d, restart=1, refine_core=grid == "ml")
    shutil.copy(src / "cellArray0001.npz", d)
    flags = ()
    if grid == "ml":
        flags = ("--coupling-depth",
                 re.search(r"coupling depth: (\d+)", out_w).group(1))
    out = _run(reader, config, d, "--iters", "1", *_NONEQ, *flags)
    assert f"restarted from {d}/cellArray0001.npz at itime=1" in out
    assert "restored 9-species noneq state from snapshot" in out
    log = _time_log(d)
    assert list(log) == [2]
    _assert_logs_close(log, {2: _time_log(src)[2]})
