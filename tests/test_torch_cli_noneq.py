"""PyTorch port, the uniform-grid CLI's `--chemistry noneq`: both
packages' `cli.main` on the same files (the synthetic galaxy at 16^3,
angular level 1, 12 sources; tests/test_torch_cli.py's helpers), in
--x64.  The `time` logs agree within 1e-10 relative and the snapshots'
9-species arrays within 1e-10 of each array's peak; a snapshot of either
package restarts the other's noneq run, an equilibrium run restarts from
a noneq snapshot and a noneq run from an equilibrium one; species that do
not fit the grid stop the restart.  Each run is one iteration where one
shows the behaviour: the port's eager network is ~80k CPU ops a step."""

import shutil

import numpy as np
import pytest
import torch

from test_torch_cli import (
    _PIXEL,
    N,
    _assert_logs_close,
    _assert_snapshots_close,
    _fesc,
    _inputs,
    _run,
    _Runs,
    _time_log,
)
from test_torch_host import jax_compile_cache

_NONEQ = ("--chemistry", "noneq", "--x64")
# the one run of two iterations: the restarts continue its itime 1
_TWO = ("--iters", "2", *_NONEQ)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _Runs(tmp_path_factory.mktemp("cli_noneq"))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port: the network's eager loop is ~80k
    small CPU ops a step, on which more threads only spin (8 threads: the
    same wall time alone for 8x the CPU time), starving the other test
    workers."""
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


def _assert_species_close(pa, pb, tol=1e-10):
    """The snapshots' 9-species arrays (float64 in --x64) within tol of each
    array's peak."""
    with np.load(pa) as fa, np.load(pb) as fb:
        keys = [k for k in fb if k.startswith("species0_")]
        assert len(keys) == 10
        assert keys == [k for k in fa if k.startswith("species0_")]
        for k in keys:
            a, b = fa[k], fb[k]
            assert a.dtype == b.dtype == np.float64 and a.shape == (N,) * 3
            assert np.max(np.abs(a - b)) <= tol * np.max(np.abs(b)), k


@pytest.mark.parametrize("mode,flags", [(9, _TWO),
                                        (8, ("--iters", "1", *_NONEQ,
                                             *_PIXEL)),
                                        (9, ("--iters", "1", *_NONEQ,
                                             "--evolve-energy"))])
def test_noneq_x64_matches_jax(runs, mode, flags):
    (out_t, dt), (out_j, dj) = runs("torch", mode, *flags), runs("jax", mode,
                                                                 *flags)
    _assert_logs_close(_time_log(dt), _time_log(dj), 1e-10)
    iters = int(flags[1])
    assert len(_time_log(dt)) == iters
    evolve = "--evolve-energy" in flags
    line = ("non-equilibrium chemistry: dt = 1.0 Myr, evolve_energy = "
            f"{evolve}")
    assert line in out_t and line in out_j
    for i in range(1, iters + 1):
        name = f"cellArray{i:04d}.npz"
        _assert_snapshots_close(dt / name, dj / name)
        _assert_species_close(dt / name, dj / name)
    if mode == 8:
        assert _fesc(out_t) == _fesc(out_j) and len(_fesc(out_t)) == 1
    # the written temperature is the held one, unless the energy evolves
    _, held = runs("torch", 9, *_TWO)
    with np.load(dt / "cellArray0001.npz") as a, \
            np.load(held / "cellArray0001.npz") as b:
        same = np.array_equal(a["temperature"], b["temperature"])
    assert same == (not evolve)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_noneq_restart_across_packages(runs, tmp_path, writer):
    """Both CLIs continue one package's itime-1 noneq snapshot with its
    species for one iteration."""
    _, src = runs(writer, 9, *_TWO)
    logs = {}
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg
        config = _inputs(d, mode=9, restart=1)
        shutil.copy(src / "cellArray0001.npz", d)
        out = _run(pkg, config, d, "--iters", "1", *_NONEQ)
        assert "restored 9-species noneq state from snapshot" in out
        logs[pkg] = _time_log(d)
    assert list(logs["torch"]) == [2]
    _assert_logs_close(logs["torch"], logs["jax"], 1e-10)
    _assert_species_close(tmp_path / "torch" / "cellArray0002.npz",
                          tmp_path / "jax" / "cellArray0002.npz")
    # the writer's own itime 2, from float64 fields where the restart
    # reads the snapshot's float32 ones
    _assert_logs_close(logs["torch"], {2: _time_log(src)[2]}, 1e-6)


def test_equilibrium_restart_from_a_noneq_snapshot(runs, tmp_path):
    """An equilibrium run restarts from a noneq snapshot: the fields are
    read, the species keys ignored, in both CLIs alike."""
    _, src = runs("torch", 9, *_TWO)
    logs = {}
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg
        config = _inputs(d, mode=9, restart=1)
        shutil.copy(src / "cellArray0002.npz", d)
        out = _run(pkg, config, d, "--iters", "1", "--x64")
        assert f"restarted from {d}/cellArray0002.npz at itime=2" in out
        assert "9-species" not in out and "species state" not in out
        logs[pkg] = _time_log(d)
        with np.load(d / "cellArray0003.npz") as fh:
            assert not any(k.startswith("species") for k in fh)
    _assert_logs_close(logs["torch"], logs["jax"], 1e-10)


def test_noneq_restart_without_species_reinitializes(runs, tmp_path):
    """A noneq restart from an equilibrium snapshot warns and starts the
    species from the restored fields, in both CLIs alike."""
    _, src = runs("torch", 9, "--iters", "1", "--x64")
    logs = {}
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg
        config = _inputs(d, mode=9, restart=1)
        shutil.copy(src / "cellArray0001.npz", d)
        out = _run(pkg, config, d, "--iters", "1", *_NONEQ)
        assert ("warning: snapshot carries no species state; "
                "H2/H2+/H-/energy re-initialized from equilibrium") in out
        logs[pkg] = _time_log(d)
    _assert_logs_close(logs["torch"], logs["jax"], 1e-10)
    _assert_species_close(tmp_path / "torch" / "cellArray0002.npz",
                          tmp_path / "jax" / "cellArray0002.npz")


def test_noneq_restart_with_species_off_the_grid_raises(runs, tmp_path):
    """Species arrays that do not fit the grid stop the restart: the port
    never falls back to a fresh equilibrium there (the JAX CLI's
    _restore_noneq catches Exception on its orbax branch)."""
    _, src = runs("torch", 9, *_TWO)
    with np.load(src / "cellArray0001.npz") as fh:
        data = {k: fh[k] for k in fh}
    data["species0_H2I"] = data["species0_H2I"][:, :, :N // 2]
    config = _inputs(tmp_path, mode=9, restart=1)
    np.savez_compressed(tmp_path / "cellArray0001.npz", **data)
    with pytest.raises(ValueError, match="species0_H2I has shape"):
        _run("torch", config, tmp_path, "--iters", "1", *_NONEQ)
    assert not (tmp_path / "time").exists()


@pytest.mark.parametrize("strategy", ["rdma", "zones", "pipelined"])
def test_noneq_mesh_strategies_match_one_device(runs, strategy):
    out, d = runs("torch", 9, "--iters", "1", *_NONEQ, "--sweep-strategy",
                  strategy, "--mesh-shape", "4")
    assert ("non-equilibrium chemistry: dt = 1.0 Myr, evolve_energy = "
            "False, mesh = (4,)") in out
    _, one = runs("torch", 9, *_TWO)
    _assert_logs_close(_time_log(d), {1: _time_log(one)[1]}, 1e-10)
    _assert_species_close(d / "cellArray0001.npz", one / "cellArray0001.npz")
