"""PyTorch port, block-sparse L-level AMR storage (core/amr_sparse.py) and
its snapshots (io/snapshot.py's write/read_snapshot_sparse) against the
JAX package's, on the CPU, in float64.

The same clustered 3-level states (8^3 and 16^3 bases, made from a seed
with NumPy) go through both packages: sparse_from_dense gives the same
block structure (slots, origins, cover, refined) and bit-equal blocks;
dense_from_sparse returns the dense state bit for bit on covered cells;
memory_bytes and n_leaves agree; sync_restriction_sparse and the generic
sync_restriction_tree agree within 1e-13 relative (and with the port's
dense sync_restriction_multi bit for bit); flat_lookup, blockify_like and
unblockify_like agree exactly.  sparse_from_level_lists on per-level cell
lists (with and without velocities, be 8 and 4, under max_depth) gives
the JAX package's structure and fields within 1e-12, and the port's dense
ingestion's on covered cells.  A state written by either package's
write_snapshot_sparse has the same keys and bit-equal leaf arrays, each
package restarts the other's file, and a structure mismatch raises
ValueError."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiativetransfer_tpu.constants import KPC, MH, PSI
from radiativetransfer_tpu.core import amr as jamr
from radiativetransfer_tpu.core import amr_sparse as jas
from radiativetransfer_tpu.core.state import make_state as jmake
from radiativetransfer_tpu.io import snapshot as jsnap
from radiativetransfer_tpu_torch.core import amr as tamr
from radiativetransfer_tpu_torch.core import amr_sparse as tas
from radiativetransfer_tpu_torch.io import grid_io as tgrid
from radiativetransfer_tpu_torch.io import snapshot as tsnap
from test_torch_host import jax_compile_cache

F64 = torch.float64


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
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


def _rand_state(rng, m, scale=1e-3):
    nh = rng.lognormal(0, 0.5, (m,) * 3) * scale
    return jmake(nh * MH / PSI, np.full((m,) * 3, 1e4), nh,
                 dtype=jnp.float64)


def clustered_ml(n=8, L=3, seed=1, scale=1e-3, off=(0.5, 0.5, 0.5)):
    """A JAX MultiLevelState with clustered refinement around `off` (the
    shape block storage is for) and its balanced refinement maps."""
    rng = np.random.default_rng(seed)
    refined, m = [], n
    for _ in range(L - 1):
        r = np.zeros((m,) * 3, bool)
        c = (np.array(off) * m).astype(int)
        r[c[0] - 2:c[0] + 2, c[1] - 2:c[1] + 2, c[2] - 2:c[2] + 2] = \
            rng.random((4, 4, 4)) < 0.6
        refined.append(r)
        m *= 2
    refined = jamr.enforce_balance(refined)
    cov = np.ones((n,) * 3, bool)
    for ell in range(L - 1):
        refined[ell] &= cov
        cov = np.repeat(np.repeat(np.repeat(refined[ell], 2, 0), 2, 1), 2, 2)
    ml = jamr.make_multilevel_state(
        _rand_state(rng, n, scale), refined,
        [_rand_state(rng, n * 2 ** (ell + 1), scale) for ell in range(L - 1)])
    return jamr.sync_restriction_multi(ml), refined


def _fields_np(fs) -> dict:
    return {f.name: (None if getattr(fs, f.name) is None
                     else np.asarray(getattr(fs, f.name)))
            for f in dataclasses.fields(fs)}


def jax_sparse_np(sp) -> dict:
    """A JAX SparseMLState as SparseMLState.from_numpy takes it."""
    return {"base": _fields_np(sp.base), "refined0": np.asarray(sp.refined0),
            "levels": [{"fields": _fields_np(lv.fields),
                        "slot": np.asarray(lv.slot),
                        "origin": np.asarray(lv.origin),
                        "cover": np.asarray(lv.cover),
                        "refined": np.asarray(lv.refined)}
                       for lv in sp.levels]}


def port_ml(ml) -> tamr.MultiLevelState:
    return tamr.MultiLevelState.from_numpy(
        {"levels": [_fields_np(lv) for lv in ml.levels],
         "refined": [np.asarray(r) for r in ml.refined]},
        dtype=F64, device="cpu")


def _assert_sparse_equal(t, j, rtol=0.0):
    """The same block structure, and fields equal (within rtol of each
    field's peak)."""
    np.testing.assert_array_equal(t.refined0.numpy(), np.asarray(j.refined0))
    assert t.n_levels == j.n_levels
    pairs = [(t.base, j.base)] + [(a.fields, b.fields)
                                  for a, b in zip(t.levels, j.levels)]
    for a, b in zip(t.levels, j.levels):
        for k in ("slot", "origin", "cover", "refined"):
            np.testing.assert_array_equal(getattr(a, k).numpy(),
                                          np.asarray(getattr(b, k)),
                                          err_msg=k)
    for ell, (a, b) in enumerate(pairs):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert (x is None) == (y is None), f.name
            if x is None:
                continue
            x, y = x.numpy(), np.asarray(y)
            assert x.shape == y.shape, (ell, f.name)
            peak = max(float(np.abs(y).max()), 1e-300)
            assert np.abs(x - y).max() <= rtol * peak, (ell, f.name)


@pytest.fixture(scope="module")
def states():
    """{(n, be): (JAX MultiLevelState, refined maps, JAX SparseMLState)}."""
    out = {}
    for n, be, off in ((8, 8, (0.5, 0.5, 0.5)), (16, 4, (0.28, 0.55, 0.4))):
        ml, refined = clustered_ml(n, seed=n, off=off)
        out[n, be] = ml, refined, jas.sparse_from_dense(ml, be=be)
    return out


class TestStateRoundTrip:
    @pytest.mark.parametrize("key", [(8, 8), (16, 4)])
    def test_sparse_from_dense_matches_jax(self, states, key):
        ml, refined, jsp = states[key]
        tsp = tas.sparse_from_dense(port_ml(ml), be=key[1])
        _assert_sparse_equal(tsp, jsp)
        assert tsp.n_leaves() == jsp.n_leaves() == ml.n_leaves()
        assert tsp.memory_bytes() == jsp.memory_bytes()
        # the padding block: last, all zero, uncovered, out of range
        for ell, lv in enumerate(tsp.levels, start=1):
            assert bool(lv.pad_mask(key[0] * 2 ** ell)[-1])
            assert int(lv.pad_mask(key[0] * 2 ** ell).sum()) == 1
            assert not bool(lv.cover[-1].any())
            assert float(lv.fields.rho[-1].abs().max()) == 0.0

    @pytest.mark.parametrize("key", [(8, 8), (16, 4)])
    def test_round_trip_exact_on_covered(self, states, key):
        ml, refined, jsp = states[key]
        tsp = tas.SparseMLState.from_numpy(jax_sparse_np(jsp), dtype=F64,
                                           device="cpu")
        back = tas.dense_from_sparse(tsp)
        jback = jas.dense_from_sparse(jsp)
        for r_t, r_j in zip(back.refined, jback.refined):
            np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
        cover = tamr.cover_masks(back.refined, back.levels[0].shape, "cpu")
        for ell, (a, b, c) in enumerate(zip(back.levels, ml.levels,
                                            cover)):
            for name in ("rho", "HI", "tgas", "Jmean"):
                x = getattr(a, name).numpy()
                y = np.asarray(getattr(b, name))
                m = np.broadcast_to(c.numpy(), x.shape)
                np.testing.assert_array_equal(x[m], y[m],
                                              err_msg=f"{ell} {name}")
                np.testing.assert_array_equal(
                    x, np.asarray(getattr(jback.levels[ell], name)))
        again = tas.SparseMLState.from_numpy(tsp.to_numpy(), dtype=F64,
                                             device="cpu")
        _assert_sparse_equal(again, jsp)

    def test_helpers_match_jax(self, states):
        ml, refined, jsp = states[16, 4]
        tsp = tas.SparseMLState.from_numpy(jax_sparse_np(jsp), dtype=F64,
                                           device="cpu")
        rng = np.random.default_rng(3)
        for ell, (lt, lj) in enumerate(zip(tsp.levels, jsp.levels),
                                       start=1):
            n_l = 16 * 2 ** ell
            x = rng.random((3, n_l, n_l, n_l))
            b = tas.blockify_like(lt, x)
            np.testing.assert_array_equal(
                b.numpy(), np.asarray(jas.blockify_like(lj, x)))
            np.testing.assert_array_equal(
                tas.unblockify_like(lt, b, fill=-1.0),
                jas.unblockify_like(lj, np.asarray(b), fill=-1.0))
            c = rng.integers(0, n_l, (50, 3))
            idx_t, ex_t = tas.flat_lookup(lt.slot, torch.as_tensor(c), lt.be)
            idx_j, ex_j = jas.flat_lookup(lj.slot, jnp.asarray(c), lj.be)
            np.testing.assert_array_equal(ex_t.numpy(), np.asarray(ex_j))
            np.testing.assert_array_equal(idx_t.numpy()[ex_t.numpy()],
                                          np.asarray(idx_j)[ex_t.numpy()])

    @pytest.mark.parametrize("key", [(8, 8), (16, 4)])
    def test_sync_restriction_matches(self, states, key):
        ml, refined, _ = states[key]
        ml = jamr.MultiLevelState(
            levels=tuple(dataclasses.replace(lv, HI=lv.HI * 1.7,
                                             Jmean=lv.Jmean + 0.3)
                         for lv in ml.levels), refined=ml.refined)
        jsp = jas.sparse_from_dense(ml, be=key[1])
        tsp = tas.SparseMLState.from_numpy(jax_sparse_np(jsp), dtype=F64,
                                           device="cpu")
        _assert_sparse_equal(tas.sync_restriction_sparse(tsp),
                             jas.sync_restriction_sparse(jsp), rtol=1e-13)
        # the port's sparse sync is its dense sync, bit for bit
        dense = tamr.sync_restriction_multi(port_ml(ml))
        back = tas.dense_from_sparse(tas.sync_restriction_sparse(tsp))
        cover = tamr.cover_masks(dense.refined, dense.levels[0].shape, "cpu")
        for a, b, c in zip(back.levels, dense.levels, cover):
            for name in ("HI", "Jmean", "rho"):
                x, y = getattr(a, name), getattr(b, name)
                m = c.expand_as(x)
                assert torch.equal(x[m], y[m]), name
        # the generic engine on other per-cell state (two species-like
        # trees of one and of three components)
        rng = np.random.default_rng(7)

        def tree(shape):
            return {"a": rng.random(shape), "b": rng.random((3,) + shape)}
        base = tree((key[0],) * 3)
        lvs = [tree(lv.cover.shape) for lv in tsp.levels]
        tb, tl = tas.sync_restriction_tree(
            tsp, {k: torch.as_tensor(v) for k, v in base.items()},
            [{k: torch.as_tensor(v) for k, v in t.items()} for t in lvs])
        jb, jl = jas.sync_restriction_tree(
            jsp, {k: jnp.asarray(v) for k, v in base.items()},
            [{k: jnp.asarray(v) for k, v in t.items()} for t in lvs])
        for a, b in zip([tb, *tl], [jb, *jl]):
            for k in ("a", "b"):
                np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]),
                                           rtol=1e-13, atol=0)


def synthetic_levels(n=8, depth=3, seed=0, with_vel=False, tgrid_cls=False):
    """Per-level cell lists: a full base, each finer level the children
    of the central half (cube) of its parent level's cells (the JAX
    package's test grid)."""
    cls = tgrid.LevelData
    if not tgrid_cls:
        from radiativetransfer_tpu.io.grid_io import LevelData as cls
    rng = np.random.default_rng(seed)
    levels, m = [], n
    for ell in range(depth):
        if ell == 0:
            idx = np.indices((m, m, m)).reshape(3, -1).T
        else:
            pidx = np.indices((m // 4,) * 3).reshape(3, -1).T + m // 4
            idx = np.array([2 * p + np.array(d) for p in pidx
                            for d in np.ndindex(2, 2, 2)])
            m *= 2
        pos = (idx + 0.5) / m * 100.0   # kpc
        ncell = len(idx)
        levels.append(cls(
            pos=pos.astype(np.float32),
            lT=rng.normal(4.0, 0.1, ncell).astype(np.float32),
            lnH=rng.normal(-3.0, 0.1, ncell).astype(np.float32),
            lx=rng.normal(-1.0, 0.2, ncell).astype(np.float32),
            vel=(rng.normal(0, 50, (ncell, 3)).astype(np.float32)
                 if with_vel else None)))
    return levels


class TestSparseIngestion:
    @pytest.mark.parametrize("n,depth,be,vel,max_depth", [
        (8, 3, 8, False, None), (8, 3, 4, True, None),
        (8, 4, 8, True, None), (8, 4, 4, False, 3)])
    def test_matches_jax_ingestion(self, n, depth, be, vel, max_depth):
        jl = synthetic_levels(n, depth, seed=5, with_vel=vel)
        tl = synthetic_levels(n, depth, seed=5, with_vel=vel,
                              tgrid_cls=True)
        jsp, jgeom = jas.sparse_from_level_lists(
            jl, read_metals=False, be=be, max_depth=max_depth,
            dtype=jnp.float64)
        tsp, tgeom = tas.sparse_from_level_lists(
            tl, read_metals=False, be=be, max_depth=max_depth, dtype=F64,
            device="cpu")
        assert ((tgeom.nx, tgeom.physical_box_size)
                == (jgeom.nx, jgeom.physical_box_size))
        _assert_sparse_equal(tsp, jsp, rtol=1e-12)
        assert (tsp.base.vel is not None) == vel
        # against the port's dense ingestion, on covered cells
        dense, _ = tamr.multilevel_from_levels(
            tl, False, F64, device="cpu", max_depth=max_depth or 4)
        back = tas.dense_from_sparse(tsp)
        cover = tamr.cover_masks(dense.refined, dense.levels[0].shape, "cpu")
        for ell, (a, b, c) in enumerate(zip(back.levels, dense.levels,
                                            cover)):
            for name in ("rho", "tgas", "HI", "HeI", "abun2"):
                x, y = getattr(a, name)[c], getattr(b, name)[c]
                assert float((x - y).abs().max()) <= 1e-12 * float(
                    y.abs().max()), (ell, name)
        dense_bytes = sum((n * 2 ** ell) ** 3 * 17 * 8
                          for ell in range(tsp.n_levels))
        assert tsp.memory_bytes() < dense_bytes


class TestSparseSnapshot:
    def test_files_match_and_restart_across(self, states, tmp_path):
        ml, refined, jsp = states[8, 8]
        tsp = tas.SparseMLState.from_numpy(jax_sparse_np(jsp), dtype=F64,
                                           device="cpu")
        pt, pj = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
        tsnap.write_snapshot_sparse(pt, tsp, 1, 300.0 * KPC)
        jsnap.write_snapshot_sparse(pj, jsp, 1, 300.0 * KPC)
        with np.load(pt) as ft, np.load(pj) as fj:
            assert list(ft.keys()) == list(fj.keys())
            assert ft["HI"].shape[0] == tsp.n_leaves()
            for k in fj:
                assert ft[k].dtype == fj[k].dtype, k
                np.testing.assert_array_equal(ft[k], fj[k], err_msg=k)
        # restart onto freshly built structures with other field data
        ml2, _ = clustered_ml(8, seed=8, scale=7e-3)
        jsp2 = jas.sparse_from_dense(ml2, be=8)
        tsp2 = tas.SparseMLState.from_numpy(jax_sparse_np(jsp2), dtype=F64,
                                            device="cpu")
        t_from_j, it_t = tsnap.read_snapshot_sparse(pj, tsp2)
        j_from_t, it_j = jsnap.read_snapshot_sparse(pt, jsp2)
        assert it_t == it_j == 1
        _assert_sparse_equal(t_from_j, j_from_t, rtol=1e-13)
        # the restored state writes the same leaf streams again
        p2 = str(tmp_path / "again.npz")
        tsnap.write_snapshot_sparse(p2, t_from_j, 2, 300.0 * KPC)
        with np.load(pt) as f1, np.load(p2) as f2:
            for k in ("level", "HI", "HeI", "HeII", "temperature"):
                np.testing.assert_array_equal(f1[k], f2[k], err_msg=k)

    def test_matches_dense_ml_snapshot_leaf_values(self, states, tmp_path):
        ml, refined, jsp = states[8, 8]
        tsp = tas.SparseMLState.from_numpy(jax_sparse_np(jsp), dtype=F64,
                                           device="cpu")
        pd, ps = str(tmp_path / "dense.npz"), str(tmp_path / "sparse.npz")
        tsnap.write_snapshot_ml(pd, port_ml(ml), 1, 300.0 * KPC)
        tsnap.write_snapshot_sparse(ps, tsp, 1, 300.0 * KPC)
        with np.load(pd) as fd, np.load(ps) as fs:
            for k in ("level", "HI", "HeI", "HeII", "temperature",
                      "density"):
                np.testing.assert_array_equal(fd[k], fs[k], err_msg=k)

    def test_structure_mismatch_raises(self, states, tmp_path):
        _, _, jsp = states[8, 8]
        tsp = tas.SparseMLState.from_numpy(jax_sparse_np(jsp), dtype=F64,
                                           device="cpu")
        p = str(tmp_path / "cellArray0001.npz")
        tsnap.write_snapshot_sparse(p, tsp, 1, 300.0 * KPC)
        ml3, _ = clustered_ml(8, seed=99)          # another refinement
        other = tas.sparse_from_dense(port_ml(ml3), be=8)
        with pytest.raises(ValueError):
            tsnap.read_snapshot_sparse(p, other)
        # the same blocks and leaf count, a refinement bitmap changed
        # inside a tile: the digest rejects it
        lv = tsp.levels[0]
        ref = lv.refined.clone()
        flat = ref.reshape(-1)
        on = int(torch.nonzero(flat)[0])
        flat[on] = False
        bent = dataclasses.replace(tsp, levels=(dataclasses.replace(
            lv, refined=ref),) + tsp.levels[1:])
        with pytest.raises(ValueError):
            tsnap.read_snapshot_sparse(p, bent)
