"""PyTorch port, the nested states on a 1-D mesh and the block-sparse
zones sweep, against the JAX package's on its 8 virtual CPU devices, on
the CPU in float64.

amr_sparse.pad_blocks_to_multiple gives the JAX package's arrays bit for
bit (multiples 3 and 8 of the clustered 8^3 grid of tests/
test_amr_sparse.py in blocks of 8 and 4); mesh.shard_amr_state,
shard_multilevel_state and shard_sparse_state put every tensor on the
mesh's device, pad a block-sparse state's blocks as the JAX package's
does, and raise ValueError where P does not divide a level's last axis.
sweep_dist.diffuse_sweep_sparse_zones on TestSparseZonesDistributed's
inputs (8^3, 3 levels, level 1, 4 coupling passes) on 8 ranks, with
eager_rounds off and on, and on 5 ranks (its zones padded with copies
scaled by 0): within 1e-12 of each band's peak of the JAX package's zones
sweep on 8 devices and of the port's one-device sparse sweep.

Checkpoints of a two-level, an
L-level and a block-sparse noneq
container restore onto a mesh through the shard functions, equal to the
saved ones (a block-sparse one padded as shard_sparse_state pads)."""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiativetransfer_tpu.core import amr_sparse as jas
from radiativetransfer_tpu.core import sweep_multilevel as jsm
from radiativetransfer_tpu.parallel import mesh as jmesh
from radiativetransfer_tpu.parallel import sweep_dist as jdist
from radiativetransfer_tpu_torch.config import MODE_BOTH_STELLAR_UVB_TRANSFER
from radiativetransfer_tpu_torch.constants import KPC
from radiativetransfer_tpu_torch.core import amr as tamr
from radiativetransfer_tpu_torch.core import amr_sparse as tas
from radiativetransfer_tpu_torch.core import step_amr as tstep_amr
from radiativetransfer_tpu_torch.core import sweep_multilevel as tsm
from radiativetransfer_tpu_torch.core import sweep_sparse as tss
from radiativetransfer_tpu_torch.io import checkpoint as ckpt
from radiativetransfer_tpu_torch.parallel import mesh as tmesh
from radiativetransfer_tpu_torch.parallel import sweep_dist as tdist
from test_torch_amr_sparse import clustered_ml, jax_sparse_np, port_ml
from test_torch_host import jax_compile_cache
import test_torch_noneq_sparse as nsp

F64 = torch.float64
P = 4
UVB = np.array([2e-21, 5e-22, 1e-23])
CELL = 3.0e21


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the eager sweeps and networks are many small
    CPU ops (module-scoped, so that the fixtures run pinned too)."""
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


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(a, b, rel, what=""):
    """|a - b| <= rel * max|b| elementwise (a that is 0 where b is)."""
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, what
    peak = float(np.abs(b).max())
    err = float(np.abs(a - b).max())
    assert err <= rel * peak, (what, err, peak, err / peak)


# ---------------------------------------------------------------------------
# pad_blocks_to_multiple and the shard functions
# ---------------------------------------------------------------------------


def _sparse_pair(be=8, seed=1):
    ml, _ = clustered_ml(8, seed=seed)
    jsp = jas.sparse_from_dense(ml, be=be)
    return jsp, tas.SparseMLState.from_numpy(jax_sparse_np(jsp), dtype=F64,
                                             device="cpu")


@pytest.mark.parametrize("be,multiple", [(8, 3), (8, 8), (4, 3), (4, 8)])
def test_pad_blocks_to_multiple_matches_jax(be, multiple):
    jsp, tsp = _sparse_pair(be)
    j = jax_sparse_np(jas.pad_blocks_to_multiple(jsp, multiple))
    t = tas.pad_blocks_to_multiple(tsp, multiple).to_numpy()
    for lv_t, lv_j, lv0 in zip(t["levels"], j["levels"], tsp.levels):
        assert lv_t["cover"].shape[0] % multiple == 0
        assert lv_t["cover"].shape[0] > lv0.n_blocks or \
            lv0.n_blocks % multiple == 0
        for k in ("slot", "origin", "cover", "refined"):
            np.testing.assert_array_equal(lv_t[k], lv_j[k])
            assert lv_t[k].dtype == lv_j[k].dtype, k
        for k, v in lv_j["fields"].items():
            if v is not None:
                np.testing.assert_array_equal(lv_t["fields"][k], v)
    assert tas.pad_blocks_to_multiple(tsp, 1) is tsp


def test_shard_functions_place_pad_and_check():
    jsp, tsp = _sparse_pair()
    dense = port_ml(clustered_ml(8)[0])
    two = tamr.two_level_view(tamr.MultiLevelState(
        levels=dense.levels[:2], refined=dense.refined[:1]))
    three = tmesh.make_grid_mesh(3, device="cpu")
    for shard, state in ((tmesh.shard_amr_state, two),
                         (tmesh.shard_multilevel_state, dense),
                         (tmesh.shard_sparse_state, tsp)):
        with pytest.raises(ValueError, match="3 ranks do not divide"):
            shard(state, three)
    mesh = tmesh.make_grid_mesh(P, device="cpu")
    sh = tmesh.shard_sparse_state(tsp, mesh)
    assert all(lv.n_blocks % P == 0 for lv in sh.levels)
    assert all(lv.pad_mask(8 * 2 ** ell).sum() == 1 + lv.n_blocks - lv0
               for ell, (lv, lv0) in enumerate(zip(
                   sh.levels, (x.n_blocks for x in tsp.levels)), start=1))
    assert sh.n_leaves() == tsp.n_leaves()
    for lv, lv0 in zip(tmesh.shard_multilevel_state(dense, mesh).levels,
                       dense.levels):
        assert torch.equal(lv.HI, lv0.HI)


# ---------------------------------------------------------------------------
# diffuse_sweep_sparse_zones
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def zones_inputs():
    """TestSparseZonesDistributed's: the clustered 8^3 grid (seed 1),
    random level opacities from seed 17, a level-1 plan; the JAX package's
    zones sweep on 8 devices and the port's one-device sparse sweep."""
    n, L = 8, 3
    ml, _ = clustered_ml(n, L)
    jsp = jas.sparse_from_dense(ml, be=8)
    tsp = tas.SparseMLState.from_numpy(jax_sparse_np(jsp), dtype=F64,
                                       device="cpu")
    rng = np.random.default_rng(17)
    kappas = [rng.lognormal(0, 0.7, (3,) + (n * 2 ** ell,) * 3) / 3e21
              for ell in range(L)]
    jlv = [jas.blockify_like(jsp.levels[ell - 1], kappas[ell])
           for ell in range(1, L)]
    j0, jbs = jdist.diffuse_sweep_sparse_zones(
        jnp.asarray(kappas[0]), jlv, jsp, jsm.build_ml_sweep_plan(1, n, L),
        jnp.asarray(UVB), CELL, jmesh.make_grid_mesh(8), n_coupling_iters=4)
    tlv = [tas.blockify_like(tsp.levels[ell - 1], kappas[ell])
           for ell in range(1, L)]
    plan = tsm.build_ml_sweep_plan(1, n, L)
    k0 = torch.as_tensor(kappas[0])
    one = tss.diffuse_sweep_sparse(k0, tlv, tsp, plan, UVB, CELL,
                                   n_coupling_iters=4)
    return dict(tsp=tsp, k0=k0, tlv=tlv, plan=plan, one=one,
                jax=(np.asarray(j0), [np.asarray(b) for b in jbs]))


@pytest.mark.parametrize("n_ranks,eager", [(8, False), (8, True), (5, False)])
def test_sparse_zones_sweep_matches_jax(zones_inputs, n_ranks, eager):
    z = zones_inputs
    j0, jbs = tdist.diffuse_sweep_sparse_zones(
        z["k0"], z["tlv"], z["tsp"], z["plan"], UVB, CELL,
        tmesh.make_grid_mesh(n_ranks, device="cpu"), n_coupling_iters=4,
        eager_rounds=eager)
    for ref in (z["jax"], z["one"]):
        for b in range(3):
            _close(j0[b], ref[0][b], 1e-12, f"J0 band {b}")
            for ell, (a, r) in enumerate(zip(jbs, ref[1]), start=1):
                _close(a[b], r[b], 1e-12, f"level {ell} band {b}")


# ---------------------------------------------------------------------------
# checkpoints restored onto a mesh
# ---------------------------------------------------------------------------


def _trees_equal(a, b):
    fa, fb = ckpt.flatten(a), ckpt.flatten(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k


@pytest.mark.parametrize("kind", ["two_level", "ml", "sparse_noneq"])
def test_checkpoint_restores_onto_a_mesh(tmp_path, kind):
    mesh = tmesh.make_grid_mesh(P, device="cpu")
    dense = port_ml(clustered_ml(8)[0])
    if kind == "two_level":
        saved = tamr.two_level_view(tamr.MultiLevelState(
            levels=dense.levels[:2], refined=dense.refined[:1]))
        want = tmesh.shard_amr_state(saved, mesh)
    elif kind == "ml":
        saved = dense
        want = tmesh.shard_multilevel_state(saved, mesh)
    else:
        _, tsp = _sparse_pair()
        trt = nsp.models(MODE_BOTH_STELLAR_UVB_TRANSFER)[1]
        species = tstep_amr.SparseMLModel.setup(trt, 3).initial_species(tsp)
        saved = (tsp, species)
        want = (tmesh.shard_sparse_state(tsp, mesh),
                tmesh.shard_sparse_species(species, mesh))
    path = ckpt.checkpoint_name(1, str(tmp_path))
    ckpt.save_sharded(path, saved, 1, 300.0 * KPC)
    back, meta = ckpt.restore_sharded(path, saved, mesh=mesh)
    assert meta["itime"] == 1
    _trees_equal(back, want)
    if kind == "sparse_noneq":
        st, sp = back
        for ell, (lv, spc) in enumerate(zip(st.levels, sp[1:]), start=1):
            assert lv.n_blocks % P == 0 and spc.HI.shape[0] == lv.n_blocks
            pad = lv.pad_mask(st.n * 2 ** ell)
            assert not bool(spc.HI[pad].any())
