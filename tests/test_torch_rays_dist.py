"""PyTorch port, the source-parallel tracers (parallel/rays_dist.py)
against the JAX package's on its 8 virtual CPU devices, and against the
port's single-device tracers, on the CPU in float64.

Inputs, the JAX package's own distributed-tracer tests' (tests/
test_parallel.py, tests/test_amr_sparse.py): the uniform 16^3 box with 8
and with 5 sources (an exact and a padded split, TestDistributedRays);
the two-level 16^3 box with its refined block and 5 sources
(TestShardedAMR._amr_setup(with_sources=True)); the L-level 8^3 box of
TestShardedMultiLevel with 5 sources; the clustered 8^3 three-level grid
stored block-sparse with 4 sources (TestSparseSharded), host_phases off
and on; all at maxPixelLevel 3 on P = 8 ranks, against the JAX package's
make_grid_mesh(8); and one quadrature_noneq case, the L-level state of
tests/test_torch_rays_ml.py with its 3 sources.  Every channel within
1e-12 of its peak and every diagnostic within 1e-12 of its peak.

Port-only, at the same sizes: each distributed tracer equals the sum over
ranks of the single-device traces of each rank's sources (the ranks'
slices summed in rank order), within 1e-13 of each peak; it is bit for
bit on the CPU, where one rank's deposits land in its slice in the order
a single-device trace adds them, and the test asserts that too.  With one
rank each tracer is the single-device one bit for bit.  A float32 trace on
the rank-strided accumulators keeps the guard of
test_torch_rays.py::test_f32_deposits_survive_a_flushing_index_add."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiativetransfer_tpu.config import RunConfig as JRunConfig
from radiativetransfer_tpu.core import amr as jamr
from radiativetransfer_tpu.core import amr_sparse as jas
from radiativetransfer_tpu.core import rays as jrays
from radiativetransfer_tpu.core import state as jstate
from radiativetransfer_tpu.core import step as jstep
from radiativetransfer_tpu.parallel import mesh as jmesh
from radiativetransfer_tpu.parallel import rays_dist as jdist
from radiativetransfer_tpu.tables import stellar as jstellar
from radiativetransfer_tpu_torch.constants import KPC, MYR
from radiativetransfer_tpu_torch.core import amr as tamr
from radiativetransfer_tpu_torch.core import amr_sparse as tas
from radiativetransfer_tpu_torch.core import rays as trays
from radiativetransfer_tpu_torch.core import rays_amr as trays_amr
from radiativetransfer_tpu_torch.core import rays_multilevel as trml
from radiativetransfer_tpu_torch.core import state as tstate
from radiativetransfer_tpu_torch.core import step as tstep
from radiativetransfer_tpu_torch.parallel import mesh as tmesh
from radiativetransfer_tpu_torch.parallel import rays_dist as tdist
from radiativetransfer_tpu_torch.tables import stellar as tstellar
from test_torch_amr_sparse import jax_sparse_np
from test_torch_host import jax_compile_cache
from test_torch_rays_ml import noneq_tables, port_tables
from test_torch_rays_ml import sources as ml_sources
from test_torch_rays_ml import states as ml_states

F64 = torch.float64
P = 8
MPL = 3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the eager march's small ops, module-scoped
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


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(a, b, rel, what=""):
    """|a - b| <= rel * max|b| elementwise (a field that is 0 on b's side
    is 0 on a's)."""
    a, b = _np(a).reshape(-1), _np(b).reshape(-1)
    assert a.shape == b.shape, what
    peak = float(np.abs(b).max())
    err = float(np.abs(a - b).max())
    assert err <= rel * peak, (what, err, peak)


def _rfs_close(t_rfs, j_rfs, rel):
    for ell, (t, j) in enumerate(zip(t_rfs, j_rfs)):
        for f in dataclasses.fields(t):
            _close(getattr(t, f.name), getattr(j, f.name), rel,
                   f"level {ell} {f.name}")


def _diag_close(t, j, rel):
    for f in dataclasses.fields(t):
        _close(getattr(t, f.name), getattr(j, f.name), rel, f.name)


def _batch(mod, n_sources, seed, lo, hi):
    rng = np.random.default_rng(seed)
    return mod.SourceBatch(
        position=rng.uniform(lo, hi, (n_sources, 3)),
        weight=rng.integers(1, 4, n_sources).astype(np.float64),
        table_idx=np.zeros(n_sources, np.int32))


def _contexts(n, box_kpc, n_sources, seed, lo, hi):
    """Both packages' StellarContext (blackbody population, one bucket) on
    the same sources."""
    jgeom = jstate.GridGeometry(n, n, n, box_kpc * KPC)
    tgeom = tstate.GridGeometry(n, n, n, box_kpc * KPC)
    jc = jstep.StellarContext.build(
        jstellar.blackbody_population(), _batch(jrays, n_sources, seed, lo,
                                                hi),
        jgeom, 10.0 * MYR, metal_coefs=[(0, 0.0)], max_pixel_level=MPL)
    tc = tstep.StellarContext.build(
        tstellar.blackbody_population(), _batch(trays, n_sources, seed, lo,
                                                hi),
        tgeom, 10.0 * MYR, metal_coefs=[(0, 0.0)], max_pixel_level=MPL,
        dtype=F64, device="cpu")
    return jgeom, tgeom, jc, tc


def _uniform(n_sources):
    """TestDistributedRays._setup: the uniform 16^3, 50 kpc box."""
    jgeom, tgeom, jc, tc = _contexts(16, 50.0, n_sources, 11, 0.15, 0.85)
    js = jstate.uniform_state(16, nh=1e-3, tgas=1e4, dtype=jnp.float64)
    ts = tstate.uniform_state(16, nh=1e-3, tgas=1e4, dtype=F64,
                              device="cpu")
    return (jgeom, js, jc), (tgeom, ts, tc)


def _two_level():
    """TestShardedAMR._amr_setup(with_sources=True)."""
    n = 16
    jgeom, tgeom, jc, tc = _contexts(n, 300.0, 5, 3, 0.2, 0.8)
    refined = np.zeros((n, n, n), bool)
    refined[5:9, 6:10, 4:8] = True
    js = jamr.make_amr_state(
        jstate.uniform_state(n, nh=2e-3, tgas=1e4, dtype=jnp.float64),
        jnp.asarray(refined))
    ts = tamr.make_amr_state(
        tstate.uniform_state(n, nh=2e-3, tgas=1e4, dtype=F64, device="cpu"),
        torch.as_tensor(refined))
    return (jgeom, js, jc), (tgeom, ts, tc)


def _ml():
    """TestShardedMultiLevel._ml_setup(with_sources=True)."""
    n = 8
    jgeom, tgeom, jc, tc = _contexts(n, 300.0, 5, 7, 0.2, 0.8)
    refined = [np.zeros((n, n, n), bool), np.zeros((2 * n,) * 3, bool)]
    refined[0][2:6, 3:7, 2:6] = True
    refined[1][6:10, 7:11, 6:10] = True
    refined = jamr.enforce_balance(refined)
    js = jamr.make_multilevel_state(
        jstate.uniform_state(n, nh=2e-3, tgas=1e4, dtype=jnp.float64),
        refined)
    ts = tamr.make_multilevel_state(
        tstate.uniform_state(n, nh=2e-3, tgas=1e4, dtype=F64, device="cpu"),
        [torch.as_tensor(r) for r in refined])
    return (jgeom, js, jc), (tgeom, ts, tc)


def _sparse():
    """TestSparseSharded: the clustered 8^3 three-level grid (seed 41,
    scale 5e-4) in blocks of 8, 4 sources from seed 4."""
    from test_amr_sparse import _clustered_ml
    n = 8
    jgeom, tgeom, jc, tc = _contexts(n, 300.0, 4, 4, 0.3, 0.7)
    ml, _ = _clustered_ml(n, 3, seed=41, scale=5e-4)
    jsp = jas.sparse_from_dense(ml, be=8)
    tsp = tas.SparseMLState.from_numpy(jax_sparse_np(jsp), dtype=F64,
                                       device="cpu")
    return (jgeom, jsp, jc), (tgeom, tsp, tc)


# the port's tracers by kind: (single-device, distributed, its state on
# the mesh), each (state, geom, sources, tables, [mesh], **kw) -> a tuple
# of per-level RateFields and the diagnostics
def _one_uniform(s, g, src, tab, **kw):
    rf, d = trays.trace_point_sources(s, g, src, tab, **kw)
    return (rf,), d


def _dist_uniform(s, g, src, tab, mesh, **kw):
    rf, d = tdist.trace_point_sources_dist(s, g, src, tab, mesh, **kw)
    return (rf,), d


def _one_amr(s, g, src, tab, **kw):
    rfb, rff, d = trays_amr.trace_point_sources_amr(s, g, src, tab, **kw)
    return (rfb, rff), d


def _dist_amr(s, g, src, tab, mesh, **kw):
    rfb, rff, d = tdist.trace_point_sources_amr_dist(s, g, src, tab, mesh,
                                                     **kw)
    return (rfb, rff), d


TRACERS = {
    "uniform": (_one_uniform, _dist_uniform, tmesh.shard_state),
    "two_level": (_one_amr, _dist_amr, tmesh.shard_amr_state),
    "ml": (trml.trace_point_sources_ml, tdist.trace_point_sources_ml_dist,
           tmesh.shard_multilevel_state),
    "sparse": (trml.trace_point_sources_sparse,
               tdist.trace_point_sources_sparse_dist,
               tmesh.shard_sparse_state),
}
SETUPS = {"uniform": lambda: _uniform(5), "two_level": _two_level,
          "ml": _ml, "sparse": _sparse}


def _jax_dist(kind, js, jgeom, jc, **kw):
    """The JAX package's distributed trace on make_grid_mesh(8): (tuple of
    per-level rate fields, diagnostics)."""
    mesh = jmesh.make_grid_mesh(P)
    args = (jgeom, jc.sources, jc.tables, mesh)
    kw = dict(max_pixel_level=MPL, dtype=jnp.float64, **kw)
    if kind == "uniform":
        rf, d = jdist.trace_point_sources_dist(
            jmesh.shard_state(js, mesh), *args, **kw)
        return (rf,), d
    if kind == "two_level":
        rfb, rff, d = jdist.trace_point_sources_amr_dist(
            jmesh.shard_amr_state(js, mesh), *args, **kw)
        return (rfb, rff), d
    if kind == "ml":
        return jdist.trace_point_sources_ml_dist(
            jmesh.shard_multilevel_state(js, mesh), *args, **kw)
    return jdist.trace_point_sources_sparse_dist(js, *args, **kw)


def _port_dist(kind, ts, tgeom, tc, n_ranks=P, **kw):
    one, dist, shard = TRACERS[kind]
    mesh = tmesh.make_grid_mesh(n_ranks, device="cpu")
    rfs, d = dist(shard(ts, mesh), tgeom, tc.sources, tc.tables, mesh,
                  max_pixel_level=MPL, dtype=F64, **kw)
    if kind == "sparse":
        # the padding blocks shard_sparse_state appended (zero deposits)
        sizes = [ts.n ** 3] + [lv.n_blocks * lv.be ** 3 for lv in ts.levels]
        for rf, m in zip(rfs, sizes):
            for f in dataclasses.fields(rf):
                assert not bool(getattr(rf, f.name)[m:].any())
        rfs = tuple(dataclasses.replace(rf, **{
            f.name: getattr(rf, f.name)[:m] for f in dataclasses.fields(rf)})
            for rf, m in zip(rfs, sizes))
    return rfs, d


@pytest.mark.parametrize("kind,n_sources,host_phases", [
    ("uniform", 8, False), ("uniform", 5, False), ("two_level", 5, False),
    ("ml", 5, False), ("sparse", 4, False), ("sparse", 4, True)])
def test_dist_tracer_matches_jax(kind, n_sources, host_phases):
    (jgeom, js, jc), (tgeom, ts, tc) = (
        _uniform(n_sources) if kind == "uniform" else SETUPS[kind]())
    kw = dict(host_phases=True, chunk_steps=7) if host_phases else {}
    j_rfs, j_diag = _jax_dist(kind, js, jgeom, jc, **kw)
    t_rfs, t_diag = _port_dist(kind, ts, tgeom, tc, **kw)
    _rfs_close(t_rfs, j_rfs, 1e-12)
    _diag_close(t_diag, j_diag, 1e-12)
    assert t_diag.ndot_remaining.shape[0] == n_sources
    assert all(float(rf.krate24.max()) > 0.0 for rf in t_rfs)
    if host_phases:
        assert trml.LAST_TRACE_PHASE_TIMES[f"level{MPL}_alive"][-1] == 0


def test_noneq_dist_tracer_matches_jax():
    """quadrature_noneq on the L-level state of tests/test_torch_rays_ml.py
    (3 sources padded to 8, two SED buckets), the k27..k31 channels too."""
    js, ts = ml_states()
    n = ts.levels[0].shape[0]
    jgeom = jstate.GridGeometry(n, n, n, 300.0 * KPC)
    tgeom = tstate.GridGeometry(n, n, n, 300.0 * KPC)
    tables = noneq_tables()
    src = ml_sources(n)
    mesh = jmesh.make_grid_mesh(P)
    j_rfs, j_diag = jdist.trace_point_sources_ml_dist(
        jmesh.shard_multilevel_state(js, mesh), jgeom,
        jrays.SourceBatch(**src), tables, mesh, max_pixel_level=MPL,
        dtype=jnp.float64, rates_mode="quadrature_noneq")
    tm = tmesh.make_grid_mesh(P, device="cpu")
    t_rfs, t_diag = tdist.trace_point_sources_ml_dist(
        tmesh.shard_multilevel_state(ts, tm), tgeom,
        trays.SourceBatch(**src), port_tables(tables, tgeom), tm,
        max_pixel_level=MPL, dtype=F64, rates_mode="quadrature_noneq")
    assert isinstance(t_rfs[0], trays.NoneqRateFields)
    _rfs_close(t_rfs, j_rfs, 1e-12)
    _diag_close(t_diag, j_diag, 1e-12)
    assert all(float(rf.krate31.max()) > 0.0 for rf in t_rfs)


def _rank_batches(sources, n_ranks):
    """Each rank's run of the padded sources."""
    padded, _ = tdist.pad_sources(sources, n_ranks)
    m = padded.n_sources // n_ranks
    return [trays.SourceBatch(position=padded.position[r * m:(r + 1) * m],
                              weight=padded.weight[r * m:(r + 1) * m],
                              table_idx=padded.table_idx[r * m:(r + 1) * m])
            for r in range(n_ranks)]


@pytest.mark.parametrize("kind", list(TRACERS))
def test_dist_tracer_is_the_sum_of_rank_traces(kind):
    """P = 8 (5, 5, 5 and 4 sources: padded splits): the sum over ranks,
    in rank order, of the single-device traces of each rank's sources
    within 1e-13 of each peak -- and bit for bit, as on the CPU it is; the
    diagnostics are the single-device trace's of all sources; at P = 1 the
    single-device tracer bit for bit."""
    _, (tgeom, ts, tc) = SETUPS[kind]()
    one = TRACERS[kind][0]
    kw = dict(max_pixel_level=MPL, dtype=F64)
    rfs, diag = _port_dist(kind, ts, tgeom, tc)
    total = None
    for batch in _rank_batches(tc.sources, P):
        part, _ = one(ts, tgeom, batch, tc.tables, **kw)
        total = part if total is None else tuple(
            dataclasses.replace(a, **{f.name: getattr(a, f.name)
                                      + getattr(b, f.name)
                                      for f in dataclasses.fields(a)})
            for a, b in zip(total, part))
    _rfs_close(rfs, total, 1e-13)
    for a, b in zip(rfs, total):
        for f in dataclasses.fields(a):
            assert torch.equal(getattr(a, f.name), getattr(b, f.name))
    ref_rfs, ref_diag = one(ts, tgeom, tc.sources, tc.tables, **kw)
    _rfs_close(rfs, ref_rfs, 1e-13)
    _diag_close(diag, ref_diag, 1e-13)
    p1_rfs, p1_diag = _port_dist(kind, ts, tgeom, tc, n_ranks=1)
    for a, b in zip(p1_rfs, ref_rfs):
        for f in dataclasses.fields(a):
            assert torch.equal(getattr(a, f.name), getattr(b, f.name))
    for f in dataclasses.fields(p1_diag):
        assert torch.equal(getattr(p1_diag, f.name), getattr(ref_diag,
                                                             f.name))


def test_f32_rank_strided_deposits_survive_a_flushing_index_add(monkeypatch):
    """test_torch_rays.py's flushing-index_add_ cell (bench_step's cut to
    16^3, 2000 kpc, 8 sources, the gas at a neutral fraction of 1e-3) traced
    on 4 ranks: the float32 trace into the rank-strided accumulators keeps
    every deposit float32 can hold (times rays._deposit_scale's power of
    two, those below float32's smallest subnormal alone lost) and holds
    every channel within 1e-5 of its peak of the float64 trace with the
    same kills."""
    from radiativetransfer_tpu_torch.bench import bench_sources
    n = 16
    tiny = torch.finfo(torch.float32).tiny
    geom = tstate.GridGeometry(n, n, n, 2000.0 * KPC)
    pop = tstellar.blackbody_population(q_ionizing=1.0e51)
    kills = dict(tau_kill=trays.default_tau_kill(torch.float32),
                 rel_kill=trays.default_rel_kill(torch.float32))
    index_add = torch.Tensor.index_add_

    def flushing(self, dim, index, source, **kw):
        if self.dtype == torch.float32:
            source = torch.where(source.abs() < tiny, 0.0, source)
        return index_add(self, dim, index, source, **kw)

    rf = {}
    for dtype in (torch.float64, torch.float32):
        ctx = tstep.StellarContext.build(pop, bench_sources(n, 8), geom,
                                         10.0 * MYR, metal_coefs=[(0, 0.0)],
                                         max_pixel_level=3, dtype=dtype,
                                         device="cpu")
        state = tstate.uniform_state(n, nh=2e-4, tgas=1.5e4, x_neutral=1e-3,
                                     dtype=dtype, device="cpu")
        fields = {k: getattr(state, name).reshape(-1)
                  for k, name in (("HI", "HI"), ("HeI", "HeI"),
                                  ("HeII", "HeII"), ("nH", "nh"),
                                  ("abun2", "abun2"))}
        # the source-parallel tracer's march (rays_dist's), with the
        # float32 kills in both dtypes
        with monkeypatch.context() as mp:
            mp.setattr(torch.Tensor, "index_add_", flushing)
            out, _ = trays._trace_all_phases(
                fields, tdist._spawn(ctx.sources, dtype, "cpu", n),
                ctx.tables, geom, 8, 0, 3, dtype, "quadrature", n_ranks=4,
                **kills)
        rf[dtype] = torch.stack([getattr(out, f.name).double()
                                 for f in dataclasses.fields(out)])
    a, b = rf[torch.float32], rf[torch.float64]
    below = int(((b != 0) & (b.abs() < tiny)).sum())
    assert below > 0.1 * int((b != 0).sum())
    lost = (b != 0) & (a == 0)
    assert not bool((lost & (b.abs() >= 2.0 ** -149)).any())
    for i in range(len(b)):
        assert float((a[i] - b[i]).abs().max()) <= 1e-5 * float(
            b[i].abs().max())
    assert float(b[0].max()) > 0.0 and float(b[3].max()) > 0.0


def test_pad_sources_matches_jax():
    batch = _batch(trays, 5, 11, 0.15, 0.85)
    jb = _batch(jrays, 5, 11, 0.15, 0.85)
    for k in (1, 4, 5, 8):
        (tp, tn), (jp, jn) = tdist.pad_sources(batch, k), \
            jdist.pad_sources(jb, k)
        assert tn == jn == 5
        for name in ("position", "weight", "table_idx"):
            np.testing.assert_array_equal(getattr(tp, name),
                                          getattr(jp, name))
            assert getattr(tp, name).dtype == getattr(jp, name).dtype
    assert JRunConfig().tracer_strategy == "sources"
