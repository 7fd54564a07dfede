"""PyTorch port, one step of each model on a 1-D mesh of 4 ranks against
the JAX package's step on its make_grid_mesh(4) (4 of its 8 virtual CPU
devices), and against the port's one-device step, on the CPU in float64.

The models and inputs: the uniform 16^3 box in mode 8 (6 sources), the
two-level 8^3 box of TestShardedAMR in mode 8, the L-level 8^3 box of
TestShardedMultiLevel in mode 8 and in noneq mode 8, the block-sparse
clustered grid of tests/test_torch_noneq_sparse.py in mode 8 and noneq
mode 8 (the source-parallel tracer's quadrature_noneq deposits, the zones
sweep).  Fields within 1e-10 of each peak on covered cells (the
diagnostics too) of JAX's mesh step and of the port's one-device step.
Where the two packages' steps on a mesh differ by more than 1e-10 of a
field's peak, their one-device steps must differ as much (to 1e-10 of the
peak): on the block-sparse grid the one-device packages' equilibrium
chemistry under the point sources already puts HeI 4.0e-10 and HeII
1.5e-9 of their peaks apart (the one-device parity tests hold mode-8
steps to 1e-9, tests/test_torch_step_ml.py), and the mesh moves neither
package by more than ~4e-15."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import radiativetransfer_tpu_torch as rt
from radiativetransfer_tpu.config import RunConfig as JRunConfig
from radiativetransfer_tpu.core import amr as jamr
from radiativetransfer_tpu.core import chemistry_noneq as jcn
from radiativetransfer_tpu.core import rays as jrays
from radiativetransfer_tpu.core import state as jstate
from radiativetransfer_tpu.core import step as jstep
from radiativetransfer_tpu.core import step_amr as jstep_amr
from radiativetransfer_tpu.parallel import mesh as jmesh
from radiativetransfer_tpu.tables import stellar as jstellar
from radiativetransfer_tpu_torch.config import (
    MODE_BOTH_STELLAR_UVB_TRANSFER,
    RunConfig,
)
from radiativetransfer_tpu_torch.constants import KPC, MYR
from radiativetransfer_tpu_torch.core import amr as tamr
from radiativetransfer_tpu_torch.core import chemistry_noneq as tcn
from radiativetransfer_tpu_torch.core import rays as trays
from radiativetransfer_tpu_torch.core import step_amr as tstep_amr
from radiativetransfer_tpu_torch.parallel import mesh as tmesh
from radiativetransfer_tpu_torch.tables import stellar as tstellar
from test_torch_host import jax_compile_cache
import test_torch_noneq_sparse as nsp

F64 = torch.float64
P = 4


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
# one step of each model on a mesh
# ---------------------------------------------------------------------------


def _cfg(mod_cfg, mode):
    return mod_cfg(mode=mode, current_redshift=6.55, n_angular_level=1,
                   reionization_model=10, grid="t")


def _ctx_pair(jgeom, tgeom, n_src, seed, lo, hi, noneq=False):
    rng = np.random.default_rng(seed)
    src = dict(position=rng.uniform(lo, hi, (n_src, 3)),
               weight=rng.integers(1, 4, n_src).astype(np.float64),
               table_idx=np.zeros(n_src, np.int32))
    kw = dict(metal_coefs=[(0, 0.0)], max_pixel_level=3, noneq=noneq)
    return (jstep.StellarContext.build(
        jstellar.blackbody_population(), jrays.SourceBatch(**src), jgeom,
        10.0 * MYR, **kw),
        rt.StellarContext.build(
            tstellar.blackbody_population(), trays.SourceBatch(**src), tgeom,
            10.0 * MYR, dtype=F64, device="cpu", **kw))


def _rts(n, box_kpc):
    jgeom = jstate.GridGeometry(n, n, n, box_kpc * KPC)
    tgeom = rt.GridGeometry(n, n, n, box_kpc * KPC)
    mode = MODE_BOTH_STELLAR_UVB_TRANSFER
    return (jstep.RTModel.setup(_cfg(JRunConfig, mode), jgeom,
                                dtype=jnp.float64),
            rt.RTModel.setup(_cfg(RunConfig, mode), tgeom, F64, "cpu"))


_FIELDS = ("HI", "HeI", "HeII", "tgas", "Jmean", "krate24", "crate26")


def _diag_close(t, j):
    for f in dataclasses.fields(t):
        _close(getattr(t, f.name), getattr(j, f.name), 1e-10, f.name)


def _uniform_step():
    jrt, trt = _rts(16, 50.0)
    jc, tc = _ctx_pair(jrt.geom, trt.geom, 6, 11, 0.15, 0.85)
    js = jstate.uniform_state(16, nh=1e-3, tgas=1e4, dtype=jnp.float64)
    ts = rt.uniform_state(16, nh=1e-3, tgas=1e4, dtype=F64, device="cpu")
    jm, tm = jmesh.make_grid_mesh(P), tmesh.make_grid_mesh(P, device="cpu")
    jo, jd = jrt.make_step(jc, mesh=jm)(jmesh.shard_state(js, jm))
    to, td = trt.make_step(tc, mesh=tm)(tmesh.shard_state(ts, tm))
    t1, _ = trt.make_step(tc)(ts)
    full = np.ones((16,) * 3, bool)
    return [to], [jo], [t1], lambda: [jrt.make_step(jc)(js)[0]], [full], \
        td, jd


def _two_level_step():
    """TestShardedAMR._amr_setup(n=8, with_sources=True)'s box."""
    n = 8
    jrt, trt = _rts(n, 300.0)
    jc, tc = _ctx_pair(jrt.geom, trt.geom, 5, 3, 0.2, 0.8)
    refined = np.zeros((n, n, n), bool)
    refined[2:5, 3:6, 2:5] = True
    js = jamr.make_amr_state(jstate.uniform_state(
        n, nh=2e-3, tgas=1e4, dtype=jnp.float64), jnp.asarray(refined))
    ts = tamr.make_amr_state(rt.uniform_state(
        n, nh=2e-3, tgas=1e4, dtype=F64, device="cpu"),
        torch.as_tensor(refined))
    jm, tm = jmesh.make_grid_mesh(P), tmesh.make_grid_mesh(P, device="cpu")
    jam, tam = (jstep_amr.AMRModel.setup(jrt),
                tstep_amr.AMRModel.setup(trt))
    jo, jd = jam.make_step(jc, mesh=jm)(jmesh.shard_amr_state(js, jm))
    to, td = tam.make_step(tc, mesh=tm)(tmesh.shard_amr_state(ts, tm))
    t1, _ = tam.make_step(tc)(ts)

    def jax_one():
        j1, _ = jam.make_step(jc)(js)
        return [j1.base, j1.fine]
    fine = np.repeat(np.repeat(np.repeat(refined, 2, 0), 2, 1), 2, 2)
    return ([to.base, to.fine], [jo.base, jo.fine], [t1.base, t1.fine],
            jax_one, [np.ones((n,) * 3, bool), fine], td, jd)


def _ml_states():
    """TestShardedMultiLevel._ml_setup's 8^3 box with two refined levels,
    partly ionized."""
    n = 8
    refined = [np.zeros((n, n, n), bool), np.zeros((2 * n,) * 3, bool)]
    refined[0][2:6, 3:7, 2:6] = True
    refined[1][6:10, 7:11, 6:10] = True
    refined = jamr.enforce_balance(refined)
    js = jamr.make_multilevel_state(jstate.uniform_state(
        n, nh=2e-3, tgas=1e4, x_neutral=0.3, dtype=jnp.float64), refined)
    ts = tamr.make_multilevel_state(rt.uniform_state(
        n, nh=2e-3, tgas=1e4, x_neutral=0.3, dtype=F64, device="cpu"),
        [torch.as_tensor(r) for r in refined])
    return js, ts


def _ml_step(noneq):
    jrt, trt = _rts(8, 300.0)
    jc, tc = _ctx_pair(jrt.geom, trt.geom, 5, 7, 0.2, 0.8, noneq=noneq)
    js, ts = _ml_states()
    jm, tm = jmesh.make_grid_mesh(P), tmesh.make_grid_mesh(P, device="cpu")
    jml = jstep_amr.MultiLevelModel.setup(jrt, 3)
    tml = tstep_amr.MultiLevelModel.setup(trt, 3)
    js_sh = jmesh.shard_multilevel_state(js, jm)
    ts_sh = tmesh.shard_multilevel_state(ts, tm)
    jsp = tuple(jcn.species_from_field_state(lv) for lv in js.levels)
    tsp = tuple(tcn.species_from_field_state(lv) for lv in ts.levels)

    def run(model, state, species, ctx, mesh=None):
        if noneq:
            out = model.make_noneq_step(MYR, ctx, n_substeps=5, mesh=mesh)(
                state, species)
            return out[0], out[2]
        return model.make_step(ctx, mesh=mesh)(state)
    jo, jd = run(jml, js_sh, tuple(jmesh.shard_species(x, jm) for x in jsp),
                 jc, jm)
    to, td = run(tml, ts_sh, tuple(tmesh.shard_species(x, tm) for x in tsp),
                 tc, tm)
    t1, _ = run(tml, ts, tsp, tc)
    covers = [m.numpy() for m in _covers(ts)]
    return (list(to.levels), list(jo.levels), list(t1.levels),
            lambda: list(run(jml, js, jsp, jc)[0].levels), covers, td, jd)


def _covers(ml):
    """Each level's covered cells."""
    out = [torch.ones_like(ml.refined[0])]
    for r in ml.refined:
        c = r & out[-1]
        out.append(c.repeat_interleave(2, 0).repeat_interleave(2, 1)
                   .repeat_interleave(2, 2))
    return out


def _sparse_step(noneq):
    """tests/test_torch_noneq_sparse.py's clustered grid (seed 23, each
    level in equilibrium, blocks of 8) with its 3 sources."""
    jrt, trt = nsp.models(MODE_BOTH_STELLAR_UVB_TRANSFER)
    jsp, tsp, _ = nsp.states(trt)
    jc, tc = nsp.contexts(jrt, trt)
    jm, tm = jmesh.make_grid_mesh(P), tmesh.make_grid_mesh(P, device="cpu")
    jmod = jstep_amr.SparseMLModel.setup(jrt, 3)
    tmod = tstep_amr.SparseMLModel.setup(trt, 3)
    t_sh = tmesh.shard_sparse_state(tsp, tm)

    def run(model, state, species, ctx, mesh=None):
        if noneq:
            out = model.make_noneq_step(MYR, ctx, n_substeps=5, mesh=mesh)(
                state, species)
            return out[0], out[2]
        return model.make_step(ctx, mesh=mesh)(state)

    def levels(out):
        # the real blocks (shard_sparse_state appended zero padding blocks)
        return [out.base] + [dataclasses.replace(lv.fields, **{
            f.name: getattr(lv.fields, f.name)[..., :lv0.n_blocks, :, :, :]
            for f in dataclasses.fields(lv.fields)
            if getattr(lv.fields, f.name) is not None})
            for lv, lv0 in zip(out.levels, tsp.levels)]
    jo, jd = run(jmod, jsp, nsp.jax_species(jmod, jsp), jc, jm)
    to, td = run(tmod, t_sh, tmesh.shard_sparse_species(
        tmod.initial_species(tsp), tm), tc, tm)
    for lv, lv0 in zip(to.levels, tsp.levels):
        assert lv.n_blocks % P == 0 and lv.n_blocks >= lv0.n_blocks
    t1, _ = run(tmod, tsp, tmod.initial_species(tsp), tc)

    def jax_one():
        return levels(run(jmod, jsp, nsp.jax_species(jmod, jsp), jc)[0])
    covers = [np.ones((8,) * 3, bool)] + [lv.cover.numpy()
                                          for lv in tsp.levels]
    return (levels(to), [jo.base] + [lv.fields for lv in jo.levels],
            levels(t1), jax_one, covers, td, jd)


STEPS = {"uniform_mode8": _uniform_step, "two_level_mode8": _two_level_step,
         "ml_mode8": lambda: _ml_step(False),
         "ml_noneq_mode8": lambda: _ml_step(True),
         "sparse_mode8": lambda: _sparse_step(False),
         "sparse_noneq_mode8": lambda: _sparse_step(True)}


@pytest.mark.parametrize("case", list(STEPS))
def test_mesh_step_matches_jax(case):
    t_levels, j_levels, t_one, jax_one, covers, td, jd = STEPS[case]()
    j_one = None
    for ell, (t, j, t1, cov) in enumerate(zip(t_levels, j_levels, t_one,
                                              covers)):
        for name in _FIELDS:
            a, b, a1 = (_np(getattr(x, name))[..., cov] for x in (t, j, t1))
            what = f"level {ell} {name}"
            _close(a, a1, 1e-10, what + " against one device")
            peak = float(np.abs(b).max())
            err = float(np.abs(a - b).max())
            if err > 1e-10 * peak:
                # the packages' one-device steps differ as much
                j_one = jax_one() if j_one is None else j_one
                b1 = _np(getattr(j_one[ell], name))[..., cov]
                gap = float(np.abs(a1 - b1).max())
                assert err <= gap + 1e-10 * peak, (what, err, gap, peak)
    _diag_close(td, jd)
