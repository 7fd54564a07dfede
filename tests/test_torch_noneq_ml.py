"""PyTorch port, the non-equilibrium 9-species chemistry on nested grids
(core/step_amr.py::MultiLevelModel.make_noneq_step) against the JAX
package's on the same NumPy inputs, on the CPU.

Two- and three-level states at an 8^3 base (tests/test_torch_rays_ml.py's
maps: 30% of the base refined, then 30% of the covered level-1 cells),
each level in its own ionization equilibrium with an H2 reservoir of 1e-4
of the nuclei, angular level 1, float64: two steps of 2 Myr and 20
substeps in modes 9 and 8 (two sources, maxPixelLevel 3), every level's
species, fields and rates within 1e-9 of each one's peak, the ray
diagnostics and the neutral fraction too; refined parents hold their
children's average species.  An unrefined two-level grid steps its base
as the uniform noneq step does."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import radiativetransfer_tpu_torch as rt
from radiativetransfer_tpu.core import amr as jamr
from radiativetransfer_tpu.core import chemistry_noneq as jcn
from radiativetransfer_tpu.core import rays as jrays
from radiativetransfer_tpu.core import state as jstate
from radiativetransfer_tpu.core import step as jstep
from radiativetransfer_tpu.core import step_amr as jstep_amr
from radiativetransfer_tpu.tables import stellar as jstellar
from radiativetransfer_tpu_torch.config import (
    MODE_BOTH_STELLAR_UVB_TRANSFER,
    MODE_UVB_TRANSFER_ONLY,
    RunConfig,
)
from radiativetransfer_tpu_torch.constants import KPC, MH, MYR, PSI
from radiativetransfer_tpu_torch.core import amr as tamr
from radiativetransfer_tpu_torch.core import chemistry_noneq as tcn
from radiativetransfer_tpu_torch.core import rays as trays
from radiativetransfer_tpu_torch.core import step_amr as tstep_amr
from radiativetransfer_tpu_torch.tables import stellar as tstellar
from test_torch_rays_ml import maps
from test_torch_host import jax_compile_cache

N = 8
BOX = 100.0 * KPC
F64 = torch.float64
_FIELDS = ("HI", "HeI", "HeII", "tgas", "Jmean", "krate24", "crate24")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the eager network is ~80k small CPU ops a
    level and step, on which more threads only spin beside the other test
    workers (module-scoped, so that the fixtures run pinned too)."""
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


def _cfg(mode):
    return RunConfig(mode=mode, current_redshift=6.55, n_angular_level=1,
                     reionization_model=10)


def _models(mode, n=N):
    geom = rt.GridGeometry(n, n, n, BOX)
    return (jstep.RTModel.setup(_cfg(mode), jstate.GridGeometry(n, n, n, BOX),
                                dtype=jnp.float64),
            rt.RTModel.setup(_cfg(mode), geom, F64, "cpu"))


def _np_fields(fs) -> dict:
    return {f.name: (None if getattr(fs, f.name) is None
                     else np.asarray(getattr(fs, f.name)))
            for f in dataclasses.fields(fs)}


def _states(trt, levels, n=N, seed=6, refined=None):
    """The same L-level state in both packages: a lognormal base, each
    refined level's density drawn on its own over its parents', every
    level in the port's equilibrium, synced."""
    rng = np.random.default_rng(seed)
    nh = 1e-4 * rng.lognormal(0.0, 1.0, (n,) * 3)
    base = jstate.make_state(nh * MH / PSI, np.full(nh.shape, 2e4), nh,
                             dtype=jnp.float64)
    refined = maps(n, levels) if refined is None else refined
    js = jamr.make_multilevel_state(base, refined)
    lv = list(js.levels)
    for ell in range(1, levels):
        nh_l = np.asarray(lv[ell].nh) * rng.lognormal(0.0, 0.3,
                                                      lv[ell].rho.shape)
        lv[ell] = dataclasses.replace(lv[ell], rho=jnp.asarray(nh_l * MH / PSI),
                                      HI=jnp.asarray(nh_l))
    ts = tamr.MultiLevelState.from_numpy(
        {"levels": [_np_fields(x) for x in lv], "refined": refined},
        dtype=F64, device="cpu")
    ts = tamr.sync_restriction_multi(tamr.MultiLevelState(
        levels=tuple(trt.initialize_equilibrium(x) for x in ts.levels),
        refined=ts.refined))
    js = jamr.MultiLevelState(
        levels=tuple(jstate.FieldState(**{
            k: None if v is None else jnp.asarray(v)
            for k, v in x.to_numpy().items()}) for x in ts.levels),
        refined=tuple(jnp.asarray(r) for r in refined))
    return js, ts


def _contexts(jrt, trt, n_src=2):
    pos = np.random.default_rng(9).uniform(0.3, 0.7, (n_src, 3))
    kw = dict(position=pos, weight=np.ones(n_src),
              table_idx=np.zeros(n_src, np.int32))
    jc = jstep.StellarContext.build(
        jstellar.blackbody_population(), jrays.SourceBatch(**kw), jrt.geom,
        10.0 * MYR, metal_coefs=[(0, 0.0)], max_pixel_level=3, noneq=True)
    tc = rt.StellarContext.build(
        tstellar.blackbody_population(), trays.SourceBatch(**kw), trt.geom,
        10.0 * MYR, metal_coefs=[(0, 0.0)], max_pixel_level=3, noneq=True,
        dtype=F64, device="cpu")
    return jc, tc


def _assert_peak_close(a, b, rel, name):
    a, b = a.detach().numpy(), np.asarray(b)
    peak = float(np.abs(b).max())
    assert np.abs(a - b).max() <= rel * peak, (name, peak)


@pytest.mark.parametrize("mode,levels", [
    (MODE_UVB_TRANSFER_ONLY, 2),
    (MODE_UVB_TRANSFER_ONLY, 3),
    (MODE_BOTH_STELLAR_UVB_TRANSFER, 2),
    (MODE_BOTH_STELLAR_UVB_TRANSFER, 3),
])
def test_noneq_ml_steps_match_jax(mode, levels):
    jrt, trt = _models(mode)
    js, ts = _states(trt, levels)
    j_sp = tuple(jcn.species_from_field_state(lv, f_h2=1e-4)
                 for lv in js.levels)
    t_sp = tuple(tcn.species_from_field_state(lv, f_h2=1e-4)
                 for lv in ts.levels)
    jc = tc = None
    if mode == MODE_BOTH_STELLAR_UVB_TRANSFER:
        jc, tc = _contexts(jrt, trt)
    jml = jstep_amr.MultiLevelModel.setup(jrt, levels)
    tml = tstep_amr.MultiLevelModel.setup(trt, levels)
    kw = dict(n_substeps=20, evolve_energy=False)
    j_step = jml.make_noneq_step(2.0 * MYR, jc, **kw)
    t_step = tml.make_noneq_step(2.0 * MYR, tc, **kw)
    for _ in range(2):
        j_out, t_out = j_step(js, j_sp), t_step(ts, t_sp)
        assert len(t_out) == len(j_out) == (3 if tc is not None else 2)
        js, j_sp, ts, t_sp = j_out[0], j_out[1], t_out[0], t_out[1]
        assert isinstance(t_sp, tuple) and len(t_sp) == levels
        for ell in range(levels):
            for k in tcn.SPECIES + ("eint",):
                _assert_peak_close(getattr(t_sp[ell], k),
                                   getattr(j_sp[ell], k), 1e-9, (ell, k))
            for k in _FIELDS:
                if tc is None and k in ("krate24", "crate24"):
                    assert not getattr(ts.levels[ell], k).any()
                    continue
                _assert_peak_close(getattr(ts.levels[ell], k),
                                   getattr(js.levels[ell], k), 1e-9, (ell, k))
        if tc is not None:
            for f in dataclasses.fields(j_out[2]):
                _assert_peak_close(getattr(t_out[2], f.name),
                                   getattr(j_out[2], f.name), 1e-9, f.name)
        assert tml.neutral_fraction(ts) == pytest.approx(
            jml.neutral_fraction(js), rel=1e-9)
    # the state follows the species; refined parents hold the average of
    # their children's species
    for ell in range(levels):
        assert torch.equal(ts.levels[ell].HI, t_sp[ell].HI)
    for ell in range(levels - 1):
        r = ts.refined[ell]
        for k in ("H2I", "de", "eint"):
            assert torch.equal(getattr(t_sp[ell], k)[r], tamr.restrict(
                getattr(t_sp[ell + 1], k))[r]), (ell, k)
    if tc is not None:
        # the k27..k31 deposits reach every level
        _, rfs, _ = tml.trace(tml._zero_rates(ts), tc, "quadrature_noneq")
        assert all(float(rf.krate31.max()) > 0.0 for rf in rfs)


@pytest.mark.parametrize("mode", [MODE_UVB_TRANSFER_ONLY,
                                  MODE_BOTH_STELLAR_UVB_TRANSFER])
def test_unrefined_two_levels_match_uniform_noneq(mode):
    """Nothing refined: the base level steps as RTModel.make_noneq_step
    steps the same grid (the L-level sweep of one covered level, the
    tracer's deposits all on the base), within 1e-9 of each peak."""
    jrt, trt = _models(mode)
    _, ts = _states(trt, 2, refined=[np.zeros((N,) * 3, bool)])
    tc = _contexts(jrt, trt)[1] if mode == MODE_BOTH_STELLAR_UVB_TRANSFER \
        else None
    kw = dict(n_substeps=20, evolve_energy=True)
    ml_step = tstep_amr.MultiLevelModel.setup(trt, 2).make_noneq_step(
        2.0 * MYR, tc, **kw)
    uni_step = trt.make_noneq_step(2.0 * MYR, tc, **kw)
    sp = tuple(tcn.species_from_field_state(lv, f_h2=1e-4)
               for lv in ts.levels)
    base, sp0 = ts.levels[0], sp[0]
    for _ in range(2):
        ml_out, uni_out = ml_step(ts, sp), uni_step(base, sp0)
        ts, sp, base, sp0 = ml_out[0], ml_out[1], uni_out[0], uni_out[1]
        for k in tcn.SPECIES + ("eint",):
            _assert_peak_close(getattr(sp[0], k), getattr(sp0, k).numpy(),
                               1e-9, k)
        for k in ("HI", "tgas", "Jmean", "krate24"):
            if tc is None and k == "krate24":
                continue
            _assert_peak_close(getattr(ts.levels[0], k),
                               getattr(base, k).numpy(), 1e-9, k)
