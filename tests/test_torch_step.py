"""PyTorch port through the public API: RTModel.setup ->
initialize_equilibrium -> make_step() -> step -> neutral_fraction, against
the JAX package's RTModel on the same NumPy state; mode 9, and modes 8 and
1 with a StellarContext (make_step(stellar))."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import radiativetransfer_tpu_torch as rt
from radiativetransfer_tpu.core import rays as jrays
from radiativetransfer_tpu.core import state as jstate
from radiativetransfer_tpu.core import step as jstep
from radiativetransfer_tpu.tables import stellar as jstellar
from radiativetransfer_tpu_torch.config import (
    MODE_BOTH_STELLAR_UVB_TRANSFER,
    MODE_NO_STARS_THIN_UVB,
    MODE_STELLAR_TRANSFER_THIN_UVB,
    MODE_UVB_TRANSFER_ONLY,
    RunConfig,
)
from radiativetransfer_tpu_torch.constants import KPC, MH, MYR, PSI
from radiativetransfer_tpu_torch.core import rays as trays
from radiativetransfer_tpu_torch.tables import stellar as tstellar

# neutral fractions of one f32 step on the 24^3 anchor setup, as the JAX
# package's 8-device dry run records them (MULTICHIP_r05.json): mode 9, and
# mode 8 with 11 sources
ANCHOR_NF = 0.044220
ANCHOR8_NF = 0.033307


def _cfg(mode=MODE_UVB_TRANSFER_ONLY, level=1, **kw):
    return RunConfig(mode=mode, current_redshift=6.55, n_angular_level=level,
                     reionization_model=10, **kw)


def _nf64(HI, nh):
    return float(np.sum(np.asarray(HI, np.float64))
                 / np.sum(np.asarray(nh, np.float64)))


def _to_numpy(jax_state):
    return {f.name: (None if getattr(jax_state, f.name) is None
                     else np.asarray(getattr(jax_state, f.name)))
            for f in dataclasses.fields(jax_state)}


@pytest.mark.parametrize("mode", [MODE_UVB_TRANSFER_ONLY,
                                  MODE_NO_STARS_THIN_UVB])
def test_setup_coefficients_match(mode):
    geom = rt.GridGeometry(6, 6, 6, 200.0 * KPC)
    jm = jstep.RTModel.setup(_cfg(mode), geom, dtype=jnp.float64)
    tm = rt.RTModel.setup(_cfg(mode), geom, torch.float64, "cpu")
    np.testing.assert_array_equal(tm.uvb, jm.uvb)
    assert tm.alpha_bands == jm.alpha_bands
    assert tm.gamma_thin == jm.gamma_thin
    assert tm.heat_thin == jm.heat_thin
    if jm.opacity_coef is None:
        assert tm.opacity_coef is None
    else:
        assert dataclasses.asdict(tm.opacity_coef) == \
            dataclasses.asdict(jm.opacity_coef)
    for name in ("ksi_matrix", "ksi_all", "gamma_matrix"):
        t, j = getattr(tm, name), getattr(jm, name)
        if j is None:
            assert t is None
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(tm.dev_tables.k16.numpy(),
                                  np.asarray(jm.dev_tables.k16))
    np.testing.assert_array_equal(tm.dev_tables.cool.numpy(),
                                  np.asarray(jm.dev_tables.cool))
    # the device tables are buffers of the module
    expected = {"dev_tables.k16", "dev_tables.cool"}
    if mode == MODE_UVB_TRANSFER_ONLY:
        expected |= {"ksi_matrix", "ksi_all", "gamma_matrix"}
    assert {n for n, _ in tm.named_buffers()} == expected


def test_mode9_steps_match_jax_f64():
    n = 6
    rng = np.random.default_rng(7)
    nh = 1e-3 * rng.lognormal(0.0, 1.0, (n, n, n))
    geom = rt.GridGeometry(n, n, n, 50.0 * KPC)
    cfg = _cfg()
    js = jstate.make_state(nh * MH / PSI, np.full(nh.shape, 1.5e4), nh,
                           dtype=jnp.float64)
    ts = rt.FieldState.from_numpy(_to_numpy(js), dtype=torch.float64,
                                  device="cpu")
    jm = jstep.RTModel.setup(cfg, geom, dtype=jnp.float64)
    tm = rt.RTModel.setup(cfg, geom, torch.float64, "cpu")
    js = jm.initialize_equilibrium(js)
    ts = tm.initialize_equilibrium(ts)
    jstep_fn, tstep_fn = jm.make_step(), tm.make_step()
    for _ in range(2):
        js, ts = jstep_fn(js), tstep_fn(ts)
        j_np, t_np = _to_numpy(js), ts.to_numpy()
        for name in ("HI", "HeI", "HeII", "Jmean", "hydroHeating"):
            np.testing.assert_allclose(t_np[name], j_np[name], rtol=1e-9,
                                       atol=0.0, err_msg=name)
        assert tm.neutral_fraction(ts) == pytest.approx(
            jm.neutral_fraction(js), rel=1e-9)


def test_mode9_anchor_f32():
    n = 24
    geom = rt.GridGeometry(n, n, n, 200.0 * KPC)
    jm = jstep.RTModel.setup(_cfg(), geom, dtype=jnp.float32)
    js = jm.make_step()(jstate.uniform_state(n, nh=1e-4, tgas=2e4,
                                             dtype=jnp.float32))
    nf_jax = jm.neutral_fraction(js)
    tm = rt.RTModel.setup(_cfg(), geom, torch.float32, "cpu")
    ts = tm.make_step()(rt.uniform_state(n, nh=1e-4, tgas=2e4,
                                         dtype=torch.float32, device="cpu"))
    nf = tm.neutral_fraction(ts)
    assert ts.HI.dtype == torch.float32
    # the two states reduced by one float64 sum: the JAX package's own f32
    # jnp.sum on the CPU carries ~1e-4 of accumulated rounding at 24^3
    # (0.0442166 vs 0.0442204), which the fields themselves do not
    assert _nf64(ts.HI.numpy(), ts.nh.numpy()) == pytest.approx(
        _nf64(js.HI, js.nh), rel=1e-5)
    assert nf == pytest.approx(ANCHOR_NF, rel=1e-4)
    assert nf_jax == pytest.approx(ANCHOR_NF, rel=1e-4)


def test_unported_paths_raise():
    geom = rt.GridGeometry(4, 4, 4, 50.0 * KPC)
    tm = rt.RTModel.setup(_cfg(), geom, torch.float64, "cpu")
    state = rt.uniform_state(4, dtype=torch.float64, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP item 15"):
        tm.transport_chemistry_step(state, mesh=object())
    with pytest.raises(NotImplementedError, match="ROADMAP item 15"):
        tm.make_step(stellar=object(), mesh=object())
    base = tm.config
    tm.config = dataclasses.replace(base, tracer_compact=True)
    with pytest.raises(NotImplementedError, match="ROADMAP item 7"):
        tm.make_step(stellar=object())
    tm.config = dataclasses.replace(base, tracer_strategy="domain")
    with pytest.raises(NotImplementedError, match="ROADMAP item 15"):
        tm.make_step(stellar=object())
    tm.config = dataclasses.replace(base, sweep_strategy="zones")
    with pytest.raises(NotImplementedError, match="ROADMAP item 15"):
        tm.make_step()(state)
    with pytest.raises(NotImplementedError, match="ROADMAP item 9"):
        rt.StellarContext.build(tstellar.blackbody_population(),
                                _batch(trays, np.full((1, 3), 0.5)), geom,
                                10.0 * MYR, [(0, 0.0)], noneq=True,
                                device="cpu")


def test_state_numpy_round_trip():
    rng = np.random.default_rng(0)
    rho = rng.lognormal(0, 1, (3, 4, 5)) * 1e-27
    s = rt.make_state(rho, np.full(rho.shape, 1e4), rho * PSI / MH,
                      dtype=torch.float64, device="cpu")
    back = rt.FieldState.from_numpy(s.to_numpy(), dtype=torch.float64,
                                    device="cpu")
    for f in dataclasses.fields(s):
        a, b = getattr(s, f.name), getattr(back, f.name)
        assert (a is None and b is None) or torch.equal(a, b), f.name


# ---------------------------------------------------------------------------
# Point sources: StellarContext and the mode-8 (and mode-1) step
# ---------------------------------------------------------------------------


def _batch(mod, pos):
    n_src = len(pos)
    return mod.SourceBatch(position=pos, weight=np.ones(n_src),
                           table_idx=np.zeros(n_src, np.int32))


def _anchor8_inputs(n=24, mode=MODE_BOTH_STELLAR_UVB_TRANSFER):
    """The JAX package's dry-run mode-8 setup (__graft_entry__.py:96-113)
    on one device: 11 sources from seed 0, not snapped, maxPixelLevel 2."""
    pos = np.random.default_rng(0).uniform(0.2, 0.8, (11, 3))
    return _cfg(mode), rt.GridGeometry(n, n, n, 200.0 * KPC), pos


def _contexts(geom, pos, dtype, **kw):
    jctx = jstep.StellarContext.build(
        jstellar.blackbody_population(), _batch(jrays, pos), geom,
        10.0 * MYR, metal_coefs=[(0, 0.0)], max_pixel_level=2, **kw)
    tctx = rt.StellarContext.build(
        tstellar.blackbody_population(), _batch(trays, pos), geom,
        10.0 * MYR, metal_coefs=[(0, 0.0)], max_pixel_level=2, dtype=dtype,
        device="cpu", **kw)
    return jctx, tctx


def test_stellar_context_tables_identical():
    _, geom, pos = _anchor8_inputs()
    jctx, tctx = _contexts(geom, pos, torch.float64, dust_approximation=1)
    assert tctx.tables.keys() == jctx.tables.keys()
    for k, v in jctx.tables.items():
        assert tctx.tables[k].dtype == torch.float64
        np.testing.assert_array_equal(tctx.tables[k].numpy(), np.asarray(v),
                                      err_msg=k)
    assert (tctx.n_stars_specific_age, tctx.dust_approximation,
            tctx.max_pixel_level) == (jctx.n_stars_specific_age,
                                      jctx.dust_approximation,
                                      jctx.max_pixel_level)
    # the device defaults to the card: no silent CPU fallback
    assert "device" in rt.StellarContext.build.__kwdefaults__
    assert rt.StellarContext.build.__kwdefaults__["device"] == "cuda"


@pytest.fixture(scope="module")
def mode8_runs():
    """One mode-8 step of each package on the 24^3 anchor setup, float32
    and float64, each neutral fraction summed in float64."""
    cfg, geom, pos = _anchor8_inputs()
    out = {}
    for jd, td in ((jnp.float32, torch.float32), (jnp.float64, torch.float64)):
        jctx, tctx = _contexts(geom, pos, td)
        jm = jstep.RTModel.setup(cfg, geom, dtype=jd)
        js, jdiag = jm.make_step(jctx)(jstate.uniform_state(
            24, nh=1e-4, tgas=2e4, dtype=jd))
        tm = rt.RTModel.setup(cfg, geom, td, "cpu")
        ts, tdiag = tm.make_step(tctx)(rt.uniform_state(
            24, nh=1e-4, tgas=2e4, dtype=td, device="cpu"))
        out[td] = dict(nf_jax=_nf64(js.HI, js.nh),
                       nf=_nf64(ts.HI.numpy(), ts.nh.numpy()),
                       nf_model=tm.neutral_fraction(ts), ts=ts,
                       jdiag=jdiag, tdiag=tdiag)
    return out


def test_mode8_step_matches_jax_f64(mode8_runs):
    r = mode8_runs[torch.float64]
    # 1e-7: the JAX tracer computes the cell faces in float32 even in a
    # float64 run (ROADMAP section 4), the port in float64; at n = 24 that
    # moves the faces by ~6e-8 and the deposits by ~5e-6 of their largest
    # value (with the float32 faces emulated the two agree to ~2e-16)
    assert r["nf"] == pytest.approx(r["nf_jax"], rel=1e-7)
    assert r["ts"].HI.dtype == torch.float64
    for f in dataclasses.fields(r["jdiag"]):
        np.testing.assert_allclose(getattr(r["tdiag"], f.name).numpy(),
                                   np.asarray(getattr(r["jdiag"], f.name)),
                                   rtol=1e-9, atol=1e-300, err_msg=f.name)


def test_mode8_step_fields_match_jax_f64():
    # the fields themselves, cell by cell: n = 16 keeps the cell faces
    # exact in float32, so the two steps agree to rounding (~6e-13 of a
    # field's largest value) and an error that cancels in the neutral
    # fraction's sum still shows
    cfg, geom, pos = _anchor8_inputs(16)
    jctx, tctx = _contexts(geom, pos, torch.float64)
    jm = jstep.RTModel.setup(cfg, geom, dtype=jnp.float64)
    tm = rt.RTModel.setup(cfg, geom, torch.float64, "cpu")
    js, _ = jm.make_step(jctx)(jstate.uniform_state(
        16, nh=1e-4, tgas=2e4, dtype=jnp.float64))
    ts, _ = tm.make_step(tctx)(rt.uniform_state(
        16, nh=1e-4, tgas=2e4, dtype=torch.float64, device="cpu"))
    j_np, t_np = _to_numpy(js), ts.to_numpy()
    for name in ("HI", "HeI", "HeII", "krate24", "krate25", "krate26",
                 "crate24", "crate25", "crate26"):
        np.testing.assert_allclose(t_np[name], j_np[name], rtol=1e-9,
                                   atol=1e-9 * np.abs(j_np[name]).max(),
                                   err_msg=name)
    assert float(ts.krate24.sum()) > 0.0 and float(ts.crate24.sum()) > 0.0


def test_mode8_anchor_f32(mode8_runs):
    r = mode8_runs[torch.float32]
    assert r["ts"].HI.dtype == torch.float32
    # summed in float64 as the mode-9 anchor test does
    assert r["nf"] == pytest.approx(r["nf_jax"], rel=1e-5)
    assert r["nf_model"] == pytest.approx(ANCHOR8_NF, rel=1e-4)


def test_mode1_step_matches_jax_f64():
    # mode 1: point sources under the optically thin uniform UVB with the
    # self-shielding switch; no sweep.  n = 16 keeps the cell faces exact in
    # float32, so the two tracers agree to rounding
    cfg, geom, pos = _anchor8_inputs(16, MODE_STELLAR_TRANSFER_THIN_UVB)
    assert cfg.run_stellar_transfer and not cfg.run_uvb_transfer
    jctx, tctx = _contexts(geom, pos, torch.float64)
    jm = jstep.RTModel.setup(cfg, geom, dtype=jnp.float64)
    tm = rt.RTModel.setup(cfg, geom, torch.float64, "cpu")
    js, _ = jm.transport_chemistry_step(
        jstate.uniform_state(16, nh=1e-3, tgas=2e4, dtype=jnp.float64), jctx)
    ts, _ = tm.transport_chemistry_step(
        rt.uniform_state(16, nh=1e-3, tgas=2e4, dtype=torch.float64,
                         device="cpu"), tctx)
    j_np, t_np = _to_numpy(js), ts.to_numpy()
    for name in ("HI", "HeI", "HeII", "krate24", "crate24", "krate26"):
        np.testing.assert_allclose(t_np[name], j_np[name], rtol=1e-9,
                                   atol=1e-9 * np.abs(j_np[name]).max(),
                                   err_msg=name)
    assert float(ts.krate24.sum()) > 0.0
