"""PyTorch port, the mode-9 slice through the public API: RTModel.setup ->
initialize_equilibrium -> make_step() -> step -> neutral_fraction, against
the JAX package's RTModel on the same NumPy state."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import radiativetransfer_tpu_torch as rt
from radiativetransfer_tpu.core import state as jstate
from radiativetransfer_tpu.core import step as jstep
from radiativetransfer_tpu_torch.config import (
    MODE_NO_STARS_THIN_UVB,
    MODE_UVB_TRANSFER_ONLY,
    RunConfig,
)
from radiativetransfer_tpu_torch.constants import KPC, MH, PSI

# neutral fraction of one f32 mode-9 step on the 24^3 anchor setup, as the
# JAX package's 8-device dry run records it (MULTICHIP_r05.json)
ANCHOR_NF = 0.044220


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
    with pytest.raises(NotImplementedError, match="ROADMAP item 7"):
        tm.make_step(stellar=object())
    with pytest.raises(NotImplementedError, match="ROADMAP item 15"):
        tm.transport_chemistry_step(state, mesh=object())
    tm.config = dataclasses.replace(tm.config, sweep_strategy="zones")
    with pytest.raises(NotImplementedError, match="ROADMAP item 15"):
        tm.make_step()(state)


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
