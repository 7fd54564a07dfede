"""PyTorch port, chemistry: the eager PyTorch solvers against the JAX
package's on the same seeded random cells."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from radiativetransfer_tpu.core import chemistry as jchem
from radiativetransfer_tpu.core import state as jstate
from radiativetransfer_tpu.tables import chemistry_rates as jrates
from radiativetransfer_tpu_torch.config import MODE_UVB_TRANSFER_ONLY, RunConfig
from radiativetransfer_tpu_torch.constants import COMPA, KPC, MH, MHE, PSI
from radiativetransfer_tpu_torch.core import chemistry as tchem
from radiativetransfer_tpu_torch.core.state import FieldState, GridGeometry
from radiativetransfer_tpu_torch.core.step import RTModel

# f64: the same ops in the same order, up to the rounding of fused or
# reordered sums; f32: the same, at single precision
RTOL = {torch.float64: 1e-10, torch.float32: 1e-5}
JDTYPE = {torch.float64: jnp.float64, torch.float32: jnp.float32}
SHAPE = (6, 5, 4)


@pytest.fixture(scope="module")
def model():
    """Coefficients of a mode-9 model (host floats/arrays), f64."""
    cfg = RunConfig(mode=MODE_UVB_TRANSFER_ONLY, current_redshift=6.55,
                    n_angular_level=1, reionization_model=10)
    return RTModel.setup(cfg, GridGeometry(4, 4, 4, 100.0 * KPC),
                         torch.float64, "cpu")


def _fields(seed, model):
    """Seeded random cells: densities spanning thin and self-shielded,
    temperatures across the table, partial ionization, point-source
    rates and diffuse band intensities."""
    rng = np.random.default_rng(seed)
    nh = np.exp(rng.normal(np.log(1e-4), 2.0, SHAPE))
    rho = nh * MH / PSI
    nhe = (1.0 - PSI) * rho / MHE
    x = rng.uniform(0.0, 1.0, SHAPE)
    z = np.zeros(SHAPE)
    uvb = np.asarray(model.uvb)
    return {
        "rho": rho, "tgas": 10.0 ** rng.uniform(3.0, 6.0, SHAPE),
        "HI": x * nh, "HeI": 0.5 * x * nhe, "HeII": 0.3 * (1 - x) * nhe,
        "abun2": np.full(SHAPE, 0.02),
        "krate24": x * nh * 10.0 ** rng.uniform(-15, -11, SHAPE),
        "krate25": 0.3 * (1 - x) * nhe * 10.0 ** rng.uniform(-16, -12, SHAPE),
        "krate26": 0.5 * x * nhe * 10.0 ** rng.uniform(-15, -12, SHAPE),
        "crate24": z, "crate25": z, "crate26": z,
        "Jmean": uvb[:, None, None, None]
        * 10.0 ** rng.uniform(-3.0, 0.0, (3,) + SHAPE),
        "hydroHeating": z, "vel": None,
    }


def _states(fields, dtype):
    jax_state = jstate.FieldState(**{
        k: (None if v is None else jnp.asarray(v, JDTYPE[dtype]))
        for k, v in fields.items()})
    jax_np = {k: (None if v is None else np.asarray(v))
              for k, v in vars(jax_state).items()}
    return jax_state, FieldState.from_numpy(jax_np, dtype=dtype, device="cpu")


def _jax_tables(dtype):
    return jchem.RateTablesDevice.from_tables(jrates.calc_rates(),
                                              JDTYPE[dtype])


def _close(t, j, dtype):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL[dtype],
                               atol=0.0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_solve_equilibrium(model, dtype):
    jstate_, tstate = _states(_fields(1, model), dtype)
    g = [np.array(x) for x in jchem.diffuse_photo_rates(
        jstate_.Jmean, jnp.asarray(model.ksi_matrix.numpy(),
                                   JDTYPE[dtype]))]
    out_j = jchem.solve_equilibrium(jstate_.nh, jstate_.nhe, jstate_.tgas,
                                    *[jnp.asarray(x) for x in g],
                                    _jax_tables(dtype), n_iter=110)
    tables = tchem.RateTablesDevice.from_tables(model.tables, dtype, "cpu")
    out_t = tchem.solve_equilibrium(tstate.nh, tstate.nhe, tstate.tgas,
                                    *[torch.from_numpy(x) for x in g],
                                    tables, n_iter=110)
    for t, j in zip(out_t, out_j):
        _close(t, j, dtype)


@pytest.mark.parametrize("diffuse", [True, False])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_solve_rate_equations(model, dtype, diffuse):
    jstate_, tstate = _states(_fields(2, model), dtype)
    n_iter = 110 if dtype == torch.float64 else 60
    kw = dict(gamma_thin=model.gamma_thin,
              self_shielding_threshold=model.config.self_shielding_threshold,
              run_uvb_transfer=diffuse, n_iter=n_iter)
    out_j = jchem.solve_rate_equations(
        jstate_, None, _jax_tables(dtype),
        ksi_matrix=jnp.asarray(model.ksi_matrix.numpy(), JDTYPE[dtype]), **kw)
    out_t = tchem.solve_rate_equations(
        tstate, None, tchem.RateTablesDevice.from_tables(model.tables, dtype,
                                                         "cpu"),
        ksi_matrix=model.ksi_matrix.to(dtype), **kw)
    for name in ("HI", "HeI", "HeII"):
        _close(getattr(out_t, name), getattr(out_j, name), dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_thermal_equilibrium(model, dtype):
    jstate_, tstate = _states(_fields(3, model), dtype)
    kw = dict(heat_thin=model.heat_thin,
              self_shielding_threshold=model.config.self_shielding_threshold,
              current_redshift=model.config.current_redshift, compa=COMPA)
    out_j = jchem.thermal_equilibrium(jstate_, tables=_jax_tables(dtype),
                                      **kw)
    out_t = tchem.thermal_equilibrium(
        tstate, tables=tchem.RateTablesDevice.from_tables(model.tables, dtype,
                                                          "cpu"), **kw)
    _close(out_t.hydroHeating, out_j.hydroHeating, dtype)


def test_h_only_equilibrium(model):
    rng = np.random.default_rng(4)
    nh = 10.0 ** rng.uniform(-6, 0, 64)
    tgas = 10.0 ** rng.uniform(3.5, 5.5, 64)
    g24 = 10.0 ** rng.uniform(-16, -11, 64)
    out_j = jchem.solve_h_only_equilibrium(
        jnp.asarray(nh), jnp.asarray(tgas), jnp.asarray(g24),
        _jax_tables(torch.float64))
    out_t = tchem.solve_h_only_equilibrium(
        torch.from_numpy(nh), torch.from_numpy(tgas), torch.from_numpy(g24),
        tchem.RateTablesDevice.from_tables(model.tables, torch.float64,
                                           "cpu"))
    for t, j in zip(out_t, out_j):
        _close(t, j, torch.float64)
