"""H/He ionization-equilibrium chemistry and the thermal balance diagnostic.

Port of the JAX package's core/chemistry.py to plain PyTorch:

* solve_rate_equations — port of solveRateEquations
  (equiSources.f90:3459-3677).  The reference bisects on the electron
  density cell-by-cell with a data-dependent stopping rule; here the
  bisection runs vectorized over the grid with a fixed iteration count
  (a Python loop of n_iter steps: 110 reach float64 machine precision,
  60 are used in float32).

* thermal_equilibrium — the cooling-function evaluation producing the
  hydroHeating diagnostic (equiSources.f90:3870-4042).  Temperature is NOT
  evolved, exactly as in the reference.

All functions are elementwise over the grid and run eagerly, one PyTorch
op at a time.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..constants import (
    DLOGTEM,
    FOUR_PI,
    LOGTEM0,
    LOGTEM9,
    SIGMA24_AT_NU1,
    SIGMA25_AT_NU3,
    SIGMA26_AT_NU2,
)


class RateTablesDevice(nn.Module):
    """Device-resident temperature tables used by the solvers, as buffers:
    k16 (nratec, 6): k1..k6; cool (nratec, 13): ceHI ceHeI ceHeII ciHI
    ciHeI ciHeIS ciHeII reHII reHeII1 reHeII2 reHeIII brem lineHI."""

    def __init__(self, k16: torch.Tensor, cool: torch.Tensor):
        super().__init__()
        self.register_buffer("k16", k16)
        self.register_buffer("cool", cool)

    @classmethod
    def from_tables(cls, tables, dtype: torch.dtype,
                    device: torch.device | str) -> "RateTablesDevice":
        cool = np.stack([
            tables.ceHI, tables.ceHeI, tables.ceHeII, tables.ciHI,
            tables.ciHeI, tables.ciHeIS, tables.ciHeII, tables.reHII,
            tables.reHeII1, tables.reHeII2, tables.reHeIII, tables.brem,
            tables.lineHI], axis=-1)
        return cls(torch.as_tensor(tables.k16(), dtype=dtype, device=device),
                   torch.as_tensor(cool, dtype=dtype, device=device))


def _tiny(dtype: torch.dtype) -> float:
    return 1e-300 if dtype == torch.float64 else 1e-37


def _lookup(table_2d, logtem):
    """Linear log-T interpolation of all columns of a (nratec, m) table.

    Mirrors equiSources.f90:3568-3586.
    """
    logtem = torch.clamp(logtem, LOGTEM0, LOGTEM9)
    pos = (logtem - LOGTEM0) / DLOGTEM
    idx = torch.clamp(pos.to(torch.int32), 0, table_2d.shape[0] - 2).long()
    frac = (pos - idx.to(pos.dtype))[..., None]
    lo = table_2d[idx]
    hi = table_2d[idx + 1]
    return lo + frac * (hi - lo)


def clamp_species(nh, nhe, HI, HeI, HeII):
    """Conservation clamps (equiSources.f90:3499-3514)."""
    HI = torch.minimum(HI, nh)
    HeIII = nhe - HeI - HeII
    # HeIII < 0: absorb into HeII; if still negative, all neutral
    HeII = torch.where(HeIII < 0.0, nhe - HeI, HeII)
    HeII = torch.clamp(HeII, min=0.0)
    HeI = torch.minimum(HeI, nhe)
    return HI, HeI, HeII


def _equilibrium_species(de, nh, nhe, k, g24, g25, g26):
    """Closed-form species given electron density de.

    The HeII-balance residual drives the bisection
    (equiSources.f90:3592-3602).  Divisions are guarded against float32
    underflow of k*de products.
    """
    k1, k2, k3, k4, k5, k6 = k
    tiny = _tiny(de.dtype)
    HII = nh / (1.0 + k2 * de / torch.clamp(k1 * de + g24, min=tiny))
    R = (k3 * de + g26) / torch.clamp(k4 * de, min=tiny)
    HeI = (de - HII - 2.0 * nhe) / (R - 2.0 - 2.0 * R)
    res = (k3 * HeI * de + k6 * (nhe - HeI - HeI * R) * de + g26 * HeI
           - HeI * R * (k4 * de + k5 * de + g25))
    return HII, R, HeI, res


def photo_rates_from_sources(krate_density, absorber_density):
    """Convert volumetric photoionization rates [1/s/cm^3] to per-particle
    rates [1/s] (equiSources.f90:3519-3543); the cell-volume division is
    folded into the source tables at build time."""
    pos = absorber_density > 0.0
    rate = torch.where(pos, krate_density / torch.where(
        pos, absorber_density, 1.0), 0.0)
    return torch.clamp(rate, min=0.0)


def diffuse_photo_rates(Jmean, ksi_matrix):
    """Photoionization rates from the three-band mean intensity
    (equiSources.f90:3546-3553).

    ksi_matrix: (3 bands, 3 species) of group ksi coefficients:
      [:,0] -> HI (ksi24), [:,1] -> HeII (ksi25), [:,2] -> HeI (ksi26).
    Returns (g24, g25, g26) tensors.
    """
    j = FOUR_PI * Jmean  # (3, ...)
    g24 = (j[0] * ksi_matrix[0, 0] + j[1] * ksi_matrix[1, 0]
           + j[2] * ksi_matrix[2, 0])
    g25 = j[2] * ksi_matrix[2, 1]
    g26 = j[1] * ksi_matrix[1, 2] + j[2] * ksi_matrix[2, 2]
    return g24, g25, g26


def uniform_photo_rates(HI, HeI, HeII, self_shielding_threshold,
                        gamma_thin: tuple[float, float, float]):
    """Optically-thin uniform UVB with the mean-free-path self-shielding
    switch (equiSources.f90:3556-3561)."""
    mfp = 1.0 / (HI * SIGMA24_AT_NU1 + HeI * SIGMA26_AT_NU2
                 + HeII * SIGMA25_AT_NU3)
    thin = (mfp >= self_shielding_threshold).to(HI.dtype)
    return (thin * gamma_thin[0], thin * gamma_thin[1],
            thin * gamma_thin[2])


def solve_equilibrium(nh, nhe, tgas, g24, g25, g26, tables: RateTablesDevice,
                      n_iter: int = 110):
    """Vectorized ionization-equilibrium solve.

    Bisection on the electron density over [1e-30, nh + 2 nhe] with the
    HeII-balance residual (equiSources.f90:3590-3633), fixed n_iter steps.

    Returns (HI, HeI, HeII, de).
    """
    kk = _lookup(tables.k16, torch.log(tgas))
    k = tuple(kk[..., i] for i in range(6))

    # lower bracket: 1e-30 in float64 (equiSources.f90:3590); scaled up for
    # float32 so k*de products stay in range
    de_hi = nh + 2.0 * nhe
    if nh.dtype == torch.float64:
        de_lo = torch.full_like(nh, 1.0e-30)
    else:
        de_lo = 1.0e-12 * de_hi
    _, _, _, res_lo = _equilibrium_species(de_lo, nh, nhe, k, g24, g25, g26)

    for _ in range(n_iter):
        de = 0.5 * (de_lo + de_hi)
        _, _, _, res = _equilibrium_species(de, nh, nhe, k, g24, g25, g26)
        opposite = ((res > 0.0) & (res_lo < 0.0)) | ((res < 0.0)
                                                     & (res_lo > 0.0))
        de_hi = torch.where(opposite, de, de_hi)
        de_lo = torch.where(opposite, de_lo, de)
        res_lo = torch.where(opposite, res_lo, res)
    de = 0.5 * (de_lo + de_hi)

    # back-substitution (equiSources.f90:3629-3632), clamped to conservation
    tiny = _tiny(nh.dtype)
    HII, R, HeI, _ = _equilibrium_species(de, nh, nhe, k, g24, g25, g26)
    HeI = torch.clamp(HeI, min=torch.zeros_like(nhe), max=nhe)
    HeII = torch.clamp(HeI * R, min=torch.zeros_like(nhe), max=nhe - HeI)
    HI = torch.clamp(k[1] * HII * de / torch.clamp(k[0] * de + g24, min=tiny),
                     min=torch.zeros_like(nh), max=nh)
    return HI, HeI, HeII, de


def solve_rate_equations(state, geom, tables: RateTablesDevice,
                         ksi_matrix=None, gamma_thin=None,
                         self_shielding_threshold=None,
                         run_uvb_transfer: bool = False, n_iter: int = 110):
    """Full chemistry update on a FieldState; returns the new state.

    Combines the rate assembly (point-source counts -> per-particle rates;
    diffuse or uniform UVB) with the equilibrium solve, then writes back the
    clamped species (solveRateEquations, equiSources.f90:3459-3677).
    """
    nh, nhe = state.nh, state.nhe
    HI, HeI, HeII = clamp_species(nh, nhe, state.HI, state.HeI, state.HeII)

    g24 = photo_rates_from_sources(state.krate24, HI)
    g25 = photo_rates_from_sources(state.krate25, HeII)
    g26 = photo_rates_from_sources(state.krate26, HeI)

    if run_uvb_transfer:
        d24, d25, d26 = diffuse_photo_rates(state.Jmean, ksi_matrix)
        g24, g25, g26 = g24 + d24, g25 + d25, g26 + d26
    elif gamma_thin is not None:
        u24, u25, u26 = uniform_photo_rates(HI, HeI, HeII,
                                            self_shielding_threshold,
                                            gamma_thin)
        g24, g25, g26 = g24 + u24, g25 + u25, g26 + u26

    HI, HeI, HeII, _ = solve_equilibrium(nh, nhe, state.tgas, g24, g25, g26,
                                         tables, n_iter)
    return dataclasses.replace(state, HI=HI, HeI=HeI, HeII=HeII)


def solve_h_only_equilibrium(nh, tgas, g24, tables: RateTablesDevice):
    """Closed-form pure-hydrogen photoionization equilibrium.

    Balance HI*(k1*de + g24) = k2*HII*de with de = HII expands to the
    quadratic (k1 + k2)*HII^2 + (g24 - nh*k1)*HII - nh*g24 = 0, solved
    with the numerically-stable root formula.
    """
    kk = _lookup(tables.k16, torch.log(tgas))
    k1, k2 = kk[..., 0], kk[..., 1]
    a = k1 + k2
    b = g24 - nh * k1
    c = -g24 * nh
    disc = torch.sqrt(torch.clamp(b * b - 4.0 * a * c, min=0.0))
    q = -0.5 * (b + torch.sign(b) * disc)
    r1 = q / torch.where(a != 0.0, a, 1.0)
    r2 = c / torch.where(q != 0.0, q, 1.0)
    HII = torch.where(a != 0.0,
                      torch.where((r1 >= 0.0) & (r1 <= nh), r1, r2),
                      -c / b)
    HII = torch.clamp(HII, min=torch.zeros_like(nh), max=nh)
    return nh - HII, HII


def thermal_equilibrium(state, heat_thin: tuple[float, float, float],
                        self_shielding_threshold: float,
                        current_redshift: float, tables: RateTablesDevice,
                        compa: float):
    """Cooling-vs-heating balance diagnostic (thermalEquilibrium,
    equiSources.f90:3870-4042).

    heat_thin = 4*pi*(uniformQuasar*gammaX_q + uniformStellar*gammaX_s) for
    X in (HI, HeII, HeI): the optically-thin photo-heating coefficients
    per absorber (:3931-3933).

    Returns the new state with hydroHeating = max(0, -edot).
    """
    nh, nhe = state.nh, state.nhe
    HI, HeI, HeII = clamp_species(nh, nhe, state.HI, state.HeI, state.HeII)
    HII = nh - HI
    HeIII = nhe - HeI - HeII
    de = HII + HeII + 2.0 * HeIII
    tgas = state.tgas

    mfp = 1.0 / (HI * SIGMA24_AT_NU1 + HeI * SIGMA26_AT_NU2
                 + HeII * SIGMA25_AT_NU3)
    thin = mfp >= self_shielding_threshold
    crate = torch.where(thin, heat_thin[0] * HI + heat_thin[1] * HeII
                        + heat_thin[2] * HeI, 0.0)

    c = _lookup(tables.cool, torch.log(tgas))
    (ceHI, ceHeI, ceHeII, ciHI, ciHeI, ciHeIS, ciHeII, reHII, reHeII1,
     reHeII2, reHeIII, brem, lineHI) = (c[..., i] for i in range(13))

    comp1 = compa * (1.0 + current_redshift) ** 4
    comp2 = 2.73 * (1.0 + current_redshift)

    edot = -(
        ceHI * HI * de
        + ceHeI * HeI * de ** 2
        + ceHeII * HeII * de
        + ciHI * HI * de
        + ciHeI * HeI * de
        + ciHeII * HeII * de
        + ciHeIS * HeII * de ** 2
        + reHII * HII * de
        + reHeII1 * HeII * de
        + reHeII2 * HeII * de
        + reHeIII * HeIII * de
        + comp1 * (tgas - comp2) * de
        + brem * (HII + HeII + 4.0 * HeIII) * de
    )
    edot = edot + crate
    return dataclasses.replace(state, hydroHeating=torch.clamp(-edot,
                                                               min=0.0))
