"""Non-equilibrium 9-species H/He/H2 chemistry with optional energy evolution.

Port of the JAX package's core/chemistry_noneq.py to plain PyTorch.  The
reference tabulates the 9-species reaction network -- k1..k19 collisional
rates, the k22 three-body H2 channel and the density-dependent H2
collisional dissociation k13dd (coll_rates.f:3-234, colh2diss.f:3-120,
calc_rates.f:3-759) -- but only ever solves the H/He photoionization
equilibrium (solveRateEquations, equiSources.f90:3459-3677).  This module
is the non-equilibrium update the tables were built for:

* the integrator is the positivity-preserving sequential BDF1 scheme of
  Anninos et al. (1997, NewA 2, 209): each species is updated as
  ``x <- (x + dt*C) / (1 + dt*D)`` with creation C and destruction D
  evaluated Gauss-Seidel style, the fast species H- and H2+ held in
  algebraic equilibrium;
* every cell carries its own remaining time and per-cell timestep (10%
  electron-density / HI / H2 / energy change), advanced by a Python loop
  of exactly n_substeps substeps over tensors: cells that finish early
  take zero-length substeps, so the loop has no data-dependent exit and
  reads nothing back from the device;
* all rate coefficients come from the same 5000-bin log-T tables as the
  equilibrium path (tables/chemistry_rates.py), gathered once per substep.

What differs from the JAX package: the loop runs eagerly, one PyTorch op
at a time (XLA fused the JAX `lax.scan` body into one elementwise kernel),
and a lookup gathers its table's columns first, so each rate is a
contiguous tensor.  `_substep_rates` computes only the species a caller
asks for; XLA drops the unused ones from the JAX program the same way.

Photoionization/photodissociation channels k24..k31 follow the reference's
numbering (sigma24..sigma31, uniformTable.f90:28-103): 24 HI, 25 HeII,
26 HeI, 27 H- photodetachment, 28 H2+ -> HI+HII, 29 H2 -> H2+ + e,
30 H2+ -> 2HII + e, 31 H2 Lyman-Werner dissociation.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..constants import DLOGTEM, GAMMA_ADIABATIC, KB, LOGTEM0, LOGTEM9

# the species of SpeciesState, in the order of its fields
SPECIES = ("HI", "HII", "HeI", "HeII", "HeIII", "de", "HM", "H2I", "H2II")


class NoneqTablesDevice(nn.Module):
    """Device-resident rate/cooling tables for the 9-species network, as
    buffers.

    kcol: (nratec, 20) log of the collisional rates k1..k19, k22.
    k13dd: (nratec, 7) density-dependent H2 CID fit functions.
    cool: (nratec, 13) log of the atomic cooling terms (the columns of
        chemistry.RateTablesDevice.cool).
    h2cool: (nratec, 2) log of the Galli & Palla (1998) H2 cooling: the
        low-density limit gpldl [erg cm^3/s per (H2 * HI)] and LTE gphdl
        [erg/s per H2].
    """

    def __init__(self, kcol: torch.Tensor, k13dd: torch.Tensor,
                 cool: torch.Tensor, h2cool: torch.Tensor, compa: float):
        super().__init__()
        self.register_buffer("kcol", kcol)
        self.register_buffer("k13dd", k13dd)
        self.register_buffer("cool", cool)
        self.register_buffer("h2cool", h2cool)
        self.compa = compa

    @classmethod
    def from_tables(cls, tables, dtype: torch.dtype,
                    device: torch.device | str) -> "NoneqTablesDevice":
        names = [f"k{i}" for i in range(1, 20)] + ["k22"]
        kcol = np.stack([tables.k[n] for n in names], axis=-1)
        cool = np.stack([
            tables.ceHI, tables.ceHeI, tables.ceHeII, tables.ciHI,
            tables.ciHeI, tables.ciHeIS, tables.ciHeII, tables.reHII,
            tables.reHeII1, tables.reHeII2, tables.reHeIII, tables.brem,
            tables.lineHI], axis=-1)
        h2cool = np.stack([tables.gpldl, tables.gphdl], axis=-1)

        # the rate tables span ~1e-40..1e-8: the logs are taken on the host
        # in float64 and cast to the run's dtype (float32-safe, and the
        # interpolation is more accurate for the steep exponential rates)
        def dev(x):
            return torch.as_tensor(x, dtype=dtype, device=device)
        return cls(kcol=dev(np.log(np.maximum(kcol, 1e-300))),
                   k13dd=dev(tables.k13dd),
                   cool=dev(np.log(np.maximum(cool, 1e-300))),
                   h2cool=dev(np.log(np.maximum(h2cool, 1e-300))),
                   compa=float(tables.compa))


@dataclasses.dataclass
class SpeciesState:
    """Number densities [cm^-3] of the 9-species network plus internal
    energy density [erg/cm^3].  All tensors share one grid shape."""
    HI: torch.Tensor
    HII: torch.Tensor
    HeI: torch.Tensor
    HeII: torch.Tensor
    HeIII: torch.Tensor
    de: torch.Tensor
    HM: torch.Tensor
    H2I: torch.Tensor      # H2 molecule number density (molecules)
    H2II: torch.Tensor
    eint: torch.Tensor

    @property
    def nh(self) -> torch.Tensor:
        """Total hydrogen nuclei [cm^-3]."""
        return self.HI + self.HII + self.HM + 2.0 * (self.H2I + self.H2II)

    @property
    def nhe(self) -> torch.Tensor:
        return self.HeI + self.HeII + self.HeIII

    @property
    def ntot(self) -> torch.Tensor:
        """Total particle number density (free electrons included)."""
        return (self.HI + self.HII + self.HeI + self.HeII + self.HeIII
                + self.de + self.HM + self.H2I + self.H2II)

    @property
    def tgas(self) -> torch.Tensor:
        """Temperature from the internal energy [K]."""
        return (GAMMA_ADIABATIC - 1.0) * self.eint / (KB * self.ntot)

    def charge_electrons(self) -> torch.Tensor:
        """Electron density implied by charge neutrality."""
        return self.HII + self.HeII + 2.0 * self.HeIII + self.H2II - self.HM


@dataclasses.dataclass(frozen=True)
class PhotoRates:
    """Per-particle photo rates [1/s] and the photoheating rate density
    [erg/cm^3/s].  Floats or tensors broadcastable to the grid shape."""
    k24: torch.Tensor | float = 0.0   # HI + g -> HII + e
    k25: torch.Tensor | float = 0.0   # HeII + g -> HeIII + e
    k26: torch.Tensor | float = 0.0   # HeI + g -> HeII + e
    k27: torch.Tensor | float = 0.0   # H- + g -> HI + e
    k28: torch.Tensor | float = 0.0   # H2+ + g -> HI + HII
    k29: torch.Tensor | float = 0.0   # H2 + g -> H2+ + e
    k30: torch.Tensor | float = 0.0   # H2+ + g -> 2 HII + e
    k31: torch.Tensor | float = 0.0   # H2 + g -> 2 HI   (Lyman-Werner)
    heat: torch.Tensor | float = 0.0  # photoheating [erg/cm^3/s]


def _tiny(dtype: torch.dtype) -> float:
    # both are normal numbers of their dtype
    return 1e-300 if dtype == torch.float64 else 1e-37


def species_from_field_state(state, f_h2: float = 0.0,
                             f_hm: float = 0.0) -> SpeciesState:
    """Initialize the 9-species state from a FieldState (H/He fields).

    f_h2 / f_hm: initial H2 / H- fractions of total hydrogen nuclei.
    Internal energy follows from state.tgas.
    """
    nh, nhe = state.nh, state.nhe
    H2I = 0.5 * f_h2 * nh
    HM = f_hm * nh
    HI = torch.clamp(state.HI - 2.0 * H2I - HM, min=0.0)
    HII = torch.clamp(nh - HI - HM - 2.0 * H2I, min=0.0)
    HeI, HeII = state.HeI, state.HeII
    HeIII = torch.clamp(nhe - HeI - HeII, min=0.0)
    z = torch.zeros_like(nh)
    sp = SpeciesState(HI=HI, HII=HII, HeI=HeI, HeII=HeII, HeIII=HeIII,
                      de=z, HM=HM, H2I=H2I, H2II=z, eint=z)
    de = torch.clamp(sp.charge_electrons(), min=0.0)
    sp = dataclasses.replace(sp, de=de)
    eint = KB * state.tgas * sp.ntot / (GAMMA_ADIABATIC - 1.0)
    return dataclasses.replace(sp, eint=eint)


def _interp_columns(table_2d, logtem):
    """Linear log-T interpolation of every column of a (nratec, m) table,
    columns first: (m, *logtem.shape).  The clip comes before the cast,
    which truncates toward zero as the JAX package's astype(int32) does."""
    logtem = torch.clamp(logtem, LOGTEM0, LOGTEM9)
    pos = (logtem - LOGTEM0) / DLOGTEM
    idx = torch.clamp(pos.to(torch.int32), 0, table_2d.shape[0] - 2).long()
    frac = pos - idx.to(pos.dtype)
    cols = table_2d.t()
    lo = cols[:, idx]
    hi = cols[:, idx + 1]
    return lo + frac * (hi - lo)


def _lookup_log(table_2d, logtem):
    """Linear interpolation of log-stored columns; returns exp of the
    result, (*logtem.shape, m)."""
    return torch.exp(_interp_columns(table_2d, logtem)).movedim(0, -1)


def _lookup_lin(table_2d, logtem):
    return _interp_columns(table_2d, logtem).movedim(0, -1)


def _k13_density_dependent(k13dd_row, HI, tgas):
    """Density-dependent H2 collisional dissociation rate [cm^3/s].

    Composes the 7 tabulated fit functions as the reference's consumer
    contract documents (colh2diss.f:110-113):

      log10 k13 = f1 - f2/(1 + (nH/f5)^f7) + f3 - f4/(1 + (nH/f6)^f7)

    with nH = n_HI [cm^-3].  f1/f2/f5 carry the direct collisional
    dissociation process, f3/f4/f6 the dissociative tunnelling process
    (Martin, Schwartz & Mandy 1996 fits; colh2diss.f:74-104).  Outside the
    fit's validity range (500 K < T < 1e6 K; colh2diss.f:57-66) the rate is
    floored to 1e-60, the reference's `CID = -60` convention.
    """
    f = tuple(k13dd_row[..., i] for i in range(7))
    lognH = torch.log10(torch.clamp(HI, min=1e-10))
    # (n/f5)^f7 evaluated in log space for overflow safety
    x5 = torch.clamp(f[6] * (lognH - torch.log10(torch.clamp(f[4],
                                                              min=1e-30))),
                     -30.0, 30.0)
    x6 = torch.clamp(f[6] * (lognH - torch.log10(torch.clamp(f[5],
                                                              min=1e-30))),
                     -30.0, 30.0)
    logk = (f[0] - f[1] / (1.0 + 10.0 ** x5)
            + f[2] - f[3] / (1.0 + 10.0 ** x6))
    valid = (tgas > 500.0) & (tgas < 1.0e6)
    logk = torch.where(valid, torch.clamp(logk, -60.0, 0.0),
                       torch.full_like(logk, -60.0))
    return 10.0 ** logk


_ALL_RATES = ("HI", "HII", "de", "HeI", "HeII", "HeIII", "H2I")


def _substep_rates(sp: SpeciesState, k, photo: PhotoRates, k13,
                   names=_ALL_RATES):
    """Creation/destruction terms for the sequential BDF1 update, for the
    species in `names`.

    Returns a dict of (creation, destruction) pairs per species, where the
    update is x_new = (x + dt*C) / (1 + dt*D) and D has units 1/s.
    """
    (k1, k2, k3, k4, k5, k6, k7, k8, k9, k10, k11, k12, _k13t, k14, k15,
     k16, k17, k18, k19, k22) = k
    HI, HII, de = sp.HI, sp.HII, sp.de
    HeI, HeII, HeIII = sp.HeI, sp.HeII, sp.HeIII
    HM, H2I, H2II = sp.HM, sp.H2I, sp.H2II

    rates = {}
    if "HI" in names:
        # created by recombination and the H2 destruction channels,
        # destroyed by ionization and the molecular formation chain
        c_HI = (k2 * HII * de
                + 2.0 * k12 * H2I * de
                + k11 * H2I * HII
                + 2.0 * k13 * H2I * HI
                + k14 * HM * de
                + k15 * HM * HI
                + 2.0 * k16 * HM * HII
                + 2.0 * k18 * H2II * de
                + k19 * H2II * HM
                + photo.k27 * HM
                + photo.k28 * H2II
                + 2.0 * photo.k31 * H2I)
        d_HI = (k1 * de + k7 * de + k8 * HM + k9 * HII + k10 * H2II
                + 2.0 * k22 * HI * HI + photo.k24)
        rates["HI"] = (c_HI, d_HI)
    if "HII" in names:
        c_HII = (k1 * HI * de + k10 * H2II * HI + photo.k24 * HI
                 + photo.k28 * H2II + 2.0 * photo.k30 * H2II)
        d_HII = k2 * de + k9 * HI + k11 * H2I + (k16 + k17) * HM
        rates["HII"] = (c_HII, d_HII)
    if "de" in names:
        c_de = (k1 * HI * de + k3 * HeI * de + k5 * HeII * de
                + k8 * HM * HI + k14 * HM * de + k15 * HM * HI
                + k17 * HM * HII
                + photo.k24 * HI + photo.k25 * HeII + photo.k26 * HeI
                + photo.k27 * HM + photo.k29 * H2I + photo.k30 * H2II)
        d_de = (k2 * HII + k4 * HeII + k6 * HeIII + k7 * HI + k18 * H2II)
        rates["de"] = (c_de, d_de)
    if "HeI" in names:
        c_HeI = k4 * HeII * de
        d_HeI = k3 * de + photo.k26
        rates["HeI"] = (c_HeI, d_HeI)
    if "HeII" in names:
        c_HeII = k3 * HeI * de + k6 * HeIII * de + photo.k26 * HeI
        d_HeII = (k4 + k5) * de + photo.k25
        rates["HeII"] = (c_HeII, d_HeII)
    if "HeIII" in names:
        c_HeIII = k5 * HeII * de + photo.k25 * HeII
        d_HeIII = k6 * de
        rates["HeIII"] = (c_HeIII, d_HeIII)
    if "H2I" in names:
        c_H2 = (k8 * HM * HI + k10 * H2II * HI + k19 * H2II * HM
                + k22 * HI ** 3)
        d_H2 = k11 * HII + k12 * de + k13 * HI + photo.k29 + photo.k31
        rates["H2I"] = (c_H2, d_H2)
    return rates


def _equilibrium_hm_h2ii(sp: SpeciesState, k, photo: PhotoRates, tiny):
    """Algebraic equilibrium for the fast species H- and H2+
    (Anninos et al. 1997 section 3; lifetimes ~<1e4 s wherever they
    matter)."""
    (k1, k2, k3, k4, k5, k6, k7, k8, k9, k10, k11, k12, _k, k14, k15,
     k16, k17, k18, k19, k22) = k
    HI, HII, de, H2I = sp.HI, sp.HII, sp.de, sp.H2I
    HM = (k7 * HI * de) / torch.clamp(
        k8 * HI + k14 * de + k15 * HI + (k16 + k17) * HII
        + k19 * sp.H2II + photo.k27, min=tiny)
    H2II = (k9 * HI * HII + k11 * H2I * HII + k17 * HM * HII
            + photo.k29 * H2I) / torch.clamp(
        k10 * HI + k18 * de + k19 * HM + photo.k28 + photo.k30, min=tiny)
    return HM, H2II


def _cooling_rate(sp: SpeciesState, tgas, tables: NoneqTablesDevice,
                  current_redshift: float):
    """Net radiative cooling [erg/cm^3/s] (positive = cooling): the atomic
    cooling function of thermalEquilibrium (equiSources.f90:3991-4029)
    plus Galli & Palla (1998) H2 cooling from the tabulated gpldl/gphdl
    fits."""
    logt = torch.log(tgas)
    (ceHI, ceHeI, ceHeII, ciHI, ciHeI, ciHeIS, ciHeII, reHII, reHeII1,
     reHeII2, reHeIII, brem, _lineHI) = torch.exp(
        _interp_columns(tables.cool, logt)).unbind(0)
    de, HI, HII = sp.de, sp.HI, sp.HII
    HeI, HeII, HeIII = sp.HeI, sp.HeII, sp.HeIII

    comp1 = tables.compa * (1.0 + current_redshift) ** 4
    comp2 = 2.73 * (1.0 + current_redshift)

    cool = (ceHI * HI * de
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
            + brem * (HII + HeII + 4.0 * HeIII) * de)

    gpldl, gphdl = torch.exp(_interp_columns(tables.h2cool, logt)).unbind(0)
    # Galli & Palla smooth low-density <-> LTE interpolation
    lam_h2 = sp.H2I * gphdl / (1.0 + gphdl / torch.clamp(
        gpldl * HI, min=_tiny(de.dtype)))
    return cool + lam_h2


# the largest relative change of de, HI, H2 (and eint) in one substep
SAFETY = 0.1


def evolve_noneq(sp: SpeciesState, dt: float, tables: NoneqTablesDevice,
                 photo: PhotoRates | None = None,
                 n_substeps: int = 200,
                 evolve_energy: bool = True,
                 tgas_fixed: torch.Tensor | None = None,
                 current_redshift: float = 0.0) -> SpeciesState:
    """Advance the 9-species network by dt [s].

    Fixed-trip-count vectorized sub-cycling: each cell consumes its own
    remaining time with per-cell steps limited to SAFETY (10%) relative
    change in electron density, HI and H2 (and internal energy, when
    evolved).  Cells that finish early take zero-length substeps.  If
    n_substeps is too small for the stiffest cell the update is still
    positivity-preserving; the remaining deficit shows up as first-order
    error (pick n_substeps ~ a few hundred for cold dense gas).

    With evolve_energy=False the temperature is held at tgas_fixed (or
    sp.tgas at entry), the reference's fixed-T contract.
    """
    if photo is None:
        photo = PhotoRates()
    tiny = _tiny(sp.HI.dtype)
    if tgas_fixed is None:
        tgas_fixed = sp.tgas

    nh0 = sp.nh
    nhe0 = sp.nhe
    floor = 1e-6 * nh0
    remaining = torch.full_like(sp.HI, dt)

    def bdf(x, cd, dt):
        c, d = cd
        return (x + dt * c) / (1.0 + dt * d)

    def limit(x, cd):
        c, d = cd
        xdot = c - d * x
        return SAFETY * torch.maximum(x, floor) / torch.clamp(
            torch.abs(xdot), min=tiny)

    for _ in range(n_substeps):
        tgas = sp.tgas if evolve_energy else tgas_fixed
        tgas = torch.clamp(tgas, 1.0, 1e9)
        logtem = torch.log(tgas)
        k = torch.exp(_interp_columns(tables.kcol, logtem)).unbind(0)
        k13dd_row = _interp_columns(tables.k13dd, logtem).movedim(0, -1)
        k13 = _k13_density_dependent(k13dd_row, sp.HI, tgas)
        k = k[:12] + (k13,) + k[13:]

        # --- timestep limiter ---------------------------------------------
        r = _substep_rates(sp, k, photo, k13, ("HI", "HII", "de", "H2I"))
        dt_de = limit(sp.de, r["de"])
        dt_hi = limit(sp.HI, r["HI"])
        # H2 can evolve on its own timescale while de/HI are static (pure
        # Lyman-Werner dissociation), so it gets its own limiter; the
        # 1e-6*nh floor keeps trace-level H2 from throttling ionized gas
        dt_h2 = limit(sp.H2I, r["H2I"])
        dtit = torch.minimum(torch.minimum(torch.minimum(dt_de, dt_hi),
                                           dt_h2), remaining)
        if evolve_energy:
            cool = _cooling_rate(sp, tgas, tables, current_redshift)
            edot = photo.heat - cool
            dt_e = SAFETY * sp.eint / torch.clamp(torch.abs(edot), min=tiny)
            dtit = torch.minimum(dtit, dt_e)
        dtit = torch.clamp(dtit, min=0.0)

        # --- sequential BDF1 update (Gauss-Seidel in species) -------------
        HI = bdf(sp.HI, r["HI"], dtit)
        HII = bdf(sp.HII, r["HII"], dtit)
        sp1 = dataclasses.replace(sp, HI=HI, HII=HII)
        r1 = _substep_rates(sp1, k, photo, k13, ("de",))
        de = bdf(sp.de, r1["de"], dtit)
        sp1 = dataclasses.replace(sp1, de=de)
        r2 = _substep_rates(sp1, k, photo, k13, ("HeI", "HeII", "HeIII"))
        HeI = bdf(sp.HeI, r2["HeI"], dtit)
        HeII = bdf(sp.HeII, r2["HeII"], dtit)
        HeIII = bdf(sp.HeIII, r2["HeIII"], dtit)
        sp1 = dataclasses.replace(sp1, HeI=HeI, HeII=HeII, HeIII=HeIII)
        HM, H2II = _equilibrium_hm_h2ii(sp1, k, photo, tiny)
        sp1 = dataclasses.replace(sp1, HM=HM, H2II=H2II)
        r3 = _substep_rates(sp1, k, photo, k13, ("H2I",))
        H2I = bdf(sp.H2I, r3["H2I"], dtit)
        sp1 = dataclasses.replace(sp1, H2I=H2I)

        # --- conservation rescale (Anninos 97 eq. 27 analog) --------------
        h_tot = sp1.HI + sp1.HII + sp1.HM + 2.0 * (sp1.H2I + sp1.H2II)
        fh = nh0 / torch.clamp(h_tot, min=tiny)
        he_tot = sp1.HeI + sp1.HeII + sp1.HeIII
        fhe = nhe0 / torch.clamp(he_tot, min=tiny)
        sp1 = dataclasses.replace(
            sp1, HI=sp1.HI * fh, HII=sp1.HII * fh, HM=sp1.HM * fh,
            H2I=sp1.H2I * fh, H2II=sp1.H2II * fh,
            HeI=sp1.HeI * fhe, HeII=sp1.HeII * fhe, HeIII=sp1.HeIII * fhe)
        sp1 = dataclasses.replace(
            sp1, de=torch.clamp(sp1.charge_electrons(), min=tiny))

        if evolve_energy:
            cool = _cooling_rate(sp1, tgas, tables, current_redshift)
            eint = torch.maximum(sp1.eint + dtit * (photo.heat - cool),
                                 0.1 * sp1.eint)
        else:
            # keep eint consistent with the fixed temperature
            eint = KB * tgas_fixed * sp1.ntot / (GAMMA_ADIABATIC - 1.0)
        sp = dataclasses.replace(sp1, eint=eint)
        remaining = remaining - dtit
    return sp
