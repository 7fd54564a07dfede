"""Dense field state for the transport + chemistry solve.

The reference stores per-cell physics in a pointer octree (zoneType,
definitionsModule.f90:163-180).  The port keeps the JAX package's
level-dense arrays: a uniform base level (nx, ny, nz) of torch tensors on
one device.  `FieldState` is a plain dataclass of tensors; functions that
update it return a new state (`dataclasses.replace`), as the JAX package
does, so a caller can keep the previous state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..constants import MH, MHE, PSI


@dataclasses.dataclass
class FieldState:
    """Prognostic + diagnostic fields on a uniform (nx, ny, nz) grid.

    Number densities in cm^-3, temperature in K, rho in g/cm^3.
    krate* are volumetric photoionization rates from point sources
    (converted to per-particle rates in the chemistry step); crate* are the
    matching heating rates.  Jmean holds the angle-averaged mean
    intensities of the three diffuse bands [erg/cm^2/s/Hz/sr].
    """
    rho: torch.Tensor
    tgas: torch.Tensor
    HI: torch.Tensor
    HeI: torch.Tensor
    HeII: torch.Tensor
    abun2: torch.Tensor       # oxygen (metallicity) abundance, dust scaling
    krate24: torch.Tensor
    krate25: torch.Tensor
    krate26: torch.Tensor
    crate24: torch.Tensor
    crate25: torch.Tensor
    crate26: torch.Tensor
    Jmean: torch.Tensor       # (3, nx, ny, nz)
    hydroHeating: torch.Tensor
    # optional kinematics, carried for I/O round-trips only
    vel: torch.Tensor | None = None    # (3, nx, ny, nz) [km/s] or None

    @property
    def shape(self) -> tuple[int, int, int]:
        return tuple(self.rho.shape)

    @property
    def nh(self) -> torch.Tensor:
        """Total hydrogen number density [cm^-3] (psi*rho/mh)."""
        return PSI * self.rho / _scalar(MH, self.rho)

    @property
    def nhe(self) -> torch.Tensor:
        """Total helium number density [cm^-3]."""
        return (1.0 - PSI) * self.rho / _scalar(MHE, self.rho)

    def zero_rates(self) -> "FieldState":
        """Reset per-iteration accumulators (setZeroRates,
        equiSources.f90:4128-4155)."""
        z = torch.zeros_like(self.krate24)
        return dataclasses.replace(
            self, krate24=z, krate25=z, krate26=z,
            crate24=z, crate25=z, crate26=z)

    @classmethod
    def from_numpy(cls, fields: dict, *, dtype: torch.dtype,
                   device: torch.device | str) -> "FieldState":
        """State from a dict of arrays keyed by field name (e.g. a JAX
        FieldState converted field by field with np.asarray); a missing or
        None `vel` stays None.  The arrays are copied."""
        def t(x):
            return torch.as_tensor(np.array(x), dtype=dtype, device=device)
        vel = fields.get("vel")
        return cls(**{f.name: t(fields[f.name])
                      for f in dataclasses.fields(cls) if f.name != "vel"},
                   vel=None if vel is None else t(vel))

    def to_numpy(self) -> dict:
        """Dict of NumPy arrays keyed by field name (vel None if absent)."""
        return {f.name: (None if getattr(self, f.name) is None
                         else getattr(self, f.name).detach().cpu().numpy())
                for f in dataclasses.fields(self)}


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """`value` as a 0-d tensor on `like`'s device and dtype.  Dividing by
    it is a true division on every device, where CUDA divides a tensor by a
    Python number as a product with its reciprocal, an ulp off in ~1 value
    of 10; the equilibrium chemistry's helium clamp (nhe - HeI - HeII near
    0) and the per-particle rates (a deposit over the clamped HeII) turn
    that ulp of nhe into 3e-9 of HeII's peak after a mode-8 step (ROADMAP,
    faults found in the port)."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def make_state(rho, tgas, HI, HeI=None, HeII=None, abun2=None, vel=None, *,
               dtype: torch.dtype = torch.float32,
               device: torch.device | str) -> FieldState:
    """Build a FieldState from density/temperature/neutral-H arrays.

    Helium defaults to fully neutral, matching grid ingestion
    (placeCellProjectWithVelocity, equiSources.f90:1941-1943); abun2 defaults
    to 0.02 (equiSources.f90:1958).
    """
    def t(x):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               dtype=dtype, device=device)
    rho = t(rho)
    shape = tuple(rho.shape)
    nhe = (1.0 - PSI) * rho / MHE
    HeI = nhe if HeI is None else t(HeI)
    HeII = (torch.zeros(shape, dtype=dtype, device=device) if HeII is None
            else t(HeII))
    abun2 = (torch.full(shape, 0.02, dtype=dtype, device=device)
             if abun2 is None else t(abun2))
    z = torch.zeros(shape, dtype=dtype, device=device)
    return FieldState(
        rho=rho, tgas=t(tgas), HI=t(HI), HeI=HeI, HeII=HeII, abun2=abun2,
        krate24=z, krate25=z, krate26=z, crate24=z, crate25=z, crate26=z,
        Jmean=torch.zeros((3,) + shape, dtype=dtype, device=device),
        hydroHeating=z, vel=None if vel is None else t(vel))


def uniform_state(n: int, nh: float = 1.0e-3, tgas: float = 1.0e4,
                  x_neutral: float = 1.0, *,
                  dtype: torch.dtype = torch.float32,
                  device: torch.device | str) -> FieldState:
    """Uniform test box: hydrogen number density nh [cm^-3]."""
    shape = (n, n, n)
    rho = np.full(shape, nh * MH / PSI)
    return make_state(rho, np.full(shape, tgas),
                      np.full(shape, nh * x_neutral), dtype=dtype,
                      device=device)


@dataclasses.dataclass(frozen=True)
class GridGeometry:
    """Static geometry of the base grid."""
    nx: int
    ny: int
    nz: int
    physical_box_size: float   # [cm]

    @property
    def cell_size(self) -> float:
        """Base-cell size [cm] (cellSizeAbsoluteUnits, equiSources.f90:1570)."""
        return self.physical_box_size / self.nx

    @property
    def cell_volume(self) -> float:
        return self.cell_size ** 3
