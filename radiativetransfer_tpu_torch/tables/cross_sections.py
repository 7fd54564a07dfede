"""Photoionization cross-section fits sigma24..sigma31(nu).

Numbered by reaction as in Abel et al. 1997 (NewA 2); the fits follow the
reference's table builders (uniformTable.f90:28-103,
calc_rates.f:630-712).  All functions are pure and vectorized
over frequency arrays (frequency in eV), returning cm^2.

These run once at startup on host, so they are written with NumPy for
float64 determinism; results are shipped to device as constants.
"""

from __future__ import annotations

import numpy as np

from ..constants import (
    DOUBLE_HELIUM_IONIZATION,
    HYDROGEN_IONIZATION,
    PI,
    SINGLE_HELIUM_IONIZATION,
)

# Secondary-channel energy edges [eV] (uniformTable.f90:17-26)
E27 = 0.755
E28A = 2.65
E28B = 11.27
E28C = 21.0
E29A = 15.42
E29B = 16.5
E29C = 17.7
E30A = 30.0
E30B = 70.0


def _kramers(nu: np.ndarray, nu_th: float, sigma_th: float) -> np.ndarray:
    """Osterbrock-style hydrogenic cross-section above threshold nu_th."""
    nu = np.asarray(nu, dtype=np.float64)
    out = np.zeros_like(nu)
    m = nu > nu_th
    dum = np.sqrt(nu[m] / nu_th - 1.0)
    out[m] = (
        sigma_th
        * (nu_th / nu[m]) ** 4
        * np.exp(4.0 - 4.0 * np.arctan(dum) / dum)
        / (1.0 - np.exp(-2.0 * PI / dum))
    )
    return out


def sigma24(nu: np.ndarray) -> np.ndarray:
    """HI photoionization cross-section [cm^2] (uniformTable.f90:32-41)."""
    return _kramers(nu, HYDROGEN_IONIZATION, 6.3e-18)


def sigma25(nu: np.ndarray) -> np.ndarray:
    """HeII photoionization cross-section [cm^2] (uniformTable.f90:43-52)."""
    return _kramers(nu, DOUBLE_HELIUM_IONIZATION, 1.58e-18)


def sigma26(nu: np.ndarray) -> np.ndarray:
    """HeI photoionization cross-section [cm^2] (uniformTable.f90:54-62)."""
    nu = np.asarray(nu, dtype=np.float64)
    out = np.zeros_like(nu)
    m = nu > SINGLE_HELIUM_IONIZATION
    x = nu[m] / SINGLE_HELIUM_IONIZATION
    out[m] = 7.42e-18 * (1.66 * x ** (-2.05) - 0.66 * x ** (-3.05))
    return out


def sigma27(nu: np.ndarray) -> np.ndarray:
    """H- photodetachment cross-section [cm^2] (uniformTable.f90:64-68)."""
    nu = np.asarray(nu, dtype=np.float64)
    out = np.zeros_like(nu)
    m = nu > E27
    out[m] = 2.11e-16 * (nu[m] - E27) ** 1.5 / nu[m] ** 3
    return out


def sigma28(nu: np.ndarray) -> np.ndarray:
    """H2+ photodissociation cross-section [cm^2] (uniformTable.f90:70-76)."""
    nu = np.asarray(nu, dtype=np.float64)
    out = np.zeros_like(nu)
    m1 = (nu > E28A) & (nu <= E28B)
    out[m1] = 10.0 ** (-40.97 + 6.03 * nu[m1] - 0.504 * nu[m1] ** 2 + 1.387e-2 * nu[m1] ** 3)
    m2 = (nu > E28B) & (nu < E28C)
    out[m2] = 10.0 ** (-30.26 + 2.79 * nu[m2] - 0.184 * nu[m2] ** 2 + 3.535e-3 * nu[m2] ** 3)
    return out


def sigma29(nu: np.ndarray) -> np.ndarray:
    """H2 photoionization cross-section [cm^2] (uniformTable.f90:78-86)."""
    nu = np.asarray(nu, dtype=np.float64)
    out = np.zeros_like(nu)
    m1 = (nu > E29A) & (nu <= E29B)
    out[m1] = 6.2e-18 * nu[m1] - 9.4e-17
    m2 = (nu > E29B) & (nu <= E29C)
    out[m2] = 1.4e-18 * nu[m2] - 1.48e-17
    m3 = nu > E29C
    out[m3] = 2.5e-14 * nu[m3] ** (-2.71)
    return out


def sigma30(nu: np.ndarray) -> np.ndarray:
    """H2+ double-ionization cross-section [cm^2] (uniformTable.f90:88-92)."""
    nu = np.asarray(nu, dtype=np.float64)
    out = np.zeros_like(nu)
    m = (nu >= E30A) & (nu < E30B)
    out[m] = 10.0 ** (-16.926 - 4.528e-2 * nu[m] + 2.238e-4 * nu[m] ** 2 + 4.245e-7 * nu[m] ** 3)
    return out


def sigma31(nu: np.ndarray) -> np.ndarray:
    """H2 Lyman-Werner photodissociation [cm^2] (uniformTable.f90:94-98)."""
    nu = np.asarray(nu, dtype=np.float64)
    out = np.zeros_like(nu)
    m = (nu > E28B) & (nu < HYDROGEN_IONIZATION)
    out[m] = 3.71e-18
    return out


def frequency_grid(nfreq: int, freqdel: float) -> np.ndarray:
    """Log-spaced frequency grid in eV: nu(i) = 10**((i-1)*freqdel), i=1..nfreq.

    Matches uniformTable.f90:30 (0.74 eV .. 7.2 keV for nfreq=400, freqdel=0.02
    after the reference's nu(1)=1 eV origin).
    """
    i = np.arange(nfreq, dtype=np.float64)
    return 10.0 ** (i * freqdel)


def all_sigmas(nu: np.ndarray) -> dict[str, np.ndarray]:
    """All eight cross-section channels on a frequency grid."""
    return {
        "sigma24": sigma24(nu),
        "sigma25": sigma25(nu),
        "sigma26": sigma26(nu),
        "sigma27": sigma27(nu),
        "sigma28": sigma28(nu),
        "sigma29": sigma29(nu),
        "sigma30": sigma30(nu),
        "sigma31": sigma31(nu),
    }
