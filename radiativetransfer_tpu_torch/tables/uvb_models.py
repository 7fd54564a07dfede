"""Redshift-dependent UV-background amplitude models.

Ports the analytic model blends computed at program start in the reference
(equiSources.f90:196-289): Abel & Haehnelt 1999 stellar and
quasar components, Paschos 2002, the Razoumov 2002 blend, and the optional
renormalization to tabulated H photoionization-rate histories for
reionization at z=6 or z=10.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..constants import FOUR_PI, NU1, NU2, NU3

# tabulated H photoionization-rate histories (equiSources.f90:263-271)
_REION_Z6_Z = np.array([0., 0.316, 0.697, 1.187, 1.513, 2.343, 2.547, 2.765,
                        3.024, 3.296, 3.772, 4.316, 4.657, 4.997, 5.302,
                        5.609, 100.])
_REION_Z6_RATE = np.array([0.0045, 0.0100, 0.0248, 0.0585, 0.0968, 0.1594,
                           0.1621, 0.1564, 0.1403, 0.1159, 0.0683, 0.0248,
                           0.0112, 0.0058, 0.0017, 0.0004, 0.0000]) * 1.0e-11
_REION_Z10_Z = np.array([0., 0.316, 0.697, 1.187, 1.513, 2.343, 2.547, 2.972,
                         3.432, 3.976, 5.065, 6.221, 6.902, 7.650, 8.331,
                         9.419, 100.])
_REION_Z10_RATE = np.array([0.0045, 0.0100, 0.0248, 0.0585, 0.0968, 0.1594,
                            0.1621, 0.1570, 0.1444, 0.1240, 0.0710, 0.0262,
                            0.0128, 0.0058, 0.0014, 0.0003, 0.0000]) * 1.0e-11


def abel_haehnelt99_stellar(z: float) -> float:
    """AH99 stellar component amplitude (equiSources.f90:198)."""
    return 1.0 / (1.0 + (7.0 / (1.0 + z)) ** 4) * math.exp(-((z / 4.0) ** 3))


def abel_haehnelt99_quasar(z: float) -> float:
    """AH99 quasar component amplitude (equiSources.f90:202)."""
    return 10.0 / (1.0 + (7.0 / (1.0 + z)) ** 4) * math.exp(-((z / 2.5) ** 3))


def paschos02(z: float) -> float:
    """Paschos 2002 total amplitude (equiSources.f90:206)."""
    return (0.0188 * math.exp(-((z - 0.5) ** 2)
                              / (1.0 + 0.0625 * (z + 2.09) ** 2.075))
            * (1.0 + z) ** 3.35)


@dataclasses.dataclass(frozen=True)
class UvbAmplitudes:
    """Resolved UVB amplitudes at a redshift, before spectral integration."""
    stellar: float   # amplitude of the stellar power-law component at nu1
    quasar: float    # amplitude of the quasar power-law component at nu1


def razoumov02(z: float) -> UvbAmplitudes:
    """Razoumov 2002 blend of stellar/quasar components
    (equiSources.f90:208-229)."""
    component1 = abel_haehnelt99_stellar(z)
    component2 = paschos02(z)
    step = 0.5 * (math.tanh((z - 4.2) * 1.5) + 1.0)
    stellar02 = (1.0 - step) * component1 + step * component2
    quasar02 = abel_haehnelt99_quasar(z)
    gaussian = math.exp(-(((z - 4.5) / 2.0) ** 2)) * 0.3
    new_quasar = gaussian * stellar02 + (1.0 - gaussian) * quasar02
    new_stellar = (1.0 - gaussian) * stellar02 + gaussian * quasar02
    step = 0.5 * (math.tanh((z - 14.0) * 0.5) + 1.0)
    new_stellar = (1.0 - step) * new_stellar
    return UvbAmplitudes(stellar=new_stellar, quasar=new_quasar)


def uniform_uvb_intensities(z: float, uvb_coefficient: float = 1.0,
                            contribution_quasar: float = 1.0,
                            contribution_stellar: float = 1.0) -> UvbAmplitudes:
    """Physical uniform-UVB intensities at nu1 [erg/cm^2/s/Hz/sr]
    (equiSources.f90:231-232)."""
    amps = razoumov02(z)
    return UvbAmplitudes(
        stellar=amps.stellar * 1.0e-21 * contribution_stellar * uvb_coefficient,
        quasar=amps.quasar * 1.0e-21 * contribution_quasar * uvb_coefficient,
    )


def band_intensities(amps: UvbAmplitudes, alpha_stellar: float,
                     alpha_quasar: float) -> tuple[np.ndarray, np.ndarray]:
    """Per-band component intensities at each band's lower edge
    (equiSources.f90:236-242).

    Returns (stellar[3], quasar[3]).
    """
    s1 = amps.stellar
    s2 = s1 * (NU2 / NU1) ** (-alpha_stellar)
    s3 = s2 * (NU3 / NU2) ** (-alpha_stellar)
    q1 = amps.quasar
    q2 = q1 * (NU2 / NU1) ** (-alpha_quasar)
    q3 = q2 * (NU3 / NU2) ** (-alpha_quasar)
    return np.array([s1, s2, s3]), np.array([q1, q2, q3])


def reionization_rate_coefficient(z: float, model: int, uniform_quasar: float,
                                  uniform_stellar: float, ksi24_quasar: float,
                                  ksi24_stellar: float) -> float:
    """Renormalization factor matching a tabulated H photoionization history
    (equiSources.f90:259-289).

    model is 6 or 10 (redshift of reionization); returns the multiplicative
    coefficient to apply to all UVB amplitudes.
    """
    if model == 6:
        zt, rt = _REION_Z6_Z, _REION_Z6_RATE
    elif model == 10:
        zt, rt = _REION_Z10_Z, _REION_Z10_RATE
    else:
        raise ValueError(f"unsupported reionization model {model!r} (use 6 or 10)")
    i = int(np.searchsorted(zt, z, side="left"))
    i = max(1, min(i, len(zt) - 1))
    actual = (z - zt[i - 1]) / (zt[i] - zt[i - 1]) * (rt[i] - rt[i - 1]) + rt[i - 1]
    current = FOUR_PI * (uniform_quasar * ksi24_quasar + uniform_stellar * ksi24_stellar)
    return float(actual / current)
