"""Spectrum-averaged photo-rate integrals for the UV background.

Ports (as pure NumPy table builders, run once at startup):

* uniform_table       — uniformTable.f90:1-200
  spectrum-averaged photo-reaction rates ksi24..31 [cm^2 Hz/erg] and
  photo-heating integrals gammaHI/HeI/HeII [cm^2 Hz] for power-law quasar
  and stellar spectra normalized to 1 at nu1.

* uvb_beta_table      — uvbBetaTable.f90:1-307
  the same plus group-averaged absorption cross-sections beta24..31 [cm^2]
  for the three frequency groups [nu1,nu2], [nu2,nu3], [nu3,inf).

* power_spectrum_index — equiSources.f90:4985-5042
  effective single power-law slope matching the photon count of a
  two-component (stellar+quasar) power-law mixture over a band.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import EV_TO_ERG, EV_TO_HZ, NU1, NU2, NU3
from .cross_sections import all_sigmas, frequency_grid

_CHANNELS = (24, 25, 26, 27, 28, 29, 30, 31)


@dataclasses.dataclass(frozen=True)
class NormCrossSections:
    """Group/spectrum-averaged integrals (normCrossSectionType,
    definitionsModule.f90:94-102)."""
    beta: dict[int, float]      # [cm^2], group tables only
    ksi: dict[int, float]       # [cm^2 Hz / erg]
    gammaHI: float              # [cm^2 Hz]
    gammaHeI: float
    gammaHeII: float


def _spectrum_integrals(nu: np.ndarray, sig: dict[str, np.ndarray],
                        shape_weight: np.ndarray) -> NormCrossSections:
    """Accumulate ksi/gamma integrals with the trapezoid-free left-Riemann rule
    the reference uses (uniformTable.f90:137-192): sums over bins i>=2 with
    dtmp = w(nu_i) * (nu_i - nu_{i-1})."""
    delta_nu = np.diff(nu)
    f = nu[1:]
    w = shape_weight[1:] * delta_nu
    w_over_e = w * EV_TO_HZ / (f * EV_TO_ERG)

    above1 = f >= NU1
    above2 = f >= NU2
    above3 = f >= NU3

    ksi = {c: float(np.sum(np.where(above1, w_over_e * sig[f"sigma{c}"][1:], 0.0)))
           for c in _CHANNELS}
    gammaHI = float(np.sum(np.where(above1, w_over_e * (f - NU1) * EV_TO_ERG * sig["sigma24"][1:], 0.0)))
    gammaHeI = float(np.sum(np.where(above2, w_over_e * (f - NU2) * EV_TO_ERG * sig["sigma26"][1:], 0.0)))
    gammaHeII = float(np.sum(np.where(above3, w_over_e * (f - NU3) * EV_TO_ERG * sig["sigma25"][1:], 0.0)))
    return NormCrossSections(beta={}, ksi=ksi, gammaHI=gammaHI,
                             gammaHeI=gammaHeI, gammaHeII=gammaHeII)


def uniform_table(nfreq: int, freqdel: float, alpha_quasar: float,
                  alpha_stellar: float) -> tuple[NormCrossSections, NormCrossSections]:
    """Quasar and stellar spectrum-averaged integrals (uniformTable.f90).

    Returns (quasar, stellar) with shape w(nu) = (nu/nu1)**(-alpha).
    """
    nu = frequency_grid(nfreq, freqdel)
    sig = all_sigmas(nu)
    quasar = _spectrum_integrals(nu, sig, (nu / NU1) ** (-alpha_quasar))
    stellar = _spectrum_integrals(nu, sig, (nu / NU1) ** (-alpha_stellar))
    return quasar, stellar


def _group_integrals(nu: np.ndarray, sig: dict[str, np.ndarray], alpha: float,
                     nu_lo: float, nu_hi: float | None,
                     heat_edges: tuple[float | None, float | None, float | None],
                     shape_norm: float) -> NormCrossSections:
    delta_nu = np.diff(nu)
    f = nu[1:]
    in_band = (f >= nu_lo) if nu_hi is None else ((f >= nu_lo) & (f <= nu_hi))
    dtmp = np.where(in_band, (f / nu_lo) ** (-alpha) * delta_nu, 0.0)
    dtmp_over_e = dtmp * EV_TO_HZ / (f * EV_TO_ERG)

    beta = {c: float(np.sum(dtmp * sig[f"sigma{c}"][1:])) / shape_norm for c in _CHANNELS}
    ksi = {c: float(np.sum(dtmp_over_e * sig[f"sigma{c}"][1:])) for c in _CHANNELS}
    eHI, eHeI, eHeII = heat_edges
    gammaHI = float(np.sum(dtmp_over_e * (f - NU1) * EV_TO_ERG * sig["sigma24"][1:])) if eHI else 0.0
    gammaHeI = float(np.sum(dtmp_over_e * (f - NU2) * EV_TO_ERG * sig["sigma26"][1:])) if eHeI else 0.0
    gammaHeII = float(np.sum(dtmp_over_e * (f - NU3) * EV_TO_ERG * sig["sigma25"][1:])) if eHeII else 0.0
    return NormCrossSections(beta=beta, ksi=ksi, gammaHI=gammaHI,
                             gammaHeI=gammaHeI, gammaHeII=gammaHeII)


def uvb_beta_table(nfreq: int, freqdel: float,
                   alpha: tuple[float, float, float]
                   ) -> tuple[NormCrossSections, NormCrossSections, NormCrossSections]:
    """Three-band group-averaged integrals (uvbBetaTable.f90:1-307).

    The beta normalization follows uvbBetaTable.f90:262-296: the band-integral
    of the power-law energy flux, shape_g * nu_g with
      shape1 = (1 - (nu2/nu1)**(1-a1)) / (a1 - 1)     (bounded bands)
      shape3 = 1/(a3 - 1)                              (unbounded band 3)
    """
    nu = frequency_grid(nfreq, freqdel)
    sig = all_sigmas(nu)
    a1, a2, a3 = alpha
    shape1 = (1.0 - (NU2 / NU1) ** (1.0 - a1)) / (a1 - 1.0)
    shape2 = (1.0 - (NU3 / NU2) ** (1.0 - a2)) / (a2 - 1.0)
    shape3 = 1.0 / (a3 - 1.0)
    g1 = _group_integrals(nu, sig, a1, NU1, NU2, (NU1, None, None), shape1 * NU1)
    g2 = _group_integrals(nu, sig, a2, NU2, NU3, (NU1, NU2, None), shape2 * NU2)
    g3 = _group_integrals(nu, sig, a3, NU3, None, (NU1, NU2, NU3), shape3 * NU3)
    return g1, g2, g3


def power_spectrum_index(uvb_a: float, alpha_a: float, uvb_b: float,
                         alpha_b: float, nu_g: float, nu_gplus: float,
                         bound: bool) -> tuple[float, float]:
    """Effective slope of the summed two-power-law spectrum over a band.

    Solves for alphaTotal such that a single power law with amplitude
    uvb_a+uvb_b carries the same photon count over [nu_g, nu_gplus] as the
    two components (equiSources.f90:4985-5042, regula-falsi iteration).
    Returns (uvbTotal, alphaTotal).
    """
    uvb_total = uvb_a + uvb_b

    def photon_count(amplitude: float, a: float) -> float:
        if bound:
            return amplitude / (a - 1.0) * (1.0 - (nu_g / nu_gplus) ** (a - 1.0))
        return amplitude / (a - 1.0)

    target = photon_count(uvb_a, alpha_a) + photon_count(uvb_b, alpha_b)
    t1 = 1.1 * alpha_a - 0.1 * alpha_b
    t2 = 1.1 * alpha_b - 0.1 * alpha_a
    f1 = photon_count(uvb_total, t1) - target
    f2 = photon_count(uvb_total, t2) - target
    if f1 * f2 > 0.0:
        raise ValueError(f"power_spectrum_index: no sign change ({f1}, {f2})")

    t_old, t = t1, t2
    while abs(t - t_old) >= 1e-8:
        t_old = t
        t = (t1 * abs(f2) + t2 * abs(f1)) / (abs(f1) + abs(f2))
        f = photon_count(uvb_total, t) - target
        if (f > 0.0 and f1 < 0.0) or (f < 0.0 and f1 > 0.0):
            t2, f2 = t, f
        else:
            t1, f1 = t, f
    return uvb_total, t
