"""Three-band absorption coefficients for the diffuse sweep.

Port of computeOpacities (equiSources.f90:4956-4983):
  kappa1 = n_HI * beta24(g1)
  kappa2 = n_HI * beta24(g2) + n_HeI * beta26(g2)
  kappa3 = n_HI * beta24(g3) + n_HeI * beta26(g3) + n_HeII * beta25(g3)
with the group-averaged cross-sections from the uvb_beta_table.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class GroupOpacityCoefficients:
    """beta coefficients entering the three band opacities [cm^2]."""
    g1_beta24: float
    g2_beta24: float
    g2_beta26: float
    g3_beta24: float
    g3_beta26: float
    g3_beta25: float

    @classmethod
    def from_groups(cls, g1, g2, g3) -> "GroupOpacityCoefficients":
        """From the three NormCrossSections of uvb_beta_table."""
        return cls(g1_beta24=g1.beta[24], g2_beta24=g2.beta[24],
                   g2_beta26=g2.beta[26], g3_beta24=g3.beta[24],
                   g3_beta26=g3.beta[26], g3_beta25=g3.beta[25])


def compute_opacities(HI, HeI, HeII, coef: GroupOpacityCoefficients):
    """kappa (3, nx, ny, nz) [1/cm]."""
    kappa1 = HI * coef.g1_beta24
    kappa2 = HI * coef.g2_beta24 + HeI * coef.g2_beta26
    kappa3 = HI * coef.g3_beta24 + HeI * coef.g3_beta26 + HeII * coef.g3_beta25
    return torch.stack([kappa1, kappa2, kappa3])
