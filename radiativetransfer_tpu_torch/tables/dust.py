"""SMC/LMC dust extinction cross-sections.

Port of dustModule.f90: the cross-section is a 7-term sum of
Pei (1992)-style Drude-like profiles
    sigma(lambda) propto sum_i a_i / ((lambda/l_i)^n_i + (lambda/l_i)^-m_i + b_i)
scaled by 1.1 (SMC) or 3.3 (LMC) and ln(10)/2.5, in units of 1e-22 cm^2 per
H atom at solar-like normalization (used as `dustCrossSection(lam_um) * 1e-22`
in stellarBetaTable.f90:36).

The reference reads the parameters from `smc_dust_parameters.dat` /
`lmc_dust_parameters.dat`, which are NOT shipped with the reference
(SURVEY.md §0).  We provide a loader for those files plus built-in defaults
taken from Pei 1992 (ApJ 394, 674), Table 4 — six physical terms padded with
a zero row to the 7-row layout the reference expects.  Exact parity with the
reference's unavailable data files is impossible; the built-ins reproduce the
published fit the files encode.
"""

from __future__ import annotations

import numpy as np

EXTINCTION_TO_TAU = 0.9210340372  # ln(10)/2.5 (dustModule.f90:6)

# columns: lambda_i [um], a_i, b_i, n_i, m_i  (m_i = n_i in Pei's form)
PEI92_SMC = np.array([
    [0.042, 185.0, 90.0, 2.0, 2.0],
    [0.08, 27.0, 5.50, 4.0, 4.0],
    [0.22, 0.005, -1.95, 2.0, 2.0],
    [9.7, 0.010, -1.95, 2.0, 2.0],
    [18.0, 0.012, -1.80, 2.0, 2.0],
    [25.0, 0.030, 0.00, 2.0, 2.0],
    [1.0, 0.0, 1.0, 2.0, 2.0],      # zero-amplitude pad to 7 rows
])

PEI92_LMC = np.array([
    [0.046, 90.0, 90.0, 2.0, 2.0],
    [0.08, 19.0, 5.50, 4.5, 4.5],
    [0.22, 0.023, -1.95, 2.0, 2.0],
    [9.7, 0.005, -1.95, 2.0, 2.0],
    [18.0, 0.006, -1.80, 2.0, 2.0],
    [25.0, 0.020, 0.00, 2.0, 2.0],
    [1.0, 0.0, 1.0, 2.0, 2.0],
])

SMC = 1
LMC = 2


class DustModel:
    """Dust cross-section evaluator (dustModule.f90:30-73)."""

    def __init__(self, a_smc: np.ndarray | None = None,
                 a_lmc: np.ndarray | None = None):
        self.a_smc = PEI92_SMC if a_smc is None else np.asarray(a_smc, np.float64)
        self.a_lmc = PEI92_LMC if a_lmc is None else np.asarray(a_lmc, np.float64)
        if self.a_smc.shape != (7, 5) or self.a_lmc.shape != (7, 5):
            raise ValueError("dust parameter tables must be (7, 5)")

    @classmethod
    def from_files(cls, smc_path: str, lmc_path: str) -> "DustModel":
        """Load the reference's parameter files (dustInitialize,
        dustModule.f90:10-28)."""
        return cls(np.loadtxt(smc_path), np.loadtxt(lmc_path))

    def cross_section(self, lam_um, kind: int = SMC):
        """Extinction cross-section in units of 1e-22 cm^2 per H
        (dustCrossSection; lam_um in microns, vectorized)."""
        lam = np.asarray(lam_um, np.float64)
        p = self.a_smc if kind == SMC else self.a_lmc
        amp = 1.1 if kind == SMC else 3.3
        sigma = np.zeros_like(lam)
        for i in range(7):
            li, ai, bi, ni, mi = p[i]
            if ai == 0.0:
                continue
            x = lam / li
            sigma = sigma + ai / (x ** ni + x ** (-mi) + bi)
        return amp * sigma * EXTINCTION_TO_TAU

    def sigma_at_energy_ev(self, energy_ev, kind: int = SMC):
        """sigma_dust [cm^2] at photon energy in eV
        (stellarBetaTable.f90:35-36)."""
        from ..constants import CLIGHT, EV_TO_HZ
        lam_angstrom = CLIGHT / (np.asarray(energy_ev) * EV_TO_HZ) * 1.0e8
        return self.cross_section(lam_angstrom / 1.0e4, kind) * 1.0e-22
