"""HII-region expansion model (disabled by default, matching the reference's
expansionFlag = .false.; definitionsModule.f90:86).

Counterpart of the JAX package's core/expansion.py, of the reference's
computeExpansionParameters / findExpansion / applyExpansion
(equiSources.f90:4395-4503): a precomputed 1-D table maps a source host
cell's hydrogen density to a final Stromgren-like radius and density-drop
factor; every cell within that radius of the source whose density does not
exceed the host's gets the minimum drop factor; rho and the species are
then scaled down.  The table lookup is NumPy (the same code); the mesh and
the mask are torch tensors on the state's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..constants import PC

# expansion table (equiSources.f90:4406-4408)
_LOG_INITIAL_DENSITY = np.array([0.0, 0.333333, 0.666667, 1.0, 1.33333,
                                 1.66667, 2.0, 2.33333, 2.66667, 3.0])
_LOG_FINAL_RADIUS = np.array([2.99506, 2.77808, 2.57210, 2.37683, 2.19731,
                              2.02898, 1.87315, 1.73656, 1.61294, 1.50202])
_LOG_FINAL_DENSITY = np.array([-0.0222764, 0.295050, 0.579490, 0.831870,
                               1.03717, 1.20892, 1.34321, 1.41970, 1.45725,
                               1.45667])


def expansion_parameters(nh: float) -> tuple[float, float]:
    """(finalRadius [cm], densityCoefficient) for a source host density
    (computeExpansionParameters, :4395-4429)."""
    lognh = np.log10(nh)
    i = int(np.searchsorted(_LOG_INITIAL_DENSITY, lognh, side="right"))
    i = max(min(i, len(_LOG_INITIAL_DENSITY) - 1), 1)
    t = ((lognh - _LOG_INITIAL_DENSITY[i - 1])
         / (_LOG_INITIAL_DENSITY[i] - _LOG_INITIAL_DENSITY[i - 1]))
    final_radius = 10.0 ** (t * (_LOG_FINAL_RADIUS[i] - _LOG_FINAL_RADIUS[i - 1])
                            + _LOG_FINAL_RADIUS[i - 1]) * PC
    coef = 10.0 ** (t * (_LOG_FINAL_DENSITY[i] - _LOG_FINAL_DENSITY[i - 1])
                    + _LOG_FINAL_DENSITY[i - 1]) / nh
    if lognh < _LOG_INITIAL_DENSITY[0]:
        # low-density extrapolation (:4422-4425)
        t = (lognh + 6.0) / (_LOG_INITIAL_DENSITY[0] + 6.0)
        coef = 10.0 ** (t * (_LOG_FINAL_DENSITY[0] + 6.0) - 6.0) / nh
    return float(final_radius), float(coef)


def apply_expansion(state, geom, source_positions: np.ndarray):
    """Apply the expansion density drop around every source
    (findExpansion/applyExpansion, :4431-4503).

    source_positions: (S, 3) in box units.  Returns the new state.
    """
    n = geom.nx
    dtype, device = state.rho.dtype, state.rho.device
    ax = (torch.arange(n, dtype=dtype, device=device) + 0.5) / n
    x, y, z = torch.meshgrid(ax, ax, ax, indexing="ij")
    rho_coef = torch.ones_like(state.rho)
    nh = state.nh

    for p in np.asarray(source_positions):
        cell = np.clip((p * n).astype(int), 0, n - 1)
        host_nh = float(nh[cell[0], cell[1], cell[2]])
        final_radius, coef = expansion_parameters(host_nh)
        dist = geom.physical_box_size * torch.sqrt(
            (x - p[0]) ** 2 + (y - p[1]) ** 2 + (z - p[2]) ** 2)
        inside = (dist < final_radius) & (nh <= 1.0001 * host_nh)
        rho_coef = torch.where(inside, torch.clamp(rho_coef, max=coef),
                               rho_coef)

    scale = torch.where(rho_coef < 1.0, rho_coef, 1.0)
    return dataclasses.replace(
        state, rho=state.rho * scale, HI=state.HI * scale,
        HeI=state.HeI * scale, HeII=state.HeII * scale)
