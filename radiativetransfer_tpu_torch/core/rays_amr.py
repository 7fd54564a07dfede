"""Two-level AMR point-source ray tracer in PyTorch.

Counterpart of the JAX package's core/rays_amr.py.  A two-level grid is
the L = 2 case of the L-level tracer (core/rays_multilevel.py), which this
module calls: the same march (rays track their FINE cell index, the
refinement state selects the local resolution for face crossings, optical
depths, split radii and deposits, equiSources.f90:2412-2595, 3120-3385),
the same face hand-off and deposits into the traversed leaf.  The JAX
package keeps two marches and holds them to each other exactly
(tests/test_rays_multilevel.py::test_two_level_exact_match_with_rays_amr);
the port keeps one, and tests/test_torch_rays_amr.py holds it at L = 2
against the JAX package's two-level tracer.

The L-level march's step caps at L = 2 are twice the JAX two-level
tracer's.  Neither binds on a marching ray: a ray crosses at most 2 sqrt(3)
fine faces a base-cell length of its path, about half the JAX cap.

No hand kernel here: the JAX two-level tracer is a plain
jax.lax.while_loop with no Pallas kernel.
"""

from __future__ import annotations

import torch

from ..constants import MAX_PIXEL_LEVEL, NO_DUST
from . import amr, rays_multilevel
from .rays import SourceBatch


def trace_point_sources_amr(amr_state, geom, sources: SourceBatch, tables,
                            dust_approximation: int = NO_DUST,
                            max_pixel_level: int = MAX_PIXEL_LEVEL,
                            dtype=torch.float64, rates_mode: str = "auto",
                            tau_kill: float | None = None,
                            rel_kill: float | None = None):
    """Trace sources through a two-level AMRState (core/amr.py) on its
    device; returns (RateFields base (n^3,), RateFields fine ((2n)^3,),
    RayDiagnostics).

    tables, rates_mode ('auto', 'table' or 'quadrature'; the two-level
    tracer has no noneq mode, as in the JAX package), tau_kill and
    rel_kill: as rays.trace_point_sources takes them.  The deposits are
    over the tables' volume: StellarContext.build divides them by the
    BASE cell's, so a fine cell's rate is its deposit times 8
    (AMRModel.trace).
    """
    if rates_mode == "auto":
        rates_mode = "quadrature" if "quad_A" in tables else "table"
    if rates_mode not in ("table", "quadrature"):
        raise ValueError(f"unknown rates_mode {rates_mode!r} for the "
                         f"two-level tracer")
    (rfb, rff), diag = rays_multilevel.trace_point_sources_ml(
        amr.MultiLevelState(levels=(amr_state.base, amr_state.fine),
                            refined=(amr_state.refined,)),
        geom, sources, tables, dust_approximation=dust_approximation,
        max_pixel_level=max_pixel_level, dtype=dtype, rates_mode=rates_mode,
        tau_kill=tau_kill, rel_kill=rel_kill)
    return rfb, rff, diag
