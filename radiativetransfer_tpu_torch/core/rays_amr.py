"""Two-level AMR point-source ray tracer in PyTorch.

Counterpart of the JAX package's core/rays_amr.py.  It extends the
lockstep phased tracer (core/rays.py) to nested grids: every ray tracks
its containing FINE cell index, and the cell's refinement state selects
the local resolution for face crossings, optical depths and deposits.

Reference semantics kept (equiSources.f90:2412-2595, 3120-3385):

* segment geometry at the local cell size (drawSegment works in
  current-cell units);
* the split criterion radius*2^level + len < rmax(pixelLevel): rays inside
  refined parents split at HALF the base-unit radius, keeping the ray
  density matched to the local cell size (:2491);
* rate deposits into the leaf cell actually traversed (fine under refined
  parents, base elsewhere);
* face hand-off across refinement boundaries by exact face-index
  arithmetic (the dense analog of findXY/YZ/XZNeighbour + zoom*,
  :2647-2960).

What differs from the JAX package is what differs in core/rays.py: an
eager march that reads any(alive) every rays._ALIVE_CHECK bodies, and
index_add_ deposits (atomic on a CUDA device, so a CUDA run matches the
CPU one to float rounding).  Two details more: the cell faces are in the
run's dtype, where the JAX package's int32 / int is float32 even in
float64 runs (exact at power-of-two grids; ROADMAP, faults found in the
port); and the gathers of dead rays, whose frozen cells may lie outside
the box, are clamped into it, where JAX clamps them silently.

No hand kernel here: the JAX two-level tracer is a plain
jax.lax.while_loop with no Pallas kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..constants import (
    KPC,
    MAX_PIXEL_LEVEL,
    NO_DUST,
    OUTPUT_RADII_KPC,
    rmax_table,
)
from . import rays
from .rays import (
    RateFields,
    RayDiagnostics,
    SourceBatch,
    _RayState,
    _deposit_scale,
    _end_phase,
    _escape_update,
    _pack_fields,
    _rate_ctx,
    _rate_deposits,
    _segment_tau,
    _sig_ratio,
    _spawn_phase,
    default_rel_kill,
    default_tau_kill,
)

# march steps run by _march_phase_amr, every phase of every trace (the
# per-step costs of profile_step divide by it)
MARCH_STEPS = 0


def _march_phase_amr(state: _RayState, fields, geom, rate_ctx,
                     diag: RayDiagnostics, rfb: RateFields, rff: RateFields,
                     r_stop: float, last_phase: bool,
                     dust_approximation: int, max_steps: int, src_of_ray,
                     tau_kill: float, rel_kill: float, scale: float):
    """March one phase on a two-level grid; the deposits, times `scale`,
    accumulate into rfb (base, n^3) and rff (fine, (2n)^3) in place.
    Returns (state, diag).

    state.cell holds FINE (2n-grid) indices; fields holds the packed
    per-level rows 'base' (n^3, 5) and 'fine' ((2n)^3, 5) [HI, HeI, HeII,
    nH, abun2] and the flat bitmap 'refined' (n^3,).  rate_ctx:
    ("table", table_flat) or ("quadrature", (quad_A, quad_W)).  tau_kill
    and rel_kill: as in rays._march_phase.
    """
    global MARCH_STEPS
    n = geom.nx
    n2 = 2 * n
    cell_size = geom.cell_size
    dtype, device = state.ndot.dtype, state.ndot.device
    out_radii = torch.tensor(np.array(OUTPUT_RADII_KPC) * KPC, dtype=dtype,
                             device=device)
    R = state.pos.shape[0]
    rem_acc = torch.zeros((R, out_radii.shape[0]), dtype=dtype, device=device)
    bnd_acc = torch.zeros((R, out_radii.shape[0]), dtype=dtype, device=device)
    axes = torch.arange(3, device=device)
    wsum = None
    if rate_ctx[0] == "quadrature" and rel_kill > 0.0:
        # the spectrum-exhaustion kill of rays._march_phase
        wsum = torch.amax(torch.sum(torch.abs(rate_ctx[1][1]), dim=2), dim=0)
        rem_floor = rel_kill * torch.sum(wsum)
    # a position exactly on a face belongs to the cell the ray is
    # ENTERING: the non-crossing axes relocalize with a downwind nudge that
    # must exceed the position's ulp at the grid scale, else a corner hit
    # desyncs pos and cell into a zero-step period-2 cycle in float32
    # (tests/test_torch_rays_amr.py::test_face_exact_f32_rays_terminate);
    # float64 keeps the parity tolerance
    tol = 2.0 ** -10 if dtype == torch.float32 else 1.0e-6
    fields_base, fields_fine = fields["base"], fields["fine"]
    refined = fields["refined"]
    bufs_b = [getattr(rfb, f.name) for f in dataclasses.fields(rfb)]
    bufs_f = [getattr(rff, f.name) for f in dataclasses.fields(rff)]
    # the rays' deposit weights (ndot is fixed within a phase)
    w_scaled = state.ndot * scale

    def body(state, rem_acc, bnd_acc):
        d = state.direction
        floor = torch.full_like(d, 1e-12)
        d_safe = torch.where(torch.abs(d) < 1e-12,
                             torch.where(d < 0, -floor, floor), d)
        active = state.alive
        cf = state.cell                            # fine index (R, 3)
        cb = cf >> 1                               # base index
        # dead rays carry frozen (possibly out-of-box) cells: clamp every
        # gather and scatter into the box (their values are masked by
        # `active`, their deposits are 0)
        ib = torch.clamp((cb[:, 0] * n + cb[:, 1]) * n + cb[:, 2],
                         0, n ** 3 - 1).long()
        if_ = torch.clamp((cf[:, 0] * n2 + cf[:, 1]) * n2 + cf[:, 2],
                          0, n2 ** 3 - 1).long()
        lvl1 = refined[ib]                         # in a refined parent

        # exit faces in fine-grid units: the fine cell's where refined, the
        # parent's (even fine indices) elsewhere
        dpos = (d_safe > 0.0).to(cf.dtype)
        f_bound = torch.where(lvl1[:, None], cf + dpos, 2 * (cb + dpos))
        t_ax = (f_bound.to(dtype) / n2 - state.pos) / d_safe
        # f32 position round-off can overshoot a face: the exact distance
        # is then 0 (rays._march_phase)
        t_min = torch.clamp(torch.amin(t_ax, dim=1), min=0.0)
        # ties break to the first axis, as jnp.argmin does
        exit_axis = torch.argmin(t_ax, dim=1)
        seg_cells = t_min * n                      # base-cell units

        # the split criterion at the LOCAL level (:2491): the stop radius
        # halves inside refined parents (a where of two Python floats
        # would be float32)
        r_stop_local = torch.where(lvl1, 0.5, 1.0).to(dtype) * r_stop
        radius_new = state.radius + seg_cells
        if last_phase:
            will_split = cut = torch.zeros_like(active)
        else:
            will_split = cut = radius_new >= r_stop_local
            seg_cells = torch.where(
                cut, torch.clamp(r_stop_local - state.radius, min=0.0),
                seg_cells)
            radius_new = state.radius + seg_cells
            t_min = seg_cells / n

        fv = torch.where(lvl1[:, None], fields_fine[if_], fields_base[ib])
        tau = _segment_tau(fv, seg_cells * cell_size, active,
                           dust_approximation)
        rem_acc, crossed, cross_depth, r2 = _escape_update(
            state, radius_new, tau, active, out_radii, cell_size, rem_acc)
        deposit, rem = _rate_deposits(state, tau,
                                      torch.where(active, w_scaled, 0.0),
                                      rate_ctx, dust_approximation,
                                      wsum=wsum)
        # into the traversed leaf's level: each channel into both levels,
        # zero-weighted on the other one (:3243-3260)
        on_fine = lvl1.to(dtype)
        for buf_b, buf_f, v in zip(bufs_b, bufs_f, deposit):
            buf_b.index_add_(0, ib, v * (1.0 - on_fine))
            buf_f.index_add_(0, if_, v * on_fine)

        # advance: snap the crossing coordinate onto the (fine-unit) face,
        # step the fine index by exact face arithmetic
        depth_new = state.depth + tau
        pos_new = state.pos + t_min[:, None] * d
        face_f = torch.gather(f_bound, 1, exit_axis[:, None])[:, 0]
        on_axis = axes[None, :] == exit_axis[:, None]
        pos_new = torch.where(on_axis & ~cut[:, None],
                              (face_f.to(dtype) / n2)[:, None], pos_new)
        entering_up = torch.gather(d_safe > 0, 1, exit_axis[:, None])[:, 0]
        new_axis_idx = torch.where(entering_up, face_f, face_f - 1)
        # the non-crossing axes relocalize from the position (a coarse ->
        # fine entry picks its fine sub-cell), truncated toward zero as
        # JAX's astype
        cf_from_pos = torch.clamp(
            (pos_new * n2 + torch.sign(d_safe) * tol).to(cf.dtype),
            0, n2 - 1)
        cell_new = torch.where(on_axis, new_axis_idx[:, None], cf_from_pos)
        cell_new = torch.where(cut[:, None], cf, cell_new)

        out_of_box = torch.any((cell_new < 0) | (cell_new >= n2),
                               dim=1) & ~cut
        # kill on the THREE ionization depths only (equiSources.f90:3241)
        killed_tau = torch.amin(depth_new[:, :3], dim=1) > tau_kill
        if wsum is not None:
            killed_tau = killed_tau | (rem < rem_floor)

        hit_boundary = active & out_of_box
        beyond = out_radii[None, :] > r2[:, None]
        bnd_acc = bnd_acc + torch.where(beyond & hit_boundary[:, None],
                                        state.ndot[:, None], 0.0)

        state = dataclasses.replace(
            state, pos=torch.where(active[:, None], pos_new, state.pos),
            cell=torch.where(active[:, None], cell_new, cf),
            radius=torch.where(active, radius_new, state.radius),
            depth=torch.where(active[:, None], depth_new, state.depth),
            alive=active & ~out_of_box & ~killed_tau & ~will_split,
            split=state.split | (active & will_split & ~killed_tau),
            crossed=crossed, cross_depth=cross_depth)
        return state, rem_acc, bnd_acc

    it = 0
    while it < max_steps:
        # see rays._ALIVE_CHECK: the bodies run after the last ray died
        # are no-ops
        if it % rays._ALIVE_CHECK == 0 and not bool(torch.any(state.alive)):
            break
        state, rem_acc, bnd_acc = body(state, rem_acc, bnd_acc)
        it += 1
        MARCH_STEPS += 1

    diag.ndot_remaining.index_add_(0, src_of_ray, rem_acc)
    diag.ndot_boundary.index_add_(0, src_of_ray, bnd_acc)
    return state, diag


def _trace_all_phases_amr(fields, init_state: _RayState, tables, geom,
                          n_sources: int, dust_approximation: int,
                          max_pixel_level: int, dtype, rates_mode: str,
                          tau_kill: float, rel_kill: float):
    """All phases of the two-level trace over tensors on one device;
    returns (RateFields base, RateFields fine, RayDiagnostics)."""
    n = geom.nx
    n2 = 2 * n
    device = init_state.pos.device
    rmax = rmax_table()
    diag = RayDiagnostics.zeros(n_sources, dtype, device)
    rfb = RateFields(*[torch.zeros(n ** 3, dtype=dtype, device=device)
                       for _ in range(6)])
    rff = RateFields(*[torch.zeros(n2 ** 3, dtype=dtype, device=device)
                       for _ in range(6)])
    fields_pk = {
        "base": _pack_fields(fields["HI"], fields["HeI"], fields["HeII"],
                             fields["nH"], fields["abun2"]),
        "fine": _pack_fields(fields["HI_f"], fields["HeI_f"],
                             fields["HeII_f"], fields["nH_f"],
                             fields["abun2_f"]),
        "refined": fields["refined"],
    }
    rate_ctx = _rate_ctx(tables, rates_mode, dtype, device)
    # the deposits accumulate times a power of two (rays._deposit_scale):
    # a CUDA float32 index_add_ flushes the adds below float32's normal
    # range, which the weights over the base cell's volume reach at the
    # 128^3 galaxy
    scale = _deposit_scale(rate_ctx)
    sig_ratio = _sig_ratio(tables, dtype, device)
    out_radii = torch.tensor(np.array(OUTPUT_RADII_KPC) * KPC, dtype=dtype,
                             device=device)
    state = init_state
    for level in range(1, max_pixel_level + 1):
        last = level == max_pixel_level
        r_stop = rmax[level - 1]
        # twice the uniform tracer's caps: a ray crosses up to twice the
        # cells where it runs through fine ones
        max_steps = int(12 * n + 64) if last else int(6 * (r_stop + 2) + 32)
        src_of_ray = torch.repeat_interleave(
            torch.arange(n_sources, device=device), 12 * 4 ** (level - 1))
        state, diag = _march_phase_amr(
            state, fields_pk, geom, rate_ctx, diag, rfb, rff, r_stop, last,
            dust_approximation, max_steps, src_of_ray, tau_kill, rel_kill,
            scale)
        state, diag = _end_phase(state, diag, src_of_ray, sig_ratio,
                                 out_radii, level, last, n, geom.cell_size,
                                 cell_grid=n2)
    # 1 / scale is a power of two: exact
    rfb, rff = (RateFields(*(getattr(rf, f.name) * (1.0 / scale)
                             for f in dataclasses.fields(rf)))
                for rf in (rfb, rff))
    return rfb, rff, diag


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
    n2 = 2 * geom.nx
    b, f = amr_state.base, amr_state.fine
    fields = {
        "HI": b.HI, "HeI": b.HeI, "HeII": b.HeII, "nH": b.nh,
        "abun2": b.abun2, "HI_f": f.HI, "HeI_f": f.HeI, "HeII_f": f.HeII,
        "nH_f": f.nh, "abun2_f": f.abun2,
    }
    fields = {k: v.reshape(-1).to(dtype) for k, v in fields.items()}
    fields["refined"] = amr_state.refined.reshape(-1)
    state = _spawn_phase(sources, 1, dtype, b.HI.device)
    state = dataclasses.replace(
        state, cell=torch.clamp((state.pos * n2).to(torch.int32), 0, n2 - 1))
    return _trace_all_phases_amr(
        fields, state, tables, geom, sources.n_sources, dust_approximation,
        max_pixel_level, dtype, rates_mode,
        default_tau_kill(dtype) if tau_kill is None else tau_kill,
        default_rel_kill(dtype) if rel_kill is None else rel_kill)
