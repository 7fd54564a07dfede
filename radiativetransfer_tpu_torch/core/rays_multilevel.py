"""L-level AMR point-source ray tracer in PyTorch, dense and block-sparse
storage.

Counterpart of the JAX package's core/rays_multilevel.py.  It generalizes
the two-level tracer (core/rays_amr.py) to any nesting depth: every ray
tracks its containing FINEST-grid cell index, and the leaf level of that
cell selects the local cell size for face crossings, optical depths,
split radii and the per-level deposits.  On dense storage
(trace_point_sources_ml) a dense leaf-level volume at the finest
resolution gives the leaf level; on block-sparse storage
(trace_point_sources_sparse, core/amr_sparse.py) each refined level is
looked up through its tile -> slot map into block-flat arrays, an absent
tile reading the zero padding block, and the leaf level is the count of
the levels that cover the cell: no finest-resolution volume is built.

Reference semantics kept (equiSources.f90:2412-2595, 3120-3385): segment
geometry in current-cell units (drawSegment), the split criterion at the
LOCAL level (:2491: the stop radius scales as 2^-level inside refined
regions), deposits into the traversed leaf, and face hand-off by exact
index arithmetic at the leaf's granularity (findXY/YZ/XZNeighbour + zoom*,
:2647-2960, as dense shifts and masks).

As in the JAX package, the levels share ONE combined index into their
level-concatenated layout (level 0 flat (n^3,), a dense level l
(n*2^l)^3, a block-sparse one nb*be^3): a march step does one gather of
the packed fields and one index_add_ per deposit channel, whatever the
depth and the storage.  What differs from it is what differs in
core/rays_amr.py: an eager march that reads any(alive) every
rays._ALIVE_CHECK bodies, index_add_ deposits (atomic on a CUDA device),
the deposits accumulated times rays._deposit_scale, the cell faces in the
run's dtype (the JAX package's int32 / int is float32 even in float64
runs: exact at power-of-two grids), and the quadrature_noneq mode's
spectrum-exhaustion envelope bounding the k27..k31 weights too, as the
port's and the JAX package's uniform tracers do.  The JAX package's
host-driven phase loop (_trace_all_phases_ml_host, bounded dispatches for
its remote TPU worker) is the eager march itself here; what it records,
LAST_TRACE_PHASE_TIMES, a trace fills with host_phases set.

No hand kernel here: the JAX L-level tracer is a plain jax.lax.while_loop
with no Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import time

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
    NoneqRateFields,
    RateFields,
    RayDiagnostics,
    SourceBatch,
    _RayState,
    _deposit_noneq,
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

# march steps run by _march_phase_ml, every phase of every trace (the
# per-step costs of profile_step divide by it)
MARCH_STEPS = 0

# per-phase record of the most recent trace run with host_phases set:
# {"level{k}": seconds, "level{k}_steps": march steps, "level{k}_alive":
# the alive count read every chunk_steps march steps}
LAST_TRACE_PHASE_TIMES: dict = {}


def leaf_level_volume(refined, n: int, n_levels: int,
                      device=None) -> torch.Tensor:
    """Dense (nF^3,) int32 leaf level at the FINEST resolution nF =
    n * 2^(L-1): the number of refined ancestors of each finest-grid cell
    (properly nested maps), on `device` (the maps' by default)."""
    if device is None:
        device = refined[0].device
    nF = n * 2 ** (n_levels - 1)
    lvl = torch.zeros((nF,) * 3, dtype=torch.int32, device=device)
    cover = torch.ones((n,) * 3, dtype=torch.bool, device=device)
    for ell, r in enumerate(refined):
        rc = r.to(torch.bool) & cover
        rep = 2 ** (n_levels - 1 - ell)
        lvl += (rc.repeat_interleave(rep, 0).repeat_interleave(rep, 1)
                .repeat_interleave(rep, 2))
        cover = (rc.repeat_interleave(2, 0).repeat_interleave(2, 1)
                 .repeat_interleave(2, 2))
    return lvl.reshape(-1)


def _level_sizes(n: int, n_levels: int, fields=None) -> list[int]:
    """Per-level flat sizes of the level-concatenated layout: (n*2^l)^3
    dense, nb*be^3 for a block-sparse level (fields' 'blocks')."""
    if fields is not None and "blocks" in fields:
        return [n ** 3] + [b["cover"].shape[0] for b in fields["blocks"]]
    return [(n * 2 ** ell) ** 3 for ell in range(n_levels)]


def _level_offsets(n: int, n_levels: int, fields=None) -> list[int]:
    """Offsets of each level's slice in the level-CONCATENATED layout (the
    packed fields 'lv_all', the combined deposit accumulators)."""
    return [0] + np.cumsum(_level_sizes(n, n_levels, fields))[:-1].tolist()


def _addr_all(fields, n: int, n_levels: int, cf):
    """Every ray's (combined flat index into the level-concatenated layout,
    leaf level), from its finest-grid cell cf (R, 3) int32.  Dead rays carry
    frozen, possibly out-of-box cells: their addresses are clipped into the
    box (their deposits are 0 and their reads masked).

    Dense storage (fields has 'leaf_level'): the JAX package computes the
    L levels' indices and selects one; here the leaf level is read first
    and only its index is computed: the same result (a clip commutes with
    the right shifts) in a launch count that does not grow with L.

    Block-sparse storage (fields has 'blocks', one dict a refined level:
    its tile -> slot map flat 'slot' (T^3,), its cover flat 'cover'
    (nb*be^3,), 'T', 'be', 'nb'): each refined level's cell is looked up
    through the slot map into the level's block-flat data, an absent tile
    routed to the padding block nb-1 (amr_sparse.flat_lookup's
    addressing), and the leaf level is the count of the levels that cover
    the cell (properly nested maps: the deepest covering level), as the
    JAX package's sparse branch does."""
    nF = n * 2 ** (n_levels - 1)
    cc = torch.clamp(cf, 0, nF - 1)
    offsets = fields["offsets"]
    if "leaf_level" in fields:
        lvl = fields["leaf_level"][((cc[:, 0] * nF + cc[:, 1]) * nF
                                    + cc[:, 2]).long()]
        c = cc >> ((n_levels - 1) - lvl)[:, None]
        nl = n << lvl
        idx = offsets[lvl.long()] + ((c[:, 0] * nl + c[:, 1]) * nl
                                     + c[:, 2]).long()
        return idx, lvl
    c = (cc >> (n_levels - 1)).long()
    idx = (c[:, 0] * n + c[:, 1]) * n + c[:, 2]
    lvl = torch.zeros_like(cf[:, 0])
    flats = []
    for ell, b in enumerate(fields["blocks"], start=1):
        be, T = b["be"], b["T"]
        c = (cc >> (n_levels - 1 - ell)).long()
        t = b["slot"][((c[:, 0] // be) * T + c[:, 1] // be) * T
                      + c[:, 2] // be].long()
        t = torch.where(t < 0, b["nb"] - 1, t)
        flat = t * be ** 3 + ((c[:, 0] % be) * be + c[:, 1] % be) * be \
            + c[:, 2] % be
        lvl = lvl + b["cover"][flat]
        flats.append(flat)
    for ell, flat in enumerate(flats, start=1):
        idx = torch.where(lvl == ell, offsets[ell] + flat, idx)
    return idx, lvl


def _march_phase_ml(state: _RayState, fields, geom, n_levels: int, rate_ctx,
                    diag: RayDiagnostics, rf, r_stop: float,
                    last_phase: bool, dust_approximation: int,
                    max_steps: int, src_of_ray, tau_kill: float,
                    rel_kill: float, scale: float, chunk_steps: int = 0,
                    alive: list | None = None, rank_offset=None):
    """March one phase on an L-level grid; the deposits accumulate into rf
    (RateFields or NoneqRateFields over the level-concatenated layout) in
    place, the six RateFields channels times `scale`.  Returns (state,
    diag).

    state.cell holds FINEST-grid indices; fields holds the packed rows of
    every level, concatenated, 'lv_all' (sum of the level sizes, 5) [HI,
    HeI, HeII, nH, abun2], the levels' offsets 'offsets' (L,) int64 and
    the addressing of one storage (_addr_all): the leaf-level volume
    'leaf_level' (nF^3,), or the refined levels' 'blocks'.  rate_ctx:
    rays._rate_ctx's.  tau_kill and rel_kill: as in rays._march_phase.
    chunk_steps > 0 also reads the alive count every chunk_steps march
    steps, and where the phase ends, into the list `alive`: the bodies
    run after the last ray died are no-ops, so the deposits are the same
    either way.  rank_offset: None, or each ray's offset into rf's
    rank-major accumulators (rays._rank_offset)."""
    global MARCH_STEPS
    L = n_levels
    n = geom.nx
    nF = n * 2 ** (L - 1)
    cell_size = geom.cell_size
    dtype, device = state.ndot.dtype, state.ndot.device
    out_radii = torch.tensor(np.array(OUTPUT_RADII_KPC) * KPC, dtype=dtype,
                             device=device)
    R = state.pos.shape[0]
    rem_acc = torch.zeros((R, out_radii.shape[0]), dtype=dtype, device=device)
    bnd_acc = torch.zeros((R, out_radii.shape[0]), dtype=dtype, device=device)
    axes = torch.arange(3, device=device)
    rates_mode = rate_ctx[0]
    # the split radius at each level, in base-cell units
    inv2 = torch.tensor(0.5 ** np.arange(L), dtype=dtype, device=device)
    wsum = None
    if rates_mode.startswith("quadrature") and rel_kill > 0.0:
        # the spectrum-exhaustion kill of rays._march_phase, whose envelope
        # bounds the k27..k31 weights too (per face area, quad_W per cell
        # volume)
        wsum = torch.amax(torch.sum(torch.abs(rate_ctx[1][1]), dim=2), dim=0)
        if rates_mode == "quadrature_noneq":
            wsum = torch.maximum(wsum, torch.amax(
                torch.sum(torch.abs(rate_ctx[1][2]), dim=2), dim=0)
                / cell_size)
        rem_floor = rel_kill * torch.sum(wsum)
    # a position exactly on a face belongs to the cell the ray is
    # ENTERING: the non-crossing axes relocalize with a downwind nudge that
    # must exceed the position's ulp at the grid scale, else a corner hit
    # desyncs pos and cell into a zero-step period-2 cycle in float32
    # (tests/test_torch_rays_ml.py::test_face_exact_f32_rays_terminate);
    # float64 keeps the parity tolerance
    tol = 2.0 ** -10 if dtype == torch.float32 else 1.0e-6
    lv_all = fields["lv_all"]
    bufs = [getattr(rf, f.name) for f in dataclasses.fields(rf)]
    noneq = rates_mode == "quadrature_noneq"
    # the rays' deposit weights (ndot is fixed within a phase)
    w_scaled = state.ndot * scale

    def body(state, rem_acc, bnd_acc):
        d = state.direction
        floor = torch.full_like(d, 1e-12)
        d_safe = torch.where(torch.abs(d) < 1e-12,
                             torch.where(d < 0, -floor, floor), d)
        active = state.alive
        cf = state.cell                                  # finest (R, 3)
        idx, lvl = _addr_all(fields, n, L, cf)
        shift = ((L - 1) - lvl)[:, None]

        # exit faces at the LEAF's granularity, in finest-grid units
        dpos = (d_safe > 0.0).to(cf.dtype)
        f_bound = ((cf >> shift) + dpos) << shift
        t_ax = (f_bound.to(dtype) / nF - state.pos) / d_safe
        # f32 position round-off can overshoot a face: the exact distance
        # is then 0 (rays._march_phase)
        t_min = torch.clamp(torch.amin(t_ax, dim=1), min=0.0)
        # ties break to the first axis, as jnp.argmin does
        exit_axis = torch.argmin(t_ax, dim=1)
        seg_cells = t_min * n                            # base-cell units

        # the split criterion at the LOCAL level (:2491)
        r_stop_local = inv2[lvl.long()] * r_stop
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

        # one gather of the packed rows, one index_add_ a channel: each
        # ray deposits once, into its own leaf level's slice
        tau = _segment_tau(lv_all[idx], seg_cells * cell_size, active,
                           dust_approximation)
        rem_acc, crossed, cross_depth, r2 = _escape_update(
            state, radius_new, tau, active, out_radii, cell_size, rem_acc)
        deposit, rem = _rate_deposits(state, tau,
                                      torch.where(active, w_scaled, 0.0),
                                      rate_ctx, dust_approximation,
                                      wsum=wsum)
        if noneq:
            deposit = deposit + _deposit_noneq(
                state.depth, rate_ctx[1][0], rate_ctx[1][2], state.table_idx,
                torch.where(active, state.ndot, 0.0),
                torch.where(active, seg_cells, 0.0))
        dep_idx = idx if rank_offset is None else idx + rank_offset
        for buf, v in zip(bufs, deposit):
            buf.index_add_(0, dep_idx, v)

        # advance: snap the crossing coordinate onto the face, exact index
        # arithmetic on the crossed axis, relocalize the others
        depth_new = state.depth + tau
        pos_new = state.pos + t_min[:, None] * d
        face_f = torch.gather(f_bound, 1, exit_axis[:, None])[:, 0]
        on_axis = axes[None, :] == exit_axis[:, None]
        pos_new = torch.where(on_axis & ~cut[:, None],
                              (face_f.to(dtype) / nF)[:, None], pos_new)
        entering_up = torch.gather(d_safe > 0, 1, exit_axis[:, None])[:, 0]
        new_axis_idx = torch.where(entering_up, face_f, face_f - 1)
        # truncated toward zero, as JAX's astype
        cf_from_pos = torch.clamp(
            (pos_new * nF + torch.sign(d_safe) * tol).to(cf.dtype),
            0, nF - 1)
        cell_new = torch.where(on_axis, new_axis_idx[:, None], cf_from_pos)
        cell_new = torch.where(cut[:, None], cf, cell_new)

        out_of_box = torch.any((cell_new < 0) | (cell_new >= nF),
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

    it = read_at = 0
    while it < max_steps:
        if chunk_steps and it and it % chunk_steps == 0:
            alive.append(int(state.alive.sum()))
            read_at = it
            if not alive[-1]:
                break
        # see rays._ALIVE_CHECK: the bodies run after the last ray died
        # are no-ops
        if it % rays._ALIVE_CHECK == 0 and not bool(torch.any(state.alive)):
            break
        state, rem_acc, bnd_acc = body(state, rem_acc, bnd_acc)
        it += 1
        MARCH_STEPS += 1
    if chunk_steps and read_at != it:
        # the count where the phase ended, between two reads
        alive.append(int(state.alive.sum()))

    diag.ndot_remaining.index_add_(0, src_of_ray, rem_acc)
    diag.ndot_boundary.index_add_(0, src_of_ray, bnd_acc)
    return state, diag


def _trace_all_phases_ml(fields, init_state: _RayState, tables, geom,
                         n_levels: int, n_sources: int,
                         dust_approximation: int, max_pixel_level: int,
                         dtype, rates_mode: str, tau_kill: float,
                         rel_kill: float, chunk_steps: int = 0,
                         n_ranks: int = 1):
    """All phases of the L-level trace over tensors on one device, either
    storage's addressing in `fields` (_addr_all); returns (tuple of
    per-level RateFields or NoneqRateFields, RayDiagnostics).  chunk_steps
    > 0 (host_phases) reads the alive count every chunk_steps march steps
    (one count over every rank's rays) and records each phase in
    LAST_TRACE_PHASE_TIMES.  n_ranks: rays._trace_all_phases's, each
    rank's slice the whole level-concatenated layout."""
    n = geom.nx
    nF = n * 2 ** (n_levels - 1)
    device = init_state.pos.device
    rmax = rmax_table()
    diag = RayDiagnostics.zeros(n_sources, dtype, device)
    # ONE deposit accumulator a channel over the level-concatenated layout,
    # split per level on return
    sizes = _level_sizes(n, n_levels, fields)
    rf_cls = NoneqRateFields if rates_mode == "quadrature_noneq" \
        else RateFields
    rf = rf_cls(*[torch.zeros(n_ranks * sum(sizes), dtype=dtype,
                              device=device)
                  for _ in dataclasses.fields(rf_cls)])
    rate_ctx = _rate_ctx(tables, rates_mode, dtype, device)
    # the six RateFields channels accumulate times a power of two
    # (rays._deposit_scale): a CUDA float32 index_add_ flushes the adds
    # below float32's normal range, and the finer levels' shorter segments
    # make smaller deposits still
    scale = _deposit_scale(rate_ctx)
    sig_ratio = _sig_ratio(tables, dtype, device)
    out_radii = torch.tensor(np.array(OUTPUT_RADII_KPC) * KPC, dtype=dtype,
                             device=device)
    state = init_state
    if chunk_steps:
        LAST_TRACE_PHASE_TIMES.clear()
    for level in range(1, max_pixel_level + 1):
        last = level == max_pixel_level
        r_stop = rmax[level - 1]
        max_steps = (int(12 * nF + 64) if last
                     else int(6 * 2 ** (n_levels - 1) * (r_stop + 2) + 32))
        src_of_ray = torch.repeat_interleave(
            torch.arange(n_sources, device=device), 12 * 4 ** (level - 1))
        t0, steps0, alive = time.perf_counter(), MARCH_STEPS, []
        state, diag = _march_phase_ml(
            state, fields, geom, n_levels, rate_ctx, diag, rf, r_stop, last,
            dust_approximation, max_steps, src_of_ray, tau_kill, rel_kill,
            scale, chunk_steps, alive,
            rays._rank_offset(src_of_ray, n_sources, n_ranks, sum(sizes)))
        if chunk_steps:
            # the last alive count synchronized the device
            LAST_TRACE_PHASE_TIMES[f"level{level}"] = (time.perf_counter()
                                                       - t0)
            LAST_TRACE_PHASE_TIMES[f"level{level}_steps"] = (MARCH_STEPS
                                                             - steps0)
            LAST_TRACE_PHASE_TIMES[f"level{level}_alive"] = alive
        state, diag = _end_phase(state, diag, src_of_ray, sig_ratio,
                                 out_radii, level, last, n, geom.cell_size,
                                 cell_grid=nF)
    # 1 / scale is a power of two: exact
    rf = dataclasses.replace(rf, **{
        f.name: getattr(rf, f.name) * (1.0 / scale)
        for f in dataclasses.fields(RateFields)})
    return _split_rfs(rays._sum_ranks(rf, n_ranks), sizes), diag


def _split_rfs(rf, sizes) -> tuple:
    """The combined flat RateFields split back into per-level ones (views
    of the combined tensors)."""
    parts = {f.name: torch.split(getattr(rf, f.name), sizes)
             for f in dataclasses.fields(rf)}
    return tuple(type(rf)(**{k: v[ell] for k, v in parts.items()})
                 for ell in range(len(sizes)))


def _trace(fields, levels, geom, sources: SourceBatch, tables,
           dust_approximation: int, max_pixel_level: int, dtype,
           rates_mode: str, tau_kill, rel_kill, chunk_steps: int = 0,
           n_ranks: int = 1):
    """The trace of either storage: `fields` with its addressing
    (_addr_all) but the packed rows, which come from `levels` (FieldStates,
    level 0 first, each flattened in its storage's order) and the level
    offsets; the rays spawned at their sources' finest-grid cells.
    n_ranks: _trace_all_phases_ml's."""
    if rates_mode == "auto":
        rates_mode = "quadrature" if "quad_A" in tables else "table"
    if rates_mode not in ("table", "quadrature", "quadrature_noneq"):
        raise ValueError(f"unknown rates_mode {rates_mode!r}")
    L = len(levels)
    n = geom.nx
    nF = n * 2 ** (L - 1)
    device = levels[0].HI.device
    fields["lv_all"] = torch.cat([
        _pack_fields(*(x.reshape(-1).to(dtype) for x in (
            f.HI, f.HeI, f.HeII, f.nh, f.abun2))) for f in levels])
    fields["offsets"] = torch.tensor(_level_offsets(n, L, fields),
                                     dtype=torch.int64, device=device)
    state = _spawn_phase(sources, 1, dtype, device)
    state = dataclasses.replace(
        state, cell=torch.clamp((state.pos * nF).to(torch.int32), 0, nF - 1))
    return _trace_all_phases_ml(
        fields, state, tables, geom, L, sources.n_sources,
        dust_approximation, max_pixel_level, dtype, rates_mode,
        default_tau_kill(dtype) if tau_kill is None else tau_kill,
        default_rel_kill(dtype) if rel_kill is None else rel_kill,
        chunk_steps, n_ranks)


def trace_point_sources_ml(ml_state, geom, sources: SourceBatch, tables,
                           dust_approximation: int = NO_DUST,
                           max_pixel_level: int = MAX_PIXEL_LEVEL,
                           dtype=torch.float64, rates_mode: str = "auto",
                           tau_kill: float | None = None,
                           rel_kill: float | None = None):
    """Trace sources through a MultiLevelState (core/amr.py) on its device;
    returns (tuple of per-level RateFields, level l's flat (n*2^l)^3, and
    RayDiagnostics).

    tables, rates_mode ('auto', 'table', 'quadrature' or
    'quadrature_noneq', the last returning NoneqRateFields), tau_kill and
    rel_kill: as rays.trace_point_sources takes them.  The deposits are
    over the tables' volume: StellarContext.build divides them by the BASE
    cell's (the k27..k31 weights by its face area), so a level-l cell's
    rate is its deposit times 8^l (MultiLevelModel.trace)."""
    return _trace(*dense_addressing(ml_state, geom.nx), geom, sources,
                  tables, dust_approximation, max_pixel_level, dtype,
                  rates_mode, tau_kill, rel_kill)


def dense_addressing(ml_state, n: int):
    """(the tracer's addressing of a MultiLevelState, its levels): the
    leaf-level volume (leaf_level_volume) and the level FieldStates."""
    fields = {"leaf_level": leaf_level_volume(
        ml_state.refined, n, ml_state.n_levels, ml_state.levels[0].HI.device)}
    return fields, ml_state.levels


def sparse_addressing(sp_state):
    """(the tracer's addressing of a SparseMLState, its levels): each
    refined level's flat slot map and cover with its sizes, and level 0's
    FieldState then each refined level's block FieldState."""
    fields = {"blocks": [{"slot": lv.slot.reshape(-1),
                          "cover": lv.cover.reshape(-1),
                          "T": lv.slot.shape[0], "be": lv.be,
                          "nb": lv.n_blocks} for lv in sp_state.levels]}
    return fields, [sp_state.base] + [lv.fields for lv in sp_state.levels]


def trace_point_sources_sparse(sp_state, geom, sources: SourceBatch, tables,
                               dust_approximation: int = NO_DUST,
                               max_pixel_level: int = MAX_PIXEL_LEVEL,
                               dtype=torch.float64, rates_mode: str = "auto",
                               tau_kill: float | None = None,
                               rel_kill: float | None = None,
                               host_phases: bool = False,
                               chunk_steps: int = 512):
    """Trace sources through a block-sparse SparseMLState
    (core/amr_sparse.py) on its device: the march of trace_point_sources_ml
    with the block-sparse addressing (_addr_all), the field gathers and the
    deposits through each refined level's tile -> slot map into its
    block-flat arrays, so no finest-resolution array is built.  Returns
    (tuple of per-level RateFields, level 0's flat (n^3,), a refined
    level's block-flat (nb*be^3,), and RayDiagnostics).

    tables, rates_mode, tau_kill and rel_kill: as trace_point_sources_ml
    takes them.  host_phases reads the alive count every `chunk_steps`
    march steps (the JAX package's host-driven phase loop) and records
    each phase's seconds, march steps and alive counts in
    LAST_TRACE_PHASE_TIMES: the same deposits; without it the march reads
    any(alive) every rays._ALIVE_CHECK steps and records nothing."""
    if host_phases and chunk_steps < 1:
        raise ValueError(f"chunk_steps must be positive, not {chunk_steps}")
    return _trace(*sparse_addressing(sp_state), geom, sources, tables,
                  dust_approximation, max_pixel_level, dtype, rates_mode,
                  tau_kill, rel_kill, chunk_steps if host_phases else 0)
