"""L-level nested (AMR) diffuse sweep, as plain PyTorch ops.

Counterpart of the JAX package's core/sweep_multilevel.py; generalizes the
two-level sweep (core/sweep_amr.py) to any nesting depth with dense
per-level fields.  The reference's recursive refined transport
(transportRoutinesModule.f90:560-963) nests to any depth; here every level
sweeps its own slab-template chain and adjacent levels couple per base
slab:

* cross-level reads follow the reference's neighbor resolution: a cell
  whose upwind face neighbor is a COARSER leaf copies that leaf's
  face-exit output (:637-648); one whose neighbor is REFINED reads the
  face-adjacent child leaf selected by its ray footpoint
  (getXY/XZ/YZNeighbour descent, :455-558);
* refinement maps must be properly nested and 2:1 FACE-BALANCED
  (amr.enforce_balance), so every face read spans at most one level;
* per base slab, a fixed number of Gauss-Seidel passes over the level stack
  (coarsest to finest; finer-level estimates lag one pass) resolves
  in-slab coupling chains across refinement boundaries.

The JAX package scans the zones of equal direction count with one compiled
body.  Eagerly, a zone's ~2,000 launches per base slab would be issued
once per zone; here the zones of a group (equal direction count, and on a
cubic grid equal rotated shapes) ride on a leading batch axis instead, so
the launches are issued once per group, up to the zones that fit in
memory at once (_zones_per_batch).  The 24 octant rotations still run one
per zone, before and after.  What XLA hoists out of the JAX loops is made
once here too: a batch's templates and masks for all its slabs before the
slabs, a slab's attenuation factors before its coupling passes, and a
pass's cross-level planes before its segments.  No hand-written kernel
runs on this path.

Jmean is accumulated on leaf cells only; propagate with
amr.sync_restriction_multi.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..geometry import healpix, octants
from .amr import cover_masks, leaf_masks
from .sweep import _shift_j, _shift_k
from .sweep_amr import (
    _build_chain,
    _chain_arrays,
    _child_start,
    _prolong_plane,
    _segment_factors,
    _segment_outputs,
    _sel_child,
    _slab,
    _slab_tables,
)

# Gauss-Seidel coupling passes per base slab (the JAX package's default;
# MultiLevelModel.validate_coupling_depth picks it for an ingested grid)
N_COUPLING_ITERS = 4


@dataclasses.dataclass(frozen=True)
class MLZoneBatch:
    """Per-zone template chains for every level (one direction batch)."""
    izone: int
    ndir: int
    params: tuple      # per level: dict of (ndir, n * 2**level) arrays


@dataclasses.dataclass(frozen=True)
class MLSweepPlan:
    zones: tuple
    n_directions: int
    nslab: int
    n_levels: int

    @property
    def weight(self) -> float:
        return 1.0 / self.n_directions


def build_ml_sweep_plan(n_angular_level: int, nx: int,
                        n_levels: int) -> MLSweepPlan:
    """Per-level slab-template chains on the host: the same ray family
    sampled at each resolution (setRaysRefined,
    transportRoutinesModule.f90:121-218)."""
    phi, theta = healpix.sweep_directions(n_angular_level)
    folded = octants.fold_all(phi, theta)
    groups = octants.group_by_zone(folded)
    zones = []
    for izone in sorted(groups):
        ds = groups[izone]
        per_level = []
        for ell in range(n_levels):
            chains = []
            for d in ds:
                start = (0.5, 0.5)
                for _ in range(ell):
                    start = _child_start(*start)
                chains.append(_chain_arrays(
                    _build_chain(d.phi, d.theta, nx * 2 ** ell, *start)))
            per_level.append({k: np.stack([c[k] for c in chains])
                              for k in chains[0]})
        zones.append(MLZoneBatch(izone=izone, ndir=len(ds),
                                 params=tuple(per_level)))
    return MLSweepPlan(zones=tuple(zones), n_directions=len(folded),
                       nslab=nx, n_levels=n_levels)


def _shift_mask(m, pad_val: bool, dim: int):
    """Upwind shift of a bool volume along `dim`, padded with pad_val."""
    shape = list(m.shape)
    shape[dim] = 1
    pad = torch.full(shape, pad_val, dtype=torch.bool, device=m.device)
    return torch.cat([pad, m.narrow(dim, 0, m.shape[dim] - 1)], dim=dim)


def _side_fns(shift, pads, nb_cov, coarse, nb_ref, leaf):
    """A level's side-input function: the shifted plane with `pads` as the
    upwind boundary line, where the neighbor is not covered at this level
    the coarser level's face exit (`coarse`), where it is refined the
    finer level's (`leaf`).  With a pair of pads (and then a pair of leaf
    planes, or None), a pair of functions, for segments 2 and 3."""
    def make(pad, leaf_p):
        def side(x):
            v = shift(x, pad)
            if coarse is not None:
                v = torch.where(nb_cov, v, coarse)
            if leaf_p is not None:
                v = torch.where(nb_ref, leaf_p, v)
            return v
        return side
    if isinstance(pads, tuple):
        leafs = leaf if leaf is not None else (None, None)
        return tuple(make(p, lf) for p, lf in zip(pads, leafs))
    return make(pads, leaf)


def _per_pad(fn, pads):
    """fn of each pad of a pair, or of the one pad."""
    return tuple(fn(p) for p in pads) if isinstance(pads, tuple) else fn(pads)


def _slab_gauss_seidel(carry, slab, n_passes: int, uvb_j, uvb_k, sel,
                       ones, level0_segs: bool = False):
    """Gauss-Seidel coupling passes for ONE base slab of an L-level stack;
    returns est, est[l][s] the segment outputs of level l's sub-slab s.

    carry[l]: the top plane of level l under this base slab (its last
    sub-slab's "top" of the slab below, the UVB under slab 0).
    slab[l][s]: level l's sub-slab s as a dict: "sp" its template column
    (_slab_tables), "att" its attenuation factors (_segment_factors),
    "below" None under base slab 0's first sub-slab, else the (cover,
    refined) masks of the sub-slab below, and the masks "nb_cov_j",
    "nb_cov_k", "nb_ref_j", "nb_ref_k" of its upwind j / k neighbors
    (covered at this level; refined); all broadcast against the planes.
    uvb_j[l] / uvb_k[l]: level l's boundary lines; sel(plane, cj, ck):
    the per-direction child of a finer plane (_sel_child); ones: the
    child index 1 for every direction.

    uvb_j[0] / uvb_k[0] may be a pair of boundary lines, the first for
    segment 2's side input and the second for segment 3's: the windowed
    block-sparse sweep (core/sweep_sparse.py) passes there the plain
    full-plane pass's intermediates at its window's upwind edge, the JAX
    package's (pad_seg2, pad_seg3) form.  level0_segs keeps level 0's
    chained intermediates ("seg1", "seg2") in est[0][0].

    Pass 1 runs with no finer estimate; later passes read the previous
    pass's finer-level planes and the current pass's coarser ones, as the
    JAX package's _slab_gauss_seidel does.  A level's coarser and finer
    side planes are made once a pass, before its segments.
    """
    def first(pads):
        # the coarse pad line feeds only first-row cells, which a window
        # keeps uncovered: either line of a pair does
        return pads[0] if isinstance(pads, tuple) else pads

    L = len(slab)
    est = None
    for _ in range(n_passes):
        new = [[None] * (2 ** ell) for ell in range(L)]
        for ell in range(L):
            for s in range(2 ** ell):
                sub = slab[ell][s]
                sp = sub["sp"]

                # ---- xy (bottom-face) input ----
                if s == 0:
                    xy_in = carry[ell]
                    t_coarse = carry[ell - 1] if ell > 0 else None
                    t_fine = carry[ell + 1] if ell < L - 1 else None
                else:
                    xy_in = new[ell][s - 1]["top"]
                    t_coarse = (new[ell - 1][(s - 1) // 2]["top"]
                                if ell > 0 else None)
                    t_fine = (est[ell + 1][2 * s - 1]["top"]
                              if est is not None and ell < L - 1 else None)
                if sub["below"] is not None:
                    # under base slab 0's first sub-slab every cell below
                    # is the boundary at its own level
                    cov_b, ref_b = sub["below"]
                    if t_coarse is not None:
                        xy_in = torch.where(cov_b, xy_in,
                                            _prolong_plane(t_coarse))
                    if t_fine is not None:
                        xy_in = torch.where(
                            ref_b, sel(t_fine, sp["cj_xy"], sp["ck_xy"]),
                            xy_in)

                # ---- side inputs: the coarser level's face exits of
                # this pass, the finer level's of the previous one ----
                coarse_j = coarse_k = leaf_j = leaf_k = None
                if ell > 0:
                    c_est = new[ell - 1][s // 2]
                    coarse_j = _prolong_plane(
                        _shift_j(c_est["exit_jface"], first(uvb_j[ell - 1])))
                    coarse_k = _prolong_plane(
                        _shift_k(c_est["exit_kface"], first(uvb_k[ell - 1])))
                if est is not None and ell < L - 1:
                    f0, f1 = est[ell + 1][2 * s], est[ell + 1][2 * s + 1]
                    # xz rays pick the sub-slab by z0 and the k-child by
                    # x0 (j-child 1, the face-adjacent row); yz rays the
                    # sub-slab by z0 and the j-child by y0
                    ck = sp["ck_xz"]
                    sel_j = torch.where(sp["sub_xz"],
                                        sel(f1["exit_jface"], ones, ck),
                                        sel(f0["exit_jface"], ones, ck))
                    leaf_j = _per_pad(lambda p, x=sel_j: _shift_j(x, p),
                                      uvb_j[ell])
                    cj = sp["cj_yz"]
                    sel_k = torch.where(sp["sub_yz"],
                                        sel(f1["exit_kface"], cj, ones),
                                        sel(f0["exit_kface"], cj, ones))
                    leaf_k = _per_pad(lambda p, x=sel_k: _shift_k(x, p),
                                      uvb_k[ell])

                side_j = _side_fns(_shift_j, uvb_j[ell], sub["nb_cov_j"],
                                   coarse_j, sub["nb_ref_j"], leaf_j)
                side_k = _side_fns(_shift_k, uvb_k[ell], sub["nb_cov_k"],
                                   coarse_k, sub["nb_ref_k"], leaf_k)
                new[ell][s] = _segment_outputs(
                    xy_in, sub["att"], sp, side_j, side_k,
                    want_segs=level0_segs and ell == 0)
        est = new
    return est


def _batch_tables(zones, ell: int, cell_size: float, dtype, device) -> dict:
    """Level ell's templates of a batch of Z zones of D directions each as
    _slab_tables' tensors with the batch axes split: (n_l, Z, D, 1, 1, 1),
    and the child indices (n_l, Z*D) for sel's flattened gather.  The
    lengths are times the level's cell size, cell_size / 2**ell, rounded
    once from float64."""
    Z, D = len(zones), zones[0].ndir
    params = {k: np.concatenate([z.params[ell][k] for z in zones])
              for k in zones[0].params[ell]}
    tables = _slab_tables(params, cell_size / 2 ** ell, dtype, device)

    def split(x):
        return x if x.dim() == 2 else x.reshape(x.shape[0], Z, D,
                                                *x.shape[2:])
    return {k: tuple(split(t) for t in v) if isinstance(v, tuple)
            else split(v) for k, v in tables.items()}


def _zone_bytes(shape0, n_levels: int, ndir: int, itemsize: int) -> int:
    """Bytes one zone of a batch holds on its device: each level's rotated
    opacities and J (3 bands each), its 8 bool masks, and the planes of a
    slab's coupling passes (two passes' segment outputs and a slab's
    attenuation factors, ~16 planes a sub-slab)."""
    nx, ny, nz = shape0
    total = 0
    for ell in range(n_levels):
        m = 2 ** ell
        cells = nx * ny * nz * m ** 3
        total += cells * (2 * 3 * itemsize + 8)
        total += m * 16 * ndir * 3 * ny * nz * m * m * itemsize
    return total


def _zones_per_batch(shape0, n_levels: int, ndir: int, dtype,
                     device, zone_bytes=None) -> int:
    """How many zones of ndir directions one batch carries: those that fit
    in half of the device's free memory (on a CUDA device: what CUDA
    reports free and what PyTorch's allocator holds unused), or in 2
    GiB.  zone_bytes(ndir, itemsize): a zone's bytes, _zone_bytes' dense
    count when None."""
    if torch.device(device).type == "cuda":
        free = (torch.cuda.mem_get_info(device)[0]
                + torch.cuda.memory_reserved(device)
                - torch.cuda.memory_allocated(device))
        budget = free // 2
    else:
        budget = 2 ** 31
    itemsize = torch.finfo(dtype).bits // 8
    per_zone = (_zone_bytes(shape0, n_levels, ndir, itemsize)
                if zone_bytes is None else zone_bytes(ndir, itemsize))
    return max(1, budget // per_zone)


def _rotate_in(vols, izones, to_sweep):
    """(Z, *rotated) stack of each zone's rotation of each volume (the
    last axis of a float volume is its band, moved to axis 1), written
    zone by zone into one tensor."""
    def rotate(v, iz):
        r = octants.rotate_to_sweep(v, iz)
        return torch.movedim(r, -1, 1) if to_sweep else r
    out = []
    for v in vols:
        first = rotate(v, izones[0])
        stack = torch.empty((len(izones), *first.shape), dtype=v.dtype,
                            device=v.device)
        stack[0] = first
        for z, iz in enumerate(izones[1:], start=1):
            stack[z] = rotate(v, iz)
        out.append(stack)
    return out


def zone_batches(plan: MLSweepPlan, shape0, dtype, device,
                 zone_bytes=None):
    """The plan's zones in the batches diffuse_sweep_multilevel sweeps
    them in, each a list of MLZoneBatch: the groups of equal direction
    count in the order their counts first appear, each cut into batches of
    _zones_per_batch zones (sized as the group is reached, by zone_bytes
    when given), or of one zone on a non-cubic grid."""
    groups: dict[int, list[MLZoneBatch]] = {}
    for zone in plan.zones:
        groups.setdefault(zone.ndir, []).append(zone)
    cubic = len(set(shape0)) == 1
    for ndir, zones in groups.items():
        size = (_zones_per_batch(shape0, plan.n_levels, ndir, dtype, device,
                                 zone_bytes) if cubic else 1)
        for b in range(0, len(zones), size):
            yield zones[b:b + size]


def batch_inputs(batch, k_l, cover, refined, cell_size: float):
    """sweep_zones_ml's inputs for a batch of zones: each level's rotated
    opacities (k_l: the levels' opacities with the band last), cover and
    refinement masks, and templates."""
    izones = [z.izone for z in batch]
    dtype, device = k_l[0].dtype, k_l[0].device
    return (_rotate_in(k_l, izones, True),
            _rotate_in(cover, izones, False),
            _rotate_in(refined, izones, False) + [None],
            [_batch_tables(batch, ell, cell_size, dtype, device)
             for ell in range(len(k_l))])


def sweep_zones_ml(k_rots, cover_rots, refined_rots, tables, uvb,
                   weight: float, n_coupling_iters: int):
    """Sweep a batch of Z zones of D directions each over an L-level grid.

    k_rots[l]: (Z, n*2^l, 3, ny*2^l, nz*2^l) rotated opacities;
    cover_rots[l]: (Z, n*2^l, ny*2^l, nz*2^l) bool (the cell exists at
    level l); refined_rots[l]: the same, absent (None) on the finest level;
    tables[l]: _batch_tables of level l.  Returns the per-level J of each
    zone, (Z, n*2^l, 3, ny*2^l, nz*2^l), on leaf cells.
    """
    L = len(k_rots)
    Z, n, _, ny, nz = k_rots[0].shape
    D = tables[0]["len1"].shape[2]
    dtype, device = k_rots[0].dtype, k_rots[0].device
    uvb = torch.as_tensor(uvb, dtype=dtype, device=device).reshape(
        1, 1, 3, 1, 1)
    dirs = torch.arange(Z * D, device=device)
    ones = torch.ones(Z * D, dtype=torch.int64, device=device)

    def sel(plane, cj, ck):
        out = _sel_child(plane.reshape(Z * D, *plane.shape[2:]), dirs, cj,
                         ck)
        return out.reshape(Z, D, *out.shape[1:])

    sizes = [(ny * 2 ** ell, nz * 2 ** ell) for ell in range(L)]
    uvb_j = [uvb.expand(Z, D, 3, 1, b) for _, b in sizes]
    uvb_k = [uvb.expand(Z, D, 3, a, 1) for a, _ in sizes]
    carry = [uvb.expand(Z, D, 3, a, b) for a, b in sizes]

    # every slab's masks at once, (Z, n_l, a, b), then viewed per slab
    masks = []
    for ell in range(L):
        cov = cover_rots[ell]
        ref = (refined_rots[ell] if ell < L - 1
               else torch.zeros_like(cov))
        masks.append({
            "cov": cov, "ref": ref, "leaf": cov & ~ref,
            "nb_cov_j": _shift_mask(cov, True, 2),
            "nb_cov_k": _shift_mask(cov, True, 3),
            "nb_ref_j": _shift_mask(ref, False, 2),
            "nb_ref_k": _shift_mask(ref, False, 3)})

    def view(mask, idx):
        return mask[:, idx][:, None, None]

    j_out = [torch.empty_like(k) for k in k_rots]
    for i in range(n):
        slab = []
        for ell in range(L):
            subs = []
            for s in range(2 ** ell):
                idx = i * 2 ** ell + s
                sp = _slab(tables[ell], idx)
                mk = masks[ell]
                subs.append({
                    "sp": sp,
                    "att": _segment_factors(k_rots[ell][:, idx][:, None],
                                            sp),
                    "below": (None if idx == 0 else
                              (view(mk["cov"], idx - 1),
                               view(mk["ref"], idx - 1))),
                    **{k: view(mk[k], idx) for k in (
                        "nb_cov_j", "nb_cov_k", "nb_ref_j", "nb_ref_k")}})
            slab.append(subs)
        est = _slab_gauss_seidel(carry, slab, n_coupling_iters, uvb_j,
                                 uvb_k, sel, ones)
        for ell in range(L):
            for s in range(2 ** ell):
                idx = i * 2 ** ell + s
                j_out[ell][:, idx] = weight * torch.sum(torch.where(
                    view(masks[ell]["leaf"], idx), est[ell][s]["j_slab"],
                    0.0), dim=1)
        carry = [est[ell][2 ** ell - 1]["top"] for ell in range(L)]
    return j_out


def diffuse_sweep_multilevel(kappas, refined, plan: MLSweepPlan, uvb,
                             cell_size: float,
                             n_coupling_iters: int = N_COUPLING_ITERS):
    """Full L-level sweep.

    kappas[l]: (3, n*2^l, ...); refined[l]: (n*2^l)^3 bool (L-1 entries,
    properly nested and face-balanced).  Returns the per-level Jmean list
    (leaf cells only; sync with amr.sync_restriction_multi).  The zones of
    equal direction count sweep together in batches (on a non-cubic grid,
    where the octant transposes change the shapes, one zone at a time),
    and their J is summed in the JAX package's order: zone by zone, the
    groups in the order their counts first appear.
    """
    L = plan.n_levels
    if len(kappas) != L or len(refined) != L - 1:
        raise ValueError(f"{len(kappas)} opacity levels and {len(refined)} "
                         f"refinement maps for a {L}-level plan")
    device, dtype = kappas[0].device, kappas[0].dtype
    shape0 = tuple(kappas[0].shape[1:])
    refined = [torch.as_tensor(r, device=device).to(torch.bool)
               for r in refined]
    cover = cover_masks(refined, shape0, device)
    k_l = [torch.movedim(k, 0, -1) for k in kappas]
    j_acc = [torch.zeros_like(k) for k in k_l]
    for batch in zone_batches(plan, shape0, dtype, device):
        js = sweep_zones_ml(*batch_inputs(batch, k_l, cover, refined,
                                          cell_size),
                            uvb, plan.weight, n_coupling_iters)
        for z, zone in enumerate(batch):
            for ell in range(L):
                j_acc[ell] = j_acc[ell] + octants.rotate_from_sweep(
                    torch.movedim(js[ell][z], 1, -1), zone.izone)
        del js
    return [torch.movedim(j, -1, 0) for j in j_acc]


def _residual(js_a, js_b, leaf) -> float:
    """The largest leaf-cell |a - b| over the peak of |a|, level by
    level."""
    res = 0.0
    for a, b, m in zip(js_a, js_b, leaf):
        scale = max(float(a.abs().max()), 1e-300)
        d = float(torch.where(m[None], (a - b).abs(), 0.0).max()) / scale
        res = max(res, d)
    return res


def coupling_residual(kappas, refined, plan: MLSweepPlan, uvb, cell_size,
                      n_coupling_iters: int = N_COUPLING_ITERS) -> float:
    """Convergence diagnostic for the fixed Gauss-Seidel coupling depth:
    the max leaf-cell relative Jmean change from one extra coupling pass.
    In-slab coupling chains have finite depth, so this residual hits zero
    once n_coupling_iters covers the longest chain; a large value means the
    depth under-resolves the refinement pattern."""
    refined = [torch.as_tensor(r, device=kappas[0].device).to(torch.bool)
               for r in refined]
    js_a = diffuse_sweep_multilevel(kappas, refined, plan, uvb, cell_size,
                                    n_coupling_iters)
    js_b = diffuse_sweep_multilevel(kappas, refined, plan, uvb, cell_size,
                                    n_coupling_iters + 1)
    return _residual(js_a, js_b, leaf_masks(
        refined, tuple(kappas[0].shape[1:]), kappas[0].device))


def pick_coupling_iters(kappas, refined, plan: MLSweepPlan, uvb, cell_size,
                        tol: float = 1e-8, max_iters: int = 12) -> int:
    """Smallest coupling depth whose one-more-pass residual
    (coupling_residual) is below tol, else max_iters.  Each depth's sweep
    runs once: depth d's residual reuses the sweep that depth d - 1's
    residual ran at d."""
    refined = [torch.as_tensor(r, device=kappas[0].device).to(torch.bool)
               for r in refined]
    leaf = leaf_masks(refined, tuple(kappas[0].shape[1:]),
                      kappas[0].device)

    def sweep(iters):
        return diffuse_sweep_multilevel(kappas, refined, plan, uvb,
                                        cell_size, iters)
    js = sweep(1)
    for iters in range(1, max_iters + 1):
        js_next = sweep(iters + 1)
        if _residual(js, js_next, leaf) < tol:
            return iters
        js = js_next
    return max_iters
