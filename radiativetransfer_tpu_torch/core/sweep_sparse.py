"""Block-sparse L-level diffuse sweep, as plain PyTorch ops.

Counterpart of the JAX package's core/sweep_sparse.py.  The transport math
is the L-level sweep's (core/sweep_multilevel.py::_slab_gauss_seidel), but
the refined levels' VOLUMES never materialize: per base slab each level's
dense cross-section planes are GATHERED from block storage (slot-map
lookup, whole (be, be) block rows) and the slab's leaf-masked Jmean is
SCATTERED back into per-level block accumulators.  Memory is

  O(n^3) base level  +  O(leaves) blocks  +  O(cross-section) planes

instead of O((n 2^L)^3) dense volumes, the reference octree's memory per
leaf (definitionsModule.f90:163-180).  Slabs with no refined coverage run
the level-0 transport alone (the skip branch).  With a refinement window
(compute_window) the coupled fine-level stack runs only on each slab's
W x W window of the cross-section, between a plain full-plane level-0 pass
that gives the window its upwind boundary lines (P1) and one that carries
the window's coupled output downwind (P2); the result is the full-plane
stack's, exactly.

As in the dense L-level sweep, the zones of equal direction count ride on
a leading batch axis, as many as fit in memory (zone_batches, sized here
by the sparse footprint: the rotated blocks and a slab's planes at the
window's cross-section).  What the JAX package decides on the device is
decided on the host before the sweep: each slab's coverage bit (JAX's
lax.cond) and each slab's window starts (its dynamic_slice) are NumPy
arrays of the state's refinement map, so the skip branch, the window's
moves and the crops are Python control flow, with no read back from the
device inside the slab loop.  A batch takes the skip branch at a slab
where no zone of it has coverage; a zone without coverage at a slab
where another has some runs the full branch, which gives it the skip
branch's values exactly (its fine planes are uncovered, so every mask
selects the level-0 values).  The zones of a batch have window starts of
their own: each crop and paste is ONE gather or scatter over the batch
with per-zone flat cell indices, which the device computes from the
batch's starts when they change, rather than a narrow() per zone (Z
launches per crop, and no fewer host-device copies).

J is summed in the JAX package's order: zone by zone, the groups in the
order their direction counts first appear.  No hand-written kernel runs
on this path.  Jmean is accumulated on leaf cells only; propagate with
amr_sparse.sync_restriction_sparse.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import octants
from .amr_sparse import SparseMLState
from .sweep import _shift_j, _shift_k
from .sweep_amr import _prolong_plane, _segment_factors, _segment_outputs
from .sweep_amr import _sel_child, _slab
from .sweep_multilevel import (
    N_COUPLING_ITERS,
    MLSweepPlan,
    _batch_tables,
    _rotate_in,
    _shift_mask,
    _slab_gauss_seidel,
    zone_batches,
)


def _slab_slots(slot_rot, X: int, be: int):
    """(slot plane (Z, T, T), in-block x offset) of level slab X: slot_rot
    (Z, T, T, T) the batch's rotated tile -> slot maps, absent tiles
    already routed to the padding block (slot nb-1, all zeros)."""
    return slot_rot[:, X // be], X % be


def _block_index(blocks, sp):
    """The advanced indices of the (Z, C, tiles...) blocks of slot plane
    sp (Z, t1, t2) in a (Z, C, nb, ...) block tensor."""
    Z, C = blocks.shape[:2]
    dev = blocks.device
    return (torch.arange(Z, device=dev)[:, None, None, None],
            torch.arange(C, device=dev)[None, :, None, None], sp[:, None])


def _gather_plane(blocks, sp, ox: int):
    """A dense level cross-section (Z, C, t1*be, t2*be) from block storage:
    blocks (Z, C, nb, be, be, be), sp (Z, t1, t2) its slot plane, ox the
    in-block x.  Whole (be, be) block sub-planes: t1*t2 rows a zone."""
    Z, C = blocks.shape[:2]
    be = blocks.shape[-1]
    t1, t2 = sp.shape[1:]
    g = blocks[:, :, :, ox][_block_index(blocks, sp)]   # (Z,C,t1,t2,be,be)
    return g.permute(0, 1, 2, 4, 3, 5).reshape(Z, C, t1 * be, t2 * be)


def _scatter_plane(blocks, sp, ox: int, plane) -> None:
    """Write a dense (Z, C, t1*be, t2*be) plane into block storage in place
    (the inverse of _gather_plane), the JAX package's scatter-add into
    zeroed accumulators: a zone writes each cell of a real block once (its
    slab and sub-slab fix the tile row and the in-block x), and only
    absent tiles repeat a slot, the padding block, with values that are
    zero (cover-masked).  So a plain scatter gives the sum exactly,
    without the index sort of an accumulating index_put_."""
    Z, C = blocks.shape[:2]
    be = blocks.shape[-1]
    t1, t2 = sp.shape[1:]
    p = plane.reshape(Z, C, t1, be, t2, be).permute(0, 1, 2, 4, 3, 5)
    blocks[:, :, :, ox].index_put_(_block_index(blocks, sp), p)


def _crop(x, idx, w: int):
    """x (Z, *mid, a, b) cut to each zone's (w, w) window: idx (Z, w*w)
    the window's flat cell indices in an (a, b) plane."""
    Z, mid = x.shape[0], x.shape[1:-2]
    flat = x.reshape(Z, *mid, -1)
    ix = idx.view(Z, *((1,) * len(mid)), -1).expand(Z, *mid, idx.shape[1])
    return flat.gather(-1, ix).view(Z, *mid, w, w)


def _paste(x, win, idx):
    """x (Z, *mid, a, b) with each zone's window (the cells of idx)
    replaced by win (Z, *mid, w, w)."""
    Z, mid = x.shape[0], x.shape[1:-2]
    out = x.clone(memory_format=torch.contiguous_format)
    ix = idx.view(Z, *((1,) * len(mid)), -1).expand(Z, *mid, idx.shape[1])
    out.view(Z, *mid, -1).scatter_(-1, ix, win.reshape(Z, *mid, -1))
    return out


class _WindowIndex:
    """A batch's window index tensors, on the device: the windows' flat
    cell indices (level 0) and tile indices (each refined level) for a
    slab, and the carry translation between two slabs, computed from the
    batch's starts (n, Z, 2), uploaded once."""

    def __init__(self, starts: np.ndarray, W: int, n: int, bes, Ts,
                 device):
        self.starts = torch.as_tensor(starts, device=device).long()
        self.W, self.n, self.bes, self.Ts = W, n, bes, Ts
        self.device = device

    def _ar(self, k):
        return torch.arange(k, device=self.device)

    def at(self, i: int) -> dict:
        W, n = self.W, self.n
        wy, wz = self.starts[i, :, 0], self.starts[i, :, 1]
        rows = wy[:, None] + self._ar(W)
        cols = wz[:, None] + self._ar(W)
        out = {
            "cells": (rows[:, :, None] * n + cols[:, None, :]).reshape(
                len(wy), W * W),
            "pad_j": (wy - 1).clamp(min=0)[:, None] * n + cols,
            "pad_k": rows * n + (wz - 1).clamp(min=0)[:, None],
            "top_j": (wy == 0).view(-1, 1, 1, 1, 1),
            "top_k": (wz == 0).view(-1, 1, 1, 1, 1),
            "tiles": []}
        for ell, (be, T) in enumerate(zip(self.bes, self.Ts), start=1):
            m, wt = 2 ** ell, W * 2 ** ell // be
            ty = (wy * m // be)[:, None] + self._ar(wt)
            tz = (wz * m // be)[:, None] + self._ar(wt)
            out["tiles"].append((ty[:, :, None] * T + tz[:, None, :])
                                .reshape(len(wy), wt * wt))
        return out

    def moves(self, i: int) -> list:
        """Per refined level, (flat source cells (Z, Wl*Wl), valid
        (Z, Wl, Wl)) that translate a window-frame plane from slab i-1's
        window to slab i's: the cells outside the old window are not
        valid (zero fill, exact by the coverage invariant: slab i's
        window covers the refinement of slab i-1)."""
        d = self.starts[i] - self.starts[i - 1]                 # (Z, 2)
        out = []
        for ell in range(1, len(self.bes) + 1):
            m, wl = 2 ** ell, self.W * 2 ** ell
            yy = self._ar(wl)[None] + d[:, :1] * m
            zz = self._ar(wl)[None] + d[:, 1:] * m
            vy, vz = (yy >= 0) & (yy < wl), (zz >= 0) & (zz < wl)
            idx = (yy.clamp(0, wl - 1)[:, :, None] * wl
                   + zz.clamp(0, wl - 1)[:, None, :])
            out.append((idx.reshape(len(d), wl * wl),
                        vy[:, :, None] & vz[:, None, :]))
        return out


def _translate(x, idx, valid):
    """x (Z, *mid, wl, wl) moved by _WindowIndex.moves' (idx, valid)."""
    wl = x.shape[-1]
    g = _crop(x, idx, wl)
    v = valid.view(valid.shape[0], *((1,) * (x.dim() - 3)), wl, wl)
    return torch.where(v, g, torch.zeros((), dtype=x.dtype,
                                         device=x.device))


def _has_fine(r0_rot: np.ndarray) -> np.ndarray:
    """(n,) bool per rotated slab: the slab touches refined levels if it
    has refined cells itself OR the previous slab does (that slab's fine
    tops feed this slab's level-0 xy inputs through refined-below)."""
    any_ref = r0_rot.any(axis=(1, 2))
    out = any_ref.copy()
    out[1:] |= any_ref[:-1]
    return out


def _bc(m):
    """A (Z, a, b) mask against (Z, D, 3, a, b) planes."""
    return m[:, None, None]


def _selector(Z: int, D: int, device):
    """(_slab_gauss_seidel's sel over a batch of Z zones of D directions,
    the child index 1 of every direction)."""
    dirs = torch.arange(Z * D, device=device)

    def sel(plane, cj, ck):
        out = _sel_child(plane.reshape(Z * D, *plane.shape[2:]), dirs, cj,
                         ck)
        return out.reshape(Z, D, *out.shape[1:])
    return sel, torch.ones(Z * D, dtype=torch.int64, device=device)


def _fine_slab(lv_rots, tables, i: int, below, crop=None):
    """The refined levels of base slab i: (their _slab_gauss_seidel
    entries, level by level, and each sub-slab's (cover, refined, slot
    plane, in-block x) for its J).  below[l-1]: the (cover, refined) masks
    under level l's first sub-slab, None under base slab 0; crop(l, sp):
    a window's cut of level l's slot plane, or None for full planes.  The
    finest level's refined mask is all False (build_ctx)."""
    slab, masks = [], []
    for ell, lv in enumerate(lv_rots, start=1):
        m, be = 2 ** ell, lv["kappa"].shape[-1]
        subs, level = [], []
        for s in range(m):
            sp, ox = _slab_slots(lv["slot"], i * m + s, be)
            if crop is not None:
                sp = crop(ell, sp)
            kap = _gather_plane(lv["kappa"], sp, ox)
            mk = _gather_plane(lv["masks"], sp, ox)
            cov, ref = mk[:, 0], mk[:, 1]
            under = below[ell - 1] if s == 0 else level[-1][:2]
            spl = _slab(tables[ell], i * m + s)
            subs.append({
                "sp": spl, "att": _segment_factors(kap[:, None], spl),
                "below": (None if under is None
                          else (_bc(under[0]), _bc(under[1]))),
                "nb_cov_j": _bc(_shift_mask(cov, True, 1)),
                "nb_cov_k": _bc(_shift_mask(cov, True, 2)),
                "nb_ref_j": _bc(_shift_mask(ref, False, 1)),
                "nb_ref_k": _bc(_shift_mask(ref, False, 2))})
            level.append((cov, ref, sp, ox))
        slab.append(subs)
        masks.append(level)
    return slab, masks


def _scatter_fine_j(jbs, est, masks, weight: float) -> None:
    """Each refined level's leaf J of a base slab (est[l][s]) into its
    block accumulators jbs[l-1], in place."""
    for ell, level in enumerate(masks, start=1):
        for s, (cov, ref, sp, ox) in enumerate(level):
            js = weight * torch.sum(torch.where(
                _bc(cov & ~ref), est[ell][s]["j_slab"], 0.0), dim=1)
            _scatter_plane(jbs[ell - 1], sp, ox, js)


def sweep_zone_sparse(k0_rot, r0_rot, lv_rots, tables, has_fine: np.ndarray,
                      window, uvb, weight: float, n_coupling_iters: int,
                      slabs=None):
    """Sweep a batch of Z zones of D directions each over a block-sparse
    L-level grid.

    k0_rot: (Z, n, 3, n, n) rotated base opacity; r0_rot: (Z, n, n, n)
    rotated refinement map; lv_rots[l-1] (levels 1..L-1): dict of
    "kappa" (Z, 3, nb, be, be, be) and "masks" (Z, 2, nb, be, be, be)
    bool (cover, refined; refined all False on the finest level) block
    data rotated within-block (octants.rotate_blocks_to_sweep), and "slot"
    (Z, T, T, T) the rotated tile maps, absent tiles routed to the padding
    block; tables[l]: _batch_tables of level l; has_fine: (n,) bool on the
    host, a slab where some zone of the batch needs the fine levels.
    window: None, or (W, (n, Z, 2) int base-cell starts, multiples of the
    block edge): the coupled stack on each slab's W x W window only
    (_sweep_zone_sparse_windowed).  slabs: the base slabs to sweep, all
    when None (a range of them from the UVB at its first: profile_step's
    traces of covered and of skipped slabs).
    Returns (j0 (Z, n, 3, n, n), [(Z, 3, nb, be, be, be) J blocks per
    refined level]), in the rotated frame and block layout.
    """
    if window is not None and lv_rots:
        return _sweep_zone_sparse_windowed(
            k0_rot, r0_rot, lv_rots, tables, has_fine, window, uvb, weight,
            n_coupling_iters, slabs)
    L = 1 + len(lv_rots)
    Z, n = k0_rot.shape[:2]
    D = tables[0]["len1"].shape[2]
    dtype, device = k0_rot.dtype, k0_rot.device
    uvb = torch.as_tensor(uvb, dtype=dtype, device=device).reshape(
        1, 1, 3, 1, 1)
    sel, ones = _selector(Z, D, device)

    sizes = [n * 2 ** ell for ell in range(L)]
    uvb_j = [uvb.expand(Z, D, 3, 1, a) for a in sizes]
    uvb_k = [uvb.expand(Z, D, 3, a, 1) for a in sizes]
    carry = [uvb.expand(Z, D, 3, a, a) for a in sizes]
    # the (cover, refined) masks under each refined level's first
    # sub-slab: None under slab 0
    below = [None] * (L - 1)
    no_cover = [torch.zeros((Z, a, a), dtype=torch.bool, device=device)
                for a in sizes]
    nb_ref0 = {"j": _shift_mask(r0_rot, False, 2),
               "k": _shift_mask(r0_rot, False, 3)}
    j0 = torch.empty_like(k0_rot)
    jbs = [torch.zeros_like(lv["kappa"]) for lv in lv_rots]
    for i in slabs or range(n):
        sp0 = _slab(tables[0], i)
        sub0 = {"sp": sp0, "att": _segment_factors(k0_rot[:, i][:, None],
                                                   sp0),
                "below": None if i == 0 else (None, _bc(r0_rot[:, i - 1])),
                "nb_cov_j": None, "nb_cov_k": None,
                "nb_ref_j": _bc(nb_ref0["j"][:, i]),
                "nb_ref_k": _bc(nb_ref0["k"][:, i])}
        leaf0 = _bc(~r0_rot[:, i])
        if L == 1 or not has_fine[i]:
            est = _slab_gauss_seidel(carry[:1], [[sub0]], 1, uvb_j[:1],
                                     uvb_k[:1], sel, ones)
            j0[:, i] = weight * torch.sum(torch.where(
                leaf0, est[0][0]["j_slab"], 0.0), dim=1)
            carry = [est[0][0]["top"]]
            for ell in range(1, L):
                carry.append(_prolong_plane(carry[-1]))
            below = [(c, c) for c in no_cover[1:]]
            continue
        fine, masks = _fine_slab(lv_rots, tables, i, below)
        est = _slab_gauss_seidel(carry, [[sub0]] + fine, n_coupling_iters,
                                 uvb_j, uvb_k, sel, ones)
        j0[:, i] = weight * torch.sum(torch.where(
            leaf0, est[0][0]["j_slab"], 0.0), dim=1)
        _scatter_fine_j(jbs, est, masks, weight)
        below = [level[-1][:2] for level in masks]
        carry = [est[ell][2 ** ell - 1]["top"] for ell in range(L)]
    return j0, jbs


def _sweep_zone_sparse_windowed(k0_rot, r0_rot, lv_rots, tables,
                                has_fine: np.ndarray, window, uvb,
                                weight: float, n_coupling_iters: int,
                                slabs=None):
    """sweep_zone_sparse with the coupled fine-level stack confined to each
    slab's W x W cross-section window (base cells) holding all of its
    refinement: the clustered refinement of real grids, where the
    full-plane stack spends most of its area on empty fine levels.  Exact
    parity with the full-plane stack by construction:

    * P1 -- a plain (uncoupled) level-0 full-plane pass.  Shifts run one
      way in the rotated frame, so P1 is exact upwind of the window; its
      chained intermediates are the window's upwind-edge boundary lines,
      per segment (_slab_gauss_seidel's pair-of-pads form).
    * the windowed L-level stack -- the same math on cropped planes (the
      window aligned to the block grid, so every parent/child factor of 2
      holds).
    * P2 -- the plain level-0 full-plane pass again with the window's
      coupled intermediates merged into its side inputs: cells downwind of
      the window see the fine-coupled radiation, the reference's
      coarse-reads-fine contract (transportRoutinesModule.f90:455-558).
      The merged outputs keep the window's values inside, P2's outside.

    window = (W, (n, Z, 2) starts).  Between slabs the window may move; the
    fine carries translate from the previous window into the current one
    with zero fill outside, exact because slab i's window covers the
    refinement of slab i-1 too.
    """
    W, starts = window
    L = 1 + len(lv_rots)
    Z, n = k0_rot.shape[:2]
    D = tables[0]["len1"].shape[2]
    dtype, device = k0_rot.dtype, k0_rot.device
    uvb = torch.as_tensor(uvb, dtype=dtype, device=device).reshape(
        1, 1, 3, 1, 1)
    sel, ones = _selector(Z, D, device)

    wsz = [W * 2 ** ell for ell in range(L)]
    uvb_j_full, uvb_k_full = uvb.expand(Z, D, 3, 1, n), uvb.expand(Z, D, 3,
                                                                   n, 1)
    uvb_j_w = [uvb.expand(Z, D, 3, 1, a) for a in wsz]
    uvb_k_w = [uvb.expand(Z, D, 3, a, 1) for a in wsz]
    top0 = uvb.expand(Z, D, 3, n, n)
    fine = [uvb.expand(Z, D, 3, a, a) for a in wsz[1:]]
    fine_masks = [None] * (L - 1)
    no_cover = [torch.zeros((Z, a, a), dtype=torch.bool, device=device)
                for a in wsz[1:]]
    bes = [lv["kappa"].shape[-1] for lv in lv_rots]
    Ts = [lv["slot"].shape[1] for lv in lv_rots]
    index = _WindowIndex(starts, W, n, bes, Ts, device)
    j0 = torch.empty_like(k0_rot)
    jbs = [torch.zeros_like(lv["kappa"]) for lv in lv_rots]

    def crop_slots(ell, sp):
        wt = wsz[ell] // bes[ell - 1]
        return sp.reshape(Z, -1).gather(1, idx["tiles"][ell - 1]).view(
            Z, wt, wt)

    idx = None
    for i in slabs or range(n):
        if idx is None or np.any(starts[i] != starts[i - 1]):
            if idx is not None and fine_masks[0] is not None:
                for e, (mv, valid) in enumerate(index.moves(i)):
                    fine[e] = _translate(fine[e], mv, valid)
                    fine_masks[e] = tuple(_translate(x, mv, valid)
                                          for x in fine_masks[e])
            idx = index.at(i)
        cells = idx["cells"]
        sp0 = _slab(tables[0], i)
        att0 = _segment_factors(k0_rot[:, i][:, None], sp0)
        sub0 = {"sp": sp0, "att": att0, "below": None, "nb_cov_j": None,
                "nb_cov_k": None, "nb_ref_j": None, "nb_ref_k": None}
        leaf0 = _bc(~r0_rot[:, i])
        # P1: the plain level-0 pass, its intermediates kept
        est1 = _slab_gauss_seidel([top0], [[sub0]], 1, [uvb_j_full],
                                  [uvb_k_full], sel, ones,
                                  level0_segs=True)[0][0]
        if not has_fine[i]:
            j0[:, i] = weight * torch.sum(torch.where(
                leaf0, est1["j_slab"], 0.0), dim=1)
            top0 = est1["top"]
            t = _crop(top0, cells, W)
            for e in range(L - 1):
                t = _prolong_plane(t)
                fine[e] = t
                fine_masks[e] = (no_cover[e], no_cover[e])
            continue

        # the windowed stack: level 0 cropped, its upwind boundary lines
        # P1's segments at the window's edge
        r0_w = _crop(r0_rot[:, i], cells, W)
        sub0_w = {"sp": sp0,
                  "att": _segment_factors(
                      _crop(k0_rot[:, i], cells, W)[:, None], sp0),
                  "below": (None if i == 0 else
                            (None, _bc(_crop(r0_rot[:, i - 1], cells, W)))),
                  "nb_cov_j": None, "nb_cov_k": None,
                  "nb_ref_j": _bc(_shift_mask(r0_w, False, 1)),
                  "nb_ref_k": _bc(_shift_mask(r0_w, False, 2))}

        def pad_j(seg):
            g = seg.reshape(Z, D, 3, n * n).gather(
                -1, idx["pad_j"].view(Z, 1, 1, W).expand(Z, D, 3, W))
            return torch.where(idx["top_j"], uvb_j_w[0],
                               g.view(Z, D, 3, 1, W))

        def pad_k(seg):
            g = seg.reshape(Z, D, 3, n * n).gather(
                -1, idx["pad_k"].view(Z, 1, 1, W).expand(Z, D, 3, W))
            return torch.where(idx["top_k"], uvb_k_w[0],
                               g.view(Z, D, 3, W, 1))

        s1, s2 = est1["seg1"], est1["seg2"]
        uvb_j = [(pad_j(s1), pad_j(s2))] + uvb_j_w[1:]
        uvb_k = [(pad_k(s1), pad_k(s2))] + uvb_k_w[1:]
        fine_slab, masks = _fine_slab(lv_rots, tables, i, fine_masks,
                                      crop_slots)
        est = _slab_gauss_seidel([_crop(top0, cells, W)] + fine,
                                 [[sub0_w]] + fine_slab, n_coupling_iters,
                                 uvb_j, uvb_k, sel, ones, level0_segs=True)

        # P2: the full-plane level-0 pass with the window's coupled
        # intermediates merged into its side inputs
        w0 = est[0][0]

        def merged(shift, pad, seg):
            return lambda x: shift(_paste(x, w0[seg], cells), pad)
        est2 = _segment_outputs(
            top0, att0, sp0,
            (merged(_shift_j, uvb_j_full, "seg1"),
             merged(_shift_j, uvb_j_full, "seg2")),
            (merged(_shift_k, uvb_k_full, "seg1"),
             merged(_shift_k, uvb_k_full, "seg2")))
        j0_full = weight * torch.sum(torch.where(leaf0, est2["j_slab"], 0.0),
                                     dim=1)
        j0_win = weight * torch.sum(torch.where(_bc(~r0_w), w0["j_slab"],
                                                0.0), dim=1)
        j0[:, i] = _paste(j0_full, j0_win, cells)
        top0 = _paste(est2["top"], w0["top"], cells)
        _scatter_fine_j(jbs, est, masks, weight)
        fine = [est[ell][2 ** ell - 1]["top"] for ell in range(1, L)]
        fine_masks = [level[-1][:2] for level in masks]
    return j0, jbs


def compute_window(state: SparseMLState, margin: int = 2):
    """The static refinement window of the windowed sparse sweep, PER
    SLAB: for every octant rotation and every rotated slab, the smallest
    be-aligned W x W cross-section holding the refinement of that slab AND
    of its upwind neighbor (the carry feeds forward, so window_i must
    cover ref(slab i-1) too), or None when refinement spans most of the
    grid (the full-plane stack is then cheaper).  W is the largest
    single-slab box, not the bounding box of all clumps.

    Returns (W, {izone: (n, 2) int32 starts}): starts tile-aligned, with
    >= `margin` uncovered base cells around the coverage, forward- and
    backward-filled through refinement-free slabs (their value does not
    matter, the skip branch runs, but a stable one spares carry
    translation).  NumPy on the host, the JAX package's function."""
    r0 = state.refined0.detach().cpu().numpy().astype(bool)
    if not r0.any() or state.n_levels < 2:
        return None
    be = state.be
    half = be // 2
    n = state.n

    def slab_boxes(rot):
        """Per-slab tile-aligned (lo_y, hi_y, lo_z, hi_z) of
        rot[i] | rot[i-1]; empty slabs -> (0, 0, 0, 0)."""
        u = rot.copy()
        u[1:] |= rot[:-1]
        out = []
        for axis in (1, 2):
            anyx = u.any(axis=2 if axis == 1 else 1)        # (n, n)
            has = anyx.any(axis=1)
            lo = np.where(has, anyx.argmax(axis=1), 0)
            hi = np.where(has, n - anyx[:, ::-1].argmax(axis=1), 0)
            lo = lo // half * half
            hi = -(-hi // half) * half
            out += [lo, hi]
        return out[0], out[1], out[2], out[3], u.any(axis=(1, 2))

    zone_rots = {iz: octants.rotate_to_sweep(r0, iz) for iz in range(1, 25)}
    ext = 0
    for rot in zone_rots.values():
        lo_y, hi_y, lo_z, hi_z, has = slab_boxes(rot)
        if has.any():
            ext = max(ext, int((hi_y - lo_y)[has].max()),
                      int((hi_z - lo_z)[has].max()))
    W = ext + 2 * margin + be
    W = min(n, -(-W // be) * be)
    if W >= n:
        return None

    starts = {}
    for iz, rot in zone_rots.items():
        lo_y, hi_y, lo_z, hi_z, has = slab_boxes(rot)
        st = np.zeros((n, 2), np.int32)
        for col, (lo, hi) in enumerate(((lo_y, hi_y), (lo_z, hi_z))):
            s = (lo - margin) // be * be
            s = np.clip(s, 0, n - W)
            assert bool(np.all((s[has] <= lo[has])
                               & (s[has] + W >= hi[has])))
            # forward/backward fill through refinement-free slabs
            idxs = np.where(has, np.arange(n), -1)
            idxs = np.maximum.accumulate(idxs)
            first = int(np.argmax(has))
            idxs = np.where(idxs < 0, first, idxs)
            st[:, col] = s[idxs]
        starts[iz] = st
    return W, starts


def build_ctx(k0, lv_kappas, state: SparseMLState):
    """The sweep's context: (base opacity (n, n, n, 3), refined0, per
    refined level (kappa (3, nb, be, be, be), (cover, refined) stacked
    (2, nb, be, be, be) with refined all False on the finest level, the
    slot map on the host with absent tiles routed to the padding
    block))."""
    L = state.n_levels
    levels = []
    for ell in range(1, L):
        lv = state.levels[ell - 1]
        ref = lv.refined if ell < L - 1 else torch.zeros_like(lv.cover)
        slot = lv.slot.detach().cpu().numpy().astype(np.int64)
        levels.append((lv_kappas[ell - 1], torch.stack([lv.cover, ref]),
                       np.where(slot < 0, lv.n_blocks - 1, slot)))
    return torch.movedim(k0, 0, -1), state.refined0, tuple(levels)


def _sparse_zone_bytes(state: SparseMLState, W: int | None):
    """zone_bytes(ndir, itemsize) of a zone of the sparse sweep: its
    rotated base opacity and J (3 bands each) and base masks, its rotated
    blocks' opacity, J and masks with the slot maps, and the planes of a
    slab (two coupling passes' segment outputs and the attenuation
    factors, ~16 planes a sub-slab; level 0 at full width for P1 and P2,
    every level at the window's cross-section, the translations' index
    planes)."""
    n, L = state.n, state.n_levels
    width = n if W is None else W

    def count(ndir: int, itemsize: int) -> int:
        total = n ** 3 * (2 * 3 * itemsize + 3)
        planes = 2 * n * n + width * width
        for ell, lv in enumerate(state.levels, start=1):
            total += lv.n_blocks * lv.be ** 3 * (2 * 3 * itemsize + 2)
            total += lv.slot.numel() * 8
            wl = width * 2 ** ell
            planes += 2 ** ell * wl * wl
            total += wl * wl * 9
        return total + 16 * ndir * 3 * itemsize * planes
    return count


def batch_inputs(batch, ctx, window, cell_size: float) -> tuple:
    """sweep_zone_sparse's inputs for a batch of zones (MLZoneBatch) from
    build_ctx's context and a window (None, or compute_window's): the
    rotated base opacity and refinement map, each level's rotated blocks
    and slot maps, the templates, the slabs that need the fine levels
    (on the host) and the batch's window."""
    k0_l, refined0, lv_ctx = ctx
    izones = [z.izone for z in batch]
    dtype, device = k0_l.dtype, k0_l.device
    lv_rots = []
    for kap, masks, slot in lv_ctx:
        lv_rots.append({
            "kappa": torch.stack([octants.rotate_blocks_to_sweep(kap, iz)
                                  for iz in izones]),
            "masks": torch.stack([octants.rotate_blocks_to_sweep(masks, iz)
                                  for iz in izones]),
            "slot": torch.as_tensor(np.stack([
                np.ascontiguousarray(octants.rotate_to_sweep(slot, iz))
                for iz in izones]), device=device)})
    r0_np = refined0.detach().cpu().numpy().astype(bool)
    has_fine = np.stack([_has_fine(octants.rotate_to_sweep(r0_np, iz))
                         for iz in izones]).any(axis=0)
    win = None
    if window is not None:
        win = (window[0], np.ascontiguousarray(np.stack(
            [window[1][iz] for iz in izones], axis=1)))
    return (_rotate_in([k0_l], izones, True)[0],
            _rotate_in([refined0], izones, False)[0], lv_rots,
            [_batch_tables(batch, ell, cell_size, dtype, device)
             for ell in range(1 + len(lv_ctx))], has_fine, win)


def diffuse_sweep_sparse(k0, lv_kappas, state: SparseMLState,
                         plan: MLSweepPlan, uvb, cell_size: float,
                         n_coupling_iters: int = N_COUPLING_ITERS,
                         window="auto"):
    """The full block-sparse L-level sweep.

    k0: (3, n, n, n) base opacity; lv_kappas[l-1]: (3, nb, be, be, be)
    block opacity of level l.  Returns (J0 (3, n, n, n), [J blocks
    (3, nb, be, be, be) per refined level]), on leaf cells only (propagate
    with amr_sparse.sync_restriction_sparse).

    window: "auto" computes the refinement window (compute_window; None,
    the full-plane stack, where refinement spans the grid); None the
    full-plane stack; or a precomputed (W, {izone: starts})."""
    L = plan.n_levels
    if state.n_levels != L or len(lv_kappas) != L - 1:
        raise ValueError(f"a {state.n_levels}-level state and "
                         f"{len(lv_kappas)} block opacities for a {L}-level "
                         f"plan")
    if isinstance(window, str) and window == "auto":
        window = compute_window(state)
    n = state.n
    ctx = build_ctx(k0, lv_kappas, state)
    j0_acc = torch.zeros_like(ctx[0])
    jb_acc = [torch.zeros_like(k) for k in lv_kappas]
    for batch in zone_batches(plan, (n, n, n), k0.dtype, k0.device,
                              _sparse_zone_bytes(
                                  state, None if window is None
                                  else window[0])):
        for c0, cb in zone_contributions(batch, ctx, window, uvb, cell_size,
                                         plan.weight, n_coupling_iters):
            j0_acc = j0_acc + c0
            jb_acc = [a + c for a, c in zip(jb_acc, cb)]
    return torch.movedim(j0_acc, -1, 0), jb_acc


def zone_contributions(batch, ctx, window, uvb, cell_size: float,
                       weight: float, n_coupling_iters: int):
    """Each zone's contribution to the sweep, (J0 (n, n, n, 3), [J blocks
    of each refined level]) rotated back, in the batch's order: one
    sweep_zone_sparse over the batch of zones (MLZoneBatch, build_ctx's
    context)."""
    inputs = batch_inputs(batch, ctx, window, cell_size)
    j0, jbs = sweep_zone_sparse(*inputs, uvb, weight, n_coupling_iters)
    del inputs
    for z, zone in enumerate(batch):
        iz = zone.izone
        yield (octants.rotate_from_sweep(torch.movedim(j0[z], 1, -1), iz),
               [octants.rotate_blocks_from_sweep(jb[z], iz) for jb in jbs])
