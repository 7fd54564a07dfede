"""Block-sparse L-level AMR storage: memory proportional to leaves.

Counterpart of the JAX package's core/amr_sparse.py.  The reference's
fully-threaded octree costs memory proportional to the leaf count
(zoneType, definitionsModule.f90:163-180); the dense per-level form
(core/amr.py::MultiLevelState) costs (n*2^l)^3 per level: 10.4 GB of
float32 fields for the 128^3 production base with two refined levels.
This module stores every refined level as a list of BLOCKS:

* level 0 stays dense (n^3) -- it is always fully covered;
* level l >= 1 is a set of blocks of `be`^3 level-l cells (be/2 parent
  cells a side); a block exists wherever any parent cell in its tile is
  refined, so memory follows the refined volume up to tile granularity;
* a dense tile -> slot volume per level, (n*2^l/be)^3 int32, gives O(1)
  random access for the sweep's slab gathers;
* the LAST slot of every level is an all-zero padding block (cover False,
  origin out of range): gathers through absent tiles read it, and
  restriction writes from it drop.

Every tensor lives on one explicit device.  What the JAX package computes
on the host in NumPy (block structure, ingestion, blockify) stays NumPy
here, and field data moves to the device once, by exact gathers.
Restriction sums a parent's eight children in the order core/amr.py's
`restrict` does, so a sparse state restricts bit for bit as the dense one.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..constants import MH, MHE, PSI
from .amr import MultiLevelState, enforce_balance
from .state import FieldState, GridGeometry, make_state

# FieldState entries carried per level (everything; Jmean and vel are
# (3, ...))
_FIELD_NAMES = [f.name for f in dataclasses.fields(FieldState)]


def _present_names(fs: FieldState) -> list[str]:
    """Field names with data (the optional vel may be None)."""
    return [n for n in _FIELD_NAMES if getattr(fs, n) is not None]


@dataclasses.dataclass
class SparseLevel:
    """One refined level stored as blocks.

    fields: FieldState of (nb, be, be, be) tensors (Jmean and vel
    (3, nb, be, be, be)); slot nb-1 is the zero padding block.
    slot: (T, T, T) int32, T = n*2^l / be; -1 where no block exists.
    origin: (nb, 3) int32 block origins in level-l cell units (the padding
    block's is out of range, so its restriction writes drop).
    cover: (nb, be, be, be) bool -- the cell exists (its parent is refined).
    refined: the same shape -- the cell is refined into level l+1 (all
    False on the finest level).
    """
    fields: FieldState
    slot: torch.Tensor
    origin: torch.Tensor
    cover: torch.Tensor
    refined: torch.Tensor

    @property
    def n_blocks(self) -> int:
        return self.cover.shape[0]

    @property
    def be(self) -> int:
        return self.cover.shape[-1]

    def pad_mask(self, n_l: int) -> torch.Tensor:
        """(nb,) bool: the padding blocks, whose origin is out of the
        level's range n_l."""
        return self.origin[:, 0] >= n_l


@dataclasses.dataclass
class SparseMLState:
    """L-level nested state with block-sparse refined levels.

    base and refined0 are dense on (n, n, n); levels[l-1] holds level l.
    The refinement maps are properly nested and 2:1 face-balanced
    (amr.enforce_balance), as the sweep's adjacent-level coupling needs.
    """
    base: FieldState
    refined0: torch.Tensor
    levels: tuple

    @property
    def n_levels(self) -> int:
        return 1 + len(self.levels)

    @property
    def n(self) -> int:
        return self.base.rho.shape[0]

    @property
    def be(self) -> int:
        return self.levels[0].be if self.levels else 8

    def n_leaves(self) -> int:
        total = int((~self.refined0).sum())
        for lv in self.levels:
            total += int((lv.cover & ~lv.refined).sum())
        return total

    def memory_bytes(self) -> int:
        """Bytes of every tensor of the state (the JAX package's count of
        its pytree leaves)."""
        tensors = [getattr(self.base, k) for k in _present_names(self.base)]
        tensors.append(self.refined0)
        for lv in self.levels:
            tensors += [getattr(lv.fields, k)
                        for k in _present_names(lv.fields)]
            tensors += [lv.slot, lv.origin, lv.cover, lv.refined]
        return sum(t.numel() * t.element_size() for t in tensors)

    @classmethod
    def from_numpy(cls, arrays: dict, *, dtype: torch.dtype,
                   device: torch.device | str) -> "SparseMLState":
        """State from {'base': fields, 'refined0': bitmap, 'levels':
        [{'fields', 'slot', 'origin', 'cover', 'refined'}, ...]}, the
        fields as FieldState.from_numpy takes them (e.g. a JAX
        SparseMLState converted array by array with np.asarray).  The
        arrays are copied."""
        def level(d):
            return SparseLevel(
                fields=FieldState.from_numpy(d["fields"], dtype=dtype,
                                             device=device),
                slot=torch.as_tensor(np.array(d["slot"], np.int32),
                                     device=device),
                origin=torch.as_tensor(np.array(d["origin"], np.int32),
                                       device=device),
                cover=torch.as_tensor(np.array(d["cover"], bool),
                                      device=device),
                refined=torch.as_tensor(np.array(d["refined"], bool),
                                        device=device))
        return cls(base=FieldState.from_numpy(arrays["base"], dtype=dtype,
                                              device=device),
                   refined0=torch.as_tensor(np.array(arrays["refined0"],
                                                     bool), device=device),
                   levels=tuple(level(d) for d in arrays["levels"]))

    def to_numpy(self) -> dict:
        """The from_numpy layout, as NumPy arrays."""
        def host(t):
            return t.detach().cpu().numpy()
        return {"base": self.base.to_numpy(),
                "refined0": host(self.refined0),
                "levels": [{"fields": lv.fields.to_numpy(),
                            "slot": host(lv.slot), "origin": host(lv.origin),
                            "cover": host(lv.cover),
                            "refined": host(lv.refined)}
                           for lv in self.levels]}


def flat_lookup(slot_map: torch.Tensor, c: torch.Tensor, be: int):
    """Block-storage flat index of level cells c (..., 3) int64: (index
    into the (nb*be^3,) flattened block data, exists bool).  Absent tiles
    give a negative index that callers must guard; out-of-range cells read
    a clamped tile, so callers bound-check c where it can leave the
    domain."""
    t = slot_map[c[..., 0] // be, c[..., 1] // be, c[..., 2] // be].long()
    off = ((c[..., 0] % be) * be + c[..., 1] % be) * be + c[..., 2] % be
    return t * be ** 3 + off, t >= 0


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _prolong_np(x: np.ndarray) -> np.ndarray:
    return np.repeat(np.repeat(np.repeat(x, 2, -3), 2, -2), 2, -1)


def _tiles_of(mask: np.ndarray, T: int, w: int):
    """(tiles (nb_real, 3), slot (T,T,T) int32) of the tiles of `mask`
    ((T*w)^3 bool) that hold any True cell."""
    tiles = np.argwhere(mask.reshape(T, w, T, w, T, w).any(axis=(1, 3, 5)))
    slot = np.full((T, T, T), -1, np.int32)
    slot[tiles[:, 0], tiles[:, 1], tiles[:, 2]] = np.arange(len(tiles),
                                                            dtype=np.int32)
    return tiles, slot


def _block3(x3: np.ndarray, tiles: np.ndarray, be: int) -> np.ndarray:
    """Dense (n_l,n_l,n_l) -> (nb, be, be, be) blocks of `tiles`, with the
    zero padding block last."""
    T = x3.shape[0] // be
    t = x3.reshape(T, be, T, be, T, be).transpose(0, 2, 4, 1, 3, 5)
    picked = t[tiles[:, 0], tiles[:, 1], tiles[:, 2]]
    return np.concatenate([picked, np.zeros((1, be, be, be), x3.dtype)])


def _blockify_np(x: np.ndarray, tiles: np.ndarray, be: int) -> np.ndarray:
    if x.ndim == 3:
        return _block3(x, tiles, be)
    return np.stack([_block3(x[i], tiles, be) for i in range(x.shape[0])])


def sparse_from_dense(ml: MultiLevelState, be: int = 8) -> SparseMLState:
    """A dense MultiLevelState in block-sparse storage, on its device.

    Block tiles are chosen over the dense cover mask; uncovered cells
    inside a block keep the dense level's (prolonged) values, so the sweep
    reads what the dense path reads even where masks discard it."""
    L, n = ml.n_levels, ml.n
    device = ml.levels[0].rho.device
    refined = [_host(r).astype(bool) for r in ml.refined]
    cover = [np.ones((n, n, n), bool)]
    for r in refined:
        cover.append(_prolong_np(r & cover[-1]))
    levels = []
    for ell in range(1, L):
        n_l = n * 2 ** ell
        if n_l % be:
            raise ValueError(f"block edge {be} must divide level size {n_l}")
        T = n_l // be
        cov = cover[ell]
        ref = refined[ell] & cov if ell < L - 1 else np.zeros_like(cov)
        tiles, slot = _tiles_of(cov, T, be)
        origin = np.concatenate([tiles * be, [[n_l, n_l, n_l]]])
        st = ml.levels[ell]
        fields = FieldState(**{
            name: torch.as_tensor(_blockify_np(_host(getattr(st, name)),
                                               tiles, be), device=device)
            for name in _present_names(st)})
        levels.append(SparseLevel(
            fields=fields,
            slot=torch.as_tensor(slot, device=device),
            origin=torch.as_tensor(origin.astype(np.int32), device=device),
            cover=torch.as_tensor(_block3(cov, tiles, be), device=device),
            refined=torch.as_tensor(_block3(ref, tiles, be),
                                    device=device)))
    return SparseMLState(
        base=ml.levels[0],
        refined0=(torch.as_tensor(refined[0], device=device) if refined
                  else torch.zeros((n, n, n), dtype=torch.bool,
                                   device=device)),
        levels=tuple(levels))


def dense_from_sparse(sp: SparseMLState) -> MultiLevelState:
    """The inverse of sparse_from_dense, on the state's device (for parity
    checks and snapshot interop): uncovered cells prolong from the parent
    level, make_multilevel_state's fill."""
    device = sp.base.rho.device
    levels = [sp.base]
    refined = [sp.refined0] if sp.n_levels > 1 else []
    prev = {k: _host(getattr(sp.base, k)) for k in _present_names(sp.base)}
    for ell, lv in enumerate(sp.levels, start=1):
        fields = {}
        for name in _present_names(lv.fields):
            fields[name] = unblockify_like(lv, getattr(lv.fields, name),
                                           fill=_prolong_np(prev[name]))
        levels.append(FieldState(**{
            k: torch.as_tensor(v, device=device) for k, v in fields.items()}))
        if ell < sp.n_levels - 1:
            refined.append(torch.as_tensor(
                unblockify_like(lv, lv.refined, fill=False), device=device))
        prev = fields
    return MultiLevelState(levels=tuple(levels), refined=tuple(refined))


def make_sparse_state(base: FieldState, refined, be: int = 8,
                      level_hook=None) -> SparseMLState:
    """A block-sparse L-level state built WITHOUT densifying field data,
    on the base's device.

    base: dense (n,n,n) FieldState; refined: the L-1 dense bool maps
    (NumPy, properly nested and face-balanced).  Refined-level fields fill
    from the parent level block by block, the reference's refine-time
    parent copy (equiSources.f90:1892-1896).

    level_hook(ell, lv) -> SparseLevel | None: applied to each level as it
    is built, BEFORE the next level fills from it (the ingestion path,
    sparse_from_level_lists, scatters the real field data there, so deeper
    levels inherit data-filled values).
    """
    n = base.rho.shape[0]
    device = base.rho.device
    L = 1 + len(refined)
    refined = [_host(r).astype(bool) for r in refined]
    levels = []
    parent_cover = np.ones((n, n, n), bool)
    parent_level = None                     # None -> the dense base
    off = np.stack(np.meshgrid(np.arange(be), np.arange(be), np.arange(be),
                               indexing="ij"), axis=-1)[None]
    for ell in range(1, L):
        n_l = n * 2 ** ell
        if n_l % be:
            raise ValueError(f"block edge {be} must divide level size {n_l}")
        T = n_l // be
        pr = refined[ell - 1] & parent_cover
        tiles, slot = _tiles_of(pr, T, be // 2)
        nb = len(tiles) + 1
        origin = np.concatenate([tiles * be, [[n_l, n_l, n_l]]])
        cc = tiles[:, None, None, None, :] * be + off   # (nb-1, be,be,be, 3)
        pc = cc // 2
        px, py, pz = pc[..., 0], pc[..., 1], pc[..., 2]
        zero_block = np.zeros((1, be, be, be), bool)
        cover_blocks = np.concatenate([pr[px, py, pz], zero_block])
        if ell < L - 1:
            ref_blocks = np.concatenate(
                [refined[ell][cc[..., 0], cc[..., 1], cc[..., 2]]
                 & cover_blocks[:-1], zero_block])
        else:
            ref_blocks = np.zeros((nb, be, be, be), bool)

        if parent_level is None:
            src = base
            idx = torch.as_tensor((px * n + py) * n + pz, device=device)
        else:
            src = parent_level.fields
            pbe = parent_level.be
            pslot = _host(parent_level.slot)
            pt = pslot[px // pbe, py // pbe, pz // pbe].astype(np.int64)
            pt = np.where(pt < 0, parent_level.n_blocks - 1, pt)
            idx = torch.as_tensor(pt * pbe ** 3 + ((px % pbe) * pbe
                                                   + py % pbe) * pbe
                                  + pz % pbe, device=device)

        def gather(x, idx=idx):
            lead = x.shape[:-4] if parent_level is not None else x.shape[:-3]
            g = x.reshape(*lead, -1)[..., idx]
            pad = torch.zeros((*lead, 1, be, be, be), dtype=x.dtype,
                              device=device)
            return torch.cat([g, pad], dim=len(lead))

        lv = SparseLevel(
            fields=FieldState(**{name: gather(getattr(src, name))
                                 for name in _present_names(src)}),
            slot=torch.as_tensor(slot, device=device),
            origin=torch.as_tensor(origin.astype(np.int32), device=device),
            cover=torch.as_tensor(cover_blocks, device=device),
            refined=torch.as_tensor(ref_blocks, device=device))
        if level_hook is not None:
            lv = level_hook(ell, lv) or lv
        levels.append(lv)
        parent_level = lv
        if ell < L - 1:     # the finest cover volume is never needed
            parent_cover = _prolong_np(pr)
    return SparseMLState(
        base=base,
        refined0=(torch.as_tensor(refined[0], device=device) if refined
                  else torch.zeros((n, n, n), dtype=torch.bool,
                                   device=device)),
        levels=tuple(levels))


def sparse_from_level_lists(level_lists, read_metals: bool, be: int = 8,
                            max_depth: int | None = None,
                            dtype: torch.dtype = torch.float32,
                            smooth_metals: bool = True, *,
                            device: torch.device | str = "cuda"):
    """SparseMLState on `device` from ingested per-level cell lists, at
    O(leaves) memory: the production ingestion path (the reference inserts
    every input cell straight into the octree, placeCellProjectWithVelocity,
    equiSources.f90:1870-1974).  Only the refinement BITMAPS are dense, on
    the host (bool, 512^3 = 134 MB at the deepest for a 128^3 base with
    three levels); no refined level is ever allocated densely:

    1. the block structure and the parent fill (make_sparse_state);
    2. the REAL level-l cell values scattered into their block slots
       (volume-weighted averages where deeper-than-kept cells land in one
       kept cell, as grid_io.levels_to_dense does), in float64 on the host;
    3. the fine-leaf restriction propagated down
       (sync_restriction_sparse), so parents of refined cells hold their
       children's average as the dense ingestion leaves them.

    Returns (SparseMLState, GridGeometry).
    """
    from ..io import grid_io
    level_lists, box = grid_io.normalize_coordinates(level_lists)
    n = round(level_lists[0].ncell ** (1.0 / 3.0))
    geom = GridGeometry(n, n, n, box)
    depth = min(len(level_lists), max_depth or len(level_lists))

    base_dense = grid_io.levels_to_dense(level_lists[:1], n, read_metals)
    abun2 = base_dense["abun2"]
    if read_metals and smooth_metals:
        abun2 = grid_io.smooth_metallicity(abun2)
    vel0 = (np.stack([base_dense["velx"], base_dense["vely"],
                      base_dense["velz"]])
            if "velx" in base_dense else None)
    base = make_state(base_dense["nh"] * MH / PSI, base_dense["tgas"],
                      base_dense["nh"] * base_dense["xneu"], abun2=abun2,
                      dtype=dtype, vel=vel0, device=device)

    refined = []
    for ell in range(1, depth):
        n_par = n * 2 ** (ell - 1)
        r = np.zeros((n_par, n_par, n_par), bool)
        idx = np.clip((level_lists[ell].pos * n_par).astype(int),
                      0, n_par - 1)
        r[idx[:, 0], idx[:, 1], idx[:, 2]] = True
        refined.append(r)
    refined = enforce_balance(refined)
    has_vel = vel0 is not None

    def scatter_hook(ell: int, lv: SparseLevel) -> SparseLevel:
        n_l = n * 2 ** ell
        slot = _host(lv.slot)
        nslots = lv.n_blocks * be ** 3
        lists = (level_lists[ell:] if ell == depth - 1
                 else level_lists[ell:ell + 1])
        cols = ["tgas", "nh", "xneu", "abun2"]
        if has_vel:
            cols += ["velx", "vely", "velz"]
        sums = {k: np.zeros(nslots) for k in cols}
        wsum = np.zeros(nslots)
        for li, ld in enumerate(lists):
            if ld.ncell == 0:
                continue
            c = np.clip((ld.pos * n_l).astype(np.int64), 0, n_l - 1)
            t = slot[c[:, 0] // be, c[:, 1] // be, c[:, 2] // be]
            off = ((c[:, 0] % be) * be + c[:, 1] % be) * be + c[:, 2] % be
            ok = t >= 0     # cells of a deeper absorbed list can fall
            #                 outside every block
            fl = (t.astype(np.int64) * be ** 3 + off)[ok]
            w = 8.0 ** (-li)
            vals = {
                "tgas": 10.0 ** ld.lT.astype(np.float64),
                "nh": 10.0 ** ld.lnH.astype(np.float64),
                "xneu": 10.0 ** ld.lx.astype(np.float64),
                "abun2": (ld.abun[:, 1].astype(np.float64)
                          if ld.abun is not None
                          else np.full(ld.ncell, 0.02)),
            }
            if has_vel:
                v = (ld.vel.astype(np.float64) if ld.vel is not None
                     else np.zeros((ld.ncell, 3)))
                vals.update(velx=v[:, 0], vely=v[:, 1], velz=v[:, 2])
            for k in cols:
                sums[k] += np.bincount(fl, w * vals[k][ok], minlength=nslots)
            wsum += np.bincount(fl, np.full(len(fl), w), minlength=nslots)
        got = wsum > 0
        norm = np.where(got, wsum, 1.0)
        avg = {k: sums[k] / norm for k in cols}
        bshape = (lv.n_blocks, be, be, be)

        def put(cur, new_flat, lead=()):
            cur = _host(cur).astype(np.float64).reshape(*lead, -1)
            return torch.as_tensor(
                np.where(got, new_flat, cur).reshape(*lead, *bshape),
                dtype=dtype, device=device)

        f = lv.fields
        rho = avg["nh"] * MH / PSI
        upd = dict(
            rho=put(f.rho, rho),
            tgas=put(f.tgas, avg["tgas"]),
            HI=put(f.HI, avg["nh"] * avg["xneu"]),
            # ingested helium starts fully neutral where data landed
            # (placeCellProjectWithVelocity, equiSources.f90:1941-1943)
            HeI=put(f.HeI, (1.0 - PSI) * rho / MHE),
            HeII=put(f.HeII, np.zeros(nslots)),
            abun2=put(f.abun2, avg["abun2"]))
        if has_vel:
            upd["vel"] = put(f.vel, np.stack([avg["velx"], avg["vely"],
                                              avg["velz"]]), lead=(3,))
        return dataclasses.replace(lv, fields=dataclasses.replace(f, **upd))

    state = make_sparse_state(base, refined, be=be, level_hook=scatter_hook)
    return sync_restriction_sparse(state), geom


def blockify_like(lv: SparseLevel, x) -> torch.Tensor:
    """A dense level array (..., n_l, n_l, n_l), NumPy or a tensor, as
    blocks (..., nb, be, be, be) in lv's slot layout (the padding block
    zero), on lv's device."""
    be = lv.be
    slot = _host(lv.slot)
    tiles = np.argwhere(slot >= 0)
    tiles = tiles[np.argsort(slot[tiles[:, 0], tiles[:, 1], tiles[:, 2]])]
    return torch.as_tensor(_blockify_np(_host(x), tiles, be),
                           device=lv.slot.device)


def unblockify_like(lv: SparseLevel, blocks, fill=0.0) -> np.ndarray:
    """The inverse of blockify_like, on the host: (..., nb, be, be, be)
    blocks to a dense (..., n_l, n_l, n_l) NumPy array whose absent tiles
    take `fill` (a scalar, or a dense array of that shape)."""
    be = lv.be
    blocks = _host(blocks)
    slot = _host(lv.slot)
    T = slot.shape[0]
    n_l = T * be
    tiles = np.argwhere(slot >= 0)
    slots = slot[tiles[:, 0], tiles[:, 1], tiles[:, 2]]
    lead = blocks.shape[:-4]
    out = np.empty(lead + (T, T, T, be, be, be), blocks.dtype)
    if np.ndim(fill):
        out[...] = np.asarray(fill).reshape(
            lead + (T, be, T, be, T, be)).transpose(
            *range(len(lead)), *(len(lead) + a for a in (0, 2, 4, 1, 3, 5)))
    else:
        out[...] = fill
    out[..., tiles[:, 0], tiles[:, 1], tiles[:, 2], :, :, :] = \
        blocks[..., slots, :, :, :]
    k = len(lead)
    return out.transpose(*range(k), *(k + a for a in (0, 3, 1, 4, 2, 5))
                         ).reshape(lead + (n_l, n_l, n_l))


def _restrict_blocks(x: torch.Tensor) -> torch.Tensor:
    """(..., nb, be, be, be) -> (..., nb, be/2, be/2, be/2): the 8
    children summed one after another in their i,j,k order, times 1/8 (as
    amr.restrict)."""
    h = x.shape[-1] // 2
    v = x.reshape(*x.shape[:-3], h, 2, h, 2, h, 2)
    total = v[..., :, 0, :, 0, :, 0]
    for a, b, c in ((0, 0, 1), (0, 1, 0), (0, 1, 1), (1, 0, 0), (1, 0, 1),
                    (1, 1, 0), (1, 1, 1)):
        total = total + v[..., :, a, :, b, :, c]
    return total * 0.125


def _tree_map(fn, tree, *rest):
    """fn over the tensors of a dict, a dataclass of tensors (None entries
    kept) or a tensor, with `rest` of the same structure."""
    if torch.is_tensor(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _tree_map(fn, getattr(tree, f.name),
                              *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)
            if getattr(tree, f.name) is not None})
    if tree is None:
        return None
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def _masked_write(dst: torch.Tensor, src: torch.Tensor, dst_idx, src_idx,
                  lead: int) -> torch.Tensor:
    """dst with its flat cells dst_idx set to src's flat cells src_idx,
    per leading component (lead: the count of leading axes)."""
    out = dst.clone()
    shape = dst.shape[:lead]
    out.view(*shape, -1)[..., dst_idx] = src.to(dst.dtype).reshape(
        *shape, -1)[..., src_idx]
    return out


def sync_restriction_tree(state: SparseMLState, base_tree, level_trees):
    """Propagate fine-leaf restrictions down through every level of any
    family of tensors that shares the state's block geometry: base_tree's
    tensors are (n, n, n) (or leading-stacked (c, n, n, n)), those of
    level_trees[l-1] (nb, be, be, be) (or (c, nb, be, be, be)); a tree is a
    tensor, a dict or a dataclass of them.  Refined parents end up holding
    their children's average -- the engine of sync_restriction_sparse, so
    that other per-cell state (the noneq species) restricts with the same
    geometry.  Returns (base_tree, tuple of level trees).

    A parent cell lies under exactly one block of the level above, so its
    masked write is a plain set, the JAX package's order-independent
    scatter-add and count."""
    n = state.n
    device = state.refined0.device
    trees = list(level_trees)
    for ell in range(state.n_levels - 1, 0, -1):
        lv = state.levels[ell - 1]
        h = lv.be // 2
        rest = _tree_map(_restrict_blocks, trees[ell - 1])
        p0 = lv.origin.long() // 2                             # (nb, 3)
        oy = torch.arange(h, device=device)
        ix = p0[:, 0, None, None, None] + oy[None, :, None, None]
        iy = p0[:, 1, None, None, None] + oy[None, None, :, None]
        iz = p0[:, 2, None, None, None] + oy[None, None, None, :]
        ix, iy, iz = torch.broadcast_tensors(ix, iy, iz)
        n_par = n * 2 ** (ell - 1)
        in_range = ix < n_par       # padding origins are out of range
        ixc, iyc, izc = (t.clamp(0, n_par - 1) for t in (ix, iy, iz))
        if ell == 1:
            mask = state.refined0[ixc, iyc, izc] & in_range
            flat = (ixc * n + iyc) * n + izc
        else:
            par = state.levels[ell - 2]
            idx, exists = flat_lookup(par.slot,
                                      torch.stack([ixc, iyc, izc], -1),
                                      par.be)
            idx_c = idx.clamp(0, par.n_blocks * par.be ** 3 - 1)
            mask = exists & par.refined.reshape(-1)[idx_c] & in_range
            flat = idx_c
        src_idx = mask.reshape(-1).nonzero().squeeze(1)
        dst_idx = flat.reshape(-1)[src_idx]
        target = base_tree if ell == 1 else trees[ell - 2]
        written = _tree_map(
            lambda b, r: _masked_write(
                b, r, dst_idx, src_idx,
                b.dim() - (3 if ell == 1 else 4)), target, rest)
        if ell == 1:
            base_tree = written
        else:
            trees[ell - 2] = written
    return base_tree, tuple(trees)


def sync_restriction_sparse(state: SparseMLState) -> SparseMLState:
    """Propagate fine-leaf restrictions down through every level (the
    sparse counterpart of amr.sync_restriction_multi), vel too."""
    names = _present_names(state.base)
    base_tree = {k: getattr(state.base, k) for k in names}
    level_trees = [{k: getattr(lv.fields, k) for k in names}
                   for lv in state.levels]
    base_tree, level_trees = sync_restriction_tree(state, base_tree,
                                                   level_trees)
    return dataclasses.replace(
        state, base=dataclasses.replace(state.base, **base_tree),
        levels=tuple(dataclasses.replace(
            lv, fields=dataclasses.replace(lv.fields, **t))
            for lv, t in zip(state.levels, level_trees)))


def zero_pad_blocks(tree, pad: torch.Tensor):
    """Every (..., nb, be, be, be) tensor of a tree (a FieldState, a dict
    or a dataclass of tensors) with its padding blocks (pad: (nb,) bool)
    set to 0: chemistry on a padding block's zero fields gives NaN or
    garbage, and absent tiles gather that block."""
    def zero(x):
        if x.dim() < 4:
            return x
        m = pad.reshape((1,) * (x.dim() - 4) + (-1, 1, 1, 1))
        return torch.where(m, torch.zeros((), dtype=x.dtype,
                                          device=x.device), x)
    return _tree_map(zero, tree)


def pad_blocks(x: torch.Tensor, extra: int) -> torch.Tensor:
    """A (..., nb, be, be, be) tensor with `extra` zero blocks appended on
    its block axis; a tensor of fewer dimensions as it is."""
    if x.dim() < 4 or extra == 0:
        return x
    shape = list(x.shape)
    shape[-4] = extra
    return torch.cat([x, x.new_zeros(shape)], dim=x.dim() - 4)


def pad_blocks_to_multiple(state: SparseMLState,
                           multiple: int) -> SparseMLState:
    """Append zero padding blocks so that every level's block count is a
    multiple of `multiple` (the JAX package's, whose block-axis sharding
    needs the division; parallel/mesh.py::shard_sparse_state).

    The extra blocks carry the contract of the standard final padding
    block: zero fields, cover and refined False, origin out of the level's
    range, so gathers through them read zeros and restriction writes from
    them drop; the slot map never names them (absent tiles route to the
    last block, itself a zero padding block)."""
    if multiple <= 1:
        return state
    levels = []
    for lv in state.levels:
        extra = (-lv.n_blocks) % multiple
        if extra == 0:
            levels.append(lv)
            continue
        n_l = lv.slot.shape[0] * lv.be
        levels.append(SparseLevel(
            fields=_tree_map(lambda x, extra=extra: pad_blocks(x, extra),
                             lv.fields),
            slot=lv.slot,
            origin=torch.cat([lv.origin, torch.full(
                (extra, 3), n_l, dtype=lv.origin.dtype,
                device=lv.origin.device)]),
            cover=pad_blocks(lv.cover, extra),
            refined=pad_blocks(lv.refined, extra)))
    return dataclasses.replace(state, levels=tuple(levels))
