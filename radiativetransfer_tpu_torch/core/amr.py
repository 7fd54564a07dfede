"""Nested (AMR) grid support: two-level and L-level dense storage.

Counterpart of the JAX package's core/amr.py.  The reference's
fully-threaded octree supports arbitrary nesting; the port keeps the JAX
package's LEVEL-DENSE fields: the base level is a dense (n,n,n) grid, the
refinement level a dense (2n,2n,2n) grid valid only where the parent
bitmap is set (AMRState), and in the L-level form (MultiLevelState) level
l a dense (n*2^l)^3 grid.  Fully-threaded semantics (cross-level neighbor
access) become restrict / prolong operators and masked shifts.

Every level is allocated densely over the whole domain (8x the level
below): at a 128^3 base the fine level's ~20 float32 fields take ~1.3 GB
of the card, at a 64^3 base with two refined levels the three take ~1.4
GB.  The block-sparse form (core/amr_sparse.py) stores the refined
levels at memory proportional to their leaves.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..constants import MH, PSI
from .state import FieldState, GridGeometry, make_state

@dataclasses.dataclass
class AMRState:
    """Two-level nested state.

    base: FieldState on (n,n,n); fine: FieldState on (2n,2n,2n);
    refined: (n,n,n) bool tensor -- where the fine level is valid.
    Base cells under refined regions hold the restriction (average) of
    their children, mirroring the reference's parent-copy semantics
    (placeCellProjectWithVelocity, equiSources.f90:1884-1909).
    """
    base: FieldState
    fine: FieldState
    refined: torch.Tensor

    @property
    def n(self) -> int:
        return self.base.rho.shape[0]

    def leaf_mask_base(self) -> torch.Tensor:
        return ~self.refined

    def leaf_mask_fine(self) -> torch.Tensor:
        return prolong_mask(self.refined)

    def n_leaves(self) -> int:
        n_ref = int(self.refined.sum())
        return self.refined.numel() - n_ref + 8 * n_ref

    @classmethod
    def from_numpy(cls, arrays: dict, *, dtype: torch.dtype,
                   device: torch.device | str) -> "AMRState":
        """State from {'base': fields, 'fine': fields, 'refined': bitmap},
        the fields as FieldState.from_numpy takes them (e.g. a JAX
        AMRState converted field by field with np.asarray).  The arrays
        are copied."""
        return cls(
            base=FieldState.from_numpy(arrays["base"], dtype=dtype,
                                       device=device),
            fine=FieldState.from_numpy(arrays["fine"], dtype=dtype,
                                       device=device),
            refined=torch.as_tensor(np.array(arrays["refined"], bool),
                                    device=device))

    def to_numpy(self) -> dict:
        """{'base': ..., 'fine': ...} of FieldState.to_numpy dicts and
        'refined' as a NumPy bool array."""
        return {"base": self.base.to_numpy(), "fine": self.fine.to_numpy(),
                "refined": self.refined.detach().cpu().numpy()}


def restrict(fine_field: torch.Tensor) -> torch.Tensor:
    """Average 2x2x2 children onto the parent grid: the 8 children summed
    one after another in their i,j,k order, times 1/8, on every device.
    (The JAX package's mean sums in that order on the CPU where n is not a
    power of two; where it is, XLA's vectorized reduce pairs the children
    otherwise, a few ulps apart in some cells: ROADMAP section 3.)"""
    n = fine_field.shape[0] // 2
    x = fine_field.reshape(n, 2, n, 2, n, 2)
    total = x[:, 0, :, 0, :, 0]
    for a, b, c in ((0, 0, 1), (0, 1, 0), (0, 1, 1), (1, 0, 0), (1, 0, 1),
                    (1, 1, 0), (1, 1, 1)):
        total = total + x[:, a, :, b, :, c]
    return total * 0.125


def prolong(base_field: torch.Tensor) -> torch.Tensor:
    """Copy parents into their 2x2x2 children (the reference's refine-time
    copy, equiSources.f90:1892-1896)."""
    x = base_field
    for axis in range(3):
        x = torch.repeat_interleave(x, 2, dim=axis)
    return x


def prolong_mask(refined: torch.Tensor) -> torch.Tensor:
    return prolong(refined)


def _per_field(fn, *states: FieldState) -> dict:
    """{field: fn(*values)} over the FieldState fields that are set; a 4-D
    field (Jmean, vel) maps component by component."""
    out = {}
    for f in dataclasses.fields(FieldState):
        xs = [getattr(s, f.name) for s in states]
        if xs[0] is None:
            continue
        out[f.name] = (fn(*xs) if xs[0].dim() == 3 else
                       torch.stack([fn(*(x[i] for x in xs))
                                    for i in range(xs[0].shape[0])]))
    return out


def make_amr_state(base: FieldState, refined,
                   fine: FieldState | None = None) -> AMRState:
    """Build an AMRState; absent fine data is prolonged from the base."""
    refined = torch.as_tensor(refined, device=base.rho.device).to(torch.bool)
    if fine is None:
        fine = dataclasses.replace(base, **_per_field(prolong, base))
    return AMRState(base=base, fine=fine, refined=refined)


def sync_restriction(state: AMRState) -> AMRState:
    """Write the restriction of fine leaves into their base parents so
    base-level fields are consistent for diagnostics and coarse transport."""
    r = state.refined
    base = dataclasses.replace(state.base, **_per_field(
        lambda b, f: torch.where(r, restrict(f), b), state.base, state.fine))
    return dataclasses.replace(state, base=base)


def amr_from_levels(levels, read_metals: bool,
                    dtype: torch.dtype = torch.float32, *,
                    device: torch.device | str = "cuda"
                    ) -> tuple[AMRState, GridGeometry]:
    """Two-level AMRState on `device` from ingested level lists (grid
    construction, equiSources.f90:580-618).

    Level-1 cells define the base grid; level-2 cells mark their parents
    refined and fill the fine grid (deeper levels are conservatively
    averaged onto level 2).  Everything up to the state is NumPy, the same
    code as the JAX package's.
    """
    from ..io import grid_io
    levels, box = grid_io.normalize_coordinates(levels)
    n = round(levels[0].ncell ** (1.0 / 3.0))
    geom = GridGeometry(n, n, n, box)

    base_dense = grid_io.levels_to_dense(levels[:1], n, read_metals)
    abun2 = base_dense["abun2"]
    if read_metals:
        abun2 = grid_io.smooth_metallicity(abun2)
    has_vel = "velx" in base_dense
    vel0 = (np.stack([base_dense["velx"], base_dense["vely"],
                      base_dense["velz"]]) if has_vel else None)
    base = make_state(base_dense["nh"] * MH / PSI, base_dense["tgas"],
                      base_dense["nh"] * base_dense["xneu"],
                      abun2=abun2, dtype=dtype, vel=vel0, device=device)

    refined = np.zeros((n, n, n), bool)
    fine = None
    if len(levels) > 1 and levels[1].ncell > 0:
        fine_dense = grid_io.levels_to_dense(
            [grid_io.LevelData(pos=lv.pos, lT=lv.lT, lnH=lv.lnH, lx=lv.lx,
                               vel=lv.vel, abun=lv.abun)
             for lv in levels[1:]], 2 * n, read_metals)
        idx = np.clip((levels[1].pos * n).astype(int), 0, n - 1)
        refined[idx[:, 0], idx[:, 1], idx[:, 2]] = True
        # fill unrefined fine regions by prolongation so the dense fine
        # fields are everywhere defined
        filled = {}
        ref_f = np.repeat(np.repeat(np.repeat(refined, 2, 0), 2, 1), 2, 2)
        keys = ["nh", "tgas", "xneu", "abun2"]
        if has_vel:
            keys += ["velx", "vely", "velz"]
            for k in ("velx", "vely", "velz"):
                fine_dense.setdefault(k, np.zeros_like(fine_dense["nh"]))
        got_f = fine_dense["nh"] > 0
        for k in keys:
            pb = np.repeat(np.repeat(np.repeat(base_dense.get(
                k, np.zeros_like(base_dense["nh"])), 2, 0), 2, 1), 2, 2)
            mask = (fine_dense[k] > 0 if k not in ("abun2", "velx", "vely",
                                                   "velz") else got_f)
            filled[k] = np.where(ref_f & mask, fine_dense[k], pb)
        velf = (np.stack([filled["velx"], filled["vely"], filled["velz"]])
                if has_vel else None)
        fine = make_state(filled["nh"] * MH / PSI, filled["tgas"],
                          filled["nh"] * filled["xneu"],
                          abun2=filled["abun2"], dtype=dtype, vel=velf,
                          device=device)

    state = make_amr_state(base, torch.as_tensor(refined, device=device),
                           fine)
    return sync_restriction(state), geom


# ---------------------------------------------------------------------------
# L-level nested grids
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MultiLevelState:
    """L-level nested state: level l is a dense FieldState on (n*2^l)^3.

    refined[l] (l = 0..L-2, bool tensors) marks level-l cells refined into
    level l+1; properly nested (refined[l] implies all ancestors refined)
    and 2:1 face-balanced (enforce_balance).  The reference's
    fully-threaded octree (definitionsModule.f90:163-180, insertion
    recursion equiSources.f90:1870-1974) nests arbitrarily deep; this is
    its dense per-level analog.
    """
    levels: tuple
    refined: tuple

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    @property
    def n(self) -> int:
        return self.levels[0].rho.shape[0]

    def cover_masks(self) -> list:
        """cover[l]: the cell exists at level l (all ancestors refined)."""
        return cover_masks(self.refined, self.levels[0].rho.shape,
                           self.levels[0].rho.device)

    def leaf_masks(self) -> list:
        return leaf_masks(self.refined, self.levels[0].rho.shape,
                          self.levels[0].rho.device)

    def n_leaves(self) -> int:
        return sum(int(m.sum()) for m in self.leaf_masks())

    @classmethod
    def from_numpy(cls, arrays: dict, *, dtype: torch.dtype,
                   device: torch.device | str) -> "MultiLevelState":
        """State from {'levels': [fields, ...], 'refined': [bitmap, ...]},
        the fields as FieldState.from_numpy takes them (e.g. a JAX
        MultiLevelState converted field by field with np.asarray).  The
        arrays are copied."""
        return cls(
            levels=tuple(FieldState.from_numpy(lv, dtype=dtype,
                                               device=device)
                         for lv in arrays["levels"]),
            refined=tuple(torch.as_tensor(np.array(r, bool), device=device)
                          for r in arrays["refined"]))

    def to_numpy(self) -> dict:
        """{'levels': [FieldState.to_numpy dicts], 'refined': [NumPy bool
        arrays]}."""
        return {"levels": [lv.to_numpy() for lv in self.levels],
                "refined": [r.detach().cpu().numpy() for r in self.refined]}


def cover_masks(refined, base_shape, device) -> list:
    """cover[l] of refinement maps (bool tensors, levels 0..L-2): the
    level-l cells that exist (all ancestors refined)."""
    masks = [torch.ones(base_shape, dtype=torch.bool, device=device)]
    for r in refined:
        masks.append(prolong(r & masks[-1]))
    return masks


def leaf_masks(refined, base_shape, device) -> list:
    """leaf[l]: the level-l cells that exist and are not refined."""
    cover = cover_masks(refined, base_shape, device)
    return [c & ~refined[ell] if ell < len(refined) else c
            for ell, c in enumerate(cover)]


def _dilate_faces(mask: np.ndarray) -> np.ndarray:
    """6-neighborhood (face) dilation of a bool volume."""
    out = mask.copy()
    for ax in range(3):
        shape = [-1 if a == ax else 1 for a in range(3)]
        idx = np.arange(mask.shape[ax])
        out |= np.roll(mask, 1, ax) & (idx != 0).reshape(shape)
        out |= np.roll(mask, -1, ax) & (idx != mask.shape[ax] - 1
                                        ).reshape(shape)
    return out


def restrict_any(mask: np.ndarray) -> np.ndarray:
    n = mask.shape[0] // 2
    return mask.reshape(n, 2, n, 2, n, 2).any(axis=(1, 3, 5))


def enforce_balance(refined: list[np.ndarray]) -> list[np.ndarray]:
    """Make refinement maps properly nested and 2:1 face-balanced (NumPy).

    Where a level-(l+1) refined cell's face neighbor would jump two levels,
    the neighbor's parent is refined too (its children fill by
    prolongation, the reference's refine-time parent copy,
    equiSources.f90:1892-1896).
    """
    refined = [np.asarray(r, bool).copy() for r in refined]
    for ell in range(len(refined) - 1, 0, -1):
        # proper nesting: a refined cell must itself be covered
        refined[ell - 1] |= restrict_any(refined[ell])
        # 2:1 face balance: face neighbors of refined cells must exist
        refined[ell - 1] |= restrict_any(_dilate_faces(refined[ell]))
    return refined


def check_balance(refined) -> bool:
    refined = [np.asarray(r, bool) for r in refined]
    for ell in range(1, len(refined)):
        need = restrict_any(_dilate_faces(refined[ell]))
        if not np.all(refined[ell - 1] | ~need):
            return False
    return True


def make_multilevel_state(base: FieldState, refined,
                          fines: list[FieldState] | None = None
                          ) -> MultiLevelState:
    """Build an L-level state on the base's device; absent fine data is
    prolonged from the level below."""
    device = base.rho.device
    refined = tuple(torch.as_tensor(r, device=device).to(torch.bool)
                    for r in refined)
    levels = [base]
    for ell in range(len(refined)):
        if fines is not None and ell < len(fines):
            levels.append(fines[ell])
        else:
            prev = levels[-1]
            levels.append(dataclasses.replace(prev,
                                              **_per_field(prolong, prev)))
    return MultiLevelState(levels=tuple(levels), refined=refined)


def sync_restriction_multi(state: MultiLevelState) -> MultiLevelState:
    """Propagate fine-leaf restrictions down to every coarser ancestor,
    finest pair first, the velocity components too."""
    levels = list(state.levels)
    for ell in range(len(levels) - 2, -1, -1):
        r = state.refined[ell]
        levels[ell] = dataclasses.replace(levels[ell], **_per_field(
            lambda b, f, r=r: torch.where(r, restrict(f), b), levels[ell],
            levels[ell + 1]))
    return MultiLevelState(levels=tuple(levels), refined=state.refined)


def multilevel_from_levels(level_lists, read_metals: bool,
                           dtype: torch.dtype = torch.float32, *,
                           device: torch.device | str = "cuda",
                           max_depth: int = 4
                           ) -> tuple[MultiLevelState, GridGeometry]:
    """MultiLevelState on `device` from ingested level lists, keeping every
    level up to max_depth dense (deeper ones conservatively averaged onto
    the deepest kept level), for reference grids of three or more levels
    (equiSources.f90:580-618).  Everything up to the states is NumPy, the
    same code as the JAX package's."""
    from ..io import grid_io
    level_lists, box = grid_io.normalize_coordinates(level_lists)
    n = round(level_lists[0].ncell ** (1.0 / 3.0))
    geom = GridGeometry(n, n, n, box)
    depth = min(len(level_lists), max_depth)

    dense = [grid_io.levels_to_dense(level_lists[:1], n, read_metals)]
    for ell in range(1, depth):
        # the deepest kept level absorbs (averages) anything deeper
        lists = (level_lists[ell:] if ell == depth - 1
                 else level_lists[ell:ell + 1])
        dense.append(grid_io.levels_to_dense(
            [grid_io.LevelData(pos=lv.pos, lT=lv.lT, lnH=lv.lnH, lx=lv.lx,
                               vel=lv.vel, abun=lv.abun) for lv in lists],
            n * 2 ** ell, read_metals))

    refined = []
    for ell in range(1, depth):
        n_par = n * 2 ** (ell - 1)
        r = np.zeros((n_par, n_par, n_par), bool)
        idx = np.clip((level_lists[ell].pos * n_par).astype(int), 0,
                      n_par - 1)
        r[idx[:, 0], idx[:, 1], idx[:, 2]] = True
        refined.append(r)
    refined = enforce_balance(refined)

    has_vel = any("velx" in d for d in dense)
    keys = ["nh", "tgas", "xneu", "abun2"]
    if has_vel:
        keys += ["velx", "vely", "velz"]
    states, filled_prev = [], None
    for ell in range(depth):
        d = dense[ell]
        abun2 = d["abun2"]
        if ell == 0 and read_metals:
            abun2 = grid_io.smooth_metallicity(abun2)
        if has_vel:
            for k in ("velx", "vely", "velz"):
                d.setdefault(k, np.zeros_like(d["nh"]))
        if ell > 0:
            # fill cells without data (unrefined regions and
            # balance-added refinement) by prolongation from the level
            # below; kinematics prolong with the rest
            # (placeCellProjectWithVelocity, equiSources.f90:1870-1974
            # carries vel at every level)
            pb = {k: np.repeat(np.repeat(np.repeat(
                filled_prev[k], 2, 0), 2, 1), 2, 2) for k in keys}
            got = d["nh"] > 0
            d = {k: np.where(d[k] > 0 if k not in ("abun2", "velx", "vely",
                                                   "velz") else got,
                             d[k], pb[k]) for k in pb}
            abun2 = d["abun2"]
        filled_prev = {k: (abun2 if k == "abun2" else d[k]) for k in keys}
        vel = (np.stack([d["velx"], d["vely"], d["velz"]])
               if has_vel else None)
        states.append(make_state(d["nh"] * MH / PSI, d["tgas"],
                                 d["nh"] * d["xneu"], abun2=abun2,
                                 dtype=dtype, vel=vel, device=device))

    state = MultiLevelState(
        levels=tuple(states),
        refined=tuple(torch.as_tensor(r, device=device) for r in refined))
    return sync_restriction_multi(state), geom


def two_level_view(state: MultiLevelState) -> AMRState:
    """The L = 2 special case as an AMRState (the two-level path)."""
    if state.n_levels != 2:
        raise ValueError(f"two_level_view takes 2 levels, not "
                         f"{state.n_levels}")
    return AMRState(base=state.levels[0], fine=state.levels[1],
                    refined=state.refined[0])
