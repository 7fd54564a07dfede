"""Two-level nested (AMR) grid support.

Counterpart of the two-level part of the JAX package's core/amr.py.  The
reference's fully-threaded octree supports arbitrary nesting; the port
keeps the JAX package's LEVEL-DENSE fields: the base level is a dense
(n,n,n) grid, the refinement level a dense (2n,2n,2n) grid valid only
where the parent bitmap is set.  Fully-threaded semantics (cross-level
neighbor access) become restrict / prolong operators and masked shifts.

The fine level is allocated densely over the whole domain (8x the base):
at a 128^3 base its ~20 float32 fields take ~1.3 GB of the card.  The
L-level form (MultiLevelState) is not ported yet: ROADMAP, L-level dense
AMR.
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
