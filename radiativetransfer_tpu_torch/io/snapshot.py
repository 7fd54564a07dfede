"""Snapshot write / restart, uniform and nested (AMR) grids.

Counterpart of the JAX package's io/snapshot.py.  The reference writes
per-iteration HDF4 files `cellArrayNNNN.h4` holding the depth-first
(space-filling-curve) flattening of octree leaves: base-grid dims + 1-D
arrays level, HI, HeI, HeII, temperature, density [, vel, abun2]
(writeIonization, equiSources.f90:4797-4912; restart readLatestIonization
:4738-4795).

Both packages keep the same logical schema in NumPy `.npz` containers:
dense single-level grids store the fields directly in C order -- which IS
the depth-first leaf order for an unrefined grid -- and nested (two-level
and L-level) AMR states flatten their leaves through the SFC codec
(io/sfc.py) under the JAX package's keys, so a snapshot written by one package restarts the
other.  Restart re-inflates onto a freshly
built grid with the same species clamping as the reference, in torch on
the state's device.  A non-equilibrium run adds its 9-species state
(`species_extra`, `read_species`; a nested run one set a level, under
`species{l}_*`) under keys that the field readers do not read, so an
equilibrium run restarts from it too.  L-level states (write_snapshot_ml)
flatten every level's leaves the same way, and block-sparse ones
(write_snapshot_sparse) too, their block structure recorded as each
level's block origins.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import re

import numpy as np
import torch

from ..core.chemistry_noneq import SPECIES, SpeciesState
from ..core.state import FieldState
from . import sfc


def snapshot_name(itime: int, directory: str = ".") -> str:
    """cellArrayNNNN equivalent (equiSources.f90:4838-4843)."""
    return os.path.join(directory, f"cellArray{itime:04d}.npz")


# the cellArray fields, snapshot key -> FieldState field
_FIELDS = (("HI", "HI"), ("HeI", "HeI"), ("HeII", "HeII"),
           ("temperature", "tgas"), ("density", "rho"), ("abun2", "abun2"))


def _clamp_species(state: FieldState, HI, HeI, HeII) -> tuple:
    """The reference's restart clamps (:4765-4773) in the state's dtype on
    its device: species non-negative, HI <= nH, HeI+HeII rescaled into
    <= nHe."""
    HI = torch.minimum(torch.clamp(HI, min=0.0), state.nh)
    HeI = torch.clamp(HeI, min=0.0)
    HeII = torch.clamp(HeII, min=0.0)
    tot = HeI + HeII
    nhe = state.nhe
    scale = torch.where(tot > nhe,
                        nhe / torch.where(tot > 0, tot, torch.ones_like(tot)),
                        torch.ones_like(tot))
    return HI, HeI * scale, HeII * scale


def _stack_host(state: FieldState) -> np.ndarray:
    """The cellArray fields (and vel's three components) of one level in
    float32 on the host, one copy off the device: (fields, *grid)."""
    cols = [getattr(state, name) for _, name in _FIELDS]
    if state.vel is not None:
        cols += list(state.vel)
    return torch.stack(cols).detach().to(torch.float32).cpu().numpy()


def write_snapshot(path: str, state: FieldState, itime: int,
                   physical_box_size: float, extra: dict | None = None) -> None:
    """Write a snapshot with the reference's cellArray field set (float32,
    C order; the fields leave the device in one copy)."""
    shape = state.shape
    host = _stack_host(state)
    host = host.reshape(len(host), -1)
    data = {
        "base_grid_size": np.array(shape, np.int32),
        "itime": np.int32(itime),
        "physical_box_size": np.float64(physical_box_size),
        "level": np.zeros(int(np.prod(shape)), np.int32),
    }
    data.update({key: host[i] for i, (key, _) in enumerate(_FIELDS)})
    if state.vel is not None:
        # the reference writes velx/vely/velz for kinematics runs
        # (writeIonization, equiSources.f90:4869-4890)
        data["velx"], data["vely"], data["velz"] = host[len(_FIELDS):]
    if extra:
        data.update(extra)
    np.savez_compressed(path, **data)


def read_snapshot(path: str, state: FieldState) -> tuple[FieldState, int]:
    """Re-inflate a snapshot onto an existing state (restart path,
    readLatestIonization, equiSources.f90:4738-4795).

    Applies the reference's clamps in the state's dtype on its device:
    species non-negative, HI <= nH, and HeI+HeII rescaled into <= nHe
    (:4765-4773).
    """
    dtype, device = state.HI.dtype, state.HI.device

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    with np.load(path) as f:
        shape = tuple(int(s) for s in f["base_grid_size"])
        if shape != state.shape:
            raise ValueError(f"snapshot grid {shape} != state grid {state.shape}")
        itime = int(f["itime"])
        HI = t(f["HI"].reshape(shape))
        HeI = t(f["HeI"].reshape(shape))
        HeII = t(f["HeII"].reshape(shape))
        tgas = t(f["temperature"].reshape(shape))
        vel = state.vel
        if "velx" in f:
            vel = t(np.stack([f["velx"].reshape(shape),
                              f["vely"].reshape(shape),
                              f["velz"].reshape(shape)]))

    HI, HeI, HeII = _clamp_species(state, HI, HeI, HeII)
    return dataclasses.replace(state, HI=HI, HeI=HeI, HeII=HeII,
                               tgas=tgas, vel=vel), itime


def write_snapshot_amr(path: str, state, itime: int,
                       physical_box_size: float) -> None:
    """Write a two-level AMRState in depth-first cellArray leaf order
    (writeIonization on an AMR octree, equiSources.f90:4797-4912), with the
    JAX package's keys: the refinement map `refined`, each leaf's `level`
    and the leaf streams in float32."""
    n = state.n
    refined_np = state.refined.detach().cpu().numpy().astype(np.uint8)
    enum = sfc.enumerate_leaves(n, n, n, [refined_np])
    leaves = sfc.gather(enum, [_stack_host(state.base),
                               _stack_host(state.fine)])
    data = {
        "base_grid_size": np.array(state.base.shape, np.int32),
        "itime": np.int32(itime),
        "physical_box_size": np.float64(physical_box_size),
        "refined": refined_np,
        "level": enum["level"].astype(np.int32),
    }
    data.update({key: leaves[i] for i, (key, _) in enumerate(_FIELDS)})
    if state.base.vel is not None:
        # the reference writes kinematics for every leaf
        # (writeIonization, equiSources.f90:4869-4890)
        data["velx"], data["vely"], data["velz"] = leaves[len(_FIELDS):]
    np.savez_compressed(path, **data)


def read_snapshot_amr(path: str, state) -> tuple["object", int]:
    """Re-inflate a two-level snapshot onto an existing AMRState (restart),
    with the reference's species clamps on each level; fine positions
    outside the refined region are filled by prolongation.  A snapshot
    whose refinement map differs from the state's raises ValueError."""
    from ..core import amr as amr_mod
    n = state.n
    dtype, device = state.base.HI.dtype, state.base.HI.device
    with np.load(path) as f:
        itime = int(f["itime"])
        refined_np = f["refined"]
        if not np.array_equal(refined_np.astype(bool),
                              state.refined.detach().cpu().numpy()):
            raise ValueError("snapshot refinement map differs from the state "
                             "(the reference rebuilds structure from the "
                             "input grid and asserts the cell count, "
                             "equiSources.f90:1124-1127)")
        enum = sfc.enumerate_leaves(n, n, n, [refined_np])
        shapes = [state.base.shape, state.fine.shape]
        keys = ["HI", "HeI", "HeII", "temperature"]
        with_vel = "velx" in f and state.base.vel is not None
        if with_vel:
            keys += ["velx", "vely", "velz"]
        levels = {k: sfc.scatter_leaves(enum, f[k].astype(np.float64), shapes)
                  for k in keys}

    def level(st, lv):
        def t(key):
            return torch.as_tensor(levels[key][lv], dtype=dtype,
                                   device=device)
        HI, HeI, HeII = _clamp_species(st, t("HI"), t("HeI"), t("HeII"))
        vel = (torch.stack([t(k) for k in ("velx", "vely", "velz")])
               if with_vel else st.vel)
        return dataclasses.replace(st, HI=HI, HeI=HeI, HeII=HeII,
                                   tgas=t("temperature"), vel=vel)

    base, fine = level(state.base, 0), level(state.fine, 1)
    # fine positions without leaves got zeros from the scatter: fill by
    # prolongation so the dense fine fields stay everywhere defined
    rf = amr_mod.prolong_mask(state.refined)
    fine = dataclasses.replace(fine, **{
        k: torch.where(rf, getattr(fine, k), amr_mod.prolong(getattr(base, k)))
        for k in ("HI", "HeI", "HeII", "tgas")})
    state = dataclasses.replace(state, base=base, fine=fine)
    return amr_mod.sync_restriction(state), itime


def write_snapshot_ml(path: str, state, itime: int,
                      physical_box_size: float,
                      extra: dict | None = None) -> None:
    """Write an L-level MultiLevelState in depth-first cellArray leaf order
    (the SFC codec enumerates any depth), with the JAX package's keys: the
    depth `n_levels`, each leaf's `level`, the leaf streams in float32 and
    the refinement maps `refined_{l}` as uint8; `extra` (a noneq run's
    species_extra of each level) is written beside them."""
    n = state.n
    refined_np = [r.detach().cpu().numpy().astype(np.uint8)
                  for r in state.refined]
    enum = sfc.enumerate_leaves(n, n, n, refined_np)
    leaves = sfc.gather(enum, [_stack_host(lv) for lv in state.levels])
    data = {
        "base_grid_size": np.array(state.levels[0].shape, np.int32),
        "itime": np.int32(itime),
        "physical_box_size": np.float64(physical_box_size),
        "n_levels": np.int32(state.n_levels),
        "level": enum["level"].astype(np.int32),
    }
    data.update({key: leaves[i] for i, (key, _) in enumerate(_FIELDS)})
    if state.levels[0].vel is not None:
        # kinematics for every leaf (writeIonization,
        # equiSources.f90:4869-4890)
        data["velx"], data["vely"], data["velz"] = leaves[len(_FIELDS):]
    for ell, r in enumerate(refined_np):
        data[f"refined_{ell}"] = r
    if extra:
        data.update(extra)
    np.savez_compressed(path, **data)


def read_snapshot_ml(path: str, state) -> tuple["object", int]:
    """Re-inflate an L-level snapshot onto an existing MultiLevelState
    (restart), with the reference's species clamps on each level; the
    positions of each refined level outside its parents' refined cells
    are filled by prolongation from the level below.  A snapshot of
    another depth, or whose refinement maps differ from the state's,
    raises ValueError."""
    from ..core import amr as amr_mod
    n, L = state.n, state.n_levels
    dtype, device = state.levels[0].HI.dtype, state.levels[0].HI.device
    with np.load(path) as f:
        itime = int(f["itime"])
        if int(f["n_levels"]) != L:
            raise ValueError("snapshot depth differs from the state")
        refined_np = [f[f"refined_{ell}"] for ell in range(L - 1)]
        for r_snap, r_st in zip(refined_np, state.refined):
            if not np.array_equal(r_snap.astype(bool),
                                  r_st.detach().cpu().numpy()):
                raise ValueError(
                    "snapshot refinement maps differ from the state "
                    "(structure is rebuilt from the input grid, "
                    "equiSources.f90:1124-1127)")
        enum = sfc.enumerate_leaves(n, n, n, refined_np)
        shapes = [lv.shape for lv in state.levels]
        keys = ["HI", "HeI", "HeII", "temperature"]
        with_vel = "velx" in f and state.levels[0].vel is not None
        if with_vel:
            keys += ["velx", "vely", "velz"]
        levels = {k: sfc.scatter_leaves(enum, f[k].astype(np.float64), shapes)
                  for k in keys}

    def level(st, lv):
        def t(key):
            return torch.as_tensor(levels[key][lv], dtype=dtype,
                                   device=device)
        HI, HeI, HeII = _clamp_species(st, t("HI"), t("HeI"), t("HeII"))
        vel = (torch.stack([t(k) for k in ("velx", "vely", "velz")])
               if with_vel else st.vel)
        return dataclasses.replace(st, HI=HI, HeI=HeI, HeII=HeII,
                                   tgas=t("temperature"), vel=vel)

    new_levels = [level(st, ell) for ell, st in enumerate(state.levels)]
    # non-leaf positions got zeros from the scatter: fill by prolongation
    # so the dense fields stay everywhere defined
    for ell in range(1, L):
        cov = amr_mod.prolong(state.refined[ell - 1])
        prev, cur = new_levels[ell - 1], new_levels[ell]
        new_levels[ell] = dataclasses.replace(cur, **{
            k: torch.where(cov, getattr(cur, k),
                           amr_mod.prolong(getattr(prev, k)))
            for k in ("HI", "HeI", "HeII", "tgas")})
    state = amr_mod.MultiLevelState(levels=tuple(new_levels),
                                    refined=state.refined)
    return amr_mod.sync_restriction_multi(state), itime


def _sparse_leaf_maps(state) -> list[np.ndarray]:
    """The dense uint8 refinement bitmaps that the SFC codec enumerates,
    rebuilt on the host from block storage (the deepest one needed lives
    at level L-2)."""
    from ..core import amr_sparse
    refined = [state.refined0.detach().cpu().numpy().astype(np.uint8)]
    for lv in state.levels[:-1]:
        refined.append(amr_sparse.unblockify_like(
            lv, lv.refined, fill=False).astype(np.uint8))
    return refined


def _sparse_block_index(state, level: np.ndarray, src: np.ndarray) -> list:
    """Per level, (the leaves' positions in SFC order, their flat indices
    into the level's storage: the dense base, or the blocks); a leaf in
    an absent block raises ValueError."""
    n = state.n
    out = []
    for ell in range(state.n_levels):
        sel = np.nonzero(level == ell)[0]
        s = src[sel]
        if ell == 0:
            out.append((sel, s))
            continue
        lv = state.levels[ell - 1]
        be = lv.be
        n_l = n * 2 ** ell
        i, rem = np.divmod(s, n_l * n_l)
        j, k = np.divmod(rem, n_l)
        t = lv.slot.detach().cpu().numpy()[i // be, j // be, k // be]
        if np.any(t < 0):
            raise ValueError("SFC leaf maps to an absent block "
                             "(inconsistent sparse structure)")
        off = ((i % be) * be + j % be) * be + k % be
        out.append((sel, t.astype(np.int64) * be ** 3 + off))
    return out


def _real_origins(state, ell: int) -> np.ndarray:
    """Level ell's block origins, the padding blocks' left out."""
    o = state.levels[ell - 1].origin.detach().cpu().numpy().astype(np.int32)
    return o[o[:, 0] < state.n * 2 ** ell]


def _bitmap_digest(bitmap: np.ndarray) -> np.ndarray:
    """Stable 20-byte digest of a refinement bitmap (sha1 of packed bits)."""
    packed = np.packbits(np.asarray(bitmap, np.uint8).reshape(-1))
    return np.frombuffer(hashlib.sha1(packed.tobytes()).digest(), np.uint8)


def write_snapshot_sparse(path: str, state, itime: int,
                          physical_box_size: float,
                          extra: dict | None = None) -> None:
    """Write a block-sparse SparseMLState in depth-first cellArray leaf
    order at O(leaves) file size (writeIonization at any octree depth,
    equiSources.f90:4797-4912), with the JAX package's keys: the depth
    `n_levels`, `storage` "sparse", each leaf's `level`, the leaf streams in
    float32, each refined level's real block origins `origin_{l}` (not
    dense bitmaps) and each bitmap's digest `refined_digest_{l}`; `extra`
    is written between the two."""
    n = state.n
    refined = _sparse_leaf_maps(state)
    enum = sfc.enumerate_leaves(n, n, n, refined)
    level = enum["level"]
    gather = _sparse_block_index(state, level, enum["src"])
    fields = [state.base] + [lv.fields for lv in state.levels]
    leaves = None
    for (sel, idx), f in zip(gather, fields):
        host = _stack_host(f)
        host = host.reshape(len(host), -1)
        if leaves is None:
            leaves = np.zeros((len(host), level.shape[0]), np.float32)
        leaves[:, sel] = host[:, idx]
    data = {
        "base_grid_size": np.array(state.base.shape, np.int32),
        "itime": np.int32(itime),
        "physical_box_size": np.float64(physical_box_size),
        "n_levels": np.int32(state.n_levels),
        "storage": np.str_("sparse"),
        "level": level.astype(np.int32),
    }
    data.update({key: leaves[i] for i, (key, _) in enumerate(_FIELDS)})
    if state.base.vel is not None:
        data["velx"], data["vely"], data["velz"] = leaves[len(_FIELDS):]
    for ell in range(1, state.n_levels):
        # real blocks only: padding blocks are a runtime matter
        data[f"origin_{ell}"] = _real_origins(state, ell)
    if extra:
        data.update(extra)
    # a bitmap change confined inside existing tiles can keep the block set
    # AND the leaf count while changing the SFC enumeration: the digests
    # let the restart reject it (equiSources.f90:1124-1127)
    for ell, r in enumerate(refined):
        data[f"refined_digest_{ell}"] = _bitmap_digest(r)
    np.savez_compressed(path, **data)


def read_snapshot_sparse(path: str, state) -> tuple["object", int]:
    """Re-inflate a block-sparse snapshot onto an existing SparseMLState
    (restart): the structure is rebuilt from the input grid, as the
    reference does, and checked against the file's depth, block origins,
    bitmap digests and leaf count (equiSources.f90:1124-1127; a mismatch
    raises ValueError); the leaf values go into the blocks with the
    reference's species clamps on each level, then the restriction
    syncs the parents."""
    from ..core import amr_sparse
    n = state.n
    with np.load(path) as f:
        itime = int(f["itime"])
        if int(f["n_levels"]) != state.n_levels:
            raise ValueError("snapshot depth differs from the state")
        for ell in range(1, state.n_levels):
            if not np.array_equal(f[f"origin_{ell}"],
                                  _real_origins(state, ell)):
                raise ValueError(
                    "snapshot block structure differs from the state "
                    "(structure is rebuilt from the input grid, "
                    "equiSources.f90:1124-1127)")
        refined = _sparse_leaf_maps(state)
        for ell, r in enumerate(refined):
            key = f"refined_digest_{ell}"
            if key in f and not np.array_equal(f[key], _bitmap_digest(r)):
                raise ValueError(
                    f"snapshot refinement bitmap differs from the state at "
                    f"level {ell}: the SFC leaf enumeration would put values "
                    f"into the wrong cells (structure is rebuilt from the "
                    f"input grid, equiSources.f90:1124-1127)")
        enum = sfc.enumerate_leaves(n, n, n, refined)
        level = enum["level"]
        if level.shape[0] != f["HI"].shape[0]:
            raise ValueError("snapshot leaf count differs from the state")
        gather = _sparse_block_index(state, level, enum["src"])
        keys = ["HI", "HeI", "HeII", "temperature"]
        with_vel = "velx" in f and state.base.vel is not None
        if with_vel:
            keys += ["velx", "vely", "velz"]
        vals = {k: f[k].astype(np.float64) for k in keys}

    def level_fields(st, sel, idx):
        dtype, device = st.HI.dtype, st.HI.device

        def put(cur, key):
            a = cur.detach().cpu().numpy().astype(np.float64).reshape(-1)
            a[idx] = vals[key][sel]
            return torch.as_tensor(a.reshape(cur.shape), dtype=dtype,
                                   device=device)
        HI, HeI, HeII = _clamp_species(st, put(st.HI, "HI"),
                                       put(st.HeI, "HeI"),
                                       put(st.HeII, "HeII"))
        vel = (torch.stack([put(st.vel[i], "vel" + c)
                            for i, c in enumerate("xyz")])
               if with_vel else st.vel)
        return dataclasses.replace(st, HI=HI, HeI=HeI, HeII=HeII,
                                   tgas=put(st.tgas, "temperature"), vel=vel)

    base = level_fields(state.base, *gather[0])
    levels = tuple(dataclasses.replace(lv, fields=level_fields(lv.fields,
                                                                *g))
                   for lv, g in zip(state.levels, gather[1:]))
    state = dataclasses.replace(state, base=base, levels=levels)
    return amr_sparse.sync_restriction_sparse(state), itime


# the non-equilibrium prognostic state: chemistry_noneq.SpeciesState's fields
SPECIES_FIELDS = (*SPECIES, "eint")


def species_extra(species, prefix: str = "species0") -> dict:
    """Snapshot payload for a chemistry_noneq.SpeciesState, at the run's
    full precision and grid shape: the 9-species abundances and internal
    energy are PROGNOSTIC, so a restart continues them instead of
    re-deriving them from equilibrium (the reference's restart restores
    every prognostic field, equiSources.f90:1071-1167).  The keys are the
    JAX package's, `{prefix}_{field}`: a nested run calls it once a level
    with prefix f"species{l}"."""
    host = torch.stack([getattr(species, k) for k in SPECIES_FIELDS])
    host = host.detach().cpu().numpy()
    return {f"{prefix}_{k}": host[i] for i, k in enumerate(SPECIES_FIELDS)}


def read_species(path: str, template):
    """The 9-species state of a snapshot, in the template's dtype on its
    device, or None when the snapshot carries none (an equilibrium run
    wrote it).  template: a chemistry_noneq.SpeciesState on the run's grid,
    or a tuple of one a level for a nested run (keys `species{l}_*`),
    which returns a tuple.

    A snapshot with some of the species arrays, of fewer levels than the
    template, or with arrays of another shape than the grid's, raises
    ValueError: the restart stops there, it never carries on from a fresh
    equilibrium."""
    single = not isinstance(template, tuple)
    temps = (template,) if single else template
    keys = [[f"species{ell}_{k}" for k in SPECIES_FIELDS]
            for ell in range(len(temps))]
    every = [k for ks in keys for k in ks]
    with np.load(path) as f:
        present = [k for k in every if k in f]
        if not present:
            return None
        if len(present) != len(every):
            missing = sorted(set(every) - set(present))
            raise ValueError(f"{path}: species state incomplete, missing "
                             f"{missing}")
        arrays = [{k: f[key] for k, key in zip(SPECIES_FIELDS, ks)}
                  for ks in keys]
    out = []
    for ell, (t, arr) in enumerate(zip(temps, arrays)):
        shape = tuple(t.HI.shape)
        for k, a in arr.items():
            if a.shape != shape:
                raise ValueError(f"{path}: species{ell}_{k} has shape "
                                 f"{a.shape}, the grid is {shape}")
        out.append(SpeciesState(**{
            k: torch.as_tensor(a, dtype=t.HI.dtype, device=t.HI.device)
            for k, a in arr.items()}))
    return out[0] if single else tuple(out)


def latest_snapshot(directory: str = ".") -> str | None:
    """Most recent cellArrayNNNN snapshot in a directory."""
    best, best_i = None, -1
    for name in os.listdir(directory):
        m = re.fullmatch(r"cellArray(\d{4})\.npz", name)
        if m and int(m.group(1)) > best_i:
            best, best_i = os.path.join(directory, name), int(m.group(1))
    return best


def itime_from_name(path: str) -> int:
    """Iteration counter parsed from the filename digits
    (equiSources.f90:1079-1080)."""
    m = re.search(r"(\d{4})\.(npz|h4)$", path)
    if not m:
        raise ValueError(f"no iteration digits in {path!r}")
    return int(m.group(1))


class TimeLog:
    """Append-only neutral-fraction log, the reference's `time` file
    (equiSources.f90:1833-1836)."""

    def __init__(self, path: str = "time"):
        self.path = path

    def append(self, itime: int, neutral_fraction: float) -> None:
        with open(self.path, "a") as fh:
            fh.write(f"itime ={itime:5d}{neutral_fraction:18.10f}\n")

    def restart_marker(self, itime: int) -> None:
        with open(self.path, "a") as fh:
            fh.write(f"itime ={itime:5d}\n")
