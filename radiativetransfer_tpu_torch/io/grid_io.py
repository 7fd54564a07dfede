"""AMR grid ingestion and format conversion.

Counterpart of the JAX package's io/grid_io.py.  The reference ingests
per-level cell lists (pos, logT, log nH, log xHI [, vel, abun]) from HDF4
grids (equiSources.f90:316-423) built from Fortran unformatted binaries
(bin2hdf4.f90).  This module provides:

* read_fortran_level_binary — reader for the reference's unformatted binary
  level-list format (bin2hdf4.f90:39-87): sequential records with 4-byte
  record markers, single precision data.
* LevelData / read_level_npz / write_level_npz — the same logical schema in
  .npz, the container both packages read and write.
* build_uniform_state — grid construction: coordinate normalization
  (equiSources.f90:448-491), the 2-pass 1-2-1 metallicity smoothing
  (:527-578), and field placement (placeCellProjectWithVelocity :1870-1974)
  for the base level; finer levels are conservatively averaged onto the base
  grid.  Everything up to the state is NumPy, the same code as the JAX
  package's; the state is torch tensors on the caller's device.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np
import torch

from ..constants import KPC, MH, PSI
from ..core.state import FieldState, GridGeometry, make_state


@dataclasses.dataclass
class LevelData:
    """One refinement level's cell list (readLevelType,
    definitionsModule.f90:198-202)."""
    pos: np.ndarray                 # (ncell, 3)
    lT: np.ndarray                  # log10 T
    lnH: np.ndarray                 # log10 nH
    lx: np.ndarray                  # log10 x_HI
    vel: np.ndarray | None = None   # (ncell, 3)
    abun: np.ndarray | None = None  # (ncell, 4)

    @property
    def ncell(self) -> int:
        return self.pos.shape[0]


def _read_record(fh) -> bytes:
    head = fh.read(4)
    if len(head) < 4:
        raise EOFError("truncated Fortran record")
    (n,) = struct.unpack("<i", head)
    data = fh.read(n)
    tail = fh.read(4)
    if struct.unpack("<i", tail)[0] != n:
        raise ValueError("corrupt Fortran record markers")
    return data


def read_fortran_level_binary(path: str, read_metals: bool,
                              read_kinematics: bool) -> list[LevelData]:
    """Reader for the reference's unformatted level-list binaries
    (bin2hdf4.f90:41-87)."""
    levels = []
    with open(path, "rb") as fh:
        (nlevels,) = struct.unpack("<i", _read_record(fh))
        for _ in range(nlevels):
            (ncell,) = struct.unpack("<i", _read_record(fh))

            def arr():
                return np.frombuffer(_read_record(fh), dtype="<f4").copy()

            if ncell == 0:
                # empty trailing levels still carry their (empty) records
                cols = 6 + (4 if read_metals else 0) + (3 if read_kinematics else 0)
                for _ in range(cols):
                    _read_record(fh)
                levels.append(LevelData(pos=np.zeros((0, 3), np.float32),
                                        lT=np.zeros(0), lnH=np.zeros(0),
                                        lx=np.zeros(0)))
                continue
            px, py, pz = arr(), arr(), arr()
            lT, lnH, lx = arr(), arr(), arr()
            abun = None
            vel = None
            if read_metals:
                abun = np.stack([arr(), arr(), arr(), arr()], axis=1)
            if read_kinematics:
                vel = np.stack([arr(), arr(), arr()], axis=1)
            levels.append(LevelData(pos=np.stack([px, py, pz], axis=1),
                                    lT=lT, lnH=lnH, lx=lx, vel=vel, abun=abun))
    while levels and levels[-1].ncell == 0:
        levels.pop()
    return levels


def write_level_npz(path: str, levels: list[LevelData]) -> None:
    """The levels into one uncompressed .npz (zlib took ~10 s of a 128^3
    grid's writing; read_level_npz, and the JAX package's, read either
    form)."""
    data: dict[str, np.ndarray] = {"nlevels": np.int32(len(levels))}
    for i, lv in enumerate(levels):
        data[f"pos_{i}"] = lv.pos
        data[f"lT_{i}"] = lv.lT
        data[f"lnH_{i}"] = lv.lnH
        data[f"lx_{i}"] = lv.lx
        if lv.vel is not None:
            data[f"vel_{i}"] = lv.vel
        if lv.abun is not None:
            data[f"abun_{i}"] = lv.abun
    np.savez(path, **data)


def read_level_npz(path: str) -> list[LevelData]:
    with np.load(path) as f:
        n = int(f["nlevels"])
        return [LevelData(
            pos=f[f"pos_{i}"], lT=f[f"lT_{i}"], lnH=f[f"lnH_{i}"],
            lx=f[f"lx_{i}"],
            vel=f[f"vel_{i}"] if f"vel_{i}" in f else None,
            abun=f[f"abun_{i}"] if f"abun_{i}" in f else None,
        ) for i in range(n)]


def grid_bounds(levels: list[LevelData]) -> tuple[np.ndarray, np.ndarray, float]:
    """(lo, hi) kpc-frame box edges and physical box size [cm]
    (equiSources.f90:448-491: base-level cell centers padded by half a cell)."""
    p = levels[0].pos
    ncell = p.shape[0]
    n = round(ncell ** (1.0 / 3.0))
    if n ** 3 != ncell:
        raise ValueError(f"base grid must be n^3 cells, got {ncell}")
    lo = p.min(axis=0).astype(np.float64)
    hi = p.max(axis=0).astype(np.float64)
    center = 0.5 * (lo + hi)
    half = 0.5 * (hi - lo) * n / (n - 1)
    lo = center - half
    hi = center + half
    return lo, hi, float(abs(hi[0] - lo[0])) * KPC


def normalize_coordinates(levels: list[LevelData]) -> tuple[list[LevelData], float]:
    """Normalize positions to [0,1) and return the physical box size [cm]
    (equiSources.f90:448-491; input coordinates are cell centers in kpc)."""
    lo, hi, box = grid_bounds(levels)
    out = []
    for lv in levels:
        pos = (lv.pos - lo) / (hi - lo)
        out.append(dataclasses.replace(lv, pos=pos.astype(np.float32)))
    return out, box


def smooth_metallicity(field: np.ndarray, npass: int = 2) -> np.ndarray:
    """2x 1-2-1 smoothing along each axis with edge renormalization to match
    the reference's non-periodic kernel (equiSources.f90:537-571)."""
    f = np.asarray(field, np.float64)
    for _ in range(npass):
        for ax in range(3):
            g = 0.5 * f
            up = 0.25 * np.roll(f, -1, axis=ax)
            dn = 0.25 * np.roll(f, 1, axis=ax)
            # the reference drops contributions across the boundary
            sl_lo = [slice(None)] * 3
            sl_lo[ax] = slice(0, 1)
            sl_hi = [slice(None)] * 3
            sl_hi[ax] = slice(-1, None)
            up[tuple(sl_hi)] = 0.0
            dn[tuple(sl_lo)] = 0.0
            f = g + up + dn
    return f


def levels_to_dense(levels: list[LevelData], n: int, read_metals: bool
                    ) -> dict[str, np.ndarray]:
    """Scatter level lists onto the dense base grid.

    Base-level cells land directly; finer-level cells are volume-weighted
    averaged into their base cell (conservative projection; the dense-AMR
    extension keeps them on their own levels).
    """
    fields = {k: np.zeros((n, n, n)) for k in ("tgas", "nh", "xneu", "abun2")}
    has_vel = any(lv.vel is not None for lv in levels if lv.ncell)
    if has_vel:
        for k in ("velx", "vely", "velz"):
            fields[k] = np.zeros((n, n, n))
    wsum = np.zeros((n, n, n))
    for li, lv in enumerate(levels):
        if lv.ncell == 0:
            continue
        idx = np.clip((lv.pos * n).astype(int), 0, n - 1)
        flat = (idx[:, 0] * n + idx[:, 1]) * n + idx[:, 2]
        w = 8.0 ** (-li)
        tgas = 10.0 ** lv.lT.astype(np.float64)
        nh = 10.0 ** lv.lnH.astype(np.float64)
        xneu = 10.0 ** lv.lx.astype(np.float64)
        abun2 = lv.abun[:, 1].astype(np.float64) if lv.abun is not None \
            else np.full(lv.ncell, 0.02)
        cols = [("tgas", tgas), ("nh", nh), ("xneu", xneu),
                ("abun2", abun2)]
        if has_vel:
            v = (lv.vel.astype(np.float64) if lv.vel is not None
                 else np.zeros((lv.ncell, 3)))
            cols += [("velx", v[:, 0]), ("vely", v[:, 1]),
                     ("velz", v[:, 2])]
        for key, val in cols:
            np.add.at(fields[key].reshape(-1), flat, w * val)
        np.add.at(wsum.reshape(-1), flat, w)
    wsum = np.where(wsum > 0, wsum, 1.0)
    return {k: v / wsum for k, v in fields.items()}


def build_uniform_state(levels: list[LevelData], read_metals: bool,
                        smooth_metals: bool = True,
                        dtype: torch.dtype = torch.float32, *,
                        device: torch.device | str = "cuda"
                        ) -> tuple[FieldState, GridGeometry]:
    """Grid construction pipeline -> (FieldState on `device`,
    GridGeometry)."""
    levels, box = normalize_coordinates(levels)
    n = round(levels[0].ncell ** (1.0 / 3.0))
    dense = levels_to_dense(levels, n, read_metals)
    abun2 = dense["abun2"]
    if read_metals and smooth_metals:
        abun2 = smooth_metallicity(abun2)
    rho = dense["nh"] * MH / PSI
    HI = dense["nh"] * dense["xneu"]
    vel = (np.stack([dense["velx"], dense["vely"], dense["velz"]])
           if "velx" in dense else None)
    state = make_state(rho, dense["tgas"], HI, abun2=abun2, dtype=dtype,
                       vel=vel, device=device)
    return state, GridGeometry(n, n, n, box)
