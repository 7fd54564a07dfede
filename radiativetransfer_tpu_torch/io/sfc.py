"""Depth-first space-filling-curve leaf enumeration (cellArray order).

Counterpart of the JAX package's io/sfc.py.  The reference flattens octree
leaves depth-first -- base cells in i,j,k order, children recursively in
2x2x2 i,j,k order (writeCell, equiSources.f90:4044-4079) -- for snapshots,
restart and the standalone converters (readCellArray.f90,
convertFormats.f90, hdf42bin.f90:222-269).

The enumerator is native: `csrc/ftte_native.cpp` (the repository's
`csrc/ftte_native.cpp`, copied), compiled with g++ at first use into
`radiativetransfer_tpu_torch/_build/` under a name that carries a hash of
the source and the flags, and bound with ctypes.  A failed build raises;
`_enumerate_python` is the plain version the tests hold the native one to.
The octree is described by per-level refinement bitmaps: level l is a
dense (nx*2^l, ny*2^l, nz*2^l) uint8 array, nonzero where that cell is
refined.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "ftte_native.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O2", "-shared", "-fPIC")

_LIB: ctypes.CDLL | None = None


def library_path() -> Path:
    """The shared library, named by a hash of the source and the flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"ftte_native_{h.hexdigest()[:16]}.so"


def _build() -> Path:
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # built under a name of this process's own and renamed into place, so
    # processes building at once never load a half-written library
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ not found: the SFC enumerator "
                           f"({SOURCE.name}) is built from source at first "
                           f"use") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def _get_lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(_build()))
        pp = ctypes.POINTER(ctypes.c_uint8)
        i64 = ctypes.c_int64
        lib.ftte_sfc_count.restype = i64
        lib.ftte_sfc_count.argtypes = [i64, i64, i64, ctypes.c_int,
                                       ctypes.POINTER(pp)]
        lib.ftte_sfc_enumerate.restype = i64
        lib.ftte_sfc_enumerate.argtypes = [
            i64, i64, i64, ctypes.c_int, ctypes.POINTER(pp),
            ctypes.POINTER(i64), ctypes.POINTER(i64),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double)]
        _LIB = lib
    return _LIB


def _bitmap_pointers(refined: list[np.ndarray]):
    ptr_t = ctypes.POINTER(ctypes.c_uint8)
    arr = (ptr_t * max(len(refined), 1))()
    keepalive = []
    for i, r in enumerate(refined):
        r = np.ascontiguousarray(r, np.uint8)
        keepalive.append(r)
        arr[i] = r.ctypes.data_as(ptr_t)
    return arr, keepalive


def enumerate_leaves(nx: int, ny: int, nz: int,
                     refined: list[np.ndarray]) -> dict[str, np.ndarray]:
    """Leaves in cellArray depth-first order, by the native enumerator.

    Returns dict with 'level' (int64), 'src' (flat index into the leaf's
    level grid), and leaf centers 'x','y','z' in box units.
    """
    for lv, r in enumerate(refined):
        want = (nx << lv, ny << lv, nz << lv)
        if np.shape(r) != want:
            raise ValueError(f"refinement bitmap of level {lv} has shape "
                             f"{np.shape(r)}, expected {want}")
    lib = _get_lib()
    arr, _keepalive = _bitmap_pointers(refined)
    n = lib.ftte_sfc_count(nx, ny, nz, len(refined), arr)
    level = np.empty(n, np.int64)
    src = np.empty(n, np.int64)
    x = np.empty(n, np.float64)
    y = np.empty(n, np.float64)
    z = np.empty(n, np.float64)
    p64 = ctypes.POINTER(ctypes.c_int64)
    pd = ctypes.POINTER(ctypes.c_double)
    lib.ftte_sfc_enumerate(nx, ny, nz, len(refined), arr,
                           level.ctypes.data_as(p64), src.ctypes.data_as(p64),
                           x.ctypes.data_as(pd), y.ctypes.data_as(pd),
                           z.ctypes.data_as(pd))
    return {"level": level, "src": src, "x": x, "y": y, "z": z}


def _enumerate_python(nx: int, ny: int, nz: int,
                      refined: list[np.ndarray]) -> dict[str, np.ndarray]:
    """The plain version of enumerate_leaves (same ordering)."""
    out_level, out_src = [], []
    out_x, out_y, out_z = [], [], []

    def is_refined(level, i, j, k):
        if level >= len(refined) or refined[level] is None:
            return False
        return bool(refined[level][i, j, k])

    def visit(level, i, j, k):
        if is_refined(level, i, j, k):
            for di in range(2):
                for dj in range(2):
                    for dk in range(2):
                        visit(level + 1, 2 * i + di, 2 * j + dj, 2 * k + dk)
        else:
            sy, sz = ny << level, nz << level
            out_level.append(level)
            out_src.append((i * sy + j) * sz + k)
            out_x.append((i + 0.5) / (nx << level))
            out_y.append((j + 0.5) / sy)
            out_z.append((k + 0.5) / sz)

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        for i in range(nx):
            for j in range(ny):
                for k in range(nz):
                    visit(0, i, j, k)
    finally:
        sys.setrecursionlimit(old)
    return {"level": np.array(out_level, np.int64),
            "src": np.array(out_src, np.int64),
            "x": np.array(out_x), "y": np.array(out_y), "z": np.array(out_z)}


def gather(enum: dict[str, np.ndarray],
           level_fields: list[np.ndarray]) -> np.ndarray:
    """SFC-ordered leaf values, in the fields' dtype: level_fields[l] is
    level l's dense (..., nx*2^l, ny*2^l, nz*2^l) array (leading axes, e.g.
    a stack of fields, are kept); returns (..., n_leaves)."""
    lead = np.shape(level_fields[0])[:-3]
    out = np.empty(lead + (len(enum["level"]),),
                   np.result_type(*level_fields))
    for lv, field in enumerate(level_fields):
        m = enum["level"] == lv
        out[..., m] = np.reshape(field, lead + (-1,))[..., enum["src"][m]]
    return out


def gather_leaves(enum: dict[str, np.ndarray],
                  level_fields: list[np.ndarray]) -> np.ndarray:
    """SFC-ordered leaf values from per-level dense fields, in float64
    (writeCell semantics)."""
    return gather(enum, [np.asarray(f, np.float64) for f in level_fields])


def scatter_leaves(enum: dict[str, np.ndarray], values: np.ndarray,
                   level_shapes: list[tuple[int, int, int]]) -> list[np.ndarray]:
    """Inverse of gather_leaves (readLatestIonization semantics); positions
    that hold no leaf are 0."""
    fields = [np.zeros(int(np.prod(s))) for s in level_shapes]
    for lv in range(len(level_shapes)):
        m = enum["level"] == lv
        fields[lv][enum["src"][m]] = values[m]
    return [f.reshape(s) for f, s in zip(fields, level_shapes)]
