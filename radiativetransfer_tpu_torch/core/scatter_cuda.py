"""Row scatter-add as a hand-written CUDA kernel.

Counterpart of the JAX package's scripts/exp_pallas_scatter.py
`_scatter_kernel` (#8): rows of 8 float32 values added into an (n_cells,
8) accumulator at given cells, in place, the deposit pattern of the
point-source tracer (core/rays.py's index_add_ deposits).  The kernel is
csrc/scatter_rows.cu: 4 rows a thread, their streaming loads issued
before their two float4 reductions each, a grid of the blocks the card
holds at once.

* `scatter_rows(acc, idx, vals)` — the wrapper: a CUDA tensor launches the
  kernel (or raises), a CPU tensor takes the plain version.  `LAUNCHES`
  counts the kernel launches.  Its host path is kept short: the checks
  read only dtypes, shapes, strides and pointers, the device is entered
  only when it is not the current one, and the stream is read raw.
* `scatter_rows_reference` — the plain version, acc.index_add_(0, idx,
  vals).
* `red_floor` / `red_floor_reference` — the floor probe: two float4
  reductions of ones per row into hashed cells, no loads.
* `bound_ms` — the least time the card could take for m rows.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_build, probes_cuda

ROW = 8
# bytes one row must move: its int32 index and 8 float32 values read, and
# the touched 32-byte sector of the accumulator read and written
BYTES_PER_ROW = 4 + 4 * ROW + 2 * 32

# kernel launches made by scatter_rows and by red_floor
LAUNCHES = 0
FLOOR_LAUNCHES = 0

_LIB = None
# the current device's index, and a device's current stream handle: torch's
# raw calls where it has them (set by build)
_current_device = None
_raw_stream = None


def scatter_rows_reference(acc, idx, vals) -> torch.Tensor:
    """acc[idx[r], :] += vals[r, :] in place, on any device; returns acc."""
    return acc.index_add_(0, idx, vals)


def build() -> ctypes.CDLL:
    """Compile (if not built yet) and load the scatter library."""
    global _LIB, _current_device, _raw_stream
    if _LIB is not None:
        return _LIB
    lib = cuda_build.build("scatter_rows")["scatter_rows"]
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rt_scatter_rows.argtypes = [p, ll, p, p, ll, p]
    lib.rt_scatter_rows.restype = i
    lib.rt_red_floor.argtypes = [p, ll, ll, p]
    lib.rt_red_floor.restype = i
    lib.rt_scatter_error_string.argtypes = [i]
    lib.rt_scatter_error_string.restype = ctypes.c_char_p
    _current_device = getattr(torch._C, "_cuda_getDevice",
                              torch.cuda.current_device)
    _raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
        lambda index: torch.cuda.current_stream(index).cuda_stream)
    _LIB = lib
    return lib


def _check_rc(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.rt_scatter_error_string(rc).decode()} "
                           f"({rc})")


def _on_device(index: int, launch) -> int:
    """launch(stream handle) on device `index`, entering it only when it is
    not the current device."""
    if index == _current_device():
        return launch(_raw_stream(index))
    with torch.cuda.device(index):
        return launch(_raw_stream(index))


def scatter_rows(acc, idx, vals) -> torch.Tensor:
    """acc (n_cells, 8) float32 += rows vals (m, 8) at cells idx (m,) int32,
    in place; returns acc.  A CPU tensor takes scatter_rows_reference; a
    CUDA tensor launches the kernel, or raises.  The kernel drops a row
    whose index lies outside [0, n_cells) (as JAX's scatter does), where
    the plain version raises."""
    global LAUNCHES
    if not acc.is_cuda:
        if acc.device.type == "cpu":
            return scatter_rows_reference(acc, idx, vals)
        raise ValueError(f"no scatter kernel for device {acc.device}")
    m = check_rows(acc, idx, vals)
    if m == 0:
        return acc
    lib = _LIB or build()
    rc = _on_device(acc.get_device(), lambda stream: lib.rt_scatter_rows(
        acc.data_ptr(), acc.shape[0], idx.data_ptr(), vals.data_ptr(),
        m, stream))
    _check_rc(lib, rc, "scatter")
    LAUNCHES += 1
    return acc


def check_rows(acc, idx, vals) -> int:
    """What the kernel asks of its arguments, from their dtypes, shapes,
    strides, pointers and devices alone (no device work); returns the
    rows' count m.  Raises TypeError or ValueError.  One expression tests
    all of it first (a wrapper call's host time is what PERF.md measures
    at small M); only a failure walks the checks one by one."""
    f32, device = torch.float32, acc.device
    if (acc.dtype is f32 and vals.dtype is f32 and idx.dtype is torch.int32
            and acc.dim() == 2 and acc.shape[1] == ROW and idx.dim() == 1
            and vals.shape == (idx.shape[0], ROW) and acc.is_contiguous()
            and idx.is_contiguous() and vals.is_contiguous()
            and not (acc.data_ptr() | vals.data_ptr()) & 15
            and idx.device == device and vals.device == device):
        return idx.shape[0]
    if acc.dtype != torch.float32 or vals.dtype != torch.float32:
        raise TypeError(f"scatter kernel takes float32 rows, got "
                        f"{acc.dtype} and {vals.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"scatter kernel takes int32 indices, got {idx.dtype}")
    m = idx.shape[0]
    if acc.dim() != 2 or acc.shape[1] != ROW or idx.dim() != 1 or \
            vals.shape != (m, ROW):
        raise ValueError(f"shapes acc {tuple(acc.shape)}, idx "
                         f"{tuple(idx.shape)}, vals {tuple(vals.shape)}: "
                         f"want (n, {ROW}), (m,), (m, {ROW})")
    if not (acc.is_contiguous() and idx.is_contiguous()
            and vals.is_contiguous()):
        raise ValueError("acc, idx and vals must be contiguous")
    if acc.data_ptr() % 16 or vals.data_ptr() % 16:
        raise ValueError("acc and vals must be 16-byte aligned (float4)")
    if idx.device != acc.device or vals.device != acc.device:
        raise ValueError("acc, idx and vals must be on one device")
    return m


def red_floor_cells(m: int, n_cells: int) -> np.ndarray:
    """The floor probe's cell of each row r < m: csrc/scatter_rows.cu's
    hash32(r) % n_cells."""
    x = np.arange(m, dtype=np.uint64) & np.uint64(0xFFFFFFFF)
    mask = np.uint64(0xFFFFFFFF)
    x ^= x >> np.uint64(16)
    x = (x * np.uint64(0x7FEB352D)) & mask
    x ^= x >> np.uint64(15)
    x = (x * np.uint64(0x846CA68B)) & mask
    x ^= x >> np.uint64(16)
    return (x % np.uint64(n_cells)).astype(np.int64)


def red_floor_reference(acc, m: int) -> torch.Tensor:
    """The floor probe's plain version: ones added into acc's rows at
    red_floor_cells, in place, on any device; returns acc."""
    cells = torch.as_tensor(red_floor_cells(m, acc.shape[0]),
                            device=acc.device)
    return acc.index_add_(0, cells, torch.ones((m, ROW), dtype=acc.dtype,
                                               device=acc.device))


def red_floor(acc, m: int) -> torch.Tensor:
    """The floor probe on acc (n_cells, 8) float32: 2 float4 reductions of
    ones per row r < m into cell red_floor_cells(m, n_cells)[r], in place;
    returns acc.  A CPU tensor takes red_floor_reference; a CUDA tensor
    launches the kernel, or raises."""
    global FLOOR_LAUNCHES
    if acc.device.type == "cpu":
        return red_floor_reference(acc, m)
    if acc.device.type != "cuda" or acc.dtype != torch.float32 or \
            acc.dim() != 2 or acc.shape[1] != ROW or not acc.is_contiguous():
        raise ValueError(f"the floor probe takes a contiguous (n, {ROW}) "
                         f"float32 CUDA accumulator, got {tuple(acc.shape)} "
                         f"{acc.dtype} on {acc.device}")
    if m < 1:
        raise ValueError(f"m must be >= 1, got {m}")
    lib = _LIB or build()
    rc = _on_device(acc.device.index, lambda stream: lib.rt_red_floor(
        acc.data_ptr(), acc.shape[0], m, stream))
    _check_rc(lib, rc, "floor probe")
    FLOOR_LAUNCHES += 1
    return acc


def bound_ms(m: int) -> float:
    """The least time in ms m rows could take: their bytes at the published
    HBM rate (8 adds a row bind nothing)."""
    return 1e3 * m * BYTES_PER_ROW / probes_cuda.HBM_BYTES_PER_S
