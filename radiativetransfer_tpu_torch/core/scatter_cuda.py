"""Row scatter-add as a hand-written CUDA kernel.

Counterpart of the JAX package's scripts/exp_pallas_scatter.py
`_scatter_kernel` (#8): rows of 8 float32 values added into an (n_cells,
8) accumulator at given cells, in place, the deposit pattern of the
point-source tracer (core/rays.py's index_add_ deposits).  The kernel is
csrc/scatter_rows.cu: one thread per row, two float4 atomics.

* `scatter_rows(acc, idx, vals)` — the wrapper: a CUDA tensor launches the
  kernel (or raises), a CPU tensor takes the plain version.  `LAUNCHES`
  counts the kernel launches.
* `scatter_rows_reference` — the plain version, acc.index_add_(0, idx,
  vals).
* `bound_ms` — the least time the card could take for m rows.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build, probes_cuda

ROW = 8
# bytes one row must move: its int32 index and 8 float32 values read, and
# the touched 32-byte sector of the accumulator read and written
BYTES_PER_ROW = 4 + 4 * ROW + 2 * 32

# kernel launches made by scatter_rows
LAUNCHES = 0

_LIB = None


def scatter_rows_reference(acc, idx, vals) -> torch.Tensor:
    """acc[idx[r], :] += vals[r, :] in place, on any device; returns acc."""
    return acc.index_add_(0, idx, vals)


def build() -> ctypes.CDLL:
    """Compile (if not built yet) and load the scatter library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = cuda_build.build("scatter_rows")["scatter_rows"]
    p = ctypes.c_void_p
    lib.rt_scatter_rows.argtypes = [p, ctypes.c_longlong, p, p,
                                    ctypes.c_longlong, p]
    lib.rt_scatter_rows.restype = ctypes.c_int
    lib.rt_scatter_error_string.argtypes = [ctypes.c_int]
    lib.rt_scatter_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def scatter_rows(acc, idx, vals) -> torch.Tensor:
    """acc (n_cells, 8) float32 += rows vals (m, 8) at cells idx (m,) int32,
    in place; returns acc.  A CPU tensor takes scatter_rows_reference; a
    CUDA tensor launches the kernel, or raises.  The kernel drops a row
    whose index lies outside [0, n_cells) (as JAX's scatter does), where
    the plain version raises."""
    global LAUNCHES
    if acc.device.type == "cpu":
        return scatter_rows_reference(acc, idx, vals)
    if acc.device.type != "cuda":
        raise ValueError(f"no scatter kernel for device {acc.device}")
    if acc.dtype != torch.float32 or vals.dtype != torch.float32:
        raise TypeError(f"scatter kernel takes float32 rows, got "
                        f"{acc.dtype} and {vals.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"scatter kernel takes int32 indices, got {idx.dtype}")
    if acc.dim() != 2 or acc.shape[1] != ROW or tuple(vals.shape) != (
            idx.shape[0], ROW) or idx.dim() != 1:
        raise ValueError(f"shapes acc {tuple(acc.shape)}, idx "
                         f"{tuple(idx.shape)}, vals {tuple(vals.shape)}: "
                         f"want (n, {ROW}), (m,), (m, {ROW})")
    if not (acc.is_contiguous() and idx.is_contiguous()
            and vals.is_contiguous()):
        raise ValueError("acc, idx and vals must be contiguous")
    if acc.data_ptr() % 16 or vals.data_ptr() % 16:
        raise ValueError("acc and vals must be 16-byte aligned (float4)")
    if not (acc.device == idx.device == vals.device):
        raise ValueError("acc, idx and vals must be on one device")
    if idx.numel() == 0:
        return acc
    lib = build()
    with torch.cuda.device(acc.device):
        rc = lib.rt_scatter_rows(
            acc.data_ptr(), acc.shape[0], idx.data_ptr(), vals.data_ptr(),
            idx.numel(),
            torch.cuda.current_stream(acc.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"scatter kernel launch failed: "
                           f"{lib.rt_scatter_error_string(rc).decode()} "
                           f"({rc})")
    LAUNCHES += 1
    return acc


def bound_ms(m: int) -> float:
    """The least time in ms m rows could take: their bytes at the published
    HBM rate (8 adds a row bind nothing)."""
    return 1e3 * m * BYTES_PER_ROW / probes_cuda.HBM_BYTES_PER_S
