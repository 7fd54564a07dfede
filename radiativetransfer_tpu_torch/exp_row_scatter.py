"""Row scatter-add experiment on one CUDA device: tracer deposits.

    python3 -m radiativetransfer_tpu_torch.exp_row_scatter

Port of the JAX package's scripts/exp_pallas_scatter.py.  The tracer
deposits 8 channels per cell with index_add_; the TPU experiment asked
whether a hand-written scatter that walks the rows beats the library's.
Here the row kernel (csrc/scatter_rows.cu, one thread per row, two float4
atomics) runs beside 6 per-channel index_add_ calls (the script's `xla6`)
and one row-wise index_add_ (`xla-row8`, the kernel's plain version) at
the script's shapes: an (N^3, 8) float32 accumulator with N = 128 (67 MB)
and M = 98,304, 393,216 and 786,432 rows, indices and values from seed 0.
Prints ms and ns per row of each (CUDA events), the kernel's bound and its
error against a float64 np.add.at on the host and against index_add_.
Needs a CUDA device; prints the card's name and power limit.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .core import probes_cuda, scatter_cuda
from .roofline_sweep import nvidia_smi

DEVICE = "cuda"
N = 128
NC = N ** 3
MS = (98304, 393216, 786432)
REPS = 20


def rows(rng, m: int):
    """The script's rows: m cells uniform over the grid, normal values."""
    idx = rng.integers(0, NC, m)
    vals = rng.normal(0, 1, (m, scatter_cuda.ROW))
    return idx, vals


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("exp_row_scatter needs a CUDA device")
    smi = nvidia_smi()
    print(f"device={torch.cuda.get_device_name(0)} grid={N}^3 "
          f"acc={NC * 8 * 4 / 1e6:.0f} MB card {smi}")
    rng = np.random.default_rng(0)
    out = {"n": N, "card": smi, "m": {}}
    for m in MS:
        idx_np, vals_np = rows(rng, m)
        idx = torch.tensor(idx_np, dtype=torch.int32, device=DEVICE)
        vals = torch.tensor(vals_np, dtype=torch.float32, device=DEVICE)
        v6 = [vals[:, c].contiguous() for c in range(6)]
        acc = torch.zeros((NC, scatter_cuda.ROW), device=DEVICE)
        rf = torch.zeros(NC, device=DEVICE)

        # correctness: one scatter into a zeroed accumulator, against a
        # float64 np.add.at of the same float32 values and the plain version
        got = scatter_cuda.scatter_rows(torch.zeros_like(acc), idx, vals)
        ref = np.zeros((NC, scatter_cuda.ROW))
        np.add.at(ref, idx_np, vals_np.astype(np.float32).astype(np.float64))
        plain = scatter_cuda.scatter_rows_reference(torch.zeros_like(acc),
                                                    idx, vals)
        err_np = float(np.abs(got.cpu().numpy() - ref).max())
        err_plain = float((got - plain).abs().max())
        del got, plain

        def xla6():
            for c in range(6):
                rf.index_add_(0, idx, v6[c])

        t_k = probes_cuda.time_ms(
            lambda: scatter_cuda.scatter_rows(acc, idx, vals), REPS)
        t_x6 = probes_cuda.time_ms(xla6, REPS)
        # the plain version is the library's row-wise index_add_: one time
        t_row = probes_cuda.time_ms(
            lambda: scatter_cuda.scatter_rows_reference(acc, idx, vals),
            REPS)
        b = scatter_cuda.bound_ms(m)
        out["m"][m] = {"ms": t_k, "ns_per_row": t_k * 1e6 / m,
                       "plain_ms": t_row, "xla6_ms": t_x6,
                       "library_ms": t_row, "bound_ms": b,
                       "max_abs_err": err_np,
                       "max_abs_err_vs_plain": err_plain}
        print(f"M={m:7d}: xla6 {t_x6:8.4f} ms ({t_x6 * 1e6 / m:6.2f} ns/row) "
              f" xla-row8 {t_row:8.4f} ms  kernel {t_k:8.4f} ms "
              f"({t_k * 1e6 / m:6.2f} ns/row, bound {b:.4f} ms by bytes, "
              f"{100 * b / t_k:.1f}%)  maxerr vs np.add.at (f64) "
              f"{err_np:.2e}, vs index_add_ {err_plain:.2e}")
    print(json.dumps({"exp_row_scatter": out}))
    return out


if __name__ == "__main__":
    main()
