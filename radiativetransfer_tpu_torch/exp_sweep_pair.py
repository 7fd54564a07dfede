"""Sweep dataflow experiment on one CUDA device: two slabs per step.

    python3 -m radiativetransfer_tpu_torch.exp_sweep_pair

Port of the JAX package's scripts/exp_sweep_pair.py.  The merged kernel
(csrc/sweep_merged.cu) walks one slab per loop step; the pair kernel
(csrc/sweep_variants.cu) walks two and keeps the carry between them in
registers, with the same arithmetic (the exact logmean).  Prints the
pair's error against the shipped kernel (`ship`: the merged kernel, exact
logmean, as the script's diffuse_sweep_pallas default), ms per sweep and
cells*angles/s of both, timed with CUDA events, and the pair kernel's time
and elementwise error beside its plain version's, and its bound.  EXP_N
(default 256) and EXP_LEVEL (default 3, 192 directions) set the shape; the
field is the script's 10**U(-26, -20) from seed 0.  Needs a CUDA device;
prints the card's name and power limit.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .constants import KPC
from .core import probes_cuda, sweep, sweep_cuda, variants_cuda
from .roofline_sweep import nvidia_smi

DEVICE = "cuda"
UVB = np.array([1e-21, 3e-22, 1e-22])
REPS = 3


def exp_kappa(n: int) -> torch.Tensor:
    """The scripts' field: 10**U(-26, -20) per cell and band, seed 0, f32."""
    rng = np.random.default_rng(0)
    return torch.tensor(10.0 ** rng.uniform(-26, -20, (3, n, n, n)),
                        dtype=torch.float32, device=DEVICE)


def max_rel_to_peak(out: torch.Tensor, ref: torch.Tensor) -> float:
    """The scripts' maxrelerr: max |out - ref| over max |ref|."""
    return float((out - ref).abs().max() / ref.abs().max())


def main(n: int | None = None, level: int | None = None) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("exp_sweep_pair needs a CUDA device")
    n = n or int(os.environ.get("EXP_N", "256"))
    level = level or int(os.environ.get("EXP_LEVEL", "3"))
    smi = nvidia_smi()
    plan = sweep.build_sweep_plan(level, n)
    ndir = plan.n_directions
    cell = 2000.0 * KPC / n
    kappa = exp_kappa(n)
    ca = n ** 3 * ndir
    print(f"device={torch.cuda.get_device_name(0)} n={n} level={level} "
          f"card {smi}")

    j_ref = sweep_cuda.diffuse_sweep_kernel(kappa, plan, UVB, cell, "exact")
    j_pair = variants_cuda.sweep_pair(kappa, plan, UVB, cell)
    err = max_rel_to_peak(j_pair, j_ref)
    print(f"pair-vs-ship maxrelerr = {err:.2e}")

    ship_ms = probes_cuda.time_ms(lambda: sweep_cuda.diffuse_sweep_kernel(
        kappa, plan, UVB, cell, "exact"), REPS)
    pair_ms = probes_cuda.time_ms(lambda: variants_cuda.sweep_pair(
        kappa, plan, UVB, cell), REPS)
    print(f"ship: {ship_ms:9.3f} ms/sweep  {ca / ship_ms * 1e3:.3e} "
          f"cells*angles/s")
    print(f"pair: {pair_ms:9.3f} ms/sweep  {ca / pair_ms * 1e3:.3e} "
          f"cells*angles/s")

    # the plain version once, on the same field: its time and the kernel's
    # error against it
    j_plain = variants_cuda.sweep_pair_reference(kappa, plan, UVB, cell)
    plain_ms = probes_cuda.time_ms(lambda: variants_cuda.sweep_pair_reference(
        kappa, plan, UVB, cell), 1, warmup=False)
    bound = probes_cuda.sweep_bound(sweep_cuda.work_counts(plan),
                                    probes_cuda.MUFU_PER_S)
    err_abs, err_rel = probes_cuda.rel_err(j_pair, j_plain)
    out = {"n": n, "directions": ndir, "card": smi, "ship_ms": ship_ms,
           "ms": pair_ms, "plain_ms": plain_ms,
           "max_rel_err_vs_ship": err, "max_abs_err": err_abs,
           "max_rel_err": err_rel,
           "max_rel_err_vs_plain": max_rel_to_peak(j_pair, j_plain),
           "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"]}
    print(f"pair plain version: {plain_ms:.3f} ms; pair vs plain max abs "
          f"{err_abs:.3e}, max elementwise rel {err_rel:.3e} (maxrelerr "
          f"{out['max_rel_err_vs_plain']:.2e}); bound {bound['bound_ms']:.4f} "
          f"ms set by {bound['binding']}, pair at "
          f"{100 * bound['bound_ms'] / pair_ms:.2f}% of it")
    print(json.dumps({"exp_sweep_pair": out}))
    return out


if __name__ == "__main__":
    main()
