"""Roofline measurement of the diffuse sweep on one CUDA device.

    python3 -m radiativetransfer_tpu_torch.roofline_sweep

Port of the JAX package's scripts/roofline_sweep.py.  Measures on the
card, with CUDA events around many launches after a warm-up (the field,
201 MB at 256^3, is 4x the 50 MB L2, so every pass streams from HBM):

  1. the HBM stream: the probe kernel with body v + 1  -> GB/s, beside the
     published 3.35 TB/s;
  2. the full sweep: the CUDA kernel and the plain slab scan
     -> cells*angles/s;
  3. the exp, div and fma rates from 64-deep chains of the probe kernel
     -> op/s, each with the sweep's floor at that rate, and the FP32
     instructions per MUFU of the exp and div chains in the kernel's SASS;

and prints the sweep kernel's bound (probes_cuda.sweep_bound) with what
sets it.  Each probe's output is held against its plain PyTorch version
on the same field (max abs and relative error), whose time it also gets;
the stream gets its one-call library equivalent (torch.add), timed in turns
with the kernel (kernel, add, add, kernel).  ROOF_N (default 256)
and ROOF_LEVEL (default 3, 192 directions) set the shape.  Needs a CUDA
device; prints the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess

import numpy as np
import torch

from .constants import KPC
from .core import cuda_build, probes_cuda, sweep, sweep_cuda

DEVICE = "cuda"


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def bench_kappa(n: int) -> torch.Tensor:
    """The benchmarks' opacity field: lognormal(0, 1) x 0.5 per cell,
    seed 0, float32 (bench.py and scripts/roofline_sweep.py)."""
    rng = np.random.default_rng(0)
    cell = (2000.0 / n) * KPC
    return torch.tensor(rng.lognormal(0.0, 1.0, (3, n, n, n)) * (0.5 / cell),
                        dtype=torch.float32, device=DEVICE)


def probe(x: torch.Tensor, body: str, depth: int, reps: int,
          plain_reps: int = 1) -> dict:
    """One probe kernel at x's shape: its device time per launch, its rate
    (chain steps per second), the plain version's time, the bound, and the
    kernel's output (its warm-up launch) against the plain version's on x:
    max abs and max relative error."""
    out = probes_cuda.chain(x, body, depth)
    ms = probes_cuda.time_ms(lambda: probes_cuda.chain(x, body, depth), reps,
                             warmup=False)
    ref = probes_cuda.chain_reference(x, body, depth)
    plain_ms = probes_cuda.time_ms(
        lambda: probes_cuda.chain_reference(x, body, depth), plain_reps,
        warmup=False)
    err = (out - ref).abs()
    rel = err / ref.abs().clamp(min=torch.finfo(ref.dtype).tiny)
    bound_ms, bound_by = probes_cuda.chain_bound_ms(x.numel(), body, depth)
    return {"body": body, "depth": depth, "ms": ms, "plain_ms": plain_ms,
            "per_s": x.numel() * depth / (ms * 1e-3), "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": float(err.max()),
            "max_rel_err": float(rel.max())}


def sass_per_step(bodies=("exp", "div")) -> dict:
    """FP32 instructions per MUFU in the innermost loop of the named chain
    kernels, counted in the SASS of the built probe library."""
    mix = probes_cuda.sass_loop_mix(cuda_build.sass("probes"))
    out = {}
    for body in bodies:
        tag = f"chain_kernelILi{probes_cuda.BODIES[body]}E"
        out[body] = probes_cuda.per_mufu(
            next(c for name, c in mix.items() if tag in name))
    return out


def main(n: int | None = None, level: int | None = None) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("roofline_sweep needs a CUDA device")
    n = n or int(os.environ.get("ROOF_N", "256"))
    level = level or int(os.environ.get("ROOF_LEVEL", "3"))
    smi = nvidia_smi()
    kappa = bench_kappa(n)
    cell = (2000.0 / n) * KPC
    uvb = np.array([1e-21, 5e-22, 1e-22])
    plan = sweep.build_sweep_plan(level, n)
    ndir = plan.n_directions
    field_bytes = kappa.numel() * 4
    out = {"n": n, "directions": ndir, "card": smi}

    # 1. HBM stream: read and write one field per pass
    st = probe(kappa, "stream", 1, reps=50)
    # the kernel and its library call in turns (kernel, add, add, kernel)
    fns = (lambda: probes_cuda.chain(kappa, "stream", 1),
           lambda: torch.add(kappa, 1.0))
    st["turns"] = [probes_cuda.time_ms(fns[i], 50) for i in (0, 1, 1, 0)]
    st["ms"] = (st["turns"][0] + st["turns"][3]) / 2
    st["library_ms"] = (st["turns"][1] + st["turns"][2]) / 2
    gbps = 2 * field_bytes / (st["ms"] * 1e-3) / 1e9
    out["stream"] = st
    out["stream_gb_per_s"] = gbps
    print(f"1. HBM stream: {st['ms']:.4f} ms/pass -> {gbps:.1f} GB/s "
          f"(published {probes_cuda.HBM_BYTES_PER_S / 1e9:.0f} GB/s; "
          f"field {field_bytes / 1e9:.3f} GB); in turns kernel "
          f"{st['turns'][0]:.4f}, torch.add {st['turns'][1]:.4f}, "
          f"{st['turns'][2]:.4f}, kernel {st['turns'][3]:.4f} ms; plain "
          f"{st['plain_ms']:.4f} ms; kernel vs plain max rel "
          f"{st['max_rel_err']:.3e}; card {smi}")

    # 2. the full sweep: CUDA kernel (clamped logmean) and plain slab scan
    sweep_ms = probes_cuda.time_ms(lambda: sweep_cuda.diffuse_sweep_kernel(
        kappa, plan, uvb, cell, "clamped"), reps=3)
    scan_ms = probes_cuda.time_ms(lambda: sweep.diffuse_sweep(
        kappa, plan, uvb, cell), reps=1)
    cells_angles = n ** 3 * ndir
    out.update(sweep_ms=sweep_ms, scan_ms=scan_ms)
    print(f"2. sweep kernel: {sweep_ms:.3f} ms -> "
          f"{cells_angles / sweep_ms * 1e3:.4e} cells*angles/s")
    print(f"2b. plain slab scan: {scan_ms:.3f} ms -> "
          f"{cells_angles / scan_ms * 1e3:.4e} cells*angles/s")

    # 3. 64-deep chains: exp, div, fma
    x = kappa * cell
    counts = sweep_cuda.work_counts(plan)
    for body, depth in probes_cuda.PLANE_PROBES[1:]:
        r = probe(x, body, depth, reps=10)
        out[body] = r
        need = {"exp": counts["exps"], "fma": counts["fp32_ops"],
                "div": 3 * n ** 3}[body]
        what = {"exp": "exps", "fma": "FP32 instructions",
                "div": "divisions (1/kappa)"}
        # the fma body is 2 FP32 instructions per step
        ops_per_s = r["per_s"] * (probes_cuda.FP32_PER_STEP[body]
                                  if body == "fma" else 1)
        print(f"3. {body}: {r['per_s']:.4e} {body}/s ({r['ms']:.4f} ms per "
              f"64-deep chain, bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']}, plain {r['plain_ms']:.3f} ms, kernel vs "
              f"plain max rel {r['max_rel_err']:.3e}) => the sweep's "
              f"{need:.3e} {what[body]} take {need / ops_per_s * 1e3:.3f} ms")
    out["sass"] = sass_per_step()
    print("3b. SASS of the chain kernels' innermost loops: " + "; ".join(
        f"{body} {m['fp32_per_mufu']:g} FP32 instructions per MUFU "
        f"(FP32_PER_STEP: {probes_cuda.FP32_PER_STEP[body]})"
        for body, m in out["sass"].items()))

    b = probes_cuda.sweep_bound(counts, out["exp"]["per_s"])
    out["bound"] = b
    print()
    print(f"summary @ {n}^3 x {ndir} dirs: sweep kernel {sweep_ms:.3f} ms; "
          f"bound {b['bound_ms']:.3f} ms set by {b['binding']} "
          f"(bytes {b['bytes_ms']:.4f} ms at 3.35 TB/s; {counts['exps']:.4e}"
          f" exps {b['exp_ms']:.3f} ms at the MUFU rate "
          f"{probes_cuda.MUFU_PER_S:.4e}/s, {b['exp_measured_ms']:.3f} ms at "
          f"the measured expf rate {out['exp']['per_s']:.4e}/s; "
          f"{counts['fp32_ops']:.4e} FP32 instructions {b['fp32_ms']:.3f} ms "
          f"at {probes_cuda.FP32_INSTR_PER_S:.4e}/s); kernel at "
          f"{100 * b['bound_ms'] / sweep_ms:.1f}% of its bound; the "
          f"wrapper's copies move {counts['wrapper_bytes'] / 1e9:.3f} GB "
          f"({b['wrapper_bytes_ms']:.3f} ms at 3.35 TB/s); card {smi}")
    print(json.dumps({"roofline": {k: out[k] for k in (
        "n", "directions", "stream_gb_per_s", "sweep_ms", "scan_ms",
        "bound", "sass", "card")}}))
    return out


if __name__ == "__main__":
    main()
