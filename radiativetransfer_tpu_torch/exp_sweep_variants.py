"""Sweep-kernel op-count experiments on one CUDA device.

    python3 -m radiativetransfer_tpu_torch.exp_sweep_variants

Port of the JAX package's scripts/exp_sweep_variants.py.  Runs the lean
kernel (csrc/sweep_variants.cu) in each variant beside the shipped merged
kernel (`ship`: csrc/sweep_merged.cu, exact logmean):

  lean     act-folded 16-slot tables: lm from i_out - i_in, no masks
  clamp    lean with the clamped branch-free logmean
  clamp2   clamp with exp2f on lengths pre-scaled by log2 e
  seg1     chain segments 2 and 3 left out (what do they cost?)
  noemi    the logmean left out (what does the emissivity cost?)
  noshift  the upwind shifts left out (what do the in-plane neighbours and
           the barriers before them cost?)

Prints ms per sweep and cells*angles/s of each (CUDA events), maxrelerr
against ship for lean, clamp and clamp2 (NaN for the attribution variants,
which compute other functions), each kernel's plain version's time and the
kernel's error against it, each one's bound, and the FP32 instructions per
MUFU in the SASS: of the expf and exp2f chain probes (csrc/probes.cu) and of
each variant's innermost loop.  EXP_N (default 256), EXP_LEVEL (default 3)
and EXP_VARIANTS (default all, comma-separated) set the run.  Needs a CUDA
device; prints the card's name and power limit.
"""

from __future__ import annotations

import json
import os

import torch

from .constants import KPC
from .core import cuda_build, probes_cuda, sweep, sweep_cuda, variants_cuda
from .exp_sweep_pair import REPS, UVB, exp_kappa, max_rel_to_peak
from .roofline_sweep import nvidia_smi, sass_per_step


def variant_sass() -> dict:
    """FP32 instructions per MUFU of each variant's innermost loop (its
    shared-memory and global-scratch instances), from the SASS of the
    built sweep_variants library."""
    mix = probes_cuda.sass_loop_mix(cuda_build.sass("sweep_variants"))
    out = {}
    for variant in variants_cuda.VARIANTS:
        f = variants_cuda.flags(variant)
        bits = (f["clamped"], f["use_exp2"], f["seg1_only"], f["no_emi"],
                f["no_shift"])
        for smem in (True, False):
            tag = "sweep_lean_kernelIf" + "".join(
                f"Lb{int(b)}E" for b in (*bits, smem))
            hit = [c for name, c in mix.items() if tag in name]
            if hit:
                out[f"{variant}_{'shared' if smem else 'global'}"] = \
                    probes_cuda.per_mufu(hit[0])
    return out


def bound_for(plan, variant: str, fp32_per_exp2: int) -> dict:
    """probes_cuda.sweep_bound of the work one variant does: the full
    sweep's for the variants that compute it."""
    counts = sweep_cuda.work_counts(
        plan, variant=(None if variant in variants_cuda.FULL_VARIANTS
                       else variant),
        fp32_per_exp=(fp32_per_exp2 if variants_cuda.flags(variant)["use_exp2"]
                      else sweep_cuda.FP32_PER_EXPF))
    return probes_cuda.sweep_bound(counts, probes_cuda.MUFU_PER_S)


def main(n: int | None = None, level: int | None = None) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("exp_sweep_variants needs a CUDA device")
    n = n or int(os.environ.get("EXP_N", "256"))
    level = level or int(os.environ.get("EXP_LEVEL", "3"))
    names = os.environ.get("EXP_VARIANTS",
                           ",".join(variants_cuda.VARIANTS)).split(",")
    smi = nvidia_smi()
    plan = sweep.build_sweep_plan(level, n)
    ndir = plan.n_directions
    cell = 2000.0 * KPC / n
    kappa = exp_kappa(n)
    ca = n ** 3 * ndir
    print(f"device={torch.cuda.get_device_name(0)} n={n} level={level} "
          f"card {smi}")

    # the exps' FP32 instructions, counted as roofline_sweep counts them
    sass = sass_per_step(("exp", "exp2"))
    print("SASS of the chain probes: " + "; ".join(
        f"{body}f {m['fp32_per_mufu']:g} FP32 instructions per MUFU"
        for body, m in sass.items()))
    fp32_per_exp2 = round(sass["exp2"]["fp32_per_mufu"])

    j_ref = sweep_cuda.diffuse_sweep_kernel(kappa, plan, UVB, cell, "exact")
    ship_ms = probes_cuda.time_ms(lambda: sweep_cuda.diffuse_sweep_kernel(
        kappa, plan, UVB, cell, "exact"), REPS)
    print(f"ship : {ship_ms:9.3f} ms/sweep  {ca / ship_ms * 1e3:.3e} "
          f"cells*angles/s")
    out = {"n": n, "directions": ndir, "card": smi, "ship_ms": ship_ms,
           "sass_probes": sass, "variants": {}}
    for name in names:
        jv = variants_cuda.lean_sweep(kappa, plan, UVB, cell, name)
        err = (max_rel_to_peak(jv, j_ref)
               if name in variants_cuda.FULL_VARIANTS else float("nan"))
        ms = probes_cuda.time_ms(lambda name=name: variants_cuda.lean_sweep(
            kappa, plan, UVB, cell, name), REPS)
        j_plain = variants_cuda.lean_sweep_reference(kappa, plan, UVB, cell,
                                                     name)
        plain_ms = probes_cuda.time_ms(
            lambda name=name: variants_cuda.lean_sweep_reference(
                kappa, plan, UVB, cell, name), 1, warmup=False)
        b = bound_for(plan, name, fp32_per_exp2)
        err_abs, err_rel = probes_cuda.rel_err(jv, j_plain)
        r = {"ms": ms, "plain_ms": plain_ms, "max_rel_err_vs_ship": err,
             "max_abs_err": err_abs, "max_rel_err": err_rel,
             "max_rel_err_vs_plain": max_rel_to_peak(jv, j_plain),
             "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
             "binding": b["binding"]}
        out["variants"][name] = r
        print(f"{name:7s}: {ms:9.3f} ms/sweep  {ca / ms * 1e3:.3e} "
              f"cells*angles/s  maxrelerr={err:.2e}; plain {plain_ms:.3f} ms,"
              f" vs plain maxrelerr {r['max_rel_err_vs_plain']:.2e}, max "
              f"elementwise rel {err_rel:.3e}; bound {b['bound_ms']:.4f} ms "
              f"({b['binding']}), {100 * b['bound_ms'] / ms:.2f}% of it")
        del jv, j_plain
    out["sass_variants"] = variant_sass()
    print("SASS of the variants' innermost loops: " + "; ".join(
        f"{k} {m['fp32_per_mufu']:.3g} FP32/MUFU ({m['mufu']} MUFU)"
        for k, m in out["sass_variants"].items()))
    print(json.dumps({"exp_sweep_variants": out}))
    return out


if __name__ == "__main__":
    main()
