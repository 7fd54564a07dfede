"""Sweep-kernel op-count experiments on one CUDA device.

    python3 -m radiativetransfer_tpu_torch.exp_sweep_variants

Port of the JAX package's scripts/exp_sweep_variants.py.  Runs each lean
variant on the cluster kernel's design (csrc/sweep_cluster_exp.cu,
variants_cuda.lean_sweep, in choose_variant_cluster's shape):

  lean     act-folded 16-slot tables: lm from i_out - i_in, no masks
  clamp    lean with the clamped branch-free logmean
  clamp2   clamp with exp2f on lengths pre-scaled by log2 e
  seg1     chain segments 2 and 3 left out, with their barriers (what do
           they cost?)
  noemi    the logmean left out (what does the emissivity cost?)
  noshift  the upwind shifts left out, with their barriers and distributed
           shared memory reads (what do the in-plane neighbours cost?)

Each is timed in turns with its yardsticks: the plane kernel
(csrc/sweep_variants.cu, one CTA per direction and band: plane, variant,
variant, plane) and the cluster kernel's merged-sweep instance in the same
launch shape (clamped for clamp and clamp2, exact for the others).  Then
the attribution: each part variant in turns with its full variant in the
full variant's shape (lean, noemi, noemi, lean; likewise seg1 and noshift
against lean, clamp2 against clamp), each difference what the part costs
on this design.  Prints ms per sweep and cells*angles/s (CUDA events),
maxrelerr against the shipped sweep (`ship`: sweep_cuda.
diffuse_sweep_kernel, exact logmean) for lean, clamp and clamp2 (NaN for
the attribution variants, which compute other functions), the plain
version's time and both kernels' error against it, each one's bound, and
the FP32 instructions per MUFU in the SASS: of the expf and exp2f chain
probes (csrc/probes.cu) and of each variant's innermost loop in both
kernels, and every launch shape of each variant with its time.  EXP_N (default 256), EXP_LEVEL (default 3) and EXP_VARIANTS (default all,
comma-separated) set the run.  Needs a CUDA device; prints the card's name
and power limit.
"""

from __future__ import annotations

import functools
import json
import os

import torch

from .constants import KPC
from .core import (
    cuda_build,
    probes_cuda,
    sweep,
    sweep_cluster,
    sweep_cuda,
    variants_cuda,
)
from .exp_sweep_pair import (
    REPS,
    UVB,
    exp_kappa,
    in_turns,
    max_rel_to_peak,
    print_table,
    shape_dict,
    shape_table,
)
from .roofline_sweep import nvidia_smi, sass_per_step

# each attribution variant and the full variant it is timed against: what
# their difference measures (PERF.md)
ATTRIBUTION = {"noemi": "lean",     # the emissivity
               "seg1": "lean",      # segments 2 and 3, with their barriers
               "noshift": "lean",   # the shifts, barriers and DSMEM reads
               "clamp2": "clamp"}   # expf's range reduction against exp2f


def variant_sass() -> dict:
    """FP32 instructions per MUFU of each variant's innermost loop, in the
    plane kernel's shared-memory and global-scratch instances (built
    sweep_variants library) and the cluster instances of each (G, cells per
    thread) (built sweep_cluster_exp library)."""
    out = {}
    mix = probes_cuda.sass_loop_mix(cuda_build.sass("sweep_variants"))
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
    mix = probes_cuda.sass_loop_mix(cuda_build.sass("sweep_cluster_exp"))
    for variant in variants_cuda.VARIANTS:
        mode = sweep_cluster.MODES.index(variant)
        for group in sweep_cluster.EXP_GROUP_SIZES:
            for cpt in sweep_cluster.EXP_CELLS_PER_THREAD:
                tag = (f"sweep_variant_cluster_kernelIfLi{mode}ELi{group}"
                       f"ELi{cpt}E")
                hit = [c for name, c in mix.items() if tag in name]
                if hit:
                    out[f"{variant}_cluster_G{group}x{cpt}"] = \
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
           "sass_probes": sass, "variants": {}, "attribution": {}}

    def variant(name, shape=None):
        shape = shape or variants_cuda.choose_variant_cluster(
            n, kappa.dtype, name)
        return functools.partial(variants_cuda.cluster_kernel, kappa, plan,
                                 UVB, cell, name, shape)

    for name in names:
        rule = variants_cuda.choose_variant_cluster(n, kappa.dtype, name)
        if rule is None:
            raise ValueError(f"no {name} cluster shape fits a {n}^3 plane")
        run = variant(name)
        plane = functools.partial(variants_cuda.lean_sweep_plane_kernel,
                                  kappa, plan, UVB, cell, name)
        yard = ("clamped" if variants_cuda.flags(name)["clamped"]
                else "exact")
        merged = functools.partial(sweep_cluster.diffuse_sweep_cluster_kernel,
                                   kappa, plan, UVB, cell, yard, rule)
        jv = run()
        err = (max_rel_to_peak(jv, j_ref)
               if name in variants_cuda.FULL_VARIANTS else float("nan"))
        vs_plane = in_turns(plane, run)
        vs_merged = in_turns(merged, run)
        t = vs_plane["turns"] + vs_merged["turns"]
        ms = (t[1] + t[2] + t[5] + t[6]) / 4
        j_plain = variants_cuda.lean_sweep_reference(kappa, plan, UVB, cell,
                                                     name)
        plain_ms = probes_cuda.time_ms(
            lambda name=name: variants_cuda.lean_sweep_reference(
                kappa, plan, UVB, cell, name), 1, warmup=False)
        b = bound_for(plan, name, fp32_per_exp2)
        err_abs, err_rel = probes_cuda.rel_err(jv, j_plain)
        plane_abs, plane_rel = probes_cuda.rel_err(plane(), j_plain)
        r = {"rule": shape_dict(rule), "ms": ms,
             "plane_ms": vs_plane["yardstick_ms"],
             "merged_ms": vs_merged["yardstick_ms"], "merged": yard,
             "turns": {"plane": vs_plane["turns"],
                       "merged": vs_merged["turns"]},
             "plain_ms": plain_ms, "max_rel_err_vs_ship": err,
             "max_abs_err": err_abs, "max_rel_err": err_rel,
             "max_rel_err_vs_plain": max_rel_to_peak(jv, j_plain),
             "plane_max_abs_err": plane_abs, "plane_max_rel_err": plane_rel,
             "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
             "binding": b["binding"]}
        out["variants"][name] = r
        print(f"{name:7s}: {ms:9.3f} ms/sweep  {ca / ms * 1e3:.3e} "
              f"cells*angles/s  maxrelerr={err:.2e} (C {rule.csize} G "
              f"{rule.group}, {rule.threads} x {rule.cpt}); in turns with "
              f"the plane kernel {', '.join(f'{x:.3f}' for x in t[:4])}, "
              f"with the merged sweep's {yard} instance in the same shape "
              f"{', '.join(f'{x:.3f}' for x in t[4:])} ms; plain "
              f"{plain_ms:.3f} ms, vs plain maxrelerr "
              f"{r['max_rel_err_vs_plain']:.2e}, max elementwise rel "
              f"{err_rel:.3e} (plane kernel {plane_rel:.3e}); bound "
              f"{b['bound_ms']:.4f} ms ({b['binding']}), "
              f"{100 * b['bound_ms'] / ms:.2f}% of it (plane kernel "
              f"{100 * b['bound_ms'] / r['plane_ms']:.2f}%)")
        r["table"] = shape_table(kappa, plan, cell, name)
        print_table(f"{name} {n}^3", r["table"], smi)
        del jv, j_plain

    # the attribution: a part variant in turns with its full variant, both
    # in the full variant's launch shape
    for part, full in ATTRIBUTION.items():
        if part not in names or full not in names:
            continue
        shape = variants_cuda.choose_variant_cluster(n, kappa.dtype, full)
        a = in_turns(variant(full, shape), variant(part, shape))
        res = {"full": full, "full_ms": a["yardstick_ms"],
               "part_ms": a["ms"], "diff_ms": a["yardstick_ms"] - a["ms"],
               "turns": a["turns"], "shape": shape_dict(shape)}
        out["attribution"][part] = res
        print(f"{full} - {part} (C {shape.csize} G {shape.group}, "
              f"{shape.threads} x {shape.cpt}), in turns "
              f"{', '.join(f'{x:.3f}' for x in a['turns'])} ms: "
              f"{res['diff_ms']:.3f} ms, "
              f"{100 * res['diff_ms'] / res['full_ms']:.1f}% of {full}")
    out["sass_variants"] = variant_sass()
    print("SASS of the variants' innermost loops: " + "; ".join(
        f"{k} {m['fp32_per_mufu']:.3g} FP32/MUFU ({m['mufu']} MUFU)"
        for k, m in out["sass_variants"].items()))
    print(json.dumps({"exp_sweep_variants": out}))
    return out


if __name__ == "__main__":
    main()
