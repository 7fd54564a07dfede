"""Sweep dataflow experiment on one CUDA device: two slabs per step.

    python3 -m radiativetransfer_tpu_torch.exp_sweep_pair

Port of the JAX package's scripts/exp_sweep_pair.py.  The pair sweep walks
two slabs per loop trip with the merged sweep's arithmetic (the exact
logmean).  Its kernel is the cluster kernel's pair instance
(csrc/sweep_cluster_exp.cu, variants_cuda.sweep_pair, in
choose_variant_cluster's shape); it is timed in turns with its two
yardsticks: the plane kernel (csrc/sweep_variants.cu, one CTA per
direction and band: plane, pair, pair, plane) and the cluster kernel's
exact instance in the same launch shape (exact, pair, pair, exact), whose
loop walks one slab a trip.  Beside them: the shipped sweep (`ship`:
sweep_cuda.diffuse_sweep_kernel, exact logmean, in its own size rule's
shape), the plain version's time, each kernel's error against the plain
version and the pair's against ship, its bound, and every launch shape
of the pair with its time and resident clusters.  EXP_N
(default 256) and EXP_LEVEL (default 3, 192 directions) set the shape; the
field is the script's 10**U(-26, -20) from seed 0.  Times are CUDA events.
Needs a CUDA device; prints the card's name and power limit.
"""

from __future__ import annotations

import functools
import json
import os

import numpy as np
import torch

from .constants import KPC
from .core import probes_cuda, sweep, sweep_cluster, sweep_cuda, variants_cuda
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


def in_turns(yardstick, kernel, reps: int = REPS) -> dict:
    """A kernel timed in turns with its yardstick (yardstick, kernel,
    kernel, yardstick), each turn the mean of reps runs after a warm-up:
    the four times and each one's mean."""
    turns = [probes_cuda.time_ms(fn, reps)
             for fn in (yardstick, kernel, kernel, yardstick)]
    return {"turns": turns, "yardstick_ms": (turns[0] + turns[3]) / 2,
            "ms": (turns[1] + turns[2]) / 2}


def shape_table(kappa, plan, cell, mode: str) -> list:
    """Every launch shape of one experiment's cluster instances: its time
    (3 runs after a warm-up), resident clusters, work items and waves."""
    meta = sweep_cuda.kernel_tables(plan, cell, kappa.dtype,
                                    kappa.device)[1].cpu().numpy()
    rule = variants_cuda.choose_variant_cluster(plan.nslab, kappa.dtype, mode)
    table = []
    for shape in variants_cuda.variant_shapes(plan.nslab, kappa.dtype, mode):
        items = len(sweep_cluster.work_items(meta, shape.group))
        resident = variants_cuda.resident_variant_clusters(kappa, plan, cell,
                                                           mode, shape)
        ms = probes_cuda.time_ms(functools.partial(
            variants_cuda.cluster_kernel, kappa, plan, UVB, cell, mode,
            shape), 3)
        table.append({"C": shape.csize, "G": shape.group, "cpt": shape.cpt,
                      "threads": shape.threads, "smem": shape.smem,
                      "items": items, "resident_clusters": resident,
                      "waves": items / resident, "ms": ms,
                      "rule": shape == rule})
    return table


def print_table(label: str, table: list, smi: str) -> None:
    for r in table:
        print(f"{label} (C, G) = ({r['C']}, {r['G']}){' rule' * r['rule']}: "
              f"{r['ms']:.3f} ms, {r['threads']} threads x {r['cpt']} "
              f"cells, {r['smem']} B shared, {r['items']} items, "
              f"{r['resident_clusters']} resident clusters, "
              f"{r['waves']:.2f} waves; card {smi}")


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
    rule = variants_cuda.choose_variant_cluster(n, kappa.dtype, "pair")
    if rule is None:
        raise ValueError(f"no pair cluster shape fits a {n}^3 plane")
    print(f"device={torch.cuda.get_device_name(0)} n={n} level={level} "
          f"card {smi}; pair shape C {rule.csize} G {rule.group}, "
          f"{rule.threads} x {rule.cpt}")

    pair = functools.partial(variants_cuda.cluster_kernel, kappa, plan, UVB,
                             cell, "pair", rule)
    plane = functools.partial(variants_cuda.sweep_pair_plane_kernel, kappa,
                              plan, UVB, cell)
    # the merged sweep's instance in the pair's launch shape (its own
    # shared memory: the launch takes C, G, cells and threads)
    exact = functools.partial(sweep_cluster.diffuse_sweep_cluster_kernel,
                              kappa, plan, UVB, cell, "exact", rule)
    ship = functools.partial(sweep_cuda.diffuse_sweep_kernel, kappa, plan,
                             UVB, cell, "exact")
    j_ref, j_pair = ship(), pair()
    err = max_rel_to_peak(j_pair, j_ref)
    print(f"pair-vs-ship maxrelerr = {err:.2e}")
    ship_ms = probes_cuda.time_ms(ship, REPS)
    vs_plane = in_turns(plane, pair)
    vs_exact = in_turns(exact, pair)
    t = vs_plane["turns"] + vs_exact["turns"]
    pair_ms = (t[1] + t[2] + t[5] + t[6]) / 4
    print(f"ship: {ship_ms:9.3f} ms/sweep  {ca / ship_ms * 1e3:.3e} "
          f"cells*angles/s")
    print(f"pair: {pair_ms:9.3f} ms/sweep  {ca / pair_ms * 1e3:.3e} "
          f"cells*angles/s; in turns with the plane kernel "
          f"{', '.join(f'{x:.3f}' for x in vs_plane['turns'])} ms, with the "
          f"cluster kernel's exact instance in the same shape "
          f"{', '.join(f'{x:.3f}' for x in vs_exact['turns'])} ms")

    # the plain version once, on the same field: its time and each kernel's
    # error against it
    j_plain = variants_cuda.sweep_pair_reference(kappa, plan, UVB, cell)
    plain_ms = probes_cuda.time_ms(lambda: variants_cuda.sweep_pair_reference(
        kappa, plan, UVB, cell), 1, warmup=False)
    bound = probes_cuda.sweep_bound(sweep_cuda.work_counts(plan),
                                    probes_cuda.MUFU_PER_S)
    err_abs, err_rel = probes_cuda.rel_err(j_pair, j_plain)
    plane_abs, plane_rel = probes_cuda.rel_err(plane(), j_plain)
    out = {"n": n, "directions": ndir, "card": smi, "ship_ms": ship_ms,
           "rule": shape_dict(rule), "ms": pair_ms,
           "plane_ms": vs_plane["yardstick_ms"],
           "exact_ms": vs_exact["yardstick_ms"],
           "turns": {"plane": vs_plane["turns"], "exact": vs_exact["turns"]},
           "plain_ms": plain_ms, "max_rel_err_vs_ship": err,
           "max_abs_err": err_abs, "max_rel_err": err_rel,
           "max_rel_err_vs_plain": max_rel_to_peak(j_pair, j_plain),
           "plane_max_abs_err": plane_abs, "plane_max_rel_err": plane_rel,
           "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"]}
    print(f"pair plain version: {plain_ms:.3f} ms; pair vs plain max abs "
          f"{err_abs:.3e}, max elementwise rel {err_rel:.3e} (maxrelerr "
          f"{out['max_rel_err_vs_plain']:.2e}); the plane kernel vs plain "
          f"max rel {plane_rel:.3e}; bound {bound['bound_ms']:.4f} ms set by "
          f"{bound['binding']}: pair {100 * bound['bound_ms'] / pair_ms:.2f}%"
          f", plane kernel "
          f"{100 * bound['bound_ms'] / out['plane_ms']:.2f}%, exact "
          f"instance {100 * bound['bound_ms'] / out['exact_ms']:.2f}%")
    out["table"] = shape_table(kappa, plan, cell, "pair")
    print_table(f"pair {n}^3", out["table"], smi)
    print(json.dumps({"exp_sweep_pair": out}))
    return out


def shape_dict(shape: sweep_cluster.ClusterShape) -> dict:
    return {"C": shape.csize, "G": shape.group, "cpt": shape.cpt,
            "threads": shape.threads, "smem": shape.smem}


if __name__ == "__main__":
    main()
