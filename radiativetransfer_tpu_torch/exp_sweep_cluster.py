"""The cluster sweep kernel's launch shapes on the card.

    python -m radiativetransfer_tpu_torch.exp_sweep_cluster

For each n of EXP_NS (default "128 256") in float32 and of EXP_F64_NS
(default "128") in float64, at angular level EXP_LEVEL (default 3, 192
directions), the clamped logmean, on phase 6's lognormal field of
chip_smoke.py: csrc/sweep_merged.cu's plane kernel and
csrc/sweep_cluster.cu's cluster kernel in the size rule's shape timed in
turns (plane, cluster, cluster, plane), then every launch shape of the
cluster kernel that fits.  For each shape its time, resident clusters
(cudaOccupancyMaxActiveClusters), work items and waves; beside them, in
float32, the plain version's time and the sweep's bound.  Prints the
card's name and power limit, a line per shape and one JSON line; needs a
CUDA device.
"""

from __future__ import annotations

import functools
import json
import os

import numpy as np
import torch

from .constants import KPC
from .core import probes_cuda, sweep, sweep_cluster, sweep_cuda
from .roofline_sweep import nvidia_smi

UVB = np.array([1.0, 0.5, 0.25])


def field(n: int, dtype=torch.float32) -> torch.Tensor:
    """chip_smoke.py's lognormal opacity field (seed 42, 0.7 per kpc)."""
    rng = np.random.default_rng(42)
    return torch.tensor(rng.lognormal(0, 1, (3, n, n, n)) * 0.7 / KPC,
                        dtype=dtype, device="cuda")


def shapes_at(n: int, dtype=torch.float32) -> list:
    """The size rule's shape first, then every other launch shape that fits
    an n^3 plane."""
    rule = sweep_cluster.choose_cluster(n, n, dtype)
    out = [rule] if rule else []
    for csize in sweep_cluster.CLUSTER_SIZES:
        for group in sweep_cluster.GROUP_SIZES:
            out += [s for s in sweep_cluster.cluster_shapes(n, n, dtype,
                                                            csize, group)
                    if s != rule]
    return out


def _ns(name: str, default: str) -> tuple[int, ...]:
    return tuple(int(x) for x in os.environ.get(name, default).split())


def measure(n: int, level: int, dtype, smi: str) -> dict:
    """One size and dtype: the turns, the shapes' table and, in float32,
    the plain version's time and the bound."""
    plan = sweep.build_sweep_plan(level, n)
    kappa = field(n, dtype)
    ca = n ** 3 * plan.n_directions
    rule = sweep_cluster.choose_cluster(n, n, dtype)
    if rule is None:
        raise ValueError(f"no cluster shape fits a {n}^3 {dtype} plane")
    time_ms = probes_cuda.time_ms
    label = f"{n}^3 {'f32' if dtype == torch.float32 else 'f64'}"

    def plane():
        return sweep_cuda.diffuse_sweep_plane_kernel(kappa, plan, UVB, KPC,
                                                     "clamped")

    def cluster(shape):
        return sweep_cluster.diffuse_sweep_cluster_kernel(
            kappa, plan, UVB, KPC, "clamped", shape)

    rule_run = functools.partial(cluster, rule)
    turns = [time_ms(fn, reps=5) for fn in (plane, rule_run, rule_run, plane)]
    plane_ms = (turns[0] + turns[3]) / 2
    cluster_ms = (turns[1] + turns[2]) / 2
    meta = sweep_cuda.kernel_tables(plan, KPC, dtype,
                                    kappa.device)[1].cpu().numpy()
    table = []
    for shape in shapes_at(n, dtype):
        items = len(sweep_cluster.work_items(meta, shape.group))
        resident = sweep_cluster.resident_clusters(kappa, plan, KPC, shape)
        ms = (cluster_ms if shape == rule
              else time_ms(functools.partial(cluster, shape), reps=3))
        table.append({"C": shape.csize, "G": shape.group, "cpt": shape.cpt,
                      "threads": shape.threads, "smem": shape.smem,
                      "items": items, "resident_clusters": resident,
                      "waves": items / resident, "ms": ms,
                      "rule": shape == rule})
    out = {"plane_ms": plane_ms, "cluster_ms": cluster_ms, "turns": turns,
           "table": table}
    share = ""
    if dtype == torch.float32:
        bound = probes_cuda.sweep_bound(sweep_cuda.work_counts(plan),
                                        probes_cuda.MUFU_PER_S)
        out["plain_ms"] = time_ms(
            lambda: sweep_cuda.diffuse_sweep_merged_reference(
                kappa, plan, UVB, KPC, "clamped"), reps=1, warmup=False)
        out["bound_ms"] = bound["bound_ms"]
        out["bound_by"] = bound["bound_by"]
        share = (f" ({100 * bound['bound_ms'] / cluster_ms:.1f}% of the "
                 f"{bound['bound_ms']:.4f} ms FP32 bound; plane "
                 f"{100 * bound['bound_ms'] / plane_ms:.1f}%); plain "
                 f"{out['plain_ms']:.3f} ms")
    print(f"sweep {label} x {plan.n_directions} dirs clamped, in turns: "
          f"plane kernel ({sweep_cuda.plane_memory_for(n, dtype)} planes) "
          f"{turns[0]:.3f} ms, cluster kernel (C {rule.csize} G "
          f"{rule.group}, {rule.threads} x {rule.cpt}) {turns[1]:.3f}, "
          f"{turns[2]:.3f}, plane {turns[3]:.3f} ({plane_ms / cluster_ms:.2f}"
          f"x); cluster {ca / cluster_ms * 1e3:.4e} cells*angles/s, plane "
          f"{ca / plane_ms * 1e3:.4e}{share}; card {smi}")
    for r in table:
        print(f"{label} (C, G) = ({r['C']}, {r['G']}){' rule' * r['rule']}: "
              f"{r['ms']:.3f} ms, {r['threads']} threads x {r['cpt']} cells, "
              f"{r['smem']} B shared, {r['items']} items, "
              f"{r['resident_clusters']} resident clusters "
              f"({r['resident_clusters'] * r['C']} CTAs), {r['waves']:.2f} "
              f"waves; card {smi}")
    return out


def main(ns=None, level: int | None = None, f64_ns=None) -> dict:
    """{"card": ..., n: float32 results, "f64": {n: float64 results}}."""
    if not torch.cuda.is_available():
        raise SystemExit("exp_sweep_cluster needs a CUDA device")
    ns = ns or _ns("EXP_NS", "128 256")
    f64_ns = _ns("EXP_F64_NS", "128") if f64_ns is None else f64_ns
    level = level or int(os.environ.get("EXP_LEVEL", "3"))
    smi = nvidia_smi()
    out = {"card": smi, "f64": {}}
    for n in ns:
        out[n] = measure(n, level, torch.float32, smi)
    for n in f64_ns:
        out["f64"][n] = measure(n, level, torch.float64, smi)
    print(json.dumps({"exp_sweep_cluster": out}))
    return out


if __name__ == "__main__":
    main()
