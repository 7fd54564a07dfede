"""The port's benchmark on one CUDA device: one JSON line per kind.

    python3 -m radiativetransfer_tpu_torch.bench

Port of the JAX package's bench.py.  With no BENCH_KIND it runs all three
kinds and prints three lines, in this order:

  sweep  the full 192-direction (level 3) three-band sweep of a 256^3
         lognormal opacity field through the CUDA kernel, clamped logmean,
         in cells*angles/s; with its roofline fields (BENCH_ROOFLINE=1, the
         default): the compulsory bytes against the published 3.35 TB/s,
         the exp rates of the probe kernel (the bench's 8-deep chain and
         the 64-deep one the bound uses) and the sweep kernel's bound;
  rays   the point-source tracer alone: 8 sources on a 128^3 grid,
         maxPixelLevel 6, quadrature deposits, in rays/s;
  step   the full mode-8 iteration (tracer + 192-direction sweep +
         equilibrium chemistry) at 128^3 with 8 sources, in cells/s, with
         the seconds per iteration as vs_baseline.

Environment knobs (the JAX bench's names): BENCH_KIND, BENCH_N, BENCH_LEVEL,
BENCH_REPS, BENCH_SOURCES, BENCH_RAYS_MODE, BENCH_BANDS, BENCH_LOGMEAN,
BENCH_ROOFLINE.  Each time is the least over BENCH_REPS runs after a
warm-up, on the host clock around work that ends in
torch.cuda.synchronize().  Needs a CUDA device; every line names the card
and its power limit.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from .constants import KPC, MYR
from .roofline_sweep import bench_kappa, nvidia_smi

# the JAX bench's per-chip target, 1e9 cells*angles/s (BASELINE.md)
TARGET_CELLS_ANGLES_PER_S = 1.0e9
KINDS = ("sweep", "rays", "step")
DEVICE = "cuda"


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def _best_s(run, reps: int) -> float:
    """Least wall time of run() over reps runs after one warm-up."""
    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return min(times)


def bench_sources(n: int, n_src: int):
    """n_src sources from seed 0 in the central [0.3, 0.7]^3, snapped to
    cell centres, one SED bucket."""
    from .core import rays
    rng = np.random.default_rng(0)
    pos = (np.floor(rng.uniform(0.3, 0.7, (n_src, 3)) * n) + 0.5) / n
    return rays.SourceBatch(position=pos, weight=np.ones(n_src),
                            table_idx=np.zeros(n_src, np.int32))


def bench_sweep(smi: str) -> dict:
    from .core import probes_cuda, sweep, sweep_cuda

    n = _env_int("BENCH_N", 256)
    level = _env_int("BENCH_LEVEL", 3)
    reps = _env_int("BENCH_REPS", 3)
    logmean = os.environ.get("BENCH_LOGMEAN", "clamped")
    kappa = bench_kappa(n)
    cell = (2000.0 / n) * KPC
    uvb = np.array([1e-21, 5e-22, 1e-22])
    plan = sweep.build_sweep_plan(level, n)
    ndir = plan.n_directions

    dt = _best_s(lambda: sweep_cuda.diffuse_sweep_kernel(
        kappa, plan, uvb, cell, logmean), reps)
    value = n ** 3 * ndir / dt
    record = {
        "metric": f"sweep cells*angles/s ({n}^3 grid, {ndir} directions, "
                  f"3 bands, cuda kernel, {logmean} logmean, "
                  f"{torch.cuda.get_device_name(0)})",
        "value": value,
        "unit": "cells*angles/s",
        "vs_baseline": value / TARGET_CELLS_ANGLES_PER_S,
        "card": smi,
    }
    if os.environ.get("BENCH_ROOFLINE", "1") == "1":
        counts = sweep_cuda.work_counts(plan)
        x = kappa * cell
        per_s = {}
        for body, depth in (probes_cuda.EXP8, ("exp", 64)):
            ms = probes_cuda.time_ms(
                lambda: probes_cuda.chain(x, body, depth), reps=10)
            per_s[depth] = x.numel() * depth / (ms * 1e-3)
        b = probes_cuda.sweep_bound(counts, per_s[64])
        record.update({
            "compulsory_gb": counts["bytes"] / 1e9,
            "pct_hbm_roofline": 100 * counts["bytes"] / dt
            / probes_cuda.HBM_BYTES_PER_S,
            "wrapper_gb": counts["wrapper_bytes"] / 1e9,
            "exps": counts["exps"],
            "exp8_per_s": per_s[8],
            "exp_per_s": per_s[64],
            "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"],
            "bound_set_by": b["binding"],
            "pct_of_bound": 100 * b["bound_ms"] / (dt * 1e3),
        })
    return record


def _rays_tables(n: int, device) -> dict:
    """blackbody_population(q_ionizing=1e51) tables at age 0, normalized
    by the cell volume of a 2000 kpc box like StellarContext, float32."""
    from .tables import stellar
    pop = stellar.blackbody_population(q_ionizing=1.0e51)
    t = stellar.build_source_tables(pop, 0, 0.0, 0, 0.0)
    log_vol = float(np.log((2000.0 / n) * KPC) * 3)
    quad_a, quad_w = stellar.quadrature_arrays(pop, 0, 0.0, 0, 0.0)
    host = {"reaction_log": (t.reaction_log - log_vol)[None],
            "energy_log": (t.energy_log - log_vol)[None],
            "quad_A": quad_a,
            "quad_W": (quad_w / np.exp(log_vol))[None],
            "output_sigma24": t.output_sigma24,
            "output_sigma25": t.output_sigma25,
            "output_sigma26": t.output_sigma26,
            "output_sigma_dust": t.output_sigma_dust}
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device)
            for k, v in host.items()}


def bench_rays(smi: str) -> dict:
    from .core import rays
    from .core.state import GridGeometry, uniform_state

    n = _env_int("BENCH_N", 128)
    n_src = _env_int("BENCH_SOURCES", 8)
    reps = _env_int("BENCH_REPS", 3)
    rates_mode = os.environ.get("BENCH_RAYS_MODE", "quadrature")
    n_bands = _env_int("BENCH_BANDS", 3)
    tables = _rays_tables(n, DEVICE)
    src = bench_sources(n, n_src)
    geom = GridGeometry(n, n, n, 2000.0 * KPC)
    state = uniform_state(n, nh=2e-4, tgas=1.5e4, dtype=torch.float32,
                          device=DEVICE)
    dt = _best_s(lambda: rays.trace_point_sources(
        state, geom, src, tables, max_pixel_level=6, dtype=torch.float32,
        rates_mode=rates_mode, n_bands=n_bands), reps)
    # rays at the final level dominate; count total ray-phase slots
    total_rays = n_src * sum(12 * 4 ** (lv - 1) for lv in range(1, 7))
    value = total_rays / dt
    return {
        "metric": f"point-source rays/s ({n}^3 grid, {n_src} sources, "
                  f"maxPixelLevel 6, {rates_mode} rates, "
                  f"{torch.cuda.get_device_name(0)})",
        "value": value,
        "unit": "rays/s",
        "vs_baseline": value / 1.0e6,
        "seconds": dt,
        "card": smi,
    }


def bench_step(smi: str) -> dict:
    from .config import MODE_BOTH_STELLAR_UVB_TRANSFER, RunConfig
    from .core.state import GridGeometry, uniform_state
    from .core.step import RTModel, StellarContext
    from .tables import stellar

    n = _env_int("BENCH_N", 128)
    level = _env_int("BENCH_LEVEL", 3)
    n_src = _env_int("BENCH_SOURCES", 8)
    reps = _env_int("BENCH_REPS", 3)
    cfg = RunConfig(mode=MODE_BOTH_STELLAR_UVB_TRANSFER,
                    current_redshift=6.55, n_angular_level=level,
                    reionization_model=10, grid="bench")
    geom = GridGeometry(n, n, n, 2000.0 * KPC)
    model = RTModel.setup(cfg, geom, torch.float32, DEVICE)
    ctx = StellarContext.build(
        stellar.blackbody_population(q_ionizing=1.0e51),
        bench_sources(n, n_src), geom, 10.0 * MYR, metal_coefs=[(0, 0.0)],
        dtype=torch.float32, device=DEVICE)
    step = model.make_step(stellar=ctx)
    state = uniform_state(n, nh=2e-4, tgas=1.5e4, dtype=torch.float32,
                          device=DEVICE)
    dt = _best_s(lambda: step(state), reps)
    ndir = 12 * 4 ** (level - 1)
    return {
        "metric": f"full mode-8 step cells/s ({n}^3, {ndir} directions, "
                  f"{n_src} sources, f32, {torch.cuda.get_device_name(0)})",
        "value": n ** 3 / dt,
        "unit": "cells/s",
        "vs_baseline": dt,   # seconds per full iteration
        "card": smi,
    }


def main() -> list[dict]:
    if not torch.cuda.is_available():
        raise SystemExit("bench needs a CUDA device")
    kind = os.environ.get("BENCH_KIND")
    if kind is not None and kind not in KINDS:
        raise SystemExit(f"BENCH_KIND must be one of {KINDS}, got {kind!r}")
    smi = nvidia_smi()
    run = {"sweep": bench_sweep, "rays": bench_rays, "step": bench_step}
    records = []
    for k in (kind,) if kind else KINDS:
        records.append(run[k](smi))
        print(json.dumps(records[-1]), flush=True)
    return records


if __name__ == "__main__":
    main()
