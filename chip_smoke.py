#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA device (an H100).

    python3 chip_smoke.py          # from the root of the repository

Drives radiativetransfer_tpu_torch's paths through their public entry
points -- mode 9 (UVB-only diffuse transfer + equilibrium chemistry), mode
8 (point sources + UVB), the roofline script and the bench -- and holds
each hand-written kernel against its plain PyTorch version.  Phases, one
line or more each; any failure raises and the script exits non-zero:

1. probe: torch, CUDA, the device, its power limit, nvcc, triton;
2. build both kernel sources from radiativetransfer_tpu_torch/csrc/, one
   nvcc each, started together (timed);
3. sweep kernel vs plain version on the device, float32 (and float64), both
   logmean forms, both plane memories, up to 128^3 x 192 directions;
4. the 24^3 mode-9 anchor: one f32 step, neutral fraction 0.044220 +-1e-4;
5. the mode-9 path at 128^3 x 192 directions: initialize_equilibrium and 3
   steps, each timed, with the kernel's launch count; step 1 against the
   plain slab scan;
6. the sweep alone at 128^3 and 256^3 x 192 directions, kernel and plain
   version, in cells*angles/s;
7. the probe kernel vs its plain version for every body at 64^3, then the
   roofline script (python -m radiativetransfer_tpu_torch.roofline_sweep)
   at 256^3: stream GB/s, the exp, div and fma rates, the sweep's bound;
   every probe's output at 256^3 against its plain version's there, and
   the bounds' per-step instruction counts against the kernel's SASS;
8. the 24^3 mode-8 anchor: one f32 step, neutral fraction 0.033307 +-1e-4,
   exactly one sweep launch;
9. the mode-8 path at 128^3 x 192 directions with 8 sources: 3 steps, each
   timed, the tracer timed apart, peak device memory, the sweep's launch
   count; step 1 against the plain slab scan;
10. the port's bench (python -m radiativetransfer_tpu_torch.bench): its
    three JSON lines, sweep, rays and step;
11. the per-zone sweep (diffuse_sweep_zones_kernel, kernel #2) against the
    plain slab scan at level 1 n 8 and level 2 n 6 (f32, f64), and at 128^3
    x 192 against its plain version and the slab scan, one launch per zone;
    the 24 zone kernels timed alone on fields rotated beforehand, beside
    the wrapper with its rotations and the merged kernel;
12. the two-slab sweep (kernel #6) against its plain version at 64^3 and
    128^3 x 192, then python -m radiativetransfer_tpu_torch.exp_sweep_pair
    at 256^3, where the kernel's global-scratch planes are held to its
    plain version too;
13. every lean variant (kernel #7) against its plain version at 64^3 and
    128^3 x 192, then python -m radiativetransfer_tpu_torch.
    exp_sweep_variants at 256^3, every variant held to its plain version
    there too, with the FP32 instructions per MUFU of expf and exp2f in
    the SASS checked against the bounds' counts;
14. the row scatter (kernel #8) through python -m
    radiativetransfer_tpu_torch.exp_row_scatter: against a float64
    np.add.at and index_add_ at every M, beside index_add_'s times.

The last lines are the card's name and power limit, one JSON object of
every kernel's numbers, and {"ok": true, "device": {...}}.  Exits non-zero
without a CUDA device.  Needs no JAX and no network.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# the anchors: one f32 step, 24^3, 200 kpc, level 1, z = 6.55, reionization
# model 10, uniform nh = 1e-4, T = 2e4 (MULTICHIP_r05.json); mode 9, and
# mode 8 with 11 sources from seed 0 at maxPixelLevel 2
ANCHOR_NF = 0.044220
ANCHOR8_NF = 0.033307
ANCHOR_RTOL = 1e-4
# the main path's size: the 128^3 base grid of the production deep-AMR run
# at the reference's 192 directions; the sweep is also timed at 256^3
DEVICE = "cuda"
MAIN_N, MAIN_LEVEL = 128, 3
TIMING_NS = (128, 256)
# the probes' comparison size and the roofline's (the JAX scripts' N)
PROBE_N, ROOF_N = 64, 256
# the mode-8 path: bench.py::bench_step's configuration
MODE8_SOURCES = 8


def _rel_err(out: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max elementwise relative error, below 1e-30 of the
    largest element, and in float32 below 1e-30, held to absolute error at
    that floor)."""
    from radiativetransfer_tpu_torch.core.probes_cuda import rel_err
    return rel_err(out, ref)


def _kappa(n: int, dtype=torch.float32, seed: int = 42) -> torch.Tensor:
    from radiativetransfer_tpu_torch.constants import KPC
    rng = np.random.default_rng(seed)
    k = rng.lognormal(0, 1, (3, n, n, n)) * 0.7 / KPC
    return torch.tensor(k, dtype=dtype, device=DEVICE)


def phase_probe() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke test needs a CUDA device")
    from radiativetransfer_tpu_torch.core import cuda_build
    from radiativetransfer_tpu_torch.roofline_sweep import nvidia_smi
    smi = nvidia_smi()
    nvcc = cuda_build.find_nvcc()
    nvcc_version = subprocess.run([nvcc, "--version"], capture_output=True,
                                  text=True, check=True).stdout.strip()
    try:
        import triton
        triton_info = f"triton {triton.__version__} imports"
    except ImportError as e:
        triton_info = f"triton does not import ({e})"
    print(f"[1 probe] python {sys.version.split()[0]} torch "
          f"{torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"nvidia-smi: {smi}; {triton_info}")
    print(f"[1 probe] {nvcc}: {nvcc_version.splitlines()[-1]}")
    return smi


def phase_build() -> None:
    from radiativetransfer_tpu_torch.core import cuda_build
    t0 = time.perf_counter()
    cuda_build.build()
    dt = time.perf_counter() - t0
    names = ", ".join(cuda_build.library_path(n).name
                      for n in cuda_build.SOURCES)
    print(f"[2 build] {names} in {dt:.2f} s")
    for name, log in cuda_build.BUILD_LOG.items():
        for line in log.splitlines():
            if "ptxas info" in line and ("Used" in line
                                         or "Compiling" in line):
                print(f"[2 build] {name}: {line.strip()}")


def phase_kernel_vs_plain() -> dict:
    from radiativetransfer_tpu_torch.constants import KPC
    from radiativetransfer_tpu_torch.core import sweep, sweep_cuda
    uvb = np.array([1.0, 0.5, 0.25])
    cases = []
    for level, n in [(1, 8), (2, 6)]:
        for lm in ("exact", "clamped"):
            for mem in ("shared", "global"):
                cases.append((level, n, torch.float32, lm, mem, 2e-6))
    cases.append((1, 8, torch.float64, "exact", "auto", 1e-12))
    for level, n, dtype, lm, mem, rtol in cases:
        kappa = _kappa(n, dtype)
        plan = sweep.build_sweep_plan(level, n)
        out = sweep_cuda.diffuse_sweep_kernel(kappa, plan, uvb, KPC, lm,
                                              plane_memory=mem)
        torch.cuda.synchronize()
        ref = sweep_cuda.diffuse_sweep_merged_reference(kappa, plan, uvb, KPC,
                                                        lm)
        err_abs, err_rel = _rel_err(out, ref)
        print(f"[3 kernel] level {level} n {n} {dtype} {lm} {mem}: max abs "
              f"{err_abs:.3e} max rel {err_rel:.3e} (rtol {rtol:g})")
        assert err_rel <= rtol, (level, n, dtype, lm, mem, err_rel)

    # transparent box: Jmean == uvb in every cell and band
    n = 6
    plan = sweep.build_sweep_plan(1, n)
    kappa = torch.full((3, n, n, n), 1e-30, device=DEVICE)
    ref = torch.tensor(uvb, dtype=torch.float32, device=DEVICE)[
        :, None, None, None].expand(3, n, n, n)
    for lm, tol in (("exact", 1e-5), ("clamped", 2e-4)):
        out = sweep_cuda.diffuse_sweep_kernel(kappa, plan, uvb, KPC, lm)
        err_abs, err_rel = _rel_err(out, ref)
        print(f"[3 kernel] transparent box {lm}: max abs {err_abs:.3e} max "
              f"rel {err_rel:.3e} (tol {tol:g})")
        assert err_rel <= tol, (lm, err_rel)

    # the main path's shape; the tolerance covers 192-term atomic sums
    # taken in another order than the plain version's
    n, level = MAIN_N, MAIN_LEVEL
    plan = sweep.build_sweep_plan(level, n)
    kappa = _kappa(n)
    result = {}
    for lm in ("exact", "clamped"):
        out = sweep_cuda.diffuse_sweep_kernel(kappa, plan, uvb, KPC, lm)
        torch.cuda.synchronize()
        ref = sweep_cuda.diffuse_sweep_merged_reference(kappa, plan, uvb, KPC,
                                                        lm)
        err_abs, err_rel = _rel_err(out, ref)
        print(f"[3 kernel] {n}^3 x {plan.n_directions} dirs f32 {lm} "
              f"({sweep_cuda.plane_memory_for(n, torch.float32)} planes): "
              f"max abs {err_abs:.3e} max rel {err_rel:.3e} (tol 1e-5)")
        assert torch.isfinite(out).all() and err_rel <= 1e-5, (lm, err_rel)
        result[lm] = err_abs
    return result


def _rtmodel(n, level, box_kpc, device, **cfg_kw):
    import radiativetransfer_tpu_torch as rt
    from radiativetransfer_tpu_torch.config import MODE_UVB_TRANSFER_ONLY
    from radiativetransfer_tpu_torch.constants import KPC
    cfg = rt.RunConfig(mode=MODE_UVB_TRANSFER_ONLY, current_redshift=6.55,
                       n_angular_level=level, reionization_model=10,
                       **cfg_kw)
    geom = rt.GridGeometry(n, n, n, box_kpc * KPC)
    return rt.RTModel.setup(cfg, geom, torch.float32, device)


def phase_anchor() -> None:
    import radiativetransfer_tpu_torch as rt
    from radiativetransfer_tpu_torch.core import sweep_cuda
    model = _rtmodel(24, 1, 200.0, DEVICE)
    state = rt.uniform_state(24, nh=1e-4, tgas=2e4, dtype=torch.float32,
                             device=DEVICE)
    before = sweep_cuda.LAUNCHES
    out = model.transport_chemistry_step(state)
    nf = model.neutral_fraction(out)
    rel = abs(nf - ANCHOR_NF) / ANCHOR_NF
    print(f"[4 anchor] 24^3 level 1 f32 mode 9: neutral fraction {nf:.7f} "
          f"vs {ANCHOR_NF} (rel {rel:.2e}, tol {ANCHOR_RTOL:g}); kernel "
          f"launches {sweep_cuda.LAUNCHES - before}")
    assert sweep_cuda.LAUNCHES - before == 1
    assert rel <= ANCHOR_RTOL, (nf, rel)


def phase_main_path() -> int:
    from radiativetransfer_tpu_torch.core import sweep_cuda
    from radiativetransfer_tpu_torch.profile_step import galaxy_state
    n, level, box = MAIN_N, MAIN_LEVEL, 300.0
    model = _rtmodel(n, level, box, DEVICE, self_shielding_threshold_kpc=0.1)
    # the synthetic galaxy of examples/make_test_data.py at n^3: a
    # self-shielded core, so the sweep sees real structure
    state = galaxy_state(n, box, DEVICE)
    sweep_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    state = model.initialize_equilibrium(state)
    torch.cuda.synchronize()
    print(f"[5 main] {n}^3 x {model.sweep_plan.n_directions} dirs f32 mode "
          f"9: initialize_equilibrium {time.perf_counter() - t0:.3f} s, "
          f"neutral fraction {model.neutral_fraction(state):.7f}")
    init_state = state
    step = model.make_step()
    nfs = []
    for it in range(1, 4):
        before = sweep_cuda.LAUNCHES
        t0 = time.perf_counter()
        state = step(state)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        nf = model.neutral_fraction(state)
        nfs.append(nf)
        print(f"[5 main] step {it}: neutral fraction {nf:.7f} wall "
              f"{dt:.4f} s, sweep_cuda.LAUNCHES {sweep_cuda.LAUNCHES}")
        assert np.isfinite(nf) and 0.0 <= nf <= 1.0, nf
        assert bool(torch.isfinite(state.HI).all())
        assert sweep_cuda.LAUNCHES > before, "the step did not launch"
    launches = sweep_cuda.LAUNCHES

    scan = _rtmodel(n, level, box, DEVICE, self_shielding_threshold_kpc=0.1,
                    use_pallas_sweep=False)
    t0 = time.perf_counter()
    nf_scan = scan.neutral_fraction(scan.make_step()(init_state))
    dt = time.perf_counter() - t0
    rel = abs(nfs[0] - nf_scan) / nf_scan
    print(f"[5 main] step 1 with the plain slab scan (exact logmean): "
          f"neutral fraction {nf_scan:.7f} wall {dt:.3f} s; kernel step "
          f"rel {rel:.2e} (tol 1e-4)")
    assert rel <= 1e-4, (nfs[0], nf_scan)
    return launches


def phase_timings(smi: str) -> dict:
    from radiativetransfer_tpu_torch.constants import KPC
    from radiativetransfer_tpu_torch.core import sweep, sweep_cuda
    from radiativetransfer_tpu_torch.core.probes_cuda import time_ms
    uvb = np.array([1.0, 0.5, 0.25])
    out = {}
    for n in TIMING_NS:
        plan = sweep.build_sweep_plan(MAIN_LEVEL, n)
        kappa = _kappa(n)
        ms = time_ms(lambda: sweep_cuda.diffuse_sweep_kernel(
            kappa, plan, uvb, KPC, "clamped"), reps=5)
        plain_ms = time_ms(lambda: sweep_cuda.diffuse_sweep_merged_reference(
            kappa, plan, uvb, KPC, "clamped"), reps=2)
        cells_angles = n ** 3 * plan.n_directions
        err_abs, err_rel = _rel_err(
            sweep_cuda.diffuse_sweep_kernel(kappa, plan, uvb, KPC, "clamped"),
            sweep_cuda.diffuse_sweep_merged_reference(kappa, plan, uvb, KPC,
                                                      "clamped"))
        print(f"[6 timing] sweep {n}^3 x {plan.n_directions} dirs f32 "
              f"clamped ({sweep_cuda.plane_memory_for(n, torch.float32)} "
              f"planes): kernel {ms:.3f} ms = {cells_angles / ms * 1e3:.4e} "
              f"cells*angles/s; plain {plain_ms:.3f} ms = "
              f"{cells_angles / plain_ms * 1e3:.4e} cells*angles/s; "
              f"kernel vs plain max rel {err_rel:.3e}; card {smi}")
        assert err_rel <= 1e-5, (n, err_rel)
        out[n] = (ms, plain_ms)
    return out


def phase_probes() -> dict:
    from radiativetransfer_tpu_torch import roofline_sweep
    from radiativetransfer_tpu_torch.constants import KPC
    from radiativetransfer_tpu_torch.core import probes_cuda, sweep_cuda
    # kernel vs plain on the same inputs; a contraction (exp, div), an
    # affine map (fma) and one add keep the chains' rounding from growing,
    # so 4e-6 relative covers the IEEE expf and division of the kernel
    # against PyTorch's own on the card (and 1/x taken as a reciprocal)
    x = roofline_sweep.bench_kappa(PROBE_N) * (2000.0 / PROBE_N) * KPC
    errs = {}
    for body, depth in (probes_cuda.EXP8, *probes_cuda.PLANE_PROBES):
        out = probes_cuda.chain(x, body, depth)
        torch.cuda.synchronize()
        ref = probes_cuda.chain_reference(x, body, depth)
        err_abs, err_rel = _rel_err(out, ref)
        print(f"[7 probes] {body} x{depth} at {PROBE_N}^3: max abs "
              f"{err_abs:.3e} max rel {err_rel:.3e} (tol 4e-6)")
        assert torch.isfinite(out).all() and err_rel <= 4e-6, (body, err_rel)
        errs[(body, depth)] = err_abs

    # at ROOF_N, where the grid is capped and every thread walks the
    # grid-stride loop ~3 times: roofline_sweep.probe holds each kernel's
    # output against the plain version's (the run that times the plain
    # version) on the same field, with the same tolerance; the #4 probe at
    # the bench's shape first (the roofline script runs #5 only)
    xb = roofline_sweep.bench_kappa(ROOF_N) * (2000.0 / ROOF_N) * KPC
    exp8 = roofline_sweep.probe(xb, *probes_cuda.EXP8, reps=20)
    print(f"[7 probes] exp x8 at {ROOF_N}^3: {exp8['ms']:.4f} ms, "
          f"{exp8['per_s']:.4e} exp/s; plain {exp8['plain_ms']:.3f} ms; "
          f"max abs {exp8['max_abs_err']:.3e} max rel "
          f"{exp8['max_rel_err']:.3e} (tol 4e-6)")
    del xb

    probes_cuda.LAUNCHES.clear()
    sweep_cuda.LAUNCHES = 0
    roof = roofline_sweep.main(ROOF_N, MAIN_LEVEL)
    launches = dict(probes_cuda.LAUNCHES)
    sweep_launches = sweep_cuda.LAUNCHES
    print(f"[7 probes] roofline_sweep launches {launches}, sweep "
          f"{sweep_launches}")
    for key in probes_cuda.PLANE_PROBES:
        assert launches.get(key, 0) > 0, f"roofline did not launch {key}"
    assert sweep_launches > 0, "roofline did not launch the sweep"
    at_roof = {probes_cuda.EXP8: exp8,
               **{key: roof[key[0]] for key in probes_cuda.PLANE_PROBES}}
    for (body, depth), r in at_roof.items():
        print(f"[7 probes] {body} x{depth} at {ROOF_N}^3: max abs "
              f"{r['max_abs_err']:.3e} max rel {r['max_rel_err']:.3e} "
              f"(tol 4e-6)")
        assert r["max_rel_err"] <= 4e-6, (body, depth, r["max_rel_err"])
        errs[(body, depth)] = max(errs[(body, depth)], r["max_abs_err"])
    # the per-step instruction counts of the bounds, against the SASS
    for body, m in roof["sass"].items():
        assert m["mufu"] > 0 and m["fp32_per_mufu"] == \
            probes_cuda.FP32_PER_STEP[body], (body, m)
    assert sweep_cuda.FP32_PER_EXPF == probes_cuda.FP32_PER_STEP["exp"]
    return {"errs": errs, "roof": roof, "exp8": exp8,
            "launches": launches, "sweep_launches": sweep_launches}


def _mode8_model(n, level, box_kpc, n_src, pos, pop, max_pixel_level,
                 **cfg_kw):
    import radiativetransfer_tpu_torch as rt
    from radiativetransfer_tpu_torch.config import (
        MODE_BOTH_STELLAR_UVB_TRANSFER)
    from radiativetransfer_tpu_torch.constants import KPC, MYR
    from radiativetransfer_tpu_torch.core.rays import SourceBatch
    from radiativetransfer_tpu_torch.core.step import StellarContext
    cfg = rt.RunConfig(mode=MODE_BOTH_STELLAR_UVB_TRANSFER,
                       current_redshift=6.55, n_angular_level=level,
                       reionization_model=10, **cfg_kw)
    geom = rt.GridGeometry(n, n, n, box_kpc * KPC)
    model = rt.RTModel.setup(cfg, geom, torch.float32, DEVICE)
    batch = SourceBatch(position=pos, weight=np.ones(n_src),
                        table_idx=np.zeros(n_src, np.int32))
    ctx = StellarContext.build(pop, batch, geom, 10.0 * MYR,
                               metal_coefs=[(0, 0.0)],
                               max_pixel_level=max_pixel_level,
                               dtype=torch.float32, device=DEVICE)
    return model, ctx


def phase_anchor8() -> None:
    import radiativetransfer_tpu_torch as rt
    from radiativetransfer_tpu_torch.core import sweep_cuda
    from radiativetransfer_tpu_torch.tables import stellar
    # the JAX package's dry run: 8 devices + 3 = 11 sources, not snapped
    pos = np.random.default_rng(0).uniform(0.2, 0.8, (11, 3))
    model, ctx = _mode8_model(24, 1, 200.0, 11, pos,
                              stellar.blackbody_population(), 2)
    state = rt.uniform_state(24, nh=1e-4, tgas=2e4, dtype=torch.float32,
                             device=DEVICE)
    before = sweep_cuda.LAUNCHES
    out, diag = model.make_step(ctx)(state)
    nf = model.neutral_fraction(out)
    rel = abs(nf - ANCHOR8_NF) / ANCHOR8_NF
    print(f"[8 anchor] 24^3 level 1 f32 mode 8, 11 sources: neutral "
          f"fraction {nf:.7f} vs {ANCHOR8_NF} (rel {rel:.2e}, tol "
          f"{ANCHOR_RTOL:g}); sweep launches "
          f"{sweep_cuda.LAUNCHES - before}")
    assert sweep_cuda.LAUNCHES - before == 1
    assert bool(torch.isfinite(diag.ndot_remaining).all())
    assert rel <= ANCHOR_RTOL, (nf, rel)


def phase_mode8() -> int:
    import radiativetransfer_tpu_torch as rt
    from radiativetransfer_tpu_torch.bench import bench_sources
    from radiativetransfer_tpu_torch.core import rays, sweep_cuda
    from radiativetransfer_tpu_torch.core.probes_cuda import time_ms
    from radiativetransfer_tpu_torch.tables import stellar
    n, level, box = MAIN_N, MAIN_LEVEL, 2000.0
    pos = bench_sources(n, MODE8_SOURCES).position
    pop = stellar.blackbody_population(q_ionizing=1.0e51)
    model, ctx = _mode8_model(n, level, box, MODE8_SOURCES, pos, pop, 6)
    state = rt.uniform_state(n, nh=2e-4, tgas=1.5e4, dtype=torch.float32,
                             device=DEVICE)
    init_state = state
    step = model.make_step(ctx)
    torch.cuda.reset_peak_memory_stats()
    sweep_cuda.LAUNCHES = 0
    nfs = []
    for it in range(1, 4):
        before = sweep_cuda.LAUNCHES
        t0 = time.perf_counter()
        state, diag = step(state)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        nf = model.neutral_fraction(state)
        nfs.append(nf)
        print(f"[9 mode8] {n}^3 x {model.sweep_plan.n_directions} dirs "
              f"f32 mode 8, {MODE8_SOURCES} sources: step {it} neutral "
              f"fraction {nf:.7f} wall {dt:.4f} s, sweep_cuda.LAUNCHES "
              f"{sweep_cuda.LAUNCHES}")
        assert np.isfinite(nf) and 0.0 <= nf <= 1.0, nf
        assert bool(torch.isfinite(state.HI).all())
        assert bool(torch.isfinite(diag.ndot_remaining).all())
        assert sweep_cuda.LAUNCHES == before + 1, "the step did not launch"
    launches = sweep_cuda.LAUNCHES
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    # the tracer apart, on the state of step 3, by CUDA events
    s0 = state.zero_rates()
    tracer_ms = time_ms(lambda: rays.trace_point_sources(
        s0, model.geom, ctx.sources, ctx.tables,
        max_pixel_level=ctx.max_pixel_level, dtype=torch.float32), reps=1)
    print(f"[9 mode8] tracer alone (state after step 3): {tracer_ms:.3f} ms;"
          f" peak device memory over the 3 steps {peak:.3f} GiB")

    scan, _ = _mode8_model(n, level, box, MODE8_SOURCES, pos, pop, 6,
                           use_pallas_sweep=False)
    t0 = time.perf_counter()
    out, _ = scan.make_step(ctx)(init_state)
    nf_scan = scan.neutral_fraction(out)
    dt = time.perf_counter() - t0
    rel = abs(nfs[0] - nf_scan) / nf_scan
    print(f"[9 mode8] step 1 with the plain slab scan (exact logmean): "
          f"neutral fraction {nf_scan:.7f} wall {dt:.3f} s; kernel step "
          f"rel {rel:.2e} (tol 1e-4)")
    assert rel <= 1e-4, (nfs[0], nf_scan)
    return launches


def phase_bench() -> dict:
    from radiativetransfer_tpu_torch import bench
    from radiativetransfer_tpu_torch.core import probes_cuda, sweep_cuda
    sweep_cuda.LAUNCHES = 0
    probes_cuda.LAUNCHES.clear()
    records = bench.main()
    launches = {"sweep": sweep_cuda.LAUNCHES,
                "probes": dict(probes_cuda.LAUNCHES)}
    print(f"[10 bench] {len(records)} lines; launches {launches}")
    assert [r["unit"] for r in records] == ["cells*angles/s", "rays/s",
                                            "cells/s"]
    assert all(np.isfinite(r["value"]) and r["value"] > 0 for r in records)
    assert launches["sweep"] > 0
    assert launches["probes"].get(probes_cuda.EXP8, 0) > 0
    return {"records": records, "launches": launches}


def phase_zones() -> dict:
    """11: the per-zone sweep (kernel #2) against the plain slab scan."""
    from radiativetransfer_tpu_torch.constants import KPC
    from radiativetransfer_tpu_torch.core import sweep, sweep_cuda
    from radiativetransfer_tpu_torch.core.probes_cuda import time_ms
    uvb = np.array([1.0, 0.5, 0.25])
    # the same function as the slab scan, the lengths times the cell size
    # rounded once (f32 1e-5: phase 3's tolerance for atomic sums)
    for level, n in [(1, 8), (2, 6)]:
        for dtype, rtol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
            kappa = _kappa(n, dtype)
            plan = sweep.build_sweep_plan(level, n)
            out = sweep_cuda.diffuse_sweep_zones_kernel(kappa, plan, uvb, KPC)
            torch.cuda.synchronize()
            ref = sweep.diffuse_sweep(kappa, plan, uvb, KPC)
            err_abs, err_rel = _rel_err(out, ref)
            print(f"[11 zones] level {level} n {n} {dtype}: max abs "
                  f"{err_abs:.3e} max rel {err_rel:.3e} (rtol {rtol:g})")
            assert err_rel <= rtol, (level, n, dtype, err_rel)

    n, level = MAIN_N, MAIN_LEVEL
    plan = sweep.build_sweep_plan(level, n)
    kappa = _kappa(n)
    sweep_cuda.ZONE_LAUNCHES = 0
    out = sweep_cuda.diffuse_sweep_zones_kernel(kappa, plan, uvb, KPC)
    torch.cuda.synchronize()
    launches = sweep_cuda.ZONE_LAUNCHES
    assert launches == len(plan.zones), (launches, len(plan.zones))
    # against the plain version (1e-5: phase 3's tolerance for atomic
    # sums), and against the slab scan, whose float32 lengths times the
    # cell size round once more (1e-4, the steps' tolerance: 1.1e-5 at 64^3
    # on the card)
    ref = sweep_cuda.diffuse_sweep_zones_reference(kappa, plan, uvb, KPC)
    err_abs, err_rel = _rel_err(out, ref)
    assert torch.isfinite(out).all() and err_rel <= 1e-5, err_rel
    scan_abs, scan_rel = _rel_err(out, sweep.diffuse_sweep(kappa, plan, uvb,
                                                           KPC))
    assert scan_rel <= 1e-4, scan_rel
    # the 24 zone kernels alone (sweep_zone_kernel on fields rotated
    # beforehand) and their plain versions on the same fields; the
    # wrapper's time adds its 48 rotations, copies and Jmean sums
    krots = [sweep_cuda.rotate_to_zone(kappa, zone) for zone in plan.zones]

    def every_zone(zone_fn):
        return lambda: [zone_fn(krot, zone, uvb, KPC, plan.weight)
                        for krot, zone in zip(krots, plan.zones)]

    ms = time_ms(every_zone(sweep_cuda.sweep_zone_kernel), reps=3)
    plain_ms = time_ms(every_zone(sweep_cuda.sweep_zone_reference), reps=1,
                       warmup=False)
    del krots
    wrapper_ms = time_ms(lambda: sweep_cuda.diffuse_sweep_zones_kernel(
        kappa, plan, uvb, KPC), reps=3)
    merged_ms = time_ms(lambda: sweep_cuda.diffuse_sweep_kernel(
        kappa, plan, uvb, KPC, "exact"), reps=3)
    ca = n ** 3 * plan.n_directions
    print(f"[11 zones] {n}^3 x {plan.n_directions} dirs f32: "
          f"{launches} zone launches (zones {len(plan.zones)}); vs the plain "
          f"version max abs {err_abs:.3e} max rel {err_rel:.3e} (tol 1e-5), "
          f"vs the slab scan max abs {scan_abs:.3e} max rel {scan_rel:.3e} "
          f"(tol 1e-4); the 24 zone kernels {ms:.3f} ms = "
          f"{ca / ms * 1e3:.4e} cells*angles/s (plain versions "
          f"{plain_ms:.3f} ms), diffuse_sweep_zones_kernel with its "
          f"rotations {wrapper_ms:.3f} ms, merged kernel (exact) "
          f"{merged_ms:.3f} ms")
    return {"launches": launches, "max_abs_err": err_abs, "ms": ms,
            "wrapper_ms": wrapper_ms, "merged_ms": merged_ms,
            "plain_ms": plain_ms}


def _check_at_main_widths(name, kernel, plain) -> float:
    """A sweep experiment's kernel against its plain version at 64^3 and
    128^3 x 192 directions (1e-5: phase 3's tolerance for atomic sums);
    returns the largest abs error."""
    from radiativetransfer_tpu_torch.constants import KPC
    from radiativetransfer_tpu_torch.core import sweep
    uvb = np.array([1.0, 0.5, 0.25])
    worst = 0.0
    for n in (PROBE_N, MAIN_N):
        plan = sweep.build_sweep_plan(MAIN_LEVEL, n)
        kappa = _kappa(n)
        out = kernel(kappa, plan, uvb, KPC)
        torch.cuda.synchronize()
        err_abs, err_rel = _rel_err(out, plain(kappa, plan, uvb, KPC))
        print(f"[{name}] {n}^3 x {plan.n_directions} dirs f32: max abs "
              f"{err_abs:.3e} max rel {err_rel:.3e} (tol 1e-5)")
        assert torch.isfinite(out).all() and err_rel <= 1e-5, (name, n,
                                                              err_rel)
        worst = max(worst, err_abs)
    return worst


def phase_pair() -> dict:
    """12: the two-slab sweep (kernel #6), then its experiment at 256^3."""
    from radiativetransfer_tpu_torch import exp_sweep_pair
    from radiativetransfer_tpu_torch.core import sweep_cuda, variants_cuda
    err = _check_at_main_widths("12 pair", variants_cuda.sweep_pair,
                                variants_cuda.sweep_pair_reference)
    variants_cuda.LAUNCHES.clear()
    sweep_cuda.LAUNCHES = 0
    res = exp_sweep_pair.main(ROOF_N, MAIN_LEVEL)
    launches = variants_cuda.LAUNCHES["pair"]
    # at ROOF_N the planes no longer fit shared memory: the experiment's
    # plain run holds the kernel's global-scratch branch to the same 1e-5
    print(f"[12 pair] exp_sweep_pair launches: pair {launches}, merged "
          f"{sweep_cuda.LAUNCHES}; at {ROOF_N}^3 vs the plain version max "
          f"rel {res['max_rel_err']:.3e} (tol 1e-5)")
    assert launches > 0 and sweep_cuda.LAUNCHES > 0
    assert res["max_rel_err"] <= 1e-5, res["max_rel_err"]
    return {**res, "launches": launches, "sweep_launches": sweep_cuda.LAUNCHES,
            "max_abs_err": max(err, res["max_abs_err"])}


def phase_variants() -> dict:
    """13: every lean variant (kernel #7), then the experiment at 256^3 and
    the FP32 instructions per MUFU of expf and exp2f in the SASS."""
    import functools

    from radiativetransfer_tpu_torch import exp_sweep_variants
    from radiativetransfer_tpu_torch.core import (
        probes_cuda,
        sweep_cuda,
        variants_cuda,
    )
    errs = {}
    for v in variants_cuda.VARIANTS:
        errs[v] = _check_at_main_widths(
            f"13 {v}", functools.partial(variants_cuda.lean_sweep, variant=v),
            functools.partial(variants_cuda.lean_sweep_reference, variant=v))
    variants_cuda.LAUNCHES.clear()
    sweep_cuda.LAUNCHES = 0
    res = exp_sweep_variants.main(ROOF_N, MAIN_LEVEL)
    launches = {v: variants_cuda.LAUNCHES[v] for v in variants_cuda.VARIANTS}
    print(f"[13 variants] exp_sweep_variants launches {launches}, merged "
          f"{sweep_cuda.LAUNCHES}")
    assert all(c > 0 for c in launches.values())
    for body, m in res["sass_probes"].items():
        assert m["mufu"] > 0 and m["fp32_per_mufu"] == \
            probes_cuda.FP32_PER_STEP[body], (body, m)
    for v, r in res["variants"].items():
        print(f"[13 variants] {v} at {ROOF_N}^3 (global-scratch planes) vs "
              f"its plain version: max rel {r['max_rel_err']:.3e} (tol 1e-5)")
        assert r["max_rel_err"] <= 1e-5, (v, r["max_rel_err"])
        errs[v] = max(errs[v], r["max_abs_err"])
    return {**res, "launches": launches, "errs": errs,
            "sweep_launches": sweep_cuda.LAUNCHES}


def phase_scatter() -> dict:
    """14: the row scatter (kernel #8) through its experiment."""
    from radiativetransfer_tpu_torch import exp_row_scatter
    from radiativetransfer_tpu_torch.core import scatter_cuda
    scatter_cuda.LAUNCHES = 0
    res = exp_row_scatter.main()
    launches = scatter_cuda.LAUNCHES
    print(f"[14 scatter] exp_row_scatter launches {launches}")
    assert launches > 0
    for m, r in res["m"].items():
        print(f"[14 scatter] M={m}: kernel vs float64 np.add.at max abs "
              f"{r['max_abs_err']:.3e}, vs index_add_ "
              f"{r['max_abs_err_vs_plain']:.3e} (tol 1e-5)")
        assert r["max_abs_err"] <= 1e-5 and r["max_abs_err_vs_plain"] <= \
            1e-5, (m, r)
    return {**res, "launches": launches}


def main() -> None:
    smi = phase_probe()
    phase_build()
    errs = phase_kernel_vs_plain()
    phase_anchor()
    launches9 = phase_main_path()
    times = phase_timings(smi)
    probes = phase_probes()
    phase_anchor8()
    launches8 = phase_mode8()
    bench_out = phase_bench()
    zones = phase_zones()
    pair = phase_pair()
    variants = phase_variants()
    scatter = phase_scatter()
    # the sweep kernel's launches on each path that runs it, each count
    # set to 0 just before its path
    sweep_paths = {"mode9": launches9, "mode8": launches8,
                   "roofline": probes["sweep_launches"],
                   "bench": bench_out["launches"]["sweep"],
                   "exp_sweep_pair": pair["sweep_launches"],
                   "exp_sweep_variants": variants["sweep_launches"]}
    line = _kernels_line(errs, times, probes, sweep_paths, bench_out)
    line += _new_kernels(zones, pair, variants, scatter)
    print(smi)
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def _kernels_line(errs, times, probes, sweep_paths, bench_out) -> list:
    from radiativetransfer_tpu_torch.core import probes_cuda, sweep, sweep_cuda
    counts = sweep_cuda.work_counts(sweep.build_sweep_plan(MAIN_LEVEL,
                                                           MAIN_N))
    b = probes_cuda.sweep_bound(counts, probes["roof"]["exp"]["per_s"])
    print(f"sweep_merged bound at {MAIN_N}^3: {b['bound_ms']:.4f} ms set by "
          f"{b['binding']} (bytes {b['bytes_ms']:.4f}, exp "
          f"{b['exp_ms']:.4f} at the MUFU rate, {b['exp_measured_ms']:.4f} "
          f"at the measured expf rate, fp32 {b['fp32_ms']:.4f} ms); kernel "
          f"{times[MAIN_N][0]:.3f} ms, "
          f"{100 * b['bound_ms'] / times[MAIN_N][0]:.1f}% of the bound")
    probe_src = "radiativetransfer_tpu_torch/csrc/probes.cu"
    bench_probes = bench_out["launches"]["probes"]
    line = [{
        "name": "sweep_merged",
        "route": "cuda",
        "source": "radiativetransfer_tpu_torch/csrc/sweep_merged.cu",
        "replaces": "radiativetransfer_tpu/core/sweep_pallas.py:287",
        "launches": sum(sweep_paths.values()),
        "launches_by_path": sweep_paths,
        "max_abs_err": errs["clamped"],
        "ms": times[MAIN_N][0],
        "plain_ms": times[MAIN_N][1],
        "bound_ms": b["bound_ms"],
        "bound_by": b["bound_by"],
        "library_ms": None,
    }]
    exp8 = probes["exp8"]
    line.append({
        "name": "chain_exp8", "route": "cuda", "source": probe_src,
        "replaces": "bench.py:270",
        "launches": bench_probes[probes_cuda.EXP8],
        "launches_by_path": {"bench": bench_probes[probes_cuda.EXP8]},
        "max_abs_err": probes["errs"][probes_cuda.EXP8],
        "ms": exp8["ms"], "plain_ms": exp8["plain_ms"],
        "bound_ms": exp8["bound_ms"], "bound_by": exp8["bound_by"],
        "library_ms": None})
    roof = probes["roof"]
    for key in probes_cuda.PLANE_PROBES:
        body, depth = key
        r = roof[body]
        paths = {"roofline": probes["launches"][key]}
        if key in bench_probes:
            paths["bench"] = bench_probes[key]
        line.append({
            "name": f"plane_{body}{depth if depth > 1 else ''}",
            "route": "cuda", "source": probe_src,
            "replaces": "scripts/roofline_sweep.py:65",
            "launches": sum(paths.values()),
            "launches_by_path": paths,
            "max_abs_err": probes["errs"][key],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms")})
    return line


def _new_kernels(zones, pair, variants, scatter) -> list:
    """The kernels line's entries of kernels #2, #6, #7 and #8."""
    from radiativetransfer_tpu_torch.core import (
        probes_cuda,
        scatter_cuda,
        sweep,
        sweep_cuda,
    )
    src = "radiativetransfer_tpu_torch/csrc/sweep_variants.cu"
    b = probes_cuda.sweep_bound(sweep_cuda.work_counts(
        sweep.build_sweep_plan(MAIN_LEVEL, MAIN_N)), probes_cuda.MUFU_PER_S)
    line = [{
        "name": "sweep_zone", "route": "cuda", "source": src,
        "replaces": "radiativetransfer_tpu/core/sweep_pallas.py:65",
        "launches": zones["launches"],
        "launches_by_path": {"zones": zones["launches"]},
        "max_abs_err": zones["max_abs_err"], "ms": zones["ms"],
        "plain_ms": zones["plain_ms"], "bound_ms": b["bound_ms"],
        "bound_by": b["bound_by"], "library_ms": None,
    }, {
        "name": "sweep_pair", "route": "cuda", "source": src,
        "replaces": "scripts/exp_sweep_pair.py:53",
        "launches": pair["launches"],
        "launches_by_path": {"exp_sweep_pair": pair["launches"]},
        "max_abs_err": pair["max_abs_err"], "ms": pair["ms"],
        "plain_ms": pair["plain_ms"], "bound_ms": pair["bound_ms"],
        "bound_by": pair["bound_by"], "library_ms": None,
    }]
    for v, r in variants["variants"].items():
        line.append({
            "name": f"sweep_lean_{v}", "route": "cuda", "source": src,
            "replaces": "scripts/exp_sweep_variants.py:71",
            "launches": variants["launches"][v],
            "launches_by_path": {"exp_sweep_variants":
                                 variants["launches"][v]},
            "max_abs_err": variants["errs"][v], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
    top = scatter["m"][max(scatter["m"])]
    line.append({
        "name": "scatter_rows", "route": "cuda",
        "source": "radiativetransfer_tpu_torch/csrc/scatter_rows.cu",
        "replaces": "scripts/exp_pallas_scatter.py:45",
        "launches": scatter["launches"],
        "launches_by_path": {"exp_row_scatter": scatter["launches"]},
        "max_abs_err": max(r["max_abs_err"] for r in scatter["m"].values()),
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": "bytes",
        "library_ms": top["library_ms"]})
    assert scatter_cuda.BYTES_PER_ROW == 100
    return line


if __name__ == "__main__":
    main()
