#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA device (an H100).

    python3 chip_smoke.py          # from the root of the repository

Drives radiativetransfer_tpu_torch's mode-9 path (UVB-only diffuse
transfer + equilibrium chemistry) through its public API and checks the
hand-written sweep kernel against its plain PyTorch version.  Phases, one
line or more each; any failure raises and the script exits non-zero:

1. probe: torch, CUDA, the device, its power limit, nvcc, triton;
2. build the kernel from radiativetransfer_tpu_torch/csrc/ (timed);
3. kernel vs plain version on the device, float32 (and float64), both
   logmean forms, both plane memories, up to 128^3 x 192 directions;
4. the 24^3 anchor: one f32 mode-9 step, neutral fraction 0.044220 +-1e-4;
5. the main path at 128^3 x 192 directions: initialize_equilibrium and 3
   steps, each timed, with the kernel's launch count; step 1 against the
   plain slab scan;
6. the sweep alone at 128^3 and 256^3 x 192 directions, kernel and plain
   version, in cells*angles/s.

The last lines are the card's name and power limit, one JSON object of
the kernel's numbers, and {"ok": true, "device": {...}}.  Exits non-zero
without a CUDA device.  Needs no JAX and no network.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# the anchor: one f32 mode-9 step, 24^3, 200 kpc, level 1, z = 6.55,
# reionization model 10, uniform nh = 1e-4, T = 2e4 (MULTICHIP_r05.json)
ANCHOR_NF = 0.044220
ANCHOR_RTOL = 1e-4
# the main path's size: the 128^3 base grid of the production deep-AMR run
# at the reference's 192 directions; the sweep is also timed at 256^3
DEVICE = "cuda"
MAIN_N, MAIN_LEVEL = 128, 3
TIMING_NS = (128, 256)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _rel_err(out: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max elementwise relative error).  Elements below
    1e-30 of the largest are held to absolute error at that floor: float32
    keeps fewer digits toward its subnormal range (from 1.2e-38), where
    the attenuation through ~100 optically thick cells lands at 256^3."""
    diff = (out - ref).abs()
    floor = float(ref.abs().max()) * 1e-30
    rel = diff / ref.abs().clamp(min=max(floor, torch.finfo(ref.dtype).tiny))
    return float(diff.max()), float(rel.max())


def _kappa(n: int, dtype=torch.float32, seed: int = 42) -> torch.Tensor:
    from radiativetransfer_tpu_torch.constants import KPC
    rng = np.random.default_rng(seed)
    k = rng.lognormal(0, 1, (3, n, n, n)) * 0.7 / KPC
    return torch.tensor(k, dtype=dtype, device=DEVICE)


def _time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_probe() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke test needs a CUDA device")
    from radiativetransfer_tpu_torch.core import sweep_cuda
    smi = _nvidia_smi()
    nvcc = sweep_cuda._find_nvcc()
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
    from radiativetransfer_tpu_torch.core import sweep_cuda
    t0 = time.perf_counter()
    sweep_cuda.build()
    dt = time.perf_counter() - t0
    print(f"[2 build] {sweep_cuda.library_path().name} in {dt:.2f} s")
    for line in sweep_cuda.BUILD_LOG.splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line):
            print(f"[2 build] {line.strip()}")


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
    uvb = np.array([1.0, 0.5, 0.25])
    out = {}
    for n in TIMING_NS:
        plan = sweep.build_sweep_plan(MAIN_LEVEL, n)
        kappa = _kappa(n)
        ms = _time_ms(lambda: sweep_cuda.diffuse_sweep_kernel(
            kappa, plan, uvb, KPC, "clamped"), reps=5)
        plain_ms = _time_ms(lambda: sweep_cuda.diffuse_sweep_merged_reference(
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


def main() -> None:
    smi = phase_probe()
    phase_build()
    errs = phase_kernel_vs_plain()
    phase_anchor()
    launches = phase_main_path()
    times = phase_timings(smi)
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "sweep_merged",
        "route": "cuda",
        "source": "radiativetransfer_tpu_torch/csrc/sweep_merged.cu",
        "replaces": "radiativetransfer_tpu/core/sweep_pallas.py:287",
        "launches": launches,
        "max_abs_err": errs["clamped"],
        "ms": times[MAIN_N][0],
        "plain_ms": times[MAIN_N][1],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
