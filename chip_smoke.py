#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA device (an H100).

    python3 chip_smoke.py          # from the root of the repository

Drives radiativetransfer_tpu_torch's paths through their public entry
points -- mode 9 (UVB-only diffuse transfer + equilibrium chemistry), mode
8 (point sources + UVB), the roofline script, the bench and mode 9 on a
1-D grid mesh -- and holds each hand-written kernel against its plain
PyTorch version.  Phases, one
line or more each; any failure raises and the script exits non-zero:

1. probe: torch, CUDA, the device, its power limit, nvcc, triton;
2. build every kernel source of radiativetransfer_tpu_torch/csrc/, one
   nvcc each, started together (timed);
3. the sweep kernels vs their plain version on the device, float32 and
   float64, both logmean forms: the plane kernel (csrc/sweep_merged.cu)
   in both plane memories and at 128^3 and 256^3 x 192 directions; the
   cluster kernel (csrc/sweep_cluster.cu) in every launch shape that
   fits, at small sizes with ragged row bands and groups, and at 128^3
   and 256^3 x 192; both at 128^3 x 192 in float64;
4. the 24^3 mode-9 anchor: one f32 step, neutral fraction 0.044220 +-1e-4,
   through the cluster kernel;
5. the mode-9 path at 128^3 x 192 directions: initialize_equilibrium and 3
   steps, each timed, with the cluster kernel's launch count (and none of
   the plane kernel's); step 1 against the
   plain slab scan;
6. the sweep alone at 128^3 and 256^3 x 192 directions in float32 and at
   128^3 in float64: the plane kernel and the cluster kernel in the size
   rule's shape timed in turns (plane, cluster, cluster, plane), every
   launch shape that fits with its resident clusters and waves, and the
   plain version, in cells*angles/s;
7. the probe kernel vs its plain version for every body at 64^3, then the
   roofline script (python -m radiativetransfer_tpu_torch.roofline_sweep)
   at 256^3: stream GB/s (the kernel in turns with torch.add), the exp,
   div and fma rates, the
   sweep's bound;
   every probe's output at 256^3 against its plain version's there, and
   the bounds' per-step instruction counts against the kernel's SASS;
8. the 24^3 mode-8 anchor: one f32 step, neutral fraction 0.033307 +-1e-4,
   exactly one sweep launch;
9. the mode-8 path at 128^3 x 192 directions with 8 sources: 3 steps, each
   timed, the tracer timed apart, peak device memory, the sweep's launch
   count; step 1 against the plain slab scan;
10. the port's bench (python -m radiativetransfer_tpu_torch.bench): its
    three JSON lines, sweep, rays and step;
11. the per-zone sweep (kernel #2, one zone a launch of the cluster
    kernel csrc/sweep_cluster.cu): every launch shape on every zone
    against its plain version at level 1 n 8 and level 2 n 6, 7 (f32,
    f64), the size rule's 24 zones against the slab scan there; at 128^3 x
    192 in f32 and f64 diffuse_sweep_zones_kernel (24 cluster launches,
    none of csrc/sweep_variants.cu's plane zone kernel) against its plain
    version and the slab scan, the plane zone kernel against the plain
    version, the 24 launches on fields rotated beforehand timed in turns
    (plane, cluster, cluster, plane) with the shape chosen, its resident
    clusters and its share of the bound, and every launch shape's time;
    beside them the wrapper with its rotations and the shipped sweep;
12. the two-slab sweep (kernel #6) on the cluster kernel
    (csrc/sweep_cluster_exp.cu's pair instances) against its plain version
    in every launch shape at level 1 n 6 and level 2 n 8 (f32, f64), in
    the size rule's shape at 64^3 (f32, f64) and 128^3 x 192, with the plane
    kernel (csrc/sweep_variants.cu) at 64^3 and 128^3; then python
    -m radiativetransfer_tpu_torch.exp_sweep_pair at 256^3: both kernels
    held to the plain version there, the pair timed in turns with the
    plane kernel and with the cluster kernel's exact instance in its shape;
13. every lean variant (kernel #7) the same way (f32; level 1 n 7 and
    level 2 n 8), then python -m radiativetransfer_tpu_torch.
    exp_sweep_variants at 256^3: both kernels of every variant held to its
    plain version, each cluster variant timed in turns with the plane kernel
    and the cluster kernel's merged instance in its shape, the attribution
    (noemi, seg1, noshift in turns with lean, clamp2 with clamp), and the
    FP32 instructions per MUFU of expf and exp2f in the SASS checked
    against the bounds' counts;
14. the row scatter (kernel #8) through python -m
    radiativetransfer_tpu_torch.exp_row_scatter: the kernel against a
    float64 np.add.at and index_add_ at every M, in turns with index_add_,
    the host and device microseconds per call of the kernel and of
    index_add_, and the float4 reduction floor into an accumulator in L2
    and into the 67 MB one;
15. the mesh path, P virtual ranks on the card: the 24^3 anchor through
    the ring sweep (kernel #3, the cluster ring: csrc/sweep_cluster.cu's
    RING instances) on 4 ranks; the ring at level 1 and 2, n 8, P = 1, 2,
    4, 8 against the pipelined plain version and the slab scan; at 128^3
    x 192 (P = 1, 2, 4 in f32, P = 4 in f64) and 256^3 (P = 4) the
    cluster ring in its size rule's shape and the plane ring
    (csrc/sweep_rdma.cu) against their plain version, their 24 launches
    timed in turns (plane, cluster, cluster, plane), every launch shape
    of the cluster ring at 128^3 (P = 4 f32 and f64, P = 1 f32), beside
    the wrapper, the shipped sweep and the per-zone sweep; 3 mode-9 steps
    at 128^3 x 192 on 4 ranks through the cluster ring (24 launches
    each), step 1 against the same step on one rank and against one
    device's; 3 steps of the zones strategy at 128^3 x 192 on 4 ranks (24
    cluster zone launches each), and one step of the pipelined strategy
    at 64^3, held the same way; and a ring of each kernel that cannot be
    co-resident, refused.

The last lines are the card's name and power limit, one JSON object of
every kernel's numbers, and {"ok": true, "device": {...}}.  Exits non-zero
without a CUDA device.  Needs no JAX and no network.
"""

from __future__ import annotations

import functools
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


def _ptxas_kernels(log: str) -> dict[str, tuple[int, int]]:
    """{mangled kernel name: (registers, spill store bytes)} of nvcc's
    -Xptxas -v output."""
    import re
    out, name, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m.group(1)), spill)
    return out


def phase_build() -> None:
    import re

    from radiativetransfer_tpu_torch.core import cuda_build
    t0 = time.perf_counter()
    cuda_build.build()
    dt = time.perf_counter() - t0
    names = ", ".join(cuda_build.library_path(n).name
                      for n in cuda_build.SOURCES)
    print(f"[2 build] {names} in {dt:.2f} s")
    for name, log in cuda_build.BUILD_LOG.items():
        if name == "sweep_cluster":
            # one entry per <dtype, clamped, G, cells per thread, ring>
            cells = []
            for kname, (regs, spill) in _ptxas_kernels(log).items():
                m = re.search(r"sweep_cluster_kernelI([fd])Lb([01])ELi(\d+)"
                              r"ELi(\d+)ELb([01])E", kname)
                if m:
                    t, cl, g, cpt, ring = m.groups()
                    cells.append(f"{'f32' if t == 'f' else 'f64'}"
                                 f"{' clamped' if cl == '1' else ''}"
                                 f"{' ring' if ring == '1' else ''} G{g} "
                                 f"CPT{cpt}: {regs} regs, {spill} B spill")
            print(f"[2 build] sweep_cluster ({len(cells)} kernels): "
                  f"{'; '.join(cells)}")
            continue
        if name == "sweep_cluster_exp":
            # one entry per <dtype, Mode, G, cells per thread>
            from radiativetransfer_tpu_torch.core.sweep_cluster import MODES
            cells = []
            for kname, (regs, spill) in _ptxas_kernels(log).items():
                m = re.search(r"sweep_variant_cluster_kernelI([fd])Li(\d+)"
                              r"ELi(\d+)ELi(\d+)E", kname)
                if m:
                    t, mode, g, cpt = m.groups()
                    cells.append(f"{'f32' if t == 'f' else 'f64'} "
                                 f"{MODES[int(mode)]} G{g} CPT{cpt}: {regs} "
                                 f"regs, {spill} B spill")
            print(f"[2 build] sweep_cluster_exp ({len(cells)} kernels): "
                  f"{'; '.join(cells)}")
            continue
        for line in log.splitlines():
            if "ptxas info" in line and ("Used" in line
                                         or "Compiling" in line):
                print(f"[2 build] {name}: {line.strip()}")


def phase_kernel_vs_plain() -> dict:
    from radiativetransfer_tpu_torch.constants import KPC
    from radiativetransfer_tpu_torch.core import (
        sweep,
        sweep_cluster,
        sweep_cuda,
    )
    from radiativetransfer_tpu_torch.exp_sweep_cluster import shapes_at
    uvb = np.array([1.0, 0.5, 0.25])
    # the plane kernel (csrc/sweep_merged.cu), both plane memories
    cases = []
    for level, n in [(1, 8), (2, 6)]:
        for lm in ("exact", "clamped"):
            for mem in ("shared", "global"):
                cases.append((level, n, torch.float32, lm, mem, 2e-6))
    cases.append((1, 8, torch.float64, "exact", "auto", 1e-12))
    for level, n, dtype, lm, mem, rtol in cases:
        kappa = _kappa(n, dtype)
        plan = sweep.build_sweep_plan(level, n)
        out = sweep_cuda.diffuse_sweep_plane_kernel(kappa, plan, uvb, KPC, lm,
                                                    plane_memory=mem)
        torch.cuda.synchronize()
        ref = sweep_cuda.diffuse_sweep_merged_reference(kappa, plan, uvb, KPC,
                                                        lm)
        err_abs, err_rel = _rel_err(out, ref)
        print(f"[3 kernel] plane kernel level {level} n {n} {dtype} {lm} "
              f"{mem}: max abs {err_abs:.3e} max rel {err_rel:.3e} (rtol "
              f"{rtol:g})")
        assert err_rel <= rtol, (level, n, dtype, lm, mem, err_rel)

    # the cluster kernel in every launch shape that fits, ragged row bands
    # (n 6, 7) and ragged groups included
    cluster_abs = 0.0
    for level, n in [(1, 8), (2, 6), (2, 7)]:
        plan = sweep.build_sweep_plan(level, n)
        for dtype, rtol in ((torch.float32, 2e-6), (torch.float64, 1e-12)):
            kappa = _kappa(n, dtype)
            for lm in ("exact", "clamped"):
                ref = sweep_cuda.diffuse_sweep_merged_reference(
                    kappa, plan, uvb, KPC, lm)
                worst = (0.0, 0.0)
                shapes = shapes_at(n, dtype)
                for shape in shapes:
                    out = sweep_cluster.diffuse_sweep_cluster_kernel(
                        kappa, plan, uvb, KPC, lm, shape)
                    torch.cuda.synchronize()
                    e = _rel_err(out, ref)
                    assert e[1] <= rtol, (level, n, dtype, lm, shape, e)
                    worst = max(worst, e, key=lambda x: x[1])
                cluster_abs = max(cluster_abs, worst[0])
                print(f"[3 kernel] cluster kernel level {level} n {n} "
                      f"{dtype} {lm}, {len(shapes)} launch shapes: max abs "
                      f"{worst[0]:.3e} max rel {worst[1]:.3e} (rtol "
                      f"{rtol:g})")

    # transparent box: Jmean == uvb in every cell and band
    n = 6
    plan = sweep.build_sweep_plan(1, n)
    kappa = torch.full((3, n, n, n), 1e-30, device=DEVICE)
    ref = torch.tensor(uvb, dtype=torch.float32, device=DEVICE)[
        :, None, None, None].expand(3, n, n, n)
    for lm, tol in (("exact", 1e-5), ("clamped", 2e-4)):
        for fn in (sweep_cuda.diffuse_sweep_kernel,
                   sweep_cuda.diffuse_sweep_plane_kernel):
            out = fn(kappa, plan, uvb, KPC, lm)
            err_abs, err_rel = _rel_err(out, ref)
            print(f"[3 kernel] transparent box {fn.__name__} {lm}: max abs "
                  f"{err_abs:.3e} max rel {err_rel:.3e} (tol {tol:g})")
            assert err_rel <= tol, (lm, err_rel)

    # the main path's shape (the plane kernel's shared planes) and 256^3
    # (the plane kernel's global scratch) in f32, every launch shape in the
    # clamped form; the tolerance covers 192-term atomic sums taken in
    # another order than the plain version's.  128^3 in f64, phase 6's
    # (both kernels' planes too large for the plane kernel's shared memory)
    result = {"plane": 0.0, "cluster": 0.0}
    cases = [(n, torch.float32, lm, 1e-5) for n in TIMING_NS
             for lm in ("exact", "clamped")]
    cases.append((MAIN_N, torch.float64, "exact", 1e-12))
    for n, dtype, lm, rtol in cases:
        plan = sweep.build_sweep_plan(MAIN_LEVEL, n)
        kappa = _kappa(n, dtype)
        ref = sweep_cuda.diffuse_sweep_merged_reference(kappa, plan, uvb, KPC,
                                                        lm)
        runs = [("cluster", s, functools.partial(
            sweep_cluster.diffuse_sweep_cluster_kernel, shape=s))
            for s in shapes_at(n, dtype)[:None if lm == "clamped" else 1]]
        runs.append(("plane", None, sweep_cuda.diffuse_sweep_plane_kernel))
        for name, shape, fn in runs:
            out = fn(kappa, plan, uvb, KPC, lm)
            torch.cuda.synchronize()
            err_abs, err_rel = _rel_err(out, ref)
            what = (f"cluster kernel C {shape.csize} G {shape.group} "
                    f"{shape.threads} x {shape.cpt}" if shape
                    else "plane kernel "
                    f"({sweep_cuda.plane_memory_for(n, dtype)} planes)")
            print(f"[3 kernel] {n}^3 x {plan.n_directions} dirs {dtype} {lm} "
                  f"{what}: max abs {err_abs:.3e} max rel {err_rel:.3e} "
                  f"(tol {rtol:g})")
            assert torch.isfinite(out).all() and err_rel <= rtol, (
                n, dtype, lm, what, err_rel)
            if lm == "clamped":
                result[name] = max(result[name], err_abs)
        del ref, out
    result["cluster"] = max(result["cluster"], cluster_abs)
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


def _sweep_launches() -> tuple[int, int]:
    """(cluster kernel, plane kernel) launches so far."""
    from radiativetransfer_tpu_torch.core import sweep_cluster, sweep_cuda
    return sweep_cluster.LAUNCHES, sweep_cuda.LAUNCHES


def _zero_sweep_launches() -> None:
    from radiativetransfer_tpu_torch.core import sweep_cluster, sweep_cuda
    sweep_cluster.LAUNCHES = 0
    sweep_cuda.LAUNCHES = 0


def phase_anchor() -> None:
    import radiativetransfer_tpu_torch as rt
    model = _rtmodel(24, 1, 200.0, DEVICE)
    state = rt.uniform_state(24, nh=1e-4, tgas=2e4, dtype=torch.float32,
                             device=DEVICE)
    before = _sweep_launches()
    out = model.transport_chemistry_step(state)
    nf = model.neutral_fraction(out)
    rel = abs(nf - ANCHOR_NF) / ANCHOR_NF
    launches = tuple(a - b for a, b in zip(_sweep_launches(), before))
    print(f"[4 anchor] 24^3 level 1 f32 mode 9: neutral fraction {nf:.7f} "
          f"vs {ANCHOR_NF} (rel {rel:.2e}, tol {ANCHOR_RTOL:g}); cluster, "
          f"plane kernel launches {launches}")
    assert launches == (1, 0)
    assert rel <= ANCHOR_RTOL, (nf, rel)


def phase_main_path() -> int:
    from radiativetransfer_tpu_torch.core import sweep_cluster, sweep_cuda
    from radiativetransfer_tpu_torch.profile_step import galaxy_state
    n, level, box = MAIN_N, MAIN_LEVEL, 300.0
    model = _rtmodel(n, level, box, DEVICE, self_shielding_threshold_kpc=0.1)
    # the synthetic galaxy of examples/make_test_data.py at n^3: a
    # self-shielded core, so the sweep sees real structure
    state = galaxy_state(n, box, DEVICE)
    _zero_sweep_launches()
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
        before = sweep_cluster.LAUNCHES
        t0 = time.perf_counter()
        state = step(state)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        nf = model.neutral_fraction(state)
        nfs.append(nf)
        print(f"[5 main] step {it}: neutral fraction {nf:.7f} wall "
              f"{dt:.4f} s, sweep_cluster.LAUNCHES {sweep_cluster.LAUNCHES}, "
              f"sweep_cuda.LAUNCHES {sweep_cuda.LAUNCHES}")
        assert np.isfinite(nf) and 0.0 <= nf <= 1.0, nf
        assert bool(torch.isfinite(state.HI).all())
        assert sweep_cluster.LAUNCHES > before, "the step did not launch"
    launches = sweep_cluster.LAUNCHES
    assert sweep_cuda.LAUNCHES == 0, "the main path took the plane kernel"

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


def phase_timings() -> dict:
    """6: the sweep alone through python -m
    radiativetransfer_tpu_torch.exp_sweep_cluster: the plane kernel
    (csrc/sweep_merged.cu) and the cluster kernel in the size rule's shape
    timed in turns (plane, cluster, cluster, plane), then every launch
    shape of the cluster kernel that fits, with its resident clusters and
    waves; the plain version; at TIMING_NS in float32 and MAIN_N in
    float64."""
    from radiativetransfer_tpu_torch import exp_sweep_cluster
    from radiativetransfer_tpu_torch.core import sweep_cluster, sweep_cuda
    _zero_sweep_launches()
    out = exp_sweep_cluster.main(TIMING_NS, MAIN_LEVEL, (MAIN_N,))
    out["launches"] = {"plane": sweep_cuda.LAUNCHES,
                       "cluster": sweep_cluster.LAUNCHES}
    for n in TIMING_NS:
        t = out[n]
        print(f"[6 timing] {n}^3: cluster kernel {t['cluster_ms']:.3f} ms, "
              f"plane kernel {t['plane_ms']:.3f} ms "
              f"({t['plane_ms'] / t['cluster_ms']:.2f}x); launches "
              f"{out['launches']}")
        assert t["cluster_ms"] > 0 and t["plane_ms"] > 0
    t = out["f64"][MAIN_N]
    print(f"[6 timing] {MAIN_N}^3 f64: cluster kernel {t['cluster_ms']:.3f} "
          f"ms, plane kernel {t['plane_ms']:.3f} ms "
          f"({t['plane_ms'] / t['cluster_ms']:.2f}x)")
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
    _zero_sweep_launches()
    roof = roofline_sweep.main(ROOF_N, MAIN_LEVEL)
    launches = dict(probes_cuda.LAUNCHES)
    sweep_launches, plane_launches = _sweep_launches()
    print(f"[7 probes] roofline_sweep launches {launches}, cluster sweep "
          f"{sweep_launches}, plane sweep {plane_launches}")
    assert plane_launches == 0
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
    before = _sweep_launches()
    out, diag = model.make_step(ctx)(state)
    nf = model.neutral_fraction(out)
    rel = abs(nf - ANCHOR8_NF) / ANCHOR8_NF
    launches = tuple(a - b for a, b in zip(_sweep_launches(), before))
    print(f"[8 anchor] 24^3 level 1 f32 mode 8, 11 sources: neutral "
          f"fraction {nf:.7f} vs {ANCHOR8_NF} (rel {rel:.2e}, tol "
          f"{ANCHOR_RTOL:g}); cluster, plane sweep launches {launches}")
    assert launches == (1, 0)
    assert bool(torch.isfinite(diag.ndot_remaining).all())
    assert rel <= ANCHOR_RTOL, (nf, rel)


def phase_mode8() -> int:
    import radiativetransfer_tpu_torch as rt
    from radiativetransfer_tpu_torch.bench import bench_sources
    from radiativetransfer_tpu_torch.core import (
        rays,
        sweep_cluster,
        sweep_cuda,
    )
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
    _zero_sweep_launches()
    nfs = []
    for it in range(1, 4):
        before = sweep_cluster.LAUNCHES
        t0 = time.perf_counter()
        state, diag = step(state)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        nf = model.neutral_fraction(state)
        nfs.append(nf)
        print(f"[9 mode8] {n}^3 x {model.sweep_plan.n_directions} dirs "
              f"f32 mode 8, {MODE8_SOURCES} sources: step {it} neutral "
              f"fraction {nf:.7f} wall {dt:.4f} s, sweep_cluster.LAUNCHES "
              f"{sweep_cluster.LAUNCHES}")
        assert np.isfinite(nf) and 0.0 <= nf <= 1.0, nf
        assert bool(torch.isfinite(state.HI).all())
        assert bool(torch.isfinite(diag.ndot_remaining).all())
        assert sweep_cluster.LAUNCHES == before + 1, "the step did not launch"
    launches = sweep_cluster.LAUNCHES
    assert sweep_cuda.LAUNCHES == 0, "the step took the plane kernel"
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
    _zero_sweep_launches()
    probes_cuda.LAUNCHES.clear()
    records = bench.main()
    assert sweep_cuda.LAUNCHES == 0, "the bench took the plane kernel"
    launches = {"sweep": _sweep_launches()[0],
                "probes": dict(probes_cuda.LAUNCHES)}
    print(f"[10 bench] {len(records)} lines; launches {launches}")
    assert [r["unit"] for r in records] == ["cells*angles/s", "rays/s",
                                            "cells/s"]
    assert all(np.isfinite(r["value"]) and r["value"] > 0 for r in records)
    assert launches["sweep"] > 0
    assert launches["probes"].get(probes_cuda.EXP8, 0) > 0
    return {"records": records, "launches": launches}


def phase_zones(smi: str) -> dict:
    """11: the per-zone sweep (kernel #2): the cluster kernel's zone launch
    in every shape at small sizes, then at 128^3 x 192 in float32 and
    float64 the size rule's shape through diffuse_sweep_zones_kernel
    against its plain version and the slab scan, timed in turns with the
    plane zone kernel (csrc/sweep_variants.cu), and every launch shape's
    time."""
    from radiativetransfer_tpu_torch.constants import KPC
    from radiativetransfer_tpu_torch.core import (
        probes_cuda,
        sweep,
        sweep_cluster,
        sweep_cuda,
    )
    from radiativetransfer_tpu_torch.core.probes_cuda import time_ms
    from radiativetransfer_tpu_torch.exp_sweep_cluster import shapes_at
    uvb = np.array([1.0, 0.5, 0.25])
    # every launch shape on each zone (ragged row bands at n 6, 7; ragged
    # groups at level 2), against the zone's plain version (f32 1e-5: the
    # kernel's (a - 1) * (1/kappa) * (1/len) rounds the plain version's
    # (1 - a)/tau otherwise, and sums in another order), and the 24 zones
    # in the size rule's shape against the slab scan
    worst = 0.0
    for level, n in [(1, 8), (2, 6), (2, 7)]:
        plan = sweep.build_sweep_plan(level, n)
        for dtype, rtol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
            kappa = _kappa(n, dtype)
            krots = [sweep_cuda.rotate_to_zone(kappa, z) for z in plan.zones]
            shapes = shapes_at(n, dtype)
            e_max = (0.0, 0.0)
            for shape in shapes:
                for zone, krot in zip(plan.zones, krots):
                    out = sweep_cluster.sweep_zone_cluster_kernel(
                        krot, zone, uvb, KPC, plan.weight, shape)
                    torch.cuda.synchronize()
                    e = _rel_err(out, sweep_cuda.sweep_zone_reference(
                        krot, zone, uvb, KPC, plan.weight))
                    assert e[1] <= rtol, (level, n, dtype, shape, zone.izone,
                                          e)
                    e_max = max(e_max, e, key=lambda x: x[1])
            out = sweep_cuda.diffuse_sweep_zones_kernel(kappa, plan, uvb, KPC)
            torch.cuda.synchronize()
            e_scan = _rel_err(out, sweep.diffuse_sweep(kappa, plan, uvb, KPC))
            print(f"[11 zones] level {level} n {n} {dtype}: {len(shapes)} "
                  f"launch shapes x {len(plan.zones)} zones vs the plain "
                  f"version max abs {e_max[0]:.3e} max rel {e_max[1]:.3e}; "
                  f"the rule's 24 zones vs the slab scan max rel "
                  f"{e_scan[1]:.3e} (rtol {rtol:g})")
            assert e_scan[1] <= rtol, (level, n, dtype, e_scan)
            worst = max(worst, e_max[0])

    n, level = MAIN_N, MAIN_LEVEL
    plan = sweep.build_sweep_plan(level, n)
    bound = probes_cuda.sweep_bound(sweep_cuda.work_counts(plan),
                                    probes_cuda.MUFU_PER_S)
    ca = n ** 3 * plan.n_directions
    res = {"bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
           "max_abs_err": worst, "old_max_abs_err": 0.0, "launches": 0,
           "old_launches": 0}
    for dtype, rtol, label in ((torch.float32, 1e-5, "f32"),
                               (torch.float64, 1e-12, "f64")):
        kappa = _kappa(n, dtype)
        rule = sweep_cluster.choose_cluster(n, n, dtype)
        assert rule is not None, (n, dtype)
        # the path: the zones sweep, one launch of the rule's kernel per zone
        sweep_cluster.ZONE_LAUNCHES = sweep_cuda.ZONE_LAUNCHES = 0
        out = sweep_cuda.diffuse_sweep_zones_kernel(kappa, plan, uvb, KPC)
        torch.cuda.synchronize()
        launches = sweep_cluster.ZONE_LAUNCHES
        assert launches == len(plan.zones) and sweep_cuda.ZONE_LAUNCHES == 0, (
            launches, sweep_cuda.ZONE_LAUNCHES)
        res["launches"] += launches
        # against the plain version (f32 1e-5: atomic sums, another
        # rounding of the exact logmean) and the slab scan, whose float32
        # lengths times the cell size round once more (1e-4)
        ref = sweep_cuda.diffuse_sweep_zones_reference(kappa, plan, uvb, KPC)
        err_abs, err_rel = _rel_err(out, ref)
        assert torch.isfinite(out).all() and err_rel <= rtol, (label, err_rel)
        # the plane zone kernel (phase 11's yardstick), its planes by size
        old_out = sweep_cuda.zone_by_zone(
            sweep_cuda.sweep_zone_plane_kernel, kappa, plan, uvb, KPC,
            plane_memory=sweep_cuda.plane_memory_for(n, dtype))
        old_abs, old_rel = _rel_err(old_out, ref)
        assert old_rel <= rtol, (label, old_rel)
        res["old_max_abs_err"] = max(res["old_max_abs_err"], old_abs)
        del ref, old_out
        scan_tol = 1e-4 if dtype == torch.float32 else 1e-12
        scan_abs, scan_rel = _rel_err(out, sweep.diffuse_sweep(kappa, plan,
                                                               uvb, KPC))
        assert scan_rel <= scan_tol, (label, scan_rel)
        res["max_abs_err"] = max(res["max_abs_err"], err_abs)
        del out
        # the 24 launches alone on fields rotated beforehand, the plane
        # zone kernel
        # and the rule's in turns (old, new, new, old): on one stream, and
        # on ZONE_STREAMS streams as diffuse_sweep_zones_kernel runs them
        krots = [sweep_cuda.rotate_to_zone(kappa, zone) for zone in plan.zones]
        k = sweep_cuda.ZONE_STREAMS

        def old(krot, zone):
            sweep_cuda.sweep_zone_plane_kernel(krot, zone, uvb, KPC,
                                               plan.weight)

        def new(shape):
            return lambda krot, zone: sweep_cluster.sweep_zone_cluster_kernel(
                krot, zone, uvb, KPC, plan.weight, shape)

        reps = 3
        sweep_cuda.ZONE_LAUNCHES = 0
        turns = {j: [time_ms(_zones_on_streams(krots, plan, fn, j), reps=reps)
                     for fn in (old, new(rule), new(rule), old)]
                 for j in (1, k)}
        res["old_launches"] += sweep_cuda.ZONE_LAUNCHES
        old_ms = {j: (t[0] + t[3]) / 2 for j, t in turns.items()}
        new_ms = {j: (t[1] + t[2]) / 2 for j, t in turns.items()}
        resident = sweep_cluster.resident_zone_clusters(krots[0],
                                                        plan.zones[0], KPC,
                                                        rule)
        items = [3 * -(-z.ndir // rule.group) for z in plan.zones]
        print(f"[11 zones] {n}^3 x {plan.n_directions} dirs {label}: the "
              f"size rule's shape C {rule.csize} G {rule.group} "
              f"{rule.threads} threads x {rule.cpt} cells, {rule.smem} B "
              f"shared, {resident} resident clusters, {min(items)}-"
              f"{max(items)} work items a zone; {launches} cluster zone "
              f"launches; vs the plain version max abs {err_abs:.3e} max "
              f"rel {err_rel:.3e} (tol {rtol:g}), vs the slab scan max rel "
              f"{scan_rel:.3e} (tol {scan_tol:g}), the plane zone kernel vs "
              f"the "
              f"plain version max rel {old_rel:.3e}; card {smi}")
        for j, t in turns.items():
            print(f"[11 zones] {n}^3 {label}, the 24 launches on {j} "
                  f"stream(s) in turns: plane zone kernel {t[0]:.3f} ms, "
                  f"cluster {t[1]:.3f}, {t[2]:.3f}, plane {t[3]:.3f} "
                  f"({old_ms[j] / new_ms[j]:.2f}x); cluster "
                  f"{ca / new_ms[j] * 1e3:.4e} cells*angles/s"
                  + (f", {100 * bound['bound_ms'] / new_ms[j]:.1f}% of the "
                     f"{bound['bound_ms']:.4f} ms FP32 bound (plane "
                     f"{100 * bound['bound_ms'] / old_ms[j]:.1f}%)"
                     if dtype == torch.float32 else "") + f"; card {smi}")
        # every launch shape on one stream and on k streams
        table = []
        for shape in shapes_at(n, dtype):
            its = [3 * -(-z.ndir // shape.group) for z in plan.zones]
            ms, ms_k = ((new_ms[1], new_ms[k]) if shape == rule else (
                time_ms(_zones_on_streams(krots, plan, new(shape), j),
                        reps=2) for j in (1, k)))
            res_c = sweep_cluster.resident_zone_clusters(
                krots[0], plan.zones[0], KPC, shape)
            table.append({"C": shape.csize, "G": shape.group,
                          "cpt": shape.cpt, "threads": shape.threads,
                          "resident_clusters": res_c, "ms": ms,
                          "ms_streams": ms_k, "rule": shape == rule})
            print(f"[11 zones] {n}^3 {label} (C, G) = ({shape.csize}, "
                  f"{shape.group}){' rule' * (shape == rule)}: {ms:.3f} ms "
                  f"for 24 launches, {ms_k:.3f} on {k} streams; "
                  f"{shape.threads} threads x {shape.cpt} "
                  f"cells, {res_c} resident clusters ({res_c * shape.csize} "
                  f"CTAs) for {min(its)}-{max(its)} work items a zone; "
                  f"card {smi}")
        res[label] = {"ms": new_ms[k], "one_stream_ms": new_ms[1],
                      "old_ms": old_ms[1], "old_streams_ms": old_ms[k],
                      "turns": turns,
                      "rule": [rule.csize, rule.group, rule.cpt,
                               rule.threads], "resident_clusters": resident,
                      "table": table, "max_rel_err": err_rel,
                      "scan_rel_err": scan_rel}
        if dtype == torch.float32:
            # several zones in flight: the rule's 24 launches dealt to k
            # streams, in turns with one stream (1, 2, 4, 4, 2, 1)
            flights = {j: _zones_on_streams(krots, plan, new(rule), j)
                       for j in (1, 2, 4)}
            order = [1, 2, 4, 4, 2, 1]
            times = [time_ms(flights[j], reps=reps) for j in order]
            res["streams_ms"] = {j: (times[order.index(j)] + times[
                len(order) - 1 - order.index(j)]) / 2 for j in flights}
            print(f"[11 zones] {n}^3 f32, the rule's 24 launches on k "
                  f"streams in turns (k = {order}): "
                  + ", ".join(f"{t:.3f}" for t in times) + " ms; card "
                  + smi)
            res["plain_ms"] = time_ms(_zones_on_streams(
                krots, plan, lambda krot, zone: sweep_cuda.sweep_zone_reference(
                    krot, zone, uvb, KPC, plan.weight), 1), reps=1,
                warmup=False)
            # the wrapper with its rotations (diffuse_sweep_zones_kernel's
            # loop), in turns over streams and shapes: the rule's shape on
            # 1, k and 2k streams, and the fastest G = 1 shape on one
            # stream on k and 2k streams; forward, then reverse
            g1 = min((sh for sh in shapes_at(n, dtype) if sh.group == 1),
                     key=lambda sh: (sh.cpt != rule.cpt,
                                     abs(sh.threads - 512), sh.csize))
            configs = [(rule, 1), (rule, k), (g1, k), (rule, 2 * k),
                       (g1, 2 * k)]
            wt = {c: [] for c in configs}
            for c in configs + configs[::-1]:
                wt[c].append(time_ms(lambda: sweep_cuda.zone_by_zone(
                    sweep_cluster.sweep_zone_cluster_kernel, kappa, plan,
                    uvb, KPC, streams=c[1], shape=c[0]), reps=reps))
            res["wrapper_ms"] = float(np.mean(wt[(rule, k)]))
            res["wrapper_one_stream_ms"] = float(np.mean(wt[(rule, 1)]))
            res["wrapper_table"] = [
                {"C": sh.csize, "G": sh.group, "cpt": sh.cpt,
                 "threads": sh.threads, "streams": j, "ms": t}
                for (sh, j), t in wt.items()]
            res["ship_ms"] = time_ms(lambda: sweep_cuda.diffuse_sweep_kernel(
                kappa, plan, uvb, KPC, "exact"), reps=3)
            print(f"[11 zones] {n}^3 f32: the plain versions of the 24 zones "
                  f"{res['plain_ms']:.1f} ms; the shipped sweep (merged "
                  f"cluster kernel, exact) {res['ship_ms']:.3f} ms; the "
                  f"wrapper with its rotations in turns (forward, reverse): "
                  + "; ".join(f"C {sh.csize} G {sh.group} {sh.threads} x "
                              f"{sh.cpt} on {j} stream(s) "
                              + "/".join(f"{x:.3f}" for x in t) + " ms"
                              for (sh, j), t in wt.items())
                  + f" (diffuse_sweep_zones_kernel: the rule's shape on "
                  f"{k}); card {smi}")
        del krots, kappa
    res["ms"] = res["f32"]["ms"]
    return res


def _zones_on_streams(krots, plan, zone_fn, k: int):
    """A callable running zone_fn(krot, zone) on every zone's rotated field,
    zone i on stream i % k of k side streams, which wait for the current
    stream first and which it waits for after."""
    streams = [torch.cuda.Stream() for _ in range(k)]

    def run():
        main = torch.cuda.current_stream()
        for s in streams:
            s.wait_stream(main)
        for i, (krot, zone) in enumerate(zip(krots, plan.zones)):
            with torch.cuda.stream(streams[i % k]):
                zone_fn(krot, zone)
        for s in streams:
            main.wait_stream(s)
    return run


def _check(name, label, kernel, ref, kappa, plan, tol) -> float:
    """One kernel against its plain version's output ref on one field (max
    elementwise relative error at probes_cuda.rel_err's floor, within tol);
    returns the max abs error."""
    from radiativetransfer_tpu_torch.constants import KPC
    out = kernel(kappa, plan, np.array([1.0, 0.5, 0.25]), KPC)
    torch.cuda.synchronize()
    err_abs, err_rel = _rel_err(out, ref)
    assert torch.isfinite(out).all() and err_rel <= tol, (name, label,
                                                          err_rel)
    return err_abs


def _check_experiment(name, mode, plane_kernel, plain, dtypes) -> dict:
    """An experiment's kernels against its plain version: the cluster
    instances in every launch shape at level 1 n 7 (n 6 for the pair, whose
    slabs go in twos) and level 2 n 8 (ragged row bands and groups; float32
    2e-6, float64 1e-12), the size rule's shape at 64^3 and 128^3 x 192 in
    float32 (1e-5: phase 3's tolerance for atomic sums), and the plane
    kernel there too.  Returns each kernel's largest abs error."""
    import functools as ft

    from radiativetransfer_tpu_torch.constants import KPC
    from radiativetransfer_tpu_torch.core import sweep, variants_cuda
    uvb = np.array([1.0, 0.5, 0.25])
    worst = {"cluster": 0.0, "plane": 0.0}
    shapes = 0
    for level, n in ((1, 6 if mode == "pair" else 7), (2, 8)):
        plan = sweep.build_sweep_plan(level, n)
        for dtype, tol in dtypes:
            kappa = _kappa(n, dtype)
            ref = plain(kappa, plan, uvb, KPC)
            for shape in variants_cuda.variant_shapes(n, dtype, mode):
                worst["cluster"] = max(worst["cluster"], _check(
                    name, f"level {level} n {n} {shape}", ft.partial(
                        variants_cuda.cluster_kernel, mode=mode, shape=shape),
                    ref, kappa, plan, tol))
                shapes += 1
    for n in (PROBE_N, MAIN_N):
        plan = sweep.build_sweep_plan(MAIN_LEVEL, n)
        kappa = _kappa(n)
        ref = plain(kappa, plan, uvb, KPC)
        for kernel, fn in (("cluster", ft.partial(variants_cuda.cluster_kernel,
                                                  mode=mode)),
                           ("plane", plane_kernel)):
            worst[kernel] = max(worst[kernel], _check(
                name, f"{kernel} {n}^3", fn, ref, kappa, plan, 1e-5))
        rule = variants_cuda.choose_variant_cluster(n, torch.float32, mode)
        print(f"[{name}] {n}^3 x {plan.n_directions} dirs f32: cluster "
              f"kernel (C {rule.csize} G {rule.group}, {rule.threads} x "
              f"{rule.cpt}) and the plane kernel vs the plain version "
              f"within 1e-5")
    print(f"[{name}] every launch shape ({shapes}) at level 1-2, n 6-8 "
          f"{[str(d).split('.')[-1] for d, _ in dtypes]} vs the plain "
          f"version: max abs {worst['cluster']:.3e}")
    return worst


def phase_pair() -> dict:
    """12: the two-slab sweep (kernel #6) on the cluster kernel and the plane
    kernel, then its experiment at 256^3."""
    import functools as ft

    from radiativetransfer_tpu_torch import exp_sweep_pair
    from radiativetransfer_tpu_torch.core import variants_cuda
    errs = _check_experiment(
        "12 pair", "pair", variants_cuda.sweep_pair_plane_kernel,
        variants_cuda.sweep_pair_reference,
        ((torch.float32, 2e-6), (torch.float64, 1e-12)))
    # float64 at 64^3 in the size rule's shape
    from radiativetransfer_tpu_torch.constants import KPC
    from radiativetransfer_tpu_torch.core import sweep
    kappa = _kappa(PROBE_N, torch.float64)
    plan = sweep.build_sweep_plan(MAIN_LEVEL, PROBE_N)
    errs["cluster"] = max(errs["cluster"], _check(
        "12 pair", f"f64 {PROBE_N}^3", ft.partial(
            variants_cuda.cluster_kernel, mode="pair"),
        variants_cuda.sweep_pair_reference(kappa, plan,
                                           np.array([1.0, 0.5, 0.25]), KPC),
        kappa, plan, 1e-12))
    variants_cuda.LAUNCHES.clear()
    variants_cuda.CLUSTER_LAUNCHES.clear()
    _zero_sweep_launches()
    res = exp_sweep_pair.main(ROOF_N, MAIN_LEVEL)
    launches = variants_cuda.CLUSTER_LAUNCHES["pair"]
    old = variants_cuda.LAUNCHES["pair"]
    ship, plane = _sweep_launches()
    # "ship" and the exact instance in the pair's shape are the cluster
    # sweep kernel's launches
    print(f"[12 pair] exp_sweep_pair launches: pair cluster {launches}, "
          f"plane kernel {old}, cluster sweep {ship}; at {ROOF_N}^3 vs "
          f"the plain version max rel {res['max_rel_err']:.3e}, plane "
          f"kernel {res['plane_max_rel_err']:.3e} (tol 1e-5)")
    assert launches > 0 and old > 0 and ship > 0 and plane == 0
    assert res["max_rel_err"] <= 1e-5, res["max_rel_err"]
    assert res["plane_max_rel_err"] <= 1e-5, res["plane_max_rel_err"]
    return {**res, "launches": launches, "old_launches": old,
            "sweep_launches": ship,
            "max_abs_err": max(errs["cluster"], res["max_abs_err"]),
            "old_max_abs_err": max(errs["plane"], res["plane_max_abs_err"])}


def phase_variants() -> dict:
    """13: every lean variant (kernel #7) on the cluster kernel and the plane
    kernel, then the experiment at 256^3 (each variant in turns with
    its yardsticks, the attribution) and the FP32 instructions per MUFU of
    expf and exp2f in the SASS."""
    import functools as ft

    from radiativetransfer_tpu_torch import exp_sweep_variants
    from radiativetransfer_tpu_torch.core import probes_cuda, variants_cuda
    errs = {}
    for v in variants_cuda.VARIANTS:
        errs[v] = _check_experiment(
            f"13 {v}", v, ft.partial(variants_cuda.lean_sweep_plane_kernel,
                                     variant=v),
            ft.partial(variants_cuda.lean_sweep_reference, variant=v),
            ((torch.float32, 2e-6),))
    variants_cuda.LAUNCHES.clear()
    variants_cuda.CLUSTER_LAUNCHES.clear()
    _zero_sweep_launches()
    res = exp_sweep_variants.main(ROOF_N, MAIN_LEVEL)
    launches = {v: variants_cuda.CLUSTER_LAUNCHES[v]
                for v in variants_cuda.VARIANTS}
    old = {v: variants_cuda.LAUNCHES[v] for v in variants_cuda.VARIANTS}
    ship, plane = _sweep_launches()
    print(f"[13 variants] exp_sweep_variants launches: cluster {launches}, "
          f"the plane kernel {old}, cluster sweep {ship}")
    assert all(c > 0 for c in launches.values())
    assert all(c > 0 for c in old.values()) and ship > 0 and plane == 0
    for body, m in res["sass_probes"].items():
        assert m["mufu"] > 0 and m["fp32_per_mufu"] == \
            probes_cuda.FP32_PER_STEP[body], (body, m)
    for v, r in res["variants"].items():
        print(f"[13 variants] {v} at {ROOF_N}^3 vs its plain version: max "
              f"rel {r['max_rel_err']:.3e}, the plane kernel "
              f"{r['plane_max_rel_err']:.3e} (tol 1e-5)")
        assert r["max_rel_err"] <= 1e-5, (v, r["max_rel_err"])
        assert r["plane_max_rel_err"] <= 1e-5, (v, r["plane_max_rel_err"])
        errs[v] = {"cluster": max(errs[v]["cluster"], r["max_abs_err"]),
                   "plane": max(errs[v]["plane"], r["plane_max_abs_err"])}
    return {**res, "launches": launches, "old_launches": old, "errs": errs,
            "sweep_launches": ship}


def phase_scatter() -> dict:
    """14: the row scatter (kernel #8) through its experiment: the kernel
    against np.add.at and index_add_, in turns with index_add_, the host
    and device time per call of each, and the float4 reduction floor."""
    from radiativetransfer_tpu_torch import exp_row_scatter
    from radiativetransfer_tpu_torch.core import scatter_cuda
    scatter_cuda.LAUNCHES = scatter_cuda.FLOOR_LAUNCHES = 0
    res = exp_row_scatter.main()
    launches = scatter_cuda.LAUNCHES
    print(f"[14 scatter] exp_row_scatter launches {launches}, floor probe "
          f"{scatter_cuda.FLOOR_LAUNCHES}")
    assert launches > 0 and scatter_cuda.FLOOR_LAUNCHES > 0
    for m, r in res["m"].items():
        k, a = r["split"]["kernel"], r["split"]["index_add_"]
        print(f"[14 scatter] M={m}: kernel {r['ms']:.4f} "
              f"ms a call in turns, index_add_ {r['plain_ms']:.4f}; host "
              f"{k['host_us']:.2f} us a call (index_add_ {a['host_us']:.2f},"
              f" the bare library call {r['split']['bare_call']['host_us']:.2f}"
              f"), device {k['device_us']:.2f} us (index_add_ "
              f"{a['device_us']:.2f}; {k['device_method']}); vs "
              f"float64 np.add.at max abs {r['max_abs_err']:.3e}, vs "
              f"index_add_ {r['max_abs_err_vs_plain']:.3e} (tol 1e-5)")
        assert r["max_abs_err"] <= 1e-5 and r["max_abs_err_vs_plain"] <= \
            1e-5, (m, r["max_abs_err"], r["max_abs_err_vs_plain"])
    assert all(f["exact"] for f in res["floor"].values()), res["floor"]
    return {**res, "launches": launches,
            "floor_launches": scatter_cuda.FLOOR_LAUNCHES}


def _mesh_zone_runs(fn, blocks, plan, uvb, **kw):
    """A callable running fn on every zone's blocks (fn(blocks, zone, uvb,
    cell, weight)), and the list its last run fills."""
    from radiativetransfer_tpu_torch.constants import KPC
    outs = []

    def run():
        outs[:] = [fn(b, zone, uvb, KPC, plan.weight, **kw)
                   for b, zone in zip(blocks, plan.zones)]
    return run, outs


def _ring_runs(blocks, plan, uvb, zones, **kw):
    """A callable running the cluster ring on the blocks of `zones`, its
    launches marking one status; the status."""
    from radiativetransfer_tpu_torch.constants import KPC
    from radiativetransfer_tpu_torch.parallel import sweep_rdma
    status = torch.zeros(1, dtype=torch.int32, device=DEVICE)

    def run():
        for i in zones:
            sweep_rdma.sweep_zone_ring_cluster_kernel(
                blocks[i], plan.zones[i], uvb, KPC, plan.weight,
                status=status, **kw)
    return run, status


def _mesh_sweep_at(n: int, p: int, dtype, smi: str, table: bool,
                   wrapper: bool) -> dict:
    """The ring's 24 launches alone on blocks split beforehand: the path's
    kernels (each zone the cluster ring in its size rule's shape, or the
    plane ring where no shape's ring is co-resident) and the plane ring
    (csrc/sweep_rdma.cu) in turns (plane, path, path, plane), both against
    their plain versions (the pipelined scan on the kernels' tables, timed
    once); with `table` every launch shape of the cluster ring (on the
    zones whose rings it holds at once), with `wrapper` the whole
    diffuse_sweep_rdma.  Every run's launches mark one status, checked after
    (a wrapper given none checks its own after each launch, which waits
    for the card)."""
    from radiativetransfer_tpu_torch.constants import KPC
    from radiativetransfer_tpu_torch.core import sweep, sweep_cluster, sweep_cuda
    from radiativetransfer_tpu_torch.core.probes_cuda import time_ms
    from radiativetransfer_tpu_torch.parallel import mesh as pmesh
    from radiativetransfer_tpu_torch.parallel import sweep_rdma
    uvb = np.array([1.0, 0.5, 0.25])
    label = "f32" if dtype == torch.float32 else "f64"
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    plan = sweep.build_sweep_plan(MAIN_LEVEL, n)
    kappa = _kappa(n, dtype)
    mesh = pmesh.make_grid_mesh(p, device=DEVICE)
    nz = n // p
    blocks = [pmesh.to_blocks(sweep_cuda.rotate_to_zone(kappa, zone), mesh)
              for zone in plan.zones]
    ndir = max(z.ndir for z in plan.zones)
    rule = sweep_rdma.ring_rule(p, n, nz, ndir, dtype, DEVICE)
    on_cluster = sum(sweep_rdma.ring_rule(p, n, nz, z.ndir, dtype, DEVICE)
                     is not None for z in plan.zones)
    status = torch.zeros(1, dtype=torch.int32, device=DEVICE)
    # as diffuse_sweep_rdma runs them: each zone its own rule's shape, or
    # the plane ring where no shape's ring is co-resident
    new, outs = _mesh_zone_runs(sweep_rdma.sweep_zone_rdma_kernel, blocks,
                                plan, uvb, status=status)
    shapes = {}
    for z in plan.zones:
        r = sweep_rdma.ring_rule(p, n, nz, z.ndir, dtype, DEVICE)
        key = "plane ring" if r is None else (
            f"C {r.csize} G {r.group} {r.threads} x {r.cpt}")
        shapes.setdefault(key, []).append(z.ndir)
    what = ("each zone its own kernel (" + "; ".join(
        f"{key}: {len(v)} zones of {min(v)}-{max(v)} directions"
        for key, v in shapes.items()) + ")")
    old, old_outs = _mesh_zone_runs(sweep_rdma.sweep_zone_ring_plane_kernel,
                                    blocks, plan, uvb, status=status)
    reps = 3
    before = (sweep_rdma.RDMA_LAUNCHES, sweep_rdma.RING_LAUNCHES)
    turns = [time_ms(fn, reps=reps) for fn in (old, new, new, old)]
    # the plane ring's own turns: 2 x (reps + a warm-up) x 24 launches
    old_launches = 2 * (reps + 1) * len(plan.zones)
    assert sweep_rdma.RDMA_LAUNCHES - before[0] == old_launches + 2 * (
        reps + 1) * (len(plan.zones) - on_cluster)
    assert sweep_rdma.RING_LAUNCHES - before[1] == 2 * (reps + 1) * on_cluster
    sweep_rdma.check_status(status)
    plain, refs = _mesh_zone_runs(sweep_rdma.sweep_zone_rdma_reference,
                                  blocks, plan, uvb)
    plain_ms = time_ms(plain, reps=1, warmup=False)
    errs = [_rel_err(o, r) for o, r in zip(outs, refs)]
    old_errs = [_rel_err(o, r) for o, r in zip(old_outs, refs)]
    err_abs, err_rel = max(e[0] for e in errs), max(e[1] for e in errs)
    old_rel = max(e[1] for e in old_errs)
    assert all(torch.isfinite(o).all() for o in outs)
    assert err_rel <= rtol and old_rel <= rtol, (n, p, label, err_rel,
                                                 old_rel)
    out = {"ms": (turns[1] + turns[2]) / 2, "old_ms": (turns[0] + turns[3]) / 2,
           "turns": turns, "plain_ms": plain_ms, "max_abs_err": err_abs,
           "old_max_abs_err": max(e[0] for e in old_errs),
           "rule": rule and [rule.csize, rule.group, rule.cpt, rule.threads],
           "zones_on_cluster": on_cluster, "zones": len(plan.zones),
           "old_launches": old_launches}
    print(f"[15 mesh] ring {n}^3 x {plan.n_directions} dirs {label}, P {p}: "
          f"{what}; the 24 launches in turns: plane ring {turns[0]:.3f} ms, "
          f"path {turns[1]:.3f}, {turns[2]:.3f}, plane {turns[3]:.3f} "
          f"({out['old_ms'] / out['ms']:.2f}x)"
          f"; {n ** 3 * plan.n_directions / out['ms'] * 1e3:.4e} "
          f"cells*angles/s; plain versions {plain_ms:.1f} ms; path max "
          f"abs {err_abs:.3e} max rel {err_rel:.3e}, plane ring max rel "
          f"{old_rel:.3e} (tol {rtol:g}); card {smi}")
    del outs, old_outs, refs
    if table:
        # every launch shape on the zones whose rings it holds at once
        rows = []
        for shape in sweep_cluster.ring_shapes(n, nz, dtype):
            res_c = sweep_rdma.resident_ring_clusters(shape, dtype, DEVICE,
                                                      n, nz)
            fit = [i for i, z in enumerate(plan.zones)
                   if sweep_cluster.ring_clusters(p, z.ndir, shape.group)
                   <= res_c]
            row = {"C": shape.csize, "G": shape.group, "cpt": shape.cpt,
                   "threads": shape.threads, "resident_clusters": res_c,
                   "zones": len(fit), "rule": shape == rule}
            rows.append(row)
            if not fit:
                print(f"[15 mesh] ring {n}^3 {label} P {p} (C, G, cpt) = "
                      f"({shape.csize}, {shape.group}, {shape.cpt}): no "
                      f"zone's ring co-resident ({res_c} clusters resident)")
                continue
            cl = max(sweep_cluster.ring_clusters(p, plan.zones[i].ndir,
                                                 shape.group) for i in fit)
            run1, st1 = _ring_runs(blocks, plan, uvb, fit, shape=shape)
            run1()      # the card busy again after the shapes that do not fit
            row["ms"] = time_ms(run1, reps=2)
            # each zone's launch alone: the size rule compares shapes zone
            # by zone
            row["zone_ms"] = {}
            for i in fit:
                run_i, st_i = _ring_runs(blocks, plan, uvb, [i], shape=shape)
                row["zone_ms"][i] = time_ms(run_i, reps=3)
                sweep_rdma.check_status(st_i)
            sweep_rdma.check_status(st1)
            by_ndir = {}
            for i, ms in row["zone_ms"].items():
                by_ndir.setdefault(plan.zones[i].ndir, []).append(ms)
            print(f"[15 mesh] ring {n}^3 {label} P {p} (C, G, cpt) = "
                  f"({shape.csize}, {shape.group}, {shape.cpt})"
                  f"{' rule' * (shape == rule)}: {row['ms']:.3f} ms for "
                  f"{len(fit)} launches"
                  + f"; {shape.threads} threads, at most {cl} clusters of "
                  f"{res_c} resident; a zone alone by its directions: "
                  + ", ".join(f"{d}: {np.mean(v):.3f}"
                              for d, v in sorted(by_ndir.items()))
                  + f" ms; card {smi}")
        out["table"] = rows
    del blocks
    if wrapper:
        out["wrapper_ms"] = time_ms(lambda: sweep_rdma.diffuse_sweep_rdma(
            kappa, plan, uvb, KPC, mesh), reps=3)
        print(f"[15 mesh] ring {n}^3 {label} P {p}: diffuse_sweep_rdma (48 "
              f"rotations, 48 block copies, 24 launches) "
              f"{out['wrapper_ms']:.3f} ms; card {smi}")
    return out


def _mesh_step_check(label, model, out, init, one_device, tol=1e-4) -> None:
    """A mesh step's output against the same strategy on one rank (the
    same arithmetic and tables, no halo: Jmean within tol elementwise) and
    against one device's "auto" step with the exact logmean (the neutral
    fraction within tol relative, Jmean within tol of its peak: the merged
    sweep kernels round the exact logmean's (1 - a)/tau otherwise, and in
    float32 an ulp of exp over a tau just above 1e-4 is ~6e-4 of one
    segment's emission, ROADMAP, faults found in the port)."""
    from radiativetransfer_tpu_torch.parallel import mesh as pmesh
    one_rank = model.make_step(mesh=pmesh.make_grid_mesh(1, device=DEVICE))(
        init)
    r_abs, r_rel = _rel_err(out.Jmean, one_rank.Jmean)
    nf, nf_ref = (model.neutral_fraction(out),
                  model.neutral_fraction(one_device))
    rel = abs(nf - nf_ref) / nf_ref
    j_abs, j_rel = _rel_err(out.Jmean, one_device.Jmean)
    peak = float(one_device.Jmean.abs().max())
    print(f"[15 mesh] {label}: Jmean vs one rank max abs {r_abs:.3e} max "
          f"rel {r_rel:.3e} (tol {tol:g}); vs one device's step: neutral "
          f"fraction {nf:.7f} vs {nf_ref:.7f} (rel {rel:.2e}, tol {tol:g}), "
          f"Jmean max abs {j_abs:.3e} = {j_abs / peak:.2e} of the peak "
          f"(tol {tol:g}), max rel {j_rel:.3e}")
    assert bool(torch.isfinite(out.HI).all())
    assert r_rel <= tol and rel <= tol and j_abs <= tol * peak, (
        label, r_rel, rel, j_abs / peak)


def phase_mesh(smi: str) -> dict:
    """15: the mode-9 path on a 1-D mesh of P ranks on the card, with the
    ring sweep (kernel #3), the pipelined and the zones strategies."""
    import radiativetransfer_tpu_torch as rt
    from radiativetransfer_tpu_torch.constants import KPC
    from radiativetransfer_tpu_torch.core import (
        probes_cuda,
        sweep,
        sweep_cluster,
        sweep_cuda,
    )
    from radiativetransfer_tpu_torch.core.probes_cuda import time_ms
    from radiativetransfer_tpu_torch.parallel import mesh as pmesh
    from radiativetransfer_tpu_torch.parallel import sweep_dist, sweep_rdma
    from radiativetransfer_tpu_torch.profile_step import galaxy_state
    uvb = np.array([1.0, 0.5, 0.25])
    mesh4 = pmesh.make_grid_mesh(4, device=DEVICE)

    # the 24^3 anchor through the ring on 4 ranks
    model = _rtmodel(24, 1, 200.0, DEVICE, sweep_strategy="rdma")
    state = pmesh.shard_state(rt.uniform_state(
        24, nh=1e-4, tgas=2e4, dtype=torch.float32, device=DEVICE), mesh4)
    before = (sweep_rdma.RING_LAUNCHES, sweep_rdma.RDMA_LAUNCHES)
    nf = model.neutral_fraction(model.make_step(mesh=mesh4)(state))
    rel = abs(nf - ANCHOR_NF) / ANCHOR_NF
    launches = sweep_rdma.RING_LAUNCHES - before[0]
    print(f"[15 mesh] 24^3 level 1 f32 mode 9, rdma on 4 ranks: neutral "
          f"fraction {nf:.7f} vs {ANCHOR_NF} (rel {rel:.2e}, tol "
          f"{ANCHOR_RTOL:g}); cluster ring launches {launches}")
    assert launches == len(model.sweep_plan.zones) and rel <= ANCHOR_RTOL
    assert sweep_rdma.RDMA_LAUNCHES == before[1]

    # small grids at P = 1, 2, 4, 8 against the pipelined plain version
    # and the slab scan, through the cluster ring (f32 1e-5: the exact
    # logmean rounded as the cluster kernel rounds it, atomic sums)
    worst = 0.0
    sweep_rdma.RING_LAUNCHES = 0
    for level, n in [(1, 8), (2, 8)]:
        plan = sweep.build_sweep_plan(level, n)
        for dtype, rtol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
            kappa = _kappa(n, dtype)
            scan = sweep.diffuse_sweep(kappa, plan, uvb, KPC)
            for p in (1, 2, 4, 8):
                mesh = pmesh.make_grid_mesh(p, device=DEVICE)
                out = sweep_rdma.diffuse_sweep_rdma(kappa, plan, uvb, KPC,
                                                    mesh)
                pipe = sweep_dist.diffuse_sweep_pipelined(kappa, plan, uvb,
                                                          KPC, mesh)
                e_pipe, e_scan = _rel_err(out, pipe), _rel_err(out, scan)
                print(f"[15 mesh] ring level {level} n {n} {dtype} P {p}: "
                      f"vs pipelined max rel {e_pipe[1]:.3e}, vs slab scan "
                      f"{e_scan[1]:.3e} (rtol {rtol:g})")
                assert max(e_pipe[1], e_scan[1]) <= rtol, (level, p, dtype)
                worst = max(worst, e_pipe[0])
    # one launch a zone, every sweep's rings co-resident at n 8
    small_launches = sweep_rdma.RING_LAUNCHES
    assert small_launches == 2 * 4 * sum(
        len(sweep.build_sweep_plan(level, 8).zones) for level in (1, 2)), \
        small_launches

    # full width: 128^3 x 192 at P = 1, 2, 4 and 256^3 at P = 4, each
    # kernel against its plain version, the cluster ring and the plane
    # ring in turns; every shape of the cluster ring at 128^3 P = 4 (f32
    # and f64) and P = 1 (f32)
    sweep_rdma.RING_LAUNCHES = sweep_rdma.RDMA_LAUNCHES = 0
    full = {p: _mesh_sweep_at(MAIN_N, p, torch.float32, smi, p != 2, True)
            for p in (1, 2, 4)}
    full["f64"] = _mesh_sweep_at(MAIN_N, 4, torch.float64, smi, True, False)
    full["big"] = _mesh_sweep_at(TIMING_NS[-1], 4, torch.float32, smi, False,
                                 False)
    # the path at 128^3 P = 4 in f32 is the cluster ring's alone
    assert full[4]["zones_on_cluster"] == full[4]["zones"], full[4]
    sweep_launches = sweep_rdma.RING_LAUNCHES
    old_launches = sweep_rdma.RDMA_LAUNCHES
    n, level = MAIN_N, MAIN_LEVEL
    plan = sweep.build_sweep_plan(level, n)
    kappa = _kappa(n)
    zones_ms = time_ms(lambda: sweep_cuda.diffuse_sweep_zones_kernel(
        kappa, plan, uvb, KPC), reps=3)
    ship_ms = time_ms(lambda: sweep_cuda.diffuse_sweep_kernel(
        kappa, plan, uvb, KPC, "exact"), reps=3)
    print(f"[15 mesh] {n}^3 x {plan.n_directions} beside the ring: the "
          f"shipped sweep (cluster kernel, exact) {ship_ms:.3f} ms, the "
          f"per-zone sweep "
          f"(diffuse_sweep_zones_kernel) {zones_ms:.3f} ms; cluster ring "
          f"launches {sweep_launches}, plane ring launches {old_launches}")
    del kappa

    # the mode-9 step at 128^3 x 192 on 4 ranks through the ring, against
    # one rank's and one device's "auto" step (the exact logmean, the
    # ring's)
    box = 300.0
    model = _rtmodel(n, level, box, DEVICE, self_shielding_threshold_kpc=0.1,
                     sweep_strategy="rdma")
    one = _rtmodel(n, level, box, DEVICE, self_shielding_threshold_kpc=0.1,
                   sweep_logmean="exact")
    init = model.initialize_equilibrium(galaxy_state(n, box, DEVICE))
    state = pmesh.shard_state(init, mesh4)
    step = model.make_step(mesh=mesh4)
    sweep_rdma.RING_LAUNCHES = sweep_rdma.RDMA_LAUNCHES = 0
    rdma_steps = []
    for it in range(1, 4):
        before = sweep_rdma.RING_LAUNCHES
        t0 = time.perf_counter()
        state = step(state)
        torch.cuda.synchronize()
        rdma_steps.append(time.perf_counter() - t0)
        print(f"[15 mesh] {n}^3 x {plan.n_directions} f32 mode 9, rdma on 4 "
              f"ranks: step {it} neutral fraction "
              f"{model.neutral_fraction(state):.7f} wall "
              f"{rdma_steps[-1]:.4f} s, cluster ring launches "
              f"{sweep_rdma.RING_LAUNCHES - before}")
        assert sweep_rdma.RING_LAUNCHES - before == len(plan.zones)
        if it == 1:
            first = state
    step_launches = sweep_rdma.RING_LAUNCHES
    assert sweep_rdma.RDMA_LAUNCHES == 0, "the step took the plane ring"
    one_step = one.make_step()(init)
    _mesh_step_check(f"{n}^3 step 1, rdma on 4 ranks", model, first, init,
                     one_step)

    # the zones strategy at 128^3 x 192 on the same mesh: 3 steps, each
    # rank's zones through the per-zone cluster kernel (24 launches a
    # step), step 1 against one rank's and one device's
    zones = _rtmodel(n, level, box, DEVICE, self_shielding_threshold_kpc=0.1,
                     sweep_strategy="zones")
    step = zones.make_step(mesh=mesh4)
    state = pmesh.shard_state(init, mesh4)
    sweep_cluster.ZONE_LAUNCHES = sweep_cuda.ZONE_LAUNCHES = 0
    zone_steps = []
    for it in range(1, 4):
        before = sweep_cluster.ZONE_LAUNCHES
        t0 = time.perf_counter()
        state = step(state)
        torch.cuda.synchronize()
        zone_steps.append(time.perf_counter() - t0)
        print(f"[15 mesh] {n}^3 x {plan.n_directions} f32 mode 9, zones on "
              f"4 ranks: step {it} neutral fraction "
              f"{zones.neutral_fraction(state):.7f} wall "
              f"{zone_steps[-1]:.4f} s, cluster zone launches "
              f"{sweep_cluster.ZONE_LAUNCHES - before}")
        assert sweep_cluster.ZONE_LAUNCHES - before == len(plan.zones)
        if it == 1:
            first = state
    zone_launches = sweep_cluster.ZONE_LAUNCHES
    assert sweep_cuda.ZONE_LAUNCHES == 0, "the zones took the plane kernel"
    _mesh_step_check(f"{n}^3 step 1, zones on 4 ranks", zones, first, init,
                     one_step)
    del one_step, first, state

    # the pipelined strategy (plain PyTorch), one step at 64^3
    n64 = PROBE_N
    one = _rtmodel(n64, level, box, DEVICE, self_shielding_threshold_kpc=0.1,
                   sweep_logmean="exact")
    init = one.initialize_equilibrium(galaxy_state(n64, box, DEVICE))
    other = _rtmodel(n64, level, box, DEVICE,
                     self_shielding_threshold_kpc=0.1,
                     sweep_strategy="pipelined")
    before = (sweep_cluster.ZONE_LAUNCHES, sweep_cuda.ZONE_LAUNCHES)
    out = other.make_step(mesh=mesh4)(pmesh.shard_state(init, mesh4))
    assert (sweep_cluster.ZONE_LAUNCHES, sweep_cuda.ZONE_LAUNCHES) == before
    _mesh_step_check(f"{n64}^3 step, pipelined on 4 ranks", other, out, init,
                     one.make_step()(init))

    # a ring that cannot be co-resident is refused, never launched: the
    # plane ring on 2 ranks of a 128^3 float64 field at level 4 (3 planes
    # of 128 x 64 fill one SM's shared memory; zone 1's 31 directions x 3
    # bands x 2 ranks = 186 CTAs), and the cluster ring on 8 ranks of a
    # 128^3 float32 field at level 4 in a shape of 744 clusters of 2 CTAs
    # x 512 threads
    zone = sweep.build_sweep_plan(4, n).zones[0]
    blocks = torch.rand((2, n, 3, n, n // 2), dtype=torch.float64,
                        device=DEVICE)
    before = (sweep_rdma.RDMA_LAUNCHES, sweep_rdma.RING_LAUNCHES)
    try:
        sweep_rdma.sweep_zone_rdma_kernel(blocks, zone, uvb, KPC, 1 / 768,
                                          plane_memory="shared")
    except RuntimeError as e:
        refused = str(e)
    else:
        raise AssertionError("a ring of 186 CTAs of 192 KiB each ran")
    blocks = torch.rand((8, n, 3, n, n // 8), dtype=torch.float32,
                        device=DEVICE)
    shape = sweep_cluster.cluster_shapes(n, n // 8, torch.float32, 2, 1,
                                         ring=True)[0]
    try:
        sweep_rdma.sweep_zone_ring_cluster_kernel(blocks, zone, uvb, KPC,
                                                  1 / 768, shape)
    except RuntimeError as e:
        refused_cluster = str(e)
    else:
        raise AssertionError("a cluster ring of 744 clusters ran")
    del blocks
    assert "co-resident" in refused and "co-resident" in refused_cluster
    assert (sweep_rdma.RDMA_LAUNCHES, sweep_rdma.RING_LAUNCHES) == before
    print(f"[15 mesh] refused as they should be: {refused}; "
          f"{refused_cluster}")

    counts = dict(sweep_cuda.work_counts(plan))
    counts["bytes"] += sweep_rdma.halo_bytes(plan, 4, n, 4)
    bound = probes_cuda.sweep_bound(counts, probes_cuda.MUFU_PER_S)
    print(f"[15 mesh] ring bound at {n}^3, P 4: {bound['bound_ms']:.4f} ms "
          f"set by {bound['binding']} (bytes with the halo lines "
          f"{bound['bytes_ms']:.4f} ms); cluster ring {full[4]['ms']:.3f} ms "
          f"({100 * bound['bound_ms'] / full[4]['ms']:.1f}% of the bound); "
          f"plane ring "
          f"{full[4]['old_ms']:.3f} "
          f"({100 * bound['bound_ms'] / full[4]['old_ms']:.1f}%)")
    return {"full": full, "bound": bound, "zones_ms": zones_ms,
            "ship_ms": ship_ms, "zone_launches": zone_launches,
            "zone_steps_s": zone_steps, "rdma_steps_s": rdma_steps,
            "launches": {"rdma_sweep": sweep_launches + small_launches,
                         "mode9_mesh": step_launches},
            "old_launches": {"rdma_sweep": old_launches},
            "max_abs_err": max(worst, *(r["max_abs_err"]
                                        for r in full.values())),
            "old_max_abs_err": max(r["old_max_abs_err"]
                                   for r in full.values())}


def main() -> None:
    smi = phase_probe()
    phase_build()
    errs = phase_kernel_vs_plain()
    phase_anchor()
    launches9 = phase_main_path()
    times = phase_timings()
    probes = phase_probes()
    phase_anchor8()
    launches8 = phase_mode8()
    bench_out = phase_bench()
    zones = phase_zones(smi)
    pair = phase_pair()
    variants = phase_variants()
    scatter = phase_scatter()
    mesh = phase_mesh(smi)
    # the cluster sweep kernel's launches on each path that runs it, each
    # count set to 0 just before its path (the plane kernel's: phase 6)
    sweep_paths = {"mode9": launches9, "mode8": launches8,
                   "timing": times["launches"]["cluster"],
                   "roofline": probes["sweep_launches"],
                   "bench": bench_out["launches"]["sweep"],
                   "exp_sweep_pair": pair["sweep_launches"],
                   "exp_sweep_variants": variants["sweep_launches"]}
    assert all(v > 0 for v in sweep_paths.values()), sweep_paths
    assert times["launches"]["plane"] > 0
    line = _kernels_line(errs, times, probes, sweep_paths, bench_out)
    line += _new_kernels(zones, pair, variants, scatter, mesh)
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
    t = times[MAIN_N]
    print(f"sweep bound at {MAIN_N}^3: {b['bound_ms']:.4f} ms set by "
          f"{b['binding']} (bytes {b['bytes_ms']:.4f}, exp "
          f"{b['exp_ms']:.4f} at the MUFU rate, {b['exp_measured_ms']:.4f} "
          f"at the measured expf rate, fp32 {b['fp32_ms']:.4f} ms); cluster "
          f"kernel {t['cluster_ms']:.3f} ms, "
          f"{100 * b['bound_ms'] / t['cluster_ms']:.1f}% of the bound; plane "
          f"kernel {t['plane_ms']:.3f} ms, "
          f"{100 * b['bound_ms'] / t['plane_ms']:.1f}%")
    probe_src = "radiativetransfer_tpu_torch/csrc/probes.cu"
    bench_probes = bench_out["launches"]["probes"]
    plane_paths = {"timing": times["launches"]["plane"]}
    line = [{
        "name": "sweep_merged",
        "route": "cuda",
        "source": "radiativetransfer_tpu_torch/csrc/sweep_merged.cu",
        "replaces": "radiativetransfer_tpu/core/sweep_pallas.py:287",
        "launches": sum(plane_paths.values()),
        "launches_by_path": plane_paths,
        "max_abs_err": errs["plane"],
        "ms": t["plane_ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": b["bound_ms"],
        "bound_by": b["bound_by"],
        "library_ms": None,
    }, {
        "name": "sweep_cluster",
        "route": "cuda",
        "source": "radiativetransfer_tpu_torch/csrc/sweep_cluster.cu",
        "replaces": "radiativetransfer_tpu/core/sweep_pallas.py:287",
        "launches": sum(sweep_paths.values()),
        "launches_by_path": sweep_paths,
        "max_abs_err": errs["cluster"],
        "ms": t["cluster_ms"],
        "plain_ms": t["plain_ms"],
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


def _new_kernels(zones, pair, variants, scatter, mesh) -> list:
    """The kernels line's entries of kernels #2, #6, #7, #8 and #3 (#6
    and #7: the cluster instances, then the plane kernels)."""
    from radiativetransfer_tpu_torch.core import (
        probes_cuda,
        scatter_cuda,
        sweep,
        sweep_cuda,
    )
    src = "radiativetransfer_tpu_torch/csrc/sweep_variants.cu"
    exp_src = "radiativetransfer_tpu_torch/csrc/sweep_cluster_exp.cu"
    line = [{
        "name": "sweep_zone_cluster", "route": "cuda",
        "source": "radiativetransfer_tpu_torch/csrc/sweep_cluster.cu",
        "replaces": "radiativetransfer_tpu/core/sweep_pallas.py:65",
        "launches": zones["launches"] + mesh["zone_launches"],
        "launches_by_path": {"zones": zones["launches"],
                             "mode9_mesh_zones": mesh["zone_launches"]},
        "max_abs_err": zones["max_abs_err"], "ms": zones["ms"],
        "plain_ms": zones["plain_ms"], "bound_ms": zones["bound_ms"],
        "bound_by": zones["bound_by"], "library_ms": None,
        "shape": zones["f32"]["rule"], "f64_ms": zones["f64"]["ms"],
        "one_stream_ms": zones["f32"]["one_stream_ms"],
        "streams_ms": zones["streams_ms"], "wrapper_ms": zones["wrapper_ms"],
    }, {
        "name": "sweep_zone", "route": "cuda", "source": src,
        "replaces": "radiativetransfer_tpu/core/sweep_pallas.py:65",
        "launches": zones["old_launches"],
        "launches_by_path": {"zone_turns": zones["old_launches"]},
        "max_abs_err": zones["old_max_abs_err"],
        "ms": zones["f32"]["old_ms"], "plain_ms": zones["plain_ms"],
        "bound_ms": zones["bound_ms"], "bound_by": zones["bound_by"],
        "library_ms": None, "f64_ms": zones["f64"]["old_ms"],
        "streams_ms": zones["f32"]["old_streams_ms"],
    }, {
        "name": "sweep_pair_cluster", "route": "cuda", "source": exp_src,
        "replaces": "scripts/exp_sweep_pair.py:53",
        "launches": pair["launches"],
        "launches_by_path": {"exp_sweep_pair": pair["launches"]},
        "max_abs_err": pair["max_abs_err"], "ms": pair["ms"],
        "plain_ms": pair["plain_ms"], "bound_ms": pair["bound_ms"],
        "bound_by": pair["bound_by"], "library_ms": None,
        "shape": pair["rule"], "plane_ms": pair["plane_ms"],
        "exact_ms": pair["exact_ms"], "turns": pair["turns"],
    }, {
        "name": "sweep_pair", "route": "cuda", "source": src,
        "replaces": "scripts/exp_sweep_pair.py:53",
        "launches": pair["old_launches"],
        "launches_by_path": {"exp_sweep_pair": pair["old_launches"]},
        "max_abs_err": pair["old_max_abs_err"], "ms": pair["plane_ms"],
        "plain_ms": pair["plain_ms"], "bound_ms": pair["bound_ms"],
        "bound_by": pair["bound_by"], "library_ms": None,
    }]
    for v, r in variants["variants"].items():
        cut = variants["attribution"].get(v)
        line.append({
            "name": f"sweep_lean_cluster_{v}", "route": "cuda",
            "source": exp_src, "replaces": "scripts/exp_sweep_variants.py:71",
            "launches": variants["launches"][v],
            "launches_by_path": {"exp_sweep_variants":
                                 variants["launches"][v]},
            "max_abs_err": variants["errs"][v]["cluster"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "shape": r["rule"], "plane_ms": r["plane_ms"],
            f"{r['merged']}_ms": r["merged_ms"], "turns": r["turns"],
            **({"attribution": cut} if cut else {})})
        line.append({
            "name": f"sweep_lean_{v}", "route": "cuda", "source": src,
            "replaces": "scripts/exp_sweep_variants.py:71",
            "launches": variants["old_launches"][v],
            "launches_by_path": {"exp_sweep_variants":
                                 variants["old_launches"][v]},
            "max_abs_err": variants["errs"][v]["plane"],
            "ms": r["plane_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
    top = scatter["m"][max(scatter["m"])]
    scatter_src = "radiativetransfer_tpu_torch/csrc/scatter_rows.cu"
    line.append({
        "name": "scatter_rows", "route": "cuda", "source": scatter_src,
        "replaces": "scripts/exp_pallas_scatter.py:45",
        "launches": scatter["launches"],
        "launches_by_path": {"exp_row_scatter": scatter["launches"]},
        "max_abs_err": max(r["max_abs_err"] for r in scatter["m"].values()),
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": "bytes",
        "library_ms": top["library_ms"],
        "host_us": top["split"]["kernel"]["host_us"],
        "device_us": top["split"]["kernel"]["device_us"],
        "library_host_us": top["split"]["index_add_"]["host_us"],
        "library_device_us": top["split"]["index_add_"]["device_us"]})
    fl = scatter["floor"]["hbm"]
    line.append({
        "name": "scatter_red_floor", "route": "cuda", "source": scatter_src,
        "replaces": "scripts/exp_pallas_scatter.py:45",
        "launches": scatter["floor_launches"],
        "launches_by_path": {"exp_row_scatter": scatter["floor_launches"]},
        "max_abs_err": 0.0, "ms": fl["ms"], "plain_ms": fl["plain_ms"],
        "bound_ms": fl["bound_ms"], "bound_by": "bytes",
        "library_ms": fl["plain_ms"]})
    assert scatter_cuda.BYTES_PER_ROW == 100
    ring = mesh["full"][4]

    def cluster_only(r):
        # a time under the cluster ring's name only where every zone took
        # it (elsewhere the path mixes in the plane ring's launches)
        return r["ms"] if r["zones_on_cluster"] == r["zones"] else None
    line.append({
        "name": "sweep_zone_ring_cluster", "route": "cuda",
        "source": "radiativetransfer_tpu_torch/csrc/sweep_cluster.cu",
        "replaces": "radiativetransfer_tpu/parallel/sweep_rdma.py:64",
        "launches": sum(mesh["launches"].values()),
        "launches_by_path": mesh["launches"],
        "max_abs_err": mesh["max_abs_err"],
        "ms": ring["ms"],
        "plain_ms": ring["plain_ms"], "bound_ms": mesh["bound"]["bound_ms"],
        "bound_by": mesh["bound"]["bound_by"], "library_ms": None,
        "largest_zone_shape": ring["rule"],
        "f64_ms": cluster_only(mesh["full"]["f64"]),
        "p1_ms": cluster_only(mesh["full"][1]),
        "p2_ms": cluster_only(mesh["full"][2]),
        "n256_ms": cluster_only(mesh["full"]["big"]),
        "zones_on_cluster": {
            key: mesh["full"][k]["zones_on_cluster"] for key, k in (
                ("p4", 4), ("f64", "f64"), ("p1", 1), ("p2", 2),
                ("n256", "big"))}})
    line.append({
        "name": "sweep_zone_rdma", "route": "cuda",
        "source": "radiativetransfer_tpu_torch/csrc/sweep_rdma.cu",
        "replaces": "radiativetransfer_tpu/parallel/sweep_rdma.py:64",
        "launches": sum(mesh["old_launches"].values()),
        "launches_by_path": mesh["old_launches"],
        "max_abs_err": mesh["old_max_abs_err"], "ms": ring["old_ms"],
        "plain_ms": ring["plain_ms"], "bound_ms": mesh["bound"]["bound_ms"],
        "bound_by": mesh["bound"]["bound_by"], "library_ms": None,
        "f64_ms": mesh["full"]["f64"]["old_ms"],
        "p1_ms": mesh["full"][1]["old_ms"], "p2_ms": mesh["full"][2]["old_ms"],
        "n256_ms": mesh["full"]["big"]["old_ms"]})
    return line


if __name__ == "__main__":
    main()
