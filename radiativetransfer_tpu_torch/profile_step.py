"""Profile steps of the port on one CUDA device, layer by layer.

    python3 -m radiativetransfer_tpu_torch.profile_step [n] [level] [mode] \
        [ranks] [noneq] [amr] [sparse]

Mode 9 (the default) builds the synthetic galaxy of chip_smoke.py (n^3,
default 128, angular level default 3) and runs initialize_equilibrium.
Mode 8 runs bench.py's step configuration: a uniform box (nH = 2e-4,
T = 1.5e4, 2000 kpc) with 8 sources from seed 0 at maxPixelLevel 6.
ranks > 0 (mode 9 only) runs the step on a 1-D mesh of that many ranks on
the card, the sweep through the ring kernel (sweep_strategy "rdma").
noneq 1 runs the non-equilibrium step (RTModel.make_noneq_step, 1 Myr, 200
substeps, the temperature held; the tracer in its quadrature_noneq mode)
in place of the equilibrium one.
amr 1 (modes 9, 6, 8 and 1, no ranks, no noneq) runs the two-level AMR
step (core/step_amr.py::AMRModel) on the galaxy with its central half of
each axis refined (the fine level the base's copy at the start, then each
level in its own equilibrium), in modes 8 and 1 with the 8 sources of
amr_sources, times its plan setup, and reports its layers (the tracer with
its march steps, opacity on each level and the two-level sweep where the
mode sweeps, chemistry on each level, sync_restriction) with device ms,
host ms and, up to 32^3, the launches from two profiler windows; one
zone's sweep traced at full width (its launches and device-busy share);
up to 32^3 also a profiled step.
amr L >= 2 (modes 9, 6, 8 and 1, no ranks; noneq 1 in modes 9 and 8)
runs the L-level step (core/step_amr.py::MultiLevelModel, make_noneq_step
with noneq 1) with L levels on the galaxy with nested central refinement
(ml_galaxy: level l refines the central 1/2^(l+1) of each axis, the finer
levels the copies of the coarser at the start, each in its own
equilibrium), in modes 8 and 1 with the 8 sources of amr_sources, times
its plan setup and validate_coupling_depth once, and reports its layers
(the tracer with its march steps, opacity on every level and the L-level
sweep where the mode sweeps, chemistry on each level and
sync_restriction_multi, or noneq each level's evolve_noneq and
sync_noneq) with device ms, host ms and, up to 16^3, the launches from two
profiler windows; the tracer in a profiler window (its device-busy share
and events a march step); the first zone batch's sweep over its first 8
base slabs traced at full width (its launches and device-busy share); and
the peak device memory.
amr L >= 3 with sparse 1 (modes 9, 6, 8 and 1, one rank; noneq 1 in modes
9 and 8) runs the block-sparse L-level step
(core/step_amr.py::SparseMLModel, make_noneq_step with noneq 1) on
make_test_data's galaxy with its refined centre and core, written by
chip_smoke.write_cli_inputs and ingested as the CLI ingests it
(sparse_from_level_lists, blocks of 8; the CLI's storage rule printed), in
modes 8 and 1 with the galaxy's 12 sources at maxPixelLevel 6 as the CLI
prepares them (galaxy_sources): it times the ingestion, compute_window,
the plan, validate_coupling_depth and the equilibrium, prints W and the
share of base slabs that take the skip branch, runs a warm-up step and
one step layer by layer (the tracer with its march steps, opacity, the
sparse sweep's device and host ms, chemistry on each level and
sync_restriction_sparse, or noneq each level's evolve_noneq and
sync_noneq), the peak device memory and memory_bytes; with sources the
tracer in a profiler window (its device-busy share, events a march step,
its peak memory) and its launches a march step at an 8^3 base from two
agreeing windows (sparse_tracer_launches); where the mode sweeps, it
times the full-plane sparse sweep from the same state (the window's
speed-up), traces the first zone batch's first 8 covered base slabs at
full width (its device-busy share), counts the launches per covered and
per skipped base slab from two agreeing windows each (4 and 8 slabs; up
to 64^3); and it times write_snapshot_sparse (s and MB; with noneq each
level's species in it).  sparse 2 (mode 9) holds one
block-sparse step to one dense L-level step from the same ingested galaxy
(main_sparse_vs_dense).
Otherwise it runs one warm-up step, times each layer of a step with CUDA
events (the tracer in mode 8, opacity, sweep, chemistry; the tracer also
per march step; noneq: tracer, opacity, sweep, _assemble_photo_rates and
evolve_noneq, each also with its host milliseconds to enqueue and its
kernel launches), and traces two steps with torch.profiler: the device
kernels by total time, the device-busy share of the traced wall time, the
kernel launches per step and the peak device memory.  Needs a CUDA
device; prints the card's name and power limit.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from . import GridGeometry, RTModel, RunConfig, make_state, uniform_state
from .config import (
    MODE_BOTH_STELLAR_UVB_TRANSFER,
    MODE_NO_STARS_THIN_UVB,
    MODE_STELLAR_TRANSFER_THIN_UVB,
    MODE_UVB_TRANSFER_ONLY,
)
from .constants import KPC, MH, MYR, PSI
from .core import (
    amr,
    amr_sparse,
    chemistry,
    chemistry_noneq,
    opacity,
    rays,
    rays_multilevel,
    sweep_amr,
    sweep_multilevel,
    sweep_sparse,
)
from .core.step_amr import AMRModel, MultiLevelModel, SparseMLModel
from .geometry import octants
from .parallel.mesh import make_grid_mesh
from .roofline_sweep import nvidia_smi


def galaxy_state(n: int, box_kpc: float, device,
                 dtype: torch.dtype = torch.float32):
    """Centrally concentrated density, lognormal(0, 0.4) fluctuations from
    seed 0, T = 1e4 K, fully neutral (examples/make_test_data.py)."""
    rng = np.random.default_rng(0)
    ax = (np.arange(n) + 0.5) / n * box_kpc - box_kpc / 2
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    r = np.sqrt(x ** 2 + y ** 2 + z ** 2)
    nh = 3e-3 * (1.0 + (r / (0.15 * box_kpc)) ** 2) ** -1
    nh = nh * rng.lognormal(0.0, 0.4, nh.shape)
    nh = 10.0 ** np.log10(nh).astype(np.float32).astype(np.float64)
    return make_state(nh * MH / PSI, np.full(nh.shape, 1e4), nh,
                      dtype=dtype, device=device)


def _event_ms(fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


# the spin kernels that open and close each profiler window (_traced):
# 20 of ~1 ms each (2e6 clock cycles); 200 in the profiler's warm-up step
_MARKERS, _MARKER_CYCLES, _WARMUP_MARKERS = 20, 2_000_000, 200
# the host's idle in seconds between a window's closing markers and its
# end: at least _TAIL_S, and twice the largest clock disagreement (least
# launch-to-kernel delay) that an earlier window recorded, at most _TAIL_MAX_S
_TAIL_S, _TAIL_MAX_S = 0.25, 2.0
# one row per profiler window of _traced: (seconds since this module was
# imported, opening and closing markers recorded, the least and the
# largest delay in us from a launch on the host to its kernel's start on
# the card, kernel launches on the host, kernels recorded, the tail's
# idle s, 0 for a first take and 1 for its retake)
WINDOWS: list[tuple] = []
_T_IMPORT = time.perf_counter()


def _trace_kernels(path: str) -> tuple[list[tuple[str, float, float]],
                                        tuple]:
    """(name, start us, end us) of every kernel, copy and set on the device
    in the chrome trace at `path` that a torch.profiler wrote, by start
    (prof.events() builds a Python object per event, minutes at the noneq
    step's ~1e5 launches; the trace's export takes about a second); and
    the clocks' agreement: (the least and the largest delay in us from a
    kernel launch on the host to its kernel's start on the card, matched
    by correlation id, the kernel launches on the host, the kernels)."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    events = [e for e in events if e.get("ph") == "X"]
    launches = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "aunch" in e["name"]
                and "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    lags = [float(e["ts"]) - launches[e["args"]["correlation"]]
            for e in kernels
            if e.get("args", {}).get("correlation") in launches]
    clocks = (min(lags, default=float("nan")),
              max(lags, default=float("nan")), len(launches), len(kernels))
    return sorted(((e["name"], float(e["ts"]), float(e["ts"] + e["dur"]))
                   for e in events if e.get("cat") in
                   ("kernel", "gpu_memcpy", "gpu_memset")),
                  key=lambda x: x[1]), clocks


def _markers(count: int = _MARKERS) -> None:
    for _ in range(count):
        torch.cuda._sleep(_MARKER_CYCLES)
    torch.cuda.synchronize()


def _traced(fn):
    """(fn(), its device events), fn traced by a torch.profiler of its
    own.  A profiler records no kernel for a while after it starts
    recording: up to a dozen kernels of a layer, thousands in the second
    window of one profiler, and once a process has run for minutes
    (phases 1-17 of chip_smoke.py) the first ~20-40 ms of the card's
    work, all 20 ~1 ms spin kernels opening 12-15 windows a run, whether
    the window opened on an idle card or idled 0.2 s on the host first.
    A warm-up step of ~200 ms of spin kernels ahead of the recorded step
    (schedule warmup=1: recording on, its events dropped) kept every
    kernel.  Later in such a process the card's clock can also read
    tens of ms late against the host's, and a window then drops its last
    kernels, which seem to end after it closed; so the host idles
    (_tail_s) between the closing markers and the window's end (ROADMAP,
    faults found in the port).  In the recorded step fn runs between
    _MARKERS spin kernels of ~1 ms each on either side, and its events
    are those between the markers.  A window that lost the markers of
    one side is taken once more with twice the warm-up and a tail of at
    least 1 s and three times its largest delay; raises if that one
    loses them too.  Every window's markers and clocks go into
    WINDOWS."""
    for retake in (0, 1):
        tail = (max(1.0, 3.0 * tail, 3e-6 * np.nan_to_num(clocks[1]))
                if retake else _tail_s())
        out, events, clocks = _trace_once(fn, tail, 1 + retake)
        inner = [i for i, e in enumerate(events)
                 if "spin_kernel" not in e[0]]
        first = inner[0] if inner else len(events)
        last = len(events) - 1 - inner[-1] if inner else 0
        WINDOWS.append((time.perf_counter() - _T_IMPORT, first, last,
                        *clocks, tail, retake))
        if (inner and first > 0 and last > 0
                and inner[-1] - inner[0] + 1 == len(inner)):
            return out, events[inner[0]:inner[-1] + 1]
    raise RuntimeError(
        f"a profiler window, taken twice, recorded {first} of its "
        f"{_MARKERS} opening markers and {last} of its {_MARKERS} closing "
        f"ones around {len(inner)} device events; launch-to-kernel delays "
        f"{clocks[0]:.1f} to {clocks[1]:.1f} us, {clocks[2]} launches, "
        f"{clocks[3]} kernels, the tail's idle {tail:.3f} s")


def _tail_s() -> float:
    """The host's idle in s at the end of the next window: _TAIL_S, or
    twice the largest |least launch-to-kernel delay| of the windows so
    far, up to _TAIL_MAX_S."""
    lags = [abs(w[3]) for w in WINDOWS if w[3] == w[3]]
    return min(_TAIL_MAX_S, max(_TAIL_S, 2e-6 * max(lags, default=0.0)))


def _trace_once(fn, tail: float, warmups: int):
    """(fn(), the device events, the clocks) of one window (_traced):
    `warmups` x _WARMUP_MARKERS spin kernels in the warm-up step, then
    _MARKERS, fn, _MARKERS and `tail` s of host idle in the recorded
    one."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(
                         path)) as prof:
            _markers(warmups * _WARMUP_MARKERS)
            prof.step()
            _markers()
            out = fn()
            torch.cuda.synchronize()
            _markers()
            time.sleep(tail)
            prof.step()
        events, clocks = _trace_kernels(path)
    return out, events, clocks


def _layer(fn):
    """(fn(), device ms between CUDA events around it, host ms to enqueue
    it, kernel launches): fn runs three times, the last two each traced
    by a profiler of its own (_traced) to count the kernels it launches
    (copies and sets apart).  Raises unless both traces count the same
    kernels, and more than 0."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    counts = [sum(1 for name, _, _ in events
                  if not name.startswith(("Memcpy", "Memset")))
              for _, events in (_traced(fn), _traced(fn))]
    if counts[0] != counts[1] or counts[0] == 0:
        raise RuntimeError(f"two traces of one layer count {counts} kernels")
    return out, start.elapsed_time(end), host_ms, counts[0]


def _timed(fn):
    """(fn(), device ms between CUDA events around it, host ms to enqueue
    it, None): _layer without the profiler windows, for calls whose
    launches are too many to trace."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return out, start.elapsed_time(end), host_ms, None


def _layer_rows(count):
    """(rows, layer): layer(name, fn) runs fn as _layer (the names in
    `count`) or _timed and puts its (device ms, host ms, launches) into
    rows[name]."""
    rows = {}

    def layer(name, fn):
        out, *rows[name] = (_layer if name in count else _timed)(fn)
        return out
    return rows, layer


AMR_LAYERS = ("tracer", "opacity_base", "opacity_fine", "sweep",
              "chemistry_base", "chemistry_fine", "sync_restriction")


def amr_layers(amodel, state, count=AMR_LAYERS, stellar=None):
    """One two-level step from `state`, layer by layer, as AMRModel's step
    runs it: (the state after the step, {layer: (device ms, host ms,
    launches)}, the tracer's march steps) for the tracer (AMRModel.trace,
    with a StellarContext), opacity on each level and the two-level sweep
    (where the mode sweeps), chemistry on each level and
    sync_restriction.  The layers named in `count` run three times and
    count their launches (_layer); the others run once, launches None (a
    32^3 sweep's 3.6e5 launches take minutes to trace twice, a 128^3
    one's 1.4e6 longer).  March steps: those of one trace, 0 without
    one."""
    rt = amodel.rt
    rows, layer = _layer_rows(count)
    s0 = dataclasses.replace(state, base=state.base.zero_rates(),
                             fine=state.fine.zero_rates())
    march = 0
    if stellar is not None:
        steps0 = rays_multilevel.MARCH_STEPS
        s0, _ = layer("tracer", lambda s=s0: amodel.trace(s, stellar))
        march = ((rays_multilevel.MARCH_STEPS - steps0)
                 // (3 if "tracer" in count else 1))
    base, fine = s0.base, s0.fine
    if amodel.plan is not None:
        kc = layer("opacity_base", lambda: opacity.compute_opacities(
            s0.base.HI, s0.base.HeI, s0.base.HeII, rt.opacity_coef))
        kf = layer("opacity_fine", lambda: opacity.compute_opacities(
            s0.fine.HI, s0.fine.HeI, s0.fine.HeII, rt.opacity_coef))
        jc, jf = layer("sweep", lambda: sweep_amr.diffuse_sweep_amr(
            kc, kf, s0.refined, amodel.plan, rt.uvb, rt.geom.cell_size))
        base = dataclasses.replace(base, Jmean=jc)
        fine = dataclasses.replace(fine, Jmean=jf)
    base = layer("chemistry_base", lambda: amodel.chemistry(base, rt.geom))
    fine = layer("chemistry_fine",
                 lambda: amodel.chemistry(fine, amodel.fine_geom))
    s1 = dataclasses.replace(s0, base=base, fine=fine)
    s2 = layer("sync_restriction", lambda: amr.sync_restriction(s1))
    return s2, {k: tuple(v) for k, v in rows.items()}, march


def amr_zone_window(amodel, state, slabs: int | None = None):
    """The two-level sweep of plan zone 0 (sweep_zone_amr) on the state's
    opacities, over its first `slabs` base slabs (all when None) at the
    grid's full plane width, in a profiler window of its own: (host wall
    s, device-busy s, kernel launches)."""
    rt = amodel.rt
    zone = amodel.plan.zones[0]
    n = slabs or state.n
    kc, kf = (torch.movedim(octants.rotate_to_sweep(torch.movedim(
        opacity.compute_opacities(s.HI, s.HeI, s.HeII, rt.opacity_coef),
        0, -1), zone.izone), -1, 1) for s in (state.base, state.fine))
    r_rot = octants.rotate_to_sweep(state.refined, zone.izone)[:n]
    params = ({k: v[:, :n] for k, v in zone.coarse.items()},
              {k: v[:, :2 * n] for k, v in zone.fine.items()})

    def body():
        t0 = time.perf_counter()
        sweep_amr.sweep_zone_amr(kc[:n], kf[:2 * n], r_rot, params, rt.uvb,
                                 rt.geom.cell_size, amodel.plan.weight)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    wall, events = _traced(body)
    launches = sum(1 for name, _, _ in events
                   if not name.startswith(("Memcpy", "Memset")))
    return wall, _busy_us(events) / 1e6, launches


def amr_zone_launches(amodel, state, slabs: int | None = None) -> int:
    """Plan zone 0's two-level sweep launches from two profiler windows
    (amr_zone_window); raises unless they agree and are above 0."""
    counts = [amr_zone_window(amodel, state, slabs)[2]
              for _ in range(2)]
    if counts[0] != counts[1] or counts[0] == 0:
        raise RuntimeError(f"two traces of one zone count {counts} kernels")
    return counts[0]


def ml_layer_names(n_levels: int, noneq: bool = False) -> tuple:
    """The layers of ml_layers (noneq False) or ml_noneq_layers, but the
    tracer."""
    if noneq:
        return ("opacity", "sweep", *(f"evolve_noneq_{ell}"
                                      for ell in range(n_levels)),
                "sync_noneq")
    return ("opacity", "sweep", *(f"chemistry_{ell}"
                                  for ell in range(n_levels)),
            "sync_restriction_multi")


def _ml_traced_and_swept(amodel, state, layer, stellar, rates_mode):
    """The layers that an L-level step runs before its chemistry, from
    `state`'s zero rates: the tracer (with a StellarContext), opacity on
    every level and the sweep (where the mode sweeps).  Returns (the state
    with the deposits and Jmean, the tracer's per-level rate fields or
    None, its march steps)."""
    rt = amodel.rt
    s0 = amodel._zero_rates(state)
    rfs, march = None, 0
    if stellar is not None:
        steps0 = rays_multilevel.MARCH_STEPS
        s0, rfs, _ = layer("tracer", lambda s=s0: amodel.trace(s, stellar,
                                                               rates_mode))
        march = rays_multilevel.MARCH_STEPS - steps0
    if amodel.plan is not None:
        kappas = layer("opacity", lambda: amodel._kappas(s0))
        js = layer("sweep", lambda: sweep_multilevel.diffuse_sweep_multilevel(
            kappas, list(s0.refined), amodel.plan, rt.uvb, rt.geom.cell_size,
            amodel.n_coupling_iters))
        s0 = amr.MultiLevelState(
            levels=tuple(dataclasses.replace(lv, Jmean=j)
                         for lv, j in zip(s0.levels, js)),
            refined=s0.refined)
    return s0, rfs, march


def ml_layers(amodel, state, count=(), stellar=None):
    """One L-level step from `state`, layer by layer, as MultiLevelModel's
    step runs it: (the state after the step, {layer: (device ms, host ms,
    launches)}, the tracer's march steps) for the tracer (with a
    StellarContext), opacity on every level and the L-level sweep (where
    the mode sweeps), chemistry on each level (chemistry_0, chemistry_1,
    ...) and sync_restriction_multi.  The layers named in `count` run
    three times and count their launches (_layer); the others run once,
    launches None.  March steps: those of one trace, 0 without one."""
    rows, layer = _layer_rows(count)
    s0, _, march = _ml_traced_and_swept(amodel, state, layer, stellar,
                                        "auto")
    levels = [layer(f"chemistry_{ell}", lambda lv=lv, ell=ell:
                    amodel.chemistry(lv, amodel.level_geom(ell)))
              for ell, lv in enumerate(s0.levels)]
    s2 = layer("sync_restriction_multi", lambda: amr.sync_restriction_multi(
        amr.MultiLevelState(levels=tuple(levels), refined=s0.refined)))
    if "tracer" in count:
        march //= 3
    return s2, {k: tuple(v) for k, v in rows.items()}, march


def ml_noneq_layers(amodel, state, species, count=(), stellar=None,
                    dt: float = MYR, n_substeps: int = 200):
    """One L-level non-equilibrium step (temperature held) from `state`
    and `species`, layer by layer, as MultiLevelModel.make_noneq_step runs
    it: (the state and species after the step, {layer: (device ms, host
    ms, launches)}, the tracer's march steps) for the tracer (with a
    StellarContext built noneq=True, in its quadrature_noneq mode),
    opacity and the sweep (where the mode sweeps), each level's photo
    rates and evolve_noneq (evolve_noneq_0, ...) and sync_noneq; `count`
    as ml_layers takes it."""
    rows, layer = _layer_rows(count)
    s0, rfs, march = _ml_traced_and_swept(amodel, state, layer, stellar,
                                          "quadrature_noneq")
    tables = amodel.noneq_tables()
    levels, new_species = zip(*(
        layer(f"evolve_noneq_{ell}", lambda lv=lv, spc=spc, ell=ell:
              amodel.evolve_level(ell, lv, spc, rfs, dt, tables,
                                  n_substeps))
        for ell, (lv, spc) in enumerate(zip(s0.levels, species))))
    s2, sp2 = layer("sync_noneq", lambda: amodel.sync_noneq(
        amr.MultiLevelState(levels=levels, refined=s0.refined), new_species))
    if "tracer" in count:
        march //= 3
    return s2, sp2, {k: tuple(v) for k, v in rows.items()}, march


def ml_batch_window(amodel, state, slabs: int):
    """The L-level sweep of the plan's first zone batch
    (sweep_multilevel.zone_batches: its first direction-count group, as
    many zones as diffuse_sweep_multilevel batches) over its first `slabs`
    base slabs at the grid's full plane width, in a profiler window of its
    own: (host wall s, device-busy s, kernel launches, zones in the
    batch)."""
    rt = amodel.rt
    plan = amodel.plan
    kappas = amodel._kappas(state)
    dtype, device = kappas[0].dtype, kappas[0].device
    shape0 = tuple(kappas[0].shape[1:])
    zones = next(sweep_multilevel.zone_batches(plan, shape0, dtype, device))
    refined = list(state.refined)
    k_rots, cov_rots, ref_rots, tables = sweep_multilevel.batch_inputs(
        zones, [torch.movedim(k, 0, -1) for k in kappas],
        amr.cover_masks(refined, shape0, device), refined,
        rt.geom.cell_size)

    def cut(xs):
        return [None if x is None else x.narrow(1, 0, slabs * 2 ** ell)
                for ell, x in enumerate(xs)]
    k_rots, cov_rots, ref_rots = (cut(x) for x in (k_rots, cov_rots,
                                                  ref_rots))
    tables = [{k: (tuple(t[:slabs * 2 ** ell] for t in v)
                   if isinstance(v, tuple) else v[:slabs * 2 ** ell])
               for k, v in t_l.items()}
              for ell, t_l in enumerate(tables)]

    def body():
        t0 = time.perf_counter()
        sweep_multilevel.sweep_zones_ml(k_rots, cov_rots, ref_rots, tables,
                                        rt.uvb, plan.weight,
                                        amodel.n_coupling_iters)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    wall, events = _traced(body)
    launches = sum(1 for name, _, _ in events
                   if not name.startswith(("Memcpy", "Memset")))
    return wall, _busy_us(events) / 1e6, launches, len(zones)


def sparse_layer_names(n_levels: int, noneq: bool = False) -> tuple:
    """The layers of sparse_layers (noneq False) or sparse_noneq_layers,
    but the tracer."""
    if noneq:
        return ("opacity", "sweep", *(f"evolve_noneq_{ell}"
                                      for ell in range(n_levels)),
                "sync_noneq")
    return ("opacity", "sweep", *(f"chemistry_{ell}"
                                  for ell in range(n_levels)),
            "sync_restriction_sparse")


def _sparse_traced_and_swept(amodel, state, layer, stellar, rates_mode):
    """The layers that a block-sparse step runs before its chemistry,
    from `state`'s zero rates: the tracer (with a StellarContext), opacity
    on every level and the sparse sweep in the model's window (where the
    mode sweeps).  Returns (the state with the deposits and Jmean, the
    tracer's per-level rate fields or None, its march steps)."""
    rt = amodel.rt
    s0 = amodel._zero_rates(state)
    rfs, march = None, 0
    if stellar is not None:
        steps0 = rays_multilevel.MARCH_STEPS
        s0, rfs, _ = layer("tracer", lambda s=s0: amodel.trace(s, stellar,
                                                               rates_mode))
        march = rays_multilevel.MARCH_STEPS - steps0
    if amodel.plan is not None:
        k0, lv_k = layer("opacity", lambda: amodel._kappas(s0))
        win = amodel._ensure_window(s0)
        j0, jbs = layer("sweep", lambda: sweep_sparse.diffuse_sweep_sparse(
            k0, lv_k, s0, amodel.plan, rt.uvb, rt.geom.cell_size,
            amodel.n_coupling_iters, window=win))
        s0 = dataclasses.replace(
            s0, base=dataclasses.replace(s0.base, Jmean=j0),
            levels=tuple(dataclasses.replace(lv, fields=dataclasses.replace(
                lv.fields, Jmean=j)) for lv, j in zip(s0.levels, jbs)))
    return s0, rfs, march


def sparse_layers(amodel, state, count=(), stellar=None):
    """One block-sparse step from `state`, layer by layer, as
    SparseMLModel's step runs it: (the state after the step, {layer:
    (device ms, host ms, launches)}, the tracer's march steps) for the
    tracer (with a StellarContext), opacity on every level and the sparse
    sweep in the model's window (where the mode sweeps), chemistry on each
    level with its padding blocks re-zeroed (chemistry_0, ...) and
    sync_restriction_sparse; `count` and the march steps as ml_layers
    takes and gives them."""
    rt = amodel.rt
    rows, layer = _layer_rows(count)
    s0, _, march = _sparse_traced_and_swept(amodel, state, layer, stellar,
                                            "auto")
    base = layer("chemistry_0", lambda: amodel.chemistry(s0.base, rt.geom))
    levels = []
    for ell, lv in enumerate(s0.levels, start=1):
        f = layer(f"chemistry_{ell}", lambda lv=lv, ell=ell:
                  amr_sparse.zero_pad_blocks(
                      amodel.chemistry(lv.fields, amodel.level_geom(ell)),
                      lv.pad_mask(rt.geom.nx * 2 ** ell)))
        levels.append(dataclasses.replace(lv, fields=f))
    s2 = layer("sync_restriction_sparse",
               lambda: amr_sparse.sync_restriction_sparse(dataclasses.replace(
                   s0, base=base, levels=tuple(levels))))
    if "tracer" in count:
        march //= 3
    return s2, {k: tuple(v) for k, v in rows.items()}, march


def sparse_noneq_layers(amodel, state, species, count=(), stellar=None,
                        dt: float = MYR, n_substeps: int = 200):
    """One block-sparse non-equilibrium step (temperature held) from
    `state` and `species`, layer by layer, as
    SparseMLModel.make_noneq_step runs it: (the state and species after
    the step, {layer: (device ms, host ms, launches)}, the tracer's march
    steps) for the tracer (with a StellarContext built noneq=True, in its
    quadrature_noneq mode), opacity and the sweep (where the mode
    sweeps), each level's photo rates and evolve_noneq with its padding
    blocks re-zeroed (evolve_noneq_0, ...) and sync_noneq; `count` as
    ml_layers takes it."""
    rows, layer = _layer_rows(count)
    s0, rfs, march = _sparse_traced_and_swept(amodel, state, layer, stellar,
                                              "quadrature_noneq")
    tables = amodel.noneq_tables()
    base, sp0 = layer("evolve_noneq_0", lambda: amodel.evolve_level(
        0, s0.base, species[0], rfs, dt, tables, n_substeps))
    levels, new_species = [], [sp0]
    for ell, (lv, spc, pad) in enumerate(zip(s0.levels, species[1:],
                                             amodel.pad_masks(s0)), start=1):
        def evolve(lv=lv, spc=spc, pad=pad, ell=ell):
            f, sp = amodel.evolve_level(ell, lv.fields, spc, rfs, dt, tables,
                                        n_substeps)
            return (amr_sparse.zero_pad_blocks(f, pad),
                    amr_sparse.zero_pad_blocks(sp, pad))
        f, spc = layer(f"evolve_noneq_{ell}", evolve)
        levels.append(dataclasses.replace(lv, fields=f))
        new_species.append(spc)
    s2, sp2 = layer("sync_noneq", lambda: amodel.sync_noneq(
        dataclasses.replace(s0, base=base, levels=tuple(levels)),
        new_species))
    if "tracer" in count:
        march //= 3
    return s2, sp2, {k: tuple(v) for k, v in rows.items()}, march


def galaxy_sources(directory: str, state, geom, noneq: bool = False,
                   max_pixel_level: int = 6, dtype=torch.float32,
                   device="cuda", first: int | None = None, levels=None):
    """The CLI's StellarContext (cli.read_stars, in `dtype`) of the galaxy
    whose inputs chip_smoke.write_cli_inputs wrote into `directory` (its
    12 sources, its first `first` kept where given), on `state` ingested
    from them -- uniform, two-level, L-level or block-sparse: its base
    level's abun2 and refined map -- at maxPixelLevel `max_pixel_level`
    (noneq: with the k27..k31 weights).  `levels`: the grid's level data
    where the caller has read them."""
    from . import cli
    from .config import load_config
    from .io import grid_io
    if levels is None:
        levels = grid_io.read_level_npz(os.path.join(directory,
                                                     "testgrid_velmet.npz"))
    if isinstance(state, amr_sparse.SparseMLState):
        abun2, refined = state.base.abun2, state.refined0
    elif isinstance(state, amr.MultiLevelState):
        abun2, refined = state.levels[0].abun2, state.refined[0]
    elif isinstance(state, amr.AMRState):
        abun2, refined = state.base.abun2, state.refined
    else:
        abun2, refined = state.abun2, None
    cfg = load_config(os.path.join(directory, "inputParameters"))
    stars = cli.read_stars(cfg, levels, abun2, refined, geom.nx)
    if first is not None:
        b = stars.batch
        stars = dataclasses.replace(
            stars, batch=rays.SourceBatch(
                position=b.position[:first], weight=b.weight[:first],
                table_idx=b.table_idx[:first]),
            n_young=int(b.weight[:first].sum()))
    return stars.context(cfg, geom, max_pixel_level=max_pixel_level,
                         noneq=noneq, dtype=dtype, device=device)


def sparse_first_batch(amodel, state):
    """(the inputs of the sparse sweep's first zone batch
    (sweep_sparse.batch_inputs) on the state's opacities in the model's
    window, its zones)."""
    rt = amodel.rt
    k0, lv_k = amodel._kappas(state)
    win = amodel._ensure_window(state)
    n = state.n
    batch = next(sweep_multilevel.zone_batches(
        amodel.plan, (n, n, n), k0.dtype, k0.device,
        sweep_sparse._sparse_zone_bytes(state, None if win is None
                                        else win[0])))
    ctx = sweep_sparse.build_ctx(k0, lv_k, state)
    return sweep_sparse.batch_inputs(batch, ctx, win, rt.geom.cell_size), \
        batch


def sparse_skip_share(amodel, state) -> float:
    """The share of base slabs that take the skip branch, over the
    sweep's zone batches."""
    n = state.n
    k0 = state.base.rho
    win = amodel._ensure_window(state)
    r0 = state.refined0.detach().cpu().numpy().astype(bool)
    skipped = total = 0
    for batch in sweep_multilevel.zone_batches(
            amodel.plan, (n, n, n), k0.dtype, k0.device,
            sweep_sparse._sparse_zone_bytes(state, None if win is None
                                            else win[0])):
        has = np.stack([sweep_sparse._has_fine(octants.rotate_to_sweep(
            r0, z.izone)) for z in batch]).any(axis=0)
        skipped += int((~has).sum())
        total += n
    return skipped / total


def sparse_slab_window(amodel, inputs, covered: bool, slabs: int):
    """The sweep of one zone batch (sparse_first_batch's inputs) over the
    first `slabs` consecutive base slabs that are covered (need the fine
    levels) or skipped, from the UVB at the first, at the grid's full
    width, in a profiler window of its own: (host wall s, device-busy s,
    kernel launches, the slabs, {kernel name: (device ms, launches)})."""
    rt = amodel.rt
    has = inputs[4]
    n = len(has)
    starts = [i for i in range(n - slabs + 1)
              if all(has[i:i + slabs] == covered)]
    if not starts:
        raise ValueError(f"no {slabs} consecutive "
                         f"{'covered' if covered else 'skipped'} slabs")
    slab_range = range(starts[0], starts[0] + slabs)

    def body():
        t0 = time.perf_counter()
        sweep_sparse.sweep_zone_sparse(*inputs, rt.uvb, amodel.plan.weight,
                                       amodel.n_coupling_iters,
                                       slabs=slab_range)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    wall, events = _traced(body)
    launches = sum(1 for name, _, _ in events
                   if not name.startswith(("Memcpy", "Memset")))
    by_name = {}
    for name, start, end in events:
        ms, k = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (end - start) / 1e3, k + 1)
    return wall, _busy_us(events) / 1e6, launches, slab_range, by_name


def sparse_slab_launches(amodel, state, covered: bool, k: int = 4) -> float:
    """Launches per covered (or skipped) base slab of the first zone
    batch's sweep: the launches of 2k and of k such slabs, each from two
    profiler windows that must agree, their difference over k."""
    inputs, _ = sparse_first_batch(amodel, state)
    counts = {}
    for m in (k, 2 * k):
        c = [sparse_slab_window(amodel, inputs, covered, m)[2]
             for _ in range(2)]
        if c[0] != c[1] or c[0] == 0:
            raise RuntimeError(f"two traces of {m} slabs count {c} kernels")
        counts[m] = c[0]
    return (counts[2 * k] - counts[k]) / k


def noneq_layers(model, state, species, ctx=None, mesh=None,
                 dt: float = MYR, n_substeps: int = 200) -> dict:
    """One non-equilibrium step, layer by layer, from `state` and
    `species` (temperature held): {layer: (device ms, host ms, launches)}
    for the tracer (with a StellarContext built noneq=True), opacity,
    sweep, _assemble_photo_rates and evolve_noneq."""
    cfg = model.config
    tables = chemistry_noneq.NoneqTablesDevice.from_tables(
        model.tables, state.HI.dtype, state.HI.device)
    s0 = state.zero_rates()
    rows, rf = {}, None
    if ctx is not None:
        (s0, rf, _), *rows["tracer"] = _layer(
            lambda: model.trace(s0, ctx, "quadrature_noneq"))
    kappa, *rows["opacity"] = _layer(lambda: opacity.compute_opacities(
        s0.HI, s0.HeI, s0.HeII, model.opacity_coef))
    jmean, *rows["sweep"] = _layer(lambda: model._run_sweep(kappa, mesh))
    s1 = dataclasses.replace(s0, Jmean=jmean)
    photo, *rows["assemble_photo_rates"] = _layer(
        lambda: model._assemble_photo_rates(s1, rf))
    _, *rows["evolve_noneq"] = _layer(lambda: chemistry_noneq.evolve_noneq(
        species, dt, tables, photo=photo, n_substeps=n_substeps,
        evolve_energy=False, tgas_fixed=s1.tgas,
        current_redshift=cfg.current_redshift))
    return {k: tuple(v) for k, v in rows.items()}


def profiled(run, box: list, steps: int = 2):
    """`steps` calls of box[0] = run(box[0]) in one window of _traced
    (the box lets each step drop its input, as a run's loop does; a
    window taken again runs `steps` more): (wall s, device-busy s: the
    union of the device events' intervals, device events per step, the 12
    kernels of most device time as (name, total ms, count))."""
    def body():
        t0 = time.perf_counter()
        for _ in range(steps):
            box[0] = run(box[0])
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    wall, spans = _traced(body)
    totals = {}
    for name, start, end in spans:
        ms, count = totals.get(name, (0.0, 0))
        totals[name] = (ms + (end - start) / 1e3, count + 1)
    top = sorted(((k, ms, c) for k, (ms, c) in totals.items()),
                 key=lambda x: -x[1])[:12]
    return wall, _busy_us(spans) / 1e6, len(spans) / steps, top


def _busy_us(spans) -> float:
    """Device-busy microseconds: the union of the (name, start, end)
    intervals, sorted by start."""
    device_us, reach = 0.0, float("-inf")
    for _, start, end in spans:
        device_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    return device_us


def _setup(n: int, level: int, mode: int, ranks: int, noneq: bool = False):
    """(model, first state, StellarContext or None) of the profiled run."""
    if mode == MODE_UVB_TRANSFER_ONLY:
        box = 300.0
        cfg = RunConfig(mode=mode, current_redshift=6.55,
                        n_angular_level=level, reionization_model=10,
                        self_shielding_threshold_kpc=0.1,
                        sweep_strategy="rdma" if ranks else "auto")
        model = RTModel.setup(cfg, GridGeometry(n, n, n, box * KPC),
                              torch.float32, "cuda")
        return (model, model.initialize_equilibrium(
            galaxy_state(n, box, "cuda")), None)
    if mode != MODE_BOTH_STELLAR_UVB_TRANSFER or ranks:
        raise SystemExit(f"profile_step profiles modes 8 and 9 (on a mesh "
                         f"9 only), not {mode} on {ranks} ranks")
    from .bench import bench_sources
    from .core.step import StellarContext
    from .tables import stellar
    cfg = RunConfig(mode=mode, current_redshift=6.55, n_angular_level=level,
                    reionization_model=10)
    geom = GridGeometry(n, n, n, 2000.0 * KPC)
    model = RTModel.setup(cfg, geom, torch.float32, "cuda")
    ctx = StellarContext.build(
        stellar.blackbody_population(q_ionizing=1.0e51),
        bench_sources(n, 8), geom, 10.0 * MYR, metal_coefs=[(0, 0.0)],
        noneq=noneq, dtype=torch.float32, device="cuda")
    state = uniform_state(n, nh=2e-4, tgas=1.5e4, dtype=torch.float32,
                          device="cuda")
    return model, state, ctx


def amr_galaxy(model, box_kpc: float = 300.0, device="cuda"):
    """The two-level galaxy of the AMR profile: galaxy_state on the base,
    the central half of each axis refined, the fine level the base's copy,
    each level in its own equilibrium."""
    n = model.geom.nx
    refined = torch.zeros((n, n, n), dtype=torch.bool, device=device)
    refined[n // 4:n - n // 4, n // 4:n - n // 4, n // 4:n - n // 4] = True
    state = amr.make_amr_state(galaxy_state(n, box_kpc, device), refined)
    return amr.sync_restriction(dataclasses.replace(
        state, base=model.initialize_equilibrium(state.base),
        fine=model.initialize_equilibrium(state.fine)))


def amr_sources(geom, device="cuda", noneq: bool = False):
    """The point sources of the nested profiles, in float32: 8 from
    bench_sources (seed 0, the central [0.3, 0.7]^3), blackbodies of
    q = 1e51 at 10 Myr, as the uniform mode-8 profile's (noneq: with the
    k27..k31 weights)."""
    from .bench import bench_sources
    from .core.step import StellarContext
    from .tables import stellar
    return StellarContext.build(
        stellar.blackbody_population(q_ionizing=1.0e51),
        bench_sources(geom.nx, 8), geom, 10.0 * MYR, metal_coefs=[(0, 0.0)],
        noneq=noneq, dtype=torch.float32, device=device)


def ml_galaxy(model, n_levels: int, box_kpc: float = 300.0,
              device="cuda"):
    """The L-level galaxy of the L-level profile: galaxy_state on the base,
    level l refining the central 1/2^(l+1) of each axis (balanced with
    amr.enforce_balance), the finer levels the copies of the coarser,
    each level in its own equilibrium."""
    n = model.geom.nx
    refined = []
    for ell in range(n_levels - 1):
        m = n * 2 ** ell
        lo, hi = m // 2 - m // 2 ** (ell + 2), m // 2 + m // 2 ** (ell + 2)
        r = np.zeros((m, m, m), bool)
        r[lo:hi, lo:hi, lo:hi] = True
        refined.append(r)
    state = amr.make_multilevel_state(galaxy_state(n, box_kpc, device),
                                      amr.enforce_balance(refined))
    return amr.sync_restriction_multi(amr.MultiLevelState(
        levels=tuple(model.initialize_equilibrium(lv)
                     for lv in state.levels),
        refined=state.refined))


def main_ml(n: int, level: int, mode: int, n_levels: int, noneq: bool,
            smi: str) -> None:
    cfg = RunConfig(mode=mode, current_redshift=6.55, n_angular_level=level,
                    reionization_model=10, self_shielding_threshold_kpc=0.1)
    model = RTModel.setup(cfg, GridGeometry(n, n, n, 300.0 * KPC),
                          torch.float32, "cuda")
    t0 = time.perf_counter()
    amodel = MultiLevelModel.setup(model, n_levels)
    plan_s = time.perf_counter() - t0
    state = ml_galaxy(model, n_levels)
    parents = [int(r.sum()) for r in state.refined]
    ctx = (amr_sources(model.geom, noneq=noneq)
           if cfg.run_stellar_transfer else None)
    if amodel.plan is not None:
        (depth, val_ms, val_host, _) = _timed(
            lambda: amodel.validate_coupling_depth(state))
        print(f"validate_coupling_depth: depth {depth}, {val_ms:.3f} ms "
              f"(host {val_host:.3f} ms); card {smi}")
    nf0 = amodel.neutral_fraction(state)
    names = ml_layer_names(n_levels, noneq)
    if ctx is not None:
        names = ("tracer", *names)
    count = names if n <= 16 else ()
    if noneq:
        species = tuple(chemistry_noneq.species_from_field_state(lv)
                        for lv in state.levels)
        state, species = amodel.make_noneq_step(MYR, ctx)(state,
                                                          species)[:2]
    elif ctx is not None:
        state = amodel.make_step(ctx)(state)[0]
    else:
        state = amodel.make_step()(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if noneq:
        state, species, rows, march = ml_noneq_layers(
            amodel, state, species, count=count, stellar=ctx)
    else:
        state, rows, march = ml_layers(amodel, state, count=count,
                                       stellar=ctx)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    print(f"{n_levels}-level mode {mode}{' noneq' if noneq else ''} at "
          f"{n}^3 (refined parents per level {parents}) x "
          f"{cfg.n_directions} dirs f32, coupling depth "
          f"{amodel.n_coupling_iters}"
          + (f", {ctx.sources.n_sources} sources (the tracer {march} march "
             f"steps)" if ctx is not None else "")
          + f": plan setup {plan_s:.3f} s (host); one step {step_s:.3f} s, "
          "layers (device ms / host ms / launches): " + ", ".join(
              f"{k} {ms:.3f} / {host:.3f} / {k_n}"
              for k, (ms, host, k_n) in rows.items())
          + f"; neutral fraction {nf0:.7f} -> "
          f"{amodel.neutral_fraction(state):.7f}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB; card {smi}")
    if ctx is not None and count:
        print(f"the tracer's launches a march step (two agreeing windows): "
              f"{rows['tracer'][2] / march:.1f}; card {smi}")
    if ctx is not None:
        wall, busy, events, _ = profiled(
            lambda s: amodel.trace(amodel._zero_rates(s), ctx)[0], [state],
            steps=1)
        print(f"the tracer in a profiler window: wall {wall * 1e3:.3f} ms, "
              f"device busy {busy * 1e3:.3f} ms ({100 * busy / wall:.1f}%), "
              f"{events:.0f} device events ({events / max(march, 1):.1f} a "
              f"march step); card {smi}")
    if amodel.plan is not None:
        slabs = min(8, n)
        wall, busy, launches, zones = ml_batch_window(amodel, state, slabs)
        print(f"the first zone batch's sweep ({zones} zones of "
              f"{amodel.plan.zones[0].ndir} directions), its first {slabs} "
              f"base slabs: wall {wall * 1e3:.3f} ms, device busy "
              f"{busy * 1e3:.3f} ms ({100 * busy / wall:.1f}%), {launches} "
              f"launches; card {smi}")


def main_amr(n: int, level: int, mode: int, smi: str) -> None:
    cfg = RunConfig(mode=mode, current_redshift=6.55, n_angular_level=level,
                    reionization_model=10, self_shielding_threshold_kpc=0.1)
    model = RTModel.setup(cfg, GridGeometry(n, n, n, 300.0 * KPC),
                          torch.float32, "cuda")
    t0 = time.perf_counter()
    amodel = AMRModel.setup(model)
    plan_s = time.perf_counter() - t0
    state = amr_galaxy(model)
    ctx = amr_sources(model.geom) if cfg.run_stellar_transfer else None
    step = amodel.make_step(ctx)

    def run(s):
        return step(s)[0] if ctx is not None else step(s)

    nf0 = amodel.neutral_fraction(state)
    state = run(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, rows, march = amr_layers(amodel, state,
                                    count=AMR_LAYERS if n <= 32 else (),
                                    stellar=ctx)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    print(f"two-level mode {mode} at {n}^3 (+ {int(state.refined.sum())} "
          f"refined parents) x {cfg.n_directions} dirs f32"
          + (f", {ctx.sources.n_sources} sources (the tracer {march} march "
             f"steps)" if ctx is not None else "")
          + f": plan setup {plan_s:.3f} s (host); one step {step_s:.3f} s, "
          "layers (device ms / host ms / launches): " + ", ".join(
              f"{k} {ms:.3f} / {host:.3f} / {k_n}"
              for k, (ms, host, k_n) in rows.items())
          + f"; neutral fraction {nf0:.7f} -> "
          f"{amodel.neutral_fraction(state):.7f}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB; card {smi}")
    if amodel.plan is not None:
        wall, busy, launches = amr_zone_window(amodel, state)
        print(f"one zone's sweep ({amodel.plan.zones[0].ndir} directions, "
              f"{n} base slabs): wall {wall * 1e3:.3f} ms, device busy "
              f"{busy * 1e3:.3f} ms ({100 * busy / wall:.1f}%), {launches} "
              f"launches; card {smi}")
    if n <= 32:
        wall, busy, kernels, _ = profiled(run, [state], steps=1)
        print(f"one profiled two-level step: wall {wall * 1e3:.3f} ms, "
              f"device busy {busy * 1e3:.3f} ms ({100 * busy / wall:.1f}%), "
              f"{kernels:.0f} device events; card {smi}")


def sparse_galaxy(n: int, directory: str, be: int = 8,
                  device="cuda"):
    """((make_test_data's galaxy at n^3 with its refined centre and core,
    as chip_smoke.write_cli_inputs writes it, ingested block-sparse as the
    CLI ingests it: f32, blocks of `be`), the CLI's storage under its
    default --amr-storage auto, ingestion seconds)."""
    import chip_smoke

    from . import cli
    from .io import grid_io
    if not os.path.exists(os.path.join(directory, "inputParameters")):
        chip_smoke.write_cli_inputs(directory, n, refine_center=True,
                                    refine_core=True)
    levels = grid_io.read_level_npz(os.path.join(directory,
                                                 "testgrid_velmet.npz"))
    storage = cli._nesting(levels, cli._parser().parse_args(["cfg"]))
    t0 = time.perf_counter()
    state, _ = amr_sparse.sparse_from_level_lists(levels, True, be=be,
                                                  device=device)
    torch.cuda.synchronize()
    return state, storage, time.perf_counter() - t0


def sparse_tracer_launches(n: int = 8, noneq: bool = False,
                           device="cuda") -> tuple[int, int]:
    """The block-sparse tracer at a small base: make_test_data's galaxy at
    n^3 with its refined centre and core (sparse_galaxy) in its
    equilibrium, its 12 sources at maxPixelLevel 6 (galaxy_sources):
    (the kernels one trace launches, from two agreeing profiler windows
    (_layer), the march steps of one trace)."""
    cfg = RunConfig(mode=MODE_STELLAR_TRANSFER_THIN_UVB,
                    current_redshift=6.55, n_angular_level=1,
                    reionization_model=10, self_shielding_threshold_kpc=0.1)
    model = RTModel.setup(cfg, GridGeometry(n, n, n, 300.0 * KPC),
                          torch.float32, device)
    with tempfile.TemporaryDirectory() as tmp:
        state, _, _ = sparse_galaxy(n, tmp, device=device)
        amodel = SparseMLModel.setup(model, state.n_levels)
        state = amodel._zero_rates(amodel.initialize_equilibrium(state))
        ctx = galaxy_sources(tmp, state, model.geom, noneq, device=device)
    steps0 = rays_multilevel.MARCH_STEPS
    _, _, _, launches = _layer(lambda: amodel.trace(
        state, ctx, "quadrature_noneq" if noneq else "auto"))
    return launches, (rays_multilevel.MARCH_STEPS - steps0) // 3


def main_sparse(n: int, level: int, mode: int, noneq: bool,
                smi: str) -> None:
    from .io import snapshot
    cfg = RunConfig(mode=mode, current_redshift=6.55, n_angular_level=level,
                    reionization_model=10, self_shielding_threshold_kpc=0.1)
    model = RTModel.setup(cfg, GridGeometry(n, n, n, 300.0 * KPC),
                          torch.float32, "cuda")
    with tempfile.TemporaryDirectory() as tmp:
        state, storage, ingest_s = sparse_galaxy(n, tmp)
        L = state.n_levels
        t0 = time.perf_counter()
        amodel = SparseMLModel.setup(model, L)
        plan_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        win = amodel._ensure_window(state)
        window_s = time.perf_counter() - t0
        ctx = (galaxy_sources(tmp, state, model.geom, noneq)
               if cfg.run_stellar_transfer else None)
        print(f"block-sparse {n}^3 + {L - 1} levels (the CLI's storage "
              f"under --amr-storage auto: {storage}): {state.n_leaves()} "
              f"leaves, blocks {[lv.n_blocks for lv in state.levels]} of "
              f"{state.be}^3, memory_bytes {state.memory_bytes() / 1e9:.3f} "
              f"GB; ingestion {ingest_s:.3f} s, compute_window "
              f"{window_s:.3f} s (W {None if win is None else win[0]}), "
              f"plan setup {plan_s:.3f} s"
              + (f"; {ctx.sources.n_sources} sources at maxPixelLevel "
                 f"{ctx.max_pixel_level}" if ctx is not None else "")
              + f"; card {smi}")
        if amodel.plan is not None:
            (depth, val_ms, val_host, _) = _timed(
                lambda: amodel.validate_coupling_depth(state))
            print(f"validate_coupling_depth: depth {depth}, {val_ms:.3f} ms "
                  f"(host {val_host:.3f} ms); skip share "
                  f"{sparse_skip_share(amodel, state):.4f}; card {smi}")
        t0 = time.perf_counter()
        state = amodel.initialize_equilibrium(state)
        torch.cuda.synchronize()
        eq_s = time.perf_counter() - t0
        nf0 = amodel.neutral_fraction(state)
        species = None
        if noneq:
            species = amodel.initial_species(state)
            state, species = amodel.make_noneq_step(MYR, ctx)(
                state, species)[:2]
        elif ctx is not None:
            state = amodel.make_step(ctx)(state)[0]
        else:
            state = amodel.make_step()(state)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if noneq:
            state, species, rows, march = sparse_noneq_layers(
                amodel, state, species, stellar=ctx)
        else:
            state, rows, march = sparse_layers(amodel, state, stellar=ctx)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        print(f"block-sparse mode {mode}{' noneq' if noneq else ''} at "
              f"{n}^3 x {cfg.n_directions} dirs f32, coupling depth "
              f"{amodel.n_coupling_iters}"
              + (f", the tracer {march} march steps" if ctx is not None
                 else "")
              + f": equilibrium {eq_s:.3f} s; one step {step_s:.3f} s, "
              f"layers (device ms / host ms): " + ", ".join(
                  f"{k} {ms:.3f} / {host:.3f}"
                  for k, (ms, host, _) in rows.items())
              + f"; neutral fraction {nf0:.7f} -> "
              f"{amodel.neutral_fraction(state):.7f}; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB; card "
              f"{smi}")
        if ctx is not None:
            rates = "quadrature_noneq" if noneq else "auto"
            torch.cuda.reset_peak_memory_stats()
            wall, busy, events, _ = profiled(
                lambda s: amodel.trace(amodel._zero_rates(s), ctx,
                                       rates)[0], [state], steps=1)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            print(f"the tracer in a profiler window: wall "
                  f"{wall * 1e3:.3f} ms, device busy {busy * 1e3:.3f} ms "
                  f"({100 * busy / wall:.1f}%), {events:.0f} device events "
                  f"({events / max(march, 1):.1f} a march step), peak "
                  f"device memory {peak:.3f} GiB; card {smi}")
            launches, march8 = sparse_tracer_launches(8, noneq)
            print(f"the tracer's launches a march step at an 8^3 base "
                  f"(two agreeing windows): {launches} in {march8} march "
                  f"steps, {launches / march8:.1f}; card {smi}")
        if amodel.plan is not None:
            k0, lv_k = amodel._kappas(state)
            _, full_ms, full_host, _ = _timed(
                lambda: sweep_sparse.diffuse_sweep_sparse(
                    k0, lv_k, state, amodel.plan, model.uvb,
                    model.geom.cell_size, amodel.n_coupling_iters,
                    window=None))
            del k0, lv_k
            print(f"the full-plane sparse sweep (--sweep-window off): "
                  f"{full_ms:.3f} ms (host {full_host:.3f} ms), the "
                  f"window's speed-up {full_ms / rows['sweep'][0]:.2f}x; "
                  f"card {smi}")
            inputs, batch = sparse_first_batch(amodel, state)
            wall, busy, launches, slabs, by_name = sparse_slab_window(
                amodel, inputs, True, 8)
            print(f"the first zone batch's sweep ({len(batch)} zones of "
                  f"{batch[0].ndir} directions), covered base slabs "
                  f"{slabs.start}-{slabs.stop - 1}: wall {wall * 1e3:.3f} "
                  f"ms, device busy {busy * 1e3:.3f} ms "
                  f"({100 * busy / wall:.1f}%), {launches} launches; card "
                  f"{smi}")
            for name, (ms, k) in sorted(by_name.items(),
                                        key=lambda x: -x[1][0])[:10]:
                print(f"  {ms:10.3f} ms {k:7d}x  {name[:100]}")
            del inputs
            if n <= 64:
                per = [sparse_slab_launches(amodel, state, c)
                       for c in (True, False)]
                print(f"launches a base slab (4 and 8 slabs, two agreeing "
                      f"windows each): covered {per[0]:.1f}, skipped "
                      f"{per[1]:.1f}; card {smi}")
        path = os.path.join(tmp, "cellArray0001.npz")
        extra = None
        if species is not None:
            extra = {}
            for ell, spc in enumerate(species):
                extra.update(snapshot.species_extra(spc,
                                                    prefix=f"species{ell}"))
        t0 = time.perf_counter()
        snapshot.write_snapshot_sparse(path, state, 1,
                                       model.geom.physical_box_size,
                                       extra=extra)
        print(f"write_snapshot_sparse: {time.perf_counter() - t0:.3f} s "
              f"(host; {os.path.getsize(path) / 1e6:.1f} MB compressed, "
              f"{state.n_leaves()} leaves)")


def main_sparse_vs_dense(n: int, level: int, smi: str) -> None:
    """The galaxy of sparse_galaxy ingested twice, block-sparse and dense
    (amr.multilevel_from_levels), each level in its own equilibrium, one
    mode-9 step of SparseMLModel and one of MultiLevelModel at the depth
    validated on the sparse state: their seconds and peaks, and the
    largest difference of the species and Jmean over each level's peak on
    the cells that exist at that level."""
    from .io import grid_io
    cfg = RunConfig(mode=MODE_UVB_TRANSFER_ONLY, current_redshift=6.55,
                    n_angular_level=level, reionization_model=10,
                    self_shielding_threshold_kpc=0.1)
    model = RTModel.setup(cfg, GridGeometry(n, n, n, 300.0 * KPC),
                          torch.float32, "cuda")
    names = ("HI", "HeI", "HeII", "Jmean")
    with tempfile.TemporaryDirectory() as tmp:
        sp, storage, ingest_s = sparse_galaxy(n, tmp)
        levels = grid_io.read_level_npz(os.path.join(tmp,
                                                     "testgrid_velmet.npz"))
    sm = SparseMLModel.setup(model, sp.n_levels)
    depth = sm.validate_coupling_depth(sp)
    sp = sm.initialize_equilibrium(sp)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sp1 = sm.make_step()(sp)
    torch.cuda.synchronize()
    sparse_s = time.perf_counter() - t0
    sparse_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del sp
    t0 = time.perf_counter()
    dense, _ = amr.multilevel_from_levels(levels, True, torch.float32,
                                          device="cuda")
    dense = amr.sync_restriction_multi(amr.MultiLevelState(
        levels=tuple(model.initialize_equilibrium(lv)
                     for lv in dense.levels), refined=dense.refined))
    torch.cuda.synchronize()
    dense_ingest_s = time.perf_counter() - t0
    ml = MultiLevelModel.setup(model, dense.n_levels)
    ml.n_coupling_iters = depth
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dense = ml.make_step()(dense)
    torch.cuda.synchronize()
    dense_s = time.perf_counter() - t0
    dense_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    worst = 0.0
    for ell, fd in enumerate(dense.levels):
        fs = sp1.base if ell == 0 else sp1.levels[ell - 1].fields
        for k in names:
            a, b = getattr(fs, k), getattr(fd, k)
            if ell:
                lv = sp1.levels[ell - 1]
                b = amr_sparse.blockify_like(lv, b)
                a, b = a[..., lv.cover], b[..., lv.cover]
            worst = max(worst, float((a - b).abs().max() / b.abs().max()))
    print(f"{n}^3 + {dense.n_levels - 1} levels x {cfg.n_directions} dirs "
          f"f32 mode 9 at depth {depth} (validated on the block-sparse "
          f"state; the CLI's storage under --amr-storage auto: {storage}): "
          f"block-sparse step {sparse_s:.3f} s, peak {sparse_peak:.3f} GiB "
          f"(ingestion {ingest_s:.3f} s); dense L-level step {dense_s:.3f} "
          f"s, peak {dense_peak:.3f} GiB (ingestion and equilibrium "
          f"{dense_ingest_s:.3f} s); species and Jmean max diff on the "
          f"cells of each level {worst:.3e} of each level's peak; card "
          f"{smi}")


def main(n: int = 128, level: int = 3, mode: int = 9, ranks: int = 0,
         noneq: int = 0, nested: int = 0, sparse: int = 0) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")
    smi = nvidia_smi()
    if sparse:
        if nested < 3 or ranks or mode not in (
                MODE_UVB_TRANSFER_ONLY, MODE_NO_STARS_THIN_UVB,
                MODE_BOTH_STELLAR_UVB_TRANSFER,
                MODE_STELLAR_TRANSFER_THIN_UVB) or (noneq and mode not in (
                    MODE_UVB_TRANSFER_ONLY, MODE_BOTH_STELLAR_UVB_TRANSFER)) \
                or (sparse == 2 and (noneq or mode != MODE_UVB_TRANSFER_ONLY)):
            raise SystemExit("the block-sparse profile runs modes 9, 6, 8 "
                             "and 1 on one rank, the noneq chemistry in "
                             "modes 9 and 8, the galaxy's 3 levels (amr 3); "
                             "sparse 2 mode 9 with equilibrium chemistry")
        if sparse == 2:
            main_sparse_vs_dense(n, level, smi)
        else:
            main_sparse(n, level, mode, bool(noneq), smi)
        return
    if nested >= 2:
        if ranks or mode not in (
                MODE_UVB_TRANSFER_ONLY, MODE_NO_STARS_THIN_UVB,
                MODE_BOTH_STELLAR_UVB_TRANSFER,
                MODE_STELLAR_TRANSFER_THIN_UVB) or (noneq and mode not in (
                    MODE_UVB_TRANSFER_ONLY, MODE_BOTH_STELLAR_UVB_TRANSFER)):
            raise SystemExit("the L-level profile runs modes 9, 6, 8 and 1 "
                             "on one rank, the noneq chemistry in modes 9 "
                             "and 8")
        main_ml(n, level, mode, nested, bool(noneq), smi)
        return
    if nested:
        if ranks or noneq or mode not in (
                MODE_UVB_TRANSFER_ONLY, MODE_NO_STARS_THIN_UVB,
                MODE_BOTH_STELLAR_UVB_TRANSFER,
                MODE_STELLAR_TRANSFER_THIN_UVB):
            raise SystemExit("the two-level profile runs modes 9, 6, 8 and "
                             "1 on one rank with equilibrium chemistry")
        main_amr(n, level, mode, smi)
        return
    model, state, ctx = _setup(n, level, mode, ranks, bool(noneq))
    cfg = model.config
    mesh = make_grid_mesh(ranks) if ranks else None
    if noneq:
        step = model.make_noneq_step(MYR, ctx, mesh=mesh)
        carry = (state, chemistry_noneq.species_from_field_state(state))

        def run(c):
            return step(*c)[:2]
    else:
        step = model.make_step(ctx, mesh=mesh)
        carry = state

        def run(c):
            return step(c)[0] if ctx is not None else step(c)

    del state
    carry = run(carry)
    torch.cuda.synchronize()

    # per layer, CUDA events around each phase of one step
    layers = []
    if noneq:
        rows = noneq_layers(model, *carry, ctx=ctx, mesh=mesh)
        layers = [f"{k} {ms:.3f} ms (host {host:.3f} ms, {k_launches} "
                  f"launches)" for k, (ms, host, k_launches) in rows.items()]
    else:
        s0 = carry.zero_rates()
        if ctx is not None:
            steps0 = rays.MARCH_STEPS
            (s0, _, _), t_tr = _event_ms(lambda: model.trace(s0, ctx))
            march = rays.MARCH_STEPS - steps0
            layers.append(f"tracer {t_tr:.3f} ms ({march} march steps, "
                          f"{t_tr / max(march, 1):.4f} ms per step)")
        kappa, t_op = _event_ms(lambda: opacity.compute_opacities(
            s0.HI, s0.HeI, s0.HeII, model.opacity_coef))
        jmean, t_sw = _event_ms(lambda: model._run_sweep(kappa, mesh))
        s1 = dataclasses.replace(s0, Jmean=jmean)
        _, t_ch = _event_ms(lambda: chemistry.solve_rate_equations(
            s1, model.geom, model.dev_tables, ksi_matrix=model.ksi_matrix,
            gamma_thin=model.gamma_thin,
            self_shielding_threshold=cfg.self_shielding_threshold,
            run_uvb_transfer=True, n_iter=60))
        layers += [f"opacity {t_op:.3f} ms", f"sweep {t_sw:.3f} ms",
                   f"chemistry {t_ch:.3f} ms"]
    what = f"mode {mode}" + (" noneq" if noneq else "") + (
        f" on {ranks} ranks (rdma)" if ranks else "")
    print(f"{what} layers at {n}^3 x {model.sweep_plan.n_directions} dirs "
          f"f32: {', '.join(layers)}; card {smi}")

    torch.cuda.reset_peak_memory_stats()
    box = [carry]
    del carry
    wall, busy, kernels, top = profiled(run, box)
    for name, ms, count in top:
        print(f"  {ms:10.3f} ms {count:7d}x  {name[:100]}")
    print(f"{what}, 2 steps: wall {wall * 1e3:.3f} ms, device busy "
          f"{busy * 1e3:.3f} ms ({100 * busy / wall:.1f}% of wall), "
          f"{kernels:.0f} device kernels per step, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} "
          f"GiB; card {smi}")


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
