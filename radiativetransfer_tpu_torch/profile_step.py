"""Profile steps of the port on one CUDA device, layer by layer.

    python3 -m radiativetransfer_tpu_torch.profile_step [n] [level] [mode] \
        [ranks] [noneq] [amr]

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
    chemistry,
    chemistry_noneq,
    opacity,
    rays,
    rays_multilevel,
    sweep_amr,
    sweep_multilevel,
)
from .core.step_amr import AMRModel, MultiLevelModel
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


def main(n: int = 128, level: int = 3, mode: int = 9, ranks: int = 0,
         noneq: int = 0, nested: int = 0) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")
    smi = nvidia_smi()
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
