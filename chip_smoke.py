#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA device (an H100).

    python3 chip_smoke.py          # from the root of the repository

Drives radiativetransfer_tpu_torch's paths through their public entry
points -- mode 9 (UVB-only diffuse transfer + equilibrium chemistry), mode
8 (point sources + UVB), the roofline script, the bench, mode 9 on a 1-D
grid mesh, the CLI from files, the non-equilibrium chemistry, two-level
AMR, L-level AMR and its point sources and non-equilibrium chemistry,
block-sparse AMR, the compacting tracer, the checked pre-flight,
checkpoints and HDF4 grids -- and holds each hand-written kernel
against its plain PyTorch version.  Phases, one line or more each; any
failure raises and the script exits non-zero:

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
   count; step 1 against the plain slab scan; the tracer's float32
   deposits against its float64 trace with the same kills, in this cell
   and in the CLI galaxy's with its 12 sources (uniform_tracer_flush: the
   deposits below float32's normal range counted, those the f32 trace
   loses, of them those float32 can hold at most 1e-5 of the nonzero,
   every channel within 1e-5 of its peak);
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
    co-resident, refused;
16. the CLI on the card, from files written by the port's own grid_io
    (write_cli_inputs: examples/make_test_data.py's galaxy and 12
    sources): the 24^3 anchor through a restart from the neutral box
    (write_anchor_inputs); mode 9 at 128^3 x 192 through cli.main, 3
    iterations (the cluster kernel's launches, none of the plane
    kernel's; the `time` log, 3 snapshots, the last read back onto the
    equilibrium state); a restart through python -m
    radiativetransfer_tpu_torch.cli in a process of its own, run beside
    this process's next checks (itime 4 against the same iteration in
    this process); mode 8 with the 12 sources, 2 iterations (the
    `weight` file, cosmicSpectrum.npz, fesc in [0, 1]); mode 9 on 4 ranks
    through --sweep-strategy rdma (the cluster ring) and zones (the
    per-zone cluster kernel), 2 iterations each, checkpointed by
    --ckpt-format orbax, against the one-device run; each iteration's dt
    from the CLI's lines, the ingestion and one write_snapshot at 128^3
    timed (host), and the phase's seconds;
17. the non-equilibrium 9-species chemistry (RTModel.make_noneq_step,
    --chemistry noneq): one f64 noneq mode-9 step at 24^3, level 1, on
    the card against the same step on the CPU (every species within 1e-9
    of its peak); at 128^3 x 192 in f32 two noneq mode-9 steps through
    the cluster kernel, the first against the plain slab scan's (neutral
    fraction within 1e-4), the step layer by layer (tracer, opacity,
    sweep, _assemble_photo_rates, evolve_noneq: device ms, host ms,
    launches; profile_step.noneq_layers), one profiled step's device-busy
    share, peak memory; one noneq mode-8
    step with phase 9's sources (k27..k31 finite and non-negative, k31 >
    0 somewhere, the species' nH the state's within 1e-5); then the CLI
    from write_cli_inputs' files: noneq mode 9, 2 iterations, a restart
    through python -m from the itime-1 snapshot, beside mode 8 and the
    4-rank runs (its itime 2 within 1e-4 of this process's), noneq mode 8
    with the 12 sources, 1 iteration, and noneq mode 9 on 4 ranks through
    rdma and zones, 1 iteration each, checkpointed by --ckpt-format orbax
    (neutral fraction and HI within 1e-4 of one device's);
18. two-level AMR (core/step_amr.py::AMRModel and its tracer
    core/rays_amr.py, the L-level march at L = 2, plain PyTorch: no
    hand-written kernel runs on them, and every kernel's count is held
    across the phase but for check (c)):
    (a) one f64 mode-9 step and one f64 mode-8 step with 3 sources at 16^3
    with its refined centre, level 2, on the card against the CPU's (every
    species within 1e-9 of its peak on both levels, the ray diagnostics
    within 1e-9 of theirs); (b) the full-width cell, make_test_data.py's
    galaxy at 128^3 with its central half refined (262,144 parents, a
    dense 256^3 fine level) and its 12 sources, prepared as the CLI does,
    x 192 f32: the inputs written and ingested (amr_from_levels), the
    plan's setup, one mode-1 step layer by layer (profile_step.amr_layers:
    the tracer with its march steps, chemistry on each level,
    sync_restriction; CUDA events and host ms), peak memory, the neutral
    fraction below its start, the tracer in a profiler window, one zone's
    first 32 and 16 base slabs of the two-level sweep traced at the full
    width (launches, the device-busy share), the sweep's bytes floor, the
    f32 trace against the f64 trace of the same state with float32's kills
    (both levels' six channels within 5e-5 of each peak, the escape
    fractions within 1e-5) and the fine deposits below float32's smallest
    normal value counted; (c) 64^3 with nothing refined: the two-level
    step against the uniform step through the cluster kernel in the exact
    logmean form (base Jmean and the neutral fraction within 1e-4); (d)
    the CLI on the two-level 32^3 grid with its central half refined x
    192 (cut from 128^3: (b) times the full width, (d) covers the CLI's
    branch): mode 9, 2 iterations, a restart of one
    through python -m from the itime-1 snapshot beside mode 8 (within
    1e-4), mode 8
    with the 12 sources, 1 iteration (the `weight` file,
    cosmicSpectrum.npz, fesc in [0, 1], the neutral fraction below its
    start); (e) the launches of each layer at 32^3, level 3, mode 8 (the
    tracer with its march steps), from two profiler windows that must
    agree, the sweep's by zone (one zone at 32^3 from two windows, equal
    to (b)'s first 32 slabs at 128^3 width; (b)'s 16 and 32 slabs: the launches a
    base slab and a zone, whence a whole zone's count at 128^3, derived);
    every profiler window's markers, clocks and tails
    (profile_step.WINDOWS; a window that loses its markers is taken once
    more with a longer warm-up and tail, and raises if that one loses
    them too);
19. L-level dense AMR (core/step_amr.py::MultiLevelModel and its sweep
    core/sweep_multilevel.py, plain PyTorch: no hand-written kernel runs
    on them, and every kernel's count is held across the phase but for
    check (c)): (a) one f64 mode-9 step at 16^3 with its refined centre
    and core (3 levels), level 1, on the card against the CPU's (species
    and Jmean within 1e-10 of each level's peak); (b) the full-width cell,
    make_test_data.py's galaxy at ML_N^3 = 64^3 with its refined centre
    and core (dense 128^3 and 256^3 levels, the largest 3-level grid the
    JAX CLI keeps dense by default) x 192 f32: ingestion, plan setup, the
    coupling depth validated on the ingested grid (timed), one mode-9
    step from the equilibrium layer by layer (profile_step.ml_layers: opacity,
    the sweep, chemistry on each level, sync_restriction_multi; CUDA
    events and host ms), peak memory, the neutral fraction below its
    start, the first zone batch's first 8 base slabs traced (launches,
    the card's busy share), write_snapshot_ml timed, the same for mode 6;
    the sweep's launches from two agreeing profiler windows at 4^3 and
    8^3 bases, whence the full width's (derived); (c) one level (nothing
    refined) at 64^3: the L-level sweep against the uniform step's
    through the cluster kernel in the exact logmean form, and the galaxy
    at 16^3 cut to two levels against the two-level sweep (leaf Jmean
    within 1e-5 of each band's peak); (d) the CLI on the L-level
    ML_CLI_N^3 = 32^3 grid x 192: mode 9, 2 iterations (the grid: and
    coupling depth: lines), a restart of one
    from the itime-1 snapshot (within 1e-4), and mode 6;
20. point sources and the non-equilibrium chemistry on L-level grids
    (core/rays_multilevel.py, MultiLevelModel.trace and make_noneq_step,
    plain PyTorch: every kernel's count is held across the phase): (a)
    the galaxy at 16^3 with its refined centre and core, 3 levels, 3 of
    its sources at maxPixelLevel 4, f64, 2 coupling passes: one mode-8
    step, one noneq mode-9 step and one noneq mode-8 step (5 substeps) on
    the card against the CPU's,
    each level within 1e-9 of each field's peak; (b) phase 19's
    full-width cell at phase 19's coupling depth with the galaxy's 12
    sources, maxPixelLevel 6, f32: one mode-8 step layer by
    layer (profile_step.ml_layers: the tracer with its march steps, CUDA
    events and host ms), the tracer in a profiler window (the card's busy
    share), peak memory, one mode-1 step, one noneq mode-6 step (0.1 Myr
    in 20 substeps; a mode-9 step adds the mode-8 step's sweep layer)
    layer by layer (profile_step.ml_noneq_layers: evolve_noneq on each
    level), the
    f32 trace against the f64 trace of the same state with float32's
    kills (every level's six channels within 5e-5 of each peak, the
    escape fractions within 1e-5; the deposits below float32's smallest
    normal value and those the f32 trace lost counted), the tracer's
    launches a march step from two agreeing profiler windows at an 8^3
    base; (c) L = 2 on the card, f64, (a)'s 16^3 grid cut to two
    levels: one mode-8 step of MultiLevelModel(2) against one of AMRModel,
    each level's fields and rates and the ray diagnostics within 1e-9 of
    their peaks; (d) the CLI at ML_CLI_N^3 = 32^3, angular level 1: mode
    8 on the L-level grid and --chemistry noneq mode 9 on the two-level
    and the L-level grids, 2 iterations each through python -m, each in a
    process of its own beside (a) and (c), each restarted in this process
    from its itime-1 snapshot (within 1e-4; the noneq ones with their
    species);
21. block-sparse L-level AMR (core/amr_sparse.py, core/sweep_sparse.py,
    the block-sparse tracer of core/rays_multilevel.py, SparseMLModel with
    its stellar and noneq steps, the CLI's sparse branch; plain PyTorch:
    every kernel's count is held across the phase): (d) the CLI on the
    L-level ML_CLI_N^3 = 32^3 grid x 192 under --amr-storage sparse: mode
    9, 2 iterations (the block-sparse grid: line, the
    coupling depth: line), its restart through python -m from the itime-1
    snapshot in a process of its own beside (a) (within 1e-4); modes 8
    and 1 with the 12 sources (fesc, cosmicSpectrum.npz) and --chemistry noneq
    mode 9, 2 iterations each through python -m in processes of their
    own beside (a), the noneq run's species in its snapshots (level 0
    dense, the refined levels in blocks) and its restart in this process
    from the itime-1 snapshot (within 1e-4); mode 6, 2 iterations; (a)
    the 24^3 galaxy with its refined centre and core in blocks of 4 (W 20
    < 24), angular level 1, f64: one mode-9 step on the card windowed and
    one full-plane against the CPU's windowed step, and the windowed one
    against the dense L-level card step on covered cells, each level
    within 1e-10 of each field's peak; with 3 of its sources at
    maxPixelLevel 4, the block-sparse trace, a mode-8 step and a noneq
    mode-9 step (5 substeps) on the card against the CPU's, each level's
    channels, fields and species and the ray diagnostics within 1e-9 of
    their peaks; (b) the production cell MAIN_N^3 = 128^3 with its
    refined centre and core x 192 f32, stored block-sparse by the CLI's
    rule under --amr-storage auto: ingestion, compute_window (W, the skip
    share), plan, validate_coupling_depth, the equilibrium; with the
    galaxy's 12 sources at maxPixelLevel 6, one mode-8 step layer by
    layer (profile_step.sparse_layers: the tracer's device and host ms
    and march steps, then mode 9's layers: opacity, the sweep, chemistry
    on each level, sync_restriction_sparse, whose seconds, the mode-8
    step's less the tracer's host ms, stand for a mode-9 step's, derived),
    peak memory, memory_bytes,
    the first zone batch's first 8 covered base slabs traced (the card's
    busy share), a mode-6 step, the tracer's peak memory (held under half
    the dense form's finest int32 leaf-level volume and packed fields)
    and its busy share in a profiler window, one mode-1 step, one noneq
    mode-6 step layer by layer (profile_step.sparse_noneq_layers:
    evolve_noneq on each level; a mode-9 step adds the mode-8 step's
    sweep layer), the
    f32 trace against the f64 trace with float32's kills (5e-5 of each
    channel's peak, escape fractions 1e-5), and the tracer's launches a
    march step from two agreeing profiler windows at an 8^3 base; (c)
    phase 19's 64^3 cell in f32: its dense state stored block-sparse, the
    windowed sparse step against phase 19's dense L-level step on covered
    cells within 1e-5 of each field's peak; with the 12 sources, the
    block-sparse trace against the dense L-level one
    and a noneq mode-1 step (20 substeps) on either storage, every
    channel, field and species on covered cells within 1e-5 of its
    peak;
22. the single-card CLI's last features (plain PyTorch and host code:
    every count is held but for the two uniform steps, which launch the
    cluster kernel): (a) the compacting tracer
    (rays.trace_point_sources_compact) against the default one at phase
    9's cell (128^3 x 8 sources, maxPixelLevel 6, f32) on the state of
    one mode-8 step, in turns (default, compact, compact, default): ms,
    march steps, peak memory above the state, the final phase's buffer
    sizes; each in a profiler window (busy share, device events a march
    step); the deposits and diagnostics within 1e-5 of each peak; (b)
    --debug-checkify through cli.main, its pre-flight timed: mode 8 on the
    64^3 uniform galaxy x 192 (one iteration, one cluster launch, its
    state checkpointed by --ckpt-format orbax), mode
    9 on the 32^3 two-level, L-level and block-sparse grids at angular
    level 1 (the JAX CLI's line each); the 16^3 galaxy with a NaN through
    python -m in a process of its own beside the rest, exiting non-zero
    with FloatingPointError naming the op; (c) --ckpt-format orbax on the
    32^3 block-sparse grid at level 1: 3 iterations, and a restart from their
    ckpt0002 to the third within 1e-4 of the uninterrupted run (the
    neutral fraction and every checkpointed field); phase 21's 128^3
    block-sparse noneq state with its species checkpointed (write s, MB,
    restore s, every tensor equal); (d) the two-level 32^3 grid converted
    with convert.npz2h4 and run from its .h4 alone, its grid: and itime=
    lines those of (b)'s .npz run;
23. the mesh on every storage (parallel/rays_dist.py, the nested states'
    shard functions, sweep_dist.diffuse_sweep_sparse_zones; plain
    PyTorch, every count held but for (b)'s steps): (b) phase 9's mode-8
    cell (128^3 x 8 sources, maxPixelLevel 6, f32, the exact logmean) from
    the neutral box on one device, on 4 ranks with the one-device sweep
    (the source-parallel tracer alone differs) and on 4 ranks under rdma
    (the cluster ring, 24 launches): the deposits, Jmean, HI and the
    neutral fraction within 1e-4 of the one-device step's, the cells where
    HeI or HeII move by more than 1e-4 of their peaks counted; (a) the
    source-parallel tracer on 4 ranks against the single-device one on the
    one-device step's state, in turns (single, 4 ranks, 4 ranks, single):
    ms, march steps, peak memory above the state; each in a profiler
    window (busy share, device events a march step); the deposits and
    diagnostics within 1e-5 of each peak; one rank bit for bit the
    single-device trace under torch.use_deterministic_algorithms; (c)
    --mesh-shape 4 through cli.main on the 32^3 two-level, L-level and
    block-sparse grids in mode 8 and a noneq mode-8 iteration on the
    L-level one (level 1, maxPixelLevel 4, coupling depth 2), each log
    within 1e-4 of the same run without a mesh through python -m in a
    process of its own beside them; (d) the block-sparse zones sweep on 4
    ranks against the one-device sparse sweep at the 64^3 galaxy x 192
    (Jmean within 1e-5 of each band's peak on every level).

The last lines are the card's name and power limit, one JSON object of
every kernel's numbers, and {"ok": true, "device": {...}}.  Exits non-zero
without a CUDA device.  Needs no JAX and no network.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import dataclasses
import functools
import io
import json
import os
import re
import shutil
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
# phase 19's full-width L-level cell: write_cli_inputs' galaxy at ML_N^3
# with its refined centre and core (dense (2 ML_N)^3 and (4 ML_N)^3
# levels), and its CLI grid
ML_N, ML_CLI_N = 64, 32


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


def write_cli_inputs(directory: str, n: int, mode: int = 9,
                     restart: int = 0, refine_center: bool = False,
                     refine_core: bool = False) -> str:
    """The CLI's inputs in `directory`, made as examples/make_test_data.py
    makes them (that script imports the JAX package, so the formulas are
    copied and the grid written with the port's own grid_io): the
    synthetic galaxy `testgrid_velmet.npz` (n^3 cells in a 300 kpc box,
    seed 0, velocities and metals; with refine_center its level-2 cells
    over the central half of each axis, with refine_core also level-3
    cells over the central quarter), `testsources.dat` (12 sources, seed
    1, ages 1-30 Myr) and `inputParameters` (its keys: z 6.55,
    selfShieldingThreshold 0.1 kpc, upperAgeLimit 34 Myr, reionizationModel
    10; the given mode and restart; the default angular level 3, 192
    directions).  Returns the config's path."""
    from radiativetransfer_tpu_torch.io import grid_io
    os.makedirs(directory, exist_ok=True)
    box_kpc, n_src = 300.0, 12
    rng = np.random.default_rng(0)

    def galaxy(pos):
        """One level's cells at `pos` (kpc): the density profile with
        lognormal fluctuations, velocities and metals, drawn from rng."""
        r = np.sqrt((pos.astype(np.float64) ** 2).sum(axis=1))
        nh = 3e-3 * (1.0 + (r / (0.15 * box_kpc)) ** 2) ** -1
        nh = nh * rng.lognormal(0.0, 0.4, nh.shape)
        vel = rng.normal(0, 30, (len(nh), 3)).astype(np.float32)
        abun = np.zeros((len(nh), 4), np.float32)
        abun[:, 1] = 0.004 * np.exp(-r / (0.3 * box_kpc))
        m = len(nh)
        return grid_io.LevelData(
            pos=pos.astype(np.float32), lT=np.full(m, 4.0, np.float32),
            lnH=np.log10(nh).astype(np.float32),
            lx=np.zeros(m, np.float32), vel=vel, abun=abun)

    def centers(first: int, per_cell: int):
        """Cell centers (kpc) of the level with per_cell cells a base
        cell, over base cells first .. n - first - 1 of each axis."""
        ax = np.array([(i + (j + 0.5) / per_cell) / n * box_kpc - box_kpc / 2
                       for i in range(first, n - first)
                       for j in range(per_cell)])
        x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
        return np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1)

    levels = [galaxy(centers(0, 1))]
    if refine_center:
        levels.append(galaxy(centers(n // 4, 2)))
    if refine_center and refine_core:
        levels.append(galaxy(centers(3 * n // 8, 4)))
    grid_io.write_level_npz(os.path.join(directory, "testgrid_velmet.npz"),
                            levels)
    rng = np.random.default_rng(1)
    rows = []
    for _ in range(n_src):
        p = rng.normal(0, 0.08 * box_kpc, 3)
        age = rng.uniform(1.0, 30.0)
        rows.append(f"1 {p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {age:.3f}")
    with open(os.path.join(directory, "testsources.dat"), "w") as fh:
        fh.write("\n".join(rows) + "\n")
    path = os.path.join(directory, "inputParameters")
    with open(path, "w") as fh:
        fh.write(f"""sphDir = '{directory}/'
synthesisDir = '{directory}/'
grid = 'testgrid_velmet'
sources = 'testsources.dat'
currentRedshift = 6.55
mode = {mode}
dustApproximation = 0
selfShieldingThreshold = 0.1
massStellarParticle = 1
upperAgeLimit = 34.
restart = {restart}
restartCellArrayName = ''
reionizationModel = 10
""")
    return path


def write_anchor_inputs(directory: str) -> str:
    """The 24^3 mode-9 anchor's inputs for the CLI: a uniform box (200 kpc,
    nH = 1e-4, T = 2e4, fully neutral) written with the port's grid_io,
    and `cellArray0000.npz`, its ingested state before any chemistry,
    which the config restarts from (restart = 1), so the CLI's first
    iteration is the anchor's one step from the neutral box (run it with
    --angular-level 1).  Returns the config's path."""
    from radiativetransfer_tpu_torch.io import grid_io, snapshot
    os.makedirs(directory, exist_ok=True)
    n, box = 24, 200.0
    ax = (np.arange(n) + 0.5) / n * box - box / 2
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    pos = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1).astype(
        np.float32)
    m = n ** 3
    levels = [grid_io.LevelData(
        pos=pos, lT=np.full(m, np.log10(2e4), np.float32),
        lnH=np.full(m, -4.0, np.float32), lx=np.zeros(m, np.float32))]
    grid_io.write_level_npz(os.path.join(directory, "anchor.npz"), levels)
    state, geom = grid_io.build_uniform_state(levels, False, device="cpu")
    snapshot.write_snapshot(os.path.join(directory, "cellArray0000.npz"),
                            state, 0, geom.physical_box_size)
    path = os.path.join(directory, "inputParameters")
    with open(path, "w") as fh:
        fh.write(f"""sphDir = '{directory}/'
grid = 'anchor'
currentRedshift = 6.55
mode = 9
restart = 1
restartCellArrayName = 'cellArray0000.npz'
reionizationModel = 10
""")
    return path


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
                 noneq=False, **cfg_kw):
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
                               noneq=noneq, dtype=torch.float32,
                               device=DEVICE)
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
    # the tracer's float32 deposits against float64's: those below
    # float32's normal range survive the card's flushing index_add_
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        uniform_tracer_flush(tmp)
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


def _cli(config: str, outdir: str, *flags,
         tag: str = "16 cli") -> tuple[str, float]:
    """cli.main in this process on the card; (its output, echoed here,
    and the call's seconds)."""
    from radiativetransfer_tpu_torch import cli
    os.makedirs(outdir, exist_ok=True)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main([config, "--snapshot-dir", outdir, *flags])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    for line in buf.getvalue().splitlines():
        print(f"[{tag}]   {line}")
    return buf.getvalue(), seconds


class _CliProcess:
    """`python -m radiativetransfer_tpu_torch.cli *argv` in a process of its
    own, started from the script's directory and run while this process
    goes on (a restart through the real entry point); result() waits for
    it.  An unfinished one is killed when the script exits."""
    live: list = []

    def __init__(self, argv):
        import tempfile
        import threading
        self.out, self.err = (tempfile.TemporaryFile("w+") for _ in "oe")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "radiativetransfer_tpu_torch.cli", *argv],
            stdout=self.out, stderr=self.err, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        self.seconds = None
        self.waiter = threading.Thread(target=self._wait, daemon=True)
        self.waiter.start()
        _CliProcess.live.append(self.proc)

    def _wait(self):
        self.proc.wait()
        self.seconds = time.perf_counter() - self.t0

    def result(self, timeout: float = 600.0):
        """(return code, stdout, stderr, the process's wall seconds)."""
        self.waiter.join(timeout)
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
            raise TimeoutError(f"the CLI process ran over {timeout} s")
        _CliProcess.live.remove(self.proc)
        self.out.seek(0)
        self.err.seek(0)
        return (self.proc.returncode, self.out.read(), self.err.read(),
                self.seconds)


@atexit.register
def _kill_cli_processes() -> None:
    for proc in _CliProcess.live:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _config_variant(config: str, dest: str, **subs) -> str:
    """A copy of an inputParameters file at `dest` with `key = value`
    lines replaced (e.g. mode=8, restart=1)."""
    with open(config) as fh:
        text = fh.read()
    for key, value in subs.items():
        text, n = re.subn(rf"(?m)^{key} = .*$", f"{key} = {value}", text)
        assert n == 1, key
    with open(dest, "w") as fh:
        fh.write(text)
    return dest


def _time_log(outdir: str) -> dict[int, float]:
    with open(os.path.join(outdir, "time")) as fh:
        rows = [re.fullmatch(r"itime =\s*(\d+)\s+(\S+)", line.rstrip("\n"))
                for line in fh]
    return {int(m.group(1)): float(m.group(2)) for m in rows if m}


def _iteration_dts(out: str, cells_angles: int) -> list[float]:
    """Each iteration's wall seconds from the CLI's own lines, to three
    digits: cells*angles over the printed rate (the printed dt has two
    decimals)."""
    return [cells_angles / float(x) for x in re.findall(
        r"itime=\d+ neutral=\S+ dt=\S+s \((\S+) cells\*angles/s\)", out)]


def _device_busy(trace_path: str) -> tuple[float, float, int]:
    """(device-busy ms, traced wall ms, device events) of a chrome trace
    written by torch.profiler: the union of the kernels', copies' and
    sets' intervals on the card, and the span of every traced event."""
    with open(trace_path) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("cat") in (
                       "kernel", "gpu_memcpy", "gpu_memset"))
    busy, reach = 0.0, float("-inf")
    for start, end in spans:
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    wall = (max(float(e["ts"]) + float(e["dur"]) for e in events)
            - min(float(e["ts"]) for e in events))
    return busy / 1e3, wall / 1e3, len(spans)


def _fmt(xs) -> str:
    return "[" + ", ".join(f"{x:.4g}" for x in xs) + "]"


def phase_cli(smi: str) -> dict:
    """16: the CLI on the card (python -m radiativetransfer_tpu_torch.cli
    and cli.main) from files written by the port's own grid_io."""
    import tempfile

    from radiativetransfer_tpu_torch import RTModel
    from radiativetransfer_tpu_torch.config import load_config
    from radiativetransfer_tpu_torch.core import sweep_cluster, sweep_cuda
    from radiativetransfer_tpu_torch.io import grid_io, snapshot
    from radiativetransfer_tpu_torch.parallel import sweep_rdma
    t_phase = time.perf_counter()
    n = MAIN_N
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        # the 24^3 anchor through the CLI: one f32 step from the neutral
        # box restored from cellArray0000.npz
        anchor = os.path.join(tmp, "anchor")
        config = write_anchor_inputs(anchor)
        _zero_sweep_launches()
        _cli(config, anchor, "--iters", "1", "--angular-level", "1")
        nf = _time_log(anchor)[1]
        rel = abs(nf - ANCHOR_NF) / ANCHOR_NF
        print(f"[16 cli] 24^3 anchor through a restart: neutral fraction "
              f"{nf:.7f} vs {ANCHOR_NF} (rel {rel:.2e}); cluster, plane "
              f"kernel launches {_sweep_launches()}")
        assert rel <= ANCHOR_RTOL and _sweep_launches() == (1, 0), nf
        launches["cli_anchor"] = sweep_cluster.LAUNCHES

        # the inputs at n^3: the synthetic galaxy, 12 sources
        inputs = os.path.join(tmp, "inputs")
        t0 = time.perf_counter()
        config = write_cli_inputs(inputs, n)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        levels = grid_io.read_level_npz(os.path.join(inputs,
                                                     "testgrid_velmet.npz"))
        state, geom = grid_io.build_uniform_state(levels, True,
                                                  device=DEVICE)
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        print(f"[16 cli] inputs at {n}^3 written in {write_s:.3f} s; "
              f"ingested (read_level_npz + build_uniform_state onto the "
              f"card) in {ingest_s:.3f} s (host)")

        # mode 9, 3 iterations in this process
        d9 = os.path.join(tmp, "mode9")
        _zero_sweep_launches()
        out9, call9 = _cli(config, d9, "--iters", "3")
        launches["cli_mode9"] = sweep_cluster.LAUNCHES
        log9 = _time_log(d9)
        dts9 = _iteration_dts(out9, n ** 3 * 192)
        print(f"[16 cli] mode 9 {n}^3 x 192 f32: call {call9:.3f} s, "
              f"iterations' dt {_fmt(dts9)} s, neutral fractions "
              f"{list(log9.values())}, cluster kernel launches "
              f"{sweep_cluster.LAUNCHES}, plane kernel {sweep_cuda.LAUNCHES}")
        assert sweep_cluster.LAUNCHES > 0 and sweep_cuda.LAUNCHES == 0
        assert list(log9) == [1, 2, 3], log9
        assert all(np.isfinite(v) and 0.0 <= v <= 1.0
                   for v in log9.values()), log9
        snaps = [snapshot.snapshot_name(i, d9) for i in (1, 2, 3)]
        assert all(os.path.exists(p) for p in snaps)
        assert snapshot.latest_snapshot(d9) == snaps[-1]

        # the loop of 2 iterations under --profile: the card's busy share
        # of the traced wall (snapshots included)
        prof = os.path.join(tmp, "profile")
        _zero_sweep_launches()
        _cli(config, os.path.join(tmp, "mode9_profiled"), "--iters", "2",
             "--profile", prof)
        launches["cli_profiled"] = sweep_cluster.LAUNCHES
        busy_ms, traced_ms, n_dev = _device_busy(os.path.join(prof,
                                                              "trace.json"))
        print(f"[16 cli] mode 9 {n}^3 --profile, 2 iterations: device busy "
              f"{busy_ms:.3f} ms of {traced_ms:.3f} ms traced "
              f"({100 * busy_ms / traced_ms:.2f}%), {n_dev} device events")
        assert n_dev > 0 and busy_ms > 0, "the trace shows no device time"

        # restart through the real entry point, one more iteration, in a
        # process of its own while this one reads and writes the snapshot,
        # runs the same iteration and mode 8 (it writes only into d9)
        restart = _config_variant(config, os.path.join(tmp, "restart"),
                                  restart=1)
        restarted = _CliProcess([restart, "--snapshot-dir", d9, "--iters",
                                 "1"])

        # the last snapshot onto the equilibrium state: HI as written
        model = RTModel.setup(load_config(config), geom, torch.float32,
                              DEVICE)
        eq = model.initialize_equilibrium(state)
        back, itime = snapshot.read_snapshot(snaps[-1], eq)
        with np.load(snaps[-1]) as f:
            written = f["HI"].reshape(back.shape)
        hi = back.HI.detach().cpu().numpy()
        err = float(np.max(np.abs(hi - written) / np.maximum(written,
                                                            1e-30)))
        print(f"[16 cli] read_snapshot of {os.path.basename(snaps[-1])} "
              f"(itime {itime}) onto the equilibrium state: HI max rel "
              f"diff {err:.2e} from the written field (tol 1.2e-7)")
        assert itime == 3 and err <= 1.2e-7, err
        t0 = time.perf_counter()
        snapshot.write_snapshot(os.path.join(tmp, "timed.npz"), back, 3,
                                geom.physical_box_size)
        snap_s = time.perf_counter() - t0
        snap_mb = os.path.getsize(os.path.join(tmp, "timed.npz")) / 1e6
        print(f"[16 cli] write_snapshot at {n}^3 alone: {snap_s:.3f} s "
              f"(host; {snap_mb:.1f} MB compressed)")
        del back, eq, state, model

        # the same 4th iteration in this process, from the same snapshot
        d9b = os.path.join(tmp, "mode9_restart")
        os.makedirs(d9b)
        shutil.copy(snaps[-1], d9b)
        _zero_sweep_launches()
        _cli(restart, d9b, "--iters", "1")
        launches["cli_restart"] = sweep_cluster.LAUNCHES

        # mode 8, the 12 sources, 2 iterations
        d8 = os.path.join(tmp, "mode8")
        os.makedirs(d8)
        mode8 = _config_variant(config, os.path.join(tmp, "mode8.cfg"),
                                mode=8)
        _zero_sweep_launches()
        out8, call8 = _cli(mode8, d8, "--iters", "2")
        launches["cli_mode8"] = sweep_cluster.LAUNCHES
        assert sweep_cluster.LAUNCHES > 0 and sweep_cuda.LAUNCHES == 0
        merged = int(re.search(r"non-degenerate = \d+ \d+ (\d+)",
                               out8).group(1))
        with open(os.path.join(d8, "weight")) as fh:
            assert len(fh.read().splitlines()) == merged
        with np.load(os.path.join(d8, "cosmicSpectrum.npz")) as f:
            assert np.isfinite(f["spectrum"]).all()
            assert np.isfinite(f["freq"]).all()
        fesc = [float(v) for m in re.findall(r"fesc=(\S+)", out8)
                for v in m.split("/")]
        assert len(fesc) > 0 and all(0.0 <= v <= 1.0 for v in fesc), fesc
        log8 = _time_log(d8)
        assert list(log8) == [1, 2] and all(
            0.0 <= v <= 1.0 for v in log8.values()), log8
        dts8 = _iteration_dts(out8, n ** 3 * 192)
        print(f"[16 cli] mode 8 {n}^3 x 192 f32, {merged} sources: call "
              f"{call8:.3f} s, iterations' dt {_fmt(dts8)} s, cluster "
              f"kernel "
              f"launches {sweep_cluster.LAUNCHES}")

        # the restart's 4th iteration against this process's
        rc, stdout, stderr, restart_s = restarted.result()
        for line in stdout.splitlines():
            print(f"[16 cli]   {line}")
        assert rc == 0, stderr[-4000:]
        assert (f"restarted from {snaps[-1]} at itime=3" in stdout), stdout
        with open(os.path.join(d9, "time")) as fh:
            assert "itime =    4" in fh.read()
        nf_sub, nf_in = _time_log(d9)[4], _time_log(d9b)[4]
        rel = abs(nf_sub - nf_in) / nf_in
        print(f"[16 cli] restart: python -m ...cli {restart_s:.3f} s (beside "
              f"this process's checks), itime 4 neutral fraction "
              f"{nf_sub:.8f} against {nf_in:.8f} in this process (rel "
              f"{rel:.2e}, tol 1e-4)")
        assert rel <= 1e-4, (nf_sub, nf_in)

        # mode 9 on a 4-rank mesh: the ring, then the zones strategy
        mesh_logs, mesh = {}, {}
        for strategy in ("rdma", "zones"):
            d = os.path.join(tmp, strategy)
            sweep_rdma.RING_LAUNCHES = sweep_rdma.RDMA_LAUNCHES = 0
            sweep_cluster.ZONE_LAUNCHES = sweep_cuda.ZONE_LAUNCHES = 0
            # checkpointed (--ckpt-format orbax), not two 128^3 snapshots
            out, call = _cli(config, d, "--iters", "2", "--sweep-strategy",
                             strategy, "--mesh-shape", "4", "--ckpt-format",
                             "orbax")
            assert os.path.isdir(os.path.join(d, "ckpt0002"))
            mesh[strategy] = {
                "call_s": call, "dts": _iteration_dts(out, n ** 3 * 192),
                "ring": sweep_rdma.RING_LAUNCHES,
                "plane_ring": sweep_rdma.RDMA_LAUNCHES,
                "zone": sweep_cluster.ZONE_LAUNCHES,
                "plane_zone": sweep_cuda.ZONE_LAUNCHES}
            mesh_logs[strategy] = _time_log(d)
            rels = [abs(mesh_logs[strategy][i] - log9[i]) / log9[i]
                    for i in (1, 2)]
            print(f"[16 cli] mode 9 {n}^3 on 4 ranks, {strategy}: call "
                  f"{call:.3f} s, dt {_fmt(mesh[strategy]['dts'])} s, "
                  f"neutral "
                  f"fractions rel {max(rels):.2e} from one device's (tol "
                  f"1e-4); launches {mesh[strategy]}")
            assert max(rels) <= 1e-4, (strategy, rels)
        assert mesh["rdma"]["ring"] > 0 and mesh["rdma"]["zone"] == 0
        assert mesh["rdma"]["plane_ring"] == 0, "the CLI took the plane ring"
        assert mesh["zones"]["zone"] > 0 and mesh["zones"]["plane_zone"] == 0
        assert mesh["zones"]["ring"] == mesh["zones"]["plane_ring"] == 0
    phase_s = time.perf_counter() - t_phase
    print(f"[16 cli] phase 16: {phase_s:.1f} s; {smi}")
    return {"launches": launches, "mesh": mesh, "phase_s": phase_s,
            "busy_share": busy_ms / traced_ms,
            "write_snapshot_s": snap_s, "ingest_s": ingest_s,
            "dts9": dts9, "dts8": dts8, "restart_s": restart_s}


def _species_worst(a, b) -> float:
    """The largest |a - b| over the 9 species and the energy, each over its
    peak in b."""
    from radiativetransfer_tpu_torch.core.chemistry_noneq import SPECIES
    worst = 0.0
    for name in (*SPECIES, "eint"):
        x = getattr(a, name).detach().cpu().double()
        y = getattr(b, name).detach().cpu().double()
        worst = max(worst, float((x - y).abs().max() / y.abs().max()))
    return worst


def phase_noneq(smi: str) -> dict:
    """17: the non-equilibrium 9-species chemistry (RTModel.make_noneq_step,
    the CLI's --chemistry noneq) on the card, driving the cluster kernel,
    the ring and the per-zone kernel."""
    import tempfile

    import radiativetransfer_tpu_torch as rt
    from radiativetransfer_tpu_torch import profile_step
    from radiativetransfer_tpu_torch.bench import bench_sources
    from radiativetransfer_tpu_torch.config import MODE_UVB_TRANSFER_ONLY
    from radiativetransfer_tpu_torch.constants import KPC, MYR
    from radiativetransfer_tpu_torch.core import chemistry_noneq as cn
    from radiativetransfer_tpu_torch.core import (rays, sweep_cluster,
                                                  sweep_cuda)
    from radiativetransfer_tpu_torch.core.step import StellarContext
    from radiativetransfer_tpu_torch.io import snapshot
    from radiativetransfer_tpu_torch.parallel import sweep_rdma
    from radiativetransfer_tpu_torch.profile_step import galaxy_state
    from radiativetransfer_tpu_torch.tables import stellar
    t_phase = time.perf_counter()
    f32, f64 = torch.float32, torch.float64
    launches, out = {}, {}

    def model9(n, level, dtype, device, **kw):
        cfg = rt.RunConfig(mode=MODE_UVB_TRANSFER_ONLY, current_redshift=6.55,
                           n_angular_level=level, reionization_model=10,
                           self_shielding_threshold_kpc=0.1, **kw)
        return rt.RTModel.setup(cfg, rt.GridGeometry(n, n, n, 300.0 * KPC),
                                dtype, device)

    def timed(fn):
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, time.perf_counter() - t0

    # (a) f64 at 24^3, level 1: one step on the card against the CPU's,
    # both from the CPU's equilibrium
    cpu = model9(24, 1, f64, "cpu")
    eq = cpu.initialize_equilibrium(galaxy_state(24, 300.0, "cpu",
                                                 dtype=f64))
    runs = {}
    for device, model in (("cpu", cpu), (DEVICE, model9(24, 1, f64, DEVICE))):
        st = rt.FieldState.from_numpy(eq.to_numpy(), dtype=f64, device=device)
        sp = cn.species_from_field_state(st, f_h2=1e-4)
        _zero_sweep_launches()
        (st, sp), dt = timed(lambda: model.make_noneq_step(MYR)(st, sp))
        runs[device] = (sp, dt, _sweep_launches())
    worst = _species_worst(runs[DEVICE][0], runs["cpu"][0])
    print(f"[17 noneq] 24^3 level 1 f64 mode 9, one noneq step: card "
          f"{runs[DEVICE][1]:.3f} s, CPU {runs['cpu'][1]:.3f} s; species "
          f"max diff {worst:.2e} of each peak (tol 1e-9); cluster, plane "
          f"kernel launches {runs[DEVICE][2]}")
    assert worst <= 1e-9 and runs[DEVICE][2] == (1, 0), (worst,
                                                        runs[DEVICE][2])
    launches["noneq_f64"] = runs[DEVICE][2][0]

    # (b) 128^3 x 192 f32 in this process: mode 9 with the cluster kernel,
    # its first step against the plain slab scan's
    n, level = MAIN_N, MAIN_LEVEL
    model = model9(n, level, f32, DEVICE)
    state = model.initialize_equilibrium(galaxy_state(n, 300.0, DEVICE))
    species = cn.species_from_field_state(state)
    step = model.make_noneq_step(MYR)
    torch.cuda.reset_peak_memory_stats()
    _zero_sweep_launches()
    st, sp, nfs, dts = state, species, [], []
    for it in (1, 2):
        (st, sp), dt = timed(lambda: step(st, sp))
        nfs.append(model.neutral_fraction(st))
        dts.append(dt)
        print(f"[17 noneq] {n}^3 x 192 f32 mode 9 noneq: step {it} "
              f"neutral fraction {nfs[-1]:.7f} wall {dt:.4f} s, "
              f"sweep_cluster.LAUNCHES {sweep_cluster.LAUNCHES}")
        assert np.isfinite(nfs[-1]) and 0.0 <= nfs[-1] <= 1.0, nfs
    launches["noneq_mode9"] = sweep_cluster.LAUNCHES
    assert sweep_cluster.LAUNCHES == 2 and sweep_cuda.LAUNCHES == 0
    peak9 = torch.cuda.max_memory_allocated() / 2 ** 30
    scan = model9(n, level, f32, DEVICE, use_pallas_sweep=False)
    (st_scan, _), dt_scan = timed(lambda: scan.make_noneq_step(MYR)(
        state, species))
    nf_scan = scan.neutral_fraction(st_scan)
    rel = abs(nfs[0] - nf_scan) / nf_scan
    print(f"[17 noneq] step 1 with the plain slab scan: neutral fraction "
          f"{nf_scan:.7f} wall {dt_scan:.3f} s; kernel step rel {rel:.2e} "
          f"(tol 1e-4); peak device memory {peak9:.3f} GiB")
    assert rel <= 1e-4, (nfs[0], nf_scan)
    del st_scan, scan
    # the step layer by layer, and its device-busy share
    rows = profile_step.noneq_layers(model, st, sp)
    print("[17 noneq] layers (device ms by CUDA events, host ms to enqueue, "
          "kernel launches): " + ", ".join(
              f"{k} {ms:.3f} / {host:.3f} / {k_n}"
              for k, (ms, host, k_n) in rows.items()))
    wall, busy, kernels, top = profile_step.profiled(
        lambda c: step(*c), [(st, sp)], steps=1)
    print(f"[17 noneq] one profiled noneq step: wall {wall * 1e3:.3f} ms, "
          f"device busy {busy * 1e3:.3f} ms ({100 * busy / wall:.2f}%), "
          f"{kernels:.0f} device events; top kernels "
          + "; ".join(f"{name[:48]} {ms:.2f} ms x{c}"
                      for name, ms, c in top[:4]))
    assert kernels > 0 and busy > 0
    out.update(dts9=dts, peak9_gib=peak9, layers=rows, busy_share=busy / wall,
               profiled_wall_s=wall)
    del st, sp, state, species, model, step

    # mode 8 with phase 9's sources, one step
    pos = bench_sources(n, MODE8_SOURCES).position
    pop = stellar.blackbody_population(q_ionizing=1.0e51)
    m8, ctx = _mode8_model(n, level, 2000.0, MODE8_SOURCES, pos, pop, 6,
                           noneq=True)
    s8 = rt.uniform_state(n, nh=2e-4, tgas=1.5e4, dtype=f32, device=DEVICE)
    sp8 = cn.species_from_field_state(s8, f_h2=1e-4)
    torch.cuda.reset_peak_memory_stats()
    _zero_sweep_launches()
    (st8, sp8b, diag), dt8 = timed(lambda: m8.make_noneq_step(MYR, ctx)(
        s8, sp8))
    launches["noneq_mode8"] = sweep_cluster.LAUNCHES
    assert sweep_cluster.LAUNCHES == 1 and sweep_cuda.LAUNCHES == 0
    peak8 = torch.cuda.max_memory_allocated() / 2 ** 30
    _, rf, _ = m8.trace(s8.zero_rates(), ctx, "quadrature_noneq")
    k_max = {}
    for c in range(27, 32):
        k = getattr(rf, f"krate{c}")
        assert bool(torch.isfinite(k).all()) and float(k.min()) >= 0.0, c
        k_max[c] = float(k.max())
    # the k27..k31 deposits with the weights StellarContext.build makes,
    # against the same trace in float64: with float32's kills on both
    # sides (printed) and with the kills off (held within 1e-5 of each
    # channel's peak, as float32 traces are held).  A kill falls a march
    # step apart in the two dtypes and cuts the channels the gas leaves
    # unattenuated (k27, k28, k31) there.
    ctx64 = StellarContext.build(pop, ctx.sources, m8.geom, 10.0 * MYR,
                                 metal_coefs=[(0, 0.0)], max_pixel_level=6,
                                 noneq=True, dtype=f64, device=DEVICE)

    def trace(dtype, tables, tau_kill, rel_kill):
        s = rt.uniform_state(n, nh=2e-4, tgas=1.5e4, dtype=dtype,
                             device=DEVICE)
        return rays.trace_point_sources(
            s, m8.geom, ctx.sources, tables, max_pixel_level=6, dtype=dtype,
            rates_mode="quadrature_noneq", tau_kill=tau_kill,
            rel_kill=rel_kill)[0]

    kills = (rays.default_tau_kill(f32), rays.default_rel_kill(f32))
    pairs = {"f32 kills": (rf, trace(f64, ctx64.tables, *kills)),
             "no kills": (trace(f32, ctx.tables, float("inf"), 0.0),
                          trace(f64, ctx64.tables, float("inf"), 0.0))}
    k_err = {tag: max(
        float((getattr(a, f"krate{c}").double() - getattr(b, f"krate{c}"))
              .abs().max() / getattr(b, f"krate{c}").abs().max())
        for c in range(27, 32)) for tag, (a, b) in pairs.items()}
    del pairs, ctx64
    nh_rel = float(((sp8b.nh - st8.nh).abs() / st8.nh).max())
    nf8 = m8.neutral_fraction(st8)
    print(f"[17 noneq] {n}^3 x 192 f32 mode 8 noneq, {MODE8_SOURCES} "
          f"sources: wall {dt8:.3f} s, neutral fraction {nf8:.7f}, "
          f"k27..k31 max {k_max}, their max diff from the f64 trace of "
          f"each peak: with f32's kills {k_err['f32 kills']:.2e}, without "
          f"kills {k_err['no kills']:.2e} (tol 1e-5); species nh vs state "
          f"nh max rel {nh_rel:.2e} (tol 1e-5), peak device memory "
          f"{peak8:.3f} GiB")
    assert k_max[31] > 0.0 and nh_rel <= 1e-5 and 0.0 <= nf8 <= 1.0
    assert k_err["no kills"] <= 1e-5, k_err
    assert bool(torch.isfinite(diag.ndot_remaining).all())
    out.update(dt8=dt8, peak8_gib=peak8, k_f32_err=k_err)
    del st8, sp8b, s8, sp8, rf, m8, ctx

    # (c) the CLI: mode 9, a restart through python -m, mode 8, 4 ranks
    noneq = ("--chemistry", "noneq")
    cells_angles = n ** 3 * 192
    with tempfile.TemporaryDirectory() as tmp:
        config = write_cli_inputs(os.path.join(tmp, "inputs"), n)
        d9 = os.path.join(tmp, "noneq9")
        _zero_sweep_launches()
        out9, call9 = _cli(config, d9, "--iters", "2", *noneq,
                           tag="17 noneq")
        launches["cli_noneq_mode9"] = sweep_cluster.LAUNCHES
        assert sweep_cluster.LAUNCHES == 2 and sweep_cuda.LAUNCHES == 0
        log9 = _time_log(d9)
        dts9 = _iteration_dts(out9, cells_angles)
        assert list(log9) == [1, 2] and all(
            0.0 <= v <= 1.0 for v in log9.values()), log9
        with np.load(snapshot.snapshot_name(2, d9)) as f:
            keys = [k for k in f if k.startswith("species0_")]
            assert len(keys) == 10 and all(
                f[k].shape == (n,) * 3 and f[k].dtype == np.float32
                and np.isfinite(f[k]).all() for k in keys), keys
        print(f"[17 noneq] CLI mode 9 noneq {n}^3 x 192: call {call9:.3f} s, "
              f"iterations' dt {_fmt(dts9)} s, neutral fractions "
              f"{list(log9.values())}")

        # restart through the entry point from the itime-1 snapshot, in a
        # process of its own while this one runs mode 8
        dr = os.path.join(tmp, "noneq9_restart")
        os.makedirs(dr)
        shutil.copy(snapshot.snapshot_name(1, d9), dr)
        restart = _config_variant(config, os.path.join(tmp, "restart"),
                                  restart=1)
        restarted = _CliProcess([restart, "--snapshot-dir", dr, "--iters",
                                 "1", *noneq])

        # mode 8, the 12 sources, 1 iteration
        d8 = os.path.join(tmp, "noneq8")
        os.makedirs(d8)
        mode8 = _config_variant(config, os.path.join(tmp, "mode8.cfg"),
                                mode=8)
        _zero_sweep_launches()
        out8, call8 = _cli(mode8, d8, "--iters", "1", *noneq,
                           tag="17 noneq")
        launches["cli_noneq_mode8"] = sweep_cluster.LAUNCHES
        assert sweep_cluster.LAUNCHES == 1 and sweep_cuda.LAUNCHES == 0
        log8 = _time_log(d8)
        dts8 = _iteration_dts(out8, cells_angles)
        fesc = [float(v) for m in re.findall(r"fesc=(\S+)", out8)
                for v in m.split("/")]
        assert fesc and all(0.0 <= v <= 1.0 for v in fesc), fesc
        assert list(log8) == [1] and all(
            0.0 <= v <= 1.0 for v in log8.values()), log8
        print(f"[17 noneq] CLI mode 8 noneq {n}^3 x 192, 12 sources: call "
              f"{call8:.3f} s, iterations' dt {_fmt(dts8)} s")

        # mode 9 on 4 ranks through the ring and the zones strategy,
        # checkpointed (--ckpt-format orbax, not a 128^3 snapshot with the
        # species), while the restart goes on beside
        with np.load(snapshot.snapshot_name(1, d9)) as f:
            hi_one = f["HI"]
        mesh = {}
        for strategy in ("rdma", "zones"):
            d = os.path.join(tmp, f"noneq_{strategy}")
            sweep_rdma.RING_LAUNCHES = sweep_rdma.RDMA_LAUNCHES = 0
            sweep_cluster.ZONE_LAUNCHES = sweep_cuda.ZONE_LAUNCHES = 0
            out_m, call = _cli(config, d, "--iters", "1", *noneq,
                               "--sweep-strategy", strategy, "--mesh-shape",
                               "4", "--ckpt-format", "orbax", tag="17 noneq")
            mesh[strategy] = {
                "call_s": call, "dts": _iteration_dts(out_m, cells_angles),
                "ring": sweep_rdma.RING_LAUNCHES,
                "plane_ring": sweep_rdma.RDMA_LAUNCHES,
                "zone": sweep_cluster.ZONE_LAUNCHES,
                "plane_zone": sweep_cuda.ZONE_LAUNCHES}
            nf = _time_log(d)[1]
            rel = abs(nf - log9[1]) / log9[1]
            # the uniform grid's leaf stream is its C order
            hi = torch.load(os.path.join(d, "ckpt0001", "leaves_rank0.pt"),
                            weights_only=True)["0.HI"].numpy().reshape(-1)
            hi_err = float(np.abs(hi - hi_one).max() / np.abs(hi_one).max())
            print(f"[17 noneq] CLI mode 9 noneq on 4 ranks, {strategy}: "
                  f"call {call:.3f} s, dt {_fmt(mesh[strategy]['dts'])} s, "
                  f"neutral fraction rel {rel:.2e}, HI max diff "
                  f"{hi_err:.2e} of its peak from one device's (tol 1e-4); "
                  f"launches {mesh[strategy]}")
            assert rel <= 1e-4 and hi_err <= 1e-4, (strategy, rel, hi_err)
        assert mesh["rdma"]["ring"] > 0 and mesh["rdma"]["zone"] == 0
        assert mesh["rdma"]["plane_ring"] == 0, "the CLI took the plane ring"
        assert mesh["zones"]["zone"] > 0 and mesh["zones"]["plane_zone"] == 0

        rc, stdout, stderr, restart_s = restarted.result()
        for line in stdout.splitlines():
            print(f"[17 noneq]   {line}")
        assert rc == 0, stderr[-4000:]
        assert "restored 9-species noneq state from snapshot" in stdout
        assert (f"restarted from {snapshot.snapshot_name(1, dr)} at itime=1"
                in stdout), stdout
        nf_sub = _time_log(dr)[2]
        rel = abs(nf_sub - log9[2]) / log9[2]
        print(f"[17 noneq] restart: python -m ...cli {restart_s:.3f} s "
              f"(beside mode 8 and the 4-rank runs), itime 2 neutral fraction "
              f"{nf_sub:.8f} against {log9[2]:.8f} in this process (rel "
              f"{rel:.2e}, tol 1e-4)")
        assert rel <= 1e-4, (nf_sub, log9[2])
    phase_s = time.perf_counter() - t_phase
    print(f"[17 noneq] phase 17: {phase_s:.1f} s; {smi}")
    out.update(launches=launches, mesh=mesh, phase_s=phase_s, cli_dts9=dts9,
               cli_dts8=dts8, restart_s=restart_s)
    return out


def _kernel_counts() -> dict:
    """Every hand-written kernel's launches so far, by kernel."""
    from radiativetransfer_tpu_torch.core import (
        probes_cuda,
        scatter_cuda,
        sweep_cluster,
        sweep_cuda,
        variants_cuda,
    )
    from radiativetransfer_tpu_torch.parallel import sweep_rdma
    return {"sweep_cluster": sweep_cluster.LAUNCHES,
            "sweep_merged": sweep_cuda.LAUNCHES,
            "sweep_zone_cluster": sweep_cluster.ZONE_LAUNCHES,
            "sweep_zone": sweep_cuda.ZONE_LAUNCHES,
            "sweep_zone_ring_cluster": sweep_rdma.RING_LAUNCHES,
            "sweep_zone_rdma": sweep_rdma.RDMA_LAUNCHES,
            "probes": sum(probes_cuda.LAUNCHES.values()),
            "scatter_rows": scatter_cuda.LAUNCHES,
            "scatter_red_floor": scatter_cuda.FLOOR_LAUNCHES,
            "sweep_variants": sum(variants_cuda.LAUNCHES.values()),
            "sweep_variants_cluster": sum(
                variants_cuda.CLUSTER_LAUNCHES.values())}


def uniform_tracer_flush(tmp: str, n: int = MAIN_N) -> dict:
    """The uniform tracer's (core/rays.py) float32 deposits on the card
    against its float64 trace of the same state with the same (float32's)
    kills, in two cells at n^3: bench.py::bench_step's (8 sources from
    seed 0, 2000 kpc, nH 2e-4, T 1.5e4, maxPixelLevel 6) and the CLI's
    galaxy (write_cli_inputs, its 12 sources prepared as the CLI does, at
    its equilibrium, maxPixelLevel 6).  Per cell, over the six deposit
    channels: the f64 trace's nonzero deposits below float32's smallest
    normal value (1.18e-38), those the f32 trace keeps as subnormals and
    those it loses to 0 (and of those the ones float32 can hold: at least
    its smallest subnormal, 2^-149), and the channels' largest difference
    over each channel's peak.  {cell: (below, subnormal, lost, holdable
    lost, nonzero, worst)}."""
    import radiativetransfer_tpu_torch as rt
    from radiativetransfer_tpu_torch.bench import bench_sources
    from radiativetransfer_tpu_torch.config import (
        MODE_BOTH_STELLAR_UVB_TRANSFER,
    )
    from radiativetransfer_tpu_torch.constants import KPC, MYR
    from radiativetransfer_tpu_torch.core import rays
    from radiativetransfer_tpu_torch.core.step import StellarContext
    from radiativetransfer_tpu_torch.io import grid_io
    from radiativetransfer_tpu_torch.tables import stellar
    f32, f64 = torch.float32, torch.float64
    kills = (rays.default_tau_kill(f32), rays.default_rel_kill(f32))
    channels = [f.name for f in dataclasses.fields(rays.RateFields)]
    tiny = torch.finfo(f32).tiny
    out = {}

    def bench_cell(dtype):
        geom = rt.GridGeometry(n, n, n, 2000.0 * KPC)
        ctx = StellarContext.build(
            stellar.blackbody_population(q_ionizing=1.0e51),
            bench_sources(n, MODE8_SOURCES), geom, 10.0 * MYR,
            metal_coefs=[(0, 0.0)], dtype=dtype, device=DEVICE)
        return geom, ctx

    state_b = rt.uniform_state(n, nh=2e-4, tgas=1.5e4, dtype=f32,
                               device=DEVICE)
    config = write_cli_inputs(os.path.join(tmp, "flush"), n)
    levels = grid_io.read_level_npz(os.path.join(tmp, "flush",
                                                 "testgrid_velmet.npz"))
    state_g, geom_g = grid_io.build_uniform_state(levels, True, dtype=f32,
                                                  device=DEVICE)
    cfg = rt.RunConfig(mode=MODE_BOTH_STELLAR_UVB_TRANSFER,
                       current_redshift=6.55, n_angular_level=MAIN_LEVEL,
                       reionization_model=10,
                       self_shielding_threshold_kpc=0.1)
    state_g = rt.RTModel.setup(cfg, geom_g, f32,
                               DEVICE).initialize_equilibrium(state_g)
    cells = {
        "bench_step": (state_b, lambda d: bench_cell(d)),
        "cli_galaxy": (state_g, lambda d: (geom_g, _cli_stellar(
            config, levels, state_g, geom_g, d, DEVICE))),
    }
    for name, (state, build) in cells.items():
        traces = {}
        for dtype in (f32, f64):
            geom, ctx = build(dtype)
            t0 = time.perf_counter()
            rf, _ = rays.trace_point_sources(
                state, geom, ctx.sources, ctx.tables,
                dust_approximation=ctx.dust_approximation,
                max_pixel_level=ctx.max_pixel_level, dtype=dtype,
                tau_kill=kills[0], rel_kill=kills[1])
            torch.cuda.synchronize()
            traces[dtype] = (torch.stack([getattr(rf, k) for k in channels]),
                             time.perf_counter() - t0)
        (a, s32), (b, s64) = traces[f32], traces[f64]
        below = int(((b != 0) & (b.abs() < tiny)).sum())
        sub = int(((a != 0) & (a.abs() < tiny)).sum())
        lost = (b != 0) & (a == 0)
        held = int((lost & (b.abs() >= 2.0 ** -149)).sum())
        lost = int(lost.sum())
        nonzero = int((b != 0).sum())
        worst = max(float((a[i].double() - b[i]).abs().max()
                          / b[i].abs().max())
                    for i in range(len(channels)) if bool(b[i].any()))
        out[name] = (below, sub, lost, held, nonzero, worst)
        print(f"[9 mode8] the uniform tracer's f32 deposits at {n}^3, "
              f"{name} ({ctx.sources.n_sources} sources, maxPixelLevel "
              f"{ctx.max_pixel_level}; f32 trace {s32:.3f} s, f64 "
              f"{s64:.3f} s, kills tau {kills[0]} rel {kills[1]}): {below} "
              f"of the f64 trace's {nonzero} nonzero deposits below "
              f"float32's smallest normal {tiny:.3e}, {sub} subnormal in "
              f"the f32 trace, {lost} nonzero in f64 and 0 in f32 ({held} of "
              f"them at least float32's smallest subnormal); channels' max "
              f"diff {worst:.2e} of each peak (tol 1e-5; of the lost, those "
              f"float32 can hold at most 1e-5 of the nonzero)")
        # before the deposits were scaled (rays._deposit_scale) the card
        # lost 2,936,556 and 3,262,259 of them here, nearly all holdable
        assert worst <= 1e-5 and held <= 1e-5 * nonzero, (name, worst, held)
    return out


def _cli_stellar(config: str, levels, state, geom, dtype, device,
                 noneq: bool = False, first: int | None = None,
                 max_pixel_level: int = 6):
    """The StellarContext cli.main builds for the point sources of
    `config` (write_cli_inputs' 12, the first `first` kept where given) on
    the grid `state` ingested from `levels` (profile_step.galaxy_sources:
    cli.read_stars, blackbodies -- the inputs carry no Starburst99 SEDs
    -- and StellarContext.build at 10 Myr, maxPixelLevel
    `max_pixel_level`; noneq: with the k27..k31 weights, as --chemistry
    noneq builds it)."""
    from radiativetransfer_tpu_torch import profile_step
    return profile_step.galaxy_sources(
        os.path.dirname(config), state, geom, noneq=noneq,
        max_pixel_level=max_pixel_level, dtype=dtype, device=device,
        first=first, levels=levels)


def phase_amr(smi: str) -> dict:
    """18: two-level AMR (core/step_amr.py::AMRModel, the CLI on a
    two-level grid) on the card, in modes 9, 8 and 1.  Its sweep and its
    tracer are plain PyTorch: the path launches none of the hand-written
    kernels (every count is held), but check (c), which holds it against
    the uniform step through the cluster kernel."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        return _phase_amr(tmp, smi)


def _phase_amr(tmp: str, smi: str) -> dict:
    """phase_amr's checks, with `tmp` a directory of their own."""
    import radiativetransfer_tpu_torch as rt
    from radiativetransfer_tpu_torch import profile_step
    from radiativetransfer_tpu_torch.config import (
        MODE_BOTH_STELLAR_UVB_TRANSFER,
        MODE_STELLAR_TRANSFER_THIN_UVB,
        MODE_UVB_TRANSFER_ONLY,
    )
    from radiativetransfer_tpu_torch.constants import KPC, MYR
    from radiativetransfer_tpu_torch.core import (
        amr,
        probes_cuda,
        rays,
        rays_amr,
        step_amr,
        sweep_cluster,
    )
    from radiativetransfer_tpu_torch.core.step import StellarContext
    from radiativetransfer_tpu_torch.io import grid_io, snapshot
    from radiativetransfer_tpu_torch.profile_step import galaxy_state
    from radiativetransfer_tpu_torch.tables import stellar
    t_phase = time.perf_counter()
    f32, f64 = torch.float32, torch.float64
    mode8, mode1 = MODE_BOTH_STELLAR_UVB_TRANSFER, MODE_STELLAR_TRANSFER_THIN_UVB
    out = {}

    def model(n, level, dtype, device, mode=MODE_UVB_TRANSFER_ONLY, **kw):
        cfg = rt.RunConfig(mode=mode, current_redshift=6.55,
                           n_angular_level=level, reionization_model=10,
                           self_shielding_threshold_kpc=0.1, **kw)
        return rt.RTModel.setup(cfg, rt.GridGeometry(n, n, n, 300.0 * KPC),
                                dtype, device)

    def timed(fn):
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, time.perf_counter() - t0

    def equilibrium(m, state):
        return amr.sync_restriction(dataclasses.replace(
            state, base=m.initialize_equilibrium(state.base),
            fine=m.initialize_equilibrium(state.fine)))

    def ingest(inputs, dtype, device):
        """((the two-level state, the levels read), seconds)."""
        path = os.path.join(inputs, "testgrid_velmet.npz")

        def read():
            levels = grid_io.read_level_npz(path)
            return amr.amr_from_levels(levels, True, dtype,
                                       device=device)[0], levels
        return timed(read)

    def worst(a, b, names):
        """The largest |a - b| over each field's peak in b, field by field
        of two FieldStates or RateFields, b's on its own device."""
        return max(float((getattr(a, k).to(getattr(b, k)) - getattr(b, k))
                         .abs().max() / getattr(b, k).abs().max())
                   for k in names)

    counts0 = _kernel_counts()
    inputs16, inputs32, inputs = (os.path.join(tmp, f"inputs{k}")
                                  for k in (16, 32, 128))
    species = ("HI", "HeI", "HeII")
    channels = [f.name for f in dataclasses.fields(rays.RateFields)]
    diag_names = [f.name for f in dataclasses.fields(rays.RayDiagnostics)]

    # (a) 16^3 with its refined centre, level 2, f64 (at 24^3 the CPU's
    # steps took 19 s): one mode-9 step and one mode-8 step with 3 sources
    # (maxPixelLevel 4: at 6 the CPU's trace takes ~100 s) on the card
    # against the same steps on the CPU, from the CPU's equilibrium
    n_a = 16
    cpu = model(n_a, 2, f64, "cpu")
    write_cli_inputs(inputs16, n_a, refine_center=True)
    arrays = equilibrium(cpu, ingest(inputs16, f64, "cpu")[0][0]).to_numpy()
    # inside the refined centre, in the coarse cell beside it, far out
    src_a = rays.SourceBatch(
        position=np.array([[8.25, 7.75, 8.5], [3.5, 8.5, 8.5],
                           [2.5, 13.5, 3.5]]) / n_a,
        weight=np.ones(3), table_idx=np.zeros(3, np.int32))
    runs, runs8 = {}, {}
    threads = torch.get_num_threads()
    for device in ("cpu", DEVICE):
        am = step_amr.AMRModel.setup(
            cpu if device == "cpu" else model(n_a, 2, f64, DEVICE))
        st = amr.AMRState.from_numpy(arrays, dtype=f64, device=device)
        # the eager CPU steps' small ops run fastest on one thread
        torch.set_num_threads(1 if device == "cpu" else threads)
        st1, dt = timed(lambda: am.make_step()(st))
        runs[device] = (st1, dt, am.neutral_fraction(st1))
        am8 = step_amr.AMRModel.setup(model(n_a, 2, f64, device,
                                            mode=mode8))
        ctx = StellarContext.build(
            stellar.blackbody_population(q_ionizing=1.0e51), src_a,
            am8.rt.geom, 10.0 * MYR, metal_coefs=[(0, 0.0)],
            max_pixel_level=4, dtype=f64, device=device)
        (st8, diag8), dt8 = timed(lambda: am8.make_step(ctx)(st))
        runs8[device] = (st8, diag8, dt8, am8.neutral_fraction(st8))
    torch.set_num_threads(threads)
    card, host = runs[DEVICE][0], runs["cpu"][0]
    err9 = max(worst(getattr(card, lv), getattr(host, lv), species)
               for lv in ("base", "fine"))
    (c8, cd8, dt8_card, nf8_card), (h8, hd8, dt8_cpu, nf8_cpu) = (
        runs8[DEVICE], runs8["cpu"])
    err8 = max(worst(getattr(c8, lv), getattr(h8, lv), species)
               for lv in ("base", "fine"))
    err8_diag = worst(cd8, hd8, diag_names)
    print(f"[18 amr] {n_a}^3 + {int(host.refined.sum())} refined "
          f"parents, level 2, f64 mode 9, one step: card "
          f"{runs[DEVICE][1]:.3f}"
          f" s, CPU {runs['cpu'][1]:.3f} s; neutral fraction "
          f"{runs[DEVICE][2]:.10f} (CPU {runs['cpu'][2]:.10f}); species max "
          f"diff {err9:.2e} of each peak (tol 1e-9); mode 8, 3 sources, "
          f"maxPixelLevel 4, one step: card {dt8_card:.3f} s, CPU {dt8_cpu:.3f} s, neutral "
          f"fraction {nf8_card:.10f} (CPU {nf8_cpu:.10f}), species max diff "
          f"{err8:.2e}, ray diagnostics {err8_diag:.2e} of each peak (tol "
          f"1e-9)")
    assert err9 <= 1e-9 and err8 <= 1e-9 and err8_diag <= 1e-9, (
        err9, err8, err8_diag)
    assert float(h8.fine.krate24.abs().max()) > 0.0
    assert _kernel_counts() == counts0, "the two-level step launched a kernel"
    del runs, runs8, arrays, cpu, card, host, c8, h8, cd8, hd8

    # (b) the full-width cell, f32: make_test_data's galaxy at 128^3 with
    # its refined centre and its 12 sources, 192 directions; one mode-1
    # step layer by layer (the tracer and both chemistries; the two-level
    # sweep, ~29 s of a mode-8 step here, is traced by zone below and
    # counted at 32^3 in (e)), the trace against float64's
    n, level = MAIN_N, MAIN_LEVEL
    config, write_s = timed(lambda: write_cli_inputs(inputs, n,
                                                     refine_center=True))
    (state, levels), ingest_s = ingest(inputs, f32, DEVICE)
    m = model(n, level, f32, DEVICE, mode=mode8)
    am, plan_s = timed(lambda: step_amr.AMRModel.setup(m))
    state, eq_s = timed(lambda: equilibrium(m, state))
    ctx, src_s = timed(lambda: _cli_stellar(
        config, levels, state, m.geom, f32, DEVICE))
    n_ref = int(state.refined.sum())
    nf0 = am.neutral_fraction(state)
    print(f"[18 amr] {n}^3 + {n_ref} refined parents ({8 * n_ref} fine "
          f"leaves in a dense {2 * n}^3 level): inputs written in "
          f"{write_s:.3f} s, ingested (read_level_npz + amr_from_levels onto "
          f"the card) in {ingest_s:.3f} s, plan setup "
          f"(build_amr_sweep_plan) {plan_s:.3f} s, equilibrium of both "
          f"levels {eq_s:.3f} s, the {ctx.sources.n_sources} sources "
          f"prepared as the CLI does (StellarContext.build) {src_s:.3f} s "
          f"(host); neutral fraction {nf0:.7f}")
    am1 = step_amr.AMRModel.setup(model(n, level, f32, DEVICE, mode=mode1))
    assert am1.plan is None
    torch.cuda.reset_peak_memory_stats()
    (state1, rows, march), step_s = timed(lambda: profile_step.amr_layers(
        am1, state, count=(), stellar=ctx))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    nf1 = am1.neutral_fraction(state1)
    print(f"[18 amr] {n}^3 f32 two-level mode-1 step (the tracer, both "
          f"levels' chemistry, no sweep), {ctx.sources.n_sources} sources: "
          f"{step_s:.3f} s, layers (device ms by CUDA events / host ms to "
          "enqueue): " + ", ".join(
              f"{k} {ms:.3f} / {host:.3f}" for k, (ms, host, _) in
              rows.items())
          + f"; the tracer {march} march steps "
          f"({rows['tracer'][0] / march:.3f} ms a step); neutral fraction "
          f"{nf0:.7f} -> {nf1:.7f}; peak device memory {peak:.3f} GiB; "
          f"{smi}")
    assert np.isfinite(nf1) and 0.0 < nf1 < nf0, (nf0, nf1)
    assert all(bool(torch.isfinite(getattr(s, k)).all())
               for s in (state1.base, state1.fine)
               for k in ("HI", "HeI", "HeII", "krate24"))
    del state1, am1
    # the tracer alone in a profiler window: its launches and the card's
    # busy share of its wall time
    tr_wall, tr_busy, tr_events, _ = profile_step.profiled(
        lambda s: am.trace(s, ctx)[0], [state], steps=1)
    print(f"[18 amr] the {n}^3 tracer in a profiler window: wall "
          f"{tr_wall * 1e3:.3f} ms, device busy {tr_busy * 1e3:.3f} ms "
          f"({100 * tr_busy / tr_wall:.1f}%), {tr_events:.0f} device "
          f"events ({tr_events / march:.1f} a march step)")
    # one zone's first 32 and 16 base slabs at the full plane width, each
    # in profiler windows of their own (a window of the whole zone, 60,333
    # launches, takes seconds to read)
    zone_wall, zone_busy, zone_32 = profile_step.amr_zone_window(
        am, state, slabs=32)
    zone_16 = profile_step.amr_zone_launches(am, state, slabs=16)
    zones = len(am.plan.zones)
    # the sweep's compulsory bytes: both levels' opacities and the refined
    # map read once, both levels' Jmean written once
    floor_mb = (2 * 3 * 4 * (n ** 3 + (2 * n) ** 3) + n ** 3) / 1e6
    print(f"[18 amr] one zone's sweep at {n}^3 width "
          f"({am.plan.zones[0].ndir} directions), its first 32 base slabs: "
          f"wall {zone_wall * 1e3:.3f} ms, device busy "
          f"{zone_busy * 1e3:.3f} ms ({100 * zone_busy / zone_wall:.2f}%), "
          f"{zone_32} launches; 16 slabs {zone_16} launches (two windows); "
          f"{zones} zones x {n} slabs: ~{zones * n / 32 * zone_busy:.2f} s "
          f"of the card's time against the sweep's bytes floor of "
          f"{floor_mb:.1f} MB, "
          f"{1e9 * floor_mb / probes_cuda.HBM_BYTES_PER_S:.4f} ms at "
          f"{probes_cuda.HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    # the float32 trace against float64's of the same state with the same
    # (float32's) kills, within 5e-5 of each channel's peak: float32's
    # positions in box units leave a fine segment's length ~1.5e-5 off
    # (an ulp of 0.5 over 1/256), and the base cell at the peak of krate24,
    # beside the refined block, is 1.8e-5 apart (kills, tables in float64,
    # a float64 sum and float64's relocalization tolerance in float32 all
    # leave that, PERF.md section 6); the fine deposits below float32's
    # smallest normal value, which the rays_amr scale keeps from the card's
    # flush
    kills = (rays.default_tau_kill(f32), rays.default_rel_kill(f32))
    ctx64 = _cli_stellar(config, levels, state, m.geom, f64, DEVICE)
    (t32, t64), trace_s = zip(*(timed(lambda c=c, d=d: (
        rays_amr.trace_point_sources_amr(
            state, m.geom, c.sources, c.tables,
            dust_approximation=c.dust_approximation,
            max_pixel_level=c.max_pixel_level, dtype=d, tau_kill=kills[0],
            rel_kill=kills[1]))) for c, d in ((ctx, f32), (ctx64, f64))))
    err_levels = [worst(a, b, channels)
                  for a, b in ((t32[0], t64[0]), (t32[1], t64[1]))]
    fesc32, fesc64 = (rays.escape_fractions(t[2], ctx.sources.weight)
                      for t in (t32, t64))
    fesc_err = float(np.abs(fesc32 - fesc64).max())
    tiny = torch.finfo(f32).tiny
    fine64 = torch.stack([getattr(t64[1], k) for k in channels])
    fine32 = torch.stack([getattr(t32[1], k) for k in channels])
    sub64 = int(((fine64 != 0) & (fine64.abs() < tiny)).sum())
    sub32 = int(((fine32 != 0) & (fine32.abs() < tiny)).sum())
    lost = int(((fine64 != 0) & (fine32 == 0)).sum())
    print(f"[18 amr] the {n}^3 f32 trace ({trace_s[0]:.3f} s) against the "
          f"f64 trace ({trace_s[1]:.3f} s), both with tau_kill {kills[0]} "
          f"and rel_kill {kills[1]}: base channels max diff "
          f"{err_levels[0]:.2e}, fine {err_levels[1]:.2e} of each "
          f"channel's peak (tol 5e-5), escape fractions {fesc_err:.2e} "
          f"(tol 1e-5); "
          f"fine deposits below float32's smallest normal {tiny:.3e}: "
          f"{sub64} in the f64 trace, {sub32} subnormal in the f32 trace, "
          f"{lost} of the f64 trace's nonzero ones 0 in f32, of "
          f"{int((fine64 != 0).sum())} nonzero")
    assert max(err_levels) <= 5e-5 and fesc_err <= 1e-5, (err_levels,
                                                            fesc_err)
    assert _kernel_counts() == counts0, "the two-level step launched a kernel"
    out.update(mode1_s=step_s, layers=rows, march=march, peak_gib=peak,
               tracer_busy_share=tr_busy / tr_wall,
               plan_s=plan_s, ingest_s=ingest_s,
               zone_busy_share=zone_busy / zone_wall, nf=(nf0, nf1),
               trace_err=(*err_levels, fesc_err),
               subnormal=(sub64, sub32, lost))
    del state, am, m, ctx, ctx64, t32, t64, fine32, fine64, levels

    # (c) 64^3, nothing refined: the plain two-level step against the
    # uniform step through the cluster kernel (#1) in the exact logmean
    # form, the form of the two-level sweep (the clamped form, f32's
    # default, is 1.6e-4 of the peak apart there)
    m = model(64, level, f32, DEVICE, sweep_logmean="exact")
    am = step_amr.AMRModel.setup(m)
    base = m.initialize_equilibrium(galaxy_state(64, 300.0, DEVICE))
    _zero_sweep_launches()
    uni = m.make_step()(base)
    two = am.make_step()(amr.make_amr_state(
        base, torch.zeros((64,) * 3, dtype=torch.bool, device=DEVICE)))
    torch.cuda.synchronize()
    j_err = max(float((two.base.Jmean[b] - uni.Jmean[b]).abs().max()
                      / uni.Jmean[b].abs().max()) for b in range(3))
    nf_u, nf_t = m.neutral_fraction(uni), am.neutral_fraction(two)
    nf_rel = abs(nf_t - nf_u) / nf_u
    print(f"[18 amr] 64^3 x 192 f32, nothing refined: two-level step base "
          f"Jmean max diff {j_err:.2e} of each band's peak, neutral fraction "
          f"{nf_t:.7f} against {nf_u:.7f} (rel {nf_rel:.2e}), both tol 1e-4, "
          f"from the uniform step through the cluster kernel "
          f"({sweep_cluster.LAUNCHES} launch)")
    assert j_err <= 1e-4 and nf_rel <= 1e-4, (j_err, nf_rel)
    assert _sweep_launches() == (1, 0)
    out["uniform_check_launches"] = sweep_cluster.LAUNCHES
    del uni, two, base, am, m
    counts0 = _kernel_counts()

    # (d) the CLI on a two-level grid: mode 9, 2 iterations, a restart of
    # one through python -m from the itime-1 snapshot; mode 8 with the 12
    # sources, 1 iteration; --chemistry noneq on it: phase 20 (d).  The
    # grid is 32^3 with its central half refined, 192 directions: the
    # branch, the snapshot and the restart are the same at any width, (b)
    # times the full width, and the two-level sweep's iterations are
    # launch-bound (~6 s each at 32^3, ~25 s at 128^3)
    n_cli = out["cli_n"] = ML_CLI_N
    config32 = write_cli_inputs(inputs32, n_cli, refine_center=True)
    d9 = os.path.join(tmp, "amr9")
    out9, call9 = _cli(config32, d9, "--iters", "2", tag="18 amr")
    log9 = _time_log(d9)
    dts = _iteration_dts(out9, n_cli ** 3 * 192)
    assert (f"grid: {n_cli}^3 + refined level ({(n_cli // 2) ** 3} "
            f"parents)") in out9, out9
    assert list(log9) == [1, 2] and all(
        0.0 < v < 1.0 for v in log9.values()), log9
    assert all(os.path.exists(snapshot.snapshot_name(i, d9))
               for i in (1, 2))
    print(f"[18 amr] CLI mode 9 on the two-level {n_cli}^3 grid: call "
          f"{call9:.3f} s, iterations' dt {_fmt(dts)} s, neutral "
          f"fractions {list(log9.values())}")
    dr = os.path.join(tmp, "restart")
    os.makedirs(dr)
    shutil.copy(snapshot.snapshot_name(1, d9), dr)
    restart = _config_variant(config32, os.path.join(tmp, "restart.cfg"),
                              restart=1)
    # in a process of its own while this one runs mode 8 (joined before
    # (e)'s profiler windows)
    restarted = _CliProcess([restart, "--snapshot-dir", dr, "--iters", "1"])
    d8 = os.path.join(tmp, "amr8")
    config8 = _config_variant(config32, os.path.join(tmp, "mode8.cfg"),
                              mode=8)
    out8, call8 = _cli(config8, d8, "--iters", "1", tag="18 amr")
    log8 = _time_log(d8)
    dts8 = _iteration_dts(out8, n_cli ** 3 * 192)
    fesc8 = [float(x) for line in re.findall(r"fesc=(\S+)", out8)
             for x in line.split("/")]
    nf8_0 = float(re.search(r"ionization equilibrium: (\S+)",
                            out8).group(1))
    with open(os.path.join(d8, "weight")) as fh:
        n_weight = len(fh.read().splitlines())
    with np.load(os.path.join(d8, "cosmicSpectrum.npz")) as fh:
        spec = fh["spectrum"]
    print(f"[18 amr] CLI mode 8 on the two-level {n_cli}^3 grid, "
          f"{n_weight} sources: call {call8:.3f} s, iterations' dt "
          f"{_fmt(dts8)} s, neutral fraction {nf8_0:.8f} -> "
          f"{list(log8.values())}, fesc {_fmt(fesc8)}, cosmicSpectrum.npz "
          f"peak {float(spec.max()):.4e}")
    assert list(log8) == [1] and all(v < nf8_0 for v in log8.values())
    assert n_weight == 12 and len(fesc8) == 7
    assert all(0.0 <= f <= 1.0 for f in fesc8), fesc8
    rc, stdout, stderr, restart_s = restarted.result()
    for line in stdout.splitlines():
        print(f"[18 amr]   {line}")
    assert rc == 0, stderr[-4000:]
    assert (f"restarted from {snapshot.snapshot_name(1, dr)} at itime=1"
            in stdout), stdout
    nf_sub = _time_log(dr)[2]
    rel = abs(nf_sub - log9[2]) / log9[2]
    print(f"[18 amr] restart: python -m ...cli {restart_s:.3f} s (beside "
          f"mode 8), itime 2 neutral fraction {nf_sub:.8f} against "
          f"{log9[2]:.8f} in this process (rel {rel:.2e}, tol 1e-4)")
    assert rel <= 1e-4, (nf_sub, log9[2])
    assert np.isfinite(spec).all() and float(spec.max()) > 0.0
    assert _kernel_counts() == counts0, "the two-level CLI launched a kernel"
    out.update(cli_dts=dts, cli_call_s=call9, restart_s=restart_s,
               cli_dts8=dts8, cli_call8_s=call8)

    # (e) launches per layer at 32^3, level 3, mode 8 with amr_sources' 8
    # sources, each from two profiler windows that must agree
    # (profile_step.amr_layers), the sweep's zone by zone: a zone's
    # launches do not depend on the plane's width (the 32^3 zone's two
    # windows against (b)'s first 32 slabs at 128^3), and (b)'s 16 and 32
    # slabs give its launches per base slab and per zone, so the zones'
    # count at 128^3 but for the wrapper's rotations and sums (the whole
    # 32^3 sweep traced twice takes minutes: profile_step 32 3 8 0 0 1
    # does it)
    m = model(32, level, f32, DEVICE, mode=mode8)
    am = step_amr.AMRModel.setup(m)
    st = profile_step.amr_galaxy(m, device=DEVICE)
    counted = tuple(k for k in profile_step.AMR_LAYERS if k != "sweep")
    st, rows32, march32 = profile_step.amr_layers(
        am, st, count=counted,
        stellar=profile_step.amr_sources(m.geom, device=DEVICE))
    zone32 = profile_step.amr_zone_launches(am, st)
    per_slab, rest = divmod(zone_32 - zone_16, 16)
    setup = zone_16 - 16 * per_slab
    # torch.stack of more than 128 slab planes takes a launch per 128: the
    # 256 fine planes of a 128^3 zone one more than 128 or fewer
    stacks = sum(-(-k // 128) for k in (n, 2 * n)) - 2
    zone128 = setup + n * per_slab + stacks
    tracer32 = rows32["tracer"][2]
    print(f"[18 amr] 32^3 level {level} mode 8 launches per layer (two "
          f"agreeing traces): " + ", ".join(
              f"{k} {v[2]}" for k, v in rows32.items() if k != "sweep")
          + f"; the tracer's {march32} march steps, "
          f"{tracer32 / march32:.1f} launches a step; one zone's sweep "
          f"{zone32} (two agreeing traces), its first 32 slabs at {n}^3 "
          f"width {zone_32}: {per_slab} per base slab (remainder {rest}) "
          f"and {setup} per zone; derived from these, not traced: a whole "
          f"zone at {n}^3 {zone128} ({stacks} for its stacks), the sweep "
          f"{zones} zones x {zone128} = {zones * zone128} launches and its "
          f"wrapper's")
    assert zone32 == zone_32, (zone32, zone_32)
    assert rest == 0 and per_slab > 0, (zone_16, zone_32)
    assert march32 > 0 and tracer32 > march32
    assert _kernel_counts() == counts0, "the two-level step launched a kernel"
    phase_s = time.perf_counter() - t_phase
    print(f"[18 amr] phase 18: {phase_s:.1f} s; {smi}")
    windows = _print_windows("18 amr", "phases 17 and 18")
    out.update(launches32=rows32, march32=march32, per_slab=per_slab,
               zone128=zone128, phase_s=phase_s, windows=windows)
    return out


def _print_windows(tag: str, phases: str) -> int:
    """Prints the markers, clocks and tails of the run's profiler windows
    so far (profile_step.WINDOWS); returns how many were kept (a first
    take that lost its markers is followed by its retake, and not kept)."""
    from radiativetransfer_tpu_torch import profile_step
    rows = profile_step.WINDOWS
    retaken = {i for i in range(len(rows) - 1) if rows[i + 1][-1] == 1}
    lost = [w for i, w in enumerate(rows) if i in retaken]
    kept = [w for i, w in enumerate(rows) if i not in retaken]
    tails = [w[7] for w in kept]
    lags = [w[3] for w in rows]
    print(f"[{tag}] the run's {len(kept)} profiler windows ({phases}), each "
          f"after a warm-up step of {profile_step._WARMUP_MARKERS} spin "
          f"kernels (twice that in a retake) and with {min(tails):.3f} to "
          f"{max(tails):.3f} s of host idle before it closed: at least "
          f"{min(w[1] for w in kept)} of {profile_step._MARKERS} opening "
          f"and {min(w[2] for w in kept)} of {profile_step._MARKERS} "
          f"closing markers recorded in each; "
          f"{len(lost)} taken again, the lost takes' markers (opening, "
          f"closing) {[(w[1], w[2]) for w in lost]}; the least "
          f"launch-to-kernel delay of a window {min(lags):.1f} to "
          f"{max(lags):.1f} us (a negative one: the card's clock read early "
          f"against the host's)")
    return len(kept)


def phase_ml(smi: str) -> dict:
    """19: L-level dense AMR (core/step_amr.py::MultiLevelModel, the CLI's
    multilevel branch) on the card, in modes 9 and 6.  Its sweep
    (core/sweep_multilevel.py) is plain PyTorch: the path launches none of
    the hand-written kernels (every count is held), but check (c), which
    holds the one-level sweep against the uniform step through the
    cluster kernel."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        return _phase_ml(tmp, smi)


def _phase_ml(tmp: str, smi: str) -> dict:
    """phase_ml's checks, with `tmp` a directory of their own."""
    import radiativetransfer_tpu_torch as rt
    from radiativetransfer_tpu_torch import cli, profile_step
    from radiativetransfer_tpu_torch.config import (
        MODE_NO_STARS_THIN_UVB,
        MODE_UVB_TRANSFER_ONLY,
    )
    from radiativetransfer_tpu_torch.constants import KPC
    from radiativetransfer_tpu_torch.core import (
        amr,
        opacity,
        step_amr,
        sweep_amr,
        sweep_cluster,
        sweep_multilevel,
    )
    from radiativetransfer_tpu_torch.io import grid_io, snapshot
    from radiativetransfer_tpu_torch.profile_step import galaxy_state
    t_phase = time.perf_counter()
    f32, f64 = torch.float32, torch.float64
    out = {}

    def model(n, level, dtype, device, mode=MODE_UVB_TRANSFER_ONLY, **kw):
        cfg = rt.RunConfig(mode=mode, current_redshift=6.55,
                           n_angular_level=level, reionization_model=10,
                           self_shielding_threshold_kpc=0.1, **kw)
        return rt.RTModel.setup(cfg, rt.GridGeometry(n, n, n, 300.0 * KPC),
                                dtype, device)

    def timed(fn):
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, time.perf_counter() - t0

    def equilibrium(m, state):
        return amr.sync_restriction_multi(amr.MultiLevelState(
            levels=tuple(m.initialize_equilibrium(lv)
                         for lv in state.levels), refined=state.refined))

    def ingest(n, dtype, device, max_depth=4):
        """((the L-level state of write_cli_inputs' galaxy at n^3 with its
        refined centre and core, the levels read), seconds)."""
        directory = os.path.join(tmp, f"inputs{n}")
        if not os.path.exists(directory):
            write_cli_inputs(directory, n, refine_center=True,
                             refine_core=True)
        path = os.path.join(directory, "testgrid_velmet.npz")

        def read():
            levels = grid_io.read_level_npz(path)
            return amr.multilevel_from_levels(
                levels, True, dtype, device=device,
                max_depth=max_depth)[0], levels
        return timed(read)

    def worst(a, b, names):
        """The largest |a - b| over each field's peak in b, field by field
        and level by level of two MultiLevelStates, b's on its device."""
        return max(float((getattr(x, k).to(getattr(y, k)) - getattr(y, k))
                         .abs().max() / getattr(y, k).abs().max())
                   for x, y in zip(a.levels, b.levels) for k in names)

    counts0 = _kernel_counts()
    species = ("HI", "HeI", "HeII")

    # (a) 16^3 with its refined centre and core (3 levels; at 24^3 the
    # CPU's step took 7-14 s), angular level 1, f64: one mode-9 step on the
    # card against the same step on the CPU, from the CPU's equilibrium,
    # each level within 1e-10 of its peak
    n_a = 16
    cpu = model(n_a, 1, f64, "cpu")
    arrays = equilibrium(cpu, ingest(n_a, f64, "cpu")[0][0]).to_numpy()
    runs = {}
    for device in ("cpu", DEVICE):
        ml = step_amr.MultiLevelModel.setup(
            cpu if device == "cpu" else model(n_a, 1, f64, DEVICE), 3)
        st = amr.MultiLevelState.from_numpy(arrays, dtype=f64, device=device)
        st1, dt = timed(lambda: ml.make_step()(st))
        runs[device] = (st1, dt, ml.neutral_fraction(st1))
    card, host = runs[DEVICE][0], runs["cpu"][0]
    err_a = worst(card, host, species + ("Jmean",))
    parents = [int(r.sum()) for r in host.refined]
    print(f"[19 ml] {n_a}^3 + refined parents per level {parents}, 3 "
          f"levels, "
          f"level 1, f64 mode 9, one step at the default coupling depth "
          f"{step_amr.MultiLevelModel.n_coupling_iters}: card "
          f"{runs[DEVICE][1]:.3f} s, CPU {runs['cpu'][1]:.3f} s; neutral "
          f"fraction {runs[DEVICE][2]:.10f} (CPU {runs['cpu'][2]:.10f}); "
          f"species and Jmean max diff {err_a:.2e} of each level's peak "
          f"(tol 1e-10)")
    assert err_a <= 1e-10, err_a
    assert _kernel_counts() == counts0, "the L-level step launched a kernel"
    out["card_vs_cpu"] = err_a
    del runs, arrays, cpu, card, host

    # (b) the full-width cell, f32: make_test_data's galaxy at 64^3 with its
    # refined centre and core (a dense 128^3 and a dense 256^3 level), 192
    # directions: ingestion, plan setup, the coupling depth validated on
    # the ingested grid, then one mode-9 step layer by layer, the first
    # zone batch's first 8 base slabs traced (launches, the card's busy
    # share), write_snapshot_ml; modes 6 the same
    n, level = ML_N, MAIN_LEVEL
    (state, levels), ingest_s = ingest(n, f32, DEVICE)
    footprint = cli._dense_bytes(levels, 3, False)
    m = model(n, level, f32, DEVICE)
    ml, plan_s = timed(lambda: step_amr.MultiLevelModel.setup(m, 3))
    depth, depth_s = timed(lambda: ml.validate_coupling_depth(state))
    state, eq_s = timed(lambda: equilibrium(m, state))
    parents = [int(r.sum()) for r in state.refined]
    nf0 = ml.neutral_fraction(state)
    print(f"[19 ml] {n}^3 + refined parents per level {parents} (dense "
          f"{2 * n}^3 and {4 * n}^3 levels, {state.n_leaves()} leaves; the "
          f"CLI's dense footprint {footprint / 1e9:.3f} GB, under its 4e9 "
          f"bytes: --amr-storage auto keeps it dense): ingested "
          f"(read_level_npz + multilevel_from_levels onto the card) in "
          f"{ingest_s:.3f} s, plan setup (build_ml_sweep_plan) {plan_s:.3f} "
          f"s, validate_coupling_depth {depth_s:.3f} s: depth {depth}, "
          f"equilibrium of the 3 levels {eq_s:.3f} s; neutral fraction "
          f"{nf0:.7f}")
    assert footprint <= 4.0e9
    torch.cuda.reset_peak_memory_stats()
    (state1, rows, _), step_s = timed(lambda: profile_step.ml_layers(
        ml, state))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    nf1 = ml.neutral_fraction(state1)
    print(f"[19 ml] {n}^3 + 2 levels x 192 f32 mode-9 step, coupling depth "
          f"{depth}, from the equilibrium (no warm-up step: one took the "
          f"step's own time): {step_s:.3f} s, "
          "layers (device ms by CUDA events / host ms to enqueue): "
          + ", ".join(f"{k} {ms:.3f} / {h:.3f}" for k, (ms, h, _) in
                      rows.items())
          + f"; neutral fraction {nf0:.7f} -> {nf1:.7f}; peak device memory "
          f"{peak:.3f} GiB; {smi}")
    assert np.isfinite(nf1) and 0.0 < nf1 < nf0, (nf0, nf1)
    assert all(bool(torch.isfinite(getattr(lv, k)).all())
               for lv in state1.levels for k in species + ("Jmean",))
    wall, busy, win_launches, zones = profile_step.ml_batch_window(
        ml, state1, 8)
    # the zones each batch of the full width's sweep carries, and each
    # direction-count group's size: (b)'s launch count below is derived on
    # one batch a group
    batches = [len(b) for b in sweep_multilevel.zone_batches(
        ml.plan, (n, n, n), f32, DEVICE)]
    groups = list(collections.Counter(z.ndir for z in ml.plan.zones)
                  .values())
    print(f"[19 ml] the first zone batch's sweep ({zones} zones of "
          f"{ml.plan.zones[0].ndir} directions) over its first 8 base slabs "
          f"at full width: wall {wall * 1e3:.3f} ms, device busy "
          f"{busy * 1e3:.3f} ms ({100 * busy / wall:.1f}%), {win_launches} "
          f"launches; the sweep's batches at {n}^3 {batches} (zones each; "
          f"the direction-count groups {groups})")
    path = os.path.join(tmp, "cellArray0001.npz")
    _, snap_s = timed(lambda: snapshot.write_snapshot_ml(
        path, state1, 1, m.geom.physical_box_size))
    print(f"[19 ml] write_snapshot_ml at {n}^3 + 2 levels "
          f"({state1.n_leaves()} leaves): {snap_s:.3f} s (host; "
          f"{os.path.getsize(path) / 1e6:.1f} MB compressed)")
    ml6 = step_amr.MultiLevelModel.setup(
        model(n, level, f32, DEVICE, mode=MODE_NO_STARS_THIN_UVB), 3)
    assert ml6.plan is None
    step6 = ml6.make_step()
    s6, warm6_s = timed(lambda: step6(state))
    (s6, rows6, _), step6_s = timed(lambda: profile_step.ml_layers(ml6,
                                                                     s6))
    nf6 = ml6.neutral_fraction(s6)
    print(f"[19 ml] {n}^3 + 2 levels f32 mode-6 step (the thin UVB, no "
          f"sweep): warm-up {warm6_s:.3f} s, the step {step6_s:.3f} s, "
          "layers (device ms / host ms): " + ", ".join(
              f"{k} {ms:.3f} / {h:.3f}" for k, (ms, h, _) in rows6.items())
          + f"; neutral fraction {nf6:.7f}")
    assert np.isfinite(nf6) and 0.0 < nf6 < 1.0
    assert _kernel_counts() == counts0, "the L-level step launched a kernel"
    # the sweep's launches, each from two profiler windows that must agree
    # (profile_step._layer), at 4^3 and 8^3 bases at the full width's
    # depth: a sweep's launches grow by a fixed count a base slab, whence
    # the full width's (derived, not traced: a 64^3 sweep's ~3e5 launches
    # take minutes to trace twice)
    counted = {}
    for k in (4, 8):
        (st, _), _ = ingest(k, f32, DEVICE)
        mk = step_amr.MultiLevelModel.setup(model(k, level, f32, DEVICE), 3)
        mk.n_coupling_iters = depth
        _, rows_k, _ = profile_step.ml_layers(
            mk, equilibrium(mk.rt, st), count=("sweep",))
        counted[k] = rows_k["sweep"][2]
    per_slab, rest = divmod(counted[8] - counted[4], 4)
    # the small bases' batches hold their whole groups; the derivation
    # holds where the full width's do too (a group cut into b batches
    # issues its per-slab launches b times)
    assert batches == groups, (batches, groups)
    launches64 = counted[8] + (n - 8) * per_slab
    print(f"[19 ml] the L-level sweep's launches at depth {depth}, 192 "
          f"directions: {counted[4]} at a 4^3 base, {counted[8]} at 8^3 "
          f"(two agreeing traces each): {per_slab} a base slab (remainder "
          f"{rest}); derived, not traced: {launches64} at {n}^3 (the "
          f"two-level sweep's per-zone loop issues 471 a base slab per zone, "
          f"x24 zones); the step's sweep {rows['sweep'][0]:.3f} ms of the "
          f"card's time for {rows['sweep'][1]:.3f} ms of host enqueue")
    assert rest == 0 and per_slab > 0, counted
    assert _kernel_counts() == counts0, "the L-level step launched a kernel"
    out.update(step_s=step_s, layers=rows, peak_gib=peak, depth=depth,
               depth_s=depth_s, plan_s=plan_s, ingest_s=ingest_s,
               batch_busy_share=busy / wall, launches=counted,
               launches64=launches64, write_snapshot_s=snap_s,
               mode6_s=step6_s, nf=(nf0, nf1))
    # phase 21 (c) holds the block-sparse step to this dense one
    out["dense_cell"] = (ml, state, state1)
    del s6, ml6, m

    # (c) nesting limits on the card, f32: nothing refined (one level)
    # against the uniform step's sweep through the cluster kernel (#1) in
    # the exact logmean form; the galaxy at 16^3 cut to two levels against
    # the two-level sweep (host-bound: at 32^3 the two took 13 s), both
    # within 1e-5 of each peak
    m = model(n, level, f32, DEVICE, sweep_logmean="exact")
    base = m.initialize_equilibrium(galaxy_state(n, 300.0, DEVICE))
    kappa = opacity.compute_opacities(base.HI, base.HeI, base.HeII,
                                      m.opacity_coef)
    _zero_sweep_launches()
    j_uni = m._run_sweep(kappa, None)
    torch.cuda.synchronize()
    uniform_launches = _sweep_launches()
    plan1 = sweep_multilevel.build_ml_sweep_plan(level, n, 1)
    (j_one,), one_s = timed(lambda: sweep_multilevel.diffuse_sweep_multilevel(
        [kappa], [], plan1, m.uvb, m.geom.cell_size))
    err_one = max(float((j_one[b] - j_uni[b]).abs().max()
                        / j_uni[b].abs().max()) for b in range(3))
    print(f"[19 ml] {n}^3 x 192 f32, one level: the L-level sweep "
          f"({one_s:.3f} s) against the uniform step's through the cluster "
          f"kernel ({uniform_launches[0]} launch): Jmean max diff "
          f"{err_one:.2e} of each band's peak (tol 1e-5)")
    assert err_one <= 1e-5, err_one
    assert uniform_launches == (1, 0), uniform_launches
    out["uniform_check_launches"] = sweep_cluster.LAUNCHES
    n2 = 16
    m = model(n2, level, f32, DEVICE, sweep_logmean="exact")
    two, _ = ingest(n2, f32, DEVICE, max_depth=2)[0]
    kc, kf = (opacity.compute_opacities(lv.HI, lv.HeI, lv.HeII,
                                        m.opacity_coef) for lv in two.levels)
    plan2 = sweep_multilevel.build_ml_sweep_plan(level, n2, 2)
    js2, two_s = timed(lambda: sweep_multilevel.diffuse_sweep_multilevel(
        [kc, kf], list(two.refined), plan2, m.uvb, m.geom.cell_size))
    (jc, jf), amr_s = timed(lambda: sweep_amr.diffuse_sweep_amr(
        kc, kf, two.refined[0], sweep_amr.build_amr_sweep_plan(level, n2),
        m.uvb, m.geom.cell_size))
    leaf = two.leaf_masks()
    err_two = max(float((a[b][mk] - r[b][mk]).abs().max()
                        / r[b][mk].abs().max())
                  for a, r, mk in ((js2[0], jc, leaf[0]),
                                   (js2[1], jf, leaf[1])) for b in range(3))
    print(f"[19 ml] {n2}^3 cut to two levels ({int(two.refined[0].sum())} "
          f"parents) x 192 f32: the L-level sweep ({two_s:.3f} s, "
          f"{sweep_multilevel.N_COUPLING_ITERS} passes) against the "
          f"two-level sweep ({amr_s:.3f} s, {sweep_amr.N_COUPLING_ITERS} "
          f"passes): leaf Jmean max diff {err_two:.2e} of each band's peak "
          f"(tol 1e-5)")
    assert err_two <= 1e-5, err_two
    del base, kappa, j_uni, j_one, two, kc, kf, js2, jc, jf, m
    counts0 = _kernel_counts()

    # (d) the CLI on the L-level 32^3 grid (its refined centre and core),
    # 192 directions: mode 9, 2 iterations, a restart of one from the
    # itime-1 snapshot; mode 6, 1 iteration (phase 21 runs the
    # block-sparse CLI)
    n_cli = out["cli_n"] = ML_CLI_N
    config = write_cli_inputs(os.path.join(tmp, "cli32"), n_cli,
                              refine_center=True, refine_core=True)
    d9 = os.path.join(tmp, "ml9")
    out9, call9 = _cli(config, d9, "--iters", "2", tag="19 ml")
    log9 = _time_log(d9)
    dts = _iteration_dts(out9, n_cli ** 3 * 192)
    assert re.search(rf"^grid: {n_cli}\^3 \+ 2 refined levels \(refined "
                     r"parents per level: \[\d+, \d+\]\)$", out9, re.M), out9
    cd = re.search(r"^coupling depth: (\d) \(validated on the ingested "
                   r"grid, residual < 1e-8\)$", out9, re.M)
    assert cd, out9
    assert list(log9) == [1, 2] and all(
        0.0 < v < 1.0 for v in log9.values()), log9
    assert all(os.path.exists(snapshot.snapshot_name(i, d9)) for i in (1, 2))
    print(f"[19 ml] CLI mode 9 on the L-level {n_cli}^3 grid: call "
          f"{call9:.3f} s, iterations' dt {_fmt(dts)} s, neutral fractions "
          f"{list(log9.values())}")
    dr = os.path.join(tmp, "restart")
    os.makedirs(dr)
    shutil.copy(snapshot.snapshot_name(1, d9), dr)
    restart = _config_variant(config, os.path.join(tmp, "restart.cfg"),
                              restart=1)
    # in this process (phases 16-18 restart through python -m)
    out_r, restart_s = _cli(restart, dr, "--iters", "1",
                            "--coupling-depth", cd.group(1), tag="19 ml")
    assert (f"restarted from {snapshot.snapshot_name(1, dr)} at itime=1"
            in out_r), out_r
    assert f"coupling depth: {cd.group(1)} (fixed)" in out_r
    nf_sub = _time_log(dr)[2]
    rel = abs(nf_sub - log9[2]) / log9[2]
    print(f"[19 ml] restart: cli.main {restart_s:.3f} s, itime 2 "
          f"neutral fraction {nf_sub:.8f} against {log9[2]:.8f} in this "
          f"process (rel {rel:.2e}, tol 1e-4)")
    assert rel <= 1e-4, (nf_sub, log9[2])
    d6 = os.path.join(tmp, "ml6")
    config6 = _config_variant(config, os.path.join(tmp, "mode6.cfg"), mode=6)
    out6, call6 = _cli(config6, d6, "--iters", "1", tag="19 ml")
    assert "coupling depth" not in out6 and list(_time_log(d6)) == [1]
    print(f"[19 ml] CLI mode 6 on the L-level {n_cli}^3 grid: call "
          f"{call6:.3f} s")
    assert _kernel_counts() == counts0, "the L-level CLI launched a kernel"
    phase_s = time.perf_counter() - t_phase
    print(f"[19 ml] phase 19: {phase_s:.1f} s; {smi}")
    out.update(cli_dts=dts, cli_call_s=call9, restart_s=restart_s,
               cli_call6_s=call6, phase_s=phase_s)
    return out


def _sweep_once(sweep):
    """A MultiLevelModel._sweep that runs `sweep` on its first state and
    puts that Jmean into every later one, whose species must be the
    first's (so its opacities and Jmean are too)."""
    first = []

    def swept(state):
        species = [(lv.HI, lv.HeI, lv.HeII) for lv in state.levels]
        if not first:
            first.append((species, [lv.Jmean for lv in
                                    sweep(state).levels]))
        assert all(torch.equal(a, b) for x, y in zip(species, first[0][0])
                   for a, b in zip(x, y)), "another state's sweep"
        return dataclasses.replace(state, levels=tuple(
            dataclasses.replace(lv, Jmean=j)
            for lv, j in zip(state.levels, first[0][1])))
    return swept


def phase_ml_sources(smi: str, depth: int | None = None) -> dict:
    """20: point sources and the non-equilibrium chemistry on L-level
    grids (core/rays_multilevel.py, MultiLevelModel.trace and
    make_noneq_step, the CLI's nested noneq branch) on the card.  Plain
    PyTorch: the path launches none of the hand-written kernels (every
    count is held).  depth: the full-width cell's coupling depth, as phase
    19 validated it (validated here when None)."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        return _phase_ml_sources(tmp, smi, depth)


def _phase_ml_sources(tmp: str, smi: str, depth: int | None) -> dict:
    """phase_ml_sources' checks, with `tmp` a directory of their own."""
    import radiativetransfer_tpu_torch as rt
    from radiativetransfer_tpu_torch import profile_step
    from radiativetransfer_tpu_torch.config import (
        MODE_BOTH_STELLAR_UVB_TRANSFER,
        MODE_NO_STARS_THIN_UVB,
        MODE_STELLAR_TRANSFER_THIN_UVB,
        MODE_UVB_TRANSFER_ONLY,
    )
    from radiativetransfer_tpu_torch.constants import KPC, MYR
    from radiativetransfer_tpu_torch.core import (
        amr,
        chemistry_noneq,
        rays,
        rays_multilevel,
        step_amr,
    )
    from radiativetransfer_tpu_torch.io import grid_io, snapshot
    t_phase = time.perf_counter()
    f32, f64 = torch.float32, torch.float64
    mode8, mode1 = (MODE_BOTH_STELLAR_UVB_TRANSFER,
                    MODE_STELLAR_TRANSFER_THIN_UVB)
    channels = tuple(f.name for f in dataclasses.fields(rays.RateFields))
    out = {}

    def model(n, level, dtype, device, mode=MODE_UVB_TRANSFER_ONLY):
        cfg = rt.RunConfig(mode=mode, current_redshift=6.55,
                           n_angular_level=level, reionization_model=10,
                           self_shielding_threshold_kpc=0.1)
        return rt.RTModel.setup(cfg, rt.GridGeometry(n, n, n, 300.0 * KPC),
                                dtype, device)

    def timed(fn):
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, time.perf_counter() - t0

    def equilibrium(m, state):
        return amr.sync_restriction_multi(amr.MultiLevelState(
            levels=tuple(m.initialize_equilibrium(lv)
                         for lv in state.levels), refined=state.refined))

    def ingest(n, dtype, device, max_depth=4, core=True):
        """(the nested state of write_cli_inputs' galaxy at n^3 with its
        refined centre (and core), the levels read, its inputParameters)."""
        directory = os.path.join(tmp, f"inputs{n}{'' if core else 'c'}")
        config = os.path.join(directory, "inputParameters")
        if not os.path.exists(directory):
            config = write_cli_inputs(directory, n, refine_center=True,
                                      refine_core=core)
        levels = grid_io.read_level_npz(
            os.path.join(directory, "testgrid_velmet.npz"))
        return amr.multilevel_from_levels(
            levels, True, dtype, device=device,
            max_depth=max_depth)[0], levels, config

    def worst(a, b, names):
        """The largest |a - b| over each field's peak in b, field by field
        and level by level of two MultiLevelStates, b's on its device
        (fields 0 in b must be 0 in a)."""
        err = 0.0
        for x, y in zip(a.levels, b.levels):
            for k in names:
                u, v = getattr(x, k).to(getattr(y, k)), getattr(y, k)
                peak = float(v.abs().max())
                err = max(err, float((u - v).abs().max()) / peak if peak
                          else float(u.abs().max()))
        return err

    def rf_worst(a, b, names=channels):
        """The same over per-level rate fields (tuples), channel by
        channel."""
        return max(float((getattr(x, k).to(getattr(y, k)) - getattr(y, k))
                         .abs().max() / getattr(y, k).abs().max())
                   for x, y in zip(a, b) for k in names
                   if float(getattr(y, k).abs().max()) > 0.0)

    counts0 = _kernel_counts()
    fields = ("HI", "HeI", "HeII", "Jmean", "krate24", "crate24")

    # (d), its runs: the CLI at 32^3, angular level 1 (the branches,
    # snapshots and restarts are the same at 12 directions as at 192,
    # which (b) runs; at 192, one after another, (d) took 71.6 s on an
    # H100): mode 8 on the L-level grid, --chemistry noneq mode 9 on the
    # two-level and the L-level grids, 2 iterations each, each through
    # python -m in a process of its own, beside (a) and (c) (joined before
    # (b)'s timings and profiler windows)
    n_cli = out["cli_n"] = ML_CLI_N
    cli_ml = write_cli_inputs(os.path.join(tmp, "cli_ml"), n_cli,
                              refine_center=True, refine_core=True)
    cli_two = write_cli_inputs(os.path.join(tmp, "cli_two"), n_cli,
                               refine_center=True)
    noneq_flags = ("--chemistry", "noneq")
    cli_cases = [
        ("mode 8, L-level", _config_variant(
            cli_ml, os.path.join(tmp, "ml8.cfg"), mode=8), ()),
        ("noneq mode 9, two-level", cli_two, noneq_flags),
        ("noneq mode 9, L-level", cli_ml, noneq_flags)]
    cli_procs = {}
    for name, config, flags in cli_cases:
        d = os.path.join(tmp, re.sub(r"\W+", "_", name))
        os.makedirs(d)
        cli_procs[name] = _CliProcess([config, "--snapshot-dir", d, "--iters",
                                       "2", "--angular-level", "1", *flags])

    # (a) the galaxy at N_A^3 = 16^3 with its refined centre and core (3
    # levels; at 24^3 the CPU's sweep took ~10 s), angular level 1, f64, 3
    # of its sources at maxPixelLevel 4: one mode-8 step, one noneq mode-9
    # step and one noneq mode-8 step (5 substeps; 2 coupling passes, the
    # full-width cell's depth) on the card against the CPU's, from the
    # CPU's equilibrium.  The three steps sweep the same opacities (a
    # step's tracer changes no species): the CPU sweeps them once
    n_a = 16
    st_a, lv_a, cfg_a = ingest(n_a, f64, "cpu")
    cpu9, cpu8 = model(n_a, 1, f64, "cpu"), model(n_a, 1, f64, "cpu", mode8)
    st_a = equilibrium(cpu9, st_a)
    arrays = st_a.to_numpy()
    runs = {}
    for device in ("cpu", DEVICE):
        m9, m8 = ((cpu9, cpu8) if device == "cpu" else
                  (model(n_a, 1, f64, DEVICE), model(n_a, 1, f64, DEVICE,
                                                       mode8)))
        ml9, ml8 = (step_amr.MultiLevelModel.setup(m, 3) for m in (m9, m8))
        ml9.n_coupling_iters = ml8.n_coupling_iters = 2
        st = amr.MultiLevelState.from_numpy(arrays, dtype=f64, device=device)
        if device == "cpu":
            ml9._sweep = ml8._sweep = _sweep_once(ml9._sweep)
        ctx, ctxn = (_cli_stellar(cfg_a, lv_a, st, m8.geom, f64, device,
                                  noneq=noneq, first=3, max_pixel_level=4)
                     for noneq in (False, True))
        sp = tuple(chemistry_noneq.species_from_field_state(lv)
                   for lv in st.levels)
        (s8, _), t8 = timed(lambda: ml8.make_step(ctx)(st))
        (s9n, sp9n), t9n = timed(lambda: ml9.make_noneq_step(
            MYR, n_substeps=5)(st, sp))
        (s8n, sp8n, _), t8n = timed(lambda: ml8.make_noneq_step(
            MYR, ctxn, n_substeps=5)(st, sp))
        runs[device] = ((s8, s9n, s8n), (sp9n, sp8n), (t8, t9n, t8n))
    (card, card_sp, t_card), (host, host_sp, t_host) = (runs[DEVICE],
                                                         runs["cpu"])
    errs = [worst(card[0], host[0], fields),
            max(worst(card[1], host[1], fields[:4]),
                max(_species_worst(a, b) for a, b in zip(card_sp[0],
                                                         host_sp[0]))),
            max(worst(card[2], host[2], fields),
                max(_species_worst(a, b) for a, b in zip(card_sp[1],
                                                         host_sp[1])))]
    parents = [int(r.sum()) for r in st_a.refined]
    print(f"[20 mlsrc] {n_a}^3 + refined parents per level {parents}, 3 "
          f"levels, level 1, f64, 3 sources at maxPixelLevel 4: card / CPU "
          f"seconds: mode 8 {t_card[0]:.3f} / {t_host[0]:.3f}, noneq mode 9 "
          f"{t_card[1]:.3f} / {t_host[1]:.3f}, noneq mode 8 {t_card[2]:.3f} "
          f"/ {t_host[2]:.3f} (5 substeps); max diff of each level's "
          f"fields, rates and species over their peaks: {errs[0]:.2e}, "
          f"{errs[1]:.2e}, {errs[2]:.2e} (tol 1e-9)")
    assert max(errs) <= 1e-9, errs
    assert all(float(lv.krate24.max()) > 0.0 for lv in card[0].levels)
    out["card_vs_cpu"] = errs
    del runs, card, host, card_sp, host_sp, cpu9, cpu8, arrays

    # (c) L = 2 on the card, f64: the N_A^3 grid cut to two levels, one
    # mode-8 step of the two-level model (AMRModel: the CLI's equilibrium
    # route) against one of MultiLevelModel(2) (its noneq route) from the
    # same state; both trace through the L-level march
    two, lv2, cfg2 = ingest(n_a, f64, DEVICE, max_depth=2)
    m2 = model(n_a, 1, f64, DEVICE, mode8)
    two = equilibrium(m2, two)
    ctx2 = _cli_stellar(cfg2, lv2, two, m2.geom, f64, DEVICE, first=3,
                        max_pixel_level=4)
    am2 = step_amr.AMRModel.setup(m2)
    (s_ml, diag_m), ml_s = timed(lambda: step_amr.MultiLevelModel.setup(
        m2, 2).make_step(ctx2)(two))
    (s_amr, diag_2), amr_s = timed(lambda: am2.make_step(ctx2)(
        amr.two_level_view(two)))
    err_c = max(worst(s_ml, amr.MultiLevelState(
        levels=(s_amr.base, s_amr.fine), refined=(s_amr.refined,)),
        fields), max(
        float((getattr(diag_m, f.name) - getattr(diag_2, f.name)).abs().max()
              / getattr(diag_2, f.name).abs().max())
        for f in dataclasses.fields(diag_2)))
    print(f"[20 mlsrc] L = 2 ({n_a}^3 + {int(two.refined[0].sum())} "
          f"parents), "
          f"f64, 3 sources, mode 8: MultiLevelModel(2)'s step "
          f"({ml_s:.3f} s) against AMRModel's ({amr_s:.3f} s): max diff "
          f"{err_c:.2e} of each level's fields, rates and diagnostics over "
          f"their peaks (tol 1e-9)")
    assert err_c <= 1e-9, err_c
    out["two_level_err"] = err_c
    del two, s_ml, s_amr, m2, am2, ctx2, st_a

    # (d), its restarts: each run's output, then its restart in this
    # process from its itime-1 snapshot, its itime 2 within 1e-4 of the
    # run's
    cli_runs = {}
    for name, config, flags in cli_cases:
        d = os.path.join(tmp, re.sub(r"\W+", "_", name))
        rc, run_out, err, call_s = cli_procs[name].result()
        for line in run_out.splitlines():
            print(f"[20 mlsrc]   {line}")
        assert rc == 0, err[-4000:]
        flags = ("--angular-level", "1", *flags)
        log = _time_log(d)
        assert list(log) == [1, 2] and all(0.0 < v < 1.0
                                           for v in log.values()), log
        cd = re.search(r"^coupling depth: (\d) ", run_out, re.M)
        depth_flags = ("--coupling-depth", cd.group(1)) if cd else ()
        dr = d + "_restart"
        os.makedirs(dr)
        shutil.copy(snapshot.snapshot_name(1, d), dr)
        restart = _config_variant(config, d + "_restart.cfg", restart=1)
        out_r, restart_s = _cli(restart, dr, "--iters", "1", *flags,
                                *depth_flags, tag="20 mlsrc")
        assert (f"restarted from {snapshot.snapshot_name(1, dr)} at itime=1"
                in out_r), out_r
        if "noneq" in flags:
            assert "restored 9-species noneq state from snapshot" in out_r
            with np.load(snapshot.snapshot_name(2, d)) as f:
                assert "species1_H2I" in f
        nf_r = _time_log(dr)[2]
        rel = abs(nf_r - log[2]) / log[2]
        dts = _iteration_dts(run_out, n_cli ** 3 * 12)
        fesc = re.findall(r"fesc=(\S+)", run_out)
        print(f"[20 mlsrc] CLI {name} on the {n_cli}^3 grid: python -m "
              f"...cli {call_s:.3f} s (beside (a) and (c)), iterations' dt "
              f"{_fmt(dts)} s, neutral fractions {list(log.values())}"
              + (f", fesc {fesc[-1]}" if fesc else "")
              + f"; restart in this process {restart_s:.3f} s, itime 2 "
              f"{nf_r:.8f} against {log[2]:.8f} (rel {rel:.2e}, tol 1e-4)")
        assert rel <= 1e-4, (name, nf_r, log[2])
        cli_runs[name] = (dts, call_s, restart_s)

    # (b) the full-width cell, f32: phase 19's galaxy at 64^3 with its
    # refined centre and core and its 12 sources at maxPixelLevel 6, 192
    # directions
    n, level = ML_N, MAIN_LEVEL
    (state, levels, config), ingest_s = timed(lambda: ingest(n, f32, DEVICE))
    m8 = model(n, level, f32, DEVICE, mode8)
    ml8, plan_s = timed(lambda: step_amr.MultiLevelModel.setup(m8, 3))
    depth_s = 0.0
    if depth is None:
        depth, depth_s = timed(lambda: ml8.validate_coupling_depth(state))
    ml8.n_coupling_iters = depth
    state, eq_s = timed(lambda: equilibrium(m8, state))
    ctx, src_s = timed(lambda: _cli_stellar(config, levels, state, m8.geom,
                                            f32, DEVICE))
    nf0 = ml8.neutral_fraction(state)
    print(f"[20 mlsrc] {n}^3 + refined parents per level "
          f"{[int(r.sum()) for r in state.refined]}: ingested in "
          f"{ingest_s:.3f} s, plan {plan_s:.3f} s, coupling depth {depth} "
          f"in {depth_s:.3f} s, equilibrium {eq_s:.3f} s, the "
          f"{ctx.sources.n_sources} sources prepared as the CLI does "
          f"{src_s:.3f} s; neutral fraction {nf0:.7f}")
    torch.cuda.reset_peak_memory_stats()
    (s8, rows8, march), step8_s = timed(lambda: profile_step.ml_layers(
        ml8, state, stellar=ctx))
    peak8 = torch.cuda.max_memory_allocated() / 2 ** 30
    nf8 = ml8.neutral_fraction(s8)
    tr_ms, tr_host = rows8["tracer"][:2]
    print(f"[20 mlsrc] {n}^3 + 2 levels x 192 f32 L-level mode-8 step, "
          f"{ctx.sources.n_sources} sources, maxPixelLevel "
          f"{ctx.max_pixel_level}: {step8_s:.3f} s, layers (device ms by "
          "CUDA events / host ms to enqueue): " + ", ".join(
              f"{k} {ms:.3f} / {h:.3f}" for k, (ms, h, _) in rows8.items())
          + f"; the tracer {march} march steps ({tr_ms / march:.3f} ms a "
          f"step); neutral fraction {nf0:.7f} -> {nf8:.7f}; peak device "
          f"memory {peak8:.3f} GiB; {smi}")
    assert np.isfinite(nf8) and 0.0 < nf8 < nf0, (nf0, nf8)
    assert all(bool(torch.isfinite(getattr(lv, k)).all())
               for lv in s8.levels for k in fields)
    assert all(float(lv.krate24.max()) > 0.0 for lv in s8.levels)
    del s8
    tr_wall, tr_busy, tr_events, _ = profile_step.profiled(
        lambda s: ml8.trace(ml8._zero_rates(s), ctx)[0], [state], steps=1)
    print(f"[20 mlsrc] the {n}^3 L-level tracer in a profiler window: wall "
          f"{tr_wall * 1e3:.3f} ms, device busy {tr_busy * 1e3:.3f} ms "
          f"({100 * tr_busy / tr_wall:.1f}%), {tr_events:.0f} device events "
          f"({tr_events / march:.1f} a march step)")
    ml1 = step_amr.MultiLevelModel.setup(model(n, level, f32, DEVICE, mode1),
                                         3)
    assert ml1.plan is None
    (s1, diag1), step1_s = timed(lambda: ml1.make_step(ctx)(state))
    nf1 = ml1.neutral_fraction(s1)
    fesc1 = rays.escape_fractions(diag1, ctx.sources.weight)
    print(f"[20 mlsrc] {n}^3 f32 L-level mode-1 step (the tracer, three "
          f"chemistries, no sweep): {step1_s:.3f} s; neutral fraction "
          f"{nf0:.7f} -> {nf1:.7f}; escape fractions at the outer radius "
          f"{_fmt(fesc1[:, -1])}")
    assert 0.0 < nf1 < nf0 and bool(np.isfinite(fesc1).all())
    del s1, ml1
    # the noneq step in mode 6: the networks (a mode-9 step adds the
    # sweep, whose layer the mode-8 step above times)
    ml9 = dataclasses.replace(ml8, rt=model(n, level, f32, DEVICE,
                                            MODE_NO_STARS_THIN_UVB),
                              plan=None)
    species = tuple(chemistry_noneq.species_from_field_state(lv)
                    for lv in state.levels)
    torch.cuda.reset_peak_memory_stats()
    (s9, sp9, rows9, _), step9_s = timed(lambda: profile_step.ml_noneq_layers(
        ml9, state, species, dt=0.1 * MYR, n_substeps=20))
    peak9 = torch.cuda.max_memory_allocated() / 2 ** 30
    nf9 = ml9.neutral_fraction(s9)
    print(f"[20 mlsrc] {n}^3 + 2 levels f32 L-level noneq mode-6 step "
          f"(0.1 Myr, 20 substeps; 1 Myr in 200 took the network 10 s; a "
          f"mode-9 step adds the mode-8 step's sweep layer): "
          f"{step9_s:.3f} s, layers (device ms / host ms): "
          + ", ".join(f"{k} {ms:.3f} / {h:.3f}"
                              for k, (ms, h, _) in rows9.items())
          + f"; neutral fraction {nf0:.7f} -> {nf9:.7f}; peak device memory "
          f"{peak9:.3f} GiB")
    assert np.isfinite(nf9) and 0.0 < nf9 < 1.0
    assert all(bool(torch.isfinite(getattr(sp, k)).all())
               for sp in sp9 for k in ("HI", "H2I", "de", "eint"))
    del s9, sp9, species, ml9
    # the float32 trace against float64's of the same state with the same
    # (float32's) kills: every level's six channels within 5e-5 of each
    # peak (phase 18's bound), the escape fractions within 1e-5; the
    # deposits below float32's smallest normal value, which the
    # rays_multilevel scale keeps from the card's flush, and the f64
    # trace's nonzero deposits that float32 can hold and the f32 trace
    # lost, counted
    kills = dict(tau_kill=rays.default_tau_kill(f32),
                 rel_kill=rays.default_rel_kill(f32))
    ctx64 = _cli_stellar(config, levels, state, m8.geom, f64, DEVICE)
    (t32, t64), trace_s = zip(*(timed(
        lambda c=c, d=d: rays_multilevel.trace_point_sources_ml(
            state, m8.geom, c.sources, c.tables,
            dust_approximation=c.dust_approximation,
            max_pixel_level=c.max_pixel_level, dtype=d, **kills))
        for c, d in ((ctx, f32), (ctx64, f64))))
    err_levels = [rf_worst((a,), (b,)) for a, b in zip(t32[0], t64[0])]
    fesc32, fesc64 = (rays.escape_fractions(t[1], ctx.sources.weight)
                      for t in (t32, t64))
    fesc_err = float(np.abs(fesc32 - fesc64).max())
    tiny = torch.finfo(f32).tiny
    counted = []
    for a, b in zip(t32[0], t64[0]):
        x = torch.stack([getattr(a, k) for k in channels]).double()
        y = torch.stack([getattr(b, k) for k in channels])
        lost = (y != 0) & (x == 0) & (y.abs() >= 2.0 ** -149)
        counted.append((int((y != 0).sum()),
                        int(((y != 0) & (y.abs() < tiny)).sum()),
                        int(lost.sum()),
                        float((y.abs() * lost).amax(dim=1).div(
                            y.abs().amax(dim=1).clamp(min=1e-300)).max())))
    print(f"[20 mlsrc] the {n}^3 f32 trace ({trace_s[0]:.3f} s) against the "
          f"f64 trace ({trace_s[1]:.3f} s), both with tau_kill "
          f"{kills['tau_kill']} and rel_kill {kills['rel_kill']}: channels "
          f"max diff by level {_fmt(err_levels)} of each channel's peak "
          f"(tol 5e-5), escape fractions {fesc_err:.2e} (tol 1e-5); by "
          f"level (nonzero in f64, below float32's smallest normal "
          f"{tiny:.3e}, lost by f32 though float32 holds them, the largest "
          f"lost over its channel's peak): {counted}")
    assert max(err_levels) <= 5e-5 and fesc_err <= 1e-5, (err_levels,
                                                           fesc_err)
    del t32, t64, ctx64, state, levels, ml8, m8
    # the tracer's launches a march step, from two agreeing profiler
    # windows of a whole trace at an 8^3 base with its 12 sources
    st8, lv8, cfg8 = ingest(8, f32, DEVICE)
    m8s = model(8, level, f32, DEVICE, mode8)
    ml8s = step_amr.MultiLevelModel.setup(m8s, 3)
    _, rows_s, march_s = profile_step.ml_layers(
        ml8s, equilibrium(m8s, st8), count=("tracer",),
        stellar=_cli_stellar(cfg8, lv8, st8, m8s.geom, f32, DEVICE))
    per_step = rows_s["tracer"][2] / march_s
    print(f"[20 mlsrc] the L-level tracer at an 8^3 base (3 levels, 12 "
          f"sources, maxPixelLevel 6): {rows_s['tracer'][2]} launches in "
          f"two agreeing traces of {march_s} march steps, {per_step:.1f} a "
          f"march step")
    assert march_s > 0 and rows_s["tracer"][2] > march_s
    assert _kernel_counts() == counts0, "the L-level step launched a kernel"
    out.update(step8_s=step8_s, layers8=rows8, march=march, peak8_gib=peak8,
               tracer_busy_share=tr_busy / tr_wall, mode1_s=step1_s,
               noneq9_s=step9_s, layers9=rows9, peak9_gib=peak9,
               trace_err=(*err_levels, fesc_err), deposits=counted,
               launches_per_march_step=per_step, depth=depth)

    assert _kernel_counts() == counts0, "the L-level CLI launched a kernel"
    phase_s = time.perf_counter() - t_phase
    print(f"[20 mlsrc] phase 20: {phase_s:.1f} s; {smi}")
    _print_windows("20 mlsrc", "phases 17 to 20")
    out.update(cli=cli_runs, phase_s=phase_s)
    return out


def _sparse_sweep_once(sweep):
    """A SparseMLModel._apply_sweep that runs `sweep` on its first state
    and puts that Jmean into every later one, whose species must be the
    first's (so its opacities and Jmean are too)."""
    first = []

    def fields(state):
        return [state.base] + [lv.fields for lv in state.levels]

    def swept(state, *args):
        species = [(f.HI, f.HeI, f.HeII) for f in fields(state)]
        if not first:
            first.append((species, [f.Jmean for f in fields(
                sweep(state, *args))]))
        assert all(torch.equal(a, b) for x, y in zip(species, first[0][0])
                   for a, b in zip(x, y)), "another state's sweep"
        js = first[0][1]
        return dataclasses.replace(
            state, base=dataclasses.replace(state.base, Jmean=js[0]),
            levels=tuple(dataclasses.replace(lv, fields=dataclasses.replace(
                lv.fields, Jmean=j)) for lv, j in zip(state.levels, js[1:])))
    return swept


def phase_sparse(smi: str, dense_cell=None) -> dict:
    """21: block-sparse L-level AMR (core/amr_sparse.py,
    core/sweep_sparse.py, the block-sparse tracer of
    core/rays_multilevel.py, SparseMLModel with its stellar and noneq
    steps, the CLI's sparse branch) on the card, in modes 9, 8, 6 and 1
    and with the noneq chemistry.  Plain PyTorch: the path launches none
    of the hand-written kernels (every count is held).  dense_cell: phase
    19's (MultiLevelModel, state, its step) at the 64^3 cell, for (c)."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        return _phase_sparse(tmp, smi, dense_cell)


def _phase_sparse(tmp: str, smi: str, dense_cell) -> dict:
    """phase_sparse's checks, with `tmp` a directory of their own."""
    import radiativetransfer_tpu_torch as rt
    from radiativetransfer_tpu_torch import profile_step
    from radiativetransfer_tpu_torch.config import (
        MODE_BOTH_STELLAR_UVB_TRANSFER,
        MODE_NO_STARS_THIN_UVB,
        MODE_STELLAR_TRANSFER_THIN_UVB,
        MODE_UVB_TRANSFER_ONLY,
    )
    from radiativetransfer_tpu_torch.constants import KPC, MYR
    from radiativetransfer_tpu_torch.core import (
        amr_sparse,
        chemistry_noneq,
        rays,
        rays_multilevel,
        step_amr,
    )
    from radiativetransfer_tpu_torch.io import grid_io, snapshot
    t_phase = time.perf_counter()
    f32, f64 = torch.float32, torch.float64
    mode8, mode1 = (MODE_BOTH_STELLAR_UVB_TRANSFER,
                    MODE_STELLAR_TRANSFER_THIN_UVB)
    channels = tuple(f.name for f in dataclasses.fields(rays.RateFields))
    counts0 = _kernel_counts()
    out = {}
    names = ("HI", "HeI", "HeII", "Jmean")

    def model(n, level, dtype, device, mode=MODE_UVB_TRANSFER_ONLY):
        cfg = rt.RunConfig(mode=mode, current_redshift=6.55,
                           n_angular_level=level, reionization_model=10,
                           self_shielding_threshold_kpc=0.1)
        return rt.RTModel.setup(cfg, rt.GridGeometry(n, n, n, 300.0 * KPC),
                                dtype, device)

    def timed(fn):
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, time.perf_counter() - t0

    def worst_covered(a, b):
        """The largest |a - b| over b's peak, field by field (names) and
        level by level, on the cells that exist at each level: a and b
        dense MultiLevelStates, a's on b's device."""
        cover = b.cover_masks()
        return max(float((getattr(x, k).to(getattr(y, k)) - getattr(y, k))
                         .abs()[..., c].max()
                         / getattr(y, k).abs()[..., c].max())
                   for x, y, c in zip(a.levels, b.levels, cover)
                   for k in names)

    def rel(x, y):
        """|x - y|'s largest over y's peak (x's largest where y is 0), x
        moved to y's device and dtype."""
        d = float((x.to(y) - y).abs().max())
        peak = float(y.abs().max())
        return d / peak if peak else float(x.abs().max())

    def sparse_worst(a, b, keys, species=()):
        """The largest rel of the fields `keys` of two SparseMLStates and
        of their species tuples (every species), level by level, on every
        block cell (the padding blocks are 0 in both)."""
        fa = [a.base] + [lv.fields for lv in a.levels]
        fb = [b.base] + [lv.fields for lv in b.levels]
        err = max(rel(getattr(x, k), getattr(y, k)) for x, y in zip(fa, fb)
                  for k in keys)
        for x, y in zip(*species) if species else ():
            err = max(err, _species_worst(x, y))
        return err

    def rf_worst(a, b, keys=channels):
        """The same over per-level rate fields, channel by channel."""
        return max(rel(getattr(x, k), getattr(y, k))
                   for x, y in zip(a, b) for k in keys)

    def diag_worst(a, b):
        return max(rel(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(b))

    # (d) the CLI on the L-level 32^3 grid under --amr-storage sparse, 192
    # directions: mode 9, 2 iterations here, its restart from the itime-1 snapshot through python -m beside
    # (a); modes 8 and 1 (the 12 sources) and --chemistry noneq mode 9, 2
    # iterations each through python -m in a process of its own beside
    # (a), the noneq run restarted in this process from its itime-1
    # snapshot after (a)
    n_cli = ML_CLI_N
    config = write_cli_inputs(os.path.join(tmp, "cli32"), n_cli,
                              refine_center=True, refine_core=True)
    sparse = ("--amr-storage", "sparse")
    d9 = os.path.join(tmp, "sparse9")
    out9, call9 = _cli(config, d9, "--iters", "2", *sparse, tag="21 sparse")
    log9 = _time_log(d9)
    dts = _iteration_dts(out9, n_cli ** 3 * 192)
    assert re.search(rf"^grid: {n_cli}\^3 \+ 2 refined levels, block-sparse "
                     r"\(be=8\): \d+ leaves, \S+ GB \(dense would be \S+ "
                     r"GB\)$", out9, re.M), out9
    cd = re.search(r"^coupling depth: (\d) \(validated on the ingested "
                   r"grid, residual < 1e-8\)$", out9, re.M)
    assert cd, out9
    assert list(log9) == [1, 2] and all(
        0.0 < v < 1.0 for v in log9.values()), log9
    print(f"[21 sparse] CLI mode 9 on the block-sparse {n_cli}^3 grid: "
          f"call {call9:.3f} s, iterations' dt {_fmt(dts)} s, neutral "
          f"fractions {list(log9.values())}")
    dr = os.path.join(tmp, "restart")
    os.makedirs(dr)
    shutil.copy(snapshot.snapshot_name(1, d9), dr)
    restart = _config_variant(config, os.path.join(tmp, "restart.cfg"),
                              restart=1)
    restarted = _CliProcess([restart, "--snapshot-dir", dr, "--iters", "1",
                             *sparse, "--coupling-depth", cd.group(1)])
    cli_cases = {
        "mode 8": (_config_variant(config, os.path.join(tmp, "m8.cfg"),
                                   mode=8), ()),
        "mode 1": (_config_variant(config, os.path.join(tmp, "m1.cfg"),
                                   mode=1), ()),
        "noneq mode 9": (config, ("--chemistry", "noneq"))}
    cli_procs = {}
    for name, (cfg_m, flags) in cli_cases.items():
        d = os.path.join(tmp, re.sub(r"\W+", "_", name))
        os.makedirs(d)
        cli_procs[name] = _CliProcess([cfg_m, "--snapshot-dir", d, "--iters",
                                       "2", *sparse, *flags])

    # (a) 24^3 with its refined centre and core in blocks of 4, level 1,
    # f64: a mode-9 step on the card, windowed and full-plane, against the
    # CPU's windowed step, and against the dense L-level card step; the
    # block-sparse trace (3 of the galaxy's sources at maxPixelLevel 4), a
    # mode-8 step and a noneq mode-9 step (5 substeps) on the card against
    # the CPU's (the CPU sweeps once for its three steps: a step's tracer
    # changes no species)
    config24 = write_cli_inputs(os.path.join(tmp, "in24"), 24,
                                refine_center=True, refine_core=True)
    levels24 = grid_io.read_level_npz(os.path.join(
        os.path.dirname(config24), "testgrid_velmet.npz"))
    # the eager CPU steps' small ops run fastest on one thread (and the
    # CLI processes of (d) share the host)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cpu = model(24, 1, f64, "cpu")
    st = amr_sparse.sparse_from_level_lists(levels24, True, be=4,
                                            dtype=f64, device="cpu")[0]
    host_sm = step_amr.SparseMLModel.setup(cpu, 3)
    host_sm._apply_sweep = _sparse_sweep_once(host_sm._apply_sweep)
    arrays = host_sm.initialize_equilibrium(st).to_numpy()
    host, cpu_s = timed(lambda: host_sm.make_step()(
        amr_sparse.SparseMLState.from_numpy(arrays, dtype=f64,
                                            device="cpu")))
    assert host_sm._window[0] == 20
    host = amr_sparse.dense_from_sparse(host)
    m24 = model(24, 1, f64, DEVICE)
    errs, card_s = {}, {}
    for windowed in (True, False):
        sm = step_amr.SparseMLModel.setup(m24, 3)
        sm.window_enabled = windowed
        st_c = amr_sparse.SparseMLState.from_numpy(arrays, dtype=f64,
                                                   device=DEVICE)
        card, card_s[windowed] = timed(lambda: sm.make_step()(st_c))
        assert (sm._window is not None) == windowed
        card = amr_sparse.dense_from_sparse(card)
        errs[windowed] = worst_covered(card, host)
        if windowed:
            windowed_card = card
    dense0 = amr_sparse.dense_from_sparse(st_c)
    dense1, dense_s = timed(lambda: step_amr.MultiLevelModel.setup(
        m24, 3).make_step()(dense0))
    err_dense = worst_covered(windowed_card, dense1)
    print(f"[21 sparse] 24^3 + refined parents per level "
          f"{[int(r.sum()) for r in dense0.refined]} in blocks of 4 "
          f"({[lv.n_blocks for lv in st_c.levels]} blocks, W 20), level 1, "
          f"f64 mode 9 at depth {sm.n_coupling_iters}: card windowed "
          f"{card_s[True]:.3f} s, full-plane {card_s[False]:.3f} s, CPU "
          f"windowed {cpu_s:.3f} s, dense L-level card {dense_s:.3f} s; "
          f"species and Jmean max diff on covered cells, card against CPU "
          f"{errs[True]:.2e} (windowed), {errs[False]:.2e} (full-plane), "
          f"windowed against the dense step {err_dense:.2e} of each "
          f"level's peak (tol 1e-10)")
    assert max(errs.values()) <= 1e-10 and err_dense <= 1e-10, (errs,
                                                                err_dense)
    out["card_vs_cpu"] = errs
    out["card_vs_dense"] = err_dense
    del host, card, windowed_card, dense0, dense1, st_c
    runs = {}
    for device in ("cpu", DEVICE):
        m9, m8 = ((cpu, model(24, 1, f64, "cpu", mode8)) if device == "cpu"
                  else (m24, model(24, 1, f64, DEVICE, mode8)))
        sm9, sm8 = (step_amr.SparseMLModel.setup(m, 3) for m in (m9, m8))
        if device == "cpu":
            sm9._apply_sweep = sm8._apply_sweep = host_sm._apply_sweep
        st = amr_sparse.SparseMLState.from_numpy(arrays, dtype=f64,
                                                 device=device)
        ctx = _cli_stellar(config24, levels24, st, m8.geom, f64, device,
                           first=3, max_pixel_level=4)
        (_, rfs, diag), t_tr = timed(lambda: sm8.trace(sm8._zero_rates(st),
                                                       ctx))
        (s8, diag8), t8 = timed(lambda: sm8.make_step(ctx)(st))
        (s9n, sp9n), t9n = timed(lambda: sm9.make_noneq_step(
            MYR, n_substeps=5)(st, sm9.initial_species(st)))
        runs[device] = ((rfs, diag), (s8, diag8), (s9n, sp9n),
                        (t_tr, t8, t9n))
    torch.set_num_threads(threads)
    card, host = runs[DEVICE], runs["cpu"]
    fields = names + ("tgas", "krate24", "crate24")
    errs_a = [max(rf_worst(card[0][0], host[0][0]),
                  diag_worst(card[0][1], host[0][1])),
              max(sparse_worst(card[1][0], host[1][0], fields),
                  diag_worst(card[1][1], host[1][1])),
              sparse_worst(card[2][0], host[2][0], names,
                           (card[2][1], host[2][1]))]
    print(f"[21 sparse] 24^3 in blocks of 4, f64, 3 sources at "
          f"maxPixelLevel 4: card / CPU seconds: the block-sparse trace "
          f"{card[3][0]:.3f} / {host[3][0]:.3f}, mode-8 step "
          f"{card[3][1]:.3f} / {host[3][1]:.3f}, noneq mode-9 step "
          f"{card[3][2]:.3f} / {host[3][2]:.3f} (5 substeps); max diff over "
          f"each channel's, field's and species' peak on every level: "
          f"{errs_a[0]:.2e} (the trace and its diagnostics), {errs_a[1]:.2e}"
          f" (mode 8), {errs_a[2]:.2e} (noneq) (tol 1e-9)")
    assert max(errs_a) <= 1e-9, errs_a
    assert all(float(rf.krate24.max()) > 0.0 for rf in card[0][0])
    out["card_vs_cpu_sources"] = errs_a
    assert _kernel_counts() == counts0, "the sparse step launched a kernel"
    del runs, card, host, cpu, host_sm, arrays, st
    rc, stdout, stderr, restart_s = restarted.result()
    for line in stdout.splitlines():
        print(f"[21 sparse]   {line}")
    assert rc == 0, stderr[-4000:]
    assert (f"restarted from {snapshot.snapshot_name(1, dr)} at itime=1"
            in stdout), stdout
    nf_sub = _time_log(dr)[2]
    rel9 = abs(nf_sub - log9[2]) / log9[2]
    print(f"[21 sparse] restart: python -m ...cli {restart_s:.3f} s (beside "
          f"(a)), itime 2 neutral fraction {nf_sub:.8f} against "
          f"{log9[2]:.8f} in this process (rel {rel9:.2e}, tol 1e-4)")
    assert rel9 <= 1e-4, (nf_sub, log9[2])
    # (d), the runs started before (a), and the noneq run's restart here
    cli_runs = {}
    for name, (cfg_m, flags) in cli_cases.items():
        d = os.path.join(tmp, re.sub(r"\W+", "_", name))
        rc, run_out, err, call_s = cli_procs[name].result()
        for line in run_out.splitlines():
            print(f"[21 sparse]   {line}")
        assert rc == 0, err[-4000:]
        log = _time_log(d)
        assert list(log) == [1, 2] and all(0.0 < v < 1.0
                                           for v in log.values()), log
        fesc = re.findall(r"fesc=(\S+)", run_out)
        assert len(fesc) == (0 if flags else 2), run_out
        assert os.path.exists(os.path.join(d, "cosmicSpectrum.npz")) == (
            not flags)
        dts_m = _iteration_dts(run_out, n_cli ** 3 * 192)
        line = (f"[21 sparse] CLI {name} on the block-sparse {n_cli}^3 grid: "
                f"python -m ...cli {call_s:.3f} s (beside (a)), iterations' "
                f"dt {_fmt(dts_m)} s, neutral fractions {list(log.values())}"
                + (f", fesc {fesc[-1]}" if fesc else ""))
        if flags:
            assert ("non-equilibrium chemistry (block-sparse, 3 levels): dt "
                    "= 1.0 Myr, evolve_energy = False") in run_out, run_out
            with np.load(snapshot.snapshot_name(2, d)) as f:
                nb = len(f["origin_2"]) + 1
                assert f["species0_H2I"].shape == (n_cli,) * 3
                assert f["species2_H2I"].shape == (nb, 8, 8, 8)
            cdn = re.search(r"^coupling depth: (\d) ", run_out, re.M)
            drn = d + "_restart"
            os.makedirs(drn)
            shutil.copy(snapshot.snapshot_name(1, d), drn)
            restart_n = _config_variant(cfg_m, d + "_restart.cfg",
                                        restart=1)
            out_r, restart_n_s = _cli(restart_n, drn, "--iters", "1",
                                      *sparse, *flags, "--coupling-depth",
                                      cdn.group(1), tag="21 sparse")
            assert (f"restarted from {snapshot.snapshot_name(1, drn)} at "
                    f"itime=1") in out_r, out_r
            assert "restored 9-species noneq state from snapshot" in out_r
            nf_r = _time_log(drn)[2]
            rel_n = abs(nf_r - log[2]) / log[2]
            line += (f"; restart in this process {restart_n_s:.3f} s, "
                     f"itime 2 {nf_r:.8f} against {log[2]:.8f} (rel "
                     f"{rel_n:.2e}, tol 1e-4)")
            assert rel_n <= 1e-4, (nf_r, log[2])
        print(line)
        cli_runs[name] = (dts_m, call_s)
    assert _kernel_counts() == counts0, "the sparse CLI launched a kernel"

    # (b) the production cell: 128^3 with its refined centre and core x
    # 192, f32, stored block-sparse under the CLI's default rule: mode 9,
    # and with the galaxy's 12 sources at maxPixelLevel 6 as the CLI
    # prepares them, modes 8 and 1 and a noneq mode-9 step
    n, level = MAIN_N, MAIN_LEVEL
    inputs = os.path.join(tmp, f"in{n}")
    state, storage, ingest_s = profile_step.sparse_galaxy(n, inputs,
                                                          device=DEVICE)
    assert storage == "sparse", storage
    m = model(n, level, f32, DEVICE)
    sm, plan_s = timed(lambda: step_amr.SparseMLModel.setup(m, 3))
    win, window_s = timed(lambda: sm._ensure_window(state))
    skip = profile_step.sparse_skip_share(sm, state)
    depth, depth_s = timed(lambda: sm.validate_coupling_depth(state))
    state, eq_s = timed(lambda: sm.initialize_equilibrium(state))
    mem = state.memory_bytes()
    nf0 = sm.neutral_fraction(state)
    print(f"[21 sparse] {n}^3 + 2 levels, the CLI's storage under "
          f"--amr-storage auto: {storage} ({state.n_leaves()} leaves, "
          f"blocks {[lv.n_blocks for lv in state.levels]} of 8^3, "
          f"memory_bytes {mem / 1e9:.3f} GB): ingested "
          f"(read_level_npz + sparse_from_level_lists onto the card) in "
          f"{ingest_s:.3f} s, compute_window {window_s:.3f} s (W "
          f"{None if win is None else win[0]}, skip share {skip:.4f}), plan "
          f"{plan_s:.3f} s, validate_coupling_depth {depth_s:.3f} s: depth "
          f"{depth}, equilibrium {eq_s:.3f} s; neutral fraction {nf0:.7f}")
    assert win is not None and win[0] < n
    # one mode-8 step with the galaxy's 12 sources at maxPixelLevel 6 as
    # the CLI prepares them, layer by layer: the tracer (its device and
    # host ms, march steps) and then mode 9's layers on the traced state
    # (the sweep reads the species alone; a separate mode-9 step would
    # sweep the same opacities once more)
    ctx, src_s = timed(lambda: profile_step.galaxy_sources(
        inputs, state, m.geom, device=DEVICE))
    sm8 = dataclasses.replace(sm, rt=model(n, level, f32, DEVICE, mode8))
    torch.cuda.reset_peak_memory_stats()
    (s8, rows8, march), step8_s = timed(lambda: profile_step.sparse_layers(
        sm8, state, stellar=ctx))
    peak8 = torch.cuda.max_memory_allocated() / 2 ** 30
    nf8 = sm8.neutral_fraction(s8)
    tr_ms = rows8["tracer"][0]
    rows = {k: v for k, v in rows8.items() if k != "tracer"}
    # derived, not a measured mode-9 step: the mode-8 step's seconds
    # less its tracer's host ms
    mode9_layers_s = step8_s - rows8["tracer"][1] / 1e3
    print(f"[21 sparse] {n}^3 + 2 levels x 192 f32 block-sparse mode-8 "
          f"step, depth {depth}, {ctx.sources.n_sources} sources (prepared "
          f"as the CLI does in {src_s:.3f} s), maxPixelLevel "
          f"{ctx.max_pixel_level}: {step8_s:.3f} s, layers (device ms by "
          "CUDA events / host ms to enqueue): " + ", ".join(
              f"{k} {ms:.3f} / {h:.3f}" for k, (ms, h, _) in rows8.items())
          + f"; the tracer {march} march steps ({tr_ms / march:.3f} ms a "
          f"step); mode 9's layers (all but the tracer; derived) "
          f"{mode9_layers_s:.3f} s; "
          f"neutral fraction {nf0:.7f} -> {nf8:.7f}; peak device memory "
          f"{peak8:.3f} GiB (the dense L-level mode-9 step 43.28 GiB, "
          f"PERF.md); {smi}")
    assert np.isfinite(nf8) and 0.0 < nf8 < nf0, (nf0, nf8)
    assert all(bool(torch.isfinite(getattr(f, k)).all()) for f in
               [s8.base] + [lv.fields for lv in s8.levels]
               for k in names + ("krate24",))
    assert all(float(f.krate24.max()) > 0.0 for f in
               [s8.base] + [lv.fields for lv in s8.levels])
    assert peak8 < 43.0, peak8
    del s8
    inputs_b, batch = profile_step.sparse_first_batch(sm, state)
    wall, busy, launches8, slabs, _ = profile_step.sparse_slab_window(
        sm, inputs_b, True, 8)
    del inputs_b
    print(f"[21 sparse] the first zone batch's sweep ({len(batch)} zones of "
          f"{batch[0].ndir} directions), covered base slabs "
          f"{slabs.start}-{slabs.stop - 1} at full width: wall "
          f"{wall * 1e3:.3f} ms, device busy {busy * 1e3:.3f} ms "
          f"({100 * busy / wall:.1f}%), {launches8} launches")
    sm6 = step_amr.SparseMLModel.setup(
        model(n, level, f32, DEVICE, mode=MODE_NO_STARS_THIN_UVB), 3)
    assert sm6.plan is None
    (s6, rows6, _), step6_s = timed(lambda: profile_step.sparse_layers(
        sm6, state))
    nf6 = sm6.neutral_fraction(s6)
    print(f"[21 sparse] {n}^3 + 2 levels f32 block-sparse mode-6 step (the "
          f"thin UVB, no sweep): {step6_s:.3f} s, layers (device ms / host "
          "ms): " + ", ".join(f"{k} {ms:.3f} / {h:.3f}"
                              for k, (ms, h, _) in rows6.items())
          + f"; neutral fraction {nf6:.7f}")
    assert np.isfinite(nf6) and 0.0 < nf6 < 1.0
    del s6, sm6
    # the tracer alone: its peak memory above the state's (the dense
    # form's finest int32 leaf-level volume and packed fields, which it
    # does not build, are the yardstick; most of it is the quadrature
    # deposit's (rays, frequencies) temporaries, which any form needs),
    # then in a profiler window
    s0 = sm8._zero_rates(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    box = [None]
    tr_wall, tr_busy, tr_events, _ = profile_step.profiled(
        lambda _: sm8.trace(s0, ctx), box, steps=1)
    trace_peak = torch.cuda.max_memory_allocated() - base_bytes
    _, rfs32, diag32 = box[0]
    trace_s = tr_wall
    dense_bytes = (n * 4) ** 3 * 4 + sum((n * 2 ** ell) ** 3
                                         for ell in range(3)) * 5 * 4
    del s0, box
    print(f"[21 sparse] the {n}^3 block-sparse tracer in a profiler window: "
          f"wall {tr_wall * 1e3:.3f} ms, device busy {tr_busy * 1e3:.3f} ms "
          f"({100 * tr_busy / tr_wall:.1f}%), {tr_events:.0f} device events "
          f"({tr_events / march:.1f} a march step); peak device memory "
          f"{trace_peak / 2 ** 30:.3f} GiB above the state's, against "
          f"{dense_bytes / 2 ** 30:.3f} GiB for the dense form's {4 * n}^3 "
          f"int32 leaf-level volume and packed fields alone")
    assert trace_peak < dense_bytes / 2, (trace_peak, dense_bytes)
    sm1 = dataclasses.replace(sm, rt=model(n, level, f32, DEVICE, mode1),
                              plan=None)
    (s1, diag1), step1_s = timed(lambda: sm1.make_step(ctx)(state))
    nf1 = sm1.neutral_fraction(s1)
    fesc1 = rays.escape_fractions(diag1, ctx.sources.weight)
    print(f"[21 sparse] {n}^3 f32 block-sparse mode-1 step (the tracer, "
          f"three chemistries, no sweep): {step1_s:.3f} s; neutral fraction "
          f"{nf0:.7f} -> {nf1:.7f}; escape fractions at the outer radius "
          f"{_fmt(fesc1[:, -1])}; {smi}")
    assert 0.0 < nf1 < nf0 and bool(np.isfinite(fesc1).all())
    del s1, sm1
    # a noneq step layer by layer, in mode 6: the networks (a mode-9 step
    # adds the sweep, whose layer the mode-8 step above times)
    sm6n = step_amr.SparseMLModel.setup(
        model(n, level, f32, DEVICE, mode=MODE_NO_STARS_THIN_UVB), 3)
    species = sm6n.initial_species(state)
    torch.cuda.reset_peak_memory_stats()
    (s9, sp9, rows9, _), step9_s = timed(
        lambda: profile_step.sparse_noneq_layers(sm6n, state, species))
    peak9 = torch.cuda.max_memory_allocated() / 2 ** 30
    nf9 = sm6n.neutral_fraction(s9)
    print(f"[21 sparse] {n}^3 + 2 levels f32 block-sparse noneq mode-6 step "
          f"(1 Myr, 200 substeps; a mode-9 step adds the mode-8 step's "
          f"sweep layer): {step9_s:.3f} s, layers (device ms "
          "/ host ms): " + ", ".join(f"{k} {ms:.3f} / {h:.3f}"
                                     for k, (ms, h, _) in rows9.items())
          + f"; neutral fraction {nf0:.7f} -> {nf9:.7f}; peak device memory "
          f"{peak9:.3f} GiB; {smi}")
    assert np.isfinite(nf9) and 0.0 < nf9 < 1.0
    assert all(bool(torch.isfinite(getattr(sp, k)).all())
               for sp in sp9 for k in ("HI", "H2I", "de", "eint"))
    # the noneq state and species, for phase 22's checkpoint at this cell
    out["noneq_cell"] = (s9, sp9, m.geom.physical_box_size)
    del s9, sp9, species
    # the float32 trace above (float32's default kills) against float64's
    # of the same state with the same kills: every level's six channels
    # within 5e-5 of each peak, the escape fractions within 1e-5
    ctx64 = profile_step.galaxy_sources(inputs, state, m.geom, dtype=f64,
                                        device=DEVICE)
    t64, trace64_s = timed(
        lambda: rays_multilevel.trace_point_sources_sparse(
            state, m.geom, ctx64.sources, ctx64.tables,
            dust_approximation=ctx64.dust_approximation,
            max_pixel_level=ctx64.max_pixel_level, dtype=f64,
            tau_kill=rays.default_tau_kill(f32),
            rel_kill=rays.default_rel_kill(f32)))
    err_levels = [rf_worst((a,), (b,)) for a, b in zip(rfs32, t64[0])]
    fesc32, fesc64 = (rays.escape_fractions(d, ctx.sources.weight)
                      for d in (diag32, t64[1]))
    fesc_err = float(np.abs(fesc32 - fesc64).max())
    print(f"[21 sparse] the {n}^3 block-sparse f32 trace ({trace_s:.3f} s) "
          f"against the f64 trace ({trace64_s:.3f} s), both with tau_kill "
          f"{rays.default_tau_kill(f32)} and rel_kill "
          f"{rays.default_rel_kill(f32)}: channels max diff by level "
          f"{_fmt(err_levels)} of each channel's peak (tol 5e-5), escape "
          f"fractions {fesc_err:.2e} (tol 1e-5)")
    assert max(err_levels) <= 5e-5 and fesc_err <= 1e-5, (err_levels,
                                                           fesc_err)
    del t64, ctx64, rfs32, diag32
    # the tracer's launches a march step, from two agreeing profiler
    # windows of a whole trace at an 8^3 base with its 12 sources
    launches_tr, march_s = profile_step.sparse_tracer_launches(8)
    per_step = launches_tr / march_s
    print(f"[21 sparse] the block-sparse tracer at an 8^3 base (3 levels, 12 "
          f"sources, maxPixelLevel 6): {launches_tr} launches in two "
          f"agreeing traces of {march_s} march steps, {per_step:.1f} a "
          f"march step")
    assert march_s > 0 and launches_tr > march_s
    assert _kernel_counts() == counts0, "the sparse step launched a kernel"
    out.update(ingest_s=ingest_s, window=None if win is None else win[0],
               skip_share=skip, depth=depth, depth_s=depth_s, plan_s=plan_s,
               mode9_layers_s=mode9_layers_s, layers=rows,
               memory_bytes=mem,
               batch_busy_share=busy / wall,
               launches8=launches8, mode6_s=step6_s, step8_s=step8_s,
               layers8=rows8, march=march, peak8_gib=peak8,
               trace_peak_gib=trace_peak / 2 ** 30,
               tracer_busy_share=tr_busy / tr_wall, mode1_s=step1_s,
               noneq9_s=step9_s, layers9=rows9, peak9_gib=peak9,
               trace_err=(*err_levels, fesc_err),
               launches_per_march_step=per_step)
    del state, sm, sm8, m, ctx

    # (c) phase 19's 64^3 cell, f32: the dense state block-sparse, the
    # windowed step against phase 19's dense step on covered cells (the
    # windowed and the full-plane sweeps are held to each other in (a));
    # with the galaxy's 12 sources, the block-sparse trace against the
    # dense one and a noneq mode-1 step (20 substeps) on either storage,
    # on covered cells
    if dense_cell is not None:
        ml, dstate, dstep = dense_cell
        sp, conv_s = timed(lambda: amr_sparse.sparse_from_dense(dstate))
        sm = step_amr.SparseMLModel.setup(ml.rt, 3)
        sm.n_coupling_iters = ml.n_coupling_iters
        sp1, sparse_s = timed(lambda: sm.make_step()(sp))
        err_d = worst_covered(amr_sparse.dense_from_sparse(sp1), dstep)
        print(f"[21 sparse] phase 19's {sp.n}^3 cell block-sparse "
              f"(converted in {conv_s:.3f} s; W {sm._window[0]}), f32 at "
              f"depth {sm.n_coupling_iters}: the windowed sparse step "
              f"{sparse_s:.3f} s against phase 19's dense step: species "
              f"and Jmean max diff on covered cells {err_d:.2e} of each "
              f"level's peak (tol 1e-5)")
        assert err_d <= 1e-5, err_d
        out.update(step64_err=err_d, step64_s=sparse_s)
        del sp1, dstep
        n64 = sp.n
        config64 = write_cli_inputs(os.path.join(tmp, f"in{n64}"), n64,
                                    refine_center=True, refine_core=True)
        levels64 = grid_io.read_level_npz(os.path.join(
            os.path.dirname(config64), "testgrid_velmet.npz"))
        m1 = model(n64, 1, f32, DEVICE, mode1)
        ctx = _cli_stellar(config64, levels64, sp, m1.geom, f32, DEVICE)
        ctxn = _cli_stellar(config64, levels64, sp, m1.geom, f32, DEVICE,
                            noneq=True)
        (rfs_s, diag_s), tr_s = timed(
            lambda: rays_multilevel.trace_point_sources_sparse(
                sp, m1.geom, ctx.sources, ctx.tables,
                dust_approximation=ctx.dust_approximation,
                max_pixel_level=ctx.max_pixel_level, dtype=f32))
        (rfs_d, diag_d), tr_d = timed(
            lambda: rays_multilevel.trace_point_sources_ml(
                dstate, m1.geom, ctx.sources, ctx.tables,
                dust_approximation=ctx.dust_approximation,
                max_pixel_level=ctx.max_pixel_level, dtype=f32))
        # each level's covered cells: (their flat index in the dense
        # level, in the block-sparse one); the base is all covered
        idx = [(torch.arange(n64 ** 3, device=DEVICE),) * 2]
        for ell, lv in enumerate(sp.levels, start=1):
            n_l, be = n64 * 2 ** ell, lv.be
            r = torch.arange(be, device=DEVICE)
            o = lv.origin.long()
            ix, iy, iz = (o[:, a, None, None, None] + r.reshape(
                [be if i == a else 1 for i in range(3)]) for a in range(3))
            flat = (ix * n_l + iy) * n_l + iz
            c = lv.cover
            idx.append((flat[c], c.reshape(-1).nonzero().squeeze(1)))

        def covered_rel(a, b, ell):
            """rel of a level's block-sparse a and dense b on its covered
            cells."""
            d_idx, s_idx = idx[ell]
            return rel(a.reshape(-1)[s_idx], b.reshape(-1)[d_idx].to(a))

        err_tr = max(covered_rel(getattr(a, k), getattr(b, k), ell)
                     for ell, (a, b) in enumerate(zip(rfs_s, rfs_d))
                     for k in channels)
        err_tr = max(err_tr, diag_worst(diag_s, diag_d))
        dense_m = step_amr.MultiLevelModel.setup(m1, 3)
        sparse_m = step_amr.SparseMLModel.setup(m1, 3)
        sp_d = tuple(chemistry_noneq.species_from_field_state(lv)
                     for lv in dstate.levels)
        (d1, spd1, _), noneq_d_s = timed(lambda: dense_m.make_noneq_step(
            MYR, ctxn, n_substeps=20)(dstate, sp_d))
        (s1, sps1, _), noneq_s_s = timed(lambda: sparse_m.make_noneq_step(
            MYR, ctxn, n_substeps=20)(sp, sparse_m.initial_species(sp)))
        fs = [s1.base] + [lv.fields for lv in s1.levels]
        err_n = max(
            covered_rel(getattr(a, k), getattr(b, k), ell)
            for ell, (fa, fd, sa, sd) in enumerate(zip(
                fs, d1.levels, sps1, spd1))
            for a, b, keys in ((fa, fd, ("HI", "HeI", "HeII", "krate24")),
                               (sa, sd, chemistry_noneq.SPECIES))
            for k in keys)
        print(f"[21 sparse] phase 19's {n64}^3 cell with its "
              f"{ctx.sources.n_sources} sources at maxPixelLevel "
              f"{ctx.max_pixel_level}, f32: the block-sparse trace "
              f"({tr_s:.3f} s) against the dense one ({tr_d:.3f} s): every "
              f"channel on every level's covered cells and the diagnostics "
              f"max diff {err_tr:.2e} of each peak (tol 1e-5); a noneq "
              f"mode-1 step (20 substeps) block-sparse ({noneq_s_s:.3f} s) "
              f"against dense ({noneq_d_s:.3f} s): fields and species max "
              f"diff on covered cells {err_n:.2e} of each peak (tol 1e-5)")
        assert err_tr <= 1e-5 and err_n <= 1e-5, (err_tr, err_n)
        out.update(trace64_err=err_tr, noneq64_err=err_n,
                   trace64_s=(tr_s, tr_d), noneq64_s=(noneq_s_s, noneq_d_s))
        del sp, dense_cell, dstate, rfs_s, rfs_d, d1, s1, spd1, sps1, sp_d

    # (d) mode 6 through the CLI, 2 iterations
    d6 = os.path.join(tmp, "sparse6")
    config6 = _config_variant(config, os.path.join(tmp, "mode6.cfg"), mode=6)
    out6, call6 = _cli(config6, d6, "--iters", "2", *sparse, tag="21 sparse")
    assert "coupling depth" not in out6 and list(_time_log(d6)) == [1, 2]
    print(f"[21 sparse] CLI mode 6 on the block-sparse {n_cli}^3 grid: call "
          f"{call6:.3f} s")
    assert _kernel_counts() == counts0, "the sparse CLI launched a kernel"
    phase_s = time.perf_counter() - t_phase
    print(f"[21 sparse] phase 21: {phase_s:.1f} s; {smi}")
    _print_windows("21 sparse", "phases 17 to 21")
    out.update(cli_dts=dts, cli_call_s=call9, restart_s=restart_s,
               cli_call6_s=call6, cli=cli_runs, phase_s=phase_s)
    return out


def phase_last_features(smi: str, noneq_cell=None) -> dict:
    """22: the single-card CLI's last features -- the compacting tracer
    (rays.trace_point_sources_compact), --debug-checkify (core/debug.py),
    --ckpt-format orbax (io/checkpoint.py) and .h4 grids (io/convert.py,
    io/hdf4.py); plain PyTorch and host code, no kernel of their own.
    noneq_cell: phase 21's block-sparse 128^3 (state, species, box) after
    its noneq step, for (c)'s checkpoint at the production cell."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        return _phase_last_features(tmp, smi, noneq_cell)


def _phase_last_features(tmp: str, smi: str, noneq_cell) -> dict:
    """phase_last_features's checks, with `tmp` a directory of their
    own."""
    import radiativetransfer_tpu_torch as rt
    from radiativetransfer_tpu_torch import cli, profile_step
    from radiativetransfer_tpu_torch.bench import bench_sources
    from radiativetransfer_tpu_torch.core import rays, sweep_cluster
    from radiativetransfer_tpu_torch.io import checkpoint, convert, grid_io
    from radiativetransfer_tpu_torch.tables import stellar
    t_phase = time.perf_counter()
    launches = {}
    out = {"launches": launches}

    def rel(x, y):
        d = float((x - y).abs().max())
        peak = float(y.abs().max())
        return d / peak if peak else float(x.abs().max())

    # (a) the compacting tracer against the default one at phase 9's cell
    # (bench_step: 128^3 x 192, 8 sources, maxPixelLevel 6, f32), on the
    # state of one default mode-8 step from the neutral box
    n, level, box = MAIN_N, MAIN_LEVEL, 2000.0
    pos = bench_sources(n, MODE8_SOURCES).position
    pop = stellar.blackbody_population(q_ionizing=1.0e51)
    model, ctx = _mode8_model(n, level, box, MODE8_SOURCES, pos, pop, 6)
    _zero_sweep_launches()
    state, _ = model.make_step(ctx)(rt.uniform_state(
        n, nh=2e-4, tgas=1.5e4, dtype=torch.float32, device=DEVICE))
    launches["compact_cell"] = sweep_cluster.LAUNCHES
    assert launches["compact_cell"] == 1
    s0 = state.zero_rates()
    del state
    counts0 = _kernel_counts()

    def trace(compact):
        tracer = (rays.trace_point_sources_compact if compact
                  else rays.trace_point_sources)
        return tracer(s0, model.geom, ctx.sources, ctx.tables,
                      max_pixel_level=ctx.max_pixel_level,
                      dtype=torch.float32)

    turns, traces = [], {}
    for compact in (False, True, True, False):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        steps0 = rays.MARCH_STEPS
        t0 = time.perf_counter()
        rf, diag = trace(compact)
        torch.cuda.synchronize()
        turns.append({
            "compact": compact, "ms": (time.perf_counter() - t0) * 1e3,
            "march_steps": rays.MARCH_STEPS - steps0,
            "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30,
            "buckets": list(rays.LAST_COMPACT_BUCKETS) if compact else None})
        traces.setdefault(compact, (rf, diag))
        del rf, diag
    name = {False: "default", True: "compact"}
    for t in turns:
        print(f"[22 last] {n}^3 x {MODE8_SOURCES} sources, maxPixelLevel "
              f"{ctx.max_pixel_level}, f32, {name[t['compact']]} tracer: "
              f"{t['ms']:.3f} ms, {t['march_steps']} march steps, peak "
              f"{t['peak_gib']:.3f} GiB above the state"
              + (f", final-phase buffers {t['buckets']}" if t["compact"]
                 else ""))
    (rf_d, dg_d), (rf_c, dg_c) = traces[False], traces[True]
    err_rf = max(rel(getattr(rf_c, f.name), getattr(rf_d, f.name))
                 for f in dataclasses.fields(rays.RateFields))
    err_dg = max(rel(getattr(dg_c, f.name), getattr(dg_d, f.name))
                 for f in dataclasses.fields(dg_d))
    del traces, rf_d, dg_d, rf_c, dg_c
    profile = {}
    for compact in (False, True):
        march = next(t["march_steps"] for t in turns
                     if t["compact"] == compact)
        wall, busy, events, _ = profile_step.profiled(
            lambda _, c=compact: trace(c), [None], steps=1)
        profile[compact] = {"busy_share": busy / wall,
                            "events_per_march_step": events / march}
        print(f"[22 last] {name[compact]} tracer in a profiler window: "
              f"{wall * 1e3:.3f} ms, busy {100 * busy / wall:.1f}%, "
              f"{events:.0f} device events, {events / march:.1f} a march "
              f"step")
    print(f"[22 last] the compacting tracer's deposits against the default "
          f"tracer's: {err_rf:.2e} of each channel's peak, the diagnostics "
          f"{err_dg:.2e} (tol 1e-5; the scatter order alone differs); "
          f"{smi}")
    assert err_rf <= 1e-5 and err_dg <= 1e-5, (err_rf, err_dg)
    assert all(t["buckets"][0] == MODE8_SOURCES * 12 * 4 ** 5
               for t in turns if t["compact"])
    assert _kernel_counts() == counts0, "the tracers launched a kernel"
    del s0, model, ctx
    out["compact"] = {"turns": turns, "profile": profile,
                      "max_err": max(err_rf, err_dg)}

    # (b) --debug-checkify through the CLI, once before the loop: the
    # pre-flight's seconds (cli._preflight timed in this process), the
    # JAX CLI's line; a grid with a NaN, through python -m in a process
    # of its own beside the rest, must exit non-zero naming the op
    poison = os.path.join(tmp, "poison")
    config_p = write_cli_inputs(poison, 16)
    grid = os.path.join(poison, "testgrid_velmet.npz")
    levels = grid_io.read_level_npz(grid)
    levels[0].lT[5] = np.nan
    grid_io.write_level_npz(grid, levels)
    poisoned = _CliProcess([config_p, "--snapshot-dir", poison, "--iters",
                            "1", "--debug-checkify"])
    preflight_s = {}
    plain_preflight = cli._preflight

    def timed_preflight(storage, *args):
        t0 = time.perf_counter()
        plain_preflight(storage, *args)
        torch.cuda.synchronize()
        preflight_s[storage] = time.perf_counter() - t0

    lines = {
        "uniform": "checkify pre-flight passed (bounds/NaN/division clean "
                   "on the ingested data)",
        "amr": "checkify pre-flight passed on two-level AMR storage",
        "ml": "checkify pre-flight passed on multilevel storage",
        "sparse": "checkify pre-flight passed on block-sparse storage "
                  "(slot-map/padding-block bounds, NaN/Inf, division clean "
                  "on the ingested data)"}
    n_cli = ML_CLI_N
    # at 64^3: the 128^3 pre-flight took 16.6-29.6 s (PERF.md section 4)
    config_u = write_cli_inputs(os.path.join(tmp, "uniform"), n // 2,
                                mode=8)
    config_two = write_cli_inputs(os.path.join(tmp, "two"), n_cli,
                                  refine_center=True)
    config_ml = write_cli_inputs(os.path.join(tmp, "ml"), n_cli,
                                 refine_center=True, refine_core=True)
    level1 = ("--angular-level", "1", "--coupling-depth", "2")
    # the uniform run checkpoints (--ckpt-format orbax) in place of its
    # cellArray snapshot
    runs = {"uniform": (config_u, ("--ckpt-format", "orbax")),
            "amr": (config_two, level1),
            "ml": (config_ml, level1),
            "sparse": (config_ml, level1 + ("--amr-storage", "sparse"))}
    logs = {}
    cli._preflight = timed_preflight
    try:
        for storage, (config, flags) in runs.items():
            d = os.path.join(tmp, f"checkify_{storage}")
            _zero_sweep_launches()
            text, call_s = _cli(config, d, "--iters", "1",
                                "--debug-checkify", *flags, tag="22 last")
            if storage == "uniform":
                launches["cli_checkify"] = sweep_cluster.LAUNCHES
                assert launches["cli_checkify"] == 1
            else:
                assert sweep_cluster.LAUNCHES == 0
            assert text.splitlines().count(lines[storage]) == 1, storage
            logs[storage] = (_time_log(d), text)
            grid_line = next(x for x in text.splitlines()
                             if x.startswith("grid: "))
            print(f"[22 last] --debug-checkify on the {storage} grid "
                  f"({grid_line}): the pre-flight {preflight_s[storage]:.3f} "
                  f"s of the call's {call_s:.3f} s")
    finally:
        cli._preflight = plain_preflight
    out["preflight_s"] = preflight_s

    # (c) --ckpt-format orbax on the 32^3 block-sparse grid, level 1: three
    # iterations, and a restart from their ckpt0002 to a third, within
    # 1e-4 of the uninterrupted run's
    sparse = ("--amr-storage", "sparse", "--ckpt-format", "orbax",
              *level1)
    d_full, d_re = os.path.join(tmp, "orbax3"), os.path.join(tmp, "orbax_re")
    _, full_s = _cli(config_ml, d_full, "--iters", "3", *sparse,
                     tag="22 last")
    assert sorted(x for x in os.listdir(d_full) if x.startswith("ckpt")) \
        == ["ckpt0001", "ckpt0002", "ckpt0003"]
    assert not any(x.startswith("cellArray") for x in os.listdir(d_full))
    os.makedirs(d_re)
    for it in (1, 2):
        shutil.copytree(checkpoint.checkpoint_name(it, d_full),
                        checkpoint.checkpoint_name(it, d_re))
    config_re = _config_variant(config_ml, os.path.join(tmp, "re.cfg"),
                                restart=1)
    text, re_s = _cli(config_re, d_re, "--iters", "1", *sparse,
                      tag="22 last")
    assert (f"restarted from {checkpoint.checkpoint_name(2, d_re)} at "
            f"itime=2") in text
    log_full, log_re = _time_log(d_full), _time_log(d_re)
    nf_err = abs(log_re[3] - log_full[3]) / log_full[3]
    a, b = (torch.load(os.path.join(checkpoint.checkpoint_name(3, d),
                                    "leaves_rank0.pt"), weights_only=True)
            for d in (d_full, d_re))
    assert a.keys() == b.keys()
    field_err = max(rel(b[k].double(), a[k].double()) for k in a
                    if a[k].is_floating_point())
    print(f"[22 last] --ckpt-format orbax on the block-sparse {n_cli}^3 "
          f"grid: 3 iterations {full_s:.3f} s, the restart from ckpt0002 "
          f"{re_s:.3f} s; itime 3 {log_re[3]:.8f} against {log_full[3]:.8f}"
          f" (rel {nf_err:.2e}), every checkpointed field within "
          f"{field_err:.2e} of its peak (tol 1e-4)")
    assert nf_err <= 1e-4 and field_err <= 1e-4, (nf_err, field_err)
    out["orbax_restart_err"] = max(nf_err, field_err)
    if noneq_cell is not None:
        # the checkpoint of phase 21's 128^3 noneq state with its species
        sp_state, species, box_cm = noneq_cell
        path = checkpoint.checkpoint_name(1, os.path.join(tmp, "ckpt128"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.save_sharded(path, (sp_state, species), 1, box_cm)
        write_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(path, x))
                     for x in os.listdir(path))
        t0 = time.perf_counter()
        back, meta = checkpoint.restore_sharded(path, (sp_state, species))
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        same = all(torch.equal(x, y) for x, y in zip(
            checkpoint.flatten(back).values(),
            checkpoint.flatten((sp_state, species)).values()))
        print(f"[22 last] the checkpoint of the {MAIN_N}^3 block-sparse "
              f"noneq state with its species (phase 21 (b)): written in "
              f"{write_s:.3f} s, {nbytes / 1e6:.1f} MB, restored in "
              f"{read_s:.3f} s, every tensor equal: {same}")
        assert same and meta["itime"] == 1
        out["ckpt128"] = {"write_s": write_s, "bytes": nbytes,
                          "read_s": read_s}
        del back, noneq_cell, sp_state, species

    # (d) the .h4 path: (b)'s two-level 32^3 grid converted with
    # convert.npz2h4, run by the CLI, its log (b)'s
    h4_dir = os.path.join(tmp, "h4")
    config_h4 = write_cli_inputs(h4_dir, n_cli, refine_center=True)
    npz = os.path.join(h4_dir, "testgrid_velmet.npz")
    with contextlib.redirect_stdout(io.StringIO()):
        convert.npz2h4(npz, os.path.join(h4_dir, "testgrid_velmet.h4"))
    os.remove(npz)
    d = os.path.join(tmp, "h4_run")
    text, h4_s = _cli(config_h4, d, "--iters", "1", *level1, tag="22 last")
    ref_log, ref_text = logs["amr"]

    def shown(x):
        return [ln.split(" dt=")[0] for ln in x.splitlines()
                if ln.startswith(("grid: ", "itime="))]
    h4_err = abs(_time_log(d)[1] - ref_log[1]) / ref_log[1]
    print(f"[22 last] the two-level {n_cli}^3 grid as .h4: call {h4_s:.3f} "
          f"s, its grid: and itime= lines those of the .npz run, itime 1 "
          f"rel {h4_err:.2e}")
    assert shown(text) == shown(ref_text), (shown(text), shown(ref_text))
    assert h4_err <= 1e-6, h4_err

    rc, stdout, stderr, poison_s = poisoned.result()
    last_line = stderr.strip().splitlines()[-1] if stderr.strip() else ""
    print(f"[22 last] the 16^3 grid with a NaN under --debug-checkify "
          f"through python -m: exit code {rc} after {poison_s:.3f} s, "
          f"{last_line!r}")
    assert rc != 0 and "FloatingPointError: nan generated by op" in \
        last_line and "itime=" not in stdout, (rc, last_line)
    # every count held since (a) but the uniform CLI run's (counted above,
    # then zeroed before the nested runs, which launched none)
    assert _kernel_counts() == dict(counts0, sweep_cluster=0)
    phase_s = time.perf_counter() - t_phase
    print(f"[22 last] phase 22: {phase_s:.1f} s; {smi}")
    out["phase_s"] = phase_s
    return out


def phase_dist(smi: str, sparse_state=None) -> dict:
    """23: the source-parallel tracers on P = 4 ranks of the card and the
    nested states on a mesh (parallel/rays_dist.py, parallel/mesh.py's
    nested shard functions, sweep_dist.diffuse_sweep_sparse_zones): plain
    PyTorch, but for (b)'s two steps, which launch the cluster kernel
    (one device) and the cluster ring (the mesh).  sparse_state: a
    block-sparse state for (d); None builds the galaxy's at 64^3 (at phase
    21's 128^3 cell the one-device sweep alone takes ~13 s, over the
    phase's budget with the zones sweep beside it)."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        return _phase_dist(tmp, smi, sparse_state)


def _phase_dist(tmp: str, smi: str, sparse_state) -> dict:
    """phase_dist's checks, with `tmp` a directory of their own."""
    import radiativetransfer_tpu_torch as rt
    from radiativetransfer_tpu_torch import profile_step
    from radiativetransfer_tpu_torch.bench import bench_sources
    from radiativetransfer_tpu_torch.constants import KPC
    from radiativetransfer_tpu_torch.core import (
        rays,
        step_amr,
        sweep_cluster,
        sweep_sparse,
    )
    from radiativetransfer_tpu_torch.parallel import mesh as pmesh
    from radiativetransfer_tpu_torch.parallel import (
        rays_dist,
        sweep_dist,
        sweep_rdma,
    )
    from radiativetransfer_tpu_torch.tables import stellar
    t_phase = time.perf_counter()
    p = 4
    mesh = pmesh.make_grid_mesh(p, device=DEVICE)
    launches = {}
    out = {"launches": launches}

    def rel(x, y):
        d = float((x.to(y) - y).abs().max())
        peak = float(y.abs().max())
        return d / peak if peak else float(x.abs().max())

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, time.perf_counter() - t0

    # (b) the uniform mode-8 step at phase 9's cell (bench_step: 128^3 x
    # 192, 8 sources, maxPixelLevel 6, f32) from the neutral box, on one
    # device (the cluster kernel) and on the 4-rank mesh under the rdma
    # strategy: the source-parallel tracer, then the cluster ring (#3)
    n, level, box = MAIN_N, MAIN_LEVEL, 2000.0
    pos = bench_sources(n, MODE8_SOURCES).position
    pop = stellar.blackbody_population(q_ionizing=1.0e51)
    # the exact logmean on one device, as the ring's (phase 15: the
    # clamped form moves Jmean 1.64e-4 of a band's peak)
    model, ctx = _mode8_model(n, level, box, MODE8_SOURCES, pos, pop, 6,
                              sweep_logmean="exact")
    model_r, _ = _mode8_model(n, level, box, MODE8_SOURCES, pos, pop, 6,
                              sweep_strategy="rdma")
    box0 = rt.uniform_state(n, nh=2e-4, tgas=1.5e4, dtype=torch.float32,
                            device=DEVICE)
    _zero_sweep_launches()
    (one, _), one_s = timed(lambda: model.make_step(ctx)(box0))
    # the same sweep on the mesh: the tracer alone differs
    (same, _), same_s = timed(lambda: model.make_step(ctx, mesh=mesh)(
        pmesh.shard_state(box0, mesh)))
    launches["dist_one_device"] = sweep_cluster.LAUNCHES
    assert launches["dist_one_device"] == 2
    sweep_rdma.RING_LAUNCHES = sweep_rdma.RDMA_LAUNCHES = 0
    (two, _), mesh_s = timed(lambda: model_r.make_step(ctx, mesh=mesh)(
        pmesh.shard_state(box0, mesh)))
    out["ring"], out["plane_ring"] = (sweep_rdma.RING_LAUNCHES,
                                      sweep_rdma.RDMA_LAUNCHES)
    assert out["ring"] + out["plane_ring"] == len(model.sweep_plan.zones)
    assert sweep_cluster.LAUNCHES == 2
    fields = ("HI", "HeI", "HeII", "tgas", "Jmean", "krate24", "crate24",
              "krate26")
    errs = {k: (rel(getattr(same, k), getattr(one, k)),
                rel(getattr(two, k), getattr(one, k))) for k in fields}

    def flipped(x, k):
        """The cells whose k differs from the one-device step's by more
        than 1e-4 of its peak."""
        y = getattr(one, k)
        return int(((getattr(x, k) - y).abs() > 1e-4 * y.abs().max()).sum())
    flips = {k: (flipped(same, k), flipped(two, k)) for k in ("HeI", "HeII")}
    nf = [model.neutral_fraction(x) for x in (one, same, two)]
    nf_rel = [abs(x - nf[0]) / nf[0] for x in nf[1:]]
    print(f"[23 dist] {n}^3 x 192 f32 mode-8 step, {MODE8_SOURCES} "
          f"sources at maxPixelLevel 6, exact logmean: one device "
          f"{one_s:.3f} s; {p} ranks, the source-parallel tracer and the "
          f"one-device sweep (1 cluster launch) {same_s:.3f} s, under rdma "
          f"({out['ring']} cluster ring and {out['plane_ring']} plane ring "
          f"launches) {mesh_s:.3f} s; each field's max diff over its peak "
          f"against the one-device step (tracer only / tracer and ring): "
          + ", ".join(f"{k} {a:.2e} / {b:.2e}" for k, (a, b) in errs.items())
          + f"; cells off by more than 1e-4 of the peak: "
          + ", ".join(f"{k} {a} / {b}" for k, (a, b) in flips.items())
          + f" of {n ** 3}; neutral fraction {nf[0]:.7f}, rel "
          f"{nf_rel[0]:.2e} / {nf_rel[1]:.2e} (tol 1e-4 but for HeI and "
          f"HeII)")
    out["step_errs"], out["step_flips"] = errs, flips
    # the float32 equilibrium's helium moves at isolated cells where an
    # input moves by ~1e-7 (the deposits' scatter order, the ring's
    # Jmean): held are the transport products, HI and the neutral fraction
    assert max(max(errs[k]) for k in fields
               if k not in ("HeI", "HeII")) <= 1e-4, errs
    assert max(nf_rel) <= 1e-4, nf_rel
    s0 = one.zero_rates()
    del one, same, two, box0, model_r
    counts0 = _kernel_counts()

    # (a) the source-parallel tracer against the single-device one at
    # that cell, on the state of the one-device step, in turns
    def trace(ranks):
        if ranks is None:
            return rays.trace_point_sources(
                s0, model.geom, ctx.sources, ctx.tables,
                max_pixel_level=ctx.max_pixel_level, dtype=torch.float32)
        m = pmesh.make_grid_mesh(ranks, device=DEVICE)
        return rays_dist.trace_point_sources_dist(
            s0, model.geom, ctx.sources, ctx.tables, m,
            max_pixel_level=ctx.max_pixel_level, dtype=torch.float32)

    turns, traces = [], {}
    for ranks in (None, p, p, None):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        steps0 = rays.MARCH_STEPS
        (rf, diag), s = timed(lambda: trace(ranks))
        turns.append({
            "ranks": ranks or 1, "dist": ranks is not None, "ms": s * 1e3,
            "march_steps": rays.MARCH_STEPS - steps0,
            "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30})
        traces.setdefault(ranks, (rf, diag))
        del rf, diag
    name = {False: "single-device", True: f"source-parallel ({p} ranks)"}
    for t in turns:
        print(f"[23 dist] {n}^3 x {MODE8_SOURCES} sources, maxPixelLevel "
              f"{ctx.max_pixel_level}, f32, the {name[t['dist']]} tracer: "
              f"{t['ms']:.3f} ms, {t['march_steps']} march steps, peak "
              f"{t['peak_gib']:.3f} GiB above the state")
    (rf_1, dg_1), (rf_p, dg_p) = traces[None], traces[p]
    err_rf = max(rel(getattr(rf_p, f.name), getattr(rf_1, f.name))
                 for f in dataclasses.fields(rays.RateFields))
    err_dg = max(rel(getattr(dg_p, f.name), getattr(dg_1, f.name))
                 for f in dataclasses.fields(dg_1))
    del traces, rf_p, dg_p
    profile = {}
    for dist in (False, True):
        march = next(t["march_steps"] for t in turns if t["dist"] == dist)
        wall, busy, events, _ = profile_step.profiled(
            lambda _, d=dist: trace(p if d else None), [None], steps=1)
        profile[dist] = {"busy_share": busy / wall,
                         "events_per_march_step": events / march}
        print(f"[23 dist] the {name[dist]} tracer in a profiler window: "
              f"{wall * 1e3:.3f} ms, busy {100 * busy / wall:.1f}%, "
              f"{events:.0f} device events, {events / march:.1f} a march "
              f"step")
    # one rank: the single-device trace itself; the deposits' atomic adds
    # run in one order in both under the deterministic algorithms
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        rf_a, dg_a = trace(None)
        rf_b, dg_b = trace(1)
    finally:
        torch.use_deterministic_algorithms(False)
    same = all(torch.equal(getattr(x, f.name), getattr(y, f.name))
               for x, y in ((rf_a, rf_b), (dg_a, dg_b))
               for f in dataclasses.fields(x))
    print(f"[23 dist] the source-parallel tracer's deposits against the "
          f"single-device tracer's: {err_rf:.2e} of each channel's peak, the "
          f"diagnostics {err_dg:.2e} (tol 1e-5; the scatter order alone "
          f"differs); on one rank bit for bit the single-device trace: "
          f"{same}; {smi}")
    assert err_rf <= 1e-5 and err_dg <= 1e-5, (err_rf, err_dg)
    assert same
    del rf_1, dg_1, rf_a, dg_a, rf_b, dg_b, s0, model, ctx
    out["tracer"] = {"turns": turns, "profile": profile,
                     "max_err": max(err_rf, err_dg)}

    # (c) --mesh-shape 4 through the CLI on the 32^3 two-level, L-level
    # and block-sparse grids in mode 8 (the galaxy's 12 sources at
    # maxPixelLevel 4) and a noneq mode-8 iteration on the L-level grid,
    # angular level 1, each against the same run without a mesh through
    # python -m in a process of its own beside the rest
    n_cli = ML_CLI_N
    config_two = write_cli_inputs(os.path.join(tmp, "two"), n_cli, mode=8,
                                  refine_center=True)
    config_ml = write_cli_inputs(os.path.join(tmp, "ml"), n_cli, mode=8,
                                 refine_center=True, refine_core=True)
    flags = ("--iters", "1", "--angular-level", "1", "--coupling-depth",
             "2", "--max-pixel-level", "4")
    runs = {"two_level": (config_two, ()), "ml": (config_ml, ()),
            "sparse": (config_ml, ("--amr-storage", "sparse")),
            "ml_noneq": (config_ml, ("--chemistry", "noneq"))}
    plain = {}
    for k, (config, extra) in runs.items():
        os.makedirs(os.path.join(tmp, f"{k}_plain"))
        plain[k] = _CliProcess([config, "--snapshot-dir",
                                os.path.join(tmp, f"{k}_plain"), *flags,
                                *extra])
    cli_out = {}
    for k, (config, extra) in runs.items():
        d = os.path.join(tmp, f"{k}_mesh")
        text, call_s = _cli(config, d, *flags, *extra, "--mesh-shape",
                            str(p), tag="23 dist")
        assert f"device mesh: {{'gz': {p}}} strategy = auto" in text
        cli_out[k] = (_time_log(d), call_s)
    errs = {}
    for k, proc in plain.items():
        rc, stdout, stderr, proc_s = proc.result()
        assert rc == 0, (k, stderr[-2000:])
        log_p = _time_log(os.path.join(tmp, f"{k}_plain"))
        log_m, call_s = cli_out[k]
        errs[k] = abs(log_m[1] - log_p[1]) / log_p[1]
        print(f"[23 dist] the CLI's {k} run on {n_cli}^3 at level 1: "
              f"--mesh-shape {p} {call_s:.3f} s (this process), without a "
              f"mesh {proc_s:.3f} s (python -m); itime 1 {log_m[1]:.8f} "
              f"against {log_p[1]:.8f} (rel {errs[k]:.2e}, tol 1e-4)")
    assert max(errs.values()) <= 1e-4, errs
    out["cli"] = {k: (cli_out[k][1], errs[k]) for k in runs}
    assert _kernel_counts() == counts0, "the nested mesh runs launched a kernel"

    # (d) diffuse_sweep_sparse_zones on phase 21's block-sparse 128^3 cell
    # x 192 against the one-device sparse sweep: Jmean within 1e-5 of
    # each band's peak on every level
    if sparse_state is None:
        inputs = os.path.join(tmp, "sparse64")
        sparse_state, _, _ = profile_step.sparse_galaxy(64, inputs,
                                                        device=DEVICE)
    ns = sparse_state.n
    cfg = rt.RunConfig(mode=9, current_redshift=6.55,
                       n_angular_level=MAIN_LEVEL, reionization_model=10,
                       self_shielding_threshold_kpc=0.1)
    sm = step_amr.SparseMLModel.setup(rt.RTModel.setup(
        cfg, rt.GridGeometry(ns, ns, ns, 300.0 * KPC),
        torch.float32, DEVICE), 3)
    sm.n_coupling_iters = 2
    k0, lv_k = sm._kappas(sparse_state)
    win = sm._ensure_window(sparse_state)
    args = (k0, lv_k, sparse_state, sm.plan, sm.rt.uvb,
            sm.rt.geom.cell_size)
    (j1, jb1), one_s = timed(lambda: sweep_sparse.diffuse_sweep_sparse(
        *args, n_coupling_iters=2, window=win))
    (jp, jbp), zones_s = timed(lambda: sweep_dist.diffuse_sweep_sparse_zones(
        *args, mesh, n_coupling_iters=2, window=win))
    err = max(rel(a[b], r[b]) for a, r in zip([jp, *jbp], [j1, *jb1])
              for b in range(3))
    print(f"[23 dist] diffuse_sweep_sparse_zones on the {ns}^3 block-sparse "
          f"cell x 192 (W {None if win is None else win[0]}, depth 2), f32: "
          f"{p} ranks {zones_s:.3f} s against the one-device sparse sweep's "
          f"{one_s:.3f} s; Jmean within {err:.2e} of each band's peak on "
          f"every level (tol 1e-5); {smi}")
    assert err <= 1e-5, err
    assert _kernel_counts() == counts0, "the zones sweep launched a kernel"
    out["zones"] = {"n": ns, "one_s": one_s, "zones_s": zones_s,
                    "max_err": err}
    del j1, jb1, jp, jbp, k0, lv_k, sparse_state
    phase_s = time.perf_counter() - t_phase
    print(f"[23 dist] phase 23: {phase_s:.1f} s; {smi}")
    out["phase_s"] = phase_s
    return out


def main() -> None:
    t_start = time.perf_counter()
    seconds = {}

    def timed_phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    smi = timed_phase(1, phase_probe)
    timed_phase(2, phase_build)
    errs = timed_phase(3, phase_kernel_vs_plain)
    timed_phase(4, phase_anchor)
    launches9 = timed_phase(5, phase_main_path)
    times = timed_phase(6, phase_timings)
    probes = timed_phase(7, phase_probes)
    timed_phase(8, phase_anchor8)
    launches8 = timed_phase(9, phase_mode8)
    bench_out = timed_phase(10, phase_bench)
    zones = timed_phase(11, phase_zones, smi)
    pair = timed_phase(12, phase_pair)
    variants = timed_phase(13, phase_variants)
    scatter = timed_phase(14, phase_scatter)
    mesh = timed_phase(15, phase_mesh, smi)
    cli = timed_phase(16, phase_cli, smi)
    noneq = timed_phase(17, phase_noneq, smi)
    amr_out = timed_phase(18, phase_amr, smi)
    ml_out = timed_phase(19, phase_ml, smi)
    timed_phase(20, phase_ml_sources, smi, ml_out["depth"])
    sparse_out = timed_phase(21, phase_sparse, smi, ml_out.pop("dense_cell"))
    last = timed_phase(22, phase_last_features, smi,
                       sparse_out.pop("noneq_cell"))
    dist = timed_phase(23, phase_dist, smi)
    print("[main] seconds by phase: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items())
        + f"; the script so far {time.perf_counter() - t_start:.1f} s")
    # the cluster sweep kernel's launches on each path that runs it, each
    # count set to 0 just before its path (the plane kernel's: phase 6);
    # the CLI's mesh runs take the ring's and the per-zone kernel's
    # instances, counted under their own names
    sweep_paths = {"mode9": launches9, "mode8": launches8,
                   "timing": times["launches"]["cluster"],
                   "roofline": probes["sweep_launches"],
                   "bench": bench_out["launches"]["sweep"],
                   "exp_sweep_pair": pair["sweep_launches"],
                   "exp_sweep_variants": variants["sweep_launches"],
                   **cli["launches"], **noneq["launches"],
                   "amr_uniform_check": amr_out["uniform_check_launches"],
                   "ml_uniform_check": ml_out["uniform_check_launches"],
                   **last["launches"], **dist["launches"]}
    assert all(v > 0 for v in sweep_paths.values()), sweep_paths
    assert times["launches"]["plane"] > 0
    line = _kernels_line(errs, times, probes, sweep_paths, bench_out)
    line += _new_kernels(zones, pair, variants, scatter, mesh, cli["mesh"],
                         noneq["mesh"], dist)
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


def _new_kernels(zones, pair, variants, scatter, mesh, cli_mesh,
                 noneq_mesh, dist) -> list:
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
        "launches": (zones["launches"] + mesh["zone_launches"]
                     + cli_mesh["zones"]["zone"]
                     + noneq_mesh["zones"]["zone"]),
        "launches_by_path": {"zones": zones["launches"],
                             "mode9_mesh_zones": mesh["zone_launches"],
                             "cli_mesh": cli_mesh["zones"]["zone"],
                             "cli_noneq_mesh": noneq_mesh["zones"]["zone"]},
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
    ring_paths = {**mesh["launches"], "cli_mesh": cli_mesh["rdma"]["ring"],
                  "cli_noneq_mesh": noneq_mesh["rdma"]["ring"],
                  "mode8_mesh": dist["ring"]}
    plane_ring_paths = dict(mesh["old_launches"])
    if dist["plane_ring"]:
        plane_ring_paths["mode8_mesh"] = dist["plane_ring"]

    def cluster_only(r):
        # a time under the cluster ring's name only where every zone took
        # it (elsewhere the path mixes in the plane ring's launches)
        return r["ms"] if r["zones_on_cluster"] == r["zones"] else None
    line.append({
        "name": "sweep_zone_ring_cluster", "route": "cuda",
        "source": "radiativetransfer_tpu_torch/csrc/sweep_cluster.cu",
        "replaces": "radiativetransfer_tpu/parallel/sweep_rdma.py:64",
        "launches": sum(ring_paths.values()),
        "launches_by_path": ring_paths,
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
        "launches": sum(plane_ring_paths.values()),
        "launches_by_path": plane_ring_paths,
        "max_abs_err": mesh["old_max_abs_err"], "ms": ring["old_ms"],
        "plain_ms": ring["plain_ms"], "bound_ms": mesh["bound"]["bound_ms"],
        "bound_by": mesh["bound"]["bound_by"], "library_ms": None,
        "f64_ms": mesh["full"]["f64"]["old_ms"],
        "p1_ms": mesh["full"][1]["old_ms"], "p2_ms": mesh["full"][2]["old_ms"],
        "n256_ms": mesh["full"]["big"]["old_ms"]})
    return line


if __name__ == "__main__":
    main()
