"""Command-line entry point: the `program pointTransfer` analog.

Counterpart of the JAX package's cli.py, with the same flags, the same
printed lines and the same files, so a run can be restarted by either
package and its log read by the same parser.  Run modes follow the
reference (equiSources.f90:65-67):
  1  point-source transfer + optically-thin UVB
  2  stellar/gas density PDFs (print and exit)
  3  projected metallicity map (write and exit)
  4  cell census (print and exit)
  6  no sources, optically-thin UVB only
  7  clumping factor (print and exit)
  8  point-source + diffuse UVB transfer
  9  diffuse UVB transfer only

Usage:
  python -m radiativetransfer_tpu_torch.cli [inputParameters|config.json]
      [--iters N] [--platform cuda|cpu] [--x64]
      [--chemistry noneq [--dt-myr X] [--evolve-energy]]

`--chemistry noneq` advances the non-equilibrium 9-species H/He/H2 network
(core/chemistry_noneq.py) by --dt-myr per iteration in place of the
equilibrium solve, and writes its species into every snapshot; a restart
continues them from the snapshot.

The run is on the card (`--platform cuda`, the default) or, when asked, on
the CPU; without a CUDA device a cuda run fails, it does not fall back to
the CPU.  A mesh (`--mesh-shape P` or an explicit `--sweep-strategy`) is P
virtual ranks on that one device (parallel/mesh.py); the JAX CLI spreads
its mesh over every device it sees.  On a mesh the point sources are traced
source-parallel (`--tracer-strategy sources`, parallel/rays_dist.py) on
every storage; a uniform grid sweeps by the strategy, a two-level or
L-level grid sweeps as without a mesh (the JAX CLI's GSPMD partitioning),
and a block-sparse grid sweeps angle-decomposed
(parallel/sweep_dist.py::diffuse_sweep_sparse_zones).

A grid of two data levels (or more, under `--amr-depth 2`, the deeper
levels averaged onto the second) runs as two-level AMR
(core/step_amr.py::AMRModel) in modes 9, 8, 6 and 1, the point sources
traced through both levels (core/rays_amr.py, the L-level tracer at
L = 2).  A grid of more data levels under `--amr-depth` > 2 runs as L-level
dense AMR (core/step_amr.py::MultiLevelModel, up to --amr-depth levels,
the deeper ones averaged onto the deepest kept) in modes 9, 8, 6 and 1,
the point sources traced through every level (core/rays_multilevel.py),
its sweep's coupling depth validated on the ingested grid unless
`--coupling-depth` fixes it, where the JAX CLI would keep it dense: always
under `--amr-storage dense`, under `auto` (the default) while the dense
levels' 17 fields take at most 4e9 bytes.  Above that, or under
`--amr-storage sparse`, such a grid runs as block-sparse L-level AMR
(core/amr_sparse.py, core/step_amr.py::SparseMLModel) in modes 9, 8, 6
and 1, the JAX CLI's storage: ingested at O(leaves) in blocks of
`--block-edge` cells a side, its coupling depth validated the same way,
its sweep confined to each slab's refinement window unless
`--sweep-window off` (core/sweep_sparse.py), the point sources traced
through each level's blocks (core/rays_multilevel.py's block-sparse
addressing), its snapshots leaf streams with the block origins; under
`--split-compile` each iteration also prints its phases' seconds (the
tracer's by phase, and its last phase's alive counts), as the JAX CLI
does.  `--chemistry noneq` on a nested grid runs the model's
make_noneq_step (a two-level grid as MultiLevelModel(2) at the default
coupling depth, as the JAX CLI does; a block-sparse one with each refined
level's species in blocks, their padding blocks zero) and writes
snapshots with each level's species (`species{l}_*`), which a restart
continues.  The diagnostic modes 2, 3, 4 and 7 of a nested grid read its
base level, as the JAX CLI's do; its snapshots are cellArray leaf streams
(io/snapshot.py::write_snapshot_amr, write_snapshot_ml,
write_snapshot_sparse).

A grid may come as `.npz`, as the reference's HDF4 container `.h4`
(io/convert.py::h42levels, the pure-Python reader io/hdf4.py) or as its
Fortran `.dat` binary.  `--ckpt-format orbax` writes each iteration's state
(with the species under --chemistry noneq) as a `ckptNNNN` checkpoint in
place of the cellArray snapshot, and a restart continues from the newest
one (io/checkpoint.py: torch-native files, not orbax's; neither package
restores the other's).  `--debug-checkify` runs the checked pre-flight
(core/debug.py) once on the ingested grid, on every storage, before the
loop.  `--tracer-compact` traces the uniform grid's point sources with the
compacting tracer (rays.trace_point_sources_compact).

Not ported yet, and refused before any work with NotImplementedError
naming their ROADMAP entry (Distribution): the domain-decomposed tracer
(`--tracer-strategy domain` on a mesh in a point-source mode), 2-D and 3-D
`--mesh-shape` and the multi-process flags.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import os
import sys
import time

import numpy as np
import torch

from .config import (
    MODE_CLUMPING_FACTOR,
    MODE_INITIAL_CONFIGURATION,
    MODE_PLOT_PDFS,
    MODE_PRINT_NUMBER_OF_CELLS,
    load_config,
)
from .constants import KPC, MYR
from .core import amr, amr_sparse, chemistry_noneq, debug, step_amr
from .core import step as step_mod
from .core.rays import cosmic_spectrum, escape_fractions
from .io import checkpoint, convert, diagnostics, grid_io, snapshot
from .io import sources_io
from .parallel import mesh as pmesh
from .tables import stellar as stellar_tables
from .tables.chemistry_rates import dump_rates


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("config", nargs="?", default="inputParameters")
    ap.add_argument("--iters", type=int, default=-1,
                    help="max iterations; 0 = unbounded (the reference's "
                         "run-until-judged contract, equiSources.f90:1230; "
                         "the convergence break at |dnf| <= 1e-6 still "
                         "applies); default: config max_iterations, itself "
                         "0 = unbounded")
    ap.add_argument("--platform", default="cuda", choices=("cuda", "cpu"),
                    help="torch device of the run: cuda (default; fails "
                         "without a CUDA device, never falls back to the "
                         "CPU) or cpu")
    ap.add_argument("--x64", action="store_true",
                    help="run in float64 (parity mode)")
    ap.add_argument("--snapshot-dir", default=".")
    ap.add_argument("--angular-level", type=int, default=0,
                    help="override nAngularLevel (12*4^(L-1) directions)")
    ap.add_argument("--max-pixel-level", type=int, default=0,
                    help="override the point-source ray-splitting depth")
    ap.add_argument("--debug-nans", action="store_true",
                    help="after every step check each state field with "
                         "torch.isfinite and raise FloatingPointError naming "
                         "the first non-finite field; coarser than the JAX "
                         "CLI's jax_debug_nans, which stops at the op that "
                         "made the NaN")
    ap.add_argument("--debug-checkify", action="store_true",
                    help="pre-flight the sweep+chemistry and tracer on the "
                         "ingested data under core/debug.py's checks "
                         "(gather/scatter bounds + NaN + integer division, "
                         "the runtime analog of the reference's "
                         "stop-asserts, equiSources.f90:2962-2976), once "
                         "before the loop; uniform, two-level, L-level and "
                         "block-sparse storage (nested: a 12-direction "
                         "plan)")
    ap.add_argument("--dump-rates", action="store_true",
                    help="write rates.out / cool_rates.out like the reference")
    ap.add_argument("--profile", default="",
                    help="write a torch.profiler trace of the iteration loop "
                         "to DIR/trace.json (chrome trace format)")
    ap.add_argument("--sweep-strategy", default="",
                    choices=("", "auto", "pipelined", "zones", "rdma"),
                    help="override cfg.sweep_strategy: auto (the sweep on "
                         "one device), or an explicit schedule on a 1-D mesh "
                         "of P ranks on the one device (pipelined = per-slab "
                         "halo lines, zones = angle decomposition + sum, "
                         "rdma = the ring kernel)")
    ap.add_argument("--sweep-logmean", default="",
                    choices=("", "auto", "exact", "clamped"),
                    help="sweep logmean form: auto (default: clamped in "
                         "f32, exact in f64), exact (reference two-branch), "
                         "or clamped (branch-free)")
    ap.add_argument("--tracer-compact", action="store_true",
                    help="uniform grid, modes 8 and 1: the single-device "
                         "tracer with host-driven final-phase dead-lane "
                         "compaction (the same deposits up to their order); "
                         "ignored on nested grids and by the noneq step's "
                         "trace, as in the JAX CLI")
    ap.add_argument("--tracer-strategy", default="",
                    choices=("", "sources", "domain"),
                    help="distributed tracer on a mesh: sources (the "
                         "default: each rank traces its share of the "
                         "sources through the whole grid) or domain (not "
                         "ported yet: raises in a point-source mode); "
                         "without a mesh both run the single-device tracer")
    ap.add_argument("--mesh-shape", default="",
                    help="P: a 1-D mesh of P virtual ranks on the run's one "
                         "device (the JAX CLI takes every device instead); "
                         "overrides cfg.mesh_shape; 2-D shapes raise")
    ap.add_argument("--coordinator", default="",
                    help="multi-process runtime: not ported yet, raises")
    ap.add_argument("--num-processes", type=int, default=0,
                    help="multi-process runtime: not ported yet, raises")
    ap.add_argument("--process-id", type=int, default=-1,
                    help="multi-process runtime: not ported yet, raises")
    ap.add_argument("--chemistry", choices=("equilibrium", "noneq"),
                    default="equilibrium",
                    help="chemistry solver: the reference's ionization "
                         "equilibrium (default) or the non-equilibrium "
                         "9-species H/He/H2 network (core.chemistry_noneq)")
    ap.add_argument("--dt-myr", type=float, default=1.0,
                    help="noneq chemistry timestep per iteration [Myr]")
    ap.add_argument("--evolve-energy", action="store_true",
                    help="noneq mode: evolve the internal energy")
    ap.add_argument("--ckpt-format", choices=("npz", "orbax"), default="npz",
                    help="snapshot format: portable cellArray .npz "
                         "(default) or checkpoint directories ckptNNNN "
                         "(io/checkpoint.py; the JAX CLI's name, torch "
                         "files in place of orbax's)")
    ap.add_argument("--amr-depth", type=int, default=4,
                    help="max AMR levels kept from the input grid (deeper "
                         "input levels average onto the deepest kept one); "
                         "2 runs a deeper grid as two-level AMR")
    ap.add_argument("--amr-storage", choices=("auto", "dense", "sparse"),
                    default="auto",
                    help="storage of a grid of more than two levels: dense "
                         "per-level volumes, block-sparse (memory "
                         "proportional to the leaves), or auto "
                         "(block-sparse when the dense footprint would "
                         "exceed 4e9 bytes)")
    ap.add_argument("--coupling-depth", type=int, default=0,
                    help="L-level sweep Gauss-Seidel coupling passes per "
                         "slab (0 = validate on the ingested grid at "
                         "startup and adopt the smallest converged depth)")
    ap.add_argument("--block-edge", type=int, default=8,
                    help="block-sparse storage block edge (level cells per "
                         "side)")
    ap.add_argument("--sweep-window", choices=("auto", "off"),
                    default="auto",
                    help="block-sparse sweep: confine the coupled fine-level "
                         "stack to each slab's refinement window (auto; the "
                         "full-plane stack where refinement spans the grid) "
                         "or not (off); the result is the same")
    ap.add_argument("--split-compile", action="store_true",
                    help="the JAX CLI's per-piece compiles: the same "
                         "results; a block-sparse run prints each "
                         "iteration's phases (tracer, sweep, "
                         "chemistry_sync) and the tracer's by phase")
    return ap


def _refuse_not_ported(args, cfg) -> None:
    """NotImplementedError for what the port does not run yet, before any
    work: the multi-process flags, and the domain-decomposed tracer on a
    mesh in a point-source mode."""
    if (bool(args.coordinator) or bool(args.num_processes)
            or args.process_id >= 0):
        raise NotImplementedError(
            "--coordinator / --num-processes / --process-id is not ported "
            "yet: ROADMAP, Distribution (ranks on several cards)")
    if ((cfg.mesh_shape or cfg.sweep_strategy != "auto")
            and cfg.run_stellar_transfer and cfg.tracer_strategy == "domain"):
        raise NotImplementedError(
            "--tracer-strategy domain (the domain-decomposed tracer, "
            "parallel/rays_domain.py) is not ported yet: ROADMAP, "
            "Distribution")


def _read_levels(cfg):
    grid_path = os.path.join(cfg.sph_dir, cfg.grid)
    if os.path.exists(grid_path + ".npz"):
        return grid_io.read_level_npz(grid_path + ".npz")
    if os.path.exists(grid_path + ".h4"):
        # the reference's own container (equiSources.f90:316-423), read by
        # the pure-Python HDF4-SD parser
        return convert.h42levels(grid_path + ".h4")
    if os.path.exists(grid_path + ".dat"):
        return grid_io.read_fortran_level_binary(
            grid_path + ".dat", cfg.read_metals, cfg.read_kinematics)
    sys.exit(f"grid not found: {grid_path}(.npz|.h4|.dat)")


def _dense_bytes(levels, depth: int, x64: bool) -> int:
    """The JAX CLI's footprint of `depth` dense levels: (n*2^l)^3 cells of
    17 fields each, 8 bytes a value under --x64, else 4; above 4e9 bytes
    it stores the grid block-sparse."""
    nbase = round(levels[0].ncell ** (1.0 / 3.0))
    return sum((nbase * 2 ** ell) ** 3 * 17 * (8 if x64 else 4)
               for ell in range(depth))


def _nesting(levels, args) -> str:
    """How the grid runs, as the JAX CLI decides it: "uniform" (one data
    level), "amr" (two-level AMR: two data levels, or more under
    --amr-depth 2), "ml" (L-level dense AMR: more than two data levels
    under --amr-depth > 2 while the dense storage is chosen) or "sparse"
    (the same grid stored block-sparse)."""
    n_data_levels = sum(1 for lv in levels if lv.ncell > 0)
    if n_data_levels <= 1:
        return "uniform"
    kind = "amr"
    if n_data_levels > 2 and args.amr_depth > 2:
        dense_bytes = _dense_bytes(levels, min(n_data_levels,
                                               args.amr_depth), args.x64)
        kind = "ml"
        if args.amr_storage == "sparse" or (args.amr_storage == "auto"
                                            and dense_bytes > 4.0e9):
            kind = "sparse"
    return kind


def _check_finite(states, itime: int) -> None:
    """--debug-nans: FloatingPointError naming the first non-finite
    field of the FieldStates given (a nested run's levels, the base
    first)."""
    for state in states:
        for f in dataclasses.fields(state):
            x = getattr(state, f.name)
            if torch.is_tensor(x) and not bool(torch.isfinite(x).all()):
                raise FloatingPointError(
                    f"non-finite values in state.{f.name} after "
                    f"itime={itime}")


def _restore_noneq(container, species, restart_snap, restart_ckpt):
    """The restart state of a noneq run: (container, species, itime or
    None).  species: a SpeciesState, or a nested run's tuple of one a
    level.

    A noneq checkpoint holds (fields, species), the prognostic state the
    reference's restart restores (equiSources.f90:1071-1167), so both
    restore together.  A fields-only checkpoint (an equilibrium run's,
    which restore_sharded reports as checkpoint.TreeMismatch, and nothing
    else) restores the fields, the species re-initialized from equilibrium
    with a warning.  Any other failure raises: a truncated or corrupt
    file, a species array that does not fit (the JAX CLI catches every
    Exception there, ROADMAP section 3).  A snapshot's fields are restored
    before this and only its species are read here, those that do not fit
    the grid raising (read_species); without a restart source, or from a
    snapshot without species (with a warning), the equilibrium species
    given are kept."""
    if restart_ckpt is not None:
        try:
            (cont2, sp2), meta = checkpoint.restore_sharded(
                restart_ckpt, (container, species))
            print("restored fields + 9-species noneq state from "
                  f"{restart_ckpt}")
            return cont2, sp2, meta["itime"]
        except checkpoint.TreeMismatch:
            cont2, meta = checkpoint.restore_sharded(restart_ckpt, container)
            print("warning: checkpoint carries no species state; "
                  "H2/H2+/H-/energy re-initialized from equilibrium")
            return cont2, species, meta["itime"]
    if restart_snap is not None:
        sp2 = snapshot.read_species(restart_snap, species)
        if sp2 is not None:
            print("restored 9-species noneq state from snapshot")
            return container, sp2, None
        print("warning: snapshot carries no species state; "
              "H2/H2+/H-/energy re-initialized from equilibrium")
    return container, species, None


def _preflight(storage: str, model, amodel, nested, state,
               stellar_ctx) -> None:
    """--debug-checkify: the checked pre-flight of the run's storage on the
    ingested grid (core/debug.py), printing the JAX CLI's line; raises at
    the first violated check.  A two-level grid checks through its
    L-level view, MultiLevelModel(2), as the JAX CLI's does."""
    if storage == "uniform":
        debug.preflight(model, state, stellar_ctx)
        print("checkify pre-flight passed (bounds/NaN/division clean "
              "on the ingested data)")
    elif storage == "sparse":
        debug.preflight_sparse(amodel, nested, stellar_ctx)
        print("checkify pre-flight passed on block-sparse storage "
              "(slot-map/padding-block bounds, NaN/Inf, division "
              "clean on the ingested data)")
    elif storage == "ml":
        debug.preflight_ml(amodel, nested, stellar_ctx)
        print("checkify pre-flight passed on multilevel storage")
    else:
        if isinstance(nested, amr.AMRState):
            nested = amr.MultiLevelState(levels=(nested.base, nested.fine),
                                         refined=(nested.refined,))
        debug.preflight_ml(step_amr.MultiLevelModel.setup(model, 2), nested,
                           stellar_ctx)
        print("checkify pre-flight passed on two-level AMR storage")


def _print_phases(times: dict, stellar_ctx) -> None:
    """A --split-compile iteration's phase lines, as the JAX CLI prints
    them: each phase's seconds, the tracer's by phase, and the last
    phase's alive counts read every chunk of march steps."""
    parts = [f"{k}={v:.1f}s" for k, v in times.items()
             if isinstance(v, (int, float))]
    sub = times.get("tracer_phases") or {}
    parts += [f"{k}={v:.1f}s" for k, v in sub.items()
              if isinstance(v, (int, float)) and not k.endswith("_steps")]
    print("  phases: " + " ".join(parts))
    alive = (sub.get(f"level{stellar_ctx.max_pixel_level}_alive")
             if stellar_ctx is not None else None)
    if alive:
        print("  final-phase alive/chunk: "
              + "/".join(str(c) for c in alive))


@dataclasses.dataclass
class Stars:
    """A config's point sources on an ingested grid, as main reads them:
    the population (Starburst99 SEDs from synthesisDir when present, else
    blackbodies, equiSources.f90:840-916), the metallicity buckets'
    coefficients (None without metals on the grid), the star count, the
    source batch, each source's host cell, the young (specific-age) star
    count and the base level's abun2 on the host."""
    population: object
    used_sb99: bool
    metal_coefs: list | None
    n_stars: int
    batch: object
    host: np.ndarray
    n_young: int
    abun2: np.ndarray

    def context(self, cfg, geom, *, max_pixel_level: int = 6,
                noneq: bool = False, dtype=torch.float64, device="cuda"):
        """The StellarContext of the run at 10 Myr (noneq: with the
        k27..k31 weights, as --chemistry noneq builds it)."""
        return step_mod.StellarContext.build(
            self.population, self.batch, geom, 10.0 * MYR,
            metal_coefs=self.metal_coefs or [(0, 0.0)],
            n_stars_specific_age=self.n_young,
            dust_approximation=cfg.dust_approximation,
            max_pixel_level=max_pixel_level, noneq=noneq, dtype=dtype,
            device=device)


def read_stars(cfg, levels, abun2: torch.Tensor, refined, nx: int) -> Stars:
    """The point sources of `cfg` (read_star_file within the grid's
    bounds) on the grid ingested from `levels`: its base level's abun2 and
    refined map (a tensor, None on a uniform grid; a star in a refined
    parent sits at its fine leaf's centre), with metallicities on the grid
    bucketed to the nearest SED track, each bucket sharing a table."""
    lo, hi, _ = grid_io.grid_bounds(levels)
    stars = sources_io.read_star_file(os.path.join(cfg.sph_dir, cfg.sources),
                                      lo, hi)
    population, used_sb99 = stellar_tables.load_population(
        cfg.synthesis_dir, len(stars.age),
        int(np.sum(stars.age <= cfg.upper_age_limit)),
        cfg.mass_stellar_particle)
    metal_edges = metal_coefs = None
    if cfg.read_metals:
        metal_edges, metal_coefs = stellar_tables.metal_bucket_plan(population)
    ab2 = abun2.detach().cpu().numpy()
    batch, host, n_young = sources_io.prepare_sources(
        stars, nx, cfg.upper_age_limit, abun2=ab2,
        metal_bucket_edges=metal_edges,
        refined=None if refined is None else refined.detach().cpu().numpy())
    return Stars(population, used_sb99, metal_coefs, len(stars.age), batch,
                 host, n_young, ab2)


def main(argv=None):
    args = _parser().parse_args(argv)
    cfg = load_config(args.config)
    if args.angular_level:
        cfg.n_angular_level = args.angular_level
    if args.sweep_strategy:
        cfg.sweep_strategy = args.sweep_strategy
    if args.sweep_logmean:
        cfg.sweep_logmean = args.sweep_logmean
    if args.tracer_compact:
        cfg.tracer_compact = True
    if args.mesh_shape:
        cfg.mesh_shape = tuple(int(x) for x in args.mesh_shape.split(","))
    if args.tracer_strategy:
        cfg.tracer_strategy = args.tracer_strategy
    _refuse_not_ported(args, cfg)
    noneq = args.chemistry == "noneq"

    device = torch.device(args.platform)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("--platform cuda: no CUDA device is available (pass "
                 "--platform cpu to run on the CPU)")
    mesh = None
    if cfg.mesh_shape or cfg.sweep_strategy != "auto":
        mesh = pmesh.make_grid_mesh(shape=cfg.mesh_shape or None,
                                    device=device)
        print(f"device mesh: {{{mesh.axis_name!r}: {mesh.n_ranks}}}"
              f" strategy = {cfg.sweep_strategy}")
    dtype = torch.float64 if args.x64 else torch.float32
    print(f"mode = {cfg.mode}   grid = {cfg.grid}   z = {cfg.current_redshift}")

    # ---- grid ingestion -------------------------------------------------
    levels = _read_levels(cfg)
    if cfg.mode == MODE_PRINT_NUMBER_OF_CELLS:
        for i, lv in enumerate(levels):
            print(f"level = {i + 1}  cells = {lv.ncell}")
        return
    nesting = _nesting(levels, args)
    # the nested state: an AMRState ("amr"), a MultiLevelState ("ml") or a
    # SparseMLState ("sparse")
    nested = None
    if nesting == "amr":
        nested, geom = amr.amr_from_levels(levels, cfg.read_metals,
                                           dtype=dtype, device=device)
        state = nested.base
        print(f"grid: {geom.nx}^3 + refined level "
              f"({int(nested.refined.sum())} parents)")
    elif nesting == "ml":
        nested, geom = amr.multilevel_from_levels(
            levels, cfg.read_metals, dtype=dtype, device=device,
            max_depth=args.amr_depth)
        state = nested.levels[0]
        counts = [int(r.sum()) for r in nested.refined]
        print(f"grid: {geom.nx}^3 + {nested.n_levels - 1} refined levels "
              f"(refined parents per level: {counts})")
    elif nesting == "sparse":
        nested, geom = amr_sparse.sparse_from_level_lists(
            levels, cfg.read_metals, be=args.block_edge,
            max_depth=args.amr_depth, dtype=dtype, device=device)
        state = nested.base
        dense_bytes = _dense_bytes(levels, nested.n_levels, args.x64)
        print(f"grid: {geom.nx}^3 + {nested.n_levels - 1} refined levels, "
              f"block-sparse (be={args.block_edge}): {nested.n_leaves()} "
              f"leaves, {nested.memory_bytes() / 1e9:.2f} GB (dense would "
              f"be {dense_bytes / 1e9:.1f} GB)")
    else:
        state, geom = grid_io.build_uniform_state(levels, cfg.read_metals,
                                                  dtype=dtype, device=device)
    print(f"grid: {geom.nx}^3, box = {geom.physical_box_size / KPC:.1f} kpc")
    # the coupling depth is validated on grids ingested as L-level; a
    # two-level grid's noneq run goes through MultiLevelModel(2) at the
    # default depth, as the JAX CLI's does
    validate_depth = nesting in ("ml", "sparse")
    # the storage the grid was ingested as (a two-level noneq run goes on
    # as an L-level one)
    storage = nesting
    if nesting == "amr" and noneq:
        nested = amr.MultiLevelState(levels=(nested.base, nested.fine),
                                     refined=(nested.refined,))
        nesting = "ml"

    if cfg.mode == MODE_CLUMPING_FACTOR:
        rho = state.rho.detach().cpu().numpy()
        print(f"clumping = {diagnostics.clumping_factor(rho)}")
        return

    if cfg.mode == MODE_INITIAL_CONFIGURATION:
        m = diagnostics.project_to_map(state.abun2.detach().cpu().numpy(),
                                       state.rho.detach().cpu().numpy())
        np.savez(os.path.join(args.snapshot_dir, "map.npz"), map=m)
        print(f"wrote map.npz ({m.shape})")
        return

    # ---- sources --------------------------------------------------------
    stellar_ctx = None
    if cfg.run_stellar_transfer or cfg.mode == MODE_PLOT_PDFS:
        stars = read_stars(
            cfg, levels, state.abun2, None if nested is None else
            (nested.refined if nesting == "amr"
             else nested.refined0 if nesting == "sparse"
             else nested.refined[0]), geom.nx)
        if stars.used_sb99:
            print(f"Starburst99 SEDs from {cfg.synthesis_dir} "
                  f"({len(stars.population.metallicity_log10)} metallicity "
                  "tracks)")
        batch, host, ab2 = stars.batch, stars.host, stars.abun2
        print(f"nStars/specificAge/non-degenerate = {stars.n_stars} "
              f"{stars.n_young} {batch.n_sources}")
        # the reference's `weight` file (equiSources.f90:1214-1224)
        with open(os.path.join(args.snapshot_dir, "weight"), "w") as fh:
            for i in range(batch.n_sources):
                hz = ab2[host[i, 0], host[i, 1], host[i, 2]]
                fh.write(f"{i + 1:10d} ==>  {int(batch.weight[i]):10d}"
                         f"{hz:16.4e}\n")

        if cfg.mode == MODE_PLOT_PDFS:
            rho = state.rho.detach().cpu().numpy()
            host_rho = rho[host[:, 0], host[:, 1], host[:, 2]]
            pdfs = diagnostics.density_pdfs(rho, host_rho)
            for c, g, s in zip(pdfs.bin_centers, pdfs.pdf_gas, pdfs.pdf_star):
                print(f"{c:12.4f} {g:12.1f} {s:12.1f}")
            return

        stellar_ctx = stars.context(
            cfg, geom, max_pixel_level=args.max_pixel_level or 6,
            noneq=noneq, dtype=dtype, device=device)

    # ---- model + iteration loop ----------------------------------------
    model = step_mod.RTModel.setup(cfg, geom, dtype=dtype, device=device)
    if args.debug_checkify and storage == "uniform":
        # on the ingested state, before its equilibrium, as the JAX CLI
        _preflight(storage, model, None, None, state, stellar_ctx)
    if nesting == "amr":
        amodel = step_amr.AMRModel.setup(model)
        step = amodel.make_step(stellar_ctx, mesh=mesh)
    elif nesting == "ml":
        amodel = step_amr.MultiLevelModel.setup(model, nested.n_levels)
        step = (amodel.make_noneq_step(args.dt_myr * MYR, stellar_ctx,
                                       evolve_energy=args.evolve_energy,
                                       mesh=mesh)
                if noneq else amodel.make_step(stellar_ctx, mesh=mesh))
    elif nesting == "sparse":
        amodel = step_amr.SparseMLModel.setup(model, nested.n_levels)
        amodel.window_enabled = args.sweep_window != "off"
        step = (amodel.make_noneq_step(args.dt_myr * MYR, stellar_ctx,
                                       evolve_energy=args.evolve_energy,
                                       split_compile=args.split_compile,
                                       mesh=mesh)
                if noneq else amodel.make_step(
                    stellar_ctx, split_compile=args.split_compile,
                    mesh=mesh))
    elif noneq:
        step = model.make_noneq_step(args.dt_myr * MYR, stellar_ctx,
                                     evolve_energy=args.evolve_energy,
                                     mesh=mesh)
    else:
        step = model.make_step(stellar_ctx, mesh=mesh)
    if args.dump_rates:
        dump_rates(model.tables,
                   os.path.join(args.snapshot_dir, "rates.out"),
                   os.path.join(args.snapshot_dir, "cool_rates.out"))
        print("wrote rates.out, cool_rates.out")
    if cfg.run_uvb_transfer and validate_depth:
        if args.coupling_depth:
            amodel.n_coupling_iters = args.coupling_depth
            print(f"coupling depth: {args.coupling_depth} (fixed)")
        else:
            d = amodel.validate_coupling_depth(nested)
            print(f"coupling depth: {d} (validated on the ingested "
                  f"grid, residual < 1e-8)")
    if nesting == "amr":
        nested = amr.sync_restriction(dataclasses.replace(
            nested, base=model.initialize_equilibrium(nested.base),
            fine=model.initialize_equilibrium(nested.fine)))
        nf0 = amodel.neutral_fraction(nested)
    elif nesting == "ml":
        nested = amr.sync_restriction_multi(amr.MultiLevelState(
            levels=tuple(model.initialize_equilibrium(lv)
                         for lv in nested.levels),
            refined=nested.refined))
        nf0 = amodel.neutral_fraction(nested)
    elif nesting == "sparse":
        nested = amodel.initialize_equilibrium(nested)
        nf0 = amodel.neutral_fraction(nested)
    else:
        state = model.initialize_equilibrium(state)
        nf0 = model.neutral_fraction(state)
    if args.debug_checkify and storage != "uniform":
        _preflight(storage, model, amodel, nested, state, stellar_ctx)
    print(f"ionization equilibrium: {nf0:.8e}")
    itime = 0
    restart_snap = restart_ckpt = None
    if cfg.restart and args.ckpt_format == "orbax":
        path = checkpoint.latest_checkpoint(args.snapshot_dir)
        if path and noneq:
            # a noneq checkpoint holds (fields, species): restored together
            # once the species are built below
            restart_ckpt = path
        elif path:
            restored, meta = checkpoint.restore_sharded(
                path, state if nested is None else nested)
            itime = meta["itime"]
            if nested is None:
                state = restored
            else:
                nested = restored
            print(f"restarted from {path} at itime={itime}")
    elif cfg.restart:
        snap = (os.path.join(args.snapshot_dir, cfg.restart_cell_array_name)
                if cfg.restart_cell_array_name
                else snapshot.latest_snapshot(args.snapshot_dir))
        if snap and nesting == "amr":
            nested, itime = snapshot.read_snapshot_amr(snap, nested)
        elif snap and nesting == "ml":
            nested, itime = snapshot.read_snapshot_ml(snap, nested)
        elif snap and nesting == "sparse":
            nested, itime = snapshot.read_snapshot_sparse(snap, nested)
        elif snap:
            state, itime = snapshot.read_snapshot(snap, state)
        if snap:
            print(f"restarted from {snap} at itime={itime}")
            restart_snap = snap

    tlog = snapshot.TimeLog(os.path.join(args.snapshot_dir, "time"))
    if mesh is not None:
        state = pmesh.shard_state(state, mesh)
    species = None
    on_mesh = (f", mesh = {(mesh.n_ranks,)}" if mesh is not None else "")
    if noneq and nesting == "sparse":
        # level 0 dense, the refined levels in blocks with their padding
        # blocks zero
        nested, species, it2 = _restore_noneq(
            nested, amodel.initial_species(nested), restart_snap,
            restart_ckpt)
        if mesh is not None:
            # the JAX CLI's lines word for word: its devices are the ranks
            print(f"block-sparse noneq distributed over {mesh.n_ranks} "
                  f"devices: zones sweep + source-parallel "
                  f"quadrature_noneq tracer")
        print(f"non-equilibrium chemistry (block-sparse, {nested.n_levels} "
              f"levels): dt = {args.dt_myr} Myr, evolve_energy = "
              f"{args.evolve_energy}")
    elif noneq and nested is not None:
        nested, species, it2 = _restore_noneq(
            nested, tuple(chemistry_noneq.species_from_field_state(lv)
                          for lv in nested.levels), restart_snap,
            restart_ckpt)
        if mesh is not None:
            nested = pmesh.shard_multilevel_state(nested, mesh)
            species = tuple(pmesh.shard_species(spc, mesh)
                            for spc in species)
        print(f"non-equilibrium chemistry ({nested.n_levels} levels): "
              f"dt = {args.dt_myr} Myr, evolve_energy = "
              f"{args.evolve_energy}" + on_mesh)
    elif noneq:
        state, species, it2 = _restore_noneq(
            state, chemistry_noneq.species_from_field_state(state),
            restart_snap, restart_ckpt)
        if mesh is not None:
            species = pmesh.shard_species(species, mesh)
        print(f"non-equilibrium chemistry: dt = {args.dt_myr} Myr, "
              f"evolve_energy = {args.evolve_energy}" + on_mesh)
    elif mesh is not None and nesting == "sparse":
        if cfg.sweep_strategy not in ("", "auto", "zones"):
            print(f"warning: sparse deep AMR distributes via the "
                  f"angle-decomposed zones strategy (not "
                  f"{cfg.sweep_strategy}); using zones")
        print(f"block-sparse deep AMR distributed over {mesh.n_ranks} "
              f"devices: zones sweep (direction chunks + psum) + "
              f"source-parallel tracer")
    elif mesh is not None and nested is not None:
        if cfg.sweep_strategy not in ("", "auto"):
            print(f"warning: explicit sweep strategies are uniform-grid "
                  f"only; the {'multilevel' if nesting == 'ml' else 'AMR'} "
                  f"sweep runs as without a mesh")
        nested = (pmesh.shard_multilevel_state(nested, mesh)
                  if nesting == "ml" else pmesh.shard_amr_state(nested, mesh))
    if noneq and it2 is not None:
        itime = it2
    # 0 = unbounded: the reference iterates until externally judged/killed
    # (equiSources.f90:1230); the convergence break below still applies
    max_iter = args.iters if args.iters >= 0 else cfg.max_iterations
    iter_range = itertools.count() if max_iter == 0 else range(max_iter)
    prev_nf = np.inf
    with contextlib.ExitStack() as stack:
        prof = None
        if args.profile:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = stack.enter_context(torch.profiler.profile(activities=acts))
        for _ in iter_range:
            itime += 1
            t0 = time.time()
            if nested is not None and noneq:
                nested, species, *traced = step(nested, species)
                diag = traced[0] if traced else None
            elif nested is not None:
                out = step(nested)
                nested, diag = out if isinstance(out, tuple) else (out, None)
            elif noneq:
                state, species, *traced = step(state, species)
                diag = traced[0] if traced else None
            else:
                out = step(state)
                state, diag = out if isinstance(out, tuple) else (out, None)
            if args.debug_nans:
                _check_finite(
                    (state,) if nested is None else
                    (nested.base, nested.fine) if nesting == "amr"
                    else (nested.base, *(lv.fields for lv in nested.levels))
                    if nesting == "sparse" else nested.levels, itime)
            nf = (model.neutral_fraction(state) if nested is None
                  else amodel.neutral_fraction(nested))
            tlog.append(itime, nf)
            dt_it = time.time() - t0
            throughput = geom.nx ** 3 * cfg.n_directions / max(dt_it, 1e-9)
            msg = (f"itime={itime} neutral={nf:.8f} dt={dt_it:.2f}s "
                   f"({throughput:.2e} cells*angles/s)")
            if nesting == "sparse" and args.split_compile:
                _print_phases(amodel.last_phase_times, stellar_ctx)
            if diag is not None:
                w = stellar_ctx.sources.weight
                frac = escape_fractions(diag, w)
                mean_fesc = (frac * w[:, None]).sum(0) / w.sum()
                msg += "  fesc=" + "/".join(f"{f:.3f}" for f in mean_fesc)
                spec = cosmic_spectrum(diag, w,
                                       stellar_ctx.n_stars_specific_age)
                freq = stellar_ctx.tables["output_freq"]
                np.savez(os.path.join(args.snapshot_dir,
                                      "cosmicSpectrum.npz"),
                         freq=freq.detach().cpu().numpy(), spectrum=spec)
            print(msg)
            if args.ckpt_format == "orbax":
                container = state if nested is None else nested
                checkpoint.save_sharded(
                    checkpoint.checkpoint_name(itime, args.snapshot_dir),
                    (container, species) if noneq else container, itime,
                    geom.physical_box_size)
            elif nesting == "amr":
                snapshot.write_snapshot_amr(
                    snapshot.snapshot_name(itime, args.snapshot_dir),
                    nested, itime, geom.physical_box_size)
            elif nesting in ("sparse", "ml"):
                write = (snapshot.write_snapshot_sparse if nesting == "sparse"
                         else snapshot.write_snapshot_ml)
                write(snapshot.snapshot_name(itime, args.snapshot_dir),
                      nested, itime, geom.physical_box_size,
                      extra=({k: v for ell, spc in enumerate(species)
                              for k, v in snapshot.species_extra(
                                  spc, prefix=f"species{ell}").items()}
                             if noneq else None))
            else:
                snapshot.write_snapshot(
                    snapshot.snapshot_name(itime, args.snapshot_dir), state,
                    itime, geom.physical_box_size,
                    extra=(snapshot.species_extra(species) if noneq
                           else None))
            if abs(nf - prev_nf) <= 1e-6 * max(nf, 1e-30):
                print("converged")
                break
            prev_nf = nf
    if prof is not None:
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
        print(f"profiler trace written to {args.profile}")


if __name__ == "__main__":
    main()
