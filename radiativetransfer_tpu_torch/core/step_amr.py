"""Full transport + chemistry iteration on nested (AMR) grids.

Counterpart of AMRModel and MultiLevelModel in the JAX package's
core/step_amr.py, the AMR analogs of core/step.py: zero rates ->
point-source trace (rays_multilevel; rays_amr is its L = 2 case) ->
opacities + the nested sweep (sweep_amr, sweep_multilevel) -> per-level
equilibrium chemistry -> restriction sync (the reference's recursive per-leaf updates walk the
octree; here each level is one dense elementwise pass).  Both models run
modes 9 (UVB only), 8 (point sources and the UVB), 1 (point sources and
the thin UVB) and 6 (the thin UVB, no stars) on one device, and the
L-level model also the non-equilibrium 9-species chemistry
(make_noneq_step, which the CLI runs on two-level grids too, as
MultiLevelModel(2)).  SparseMLModel runs the same modes and the
non-equilibrium chemistry on block-sparse storage (core/amr_sparse.py,
core/sweep_sparse.py, the block-sparse tracer of core/rays_multilevel.py).

On a 1-D mesh of P ranks on one device (parallel/mesh.py: the states of
shard_amr_state, shard_multilevel_state, shard_sparse_state) the point
sources are traced source-parallel (parallel/rays_dist.py), as the JAX
package's models trace them; the two-level and L-level sweeps and the
chemistry run as without a mesh (the JAX package leaves them to GSPMD's
partitioning), and the block-sparse sweep runs angle-decomposed
(parallel/sweep_dist.py::diffuse_sweep_sparse_zones).  The
domain-decomposed tracer (tracer_strategy "domain" on a mesh) raises
NotImplementedError naming its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import time

import numpy as np
import torch

from . import (
    amr,
    amr_sparse,
    chemistry,
    chemistry_noneq,
    opacity,
    rays,
    rays_amr,
    rays_multilevel,
    sweep_amr,
    sweep_multilevel,
    sweep_sparse,
)
from ..parallel import rays_dist, sweep_dist
from .state import GridGeometry
from .step import check_mesh


@dataclasses.dataclass
class AMRModel:
    """Two-level model wrapper around an RTModel's tables/config."""
    rt: "object"                      # core.step.RTModel
    plan: sweep_amr.AMRSweepPlan | None

    @classmethod
    def setup(cls, rt_model) -> "AMRModel":
        """The two-level sweep plan (both levels' templates, on the host)
        when the run sweeps the UVB."""
        plan = None
        if rt_model.config.run_uvb_transfer:
            plan = sweep_amr.build_amr_sweep_plan(
                rt_model.config.n_angular_level, rt_model.geom.nx)
        return cls(rt=rt_model, plan=plan)

    @property
    def fine_geom(self) -> GridGeometry:
        g = self.rt.geom
        return GridGeometry(2 * g.nx, 2 * g.ny, 2 * g.nz, g.physical_box_size)

    def _check_supported(self, stellar, mesh) -> None:
        check_mesh(self.rt.config, stellar, mesh)

    @staticmethod
    def _zero_rates(state: amr.AMRState) -> amr.AMRState:
        return dataclasses.replace(state, base=state.base.zero_rates(),
                                   fine=state.fine.zero_rates())

    def step(self, state: amr.AMRState, stellar=None, mesh=None):
        """One iteration; returns (state, RayDiagnostics), the diagnostics
        None unless the mode traces point sources (a StellarContext
        given in mode 1 or 8); with a mesh (mesh.shard_amr_state's state)
        the tracer runs source-parallel."""
        self._check_supported(stellar, mesh)
        state = self._zero_rates(state)
        diag = None
        if self.rt.config.run_stellar_transfer and stellar is not None:
            state, diag = self.trace(state, stellar, mesh)
        return self._sweep_and_chemistry(state), diag

    def trace(self, state: amr.AMRState, stellar, mesh=None):
        """The point-source phase (the JAX package's AMRModel._traced):
        trace every source through both levels (source-parallel on a mesh,
        rays_dist.trace_point_sources_amr_dist) and put the six deposit
        fields into the (zero-rate) state, the base level's as they are
        and the fine level's times 8: the tables are over the BASE cell's
        volume (StellarContext.build), a fine cell's is an eighth of it.
        Returns (state, RayDiagnostics)."""
        args = (state, self.rt.geom, stellar.sources, stellar.tables)
        kw = dict(dust_approximation=stellar.dust_approximation,
                  max_pixel_level=stellar.max_pixel_level,
                  dtype=state.base.rho.dtype)
        rfb, rff, diag = (
            rays_amr.trace_point_sources_amr(*args, **kw) if mesh is None
            else rays_dist.trace_point_sources_amr_dist(*args, mesh, **kw))
        bs, fs = state.base.shape, state.fine.shape
        names = [f.name for f in dataclasses.fields(rfb)]
        return dataclasses.replace(
            state,
            base=dataclasses.replace(state.base, **{
                k: getattr(rfb, k).reshape(bs) for k in names}),
            fine=dataclasses.replace(state.fine, **{
                k: getattr(rff, k).reshape(fs) * 8.0 for k in names})), diag

    def _sweep(self, state: amr.AMRState) -> amr.AMRState:
        """Both levels' opacities and the two-level sweep, into Jmean."""
        rt = self.rt
        kc = opacity.compute_opacities(state.base.HI, state.base.HeI,
                                       state.base.HeII, rt.opacity_coef)
        kf = opacity.compute_opacities(state.fine.HI, state.fine.HeI,
                                       state.fine.HeII, rt.opacity_coef)
        jc, jf = sweep_amr.diffuse_sweep_amr(kc, kf, state.refined,
                                             self.plan, rt.uvb,
                                             rt.geom.cell_size)
        return dataclasses.replace(
            state, base=dataclasses.replace(state.base, Jmean=jc),
            fine=dataclasses.replace(state.fine, Jmean=jf))

    def chemistry(self, state, geom: GridGeometry):
        """One level's equilibrium solve: 60 bisection steps in float32,
        110 in float64, as in the JAX package."""
        rt = self.rt
        cfg = rt.config
        return chemistry.solve_rate_equations(
            state, geom, rt.dev_tables, ksi_matrix=rt.ksi_matrix,
            gamma_thin=rt.gamma_thin,
            self_shielding_threshold=cfg.self_shielding_threshold,
            run_uvb_transfer=cfg.run_uvb_transfer,
            n_iter=110 if state.rho.dtype == torch.float64 else 60)

    def _sweep_and_chemistry(self, state: amr.AMRState) -> amr.AMRState:
        if self.rt.config.run_uvb_transfer:
            state = self._sweep(state)
        state = dataclasses.replace(
            state, base=self.chemistry(state.base, self.rt.geom),
            fine=self.chemistry(state.fine, self.fine_geom))
        return amr.sync_restriction(state)

    def make_step(self, stellar=None, mesh=None):
        """The iteration step, a plain eager function: state -> state, or
        with a StellarContext state -> (state, RayDiagnostics or None), as
        step returns them, on a mesh if one is given."""
        self._check_supported(stellar, mesh)
        if stellar is None:
            return lambda state: self.step(state, mesh=mesh)[0]
        return functools.partial(self.step, stellar=stellar, mesh=mesh)

    def neutral_fraction(self, state: amr.AMRState) -> float:
        """Leaf-volume-weighted neutral hydrogen fraction, summed in float64
        on the state's device."""
        r = state.refined
        rf = amr.prolong_mask(r)
        b, f = state.base, state.fine

        def total(x_base, x_fine):
            return (torch.sum(torch.where(r, 0.0, x_base.double()))
                    + torch.sum(torch.where(rf, x_fine.double(), 0.0)) / 8.0)
        return float(total(b.HI, f.HI) / total(b.nh, f.nh))


@dataclasses.dataclass
class MultiLevelModel:
    """L-level model wrapper around an RTModel's tables/config: modes 9,
    8, 1 and 6 and the non-equilibrium chemistry on one device (the
    L-level tracer core/rays_multilevel.py, the multilevel sweep
    core/sweep_multilevel.py, chemistry on each level,
    sync_restriction_multi)."""
    rt: "object"                      # core.step.RTModel
    n_levels: int
    plan: sweep_multilevel.MLSweepPlan | None
    # Gauss-Seidel cross-level coupling passes per slab; 4 covers the
    # chain depth of typical clustered refinement, validate_coupling_depth
    # checks and selects it for the actual ingested grid
    n_coupling_iters: int = sweep_multilevel.N_COUPLING_ITERS

    @classmethod
    def setup(cls, rt_model, n_levels: int) -> "MultiLevelModel":
        """The L-level sweep plan (every level's templates, on the host)
        when the run sweeps the UVB."""
        plan = None
        if rt_model.config.run_uvb_transfer:
            plan = sweep_multilevel.build_ml_sweep_plan(
                rt_model.config.n_angular_level, rt_model.geom.nx, n_levels)
        return cls(rt=rt_model, n_levels=n_levels, plan=plan)

    _check_supported = AMRModel._check_supported

    def _kappas(self, state: amr.MultiLevelState) -> list:
        rt = self.rt
        return [opacity.compute_opacities(lv.HI, lv.HeI, lv.HeII,
                                          rt.opacity_coef)
                for lv in state.levels]

    def validate_coupling_depth(self, state: amr.MultiLevelState,
                                tol: float = 1e-8, max_iters: int = 6) -> int:
        """Select the smallest converged coupling depth for the INGESTED
        grid and adopt it (sweep_multilevel.pick_coupling_iters; the
        reference's recursive transport resolves coupling exactly by
        construction, transportRoutinesModule.f90:560-963, so the
        fixed-depth Gauss-Seidel is validated per refinement pattern).
        Runs on a 12-direction level-1 plan: the in-slab coupling chain
        depth is set by the refinement geometry, not the direction
        count."""
        plan1 = sweep_multilevel.build_ml_sweep_plan(1, self.rt.geom.nx,
                                                     self.n_levels)
        it = sweep_multilevel.pick_coupling_iters(
            self._kappas(state), list(state.refined), plan1, self.rt.uvb,
            self.rt.geom.cell_size, tol=tol, max_iters=max_iters)
        self.n_coupling_iters = it
        return it

    def level_geom(self, ell: int) -> GridGeometry:
        g = self.rt.geom
        m = 2 ** ell
        return GridGeometry(m * g.nx, m * g.ny, m * g.nz,
                            g.physical_box_size)

    @staticmethod
    def _zero_rates(state: amr.MultiLevelState) -> amr.MultiLevelState:
        return amr.MultiLevelState(
            levels=tuple(lv.zero_rates() for lv in state.levels),
            refined=state.refined)

    def step(self, state: amr.MultiLevelState, stellar=None, mesh=None):
        """One full iteration; returns (state, RayDiagnostics), the
        diagnostics None unless the mode traces point sources (a
        StellarContext given in mode 1 or 8); with a mesh
        (mesh.shard_multilevel_state's state) the tracer runs
        source-parallel."""
        self._check_supported(stellar, mesh)
        state = self._zero_rates(state)
        diag = None
        if self.rt.config.run_stellar_transfer and stellar is not None:
            state, _, diag = self.trace(state, stellar, mesh=mesh)
        return self._sweep_and_chemistry(state), diag

    def trace(self, state: amr.MultiLevelState, stellar,
              rates_mode: str = "auto", mesh=None):
        """The point-source phase (the JAX package's
        MultiLevelModel._traced): trace every source through every level
        (source-parallel on a mesh, rays_dist.trace_point_sources_ml_dist)
        and put the six deposit fields into the (zero-rate) state, level
        l's times 8^l: the tables are over the BASE cell's volume
        (StellarContext.build), a level-l cell's is 8^-l of it.  Returns
        (state, the tracer's per-level rate fields as it made them,
        RayDiagnostics); rates_mode: rays_multilevel's."""
        args = (state, self.rt.geom, stellar.sources, stellar.tables)
        kw = dict(dust_approximation=stellar.dust_approximation,
                  max_pixel_level=stellar.max_pixel_level,
                  dtype=state.levels[0].rho.dtype, rates_mode=rates_mode)
        rfs, diag = (
            rays_multilevel.trace_point_sources_ml(*args, **kw)
            if mesh is None
            else rays_dist.trace_point_sources_ml_dist(*args, mesh, **kw))
        names = [f.name for f in dataclasses.fields(rays.RateFields)]
        levels = tuple(
            dataclasses.replace(lv, **{
                k: getattr(rf, k).reshape(lv.shape) * 8.0 ** ell
                for k in names})
            for ell, (lv, rf) in enumerate(zip(state.levels, rfs)))
        return amr.MultiLevelState(levels=levels,
                                   refined=state.refined), rfs, diag

    def _sweep(self, state: amr.MultiLevelState) -> amr.MultiLevelState:
        """Every level's opacities and the L-level sweep, into Jmean."""
        rt = self.rt
        js = sweep_multilevel.diffuse_sweep_multilevel(
            self._kappas(state), list(state.refined), self.plan, rt.uvb,
            rt.geom.cell_size, n_coupling_iters=self.n_coupling_iters)
        return amr.MultiLevelState(
            levels=tuple(dataclasses.replace(lv, Jmean=j)
                         for lv, j in zip(state.levels, js)),
            refined=state.refined)

    def chemistry(self, state, geom: GridGeometry):
        """One level's equilibrium solve: 60 bisection steps in float32,
        110 in float64, as in the JAX package."""
        rt = self.rt
        cfg = rt.config
        return chemistry.solve_rate_equations(
            state, geom, rt.dev_tables, ksi_matrix=rt.ksi_matrix,
            gamma_thin=rt.gamma_thin,
            self_shielding_threshold=cfg.self_shielding_threshold,
            run_uvb_transfer=cfg.run_uvb_transfer,
            n_iter=110 if state.rho.dtype == torch.float64 else 60)

    def _sweep_and_chemistry(self, state: amr.MultiLevelState):
        if self.rt.config.run_uvb_transfer:
            state = self._sweep(state)
        state = amr.MultiLevelState(
            levels=tuple(self.chemistry(lv, self.level_geom(ell))
                         for ell, lv in enumerate(state.levels)),
            refined=state.refined)
        return amr.sync_restriction_multi(state)

    def make_step(self, stellar=None, mesh=None):
        """The iteration step, a plain eager function: state -> state, or
        with a StellarContext state -> (state, RayDiagnostics or None), as
        step returns them, on a mesh if one is given."""
        self._check_supported(stellar, mesh)
        if stellar is None:
            return lambda state: self.step(state, mesh=mesh)[0]
        return functools.partial(self.step, stellar=stellar, mesh=mesh)

    def noneq_tables(self) -> chemistry_noneq.NoneqTablesDevice:
        """The network's tables, the model's in the run's dtype on its
        device (as RTModel.make_noneq_step's)."""
        k16 = self.rt.dev_tables.k16
        return chemistry_noneq.NoneqTablesDevice.from_tables(
            self.rt.tables, k16.dtype, k16.device)

    def evolve_level(self, ell: int, lv, spc, rfs, dt: float, tables,
                     n_substeps: int = 200, evolve_energy: bool = False):
        """Level l's network advanced by dt [s] with its own photo rates
        (RTModel._assemble_photo_rates on the level; with the tracer's
        per-level NoneqRateFields `rfs`, its k27..k31 times 8^l):
        (the level's FieldState, HI/HeI/HeII and with evolve_energy tgas
        synced from the species, the species)."""
        rt = self.rt
        rf = None
        if rfs is not None:
            rf = rays.NoneqRateFields(**{
                f.name: getattr(rfs[ell], f.name).reshape(lv.shape)
                * 8.0 ** ell for f in dataclasses.fields(rfs[ell])})
        spc = chemistry_noneq.evolve_noneq(
            spc, dt, tables, photo=rt._assemble_photo_rates(lv, rf),
            n_substeps=n_substeps, evolve_energy=evolve_energy,
            tgas_fixed=None if evolve_energy else lv.tgas,
            current_redshift=rt.config.current_redshift)
        dtype = lv.HI.dtype
        lv = dataclasses.replace(
            lv, HI=spc.HI.to(dtype), HeI=spc.HeI.to(dtype),
            HeII=spc.HeII.to(dtype),
            tgas=spc.tgas.to(dtype) if evolve_energy else lv.tgas)
        return lv, spc

    def sync_noneq(self, state: amr.MultiLevelState, species):
        """sync_restriction_multi, then the species restricted onto refined
        parents (their children's average), finest level first: (state,
        species tuple)."""
        state = amr.sync_restriction_multi(state)
        species = list(species)
        for ell in range(self.n_levels - 2, -1, -1):
            r = state.refined[ell]
            coarse, fine = species[ell], species[ell + 1]
            species[ell] = chemistry_noneq.SpeciesState(**{
                f.name: torch.where(r, amr.restrict(getattr(fine, f.name)),
                                    getattr(coarse, f.name))
                for f in dataclasses.fields(coarse)})
        return state, tuple(species)

    def make_noneq_step(self, dt: float, stellar=None, n_substeps: int = 200,
                        evolve_energy: bool = False, mesh=None):
        """Transport + non-equilibrium 9-species chemistry on an L-level
        grid, each level advanced by dt [s] with its own photo rates (the
        reference's network tables are global, coll_rates.f:3-234: nothing
        in the physics is level-specific), then the species restricted
        onto refined parents, finest level first.

        Returns step(state, species) -> (state, species), or with a
        StellarContext (built noneq=True) (state, species,
        RayDiagnostics): `species` is a tuple of one
        chemistry_noneq.SpeciesState a level (species_from_field_state on
        each), the state's HI/HeI/HeII (and tgas with evolve_energy)
        synced from them each step.  The tracer runs in its
        quadrature_noneq mode; its k27..k31 deposits, per-particle rates
        over the BASE cell (the weights over its face area, the segment in
        base cells), scale by 8^l on level l as the six band channels do
        (evolve_level).  With a mesh the tracer runs source-parallel."""
        self._check_supported(stellar, mesh)
        tables = self.noneq_tables()

        def sweep_and_evolve(state, species, rfs):
            if self.rt.config.run_uvb_transfer:
                state = self._sweep(state)
            levels, species = zip(*(
                self.evolve_level(ell, lv, spc, rfs, dt, tables, n_substeps,
                                  evolve_energy)
                for ell, (lv, spc) in enumerate(zip(state.levels, species))))
            return self.sync_noneq(amr.MultiLevelState(
                levels=levels, refined=state.refined), species)

        if stellar is None:
            def step(state: amr.MultiLevelState, species):
                return sweep_and_evolve(self._zero_rates(state), species,
                                        None)
            return step

        def step_traced(state: amr.MultiLevelState, species):
            state, rfs, diag = self.trace(self._zero_rates(state), stellar,
                                          "quadrature_noneq", mesh)
            state, species = sweep_and_evolve(state, species, rfs)
            return state, species, diag

        return step_traced

    def neutral_fraction(self, state: amr.MultiLevelState) -> float:
        """Leaf-volume-weighted neutral hydrogen fraction, summed in float64
        on the state's device."""
        leafs = state.leaf_masks()

        def total(name):
            return sum(float(torch.sum(torch.where(
                m, getattr(lv, name).double(), 0.0))) * 8.0 ** -ell
                for ell, (lv, m) in enumerate(zip(state.levels, leafs)))
        return total("HI") / total("nh")


@dataclasses.dataclass
class SparseMLModel:
    """L-level model on block-sparse storage (core/amr_sparse.py): the
    iteration of MultiLevelModel -- zero rates, the block-sparse tracer
    (modes 8 and 1), opacities and the block-sparse sweep
    (core/sweep_sparse.py), chemistry (or the noneq network) on each
    level with the padding blocks re-zeroed, restriction sync -- at memory
    proportional to the leaves, the reference octree's
    (definitionsModule.f90:163-180).  Modes 9, 8, 6 and 1 and the noneq
    chemistry, on one device or on a mesh (the zones sweep and the
    source-parallel tracer)."""
    rt: "object"                      # core.step.RTModel
    n_levels: int
    plan: sweep_multilevel.MLSweepPlan | None
    n_coupling_iters: int = sweep_multilevel.N_COUPLING_ITERS
    # the windowed sweep (the CLI's --sweep-window auto); False runs the
    # full-plane stack
    window_enabled: bool = True
    # the sweep's refinement window (sweep_sparse.compute_window) and the
    # digest of the refined0 it was computed from
    _window: "object" = "unset"
    _window_key: "object" = None
    # a split_compile step's seconds by phase: tracer (with its
    # LAST_TRACE_PHASE_TIMES as tracer_phases), sweep, chemistry_sync
    last_phase_times: dict | None = None

    chemistry = MultiLevelModel.chemistry
    level_geom = MultiLevelModel.level_geom
    noneq_tables = MultiLevelModel.noneq_tables
    evolve_level = MultiLevelModel.evolve_level

    @classmethod
    def setup(cls, rt_model, n_levels: int) -> "SparseMLModel":
        """The L-level sweep plan (every level's templates, on the host)
        when the run sweeps the UVB."""
        plan = None
        if rt_model.config.run_uvb_transfer:
            plan = sweep_multilevel.build_ml_sweep_plan(
                rt_model.config.n_angular_level, rt_model.geom.nx, n_levels)
        return cls(rt=rt_model, n_levels=n_levels, plan=plan)

    _check_supported = AMRModel._check_supported

    def _ensure_window(self, state: amr_sparse.SparseMLState):
        """The sweep's refinement window of the state (None with
        window_enabled False, or where compute_window finds none), cached
        by a digest of its refined0: a state of another refinement
        recomputes it."""
        if not self.window_enabled:
            self._window, self._window_key = None, "disabled"
            return None
        r0 = state.refined0.detach().cpu().numpy()
        key = hashlib.sha1(np.packbits(r0.astype(np.uint8))).digest()
        if isinstance(self._window, str) or key != self._window_key:
            self._window = sweep_sparse.compute_window(state)
            self._window_key = key
        return self._window

    def _kappas(self, state: amr_sparse.SparseMLState):
        """(base opacity (3, n, n, n), [block opacity (3, nb, be, be, be)
        of each refined level])."""
        coef = self.rt.opacity_coef
        return (opacity.compute_opacities(state.base.HI, state.base.HeI,
                                          state.base.HeII, coef),
                [opacity.compute_opacities(lv.fields.HI, lv.fields.HeI,
                                           lv.fields.HeII, coef)
                 for lv in state.levels])

    @staticmethod
    def _zero_rates(state: amr_sparse.SparseMLState):
        return dataclasses.replace(
            state, base=state.base.zero_rates(),
            levels=tuple(dataclasses.replace(lv, fields=lv.fields.zero_rates())
                         for lv in state.levels))

    def _apply_sweep(self, state: amr_sparse.SparseMLState, mesh=None,
                     eager_rounds: bool = False):
        """Every level's opacities and the block-sparse sweep, into Jmean;
        on a mesh the angle-decomposed one
        (sweep_dist.diffuse_sweep_sparse_zones, eager_rounds its)."""
        rt = self.rt
        k0, lv_k = self._kappas(state)
        args = (k0, lv_k, state, self.plan, rt.uvb, rt.geom.cell_size)
        kw = dict(n_coupling_iters=self.n_coupling_iters,
                  window=self._ensure_window(state))
        j0, jbs = (
            sweep_sparse.diffuse_sweep_sparse(*args, **kw) if mesh is None
            else sweep_dist.diffuse_sweep_sparse_zones(
                *args, mesh, eager_rounds=eager_rounds, **kw))
        return dataclasses.replace(
            state, base=dataclasses.replace(state.base, Jmean=j0),
            levels=tuple(dataclasses.replace(lv, fields=dataclasses.replace(
                lv.fields, Jmean=j)) for lv, j in zip(state.levels, jbs)))

    def initialize_equilibrium(self, state: amr_sparse.SparseMLState):
        """Each level in its own initial equilibrium (RTModel's), the
        padding blocks re-zeroed after it, the restriction synced: the
        CLI's start on block-sparse storage."""
        rt = self.rt
        return amr_sparse.sync_restriction_sparse(dataclasses.replace(
            state, base=rt.initialize_equilibrium(state.base),
            levels=tuple(dataclasses.replace(
                lv, fields=amr_sparse.zero_pad_blocks(
                    rt.initialize_equilibrium(lv.fields),
                    lv.pad_mask(rt.geom.nx * 2 ** ell)))
                for ell, lv in enumerate(state.levels, start=1))))

    def _chemistry_and_sync(self, state: amr_sparse.SparseMLState):
        """Chemistry on every level, each refined level's padding blocks
        (origin out of range) re-zeroed after it -- chemistry on their zero
        fields is garbage, and absent tiles gather them -- then the
        restriction sync."""
        levels = []
        for ell, lv in enumerate(state.levels, start=1):
            f = self.chemistry(lv.fields, self.level_geom(ell))
            pad = lv.pad_mask(self.rt.geom.nx * 2 ** ell)
            levels.append(dataclasses.replace(
                lv, fields=amr_sparse.zero_pad_blocks(f, pad)))
        state = dataclasses.replace(
            state, base=self.chemistry(state.base, self.rt.geom),
            levels=tuple(levels))
        return amr_sparse.sync_restriction_sparse(state)

    def _iteration(self, stellar, rates_mode: str, rest,
                   split_compile: bool = False, mesh=None):
        """The one body of every iteration on this storage: state, *extra
        -> (rest(state, rfs, *extra), RayDiagnostics or None) -- zero
        rates, the tracer where `stellar` is given (rates_mode), the sweep
        where the mode sweeps the UVB, then rest (chemistry or the noneq
        network, and the restriction sync).  split_compile (the JAX
        package's per-piece compiles for its remote TPU worker: here the
        same ops) waits for the device after each phase, runs the tracer
        with host_phases (and on a mesh the sweep with eager_rounds), and
        fills self.last_phase_times with each phase's seconds (tracer, its
        tracer_phases, sweep, chemistry_sync).  A mesh runs the
        source-parallel tracer and the zones sweep (the JAX package's
        make_step(mesh=...))."""
        def step(state, *extra):
            times = {} if split_compile else None
            device = state.base.rho.device

            def phase(name, fn, *args):
                if times is None:
                    return fn(*args)
                t0 = time.perf_counter()
                out = fn(*args)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                times[name] = time.perf_counter() - t0
                return out

            state = self._zero_rates(state)
            rfs = diag = None
            if stellar is not None:
                state, rfs, diag = phase("tracer", self.trace, state,
                                         stellar, rates_mode, split_compile,
                                         mesh)
                if times is not None:
                    times["tracer_phases"] = dict(
                        rays_multilevel.LAST_TRACE_PHASE_TIMES)
            if self.rt.config.run_uvb_transfer:
                state = phase("sweep", self._apply_sweep, state, mesh,
                              split_compile)
            out = phase("chemistry_sync", rest, state, rfs, *extra)
            if times is not None:
                self.last_phase_times = times
            return out, diag
        return step

    def step(self, state: amr_sparse.SparseMLState, stellar=None,
             mesh=None):
        """One full iteration; returns (state, RayDiagnostics), the
        diagnostics None unless the mode traces point sources (a
        StellarContext given in mode 1 or 8); on a mesh
        (mesh.shard_sparse_state's state) the zones sweep and the
        source-parallel tracer."""
        self._check_supported(stellar, mesh)
        return self._iteration(
            stellar if self.rt.config.run_stellar_transfer else None, "auto",
            lambda state, rfs: self._chemistry_and_sync(state),
            mesh=mesh)(state)

    def trace(self, state: amr_sparse.SparseMLState, stellar,
              rates_mode: str = "auto", host_phases: bool = False,
              mesh=None):
        """The point-source phase (the JAX package's
        SparseMLModel._traced): trace every source through every level's
        blocks and put the six deposit fields into the (zero-rate) state,
        level 0's as they are and a refined level's blocks times 8^l: the
        tables are over the BASE cell's volume (StellarContext.build), a
        level-l cell's is 8^-l of it.  Returns (state, the tracer's
        per-level rate fields as it made them, level 0 flat and the refined
        levels block-flat, RayDiagnostics); rates_mode and host_phases:
        rays_multilevel.trace_point_sources_sparse's; a mesh traces
        source-parallel (rays_dist.trace_point_sources_sparse_dist)."""
        args = (state, self.rt.geom, stellar.sources, stellar.tables)
        kw = dict(dust_approximation=stellar.dust_approximation,
                  max_pixel_level=stellar.max_pixel_level,
                  dtype=state.base.rho.dtype, rates_mode=rates_mode,
                  host_phases=host_phases)
        rfs, diag = (
            rays_multilevel.trace_point_sources_sparse(*args, **kw)
            if mesh is None
            else rays_dist.trace_point_sources_sparse_dist(*args, mesh, **kw))
        names = [f.name for f in dataclasses.fields(rays.RateFields)]
        base = dataclasses.replace(state.base, **{
            k: getattr(rfs[0], k).reshape(state.base.shape) for k in names})
        levels = tuple(
            dataclasses.replace(lv, fields=dataclasses.replace(lv.fields, **{
                k: getattr(rf, k).reshape(lv.cover.shape) * 8.0 ** ell
                for k in names}))
            for ell, (lv, rf) in enumerate(zip(state.levels, rfs[1:]),
                                           start=1))
        return dataclasses.replace(state, base=base, levels=levels), rfs, \
            diag

    def make_step(self, stellar=None, split_compile: bool = False,
                  mesh=None):
        """The iteration step, a plain eager function: state -> state, or
        with a StellarContext state -> (state, RayDiagnostics or None), as
        step returns them.  split_compile gives the same results and fills
        last_phase_times (_iteration); a mesh runs the zones sweep and the
        source-parallel tracer."""
        self._check_supported(stellar, mesh)
        step = self._iteration(
            stellar if self.rt.config.run_stellar_transfer else None, "auto",
            lambda state, rfs: self._chemistry_and_sync(state),
            split_compile, mesh)
        if stellar is None:
            return lambda state: step(state)[0]
        return step

    def pad_masks(self, state: amr_sparse.SparseMLState) -> list:
        """(nb,) bool padding-block mask of each refined level."""
        return [lv.pad_mask(self.rt.geom.nx * 2 ** ell)
                for ell, lv in enumerate(state.levels, start=1)]

    def initial_species(self, state: amr_sparse.SparseMLState,
                        **kwargs) -> tuple:
        """One chemistry_noneq.SpeciesState a level from the state's
        fields (species_from_field_state, with `kwargs`): level 0 dense
        (n, n, n), a refined level's blocks (nb, be, be, be) with the
        padding blocks zeroed (their zero fields give garbage species).
        The CLI's start of a block-sparse noneq run."""
        return (chemistry_noneq.species_from_field_state(state.base,
                                                         **kwargs),) + tuple(
            amr_sparse.zero_pad_blocks(
                chemistry_noneq.species_from_field_state(lv.fields, **kwargs),
                pad)
            for lv, pad in zip(state.levels, self.pad_masks(state)))

    def sync_noneq(self, state: amr_sparse.SparseMLState, species):
        """sync_restriction_sparse, then the species restricted onto
        refined parents (their children's average) through the same block
        geometry (amr_sparse.sync_restriction_tree): (state, species
        tuple)."""
        state = amr_sparse.sync_restriction_sparse(state)
        sp0, sp_levels = amr_sparse.sync_restriction_tree(
            state, species[0], tuple(species[1:]))
        return state, (sp0, *sp_levels)

    def make_noneq_step(self, dt: float, stellar=None, n_substeps: int = 200,
                        evolve_energy: bool = False,
                        split_compile: bool = False, mesh=None):
        """Transport + non-equilibrium 9-species chemistry on block-sparse
        storage (MultiLevelModel.make_noneq_step's, the JAX package's
        SparseMLModel.make_noneq_step): each level advanced by dt [s] with
        its own photo rates (evolve_level on the level's blocks, the
        tracer's k27..k31 times 8^l), the padding blocks of the fields and
        the species re-zeroed (the network on their zero fields is
        garbage), then the fields and the species restricted onto refined
        parents (sync_noneq).

        Returns step(state, species) -> (state, species), or with a
        StellarContext (built noneq=True) (state, species,
        RayDiagnostics): `species` is a tuple of one
        chemistry_noneq.SpeciesState a level, level 0 dense and the refined
        levels block-shaped (initial_species), the state's HI/HeI/HeII
        (and tgas with evolve_energy) synced from them each step; the
        tracer runs in its quadrature_noneq mode.  split_compile and mesh:
        as make_step takes them."""
        self._check_supported(stellar, mesh)
        tables = self.noneq_tables()
        traced = stellar is not None

        def evolve_and_sync(state, rfs, species):
            base, sp0 = self.evolve_level(0, state.base, species[0], rfs, dt,
                                          tables, n_substeps, evolve_energy)
            levels, new_species = [], [sp0]
            for ell, (lv, spc, pad) in enumerate(zip(
                    state.levels, species[1:], self.pad_masks(state)),
                    start=1):
                f, spc = self.evolve_level(ell, lv.fields, spc, rfs, dt,
                                           tables, n_substeps, evolve_energy)
                levels.append(dataclasses.replace(
                    lv, fields=amr_sparse.zero_pad_blocks(f, pad)))
                new_species.append(amr_sparse.zero_pad_blocks(spc, pad))
            return self.sync_noneq(dataclasses.replace(
                state, base=base, levels=tuple(levels)), new_species)

        body = self._iteration(stellar, "quadrature_noneq", evolve_and_sync,
                               split_compile, mesh)

        def step(state: amr_sparse.SparseMLState, species):
            (state, species), diag = body(state, species)
            return (state, species, diag) if traced else (state, species)
        return step

    def validate_coupling_depth(self, state: amr_sparse.SparseMLState,
                                tol: float = 1e-8, max_iters: int = 6) -> int:
        """The smallest coupling depth whose one-more-pass leaf Jmean
        residual is below tol, measured with the block-sparse sweep itself
        (in the run's window) on a 12-direction level-1 plan, and
        adopted."""
        rt = self.rt
        plan1 = sweep_multilevel.build_ml_sweep_plan(1, rt.geom.nx,
                                                     self.n_levels)
        k0, lv_k = self._kappas(state)
        win = self._ensure_window(state)

        def sweep(iters):
            return sweep_sparse.diffuse_sweep_sparse(
                k0, lv_k, state, plan1, rt.uvb, rt.geom.cell_size,
                n_coupling_iters=iters, window=win)

        def leaf_max_diff(a, b):
            (j0a, jba), (j0b, jbb) = a, b
            scale = max(float(j0a.abs().max()), 1e-300)
            res = float(torch.where(~state.refined0[None],
                                    (j0a - j0b).abs(), 0.0).max()) / scale
            for lv, x, y in zip(state.levels, jba, jbb):
                leaf = lv.cover & ~lv.refined
                d = float(torch.where(leaf[None], (x - y).abs(), 0.0).max())
                res = max(res, d / max(float(x.abs().max()), scale))
            return res

        prev = sweep(1)
        for iters in range(1, max_iters + 1):
            nxt = sweep(iters + 1)
            if leaf_max_diff(prev, nxt) < tol:
                self.n_coupling_iters = iters
                return iters
            prev = nxt
        self.n_coupling_iters = max_iters
        return max_iters

    def neutral_fraction(self, state: amr_sparse.SparseMLState) -> float:
        """Leaf-volume-weighted neutral hydrogen fraction, each level
        summed in float64 on the state's device."""
        def total(name):
            out = float(torch.where(state.refined0, 0.0, getattr(
                state.base, name).double()).sum())
            for ell, lv in enumerate(state.levels, start=1):
                leaf = lv.cover & ~lv.refined
                out += float(torch.where(leaf, getattr(
                    lv.fields, name).double(), 0.0).sum()) * 8.0 ** -ell
            return out
        return total("HI") / total("nh")
