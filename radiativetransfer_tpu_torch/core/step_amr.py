"""Full transport + chemistry iteration on a two-level AMR grid.

Counterpart of AMRModel in the JAX package's core/step_amr.py, the AMR
analog of core/step.py: zero rates -> point-source trace (rays_amr) ->
opacities + two-level sweep (sweep_amr) -> per-level equilibrium chemistry
-> restriction sync (the reference's recursive per-leaf updates walk the
octree; here each level is one dense elementwise pass).  Modes 9 (UVB
only), 8 (point sources and the UVB), 1 (point sources and the thin UVB)
and 6 (the thin UVB, no stars) run on one device; the device mesh
(shard_amr_state, with the distributed two-level tracers) and the L-level
and block-sparse models are not ported yet and raise NotImplementedError
naming their ROADMAP items.
"""

from __future__ import annotations

import dataclasses

import torch

from . import amr, chemistry, opacity, rays_amr, sweep_amr
from .state import GridGeometry


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

    @staticmethod
    def _check_supported(mesh) -> None:
        if mesh is not None:
            raise NotImplementedError(
                "a two-level AMR state on a mesh (shard_amr_state) is not "
                "ported yet: ROADMAP, Distribution")

    @staticmethod
    def _zero_rates(state: amr.AMRState) -> amr.AMRState:
        return dataclasses.replace(state, base=state.base.zero_rates(),
                                   fine=state.fine.zero_rates())

    def step(self, state: amr.AMRState, stellar=None, mesh=None):
        """One iteration; returns (state, RayDiagnostics), the diagnostics
        None unless the mode traces point sources (a StellarContext
        given in mode 1 or 8)."""
        self._check_supported(mesh)
        state = self._zero_rates(state)
        diag = None
        if self.rt.config.run_stellar_transfer and stellar is not None:
            state, diag = self.trace(state, stellar)
        return self._sweep_and_chemistry(state), diag

    def trace(self, state: amr.AMRState, stellar):
        """The point-source phase (the JAX package's AMRModel._traced):
        trace every source through both levels and put the six deposit
        fields into the (zero-rate) state, the base level's as they are
        and the fine level's times 8: the tables are over the BASE cell's
        volume (StellarContext.build), a fine cell's is an eighth of it.
        Returns (state, RayDiagnostics)."""
        rfb, rff, diag = rays_amr.trace_point_sources_amr(
            state, self.rt.geom, stellar.sources, stellar.tables,
            dust_approximation=stellar.dust_approximation,
            max_pixel_level=stellar.max_pixel_level,
            dtype=state.base.rho.dtype)
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
        with a StellarContext state -> (state, RayDiagnostics), tracing
        whatever the mode (as RTModel.make_step)."""
        self._check_supported(mesh)
        if stellar is None:
            return lambda state: self.step(state)[0]

        def step(state: amr.AMRState):
            state, diag = self.trace(self._zero_rates(state), stellar)
            return self._sweep_and_chemistry(state), diag

        return step

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

