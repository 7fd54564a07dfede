"""The main iteration: transport + chemistry cycle, and the model setup.

Mirrors the reference's driver flow (equiSources.f90:1230-1843):
  zero rates -> [point-source ray trace] -> [opacities + diffuse sweep] ->
  equilibrium chemistry -> neutral-fraction log.

`RTModel.setup()` performs the table initialization the reference does before
the loop (calc_rates, uniformTable, UVB amplitudes, powerSpectrumIndex,
uvbBetaTable; equiSources.f90:172-289) on the host and keeps the device
tables as buffers of the module.  The port covers the uniform grid in
modes 1, 6, 8 and 9 on one device; the compacting tracer (ROADMAP item 7)
and the distributed sweep and tracer strategies (item 15) raise
NotImplementedError.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..config import RunConfig
from ..constants import (
    ALPHA_QUASAR,
    ALPHA_STELLAR,
    CASE_B,
    COMPA,
    FOUR_PI,
    FREQUENCY_BIN_WIDTH,
    NFBINS,
    NU1,
    NU2,
    NU3,
)
from ..tables import chemistry_rates, spectral, uvb_models
from ..tables import stellar as stellar_tables
from . import chemistry, opacity, rays, sweep, sweep_cuda
from .state import FieldState, GridGeometry

# the six point-source deposit fields, in RateFields order
_RATE_FIELDS = ("krate24", "krate25", "krate26", "crate24", "crate25",
                "crate26")


@dataclasses.dataclass
class StellarContext:
    """Point-source transfer inputs for one iteration.

    The reference rebuilds the 11^4 attenuation tables per source
    (equiSources.f90:1298); here sources sharing an (age, metallicity)
    bucket share a table and the tables are stacked on a leading bucket
    axis for per-ray gathering.  The tables are tensors on the run's device.
    """
    population: "stellar_tables.StellarPopulation"
    sources: rays.SourceBatch
    tables: dict         # reaction_log/energy_log (B,3,11^4), quad_*, output_*
    n_stars_specific_age: int
    dust_approximation: int = 0
    max_pixel_level: int = 6

    @classmethod
    def build(cls, population, sources: rays.SourceBatch, geom: GridGeometry,
              age_s: float, metal_coefs: list[tuple[int, float]],
              n_stars_specific_age: int | None = None,
              dust_approximation: int = 0, max_pixel_level: int = 6,
              dust=None, noneq: bool = False, *,
              dtype: torch.dtype = torch.float32,
              device: torch.device | str = "cuda") -> "StellarContext":
        """Build stacked tables for the metallicity buckets at a fixed age
        slice (the reference uses timeReadTable = 10 Myr,
        equiSources.f90:1236), as `dtype` tensors on `device`.

        The tables are divided by the cell volume (in float64, on the host)
        so the ray deposits are volumetric rates [1/s/cm^3]: CGS cell
        volumes overflow float32 on the device.
        """
        if noneq:
            raise NotImplementedError(
                "the non-equilibrium deposit weights (noneq=True) are not "
                "ported yet: ROADMAP item 9")
        i_spec, coef_spec = population.age_bracket(age_s)
        log_vol = float(np.log(geom.cell_volume))
        reaction, energy, quad_w = [], [], []
        out = quad_a = None
        for i_metal, coef_metal in metal_coefs:
            t = stellar_tables.build_source_tables(
                population, i_spec, coef_spec, i_metal, coef_metal, dust=dust)
            reaction.append(t.reaction_log - log_vol)
            energy.append(t.energy_log - log_vol)
            out = t
            quad_a, w = stellar_tables.quadrature_arrays(
                population, i_spec, coef_spec, i_metal, coef_metal, dust=dust)
            quad_w.append(w / geom.cell_volume)
        host = {
            "reaction_log": np.stack(reaction),
            "energy_log": np.stack(energy),
            # direct-quadrature factors: the tracer's default path
            # (core.rays._deposit_quadrature)
            "quad_A": quad_a,
            "quad_W": np.stack(quad_w),
            "output_freq": out.output_freq,
            "output_sigma24": out.output_sigma24,
            "output_sigma25": out.output_sigma25,
            "output_sigma26": out.output_sigma26,
            "output_sigma_dust": out.output_sigma_dust,
        }
        tables = {k: torch.as_tensor(v, dtype=dtype, device=device)
                  for k, v in host.items()}
        return cls(population=population, sources=sources, tables=tables,
                   n_stars_specific_age=(n_stars_specific_age
                                         or int(sources.weight.sum())),
                   dust_approximation=dust_approximation,
                   max_pixel_level=max_pixel_level)


class RTModel(nn.Module):
    """All static data for a run: host tables, geometry, device buffers
    (dev_tables.k16/cool, ksi_matrix, ksi_all, gamma_matrix)."""

    def __init__(self, config: RunConfig, geom: GridGeometry, tables,
                 dev_tables: chemistry.RateTablesDevice, quasar, stellar,
                 groups, opacity_coef, ksi_matrix, uvb: np.ndarray,
                 uniform_quasar: float, uniform_stellar: float,
                 sweep_plan: sweep.SweepPlan | None, alpha_bands,
                 ksi_all=None, gamma_matrix=None):
        super().__init__()
        self.config = config
        self.geom = geom
        self.tables = tables
        self.dev_tables = dev_tables
        self.quasar = quasar
        self.stellar = stellar
        self.groups = groups            # (g1, g2, g3) when UVB transfer is on
        self.opacity_coef = opacity_coef
        self.uvb = uvb                  # (3,) band boundary intensities
        self.uniform_quasar = uniform_quasar
        self.uniform_stellar = uniform_stellar
        self.sweep_plan = sweep_plan
        self.alpha_bands = alpha_bands
        # (3 bands, 3 species) for diffuse rates; (3 bands, 8 channels) and
        # (3 bands, 3 species) for the non-equilibrium mode
        self.register_buffer("ksi_matrix", ksi_matrix)
        self.register_buffer("ksi_all", ksi_all)
        self.register_buffer("gamma_matrix", gamma_matrix)

    # ----- setup ---------------------------------------------------------

    @classmethod
    def setup(cls, config: RunConfig, geom: GridGeometry, dtype: torch.dtype,
              device: torch.device | str,
              recombination_type: int | None = None) -> "RTModel":
        rt = CASE_B if recombination_type is None else recombination_type
        tables = chemistry_rates.calc_rates(recombination_type=rt)
        dev_tables = chemistry.RateTablesDevice.from_tables(tables, dtype,
                                                            device)
        quasar, stellar = spectral.uniform_table(
            NFBINS, FREQUENCY_BIN_WIDTH, ALPHA_QUASAR, ALPHA_STELLAR)

        z = config.current_redshift
        amps = uvb_models.uniform_uvb_intensities(z, config.uvb_coefficient)
        uniform_quasar, uniform_stellar = amps.quasar, amps.stellar

        def dev(x):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

        groups = opacity_coef = ksi_matrix = ksi_all = gamma_matrix = None
        alpha_bands = None
        uvb = np.zeros(3)
        if config.run_uvb_transfer:
            s_bands, q_bands = uvb_models.band_intensities(
                amps, ALPHA_STELLAR, ALPHA_QUASAR)
            uvb1, a1 = spectral.power_spectrum_index(
                s_bands[0], ALPHA_STELLAR, q_bands[0], ALPHA_QUASAR, NU1, NU2,
                True)
            uvb2, a2 = spectral.power_spectrum_index(
                s_bands[1], ALPHA_STELLAR, q_bands[1], ALPHA_QUASAR, NU2, NU3,
                True)
            uvb3, a3 = spectral.power_spectrum_index(
                s_bands[2], ALPHA_STELLAR, q_bands[2], ALPHA_QUASAR, NU3, NU3,
                False)
            uvb = np.array([uvb1, uvb2, uvb3])
            alpha_bands = (a1, a2, a3)
            g1, g2, g3 = spectral.uvb_beta_table(NFBINS, FREQUENCY_BIN_WIDTH,
                                                 alpha_bands)
            groups = (g1, g2, g3)
            opacity_coef = opacity.GroupOpacityCoefficients.from_groups(
                g1, g2, g3)
            # rows: bands; cols: (HI ksi24, HeII ksi25, HeI ksi26)
            ksi_matrix = dev([[g.ksi[24], g.ksi[25], g.ksi[26]]
                              for g in groups])
            ksi_all = dev([[g.ksi[c] for c in range(24, 32)] for g in groups])
            gamma_matrix = dev([[g.gammaHI, g.gammaHeII, g.gammaHeI]
                                for g in groups])

        # reionization-history renormalization (equiSources.f90:259-289)
        if config.reionization_model:
            coef = uvb_models.reionization_rate_coefficient(
                z, config.reionization_model, uniform_quasar, uniform_stellar,
                quasar.ksi[24], stellar.ksi[24])
            uniform_quasar *= coef
            uniform_stellar *= coef
            uvb = uvb * coef

        sweep_plan = None
        if config.run_uvb_transfer:
            sweep_plan = sweep.build_sweep_plan(config.n_angular_level,
                                                geom.nx)

        return cls(config=config, geom=geom, tables=tables,
                   dev_tables=dev_tables, quasar=quasar, stellar=stellar,
                   groups=groups, opacity_coef=opacity_coef,
                   ksi_matrix=ksi_matrix, uvb=uvb,
                   uniform_quasar=uniform_quasar,
                   uniform_stellar=uniform_stellar, sweep_plan=sweep_plan,
                   alpha_bands=alpha_bands, ksi_all=ksi_all,
                   gamma_matrix=gamma_matrix)

    # ----- derived coefficients -----------------------------------------

    @property
    def gamma_thin(self) -> tuple[float, float, float]:
        """Optically-thin uniform-UVB photoionization rates [1/s]
        (equiSources.f90:3558-3560): (HI, HeII, HeI)."""
        q, s = self.quasar, self.stellar
        return (
            FOUR_PI * (self.uniform_quasar * q.ksi[24]
                       + self.uniform_stellar * s.ksi[24]),
            FOUR_PI * (self.uniform_quasar * q.ksi[25]
                       + self.uniform_stellar * s.ksi[25]),
            FOUR_PI * (self.uniform_quasar * q.ksi[26]
                       + self.uniform_stellar * s.ksi[26]),
        )

    @property
    def heat_thin(self) -> tuple[float, float, float]:
        """Optically-thin photo-heating coefficients
        (thermalEquilibrium, equiSources.f90:3931-3933): (HI, HeII, HeI)."""
        q, s = self.quasar, self.stellar
        return (
            FOUR_PI * (self.uniform_quasar * q.gammaHI
                       + self.uniform_stellar * s.gammaHI),
            FOUR_PI * (self.uniform_quasar * q.gammaHeII
                       + self.uniform_stellar * s.gammaHeII),
            FOUR_PI * (self.uniform_quasar * q.gammaHeI
                       + self.uniform_stellar * s.gammaHeI),
        )

    # ----- setup-time equilibrium ----------------------------------------

    def initialize_equilibrium(self, state: FieldState) -> FieldState:
        """Initial ionization equilibrium under the uniform UVB, run twice
        because the self-shielding surface moves after the first pass
        (equiSources.f90:1012-1021), followed by the thermal-balance
        diagnostic (:1026-1033)."""
        n_iter = 110 if state.rho.dtype == torch.float64 else 60
        for _ in range(2):
            state = chemistry.solve_rate_equations(
                state.zero_rates(), self.geom, self.dev_tables,
                gamma_thin=self.gamma_thin,
                self_shielding_threshold=self.config.self_shielding_threshold,
                run_uvb_transfer=False, n_iter=n_iter)
        return chemistry.thermal_equilibrium(
            state, heat_thin=self.heat_thin,
            self_shielding_threshold=self.config.self_shielding_threshold,
            current_redshift=self.config.current_redshift,
            tables=self.dev_tables, compa=COMPA)

    # ----- the iteration -------------------------------------------------

    def _check_supported(self, stellar, mesh) -> None:
        cfg = self.config
        if mesh is not None:
            raise NotImplementedError(
                "multi-device meshes are not ported yet: ROADMAP item 15")
        if stellar is None:
            return
        if cfg.tracer_compact:
            raise NotImplementedError(
                "tracer_compact=True (the compacting tracer) is not ported "
                "yet: ROADMAP item 7")
        if cfg.tracer_strategy == "domain":
            raise NotImplementedError(
                "tracer_strategy='domain' (the domain-decomposed tracer) is "
                "not ported yet: ROADMAP item 15")

    def trace(self, state: FieldState, stellar: StellarContext
              ) -> tuple[FieldState, rays.RayDiagnostics]:
        """The point-source phase: trace every source and put the six
        deposit fields into the (zero-rate) state."""
        rf, diag = rays.trace_point_sources(
            state, self.geom, stellar.sources, stellar.tables,
            dust_approximation=stellar.dust_approximation,
            max_pixel_level=stellar.max_pixel_level,
            dtype=state.rho.dtype)
        shape = state.shape
        state = dataclasses.replace(
            state, **{name: getattr(rf, name).reshape(shape)
                      for name in _RATE_FIELDS})
        return state, diag

    def transport_chemistry_step(self, state: FieldState,
                                 stellar: StellarContext | None = None,
                                 mesh=None):
        """One full transport + chemistry iteration (a function of state;
        the input state is not modified).  With a StellarContext in a
        point-source mode the tracer runs first and (state, RayDiagnostics)
        is returned; else the state alone."""
        self._check_supported(stellar, mesh)
        state = state.zero_rates()
        if not (self.config.run_stellar_transfer and stellar is not None):
            return self._sweep_and_chemistry(state)
        state, diag = self.trace(state, stellar)
        return self._sweep_and_chemistry(state), diag

    def _run_sweep(self, kappa: torch.Tensor) -> torch.Tensor:
        """The "auto" sweep on one device: the hand-written CUDA kernel for
        a CUDA tensor (cfg.use_pallas_sweep), else the plain slab scan."""
        cfg = self.config
        if cfg.sweep_strategy != "auto":
            raise NotImplementedError(
                f"sweep_strategy={cfg.sweep_strategy!r} is not ported yet: "
                f"ROADMAP item 15")
        cell = self.geom.cell_size
        if cfg.use_pallas_sweep and kappa.is_cuda:
            lm = cfg.sweep_logmean
            if lm == "auto":
                # clamped in f32 (per-iteration neutral-fraction deltas
                # <= 8e-7 in the JAX package's A/B), exact in f64
                lm = "clamped" if kappa.dtype == torch.float32 else "exact"
            return sweep_cuda.diffuse_sweep_kernel(
                kappa, self.sweep_plan, self.uvb, cell, logmean=lm)
        return sweep.diffuse_sweep(kappa, self.sweep_plan, self.uvb, cell)

    def _sweep_and_chemistry(self, state: FieldState) -> FieldState:
        cfg = self.config
        if cfg.run_uvb_transfer:
            kappa = opacity.compute_opacities(state.HI, state.HeI, state.HeII,
                                              self.opacity_coef)
            state = dataclasses.replace(state, Jmean=self._run_sweep(kappa))

        return chemistry.solve_rate_equations(
            state, self.geom, self.dev_tables,
            ksi_matrix=self.ksi_matrix,
            gamma_thin=self.gamma_thin,
            self_shielding_threshold=self.config.self_shielding_threshold,
            run_uvb_transfer=cfg.run_uvb_transfer,
            n_iter=110 if state.rho.dtype == torch.float64 else 60)

    def make_step(self, stellar: StellarContext | None = None, mesh=None):
        """The iteration step, a plain eager function (PyTorch has no jit
        to apply here): state -> state, or with a StellarContext
        state -> (state, RayDiagnostics), tracing whatever the mode."""
        self._check_supported(stellar, mesh)
        if stellar is None:
            return self.transport_chemistry_step

        def step(state: FieldState):
            state, diag = self.trace(state.zero_rates(), stellar)
            return self._sweep_and_chemistry(state), diag

        return step

    def neutral_fraction(self, state: FieldState) -> float:
        """Global neutral-hydrogen mass fraction (computeMass,
        equiSources.f90:4369-4393 / :1833-1836)."""
        return float(torch.sum(state.HI) / torch.sum(state.nh))


def iterate_to_equilibrium(model: RTModel, state: FieldState,
                           max_iter: int = 50, tol: float = 1e-6,
                           log=None) -> tuple[FieldState, list[float]]:
    """Run transport+chemistry iterations until the global neutral fraction
    stabilizes (the reference loops forever and is killed by hand; this adds
    the convergence check the reference's author applied by eye on the
    `time` log)."""
    step = model.make_step()
    history = []
    prev = np.inf
    for it in range(max_iter):
        state = step(state)
        nf = model.neutral_fraction(state)
        history.append(nf)
        if log is not None:
            log(it, nf)
        if abs(nf - prev) <= tol * max(nf, 1e-30):
            break
        prev = nf
    return state, history
