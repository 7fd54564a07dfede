"""The main iteration: transport + chemistry cycle, and the model setup.

Mirrors the reference's driver flow (equiSources.f90:1230-1843):
  zero rates -> [point-source ray trace] -> [opacities + diffuse sweep] ->
  equilibrium chemistry -> neutral-fraction log.

`RTModel.setup()` performs the table initialization the reference does before
the loop (calc_rates, uniformTable, UVB amplitudes, powerSpectrumIndex,
uvbBetaTable; equiSources.f90:172-289) on the host and keeps the device
tables as buffers of the module.  The port covers the uniform grid in
modes 1, 6, 8 and 9, on one device and on a 1-D grid mesh of P ranks on
one device (parallel/mesh.py: every sweep strategy, and the point sources
traced source-parallel, parallel/rays_dist.py), with equilibrium
chemistry (make_step) or the non-equilibrium 9-species network
(make_noneq_step).  The domain-decomposed tracer (tracer_strategy
"domain" on a mesh; ROADMAP, "Distribution") raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import functools

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
from ..parallel import rays_dist, sweep_dist, sweep_rdma
from ..parallel.mesh import GridMesh
from ..tables import chemistry_rates, spectral, uvb_models
from ..tables import stellar as stellar_tables
from . import chemistry, chemistry_noneq, opacity, rays, sweep, sweep_cuda
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
        volumes overflow float32 on the device.  noneq=True adds the
        k27..k31 weights 'quad_W27' of the tracer's quadrature_noneq mode,
        divided by the cell's face area: the tracer weighs them by the
        segment length in cells.  Over the cell volume, as the JAX package
        divides them, they fall below float32's normal range (8.6e-39 at
        most at 16^3 in a 300 kpc box), where a device that flushes
        subnormals deposits nothing.
        """
        i_spec, coef_spec = population.age_bracket(age_s)
        log_vol = float(np.log(geom.cell_volume))
        reaction, energy, quad_w, quad_w27 = [], [], [], []
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
            if noneq:
                w27 = stellar_tables.quadrature_noneq_weights(
                    population, i_spec, coef_spec, i_metal, coef_metal,
                    dust=dust)
                quad_w27.append(w27 / geom.cell_size ** 2)
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
        if noneq:
            host["quad_W27"] = np.stack(quad_w27)
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

    @property
    def photo_thin_all(self) -> np.ndarray:
        """Optically-thin uniform-UVB rates [1/s] for all 8 photo channels
        k24..k31 (the reference integrates its uniform ksi above nu1 only,
        uniformTable.f90:137-192; followed here)."""
        q, s = self.quasar, self.stellar
        return np.array([
            FOUR_PI * (self.uniform_quasar * q.ksi[c]
                       + self.uniform_stellar * s.ksi[c])
            for c in range(24, 32)])

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
        check_mesh(self.config, stellar, mesh)

    def trace(self, state: FieldState, stellar: StellarContext,
              rates_mode: str = "auto", compact: bool = False, mesh=None):
        """The point-source phase: trace every source and put the six
        deposit fields into the (zero-rate) state; (state, RateFields,
        RayDiagnostics).  rates_mode: rays.trace_point_sources's; compact
        runs rays.trace_point_sources_compact instead; a mesh runs the
        source-parallel tracer (rays_dist.trace_point_sources_dist), as
        the JAX package's make_step does before it looks at
        tracer_compact."""
        kw = dict(dust_approximation=stellar.dust_approximation,
                  max_pixel_level=stellar.max_pixel_level,
                  dtype=state.rho.dtype, rates_mode=rates_mode)
        if mesh is not None:
            rf, diag = rays_dist.trace_point_sources_dist(
                state, self.geom, stellar.sources, stellar.tables, mesh,
                **kw)
        else:
            tracer = (rays.trace_point_sources_compact if compact
                      else rays.trace_point_sources)
            rf, diag = tracer(state, self.geom, stellar.sources,
                              stellar.tables, **kw)
        shape = state.shape
        state = dataclasses.replace(
            state, **{name: getattr(rf, name).reshape(shape)
                      for name in _RATE_FIELDS})
        return state, rf, diag

    def transport_chemistry_step(self, state: FieldState,
                                 stellar: StellarContext | None = None,
                                 mesh=None):
        """One full transport + chemistry iteration (a function of state;
        the input state is not modified).  With a StellarContext in a
        point-source mode the tracer runs first (source-parallel on a
        mesh: where the JAX package's traces on one device, the port's
        runs the tracer of its make_step) and (state, RayDiagnostics) is
        returned; else the state alone."""
        self._check_supported(stellar, mesh)
        state = state.zero_rates()
        if not (self.config.run_stellar_transfer and stellar is not None):
            return self._sweep_and_chemistry(state, mesh)
        state, _, diag = self.trace(state, stellar, mesh=mesh)
        return self._sweep_and_chemistry(state, mesh), diag

    def _run_sweep(self, kappa: torch.Tensor, mesh=None) -> torch.Tensor:
        """Dispatch cfg.sweep_strategy.  The explicit strategies need a 1-D
        `mesh`: "pipelined" (the plain halo-line scan) and "rdma" (the ring
        kernel on a CUDA tensor) sweep each rank's k-block, "zones" deals
        the octant zones to the ranks (parallel/sweep_dist.py,
        parallel/sweep_rdma.py).  "auto" is the sweep on one device, mesh
        or not (all ranks share it): the hand-written CUDA kernel for a
        CUDA tensor (cfg.use_pallas_sweep), else the plain slab scan."""
        cfg = self.config
        strategy = cfg.sweep_strategy
        if strategy != "auto" and mesh is None:
            raise ValueError(f"sweep_strategy={strategy!r} needs a mesh")
        cell = self.geom.cell_size
        plan = self.sweep_plan
        if strategy == "pipelined":
            return sweep_dist.diffuse_sweep_pipelined(kappa, plan, self.uvb,
                                                      cell, mesh)
        if strategy == "zones":
            return sweep_dist.diffuse_sweep_zone_parallel(kappa, plan,
                                                          self.uvb, cell, mesh)
        if strategy == "rdma":
            return sweep_rdma.diffuse_sweep_rdma(kappa, plan, self.uvb, cell,
                                                 mesh)
        if strategy != "auto":
            raise ValueError(f"unknown sweep_strategy {strategy!r}")
        if cfg.use_pallas_sweep and kappa.is_cuda:
            lm = cfg.sweep_logmean
            if lm == "auto":
                # clamped in f32 (per-iteration neutral-fraction deltas
                # <= 8e-7 in the JAX package's A/B), exact in f64
                lm = "clamped" if kappa.dtype == torch.float32 else "exact"
            return sweep_cuda.diffuse_sweep_kernel(kappa, plan, self.uvb,
                                                   cell, logmean=lm)
        return sweep.diffuse_sweep(kappa, plan, self.uvb, cell)

    def _sweep_and_chemistry(self, state: FieldState,
                             mesh=None) -> FieldState:
        """Opacities, the sweep and chemistry; all but the sweep are
        elementwise and run on the whole field, mesh or not."""
        cfg = self.config
        if cfg.run_uvb_transfer:
            kappa = opacity.compute_opacities(state.HI, state.HeI, state.HeII,
                                              self.opacity_coef)
            state = dataclasses.replace(state,
                                        Jmean=self._run_sweep(kappa, mesh))

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
        state -> (state, RayDiagnostics), tracing whatever the mode, with
        the compacting tracer under config.tracer_compact (as the JAX
        package's make_step; its noneq step and transport_chemistry_step
        trace with the default one).  With a `mesh` (parallel.mesh.GridMesh)
        the point sources are traced source-parallel on it
        (rays_dist.trace_point_sources_dist; tracer_compact is then
        ignored, as in the JAX package) and the sweep runs the configured
        strategy on it."""
        self._check_supported(stellar, mesh)
        if stellar is None:
            return functools.partial(self.transport_chemistry_step,
                                     mesh=mesh)
        compact = self.config.tracer_compact

        def step(state: FieldState):
            state, _, diag = self.trace(state.zero_rates(), stellar,
                                        compact=compact, mesh=mesh)
            return self._sweep_and_chemistry(state, mesh), diag

        return step

    # ----- non-equilibrium chemistry mode ---------------------------------

    def _assemble_photo_rates(self, state: FieldState, rf=None
                              ) -> chemistry_noneq.PhotoRates:
        """Per-cell PhotoRates for the 9-species network from the transport
        products: point-source deposits (krate/crate fields + the k27..k31
        channels of a NoneqRateFields) plus diffuse-band or uniform-thin UVB
        contributions.  Rate assembly mirrors solveRateEquations
        (equiSources.f90:3519-3562) extended to the secondary channels."""
        cfg = self.config
        nh, nhe = state.nh, state.nhe
        HI, HeI, HeII = chemistry.clamp_species(nh, nhe, state.HI, state.HeI,
                                                state.HeII)
        k24 = chemistry.photo_rates_from_sources(state.krate24, HI)
        k25 = chemistry.photo_rates_from_sources(state.krate25, HeII)
        k26 = chemistry.photo_rates_from_sources(state.krate26, HeI)
        heat = state.crate24 + state.crate25 + state.crate26  # [erg/cm^3/s]
        k_sec = [0.0] * 5
        if isinstance(rf, rays.NoneqRateFields):
            k_sec = [getattr(rf, f"krate{c}").reshape(state.shape)
                     for c in range(27, 32)]

        if cfg.run_uvb_transfer:
            j = FOUR_PI * state.Jmean                      # (3, nx, ny, nz)
            ch = torch.tensordot(self.ksi_all, j, dims=([0], [0]))  # (8, ...)
            k24, k25, k26 = k24 + ch[0], k25 + ch[1], k26 + ch[2]
            k_sec = [k + ch[3 + i] for i, k in enumerate(k_sec)]
            gm = self.gamma_matrix
            heat = heat + (
                torch.tensordot(gm[:, 0], j, dims=([0], [0])) * HI
                + torch.tensordot(gm[:, 1], j, dims=([0], [0])) * HeII
                + torch.tensordot(gm[:, 2], j, dims=([0], [0])) * HeI)
        else:
            thin_all = self.photo_thin_all
            u24, u25, u26 = chemistry.uniform_photo_rates(
                HI, HeI, HeII, cfg.self_shielding_threshold,
                tuple(thin_all[:3]))
            # the same self-shielding switch gates the secondary channels
            shielded_off = (u24 > 0.0).to(HI.dtype)
            k24, k25, k26 = k24 + u24, k25 + u25, k26 + u26
            k_sec = [k + float(thin_all[3 + i]) * shielded_off
                     for i, k in enumerate(k_sec)]
            ht = self.heat_thin
            heat = heat + shielded_off * (ht[0] * HI + ht[1] * HeII
                                          + ht[2] * HeI)

        return chemistry_noneq.PhotoRates(
            k24=k24, k25=k25, k26=k26, k27=k_sec[0], k28=k_sec[1],
            k29=k_sec[2], k30=k_sec[3], k31=k_sec[4], heat=heat)

    def make_noneq_step(self, dt: float,
                        stellar: StellarContext | None = None,
                        n_substeps: int = 200,
                        evolve_energy: bool = False, mesh=None):
        """Transport + NON-EQUILIBRIUM chemistry iteration advancing the
        9-species network by dt [s] per step (the capability the reference
        built its k1..k19/k13dd/sigma24..31 tables for but never wired;
        coll_rates.f:3-234, colh2diss.f:3-120).

        Returns step(state, species) -> (state, species), or with a
        StellarContext (state, species, RayDiagnostics): `state` is the
        FieldState the transport sees (HI/HeI/HeII synced from the species
        each step, tgas too with evolve_energy), `species` the
        chemistry_noneq.SpeciesState; initialize it with
        chemistry_noneq.species_from_field_state.  The tracer runs in its
        quadrature_noneq mode (the StellarContext needs noneq=True).

        The network's tables are the model's, in the run's dtype on its
        device.  With a `mesh` (parallel.mesh.GridMesh) the tracer runs
        source-parallel on it, the sweep the configured strategy, and the
        network, elementwise, on the whole field.
        """
        self._check_supported(stellar, mesh)
        k16 = self.dev_tables.k16
        noneq_tables = chemistry_noneq.NoneqTablesDevice.from_tables(
            self.tables, k16.dtype, k16.device)
        cfg = self.config

        def sweep_and_evolve(state: FieldState, species, rf):
            if cfg.run_uvb_transfer:
                kappa = opacity.compute_opacities(
                    state.HI, state.HeI, state.HeII, self.opacity_coef)
                # the mesh must reach _run_sweep: the explicit strategies
                # (pipelined/zones/rdma) raise without it
                state = dataclasses.replace(state,
                                            Jmean=self._run_sweep(kappa, mesh))
            photo = self._assemble_photo_rates(state, rf)
            species = chemistry_noneq.evolve_noneq(
                species, dt, noneq_tables, photo=photo,
                n_substeps=n_substeps, evolve_energy=evolve_energy,
                tgas_fixed=None if evolve_energy else state.tgas,
                current_redshift=cfg.current_redshift)
            dtype = state.HI.dtype
            state = dataclasses.replace(
                state, HI=species.HI.to(dtype), HeI=species.HeI.to(dtype),
                HeII=species.HeII.to(dtype),
                tgas=(species.tgas.to(dtype) if evolve_energy
                      else state.tgas))
            return state, species

        if stellar is None:
            def step(state: FieldState, species):
                return sweep_and_evolve(state.zero_rates(), species, None)
            return step

        def step_traced(state: FieldState, species):
            state, rf, diag = self.trace(state.zero_rates(), stellar,
                                         "quadrature_noneq", mesh=mesh)
            state, species = sweep_and_evolve(state, species, rf)
            return state, species, diag

        return step_traced

    def neutral_fraction(self, state: FieldState) -> float:
        """Global neutral-hydrogen mass fraction (computeMass,
        equiSources.f90:4369-4393 / :1833-1836)."""
        return float(torch.sum(state.HI) / torch.sum(state.nh))


def check_mesh(config, stellar, mesh) -> None:
    """What the models still refuse on a mesh: TypeError for a mesh that is
    not a parallel.mesh.GridMesh, NotImplementedError for point sources
    under tracer_strategy "domain" (the domain-decomposed tracer,
    parallel/rays_domain.py).  Without a mesh "sources" and "domain" both
    run the single-device tracer, as in the JAX package."""
    if mesh is None:
        return
    if not isinstance(mesh, GridMesh):
        raise TypeError(f"mesh must be a parallel.mesh.GridMesh, got "
                        f"{type(mesh).__name__}")
    if stellar is not None and config.tracer_strategy == "domain":
        raise NotImplementedError(
            "tracer_strategy 'domain' (the domain-decomposed tracer, "
            "parallel/rays_domain.py) is not ported yet: ROADMAP, "
            "Distribution")


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
