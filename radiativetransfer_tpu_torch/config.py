"""Run configuration.

Replaces the reference's flat `inputParameters` file with a dataclass that
keeps the same 14 semantic knobs (inputParameters:1-14,
parse loop equiSources.f90:100-128), plus the device-specific knobs
(precision, sweep kernel, sharding).  A parser for the reference's
key = value format is provided for drop-in compatibility, along with JSON.
"""

from __future__ import annotations

import dataclasses
import json
import re

from .constants import KPC, MYR

# run modes (equiSources.f90:65-67)
MODE_STELLAR_TRANSFER_THIN_UVB = 1
MODE_PLOT_PDFS = 2
MODE_INITIAL_CONFIGURATION = 3
MODE_PRINT_NUMBER_OF_CELLS = 4
MODE_NO_STARS_THIN_UVB = 6
MODE_CLUMPING_FACTOR = 7
MODE_BOTH_STELLAR_UVB_TRANSFER = 8
MODE_UVB_TRANSFER_ONLY = 9


@dataclasses.dataclass
class RunConfig:
    """All run-time knobs.  Defaults mirror equiSources.f90:89-104."""
    sph_dir: str = ""
    synthesis_dir: str = ""
    grid: str = ""
    sources: str = ""
    current_redshift: float = 3.0
    mode: int = MODE_STELLAR_TRANSFER_THIN_UVB
    dust_approximation: int = 0          # 0=noDust 1=completeSublimation 2=noSublimation
    self_shielding_threshold_kpc: float = 1.0
    mass_stellar_particle: int = 1
    upper_age_limit_myr: float = 10.0
    restart: int = 0
    restart_cell_array_name: str = ""
    reionization_model: int = 0          # 0=off, 6 or 10
    uvb_coefficient: float = 1.0

    # --- additions with no reference analog (field for field the same as
    # the JAX package's RunConfig, so one config means the same to both) ---
    dtype: str = "float32"               # compute dtype for device kernels
    use_pallas_sweep: bool = True        # hand-written CUDA sweep kernel on a
    #                                      CUDA device vs the plain slab scan
    n_angular_level: int = 3             # 12*4**(L-1) sweep directions
    mesh_shape: tuple[int, ...] = ()     # () = single device
    max_iterations: int = 0              # 0 = run until externally stopped
    # sweep distribution strategy: "auto" (the local sweep on one device),
    # or an explicit collective schedule on a 1-D mesh: "pipelined",
    # "zones", "rdma" (not ported yet: RTModel raises NotImplementedError)
    sweep_strategy: str = "auto"
    # logmean form: "exact" (reference two-branch, emi = 1 exactly in
    # transparent cells) or "clamped" (branch-free min-clamp, bounded
    # emissivity bias <= 1.75e-4 below tau = 3.5e-4)
    sweep_logmean: str = "auto"   # auto: clamped in f32, exact in f64
    # single-device tracer: host-driven final-phase dead-lane compaction
    # (the point-source tracer is not ported yet)
    tracer_compact: bool = False
    # "sources": shard sources, all-gather fields; "domain": shard fields,
    # migrate rays between shards (distributed tracers not ported yet)
    tracer_strategy: str = "sources"

    @property
    def self_shielding_threshold(self) -> float:
        """[cm]"""
        return self.self_shielding_threshold_kpc * KPC

    @property
    def upper_age_limit(self) -> float:
        """[s]"""
        return self.upper_age_limit_myr * MYR

    @property
    def run_stellar_transfer(self) -> bool:
        return self.mode in (MODE_STELLAR_TRANSFER_THIN_UVB,
                             MODE_BOTH_STELLAR_UVB_TRANSFER)

    @property
    def run_uvb_transfer(self) -> bool:
        return self.mode in (MODE_UVB_TRANSFER_ONLY,
                             MODE_BOTH_STELLAR_UVB_TRANSFER)

    @property
    def read_kinematics(self) -> bool:
        """Grid filename containing 'vel' enables kinematics
        (equiSources.f90:144-150)."""
        return "vel" in self.grid

    @property
    def read_metals(self) -> bool:
        """Grid filename containing 'met' enables metallicities
        (equiSources.f90:152-158)."""
        return "met" in self.grid

    @property
    def n_directions(self) -> int:
        return 12 * 4 ** (self.n_angular_level - 1)


_LEGACY_KEYS = {
    "sphDir": ("sph_dir", str),
    "synthesisDir": ("synthesis_dir", str),
    "grid": ("grid", str),
    "sources": ("sources", str),
    "sourcesWithRadii": (None, str),
    "currentRedshift": ("current_redshift", float),
    "mode": ("mode", int),
    "dustApproximation": ("dust_approximation", int),
    "selfShieldingThreshold": ("self_shielding_threshold_kpc", float),
    "massStellarParticle": ("mass_stellar_particle", int),
    "upperAgeLimit": ("upper_age_limit_myr", float),
    "restart": ("restart", int),
    "restartCellArrayName": ("restart_cell_array_name", str),
    "reionizationModel": ("reionization_model", int),
    "uvbCoefficient": ("uvb_coefficient", float),
}


def parse_legacy_input_parameters(text: str) -> RunConfig:
    """Parse the reference's `inputParameters` flat key = value format.

    Values may carry trailing `//` comments and quoted strings, as in the
    reference file (inputParameters:8-13).
    """
    cfg = RunConfig()
    for line in text.splitlines():
        m = re.match(r"\s*(\w+)\s*=\s*(.*)", line)
        if not m:
            continue
        key, raw = m.group(1), m.group(2)
        if key not in _LEGACY_KEYS:
            continue
        field, typ = _LEGACY_KEYS[key]
        if field is None:
            continue
        value = raw.split("//")[0].strip().strip("'\"")
        if typ is not str:
            value = typ(value.rstrip("."))  if typ is int else typ(value)
        setattr(cfg, field, value)
    return cfg


def load_config(path: str) -> RunConfig:
    """Load a RunConfig from JSON (.json) or legacy text (anything else)."""
    with open(path) as fh:
        text = fh.read()
    if path.endswith(".json"):
        data = json.loads(text)
        if "mesh_shape" in data:
            data["mesh_shape"] = tuple(data["mesh_shape"])
        return RunConfig(**data)
    return parse_legacy_input_parameters(text)


def save_config(cfg: RunConfig, path: str) -> None:
    data = dataclasses.asdict(cfg)
    data["mesh_shape"] = list(data["mesh_shape"])
    with open(path, "w") as fh:
        json.dump(data, fh, indent=2)
