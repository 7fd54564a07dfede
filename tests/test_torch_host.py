"""PyTorch port, host side: the copied NumPy builders give arrays identical
to the JAX package's, the octant rotations work on tensors, the package
imports no JAX, and the config parser reads the reference's format."""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

from radiativetransfer_tpu import config as jconfig
from radiativetransfer_tpu.core import sweep as jsweep
from radiativetransfer_tpu.geometry import octants as joctants
from radiativetransfer_tpu.tables import chemistry_rates as jrates
from radiativetransfer_tpu.tables import spectral as jspectral
from radiativetransfer_tpu.tables import uvb_models as juvb
from radiativetransfer_tpu_torch import config as tconfig
from radiativetransfer_tpu_torch import constants as C
from radiativetransfer_tpu_torch.core import sweep as tsweep
from radiativetransfer_tpu_torch.geometry import octants as toctants
from radiativetransfer_tpu_torch.tables import chemistry_rates as trates
from radiativetransfer_tpu_torch.tables import spectral as tspectral
from radiativetransfer_tpu_torch.tables import uvb_models as tuvb


def _assert_same(a, b, path="value"):
    """Recursive exact equality of dataclasses, dicts, tuples, arrays and
    scalars."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)


@pytest.mark.parametrize("recombination_type", [C.CASE_A, C.CASE_B])
def test_calc_rates_identical(recombination_type):
    _assert_same(trates.calc_rates(recombination_type=recombination_type),
                 jrates.calc_rates(recombination_type=recombination_type))


def test_spectral_tables_identical():
    args = (C.NFBINS, C.FREQUENCY_BIN_WIDTH, C.ALPHA_QUASAR, C.ALPHA_STELLAR)
    _assert_same(tspectral.uniform_table(*args),
                 jspectral.uniform_table(*args))
    alpha = (1.3, 1.7, 2.1)
    _assert_same(tspectral.uvb_beta_table(C.NFBINS, C.FREQUENCY_BIN_WIDTH,
                                          alpha),
                 jspectral.uvb_beta_table(C.NFBINS, C.FREQUENCY_BIN_WIDTH,
                                          alpha))


@pytest.mark.parametrize("z,model", [(6.55, 10), (3.0, 6), (8.0, 10)])
def test_uvb_builders_identical(z, model):
    t_amps = tuvb.uniform_uvb_intensities(z, 1.3)
    j_amps = juvb.uniform_uvb_intensities(z, 1.3)
    _assert_same(t_amps, j_amps)
    t_bands = tuvb.band_intensities(t_amps, C.ALPHA_STELLAR, C.ALPHA_QUASAR)
    j_bands = juvb.band_intensities(j_amps, C.ALPHA_STELLAR, C.ALPHA_QUASAR)
    _assert_same(t_bands, j_bands)
    for b, (lo, hi, bound) in enumerate([(C.NU1, C.NU2, True),
                                         (C.NU2, C.NU3, True),
                                         (C.NU3, C.NU3, False)]):
        args = (t_bands[0][b], C.ALPHA_STELLAR, t_bands[1][b], C.ALPHA_QUASAR,
                lo, hi, bound)
        _assert_same(tspectral.power_spectrum_index(*args),
                     jspectral.power_spectrum_index(*args))
    q, s = jspectral.uniform_table(C.NFBINS, C.FREQUENCY_BIN_WIDTH,
                                   C.ALPHA_QUASAR, C.ALPHA_STELLAR)
    args = (z, model, t_amps.quasar, t_amps.stellar, q.ksi[24], s.ksi[24])
    _assert_same(tuvb.reionization_rate_coefficient(*args),
                 juvb.reionization_rate_coefficient(*args))


@pytest.mark.parametrize("level,n", [(1, 8), (2, 6), (3, 5)])
def test_sweep_plan_identical(level, n):
    t_plan = tsweep.build_sweep_plan(level, n)
    j_plan = jsweep.build_sweep_plan(level, n)
    assert (t_plan.n_directions, t_plan.nslab, t_plan.weight) == \
        (j_plan.n_directions, j_plan.nslab, j_plan.weight)
    assert len(t_plan.zones) == len(j_plan.zones)
    for tz, jz in zip(t_plan.zones, j_plan.zones):
        assert (tz.izone, tz.ndir) == (jz.izone, jz.ndir)
        for name in ("len_xy", "len_xz", "len_yz", "chain2", "chain3",
                     "n_active"):
            a, b = getattr(tz, name), getattr(jz, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("izone", [1, 6, 11, 16, 24])
def test_octant_rotations_torch(izone):
    rng = np.random.default_rng(izone)
    field = rng.normal(size=(4, 5, 6, 2))
    rot_np = toctants.rotate_to_sweep(field, izone)
    np.testing.assert_array_equal(rot_np,
                                  joctants.rotate_to_sweep(field, izone))
    rot_t = toctants.rotate_to_sweep(torch.from_numpy(field), izone)
    np.testing.assert_array_equal(rot_t.numpy(), rot_np)
    back = toctants.rotate_from_sweep(rot_t, izone)
    np.testing.assert_array_equal(back.numpy(), field)
    blocks = rng.normal(size=(3, 2, 4, 4, 4))
    rb = toctants.rotate_blocks_to_sweep(torch.from_numpy(blocks), izone)
    np.testing.assert_array_equal(
        rb.numpy(), toctants.rotate_blocks_to_sweep(blocks, izone))
    np.testing.assert_array_equal(
        toctants.rotate_blocks_from_sweep(rb, izone).numpy(), blocks)


_PORT_MODULES = (
    "radiativetransfer_tpu_torch",
    "radiativetransfer_tpu_torch.bench",
    "radiativetransfer_tpu_torch.exp_row_scatter",
    "radiativetransfer_tpu_torch.exp_sweep_pair",
    "radiativetransfer_tpu_torch.exp_sweep_variants",
    "radiativetransfer_tpu_torch.roofline_sweep",
    "radiativetransfer_tpu_torch.profile_step",
    "radiativetransfer_tpu_torch.core.cuda_build",
    "radiativetransfer_tpu_torch.core.probes_cuda",
    "radiativetransfer_tpu_torch.core.rays",
    "radiativetransfer_tpu_torch.core.scatter_cuda",
    "radiativetransfer_tpu_torch.core.step",
    "radiativetransfer_tpu_torch.core.sweep_cuda",
    "radiativetransfer_tpu_torch.core.variants_cuda",
    "radiativetransfer_tpu_torch.tables.dust",
    "radiativetransfer_tpu_torch.tables.stellar",
)


def test_package_imports_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {_PORT_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert 'radiativetransfer_tpu' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], check=True)


_INPUT_PARAMETERS = """\
sphDir = '/data/sph/'                  // directory with SPH snapshots
synthesisDir = '/data/synthesis/'      // stellar population tables
grid = 'grid_velmet.dat'
sources = 'sources.dat'
currentRedshift = 6.55
mode = 1.
dustApproximation = 0
selfShieldingThreshold = 0.1
massStellarParticle = 1
upperAgeLimit = 34.0
restart = 0
restartCellArrayName = 'cellArray0001'
reionizationModel = 10
uvbCoefficient = 1.0
"""


def test_parse_inline_input_parameters():
    cfg = tconfig.parse_legacy_input_parameters(_INPUT_PARAMETERS)
    assert cfg.mode == 1
    assert cfg.current_redshift == 6.55
    assert cfg.self_shielding_threshold_kpc == 0.1
    assert cfg.upper_age_limit_myr == 34.0
    assert cfg.reionization_model == 10
    assert cfg.read_kinematics and cfg.read_metals
    assert cfg.run_stellar_transfer and not cfg.run_uvb_transfer
    # one config means the same thing to both packages
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jconfig.parse_legacy_input_parameters(_INPUT_PARAMETERS))
    assert [f.name for f in dataclasses.fields(tconfig.RunConfig)] == \
        [f.name for f in dataclasses.fields(jconfig.RunConfig)]
