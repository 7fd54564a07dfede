"""PyTorch port, host side: the copied NumPy builders give arrays identical
to the JAX package's, the octant rotations work on tensors, the package
imports no JAX, and the config parser reads the reference's format."""

import contextlib
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


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the port's eager ops are small CPU ops, on
    which more threads only spin beside the other test workers (module-
    scoped, so that the module's fixtures run pinned too)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def jax_compile_cache(directory):
    """JAX's persistent compilation cache in `directory` for the block, the
    settings as they were after it.  A JAX CLI run (or model setup) builds
    new jitted closures each time, so JAX's in-memory cache misses on a
    second run of the same configuration; with this cache the second run
    loads the programs the first compiled (its executables are the same,
    so are the results), and a parity module shares the JAX package's
    compiles across its cases.  Every program is cached, however quick
    its compile."""
    import jax
    from jax._src import compilation_cache
    names = ("jax_compilation_cache_dir",
             "jax_persistent_cache_min_compile_time_secs",
             "jax_persistent_cache_min_entry_size_bytes")
    before = {k: getattr(jax.config, k) for k in names}
    jax.config.update("jax_compilation_cache_dir", str(directory))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    compilation_cache.reset_cache()
    try:
        yield
    finally:
        for k, v in before.items():
            jax.config.update(k, v)
        compilation_cache.reset_cache()


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
    "radiativetransfer_tpu_torch.cli",
    "radiativetransfer_tpu_torch.exp_row_scatter",
    "radiativetransfer_tpu_torch.exp_sweep_pair",
    "radiativetransfer_tpu_torch.exp_sweep_variants",
    "radiativetransfer_tpu_torch.roofline_sweep",
    "radiativetransfer_tpu_torch.profile_step",
    "radiativetransfer_tpu_torch.core.amr",
    "radiativetransfer_tpu_torch.core.chemistry_noneq",
    "radiativetransfer_tpu_torch.core.cuda_build",
    "radiativetransfer_tpu_torch.core.expansion",
    "radiativetransfer_tpu_torch.core.probes_cuda",
    "radiativetransfer_tpu_torch.core.rays",
    "radiativetransfer_tpu_torch.core.rays_multilevel",
    "radiativetransfer_tpu_torch.core.scatter_cuda",
    "radiativetransfer_tpu_torch.core.step",
    "radiativetransfer_tpu_torch.core.step_amr",
    "radiativetransfer_tpu_torch.core.sweep_amr",
    "radiativetransfer_tpu_torch.core.sweep_cuda",
    "radiativetransfer_tpu_torch.core.sweep_multilevel",
    "radiativetransfer_tpu_torch.core.variants_cuda",
    "radiativetransfer_tpu_torch.io.diagnostics",
    "radiativetransfer_tpu_torch.io.grid_io",
    "radiativetransfer_tpu_torch.io.sfc",
    "radiativetransfer_tpu_torch.io.snapshot",
    "radiativetransfer_tpu_torch.io.sources_io",
    "radiativetransfer_tpu_torch.parallel.mesh",
    "radiativetransfer_tpu_torch.parallel.sweep_dist",
    "radiativetransfer_tpu_torch.parallel.sweep_rdma",
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


@pytest.mark.parametrize("takes", ["kept", "retaken", "lost"])
def test_profiler_window_retake(monkeypatch, takes):
    """profile_step._traced keeps a window that recorded markers on both
    sides, takes once more (twice the warm-up, a tail of at least 1 s) one
    that lost them, and raises if the retake loses them too; the tail
    grows with the clocks' disagreement of earlier windows."""
    from radiativetransfer_tpu_torch import profile_step
    spin, kernel = ("spin_kernel", 0.0, 1.0), ("k", 1.0, 2.0)
    whole = ([spin] * 20 + [kernel] * 3 + [spin] * 20,
             (5.0, 90.0, 43, 43))
    cut = ([spin] * 27 + [kernel] * 2, (29_000.0, 89_900.0, 43, 29))
    takes_ = {"kept": [whole], "retaken": [cut, whole],
              "lost": [cut, cut]}[takes]
    calls = []

    def trace_once(fn, tail, warmups):
        calls.append((tail, warmups))
        events, clocks = takes_[len(calls) - 1]
        return fn(), events, clocks

    monkeypatch.setattr(profile_step, "_trace_once", trace_once)
    monkeypatch.setattr(profile_step, "WINDOWS", [])
    if takes == "lost":
        with pytest.raises(RuntimeError, match="taken twice"):
            profile_step._traced(lambda: 7)
    else:
        out, events = profile_step._traced(lambda: 7)
        assert out == 7 and events == [kernel] * 3
    assert calls[0] == (profile_step._TAIL_S, 1)
    assert len(calls) == len(takes_)
    if len(calls) == 2:
        assert calls[1] == (1.0, 2)
    rows = profile_step.WINDOWS
    assert [w[-1] for w in rows] == list(range(len(takes_)))
    assert (rows[0][1], rows[0][2]) == ((20, 20) if takes == "kept"
                                        else (27, 0))
    # the next window's tail: twice the largest |least delay| so far,
    # from _TAIL_S up to _TAIL_MAX_S
    assert profile_step._tail_s() == profile_step._TAIL_S
    rows.append((0.0, 20, 20, -400_000.0, 0.0, 1, 1, 0.25, 0))
    assert profile_step._tail_s() == pytest.approx(0.8)
    rows.append((0.0, 20, 20, 5e6, 5e6, 1, 1, 0.8, 0))
    assert profile_step._tail_s() == profile_step._TAIL_MAX_S
