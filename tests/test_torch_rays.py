"""PyTorch port, the point-source slice: the copied stellar and dust table
builders against the JAX package's, and the tracer (core/rays.py) against
the JAX package's trace_point_sources on the same NumPy inputs.

Tolerances: the float64 traces agree to 1e-9 of each field's largest value.
The tracers run the same operations per ray in the same order; what
differs is the order of the sums (the matrix-vector products of the
quadrature deposits, and the scatter-adds, which are atomic and unordered
on a CUDA device)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiativetransfer_tpu.core import rays as jrays
from radiativetransfer_tpu.core import state as jstate
from radiativetransfer_tpu.tables import dust as jdust
from radiativetransfer_tpu.tables import stellar as jstellar
from radiativetransfer_tpu_torch.constants import (
    KPC,
    MH,
    MHE,
    MYR,
    NO_DUST,
    NO_SUBLIMATION,
    PSI,
)
from radiativetransfer_tpu_torch.core import rays as trays
from radiativetransfer_tpu_torch.core import state as tstate
from radiativetransfer_tpu_torch.tables import dust as tdust
from radiativetransfer_tpu_torch.tables import stellar as tstellar
from test_torch_host import _assert_same, jax_compile_cache


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the port's eager ops are small CPU ops, on
    which more threads only spin beside the other test workers (module-
    scoped, so that the module's fixtures run pinned too)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

N = 16
BOX = 300.0 * KPC   # the 100 kpc output radius lies inside the box


@pytest.fixture(scope="module", autouse=True)
def _jax_cache(tmp_path_factory):
    """The JAX package's compiles shared by the port's parity modules of
    this test process (test_torch_host.jax_compile_cache)."""
    with jax_compile_cache(tmp_path_factory.getbasetemp() / "jax_cache"):
        yield


# ---------------------------------------------------------------------------
# Table builders
# ---------------------------------------------------------------------------


def test_dust_tables_identical():
    lam = np.geomspace(0.01, 30.0, 97)
    energy = np.geomspace(13.6, 1000.0, 53)
    tm, jm = tdust.DustModel(), jdust.DustModel()
    for kind in (tdust.SMC, tdust.LMC):
        _assert_same(tm.cross_section(lam, kind), jm.cross_section(lam, kind))
        _assert_same(tm.sigma_at_energy_ev(energy, kind),
                     jm.sigma_at_energy_ev(energy, kind))


@pytest.mark.parametrize("kw", [{}, {"q_ionizing": 1.0e51},
                                {"temperature": 5e4, "n_ages": 5,
                                 "n_metal": 3}])
def test_population_identical(kw):
    tp, jp = (tstellar.blackbody_population(**kw),
              jstellar.blackbody_population(**kw))
    _assert_same(tp, jp)
    _assert_same(tstellar.metal_bucket_plan(tp),
                 jstellar.metal_bucket_plan(jp))
    for age in (0.0, 3.0e14, 1.0e15):
        assert tp.age_bracket(age) == jp.age_bracket(age)


@pytest.mark.parametrize("args", [(0, 0.0, 0, 0.0), (2, 0.3, 0, 0.7)])
def test_source_tables_identical(args):
    tp = tstellar.blackbody_population(q_ionizing=1.0e51)
    jp = jstellar.blackbody_population(q_ionizing=1.0e51)
    _assert_same(tstellar.build_source_tables(tp, *args),
                 jstellar.build_source_tables(jp, *args))
    _assert_same(tstellar.quadrature_arrays(tp, *args),
                 jstellar.quadrature_arrays(jp, *args))
    _assert_same(tstellar.quadrature_noneq_weights(tp, *args),
                 jstellar.quadrature_noneq_weights(jp, *args))
    assert tstellar.luminosity_shift_log10(100, 7, 2) == \
        jstellar.luminosity_shift_log10(100, 7, 2)


@pytest.mark.parametrize("dust_on", [False, True])
def test_interp_rates_4d_matches_jax(dust_on):
    t = jstellar.build_source_tables(jstellar.blackbody_population(),
                                     0, 0.0, 0, 0.0)
    rng = np.random.default_rng(5)
    taus = rng.uniform(0.0, 10.5, (4, 200))   # some beyond the grid
    jn, jh = jstellar.interp_rates_4d(jnp.asarray(t.reaction_log),
                                      jnp.asarray(t.energy_log),
                                      *map(jnp.asarray, taus),
                                      dust_on=dust_on)
    tn, th = tstellar.interp_rates_4d(torch.as_tensor(t.reaction_log),
                                      torch.as_tensor(t.energy_log),
                                      *map(torch.as_tensor, taus),
                                      dust_on=dust_on)
    for a, b in ((tn, jn), (th, jh)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=0.0)
    assert (tn.numpy() == 0.0).any()          # out-of-range taus give 0


# ---------------------------------------------------------------------------
# The tracer against the JAX package's
# ---------------------------------------------------------------------------


def _tables(volume: float = 1.0) -> dict:
    """Two SED buckets (age 0 and a later, dimmer slice), weights divided
    by `volume`."""
    pop = jstellar.blackbody_population(q_ionizing=5.0e48)
    react, energy, quad_w = [], [], []
    for i_spec, coef in ((0, 0.0), (2, 0.5)):
        t = jstellar.build_source_tables(pop, i_spec, coef, 0, 0.0)
        react.append(t.reaction_log - np.log(volume))
        energy.append(t.energy_log - np.log(volume))
        quad_a, w = jstellar.quadrature_arrays(pop, i_spec, coef, 0, 0.0)
        quad_w.append(w / volume)
    return {"reaction_log": np.stack(react), "energy_log": np.stack(energy),
            "quad_A": quad_a, "quad_W": np.stack(quad_w),
            "output_freq": t.output_freq,
            "output_sigma24": t.output_sigma24,
            "output_sigma25": t.output_sigma25,
            "output_sigma26": t.output_sigma26,
            "output_sigma_dust": t.output_sigma_dust}


def _fields(seed: int = 3) -> dict:
    """Clumpy, mostly ionized gas with helium in both ionized states."""
    rng = np.random.default_rng(seed)
    shape = (N, N, N)
    nh = 1e-4 * rng.lognormal(0.0, 1.0, shape)
    rho = nh * MH / PSI
    nhe = (1.0 - PSI) * rho / MHE
    return dict(rho=rho, tgas=np.full(shape, 1e4),
                HI=nh * rng.uniform(1e-3, 3e-2, shape),
                HeI=nhe * rng.uniform(1e-3, 3e-2, shape),
                HeII=nhe * rng.uniform(1e-2, 3e-1, shape),
                abun2=rng.uniform(0.01, 0.03, shape))


def _sources():
    rng = np.random.default_rng(11)
    return dict(position=rng.uniform(0.25, 0.75, (3, 3)),
                weight=np.array([1.0, 2.0, 0.5]),
                table_idx=np.array([0, 1, 0], np.int32))


def _trace_both(dtype, volume=1.0, **kw):
    f = _fields()
    src = _sources()
    tables = _tables(volume)
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    js = jstate.make_state(**f, dtype=jd)
    ts = tstate.make_state(**f, dtype=dtype, device="cpu")
    jgeom = jstate.GridGeometry(N, N, N, BOX)
    tgeom = tstate.GridGeometry(N, N, N, BOX)
    j = jrays.trace_point_sources(js, jgeom, jrays.SourceBatch(**src),
                                  tables, max_pixel_level=3, dtype=jd, **kw)
    t = trays.trace_point_sources(ts, tgeom, trays.SourceBatch(**src),
                                  tables, max_pixel_level=3, dtype=dtype,
                                  **kw)
    return j, t, src


def _assert_traces_close(j, t, src, rel, floor=0.0):
    (jrf, jdiag), (trf, tdiag) = j, t
    pairs = [(getattr(trf, f.name).numpy(), np.asarray(getattr(jrf, f.name)),
              f.name) for f in dataclasses.fields(jrf)]
    pairs += [(getattr(tdiag, f.name).numpy(),
               np.asarray(getattr(jdiag, f.name)), f.name)
              for f in dataclasses.fields(jdiag)]
    pairs += [(trays.escape_fractions(tdiag, src["weight"]),
               jrays.escape_fractions(jdiag, src["weight"]), "escape"),
              (trays.cosmic_spectrum(tdiag, src["weight"], 3),
               jrays.cosmic_spectrum(jdiag, src["weight"], 3), "spectrum")]
    for a, b, name in pairs:
        assert a.shape == b.shape, name
        scale = float(np.abs(b).max())
        assert np.abs(a - b).max() <= rel * scale + floor, (name, scale)


@pytest.mark.parametrize("rates_mode,dust,n_bands", [
    ("table", NO_DUST, 3),
    ("table", NO_SUBLIMATION, 3),
    ("quadrature", NO_DUST, 3),
    ("quadrature", NO_SUBLIMATION, 3),
    ("quadrature", NO_DUST, 1),
])
def test_trace_matches_jax_f64(rates_mode, dust, n_bands):
    j, t, src = _trace_both(torch.float64, rates_mode=rates_mode,
                            dust_approximation=dust, n_bands=n_bands)
    _assert_traces_close(j, t, src, rel=1e-9)
    trf = t[0]
    assert float(trf.krate24.sum()) > 0.0
    assert float(trf.krate25.sum()) > 0.0 or n_bands == 1
    assert float(t[1].ndot_spectrum.sum()) > 0.0   # rays reach 100 kpc


def test_trace_matches_jax_f32_default_kills():
    # float32 with tau_kill 30 and rel_kill 1e-10 on both sides, weights
    # divided by the cell volume (as StellarContext does) so the rates are
    # finite in float32; 1e-5 of each field's largest value covers float32
    # rounding of 399-term quadrature sums taken in another order, and an
    # absolute 1e-37 the heating deposits below float32's normal range
    # (1.2e-38), which keep fewer digits
    j, t, src = _trace_both(torch.float32, volume=(BOX / N) ** 3)
    assert t[0].krate24.dtype == torch.float32
    _assert_traces_close(j, t, src, rel=1e-5, floor=1e-37)


def test_f32_deposits_survive_a_flushing_index_add(monkeypatch):
    """bench.py::bench_step's cell cut to 16^3 (a uniform box of 2000 kpc,
    nH 2e-4, T 1.5e4, 8 sources from seed 0, maxPixelLevel 3), its gas
    ionized to a neutral fraction of 1e-3 so the rays cross it: over this
    cell volume a fifth of the float64 trace's nonzero deposits are below
    float32's smallest normal value (1.2e-38), and a CUDA float32
    index_add_ flushes such adds to zero.  With index_add_ flushing them
    here too, the float32 trace keeps every deposit that float32 can hold
    (the tracer accumulates them times a power of two,
    rays._deposit_scale: only those below float32's smallest subnormal,
    1.4e-45, are 0) and holds every channel within 1e-5 of its peak of the
    float64 trace with the same kills.  Without the scale it loses them,
    as the card lost 2.9 million of the 128^3 cell's (ROADMAP, faults
    found in the port).  (torch.set_flush_denormal is no stand-in for the
    card here: it also zeroes the float32 tables' subnormal weights and
    the subnormal totals, which the card keeps.)"""
    from radiativetransfer_tpu_torch.bench import bench_sources
    from radiativetransfer_tpu_torch.core.step import StellarContext
    n = 16
    tiny = torch.finfo(torch.float32).tiny
    geom = tstate.GridGeometry(n, n, n, 2000.0 * KPC)
    pop = tstellar.blackbody_population(q_ionizing=1.0e51)
    kills = dict(tau_kill=trays.default_tau_kill(torch.float32),
                 rel_kill=trays.default_rel_kill(torch.float32))
    index_add = torch.Tensor.index_add_

    def flushing(self, dim, index, source, **kw):
        if self.dtype == torch.float32:
            source = torch.where(source.abs() < tiny, 0.0, source)
        return index_add(self, dim, index, source, **kw)

    rf = {}
    threads = torch.get_num_threads()
    # one intra-op thread: the eager march's small ops only spin on more
    torch.set_num_threads(1)
    try:
        for dtype in (torch.float64, torch.float32):
            ctx = StellarContext.build(pop, bench_sources(n, 8), geom,
                                       10.0 * MYR, metal_coefs=[(0, 0.0)],
                                       max_pixel_level=3, dtype=dtype,
                                       device="cpu")
            state = tstate.uniform_state(n, nh=2e-4, tgas=1.5e4,
                                         x_neutral=1e-3, dtype=dtype,
                                         device="cpu")
            with monkeypatch.context() as mp:
                mp.setattr(torch.Tensor, "index_add_", flushing)
                out, _ = trays.trace_point_sources(
                    state, geom, ctx.sources, ctx.tables, max_pixel_level=3,
                    dtype=dtype, **kills)
            rf[dtype] = torch.stack([getattr(out, f.name).double()
                                     for f in dataclasses.fields(out)])
    finally:
        torch.set_num_threads(threads)
    a, b = rf[torch.float32], rf[torch.float64]
    below = int(((b != 0) & (b.abs() < tiny)).sum())
    assert below > 0.1 * int((b != 0).sum())
    lost = (b != 0) & (a == 0)
    assert not bool((lost & (b.abs() >= 2.0 ** -149)).any())
    for i in range(len(b)):
        peak = float(b[i].abs().max())
        assert float((a[i] - b[i]).abs().max()) <= 1e-5 * peak
    assert float(b[0].max()) > 0.0 and float(b[3].max()) > 0.0


def test_unroll_keeps_the_result():
    f, src = _fields(), _sources()
    ts = tstate.make_state(**f, dtype=torch.float64, device="cpu")
    geom = tstate.GridGeometry(N, N, N, BOX)
    out = [trays.trace_point_sources(ts, geom, trays.SourceBatch(**src),
                                     _tables(), max_pixel_level=2,
                                     unroll=u)[0] for u in (1, 3)]
    for fld in dataclasses.fields(out[0]):
        a, b = getattr(out[1], fld.name), getattr(out[0], fld.name)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-300, err_msg=fld.name)


def test_unported_modes_raise():
    """No tracer mode is left unported: the compacting tracer runs
    (tests/test_torch_compact.py) and refuses what no tracer takes."""
    ts = tstate.uniform_state(4, dtype=torch.float64, device="cpu")
    geom = tstate.GridGeometry(4, 4, 4, BOX)
    src = trays.SourceBatch(**{k: v[:1] for k, v in _sources().items()})
    for tracer in (trays.trace_point_sources,
                   trays.trace_point_sources_compact):
        with pytest.raises(ValueError, match="unknown rates_mode"):
            tracer(ts, geom, src, _tables(), rates_mode="exact")
    with pytest.raises(ValueError, match="chunk must be positive"):
        trays.trace_point_sources_compact(ts, geom, src, _tables(), chunk=0)


# ---------------------------------------------------------------------------
# Photon conservation (the JAX package's tests/test_rays.py:148-175)
# ---------------------------------------------------------------------------


def _center_trace(nh):
    t = tstellar.build_source_tables(
        tstellar.blackbody_population(temperature=1.0e5, q_ionizing=5.0e48),
        0, 0.0, 0, 0.0)
    tables = {k: getattr(t, k)[None] if k.endswith("_log") else getattr(t, k)
              for k in ("reaction_log", "energy_log", "output_sigma24",
                        "output_sigma25", "output_sigma26",
                        "output_sigma_dust")}
    c = N // 2
    src = trays.SourceBatch(position=np.full((1, 3), (c + 0.5) / N),
                            weight=np.array([1.0]),
                            table_idx=np.array([0], np.int32))
    state = tstate.uniform_state(N, nh=nh, tgas=1e4, dtype=torch.float64,
                                 device="cpu")
    rf, diag = trays.trace_point_sources(
        state, tstate.GridGeometry(N, N, N, 100 * KPC), src, tables,
        max_pixel_level=3)
    return rf, diag, t.total_integral


def test_transparent_box_deposits_nothing():
    rf, diag, total = _center_trace(1e-30)
    assert float(rf.krate24.sum()) < 1e-10 * total
    # everything escapes: fraction at the radii inside the box ~ 1
    frac = trays.escape_fractions(diag, np.array([1.0]))[0]
    np.testing.assert_allclose(frac[:6], 1.0, atol=1e-6)


def test_opaque_box_absorbs_ionizing_photons():
    rf, _, total = _center_trace(1.0)
    absorbed = float(rf.krate24.sum())
    assert absorbed == pytest.approx(total, rel=0.05)
    # absorption concentrated in the source cell
    k = rf.krate24.numpy().reshape(N, N, N)
    c = N // 2
    assert k[c, c, c] > 0.5 * absorbed


def test_ray_diagnostics_need_a_device():
    # no constructor of the port lands on the CPU unless asked
    with pytest.raises(TypeError):
        trays.RayDiagnostics.zeros(2, torch.float32)
    diag = trays.RayDiagnostics.zeros(2, torch.float64, "cpu")
    assert diag.ndot_remaining.shape == (2, trays.N_RADIUS)
    assert diag.ndot_spectrum.dtype == torch.float64
