"""PyTorch port, the two-level AMR tracer (core/rays_amr.py, the L-level
march at L = 2) against the JAX package's trace_point_sources_amr on the
same NumPy inputs, and the JAX package's degenerate limits of
tests/test_rays_amr.py on the port.

Tolerances: float64 traces agree to 1e-9 of each field's largest value
at n = 8, where the fine grid (n2 = 16) keeps the JAX package's float32
cell faces exact; float32 traces to 1e-5 with the uniform tracer test's
absolute 1e-37 floor for heating deposits below float32's normal range.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiativetransfer_tpu.core import amr as jamr
from radiativetransfer_tpu.core import rays as jrays
from radiativetransfer_tpu.core import rays_amr as jrays_amr
from radiativetransfer_tpu.core import state as jstate
from radiativetransfer_tpu_torch.constants import (
    COMPLETE_SUBLIMATION,
    KPC,
    MH,
    MHE,
    NO_DUST,
    NO_SUBLIMATION,
    PSI,
)
from radiativetransfer_tpu_torch.core import amr as tamr
from radiativetransfer_tpu_torch.core import rays as trays
from radiativetransfer_tpu_torch.core import rays_amr as trays_amr
from radiativetransfer_tpu_torch.core import rays_multilevel as trml
from radiativetransfer_tpu_torch.core import state as tstate
from radiativetransfer_tpu_torch.tables import stellar as tstellar
from test_torch_rays import _tables
from test_torch_host import jax_compile_cache

BOX = 300.0 * KPC


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the eager march is ~300 small CPU ops a step,
    on which more threads only spin beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _jax_cache(tmp_path_factory):
    """The JAX package's compiles shared by the port's parity modules of
    this test process (test_torch_host.jax_compile_cache)."""
    with jax_compile_cache(tmp_path_factory.getbasetemp() / "jax_cache"):
        yield


def _np_fields(fs) -> dict:
    return {f.name: (None if getattr(fs, f.name) is None
                     else np.asarray(getattr(fs, f.name)))
            for f in dataclasses.fields(fs)}


def _states(n, seed=3):
    """The same two-level state in both packages: clumpy, partly ionized
    gas with helium in both ionized states; refined: a central block and
    a slab on the z = 0 face; the fine HI off the prolongation."""
    rng = np.random.default_rng(seed)
    shape = (n, n, n)
    nh = 1e-3 * rng.lognormal(0.0, 1.0, shape)
    rho = nh * MH / PSI
    nhe = (1.0 - PSI) * rho / MHE
    base = jstate.make_state(
        rho, np.full(shape, 1e4), nh * rng.uniform(1e-2, 3e-1, shape),
        HeI=nhe * rng.uniform(1e-2, 3e-1, shape),
        HeII=nhe * rng.uniform(1e-2, 3e-1, shape),
        abun2=rng.uniform(0.01, 0.03, shape), dtype=jnp.float64)
    refined = np.zeros(shape, bool)
    q = n // 4
    refined[q:n - q, q:n - q, q:n - q] = True
    refined[:, :, 0] = True
    js = jamr.make_amr_state(base, jnp.asarray(refined))
    hi_f = 0.1 * np.asarray(js.fine.nh) * rng.lognormal(0.0, 0.3,
                                                        (2 * n,) * 3)
    js = dataclasses.replace(js, fine=dataclasses.replace(
        js.fine, HI=jnp.asarray(hi_f)))
    ts = tamr.AMRState.from_numpy(
        {"base": _np_fields(js.base), "fine": _np_fields(js.fine),
         "refined": refined}, dtype=torch.float64, device="cpu")
    return js, ts


def _sources(n):
    """One source inside the refined centre, one in the coarse cell next
    to it, one in the refined face slab."""
    return dict(position=np.array([[0.5 + 0.25 / n, 0.5 + 0.75 / n,
                                    0.5 + 0.25 / n],
                                   [(n // 4 - 0.5) / n, 0.47, 0.55],
                                   [0.3, 0.7, 0.5 / n]]),
                weight=np.array([1.0, 2.0, 0.5]),
                table_idx=np.array([0, 1, 0], np.int32))


def _trace_both(n, dtype, volume=1.0, **kw):
    js, ts = _states(n)
    src = _sources(n)
    tables = _tables(volume)
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    j = jrays_amr.trace_point_sources_amr(
        js, jstate.GridGeometry(n, n, n, BOX), jrays.SourceBatch(**src),
        tables, max_pixel_level=3, dtype=jd, **kw)
    t = trays_amr.trace_point_sources_amr(
        ts, tstate.GridGeometry(n, n, n, BOX), trays.SourceBatch(**src),
        tables, max_pixel_level=3, dtype=dtype, **kw)
    return j, t, src


def _assert_traces_close(j, t, src, rel, floor=0.0):
    (jb, jf, jdiag), (tb, tf, tdiag) = j, t
    pairs = [(getattr(a, f.name).numpy(), np.asarray(getattr(b, f.name)),
              f"{level}.{f.name}")
             for level, a, b in (("base", tb, jb), ("fine", tf, jf))
             for f in dataclasses.fields(b)]
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


@pytest.mark.parametrize("rates_mode,dust", [
    ("table", NO_DUST),
    ("table", NO_SUBLIMATION),
    ("quadrature", NO_DUST),
    ("quadrature", NO_SUBLIMATION),
    ("quadrature", COMPLETE_SUBLIMATION),
])
def test_trace_amr_matches_jax_f64(rates_mode, dust):
    j, t, src = _trace_both(8, torch.float64, rates_mode=rates_mode,
                            dust_approximation=dust)
    _assert_traces_close(j, t, src, rel=1e-9)
    tb, tf, tdiag = t
    # every level and every channel is reached
    for rf in (tb, tf):
        for f in dataclasses.fields(rf):
            assert float(getattr(rf, f.name).abs().sum()) > 0.0, f.name
    assert float(tdiag.ndot_spectrum.sum()) > 0.0


@pytest.mark.parametrize("rates_mode", ["table", "quadrature"])
def test_trace_amr_matches_jax_f32_default_kills(rates_mode):
    # float32 with tau_kill 30 and rel_kill 1e-10 on both sides, the
    # weights over the cell volume as StellarContext divides them; the
    # tolerances of tests/test_torch_rays.py's float32 test
    j, t, src = _trace_both(8, torch.float32, volume=(BOX / 8) ** 3,
                            rates_mode=rates_mode)
    assert t[1].krate24.dtype == torch.float32
    _assert_traces_close(j, t, src, rel=1e-5, floor=1e-37)


def test_trace_amr_at_float32_face_gap():
    # n = 6: the fine grid's faces k/12 are not exact in float32, and the
    # JAX package computes them in float32 even in a float64 run (the port
    # in the run's dtype; ROADMAP, faults found in the port): the traces
    # differ by the faces' error, measured at 3.0e-7 of the peak here
    j, t, src = _trace_both(6, torch.float64, rates_mode="quadrature")
    _assert_traces_close(j, t, src, rel=1e-6)


def test_noneq_rates_mode_raises():
    _, ts = _states(4)
    with pytest.raises(ValueError, match="quadrature_noneq"):
        trays_amr.trace_point_sources_amr(
            ts, tstate.GridGeometry(4, 4, 4, BOX),
            trays.SourceBatch(**_sources(4)), _tables(),
            rates_mode="quadrature_noneq")


# ---------------------------------------------------------------------------
# Degenerate limits (the JAX package's tests/test_rays_amr.py), port only
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bb_tables():
    t = tstellar.build_source_tables(
        tstellar.blackbody_population(temperature=1.0e5, q_ionizing=5.0e48),
        0, 0.0, 0, 0.0)
    tables = {k: getattr(t, k)[None] if k.endswith("_log") else getattr(t, k)
              for k in ("reaction_log", "energy_log", "output_sigma24",
                        "output_sigma25", "output_sigma26",
                        "output_sigma_dust")}
    return tables, t.total_integral


def _source_at(p):
    return trays.SourceBatch(position=np.array([p]), weight=np.array([1.0]),
                             table_idx=np.array([0], np.int32))


def _rand_state(n, seed=0, scale=1e-2):
    nh = np.random.default_rng(seed).lognormal(0, 0.5, (n, n, n)) * scale
    return tstate.make_state(nh * MH / PSI, np.full((n, n, n), 1e4), nh,
                             dtype=torch.float64, device="cpu")


def _amr(base, refined):
    return tamr.make_amr_state(base, torch.as_tensor(refined))


def test_unrefined_matches_uniform_tracer(bb_tables):
    tables, _ = bb_tables
    n = 12
    geom = tstate.GridGeometry(n, n, n, 100 * KPC)
    base = _rand_state(n)
    src = _source_at([0.47, 0.52, 0.5])
    rfb, rff, diag_a = trays_amr.trace_point_sources_amr(
        _amr(base, np.zeros((n,) * 3, bool)), geom, src, tables,
        max_pixel_level=3)
    rf_u, diag_u = trays.trace_point_sources(base, geom, src, tables,
                                             max_pixel_level=3)
    for f in dataclasses.fields(rf_u):
        u = getattr(rf_u, f.name)
        np.testing.assert_allclose(getattr(rfb, f.name).numpy(), u.numpy(),
                                   rtol=1e-12,
                                   atol=1e-12 * float(u.abs().max()),
                                   err_msg=f.name)
        assert not getattr(rff, f.name).any(), f.name
    for f in dataclasses.fields(diag_u):
        np.testing.assert_allclose(getattr(diag_a, f.name).numpy(),
                                   getattr(diag_u, f.name).numpy(),
                                   rtol=1e-12, err_msg=f.name)


def test_fully_refined_matches_fine_uniform_tracer(bb_tables):
    tables, _ = bb_tables
    n = 6
    geom = tstate.GridGeometry(n, n, n, 100 * KPC)
    state = _amr(_rand_state(n), np.ones((n,) * 3, bool))
    src = _source_at([0.47, 0.52, 0.5])
    rfb, rff, diag_a = trays_amr.trace_point_sources_amr(
        state, geom, src, tables, max_pixel_level=4)
    # the same run on a uniform grid at the fine resolution
    rf_u, diag_u = trays.trace_point_sources(
        state.fine, tstate.GridGeometry(2 * n, 2 * n, 2 * n, 100 * KPC),
        src, tables, max_pixel_level=4)
    for f in dataclasses.fields(rf_u):
        u = getattr(rf_u, f.name)
        np.testing.assert_allclose(getattr(rff, f.name).numpy(), u.numpy(),
                                   rtol=1e-6,
                                   atol=1e-12 * float(u.abs().max()),
                                   err_msg=f.name)
        assert not getattr(rfb, f.name).any(), f.name
    np.testing.assert_allclose(diag_a.ndot_remaining.numpy(),
                               diag_u.ndot_remaining.numpy(), rtol=1e-6)


def test_mixed_grid_conserves_photons(bb_tables):
    tables, total = bb_tables
    n = 12
    geom = tstate.GridGeometry(n, n, n, 100 * KPC)
    # a dense neutral box: every ionizing photon is absorbed somewhere
    refined = np.zeros((n,) * 3, bool)
    refined[4:8, 4:8, 4:8] = True
    rfb, rff, _ = trays_amr.trace_point_sources_amr(
        _amr(_rand_state(n, scale=1.0), refined), geom,
        _source_at([0.5, 0.5, 0.5]), tables, max_pixel_level=3)
    absorbed = float(rfb.krate24.sum() + rff.krate24.sum())
    assert absorbed == pytest.approx(total, rel=0.05)
    # the source sits in the refined centre: the deposits near it go to
    # the FINE level
    assert float(rff.krate24.sum()) > 0.9 * absorbed


def test_refinement_boundary_handoff(bb_tables):
    # a ray crossing coarse -> fine -> coarse takes the optical depth of
    # the same uniform medium
    tables, _ = bb_tables
    n = 8
    geom = tstate.GridGeometry(n, n, n, 50 * KPC)
    base = tstate.uniform_state(n, nh=0.01, tgas=1e4, dtype=torch.float64,
                                device="cpu")
    refined = np.zeros((n,) * 3, bool)
    refined[3:5, :, :] = True          # a refined slab in the middle
    src = _source_at([0.06, 0.5, 0.52])
    rfb, rff, diag_a = trays_amr.trace_point_sources_amr(
        _amr(base, refined), geom, src, tables, max_pixel_level=3)
    rf_u, diag_u = trays.trace_point_sources(base, geom, src, tables,
                                             max_pixel_level=3)
    assert float(rfb.krate24.sum() + rff.krate24.sum()) == pytest.approx(
        float(rf_u.krate24.sum()), rel=2e-2)
    np.testing.assert_allclose(diag_a.ndot_remaining.numpy(),
                               diag_u.ndot_remaining.numpy(), rtol=2e-2)


def test_face_exact_f32_rays_terminate():
    """The JAX package's tests/test_rays_multilevel.py::
    TestCornerHitTermination for the march at L = 2 (the one
    core/rays_amr.py runs): float32 rays parked
    exactly on a fine cell's corner (two coordinates on faces, the state
    every crossing's snap produces) with negative components on those
    axes must march on and leave the box, not freeze in the zero-step
    period-2 cycle a sub-ulp relocalization nudge gives (with float64's
    1e-6 in float32 these 8 rays are all alive at the cap)."""
    n = 32
    n2 = 2 * n
    f32 = torch.float32
    geom = tstate.GridGeometry(n, n, n, 100.0 * KPC)
    refined = np.zeros((n,) * 3, bool)
    refined[8:24, 8:24, 8:24] = True
    nh = np.random.default_rng(0).lognormal(0, 0.3, (n,) * 3) * 1e-4
    state = _amr(tstate.make_state(nh * MH / PSI, np.full(nh.shape, 1e4), nh,
                                   dtype=torch.float64, device="cpu"),
                 refined)
    # the two-level layout of the L-level march (core/rays_amr.py calls
    # it at L = 2): both levels' packed rows concatenated
    fields = {
        "lv_all": torch.cat([trays._pack_fields(*(x.reshape(-1).to(f32)
                                                  for x in (
            fs.HI, fs.HeI, fs.HeII, fs.nh, fs.abun2)))
            for fs in (state.base, state.fine)]),
        "leaf_level": trml.leaf_level_volume((state.refined,), n, 2),
        "offsets": torch.tensor([0, n ** 3], dtype=torch.int64)}
    R = 8
    pos = np.tile(np.array([[0.2764418, 45.0 / n2, 45.0 / n2]], np.float32),
                  (R, 1))                    # y and z exactly on faces
    d = np.tile(np.array([[0.25885, -0.25626, -0.89508]], np.float32),
                (R, 1))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ray = trays._RayState(
        pos=torch.tensor(pos), direction=torch.tensor(d),
        cell=torch.tensor(np.clip((pos * n2).astype(np.int32), 0, n2 - 1)),
        radius=torch.zeros(R, dtype=f32), ndot=torch.ones(R, dtype=f32),
        depth=torch.zeros((R, 4), dtype=f32),
        alive=torch.ones(R, dtype=torch.bool),
        split=torch.zeros(R, dtype=torch.bool),
        table_idx=torch.zeros(R, dtype=torch.int64),
        crossed=torch.zeros(R, dtype=torch.bool),
        cross_depth=torch.zeros((R, 4), dtype=f32))
    pop = tstellar.blackbody_population(q_ionizing=5.0e48)
    quad_a, quad_w = tstellar.quadrature_arrays(pop, 0, 0.0, 0, 0.0)
    rate_ctx = ("quadrature", (torch.tensor(quad_a, dtype=f32),
                               torch.tensor(quad_w[None] / geom.cell_volume,
                                            dtype=f32)))

    rf = trays.RateFields(*[torch.zeros(n ** 3 + n2 ** 3, dtype=f32)
                            for _ in range(6)])
    cap = 6 * n2
    steps0 = trml.MARCH_STEPS
    out, _ = trml._march_phase_ml(
        ray, fields, geom, 2, rate_ctx,
        trays.RayDiagnostics.zeros(1, f32, "cpu"), rf, 1e9, True, NO_DUST,
        cap, torch.zeros(R, dtype=torch.int64), tau_kill=30.0,
        rel_kill=1e-10, scale=1.0)
    # every ray left the box (or died) well before the cap
    assert not bool(out.alive.any())
    assert trml.MARCH_STEPS - steps0 < cap // 2
