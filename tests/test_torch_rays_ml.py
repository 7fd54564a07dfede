"""PyTorch port, the L-level AMR tracer (core/rays_multilevel.py) against
the JAX package's trace_point_sources_ml on the same NumPy inputs, and the
JAX package's degenerate limits of tests/test_rays_multilevel.py on the
port.

The states: an 8^3 base of clumpy, partly ionized gas with helium in both
ionized states, two refined levels from maps that refine 30% of the base
and then 30% of the covered level-1 cells (balanced), each refined level's
HI drawn on its own; three sources, one in a doubly refined cell.
Tolerances: float64 traces agree to 1e-9 of each channel's largest value
on every level (the finest grid, 32^3, keeps the JAX package's float32
cell faces exact); the limits as the JAX package's tests hold them, the
two-level case against the JAX package's two-level tracer to 1e-9."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiativetransfer_tpu.core import amr as jamr
from radiativetransfer_tpu.core import rays as jrays
from radiativetransfer_tpu.core import rays_amr as jrays_amr
from radiativetransfer_tpu.core import rays_multilevel as jrml
from radiativetransfer_tpu.core import state as jstate
from radiativetransfer_tpu.tables import stellar as jstellar
from radiativetransfer_tpu_torch.bench import bench_sources
from radiativetransfer_tpu_torch.constants import (
    COMPLETE_SUBLIMATION,
    KPC,
    MH,
    MHE,
    MYR,
    NO_DUST,
    NO_SUBLIMATION,
    PSI,
)
from radiativetransfer_tpu_torch.core import amr as tamr
from radiativetransfer_tpu_torch.core import rays as trays
from radiativetransfer_tpu_torch.core import rays_multilevel as trml
from radiativetransfer_tpu_torch.core import state as tstate
from radiativetransfer_tpu_torch.core.step import StellarContext
from radiativetransfer_tpu_torch.tables import stellar as tstellar
from test_torch_rays import _tables
from test_torch_host import jax_compile_cache

N, L = 8, 3
BOX = 300.0 * KPC
F64 = torch.float64


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the eager march is ~150 small CPU ops a step,
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


def maps(n, levels, seed=2):
    """Refinement maps refining 30% of the base, then 30% of each covered
    level's cells, balanced (as tests/test_torch_sweep_ml.py's)."""
    rng = np.random.default_rng(seed)
    refined = [rng.random((n,) * 3) < 0.3]
    for _ in range(levels - 2):
        cov = np.repeat(np.repeat(np.repeat(refined[-1], 2, 0), 2, 1), 2, 2)
        refined.append(cov & (rng.random(cov.shape) < 0.3))
    return tamr.enforce_balance(refined)


def states(n=N, levels=L, seed=3, nh_scale=1e-4):
    """The same L-level state in both packages (see the module's
    docstring)."""
    rng = np.random.default_rng(seed)
    shape = (n,) * 3
    nh = nh_scale * rng.lognormal(0.0, 1.0, shape)
    rho = nh * MH / PSI
    nhe = (1.0 - PSI) * rho / MHE
    base = jstate.make_state(
        rho, np.full(shape, 1e4), nh * rng.uniform(1e-3, 3e-2, shape),
        HeI=nhe * rng.uniform(1e-3, 3e-2, shape),
        HeII=nhe * rng.uniform(1e-2, 3e-1, shape),
        abun2=rng.uniform(0.01, 0.03, shape), dtype=jnp.float64)
    refined = maps(n, levels)
    js = jamr.make_multilevel_state(base, refined)
    lv = list(js.levels)
    for ell in range(1, levels):
        hi = np.asarray(lv[ell].HI) * rng.lognormal(0.0, 0.5,
                                                    lv[ell].rho.shape)
        lv[ell] = dataclasses.replace(lv[ell], HI=jnp.asarray(hi))
    js = jamr.MultiLevelState(levels=tuple(lv), refined=js.refined)
    ts = tamr.MultiLevelState.from_numpy(
        {"levels": [_np_fields(x) for x in js.levels], "refined": refined},
        dtype=F64, device="cpu")
    return js, ts


def sources(n=N):
    """One source in a doubly refined cell, one in a coarse cell, one on
    the z = 0 face."""
    return dict(position=np.array([[0.5 + 0.25 / n, 0.5 + 0.75 / n,
                                    0.5 + 0.25 / n],
                                   [0.3, 0.47, 0.55],
                                   [0.3, 0.7, 0.5 / n]]),
                weight=np.array([1.0, 2.0, 0.5]),
                table_idx=np.array([0, 1, 0], np.int32))


def noneq_tables():
    """_tables() with the k27..k31 weights of two SED buckets, per cell
    volume 1 (the JAX package's convention)."""
    tables = _tables()
    pop = jstellar.blackbody_population(q_ionizing=5.0e48)
    tables["quad_W27"] = np.stack([
        jstellar.quadrature_noneq_weights(pop, i_spec, coef, 0, 0.0)
        for i_spec, coef in ((0, 0.0), (2, 0.5))])
    return tables


def port_tables(tables, geom):
    """The port's form of JAX tables: quad_W27 per cell face area, where
    the JAX package's is per cell volume."""
    if "quad_W27" not in tables:
        return tables
    return dict(tables, quad_W27=tables["quad_W27"] * geom.cell_size)


_CASES = {
    "table": ("table", NO_DUST),
    "quadrature_nosub": ("quadrature", NO_SUBLIMATION),
    "quadrature_complete": ("quadrature", COMPLETE_SUBLIMATION),
    "quadrature_noneq": ("quadrature_noneq", NO_DUST),
}


@pytest.fixture(scope="module")
def traces():
    """{case: (JAX trace, port trace)} of the module's state, f64."""
    js, ts = states()
    src = sources()
    out = {}
    for case, (mode, dust) in _CASES.items():
        tables = noneq_tables() if mode == "quadrature_noneq" else _tables()
        tgeom = tstate.GridGeometry(N, N, N, BOX)
        j = jrml.trace_point_sources_ml(
            js, jstate.GridGeometry(N, N, N, BOX), jrays.SourceBatch(**src),
            tables, dust_approximation=dust, max_pixel_level=3,
            dtype=jnp.float64, rates_mode=mode)
        t = trml.trace_point_sources_ml(
            ts, tgeom, trays.SourceBatch(**src), port_tables(tables, tgeom),
            dust_approximation=dust, max_pixel_level=3, dtype=F64,
            rates_mode=mode)
        out[case] = (j, t)
    return out


@pytest.mark.parametrize("case", list(_CASES))
def test_trace_ml_matches_jax_f64(traces, case):
    (jrfs, jdiag), (trfs, tdiag) = traces[case]
    assert len(trfs) == len(jrfs) == L
    src = sources()
    for ell, (a, b) in enumerate(zip(trfs, jrfs)):
        assert type(a).__name__ == type(b).__name__
        assert a.krate24.shape == ((N * 2 ** ell) ** 3,)
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name).numpy(), np.asarray(getattr(b, f.name))
            peak = float(np.abs(y).max())
            # every level and every channel is reached
            assert peak > 0.0, (ell, f.name)
            assert np.abs(x - y).max() <= 1e-9 * peak, (ell, f.name)
    pairs = [(getattr(tdiag, f.name).numpy(),
              np.asarray(getattr(jdiag, f.name)), f.name)
             for f in dataclasses.fields(jdiag)]
    pairs += [(trays.escape_fractions(tdiag, src["weight"]),
               jrays.escape_fractions(jdiag, src["weight"]), "escape"),
              (trays.cosmic_spectrum(tdiag, src["weight"], 3),
               jrays.cosmic_spectrum(jdiag, src["weight"], 3), "spectrum")]
    for a, b, name in pairs:
        assert np.abs(a - b).max() <= 1e-9 * np.abs(b).max(), name


def test_leaf_level_volume_matches_jax():
    refined = maps(N, 4)
    j = jrml.leaf_level_volume([jnp.asarray(r) for r in refined], N, 4)
    t = trml.leaf_level_volume([torch.as_tensor(r) for r in refined], N, 4)
    assert t.dtype == torch.int32 and t.shape == ((8 * N) ** 3,)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert set(np.unique(t.numpy())) == {0, 1, 2, 3}
    assert trml._level_offsets(N, 3) == [0, N ** 3, N ** 3 + (2 * N) ** 3]


# ---------------------------------------------------------------------------
# Degenerate limits (the JAX package's tests/test_rays_multilevel.py), port
# only
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
                             dtype=F64, device="cpu")


def _ml(base, refined):
    return tamr.make_multilevel_state(base, [torch.as_tensor(r)
                                             for r in refined])


def test_unrefined_three_levels_match_uniform(bb_tables):
    tables, _ = bb_tables
    n = 8
    geom = tstate.GridGeometry(n, n, n, 100 * KPC)
    base = _rand_state(n)
    src = _source_at([0.47, 0.52, 0.5])
    rfs, diag_m = trml.trace_point_sources_ml(
        _ml(base, [np.zeros((n,) * 3, bool), np.zeros((2 * n,) * 3, bool)]),
        geom, src, tables, max_pixel_level=3)
    rf_u, diag_u = trays.trace_point_sources(base, geom, src, tables,
                                             max_pixel_level=3)
    for f in dataclasses.fields(rf_u):
        u = getattr(rf_u, f.name)
        np.testing.assert_allclose(getattr(rfs[0], f.name).numpy(),
                                   u.numpy(), rtol=1e-12,
                                   atol=1e-12 * float(u.abs().max()),
                                   err_msg=f.name)
        for ell in (1, 2):
            assert not getattr(rfs[ell], f.name).any(), (ell, f.name)
    for f in dataclasses.fields(diag_u):
        np.testing.assert_allclose(getattr(diag_m, f.name).numpy(),
                                   getattr(diag_u, f.name).numpy(),
                                   rtol=1e-12, err_msg=f.name)


@pytest.mark.parametrize("rates_mode", ["table", "quadrature"])
def test_two_levels_match_rays_amr(rates_mode):
    """L = 2 gives the JAX package's two-level tracer's trace (the port
    has one march for both, core/rays_amr.py calls this one; the JAX
    package holds its pair exactly): within 1e-9 of each channel's peak,
    the diagnostics too."""
    js, ts = states(levels=2)
    src = sources()
    geom = tstate.GridGeometry(N, N, N, BOX)
    rfs, diag_m = trml.trace_point_sources_ml(
        ts, geom, trays.SourceBatch(**src), _tables(), max_pixel_level=3,
        rates_mode=rates_mode)
    rfb, rff, diag_2 = jrays_amr.trace_point_sources_amr(
        jamr.AMRState(base=js.levels[0], fine=js.levels[1],
                      refined=js.refined[0]),
        jstate.GridGeometry(N, N, N, BOX), jrays.SourceBatch(**src),
        _tables(), max_pixel_level=3, dtype=jnp.float64,
        rates_mode=rates_mode)
    for a, b in ((rfs[0], rfb), (rfs[1], rff)):
        for f in dataclasses.fields(b):
            y = np.asarray(getattr(b, f.name))
            peak = float(np.abs(y).max())
            assert peak > 0.0, f.name
            assert float(np.abs(getattr(a, f.name).numpy() - y).max()) <= (
                1e-9 * peak), f.name
    for f in dataclasses.fields(diag_2):
        y = np.asarray(getattr(diag_2, f.name))
        assert float(np.abs(getattr(diag_m, f.name).numpy() - y).max()) <= (
            1e-9 * float(np.abs(y).max())), f.name


def test_three_levels_conserve_photons(bb_tables):
    tables, total = bb_tables
    n = 8
    geom = tstate.GridGeometry(n, n, n, 100 * KPC)
    refined = [np.zeros((n,) * 3, bool), np.zeros((2 * n,) * 3, bool)]
    refined[0][2:6, 2:6, 2:6] = True
    refined[1][6:10, 6:10, 6:10] = True
    state = _ml(_rand_state(n, seed=7, scale=1.0),   # dense: all absorbed
                tamr.enforce_balance(refined))
    rfs, _ = trml.trace_point_sources_ml(state, geom,
                                         _source_at([0.5, 0.5, 0.5]), tables,
                                         max_pixel_level=3)
    absorbed = sum(float(rf.krate24.sum()) for rf in rfs)
    assert absorbed == pytest.approx(total, rel=0.05)
    # the source sits inside the doubly refined region: the innermost
    # deposits land on level 2
    assert float(rfs[2].krate24.sum()) > 0.5 * absorbed


def test_three_level_boundary_handoff(bb_tables):
    """A ray crossing level 0 -> 1 -> 2 -> 1 -> 0 takes the absorption of
    the same uniform medium."""
    tables, _ = bb_tables
    n = 8
    geom = tstate.GridGeometry(n, n, n, 50 * KPC)
    base = tstate.uniform_state(n, nh=0.01, tgas=1e4, dtype=F64,
                                device="cpu")
    refined = [np.zeros((n,) * 3, bool), np.zeros((2 * n,) * 3, bool)]
    refined[0][3:5, :, :] = True
    refined[1][7:9, :, :] = True
    src = _source_at([0.06, 0.5, 0.52])
    rfs, diag_m = trml.trace_point_sources_ml(
        _ml(base, tamr.enforce_balance(refined)), geom, src, tables,
        max_pixel_level=3)
    rf_u, diag_u = trays.trace_point_sources(base, geom, src, tables,
                                             max_pixel_level=3)
    assert sum(float(rf.krate24.sum()) for rf in rfs) == pytest.approx(
        float(rf_u.krate24.sum()), rel=2e-2)
    np.testing.assert_allclose(diag_m.ndot_remaining.numpy(),
                               diag_u.ndot_remaining.numpy(), rtol=2e-2)


def test_f32_noneq_kill_envelope_matches_uniform():
    """float32, quadrature_noneq, the default kills: the spectrum-exhaustion
    kill's envelope counts the k27..k31 weights (per face area, over the
    cell size), as the uniform tracer's does, so an unrefined three-level
    grid gives the uniform tracer's trace.  In gas that absorbs the
    ionizing spectrum within a cell, the rays live on for the
    sub-threshold k27..k31 deposits (weights scaled here to the band
    weights' envelope, so that they count): with an envelope of the band
    weights alone they die in the first cells and deposit k27 in 9 cells
    of the 512, not the uniform tracer's 485."""
    n = 8
    f32 = torch.float32
    geom = tstate.GridGeometry(n, n, n, 100 * KPC)
    vol = geom.cell_volume
    t = noneq_tables()
    t = port_tables(dict(t, reaction_log=t["reaction_log"] - np.log(vol),
                         energy_log=t["energy_log"] - np.log(vol),
                         quad_W=t["quad_W"] / vol,
                         quad_W27=t["quad_W27"] / vol), geom)

    def envelope(w):
        return np.abs(w).sum(axis=2).max(axis=0)
    t["quad_W27"] = t["quad_W27"] * (envelope(t["quad_W"]).max() * (
        geom.cell_size / envelope(t["quad_W27"]).max()))
    nh = np.random.default_rng(0).lognormal(0, 0.5, (n,) * 3)
    base = tstate.make_state(nh * MH / PSI, np.full((n,) * 3, 1e4), nh,
                             dtype=f32, device="cpu")
    src = _source_at([0.47, 0.52, 0.5])
    kw = dict(max_pixel_level=3, dtype=f32, rates_mode="quadrature_noneq")
    rfs, diag_m = trml.trace_point_sources_ml(
        _ml(base, [np.zeros((n,) * 3, bool), np.zeros((2 * n,) * 3, bool)]),
        geom, src, t, **kw)
    rf_u, diag_u = trays.trace_point_sources(base, geom, src, t, **kw)
    assert int((rf_u.krate27 > 0).sum()) > n ** 3 // 2
    for f in dataclasses.fields(rf_u):
        u = getattr(rf_u, f.name)
        np.testing.assert_allclose(getattr(rfs[0], f.name).numpy(),
                                   u.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(u.abs().max()),
                                   err_msg=f.name)
        for ell in (1, 2):
            assert not getattr(rfs[ell], f.name).any(), (ell, f.name)
    for f in dataclasses.fields(diag_u):
        np.testing.assert_allclose(getattr(diag_m, f.name).numpy(),
                                   getattr(diag_u, f.name).numpy(),
                                   rtol=1e-5, err_msg=f.name)


def test_face_exact_f32_rays_terminate():
    """The JAX package's tests/test_rays_multilevel.py::
    TestCornerHitTermination: float32 rays parked exactly on a cell's
    corner (two coordinates on faces, the state every crossing's snap
    produces) with negative components on those axes must march on and
    leave the box, not freeze in the zero-step period-2 cycle that a
    sub-ulp relocalization nudge gives."""
    n, levels = 16, 2
    nF = n * 2 ** (levels - 1)
    f32 = torch.float32
    geom = tstate.GridGeometry(n, n, n, 100.0 * KPC)
    refined = np.zeros((n,) * 3, bool)
    refined[6:10, 6:10, 6:10] = True
    nh = np.random.default_rng(0).lognormal(0, 0.3, (n,) * 3) * 1e-4
    ml = tamr.sync_restriction_multi(_ml(
        tstate.make_state(nh * MH / PSI, np.full(nh.shape, 1e4), nh,
                          dtype=F64, device="cpu"), [refined]))
    fields = {
        "leaf_level": trml.leaf_level_volume(ml.refined, n, levels),
        "lv_all": torch.cat([trays._pack_fields(*(x.reshape(-1).to(f32) for x
                                                  in (lv.HI, lv.HeI, lv.HeII,
                                                      lv.nh, lv.abun2)))
                             for lv in ml.levels]),
        "offsets": torch.tensor(trml._level_offsets(n, levels)),
    }
    R = 8
    pos = np.full((R, 3), 0.37109, np.float32)
    pos[:, 1] = 8.0 / nF * 2            # exactly on a face
    pos[:, 2] = 14.0 / nF               # exactly on a face
    d = np.tile(np.array([[0.65, -0.645, -0.4]], np.float32), (R, 1))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ray = trays._RayState(
        pos=torch.tensor(pos), direction=torch.tensor(d),
        cell=torch.tensor(np.clip((pos * nF).astype(np.int32), 0, nF - 1)),
        radius=torch.zeros(R, dtype=f32), ndot=torch.ones(R, dtype=f32),
        depth=torch.zeros((R, 4), dtype=f32),
        alive=torch.ones(R, dtype=torch.bool),
        split=torch.zeros(R, dtype=torch.bool),
        table_idx=torch.zeros(R, dtype=torch.int64),
        crossed=torch.zeros(R, dtype=torch.bool),
        cross_depth=torch.zeros((R, 4), dtype=f32))
    rng = np.random.default_rng(1)
    rate_ctx = ("quadrature", (
        torch.tensor(rng.uniform(0.1, 1.0, (4, 16)), dtype=f32),
        torch.tensor(rng.uniform(0, 1e-30, (1, 16, 6)), dtype=f32)))
    rf = trays.RateFields(*[torch.zeros(fields["lv_all"].shape[0], dtype=f32)
                            for _ in range(6)])
    cap = 6 * nF
    steps0 = trml.MARCH_STEPS
    out, _ = trml._march_phase_ml(
        ray, fields, geom, levels, rate_ctx,
        trays.RayDiagnostics.zeros(1, f32, "cpu"), rf, 1e9, True, NO_DUST,
        cap, torch.zeros(R, dtype=torch.int64), tau_kill=30.0,
        rel_kill=1e-10, scale=1.0)
    # every ray left the box (or died) well before the cap
    assert not bool(out.alive.any())
    assert trml.MARCH_STEPS - steps0 < cap // 2


def test_f32_deposits_survive_a_flushing_index_add(monkeypatch):
    """bench.py::bench_step's cell cut to an 8^3 base with the module's two
    refined levels (a uniform box of 2000 kpc, nH 2e-4, T 1.5e4, ionized
    to a neutral fraction of 1e-3, 8 sources from seed 0, maxPixelLevel
    3): over the base cell's volume a fifth of the float64 trace's nonzero
    deposits on every level are below float32's smallest normal value
    (1.2e-38), and a CUDA float32 index_add_ flushes such adds to zero.
    With index_add_ flushing them here too, the float32 trace loses no
    deposit that float32 can hold (the tracer accumulates them times
    rays._deposit_scale) beyond those that the float32 trace without the
    flush misses too (3 on level 2, where float32 positions take a ray
    past a cell that the float64 ray grazes, 6e-7 of the channel's peak),
    and holds every channel of every level within 1e-5 of its peak of the
    float64 trace with the same kills (tests/test_torch_rays.py's test of
    the uniform tracer).  Without the scale it loses thousands."""
    n = 8
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
    for dtype, flush in ((F64, False), (torch.float32, False),
                         (torch.float32, True)):
        ctx = StellarContext.build(pop, bench_sources(n, 8), geom,
                                   10.0 * MYR, metal_coefs=[(0, 0.0)],
                                   max_pixel_level=3, dtype=dtype,
                                   device="cpu")
        base = tstate.uniform_state(n, nh=2e-4, tgas=1.5e4, x_neutral=1e-3,
                                    dtype=dtype, device="cpu")
        state = tamr.make_multilevel_state(
            base, [torch.as_tensor(r) for r in maps(n, 3)])
        with monkeypatch.context() as mp:
            if flush:
                mp.setattr(torch.Tensor, "index_add_", flushing)
            out, _ = trml.trace_point_sources_ml(
                state, geom, ctx.sources, ctx.tables, max_pixel_level=3,
                dtype=dtype, **kills)
        rf[dtype, flush] = [torch.stack([getattr(r, f.name).double()
                                         for f in dataclasses.fields(r)])
                            for r in out]
    for ell, (a, a_kept, b) in enumerate(zip(rf[torch.float32, True],
                                             rf[torch.float32, False],
                                             rf[F64, False])):
        below = int(((b != 0) & (b.abs() < tiny)).sum())
        assert below > 0.1 * int((b != 0).sum()), ell
        lost = (b != 0) & (a == 0) & (b.abs() >= 2.0 ** -149)
        assert int(lost.sum()) <= 3, ell
        assert not bool((lost & (a_kept != 0)).any()), ell
        for i in range(len(b)):
            peak = float(b[i].abs().max())
            assert float((a[i] - b[i]).abs().max()) <= 1e-5 * peak, (ell, i)
        assert float(b[0].max()) > 0.0 and float(b[3].max()) > 0.0, ell
