"""PyTorch port, the non-equilibrium 9-species chemistry
(core/chemistry_noneq.py, the tracer's quadrature_noneq deposits,
RTModel.make_noneq_step, shard_species, the species snapshots) against the
JAX package's on the same NumPy inputs, on the CPU.

Tolerances, float64: the tables equal to the last bit; the lookups and
k13 within 1e-13 relative (the two libraries' exp, log and pow may round
an ulp apart); the network within 1e-10 of each species' peak, the step
and the tracer's deposits within 1e-9 (the tracers sum their quadrature
products and scatter-adds in another order).  Float32: see
test_evolve_matches_jax_f32."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import radiativetransfer_tpu_torch as rt
from radiativetransfer_tpu.core import chemistry_noneq as jcn
from radiativetransfer_tpu.core import rays as jrays
from radiativetransfer_tpu.core import state as jstate
from radiativetransfer_tpu.core import step as jstep
from radiativetransfer_tpu.io import snapshot as jsnap
from radiativetransfer_tpu.tables import chemistry_rates as jrates
from radiativetransfer_tpu.tables import stellar as jstellar
from radiativetransfer_tpu_torch.config import (
    MODE_BOTH_STELLAR_UVB_TRANSFER,
    MODE_UVB_TRANSFER_ONLY,
    RunConfig,
)
from radiativetransfer_tpu_torch.constants import (
    GAMMA_ADIABATIC,
    KB,
    KPC,
    LOGTEM0,
    LOGTEM9,
    MH,
    MYR,
    PSI,
)
from radiativetransfer_tpu_torch.core import chemistry_noneq as tcn
from radiativetransfer_tpu_torch.core import rays as trays
from radiativetransfer_tpu_torch.io import snapshot as tsnap
from radiativetransfer_tpu_torch.parallel import mesh as tmesh
from radiativetransfer_tpu_torch.tables import chemistry_rates as trates
from radiativetransfer_tpu_torch.tables import stellar as tstellar
from test_torch_rays import BOX, N, _fields, _sources, _tables
from test_torch_host import jax_compile_cache

SPECIES = tcn.SPECIES
_JDTYPE = {torch.float64: jnp.float64, torch.float32: jnp.float32}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port: the network's eager loop is ~80k
    small CPU ops a step, on which more threads only spin (8 threads: the
    same wall time alone for 8x the CPU time), starving the other test
    workers."""
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


@pytest.fixture(scope="module")
def rate_tables():
    return trates.calc_rates(), jrates.calc_rates()


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _assert_peak_close(a, b, rel, name=""):
    """|a - b| <= rel * max|b| elementwise."""
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, name
    peak = float(np.max(np.abs(b)))
    err = float(np.max(np.abs(a - b)))
    assert err <= rel * peak, (name, err, peak, err / max(peak, 1e-300))


def _assert_species_close(t_sp, j_sp, rel):
    for name in (*SPECIES, "eint"):
        _assert_peak_close(getattr(t_sp, name), getattr(j_sp, name), rel,
                           name)


# ---------------------------------------------------------------------------
# The network
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tables_identical(rate_tables, dtype):
    t_tab, j_tab = rate_tables
    t = tcn.NoneqTablesDevice.from_tables(t_tab, dtype, "cpu")
    j = jcn.NoneqTablesDevice.from_tables(j_tab, _JDTYPE[dtype])
    for name in ("kcol", "k13dd", "cool", "h2cool"):
        a = getattr(t, name)
        assert a.dtype == dtype and a.device.type == "cpu", name
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(j, name)),
                                      err_msg=name)
    assert t.compa == j.compa
    assert {n for n, _ in t.named_buffers()} == {"kcol", "k13dd", "cool",
                                                 "h2cool"}


def test_lookups_and_k13_match_jax(rate_tables):
    """Random log T, a tenth of it outside the table on either side, and
    each table's end points."""
    t_tab, j_tab = rate_tables
    t = tcn.NoneqTablesDevice.from_tables(t_tab, torch.float64, "cpu")
    j = jcn.NoneqTablesDevice.from_tables(j_tab, jnp.float64)
    rng = np.random.default_rng(5)
    span = LOGTEM9 - LOGTEM0
    logtem = np.concatenate([
        rng.uniform(LOGTEM0 - 0.1 * span, LOGTEM9 + 0.1 * span, 4000),
        [LOGTEM0, LOGTEM9, LOGTEM0 - 1.0, LOGTEM9 + 1.0]])
    assert (logtem < LOGTEM0).sum() > 100 and (logtem > LOGTEM9).sum() > 100
    lt, lj = torch.as_tensor(logtem), jnp.asarray(logtem)
    for name in ("kcol", "cool", "h2cool"):
        a = tcn._lookup_log(getattr(t, name), lt)
        b = jcn._lookup_log(getattr(j, name), lj)
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-13,
                                   atol=0, err_msg=name)
    row_t = tcn._lookup_lin(t.k13dd, lt)
    row_j = jcn._lookup_lin(j.k13dd, lj)
    np.testing.assert_allclose(row_t.numpy(), np.asarray(row_j), rtol=1e-13,
                               atol=1e-300)
    # HI from below the 1e-10 floor to dense gas; T across the fit's range
    hi = 10.0 ** rng.uniform(-12, 4, logtem.shape)
    tgas = np.exp(logtem)
    k13_t = tcn._k13_density_dependent(row_t, torch.as_tensor(hi),
                                       torch.as_tensor(tgas))
    k13_j = jcn._k13_density_dependent(row_j, jnp.asarray(hi),
                                       jnp.asarray(tgas))
    np.testing.assert_allclose(k13_t.numpy(), np.asarray(k13_j), rtol=1e-13,
                               atol=0)
    assert (k13_t.numpy() > 1e-59).sum() > 100   # the fit's range is hit


def _regime_cells(n: int = 8, seed: int = 2):
    """n^3 cells, a quarter in each regime of the JAX package's
    tests/test_chemistry_noneq.py (ionizing front, recombining cloud,
    cold H2 formation, Lyman-Werner dissociation), each cell's density,
    abundances and rates drawn around its regime's values.  Returns
    (species arrays, temperature, photo rate arrays)."""
    rng = np.random.default_rng(seed)
    m = n ** 3
    q = m // 4
    reg = np.repeat(np.arange(4), q)
    jit = rng.lognormal(0.0, 0.3, m)
    nh = np.choose(reg, [1e-3, 1.0, 1e2, 1.0]) * jit
    nhe = 0.079 * nh
    xi = np.choose(reg, [1e-6, 1.0 - 1e-8, 1e-4, 1e-8]) * rng.uniform(
        0.5, 1.0, m)
    fh2 = np.where(reg == 3, 1e-3, 0.0) * rng.uniform(0.5, 1.5, m)
    HII = nh * xi
    H2I = fh2 * nh
    HI = nh - HII - 2.0 * H2I
    heIII_f = np.where(reg == 1, 1.0 - 1e-6, 0.0)
    HeIII = nhe * heIII_f
    HeII = np.where(reg == 1, 1e-6 * nhe, 0.0)
    HeI = nhe - HeII - HeIII
    de = HII + HeII + 2.0 * HeIII
    z = np.zeros(m)
    T = np.choose(reg, [1.2e4, 1.5e4, 800.0, 200.0]) * rng.uniform(0.9, 1.1,
                                                                    m)
    sp = dict(HI=HI, HII=HII, HeI=HeI, HeII=HeII, HeIII=HeIII, de=de, HM=z,
              H2I=H2I, H2II=z)
    ntot = sum(sp.values())
    sp["eint"] = KB * T * ntot / (GAMMA_ADIABATIC - 1.0)
    on = (reg == 0).astype(float) * rng.uniform(0.5, 2.0, m)
    photo = dict(k24=1e-12 * on, k26=5e-13 * on, k25=1e-14 * on,
                 k31=np.where(reg == 3, 1e-11, 0.0) * rng.uniform(0.5, 2.0,
                                                                  m),
                 k27=1e-10 * on, k28=1e-12 * on, k29=1e-13 * on,
                 k30=1e-13 * on)
    # photoheating of ~3 eV per ionization where the front is
    photo["heat"] = photo["k24"] * HI * 5e-12
    shape = (n, n, n)
    return ({k: v.reshape(shape) for k, v in sp.items()}, T.reshape(shape),
            {k: v.reshape(shape) for k, v in photo.items()})


def _evolve_both(dtype, evolve_energy, rate_tables, dt=3e11,
                 n_substeps=50):
    t_tab, j_tab = rate_tables
    sp, T, photo = _regime_cells()
    jd = _JDTYPE[dtype]

    def tt(x):
        return torch.as_tensor(x, dtype=dtype)

    t_sp = tcn.evolve_noneq(
        tcn.SpeciesState(**{k: tt(v) for k, v in sp.items()}), dt,
        tcn.NoneqTablesDevice.from_tables(t_tab, dtype, "cpu"),
        photo=tcn.PhotoRates(**{k: tt(v) for k, v in photo.items()}),
        n_substeps=n_substeps, evolve_energy=evolve_energy,
        tgas_fixed=None if evolve_energy else tt(T))
    # the JAX tables in the run's dtype, passed explicitly (its default
    # follows jax_enable_x64, not the state's dtype)
    j_sp = jcn.evolve_noneq(
        jcn.SpeciesState(**{k: jnp.asarray(v, jd) for k, v in sp.items()}),
        dt, jcn.NoneqTablesDevice.from_tables(j_tab, jd),
        photo=jcn.PhotoRates(**{k: jnp.asarray(v, jd)
                                for k, v in photo.items()}),
        n_substeps=n_substeps, evolve_energy=evolve_energy,
        tgas_fixed=None if evolve_energy else jnp.asarray(T, jd))
    return t_sp, j_sp, sp


@pytest.mark.parametrize("evolve_energy", [False, True])
def test_evolve_matches_jax_f64(rate_tables, evolve_energy):
    t_sp, j_sp, sp0 = _evolve_both(torch.float64, evolve_energy, rate_tables)
    assert t_sp.HI.dtype == torch.float64
    _assert_species_close(t_sp, j_sp, 1e-10)
    # the regimes moved: ionized, recombined, formed and lost H2
    n = t_sp.HI.shape[0]
    q = n ** 3 // 4
    h2 = t_sp.H2I.reshape(-1).numpy()
    assert np.all(h2[2 * q:3 * q] > 0.0)
    assert np.all(h2[3 * q:] < sp0["H2I"].reshape(-1)[3 * q:])
    hii = t_sp.HII.reshape(-1).numpy()
    assert np.all(hii[:q] > 10.0 * sp0["HII"].reshape(-1)[:q])
    # conservation of nuclei and charge
    np.testing.assert_allclose(t_sp.nh.numpy(),
                               sum(sp0[k] for k in ("HI", "HII"))
                               + 2.0 * sp0["H2I"], rtol=1e-10)
    np.testing.assert_allclose(t_sp.de.numpy(),
                               t_sp.charge_electrons().numpy(), rtol=1e-8)
    if evolve_energy:
        assert np.max(np.abs(t_sp.eint.numpy() / sp0["eint"] - 1.0)) > 1e-3


@pytest.mark.parametrize("evolve_energy", [False, True])
def test_evolve_matches_jax_f32(rate_tables, evolve_energy):
    """float32, the JAX tables made float32 explicitly.  XLA's and
    PyTorch's float32 exp and log round an ulp apart in a tenth of their
    values (ROADMAP, faults found in the port); 50 BDF substeps, each
    taking the least of four limiters, carry those ulps from the rates
    into every species, so each is held within 1e-4 of its peak (float32
    resolves 6e-8; measured 1.2e-6 with the temperature fixed and 4.2e-6,
    in H2II, with the energy evolved)."""
    t_sp, j_sp, _ = _evolve_both(torch.float32, evolve_energy, rate_tables)
    assert t_sp.HI.dtype == torch.float32 and j_sp.HI.dtype == jnp.float32
    for name in (*SPECIES, "eint"):
        assert bool(torch.isfinite(getattr(t_sp, name)).all()), name
    _assert_species_close(t_sp, j_sp, 1e-4)


def test_species_from_field_state_matches_jax():
    n = 6
    rng = np.random.default_rng(4)
    f = _fields()
    f = {k: v[:n, :n, :n] for k, v in f.items()}
    js = jstate.make_state(**f, dtype=jnp.float64)
    ts = rt.make_state(**f, dtype=torch.float64, device="cpu")
    fh2, fhm = rng.uniform(0, 1e-3), rng.uniform(0, 1e-6)
    _assert_species_close(tcn.species_from_field_state(ts, fh2, fhm),
                          jcn.species_from_field_state(js, fh2, fhm), 1e-15)


# ---------------------------------------------------------------------------
# The tracer's quadrature_noneq deposits
# ---------------------------------------------------------------------------


def _noneq_tables(volume=1.0):
    tables = _tables(volume)
    pop = jstellar.blackbody_population(q_ionizing=5.0e48)
    tables["quad_W27"] = np.stack([
        jstellar.quadrature_noneq_weights(pop, i_spec, coef, 0, 0.0) / volume
        for i_spec, coef in ((0, 0.0), (2, 0.5))])
    return tables


def _trace_noneq_both(dtype, volume=1.0):
    f, src, tables = _fields(), _sources(), _noneq_tables(volume)
    jd = _JDTYPE[dtype]
    js = jstate.make_state(**f, dtype=jd)
    ts = rt.make_state(**f, dtype=dtype, device="cpu")
    j = jrays.trace_point_sources(
        js, jstate.GridGeometry(N, N, N, BOX), jrays.SourceBatch(**src),
        tables, max_pixel_level=3, dtype=jd, rates_mode="quadrature_noneq")
    tgeom = rt.GridGeometry(N, N, N, BOX)
    # the port's quad_W27 is per cell face area, the JAX package's per
    # cell volume
    t_tables = dict(tables,
                    quad_W27=tables["quad_W27"] * tgeom.cell_size)
    t = trays.trace_point_sources(ts, tgeom, trays.SourceBatch(**src),
                                  t_tables, max_pixel_level=3, dtype=dtype,
                                  rates_mode="quadrature_noneq")
    plain = trays.trace_point_sources(ts, tgeom, trays.SourceBatch(**src),
                                      tables, max_pixel_level=3, dtype=dtype,
                                      rates_mode="quadrature")
    return j, t, plain


@pytest.mark.parametrize("dtype,rel", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-5)])
def test_quadrature_noneq_deposits_match_jax(dtype, rel):
    """16^3, 3 sources in 2 SED buckets, f64 and f32.  f32: tau_kill 30
    and the spectrum-exhaustion kill, whose envelope now bounds the
    k27..k31 weights too, on both sides; 1e-5 of the peak, as
    tests/test_torch_rays.py holds f32 traces.  The weights are divided by
    1e48, not by the cell volume (1.9e68 here) as the JAX package's
    StellarContext divides them: that puts every k27..k31 weight below
    float32's normal range (8.6e-39 at most), where XLA's CPU flushes to
    zero (ROADMAP, faults found in the port); over 1e48 the subnormal ones
    are below 1e-20 of the largest.  The port's own scaling is held in
    test_noneq_deposits_f32_at_production_scaling."""
    volume = 1.0 if dtype == torch.float64 else 1e48
    (jrf, jdiag), (trf, tdiag), (prf, pdiag) = _trace_noneq_both(dtype,
                                                                 volume)
    assert isinstance(trf, trays.NoneqRateFields)
    names = [f.name for f in dataclasses.fields(trf)]
    assert names == [f.name for f in dataclasses.fields(jrf)]
    assert len(names) == 11
    for name in names:
        _assert_peak_close(getattr(trf, name), getattr(jrf, name), rel, name)
    for f in dataclasses.fields(jdiag):
        _assert_peak_close(getattr(tdiag, f.name), getattr(jdiag, f.name),
                           rel, f.name)
    # the six band deposits are plain quadrature's, the diagnostics too
    for f in dataclasses.fields(prf):
        np.testing.assert_allclose(getattr(trf, f.name).numpy(),
                                   getattr(prf, f.name).numpy(), rtol=1e-12,
                                   atol=0, err_msg=f.name)
    for f in dataclasses.fields(pdiag):
        np.testing.assert_array_equal(getattr(tdiag, f.name).numpy(),
                                      getattr(pdiag, f.name).numpy())
    for c in range(27, 32):
        k = getattr(trf, f"krate{c}").numpy()
        assert np.all(np.isfinite(k)) and np.all(k >= 0.0), c
        assert k.max() > 0.0, c


@pytest.mark.parametrize("flush", [False, True])
def test_noneq_deposits_f32_at_production_scaling(flush):
    """The port's float32 deposits with the weights StellarContext.build
    makes (16^3 in a 300 kpc box, 3 sources of q = 5e48, seed 11), held
    against its float64 trace of the same inputs within 1e-5 of each
    channel's peak, as float32 traces are held (measured: 7.2e-7).
    flush: float32 subnormals flushed to zero during the float32 trace,
    as XLA's CPU does and a device may; over the cell volume every
    k27..k31 weight here is subnormal and then deposits nothing, over the
    face area the largest is 1.8e-16.  Flushed, the band heating channels
    are held within 1e-4: crate25 peaks at 2.9e-33 erg/cm^3/s and its
    deposits reach below 1.2e-38, float32's smallest normal, so it loses
    1.7e-5 of its peak (ROADMAP, faults found in the port)."""
    geom = rt.GridGeometry(N, N, N, BOX)
    src = trays.SourceBatch(**dict(_sources(),
                                   table_idx=np.zeros(3, np.int32)))
    pop = tstellar.blackbody_population(q_ionizing=5.0e48)
    rf = {}
    for dtype in (torch.float64, torch.float32):
        ctx = rt.StellarContext.build(pop, src, geom, 10.0 * MYR,
                                      metal_coefs=[(0, 0.0)],
                                      max_pixel_level=3, noneq=True,
                                      dtype=dtype, device="cpu")
        state = rt.make_state(**_fields(), dtype=dtype, device="cpu")
        torch.set_flush_denormal(flush and dtype == torch.float32)
        try:
            rf[dtype], _ = trays.trace_point_sources(
                state, geom, ctx.sources, ctx.tables, max_pixel_level=3,
                dtype=dtype, rates_mode="quadrature_noneq")
        finally:
            torch.set_flush_denormal(False)
    for f in dataclasses.fields(rf[torch.float64]):
        rel = 1e-4 if flush and f.name.startswith("crate") else 1e-5
        _assert_peak_close(getattr(rf[torch.float32], f.name).double(),
                           getattr(rf[torch.float64], f.name), rel, f.name)
    for c in range(27, 32):
        assert float(getattr(rf[torch.float64], f"krate{c}").max()) > 0.0


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------


def _cfg(mode, **kw):
    return RunConfig(mode=mode, current_redshift=6.55, n_angular_level=1,
                     reionization_model=10, **kw)


def _states(n, seed=6):
    rng = np.random.default_rng(seed)
    nh = 1e-4 * rng.lognormal(0.0, 1.0, (n, n, n))
    args = (nh * MH / PSI, np.full(nh.shape, 2e4), nh)
    return (jstate.make_state(*args, dtype=jnp.float64),
            rt.make_state(*args, dtype=torch.float64, device="cpu"))


def _contexts(geom_j, geom_t, n_src=2):
    pos = np.random.default_rng(9).uniform(0.3, 0.7, (n_src, 3))
    kw = dict(position=pos, weight=np.ones(n_src),
              table_idx=np.zeros(n_src, np.int32))
    jc = jstep.StellarContext.build(
        jstellar.blackbody_population(), jrays.SourceBatch(**kw), geom_j,
        10.0 * MYR, metal_coefs=[(0, 0.0)], max_pixel_level=3, noneq=True)
    tc = rt.StellarContext.build(
        tstellar.blackbody_population(), trays.SourceBatch(**kw), geom_t,
        10.0 * MYR, metal_coefs=[(0, 0.0)], max_pixel_level=3, noneq=True,
        dtype=torch.float64, device="cpu")
    return jc, tc


@pytest.mark.parametrize("mode,n,evolve_energy", [
    (MODE_UVB_TRANSFER_ONLY, 8, False),
    (MODE_UVB_TRANSFER_ONLY, 16, True),
    (MODE_BOTH_STELLAR_UVB_TRANSFER, 8, True),
    (MODE_BOTH_STELLAR_UVB_TRANSFER, 16, False),
])
def test_noneq_step_matches_jax(mode, n, evolve_energy):
    """make_noneq_step, level 1, two steps of 2 Myr and 20 substeps from an
    equilibrium state with an H2 reservoir (1e-4 of the nuclei)."""
    box = 100.0 * KPC
    jg, tg = jstate.GridGeometry(n, n, n, box), rt.GridGeometry(n, n, n, box)
    jm = jstep.RTModel.setup(_cfg(mode), jg, dtype=jnp.float64)
    tm = rt.RTModel.setup(_cfg(mode), tg, torch.float64, "cpu")
    np.testing.assert_array_equal(tm.photo_thin_all, jm.photo_thin_all)
    js, ts = _states(n)
    js, ts = jm.initialize_equilibrium(js), tm.initialize_equilibrium(ts)
    j_sp = jcn.species_from_field_state(js, f_h2=1e-4)
    t_sp = tcn.species_from_field_state(ts, f_h2=1e-4)
    jc = tc = None
    if mode == MODE_BOTH_STELLAR_UVB_TRANSFER:
        jc, tc = _contexts(jg, tg)
        # the port's quad_W27 is per cell face area, the JAX package's per
        # cell volume
        np.testing.assert_allclose(
            tc.tables["quad_W27"].numpy() / tg.cell_size,
            np.asarray(jc.tables["quad_W27"]), rtol=1e-15, atol=0)
    kw = dict(n_substeps=20, evolve_energy=evolve_energy)
    j_step = jm.make_noneq_step(2.0 * MYR, jc, **kw)
    t_step = tm.make_noneq_step(2.0 * MYR, tc, **kw)
    tgas0 = ts.tgas.clone()
    for _ in range(2):
        j_out, t_out = j_step(js, j_sp), t_step(ts, t_sp)
        assert len(t_out) == len(j_out) == (3 if tc is not None else 2)
        js, j_sp, ts, t_sp = j_out[0], j_out[1], t_out[0], t_out[1]
        _assert_species_close(t_sp, j_sp, 1e-9)
        for name in ("HI", "HeI", "HeII", "tgas", "Jmean", "krate24",
                     "crate24"):
            _assert_peak_close(getattr(ts, name), getattr(js, name), 1e-9,
                               name)
        if tc is not None:
            for f in dataclasses.fields(j_out[2]):
                _assert_peak_close(getattr(t_out[2], f.name),
                                   getattr(j_out[2], f.name), 1e-9, f.name)
        assert tm.neutral_fraction(ts) == pytest.approx(
            jm.neutral_fraction(js), rel=1e-9)
    # the state follows the species; its temperature only with the energy
    assert torch.equal(ts.HI, t_sp.HI)
    if evolve_energy:
        np.testing.assert_allclose(ts.tgas.numpy(), t_sp.tgas.numpy(),
                                   rtol=1e-14)
        assert not torch.equal(ts.tgas, tgas0)
    else:
        assert torch.equal(ts.tgas, tgas0)
    np.testing.assert_allclose(t_sp.nh.numpy(), ts.nh.numpy(), rtol=1e-10)


@pytest.fixture(scope="module")
def mesh_reference():
    """One device's noneq mode-9 step at 16^3, f64, from equilibrium."""
    n = 16
    geom = rt.GridGeometry(n, n, n, 100.0 * KPC)
    model = rt.RTModel.setup(_cfg(MODE_UVB_TRANSFER_ONLY), geom,
                             torch.float64, "cpu")
    state = model.initialize_equilibrium(_states(n)[1])
    species = tcn.species_from_field_state(state, f_h2=1e-4)
    one = model.make_noneq_step(5.0 * MYR, n_substeps=20)(state, species)
    return geom, state, species, one


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("strategy", ["rdma", "zones", "pipelined"])
def test_noneq_step_on_mesh_matches_one_device(mesh_reference, strategy, p):
    """The mesh reaches the sweep (the JAX package's
    tests/test_step_noneq.py:231-262): P CPU ranks against one device."""
    geom, state, species, (st1, sp1) = mesh_reference
    model = rt.RTModel.setup(_cfg(MODE_UVB_TRANSFER_ONLY,
                                  sweep_strategy=strategy), geom,
                             torch.float64, "cpu")
    with pytest.raises(ValueError, match="needs a mesh"):
        model.make_noneq_step(5.0 * MYR, n_substeps=20)(state, species)
    mesh = tmesh.make_grid_mesh(p, device="cpu")
    st, sp = model.make_noneq_step(5.0 * MYR, n_substeps=20, mesh=mesh)(
        tmesh.shard_state(state, mesh), tmesh.shard_species(species, mesh))
    _assert_species_close(sp, sp1, 1e-9)
    _assert_peak_close(st.Jmean, st1.Jmean, 1e-9, "Jmean")
    _assert_peak_close(st.HI, st1.HI, 1e-9, "HI")


def test_noneq_refusals():
    n = 4
    geom = rt.GridGeometry(n, n, n, 50.0 * KPC)
    model = rt.RTModel.setup(_cfg(MODE_BOTH_STELLAR_UVB_TRANSFER), geom,
                             torch.float64, "cpu")
    _, tc = _contexts(jstate.GridGeometry(n, n, n, 50.0 * KPC), geom)
    species = tcn.species_from_field_state(
        rt.uniform_state(n, dtype=torch.float64, device="cpu"))
    # point sources on a mesh: the noneq step traces source-parallel (its
    # quadrature_noneq deposits), within 1e-12 of the one-device step; the
    # domain tracer raises naming its ROADMAP item
    mesh = tmesh.make_grid_mesh(2, device="cpu")
    state = rt.uniform_state(n, dtype=torch.float64, device="cpu")
    one = model.make_noneq_step(MYR, tc, n_substeps=2)(state, species)
    two = model.make_noneq_step(MYR, tc, n_substeps=2, mesh=mesh)(
        tmesh.shard_state(state, mesh), tmesh.shard_species(species, mesh))
    _assert_species_close(two[1], one[1], 1e-12)
    _assert_peak_close(two[0].HI, one[0].HI, 1e-12, "HI")
    model.config = dataclasses.replace(model.config, tracer_strategy="domain")
    with pytest.raises(NotImplementedError,
                       match="rays_domain.*ROADMAP, Distribution"):
        model.make_noneq_step(MYR, tc, mesh=mesh)
    # tracer_compact is ignored by the noneq step's trace, as in the JAX
    # package: the step builds and traces with the default tracer
    model.config = dataclasses.replace(model.config, tracer_compact=True,
                                       tracer_strategy="sources")
    trays.LAST_COMPACT_BUCKETS.clear()
    model.make_noneq_step(MYR, tc, n_substeps=2)(
        rt.uniform_state(n, dtype=torch.float64, device="cpu"), species)
    assert trays.LAST_COMPACT_BUCKETS == []
    with pytest.raises(ValueError, match="do not divide"):
        tmesh.shard_species(species, tmesh.make_grid_mesh(3, device="cpu"))
    # a StellarContext built without noneq=True has no k27..k31 weights
    model.config = dataclasses.replace(model.config, tracer_compact=False)
    plain = dataclasses.replace(tc, tables={
        k: v for k, v in tc.tables.items() if k != "quad_W27"})
    with pytest.raises(KeyError, match="quad_W27"):
        model.make_noneq_step(MYR, plain)(
            rt.uniform_state(n, dtype=torch.float64, device="cpu"), species)


# ---------------------------------------------------------------------------
# The species in snapshots
# ---------------------------------------------------------------------------


def _snapshot_pair(tmp_path, writer, with_species=True):
    n = 6
    f = {k: v[:n, :n, :n] for k, v in _fields().items()}
    js = jstate.make_state(**f, dtype=jnp.float64)
    ts = rt.make_state(**f, dtype=torch.float64, device="cpu")
    j_sp = jcn.species_from_field_state(js, f_h2=1e-4, f_hm=1e-7)
    t_sp = tcn.species_from_field_state(ts, f_h2=1e-4, f_hm=1e-7)
    path = str(tmp_path / f"cellArray0001_{writer}.npz")
    if writer == "jax":
        jsnap.write_snapshot(path, js, 1, 1e23, extra=(
            jsnap.species_extra(j_sp) if with_species else None))
    else:
        tsnap.write_snapshot(path, ts, 1, 1e23, extra=(
            tsnap.species_extra(t_sp) if with_species else None))
    return path, js, ts, j_sp, t_sp


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_species_snapshot_across_packages(tmp_path, writer):
    path, js, ts, j_sp, t_sp = _snapshot_pair(tmp_path, writer)
    assert tsnap.SPECIES_FIELDS == jsnap.SPECIES_FIELDS
    # blank templates (no H2): what is read must be the file's
    t_back = tsnap.read_species(path, tcn.species_from_field_state(ts))
    j_back = jsnap.read_species(path, jcn.species_from_field_state(js))
    for k in tsnap.SPECIES_FIELDS:
        want = np.asarray(getattr(j_sp, k))
        np.testing.assert_array_equal(getattr(t_back, k).numpy(), want, k)
        np.testing.assert_array_equal(np.asarray(getattr(j_back, k)), want,
                                      k)
    assert t_back.HI.dtype == torch.float64
    assert float(t_back.H2I.max()) > 0.0
    # an equilibrium restart reads the fields and ignores the species
    t_state, itime = tsnap.read_snapshot(path, ts)
    assert itime == 1
    np.testing.assert_array_equal(t_state.HI.numpy(),
                                  np.asarray(js.HI, np.float32))
    # the file's keys are the JAX package's, in its order
    with np.load(path) as fh:
        keys = list(fh.keys())
    other = str(tmp_path / "other.npz")
    if writer == "jax":
        tsnap.write_snapshot(other, ts, 1, 1e23,
                             extra=tsnap.species_extra(t_sp))
    else:
        jsnap.write_snapshot(other, js, 1, 1e23,
                             extra=jsnap.species_extra(j_sp))
    with np.load(other) as fh:
        assert list(fh.keys()) == keys


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_species_absent_is_none(tmp_path, writer):
    path, js, ts, _, _ = _snapshot_pair(tmp_path, writer, with_species=False)
    assert tsnap.read_species(path, tcn.species_from_field_state(ts)) is None
    assert jsnap.read_species(path, jcn.species_from_field_state(js)) is None


def test_species_that_do_not_fit_raise(tmp_path):
    path, _, ts, _, t_sp = _snapshot_pair(tmp_path, "torch")
    small = tcn.species_from_field_state(
        rt.uniform_state(4, dtype=torch.float64, device="cpu"))
    with pytest.raises(ValueError, match="species0_HI has shape"):
        tsnap.read_species(path, small)
    extra = tsnap.species_extra(t_sp)
    del extra["species0_eint"]
    partial = str(tmp_path / "partial.npz")
    tsnap.write_snapshot(partial, ts, 1, 1e23, extra=extra)
    with pytest.raises(ValueError, match="incomplete"):
        tsnap.read_species(partial, t_sp)
