"""PyTorch port, the compacting tracer (rays.trace_point_sources_compact)
and RTModel.make_step under tracer_compact, against the JAX package's.

The inputs are the JAX package's tests/test_rays.py::TestCompactTracer's:
three sources at cell centres from seed 0, maxPixelLevel 4, chunk 8, f64,
quadrature, a 300 kpc box.  The six channels and the three diagnostics
agree within 1e-12 of each field's peak: the port's compacting tracer with
the JAX package's at 16^3, and with the port's own default tracer at 16^3
and 24^3 (only the scatter order differs).  At 24^3 the two packages'
tracers differ by ~1e-7 of the peak, the JAX tracer's float32 cell faces
in a float64 run (ROADMAP section 3); at power-of-two widths they agree
to ~1e-15.  A chunk of 2 steps shrinks the ray buffer at least twice.
make_step with tracer_compact in mode 8 at 8^3, f64, 11 sources at
maxPixelLevel 3: the fields within 1e-10 of each peak of the
JAX package's.  The JAX traces are shared through a module fixture."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiativetransfer_tpu.config import RunConfig as JConfig
from radiativetransfer_tpu.core import rays as jrays
from radiativetransfer_tpu.core import step as jstep
from radiativetransfer_tpu.core.state import GridGeometry as JGeom
from radiativetransfer_tpu.core.state import uniform_state as juniform
from radiativetransfer_tpu.tables import stellar as jstellar
from radiativetransfer_tpu_torch.config import RunConfig
from radiativetransfer_tpu_torch.constants import KPC, MYR
from radiativetransfer_tpu_torch.core import rays as trays
from radiativetransfer_tpu_torch.core import step as tstep
from radiativetransfer_tpu_torch.core.state import GridGeometry, uniform_state
from radiativetransfer_tpu_torch.tables import stellar as tstellar
from test_torch_host import jax_compile_cache

CHANNELS = ("krate24", "krate25", "krate26", "crate24", "crate25",
            "crate26")
DIAGS = ("ndot_remaining", "ndot_boundary", "ndot_spectrum")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
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


def _inputs(n):
    """TestCompactTracer's tables, sources and state at width n (NumPy
    tables; the port's and the JAX package's sources)."""
    pop = jstellar.blackbody_population(temperature=1.0e5, q_ionizing=5.0e48)
    t = jstellar.build_source_tables(pop, 0, 0.0, 0, 0.0)
    cell = 300.0 * KPC / n
    quad_a, quad_w = jstellar.quadrature_arrays(pop, 0, 0.0, 0, 0.0)
    tables = {"quad_A": np.asarray(quad_a),
              "quad_W": np.asarray(quad_w / np.exp(np.log(cell) * 3))[None],
              "output_freq": t.output_freq,
              "output_sigma24": t.output_sigma24,
              "output_sigma25": t.output_sigma25,
              "output_sigma26": t.output_sigma26,
              "output_sigma_dust": t.output_sigma_dust}
    pos = (np.floor(np.random.default_rng(0).uniform(0.3, 0.7, (3, 3)) * n)
           + 0.5) / n
    src = dict(position=pos, weight=np.ones(3),
               table_idx=np.zeros(3, np.int32))
    return tables, src


def _port_trace(n, compact=True, rates_mode="quadrature", **kw):
    tables, src = _inputs(n)
    tracer = (trays.trace_point_sources_compact if compact
              else trays.trace_point_sources)
    return tracer(uniform_state(n, nh=2e-4, tgas=1.5e4, dtype=torch.float64,
                                device="cpu"),
                  GridGeometry(n, n, n, 300.0 * KPC),
                  trays.SourceBatch(**src), tables, max_pixel_level=4,
                  dtype=torch.float64, rates_mode=rates_mode, **kw)


def _jax_trace(n):
    """The JAX package's compacting trace at width n (chunk 8)."""
    tables, src = _inputs(n)
    return jrays.trace_point_sources_compact(
        juniform(n, nh=2e-4, tgas=1.5e4, dtype=jnp.float64),
        JGeom(n, n, n, 300.0 * KPC), jrays.SourceBatch(**src),
        {k: jnp.asarray(v) for k, v in tables.items()},
        max_pixel_level=4, dtype=jnp.float64, rates_mode="quadrature",
        chunk=8)


def _assert_traces_close(got, want, rel):
    (rf_a, dg_a), (rf_b, dg_b) = got, want
    for names, a_obj, b_obj in ((CHANNELS, rf_a, rf_b), (DIAGS, dg_a, dg_b)):
        for f in names:
            a = np.asarray(getattr(a_obj, f))
            b = np.asarray(getattr(b_obj, f))
            sc = np.abs(b).max()
            if sc == 0.0:
                assert np.abs(a).max() == 0.0, f
            else:
                assert np.abs(a - b).max() <= rel * sc, (f, np.abs(a - b)
                                                         .max() / sc)


def test_compact_matches_jax():
    n = 16
    _assert_traces_close(_port_trace(n, chunk=8), _jax_trace(n), 1e-12)
    # the final phase's 3 x 768 rays, compacted below 2048 and to the 1024
    # floor as they die
    assert trays.LAST_COMPACT_BUCKETS == [2304, 2048, 1024]


@pytest.mark.parametrize("n", [16, 24])
def test_compact_matches_default_tracer(n):
    _assert_traces_close(_port_trace(n, chunk=8),
                         _port_trace(n, compact=False), 1e-12)


def test_small_chunks_shrink_the_bucket_twice():
    got = _port_trace(16, chunk=2)
    buckets = list(trays.LAST_COMPACT_BUCKETS)
    assert len(buckets) >= 3 and buckets == sorted(buckets, reverse=True)
    _assert_traces_close(got, _port_trace(16, compact=False), 1e-12)


def test_bucket_size_and_bad_arguments():
    assert [trays._bucket_size(c) for c in (1, 1024, 1025, 2048, 2049)] == [
        1024, 1024, 2048, 2048, 4096]
    assert trays._bucket_size(3, floor=2) == 4
    with pytest.raises(ValueError, match="chunk must be positive"):
        _port_trace(8, chunk=0)
    with pytest.raises(ValueError, match="unknown rates_mode"):
        _port_trace(8, rates_mode="other")


def test_make_step_tracer_compact_matches_jax():
    n = 8
    pos = np.random.default_rng(0).uniform(0.2, 0.8, (11, 3))
    batch = dict(position=pos, weight=np.ones(11),
                 table_idx=np.zeros(11, np.int32))
    kw = dict(mode=8, current_redshift=6.55, n_angular_level=1,
              reionization_model=10, tracer_compact=True)
    jgeom = JGeom(n, n, n, 200.0 * KPC)
    jctx = jstep.StellarContext.build(
        jstellar.blackbody_population(), jrays.SourceBatch(**batch), jgeom,
        10.0 * MYR, metal_coefs=[(0, 0.0)], max_pixel_level=3)
    jm = jstep.RTModel.setup(JConfig(**kw), jgeom, dtype=jnp.float64)
    js, jdiag = jm.make_step(jctx)(juniform(n, nh=1e-4, tgas=2e4,
                                            dtype=jnp.float64))
    geom = GridGeometry(n, n, n, 200.0 * KPC)
    tctx = tstep.StellarContext.build(
        tstellar.blackbody_population(), trays.SourceBatch(**batch), geom,
        10.0 * MYR, metal_coefs=[(0, 0.0)], max_pixel_level=3,
        dtype=torch.float64, device="cpu")
    tm = tstep.RTModel.setup(RunConfig(**kw), geom, torch.float64, "cpu")
    ts, tdiag = tm.make_step(tctx)(uniform_state(
        n, nh=1e-4, tgas=2e4, dtype=torch.float64, device="cpu"))
    # the compacting tracer ran: 11 x 192 final-phase rays, every one out
    # of the 8^3 box within its first chunk of 16 steps
    assert trays.LAST_COMPACT_BUCKETS == [11 * 192]
    for name in ("HI", "HeI", "HeII", "tgas", "Jmean", *CHANNELS):
        a = getattr(ts, name).numpy()
        b = np.asarray(getattr(js, name))
        peak = np.abs(b).max()
        assert peak > 0.0 or name in ("krate25", "crate25"), name
        assert np.abs(a - b).max() <= 1e-10 * max(peak, 1e-300), name
    for f in dataclasses.fields(jdiag):
        b = np.asarray(getattr(jdiag, f.name))
        a = getattr(tdiag, f.name).numpy()
        assert np.abs(a - b).max() <= 1e-10 * max(np.abs(b).max(), 1e-300)
