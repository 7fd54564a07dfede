"""PyTorch port, the two-level AMR iteration (core/step_amr.py::AMRModel)
and its snapshots against the JAX package's, on the CPU.

AMRModel in modes 9 and 6 at n = 6, and in modes 8 and 1 (point sources
through core/rays_amr.py) at n = 8, angular level 1, float64: 3 steps from
the same state within 1e-9 of each field's peak, the ray diagnostics
within 1e-9 of theirs (n = 8 keeps the JAX tracer's float32 cell faces
exact on the 16^3 fine grid); an unrefined two-level
step equals the port's uniform step (1e-10, as tests/test_step_amr.py
holds the JAX package's); the neutral fraction; the two-level snapshot
written by either package restarts the other, and a snapshot of another
refinement map raises; the port's AMR modules import no JAX."""

import dataclasses
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import radiativetransfer_tpu_torch as rt
from radiativetransfer_tpu.core import amr as jamr
from radiativetransfer_tpu.core import rays as jrays
from radiativetransfer_tpu.core import state as jstate
from radiativetransfer_tpu.core import step as jstep
from radiativetransfer_tpu.core import step_amr as jstep_amr
from radiativetransfer_tpu.io import snapshot as jsnap
from radiativetransfer_tpu.tables import stellar as jstellar
from radiativetransfer_tpu_torch.config import (
    MODE_BOTH_STELLAR_UVB_TRANSFER,
    MODE_NO_STARS_THIN_UVB,
    MODE_STELLAR_TRANSFER_THIN_UVB,
    MODE_UVB_TRANSFER_ONLY,
    RunConfig,
)
from radiativetransfer_tpu_torch.constants import KPC, MH, MYR, PSI
from radiativetransfer_tpu_torch.core import amr as tamr
from radiativetransfer_tpu_torch.core import rays as trays
from radiativetransfer_tpu_torch.core import step_amr as tstep_amr
from radiativetransfer_tpu_torch.io import snapshot as tsnap
from radiativetransfer_tpu_torch.parallel.mesh import (
    make_grid_mesh,
    shard_amr_state,
)
from radiativetransfer_tpu_torch.tables import stellar as tstellar
from test_torch_host import jax_compile_cache

N = 6
F64 = torch.float64
_FIELDS = ("HI", "HeI", "HeII", "tgas", "Jmean", "rho")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the eager sweep is ~10^5 small CPU ops a step,
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


def _cfg(mode):
    return RunConfig(mode=mode, current_redshift=6.55, n_angular_level=1,
                     reionization_model=10, self_shielding_threshold_kpc=0.1)


def _models(mode, box_kpc=300.0, n=N):
    geom = rt.GridGeometry(n, n, n, box_kpc * KPC)
    jm = jstep.RTModel.setup(_cfg(mode), geom, dtype=jnp.float64)
    tm = rt.RTModel.setup(_cfg(mode), geom, F64, "cpu")
    return (jstep_amr.AMRModel.setup(jm), tstep_amr.AMRModel.setup(tm))


def _np_fields(fs) -> dict:
    return {f.name: (None if getattr(fs, f.name) is None
                     else np.asarray(getattr(fs, f.name)))
            for f in dataclasses.fields(fs)}


def _states(seed=7, n=N):
    """The same two-level state in both packages: a lognormal base
    (partly ionized), a refined block, fine fields off the prolongation."""
    rng = np.random.default_rng(seed)
    nh = 2e-3 * rng.lognormal(0.0, 1.0, (n, n, n))
    base = jstate.make_state(nh * MH / PSI, np.full(nh.shape, 1.2e4),
                             0.6 * nh, vel=rng.normal(0.0, 30.0, (3, n, n, n)),
                             dtype=jnp.float64)
    refined = np.zeros((n, n, n), bool)
    refined[1:4, 2:5, 0:3] = True
    js = jamr.make_amr_state(base, jnp.asarray(refined))
    nh_f = np.asarray(js.fine.nh) * rng.lognormal(0.0, 0.3, (2 * n,) * 3)
    js = dataclasses.replace(js, fine=dataclasses.replace(
        js.fine, rho=jnp.asarray(nh_f * MH / PSI),
        HI=jnp.asarray(0.6 * nh_f),
        HeI=jnp.asarray(np.asarray(js.fine.HeI) * nh_f
                        / np.asarray(js.fine.nh))))
    js = jamr.sync_restriction(js)
    ts = tamr.AMRState.from_numpy(
        {"base": _np_fields(js.base), "fine": _np_fields(js.fine),
         "refined": refined}, dtype=F64, device="cpu")
    return js, ts


def _worst(t_fs, j_fs, names=_FIELDS) -> float:
    """Largest |port - JAX| over each field's peak (a field that is 0 on
    the JAX side, as Jmean in mode 6, must be 0 on the port's)."""
    worst = 0.0
    for name in names:
        a = getattr(t_fs, name).numpy()
        b = np.asarray(getattr(j_fs, name))
        peak = np.abs(b).max()
        if peak == 0:
            assert not a.any(), name
            continue
        worst = max(worst, float(np.abs(a - b).max() / peak))
    return worst


def _contexts(geom):
    """Both packages' StellarContext on the same blackbody population and
    3 sources: inside the refined block, in the coarse cell beside it, and
    on the coarse side far from it."""
    pos = np.array([[2.3, 3.6, 1.2], [0.5, 3.5, 1.5], [6.5, 5.5, 6.5]])
    pos /= geom.nx
    ctx = []
    for mod, stellar, kw in ((jrays, jstellar, {}),
                             (trays, tstellar, dict(dtype=F64,
                                                    device="cpu"))):
        batch = mod.SourceBatch(position=pos, weight=np.array([1.0, 2.0, 1.0]),
                                table_idx=np.zeros(3, np.int32))
        build = (jstep if mod is jrays else rt).StellarContext.build
        ctx.append(build(stellar.blackbody_population(q_ionizing=1e51), batch,
                         geom, 10.0 * MYR, metal_coefs=[(0, 0.0)],
                         max_pixel_level=3, **kw))
    return ctx


@pytest.mark.parametrize("mode", [MODE_UVB_TRANSFER_ONLY,
                                  MODE_NO_STARS_THIN_UVB,
                                  MODE_BOTH_STELLAR_UVB_TRANSFER,
                                  MODE_STELLAR_TRANSFER_THIN_UVB])
def test_amr_steps_match_jax_f64(mode):
    # the point-source modes at n = 8, where JAX's float32 faces are exact
    n = 8 if mode in (MODE_BOTH_STELLAR_UVB_TRANSFER,
                      MODE_STELLAR_TRANSFER_THIN_UVB) else N
    jam, tam = _models(mode, n=n)
    assert (tam.plan is None) == (jam.plan is None)
    assert tam.fine_geom == rt.GridGeometry(2 * n, 2 * n, 2 * n,
                                            300.0 * KPC)
    js, ts = _states(n=n)
    stars = tam.rt.config.run_stellar_transfer
    jctx, tctx = _contexts(tam.rt.geom) if stars else (None, None)
    jstep_fn, tstep_fn = jam.make_step(jctx), tam.make_step(tctx)
    for _ in range(3):
        js, ts = jstep_fn(js), tstep_fn(ts)
        if stars:
            (js, jdiag), (ts, tdiag) = js, ts
            for f in dataclasses.fields(jdiag):
                a = getattr(tdiag, f.name).numpy()
                b = np.asarray(getattr(jdiag, f.name))
                assert np.abs(a - b).max() <= 1e-9 * np.abs(b).max(), f.name
            assert float(ts.fine.krate24.sum()) > 0.0
            assert float(ts.base.krate24.sum()) > 0.0
        assert _worst(ts.base, js.base) <= 1e-9
        assert _worst(ts.fine, js.fine) <= 1e-9
        assert tam.neutral_fraction(ts) == pytest.approx(
            jam.neutral_fraction(js), rel=1e-9)
    # the base holds the restriction of the fine leaves under refined cells
    r = ts.refined.numpy()
    np.testing.assert_array_equal(ts.base.HI.numpy()[r],
                                  tamr.restrict(ts.fine.HI).numpy()[r])


def test_unrefined_amr_step_equals_uniform_step():
    tm = rt.RTModel.setup(_cfg(MODE_UVB_TRANSFER_ONLY),
                          rt.GridGeometry(N, N, N, 300.0 * KPC), F64, "cpu")
    tam = tstep_amr.AMRModel.setup(tm)
    base = rt.uniform_state(N, nh=2e-3, tgas=1e4, dtype=F64, device="cpu")
    out_amr = tam.make_step()(tamr.make_amr_state(
        base, torch.zeros((N, N, N), dtype=torch.bool)))
    out_uni = tm.make_step()(base)
    for name in ("HI", "Jmean"):
        np.testing.assert_allclose(getattr(out_amr.base, name).numpy(),
                                   getattr(out_uni, name).numpy(),
                                   rtol=1e-10, err_msg=name)
    assert tam.neutral_fraction(out_amr) == pytest.approx(
        tm.neutral_fraction(out_uni), rel=1e-10)


def test_neutral_fraction():
    jam, tam = _models(MODE_UVB_TRANSFER_ONLY)
    js, ts = _states(seed=3)
    r = ts.refined.numpy()
    rf = tamr.prolong_mask(ts.refined).numpy()
    hi = (ts.base.HI.numpy()[~r].sum() + ts.fine.HI.numpy()[rf].sum() / 8)
    nh = (ts.base.nh.numpy()[~r].sum() + ts.fine.nh.numpy()[rf].sum() / 8)
    nf = tam.neutral_fraction(ts)
    assert nf == pytest.approx(hi / nh, rel=1e-14)
    assert nf == pytest.approx(jam.neutral_fraction(js), rel=1e-14)
    # float32 fields, summed in float64
    f32 = tamr.AMRState.from_numpy(ts.to_numpy(), dtype=torch.float32,
                                   device="cpu")
    assert tam.neutral_fraction(f32) == pytest.approx(nf, rel=1e-6)


@pytest.fixture(scope="module")
def stepped():
    """One mode-9 step of each package from the same state."""
    jam, tam = _models(MODE_UVB_TRANSFER_ONLY)
    js, ts = _states()
    return jam.make_step()(js), tam.make_step()(ts)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_amr_snapshot_restarts_across_packages(tmp_path, stepped, writer):
    """The snapshot of one package's stepped state, read back onto a fresh
    (unstepped) state by both."""
    js, ts = stepped
    path = str(tmp_path / "cellArray0001.npz")
    if writer == "jax":
        jsnap.write_snapshot_amr(path, js, 1, 300.0 * KPC)
    else:
        tsnap.write_snapshot_amr(path, ts, 1, 300.0 * KPC)
    fresh_j, fresh_t = _states()
    # the written files: the same keys and arrays from either package
    other = str(tmp_path / "other.npz")
    if writer == "jax":
        tsnap.write_snapshot_amr(other, ts, 1, 300.0 * KPC)
    else:
        jsnap.write_snapshot_amr(other, js, 1, 300.0 * KPC)
    with np.load(path) as fa, np.load(other) as fb:
        assert list(fa.keys()) == list(fb.keys())
        assert {"refined", "level", "HI", "velx"} - set(fa.keys()) == set()
        for k in fa:
            a, b = fa[k], fb[k]
            assert a.dtype == b.dtype, k
            if a.dtype.kind == "f" and a.ndim:
                assert a.dtype == np.float32, k
                np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=k)
            else:
                np.testing.assert_array_equal(a, b, err_msg=k)
    back_t, it_t = tsnap.read_snapshot_amr(path, fresh_t)
    back_j, it_j = jsnap.read_snapshot_amr(path, fresh_j)
    assert it_t == it_j == 1
    names = ("HI", "HeI", "HeII", "tgas", "vel")
    for level in ("base", "fine"):
        for name in names:
            a = getattr(getattr(back_t, level), name).numpy()
            b = np.asarray(getattr(getattr(back_j, level), name))
            np.testing.assert_array_equal(a, b, err_msg=f"{level}.{name}")
    # the leaves as written, within float32's rounding of the stepped state
    rf = tamr.prolong_mask(ts.refined).numpy()
    np.testing.assert_allclose(back_t.fine.HI.numpy()[rf],
                               np.asarray(js.fine.HI)[rf], rtol=1e-6)


@pytest.mark.parametrize("reader", ["jax", "torch"])
def test_amr_snapshot_of_another_map_raises(tmp_path, stepped, reader):
    path = str(tmp_path / "cellArray0001.npz")
    tsnap.write_snapshot_amr(path, stepped[1], 1, 300.0 * KPC)
    other = np.zeros((N, N, N), bool)
    other[0, 0, 0] = True
    fresh_j, fresh_t = _states()
    fresh_t = dataclasses.replace(fresh_t, refined=torch.tensor(other))
    fresh_j = dataclasses.replace(fresh_j, refined=jnp.asarray(other))
    with pytest.raises(ValueError, match="refinement map differs"):
        if reader == "torch":
            tsnap.read_snapshot_amr(path, fresh_t)
        else:
            jsnap.read_snapshot_amr(path, fresh_j)


def test_mesh_raises_naming_roadmap():
    """The two-level model on a 1-D mesh (mesh.shard_amr_state): mode 8
    through make_step and step, the tracer source-parallel (3 sources
    padded to 4 over 2 ranks) and the rest as on one device, within 1e-12
    of the one-device step; the domain tracer still raises naming its
    ROADMAP item."""
    _, tam = _models(MODE_BOTH_STELLAR_UVB_TRANSFER)
    _, ts = _states()
    _, tc = _contexts(tam.rt.geom)
    mesh = make_grid_mesh(2, device="cpu")
    one, _ = tam.make_step(tc)(ts)
    sharded = shard_amr_state(ts, mesh)
    for call in (lambda: tam.make_step(tc, mesh=mesh)(sharded),
                 lambda: tam.step(sharded, stellar=tc, mesh=mesh)):
        out, diag = call()
        assert _worst(out.base, one.base) <= 1e-12
        assert _worst(out.fine, one.fine) <= 1e-12
        assert diag.ndot_remaining.shape[0] == 3
    base = tam.rt.config
    tam.rt.config = dataclasses.replace(base, tracer_strategy="domain")
    try:
        with pytest.raises(NotImplementedError,
                           match=r"rays_domain.*ROADMAP, Distribution"):
            tam.make_step(tc, mesh=mesh)
    finally:
        tam.rt.config = base


@pytest.mark.parametrize("module", [
    "radiativetransfer_tpu_torch.core.amr",
    "radiativetransfer_tpu_torch.core.rays_amr",
    "radiativetransfer_tpu_torch.core.sweep_amr",
    "radiativetransfer_tpu_torch.core.step_amr",
    "radiativetransfer_tpu_torch.io.sfc",
    "radiativetransfer_tpu_torch.cli",
])
def test_amr_modules_import_no_jax(module):
    code = (f"import {module}, sys\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert 'radiativetransfer_tpu' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], check=True)

