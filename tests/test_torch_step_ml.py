"""PyTorch port, the L-level AMR iteration (core/step_amr.py::
MultiLevelModel) and its snapshots against the JAX package's, on the CPU.

MultiLevelModel in modes 9 and 6 on 3 levels at n = 4, angular level 1,
float64: 2 steps from the same state (a lognormal base, the refined
levels' densities drawn on their own, nested balanced maps with
refinement chains) within 1e-10 of each field's peak on every level, and
the neutral fraction within 1e-10; modes 8 and 1 with three sources
(maxPixelLevel 3) within 1e-9, the deposits and the ray diagnostics too;
MultiLevelModel(2) against the port's
AMRModel on a two-level state; the L-level snapshot written by either
package restarts the other (the files key for key and dtype for dtype,
the floats within 1e-10 of each peak; the restored states within 1e-10),
and a snapshot of another depth or refinement raises; each level's
9-species state written beside the fields (species_extra's prefix
`species{l}`) by either package reads back in the other exactly (the
tuple form of read_species), and an incomplete or mis-shaped one raises;
the mesh raises naming its ROADMAP item."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import radiativetransfer_tpu_torch as rt
from radiativetransfer_tpu.core import amr as jamr
from radiativetransfer_tpu.core import chemistry_noneq as jcn
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
from radiativetransfer_tpu_torch.core import chemistry_noneq as tcn
from radiativetransfer_tpu_torch.core import rays as trays
from radiativetransfer_tpu_torch.core import step_amr as tstep_amr
from radiativetransfer_tpu_torch.io import snapshot as tsnap
from radiativetransfer_tpu_torch.parallel.mesh import (
    make_grid_mesh,
    shard_multilevel_state,
)
from radiativetransfer_tpu_torch.tables import stellar as tstellar
from test_torch_host import jax_compile_cache

N = 4
F64 = torch.float64
_FIELDS = ("HI", "HeI", "HeII", "tgas", "Jmean", "rho")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the eager sweep is ~10^4 small CPU ops a step,
    on which more threads only spin beside the other test workers (the
    module's fixture too)."""
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


def _rt(mode, n=N):
    geom = rt.GridGeometry(n, n, n, 300.0 * KPC)
    return (jstep.RTModel.setup(_cfg(mode), geom, dtype=jnp.float64),
            rt.RTModel.setup(_cfg(mode), geom, F64, "cpu"))


def _np_fields(fs) -> dict:
    return {f.name: (None if getattr(fs, f.name) is None
                     else np.asarray(getattr(fs, f.name)))
            for f in dataclasses.fields(fs)}


def _maps(n, levels, seed=2):
    rng = np.random.default_rng(seed)
    refined = [rng.random((n,) * 3) < 0.3]
    for _ in range(levels - 2):
        cov = np.repeat(np.repeat(np.repeat(refined[-1], 2, 0), 2, 1), 2, 2)
        refined.append(cov & (rng.random(cov.shape) < 0.3))
    return tamr.enforce_balance(refined)


def _states(n=N, levels=3, seed=7):
    """The same L-level state in both packages: a lognormal base (partly
    ionized), each refined level's density drawn on its own over its
    parents', synced."""
    rng = np.random.default_rng(seed)
    nh = 2e-3 * rng.lognormal(0.0, 1.0, (n, n, n))
    base = jstate.make_state(nh * MH / PSI, np.full(nh.shape, 1.2e4),
                             0.6 * nh, vel=rng.normal(0.0, 30.0, (3, n, n, n)),
                             dtype=jnp.float64)
    refined = _maps(n, levels)
    js = jamr.make_multilevel_state(base, refined)
    lv = list(js.levels)
    for ell in range(1, levels):
        nh_l = np.asarray(lv[ell].nh) * rng.lognormal(0.0, 0.3,
                                                      lv[ell].rho.shape)
        lv[ell] = dataclasses.replace(
            lv[ell], rho=jnp.asarray(nh_l * MH / PSI),
            HI=jnp.asarray(0.6 * nh_l),
            HeI=jnp.asarray(np.asarray(lv[ell].HeI) * nh_l
                            / np.asarray(lv[ell].nh)))
    js = jamr.sync_restriction_multi(jamr.MultiLevelState(
        levels=tuple(lv), refined=js.refined))
    ts = tamr.MultiLevelState.from_numpy(
        {"levels": [_np_fields(x) for x in js.levels],
         "refined": refined}, dtype=F64, device="cpu")
    return js, ts


def _worst(t_state, j_state, names=_FIELDS) -> float:
    """Largest |port - JAX| over each field's peak, every level (a field
    that is 0 on the JAX side, as Jmean in mode 6, must be 0 on the
    port's)."""
    worst = 0.0
    for t_fs, j_fs in zip(t_state.levels, j_state.levels):
        for name in names:
            a = getattr(t_fs, name).numpy()
            b = np.asarray(getattr(j_fs, name))
            peak = np.abs(b).max()
            if peak == 0:
                assert not a.any(), name
                continue
            worst = max(worst, float(np.abs(a - b).max() / peak))
    return worst


@pytest.mark.parametrize("mode", [MODE_UVB_TRANSFER_ONLY,
                                  MODE_NO_STARS_THIN_UVB])
def test_ml_steps_match_jax_f64(mode):
    jrt, trt = _rt(mode)
    jml = jstep_amr.MultiLevelModel.setup(jrt, 3)
    tml = tstep_amr.MultiLevelModel.setup(trt, 3)
    assert (tml.plan is None) == (jml.plan is None)
    assert tml.n_coupling_iters == jml.n_coupling_iters == 4
    assert tml.level_geom(2) == rt.GridGeometry(4 * N, 4 * N, 4 * N,
                                                 300.0 * KPC)
    js, ts = _states()
    assert [int(r.sum()) for r in ts.refined] == [49, 47]
    nf0 = tml.neutral_fraction(ts)
    assert abs(nf0 - jml.neutral_fraction(js)) <= 1e-12 * nf0
    jstep_fn, tstep_fn = jml.make_step(), tml.make_step()
    for _ in range(2):
        js, ts = jstep_fn(js), tstep_fn(ts)
        assert _worst(ts, js) <= 1e-10
    nf_t, nf_j = tml.neutral_fraction(ts), jml.neutral_fraction(js)
    assert abs(nf_t - nf_j) <= 1e-10 * nf_j and abs(nf_t - nf0) > 1e-3
    # the restriction holds on both pairs of levels after a step
    for ell in range(2):
        r = ts.refined[ell]
        assert torch.equal(ts.levels[ell].HI[r],
                           tamr.restrict(ts.levels[ell + 1].HI)[r])
    if mode == MODE_UVB_TRANSFER_ONLY:
        for lv, m in zip(ts.levels, ts.leaf_masks()):
            assert bool((lv.Jmean[:, m] > 0).any())


@pytest.mark.parametrize("mode", [MODE_BOTH_STELLAR_UVB_TRANSFER,
                                  MODE_STELLAR_TRANSFER_THIN_UVB])
def test_ml_point_source_steps_match_jax_f64(mode):
    """Modes 8 and 1: three sources (one in a doubly refined cell) in two
    SED buckets, as the CLI builds them (StellarContext.build, the tables
    over the base cell's volume), 2 steps: every level's fields and the
    deposits (level l's times 8^l) within 1e-9 of each peak, the ray
    diagnostics too."""
    jrt, trt = _rt(mode)
    jml = jstep_amr.MultiLevelModel.setup(jrt, 3)
    tml = tstep_amr.MultiLevelModel.setup(trt, 3)
    assert (tml.plan is None) == (mode == MODE_STELLAR_TRANSFER_THIN_UVB)
    src = dict(position=np.array([[0.5 + 0.25 / N, 0.5 + 0.75 / N,
                                   0.5 + 0.25 / N], [0.3, 0.47, 0.55],
                                  [0.81, 0.2, 0.5]]),
               weight=np.array([4.0, 2.0, 1.0]),
               table_idx=np.array([0, 1, 0], np.int32))
    args = (10.0 * MYR,)
    kw = dict(metal_coefs=[(0, 0.0), (1, 0.0)], max_pixel_level=3)
    jc = jstep.StellarContext.build(
        jstellar.blackbody_population(n_metal=3), jrays.SourceBatch(**src),
        jrt.geom, *args, **kw)
    tc = rt.StellarContext.build(
        tstellar.blackbody_population(n_metal=3), trays.SourceBatch(**src),
        trt.geom, *args, dtype=F64, device="cpu", **kw)
    js, ts = _states()
    jstep_fn, tstep_fn = jml.make_step(jc), tml.make_step(tc)
    for _ in range(2):
        (js, jdiag), (ts, tdiag) = jstep_fn(js), tstep_fn(ts)
        assert _worst(ts, js, ("HI", "HeI", "HeII", "tgas", "krate24",
                               "krate26", "crate24")) <= 1e-9
        for f in dataclasses.fields(jdiag):
            a, b = getattr(tdiag, f.name).numpy(), np.asarray(
                getattr(jdiag, f.name))
            assert np.abs(a - b).max() <= 1e-9 * np.abs(b).max(), f.name
    assert all(float(lv.krate24.max()) > 0.0 for lv in ts.levels)
    nf_t, nf_j = tml.neutral_fraction(ts), jml.neutral_fraction(js)
    assert abs(nf_t - nf_j) <= 1e-9 * nf_j
    # step() traces only in a point-source mode, with a context
    s_ctx, diag = tml.step(ts, tc)
    assert diag is not None and _worst(s_ctx, tml.make_step(tc)(ts)[0],
                                       ("HI",)) == 0.0


def test_two_levels_match_amr_model():
    """MultiLevelModel(2) gives the port's AMRModel step: the L-level
    sweep at its 4 passes and the two-level sweep at its 3 agree once
    converged (2 passes on this map), and the rest is the same."""
    _, trt = _rt(MODE_UVB_TRANSFER_ONLY, n=6)
    _, ts = _states(n=6, levels=2)
    am = tstep_amr.AMRModel.setup(trt)
    ml = tstep_amr.MultiLevelModel.setup(trt, 2)
    s2 = am.make_step()(tamr.two_level_view(ts))
    sm = ml.make_step()(ts)
    leaf = sm.leaf_masks()
    for name in _FIELDS:
        for lv, (a, b) in enumerate(((sm.levels[0], s2.base),
                                     (sm.levels[1], s2.fine))):
            x, y = getattr(a, name), getattr(b, name)
            if name == "Jmean":
                x, y = x[:, leaf[lv]], y[:, leaf[lv]]
            assert float((x - y).abs().max()) <= 1e-12 * float(
                y.abs().max()), (name, lv)
    assert abs(ml.neutral_fraction(sm) - am.neutral_fraction(s2)) <= (
        1e-12 * am.neutral_fraction(s2))


@pytest.fixture(scope="module")
def stepped():
    """Both packages' 3-level state after one mode-9 step."""
    jrt, trt = _rt(MODE_UVB_TRANSFER_ONLY)
    js, ts = _states()
    js = jstep_amr.MultiLevelModel.setup(jrt, 3).make_step()(js)
    ts = tstep_amr.MultiLevelModel.setup(trt, 3).make_step()(ts)
    return js, ts, trt.geom


def _assert_files_close(path_t, path_j):
    with np.load(path_t) as ft, np.load(path_j) as fj:
        assert list(ft.keys()) == list(fj.keys())
        for k in fj:
            a, b = ft[k], fj[k]
            assert a.dtype == b.dtype, k
            if a.dtype.kind == "f" and a.ndim:
                assert np.abs(a - b).max() <= 1e-10 * np.abs(b).max(), k
            else:
                np.testing.assert_array_equal(a, b, err_msg=k)


def test_snapshots_match_and_restart_across_packages(stepped, tmp_path):
    js, ts, geom = stepped
    pt, pj = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tsnap.write_snapshot_ml(pt, ts, 3, geom.physical_box_size)
    jsnap.write_snapshot_ml(pj, js, 3, geom.physical_box_size)
    _assert_files_close(pt, pj)
    with np.load(pt) as f:
        assert int(f["n_levels"]) == 3
        assert len(f["level"]) == ts.n_leaves()
        assert f["refined_1"].dtype == np.uint8
    # each package restarts from the other's file onto the state before
    # the step (the grid rebuilt from the same inputs)
    j0, t0 = _states()
    restored_t, it_t = tsnap.read_snapshot_ml(pj, t0)
    restored_j, it_j = jsnap.read_snapshot_ml(pt, j0)
    assert it_t == it_j == 3
    assert _worst(restored_t, restored_j, ("HI", "HeI", "HeII", "tgas",
                                           "rho")) <= 1e-10
    # the leaves came from the snapshot, the rest from the fresh state
    for lv, (a, b) in enumerate(zip(restored_t.levels, ts.levels)):
        m = ts.leaf_masks()[lv]
        assert float((a.HI[m] - b.HI[m]).abs().max()) <= 1e-6 * float(
            b.HI[m].abs().max())
        np.testing.assert_allclose(a.rho.numpy(), t0.levels[lv].rho.numpy(),
                                   rtol=1e-15, atol=0)
    assert restored_t.levels[0].vel is not None


def test_snapshot_of_another_grid_raises(stepped, tmp_path):
    js, ts, geom = stepped
    path = str(tmp_path / "c.npz")
    tsnap.write_snapshot_ml(path, ts, 1, geom.physical_box_size)
    _, two = _states(levels=2)
    with pytest.raises(ValueError, match="depth"):
        tsnap.read_snapshot_ml(path, two)
    flipped = dataclasses.replace(ts, refined=(
        ts.refined[0], ~ts.refined[1] & tamr.prolong(ts.refined[0])))
    with pytest.raises(ValueError, match="refinement maps differ"):
        tsnap.read_snapshot_ml(path, flipped)


def _species_extra(mod, species) -> dict:
    """One package's snapshot payload of a tuple of per-level species."""
    extra = {}
    for ell, spc in enumerate(species):
        extra.update(mod.species_extra(spc, prefix=f"species{ell}"))
    return extra


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_species_snapshots_across_packages(stepped, tmp_path, writer):
    js, ts, geom = stepped
    j_sp = tuple(jcn.species_from_field_state(lv, f_h2=1e-4)
                 for lv in js.levels)
    t_sp = tuple(tcn.species_from_field_state(lv, f_h2=1e-4)
                 for lv in ts.levels)
    path = str(tmp_path / "s.npz")
    if writer == "jax":
        jsnap.write_snapshot_ml(path, js, 2, geom.physical_box_size,
                                extra=_species_extra(jsnap, j_sp))
        got = tsnap.read_species(path, t_sp)
        got = [{k: getattr(sp, k).numpy() for k in tsnap.SPECIES_FIELDS}
               for sp in got]
    else:
        tsnap.write_snapshot_ml(path, ts, 2, geom.physical_box_size,
                                extra=_species_extra(tsnap, t_sp))
        got = jsnap.read_species(path, j_sp)
        got = [{k: np.asarray(getattr(sp, k)) for k in tsnap.SPECIES_FIELDS}
               for sp in got]
    # the writer's species, to the bit
    assert len(got) == 3
    for ell, sp in enumerate(j_sp if writer == "jax" else t_sp):
        for k in tsnap.SPECIES_FIELDS:
            np.testing.assert_array_equal(got[ell][k],
                                          np.asarray(getattr(sp, k)),
                                          err_msg=f"species{ell}_{k}")
    # the fields restart as from the file without species; one template
    # reads the base level's species
    plain = str(tmp_path / "plain.npz")
    tsnap.write_snapshot_ml(plain, ts, 2, geom.physical_box_size)
    restored, plain_restored = (tsnap.read_snapshot_ml(x, ts)
                                for x in (path, plain))
    assert restored[1] == plain_restored[1] == 2
    assert all(torch.equal(a.HI, b.HI) for a, b in zip(
        restored[0].levels, plain_restored[0].levels))
    base = tsnap.read_species(path, t_sp[0])
    np.testing.assert_array_equal(base.H2I.numpy(), got[0]["H2I"])


def test_species_snapshot_that_does_not_fit_raises(stepped, tmp_path):
    _, ts, geom = stepped
    t_sp = tuple(tcn.species_from_field_state(lv) for lv in ts.levels)
    path = str(tmp_path / "two.npz")
    tsnap.write_snapshot_ml(path, ts, 1, geom.physical_box_size,
                            extra=_species_extra(tsnap, t_sp[:2]))
    with pytest.raises(ValueError, match=r"incomplete, missing "
                       r"\['species2_H2I'"):
        tsnap.read_species(path, t_sp)
    with pytest.raises(ValueError, match=r"species1_HI has shape \(8, 8, "
                       r"8\), the grid is \(16, 16, 16\)"):
        tsnap.read_species(path, (t_sp[0], t_sp[2]))
    plain = str(tmp_path / "plain.npz")
    tsnap.write_snapshot_ml(plain, ts, 1, geom.physical_box_size)
    assert tsnap.read_species(plain, t_sp) is None


def test_sources_and_mesh_raise_naming_roadmap():
    """Point sources run on an L-level grid, on one device and on a 1-D
    mesh (mesh.shard_multilevel_state): mode 9 and mode 8 through
    make_step and step (the tracer source-parallel), and a noneq mode-9
    step, within 1e-12 of the one-device steps; the domain tracer on a
    mesh raises naming its ROADMAP item."""
    _, t8 = _rt(MODE_BOTH_STELLAR_UVB_TRANSFER)
    ml = tstep_amr.MultiLevelModel.setup(t8, 3)
    assert ml.plan is not None
    _, ts = _states()
    mesh = make_grid_mesh(2, device="cpu")
    sharded = shard_multilevel_state(ts, mesh)
    tc = rt.StellarContext.build(
        tstellar.blackbody_population(), trays.SourceBatch(
            position=np.array([[0.4, 0.55, 0.6], [0.7, 0.3, 0.45],
                               [0.52, 0.48, 0.51]]),
            weight=np.array([2.0, 1.0, 1.0]),
            table_idx=np.zeros(3, np.int32)),
        t8.geom, 10.0 * MYR, metal_coefs=[(0, 0.0)], max_pixel_level=2,
        dtype=F64, device="cpu")
    assert _worst(ml.make_step(mesh=mesh)(sharded), ml.make_step()(ts)) \
        <= 1e-12
    one, _ = ml.make_step(tc)(ts)
    for out, diag in (ml.make_step(stellar=tc, mesh=mesh)(sharded),
                      ml.step(sharded, stellar=tc, mesh=mesh)):
        assert _worst(out, one, _FIELDS + ("krate24", "crate26")) <= 1e-12
        assert diag.ndot_spectrum.shape[0] == 3
    species = tuple(tcn.species_from_field_state(lv)
                    for lv in ts.levels)
    st1, _ = ml.make_noneq_step(1.0e13, n_substeps=2)(ts, species)
    st2, _ = ml.make_noneq_step(1.0e13, n_substeps=2, mesh=mesh)(sharded,
                                                                species)
    assert _worst(st2, st1, ("HI", "HeII")) <= 1e-12
    base = ml.rt.config
    ml.rt.config = dataclasses.replace(base, tracer_strategy="domain")
    try:
        with pytest.raises(NotImplementedError,
                           match="rays_domain.*ROADMAP, Distribution$"):
            ml.step(ts, stellar=tc, mesh=mesh)
    finally:
        ml.rt.config = base
