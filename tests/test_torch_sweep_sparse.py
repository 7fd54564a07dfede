"""PyTorch port, the block-sparse L-level sweep (core/sweep_sparse.py) and
SparseMLModel (core/step_amr.py) against the JAX package's, on the CPU,
in float64.

On clustered 3-level states made from a seed with NumPy (8^3 with be 8,
16^3 with be 4, and 16^3 with two clumps whose windows move between
slabs), angular level 1: the full-plane sparse sweep within 1e-12 of each
level's leaf peak of the JAX package's sparse sweep and of the port's
dense L-level sweep; compute_window gives the JAX package's W and starts
in all 24 rotations (W = 12 < 16 at the 16^3 bases), every slab's window
covering the refinement of that slab and the slab before; the windowed
sweep (the fine carries translated where the window moves) within 1e-13
of the full-plane one and 1e-12 of the JAX package's windowed sweep; the mode-9 and mode-6 steps within 1e-10 of
the JAX package's SparseMLModel (and the windowed mode-9 step of the
port's dense MultiLevelModel's), the padding blocks zero after the
chemistry; validate_coupling_depth adopts the JAX package's depth; the
mode-8 step and a mode-1 noneq step (three sources) within 1e-10 of the
port's dense L-level steps; a mesh raises NotImplementedError naming its
ROADMAP item.  The JAX runs are shared through module fixtures."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiativetransfer_tpu.config import (
    MODE_BOTH_STELLAR_UVB_TRANSFER,
    MODE_NO_STARS_THIN_UVB,
    MODE_UVB_TRANSFER_ONLY,
    RunConfig,
)
from radiativetransfer_tpu.constants import KPC
from radiativetransfer_tpu.core import amr as jamr
from radiativetransfer_tpu.core import amr_sparse as jas
from radiativetransfer_tpu.core import step as jstep
from radiativetransfer_tpu.core import step_amr as jstep_amr
from radiativetransfer_tpu.core import sweep_multilevel as jsm
from radiativetransfer_tpu.core import sweep_sparse as jss
from radiativetransfer_tpu.core.state import GridGeometry as JGeom
from radiativetransfer_tpu.geometry.octants import rotate_to_sweep
from radiativetransfer_tpu_torch import RTModel
from radiativetransfer_tpu_torch import RunConfig as TConfig
from radiativetransfer_tpu_torch.core import amr as tamr
from radiativetransfer_tpu_torch.core import amr_sparse as tas
from radiativetransfer_tpu_torch.core import step_amr as tstep_amr
from radiativetransfer_tpu_torch.core import sweep_multilevel as tsm
from radiativetransfer_tpu_torch.core import sweep_sparse as tss
from radiativetransfer_tpu_torch.core.state import GridGeometry
from test_torch_amr_sparse import (
    _rand_state,
    clustered_ml,
    jax_sparse_np,
    port_ml,
)
from test_torch_host import jax_compile_cache

F64 = torch.float64
UVB = np.array([2e-21, 5e-22, 1e-23])
CELL = 3.0e21
CASES = {8: (8, (0.5, 0.5, 0.5)), 16: (4, (0.28, 0.55, 0.4))}


def two_clumps_ml(n=16, L=3, seed=5):
    """A JAX MultiLevelState with two small clumps of refinement, near
    (1/4, 1/4, 1/4) and (7/10, 7/10, 7/10) of the box: in most rotations
    the slabs of one clump have their window where the other's have not,
    so the window moves."""
    rng = np.random.default_rng(seed)
    refined, m = [], n
    for _ in range(L - 1):
        r = np.zeros((m,) * 3, bool)
        for off in ((0.25, 0.25, 0.25), (0.7, 0.7, 0.7)):
            c = (np.array(off) * m).astype(int)
            r[c[0] - 1:c[0] + 1, c[1] - 1:c[1] + 1, c[2] - 1:c[2] + 1] = \
                rng.random((2, 2, 2)) < 0.8
        refined.append(r)
        m *= 2
    refined = jamr.enforce_balance(refined)
    cov = np.ones((n,) * 3, bool)
    for ell in range(L - 1):
        refined[ell] &= cov
        cov = np.repeat(np.repeat(np.repeat(refined[ell], 2, 0), 2, 1), 2, 2)
    ml = jamr.make_multilevel_state(
        _rand_state(rng, n), refined,
        [_rand_state(rng, n * 2 ** (ell + 1)) for ell in range(L - 1)])
    return jamr.sync_restriction_multi(ml), refined


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


@pytest.fixture(scope="module")
def sweeps():
    """{case: (JAX sparse state, port state, refined maps, opacities
    (dense levels), port block opacities, the window, {windowed: JAX (j0,
    jbs)})}: the JAX package's full-plane sweep at both clustered bases,
    its windowed one at 16^3 and on the two clumps ("moving")."""
    _PORT_SWEEPS.clear()
    out = {}
    for key, (be, off) in [*CASES.items(), ("moving", (4, None))]:
        n = 16 if key == "moving" else key
        ml, refined = (two_clumps_ml(n) if key == "moving"
                       else clustered_ml(n, seed=3 * n, off=off))
        jsp = jas.sparse_from_dense(ml, be=be)
        tsp = tas.SparseMLState.from_numpy(jax_sparse_np(jsp), dtype=F64,
                                           device="cpu")
        rng = np.random.default_rng(11)
        kappas = [rng.lognormal(0, 0.7, (3,) + (n * 2 ** ell,) * 3) / 3e21
                  for ell in range(3)]
        jlv = [jas.blockify_like(jsp.levels[e], kappas[e + 1])
               for e in range(2)]
        plan = jsm.build_ml_sweep_plan(1, n, 3)
        win = jss.compute_window(jsp)
        runs = {}
        for w in {8: (None,), 16: (None, win), "moving": (win,)}[key]:
            runs[w is not None] = jss.diffuse_sweep_sparse(
                jnp.asarray(kappas[0]), jlv, jsp, plan, jnp.asarray(UVB),
                CELL, n_coupling_iters=4, window=w)
        out[key] = (jsp, tsp, refined, kappas,
                    [torch.as_tensor(np.array(k)) for k in jlv], win, runs)
    return out


def _port_sweep(case, window):
    """The port's sparse sweep of a `sweeps` case, full-plane (window
    None) or windowed, each computed once for the module (the cases share
    them; the tests do not change them)."""
    jsp, tsp, refined, kappas, tlv, win, _ = case
    key = (id(case[1]), window is not None)
    if key not in _PORT_SWEEPS:
        plan = tsm.build_ml_sweep_plan(1, tsp.n, 3)
        _PORT_SWEEPS[key] = tss.diffuse_sweep_sparse(
            torch.as_tensor(kappas[0]), tlv, tsp, plan, UVB, CELL,
            n_coupling_iters=4, window=window)
    return _PORT_SWEEPS[key]


_PORT_SWEEPS: dict = {}


def _leaf_err(tsp, got, want) -> float:
    """The largest leaf |got - want| over the leaf peak of want, level by
    level: got/want (j0 (3, n, n, n), [J blocks])."""
    (g0, gb), (w0, wb) = got, want
    leaf0 = ~tsp.refined0.numpy()
    g0, w0 = np.asarray(g0), np.asarray(w0)
    err = np.abs(g0 - w0)[:, leaf0].max() / np.abs(w0)[:, leaf0].max()
    for lv, a, b in zip(tsp.levels, gb, wb):
        leaf = (lv.cover & ~lv.refined).numpy()
        a, b = np.asarray(a)[:, leaf], np.asarray(b)[:, leaf]
        err = max(err, np.abs(a - b).max() / np.abs(b).max())
    return float(err)


class TestSparseSweepParity:
    @pytest.mark.parametrize("n", [8, 16])
    def test_matches_jax_sparse_sweep(self, sweeps, n):
        case = sweeps[n]
        got = _port_sweep(case, None)
        assert _leaf_err(case[1], got, case[6][False]) <= 1e-12

    @pytest.mark.parametrize("n", [8, 16])
    def test_matches_port_dense_sweep(self, sweeps, n):
        jsp, tsp, refined, kappas, *_ = case = sweeps[n]
        j0, jbs = _port_sweep(case, None)
        js = tsm.diffuse_sweep_multilevel(
            [torch.as_tensor(k) for k in kappas],
            [torch.as_tensor(r) for r in refined],
            tsm.build_ml_sweep_plan(1, n, 3), UVB, CELL, 4)
        dense = [js[0]] + [tas.blockify_like(lv, j) for lv, j in
                           zip(tsp.levels, js[1:])]
        assert _leaf_err(tsp, (j0, jbs), (dense[0], dense[1:])) <= 1e-12


class TestWindowedSweep:
    def test_window_matches_jax(self, sweeps):
        for key in (8, 16, "moving"):
            jsp, tsp, *_, win, _ = sweeps[key]
            got = tss.compute_window(tsp)
            if win is None:
                assert got is None
                continue
            assert got[0] == win[0] == 12 < tsp.n
            assert sorted(got[1]) == sorted(win[1]) == list(range(1, 25))
            for iz in win[1]:
                np.testing.assert_array_equal(got[1][iz], win[1][iz])

    @pytest.mark.parametrize("key", [16, "moving"])
    def test_window_covers_refinement(self, sweeps, key):
        jsp, tsp, *_ = sweeps[key]
        W, starts = tss.compute_window(tsp)
        n = tsp.n
        r0 = tsp.refined0.numpy()
        for iz, st in starts.items():
            assert np.all(st % tsp.be == 0) and np.all(st >= 0)
            assert np.all(st + W <= n)
            rot = rotate_to_sweep(r0, iz)
            u = rot.copy()
            u[1:] |= rot[:-1]
            for i in range(n):
                if u[i].any():
                    iy, iz2 = np.nonzero(u[i])
                    assert st[i, 0] <= iy.min() and st[i, 0] + W > iy.max()
                    assert st[i, 1] <= iz2.min() and st[i, 1] + W > iz2.max()

    @pytest.mark.parametrize("key", [16, "moving"])
    def test_windowed_matches_full_plane_and_jax(self, sweeps, key):
        case = sweeps[key]
        tsp = case[1]
        moves = sum(int(np.any(st[1:] != st[:-1], axis=1).sum())
                    for st in case[5][1].values())
        assert (moves > 0) == (key == "moving"), moves
        full = _port_sweep(case, None)
        windowed = _port_sweep(case, tss.compute_window(tsp))
        np.testing.assert_allclose(windowed[0].numpy(), full[0].numpy(),
                                   rtol=1e-13, atol=1e-300)
        for lv, a, b in zip(tsp.levels, windowed[1], full[1]):
            cov = lv.cover.numpy()
            np.testing.assert_allclose(a.numpy()[:, cov], b.numpy()[:, cov],
                                       rtol=1e-13, atol=1e-300)
        assert _leaf_err(tsp, windowed, case[6][True]) <= 1e-12


def _models(n, mode, pkg):
    if pkg == "jax":
        cfg = RunConfig(mode=mode, current_redshift=6.55, n_angular_level=1,
                        reionization_model=10, grid="sparse")
        rt = jstep.RTModel.setup(cfg, JGeom(n, n, n, 300.0 * KPC),
                                 dtype=jnp.float64)
        return (jstep_amr.MultiLevelModel.setup(rt, 3),
                jstep_amr.SparseMLModel.setup(rt, 3))
    cfg = TConfig(mode=mode, current_redshift=6.55, n_angular_level=1,
                  reionization_model=10, grid="sparse")
    rt = RTModel.setup(cfg, GridGeometry(n, n, n, 300.0 * KPC), F64, "cpu")
    return (tstep_amr.MultiLevelModel.setup(rt, 3),
            tstep_amr.SparseMLModel.setup(rt, 3))


@pytest.fixture(scope="module")
def steps():
    """{mode: (JAX sparse state, the JAX package's SparseMLModel step from
    it, JAX neutral fraction)} at the 8^3 base, and the JAX package's
    validated coupling depth."""
    ml, _ = clustered_ml(8, seed=21, scale=1e-5)
    jsp = jas.sparse_from_dense(ml, be=8)
    out = {}
    for mode in (MODE_UVB_TRANSFER_ONLY, MODE_NO_STARS_THIN_UVB):
        _, sparse = _models(8, mode, "jax")
        s1 = sparse.make_step()(jsp)
        out[mode] = (jsp, s1, sparse.neutral_fraction(s1))
    _, sparse = _models(8, MODE_UVB_TRANSFER_ONLY, "jax")
    out["depth"] = sparse.validate_coupling_depth(jsp, tol=1e-8,
                                                  max_iters=6)
    return out


def _assert_state_close(t, j, rtol):
    pairs = [(t.base, j.base)] + [(a.fields, b.fields)
                                  for a, b in zip(t.levels, j.levels)]
    for a, b in pairs:
        for name in ("HI", "HeI", "HeII", "Jmean", "tgas"):
            x, y = getattr(a, name).numpy(), np.asarray(getattr(b, name))
            peak = max(float(np.abs(y).max()), 1e-300)
            assert np.abs(x - y).max() <= rtol * peak, name


class TestSparseStepParity:
    @pytest.mark.parametrize("mode", [MODE_UVB_TRANSFER_ONLY,
                                      MODE_NO_STARS_THIN_UVB])
    def test_step_matches_jax(self, steps, mode):
        jsp, j1, nf_j = steps[mode]
        _, sparse = _models(8, mode, "torch")
        assert (sparse.plan is None) == (mode == MODE_NO_STARS_THIN_UVB)
        tsp = tas.SparseMLState.from_numpy(jax_sparse_np(jsp), dtype=F64,
                                           device="cpu")
        t1 = sparse.make_step(split_compile=True)(tsp)
        _assert_state_close(t1, j1, 1e-10)
        assert sparse.neutral_fraction(t1) == pytest.approx(nf_j, rel=1e-10)
        for ell, lv in enumerate(t1.levels, start=1):
            pad = lv.pad_mask(8 * 2 ** ell)
            for name in ("HI", "HeI", "HeII", "Jmean", "hydroHeating"):
                x = getattr(lv.fields, name)
                assert bool(torch.isfinite(x).all()), name
                assert float(x[..., pad, :, :, :].abs().max()) == 0.0, name

    def test_windowed_step_matches_dense(self):
        """The windowed sparse mode-9 step against the port's dense
        L-level step from the same state: another storage and stack
        shape."""
        ml, _ = clustered_ml(16, seed=31, off=CASES[16][1])
        dense, sparse = _models(16, MODE_UVB_TRANSFER_ONLY, "torch")
        rt = dense.rt
        tml = port_ml(ml)
        tml = tamr.sync_restriction_multi(tamr.MultiLevelState(
            levels=tuple(rt.initialize_equilibrium(lv) for lv in tml.levels),
            refined=tml.refined))
        tsp = tas.sparse_from_dense(tml, be=4)
        out_d = dense.make_step()(tml)
        out_s = sparse.make_step()(tsp)
        assert sparse._window is not None and sparse._window[0] == 12
        back = tas.dense_from_sparse(out_s)
        cover = tamr.cover_masks(tml.refined, tml.levels[0].shape, "cpu")
        for a, b, c in zip(back.levels, out_d.levels, cover):
            for name in ("HI", "HeII", "Jmean"):
                x, y = getattr(a, name), getattr(b, name)
                m = c.expand_as(x)
                assert float((x[m] - y[m]).abs().max()) <= 1e-10 * float(
                    y[m].abs().max()), name
        assert sparse.neutral_fraction(out_s) == pytest.approx(
            dense.neutral_fraction(out_d), rel=1e-10)


class TestCouplingDepthProduction:
    def test_sparse_model_adopts_jax_depth(self, steps):
        jsp = steps[MODE_UVB_TRANSFER_ONLY][0]
        _, sparse = _models(8, MODE_UVB_TRANSFER_ONLY, "torch")
        tsp = tas.SparseMLState.from_numpy(jax_sparse_np(jsp), dtype=F64,
                                           device="cpu")
        d = sparse.validate_coupling_depth(tsp, tol=1e-8, max_iters=6)
        assert d == steps["depth"] and 1 <= d <= 6
        assert sparse.n_coupling_iters == d


@pytest.mark.parametrize("what", ["stellar", "mesh", "noneq"])
def test_unported_parts_raise(what):
    """The point sources, the noneq step and the mesh, which raised until
    they were ported, run: the mode-8 step (make_step with a
    StellarContext; on a 2-rank mesh too, mesh.shard_sparse_state's state:
    the zones sweep and the source-parallel tracer) and a mode-1 noneq
    step (three sources, 1 Myr, 10 substeps) on block-sparse storage
    against the port's dense L-level steps from the same state
    (which test_torch_step_ml and test_torch_noneq_ml hold to the JAX
    package's; test_torch_noneq_sparse and test_torch_cli_sparse hold the
    block-sparse ones to it): every level's HI, HeII and krate24 (and the
    species) on covered cells within 1e-10 of their peak, ndot_remaining
    within 1e-10."""
    from radiativetransfer_tpu_torch import StellarContext
    from radiativetransfer_tpu_torch.config import (
        MODE_STELLAR_TRANSFER_THIN_UVB,
    )
    from radiativetransfer_tpu_torch.constants import MYR
    from radiativetransfer_tpu_torch.core import chemistry_noneq as tcn
    from radiativetransfer_tpu_torch.core import rays as trays
    from radiativetransfer_tpu_torch.tables import stellar as tstellar
    from radiativetransfer_tpu_torch.parallel import mesh as tmesh
    mode = (MODE_STELLAR_TRANSFER_THIN_UVB if what == "noneq"
            else MODE_BOTH_STELLAR_UVB_TRANSFER)
    dense, sparse = _models(8, mode, "torch")
    rt = dense.rt
    tml = port_ml(clustered_ml(8, seed=21, scale=1e-5)[0])
    tml = tamr.sync_restriction_multi(tamr.MultiLevelState(
        levels=tuple(rt.initialize_equilibrium(lv) for lv in tml.levels),
        refined=tml.refined))
    tsp = tas.sparse_from_dense(tml, be=8)
    pos = np.random.default_rng(2).uniform(0.3, 0.7, (3, 3))
    ctx = StellarContext.build(
        tstellar.blackbody_population(), trays.SourceBatch(
            position=pos, weight=np.ones(3),
            table_idx=np.zeros(3, np.int32)), rt.geom, 10.0 * MYR,
        metal_coefs=[(0, 0.0)], max_pixel_level=3, noneq=what == "noneq",
        dtype=F64, device="cpu")
    cover = tamr.cover_masks(tml.refined, tml.levels[0].shape, "cpu")
    if what != "noneq":
        mesh = tmesh.make_grid_mesh(2, device="cpu") if what == "mesh" \
            else None
        (out_d, diag_d), (out_s, diag_s) = (
            dense.make_step(ctx)(tml), sparse.make_step(ctx, mesh=mesh)(
                tsp if mesh is None else tmesh.shard_sparse_state(tsp, mesh)))
        pairs = []
    else:
        out_d, sp_d, diag_d = dense.make_noneq_step(
            MYR, ctx, n_substeps=10)(tml, tuple(
                tcn.species_from_field_state(lv) for lv in tml.levels))
        out_s, sp_s, diag_s = sparse.make_noneq_step(
            MYR, ctx, n_substeps=10)(tsp, sparse.initial_species(tsp))
        pairs = [(getattr(a, k) if ell == 0 else torch.as_tensor(
            tas.unblockify_like(out_s.levels[ell - 1], getattr(a, k))),
                  getattr(b, k), c)
                 for ell, (a, b, c) in enumerate(zip(sp_s, sp_d, cover))
                 for k in ("HI", "HII", "H2I")]
    back = tas.dense_from_sparse(out_s)
    pairs += [(getattr(a, k), getattr(b, k), c.expand_as(getattr(a, k)))
              for a, b, c in zip(back.levels, out_d.levels, cover)
              for k in ("HI", "HeII", "krate24")]
    pairs.append((diag_s.ndot_remaining, diag_d.ndot_remaining, None))
    for a, b, m in pairs:
        if m is not None:
            a, b = a[m], b[m]
        peak = float(b.abs().max())
        assert peak > 0.0 and float((a - b).abs().max()) <= 1e-10 * peak
    assert float(out_s.levels[-1].fields.krate24.max()) > 0.0
