"""PyTorch port, the L-level AMR sweep (core/sweep_multilevel.py) against
the JAX package's on the CPU, in float64.

The plan's template chains equal JAX's; the sweep on 3 levels at n = 4,
angular level 1, on lognormal opacities drawn level by level and two
random nested maps (30% of the base refined, 30% of those children again,
balanced with enforce_balance: refinement chains on both pairs of levels)
is within 1e-12 of each level's peak on leaf cells at 1 and 4 coupling
passes (the first pass has no finer estimate, later ones read the previous
pass's finer planes: an off-by-one-pass error shows at both depths); at
6 passes it matches the serial oracle of the reference's recursive
transport (tests/reference_impl.py::serial_sweep_multilevel) within 1e-9,
seeds 0 and 1, as tests/test_sweep_multilevel.py holds JAX's.  One level
equals the port's uniform sweep; two levels equal the port's two-level
sweep (diffuse_sweep_amr) once both have converged.  coupling_residual at
depth 1 is within 1e-6 of JAX's, and pick_coupling_iters returns JAX's
depth (JAX's own functions, run on its compiled sweeps).  Also: the zone
batches' gather of a finer plane's children against a loop, their tables
against one zone's, and the sweep's independence of the batch size."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiativetransfer_tpu.core import sweep_multilevel as jsm
from radiativetransfer_tpu_torch.core import amr as tamr
from radiativetransfer_tpu_torch.core import sweep as tsweep
from radiativetransfer_tpu_torch.core import sweep_amr as tsa
from radiativetransfer_tpu_torch.core import sweep_multilevel as tsm

sys.path.insert(0, os.path.dirname(__file__))
from reference_impl import serial_sweep_multilevel  # noqa: E402
from test_torch_host import jax_compile_cache

N = 4
UVB = np.array([2e-21, 5e-22, 1e-23])
CELL = 3.0e21


@pytest.fixture(autouse=True)
def _one_thread():
    """The eager sweep's small ops run as fast on one intra-op thread as on
    eight, with an eighth of the CPU time beside the other workers."""
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


def _kappa(n, seed):
    rng = np.random.default_rng(seed)
    return rng.lognormal(0.0, 0.7, (3, n, n, n)) / 3.0e21


def _maps(n, levels, seed, frac=0.3):
    """Random nested maps: frac of the base refined, frac of the covered
    children of each level refined again, then balanced."""
    rng = np.random.default_rng(seed)
    refined = [rng.random((n,) * 3) < frac]
    for _ in range(levels - 2):
        cov = np.repeat(np.repeat(np.repeat(refined[-1], 2, 0), 2, 1), 2, 2)
        refined.append(cov & (rng.random(cov.shape) < frac))
    refined = tamr.enforce_balance(refined)
    assert tamr.check_balance(refined)
    return refined


def _case(seed, n=N, levels=3):
    return ([_kappa(n * 2 ** ell, 10 * seed + ell) for ell in range(levels)],
            _maps(n, levels, seed))


def _port(kappas, refined, iters, plan=None):
    plan = plan or tsm.build_ml_sweep_plan(1, kappas[0].shape[1],
                                           len(kappas))
    js = tsm.diffuse_sweep_multilevel(
        [torch.tensor(k) for k in kappas], [torch.tensor(r) for r in refined],
        plan, UVB, CELL, iters)
    return [j.numpy() for j in js]


def _leaves(refined, n):
    return [m.numpy() for m in tamr.leaf_masks(
        [torch.tensor(r) for r in refined], (n,) * 3, "cpu")]


def _worst(js, ref, leaf) -> float:
    """The largest leaf-cell |a - b| over each level's peak of b."""
    out = 0.0
    for a, b, m in zip(js, ref, leaf):
        assert m.any()
        peak = float(np.abs(b[:, m]).max())
        out = max(out, float(np.abs(a[:, m] - b[:, m]).max()) / peak)
    return out


@pytest.fixture(scope="module")
def jax_sweeps():
    """JAX's compiled 3-level sweep at n = 4, one per coupling depth,
    compiled on first use."""
    plan = jsm.build_ml_sweep_plan(1, N, 3)
    sweep = jsm.diffuse_sweep_multilevel
    cache = {}

    def run(kappas, refined, iters):
        if iters not in cache:
            cache[iters] = jax.jit(lambda ks, rs, uvb, cell: sweep(
                ks, rs, plan, uvb, cell, iters))
        return [np.asarray(j) for j in cache[iters](
            [jnp.asarray(k) for k in kappas],
            [jnp.asarray(r) for r in refined], jnp.asarray(UVB), CELL)]
    return run


def test_plan_matches_jax():
    for level, n, levels in ((1, 4, 3), (2, 3, 2)):
        tp = tsm.build_ml_sweep_plan(level, n, levels)
        jp = jsm.build_ml_sweep_plan(level, n, levels)
        assert (tp.n_directions, tp.nslab, tp.n_levels, tp.weight) == (
            jp.n_directions, jp.nslab, jp.n_levels, jp.weight)
        assert len(tp.zones) == len(jp.zones)
        for a, b in zip(tp.zones, jp.zones):
            assert (a.izone, a.ndir) == (b.izone, b.ndir)
            for pa, pb in zip(a.params, b.params):
                assert pa.keys() == pb.keys()
                for k in pb:
                    assert pa[k].dtype == pb[k].dtype, k
                    np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)


@pytest.mark.parametrize("iters", [1, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_sweep_matches_jax_f64(jax_sweeps, seed, iters):
    kappas, refined = _case(seed)
    js = _port(kappas, refined, iters)
    ref = jax_sweeps(kappas, refined, iters)
    leaf = _leaves(refined, N)
    assert _worst(js, ref, leaf) <= 1e-12
    # J on leaf cells only
    for j, m in zip(js, leaf):
        assert not j[:, ~m].any() and np.all(j[:, m] > 0)


@pytest.mark.parametrize("seed", [0, 1])
def test_sweep_matches_serial_oracle(seed):
    kappas, refined = _case(seed)
    js = _port(kappas, refined, 6)
    ref = serial_sweep_multilevel(kappas, refined, 1, UVB, CELL)
    for a, b, m in zip(js, ref, _leaves(refined, N)):
        np.testing.assert_allclose(a * m[None], b * m[None], rtol=1e-9,
                                   atol=1e-30)


def test_one_level_is_the_uniform_sweep():
    n = 6
    kap = _kappa(n, 0)
    ju = tsweep.diffuse_sweep(torch.tensor(kap), tsweep.build_sweep_plan(
        1, n), UVB, CELL).numpy()
    (jm,) = _port([kap], [], 4)
    assert np.abs(jm - ju).max() <= 1e-12 * np.abs(ju).max()


def test_two_levels_are_the_two_level_sweep():
    """Converged (from 2 passes on for this map), the L-level sweep gives
    the two-level sweep's J on leaf cells; at 1 pass the coarse side reads
    of refined neighbours are still missing."""
    n = 6
    kappas, refined = _case(0, n=n, levels=2)
    jc, jf = (j.numpy() for j in tsa.diffuse_sweep_amr(
        torch.tensor(kappas[0]), torch.tensor(kappas[1]),
        torch.tensor(refined[0]), tsa.build_amr_sweep_plan(1, n), UVB, CELL))
    leaf = _leaves(refined, n)
    for iters, tol in ((4, 1e-12), (1, None)):
        js = _port(kappas, refined, iters)
        err = _worst(js, [jc, jf], leaf)
        if tol is None:
            assert err > 1e-3
        else:
            assert err <= tol


@pytest.fixture
def jax_uses_compiled_sweeps(jax_sweeps, monkeypatch):
    """JAX's coupling_residual and pick_coupling_iters on its compiled
    sweeps (its own call each runs the scans uncompiled, ~5 s a sweep)."""
    def sweep(kappas, refined, plan, uvb, cell_size, n_coupling_iters=4):
        assert plan.nslab == N and cell_size == CELL
        return jax_sweeps([np.asarray(k) for k in kappas],
                          [np.asarray(r) for r in refined], n_coupling_iters)
    monkeypatch.setattr(jsm, "diffuse_sweep_multilevel", sweep)


def test_coupling_residual_and_depth_match_jax(jax_uses_compiled_sweeps):
    kappas, refined = _case(1)
    tplan = tsm.build_ml_sweep_plan(1, N, 3)
    jplan = jsm.build_ml_sweep_plan(1, N, 3)
    t_args = ([torch.tensor(k) for k in kappas],
              [torch.tensor(r) for r in refined], tplan, UVB, CELL)
    j_args = ([jnp.asarray(k) for k in kappas],
              [jnp.asarray(r) for r in refined], jplan, jnp.asarray(UVB),
              CELL)
    r_t = tsm.coupling_residual(*t_args, 1)
    r_j = jsm.coupling_residual(*j_args, 1)
    assert r_j > 1e-6 and abs(r_t - r_j) <= 1e-6 * r_j
    depth = jsm.pick_coupling_iters(*j_args, tol=1e-7)
    assert 1 < depth < 12
    assert tsm.pick_coupling_iters(*t_args, tol=1e-7) == depth
    assert tsm.coupling_residual(*t_args, depth) < 1e-7


def test_batch_gather_and_tables():
    """The zone batch's flattened child gather against a loop over zones
    and directions (PyTorch moves the separated advanced indices to the
    front, as NumPy does), and a batch's tables against each zone's."""
    rng = np.random.default_rng(0)
    Z, D, a, b = 3, 2, 4, 6
    plane = torch.tensor(rng.normal(size=(Z, D, 3, 2 * a, 2 * b)))
    cj = torch.tensor(rng.integers(0, 2, Z * D))
    ck = torch.tensor(rng.integers(0, 2, Z * D))
    out = tsa._sel_child(plane.reshape(Z * D, 3, 2 * a, 2 * b),
                         torch.arange(Z * D), cj, ck).reshape(Z, D, 3, a, b)
    assert out.shape == (Z, D, 3, a, b)
    for z in range(Z):
        for d in range(D):
            i = z * D + d
            ref = plane[z, d].reshape(3, a, 2, b, 2)[:, :, cj[i], :, ck[i]]
            assert torch.equal(out[z, d], ref)
    plan = tsm.build_ml_sweep_plan(2, 4, 3)
    zones = [z for z in plan.zones if z.ndir == 2][:3]
    for ell in range(3):
        batch = tsm._batch_tables(zones, ell, CELL, torch.float64, "cpu")
        for i, zone in enumerate(zones):
            one = tsa._slab_tables(zone.params[ell], CELL / 2 ** ell,
                                   torch.float64, "cpu")
            for k, v in one.items():
                if isinstance(v, tuple):
                    for x, y in zip(batch[k], v):
                        assert torch.equal(x[:, i], y), k
                elif v.dim() == 2:
                    assert torch.equal(batch[k][:, i * 2:(i + 1) * 2], v), k
                else:
                    assert torch.equal(batch[k][:, i], v), k


def test_batch_size_does_not_change_the_sweep(monkeypatch):
    kappas, refined = _case(0)
    plan = tsm.build_ml_sweep_plan(2, N, 3)
    whole = _port(kappas, refined, 2, plan)
    monkeypatch.setattr(tsm, "_zones_per_batch", lambda *a: 1)
    one = _port(kappas, refined, 2, plan)
    for a, b in zip(whole, one):
        np.testing.assert_array_equal(a, b)
