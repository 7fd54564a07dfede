"""PyTorch port, L-level dense AMR storage (core/amr.py's MultiLevelState
and its helpers) against the JAX package's, on the CPU, in float64.

enforce_balance and check_balance (host NumPy) give the JAX package's maps
bit for bit on random 3- and 4-level maps; make_multilevel_state,
sync_restriction_multi (the velocity components too) and
multilevel_from_levels (make_test_data.py's galaxy with its refined centre
and core, n = 8 and 12, with and without metals and velocities, and under
--amr-depth 2 and 3 of a 4-level grid) give the same refinement maps and
fields within 1e-15 relative (bitwise where XLA's CPU reduce sums a
restriction's 8 children in the port's order); the cover and leaf masks
and the leaf count; two_level_view; the state's NumPy round trip."""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import make_test_data  # noqa: E402
from radiativetransfer_tpu.core import amr as jamr  # noqa: E402
from radiativetransfer_tpu.core import state as jstate  # noqa: E402
from radiativetransfer_tpu.io.grid_io import LevelData  # noqa: E402
from radiativetransfer_tpu_torch.core import amr as tamr  # noqa: E402
from radiativetransfer_tpu_torch.core.state import make_state  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the port's eager ops are small CPU ops, on
    which more threads only spin beside the other test workers (module-
    scoped, so that the module's fixtures run pinned too)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

F64 = torch.float64


def _random_maps(n: int, levels: int, seed: int, frac: float):
    """Unbalanced random maps, each level's drawn over its whole grid."""
    rng = np.random.default_rng(seed)
    return [rng.random((n * 2 ** ell,) * 3) < frac
            for ell in range(levels - 1)]


def _assert_close(a, b, err_msg=""):
    """Equal where both are 0, else within 1e-15 of b relative."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, err_msg
    np.testing.assert_allclose(a, b, rtol=1e-15, atol=0, err_msg=err_msg)


def _assert_ml_close(t_state, j_state) -> None:
    assert t_state.n_levels == j_state.n_levels
    for r_t, r_j in zip(t_state.refined, j_state.refined):
        assert r_t.dtype == torch.bool
        np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    for ell, (lt, lj) in enumerate(zip(t_state.levels, j_state.levels)):
        for f in dataclasses.fields(lt):
            a, b = getattr(lt, f.name), getattr(lj, f.name)
            assert (a is None) == (b is None), f.name
            if a is not None:
                _assert_close(a.numpy(), b, err_msg=f"level {ell} {f.name}")


@pytest.mark.parametrize("levels,seed", [(3, 0), (3, 1), (4, 2)])
def test_balance_bit_for_bit(levels, seed):
    maps = _random_maps(4, levels, seed, 0.05)
    ours, ref = tamr.enforce_balance(maps), jamr.enforce_balance(maps)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype == np.bool_
        np.testing.assert_array_equal(a, b)
    assert tamr.check_balance(ours) and jamr.check_balance(ref)
    assert tamr.check_balance(maps) == jamr.check_balance(maps)
    np.testing.assert_array_equal(tamr._dilate_faces(maps[-1]),
                                  jamr._dilate_faces(maps[-1]))
    np.testing.assert_array_equal(tamr.restrict_any(maps[-1]),
                                  jamr.restrict_any(maps[-1]))
    # a refined cell beside an unrefined coarse one two levels up breaks
    # the balance
    bad = [np.zeros((4,) * 3, bool), np.zeros((8,) * 3, bool)]
    bad[0][1, 1, 1] = True
    bad[1][2, 2, 2] = True
    assert not tamr.check_balance(bad) and not jamr.check_balance(bad)


def _base_fields(n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    nh = rng.lognormal(-6.0, 1.0, (n,) * 3)
    return dict(rho=nh * 2.3e-24, tgas=np.full(nh.shape, 1e4), HI=0.5 * nh,
                vel=rng.normal(0.0, 30.0, (3, n, n, n)))


def test_make_sync_and_masks_match_jax():
    n = 6
    refined = jamr.enforce_balance(_random_maps(n, 3, 5, 0.04))
    base = _base_fields(n, 3)
    t_st = tamr.make_multilevel_state(make_state(**base, dtype=F64,
                                                 device="cpu"), refined)
    j_st = jamr.make_multilevel_state(
        jstate.make_state(**base, dtype=jnp.float64), refined)
    _assert_ml_close(t_st, j_st)
    # each refined level's fields off the prolongation, then the
    # restriction of every level into its parents
    rng = np.random.default_rng(4)
    for ell in (1, 2):
        m = n * 2 ** ell
        hi = rng.lognormal(-7.0, 1.0, (m,) * 3)
        vel = rng.normal(0.0, 30.0, (3, m, m, m))
        jm = rng.normal(size=(3, m, m, m))
        t_st.levels = tuple(
            dataclasses.replace(lv, HI=torch.tensor(hi),
                                vel=torch.tensor(vel), Jmean=torch.tensor(jm))
            if i == ell else lv for i, lv in enumerate(t_st.levels))
        j_st = jamr.MultiLevelState(levels=tuple(
            dataclasses.replace(lv, HI=jnp.asarray(hi), vel=jnp.asarray(vel),
                                Jmean=jnp.asarray(jm))
            if i == ell else lv for i, lv in enumerate(j_st.levels)),
            refined=j_st.refined)
    t_sync = tamr.sync_restriction_multi(t_st)
    j_sync = jamr.sync_restriction_multi(j_st)
    _assert_ml_close(t_sync, j_sync)
    # the base's velocity under a refined parent is its children's mean
    r0 = t_sync.refined[0]
    assert not torch.equal(t_sync.levels[0].vel[:, r0],
                           t_st.levels[0].vel[:, r0])
    for t_m, j_m in zip(t_sync.cover_masks(), j_sync.cover_masks()):
        np.testing.assert_array_equal(t_m.numpy(), np.asarray(j_m))
    for t_m, j_m in zip(t_sync.leaf_masks(), j_sync.leaf_masks()):
        np.testing.assert_array_equal(t_m.numpy(), np.asarray(j_m))
    assert t_sync.n_leaves() == j_sync.n_leaves()
    assert t_sync.n == n and t_sync.n_levels == 3


@pytest.fixture(scope="module")
def galaxies(tmp_path_factory):
    """make_test_data's galaxy with its refined centre and core (3 data
    levels) at n = 8 and 12."""
    out = {}
    for n in (8, 12):
        path = str(tmp_path_factory.mktemp("grid") / f"grid{n}")
        out[n], _ = make_test_data.make_grid(n=n, refine_center=True,
                                             refine_core=True, path=path)
    return out


@pytest.mark.parametrize("n,read_metals,with_vel", [
    (8, True, True), (8, False, False), (12, True, False), (12, False, True)])
def test_multilevel_from_levels_matches_jax(galaxies, n, read_metals,
                                            with_vel):
    levels = [lv if with_vel else dataclasses.replace(lv, vel=None)
              for lv in galaxies[n]]
    t_state, t_geom = tamr.multilevel_from_levels(levels, read_metals,
                                                  dtype=F64, device="cpu")
    j_state, j_geom = jamr.multilevel_from_levels(levels, read_metals,
                                                  dtype=jnp.float64)
    assert dataclasses.astuple(t_geom) == dataclasses.astuple(j_geom)
    assert t_state.n_levels == 3
    assert (t_state.levels[2].vel is not None) == with_vel
    assert [int(r.sum()) for r in t_state.refined] == [
        int(np.asarray(r).sum()) for r in j_state.refined]
    _assert_ml_close(t_state, j_state)
    assert t_state.n_leaves() == j_state.n_leaves()


@pytest.mark.parametrize("max_depth", [2, 3])
def test_deeper_levels_average_onto_the_deepest_kept(galaxies, max_depth):
    """A 4-level grid (a level-4 block inside the core) under max_depth 2
    and 3: the levels below the deepest kept one average onto it."""
    levels = list(galaxies[8])
    core = levels[2]
    # the core's first 8 cells' children: level 4 at twice the core's
    # resolution
    h = (core.pos[1] - core.pos[0]).max() / 4
    kids = np.concatenate([core.pos[:8] + h * np.array(d)
                           for d in np.ndindex(2, 2, 2)]) - h / 2
    m = len(kids)
    levels.append(LevelData(pos=kids.astype(np.float32),
                            lT=np.full(m, 4.2, np.float32),
                            lnH=np.full(m, -1.5, np.float32),
                            lx=np.zeros(m, np.float32),
                            vel=np.zeros((m, 3), np.float32),
                            abun=np.zeros((m, 4), np.float32)))
    t_state, _ = tamr.multilevel_from_levels(levels, True, dtype=F64,
                                             device="cpu",
                                             max_depth=max_depth)
    j_state, _ = jamr.multilevel_from_levels(levels, True, dtype=jnp.float64,
                                             max_depth=max_depth)
    assert t_state.n_levels == max_depth
    _assert_ml_close(t_state, j_state)


def test_two_level_view_and_numpy_round_trip(galaxies):
    j_state, _ = jamr.multilevel_from_levels(galaxies[8], True,
                                             dtype=jnp.float64)
    arrays = {"levels": [{f.name: (None if getattr(lv, f.name) is None
                                   else np.asarray(getattr(lv, f.name)))
                          for f in dataclasses.fields(lv)}
                         for lv in j_state.levels],
              "refined": [np.asarray(r) for r in j_state.refined]}
    t_state = tamr.MultiLevelState.from_numpy(arrays, dtype=F64,
                                              device="cpu")
    _assert_ml_close(t_state, j_state)
    back = t_state.to_numpy()
    for a, b in zip(back["refined"], arrays["refined"]):
        assert a.dtype == np.bool_
        np.testing.assert_array_equal(a, b)
    for lv_a, lv_b in zip(back["levels"], arrays["levels"]):
        for k, v in lv_b.items():
            if v is None:
                assert lv_a[k] is None, k
            else:
                np.testing.assert_array_equal(lv_a[k], v, err_msg=k)
    two = tamr.MultiLevelState(levels=t_state.levels[:2],
                               refined=t_state.refined[:1])
    view = tamr.two_level_view(two)
    assert view.base is two.levels[0] and view.fine is two.levels[1]
    assert view.refined is two.refined[0]
    with pytest.raises(ValueError, match="2 levels"):
        tamr.two_level_view(t_state)
