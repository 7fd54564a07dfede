"""PyTorch port, two-level AMR storage: the SFC leaf codec (io/sfc.py) and
the two-level state (core/amr.py) against the JAX package's, on the CPU.

The native enumerator (built with g++ at first use), the plain Python
one and the JAX package's agree bitwise on random refinement maps, and so
do gather and scatter; restrict, prolong, make_amr_state, sync_restriction
and amr_from_levels are bitwise equal in float64 on the synthetic galaxy
with its refined centre (examples/make_test_data.py, n = 12), with and
without metals and velocities.  At a power-of-two n XLA's CPU code sums
the JAX restriction's 8 children in another order (ROADMAP section 3): there
the two restrictions are held to the rounding bound of two orders of an
8-term sum of positive values, 14 u (1.6e-15 relative)."""

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
from radiativetransfer_tpu.io import sfc as jsfc  # noqa: E402
from radiativetransfer_tpu_torch.core import amr as tamr  # noqa: E402
from radiativetransfer_tpu_torch.core.state import (  # noqa: E402
    FieldState,
    make_state,
)
from radiativetransfer_tpu_torch.io import grid_io  # noqa: E402
from radiativetransfer_tpu_torch.io import sfc as tsfc  # noqa: E402

F64 = torch.float64


def _refinement(n: int, seed: int) -> list[np.ndarray]:
    """A random 3-level octree on an n^3 base: ~40% of the base cells
    refined, ~30% of their children refined again."""
    rng = np.random.default_rng(seed)
    r0 = rng.random((n, n, n)) < 0.4
    p0 = np.repeat(np.repeat(np.repeat(r0, 2, 0), 2, 1), 2, 2)
    r1 = p0 & (rng.random((2 * n,) * 3) < 0.3)
    return [r0.astype(np.uint8), r1.astype(np.uint8)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n", [4, 6, 8])
def test_sfc_enumeration_gather_scatter_bitwise(n, seed):
    refined = _refinement(n, seed)
    native = tsfc.enumerate_leaves(n, n, n, refined)
    plain = tsfc._enumerate_python(n, n, n, refined)
    ref = jsfc.enumerate_leaves(n, n, n, refined)
    ref_plain = jsfc._enumerate_python(n, n, n, refined)
    for key in ("level", "src", "x", "y", "z"):
        for enum in (native, plain, ref_plain):
            assert enum[key].dtype == ref[key].dtype, key
            np.testing.assert_array_equal(enum[key], ref[key], err_msg=key)
    r0, r1 = (int(r.sum()) for r in refined)
    assert len(native["level"]) == n ** 3 - r0 + 8 * r0 - r1 + 8 * r1

    rng = np.random.default_rng(seed + 10)
    shapes = [(n << lv,) * 3 for lv in range(3)]
    fields = [rng.normal(size=s) for s in shapes]
    leaves = tsfc.gather_leaves(native, fields)
    assert leaves.dtype == np.float64
    np.testing.assert_array_equal(leaves, jsfc.gather_leaves(ref, fields))
    # the stacked, dtype-keeping form the snapshot writer uses
    stacks = [np.stack([f, 2 * f]).astype(np.float32) for f in fields]
    both = tsfc.gather(native, stacks)
    assert both.dtype == np.float32 and both.shape == (2, len(leaves))
    np.testing.assert_array_equal(both[1], (2 * leaves).astype(np.float32))
    back = tsfc.scatter_leaves(native, leaves, shapes)
    for a, b in zip(back, jsfc.scatter_leaves(ref, leaves, shapes)):
        np.testing.assert_array_equal(a, b)


def test_sfc_native_library_is_built_in_the_package():
    path = tsfc.library_path()
    tsfc.enumerate_leaves(2, 2, 2, [np.zeros((2, 2, 2), np.uint8)])
    assert path.exists() and path.parent == tsfc.BUILD_DIR
    assert path.parent.name == "_build"
    with pytest.raises(ValueError, match="shape"):
        tsfc.enumerate_leaves(2, 2, 2, [np.zeros((3, 2, 2), np.uint8)])


def _fields(jax_fs) -> dict:
    return {f.name: (None if getattr(jax_fs, f.name) is None
                     else np.asarray(getattr(jax_fs, f.name)))
            for f in dataclasses.fields(jax_fs)}


def _assert_state_equal(t_fs: FieldState, j_fs) -> None:
    for f in dataclasses.fields(t_fs):
        a, b = getattr(t_fs, f.name), getattr(j_fs, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f.name)


def _assert_amr_equal(t_state, j_state) -> None:
    np.testing.assert_array_equal(t_state.refined.numpy(),
                                  np.asarray(j_state.refined))
    _assert_state_equal(t_state.base, j_state.base)
    _assert_state_equal(t_state.fine, j_state.fine)


@pytest.fixture(scope="module")
def galaxy_levels(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("grid") / "grid")
    levels, _ = make_test_data.make_grid(n=12, refine_center=True,
                                         path=path)
    return levels


@pytest.mark.parametrize("read_metals,with_vel", [
    (True, True), (True, False), (False, True), (False, False)])
def test_amr_from_levels_bitwise(galaxy_levels, read_metals, with_vel):
    levels = [lv if with_vel else dataclasses.replace(lv, vel=None)
              for lv in galaxy_levels]
    t_state, t_geom = tamr.amr_from_levels(levels, read_metals, dtype=F64,
                                           device="cpu")
    j_state, j_geom = jamr.amr_from_levels(levels, read_metals,
                                           dtype=jnp.float64)
    assert dataclasses.astuple(t_geom) == dataclasses.astuple(j_geom)
    assert int(t_state.refined.sum()) == 216
    assert (t_state.base.vel is not None) == with_vel
    _assert_amr_equal(t_state, j_state)
    assert t_state.n_leaves() == j_state.n_leaves() == 1728 - 216 + 8 * 216
    np.testing.assert_array_equal(t_state.leaf_mask_fine().numpy(),
                                  np.asarray(j_state.leaf_mask_fine()))
    np.testing.assert_array_equal(t_state.leaf_mask_base().numpy(),
                                  np.asarray(j_state.leaf_mask_base()))


def test_restrict_prolong_make_sync_bitwise():
    rng = np.random.default_rng(3)
    n = 6
    fine = rng.lognormal(0.0, 1.0, (2 * n,) * 3)
    coarse = rng.lognormal(0.0, 1.0, (n,) * 3)
    np.testing.assert_array_equal(tamr.restrict(torch.tensor(fine)).numpy(),
                                  np.asarray(jamr.restrict(jnp.asarray(fine))))
    np.testing.assert_array_equal(tamr.prolong(torch.tensor(coarse)).numpy(),
                                  np.asarray(jamr.prolong(jnp.asarray(coarse))))
    refined = rng.random((n, n, n)) < 0.3
    np.testing.assert_array_equal(
        tamr.prolong_mask(torch.tensor(refined)).numpy(),
        np.asarray(jamr.prolong_mask(jnp.asarray(refined))))

    nh = rng.lognormal(-6.0, 1.0, (n,) * 3)
    vel = rng.normal(0.0, 30.0, (3, n, n, n))
    base = dict(rho=nh * 2.3e-24, tgas=np.full(nh.shape, 1e4), HI=0.5 * nh,
                vel=vel)
    t_base = make_state(**base, dtype=F64, device="cpu")
    j_base = jstate.make_state(**base, dtype=jnp.float64)
    t_st = tamr.make_amr_state(t_base, refined)
    j_st = jamr.make_amr_state(j_base, jnp.asarray(refined))
    _assert_amr_equal(t_st, j_st)

    # fine fields off the prolongation, then the restriction into the base
    fine_hi = rng.lognormal(-7.0, 1.0, (2 * n,) * 3)
    fine_j = rng.normal(size=(3,) + (2 * n,) * 3)
    t_st = dataclasses.replace(t_st, fine=dataclasses.replace(
        t_st.fine, HI=torch.tensor(fine_hi), Jmean=torch.tensor(fine_j)))
    j_st = dataclasses.replace(j_st, fine=dataclasses.replace(
        j_st.fine, HI=jnp.asarray(fine_hi), Jmean=jnp.asarray(fine_j)))
    _assert_amr_equal(tamr.sync_restriction(t_st),
                      jamr.sync_restriction(j_st))


@pytest.mark.parametrize("n", [8, 16])
def test_restrict_at_a_power_of_two_within_rounding(n):
    """Where n is a power of two XLA's CPU reduce pairs the children as
    (x000 + x001) + (x010 + x011), then adds the other four the same way;
    the port sums them in i,j,k order there too, as a plain NumPy sum."""
    fine = np.random.default_rng(n).lognormal(0.0, 1.0, (2 * n,) * 3)
    ours = tamr.restrict(torch.tensor(fine)).numpy()
    x = fine.reshape(n, 2, n, 2, n, 2)
    total = x[:, 0, :, 0, :, 0]
    for a, b, c in np.ndindex(2, 2, 2):
        if (a, b, c) != (0, 0, 0):
            total = total + x[:, a, :, b, :, c]
    np.testing.assert_array_equal(ours, total * 0.125)
    ref = np.asarray(jamr.restrict(jnp.asarray(fine)))
    # two orders of a sum of 8 positive terms differ by at most
    # 2 * 7 * 2**-53 of the sum
    np.testing.assert_allclose(ours, ref, rtol=14 * 2.0 ** -53, atol=0)


def test_amr_state_numpy_round_trip(galaxy_levels):
    j_state, _ = jamr.amr_from_levels(galaxy_levels, True, dtype=jnp.float64)
    arrays = {"base": _fields(j_state.base), "fine": _fields(j_state.fine),
              "refined": np.asarray(j_state.refined)}
    t_state = tamr.AMRState.from_numpy(arrays, dtype=F64, device="cpu")
    _assert_amr_equal(t_state, j_state)
    back = t_state.to_numpy()
    assert back.keys() == arrays.keys()
    assert back["refined"].dtype == np.bool_
    np.testing.assert_array_equal(back["refined"], arrays["refined"])
    for level in ("base", "fine"):
        for k, v in arrays[level].items():
            if v is None:
                assert back[level][k] is None, k
            else:
                np.testing.assert_array_equal(back[level][k], v, err_msg=k)
    # the copy owns its memory: changing it leaves the arrays as they were
    t_state.base.HI.zero_()
    assert np.any(arrays["base"]["HI"] != 0)
    f32 = tamr.AMRState.from_numpy(arrays, dtype=torch.float32, device="cpu")
    assert f32.fine.rho.dtype == torch.float32
    assert f32.refined.dtype == torch.bool


def test_write_cli_inputs_two_level_matches_make_grid(tmp_path):
    """chip_smoke.write_cli_inputs' refined galaxy is make_grid's, bit for
    bit (the port's inputs on the card are the JAX example's)."""
    import chip_smoke
    for n, core in ((8, False), (16, True)):
        d = tmp_path / f"{n}"
        chip_smoke.write_cli_inputs(str(d), n, refine_center=True,
                                    refine_core=core)
        ours = grid_io.read_level_npz(str(d / "testgrid_velmet.npz"))
        ref, _ = make_test_data.make_grid(n=n, refine_center=True,
                                          refine_core=core,
                                          path=str(d / "ref"))
        assert len(ours) == len(ref) == (3 if core else 2)
        for a, b in zip(ours, ref):
            for key in ("pos", "lT", "lnH", "lx", "vel", "abun"):
                x, y = getattr(a, key), getattr(b, key)
                assert x.dtype == y.dtype, key
                np.testing.assert_array_equal(x, y, err_msg=key)
