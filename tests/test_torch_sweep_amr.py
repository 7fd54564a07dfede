"""PyTorch port, the two-level AMR sweep (core/sweep_amr.py) against the
JAX package's on the CPU.

n = 6, angular levels 1 and 2, float64, the five refinement maps of
tests/test_sweep_amr.py (none refined, all refined, a refined slab, a
refined block, 30% at random from seed 0) on lognormal opacities whose
fine level is drawn on its own (not the prolonged base): both levels'
Jmean within 1e-12 of each band's peak.  Also held against the serial
oracle of the reference's recursive transport order
(tests/reference_impl.py::serial_sweep_two_level) at that test's
tolerance (rtol 1e-9, atol 1e-13), in float32 within 1e-5 of each peak of
the JAX float32 sweep, and unit cases for the traps of the translation:
sel_child's axis order, the int8 template columns against SEG_XZ and the
TAG_* values, and the interleave of the two fine sub-slabs."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiativetransfer_tpu.constants import KPC
from radiativetransfer_tpu.core import sweep_amr as jsweep
from radiativetransfer_tpu.geometry.patterns import (
    SEG_XZ,
    TAG_XY,
    TAG_XZ,
    TAG_YZ,
)
from radiativetransfer_tpu_torch.core import sweep_amr as tsweep

sys.path.insert(0, os.path.dirname(__file__))
from reference_impl import serial_sweep_two_level  # noqa: E402
from test_torch_host import jax_compile_cache

N = 6
UVB = np.array([1.0, 0.5, 0.25])


def _map(name: str) -> np.ndarray:
    refined = np.zeros((N, N, N), bool)
    if name == "all":
        refined[:] = True
    elif name == "slab":
        refined[N // 2, :, :] = True
    elif name == "block":
        refined[1:4, 2:5, 0:3] = True
    elif name == "random":
        refined = np.random.default_rng(0).random((N, N, N)) < 0.3
    return refined


def _kappas(tau=0.5, seed=0, prolonged=False):
    rng = np.random.default_rng(seed)
    kc = rng.lognormal(0, 0.7, (3, N, N, N)) * tau / KPC
    if prolonged:
        kf = np.repeat(np.repeat(np.repeat(kc, 2, 1), 2, 2), 2, 3)
    else:
        kf = rng.lognormal(0, 0.7, (3,) + (2 * N,) * 3) * tau / KPC
    return kc, kf


@pytest.fixture(autouse=True)
def _one_thread():
    """The eager sweep's ~10^5 small ops run as fast on one intra-op thread
    as on eight, with an eighth of the CPU time beside the other workers."""
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
def plans():
    """Per angular level: the port's plan and one compiled JAX sweep."""
    out = {}
    for level in (1, 2):
        jplan = jsweep.build_amr_sweep_plan(level, N)
        out[level] = (tsweep.build_amr_sweep_plan(level, N),
                      jsweep.make_jitted_sweep_amr(jplan), jplan)
    return out


def _port(plan, kc, kf, refined, dtype=torch.float64):
    jc, jf = tsweep.diffuse_sweep_amr(
        torch.tensor(kc, dtype=dtype), torch.tensor(kf, dtype=dtype),
        torch.tensor(refined), plan, UVB, KPC)
    return jc.double().numpy(), jf.double().numpy()


def _worst(a, b) -> float:
    """Largest |a - b| over each band's peak of b."""
    return max(float(np.abs(a[i] - b[i]).max() / np.abs(b[i]).max())
               for i in range(3) if np.abs(b[i]).max() > 0)


def test_plan_matches():
    for level in (1, 2):
        tp = tsweep.build_amr_sweep_plan(level, N)
        jp = jsweep.build_amr_sweep_plan(level, N)
        assert (tp.n_directions, tp.nslab, tp.weight) == (
            jp.n_directions, jp.nslab, jp.weight)
        assert len(tp.zones) == len(jp.zones)
        for a, b in zip(tp.zones, jp.zones):
            assert (a.izone, a.ndir) == (b.izone, b.ndir)
            for side in ("coarse", "fine"):
                pa, pb = getattr(a, side), getattr(b, side)
                assert pa.keys() == pb.keys()
                for k in pb:
                    assert pa[k].dtype == pb[k].dtype, k
                    np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)


@pytest.mark.parametrize("name", ["none", "all", "slab", "block", "random"])
@pytest.mark.parametrize("level", [1, 2])
def test_sweep_matches_jax_f64(plans, level, name):
    plan, run_jax, _ = plans[level]
    kc, kf = _kappas(seed=level)
    refined = _map(name)
    jc, jf = _port(plan, kc, kf, refined)
    rc, rf = (np.asarray(x) for x in run_jax(
        jnp.asarray(kc), jnp.asarray(kf), jnp.asarray(refined),
        jnp.asarray(UVB), KPC))
    if refined.all():
        assert not jc.any() and not rc.any()
    else:
        assert _worst(jc, rc) <= 1e-12
    if refined.any():
        assert _worst(jf, rf) <= 1e-12
    else:
        # no fine leaf: the fine level carries no J on either side
        assert not jf.any() and not rf.any()
    # base J is zero under refined parents (their children hold it)
    assert not jc[:, refined].any()


def test_sweep_matches_serial_oracle(plans):
    plan = plans[1][0]
    kc, kf = _kappas(tau=0.6, seed=11, prolonged=True)
    refined = np.random.default_rng(7).random((N, N, N)) < 0.3
    jc_s, jf_s = serial_sweep_two_level(kc, kf, refined, 1, UVB, KPC)
    jc, jf = _port(plan, kc, kf, refined)
    np.testing.assert_allclose(jc[:, ~refined], jc_s[:, ~refined],
                               rtol=1e-9, atol=1e-13)
    ref_f = np.repeat(np.repeat(np.repeat(refined, 2, 0), 2, 1), 2, 2)
    np.testing.assert_allclose(jf[:, ref_f], jf_s[:, ref_f],
                               rtol=1e-9, atol=1e-13)


def test_sweep_f32_matches_jax_f32(plans):
    plan, _, jplan = plans[1]
    kc, kf = _kappas(seed=5)
    refined = _map("random")
    jc, jf = _port(plan, kc, kf, refined, torch.float32)
    rc, rf = jsweep.make_jitted_sweep_amr(jplan)(
        jnp.asarray(kc, jnp.float32), jnp.asarray(kf, jnp.float32),
        jnp.asarray(refined), jnp.asarray(UVB, jnp.float32), KPC)
    assert rc.dtype == jnp.float32
    rc, rf = np.asarray(rc, np.float64), np.asarray(rf, np.float64)
    assert _worst(jc, rc) <= 1e-5 and _worst(jf, rf) <= 1e-5


def test_sel_child_axis_order():
    """The advanced indices at dims 0, 3 and 5 are separated by slices:
    their broadcast dimension goes to the front, as NumPy and JAX put it."""
    rng = np.random.default_rng(1)
    D, ny, nz = 4, 3, 5
    plane = rng.normal(size=(D, 3, 2 * ny, 2 * nz))
    cj = np.array([0, 1, 1, 0])
    ck = np.array([1, 1, 0, 0])
    ours = tsweep._sel_child(torch.tensor(plane), torch.arange(D),
                             torch.tensor(cj), torch.tensor(ck)).numpy()
    f = plane.reshape(D, 3, ny, 2, nz, 2)
    ref = f[np.arange(D), :, :, cj, :, ck]
    assert ref.shape == ours.shape == (D, 3, ny, nz)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, np.asarray(
        jnp.asarray(f)[jnp.arange(D), :, :, jnp.asarray(cj), :,
                       jnp.asarray(ck)]))
    for d in range(D):
        np.testing.assert_array_equal(
            ours[d], plane[d][:, cj[d]::2, ck[d]::2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_slab_tables_against_jax_columns(dtype):
    """The int8 columns compared with SEG_XZ and the TAG_* values, the
    float columns rounded to the dtype before the 0.5 tests, slab by
    slab, as the JAX sweep reads them (_slab_params)."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    plan = tsweep.build_amr_sweep_plan(2, N)
    for zone in plan.zones:
        for params, cell in ((zone.coarse, KPC), (zone.fine, KPC / 2)):
            tab = tsweep._slab_tables(params, cell, dtype, "cpu")
            for i in range(params["len_xy"].shape[1]):
                sp = jsweep._slab_params(
                    {k: jnp.asarray(v) for k, v in params.items()}, i, jdt)
                sp = {k: np.asarray(v) for k, v in sp.items()}
                col = tsweep._slab(tab, i)

                def eq(t, ref):
                    np.testing.assert_array_equal(
                        t.reshape(-1).numpy(), np.asarray(ref).reshape(-1))
                eq(col["is2_xz"], sp["chain2"] == SEG_XZ)
                eq(col["act2"], sp["chain2"] != 0)
                eq(col["is3_xz"], sp["chain3"] == SEG_XZ)
                eq(col["act3"], sp["chain3"] != 0)
                eq(col["n_act3"], sp["n_active"] == 3)
                eq(col["n_act2"], sp["n_active"] == 2)
                eq(col["len1"], sp["len_xy"] * jdt(cell))
                eq(col["len2"], np.where(sp["chain2"] == SEG_XZ,
                                         sp["len_xz"], sp["len_yz"])
                   * jdt(cell))
                for face in ("top_xz", "top_yz"):
                    for got, tag in zip(col[face], (TAG_XY, TAG_XZ, TAG_YZ)):
                        eq(got, sp[face] == tag)
                eq(col["cj_xy"], sp["y0"] >= 0.5)
                eq(col["ck_xy"], sp["x0"] >= 0.5)
                eq(col["ck_xz"], sp["xz_x0"] >= 0.5)
                eq(col["sub_xz"], sp["xz_z0"] >= 0.5)
                eq(col["cj_yz"], sp["yz_y0"] >= 0.5)
                eq(col["sub_yz"], sp["yz_z0"] >= 0.5)


def test_zone_sweep_interleaves_the_fine_sub_slabs():
    """sweep_zone_amr returns the fine slab axis interleaved: slab 2i is
    base slab i's first sub-slab (JAX's jf0[i]), 2i+1 its second (jf1[i])."""
    plan = tsweep.build_amr_sweep_plan(1, N)
    zone = max(plan.zones, key=lambda z: z.ndir)
    kc, kf = _kappas(seed=9)
    kc_rot = np.moveaxis(kc, 0, 1)
    kf_rot = np.moveaxis(kf, 0, 1)
    refined = _map("random")
    jc, jf = tsweep.sweep_zone_amr(
        torch.tensor(kc_rot), torch.tensor(kf_rot), torch.tensor(refined),
        (zone.coarse, zone.fine), UVB, KPC, plan.weight)
    rc, rf0, rf1 = jsweep.sweep_zone_amr(
        jnp.asarray(kc_rot), jnp.asarray(kf_rot), jnp.asarray(refined),
        (zone.coarse, zone.fine), UVB, KPC, plan.weight)
    assert jf.shape == (2 * N, 3, 2 * N, 2 * N)
    np.testing.assert_allclose(jc.numpy(), np.asarray(rc), rtol=1e-12,
                               atol=0)
    np.testing.assert_allclose(jf[0::2].numpy(), np.asarray(rf0),
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(jf[1::2].numpy(), np.asarray(rf1),
                               rtol=1e-12, atol=0)
