"""PyTorch port, the per-zone sweep (TPU kernel #2) and the sweep
experiments (#6 and #7): their plain versions against the JAX kernels in
interpret mode, the zone-by-zone sweep against the JAX package's sweep, the
copied table packing, the CPU path of the wrappers and the attribution
variants' work counts.

The scripts' launchers take no interpret flag, so each test swaps the
script module's launcher for one that builds the same pallas_call around
the script's own kernel body with interpret=True (pytest's monkeypatch
restores it)."""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from radiativetransfer_tpu.constants import KPC
from radiativetransfer_tpu.core import sweep as jsweep
from radiativetransfer_tpu.core import sweep_pallas
from radiativetransfer_tpu_torch.core import sweep as tsweep
from radiativetransfer_tpu_torch.core import sweep_cuda, variants_cuda
from radiativetransfer_tpu_torch.geometry import octants
from test_torch_host import jax_compile_cache


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the port's eager ops are small CPU ops, on
    which more threads only spin beside the other test workers (module-
    scoped, so that the module's fixtures run pinned too)."""
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


UVB = np.array([1.0, 0.5, 0.25])
TOL = {np.float64: 1e-12, np.float32: 2e-6}


# the zone kernel's exact logmean (1 - a)/tau in float32: XLA's and
# PyTorch's float32 exp on the CPU differ by an ulp in ~10% of values, and
# the division by tau turns that ulp into up to 6e-4 of one segment's
# emissivity for tau just above the 1e-4 switch (1.6e-5 elementwise on
# these fields, level 2, n 6)
ZONE_TOL_F32 = 4e-5


def _assert_close(actual, desired, np_dtype, err_msg=""):
    """Elementwise relative TOL of the dtype."""
    np.testing.assert_allclose(actual, desired, rtol=TOL[np_dtype], atol=0.0,
                               err_msg=err_msg)


_SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"


def _script(name):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}",
                                                  _SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


xpair = _script("exp_sweep_pair")
xvar = _script("exp_sweep_variants")


def _kappa(n, np_dtype, seed=42):
    rng = np.random.default_rng(seed)
    return (rng.lognormal(0, 1, (3, n, n, n)) * 0.7 / KPC).astype(np_dtype)


def _slab_call(kernel, kappa_perm, lens, chains, uvb, weight, *, dirs_meta,
               reverse, nslab, ny, nz, block):
    """The grid spec of the scripts' _pair_call (block 2) and _lean_call
    (block 1) around a kernel body, in interpret mode."""
    dtype = kappa_perm.dtype
    nblk = nslab // block

    def index_map(b, i, *_):
        return (b, nblk - 1 - i if reverse else i, 0, 0)

    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=4, grid=(3, nblk),
        in_specs=[pl.BlockSpec((1, block, ny, nz), index_map)],
        out_specs=pl.BlockSpec((1, block, ny, nz), index_map),
        scratch_shapes=[pltpu.VMEM((len(dirs_meta), ny, nz), dtype)])
    return pl.pallas_call(
        kernel, grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((3, nslab, ny, nz), dtype),
        interpret=True,
    )(lens, chains, uvb.astype(dtype), jnp.full((1,), weight, dtype),
      kappa_perm)


def _pair_call_interpret(kappa_perm, lens, chains, uvb, weight, *, dirs_meta,
                         reverse, nslab, ny, nz):
    kernel = functools.partial(
        xpair._pair_kernel, dirs_meta=dirs_meta,
        eps=float(jsweep._tau_eps(kappa_perm.dtype)), reverse=reverse)
    return _slab_call(kernel, kappa_perm, lens, chains, uvb, weight,
                      dirs_meta=dirs_meta, reverse=reverse, nslab=nslab,
                      ny=ny, nz=nz, block=2)


def _lean_call_interpret(kappa_perm, lens, chains, uvb, weight, *, dirs_meta,
                         reverse, nslab, ny, nz, **flags):
    kernel = functools.partial(
        xvar._lean_kernel, dirs_meta=dirs_meta,
        eps=float(jsweep._tau_eps(kappa_perm.dtype)), **flags)
    return _slab_call(kernel, kappa_perm, lens, chains, uvb, weight,
                      dirs_meta=dirs_meta, reverse=reverse, nslab=nslab,
                      ny=ny, nz=nz, block=1)


@pytest.mark.parametrize("np_dtype", [np.float64, np.float32])
@pytest.mark.parametrize("level,n", [(1, 8), (2, 6)])
def test_zone_kernel_interpret_matches_plain(level, n, np_dtype):
    kappa = _kappa(n, np_dtype)
    kappa_l = np.moveaxis(kappa, 0, -1)
    j_plan = jsweep.build_sweep_plan(level, n)
    t_plan = tsweep.build_sweep_plan(level, n)
    for jz, tz in zip(j_plan.zones, t_plan.zones):
        krot = np.ascontiguousarray(np.moveaxis(
            octants.rotate_to_sweep(kappa_l, tz.izone), -1, 1))
        nslab, _, ny, nz = krot.shape
        lens, chains = sweep_pallas.zone_arrays(jz, KPC, np_dtype)
        j_pal = np.asarray(sweep_pallas._sweep_zone_pallas(
            jnp.asarray(krot), lens, chains, jnp.asarray(UVB, np_dtype),
            j_plan.weight, ndir=jz.ndir, nslab=nslab, ny=ny, nz=nz,
            interpret=True))
        j_t = sweep_cuda.sweep_zone_kernel(torch.from_numpy(krot), tz, UVB,
                                           KPC, t_plan.weight)
        assert j_t.dtype == torch.from_numpy(krot).dtype
        if np_dtype == np.float64:
            _assert_close(j_t.numpy(), j_pal, np_dtype, f"zone {tz.izone}")
        else:
            # also ZONE_TOL_F32 of the field's largest value, for the same
            # ulp of exp where a cell's value is small
            np.testing.assert_allclose(
                j_t.numpy(), j_pal, rtol=ZONE_TOL_F32,
                atol=ZONE_TOL_F32 * np.abs(j_pal).max(),
                err_msg=f"zone {tz.izone}")


@pytest.mark.parametrize("level,n", [(1, 8), (2, 6)])
def test_zones_sweep_on_cpu_matches_jax_sweep(level, n):
    kappa = _kappa(n, np.float64)
    j_jax = np.asarray(jsweep.make_jitted_sweep(
        jsweep.build_sweep_plan(level, n))(jnp.asarray(kappa),
                                           jnp.asarray(UVB), KPC))
    before = sweep_cuda.ZONE_LAUNCHES
    j_t = sweep_cuda.diffuse_sweep_zones_kernel(
        torch.from_numpy(kappa), tsweep.build_sweep_plan(level, n), UVB, KPC)
    assert sweep_cuda.ZONE_LAUNCHES == before
    np.testing.assert_allclose(j_t.numpy(), j_jax, rtol=1e-12)


@pytest.mark.parametrize("np_dtype", [np.float64, np.float32])
@pytest.mark.parametrize("level,n", [(1, 6), (1, 4)])
def test_pair_interpret_matches_plain(level, n, np_dtype, monkeypatch):
    monkeypatch.setattr(xpair, "_pair_call", _pair_call_interpret)
    kappa = _kappa(n, np_dtype)
    plan = jsweep.build_sweep_plan(level, n)
    # one compiled program around the script's sweep (its launches would
    # compile one by one eagerly)
    j_pal = np.asarray(jax.jit(lambda k: xpair.pair_sweep(
        k, plan, jnp.asarray(UVB, np_dtype), KPC))(jnp.asarray(kappa)))
    j_t = variants_cuda.sweep_pair(torch.from_numpy(kappa),
                                   tsweep.build_sweep_plan(level, n), UVB,
                                   KPC)
    _assert_close(j_t.numpy(), j_pal, np_dtype)


@pytest.mark.parametrize("np_dtype", [np.float64, np.float32])
@pytest.mark.parametrize("variant", list(variants_cuda.VARIANTS))
def test_lean_interpret_matches_plain(variant, np_dtype, monkeypatch):
    monkeypatch.setattr(xvar, "_lean_call", _lean_call_interpret)
    n = 6
    kappa = _kappa(n, np_dtype)
    plan = jsweep.build_sweep_plan(1, n)
    j_pal = np.asarray(jax.jit(lambda k: xvar.lean_sweep(
        k, plan, jnp.asarray(UVB, np_dtype), KPC,
        **variants_cuda.flags(variant)))(jnp.asarray(kappa)))
    j_t = variants_cuda.lean_sweep(torch.from_numpy(kappa),
                                   tsweep.build_sweep_plan(1, n), UVB, KPC,
                                   variant)
    _assert_close(j_t.numpy(), j_pal, np_dtype)


@pytest.mark.parametrize("variant", list(variants_cuda.VARIANTS))
def test_lean_pack_matches_script(variant):
    f = variants_cuda.flags(variant)
    plan = jsweep.build_sweep_plan(2, 6)
    for launch in sweep_pallas._build_merged_launches(plan, np.float64):
        for np_dtype in (np.float32, np.float64):
            ours = variants_cuda._lean_pack(launch, KPC, f["use_exp2"],
                                            np_dtype, clamped=f["clamped"])
            theirs = xvar._lean_pack(launch, KPC, f["use_exp2"], np_dtype,
                                     clamped=f["clamped"])
            assert ours.dtype == theirs.dtype
            np.testing.assert_array_equal(ours, theirs)


def test_zone_arrays_match_jax():
    plan = tsweep.build_sweep_plan(2, 6)
    for jz, tz in zip(jsweep.build_sweep_plan(2, 6).zones, plan.zones):
        for np_dtype in (np.float32, np.float64):
            lens, chains = sweep_cuda.zone_arrays(tz, KPC, np_dtype)
            j_lens, j_chains = sweep_pallas.zone_arrays(jz, KPC, np_dtype)
            assert lens.dtype == np.asarray(j_lens).dtype
            np.testing.assert_array_equal(lens, np.asarray(j_lens))
            np.testing.assert_array_equal(chains, np.asarray(j_chains))


def test_cpu_wrappers_take_plain_versions():
    n = 6
    kappa = torch.from_numpy(_kappa(n, np.float32))
    plan = tsweep.build_sweep_plan(2, n)
    variants_cuda.LAUNCHES.clear()
    assert torch.equal(variants_cuda.sweep_pair(kappa, plan, UVB, KPC),
                       sweep_cuda.diffuse_sweep_merged_reference(
                           kappa, plan, UVB, KPC, "exact"))
    for variant in variants_cuda.VARIANTS:
        assert torch.equal(
            variants_cuda.lean_sweep(kappa, plan, UVB, KPC, variant),
            variants_cuda.lean_sweep_reference(kappa, plan, UVB, KPC,
                                               variant))
    assert sum(variants_cuda.LAUNCHES.values()) == 0
    with pytest.raises(ValueError, match="variant"):
        variants_cuda.lean_sweep(kappa, plan, UVB, KPC, "lean2")
    with pytest.raises(ValueError, match="odd"):
        variants_cuda.sweep_pair(torch.from_numpy(_kappa(5, np.float32)),
                                 tsweep.build_sweep_plan(1, 5), UVB, KPC)


def test_full_variants_compute_the_sweep():
    # lean, clamp and clamp2 are the merged sweep in other arithmetic:
    # lean is the exact logmean (1e-5: f32 rounding through ~n chained
    # attenuations), the clamped forms within 1e-3 as the merged kernel's
    n = 6
    kappa = torch.from_numpy(_kappa(n, np.float32))
    plan = tsweep.build_sweep_plan(2, n)
    ref = sweep_cuda.diffuse_sweep_merged_reference(kappa, plan, UVB,
                                                    KPC).numpy()
    for variant, rtol in (("lean", 1e-5), ("clamp", 1e-3),
                          ("clamp2", 1e-3)):
        np.testing.assert_allclose(
            variants_cuda.lean_sweep_reference(kappa, plan, UVB, KPC,
                                               variant).numpy(),
            ref, rtol=rtol, err_msg=variant)


@pytest.mark.parametrize("level,n", [(1, 5), (2, 6)])
def test_variant_work_counts(level, n):
    plan = tsweep.build_sweep_plan(level, n)
    full = sweep_cuda.work_counts(plan)
    dir_slabs = plan.n_directions * n
    plane = 3 * n * n
    assert sweep_cuda.work_counts(plan, variant="noshift") == full
    seg1 = sweep_cuda.work_counts(plan, variant="seg1")
    assert seg1["exps"] == plane * dir_slabs
    # 8 + 6 per segment, 3 per slab cell, no chained segment
    assert seg1["fp32_ops"] == plane * dir_slabs * (8 + 6 + 3)
    noemi = sweep_cuda.work_counts(plan, variant="noemi")
    assert noemi["exps"] == 3 * plane * dir_slabs
    assert noemi["fp32_ops"] == plane * dir_slabs * (3 * (2 + 6) + 2 + 3)
    assert full["exps"] < noemi["exps"]
    exp2 = sweep_cuda.work_counts(plan, fp32_per_exp=2)
    assert full["fp32_ops"] - exp2["fp32_ops"] == 4 * full["exps"]
    assert seg1["bytes"] == noemi["bytes"] == full["bytes"]
    with pytest.raises(ValueError, match="variant"):
        sweep_cuda.work_counts(plan, variant="lean2")
