"""PyTorch port, diffuse sweep: the slab scan (core/sweep.py) and the
kernel's plain version (core/sweep_cuda.py) against the JAX package's
sweep, its Pallas kernel in interpret mode and the serial oracle."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiativetransfer_tpu.constants import KPC
from radiativetransfer_tpu.core import sweep as jsweep
from radiativetransfer_tpu.core import sweep_pallas
from radiativetransfer_tpu_torch.core import sweep as tsweep
from radiativetransfer_tpu_torch.core import sweep_cuda

from reference_impl import serial_sweep
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


def _kappa(n, seed=42, tau_scale=0.7):
    rng = np.random.default_rng(seed)
    return rng.lognormal(0, 1, (3, n, n, n)) * tau_scale / KPC


@pytest.mark.parametrize("level,n", [(1, 4), (2, 6), (3, 6)])
def test_slab_scan_matches_jax_f64(level, n):
    kappa = _kappa(n)
    j_jax = np.asarray(jsweep.make_jitted_sweep(
        jsweep.build_sweep_plan(level, n))(jnp.asarray(kappa),
                                           jnp.asarray(UVB), KPC))
    j_t = tsweep.diffuse_sweep(torch.from_numpy(kappa),
                               tsweep.build_sweep_plan(level, n), UVB, KPC)
    assert j_t.dtype == torch.float64
    np.testing.assert_allclose(j_t.numpy(), j_jax, rtol=1e-12)


def test_slab_scan_matches_serial_oracle():
    # as tests/test_sweep.py: all 12 directions of level 1 at n = 4
    kappa = _kappa(4, tau_scale=0.5)
    uvb = np.array([1.0, 0.6, 0.3])
    j_serial = serial_sweep(kappa, 1, uvb, KPC)
    j_t = tsweep.diffuse_sweep(torch.from_numpy(kappa),
                               tsweep.build_sweep_plan(1, 4), uvb, KPC)
    np.testing.assert_allclose(j_t.numpy(), j_serial, rtol=1e-10,
                               atol=1e-14)


@pytest.mark.parametrize("logmean", ["exact", "clamped"])
@pytest.mark.parametrize("level,n", [(1, 8), (2, 6)])
def test_merged_reference_matches_pallas_interpret(level, n, logmean):
    kappa = _kappa(n).astype(np.float32)
    j_pal = np.asarray(sweep_pallas.make_jitted_sweep_pallas(
        jsweep.build_sweep_plan(level, n), interpret=True, logmean=logmean)(
            jnp.asarray(kappa), jnp.asarray(UVB, jnp.float32), KPC))
    j_t = sweep_cuda.diffuse_sweep_merged_reference(
        torch.from_numpy(kappa), tsweep.build_sweep_plan(level, n), UVB, KPC,
        logmean=logmean)
    assert j_t.dtype == torch.float32
    np.testing.assert_allclose(j_t.numpy(), j_pal, rtol=2e-6)


@pytest.mark.parametrize("sweep_fn", ["slab_scan", "merged_reference"])
def test_transparent_box(sweep_fn):
    n = 6
    kappa = torch.full((3, n, n, n), 1e-30, dtype=torch.float32)
    plan = tsweep.build_sweep_plan(1, n)
    if sweep_fn == "slab_scan":
        j = tsweep.diffuse_sweep(kappa, plan, UVB, KPC)
    else:
        j = sweep_cuda.diffuse_sweep_merged_reference(kappa, plan, UVB, KPC)
    np.testing.assert_allclose(
        j.numpy(), UVB[:, None, None, None] * np.ones((3, n, n, n)),
        rtol=1e-5)


def test_clamped_logmean_bounds():
    """As tests/test_sweep_pallas.py: the clamped form stays within 1e-3 of
    the exact form across both regimes and within 2e-4 of the UVB in a
    transparent box."""
    n = 6
    rng = np.random.default_rng(3)
    kappa = torch.tensor(10.0 ** rng.uniform(-8, 1, (3, n, n, n)) / KPC,
                         dtype=torch.float32)
    plan = tsweep.build_sweep_plan(1, n)
    j_exact = sweep_cuda.diffuse_sweep_merged_reference(
        kappa, plan, UVB, KPC).numpy()
    j_clamp = sweep_cuda.diffuse_sweep_merged_reference(
        kappa, plan, UVB, KPC, logmean="clamped").numpy()
    denom = np.maximum(np.abs(j_exact), np.abs(j_exact).max() * 1e-3)
    assert np.max(np.abs(j_clamp - j_exact) / denom) < 1e-3

    kappa0 = torch.full((3, n, n, n), 1e-30, dtype=torch.float32)
    j0 = sweep_cuda.diffuse_sweep_merged_reference(
        kappa0, plan, UVB, KPC, logmean="clamped").numpy()
    ref = UVB[:, None, None, None] * np.ones((3, n, n, n))
    assert np.max(np.abs(j0 - ref) / ref) < 2.0e-4


def test_malformed_chain_table_rejected():
    plan = tsweep.build_sweep_plan(1, 8)
    chain2 = np.asarray(plan.zones[0].chain2).copy()
    chain2[0, 0] = 7                       # not a segment code
    bad_zone = dataclasses.replace(plan.zones[0], chain2=chain2)
    with pytest.raises(ValueError, match="malformed chain table"):
        sweep_cuda._validate_zone_tables(bad_zone)
    for z in plan.zones:                   # real plans pass
        sweep_cuda._validate_zone_tables(z)
    bad_plan = dataclasses.replace(plan, zones=(bad_zone,) + plan.zones[1:])
    with pytest.raises(ValueError, match="malformed chain table"):
        sweep_cuda.diffuse_sweep_kernel(torch.ones(3, 8, 8, 8), bad_plan,
                                        UVB, KPC)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wrapper_on_cpu_takes_plain_version(dtype):
    n = 6
    kappa = torch.from_numpy(_kappa(n)).to(dtype)
    plan = tsweep.build_sweep_plan(2, n)
    before = sweep_cuda.LAUNCHES
    j = sweep_cuda.diffuse_sweep_kernel(kappa, plan, UVB, KPC,
                                        logmean="clamped")
    assert sweep_cuda.LAUNCHES == before
    ref = sweep_cuda.diffuse_sweep_merged_reference(kappa, plan, UVB, KPC,
                                                    logmean="clamped")
    assert torch.equal(j, ref)
    with pytest.raises(ValueError, match="logmean"):
        sweep_cuda.diffuse_sweep_kernel(kappa, plan, UVB, KPC,
                                        logmean="fast")


def _emulate_kernel_launch(kappa, plan, uvb, cell_size, logmean):
    """sweep_merged.cu's control flow, one (direction, 3 bands) at a time,
    on the tables and permuted buffers the wrapper hands the kernel: a CPU
    check of the host-side packing (permutations, flips, slab order,
    channel scaling) and of the gather back to grid order."""
    perms, meta, lens, chains = sweep_cuda.kernel_tables(
        plan, cell_size, kappa.dtype, kappa.device)
    jmean, kperm, ikperm, jperm = sweep_cuda.launch_buffers(kappa, logmean,
                                                             perms)
    eps = tsweep._tau_eps(kappa.dtype)
    nslab, ny, nz = kperm[0].shape[1:]
    pad = torch.as_tensor(uvb, dtype=kappa.dtype)[:, None, None]

    def seg(i_in, kap, ikap, len_n, inv_len_n):
        a = torch.exp(kap * len_n)
        if logmean == "clamped":
            d = i_in * (1.0 - torch.clamp(a, max=sweep_cuda._A_EPS))
            r = torch.clamp(ikap * (-inv_len_n), max=1.0 / sweep_cuda._EPS_CL)
            return i_in * a, d * r
        tau_n = kap * len_n
        emi = torch.where(tau_n < -eps, (a - 1.0) * ikap * inv_len_n,
                          1.0 + 0.5 * tau_n)
        return i_in * a, i_in * emi

    def shift(x, chain, flip_j, flip_k):
        pj, pk = pad.expand(3, 1, nz), pad.expand(3, ny, 1)
        if chain == 1:
            return (torch.cat([x[:, 1:], pj], 1) if flip_j
                    else torch.cat([pj, x[:, :-1]], 1))
        return (torch.cat([x[:, :, 1:], pk], 2) if flip_k
                else torch.cat([pk, x[:, :, :-1]], 2))

    for d in range(meta.shape[0]):
        p, reverse, flip_j, flip_k = meta[d].tolist()
        cur = pad.expand(3, ny, nz)
        for i in range(nslab):
            s = nslab - 1 - i if reverse else i
            ln, (ch2, ch3) = lens[d, i], chains[d, i].tolist()
            kap, ikap = kperm[p][:, s], ikperm[p][:, s]
            cur, jacc = seg(cur, kap, ikap, ln[0], ln[4])
            for chain, k in ((ch2, 1), (ch3, 2)):
                if chain == 0:
                    break
                cur, lm = seg(shift(cur, chain, flip_j, flip_k), kap, ikap,
                              ln[k], ln[4 + k])
                jacc = jacc + lm
            jperm[p][:, s] += plan.weight * (ln[3] * jacc)
    return sweep_cuda.gather_jmean(jmean, jperm, perms)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 2e-6),
                                        (torch.float64, 1e-12)])
@pytest.mark.parametrize("logmean", ["exact", "clamped"])
@pytest.mark.parametrize("level,n", [(1, 8), (2, 6)])
def test_kernel_host_packing_emulated(level, n, logmean, dtype, rtol):
    kappa = torch.from_numpy(_kappa(n)).to(dtype)
    plan = tsweep.build_sweep_plan(level, n)
    perms, meta, lens, chains = sweep_cuda.kernel_tables(plan, KPC, dtype,
                                                          "cpu")
    assert meta.shape[0] == plan.n_directions == lens.shape[0]
    assert lens.shape == (plan.n_directions, n, 8) and lens.dtype == dtype
    assert chains.shape == (plan.n_directions, n, 2)
    assert len(perms) <= 6 and int(meta[:, 0].max()) < len(perms)
    j = _emulate_kernel_launch(kappa, plan, UVB, KPC, logmean)
    ref = sweep_cuda.diffuse_sweep_merged_reference(kappa, plan, UVB, KPC,
                                                    logmean)
    np.testing.assert_allclose(j.numpy(), ref.numpy(), rtol=rtol)
