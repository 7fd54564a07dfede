"""PyTorch port on a CUDA device: the hand-written sweep, per-zone sweep,
sweep-experiment, scatter and probe kernels against their plain PyTorch
versions, the tracer against its CPU run, and the mode-9 and mode-8 steps
through the sweep kernel.  Every test needs a
card and skips without one.  This file imports no JAX, so on a machine
without it run it past tests/conftest.py:

    python3 -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import radiativetransfer_tpu_torch as rt
from radiativetransfer_tpu_torch.config import (
    MODE_BOTH_STELLAR_UVB_TRANSFER,
    MODE_UVB_TRANSFER_ONLY,
)
from radiativetransfer_tpu_torch.constants import KPC, MYR
from radiativetransfer_tpu_torch.core import (
    probes_cuda,
    rays,
    scatter_cuda,
    sweep,
    sweep_cuda,
    variants_cuda,
)
from radiativetransfer_tpu_torch.tables import stellar

pytestmark = pytest.mark.cuda

UVB = np.array([1.0, 0.5, 0.25])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _kappa(n, dtype, device):
    rng = np.random.default_rng(42)
    return torch.tensor(rng.lognormal(0, 1, (3, n, n, n)) * 0.7 / KPC,
                        dtype=dtype, device=device)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 2e-6),
                                        (torch.float64, 1e-12)])
@pytest.mark.parametrize("plane_memory", ["shared", "global"])
@pytest.mark.parametrize("logmean", ["exact", "clamped"])
@pytest.mark.parametrize("level,n", [(1, 8), (2, 6)])
def test_kernel_matches_plain_version(card, level, n, logmean, plane_memory,
                                      dtype, rtol):
    # rtol: the same ops per cell, Jmean summed over directions in another
    # order (atomics)
    kappa = _kappa(n, dtype, card)
    plan = sweep.build_sweep_plan(level, n)
    before = sweep_cuda.LAUNCHES
    j = sweep_cuda.diffuse_sweep_kernel(kappa, plan, UVB, KPC, logmean,
                                        plane_memory=plane_memory)
    torch.cuda.synchronize()
    assert sweep_cuda.LAUNCHES == before + 1
    ref = sweep_cuda.diffuse_sweep_merged_reference(kappa, plan, UVB, KPC,
                                                    logmean)
    np.testing.assert_allclose(j.cpu().numpy(), ref.cpu().numpy(), rtol=rtol)


def test_kernel_rejects_what_it_does_not_take(card):
    plan = sweep.build_sweep_plan(1, 8)
    with pytest.raises(TypeError):
        sweep_cuda.diffuse_sweep_kernel(_kappa(8, torch.float16, card), plan,
                                        UVB, KPC)
    with pytest.raises(ValueError, match="shape"):
        sweep_cuda.diffuse_sweep_kernel(_kappa(6, torch.float32, card), plan,
                                        UVB, KPC)
    with pytest.raises(ValueError, match="contiguous"):
        sweep_cuda.diffuse_sweep_kernel(
            _kappa(8, torch.float32, card).transpose(1, 2), plan, UVB, KPC)


def test_mode9_step_launches_kernel(card):
    cfg = rt.RunConfig(mode=MODE_UVB_TRANSFER_ONLY, current_redshift=6.55,
                       n_angular_level=1, reionization_model=10)
    model = rt.RTModel.setup(cfg, rt.GridGeometry(24, 24, 24, 200.0 * KPC),
                             torch.float32, card)
    state = rt.uniform_state(24, nh=1e-4, tgas=2e4, device=card)
    before = sweep_cuda.LAUNCHES
    nf = model.neutral_fraction(model.make_step()(state))
    assert sweep_cuda.LAUNCHES == before + 1
    assert nf == pytest.approx(0.044220, rel=1e-4)


@pytest.mark.parametrize("numel", [3 * 16 ** 3, 1001, 3 * 256 ** 3 + 3])
@pytest.mark.parametrize("body,depth", [probes_cuda.EXP8,
                                        *probes_cuda.PLANE_PROBES,
                                        ("exp2", 64)])
def test_probe_matches_plain_version(card, body, depth, numel):
    # 1001 values: a ragged float4 tail; 3 * 256^3 + 3: the roofline's
    # shape, where the grid is capped and each thread walks the grid-stride
    # loop ~3 times, plus a ragged tail.  4e-6: the kernel's IEEE expf and
    # division against PyTorch's own on the card; the chains contract
    # (exp, div) or stay affine (fma), so rounding does not grow
    gen = torch.Generator(device=card).manual_seed(1)
    x = torch.empty(numel, device=card).log_normal_(0.0, 1.0, generator=gen)
    before = probes_cuda.LAUNCHES[(body, depth)]
    out = probes_cuda.chain(x, body, depth)
    torch.cuda.synchronize()
    assert probes_cuda.LAUNCHES[(body, depth)] == before + 1
    ref = probes_cuda.chain_reference(x, body, depth)
    torch.testing.assert_close(out, ref, rtol=4e-6, atol=0.0)


def test_probe_rejects_what_it_does_not_take(card):
    x = torch.ones(64, device=card)
    with pytest.raises(TypeError):
        probes_cuda.chain(x.double(), "exp", 8)
    with pytest.raises(ValueError, match="contiguous"):
        probes_cuda.chain(torch.ones(8, 8, device=card).t(), "exp", 8)
    with pytest.raises(ValueError, match="aligned"):
        probes_cuda.chain(x[1:], "exp", 8)


def _mode8(card, n=24):
    cfg = rt.RunConfig(mode=MODE_BOTH_STELLAR_UVB_TRANSFER,
                       current_redshift=6.55, n_angular_level=1,
                       reionization_model=10)
    geom = rt.GridGeometry(n, n, n, 200.0 * KPC)
    pos = np.random.default_rng(0).uniform(0.2, 0.8, (11, 3))
    batch = rays.SourceBatch(position=pos, weight=np.ones(11),
                             table_idx=np.zeros(11, np.int32))
    ctx = rt.StellarContext.build(stellar.blackbody_population(), batch,
                                  geom, 10.0 * MYR, [(0, 0.0)],
                                  max_pixel_level=2, device=card)
    return rt.RTModel.setup(cfg, geom, torch.float32, card), ctx


def test_mode8_step_launches_kernel(card):
    model, ctx = _mode8(card)
    state = rt.uniform_state(24, nh=1e-4, tgas=2e4, device=card)
    before = sweep_cuda.LAUNCHES
    out, diag = model.make_step(ctx)(state)
    assert sweep_cuda.LAUNCHES == before + 1
    assert out.HI.is_cuda and diag.ndot_remaining.is_cuda
    assert model.neutral_fraction(out) == pytest.approx(0.033307, rel=1e-4)


def test_tracer_on_card_matches_cpu(card):
    # float64 on both devices: the same operations, the deposits summed by
    # atomics in another order on the card
    model, ctx = _mode8(card)
    state = rt.uniform_state(24, nh=1e-4, tgas=2e4, dtype=torch.float64,
                             device=card)
    tables = {k: v.double() for k, v in ctx.tables.items()}
    out = [rays.trace_point_sources(s, model.geom, ctx.sources, t,
                                    max_pixel_level=2)
           for s, t in ((state, tables),
                        (rt.uniform_state(24, nh=1e-4, tgas=2e4,
                                          dtype=torch.float64, device="cpu"),
                         {k: v.cpu() for k, v in tables.items()}))]
    (g_rf, g_diag), (c_rf, c_diag) = out
    for a, b in ((g_rf, c_rf), (g_diag, c_diag)):
        for name in vars(a):
            x, y = getattr(a, name).cpu().numpy(), getattr(b, name).numpy()
            assert np.abs(x - y).max() <= 1e-9 * np.abs(y).max(), name


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 2e-6),
                                        (torch.float64, 1e-12)])
@pytest.mark.parametrize("plane_memory", ["shared", "global"])
@pytest.mark.parametrize("level,n", [(1, 8), (2, 6)])
def test_zone_kernel_matches_plain_version(card, level, n, plane_memory,
                                           dtype, rtol):
    # rtol: the same ops per cell, the directions summed by atomics
    kappa = _kappa(n, dtype, card)
    plan = sweep.build_sweep_plan(level, n)
    before = sweep_cuda.ZONE_LAUNCHES
    j = sweep_cuda.diffuse_sweep_zones_kernel(kappa, plan, UVB, KPC,
                                              plane_memory=plane_memory)
    torch.cuda.synchronize()
    assert sweep_cuda.ZONE_LAUNCHES == before + len(plan.zones)
    ref = sweep_cuda.diffuse_sweep_zones_reference(kappa, plan, UVB, KPC)
    np.testing.assert_allclose(j.cpu().numpy(), ref.cpu().numpy(), rtol=rtol)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 2e-6),
                                        (torch.float64, 1e-12)])
@pytest.mark.parametrize("plane_memory", ["shared", "global"])
@pytest.mark.parametrize("level,n", [(1, 8), (2, 6)])
def test_pair_kernel_matches_plain_version(card, level, n, plane_memory,
                                           dtype, rtol):
    kappa = _kappa(n, dtype, card)
    plan = sweep.build_sweep_plan(level, n)
    before = variants_cuda.LAUNCHES["pair"]
    j = variants_cuda.sweep_pair(kappa, plan, UVB, KPC,
                                 plane_memory=plane_memory)
    torch.cuda.synchronize()
    assert variants_cuda.LAUNCHES["pair"] == before + 1
    ref = variants_cuda.sweep_pair_reference(kappa, plan, UVB, KPC)
    np.testing.assert_allclose(j.cpu().numpy(), ref.cpu().numpy(), rtol=rtol)


@pytest.mark.parametrize("plane_memory", ["shared", "global"])
@pytest.mark.parametrize("variant", list(variants_cuda.VARIANTS))
def test_lean_kernel_matches_plain_version(card, variant, plane_memory):
    n = 8
    kappa = _kappa(n, torch.float32, card)
    plan = sweep.build_sweep_plan(2, n)
    before = variants_cuda.LAUNCHES[variant]
    j = variants_cuda.lean_sweep(kappa, plan, UVB, KPC, variant,
                                 plane_memory=plane_memory)
    torch.cuda.synchronize()
    assert variants_cuda.LAUNCHES[variant] == before + 1
    ref = variants_cuda.lean_sweep_reference(kappa, plan, UVB, KPC, variant)
    np.testing.assert_allclose(j.cpu().numpy(), ref.cpu().numpy(), rtol=2e-6)


def test_variant_kernels_reject_what_they_do_not_take(card):
    plan = sweep.build_sweep_plan(1, 8)
    with pytest.raises(TypeError):
        variants_cuda.lean_sweep(_kappa(8, torch.float64, card), plan, UVB,
                                 KPC)
    with pytest.raises(ValueError, match="odd"):
        variants_cuda.sweep_pair(_kappa(5, torch.float32, card),
                                 sweep.build_sweep_plan(1, 5), UVB, KPC)
    with pytest.raises(ValueError, match="shape"):
        variants_cuda.sweep_pair(_kappa(6, torch.float32, card), plan, UVB,
                                 KPC)


@pytest.mark.parametrize("m", [1, 1000, 98304])
def test_scatter_kernel_matches_plain_version(card, m):
    nc = 4096
    rng = np.random.default_rng(m)
    idx_np = rng.integers(0, nc, m)
    vals_np = rng.normal(0, 1, (m, 8)).astype(np.float32)
    idx = torch.tensor(idx_np, dtype=torch.int32, device=card)
    vals = torch.tensor(vals_np, device=card)
    acc0 = torch.tensor(rng.normal(0, 1, (nc, 8)), dtype=torch.float32,
                        device=card)
    before = scatter_cuda.LAUNCHES
    out = scatter_cuda.scatter_rows(acc0.clone(), idx, vals)
    torch.cuda.synchronize()
    assert scatter_cuda.LAUNCHES == before + 1
    ref = scatter_cuda.scatter_rows_reference(acc0.clone(), idx, vals)
    # rows that share a cell add in another order (atomics)
    assert float((out - ref).abs().max()) <= 1e-5
    ref64 = acc0.cpu().double().numpy()
    np.add.at(ref64, idx_np, vals_np.astype(np.float64))
    assert np.abs(out.cpu().numpy() - ref64).max() <= 1e-5


def test_scatter_drops_rows_outside_the_accumulator(card):
    acc = torch.zeros(16, 8, device=card)
    idx = torch.tensor([-1, 3, 16, 1 << 30], dtype=torch.int32, device=card)
    vals = torch.ones(4, 8, device=card)
    scatter_cuda.scatter_rows(acc, idx, vals)
    ref = torch.zeros(16, 8)
    ref[3] = 1.0
    assert torch.equal(acc.cpu(), ref)


def test_scatter_rejects_what_it_does_not_take(card):
    acc = torch.zeros(16, 8, device=card)
    idx = torch.zeros(4, dtype=torch.int32, device=card)
    vals = torch.ones(4, 8, device=card)
    with pytest.raises(TypeError):
        scatter_cuda.scatter_rows(acc, idx.long(), vals)
    with pytest.raises(TypeError):
        scatter_cuda.scatter_rows(acc.double(), idx, vals.double())
    with pytest.raises(ValueError, match="shapes"):
        scatter_cuda.scatter_rows(acc, idx, vals[:, :4].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        scatter_cuda.scatter_rows(acc, idx,
                                  torch.ones(8, 4, device=card).t())
