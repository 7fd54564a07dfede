"""PyTorch port on a CUDA device: the hand-written cluster sweep, plane
sweep, per-zone sweep, ring sweep, sweep-experiment, scatter and probe
kernels against their plain PyTorch versions, the tracer against its CPU
run, and the mode-9 and mode-8 steps through the cluster sweep kernel
(mode 9 also on a mesh through the ring kernel).  Every test needs a
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
    sweep_cluster,
    sweep_cuda,
    variants_cuda,
)
from radiativetransfer_tpu_torch.parallel import mesh as pmesh
from radiativetransfer_tpu_torch.parallel import sweep_rdma
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
    # csrc/sweep_merged.cu's kernel.  rtol: the same ops per cell, Jmean
    # summed over directions in another order (atomics)
    kappa = _kappa(n, dtype, card)
    plan = sweep.build_sweep_plan(level, n)
    before = sweep_cuda.LAUNCHES
    j = sweep_cuda.diffuse_sweep_plane_kernel(kappa, plan, UVB, KPC, logmean,
                                              plane_memory=plane_memory)
    torch.cuda.synchronize()
    assert sweep_cuda.LAUNCHES == before + 1
    ref = sweep_cuda.diffuse_sweep_merged_reference(kappa, plan, UVB, KPC,
                                                    logmean)
    np.testing.assert_allclose(j.cpu().numpy(), ref.cpu().numpy(), rtol=rtol)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 2e-6),
                                        (torch.float64, 1e-12)])
@pytest.mark.parametrize("logmean", ["exact", "clamped"])
@pytest.mark.parametrize("csize,group", [(1, 1), (1, 4), (2, 2), (4, 1),
                                         (4, 4)])
@pytest.mark.parametrize("level,n", [(1, 8), (2, 6), (2, 7)])
def test_cluster_kernel_matches_plain_version(card, level, n, csize, group,
                                              logmean, dtype, rtol):
    # n 6 and 7 split into ragged row bands; the launches of 2 (level 1) and
    # 3-5 (level 2) directions leave ragged groups.  rtol: the same ops per
    # cell, Jmean summed over directions in another order
    kappa = _kappa(n, dtype, card)
    plan = sweep.build_sweep_plan(level, n)
    shape = sweep_cluster.cluster_shapes(n, n, dtype, csize, group)[0]
    before = sweep_cluster.LAUNCHES
    j = sweep_cluster.diffuse_sweep_cluster_kernel(kappa, plan, UVB, KPC,
                                                   logmean, shape)
    torch.cuda.synchronize()
    assert sweep_cluster.LAUNCHES == before + 1
    ref = sweep_cuda.diffuse_sweep_merged_reference(kappa, plan, UVB, KPC,
                                                    logmean)
    np.testing.assert_allclose(j.cpu().numpy(), ref.cpu().numpy(), rtol=rtol)


@pytest.mark.parametrize("logmean", ["exact", "clamped"])
def test_cluster_kernel_at_main_width(card, logmean):
    # the main path's 128^3 x 192 in the size rule's shape; 1e-5: 192-term
    # atomic sums in another order than the plain version's
    n = 128
    kappa = _kappa(n, torch.float32, card)
    plan = sweep.build_sweep_plan(3, n)
    before = (sweep_cluster.LAUNCHES, sweep_cuda.LAUNCHES)
    j = sweep_cuda.diffuse_sweep_kernel(kappa, plan, UVB, KPC, logmean)
    torch.cuda.synchronize()
    assert (sweep_cluster.LAUNCHES, sweep_cuda.LAUNCHES) == (before[0] + 1,
                                                             before[1])
    ref = sweep_cuda.diffuse_sweep_merged_reference(kappa, plan, UVB, KPC,
                                                    logmean)
    assert probes_cuda.rel_err(j, ref)[1] <= 1e-5


def test_size_rule_takes_plane_kernel_where_nothing_fits(card):
    # no cluster shape holds a 256^3 float64 plane's registers: the size
    # rule sends the sweep to csrc/sweep_merged.cu's kernel before launching
    n = 256
    assert sweep_cluster.choose_cluster(n, n, torch.float64) is None
    kappa = _kappa(n, torch.float64, card)
    plan = sweep.build_sweep_plan(1, n)
    before = (sweep_cluster.LAUNCHES, sweep_cuda.LAUNCHES)
    j = sweep_cuda.diffuse_sweep_kernel(kappa, plan, UVB, KPC)
    torch.cuda.synchronize()
    assert (sweep_cluster.LAUNCHES, sweep_cuda.LAUNCHES) == (before[0],
                                                             before[1] + 1)
    ref = sweep_cuda.diffuse_sweep_merged_reference(kappa, plan, UVB, KPC)
    assert probes_cuda.rel_err(j, ref)[1] <= 1e-12


def test_cluster_that_cannot_be_scheduled_is_refused(card):
    # 32 CTAs per cluster: above the card's largest cluster, so the
    # occupancy query finds none, and nothing is launched
    n = 64
    kappa = _kappa(n, torch.float32, card)
    plan = sweep.build_sweep_plan(1, n)
    shape = sweep_cluster.ClusterShape(csize=32, group=1, cpt=1,
                                       threads=128, smem=2 * 2 * n * 4)
    before = sweep_cluster.LAUNCHES
    with pytest.raises(RuntimeError, match="cannot be scheduled"):
        sweep_cluster.diffuse_sweep_cluster_kernel(kappa, plan, UVB, KPC,
                                                   shape=shape)
    assert sweep_cluster.LAUNCHES == before
    # a shape of the rule is resident
    rule = sweep_cluster.choose_cluster(n, n, torch.float32)
    assert sweep_cluster.resident_clusters(kappa, plan, KPC, rule) >= 1


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
    before = (sweep_cluster.LAUNCHES, sweep_cuda.LAUNCHES)
    nf = model.neutral_fraction(model.make_step()(state))
    # the cluster kernel, not the plane kernel
    assert (sweep_cluster.LAUNCHES, sweep_cuda.LAUNCHES) == (before[0] + 1,
                                                             before[1])
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
    before = (sweep_cluster.LAUNCHES, sweep_cuda.LAUNCHES)
    out, diag = model.make_step(ctx)(state)
    assert (sweep_cluster.LAUNCHES, sweep_cuda.LAUNCHES) == (before[0] + 1,
                                                             before[1])
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


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 2e-6),
                                        (torch.float64, 1e-12)])
@pytest.mark.parametrize("level,n,p", [(1, 8, 1), (1, 8, 2), (2, 6, 3),
                                       (2, 8, 4)])
def test_rdma_kernel_matches_plain_version(card, level, n, p, dtype, rtol):
    # rtol: the same ops per cell, the directions summed by atomics
    kappa = _kappa(n, dtype, card)
    plan = sweep.build_sweep_plan(level, n)
    mesh = pmesh.make_grid_mesh(p)
    before = sweep_rdma.RDMA_LAUNCHES
    j = sweep_rdma.diffuse_sweep_rdma(kappa, plan, UVB, KPC, mesh)
    torch.cuda.synchronize()
    assert sweep_rdma.RDMA_LAUNCHES == before + len(plan.zones)
    ref = sweep_rdma.diffuse_sweep_rdma_reference(kappa, plan, UVB, KPC, mesh)
    np.testing.assert_allclose(j.cpu().numpy(), ref.cpu().numpy(), rtol=rtol)


@pytest.mark.parametrize("plane_memory", ["shared", "global"])
def test_rdma_kernel_plane_memory(card, plane_memory):
    kappa = _kappa(8, torch.float32, card)
    plan = sweep.build_sweep_plan(2, 8)
    mesh = pmesh.make_grid_mesh(2)
    j = sweep_rdma.diffuse_sweep_rdma(kappa, plan, UVB, KPC, mesh,
                                      plane_memory=plane_memory)
    ref = sweep_rdma.diffuse_sweep_rdma_reference(kappa, plan, UVB, KPC, mesh)
    np.testing.assert_allclose(j.cpu().numpy(), ref.cpu().numpy(), rtol=2e-6)


def test_rdma_kernel_refuses_grid_that_cannot_be_resident(card):
    # 2 ranks of a 128^3 float64 field at level 4: 3 planes of 128 x 64
    # take 192 KiB of shared memory, one CTA per SM, and zone 1's 31
    # directions x 3 bands x 2 ranks are 186 CTAs > the card's 132 SMs
    zone = sweep.build_sweep_plan(4, 128).zones[0]
    blocks = torch.rand((2, 128, 3, 128, 64), dtype=torch.float64,
                        device=card)
    before = sweep_rdma.RDMA_LAUNCHES
    with pytest.raises(RuntimeError, match="co-resident"):
        sweep_rdma.sweep_zone_rdma_kernel(blocks, zone, UVB, KPC, 1 / 768,
                                          plane_memory="shared")
    assert sweep_rdma.RDMA_LAUNCHES == before


@pytest.mark.parametrize("strategy", ["rdma", "pipelined", "zones"])
def test_mode9_step_on_mesh(card, strategy):
    cfg = rt.RunConfig(mode=MODE_UVB_TRANSFER_ONLY, current_redshift=6.55,
                       n_angular_level=1, reionization_model=10,
                       sweep_strategy=strategy)
    model = rt.RTModel.setup(cfg, rt.GridGeometry(24, 24, 24, 200.0 * KPC),
                             torch.float32, card)
    mesh = pmesh.make_grid_mesh(4)
    state = pmesh.shard_state(rt.uniform_state(24, nh=1e-4, tgas=2e4,
                                               device="cpu"), mesh)
    before = sweep_rdma.RDMA_LAUNCHES
    nf = model.neutral_fraction(model.make_step(mesh=mesh)(state))
    assert sweep_rdma.RDMA_LAUNCHES == before + (
        len(model.sweep_plan.zones) if strategy == "rdma" else 0)
    assert nf == pytest.approx(0.044220, rel=1e-4)
