"""PyTorch port on a CUDA device: the hand-written cluster sweep, plane
sweep, per-zone sweep, ring sweeps (the cluster ring and the plane ring),
sweep-experiment (the cluster instances and the plane kernels), scatter
and probe kernels against their plain PyTorch versions, the tracer against
its CPU run, and the mode-9 and mode-8 steps through the cluster sweep kernel
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
from radiativetransfer_tpu_torch.parallel import sweep_dist, sweep_rdma
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


@pytest.mark.parametrize("numel", [1, 2, 3, 5, 4099, 3 * 64 ** 3 + 1])
def test_stream_kernel_matches_plain_version(card, numel):
    # the stream body's one-pass kernel at sizes that leave a ragged float4
    # tail, a partial block and a grid of many blocks; v + 1 is one
    # rounding, so bit for bit
    gen = torch.Generator(device=card).manual_seed(2)
    x = torch.empty(numel, device=card).log_normal_(0.0, 1.0, generator=gen)
    ref = probes_cuda.chain_reference(x, "stream", 1)
    before = probes_cuda.LAUNCHES[("stream", 1)]
    out = probes_cuda.chain(x, "stream", 1)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert probes_cuda.LAUNCHES[("stream", 1)] == before + 1


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
    j = sweep_cuda.zone_by_zone(sweep_cuda.sweep_zone_plane_kernel, kappa,
                                plan, UVB, KPC, plane_memory=plane_memory)
    torch.cuda.synchronize()
    assert sweep_cuda.ZONE_LAUNCHES == before + len(plan.zones)
    ref = sweep_cuda.diffuse_sweep_zones_reference(kappa, plan, UVB, KPC)
    np.testing.assert_allclose(j.cpu().numpy(), ref.cpu().numpy(), rtol=rtol)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-12)])
@pytest.mark.parametrize("level,n,csize,group", [
    (level, n, c, g) for level, n in [(1, 8), (2, 6), (2, 7)]
    for c, g in [(1, 1), (2, 2), (4, 1), (8, 1), (4, 4)] if c <= n])
def test_zone_cluster_kernel_matches_plain_version(card, level, n, csize,
                                                   group, dtype, rtol):
    # one zone a launch of csrc/sweep_cluster.cu on the rotated field; n 6
    # and 7 split into ragged row bands, level 2's zones of 1-3 directions
    # leave ragged groups.  rtol: the kernel's exact logmean (a - 1) *
    # (1/kappa) * (1/len) rounds the plain version's (1 - a)/tau otherwise,
    # and the directions are summed in another order
    kappa = _kappa(n, dtype, card)
    plan = sweep.build_sweep_plan(level, n)
    shape = sweep_cluster.cluster_shapes(n, n, dtype, csize, group)[0]
    before = sweep_cluster.ZONE_LAUNCHES
    for zone in plan.zones:
        krot = sweep_cuda.rotate_to_zone(kappa, zone)
        j = sweep_cluster.sweep_zone_cluster_kernel(krot, zone, UVB, KPC,
                                                    plan.weight, shape)
        torch.cuda.synchronize()
        ref = sweep_cuda.sweep_zone_reference(krot, zone, UVB, KPC,
                                              plan.weight)
        np.testing.assert_allclose(j.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=rtol, err_msg=f"zone {zone.izone}")
    assert sweep_cluster.ZONE_LAUNCHES == before + len(plan.zones)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-12)])
def test_zones_sweep_takes_cluster_kernel_at_main_width(card, dtype, rtol):
    # the zones strategy's sweep at 128^3 x 192: the size rule's shape, one
    # cluster launch a zone and none of the plane zone kernel
    n = 128
    kappa = _kappa(n, dtype, card)
    plan = sweep.build_sweep_plan(3, n)
    assert sweep_cluster.choose_cluster(n, n, dtype) is not None
    before = (sweep_cluster.ZONE_LAUNCHES, sweep_cuda.ZONE_LAUNCHES)
    j = sweep_cuda.diffuse_sweep_zones_kernel(kappa, plan, UVB, KPC)
    torch.cuda.synchronize()
    assert (sweep_cluster.ZONE_LAUNCHES, sweep_cuda.ZONE_LAUNCHES) == (
        before[0] + len(plan.zones), before[1])
    ref = sweep_cuda.diffuse_sweep_zones_reference(kappa, plan, UVB, KPC)
    assert probes_cuda.rel_err(j, ref)[1] <= rtol


def test_zone_tables_record_every_stream_that_reads_them(card):
    # zone i runs on side stream i % k: with k = 2 and then 3 zone 1's
    # cached tables are read on two streams, and each is recorded on them
    # (so a slot replaced later is not reused while either still reads it)
    n = 8
    plan = sweep.build_sweep_plan(1, n)
    kappa = _kappa(n, torch.float32, card)
    ref = sweep_cuda.diffuse_sweep_zones_reference(kappa, plan, UVB, KPC)
    for k in (2, 3):
        j = sweep_cuda.zone_by_zone(sweep_cuda.sweep_zone_kernel, kappa,
                                    plan, UVB, KPC, streams=k)
        assert probes_cuda.rel_err(j, ref)[1] <= 1e-5, k
    seen = sweep_cuda._TABLES[("cluster_zone", plan.zones[1].izone)][3]
    for k in (2, 3):
        assert sweep_cuda._side_streams(kappa.device, k)[1] in seen, k


def test_zone_rule_takes_old_kernel_where_nothing_fits(card):
    # no cluster shape holds a 256^3 float64 plane: the size rule sends the
    # zone to csrc/sweep_variants.cu's kernel before launching
    n = 256
    assert sweep_cluster.choose_cluster(n, n, torch.float64) is None
    zone = sweep.build_sweep_plan(1, n).zones[0]
    krot = torch.rand((n, 3, n, n), dtype=torch.float64, device=card) * 1e-22
    before = (sweep_cluster.ZONE_LAUNCHES, sweep_cuda.ZONE_LAUNCHES)
    j = sweep_cuda.sweep_zone_kernel(krot, zone, UVB, KPC, 1 / 12)
    torch.cuda.synchronize()
    assert (sweep_cluster.ZONE_LAUNCHES, sweep_cuda.ZONE_LAUNCHES) == (
        before[0], before[1] + 1)
    ref = sweep_cuda.sweep_zone_reference(krot, zone, UVB, KPC, 1 / 12)
    assert probes_cuda.rel_err(j, ref)[1] <= 1e-12


def test_zone_cluster_kernel_rejects_what_it_does_not_take(card):
    n = 8
    plan = sweep.build_sweep_plan(1, n)
    zone = plan.zones[0]
    krot = sweep_cuda.rotate_to_zone(_kappa(n, torch.float32, card), zone)
    with pytest.raises(ValueError, match="slabs"):
        sweep_cluster.sweep_zone_cluster_kernel(krot[:4].contiguous(), zone,
                                                UVB, KPC, plan.weight)
    with pytest.raises(TypeError):
        sweep_cluster.sweep_zone_cluster_kernel(krot.half(), zone, UVB, KPC,
                                                plan.weight)
    with pytest.raises(RuntimeError, match="launch failed"):
        # 8 rows split over 16 CTAs: refused by the library, not launched
        sweep_cluster.sweep_zone_cluster_kernel(
            krot, zone, UVB, KPC, plan.weight,
            sweep_cluster.ClusterShape(16, 1, 1, 32, 0))


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 2e-6),
                                        (torch.float64, 1e-12)])
@pytest.mark.parametrize("plane_memory", ["shared", "global"])
@pytest.mark.parametrize("level,n", [(1, 8), (2, 6)])
def test_pair_kernel_matches_plain_version(card, level, n, plane_memory,
                                           dtype, rtol):
    kappa = _kappa(n, dtype, card)
    plan = sweep.build_sweep_plan(level, n)
    before = variants_cuda.LAUNCHES["pair"]
    j = variants_cuda.sweep_pair_plane_kernel(kappa, plan, UVB, KPC,
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
    j = variants_cuda.lean_sweep_plane_kernel(kappa, plan, UVB, KPC, variant,
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


@pytest.mark.parametrize("mode,dtype,rtol", [
    (mode, torch.float32, 2e-6) for mode in variants_cuda.MODES] + [
    ("pair", torch.float64, 1e-12)])
@pytest.mark.parametrize("level,n", [(1, 6), (1, 7), (2, 8)])
def test_cluster_variant_matches_plain_version(card, level, n, mode, dtype,
                                               rtol):
    # every launch shape of the experiment's cluster instances: ragged row
    # bands (n 6, 7) and ragged groups (level 1's launches of 1-2
    # directions at G 2); the pair's slabs go in twos
    if mode == "pair" and n % 2:
        n += 1
    kappa = _kappa(n, dtype, card)
    plan = sweep.build_sweep_plan(level, n)
    ref = (variants_cuda.sweep_pair_reference(kappa, plan, UVB, KPC)
           if mode == "pair" else
           variants_cuda.lean_sweep_reference(kappa, plan, UVB, KPC, mode))
    shapes = variants_cuda.variant_shapes(n, dtype, mode)
    assert shapes
    before = variants_cuda.CLUSTER_LAUNCHES[mode]
    for shape in shapes:
        j = variants_cuda.cluster_kernel(kappa, plan, UVB, KPC, mode, shape)
        torch.cuda.synchronize()
        np.testing.assert_allclose(j.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=rtol, err_msg=str(shape))
    assert variants_cuda.CLUSTER_LAUNCHES[mode] == before + len(shapes)


def test_variant_wrappers_take_cluster_kernel(card):
    # the wrappers launch the cluster instances in the size rule's shape,
    # the plane kernels nowhere
    plan = sweep.build_sweep_plan(2, 8)
    variants_cuda.LAUNCHES.clear()
    variants_cuda.CLUSTER_LAUNCHES.clear()
    kappa = _kappa(8, torch.float32, card)
    for mode in variants_cuda.VARIANTS:
        j = variants_cuda.lean_sweep(kappa, plan, UVB, KPC, mode)
        np.testing.assert_allclose(
            j.cpu().numpy(), variants_cuda.lean_sweep_reference(
                kappa, plan, UVB, KPC, mode).cpu().numpy(), rtol=2e-6)
    for dtype in (torch.float32, torch.float64):
        variants_cuda.sweep_pair(_kappa(8, dtype, card), plan, UVB, KPC)
    torch.cuda.synchronize()
    assert dict(variants_cuda.CLUSTER_LAUNCHES) == {
        **{mode: 1 for mode in variants_cuda.VARIANTS}, "pair": 2}
    assert sum(variants_cuda.LAUNCHES.values()) == 0


def test_cluster_variant_rejects_what_it_does_not_take(card):
    plan = sweep.build_sweep_plan(1, 8)
    with pytest.raises(TypeError):
        variants_cuda.cluster_kernel(_kappa(8, torch.float64, card), plan,
                                     UVB, KPC, "lean")
    with pytest.raises(ValueError, match="odd"):
        variants_cuda.cluster_kernel(_kappa(7, torch.float32, card),
                                     sweep.build_sweep_plan(1, 7), UVB, KPC,
                                     "pair", sweep_cluster.ClusterShape(
                                         1, 1, 2, 32, 0))
    with pytest.raises(RuntimeError, match="launch failed"):
        # 8 rows split over 16 CTAs: refused by the library, not launched
        variants_cuda.cluster_kernel(
            _kappa(8, torch.float32, card), plan, UVB, KPC, "noemi",
            sweep_cluster.ClusterShape(16, 1, 2, 32, 0))


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


@pytest.mark.parametrize("cells,m", [(16, 1), (4096, 5000), (1 << 17, 98304)])
def test_red_floor_matches_plain_version(card, cells, m):
    # sums of ones: exact in any order
    acc = torch.zeros(cells, 8, device=card)
    before = scatter_cuda.FLOOR_LAUNCHES
    scatter_cuda.red_floor(acc, m)
    torch.cuda.synchronize()
    assert scatter_cuda.FLOOR_LAUNCHES == before + 1
    ref = scatter_cuda.red_floor_reference(torch.zeros(cells, 8), m)
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


@pytest.mark.parametrize("kernel", ["plane", "cluster"])
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 2e-6),
                                        (torch.float64, 1e-12)])
@pytest.mark.parametrize("level,n,p", [(1, 8, 1), (1, 8, 2), (2, 6, 3),
                                       (2, 8, 4)])
def test_rdma_kernel_matches_plain_version(card, level, n, p, dtype, rtol,
                                           kernel):
    # rtol: the directions summed by atomics (the cluster ring's exact
    # logmean rounded as the cluster kernel rounds it).  The plane ring
    # through its own wrapper, zone by zone; the cluster ring as the sweep
    # takes it by its size rule.  Each one launch a zone, and none of the
    # other's
    kappa = _kappa(n, dtype, card)
    plan = sweep.build_sweep_plan(level, n)
    mesh = pmesh.make_grid_mesh(p)
    before = (sweep_rdma.RING_LAUNCHES, sweep_rdma.RDMA_LAUNCHES)
    if kernel == "plane":
        j = sweep_dist.zone_by_zone_on_blocks(
            sweep_rdma.sweep_zone_ring_plane_kernel, kappa, plan, UVB, KPC,
            mesh)
        launched = (0, len(plan.zones))
    else:
        j = sweep_rdma.diffuse_sweep_rdma(kappa, plan, UVB, KPC, mesh)
        launched = (len(plan.zones), 0)
    torch.cuda.synchronize()
    assert (sweep_rdma.RING_LAUNCHES - before[0],
            sweep_rdma.RDMA_LAUNCHES - before[1]) == launched
    ref = sweep_rdma.diffuse_sweep_rdma_reference(kappa, plan, UVB, KPC, mesh)
    np.testing.assert_allclose(j.cpu().numpy(), ref.cpu().numpy(), rtol=rtol)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-12)])
@pytest.mark.parametrize("level,n,p", [(1, 8, 1), (2, 8, 2), (2, 6, 3),
                                       (2, 8, 4), (1, 16, 8), (2, 8, 8)])
def test_cluster_ring_every_shape_matches_plain_version(card, level, n, p,
                                                        dtype, rtol):
    # every launch shape of the ring's instances on every zone; n 6 splits
    # into ragged row bands, P 8 at n 8 leaves one k-column a rank (each cell
    # both the rank's first and last)
    kappa = _kappa(n, dtype, card)
    plan = sweep.build_sweep_plan(level, n)
    mesh = pmesh.make_grid_mesh(p)
    blocks = [pmesh.to_blocks(sweep_cuda.rotate_to_zone(kappa, z), mesh)
              for z in plan.zones]
    refs = [sweep_rdma.sweep_zone_rdma_reference(b, z, UVB, KPC, plan.weight)
            for b, z in zip(blocks, plan.zones)]
    shapes = sweep_cluster.ring_shapes(n, n // p, dtype)
    assert shapes
    before = sweep_rdma.RING_LAUNCHES
    for shape in shapes:
        for b, z, ref in zip(blocks, plan.zones, refs):
            out = sweep_rdma.sweep_zone_ring_cluster_kernel(
                b, z, UVB, KPC, plan.weight, shape)
            assert probes_cuda.rel_err(out, ref)[1] <= rtol, (shape, z.izone)
    assert sweep_rdma.RING_LAUNCHES == before + len(shapes) * len(
        plan.zones)


def test_cluster_ring_timeout_raises(card, monkeypatch):
    # rank 0's CTAs start ~2^26 cycles late and a wait may take 2^12: rank
    # 1's first wait runs out, marks the status, and every CTA runs to its
    # end; the wrapper raises, and the card runs the next ring as before
    n, p = 8, 2
    plan = sweep.build_sweep_plan(2, n)
    kappa = _kappa(n, torch.float32, card)
    zone = max(plan.zones, key=sweep_rdma._max_lines)
    blocks = pmesh.to_blocks(sweep_cuda.rotate_to_zone(kappa, zone),
                             pmesh.make_grid_mesh(p))
    monkeypatch.setattr(sweep_rdma, "SPIN_BUDGET_CYCLES", 1 << 12)
    with pytest.raises(RuntimeError, match="timeout"):
        sweep_rdma.sweep_zone_ring_cluster_kernel(
            blocks, zone, UVB, KPC, plan.weight, hold=(0, 1 << 26))
    torch.cuda.synchronize()
    monkeypatch.undo()
    out = sweep_rdma.sweep_zone_ring_cluster_kernel(blocks, zone, UVB, KPC,
                                                    plan.weight)
    ref = sweep_rdma.sweep_zone_rdma_reference(blocks, zone, UVB, KPC,
                                               plan.weight)
    assert probes_cuda.rel_err(out, ref)[1] <= 1e-5


def test_cluster_ring_that_cannot_be_co_resident_is_refused(card):
    # 8 ranks of a 128^3 float32 field at level 4: zone 1's 31 directions
    # at G 1 are 93 work items, 744 clusters of 2 CTAs x 512 threads, far
    # above the ~132 such clusters the card holds; no shape of the ring is
    # co-resident there, so the zone's own wrapper takes the plane ring
    n, p = 128, 8
    zone = sweep.build_sweep_plan(4, n).zones[0]
    blocks = torch.rand((p, n, 3, n, n // p), dtype=torch.float32,
                        device=card) * 1e-22
    shape = sweep_cluster.cluster_shapes(n, n // p, torch.float32, 2, 1,
                                         ring=True)[0]
    assert (shape.threads, sweep_cluster.ring_clusters(p, zone.ndir, 1)) \
        == (512, 744)
    before = sweep_rdma.RING_LAUNCHES
    with pytest.raises(RuntimeError, match="co-resident"):
        sweep_rdma.sweep_zone_ring_cluster_kernel(blocks, zone, UVB, KPC,
                                                  1 / 768, shape)
    assert sweep_rdma.RING_LAUNCHES == before
    assert sweep_rdma.ring_rule(p, n, n // p, zone.ndir, torch.float32,
                                card) is None
    old = sweep_rdma.RDMA_LAUNCHES
    sweep_rdma.sweep_zone_rdma_kernel(blocks, zone, UVB, KPC, 1 / 768)
    torch.cuda.synchronize()
    assert (sweep_rdma.RING_LAUNCHES, sweep_rdma.RDMA_LAUNCHES) == (
        before, old + 1)


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
    before = (sweep_rdma.RING_LAUNCHES, sweep_rdma.RDMA_LAUNCHES,
              sweep_cluster.ZONE_LAUNCHES, sweep_cuda.ZONE_LAUNCHES)
    nf = model.neutral_fraction(model.make_step(mesh=mesh)(state))
    zones = len(model.sweep_plan.zones)
    # the rdma strategy through the cluster ring, the zones strategy
    # through the per-zone cluster kernel; neither takes a plane kernel
    assert (sweep_rdma.RING_LAUNCHES, sweep_rdma.RDMA_LAUNCHES,
            sweep_cluster.ZONE_LAUNCHES, sweep_cuda.ZONE_LAUNCHES) == (
        before[0] + (zones if strategy == "rdma" else 0), before[1],
        before[2] + (zones if strategy == "zones" else 0), before[3])
    assert nf == pytest.approx(0.044220, rel=1e-4)
