"""PyTorch port, the cluster sweep kernel's host side (core/sweep_cluster.py):
its size rules (the merged sweep's and one zone's), its work items and row
bands, and csrc/sweep_cluster.cu's control flow replayed on the host
against the merged sweep's plain version and, on a zone's rotated field,
against the per-zone sweep's.  The kernel itself runs only on a card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from radiativetransfer_tpu_torch.constants import KPC
from radiativetransfer_tpu_torch.core import sweep as tsweep
from radiativetransfer_tpu_torch.core import sweep_cluster, sweep_cuda


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the port's eager ops are small CPU ops, on
    which more threads only spin beside the other test workers (module-
    scoped, so that the module's fixtures run pinned too)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


UVB = np.array([1.0, 0.5, 0.25])
SMEM_OPTIN = 232448


def _kappa(n, dtype, seed=42):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.lognormal(0, 1, (3, n, n, n)) * 0.7
                            / KPC).to(dtype)


def _every_shape(n, dtype):
    return [s for c in sweep_cluster.CLUSTER_SIZES
            for g in sweep_cluster.GROUP_SIZES
            for s in sweep_cluster.cluster_shapes(n, n, dtype, c, g)]


@pytest.mark.parametrize("n,dtype", [
    (n, torch.float32) for n in (6, 7, 8, 128, 192, 256)] + [
    (n, torch.float64) for n in (6, 7, 8, 64, 128)])
def test_launch_shapes_fit_one_cta(n, dtype):
    itemsize = torch.finfo(dtype).bits // 8
    shapes = _every_shape(n, dtype)
    assert shapes, (n, dtype)
    for s in shapes:
        rows_max = -(-n // s.csize)
        assert s.smem == 2 * s.group * rows_max * n * itemsize
        assert s.smem <= SMEM_OPTIN
        assert s.threads % 32 == 0 and s.threads * s.cpt >= rows_max * n
        assert s.threads <= sweep_cluster.max_threads(s.group, s.cpt,
                                                      itemsize)
        assert s.csize <= n
    rule = sweep_cluster.choose_cluster(n, n, dtype)
    assert rule in shapes
    # the rule: in float32 G = 2 and 4 cells per thread, in float64 G = 1
    # and 2 cells per thread, wherever such a shape fits
    group, cpt = (2, 4) if dtype == torch.float32 else (1, 2)
    if any(s.group == group and s.cpt == cpt for s in shapes):
        assert (rule.group, rule.cpt) == (group, cpt)
    rules = {(128, torch.float32): (8, 2, 4, 512),
             (256, torch.float32): (16, 2, 4, 1024),
             (128, torch.float64): (16, 1, 2, 512)}
    if (n, dtype) in rules:
        assert (rule.csize, rule.group, rule.cpt,
                rule.threads) == rules[(n, dtype)]


def test_size_rule_takes_the_plane_kernel_where_nothing_fits():
    # the planes of 256^3 float64 need more registers than any block
    # leaves, even split over 16 CTAs
    for n, dtype in ((256, torch.float64), (384, torch.float32)):
        assert sweep_cluster.choose_cluster(n, n, dtype) is None
        assert _every_shape(n, dtype) == []
    # the main path's planes all fit
    for n in (24, 128, 256):
        assert sweep_cluster.choose_cluster(n, n, torch.float32) is not None
    assert sweep_cluster.choose_cluster(128, 128, torch.float64) is not None
    assert sweep_cluster.max_threads(4, 16, 4) == 0


def test_register_model_matches_the_kernel_source():
    # csrc/sweep_cluster.cuh's kRegs and max_threads (its launch bounds and
    # the check before launch) against sweep_cluster.max_threads (the size
    # rule's), read from the source, for the merged and zone instances, the
    # ring's (RING, G 1 and 2) and the experiments' Modes (their terms
    # kCellRegsG against CELL_REGS_G)
    src = (Path(sweep_cluster.__file__).parents[1] / "csrc"
           / "sweep_cluster.cuh").read_text()
    ring_regs = int(re.search(r"constexpr int RING_REGS = (\d+);",
                              src).group(1))
    assert ring_regs == sweep_cluster.RING_REGS
    modes = re.search(r"enum Mode : int \{(.*?)\};", src, re.S).group(1)
    assert len(modes.split(",")) - 1 == len(sweep_cluster.MODES)
    cell_g = [int(x) for x in re.search(
        r"constexpr int kCellRegsG\[\] = \{(.*?)\};", src).group(1).split(",")]
    assert tuple(cell_g) == sweep_cluster.CELL_REGS_G
    expr = re.search(r"constexpr int kRegs =(.*?);", src, re.S).group(1)
    expr = " ".join(expr.split()).replace("kWords<T>", "W").replace(
        "RING_REGS", str(ring_regs)).replace("kCellRegsG[M]", "X").replace(
        "(M == kRing)", "RING")
    assert re.fullmatch(r"[\dGCPTWRINX+*/() -]+", expr), expr
    body = re.search(r"constexpr int max_threads\(\) \{(.*?)\n\}", src,
                     re.S).group(1)
    caps = [(int(r), int(t))
            for r, t in re.findall(r"regs <= (\d+) \? (\d+)", body)]
    assert [t for _, t in caps] == [1024, 768, 512, 384, 256]
    for mode, groups, built in (
            ("exact", sweep_cluster.GROUP_SIZES,
             sweep_cluster.CELLS_PER_THREAD),
            ("ring", sweep_cluster.RING_GROUP_SIZES,
             sweep_cluster.RING_CELLS_PER_THREAD)) + tuple(
            (mode, sweep_cluster.EXP_GROUP_SIZES,
             sweep_cluster.EXP_CELLS_PER_THREAD)
            for mode in sweep_cluster.MODES[3:]):
        ring = mode == "ring"
        for itemsize in (4, 8):
            for group in groups:
                for cpt in sweep_cluster.CELLS_PER_THREAD + (8, 16):
                    regs = eval(expr.replace("/", "//"), {
                        "G": group, "CPT": cpt, "W": itemsize // 4,
                        "RING": int(ring),
                        "X": cell_g[sweep_cluster.MODES.index(mode)]})
                    cu = next((t for r, t in caps if regs <= r), 0)
                    assert cu == sweep_cluster.max_threads(
                        group, cpt, itemsize, ring, mode)
                    # every instance the library builds has a block
                    assert cu > 0 or cpt not in built


@pytest.mark.parametrize("level,n", [(1, 6), (1, 7), (2, 8), (3, 8)])
@pytest.mark.parametrize("group", sweep_cluster.GROUP_SIZES)
def test_work_items_cover_every_direction_band_and_row(level, n, group):
    plan = tsweep.build_sweep_plan(level, n)
    _, meta, _, _ = sweep_cuda.kernel_tables(plan, KPC, torch.float32, "cpu")
    meta = meta.numpy()
    items = sweep_cluster.work_items(meta, group)
    assert items.dtype == np.int32 and items.shape[1] == 4
    for csize in [c for c in sweep_cluster.CLUSTER_SIZES if c <= n]:
        seen = np.zeros((len(meta), 3, n), np.int64)
        bands = sweep_cluster.row_bands(n, csize)
        assert bands[0][0] == 0 and bands[-1][1] == n
        assert all(r1 > r0 for r0, r1 in bands)
        assert all(a[1] == b[0] for a, b in zip(bands, bands[1:]))
        for d0, count, band, _ in items:
            assert 1 <= count <= group
            for r0, r1 in bands:
                seen[d0:d0 + count, band, r0:r1] += 1
        assert (seen == 1).all(), (csize, group)
    groups = {}
    for d0, count, band, _ in items:
        # one permutation and one slab order per work item
        assert (meta[d0:d0 + count, :2] == meta[d0, :2]).all()
        if band == 0:
            groups.setdefault(tuple(meta[d0, :2]), []).append(count)
    # each merged launch (15 or 17 directions at level 3) in as few groups
    # as G allows, sized within one of each other
    for key, sizes in groups.items():
        run = int((meta[:, :2] == key).all(axis=1).sum())
        assert sum(sizes) == run and len(sizes) == -(-run // group)
        assert max(sizes) - min(sizes) <= 1


def _emulate_cluster_launch(kappa, plan, uvb, cell_size, logmean, shape):
    """The merged sweep's launch replayed on the host (_emulate_items)."""
    perms, meta, lens, chains = sweep_cuda.kernel_tables(
        plan, cell_size, kappa.dtype, kappa.device)
    jmean, kperm, ikperm, jperm = sweep_cuda.launch_buffers(kappa, logmean,
                                                             perms)
    _emulate_items(kperm, ikperm, jperm, meta, lens, chains, uvb,
                   plan.weight, logmean, shape)
    return sweep_cuda.gather_jmean(jmean, jperm, perms)


def _emulate_zone_launch(kappa_rot, zone, uvb, cell_size, weight, shape):
    """One zone's launch replayed on the host: the zone's tables
    (sweep_cluster.zone_tables) on (3, nslab, ny, nz) views of the rotated
    (nslab, 3, ny, nz) field and of Jmean, the kernel's slab and band
    strides."""
    meta, lens, chains = sweep_cluster.zone_tables(zone, cell_size,
                                                   kappa_rot.dtype, "cpu")
    jout = torch.zeros_like(kappa_rot)
    _emulate_items([kappa_rot.transpose(0, 1)],
                   [(1.0 / kappa_rot).transpose(0, 1)],
                   [jout.transpose(0, 1)], meta, lens, chains, uvb, weight,
                   "exact", shape)
    return jout


def _emulate_items(kperm, ikperm, jperm, meta, lens, chains, uvb, weight,
                   logmean, shape):
    """csrc/sweep_cluster.cu's control flow on the host: each work item (a
    band and <= G directions) walked by C CTAs of row bands; segment 1 in
    place, then the union of the directions' chained stages, each writing
    every CTA's staging plane before any CTA reads (the cluster barrier),
    the j-shift reading the neighbour CTA's edge row (the pad at the
    plane's edge), the k-shift inside the CTA; the G logmeans, each times
    its direction's weight 1/N * 1/n_active, summed before one deposit
    per cell.  Adds into jperm's (3, nslab, ny, nz) fields in place."""
    dtype = kperm[0].dtype
    eps = tsweep._tau_eps(dtype)
    nslab, ny, nz = kperm[0].shape[1:]
    bands = sweep_cluster.row_bands(ny, shape.csize)

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

    for d0, count, band, _ in sweep_cluster.work_items(meta.numpy(),
                                                       shape.group):
        dirs = slice(d0, d0 + count)
        p, reverse = meta[d0, :2].tolist()
        flip_j = meta[dirs, 2].bool()[:, None, None]
        flip_k = meta[dirs, 3].bool()[:, None, None]
        pad = torch.tensor(float(uvb[band]), dtype=dtype)
        carry = [pad.expand(count, r1 - r0, nz) for r0, r1 in bands]
        acc = [None] * len(bands)
        for i in range(nslab):
            s = nslab - 1 - i if reverse else i
            ln = lens[dirs, i][:, :, None, None]              # (g, 8, 1, 1)
            kap = [kperm[p][band, s, r0:r1] for r0, r1 in bands]
            ikap = [ikperm[p][band, s, r0:r1] for r0, r1 in bands]
            for r in range(len(bands)):
                carry[r], acc[r] = seg(carry[r], kap[r], ikap[r], ln[:, 0],
                                       ln[:, 4])
            for stage in (1, 2):
                code = chains[dirs, i, stage - 1][:, None, None]
                if not bool((code != 0).any()):
                    break
                planes = [c.clone() for c in carry]          # then barrier
                for r in range(len(bands)):
                    src = planes[r]
                    rows = src.shape[1]
                    edge = pad.expand(count, 1, nz)
                    lo = planes[r - 1][:, -1:] if r > 0 else edge
                    hi = planes[r + 1][:, :1] if r + 1 < len(bands) else edge
                    j_in = torch.where(flip_j, torch.cat([src[:, 1:], hi], 1),
                                       torch.cat([lo, src[:, :rows - 1]], 1))
                    kpad = pad.expand(count, rows, 1)
                    k_in = torch.where(flip_k,
                                       torch.cat([src[:, :, 1:], kpad], 2),
                                       torch.cat([kpad, src[:, :, :-1]], 2))
                    i_out, lm = seg(torch.where(code == 1, j_in, k_in),
                                    kap[r], ikap[r], ln[:, stage],
                                    ln[:, 4 + stage])
                    on = code != 0
                    carry[r] = torch.where(on, i_out, carry[r])
                    acc[r] = torch.where(on, acc[r] + lm, acc[r])
            for r, (r0, r1) in enumerate(bands):
                terms = (weight * ln[:, 3]) * acc[r]
                dep = terms[0]
                for g in range(1, count):
                    dep = dep + terms[g]
                jperm[p][band, s, r0:r1] += dep


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 2e-6),
                                        (torch.float64, 1e-12)])
@pytest.mark.parametrize("logmean", ["exact", "clamped"])
@pytest.mark.parametrize("level,n,csize,group", [(1, 7, 4, 2), (2, 6, 4, 4),
                                                 (1, 8, 2, 1), (2, 7, 1, 4)])
def test_kernel_control_flow_emulated(level, n, csize, group, logmean, dtype,
                                      rtol):
    # n 6 and 7 split into ragged row bands; level 1 has launches of 2
    # directions, level 2 of 3-5, so G = 2 and 4 leave ragged groups
    kappa = _kappa(n, dtype)
    plan = tsweep.build_sweep_plan(level, n)
    shape = sweep_cluster.cluster_shapes(n, n, dtype, csize, group)[0]
    j = _emulate_cluster_launch(kappa, plan, UVB, KPC, logmean, shape)
    ref = sweep_cuda.diffuse_sweep_merged_reference(kappa, plan, UVB, KPC,
                                                    logmean)
    np.testing.assert_allclose(j.numpy(), ref.numpy(), rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wrappers_on_cpu_take_plain_version(dtype):
    n = 6
    kappa = _kappa(n, dtype)
    plan = tsweep.build_sweep_plan(2, n)
    before = (sweep_cuda.LAUNCHES, sweep_cluster.LAUNCHES)
    ref = sweep_cuda.diffuse_sweep_merged_reference(kappa, plan, UVB, KPC,
                                                    "clamped")
    for fn in (sweep_cuda.diffuse_sweep_kernel,
               sweep_cuda.diffuse_sweep_plane_kernel,
               sweep_cluster.diffuse_sweep_cluster_kernel):
        assert torch.equal(fn(kappa, plan, UVB, KPC, "clamped"), ref)
    assert (sweep_cuda.LAUNCHES, sweep_cluster.LAUNCHES) == before
    with pytest.raises(ValueError, match="logmean"):
        sweep_cluster.diffuse_sweep_cluster_kernel(kappa, plan, UVB, KPC,
                                                   "fast")


# ---------------------------------------------------------------------------
# One zone's sweep through the cluster kernel (TPU kernel #2)
# ---------------------------------------------------------------------------


def _zone_fields(level, n, dtype):
    kappa = _kappa(n, dtype)
    plan = tsweep.build_sweep_plan(level, n)
    return plan, [sweep_cuda.rotate_to_zone(kappa, zone) for zone in
                  plan.zones]


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-12)])
@pytest.mark.parametrize("level,n,csize,group", [
    (1, 6, 4, 1), (1, 7, 2, 2), (2, 6, 4, 2), (2, 7, 4, 1), (2, 8, 8, 2),
    (1, 8, 1, 1)])
def test_zone_launch_control_flow_emulated(level, n, csize, group, dtype,
                                           rtol):
    # n 6 and 7 split into ragged row bands; level 2's zones of 1-3
    # directions leave ragged groups at G = 2.  Against the zone kernel's
    # plain version, the slab scan's sweep_zone: the kernel's exact logmean
    # (a - 1) * (1/kappa) * (1/len_n) rounds the scan's (1 - a)/tau
    # otherwise, and it sums the directions' weighted logmeans in another
    # order (f32 2.1e-6 at level 1 n 6; 1e-5, phase 11's tolerance)
    plan, krots = _zone_fields(level, n, dtype)
    shape = sweep_cluster.cluster_shapes(n, n, dtype, csize, group)[0]
    for zone, krot in zip(plan.zones, krots):
        j = _emulate_zone_launch(krot, zone, UVB, KPC, plan.weight, shape)
        ref = sweep_cuda.sweep_zone_reference(krot, zone, UVB, KPC,
                                              plan.weight)
        np.testing.assert_allclose(j.numpy(), ref.numpy(), rtol=rtol,
                                   err_msg=f"zone {zone.izone}")


@pytest.mark.parametrize("level,n", [(1, 6), (2, 8), (3, 8)])
@pytest.mark.parametrize("group", [1, 2])
def test_zone_work_items_cover_every_direction_and_band(level, n, group):
    # one merged launch of the zone's directions (meta all zero), in as few
    # groups of <= G as it takes, sized within one of each other, x 3 bands
    plan = tsweep.build_sweep_plan(level, n)
    for zone in plan.zones:
        meta, lens, chains = sweep_cluster.zone_tables(zone, KPC,
                                                       torch.float64, "cpu")
        assert meta.shape == (zone.ndir, 4) and not meta.any()
        assert lens.shape == (zone.ndir, n, 8)
        assert chains.shape == (zone.ndir, n, 2)
        items = sweep_cluster.work_items(meta.numpy(), group)
        assert len(items) == 3 * -(-zone.ndir // group)
        seen = np.zeros((zone.ndir, 3), np.int64)
        for d0, count, band, _ in items:
            seen[d0:d0 + count, band] += 1
        assert (seen == 1).all()
        sizes = [count for _, count, band, _ in items if band == 0]
        assert max(sizes) - min(sizes) <= 1
        # lens: -len*cell x3 (chain order), 1/n_active, -1/(len*cell) x3
        np.testing.assert_allclose(lens[..., 0].numpy(),
                                   -zone.len_xy * KPC, rtol=1e-15)
        np.testing.assert_allclose(lens[..., 3].numpy(),
                                   1.0 / zone.n_active, rtol=1e-15)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_zone_wrappers_on_cpu_take_plain_version(dtype):
    plan, krots = _zone_fields(2, 6, dtype)
    before = (sweep_cuda.ZONE_LAUNCHES, sweep_cluster.ZONE_LAUNCHES)
    for zone, krot in zip(plan.zones, krots):
        ref = sweep_cuda.sweep_zone_reference(krot, zone, UVB, KPC,
                                              plan.weight)
        for fn in (sweep_cuda.sweep_zone_kernel,
                   sweep_cuda.sweep_zone_plane_kernel,
                   sweep_cluster.sweep_zone_cluster_kernel):
            assert torch.equal(fn(krot, zone, UVB, KPC, plan.weight), ref)
    assert (sweep_cuda.ZONE_LAUNCHES, sweep_cluster.ZONE_LAUNCHES) == before
