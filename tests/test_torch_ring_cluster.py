"""PyTorch port, the cluster ring (TPU kernel #3 on csrc/sweep_cluster.cu's
RING instances): its size rule and co-residency arithmetic
(core/sweep_cluster.py), its line tables, and the kernel's control flow
replayed on the host -- the clusters' row bands, the neighbour CTA's edge
row read as through distributed shared memory after a cluster barrier, G
directions per CTA, each CTA's rows of the halo columns, every value with
its line's sequence number, loaded early and reloaded until it matches,
each line in its own slot -- under random interleavings of every CTA of a
launch, against the ring's plain version.  The kernel itself runs only on
a card (tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

from radiativetransfer_tpu_torch.constants import KPC
from radiativetransfer_tpu_torch.core import sweep as tsweep
from radiativetransfer_tpu_torch.core import sweep_cluster, sweep_cuda
from radiativetransfer_tpu_torch.geometry.patterns import SEG_XZ, SEG_YZ
from radiativetransfer_tpu_torch.parallel import mesh as tmesh
from radiativetransfer_tpu_torch.parallel import sweep_rdma


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


def _blocks(level, n, p, seed=42):
    rng = np.random.default_rng(seed)
    kappa = torch.from_numpy(rng.lognormal(0, 1, (3, n, n, n)) * 0.7 / KPC)
    plan = tsweep.build_sweep_plan(level, n)
    mesh = tmesh.make_grid_mesh(p, device="cpu")
    return plan, [tmesh.to_blocks(sweep_cuda.rotate_to_zone(kappa, z), mesh)
                  for z in plan.zones]


# ---------------------------------------------------------------------------
# The size rule, the co-residency arithmetic and the line tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ny,nz,dtype", [
    (128, 32, torch.float32), (128, 64, torch.float32),
    (128, 128, torch.float32), (256, 64, torch.float32),
    (128, 32, torch.float64), (128, 128, torch.float64),
    (8, 2, torch.float64), (6, 3, torch.float32)])
def test_ring_shapes_fit_one_cta(ny, nz, dtype):
    itemsize = torch.finfo(dtype).bits // 8
    shapes = sweep_cluster.ring_shapes(ny, nz, dtype)
    assert shapes
    for s in shapes:
        rows_max = -(-ny // s.csize)
        assert s.group in sweep_cluster.RING_GROUP_SIZES
        assert s.cpt in sweep_cluster.RING_CELLS_PER_THREAD
        # the staging planes and the incoming lines; a thread a row
        assert s.smem == s.group * rows_max * (2 * nz + 1) * itemsize \
            <= SMEM_OPTIN
        assert s.threads % 32 == 0 and s.threads * s.cpt >= rows_max * nz
        assert s.threads >= rows_max
        assert s.threads <= sweep_cluster.max_threads(s.group, s.cpt,
                                                      itemsize, ring=True)
    with pytest.raises(ValueError, match="no ring kernel"):
        sweep_cluster.cluster_shapes(ny, nz, dtype, 1, 4, ring=True)


def test_ring_rule_and_co_residency():
    # 128^3 on 4 ranks: a rank's plane is 128 x 32; a level-3 zone has 5-11
    # directions, so a launch is 4 x 3 x ceil(ndir / G) clusters
    assert sweep_cluster.ring_clusters(4, 11, 2) == 72
    assert sweep_cluster.ring_clusters(4, 11, 1) == 132
    assert sweep_cluster.ring_clusters(1, 5, 2) == 9
    shapes = sweep_cluster.ring_shapes(128, 32, torch.float32)
    # a card that holds every shape's clusters: the preference's first
    # (G, cells per thread), the block nearest 256 threads, the smallest
    # cluster
    rule = sweep_cluster.choose_ring(128, 32, 4, 11, torch.float32,
                                     lambda s: 10 ** 6)
    g, cpt = sweep_cluster.RING_PREFERENCE[4][0]
    best = [s for s in shapes if (s.group, s.cpt) == (g, cpt)]
    assert (rule.group, rule.cpt) == (g, cpt)
    assert rule == min(best, key=lambda s: (abs(s.threads - 256), s.csize))
    # only co-resident shapes: each shape holds as many clusters as its
    # CTAs of `threads` fit 132 SMs of 2048 threads (a stand-in for the
    # card's answer)

    def held(s):
        return 132 * (2048 // s.threads) // s.csize
    for ranks, ndir in ((1, 5), (4, 8), (4, 11), (8, 11), (16, 33)):
        r = sweep_cluster.choose_ring(128, 32, ranks, ndir, torch.float32,
                                      held)
        fits = [s for s in shapes if sweep_cluster.ring_clusters(
            ranks, ndir, s.group) <= held(s)]
        assert (r is None) == (not fits)
        if r is not None:
            assert r in fits
    assert sweep_cluster.choose_ring(128, 32, 4, 11, torch.float32,
                                     lambda s: 0) is None
    # a plane no ring instance can hold
    assert sweep_cluster.choose_ring(256, 256, 1, 5, torch.float64,
                                     lambda s: 10 ** 6) is None


@pytest.mark.parametrize("level,n", [(1, 6), (2, 8), (3, 16)])
def test_ring_lines_number_each_yz_stage(level, n):
    plan = tsweep.build_sweep_plan(level, n)
    for zone in plan.zones:
        lines = sweep_cluster.ring_lines(zone.chain2, zone.chain3)
        assert lines.shape == (zone.ndir, n, 2) and lines.dtype == np.int32
        for st, chain in enumerate((zone.chain2, zone.chain3)):
            yz = chain == SEG_YZ
            assert ((lines[..., st] >= 0) == yz).all()
            for d in range(zone.ndir):
                assert lines[d, yz[d], st].tolist() == list(range(
                    int(yz[d].sum())))
        assert sweep_rdma._max_lines(zone) == int(lines.max()) + 1 or \
            lines.max() < 0


def test_wrappers_on_cpu_take_plain_version():
    plan, blocks = _blocks(2, 6, 3)
    before = (sweep_rdma.RDMA_LAUNCHES, sweep_rdma.RING_LAUNCHES)
    for zone, b in zip(plan.zones[:4], blocks):
        ref = sweep_rdma.sweep_zone_rdma_reference(b, zone, UVB, KPC,
                                                   plan.weight)
        for fn in (sweep_rdma.sweep_zone_rdma_kernel,
                   sweep_rdma.sweep_zone_ring_plane_kernel,
                   sweep_rdma.sweep_zone_ring_cluster_kernel):
            assert torch.equal(fn(b, zone, UVB, KPC, plan.weight), ref)
    assert (sweep_rdma.RDMA_LAUNCHES, sweep_rdma.RING_LAUNCHES) == before


# ---------------------------------------------------------------------------
# The RING instances' control flow, replayed on the host
# ---------------------------------------------------------------------------


class _Launch:
    """One ring launch's shared state: staging planes (distributed shared
    memory), halo lines (each row a word of value and sequence number) in
    device memory, the cluster barriers' arrivals, and the slots written."""

    def __init__(self, n_lines):
        self.planes, self.halo = {}, {}
        self.arrived = {}
        self.n_lines = n_lines
        self.written = set()    # (buffer key, slot) written this launch


def _ring_cta(L, rank, cid, crank, item, blocks, tabs, shape, weight, eps):
    """One CTA of the RING instances (rank, work item cid, cluster rank
    crank) as a generator that yields wherever the card may run other
    CTAs: the kernel's stages, barriers and halo lines."""
    ranks, nslab, _, ny, nz = blocks.shape
    lens, chains, lines = tabs
    d0, count, band, _ = item
    csize = shape.csize
    r0, r1 = sweep_cluster.row_bands(ny, csize)[crank]
    pad = UVB[band]
    cluster = (rank, cid)
    n_items = L.n_items
    key_in = lambda g, st: (rank, cid, crank, g, st)          # noqa: E731
    key_out = lambda g, st: (rank + 1, cid, crank, g, st)     # noqa: E731
    barriers = 0

    def barrier():
        nonlocal barriers
        barriers += 1
        L.arrived[cluster] = L.arrived.get(cluster, 0) + 1
        while L.arrived[cluster] < barriers * csize:
            yield

    def seg(i_in, kap, len_n, inv_len_n):
        tau_n = kap * len_n
        a = np.exp(tau_n)
        emi = np.where(tau_n < -eps, (a - 1.0) * (1.0 / kap) * inv_len_n,
                       1.0 + 0.5 * tau_n)
        return i_in * a, i_in * emi

    assert cid < n_items
    carry = np.full((count, r1 - r0, nz), pad)
    acc = np.zeros_like(carry)
    parity = 0
    for i in range(nslab):
        kap = blocks[rank, i, band, r0:r1]
        ln = lens[d0:d0 + count, i]                          # (g, 8)
        for g in range(count):
            carry[g], acc[g] = seg(carry[g], kap, ln[g, 0], ln[g, 4])
        for stage in (1, 2):
            code = chains[d0:d0 + count, i, stage - 1]
            if not code.any():
                break
            line = np.where(code == SEG_YZ,
                            lines[d0:d0 + count, i, stage - 1], -1)
            yz = [g for g in range(count) if line[g] >= 0]
            rows = r1 - r0

            def buf(key, g):
                assert line[g] < L.n_lines
                return L.halo.setdefault((key, line[g]), np.zeros((rows, 2)))
            # the receiver's row threads load their words as the stage
            # begins (value, sequence number; zeroed buffers at launch)
            early = {g: buf(key_in(g, stage), g).copy() for g in yz} \
                if rank > 0 else {}
            L.planes[(rank, cid, crank, parity)] = carry.copy()
            if yz and rank + 1 < ranks:
                # a sender never waits on its receiver: every line has a
                # slot of its own, written once a launch
                for g in yz:
                    slot = (key_out(g, stage), line[g])
                    assert slot not in L.written, slot
                    L.written.add(slot)
                    words = buf(key_out(g, stage), g)
                    for r in range(rows):      # each word on its own
                        words[r] = (carry[g, r, -1], line[g] + 1)
                        yield
            yield from barrier()
            yield
            lines_in = {}
            if yz and rank > 0:
                for g in yz:
                    got = early[g]
                    while (got[:, 1] != line[g] + 1).any():
                        yield
                        got = np.where((got[:, 1] == line[g] + 1)[:, None],
                                       got, buf(key_in(g, stage), g))
                    lines_in[g] = got[:, 0].copy()
            own = L.planes[(rank, cid, crank, parity)]
            lo = (L.planes[(rank, cid, crank - 1, parity)][:, -1:]
                  if crank > 0 else np.full((count, 1, nz), pad))
            j_in = np.concatenate([lo, own[:, :-1]], 1)
            first = np.full((count, r1 - r0, 1), pad)
            for g, vals in lines_in.items():
                first[g, :, 0] = vals
            k_in = np.concatenate([first, own[:, :, :-1]], 2)
            for g in range(count):
                if code[g] == 0:
                    continue
                i_in = j_in[g] if code[g] == SEG_XZ else k_in[g]
                carry[g], lm = seg(i_in, kap, ln[g, stage], ln[g, 4 + stage])
                acc[g] = acc[g] + lm
            parity ^= 1
        dep = (weight * ln[0, 3]) * acc[0]
        for g in range(1, count):
            dep = dep + (weight * ln[g, 3]) * acc[g]
        L.jout[rank, i, band, r0:r1] += dep
        yield
    yield from barrier()


def _replay(blocks, zone, shape, rng, weight):
    """Every CTA of one ring launch interleaved at random (each rank at its
    own speed, so senders run ahead of receivers and behind them); the
    launch's Jmean and shared state."""
    b = blocks.numpy()
    ranks = b.shape[0]
    meta, lens, chains = sweep_cluster.zone_tables(zone, KPC, blocks.dtype,
                                                   "cpu")
    items = sweep_cluster.work_items(meta.numpy(), shape.group)
    lines = sweep_cluster.ring_lines(zone.chain2, zone.chain3)
    L = _Launch(max(1, sweep_rdma._max_lines(zone)))
    L.n_items = len(items)
    L.jout = np.zeros_like(b)
    tabs = (lens.numpy(), chains.numpy(), lines)
    eps = tsweep._tau_eps(blocks.dtype)
    speed = rng.uniform(0.05, 1.0, ranks)
    gens = [(r, _ring_cta(L, r, cid, c, item, b, tabs, shape, weight, eps))
            for r in range(ranks) for cid, item in enumerate(items)
            for c in range(shape.csize)]
    for _ in range(2_000_000):
        if not gens:
            break
        w = np.array([speed[r] for r, _ in gens])
        k = rng.choice(len(gens), p=w / w.sum())
        try:
            next(gens[k][1])
        except StopIteration:
            gens.pop(k)
    assert not gens, f"zone {zone.izone}: the ring did not finish"
    return L


# (P, n, C, G): every (C, G) a rank's plane of these widths takes; n 6
# splits into ragged row bands at C 4
_CASES = [(2, 6, 4, 2), (3, 6, 2, 1), (2, 8, 8, 2), (4, 8, 1, 1),
          (4, 8, 2, 2), (2, 8, 1, 2), (3, 6, 4, 1), (2, 8, 8, 1)]


@pytest.mark.parametrize("p,n,csize,group", _CASES)
def test_ring_control_flow_replayed(p, n, csize, group):
    # under 3 seeds, each on its own zones of level 2 (1-3 directions, so
    # ragged groups at G 2): no deadlock; no slot written twice, so no
    # wait on the right rank; the plain version's result (f64, 1e-12)
    plan, blocks = _blocks(2, n, p)
    shape = sweep_cluster.cluster_shapes(n, n // p, torch.float64, csize,
                                         group, ring=True)[0]
    yz_zones = [k for k, z in enumerate(plan.zones)
                if sweep_rdma._max_lines(z) > 2]
    for seed in range(3):
        rng = np.random.default_rng(seed)
        for k in (yz_zones[seed::3][:1] + [int(rng.integers(24))]):
            zone = plan.zones[k]
            L = _replay(blocks[k], zone, shape, rng, plan.weight)
            if p > 1:
                assert L.written
            ref = sweep_rdma.sweep_zone_rdma_reference(blocks[k], zone, UVB,
                                                       KPC, plan.weight)
            np.testing.assert_allclose(L.jout, ref.numpy(), rtol=1e-12,
                                       err_msg=f"zone {zone.izone}")
