"""The merged sweep with each plane split across a thread-block cluster
and each kappa slab shared by G directions (csrc/sweep_cluster.cu).

The kernel computes what csrc/sweep_merged.cu computes (the JAX package's
core/sweep_pallas.py::_merged_kernel), from the same tables
(sweep_cuda.kernel_tables), with the same plain version
(sweep_cuda.diffuse_sweep_merged_reference).  A work item is one band and
G directions of one merged launch (one axis permutation, one slab order);
a cluster of C CTAs walks its slabs, CTA r holding the rows
[r*ny/C, (r+1)*ny/C) of every plane (`row_bands`).

* `cluster_shapes(ny, nz, dtype, C, G)` — the launch shapes of (C, G), one
  per cells-per-thread, none where the staging planes overflow one CTA's
  shared memory or the registers (carry, logmean and the prefetched slab
  per thread) overflow the register file at every block size.
* `choose_cluster(ny, nz, dtype)` — the size rule: the launch shape the
  H100's measurements favour among those that fit (per dtype), or None,
  and then sweep_cuda.diffuse_sweep_kernel takes csrc/sweep_merged.cu's
  kernel.
  Decided from the shapes before any launch.
* `work_items(meta, G)` — the (first direction, directions, band) of every
  work item.
* One octant zone's sweep (TPU kernel #2) through the same kernel: a zone
  on its rotate_to_sweep-ed (nslab, 3, ny, nz) field is one merged launch
  with the identity permutation and no flips (`zone_tables`), the field's
  slab and band strides passed to the kernel; `choose_cluster` is its
  size rule too, `sweep_zone_cluster_kernel` its wrapper (plain version
  sweep_cuda.sweep_zone_reference; `ZONE_LAUNCHES` counts its launches)
  and `resident_zone_clusters` asks the card how many clusters it holds.
* `diffuse_sweep_cluster_kernel` — launches the kernel on a CUDA tensor
  (or raises), takes the plain version on a CPU tensor; `LAUNCHES` counts
  its launches.  `resident_clusters` asks the
  card how many clusters of a shape it holds at once.
* The halo ring of a 1-D mesh (TPU kernel #3) through the same kernel's
  RING instances (parallel/sweep_rdma.py launches them): `ring_shapes`,
  `ring_clusters` and `choose_ring` (its size rule, with the card's
  resident clusters) and `ring_lines` (each yz stage's line number).
* `build` — compiles csrc/sweep_cluster.cu (core/cuda_build.py) and binds
  it with ctypes.  Nothing is compiled or loaded at import.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..geometry.patterns import SEG_YZ
from . import cuda_build, sweep_cuda
from .sweep import SweepPlan, _tau_eps

# what the kernel is built for: CTAs per cluster (above 8 a non-portable
# cluster size), directions per work item, cells per thread (8 and 16 ran
# slower than 4 at every (C, G) on the H100, PERF.md, and are not built)
CLUSTER_SIZES = (1, 2, 4, 8, 16)
GROUP_SIZES = (1, 2, 4)
CELLS_PER_THREAD = (1, 2, 4)
# the size rule (choose_cluster) by item size: its order of directions per
# work item and its cells per thread
RULE_PREFERENCE = {4: ((2, 1, 4), 4), 8: ((1, 2, 4), 2)}
# the register file of one SM, which one CTA of this kernel fills
_REGS_PER_SM = 65536
# the ring's instances (exact logmean only): directions per work item and
# cells per thread (a ring of 1 cell a thread was never co-resident at
# 128^3 on the H100, PERF.md)
RING_GROUP_SIZES = (1, 2)
RING_CELLS_PER_THREAD = (2, 4)
# registers the ring's line numbers, flag offsets and pointers add per
# thread (csrc/sweep_cluster.cu's RING_REGS)
RING_REGS = 16
# the ring's size rule (choose_ring) by item size: (G, cells per thread)
# in order of preference.  Measured on the H100, each zone's launch alone
# at 128^3 x 192 on 4 ranks in every shape whose ring is co-resident
# (PERF.md): a zone ran fastest at G 1 and 2 cells a thread, then G 1 and
# 4 cells, G 2 and 2, G 2 and 4 (0.45, 0.51, 0.54, 0.65 ms a zone of 5
# directions); a ring is co-resident only where its ranks x work items x
# cells / cpt threads fit the registers, so a zone's shape follows its
# directions.  Float64 rings fit only the smallest zones there
RING_PREFERENCE = {4: ((1, 2), (1, 4), (2, 2), (2, 4)),
                   8: ((1, 2), (1, 4), (2, 2), (2, 4))}
# rt_sweep_cluster's return when no cluster of the shape fits the card
_NOT_SCHEDULABLE = -1

# kernel launches made by diffuse_sweep_cluster_kernel (one per sweep) and
# by sweep_zone_cluster_kernel (one per zone)
LAUNCHES = 0
ZONE_LAUNCHES = 0

_LIB = None


@dataclasses.dataclass(frozen=True)
class ClusterShape:
    """One launch shape: C CTAs per cluster, G directions per work item,
    `cpt` cells per thread, `threads` per CTA and `smem` bytes of staging
    planes per CTA (2 planes per direction of rows_max x nz cells)."""
    csize: int
    group: int
    cpt: int
    threads: int
    smem: int


def max_threads(group: int, cpt: int, itemsize: int,
                ring: bool = False) -> int:
    """The most threads a CTA of (G, cpt) may have (csrc/sweep_cluster.cu's
    max_threads and kRegs, the same formula): the registers a thread needs
    without spilling, ~2.5 G + 4.5 per float32 cell (carry and logmean per
    direction, kappa and 1/kappa of this slab and the next), twice that in
    float64, and ~26 more (~58 in float64), fitted to ptxas -v's counts
    and spills, RING_REGS more in the ring's instances, under the
    per-thread cap each block size leaves; 0 where no block size leaves
    enough (no kernel of such a shape is built)."""
    words = itemsize // 4
    regs = (((5 * group + 9) * cpt * words + 1) // 2 + 26 + 32 * (words - 1)
            + RING_REGS * ring)
    for threads in (1024, 768, 512, 384, 256):
        # ptxas's cap at this block size: the register file over the
        # threads, in steps of 8, at most 255
        if regs <= min(255, _REGS_PER_SM // threads // 8 * 8):
            return threads
    return 0


def row_bands(ny: int, csize: int) -> list[tuple[int, int]]:
    """The rows [r0, r1) of each CTA rank of a cluster."""
    return [(r * ny // csize, (r + 1) * ny // csize) for r in range(csize)]


def cluster_shapes(ny: int, nz: int, dtype: torch.dtype, csize: int,
                   group: int, ring: bool = False) -> list[ClusterShape]:
    """Every launch shape of C = csize, G = group on a ny x nz plane (of
    the ring's instances with `ring`), one per cells-per-thread whose block
    (of at least 128 threads, or the one block a small plane takes) fits
    the register file, fewest cells per thread first; none where there are
    more CTAs than rows or the staging planes exceed one CTA's shared
    memory.  A ring shape also stages its incoming lines (rows_max values
    a direction) and has a thread for every row."""
    if csize not in CLUSTER_SIZES or group not in (
            RING_GROUP_SIZES if ring else GROUP_SIZES):
        raise ValueError(f"no {'ring ' * ring}kernel for C={csize}, "
                         f"G={group}")
    if csize > ny:
        return []
    itemsize = torch.finfo(dtype).bits // 8
    rows_max = -(-ny // csize)
    cells = rows_max * nz
    smem = group * rows_max * (2 * nz + ring) * itemsize
    if smem > sweep_cuda._SMEM_OPTIN_BYTES:
        return []
    shapes = []
    for cpt in RING_CELLS_PER_THREAD if ring else CELLS_PER_THREAD:
        threads = max(32, (-(-cells // cpt) + 31) // 32 * 32)
        if threads <= max_threads(group, cpt, itemsize, ring) and (
                threads >= 128 or not shapes) and (
                not ring or threads >= rows_max):
            shapes.append(ClusterShape(csize, group, cpt, threads, smem))
    return shapes


def choose_cluster(ny: int, nz: int, dtype: torch.dtype
                   ) -> ClusterShape | None:
    """The size rule: of every launch shape that fits, in float32 G = 2
    first (then 1, then 4) and 4 cells per thread, in float64 G = 1 first
    (then 2, then 4) and 2 cells per thread; then the block nearest 512
    threads, the smallest cluster; None where no shape fits.  Measured on
    the H100 (exp_sweep_cluster, PERF.md): in float32 at 128^3 and 256^3 x
    192 every (C, G) with G <= 2 ran fastest at 4 cells per thread, G = 2
    beat G = 1 and G = 4 at either size, and two CTAs of 512 threads per
    SM beat one of 1024; in float64 at 128^3, where a cell's carry and
    logmean take twice the registers, G = 1 at 512 threads x 2 cells ran
    fastest, 1.6x G = 2 at 256 x 4.  One zone's sweep takes the same rule:
    at 128^3 x 192 its 24 launches on sweep_cuda.ZONE_STREAMS streams (as
    the zones sweep runs them) ran fastest in this shape in float32 (C 8,
    G 2, 512 x 4; on one stream, with only 15-33 work items a launch, G = 1
    ran faster) and in float64 (C 16, G 1, 512 x 2) (chip_smoke.py phase
    11, PERF.md)."""
    shapes = [s for c in CLUSTER_SIZES for g in GROUP_SIZES
              for s in cluster_shapes(ny, nz, dtype, c, g)]
    if not shapes:
        return None
    groups, cpt = RULE_PREFERENCE[torch.finfo(dtype).bits // 8]
    return min(shapes, key=lambda s: (groups.index(s.group), s.cpt != cpt,
                                      abs(s.threads - 512), s.csize))


def work_items(meta: np.ndarray, group: int) -> np.ndarray:
    """(n_items, 4) int32 rows (first direction, directions, band, 0): each
    merged launch (a run of equal permutation and slab order in the rows of
    `meta`, sweep_cuda.kernel_tables' dir_meta) split into as few groups of
    at most G consecutive directions as it takes, sized within one of each
    other, times the 3 bands."""
    meta = np.asarray(meta)
    key = meta[:, :2]
    starts = [0] + [d for d in range(1, len(meta))
                    if (key[d] != key[d - 1]).any()] + [len(meta)]
    items = []
    for a, b in zip(starts[:-1], starts[1:]):
        for chunk in np.array_split(np.arange(a, b), -(-(b - a) // group)):
            items += [(int(chunk[0]), len(chunk), band, 0)
                      for band in range(3)]
    return np.asarray(items, dtype=np.int32)


# ---------------------------------------------------------------------------
# Build and launch
# ---------------------------------------------------------------------------


def build() -> ctypes.CDLL:
    """Compile (if this source has not been built yet) and load the kernel
    library; idempotent within a process."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = cuda_build.build("sweep_cluster")["sweep_cluster"]
    p, pp, i, d = (ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                   ctypes.c_int, ctypes.c_double)
    lib.rt_sweep_cluster.argtypes = (
        [i, i, pp, pp, pp] + [p] * 4 + [d] * 7 + [i] * 4
        + [ctypes.c_longlong] * 2 + [i] * 6 + [ctypes.POINTER(i), p])
    lib.rt_sweep_cluster.restype = i
    ll = ctypes.c_longlong
    lib.rt_sweep_cluster_ring.argtypes = (
        [i] + [p] * 10 + [d] * 5 + [i] * 5 + [ll] * 3 + [i, ll, i, ll]
        + [i] * 5 + [ctypes.POINTER(i), p])
    lib.rt_sweep_cluster_ring.restype = i
    lib.rt_cluster_error_string.argtypes = [i]
    lib.rt_cluster_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def _item_table(slot, owner, meta: torch.Tensor, group: int, device):
    return sweep_cuda.device_tables(
        (slot, group), owner, 0.0, torch.int32, device,
        lambda: torch.as_tensor(work_items(meta.cpu().numpy(), group),
                                device=device))


def _run(fields, tables, uvb, weight: float, logmean: str, dims, strides,
         shape: ClusterShape, query_only: bool) -> int:
    """One rt_sweep_cluster call on the current device: fields (kappa,
    1/kappa, Jmean lists, one tensor per axis permutation), tables
    (dir_meta, lens, chains, items), dims (nslab, ny, nz) and strides (slab,
    band, in elements).  The library checks the shape's block against the
    plane and its registers, and asks the card whether such a cluster can
    be scheduled, before any launch.  Returns the clusters of the shape the
    card holds at once; raises on a refused launch."""
    if shape.group not in GROUP_SIZES or shape.cpt not in CELLS_PER_THREAD:
        raise ValueError(f"no kernel for {shape}")
    lib = build()
    kperm, ikperm, jperm = fields
    meta, lens, chains, items = tables
    dtype, device = kperm[0].dtype, kperm[0].device
    occupancy = (ctypes.c_int * 2)()
    rc = lib.rt_sweep_cluster(
        0 if dtype == torch.float32 else 1, len(kperm),
        sweep_cuda.pointer_array(kperm), sweep_cuda.pointer_array(ikperm),
        sweep_cuda.pointer_array(jperm), meta.data_ptr(), lens.data_ptr(),
        chains.data_ptr(), items.data_ptr(), *sweep_cuda.uvb_floats(uvb),
        weight, _tau_eps(dtype), sweep_cuda._A_EPS,
        1.0 / sweep_cuda._EPS_CL, items.shape[0], *dims, *strides,
        int(logmean == "clamped"), shape.csize, shape.group, shape.cpt,
        shape.threads, int(query_only), occupancy,
        torch.cuda.current_stream(device).cuda_stream)
    if rc == _NOT_SCHEDULABLE:
        query = lib.rt_cluster_error_string(occupancy[1]).decode()
        raise RuntimeError(
            f"cluster sweep kernel refused: a cluster of {shape.csize} CTAs "
            f"x {shape.threads} threads cannot be scheduled on the card "
            f"({occupancy[0]} resident clusters; occupancy query: {query})")
    if rc != 0:
        raise RuntimeError(f"cluster sweep kernel launch failed: "
                           f"{lib.rt_cluster_error_string(rc).decode()} "
                           f"({rc})")
    return occupancy[0]


def _call(kappa, plan: SweepPlan, uvb, cell_size, logmean: str,
          shape: ClusterShape, query_only: bool):
    """The merged sweep through rt_sweep_cluster: (Jmean or None, resident
    clusters)."""
    sweep_cuda.check_sweep_field(kappa, plan)
    n = plan.nslab
    dtype, device = kappa.dtype, kappa.device
    with torch.cuda.device(device):
        perms, meta, lens, chains = sweep_cuda.kernel_tables(
            plan, cell_size, dtype, device)
        items = _item_table("cluster_items", plan, meta, shape.group, device)
        if query_only:
            # nothing is launched: the field stands in for every buffer
            jmean = None
            fields = ([kappa] * len(perms),) * 3
        else:
            jmean, *fields = sweep_cuda.launch_buffers(kappa, logmean, perms)
        resident = _run(fields, (meta, lens, chains, items), uvb, plan.weight,
                        logmean, (n, n, n), (n * n, n ** 3), shape,
                        query_only)
    if query_only:
        return None, resident
    return sweep_cuda.gather_jmean(jmean, fields[2], perms), resident


def diffuse_sweep_cluster_kernel(kappa, plan: SweepPlan, uvb, cell_size,
                                 logmean: str = "exact",
                                 shape: ClusterShape | None = None
                                 ) -> torch.Tensor:
    """Full multi-direction sweep: (3, n, n, n) kappa -> (3, n, n, n)
    Jmean.  A CPU tensor takes sweep_cuda.diffuse_sweep_merged_reference; a
    CUDA tensor (float32 or float64) launches the cluster kernel in `shape`
    (choose_cluster's by default), or raises where the shape does not fit
    the plane or cannot be scheduled, before any launch."""
    global LAUNCHES
    if logmean not in ("exact", "clamped"):
        raise ValueError(f"unknown logmean {logmean!r}")
    if kappa.device.type == "cpu":
        return sweep_cuda.diffuse_sweep_merged_reference(
            kappa, plan, uvb, cell_size, logmean)
    if shape is None:
        n = plan.nslab
        shape = choose_cluster(n, n, kappa.dtype)
        if shape is None:
            raise ValueError(f"no cluster shape fits a {n}^3 {kappa.dtype} "
                             f"plane")
    jmean, _ = _call(kappa, plan, uvb, cell_size, logmean, shape, False)
    LAUNCHES += 1
    return jmean


def resident_clusters(kappa, plan: SweepPlan, cell_size,
                      shape: ClusterShape) -> int:
    """How many clusters of `shape` the card holds at once
    (cudaOccupancyMaxActiveClusters); launches nothing.  `cell_size` is the
    sweep's, so the cached tables stay those of its launches."""
    return _call(kappa, plan, np.zeros(3), cell_size, "exact", shape,
                 True)[1]


# ---------------------------------------------------------------------------
# One zone's sweep (TPU kernel #2) through the same kernel
# ---------------------------------------------------------------------------


def zone_tables(zone, cell_size: float, dtype, device):
    """One zone's tables in the cluster kernel's form, kept in the zone's
    slot: dir_meta (D, 4) int32 of zeros (one merged launch: the identity
    permutation, no reversal, no flips; the field is rotated already), lens
    (D, nslab, 8) as kernel_tables' (-len*cell x3, 1/n_active,
    -1/(len*cell) x3, pad) and chains (D, nslab, 2).  The lengths times
    the cell size are taken in float64 and rounded once, as the plain
    version's (sweep_cuda.scaled_zone) are, so a segment's tau rounds as
    its tau does: in float32 an ulp of tau moves exp(-tau) by an ulp,
    which the exact logmean's 1 - exp(-tau) magnifies by 1/tau (7.9e-5 of
    Jmean at 128^3 with kernel_tables' float32 product)."""
    def make():
        lens, chains = sweep_cuda.zone_launch_tables(zone)
        lens = lens * np.array([-cell_size] * 3 + [1.0]
                               + [-1.0 / cell_size] * 3 + [0.0])
        return (torch.zeros((zone.ndir, 4), dtype=torch.int32, device=device),
                torch.as_tensor(np.swapaxes(lens, 0, 1).astype(
                    sweep_cuda.numpy_dtype(dtype)), device=device),
                torch.as_tensor(np.swapaxes(chains, 0, 1).copy(),
                                device=device))
    return sweep_cuda.device_tables(("cluster_zone", zone.izone), zone,
                                    cell_size, dtype, device, make)


def _zone_call(kappa_rot, zone, uvb, cell_size, weight, shape: ClusterShape,
               query_only: bool):
    """One zone through rt_sweep_cluster: (weighted Jmean or None, resident
    clusters).  The rotated field (nslab, 3, ny, nz) has slab stride
    3*ny*nz and band stride ny*nz."""
    sweep_cuda.check_device_field(kappa_rot)
    nslab, nb, ny, nz = kappa_rot.shape
    if nb != 3 or nslab != zone.len_xy.shape[1]:
        raise ValueError(f"kappa_rot shape {tuple(kappa_rot.shape)} does not "
                         f"match the zone's {zone.len_xy.shape[1]} slabs x 3 "
                         f"bands")
    dtype, device = kappa_rot.dtype, kappa_rot.device
    with torch.cuda.device(device):
        meta, lens, chains = zone_tables(zone, cell_size, dtype, device)
        items = _item_table(("cluster_zone_items", zone.izone), zone, meta,
                            shape.group, device)
        if query_only:
            jout = None
            fields = ([kappa_rot],) * 3
        else:
            jout = torch.zeros_like(kappa_rot)
            fields = ([kappa_rot],
                      [sweep_cuda._inv_kappa(kappa_rot, "exact")], [jout])
        resident = _run(fields, (meta, lens, chains, items), uvb,
                        float(weight), "exact", (nslab, ny, nz),
                        (3 * ny * nz, ny * nz), shape, query_only)
    return jout, resident


def sweep_zone_cluster_kernel(kappa_rot, zone, uvb, cell_size, weight,
                              shape: ClusterShape | None = None
                              ) -> torch.Tensor:
    """One zone's sweep, sweep_cuda.sweep_zone_kernel's function: (nslab,
    3, ny, nz) rotated kappa -> (nslab, 3, ny, nz) weighted Jmean, the
    exact logmean.  A CPU tensor takes sweep_cuda.sweep_zone_reference; a
    CUDA tensor (float32 or float64) launches the cluster kernel in `shape`
    (choose_cluster's by default), or raises where the shape does not
    fit the plane or cannot be scheduled, before any launch."""
    global ZONE_LAUNCHES
    if kappa_rot.device.type == "cpu":
        return sweep_cuda.sweep_zone_reference(kappa_rot, zone, uvb,
                                               cell_size, weight)
    if shape is None:
        sweep_cuda.check_device_field(kappa_rot)
        ny, nz = kappa_rot.shape[2:]
        shape = choose_cluster(ny, nz, kappa_rot.dtype)
        if shape is None:
            raise ValueError(f"no cluster shape fits a {ny} x {nz} "
                             f"{kappa_rot.dtype} plane")
    jout, _ = _zone_call(kappa_rot, zone, uvb, cell_size, weight, shape,
                         False)
    ZONE_LAUNCHES += 1
    return jout


def resident_zone_clusters(kappa_rot, zone, cell_size,
                           shape: ClusterShape) -> int:
    """How many clusters of `shape` the card holds at once for one zone's
    launch; launches nothing."""
    return _zone_call(kappa_rot, zone, np.zeros(3), cell_size, 1.0, shape,
                      True)[1]


# ---------------------------------------------------------------------------
# The halo ring of a 1-D mesh (TPU kernel #3) through the RING instances
# ---------------------------------------------------------------------------


def ring_shapes(ny: int, nz: int, dtype: torch.dtype) -> list[ClusterShape]:
    """Every launch shape of the ring's instances on a rank's ny x nz
    k-block plane (cluster_shapes with ring=True), by C, then G."""
    return [s for c in CLUSTER_SIZES for g in RING_GROUP_SIZES
            for s in cluster_shapes(ny, nz, dtype, c, g, ring=True)]


def ring_clusters(ranks: int, ndir: int, group: int) -> int:
    """Clusters of one ring launch: ranks x work items (3 bands x the
    zone's directions in groups of at most G)."""
    return ranks * 3 * -(-ndir // group)


def choose_ring(ny: int, nz: int, ranks: int, ndir: int, dtype: torch.dtype,
                resident) -> ClusterShape | None:
    """The ring's size rule: of the launch shapes whose ranks x work items
    clusters the card holds at once (`resident(shape)`: the card's
    cudaOccupancyMaxActiveClusters for the shape), the first in
    RING_PREFERENCE's order of (G, cells per thread), then the block
    nearest 256 threads, then the smallest cluster; None where no shape
    fits or none can be co-resident."""
    fits = [s for s in ring_shapes(ny, nz, dtype)
            if ring_clusters(ranks, ndir, s.group) <= resident(s)]
    if not fits:
        return None
    order = RING_PREFERENCE[torch.finfo(dtype).bits // 8]

    def rank(s):
        pair = (s.group, s.cpt)
        return (order.index(pair) if pair in order else len(order),
                abs(s.threads - 256), s.csize)
    return min(fits, key=rank)


def ring_lines(chain2: np.ndarray, chain3: np.ndarray) -> np.ndarray:
    """(D, nslab) chain codes of segments 2 and 3 (a zone's, in slab order)
    -> (D, nslab, 2) int32: at a yz segment its line number, the count of
    yz segments of that direction and stage before it; -1 elsewhere."""
    yz = np.stack([np.asarray(chain2), np.asarray(chain3)], -1) == SEG_YZ
    return np.where(yz, np.cumsum(yz, axis=1) - 1, -1).astype(np.int32)
