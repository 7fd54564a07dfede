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
* `diffuse_sweep_cluster_kernel` — launches the kernel on a CUDA tensor
  (or raises), takes the plain version on a CPU tensor; `LAUNCHES` counts
  its launches.  `resident_clusters` asks the
  card how many clusters of a shape it holds at once.
* `build` — compiles csrc/sweep_cluster.cu (core/cuda_build.py) and binds
  it with ctypes.  Nothing is compiled or loaded at import.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

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
# rt_sweep_cluster's return when no cluster of the shape fits the card
_NOT_SCHEDULABLE = -1

# kernel launches made by diffuse_sweep_cluster_kernel
LAUNCHES = 0

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


def max_threads(group: int, cpt: int, itemsize: int) -> int:
    """The most threads a CTA of (G, cpt) may have (csrc/sweep_cluster.cu's
    max_threads and kRegs, the same formula): the registers a thread needs
    without spilling, ~2.5 G + 4.5 per float32 cell (carry and logmean per
    direction, kappa and 1/kappa of this slab and the next), twice that in
    float64, and ~26 more (~58 in float64), fitted to ptxas -v's counts
    and spills, under the per-thread cap each block size leaves; 0 where
    no block size leaves enough (no kernel of such a shape is built)."""
    words = itemsize // 4
    regs = ((5 * group + 9) * cpt * words + 1) // 2 + 26 + 32 * (words - 1)
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
                   group: int) -> list[ClusterShape]:
    """Every launch shape of C = csize, G = group on a ny x nz plane, one
    per cells-per-thread whose block (of at least 128 threads, or the one
    block a small plane takes) fits the register file, fewest cells per
    thread first; none where there are more CTAs than rows or the staging
    planes exceed one CTA's shared memory."""
    if csize not in CLUSTER_SIZES or group not in GROUP_SIZES:
        raise ValueError(f"no kernel for C={csize}, G={group}")
    if csize > ny:
        return []
    itemsize = torch.finfo(dtype).bits // 8
    cells = -(-ny // csize) * nz
    smem = 2 * group * cells * itemsize
    if smem > sweep_cuda._SMEM_OPTIN_BYTES:
        return []
    shapes = []
    for cpt in CELLS_PER_THREAD:
        threads = max(32, (-(-cells // cpt) + 31) // 32 * 32)
        if threads <= max_threads(group, cpt, itemsize) and (
                threads >= 128 or not shapes):
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
    fastest, 1.6x G = 2 at 256 x 4."""
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
    lib.rt_sweep_cluster.argtypes = ([i, i, pp, pp, pp] + [p] * 4 + [d] * 7
                                     + [i] * 10 + [ctypes.POINTER(i), p])
    lib.rt_sweep_cluster.restype = i
    lib.rt_cluster_error_string.argtypes = [i]
    lib.rt_cluster_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def _item_table(plan: SweepPlan, meta: torch.Tensor, group: int, device):
    return sweep_cuda.device_tables(
        ("cluster_items", group), plan, 0.0, torch.int32, device,
        lambda: torch.as_tensor(work_items(meta.cpu().numpy(), group),
                                device=device))


def _call(kappa, plan: SweepPlan, uvb, cell_size, logmean: str,
          shape: ClusterShape, query_only: bool):
    """One rt_sweep_cluster call: (Jmean or None, resident clusters).  The
    library checks the shape's block against the plane and its registers,
    and asks the card whether such a cluster can be scheduled, before any
    launch."""
    sweep_cuda.check_sweep_field(kappa, plan)
    if shape.group not in GROUP_SIZES or shape.cpt not in CELLS_PER_THREAD:
        raise ValueError(f"no kernel for {shape}")
    n = plan.nslab
    lib = build()
    dtype, device = kappa.dtype, kappa.device
    with torch.cuda.device(device):
        perms, meta, lens, chains = sweep_cuda.kernel_tables(
            plan, cell_size, dtype, device)
        items = _item_table(plan, meta, shape.group, device)
        if query_only:
            # nothing is launched: the field stands in for every buffer
            kperm = ikperm = jperm = [kappa] * len(perms)
        else:
            jmean, kperm, ikperm, jperm = sweep_cuda.launch_buffers(
                kappa, logmean, perms)
        occupancy = (ctypes.c_int * 2)()
        rc = lib.rt_sweep_cluster(
            0 if dtype == torch.float32 else 1, len(perms),
            sweep_cuda.pointer_array(kperm), sweep_cuda.pointer_array(ikperm),
            sweep_cuda.pointer_array(jperm), meta.data_ptr(),
            lens.data_ptr(), chains.data_ptr(), items.data_ptr(),
            *sweep_cuda.uvb_floats(uvb), plan.weight, _tau_eps(dtype),
            sweep_cuda._A_EPS, 1.0 / sweep_cuda._EPS_CL, items.shape[0], n,
            n, n, int(logmean == "clamped"), shape.csize, shape.group,
            shape.cpt, shape.threads, int(query_only), occupancy,
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
    if query_only:
        return None, occupancy[0]
    return sweep_cuda.gather_jmean(jmean, jperm, perms), occupancy[0]


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
