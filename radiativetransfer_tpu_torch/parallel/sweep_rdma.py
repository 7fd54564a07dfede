"""The halo-ring sweep of a 1-D grid mesh as a hand-written CUDA kernel.

Counterpart of the JAX package's parallel/sweep_rdma.py (TPU kernel #3,
`_sweep_zone_rdma_kernel`): per octant zone, each rank's k-block of the
rotated field is swept by the per-zone sweep, and the exit columns of the
in-slab yz segments travel to the right rank as halo lines.  The mesh's
ranks all live on one device (parallel/mesh.py), so one launch runs every
rank and passes the lines through device memory with release/acquire
flags.  Two kernels compute it:

* the cluster ring (csrc/sweep_cluster.cu's RING instances, the design of
  the merged and per-zone sweeps): a thread-block cluster per (rank, work
  item), the rank's plane split by rows across the cluster, each CTA
  sending and receiving only its rows of the halo columns, G directions
  per CTA; `sweep_zone_ring_cluster_kernel`, its size rule
  core/sweep_cluster.py's `choose_ring` with the card's resident
  clusters (`resident_ring_clusters`).  `RING_LAUNCHES` counts its
  launches;
* the plane ring (csrc/sweep_rdma.cu): one CTA per (rank, direction,
  band) holding the rank's whole plane;
  `sweep_zone_ring_plane_kernel`, taken where no cluster shape fits or a
  plane memory is asked for.  `RDMA_LAUNCHES` counts its launches.

* `sweep_zone_rdma_kernel` -- one zone: (P, nslab, 3, ny, nz/P) blocks ->
  the same shape of weighted Jmean.  A CUDA tensor launches the cluster
  ring where its size rule finds a shape, else the plane ring, or raises (a
  grid that cannot be co-resident, a wait of the ring that ran out of
  time); a CPU tensor takes the plain version.
* `sweep_zone_rdma_reference` -- its plain version: the pipelined lockstep
  scan (sweep_dist.sweep_zone_halo) on the kernel's own tables.
* `diffuse_sweep_rdma` -- the whole sweep, one launch per zone.
* `halo_bytes` -- the lines' bytes, for the kernel's bound.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..core import cuda_build, sweep_cluster, sweep_cuda
from ..core.sweep import SweepPlan, _tau_eps
from ..geometry.patterns import SEG_YZ
from .mesh import GridMesh
from .sweep_dist import sweep_zone_halo, zone_by_zone_on_blocks

# kernel launches, one per zone: the plane ring (sweep_zone_ring_plane_kernel)
# and the cluster ring (sweep_zone_ring_cluster_kernel)
RDMA_LAUNCHES = 0
RING_LAUNCHES = 0
# clock64 cycles one wait of the ring may take (~8.7 s at 1.98 GHz) before
# the kernel gives up and the wrapper raises: a wait the protocol
# satisfies takes microseconds
SPIN_BUDGET_CYCLES = 1 << 34
# cudaErrorCooperativeLaunchTooLarge: the grid cannot be co-resident
_NOT_CO_RESIDENT = 720
# rt_sweep_cluster_ring's return when no cluster of the shape fits the card
_NOT_SCHEDULABLE = -1

_LIB = None
# resident clusters of a cluster ring shape, by (shape, dtype, device)
_RESIDENT: dict = {}
# ring_rule's answers: a sweep asks for every zone, and the rule's Python
# took long enough for the card to wait on the host
_RULES: dict = {}


def build() -> ctypes.CDLL:
    """Compile (if not built yet) and load csrc/sweep_rdma.cu."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = cuda_build.build("sweep_rdma")["sweep_rdma"]
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.rt_sweep_zone_rdma.argtypes = ([i] + [p] * 8 + [d] * 5
                                       + [ctypes.c_longlong] + [i] * 6
                                       + [p, p])
    lib.rt_sweep_zone_rdma.restype = i
    lib.rt_rdma_error_string.argtypes = [i]
    lib.rt_rdma_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def sweep_zone_rdma_reference(blocks, zone, uvb, cell_size,
                              weight) -> torch.Tensor:
    """The ring kernel's plain version, on any device: the lockstep scan of
    sweep_dist.sweep_zone_halo on the zone's lengths times the cell size,
    taken in float64 before the cast to the field's type, as the kernel's
    tables (sweep_cuda.zone_arrays) and the JAX kernel's are."""
    return sweep_zone_halo(blocks, sweep_cuda.scaled_zone(zone, cell_size),
                           uvb, 1.0, weight)


def check_status(status: torch.Tensor) -> None:
    """Raise when a ring kernel launched with `status` ran out of time in a
    wait (reading it waits for those launches)."""
    if int(status.item()) != 0:
        raise RuntimeError(
            f"ring protocol timeout: a halo-line wait of the ring sweep "
            f"kernel took more than {SPIN_BUDGET_CYCLES} cycles")


def sweep_zone_rdma_kernel(blocks, zone, uvb, cell_size, weight,
                           plane_memory: str = "auto",
                           status: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """One zone's ring sweep on P k-blocks: (P, nslab, 3, ny, nz/P) rotated
    kappa -> the same shape of weighted Jmean.

    A CPU tensor takes sweep_zone_rdma_reference.  A CUDA tensor (float32
    or float64) launches the cluster ring in the shape of its size rule
    (ring_rule) or, where none fits or plane_memory is not "auto" ("shared"
    or "global"), the plane ring (sweep_zone_ring_plane_kernel); either
    raises rather than run a ring that cannot be co-resident.  status: a
    zeroed int32 device tensor that the kernel marks when a wait runs out
    of time; the caller checks it (check_status) after its launches.
    Without one the wrapper makes one and checks it after this launch,
    which waits for the kernel."""
    if blocks.device.type == "cpu":
        return sweep_zone_rdma_reference(blocks, zone, uvb, cell_size, weight)
    shape = None
    if plane_memory == "auto":
        _check_blocks(blocks, zone)
        shape = ring_rule(blocks.shape[0], *blocks.shape[3:], zone.ndir,
                          blocks.dtype, blocks.device)
    if shape is None:
        return sweep_zone_ring_plane_kernel(blocks, zone, uvb, cell_size,
                                            weight, plane_memory, status)
    return sweep_zone_ring_cluster_kernel(blocks, zone, uvb, cell_size,
                                          weight, shape, status)


def _check_blocks(blocks, zone) -> None:
    sweep_cuda.check_device_field(blocks)
    if blocks.dim() != 5 or blocks.shape[2] != 3 or \
            blocks.shape[1] != zone.len_xy.shape[1]:
        raise ValueError(f"blocks shape {tuple(blocks.shape)} does not match "
                         f"the zone's {zone.len_xy.shape[1]} slabs x 3 bands")


def _raise_refused(rc: int, what: str, detail: str, error_string) -> None:
    """Raise on a launch refused (rc: a cudaError_t of the library whose
    error_string names it)."""
    if rc == _NOT_CO_RESIDENT:
        raise RuntimeError(
            f"{what} refused: its {detail} cannot be co-resident on the "
            f"card, and a ring whose CTAs are not all resident can hang")
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{error_string(rc).decode()} ({rc})")


def sweep_zone_ring_plane_kernel(blocks, zone, uvb, cell_size, weight,
                                 plane_memory: str = "auto",
                                 status: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """One zone's ring sweep through the plane ring (csrc/sweep_rdma.cu: one
    CTA per rank, direction and band, every rank's CTAs in one cooperative
    launch); sweep_zone_rdma_kernel's function and arguments.
    plane_memory: "auto" (by the rank's plane, ny x nz/P), "shared" or
    "global"."""
    global RDMA_LAUNCHES
    if blocks.device.type == "cpu":
        return sweep_zone_rdma_reference(blocks, zone, uvb, cell_size, weight)
    _check_blocks(blocks, zone)
    ranks, nslab, _, ny, nz = blocks.shape
    dtype, device = blocks.dtype, blocks.device
    plane_memory = sweep_cuda.resolve_plane_memory(plane_memory, ny, dtype, nz)
    lib = build()
    own_status = status is None
    with torch.cuda.device(device):
        if own_status:
            status = torch.zeros(1, dtype=torch.int32, device=device)
        lens, chains = sweep_cuda.zone_tables(zone, cell_size, dtype, device)
        jout = torch.zeros_like(blocks)
        ctas = ranks * zone.ndir * 3
        scratch = (torch.empty(ctas * 3 * ny * nz, dtype=dtype, device=device)
                   if plane_memory == "global" else None)
        halo = torch.empty(ctas * 4 * ny, dtype=dtype, device=device)
        flags = torch.zeros(2 * ctas * 4, dtype=torch.int32, device=device)
        info = (ctypes.c_int * 2)()
        rc = lib.rt_sweep_zone_rdma(
            0 if dtype == torch.float32 else 1, blocks.data_ptr(),
            jout.data_ptr(), lens.data_ptr(), chains.data_ptr(),
            None if scratch is None else scratch.data_ptr(), halo.data_ptr(),
            flags.data_ptr(), status.data_ptr(), *sweep_cuda.uvb_floats(uvb),
            float(weight), _tau_eps(dtype), SPIN_BUDGET_CYCLES, ranks,
            zone.ndir, nslab, ny, nz, int(plane_memory == "shared"), info,
            torch.cuda.current_stream(device).cuda_stream)
    _raise_refused(rc, "ring sweep kernel",
                   f"{ctas} CTAs (at most {info[1]} of {info[0]} threads)",
                   lib.rt_rdma_error_string)
    RDMA_LAUNCHES += 1
    if own_status:
        check_status(status)
    return jout


def _ring_call(blocks, zone, uvb, cell_size, weight, shape, status,
               query_only: bool, hold=(-1, 0)):
    """One rt_sweep_cluster_ring call on the current device: (Jmean or
    None, the return code, the resident clusters)."""
    lib = sweep_cluster.build()
    dtype, device = blocks.dtype, blocks.device
    ranks, nslab, _, ny, nz = blocks.shape
    occupancy = (ctypes.c_int * 2)()
    if query_only:      # nothing launched: one rank of one work item
        args = [None] * 10 + [0.0] * 5 + [1, 1, nslab, ny, nz]
        args += [0, 3 * ny * nz, ny * nz, 1, 0, -1, 0]
        jout = None
    else:
        meta, lens, chains = sweep_cluster.zone_tables(zone, cell_size,
                                                       dtype, device)
        items = sweep_cluster._item_table(
            ("cluster_zone_items", zone.izone), zone, meta, shape.group,
            device)
        lines = sweep_cuda.device_tables(
            ("ring_lines", zone.izone), zone, 0.0, torch.int32, device,
            lambda: torch.as_tensor(sweep_cluster.ring_lines(
                zone.chain2, zone.chain3), device=device))
        n_lines = max(1, _max_lines(zone))
        n_items = items.shape[0]
        # per (rank, item, CTA, direction slot, stage): a slot for each of
        # its n_lines lines of rows_max values, each value as 64-bit words
        # of 32 bits and the line's sequence number
        buffers = ranks * n_items * shape.csize * shape.group * 2
        words = torch.finfo(dtype).bits // 32
        halo = torch.zeros(buffers * n_lines * -(-ny // shape.csize) * words,
                           dtype=torch.int64, device=device)
        inv = sweep_cuda._inv_kappa(blocks, "exact")
        jout = torch.zeros_like(blocks)
        args = [blocks.data_ptr(), inv.data_ptr(), jout.data_ptr(),
                meta.data_ptr(), lens.data_ptr(), chains.data_ptr(),
                items.data_ptr(), lines.data_ptr(), halo.data_ptr(),
                status.data_ptr(),
                *sweep_cuda.uvb_floats(uvb), float(weight), _tau_eps(dtype),
                n_items, ranks, nslab, ny, nz]
        args += [nslab * 3 * ny * nz, 3 * ny * nz, ny * nz, n_lines,
                 SPIN_BUDGET_CYCLES, *hold]
    rc = lib.rt_sweep_cluster_ring(
        0 if dtype == torch.float32 else 1, *args, shape.csize, shape.group,
        shape.cpt, shape.threads, int(query_only), occupancy,
        torch.cuda.current_stream(device).cuda_stream)
    if rc == _NOT_SCHEDULABLE and not query_only:  # a query answers 0
        query = lib.rt_cluster_error_string(occupancy[1]).decode()
        raise RuntimeError(
            f"cluster ring sweep kernel refused: a cluster of {shape.csize} "
            f"CTAs x {shape.threads} threads cannot be scheduled on the card"
            f" ({occupancy[0]} resident clusters; occupancy query: {query})")
    return jout, rc, occupancy[0]


def _max_lines(zone) -> int:
    """The most halo lines one direction of the zone sends at one stage."""
    return int(max((np.asarray(zone.chain2) == SEG_YZ).sum(axis=1).max(),
                   (np.asarray(zone.chain3) == SEG_YZ).sum(axis=1).max()))


def resident_ring_clusters(shape: sweep_cluster.ClusterShape, dtype, device,
                           ny: int, nz: int) -> int:
    """How many clusters of the cluster ring's `shape` the card holds at
    once (cudaOccupancyMaxActiveClusters, asked once per shape, dtype and
    device); launches nothing."""
    key = (shape, dtype, str(device))
    if key not in _RESIDENT:
        with torch.cuda.device(device):
            blocks = torch.empty((1, 1, 3, ny, nz), dtype=dtype,
                                 device=device)
            _RESIDENT[key] = _ring_call(blocks, None, None, 0.0, 0.0, shape,
                                        None, True)[2]
    return _RESIDENT[key]


def ring_rule(ranks: int, ny: int, nz: int, ndir: int, dtype, device
              ) -> sweep_cluster.ClusterShape | None:
    """sweep_cluster.choose_ring on a rank's ny x nz plane with the card's
    resident clusters, kept once found."""
    key = (ranks, ny, nz, ndir, dtype, str(device),
           sweep_cluster.RING_PREFERENCE[torch.finfo(dtype).bits // 8])
    if key not in _RULES:
        _RULES[key] = sweep_cluster.choose_ring(
            ny, nz, ranks, ndir, dtype,
            lambda s: resident_ring_clusters(s, dtype, device, ny, nz))
    return _RULES[key]


def sweep_zone_ring_cluster_kernel(blocks, zone, uvb, cell_size, weight,
                                   shape: sweep_cluster.ClusterShape
                                   | None = None,
                                   status: torch.Tensor | None = None,
                                   hold: tuple[int, int] = (-1, 0)
                                   ) -> torch.Tensor:
    """One zone's ring sweep through the cluster ring (csrc/sweep_cluster.cu,
    RING instances); sweep_zone_rdma_kernel's function.  A CPU tensor takes
    sweep_zone_rdma_reference; a CUDA tensor (float32 or float64) launches
    the kernel in `shape` (ring_rule's by default), or raises where the
    shape does not fit the plane or its ranks x work items clusters cannot
    be co-resident, before any launch.  status as sweep_zone_rdma_kernel's.
    hold: (rank, clock64 cycles) by which that rank's CTAs start late, for
    tests of the timeout."""
    global RING_LAUNCHES
    if blocks.device.type == "cpu":
        return sweep_zone_rdma_reference(blocks, zone, uvb, cell_size, weight)
    _check_blocks(blocks, zone)
    ranks, _, _, ny, nz = blocks.shape
    dtype, device = blocks.dtype, blocks.device
    if shape is None:
        shape = ring_rule(ranks, ny, nz, zone.ndir, dtype, device)
        if shape is None:
            raise ValueError(f"no cluster ring shape fits {ranks} ranks of a "
                             f"{ny} x {nz} {dtype} plane")
    own_status = status is None
    with torch.cuda.device(device):
        if own_status:
            status = torch.zeros(1, dtype=torch.int32, device=device)
        jout, rc, resident = _ring_call(blocks, zone, uvb, cell_size, weight,
                                        shape, status, False, hold)
    if rc != 0:
        clusters = sweep_cluster.ring_clusters(ranks, zone.ndir, shape.group)
        _raise_refused(rc, "cluster ring sweep kernel",
                       f"{clusters} clusters of {shape.csize} CTAs x "
                       f"{shape.threads} threads (the card holds "
                       f"{resident})",
                       sweep_cluster.build().rt_cluster_error_string)
    RING_LAUNCHES += 1
    if own_status:
        check_status(status)
    return jout


def diffuse_sweep_rdma(kappa, plan: SweepPlan, uvb, cell_size,
                       mesh: GridMesh, plane_memory: str = "auto"
                       ) -> torch.Tensor:
    """Grid-decomposed sweep with the ring kernel: per zone rotate_to_zone,
    mesh.to_blocks, sweep_zone_rdma_kernel (the cluster ring in the shape
    its size rule finds for the zone, else the plane ring), mesh.from_blocks
    and rotate_from_sweep, one zone after another.  (3, n, n, n) kappa ->
    (3, n, n, n) Jmean; the plain version on a CPU tensor.  On a CUDA
    tensor the launches mark one status, checked once at the end.  (Zones
    in flight on side streams, as the zones strategy runs them, did not
    hold a gain for the rings on the H100: PERF.md.)"""
    status = (torch.zeros(1, dtype=torch.int32, device=kappa.device)
              if kappa.is_cuda else None)
    jmean = zone_by_zone_on_blocks(
        functools.partial(sweep_zone_rdma_kernel, plane_memory=plane_memory,
                          status=status),
        kappa, plan, uvb, cell_size, mesh)
    if status is not None:
        check_status(status)
    return jmean


def diffuse_sweep_rdma_reference(kappa, plan: SweepPlan, uvb, cell_size,
                                 mesh: GridMesh) -> torch.Tensor:
    """The plain version of diffuse_sweep_rdma, on any device."""
    return zone_by_zone_on_blocks(sweep_zone_rdma_reference, kappa, plan, uvb,
                                  cell_size, mesh)


def halo_bytes(plan: SweepPlan, n_ranks: int, ny: int, itemsize: int) -> int:
    """Bytes of halo lines one sweep moves: for every active yz chained
    segment of a direction and slab, each of the P - 1 rank edges writes
    one line of ny values per band and reads it back."""
    yz = sum(int(np.count_nonzero(z.chain2 == SEG_YZ)
                 + np.count_nonzero(z.chain3 == SEG_YZ)) for z in plan.zones)
    return 2 * 3 * (n_ranks - 1) * ny * itemsize * yz
