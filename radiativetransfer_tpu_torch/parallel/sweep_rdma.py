"""The halo-ring sweep of a 1-D grid mesh as a hand-written CUDA kernel.

Counterpart of the JAX package's parallel/sweep_rdma.py (TPU kernel #3,
`_sweep_zone_rdma_kernel`): per octant zone, each rank's k-block of the
rotated field is swept by the per-zone sweep, and the exit columns of the
in-slab yz segments travel to the right rank as halo lines, with ACKs
gating the reuse of 2-slot buffers.  The mesh's ranks all live on one
device (parallel/mesh.py), so the kernel (csrc/sweep_rdma.cu) runs every
rank's CTAs in one cooperative launch and passes the lines through device
memory with release/acquire flags.

* `sweep_zone_rdma_kernel` -- one zone: (P, nslab, 3, ny, nz/P) blocks ->
  the same shape of weighted Jmean.  A CUDA tensor launches the kernel, or
  raises (a grid that cannot be co-resident, a wait of the ring that ran
  out of time); a CPU tensor takes the plain version.  `RDMA_LAUNCHES`
  counts the launches.
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

from ..core import cuda_build, sweep_cuda
from ..core.sweep import SweepPlan, _tau_eps
from ..geometry.patterns import SEG_YZ
from .mesh import GridMesh
from .sweep_dist import sweep_zone_halo, zone_by_zone_on_blocks

# kernel launches made by sweep_zone_rdma_kernel (one per zone)
RDMA_LAUNCHES = 0
# clock64 cycles one wait of the ring may take (~8.7 s at 1.98 GHz) before
# the kernel gives up and the wrapper raises: a wait the protocol
# satisfies takes microseconds
SPIN_BUDGET_CYCLES = 1 << 34
# cudaErrorCooperativeLaunchTooLarge: the grid cannot be co-resident
_NOT_CO_RESIDENT = 720

_LIB = None


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

    A CPU tensor takes sweep_zone_rdma_reference; a CUDA tensor launches the
    kernel (float32 or float64), or raises.  status: a zeroed int32 device
    tensor that the kernel marks when a wait runs out of time; the caller
    checks it (check_status) after its launches.  Without one the wrapper
    makes one and checks it after this launch, which waits for the kernel.
    plane_memory: "auto" (by the rank's plane, ny x nz/P), "shared" or
    "global"."""
    global RDMA_LAUNCHES
    if blocks.device.type == "cpu":
        return sweep_zone_rdma_reference(blocks, zone, uvb, cell_size, weight)
    sweep_cuda.check_device_field(blocks)
    ranks, nslab, nb, ny, nz = blocks.shape
    if nb != 3 or nslab != zone.len_xy.shape[1]:
        raise ValueError(f"blocks shape {tuple(blocks.shape)} does not match "
                         f"the zone's {zone.len_xy.shape[1]} slabs x 3 bands")
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
    if rc == _NOT_CO_RESIDENT:
        raise RuntimeError(
            f"ring sweep kernel refused: its {ctas} CTAs cannot be "
            f"co-resident on the card (at most {info[1]} of {info[0]} "
            f"threads), and a ring whose CTAs are not all resident can hang")
    if rc != 0:
        raise RuntimeError(f"ring sweep kernel launch failed: "
                           f"{lib.rt_rdma_error_string(rc).decode()} ({rc})")
    RDMA_LAUNCHES += 1
    if own_status:
        check_status(status)
    return jout


def diffuse_sweep_rdma(kappa, plan: SweepPlan, uvb, cell_size,
                       mesh: GridMesh, plane_memory: str = "auto"
                       ) -> torch.Tensor:
    """Grid-decomposed sweep with the ring kernel: per zone rotate_to_zone,
    mesh.to_blocks, sweep_zone_rdma_kernel, mesh.from_blocks and
    rotate_from_sweep.  (3, n, n, n) kappa -> (3, n, n, n) Jmean; one launch
    per zone on a CUDA tensor, checked for timeouts once at the end; the
    plain version on a CPU tensor."""
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
