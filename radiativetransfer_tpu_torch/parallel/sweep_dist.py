"""The explicit sweeps of a 1-D grid mesh, in plain PyTorch.

Counterpart of the JAX package's parallel/sweep_dist.py (1-D mesh, no
sparse zones).  The mesh's P ranks all live on one device
(parallel/mesh.py), so what the JAX package does with shard_map and
collectives is written out over a leading rank axis:

1. `diffuse_sweep_pipelined` -- grid decomposition.  Per octant zone the
   rotated opacity is cut into P k-blocks (mesh.to_blocks) and the slab scan
   advances in lockstep on all of them; only the in-slab upwind `yz` shift
   crosses a block edge: rank r's first k-column is rank r-1's last, from
   the same slab and chain segment (the JAX package's ppermute), and rank 0
   takes the UVB.  It is the plain version of the ring kernel
   (parallel/sweep_rdma.py), which computes the same function.
2. `diffuse_sweep_zone_parallel` -- angle decomposition.  The 24 zones are
   dealt round-robin to the ranks; each rank sweeps its zones over the
   whole field with the per-zone sweep (sweep_cuda.sweep_zone_kernel, TPU
   kernel #2 on the card, its plain version on the CPU), and the ranks'
   sums are added in rank order (the psum).

Both match core.sweep.diffuse_sweep to float rounding.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import sweep_cuda
from ..core.sweep import SweepPlan, ZoneBatch, sweep_zone
from .mesh import GridMesh, from_blocks, to_blocks


def _halo_shift_k(x, boundary):
    """The yz shift across k-blocks: x is (ndir, P, 3, ny, nz/P); rank r's
    first k-column is rank r-1's last, rank 0's the boundary."""
    first = torch.cat([boundary[:, :1], x[:, :-1, ..., -1:]], dim=1)
    return torch.cat([first, x[..., :-1]], dim=-1)


def sweep_zone_halo(blocks, zone: ZoneBatch, uvb, cell_size,
                    weight) -> torch.Tensor:
    """One zone's slab scan on the P k-blocks in lockstep (the JAX
    package's _sweep_zone_halo, 1-D): (P, nslab, 3, ny, nz/P) rotated
    opacity -> (P, nslab, 3, ny, nz/P) weighted Jmean.  The arithmetic of
    core.sweep.sweep_zone, whose yz shift it replaces."""
    uvb = torch.as_tensor(uvb, dtype=blocks.dtype, device=blocks.device)
    j = sweep_zone(blocks.transpose(0, 1), zone, uvb, cell_size, weight,
                   shift_k=_halo_shift_k)
    return j.transpose(0, 1).contiguous()


def zone_by_zone_on_blocks(block_fn, kappa, plan: SweepPlan, uvb, cell_size,
                           mesh: GridMesh) -> torch.Tensor:
    """core.sweep.diffuse_sweep's loop over zones, each zone's rotated field
    cut into the mesh's k-blocks for block_fn and joined after:
    (3, n, n, n) kappa -> (3, n, n, n) Jmean."""
    def zone_fn(krot, zone, uvb, cell_size, weight):
        return from_blocks(block_fn(to_blocks(krot, mesh), zone, uvb,
                                    cell_size, weight))
    return sweep_cuda.zone_by_zone(zone_fn, kappa, plan, uvb, cell_size)


def diffuse_sweep_pipelined(kappa, plan: SweepPlan, uvb, cell_size,
                            mesh: GridMesh) -> torch.Tensor:
    """Grid-decomposed sweep with per-slab halo lines, plain PyTorch.
    Args as core.sweep.diffuse_sweep's; ValueError when the mesh's ranks do
    not divide the grid's last axis."""
    return zone_by_zone_on_blocks(sweep_zone_halo, kappa, plan, uvb,
                                  cell_size, mesh)


def diffuse_sweep_zone_parallel(kappa, plan: SweepPlan, uvb, cell_size,
                                mesh: GridMesh) -> torch.Tensor:
    """Angle-decomposed sweep: rank r sweeps zones r, r + P, ... of the
    plan with the per-zone sweep; the ranks' Jmean are summed in rank
    order.  Args as core.sweep.diffuse_sweep's."""
    p = mesh.n_ranks
    return sum(sweep_cuda.zone_by_zone(
        sweep_cuda.sweep_zone_kernel, kappa,
        dataclasses.replace(plan, zones=plan.zones[r::p]), uvb, cell_size)
        for r in range(p))
