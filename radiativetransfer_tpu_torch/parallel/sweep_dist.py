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
   kernel #2 on the card, its plain version on the CPU; on the card several
   zones in flight at once), and the ranks' sums are added in rank order
   (the psum).
3. `diffuse_sweep_sparse_zones` -- angle decomposition of the block-sparse
   L-level sweep (core/sweep_sparse.py).  Each direction count's zones are
   padded to a multiple of P with copies scaled by 0 and dealt to the ranks
   in contiguous runs; each rank sums its zones' contributions, and the
   ranks' sums are added in rank order.

The first two match core.sweep.diffuse_sweep, the third
core.sweep_sparse.diffuse_sweep_sparse, to float rounding.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import sweep_cuda, sweep_multilevel, sweep_sparse
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
    # every rank's zones may start once kappa is written: several zones in
    # flight across the ranks (sweep_cuda.zone_by_zone on a CUDA tensor)
    ready = torch.cuda.current_stream(kappa.device).record_event() \
        if kappa.is_cuda else None
    return sum(sweep_cuda.zone_by_zone(
        sweep_cuda.sweep_zone_kernel, kappa,
        dataclasses.replace(plan, zones=plan.zones[r::p]), uvb, cell_size,
        streams=sweep_cuda.ZONE_STREAMS, ready=ready)
        for r in range(p))


def _rank_sum(parts):
    """The ranks' tensors added in rank order."""
    acc = parts[0]
    for x in parts[1:]:
        acc = acc + x
    return acc


def diffuse_sweep_sparse_zones(k0, lv_kappas, state, plan, uvb, cell_size,
                               mesh: GridMesh,
                               n_coupling_iters: int =
                               sweep_multilevel.N_COUPLING_ITERS,
                               eager_rounds: bool = False, window="auto"):
    """Angle-decomposed block-sparse L-level sweep: args and result as
    core.sweep_sparse.diffuse_sweep_sparse's, (J0 (3, n, n, n), [J blocks
    (3, nb, be, be, be) of each refined level]).

    The JAX package's units are its direction chunks (build_chunks); here
    they are the plan's zones.  Each group of equal direction count is
    padded to a multiple of P with copies of its first zone scaled by 0
    and dealt to the ranks in contiguous runs, as shard_map deals the JAX
    package's chunks; each rank adds its zones' contributions, in its
    run's order, into an accumulator of its own, and the ranks'
    accumulators are added in rank order (the psum).  The order of the adds
    therefore differs from the JAX package's, and from the one-device
    sweep's: the three agree to float rounding (ROADMAP section 3).  While
    the ranks share one device they share its zone batches too (sized as
    diffuse_sweep_sparse sizes them, over the padded group): a batch may
    hold several ranks' zones, and its launches serve them all, which cut
    the rank's own batches to a quarter of the zones at P = 4 and the sweep
    ran 1.9x (128^3) to 3.6x (64^3) slower on one card (PERF.md).  A round
    is one batch; eager_rounds synchronizes the device after each (the JAX
    package's bounded dispatches), with the same values."""
    L = plan.n_levels
    if state.n_levels != L or len(lv_kappas) != L - 1:
        raise ValueError(f"a {state.n_levels}-level state and "
                         f"{len(lv_kappas)} block opacities for a {L}-level "
                         f"plan")
    if isinstance(window, str) and window == "auto":
        window = sweep_sparse.compute_window(state)
    n, p = state.n, mesh.n_ranks
    dtype, device = k0.dtype, k0.device
    ctx = sweep_sparse.build_ctx(k0, lv_kappas, state)
    zone_bytes = sweep_sparse._sparse_zone_bytes(
        state, None if window is None else window[0])
    accs = [(torch.zeros_like(ctx[0]),
             [torch.zeros_like(k) for k in lv_kappas]) for _ in range(p)]
    groups: dict[int, list] = {}
    for zone in plan.zones:
        groups.setdefault(zone.ndir, []).append(zone)
    for ndir, zones in groups.items():
        pad = (-len(zones)) % p
        units = zones + [zones[0]] * pad
        scales = [1.0] * len(zones) + [0.0] * pad
        m = len(units) // p                   # rank r's run: [r m, (r+1) m)
        size = sweep_multilevel._zones_per_batch((n, n, n), L, ndir, dtype,
                                                 device, zone_bytes)
        for lo in range(0, len(units), size):     # one round: a batch
            batch = units[lo:lo + size]
            for u, (c0, cb) in enumerate(sweep_sparse.zone_contributions(
                    batch, ctx, window, uvb, cell_size, plan.weight,
                    n_coupling_iters), start=lo):
                r, sc = u // m, scales[u]
                if sc != 1.0:
                    c0, cb = c0 * sc, [c * sc for c in cb]
                j0_r, jb_r = accs[r]
                accs[r] = (j0_r + c0, [a + c for a, c in zip(jb_r, cb)])
            if eager_rounds and device.type == "cuda":
                torch.cuda.synchronize(device)
    j0 = _rank_sum([a[0] for a in accs])
    jbs = [_rank_sum([a[1][ell] for a in accs]) for ell in range(L - 1)]
    return torch.movedim(j0, -1, 0), jbs
