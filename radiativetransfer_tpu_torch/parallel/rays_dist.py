"""The source-parallel point-source tracers of a 1-D grid mesh.

Counterpart of the JAX package's parallel/rays_dist.py.  There the merged
source list is sharded over the devices: each device traces its own
sources through an all-gathered copy of the fields, and the deposits are
reduce-scattered (psum_scatter) back onto the grid decomposition, the
block-sparse ones psum-reduced.  Here the mesh's P ranks all live on one
device (parallel/mesh.py), so every rank's fields already lie where its
rays read them and its deposits already lie where the chemistry reads
them: no all-gather and no reduce-scatter appears.  What stays of the
source split is the JAX package's host-driven form ("per-shard partial
deposit accumulators ... summed over shards only at the very end", its
_trace_sparse_host_dist):

* the sources are padded to a multiple of P with zero-weight dummies at
  the box centre (pad_sources), and rank r traces the r-th run of
  S_padded / P of them;
* ONE march serves every rank (rays._trace_all_phases and
  rays_multilevel._trace_all_phases_ml with n_ranks): each deposit
  channel is one rank-major (P * ncell,) accumulator, a ray of source s
  depositing into rank s // (S_padded / P)'s slice, and the slices are
  summed in rank order at the end (the psum).  Its launches a march step
  do not grow with P, and the lanes of rank r are the contiguous slice a
  card of its own would hold;
* the deposits come back as whole fields on the mesh's device, as the
  mesh's states hold them (mesh.to_blocks is their rank view), and the
  diagnostics are trimmed to the real sources.

Each rank's slice is the single-device trace of its sources; with one rank
the tracers are the single-device ones, bit for bit.  The states are the
mesh's (mesh.shard_state and its nested counterparts): every tensor on the
mesh's device, where the deposits come back.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..constants import MAX_PIXEL_LEVEL, NO_DUST
from ..core import amr, rays, rays_multilevel
from ..core.rays import RayDiagnostics, SourceBatch
from .mesh import GridMesh


def pad_sources(sources: SourceBatch, n_shards: int) -> tuple[SourceBatch,
                                                               int]:
    """The batch padded to a multiple of n_shards with zero-weight dummies
    at the box centre (they march but deposit nothing), and the real
    source count."""
    s = sources.n_sources
    pad = (-s) % n_shards
    if pad == 0:
        return sources, s
    return SourceBatch(
        position=np.concatenate([sources.position, np.full((pad, 3), 0.5)]),
        weight=np.concatenate([sources.weight, np.zeros(pad)]),
        table_idx=np.concatenate([sources.table_idx,
                                  np.zeros(pad, sources.table_idx.dtype)]),
    ), s


def _trim(diag: RayDiagnostics, n_real: int) -> RayDiagnostics:
    """The diagnostics of the real sources (the padding's last)."""
    if diag.ndot_remaining.shape[0] == n_real:
        return diag
    return dataclasses.replace(diag, **{
        f.name: getattr(diag, f.name)[:n_real]
        for f in dataclasses.fields(diag)})


def _rates_mode(tables, rates_mode: str) -> str:
    if rates_mode == "auto":
        rates_mode = "quadrature" if "quad_A" in tables else "table"
    if rates_mode not in ("table", "quadrature", "quadrature_noneq"):
        raise ValueError(f"unknown rates_mode {rates_mode!r}")
    return rates_mode


def _spawn(padded: SourceBatch, dtype, device, n: int):
    """Phase 1's rays of every rank, at their sources' cells."""
    state = rays._spawn_phase(padded, 1, dtype, device)
    return dataclasses.replace(state, cell=torch.clamp(
        (state.pos * n).to(torch.int32), 0, n - 1))


def trace_point_sources_dist(state_fields, geom, sources: SourceBatch,
                             tables, mesh: GridMesh,
                             dust_approximation: int = NO_DUST,
                             max_pixel_level: int = MAX_PIXEL_LEVEL,
                             dtype=torch.float32, rates_mode: str = "auto",
                             n_bands: int = 3):
    """The source-parallel rays.trace_point_sources: (RateFields over the
    whole (n^3,) grid on the mesh's device, RayDiagnostics of the real
    sources).  state_fields: a FieldState (mesh.shard_state's)."""
    padded, n_real = pad_sources(sources, mesh.n_ranks)
    fields = {k: getattr(state_fields, name).reshape(-1).to(dtype)
              for k, name in (("HI", "HI"), ("HeI", "HeI"),
                              ("HeII", "HeII"), ("nH", "nh"),
                              ("abun2", "abun2"))}
    rf, diag = rays._trace_all_phases(
        fields, _spawn(padded, dtype, state_fields.HI.device, geom.nx),
        tables, geom, padded.n_sources, dust_approximation,
        max_pixel_level, dtype, _rates_mode(tables, rates_mode), n_bands,
        n_ranks=mesh.n_ranks)
    return rf, _trim(diag, n_real)


def _trace_ml_dist(addressing, geom, sources: SourceBatch, tables,
                   mesh: GridMesh, dust_approximation: int,
                   max_pixel_level: int, dtype, rates_mode: str,
                   chunk_steps: int = 0):
    """The L-level source-parallel trace of either storage's addressing
    (rays_multilevel.dense_addressing, sparse_addressing)."""
    padded, n_real = pad_sources(sources, mesh.n_ranks)
    rfs, diag = rays_multilevel._trace(
        *addressing, geom, padded, tables, dust_approximation,
        max_pixel_level, dtype, _rates_mode(tables, rates_mode), None,
        None, chunk_steps, mesh.n_ranks)
    return rfs, _trim(diag, n_real)


def trace_point_sources_ml_dist(ml_state, geom, sources: SourceBatch,
                                tables, mesh: GridMesh,
                                dust_approximation: int = NO_DUST,
                                max_pixel_level: int = MAX_PIXEL_LEVEL,
                                dtype=torch.float32,
                                rates_mode: str = "auto"):
    """The source-parallel rays_multilevel.trace_point_sources_ml: (tuple
    of per-level RateFields, level l's flat (n*2^l)^3 on the mesh's device,
    RayDiagnostics of the real sources).  ml_state: a MultiLevelState
    (mesh.shard_multilevel_state's)."""
    return _trace_ml_dist(
        rays_multilevel.dense_addressing(ml_state, geom.nx), geom, sources,
        tables, mesh, dust_approximation, max_pixel_level, dtype,
        rates_mode)


def trace_point_sources_amr_dist(amr_state, geom, sources: SourceBatch,
                                 tables, mesh: GridMesh,
                                 dust_approximation: int = NO_DUST,
                                 max_pixel_level: int = MAX_PIXEL_LEVEL,
                                 dtype=torch.float32,
                                 rates_mode: str = "auto"):
    """The source-parallel rays_amr.trace_point_sources_amr: the L-level
    tracer at L = 2, as the single-device one (RateFields base (n^3,),
    RateFields fine ((2n)^3,), RayDiagnostics of the real sources);
    amr_state: an AMRState (mesh.shard_amr_state's)."""
    mode = _rates_mode(tables, rates_mode)
    if mode == "quadrature_noneq":
        raise ValueError(f"unknown rates_mode {rates_mode!r} for the "
                         f"two-level tracer")
    (rfb, rff), diag = trace_point_sources_ml_dist(
        amr.MultiLevelState(levels=(amr_state.base, amr_state.fine),
                            refined=(amr_state.refined,)),
        geom, sources, tables, mesh, dust_approximation, max_pixel_level,
        dtype, mode)
    return rfb, rff, diag


def trace_point_sources_sparse_dist(sp_state, geom, sources: SourceBatch,
                                    tables, mesh: GridMesh,
                                    dust_approximation: int = NO_DUST,
                                    max_pixel_level: int = MAX_PIXEL_LEVEL,
                                    dtype=torch.float32,
                                    rates_mode: str = "auto",
                                    host_phases: bool = False,
                                    chunk_steps: int = 512):
    """The source-parallel rays_multilevel.trace_point_sources_sparse:
    (tuple of per-level RateFields, level 0's flat (n^3,), a refined
    level's block-flat (nb*be^3,), on the mesh's device; RayDiagnostics of
    the real sources).  host_phases reads one alive count over every
    rank's rays every chunk_steps march steps and fills
    rays_multilevel.LAST_TRACE_PHASE_TIMES, as the single-device tracer
    does (the JAX package's _trace_sparse_host_dist: one cross-shard count
    a chunk)."""
    if host_phases and chunk_steps < 1:
        raise ValueError(f"chunk_steps must be positive, not {chunk_steps}")
    return _trace_ml_dist(
        rays_multilevel.sparse_addressing(sp_state), geom, sources, tables, mesh, dust_approximation,
        max_pixel_level, dtype, rates_mode,
        chunk_steps if host_phases else 0)
