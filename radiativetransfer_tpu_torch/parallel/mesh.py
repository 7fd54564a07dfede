"""The 1-D grid mesh: P ranks over the grid's last axis, on one device.

Counterpart of the JAX package's parallel/mesh.py, 1-D part only.  There a
mesh is a `jax.sharding.Mesh` of devices and a sharding constraint cuts a
field into per-device blocks; here a `GridMesh` is P virtual ranks that all
live on the one device the caller names (the card by default, the CPU for
the tests), and `to_blocks` / `from_blocks` do the cutting: a rotated
(nslab, 3, ny, nz) field becomes (P, nslab, 3, ny, nz/P), each rank's
k-block contiguous.  On the card the ring sweep (parallel/sweep_rdma.py)
runs every rank's CTAs in one launch and passes the halo lines through
device memory.

The nested states go on a mesh as the JAX package places them
(shard_amr_state, shard_multilevel_state, shard_sparse_state), every tensor
on the mesh's device; a block-sparse state's block counts are padded to a
multiple of P (amr_sparse.pad_blocks_to_multiple) as there.  The JAX
package's block_sharding and replicated have no counterpart: while every
rank shares one device, a tensor cut over the block axis or copied to
every rank is the tensor itself, and `to_blocks` is the rank view where a
path needs one.

Left out (ROADMAP, Distribution): ranks on several devices, 2-D and 3-D meshes
and the multi-process runtime (`maybe_initialize_distributed`).
"""

from __future__ import annotations

import dataclasses

import torch

# the JAX package's name of the axis a 1-D mesh decomposes (the grid's last)
AXIS_NAME = "gz"

_NOT_PORTED = "not ported yet: ROADMAP, Distribution"


@dataclasses.dataclass(frozen=True)
class GridMesh:
    """P ranks over the grid's last axis, all on `device`."""
    n_ranks: int
    device: torch.device
    axis_name: str = AXIS_NAME


def maybe_initialize_distributed(*args, **kwargs) -> bool:
    """The multi-process runtime of the JAX package's mesh module."""
    raise NotImplementedError(f"multi-process meshes are {_NOT_PORTED}")


def make_grid_mesh(n_devices: int | None = None,
                   shape: tuple[int, ...] | None = None, *,
                   device: torch.device | str = "cuda") -> GridMesh:
    """A 1-D mesh of `n_devices` ranks (or `shape=(P,)`), every rank on
    `device`.  n_devices None: one rank."""
    if shape is not None:
        if len(shape) > 1:
            raise NotImplementedError(
                f"{len(shape)}-D meshes are {_NOT_PORTED}")
        n_devices = shape[0]
    if isinstance(device, (list, tuple)):
        raise NotImplementedError(f"ranks on more than one device are "
                                  f"{_NOT_PORTED}")
    n = 1 if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one rank, got {n}")
    return GridMesh(n_ranks=n, device=torch.device(device))


def check_divides(mesh: GridMesh, nz: int) -> int:
    """nz / P, or ValueError when the mesh's P ranks do not divide nz."""
    if nz % mesh.n_ranks:
        raise ValueError(f"{mesh.n_ranks} ranks do not divide the grid's "
                         f"last axis ({nz} cells)")
    return nz // mesh.n_ranks


def shard_state(state, mesh: GridMesh):
    """The FieldState on the mesh's device (every rank's block of every
    field lies there); ValueError when P does not divide nz."""
    check_divides(mesh, state.shape[-1])
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).to(mesh.device)
        for f in dataclasses.fields(state)
        if torch.is_tensor(getattr(state, f.name))})


def shard_species(species, mesh: GridMesh):
    """The chemistry_noneq.SpeciesState on the mesh's device, as
    shard_state places a FieldState (all its tensors share the (nx, ny, nz)
    grid shape); ValueError when P does not divide nz."""
    check_divides(mesh, species.HI.shape[-1])
    return dataclasses.replace(species, **{
        f.name: getattr(species, f.name).to(mesh.device)
        for f in dataclasses.fields(species)})


def _on_device(x, mesh: GridMesh):
    return x.to(mesh.device) if torch.is_tensor(x) else x


def shard_amr_state(state, mesh: GridMesh):
    """A core.amr.AMRState on the mesh's device: the base and fine
    FieldStates as shard_state places them (P divides n, so a rank's
    base cells own their fine children) and the refined map beside them;
    ValueError when P does not divide either level's last axis."""
    return dataclasses.replace(
        state, base=shard_state(state.base, mesh),
        fine=shard_state(state.fine, mesh),
        refined=_on_device(state.refined, mesh))


def shard_multilevel_state(state, mesh: GridMesh):
    """A core.amr.MultiLevelState on the mesh's device: every level's
    FieldState as shard_state places it and each refined map beside its
    level; ValueError when P does not divide a level's last axis."""
    from ..core.amr import MultiLevelState
    return MultiLevelState(
        levels=tuple(shard_state(lv, mesh) for lv in state.levels),
        refined=tuple(_on_device(r, mesh) for r in state.refined))


def shard_sparse_state(state, mesh: GridMesh):
    """A core.amr_sparse.SparseMLState on the mesh's device: the base
    FieldState as shard_state places it (ValueError when P does not divide
    its last axis), every refined level's block count padded with zero
    padding blocks to a multiple of P (amr_sparse.pad_blocks_to_multiple,
    the JAX package's division of the block axis), its blocks, slot map
    and origins on the device."""
    from ..core.amr_sparse import _tree_map, pad_blocks_to_multiple
    base = shard_state(state.base, mesh)
    state = pad_blocks_to_multiple(state, mesh.n_ranks)
    return dataclasses.replace(
        state, base=base, refined0=_on_device(state.refined0, mesh),
        levels=tuple(dataclasses.replace(
            lv, fields=_tree_map(lambda x: _on_device(x, mesh), lv.fields),
            slot=_on_device(lv.slot, mesh),
            origin=_on_device(lv.origin, mesh),
            cover=_on_device(lv.cover, mesh),
            refined=_on_device(lv.refined, mesh))
            for lv in state.levels))


def shard_sparse_species(species, mesh: GridMesh):
    """A block-sparse noneq run's species (one SpeciesState a level,
    level 0 dense, the refined levels' block-shaped) on the mesh's device:
    level 0 as shard_species places it, each refined level's blocks padded
    with zero blocks to a multiple of P, as shard_sparse_state pads the
    fields."""
    from ..core.amr_sparse import _tree_map, pad_blocks
    p = mesh.n_ranks

    def blocks(spc):
        extra = (-spc.HI.shape[0]) % p
        return _tree_map(lambda x: _on_device(pad_blocks(x, extra), mesh),
                         spc)
    return (shard_species(species[0], mesh),
            *(blocks(spc) for spc in species[1:]))


def to_blocks(x: torch.Tensor, mesh: GridMesh) -> torch.Tensor:
    """(..., nz) -> (P, ..., nz/P), rank r's k-block [r*nz/P, (r+1)*nz/P)
    contiguous."""
    nz_loc = check_divides(mesh, x.shape[-1])
    p = mesh.n_ranks
    split = x.reshape(*x.shape[:-1], p, nz_loc)
    return torch.movedim(split, -2, 0).contiguous()


def from_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """(P, ..., nz/P) -> (..., nz): the inverse of to_blocks."""
    joined = torch.movedim(blocks, 0, -2)
    return joined.reshape(*joined.shape[:-2], -1)
