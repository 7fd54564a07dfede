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
