"""Checkpoints of the state containers, torch-native.

Counterpart of the JAX package's io/checkpoint.py, name for name.  The
reference checkpoints one HDF4 file per iteration and restarts from it
(writeIonization/readLatestIonization, equiSources.f90:4797-4912,
4738-4795); the grid STRUCTURE is never checkpointed -- it is rebuilt from
the input and only the state is restored.  A checkpoint keeps that
contract: the directory `ckptNNNN` holds the state container's tensors and
the `ftte_meta.json` sidecar (itime, physical_box_size, the first tensor's
shape and any extra meta), the JAX package's names and values.

What differs: the JAX package saves the leaves with orbax; here each
process writes its tensors to one file of its own, `leaves_rank{r}.pt`, a
torch.save of a flat dict keyed by each tensor's dataclass path ("base.rho",
"levels.0.fields.HI"; a tuple's entries by their index, "1.HI" for the
species of a (state, species) pair), read back with
torch.load(weights_only=True).  Neither package restores the other's
checkpoints (ROADMAP section 3); io/snapshot.py's cellArray files are the
format both read.

A container is a FieldState, AMRState, MultiLevelState, SparseMLState,
SpeciesState, or a tuple of them (a noneq run's (state, species), a nested
run's species a level); optional fields left None stay None.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re

import torch

_META = "ftte_meta.json"


class TreeMismatch(ValueError):
    """The checkpoint holds another container than the one to restore into
    (its tensors' paths differ): for example a fields-only checkpoint read
    as a noneq run's (state, species)."""


def checkpoint_name(itime: int, directory: str = ".") -> str:
    """Step-numbered checkpoint directory, the analog of cellArrayNNNN
    (equiSources.f90:4838-4843)."""
    return os.path.join(os.path.abspath(directory), f"ckpt{itime:04d}")


def flatten(tree, prefix: str = "") -> dict:
    """{dataclass path: tensor} of a container, in field order (what a
    checkpoint file holds); None entries are left out, as a JAX pytree
    leaves them out."""
    if torch.is_tensor(tree):
        return {prefix: tree}
    if tree is None:
        return {}
    if dataclasses.is_dataclass(tree):
        items = [(f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree)]
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), x) for i, x in enumerate(tree)]
    else:
        raise TypeError(f"not a container of tensors: {type(tree).__name__}"
                        f" at {prefix or 'the root'}")
    out = {}
    for name, x in items:
        out.update(flatten(x, f"{prefix}.{name}" if prefix else name))
    return out


def _rebuild(like, leaves: dict, prefix: str = ""):
    """`like` with each tensor replaced by leaves[its path]."""
    if torch.is_tensor(like):
        return leaves[prefix]
    if like is None:
        return None
    if dataclasses.is_dataclass(like):
        return dataclasses.replace(like, **{
            f.name: _rebuild(getattr(like, f.name), leaves,
                             f"{prefix}.{f.name}" if prefix else f.name)
            for f in dataclasses.fields(like)})
    return type(like)(_rebuild(x, leaves, f"{prefix}.{i}" if prefix
                               else str(i)) for i, x in enumerate(like))


def _rank() -> int:
    dist = torch.distributed
    return (dist.get_rank()
            if dist.is_available() and dist.is_initialized() else 0)


def _leaves_file(path: str, rank: int) -> str:
    return os.path.join(path, f"leaves_rank{rank}.pt")


def save_sharded(path: str, state, itime: int, physical_box_size: float,
                 extra_meta: dict | None = None) -> None:
    """Save a state container: this process's tensors to its
    leaves_rank{r}.pt (host copies), then the metadata sidecar, each
    through a temporary name, so a checkpoint that latest_checkpoint finds
    is whole."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    leaves = flatten(state)
    if not leaves:
        raise ValueError("the container holds no tensor")
    rank = _rank()
    target = _leaves_file(path, rank)
    torch.save({k: v.detach().cpu() for k, v in leaves.items()},
               target + ".tmp")
    os.replace(target + ".tmp", target)
    if rank != 0:
        return
    meta = {"itime": int(itime),
            "physical_box_size": float(physical_box_size),
            "shape": list(next(iter(leaves.values())).shape)}
    if extra_meta:
        meta.update(extra_meta)
    with open(os.path.join(path, _META + ".tmp"), "w") as fh:
        json.dump(meta, fh)
    os.replace(os.path.join(path, _META + ".tmp"), os.path.join(path, _META))


def restore_sharded(path: str, like_state, mesh=None):
    """Restore a checkpoint into the structure of like_state (for example a
    state freshly built from the input grid: the reference's
    rebuild-then-restore restart), each tensor onto its like tensor's
    device.  With a mesh (parallel.mesh.GridMesh) the container goes
    through parallel.mesh's shard functions: shard_state, shard_species,
    shard_amr_state, shard_multilevel_state, shard_sparse_state (a
    block-sparse noneq run's species through shard_sparse_species, their
    blocks padded as the state's are), a tuple entry by entry.  Returns
    (state, meta dict).

    TreeMismatch when the checkpoint's tensor paths differ from
    like_state's; ValueError when a tensor's shape or dtype does; a
    truncated or corrupt file raises torch.load's error."""
    path = os.path.abspath(path)
    like = flatten(like_state)
    saved = torch.load(_leaves_file(path, _rank()), map_location="cpu",
                       weights_only=True)
    if saved.keys() != like.keys():
        missing = sorted(like.keys() - saved.keys())
        extra = sorted(saved.keys() - like.keys())
        raise TreeMismatch(f"{path} holds another container: missing "
                           f"{missing[:4]}{'...' if len(missing) > 4 else ''}"
                           f", unexpected {extra[:4]}"
                           f"{'...' if len(extra) > 4 else ''}")
    leaves = {}
    for k, x in like.items():
        v = saved[k]
        if v.shape != x.shape or v.dtype != x.dtype:
            raise ValueError(f"{path}: {k} is {v.dtype} {tuple(v.shape)}, "
                             f"the state's {x.dtype} {tuple(x.shape)}")
        leaves[k] = v.to(x.device)
    with open(os.path.join(path, _META)) as fh:
        meta = json.load(fh)
    state = _rebuild(like_state, leaves)
    if mesh is not None:
        state = _shard(state, mesh)
    return state, meta


def _shard(state, mesh):
    from ..core.amr import AMRState, MultiLevelState
    from ..core.amr_sparse import SparseMLState
    from ..core.chemistry_noneq import SpeciesState
    from ..core.state import FieldState
    from ..parallel import mesh as pmesh
    place = {FieldState: pmesh.shard_state, SpeciesState: pmesh.shard_species,
             AMRState: pmesh.shard_amr_state,
             MultiLevelState: pmesh.shard_multilevel_state,
             SparseMLState: pmesh.shard_sparse_state}
    if type(state) in place:
        return place[type(state)](state, mesh)
    if (isinstance(state, tuple) and len(state) == 2
            and isinstance(state[0], SparseMLState)):
        return (pmesh.shard_sparse_state(state[0], mesh),
                pmesh.shard_sparse_species(state[1], mesh))
    if isinstance(state, tuple):
        return tuple(_shard(x, mesh) for x in state)
    raise TypeError(f"not a state container: {type(state).__name__}")


def latest_checkpoint(directory: str = ".") -> str | None:
    """Newest ckptNNNN directory with its metadata sidecar (restart
    counterpart of io.snapshot.latest_snapshot)."""
    best, best_i = None, -1
    if not os.path.isdir(directory):
        return None
    for name in os.listdir(directory):
        m = re.fullmatch(r"ckpt(\d{4,})", name)
        full = os.path.join(directory, name)
        if m and os.path.isdir(full) and os.path.exists(
                os.path.join(full, _META)):
            if int(m.group(1)) > best_i:
                best, best_i = full, int(m.group(1))
    return best
