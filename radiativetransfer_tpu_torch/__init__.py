"""radiativetransfer_tpu_torch — the PyTorch/CUDA port of
radiativetransfer_tpu, module for module.

Modes 9 (UVB-only diffuse transfer + equilibrium chemistry), 6, 8 (point
sources + UVB) and 1 (point sources under the thin UVB) on a uniform grid
on one device.  The diffuse sweep runs as a hand-written CUDA kernel on a
CUDA device (core/sweep_cuda.py) and as a plain PyTorch slab scan on the
CPU (core/sweep.py); the point-source tracer (core/rays.py) is PyTorch.
Every mode also runs on a 1-D grid mesh of P ranks on one device
(parallel/mesh.py), with the pipelined, zones or ring sweep
(parallel/sweep_dist.py, parallel/sweep_rdma.py; the ring is a CUDA
kernel on the card) and the source-parallel tracer
(parallel/rays_dist.py).  In every one of these the non-equilibrium
9-species network (core/chemistry_noneq.py, RTModel.make_noneq_step) can
take the equilibrium chemistry's place.  Modes 9, 8, 6 and 1 and the
noneq network also run on nested grids, plain PyTorch (core/step_amr.py):
two levels (AMRModel), L levels dense (MultiLevelModel) and block-sparse
(SparseMLModel, core/amr_sparse.py), on one device or on the mesh.
The measuring entry points are `python -m radiativetransfer_tpu_torch.bench`
and `python -m radiativetransfer_tpu_torch.roofline_sweep`.

Public API:

    from radiativetransfer_tpu_torch import RunConfig, RTModel, GridGeometry
    model = RTModel.setup(cfg, geom, torch.float32, "cuda")
    state = model.initialize_equilibrium(state)
    step = model.make_step()                 # modes 6 and 9
    state = step(state)
    ctx = StellarContext.build(pop, sources, geom, age_s, metal_coefs)
    state, diag = model.make_step(ctx)(state)     # modes 1 and 8
    model.neutral_fraction(state)
    species = chemistry_noneq.species_from_field_state(state)
    state, species = model.make_noneq_step(dt_s)(state, species)
"""

__version__ = "0.1.0"

from .config import RunConfig, load_config, save_config
from .core.state import FieldState, GridGeometry, make_state, uniform_state
from .core.rays import SourceBatch
from .core.step import RTModel, StellarContext

__all__ = [
    "RunConfig", "load_config", "save_config",
    "FieldState", "GridGeometry", "make_state", "uniform_state", "RTModel",
    "SourceBatch", "StellarContext",
]
