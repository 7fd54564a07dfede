"""radiativetransfer_tpu_torch — the PyTorch/CUDA port of
radiativetransfer_tpu, module for module.

Modes 9 (UVB-only diffuse transfer + equilibrium chemistry), 6, 8 (point
sources + UVB) and 1 (point sources under the thin UVB) on a uniform grid
on one device.  The diffuse sweep runs as a hand-written CUDA kernel on a
CUDA device (core/sweep_cuda.py) and as a plain PyTorch slab scan on the
CPU (core/sweep.py); the point-source tracer (core/rays.py) is PyTorch.
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
