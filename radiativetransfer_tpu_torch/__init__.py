"""radiativetransfer_tpu_torch — the PyTorch/CUDA port of
radiativetransfer_tpu, module for module.

First slice: mode 9 (UVB-only diffuse transfer + equilibrium chemistry)
and mode 6 on a uniform grid on one device.  The diffuse sweep runs as a
hand-written CUDA kernel on a CUDA device (core/sweep_cuda.py) and as a
plain PyTorch slab scan on the CPU (core/sweep.py).

Public API:

    from radiativetransfer_tpu_torch import RunConfig, RTModel, GridGeometry
    model = RTModel.setup(cfg, geom, torch.float32, "cuda")
    state = model.initialize_equilibrium(state)
    step = model.make_step()
    state = step(state)
    model.neutral_fraction(state)
"""

__version__ = "0.1.0"

from .config import RunConfig, load_config, save_config
from .core.state import FieldState, GridGeometry, make_state, uniform_state
from .core.step import RTModel

__all__ = [
    "RunConfig", "load_config", "save_config",
    "FieldState", "GridGeometry", "make_state", "uniform_state", "RTModel",
]
