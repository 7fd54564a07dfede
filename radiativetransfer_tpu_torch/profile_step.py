"""Profile mode-9 steps of the port on one CUDA device.

    python3 -m radiativetransfer_tpu_torch.profile_step [n] [level]

Builds the synthetic galaxy of chip_smoke.py (n^3, default 128, angular
level default 3), runs initialize_equilibrium and one warm-up step, then
times each layer of a step with CUDA events (opacity, sweep, chemistry)
and traces two steps with torch.profiler: the device kernels by total
time, the device-busy share of the traced wall time, and the peak device
memory.  Needs a CUDA device; prints the card's name and power limit.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from . import GridGeometry, RTModel, RunConfig, make_state
from .config import MODE_UVB_TRANSFER_ONLY
from .constants import KPC, MH, PSI
from .core import chemistry, opacity


def galaxy_state(n: int, box_kpc: float, device):
    """Centrally concentrated density, lognormal(0, 0.4) fluctuations from
    seed 0, T = 1e4 K, fully neutral (examples/make_test_data.py)."""
    rng = np.random.default_rng(0)
    ax = (np.arange(n) + 0.5) / n * box_kpc - box_kpc / 2
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    r = np.sqrt(x ** 2 + y ** 2 + z ** 2)
    nh = 3e-3 * (1.0 + (r / (0.15 * box_kpc)) ** 2) ** -1
    nh = nh * rng.lognormal(0.0, 0.4, nh.shape)
    nh = 10.0 ** np.log10(nh).astype(np.float32).astype(np.float64)
    return make_state(nh * MH / PSI, np.full(nh.shape, 1e4), nh,
                      dtype=torch.float32, device=device)


def _event_ms(fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def main(n: int = 128, level: int = 3) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    box = 300.0
    cfg = RunConfig(mode=MODE_UVB_TRANSFER_ONLY, current_redshift=6.55,
                    n_angular_level=level, reionization_model=10,
                    self_shielding_threshold_kpc=0.1)
    model = RTModel.setup(cfg, GridGeometry(n, n, n, box * KPC),
                          torch.float32, "cuda")
    state = model.initialize_equilibrium(galaxy_state(n, box, "cuda"))
    step = model.make_step()
    state = step(state)
    torch.cuda.synchronize()

    # per layer, CUDA events around each phase of one step
    s0 = state.zero_rates()
    kappa, t_op = _event_ms(lambda: opacity.compute_opacities(
        s0.HI, s0.HeI, s0.HeII, model.opacity_coef))
    jmean, t_sw = _event_ms(lambda: model._run_sweep(kappa))
    s1 = dataclasses.replace(s0, Jmean=jmean)
    _, t_ch = _event_ms(lambda: chemistry.solve_rate_equations(
        s1, model.geom, model.dev_tables, ksi_matrix=model.ksi_matrix,
        gamma_thin=model.gamma_thin,
        self_shielding_threshold=cfg.self_shielding_threshold,
        run_uvb_transfer=True, n_iter=60))
    print(f"layers at {n}^3 x {model.sweep_plan.n_directions} dirs f32: "
          f"opacity {t_op:.3f} ms, sweep {t_sw:.3f} ms, chemistry "
          f"{t_ch:.3f} ms; card {smi}")

    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            state = step(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device busy: the union of the kernels' intervals on the device
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    device_us, reach = 0.0, float("-inf")
    for start, end in spans:
        device_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                    row_limit=12))
    print(f"2 steps: wall {wall * 1e3:.3f} ms, device busy "
          f"{device_us / 1e3:.3f} ms ({100 * device_us / 1e6 / wall:.1f}% "
          f"of wall), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB; card {smi}")


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
