"""Profile steps of the port on one CUDA device, layer by layer.

    python3 -m radiativetransfer_tpu_torch.profile_step [n] [level] [mode] \
        [ranks]

Mode 9 (the default) builds the synthetic galaxy of chip_smoke.py (n^3,
default 128, angular level default 3) and runs initialize_equilibrium.
Mode 8 runs bench.py's step configuration: a uniform box (nH = 2e-4,
T = 1.5e4, 2000 kpc) with 8 sources from seed 0 at maxPixelLevel 6.
ranks > 0 (mode 9 only) runs the step on a 1-D mesh of that many ranks on
the card, the sweep through the ring kernel (sweep_strategy "rdma").
Either then runs one warm-up step, times each layer of a step with CUDA
events (the tracer in mode 8, opacity, sweep, chemistry; the tracer also
per march step), and traces two steps with torch.profiler: the device
kernels by total time, the device-busy share of the traced wall time, the
kernel launches per step and the peak device memory.  Needs a CUDA
device; prints the card's name and power limit.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from . import GridGeometry, RTModel, RunConfig, make_state, uniform_state
from .config import MODE_BOTH_STELLAR_UVB_TRANSFER, MODE_UVB_TRANSFER_ONLY
from .constants import KPC, MH, MYR, PSI
from .core import chemistry, opacity, rays
from .parallel.mesh import make_grid_mesh
from .roofline_sweep import nvidia_smi


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


def _setup(n: int, level: int, mode: int, ranks: int):
    """(model, first state, StellarContext or None) of the profiled run."""
    if mode == MODE_UVB_TRANSFER_ONLY:
        box = 300.0
        cfg = RunConfig(mode=mode, current_redshift=6.55,
                        n_angular_level=level, reionization_model=10,
                        self_shielding_threshold_kpc=0.1,
                        sweep_strategy="rdma" if ranks else "auto")
        model = RTModel.setup(cfg, GridGeometry(n, n, n, box * KPC),
                              torch.float32, "cuda")
        return (model, model.initialize_equilibrium(
            galaxy_state(n, box, "cuda")), None)
    if mode != MODE_BOTH_STELLAR_UVB_TRANSFER or ranks:
        raise SystemExit(f"profile_step profiles modes 8 and 9 (on a mesh "
                         f"9 only), not {mode} on {ranks} ranks")
    from .bench import bench_sources
    from .core.step import StellarContext
    from .tables import stellar
    cfg = RunConfig(mode=mode, current_redshift=6.55, n_angular_level=level,
                    reionization_model=10)
    geom = GridGeometry(n, n, n, 2000.0 * KPC)
    model = RTModel.setup(cfg, geom, torch.float32, "cuda")
    ctx = StellarContext.build(
        stellar.blackbody_population(q_ionizing=1.0e51),
        bench_sources(n, 8), geom, 10.0 * MYR, metal_coefs=[(0, 0.0)],
        dtype=torch.float32, device="cuda")
    state = uniform_state(n, nh=2e-4, tgas=1.5e4, dtype=torch.float32,
                          device="cuda")
    return model, state, ctx


def main(n: int = 128, level: int = 3, mode: int = 9, ranks: int = 0) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")
    smi = nvidia_smi()
    model, state, ctx = _setup(n, level, mode, ranks)
    cfg = model.config
    mesh = make_grid_mesh(ranks) if ranks else None
    step = model.make_step(ctx, mesh=mesh)

    def run(s):
        return step(s)[0] if ctx is not None else step(s)

    state = run(state)
    torch.cuda.synchronize()

    # per layer, CUDA events around each phase of one step
    s0 = state.zero_rates()
    layers = []
    if ctx is not None:
        steps0 = rays.MARCH_STEPS
        (s0, _), t_tr = _event_ms(lambda: model.trace(s0, ctx))
        march = rays.MARCH_STEPS - steps0
        layers.append(f"tracer {t_tr:.3f} ms ({march} march steps, "
                      f"{t_tr / max(march, 1):.4f} ms per step)")
    kappa, t_op = _event_ms(lambda: opacity.compute_opacities(
        s0.HI, s0.HeI, s0.HeII, model.opacity_coef))
    jmean, t_sw = _event_ms(lambda: model._run_sweep(kappa, mesh))
    s1 = dataclasses.replace(s0, Jmean=jmean)
    _, t_ch = _event_ms(lambda: chemistry.solve_rate_equations(
        s1, model.geom, model.dev_tables, ksi_matrix=model.ksi_matrix,
        gamma_thin=model.gamma_thin,
        self_shielding_threshold=cfg.self_shielding_threshold,
        run_uvb_transfer=True, n_iter=60))
    layers += [f"opacity {t_op:.3f} ms", f"sweep {t_sw:.3f} ms",
               f"chemistry {t_ch:.3f} ms"]
    where = f" on {ranks} ranks (rdma)" if ranks else ""
    print(f"mode {mode}{where} layers at {n}^3 x "
          f"{model.sweep_plan.n_directions} dirs f32: {', '.join(layers)}; "
          f"card {smi}")

    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            state = run(state)
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
                                    row_limit=15))
    print(f"mode {mode}{where}, 2 steps: wall {wall * 1e3:.3f} ms, device "
          f"busy {device_us / 1e3:.3f} ms "
          f"({100 * device_us / 1e6 / wall:.1f}% of wall), "
          f"{len(spans) / 2:.0f} device kernels per step, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} "
          f"GiB; card {smi}")


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
