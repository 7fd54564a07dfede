"""Row scatter-add experiment on one CUDA device: tracer deposits.

    python3 -m radiativetransfer_tpu_torch.exp_row_scatter

Port of the JAX package's scripts/exp_pallas_scatter.py.  The tracer
deposits 8 channels per cell with index_add_; the TPU experiment asked
whether a hand-written scatter that walks the rows beats the library's.
Here the row kernel (csrc/scatter_rows.cu) runs beside 6 per-channel
index_add_ calls (the script's `xla6`) and one row-wise index_add_
(`xla-row8`, the kernel's plain version) at the script's shapes: an (N^3,
8) float32 accumulator with N = 128 (67 MB) and M = 98,304, 393,216 and
786,432 rows, indices and values from seed 0.

At each M:
* the kernel against a float64 np.add.at on the host and against
  index_add_;
* in turns (index_add_, kernel, kernel, index_add_, twice), ms per call by
  CUDA events over REPS back-to-back calls: where the host takes longer
  per call than the device, this is the host's time;
* the split: host us per call (perf_counter over HOST_CALLS calls, no
  synchronisation inside the loop) of the wrapper, of its checks alone,
  of the bare library call (also inside the tensor's device context with
  the stream read through torch.cuda, which the wrapper avoids) and of
  index_add_; device us per call by torch.profiler's kernel intervals and
  by CUDA events around REPS calls queued behind a device sleep (the
  profiler's where it records any, `device_method` says which).

Then the floor probe (scatter_cuda.red_floor): 2 float4 reductions of ones
per row into hashed cells at the largest M, into an accumulator that fits
L2 (FLOOR_L2_CELLS) and into the 67 MB one, each held to its plain
version.  Prints the card's name
and power limit and one JSON line; needs a CUDA device.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from .core import probes_cuda, scatter_cuda
from .roofline_sweep import nvidia_smi

DEVICE = "cuda"
N = 128
NC = N ** 3
MS = (98304, 393216, 786432)
REPS = 20
HOST_CALLS = 500
# 4 MB of accumulator: well inside the 50 MB L2
FLOOR_L2_CELLS = 1 << 17


def rows(rng, m: int):
    """The script's rows: m cells uniform over the grid, normal values."""
    idx = rng.integers(0, NC, m)
    vals = rng.normal(0, 1, (m, scatter_cuda.ROW))
    return idx, vals


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """Host microseconds per call of fn: calls back to back, no
    synchronisation inside the timed loop."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * dt / calls


def device_us(fn, calls: int = REPS, tries: int = 3
              ) -> tuple[float | None, list[str]]:
    """(device microseconds per call of fn, the kernels' names): the summed
    intervals of torch.profiler's device events over `calls` calls, or
    (None, []) where `tries` profiles record no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        total = sum(e.time_range.elapsed_us() for e in kernels)
        if kernels and total > 0:
            return total / calls, sorted({e.name for e in kernels})
    return None, []


def queued_device_us(fn, calls: int = REPS) -> float:
    """Device microseconds per call of fn by CUDA events around `calls`
    calls enqueued behind a ~1 ms device sleep, so the host's time per call
    hides behind the device's queue and the events see back-to-back
    launches."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(2_000_000)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return 1e3 * start.elapsed_time(end) / calls


def in_turns(fns: dict, reps: int = REPS, rounds: int = 2) -> dict:
    """ms per call of each fn by CUDA events, in turns: in order, then in
    reverse order, `rounds` times; each fn's 2 * rounds times."""
    names = list(fns)
    out = {k: [] for k in names}
    for k in (names + names[::-1]) * rounds:
        out[k].append(probes_cuda.time_ms(fns[k], reps))
    return out


def floor(smi: str) -> dict:
    """The floor probe at the largest M: ms, float4 reductions per second
    and the share of the scatter's bytes bound, per accumulator, each held
    to its plain version (sums of ones: exact)."""
    m = max(MS)
    out = {}
    for label, cells in (("l2", FLOOR_L2_CELLS), ("hbm", NC)):
        acc = torch.zeros((cells, scatter_cuda.ROW), device=DEVICE)
        got = scatter_cuda.red_floor(acc, m)
        ref = scatter_cuda.red_floor_reference(torch.zeros_like(acc), m)
        exact = bool(torch.equal(got, ref))
        ms = probes_cuda.time_ms(lambda: scatter_cuda.red_floor(acc, m), REPS)
        # the plain version's index_add_ alone, its cells and ones made
        # beforehand
        at = torch.as_tensor(scatter_cuda.red_floor_cells(m, cells),
                             device=DEVICE)
        ones = torch.ones((m, scatter_cuda.ROW), device=DEVICE)
        plain_ms = probes_cuda.time_ms(lambda: acc.index_add_(0, at, ones),
                                       REPS)
        # its bytes: the touched sector read and written, per row
        bound = 1e3 * m * 64 / probes_cuda.HBM_BYTES_PER_S
        out[label] = {"ms": ms, "reds_per_s": 2 * m / ms * 1e3,
                      "plain_ms": plain_ms, "bound_ms": bound,
                      "acc_mb": cells * 32 / 1e6, "exact": exact}
        print(f"floor {label}: {m} rows x 2 float4 reductions into "
              f"{cells * 32 / 1e6:.1f} MB: {ms:.4f} ms = "
              f"{2 * m / ms * 1e3:.4e} reductions/s (its bytes bound "
              f"{bound:.4f} ms; index_add_ of the same {plain_ms:.4f} ms; "
              f"the scatter's bound {scatter_cuda.bound_ms(m):.4f} ms); "
              f"{'equals' if exact else 'DIFFERS FROM'} its plain version; "
              f"card {smi}")
        del acc, got, ref, at, ones
    return out


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("exp_row_scatter needs a CUDA device")
    smi = nvidia_smi()
    print(f"device={torch.cuda.get_device_name(0)} grid={N}^3 "
          f"acc={NC * 8 * 4 / 1e6:.0f} MB card {smi}")
    rng = np.random.default_rng(0)
    out = {"n": N, "card": smi, "m": {}}
    lib = scatter_cuda.build()
    for m in MS:
        idx_np, vals_np = rows(rng, m)
        idx = torch.tensor(idx_np, dtype=torch.int32, device=DEVICE)
        vals = torch.tensor(vals_np, dtype=torch.float32, device=DEVICE)
        v6 = [vals[:, c].contiguous() for c in range(6)]
        acc = torch.zeros((NC, scatter_cuda.ROW), device=DEVICE)
        rf = torch.zeros(NC, device=DEVICE)

        # correctness: one scatter into a zeroed accumulator, against a
        # float64 np.add.at of the same float32 values and the plain version
        ref = np.zeros((NC, scatter_cuda.ROW))
        np.add.at(ref, idx_np, vals_np.astype(np.float32).astype(np.float64))
        plain = scatter_cuda.scatter_rows_reference(torch.zeros_like(acc),
                                                    idx, vals)
        got = scatter_cuda.scatter_rows(torch.zeros_like(acc), idx, vals)
        err_np = float(np.abs(got.cpu().numpy() - ref).max())
        err_plain = float((got - plain).abs().max())
        del got, plain

        def xla6():
            for c in range(6):
                rf.index_add_(0, idx, v6[c])

        def add():
            scatter_cuda.scatter_rows_reference(acc, idx, vals)

        def kernel():
            scatter_cuda.scatter_rows(acc, idx, vals)

        stream = torch.cuda.current_stream().cuda_stream

        def bare():
            lib.rt_scatter_rows(acc.data_ptr(), NC, idx.data_ptr(),
                                vals.data_ptr(), m, stream)

        def bare_in_context():
            # the bare call inside the tensor's device context, the stream
            # read through torch.cuda: what the wrapper's host path avoids
            with torch.cuda.device(acc.device):
                lib.rt_scatter_rows(
                    acc.data_ptr(), NC, idx.data_ptr(), vals.data_ptr(), m,
                    torch.cuda.current_stream(acc.device).cuda_stream)

        turns = in_turns({"index_add_": add, "kernel": kernel})
        t_x6 = probes_cuda.time_ms(xla6, REPS)
        split = {}
        for name, fn in (("kernel", kernel), ("index_add_", add)):
            prof_us, names = device_us(fn)
            queued = queued_device_us(fn)
            split[name] = {"host_us": host_us(fn),
                           "device_us": queued if prof_us is None else prof_us,
                           "device_method": ("queued events" if prof_us is None
                                             else "profiler"),
                           "profiler_us": prof_us, "queued_us": queued,
                           "device_kernels": names}
        split["checks"] = {"host_us": host_us(
            lambda: scatter_cuda.check_rows(acc, idx, vals))}
        split["bare_call"] = {"host_us": host_us(bare)}
        split["bare_call_in_context"] = {"host_us": host_us(bare_in_context)}
        torch.cuda.synchronize()
        ms = {k: float(np.mean(t)) for k, t in turns.items()}
        b = scatter_cuda.bound_ms(m)
        t_k, t_row = ms["kernel"], ms["index_add_"]
        out["m"][m] = {"ms": t_k, "ns_per_row": t_k * 1e6 / m,
                       "plain_ms": t_row, "xla6_ms": t_x6,
                       "library_ms": t_row, "bound_ms": b, "turns": turns,
                       "split": split, "max_abs_err": err_np,
                       "max_abs_err_vs_plain": err_plain}
        print(f"M={m:7d}: in turns (ms per call, events over {REPS} calls) "
              + ", ".join(f"{k} {t[0]:.4f}/{t[1]:.4f}"
                          for k, t in turns.items())
              + f"; xla6 {t_x6:.4f}; bound {b:.4f} ms by bytes, kernel "
              f"{100 * b / t_k:.1f}%, index_add_ {100 * b / t_row:.1f}%; "
              f"card {smi}")
        for name, r in split.items():
            prof = ("none recorded" if r.get("profiler_us") is None
                    else f"{r['profiler_us']:.2f}")
            dev = (f", device {r['device_us']:.2f} us (profiler {prof}, "
                   f"queued events {r['queued_us']:.2f}; "
                   f"{'; '.join(r['device_kernels'])[:120]})"
                   if "device_us" in r else "")
            print(f"M={m:7d}: {name}: host {r['host_us']:.2f} us per call"
                  f"{dev}")
        print(f"M={m:7d}: kernel max abs err vs float64 np.add.at "
              f"{err_np:.2e}, vs index_add_ {err_plain:.2e}")
        del acc, rf, idx, vals, v6
    out["floor"] = floor(smi)
    print(json.dumps({"exp_row_scatter": out}))
    return out


if __name__ == "__main__":
    main()
