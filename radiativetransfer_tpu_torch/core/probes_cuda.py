"""Elementwise chain probes as a hand-written CUDA kernel, and the
roofline bound of the sweep kernel they feed.

Counterpart of two TPU kernels of the JAX package: bench.py's
`_exp_kernel` (8 chained exp(-x) per element; here body "exp", depth 8)
and scripts/roofline_sweep.py's `_plane_call` (one elementwise body per
element of a (3, N, N, N) field: "stream" v + 1 at depth 1, and 64-deep
"exp", "div" and "fma" chains).  The kernel (csrc/probes.cu) is built
with the sweep kernel's flags, so "exp" times the very IEEE expf that
csrc/sweep_merged.cu issues.

* `chain(x, body, depth)` — the wrapper: a CUDA tensor launches the kernel
  (or raises), a CPU tensor takes the plain version.  `LAUNCHES` counts the
  kernel launches by (body, depth).  The stream body has a kernel of its
  own (one pass, its loads ahead of its stores).
* `chain_reference(x, body, depth)` — the plain PyTorch version.
* `time_ms` — mean device time of one call, by CUDA events.
* `chain_bound_ms`, `sweep_bound` — the least time the card could take
  for one chain, and for one sweep (from sweep_cuda.work_counts).
* `sass_loop_mix` — the instruction mix of a kernel's innermost loop in a
  `cuobjdump -sass` listing: where the per-step counts below come from.
"""

from __future__ import annotations

import collections
import ctypes
import re

import torch

from . import cuda_build

BODIES = {"exp": 0, "stream": 1, "div": 2, "fma": 3, "exp2": 4}
# the probes the JAX package ran: (body, depth)
EXP8 = ("exp", 8)                     # bench.py:270 _exp_kernel
PLANE_PROBES = (("stream", 1), ("exp", 64), ("div", 64), ("fma", 64))
# instructions per chain step, counted in the SASS of the built kernel
# (sass_loop_mix; nvcc 12.9): FP32 ones (FADD, FMUL, FFMA) and
# special-function ones (MUFU).  exp: IEEE expf, the FP32 range reduction
# around one MUFU.EX2; div: x + 1.5, then one MUFU.RCP and its 3-instruction
# Newton correction; fma: a separate FMUL and FADD under -fmad=false;
# exp2: exp2f (no fast math), the exp2 sweep variant's exp, one MUFU.EX2
# and the FMULs that scale an argument below -126 around it
FP32_PER_STEP = {"exp": 6, "stream": 1, "div": 4, "fma": 2, "exp2": 2}
MUFU_PER_STEP = {"exp": 1, "stream": 0, "div": 1, "fma": 0, "exp2": 1}

# published peaks of one H100 SXM at 700 W: HBM 3.35 TB/s and FP32
# 67 TFLOP/s (NVIDIA's data sheet), where an FMA counts 2: 132 SMs x 128
# lanes x 1.98 GHz, so 33.5e12 FP32 instructions per second, each a mul,
# an add or a min here; the special-function unit (MUFU) issues 16 lanes
# per SM per clock (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0)
HBM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_S = 67e12 / 2
MUFU_PER_S = 132 * 16 * 1.98e9

# kernel launches made by chain, by (body, depth)
LAUNCHES: collections.Counter = collections.Counter()

_LIB = None


def _step(acc, body: str):
    if body == "exp":
        return torch.exp(-acc)
    if body == "exp2":
        return torch.exp2(-acc)
    if body == "stream":
        return acc + 1.0
    if body == "div":
        return 1.0 / (acc + 1.5)
    return acc * 1.0000001 + 0.1


def chain_reference(x: torch.Tensor, body: str, depth: int) -> torch.Tensor:
    """Plain PyTorch version: `depth` steps of `body`, on any device."""
    if body not in BODIES:
        raise ValueError(f"unknown probe body {body!r}")
    acc = x
    for _ in range(depth):
        acc = _step(acc, body)
    return acc


def build() -> ctypes.CDLL:
    """Compile (if not built yet) and load the probe library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = cuda_build.build("probes")["probes"]
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rt_chain.argtypes = [i, i, p, p, ctypes.c_longlong, p]
    lib.rt_chain.restype = i
    lib.rt_probe_error_string.argtypes = [i]
    lib.rt_probe_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def chain(x: torch.Tensor, body: str, depth: int) -> torch.Tensor:
    """`depth` steps of `body` elementwise over float32 x.  A CPU tensor
    takes chain_reference; a CUDA tensor launches the kernel, or raises."""
    if body not in BODIES:
        raise ValueError(f"unknown probe body {body!r}")
    if depth < 1 or (body == "stream" and depth != 1):
        raise ValueError(f"no {body} probe of depth {depth}")
    if x.device.type == "cpu":
        return chain_reference(x, body, depth)
    if x.device.type != "cuda":
        raise ValueError(f"no probe kernel for device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"probe kernel takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.numel() == 0:
        raise ValueError("x is empty")
    out = torch.empty_like(x)
    if x.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned (float4 loads)")
    lib = build()
    with torch.cuda.device(x.device):
        rc = lib.rt_chain(BODIES[body], depth, x.data_ptr(), out.data_ptr(),
                          x.numel(),
                          torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"probe kernel launch failed: "
                           f"{lib.rt_probe_error_string(rc).decode()} ({rc})")
    LAUNCHES[(body, depth)] += 1
    return out


def time_ms(fn, reps: int, warmup: bool = True) -> float:
    """Mean device time of fn() over reps runs, after one warm-up run unless
    the caller made it, by CUDA events around the whole run."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max elementwise relative error) of a kernel's output
    against its plain version's.  Elements below 1e-30 of the largest, and
    in float32 below 1e-30, are held to absolute error at that floor: the
    attenuation through ~100 optically thick cells reaches float32's
    subnormal range (below 1.2e-38) at 256^3, where the sweeps' Jmean
    atomicAdd flushes each deposit to zero (PTX atom.add.f32) and the plain
    version's sum keeps it: at most ~200 deposits of < 1.2e-38 a cell,
    which 1e-5 of 1e-30 covers."""
    diff = (out - ref).abs()
    floor = max(float(ref.abs().max()) * 1e-30,
                1e-30 if ref.dtype == torch.float32
                else torch.finfo(ref.dtype).tiny)
    rel = diff / ref.abs().clamp(min=floor)
    return float(diff.max()), float(rel.max())


def chain_bound_ms(numel: int, body: str, depth: int) -> tuple[float, str]:
    """(least time in ms, what binds it) of one chain over numel float32
    values: each value read once and written once at the published HBM
    rate, against depth steps of FP32 instructions at the FP32 rate and of
    MUFU instructions at the special-function rate."""
    t_bytes = 2 * 4 * numel / HBM_BYTES_PER_S
    steps = numel * depth
    t_ops = max(steps * FP32_PER_STEP[body] / FP32_INSTR_PER_S,
                steps * MUFU_PER_STEP[body] / MUFU_PER_S)
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def sweep_bound(counts: dict, exp_per_s: float) -> dict:
    """The least time one sweep could take on this card: the largest of the
    compulsory bytes at the published HBM rate, the exps' MUFU.EX2 at the
    special-function rate and the FP32 instructions (the expfs' own
    included) at the FP32 rate.  counts: sweep_cuda.work_counts.  Returns
    each floor in ms, the bound, what sets it ("bytes" or "operations";
    `binding` names the floor) and, beside them, the exps at exp_per_s, the
    rate the 64-deep exp chain measured."""
    floors = {"bytes_ms": 1e3 * counts["bytes"] / HBM_BYTES_PER_S,
              "exp_ms": 1e3 * counts["exps"] / MUFU_PER_S,
              "fp32_ms": 1e3 * counts["fp32_ops"] / FP32_INSTR_PER_S}
    which = max(floors, key=floors.get)
    return {**floors, "exp_measured_ms": 1e3 * counts["exps"] / exp_per_s,
            "wrapper_bytes_ms":
            1e3 * counts["wrapper_bytes"] / HBM_BYTES_PER_S,
            "bound_ms": floors[which],
            "bound_by": "bytes" if which == "bytes_ms" else "operations",
            "binding": which[:-3]}


# one instruction of a cuobjdump -sass listing: address, predicate, opcode
# and operands
_SASS_LINE = re.compile(
    r"/\*([0-9a-f]+)\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def sass_loop_mix(sass: str) -> dict[str, collections.Counter]:
    """{kernel's mangled name: opcode counts} of one loop per kernel of a
    `cuobjdump -sass` listing: of its innermost loops (from a backward
    branch's target to the branch, holding no other loop), the one with the
    most MUFU instructions."""
    out = {}
    for chunk in sass.split("Function : ")[1:]:
        name = chunk.split(None, 1)[0]
        instrs = [(int(a, 16), pred, op, args.strip())
                  for a, pred, op, args in _SASS_LINE.findall(chunk)]
        loops = [(int(args, 16), addr) for addr, pred, op, args in instrs
                 if op == "BRA" and pred and args.startswith("0x")
                 and int(args, 16) < addr]
        inner = [(lo, hi) for lo, hi in loops
                 if not any((lo, hi) != (a, b) and lo <= a and b <= hi
                            for a, b in loops)]
        mixes = [collections.Counter(op for addr, _, op, _ in instrs
                                     if lo <= addr <= hi) for lo, hi in inner]
        if mixes:
            out[name] = max(mixes, key=lambda c: _count(c, ("MUFU",)))
    return out


def _count(mix: collections.Counter, kinds: tuple[str, ...]) -> int:
    return sum(v for op, v in mix.items() if op.split(".")[0] in kinds)


def per_mufu(mix: collections.Counter) -> dict:
    """MUFU instructions of a loop's mix, and its FP32 instructions (FADD,
    FMUL, FFMA) per MUFU."""
    mufu = _count(mix, ("MUFU",))
    return {"mufu": mufu,
            "fp32_per_mufu": _count(mix, ("FADD", "FMUL", "FFMA")) / mufu}
