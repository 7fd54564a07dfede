"""The TPU's two sweep experiments as hand-written CUDA kernels.

Counterpart of two TPU kernels of the JAX package's scripts/:

* exp_sweep_pair.py's `_pair_kernel` (#6): the merged flip-folded sweep
  with the exact logmean, two slabs per step, the carry kept across the
  pair.  Its function is the merged sweep's, so its plain version is
  sweep_cuda.diffuse_sweep_merged_reference(..., "exact").
* exp_sweep_variants.py's `_lean_kernel` (#7): the merged sweep on
  act-folded 16-slot tables (`_lean_pack`), with the flags of its variants
  lean, clamp, clamp2 (exp2 on lengths pre-scaled by log2 e), and the
  attribution variants seg1 (segment 1 only), noemi (no logmean) and
  noshift (no upwind shift), which compute other functions on purpose.
  Its plain version, `lean_sweep_reference`, repeats the TPU kernel's
  arithmetic for every flag.

Each has two kernels.  The cluster instances (csrc/sweep_cluster_exp.cu,
the main path's cluster kernel body of csrc/sweep_cluster.cuh in the
experiment's Mode: a cluster of C CTAs per plane, G directions a CTA) are
what `sweep_pair` and `lean_sweep` launch, in `choose_variant_cluster`'s
shape; where no shape fits the plane they take the plane kernels of
csrc/sweep_variants.cu (`sweep_pair_plane_kernel`, `lean_sweep_plane_kernel`:
one CTA per (direction, band) plane, as csrc/sweep_merged.cu), which stay as
the yardstick.  A CPU tensor takes the plain version; a CUDA tensor
launches a kernel or raises.  `CLUSTER_LAUNCHES` and `LAUNCHES` count the
two kernels' launches by variant ("pair", "lean", "clamp", ...).
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from ..geometry.patterns import SEG_NONE, SEG_XZ
from . import cuda_build, sweep_cluster, sweep_cuda
from .sweep import SweepPlan, _tau_eps

LOG2E = float(np.log2(np.e))
# the variants of exp_sweep_variants.py:291-298, in the order of the
# kernel's variant codes
VARIANTS = {
    "lean": dict(),
    "clamp": dict(clamped=True),
    "clamp2": dict(clamped=True, use_exp2=True),
    "seg1": dict(seg1_only=True),
    "noemi": dict(no_emi=True),
    "noshift": dict(no_shift=True),
}
# the variants that compute the sweep (the others attribute its time)
FULL_VARIANTS = ("lean", "clamp", "clamp2")
_DEFAULTS = dict(use_exp2=False, seg1_only=False, no_emi=False,
                 clamped=False, no_shift=False)
# the clamped logmean's constants (exp_sweep_variants.py:96-97)
_EPS_CL = 3.5e-4
_A_EPS = float(np.exp(-_EPS_CL))

# launches of csrc/sweep_variants.cu's plane kernels by variant ("pair" for
# the two-slab kernel), and of the cluster instances the same way
LAUNCHES: collections.Counter = collections.Counter()
CLUSTER_LAUNCHES: collections.Counter = collections.Counter()


def flags(variant: str) -> dict:
    """The five flags of one lean variant."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    return {**_DEFAULTS, **VARIANTS[variant]}


def _lean_pack(launch, cell_size, use_exp2, np_dtype, clamped=False):
    """(nslab, D, 16) from a _MergedLaunch's raw lens (unit) + chains.

    All per-segment scalars are act-masked so inactive chain slots (whose
    builder lengths carry nonzero chain-selected values) contribute
    exactly 0 to both tau and lm."""
    lens = launch.lens.astype(np.float64)   # (nslab, D, 8) raw: see builder
    raw = lens[..., 0:3]                    # unit lengths, chain-ordered
    inv_n = lens[..., 3:4]
    act = np.concatenate([np.ones_like(raw[..., :1]),
                          (launch.chains[..., 0:1] != SEG_NONE),
                          (launch.chains[..., 1:2] != SEG_NONE)],
                         axis=-1).astype(np.float64)
    len_nat = -raw * cell_size * act
    # raw = 0 gives 0/0 in the branch np.where discards
    with np.errstate(divide="ignore", invalid="ignore"):
        if clamped:
            # C slot: act*inv_n/(len*cell) (positive); s slot: inv_n
            C = np.where(raw > 0, act * inv_n / (raw * cell_size), 0.0)
        else:
            C = np.where(raw > 0, -act * inv_n / (raw * cell_size), 0.0)
    h = 0.5 * inv_n * len_nat
    s = inv_n * (np.ones_like(act) if clamped else act)
    ln = len_nat * (LOG2E if use_exp2 else 1.0)
    out = np.concatenate(
        [ln, C, h, s, np.zeros_like(raw), np.zeros_like(raw[..., :1])],
        axis=-1)
    return out.astype(np_dtype)


def _eps_c(dtype, use_exp2: bool) -> float:
    """The small-tau switch in the tau_n domain of the variant's exp."""
    eps = _tau_eps(dtype)
    return eps * LOG2E if use_exp2 else eps


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def sweep_pair_reference(kappa, plan: SweepPlan, uvb,
                         cell_size) -> torch.Tensor:
    """The pair kernel's plain version: the merged sweep, exact logmean."""
    return sweep_cuda.diffuse_sweep_merged_reference(kappa, plan, uvb,
                                                     cell_size, "exact")


def lean_sweep_reference(kappa, plan: SweepPlan, uvb, cell_size,
                         variant: str = "lean") -> torch.Tensor:
    """Plain PyTorch version of one lean variant, on any device: the TPU
    kernel's arithmetic op for op per cell (every segment evaluated,
    inactive ones masked by their act-folded tables), vectorized over the
    directions of a merged launch and the 3 bands, looping over slabs."""
    f = flags(variant)
    dtype, device = kappa.dtype, kappa.device
    np_dtype = sweep_cuda.numpy_dtype(dtype)
    eps_c = _eps_c(dtype, f["use_exp2"])
    exp_fn = torch.exp2 if f["use_exp2"] else torch.exp
    uvb_c = torch.as_tensor(uvb, dtype=dtype, device=device)[
        None, :, None, None]                                  # (1,3,1,1)
    jmean = torch.zeros_like(kappa)
    by_perm: dict = {}
    for launch in sweep_cuda.build_merged_launches(plan, np.float64):
        by_perm.setdefault(launch.perm, []).append(launch)

    for q, launches in by_perm.items():
        kperm = kappa.permute(
            0, *(1 + a for a in sweep_cuda.inverse_perm(q)))
        nslab, ny, nz = kperm.shape[1:]
        j_perm = torch.zeros((3, nslab, ny, nz), dtype=dtype, device=device)
        for launch in launches:
            ndir = len(launch.dirs_meta)
            packed = torch.as_tensor(
                _lean_pack(launch, cell_size, f["use_exp2"], np_dtype,
                           clamped=f["clamped"]), device=device)
            chains = torch.as_tensor(launch.chains, device=device)
            flips = torch.tensor(launch.dirs_meta, device=device)
            flip_j = flips[:, 0, None, None, None]            # (D,1,1,1)
            flip_k = flips[:, 1, None, None, None]
            pad_j = uvb_c.expand(ndir, 3, 1, nz)
            pad_k = uvb_c.expand(ndir, 3, ny, 1)

            def shift_j(x):
                if f["no_shift"]:
                    return x
                fwd = torch.cat([pad_j, x[:, :, :-1, :]], dim=2)
                bwd = torch.cat([x[:, :, 1:, :], pad_j], dim=2)
                return torch.where(flip_j, bwd, fwd)

            def shift_k(x):
                if f["no_shift"]:
                    return x
                fwd = torch.cat([pad_k, x[:, :, :, :-1]], dim=3)
                bwd = torch.cat([x[:, :, :, 1:], pad_k], dim=3)
                return torch.where(flip_k, bwd, fwd)

            itop = uvb_c.expand(ndir, 3, ny, nz)
            for i in range(nslab):
                s = nslab - 1 - i if launch.reverse else i
                kap = kperm[:, s][None]                       # (1,3,ny,nz)
                inv_kap = 1.0 / kap
                col = packed[i][:, :, None, None, None]       # (D,16,1,1,1)

                def seg(i_in, k):
                    ln, c, h, sp = (col[:, k], col[:, 3 + k], col[:, 6 + k],
                                    col[:, 9 + k])
                    tau_n = kap * ln
                    a = exp_fn(tau_n)
                    i_out = i_in * a
                    if f["no_emi"]:
                        return i_out, i_out
                    if f["clamped"]:
                        d = i_in - i_in * torch.clamp(a, max=_A_EPS)
                        return i_out, d * torch.minimum(
                            inv_kap * c, sp * (1.0 / _EPS_CL))
                    return i_out, torch.where(tau_n < -eps_c,
                                              (i_out - i_in) * (inv_kap * c),
                                              i_in * (sp + h * kap))

                i1, lm1 = seg(itop, 0)
                if f["seg1_only"]:
                    itop, jacc = i1, lm1
                else:
                    ch2 = chains[i, :, 0, None, None, None]
                    ch3 = chains[i, :, 1, None, None, None]
                    is2 = (ch2 == SEG_XZ).to(dtype)
                    i2, lm2 = seg(is2 * shift_j(i1) + (1.0 - is2) * shift_k(i1),
                                  1)
                    is3 = (ch3 == SEG_XZ).to(dtype)
                    i3, lm3 = seg(is3 * shift_j(i2) + (1.0 - is3) * shift_k(i2),
                                  2)
                    itop = torch.where(ch3 != SEG_NONE, i3,
                                       torch.where(ch2 != SEG_NONE, i2, i1))
                    jacc = lm1 + lm2 + lm3
                j_perm[:, s] += plan.weight * torch.sum(jacc, dim=0)
        jmean += j_perm.permute(0, *(1 + a for a in q))
    return jmean


# ---------------------------------------------------------------------------
# The cluster kernel's instances (csrc/sweep_cluster_exp.cu) and their size
# rule
# ---------------------------------------------------------------------------


# rt_sweep_cluster_variant's code of each Mode: the lean variants in
# VARIANTS' order, then the pair
_CODES = {**{v: i for i, v in enumerate(VARIANTS)}, "pair": len(VARIANTS)}
MODES = tuple(_CODES)
# the size rule (choose_variant_cluster) by Mode and item size: its order of
# directions per work item and its cells per thread.  Measured on the H100
# at 128^3 and 256^3 x 192 in float32, every launch shape (exp_sweep_variants
# and exp_sweep_pair, PERF.md): the lean variants keep the
# merged sweep's order (G 2, 4 cells; within 8% of the fastest shape at
# 128^3, the fastest at 256^3), the pair runs fastest at 2 cells per thread
# (C 16, G 2, 512 x 2 at 128^3; 256^3 fits G 1 x 4 only); float64 keeps the
# merged sweep's order, not measured
RULE_PREFERENCE = {mode: {4: ((2, 1), 2 if mode == "pair" else 4),
                          8: ((1, 2), 2)} for mode in MODES}

_LIB = None


def build() -> ctypes.CDLL:
    """Compile (if not built yet) and load csrc/sweep_cluster_exp.cu."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = cuda_build.build("sweep_cluster_exp")["sweep_cluster_exp"]
    p, pp, i, d = (ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                   ctypes.c_int, ctypes.c_double)
    lib.rt_sweep_cluster_variant.argtypes = (
        [i, i, i, pp, pp, pp] + [p] * 4 + [d] * 7 + [i] * 9
        + [ctypes.POINTER(i), p])
    lib.rt_sweep_cluster_variant.restype = i
    lib.rt_cluster_variant_error_string.argtypes = [i]
    lib.rt_cluster_variant_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def _check_mode(mode: str) -> None:
    if mode not in _CODES:
        raise ValueError(f"unknown variant {mode!r}")


def variant_shapes(n: int, dtype: torch.dtype, mode: str
                   ) -> list[sweep_cluster.ClusterShape]:
    """Every launch shape of one Mode's instances ("pair" or a lean variant)
    on an n^3 field, by C, then G (sweep_cluster.cluster_shapes)."""
    _check_mode(mode)
    return [s for c in sweep_cluster.CLUSTER_SIZES
            for g in sweep_cluster.EXP_GROUP_SIZES
            for s in sweep_cluster.cluster_shapes(n, n, dtype, c, g,
                                                  mode=mode, nslab=n)]


def choose_variant_cluster(n: int, dtype: torch.dtype, mode: str
                           ) -> sweep_cluster.ClusterShape | None:
    """The experiments' size rule: of every launch shape of the Mode that
    fits an n^3 field, the first in RULE_PREFERENCE's order of G, its cells
    per thread, then the block nearest 512 threads, the smallest cluster;
    None where none fits (the wrappers then take csrc/sweep_variants.cu's
    plane kernel)."""
    shapes = variant_shapes(n, dtype, mode)
    if not shapes:
        return None
    groups, cpt = RULE_PREFERENCE[mode][torch.finfo(dtype).bits // 8]
    return min(shapes, key=lambda s: (groups.index(s.group), s.cpt != cpt,
                                      abs(s.threads - 512), s.csize))


def _tables(plan: SweepPlan, cell_size: float, mode: str, dtype, device):
    """(perms, dir_meta, lens, chains): kernel_tables' 8-slot rows for the
    pair, _lean_tables' 16-slot rows for a lean variant."""
    if mode == "pair":
        return sweep_cuda.kernel_tables(plan, cell_size, dtype, device)
    return _lean_tables(plan, cell_size, mode, dtype, device)


def _cluster_call(kappa, plan: SweepPlan, uvb, cell_size, mode: str,
                  shape: sweep_cluster.ClusterShape, query_only: bool):
    """One rt_sweep_cluster_variant call: (Jmean or None, resident
    clusters).  The library checks the shape's block against the plane and
    its registers, and asks the card whether such a cluster can be
    scheduled, before any launch."""
    _check_mode(mode)
    sweep_cuda.check_sweep_field(kappa, plan)
    if mode != "pair" and kappa.dtype != torch.float32:
        raise TypeError(f"the lean sweep kernel takes float32, got "
                        f"{kappa.dtype}")
    if mode == "pair":
        _check_pair(plan)
    if (shape.group not in sweep_cluster.EXP_GROUP_SIZES
            or shape.cpt not in sweep_cluster.EXP_CELLS_PER_THREAD):
        raise ValueError(f"no {mode} kernel for {shape}")
    lib = build()
    n = plan.nslab
    dtype, device = kappa.dtype, kappa.device
    eps = (_tau_eps(dtype) if mode == "pair"
           else _eps_c(dtype, flags(mode)["use_exp2"]))
    with torch.cuda.device(device):
        perms, meta, lens, chains = _tables(plan, cell_size, mode, dtype,
                                            device)
        items = sweep_cluster._item_table("cluster_items", plan, meta,
                                          shape.group, device)
        if query_only:
            jmean = None
            fields = ([kappa] * len(perms),) * 3
        else:
            jmean, *fields = sweep_cuda.launch_buffers(kappa, "exact", perms)
        occupancy = (ctypes.c_int * 2)()
        rc = lib.rt_sweep_cluster_variant(
            _CODES[mode], 0 if dtype == torch.float32 else 1, len(perms),
            *(sweep_cuda.pointer_array(f) for f in fields), meta.data_ptr(),
            lens.data_ptr(), chains.data_ptr(), items.data_ptr(),
            *sweep_cuda.uvb_floats(uvb), plan.weight, eps, _A_EPS,
            1.0 / _EPS_CL, items.shape[0], n, n, n, shape.csize, shape.group,
            shape.cpt, shape.threads, int(query_only), occupancy,
            torch.cuda.current_stream(device).cuda_stream)
        sweep_cluster.check_launch(
            rc, occupancy, shape, lib.rt_cluster_variant_error_string,
            f"cluster {mode} sweep kernel")
    if query_only:
        return None, occupancy[0]
    return sweep_cuda.gather_jmean(jmean, fields[2], perms), occupancy[0]


def cluster_kernel(kappa, plan: SweepPlan, uvb, cell_size, mode: str,
                   shape: sweep_cluster.ClusterShape | None = None
                   ) -> torch.Tensor:
    """One experiment through its cluster instances: the pair ("pair",
    float32 or float64, nslab even) or a lean variant (float32): (3, n, n,
    n) kappa -> (3, n, n, n) Jmean, in `shape` (choose_variant_cluster's by
    default).  A CUDA tensor only: raises where the shape does not fit the
    plane or cannot be scheduled, before any launch.  Counts its launches
    in CLUSTER_LAUNCHES[mode]."""
    if shape is None:
        shape = choose_variant_cluster(plan.nslab, kappa.dtype, mode)
        if shape is None:
            raise ValueError(f"no {mode} cluster shape fits a "
                             f"{plan.nslab}^3 {kappa.dtype} plane")
    jmean, _ = _cluster_call(kappa, plan, uvb, cell_size, mode, shape, False)
    CLUSTER_LAUNCHES[mode] += 1
    return jmean


def resident_variant_clusters(kappa, plan: SweepPlan, cell_size, mode: str,
                              shape: sweep_cluster.ClusterShape) -> int:
    """How many clusters of `shape` of the Mode's instances the card holds
    at once; launches nothing."""
    return _cluster_call(kappa, plan, np.zeros(3), cell_size, mode, shape,
                         True)[1]


# ---------------------------------------------------------------------------
# The plane kernels (csrc/sweep_variants.cu) and the wrappers
# ---------------------------------------------------------------------------


def _lean_tables(plan: SweepPlan, cell_size: float, variant: str, dtype,
                 device):
    """(perms, dir_meta, lens (D, nslab, 16), chains (D, nslab, 2)) of every
    merged launch concatenated along directions, in the order of
    sweep_cuda.kernel_tables; kept per variant for the last plan."""
    def make():
        f = flags(variant)
        perms, meta, _, chains = sweep_cuda.kernel_tables(plan, cell_size,
                                                          dtype, device)
        packed = [_lean_pack(launch, cell_size, f["use_exp2"],
                             sweep_cuda.numpy_dtype(dtype),
                             clamped=f["clamped"])
                  for launch in sweep_cuda.build_merged_launches(plan,
                                                                 np.float64)]
        lens = torch.as_tensor(np.swapaxes(np.concatenate(packed, axis=1), 0,
                                           1).copy(), device=device)
        return perms, meta, lens, chains
    return sweep_cuda.device_tables(("lean", variant), plan, cell_size, dtype,
                                    device, make)


def _launch(fn, what: str, kappa, plan: SweepPlan, uvb, tables, head,
            tail, plane_memory: str):
    """Shared launch of the pair and lean plane kernels: permuted buffers,
    the hoisted 1/kappa (no floor, as both TPU kernels), scratch, the call
    and the gather back to grid order.  head: the arguments before the
    pointers, tail: the scalars between the UVB and the sizes."""
    n = plan.nslab
    if tuple(kappa.shape) != (3, n, n, n):
        raise ValueError(f"kappa shape {tuple(kappa.shape)} != (3, {n}, {n}, "
                         f"{n}) of the plan")
    plane_memory = sweep_cuda.resolve_plane_memory(plane_memory, n,
                                                   kappa.dtype)
    lib = sweep_cuda.build_variants()
    dtype, device = kappa.dtype, kappa.device
    perms, meta, lens, chains = tables
    ndir = meta.shape[0]
    jmean, kperm, ikperm, jperm = sweep_cuda.launch_buffers(kappa, "exact",
                                                             perms)
    scratch = (torch.empty(3 * ndir * 3 * n * n, dtype=dtype, device=device)
               if plane_memory == "global" else None)

    def ptrs(ts):
        return (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))

    rc = fn(*head, len(perms), ptrs(kperm), ptrs(ikperm), ptrs(jperm),
            meta.data_ptr(), lens.data_ptr(), chains.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            *sweep_cuda.uvb_floats(uvb), plan.weight, *tail, ndir, n, n, n,
            int(plane_memory == "shared"),
            torch.cuda.current_stream(device).cuda_stream)
    sweep_cuda.check_rc(lib, rc, what)
    return sweep_cuda.gather_jmean(jmean, jperm, perms)


def _check_pair(plan: SweepPlan) -> None:
    if plan.nslab % 2:
        raise ValueError(f"the pair sweep walks slabs two at a time; nslab "
                         f"{plan.nslab} is odd")


def sweep_pair_plane_kernel(kappa, plan: SweepPlan, uvb, cell_size,
                            plane_memory: str = "auto") -> torch.Tensor:
    """The two-slab sweep through csrc/sweep_variants.cu's plane kernel, one
    CTA per (direction, band) plane: (3, n, n, n) kappa -> (3, n, n, n)
    Jmean; n even.  A CPU tensor takes sweep_pair_reference; a CUDA tensor
    launches the kernel (float32 or float64), or raises."""
    _check_pair(plan)
    if kappa.device.type == "cpu":
        return sweep_pair_reference(kappa, plan, uvb, cell_size)
    sweep_cuda.check_device_field(kappa)
    lib = sweep_cuda.build_variants()
    with torch.cuda.device(kappa.device):
        tables = sweep_cuda.kernel_tables(plan, cell_size, kappa.dtype,
                                           kappa.device)
        out = _launch(lib.rt_sweep_pair, "pair sweep", kappa, plan, uvb,
                      tables, (0 if kappa.dtype == torch.float32 else 1,),
                      (_tau_eps(kappa.dtype),), plane_memory)
    LAUNCHES["pair"] += 1
    return out


def lean_sweep_plane_kernel(kappa, plan: SweepPlan, uvb, cell_size,
                            variant: str = "lean",
                            plane_memory: str = "auto") -> torch.Tensor:
    """One lean variant through csrc/sweep_variants.cu's plane kernel:
    (3, n, n, n) kappa -> (3, n, n, n) Jmean.  A CPU tensor takes
    lean_sweep_reference; a CUDA tensor launches the kernel (float32, the
    experiment's type), or raises."""
    f = flags(variant)
    if kappa.device.type == "cpu":
        return lean_sweep_reference(kappa, plan, uvb, cell_size, variant)
    sweep_cuda.check_device_field(kappa, (torch.float32,))
    lib = sweep_cuda.build_variants()
    with torch.cuda.device(kappa.device):
        tables = _lean_tables(plan, cell_size, variant, kappa.dtype,
                              kappa.device)
        out = _launch(lib.rt_sweep_lean, f"lean sweep ({variant})", kappa,
                      plan, uvb, tables, (list(VARIANTS).index(variant),),
                      (_eps_c(kappa.dtype, f["use_exp2"]), _A_EPS,
                       1.0 / _EPS_CL), plane_memory)
    LAUNCHES[variant] += 1
    return out


def sweep_pair(kappa, plan: SweepPlan, uvb, cell_size) -> torch.Tensor:
    """The two-slab merged sweep (exact logmean): (3, n, n, n) kappa ->
    (3, n, n, n) Jmean; n must be even.  A CPU tensor takes
    sweep_pair_reference; a CUDA tensor (float32 or float64) launches the
    cluster instance in choose_variant_cluster's shape or, where no shape
    fits the plane, sweep_pair_plane_kernel; the rule decides before any
    launch, and each kernel's count records it."""
    _check_pair(plan)
    if kappa.device.type == "cpu":
        return sweep_pair_reference(kappa, plan, uvb, cell_size)
    shape = choose_variant_cluster(plan.nslab, kappa.dtype, "pair")
    if shape is None:
        return sweep_pair_plane_kernel(kappa, plan, uvb, cell_size)
    return cluster_kernel(kappa, plan, uvb, cell_size, "pair", shape)


def lean_sweep(kappa, plan: SweepPlan, uvb, cell_size,
               variant: str = "lean") -> torch.Tensor:
    """One lean variant: (3, n, n, n) kappa -> (3, n, n, n) Jmean.  A CPU
    tensor takes lean_sweep_reference; a CUDA tensor (float32, the
    experiment's type) launches the variant's cluster instance in
    choose_variant_cluster's shape or, where no shape fits the plane,
    lean_sweep_plane_kernel; the rule decides before any launch."""
    if kappa.device.type == "cpu":
        return lean_sweep_reference(kappa, plan, uvb, cell_size, variant)
    shape = choose_variant_cluster(plan.nslab, kappa.dtype, variant)
    if shape is None:
        return lean_sweep_plane_kernel(kappa, plan, uvb, cell_size, variant)
    return cluster_kernel(kappa, plan, uvb, cell_size, variant, shape)
