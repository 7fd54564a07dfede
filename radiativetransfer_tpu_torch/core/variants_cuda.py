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

Both kernels are in csrc/sweep_variants.cu (built and bound by
sweep_cuda.build_variants) and take every direction of the plan in one
launch, one CTA per (direction, band) plane, as csrc/sweep_merged.cu does.
A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  `LAUNCHES` counts the kernel launches by variant ("pair", "lean",
"clamp", ...).
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from ..geometry.patterns import SEG_NONE, SEG_XZ
from . import sweep_cuda
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

# kernel launches by variant ("pair" for the two-slab kernel)
LAUNCHES: collections.Counter = collections.Counter()


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
# The kernels' wrappers
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
    """Shared launch of the pair and lean kernels: permuted buffers, the
    hoisted 1/kappa (no floor, as both TPU kernels), scratch, the call and
    the gather back to grid order.  head: the arguments before the
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


def sweep_pair(kappa, plan: SweepPlan, uvb, cell_size,
               plane_memory: str = "auto") -> torch.Tensor:
    """The two-slab merged sweep (exact logmean): (3, n, n, n) kappa ->
    (3, n, n, n) Jmean; n must be even.  A CPU tensor takes
    sweep_pair_reference; a CUDA tensor launches the pair kernel (float32 or
    float64), or raises."""
    if plan.nslab % 2:
        raise ValueError(f"the pair sweep walks slabs two at a time; nslab "
                         f"{plan.nslab} is odd")
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


def lean_sweep(kappa, plan: SweepPlan, uvb, cell_size, variant: str = "lean",
               plane_memory: str = "auto") -> torch.Tensor:
    """One lean variant: (3, n, n, n) kappa -> (3, n, n, n) Jmean.  A CPU
    tensor takes lean_sweep_reference; a CUDA tensor launches the lean
    kernel (float32, the experiment's type), or raises."""
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
