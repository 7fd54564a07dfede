"""The diffuse upwind sweep as a plain PyTorch slab scan.

Replaces the reference's serial 192-direction cell-by-cell sweep
(equiSources.f90:1372-1808, transportRoutinesModule.f90:560-963) with a
vectorized slab pipeline, exactly as the JAX package's core/sweep.py does:

* Directions are folded into 24 octant-orientation zones; per zone the
  field tensors are viewed through one transpose/flip (geometry.octants), so
  the scan always sweeps along array axis 0.
* Within a slab every cell shares the same <=3-segment ray template
  (geometry.patterns) and the in-slab dependency chain has depth <= 2:
  the xy segment depends only on the previous slab, the second chain segment
  on an in-slab neighbor's xy output, the third on the second.  Each slab is
  therefore 3 shifted multiply-accumulate passes over the (ny, nz) plane,
  batched over all directions of the zone and the 3 frequency bands.
* A Python loop walks the slabs (the JAX package's lax.scan); the carry is
  the top-exit intensity plane.

This is the CPU path of RTModel and the oracle of the CUDA kernel in
core/sweep_cuda.py.

The mean intensity uses the reference's log-mean accumulation
  J += (Iin - Iout)/ln(Iin/Iout)
in the numerically-safe equivalent form Iin*(1-e^-tau)/tau
(computeCellIntensity, transportRoutinesModule.f90:1036-1054).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..geometry import healpix, octants, patterns
from ..geometry.patterns import SEG_XZ

# small-tau switch for the (1-e^-tau)/tau form: 1e-10 in float64 matches the
# reference branch (equiSources.f90:1618); float32 needs a much larger
# threshold because 1-exp(-tau) cancels to zero below tau ~ 1e-7 (the linear
# limit 1 - tau/2 is accurate to ~tau^2/6 < 2e-9 at the switch)
_TAU_EPS_F64 = 1.0e-10
_TAU_EPS_F32 = 1.0e-4


def _tau_eps(dtype: torch.dtype) -> float:
    return _TAU_EPS_F64 if dtype == torch.float64 else _TAU_EPS_F32


@dataclasses.dataclass(frozen=True)
class ZoneBatch:
    """All sweep directions sharing one octant orientation."""
    izone: int
    ndir: int
    # (ndir, nslab) float arrays / int8 arrays
    len_xy: np.ndarray
    len_xz: np.ndarray
    len_yz: np.ndarray
    chain2: np.ndarray
    chain3: np.ndarray
    n_active: np.ndarray


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """Precomputed geometry for a full multi-direction sweep."""
    zones: tuple[ZoneBatch, ...]
    n_directions: int
    nslab: int

    @property
    def weight(self) -> float:
        """Angular quadrature weight 1/N (equiSources.f90:1386)."""
        return 1.0 / self.n_directions


def build_sweep_plan(n_angular_level: int, nx: int) -> SweepPlan:
    """Fold all HEALPix directions, group by zone, build slab templates."""
    phi, theta = healpix.sweep_directions(n_angular_level)
    folded = octants.fold_all(phi, theta)
    groups = octants.group_by_zone(folded)
    zones = []
    for izone in sorted(groups):
        ds = groups[izone]
        p = patterns.stack_patterns(
            [patterns.build_slab_patterns(d.phi, d.theta, nx) for d in ds])
        zones.append(ZoneBatch(
            izone=izone, ndir=len(ds),
            len_xy=p.len_xy, len_xz=p.len_xz, len_yz=p.len_yz,
            chain2=p.chain2, chain3=p.chain3, n_active=p.n_active))
    return SweepPlan(zones=tuple(zones), n_directions=len(folded), nslab=nx)


def _attenuation(tau):
    """A segment's factors (e^-tau, (1-e^-tau)/tau), the latter with the
    small-tau limit 1 - tau/2 (branch at equiSources.f90:1618-1632 and
    computeCellIntensity)."""
    a = torch.exp(-tau)
    eps = _tau_eps(tau.dtype)
    big = tau > eps
    emi = torch.where(big, (1.0 - a) / torch.where(big, tau, 1.0),
                      1.0 - 0.5 * tau)
    return a, emi


def _attenuate(i_in, tau):
    """One segment: returns (i_out, logmean_contribution).

    logmean = (Iin - Iout)/ln(Iin/Iout) = Iin*(1-e^-tau)/tau.
    """
    a, emi = _attenuation(tau)
    return i_in * a, i_in * emi


def _shift_j(x, boundary):
    """Upwind shift along axis -2 (the xz-segment neighbor j-1)."""
    return torch.cat([boundary, x[..., :-1, :]], dim=-2)


def _shift_k(x, boundary):
    """Upwind shift along axis -1 (the yz-segment neighbor k-1)."""
    return torch.cat([boundary, x[..., :, :-1]], dim=-1)


def sweep_zone(kappa_rot, zone: ZoneBatch, uvb, cell_size, weight,
               shift_k=_shift_k):
    """Sweep all directions of one zone over a rotated opacity field.

    Args:
      kappa_rot: (nslab, 3, ny, nz) opacity in sweep orientation [1/cm];
        or (nslab, P, 3, ny, nz/P), P k-blocks swept in lockstep, with a
        `shift_k` that crosses the blocks (parallel/sweep_dist.py).
      zone: the zone's per-slab templates, each (ndir, nslab).
      uvb: (3,) tensor of boundary intensities of the three bands.
      cell_size: base-cell physical size [cm].
      weight: per-direction angular weight.
      shift_k: (x, boundary) -> the yz-segment upwind shift of x along
        axis -1.
    Returns:
      j_rot: kappa_rot's shape, accumulated weighted mean intensity.
    """
    nslab, *plane_shape = kappa_rot.shape                     # [P,] 3, ny, nz
    ndir = zone.ndir
    dtype, device = kappa_rot.dtype, kappa_rot.device
    ones = (1,) * len(plane_shape)

    def table(x, dt=dtype):
        # (ndir, nslab) -> (nslab, ndir, 1, ...) for broadcasting
        return torch.as_tensor(np.ascontiguousarray(x.T), device=device).to(
            dt).reshape(nslab, ndir, *ones)

    len_xy, len_xz, len_yz = (table(zone.len_xy), table(zone.len_xz),
                              table(zone.len_yz))
    chain2 = table(zone.chain2, torch.int64)
    chain3 = table(zone.chain3, torch.int64)
    n_act = table(zone.n_active)

    uvb_cell = uvb.to(dtype).reshape(*ones[:-3], 3, 1, 1)    # ([1,]3,1,1)
    shape = (ndir, *plane_shape)
    i_top = uvb_cell.expand(shape)
    uvb_j = uvb_cell.expand(*shape[:-2], 1, shape[-1])
    uvb_k = uvb_cell.expand(*shape[:-1], 1)

    out = []
    for i in range(nslab):
        kappa = kappa_rot[i][None]                            # (1,[P,]3,ny,nz)

        def seg_tau(length):
            # (ndir,1,1,1) lengths -> (ndir,3,ny,nz) optical depth
            return kappa * (length * cell_size)

        # --- segment 1: xy (enters the bottom face) ---
        i_out1, lm1 = _attenuate(i_top, seg_tau(len_xy[i]))

        # --- segment 2: second chain segment (xz -> shift j, yz -> shift k) ---
        is2_xz = chain2[i] == SEG_XZ
        act2 = chain2[i] != 0
        i_in2 = torch.where(is2_xz, _shift_j(i_out1, uvb_j),
                            shift_k(i_out1, uvb_k))
        len2 = torch.where(is2_xz, len_xz[i], len_yz[i])
        i_out2, lm2 = _attenuate(i_in2, seg_tau(len2))

        # --- segment 3 ---
        is3_xz = chain3[i] == SEG_XZ
        act3 = chain3[i] != 0
        i_in3 = torch.where(is3_xz, _shift_j(i_out2, uvb_j),
                            shift_k(i_out2, uvb_k))
        len3 = torch.where(is3_xz, len_xz[i], len_yz[i])
        i_out3, lm3 = _attenuate(i_in3, seg_tau(len3))

        j_slab = (lm1 + torch.where(act2, lm2, 0.0)
                  + torch.where(act3, lm3, 0.0)) / n_act[i]
        out.append(weight * torch.sum(j_slab, dim=0))         # ([P,]3,ny,nz)

        i_top = torch.where(n_act[i] == 3, i_out3,
                            torch.where(n_act[i] == 2, i_out2, i_out1))
    return torch.stack(out)


def diffuse_sweep(kappa, plan: SweepPlan, uvb, cell_size) -> torch.Tensor:
    """Full multi-direction sweep.

    Args:
      kappa: (3, nx, ny, nz) band opacities [1/cm].
      plan: SweepPlan from build_sweep_plan.
      uvb: (3,) boundary band intensities.
      cell_size: base-cell size [cm].
    Returns:
      Jmean: (3, nx, ny, nz) angle-averaged mean intensity per band.
    """
    uvb = torch.as_tensor(uvb, dtype=kappa.dtype, device=kappa.device)
    kappa_l = torch.movedim(kappa, 0, -1)  # (nx,ny,nz,3) for axis transforms
    jmean = torch.zeros_like(kappa_l)
    for zone in plan.zones:
        krot = octants.rotate_to_sweep(kappa_l, zone.izone)   # (nxt,nyt,nzt,3)
        krot = torch.movedim(krot, -1, 1)                     # (nxt,3,nyt,nzt)
        j_rot = sweep_zone(krot, zone, uvb, cell_size, plan.weight)
        j_rot = torch.movedim(j_rot, 1, -1)                   # (nxt,nyt,nzt,3)
        jmean = jmean + octants.rotate_from_sweep(j_rot, zone.izone)
    return torch.movedim(jmean, -1, 0)
