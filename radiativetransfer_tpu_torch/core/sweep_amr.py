"""Two-level AMR diffuse sweep, as plain PyTorch ops.

Counterpart of the JAX package's core/sweep_amr.py; extends the slab
sweep (core/sweep.py) to a nested grid, mirroring the reference's refined
transport (transportRoutinesModule.f90:560-963, setRaysRefined :121-218):

* The fine level sweeps its own 2n-slab template chain -- the SAME ray
  family as the base chain sampled at fine planes (setRaysRefined derives
  child footpoints from the parent's, :151-187), so the fine chain starts
  from the child-transformed base footpoint.
* Per base slab i the fine sub-slabs 2i, 2i+1 and the coarse slab i advance
  together; cross-level couplings follow the reference:
  - a fine cell whose upwind neighbor is coarse copies that coarse cell's
    face-exit output without interpolation (:637-648);
  - a coarse cell whose upwind neighbor is refined reads the fine child leaf
    selected by its ray footpoint (getXY/XZ/YZNeighbour descent, :455-558);
  - when the feeding template has no segment exiting the face (tag 0), the
    averaging fallback 0.5*(xy + side) applies (case(0), :618-634).
* In-slab couplings across refinement boundaries can chain along the plane;
  a fixed number of coupling passes (N_COUPLING_ITERS, Gauss-Seidel over
  [fine 2i, fine 2i+1, coarse i], the first without a coarse estimate)
  resolves chains up to that depth.

The JAX package's slab scan and zone scan are Python loops here, as in the
port's uniform slab sweep, and every operation is an eager PyTorch op: no
hand-written kernel runs on this path.  What XLA hoists out of the JAX
loops is made once here too: a zone's per-slab templates and refinement
masks as tensors before its slabs, a slab's attenuation factors before its
coupling passes.

Base cells under refined parents receive no direct J (their children do);
sync with amr.sync_restriction.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..geometry import healpix, octants, patterns
from ..geometry.patterns import SEG_XZ, TAG_XY, TAG_XZ, TAG_YZ
from .sweep import _attenuation, _shift_j, _shift_k

# Gauss-Seidel coupling passes per base slab (the JAX package's default)
N_COUPLING_ITERS = 3


@dataclasses.dataclass(frozen=True)
class AMRZoneBatch:
    """Per-zone templates for both levels (one direction batch)."""
    izone: int
    ndir: int
    coarse: dict      # arrays (ndir, n)
    fine: dict        # arrays (ndir, 2n)


@dataclasses.dataclass(frozen=True)
class AMRSweepPlan:
    zones: tuple[AMRZoneBatch, ...]
    n_directions: int
    nslab: int

    @property
    def weight(self) -> float:
        return 1.0 / self.n_directions


def _build_chain(phi, theta, nslab, x0=0.5, y0=0.5):
    tmpl = []
    for _ in range(nslab):
        t = patterns.set_pattern(x0, y0, phi, theta)
        tmpl.append(t)
        x0, y0 = t.next_x0, t.next_y0
    return tmpl


def _chain_arrays(tmpl) -> dict:
    def g(f, dt=np.float64):
        return np.array([getattr(t, f) for t in tmpl], dtype=dt)
    return {
        "len_xy": g("len_xy"), "len_xz": g("len_xz"), "len_yz": g("len_yz"),
        "chain2": g("chain2", np.int8), "chain3": g("chain3", np.int8),
        "n_active": g("n_active", np.int8),
        "top_xy": g("top_xy", np.int8), "top_xz": g("top_xz", np.int8),
        "top_yz": g("top_yz", np.int8),
        "x0": g("x0"), "y0": g("y0"),
        "xz_x0": g("xz_x0"), "xz_z0": g("xz_z0"),
        "yz_y0": g("yz_y0"), "yz_z0": g("yz_z0"),
    }


def _child_start(x0: float, y0: float) -> tuple[float, float]:
    """Fine-chain start footpoint from the base chain's slab-0 footpoint
    (setRaysRefined, transportRoutinesModule.f90:151-160)."""
    cx = 2 * x0 if x0 < 0.5 else 2 * x0 - 1.0
    cy = 2 * y0 if y0 < 0.5 else 2 * y0 - 1.0
    return cx, cy


def build_amr_sweep_plan(n_angular_level: int, nx: int) -> AMRSweepPlan:
    """Fold all HEALPix directions, group by zone, build both levels' slab
    templates on the host."""
    phi, theta = healpix.sweep_directions(n_angular_level)
    folded = octants.fold_all(phi, theta)
    groups = octants.group_by_zone(folded)
    zones = []
    for izone in sorted(groups):
        ds = groups[izone]
        coarse_list = [_chain_arrays(_build_chain(d.phi, d.theta, nx))
                       for d in ds]
        fine_list = [
            _chain_arrays(_build_chain(d.phi, d.theta, 2 * nx,
                                       *_child_start(0.5, 0.5)))
            for d in ds]
        coarse = {k: np.stack([c[k] for c in coarse_list])
                  for k in coarse_list[0]}
        fine = {k: np.stack([c[k] for c in fine_list]) for k in fine_list[0]}
        zones.append(AMRZoneBatch(izone=izone, ndir=len(ds), coarse=coarse,
                                  fine=fine))
    return AMRSweepPlan(zones=tuple(zones), n_directions=len(folded), nslab=nx)


def _prolong_plane(x):
    """(D,3,ny,nz) -> (D,3,2ny,2nz) parent copy."""
    return torch.repeat_interleave(torch.repeat_interleave(x, 2, dim=-2), 2,
                                   dim=-1)


def _np_dtype(dtype: torch.dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def _slab_tables(params: dict, cell_size: float, dtype: torch.dtype,
                 device) -> dict:
    """One level's templates of one zone as tensors with the slab first,
    so that table[i] is slab i's column: the segment lengths times the
    cell size in the run's dtype, the segment kinds, active counts and
    face-exit tags as masks, all (nslab, D, 1, 1, 1); the footpoint tests
    that pick a fine child as (nslab, D) int64 indices.  The float columns
    are rounded to the dtype before they are tested or scaled, as the JAX
    package's _slab_params rounds them."""
    def t(x):
        x = np.ascontiguousarray(np.asarray(x).T)
        return torch.as_tensor(x, device=device)[..., None, None, None]

    def f(key):
        return params[key].astype(_np_dtype(dtype))

    def child(key):
        return torch.as_tensor(np.ascontiguousarray(f(key).T >= 0.5),
                               device=device).to(torch.int64)

    c2, c3, n_act = params["chain2"], params["chain3"], params["n_active"]
    len_xy, len_xz, len_yz = (t(f(k)) for k in ("len_xy", "len_xz",
                                                "len_yz"))
    out = {
        "len1": len_xy * cell_size,
        "len2": torch.where(t(c2 == SEG_XZ), len_xz, len_yz) * cell_size,
        "len3": torch.where(t(c3 == SEG_XZ), len_xz, len_yz) * cell_size,
        "is2_xz": t(c2 == SEG_XZ), "act2": t(c2 != 0),
        "is3_xz": t(c3 == SEG_XZ), "act3": t(c3 != 0),
        "n_act": t(n_act.astype(_np_dtype(dtype))),
        "n_act3": t(n_act == 3), "n_act2": t(n_act == 2),
        # xy footpoint -> the coarse consumer's fine child below it;
        # side footpoints -> the sub-slab (z0) and the child (x0 or y0)
        "cj_xy": child("y0"), "ck_xy": child("x0"),
        "ck_xz": child("xz_x0"), "sub_xz": t(f("xz_z0") >= 0.5),
        "cj_yz": child("yz_y0"), "sub_yz": t(f("yz_z0") >= 0.5),
    }
    for face in ("top_xz", "top_yz"):
        tag = params[face]
        out[face] = (t(tag == TAG_XY), t(tag == TAG_XZ), t(tag == TAG_YZ))
    return out


def _segment_factors(kappa_slab, sp):
    """The three segments' (e^-tau, (1-e^-tau)/tau) on one slab plane: they
    depend on the opacities and the templates only, so the coupling passes
    of a slab share them (sp: the slab's column of _slab_tables, lengths
    already times the level's cell size)."""
    return [_attenuation(kappa_slab * sp[k]) for k in ("len1", "len2",
                                                       "len3")]


def _segment_outputs(i_top_in, factors, sp, side_j, side_k,
                     want_segs: bool = False):
    """All 3 chained segment outputs for one slab plane.

    factors: _segment_factors of the slab.  side_j / side_k: callables
    mapping a segment-output plane to the upwind side-input plane (closures
    encode level coupling and boundaries), or a pair of them, the first
    for segment 2's input and the second for segment 3's (the windowed
    block-sparse sweep's per-segment boundary lines, core/sweep_sparse.py).
    want_segs also returns the chained intermediates that the side
    closures consume, "seg1" and "seg2", for that sweep's window merge.
    """
    sj2, sj3 = side_j if isinstance(side_j, tuple) else (side_j, side_j)
    sk2, sk3 = side_k if isinstance(side_k, tuple) else (side_k, side_k)
    (a1, e1), (a2, e2), (a3, e3) = factors
    i_out1, lm1 = i_top_in * a1, i_top_in * e1

    i_in2 = torch.where(sp["is2_xz"], sj2(i_out1), sk2(i_out1))
    i_out2, lm2 = i_in2 * a2, i_in2 * e2

    i_in3 = torch.where(sp["is3_xz"], sj3(i_out2), sk3(i_out2))
    i_out3, lm3 = i_in3 * a3, i_in3 * e3

    act2 = sp["act2"]
    j_slab = (lm1 + torch.where(act2, lm2, 0.0)
              + torch.where(sp["act3"], lm3, 0.0)) / sp["n_act"]
    top = torch.where(sp["n_act3"], i_out3,
                      torch.where(sp["n_act2"], i_out2, i_out1))

    is2_xz = sp["is2_xz"]
    out_xz = torch.where(is2_xz, i_out2, i_out3)
    out_yz = torch.where(is2_xz, i_out3, i_out2)
    # face-exit plane by per-slab tag; TAG_NONE -> case(0) averaging
    # fallback 0.5*(xy + active side) (:618-634)
    fallback = 0.5 * (i_out1 + torch.where(act2, i_out2, i_out1))

    def by_tag(tag):
        is_xy, is_xz, is_yz = tag
        return torch.where(is_xy, i_out1, torch.where(
            is_xz, out_xz, torch.where(is_yz, out_yz, fallback)))

    out = {"top": top, "j_slab": j_slab,
           "exit_jface": by_tag(sp["top_xz"]),
           "exit_kface": by_tag(sp["top_yz"])}
    if want_segs:
        out["seg1"], out["seg2"] = i_out1, i_out2
    return out


def _slab(tables: dict, i: int) -> dict:
    return {k: (tuple(x[i] for x in v) if isinstance(v, tuple) else v[i])
            for k, v in tables.items()}


def _sel_child(plane_f, dirs, cj, ck):
    """(D,3,2ny,2nz) fine plane -> (D,3,ny,nz): per direction d the child
    (cj[d], ck[d]) of each coarse cell (dirs = arange(D); cj, ck int64
    tensors in {0,1}).  The advanced indices are separated by slices, so
    their broadcast dimension (D) goes to the front, giving (D,3,ny,nz), as
    in NumPy and JAX."""
    D, _, ny2, nz2 = plane_f.shape
    f = plane_f.reshape(D, 3, ny2 // 2, 2, nz2 // 2, 2)
    return f[dirs, :, :, cj, :, ck]


def _refinement_masks(refined_rot):
    """Per-slab refinement masks of one zone, all slabs at once: the slab's
    own map (n, ny, nz) and its fine copy (n, 2ny, 2nz), the map of the
    slab below (all False under slab 0) on both levels, which fine side
    reads stay on the fine level (the j-1 / k-1 neighbor is a refined
    cell's fine child) and which coarse side reads go down to the fine
    level (the j-1 / k-1 coarse neighbor is refined)."""
    n, ny, nz = refined_rot.shape
    dev = refined_rot.device
    r = refined_rot
    rf = torch.repeat_interleave(torch.repeat_interleave(r, 2, 1), 2, 2)
    below = torch.cat([torch.zeros((1, ny, nz), dtype=torch.bool,
                                   device=dev), r[:-1]])
    below_f = torch.cat([torch.zeros((1, 2 * ny, 2 * nz), dtype=torch.bool,
                                     device=dev), rf[:-1]])
    nb_j = torch.cat([torch.zeros((n, 1, 2 * nz), dtype=torch.bool,
                                  device=dev), rf[:, :-1, :]], dim=1)
    nb_k = torch.cat([torch.zeros((n, 2 * ny, 1), dtype=torch.bool,
                                  device=dev), rf[:, :, :-1]], dim=2)
    odd_j = (torch.arange(2 * ny, device=dev) % 2 == 1)[:, None]
    odd_k = (torch.arange(2 * nz, device=dev) % 2 == 1)[None, :]
    c_nb_j = torch.cat([torch.zeros((n, 1, nz), dtype=torch.bool,
                                    device=dev), r[:, :-1, :]], dim=1)
    c_nb_k = torch.cat([torch.zeros((n, ny, 1), dtype=torch.bool,
                                    device=dev), r[:, :, :-1]], dim=2)
    return {"r": r, "rf": rf, "below": below, "below_f": below_f,
            "nb_fine_j": torch.where(odd_j, rf, nb_j),
            "nb_fine_k": torch.where(odd_k, rf, nb_k),
            "c_nb_ref_j": c_nb_j, "c_nb_ref_k": c_nb_k}


def sweep_zone_amr(kc_rot, kf_rot, refined_rot, zone_params, uvb,
                   cell_size, weight):
    """Sweep one zone over a two-level grid.

    kc_rot: (n, 3, ny, nz); kf_rot: (2n, 3, 2ny, 2nz);
    refined_rot: (n, ny, nz) bool; zone_params: (coarse, fine) template
    dicts of (D, n)/(D, 2n) host arrays.
    Returns (jc_rot (n,3,ny,nz), jf_rot (2n,3,2ny,2nz)): fine slab 2i is
    the first sub-slab of base slab i, 2i+1 the second.
    """
    coarse_params, fine_params = zone_params
    n, _, ny, nz = kc_rot.shape
    dtype, device = kc_rot.dtype, kc_rot.device
    D = coarse_params["len_xy"].shape[0]
    uvb = torch.as_tensor(uvb, dtype=dtype, device=device).reshape(1, 3, 1, 1)
    uvb_cell_c = uvb.expand(D, 3, ny, nz)
    uvb_cell_f = uvb.expand(D, 3, 2 * ny, 2 * nz)
    uvb_j_c, uvb_k_c = uvb.expand(D, 3, 1, nz), uvb.expand(D, 3, ny, 1)
    uvb_j_f, uvb_k_f = uvb.expand(D, 3, 1, 2 * nz), uvb.expand(D, 3, 2 * ny,
                                                               1)

    cp = _slab_tables(coarse_params, cell_size, dtype, device)
    # fine segments are in fine-cell units: half the base size
    # (transport recursion, transportRoutinesModule.f90:583)
    fp = _slab_tables(fine_params, cell_size / 2.0, dtype, device)
    masks = _refinement_masks(refined_rot)
    dirs = torch.arange(D, device=device)
    ones = torch.ones(D, dtype=torch.int64, device=device)

    def sel_child(plane_f, cj, ck):
        return _sel_child(plane_f, dirs, cj, ck)

    def fine_pass(xy_in, factors, spf, nb_j, nb_k, coarse_exit):
        if coarse_exit is None:
            def side_j(x):
                return _shift_j(x, uvb_j_f)

            def side_k(x):
                return _shift_k(x, uvb_k_f)
        else:
            exit_j, exit_k = coarse_exit

            def side_j(x):
                return torch.where(nb_j, _shift_j(x, uvb_j_f), exit_j)

            def side_k(x):
                return torch.where(nb_k, _shift_k(x, uvb_k_f), exit_k)
        return _segment_outputs(xy_in, factors, spf, side_j, side_k)

    def coarse_pass(xy_in, factors, spc, c_nb_j, c_nb_k, f0_est, f1_est):
        # the fine leaf under the side ray's footpoint: xz rays pick the
        # sub-slab by z0 and the k-child by x0 (j-child 1, the face-adjacent
        # row); yz rays the sub-slab by z0 and the j-child by y0
        ck = spc["ck_xz"]
        leaf_j = torch.where(spc["sub_xz"],
                             sel_child(f1_est["exit_jface"], ones, ck),
                             sel_child(f0_est["exit_jface"], ones, ck))
        fine_exit_j = _shift_j(leaf_j, uvb_j_c)
        cj = spc["cj_yz"]
        leaf_k = torch.where(spc["sub_yz"],
                             sel_child(f1_est["exit_kface"], cj, ones),
                             sel_child(f0_est["exit_kface"], cj, ones))
        fine_exit_k = _shift_k(leaf_k, uvb_k_c)

        def side_j(x):
            return torch.where(c_nb_j, fine_exit_j, _shift_j(x, uvb_j_c))

        def side_k(x):
            return torch.where(c_nb_k, fine_exit_k, _shift_k(x, uvb_k_c))
        return _segment_outputs(xy_in, factors, spc, side_j, side_k)

    ic_top, if_top = uvb_cell_c, uvb_cell_f
    jc_out, jf_out = [], []
    for i in range(n):
        spc, spf0, spf1 = _slab(cp, i), _slab(fp, 2 * i), _slab(fp, 2 * i + 1)
        r_i, r_f = masks["r"][i], masks["rf"][i]
        nb_j, nb_k = masks["nb_fine_j"][i], masks["nb_fine_k"][i]
        c_nb_j, c_nb_k = masks["c_nb_ref_j"][i], masks["c_nb_ref_k"][i]
        att_c = _segment_factors(kc_rot[i][None], spc)
        att_f0 = _segment_factors(kf_rot[2 * i][None], spf0)
        att_f1 = _segment_factors(kf_rot[2 * i + 1][None], spf1)

        # ---- xy (bottom-face) inputs, fixed for this slab ----
        f0_xy_in = torch.where(masks["below_f"][i], if_top,
                               _prolong_plane(ic_top))
        # coarse consumer picks the fine child under its xy footpoint:
        # y0 -> j-child, x0 -> k-child
        c_xy_in = torch.where(
            masks["below"][i],
            sel_child(if_top, spc["cj_xy"], spc["ck_xy"]), ic_top)

        # Gauss-Seidel coupling passes, the first without a coarse estimate
        f0 = fine_pass(f0_xy_in, att_f0, spf0, nb_j, nb_k, None)
        f1 = fine_pass(f0["top"], att_f1, spf1, nb_j, nb_k, None)
        c = coarse_pass(c_xy_in, att_c, spc, c_nb_j, c_nb_k, f0, f1)
        for _ in range(1, N_COUPLING_ITERS):
            coarse_exit = (
                _prolong_plane(_shift_j(c["exit_jface"], uvb_j_c)),
                _prolong_plane(_shift_k(c["exit_kface"], uvb_k_c)))
            f0 = fine_pass(f0_xy_in, att_f0, spf0, nb_j, nb_k, coarse_exit)
            f1 = fine_pass(f0["top"], att_f1, spf1, nb_j, nb_k, coarse_exit)
            c = coarse_pass(c_xy_in, att_c, spc, c_nb_j, c_nb_k, f0, f1)

        ic_top = c["top"]
        if_top = torch.where(r_f, f1["top"], _prolong_plane(c["top"]))

        jc_out.append(weight * torch.sum(torch.where(r_i, 0.0, c["j_slab"]),
                                         dim=0))
        for f in (f0, f1):
            jf_out.append(weight * torch.sum(
                torch.where(r_f, f["j_slab"], 0.0), dim=0))
    return torch.stack(jc_out), torch.stack(jf_out)


def diffuse_sweep_amr(kappa_c, kappa_f, refined, plan: AMRSweepPlan, uvb,
                      cell_size):
    """Full two-level sweep.

    kappa_c: (3,n,n,n); kappa_f: (3,2n,2n,2n); refined: (n,n,n) bool.
    Returns (Jmean_base (3,n,n,n), Jmean_fine (3,2n,2n,2n)); base J is zero
    under refined parents (sync via amr.sync_restriction).  The zones are
    summed in the JAX package's order: zones of equal direction count
    together, in the order those counts first appear.
    """
    kc_l = torch.movedim(kappa_c, 0, -1)
    kf_l = torch.movedim(kappa_f, 0, -1)
    refined = torch.as_tensor(refined, device=kappa_c.device).to(torch.bool)
    jc_acc = torch.zeros_like(kc_l)
    jf_acc = torch.zeros_like(kf_l)
    groups: dict[int, list[AMRZoneBatch]] = {}
    for zone in plan.zones:
        groups.setdefault(zone.ndir, []).append(zone)
    for zones in groups.values():
        for zone in zones:
            iz = zone.izone
            kc_rot = torch.movedim(octants.rotate_to_sweep(kc_l, iz), -1, 1)
            kf_rot = torch.movedim(octants.rotate_to_sweep(kf_l, iz), -1, 1)
            r_rot = octants.rotate_to_sweep(refined, iz)
            jc, jf = sweep_zone_amr(kc_rot, kf_rot, r_rot,
                                    (zone.coarse, zone.fine), uvb, cell_size,
                                    plan.weight)
            jc_acc = jc_acc + octants.rotate_from_sweep(
                torch.movedim(jc, 1, -1), iz)
            jf_acc = jf_acc + octants.rotate_from_sweep(
                torch.movedim(jf, 1, -1), iz)
    return torch.movedim(jc_acc, -1, 0), torch.movedim(jf_acc, -1, 0)
