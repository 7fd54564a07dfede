"""PyTorch port, the TPU's two sweep experiments (#6, #7) on the cluster
kernel (csrc/sweep_cluster_exp.cu, core/variants_cuda.py): their size rule
and launch shapes, the register model of their instances, and the
kernel's control flow in each experiment Mode replayed on the host (row
bands, G-direction work items with ragged groups, the rows staged per
work item, each lean variant's policy with noemi's inactive segments, the
pair's two-slab trip with its held deposit) against the plain versions
and, at one small size, against the JAX package's _lean_kernel and
_pair_kernel in interpret mode.  The kernels themselves run only on a card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_variants import (
    _lean_call_interpret,
    _pair_call_interpret,
    xpair,
    xvar,
)

from radiativetransfer_tpu.core import sweep as jsweep
from radiativetransfer_tpu_torch.constants import KPC
from radiativetransfer_tpu_torch.core import sweep as tsweep
from radiativetransfer_tpu_torch.core import (
    sweep_cluster,
    sweep_cuda,
    variants_cuda,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the port's eager ops are small CPU ops, on
    which more threads only spin beside the other test workers (module-
    scoped, so that the module's fixtures run pinned too)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


UVB = np.array([1.0, 0.5, 0.25])
SMEM_OPTIN = 232448
# tests/test_torch_variants.py's tolerances
TOL = {torch.float32: 2e-6, torch.float64: 1e-12}


def _kappa(n, dtype, seed=42):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.lognormal(0, 1, (3, n, n, n)) * 0.7
                            / KPC).to(dtype)


def _plain(kappa, plan, mode):
    if mode == "pair":
        return variants_cuda.sweep_pair_reference(kappa, plan, UVB, KPC)
    return variants_cuda.lean_sweep_reference(kappa, plan, UVB, KPC, mode)


def _segment(mode, dtype):
    """One segment of the Mode's instance, op for op as csrc/
    sweep_cluster.cuh's segment and lean_segment: (i_in, kappa, 1/kappa,
    the directions' rows (g, slots, 1, 1), segment k) -> (i_out, lm)."""
    if mode == "pair":
        eps = tsweep._tau_eps(dtype)

        def seg(i_in, kap, ikap, row, k):
            tau_n = kap * row[:, k]
            a = torch.exp(tau_n)
            emi = torch.where(tau_n < -eps, (a - 1.0) * ikap * row[:, 4 + k],
                              1.0 + 0.5 * tau_n)
            return i_in * a, i_in * emi
        return seg
    f = variants_cuda.flags(mode)
    eps = variants_cuda._eps_c(dtype, f["use_exp2"])
    exp = torch.exp2 if f["use_exp2"] else torch.exp

    def seg(i_in, kap, ikap, row, k):
        ln, c, h, sp = row[:, k], row[:, 3 + k], row[:, 6 + k], row[:, 9 + k]
        tau_n = kap * ln
        a = exp(tau_n)
        i_out = i_in * a
        if f["no_emi"]:
            return i_out, i_out
        if f["clamped"]:
            d = i_in - i_in * torch.clamp(a, max=variants_cuda._A_EPS)
            return i_out, d * torch.minimum(
                ikap * c, sp * (1.0 / variants_cuda._EPS_CL))
        return i_out, torch.where(tau_n < -eps, (i_out - i_in) * (ikap * c),
                                  i_in * (sp + h * kap))
    return seg


def _emulate(kappa, plan, mode, shape):
    """csrc/sweep_cluster.cuh's body in an experiment's Mode on the host:
    each work item (a band and <= G directions, their rows staged) walked
    by C CTAs of row bands, one slab a trip (two in the pair, whose first
    slab's deposit is held until the second slab's segment 1 is done);
    segment 1 in place; then, unless seg1, the union of the directions'
    chained stages, each writing every CTA's staging plane (under noemi
    each direction's last output, active or not) before any CTA reads
    (the cluster barrier), the j-shift reading the neighbour CTA's edge
    row (the pad at the plane's edge), the k-shift inside the CTA, noshift
    reading the cell itself; an inactive segment skipped, except under
    noemi, where every direction runs both stages, an inactive segment as
    a k-shift whose output adds to the logmean and feeds the next stage but
    not the carry; the G directions' weighted logmeans summed before one
    deposit per cell."""
    dtype = kappa.dtype
    perms, meta, lens, chains = variants_cuda._tables(plan, KPC, mode, dtype,
                                                      "cpu")
    jmean, kperm, ikperm, jperm = sweep_cuda.launch_buffers(kappa, "exact",
                                                             perms)
    seg = _segment(mode, dtype)
    noemi, slabs = mode == "noemi", 2 if mode == "pair" else 1
    nslab, ny, nz = kperm[0].shape[1:]
    bands = sweep_cluster.row_bands(ny, shape.csize)
    for d0, count, band, _ in sweep_cluster.work_items(meta.numpy(),
                                                       shape.group):
        dirs = slice(d0, d0 + count)
        p, reverse = meta[d0, :2].tolist()
        flip_j = meta[dirs, 2].bool()[:, None, None]
        flip_k = meta[dirs, 3].bool()[:, None, None]
        pad = torch.tensor(float(UVB[band]), dtype=dtype)
        rows, codes = lens[dirs], chains[dirs]      # the staged rows
        carry = [pad.expand(count, r1 - r0, nz) for r0, r1 in bands]
        last = list(carry)
        acc, held = [None] * len(bands), None
        for i0 in range(0, nslab, slabs):
            s0 = nslab - 1 - i0 if reverse else i0
            for h in range(slabs):
                i = i0 + h
                s = s0 - h if reverse else s0 + h
                row = rows[:, i][:, :, None, None]        # (g, slots, 1, 1)
                kap = [kperm[p][band, s, r0:r1] for r0, r1 in bands]
                ikap = [ikperm[p][band, s, r0:r1] for r0, r1 in bands]
                for r in range(len(bands)):
                    carry[r], acc[r] = seg(carry[r], kap[r], ikap[r], row, 0)
                    last[r] = carry[r]
                if h == 1:
                    for r, (r0, r1) in enumerate(bands):
                        jperm[p][band, s0, r0:r1] += held[r]
                for stage in (1, 2):
                    code = codes[:, i, stage - 1][:, None, None]
                    if mode == "seg1" or not (noemi or (code != 0).any()):
                        break
                    planes = [x.clone() for x in (last if noemi else carry)]
                    for r in range(len(bands)):
                        src = planes[r]
                        n_rows = src.shape[1]
                        edge = pad.expand(count, 1, nz)
                        lo = planes[r - 1][:, -1:] if r > 0 else edge
                        hi = (planes[r + 1][:, :1] if r + 1 < len(bands)
                              else edge)
                        j_in = torch.where(
                            flip_j, torch.cat([src[:, 1:], hi], 1),
                            torch.cat([lo, src[:, :n_rows - 1]], 1))
                        kpad = pad.expand(count, n_rows, 1)
                        k_in = torch.where(
                            flip_k, torch.cat([src[:, :, 1:], kpad], 2),
                            torch.cat([kpad, src[:, :, :-1]], 2))
                        i_in = (carry[r] if mode == "noshift"
                                else torch.where(code == 1, j_in, k_in))
                        i_out, lm = seg(i_in, kap[r], ikap[r], row, stage)
                        on = code != 0
                        carry[r] = torch.where(on, i_out, carry[r])
                        if noemi:
                            last[r] = i_out
                            acc[r] = acc[r] + lm
                        else:
                            acc[r] = torch.where(on, acc[r] + lm, acc[r])
                w = (plan.weight * row[:, 3] if mode == "pair"
                     else torch.full((count, 1, 1), plan.weight, dtype=dtype))
                deps = []
                for r in range(len(bands)):
                    terms = w * acc[r]
                    dep = terms[0]
                    for g in range(1, count):
                        dep = dep + terms[g]
                    deps.append(dep)
                if slabs == 2 and h == 0:
                    held = deps
                else:
                    for r, (r0, r1) in enumerate(bands):
                        jperm[p][band, s, r0:r1] += deps[r]
    return sweep_cuda.gather_jmean(jmean, jperm, perms)


def _shape(n, dtype, mode, csize, group):
    return sweep_cluster.cluster_shapes(n, n, dtype, csize, group, mode=mode,
                                        nslab=n)[0]


# n 6 and 7 split into ragged row bands (C 4 and 2); level 1 has launches of
# 1 and 2 directions, so G 2 leaves ragged groups; C 8 at n 8 puts one row
# on each CTA, both its neighbours' edge rows read
CASES = [(1, 6, 4, 2), (1, 7, 2, 1), (2, 8, 8, 2)]


@pytest.mark.parametrize("mode,level,n,csize,group", [
    (mode, *case) for mode in variants_cuda.MODES for case in CASES
    if mode != "pair" or case[1] % 2 == 0])     # the pair: nslab even
def test_experiment_control_flow_emulated(mode, level, n, csize, group):
    kappa = _kappa(n, torch.float32)
    plan = tsweep.build_sweep_plan(level, n)
    j = _emulate(kappa, plan, mode,
                 _shape(n, torch.float32, mode, csize, group))
    np.testing.assert_allclose(j.numpy(), _plain(kappa, plan, mode).numpy(),
                               rtol=TOL[torch.float32])


@pytest.mark.parametrize("level,n,csize,group", [(1, 6, 4, 2),
                                                 (2, 8, 2, 1)])
def test_pair_control_flow_emulated_f64(level, n, csize, group):
    kappa = _kappa(n, torch.float64)
    plan = tsweep.build_sweep_plan(level, n)
    j = _emulate(kappa, plan, "pair",
                 _shape(n, torch.float64, "pair", csize, group))
    np.testing.assert_allclose(j.numpy(), _plain(kappa, plan, "pair").numpy(),
                               rtol=TOL[torch.float64])


@pytest.mark.parametrize("mode", ["lean", "noemi", "pair"])
def test_emulation_matches_jax_interpret(mode, monkeypatch):
    # the base lean arithmetic, noemi's inactive segments and the pair's
    # trip against the JAX package's kernels themselves, in interpret mode
    monkeypatch.setattr(xvar, "_lean_call", _lean_call_interpret)
    monkeypatch.setattr(xpair, "_pair_call", _pair_call_interpret)
    n = 4
    kappa = _kappa(n, torch.float32)
    jplan = jsweep.build_sweep_plan(1, n)
    args = (jnp.asarray(kappa.numpy()), jplan,
            jnp.asarray(UVB, np.float32), KPC)
    j_jax = np.asarray(xpair.pair_sweep(*args) if mode == "pair"
                       else xvar.lean_sweep(*args,
                                            **variants_cuda.flags(mode)))
    j = _emulate(kappa, tsweep.build_sweep_plan(1, n), mode,
                 _shape(n, torch.float32, mode, 2, 2))
    np.testing.assert_allclose(j.numpy(), j_jax, rtol=TOL[torch.float32])


@pytest.mark.parametrize("mode,n,dtype", [
    (mode, n, torch.float32) for mode in variants_cuda.MODES
    for n in (6, 7, 8, 64, 128, 256)] + [
    ("pair", n, torch.float64) for n in (8, 64, 128)])   # lean: float32
def test_experiment_shapes_fit_one_cta(mode, n, dtype):
    itemsize = torch.finfo(dtype).bits // 8
    shapes = variants_cuda.variant_shapes(n, dtype, mode)
    assert shapes, (mode, n, dtype)
    slots = 8 if mode == "pair" else 16
    for s in shapes:
        rows_max = -(-n // s.csize)
        planes = (0 if mode in ("seg1", "noshift")
                  else 2 * s.group * rows_max * n * itemsize)
        # the staging planes (none without shifts), then every slab's rows
        # and chain codes of the G directions
        assert s.smem == planes + s.group * n * (slots * itemsize + 8)
        assert s.smem <= SMEM_OPTIN
        assert s.group in sweep_cluster.EXP_GROUP_SIZES
        assert s.cpt in sweep_cluster.EXP_CELLS_PER_THREAD
        assert s.threads % 32 == 0 and s.threads * s.cpt >= rows_max * n
        assert s.threads <= sweep_cluster.max_threads(s.group, s.cpt,
                                                      itemsize, mode=mode)
    assert variants_cuda.choose_variant_cluster(n, dtype, mode) in shapes


@pytest.mark.parametrize("mode", variants_cuda.MODES)
def test_size_rule_takes_the_measured_shapes(mode):
    # (C, G, cells, threads) at 128^3 and 256^3 in float32: the lean
    # variants the merged sweep's shape, the pair 2 cells a thread; every
    # experiment has a shape at 256^3 (1024 threads x 4 cells, 16 CTAs)
    rule = {128: (8, 2, 4, 512), 256: (16, 2, 4, 1024)}
    if mode == "pair":
        rule = {128: (16, 2, 2, 512), 256: (16, 1, 4, 1024)}
    for n, want in rule.items():
        s = variants_cuda.choose_variant_cluster(n, torch.float32, mode)
        assert (s.csize, s.group, s.cpt, s.threads) == want
    # nothing fits a 384^3 plane: the wrappers take the plane kernels
    assert variants_cuda.choose_variant_cluster(384, torch.float32,
                                                mode) is None


def test_experiment_register_model():
    # every experiment instance the library builds has a block; the pair's
    # second slab costs registers: G 2 x 4 cells keeps 512 threads, G 1 x 4
    # the 1024 that 256^3 needs; the lean variants fit the merged sweep's
    for mode in variants_cuda.MODES:
        for group in sweep_cluster.EXP_GROUP_SIZES:
            for cpt in sweep_cluster.EXP_CELLS_PER_THREAD:
                for itemsize in (4, 8):
                    assert sweep_cluster.max_threads(group, cpt, itemsize,
                                                     mode=mode) > 0
                if mode != "pair":
                    assert sweep_cluster.max_threads(group, cpt, 4,
                                                     mode=mode) == \
                        sweep_cluster.max_threads(group, cpt, 4)
    assert sweep_cluster.max_threads(2, 4, 4, mode="pair") == 512
    assert sweep_cluster.max_threads(1, 4, 4, mode="pair") == 1024
    assert sweep_cluster.max_threads(2, 4, 4) == 1024


def test_cpu_wrappers_take_plain_versions():
    n = 6
    kappa = _kappa(n, torch.float32)
    plan = tsweep.build_sweep_plan(2, n)
    variants_cuda.LAUNCHES.clear()
    variants_cuda.CLUSTER_LAUNCHES.clear()
    for mode in variants_cuda.MODES:
        ref = _plain(kappa, plan, mode)
        if mode == "pair":
            outs = (variants_cuda.sweep_pair(kappa, plan, UVB, KPC),
                    variants_cuda.sweep_pair_plane_kernel(kappa, plan, UVB,
                                                          KPC))
        else:
            outs = (variants_cuda.lean_sweep(kappa, plan, UVB, KPC, mode),
                    variants_cuda.lean_sweep_plane_kernel(kappa, plan, UVB,
                                                          KPC, mode))
        for out in outs:
            assert torch.equal(out, ref)
        # the cluster instances take a CUDA tensor only
        with pytest.raises(ValueError, match="no sweep kernel for device"):
            variants_cuda.cluster_kernel(kappa, plan, UVB, KPC, mode)
    assert sum(variants_cuda.LAUNCHES.values()) == 0
    assert sum(variants_cuda.CLUSTER_LAUNCHES.values()) == 0
    with pytest.raises(ValueError, match="variant"):
        variants_cuda.variant_shapes(n, torch.float32, "lean2")
