"""PyTorch port, the 1-D grid mesh (radiativetransfer_tpu_torch/parallel/):
the pipelined, zone-parallel and ring sweeps (the ring is TPU kernel #3) on
a CPU mesh against the JAX package's on its virtual CPU devices (the JAX
ring kernel in interpret mode), the mode-9 step on a mesh for each sweep
strategy, the ring kernel's protocol replayed on the host under adversarial
schedules, and the errors of what is not ported."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import radiativetransfer_tpu_torch as rt
from radiativetransfer_tpu.core import state as jstate
from radiativetransfer_tpu.core import step as jstep
from radiativetransfer_tpu.core import sweep as jsweep
from radiativetransfer_tpu.parallel import mesh as jmesh
from radiativetransfer_tpu.parallel import sweep_dist as jdist
from radiativetransfer_tpu.parallel import sweep_rdma as jrdma
from radiativetransfer_tpu_torch.config import MODE_UVB_TRANSFER_ONLY
from radiativetransfer_tpu_torch.constants import KPC, MH, PSI
from radiativetransfer_tpu_torch.core import sweep as tsweep
from radiativetransfer_tpu_torch.core import sweep_cuda
from radiativetransfer_tpu_torch.core.sweep import _tau_eps
from radiativetransfer_tpu_torch.geometry.patterns import SEG_XZ, SEG_YZ
from radiativetransfer_tpu_torch.parallel import mesh as tmesh
from radiativetransfer_tpu_torch.parallel import sweep_dist, sweep_rdma
from test_torch_host import jax_compile_cache


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the port's eager ops are small CPU ops, on
    which more threads only spin beside the other test workers (module-
    scoped, so that the module's fixtures run pinned too)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _jax_cache(tmp_path_factory):
    """The JAX package's compiles shared by the port's parity modules of
    this test process (test_torch_host.jax_compile_cache)."""
    with jax_compile_cache(tmp_path_factory.getbasetemp() / "jax_cache"):
        yield


UVB = np.array([1.0, 0.5, 0.25])
# float32 against the JAX package: XLA's and PyTorch's float32 exp on the
# CPU differ by an ulp in ~10% of values, which the exact logmean's
# division by tau turns into up to 1.6e-5 elementwise (ROADMAP, faults
# found in the port; tests/test_torch_variants.py holds the zone kernel to
# the same)
ZONE_TOL_F32 = 4e-5


def _kappa(n, np_dtype=np.float64, seed=42):
    rng = np.random.default_rng(seed)
    return (rng.lognormal(0, 1, (3, n, n, n)) * 0.7 / KPC).astype(np_dtype)


def _cpu_mesh(p):
    return tmesh.make_grid_mesh(p, device="cpu")


def _jax_sharded(kappa, p):
    mesh = jmesh.make_grid_mesh(p)
    return jax.device_put(jnp.asarray(kappa),
                          jmesh.band_field_sharding(mesh)), mesh


def _assert_close(actual, desired, np_dtype):
    if np_dtype == np.float64:
        np.testing.assert_allclose(actual, desired, rtol=1e-12, atol=0.0)
    else:
        np.testing.assert_allclose(actual, desired, rtol=ZONE_TOL_F32,
                                   atol=ZONE_TOL_F32 * np.abs(desired).max())


# ---------------------------------------------------------------------------
# The three sweeps against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p", [2, 4])
def test_rdma_matches_jax_interpret(p):
    # the JAX ring kernel under the Pallas interpreter: ~5 s a case
    n, level = 8, 1
    kappa = _kappa(n)
    k_sh, jm = _jax_sharded(kappa, p)
    j_jax = np.asarray(jrdma.make_jitted_sweep_rdma(
        jsweep.build_sweep_plan(level, n), jm, interpret=True)(
            k_sh, jnp.asarray(UVB), KPC))
    before = sweep_rdma.RDMA_LAUNCHES
    j_t = sweep_rdma.diffuse_sweep_rdma(
        torch.from_numpy(kappa), tsweep.build_sweep_plan(level, n), UVB, KPC,
        _cpu_mesh(p))
    assert sweep_rdma.RDMA_LAUNCHES == before      # the CPU takes no kernel
    _assert_close(j_t.numpy(), j_jax, np.float64)


@pytest.mark.parametrize("np_dtype", [np.float64, np.float32])
@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("level,n", [(1, 8), (2, 12)])
def test_pipelined_matches_jax(level, n, p, np_dtype):
    kappa = _kappa(n, np_dtype)
    k_sh, jm = _jax_sharded(kappa, p)
    j_jax = np.asarray(jdist.make_jitted_sweep_dist(
        jsweep.build_sweep_plan(level, n), jm, "pipelined")(
            k_sh, jnp.asarray(UVB, np_dtype), KPC))
    j_t = sweep_dist.diffuse_sweep_pipelined(
        torch.from_numpy(kappa), tsweep.build_sweep_plan(level, n), UVB, KPC,
        _cpu_mesh(p))
    assert j_t.dtype == torch.from_numpy(kappa).dtype
    _assert_close(j_t.numpy(), j_jax, np_dtype)


def test_zone_parallel_matches_jax():
    # level 2: all 24 zones; 5 ranks: the last round leaves ranks idle
    n, level, p = 8, 2, 5
    kappa = _kappa(n)
    j_jax = np.asarray(jdist.make_jitted_sweep_dist(
        jsweep.build_sweep_plan(level, n), jmesh.make_grid_mesh(p), "zones")(
            jnp.asarray(kappa), jnp.asarray(UVB), KPC))
    before = sweep_cuda.ZONE_LAUNCHES
    j_t = sweep_dist.diffuse_sweep_zone_parallel(
        torch.from_numpy(kappa), tsweep.build_sweep_plan(level, n), UVB, KPC,
        _cpu_mesh(p))
    assert sweep_cuda.ZONE_LAUNCHES == before
    _assert_close(j_t.numpy(), j_jax, np.float64)


@pytest.mark.parametrize("p", [1, 3])
def test_mesh_sweeps_match_slab_scan(p):
    # P = 1 (one block, no halo) and P = 3 (n 6): the ring's plain version,
    # the pipelined scan and the zones sweep are the slab scan's function
    n = 6
    kappa = torch.from_numpy(_kappa(n))
    plan = tsweep.build_sweep_plan(2, n)
    mesh = _cpu_mesh(p)
    ref = tsweep.diffuse_sweep(kappa, plan, UVB, KPC).numpy()
    for fn in (sweep_rdma.diffuse_sweep_rdma,
               sweep_rdma.diffuse_sweep_rdma_reference,
               sweep_dist.diffuse_sweep_pipelined,
               sweep_dist.diffuse_sweep_zone_parallel):
        np.testing.assert_allclose(fn(kappa, plan, UVB, KPC, mesh).numpy(),
                                   ref, rtol=1e-12, err_msg=fn.__name__)


# ---------------------------------------------------------------------------
# The mode-9 step on a mesh
# ---------------------------------------------------------------------------


def _cfg(strategy):
    return rt.RunConfig(mode=MODE_UVB_TRANSFER_ONLY, current_redshift=6.55,
                        n_angular_level=1, reionization_model=10,
                        sweep_strategy=strategy)


@pytest.fixture(scope="module")
def mode9_inputs():
    """An f64 8^3 state (lognormal nH) as JAX and port states, and the
    port's single-device step from it."""
    n = 8
    rng = np.random.default_rng(3)
    nh = 2e-3 * rng.lognormal(0.0, 1.0, (n, n, n))
    js = jstate.make_state(nh * MH / PSI, np.full(nh.shape, 1e4), nh,
                           dtype=jnp.float64)
    ts = rt.FieldState.from_numpy(
        {f.name: (None if getattr(js, f.name) is None
                  else np.asarray(getattr(js, f.name)))
         for f in dataclasses.fields(js)}, dtype=torch.float64, device="cpu")
    geom = rt.GridGeometry(n, n, n, 300.0 * KPC)
    single = rt.RTModel.setup(_cfg("auto"), geom, torch.float64,
                              "cpu").make_step()(ts)
    return geom, js, ts, single


@pytest.mark.parametrize("strategy", ["pipelined", "zones", "rdma", "auto"])
def test_mode9_step_on_mesh_matches_jax(mode9_inputs, strategy):
    geom, js, ts, single = mode9_inputs
    p = 4
    jm = jstep.RTModel.setup(_cfg(strategy), geom, dtype=jnp.float64)
    jmesh_ = jmesh.make_grid_mesh(p)
    j_out = jm.make_step(mesh=jmesh_)(jmesh.shard_state(js, jmesh_))
    tm = rt.RTModel.setup(_cfg(strategy), geom, torch.float64, "cpu")
    mesh = _cpu_mesh(p)
    t_out = tm.make_step(mesh=mesh)(tmesh.shard_state(ts, mesh))
    # rtol 1e-11 on HI, as the JAX package's sharded-step tests hold it
    np.testing.assert_allclose(t_out.HI.numpy(), np.asarray(j_out.HI),
                               rtol=1e-11)
    np.testing.assert_allclose(t_out.HI.numpy(), single.HI.numpy(),
                               rtol=1e-11)
    np.testing.assert_allclose(t_out.Jmean.numpy(), single.Jmean.numpy(),
                               rtol=1e-11)
    assert tm.neutral_fraction(t_out) == pytest.approx(
        tm.neutral_fraction(single), rel=1e-11)


# ---------------------------------------------------------------------------
# The mesh's blocks, the ring's bytes and what raises
# ---------------------------------------------------------------------------


def test_blocks_round_trip():
    x = torch.arange(2 * 3 * 4 * 8, dtype=torch.float64).reshape(2, 3, 4, 8)
    blocks = tmesh.to_blocks(x, _cpu_mesh(4))
    assert blocks.shape == (4, 2, 3, 4, 2) and blocks.is_contiguous()
    for r in range(4):
        assert torch.equal(blocks[r], x[..., 2 * r:2 * r + 2])
    assert torch.equal(tmesh.from_blocks(blocks), x)


def test_halo_bytes():
    plan = tsweep.build_sweep_plan(2, 8)
    assert sweep_rdma.halo_bytes(plan, 1, 8, 4) == 0
    yz = sum(int((z.chain2 == SEG_YZ).sum() + (z.chain3 == SEG_YZ).sum())
             for z in plan.zones)
    assert yz > 0
    assert sweep_rdma.halo_bytes(plan, 4, 8, 4) == 2 * 3 * 3 * 8 * 4 * yz


@pytest.mark.parametrize("strategy", ["pipelined", "zones", "rdma"])
def test_strategy_requires_mesh(strategy):
    tm = rt.RTModel.setup(_cfg(strategy), rt.GridGeometry(4, 4, 4, 50 * KPC),
                          torch.float64, "cpu")
    with pytest.raises(ValueError, match="needs a mesh"):
        tm.make_step()(rt.uniform_state(4, dtype=torch.float64,
                                        device="cpu"))


def test_mesh_errors():
    state = rt.uniform_state(8, dtype=torch.float64, device="cpu")
    three = _cpu_mesh(3)
    with pytest.raises(ValueError, match="do not divide"):
        tmesh.shard_state(state, three)
    with pytest.raises(ValueError, match="do not divide"):
        sweep_dist.diffuse_sweep_pipelined(
            torch.from_numpy(_kappa(8)), tsweep.build_sweep_plan(1, 8), UVB,
            KPC, three)
    for call in (lambda: tmesh.make_grid_mesh(shape=(2, 4), device="cpu"),
                 lambda: tmesh.make_grid_mesh(2, device=["cuda:0", "cuda:1"]),
                 tmesh.maybe_initialize_distributed):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP, Distribution"):
            call()
    mesh = tmesh.make_grid_mesh(shape=(2,), device="cpu")
    assert (mesh.n_ranks, mesh.axis_name, mesh.device.type) == \
        (2, "gz", "cpu")
    assert tmesh.make_grid_mesh(4).device.type == "cuda"   # the card
    tm = rt.RTModel.setup(_cfg("rdma"), rt.GridGeometry(8, 8, 8, 50 * KPC),
                          torch.float64, "cpu")
    # point sources on a mesh build the source-parallel step
    # (tests/test_torch_rays_dist.py runs it); the domain tracer raises
    assert callable(tm.make_step(stellar=object(), mesh=mesh))
    tm.config = dataclasses.replace(tm.config, tracer_strategy="domain")
    with pytest.raises(NotImplementedError,
                       match="rays_domain.*ROADMAP, Distribution"):
        tm.make_step(stellar=object(), mesh=mesh)
    with pytest.raises(TypeError, match="GridMesh"):
        tm.make_step(mesh=object())


# ---------------------------------------------------------------------------
# The ring protocol of csrc/sweep_rdma.cu, replayed on the host
# ---------------------------------------------------------------------------


def _ring_cta(rank, d, b, blocks, lens, chains, ndir, ring, jout, weight,
              eps):
    """One CTA of the ring kernel, as a generator that yields wherever the
    card may run other CTAs: the same tables, slot indices and flags."""
    n_ranks, nslab, _, ny, nz = blocks.shape
    halo, seq, ack = ring
    per_rank = 3 * ndir
    mine = (rank * per_rank + d * 3 + b) * 4
    right = mine + per_rank * 4
    pad = UVB[b]
    last_sent = [-1] * 4

    def segment(i_in, kap, length):
        tau = kap * length
        a = np.exp(-tau)
        emi = np.where(tau > eps, (1.0 - a) / np.where(tau > eps, tau, 1.0),
                       1.0 - 0.5 * tau)
        return i_in * a, i_in * emi

    cur = np.full((ny, nz), pad)
    for i in range(nslab):
        row = (i * ndir + d) * 3
        kap = blocks[rank, i, b]
        cur, jacc = segment(cur, kap, lens[row])
        for s in range(2):
            ch = chains[row + s]
            if ch == 0:
                break
            slot = 2 * s + (i & 1)
            line = None
            if ch == SEG_YZ:
                if rank + 1 < n_ranks:
                    while last_sent[slot] >= 0 and \
                            ack[right + slot] < last_sent[slot] + 1:
                        yield
                    # the right rank has consumed what the slot holds
                    assert ack[right + slot] == seq[right + slot]
                    halo[right + slot] = cur[:, -1]
                    yield
                    seq[right + slot] = i + 1
                    last_sent[slot] = i
                if rank > 0:
                    while seq[mine + slot] < i + 1:
                        yield
                    assert seq[mine + slot] == i + 1    # not overwritten
                    line = halo[mine + slot].copy()
            if ch == SEG_XZ:
                i_in = np.concatenate([np.full((1, nz), pad), cur[:-1]], 0)
            else:
                first = (np.full((ny, 1), pad) if line is None
                         else line[:, None])
                i_in = np.concatenate([first, cur[:, :-1]], 1)
            cur, lm = segment(i_in, kap,
                              lens[row + (1 if ch == SEG_XZ else 2)])
            jacc = jacc + lm
            if line is not None:
                yield
                ack[mine + slot] = i + 1
        jout[rank, i, b] += weight * (jacc / chains[row + 2])
        yield


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ring_protocol_replayed(seed):
    # every CTA of a launch interleaved at random (each seed favours some
    # ranks, so senders run ahead of receivers and behind them): no
    # deadlock, no slot overwritten before its ACK, and the plain
    # version's result
    n, p = 6, 3
    rng = np.random.default_rng(seed)
    kappa = torch.from_numpy(_kappa(n))
    plan = tsweep.build_sweep_plan(2, n)
    eps = _tau_eps(torch.float64)
    speed = rng.uniform(0.05, 1.0, p)
    for zone in plan.zones:
        krot = sweep_cuda.rotate_to_zone(kappa, zone)
        blocks = tmesh.to_blocks(krot, _cpu_mesh(p))
        lens, chains = sweep_cuda.zone_arrays(zone, KPC, np.float64)
        ctas = p * zone.ndir * 3
        ring = (np.zeros((ctas * 4, n)), np.zeros(ctas * 4, int),
                np.zeros(ctas * 4, int))
        jout = np.zeros(blocks.shape)
        gens = [(r, _ring_cta(r, d, b, blocks.numpy(), lens, chains,
                              zone.ndir, ring, jout, plan.weight, eps))
                for r in range(p) for d in range(zone.ndir) for b in range(3)]
        for _ in range(200_000):
            if not gens:
                break
            w = np.array([speed[r] for r, _ in gens])
            k = rng.choice(len(gens), p=w / w.sum())
            try:
                next(gens[k][1])
            except StopIteration:
                gens.pop(k)
        assert not gens, f"zone {zone.izone}: the ring did not finish"
        ref = sweep_rdma.sweep_zone_rdma_reference(blocks, zone, UVB, KPC,
                                                   plan.weight)
        np.testing.assert_allclose(jout, ref.numpy(), rtol=1e-12,
                                   err_msg=f"zone {zone.izone}")
