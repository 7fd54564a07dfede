"""PyTorch port, the block-sparse L-level tracer
(core/rays_multilevel.py::trace_point_sources_sparse) against the JAX
package's on the same NumPy inputs, and against the port's dense L-level
tracer, on the CPU.

The state: the JAX tests' clustered 8^3 base with two refined levels
(tests/test_amr_sparse.py's refinement, seed 7), every level's hydrogen
and helium partly ionized (helium in both ionized states, so that every
channel is reached), stored block-sparse in blocks of 8 and of 4 (blocks
of 4 cross more block faces); one source, and three (one on the z = 0
face), at maxPixelLevel 3 in a 300 kpc box.  In float64, in the table,
quadrature and quadrature_noneq modes (each in both block edges, each
block edge with one and with three sources): every channel on each level's
blocks within 1e-9 of its peak of the JAX package's trace, the
diagnostics, escape fractions and spectrum within 1e-9; the port's dense
tracer on the same state gives the same deposits on every covered cell,
bit for bit; host_phases with chunk_steps 7 gives the default's deposits
bit for bit and fills LAST_TRACE_PHASE_TIMES; no finest-resolution
volume is built."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiativetransfer_tpu.core import amr_sparse as jas
from radiativetransfer_tpu.core import rays as jrays
from radiativetransfer_tpu.core import rays_multilevel as jrml
from radiativetransfer_tpu.core import state as jstate
from radiativetransfer_tpu_torch.constants import KPC, MHE, PSI
from radiativetransfer_tpu_torch.core import amr as tamr
from radiativetransfer_tpu_torch.core import amr_sparse as tas
from radiativetransfer_tpu_torch.core import rays as trays
from radiativetransfer_tpu_torch.core import rays_multilevel as trml
from radiativetransfer_tpu_torch.core import state as tstate
from test_torch_amr_sparse import clustered_ml, jax_sparse_np, port_ml
from test_torch_rays import _tables
from test_torch_rays_ml import noneq_tables, port_tables
from test_torch_host import jax_compile_cache

N, L = 8, 3
BOX = 300.0 * KPC
F64 = torch.float64
# every rate mode in both block edges, each block edge with one source
# and with three (each case costs a JAX compile)
CASES = [(8, 1, "table"), (8, 3, "quadrature"), (8, 3, "quadrature_noneq"),
         (4, 1, "quadrature"), (4, 3, "table"), (4, 3, "quadrature_noneq")]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the eager march's small ops, module-scoped
    so that it holds for the module fixtures too."""
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


def dense_state(seed=7):
    """The JAX MultiLevelState (see the module's docstring) and its
    refinement maps."""
    ml, refined = clustered_ml(N, seed=seed, scale=1e-4)
    rng = np.random.default_rng(seed + 1)
    levels = []
    for lv in ml.levels:
        shape = lv.rho.shape
        nh = np.asarray(lv.nh)
        nhe = (1.0 - PSI) * np.asarray(lv.rho) / MHE
        levels.append(dataclasses.replace(
            lv, HI=jnp.asarray(nh * rng.uniform(1e-3, 3e-2, shape)),
            HeI=jnp.asarray(nhe * rng.uniform(1e-3, 3e-2, shape)),
            HeII=jnp.asarray(nhe * rng.uniform(1e-2, 3e-1, shape))))
    return dataclasses.replace(ml, levels=tuple(levels)), refined


def sources(n_src):
    """One source near the refined centre; three adds a coarse one and
    one on the z = 0 face."""
    pos = np.array([[0.5 + 0.25 / N, 0.5 + 0.75 / N, 0.5 + 0.25 / N],
                    [0.3, 0.47, 0.55], [0.3, 0.7, 0.5 / N]])
    return dict(position=pos[:n_src], weight=np.array([1.0, 2.0, 0.5])[:n_src],
                table_idx=np.array([0, 1, 0], np.int32)[:n_src])


def _tables_for(mode):
    return noneq_tables() if mode == "quadrature_noneq" else _tables()


def port_trace(tsp, n_src, mode, **kw):
    tgeom = tstate.GridGeometry(N, N, N, BOX)
    return trml.trace_point_sources_sparse(
        tsp, tgeom, trays.SourceBatch(**sources(n_src)),
        port_tables(_tables_for(mode), tgeom), max_pixel_level=3, dtype=F64,
        rates_mode=mode, **kw)


@pytest.fixture(scope="module")
def traces():
    """{(be, sources, mode): (JAX trace, port trace)} and {be: (JAX sparse
    state, port sparse state)}, with the dense JAX state and its maps."""
    ml, refined = dense_state()
    states, out = {}, {}
    for be in (8, 4):
        jsp = jas.sparse_from_dense(ml, be=be)
        states[be] = jsp, tas.SparseMLState.from_numpy(
            jax_sparse_np(jsp), dtype=F64, device="cpu")
    for be, n_src, mode in CASES:
        jsp, tsp = states[be]
        j = jrml.trace_point_sources_sparse(
            jsp, jstate.GridGeometry(N, N, N, BOX),
            jrays.SourceBatch(**sources(n_src)), _tables_for(mode),
            max_pixel_level=3, dtype=jnp.float64, rates_mode=mode)
        out[be, n_src, mode] = (j, port_trace(tsp, n_src, mode))
    return out, states, ml, refined


@pytest.mark.parametrize("be,n_src,mode", CASES)
def test_trace_sparse_matches_jax_f64(traces, be, n_src, mode):
    (jrfs, jdiag), (trfs, tdiag) = traces[0][be, n_src, mode]
    tsp = traces[1][be][1]
    assert len(trfs) == len(jrfs) == L
    w = sources(n_src)["weight"]
    for ell, (a, b) in enumerate(zip(trfs, jrfs)):
        assert type(a).__name__ == type(b).__name__
        size = N ** 3 if ell == 0 else tsp.levels[ell - 1].cover.numel()
        assert a.krate24.shape == (size,)
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name).numpy(), np.asarray(getattr(b, f.name))
            peak = float(np.abs(y).max())
            # every level and every channel is reached
            assert peak > 0.0, (ell, f.name)
            assert np.abs(x - y).max() <= 1e-9 * peak, (ell, f.name)
            if ell:
                # nothing lands in the padding block
                pad = x.reshape(-1, be ** 3)[-1]
                assert not pad.any(), (ell, f.name)
    pairs = [(getattr(tdiag, f.name).numpy(),
              np.asarray(getattr(jdiag, f.name)), f.name)
             for f in dataclasses.fields(jdiag)]
    pairs += [(trays.escape_fractions(tdiag, w),
               jrays.escape_fractions(jdiag, w), "escape"),
              (trays.cosmic_spectrum(tdiag, w, 3),
               jrays.cosmic_spectrum(jdiag, w, 3), "spectrum")]
    for a, b, name in pairs:
        assert np.abs(a - b).max() <= 1e-9 * np.abs(b).max(), name


@pytest.mark.parametrize("be,mode", [(8, "quadrature"),
                                     (4, "quadrature_noneq")])
def test_sparse_equals_port_dense_tracer(traces, be, mode):
    """The same state dense (trace_point_sources_ml) and block-sparse:
    every channel equal on every covered cell, the diagnostics equal, bit
    for bit (the same rays, the same deposit order on the CPU)."""
    out, states, ml, refined = traces
    tsp = states[be][1]
    trfs_s, tdiag_s = out[be, 3, mode][1]
    tgeom = tstate.GridGeometry(N, N, N, BOX)
    trfs_d, tdiag_d = trml.trace_point_sources_ml(
        port_ml(ml), tgeom, trays.SourceBatch(**sources(3)),
        port_tables(_tables_for(mode), tgeom), max_pixel_level=3, dtype=F64,
        rates_mode=mode)
    cover = [c.numpy() for c in tamr.cover_masks(
        [torch.as_tensor(r) for r in refined], (N,) * 3, "cpu")]
    for ell, (a, b) in enumerate(zip(trfs_s, trfs_d)):
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name).numpy(), getattr(b, f.name).numpy()
            if ell:
                lv = tsp.levels[ell - 1]
                x = tas.unblockify_like(lv, x.reshape(lv.cover.shape))
                y = y.reshape((N * 2 ** ell,) * 3)
            else:
                x, y = x.reshape((N,) * 3), y.reshape((N,) * 3)
            np.testing.assert_array_equal(x[cover[ell]], y[cover[ell]],
                                          err_msg=f"{ell} {f.name}")
            assert np.abs(y[cover[ell]]).max() > 0.0, (ell, f.name)
    for f in dataclasses.fields(tdiag_d):
        assert torch.equal(getattr(tdiag_s, f.name),
                           getattr(tdiag_d, f.name)), f.name


def test_host_phases_match_default(traces, monkeypatch):
    """host_phases with chunk_steps 7: the default's deposits and
    diagnostics bit for bit, each phase's seconds, march steps and alive
    counts in LAST_TRACE_PHASE_TIMES; and neither form builds a
    finest-resolution volume."""
    def no_volume(*args, **kwargs):
        raise AssertionError("a finest-resolution volume was built")
    monkeypatch.setattr(trml, "leaf_level_volume", no_volume)
    tsp = traces[1][4][1]
    steps0 = trml.MARCH_STEPS
    want = port_trace(tsp, 3, "quadrature")
    steps_default = trml.MARCH_STEPS - steps0
    trml.LAST_TRACE_PHASE_TIMES.clear()
    got = port_trace(tsp, 3, "quadrature", host_phases=True, chunk_steps=7)
    for a, b in zip(got[0], want[0]):
        for f in dataclasses.fields(b):
            assert torch.equal(getattr(a, f.name), getattr(b, f.name))
    for f in dataclasses.fields(want[1]):
        assert torch.equal(getattr(got[1], f.name), getattr(want[1], f.name))
    rec = trml.LAST_TRACE_PHASE_TIMES
    assert sorted(rec) == sorted(f"level{k}{s}" for k in (1, 2, 3)
                                 for s in ("", "_steps", "_alive"))
    for k in (1, 2, 3):
        steps, alive = rec[f"level{k}_steps"], rec[f"level{k}_alive"]
        assert rec[f"level{k}"] > 0.0 and steps > 0
        # a count every 7 march steps and where the phase ended, 0
        assert len(alive) == -(-steps // 7) and alive[-1] == 0
        assert all(c > 0 for c in alive[:-1])
    # both end a phase at the same any(alive) check
    assert sum(rec[f"level{k}_steps"] for k in (1, 2, 3)) == steps_default
