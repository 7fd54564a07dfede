"""PyTorch port, the row scatter (TPU kernel #8): the plain version
(index_add_) against the JAX kernel in interpret mode and against the
script's own oracle, np.add.at, the CPU path of the wrapper, its bound, and
the experiment's entry point, which refuses to run without a card.

The script's launcher takes no interpret flag and sizes its accumulator at
128^3 cells, so the test builds pallas_scatter_once's grid spec around the
script's own kernel body, in interpret mode, for a smaller accumulator.  In
interpret mode the kernel is right for one grid step only: it copies the
input accumulator at step 0 and relies on the TPU keeping the output block
resident across steps, which the interpreter does not.  So the JAX kernel
is held at one chunk of 2048 rows, and np.add.at at several chunks."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from radiativetransfer_tpu_torch import exp_row_scatter
from radiativetransfer_tpu_torch.core import scatter_cuda

_SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / \
    "exp_pallas_scatter.py"
_spec = importlib.util.spec_from_file_location("_jax_exp_pallas_scatter",
                                               _SCRIPT)
xscatter = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(xscatter)

NC = 4096
CHUNK = xscatter.CHUNK


def _rows(m, nc=NC, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, nc, m).astype(np.int32),
            rng.normal(0, 1, (m, 8)).astype(np.float32))


def _scatter_interpret(idx, vals, acc):
    """pallas_scatter_once's grid spec around the script's kernel body, at
    acc's size, in interpret mode."""
    nc = acc.shape[0]
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(idx.shape[0] // CHUNK,),
        in_specs=[pl.BlockSpec((CHUNK, 8), lambda i, *_: (i, 0)),
                  pl.BlockSpec((nc, 8), lambda i, *_: (0, 0))],
        out_specs=pl.BlockSpec((nc, 8), lambda i, *_: (0, 0)))
    return pl.pallas_call(
        xscatter._scatter_kernel, grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((nc, 8), jnp.float32),
        input_output_aliases={2: 0}, interpret=True)(idx, vals, acc)


def test_plain_matches_jax_kernel_one_chunk():
    idx, vals = _rows(CHUNK)
    acc0 = np.random.default_rng(1).normal(0, 1, (NC, 8)).astype(np.float32)
    j_out = np.asarray(_scatter_interpret(jnp.asarray(idx),
                                          jnp.asarray(vals),
                                          jnp.asarray(acc0)))
    t_out = scatter_cuda.scatter_rows_reference(
        torch.from_numpy(acc0.copy()), torch.from_numpy(idx),
        torch.from_numpy(vals))
    # f32 sums in another order where rows share a cell
    assert np.abs(t_out.numpy() - j_out).max() <= 1e-5


@pytest.mark.parametrize("chunks", [1, 3, 8])
def test_plain_matches_add_at(chunks):
    m = chunks * CHUNK
    idx, vals = _rows(m, seed=chunks)
    ref = np.zeros((NC, 8))
    np.add.at(ref, idx, vals.astype(np.float64))
    scatter_cuda.LAUNCHES = 0
    out = scatter_cuda.scatter_rows(torch.zeros(NC, 8), torch.from_numpy(idx),
                                    torch.from_numpy(vals))
    assert scatter_cuda.LAUNCHES == 0          # the CPU takes the plain one
    assert np.abs(out.numpy() - ref).max() <= 1e-5


def test_wrapper_is_in_place_on_cpu():
    idx, vals = _rows(100)
    acc = torch.ones(NC, 8)
    out = scatter_cuda.scatter_rows(acc, torch.from_numpy(idx),
                                    torch.from_numpy(vals))
    assert out is acc
    ref = torch.ones(NC, 8).index_add_(0, torch.from_numpy(idx),
                                       torch.from_numpy(vals))
    assert torch.equal(acc, ref)


def test_bound_counts_100_bytes_a_row():
    # 4 (index) + 32 (row) + 32 + 32 (the accumulator's 32-byte sector read
    # and written), at 3.35 TB/s
    assert scatter_cuda.BYTES_PER_ROW == 100
    assert scatter_cuda.bound_ms(786432) == pytest.approx(
        1e3 * 786432 * 100 / 3.35e12)
    assert scatter_cuda.bound_ms(786432) == pytest.approx(0.0235, abs=5e-5)


def test_script_shapes():
    assert exp_row_scatter.NC == xscatter.NC == 128 ** 3
    assert exp_row_scatter.MS == (98304, 393216, 786432)
    # the script's rows from seed 0: indices then values, per M
    rng = np.random.default_rng(0)
    idx, vals = exp_row_scatter.rows(np.random.default_rng(0), 98304)
    np.testing.assert_array_equal(idx, rng.integers(0, xscatter.NC, 98304))
    np.testing.assert_array_equal(vals, rng.normal(0, 1, (98304, 8)))


def test_entry_point_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA device"):
        exp_row_scatter.main()
