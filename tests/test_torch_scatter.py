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
import re
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


def test_host_checks_refuse_what_the_kernel_does_not_take():
    # the card path's checks (scatter_cuda.check_rows) read dtypes, shapes,
    # strides, pointers and devices only, so they run on CPU tensors too
    acc = torch.zeros(16, 8)
    idx = torch.zeros(4, dtype=torch.int32)
    vals = torch.ones(4, 8)
    assert scatter_cuda.check_rows(acc, idx, vals) == 4
    assert scatter_cuda.check_rows(acc, idx[:0], vals[:0]) == 0
    with pytest.raises(TypeError, match="int32"):
        scatter_cuda.check_rows(acc, idx.long(), vals)
    with pytest.raises(TypeError, match="float32"):
        scatter_cuda.check_rows(acc.double(), idx, vals.double())
    with pytest.raises(ValueError, match="shapes"):
        scatter_cuda.check_rows(acc, idx, vals[:, :4].contiguous())
    with pytest.raises(ValueError, match="shapes"):
        scatter_cuda.check_rows(acc, idx[:3], vals)
    with pytest.raises(ValueError, match="shapes"):
        scatter_cuda.check_rows(acc[:, :4].contiguous(), idx,
                                vals[:, :4].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        scatter_cuda.check_rows(acc, idx, torch.ones(8, 4).t())
    with pytest.raises(ValueError, match="aligned"):
        # one float past a 16-byte boundary
        scatter_cuda.check_rows(acc, idx, torch.ones(4 * 8 + 1)[1:].view(4, 8))
    with pytest.raises(ValueError, match="device"):
        scatter_cuda.check_rows(acc, idx.to("meta"), vals)


def _kernel_source():
    return (Path(scatter_cuda.__file__).parents[1] / "csrc"
            / "scatter_rows.cu").read_text()


def _replay_kernel(acc, idx, vals, resident):
    """csrc/scatter_rows.cu's launch replayed on the host: grid_for's
    blocks of kThreads threads (at most the `resident` blocks the card
    holds, where that query answered), each thread's grid-stride loop
    taking kRows rows a pass, the rows outside [0, n_cells) dropped.
    Returns acc (float64 sums) and how often each row was taken."""
    src = _kernel_source()
    threads = int(re.search(r"constexpr int kThreads = (\d+);", src)[1])
    rows = int(re.search(r"constexpr int kRows = (\d+);", src)[1])
    m, n_cells = len(idx), acc.shape[0]
    blocks = -(-m // (threads * rows))
    if resident > 0:
        blocks = min(blocks, resident)
    stride = blocks * threads
    taken = np.zeros(m, np.int64)
    base = np.arange(stride)        # every thread's first row, then a pass
    while (base < m).any():         # of `rows` rows at a time
        live = base[base < m]
        r = (live[:, None] + stride * np.arange(rows)[None, :]).ravel()
        r = r[r < m]
        np.add.at(taken, r, 1)
        ok = r[(idx[r] >= 0) & (idx[r] < n_cells)]
        np.add.at(acc, idx[ok], vals[ok])
        base = base + rows * stride
    return acc, taken


@pytest.mark.parametrize("m,resident", [(1, 528), (1000, 528), (70000, 16),
                                        (8193, 3), (5000, 0)])
def test_kernel_row_walk_replayed_takes_every_row_once(m, resident):
    # the kernel's grid-stride walk takes each row exactly once (ragged
    # last passes, grids capped at the blocks the card holds, or not where
    # the occupancy query failed), and the rows outside the accumulator are
    # dropped: against np.add.at of the rows inside
    rng = np.random.default_rng(m)
    idx = rng.integers(-50, NC + 50, m)
    vals = rng.normal(0, 1, (m, 8))
    acc, taken = _replay_kernel(np.zeros((NC, 8)), idx, vals, resident)
    assert (taken == 1).all()
    inside = (idx >= 0) & (idx < NC)
    ref = np.zeros((NC, 8))
    np.add.at(ref, idx[inside], vals[inside])
    np.testing.assert_allclose(acc, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("m,n_cells", [(1, 16), (5000, 4096),
                                       (98304, 1 << 17)])
def test_floor_probe_plain_version(m, n_cells):
    # the probe's cells: lowbias32 of the row number, as the kernel hashes
    # it, spread over the accumulator; on the CPU the wrapper takes the
    # plain version and counts no launch
    cells = scatter_cuda.red_floor_cells(m, n_cells)
    assert cells.min() >= 0 and cells.max() < n_cells

    def lowbias32(x):
        x ^= x >> 16
        x = (x * 0x7FEB352D) & 0xFFFFFFFF
        x ^= x >> 15
        x = (x * 0x846CA68B) & 0xFFFFFFFF
        return x ^ (x >> 16)

    assert [lowbias32(r) % n_cells for r in range(min(m, 64))] == \
        cells[:64].tolist()
    before = scatter_cuda.FLOOR_LAUNCHES
    acc = scatter_cuda.red_floor(torch.zeros(n_cells, 8), m)
    assert scatter_cuda.FLOOR_LAUNCHES == before
    ref = np.zeros((n_cells, 8))
    np.add.at(ref, cells, 1.0)
    assert np.array_equal(acc.numpy(), ref)
