"""PyTorch port, core/debug.py: the checked pre-flight (CheckMode, the
torch analogue of the JAX package's `checkify`) on the inputs and with the
verdicts of the JAX package's tests/test_debug.py -- the 12^3 uniform
state with one source, and TestNestedPreflight's 8^3 three-level grid in
its L-level dense and block-sparse forms.  The clean pre-flights pass; a
NaN density, and a NaN in a sparse block, raise naming the op; the checked
trace equals the production trace bit for bit; an out-of-range index, an
integer division by zero and a NaN each raise inside the mode before the
op changes anything.  JAX's checkify is not run here: its verdicts on
these inputs are what tests/test_debug.py asserts."""

import dataclasses

import numpy as np
import pytest
import torch

from radiativetransfer_tpu_torch.config import RunConfig
from radiativetransfer_tpu_torch.constants import KPC, MYR
from radiativetransfer_tpu_torch.core import (amr, amr_sparse, debug, rays,
                                              step_amr)
from radiativetransfer_tpu_torch.core import step as step_mod
from radiativetransfer_tpu_torch.core.state import (GridGeometry,
                                                    uniform_state)
from radiativetransfer_tpu_torch.tables import stellar as stellar_tables


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the checked paths are small CPU ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return RunConfig(mode=8, current_redshift=6.55, n_angular_level=1,
                     reionization_model=10, grid="t")


def _ctx(geom):
    batch = rays.SourceBatch(position=np.array([[0.5, 0.5, 0.5]]),
                             weight=np.ones(1),
                             table_idx=np.zeros(1, np.int32))
    return step_mod.StellarContext.build(
        stellar_tables.blackbody_population(), batch, geom, 10.0 * MYR,
        metal_coefs=[(0, 0.0)], max_pixel_level=2, dtype=torch.float64,
        device="cpu")


@pytest.fixture(scope="module")
def model_state_ctx():
    n = 12
    geom = GridGeometry(n, n, n, 100.0 * KPC)
    rt = step_mod.RTModel.setup(_cfg(), geom, torch.float64, "cpu")
    state = rt.initialize_equilibrium(
        uniform_state(n, nh=1e-4, tgas=2e4, dtype=torch.float64,
                      device="cpu"))
    return rt, state, _ctx(geom)


def test_preflight_clean_on_valid_data(model_state_ctx):
    rt, state, ctx = model_state_ctx
    debug.preflight(rt, state, ctx)


def test_poisoned_density_is_caught(model_state_ctx):
    rt, state, ctx = model_state_ctx
    rho = state.rho.clone()
    rho[0, 0, 0] = float("nan")
    bad = dataclasses.replace(state, rho=rho)
    with pytest.raises(FloatingPointError, match="nan generated by op"):
        debug.checked_sweep_chemistry(rt, bad)


def test_checked_trace_matches_production(model_state_ctx):
    """Instrumentation does not change results: bit for bit."""
    rt, state, ctx = model_state_ctx
    rf_c, diag_c = debug.checked_trace(
        state, rt.geom, ctx.sources, ctx.tables, max_pixel_level=2,
        dtype=torch.float64)
    rf_p, diag_p = rays.trace_point_sources(
        state, rt.geom, ctx.sources, ctx.tables, max_pixel_level=2,
        dtype=torch.float64)
    for f in dataclasses.fields(rf_p):
        assert torch.equal(getattr(rf_c, f.name), getattr(rf_p, f.name))
    for f in dataclasses.fields(diag_p):
        assert torch.equal(getattr(diag_c, f.name), getattr(diag_p, f.name))


def test_checked_sweep_chemistry_matches_production(model_state_ctx):
    """The checked sweep and chemistry equal the production step's on the
    CPU (where the production sweep is the same slab scan)."""
    rt, state, _ = model_state_ctx
    cfg9 = dataclasses.replace(rt.config, mode=9)
    rt9 = step_mod.RTModel.setup(cfg9, rt.geom, torch.float64, "cpu")
    checked = debug.checked_sweep_chemistry(rt9, state)
    prod = rt9.make_step()(state)
    for name in ("HI", "HeI", "HeII", "Jmean"):
        assert torch.equal(getattr(checked, name), getattr(prod, name)), name


@pytest.mark.parametrize("op", ["index_add_", "getitem", "setitem",
                                "index_select", "gather", "take",
                                "index_put_", "scatter_add_", "index_copy_"])
def test_out_of_range_index_raises_before_the_op(op):
    x = torch.arange(10, dtype=torch.float64)
    before = x.clone()
    bad = torch.tensor([2, 10])
    calls = {
        "index_add_": lambda: x.index_add_(0, bad, torch.ones(2,
                                                              dtype=x.dtype)),
        "getitem": lambda: x[torch.tensor([3, -11])],
        "setitem": lambda: x.__setitem__(bad, 1.0),
        "index_select": lambda: torch.index_select(x, 0, bad),
        "gather": lambda: torch.gather(x, 0, bad),
        "take": lambda: torch.take(x, bad),
        "index_put_": lambda: x.index_put_((bad,), torch.ones(2,
                                                              dtype=x.dtype)),
        "scatter_add_": lambda: x.scatter_add_(0, bad,
                                               torch.ones(2, dtype=x.dtype)),
        "index_copy_": lambda: x.index_copy_(0, bad, torch.ones(
            2, dtype=x.dtype)),
    }
    with debug.CheckMode():
        with pytest.raises(IndexError, match="index out of bounds for "
                                             "dimension 0 with size 10"):
            calls[op]()
    assert torch.equal(x, before)
    # in range, the same ops run under the mode
    with debug.CheckMode():
        y = x.clone()
        y.index_add_(0, torch.tensor([0, 9]), torch.ones(2, dtype=x.dtype))
        assert float(y[torch.tensor([-1])]) == 10.0


def test_index_checks_follow_the_indexed_dimension():
    """A key's integer tensors are held to the dimension they index,
    past slices, None and an Ellipsis."""
    x = torch.zeros((2, 3, 4))
    with debug.CheckMode():
        x[..., torch.tensor([3])]
        x[:, None, torch.tensor([2])]
        with pytest.raises(IndexError, match="dimension 2 with size 4"):
            x[..., torch.tensor([4])]
        with pytest.raises(IndexError, match="dimension 1 with size 3"):
            x[0, torch.tensor([3])]


def test_integer_division_by_zero_and_nan_raise():
    a = torch.arange(4)
    with debug.CheckMode():
        with pytest.raises(ZeroDivisionError, match="floor_divide|"
                                                    "__floordiv__"):
            a // torch.zeros(4, dtype=torch.int64)
        with pytest.raises(ZeroDivisionError, match="remainder|__mod__"):
            torch.remainder(a, 0)
        # a float division by zero is inf, which passes (checkify's float
        # checks flag NaN alone)
        assert bool(torch.isinf(torch.ones(1) / 0.0).all())
        with pytest.raises(FloatingPointError,
                           match="nan generated by op sqrt"):
            torch.sqrt(torch.tensor([-1.0]))
    # outside the mode nothing is checked
    assert bool(torch.isnan(torch.sqrt(torch.tensor([-1.0]))).all())


def test_deferred_nan_flags_name_the_first_op():
    """A card's NaN flags are read in batches (CheckMode.flush): the first
    op whose flag is set is named, and the batch is gone after."""
    mode = debug.CheckMode()
    mode._pending = [("add", torch.tensor(False)), ("mul", torch.tensor(True)),
                     ("exp", torch.tensor(True))]
    with pytest.raises(FloatingPointError, match="nan generated by op mul$"):
        mode.flush()
    assert mode._pending == []
    mode.flush()


def _nested():
    """TestNestedPreflight's 8^3 three-level grid: clustered refinement
    from seed 3, balanced, each level in equilibrium, the restriction
    synced; its dense L-level and block-sparse forms with their models
    and the one-source context."""
    n, L = 8, 3
    geom = GridGeometry(n, n, n, 100.0 * KPC)
    rt = step_mod.RTModel.setup(_cfg(), geom, torch.float64, "cpu")
    rng = np.random.default_rng(3)
    refined = []
    m = n
    for _ in range(L - 1):
        r = np.zeros((m,) * 3, bool)
        c = m // 2
        r[c - 2:c + 2, c - 2:c + 2, c - 2:c + 2] = (
            rng.random((4, 4, 4)) < 0.6)
        refined.append(r)
        m *= 2
    refined = amr.enforce_balance(refined)
    cov = np.ones((n,) * 3, bool)
    for ell in range(L - 1):
        refined[ell] &= cov
        cov = np.repeat(np.repeat(np.repeat(refined[ell], 2, 0), 2, 1), 2, 2)
    levels = [rt.initialize_equilibrium(
        uniform_state(n * 2 ** ell, nh=1e-4, tgas=2e4, dtype=torch.float64,
                      device="cpu")) for ell in range(L)]
    ml = amr.sync_restriction_multi(
        amr.make_multilevel_state(levels[0], refined, levels[1:]))
    sp = amr_sparse.sparse_from_dense(ml, be=8)
    return (rt, ml, sp, step_amr.MultiLevelModel.setup(rt, L),
            step_amr.SparseMLModel.setup(rt, L), _ctx(geom))


@pytest.fixture(scope="module")
def nested():
    return _nested()


def test_sparse_preflight_clean(nested):
    rt, ml, sp, dense, sparse, ctx = nested
    debug.preflight_sparse(sparse, sp, ctx)


def test_ml_preflight_clean(nested):
    rt, ml, sp, dense, sparse, ctx = nested
    debug.preflight_ml(dense, ml, ctx)


def test_sparse_poisoned_block_is_caught(nested):
    rt, ml, sp, dense, sparse, ctx = nested
    lv = sp.levels[0]
    bad_hi = lv.fields.HI.clone()
    bad_hi[0, 0, 0, 0] = float("nan")
    bad = dataclasses.replace(sp, levels=(
        dataclasses.replace(lv, fields=dataclasses.replace(lv.fields,
                                                           HI=bad_hi)),)
        + sp.levels[1:])
    with pytest.raises(FloatingPointError, match="nan generated by op"):
        debug.checked_sweep_chemistry_sparse(sparse, bad)


def test_checked_nested_traces_match_production(nested):
    rt, ml, sp, dense, sparse, ctx = nested
    from radiativetransfer_tpu_torch.core import rays_multilevel as rml
    for checked, prod, state in (
            (debug.checked_trace_ml, rml.trace_point_sources_ml, ml),
            (debug.checked_trace_sparse, rml.trace_point_sources_sparse,
             sp)):
        rfs_c, diag_c = checked(state, rt.geom, ctx.sources, ctx.tables,
                                max_pixel_level=2, dtype=torch.float64)
        rfs_p, diag_p = prod(state, rt.geom, ctx.sources, ctx.tables,
                             max_pixel_level=2, dtype=torch.float64)
        for rf_c, rf_p in zip(rfs_c, rfs_p):
            for f in dataclasses.fields(rf_p):
                assert torch.equal(getattr(rf_c, f.name),
                                   getattr(rf_p, f.name))
        assert torch.equal(diag_c.ndot_remaining, diag_p.ndot_remaining)
