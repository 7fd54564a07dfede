"""Runtime sanitizers: the checked pre-flight of the compute paths.

Counterpart of the JAX package's core/debug.py, name for name.  The
reference guards its hot paths with ~40 stop-asserts (intensity sanity,
geometry bound checks, species-range checks -- e.g. checkPoint,
equiSources.f90:2962-2976).  The JAX package instruments its XLA paths
with `checkify` (index, float and division checks) and runs them once on
the ingested data (the CLI's --debug-checkify).  Here `CheckMode`, one
`torch.overrides.TorchFunctionMode`, does the same for the eager PyTorch
paths, with the JAX package's three error sets (its ERRORS):

* "index": before every gather, scatter or index op given an integer
  tensor index (__getitem__/__setitem__, index_select, gather, take,
  index_add_, index_put_, scatter_add_, index_copy_, ...) the index's
  range is read back to the host and held to the indexed dimension: an
  IndexError names the op and the bad range BEFORE the op runs.  On a
  CUDA device an out-of-bounds access is a device-side assert that
  poisons the context instead of raising, so the check has to come first;
* "float": after every op with a floating output (for a write into part
  of a tensor, the values written), a NaN in it raises FloatingPointError
  naming the op (checkify's NaN check; an inf passes, as there; on a card
  the NaN flags are read back in batches, CheckMode.flush);
* "div": an integer division or remainder by zero raises
  ZeroDivisionError naming the op, before it runs (a CUDA integer division
  by zero gives garbage, not an error).

The production modules are not edited: the mode costs nothing unless a
checked_* function enters it, and then a host read per op.  The checked
sweeps run the plain PyTorch formulation (core/sweep.py's slab scan, the
nested sweeps' torch ops), not the hand-written CUDA kernel, as the JAX
package's run its lax.scan formulation and not the Pallas kernel: a CUDA
kernel's accesses are not torch ops the mode can see, and the plain
version computes the same Jmean (chip_smoke.py holds the two together).
That is the checked formulation by design, not a fallback.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.overrides import TorchFunctionMode

from . import amr, chemistry, opacity, rays, rays_multilevel, sweep
from . import sweep_multilevel, sweep_sparse

# ops given (tensor, dim, index) whose index must lie in [0, size(dim))
_DIM_INDEX_OPS = {
    "index_select", "index_add", "index_add_", "index_copy", "index_copy_",
    "index_fill", "index_fill_", "index_reduce", "index_reduce_", "gather",
    "scatter", "scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
    "scatter_reduce_"}
# advanced indexing: negative indices wrap, [-size, size)
_KEY_OPS = {"__getitem__", "__setitem__"}
_PUT_OPS = {"index_put", "index_put_"}
_TAKE_OPS = {"take"}
# integer division and remainder; the __r*__ forms divide by self
_INT_DIV_OPS = {"floor_divide", "floor_divide_", "remainder", "remainder_",
                "fmod", "fmod_", "__floordiv__", "__ifloordiv__", "__mod__",
                "__imod__"}
_INT_RDIV_OPS = {"__rfloordiv__", "__rmod__"}
_ROUNDED_DIV_OPS = {"div", "div_", "divide", "divide_", "true_divide",
                    "true_divide_"}
# ops whose floating output is not computed from their inputs
_UNCHECKED_OUTPUT = {"empty", "empty_like", "new_empty", "empty_strided",
                     "new_empty_strided", "__get__", "__set__"}
# ops that write their source into part of a tensor (which may hold
# torch.empty's garbage elsewhere): the values written are what they
# compute, (position, name) of that argument
_PARTIAL_WRITES = {"__setitem__": (2, "value"), "index_put_": (2, "values"),
                   "index_put": (2, "values"), "index_copy_": (3, "source"),
                   "index_copy": (3, "source"), "scatter_": (3, "src"),
                   "masked_scatter_": (2, "source")}


def _op_name(func) -> str:
    return getattr(func, "__name__", None) or str(func)


def _is_int_index(x) -> bool:
    return (torch.is_tensor(x) and not x.dtype.is_floating_point
            and not x.dtype.is_complex and x.dtype != torch.bool)


def _index_span(index: torch.Tensor) -> tuple[int, int] | None:
    if index.numel() == 0:
        return None
    lo, hi = torch.stack([index.min(), index.max()]).tolist()
    return lo, hi


def _check_range(name: str, index, size: int, dim: int,
                 negative: bool) -> None:
    if not torch.is_tensor(index):
        if isinstance(index, (list, tuple)) and index and all(
                isinstance(v, int) and not isinstance(v, bool)
                for v in index):
            index = torch.tensor(index)
        else:
            return
    if not _is_int_index(index):
        return
    span = _index_span(index)
    if span is None:
        return
    lo, hi = span
    if hi >= size or lo < (-size if negative else 0):
        raise IndexError(
            f"{name}: index out of bounds for dimension {dim} with size "
            f"{size}: the indices span [{lo}, {hi}]")


def _check_key(name: str, t: torch.Tensor, key) -> None:
    """The integer-tensor entries of an advanced-indexing key against the
    dimensions they index."""
    key = key if isinstance(key, tuple) else (key,)

    def width(k):
        if k is None or k is Ellipsis:
            return 0
        if torch.is_tensor(k) and k.dtype == torch.bool:
            return max(k.dim(), 1)
        return 1
    used = sum(width(k) for k in key)
    dim = 0
    for k in key:
        if k is Ellipsis:
            dim += t.dim() - used
            continue
        if dim < t.dim() and (_is_int_index(k) or isinstance(k, list)):
            _check_range(name, k, t.shape[dim], dim, negative=True)
        dim += width(k)


def _arg(args, kwargs, pos: int, name: str):
    if len(args) > pos:
        return args[pos]
    return kwargs.get(name)


def _check_indices(name: str, args, kwargs) -> None:
    if name in _KEY_OPS and len(args) >= 2 and torch.is_tensor(args[0]):
        _check_key(name, args[0], args[1])
    elif name in _DIM_INDEX_OPS:
        t = _arg(args, kwargs, 0, "input")
        dim, index = _arg(args, kwargs, 1, "dim"), _arg(args, kwargs, 2,
                                                        "index")
        if torch.is_tensor(t) and isinstance(dim, int):
            d = dim % max(t.dim(), 1)
            _check_range(name, index, t.shape[d] if t.dim() else 1, d,
                         negative=False)
    elif name in _PUT_OPS:
        t, indices = _arg(args, kwargs, 0, "input"), _arg(args, kwargs, 1,
                                                           "indices")
        if torch.is_tensor(t) and isinstance(indices, (tuple, list)):
            _check_key(name, t, tuple(indices))
    elif name in _TAKE_OPS:
        t, index = _arg(args, kwargs, 0, "input"), _arg(args, kwargs, 1,
                                                         "index")
        if torch.is_tensor(t):
            _check_range(name, index, t.numel(), 0, negative=True)


def _is_integral(x) -> bool:
    if torch.is_tensor(x):
        return not (x.dtype.is_floating_point or x.dtype.is_complex
                    or x.dtype == torch.bool)
    return isinstance(x, int) and not isinstance(x, bool)


def _check_div(name: str, args, kwargs) -> None:
    if name in _INT_RDIV_OPS:
        num, den = _arg(args, kwargs, 1, "other"), args[0] if args else None
    elif name in _INT_DIV_OPS or (name in _ROUNDED_DIV_OPS
                                  and kwargs.get("rounding_mode")):
        num, den = _arg(args, kwargs, 0, "input"), _arg(args, kwargs, 1,
                                                         "other")
    else:
        return
    if not (_is_integral(num) and _is_integral(den)):
        return
    zero = bool((den == 0).any()) if torch.is_tensor(den) else den == 0
    if zero:
        raise ZeroDivisionError(f"{name}: integer division by zero")


class CheckMode(TorchFunctionMode):
    """The torch analogue of `checkify` with the JAX package's three error
    sets (see the module docstring): `with CheckMode():` checks every
    torch op of the block.  The ops run with the mode off inside its
    handler, so the checks' own ops are not checked.

    The NaN test of an output on a CUDA device is a flag on the device,
    read back with the next _FLUSH ones in one host read (or at the
    block's end, or before an index or division error, so the first fault
    is named first), as checkify reports its errors after the program: a
    host read per op would serialize the card's queue for each of the
    sweep's ~1e5 ops.  On the CPU each is read at once."""

    _FLUSH = 512

    def __init__(self):
        super().__init__()
        self._pending = []      # (op name, its 0-d bool NaN flag on a card)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = _op_name(func)
        try:
            _check_indices(name, args, kwargs)
            _check_div(name, args, kwargs)
        except (IndexError, ZeroDivisionError):
            self.flush()
            raise
        out = func(*args, **kwargs)
        if name in _PARTIAL_WRITES:
            self._note_nan(name, _arg(args, kwargs, *_PARTIAL_WRITES[name]))
        elif name not in _UNCHECKED_OUTPUT:
            self._note_nan(name, out)
        return out

    def _note_nan(self, name: str, out) -> None:
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for x in outs:
            if not (torch.is_tensor(x) and x.dtype.is_floating_point):
                continue
            if not x.is_cuda:
                if bool(torch.isnan(x).any()):
                    self.flush()
                    raise FloatingPointError(f"nan generated by op {name}")
                continue
            self._pending.append((name, torch.isnan(x).any()))
            if len(self._pending) >= self._FLUSH:
                self.flush()

    def flush(self) -> None:
        """Read the pending NaN flags; FloatingPointError naming the first
        op whose output held a NaN."""
        pending, self._pending = self._pending, []
        if not pending:
            return
        flags = torch.stack([f for _, f in pending]).tolist()
        for (name, _), bad in zip(pending, flags):
            if bad:
                raise FloatingPointError(f"nan generated by op {name}")

    def __exit__(self, exc_type, exc, tb):
        try:
            if exc_type is None:
                self.flush()
        finally:
            super().__exit__(exc_type, exc, tb)


def _n_iter(dtype) -> int:
    return 110 if dtype == torch.float64 else 60


def checked_trace(state_fields, geom, sources, tables,
                  dust_approximation: int = 0, max_pixel_level: int = 3,
                  dtype=torch.float64, rates_mode: str = "auto",
                  n_bands: int = 3):
    """The point-source trace (rays.trace_point_sources) under CheckMode:
    every gather and scatter index bounds-checked, every float op
    NaN-checked.  Raises on the first violated invariant; returns
    (RateFields, RayDiagnostics) otherwise, the production trace's bit for
    bit.  A debug tool, not the production path."""
    with CheckMode():
        return rays.trace_point_sources(
            state_fields, geom, sources, tables,
            dust_approximation=dust_approximation,
            max_pixel_level=max_pixel_level, dtype=dtype,
            rates_mode=rates_mode, n_bands=n_bands)


def checked_sweep_chemistry(model, state):
    """One diffuse sweep (core/sweep.py's plain slab scan, see the module
    docstring) and the equilibrium chemistry under CheckMode.  Raises on
    the first NaN, out-of-bounds index or integer division by zero."""
    cfg = model.config
    with CheckMode():
        if cfg.run_uvb_transfer:
            kappa = opacity.compute_opacities(state.HI, state.HeI,
                                              state.HeII, model.opacity_coef)
            state = dataclasses.replace(state, Jmean=sweep.diffuse_sweep(
                kappa, model.sweep_plan, model.uvb, model.geom.cell_size))
        return chemistry.solve_rate_equations(
            state, model.geom, model.dev_tables,
            ksi_matrix=model.ksi_matrix, gamma_thin=model.gamma_thin,
            self_shielding_threshold=cfg.self_shielding_threshold,
            run_uvb_transfer=cfg.run_uvb_transfer,
            n_iter=_n_iter(state.rho.dtype))


def preflight(model, state, stellar_ctx=None, max_pixel_level: int = 3):
    """The checked sweep and chemistry (and trace, with sources) once on
    the ingested data: the sanitizer analog of the reference's startup
    asserts.  Returns normally or raises at the first violated
    invariant."""
    checked_sweep_chemistry(model, state)
    if stellar_ctx is not None:
        checked_trace(state, model.geom, stellar_ctx.sources,
                      stellar_ctx.tables,
                      dust_approximation=stellar_ctx.dust_approximation,
                      max_pixel_level=min(max_pixel_level,
                                          stellar_ctx.max_pixel_level),
                      dtype=state.rho.dtype)


# ---------------------------------------------------------------------------
# nested and block-sparse storage: the slot-map and padding-block index
# machinery is where bounds faults live, so the production storage gets the
# same pre-flight, each sweep on a 12-direction level-1 plan (the indexing
# is zone-independent, so 12 directions exercise every path)
# ---------------------------------------------------------------------------


def checked_trace_sparse(sp_state, geom, sources, tables,
                         dust_approximation: int = 0,
                         max_pixel_level: int = 3, dtype=torch.float64,
                         rates_mode: str = "auto"):
    """The block-sparse trace under CheckMode: every slot-map gather,
    level-concatenated field gather and deposit scatter bounds-checked,
    every float op NaN-checked."""
    with CheckMode():
        return rays_multilevel.trace_point_sources_sparse(
            sp_state, geom, sources, tables,
            dust_approximation=dust_approximation,
            max_pixel_level=max_pixel_level, dtype=dtype,
            rates_mode=rates_mode)


def checked_sweep_chemistry_sparse(amodel, state):
    """One block-sparse sweep (12-direction level-1 plan, the production
    refinement window), chemistry and the restriction sync under
    CheckMode."""
    rt = amodel.rt
    cfg = rt.config
    plan1 = (sweep_multilevel.build_ml_sweep_plan(1, rt.geom.nx,
                                                  amodel.n_levels)
             if cfg.run_uvb_transfer else None)
    # the window is host NumPy, resolved before the checked ops, so that
    # the checked sweep runs the windowed production path
    win = sweep_sparse.compute_window(state)
    with CheckMode():
        if cfg.run_uvb_transfer:
            k0, lv_k = amodel._kappas(state)
            j0, jbs = sweep_sparse.diffuse_sweep_sparse(
                k0, lv_k, state, plan1, rt.uvb, rt.geom.cell_size,
                n_coupling_iters=amodel.n_coupling_iters, window=win)
            state = dataclasses.replace(
                state, base=dataclasses.replace(state.base, Jmean=j0),
                levels=tuple(dataclasses.replace(
                    lv, fields=dataclasses.replace(lv.fields, Jmean=j))
                    for lv, j in zip(state.levels, jbs)))
        return amodel._chemistry_and_sync(state)


def checked_sweep_chemistry_ml(amodel, state):
    """The dense L-level analog of checked_sweep_chemistry_sparse
    (12-direction level-1 plan)."""
    rt = amodel.rt
    cfg = rt.config
    plan1 = (sweep_multilevel.build_ml_sweep_plan(1, rt.geom.nx,
                                                  amodel.n_levels)
             if cfg.run_uvb_transfer else None)
    with CheckMode():
        if cfg.run_uvb_transfer:
            js = sweep_multilevel.diffuse_sweep_multilevel(
                amodel._kappas(state), list(state.refined), plan1, rt.uvb,
                rt.geom.cell_size, n_coupling_iters=amodel.n_coupling_iters)
            state = amr.MultiLevelState(
                levels=tuple(dataclasses.replace(lv, Jmean=j)
                             for lv, j in zip(state.levels, js)),
                refined=state.refined)
        return amr.sync_restriction_multi(amr.MultiLevelState(
            levels=tuple(amodel.chemistry(lv, amodel.level_geom(ell))
                         for ell, lv in enumerate(state.levels)),
            refined=state.refined))


def checked_trace_ml(ml_state, geom, sources, tables,
                     dust_approximation: int = 0, max_pixel_level: int = 3,
                     dtype=torch.float64, rates_mode: str = "auto"):
    """The dense L-level trace under CheckMode."""
    with CheckMode():
        return rays_multilevel.trace_point_sources_ml(
            ml_state, geom, sources, tables,
            dust_approximation=dust_approximation,
            max_pixel_level=max_pixel_level, dtype=dtype,
            rates_mode=rates_mode)


def preflight_sparse(amodel, state, stellar_ctx=None,
                     max_pixel_level: int = 3):
    """Pre-flight the block-sparse path on the ingested data: the checked
    sweep, chemistry and restriction, and the checked sparse trace with
    sources."""
    checked_sweep_chemistry_sparse(amodel, state)
    if stellar_ctx is not None:
        checked_trace_sparse(
            state, amodel.rt.geom, stellar_ctx.sources, stellar_ctx.tables,
            dust_approximation=stellar_ctx.dust_approximation,
            max_pixel_level=min(max_pixel_level,
                                stellar_ctx.max_pixel_level),
            dtype=state.base.rho.dtype)


def preflight_ml(amodel, state, stellar_ctx=None, max_pixel_level: int = 3):
    """Pre-flight the dense L-level path on the ingested data."""
    checked_sweep_chemistry_ml(amodel, state)
    if stellar_ctx is not None:
        checked_trace_ml(
            state, amodel.rt.geom, stellar_ctx.sources, stellar_ctx.tables,
            dust_approximation=stellar_ctx.dust_approximation,
            max_pixel_level=min(max_pixel_level,
                                stellar_ctx.max_pixel_level),
            dtype=state.levels[0].rho.dtype)
