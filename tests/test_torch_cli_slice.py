"""PyTorch port, the single-card CLI's last features together: both
packages' `cli.main` on the synthetic galaxy at 8^3 (angular level 1, the
12 sources at maxPixelLevel 3), --x64, mode 8, `--tracer-compact
--ckpt-format orbax`: two iterations, then a restart from the newest
checkpoint to a third, in each package (the JAX CLI's checkpoints are
orbax's, the port's its own files).  The two `time` logs agree within
1e-10 relative, the `fesc=` lines are identical, both print the restart
from ckpt0002 and write the same checkpoint sidecars; the port's
restarted run equals its own uninterrupted three-iteration run, every
checkpointed tensor exactly.  `--debug-checkify` prints the JAX CLI's
pre-flight line on each storage (uniform here, two-level, L-level and
block-sparse on the 8^3 nested galaxy in mode 9) and leaves the run's log
as it was; a grid with a NaN stops the run at the pre-flight, naming the
op.  The JAX CLI's runs are shared through a module fixture; JAX's
checkify is not run (tests/test_debug.py holds it)."""

import contextlib
import io
import json
import os
import re

import numpy as np
import pytest
import torch

import chip_smoke
from radiativetransfer_tpu import cli as jcli
from radiativetransfer_tpu_torch import cli as tcli
from radiativetransfer_tpu_torch.core import rays as trays
from radiativetransfer_tpu_torch.io import grid_io
from test_torch_host import jax_compile_cache

N = 8
_LEVEL = ("--angular-level", "1")
_FLAGS = ("--x64", "--max-pixel-level", "3", "--tracer-compact",
          "--ckpt-format", "orbax")
_LINES = {
    "uniform": "checkify pre-flight passed (bounds/NaN/division clean on "
               "the ingested data)",
    "two": "checkify pre-flight passed on two-level AMR storage",
    "ml": "checkify pre-flight passed on multilevel storage",
    "sparse": "checkify pre-flight passed on block-sparse storage "
              "(slot-map/padding-block bounds, NaN/Inf, division clean on "
              "the ingested data)"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
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


def _inputs(directory, **kw) -> str:
    os.makedirs(directory, exist_ok=True)
    return chip_smoke.write_cli_inputs(str(directory), N, **kw)


def _run(pkg: str, config: str, outdir, *flags) -> str:
    os.makedirs(outdir, exist_ok=True)
    argv = [config, "--snapshot-dir", str(outdir), *_LEVEL, *flags]
    main = jcli.main
    if pkg == "torch":
        main = tcli.main
        argv += ["--platform", "cpu"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def _time_log(outdir) -> dict[int, float]:
    out = {}
    with open(os.path.join(outdir, "time")) as fh:
        for line in fh:
            m = re.fullmatch(r"itime =\s*(\d+)\s+(\S+)\n", line)
            if m:
                out[int(m.group(1))] = float(m.group(2))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{pkg: (the 2-iteration run's stdout, the restart's, dir)} and
    "straight": the port's uninterrupted 3-iteration run (stdout, dir)."""
    root = tmp_path_factory.mktemp("slice_cli")
    out = {}
    for pkg in ("torch", "jax"):
        d = root / pkg
        first = _run(pkg, _inputs(d, mode=8), d, "--iters", "2", *_FLAGS)
        second = _run(pkg, _inputs(d, mode=8, restart=1), d, "--iters", "1",
                      *_FLAGS)
        out[pkg] = (first, second, d)
    d = root / "straight"
    out["straight"] = (_run("torch", _inputs(d, mode=8), d, "--iters", "3",
                            *_FLAGS), d)
    return out


def test_restart_sequence_matches_jax(runs):
    logs = {pkg: _time_log(runs[pkg][2]) for pkg in ("torch", "jax")}
    assert list(logs["torch"]) == [1, 2, 3]
    for k in logs["jax"]:
        assert abs(logs["torch"][k] - logs["jax"][k]) <= 1e-10 * abs(
            logs["jax"][k]), k
    for pkg in ("torch", "jax"):
        first, second, d = runs[pkg]
        assert "nStars/specificAge/non-degenerate = 12 12 10" in first
        assert f"restarted from {d}/ckpt0002 at itime=2" in second
        assert not any(d.glob("cellArray*"))
        assert sorted(p.name for p in d.glob("ckpt*")) == [
            "ckpt0001", "ckpt0002", "ckpt0003"]
    fesc = [re.findall(r"fesc=(\S+)", runs[pkg][0] + runs[pkg][1])
            for pkg in ("torch", "jax")]
    assert fesc[0] == fesc[1] and len(fesc[0]) == 3
    for it in (1, 2, 3):
        metas = [json.loads((runs[pkg][2] / f"ckpt{it:04d}" /
                             "ftte_meta.json").read_text())
                 for pkg in ("torch", "jax")]
        assert metas[0] == metas[1] and metas[0]["itime"] == it


def test_restart_equals_the_uninterrupted_run(runs):
    _, d = runs["straight"]
    restarted = runs["torch"][2]
    assert _time_log(d) == _time_log(restarted)
    for it in (1, 2, 3):
        a = torch.load(d / f"ckpt{it:04d}" / "leaves_rank0.pt",
                       weights_only=True)
        b = torch.load(restarted / f"ckpt{it:04d}" / "leaves_rank0.pt",
                       weights_only=True)
        assert a.keys() == b.keys() and "Jmean" in a
        for k in a:
            assert torch.equal(a[k], b[k]), (it, k)


def test_tracer_compact_runs_the_compacting_tracer(runs, tmp_path):
    """The CLI's mode 8 under --tracer-compact traces with
    rays.trace_point_sources_compact: its final phase's 12 x 192 rays."""
    trays.LAST_COMPACT_BUCKETS.clear()
    _run("torch", _inputs(tmp_path, mode=8), tmp_path, "--iters", "1",
         *_FLAGS)
    assert trays.LAST_COMPACT_BUCKETS[0] == 10 * 192
    assert _time_log(tmp_path) == {1: _time_log(runs["straight"][1])[1]}


@pytest.mark.parametrize("storage", ["uniform", "two", "ml", "sparse"])
def test_debug_checkify_prints_the_jax_line(runs, tmp_path, storage):
    """One iteration under --debug-checkify: the JAX CLI's line once,
    before the loop, and the iteration as without the flag."""
    if storage == "uniform":
        flags = ("--iters", "1", *_FLAGS)
        config = _inputs(tmp_path, mode=8)
        want = {1: _time_log(runs["straight"][1])[1]}
    else:
        flags = ("--iters", "1", "--x64")
        if storage == "sparse":
            flags += ("--amr-storage", "sparse")
        config = _inputs(tmp_path / "ref", refine_center=True,
                         refine_core=storage != "two")
        _run("torch", config, tmp_path / "ref", *flags)
        want = _time_log(tmp_path / "ref")
        config = _inputs(tmp_path, refine_center=True,
                         refine_core=storage != "two")
    out = _run("torch", config, tmp_path, "--debug-checkify", *flags)
    lines = out.splitlines()
    assert lines.count(_LINES[storage]) == 1
    assert lines.index(_LINES[storage]) < next(
        i for i, x in enumerate(lines) if x.startswith("itime=1 "))
    assert _time_log(tmp_path) == want


def test_poisoned_grid_stops_at_the_preflight(tmp_path):
    config = _inputs(tmp_path, mode=9)
    levels = grid_io.read_level_npz(str(tmp_path / "testgrid_velmet.npz"))
    levels[0].lT[5] = np.nan
    grid_io.write_level_npz(str(tmp_path / "testgrid_velmet.npz"), levels)
    with pytest.raises(FloatingPointError, match="nan generated by op"):
        _run("torch", config, tmp_path, "--iters", "1", "--debug-checkify")
    assert not (tmp_path / "time").exists()
