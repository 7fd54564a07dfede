"""PyTorch port, the CLI's `--mesh-shape P` on nested grids: both packages'
`cli.main` on the same files, the synthetic galaxy of
examples/make_test_data.py at 8^3 with its refined centre (two-level) and
core (L-level dense, and block-sparse under `--amr-storage sparse`), its 12
sources at maxPixelLevel 2, angular level 1, `--x64`, mode 8, two
iterations, `--mesh-shape 4` (the JAX CLI's mesh on 4 of its 8 virtual CPU
devices; the port's 4 ranks on the CPU), at the default coupling depth
(`--coupling-depth 4`, so that neither CLI validates it); and one
`--chemistry noneq` mode-8 iteration on the L-level grid.

Each port run's `time` log is within 1e-10 of the JAX CLI's and of the
port's own run without a mesh, the `fesc=` lines equal JAX's; the JAX
CLI's mesh lines (the block-sparse "distributed over 4 devices" line, the
noneq `mesh = (4,)` suffix) are the port's."""

import contextlib
import io
import os
import re

import pytest
import torch

import chip_smoke
from radiativetransfer_tpu import cli as jcli
from radiativetransfer_tpu_torch import cli as tcli
from test_torch_host import jax_compile_cache

N = 8
_COMMON = ("--angular-level", "1", "--x64", "--iters", "2",
           "--max-pixel-level", "2", "--coupling-depth", "4")
# case -> (refine_core, flags)
RUNS = {
    "two_level": (False, ()),
    "ml": (True, ()),
    "sparse": (True, ("--amr-storage", "sparse")),
    "ml_noneq": (True, ("--chemistry", "noneq", "--iters", "1")),
}
_SPARSE_LINE = ("block-sparse deep AMR distributed over 4 devices: zones "
                "sweep (direction chunks + psum) + source-parallel tracer")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the eager nested sweeps are many small CPU ops
    (module-scoped, so that the module fixture runs pinned too)."""
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


def _run(pkg: str, config: str, outdir, *flags) -> str:
    os.makedirs(outdir, exist_ok=True)
    argv = [config, "--snapshot-dir", str(outdir), *_COMMON, *flags]
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


def _assert_logs_close(a, b, rtol=1e-10):
    assert a.keys() == b.keys() and a
    for k in a:
        assert abs(a[k] - b[k]) <= rtol * abs(b[k]), (k, a[k], b[k])


def _fesc(out: str) -> list[str]:
    return re.findall(r"fesc=\S+", out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{(case, run): (stdout, time log)}, run "jax" and "torch" on the
    4-device / 4-rank mesh, "plain" the port without one."""
    root = tmp_path_factory.mktemp("cli_mesh")
    out = {}
    for case, (core, flags) in RUNS.items():
        for run, pkg, mesh in (("jax", "jax", True), ("torch", "torch", True),
                               ("plain", "torch", False)):
            d = root / f"{case}_{run}"
            os.makedirs(d)
            config = chip_smoke.write_cli_inputs(
                str(d), N, refine_center=True, refine_core=core, mode=8)
            text = _run(pkg, config, d, *flags,
                        *(("--mesh-shape", "4") if mesh else ()))
            out[case, run] = (text, _time_log(d))
    return out


@pytest.mark.parametrize("case", list(RUNS))
def test_mesh_run_matches_jax_and_one_device(runs, case):
    (out_t, log_t), (out_j, log_j), (out_p, log_p) = (
        runs[case, run] for run in ("torch", "jax", "plain"))
    iters = 1 if case == "ml_noneq" else 2
    assert list(log_t) == list(range(1, iters + 1))
    _assert_logs_close(log_t, log_j)
    _assert_logs_close(log_t, log_p)
    assert _fesc(out_t) == _fesc(out_j) == _fesc(out_p)
    assert len(_fesc(out_t)) == iters
    assert "device mesh: {'gz': 4} strategy = auto" in out_t.splitlines()
    if case == "sparse":
        for out in (out_t, out_j):
            assert _SPARSE_LINE in out.splitlines()
    if case == "ml_noneq":
        line = ("non-equilibrium chemistry (3 levels): dt = 1.0 Myr, "
                "evolve_energy = False")
        assert line + ", mesh = (4,)" in out_t.splitlines()
        assert line + ", mesh = (4,)" in out_j.splitlines()
        assert line in out_p.splitlines()
