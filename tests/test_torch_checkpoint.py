"""PyTorch port, io/checkpoint.py: torch-native checkpoints with the JAX
package's names and sidecar.

Round trips of every container the CLI checkpoints (uniform, two-level,
L-level, block-sparse, a noneq run's (state, species) and a nested run's
species tuple) restore every tensor exactly, onto the like state's device,
optional fields left None; latest_checkpoint picks the newest directory
with a sidecar, as the JAX package's does; the port's ftte_meta.json for
a state equals the one the JAX package's orbax save_sharded writes for
the same state, key for key and byte for byte.  A checkpoint of another
container raises TreeMismatch (and nothing else does), a tensor of another
shape ValueError, a truncated file torch.load's error.  Through the CLI
(8^3, angular level 1, --ckpt-format orbax): a noneq restart from an
equilibrium run's fields-only checkpoint warns and runs on, and a noneq
checkpoint with a corrupt or ill-fitting species file stops the restart
(the JAX CLI's `except Exception` would fall back to the fields there,
ROADMAP section 3)."""

import contextlib
import dataclasses
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from radiativetransfer_tpu.core import state as jstate
from radiativetransfer_tpu.io import checkpoint as jckpt
from radiativetransfer_tpu_torch import cli as tcli
from radiativetransfer_tpu_torch.core import amr, amr_sparse
from radiativetransfer_tpu_torch.core import chemistry_noneq as cn
from radiativetransfer_tpu_torch.core.state import FieldState, uniform_state
from radiativetransfer_tpu_torch.io import checkpoint as ckpt
from radiativetransfer_tpu_torch.parallel import mesh as pmesh

F64 = torch.float64


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand_state(n, seed=0, vel=False):
    rng = np.random.default_rng(seed)
    st = uniform_state(n, nh=1e-3, dtype=F64, device="cpu")
    return dataclasses.replace(
        st, HI=torch.as_tensor(rng.uniform(0, 1e-3, (n, n, n))),
        tgas=torch.as_tensor(rng.uniform(1e3, 1e5, (n, n, n))),
        Jmean=torch.as_tensor(rng.uniform(size=(3, n, n, n))),
        vel=torch.as_tensor(rng.normal(size=(3, n, n, n))) if vel else None)


def _refined(n=8):
    refined = [np.zeros((n, n, n), bool), np.zeros((2 * n,) * 3, bool)]
    refined[0][2:5, 2:5, 2:5] = True
    refined[1][6:9, 6:9, 6:9] = True
    refined = amr.enforce_balance(refined)
    cov = np.ones((n, n, n), bool)
    for ell in range(2):
        refined[ell] &= cov
        cov = np.repeat(np.repeat(np.repeat(refined[ell], 2, 0), 2, 1), 2, 2)
    return refined


def _containers(kind):
    """(state to save, like state built from zeros) of each kind."""
    n = 8
    blank = uniform_state(n, dtype=F64, device="cpu")
    if kind == "uniform":
        return _rand_state(n, vel=True), dataclasses.replace(
            blank, vel=torch.zeros((3, n, n, n), dtype=F64))
    if kind == "two_level":
        r = np.zeros((n, n, n), bool)
        r[2:5, 3:6, 1:4] = True
        st = amr.make_amr_state(_rand_state(n, 1), r)
        st = dataclasses.replace(st, fine=_rand_state(2 * n, 2))
        return st, amr.make_amr_state(blank, r)
    if kind == "l_level":
        ref = _refined(n)
        st = amr.make_multilevel_state(_rand_state(n, 3), ref, [
            _rand_state(2 * n, 4), _rand_state(4 * n, 5)])
        return st, amr.make_multilevel_state(blank, ref)
    if kind == "sparse":
        ref = _refined(n)
        return (amr_sparse.make_sparse_state(_rand_state(n, 5), ref),
                amr_sparse.make_sparse_state(blank, ref))
    if kind == "noneq":
        st = _rand_state(n, 9)
        return ((st, cn.species_from_field_state(st, f_h2=1e-4, f_hm=1e-7)),
                (blank, cn.species_from_field_state(blank)))
    # a nested noneq run's container: (L-level state, species a level)
    st, like = _containers("l_level")
    return ((st, tuple(cn.species_from_field_state(lv, f_h2=1e-4)
                       for lv in st.levels)),
            (like, tuple(cn.species_from_field_state(lv)
                         for lv in like.levels)))


def _assert_trees_equal(a, b):
    fa, fb = ckpt.flatten(a), ckpt.flatten(b)
    assert fa.keys() == fb.keys() and fa
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        assert torch.equal(fa[k], fb[k]), k


@pytest.mark.parametrize("kind", ["uniform", "two_level", "l_level",
                                  "sparse", "noneq", "nested_noneq"])
def test_round_trip(tmp_path, kind):
    st, like = _containers(kind)
    path = ckpt.checkpoint_name(7, str(tmp_path))
    assert path == os.path.join(str(tmp_path), "ckpt0007")
    ckpt.save_sharded(path, st, itime=7, physical_box_size=1.5e24,
                      extra_meta={"kind": kind})
    assert sorted(os.listdir(path)) == ["ftte_meta.json", "leaves_rank0.pt"]
    back, meta = ckpt.restore_sharded(path, like)
    assert meta["itime"] == 7 and meta["physical_box_size"] == 1.5e24
    assert meta["kind"] == kind and meta["shape"] == [8, 8, 8]
    assert type(back) is type(st)
    _assert_trees_equal(back, st)
    if kind == "uniform":
        assert back.vel is not None
    elif kind == "noneq":
        assert isinstance(back[1], cn.SpeciesState)


def test_none_fields_stay_none_and_mesh_restore(tmp_path):
    st = _rand_state(8)
    assert st.vel is None
    path = ckpt.checkpoint_name(1, str(tmp_path))
    ckpt.save_sharded(path, st, 1, 1.0)
    like = uniform_state(8, dtype=F64, device="cpu")
    back, _ = ckpt.restore_sharded(
        path, like, mesh=pmesh.make_grid_mesh(2, device="cpu"))
    assert back.vel is None
    _assert_trees_equal(back, st)
    two, like2 = _containers("two_level")
    ckpt.save_sharded(path, two, 1, 1.0)
    back2, _ = ckpt.restore_sharded(
        path, like2, mesh=pmesh.make_grid_mesh(2, device="cpu"))
    _assert_trees_equal(back2, two)


def test_latest_checkpoint(tmp_path):
    st = _rand_state(4)
    assert ckpt.latest_checkpoint(str(tmp_path / "absent")) is None
    for it in (1, 12, 5):
        ckpt.save_sharded(ckpt.checkpoint_name(it, str(tmp_path)), st,
                          itime=it, physical_box_size=1.0)
    # a directory without its sidecar (a save cut short) is not a
    # checkpoint
    os.makedirs(tmp_path / "ckpt0099")
    (tmp_path / "ckpt100").mkdir()
    latest = ckpt.latest_checkpoint(str(tmp_path))
    assert latest is not None and latest.endswith("ckpt0012")
    assert os.path.basename(latest) == os.path.basename(
        jckpt.latest_checkpoint(str(tmp_path)))


@pytest.mark.parametrize("extra", [None, {"n_levels": 3}])
def test_meta_equals_jax(tmp_path, extra):
    """The sidecar of the same state: the JAX package's orbax save and the
    port's torch save write the same JSON."""
    n = 6
    rng = np.random.default_rng(4)
    nh = rng.lognormal(0, 0.5, (n, n, n)) * 1e-3
    js = jstate.make_state(nh * 1.67e-24, np.full((n, n, n), 1e4), nh,
                           dtype=jnp.float64)
    ts = FieldState.from_numpy(
        {f.name: (None if getattr(js, f.name) is None
                  else np.asarray(getattr(js, f.name)))
         for f in dataclasses.fields(js)}, dtype=F64, device="cpu")
    box = 300.0 * 3.0856775814913673e21
    jp, tp = tmp_path / "jax", tmp_path / "torch"
    jckpt.save_sharded(jckpt.checkpoint_name(3, str(jp)), js, 3, box,
                       extra_meta=extra)
    ckpt.save_sharded(ckpt.checkpoint_name(3, str(tp)), ts, 3, box,
                      extra_meta=extra)
    files = [p / "ckpt0003" / "ftte_meta.json" for p in (jp, tp)]
    metas = [json.loads(f.read_text()) for f in files]
    assert metas[0] == metas[1]
    assert files[0].read_bytes() == files[1].read_bytes()


def test_mismatch_errors(tmp_path):
    (st, sp), (like, like_sp) = _containers("noneq")
    fields_only = ckpt.checkpoint_name(1, str(tmp_path))
    ckpt.save_sharded(fields_only, st, 1, 1.0)
    with pytest.raises(ckpt.TreeMismatch, match="another container"):
        ckpt.restore_sharded(fields_only, (like, like_sp))
    # the wrong shape or dtype is not a TreeMismatch
    with pytest.raises(ValueError, match="rho is") as e:
        ckpt.restore_sharded(fields_only, uniform_state(4, dtype=F64,
                                                        device="cpu"))
    assert not isinstance(e.value, ckpt.TreeMismatch)
    with pytest.raises(ValueError, match="torch.float32"):
        ckpt.restore_sharded(fields_only, uniform_state(
            8, dtype=torch.float32, device="cpu"))
    both = ckpt.checkpoint_name(2, str(tmp_path))
    ckpt.save_sharded(both, (st, sp), 2, 1.0)
    leaves = os.path.join(both, "leaves_rank0.pt")
    with open(leaves, "r+b") as fh:
        fh.truncate(os.path.getsize(leaves) // 2)
    with pytest.raises(Exception) as e:
        ckpt.restore_sharded(both, (like, like_sp))
    assert not isinstance(e.value, ckpt.TreeMismatch)


# ---------------------------------------------------------------------------
# The CLI's noneq restart from a checkpoint (cli._restore_noneq)
# ---------------------------------------------------------------------------

_FLAGS = ("--angular-level", "1", "--x64", "--ckpt-format", "orbax",
          "--platform", "cpu", "--iters", "1")


def _cli(directory, *flags, restart=0):
    config = chip_smoke.write_cli_inputs(str(directory), 8, mode=9,
                                         restart=restart)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tcli.main([config, "--snapshot-dir", str(directory), *_FLAGS,
                   *flags])
    return buf.getvalue()


@pytest.fixture(scope="module")
def noneq_ckpt(tmp_path_factory):
    """A port noneq run's checkpoint ckpt0001: (state, species)."""
    d = tmp_path_factory.mktemp("noneq_ckpt")
    _cli(d, "--chemistry", "noneq")
    return d / "ckpt0001"


def test_noneq_restart_from_fields_only_checkpoint_warns(tmp_path):
    _cli(tmp_path)
    assert sorted(p.name for p in tmp_path.glob("ckpt*")) == ["ckpt0001"]
    out = _cli(tmp_path, "--chemistry", "noneq", restart=1)
    assert ("warning: checkpoint carries no species state; "
            "H2/H2+/H-/energy re-initialized from equilibrium") in out
    assert "itime=2 " in out and (tmp_path / "ckpt0002").is_dir()
    # the run went on with its species, and checkpointed them
    meta = json.loads((tmp_path / "ckpt0002" / "ftte_meta.json").read_text())
    assert meta["itime"] == 2
    leaves = torch.load(tmp_path / "ckpt0002" / "leaves_rank0.pt",
                        weights_only=True)
    assert {"0.rho", "0.vel", "1.H2I", "1.eint"} <= leaves.keys()


def test_noneq_restart_from_its_checkpoint(noneq_ckpt, tmp_path):
    os.symlink(noneq_ckpt, tmp_path / "ckpt0001")
    out = _cli(tmp_path, "--chemistry", "noneq", restart=1)
    assert (f"restored fields + 9-species noneq state from "
            f"{tmp_path}/ckpt0001") in out
    assert "itime=2 " in out and "warning" not in out


@pytest.mark.parametrize("fault", ["truncated", "species_shape"])
def test_noneq_restart_from_a_bad_species_file_raises(noneq_ckpt, tmp_path,
                                                      fault):
    d = tmp_path / "ckpt0001"
    d.mkdir()
    (d / "ftte_meta.json").write_bytes(
        (noneq_ckpt / "ftte_meta.json").read_bytes())
    leaves = torch.load(noneq_ckpt / "leaves_rank0.pt", weights_only=True)
    assert "1.H2I" in leaves and "0.rho" in leaves
    if fault == "species_shape":
        leaves["1.H2I"] = leaves["1.H2I"][:, :, :4].clone()
    torch.save(leaves, d / "leaves_rank0.pt")
    if fault == "truncated":
        raw = (d / "leaves_rank0.pt").read_bytes()
        (d / "leaves_rank0.pt").write_bytes(raw[:len(raw) // 3])
    with pytest.raises(Exception) as e:
        _cli(tmp_path, "--chemistry", "noneq", restart=1)
    assert not isinstance(e.value, ckpt.TreeMismatch)
    if fault == "species_shape":
        assert isinstance(e.value, ValueError) and "1.H2I" in str(e.value)
    assert not (tmp_path / "ckpt0002").exists()
