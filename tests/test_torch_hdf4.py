"""PyTorch port, io/hdf4.py and io/convert.py: the HDF4-SD container and
the converters against the JAX package's, on the cases of its
tests/test_io.py (TestHDF4Interchange, TestConverters).  The port's files
are byte for byte the JAX package's (the .h4 containers), its arrays
identical (the npz outputs: the port's grid_io writes level npz files
uncompressed, so their bytes differ); each package reads the other's .h4.
`python -m radiativetransfer_tpu_torch.io.convert` runs the subcommands.
The port's CLI on a nested grid converted to .h4 prints the same log and
writes the same snapshots as on the grid's .npz."""

import contextlib
import io
import os
import re
import struct
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from radiativetransfer_tpu.core import amr as jamr
from radiativetransfer_tpu.core import state as jstate
from radiativetransfer_tpu.io import convert as jconvert
from radiativetransfer_tpu.io import grid_io as jgrid_io
from radiativetransfer_tpu.io import hdf4 as jhdf4
from radiativetransfer_tpu.io import snapshot as jsnapshot
from radiativetransfer_tpu_torch import cli as tcli
from radiativetransfer_tpu_torch.constants import KPC, MH, PSI
from radiativetransfer_tpu_torch.io import convert, grid_io, hdf4


def _quiet(fn, *args):
    """fn(*args) with its printed lines returned."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


def _sd_datasets():
    return [("nlevels", np.array([3], np.int32)),
            ("pos", np.arange(12, dtype=np.float32).reshape(3, 4)),
            ("lT", np.linspace(0, 1, 7).astype(np.float32)),
            ("big", np.arange(1000, dtype=np.float64)),
            ("i16", np.arange(-5, 5, dtype=np.int16)),
            ("u8", np.arange(9, dtype=np.uint8).reshape(3, 3))]


def test_sd_round_trip_types_and_order(tmp_path):
    ds = _sd_datasets()
    pt, pj = str(tmp_path / "t.h4"), str(tmp_path / "j.h4")
    hdf4.write_sd(pt, ds)
    jhdf4.write_sd(pj, ds)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    for got in (hdf4.read_sd(pt), hdf4.read_sd(pj), jhdf4.read_sd(pt)):
        assert [n for n, _ in got] == [n for n, _ in ds]
        for (_, a0), (_, a1) in zip(ds, got):
            assert a1.dtype.kind == a0.dtype.kind
            np.testing.assert_array_equal(a1, a0)


def test_file_structure_is_valid_hdf4(tmp_path):
    p = str(tmp_path / "s.h4")
    hdf4.write_sd(p, [("a", np.array([1.5, 2.5], np.float32))])
    buf = open(p, "rb").read()
    assert buf[:4] == hdf4.MAGIC == jhdf4.MAGIC
    dds = hdf4._read_dds(buf)
    assert dds == jhdf4._read_dds(buf)
    tags = [t for t, *_ in dds]
    for t in (hdf4.DFTAG_NT, hdf4.DFTAG_SDD, hdf4.DFTAG_SD,
              hdf4.DFTAG_NDG, hdf4.DFTAG_DIL):
        assert t in tags
    sd = hdf4._element(buf, dds, hdf4.DFTAG_SD, 1)
    assert struct.unpack(">2f", sd) == (1.5, 2.5)


def _levels(seed=5, vel=True, abun=False):
    rng = np.random.default_rng(seed)
    levels = []
    for ncell in (64, 24):
        levels.append(grid_io.LevelData(
            pos=rng.uniform(0, 100, (ncell, 3)).astype(np.float32),
            lT=rng.normal(4, 0.3, ncell).astype(np.float32),
            lnH=rng.normal(-3, 0.5, ncell).astype(np.float32),
            lx=np.zeros(ncell, np.float32),
            abun=(rng.uniform(0, 0.01, (ncell, 4)).astype(np.float32)
                  if abun else None),
            vel=(rng.normal(0, 50, (ncell, 3)).astype(np.float32)
                 if vel else None)))
    return levels


def _assert_levels_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for k in ("pos", "lT", "lnH", "lx", "abun", "vel"):
            x, y = getattr(a, k), getattr(b, k)
            assert (x is None) == (y is None), k
            if x is not None:
                assert x.dtype == y.dtype, k
                np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("vel,abun", [(True, False), (False, True),
                                      (True, True)])
def test_grid_npz_h4_round_trip_matches_jax(tmp_path, vel, abun):
    levels = _levels(vel=vel, abun=abun)
    src = str(tmp_path / "g.npz")
    grid_io.write_level_npz(src, levels)
    outs = {}
    for name, mod in (("torch", convert), ("jax", jconvert)):
        h4, back = str(tmp_path / f"{name}.h4"), str(tmp_path / f"{name}.npz")
        outs[name] = _quiet(mod.npz2h4, src, h4) + _quiet(mod.h42npz, h4,
                                                          back)
    assert open(tmp_path / "torch.h4", "rb").read() == open(
        tmp_path / "jax.h4", "rb").read()
    assert outs["torch"].replace("torch", "jax") == outs["jax"]
    got = grid_io.read_level_npz(str(tmp_path / "torch.npz"))
    _assert_levels_equal(got, levels)
    _assert_levels_equal(got, jgrid_io.read_level_npz(
        str(tmp_path / "jax.npz")))
    _assert_levels_equal(convert.h42levels(str(tmp_path / "jax.h4")),
                         jconvert.h42levels(str(tmp_path / "torch.h4")))


def test_h4_dataset_layout_matches_reference(tmp_path):
    ncell = 27
    lv = grid_io.LevelData(
        pos=np.arange(ncell * 3, dtype=np.float32).reshape(ncell, 3),
        lT=np.zeros(ncell, np.float32), lnH=np.zeros(ncell, np.float32),
        lx=np.zeros(ncell, np.float32))
    src = str(tmp_path / "g.npz")
    grid_io.write_level_npz(src, [lv])
    h4 = str(tmp_path / "g.h4")
    _quiet(convert.npz2h4, src, h4)
    ds = hdf4.read_sd(h4)
    assert ds[0][0] == "nlevels" and int(ds[0][1][0]) == 1
    assert [n for n, _ in ds[1:5]] == ["pos", "lT", "lnH", "lx"]
    assert ds[1][1].shape == (3, ncell)
    np.testing.assert_array_equal(ds[1][1][0], lv.pos[:, 0])


def test_snapshot_h4_round_trip_matches_jax(tmp_path):
    n = 8
    rng = np.random.default_rng(9)
    nh = rng.lognormal(0, 0.5, (n, n, n)) * 1e-3
    st = jstate.make_state(nh * MH / PSI, np.full((n, n, n), 1e4), nh,
                           dtype=jnp.float64)
    p = str(tmp_path / "cellArray0042.npz")
    jsnapshot.write_snapshot(p, st, 42, 1.0)
    for name, mod in (("torch", convert), ("jax", jconvert)):
        os.makedirs(tmp_path / name)
        h4 = str(tmp_path / name / "cellArray0042.h4")
        _quiet(mod.snapshot2h4, p, h4)
        _quiet(mod.h42snapshot, h4, str(tmp_path / name / "back.npz"))
    assert open(tmp_path / "torch" / "cellArray0042.h4", "rb").read() == \
        open(tmp_path / "jax" / "cellArray0042.h4", "rb").read()
    with np.load(tmp_path / "torch" / "back.npz") as a, \
            np.load(tmp_path / "jax" / "back.npz") as b, np.load(p) as c:
        assert list(a.keys()) == list(b.keys())
        assert int(a["itime"]) == 42
        for k in b:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for k in ("level", "HI", "HeI", "HeII", "temperature", "density"):
            np.testing.assert_array_equal(a[k], c[k].astype(a[k].dtype))


def test_amr_snapshot2levels_matches_jax(tmp_path):
    """The SFC bitmap reconstruction inverts write_snapshot_amr's leaf
    stream in both packages alike."""
    n = 4
    refined = np.zeros((n, n, n), bool)
    refined[0, 1, 2] = True
    refined[3, 3, 3] = True
    st = jamr.make_amr_state(jstate.uniform_state(n, dtype=jnp.float64),
                             jnp.asarray(refined))
    snap = str(tmp_path / "cellArray0001.npz")
    jsnapshot.write_snapshot_amr(snap, st, 1, KPC)
    outs = {}
    for name, mod in (("torch", convert), ("jax", jconvert)):
        outs[name] = _quiet(mod.snapshot2levels, snap,
                            str(tmp_path / f"{name}.npz"))
    assert outs["torch"] == outs["jax"].replace("jax", "torch")
    with np.load(tmp_path / "torch.npz") as a, \
            np.load(tmp_path / "jax.npz") as b:
        assert list(a.keys()) == list(b.keys())
        assert len(a["level"]) == n ** 3 - 2 + 16
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # base cell 0 of a 2^3 base refined: its 8 children, then 7 leaves
    stream = np.r_[[1] * 8, [0] * 7]
    for got, want in zip(convert._reconstruct_bitmaps(2, stream),
                         jconvert._reconstruct_bitmaps(2, stream)):
        np.testing.assert_array_equal(got, want)


def test_info_project_and_module_entry(tmp_path):
    n = 6
    rng = np.random.default_rng(2)
    nh = rng.lognormal(0, 0.5, (n, n, n)) * 1e-3
    st = jstate.make_state(nh * MH / PSI, np.full((n, n, n), 1e4), nh,
                           dtype=jnp.float64)
    snap = str(tmp_path / "cellArray0003.npz")
    jsnapshot.write_snapshot(snap, st, 3, 1.0)
    grid = str(tmp_path / "grid.npz")
    grid_io.write_level_npz(grid, _levels())
    for argv in (["info", snap], ["info", grid],
                 ["project", snap, str(tmp_path / "{}.npz"), "--field",
                  "HeI", "--axis", "1"]):
        outs = {}
        for name, mod in (("torch", convert), ("jax", jconvert)):
            outs[name] = _quiet(mod.main, [a.format(name) for a in argv])
        assert outs["torch"] == outs["jax"].replace("jax.npz", "torch.npz")
    with np.load(tmp_path / "torch.npz") as a, \
            np.load(tmp_path / "jax.npz") as b:
        np.testing.assert_array_equal(a["map"], b["map"])
    r = subprocess.run([sys.executable, "-m",
                        "radiativetransfer_tpu_torch.io.convert", "info",
                        snap], capture_output=True, text=True, check=True,
                       cwd=os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__))))
    assert r.stdout == _quiet(jconvert.main, ["info", snap])


def _cli_run(directory, *flags):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tcli.main([str(directory / "inputParameters"), "--snapshot-dir",
                   str(directory), "--angular-level", "1", "--x64",
                   "--platform", "cpu", "--iters", "2", *flags])
    return buf.getvalue()


def test_cli_on_an_h4_grid_matches_its_npz(tmp_path):
    """The two-level 8^3 galaxy, mode 9: the .h4 run's log lines (but the
    iteration's seconds) and its snapshots equal the .npz run's."""
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        outs = {}
        for kind in ("npz", "h4"):
            d = tmp_path / kind
            chip_smoke.write_cli_inputs(str(d), 8, refine_center=True)
            if kind == "h4":
                npz = str(d / "testgrid_velmet.npz")
                _quiet(convert.npz2h4, npz, str(d / "testgrid_velmet.h4"))
                os.remove(npz)
            outs[kind] = re.sub(r"dt=\S+s \(\S+ cells\*angles/s\)", "",
                                _cli_run(d))
    finally:
        torch.set_num_threads(torch_threads)
    assert "grid: 8^3 + refined level (64 parents)" in outs["h4"]
    assert outs["h4"] == outs["npz"].replace(str(tmp_path / "npz"),
                                             str(tmp_path / "h4"))
    assert (tmp_path / "h4" / "time").read_text() == (
        tmp_path / "npz" / "time").read_text()
    for it in (1, 2):
        name = f"cellArray{it:04d}.npz"
        with np.load(tmp_path / "h4" / name) as a, \
                np.load(tmp_path / "npz" / name) as b:
            assert list(a.keys()) == list(b.keys())
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
