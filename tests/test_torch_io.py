"""PyTorch port, host I/O: grid and source ingestion, diagnostics, the
expansion model and uniform snapshots, each run through both packages on
the same NumPy inputs from a seed.  NumPy code copied from the JAX package
must give identical arrays; torch code is held to float64 within 1e-12
relative, and snapshots are read across packages within 1 ulp."""

import dataclasses
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiativetransfer_tpu.core import expansion as jexpansion
from radiativetransfer_tpu.core import state as jstate
from radiativetransfer_tpu.io import diagnostics as jdiag
from radiativetransfer_tpu.io import grid_io as jgrid
from radiativetransfer_tpu.io import snapshot as jsnap
from radiativetransfer_tpu.io import sources_io as jsrc
from radiativetransfer_tpu_torch import GridGeometry
from radiativetransfer_tpu_torch.constants import KPC, MH, MHE, MYR, PSI
from radiativetransfer_tpu_torch.core import expansion as texpansion
from radiativetransfer_tpu_torch.core import state as tstate
from radiativetransfer_tpu_torch.io import diagnostics as tdiag
from radiativetransfer_tpu_torch.io import grid_io as tgrid
from radiativetransfer_tpu_torch.io import snapshot as tsnap
from radiativetransfer_tpu_torch.io import sources_io as tsrc

_JDT = {torch.float32: jnp.float32, torch.float64: jnp.float64}


def _levels(mod, n=8, box=300.0, seed=0, vel=True, metals=True,
            refine=False):
    """A synthetic galaxy's level lists (examples/make_test_data.py's
    formula) as `mod.LevelData`; with `refine`, a second level over the
    central quarter."""
    rng = np.random.default_rng(seed)
    ax = (np.arange(n) + 0.5) / n * box - box / 2
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    pos = np.stack([x.ravel(), y.ravel(), z.ravel()], 1).astype(np.float32)
    r = np.sqrt((pos.astype(np.float64) ** 2).sum(1))
    nh = 3e-3 / (1.0 + (r / (0.15 * box)) ** 2)
    nh = nh * rng.lognormal(0.0, 0.4, nh.shape)
    m = n ** 3
    abun = np.zeros((m, 4), np.float32)
    abun[:, 1] = 0.004 * np.exp(-r / (0.3 * box))
    levels = [mod.LevelData(
        pos=pos, lT=rng.uniform(3.8, 4.4, m).astype(np.float32),
        lnH=np.log10(nh).astype(np.float32),
        lx=rng.uniform(-0.5, 0.0, m).astype(np.float32),
        vel=rng.normal(0, 30, (m, 3)).astype(np.float32) if vel else None,
        abun=abun if metals else None)]
    if refine:
        sel = pos[np.all(np.abs(pos) < box / 4, axis=1)]
        fine = (sel[:, None, :] + box / n / 4 * np.array(
            [[i, j, k] for i in (-1, 1) for j in (-1, 1) for k in (-1, 1)],
            np.float32)[None]).reshape(-1, 3)
        mf = len(fine)
        levels.append(mod.LevelData(
            pos=fine.astype(np.float32),
            lT=np.full(mf, 4.0, np.float32),
            lnH=np.log10(rng.uniform(1e-3, 1e-2, mf)).astype(np.float32),
            lx=np.zeros(mf, np.float32),
            vel=rng.normal(0, 30, (mf, 3)).astype(np.float32) if vel else None,
            abun=np.full((mf, 4), 0.002, np.float32) if metals else None))
    return levels


def _same_levels(a, b):
    assert len(a) == len(b)
    for la, lb in zip(a, b):
        for f in dataclasses.fields(la):
            x, y = getattr(la, f.name), getattr(lb, f.name)
            if x is None:
                assert y is None, f.name
            else:
                assert x.dtype == y.dtype, f.name
                np.testing.assert_array_equal(x, y, err_msg=f.name)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_level_npz_read_across_packages(tmp_path, writer):
    w, r = (jgrid, tgrid) if writer == "jax" else (tgrid, jgrid)
    levels = _levels(w, refine=True)
    path = str(tmp_path / "grid.npz")
    w.write_level_npz(path, levels)
    _same_levels(r.read_level_npz(path), w.read_level_npz(path))
    _same_levels(r.read_level_npz(path), levels)


def _write_fortran_levels(path, levels, metals, kinematics, empty_tail):
    def rec(fh, payload):
        fh.write(struct.pack("<i", len(payload)) + payload
                 + struct.pack("<i", len(payload)))

    with open(path, "wb") as fh:
        rec(fh, struct.pack("<i", len(levels) + empty_tail))
        for lv in levels:
            rec(fh, struct.pack("<i", lv.ncell))
            cols = [lv.pos[:, 0], lv.pos[:, 1], lv.pos[:, 2], lv.lT, lv.lnH,
                    lv.lx]
            if metals:
                cols += [lv.abun[:, i] for i in range(4)]
            if kinematics:
                cols += [lv.vel[:, i] for i in range(3)]
            for c in cols:
                rec(fh, np.ascontiguousarray(c, "<f4").tobytes())
        ncols = 6 + 4 * metals + 3 * kinematics
        for _ in range(empty_tail):
            rec(fh, struct.pack("<i", 0))
            for _ in range(ncols):
                rec(fh, b"")


@pytest.mark.parametrize("metals,kinematics", [(True, True), (False, False)])
def test_fortran_level_binary_round_trip(tmp_path, metals, kinematics):
    levels = _levels(tgrid, vel=kinematics, metals=metals, refine=True)
    path = str(tmp_path / "grid.dat")
    _write_fortran_levels(path, levels, metals, kinematics, empty_tail=1)
    got = tgrid.read_fortran_level_binary(path, metals, kinematics)
    _same_levels(got, jgrid.read_fortran_level_binary(path, metals,
                                                      kinematics))
    assert len(got) == 2
    for lv, ref in zip(got, levels):
        np.testing.assert_array_equal(lv.pos, ref.pos)
        np.testing.assert_array_equal(lv.lnH, ref.lnH)
        if metals:
            np.testing.assert_array_equal(lv.abun, ref.abun)
        if kinematics:
            np.testing.assert_array_equal(lv.vel, ref.vel)
    bad = tmp_path / "bad.dat"
    data = bytearray(open(path, "rb").read())
    data[-1] ^= 0xFF
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="record markers"):
        tgrid.read_fortran_level_binary(str(bad), metals, kinematics)


def test_grid_numpy_functions_identical():
    levels = _levels(tgrid, refine=True)
    for a, b in zip(tgrid.grid_bounds(levels), jgrid.grid_bounds(levels)):
        np.testing.assert_array_equal(a, b)
    (nt, bt), (nj, bj) = (tgrid.normalize_coordinates(levels),
                          jgrid.normalize_coordinates(levels))
    assert bt == bj
    _same_levels(nt, nj)
    dt = tgrid.levels_to_dense(nt, 8, True)
    dj = jgrid.levels_to_dense(nj, 8, True)
    assert dt.keys() == dj.keys()
    for k in dt:
        np.testing.assert_array_equal(dt[k], dj[k], err_msg=k)
    np.testing.assert_array_equal(tgrid.smooth_metallicity(dt["abun2"]),
                                  jgrid.smooth_metallicity(dj["abun2"]))


def _fields(state) -> dict:
    return {f.name: (None if getattr(state, f.name) is None
                     else np.asarray(getattr(state, f.name))
                     if not torch.is_tensor(getattr(state, f.name))
                     else getattr(state, f.name).numpy())
            for f in dataclasses.fields(state)}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("metals", [True, False])
def test_build_uniform_state_matches(dtype, metals):
    levels = _levels(tgrid, metals=metals)
    ts, tg = tgrid.build_uniform_state(levels, metals, dtype=dtype,
                                       device="cpu")
    js, jg = jgrid.build_uniform_state(levels, metals, dtype=_JDT[dtype])
    assert dataclasses.asdict(tg) == dataclasses.asdict(jg)
    assert tgrid.build_uniform_state.__kwdefaults__["device"] == "cuda"
    ft, fj = _fields(ts), _fields(js)
    for k in ft:
        assert ft[k].dtype == fj[k].dtype, k
        # max abs diff 0, f32 included
        np.testing.assert_array_equal(ft[k], fj[k], err_msg=k)


def _stars(mod, n_src=40, seed=1):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, 1.0, (n_src, 3))
    pos[: n_src // 4] = pos[0]          # degenerate particles merge
    return mod.StarList(position=pos,
                        age=rng.uniform(1.0, 30.0, n_src) * MYR,
                        level=np.ones(n_src, int))


@pytest.mark.parametrize("buckets", [False, True])
@pytest.mark.parametrize("refined", [False, True])
def test_prepare_sources_identical(buckets, refined):
    n = 8
    rng = np.random.default_rng(3)
    abun2 = rng.uniform(1e-4, 2e-2, (n, n, n))
    edges = np.array([0.0, 1e-3, 5e-3, np.inf]) if buckets else None
    ref = rng.uniform(size=(n, n, n)) < 0.3 if refined else None
    bt, ht, yt = tsrc.prepare_sources(_stars(tsrc), n, 20.0 * MYR,
                                      abun2=abun2, metal_bucket_edges=edges,
                                      refined=ref)
    bj, hj, yj = jsrc.prepare_sources(_stars(jsrc), n, 20.0 * MYR,
                                      abun2=abun2, metal_bucket_edges=edges,
                                      refined=ref)
    assert type(bt).__module__ == "radiativetransfer_tpu_torch.core.rays"
    assert yt == yj
    np.testing.assert_array_equal(ht, hj)
    for f in ("position", "weight", "table_idx"):
        a, b = getattr(bt, f), getattr(bj, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    if buckets:
        assert len(np.unique(bt.table_idx)) > 1


def test_read_star_file_identical(tmp_path):
    rng = np.random.default_rng(5)
    rows = [f"1 {p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {a:.3f}"
            for p, a in zip(rng.normal(0, 20, (9, 3)), rng.uniform(1, 30, 9))]
    path = tmp_path / "stars.dat"
    path.write_text("\n".join(rows) + "\n")
    lo, hi = np.full(3, -150.0), np.full(3, 150.0)
    st, sj = (tsrc.read_star_file(str(path), lo, hi),
              jsrc.read_star_file(str(path), lo, hi))
    for f in ("position", "age", "level"):
        np.testing.assert_array_equal(getattr(st, f), getattr(sj, f))


def test_diagnostics_identical():
    rng = np.random.default_rng(7)
    n = 8
    rho = 10.0 ** rng.uniform(-29, -22, (n, n, n))
    host_rho = rho.ravel()[rng.integers(0, n ** 3, 20)]
    pt, pj = (tdiag.density_pdfs(rho, host_rho),
              jdiag.density_pdfs(rho, host_rho))
    for f in dataclasses.fields(pt):
        np.testing.assert_array_equal(getattr(pt, f.name),
                                      getattr(pj, f.name))
    # float32 densities are binned in float64 (rho / MSUN underflows
    # float32)
    r32 = rho.astype(np.float32)
    p32, p64 = (tdiag.density_pdfs(r32, host_rho.astype(np.float32)),
                tdiag.density_pdfs(r32.astype(np.float64), host_rho.astype(
                    np.float32).astype(np.float64)))
    for f in dataclasses.fields(p32):
        np.testing.assert_array_equal(getattr(p32, f.name),
                                      getattr(p64, f.name))
    assert p32.pdf_gas.sum() > 0 and p32.pdf_star.sum() > 0
    assert tdiag.clumping_factor(rho) == jdiag.clumping_factor(rho)
    lev = rng.integers(0, 3, (n, n, n))
    for levels in (lev, None):
        assert tdiag.cell_census(levels, rho.shape) == \
            jdiag.cell_census(levels, rho.shape)
    field = rng.uniform(size=rho.shape)
    for axis, zslice in ((2, None), (0, (2, 6))):
        np.testing.assert_array_equal(
            tdiag.project_to_map(field, rho, axis, zslice),
            jdiag.project_to_map(field, rho, axis, zslice))


def _state_pair(n=8, dtype=torch.float64, seed=11, vel=False, **species):
    """The same random state in both packages."""
    rng = np.random.default_rng(seed)
    nh = 10.0 ** rng.uniform(-4, 0, (n, n, n))
    rho = nh * MH / PSI
    tgas = rng.uniform(1e3, 3e4, (n, n, n))
    HI = species.pop("HI", nh * rng.uniform(0.0, 1.0, (n, n, n)))
    v = rng.normal(0, 30, (3, n, n, n)) if vel else None
    abun2 = rng.uniform(1e-4, 2e-2, (n, n, n))
    js = jstate.make_state(rho, tgas, HI, abun2=abun2, dtype=_JDT[dtype],
                           vel=v, **species)
    ts = tstate.make_state(rho, tgas, HI, abun2=abun2, dtype=dtype, vel=v,
                           device="cpu", **species)
    return ts, js


def test_neutral_mass_fractions_f64():
    ts, js = _state_pair()
    vol = (300.0 * KPC / 8) ** 3
    for a, b in zip(tdiag.neutral_mass_fractions(ts, vol),
                    jdiag.neutral_mass_fractions(js, vol)):
        assert abs(a - b) <= 1e-12 * abs(b)


def test_expansion_matches_f64():
    for nh in (1e-8, 0.5, 1.0, 3.7, 250.0, 1e4):
        assert texpansion.expansion_parameters(nh) == \
            jexpansion.expansion_parameters(nh)
    n = 12
    ts, js = _state_pair(n)
    geom = GridGeometry(n, n, n, 0.3 * KPC)
    pos = np.random.default_rng(2).uniform(0.1, 0.9, (3, 3))
    to = texpansion.apply_expansion(ts, geom, pos)
    jo = jexpansion.apply_expansion(js, geom, pos)
    assert not np.array_equal(to.rho.numpy(), ts.rho.numpy())
    for f in ("rho", "HI", "HeI", "HeII"):
        a, b = getattr(to, f).numpy(), np.asarray(getattr(jo, f))
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0, err_msg=f)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("vel", [False, True])
def test_write_snapshot_same_file(tmp_path, dtype, vel):
    ts, js = _state_pair(dtype=dtype, vel=vel)
    extra = {"note": np.arange(4, dtype=np.int16)}
    pt, pj = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tsnap.write_snapshot(pt, ts, 7, 300.0 * KPC, extra=extra)
    jsnap.write_snapshot(pj, js, 7, 300.0 * KPC, extra=extra)
    with np.load(pt) as ft, np.load(pj) as fj:
        assert list(ft.keys()) == list(fj.keys())
        for k in fj:
            assert ft[k].dtype == fj[k].dtype, k
            assert np.array_equal(ft[k], fj[k]), k


def _assert_fields_ulp(ts, js, names, maxulp=1):
    for f in names:
        a, b = getattr(ts, f).numpy(), np.asarray(getattr(js, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_max_ulp(a, b, maxulp=maxulp)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_read_snapshot_across_packages_with_clamps(tmp_path, dtype, writer):
    """A snapshot from a state with HI < 0 and HI > nH, negative HeI and
    HeII and HeI + HeII > nHe in some cells, read by both packages onto
    the same base state: every clamp bites, and the fields agree."""
    n = 8
    rng = np.random.default_rng(13)
    nh = 10.0 ** rng.uniform(-4, 0, (n, n, n))
    nhe = (1.0 - PSI) * (nh * MH / PSI) / MHE
    pick = rng.integers(0, 5, (n, n, n))
    HI = np.choose(pick, [-0.1 * nh, 1.5 * nh, 0.3 * nh, nh, 0.9 * nh])
    HeI = np.where(pick == 2, -nhe, 0.8 * nhe)
    HeII = np.where(pick == 3, -0.2 * nhe, np.where(pick == 4, 0.7 * nhe,
                                                    0.1 * nhe))
    ws, wj = _state_pair(dtype=dtype, seed=17, vel=True, HI=HI, HeI=HeI,
                         HeII=HeII)
    path = str(tmp_path / "cellArray0042.npz")
    if writer == "jax":
        jsnap.write_snapshot(path, wj, 42, 300.0 * KPC)
    else:
        tsnap.write_snapshot(path, ws, 42, 300.0 * KPC)
    base_t, base_j = _state_pair(dtype=dtype, seed=19)
    rt_, it_ = tsnap.read_snapshot(path, base_t)
    rj, ij = jsnap.read_snapshot(path, base_j)
    assert it_ == ij == 42
    _assert_fields_ulp(rt_, rj, ("HI", "HeI", "HeII", "tgas", "vel", "rho"))
    hi, nh_b = rt_.HI.numpy(), base_t.nh.numpy()
    with np.load(path) as f:
        raw = f["HI"].reshape(n, n, n)
    assert (raw < 0).any() and (raw > nh_b).any()
    assert hi.min() >= 0 and (hi <= nh_b).all()
    he = (rt_.HeI + rt_.HeII).numpy()
    assert (rt_.HeI.numpy() >= 0).all() and (rt_.HeII.numpy() >= 0).all()
    assert (he <= base_t.nhe.numpy() * (1 + 4 * np.finfo(he.dtype).eps)).all()
    with pytest.raises(ValueError, match="grid"):
        tsnap.read_snapshot(path, _state_pair(n=4, dtype=dtype)[0])


def test_snapshot_names_and_time_log(tmp_path):
    for it in (0, 7, 123, 9999):
        assert tsnap.snapshot_name(it, str(tmp_path)) == \
            jsnap.snapshot_name(it, str(tmp_path))
    for name in ("cellArray0003.npz", "cellArray0012.npz", "cellArray0100.npz",
                 "cellArray12.npz", "other0200.npz"):
        (tmp_path / name).write_bytes(b"")
    assert tsnap.latest_snapshot(str(tmp_path)) == \
        jsnap.latest_snapshot(str(tmp_path)) == \
        str(tmp_path / "cellArray0100.npz")
    empty = tmp_path / "empty"
    empty.mkdir()
    assert tsnap.latest_snapshot(str(empty)) is None
    for path in ("x/cellArray0042.npz", "cellArray0007.h4"):
        assert tsnap.itime_from_name(path) == jsnap.itime_from_name(path)
    with pytest.raises(ValueError):
        tsnap.itime_from_name("cellArray.npz")
    logs = []
    for mod in (tsnap, jsnap):
        path = str(tmp_path / f"time_{mod.__name__.split('.')[0]}")
        log = mod.TimeLog(path)
        log.append(1, 0.123456789012)
        log.restart_marker(1)
        log.append(12345, 1.0)
        with open(path, "rb") as fh:
            logs.append(fh.read())
    assert logs[0] == logs[1]


@pytest.mark.parametrize("name", [
    "species_extra", "read_species", "write_snapshot_sparse",
    "read_snapshot_sparse"])
def test_storage_forms_not_ported(name):
    # no storage form is left as a stub: the block-sparse forms are ported
    # (tests/test_torch_amr_sparse.py holds them against the JAX
    # package's) and fail on a missing state as code, not as a stub; the
    # species forms are ported for uniform and nested grids alike (their
    # nested form is the prefix / the tuple of templates, no stub of its
    # own)
    if name in ("species_extra", "read_species"):
        assert not hasattr(tsnap, f"{name}_ml")
        return
    fn = getattr(tsnap, name)
    assert fn.__name__ == name and fn.__module__ == tsnap.__name__
    with pytest.raises(Exception) as e:
        fn(None, None)
    assert not isinstance(e.value, NotImplementedError)
