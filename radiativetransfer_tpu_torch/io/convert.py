"""Standalone format converters -- the C24 tool family.

Counterpart of the JAX package's io/convert.py, the same subcommands on
the port's own grid_io, sfc, diagnostics and hdf4 (NumPy only).  The
reference ships four converter programs (SURVEY.md C24); their
equivalents here operate between the reference's Fortran unformatted
level-list binaries, our npz level lists, and cellArray snapshots:

* bin2npz       — bin2hdf4.f90 equivalent: Fortran binary -> level npz
* snapshot2levels — hdf42bin.f90 equivalent: cellArray snapshot ->
                  level-list npz with SFC-reconstructed coordinates
                  (computeCellCoordinates, hdf42bin.f90:222-269)
* info          — readCellArray.f90-style census + field summary
* project       — slice/map extraction from a snapshot
* npz2h4 / h42npz — level npz <-> the reference's HDF4 grid container
                  (bin2hdf4.f90 layout; pure-Python SD codec io.hdf4)
* snapshot2h4 / h42snapshot — cellArray npz <-> reference HDF4 snapshot
                  (writeIonization layout, equiSources.f90:4797-4912)

Usage: python -m radiativetransfer_tpu_torch.io.convert <command> <args...>
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from . import grid_io, sfc


def bin2npz(src: str, dst: str, read_metals: bool, read_kinematics: bool) -> None:
    levels = grid_io.read_fortran_level_binary(src, read_metals, read_kinematics)
    grid_io.write_level_npz(dst, levels)
    for i, lv in enumerate(levels):
        print(f"level = {i + 1}  cells = {lv.ncell}")
    print(f"wrote {dst}")


def snapshot2levels(src: str, dst: str) -> None:
    """cellArray snapshot -> level-list npz with leaf coordinates.

    For AMR snapshots the per-leaf levels drive the SFC reconstruction; the
    uniform case is plain C order.
    """
    with np.load(src) as f:
        shape = tuple(f["base_grid_size"])
        levels_arr = f["level"]
        fields = {k: f[k] for k in ("HI", "HeI", "HeII", "temperature",
                                    "density", "velx", "vely", "velz")
                  if k in f}
    n = shape[0]
    nlv = int(levels_arr.max()) + 1
    if nlv == 1:
        enum = sfc.enumerate_leaves(n, n, n, [np.zeros(shape, np.uint8)])
    else:
        # reconstruct refinement bitmaps by walking the SFC stream
        refined = _reconstruct_bitmaps(n, levels_arr)
        enum = sfc.enumerate_leaves(n, n, n, refined)
    assert len(enum["level"]) == len(levels_arr), "leaf count mismatch"
    out = {
        "x": enum["x"], "y": enum["y"], "z": enum["z"],
        "level": enum["level"],
    }
    out.update(fields)
    np.savez_compressed(dst, **out)
    print(f"wrote {dst}: {len(levels_arr)} leaves, {nlv} levels")


def _reconstruct_bitmaps(n: int, levels_stream: np.ndarray) -> list[np.ndarray]:
    """Refinement bitmaps from a depth-first level stream
    (createFullyThreadedStructure semantics, readCellArray.f90:154-187)."""
    nlv = int(levels_stream.max())
    refined = [np.zeros((n << l, n << l, n << l), np.uint8) for l in range(nlv)]
    pos = 0

    def visit(level, i, j, k):
        nonlocal pos
        if levels_stream[pos] > level:
            refined[level][i, j, k] = 1
            for di in range(2):
                for dj in range(2):
                    for dk in range(2):
                        visit(level + 1, 2 * i + di, 2 * j + dj, 2 * k + dk)
        else:
            if levels_stream[pos] != level:
                raise ValueError(f"level stream mismatch at leaf {pos}")
            pos += 1

    sys.setrecursionlimit(10000)
    for i in range(n):
        for j in range(n):
            for k in range(n):
                visit(0, i, j, k)
    return refined


def npz2h4(src: str, dst: str) -> None:
    """Level-list npz -> HDF4 grid file in the reference's exact layout
    (bin2hdf4.f90:106-166): dataset 0 = 'nlevels' int32, then per level
    'pos' (Fortran (ncell,3) = C (3,ncell)), 'lT', 'lnH', 'lx'
    [, 'abun' (4,ncell)][, 'vel' (3,ncell)] — readable by the reference's
    `sfstart`/`sfselect`/`sfrdata` ingestion (equiSources.f90:316-423)."""
    from . import hdf4
    levels = grid_io.read_level_npz(src)
    ds = [("nlevels", np.array([len(levels)], np.int32))]
    for lv in levels:
        ds.append(("pos", np.ascontiguousarray(lv.pos.T, np.float32)))
        ds.append(("lT", lv.lT.astype(np.float32)))
        ds.append(("lnH", lv.lnH.astype(np.float32)))
        ds.append(("lx", lv.lx.astype(np.float32)))
        if lv.abun is not None:
            ds.append(("abun", np.ascontiguousarray(lv.abun.T, np.float32)))
        if lv.vel is not None:
            ds.append(("vel", np.ascontiguousarray(lv.vel.T, np.float32)))
    hdf4.write_sd(dst, ds)
    print(f"wrote {dst}: {len(levels)} levels, {len(ds)} datasets")


def h42npz(src: str, dst: str) -> None:
    """HDF4 grid file (reference layout) -> level-list npz."""
    levels = h42levels(src)
    grid_io.write_level_npz(dst, levels)
    for i, lv in enumerate(levels):
        print(f"level = {i + 1}  cells = {lv.ncell}")
    print(f"wrote {dst}")


def h42levels(src: str) -> list:
    """Parse an HDF4 grid file (reference layout) into LevelData lists
    (the CLI ingests `grid.h4` inputs through this)."""
    from . import hdf4
    ds = hdf4.read_sd(src)
    nlevels = int(np.asarray(ds[0][1]).reshape(-1)[0])
    n_var = (len(ds) - 1) // nlevels
    levels = []
    for lv in range(nlevels):
        chunk = ds[1 + lv * n_var: 1 + (lv + 1) * n_var]
        by_name = {name: arr for name, arr in chunk}
        # index-order fallback when names were not recoverable
        keys = ["pos", "lT", "lnH", "lx"]
        if len(chunk) >= 5:
            keys.append("abun" if chunk[4][1].ndim == 2
                        and chunk[4][1].shape[0] == 4 else "vel")
        if len(chunk) >= 6:
            keys.append("vel")
        vals = {k: by_name.get(k, chunk[i][1])
                for i, k in enumerate(keys)}
        levels.append(grid_io.LevelData(
            pos=np.ascontiguousarray(vals["pos"].T, np.float32),
            lT=vals["lT"].astype(np.float32),
            lnH=vals["lnH"].astype(np.float32),
            lx=vals["lx"].astype(np.float32),
            abun=(np.ascontiguousarray(vals["abun"].T, np.float32)
                  if "abun" in vals else None),
            vel=(np.ascontiguousarray(vals["vel"].T, np.float32)
                 if "vel" in vals else None)))
    return levels


_CELLARRAY_FIELDS = ("HI", "HeI", "HeII", "temperature", "density")


def snapshot2h4(src: str, dst: str) -> None:
    """cellArray npz snapshot -> HDF4 in the reference's writeIonization
    layout (equiSources.f90:4797-4912): 'base grid size' int32(3),
    'level' int32, HI/HeI/HeII/temperature/density float32
    [, velx/vely/velz][, abun2] — SFC leaf order preserved, restartable
    by the reference (readLatestIonization, :4738-4795; the iteration
    counter rides the filename digits, :1079-1080)."""
    from . import hdf4
    with np.load(src) as f:
        ds = [("base grid size",
               np.asarray(f["base_grid_size"], np.int32)),
              ("level", f["level"].astype(np.int32))]
        for k in _CELLARRAY_FIELDS:
            ds.append((k, f[k].astype(np.float32)))
        for k in ("velx", "vely", "velz"):
            if k in f:
                ds.append((k, f[k].astype(np.float32)))
        if "abun2" in f:
            ds.append(("abun2", f["abun2"].astype(np.float32)))
    hdf4.write_sd(dst, ds)
    print(f"wrote {dst}: {len(ds)} datasets")


def h42snapshot(src: str, dst: str, itime: int | None = None) -> None:
    """HDF4 cellArray (reference layout) -> npz snapshot.  itime defaults
    to the source filename digits (equiSources.f90:1079-1080)."""
    import re

    from . import hdf4
    ds = hdf4.read_sd(src)
    by_name = {name: arr for name, arr in ds}
    named = all(k in by_name for k in ("level",) + _CELLARRAY_FIELDS)
    if not named:
        # index order per writeIonization
        keys = ["base grid size", "level", *_CELLARRAY_FIELDS]
        rest = [a for _, a in ds[len(keys):]]
        by_name = {k: ds[i][1] for i, k in enumerate(keys)}
        if len(rest) >= 3:
            by_name.update(velx=rest[0], vely=rest[1], velz=rest[2])
        if len(rest) in (1, 4):
            by_name["abun2"] = rest[-1]
    if itime is None:
        m = re.search(r"(\d+)\.h4$", src)
        itime = int(m.group(1)) if m else 0
    out = {"base_grid_size": np.asarray(by_name["base grid size"],
                                        np.int32),
           "itime": np.int32(itime),
           "physical_box_size": np.float64(0.0),
           "level": by_name["level"].astype(np.int32)}
    for k in _CELLARRAY_FIELDS + ("velx", "vely", "velz", "abun2"):
        if k in by_name:
            out[k] = by_name[k].astype(np.float32)
    np.savez_compressed(dst, **out)
    print(f"wrote {dst}: {len(out['level'])} leaves, itime = {itime}")


def info(src: str) -> None:
    with np.load(src) as f:
        if "base_grid_size" in f:
            shape = tuple(f["base_grid_size"])
            levels_arr = f["level"]
            print(f"snapshot: base grid {shape}, itime = {int(f['itime'])}")
            vals, counts = np.unique(levels_arr, return_counts=True)
            for v, c in zip(vals, counts):
                print(f"level = {v}  cells = {c}")
            for k in ("HI", "HeI", "HeII", "temperature", "density"):
                if k in f:
                    a = f[k]
                    print(f"{k:12s} min={a.min():.4e} max={a.max():.4e} "
                          f"mean={a.mean():.4e}")
        elif "nlevels" in f:
            nl = int(f["nlevels"])
            print(f"level-list grid: {nl} levels")
            for i in range(nl):
                print(f"level = {i + 1}  cells = {len(f[f'lT_{i}'])}")
        else:
            print(f"unknown npz schema: keys = {sorted(f.keys())}")


def project(src: str, dst: str, field: str, axis: int) -> None:
    from . import diagnostics
    with np.load(src) as f:
        shape = tuple(f["base_grid_size"])
        data = f[field].reshape(shape)
        rho = f["density"].reshape(shape)
    m = diagnostics.project_to_map(data, rho, axis=axis)
    np.savez_compressed(dst, map=m)
    print(f"wrote {dst}: {m.shape} projection of {field}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("bin2npz")
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--metals", action="store_true")
    p.add_argument("--kinematics", action="store_true")
    p = sub.add_parser("snapshot2levels")
    p.add_argument("src")
    p.add_argument("dst")
    for cmd in ("npz2h4", "h42npz", "snapshot2h4", "h42snapshot"):
        p = sub.add_parser(cmd)
        p.add_argument("src")
        p.add_argument("dst")
    p = sub.add_parser("info")
    p.add_argument("src")
    p = sub.add_parser("project")
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--field", default="HI")
    p.add_argument("--axis", type=int, default=2)
    args = ap.parse_args(argv)
    if args.cmd == "bin2npz":
        bin2npz(args.src, args.dst, args.metals, args.kinematics)
    elif args.cmd == "snapshot2levels":
        snapshot2levels(args.src, args.dst)
    elif args.cmd in ("npz2h4", "h42npz", "snapshot2h4", "h42snapshot"):
        {"npz2h4": npz2h4, "h42npz": h42npz,
         "snapshot2h4": snapshot2h4,
         "h42snapshot": h42snapshot}[args.cmd](args.src, args.dst)
    elif args.cmd == "info":
        info(args.src)
    elif args.cmd == "project":
        project(args.src, args.dst, args.field, args.axis)


if __name__ == "__main__":
    main()
