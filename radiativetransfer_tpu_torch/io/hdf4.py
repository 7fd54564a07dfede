"""Minimal pure-Python HDF4 Scientific-Data-Set reader/writer.

Counterpart of the JAX package's io/hdf4.py, the same code (it is
struct and NumPy only, and the port imports nothing of that package).
The reference stores grids and cellArray snapshots as HDF4 SDS files
accessed through the mfhdf SD API by dataset INDEX
(equiSources.f90:316-423 reads `sfselect(sd_id, k)`;
`bin2hdf4.f90:106-166` and `writeIonization`, equiSources.f90:4797-4912,
create them in a fixed order).  This module implements the subset of the
HDF4 container those programs touch, with no native library:

* `read_sd(path)` -> list of (name, ndarray) in dataset-index order.
  Parses the DD list for DFTAG_NDG numeric-data groups (written both by
  the old DFSD interface and, for backward compatibility, by the mfhdf
  SD interface), resolves each group's dimension record (DFTAG_SDD),
  number type (DFTAG_NT) and raw data (DFTAG_SD), and recovers names
  from DFAN labels (DFTAG_DIL) or SD-interface Vgroups (DFTAG_VG,
  class "Var0.0").  Contiguous and linked-block (special tag 0x4000)
  data elements are supported.

* `write_sd(path, datasets)` -> writes `[(name, array), ...]` as an
  old-style (DFSD-compatible) HDF4 file: per dataset one NT + SDD + SD +
  NDG tag set plus a DFTAG_DIL label carrying the name.  The mfhdf SD
  API reads such files transparently (old-style SDS support), so the
  reference toolchain can `sfstart`/`sfselect`/`sfrdata` them directly.

Byte order is big-endian throughout (HDF4 stores Motorola order; the
number-type class bytes declare DFNTF_IEEE / DFNTI_MBO).  Array axis
convention: HDF4 C dimension 0 is the slowest axis, so a Fortran writer
calling `sfcreate(..., edges=(ncell, 3))` produces a C-order (3, ncell)
array here — converters transpose where the npz schema wants (ncell, 3).
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = b"\x0e\x03\x13\x01"

DFTAG_NULL = 1
DFTAG_LINKED = 20          # linked-block special storage
DFTAG_VERSION = 30
DFTAG_DIL = 104            # data identifier label (annotation)
DFTAG_NT = 106             # number type
DFTAG_SDD = 701            # scientific data dimension record
DFTAG_SD = 702             # scientific data
DFTAG_SDS = 703            # scales
DFTAG_NDG = 720            # numeric data group
DFTAG_VG = 1965            # Vgroup
DFTAG_VH = 1962            # Vdata header
SPECIAL_BIT = 0x4000

DFNT_FLOAT32 = 5
DFNT_FLOAT64 = 6
DFNT_INT8 = 20
DFNT_UINT8 = 21
DFNT_INT16 = 22
DFNT_UINT16 = 23
DFNT_INT32 = 24
DFNT_UINT32 = 25

_DTYPES = {
    DFNT_FLOAT32: np.dtype(">f4"),
    DFNT_FLOAT64: np.dtype(">f8"),
    DFNT_INT8: np.dtype(">i1"),
    DFNT_UINT8: np.dtype(">u1"),
    DFNT_INT16: np.dtype(">i2"),
    DFNT_UINT16: np.dtype(">u2"),
    DFNT_INT32: np.dtype(">i4"),
    DFNT_UINT32: np.dtype(">u4"),
}
_CODES = {
    np.dtype(np.float32): DFNT_FLOAT32,
    np.dtype(np.float64): DFNT_FLOAT64,
    np.dtype(np.int32): DFNT_INT32,
    np.dtype(np.int16): DFNT_INT16,
    np.dtype(np.uint8): DFNT_UINT8,
}


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------


def _read_dds(buf: bytes):
    """All (tag, ref, offset, length) descriptors, DD-block chain walked."""
    if buf[:4] != MAGIC:
        raise ValueError("not an HDF4 file (bad magic)")
    dds = []
    pos = 4
    while pos:
        ndd, nxt = struct.unpack_from(">hI", buf, pos)
        for i in range(ndd):
            tag, ref, off, ln = struct.unpack_from(">HHII", buf,
                                                   pos + 6 + 12 * i)
            if tag != DFTAG_NULL:
                dds.append((tag, ref, off, ln))
        pos = nxt
    return dds


def _element(buf: bytes, dds, tag: int, ref: int) -> bytes:
    """Raw bytes of a data element, following linked-block storage."""
    for t, r, off, ln in dds:
        if r != ref:
            continue
        if t == tag:
            return buf[off:off + ln]
        if t == (tag | SPECIAL_BIT):
            sp, = struct.unpack_from(">h", buf, off)
            if sp != 1:                     # SPECIAL_LINKED
                raise ValueError(f"unsupported special storage {sp} for "
                                 f"tag {tag} ref {ref}")
            length, first_len, blk_len, nblk, link_ref = struct.unpack_from(
                ">IIIIH", buf, off + 2)
            out = bytearray()
            bi = 0
            while link_ref and len(out) < length:
                tbl = _element(buf, dds, DFTAG_LINKED, link_ref)
                link_ref, = struct.unpack_from(">H", tbl, 0)
                nrefs = (len(tbl) - 2) // 2
                refs = struct.unpack_from(f">{nrefs}H", tbl, 2)
                for br in refs:
                    if br == 0 or len(out) >= length:
                        break
                    take = first_len if bi == 0 else blk_len
                    out += _element(buf, dds, DFTAG_LINKED, br)[:take]
                    bi += 1
            return bytes(out[:length])
    raise KeyError(f"no data element tag {tag} ref {ref}")


def _vgroup_names(buf: bytes, dds) -> dict:
    """NDG-ref -> name from SD-interface Vgroups (class Var0.0)."""
    names = {}
    for t, r, off, ln in dds:
        if t != DFTAG_VG:
            continue
        data = buf[off:off + ln]
        try:
            nelt, = struct.unpack_from(">H", data, 0)
            tags = struct.unpack_from(f">{nelt}H", data, 2)
            refs = struct.unpack_from(f">{nelt}H", data, 2 + 2 * nelt)
            p = 2 + 4 * nelt
            nl, = struct.unpack_from(">H", data, p)
            name = data[p + 2:p + 2 + nl].split(b"\0")[0].decode(
                "ascii", "replace")
            p += 2 + nl
            cl, = struct.unpack_from(">H", data, p)
            klass = data[p + 2:p + 2 + cl].split(b"\0")[0].decode(
                "ascii", "replace")
        except struct.error:
            continue
        if klass.startswith("Var"):
            for tg, rf in zip(tags, refs):
                if tg == DFTAG_NDG:
                    names[rf] = name
    return names


def _label_names(buf: bytes, dds) -> dict:
    """NDG-ref -> name from DFAN labels (DFTAG_DIL)."""
    names = {}
    for t, r, off, ln in dds:
        if t != DFTAG_DIL:
            continue
        data = buf[off:off + ln]
        tg, rf = struct.unpack_from(">HH", data, 0)
        if tg == DFTAG_NDG:
            names[rf] = data[4:].split(b"\0")[0].decode("ascii", "replace")
    return names


def read_sd(path: str) -> list[tuple[str, np.ndarray]]:
    """All scientific data sets of an HDF4 file, in dataset-index order
    (the order `sfselect(sd_id, k)` sees)."""
    with open(path, "rb") as fh:
        buf = fh.read()
    dds = _read_dds(buf)
    names = _label_names(buf, dds)
    names.update(_vgroup_names(buf, dds))

    out = []
    count = 0
    for t, r, off, ln in dds:
        if t != DFTAG_NDG:
            continue
        grp = buf[off:off + ln]
        members = [struct.unpack_from(">HH", grp, 4 * i)
                   for i in range(len(grp) // 4)]
        sdd_ref = next((rf for tg, rf in members if tg == DFTAG_SDD), None)
        sd_ref = next((rf for tg, rf in members if tg == DFTAG_SD), None)
        if sdd_ref is None or sd_ref is None:
            continue
        sdd = _element(buf, dds, DFTAG_SDD, sdd_ref)
        rank, = struct.unpack_from(">H", sdd, 0)
        dims = struct.unpack_from(f">{rank}I", sdd, 2)
        nt_tag, nt_ref = struct.unpack_from(">HH", sdd, 2 + 4 * rank)
        nt = _element(buf, dds, DFTAG_NT, nt_ref)
        code = nt[1]
        if code not in _DTYPES:
            raise ValueError(f"unsupported HDF4 number type {code}")
        dt = _DTYPES[code]
        raw = _element(buf, dds, DFTAG_SD, sd_ref)
        n = int(np.prod(dims)) if rank else 1
        arr = np.frombuffer(raw[:n * dt.itemsize], dt).reshape(dims)
        out.append((names.get(r, f"sds{count}"),
                    arr.astype(dt.newbyteorder("="))))
        count += 1
    return out


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------


def write_sd(path: str, datasets: list[tuple[str, np.ndarray]]) -> None:
    """Write (name, array) pairs as an old-style (DFSD-compatible) HDF4
    file readable through the mfhdf SD API.  Arrays convert to big-endian
    float32/float64/int32/int16/uint8; the C axis order is stored as-is
    (axis 0 slowest), matching what a Fortran reader with reversed edges
    expects."""
    dds = []        # (tag, ref, data bytes)
    for i, (name, arr) in enumerate(datasets):
        ref = i + 1
        arr = np.asarray(arr)
        base = arr.dtype.newbyteorder("=")
        if base not in _CODES:
            # promote anything unusual to a supported type
            base = np.dtype(np.int32 if arr.dtype.kind in "iub"
                            else np.float32)
        code = _CODES[base]
        width = base.itemsize * 8
        klass = 1               # DFNTF_IEEE / DFNTI_MBO
        nt = struct.pack(">BBBB", 1, code, width, klass)
        rank = max(arr.ndim, 1)
        dims = arr.shape if arr.ndim else (1,)
        sdd = struct.pack(">H", rank)
        sdd += struct.pack(f">{rank}I", *dims)
        sdd += struct.pack(">HH", DFTAG_NT, ref)           # data NT
        for _ in range(rank):
            sdd += struct.pack(">HH", DFTAG_NT, ref)       # scale NTs
        data = np.ascontiguousarray(arr,
                                    base.newbyteorder(">")).tobytes()
        ndg = (struct.pack(">HH", DFTAG_SDD, ref)
               + struct.pack(">HH", DFTAG_SD, ref))
        dil = (struct.pack(">HH", DFTAG_NDG, ref)
               + name.encode("ascii", "replace") + b"\0")
        dds += [(DFTAG_NT, ref, nt), (DFTAG_SDD, ref, sdd),
                (DFTAG_SD, ref, data), (DFTAG_NDG, ref, ndg),
                (DFTAG_DIL, ref, dil)]

    ndd = len(dds)
    header_len = 4 + 6 + 12 * ndd
    out = bytearray(MAGIC)
    out += struct.pack(">hI", ndd, 0)
    offset = header_len
    table = b""
    payload = bytearray()
    for tag, ref, data in dds:
        table += struct.pack(">HHII", tag, ref, offset, len(data))
        payload += data
        offset += len(data)
    out += table + payload
    with open(path, "wb") as fh:
        fh.write(bytes(out))
