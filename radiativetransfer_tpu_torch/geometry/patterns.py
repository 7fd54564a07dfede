"""Per-direction slab ray templates for the diffuse sweep.

The reference computes, per direction and per x-slab, a template of up to
three ray segments threading a unit cell (setPattern,
transportRoutinesModule.f90:7-85) and chains templates from
slab to slab (equiSources.f90:1495-1553).  All cells in a slab share the
template — the central memory/compute trick of Razoumov & Cardall 2005.

Here we precompute the whole template chain for all slabs of a direction as
small NumPy arrays ("SlabPatterns"), which the sweep kernel consumes as
per-slab scalars.  Segment naming (canonical sweep orientation; array axes
(slab, j, k)):

* xy segment: enters through the bottom (slab-) face; upwind (i-1, j, k).
* xz segment: enters through the j- face; upwind (i, j-1, k).
* yz segment: enters through the k- face; upwind (i, j, k-1).

Chain structure: the xy segment comes first; when it exits a side face the
template re-enters through the opposite face as the next segment, so a slab
has 1-3 segments in a fixed order and each segment's input is the previous
chain segment's output of the adjacent cell.  The last chain segment exits
the top face and feeds the next slab's xy segment.
"""

from __future__ import annotations

import dataclasses

import numpy as np

SEG_NONE = 0
SEG_XZ = 1   # shifts along axis 1 (j)
SEG_YZ = 2   # shifts along axis 2 (k)

# face-exit tags, matching the reference constants xyEnd=1, yzEnd=2, xzEnd=3
# (definitionsModule.f90:159)
TAG_NONE = 0
TAG_XY = 1
TAG_YZ = 2
TAG_XZ = 3


@dataclasses.dataclass(frozen=True)
class SlabTemplate:
    """Template for one slab of one direction."""
    x0: float
    y0: float
    len_xy: float
    len_xz: float       # 0 when inactive
    len_yz: float       # 0 when inactive
    chain2: int         # SEG_NONE / SEG_XZ / SEG_YZ: second chain segment
    chain3: int         # third chain segment
    n_active: int       # 1..3
    next_x0: float      # entry footpoint of the next slab's xy segment
    next_y0: float
    # which segment exits through each face (patternType %xyTop/%xzTop/%yzTop,
    # definitionsModule.f90:148-150): TAG_XY/TAG_YZ/TAG_XZ or TAG_NONE
    top_xy: int = TAG_NONE
    top_xz: int = TAG_NONE
    top_yz: int = TAG_NONE
    # side-segment entry footpoints (xzRay %x0/%z0, yzRay %y0/%z0) for the
    # AMR cross-level child selection; 0 when inactive
    xz_x0: float = 0.0
    xz_z0: float = 0.0
    yz_y0: float = 0.0
    yz_z0: float = 0.0


def set_pattern(x0: float, y0: float, phi: float, theta: float) -> SlabTemplate:
    """One-slab template; exact port of setPattern
    (transportRoutinesModule.f90:7-85) plus the slab-advance rules
    (equiSources.f90:1507-1528)."""
    sin_t, cos_t = np.sin(theta), np.cos(theta)
    sin_p, cos_p = np.sin(phi), np.cos(phi)

    tmp1 = 1.0 / sin_t
    tmp2 = (1.0 - x0) / (cos_p * cos_t)
    tmp3 = (1.0 - y0) / (sin_p * cos_t)

    if tmp1 < min(tmp2, tmp3):
        # single segment, exits the top directly
        len_xy = tmp1
        nxt_x0 = x0 + cos_p / np.tan(theta)
        nxt_y0 = y0 + sin_p / np.tan(theta)
        return SlabTemplate(x0, y0, len_xy, 0.0, 0.0, SEG_NONE, SEG_NONE, 1,
                            nxt_x0, nxt_y0, TAG_XY, TAG_NONE, TAG_NONE)

    if tmp2 < min(tmp1, tmp3):
        # xy exits the x=1 face -> chain continues as a yz segment
        len_xy = tmp2
        yz_y0 = (1.0 - x0) * np.tan(phi) + y0
        yz_z0 = len_xy * sin_t
        tmpa1 = (1.0 - yz_z0) / sin_t
        tmpa2 = (1.0 - yz_y0) / (sin_p * cos_t)
        if tmpa1 < tmpa2:
            len_yz = tmpa1
            # xyTop = yzEnd: next slab footpoint from the yz segment exit
            nxt_x0 = len_yz * cos_t * cos_p
            nxt_y0 = yz_y0 + len_yz * cos_t * sin_p
            return SlabTemplate(x0, y0, len_xy, 0.0, len_yz, SEG_YZ, SEG_NONE,
                                2, nxt_x0, nxt_y0, TAG_YZ, TAG_NONE, TAG_XY,
                                0.0, 0.0, yz_y0, yz_z0)
        len_yz = tmpa2
        xz_x0 = (1.0 - yz_y0) / np.tan(phi)
        xz_z0 = yz_z0 + tmpa2 * sin_t
        len_xz = (1.0 - xz_z0) / sin_t
        # xyTop = xzEnd
        nxt_x0 = xz_x0 + len_xz * cos_t * cos_p
        nxt_y0 = len_xz * cos_t * sin_p
        return SlabTemplate(x0, y0, len_xy, len_xz, len_yz, SEG_YZ, SEG_XZ, 3,
                            nxt_x0, nxt_y0, TAG_XZ, TAG_YZ, TAG_XY,
                            xz_x0, xz_z0, yz_y0, yz_z0)

    # xy exits the y=1 face -> chain continues as an xz segment
    len_xy = tmp3
    xz_x0 = (1.0 - y0) / np.tan(phi) + x0
    xz_z0 = len_xy * sin_t
    tmpb1 = (1.0 - xz_z0) / sin_t
    tmpb2 = (1.0 - xz_x0) / (cos_p * cos_t)
    if tmpb1 < tmpb2:
        len_xz = tmpb1
        # xyTop = xzEnd
        nxt_x0 = xz_x0 + len_xz * cos_t * cos_p
        nxt_y0 = len_xz * cos_t * sin_p
        return SlabTemplate(x0, y0, len_xy, len_xz, 0.0, SEG_XZ, SEG_NONE, 2,
                            nxt_x0, nxt_y0, TAG_XZ, TAG_XY, TAG_NONE,
                            xz_x0, xz_z0, 0.0, 0.0)
    len_xz = tmpb2
    yz_y0 = (1.0 - xz_x0) * np.tan(phi)
    yz_z0 = xz_z0 + len_xz * sin_t
    len_yz = (1.0 - yz_z0) / sin_t
    # xyTop = yzEnd
    nxt_x0 = len_yz * cos_t * cos_p
    nxt_y0 = yz_y0 + len_yz * cos_t * sin_p
    return SlabTemplate(x0, y0, len_xy, len_xz, len_yz, SEG_XZ, SEG_YZ, 3,
                        nxt_x0, nxt_y0, TAG_YZ, TAG_XY, TAG_XZ,
                        xz_x0, xz_z0, yz_y0, yz_z0)


@dataclasses.dataclass(frozen=True)
class SlabPatterns:
    """Stacked per-slab template arrays for one direction (or a batch).

    All arrays have shape (..., nslab) so that a direction batch can be
    stacked on the leading axis.
    """
    len_xy: np.ndarray
    len_xz: np.ndarray
    len_yz: np.ndarray
    chain2: np.ndarray   # int8: SEG_NONE/SEG_XZ/SEG_YZ
    chain3: np.ndarray
    n_active: np.ndarray

    @property
    def nslab(self) -> int:
        return self.len_xy.shape[-1]


def build_slab_patterns(phi: float, theta: float, nslab: int) -> SlabPatterns:
    """Template chain for all slabs of one direction
    (equiSources.f90:1495-1553; slab 0 starts at footpoint (0.5, 0.5))."""
    x0, y0 = 0.5, 0.5
    tmpl = []
    for _ in range(nslab):
        t = set_pattern(x0, y0, phi, theta)
        tmpl.append(t)
        x0, y0 = t.next_x0, t.next_y0
        if x0 > 1.0 or y0 > 1.0:
            raise ValueError(f"pattern footpoint escaped the unit cell: {x0}, {y0}")
    return SlabPatterns(
        len_xy=np.array([t.len_xy for t in tmpl]),
        len_xz=np.array([t.len_xz for t in tmpl]),
        len_yz=np.array([t.len_yz for t in tmpl]),
        chain2=np.array([t.chain2 for t in tmpl], dtype=np.int8),
        chain3=np.array([t.chain3 for t in tmpl], dtype=np.int8),
        n_active=np.array([t.n_active for t in tmpl], dtype=np.int8),
    )


def stack_patterns(patterns: list[SlabPatterns]) -> SlabPatterns:
    """Stack per-direction patterns into a (ndir, nslab) batch."""
    return SlabPatterns(
        len_xy=np.stack([p.len_xy for p in patterns]),
        len_xz=np.stack([p.len_xz for p in patterns]),
        len_yz=np.stack([p.len_yz for p in patterns]),
        chain2=np.stack([p.chain2 for p in patterns]),
        chain3=np.stack([p.chain3 for p in patterns]),
        n_active=np.stack([p.n_active for p in patterns]),
    )
