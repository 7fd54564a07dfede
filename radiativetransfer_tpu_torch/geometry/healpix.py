"""HEALPix NESTED-scheme pixel -> direction conversion, vectorized.

Port of the reference's pix2ang_nest / mk_pix2xy / rotateAngles
(equiSources.f90:2118-2361), rewritten as vectorized NumPy
bit arithmetic (no 1024-entry LUT; we de-interleave with magic masks).

Conventions match the reference exactly:
* theta is the ELEVATION above the xy-plane in (-pi/2, pi/2)
  (the reference computes theta = acos(z) - pi/2 ... with its truncated pi,
  equiSources.f90:2205);
* after conversion every direction is rotated by 0.111 rad about x and
  0.222 rad about y (rotateAngles, :2297-2335) to avoid grid-axis alignment.
"""

from __future__ import annotations

import numpy as np

from ..constants import HALF_PI, PI, TWO_PI

# coordinates of the lowest corner of each of the 12 base faces
_JRLL = np.array([2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4], dtype=np.int64)
_JPLL = np.array([1, 3, 5, 7, 0, 2, 4, 6, 1, 3, 5, 7], dtype=np.int64)


def _compress_bits(v: np.ndarray) -> np.ndarray:
    """Extract even-positioned bits of v into the low bits (inverse Morton)."""
    v = v & np.int64(0x5555555555555555)
    v = (v | (v >> 1)) & np.int64(0x3333333333333333)
    v = (v | (v >> 2)) & np.int64(0x0F0F0F0F0F0F0F0F)
    v = (v | (v >> 4)) & np.int64(0x00FF00FF00FF00FF)
    v = (v | (v >> 8)) & np.int64(0x0000FFFF0000FFFF)
    v = (v | (v >> 16)) & np.int64(0x00000000FFFFFFFF)
    return v


def pix2xy_nest(nside: int, ipix: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Face number and in-face (x, y) for NESTED pixels."""
    ipix = np.asarray(ipix, dtype=np.int64)
    npface = np.int64(nside) * np.int64(nside)
    face = ipix // npface
    ipf = ipix % npface
    ix = _compress_bits(ipf)
    iy = _compress_bits(ipf >> 1)
    return face, ix, iy


def pix2ang_nest(nside: int, ipix: np.ndarray, rotate: bool = True
                 ) -> tuple[np.ndarray, np.ndarray]:
    """(phi, theta) of NESTED pixel centers; theta is elevation.

    Matches equiSources.f90:2118-2231 including the final rotateAngles call
    (disable with rotate=False).
    """
    ipix = np.atleast_1d(np.asarray(ipix, dtype=np.int64))
    face, ix, iy = pix2xy_nest(nside, ipix)

    jrt = ix + iy
    jpt = ix - iy
    jr = _JRLL[face] * nside - jrt - 1
    nl4 = 4 * nside

    fact1 = 1.0 / (3.0 * nside * nside)
    fact2 = 2.0 / (3.0 * nside)

    nr = np.full_like(jr, nside)
    z = (2 * nside - jr) * fact2
    kshift = (jr - nside) % 2
    north = jr < nside
    nr = np.where(north, jr, nr)
    z = np.where(north, 1.0 - jr.astype(np.float64) ** 2 * fact1, z)
    kshift = np.where(north, 0, kshift)
    south = jr > 3 * nside
    nr_s = nl4 - jr
    nr = np.where(south, nr_s, nr)
    z = np.where(south, -1.0 + nr_s.astype(np.float64) ** 2 * fact1, z)
    kshift = np.where(south, 0, kshift)

    # NOTE: the reference maps z -> theta as acos(z) - pi/2, which assigns the
    # NORTH pole theta = -pi/2 (equiSources.f90:2205).  This mirrors the
    # pixelization about the equator; it is a valid full-sphere quadrature and
    # we reproduce it exactly for per-pixel parity with the reference.
    theta = np.arccos(z) - HALF_PI

    jp = (_JPLL[face] * nr + jpt + 1 + kshift) // 2
    jp = np.where(jp > nl4, jp - nl4, jp)
    jp = np.where(jp < 1, jp + nl4, jp)
    phi = (jp - (kshift + 1) * 0.5) * HALF_PI / nr

    phi = np.mod(phi, TWO_PI)

    if rotate:
        phi, theta = rotate_angles(phi, theta)
    return phi, theta


def _get_angle(cosphi: np.ndarray, sinphi: np.ndarray) -> np.ndarray:
    """Quadrant-correct phi in [0, 2pi) (getAngle, equiSources.f90:2337-2361)."""
    phi = np.arcsin(np.clip(sinphi, -1.0, 1.0))
    phi = np.where(cosphi > 0.0, np.where(sinphi > 0.0, phi, TWO_PI + phi), PI - phi)
    return phi


def rotate_angles(phi: np.ndarray, theta: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Fixed rotations (0.111 rad about x, 0.222 rad about y) applied to every
    direction (rotateAngles, equiSources.f90:2297-2335)."""
    # rotation around x-axis
    ang = 0.111
    theta1 = np.arcsin(np.clip(
        np.cos(theta) * np.sin(phi) * np.sin(ang) + np.sin(theta) * np.cos(ang),
        -1.0, 1.0))
    cosphi = np.cos(theta) * np.cos(phi) / np.cos(theta1)
    sinphi = (np.cos(theta) * np.sin(phi) * np.cos(ang)
              - np.sin(theta) * np.sin(ang)) / np.cos(theta1)
    phi1 = _get_angle(cosphi, sinphi)

    # rotation around y-axis
    ang = 0.222
    theta2 = np.arcsin(np.clip(
        np.cos(theta1) * np.cos(phi1) * np.sin(ang) + np.sin(theta1) * np.cos(ang),
        -1.0, 1.0))
    cosphi = (np.cos(theta1) * np.cos(phi1) * np.cos(ang)
              - np.sin(theta1) * np.sin(ang)) / np.cos(theta2)
    sinphi = np.cos(theta1) * np.sin(phi1) / np.cos(theta2)
    phi2 = _get_angle(cosphi, sinphi)
    return phi2, theta2


def direction_vectors(phi: np.ndarray, theta: np.ndarray) -> np.ndarray:
    """Unit vectors (..., 3) with components
    (cos(theta)cos(phi), cos(theta)sin(phi), sin(theta)) — the convention of
    the point-source tracer (equiSources.f90:2440-2442)."""
    return np.stack([
        np.cos(theta) * np.cos(phi),
        np.cos(theta) * np.sin(phi),
        np.sin(theta),
    ], axis=-1)


def sweep_directions(n_angular_level: int) -> tuple[np.ndarray, np.ndarray]:
    """All (phi, theta) for the diffuse sweep at the given angular level
    (12 * 4**(L-1) directions; equiSources.f90:1385-1391)."""
    nside = 2 ** (n_angular_level - 1)
    npix = 12 * 4 ** (n_angular_level - 1)
    return pix2ang_nest(nside, np.arange(npix))
