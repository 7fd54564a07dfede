"""Stellar source ingestion: read, localize, age-filter, deduplicate.

Counterpart of the JAX package's io/sources_io.py, NumPy throughout (the
same code); the result is the port's core.rays.SourceBatch.  The
reference's source pipeline (equiSources.f90:733-783,
1169-1224): read star particles (level, x, y, z, age[Myr]); normalize into
box coordinates; apply the upper age cut; merge particles sharing a host
cell into a single weighted source (the heapsort+scan dedup,
utilities.f90:11-53, becomes a NumPy unique over flat cell indices).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import MYR
from ..core.rays import SourceBatch


@dataclasses.dataclass
class StarList:
    """Raw particles before dedup."""
    position: np.ndarray   # (S, 3) box units [0,1)
    age: np.ndarray        # (S,) [s]
    level: np.ndarray      # (S,) declared refinement level (informational)


def read_star_file(path: str, box_lo: np.ndarray, box_hi: np.ndarray) -> StarList:
    """Read the reference's source list format: `level x y z age_Myr` rows
    (equiSources.f90:744-749); positions in the grid's kpc frame."""
    data = np.loadtxt(path, ndmin=2)
    level = data[:, 0].astype(int)
    pos = (data[:, 1:4] - box_lo) / (box_hi - box_lo)
    age = data[:, 4] * MYR
    return StarList(position=pos, age=age, level=level)


def prepare_sources(stars: StarList, n: int, upper_age_limit: float,
                    abun2: np.ndarray | None = None,
                    metal_bucket_edges: np.ndarray | None = None,
                    refined: np.ndarray | None = None
                    ) -> tuple[SourceBatch, np.ndarray, int]:
    """Age-filter, host-cell localize, and merge degenerate particles.

    Sources are placed at their FINEST-LEAF CENTERS (the reference descends
    to the star's leaf and launches rays from startingPoint=(0.5,0.5,0.5)
    in that cell's units, equiSources.f90:753-758, 1272-1280).  With a
    two-level `refined` bitmap, stars in refined base cells localize to
    their fine leaf.

    Returns (SourceBatch, host_cell_index (S,3) at base level,
    n_stars_specific_age).  table_idx buckets sources by host-cell
    metallicity when metal_bucket_edges is given (the TPU analog of the
    per-source stellarBetaTable rebuild: sources sharing a bucket share a
    table).
    """
    young = stars.age <= upper_age_limit
    n_young = int(np.sum(young))
    pos = stars.position[young]
    cell = np.clip((pos * n).astype(np.int64), 0, n - 1)
    if refined is not None:
        # dedup by finest leaf: fine cells inside refined parents
        refined = np.asarray(refined, bool)
        in_fine = refined[cell[:, 0], cell[:, 1], cell[:, 2]]
        n2 = 2 * n
        fcell = np.clip((pos * n2).astype(np.int64), 0, n2 - 1)
        # unique key: base leaves get even fine indices via 2*cell; tag the
        # level in the high bit of the key
        key = np.where(
            in_fine,
            ((fcell[:, 0] * n2 + fcell[:, 1]) * n2 + fcell[:, 2]) + n ** 3,
            (cell[:, 0] * n + cell[:, 1]) * n + cell[:, 2])
        uniq, counts = np.unique(key, return_counts=True)
        is_fine_u = uniq >= n ** 3
        centers = np.empty((len(uniq), 3))
        host = np.empty((len(uniq), 3), np.int64)
        fu = uniq - n ** 3
        fidx = np.stack([fu // (n2 * n2), (fu // n2) % n2, fu % n2], axis=1)
        bidx = np.stack([uniq // (n * n), (uniq // n) % n, uniq % n], axis=1)
        centers = np.where(is_fine_u[:, None], (fidx + 0.5) / n2,
                           (bidx + 0.5) / n)
        host = np.where(is_fine_u[:, None], fidx >> 1, bidx)
        if metal_bucket_edges is not None and abun2 is not None:
            z = abun2[host[:, 0], host[:, 1], host[:, 2]]
            tidx = np.clip(np.searchsorted(metal_bucket_edges, z) - 1, 0,
                           len(metal_bucket_edges) - 2).astype(np.int32)
        else:
            tidx = np.zeros(len(uniq), np.int32)
        batch = SourceBatch(position=centers.astype(np.float64),
                            weight=counts.astype(np.float64),
                            table_idx=tidx)
        return batch, host, n_young

    flat = (cell[:, 0] * n + cell[:, 1]) * n + cell[:, 2]

    uniq, inverse, counts = np.unique(flat, return_inverse=True,
                                      return_counts=True)
    host = np.stack([uniq // (n * n), (uniq // n) % n, uniq % n], axis=1)
    centers = (host + 0.5) / n

    if metal_bucket_edges is not None and abun2 is not None:
        z = abun2[host[:, 0], host[:, 1], host[:, 2]]
        tidx = np.clip(np.searchsorted(metal_bucket_edges, z) - 1, 0,
                       len(metal_bucket_edges) - 2).astype(np.int32)
    else:
        tidx = np.zeros(len(uniq), np.int32)

    batch = SourceBatch(position=centers.astype(np.float64),
                        weight=counts.astype(np.float64),
                        table_idx=tidx)
    return batch, host, n_young
