"""Diagnostics: PDFs, clumping factor, projected maps, cell census.

Ports of the reference's diagnostic modes (SURVEY.md C21):
* gas/stellar density PDFs — mode=2 (equiSources.f90:785-836,
  computeGasPDF :4682-4709)
* clumping factor C = <n^2>/<n>^2 — mode=7 (:661-676, computeClumping
  :4711-4735)
* projected variable maps — mode=3 (:678-731, projectVariableToMap
  :4914-4954)
* cell census — mode=4 (:379-385, 425)

All operate on dense fields, so they reduce to array expressions.
Counterpart of the JAX package's io/diagnostics.py: the same NumPy code,
and neutral_mass_fractions on the state's torch tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..constants import MH, MSUN, PC, PSI

# PDF binning (definitionsModule.f90:64-65)
NPDF = 50
APDF = -8.0
BPDF = 3.0


@dataclasses.dataclass(frozen=True)
class PdfResult:
    bin_centers: np.ndarray
    pdf_gas: np.ndarray
    pdf_star: np.ndarray
    gas_outside: float
    star_outside: int


def density_pdfs(rho: np.ndarray, star_host_rho: np.ndarray | None = None
                 ) -> PdfResult:
    """Volume-weighted gas density PDF and stellar host-cell PDF in
    log10(rho [Msun/pc^3]) (computeGasPDF; binning :4700-4706).  In
    float64 whatever the input: rho / MSUN underflows float32."""
    logrho = np.log10(np.asarray(rho, np.float64) / MSUN * PC ** 3).ravel()
    inside = (logrho > APDF) & (logrho < BPDF)
    idx = ((logrho[inside] - APDF) / (BPDF - APDF) * NPDF).astype(int)
    pdf_gas = np.bincount(idx, minlength=NPDF).astype(np.float64)
    gas_outside = float(np.sum(~inside))

    pdf_star = np.zeros(NPDF)
    star_outside = 0
    if star_host_rho is not None:
        ls = np.log10(np.asarray(star_host_rho, np.float64) / MSUN
                      * PC ** 3)
        ins = (ls > APDF) & (ls < BPDF)
        sidx = ((ls[ins] - APDF) / (BPDF - APDF) * NPDF).astype(int)
        pdf_star = np.bincount(sidx, minlength=NPDF).astype(np.float64)
        star_outside = int(np.sum(~ins))

    centers = (np.arange(NPDF) + 0.5) / NPDF * (BPDF - APDF) + APDF
    return PdfResult(bin_centers=centers, pdf_gas=pdf_gas, pdf_star=pdf_star,
                     gas_outside=gas_outside, star_outside=star_outside)


def clumping_factor(rho: np.ndarray) -> float:
    """C = <nH^2> / <nH>^2, volume-weighted (computeClumping,
    equiSources.f90:4711-4735)."""
    nh = PSI * np.asarray(rho, np.float64) / MH
    return float(np.mean(nh ** 2) / np.mean(nh) ** 2)


def cell_census(levels: np.ndarray | None, shape: tuple[int, ...]) -> dict:
    """Cell counts per refinement level (mode=4 semantics)."""
    if levels is None:
        return {0: int(np.prod(shape))}
    vals, counts = np.unique(np.asarray(levels), return_counts=True)
    return {int(v): int(c) for v, c in zip(vals, counts)}


def project_to_map(field: np.ndarray, weight: np.ndarray, axis: int = 2,
                   zslice: tuple[int, int] | None = None) -> np.ndarray:
    """Mass-weighted projection of a field along an axis
    (projectVariableToMap semantics: accumulate field*weight and normalize
    by the accumulated weight, equiSources.f90:4914-4954)."""
    f = np.asarray(field, np.float64)
    w = np.asarray(weight, np.float64)
    if zslice is not None:
        sl = [slice(None)] * 3
        sl[axis] = slice(*zslice)
        f = f[tuple(sl)]
        w = w[tuple(sl)]
    num = np.sum(f * w, axis=axis)
    den = np.sum(w, axis=axis)
    return num / np.where(den > 0, den, 1.0)


def neutral_mass_fractions(state, cell_volume: float) -> tuple[float, float]:
    """(neutralHydrogenMass, totalHydrogenMass) in Msun (computeMass,
    equiSources.f90:4369-4393).  Summed in float64 on the state's
    device."""
    f64 = torch.float64
    hi = float(torch.sum(state.HI, dtype=f64)) * MH * cell_volume / MSUN
    tot = float(torch.sum(state.nh, dtype=f64)) * MH * cell_volume / MSUN
    return hi, tot
