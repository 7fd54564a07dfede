"""Collisional/recombination rate and cooling tables.

Builds the 5000-bin log-temperature tables used by the chemistry solver.
The fits follow the reference's Enzo-lineage builders:

* collisional rates k1..k19:   coll_rates.f:3-234
* three-body / deuterium / H2: calc_rates.f:321-382
* cooling terms:               calc_rates.f:414-619
* density-dependent H2 CID:    colh2diss.f:3-120

All builders are pure NumPy (float64, run once on host).  Case-B
recombination *cooling* in the reference reads external data files
(`HII-ktbetas.tab`, `cratesHe.res`, calc_rates.f:397-411) that are not
shipped with the reference; when those files are absent we fall back to the
analytic case-B cooling fits of Hui & Gnedin 1997 (MNRAS 292, 27), which the
reference's case-B *rate* fits (coll_rates.f:115-147) are also drawn from.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..constants import (
    CASE_A,
    CASE_B,
    COMPA,
    DLOGTEM,
    NRATEC,
    TEMEND,
    TEMSTART,
)

_TINY = 1.0e-20
_DHUGE_LOG = np.log(1.0e30)


def temperature_grid(nratec: int = NRATEC, temstart: float = TEMSTART,
                     temend: float = TEMEND) -> np.ndarray:
    """Log-spaced temperature grid [K] matching calc_rates.f:249-251, 325."""
    dlogtem = (np.log(temend) - np.log(temstart)) / (nratec - 1)
    return np.exp(np.log(temstart) + np.arange(nratec, dtype=np.float64) * dlogtem)


# ---------------------------------------------------------------------------
# k1..k19 collisional rates (coll_rates.f)
# ---------------------------------------------------------------------------

def _poly_exp(log_t_ev: np.ndarray, coeffs: list[float]) -> np.ndarray:
    """exp(sum_i c_i * log_T_eV**i)."""
    acc = np.zeros_like(log_t_ev)
    for i, c in enumerate(coeffs):
        acc = acc + c * log_t_ev ** i
    return np.exp(acc)


def coll_rates(T: np.ndarray, recombination_type: int = CASE_B) -> dict[str, np.ndarray]:
    """Collisional rates k1..k19 [cm^3/s] on a temperature array [K].

    Vectorized port of the fits in coll_rates.f:62-231.
    """
    T = np.asarray(T, dtype=np.float64)
    T_eV = T / 11605.0
    with np.errstate(divide="ignore"):
        log_T_eV = np.log(T_eV)

    hot = T_eV > 0.8
    k1 = np.where(hot, _poly_exp(np.where(hot, log_T_eV, 0.0), [
        -32.71396786375, 13.53655609057, -5.739328757388, 1.563154982022,
        -0.2877056004391, 0.03482559773736999, -0.00263197617559,
        0.0001119543953861, -2.039149852002e-6]), _TINY)
    k3 = np.where(hot, _poly_exp(np.where(hot, log_T_eV, 0.0), [
        -44.09864886561001, 23.91596563469, -10.75323019821, 3.058038757198,
        -0.5685118909884001, 0.06795391233790001, -0.005009056101857001,
        0.0002067236157507, -3.649161410833e-6]), _TINY)
    k5 = np.where(hot, _poly_exp(np.where(hot, log_T_eV, 0.0), [
        -68.71040990212001, 43.93347632635, -18.48066993568, 4.701626486759002,
        -0.7692466334492, 0.08113042097303, -0.005324020628287001,
        0.0001975705312221, -3.165581065665e-6]), _TINY)

    if recombination_type == CASE_A:
        # HeII -> HeI recombination, Abel et al. 1997 (coll_rates.f:109-113)
        k4_hot = (1.54e-9 * (1.0 + 0.3 / np.exp(np.minimum(8.099328789667 / T_eV, 700.0)))
                  / (np.exp(np.minimum(40.49664394833662 / T_eV, 700.0)) * T_eV ** 1.5)
                  + 3.92e-13 / T_eV ** 0.6353)
        k4 = np.where(hot, k4_hot, 3.92e-13 / T_eV ** 0.6353)
        # HII recombination (coll_rates.f:122-135)
        k2_hot = _poly_exp(log_T_eV, [
            -28.61303380689232, -0.7241125657826851, -0.02026044731984691,
            -0.002380861877349834, -0.0003212605213188796,
            -0.00001421502914054107, 4.989108920299513e-6,
            5.755614137575758e-7, -1.856767039775261e-8,
            -3.071135243196595e-9])
        k2 = np.where(T > 5500.0, k2_hot, k4)
        # HeIII -> HeII recombination (coll_rates.f:143)
        k6 = 3.36e-10 / np.sqrt(T) / (T / 1.0e3) ** 0.2 / (1.0 + (T / 1.0e6) ** 0.7)
    else:
        # case B — Hui & Gnedin 1997 fits (coll_rates.f:115-147)
        tmp = 2.0 * 24.587 * 1.60217646e-12 / (1.3806503e-16 * T)
        k4 = 1.26e-14 * tmp ** 0.750
        tmp = 2.0 * 13.598 * 1.60217646e-12 / (1.3806503e-16 * T)
        k2 = 2.753e-14 * tmp ** 1.500 / (1.0 + (tmp / 2.740) ** 0.407) ** 2.242
        tmp = 2.0 * 54.418 * 1.60217646e-12 / (1.3806503e-16 * T)
        k6 = 2.0 * 2.753e-14 * tmp ** 1.500 / (1.0 + (tmp / 2.740) ** 0.407) ** 2.242

    k7 = 6.77e-15 * T_eV ** 0.8779

    warm01 = T_eV > 0.1
    k8 = np.where(warm01, _poly_exp(np.where(warm01, log_T_eV, 0.0), [
        -20.06913897587003, 0.2289800603272916, 0.03599837721023835,
        -0.004555120027032095, -0.0003105115447124016, 0.0001073294010367247,
        -8.36671960467864e-6, 2.238306228891639e-7]), 1.43e-9)

    k9 = np.where(T > 6.7e3,
                  5.81e-16 * (T / 56200.0) ** (-0.6657 * np.log10(T / 56200.0)),
                  1.85e-23 * T ** 1.8)
    k10 = np.full_like(T, 6.0e-10)

    warm03 = T_eV > 0.3
    k13 = np.where(warm03,
                   1.0670825e-10 * T_eV ** 2.012
                   / (np.exp(np.minimum(4.463 / T_eV, 700.0)) * (1.0 + 0.2472 * T_eV) ** 3.512),
                   _TINY)
    k11 = np.where(warm03, _poly_exp(np.where(warm03, log_T_eV, 0.0), [
        -24.24914687731536, 3.400824447095291, -3.898003964650152,
        2.045587822403071, -0.5416182856220388, 0.0841077503763412,
        -0.007879026154483455, 0.0004138398421504563, -9.36345888928611e-6]),
        _TINY)
    k12 = np.where(warm03, 5.6e-11 * np.exp(-np.minimum(102124.0 / T, 700.0)) * T ** 0.5, _TINY)

    warm004 = T_eV > 0.04
    k14 = np.where(warm004, _poly_exp(np.where(warm004, log_T_eV, 0.0), [
        -18.01849334273, 2.360852208681, -0.2827443061704, 0.01623316639567,
        -0.03365012031362999, 0.01178329782711, -0.001656194699504,
        0.0001068275202678, -2.631285809207e-6]), _TINY)

    k15 = np.where(warm01, _poly_exp(np.where(warm01, log_T_eV, 0.0), [
        -20.37260896533324, 1.139449335841631, -0.1421013521554148,
        0.00846445538663, -0.0014327641212992, 0.0002012250284791,
        0.0000866396324309, -0.00002585009680264, 2.4555011970392e-6,
        -8.06838246118e-8]), 2.56e-9 * T_eV ** 1.78186)

    k16 = 6.5e-9 / np.sqrt(T_eV)
    k17 = np.where(T > 1.0e4,
                   4.0e-4 * T ** (-1.4) * np.exp(-np.minimum(15100.0 / T, 700.0)),
                   1.0e-8 * T ** (-0.4))
    k18 = np.where(T > 617.0, 1.32e-6 * T ** (-0.76), 1.0e-8)
    k19 = 5.0e-7 * np.sqrt(100.0 / T)

    return {f"k{i}": v for i, v in zip(
        range(1, 20),
        [k1, k2, k3, k4, k5, k6, k7, k8, k9, k10, k11, k12, k13, k14, k15,
         k16, k17, k18, k19])}


# ---------------------------------------------------------------------------
# colh2diss: density-dependent H2 collisional dissociation (7 functions)
# ---------------------------------------------------------------------------

def colh2diss(T: np.ndarray) -> np.ndarray:
    """The 7 functions f1..f7 of the density-dependent H2 CID rate.

    Vectorized port of colh2diss.f:3-120; returns array (..., 7).
    """
    T = np.asarray(T, dtype=np.float64)
    y = [0.0, -1.784239e2, -6.842243e1, 4.320243e1, -4.633167e0, 6.970086e1,
         4.087038e4, -2.370570e4, 1.288953e2, -5.391334e1, 5.315517e0,
         -1.973427e1, 1.678095e4, -2.578611e4, 1.482123e1, -4.890915e0,
         4.749030e-1, -1.338283e2, -1.164408e0, 8.227443e-1, 5.864073e-1,
         -2.056313e0]
    valid = (T > 500.0) & (T < 1.0e6)
    Ts = np.where(valid, T, 1000.0)
    tl = np.log10(Ts)
    a = y[1] + y[2] * tl + y[3] * tl ** 2 + y[4] * tl ** 3 + y[5] * np.log10(1.0 + y[6] / Ts)
    a1 = y[7] / Ts
    b = y[8] + y[9] * tl + y[10] * tl ** 2 + y[11] * np.log10(1.0 + y[12] / Ts)
    b1 = y[13] / Ts
    c = y[14] + y[15] * tl + y[16] * tl ** 2 + y[17] / Ts
    c1 = y[18] + c
    d = y[19] + y[20] * np.exp(-Ts / 1850.0) + y[21] * np.exp(-Ts / 440.0)
    out = np.stack([
        np.where(valid, a, _TINY),
        np.where(valid, a - b, _TINY),
        np.where(valid, a1, _TINY),
        np.where(valid, a1 - b1, _TINY),
        np.where(valid, 10.0 ** c, 1.0),
        np.where(valid, 10.0 ** c1, 1.0),
        np.where(valid, d, 0.0),
    ], axis=-1)
    return out


# ---------------------------------------------------------------------------
# Hui & Gnedin 1997 analytic case-B recombination cooling (fallback for the
# reference's external Mellema/Gnedin tables, calc_rates.f:397-411)
# ---------------------------------------------------------------------------

def _hg97_shape(T: np.ndarray, t_ion_ev: float) -> np.ndarray:
    lam = 2.0 * t_ion_ev * 1.60217646e-12 / (1.3806503e-16 * T)
    return lam ** 1.970 / (1.0 + (lam / 2.250) ** 0.376) ** 3.720


def hii_rec_cool_case_b(T: np.ndarray) -> np.ndarray:
    """HII case-B recombination cooling [erg cm^3/s] (Hui & Gnedin 97 eq. A24)."""
    return 3.435e-30 * T * _hg97_shape(T, 13.598)


def heiii_rec_cool_case_b(T: np.ndarray) -> np.ndarray:
    """HeIII case-B recombination cooling [erg cm^3/s].

    Hydrogenic Z=2 scaling consistent with the reference's case-B rate k6
    (coll_rates.f:145-146): twice the HII fit evaluated at the HeIII lambda.
    """
    return 2.0 * 3.435e-30 * T * _hg97_shape(T, 54.418)


def heii_rec_cool_case_b(T: np.ndarray) -> np.ndarray:
    """HeII case-B recombination cooling [erg cm^3/s].

    kB*T per recombination times alpha_B(HeII) from the reference's case-B
    rate fit (coll_rates.f:116-117).
    """
    lam = 2.0 * 24.587 * 1.60217646e-12 / (1.3806503e-16 * T)
    alpha_b = 1.26e-14 * lam ** 0.750
    return 1.3806503e-16 * T * alpha_b


def _load_mellema_table(path: str):
    data = np.loadtxt(path)
    return data[:, 0], data[:, 2]  # log10(T), cooling


def _load_gnedin_table(path: str):
    data = np.loadtxt(path)
    return (np.log10(data[:, 0]), np.log10(data[:, 2]), np.log10(data[:, 4]))


# ---------------------------------------------------------------------------
# full table assembly (calc_rates.f)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChemistryTables:
    """All temperature-indexed rate/cooling tables (each shape (nratec,)).

    Mirrors the global arrays of definitionsModule.f90:245-254.
    """
    T: np.ndarray
    k: dict[str, np.ndarray]          # k1..k19, k22, k50..k56
    k13dd: np.ndarray                 # (nratec, 7)
    ceHI: np.ndarray
    ceHeI: np.ndarray
    ceHeII: np.ndarray
    ciHI: np.ndarray
    ciHeI: np.ndarray
    ciHeIS: np.ndarray
    ciHeII: np.ndarray
    reHII: np.ndarray
    reHeII1: np.ndarray
    reHeII2: np.ndarray
    reHeIII: np.ndarray
    brem: np.ndarray
    lineHI: np.ndarray
    compa: float
    # molecular cooling
    hyd01k: np.ndarray
    h2k01: np.ndarray
    vibh: np.ndarray
    roth: np.ndarray
    rotl: np.ndarray
    gpldl: np.ndarray
    gphdl: np.ndarray
    hdlte: np.ndarray
    hdlow: np.ndarray

    def k16(self) -> np.ndarray:
        """Stacked (nratec, 6) array of k1..k6 for the equilibrium solver."""
        return np.stack([self.k[f"k{i}"] for i in range(1, 7)], axis=-1)


def calc_rates(nratec: int = NRATEC, temstart: float = TEMSTART,
               temend: float = TEMEND, recombination_type: int = CASE_B,
               data_dir: str | None = None) -> ChemistryTables:
    """Build all rate/cooling tables; port of calc_rates.f:3-759.

    data_dir, if given, is searched for the optional case-B cooling tables
    `HII-ktbetas.tab` and `cratesHe.res`; otherwise analytic fallbacks are
    used (see module docstring).
    """
    T = temperature_grid(nratec, temstart, temend)
    k = coll_rates(T, recombination_type)

    # three-body H2 rate (calc_rates.f:357-361)
    k["k22"] = np.where(T <= 300.0,
                        1.3e-32 * (T / 300.0) ** (-0.38),
                        1.3e-32 * (T / 300.0) ** (-1.0))
    # deuterium rates (calc_rates.f:374-380)
    k["k50"] = 1.0e-9 * np.exp(-np.minimum(4.1e1 / T, 700.0))
    k["k51"] = np.full_like(T, 1.0e-9)
    k["k52"] = np.full_like(T, 2.1e-9)
    k["k53"] = 1.0e-9 * np.exp(-np.minimum(4.57e2 / T, 700.0))
    k["k54"] = 7.5e-11 * np.exp(-np.minimum(3.82e3 / T, 700.0))
    k["k55"] = 7.5e-11 * np.exp(-np.minimum(4.24e3 / T, 700.0))
    k["k56"] = 1.5e-9 * (T / 300.0) ** (-0.1)

    k13dd = colh2diss(T)

    def emin(x):
        return np.exp(-np.minimum(x, _DHUGE_LOG))

    sq5 = 1.0 + np.sqrt(T / 1.0e5)
    # collisional excitation cooling (calc_rates.f:423-428)
    ceHI = 7.5e-19 * emin(118348.0 / T) / sq5
    ceHeI = 9.1e-27 * emin(13179.0 / T) * T ** (-0.1687) / sq5
    ceHeII = 5.54e-17 * emin(473638.0 / T) * T ** (-0.397) / sq5
    # collisional ionization cooling (calc_rates.f:446-453)
    ciHeIS = 5.01e-27 * T ** (-0.1687) / sq5 * emin(55338.0 / T)
    ciHI = 2.18e-11 * k["k1"]
    ciHeI = 3.94e-11 * k["k3"]
    ciHeII = 8.72e-11 * k["k5"]

    # recombination cooling
    log10T = np.log10(T)
    if recombination_type == CASE_A:
        reHII = 8.70e-27 * np.sqrt(T) * (T / 1000.0) ** (-0.2) / (1.0 + (T / 1.0e6) ** 0.7)
        reHeII1 = 1.55e-26 * T ** 0.3647
        reHeIII = 3.48e-26 * np.sqrt(T) * (T / 1000.0) ** (-0.2) / (1.0 + (T / 1.0e6) ** 0.7)
    else:
        mellema = os.path.join(data_dir, "HII-ktbetas.tab") if data_dir else None
        gnedin = os.path.join(data_dir, "cratesHe.res") if data_dir else None
        if mellema and os.path.exists(mellema):
            tm, cm = _load_mellema_table(mellema)
            reHII = np.where((log10T < tm[0]) | (log10T > tm[-1]), 0.0,
                             10.0 ** np.interp(log10T, tm, cm))
        else:
            reHII = hii_rec_cool_case_b(T)
        if gnedin and os.path.exists(gnedin):
            tg, c2, c3 = _load_gnedin_table(gnedin)
            inside = (log10T >= tg[0]) & (log10T <= tg[-1])
            reHeII1 = np.where(inside, 10.0 ** np.interp(log10T, tg, c2), 0.0)
            reHeIII = np.where(inside, 10.0 ** np.interp(log10T, tg, c3), 0.0)
        else:
            reHeII1 = heii_rec_cool_case_b(T)
            reHeIII = heiii_rec_cool_case_b(T)
    # HeII dielectronic recombination cooling (calc_rates.f:513-515)
    reHeII2 = 1.24e-13 * T ** (-1.5) * emin(470000.0 / T) * (1.0 + 0.3 * emin(94000.0 / T))

    # Bremsstrahlung (calc_rates.f:527-528)
    brem = 1.43e-27 * np.sqrt(T) * (1.1 + 0.34 * np.exp(-(5.5 - log10T) ** 2 / 3.0))
    # HI line excitation cooling (calc_rates.f:543-544)
    lam = 2.0 * 13.598 * 1.60217646e-12 / (1.3806503e-16 * T)
    lineHI = 7.5e-19 * np.exp(-0.75 * lam / 2.0) / sq5

    # molecular-hydrogen cooling (calc_rates.f:552-612)
    xx = np.log10(T / 1.0e4)
    vibh = 1.1e-18 * emin(6744.0 / T)
    dum = np.where(T > 1635.0,
                   1.0e-12 * np.sqrt(T) * np.exp(-1000.0 / T),
                   1.4e-13 * np.exp((T / 125.0) - (T / 577.0) ** 2))
    hyd01k = dum * emin(8.152e-13 / (1.38e-16 * T))
    dum = 8.152e-13 * (4.2 / (1.38e-16 * (T + 1190.0)) + 1.0 / (1.38e-16 * T))
    h2k01 = 1.45e-12 * np.sqrt(T) * emin(dum)
    rotl = np.where(T > 4031.0,
                    1.38e-22 * np.exp(-9243.0 / T),
                    10.0 ** (-22.9 - 0.553 * xx - 1.148 * xx ** 2))
    roth = np.where(T > 1087.0,
                    3.9e-19 * np.exp(-6118.0 / T),
                    10.0 ** (-19.24 + 0.474 * xx - 1.247 * xx ** 2))
    tm = np.clip(T, 13.0, 1.0e5)
    lt = np.log10(tm)
    gpldl = 10.0 ** (-103.0 + 97.59 * lt - 48.05 * lt ** 2 + 10.80 * lt ** 3 - 0.9032 * lt ** 4)
    t3 = tm / 1000.0
    hdlr = ((9.5e-22 * t3 ** 3.76) / (1.0 + 0.12 * t3 ** 2.1) * np.exp(-(0.13 / t3) ** 3)
            + 3.0e-24 * np.exp(-0.51 / t3))
    hdlv = 7.7e-19 * np.exp(-5.86 / t3) + 1.6e-18 * np.exp(-11.7 / t3)
    gphdl = hdlr + hdlv
    hdlte = 10.0 ** (-35.6998 + 15.35716 * log10T - 5.58513 * log10T ** 2
                     + 0.8561149 * log10T ** 3 - 1.75538e-2 * log10T ** 4)
    hdlow = ((3.0 * (4.4e-12 + 3.6e-13 * T ** 0.77) * np.exp(-128.0 / T) * 128.0
              + (5.0 / 3.0) * (4.1e-12 + 2.1e-13 * T ** 0.92) * np.exp(-255.0 / T) * 255.0)
             * 1.380658e-16 / 1.27)

    return ChemistryTables(
        T=T, k=k, k13dd=k13dd,
        ceHI=ceHI, ceHeI=ceHeI, ceHeII=ceHeII,
        ciHI=ciHI, ciHeI=ciHeI, ciHeIS=ciHeIS, ciHeII=ciHeII,
        reHII=reHII, reHeII1=reHeII1, reHeII2=reHeII2, reHeIII=reHeIII,
        brem=brem, lineHI=lineHI, compa=COMPA,
        hyd01k=hyd01k, h2k01=h2k01, vibh=vibh, roth=roth, rotl=rotl,
        gpldl=gpldl, gphdl=gphdl, hdlte=hdlte, hdlow=hdlow,
    )


def dump_rates(tables: "ChemistryTables", rates_path: str = "rates.out",
               cool_path: str = "cool_rates.out") -> None:
    """Write the rate/cooling tables for offline inspection, matching the
    reference's dumps (calc_rates.f:735-756)."""
    T = tables.T
    with open(cool_path, "w") as fh:
        for i in range(len(T)):
            row = [T[i], tables.ceHI[i], tables.ceHeI[i], tables.ceHeII[i],
                   tables.ciHI[i], tables.ciHeI[i], tables.ciHeIS[i],
                   tables.ciHeII[i], tables.reHII[i], tables.reHeII1[i],
                   tables.reHeII2[i], tables.reHeIII[i], tables.brem[i],
                   tables.compa]
            fh.write(" ".join(f"{v:10.3e}" for v in row) + "\n")
    with open(rates_path, "w") as fh:
        ks = [f"k{j}" for j in list(range(1, 20)) + [22]]
        for i in range(len(T)):
            row = [T[i]] + [tables.k[k][i] for k in ks]
            fh.write(" ".join(f"{v:10.3e}" for v in row) + "\n")


def interp_log_t(table: np.ndarray, logtem, xp=np):
    """Linear interpolation of a rate table in log(T).

    Mirrors the inline lookup at equiSources.f90:3568-3586 and is usable with
    any array module with NumPy's clip/astype API (xp=np by default).
    """
    from ..constants import LOGTEM0, LOGTEM9
    logtem = xp.clip(logtem, LOGTEM0, LOGTEM9)
    pos = (logtem - LOGTEM0) / DLOGTEM
    idx = xp.clip(pos.astype(int), 0, table.shape[0] - 2)
    t1 = LOGTEM0 + idx * DLOGTEM
    frac = (logtem - t1) / DLOGTEM
    return table[idx] + frac * (table[idx + 1] - table[idx])
