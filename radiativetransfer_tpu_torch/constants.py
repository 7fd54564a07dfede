"""Physical constants for the radiative-transfer framework (PyTorch port).

Values mirror the reference implementation's constant block
(definitionsModule.f90:8-41) so that table builders and
chemistry reproduce the reference physics bit-for-bit in float64.

All values are CGS unless noted.
"""

from __future__ import annotations

import math

# --- mathematical ---------------------------------------------------------
PI = 3.141592654  # reference uses this truncated value (definitionsModule.f90:8)
HALF_PI = 0.5 * PI
TWO_PI = 2.0 * PI
FOUR_PI = 4.0 * PI
QUARTER_PI = 0.25 * PI

# --- fundamental constants (cgs) ------------------------------------------
HP = 6.6260693e-27          # Planck constant [erg s]
KB = 1.3806503e-16          # Boltzmann constant [erg/K]
CLIGHT = 2.99792458e10      # speed of light [cm/s]

# --- time / length units ---------------------------------------------------
YR = 31557600.0             # Julian year [s]
KYR = 1.0e3 * YR
MYR = 1.0e6 * YR
PC = 3.08568025e18          # parsec [cm]
KPC = 1.0e3 * PC
MPC = 1.0e6 * PC
ANGSTROM = 1.0e-8           # [cm]

# --- particle masses -------------------------------------------------------
MP = 1.6726231e-24          # proton mass [g]
MN = 1.67492728e-24         # neutron mass [g]
MH = MP                     # hydrogen mass [g]
MHE = 2.0 * (MP + MN)       # helium mass [g]
MSUN = 1.98892e33           # solar mass [g]

# --- ionization thresholds [eV] -------------------------------------------
HYDROGEN_IONIZATION = 13.598
SINGLE_HELIUM_IONIZATION = 24.587
DOUBLE_HELIUM_IONIZATION = 54.418
NU1 = HYDROGEN_IONIZATION       # band-1 lower edge (HI)
NU2 = SINGLE_HELIUM_IONIZATION  # band-2 lower edge (HeI)
NU3 = DOUBLE_HELIUM_IONIZATION  # band-3 lower edge (HeII)

EV_TO_ERG = 1.60217646e-12
EV = EV_TO_ERG
EV_TO_HZ = EV_TO_ERG / HP

GAMMA_ADIABATIC = 1.6667
NU_ALPHA = 2.466e15         # Lyman-alpha frequency [Hz]

# --- photoionization cross sections at threshold [cm^2] --------------------
# (used to normalize optical-depth channels; equiSources.f90:3180-3182)
SIGMA24_AT_NU1 = 6.3e-18    # HI at 13.598 eV
SIGMA26_AT_NU2 = 7.42e-18   # HeI at 24.587 eV
SIGMA25_AT_NU3 = 1.58e-18   # HeII at 54.418 eV
SIGMA_DUST_AT_NU1 = 5.4116737e-22  # SMC dust at the Lyman limit (equiSources.f90:3189)

# --- composition -----------------------------------------------------------
PSI = 0.76                  # hydrogen mass fraction (definitionsModule.f90:261)

# --- chemistry table configuration (definitionsModule.f90:236-241) ---------
TEMSTART = 1.0              # rate-table start temperature [K]
TEMEND = 1.0e8              # rate-table end temperature [K]
NRATEC = 5000               # number of log-T bins
NFBINS = 400                # number of frequency bins for spectral integrals
FREQUENCY_BIN_WIDTH = 0.02  # Delta log10(eV)

LOGTEM0 = math.log(TEMSTART)
LOGTEM9 = math.log(TEMEND)
DLOGTEM = (math.log(TEMEND) - math.log(TEMSTART)) / (NRATEC - 1)

# --- Compton cooling -------------------------------------------------------
COMPA = 5.65e-36            # calc_rates.f:619
COMP_XRAYA = 0.0
COMP_TEMP = 0.0

# --- 4-D attenuation table (definitionsModule.f90:72-74) -------------------
NDEPTH1 = 10
NDEPTH2 = 10
NDEPTH3 = 10
NDEPTH_DUST = 10
MAX_OPTICAL_DEPTH1 = 10.0
MAX_OPTICAL_DEPTH2 = 10.0
MAX_OPTICAL_DEPTH3 = 10.0
MAX_OPTICAL_DEPTH_DUST = 10.0

# --- recombination cases ---------------------------------------------------
CASE_A = 1
CASE_B = 2

# --- dust handling modes (definitionsModule.f90:87) ------------------------
NO_DUST = 0
COMPLETE_SUBLIMATION = 1
NO_SUBLIMATION = 2

# --- point-source ray splitting (equiSources.f90:9, 304-309) ---------------
MAX_PIXEL_LEVEL = 6
NRMAX = 30
N_RADIUS = 7
OUTPUT_RADII_KPC = (0.1, 0.3, 1.0, 3.0, 10.0, 30.0, 100.0)

# --- emergent-spectrum sampling (definitionsModule.f90:290-292) ------------
NENERGY = 300
LOWER_ENERGY = HYDROGEN_IONIZATION
UPPER_ENERGY = 10.0 * HYDROGEN_IONIZATION

# --- stellar population grid (definitionsModule.f90:267) -------------------
N_METALLICITY = 5
N_SPECTRA = 37
N_WAVELENGTHS = 1221
METALLICITIES = (0.0004, 0.004, 0.008, 0.020, 0.050)  # equiSources.f90:844

# --- UVB power-law slopes (equiSources.f90:61-62) --------------------------
ALPHA_QUASAR = 1.8
ALPHA_STELLAR = 5.0


def rmax_table(n: int = NRMAX) -> list[float]:
    """Ray-splitting radius law, in units of the base-grid cell size.

    rmax(l) = sqrt(3)*(sqrt(0.5*4**(l-1) - 1/12) + 0.5) / 2, the radius at
    which the HEALPix inter-ray spacing at pixel level l exceeds roughly one
    cell size (equiSources.f90:304-309; divided by 2 at :309).
    """
    return [
        math.sqrt(3.0) * (math.sqrt(0.5 * 4.0 ** (l - 1) - 1.0 / 12.0) + 0.5) / 2.0
        for l in range(1, n + 1)
    ]
