"""Copy of imd_tpu/units.py, so the port never imports the JAX package.

IMD internal units and physical constants.

The reference (and therefore this framework, for file compatibility) works
in "IMD units" (see reference manual §4 and globals.h:1190-1196):

- length:  Angstrom
- energy:  eV
- mass:    amu
- time:    sqrt(amu * A^2 / eV) = 10.1805057 fs   (one internal time unit)
- temperature: measured in eV (k_B folded into T, i.e. k_B == 1)
- momentum: amu * A / time-unit
"""

import math

# --- base conversions -------------------------------------------------------
EV_TO_J = 1.602176634e-19           # 1 eV in J      (reference globals.h J2eV)
J_TO_EV = 1.0 / EV_TO_J
AMU_TO_KG = 1.66053906660e-27       # 1 amu in kg
ANGSTROM_TO_M = 1.0e-10

# one IMD time unit in seconds: sqrt(amu A^2 / eV)
TIME_UNIT_S = math.sqrt(AMU_TO_KG * ANGSTROM_TO_M**2 / EV_TO_J)  # ~1.018e-14 s
TIME_UNIT_FS = TIME_UNIT_S * 1.0e15                              # ~10.18 fs
# The reference hard-codes 10.18 fs in unit conversions (imd_ttm.c:117,
# imd_tmm.c:137); we use the same rounded value wherever we convert
# to/from SI to stay numerically compatible.
IMD_TIME_FS = 10.18
IMD_TIME_S = IMD_TIME_FS * 1.0e-15

# --- physical constants (SI) ------------------------------------------------
KB_J = 1.380649e-23                 # Boltzmann, J/K
KB_EV = KB_J * J_TO_EV              # eV/K (~8.617e-5)
HBAR_J = 1.054571817e-34            # J s
HBAR_EV = HBAR_J * J_TO_EV          # eV s
EMASS_KG = 9.1093837015e-31         # electron mass, kg
ECHARGE_C = 1.602176634e-19         # elementary charge, C
EPS0 = 8.8541878128e-12             # vacuum permittivity, F/m
C_SI = 299792458.0                  # speed of light, m/s
BOHR_A = 0.529177210903             # Bohr radius in Angstrom
RYD_EV = 13.605693122994            # Rydberg in eV

# density conversion used by the reference wide-range models
# (globals.h "densSI"): IMD mass density (amu/A^3) -> kg/m^3
DENS_IMD_TO_SI = AMU_TO_KG / ANGSTROM_TO_M**3   # ~1660.54

# temperature: IMD temperature is k_B T in eV
EV_TO_K = 1.0 / KB_EV               # 1 eV of temperature in kelvin (~11604.5 K)
K_TO_EV = KB_EV
