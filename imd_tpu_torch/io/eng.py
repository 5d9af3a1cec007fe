"""Copy of imd_tpu/io/eng.py.

Per-interval .eng metrics file (write_eng_file, imd_io.c:2133/2290).

Columns match the reference's base build: ``time Epot temperature pressure
volume`` plus optional fnorm/PxF (relax builds), eta (NVT), ttm_eng (TTM).
Values: Epot = total potential energy / natoms; temperature = 2 Ekin /
nactive (eV); pressure = (2 Ekin + virial) / (3 V).
"""

from __future__ import annotations

from typing import Optional, Sequence


class EngWriter:
    def __init__(self, path: str, *, relax: bool = False, fnorm: bool = False,
                 nvt: bool = False, ttm: bool = False,
                 extra_cols: Sequence[str] = (), append: bool = False):
        self.path = path
        self.cols = ["time", "Epot", "temperature"]
        if fnorm:
            self.cols += ["fnorm", "fmax"]
        self.cols += ["pressure", "volume"]
        if nvt:
            self.cols += ["eta*tau_eta"]
        if ttm:
            self.cols += ["ttm_eng"]
        self.cols += list(extra_cols)
        # later simulation phases continue the same time series
        # (imd.c:297 runs main_loop per phase into one .eng)
        self._f = open(path, "a" if append else "w")
        if not append:
            self._f.write("# " + " ".join(self.cols) + "\n")
            self._f.flush()

    def write(self, *, time, epot_per_atom, temperature, pressure, volume,
              fnorm=None, fmax=None, eta=None, ttm_eng=None, extra=()):
        vals = [time, epot_per_atom, temperature]
        if "fnorm" in self.cols:
            vals += [fnorm or 0.0, fmax or 0.0]
        vals += [pressure, volume]
        if "eta*tau_eta" in self.cols:
            vals += [eta or 0.0]
        if "ttm_eng" in self.cols:
            vals += [ttm_eng or 0.0]
        vals += list(extra)
        self._f.write(" ".join("%.16e" % float(v) for v in vals) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()
