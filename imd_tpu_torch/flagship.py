"""The flagship configuration of the port: bench.py's default run.

fcc Al (alat 4.05, ``ncell = round((atoms/4)^(1/3))`` unit cells per axis,
1,000,188 atoms at the default 1e6, every position shifted by +1 A off the
cell boundaries), the analytic Al EAM fitted to degree-12 polynomials,
skin 0.5 with the dense-sweep grid of ``optimize_grid_dims(max_capacity=
32)``, mass 26.9815, dt 0.1, Maxwell momenta at 0.026 eV from a seeded
``torch.Generator``, and the 1-D TTM (FEG EOS, explicit solver,
``fd_nx = max(8, gx // 2)``, ``fd_min_atoms = 8``) with the Lambert-Beer
laser of bench.py, in float32.  With ``ntypes`` > 1 the run is bench.py's
``--ntypes``: types ``index % ntypes`` and the tables tiled to ntypes^2 /
ntypes identical columns, the same physics at the alloy kernels' cost.
Counterpart of ``__graft_entry__._build``
plus ``bench.py:114-258``; it differs in that atoms keep the generator's
order (bench.py re-reads them from a first binning) and the momenta come
from torch's generator, not jax.random.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from imd_tpu_torch.config import LaserConfig, TTMConfig
from imd_tpu_torch.utils.generate import fcc
from imd_tpu_torch import integrate
from imd_tpu_torch.models import ttm as ttm_mod
from imd_tpu_torch.models.eos import FEGEos
from imd_tpu_torch.models.potential import (EAMPotential, analytic_eam,
                                            eam_to_fastpoly, tile_columns)
from imd_tpu_torch.ops.fused_step import make_fused_step, make_fused_ttm_step
from imd_tpu_torch.ops.geometry import (Box, CellGrid, np_dtype,
                                        optimize_grid_dims)
from imd_tpu_torch.phases import StepCounters, no_timer
from imd_tpu_torch.scene import make_scene

ALAT = 4.05
CUTOFF = 5.0
SKIN = 0.5
MASS = 26.9815
TIMESTEP = 0.1
TEMPERATURE = 0.026
SEED = 0                 # of the Maxwell start's torch.Generator
LASER = LaserConfig(rescale_mode=4, sigma_e=0.05, sigma_t=50.0, t_0=100.0,
                    mu=0.01)


@dataclasses.dataclass(eq=False)
class Flagship:
    """A built run: the step function and its carry."""
    n_atoms: int
    grid: CellGrid
    ttm: bool
    step: object
    carry: tuple
    counters: StepCounters
    scene: object            # the template Scene (grid + t=0 state)
    eam: object              # the fastpoly EAM set
    tp: object = None        # TTMParams when ttm

    def run(self, nsteps: int) -> float:
        """Advance ``nsteps`` steps; returns wall seconds, synchronized."""
        t0 = time.perf_counter()
        carry = self.carry
        for _ in range(nsteps):
            carry = self.step(*carry) if self.ttm \
                else (self.step(carry[0])[0],)
        if carry[0].xi.is_cuda:
            torch.cuda.synchronize()
        self.carry = carry
        return time.perf_counter() - t0


def eam_tables(ntypes: int = 1, scales=None, dtype=np.float32):
    """The flagship's analytic Al EAM tables.  For ``ntypes`` > 1 each
    table is tiled to ntypes^2 (pair, rho) / ntypes (embed) columns,
    column k scaled by ``scales`` = (pair, rho, embed)[..][k]; without
    ``scales`` the columns are identical (bench.py --ntypes)."""
    eam = analytic_eam(r_cut=CUTOFF, r0=ALAT / math.sqrt(2.0), E_c=3.39,
                       dtype=dtype)
    if ntypes == 1:
        return eam
    nc = ntypes * ntypes
    pair, rho, embed = scales or ([1.0] * nc, [1.0] * nc, [1.0] * ntypes)
    if (len(pair), len(rho), len(embed)) != (nc, nc, ntypes):
        raise ValueError(f"ntypes {ntypes} takes {nc}, {nc} and {ntypes} "
                         "column scales")
    return EAMPotential(pair=tile_columns(eam.pair, pair),
                        rho=tile_columns(eam.rho, rho),
                        embed=tile_columns(eam.embed, embed))


def build(device="cuda", atoms: int = 1_000_000, ttm: bool = True,
          temperature: float = TEMPERATURE, timer=no_timer,
          ntypes: int = 1) -> Flagship:
    """Build the flagship run on ``device`` (host set-up in NumPy).

    ``temperature`` (eV) of the Maxwell start: at the configured 0.026 eV
    no atom of this lattice moves more than ~0.03 A, so the skin check
    (skin/2 = 0.25 A) never triggers a rebin; a warmed start (0.3 eV)
    rebins every few steps."""
    ncell = max(2, round((atoms / 4) ** (1 / 3)))
    dtype = torch.float32
    dt = np_dtype(dtype)
    pos, _, diag = fcc((ncell, ncell, ncell), ALAT)
    box = Box.create([diag[0], 0, 0], [0, diag[1], 0], [0, 0, diag[2]],
                     dtype=dt)
    eam_run = eam_to_fastpoly(eam_tables(ntypes, dtype=dt), deg=12)
    typ = (np.arange(len(pos), dtype=np.int32) % ntypes if ntypes > 1
           else None)
    # off the exact cell boundaries, as bench.py does
    pos0 = pos.astype(dt) + 1.0
    dims, cap = optimize_grid_dims(box, CUTOFF, SKIN, pos0, dtype=dt,
                                   max_capacity=32)
    grid = CellGrid(box=box, dims=dims, capacity=cap, cutoff=CUTOFF,
                    skin=SKIN)
    scene = make_scene(grid, pos0, type=typ, mass=np.full(len(pos0), MASS),
                       dtype=dtype, device=device)
    if int(scene.overflow):
        raise RuntimeError(f"initial binning overflow {int(scene.overflow)}"
                           f" at capacity {cap}")
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    scene = integrate.maxwell(scene, temperature, gen)
    counters = StepCounters()
    if not ttm:
        step, cl = make_fused_step(scene, eam_run, TIMESTEP, ntypes=ntypes,
                                   timer=timer, counters=counters)
        return Flagship(n_atoms=len(pos0), grid=grid, ttm=False, step=step,
                        carry=(cl,), counters=counters, scene=scene,
                        eam=eam_run)
    tcfg = TTMConfig(enabled=True, fd_nx=max(8, dims[0] // 2),
                     fd_min_atoms=8)
    tp = ttm_mod.make_params(tcfg, box, CUTOFF)
    step, cl = make_fused_ttm_step(scene, eam_run, TIMESTEP, tp,
                                   FEGEos(), LASER, ntypes=ntypes,
                                   timer=timer, counters=counters)
    fdi = torch.full((cl.mass.numel(),), -1, dtype=torch.int32,
                     device=device)
    carry = (cl, ttm_mod.make_grid(tp, dtype, device), fdi, 0)
    return Flagship(n_atoms=len(pos0), grid=grid, ttm=True, step=step,
                    carry=carry, counters=counters, scene=scene,
                    eam=eam_run, tp=tp)
