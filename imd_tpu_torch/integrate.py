"""The general step's ensembles, Maxwell initial momenta and the
degree-of-freedom count of the .eng temperature (port of
imd_tpu/integrate.py:27-63, 94, 126, 144-200, 718, 797).

``nve`` is the reference's move_atoms_nve (imd_integrate.c:35): p += dt F,
x += dt p / m, with the time-centred kinetic energy (p_old^2 + p_new^2) /
(4 m) for the .eng.  ``mik``, ``berendsen`` and ``nvt`` are the same
leapfrog with imd_tpu's discretisations of the microconvergence reset,
the Berendsen rescale and the Nose-Hoover friction; GLOK is ``nve`` at
FIRE's timestep followed by relax.fire_update.  Of ``_apply_force_mods``
only viscous friction is ported: the restrictions, FBC, BEND, RIGID and
PDECAY refuse to run in the driver (simulation.UNPORTED).  The sums of
``StepStats`` are float64 scalars on the device (imd_tpu sums in the
state's dtype), as the fused path's observables are, and every scalar
of a thermostat stays a 0-d device tensor: no ensemble reads the host.
The fused hot loop does its own leapfrog (ops/fused_step.py).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from imd_tpu_torch.scene import Scene


@dataclasses.dataclass(eq=False)
class StepStats:
    """Per-step sums of the integrator (float64 device scalars)."""
    tot_kin_energy: torch.Tensor    # time-centred Ekin (eV)
    fnorm: torch.Tensor             # sum F.F
    pnorm: torch.Tensor             # sum p.p
    pxf: torch.Tensor               # sum p.F (GLOK/MIK criterion)
    ekin_new: torch.Tensor          # Ekin of the new momenta


@dataclasses.dataclass(eq=False)
class IntegratorParams:
    """The per-step knobs of the ensembles: floats (the timestep also a
    0-d tensor: FIRE's)."""
    timestep: float
    temperature: float = 0.0        # k_B T (eV) of nvt and ber
    isq_tau_eta: float = 0.0        # 1 / tau_eta^2 (nvt)
    tau_berendsen: float = 0.0      # ber
    viscous_friction: float = 0.0


def _apply_force_mods(scene: Scene, params: IntegratorParams):
    """The masked force with viscous damping F -= p friction / dt
    (imd_integrate.c:201-206); imd_tpu/integrate.py:94."""
    m = scene.mask.to(scene.force.dtype)[..., None]
    F = scene.force
    F = F - scene.mom * (params.viscous_friction / params.timestep) * m
    return F * m


def _finish(scene: Scene, params: IntegratorParams, F, p_new):
    """x += dt p_new / m and the step's sums (imd_tpu/integrate.py:126)."""
    mask = scene.mask
    maskd = mask.to(torch.float64)[..., None]
    inv_m = torch.where(mask, 1.0 / torch.clamp(scene.mass, min=1e-30),
                        torch.zeros_like(scene.mass))
    p_old = scene.mom
    x_new = scene.pos + params.timestep * p_new * inv_m[..., None]
    inv_md = inv_m.double()
    k1 = ((p_old.double() ** 2).sum(-1) * inv_md).sum()
    k2 = ((p_new.double() ** 2).sum(-1) * inv_md).sum()
    Fd, pd = F.double(), p_new.double()
    stats = StepStats(tot_kin_energy=(k1 + k2) / 4.0,
                      fnorm=(Fd * Fd * maskd).sum(),
                      pnorm=(pd * pd * maskd).sum(),
                      pxf=(pd * Fd * maskd).sum(), ekin_new=k2 / 2.0)
    return scene.replace(pos=x_new, mom=p_new), stats


def nve(scene: Scene, params: IntegratorParams):
    """Plain leapfrog NVE (move_atoms_nve, imd_integrate.c:35;
    imd_tpu/integrate.py:144).  Returns (scene', StepStats)."""
    F = _apply_force_mods(scene, params)
    p_new = scene.mom + params.timestep * F
    return _finish(scene, params, F, p_new)


def mik(scene: Scene, params: IntegratorParams):
    """Microconvergence relaxation: the leapfrog with p zeroed for each
    atom whose new momentum points against its force, p.F < 0
    (integrate.c:831; imd_tpu/integrate.py:159)."""
    F = _apply_force_mods(scene, params)
    p_new = scene.mom + params.timestep * F
    pf = (p_new * F).sum(-1, keepdim=True)
    p_new = torch.where(pf < 0.0, torch.zeros_like(p_new), p_new)
    return _finish(scene, params, F, p_new)


# the reference's additive epsilon of the Berendsen ratio (~0.1 K)
BERENDSEN_EPS = 8.6174101569719990e-06


def berendsen(scene: Scene, params: IntegratorParams, nactive: float,
              tot_kin_energy: torch.Tensor):
    """The leapfrog with the Berendsen rescale of Ju Li's variant
    (integrate.c:60-68; imd_tpu/integrate.py:168): p' = (p + dt F) cc with
    cc^2 = 1 - dt / tau ((2 Ekin / nactive + eps) / (T + eps) - 1),
    clipped to [0.5, 2], where Ekin is the PREVIOUS step's time-centred
    kinetic energy (``tot_kin_energy``, a device scalar; 0 at a phase's
    start, as imd_tpu's carry)."""
    eps = BERENDSEN_EPS
    # tau 0 rescales by the clip's bound, as the reference's 1 / 0 = inf
    rate = (params.timestep / params.tau_berendsen if params.tau_berendsen
            else math.inf)
    cc = 1.0 - rate * (
        (2.0 * tot_kin_energy / nactive + eps)
        / (params.temperature + eps) - 1.0)
    cc = torch.sqrt(torch.clamp(cc, 0.5, 2.0)).to(scene.mom.dtype)
    F = _apply_force_mods(scene, params)
    p_new = (scene.mom + params.timestep * F) * cc
    return _finish(scene, params, F, p_new)


def nvt(scene: Scene, params: IntegratorParams, nactive: float,
        eta: torch.Tensor):
    """Nose-Hoover NVT (move_atoms_nvt, integrate.c:1047;
    imd_tpu/integrate.py:184) with the reference's half-implicit friction:
    p' = p (1 - dt eta / 2) / (1 + dt eta / 2) + dt F / (1 + dt eta / 2),
    then eta' = eta + dt isq_tau_eta (T_cur / T - 1) from this step's
    time-centred kinetic energy.  ``eta`` is a 0-d device tensor; returns
    (scene', StepStats, eta')."""
    F = _apply_force_mods(scene, params)
    dt = params.timestep
    reib = 0.5 * dt * eta
    fac1 = ((1.0 - reib) / (1.0 + reib)).to(scene.mom.dtype)
    fac2 = (dt / (1.0 + reib)).to(scene.mom.dtype)
    p_new = scene.mom * fac1 + fac2 * F
    scene2, stats = _finish(scene, params, F, p_new)
    t_cur = 2.0 * stats.tot_kin_energy / max(nactive, 1.0)
    eta_new = eta + dt * params.isq_tau_eta * (
        t_cur / max(float(params.temperature), 1e-30) - 1.0)
    return scene2, stats, eta_new


def maxwell(scene: Scene, temperature: float,
            generator: torch.Generator) -> Scene:
    """Maxwell-Boltzmann momenta at (k_B T) = ``temperature`` (eV).

    Gaussian momenta with variance m*T per component drawn from
    ``generator``, total momentum removed, then rescaled to the exact
    temperature over the active degrees of freedom.  For the same seed
    the numbers differ from imd_tpu's (jax.random); tests inject NumPy
    momenta through make_scene(mom=...) instead."""
    dtype = scene.pos.dtype
    mask = scene.mask.to(dtype)
    g = torch.randn(scene.mom.shape, generator=generator, dtype=dtype,
                    device=generator.device).to(scene.pos.device)
    sigma = torch.sqrt(torch.clamp(scene.mass, min=0.0) * temperature)
    p = g * sigma[..., None] * mask[..., None]
    active = mask[..., None].expand_as(p)
    mass_tot = (scene.mass * mask).sum()
    p_tot = p.sum(dim=(0, 1, 2, 3))
    p = p - (p_tot / torch.clamp(mass_tot, min=1e-30)) \
        * scene.mass[..., None] * active
    inv_m = torch.where(scene.mask, 1.0 / torch.clamp(scene.mass, min=1e-30),
                        torch.zeros((), dtype=dtype, device=scene.pos.device))
    ekin = 0.5 * ((p * p).sum(-1) * inv_m).sum()
    ndof = active.sum()
    t_cur = 2.0 * ekin / torch.clamp(ndof, min=1.0)
    scale = torch.sqrt(temperature / torch.clamp(t_cur, min=1e-30))
    p = p * (scale if temperature > 0 else 0.0)
    return scene.replace(mom=p)


def count_active_dof(scene: Scene) -> float:
    """nactive: 3 per live atom (imd_misc.c); the restricted-motion
    variant belongs to the general engine."""
    return 3.0 * float(scene.mask.sum())
