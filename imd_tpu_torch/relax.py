"""GLOK/FIRE relaxation and the quasistatic convergence test (port of
imd_tpu/relax.py:34-91, 163-178; update_glok, imd_main_3d.c:1018-1111;
check_relaxed, imd_main_3d.c:1787-1870).

GLOK runs NVE steps at FIRE's adaptive timestep; after each one
``fire_update`` moves every position half a step back and zeroes all
momenta when the step went uphill (P.F < 0, or the kinetic temperature
above ``ekin_threshold``), adapts the timestep (shrink on uphill, grow
after ``minsteps`` downhill steps once ``min_n_pxf`` uphill events were
seen, capped at ``max_timestep``) and steers the momenta toward the
force, p <- (1 - mix) p + mix sqrt(pnorm / fnorm) F (MIX,
imd_integrate.c:367-374).  Every condition is a 0-d device tensor under
``torch.where``: the update reads nothing on the host.  CG relaxation
(``cg_relax``) is not ported.
"""

from __future__ import annotations

import dataclasses

import torch

from imd_tpu_torch import integrate
from imd_tpu_torch.scene import Scene


@dataclasses.dataclass(eq=False)
class FireState:
    """FIRE's carry: 0-d device tensors."""
    timestep: torch.Tensor      # adaptive dt (ADAPTGLOK), the state's dtype
    mix: torch.Tensor           # MIX mixing factor
    glok_int: torch.Tensor      # steps since the last reset (int32)
    n_pxf: torch.Tensor         # uphill-event counter (int32)


@dataclasses.dataclass(frozen=True)
class FireConfig:
    """The glok_* / fire_* knobs."""
    incfac: float = 1.1
    decfac: float = 0.5
    mix0: float = 0.1
    mixdec: float = 0.99
    minsteps: int = 5
    min_n_pxf: int = 1
    max_timestep: float = 0.0
    ekin_threshold: float = 1e30


def fire_init(dt0: float, cfg: FireConfig, dtype=torch.float32,
              device="cpu") -> FireState:
    def z(v, dt):
        return torch.tensor(v, dtype=dt, device=device)
    return FireState(timestep=z(dt0, dtype), mix=z(cfg.mix0, dtype),
                     glok_int=z(0, torch.int32), n_pxf=z(0, torch.int32))


def fire_update(scene: Scene, stats: integrate.StepStats, st: FireState,
                cfg: FireConfig, nactive: float):
    """The post-step GLOK correction and timestep adaptation
    (update_glok); returns (scene', FireState')."""
    dtr = st.timestep.dtype
    ekin = 2.0 * stats.tot_kin_energy / max(nactive, 1.0)
    uphill = (stats.pxf < 0.0) | (ekin > cfg.ekin_threshold)

    # half a step back and the momentum reset on uphill (main_3d.c:
    # 1081-1097)
    zero = torch.zeros((), dtype=scene.pos.dtype, device=scene.pos.device)
    inv_m = torch.where(scene.mask,
                        1.0 / torch.clamp(scene.mass, min=1e-30), zero)
    x_back = scene.pos - 0.5 * st.timestep.to(scene.pos.dtype) \
        * scene.mom * inv_m[..., None]
    mom = torch.where(uphill, zero, scene.mom)
    scene = scene.replace(pos=torch.where(uphill, x_back, scene.pos))

    max_dt = cfg.max_timestep if cfg.max_timestep > 0 else 1e30
    grown = torch.clamp(st.timestep * cfg.incfac, max=max_dt)
    can_grow = (st.n_pxf >= cfg.min_n_pxf) & (st.glok_int > cfg.minsteps)
    dt_new = torch.where(uphill, st.timestep * cfg.decfac,
                         torch.where(can_grow, grown, st.timestep))
    mix_new = torch.where(uphill, torch.full_like(st.mix, cfg.mix0),
                          st.mix * cfg.mixdec)

    # MIX momentum steering (imd_integrate.c:367-374)
    scale = torch.sqrt(stats.pnorm / torch.clamp(stats.fnorm, min=1e-20))
    mix = st.mix.to(scene.mom.dtype)
    mixed = (1.0 - mix) * mom + mix * scale.to(scene.mom.dtype) \
        * scene.force
    m = scene.mask.to(scene.mom.dtype)[..., None]
    scene = scene.replace(mom=torch.where(uphill, mom, mixed) * m)
    up = uphill.to(torch.int32)
    return scene, FireState(
        timestep=dt_new.to(dtr), mix=mix_new.to(dtr),
        glok_int=torch.where(uphill, torch.zeros_like(st.glok_int),
                             st.glok_int + 1),
        n_pxf=st.n_pxf + up)


def check_relaxed(stats: integrate.StepStats, epot, epot_prev,
                  nactive: float, fnorm_threshold: float = 0.0,
                  ekin_threshold: float = 0.0,
                  delta_epot_threshold: float = 0.0) -> torch.Tensor:
    """The quasistatic convergence test (check_relaxed,
    main_3d.c:1787-1870): a 0-d bool tensor, true when any set threshold
    is met."""
    ok = torch.zeros((), dtype=torch.bool, device=stats.fnorm.device)
    n = max(nactive, 1.0)
    if fnorm_threshold > 0:
        ok = ok | (torch.sqrt(stats.fnorm / n) < fnorm_threshold)
    if ekin_threshold > 0:
        ok = ok | (2.0 * stats.tot_kin_energy / n < ekin_threshold)
    if delta_epot_threshold > 0:
        # the energies are host floats: the driver has read them
        ok = ok | (abs(epot - epot_prev) / n < delta_epot_threshold)
    return ok
