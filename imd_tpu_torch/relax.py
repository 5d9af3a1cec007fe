"""GLOK/FIRE relaxation, conjugate-gradient relaxation and the quasistatic
convergence test (port of imd_tpu/relax.py; update_glok,
imd_main_3d.c:1018-1111; cg_step/linmin, imd_cg.c:46-210; check_relaxed,
imd_main_3d.c:1787-1870).

GLOK runs NVE steps at FIRE's adaptive timestep; after each one
``fire_update`` moves every position half a step back and zeroes all
momenta when the step went uphill (P.F < 0, or the kinetic temperature
above ``ekin_threshold``), adapts the timestep (shrink on uphill, grow
after ``minsteps`` downhill steps once ``min_n_pxf`` uphill events were
seen, capped at ``max_timestep``) and steers the momenta toward the
force, p <- (1 - mix) p + mix sqrt(pnorm / fnorm) F (MIX,
imd_integrate.c:367-374).  Every condition is a 0-d device tensor under
``torch.where``: the update reads nothing on the host.

``cg_relax`` runs Polak-Ribiere conjugate gradients with imd_tpu's secant
line search: two force calls an iteration, the probe at ``trial_step`` A
for the fastest atom, the step clamped to ``max_move`` A, steepest descent
every ``restart_every`` iterations and wherever the direction is not
downhill.  beta, alpha and the restarts are ``torch.where`` on 0-d device
tensors as well, so an iteration reads nothing on the host either; its
sums are float64.
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


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b) as a float64 0-d tensor."""
    return torch.sum(a * b, dtype=torch.float64)


def cg_relax(scene: Scene, force_fn, n_steps: int, trial_step: float = 0.02,
             restart_every: int = 50, max_move: float = 0.2):
    """Polak-Ribiere CG with a secant line search (imd_tpu/relax.py:110-160;
    cg_step/linmin, imd_cg.c:46-210): ``n_steps`` iterations of two force
    calls each, after one for the start and before one for the end, with
    ``force_fn(scene)`` -> a result with ``force`` and ``epot``.

    Each iteration takes g = F (live slots), beta = max(g.(g - g_prev) /
    g_prev.g_prev, 0) (0 on every ``restart_every``-th iteration of the
    call, the first included), h = g + beta h, steepest descent where g.h
    <= 0; probes F at s = trial_step / max|h| along h and steps alpha =
    s d0 / (d0 - d1) (s where d0 - d1 vanishes) of the directional
    derivatives d0 = g.h and d1 = F(x + s h).h, clamped to [0, max_move /
    max|h|].  Returns (scene with the last call's force and epot, the
    energies at each iteration's start [n_steps] float64, sum F.F at the
    end)."""
    fm = scene.mask.to(scene.pos.dtype)[..., None]
    g_prev = force_fn(scene).force * fm
    h = torch.zeros_like(g_prev)
    zero = torch.zeros((), dtype=torch.float64, device=g_prev.device)
    epots = []
    for i in range(n_steps):
        res = force_fn(scene)
        g = res.force * fm
        den = torch.clamp(_dot(g_prev, g_prev), min=1e-30)
        beta = torch.clamp(_dot(g, g - g_prev) / den, min=0.0)
        if i % restart_every == 0:
            beta = zero
        h = g + beta.to(g.dtype) * h
        # steepest descent where h is not a descent direction
        d0 = _dot(g, h)
        down = d0 > 0.0
        h = torch.where(down, h, g)
        d0 = torch.where(down, d0, _dot(g, g))
        # the secant step on the directional derivative, probed at a
        # displacement of trial_step A for the fastest atom
        hmax = torch.clamp(h.abs().amax().to(torch.float64), min=1e-30)
        s = trial_step / hmax
        trial = force_fn(scene.replace(pos=scene.pos + s.to(h.dtype) * h))
        d1 = _dot(trial.force * fm, h)
        denom = d0 - d1
        alpha = torch.where(denom.abs() > 1e-30, s * d0 / denom, s)
        # no atom moves more than max_move A in one iteration
        alpha = torch.minimum(torch.clamp(alpha, min=0.0), max_move / hmax)
        scene = scene.replace(pos=scene.pos + alpha.to(h.dtype) * h)
        epots.append(res.epot.sum(dtype=torch.float64))
        g_prev = g
    res = force_fn(scene)
    fnorm = _dot(res.force * res.force, fm)
    return (scene.replace(force=res.force, epot=res.epot),
            torch.stack(epots), fnorm)


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
