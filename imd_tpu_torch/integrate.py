"""Maxwell initial momenta and the degree-of-freedom count of the .eng
temperature (port of imd_tpu/integrate.py:718, 797).

The fused hot loop does its own leapfrog (ops/fused_step.py); the
ensembles of the general engine are not part of this slice.
"""

from __future__ import annotations

import torch

from imd_tpu_torch.scene import Scene


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
