"""imd_tpu_torch — the PyTorch/CUDA port of imd_tpu's fused EAM+TTM path.

The JAX package ``imd_tpu`` stays the reference.  This package mirrors its
module names (``simulation.py``, ``ops/forces_win.py``,
``ops/forces_pallas.py``, ``ops/rebin_cl.py``, ``ops/fused_step.py``,
``models/ttm.py`` ...) so each counterpart is easy to find, and runs the
same numerics with plain torch ops plus hand-written CUDA kernels for
Hopper (``csrc/*.cu``):

- ``eam_rho`` and ``eam_force`` (``ops/forces_win.py``): the EAM host-density
  and force passes over the 27-cell stencil of the cells-last layout;
- ``eam_rho_e`` and ``eam_force_s`` (``ops/forces_pallas.py``): the same
  passes with the per-atom energy and stress of the .eng observables;
- ``compact`` (``ops/rebin_cl.py``): the per-cell slot compaction of the
  sort-free migration rebin.

Each kernel has a plain torch version with the same contract beside it.  A
wrapper takes the plain version only for tensors on the CPU; on a CUDA
tensor it launches the kernel or raises.

Entry points: ``python -m imd_tpu_torch -p params.imd`` (the param-file
driver, ``simulation.py``) and ``flagship.build`` (bench.py's default run).

This package never imports jax or any module of ``imd_tpu``: the
framework-free modules it needs (``config``, ``units``, ``utils/generate``,
``utils/timers``, ``io/eng``) are copies.
"""

__version__ = "0.1.0"
