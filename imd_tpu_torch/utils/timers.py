"""Copy of imd_tpu/utils/timers.py.

Named wall-clock timers (imd_time.c:34-96; report imd.c:387-401).

The reference keeps a fixed set of timers (total/setup/main/io/input/
integrate/forces) and prints per-section percentages plus the headline
"cpuseconds per step and atom" at the end of every run.  Device work is
asynchronous under PyTorch, so a section that must measure the card ends
in torch.cuda.synchronize(); kernel-level attribution comes from
torch.profiler or CUDA events (phases.CudaPhaseTimer).
"""

from __future__ import annotations

import time
from typing import Dict


class Timers:
    def __init__(self):
        self._acc: Dict[str, float] = {}
        self._t0: Dict[str, float] = {}

    def start(self, name: str):
        self._t0[name] = time.perf_counter()

    def stop(self, name: str) -> float:
        dt = time.perf_counter() - self._t0.pop(name)
        self._acc[name] = self._acc.get(name, 0.0) + dt
        return dt

    class _Section:
        def __init__(self, owner, name):
            self.owner, self.name = owner, name

        def __enter__(self):
            self.owner.start(self.name)

        def __exit__(self, *exc):
            self.owner.stop(self.name)

    def section(self, name: str) -> "_Section":
        return self._Section(self, name)

    def get(self, name: str) -> float:
        return self._acc.get(name, 0.0)

    def report(self, n_atoms: int = 0, n_steps: int = 0,
               total: str = "total") -> str:
        """Reference-style summary (imd.c:387-401): per-section
        percentages and seconds per step and atom + its inverse."""
        tot = self._acc.get(total, sum(self._acc.values()))
        lines = []
        for name, v in sorted(self._acc.items()):
            pct = 100.0 * v / tot if tot > 0 else 0.0
            lines.append(f"  {name:<12s} {v:10.3f} s  ({pct:5.1f} %)")
        if n_atoms and n_steps and tot > 0:
            spsa = tot / (n_atoms * n_steps)
            lines.append(f"  seconds per step and atom: {spsa:.3e} "
                         f"({1.0 / spsa:.3e} atom-steps/s)")
        return "\n".join(lines)
