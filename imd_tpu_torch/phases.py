"""Per-phase timing and the step counters of the fused hot loop.

The step functions take a ``timer`` (a callable giving a context manager
per phase name) and a ``StepCounters``.  ``no_timer`` costs nothing;
``CudaPhaseTimer`` records CUDA events around each phase without
synchronizing and sums the elapsed times when asked.
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict

import torch


@dataclasses.dataclass
class StepCounters:
    """Host-side counts of the data-dependent control flow of a run."""
    steps: int = 0
    host_syncs: int = 0     # device->host reads that stall the stream
    rebins: int = 0         # skin-triggered migration rebins
    cfl_substeps: int = 0   # TTM diffusion substeps summed over steps
    colrad_tries: int = 0   # COLRAD batched backward-Euler tries
    maxwell_steps: int = 0  # FDTD Maxwell steps (the laser on)


def no_timer(name: str):
    return contextlib.nullcontext()


class CudaPhaseTimer:
    """CUDA-event timer: ``with timer("r_pass"): ...`` on the current
    stream; ``totals_ms()`` synchronizes once and sums per phase."""

    def __init__(self):
        self._events = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            stop.record()
            self._events[name].append((start, stop))

    def reset(self) -> None:
        self._events.clear()

    def totals_ms(self) -> dict:
        torch.cuda.synchronize()
        return {k: sum(a.elapsed_time(b) for a, b in v)
                for k, v in self._events.items()}

    def counts(self) -> dict:
        return {k: len(v) for k, v in self._events.items()}
