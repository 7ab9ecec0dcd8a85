"""Cumulative per-phase wall-clock accounting for pipeline drivers.

Counterpart of colmap_tpu/utils/phase_timer.py. The incremental pipeline
keeps one PhaseTimer and, when verbose, logs one summary line of cumulative
seconds per phase (init search, registration, triangulation, local/global
BA, track complete+merge, filtering) at the end of the run (reference
analog: Timer::PrintSeconds around every mapper phase,
controllers/incremental_pipeline.cc). It always accumulates: a perf_counter
read per phase entry costs nothing next to the phases, and callers such as
chip_smoke.py read ``seconds`` and ``calls`` after the run. Phases end on
the host clock; work a phase queued on the card without waiting for it is
counted in the phase that next waits.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict


class PhaseTimer:
    """Accumulates wall seconds + call counts per named phase."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.seconds[name] = self.seconds.get(name, 0.0) + dt
            self.calls[name] = self.calls.get(name, 0) + 1

    def summary(self) -> str:
        parts = [
            f"{k}={self.seconds[k]:.1f}s/{self.calls[k]}x"
            for k in sorted(self.seconds, key=self.seconds.get, reverse=True)
        ]
        return " ".join(parts)

    def report(self):
        if self.seconds:
            from colmap_tpu_torch.utils import logging

            logging.info("[phases] %s", self.summary())
