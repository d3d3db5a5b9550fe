"""Fault-tolerance utilities: the step watchdog (straggler detection).

The counterpart of ``repro.runtime.fault``, the same behaviour.  The
training loop's other guards live elsewhere: preemption (SIGTERM) sets a
flag in ``CheckpointManager.install_preemption_handler`` and the loop makes
an emergency save; a lost run restarts from the latest checkpoint.  The
watchdog keeps an EMA of step wall time and flags outliers; the loop logs
and counts them.
"""
from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class StepWatchdog:
    threshold: float = 2.0        # x EMA considered a straggler step
    decay: float = 0.9
    ema: float | None = None
    straggler_steps: int = 0
    total_steps: int = 0
    _t0: float | None = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> bool:
        """Returns True if this step was a straggler."""
        assert self._t0 is not None, "start() not called"
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.total_steps += 1
        slow = self.ema is not None and dt > self.threshold * self.ema
        if slow:
            self.straggler_steps += 1
        # the EMA excludes straggler samples so one slow step can't mask
        # itself
        if self.ema is None:
            self.ema = dt
        elif not slow:
            self.ema = self.decay * self.ema + (1 - self.decay) * dt
        return slow

    def summary(self) -> dict:
        return {"steps": self.total_steps, "stragglers": self.straggler_steps,
                "ema_step_s": self.ema}
