"""Fault tolerance and straggler mitigation.

  * ``RestartPolicy``   — crash-loop-aware resume decision: the train
    driver restores the newest valid checkpoint (corrupt ones are skipped
    by ``checkpoint.restore``), with a bounded number of restarts per time
    window.
  * ``StragglerMonitor`` — a trailing median of step (pass) times; a step
    that exceeds ``k`` times it is flagged, and as breaches accumulate the
    escalation goes log -> reslice -> remesh.  The serving engine feeds it
    the host-visible time of every delivered pass except each shape's
    first execution (warm-up and capture are not straggling), and
    ``ServingMetrics.summary()["straggler"]`` reports it; the train driver
    feeds it every step.

Of the JAX package's fault module, elastic re-meshing (``ElasticPlan``,
``plan_elastic_mesh``, ``plan_recovery_mesh``) belongs to the
fault-tolerance slice.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional


@dataclasses.dataclass
class RestartPolicy:
    max_restarts: int = 5
    window_sec: float = 3600.0
    _restarts: List[float] = dataclasses.field(default_factory=list)

    def should_restart(self, now: Optional[float] = None) -> bool:
        """Record a restart at ``now``; False once ``max_restarts`` fall
        inside the window (a crash loop: surface it to an operator)."""
        now = time.monotonic() if now is None else now
        self._restarts = [t for t in self._restarts
                          if now - t < self.window_sec]
        if len(self._restarts) >= self.max_restarts:
            return False
        self._restarts.append(now)
        return True


@dataclasses.dataclass
class StragglerMonitor:
    """Trailing-median step-time model with a k-times deadline."""

    k: float = 3.0
    history: int = 32
    _times: List[float] = dataclasses.field(default_factory=list)
    flagged: int = 0

    def deadline(self) -> Optional[float]:
        if len(self._times) < 5:
            return None
        s = sorted(self._times)
        return self.k * s[len(s) // 2]

    def observe(self, step_time: float) -> bool:
        """Record a step; returns True if it breached the deadline."""
        d = self.deadline()
        breach = d is not None and step_time > d
        self._times.append(step_time)
        self._times = self._times[-self.history:]
        if breach:
            self.flagged += 1
        return breach

    def escalation(self) -> str:
        """log -> reslice -> remesh as breaches accumulate."""
        if self.flagged <= 2:
            return "log"
        if self.flagged <= 5:
            return "reslice"
        return "remesh"
