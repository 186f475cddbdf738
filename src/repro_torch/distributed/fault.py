"""Straggler detection for the serving engine.

``StragglerMonitor`` keeps a trailing median of step (pass) times and
flags a step that exceeds ``k`` times it; as breaches accumulate, its
escalation goes log -> reslice -> remesh.  The serving engine feeds it the
host-visible time of every delivered pass except each shape's first
execution (warm-up and capture are not straggling), and
``ServingMetrics.summary()["straggler"]`` reports it.  Of the JAX
package's fault module (restart policy, elastic re-meshing), only this
class is ported; the rest belongs to the fault-tolerance slice.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional


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
