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
  * ``ElasticPlan``     — given the surviving chips, the largest valid
    (data, model) mesh (``plan_elastic_mesh``), or one that narrows the
    model axis when it must (``plan_recovery_mesh``, the serving engine's
    shard-drop recovery).  The port serves one card, so its engine takes
    the single-array branch: re-program the array from the clean spare.
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


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    old_shape: tuple
    new_shape: tuple
    lost_hosts: int

    @property
    def changed(self) -> bool:
        return self.old_shape != self.new_shape


def plan_elastic_mesh(chips_available: int, model_parallel: int,
                      old_shape: tuple) -> ElasticPlan:
    """Largest (data, model) mesh under the surviving chip count, holding
    the model axis fixed (the weights' TP layout is the expensive one to
    move)."""
    data = chips_available // model_parallel
    if data < 1:
        raise RuntimeError(
            f"{chips_available} chips cannot hold model_parallel="
            f"{model_parallel}")
    new_shape = (data, model_parallel)
    lost = int((old_shape[0] * old_shape[1] - chips_available))
    return ElasticPlan(tuple(old_shape), new_shape, max(lost, 0))


def plan_recovery_mesh(chips_available: int, model_parallel: int,
                       old_shape: tuple) -> ElasticPlan:
    """``plan_elastic_mesh`` for fault recovery: narrow the model axis
    when the surviving chips cannot hold it (after a shard-drop recovery
    the weights are re-programmed from the clean spare anyway).  Raises
    only when no chip survives."""
    if chips_available < 1:
        raise RuntimeError("no surviving chips to re-mesh onto")
    mp = max(1, min(model_parallel, chips_available))
    return plan_elastic_mesh(chips_available, mp, old_shape)
