"""Pluggable admission schedulers for the continuous-batching engine.

A scheduler owns the waiting queue between ``ServingEngine.submit()`` and
slot admission.  Every ``poll()`` the engine asks ``pop(now)`` for the next
request to admit; only requests that have *arrived* (``arrival_time <=
now``) are eligible, so the same scheduler drives both the simulated-clock
open-loop path (deterministic tests, trace replay) and wall-clock serving.

Policies decide admission ORDER; the queue itself is preemption-AWARE:
the paged engine requeues preempted requests here (``requeue`` preserves
arrival order, so a victim re-admits ahead of younger traffic), peeks the
head under an admissibility filter for priority page claims, and can
``remove`` a specific request it is about to admit by preempting a victim.
``pop``/``peek`` accept an optional ``admissible`` predicate — requests
failing it (per-tenant page quota, pool exhaustion) are SKIPPED, not
dequeued, so a blocked tenant never head-of-line blocks the rest.

  * ``fcfs``      — first-come-first-served on (arrival_time, submit order).
  * ``sjf``       — shortest-prompt-first among arrived requests (minimizes
                    mean TTFT under prefill-dominated load; starvation-free
                    only under finite workloads).
  * ``priority``  — highest ``Request.priority`` first; WITHIN a priority
                    class, tenants round-robin on fewest-admissions-so-far,
                    so one tenant flooding the queue cannot starve another
                    at the same priority (per-tenant fairness under
                    saturation).

Queues here are small (hundreds at most) and admission happens at most
``capacity`` times per tick, so the linear-scan ``pop`` is deliberate —
an indexed heap would buy nothing and cost the invariant clarity.
"""

from __future__ import annotations

import abc
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple, Union

if TYPE_CHECKING:  # pragma: no cover - import cycle guard, typing only
    from repro_torch.serving.engine import Request


class Scheduler(abc.ABC):
    """Base queue: stable submit order plus a policy-defined sort key."""

    name = "base"

    def __init__(self) -> None:
        self._queue: List["Request"] = []
        self._order: Dict[int, int] = {}    # id(req) -> submit sequence
        self._seq = 0

    def add(self, req: "Request") -> None:
        self._order[id(req)] = self._seq
        self._seq += 1
        self._queue.append(req)

    def __len__(self) -> int:
        return len(self._queue)

    def pending(self, now: float) -> int:
        """Queued requests that have arrived by ``now`` (queue depth)."""
        return sum(1 for r in self._queue if r.arrival_time <= now)

    def next_arrival(self) -> Optional[float]:
        """Earliest arrival among queued requests (for idle clock jumps)."""
        return min((r.arrival_time for r in self._queue), default=None)

    def requeue(self, req: "Request") -> None:
        """Re-add an in-flight request evicted by fault recovery (its slot
        state died with a shard).  ``arrival_time`` is preserved, so
        arrival-ordered policies re-admit it ahead of younger traffic —
        a recovered request never goes to the back of the line."""
        self.add(req)

    def expire(self, now: float) -> List["Request"]:
        """Remove and return queued requests whose deadline has passed —
        they will never be admitted, so the engine marks them timed out
        instead of letting them rot in the queue."""
        out = [r for r in self._queue
               if getattr(r, "deadline", None) is not None
               and r.deadline <= now]
        for r in out:
            self._queue.remove(r)
            self._order.pop(id(r))
        return out

    def _arrived(self, now: float, admissible=None) -> List["Request"]:
        out = [r for r in self._queue if r.arrival_time <= now]
        if admissible is not None:
            out = [r for r in out if admissible(r)]
        return out

    def peek(self, now: float, admissible=None) -> Optional["Request"]:
        """The request ``pop`` would return, without removing it — the
        engine's priority-claim path peeks before deciding to preempt."""
        arrived = self._arrived(now, admissible)
        return min(arrived, key=self._key) if arrived else None

    def pop(self, now: float, admissible=None) -> Optional["Request"]:
        """Remove and return the next request to admit, or None if nothing
        has arrived by ``now`` (or nothing passes ``admissible``)."""
        arrived = self._arrived(now, admissible)
        if not arrived:
            return None
        req = min(arrived, key=self._key)
        self.remove(req)
        return req

    def remove(self, req: "Request") -> None:
        """Dequeue a specific request the engine is admitting out-of-band
        (priority claim after preempting a victim); fires ``_on_pop`` so
        per-tenant fairness accounting stays consistent."""
        self._queue.remove(req)
        self._order.pop(id(req))
        self._on_pop(req)

    def _on_pop(self, req: "Request") -> None:
        """Policy hook: called after ``req`` is chosen for admission."""

    @abc.abstractmethod
    def _key(self, req: "Request") -> Tuple:
        """Sort key over arrived requests; the minimum is admitted next."""


class FCFSScheduler(Scheduler):
    name = "fcfs"

    def _key(self, req: "Request") -> Tuple:
        return (req.arrival_time, self._order[id(req)])


class ShortestPromptFirst(Scheduler):
    name = "sjf"

    def _key(self, req: "Request") -> Tuple:
        return (len(req.prompt), req.arrival_time, self._order[id(req)])


class PriorityScheduler(Scheduler):
    """Strict priority between classes, tenant-fair within a class."""

    name = "priority"

    def __init__(self) -> None:
        super().__init__()
        self._tenant_admits: Dict[str, int] = {}

    def _key(self, req: "Request") -> Tuple:
        return (-req.priority,
                self._tenant_admits.get(req.tenant, 0),
                req.arrival_time,
                self._order[id(req)])

    def _on_pop(self, req: "Request") -> None:
        self._tenant_admits[req.tenant] = (
            self._tenant_admits.get(req.tenant, 0) + 1)


POLICIES = {
    FCFSScheduler.name: FCFSScheduler,
    ShortestPromptFirst.name: ShortestPromptFirst,
    PriorityScheduler.name: PriorityScheduler,
}


def get_scheduler(policy: Union[str, Scheduler]) -> Scheduler:
    """Resolve a policy name (``fcfs`` / ``sjf`` / ``priority``) or pass an
    already-constructed Scheduler through."""
    if isinstance(policy, Scheduler):
        return policy
    try:
        return POLICIES[policy]()
    except KeyError:
        raise ValueError(
            f"unknown scheduling policy {policy!r}; "
            f"expected one of {sorted(POLICIES)}") from None
