"""Per-request latency accounting and fleet-level serving metrics.

Timestamps come from the engine clock — simulated ticks by default (each
jitted pass advances ``tick_time``), wall-clock seconds when the engine is
built with ``clock=time.perf_counter``.  All derived latencies are plain
differences, so the unit is whatever the clock counts in.

Per request (``RequestMetrics``):
  * TTFT  — first token time minus arrival (queueing + prefill).
  * TPOT  — mean inter-token time after the first (decode cadence).
  * E2E   — finish minus arrival.
  * queue_delay — admit minus arrival (scheduler wait alone).

Per fleet (``ServingMetrics``):
  * tick utilization — live slots / capacity, sampled every jitted pass.
  * queue depth — arrived-but-unadmitted requests, sampled every pass.
  * percentile summaries (p50/p90/p99 by default) exported as JSON.
  * goodput — finished requests meeting a TTFT SLO, per clock unit.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Union

import numpy as np


@dataclasses.dataclass
class RequestMetrics:
    uid: int
    tenant: str = "default"
    prompt_len: int = 0
    arrival_time: Optional[float] = None
    admit_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    n_tokens: int = 0
    rejected: bool = False
    timed_out: bool = False     # deadline expired (queued or in-flight)
    corrupted: bool = False     # some token was generated while an
                                # injected fault was active and unrepaired
    requeues: int = 0           # times evicted + requeued by fault recovery
    preempts: int = 0           # times evicted under page-pool pressure
    resumes: int = 0            # re-admissions after a preemption
    shed: bool = False          # dropped by admission backpressure (a shed
                                # request is a rejection for conservation)
    retry_after: Optional[float] = None     # backoff hint stamped when shed

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None or self.arrival_time is None:
            return None
        return self.first_token_time - self.arrival_time

    @property
    def tpot(self) -> Optional[float]:
        """Mean time-per-output-token after the first token; None for
        single-token requests (no inter-token gap exists)."""
        if (self.finish_time is None or self.first_token_time is None
                or self.n_tokens < 2):
            return None
        return (self.finish_time - self.first_token_time) / (self.n_tokens - 1)

    @property
    def e2e(self) -> Optional[float]:
        if self.finish_time is None or self.arrival_time is None:
            return None
        return self.finish_time - self.arrival_time

    @property
    def queue_delay(self) -> Optional[float]:
        if self.admit_time is None or self.arrival_time is None:
            return None
        return self.admit_time - self.arrival_time


def percentile_summary(values: Iterable[Optional[float]],
                       percentiles: Sequence[int] = (50, 90, 99)) -> Dict:
    """``{"p50": ..., "p90": ..., "p99": ..., "mean": ..., "n": ...}`` over
    the non-None values (all None when the sample is empty)."""
    xs = [v for v in values if v is not None]
    if not xs:
        return {**{f"p{p}": None for p in percentiles},
                "mean": None, "max": None, "n": 0}
    arr = np.asarray(xs, dtype=np.float64)
    out = {f"p{p}": float(np.percentile(arr, p)) for p in percentiles}
    out["mean"] = float(arr.mean())
    out["max"] = float(arr.max())
    out["n"] = len(xs)
    return out


class ServingMetrics:
    """Event-driven collector the engine feeds; holds one RequestMetrics per
    uid (created lazily, so direct ``try_admit`` users are covered too)."""

    def __init__(self, capacity: Optional[int] = None) -> None:
        self.capacity = capacity
        self.reset()

    #: Optional ``distributed.fault.StragglerMonitor`` the engine wires in;
    #: ``summary()`` surfaces its escalation state when present.
    straggler = None

    def reset(self) -> None:
        self.requests: Dict[int, RequestMetrics] = {}
        self.ticks = 0
        self._utilization: List[float] = []
        self._queue_depth: List[int] = []
        # Paged-pool gauges (engine feeds a PoolStats per tick when paged).
        self._pool_pressure: List[float] = []
        self._pool_occupancy: List[float] = []
        self.pool_last = None       # last PoolStats observed (cumulative
                                    # prefix_hits / cow_copies / evictions)
        self.degraded_ticks = 0
        self.degraded_transitions = 0
        # Fault-tolerance counters (serving.faults / engine recovery).
        self.faults: Dict[str, int] = {
            "injected": 0,
            "injected_stuck_col": 0,
            "injected_scale_drift": 0,
            "injected_shard_drop": 0,
            "detected": 0,
            "cols_remapped": 0,
            "tiles_requantized": 0,
            "reshards": 0,
        }
        # Device-occupancy gauge (wall-clock host perf timestamps, NOT the
        # engine clock): merged union of [dispatch, delivery-done] spans
        # over the active windows the engine was serving in.
        self._device_busy = 0.0
        self._busy_mark: Optional[float] = None    # end of last merged span
        self._active = 0.0
        self._active_since: Optional[float] = None

    # -- event hooks (engine-facing) --------------------------------------
    def _req(self, uid: int) -> RequestMetrics:
        return self.requests.setdefault(uid, RequestMetrics(uid=uid))

    def on_submit(self, uid: int, *, arrival_time: float,
                  tenant: str = "default", prompt_len: int = 0) -> None:
        # A new submission of a uid is a new request: replace any completed
        # record outright so reused uids (fresh workload, same engine) do
        # not inherit stale token timestamps.
        self.requests[uid] = RequestMetrics(
            uid=uid, arrival_time=arrival_time, tenant=tenant,
            prompt_len=prompt_len)

    def on_reject(self, uid: int) -> None:
        self.requests[uid] = RequestMetrics(uid=uid, rejected=True)

    def on_admit(self, uid: int, now: float, *,
                 tenant: Optional[str] = None,
                 prompt_len: Optional[int] = None,
                 arrival_time: Optional[float] = None) -> None:
        r = self.requests.get(uid)
        if r is None or r.finish_time is not None or r.rejected:
            # Direct try_admit() (no submit) with a reused uid: start fresh.
            r = self.requests[uid] = RequestMetrics(uid=uid)
        if r.admit_time is None:
            r.admit_time = now
        if r.preempts > r.resumes:
            # This admission closes an open preemption: the request is
            # back in a slot (recompute resume), so the per-request
            # ``preempts - resumes in {0, 1}`` invariant holds again.
            r.resumes += 1
        if tenant is not None:
            r.tenant = tenant
        if prompt_len is not None:
            r.prompt_len = prompt_len
        if r.arrival_time is None:
            r.arrival_time = now if arrival_time is None else arrival_time

    def on_token(self, uid: int, now: float) -> None:
        r = self._req(uid)
        r.n_tokens += 1
        if r.first_token_time is None:
            r.first_token_time = now

    def on_finish(self, uid: int, now: float) -> None:
        self._req(uid).finish_time = now

    def on_timeout(self, uid: int, now: float) -> None:
        """Deadline expired: the request is cancelled (queued or in-flight),
        never finished — it counts toward conservation as ``timed_out``."""
        self._req(uid).timed_out = True

    def on_corrupted(self, uid: int) -> None:
        """A token was generated while an injected fault was active and
        unrepaired: the request's output cannot be trusted.  Corrupted
        requests still complete (degrade, don't crash) but are excluded
        from SLO goodput by default."""
        self._req(uid).corrupted = True

    def on_requeue(self, uid: int) -> None:
        """Fault recovery evicted this in-flight request and requeued it
        with state reset; its generation restarts from scratch, so the
        token-level timestamps (and any corruption from the discarded
        attempt) are cleared while arrival/admit history is kept."""
        r = self._req(uid)
        r.requeues += 1
        r.first_token_time = None
        r.finish_time = None
        r.n_tokens = 0
        r.corrupted = False

    def on_preempt(self, uid: int, now: float) -> None:
        """The engine evicted this in-flight request under page-pool
        pressure; it keeps every token already streamed (they are valid —
        recompute resumes the identical stream) and waits in the queue."""
        self._req(uid).preempts += 1

    def on_shed(self, uid: int, *, tenant: str = "default",
                retry_after: Optional[float] = None) -> None:
        """Admission backpressure dropped this request at submit: it was
        never queued, counts as rejected for conservation, and carries the
        retry-after hint surfaced to the client."""
        self.requests[uid] = RequestMetrics(
            uid=uid, tenant=tenant, rejected=True, shed=True,
            retry_after=retry_after)

    def on_prefix(self, n_pages: int) -> None:
        """``n_pages`` cached prompt pages attached instead of prefilled
        (the cumulative pool-side counter lives in PoolStats)."""

    def on_cow(self) -> None:
        """One copy-on-write page split (cumulative count in PoolStats)."""

    def on_degraded(self, entered: bool, now: float) -> None:
        self.degraded_transitions += 1

    def on_fault(self, kind: str) -> None:
        self.faults["injected"] += 1
        self.faults[f"injected_{kind}"] += 1

    def on_detected(self, n: int) -> None:
        self.faults["detected"] += int(n)

    def on_repair(self, action: str, n: int = 1) -> None:
        """``action`` in {cols_remapped, tiles_requantized, reshards}."""
        self.faults[action] += int(n)

    def on_device_span(self, start: float, end: float) -> None:
        """One device pass's [dispatch, delivery-done] host-clock span.
        Spans from overlapped passes interleave; busy time is the MERGED
        union (overlap counted once), so ``tick_utilization`` reads 1.0
        when the device never waits on the host between passes."""
        if end <= start:
            return
        if self._busy_mark is None or start >= self._busy_mark:
            self._device_busy += end - start
        elif end > self._busy_mark:
            self._device_busy += end - self._busy_mark
        else:
            return                      # fully inside an earlier span
        self._busy_mark = end

    def window_open(self, t: float) -> None:
        """The engine has work in flight from host-clock time ``t`` (no-op
        while a window is already open).  Idle gaps between windows —
        waiting on arrivals — don't count against device utilization."""
        if self._active_since is None:
            self._active_since = t

    def window_close(self, t: float) -> None:
        """The engine went idle: close the active window."""
        if self._active_since is not None:
            self._active += max(0.0, t - self._active_since)
            self._active_since = None

    def tick_utilization(self) -> Dict:
        """Device-busy over engine-active wall time (see on_device_span).
        A still-open window is closed virtually at the busy mark so a
        mid-run read doesn't count not-yet-delivered host time as idle."""
        active = self._active
        if self._active_since is not None and self._busy_mark is not None:
            active += max(0.0, self._busy_mark - self._active_since)
        value = (self._device_busy / active) if active > 0 else None
        return {
            "device_busy_s": self._device_busy,
            "active_s": active,
            "value": value,
        }

    def on_tick(self, now: float, live: int, capacity: int,
                queue_depth: int, *, pool=None, degraded: bool = False
                ) -> None:
        self.ticks += 1
        self._utilization.append(live / max(1, capacity))
        self._queue_depth.append(queue_depth)
        if pool is not None:
            self._pool_pressure.append(pool.pressure)
            self._pool_occupancy.append(pool.occupancy)
            self.pool_last = pool
        if degraded:
            self.degraded_ticks += 1

    # -- summaries ---------------------------------------------------------
    def finished(self) -> List[RequestMetrics]:
        return [r for r in self.requests.values()
                if r.finish_time is not None]

    def goodput(self, slo_ttft: float,
                duration: Optional[float] = None,
                include_corrupted: bool = False) -> Optional[float]:
        """Requests that finished with TTFT <= ``slo_ttft``, per clock unit.
        ``duration`` defaults to the span from earliest arrival to last
        finish.

        Corrupted requests (tokens generated under an active, unrepaired
        fault) are NOT good output and are excluded by default;
        ``include_corrupted=True`` gives the DEGRADED-MODE goodput — how
        fast the engine pushes requests out regardless of trustworthiness.
        The gap between the two is the cost of serving through faults
        without recovery."""
        fin = self.finished()
        if not fin:
            return None
        if duration is None:
            arrivals = [r.arrival_time for r in fin
                        if r.arrival_time is not None]
            duration = max(r.finish_time for r in fin) - min(arrivals)
        if duration <= 0:
            return None
        good = sum(1 for r in fin
                   if r.ttft is not None and r.ttft <= slo_ttft
                   and (include_corrupted or not r.corrupted))
        return good / duration

    def conservation(self) -> Dict:
        """The invariant every fault OR overload trace must preserve: after
        drain, ``submitted == completed + rejected + timed_out`` — a
        request can be evicted, preempted, and requeued any number of
        times, but it is never lost.  (In-flight/queued requests make the
        identity a ``<=`` mid-run.)

        With preemption the identity extends per request: every preemption
        is closed by exactly one resume or by a timeout —
        ``preempts - resumes in {0, 1}``, and the unresumed case implies
        ``timed_out`` (``preempt_ok``).  Shed requests count as rejected."""
        vals = list(self.requests.values())
        completed = sum(1 for r in vals if r.finish_time is not None)
        rejected = sum(1 for r in vals if r.rejected)
        timed_out = sum(1 for r in vals if r.timed_out)
        preempted = sum(r.preempts for r in vals)
        resumed = sum(r.resumes for r in vals)
        preempt_ok = all(
            r.preempts - r.resumes in (0, 1)
            and (r.preempts == r.resumes or r.timed_out)
            for r in vals)
        return {
            "submitted": len(self.requests),
            "completed": completed,
            "rejected": rejected,
            "timed_out": timed_out,
            "shed": sum(1 for r in vals if r.shed),
            "preempted": preempted,
            "resumed": resumed,
            "preempt_ok": preempt_ok,
            "ok": len(self.requests) == completed + rejected + timed_out,
        }

    def summary(self, percentiles: Sequence[int] = (50, 90, 99)) -> Dict:
        fin = self.finished()
        util = self._utilization
        depth = self._queue_depth
        cons = self.conservation()
        return {
            "requests": {
                "submitted": len(self.requests),
                "finished": len(fin),
                "rejected": cons["rejected"],
                "timed_out": cons["timed_out"],
                "shed": cons["shed"],
                "preempted": cons["preempted"],
                "resumed": cons["resumed"],
                "requeued": sum(1 for r in self.requests.values()
                                if r.requeues > 0),
                "corrupted": sum(1 for r in self.requests.values()
                                 if r.corrupted),
                "conservation_ok": cons["ok"],
                "preempt_ok": cons["preempt_ok"],
            },
            "pool": (None if self.pool_last is None else {
                "num_pages": self.pool_last.num_pages,
                "page_size": self.pool_last.page_size,
                "pressure_mean": float(np.mean(self._pool_pressure)),
                "pressure_max": float(np.max(self._pool_pressure)),
                "occupancy_mean": float(np.mean(self._pool_occupancy)),
                "prefix_hits": self.pool_last.prefix_hits,
                "prefix_evictions": self.pool_last.prefix_evictions,
                "cow_copies": self.pool_last.cow_copies,
                "degraded_ticks": self.degraded_ticks,
                "degraded_transitions": self.degraded_transitions,
            }),
            "faults": dict(self.faults),
            "straggler": (
                None if self.straggler is None else {
                    "escalation": self.straggler.escalation(),
                    "flagged": self.straggler.flagged,
                    "deadline_s": self.straggler.deadline(),
                }),
            "ttft": percentile_summary((r.ttft for r in fin), percentiles),
            "tpot": percentile_summary((r.tpot for r in fin), percentiles),
            "e2e": percentile_summary((r.e2e for r in fin), percentiles),
            "queue_delay": percentile_summary(
                (r.queue_delay for r in fin), percentiles),
            "ticks": self.ticks,
            "tick_utilization": self.tick_utilization(),
            "utilization": {
                "mean": float(np.mean(util)) if util else None,
                "min": float(np.min(util)) if util else None,
            },
            "queue_depth": {
                "mean": float(np.mean(depth)) if depth else None,
                "max": int(np.max(depth)) if depth else 0,
            },
        }

    def to_json(self, path: Optional[Union[str, Path]] = None,
                percentiles: Sequence[int] = (50, 90, 99), **extra) -> str:
        """Serialize ``summary()`` (plus any ``extra`` top-level fields) to
        JSON; write to ``path`` when given."""
        doc = {**self.summary(percentiles), **extra}
        text = json.dumps(doc, indent=2) + "\n"
        if path is not None:
            Path(path).write_text(text)
        return text
