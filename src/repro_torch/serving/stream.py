"""DeviceStream: the seam isolating the serving engine's device-to-host
sync points.

The engine never moves a device tensor to the host itself; every transfer
goes through its stream, which comes in two flavours:

* :class:`DeviceStream` — the BLOCKING policy (the default).  ``fetch``
  copies at once (counted in ``host_syncs``, so tests can assert that a
  pass moved nothing), ``submit`` delivers a ticket inline and ``sync`` is
  a no-op because nothing is ever in flight.  The simulated clock runs on
  this stream.

* :class:`OverlappedStream` — the wall-clock overlapped policy.  ``submit``
  enqueues a delivery ticket on a BOUNDED queue consumed by one daemon
  worker thread; the bound is the dispatch-ahead depth, so a host that
  outruns delivery blocks on ``submit`` instead of growing an unbounded
  backlog.  The worker resolves each ticket's sampled tokens (it waits on
  the CUDA event recorded behind their copy to pinned host memory, never
  on the whole stream), fires streaming callbacks and finalizes metrics
  while the engine's thread already dispatches the next pass.  ``sync``
  drains the queue.

A worker exception is captured and re-raised on the next ``submit`` /
``sync``, so a failing callback surfaces in the serve loop instead of
dying silently on the daemon thread.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class TokenRec:
    """One slot that sampled a token in a dispatched pass."""
    slot: int
    req: Any                    # serving.engine.Request
    finishing: bool             # this token hits the request's limit
    corrupted: bool = False     # dispatched while an injected fault was
                                # active and unrepaired


@dataclasses.dataclass
class Ticket:
    """One dispatched pass awaiting delivery: its sampled tokens (a host
    tensor that a non-blocking copy fills, and the CUDA event recorded
    behind that copy, None on the CPU), the recipients, the dispatch time
    for the straggler and utilization gauges, the engine clock the tokens
    are stamped with, the pass kind, and the warm-up flag that keeps a
    shape's first execution out of the straggler model."""
    engine: Any                 # serving.engine.ServingEngine
    t0: float                   # host perf-clock at dispatch
    warmup: bool                # first run of this pass shape
    sampled: Any                # (B,) int32 host tensor (or array)
    recs: List[TokenRec]
    now: float                  # engine clock at dispatch
    kind: str = "decode"        # "decode" / "prefill"
    ready: Any = None           # torch.cuda.Event behind the copy, or None


class DeviceStream:
    """Blocking sync policy: transfers happen inline, nothing is ever
    pending.  ``host_syncs`` counts every device-to-host transfer the
    engine made."""

    def __init__(self) -> None:
        self.host_syncs = 0

    def fetch(self, arr, dtype=None) -> np.ndarray:
        """Device -> host transfer (THE sync point)."""
        self.host_syncs += 1
        if isinstance(arr, torch.Tensor):
            arr = arr.detach().cpu().numpy()
        return np.array(arr, dtype=dtype, copy=True)

    def submit(self, ticket: Ticket) -> None:
        ticket.engine._deliver_ticket(ticket)

    def pending(self) -> int:
        return 0

    def sync(self) -> None:
        pass

    def close(self) -> None:
        pass


class OverlappedStream(DeviceStream):
    """Background delivery over a bounded queue (see the module
    docstring).  ``depth`` bounds how many dispatched but undelivered
    passes may wait; the engine's dispatch blocks on ``submit`` past it."""

    def __init__(self, depth: int = 4) -> None:
        super().__init__()
        self._q: "queue.Queue[Optional[Ticket]]" = queue.Queue(
            maxsize=max(1, int(depth)))
        self._exc: Optional[BaseException] = None
        self._closed = False
        self._worker = threading.Thread(
            target=self._run, name="serving-delivery", daemon=True)
        self._worker.start()

    def _run(self) -> None:
        while True:
            ticket = self._q.get()
            if ticket is None:
                self._q.task_done()
                return
            try:
                ticket.engine._deliver_ticket(ticket)
            except BaseException as e:     # surface on the engine thread
                self._exc = e
            finally:
                self._q.task_done()

    def _raise_pending(self) -> None:
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def submit(self, ticket: Ticket) -> None:
        self._raise_pending()
        if self._closed:
            raise RuntimeError("OverlappedStream is closed")
        self._q.put(ticket)

    def pending(self) -> int:
        return int(self._q.unfinished_tasks)

    def sync(self) -> None:
        """Block until every submitted ticket has been delivered."""
        self._q.join()
        self._raise_pending()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._q.put(None)
        self._worker.join(timeout=10.0)
