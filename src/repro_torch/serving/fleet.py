"""Multi-model fleet serving: N single-model lanes on one shared clock.

``ServingEngine(models={name: (params, mcfg[, runner])})`` constructs a
:class:`FleetEngine` (``ServingEngine.__new__`` dispatches) instead of a
single-model engine.  Each entry becomes a **lane**: a full single-model
``ServingEngine`` with its own slot partition, scheduler, metrics, warmed
passes and (when pageable) its own page-pool quota.  The fleet serves the
lanes round-robin on a shared clock, the multi-model analogue of one
analog accelerator board hosting several programmed arrays.  This is the
port's copy of the JAX package's ``serving/fleet.py``.

Partitioning rules
------------------
* ``capacity`` is the TOTAL slot count, split near-equally across lanes;
  ``model_split={name: slots}`` overrides single lanes (every lane gets at
  least one slot).
* ``paged=True`` applies only to lanes whose runner reports ``paged_ok``
  (full-attention decoders).  Recurrent lanes hold fixed-size state: they
  have no page pool and are never preempted under pool pressure.
* ``pool_pages`` is split across the pageable lanes by slot share, the
  remainder on the last one, so one model's long-context burst cannot
  evict another model's pages.

Clock protocol
--------------
``self.now`` is the fleet clock.  Before any lane operation the lane's
clock is synced forward to the fleet clock; after it the fleet clock
absorbs the lane's advance.  When every lane is idle the fleet jumps to
the earliest next arrival across the lanes.

Routing
-------
``Request.model`` names the lane.  With a single lane, unrouted requests
(``model=None``) go to it; with several, routing is mandatory and an
unknown or missing model name raises ``KeyError`` listing the fleet.

Every other keyword (``quant``, ``max_len``, ``faults``, ``device``,
``overlap`` ...) goes to every lane.  With ``overlap=True`` the lanes
share ONE ``OverlappedStream`` (``inflight`` becomes its depth): one
delivery worker and one dispatch-ahead bound for the whole fleet.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.runners import runner_for
from repro_torch.serving.stream import OverlappedStream


def _split_capacity(total: int, names: List[str],
                    overrides: Optional[Dict[str, int]]) -> Dict[str, int]:
    """Near-equal slot split with per-model overrides; every lane >= 1."""
    overrides = dict(overrides or {})
    unknown = set(overrides) - set(names)
    if unknown:
        raise KeyError(f"model_split names unknown models {sorted(unknown)}; "
                       f"fleet serves {sorted(names)}")
    out = {n: int(overrides[n]) for n in names if n in overrides}
    rest = [n for n in names if n not in out]
    budget = total - sum(out.values())
    if rest:
        if budget < len(rest):
            raise ValueError(
                f"capacity {total} leaves {budget} slots for "
                f"{len(rest)} un-split lanes (each needs >= 1)")
        base, extra = divmod(budget, len(rest))
        for i, n in enumerate(rest):
            out[n] = base + (1 if i < extra else 0)
    bad = {n: c for n, c in out.items() if c < 1}
    if bad:
        raise ValueError(f"every lane needs >= 1 slot, got {bad}")
    return out


class FleetEngine(ServingEngine):
    """Multiplexed multi-model serving engine (see the module docstring).

    It does not call ``ServingEngine.__init__``: the fleet owns no model
    state of its own, only the lanes, the shared clock and the routing
    table.
    """

    def __init__(self, params=None, mcfg=None, *, models,
                 capacity: int = 8,
                 model_split: Optional[Dict[str, int]] = None,
                 paged: bool = False,
                 pool_pages: Optional[int] = None,
                 **lane_kwargs):
        if params is not None or mcfg is not None:
            raise TypeError(
                "fleet mode takes models={name: (params, mcfg[, runner])}; "
                "do not also pass positional params/mcfg")
        if not models:
            raise ValueError("models must name at least one lane")
        names = list(models)
        split = _split_capacity(int(capacity), names, model_split)

        resolved = {}
        for name, entry in models.items():
            p, cfg = entry[0], entry[1]
            runner = entry[2] if len(entry) > 2 else runner_for(cfg)
            resolved[name] = (p, cfg, runner)

        pageable = [n for n in names if paged and resolved[n][2].paged_ok]
        pool_split: Dict[str, Optional[int]] = {n: None for n in names}
        if pool_pages is not None and pageable:
            ptotal = sum(split[n] for n in pageable)
            acc = 0
            for i, n in enumerate(pageable):
                if i == len(pageable) - 1:
                    pool_split[n] = int(pool_pages) - acc   # remainder
                else:
                    share = int(pool_pages) * split[n] // ptotal
                    pool_split[n] = max(1, share)
                    acc += pool_split[n]

        # Overlapped fleets share ONE delivery pipeline, so the in-flight
        # depth is bounded fleet-wide rather than per lane.
        self._shared_stream = None
        if lane_kwargs.get("overlap"):
            depth = lane_kwargs.pop("inflight", 4)
            self._shared_stream = OverlappedStream(depth=depth)
            lane_kwargs.setdefault("stream", self._shared_stream)

        self.lanes: Dict[str, ServingEngine] = {}
        for name in names:
            p, cfg, runner = resolved[name]
            self.lanes[name] = ServingEngine(
                p, cfg, runner=runner, capacity=split[name],
                paged=paged and runner.paged_ok,
                pool_pages=pool_split[name],
                **lane_kwargs)
        self.capacity = int(capacity)
        self._clock = lane_kwargs.get("clock")
        self.now = self._clock() if self._clock is not None else 0.0
        self._rr = 0                    # round-robin cursor over lanes

    # -- clock sync -------------------------------------------------------
    def _enter(self, lane: ServingEngine) -> None:
        lane.now = max(lane.now, self.now)

    def _leave(self, lane: ServingEngine) -> None:
        self.now = max(self.now, lane.now)

    def _lane_for(self, req: Request) -> ServingEngine:
        if req.model is None:
            if len(self.lanes) == 1:
                return next(iter(self.lanes.values()))
            raise KeyError(
                f"request {req.uid} has no model routing key; fleet serves "
                f"{sorted(self.lanes)}")
        try:
            return self.lanes[req.model]
        except KeyError:
            raise KeyError(
                f"request {req.uid} routed to unknown model "
                f"{req.model!r}; fleet serves {sorted(self.lanes)}") from None

    @staticmethod
    def _has_work(lane: ServingEngine) -> bool:
        """Work servable NOW: occupied slots, arrived queue entries,
        requests finalized outside a step awaiting a poll, or overlapped
        deliveries not yet handed back."""
        return (any(s is not None for s in lane.slots)
                or lane.scheduler.pending(lane.now) > 0
                or bool(lane._returned)
                or bool(lane._delivered))

    # -- open-loop API ----------------------------------------------------
    def submit(self, req: Request) -> bool:
        lane = self._lane_for(req)
        self._enter(lane)
        ok = lane.submit(req)
        self._leave(lane)
        return ok

    def poll(self) -> List[Request]:
        """One fleet round: one lane's poll, round-robin over the lanes
        with work at the shared clock.  When every lane is idle, wait for
        the shared stream's pending deliveries if there are any, else jump
        the clock to the earliest next arrival (the next poll serves that
        lane)."""
        names = list(self.lanes)
        for lane in self.lanes.values():
            self._enter(lane)
        busy = [n for n in names if self._has_work(self.lanes[n])]
        if not busy:
            if any(l_._stream.pending() for l_ in self.lanes.values()):
                # Everything dispatched, nothing feedable: wait for the
                # shared pipeline to deliver, then hand the tokens back.
                out: List[Request] = []
                for lane in self.lanes.values():
                    lane.sync()
                    out.extend(lane._drain_delivered())
                return out
            nxts = [self.lanes[n].scheduler.next_arrival() for n in names]
            nxts = [t for t in nxts if t is not None]
            if nxts:
                self.now = max(self.now, min(nxts))
            return []
        # Round-robin among busy lanes, resuming after the last-served one.
        order = busy
        for off in range(len(names)):
            cand = names[(self._rr + off) % len(names)]
            if cand in busy:
                order = [cand]
                self._rr = (names.index(cand) + 1) % len(names)
                break
        lane = self.lanes[order[0]]
        self._enter(lane)
        out = lane.poll()
        self._leave(lane)
        return out

    def drain(self) -> List[Request]:
        finished: List[Request] = []
        while any(len(l_.scheduler)
                  or any(s is not None for s in l_.slots)
                  or l_._returned
                  or l_._stream.pending()
                  or l_._delivered
                  for l_ in self.lanes.values()):
            finished.extend(self.poll())
        return finished

    def sync(self) -> None:
        for lane in self.lanes.values():
            lane.sync()

    def close(self) -> None:
        """Shut down the fleet's shared delivery worker (lanes never own
        the stream in fleet mode, so this is the only close point)."""
        if self._shared_stream is not None:
            self._shared_stream.sync()
            self._shared_stream.close()

    def warmup(self) -> None:
        """Warm (on a GPU: capture) every lane's pass shapes."""
        for lane in self.lanes.values():
            lane.warmup()

    # ``run()`` is inherited: submit-all + drain works unchanged because
    # both are overridden here.

    # -- observability ----------------------------------------------------
    @property
    def ticks(self) -> int:
        return sum(l_.ticks for l_ in self.lanes.values())

    @ticks.setter
    def ticks(self, _v):
        raise AttributeError("fleet ticks are derived from lane ticks")

    def summary(self, **kw) -> Dict[str, Dict]:
        return {n: l_.metrics.summary(**kw) for n, l_ in self.lanes.items()}

    def conservation(self) -> Dict[str, Dict]:
        return {n: l_.metrics.conservation() for n, l_ in self.lanes.items()}
