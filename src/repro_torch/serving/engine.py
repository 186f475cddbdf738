"""Batched serving engine core: continuous batching with chunked prefill,
arrival-driven admission and streaming, on the simulated clock.

Tick model
----------
The engine owns one batched decode state of ``capacity`` slots.  Every
``step()`` advances the batch by ONE pass, which is either:

  * a **decode tick** (``decode_step``) — every live slot advances by one
    token at matmul shapes M = capacity, or
  * a **prefill pass** (``models.prefill``) — taken whenever a live slot
    still has unconsumed prompt.  Each prefilling slot contributes its next
    prompt chunk (up to the largest bucket) and each decoding slot rides
    along with its single next token, so admission never stalls generation.

Chunk lengths come from the static set ``prefill_chunks``: a pass is
padded up to the smallest bucket that fits and per-slot padding is masked
through ``n_tokens``.

Open-loop serving
-----------------
``submit()`` enqueues a request with an ``arrival_time`` (default: the
engine clock now); ``poll()`` admits every arrived request the scheduling
policy picks (``serving.scheduler``: fcfs / sjf / priority), runs one
``step()`` and returns the requests that finished.  The clock is SIMULATED
by default — each pass advances ``tick_time`` — so runs are deterministic;
``clock=time.perf_counter`` gives wall-clock serving.  ``run()`` submits a
static workload and drains it.

Per-request TTFT/TPOT/E2E and queue depth are recorded in
``engine.metrics`` (``serving.metrics.ServingMetrics``); each generated
token is streamed to ``Request.on_token`` as it is sampled.

Numerics
--------
``QuantConfig.mode`` picks ``float``, ``abfp_kernel`` (no packing: every
pass through the unpacked ABFP kernel, which quantizes each weight inside
the call), ``abfp_packed`` (every dense weight packed once at engine init,
every pass through the packed ABFP kernel) or
``abfp_fused`` (packs with per-tile ADC gains; decode ticks run the fused
QKV and int8-KV attention kernels).  The kernels run on the engine's
device: the CUDA kernels on a GPU, their plain versions on the CPU.

Sampling: temperature 0 decodes greedily (argmax, first occurrence on
ties).  The blocking engine fetches each pass's logits and samples
temperature rows on the host from a stream seeded by (engine seed,
request uid, token index); the overlapped engine samples on the device
(``models.sample_tokens``: JAX's Gumbel-max draw from the key
``fold_in(fold_in(PRNGKey(seed), uid), token index)``).

Warmed passes
-------------
Each pass shape, ``("decode",)`` or ``("prefill", bucket)``, has static
buffers (``serving.runners.PassIO``) and, on a GPU, is captured ONCE into
a CUDA graph (``_executable``: after a warm-up run on a side stream and on
a scratch copy of the state, so the served state is untouched); every
later pass of that shape is a replay.  ``warmup()`` captures them all up
front.  An overlapped pass in which some row samples at a temperature
runs its shape's ``"draw"`` variant (the device Gumbel draw, captured at
first use); a greedy one skips the draw.  A capture or replay that fails
raises: there is no eager fallback.  Each pass's noise seeds live in its seed table, filled by the
pass's one host-to-device copy, so every replay draws fresh noise.  A
replay adds to ``kernels.ops.launch_counts()`` the launches its capture
recorded.  On the CPU passes run eagerly through the same code.

Overlapped runtime
------------------
``overlap=True`` (wall clock only) dispatches ahead: the host tracks token
COUNTS (``Request.dispatched``), the next pass's input rows take the
previous pass's device sample (a device-to-device copy), and each pass's
sampled tokens go to a ring of pinned host buffers with a CUDA event
behind the copy; a ``serving.stream.OverlappedStream`` worker waits on
that event, appends the tokens, fires callbacks and finalizes metrics
while the next pass runs.  ``inflight`` bounds the passes dispatched but
not delivered.  ``sync()`` waits for them, ``close()`` stops the worker.

Gauges: every delivered pass's [dispatch, delivery] span feeds
``metrics.tick_utilization()``, and every one but a shape's first feeds
the ``straggler`` monitor (``distributed.fault.StragglerMonitor``).

Not ported (each raises when asked for): paged KV and preemption, fault
injection, meshes, fleets and deadlines.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng
from repro_torch.core.abfp import QuantConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.distributed.fault import StragglerMonitor
from repro_torch.kernels import ops
from repro_torch.models.layers import LM_HEAD_FOLD
from repro_torch.models.lm import calls_per_layer, clone_state
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.runners import (
    FIELDS,
    DecoderRunner,
    PassIO,
    Staging,
    runner_for,
)
from repro_torch.serving.scheduler import Scheduler, get_scheduler
from repro_torch.serving.stream import (
    DeviceStream,
    OverlappedStream,
    Ticket,
    TokenRec,
)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    arrival_time: Optional[float] = None    # engine clock; None = at submit
    priority: int = 0                       # larger = served first
    tenant: str = "default"                 # fairness domain for `priority`
    deadline: Optional[float] = None        # not ported: must stay None
    on_token: Optional[Callable[["Request", int], None]] = None
    generated: List[int] = dataclasses.field(default_factory=list)
    prompt_pos: int = 0                 # prompt tokens consumed so far
    dispatched: int = 0                 # tokens whose pass has run; ahead
                                        # of len(generated) while overlapped
                                        # deliveries are in flight
    done: bool = False


_UNPORTED = ("paged", "faults", "mesh", "models", "deadlines")


@dataclasses.dataclass
class WarmPass:
    """One pass shape, warmed: its static buffers, its body and, on a GPU,
    the CUDA graph captured from the body with the kernel launches the
    capture recorded (added to the launch counts at every replay)."""
    io: PassIO
    body: Callable[[dict], None]
    graph: Any = None                   # torch.cuda.CUDAGraph
    launches: Optional[dict] = None

    def run(self, state: dict) -> None:
        if self.graph is None:
            self.body(state)
        else:
            self.graph.replay()
            ops.add_launch_counts(self.launches)


class ServingEngine:
    def __init__(self, params, mcfg: ModelConfig, *, capacity: int = 8,
                 max_len: int = 512,
                 runner: Optional[DecoderRunner] = None,
                 quant: QuantConfig = QuantConfig(mode="float"),
                 seed: int = 0,
                 prefill_chunks: Sequence[int] = (16, 64, 128),
                 chunked: bool = True,
                 policy: Union[str, Scheduler] = "fcfs",
                 tick_time: float = 1.0,
                 clock: Optional[Callable[[], float]] = None,
                 device: DeviceLike = None,
                 overlap: bool = False,
                 inflight: int = 4,
                 stream: Optional[DeviceStream] = None,
                 _graphs: Optional[bool] = None,
                 **unported: Any):
        asked = [k for k, v in unported.items() if v not in (None, False)]
        bad = [k for k in unported if k not in _UNPORTED]
        if bad:
            raise TypeError(f"unknown ServingEngine arguments: {bad}")
        if asked:
            raise NotImplementedError(
                f"repro_torch's ServingEngine does not port {asked}: paged "
                f"KV, preemption, faults, meshes, fleets and deadlines stay "
                f"with the JAX package for now")
        if quant.mode == "abfp_ref":
            raise ValueError(
                "the serving engine does not take abfp_ref numerics: its "
                "passes hand the kernels seeds from a table (CUDA graphs "
                "have no per-call keys), and the abfp_ref scan splits a "
                "key per call; serve abfp_kernel, abfp_packed or abfp_fused")
        self.overlap = bool(overlap)
        if self.overlap and clock is None:
            raise ValueError(
                "overlap=True needs a wall clock (clock=time.perf_counter): "
                "the simulated clock is defined by blocking passes")
        self.device = resolve_device(device)
        # CUDA graphs on a GPU; ``_graphs=False`` runs every pass eagerly
        # there too (for in-turn comparisons and the card tests only).
        self._graphs = (self.device.type == "cuda" if _graphs is None
                        else bool(_graphs))
        if self._graphs and self.device.type != "cuda":
            raise ValueError("CUDA graphs need a CUDA device")
        self.runner = runner if runner is not None else runner_for(mcfg)
        if quant.mode in ("abfp_packed", "abfp_fused"):
            # Quantize once: pack every dense weight at engine init so
            # passes only stream int8 codes + bf16 scales (+ gains).
            from repro_torch.models.packing import pack_model_params
            params = pack_model_params(params, quant, mcfg)
        self.params = params
        self.mcfg = mcfg
        self.capacity = capacity
        self.max_len = max_len
        self.quant = quant
        self.seed = seed
        self.key = prng.PRNGKey(seed)
        self.prefill_chunks = tuple(sorted({int(c) for c in prefill_chunks}))
        self.chunked = chunked and bool(self.prefill_chunks)

        self.state = self.runner.init_state(capacity, max_len, self.device)
        self.slots: List[Optional[Request]] = [None] * capacity
        self._next_input = np.zeros((capacity,), np.int32)
        self._reset_fn = self.runner.make_reset()
        self._perf = time.perf_counter

        # -- overlapped runtime (serving.stream) ---------------------------
        self._owns_stream = stream is None
        self._stream: DeviceStream = stream if stream is not None else (
            OverlappedStream(depth=inflight) if self.overlap
            else DeviceStream())
        self._delivered: deque = deque()    # finished by the worker,
                                            # flushed into poll() returns
        self._dev_next = None               # previous pass's device samples
        self._ov_vals = np.zeros((capacity,), np.int32)
        self._ov_mask = np.zeros((capacity,), bool)
        depth = max(int(inflight), getattr(getattr(self._stream, "_q", None),
                                           "maxsize", 0)) + 2
        pinned = self.device.type == "cuda"
        # A pass's sampled tokens land here, one buffer per pass in flight
        # (bounded by the stream's queue, the worker's ticket and the pass
        # being built).
        self._host_ring = [torch.zeros(capacity, dtype=torch.int32,
                                       pin_memory=pinned)
                           for _ in range(depth)]
        self._ring_i = 0

        # -- warmed passes ---------------------------------------------------
        self._passes = {}
        self._warmed_shapes = set()
        self._calls = calls_per_layer(mcfg)
        self._noisy = quant.mode != "float" and quant.noise_lsb > 0.0
        widest = max((1,) + self.prefill_chunks)
        self._staging = Staging(
            capacity * (widest + len(FIELDS) - 2) + self.runner.n_seeds(),
            depth, self.device)

        self.ticks = 0
        self.scheduler = get_scheduler(policy)
        self.metrics = ServingMetrics(capacity)
        self.tick_time = float(tick_time)
        self._clock = clock             # None => simulated (tick_time/pass)
        self.now = clock() if clock is not None else 0.0
        self._just_finished: List[Request] = []
        #: Host seconds of every delivered pass, by kind ("decode" /
        #: "prefill"), from dispatch to its logits (blocking) or sampled
        #: tokens (overlapped) on the host.
        self.pass_seconds = {"decode": [], "prefill": []}
        # Every delivered pass's host-visible duration feeds the
        # trailing-median straggler model (a shape's first run excluded).
        self.straggler = StragglerMonitor()
        self.metrics.straggler = self.straggler

    # -- warmed passes ------------------------------------------------------
    def _capture(self, body: Callable[[dict], None]):
        """Capture ``body`` on the served state into a CUDA graph: a
        warm-up run first, on a side stream and a scratch copy of the state
        (the served state is not touched: capture only records).  Returns
        (graph, the kernel launches it holds); any failure raises."""
        self._stream.sync()             # no delivery waits during capture
        dev = self.device
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        scratch = clone_state(self.state)
        with torch.cuda.stream(side):
            body(scratch)
        main.wait_stream(side)
        torch.cuda.synchronize(dev)
        del scratch
        before = ops.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            body(self.state)
        after = ops.launch_counts()
        launches = {k: after[k] - before[k] for k in after}
        ops.add_launch_counts(launches, -1)     # recorded, not launched
        return graph, launches

    def _executable(self, shape_key: Tuple) -> Tuple[WarmPass, bool]:
        """The warmed pass of ``shape_key`` — ``("decode",)`` or
        ``("prefill", bucket)`` — built (and on a GPU captured) at its
        first use, outside the timed region.  Returns ``(pass, warmup)``:
        ``warmup`` marks the shape's first EXECUTION, which the straggler
        model excludes."""
        wp = self._passes.get(shape_key)
        if wp is None:
            io, body = self.runner.make_pass(shape_key, self.params,
                                             self.quant, self.seed,
                                             self.capacity, self.device,
                                             sample=self.overlap)
            wp = WarmPass(io, body)
            if self._graphs:
                wp.graph, wp.launches = self._capture(body)
            self._passes[shape_key] = wp
        warm = shape_key not in self._warmed_shapes
        self._warmed_shapes.add(shape_key)
        return wp, warm

    def warmup(self):
        """Build (capture) the decode tick and every prefill bucket before
        traffic arrives (their ``"draw"`` variants are captured at first
        use); the first real pass of each shape still counts as its
        warm-up for the straggler model."""
        self._executable(("decode",))
        if self.chunked:
            for bucket in self.prefill_chunks:
                self._executable(("prefill", bucket))
        self._warmed_shapes.clear()

    def _call(self, shape_key: Tuple, key, **fields) -> Tuple[PassIO, bool]:
        """Run one pass: fill its inputs (one host-to-device copy of the
        host fields and the pass's seed table from ``key``; rows in
        ``prev_mask`` take the previous pass's device sample), then replay
        (or run) it.  Returns (its buffers, warmup)."""
        wp, warm = self._executable(shape_key)
        io = wp.io
        if self._noisy:
            fields["seeds"] = prng.seed_table(
                key, self.mcfg.num_layers, self._calls, LM_HEAD_FOLD)
        self._staging.copy(io.pack(**fields), io.words)
        if fields["prev_mask"].any():
            io.prev.copy_(self._dev_next, non_blocking=True)
        wp.run(self.state)
        return io, warm

    def _shape(self, base: Tuple, temps: np.ndarray) -> Tuple:
        """The shape key of a pass: an overlapped pass in which some row
        samples at a temperature runs the ``"draw"`` variant (the device
        sampler's Gumbel draw); a greedy one skips it."""
        return base + ("draw",) if self.overlap and temps.max() > 0 else base

    # -- dispatch inputs --------------------------------------------------
    def _samp_arrays(self):
        """Per-slot sampling inputs: temperature, uid and NEXT token index
        (``dispatched``, which in overlap mode runs ahead of
        ``len(generated)``); zeros for empty slots."""
        temps = np.zeros((self.capacity,), np.float32)
        uids = np.zeros((self.capacity,), np.int32)
        idxs = np.zeros((self.capacity,), np.int32)
        for i, req in enumerate(self.slots):
            if req is not None:
                temps[i] = req.temperature
                uids[i] = req.uid & 0x7FFFFFFF
                idxs[i] = req.dispatched
        return temps, uids, idxs

    def _set_next(self, i: int, val: int):
        """Host-known next input for slot i.  The overlapped path records
        it as an OVERRIDE too: its base decode input is the previous
        pass's device sample, which a host prompt feed must shadow."""
        self._next_input[i] = int(val)
        if self.overlap:
            self._ov_vals[i] = int(val)
            self._ov_mask[i] = True

    # -- delivery (the stream's consumer side) ----------------------------
    def _account_dispatch(self, i: int, req: Request) -> TokenRec:
        """Host bookkeeping for one device-sampled token the overlapped
        path has NOT seen yet: bump the dispatched count and, when it hits
        the limit, free the slot at once (completion is a count, so the
        next admission can reuse the slot while the token is in flight)."""
        req.dispatched += 1
        finishing = req.dispatched >= req.max_new_tokens
        if finishing:
            self.slots[i] = None
        return TokenRec(slot=i, req=req, finishing=finishing)

    def _submit(self, kind: str, t0: float, warm: bool, io: PassIO,
                recs: List[TokenRec]):
        """Hand a dispatched pass to the stream: its sampled tokens go to
        the next pinned host buffer of the ring by a non-blocking copy, and
        the ticket carries the event recorded behind it."""
        host = self._host_ring[self._ring_i]
        self._ring_i = (self._ring_i + 1) % len(self._host_ring)
        host.copy_(io.sampled, non_blocking=True)
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        self._stream.submit(Ticket(engine=self, t0=t0, warmup=warm,
                                   sampled=host, recs=recs, now=self.now,
                                   kind=kind, ready=ready))

    def _deliver_ticket(self, ticket: Ticket):
        """Resolve one dispatched pass (on the stream's worker thread in
        overlap mode): wait for its sampled tokens' copy, append them, fire
        the streaming callbacks, finalize metrics, feed the gauges."""
        if ticket.ready is not None:
            ticket.ready.synchronize()
        vals = self._stream.fetch(ticket.sampled)
        done = self._perf()
        self.metrics.on_device_span(ticket.t0, done)
        self.pass_seconds[ticket.kind].append(done - ticket.t0)
        if not ticket.warmup:
            self.straggler.observe(done - ticket.t0)
        for rec in ticket.recs:
            req = rec.req
            nxt = int(vals[rec.slot])
            req.generated.append(nxt)
            self.metrics.on_token(req.uid, ticket.now)
            if req.on_token is not None:
                req.on_token(req, nxt)
            if rec.finishing:
                req.done = True
                self.metrics.on_finish(req.uid, ticket.now)
                self._delivered.append(req)

    def _drain_delivered(self) -> List[Request]:
        out: List[Request] = []
        while self._delivered:
            out.append(self._delivered.popleft())
        return out

    def sync(self):
        """Wait until every in-flight pass has delivered its tokens (a
        no-op on the blocking path)."""
        self._stream.sync()

    def close(self):
        """Shut down the delivery worker (safe on any engine; a stream
        passed in by the caller is left to the caller)."""
        if self._owns_stream:
            self._stream.sync()
            self._stream.close()

    # -- clock ----------------------------------------------------------------
    def _tick_clock(self):
        """One pass just ran: advance the engine clock (simulated ticks or
        wall time) BEFORE tokens from that pass are recorded."""
        self.ticks += 1
        self.now = (self._clock() if self._clock is not None
                    else self.now + self.tick_time)

    # -- admission ------------------------------------------------------------
    def _reset_slot(self, i: int):
        self.state = self._reset_fn(self.state, i)

    def fits(self, req: Request) -> bool:
        """A request needs a non-empty prompt and must leave room for at
        least one generated token: prompt + max(1, max_new) <= max_len."""
        if len(req.prompt) < 1:
            return False
        total = len(req.prompt) + max(1, req.max_new_tokens)
        return total <= self.max_len

    def submit(self, req: Request) -> bool:
        """Enqueue a request for arrival-driven admission (``arrival_time``
        defaults to now).  Oversized requests are rejected (marked done,
        recorded in metrics): returns False."""
        if req.deadline is not None:
            raise NotImplementedError("deadlines are not ported")
        if not self.fits(req):
            req.done = True
            self.metrics.on_reject(req.uid)
            return False
        if req.arrival_time is None:
            req.arrival_time = self.now
        self.metrics.on_submit(req.uid, arrival_time=req.arrival_time,
                               tenant=req.tenant,
                               prompt_len=len(req.prompt))
        self.scheduler.add(req)
        return True

    def try_admit(self, req: Request) -> bool:
        if not self.fits(req):
            raise ValueError(
                f"request {req.uid}: prompt ({len(req.prompt)}) must be "
                f"non-empty and prompt + max_new ({req.max_new_tokens}) "
                f"must fit max_len ({self.max_len})")
        for i, slot in enumerate(self.slots):
            if slot is None:
                self._reset_slot(i)
                self.slots[i] = req
                if req.arrival_time is None:
                    req.arrival_time = self.now
                self.metrics.on_admit(req.uid, self.now, tenant=req.tenant,
                                      prompt_len=len(req.prompt),
                                      arrival_time=req.arrival_time)
                if self.chunked:
                    req.prompt_pos = 0      # consumed by prefill passes
                else:
                    # Prefill-in-decode: one prompt token per tick.
                    self._set_next(i, req.prompt[0])
                    req.prompt_pos = 1
                return True
        return False

    def _admit_arrived(self) -> List[Request]:
        """Fill free slots from the queue (policy order) with requests that
        have arrived by the current clock."""
        admitted: List[Request] = []
        free = self.slots.count(None)
        while free > 0:
            req = self.scheduler.pop(self.now)
            if req is None:
                break
            self.try_admit(req)     # a slot is free; fits() held at submit
            admitted.append(req)
            free -= 1
        return admitted

    # -- sampling -------------------------------------------------------------
    def _record(self, i: int, req: Request, logits_row: np.ndarray):
        if req.temperature > 0:
            # Keyed by (engine seed, uid, token index): reproducible for a
            # given engine seed however requests interleave.
            z = logits_row.astype(np.float64) / req.temperature
            z -= z.max()
            p = np.exp(z)
            p /= p.sum()
            rng = np.random.default_rng(
                (self.seed, req.uid, len(req.generated)))
            nxt = int(rng.choice(len(p), p=p))
        else:
            nxt = int(np.argmax(logits_row))
        req.generated.append(nxt)
        req.dispatched = len(req.generated)
        self._next_input[i] = nxt
        self.metrics.on_token(req.uid, self.now)
        if req.on_token is not None:
            req.on_token(req, nxt)
        if len(req.generated) >= req.max_new_tokens:
            req.done = True
            self.slots[i] = None            # free for the next request
            self.metrics.on_finish(req.uid, self.now)
            self._just_finished.append(req)

    # -- one engine tick ------------------------------------------------------
    def step(self):
        self._just_finished = []
        live = [i for i, s in enumerate(self.slots) if s is not None]
        if not live:
            return
        self.metrics.on_tick(self.now, len(live), self.capacity,
                             self.scheduler.pending(self.now))
        prefilling = [i for i in live
                      if self.slots[i].prompt_pos
                      < len(self.slots[i].prompt)]
        if self.chunked and prefilling:
            if all(len(self.slots[i].prompt) - self.slots[i].prompt_pos
                   == 1 for i in prefilling):
                # Every prefilling slot has exactly ONE prompt token left:
                # feed it as the decode input instead of a padded chunk.
                for i in prefilling:
                    req = self.slots[i]
                    self._set_next(i, req.prompt[req.prompt_pos])
                    req.prompt_pos += 1
                self._decode_tick()
            else:
                self._prefill_pass(live)
        else:
            self._decode_tick()

    def _fetch_logits(self, kind: str, t0: float, logits, warm: bool):
        """The blocking path's one host sync of a pass that samples; feeds
        the pass timings and the gauges."""
        lg = self._stream.fetch(logits, np.float32)     # host sync
        done = self._perf()
        self.metrics.on_device_span(t0, done)
        self.pass_seconds[kind].append(done - t0)
        if not warm:
            self.straggler.observe(done - t0)
        return lg

    def _prefill_pass(self, live: List[int]):
        """One bucketed prefill pass: prompt chunks for prefilling slots, a
        single next token for decoding slots, nothing for empty slots.

        Decoding slots riding along take their input from ``_next_input``
        on the blocking path, or from the previous pass's device sample
        (``prev_mask``) on the overlapped path, unless a host override is
        pending."""
        cap = self.prefill_chunks[-1]
        need = np.zeros((self.capacity,), np.int32)
        for i in live:
            req = self.slots[i]
            rem = len(req.prompt) - req.prompt_pos
            need[i] = min(rem, cap) if rem > 0 else 1
        bucket = next(c for c in self.prefill_chunks if c >= need.max())

        tokens = np.zeros((self.capacity, bucket), np.int32)
        riders = np.zeros((self.capacity,), bool)
        for i in live:
            req = self.slots[i]
            if req.prompt_pos < len(req.prompt):
                n = int(need[i])
                tokens[i, :n] = req.prompt[req.prompt_pos:req.prompt_pos + n]
            elif (self.overlap and self._dev_next is not None
                    and not self._ov_mask[i]):
                riders[i] = True    # input = previous device sample
            else:
                tokens[i, 0] = self._next_input[i]
        temps, uids, idxs = self._samp_arrays()
        self.key, sub = prng.split(self.key)
        t0 = self._perf()
        self.metrics.window_open(t0)
        io, warm = self._call(self._shape(("prefill", bucket), temps), sub,
                              tokens=tokens,
                              n_tokens=need, prev_mask=riders, temps=temps,
                              uids=uids, idxs=idxs)
        self._dev_next = io.sampled
        self._ov_vals[:] = 0
        self._ov_mask[:] = False

        # Recipients: slots whose prompt completes this pass, or riders.
        recipients = [i for i in live
                      if (len(self.slots[i].prompt) - self.slots[i].prompt_pos
                          <= int(need[i]))]
        if not self.overlap:
            lg = (self._fetch_logits("prefill", t0, io.logits, warm)
                  if recipients else None)
            self._tick_clock()
            for i in live:
                req = self.slots[i]
                if req.prompt_pos < len(req.prompt):
                    req.prompt_pos += int(need[i])
                    if req.prompt_pos < len(req.prompt):
                        continue        # still prefilling; logits unused
                # Prompt just completed (logits are at its last prompt
                # token) or the slot was decoding: sample either way.
                self._record(i, req, lg[i])
            return

        self._tick_clock()
        recs: List[TokenRec] = []
        for i in live:
            req = self.slots[i]
            if req.prompt_pos < len(req.prompt):
                req.prompt_pos += int(need[i])
                if req.prompt_pos < len(req.prompt):
                    continue
            recs.append(self._account_dispatch(i, req))
        self._submit("prefill", t0, warm, io, recs)

    def _decode_tick(self):
        fed = [i for i, s in enumerate(self.slots) if s is not None]
        # Blocking: every row's host token.  Overlapped: every row takes
        # the previous pass's device sample unless overridden by the host.
        prev = np.zeros((self.capacity,), bool)
        if self.overlap and self._dev_next is not None:
            prev = ~self._ov_mask
        tokens = np.where(self._ov_mask, self._ov_vals, self._next_input)
        temps, uids, idxs = self._samp_arrays()
        self.key, sub = prng.split(self.key)
        t0 = self._perf()
        self.metrics.window_open(t0)
        io, warm = self._call(self._shape(("decode",), temps), sub,
                              tokens=tokens,
                              prev_mask=prev, temps=temps, uids=uids,
                              idxs=idxs)
        self._dev_next = io.sampled
        self._ov_vals[:] = 0
        self._ov_mask[:] = False

        recipients = [i for i in fed
                      if self.slots[i].prompt_pos
                      >= len(self.slots[i].prompt)]
        if not self.overlap:
            lg = (self._fetch_logits("decode", t0, io.logits, warm)
                  if recipients else None)
            self._tick_clock()
            for i, req in enumerate(self.slots):
                if req is None:
                    continue
                if req.prompt_pos < len(req.prompt):
                    # prefill-in-decode: feed the next prompt token
                    self._set_next(i, req.prompt[req.prompt_pos])
                    req.prompt_pos += 1
                    continue
                self._record(i, req, lg[i])
            return

        self._tick_clock()
        recs: List[TokenRec] = []
        for i in fed:
            req = self.slots[i]
            if req.prompt_pos < len(req.prompt):
                self._set_next(i, req.prompt[req.prompt_pos])
                req.prompt_pos += 1
                continue
            recs.append(self._account_dispatch(i, req))
        self._submit("decode", t0, warm, io, recs)

    # -- open-loop API ----------------------------------------------------
    def poll(self) -> List[Request]:
        """One arrival-driven round: sync the clock, admit every arrived
        request the policy picks, run one ``step()``.  Returns the requests
        that finished during this poll (on the overlapped path: whose last
        token was delivered).  With the simulated clock an idle engine
        jumps to the next arrival; with a wall clock it naps (capped) and
        re-reads the clock."""
        if self._clock is not None:
            self.now = self._clock()
        out = self._drain_delivered()
        self._admit_arrived()
        if all(s is None for s in self.slots):
            if self._stream.pending():
                # Everything dispatched: wait for the deliveries in flight.
                self._stream.sync()
                out.extend(self._drain_delivered())
            self.metrics.window_close(self._perf())
            nxt = self.scheduler.next_arrival()
            if nxt is None:
                return out                  # fully drained
            if self._clock is not None:
                if nxt > self.now:
                    time.sleep(min(nxt - self.now, 0.01))
                    self.now = self._clock()
                return out
            self.now = max(self.now, nxt)
            self._admit_arrived()
        self.step()
        return out + list(self._just_finished)

    def drain(self) -> List[Request]:
        """Poll until the queue, every slot and the in-flight stream are
        empty; returns finished requests in completion order."""
        finished: List[Request] = []
        while (len(self.scheduler)
               or any(s is not None for s in self.slots)
               or self._stream.pending()
               or self._delivered):
            finished.extend(self.poll())
        return finished

    def run(self, requests: List[Request]) -> List[Request]:
        """Serve a static workload to completion under the engine's policy.
        Oversized requests are rejected up front (marked done, nothing
        generated) and returned first."""
        finished: List[Request] = []
        for r in requests:
            if not self.submit(r):
                finished.append(r)
        finished.extend(self.drain())
        return finished

    def pass_stats(self) -> Tuple[dict, dict]:
        """By pass kind ("decode" / "prefill"): the median host seconds
        per pass (None before the first), and the number of passes."""
        return {k: (float(np.median(v)) if v else None)
                for k, v in self.pass_seconds.items()}, \
            {k: len(v) for k, v in self.pass_seconds.items()}
