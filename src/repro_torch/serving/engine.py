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
ties); temperature > 0 samples on the host from a stream seeded by
(engine seed, request uid, token index).

Not ported (each raises when asked for): paged KV and preemption, fault
injection, meshes, the overlapped runtime, fleets and deadlines.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng
from repro_torch.core.abfp import QuantConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.runners import DecoderRunner, runner_for
from repro_torch.serving.scheduler import Scheduler, get_scheduler
from repro_torch.serving.stream import DeviceStream


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
    dispatched: int = 0                 # tokens whose pass has run
    done: bool = False


_UNPORTED = ("paged", "faults", "mesh", "overlap", "models", "deadlines")


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
                 **unported: Any):
        asked = [k for k, v in unported.items() if v not in (None, False)]
        bad = [k for k in unported if k not in _UNPORTED]
        if bad:
            raise TypeError(f"unknown ServingEngine arguments: {bad}")
        if asked:
            raise NotImplementedError(
                f"repro_torch's ServingEngine does not port {asked}: paged "
                f"KV, preemption, faults, meshes, the overlapped runtime, "
                f"fleets and deadlines stay with the JAX package for now")
        self.device = resolve_device(device)
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
        self._stream = DeviceStream()
        self._perf = time.perf_counter
        self._step_fn = self.runner.make_step(quant, seed)
        self._prefill_fn = self.runner.make_prefill(quant, seed)
        self._reset_fn = self.runner.make_reset()
        self._ov_vals = np.zeros((capacity,), np.int32)
        self._ov_mask = np.zeros((capacity,), bool)

        self.ticks = 0
        self.scheduler = get_scheduler(policy)
        self.metrics = ServingMetrics(capacity)
        self.tick_time = float(tick_time)
        self._clock = clock             # None => simulated (tick_time/pass)
        self.now = clock() if clock is not None else 0.0
        self._just_finished: List[Request] = []
        #: Host seconds of every pass, by kind ("decode" / "prefill"),
        #: each ending in the host fetch of its logits.
        self.pass_seconds = {"decode": [], "prefill": []}

    # -- dispatch inputs --------------------------------------------------
    def _samp_arrays(self):
        """Per-slot sampling inputs: temperature, uid and next token index
        (zeros for empty slots)."""
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
        self._next_input[i] = int(val)

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

    def _fetch_logits(self, kind: str, t0: float, logits):
        lg = self._stream.fetch(logits, np.float32)     # host sync
        done = self._perf()
        self.metrics.on_device_span(t0, done)
        self.pass_seconds[kind].append(done - t0)
        return lg

    def _prefill_pass(self, live: List[int]):
        """One bucketed prefill pass: prompt chunks for prefilling slots, a
        single next token for decoding slots, nothing for empty slots."""
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
            else:
                tokens[i, 0] = self._next_input[i]
        temps, uids, idxs = self._samp_arrays()
        self.key, sub = prng.split(self.key)
        rv = np.zeros((self.capacity,), np.int32)
        t0 = self._perf()
        self.metrics.window_open(t0)
        logits, _sampled, self.state = self._prefill_fn(
            self.params, self.state, tokens, need, rv, riders, sub, temps,
            uids, idxs)

        # Recipients: slots whose prompt completes this pass, or riders.
        recipients = [i for i in live
                      if (len(self.slots[i].prompt) - self.slots[i].prompt_pos
                          <= int(need[i]))]
        lg = self._fetch_logits("prefill", t0, logits) if recipients else None
        self._tick_clock()
        for i in live:
            req = self.slots[i]
            if req.prompt_pos < len(req.prompt):
                req.prompt_pos += int(need[i])
                if req.prompt_pos < len(req.prompt):
                    continue        # still prefilling; logits unused
            # Prompt just completed (logits are at its last prompt token)
            # or the slot was decoding: sample either way.
            self._record(i, req, lg[i])

    def _decode_tick(self):
        fed = [i for i, s in enumerate(self.slots) if s is not None]
        temps, uids, idxs = self._samp_arrays()
        self.key, sub = prng.split(self.key)
        t0 = self._perf()
        self.metrics.window_open(t0)
        logits, _sampled, self.state = self._step_fn(
            self.params, self.state, self._next_input, self._ov_vals,
            self._ov_mask, sub, temps, uids, idxs)

        recipients = [i for i in fed
                      if self.slots[i].prompt_pos
                      >= len(self.slots[i].prompt)]
        lg = self._fetch_logits("decode", t0, logits) if recipients else None
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

    # -- open-loop API ----------------------------------------------------
    def poll(self) -> List[Request]:
        """One arrival-driven round: sync the clock, admit every arrived
        request the policy picks, run one ``step()``.  Returns the requests
        that finished.  With the simulated clock an idle engine jumps to
        the next arrival."""
        if self._clock is not None:
            self.now = self._clock()
        self._admit_arrived()
        if all(s is None for s in self.slots):
            self.metrics.window_close(self._perf())
            nxt = self.scheduler.next_arrival()
            if nxt is None:
                return []                   # fully drained
            if self._clock is not None:
                if nxt > self.now:
                    time.sleep(min(nxt - self.now, 0.01))
                    self.now = self._clock()
                return []
            self.now = max(self.now, nxt)
            self._admit_arrived()
        self.step()
        return list(self._just_finished)

    def drain(self) -> List[Request]:
        """Poll until the queue and every slot are empty; returns finished
        requests in completion order."""
        finished: List[Request] = []
        while (len(self.scheduler)
               or any(s is not None for s in self.slots)):
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
