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
``QuantConfig.mode`` picks ``float``, ``abfp_ref`` (the paper's reference
numerics: the tile scan on float weights, each dense call's key from the
pass's key table, its noise drawn on the engine's device), ``abfp_kernel``
(no packing: every pass through the unpacked ABFP kernel, which quantizes
each weight inside the call), ``abfp_packed`` (every dense weight packed
once at engine init, every pass through the packed ABFP kernel) or
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
raises: there is no eager fallback.  Each pass's noise seeds (its keys,
under ``abfp_ref``) live in its table, filled by the pass's one
host-to-device copy, so every replay draws fresh noise.  A
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

Paged KV + overload robustness
------------------------------
``paged=True`` swaps the per-slot ``max_len`` KV strips for a shared
``serving.pages.PagePool``: fixed-size pages (the quant tile width by
default, so an int8 KV page never straddles a tile) that each slot
addresses through a (capacity, max_pages) page table.  The host table
(``self._table``) is the source of truth; every pass copies it to the
device with its other inputs (``PassIO.table``) and reads it there, so a
captured pass replays under any table.  Unallocated entries hold the
sentinel ``pool.num_pages``, the pool's scratch page: writes routed there
are never read, so a dead slot cannot corrupt a live page.  Prompt
prefixes are shared copy-on-write across requests (chained-hash keys over
full pages; a write to a shared page splits it first).

Under page saturation the engine PREEMPTS the lowest-priority, youngest
slot: its pages return to the pool and the request requeues with a
replay of ``prompt + generated``, re-prefilled on re-admission (recompute
is restore).  Backpressure sheds newly ARRIVED requests past
``queue_watermark`` (``shed`` with a ``retry_after`` hint, surfaced through
``poll()``); ``tenant_quota`` caps one tenant's pages at projected
footprint; pool pressure above ``page_watermarks[0]`` enters a hysteretic
DEGRADED mode (admissions capped at ``degraded_max_new`` tokens, prefill
at the smallest bucket) until pressure falls to ``page_watermarks[1]``.
A request's ``deadline`` (engine clock) cancels it, queued or in flight,
as ``timed_out``.  Every decision is the JAX engine's.

Fault tolerance
---------------
``faults=FaultConfig(...)`` (or a ``FaultPlan``) injects the plan's
seeded events into the served weights at their ticks
(``serving.faults``: in place, into the codes, the kernel-layout codes
and the fused QKV concatenation alike, so the faults flow through the
kernels and the captured graphs).  Every ``detect_every`` ticks while a
fault is live, a detection round compares every site's fingerprint with
its healthy baseline; with ``recovery`` it repairs what it found from a
clean spare (a device clone of every site, made at init), requeues the
requests that produced tokens under the fault, and on a shard drop
re-programs the whole array (on a mesh, first re-planning the mesh
without the lost model bank: see "Tensor-parallel serving") and
restarts every request in flight.
Detection runs before the tick's injections, so every fault is live for
at least one pass.  Tokens produced under a live fault mark their request
``corrupted``.  With ``faults=None`` nothing of this exists on the hot
path: the same graphs, the same launches, no spare.

Encoder-decoders
----------------
A runner with ``needs_admission`` (``EncDecRunner``) takes requests whose
``features`` it ``accepts`` (anything else is rejected at ``submit``, as
the JAX engine rejects it).  Admission runs the runner's ``("admit",)``
pass after the slot reset and before the prompt: the encoder over the
request's features under the key ``fold_in(PRNGKey(seed), uid)``, its
cross-attention K/V written into the slot's rows of the state, so a
preempted request re-admits and re-encodes to the same bits.  On a GPU
the admission pass is a captured shape of its own (its features, slot
index and seed table are device data).  A fault in an encoder weight or a
cross-attention ``wk``/``wv`` reaches the served cross K/V only at an
admission: a requeued request re-admits, and so re-encodes under the
repaired weights, as in the JAX engine.

Fleets
------
``ServingEngine(models={name: (params, mcfg[, runner])}, ...)`` builds a
``serving.fleet.FleetEngine``: one single-model lane per entry on a
shared clock, routed by ``Request.model``.

Tensor-parallel serving
-----------------------
``mesh=`` (a ``distributed.sharding.Mesh`` with a 'model' axis and
optional 'data'/'pod' axes, ``launch.mesh.make_host_mesh``) serves
column-parallel: every dense weight whose columns split over 'model'
(packed codes and scales together) is stored as ``tp`` column shards
(``distributed.sharding.shard_serving_params``), each dense call runs one
kernel launch per shard at its global column-block offset and
concatenates the outputs in shard order (``kernels.ops.dense_tp``), and
the fused decode tick's QKV runs per shard when wq, wk and wv all split.
Column splits never cross an ABFP K-tile nor reorder an f32 contraction,
so greedy streams are bit-identical to the one-device engine at any
mesh shape, noise included.  Everything else (norms, rope, KV encoding,
attention, sampling, the state) runs once, unsharded.  In this port a
mesh is virtual: its every position is the engine's device, so the
passes are captured into CUDA graphs as any others.  The 'data' axis is
validated and read by the spec trees, and rows stay whole (a row split
would also reorder the float matmuls' rounding).  A mesh over several
devices raises ``NotImplementedError``: it comes in the multi-card slice.

Fault plans run on a mesh as in the JAX engine: a shard drop zeroes the
lost model shard's columns of every weight split over 'model'
(``serving.faults.inject_shard_drop``), and recovery re-plans the mesh
without the lost bank (``distributed.fault.plan_recovery_mesh``: a data
row's chip per model bank).  When the plan keeps the model axis (any
mesh with two or more data rows) the column shards keep their layout, so
the spare is copied into the served tensors in place and every captured
pass stays valid; when it narrows the model axis (one data row) the
weights are placed anew from the whole packed tree (kept for that from
engine init) and every pass is built, and captured, again.
"""

from __future__ import annotations

import contextlib
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
from repro_torch.distributed.fault import (
    StragglerMonitor,
    plan_recovery_mesh,
)
from repro_torch.distributed.sharding import (
    Mesh,
    canonical_device,
    shard_serving_params,
)
from repro_torch.kernels import ops
from repro_torch.kernels.ops import tp_size
from repro_torch.models.convert import to_tensor
from repro_torch.models.lm import clone_state
from repro_torch.serving import faults as faultlib
from repro_torch.serving.faults import FaultConfig, FaultPlan
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.pages import (
    PagePool,
    page_table_array,
    pages_needed,
    plan_chunk,
    prefix_key,
)
from repro_torch.serving.runners import (
    DecoderRunner,
    PassIO,
    Staging,
    runner_for,
    state_tensors,
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
    model: Optional[str] = None         # fleet routing key (ServingEngine
                                        # with models=...); None on a
                                        # single-model engine
    deadline: Optional[float] = None    # absolute engine-clock time; past it
                                        # the request is cancelled (queued or
                                        # in flight) and marked timed_out
    on_token: Optional[Callable[["Request", int], None]] = None
    features: Optional[Any] = None      # frontend side input (enc-dec:
                                        # (enc_len, d_model) frame
                                        # embeddings, numpy or a tensor)
    generated: List[int] = dataclasses.field(default_factory=list)
    prompt_pos: int = 0                 # prompt tokens consumed so far
    dispatched: int = 0                 # tokens whose pass has run; ahead
                                        # of len(generated) while overlapped
                                        # deliveries are in flight
    done: bool = False
    timed_out: bool = False             # cancelled by deadline expiry
    replay: Optional[List[int]] = None  # recompute stream after preemption:
                                        # prompt + tokens already streamed,
                                        # re-prefilled verbatim on resume
    preempted: int = 0                  # times evicted under page pressure
    shed: bool = False                  # rejected by admission backpressure
    retry_after: Optional[float] = None  # backoff hint stamped when shed


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


@contextlib.contextmanager
def _refused_capture_restores(dev: torch.device):
    """Around a graph capture: if it is refused, put back the device's
    default CUDA generator state and current stream as they were before,
    then raise.  A refused capture ends without the generator's capture
    epilogue (it stays in capture mode, and every later random draw or
    capture on the device fails) and without leaving the capture's stream
    context."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    gen = torch.cuda.default_generators[idx]
    saved = gen.clone_state()
    stream = torch.cuda.current_stream(dev)
    try:
        yield
    except BaseException:
        gen.graphsafe_set_state(saved)
        torch.cuda.set_stream(stream)
        raise


def _check_mesh(mesh, device: torch.device, faults) -> Optional[Mesh]:
    """The engine's mesh, or None for the one-device engine (a mesh of
    one position serves as it).  A mesh of this port is virtual: its every
    position must be the engine's device."""
    if mesh is None:
        return None
    if not isinstance(mesh, Mesh) or mesh.device_set() != {
            canonical_device(device)}:
        what = "a fault plan on " if faults is not None else ""
        raise NotImplementedError(
            f"repro_torch serves {what}a mesh whose every position is the "
            f"engine's device ({device}; launch.mesh.make_host_mesh), got "
            f"{mesh!r}: shards on several devices come in the multi-card "
            f"slice")
    return mesh


class ServingEngine:
    def __new__(cls, params=None, mcfg=None, *args, models=None, **kwargs):
        # ``models={name: (params, mcfg[, runner])}`` makes a multi-model
        # fleet (serving.fleet); a subclass is never dispatched.
        if models is not None and cls is ServingEngine:
            from repro_torch.serving.fleet import FleetEngine
            return super().__new__(FleetEngine)
        return super().__new__(cls)

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
                 faults: Optional[Union[FaultConfig, FaultPlan]] = None,
                 recovery: bool = True,
                 detect_every: int = 4,
                 paged: bool = False,
                 page_size: Optional[int] = None,
                 pool_pages: Optional[int] = None,
                 prefix_cache: bool = True,
                 preemption: Optional[bool] = None,
                 queue_watermark: Optional[int] = None,
                 page_watermarks: Tuple[float, float] = (0.85, 0.5),
                 degraded_max_new: Optional[int] = None,
                 tenant_quota: Optional[int] = None,
                 overlap: bool = False,
                 inflight: int = 4,
                 stream: Optional[DeviceStream] = None,
                 mesh: Optional[Mesh] = None,
                 _graphs: Optional[bool] = None):
        if faults is not None and not isinstance(faults,
                                                 (FaultConfig, FaultPlan)):
            raise TypeError(f"faults must be a FaultConfig or a FaultPlan, "
                            f"got {type(faults).__name__}")
        self.overlap = bool(overlap)
        if self.overlap and clock is None:
            raise ValueError(
                "overlap=True needs a wall clock (clock=time.perf_counter): "
                "the simulated clock is defined by blocking passes")
        self.device = resolve_device(device)
        self.mesh = _check_mesh(mesh, self.device, faults)
        # CUDA graphs on a GPU; ``_graphs=False`` runs every pass eagerly
        # there too (for in-turn comparisons and the card tests only).
        self._graphs = (self.device.type == "cuda" if _graphs is None
                        else bool(_graphs))
        if self._graphs and self.device.type != "cuda":
            raise ValueError("CUDA graphs need a CUDA device")
        self.runner = runner if runner is not None else runner_for(mcfg)
        if quant.mode in ("abfp_packed", "abfp_fused"):
            # Quantize once: pack every dense weight at engine init so
            # passes only stream int8 codes + bf16 scales (+ gains); on a
            # mesh the packs are then split into column shards.
            from repro_torch.models.packing import pack_model_params
            params = pack_model_params(params, quant, mcfg)
        # The whole tree a fault plan re-places from when a recovery
        # narrows the model axis (module docstring).
        self._params_whole = (params if faults is not None
                              and tp_size(self.mesh) > 1 else None)
        if self.mesh is not None:
            params = shard_serving_params(params, self.mesh, quant)
        self.params = params
        self.mcfg = mcfg
        self.capacity = capacity
        self.max_len = max_len
        self.quant = quant
        self.seed = seed
        self.key = prng.PRNGKey(seed)
        self.prefill_chunks = tuple(sorted({int(c) for c in prefill_chunks}))
        self.chunked = chunked and bool(self.prefill_chunks)

        # -- paged KV pool (serving.pages) ---------------------------------
        # With ``paged=False`` the engine allocates per-slot max_len caches
        # and nothing below exists on the hot path.
        self.paged = bool(paged)
        self.pool: Optional[PagePool] = None
        self.page_size = 0
        self.max_pages = 0
        if self.paged:
            if not self.runner.paged_ok:
                raise ValueError(
                    "paged serving needs append-only full-attention KV "
                    f"caches; got attention_type={mcfg.attention_type!r}")
            # The ABFP tile width is the natural page quantum.
            self.page_size = int(page_size) if page_size else (
                quant.tile_width if quant.mode != "float"
                else min(16, max_len))
            self.max_pages = pages_needed(max_len, self.page_size)
            self.pool = PagePool(
                int(pool_pages) if pool_pages else capacity * self.max_pages,
                self.page_size)
            self._table = page_table_array(capacity, self.max_pages,
                                           self.pool.sentinel)
            self._slot_pages: List[List[int]] = [[] for _ in range(capacity)]
            self._slot_len = [0] * capacity     # tokens appended per slot
            self._slot_keys: List[List[int]] = [[] for _ in range(capacity)]
            self._slot_cap: List[Optional[int]] = [None] * capacity
        self.prefix_enabled = (self.paged and bool(prefix_cache)
                               and self.chunked
                               and self.runner.prefix_cache_ok)
        self.preemption = (self.paged if preemption is None
                           else bool(preemption))
        self.queue_watermark = queue_watermark
        hi, lo = page_watermarks
        if not 0.0 < lo <= hi <= 1.0:
            raise ValueError("page_watermarks must be (hi, lo) in (0, 1] "
                             "with lo <= hi")
        self.page_watermarks = (float(hi), float(lo))
        self.degraded_max_new = degraded_max_new
        self.tenant_quota = tenant_quota
        self._degraded = False

        self.state = self.runner.init_state(
            capacity, max_len, self.device,
            page_size=self.page_size if self.paged else None,
            pool_pages=self.pool.num_pages if self.paged else None)
        if self.mesh is not None:
            self.state = self.runner.shard_state(self.state, self.mesh)
        self.slots: List[Optional[Request]] = [None] * capacity
        self._next_input = np.zeros((capacity,), np.int32)
        self._reset_fn = self.runner.make_reset()
        self._attach_fn = self.runner.make_attach()
        self._copy_page_fn = self.runner.make_copy_page()
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
        self._noisy = quant.mode != "float" and quant.noise_lsb > 0.0
        widest = max((1,) + self.prefill_chunks)
        self._staging = Staging(
            PassIO.n_words(capacity, widest, self.runner.n_seeds(quant),
                           self.max_pages), depth, self.device)
        self._admit_staging = None      # the admission pass's (enc-dec)

        self.ticks = 0
        self.scheduler = get_scheduler(policy)
        self.metrics = ServingMetrics(capacity)
        self.tick_time = float(tick_time)
        self._clock = clock             # None => simulated (tick_time/pass)
        self.now = clock() if clock is not None else 0.0
        self._just_finished: List[Request] = []
        self._returned: List[Request] = []  # finalized outside step():
                                            # shed + admission-pass expiries
        self._has_deadlines = False     # set on the first deadline'd request
        #: Host seconds of every delivered pass, by kind ("decode" /
        #: "prefill"), from dispatch to its logits (blocking) or sampled
        #: tokens (overlapped) on the host.
        self.pass_seconds = {"decode": [], "prefill": []}
        # Every delivered pass's host-visible duration feeds the
        # trailing-median straggler model (a shape's first run excluded).
        self.straggler = StragglerMonitor()
        self.metrics.straggler = self.straggler

        # -- fault tolerance (serving.faults) ------------------------------
        # With ``faults=None`` nothing below exists on the hot path.
        self.recovery = bool(recovery)
        self.detect_every = max(1, int(detect_every))
        self._fault_cursor = 0
        self._lost_shard: Optional[int] = None
        self._fault_dirty = False       # unrepaired injected faults live
        if isinstance(faults, FaultConfig):
            faults = faultlib.make_fault_plan(self.params, faults,
                                              tp=tp_size(self.mesh))
        self.fault_plan: Optional[FaultPlan] = faults
        if self.fault_plan is not None:
            # The hot spare the repairs re-program from: a device clone
            # (injection writes the served tensors in place).
            self._params_clean = faultlib.clone_sites(self.params)
            self._fault_sites = faultlib.fault_sites(self.params)
            self._baselines = faultlib.fingerprint_round(self.params,
                                                         self._fault_sites)

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
        with _refused_capture_restores(dev):
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
                                             sample=self.overlap,
                                             max_pages=self.max_pages,
                                             mesh=self.mesh)
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
        if self.runner.needs_admission:
            self._executable(("admit",))
        self._warmed_shapes.clear()

    def _call(self, shape_key: Tuple, key, **fields) -> Tuple[PassIO, bool]:
        """Run one pass: fill its inputs (one host-to-device copy of the
        host fields, the pass's seed table from ``key`` and, paged, the
        host page table; rows in ``prev_mask`` take the previous pass's
        device sample), then replay (or run) it.  Returns (its buffers,
        warmup)."""
        wp, warm = self._executable(shape_key)
        io = wp.io
        if self.paged:
            fields["table"] = self._table
        if self._noisy:
            fields["seeds"] = self.runner.seed_table(key, self.quant)
        self._staging.copy(io.pack(**fields), io.words)
        if fields["prev_mask"].any():
            io.prev.copy_(self._dev_next, non_blocking=True)
        wp.run(self.state)
        return io, warm

    def _admit_pass(self, i: int, req: Request) -> None:
        """The runner's admission pass for slot i (enc-dec: the encoder
        over ``req.features`` into the slot's cross K/V) under the key
        ``fold_in(PRNGKey(seed), uid)``: one host-to-device copy of the
        features, slot and seeds, then the pass (a replay on a GPU)."""
        wp, _ = self._executable(("admit",))
        io = wp.io
        if self._admit_staging is None:
            self._admit_staging = Staging(io.words.numel(), 2, self.device)
        feats = req.features
        feats = (feats.detach().cpu() if isinstance(feats, torch.Tensor)
                 else to_tensor(feats, "cpu"))
        seeds = (self.runner.seed_table(prng.fold_in(
            prng.PRNGKey(self.seed), req.uid), self.quant)
                 if self._noisy else None)
        self._admit_staging.copy(io.pack(feats, i, seeds), io.words)
        wp.run(self.state)

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

    def _clear_ov(self, i: int):
        self._ov_vals[i] = 0
        self._ov_mask[i] = False

    # -- delivery (the stream's consumer side) ----------------------------
    def _account_dispatch(self, i: int, req: Request) -> TokenRec:
        """Host bookkeeping for one device-sampled token the overlapped
        path has NOT seen yet: bump the dispatched count and, when it hits
        the limit, free the slot at once (completion is a count, so the
        next admission can reuse the slot while the token is in flight)."""
        req.dispatched += 1
        finishing = req.dispatched >= self._limit(i, req)
        if finishing:
            # Device passes run in dispatch order, so pages released here
            # cannot be overwritten before this pass's writes land.
            self.slots[i] = None
            self._release_slot(i, req.tenant)
        return TokenRec(slot=i, req=req, finishing=finishing,
                        corrupted=self._fault_dirty)

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
            if rec.corrupted:
                self.metrics.on_corrupted(req.uid)
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
        no-op on the blocking path).  Called before anything that must see
        COMPLETE token streams: preemption replay snapshots, deadline
        expiry, fault requeues and reshards."""
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

    def _feed(self, req: Request) -> List[int]:
        """The token stream this request prefills from: the preemption
        replay (prompt + tokens already streamed) when resuming, else the
        prompt."""
        return req.replay if req.replay is not None else req.prompt

    def _limit(self, i: int, req: Request) -> int:
        """Tokens slot i's request may generate: its max_new_tokens, or
        less when it was admitted in degraded mode."""
        if self.paged and self._slot_cap[i] is not None:
            return min(req.max_new_tokens, self._slot_cap[i])
        return req.max_new_tokens

    def fits(self, req: Request) -> bool:
        """A request needs a non-empty prompt and must leave room for at
        least one generated token: prompt + max(1, max_new) <= max_len,
        unless the runner's state is fixed-size (recurrent families: no
        cache bound).  Under paging the bound is the page budget instead:
        the page table must address the request and the pool (at full
        eviction) grow it."""
        if len(req.prompt) < 1:
            return False
        total = len(req.prompt) + max(1, req.max_new_tokens)
        if not self.paged:
            return self.runner.fixed_state or total <= self.max_len
        need = self.runner.capacity_cost(total, self.page_size)
        return need <= self.max_pages and need <= self.pool.num_pages

    def _should_shed(self, at: float) -> bool:
        """Admission backpressure for a request arriving NOW: shed when the
        queue is past its watermark, or when the pool is past the high
        pressure watermark and the queue already covers the batch."""
        if (self.queue_watermark is not None
                and self.scheduler.pending(at) >= self.queue_watermark):
            return True
        return (self.paged and self.pool.pressure() >= self.page_watermarks[0]
                and self.scheduler.pending(at) >= self.capacity)

    def _retry_after(self, at: float) -> float:
        """The engine-clock time a shed client should retry at: backlog /
        capacity service rounds at the observed mean E2E (8 ticks before
        any request has finished)."""
        fin = [r.e2e for r in self.metrics.finished() if r.e2e is not None]
        est = float(np.mean(fin)) if fin else self.tick_time * 8
        backlog = self.scheduler.pending(at) + sum(
            1 for s in self.slots if s is not None)
        return at + est * max(1.0, backlog / max(1, self.capacity))

    def submit(self, req: Request) -> bool:
        """Enqueue a request for arrival-driven admission (``arrival_time``
        defaults to now).  Oversized requests are rejected (marked done,
        recorded in metrics); under the backpressure watermarks an arriving
        request is SHED (``shed`` with a ``retry_after`` hint, returned by
        the next ``poll()``).  A request the runner does not accept (an
        encoder-decoder's without features of its shape) is rejected too.
        Returns False for each."""
        if not self.fits(req) or not self.runner.accepts(req):
            req.done = True
            self.metrics.on_reject(req.uid)
            return False
        if req.arrival_time is None:
            req.arrival_time = self.now
        if req.arrival_time <= self.now and self._should_shed(
                req.arrival_time):
            req.done = True
            req.shed = True
            req.retry_after = self._retry_after(req.arrival_time)
            self.metrics.on_shed(req.uid, tenant=req.tenant,
                                 retry_after=req.retry_after)
            self._returned.append(req)
            return False
        if req.deadline is not None:
            self._has_deadlines = True
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
                self._clear_ov(i)   # stale override from a past occupant
                self.slots[i] = req
                if req.arrival_time is None:
                    req.arrival_time = self.now
                if req.deadline is not None:
                    self._has_deadlines = True
                self.metrics.on_admit(req.uid, self.now, tenant=req.tenant,
                                      prompt_len=len(req.prompt),
                                      arrival_time=req.arrival_time)
                if self.paged:
                    self._table[i, :] = self.pool.sentinel
                    self._slot_pages[i] = []
                    self._slot_len[i] = 0
                    self._slot_keys[i] = []
                    # Degraded mode caps generation for admissions made
                    # under pressure (never below what a resumed request
                    # already streamed).
                    self._slot_cap[i] = None
                    if self._degraded and self.degraded_max_new is not None:
                        self._slot_cap[i] = max(self.degraded_max_new,
                                                len(req.generated) + 1)
                if self.runner.needs_admission:
                    self._admit_pass(i, req)
                if self.chunked:
                    req.prompt_pos = 0      # consumed by prefill passes
                    if self.prefix_enabled:
                        self._attach_prefix(i, req)
                else:
                    # Prefill-in-decode: one prompt token per tick.
                    self._set_next(i, self._feed(req)[0])
                    req.prompt_pos = 1
                return True
        return False

    def _admissible(self, req: Request) -> bool:
        """Pop-time admission filter: the tenant's page quota and some
        pool room.  Requests failing it are SKIPPED, not dequeued, so one
        greedy tenant never blocks the rest of the queue."""
        return self._quota_ok(req) and self.pool.available() >= 1

    def _quota_ok(self, req: Request) -> bool:
        """Per-tenant page quota against PROJECTED footprints: each live
        slot of the tenant is charged its full eventual pages (pages grow
        lazily, so current holdings would let a tenant admit several
        requests "under quota" in one pass).  A tenant with nothing in
        flight always passes: a quota throttles, it never starves."""
        if self.tenant_quota is None or self.pool is None:
            return True
        live = [r for r in self.slots
                if r is not None and r.tenant == req.tenant]
        if not live and self.pool.tenant_held(req.tenant) == 0:
            return True
        charged = sum(
            self.runner.capacity_cost(
                len(r.prompt) + max(1, r.max_new_tokens), self.page_size)
            for r in live)
        remaining = max(1, req.max_new_tokens - len(req.generated))
        need = self.runner.capacity_cost(
            len(self._feed(req)) + remaining, self.page_size)
        return charged + need <= self.tenant_quota

    def _admit_arrived(self) -> List[Request]:
        """Fill free slots from the queue (policy order) with requests that
        have arrived by the current clock.  Queue expiry runs first: a
        requeued request whose deadline has passed is timed out, never
        re-admitted."""
        if self._has_deadlines:
            self._returned.extend(self._expire_queue())
        admitted: List[Request] = []
        free = self.slots.count(None)
        while free > 0:
            req = self.scheduler.pop(
                self.now, self._admissible if self.paged else None)
            if req is None:
                break
            self.try_admit(req)     # a slot is free; fits() held at submit
            admitted.append(req)
            free -= 1
        if self.paged and self.preemption:
            self._priority_claim(admitted)
        return admitted

    def _priority_claim(self, admitted: List[Request]):
        """Under saturation a strictly-higher-priority arrival claims a
        slot (and its pages) by preempting the lowest-priority live
        request; ties and lower priorities wait their turn."""
        while True:
            top = self.scheduler.peek(self.now, self._quota_ok)
            if top is None:
                return
            if self.slots.count(None) and self.pool.available() >= 1:
                return              # normal admission will take it
            victims = [i for i, s in enumerate(self.slots)
                       if s is not None and s.priority < top.priority]
            if not victims:
                return
            self._preempt_slot(min(victims, key=self._victim_key))
            self.scheduler.remove(top)
            self.try_admit(top)
            admitted.append(top)

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
        if self._fault_dirty:
            # Computed against faulted weights no detection round has
            # repaired yet: the output cannot be trusted (cleared if
            # recovery later requeues the request).
            self.metrics.on_corrupted(req.uid)
        if req.on_token is not None:
            req.on_token(req, nxt)
        if len(req.generated) >= self._limit(i, req):
            req.done = True
            self.slots[i] = None            # free for the next request
            self._release_slot(i, req.tenant)
            self.metrics.on_finish(req.uid, self.now)
            self._just_finished.append(req)

    # -- paged pool management --------------------------------------------
    def _release_slot(self, i: int, tenant: str):
        """Return slot i's pages to the pool and clear its host mirrors
        (pages the prefix cache also holds stay allocated for reuse)."""
        if not self.paged:
            return
        if self._slot_pages[i]:
            self.pool.release(self._slot_pages[i], tenant)
        self._slot_pages[i] = []
        self._slot_len[i] = 0
        self._slot_keys[i] = []
        self._slot_cap[i] = None
        self._table[i, :] = self.pool.sentinel

    def _victim_key(self, i: int) -> Tuple:
        """Preemption order: lowest priority, then youngest arrival, then
        largest uid."""
        s = self.slots[i]
        return (s.priority, -(s.arrival_time or 0.0), -s.uid)

    def _preempt_slot(self, i: int):
        """Evict slot i to the queue with a recompute plan: its pages go
        back to the pool now, and ``req.replay`` snapshots prompt + every
        token already streamed, so the resume prefills the same stream."""
        self.sync()     # the replay snapshot needs every in-flight token
        req = self.slots[i]
        self.slots[i] = None
        self._next_input[i] = 0
        self._clear_ov(i)
        self._release_slot(i, req.tenant)
        req.replay = list(req.prompt) + list(req.generated)
        req.prompt_pos = 0
        req.preempted += 1
        self.metrics.on_preempt(req.uid, self.now)
        self.scheduler.requeue(req)

    def _preempt_for(self, req: Request) -> bool:
        """Free pages for ``req`` by preempting a live victim that does not
        outrank it (strictly lower priority, or the same priority and not
        older).  False when there is none."""
        cand = [i for i, s in enumerate(self.slots)
                if s is not None and s is not req
                and (s.priority < req.priority
                     or (s.priority == req.priority
                         and (s.arrival_time or 0.0)
                         >= (req.arrival_time or 0.0)))]
        if not cand:
            return False
        self._preempt_slot(min(cand, key=self._victim_key))
        return True

    def _chunk_cap(self) -> int:
        """Largest prefill chunk this pass: degraded mode drops to the
        smallest bucket so admission bursts stay small under pressure."""
        if self.paged and self._degraded:
            return self.prefill_chunks[0]
        return self.prefill_chunks[-1] if self.prefill_chunks else 1

    def _update_degraded(self):
        """Hysteretic degraded mode: enter at the high pool-pressure
        watermark, leave only at the low one."""
        hi, lo = self.page_watermarks
        p = self.pool.pressure()
        if not self._degraded and p >= hi:
            self._degraded = True
            self.metrics.on_degraded(True, self.now)
        elif self._degraded and p <= lo:
            self._degraded = False
            self.metrics.on_degraded(False, self.now)

    def _grow_slot(self, i: int, req: Request, need: int) -> bool:
        """Make slot i's next ``need`` positions writable: split shared
        pages in the write range (copy-on-write), allocate missing pages,
        and when the pool is dry preempt non-outranking victims (slot i
        itself last, returning False)."""
        extra, writes = plan_chunk(self._slot_len[i], need,
                                   self._slot_pages[i], self.page_size)
        for j in writes:
            p = self._slot_pages[i][j]
            newp = self.pool.cow(p, req.tenant)
            while newp is None:
                if not self._preempt_for(req):
                    self._preempt_slot(i)
                    return False
                newp = self.pool.cow(p, req.tenant)
            if newp != p:
                self.state = self._copy_page_fn(self.state, p, newp)
                self._slot_pages[i][j] = newp
                self._table[i, j] = newp
                self.metrics.on_cow()
        while extra > 0:
            got = self.pool.alloc(extra, req.tenant)
            if got is not None:
                base = len(self._slot_pages[i])
                self._table[i, base:base + len(got)] = got
                self._slot_pages[i].extend(got)
                break
            if not self._preempt_for(req):
                self._preempt_slot(i)
                return False
        return True

    def _ensure_pages(self, live: List[int]) -> List[int]:
        """Before a pass, give every live slot writable pages for the
        tokens it is about to append; higher-priority, older slots claim
        first, so exhaustion preempts the requests that should yield.
        Returns the surviving live slots."""
        cap = self._chunk_cap()
        order = sorted(live, key=lambda i: (-self.slots[i].priority,
                                            self.slots[i].arrival_time or 0.0,
                                            self.slots[i].uid))
        for i in order:
            req = self.slots[i]
            if req is None:
                continue            # preempted by an earlier claimant
            rem = len(self._feed(req)) - req.prompt_pos
            self._grow_slot(i, req, min(rem, cap) if rem > 0 else 1)
        return [i for i in live if self.slots[i] is not None]

    def _attach_prefix(self, i: int, req: Request):
        """Prefix-cache attach at admission: walk the prompt's full-page
        chain keys through the pool's cache; every hit is SHARED, never
        re-prefilled.  A whole-prompt hit backs off one token, which is
        re-fed to produce the first logits (its write splits the shared
        last page)."""
        toks = self._feed(req)
        key = None
        matched: List[Tuple[int, int]] = []
        pos = 0
        while pos + self.page_size <= len(toks):
            key = prefix_key(key, toks[pos:pos + self.page_size])
            p = self.pool.lookup(key)
            if p is None:
                break
            matched.append((key, p))
            pos += self.page_size
        if not matched:
            return
        pages = [p for _, p in matched]
        self.pool.share(pages, req.tenant)
        self._slot_pages[i] = pages
        self._slot_keys[i] = [k for k, _ in matched]
        self._table[i, :len(pages)] = pages
        attached = min(pos, len(toks) - 1)
        self._slot_len[i] = attached
        req.prompt_pos = attached
        self.state = self._attach_fn(self.state, i, attached)
        self.metrics.on_prefix(len(matched))

    def _register_prefix(self, i: int, req: Request):
        """Publish slot i's fully prefilled PROMPT pages under their chain
        keys (fresh requests only: a replay would put generated tokens in
        the cache)."""
        if req.replay is not None:
            return
        full = min(req.prompt_pos, len(req.prompt)) // self.page_size
        while len(self._slot_keys[i]) < full:
            j = len(self._slot_keys[i])
            block = req.prompt[j * self.page_size:(j + 1) * self.page_size]
            prev = self._slot_keys[i][-1] if self._slot_keys[i] else None
            key = prefix_key(prev, block)
            self._slot_keys[i].append(key)
            if j < len(self._slot_pages[i]):
                self.pool.register(key, self._slot_pages[i][j])

    # -- deadlines --------------------------------------------------------
    def _expire_slots(self):
        """Cancel in-flight requests past their deadline and free their
        slots at once (the next admission resets the state)."""
        for i, req in enumerate(self.slots):
            if (req is not None and req.deadline is not None
                    and req.deadline <= self.now):
                self.slots[i] = None
                self._release_slot(i, req.tenant)
                req.done = True
                req.timed_out = True
                self.metrics.on_timeout(req.uid, self.now)
                self._just_finished.append(req)

    def _expire_queue(self) -> List[Request]:
        """Time out queued requests whose deadline already passed."""
        expired = self.scheduler.expire(self.now)
        for req in expired:
            req.done = True
            req.timed_out = True
            self.metrics.on_timeout(req.uid, self.now)
        return expired

    # -- fault tolerance --------------------------------------------------
    def _inject_due_faults(self):
        """Apply every fault event scheduled at or before the current tick,
        in place into the served operands (``serving.faults``)."""
        due, self._fault_cursor = self.fault_plan.due(
            self.ticks, self._fault_cursor)
        for ev in due:
            if ev.kind == "shard_drop":
                # The injectable host-failure signal: recovery reads it as
                # a health-check verdict.
                self._lost_shard = ev.shard
            faultlib.apply_event(self.params, ev, tp=tp_size(self.mesh),
                                 quant=self.quant, mesh=self.mesh)
            self.metrics.on_fault(ev.kind)
            self._fault_dirty = True

    def _detect_and_recover(self):
        """One detection round: fingerprint every fault site against its
        healthy baseline (one device-to-host copy); with recovery on,
        repair what was found (re-quantize drifted tiles, remap stuck
        columns) and requeue the requests it corrupted, or on a lost-shard
        signal re-program the array and requeue everything in flight."""
        self.sync()     # requeues read complete streams + corruption marks
        if self._lost_shard is not None and self.recovery:
            self._reshard_and_requeue()
            return
        cur = faultlib.fingerprint_round(self.params, self._fault_sites)
        hits = []
        for site in self._fault_sites:
            det = faultlib.detect_site(self._baselines[site.path],
                                       cur[site.path])
            if not det.clean:
                hits.append((site, det))
        if hits:
            self.metrics.on_detected(sum(
                len(d.stuck_cols) + len(d.drifted) for _, d in hits))
        if not self.recovery:
            return
        for site, det in hits:
            if det.stuck_cols:
                faultlib.repair_stuck(self.params, self._params_clean,
                                      site.path, det.stuck_cols)
                self.metrics.on_repair("cols_remapped", len(det.stuck_cols))
            if det.drifted:
                faultlib.repair_drift(self.params, self._params_clean,
                                      site.path, det.drifted)
                self.metrics.on_repair("tiles_requantized", len(det.drifted))
        if hits:
            # Tokens of the dirty window came from faulted weights: with
            # recovery on they are discarded and the request re-decoded
            # from the repaired array (a shipped token is gone, so only
            # requests in flight can be salvaged).
            self._requeue_corrupted()
        self._fault_dirty = False

    def _requeue_corrupted(self):
        """Restart the requests in flight whose output (and KV cache) was
        produced under a live fault: free the slot, clear the generated
        tokens, requeue (arrival order is kept, so they re-admit ahead of
        younger traffic)."""
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            rec = self.metrics.requests.get(req.uid)
            if rec is None or not rec.corrupted:
                continue
            self.slots[i] = None
            self._next_input[i] = 0
            self._clear_ov(i)
            self._release_slot(i, req.tenant)
            self._restart(req)

    def _restart(self, req: Request):
        """Requeue ``req`` to run again from its prompt."""
        req.prompt_pos = 0
        req.generated.clear()
        req.dispatched = 0
        req.replay = None
        self.metrics.on_requeue(req.uid)
        self.scheduler.requeue(req)

    def _reshard_and_requeue(self):
        """Shard-drop recovery: on a mesh, re-plan it without the lost
        model bank (``plan_recovery_mesh``, as the JAX engine); then
        re-program every site from the clean spare, reset the decode
        state, rebuild the page pool when paged, and requeue every
        request in flight (conservation holds over the whole trace).

        The spare and a fresh state are copied INTO the served tensors in
        place: every captured graph keeps reading valid buffers, so no
        pass is dropped or captured again; only a plan that narrows the
        model axis places the weights anew (``_replace_weights``)."""
        self._lost_shard = None
        faultlib.restore_sites(self.params, self._params_clean)
        if self.mesh is not None and self.mesh.size > 1:
            dp, tp = self.mesh.devices.shape
            plan = plan_recovery_mesh(dp * tp - dp, tp, (dp, tp))
            keep = list(self.mesh.devices.flat)[
                :plan.new_shape[0] * plan.new_shape[1]]
            self.mesh = Mesh(np.asarray(keep, dtype=object).reshape(
                plan.new_shape), self.mesh.axis_names)
            if plan.new_shape[1] != tp:
                self._replace_weights()
        fresh = self.runner.init_state(
            self.capacity, self.max_len, self.device,
            page_size=self.page_size if self.paged else None,
            pool_pages=self.pool.num_pages if self.paged else None)
        for t, src in zip(state_tensors(self.state), state_tensors(fresh)):
            t.copy_(src)
        del fresh
        if self.paged:
            # The lost state's pages died with it: rebuild the allocator
            # (prefix cache included) from scratch.
            self.pool = PagePool(self.pool.num_pages, self.page_size)
            self._table = page_table_array(self.capacity, self.max_pages,
                                           self.pool.sentinel)
            self._slot_pages = [[] for _ in range(self.capacity)]
            self._slot_len = [0] * self.capacity
            self._slot_keys = [[] for _ in range(self.capacity)]
            self._slot_cap = [None] * self.capacity
        inflight = [r for r in self.slots if r is not None]
        self.slots = [None] * self.capacity
        self._next_input[:] = 0
        self._ov_vals[:] = 0
        self._ov_mask[:] = False
        for req in inflight:
            self._restart(req)
        self.metrics.on_repair("reshards", 1)
        self._fault_dirty = False

    def _replace_weights(self):
        """Place the whole packed tree on the (narrower) recovery mesh,
        take a new spare, and drop every built pass: each is built (and
        captured) again at its next use.  The served tree's replicated
        leaves are the whole tree's own, repaired in place just before."""
        self.params = shard_serving_params(self._params_whole, self.mesh,
                                           self.quant)
        self._params_clean = faultlib.clone_sites(self.params)
        self._passes = {}
        self._warmed_shapes = set()
        self._dev_next = None

    # -- one engine tick ------------------------------------------------------
    def step(self):
        self._just_finished = []
        if self._has_deadlines:
            if self.overlap:
                self.sync()     # cancel only COMPLETE streams
            self._expire_slots()
            self._just_finished.extend(self._expire_queue())
        if self.fault_plan is not None:
            # Detect (and repair) faults of earlier ticks BEFORE this
            # tick's injections land, so every fault is live for at least
            # one pass; then inject what the plan schedules now.
            if self.ticks % self.detect_every == 0 and (
                    self._fault_dirty or self._lost_shard is not None):
                self._detect_and_recover()
            self._inject_due_faults()
        live = [i for i, s in enumerate(self.slots) if s is not None]
        if self.paged:
            self._update_degraded()
            if live:
                # Claim, split and grow pages for every token this pass
                # appends; pool exhaustion preempts here, before the pass.
                live = self._ensure_pages(live)
        if not live:
            return
        self.metrics.on_tick(self.now, len(live), self.capacity,
                             self.scheduler.pending(self.now),
                             pool=self.pool.stats() if self.paged else None,
                             degraded=self._degraded)
        prefilling = [i for i in live
                      if self.slots[i].prompt_pos
                      < len(self._feed(self.slots[i]))]
        if self.chunked and prefilling:
            if all(len(self._feed(self.slots[i])) - self.slots[i].prompt_pos
                   == 1 for i in prefilling):
                # Every prefilling slot has exactly ONE prompt token left:
                # feed it as the decode input instead of a padded chunk.
                for i in prefilling:
                    req = self.slots[i]
                    self._set_next(i, self._feed(req)[req.prompt_pos])
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
        cap = self._chunk_cap()
        need = np.zeros((self.capacity,), np.int32)
        for i in live:
            req = self.slots[i]
            rem = len(self._feed(req)) - req.prompt_pos
            need[i] = min(rem, cap) if rem > 0 else 1
        bucket = next(c for c in self.prefill_chunks if c >= need.max())

        tokens = np.zeros((self.capacity, bucket), np.int32)
        riders = np.zeros((self.capacity,), bool)
        for i in live:
            req = self.slots[i]
            toks = self._feed(req)
            if req.prompt_pos < len(toks):
                n = int(need[i])
                tokens[i, :n] = toks[req.prompt_pos:req.prompt_pos + n]
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
                      if (len(self._feed(self.slots[i]))
                          - self.slots[i].prompt_pos <= int(need[i]))]
        if not self.overlap:
            lg = (self._fetch_logits("prefill", t0, io.logits, warm)
                  if recipients else None)
        self._tick_clock()
        if self.paged:
            for i in live:
                self._slot_len[i] += int(need[i])
        recs: List[TokenRec] = []
        for i in live:
            req = self.slots[i]
            toks = self._feed(req)
            if req.prompt_pos < len(toks):
                req.prompt_pos += int(need[i])
                if self.prefix_enabled:
                    self._register_prefix(i, req)
                if req.prompt_pos < len(toks):
                    continue        # still prefilling; logits unused
            # Prompt just completed (logits are at its last prompt token)
            # or the slot was decoding: sample either way.
            if self.overlap:
                recs.append(self._account_dispatch(i, req))
            else:
                self._record(i, req, lg[i])
        if self.overlap:
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
                      >= len(self._feed(self.slots[i]))]
        if not self.overlap:
            lg = (self._fetch_logits("decode", t0, io.logits, warm)
                  if recipients else None)
        self._tick_clock()
        if self.paged:
            for i in fed:
                self._slot_len[i] += 1
        recs: List[TokenRec] = []
        for i in fed:
            req = self.slots[i]
            toks = self._feed(req)
            if req.prompt_pos < len(toks):
                # prefill-in-decode: feed the next prompt token
                self._set_next(i, toks[req.prompt_pos])
                req.prompt_pos += 1
            elif self.overlap:
                recs.append(self._account_dispatch(i, req))
            else:
                self._record(i, req, lg[i])
        if self.overlap:
            self._submit("decode", t0, warm, io, recs)

    # -- open-loop API ----------------------------------------------------
    def poll(self) -> List[Request]:
        """One arrival-driven round: sync the clock, admit every arrived
        request the policy picks, run one ``step()``.  Returns the requests
        that finished during this poll (on the overlapped path: whose last
        token was delivered), plus those finalized outside a step since the
        last poll: shed submissions and queued requests that timed out in
        an admission pass.  With the simulated clock an idle engine jumps
        to the next arrival; with a wall clock it naps (capped) and
        re-reads the clock."""
        if self._clock is not None:
            self.now = self._clock()
        out = self._returned
        self._returned = []
        out.extend(self._drain_delivered())
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
        """Poll until the queue, every slot, the in-flight stream and the
        returned buffer are empty; returns finished requests in completion
        order."""
        finished: List[Request] = []
        while (len(self.scheduler)
               or any(s is not None for s in self.slots)
               or self._returned
               or self._stream.pending()
               or self._delivered):
            finished.extend(self.poll())
        return finished

    def run(self, requests: List[Request]) -> List[Request]:
        """Serve a static workload to completion under the engine's policy.
        Oversized requests are rejected up front (marked done, nothing
        generated) and returned first; shed requests come back through
        ``drain()``'s polls, so nothing is returned twice."""
        finished: List[Request] = []
        for r in requests:
            if not self.submit(r) and not r.shed:
                finished.append(r)
        finished.extend(self.drain())
        return finished

    def pass_stats(self) -> Tuple[dict, dict]:
        """By pass kind ("decode" / "prefill"): the median host seconds
        per pass (None before the first), and the number of passes."""
        return {k: (float(np.median(v)) if v else None)
                for k, v in self.pass_seconds.items()}, \
            {k: len(v) for k, v in self.pass_seconds.items()}
