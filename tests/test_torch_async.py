"""The port's overlapped serving runtime and warmed passes, on the CPU: the
analogues of ``tests/test_async.py``.

The simulated-clock blocking engine and the wall-clock overlapped engine
(``overlap=True``: sampling on the device, dispatch ahead of delivery over
a bounded queue) must emit the same greedy streams in ``float``,
``abfp_packed`` and ``abfp_fused`` (tile 32, gain 4, noise 0.5).  On the
CPU every pass runs eagerly through the same runner code as the card's
CUDA graphs (``tests/test_torch_cuda.py`` holds a replay against an eager
pass).  Temperature streams of the overlapped port equal the JAX
overlapped engine's in float mode: the port's device sampler draws JAX's
Gumbel noise bit for bit, so a token can differ only where the two sides'
logits (equal to f32 rounding) or ``log`` (last bit) part a near tie; the
engine seed below is pinned as the other stream tests pin theirs.

Also here: the three sync regressions of the JAX suite (no host sync on a
mid-prompt pass, no straggler sample from a shape's first run, the clock
re-read after an idle nap), the bounded stream, the utilization gauge,
and that a pass keeps every state tensor's storage (a captured graph
reads its state at fixed addresses).

The preemption-resume overlap case is in ``tests/test_torch_overload.py``.
The fault-recovery case runs a workload long enough for the plan's events
to land (the JAX suite's four short requests end before its first).  No
analogue yet: the mesh overlap cases of the JAX suite (ROADMAP queue 1
item 5).
"""

import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.models import init_params as j_init_params
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import smoke_config
from repro_torch.core.abfp import QuantConfig
from repro_torch.distributed.fault import StragglerMonitor
from repro_torch.models import init_params
from repro_torch.models.convert import from_jax_params
from repro_torch.serving import (
    DeviceStream,
    FaultConfig,
    OverlappedStream,
    Request,
    ServingEngine,
    ServingMetrics,
)
from repro_torch.serving.runners import state_tensors
from repro_torch.serving.stream import Ticket

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker

FLOAT = QuantConfig(mode="float")
PACKED = QuantConfig(mode="abfp_packed", tile_width=32, gain=4.0,
                     noise_lsb=0.5)
FUSED = QuantConfig(mode="abfp_fused", tile_width=32, gain=4.0,
                    noise_lsb=0.5)

# Prompts straddle the (4, 8) prefill buckets plus a single-token prompt
# (the decode-tick admission path), as in the JAX suite.
PROMPTS = [[3, 5, 7, 9, 11], [2, 4, 6], [8, 1, 2, 3, 4, 5, 6, 7, 9], [13]]
# The engine seed of the temperature parity against JAX (see above).
TEMP_SEED = 11


@pytest.fixture(scope="module")
def tiny():
    mcfg = smoke_config("smollm-360m")
    return init_params(0, mcfg, device="cpu"), mcfg


@pytest.fixture(scope="module")
def tinyllama():
    mcfg = smoke_config("tinyllama-1.1b")
    return init_params(0, mcfg, device="cpu"), mcfg


def _reqs(n=4, *, prompts=None, max_new=4, temp=0.0, arrival=0.0,
          cls=Request):
    prompts = prompts if prompts is not None else PROMPTS[:n]
    return [cls(uid=i, prompt=list(p), max_new_tokens=max_new,
                temperature=temp, arrival_time=arrival)
            for i, p in enumerate(prompts)]


def _outs(done):
    return {r.uid: tuple(r.generated) for r in done}


def _engine(params, mcfg, **kw):
    kw = dict(dict(capacity=4, max_len=64, seed=0, prefill_chunks=(4, 8),
                   device="cpu"), **kw)
    return ServingEngine(params, mcfg, **kw)


@pytest.mark.parametrize("quant", [FLOAT, PACKED, FUSED],
                         ids=["float", "abfp_packed", "abfp_fused"])
def test_overlap_parity_single_device(tinyllama, quant):
    params, mcfg = tinyllama
    mcfg = (dataclasses.replace(mcfg, kv_quant=True)
            if quant.mode == "abfp_fused" else mcfg)
    ref = _outs(_engine(params, mcfg, quant=quant).run(_reqs()))
    eng = _engine(params, mcfg, quant=quant, clock=time.perf_counter,
                  overlap=True)
    eng.warmup()
    got = _outs(eng.run(_reqs()))
    eng.close()
    assert got == ref
    assert all(len(v) == 4 for v in got.values())
    assert eng.metrics.conservation()["ok"]
    assert set(eng._passes) == {("decode",), ("prefill", 4), ("prefill", 8)}
    assert eng._warmed_shapes <= set(eng._passes)


@pytest.mark.parametrize("quant", [PACKED, FUSED],
                         ids=["abfp_packed", "abfp_fused"])
def test_overlap_parity_fault_recovery(tiny, quant):
    """A fault plan injecting and recovering mid-trace: detection rounds
    run on the tick cadence (clock-independent), recovery syncs the
    pipeline, and the requeued re-executions land on the blocking
    engine's streams."""
    params, mcfg = tiny
    mcfg = (dataclasses.replace(mcfg, kv_quant=True)
            if quant.mode == "abfp_fused" else mcfg)
    kw = dict(quant=quant, faults=FaultConfig(rate=0.05, seed=3, horizon=64),
              recovery=True, detect_every=2)

    def reqs():
        return _reqs(prompts=PROMPTS * 2, max_new=12)

    ref_eng = _engine(params, mcfg, **kw)
    ref = _outs(ref_eng.run(reqs()))
    eng = _engine(params, mcfg, clock=time.perf_counter, overlap=True, **kw)
    eng.warmup()
    got = _outs(eng.run(reqs()))
    eng.close()
    assert got == ref
    assert eng.metrics.faults == ref_eng.metrics.faults
    assert eng.metrics.faults["injected"] >= 1
    assert eng.metrics.summary()["requests"]["requeued"] >= 1
    assert eng.metrics.conservation()["ok"]
    assert all(len(v) == 12 for v in got.values())


def test_overlap_temperature_reproducible_and_equal_to_jax():
    """Temperature sampling on the overlapped path draws from the device
    stream keyed (seed, uid, token_idx): two runs match, temperature 0 is
    greedy, and the streams equal the JAX overlapped engine's."""
    jm, tm = j_smoke_config("smollm-360m"), smoke_config("smollm-360m")
    jp = j_init_params(jax.random.PRNGKey(0), jm)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tm, device="cpu")
    kw = dict(capacity=4, max_len=64, seed=TEMP_SEED, prefill_chunks=(4, 8),
              clock=time.perf_counter, overlap=True)

    def run_once(temp):
        eng = ServingEngine(tp, tm, device="cpu", **kw)
        out = _outs(eng.run(_reqs(max_new=6, temp=temp)))
        eng.close()
        # Passes with a temperature row run their shape's "draw" variant.
        assert any(k[-1] == "draw" for k in eng._passes) == (temp > 0)
        return out

    a, b = run_once(0.8), run_once(0.8)
    assert a == b
    g = run_once(0.0)
    assert any(a[u] != g[u] for u in a)     # temperature actually sampled
    jeng = JServingEngine(jp, jm, **kw)
    j = _outs(jeng.run(_reqs(max_new=6, temp=0.8, cls=JRequest)))
    jeng.close()
    assert a == j


def test_overlap_streaming_callbacks_in_order(tiny):
    params, mcfg = tiny
    seen = {}
    reqs = _reqs(max_new=5)
    for r in reqs:
        r.on_token = lambda req, tok: seen.setdefault(req.uid,
                                                      []).append(tok)
    eng = _engine(params, mcfg, clock=time.perf_counter, overlap=True)
    done = eng.run(reqs)
    eng.close()
    assert {u: tuple(t) for u, t in seen.items()} == _outs(done)


def test_overlap_worker_exception_surfaces(tiny):
    params, mcfg = tiny
    req = Request(uid=0, prompt=[1, 2, 3], max_new_tokens=4,
                  arrival_time=0.0)
    req.on_token = lambda r, t: (_ for _ in ()).throw(RuntimeError("boom"))
    eng = _engine(params, mcfg, capacity=1, max_len=32,
                  clock=time.perf_counter, overlap=True)
    eng.submit(req)
    with pytest.raises(RuntimeError, match="boom"):
        eng.drain()
    eng._stream._exc = None      # don't re-raise during close
    eng.close()


def test_midprompt_prefill_pass_does_not_host_sync(tiny):
    """prompt = 20 tokens through chunk-4 buckets is 5 prefill passes; only
    the last yields a token, so the blocking engine fetches logits once
    per recorded token."""
    params, mcfg = tiny
    prompt = [(3 * j) % 97 + 1 for j in range(20)]
    eng = _engine(params, mcfg, capacity=1, prefill_chunks=(4,))
    out = _outs(eng.run([Request(uid=0, prompt=prompt, max_new_tokens=3,
                                 arrival_time=0.0)]))
    assert isinstance(eng._stream, DeviceStream)
    assert eng._stream.host_syncs == 3
    assert len(out[0]) == 3


class _SpyMonitor(StragglerMonitor):
    def __init__(self):
        super().__init__()
        self.samples = []

    def observe(self, step_time):
        self.samples.append(step_time)
        return super().observe(step_time)


def test_straggler_excludes_fresh_bucket_warmup(tiny):
    """A fresh prefill bucket mid-trace on a fake perf clock where each
    shape's first execution costs +99 s: the monitor sees only
    steady-state samples, and flags none."""
    params, mcfg = tiny
    eng = _engine(params, mcfg, capacity=1)
    spy = _SpyMonitor()
    eng.straggler = spy
    eng.metrics.straggler = spy
    t = [0.0]

    def fake_perf():
        t[0] += 0.0005
        return t[0]

    eng._perf = fake_perf
    orig = eng._executable

    def slow_first_run(shape_key):
        wp, warm = orig(shape_key)
        if warm:
            t[0] += 99.0
        return wp, warm

    eng._executable = slow_first_run
    reqs = [Request(uid=0, prompt=[1, 2, 3, 4], max_new_tokens=8,
                    arrival_time=0.0),
            Request(uid=1, prompt=[5, 6, 7, 8, 9, 10, 11], max_new_tokens=4,
                    arrival_time=0.0)]
    assert len(eng.run(reqs)) == 2
    assert {("decode",), ("prefill", 4), ("prefill", 8)} <= eng._warmed_shapes
    assert spy.samples, "steady-state passes must still feed the monitor"
    assert all(dt < 1.0 for dt in spy.samples), spy.samples
    assert spy.flagged == 0
    assert eng.metrics.summary()["straggler"]["flagged"] == 0


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_poll_resyncs_clock_after_idle_nap(tiny, monkeypatch):
    import repro_torch.serving.engine as engine_mod
    params, mcfg = tiny
    clk = _FakeClock()
    slept = []

    def fake_sleep(dt):
        slept.append(dt)
        clk.t += dt

    monkeypatch.setattr(engine_mod.time, "sleep", fake_sleep)
    eng = _engine(params, mcfg, capacity=1, max_len=32, clock=clk)
    eng.submit(Request(uid=0, prompt=[1, 2, 3], max_new_tokens=1,
                       arrival_time=0.5))
    out = eng.poll()
    assert out == [] and slept, "poll must nap toward the future arrival"
    assert eng.now == clk.t
    eng.submit(Request(uid=1, prompt=[4, 5], max_new_tokens=1))
    assert eng.metrics.requests[1].arrival_time == clk.t


def test_overlapped_stream_bounded_and_drains():
    class Eng:
        def __init__(self):
            self.seen = []

        def _deliver_ticket(self, ticket):
            self.seen.append(ticket.now)

    e = Eng()
    s = OverlappedStream(depth=2)
    for k in range(5):
        s.submit(Ticket(engine=e, t0=0.0, warmup=False, sampled=None,
                        recs=[], now=float(k)))
    s.sync()
    assert e.seen == [0.0, 1.0, 2.0, 3.0, 4.0]
    assert s.pending() == 0
    s.close()
    with pytest.raises(RuntimeError):
        s.submit(Ticket(engine=e, t0=0.0, warmup=False, sampled=None,
                        recs=[], now=9.0))


def test_device_span_union_and_windows():
    m = ServingMetrics()
    m.window_open(0.0)
    m.on_device_span(0.0, 1.0)
    m.on_device_span(0.5, 2.0)      # overlaps: union adds only [1, 2]
    m.on_device_span(3.0, 4.0)      # gap [2, 3] is host-idle inside window
    m.window_close(4.0)
    m.window_open(10.0)             # idle [4, 10] never counted
    m.on_device_span(10.0, 11.0)
    m.window_close(11.0)
    u = m.tick_utilization()
    assert u["device_busy_s"] == pytest.approx(4.0)
    assert u["active_s"] == pytest.approx(5.0)
    assert u["value"] == pytest.approx(0.8)


def test_overlap_feeds_the_gauges(tiny):
    params, mcfg = tiny
    eng = _engine(params, mcfg, clock=time.perf_counter, overlap=True)
    eng.run(_reqs(max_new=6))
    eng.close()
    u = eng.metrics.tick_utilization()
    assert u["value"] is not None and 0.0 < u["value"] <= 1.0 + 1e-9
    med, counts = eng.pass_stats()
    assert counts["decode"] > 0 and counts["prefill"] > 0
    assert eng.metrics.summary()["straggler"]["escalation"] == "log"


@pytest.mark.parametrize("quant", [FLOAT, FUSED], ids=["float", "abfp_fused"])
@pytest.mark.parametrize("shape_key", [("decode",), ("prefill", 4),
                                       ("prefill", 8)],
                         ids=["decode", "prefill4", "prefill8"])
def test_passes_keep_state_storage(tiny, quant, shape_key):
    """Every state tensor keeps its storage across a pass of each shape:
    a CUDA graph reads the state at the addresses it captured."""
    params, mcfg = tiny
    mcfg = dataclasses.replace(mcfg, kv_quant=quant.mode == "abfp_fused")
    eng = _engine(params, mcfg, quant=quant)
    before = [t.data_ptr() for t in state_tensors(eng.state)]
    copies = [t.clone() for t in state_tensors(eng.state)]
    wp, _ = eng._executable(shape_key)
    io = wp.io
    b = eng.capacity
    n = np.array([1, 0, io.width, 2][:b], np.int32)
    rng = np.random.default_rng(0)
    eng._staging.copy(io.pack(tokens=rng.integers(1, 50, (b, io.width)),
                              n_tokens=n, prev_mask=np.zeros(b, bool),
                              temps=np.zeros(b), uids=np.arange(b),
                              idxs=np.zeros(b)), io.words)
    ptrs = [t.data_ptr() for t in (io.words, io.logits, io.sampled)]
    wp.run(eng.state)
    assert [t.data_ptr() for t in state_tensors(eng.state)] == before
    assert [t.data_ptr() for t in (io.words, io.logits, io.sampled)] == ptrs
    # The pass wrote the state in place: positions moved, row 1 of a
    # prefill pass (n_tokens 0) kept its values.
    pos = eng.state["position"]
    if shape_key[0] == "decode":
        assert pos.tolist() == [1] * b
    else:
        assert pos.tolist() == n.tolist()
        for t, c in zip(state_tensors(eng.state), copies):
            assert torch.equal(t[1], c[1])
