"""The port's overload layer against the JAX engine's, on the CPU.

The ``@overload`` cases of ``tests/test_pages.py`` (preemption with
recompute resume, a preempted request timing out, priority page claims,
queue-watermark shedding with ``retry_after``, degraded mode with
hysteresis, tenant quotas) run on the port's paged engine on the simulated
clock.  Each asserts its own property, and every request's record must
equal the JAX engine's on the same requests: generated tokens,
``preempted``, ``shed``, ``retry_after``, ``timed_out``, TTFT in ticks,
plus the engine's tick count and conservation counters.  Weights are the
JAX package's (``repro_torch.models.convert``), numerics float.

The overlapped preemption-resume case (``tests/test_async.py``'s) runs the
port's overlapped engine and the JAX overlapped engine in this process and
compares their streams with each other and with both blocking engines:
the reference's own stream for that case depends on the checkout's
directory (ROADMAP queue 3), so no stream is stored.
"""

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
from repro_torch.models.convert import from_jax_params
from repro_torch.serving import Request, ServingEngine

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker

pytestmark = [pytest.mark.overload]

ARCH = "smollm-360m"


@pytest.fixture(scope="module")
def pair():
    jm, tm = j_smoke_config(ARCH), smoke_config(ARCH)
    jp = j_init_params(jax.random.PRNGKey(0), jm)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tm, device="cpu")
    return (jp, jm), (tp, tm)


def _reqs(cls, n=5, plen=20, max_new=6, seed=0, **kw):
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=[int(t) for t in rng.integers(2, 400, plen)],
                max_new_tokens=max_new, **kw) for i in range(n)]


def _outs(done):
    return {r.uid: list(r.generated) for r in done}


def _records(eng, reqs):
    out = {}
    for r in reqs:
        m = eng.metrics.requests.get(r.uid)
        out[r.uid] = dict(generated=list(r.generated), preempted=r.preempted,
                          shed=r.shed, retry_after=r.retry_after,
                          timed_out=r.timed_out, done=r.done,
                          ttft=None if m is None else m.ttft)
    return out


def _both(pair, make_reqs, drive, **kw):
    """Build the JAX and the port engine with ``kw``, hand each its own
    copy of the workload to ``drive(engine, requests)``, and hold the
    port's per-request records, tick count and conservation counters to
    JAX's.  Returns (port engine, port requests, what drive returned)."""
    (jp, jm), (tp, tm) = pair
    jeng = JServingEngine(jp, jm, **kw)
    jreqs = make_reqs(JRequest)
    drive(jeng, jreqs)
    teng = ServingEngine(tp, tm, device="cpu", **kw)
    treqs = make_reqs(Request)
    got = drive(teng, treqs)
    assert _records(teng, treqs) == _records(jeng, jreqs)
    assert teng.ticks == jeng.ticks
    assert teng.metrics.conservation() == jeng.metrics.conservation()
    return teng, treqs, got


def _run(eng, reqs):
    return eng.run(reqs)


def _submit_drain(eng, reqs):
    for r in reqs:
        assert eng.submit(r)
    return eng.drain()


# ---------------------------------------------------------------------------
# Preemption
# ---------------------------------------------------------------------------


def test_preemption_resumes_bit_identically(pair):
    kw = dict(capacity=4, max_len=64, prefill_chunks=(8,), paged=True,
              page_size=16)
    _, (tp, tm) = pair
    roomy = ServingEngine(tp, tm, device="cpu", **kw)
    ref = _outs(roomy.run(_reqs(Request, 8, plen=20, max_new=8)))
    tight, _, done = _both(pair, lambda c: _reqs(c, 8, plen=20, max_new=8),
                           _run, pool_pages=6, **kw)
    cons = tight.metrics.conservation()
    assert cons["preempted"] > 0            # the pool actually saturated
    assert cons["ok"] and cons["preempt_ok"]
    assert cons["preempted"] == cons["resumed"]     # no deadlines: all resume
    assert _outs(done) == ref               # recompute resume is bit-exact


def test_preempted_request_can_time_out(pair):
    eng, _, done = _both(
        pair, lambda c: _reqs(c, 4, plen=20, max_new=8, deadline=6.0), _run,
        capacity=2, max_len=64, prefill_chunks=(8,), paged=True,
        page_size=16, pool_pages=3)
    cons = eng.metrics.conservation()
    assert cons["ok"] and cons["preempt_ok"]
    assert len(done) == 4
    for r in eng.metrics.requests.values():
        if r.preempts > r.resumes:
            assert r.timed_out


def test_priority_claims_pages_under_saturation(pair):
    def make(cls):
        low = _reqs(cls, 2, plen=16, max_new=24, seed=1)
        for r in low:
            r.arrival_time = 0.0
        return low + [cls(uid=99, prompt=[5, 7, 11, 13], max_new_tokens=4,
                          priority=5, arrival_time=2.0)]

    eng, reqs, done = _both(pair, make, _submit_drain, capacity=2,
                            max_len=64, prefill_chunks=(8,), paged=True,
                            page_size=16, pool_pages=4, policy="priority")
    cons = eng.metrics.conservation()
    assert cons["ok"] and cons["preempt_ok"]
    assert cons["preempted"] > 0            # a low-pri victim yielded
    assert eng.metrics.requests[99].preempts == 0   # never the high-pri
    finish = {r.uid: eng.metrics.requests[r.uid].finish_time for r in done}
    assert finish[99] < max(finish[r.uid] for r in reqs[:2])


# ---------------------------------------------------------------------------
# Backpressure, degraded modes, quotas
# ---------------------------------------------------------------------------


def test_queue_watermark_sheds_with_retry_after(pair):
    def drive(eng, reqs):
        accepted = [r for r in reqs if eng.submit(r)]
        polled = []
        while (len(eng.scheduler) or any(s is not None for s in eng.slots)
               or eng._returned):
            polled.extend(eng.poll())
        return accepted, polled

    eng, reqs, (accepted, polled) = _both(
        pair, lambda c: _reqs(c, 5, plen=8, max_new=4), drive, capacity=1,
        max_len=32, prefill_chunks=(8,), paged=True, page_size=16,
        queue_watermark=2)
    shed = [r for r in reqs if r.shed]
    assert len(shed) >= 1                   # watermark 2 tripped
    for r in shed:
        assert r.done and r.retry_after is not None
        assert r.retry_after > (r.arrival_time or 0.0)
    # Shed requests surface through poll(), exactly once each.
    assert sorted(r.uid for r in polled) == sorted(
        [r.uid for r in accepted] + [r.uid for r in shed])
    cons = eng.metrics.conservation()
    assert cons["ok"] and cons["shed"] == len(shed)
    assert cons["rejected"] == len(shed)    # shed counts as rejected


def test_degraded_mode_caps_tokens_and_recovers_hysteretically(pair):
    eng, _, done = _both(
        pair, lambda c: _reqs(c, 6, plen=16, max_new=8), _run, capacity=2,
        max_len=64, prefill_chunks=(8, 16), paged=True, page_size=8,
        pool_pages=8, page_watermarks=(0.75, 0.25), degraded_max_new=2)
    s = eng.metrics.summary()
    assert s["pool"]["degraded_ticks"] > 0          # pressure tripped hi
    assert s["pool"]["degraded_transitions"] >= 2   # entered AND recovered
    assert any(0 < len(r.generated) <= 2 for r in done)
    assert eng.metrics.conservation()["ok"]
    assert eng.pool.stats().held == 0       # everything released after drain
    eng._update_degraded()                  # next observation of the pool...
    assert not eng._degraded                # ...exits via the lo watermark


def test_tenant_quota_isolates_noisy_neighbor(pair):
    def make(cls):
        noisy = _reqs(cls, 4, plen=20, max_new=6, seed=2, tenant="noisy")
        quiet = _reqs(cls, 2, plen=8, max_new=4, seed=3, tenant="quiet")
        for i, r in enumerate(quiet):
            r.uid = 100 + i
        return noisy + quiet

    def drive(eng, reqs):
        held = {"noisy": 0, "quiet": 0}
        for r in reqs:
            assert eng.submit(r)
        while (len(eng.scheduler) or any(s is not None for s in eng.slots)
               or eng._returned):
            eng.poll()
            for t in held:
                held[t] = max(held[t], eng.pool.tenant_held(t))
        return held

    eng, reqs, held = _both(pair, make, drive, capacity=2, max_len=64,
                            prefill_chunks=(8,), paged=True, page_size=16,
                            pool_pages=8, tenant_quota=2)
    assert eng.metrics.conservation()["ok"]
    assert held["noisy"] <= 2 + 1           # quota + at most one growth page
    assert held["quiet"] >= 1               # the quiet tenant actually ran
    for r in reqs[4:]:
        assert len(r.generated) == 4


def test_deadlines_on_a_paged_engine_match_jax(pair):
    """Deadlines on a third of the requests under a tight pool and the
    priority policy: queued and in-flight expiries, preemptions and
    resumes land on the same requests and ticks as in the JAX engine."""
    def make(cls):
        rs = _reqs(cls, 9, plen=20, max_new=8, seed=5)
        for r in rs:
            r.priority = r.uid % 3
            r.tenant = f"t{r.uid % 2}"
            r.arrival_time = float(r.uid)
            if r.uid % 3 == 0:
                r.deadline = r.arrival_time + 12.0
        return rs

    eng, reqs, done = _both(pair, make, _run, capacity=3, max_len=64,
                            prefill_chunks=(8, 16), paged=True, page_size=16,
                            pool_pages=5, policy="priority")
    cons = eng.metrics.conservation()
    assert cons["ok"] and cons["preempt_ok"]
    assert cons["timed_out"] > 0 and cons["preempted"] > 0
    assert all(r.done for r in reqs)


# ---------------------------------------------------------------------------
# The overlapped engine under preemption (tests/test_async.py's case)
# ---------------------------------------------------------------------------


def test_overlap_preemption_resume_matches_jax_overlapped(pair):
    """A pool tight enough to force preemptions: the port's overlapped
    engine preempts (after syncing its in-flight passes), replays and
    resumes to the JAX overlapped engine's streams, and both equal the
    blocking engines' streams."""
    (jp, jm), (tp, tm) = pair

    def reqs(cls):
        return [cls(uid=i, prompt=[(7 * i + j) % 97 + 1 for j in range(20)],
                    max_new_tokens=8, arrival_time=0.0) for i in range(8)]

    kw = dict(capacity=4, max_len=64, seed=0, prefill_chunks=(4, 8),
              paged=True, page_size=16, pool_pages=6)
    ov = dict(clock=time.perf_counter, overlap=True)
    streams, cons = {}, {}
    for name, eng, cls in (
            ("jax", JServingEngine(jp, jm, **kw), JRequest),
            ("jax_overlap", JServingEngine(jp, jm, **kw, **ov), JRequest),
            ("port", ServingEngine(tp, tm, device="cpu", **kw), Request),
            ("port_overlap", ServingEngine(tp, tm, device="cpu", **kw, **ov),
             Request)):
        if name.endswith("overlap"):
            eng.warmup()
        streams[name] = _outs(eng.run(reqs(cls)))
        eng.close()
        cons[name] = eng.metrics.conservation()
    assert streams["port_overlap"] == streams["jax_overlap"]
    assert streams["port"] == streams["jax"]
    assert streams["port_overlap"] == streams["port"]
    c = cons["port_overlap"]
    assert c["preempted"] > 0               # the pool actually saturated
    assert c["ok"] and c["preempt_ok"]
    assert all(len(v) == 8 for v in streams["port_overlap"].values())
