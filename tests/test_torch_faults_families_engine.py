"""The served engine's fault loop on every model family against the JAX
engine's, on the CPU: the engine cases of
``tests/test_torch_faults_families.py`` (whose weights, plans' sites and
three-copy checks this file shares), on the smoke configs of
granite-moe-1b-a400m, xlstm-350m, recurrentgemma-2b and whisper-base.

Held to the JAX package: the engine's fault counters, each request's
(corrupted, requeues), ticks and conservation, and the greedy streams at
the pinned engine seeds below, on an explicit plan per family that hits
only sites of the non-dense families (an encoder weight and a cross
``wk`` on whisper: the requeued requests re-admit, and so re-encode under
the repaired weights).  Port-only: after the run every site equals the
spare and no served tensor moved; a rate-0 plan serves what no plan
serves; a shard drop on one card resets the recurrent states and the
cross K/V in place.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.abfp import QuantConfig as JQuantConfig
from repro.launch import serve as j_serve
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro.serving import faults as jfl
from repro.serving.runners import runner_for as j_runner_for
from repro_torch.configs import smoke_config
from repro_torch.core.abfp import QuantConfig
from repro_torch.launch import serve
from repro_torch.serving import (
    FaultConfig,
    FaultPlan,
    Request,
    ServingEngine,
    runner_for,
)
from repro_torch.serving import faults as faultlib
from repro_torch.serving.faults import FaultEvent
from test_torch_faults_families import (
    ARCHS,
    KW,
    PLANS,
    _pair,
    _ptrs,
    assert_three_copies,
)

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker

pytestmark = pytest.mark.fault

# (mode, engine seed) per family on which every stream of the JAX and port
# engines agrees under its plan (the counters agree on every seed tried;
# granite's streams agree on abfp_fused seeds 3 and 6 of 1-6 and
# abfp_packed seed 2 of 0-5, one or two requests of six parting on the
# others: ROADMAP queue 3's one-ULP flips).
PINNED = {"granite-moe-1b-a400m": ("abfp_fused", 3),
          "xlstm-350m": ("abfp_packed", 0),
          "recurrentgemma-2b": ("abfp_packed", 1),
          "whisper-base": ("abfp_fused", 1)}


def _plan(lib, arch):
    stuck, drift = PLANS[arch]
    return lib.FaultPlan(
        [lib.FaultEvent(3, "stuck_col", stuck, cols=(5, 70)),
         lib.FaultEvent(6, "scale_drift", drift,
                        tiles=((0, 3), (2, 100)), factors=(1.2, 0.8))],
        lib.FaultConfig(rate=0.01))


def _workload(cls, arch, runner, attach, n=6, max_new=5):
    rng = np.random.default_rng(0)
    vocab = smoke_config(arch).vocab_size
    reqs = [cls(uid=i, prompt=[int(t) for t in rng.integers(1, vocab, 6)],
                max_new_tokens=max_new, arrival_time=float(i), model=arch)
            for i in range(n)]
    attach(reqs, {arch: runner}, 0)     # stub features for whisper only
    return reqs


def _record(eng):
    s = eng.metrics.summary()
    return dict(faults=dict(eng.metrics.faults), ticks=eng.ticks,
                requests=s["requests"],
                conservation=eng.metrics.conservation(),
                per_request={u: (r.corrupted, r.requeues)
                             for u, r in eng.metrics.requests.items()})


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_fault_loop_equals_jax(arch):
    """The family's explicit plan through the JAX engine and the port's:
    equal counters, (corrupted, requeues) per request, ticks and
    conservation, equal streams at the pinned seed; every request in
    flight at a detection is requeued (and, on whisper, admitted once
    more, so re-encoded under the repaired weights); afterwards every site
    equals the spare and no served tensor moved."""
    (jp, jm), (tp, tm) = _pair(arch)
    mode, seed = PINNED[arch]
    if mode == "abfp_fused":
        jm = dataclasses.replace(jm, kv_quant=True)
        tm = dataclasses.replace(tm, kv_quant=True)
    kw = dict(capacity=4, max_len=64, seed=seed, detect_every=2,
              prefill_chunks=(8,))
    jeng = JServingEngine(jp, jm, quant=JQuantConfig(mode=mode, **KW),
                          faults=_plan(jfl, arch), **kw)
    jdone = jeng.run(_workload(JRequest, arch, j_runner_for(jm),
                               j_serve.attach_features))
    cfg = QuantConfig(mode=mode, **KW)
    teng = ServingEngine(tp, tm, quant=cfg, device="cpu",
                         faults=_plan(faultlib, arch), **kw)
    ptrs = _ptrs(teng.params)
    admits = []
    if teng.runner.needs_admission:
        admit = teng._admit_pass
        teng._admit_pass = lambda i, req: (admits.append(req.uid),
                                           admit(i, req))
    tdone = teng.run(_workload(Request, arch, runner_for(tm),
                               serve.attach_features))
    assert _record(teng) == _record(jeng)
    assert ({r.uid: r.generated for r in tdone}
            == {r.uid: r.generated for r in jdone})
    f = teng.metrics.faults
    assert f["injected"] == 2 and f["detected"] == 4
    assert f["cols_remapped"] == 2 and f["tiles_requantized"] == 2
    assert any(r.requeues for r in teng.metrics.requests.values())
    if admits:
        for u in range(6):
            want = 1 + teng.metrics.requests[u].requeues
            assert admits.count(u) == want, (u, admits)
    assert_three_copies(teng.params, cfg, ptrs)
    for site in faultlib.fault_sites(teng.params):
        for a, b in zip(faultlib.site_leaves(teng.params, site.path),
                        faultlib.site_leaves(teng._params_clean, site.path)):
            assert torch.equal(a.codes, b.codes)
            assert torch.equal(a.scales.view(torch.int16),
                               b.scales.view(torch.int16))


@pytest.mark.parametrize("arch", ARCHS)
def test_rate_zero_plan_serves_what_no_plan_serves(arch):
    _, (tp, tm) = _pair(arch)
    kw = dict(capacity=4, max_len=64, seed=0, prefill_chunks=(8,),
              quant=QuantConfig(mode="abfp_packed", **KW), device="cpu")
    outs = []
    for faults in (None, FaultConfig(rate=0.0)):
        eng = ServingEngine(tp, tm, faults=faults, **kw)
        done = eng.run(_workload(Request, arch, runner_for(tm),
                                 serve.attach_features))
        outs.append({r.uid: r.generated for r in done})
        assert eng.metrics.faults["injected"] == 0
    assert outs[0] == outs[1]


@pytest.mark.parametrize("arch", ("recurrentgemma-2b", "whisper-base"))
def test_shard_drop_resets_fixed_and_encoder_state(arch):
    """A shard drop on one card re-programs the array and resets the
    whole decode state (recurrent states, the cross K/V) in place: every
    request in flight restarts, and every request that no token of the
    dead array reached serves what a fault-free run serves (without ADC
    noise: a restart shifts the passes' noise keys)."""
    _, (tp, tm) = _pair(arch)
    quiet = QuantConfig(mode="abfp_packed", **{**KW, "noise_lsb": 0.0})
    kw = dict(capacity=4, max_len=64, seed=0, prefill_chunks=(8,),
              quant=quiet, device="cpu")
    clean = ServingEngine(tp, tm, **kw).run(
        _workload(Request, arch, runner_for(tm), serve.attach_features))
    plan = FaultPlan([FaultEvent(5, "shard_drop", "", shard=0)],
                     FaultConfig(rate=0.01))
    eng = ServingEngine(tp, tm, faults=plan, detect_every=2, **kw)
    done = eng.run(_workload(Request, arch, runner_for(tm),
                             serve.attach_features))
    assert eng.metrics.faults["reshards"] == 1
    assert eng.metrics.conservation()["ok"]
    assert eng.metrics.summary()["requests"]["requeued"] >= 1
    want = {r.uid: r.generated for r in clean}
    kept = [r.uid for r in done
            if not eng.metrics.requests[r.uid].corrupted]
    assert len(kept) >= 4
    assert all(r.generated == want[r.uid] for r in done if r.uid in kept)
