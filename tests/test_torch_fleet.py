"""The port's multi-model fleet (``serving.fleet.FleetEngine``, the
engine's ``models=`` argument, ``launch.serve``'s ``--archs`` path)
against the JAX package's, on the CPU: the analogue of
``tests/test_fleet.py``.

Weights are the JAX package's smoke-config params (``repro.models.
init_params``), carried across by ``models.convert.from_jax_params``.
Held to the JAX package:

  * construction through ``ServingEngine(models=...)``, the slot split
    (``_split_capacity``) and the pool split, with JAX's errors and
    messages; routing errors with JAX's messages; a single lane's
    default routing;
  * the paged fleet whose fixed-state lane is never preempted: the pool on
    ``dec`` only, preemptions on ``dec`` and none on ``rec``, counts and
    streams equal to JAX's;
  * the three-family fleet (whisper fed features, xlstm,
    recurrentgemma): per-lane submitted / completed / ok and the summary
    (without its wall-clock parts) equal to JAX's, ``ticks`` the sum over
    the lanes;
  * per-lane greedy streams, ticks and conservation equal to JAX's fleet
    in float (four lanes; the ``abfp_packed``, overlapped and faulted
    fleets: ``tests/test_torch_fleet_serving.py``);
  * ``serve_fleet``'s per-lane lines and ``--metrics-out`` JSON against
    the JAX CLI's, its refusal of ``--archs`` with ``--fault-rate``;
    ``resolve_archs`` and ``parse_model_split`` (results and exit texts
    equal), and ``attach_features``: features only for enc-dec lanes,
    their uniform bits JAX's, the bf16 values equal but for the last bit
    of ``erfinv`` (``core.prng.normal``): 2 of 327,680 elements (40
    requests at the smoke config's 64 x 128) were one bf16 ULP apart, so
    the bar is at most 2 such elements per request.
"""

import argparse
import dataclasses
import json
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.core.abfp import QuantConfig as JQuantConfig
from repro.launch import serve as j_serve
from repro.models import init_params as j_init_params
from repro.serving import FleetEngine as JFleetEngine
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro.serving import faults as jfl
from repro.serving import fleet as jfleet
from repro.serving.runners import runner_for as j_runner_for
from repro_torch.configs import smoke_config
from repro_torch.core.abfp import QuantConfig
from repro_torch.launch import serve
from repro_torch.models.convert import from_jax_params
from repro_torch.serving import (
    FaultConfig,
    FleetEngine,
    Request,
    ServingEngine,
    runner_for,
)
from repro_torch.serving import fleet

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker

pytestmark = pytest.mark.fleet

ARCHS = ("smollm-360m", "whisper-base", "xlstm-350m", "recurrentgemma-2b")
KW = dict(tile_width=32, gain=4.0, noise_lsb=0.5)


@pytest.fixture(scope="module")
def zoo():
    """{arch: ((JAX params, JAX config), (port params, port config))}."""
    out = {}
    for a in ARCHS:
        jm, tm = j_smoke_config(a), smoke_config(a)
        jp = j_init_params(jax.random.PRNGKey(0), jm)
        tp = from_jax_params(jax.tree.map(np.asarray, jp), tm, device="cpu")
        out[a] = (jp, jm), (tp, tm)
    return out


def _models(zoo, lanes, side):
    """``models=`` for ``lanes`` ({lane: arch}) on one side (0 JAX, 1
    port)."""
    return {n: zoo[a][side] for n, a in lanes.items()}


def _fleets(zoo, lanes, **kw):
    """The same fleet in JAX and in the port."""
    jkw, tkw = dict(kw), dict(kw, device="cpu")
    if "quant" in kw:
        q = kw["quant"]
        jkw["quant"] = JQuantConfig(mode=q.mode, tile_width=q.tile_width,
                                    gain=q.gain, noise_lsb=q.noise_lsb)
    if "faults" in kw:
        jkw["faults"] = jfl.FaultConfig(**dataclasses.asdict(kw["faults"]))
    return (JServingEngine(models=_models(zoo, lanes, 0), **jkw),
            ServingEngine(models=_models(zoo, lanes, 1), **tkw))


def _reqs(cls, mcfg, n, *, prompt_len=4, max_new=4, model=None,
          features=None, uid0=0, arrivals=None):
    rng = np.random.default_rng(uid0 + 1)
    return [cls(
        uid=uid0 + i,
        prompt=rng.integers(1, mcfg.vocab_size, prompt_len).tolist(),
        max_new_tokens=max_new, model=model, features=features,
        arrival_time=None if arrivals is None else float(arrivals[i]))
        for i in range(n)]


def _round_robin(cls, zoo, lanes, n, attach, **kw):
    """``n`` requests routed round-robin over ``lanes`` as the CLI routes
    them: prompts folded into each lane's vocabulary, enc-dec lanes' given
    stub features keyed by (seed 0, uid)."""
    names = list(lanes)
    rng = np.random.default_rng(7)
    reqs = []
    for i in range(n):
        name = names[i % len(names)]
        mcfg = zoo[lanes[name]][1][1]
        plen = int(rng.integers(3, 12))
        prompt = [int(t) % (mcfg.vocab_size - 1) + 1
                  for t in rng.integers(1, 10_000, plen)]
        reqs.append(cls(uid=i, prompt=prompt, model=name, **kw))
    runners = {n_: (j_runner_for if cls is JRequest else runner_for)(
        zoo[lanes[n_]][1][1]) for n_ in names}
    attach(reqs, runners, 0)
    return reqs


def _streams(done):
    return {r.uid: r.generated for r in done}


def _strip(summary):
    """A lane's summary without its wall-clock parts."""
    return {k: v for k, v in summary.items()
            if k not in ("tick_utilization", "straggler")}


# ---------------------------------------------------------------------------
# Construction, splits, routing
# ---------------------------------------------------------------------------


def test_models_kwarg_builds_fleet(zoo):
    lanes = {"a": "smollm-360m", "b": "xlstm-350m"}
    jeng, teng = _fleets(zoo, lanes, capacity=4)
    assert isinstance(teng, FleetEngine) and isinstance(jeng, JFleetEngine)
    assert ({n: l_.capacity for n, l_ in teng.lanes.items()}
            == {n: l_.capacity for n, l_ in jeng.lanes.items()}
            == {"a": 2, "b": 2})
    (_, _), (tp, tm) = zoo["smollm-360m"]
    with pytest.raises(TypeError, match="positional params"):
        ServingEngine(tp, tm, models=_models(zoo, lanes, 1))
    with pytest.raises(ValueError, match="at least one lane"):
        ServingEngine(models={})

    class Sub(ServingEngine):
        pass

    # A subclass is never dispatched to the fleet, as in JAX.
    with pytest.raises(TypeError):
        Sub(models=_models(zoo, lanes, 1))


def _outcome(fn, *a):
    try:
        return ("ok", fn(*a))
    except (KeyError, ValueError) as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("total,overrides", [
    (4, None), (7, None), (6, {"a": 4}), (9, {"b": 1, "c": 5}),
    (5, {"a": 5}), (3, {"a": 2}), (2, None), (6, {"zzz": 1}),
    (6, {"a": 0}), (8, {"a": 2, "b": 3, "c": 3})])
def test_split_capacity_equals_jax(total, overrides):
    names = ["a", "b", "c"]
    got = _outcome(fleet._split_capacity, total, names, overrides)
    assert got == _outcome(jfleet._split_capacity, total, names, overrides)


def test_model_split_and_pool_split_equal_jax(zoo):
    lanes = {"a": "smollm-360m", "b": "xlstm-350m", "c": "whisper-base"}
    kw = dict(capacity=7, model_split={"a": 4}, max_len=32, paged=True,
              page_size=8, pool_pages=11)
    jeng, teng = _fleets(zoo, lanes, **kw)
    for n in lanes:
        tl, jl = teng.lanes[n], jeng.lanes[n]
        assert (tl.capacity, tl.paged) == (jl.capacity, jl.paged)
        assert (tl.pool is None) == (jl.pool is None)
        if tl.pool is not None:
            assert tl.pool.num_pages == jl.pool.num_pages
    with pytest.raises(KeyError, match="unknown models"):
        ServingEngine(models=_models(zoo, {"a": "smollm-360m"}, 1),
                      capacity=2, model_split={"zzz": 1}, device="cpu")


def test_routing_errors_equal_jax(zoo):
    lanes = {"a": "smollm-360m", "b": "xlstm-350m"}
    jeng, teng = _fleets(zoo, lanes, capacity=4)
    for kw in (dict(model="zzz"), {}):
        msgs = []
        for eng, cls in ((jeng, JRequest), (teng, Request)):
            with pytest.raises(KeyError) as e:
                eng.submit(cls(uid=3, prompt=[1], max_new_tokens=1, **kw))
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
        assert ("unknown model" if kw else "no model routing key") in msgs[1]


def test_single_lane_fleet_defaults_routing(zoo):
    eng = ServingEngine(models={"only": zoo["smollm-360m"][1]}, capacity=2,
                        device="cpu")
    req = Request(uid=0, prompt=[1, 2], max_new_tokens=2)
    assert eng.submit(req)
    eng.drain()
    assert len(req.generated) == 2


# ---------------------------------------------------------------------------
# Served fleets against JAX's
# ---------------------------------------------------------------------------


def test_fixed_state_lane_never_preempted(zoo):
    """A paged fleet puts only pageable lanes on the pool: the recurrent
    lane runs unpaged, so pool pressure on the decoder lane never evicts
    it.  Counts, conservation and streams equal JAX's fleet's."""
    lanes = {"dec": "smollm-360m", "rec": "xlstm-350m"}
    jeng, teng = _fleets(zoo, lanes, capacity=6, model_split={"dec": 4},
                         max_len=32, paged=True, page_size=8, pool_pages=6)
    assert teng.lanes["dec"].paged and teng.lanes["dec"].pool is not None
    assert not teng.lanes["rec"].paged and teng.lanes["rec"].pool is None
    assert not teng.lanes["rec"].preemption
    out = []
    for eng, cls in ((jeng, JRequest), (teng, Request)):
        md, mr = (zoo[a][1][1] for a in lanes.values())
        reqs = (_reqs(cls, md, 8, prompt_len=8, max_new=8, model="dec",
                      arrivals=[0] * 8)
                + _reqs(cls, mr, 4, prompt_len=8, max_new=8, model="rec",
                        uid0=100, arrivals=[0] * 4))
        for r in reqs:
            eng.submit(r)
        out.append((_streams(eng.drain()), eng.conservation(), eng.ticks))
    (jstreams, jcons, jticks), (tstreams, tcons, tticks) = out
    assert tcons["dec"]["ok"] and tcons["dec"]["preempt_ok"]
    assert tcons["rec"]["ok"]
    assert tcons["dec"]["preempted"] > 0        # the pressure was real
    assert tcons["rec"]["preempted"] == 0       # fixed state: never evicted
    assert len(tstreams) == 12
    assert (tstreams, tcons, tticks) == (jstreams, jcons, jticks)


def test_three_model_fleet_equals_jax(zoo):
    names = ("whisper-base", "xlstm-350m", "recurrentgemma-2b")
    lanes = {n: n for n in names}
    jeng, teng = _fleets(zoo, lanes, capacity=6, max_len=32)
    out = []
    for eng, cls, attach in ((jeng, JRequest, j_serve.attach_features),
                             (teng, Request, serve.attach_features)):
        reqs = []
        for i in range(9):
            name = names[i % 3]
            reqs += _reqs(cls, zoo[name][1][1], 1, model=name, uid0=i,
                          arrivals=[i * 0.5])
        attach(reqs, {n: eng.lanes[n].runner for n in names}, 0)
        for r in reqs:
            assert eng.submit(r)
        done = eng.drain()
        assert len(done) == 9
        assert eng.ticks == sum(l_.ticks for l_ in eng.lanes.values())
        out.append((_streams(done), eng.conservation(),
                    {n: _strip(s) for n, s in eng.summary().items()}))
    (jstreams, jcons, jsum), (tstreams, tcons, tsum) = out
    for n in names:
        assert tcons[n]["submitted"] == tcons[n]["completed"] == 3
        assert tcons[n]["ok"]
        assert tsum[n]["requests"]["finished"] == 3
    assert tcons == jcons and tsum == jsum
    assert tstreams == jstreams


def _serve_both(zoo, lanes, n, *, max_new=4, **kw):
    jeng, teng = _fleets(zoo, lanes, **kw)
    jdone = jeng.run(_round_robin(JRequest, zoo, lanes, n,
                                  j_serve.attach_features,
                                  max_new_tokens=max_new))
    tdone = teng.run(_round_robin(Request, zoo, lanes, n,
                                  serve.attach_features,
                                  max_new_tokens=max_new))
    for e in (jeng, teng):
        e.close()
    return (jeng, jdone), (teng, tdone)


def test_fleet_streams_equal_jax_float(zoo):
    lanes = {a: a for a in ARCHS}
    (jeng, jdone), (teng, tdone) = _serve_both(
        zoo, lanes, 12, capacity=8, max_len=48)
    assert len(tdone) == 12
    assert _streams(tdone) == _streams(jdone)
    assert teng.ticks == jeng.ticks
    assert teng.conservation() == jeng.conservation()


# ---------------------------------------------------------------------------
# The CLI's fleet path against the JAX CLI's
# ---------------------------------------------------------------------------


def _lane_lines(text):
    return [ln for ln in text.splitlines()
            if ln.startswith("  ") and "conservation_ok" in ln]


def test_serve_fleet_cli_equals_jax(tmp_path, capsys, monkeypatch):
    argv = ["--reduced", "--archs", ",".join(ARCHS), "--requests", "8",
            "--model-split", "smollm-360m=2", "--capacity", "5"]
    out = tmp_path / "torch.json"
    serve.main(["--device", "cpu", *argv, "--metrics-out", str(out)])
    text = capsys.readouterr().out
    jout = tmp_path / "jax.json"
    monkeypatch.setattr(sys, "argv", ["serve", *argv, "--metrics-out",
                                      str(jout)])
    j_serve.main()
    jtext = capsys.readouterr().out
    assert _lane_lines(text) == _lane_lines(jtext)
    assert len(_lane_lines(text)) == 4
    assert all("conservation_ok True" in ln for ln in _lane_lines(text))
    head = [ln for ln in text.splitlines() if "slots" in ln]
    assert head == [ln for ln in jtext.splitlines() if "slots" in ln]
    got, want = json.loads(out.read_text()), json.loads(jout.read_text())
    assert got["conservation"] == want["conservation"]
    assert ({n: _strip(s) for n, s in got["fleet"].items()}
            == {n: _strip(s) for n, s in want["fleet"].items()})


def test_cli_refuses_archs_with_fault_rate(monkeypatch):
    argv = ["--reduced", "--archs", "smollm-360m,xlstm-350m",
            "--fault-rate", "0.1"]
    with pytest.raises(SystemExit) as got:
        serve.main(["--device", "cpu", *argv])
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    with pytest.raises(SystemExit) as want:
        j_serve.main()
    assert str(got.value) == str(want.value)
    assert "fault injection" in str(got.value)


def _exit_text(fn, *a):
    try:
        return fn(*a)
    except SystemExit as e:
        return ("exit", str(e))


@pytest.mark.parametrize("arch,archs", [
    ("smollm-360m", None), ("xlstm-350m", "smollm-360m, whisper-base"),
    ("smollm-360m", "smollm-360m,nope"), ("smollm-360m", " , ")])
def test_resolve_archs_equals_jax(arch, archs):
    args = argparse.Namespace(arch=arch, archs=archs)
    assert (_exit_text(serve.resolve_archs, args)
            == _exit_text(j_serve.resolve_archs, args))


@pytest.mark.parametrize("arg", [None, "a=2,b=3", "a=2,", "a:2", "a=x",
                                 ","])
def test_parse_model_split_equals_jax(arg):
    assert (_exit_text(serve.parse_model_split, arg)
            == _exit_text(j_serve.parse_model_split, arg))


def test_attach_features_equal_jax(zoo):
    """Only requests routed to an enc-dec lane get features: (enc_len,
    d_model) f32 from the key (seed, uid), JAX's values but for at most 2
    elements one bf16 ULP apart (the last bit of ``erfinv``)."""
    lanes = {"w": "whisper-base", "s": "smollm-360m"}
    out = []
    for cls, attach, rf, side in ((JRequest, j_serve.attach_features,
                                   j_runner_for, 0),
                                  (Request, serve.attach_features,
                                   runner_for, 1)):
        reqs = [cls(uid=u, prompt=[1], model=("w" if u % 2 else "s"))
                for u in range(6)] + [cls(uid=9, prompt=[1], model="zz")]
        attach(reqs, {n: rf(zoo[a][side][1]) for n, a in lanes.items()}, 5)
        out.append(reqs)
    for j, t in zip(*out):
        if j.features is None:
            assert t.features is None
            continue
        assert t.features.dtype == np.float32 == j.features.dtype
        assert t.features.shape == j.features.shape == (64, 128)
        tb, jb = (x.view(np.int32) >> 16 for x in (t.features, j.features))
        assert not (t.features.view(np.int32) & 0xFFFF).any()  # bf16 values
        apart = tb != jb
        assert apart.sum() <= 2 and np.all(np.abs(tb - jb)[apart] == 1)
    assert sum(r.features is not None for r in out[1]) == 3
