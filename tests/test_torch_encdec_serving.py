"""The port's encoder-decoder serving against the JAX package's, on the
CPU: the enc-dec cases of ``tests/test_runners.py`` and
``tests/test_frontends.py`` (``EncDecRunner``'s flags and ``accepts``,
refusal of missing or misshapen features, submit / poll / drain to
completion, decode conditioned on the audio), engine streams against the
JAX engine's, and the paged engine through a preemption.

Weights are the JAX package's (``smoke_config("whisper-base")``, carried
across by ``from_jax_params``); each request carries JAX's stub audio
features (64 frames).  Bars: the admission pass's cross K/V within 1e-5 of
JAX's admit in float; greedy streams equal to the JAX engine's in float
(every seed) and in ``abfp_packed`` / ``abfp_fused`` at the pinned engine
seeds below (a one-ULP difference parts a stream: ROADMAP queue 3); the
paged run's streams equal the unpaged run's bit for bit (a preempted
request re-admits and re-encodes to the same bits).
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.core.abfp import QuantConfig as JQuantConfig
from repro.models import frontends as jfr
from repro.models import init_params as j_init_params
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro.serving.runners import runner_for as j_runner_for
from repro_torch.configs import smoke_config
from repro_torch.core.abfp import QuantConfig
from repro_torch.launch import serve
from repro_torch.models import decode_step
from repro_torch.models.convert import from_jax_params
from repro_torch.serving import (
    EncDecRunner,
    FaultConfig,
    Request,
    ServingEngine,
    runner_for,
)

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker

ARCH = "whisper-base"
KW = dict(tile_width=32, gain=8.0, noise_lsb=0.5)
# Engine seeds on which every stream of the JAX and port engines agrees
# (float on every seed; abfp_packed on 0-3; abfp_fused on 0-2, not 3).
PINNED = {"float": 0, "abfp_packed": 1, "abfp_fused": 2}


@pytest.fixture(scope="module")
def pair():
    jm, tm = j_smoke_config(ARCH), smoke_config(ARCH)
    jp = j_init_params(jax.random.PRNGKey(0), jm)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tm, device="cpu")
    return (jp, jm), (tp, tm)


def _feats(seed, enc_len=EncDecRunner.DEFAULT_ENC_LEN, d=128):
    return np.asarray(jfr.audio_stub_features(jax.random.PRNGKey(seed), 1,
                                              enc_len, d)[0], np.float32)


def _workload(cls, n=5, max_new=5):
    return [cls(uid=i, prompt=[1 + i, 2, 3 + 7 * i][:2 + i % 2] * (1 + i),
                max_new_tokens=max_new, features=_feats(10 + i))
            for i in range(n)]


def _tokens(done):
    return {r.uid: tuple(r.generated) for r in done}


def test_runner_flags_and_accepts():
    mcfg = smoke_config(ARCH)
    r = runner_for(mcfg)
    j = j_runner_for(j_smoke_config(ARCH))
    assert isinstance(r, EncDecRunner) and r.enc_len == j.enc_len == 64
    assert (r.needs_admission, r.prefix_cache_ok, r.paged_ok,
            r.fixed_state) == (j.needs_admission, j.prefix_cache_ok,
                               j.paged_ok, j.fixed_state)

    class Req:
        features = None

    req = Req()
    assert not r.accepts(req)
    req.features = np.zeros((r.enc_len, mcfg.d_model), np.float32)
    assert r.accepts(req)
    req.features = np.zeros((r.enc_len + 1, mcfg.d_model), np.float32)
    assert not r.accepts(req)
    assert runner_for(smoke_config("smollm-360m")).accepts(Req())
    assert runner_for(mcfg, enc_len=1500).enc_len == 1500


def test_rejects_missing_or_misshapen_features_as_jax(pair):
    (jp, jm), (tp, tm) = pair
    for cls, eng in ((JRequest, JServingEngine(jp, jm, capacity=1,
                                               max_len=32)),
                     (Request, ServingEngine(tp, tm, capacity=1, max_len=32,
                                             device="cpu"))):
        no_feats = cls(uid=0, prompt=[1, 2], max_new_tokens=2)
        bad = cls(uid=1, prompt=[1, 2], max_new_tokens=2,
                  features=np.zeros((67, tm.d_model), np.float32))
        assert not eng.submit(no_feats) and no_feats.done
        assert not eng.submit(bad) and bad.done
        assert eng.metrics.conservation()["rejected"] == 2


def test_request_completes_via_submit_poll_drain(pair):
    _, (tp, tm) = pair
    eng = ServingEngine(tp, tm, capacity=2, max_len=32, device="cpu")
    reqs = [Request(uid=i, prompt=[1, 2, 3 + i], max_new_tokens=4,
                    features=_feats(5)) for i in range(3)]
    for r in reqs:
        assert eng.submit(r)
    done = eng.drain()
    assert len(done) == 3 and all(len(r.generated) == 4 for r in done)
    assert eng.metrics.conservation()["ok"]


def test_decode_conditions_on_audio(pair):
    """Same prompt, different audio: the admission pass's cross K/V changes
    the decode logits; the same audio gives the same logits."""
    _, (tp, tm) = pair
    runner = runner_for(tm)
    quant = QuantConfig(mode="float")

    def logits_for(feat_seed):
        state = runner.init_state(1, 8, "cpu")
        io, admit = runner.make_pass(("admit",), tp, quant, 0, 1, "cpu")
        io.words.copy_(torch.from_numpy(io.pack(
            torch.from_numpy(_feats(feat_seed)), 0)))
        admit(state)
        logits, _ = decode_step(tp, state, torch.tensor([5], dtype=torch.int32),
                                tm, enc_kv=runner.enc_kv(state))
        return logits

    base, same, other = logits_for(11), logits_for(11), logits_for(12)
    assert torch.equal(base, same)
    assert not torch.equal(base, other)


def test_admission_pass_equals_jax_admit(pair):
    """The admission pass writes slot 1's cross K/V in place (slot 0 keeps
    its zeros), within 1e-5 of JAX's ``make_admit`` in float."""
    (jp, jm), (tp, tm) = pair
    feats = _feats(3)
    jr = j_runner_for(jm)
    jstate = jax.jit(jr.make_admit(JQuantConfig(mode="float"), None))(
        jp, jr.init_state(2, 8), jnp.asarray(feats), jnp.int32(1),
        jax.random.PRNGKey(0))
    runner = runner_for(tm)
    state = runner.init_state(2, 8, "cpu")
    ptrs = [e[n].data_ptr() for e in state["enc"] for n in ("k", "v")]
    io, admit = runner.make_pass(("admit",), tp, QuantConfig(mode="float"),
                                 0, 2, "cpu")
    io.words.copy_(torch.from_numpy(io.pack(torch.from_numpy(feats), 1)))
    admit(state)
    assert [e[n].data_ptr() for e in state["enc"] for n in ("k", "v")] == ptrs
    for li, e in enumerate(state["enc"]):
        for n in ("k", "v"):
            assert not e[n][0].any()
            np.testing.assert_allclose(
                e[n][1].numpy(), np.asarray(jstate["enc"][0][n][li, 1]),
                rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["float", "abfp_packed", "abfp_fused"])
def test_engine_streams_equal_jax(pair, mode):
    (jp, jm), (tp, tm) = pair
    kw = {} if mode == "float" else KW
    if mode == "abfp_fused":
        jm = dataclasses.replace(jm, kv_quant=True)
        tm = dataclasses.replace(tm, kv_quant=True)
    ekw = dict(capacity=2, max_len=32, seed=PINNED[mode])
    jeng = JServingEngine(jp, jm, quant=JQuantConfig(mode=mode, **kw), **ekw)
    jdone = jeng.run(_workload(JRequest))
    teng = ServingEngine(tp, tm, quant=QuantConfig(mode=mode, **kw),
                         device="cpu", **ekw)
    tdone = teng.run(_workload(Request))
    assert _tokens(tdone) == _tokens(jdone)
    assert teng.ticks == jeng.ticks
    assert teng.metrics.conservation() == jeng.metrics.conservation()


def test_paged_preemption_streams_equal_unpaged(pair):
    """A pool too small for the batch preempts; the requeued request
    re-admits (re-encoding its features under the same key) and the
    streams equal the unpaged run's."""
    _, (tp, tm) = pair
    quant = QuantConfig(mode="abfp_packed", **KW)
    reqs = lambda: _workload(Request, n=4, max_new=12)  # noqa: E731
    base = ServingEngine(tp, tm, capacity=2, max_len=64, quant=quant,
                         seed=1, device="cpu")
    want = _tokens(base.run(reqs()))
    paged = ServingEngine(tp, tm, capacity=2, max_len=64, quant=quant,
                          seed=1, device="cpu", paged=True, page_size=8,
                          pool_pages=5, prefill_chunks=(8,))
    assert not paged.prefix_enabled
    got = _tokens(paged.run(reqs()))
    assert paged.metrics.summary()["requests"]["preempted"] >= 1
    assert got == want
    assert paged.metrics.conservation()["ok"]
    assert paged.pool.stats().held == 0


def test_overlapped_streams_equal_blocking(pair):
    _, (tp, tm) = pair
    quant = QuantConfig(mode="abfp_packed", **KW)
    want = _tokens(ServingEngine(tp, tm, capacity=2, max_len=32, quant=quant,
                                 seed=1, device="cpu").run(_workload(Request)))
    eng = ServingEngine(tp, tm, capacity=2, max_len=32, quant=quant, seed=1,
                        device="cpu", overlap=True, clock=time.perf_counter)
    try:
        got = _tokens(eng.run(_workload(Request)))
    finally:
        eng.close()
    assert got == want


def test_fault_plan_refused(pair):
    """Fault plans were refused on an encoder-decoder until the site walk
    reached its encoder and cross-attention weights; the engine now takes
    one, over JAX's sites (its runs against the JAX engine's are in
    ``tests/test_torch_faults_families_engine.py``)."""
    _, (tp, tm) = pair
    eng = ServingEngine(tp, tm, capacity=2, max_len=32, device="cpu",
                        quant=QuantConfig(mode="abfp_packed", **KW),
                        faults=FaultConfig(rate=0.01))
    paths = [s.path for s in eng._fault_sites]
    assert "encoder/layers/mlp/wi" in paths
    assert "groups/0/cross/wk" in paths and eng.fault_plan.events


def test_cli_refuses_featureless_requests(capsys):
    """``--arch whisper-base`` builds token-only requests: every one is
    rejected at submit, as by the JAX driver's single-model path."""
    serve.main(["--device", "cpu", "--arch", ARCH, "--reduced",
                "--requests", "3"])
    out = capsys.readouterr().out
    assert "3 requests, 0 tokens" in out
