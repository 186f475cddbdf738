"""The paper's reference numerics (``abfp_ref``) served through the
port's fleet, under a fault plan and from the CLI (``--quant abfp``), on
the CPU, against the JAX package (tile 32, gain 2, noise 0.5 in the
engines; the CLI's own tile 128, gain 8).

  * a two-lane fleet (smollm-360m beside whisper-base, whose requests
    carry the CLI's stub features and take an admission pass): per-lane
    greedy streams, ticks and conservation equal to JAX's fleet;
  * a seeded ``FaultConfig`` under ``abfp_ref``: as in the JAX engine the
    weights stay float, so the plan's sites are the float dense leaves
    (stuck columns and shard drops; scale drift has no float site): the
    plan's events, the fault counters, the request counts and the streams
    equal the JAX engine's;
  * ``--quant abfp --reduced --device cpu``, single model and ``--archs``:
    the JAX CLI's summary lines (the weights differ, so the tokens may;
    the lengths and so the ticks and latencies do not).

Streams are held at pinned engine seeds (a one-ULP difference upstream of
the scan can part one: ROADMAP queue 3).
"""

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
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro.serving import faults as jfl
from repro_torch.configs import smoke_config
from repro_torch.core.abfp import QuantConfig
from repro_torch.launch import serve
from repro_torch.models.convert import from_jax_params
from repro_torch.serving import FaultConfig, Request, ServingEngine
from test_torch_fleet import _serve_both

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker

KW = dict(tile_width=32, gain=2.0, noise_lsb=0.5)
REF = QuantConfig(mode="abfp_ref", **KW)
FLEET_SEED = 0
FAULT_SEED = 0


def _zoo(*archs):
    out = {}
    for a in archs:
        jm, tm = j_smoke_config(a), smoke_config(a)
        jp = j_init_params(jax.random.PRNGKey(0), jm)
        tp = from_jax_params(jax.tree.map(np.asarray, jp), tm, device="cpu")
        out[a] = (jp, jm), (tp, tm)
    return out


def _streams(done):
    return {r.uid: list(r.generated) for r in done}


def test_fleet_streams_equal_jax():
    zoo = _zoo("smollm-360m", "whisper-base")
    lanes = {a: a for a in zoo}
    (jeng, jdone), (teng, tdone) = _serve_both(
        zoo, lanes, 6, capacity=4, max_len=48, seed=FLEET_SEED, quant=REF,
        prefill_chunks=(16,))
    assert len(tdone) == 6
    assert _streams(tdone) == _streams(jdone)
    assert teng.ticks == jeng.ticks
    assert teng.conservation() == jeng.conservation()
    assert ("admit",) in teng.lanes["whisper-base"]._passes


def _workload(cls, n=10, vocab=512):
    rng = np.random.default_rng(0)
    return [cls(uid=i, prompt=[int(t) for t in rng.integers(1, vocab, 6)],
                max_new_tokens=6, arrival_time=float(i)) for i in range(n)]


def test_fault_config_equals_jax():
    (jp, jm), (tp, tm) = _zoo("smollm-360m")["smollm-360m"]
    cfg = dict(rate=0.1, seed=3, horizon=48)
    kw = dict(capacity=4, max_len=64, seed=FAULT_SEED, detect_every=2)
    jeng = JServingEngine(jp, jm, quant=JQuantConfig(mode="abfp_ref", **KW),
                          faults=jfl.FaultConfig(**cfg), **kw)
    jdone = jeng.run(_workload(JRequest))
    teng = ServingEngine(tp, tm, quant=REF, device="cpu",
                         faults=FaultConfig(**cfg), **kw)
    tdone = teng.run(_workload(Request))
    assert ([dataclasses.astuple(e) for e in teng.fault_plan.events]
            == [dataclasses.astuple(e) for e in jeng.fault_plan.events])
    assert teng.fault_plan.events
    assert not any(s.packed for s in teng._fault_sites)
    assert dict(teng.metrics.faults) == dict(jeng.metrics.faults)
    assert teng.metrics.faults["injected"] >= 1
    assert teng.metrics.summary()["requests"] == \
        jeng.metrics.summary()["requests"]
    assert teng.metrics.conservation() == jeng.metrics.conservation()
    assert teng.ticks == jeng.ticks
    assert _streams(tdone) == _streams(jdone)


def _run_both(argv, tmp_path, capsys, monkeypatch):
    out = tmp_path / "torch.json"
    serve.main(["--device", "cpu", *argv, "--metrics-out", str(out)])
    text = capsys.readouterr().out
    jout = tmp_path / "jax.json"
    monkeypatch.setattr(sys, "argv", ["serve", *argv, "--metrics-out",
                                      str(jout)])
    j_serve.main()
    jtext = capsys.readouterr().out
    return (text, json.loads(out.read_text())), (jtext,
                                                 json.loads(jout.read_text()))


def test_cli_serves_abfp_like_the_jax_cli(tmp_path, capsys, monkeypatch):
    argv = ["--reduced", "--quant", "abfp", "--requests", "4",
            "--prompt-len", "6", "--max-new", "3", "--max-len", "32"]
    (text, got), (jtext, want) = _run_both(argv, tmp_path, capsys,
                                           monkeypatch)
    assert "quant=abfp_ref" in text

    def summary(t):
        return [ln for ln in t.splitlines()
                if ln.startswith(("[serve] TTFT", "[serve] goodput"))]

    assert summary(text) == summary(jtext) and len(summary(text)) == 2
    assert "[serve] 4 requests, 12 tokens in" in text
    strip = ("tick_utilization", "straggler")
    assert {k: v for k, v in got.items() if k not in strip} == \
        {k: v for k, v in want.items() if k not in strip}


def test_cli_fleet_serves_abfp_like_the_jax_cli(tmp_path, capsys,
                                                monkeypatch):
    argv = ["--reduced", "--quant", "abfp", "--archs",
            "smollm-360m,xlstm-350m", "--requests", "4", "--max-new", "3",
            "--max-len", "32"]
    (text, got), (jtext, want) = _run_both(argv, tmp_path, capsys,
                                           monkeypatch)

    def lanes(t):
        return [ln for ln in t.splitlines()
                if ln.startswith("  ") and "conservation_ok" in ln]

    assert lanes(text) == lanes(jtext) and len(lanes(text)) == 2
    assert all("conservation_ok True" in ln for ln in lanes(text))
    head = [ln for ln in text.splitlines() if "quant=abfp" in ln]
    assert head and head == [ln for ln in jtext.splitlines()
                             if "quant=abfp" in ln]
    assert got["conservation"] == want["conservation"]


@pytest.mark.parametrize("quant,mode", [("abfp", "abfp_ref"),
                                        ("abfp-kernel", "abfp_kernel")])
def test_quant_flag_maps_as_the_jax_cli(quant, mode):
    args = serve.build_parser().parse_args(["--quant", quant])
    assert serve.quant_config(args).mode == mode
    args = serve.build_parser().parse_args(["--quant", quant, "--fused"])
    assert serve.quant_config(args).mode == "abfp_fused"
