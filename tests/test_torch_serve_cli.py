"""The port's serving CLI (``repro_torch.launch.serve``) against the JAX
package's (``repro.launch.serve``), on the CPU.

``poisson_workload`` and ``trace_workload`` must draw the JAX CLI's
requests from the same seed (prompts, arrivals, priorities, tenants); the
CLI runs end to end with ``--device cpu --reduced --paged`` open-loop
(Poisson arrivals, tenants, deadlines, ``--metrics-out``), from a
``--trace`` file, and overlapped on the wall clock; its metrics JSON has
the JAX CLI's keys and, on the simulated clock, its scheduling numbers
(the weights differ, the lengths and so the ticks do not).
"""

import argparse
import json
import sys

import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.launch import serve as j_serve
from repro_torch.configs import smoke_config
from repro_torch.launch import serve

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker

ARCH = "smollm-360m"


def _args(**kw):
    base = dict(arrival_rate=0.7, requests=12, prompt_len=9, max_new=5,
                temperature=0.3, tenants=3, trace=None)
    base.update(kw)
    return argparse.Namespace(**base)


def _fields(r):
    return (r.uid, list(r.prompt), r.max_new_tokens, r.temperature,
            r.arrival_time, r.priority, r.tenant)


@pytest.mark.parametrize("seed", [0, 5])
def test_poisson_workload_draws_the_jax_requests(seed):
    args = _args()
    got = serve.poisson_workload(smoke_config(ARCH), args,
                                 np.random.default_rng(seed))
    want = j_serve.poisson_workload(j_smoke_config(ARCH), args,
                                    np.random.default_rng(seed))
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    assert len({r.tenant for r in got}) > 1


def _write_trace(tmp_path):
    entries = [{"arrival_time": 0.0, "prompt": [5, 6, 7]},
               {"arrival_time": 1.5, "prompt_len": 6, "priority": 2,
                "tenant": "b"},
               {"arrival_time": 2.0, "prompt_len": 4, "max_new_tokens": 3,
                "temperature": 0.0},
               {"arrival_time": 2.5, "prompt_len": 11}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(entries))
    return str(path)


def test_trace_workload_draws_the_jax_requests(tmp_path):
    args = _args(trace=_write_trace(tmp_path))
    got = serve.trace_workload(smoke_config(ARCH), args,
                               np.random.default_rng(3))
    want = j_serve.trace_workload(j_smoke_config(ARCH), args,
                                  np.random.default_rng(3))
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    assert got[0].prompt == [5, 6, 7] and got[1].tenant == "b"


OPEN_LOOP = ["--reduced", "--paged", "--arrival-rate", "2", "--tenants",
             "2", "--deadline", "40", "--requests", "8"]


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + ".")
    return out


def _strip_timing(d):
    """The summary without its wall-clock parts."""
    return {k: v for k, v in d.items()
            if k not in ("tick_utilization", "straggler")}


def test_open_loop_paged_cli_matches_jax_cli(tmp_path, capsys,
                                             monkeypatch):
    out = tmp_path / "torch.json"
    serve.main(["--device", "cpu", *OPEN_LOOP, "--metrics-out", str(out)])
    text = capsys.readouterr().out
    for line in ("[serve] open-loop: 8 requests", "[serve] TTFT p50",
                 "[serve] goodput", "[serve] timed_out",
                 "[serve] pool: pressure mean", "[serve] overload: shed",
                 f"[serve] wrote {out}"):
        assert line in text, line
    jout = tmp_path / "jax.json"
    monkeypatch.setattr(sys, "argv", ["serve", *OPEN_LOOP, "--metrics-out",
                                      str(jout)])
    j_serve.main()
    capsys.readouterr()
    got, want = json.loads(out.read_text()), json.loads(jout.read_text())
    assert _keys(got) == _keys(want)
    assert _strip_timing(got) == _strip_timing(want)
    assert got["requests"]["finished"] == 8
    assert got["requests"]["preempted"] == got["requests"]["resumed"] > 0


def test_trace_cli_runs_end_to_end(tmp_path, capsys):
    out = tmp_path / "m.json"
    serve.main(["--device", "cpu", "--reduced", "--paged", "--trace",
                _write_trace(tmp_path), "--max-new", "4", "--policy",
                "priority", "--metrics-out", str(out)])
    text = capsys.readouterr().out
    assert "[serve] open-loop: 4 requests arriving over 2.5 ticks" in text
    doc = json.loads(out.read_text())
    assert doc["requests"]["finished"] == 4
    assert doc["policy"] == "priority"


def test_overlapped_paged_cli_on_the_wall_clock(tmp_path, capsys):
    out = tmp_path / "w.json"
    serve.main(["--device", "cpu", "--reduced", "--paged", "--overlap",
                "--arrival-rate", "200", "--requests", "6", "--pool-pages",
                "6", "--queue-watermark", "8", "--metrics-out", str(out)])
    text = capsys.readouterr().out
    assert "[serve] wall clock: overlap=on" in text
    assert "[serve] tick utilization" in text
    doc = json.loads(out.read_text())
    assert doc["requests"]["finished"] + doc["requests"]["shed"] == 6


FAULTS = ["--reduced", "--quant", "abfp-packed", "--tile", "32",
          "--requests", "8", "--max-new", "8", "--fault-rate", "0.1",
          "--fault-seed", "1", "--fault-kinds", "stuck_col,scale_drift",
          "--detect-every", "2"]


@pytest.mark.parametrize("recovery", [True, False], ids=["on", "off"])
def test_fault_flags_reach_the_engine_and_the_metrics(tmp_path, capsys,
                                                      monkeypatch, recovery):
    """The ``--fault-*`` flags build the engine's plan, cadence and
    recovery; the summary prints the fault counters and ``--metrics-out``
    carries them, equal to the JAX CLI's (the plan depends on the weight
    shapes only, and the simulated clock on the token counts)."""
    built = []

    class Spy(serve.ServingEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    monkeypatch.setattr(serve, "ServingEngine", Spy)
    argv = FAULTS + ([] if recovery else ["--no-recovery"])
    out = tmp_path / "torch.json"
    serve.main(["--device", "cpu", *argv, "--metrics-out", str(out)])
    eng, = built
    assert eng.fault_plan.cfg == serve.FaultConfig(
        rate=0.1, seed=1, kinds=("stuck_col", "scale_drift"))
    assert eng.detect_every == 2 and eng.recovery == recovery
    text = capsys.readouterr().out
    assert (f"[serve] fault injection: rate=0.1/tick, kinds=stuck_col,"
            f"scale_drift, seed=1, recovery={'on' if recovery else 'off'}"
            in text)
    assert "[serve] faults: " in text and "[serve] timed_out 0" in text
    jout = tmp_path / "jax.json"
    monkeypatch.setattr(sys, "argv", ["serve", *argv, "--metrics-out",
                                      str(jout)])
    j_serve.main()
    capsys.readouterr()
    got, want = json.loads(out.read_text()), json.loads(jout.read_text())
    assert _keys(got) == _keys(want)
    assert got["faults"] == want["faults"]
    assert got["requests"] == want["requests"]
    assert got["faults"]["injected"] >= 1 and got["faults"]["detected"] >= 1
    repaired = got["faults"]["cols_remapped"] + got["faults"][
        "tiles_requantized"]
    assert (repaired > 0) == recovery
    assert got["requests"]["conservation_ok"]
