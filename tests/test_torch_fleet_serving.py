"""The port's multi-model fleet served against the JAX package's fleet,
on the CPU: the serving cases of ``tests/test_torch_fleet.py`` (whose
weights and helpers this file shares).

  * per-lane greedy streams and ticks equal to JAX's two-lane (smollm,
    xlstm) fleet in ``abfp_packed`` at a pinned engine seed (a one-ULP
    difference parts a stream: ROADMAP queue 3);
  * an overlapped fleet (one shared delivery stream, ``inflight`` its
    depth) against JAX's overlapped fleet, and against the blocking fleet;
  * a fleet under ``faults=FaultConfig(...)``, which goes to every lane:
    each lane's plan, counters and conservation, and the streams, equal
    to JAX's (float: stuck columns and a shard drop).
"""

import dataclasses
import time

import pytest
import torch

from repro_torch.core.abfp import QuantConfig
from repro_torch.serving import FaultConfig
from test_torch_fleet import (  # noqa: F401 (zoo is a fixture)
    KW,
    _serve_both,
    _streams,
    zoo,
)

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker

pytestmark = pytest.mark.fleet

# The engine seed on which every stream of the two-lane (smollm, xlstm)
# abfp_packed fleet agrees with JAX's.
PACKED_SEED = 0


def test_fleet_streams_equal_jax_abfp_packed(zoo):
    lanes = {"smollm-360m": "smollm-360m", "xlstm-350m": "xlstm-350m"}
    (jeng, jdone), (teng, tdone) = _serve_both(
        zoo, lanes, 6, capacity=4, max_len=48, seed=PACKED_SEED,
        quant=QuantConfig(mode="abfp_packed", **KW), prefill_chunks=(16,))
    assert _streams(tdone) == _streams(jdone)
    assert teng.ticks == jeng.ticks


def test_overlapped_fleet_equals_jax_overlapped(zoo):
    """One shared delivery stream (``inflight`` its depth) on the wall
    clock: every request finishes with JAX's overlapped fleet's greedy
    stream, and with the blocking fleet's."""
    lanes = {"smollm-360m": "smollm-360m", "xlstm-350m": "xlstm-350m"}
    (jeng, jdone), (teng, tdone) = _serve_both(
        zoo, lanes, 6, capacity=4, max_len=48, clock=time.perf_counter,
        overlap=True, inflight=3)
    assert teng._shared_stream is not None
    assert teng._shared_stream._q.maxsize == 3
    assert all(l_._stream is teng._shared_stream
               for l_ in teng.lanes.values())
    assert len(tdone) == 6
    assert _streams(tdone) == _streams(jdone)
    assert all(c["ok"] for c in teng.conservation().values())
    (_, _), (_, blocking) = _serve_both(zoo, lanes, 6, capacity=4,
                                        max_len=48)
    assert _streams(tdone) == _streams(blocking)


def test_fleet_faults_forwarded_to_every_lane_equal_jax(zoo):
    """``faults=FaultConfig(...)`` reaches every lane: each lane draws its
    own plan over its own sites, JAX's plan, and serves it with JAX's
    counters and streams (float: stuck columns and a shard drop)."""
    lanes = {"smollm-360m": "smollm-360m", "xlstm-350m": "xlstm-350m"}
    (jeng, jdone), (teng, tdone) = _serve_both(
        zoo, lanes, 8, capacity=4, max_len=48,
        faults=FaultConfig(rate=0.2, seed=1, horizon=40), detect_every=2)
    for n in lanes:
        tl, jl = teng.lanes[n], jeng.lanes[n]
        assert ([dataclasses.astuple(e) for e in tl.fault_plan.events]
                == [dataclasses.astuple(e) for e in jl.fault_plan.events])
        assert tl.fault_plan.events
        assert dict(tl.metrics.faults) == dict(jl.metrics.faults)
        assert tl.metrics.conservation() == jl.metrics.conservation()
    assert len(tdone) == 8
    assert _streams(tdone) == _streams(jdone)
