"""Tensor-parallel serving on a virtual mesh (``ServingEngine(mesh=...)``,
``--mesh dp,tp``) against the one-device engines, on the CPU: the
analogues of ``tests/test_sharded_serving.py``'s engine cases.

Every case serves the same prompts on the port's engine at MESH_SHAPES
and holds its greedy streams to the port's one-device engine's (bit
equality: column shards at their global offsets compute every output
element as the whole call does) and to the JAX package's one-device
engine's on the same weights.  One case runs the JAX package's own mesh
engine in a subprocess on forced placeholder CPU devices and holds the
port's mesh streams to it.  In the port every mesh position is the
engine's device (here the CPU).
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

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
from repro_torch.configs import smoke_config
from repro_torch.core.abfp import QuantConfig
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import init_params
from repro_torch.models.convert import from_jax_params
from repro_torch.serving import FaultConfig, Request, ServingEngine

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker

ROOT = Path(__file__).resolve().parents[1]

MESH_SHAPES = [(1, 1), (2, 1), (1, 2), (2, 4)]

# The engine seed of every case (the noise keys of its passes).  The port's
# one-device streams equal the JAX package's at this seed in every case
# below; at seed 0 a one-ULP bf16 flip parts the last token of one abfp
# stream (ROADMAP queue 3: the plain versions' f32 order against XLA's).
# Mesh and one-device streams are bit-equal at any seed.
SEED = 4

# Prompts straddle the (4, 8) prefill buckets, plus a one-token prompt
# (the decode tick): tests/test_sharded_serving.py's.
PROMPTS = [[3, 5, 7, 9, 11], [2, 4, 6], [8, 1, 2, 3, 4, 5, 6, 7, 9], [13]]

FLOAT = QuantConfig(mode="float")
PACKED = QuantConfig(mode="abfp_packed", tile_width=32, gain=4.0,
                     noise_lsb=0.5)
PACKED1 = QuantConfig(mode="abfp_packed", tile_width=32, gain=1.0,
                      noise_lsb=0.5)
FUSED1 = QuantConfig(mode="abfp_fused", tile_width=32, gain=1.0,
                     noise_lsb=0.5)
FUSED4 = QuantConfig(mode="abfp_fused", tile_width=32, gain=4.0,
                     noise_lsb=0.5)


def _jq(q):
    if q.mode == "float":
        return JQuantConfig(mode="float")
    return JQuantConfig(mode=q.mode, tile_width=q.tile_width, gain=q.gain,
                        noise_lsb=q.noise_lsb)


def _mesh(shape):
    return make_host_mesh(*shape, "cpu")


def _serve(mcfg, params, quant, mesh, *, max_new=4, max_len=32, **ekw):
    eng = ServingEngine(params, mcfg, capacity=4, max_len=max_len,
                        quant=quant, seed=SEED, prefill_chunks=(4, 8),
                        mesh=mesh, device="cpu", **ekw)
    done = eng.run([Request(uid=i, prompt=list(p), max_new_tokens=max_new)
                    for i, p in enumerate(PROMPTS)])
    assert len(done) == len(PROMPTS)
    return {r.uid: tuple(r.generated) for r in done}


def _serve_jax(mcfg, params, quant, *, max_new=4, max_len=32, **ekw):
    eng = JServingEngine(params, mcfg, capacity=4, max_len=max_len,
                         quant=_jq(quant), seed=SEED, prefill_chunks=(4, 8),
                         **ekw)
    done = eng.run([JRequest(uid=i, prompt=list(p), max_new_tokens=max_new)
                    for i, p in enumerate(PROMPTS)])
    return {r.uid: tuple(int(t) for t in r.generated) for r in done}


def _pair(arch, key=0, **repl):
    """(JAX config, JAX params, port config, port params) of a smoke arch,
    the port's params converted from the JAX package's."""
    jm = dataclasses.replace(j_smoke_config(arch), **repl)
    tm = dataclasses.replace(smoke_config(arch), **repl)
    jp = j_init_params(jax.random.PRNGKey(key), jm)
    return jm, jp, tm, from_jax_params(jax.tree.map(np.asarray, jp), tm,
                                       device="cpu")


@pytest.fixture(scope="module")
def tinyllama():
    return _pair("tinyllama-1.1b")


@pytest.fixture(scope="module")
def tinyllama_kvq():
    """The same weights with the int8 KV cache: the fused decode tick."""
    return _pair("tinyllama-1.1b", kv_quant=True)


@pytest.fixture(scope="module")
def recurrentgemma():
    return _pair("recurrentgemma-2b", key=1, window_size=8)


_BASES = {}


def _base(pair, quant):
    """The one-device streams of the port's engine, checked once against
    the JAX package's one-device engine on the same weights."""
    jm, jp, tm, tp = pair
    key = (tm.name, tm.kv_quant, quant)
    if key not in _BASES:
        want = _serve(tm, tp, quant, None)
        assert want == _serve_jax(jm, jp, quant)
        _BASES[key] = want
    return _BASES[key]


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_float_parity(tinyllama, shape):
    jm, jp, tm, tp = tinyllama
    assert _serve(tm, tp, FLOAT, _mesh(shape)) == _base(tinyllama, FLOAT)


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_packed_parity_bit_identical(tinyllama, shape):
    """abfp_packed greedy decode with ADC noise: the streams of the
    one-device engines, port's and JAX's, at every mesh shape."""
    jm, jp, tm, tp = tinyllama
    assert _serve(tm, tp, PACKED, _mesh(shape)) == _base(tinyllama, PACKED)


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_fused_gain1_equals_one_device_packed(tinyllama_kvq, shape):
    """abfp_fused at gain 1 (all-ones tile gains: exact no-ops) through the
    fused QKV and the attention kernel's plain version equals the
    one-device abfp_packed engine at every mesh shape."""
    jm, jp, tm, tp = tinyllama_kvq
    assert _serve(tm, tp, FUSED1, _mesh(shape)) == \
        _base(tinyllama_kvq, PACKED1)


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_fused_gain4_mesh_self_parity(tinyllama_kvq, shape):
    jm, jp, tm, tp = tinyllama_kvq
    assert _serve(tm, tp, FUSED4, _mesh(shape)) == \
        _base(tinyllama_kvq, FUSED4)


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_paged_parity_bit_identical(tinyllama, shape):
    """Paged float decode on a mesh: the unpaged one-device streams."""
    jm, jp, tm, tp = tinyllama
    got = _serve(tm, tp, FLOAT, _mesh(shape), paged=True, page_size=16)
    assert got == _base(tinyllama, FLOAT)


def test_paged_packed_parity_on_mesh(tinyllama):
    jm, jp, tm, tp = tinyllama
    got = _serve(tm, tp, PACKED, _mesh((2, 4)), paged=True, page_size=32)
    assert got == _base(tinyllama, PACKED)


@pytest.mark.parametrize("shape", [(1, 2), (2, 4)])
@pytest.mark.parametrize("quant", [FLOAT, PACKED], ids=["float",
                                                        "abfp_packed"])
def test_ring_cache_wraparound_parity(recurrentgemma, shape, quant):
    """recurrentgemma with a ring cache of 8 that wraps during decode:
    chunked prefill and the wraparound stay bit-identical on the mesh."""
    jm, jp, tm, tp = recurrentgemma
    assert tm.attention_type == "hybrid"
    assert any(len(p) + 6 > 8 for p in PROMPTS)     # wraps for long prompts
    kw = dict(max_new=6, max_len=48)
    key = ("ring", quant)
    if key not in _BASES:
        _BASES[key] = _serve(tm, tp, quant, None, **kw)
        assert _BASES[key] == _serve_jax(jm, jp, quant, **kw)
    assert _serve(tm, tp, quant, _mesh(shape), **kw) == _BASES[key]


def test_open_loop_api_unchanged_under_mesh(tinyllama):
    jm, jp, tm, tp = tinyllama

    def run(cls, req, params, mcfg, **kw):
        eng = cls(params, mcfg, capacity=2, max_len=32, quant=kw.pop(
            "quant"), seed=0, prefill_chunks=(4, 8), policy="priority", **kw)
        for i, p in enumerate(PROMPTS):
            eng.submit(req(uid=i, prompt=list(p), max_new_tokens=3,
                           arrival_time=float(i), priority=i % 2,
                           tenant=f"t{i % 2}"))
        done = eng.drain()
        return {r.uid: tuple(int(t) for t in r.generated)
                for r in done}, eng.ticks

    base = run(ServingEngine, Request, tp, tm, quant=FLOAT, device="cpu")
    assert base == run(JServingEngine, JRequest, jp, jm,
                       quant=JQuantConfig(mode="float"))
    assert run(ServingEngine, Request, tp, tm, quant=FLOAT, device="cpu",
               mesh=_mesh((2, 4))) == base


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-1b-a400m",
                                  "xlstm-350m", "recurrentgemma-2b",
                                  "whisper-base", "phi-3-vision-4.2b"])
def test_every_family_serves_on_a_mesh(arch, monkeypatch):
    """Every family's dense calls go through ``Numerics.dense``: its
    streams on a (1, 2) mesh (packed) and a (2, 4) mesh (float) are the
    one-device engine's, and the packed mesh run makes one kernel-1 call
    per column shard of every weight that splits (on the CPU each call
    runs the plain version)."""
    calls = []
    real = ops.abfp_matmul_packed

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(ops, "abfp_matmul_packed", counted)
    tm = smoke_config(arch)
    tp = init_params(0, tm, device="cpu")
    feats = None
    if tm.is_encoder_decoder:
        from repro_torch.serving import EncDecRunner
        enc_len = EncDecRunner.DEFAULT_ENC_LEN
        feats = torch.randn(len(PROMPTS), enc_len, tm.d_model,
                            generator=torch.Generator().manual_seed(0))

    def serve_(quant, mesh):
        eng = ServingEngine(tp, tm, capacity=4, max_len=32, quant=quant,
                            seed=0, prefill_chunks=(4, 8), mesh=mesh,
                            device="cpu")
        calls.clear()
        done = eng.run([Request(
            uid=i, prompt=[t % (tm.vocab_size - 1) + 1 for t in p],
            max_new_tokens=3,
            features=None if feats is None else feats[i])
            for i, p in enumerate(PROMPTS)])
        assert len(done) == len(PROMPTS)
        return {r.uid: r.generated for r in done}, len(calls)

    for quant, shape in ((PACKED, (1, 2)), (FLOAT, (2, 4))):
        (one, n1), (got, n2) = serve_(quant, None), serve_(quant,
                                                           _mesh(shape))
        assert got == one, (arch, shape)
        if quant is PACKED:
            assert n2 > n1 > 0


def test_fleet_serves_every_lane_on_the_mesh():
    """``FleetEngine`` hands the mesh to every lane, as the JAX fleet's
    lane kwargs do: each lane's streams are the fleet's without a mesh."""
    models = {}
    for a in ("smollm-360m", "xlstm-350m"):
        tm = smoke_config(a)
        models[a] = (init_params(0, tm, device="cpu"), tm)

    def run(mesh):
        eng = ServingEngine(models=models, capacity=4, max_len=32,
                            quant=PACKED, seed=0, prefill_chunks=(4, 8),
                            mesh=mesh, device="cpu")
        assert all(l_.mesh is mesh for l_ in eng.lanes.values())
        done = eng.run([Request(uid=i, prompt=list(p), max_new_tokens=3,
                                model=list(models)[i % 2])
                        for i, p in enumerate(PROMPTS)])
        return {r.uid: r.generated for r in done}

    assert run(_mesh((1, 2))) == run(None)


def test_mesh_refusals(tinyllama):
    """A fault plan on a mesh of another device, a mesh of another device
    and a mesh that is not the port's raise NotImplementedError naming
    the multi-card slice (a fault plan on the engine's own mesh serves:
    ``tests/test_torch_mesh_faults.py``)."""
    jm, jp, tm, tp = tinyllama
    meta = make_host_mesh(1, 2, "meta")
    with pytest.raises(NotImplementedError,
                       match="a fault plan on a mesh.*multi-card"):
        ServingEngine(tp, tm, capacity=2, mesh=meta, device="cpu",
                      quant=PACKED, faults=FaultConfig(rate=0.1))
    for bad in (meta, jax.make_mesh((1, 1), ("data", "model"))):
        with pytest.raises(NotImplementedError, match="multi-card"):
            ServingEngine(tp, tm, capacity=2, mesh=bad, device="cpu")


_JAX_MESH_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json, sys
import jax
import numpy as np
from repro.configs import smoke_config
from repro.core.abfp import QuantConfig
from repro.models import init_params
from repro.serving import Request, ServingEngine

shape = tuple(int(v) for v in sys.argv[1].split(","))
prompts = json.loads(sys.argv[2])
seed = int(sys.argv[3])
mcfg = dataclasses.replace(smoke_config("tinyllama-1.1b"), kv_quant=True)
params = init_params(jax.random.PRNGKey(0), mcfg)
eng = ServingEngine(params, mcfg, capacity=4, max_len=32,
                    quant=QuantConfig(mode="abfp_fused", tile_width=32,
                                      gain=4.0, noise_lsb=0.5),
                    seed=seed, prefill_chunks=(4, 8),
                    mesh=jax.sharding.Mesh(
                        np.array(jax.devices()[:shape[0] * shape[1]])
                        .reshape(shape), ("data", "model")))
done = eng.run([Request(uid=i, prompt=p, max_new_tokens=4)
                for i, p in enumerate(prompts)])
print("STREAMS " + json.dumps({r.uid: [int(t) for t in r.generated]
                               for r in done}))
"""

# The JAX package's mesh engine runs in a subprocess on a (data, model)
# mesh of forced placeholder CPU devices.  The mesh is built with
# ``jax.sharding.Mesh`` (automatic axes): ``jax.make_mesh`` of this JAX
# gives explicit axes, under which the engine's KV-cache scatter raises a
# ShardingTypeError at every mesh shape (ROADMAP queue 3).
JAX_MESH = (2, 4)


def test_mesh_streams_equal_jax_mesh_engine(tinyllama_kvq):
    """The JAX package's own (2, 4) mesh engine (abfp_fused, gain 4), on
    forced placeholder CPU devices in a subprocess, and the port's (2, 4)
    mesh engine serve the same streams: the port holds the JAX mesh
    contract as the JAX package itself runs it."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-c", _JAX_MESH_SCRIPT,
         ",".join(map(str, JAX_MESH)), json.dumps(PROMPTS), str(SEED)],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    print(f"JAX mesh engine subprocess: {time.perf_counter() - t0:.1f}s")
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("STREAMS ")]
    assert line, r.stdout + r.stderr
    want = {int(k): tuple(v) for k, v in json.loads(line[0][8:]).items()}
    jm, jp, tm, tp = tinyllama_kvq
    assert _serve(tm, tp, FUSED4, _mesh(JAX_MESH)) == want


# The metrics' wall-clock parts.
_WALL = ("tick_utilization", "straggler")


def test_mesh_cli_prints_the_jax_lines_and_the_one_device_tokens(
        tmp_path, capsys, monkeypatch):
    argv = ["--reduced", "--arch", "tinyllama-1.1b", "--quant",
            "abfp-packed", "--tile", "32", "--requests", "4", "--max-new",
            "4"]
    out = tmp_path / "mesh.json"
    serve.main(["--device", "cpu", *argv, "--mesh", "2,4", "--metrics-out",
                str(out)])
    text = capsys.readouterr().out
    assert "quant=abfp_packed, policy=fcfs, mesh=(2x4 data x model)" in text
    serve.main(["--device", "cpu", *argv])
    one = capsys.readouterr().out
    toks = [ln for ln in text.splitlines() if ln.startswith("  req ")]
    assert toks and toks == [ln for ln in one.splitlines()
                             if ln.startswith("  req ")]
    jout = tmp_path / "jax.json"
    monkeypatch.setattr(sys, "argv", ["serve", *argv, "--metrics-out",
                                      str(jout)])
    j_serve.main()
    jtext = capsys.readouterr().out
    for prefix in ("[serve] 4 requests", "[serve] TTFT p50",
                   "[serve] goodput"):
        mine = [ln for ln in text.splitlines() if ln.startswith(prefix)]
        theirs = [ln for ln in jtext.splitlines() if ln.startswith(prefix)]
        assert len(mine) == len(theirs) == 1, prefix
        if prefix != "[serve] 4 requests":      # its wall time differs
            assert mine == theirs
    got, want = json.loads(out.read_text()), json.loads(jout.read_text())
    assert ({k: v for k, v in got.items() if k not in _WALL}
            == {k: v for k, v in want.items() if k not in _WALL})
    for bad in ("2", "a,b", "0,2"):
        with pytest.raises(SystemExit) as e1:
            serve.parse_mesh(bad)
        with pytest.raises(SystemExit) as e2:
            j_serve.parse_mesh(bad)
        assert str(e1.value) == str(e2.value)
    assert serve.parse_mesh("2,4") == j_serve.parse_mesh("2,4") == (2, 4)
