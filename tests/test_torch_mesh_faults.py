"""Fault plans on a virtual mesh (``ServingEngine(mesh=..., faults=...)``)
against the JAX package's, on the CPU: the analogues of
``tests/test_faults.py``'s mesh cases.

On a mesh a served weight whose columns split over 'model' is a
``kernels.ops.ColumnShards``; its fault site is still the whole weight, as
JAX's sharded array is.  Held to the JAX package:

  * injection on equal packs at tp 2 and 4 (``abfp_packed`` and
    ``abfp_fused``, with and without noise: without it every weight
    splits and each layer's QKV concatenation is per shard): a shard drop
    of shard 1 zeroes exactly the columns JAX's ``inject_shard_drop``
    zeroes (JAX never cuts a weight it stacks; ``lm_head`` loses the
    shard's columns), and stuck columns and drifted tiles that straddle
    shards land as JAX's do, are detected as JAX detects them and are
    repaired back to the clean pack; after every write each shard's
    kernel codes are ``kernel_layout(codes)`` and each per-shard
    ``PackedQKV`` a fresh concatenation of its shards;
  * the engine: rate-0 plans at meshes (1, 1), (2, 1), (1, 2) and (2, 4)
    serve the one-device streams (the port's, equal to the JAX engine's
    at the pinned seed); a shard drop of shard 1 re-meshes as the JAX
    mesh engine does ((2, 4) -> (1, 4) keeping the shards' layout, (1, 2)
    -> (1, 1) and (1, 4) -> (1, 3) narrowing the model axis), with 1
    reshard, conservation and 10 of 10 finished; at (2, 4) and (1, 2) its
    fault counters and greedy streams equal the JAX package's own mesh
    engine's, run in a
    subprocess on forced placeholder CPU devices (a ``jax.sharding.Mesh``:
    ``jax.make_mesh``'s explicit axes make that engine raise, ROADMAP
    queue 3).  At (2, 4) the served tensors are repaired in place (no pass
    built again); a narrowed model axis places the weights anew.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.core.abfp import QuantConfig as JQuantConfig
from repro.models import init_params as j_init_params
from repro.models.packing import pack_model_params as j_pack
from repro.serving import faults as jfl
from repro_torch.core.abfp import PackedWeight, QuantConfig, kernel_layout
from repro_torch.configs import smoke_config
from repro_torch.kernels.abfp_decode_fused import concat_qkv
from repro_torch.kernels.ops import ColumnShards
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import pack_model_params
from repro_torch.models.convert import from_jax_params
from repro_torch.serving import FaultConfig, FaultPlan, Request, ServingEngine
from repro_torch.serving import faults as faultlib
from repro_torch.serving.faults import FaultEvent

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker

pytestmark = pytest.mark.fault

ROOT = Path(__file__).resolve().parents[1]
ARCH = "tinyllama-1.1b"
MESH_SHAPES = [(1, 1), (2, 1), (1, 2), (2, 4)]
# The shard drops held to the JAX mesh engine; (1, 4) -> (1, 3) is held
# to the port's own invariants (the JAX runs take most of this file's
# time).
DROP_SHAPES = [(2, 4), (1, 2)]
# The engine seed of the engine cases (the noise keys of its passes): the
# port's and the JAX engine's streams agree at it on the one-device run
# and under every shard drop below.  At seeds 1 and 4 one one-device
# stream parts from JAX's at its fifth token, at seed 3 two re-decoded
# streams after the drop (one-ULP flips, ROADMAP queue 3).
SEED = 2
PACKED = QuantConfig(mode="abfp_packed", tile_width=32, gain=4.0,
                     noise_lsb=0.5)


class _FakeMesh:
    """What the JAX package's ``tp_shardable`` reads of a mesh."""

    axis_names = ("data", "model")

    def __init__(self, dp, tp):
        self.shape = {"data": dp, "model": tp}


def _jq(q):
    return JQuantConfig(mode=q.mode, tile_width=q.tile_width, gain=q.gain,
                        noise_lsb=q.noise_lsb)


@pytest.fixture(scope="module")
def pair():
    jm, tm = j_smoke_config(ARCH), smoke_config(ARCH)
    jp = j_init_params(jax.random.PRNGKey(0), jm)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tm, device="cpu")
    return (jp, jm), (tp, tm)


def _np(t):
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


def _jnp(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _whole(leaf):
    """A served leaf's (codes, scales) over the whole weight's columns (a
    ``ColumnShards``' shards concatenated, each without its padding)."""
    if isinstance(leaf, PackedWeight):
        return leaf.codes, leaf.scales
    w = leaf.shard_cols
    return (torch.cat([s.codes[:, :w] for s in leaf.shards], 1),
            torch.cat([s.scales[:, :w] for s in leaf.shards], 1))


def _equal_to_jax(tparams, jparams, path):
    jleaf = jfl._get_site(jparams, path)
    for i, leaf in enumerate(faultlib.site_leaves(tparams, path)):
        sl = (i,) if path.startswith("groups/") else ()
        codes, scales = _whole(leaf)
        assert np.array_equal(_np(codes), _jnp(jleaf.codes)[sl]), path
        assert np.array_equal(_np(scales), _jnp(jleaf.scales)[sl]), path


def _three_copies(params, quant):
    """Every stored shard's kernel codes are ``kernel_layout(codes)``, and
    each layer's per-shard ``PackedQKV`` a fresh concatenation of its
    wq, wk and wv shards."""
    for site in faultlib.fault_sites(params):
        for leaf in faultlib.site_leaves(params, site.path):
            for pw in (leaf.shards if isinstance(leaf, ColumnShards)
                       else (leaf,)):
                assert torch.equal(pw.kcodes, kernel_layout(pw.codes))
    for lp in params["layers"]:
        a = lp["attn"]
        if not isinstance(a.get("qkv"), tuple):
            continue
        for t, q in enumerate(a["qkv"]):
            fresh = concat_qkv([a[w].shards[t] for w in ("wq", "wk", "wv")],
                               quant)
            assert torch.equal(q.kcodes, fresh.kcodes)
            assert torch.equal(q.scales.view(torch.int16),
                               fresh.scales.view(torch.int16))


def _packs(pair, quant, tp):
    (jp, jm), (tparams, tm) = pair
    mesh = make_host_mesh(1, tp, "cpu")
    return (j_pack(jp, _jq(quant), jm),
            pack_model_params(tparams, quant, tm, mesh=mesh), mesh)


QUANTS = [dataclasses.replace(PACKED, mode=m, noise_lsb=n)
          for m in ("abfp_packed", "abfp_fused") for n in (0.5, 0.0)]
QUANT_IDS = [f"{q.mode}-noise{q.noise_lsb}" for q in QUANTS]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("quant", QUANTS, ids=QUANT_IDS)
def test_shard_drop_zeroes_the_columns_jax_zeroes(pair, quant, tp):
    jparams, tparams, mesh = _packs(pair, quant, tp)
    sites = faultlib.fault_sites(tparams)
    assert [dataclasses.astuple(s) for s in sites] == [
        dataclasses.astuple(s) for s in jfl.fault_sites(jparams)]
    spare = faultlib.clone_sites(tparams)
    faultlib.apply_event(tparams, FaultEvent(0, "shard_drop", "", shard=1),
                         tp=tp, quant=quant, mesh=mesh)
    jbad = jfl.inject_shard_drop(jparams, 1, tp, quant=_jq(quant),
                                 mesh=_FakeMesh(1, tp))
    cut = 0
    for site in sites:
        _equal_to_jax(tparams, jbad, site.path)
        for leaf in faultlib.site_leaves(tparams, site.path):
            if isinstance(leaf, ColumnShards) and site.path == "lm_head":
                assert not leaf.shards[1].codes.any()
                assert all(s.codes.any() for t, s in enumerate(leaf.shards)
                           if t != 1)
                cut += 1
    assert cut == 1                 # JAX cuts no stacked weight
    _three_copies(tparams, quant)
    faultlib.restore_sites(tparams, spare)
    for site in sites:
        _equal_to_jax(tparams, jparams, site.path)


STRADDLING = [
    FaultEvent(0, "stuck_col", "groups/0/attn/wq", cols=(3, 100)),
    FaultEvent(0, "stuck_col", "groups/0/mlp/wi", cols=(0, 127, 128, 255)),
    FaultEvent(0, "scale_drift", "groups/0/attn/wv",
               tiles=((0, 5), (3, 60)), factors=(1.2, 0.8)),
    FaultEvent(0, "scale_drift", "groups/0/mlp/wg",
               tiles=((1, 7), (2, 200)), factors=(0.9, 1.1)),
    FaultEvent(0, "stuck_col", "lm_head", cols=(11, 300, 511)),
]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("quant", QUANTS[2:], ids=QUANT_IDS[2:])
@pytest.mark.parametrize("ev", STRADDLING,
                         ids=[f"{e.kind}-{e.path}" for e in STRADDLING])
def test_straddling_faults_roundtrip_like_jax(pair, quant, tp, ev):
    """A fault across shard boundaries lands in every shard it touches:
    the same weights as JAX's injection, JAX's detection, and the repair
    restores the clean pack."""
    jparams, tparams, mesh = _packs(pair, quant, tp)
    site = next(s for s in faultlib.fault_sites(tparams) if s.path == ev.path)
    jsite = jfl.FaultSite(*dataclasses.astuple(site))
    base = faultlib.site_fingerprint(tparams, site)
    jbase = jfl.site_fingerprint(jparams, jsite)
    spare = faultlib.clone_sites(tparams)
    faultlib.apply_event(tparams, ev, tp=tp, quant=quant, mesh=mesh)
    jbad = jfl.apply_event(jparams, jfl.FaultEvent(*dataclasses.astuple(ev)))
    _equal_to_jax(tparams, jbad, ev.path)
    _three_copies(tparams, quant)
    det = faultlib.detect_site(base, faultlib.site_fingerprint(tparams, site))
    jdet = jfl.detect_site(jbase, jfl.site_fingerprint(jbad, jsite))
    assert (det.stuck_cols, det.drifted) == (jdet.stuck_cols, jdet.drifted)
    assert not det.clean
    if det.stuck_cols:
        faultlib.repair_stuck(tparams, spare, ev.path, det.stuck_cols)
    if det.drifted:
        faultlib.repair_drift(tparams, spare, ev.path, det.drifted)
    _equal_to_jax(tparams, jparams, ev.path)
    _three_copies(tparams, quant)


def test_plan_draws_shards_like_jax(pair):
    jparams, tparams, _ = _packs(pair, PACKED, 4)
    for seed in range(4):
        cfg = FaultConfig(rate=0.05, seed=seed, horizon=64,
                          kinds=("shard_drop", "stuck_col"))
        got = faultlib.make_fault_plan(tparams, cfg, tp=4)
        want = jfl.make_fault_plan(jparams, jfl.FaultConfig(
            rate=0.05, seed=seed, horizon=64,
            kinds=("shard_drop", "stuck_col")), tp=4)
        assert [dataclasses.astuple(e) for e in got.events] == [
            dataclasses.astuple(e) for e in want.events]


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def _workload(n=10, max_new=6, vocab=512):
    rng = np.random.default_rng(0)
    return [Request(uid=i, prompt=[int(t) for t in rng.integers(1, vocab, 6)],
                    max_new_tokens=max_new, arrival_time=float(i))
            for i in range(n)]


def _tokens(done):
    return {r.uid: tuple(r.generated) for r in done}


def _engine(pair, mesh=None, **kw):
    _, (tp, tm) = pair
    return ServingEngine(tp, tm, capacity=4, max_len=64, quant=PACKED,
                         seed=SEED, prefill_chunks=(4, 8), device="cpu",
                         mesh=None if mesh is None else make_host_mesh(
                             *mesh, "cpu"), **kw)


def _drop_plan():
    return FaultPlan([FaultEvent(6, "shard_drop", "", shard=1)],
                     FaultConfig(rate=0.01))


_JAX_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
import jax, numpy as np
from repro.configs import smoke_config
from repro.core.abfp import QuantConfig
from repro.models import init_params
from repro.serving import FaultConfig, FaultPlan, Request, ServingEngine
from repro.serving.faults import FaultEvent

seed, shapes = int(sys.argv[1]), json.loads(sys.argv[2])
mcfg = smoke_config("tinyllama-1.1b")
params = init_params(jax.random.PRNGKey(0), mcfg)
quant = QuantConfig(mode="abfp_packed", tile_width=32, gain=4.0,
                    noise_lsb=0.5)


def workload():
    rng = np.random.default_rng(0)
    return [Request(uid=i, prompt=[int(t) for t in
                                   rng.integers(1, mcfg.vocab_size, 6)],
                    max_new_tokens=6, arrival_time=float(i))
            for i in range(10)]


def streams(done):
    return {r.uid: [int(t) for t in r.generated] for r in done}


kw = dict(capacity=4, max_len=64, quant=quant, seed=seed,
          prefill_chunks=(4, 8))
out = {"one": streams(ServingEngine(params, mcfg, **kw).run(workload()))}
for dp, tp in shapes:
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:dp * tp]).reshape(
        dp, tp), ("data", "model"))
    plan = FaultPlan([FaultEvent(6, "shard_drop", "", shard=1)],
                     FaultConfig(rate=0.01))
    eng = ServingEngine(params, mcfg, mesh=mesh, faults=plan,
                        recovery=True, detect_every=2, **kw)
    done = eng.run(workload())
    out[f"{dp}x{tp}"] = {
        "mesh": list(eng.mesh.devices.shape), "faults": eng.metrics.faults,
        "conservation": eng.metrics.conservation(), "n": len(done),
        "streams": streams(done)}
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_engine():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(SEED),
                        json.dumps(DROP_SHAPES)], capture_output=True,
                       text=True, timeout=900, env=env, cwd=ROOT)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    assert line, r.stdout + r.stderr
    return json.loads(line[0][7:])


@pytest.fixture(scope="module")
def one_device(pair, jax_engine):
    want = _tokens(_engine(pair).run(_workload()))
    assert want == {int(k): tuple(v) for k, v in jax_engine["one"].items()}
    return want


@pytest.mark.parametrize("shape", MESH_SHAPES,
                         ids=[f"{d}x{t}" for d, t in MESH_SHAPES])
def test_mesh_parity_with_fault_machinery(pair, one_device, shape):
    eng = _engine(pair, shape, faults=FaultConfig(rate=0.0))
    assert _tokens(eng.run(_workload())) == one_device
    assert eng.metrics.faults["injected"] == 0
    assert eng.fault_plan is not None and eng.fault_plan.events == []


@pytest.mark.parametrize("shape", DROP_SHAPES,
                         ids=[f"{d}x{t}" for d, t in DROP_SHAPES])
def test_mesh_shard_drop_reshards_and_conserves(pair, jax_engine, shape):
    want = jax_engine[f"{shape[0]}x{shape[1]}"]
    eng = _engine(pair, shape, faults=_drop_plan(), recovery=True,
                  detect_every=2)
    eng.warmup()
    built = dict(eng._passes)
    done = eng.run(_workload())
    new_shape = tuple(eng.mesh.devices.shape)
    assert new_shape == tuple(want["mesh"])
    assert eng.metrics.faults["reshards"] == 1
    assert eng.metrics.faults == want["faults"]
    assert eng.metrics.conservation() == want["conservation"]
    assert eng.metrics.conservation()["ok"]
    assert len(done) == want["n"] == 10
    assert _tokens(done) == {int(k): tuple(v)
                             for k, v in want["streams"].items()}
    kept = new_shape[1] == shape[1]
    assert kept == (shape[0] > 1)
    # The model axis kept: the spare was copied into the served tensors
    # and every built pass serves on; narrowed: the weights were placed
    # anew and the passes built again.
    assert all((eng._passes.get(k) is wp) == kept for k, wp in built.items())
    faultlib.fault_sites(eng.params)            # the new placement's sites


def test_mesh_shard_drop_narrows_to_three_shards(pair):
    """(1, 4) loses a model bank: 3 chips survive, the model axis narrows
    to 3, whose column count no weight divides: every weight is placed
    whole again and every pass built again."""
    eng = _engine(pair, (1, 4), faults=_drop_plan(), recovery=True,
                  detect_every=2)
    eng.warmup()
    built = dict(eng._passes)
    done = eng.run(_workload())
    assert tuple(eng.mesh.devices.shape) == (1, 3)
    assert eng.metrics.faults["reshards"] == 1
    assert eng.metrics.conservation()["ok"] and len(done) == 10
    assert not any(eng._passes.get(k) is wp for k, wp in built.items())
    assert not any(isinstance(leaf, ColumnShards)
                   for s in faultlib.fault_sites(eng.params)
                   for leaf in faultlib.site_leaves(eng.params, s.path))


def test_mesh_of_other_devices_refuses_a_fault_plan(pair):
    _, (tp, tm) = pair
    meta = make_host_mesh(1, 2, "meta")
    with pytest.raises(NotImplementedError, match="a fault plan on a mesh"):
        ServingEngine(tp, tm, capacity=2, mesh=meta, device="cpu",
                      quant=PACKED, faults=FaultConfig(rate=0.1))
