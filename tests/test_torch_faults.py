"""The port's fault injection, detection and recovery against the JAX
package's (``repro.serving.faults`` and the engine's loop), on the CPU:
the analogue of ``tests/test_faults.py``.

Weights are the JAX package's (``smoke_config("tinyllama-1.1b")``, carried
across by ``models.convert.from_jax_params``), packed by each side at tile
32, gain 4, noise 0.5.  Held to the JAX package:

  * the site list (JAX's paths, each addressing the port's per-layer
    leaves) and ``make_fault_plan``'s events, for seeds 0-3 and rates
    0.01 / 0.05 / 0 in ``abfp_packed`` and ``abfp_fused``;
  * injected codes and scales, layer by layer, equal to JAX's stacked
    leaves; per-layer fingerprints bit-equal to JAX's per-layer slice, the
    layer sum within one f32 ULP; ``detect_site`` verdicts equal;
    ``packed_output_error_bound`` within rtol 1e-6;
  * the engine's fault counters, conservation counts and request counts
    equal to the JAX engine's on one explicit plan and workload (a stuck
    LM-head column, a drifted MLP tile, a stuck wk column, a shard drop),
    unpaged and paged, and on a seeded ``FaultConfig``, with the greedy
    streams equal too at the pinned engine seeds below (a one-ULP
    difference parts a stream: ROADMAP queue 3).

The port-only contract: every write lands in all three copies of a packed
weight (``codes``, the kernel layout ``kcodes`` and the fused QKV
concatenation) in place, so after every inject and repair ``kcodes ==
kernel_layout(codes)``, each layer's ``PackedQKV`` equals a fresh
``concat_qkv`` of its pieces, and no served tensor moved.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.core import abfp as jabfp
from repro.core.abfp import QuantConfig as JQuantConfig
from repro.distributed import fault as jfault
from repro.models import init_params as j_init_params
from repro.models.packing import pack_model_params as j_pack
from repro.serving import faults as jfl
from repro_torch.configs import smoke_config
from repro_torch.core import abfp
from repro_torch.core.abfp import QuantConfig, kernel_layout
from repro_torch.distributed import fault as tfault
from repro_torch.kernels.abfp_decode_fused import concat_qkv
from repro_torch.models.convert import from_jax_params
from repro_torch.models.packing import pack_model_params
from repro_torch.serving import (
    FaultConfig,
    FaultPlan,
    ServingEngine,
    drift_detect_rtol,
    make_fault_plan,
)
from repro_torch.serving import faults as faultlib
from repro_torch.serving.faults import FaultEvent

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker

pytestmark = pytest.mark.fault

ARCH = "tinyllama-1.1b"
KW = dict(tile_width=32, gain=4.0, noise_lsb=0.5)
PACKED = QuantConfig(mode="abfp_packed", **KW)
MODES = ["abfp_packed", "abfp_fused"]


@pytest.fixture(scope="module")
def pair():
    jm, tm = j_smoke_config(ARCH), smoke_config(ARCH)
    jp = j_init_params(jax.random.PRNGKey(0), jm)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tm, device="cpu")
    return (jp, jm), (tp, tm)


def _packs(pair, mode):
    """Fresh packs of the same weights on both sides (injection writes the
    port's in place)."""
    (jp, jm), (tp, tm) = pair
    return (j_pack(jp, JQuantConfig(mode=mode, **KW), jm),
            pack_model_params(tp, QuantConfig(mode=mode, **KW), tm))


def _clone(node):
    if isinstance(node, dict):
        return {k: _clone(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_clone(v) for v in node]
    return node.clone()


def _tuples(xs):
    return [dataclasses.astuple(x) for x in xs]


def _jsite(site):
    return jfl.FaultSite(*dataclasses.astuple(site))


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _jnp(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _equal_to_jax(tparams, jparams, path):
    """Every layer's codes and scales (or float weight) equal JAX's stacked
    leaf's slice, bit for bit."""
    jleaf = jfl._get_site(jparams, path)
    tleaves = faultlib.site_leaves(tparams, path)
    for i, leaf in enumerate(tleaves):
        sl = (i,) if path.startswith("groups/") else ()
        if isinstance(leaf, abfp.PackedWeight):
            assert np.array_equal(_np(leaf.codes), _jnp(jleaf.codes)[sl])
            assert np.array_equal(_np(leaf.scales), _jnp(jleaf.scales)[sl])
        else:
            assert np.array_equal(_np(leaf), _jnp(jleaf)[sl])


# ---------------------------------------------------------------------------
# Sites and plans against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["float"] + MODES)
def test_fault_sites_equal_jax(pair, mode):
    if mode == "float":
        (jp, _), (tp, _) = pair
        jparams, tparams = jp, tp
    else:
        jparams, tparams = _packs(pair, mode)
    sites = faultlib.fault_sites(tparams)
    assert _tuples(sites) == _tuples(jfl.fault_sites(jparams))
    assert [s.path for s in sites][0] == "groups/0/attn/wk"
    assert sites[-1].path == "lm_head" and len(sites) == 8
    n_layers = len(tparams["layers"])
    for s in sites:
        leaves = faultlib.site_leaves(tparams, s.path)
        assert len(leaves) == (1 if s.path == "lm_head" else n_layers)


@pytest.mark.parametrize("rate", [0.01, 0.05, 0.0])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("mode", MODES)
def test_plan_equals_jax(pair, mode, seed, rate):
    jparams, tparams = _packs(pair, mode)
    got = make_fault_plan(tparams, FaultConfig(rate=rate, seed=seed))
    want = jfl.make_fault_plan(jparams, jfl.FaultConfig(rate=rate,
                                                        seed=seed))
    assert _tuples(got.events) == _tuples(want.events)
    assert bool(got.events) == (rate > 0)


def test_plan_rate_zero_empty_and_rate_positive_nonempty(pair):
    _, tparams = _packs(pair, "abfp_packed")
    assert make_fault_plan(tparams, FaultConfig(rate=0.0)).events == []
    plan = make_fault_plan(tparams, FaultConfig(rate=1e-6, horizon=32))
    assert len(plan.events) >= 1 and plan.events[0].tick < 32


def test_fault_config_validates():
    with pytest.raises(ValueError):
        FaultConfig(kinds=("stuck_col", "bitflip"))
    with pytest.raises(ValueError):
        FaultConfig(rate=1.5)


def test_plan_due_cursor():
    plan = FaultPlan([FaultEvent(2, "stuck_col", "a", cols=(0,)),
                      FaultEvent(5, "stuck_col", "b", cols=(1,))],
                     FaultConfig())
    evs, cur = plan.due(tick=3, cursor=0)
    assert [e.path for e in evs] == ["a"] and cur == 1
    evs, cur = plan.due(tick=3, cursor=cur)
    assert evs == [] and cur == 1
    evs, cur = plan.due(tick=9, cursor=cur)
    assert [e.path for e in evs] == ["b"] and cur == 2


def test_constants_and_elastic_plans_equal_jax():
    assert abfp.scale_storage_eps() == jabfp.scale_storage_eps()
    assert drift_detect_rtol() == jfl.drift_detect_rtol()
    for chips, mp, old in ((8, 4, (2, 4)), (6, 4, (2, 4)), (3, 4, (1, 4)),
                           (1, 1, (1, 1)), (5, 2, (4, 2))):
        got = tfault.plan_recovery_mesh(chips, mp, old)
        want = jfault.plan_recovery_mesh(chips, mp, old)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert got.changed == want.changed
        if chips >= mp:
            assert dataclasses.astuple(tfault.plan_elastic_mesh(
                chips, mp, old)) == dataclasses.astuple(
                jfault.plan_elastic_mesh(chips, mp, old))
    with pytest.raises(RuntimeError):
        tfault.plan_elastic_mesh(3, 4, (1, 4))
    with pytest.raises(RuntimeError):
        tfault.plan_recovery_mesh(0, 4, (1, 4))


# ---------------------------------------------------------------------------
# Injection -> detection -> repair against JAX's
# ---------------------------------------------------------------------------


def _roundtrip(pair, mode, ev):
    """Inject ``ev`` on both sides; the port's faulted weights equal JAX's
    and its detection equals JAX's; repair restores the clean pack.
    Returns the port's detection."""
    jparams, tparams = _packs(pair, mode)
    sites = faultlib.fault_sites(tparams)
    site = next(s for s in sites if s.path == ev.path)
    base = faultlib.site_fingerprint(tparams, site)
    jbase = jfl.site_fingerprint(jparams, _jsite(site))
    spare = faultlib.clone_sites(tparams)
    faultlib.apply_event(tparams, ev)
    jbad = jfl.apply_event(jparams, jfl.FaultEvent(*dataclasses.astuple(ev)))
    _equal_to_jax(tparams, jbad, ev.path)
    det = faultlib.detect_site(base, faultlib.site_fingerprint(tparams, site))
    jdet = jfl.detect_site(jbase, jfl.site_fingerprint(jbad, _jsite(site)))
    assert (det.stuck_cols, det.drifted) == (jdet.stuck_cols, jdet.drifted)
    if det.stuck_cols:
        faultlib.repair_stuck(tparams, spare, ev.path, det.stuck_cols)
    if det.drifted:
        faultlib.repair_drift(tparams, spare, ev.path, det.drifted)
    _equal_to_jax(tparams, jparams, ev.path)     # the clean pack again
    return det


@pytest.mark.parametrize("mode", MODES)
def test_stuck_col_roundtrip(pair, mode):
    det = _roundtrip(pair, mode, FaultEvent(0, "stuck_col",
                                            "groups/0/attn/wq", cols=(1, 5)))
    assert det.stuck_cols == (1, 5) and det.drifted == ()


@pytest.mark.parametrize("mode", MODES)
def test_scale_drift_roundtrip(pair, mode):
    tiles = ((0, 3), (3, 7))
    det = _roundtrip(pair, mode, FaultEvent(
        0, "scale_drift", "groups/0/attn/wv", tiles=tiles,
        factors=(1.2, 0.8)))
    assert det.stuck_cols == () and set(det.drifted) >= set(tiles)


def test_stuck_lm_head_and_float_site_roundtrip(pair):
    _roundtrip(pair, "abfp_packed", FaultEvent(0, "stuck_col", "lm_head",
                                               cols=(0, 511)))
    (jp, _), (tp, _) = pair
    tp = _clone(tp)         # float mode: the weights themselves are served
    site = next(s for s in faultlib.fault_sites(tp)
                if s.path == "groups/0/mlp/wo")
    assert not site.packed
    base = faultlib.site_fingerprint(tp, site)
    spare = faultlib.clone_sites(tp)
    faultlib.inject_stuck_cols(tp, site.path, (2, 9))
    jbad = jfl.inject_stuck_cols(jp, site.path, (2, 9))
    _equal_to_jax(tp, jbad, site.path)
    det = faultlib.detect_site(base, faultlib.site_fingerprint(tp, site))
    assert det.stuck_cols == (2, 9) and det.drifted == ()
    faultlib.repair_stuck(tp, spare, site.path, det.stuck_cols)
    _equal_to_jax(tp, jp, site.path)


def test_drift_below_tolerance_not_flagged(pair):
    _, tparams = _packs(pair, "abfp_packed")
    site = faultlib.fault_sites(tparams)[0]
    base = faultlib.site_fingerprint(tparams, site)
    cur = base * (1.0 + 0.1 * drift_detect_rtol())
    assert faultlib.detect_site(base, cur).clean


@pytest.mark.parametrize("mode", MODES)
def test_shard_drop_single_device_kills_sites(pair, mode):
    jparams, tparams = _packs(pair, mode)
    faultlib.inject_shard_drop(tparams)
    jbad = jfl.inject_shard_drop(jparams, shard=0, tp=1)
    for site in faultlib.fault_sites(tparams):
        _equal_to_jax(tparams, jbad, site.path)
        for leaf in faultlib.site_leaves(tparams, site.path):
            assert not leaf.codes.any() and not leaf.scales.any()
            assert not leaf.kcodes.any()
    if mode == "abfp_fused":
        for lp in tparams["layers"]:
            assert not lp["attn"]["qkv"].kcodes.any()
            assert not lp["attn"]["qkv"].scales.any()


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    gap = np.abs(a.astype(np.float64) - b)
    return float((gap / np.spacing(np.maximum(np.abs(a), np.abs(b)))).max())


@pytest.mark.parametrize("mode", MODES)
def test_fingerprints_equal_jax(pair, mode):
    """Per-layer fingerprints bit-equal to JAX's per-layer slice, the site
    (the layer sum) within one f32 ULP; the round's one copy equals the
    per-site reads."""
    jparams, tparams = _packs(pair, mode)
    sites = faultlib.fault_sites(tparams)
    rnd = faultlib.fingerprint_round(tparams, sites)
    for site in sites:
        jleaf = jfl._get_site(jparams, site.path)
        jper = np.asarray(jabfp.packed_tile_fingerprint(jleaf), np.float32)
        for i, leaf in enumerate(faultlib.site_leaves(tparams, site.path)):
            want = jper[i] if site.path.startswith("groups/") else jper
            assert np.array_equal(
                abfp.packed_tile_fingerprint(leaf).numpy(), want)
        got = faultlib.site_fingerprint(tparams, site)
        assert np.array_equal(got, rnd[site.path])
        assert _ulps(got, jfl.site_fingerprint(jparams, _jsite(site))) <= 1


@pytest.mark.parametrize("mode", MODES)
def test_output_error_bound_allclose_jax(pair, mode):
    jparams, tparams = _packs(pair, mode)
    jcfg = JQuantConfig(mode=mode, **KW)
    cfg = QuantConfig(mode=mode, **KW)
    for site in faultlib.fault_sites(tparams):
        want = np.asarray(jabfp.packed_output_error_bound(
            jfl._get_site(jparams, site.path), jcfg), np.float32)
        for i, leaf in enumerate(faultlib.site_leaves(tparams, site.path)):
            got = abfp.packed_output_error_bound(leaf, cfg).numpy()
            w = want[i] if site.path.startswith("groups/") else want
            np.testing.assert_allclose(got, w, rtol=1e-6)
            # A healthy column's probe response sits below the envelope.
            fp = abfp.packed_tile_fingerprint(leaf).sum(0).numpy()
            assert np.all(fp <= got)


# ---------------------------------------------------------------------------
# The three copies of a packed weight, in place
# ---------------------------------------------------------------------------


def _ptrs(params):
    out = []
    for site in faultlib.fault_sites(params):
        for leaf in faultlib.site_leaves(params, site.path):
            out += [leaf.codes.data_ptr(), leaf.scales.data_ptr(),
                    leaf.kcodes.data_ptr()]
    for lp in params["layers"]:
        q = lp["attn"]["qkv"]
        out += [q.kcodes.data_ptr(), q.scales.data_ptr()]
    return out


def assert_three_copies(params, cfg, ptrs):
    """``kcodes == kernel_layout(codes)`` for every site leaf, each layer's
    ``PackedQKV`` equal to a fresh ``concat_qkv`` of its pieces, and no
    served tensor moved."""
    for site in faultlib.fault_sites(params):
        for leaf in faultlib.site_leaves(params, site.path):
            assert torch.equal(leaf.kcodes, kernel_layout(leaf.codes))
    for lp in params["layers"]:
        a = lp["attn"]
        fresh = concat_qkv((a["wq"], a["wk"], a["wv"]), cfg)
        assert a["qkv"].pws == (a["wq"], a["wk"], a["wv"])
        assert torch.equal(a["qkv"].kcodes, fresh.kcodes)
        assert torch.equal(a["qkv"].scales.view(torch.int16),
                           fresh.scales.view(torch.int16))
        assert torch.equal(a["qkv"].gains, fresh.gains)
    assert _ptrs(params) == ptrs


def _same_sites(a, b):
    for site in faultlib.fault_sites(a):
        for x, y in zip(faultlib.site_leaves(a, site.path),
                        faultlib.site_leaves(b, site.path)):
            assert torch.equal(x.codes, y.codes)
            assert torch.equal(x.kcodes, y.kcodes)
            assert torch.equal(x.scales.view(torch.int16),
                               y.scales.view(torch.int16))
    for la, lb in zip(a["layers"], b["layers"]):
        assert torch.equal(la["attn"]["qkv"].kcodes, lb["attn"]["qkv"].kcodes)
        assert torch.equal(la["attn"]["qkv"].scales.view(torch.int16),
                           lb["attn"]["qkv"].scales.view(torch.int16))


THREE_COPY_EVENTS = [
    FaultEvent(0, "stuck_col", "groups/0/attn/wq", cols=(3, 100)),
    FaultEvent(0, "stuck_col", "groups/0/attn/wk", cols=(0, 63)),
    FaultEvent(0, "scale_drift", "groups/0/attn/wv",
               tiles=((0, 5), (3, 60)), factors=(1.2, 0.8)),
    FaultEvent(0, "scale_drift", "groups/0/mlp/wi",
               tiles=((1, 7),), factors=(0.9,)),
    FaultEvent(0, "stuck_col", "lm_head", cols=(11,)),
]


def test_three_copies_after_every_inject_and_repair(pair):
    _, params = _packs(pair, "abfp_fused")
    cfg = QuantConfig(mode="abfp_fused", **KW)
    ptrs = _ptrs(params)
    spare = faultlib.clone_sites(params)
    sites = faultlib.fault_sites(params)
    base = faultlib.fingerprint_round(params, sites)
    for ev in THREE_COPY_EVENTS:
        faultlib.apply_event(params, ev)
        assert_three_copies(params, cfg, ptrs)
        site = next(s for s in sites if s.path == ev.path)
        det = faultlib.detect_site(base[ev.path],
                                   faultlib.site_fingerprint(params, site))
        assert not det.clean
        if det.stuck_cols:
            faultlib.repair_stuck(params, spare, ev.path, det.stuck_cols)
            assert_three_copies(params, cfg, ptrs)
        if det.drifted:
            faultlib.repair_drift(params, spare, ev.path, det.drifted)
            assert_three_copies(params, cfg, ptrs)
        _same_sites(params, spare)
    faultlib.apply_event(params, FaultEvent(0, "shard_drop", "", shard=0))
    assert_three_copies(params, cfg, ptrs)
    faultlib.restore_sites(params, spare)
    assert_three_copies(params, cfg, ptrs)
    _same_sites(params, spare)


# ---------------------------------------------------------------------------
# The engine's arguments (its runs: tests/test_torch_faults_engine.py)
# ---------------------------------------------------------------------------


def _engine(pair, quant, **kw):
    _, (tp, tm) = pair
    return ServingEngine(tp, tm, capacity=4, max_len=64, quant=quant,
                         device="cpu", **kw)


def test_unknown_faults_value_raises(pair):
    with pytest.raises(TypeError):
        _engine(pair, PACKED, faults=object())


def test_fingerprint_equals_jax_reduction_on_stacked_leaf(pair):
    """The site fingerprint is the JAX reduction of the stacked leaf:
    ``packed_tile_fingerprint`` summed over the leading (layer) axis."""
    jparams, tparams = _packs(pair, "abfp_packed")
    site = faultlib.fault_sites(tparams)[0]
    want = jabfp.packed_tile_fingerprint(jfl._get_site(jparams, site.path))
    want = np.asarray(jnp.sum(want.reshape(-1, *want.shape[-2:]), axis=0),
                      np.float32)
    assert _ulps(faultlib.site_fingerprint(tparams, site), want) <= 1
