"""Fault plans on every model family: the port's fault sites, injection,
detection and repair against the JAX package's, on the CPU, on the smoke configs of granite-moe-1b-a400m (MoE),
xlstm-350m (mLSTM / sLSTM), recurrentgemma-2b (RG-LRU + windowed
attention) and whisper-base (encoder-decoder).

Weights are the JAX package's, carried across by
``models.convert.from_jax_params``, packed by each side at tile 32, gain
4, noise 0.5.  Held to the JAX package:

  * ``fault_sites`` (paths, packed flag, columns, tiles) and
    ``make_fault_plan``'s events, in float and ``abfp_fused``; the float
    sites' paths of the FULL configs, read from
    ``jax.eval_shape(init_params)`` (nothing full-size is computed): that
    covers recurrentgemma-2b's remainder layers ``extra/0`` and
    ``extra/1``;
  * every site's injected and repaired weights, layer by layer and expert
    by expert, equal to the rows of JAX's stacked leaf, and
    ``detect_site``'s verdicts equal to JAX's;
  * per-leaf fingerprints bit-equal to JAX's per-row fingerprint; the site
    fingerprint (the sum over its n leaves) within n - 1 f32 ULPs of JAX's
    reduction (at least 1): the worst case of summing n positive f32 terms
    in another order (XLA reduces the stacked rows in its own order; the
    port sums the leaves one after another).

Port-only: after every inject and repair ``kcodes == kernel_layout(codes)``
and each ``PackedQKV`` equals a fresh ``concat_qkv``, and no served tensor
moved.  The engine's fault loop on these families:
``tests/test_torch_faults_families_engine.py``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke_config
from repro.core import abfp as jabfp
from repro.core.abfp import QuantConfig as JQuantConfig
from repro.models import init_params as j_init_params
from repro.models.packing import pack_model_params as j_pack
from repro.serving import faults as jfl
from repro_torch.configs import smoke_config
from repro_torch.core import abfp
from repro_torch.core.abfp import QuantConfig, kernel_layout
from repro_torch.kernels.abfp_decode_fused import PackedQKV, concat_qkv
from repro_torch.models.convert import from_jax_params
from repro_torch.models.packing import pack_model_params
from repro_torch.serving import FaultConfig, make_fault_plan
from repro_torch.serving import faults as faultlib
from repro_torch.serving.faults import FaultEvent

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker

pytestmark = pytest.mark.fault

ARCHS = ("granite-moe-1b-a400m", "xlstm-350m", "recurrentgemma-2b",
         "whisper-base")
KW = dict(tile_width=32, gain=4.0, noise_lsb=0.5)

# Each family's explicit plan: a stuck column pair and a drifted tile pair
# on sites the dense decoder does not have.
PLANS = {
    "granite-moe-1b-a400m": ("groups/0/moe/wo", "groups/0/moe/wi"),
    "xlstm-350m": ("groups/1/slstm/w_up", "groups/0/mlstm/wq"),
    "recurrentgemma-2b": ("groups/1/rglru/w_in", "groups/2/attn/wq"),
    "whisper-base": ("encoder/layers/mlp/wi", "groups/0/cross/wk"),
}
_PAIRS = {}
_JPACKS = {}


def _pair(arch):
    """(JAX params, JAX config), (port params, port config) of ``arch``'s
    smoke config, built once per module."""
    if arch not in _PAIRS:
        jm, tm = j_smoke_config(arch), smoke_config(arch)
        jp = j_init_params(jax.random.PRNGKey(0), jm)
        tp = from_jax_params(jax.tree.map(np.asarray, jp), tm, device="cpu")
        _PAIRS[arch] = (jp, jm), (tp, tm)
    return _PAIRS[arch]


def _packs(arch, mode):
    """Fresh packs of the same weights on both sides (injection writes the
    port's in place)."""
    (jp, jm), (tp, tm) = _pair(arch)
    if mode == "float":
        return jp, _clone(tp)
    if (arch, mode) not in _JPACKS:     # JAX's arrays are immutable
        _JPACKS[arch, mode] = j_pack(jp, JQuantConfig(mode=mode, **KW), jm)
    return (_JPACKS[arch, mode],
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
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


def _jnp(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _rows(jleaf, site):
    """JAX's stacked leaf as rows in (layer, expert) order: the leading
    axes flattened (a float MoE weight keeps its (E, K, N) per layer)."""
    if isinstance(jleaf, jabfp.PackedWeight):
        arrs = (_jnp(jleaf.codes), _jnp(jleaf.scales))
        keep = 2
    else:
        arrs = (_jnp(jleaf),)
        keep = 3 if "/moe/" in site.path else 2
    if site.path == "lm_head":
        return [arrs]
    return list(zip(*(a.reshape(-1, *a.shape[-keep:]) for a in arrs)))


def _equal_to_jax(tparams, jparams, site):
    jrows = _rows(jfl._get_site(jparams, site.path), site)
    leaves = faultlib.site_leaves(tparams, site.path)
    assert len(leaves) == len(jrows)
    for leaf, want in zip(leaves, jrows):
        if isinstance(leaf, abfp.PackedWeight):
            got = (_np(leaf.codes), _np(leaf.scales))
        else:
            got = (_np(leaf),)
        for g, w in zip(got, want):
            assert np.array_equal(g, w), site.path


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    gap = np.abs(a.astype(np.float64) - b)
    return float((gap / np.spacing(np.maximum(np.abs(a), np.abs(b)))).max())


# ---------------------------------------------------------------------------
# Sites and plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ("float", "abfp_fused"))
@pytest.mark.parametrize("arch", ARCHS)
def test_sites_and_plans_equal_jax(arch, mode):
    jparams, tparams = _packs(arch, mode)
    sites = faultlib.fault_sites(tparams)
    assert _tuples(sites) == _tuples(jfl.fault_sites(jparams))
    assert [s.path for s in sites] == sorted(s.path for s in sites)
    for s in sites:
        n = len(_rows(jfl._get_site(jparams, s.path), s))
        assert len(faultlib.site_leaves(tparams, s.path)) == n, s.path
    for seed in (0, 1):
        got = make_fault_plan(tparams, FaultConfig(rate=0.05, seed=seed))
        want = jfl.make_fault_plan(jparams,
                                   jfl.FaultConfig(rate=0.05, seed=seed))
        assert _tuples(got.events) == _tuples(want.events)
    assert make_fault_plan(tparams, FaultConfig(rate=0.0)).events == []


def _meta_params(tree, mcfg):
    """The port's param layout of a JAX ``eval_shape`` tree, as meta
    tensors: ``models.convert.from_jax_params``'s unstacking without
    values (groups[j][g] is layer g * len(pattern) + j, extra[r] layer
    n_groups * len(pattern) + r, the encoder's stacked layers a list)."""
    glen = len(mcfg.block_pattern or ("attention",))
    n_groups = mcfg.num_layers // glen

    def layer(node, lead):
        if isinstance(node, dict):
            return {k: layer(v, lead) for k, v in node.items()}
        return torch.empty(node.shape[lead:], device="meta")

    layers = [None] * mcfg.num_layers
    for j, stacked in enumerate(tree["groups"]):
        for g in range(n_groups):
            layers[g * glen + j] = layer(stacked, 1)
    for r, node in enumerate(tree.get("extra", ())):
        layers[n_groups * glen + r] = layer(node, 0)
    out = {"embed": layer(tree["embed"], 0), "layers": layers,
           "final_norm": layer(tree["final_norm"], 0)}
    if "lm_head" in tree:
        out["lm_head"] = layer(tree["lm_head"], 0)
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = {"layers": [layer(enc["layers"], 1)
                                     for _ in range(mcfg.num_encoder_layers)],
                          "final_norm": layer(enc["final_norm"], 0)}
    return out


@pytest.mark.parametrize("arch", ARCHS + ("smollm-360m",))
def test_full_config_site_paths_equal_jax(arch):
    jm = j_get_config(arch)
    tree = jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0), jm))
    want = _tuples(jfl.fault_sites(tree))
    got = _tuples(faultlib.fault_sites(_meta_params(tree, jm)))
    assert got == want
    paths = [s[0] for s in got]
    if arch == "recurrentgemma-2b":
        # 26 layers: 8 groups of (R, R, A) and 2 remainder layers.
        assert {p.split("/")[1] for p in paths if p.startswith("extra/")} \
            == {"0", "1"}
        assert "extra/1/rglru/w_in" in paths


# ---------------------------------------------------------------------------
# Injection -> detection -> repair, every site, against JAX's
# ---------------------------------------------------------------------------


def _ptrs(params):
    out = []
    for site in faultlib.fault_sites(params):
        for leaf in faultlib.site_leaves(params, site.path):
            if isinstance(leaf, abfp.PackedWeight):
                out += [leaf.codes.data_ptr(), leaf.scales.data_ptr(),
                        leaf.kcodes.data_ptr()]
            else:
                out.append(leaf.data_ptr())
    for q in _qkvs(params):
        out += [q.kcodes.data_ptr(), q.scales.data_ptr()]
    return out


def _qkvs(params):
    return [lp["attn"]["qkv"] for lp in params["layers"]
            if isinstance(lp.get("attn", {}).get("qkv"), PackedQKV)]


def assert_three_copies(params, cfg, ptrs):
    for site in faultlib.fault_sites(params):
        for leaf in faultlib.site_leaves(params, site.path):
            if isinstance(leaf, abfp.PackedWeight):
                assert torch.equal(leaf.kcodes, kernel_layout(leaf.codes))
    for q in _qkvs(params):
        fresh = concat_qkv(q.pws, cfg)
        assert torch.equal(q.kcodes, fresh.kcodes)
        assert torch.equal(q.scales.view(torch.int16),
                           fresh.scales.view(torch.int16))
    assert _ptrs(params) == ptrs


def _event(site, kind):
    if kind == "stuck_col":
        return FaultEvent(0, kind, site.path,
                          cols=(1, site.n_cols - 2))
    return FaultEvent(0, kind, site.path,
                      tiles=((0, 3), (site.n_tiles - 1, site.n_cols - 1)),
                      factors=(1.2, 0.8))


@pytest.mark.parametrize("kind", ("stuck_col", "scale_drift"))
@pytest.mark.parametrize("arch", ARCHS)
def test_every_site_inject_detect_repair_equal_jax(arch, kind):
    """abfp_fused (the mode with the QKV concatenation): every site of the
    family, one event each, injected and repaired on both sides."""
    jparams, tparams = _packs(arch, "abfp_fused")
    cfg = QuantConfig(mode="abfp_fused", **KW)
    ptrs = _ptrs(tparams)
    spare = faultlib.clone_sites(tparams)
    sites = faultlib.fault_sites(tparams)
    base = faultlib.fingerprint_round(tparams, sites)
    for site in sites:
        ev = _event(site, kind)
        jbase = jfl.site_fingerprint(jparams, _jsite(site))
        faultlib.apply_event(tparams, ev)
        jbad = jfl.apply_event(jparams,
                               jfl.FaultEvent(*dataclasses.astuple(ev)))
        _equal_to_jax(tparams, jbad, site)
        assert_three_copies(tparams, cfg, ptrs)
        det = faultlib.detect_site(base[site.path],
                                   faultlib.site_fingerprint(tparams, site))
        jdet = jfl.detect_site(jbase, jfl.site_fingerprint(jbad,
                                                           _jsite(site)))
        assert (det.stuck_cols, det.drifted) == (jdet.stuck_cols,
                                                 jdet.drifted), site.path
        if kind == "stuck_col":
            assert det.stuck_cols == ev.cols
            faultlib.repair_stuck(tparams, spare, site.path, det.stuck_cols)
        else:
            assert set(det.drifted) >= set(ev.tiles)
            faultlib.repair_drift(tparams, spare, site.path, det.drifted)
        assert_three_copies(tparams, cfg, ptrs)
        _equal_to_jax(tparams, jparams, site)       # the clean pack again
    faultlib.apply_event(tparams, FaultEvent(0, "shard_drop", "", shard=0))
    jbad = jfl.inject_shard_drop(jparams, shard=0, tp=1)
    for site in sites:
        _equal_to_jax(tparams, jbad, site)
    faultlib.restore_sites(tparams, spare)
    assert_three_copies(tparams, cfg, ptrs)
    for site in sites:
        _equal_to_jax(tparams, jparams, site)


@pytest.mark.parametrize("arch", ("granite-moe-1b-a400m", "whisper-base"))
def test_float_sites_inject_repair_equal_jax(arch):
    """Float mode serves the weights themselves: an MoE (E, K, N) expert
    weight and an encoder weight, stuck and repaired as JAX's."""
    jparams, tparams = _packs(arch, "float")
    path = PLANS[arch][0]
    site = next(s for s in faultlib.fault_sites(tparams) if s.path == path)
    assert not site.packed
    base = faultlib.site_fingerprint(tparams, site)
    spare = faultlib.clone_sites(tparams)
    faultlib.inject_stuck_cols(tparams, path, (2, 9))
    _equal_to_jax(tparams, jfl.inject_stuck_cols(jparams, path, (2, 9)),
                  site)
    det = faultlib.detect_site(base, faultlib.site_fingerprint(tparams, site))
    assert det.stuck_cols == (2, 9) and det.drifted == ()
    faultlib.repair_stuck(tparams, spare, path, det.stuck_cols)
    _equal_to_jax(tparams, jparams, site)


@pytest.mark.parametrize("arch", ARCHS)
def test_fingerprints_equal_jax(arch):
    """Every leaf's fingerprint bit-equal to JAX's row of the stacked
    leaf's; the site fingerprint within n - 1 f32 ULPs (n leaves, at least
    1) of JAX's reduction; the round's one copy equals the per-site
    reads."""
    jparams, tparams = _packs(arch, "abfp_packed")
    sites = faultlib.fault_sites(tparams)
    rnd = faultlib.fingerprint_round(tparams, sites)
    for site in sites:
        jfp = np.asarray(jabfp.packed_tile_fingerprint(
            jfl._get_site(jparams, site.path)), np.float32)
        jfp = jfp.reshape(-1, *jfp.shape[-2:])
        leaves = faultlib.site_leaves(tparams, site.path)
        assert len(leaves) == len(jfp)
        for leaf, want in zip(leaves, jfp):
            assert np.array_equal(
                abfp.packed_tile_fingerprint(leaf).numpy(), want)
        got = faultlib.site_fingerprint(tparams, site)
        assert np.array_equal(got, rnd[site.path])
        assert _ulps(got, jfl.site_fingerprint(jparams, _jsite(site))) \
            <= max(1, len(leaves) - 1)
        assert faultlib.detect_site(got, rnd[site.path]).clean
