"""The port's encoder-decoder and stub-frontend models against the JAX
package's, on the CPU (``smoke_config("whisper-base")``: 2 + 2 layers,
d_model 128, 4 heads of 32, f32; ``smoke_config("phi-3-vision-4.2b")``).

JAX's parameters are carried across by ``from_jax_params`` and both sides
take the same noise keys (the port's threefry chain); JAX's Pallas kernels
run in interpret mode.  Inputs are made with numpy from a seed.

Bars:
  * the stub frontends: uniform bits equal; the bf16 features equal at
    the smoke sizes, and at whisper's full (1,500, 512) within
    ``STUB_FLIPS`` last-bit differences (``erfinv``; 10-13 seen);
  * every dense call's noise seed of an enc-dec pass equal to the JAX
    fold chain: decoder layer ``i`` under ``fold(i)``, encoder layer ``g``
    under ``fold(1000 + g)``, every layer's cross K/V under the root key at
    calls 0 and 1, the head under ``fold(999_983)``;
  * float: ``encode``, the cross K/V, ``forward`` with
    ``encoder_features`` (flash off and on), phi-3-vision's ``forward`` on
    embeddings, ``decode_step`` / ``prefill`` with ``enc_kv`` and the
    losses within rtol = atol = 1e-5 (f32 sum order); phi-3-vision's ABFP
    forward is held on the card (``chip_smoke.py`` phase 15e);
  * ``abfp_kernel`` / ``abfp_packed`` (tile 32, gain 8, noise 0.5): one
    dense call at most ``CALL_FLIPS`` one-ULP bf16 flips of 16,384 (3
    seen: the plain versions keep the kernel's f32 order, which XLA's CPU
    interpret mode contracts into FMAs); a flip moves an activation code,
    and non-causal attention spreads one moved row to every row of the
    encoder, so the encoder (both modes) and the forward over it
    (``abfp_kernel`` with flash) are held to ``ABFP_PASS_TOL`` (the
    encoder's output 0.045-0.052 seen, the logits 0.088-0.10), with the
    differing rows counted in the printout;
  * converted and packed encoder and cross weights bit-equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.core.abfp import QuantConfig as JQuantConfig
from repro.kernels.ops import _key_to_seed as j_key_to_seed
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import frontends as jfr
from repro.models import init_decode_state as j_init_decode_state
from repro.models import init_params as j_init_params
from repro.models import lm as jlm
from repro.models import prefill as j_prefill
from repro.models.layers import Numerics as JNumerics
from repro.models.packing import pack_model_params as j_pack
from repro.training.train_lib import chunked_cross_entropy as j_chunked_ce
from repro_torch import optim
from repro_torch.configs import smoke_config
from repro_torch.core import prng
from repro_torch.core.abfp import PackedWeight, QuantConfig
from repro_torch.kernels import ops
from repro_torch.launch import train as train_cli
from repro_torch.models import (
    Numerics,
    decode_step,
    encode,
    encode_cross_kv,
    forward,
    frontends,
    init_decode_state,
    init_params,
    prefill,
)
from repro_torch.models.convert import from_jax_params
from repro_torch.models.lm import (
    ENCODER_FOLD,
    calls_per_layer,
    check_supported,
    pass_numerics,
    pass_seed_table,
)
from repro_torch.models.packing import pack_model_params
from repro_torch.training import TrainConfig, make_train_step

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker

WHISPER, PHI = "whisper-base", "phi-3-vision-4.2b"
B, S, S_ENC = 2, 16, 64
KW = dict(tile_width=32, gain=8.0, noise_lsb=0.5)
STUB_FLIPS = 32
CALL_FLIPS = 8
ABFP_PASS_TOL = 0.5


def _configs(arch, flash=False):
    return (dataclasses.replace(j_smoke_config(arch), use_flash_attention=flash),
            dataclasses.replace(smoke_config(arch), use_flash_attention=flash))


@pytest.fixture(scope="module")
def whisper():
    jm, tm = _configs(WHISPER)
    jp = j_init_params(jax.random.PRNGKey(0), jm)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), tm, device="cpu")


@pytest.fixture(scope="module")
def phi():
    jm, tm = _configs(PHI)
    jp = j_init_params(jax.random.PRNGKey(1), jm)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), tm, device="cpu")


def _keys(seed):
    k = prng.PRNGKey(seed)
    return jnp.asarray(k, jnp.uint32), k


def _features(seed, b=B, s=S_ENC, d=128):
    """Stub audio features (JAX's draw) as f32 numpy."""
    return np.asarray(jfr.audio_stub_features(jax.random.PRNGKey(seed), b, s,
                                              d), np.float32)


def _tokens(seed, b=B, s=S, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab, (b, s)).astype(
        np.int32)


def _np(t):
    return t.float().numpy()


# ---------------------------------------------------------------------------
# The stub frontends (the ``tests/test_frontends.py`` stub cases)
# ---------------------------------------------------------------------------


def test_audio_stub_shape_and_dtype():
    out = frontends.audio_stub_features(prng.PRNGKey(0), 2, 16, 64,
                                        device="cpu")
    assert out.shape == (2, 16, 64) and out.dtype == torch.bfloat16
    out32 = frontends.audio_stub_features(prng.PRNGKey(0), 1, 8, 32,
                                          dtype=torch.float32, device="cpu")
    assert out32.dtype == torch.float32 and torch.isfinite(out32).all()


def test_vision_stub_shape_and_dtype():
    out = frontends.vision_stub_embeddings(prng.PRNGKey(0), 2, 16, 64,
                                           device="cpu")
    assert out.shape == (2, 16, 64) and out.dtype == torch.bfloat16


def test_stubs_deterministic_per_key():
    a, b, c = (frontends.audio_stub_features(prng.PRNGKey(k), 1, 8, 32,
                                             device="cpu")
               for k in (7, 7, 8))
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("shape", [(2, 16, 64), (1, 64, 128),
                                   (1, 1500, 512)])
@pytest.mark.parametrize("which", ["audio", "vision"])
def test_stub_features_equal_jax(which, shape):
    seed = sum(shape)
    jfn = {"audio": jfr.audio_stub_features,
           "vision": jfr.vision_stub_embeddings}[which]
    tfn = {"audio": frontends.audio_stub_features,
           "vision": frontends.vision_stub_embeddings}[which]
    want = np.asarray(jfn(jax.random.PRNGKey(seed), *shape), np.float32)
    got = _np(tfn(prng.PRNGKey(seed), *shape, device="cpu"))
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    ju = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                       minval=lo, maxval=1.0))
    np.testing.assert_array_equal(
        prng.uniform(prng.PRNGKey(seed), shape, lo, 1.0).numpy(), ju)
    flips = int((got != want).sum())
    print(f"{which} {shape}: {flips} of {want.size} bf16 features differ")
    assert flips <= (STUB_FLIPS if want.size > 10 ** 5 else 0)
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)


# ---------------------------------------------------------------------------
# Noise keys of an encoder-decoder pass
# ---------------------------------------------------------------------------


def _j_seed(key, *folds):
    k = key
    for f in folds:
        k = jax.random.fold_in(k, f)
    return int(j_key_to_seed(jax.random.key_data(k)
                             if jnp.issubdtype(k.dtype, jax.dtypes.prng_key)
                             else k))


def test_seed_table_rows_equal_jax_fold_chain():
    _, tm = _configs(WHISPER)
    jk, tk = _keys(11)
    calls = calls_per_layer(tm)
    assert calls == 8          # wq wk wv wo, cross wq wo, MLP wi wo
    nx = pass_numerics(QuantConfig(mode="abfp_packed", **KW),
                       torch.from_numpy(pass_seed_table(tm, tk)), tm)
    for li in range(tm.num_layers):
        got = nx.fold(li).next_seeds(calls).tolist()
        assert got == [_j_seed(jk, li, c) for c in range(calls)]
    for g in range(tm.num_encoder_layers):
        got = nx.fold(ENCODER_FOLD + g).next_seeds(calls).tolist()
        assert got == [_j_seed(jk, 1000 + g, c) for c in range(calls)]
    assert nx.next_seeds(2).tolist() == [_j_seed(jk, 0), _j_seed(jk, 1)]
    assert int(nx.fold(999_983).next_seeds(1)[0]) == _j_seed(jk, 999_983, 0)


def test_every_call_seed_of_a_forward_equals_jax(whisper, monkeypatch):
    """Every dense call of an ``abfp_packed`` forward with encoder features,
    recorded in call order: the encoder's layers (1000 + g, calls 0-5),
    each decoder layer's cross wk and wv (the root's calls 0 and 1, the
    same for every layer), the decoder layers (calls 0-7) and the head."""
    _, tm = _configs(WHISPER)
    jk, tk = _keys(5)
    seen = []
    dense = ops.dense

    def record(x, w, cfg, key=None, plain=False):
        seen.append(int(key))
        return dense(x, w, cfg, key, plain)

    monkeypatch.setattr(ops, "dense", record)
    forward(whisper[1], torch.from_numpy(_tokens(1)), tm,
            Numerics(QuantConfig(mode="abfp_packed", **KW), tk),
            encoder_features=torch.from_numpy(_features(2)))
    want = [_j_seed(jk, 1000 + g, c) for g in range(tm.num_encoder_layers)
            for c in range(6)]
    want += [_j_seed(jk, c) for _ in range(tm.num_layers) for c in (0, 1)]
    want += [_j_seed(jk, li, c) for li in range(tm.num_layers)
             for c in range(8)]
    want += [_j_seed(jk, 999_983, 0)]
    assert seen == want


# ---------------------------------------------------------------------------
# Float passes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flash", [False, True])
def test_float_encoder_and_forward_match_jax(flash, whisper):
    jm, tm = _configs(WHISPER, flash)
    jp, tp = whisper
    feats, toks = _features(3), _tokens(4)
    jn, tn = JNumerics(JQuantConfig(mode="float")), Numerics(
        QuantConfig(mode="float"))
    je = jlm.encode(jp, jnp.asarray(feats), jm, jn)
    te = encode(tp, torch.from_numpy(feats), tm, tn)
    np.testing.assert_allclose(_np(te), np.asarray(je), rtol=1e-5, atol=1e-5)
    jkv = jlm.encode_cross_kv(jp, je, jm, jn)[0]
    tkv = encode_cross_kv(tp, torch.from_numpy(np.array(je)), tm, tn)
    for li, (k, v) in enumerate(tkv):
        assert k.shape == (B, S_ENC, tm.num_kv_heads, tm.resolved_head_dim)
        np.testing.assert_allclose(_np(k), np.asarray(jkv[0][li]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_np(v), np.asarray(jkv[1][li]),
                                   rtol=1e-5, atol=1e-5)
    jl, _ = j_forward(jp, jnp.asarray(toks), jm,
                      encoder_features=jnp.asarray(feats))
    tl, _ = forward(tp, torch.from_numpy(toks), tm,
                    encoder_features=torch.from_numpy(feats))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="encoder_features"):
        forward(tp, torch.from_numpy(toks), tm)


def test_phi3_vision_forward_on_embeddings_matches_jax(phi):
    jm, tm = _configs(PHI)
    jp, tp = phi
    emb = np.asarray(jfr.vision_stub_embeddings(jax.random.PRNGKey(6), B, S,
                                                tm.d_model), np.float32)
    jl, _ = j_forward(jp, jnp.asarray(emb), jm)
    tl, _ = forward(tp, torch.from_numpy(emb), tm)
    assert tl.shape == (B, S, tm.vocab_size)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=1e-5, atol=1e-5)


def _j_enc_kv(jp, jm, feats):
    """JAX's per-slot cross K/V: a list over pattern positions of stacked
    (NG, B, S_enc, KH, D) pairs."""
    jn = JNumerics(JQuantConfig(mode="float"))
    return jlm.encode_cross_kv(jp, jlm.encode(jp, jnp.asarray(feats), jm, jn),
                               jm, jn)


def test_decode_and_prefill_with_enc_kv_match_jax(whisper):
    """A prompt chunk (row 1 padded) through ``prefill``, then three decode
    ticks, each side on its own encoder K/V: logits and KV caches within
    1e-5."""
    jm, tm = _configs(WHISPER)
    jp, tp = whisper
    feats = _features(8)
    jkv = _j_enc_kv(jp, jm, feats)
    tkv = [(torch.from_numpy(np.array(jkv[0][0][li])),
            torch.from_numpy(np.array(jkv[0][1][li])))
           for li in range(tm.num_layers)]
    toks = _tokens(9, s=8)
    n = np.array([8, 5], np.int32)
    jst = j_init_decode_state(jm, B, 32)
    tst = init_decode_state(tm, B, 32, device="cpu")
    jl, jst = j_prefill(jp, jst, jnp.asarray(toks), jnp.asarray(n), jm,
                        enc_kv=jkv)
    tl, tst = prefill(tp, tst, torch.from_numpy(toks), torch.from_numpy(n),
                      tm, enc_kv=tkv)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=1e-5, atol=1e-5)
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    for _ in range(3):
        jl, jst = j_decode_step(jp, jst, jnp.asarray(tok), jm, enc_kv=jkv)
        tl, tst = decode_step(tp, tst, torch.from_numpy(tok), tm, enc_kv=tkv)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=1e-5,
                                   atol=1e-5)
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    for li in range(tm.num_layers):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                _np(tst["layers"][li]["kv"][name]),
                np.asarray(jst["groups"][0]["kv"][name][li]), rtol=1e-5,
                atol=1e-5)
    assert tst["position"].tolist() == np.asarray(jst["position"]).tolist()


# ---------------------------------------------------------------------------
# ABFP passes (plain versions against Pallas interpret)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,flash", [("abfp_kernel", True),
                                        ("abfp_packed", False)])
def test_abfp_encoder_and_forward_match_jax(mode, flash, whisper):
    jm, tm = _configs(WHISPER, flash)
    jp, tp = whisper
    jq, tq = JQuantConfig(mode=mode, **KW), QuantConfig(mode=mode, **KW)
    jk, tk = _keys(1)
    feats, toks = _features(3), _tokens(4)
    # One dense call on equal inputs: the encoder's first wq.
    x = np.random.default_rng(0).standard_normal((B * S_ENC, 128)).astype(
        np.float32)
    wq = jax.tree.map(lambda a: a[0], jp["encoder"]["layers"])["attn"]["wq"]
    if mode == "abfp_packed":
        wq = j_pack({"wq": wq}, jq)["wq"]
    jd = np.asarray(JNumerics(jq, jk).dense(jnp.asarray(x), wq), np.float32)
    td = _np(Numerics(tq, tk).dense(
        torch.from_numpy(x), pack_model_params(
            {"wq": tp["encoder"]["layers"][0]["attn"]["wq"]}, tq)["wq"]
        if mode == "abfp_packed" else tp["encoder"]["layers"][0]["attn"]["wq"]))
    flips = int((jd != td).sum())
    assert flips <= CALL_FLIPS
    np.testing.assert_allclose(td, jd, rtol=2 ** -7, atol=0)
    # Whole passes: the encoder in both modes, the forward over it (the
    # evaluation route) in abfp_kernel with flash attention.
    je = np.asarray(jlm.encode(jp, jnp.asarray(feats), jm,
                               JNumerics(jq, jk)), np.float32)
    te = _np(encode(tp, torch.from_numpy(feats), tm, Numerics(tq, tk)))
    de = np.abs(je - te)
    print(f"{mode}: wq {flips} flips of {jd.size}; encoder max-abs "
          f"{de.max():.3g}, rows differing {int((de.max(-1) > 0).sum())} of "
          f"{B * S_ENC}")
    assert de.max() < ABFP_PASS_TOL
    if mode != "abfp_kernel":
        return
    jl = np.asarray(j_forward(jp, jnp.asarray(toks), jm, JNumerics(jq, jk),
                              encoder_features=jnp.asarray(feats))[0])
    tl = _np(forward(tp, torch.from_numpy(toks), tm, Numerics(tq, tk),
                     encoder_features=torch.from_numpy(feats))[0])
    dl = np.abs(jl - tl)
    print(f"logits max-abs {dl.max():.3g}, argmax equal "
          f"{float((jl.argmax(-1) == tl.argmax(-1)).mean()):.3f}")
    assert dl.max() < ABFP_PASS_TOL


# ---------------------------------------------------------------------------
# Conversion, packing, supported paths, training
# ---------------------------------------------------------------------------


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _tbits(t):
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def test_converted_and_packed_encoder_and_cross_bit_equal(whisper):
    jm, tm = _configs(WHISPER)
    jp, tp = whisper
    enc = tp["encoder"]
    assert len(enc["layers"]) == tm.num_encoder_layers
    for g, lp in enumerate(enc["layers"]):
        for blk in ("attn", "mlp"):
            for name, t in lp[blk].items():
                np.testing.assert_array_equal(
                    _tbits(t), _bits(jp["encoder"]["layers"][blk][name])[g])
    for li, lp in enumerate(tp["layers"]):
        for name, t in lp["cross"].items():
            np.testing.assert_array_equal(
                _tbits(t), _bits(jp["groups"][0]["cross"][name])[li])
        np.testing.assert_array_equal(
            lp["norm3"]["scale"].numpy(),
            np.asarray(jp["groups"][0]["norm3"]["scale"])[li])
    cfg = QuantConfig(mode="abfp_fused", **KW)
    jpk = j_pack(jp, JQuantConfig(mode="abfp_fused", **KW), jm)
    tpk = pack_model_params(tp, cfg, tm)

    def same(pw, jpw, i):
        assert isinstance(pw, PackedWeight)
        for f in ("codes", "scales", "gains"):
            np.testing.assert_array_equal(_tbits(getattr(pw, f)),
                                          _bits(getattr(jpw, f))[i])

    for g, lp in enumerate(tpk["encoder"]["layers"]):
        assert "qkv" not in lp["attn"]
        for blk in ("attn", "mlp"):
            for name, pw in lp[blk].items():
                same(pw, jpk["encoder"]["layers"][blk][name], g)
    for li, lp in enumerate(tpk["layers"]):
        assert "qkv" in lp["attn"] and "qkv" not in lp["cross"]
        for name, pw in lp["cross"].items():
            same(pw, jpk["groups"][0]["cross"][name], li)


def test_check_supported_takes_both_families_on_every_path():
    for arch in (WHISPER, PHI):
        for serving in (True, False):
            check_supported(smoke_config(arch), serving=serving)
    params = init_params(0, smoke_config(WHISPER), device="cpu")
    assert set(params["encoder"]) == {"layers", "final_norm"}
    assert set(params["layers"][0]) >= {"cross", "norm3"}
    assert float(params["layers"][0]["norm3"]["scale"][0]) == 1.0


def _j_loss(jp, jm, inputs, labels, feats=None):
    """JAX's ``loss_fn`` body in float: the forward's hidden states through
    the chunked cross-entropy, plus 0.01 x aux (0 here)."""
    jn = JNumerics(JQuantConfig(mode="float"))
    hidden, aux = j_forward(jp, jnp.asarray(inputs), jm, jn,
                            encoder_features=feats, return_hidden=True)
    return float(j_chunked_ce(jp, hidden, jnp.asarray(labels), jm, jn)
                 + 0.01 * aux)


def test_loss_on_embeds_labels_and_encoder_features_matches_jax(phi,
                                                                whisper):
    """The port's first float train step on phi-3-vision's stub-frontend
    batch (``embeds`` + ``labels``: the branch of JAX's ``loss_fn``) and on
    whisper's (``tokens`` + ``encoder_features``): its loss within 1e-5 of
    JAX's ``loss_fn`` body on the same batch."""
    _, tk = _keys(2)
    jm, tm = _configs(PHI)
    emb = np.asarray(jfr.vision_stub_embeddings(jax.random.PRNGKey(3), B, S,
                                                tm.d_model), np.float32)
    labels = _tokens(5)
    jm_w, tm_w = _configs(WHISPER)
    toks, feats = _tokens(6, s=S + 1), _features(7)
    for (jp, tp), jm_, tm_, batch, want in (
            (phi, jm, tm, {"embeds": emb, "labels": labels},
             _j_loss(phi[0], jm, emb, labels)),
            (whisper, jm_w, tm_w, {"tokens": toks, "encoder_features": feats},
             _j_loss(whisper[0], jm_w, toks[:, :-1], toks[:, 1:],
                     jnp.asarray(feats)))):
        tinit, tstep = make_train_step(
            tm_, optim.AdamW(optim.cosine_one_cycle(1e-3, 4)), TrainConfig(),
            device="cpu")
        _, tmet = tstep(tinit(tp), batch, tk)
        np.testing.assert_allclose(float(tmet["loss"]), want, rtol=1e-5)


def test_train_driver_falls_back_to_the_text_backbone(capsys):
    out = train_cli.main(["--arch", PHI, "--reduced", "--device", "cpu",
                          "--steps", "1", "--batch", "2", "--seq", "8"])
    assert "training the text backbone" in capsys.readouterr().out
    assert len(out["losses"]) == 1 and np.isfinite(out["losses"][0])
