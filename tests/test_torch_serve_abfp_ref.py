"""The paper's reference numerics served (``abfp_ref``), on the CPU, against
the JAX package: the device key chain and the dense family's engine.

Each ``abfp_ref`` dense call splits its own key, ``fold_in(fold_in(pass
key, fold), call)``, into one key per K-tile and draws each tile's ADC
noise from it.  The port serves that from a KEY TABLE (``models.lm
.pass_key_table``) filled once per pass, and draws on the device with the
tensor forms of ``core.prng``'s ``split``, ``fold_in`` and ``key_bits``.

Held here, bit for bit: the key table against JAX's fold chain for a
dense, an MoE and an encoder-decoder config; the tensor ``split``,
``fold_in`` and ``key_bits`` against ``jax.random``; ``abfp_matmul`` on
a key-table row against the same call on the host key; a pass's key
table in the pass buffers against ``Numerics``' host chain.

Held against the JAX engine's ``abfp_ref`` (tile 32, gain 2, noise 0.5,
``tests/test_prefill.py``'s settings), smollm-360m smoke config with the
JAX package's weights: greedy streams equal, blocking, overlapped (wall
clock) and paged.  Over engine seeds 0..7 every stream of the blocking
engine agreed (33 of 33 tokens on each), so the seeds below are pinned
only as the other engine files pin theirs.  The seed-independent bar is
the teacher-forced one of ``test_torch_model.py``: a prefill pass and 8
decode ticks, each started on both sides from JAX's state and token, on
noise-key seeds 0..3, every pass's logits within ``FORCED_PASS_TOL``
(0.5) and at most ``FORCED_OFF_PASSES`` (3) of the 9 beyond
``FORCED_CLOSE`` (1e-2): a last-bit difference upstream of the scan (rope,
rsqrt, the f32 sums) can move an activation code (ROADMAP queue 3).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.core import abfp as J
from repro.models import init_decode_state as j_init_state
from repro.models import init_params as j_init_params
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import smoke_config
from repro_torch.core import abfp as T
from repro_torch.core import prng
from repro_torch.core.abfp import QuantConfig
from repro_torch.models import Numerics, decode_step, prefill
from repro_torch.models.convert import from_jax_params
from repro_torch.models.lm import (
    ENCODER_FOLD,
    calls_per_layer,
    n_pass_seeds,
    n_pass_words,
    pass_key_table,
    pass_numerics,
    pass_seed_table,
    pass_words,
)
from repro_torch.models.layers import LM_HEAD_FOLD
from repro_torch.serving import Request, ServingEngine
from test_torch_model import (  # noqa: F401 (fixtures)
    FORCED_CLOSE,
    FORCED_OFF_PASSES,
    FORCED_PASS_TOL,
    _state_from_jax,
    jax_prefill,
    jax_step,
)

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker

ARCH = "smollm-360m"
KW = dict(tile_width=32, gain=2.0, noise_lsb=0.5)
REF = QuantConfig(mode="abfp_ref", **KW)
JREF = J.QuantConfig(mode="abfp_ref", **KW)
ENGINE_SEED = 4
PAGED_SEED = 1


def _jwords(key):
    return np.asarray(jax.random.key_data(key), np.uint32)


def _j_chain(key, mcfg):
    """JAX's fold chain of one pass: every decoder layer's calls, the
    encoder layers' (fold 1000 + g), the root's own calls (the cross K/V)
    for an encoder-decoder, and the head's call 0."""
    jk = jnp.asarray(key, jnp.uint32)
    calls = calls_per_layer(mcfg)
    folds = list(range(mcfg.num_layers))
    if mcfg.is_encoder_decoder:
        folds += [ENCODER_FOLD + g for g in range(mcfg.num_encoder_layers)]
    rows = [_jwords(jax.random.fold_in(jax.random.fold_in(jk, f), c))
            for f in folds for c in range(calls)]
    if mcfg.is_encoder_decoder:
        rows += [_jwords(jax.random.fold_in(jk, c)) for c in range(calls)]
    rows.append(_jwords(jax.random.fold_in(
        jax.random.fold_in(jk, LM_HEAD_FOLD), 0)))
    return np.stack(rows)


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-1b-a400m",
                                  "whisper-base"])
def test_key_table_equals_jax_fold_chain(arch):
    mcfg = smoke_config(arch)
    key = prng.split(prng.PRNGKey(9))[1]
    tbl = pass_key_table(mcfg, key)
    assert tbl.dtype == np.uint32 and tbl.shape == (n_pass_seeds(mcfg), 2)
    np.testing.assert_array_equal(tbl, _j_chain(key, mcfg))
    np.testing.assert_array_equal(
        (tbl[:, 0] ^ tbl[:, 1]).view(np.int32), pass_seed_table(mcfg, key))
    words = pass_words(mcfg, REF, key)
    assert words.dtype == np.int32 and words.size == n_pass_words(mcfg, REF)
    assert n_pass_words(mcfg, REF.replace(mode="abfp_packed")) == \
        n_pass_seeds(mcfg)
    # The pass buffers' int32 words read back as the table's keys.
    nx = pass_numerics(REF, torch.from_numpy(words), mcfg)
    np.testing.assert_array_equal(nx.keys.numpy(), tbl.astype(np.int64))


def _tensor_key(key):
    return torch.from_numpy(np.asarray(key, np.uint32).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 7, 2**32 - 1])
def test_device_split_and_fold_in_equal_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    for num in (1, 2, 5, 130):
        got = prng.split(_tensor_key(tk), num)
        assert got.dtype == torch.int64 and got.shape == (num, 2)
        np.testing.assert_array_equal(
            got.numpy(), np.stack([_jwords(k) for k in
                                   jax.random.split(jk, num)]))
    for data in (0, 3, 999_983, 2**32 - 1):
        np.testing.assert_array_equal(
            prng.fold_in(_tensor_key(tk), data).numpy(),
            _jwords(jax.random.fold_in(jk, data)))
    stack = prng.split(tk, 4)
    np.testing.assert_array_equal(
        prng.fold_in(_tensor_key(stack), 11).numpy(),
        prng.fold_in(stack, 11))


@pytest.mark.parametrize("shape", [(7,), (3, 40), (4, 5, 6)])
@pytest.mark.parametrize("seed", [1, 12])
def test_device_key_bits_equal_jax(seed, shape):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
    tk = prng.fold_in(prng.PRNGKey(seed), 5)
    want = np.asarray(jax.random.bits(jk, shape, jnp.uint32))
    got = prng.key_bits(_tensor_key(tk), shape)
    assert got.shape == shape
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # A stack of G keys draws each key's bits.
    keys = prng.split(tk, 3)
    got = prng.key_bits(_tensor_key(keys), shape).numpy()
    for g, k in enumerate(jax.random.split(jk, 3)):
        np.testing.assert_array_equal(
            got[g], np.asarray(jax.random.bits(k, shape, jnp.uint32)))
    np.testing.assert_array_equal(
        prng.uniform(_tensor_key(tk), shape, -0.5, 0.5).numpy(),
        np.asarray(jax.random.uniform(jk, shape, jnp.float32, -0.5, 0.5)))


@pytest.mark.parametrize("tile,m,gains,group", [
    (8, 5, False, None), (32, 9, False, None), (32, 9, True, None),
    (32, 64, False, 1), (16, 3, True, 1)])
def test_scan_on_a_device_key_equals_the_host_key(tile, m, gains, group,
                                                  monkeypatch):
    """``abfp_matmul`` on a (2,) int64 key-table row draws the host key's
    noise: the outputs are bit-equal, at one and at several tiles per
    group."""
    if group is not None:
        monkeypatch.setattr(T, "REF_GROUP_ELEMENTS", group)
    rng = np.random.default_rng(tile + m)
    cfg = QuantConfig(tile_width=tile, gain=4.0, noise_lsb=0.5)
    x = torch.from_numpy(rng.normal(size=(m, 200)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(200, 70)) * 0.1)
                         .astype(np.float32))
    tg = (torch.from_numpy(rng.uniform(1, 8, (200 + tile - 1) // tile)
                           .astype(np.float32)) if gains else None)
    key = prng.fold_in(prng.PRNGKey(tile), m)
    want = T.abfp_matmul(x, w, cfg, key, tile_gains=tg)
    got = T.abfp_matmul(x, w, cfg, _tensor_key(key), tile_gains=tg)
    assert torch.equal(got, want)
    other = T.abfp_matmul(x, w, cfg, _tensor_key(prng.fold_in(key, 1)),
                          tile_gains=tg)
    assert not torch.equal(other, want)
    with pytest.raises(ValueError, match="not an int seed"):
        T.abfp_matmul(x, w, cfg, _tensor_key(key).to(torch.int32))


def test_as_table_hands_each_call_its_key_row():
    """A key-mode ``abfp_ref`` Numerics turns into a key table at the top
    of a pass; each call's row is the host chain's key, and the table
    rows after the layers are the encoder's, the root's and the head's."""
    mcfg = smoke_config("whisper-base")
    key = prng.fold_in(prng.PRNGKey(1), 2)
    nx = Numerics(REF, key)
    tbl = nx.as_table(mcfg.num_layers, calls_per_layer(mcfg), "cpu",
                      extra=(ENCODER_FOLD, ENCODER_FOLD + 1), root=True)
    assert tbl.seeds is None and tbl.keys.shape == (n_pass_seeds(mcfg), 2)
    for fold in (0, 1, ENCODER_FOLD + 1, LM_HEAD_FOLD):
        rows = tbl.fold(fold).next_seeds(2 if fold != LM_HEAD_FOLD else 1)
        want = nx.fold(fold).next_seeds(len(rows))
        for got, k in zip(rows, want):
            np.testing.assert_array_equal(got.numpy(), k.astype(np.int64))
    root = tbl.next_seeds(2)
    for c, got in enumerate(root):
        np.testing.assert_array_equal(got.numpy(),
                                      prng.fold_in(key, c).astype(np.int64))


# ---------------------------------------------------------------------------
# The engine against the JAX engine's abfp_ref
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    jm, tm = j_smoke_config(ARCH), smoke_config(ARCH)
    jp = j_init_params(jax.random.PRNGKey(0), jm)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tm, device="cpu")
    return (jp, jm), (tp, tm)


PROMPT_LENS = (3, 40, 17, 9, 26, 5)
MAX_NEW = (6, 4, 8, 5, 3, 7)


def _workload(cls, vocab):
    rng = np.random.default_rng(11)
    return [cls(uid=i, prompt=rng.integers(1, vocab, n).tolist(),
                max_new_tokens=m)
            for i, (n, m) in enumerate(zip(PROMPT_LENS, MAX_NEW))]


def _streams(done):
    return {r.uid: list(r.generated) for r in done}


@pytest.mark.parametrize("kind", ["blocking", "overlapped", "paged"])
def test_engine_streams_match_jax(pair, kind):
    (jp, jm), (tp, tm) = pair
    kw = dict(capacity=4, max_len=128, seed=ENGINE_SEED,
              prefill_chunks=(16, 64, 128))
    if kind == "overlapped":
        kw.update(clock=time.perf_counter, overlap=True)
    if kind == "paged":
        kw.update(max_len=64, prefill_chunks=(8,), paged=True,
                  seed=PAGED_SEED)
    jeng = JServingEngine(jp, jm, quant=JREF, **kw)
    jdone = jeng.run(_workload(JRequest, jm.vocab_size))
    teng = ServingEngine(tp, tm, quant=REF, device="cpu", **kw)
    tdone = teng.run(_workload(Request, tm.vocab_size))
    if kind == "overlapped":
        jeng.close()
        teng.close()
    assert [r.uid for r in tdone] == [r.uid for r in jdone]
    assert _streams(tdone) == _streams(jdone)
    assert all(len(r.generated) == r.max_new_tokens for r in tdone)
    assert teng.metrics.conservation() == jeng.metrics.conservation()
    if kind != "overlapped":
        assert teng.ticks == jeng.ticks
    if kind == "paged":
        assert teng.pool.stats().held == 0
    # Weights stay float: abfp_ref quantizes inside every call.
    assert isinstance(teng.params["layers"][0]["attn"]["wq"], torch.Tensor)


@pytest.mark.parametrize("seed", range(4))
def test_passes_from_jax_state_match_jax(pair, seed, jax_step, jax_prefill):
    """Teacher-forced: every pass starts both sides from JAX's state and
    JAX's token, so a difference cannot carry over from an earlier pass."""
    (jp, jm), (tp, tm) = pair
    b = 2
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, tm.vocab_size, size=(b, 16)).astype(np.int32)
    n = np.array([16, 9], np.int32)
    js = j_init_state(jm, b, max_len=32)

    def keys(t):
        k = prng.fold_in(prng.PRNGKey(seed), t)
        return jnp.asarray(k, jnp.uint32), k

    jk, tk = keys(0)
    tl, _ = prefill(tp, _state_from_jax(js), torch.from_numpy(toks),
                    torch.from_numpy(n), tm, Numerics(REF, tk))
    jl, js = jax_prefill(jp, js, jnp.asarray(toks), jnp.asarray(n), jk, jm,
                         JREF)
    diffs = []
    for t in range(1, 10):
        jl, tl = np.asarray(jl), tl.numpy()
        diffs.append(float(np.abs(jl - tl).max()))
        if t == 9:
            break
        tok = jl.argmax(-1).astype(np.int32)
        jk, tk = keys(t)
        tl, _ = decode_step(tp, _state_from_jax(js), torch.from_numpy(tok),
                            tm, Numerics(REF, tk))
        jl, js = jax_step(jp, js, jnp.asarray(tok), jk, jm, JREF)
    print(f"abfp_ref seed {seed}: per-pass logits max-abs difference "
          f"{[float(f'{d:.2g}') for d in diffs]}")
    assert max(diffs) < FORCED_PASS_TOL
    assert sum(d > FORCED_CLOSE for d in diffs) <= FORCED_OFF_PASSES, diffs
