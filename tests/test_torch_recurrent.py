"""The port's recurrent and hybrid families (RG-LRU, mLSTM, sLSTM, the
ring-buffer window cache, ``RecurrentRunner``) against the JAX package's,
on the CPU.

Weights are the JAX package's (``init_params`` on the recurrentgemma-2b
and xlstm-350m smoke configs: f32, d_model 128), carried across by
``models.convert.from_jax_params``; block inputs and states are drawn
from numpy with a seed.  Bars:

  * blocks (``rglru_block``, ``mlstm_block``, ``slstm_block``), the decode
    step (3 rows) and a 9-position chunk with 6 real tokens in row 1 and
    an idle row 2, each from a random state:
      - ``float``: outputs at real positions and the new state within
        rtol = atol = ``FLOAT_TOL`` of JAX's (XLA's exp, tanh and logistic
        differ from PyTorch's in the last f32 bit in 9-59 % of draws);
      - ``abfp_packed`` / ``abfp_fused`` (tile 32, gain 8, noise 0.5, one
        pinned noise key): the bf16 outputs that differ from JAX's are
        counted, and the rows (tokens) they fall in; at most
        ``ABFP_ROWS`` row may differ (measured: 0 in 9 of the 12 cases; 1
        row of 15 in the mLSTM chunk, 54 elements in ``abfp_packed`` and
        4 in ``abfp_fused``, and 1 element in the RG-LRU chunk, where an
        f32 last-bit difference moved one activation code of the output
        projection; a wrong seed or call order moves every row); the
        state within ``ABFP_STATE_TOL``;
      - the idle row's state bit for bit unchanged on both sides;
  * the ring buffer (``_append_attend_one`` and ``chunk_append_attend``
    at window 8, float and int8 caches): caches and lengths bit-equal to
    JAX's, outputs within ``FLOAT_TOL``; 20 tokens in chunks of 9 and 11
    wrap the ring inside and across chunks;
  * in the port alone, in float: chunked prefill equals token-by-token
    decode bit for bit (logits and every state tensor) for
    recurrentgemma-2b, ``hybrid-window8`` (its window cut to 8) and
    xlstm-350m, and an idle slot keeps its whole state (the JAX package's
    own xlstm identity fails, ROADMAP queue 3; the port's holds);
  * ``RecurrentRunner`` (the ``tests/test_runners.py`` analogues) and the
    converter's groups-plus-remainder layout, which a decode step on
    5- and 3-layer configs holds to JAX's logits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.core.abfp import QuantConfig as JQuantConfig
from repro.models import decode_step as j_decode_step
from repro.models import init_decode_state as j_init_state
from repro.models import init_params as j_init_params
from repro.models import layers as j_layers
from repro.models import recurrent as j_rec
from repro.models.layers import Numerics as JNumerics
from repro.models.packing import pack_model_params as j_pack
from repro_torch.configs import smoke_config
from repro_torch.core import prng
from repro_torch.core.abfp import PackedWeight, QuantConfig
from repro_torch.kernels.abfp_decode_fused import PackedQKV
from repro_torch.models import (
    Numerics,
    clone_state,
    decode_step,
    init_decode_state,
    init_params,
    pack_model_params,
    prefill,
)
from repro_torch.models import layers, recurrent
from repro_torch.models.convert import from_jax_params, to_tensor
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.faults import FaultConfig
from repro_torch.serving.runners import (
    DecoderRunner,
    EncDecRunner,
    RecurrentRunner,
    runner_for,
    state_tensors,
)

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker

FLOAT_TOL = 1e-5
ABFP_ROWS = 1
ABFP_STATE_TOL = 2e-2
KEY_SEED = 3
B, S = 3, 9
N_TOKENS = np.array([S, 6, 0], np.int32)
ABFP = dict(tile_width=32, gain=8.0, noise_lsb=0.5)
# block -> (arch, layer index, params key)
BLOCKS = {"rglru": ("recurrentgemma-2b", 0, "rglru"),
          "mlstm": ("xlstm-350m", 0, "mlstm"),
          "slstm": ("xlstm-350m", 1, "slstm")}


def _configs(name, **kw):
    return (dataclasses.replace(j_smoke_config(name), **kw),
            dataclasses.replace(smoke_config(name), **kw))


@pytest.fixture(scope="module")
def models():
    """Each arch's JAX params (numpy leaves) and the port's copy."""
    out = {}
    for arch in ("recurrentgemma-2b", "xlstm-350m"):
        jm, tm = _configs(arch)
        jp = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0),
                                                    jm))
        out[arch] = (jm, tm, jp, from_jax_params(jp, tm, device="cpu"))
    return out


def _quant(mode):
    kw = {} if mode == "float" else ABFP
    return JQuantConfig(mode=mode, **kw), QuantConfig(mode=mode, **kw)


def _keys(seed=KEY_SEED):
    k = prng.fold_in(prng.PRNGKey(seed), 0)
    return jnp.asarray(k, jnp.uint32), k


def _random_state(tstate: dict, rng) -> dict:
    """Numpy draws in the shapes of a port block state (one layer's
    ``rec``): standard normal, the mLSTM stabilizer ``m`` included."""
    return {k: (rng.normal(size=tuple(t.shape)) * (0.3 if k == "C" else 1.0)
                ).astype(np.float32) for k, t in tstate.items()}


def _j_block(name):
    return {"rglru": j_rec.rglru_block, "mlstm": j_rec.mlstm_block,
            "slstm": j_rec.slstm_block}[name]


def _t_block(name):
    return {"rglru": recurrent.rglru_block, "mlstm": recurrent.mlstm_block,
            "slstm": recurrent.slstm_block}[name]


def _flips(got: np.ndarray, want, what: str) -> int:
    """Count the (rows, d) bf16 outputs that differ from JAX's, and the
    rows (tokens) they fall in; hold the rows to ``ABFP_ROWS``."""
    w = np.asarray(want, np.float32)
    diff = got != w
    n, rows = int(diff.sum()), int(diff.any(axis=-1).sum())
    print(f"{what}: {n}/{got.size} elements in {rows}/{got.shape[0]} rows "
          f"differ, max-abs {float(np.abs(got - w).max()):.3g}")
    assert rows <= ABFP_ROWS, what
    return n


@pytest.mark.parametrize("path", ["decode", "chunk"])
@pytest.mark.parametrize("mode", ["float", "abfp_packed", "abfp_fused"])
@pytest.mark.parametrize("block", list(BLOCKS))
def test_block_matches_jax(models, block, mode, path):
    arch, li, key = BLOCKS[block]
    jm, tm, jp, tp = models[arch]
    jq, tq = _quant(mode)
    glen = len(jm.block_pattern)
    jparams = jax.tree.map(lambda a: a[0], jp["groups"][li % glen][key])
    tparams = tp["layers"][li][key]
    if mode != "float":
        jparams, tparams = j_pack(jparams, jq), pack_model_params(tparams, tq)
    rng = np.random.default_rng(2 * list(BLOCKS).index(block)
                                + (path == "chunk"))
    s = 1 if path == "decode" else S
    x = rng.normal(size=(B, s, jm.d_model)).astype(np.float32)
    tstate0 = init_decode_state(tm, B, 16, device="cpu")["layers"][li]["rec"]
    st = _random_state(tstate0, rng)
    n = None if path == "decode" else N_TOKENS
    jk, tk = _keys()

    jy, jst = jax.jit(lambda p, x, s, n, k: _j_block(block)(
        p, x, jm, JNumerics(jq, k), state=s, n_tokens=n))(
        jparams, jnp.asarray(x), {k: jnp.asarray(v) for k, v in st.items()},
        None if n is None else jnp.asarray(n), jk)
    tst = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    ty, tst = _t_block(block)(tparams, torch.from_numpy(x), tm,
                              Numerics(tq, tk), state=tst,
                              n_tokens=None if n is None
                              else torch.from_numpy(n))
    real = (np.ones((B, 1), bool) if n is None
            else np.arange(s)[None, :] < n[:, None])
    jy = np.asarray(jy, np.float32)[real]
    tyr = ty.float().numpy()[real]
    if mode == "float":
        np.testing.assert_allclose(tyr, jy, rtol=FLOAT_TOL, atol=FLOAT_TOL)
    else:
        _flips(tyr, jy, f"{block} {mode} {path} outputs")
    tol = FLOAT_TOL if mode == "float" else ABFP_STATE_TOL
    for k in st:
        np.testing.assert_allclose(tst[k].float().numpy(),
                                   np.asarray(jst[k], np.float32),
                                   rtol=tol, atol=tol, err_msg=k)
        if n is not None:
            # The idle row: bit for bit what it held, on both sides.
            assert np.array_equal(tst[k][2].numpy(), st[k][2]), k
            assert np.array_equal(np.asarray(jst[k])[2], st[k][2]), k


def test_chunk_scan_at_chunk_4_matches_jax():
    """The chunkwise mLSTM scan, ported whole: at chunk 4 over 10
    positions (padded to 12), from a random state."""
    rng = np.random.default_rng(5)
    b, nh, s, dh = 2, 2, 10, 8
    q, k, v = (rng.normal(size=(b, nh, s, dh)).astype(np.float32)
               for _ in range(3))
    li = rng.normal(size=(b, nh, s)).astype(np.float32)
    lf = -np.abs(rng.normal(size=(b, nh, s))).astype(np.float32)
    st = (rng.normal(size=(b, nh, dh, dh)).astype(np.float32) * 0.3,
          rng.normal(size=(b, nh, dh)).astype(np.float32),
          rng.normal(size=(b, nh)).astype(np.float32))
    jh, jst = j_rec._mlstm_chunk_scan(*(jnp.asarray(a) for a in
                                        (q, k, v, li, lf)),
                                      tuple(jnp.asarray(a) for a in st), 4)
    th, tst = recurrent._mlstm_chunk_scan(
        *(torch.from_numpy(a) for a in (q, k, v, li, lf)),
        tuple(torch.from_numpy(a) for a in st), 4)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=FLOAT_TOL,
                               atol=FLOAT_TOL)
    for a, b_ in zip(tst, jst):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_),
                                   rtol=FLOAT_TOL, atol=FLOAT_TOL)


# ---------------------------------------------------------------------------
# The ring buffer
# ---------------------------------------------------------------------------

W, KH, H, D = 8, 2, 4, 8


def _cache(kv_quant: bool, lengths, rng):
    shape = (len(lengths), W, KH, D)
    if kv_quant:
        c = {"k": rng.integers(-127, 128, shape).astype(np.int8),
             "v": rng.integers(-127, 128, shape).astype(np.int8),
             "k_scale": rng.uniform(0.5, 2.0, shape[:3]).astype(np.float32),
             "v_scale": rng.uniform(0.5, 2.0, shape[:3]).astype(np.float32)}
    else:
        c = {"k": rng.normal(size=shape).astype(np.float32),
             "v": rng.normal(size=shape).astype(np.float32)}
    c["length"] = np.asarray(lengths, np.int32)
    return c


def _sides(cache):
    """The same cache on both sides (bf16 scales from the f32 draws)."""
    j = {k: jnp.asarray(v, jnp.bfloat16 if "scale" in k else None)
         for k, v in cache.items()}
    t = {k: (torch.from_numpy(v).to(torch.bfloat16) if "scale" in k
             else torch.from_numpy(v.copy())) for k, v in cache.items()}
    return j, t


def _assert_caches_equal(tc, jc):
    for k, v in jc.items():
        assert torch.equal(tc[k].float(),
                           torch.from_numpy(np.array(v, np.float32))), k


@pytest.mark.parametrize("kv_quant", [False, True])
def test_ring_decode_step_matches_jax(kv_quant):
    """One decode step on rings at lengths 3 (filling), 8 (full, writes
    slot 0) and 19 (wrapped twice)."""
    rng = np.random.default_rng(7)
    jc, tc = _sides(_cache(kv_quant, [3, 8, 19], rng))
    q = rng.normal(size=(3, 1, H, D)).astype(np.float32)
    k = rng.normal(size=(3, 1, KH, D)).astype(np.float32)
    v = rng.normal(size=(3, 1, KH, D)).astype(np.float32)
    jo, jc = j_layers._append_attend_one(*(jnp.asarray(a) for a in (q, k, v)),
                                         jc, W)
    to, tc = layers._append_attend_one(*(torch.from_numpy(a)
                                         for a in (q, k, v)), tc, W)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=FLOAT_TOL,
                               atol=FLOAT_TOL)
    _assert_caches_equal(tc, jc)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_ring_chunks_wrap_like_jax(kv_quant):
    """20 tokens per row in chunks of 9 and 11 (each padded by 2), a ring
    of 8: the ring wraps inside and across chunks; row 1 starts mid-ring
    and row 2 is idle in the second chunk."""
    rng = np.random.default_rng(8)
    jc, tc = _sides(_cache(kv_quant, [0, 5, 0], rng))
    for c, n in ((9, [9, 9, 9]), (11, [11, 11, 0])):
        q = rng.normal(size=(3, c + 2, H, D)).astype(np.float32)
        k = rng.normal(size=(3, c + 2, KH, D)).astype(np.float32)
        v = rng.normal(size=(3, c + 2, KH, D)).astype(np.float32)
        n = np.asarray(n, np.int32)
        before = {k_: t.clone() for k_, t in tc.items()}
        jo, jc = j_layers.chunk_append_attend(
            *(jnp.asarray(a) for a in (q, k, v)), jc,
            n_tokens=jnp.asarray(n), window=W)
        to, tc = layers.chunk_append_attend(
            *(torch.from_numpy(a) for a in (q, k, v)), tc,
            n_tokens=torch.from_numpy(n), window=W)
        real = np.arange(c + 2)[None, :] < n[:, None]
        np.testing.assert_allclose(to.numpy()[real], np.asarray(jo)[real],
                                   rtol=FLOAT_TOL, atol=FLOAT_TOL)
        _assert_caches_equal(tc, jc)
        for k_, t in tc.items():
            if n[2] == 0:
                assert torch.equal(t[2], before[k_][2]), k_
    assert tc["length"].tolist() == [20, 25, 9]


# ---------------------------------------------------------------------------
# Chunked prefill against token-by-token decode, in the port (float)
# ---------------------------------------------------------------------------


def _port_cfg(name):
    if name.startswith("hybrid-window8"):
        return dataclasses.replace(smoke_config("recurrentgemma-2b"),
                                   window_size=8,
                                   kv_quant=name.endswith("kvquant"))
    return smoke_config(name)


@pytest.mark.parametrize("arch,length,chunks", [
    ("recurrentgemma-2b", 12, (5, 7)), ("xlstm-350m", 12, (5, 7)),
    ("hybrid-window8", 12, (5, 7)), ("hybrid-window8", 20, (9, 11)),
    ("hybrid-window8-kvquant", 20, (9, 11))])
def test_prefill_bit_identical(arch, length, chunks):
    """Chunked prefill (each chunk padded by 2) == token-by-token decode,
    bit for bit: the last logits and every state tensor."""
    mcfg = _port_cfg(arch)
    params = init_params(0, mcfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, mcfg.vocab_size, (2, length)).astype(np.int32))
    s1 = init_decode_state(mcfg, 2, 2 * length, device="cpu")
    for t in range(length):
        l1, s1 = decode_step(params, s1, toks[:, t], mcfg)
    s2 = init_decode_state(mcfg, 2, 2 * length, device="cpu")
    pos = 0
    for c in chunks:
        tk = torch.zeros(2, c + 2, dtype=torch.int32)
        tk[:, :c] = toks[:, pos:pos + c]
        l2, s2 = prefill(params, s2, tk, torch.full((2,), c), mcfg)
        pos += c
    assert torch.equal(l1, l2)
    for a, b in zip(state_tensors(s1), state_tensors(s2)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "xlstm-350m",
                                  "hybrid-window8"])
def test_prefill_idle_slot_untouched(arch):
    """A slot with n_tokens == 0 keeps its whole state bit for bit, and
    the active slot advances as it does alone."""
    mcfg = _port_cfg(arch)
    params = init_params(0, mcfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, mcfg.vocab_size, (2, 6)).astype(np.int32))
    s0 = init_decode_state(mcfg, 2, 16, device="cpu")
    prefill(params, s0, toks[:, :3], torch.tensor([3, 3]), mcfg)
    _, both = prefill(params, clone_state(s0), toks,
                      torch.tensor([6, 6]), mcfg)
    _, one = prefill(params, clone_state(s0), toks, torch.tensor([6, 0]),
                     mcfg)
    for a, b, z in zip(state_tensors(one), state_tensors(both),
                       state_tensors(s0)):
        assert torch.equal(a[0], b[0])
        assert torch.equal(a[1], z[1])


# ---------------------------------------------------------------------------
# Decode state, packing, converter, runners
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "xlstm-350m"])
def test_decode_state_layout_matches_jax(arch):
    """Layer i's state holds JAX's leaves (group g of pattern position j,
    or the remainder layer), shapes and dtypes; ring caches have
    window_size slots whatever max_len is."""
    jm, tm = _configs(arch, num_layers=5, kv_quant=True)
    js = j_init_state(jm, 2, 100)
    ts = init_decode_state(tm, 2, 100, device="cpu")
    glen = len(jm.block_pattern)
    for i, layer in enumerate(ts["layers"]):
        g, j = divmod(i, glen)
        jl = (jax.tree.map(lambda a: a[g], js["groups"][j]) if g < 5 // glen
              else js["extra"][i - (5 // glen) * glen])
        flat_j = jax.tree_util.tree_leaves_with_path(jl)
        assert len(flat_j) == len(state_tensors(layer))
        for path, leaf in flat_j:
            t = layer
            for p in path:
                t = t[p.key]
            assert tuple(t.shape) == leaf.shape
            assert to_tensor(np.asarray(leaf), "cpu").dtype == t.dtype
            assert torch.equal(to_tensor(np.asarray(leaf), "cpu"), t)
    if arch == "recurrentgemma-2b":
        assert ts["layers"][2]["kv"]["k"].shape[1] == tm.window_size


@pytest.mark.parametrize("arch,layers_", [("recurrentgemma-2b", 5),
                                          ("xlstm-350m", 3)])
def test_convert_groups_and_remainder(arch, layers_):
    """groups[j][g] -> layer g * len(pattern) + j, extra[r] -> layer
    n_groups * len(pattern) + r, leaf for leaf; an abfp_fused decode step
    then folds each layer's flat index into its noise key as JAX folds
    g * len(pattern) + j and its remainder index (logits within
    ``ABFP_STATE_TOL``, greedy tokens equal)."""
    jm, tm = _configs(arch, num_layers=layers_, kv_quant=True)
    jp = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(2), jm))
    tp = from_jax_params(jp, tm, device="cpu")
    glen = len(jm.block_pattern)
    ng = layers_ // glen
    assert len(tp["layers"]) == layers_ and len(jp["extra"]) == layers_ % glen
    for i, layer in enumerate(tp["layers"]):
        want = (jax.tree.map(lambda a: a[i // glen], jp["groups"][i % glen])
                if i < ng * glen else jp["extra"][i - ng * glen])
        got = jax.tree.map(lambda a: a.numpy(), layer)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, b)
    jq, tq = _quant("abfp_fused")
    jpp, tpp = j_pack(jp, jq, jm), pack_model_params(tp, tq, tm)
    jk, tk = _keys()
    tok = np.array([5, 300], np.int32)
    jl, _ = jax.jit(lambda p, s, t, k: j_decode_step(
        p, s, t, jm, JNumerics(jq, k)))(jpp, j_init_state(jm, 2, 8),
                                        jnp.asarray(tok), jk)
    tl, _ = decode_step(tpp, init_decode_state(tm, 2, 8, device="cpu"),
                        torch.from_numpy(tok), tm, Numerics(tq, tk))
    jl = np.asarray(jl)
    assert np.abs(jl - tl.numpy()).max() < ABFP_STATE_TOL
    np.testing.assert_array_equal(tl.numpy().argmax(-1), jl.argmax(-1))


def test_qkv_only_where_the_fused_decode_runs():
    """abfp_fused packing builds the fused QKV concatenation only under a
    full-attention model's ``attn`` blocks: mLSTM blocks and windowed
    attention carry none; the dense tree keeps one per layer."""
    q = QuantConfig(mode="abfp_fused", **ABFP)

    def qkvs(node):
        if isinstance(node, dict):
            return sum(qkvs(v) for v in node.values()) + (
                "qkv" in node)
        if isinstance(node, list):
            return sum(qkvs(v) for v in node)
        return 0

    for arch, want in (("xlstm-350m", 0), ("recurrentgemma-2b", 0),
                       ("smollm-360m", 2)):
        mcfg = smoke_config(arch)
        packed = pack_model_params(init_params(0, mcfg, device="cpu"), q,
                                   mcfg)
        assert qkvs(packed) == want, arch
        if arch == "xlstm-350m":
            assert isinstance(packed["layers"][0]["mlstm"]["wq"],
                              PackedWeight)
        if arch == "smollm-360m":
            assert isinstance(packed["layers"][0]["attn"]["qkv"], PackedQKV)


def test_runner_for_mapping():
    for arch, cls in (("recurrentgemma-2b", RecurrentRunner),
                      ("xlstm-350m", RecurrentRunner),
                      ("smollm-360m", DecoderRunner),
                      ("granite-moe-1b-a400m", DecoderRunner),
                      ("phi-3-vision-4.2b", DecoderRunner),
                      ("whisper-base", EncDecRunner)):
        assert type(runner_for(smoke_config(arch))) is cls, arch
    with pytest.raises(NotImplementedError):
        runner_for(dataclasses.replace(smoke_config("whisper-base"),
                                       frontend="video_stub"))


def test_recurrent_runner_costs_no_pages_and_never_pages():
    r = runner_for(smoke_config("xlstm-350m"))
    assert r.fixed_state and not r.paged_ok
    assert r.capacity_cost(10, 16) == 0
    assert r.capacity_cost(100_000, 16) == 0
    assert runner_for(smoke_config("smollm-360m")).paged_ok
    mcfg = smoke_config("recurrentgemma-2b")
    params = init_params(0, mcfg, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(params, mcfg, capacity=2, max_len=16, device="cpu",
                      paged=True)
    # A fault plan is taken (over JAX's groups/j sites; the runs against
    # JAX's engine: tests/test_torch_faults_families_engine.py).
    eng = ServingEngine(params, mcfg, capacity=2, max_len=16, device="cpu",
                        faults=FaultConfig(rate=0.1))
    assert "groups/2/attn/wq" in [s.path for s in eng._fault_sites]


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "smollm-360m"])
def test_fits_past_max_len_only_with_fixed_state(arch):
    mcfg = smoke_config(arch)
    eng = ServingEngine(init_params(0, mcfg, device="cpu"), mcfg,
                        capacity=2, max_len=16, device="cpu")
    long_req = Request(uid=0, prompt=[1] * 40, max_new_tokens=8)
    assert eng.fits(long_req) == (arch != "smollm-360m")
    assert eng.fits(Request(uid=1, prompt=[1] * 8, max_new_tokens=4))
    assert not eng.fits(Request(uid=2, prompt=[], max_new_tokens=4))


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "xlstm-350m"])
def test_reset_fills_like_jax(arch):
    """The slot reset puts row i back to the JAX package's fill (sLSTM's
    m at -1e30, everything else 0, ring caches included) and touches no
    other row."""
    mcfg = dataclasses.replace(smoke_config(arch), kv_quant=True)
    runner = runner_for(mcfg)
    state = init_decode_state(mcfg, 3, 16, device="cpu")
    fresh = clone_state(state)
    for t in state_tensors(state):
        t.fill_(3)
    filled = clone_state(state)
    runner.make_reset()(state, 1)
    for a, z, f in zip(state_tensors(state), state_tensors(fresh),
                       state_tensors(filled)):
        assert torch.equal(a[1], z[1])
        assert torch.equal(a[0], f[0]) and torch.equal(a[2], f[2])
    ms = [t for layer in state["layers"] for k, t in
          layer.get("rec", {}).items() if k == "m"]
    if arch == "xlstm-350m":
        assert min(float(m[1].min()) for m in ms) == float(np.float32(-1e30))
        assert any(float(m[1].flatten()[0]) == 0.0 for m in ms)
