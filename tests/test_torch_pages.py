"""The port's paged KV cache against the JAX package's, on the CPU.

Three layers, as in ``tests/test_pages.py``:

  * the allocator: ``repro_torch.serving.pages`` (the port's own copy)
    runs the pool cases of the JAX suite with their seeds and invariants,
    and a random op sequence gives the JAX pool's results step for step;
  * the device side: ``paged_append_attend`` against the JAX package's on
    equal pools, tables and values, for a decode tick and a chunk, float
    and int8.  The port's pools carry one scratch page past the JAX
    pool's last (it takes the dropped writes); pages 0..NP-1 and the int8
    codes and scales must be bit-equal to JAX's after the scatter,
    sentinel and past-table lanes included, and the outputs equal within
    the f32 bar of ``tests/test_torch_attention.py`` (rtol = atol = 1e-5:
    only the dot products' f32 sum order differs) in f32, one bf16 ULP in
    bf16;
  * the engine: the port's paged engine gives the JAX paged engine's
    streams and tick count in float, with ``kv_quant``, and in
    ``abfp_packed`` / ``abfp_fused`` on pinned engine seeds (a one-ULP
    difference of XLA's CPU order can part a greedy stream, ROADMAP queue
    3; the seeds are ones where all streams agree, as the other stream
    tests pin theirs).  The prefix-cache cases of the JAX suite run on
    both engines with equal streams and pool counters.

The reference's own ``test_paged_bit_identical_unchunked`` does not give
one result: the JAX paged engine's unchunked greedy streams differ between
processes of one checkout.  So the unchunked analogue holds the port's
paged streams to its unpaged ones, and its paged decode ticks to JAX's on
equal tokens, pages and tables (logits within 1e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.core.abfp import QuantConfig as JQuantConfig
from repro.models import init_params as j_init_params
from repro.models.layers import paged_append_attend as j_paged_append_attend
from repro.serving import PagePool as JPagePool
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import smoke_config
from repro_torch.core.abfp import QuantConfig
from repro_torch.models import init_decode_state
from repro_torch.models.convert import from_jax_params, to_tensor
from repro_torch.models.layers import (
    _append_attend_one,
    _paged_view,
    chunk_append_attend,
    paged_append_attend,
)
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.pages import (
    PagePool,
    pages_needed,
    plan_chunk,
    prefix_key,
)

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker

ARCH = "smollm-360m"

# ---------------------------------------------------------------------------
# PagePool allocator (host only): the JAX suite's cases on the port's copy
# ---------------------------------------------------------------------------


def test_pages_needed_ceil_div():
    assert pages_needed(1, 16) == 1
    assert pages_needed(16, 16) == 1
    assert pages_needed(17, 16) == 2
    assert pages_needed(0, 16) == 0


def test_alloc_release_roundtrip():
    pool = PagePool(4, 16)
    got = pool.alloc(3, "a")
    assert got is not None and len(set(got)) == 3
    assert pool.stats().free == 1 and pool.tenant_held("a") == 3
    pool.release(got, "a")
    assert pool.stats().free == 4 and pool.tenant_held("a") == 0
    pool.check()


def test_alloc_all_or_nothing():
    pool = PagePool(4, 16)
    assert pool.alloc(4) is not None
    assert pool.alloc(1) is None            # dry, nothing cached to evict
    pool.check()


def test_share_then_release_keeps_page_until_last_ref():
    pool = PagePool(2, 16)
    [p] = pool.alloc(1, "a")
    pool.share([p], "b")
    pool.release([p], "a")
    assert pool.ref[p] == 1                 # b still holds it
    pool.release([p], "b")
    assert pool.stats().free == 2
    pool.check()


def test_cow_exclusive_is_noop_shared_splits():
    pool = PagePool(3, 16)
    [p] = pool.alloc(1, "a")
    assert pool.cow(p, "a") == p            # exclusive: write in place
    pool.share([p], "b")
    q = pool.cow(p, "b")                    # shared: b gets a private copy
    assert q is not None and q != p
    assert pool.ref[p] == 1 and pool.ref[q] == 1
    assert pool.stats().cow_copies == 1
    pool.check()


def test_cow_pool_exhausted_returns_none():
    pool = PagePool(2, 16)
    pages = pool.alloc(2, "a")
    pool.share([pages[0]], "b")
    assert pool.cow(pages[0], "b") is None  # no page left for the copy
    pool.check()


def test_prefix_cache_register_lookup_and_lru_eviction():
    pool = PagePool(3, 4)
    keys = [prefix_key(None, [i, i, i, i]) for i in range(3)]
    pages = [pool.alloc(1)[0] for _ in range(3)]
    for k, p in zip(keys, pages):
        pool.register(k, p)
        pool.release([p])                   # cache-only now
    assert pool.stats().cached == 3 and pool.stats().free == 0
    pool.lookup(keys[0])                    # touch: keys[0] becomes MRU
    got = pool.alloc(2)                     # must evict the 2 LRU entries
    assert got is not None
    assert pool.lookup(keys[0]) is not None     # survivor
    assert pool.lookup(keys[1]) is None and pool.lookup(keys[2]) is None
    assert pool.stats().prefix_evictions == 2
    pool.check()


def test_prefix_key_chains_commit_to_whole_prefix():
    a = prefix_key(None, [1, 2])
    assert prefix_key(a, [3, 4]) != prefix_key(prefix_key(None, [9, 9]),
                                               [3, 4])
    assert prefix_key(a, [3, 4]) == prefix_key(prefix_key(None, [1, 2]),
                                               [3, 4])


def test_plan_chunk_write_range_and_growth():
    extra, writes = plan_chunk(10, 7, [4, 5], 8)
    assert extra == 1 and writes == [1]
    extra, writes = plan_chunk(0, 8, [], 8)
    assert extra == 1 and writes == []


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pool_randomized_invariants_match_jax(seed):
    """The JAX suite's random op sequence (seed 0 is its own), on the
    port's pool and the JAX pool side by side: the same pages, refs, free
    lists and counters after every op, and the invariants hold."""
    rng = np.random.default_rng(seed)
    pool, jpool = PagePool(8, 4), JPagePool(8, 4)
    held = []
    for _ in range(300):
        op = rng.integers(0, 4)
        if op == 0:
            n = int(rng.integers(1, 3))
            got = pool.alloc(n, "t")
            assert got == jpool.alloc(n, "t")
            if got is not None:
                held.extend(got)
        elif op == 1 and held:
            p = held.pop(int(rng.integers(0, len(held))))
            pool.release([p], "t")
            jpool.release([p], "t")
        elif op == 2 and held:
            p = held[int(rng.integers(0, len(held)))]
            q = pool.cow(p, "t")
            assert q == jpool.cow(p, "t")
            if q is not None and q != p:
                held[held.index(p)] = q
        elif op == 3 and held:
            p = held[int(rng.integers(0, len(held)))]
            k = int(rng.integers(0, 1 << 30))
            pool.register(k, p)
            jpool.register(k, p)
        pool.check()
        assert pool.ref.tolist() == jpool.ref.tolist()
        assert pool._free == jpool._free
        assert dataclasses.asdict(pool.stats()) == dataclasses.asdict(
            jpool.stats())
    pool.release(held, "t")
    pool.check()


# ---------------------------------------------------------------------------
# paged_append_attend against the JAX package's
# ---------------------------------------------------------------------------

NP_, PS, KH, H, D = 6, 4, 2, 4, 8
SENT = NP_
# Row 0: pages 2, 5, 1 (a chunk's padding lanes land on live page 1 and
# must leave it as it was); row 1: dead (all sentinel); row 2: length at
# the table's end (every write past the table); row 3: one page, the rest
# sentinel (a chunk runs into the sentinel).
TABLE = np.array([[2, 5, 1], [SENT, SENT, SENT], [0, 3, SENT],
                  [4, SENT, SENT]], np.int32)
LENGTHS = np.array([5, 3, 12, 3], np.int32)


def _pools(rng, quantized: bool, dtype):
    """Equal pools for both packages: numpy (NP, PS, ...) arrays; the port
    appends the scratch page."""
    if quantized:
        return {"k_pages": rng.integers(-127, 128, (NP_, PS, KH, D)).astype(
                    np.int8),
                "v_pages": rng.integers(-127, 128, (NP_, PS, KH, D)).astype(
                    np.int8),
                "k_scale_pages": (rng.random((NP_, PS, KH)) * 4).astype(
                    np.float32),
                "v_scale_pages": (rng.random((NP_, PS, KH)) * 4).astype(
                    np.float32)}
    return {n: rng.standard_normal((NP_, PS, KH, D)).astype(np.float32)
            for n in ("k_pages", "v_pages")}


def _jax_cache(pools, dtype):
    c = {n: (jnp.asarray(a) if a.dtype == np.int8
             else jnp.asarray(a, jnp.bfloat16 if "scale" in n else dtype))
         for n, a in pools.items()}
    c["length"] = jnp.asarray(LENGTHS)
    return c


def _torch_cache(jcache):
    c = {}
    for n, a in jcache.items():
        t = to_tensor(np.asarray(a), "cpu")
        if n.endswith("_pages"):
            t = torch.cat([t, torch.zeros((1,) + tuple(t.shape[1:]),
                                          dtype=t.dtype)])
        c[n] = t
    return c


def _same_bits(got: torch.Tensor, want) -> bool:
    want = to_tensor(np.asarray(want), "cpu")
    if got.dtype in (torch.bfloat16, torch.float32):
        w = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
        return torch.equal(got.view(w), want.view(w))
    return torch.equal(got, want)


@pytest.mark.parametrize("quantized,dtype", [
    (False, jnp.float32), (False, jnp.bfloat16), (True, jnp.bfloat16)],
    ids=["f32", "bf16", "int8"])
@pytest.mark.parametrize("s,n_tokens", [
    (1, None), (5, [3, 0, 2, 5]), (4, [4, 1, 4, 0])],
    ids=["decode", "chunk5", "chunk4"])
def test_paged_append_attend_matches_jax(quantized, dtype, s, n_tokens):
    rng = np.random.default_rng(7 + s)
    pools = _pools(rng, quantized, dtype)
    b = TABLE.shape[0]
    q, k, v = (rng.standard_normal((b, s, nh, D)).astype(np.float32)
               for nh in (H, KH, KH))
    jc = _jax_cache(pools, dtype)
    jn = None if n_tokens is None else jnp.asarray(n_tokens, jnp.int32)
    j_out, j_new = j_paged_append_attend(
        *(jnp.asarray(a, dtype) for a in (q, k, v)), jc,
        jnp.asarray(TABLE), n_tokens=jn)
    tc = _torch_cache(jc)
    tdt = to_tensor(np.zeros(1, np.asarray(jnp.zeros(1, dtype)).dtype),
                    "cpu").dtype
    tn = None if n_tokens is None else torch.tensor(n_tokens,
                                                    dtype=torch.int32)
    t_out, t_new = paged_append_attend(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), tc,
        torch.from_numpy(TABLE), n_tokens=tn)
    assert t_new is tc                      # updated in place
    for n, want in j_new.items():
        got = t_new[n][:NP_] if n.endswith("_pages") else t_new[n]
        assert _same_bits(got, want), f"{n} differs from JAX's"
    before = _torch_cache(jc)               # the pools as they were
    assert any(not torch.equal(t_new[n], before[n]) for n in before
               if n.endswith("_pages")), "nothing was written"
    want = to_tensor(np.asarray(j_out), "cpu").float()
    if dtype == jnp.float32:
        torch.testing.assert_close(t_out.float(), want, rtol=1e-5,
                                   atol=1e-5)
    else:
        torch.testing.assert_close(t_out.float(), want, rtol=2 ** -7,
                                   atol=1e-5)


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_paged_attend_equals_unpaged_on_the_same_cache(quantized):
    """The port's paged path against its own unpaged path: a dense cache
    of MP * PS slots per row laid out into pages through a table gives
    the unpaged decode tick's and chunk's outputs and cache values bit for
    bit (the gather feeds the same attention cores)."""
    gen = torch.Generator().manual_seed(4)
    b = 3
    table = torch.tensor([[4, 1, 7], [0, 6, 2], [8, 3, 5]], dtype=torch.int32)
    shape = (10, PS, KH, D)                 # 9 pages + the scratch page
    if quantized:
        pools = {n: torch.randint(-127, 128, shape, generator=gen,
                                  dtype=torch.int8)
                 for n in ("k_pages", "v_pages")}
        pools.update({n: (torch.rand(shape[:3], generator=gen) * 4).to(
            torch.bfloat16) for n in ("k_scale_pages", "v_scale_pages")})
    else:
        pools = {n: torch.randn(shape, generator=gen).to(torch.bfloat16)
                 for n in ("k_pages", "v_pages")}
    lengths = torch.tensor([2, 7, 9], dtype=torch.int32)
    chunk = torch.tensor([3, 1, 2], dtype=torch.int32)
    for s, n_tok in ((1, None), (3, chunk)):
        pc = {n: t.clone() for n, t in pools.items()}
        pc["length"] = lengths.clone()
        dense = {n.replace("_pages", ""): v.clone() for n, v in zip(
            pools, _paged_view(list(pools.values()), table))}
        dense["length"] = lengths.clone()
        q = torch.randn((b, s, H, D), generator=gen).to(torch.bfloat16)
        k, v = (torch.randn((b, s, KH, D), generator=gen).to(torch.bfloat16)
                for _ in "kv")
        p_out, _ = paged_append_attend(q, k, v, pc, table, n_tokens=n_tok)
        if n_tok is None:
            u_out, _ = _append_attend_one(q, k, v, dense)
        else:
            u_out, _ = chunk_append_attend(q, k, v, dense, n_tokens=n_tok)
        assert torch.equal(p_out.view(torch.int16), u_out.view(torch.int16))
        names = [n for n in pc if n.endswith("_pages")]
        for n, view in zip(names, _paged_view([pc[n] for n in names],
                                              table)):
            assert torch.equal(view, dense[n.replace("_pages", "")])
        assert torch.equal(pc["length"], dense["length"])


def test_paged_decode_state_shapes():
    mcfg = dataclasses.replace(smoke_config(ARCH), kv_quant=True)
    st = init_decode_state(mcfg, 3, 40, "cpu", page_size=16, pool_pages=5)
    kv = st["layers"][0]["kv"]
    kh, hd = mcfg.num_kv_heads, mcfg.resolved_head_dim
    assert kv["k_pages"].shape == (6, 16, kh, hd)
    assert kv["k_pages"].dtype == torch.int8
    assert kv["v_scale_pages"].shape == (6, 16, kh)
    assert kv["v_scale_pages"].dtype == torch.bfloat16
    assert st["page_table"].shape == (3, 3)
    assert (st["page_table"] == 5).all()
    assert all((t == 0).all() for t in kv.values())


# ---------------------------------------------------------------------------
# The paged engine against the JAX paged engine
# ---------------------------------------------------------------------------


def _models(**over):
    jm = dataclasses.replace(j_smoke_config(ARCH), **over)
    tm = dataclasses.replace(smoke_config(ARCH), **over)
    jp = j_init_params(jax.random.PRNGKey(0), jm)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tm, device="cpu")
    return (jp, jm), (tp, tm)


@pytest.fixture(scope="module")
def pair():
    return _models()


def _reqs(cls, n=5, plen=20, max_new=6, seed=0, **kw):
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=[int(t) for t in rng.integers(2, 400, plen)],
                max_new_tokens=max_new, **kw) for i in range(n)]


def _outs(done):
    return {r.uid: list(r.generated) for r in done}


def _serve_both(pair, make_reqs, quant=None, tquant=None, **kw):
    """The same workload through the JAX engine and the port's engine;
    returns (jax engine, its finished list, port engine, its list)."""
    (jp, jm), (tp, tm) = pair
    jeng = JServingEngine(jp, jm, quant=quant or JQuantConfig(mode="float"),
                          **kw)
    jdone = jeng.run(make_reqs(JRequest))
    teng = ServingEngine(tp, tm, quant=tquant or QuantConfig(mode="float"),
                         device="cpu", **kw)
    tdone = teng.run(make_reqs(Request))
    assert [r.uid for r in tdone] == [r.uid for r in jdone]
    assert _outs(tdone) == _outs(jdone)
    assert teng.ticks == jeng.ticks
    assert teng.metrics.conservation() == jeng.metrics.conservation()
    return jeng, jdone, teng, tdone


def test_paged_engine_matches_jax_float(pair):
    _, _, teng, _ = _serve_both(
        pair, lambda c: _reqs(c), capacity=3, max_len=48,
        prefill_chunks=(8,), paged=True, page_size=16)
    assert teng.pool.stats().held == 0      # everything released


def test_paged_engine_matches_jax_kv_quant():
    _serve_both(_models(kv_quant=True), lambda c: _reqs(c, 6),
                capacity=3, max_len=64, prefill_chunks=(8,), paged=True,
                page_size=16)


# Engine seeds on which every stream of the JAX and port paged engines
# agree (tile 16 = the default page size, gain 8, noise 0.5).  Over seeds
# 0..7, abfp_packed kept all 5 streams equal on seven (not 2: 29 of 30
# tokens) and abfp_fused on five (2-6; 26, 26 and 28 of 30 on 0, 1, 7).
PACKED_SEED = 0
FUSED_SEED = 2


@pytest.mark.parametrize("mode,seed", [("abfp_packed", PACKED_SEED),
                                       ("abfp_fused", FUSED_SEED)])
def test_paged_engine_matches_jax_abfp(mode, seed):
    kw = dict(tile_width=16, gain=8.0, noise_lsb=0.5)
    fused = mode == "abfp_fused"
    _, _, teng, tdone = _serve_both(
        _models(kv_quant=fused), lambda c: _reqs(c), capacity=3,
        max_len=64, prefill_chunks=(8,), paged=True, seed=seed,
        quant=JQuantConfig(mode=mode, **kw), tquant=QuantConfig(mode=mode,
                                                                **kw))
    assert teng.page_size == 16             # the tile is the page quantum
    assert all(len(r.generated) == 6 for r in tdone)


def test_paged_bit_identical_to_unpaged_float(pair):
    """The port's paged engine equals its unpaged engine (chunked)."""
    _, (tp, tm) = pair
    common = dict(capacity=3, max_len=48, prefill_chunks=(8,), device="cpu")
    ref = _outs(ServingEngine(tp, tm, **common).run(_reqs(Request)))
    e1 = ServingEngine(tp, tm, paged=True, page_size=16, **common)
    assert _outs(e1.run(_reqs(Request))) == ref
    assert e1.metrics.conservation()["ok"]
    assert e1.pool.stats().held == 0


def test_paged_unchunked_equals_unpaged(pair):
    """Prefill-in-decode on a paged cache gives the unpaged engine's
    streams.  (The JAX paged engine's unchunked streams are not the same
    in every process, ROADMAP queue 3, so the port's decode tick is held
    to JAX's on equal tokens in ``test_paged_decode_ticks_match_jax``.)"""
    _, (tp, tm) = pair
    kw = dict(capacity=2, max_len=32, chunked=False, device="cpu")
    want = _outs(ServingEngine(tp, tm, **kw).run(
        _reqs(Request, 4, plen=6, max_new=4)))
    eng = ServingEngine(tp, tm, paged=True, page_size=16, **kw)
    assert _outs(eng.run(_reqs(Request, 4, plen=6, max_new=4))) == want
    assert eng.metrics.conservation()["ok"]


@pytest.mark.parametrize("kv_quant", [False, True], ids=["float", "int8"])
def test_paged_decode_ticks_match_jax(kv_quant):
    """Ten decode ticks of both packages from paged states on equal pages
    and tables (two live rows, one dead, pages crossing a boundary),
    teacher-forced with the same tokens: the f32 logits within 1e-4 and
    the pools equal (int8 codes and scales up to a code moved by the f32
    rounding of a projection)."""
    from repro.models import decode_step as j_decode_step
    from repro.models import init_decode_state as j_init_decode_state
    from repro_torch.models import decode_step

    (jp, jm), (tp, tm) = _models(kv_quant=kv_quant)
    b, max_len, ps, npages = 3, 32, 4, 10
    table = np.array([[7, 2, 9, 10, 10, 10, 10, 10],
                      [10, 10, 10, 10, 10, 10, 10, 10],
                      [0, 5, 3, 10, 10, 10, 10, 10]], np.int32)
    jst = j_init_decode_state(jm, b, max_len, page_size=ps,
                              pool_pages=npages)
    jst["page_table"] = jnp.asarray(table)
    tst = init_decode_state(tm, b, max_len, "cpu", page_size=ps,
                            pool_pages=npages)
    tst["page_table"].copy_(torch.from_numpy(table))
    toks = np.random.default_rng(1).integers(2, 400, (10, b)).astype(
        np.int32)
    for t in range(len(toks)):
        jl, jst = j_decode_step(jp, jst, jnp.asarray(toks[t]), jm)
        tl, tst = decode_step(tp, tst, torch.from_numpy(toks[t]), tm)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
    for li, layer in enumerate(tst["layers"]):
        for n, t in layer["kv"].items():
            want = np.asarray(jst["groups"][0]["kv"][n][li]).astype(
                np.float32)
            got = (t[:npages] if n.endswith("_pages") else t).float().numpy()
            if n.endswith("_pages") and not kv_quant:
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
            elif n in ("k_pages", "v_pages"):
                assert np.abs(got - want).max() <= 1   # an int8 code
            else:
                np.testing.assert_allclose(got, want, rtol=2 ** -7)


def test_long_request_admits_under_paging(pair):
    """prompt + max_new above max_len serves when the page table addresses
    it (max_len 40, PS 16: 3 pages = 48 tokens); unpaged it is rejected."""
    _, (tp, tm) = pair
    e0 = ServingEngine(tp, tm, capacity=1, max_len=40, prefill_chunks=(8,),
                       device="cpu")
    assert not e0.submit(_reqs(Request, 1, plen=30, max_new=14)[0])
    assert e0.metrics.requests[0].rejected
    _, _, teng, tdone = _serve_both(
        pair, lambda c: _reqs(c, 1, plen=30, max_new=14), capacity=1,
        max_len=40, prefill_chunks=(8,), paged=True, page_size=16)
    assert len(tdone) == 1 and len(tdone[0].generated) == 14


# ---------------------------------------------------------------------------
# Prefix sharing (the JAX suite's cases, on both engines)
# ---------------------------------------------------------------------------

PREFIX_KW = dict(capacity=1, max_len=64, prefill_chunks=(8,), paged=True,
                 page_size=16)


def _pool_counts(eng):
    s = eng.pool.stats()
    return s.prefix_hits, s.cow_copies, s.prefix_evictions


def test_prefix_sharing_saves_ticks_bit_identically(pair):
    sysp = [int(t) for t in np.random.default_rng(7).integers(2, 400, 40)]

    def batch(cls):
        return [cls(uid=i, prompt=sysp + [i + 2], max_new_tokens=4)
                for i in range(3)]

    jeng, _, on, got = _serve_both(pair, batch, **PREFIX_KW)
    assert _pool_counts(on) == _pool_counts(jeng)
    _, (tp, tm) = pair
    off = ServingEngine(tp, tm, prefix_cache=False, device="cpu",
                        **PREFIX_KW)
    assert _outs(got) == _outs(off.run(batch(Request)))
    assert on.pool.stats().prefix_hits > 0
    assert on.ticks < off.ticks             # repeated prefixes prefill once


def test_full_prompt_hit_triggers_cow_not_corruption(pair):
    sysp = [int(t) for t in np.random.default_rng(8).integers(2, 400, 32)]

    def batch(cls):
        return [cls(uid=i, prompt=list(sysp), max_new_tokens=4)
                for i in range(2)]

    jeng, _, on, got = _serve_both(pair, batch, **PREFIX_KW)
    assert _pool_counts(on) == _pool_counts(jeng)
    _, (tp, tm) = pair
    off = ServingEngine(tp, tm, prefix_cache=False, device="cpu",
                        **PREFIX_KW)
    assert _outs(got) == _outs(off.run(batch(Request)))
    assert on.pool.stats().cow_copies >= 1


def test_prefix_cache_never_serves_across_different_prefixes(pair):
    rng = np.random.default_rng(9)
    a = [int(t) for t in rng.integers(2, 400, 20)]
    b = list(a)
    b[0] = (b[0] + 1) % 400 + 2             # same length, different 1st token

    def batch(cls):
        return [cls(uid=0, prompt=list(a), max_new_tokens=4),
                cls(uid=1, prompt=list(b), max_new_tokens=4)]

    jeng, _, on, got = _serve_both(pair, batch, **PREFIX_KW)
    assert _pool_counts(on) == _pool_counts(jeng) and on.pool.stats(
    ).prefix_hits == 0
    _, (tp, tm) = pair
    off = ServingEngine(tp, tm, prefix_cache=False, device="cpu",
                        **PREFIX_KW)
    assert _outs(got) == _outs(off.run(batch(Request)))
