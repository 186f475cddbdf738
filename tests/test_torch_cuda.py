"""The CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so every test here carries the ``cuda``
marker and skips where ``torch.cuda.is_available()`` is false.  This file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Bars: kernels 1 and 2 equal their plain versions bit for bit in bf16,
except at most one element in each started 1,000 that is one bf16 ULP off
(f32 sum order), where a test says so; kernel 3 within one bf16 ULP (rtol
2**-7).  The ABFP core's three routes (the decode launch at M <= 8, the
fused launch above it at every row block, the two-launch route) equal the
plain version bit for bit (0 flips).  Kernel 4 equals its plain version
and kernel 1 on ``pack_abfp_weight(w)`` bit for bit (it runs kernel 1's
launches on codes it quantized itself, and its codes and scales are
byte-equal to the pack's).  Kernel 5 (flash attention) within rtol 1e-5 /
atol 2e-5 in f32 (another sum order, f32 FMAs) and within one bf16 ULP
(rtol 2**-7, atol 1e-5) in bf16, on the tensor-core route and on the FMA
route alike, query rows that see no key included.  Under autograd
(QAT), the straight-through Functions over kernels 1 and 4 keep those
forward bars and give the plain versions' gradients bit for bit.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.abfp import QuantConfig, pack_abfp_weight
from repro_torch.kernels import ops
from repro_torch.kernels.abfp_decode_fused import (
    fused_qkv_packed,
    fused_qkv_packed_ref,
    fused_quantized_decode_attention,
    quantized_decode_attention,
)
from repro_torch.kernels.abfp_decode_fused import (
    _fused_qkv_packed,
    concat_qkv,
    decode_attention_split,
)
from repro_torch.kernels.abfp_matmul import (
    DECODE_ROWS,
    _abfp_matmul,
    _abfp_matmul_packed,
    abfp_matmul,
    abfp_matmul_packed,
    abfp_matmul_packed_ref,
    abfp_matmul_ref,
    fused_rows,
    quantize_weight,
)
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_ref,
)

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker

CFG = QuantConfig(mode="abfp_fused", tile_width=128, gain=8.0, noise_lsb=0.5)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _bf16_match(got, want):
    g = got.cpu().view(torch.int16).numpy().view(np.uint16).astype(np.int32)
    w = want.cpu().view(torch.int16).numpy().view(np.uint16).astype(np.int32)
    diff = g != w
    assert np.all(np.abs(g[diff] - w[diff]) == 1)
    assert int(diff.sum()) <= -(-g.size // 1000)


def _bits(t):
    return t.cpu().view(torch.int16)


def _assert_bits_equal(got, want):
    n = int((_bits(got) != _bits(want)).sum())
    assert n == 0, f"{n}/{got.numel()} bf16 elements differ"


def _weight(rng, k, n):
    return torch.from_numpy((rng.laplace(size=(k, n)) * 0.08)
                            .astype(np.float32)).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 960, 320), (4, 960, 2560),
                                   (40, 2560, 960), (512, 960, 960)])
def test_cuda_packed_matmul_matches_plain(m, k, n):
    _need_cuda()
    rng = np.random.default_rng(m)
    pw = pack_abfp_weight(_weight(rng, k, n), CFG, adaptive_gain=True)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).cuda()
    ops.reset_launch_counts()
    got = abfp_matmul_packed(x.to(torch.bfloat16), pw, CFG, 99)
    want = abfp_matmul_packed_ref(x.to(torch.bfloat16), pw, CFG, 99)
    torch.cuda.synchronize()
    assert ops.launch_counts()["abfp_matmul_packed"] == 1
    _bf16_match(got, want)


@pytest.mark.cuda
def test_cuda_fused_qkv_matches_plain():
    _need_cuda()
    rng = np.random.default_rng(1)
    pws = [pack_abfp_weight(_weight(rng, 960, c), CFG, adaptive_gain=True)
           for c in (960, 320, 320)]
    x = torch.from_numpy(rng.normal(size=(4, 960)).astype(np.float32)).cuda()
    got = fused_qkv_packed(x, pws, CFG, (1, -2, 3))
    for g, w in zip(got, fused_qkv_packed_ref(x, pws, CFG, (1, -2, 3))):
        _bf16_match(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_attention_matches_plain(dtype):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(4, 1, 15, 64, device="cuda", generator=g).to(dtype)
    kc = torch.randint(-127, 128, (4, 512, 5, 64), dtype=torch.int8,
                       device="cuda", generator=g)
    vc = torch.randint(-127, 128, (4, 512, 5, 64), dtype=torch.int8,
                       device="cuda", generator=g)
    ks = torch.rand(4, 512, 5, device="cuda", generator=g).to(torch.bfloat16)
    vs = torch.rand(4, 512, 5, device="cuda", generator=g).to(torch.bfloat16)
    lengths = torch.tensor([1, 512, 9, 333], dtype=torch.int32, device="cuda")
    got = fused_quantized_decode_attention(q, kc, ks, vc, vs, lengths=lengths)
    want = quantized_decode_attention(q, kc, ks, vc, vs, lengths=lengths)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               rtol=2 ** -7, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("noise", [0.0, 0.5])
@pytest.mark.parametrize("m,k,n,tile", [(40, 200, 136, 32), (3, 300, 256, 128)])
def test_cuda_packed_matmul_without_gains_matches_plain(m, k, n, tile, noise):
    """The abfp_packed path: scalar gain, ragged K and N, M across
    auto_bm's 8-row steps, noise on and off."""
    _need_cuda()
    cfg = QuantConfig(mode="abfp_packed", tile_width=tile, gain=4.0,
                      noise_lsb=noise)
    rng = np.random.default_rng(k + m)
    pw = pack_abfp_weight(_weight(rng, k, n), cfg)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).cuda()
    seed = 5 if noise else None
    _bf16_match(abfp_matmul_packed(x, pw, cfg, seed),
                abfp_matmul_packed_ref(x, pw, cfg, seed))


@pytest.mark.cuda
def test_cuda_decode_attention_without_gqa_matches_plain():
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn(2, 1, 4, 32, device="cuda", generator=g)
    kc = torch.randint(-127, 128, (2, 40, 4, 32), dtype=torch.int8,
                       device="cuda", generator=g)
    ks = torch.rand(2, 40, 4, device="cuda", generator=g).to(torch.bfloat16)
    lengths = torch.tensor([40, 3], dtype=torch.int32, device="cuda")
    got = fused_quantized_decode_attention(q, kc, ks, kc, ks, lengths=lengths)
    want = quantized_decode_attention(q, kc, ks, kc, ks, lengths=lengths)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["float", "abfp_packed", "abfp_fused"])
def test_cuda_engine_serves_the_smoke_config(mode):
    """Every mode serves on the card; the ABFP modes launch their kernels."""
    _need_cuda()
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.models import init_params
    from repro_torch.serving import Request, ServingEngine

    mcfg = dataclasses.replace(smoke_config("smollm-360m"),
                               kv_quant=mode == "abfp_fused")
    quant = (QuantConfig(mode="float") if mode == "float" else
             QuantConfig(mode=mode, tile_width=32, gain=8.0, noise_lsb=0.5))
    eng = ServingEngine(init_params(0, mcfg, device="cuda"), mcfg,
                        capacity=2, max_len=64, quant=quant, device="cuda")
    ops.reset_launch_counts()
    done = eng.run([Request(uid=i, prompt=list(range(1, 3 + 7 * i)),
                            max_new_tokens=4) for i in range(3)])
    assert sorted(r.uid for r in done) == [0, 1, 2]
    assert all(len(r.generated) == 4 for r in done)
    counts = ops.launch_counts()
    if mode == "float":
        assert sum(counts.values()) == 0
    else:
        assert counts["abfp_matmul_packed"] > 0
        fused = mode == "abfp_fused"
        assert (counts["fused_qkv_packed"] > 0) == fused
        assert (counts["fused_quantized_decode_attention"] > 0) == fused


@pytest.mark.cuda
@pytest.mark.parametrize("noise", [0.0, 0.5])
@pytest.mark.parametrize("m,k,n,tile", [(1, 72, 40, 8), (40, 200, 136, 32),
                                        (130, 300, 260, 128),
                                        (9, 960, 1600, 128)])
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
def test_cuda_unpacked_matmul_matches_plain_and_packed(m, k, n, tile, noise,
                                                       wdtype):
    """Kernel 4 against its plain version and against kernel 1 on the
    packed weight, ragged M/K/N, f32 and bf16 weights: equal bits."""
    _need_cuda()
    cfg = QuantConfig(mode="abfp_kernel", tile_width=tile, gain=8.0,
                      noise_lsb=noise)
    rng = np.random.default_rng(m + k + tile)
    w = _weight(rng, k, n).to(wdtype)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).cuda()
    seed = 17 if noise else None
    ops.reset_launch_counts()
    got = abfp_matmul(x, w, cfg, seed)
    torch.cuda.synchronize()
    assert ops.launch_counts()["abfp_matmul"] == 1
    assert ops.launch_counts()["abfp_matmul_packed"] == 0
    assert torch.equal(got, abfp_matmul_ref(x, w, cfg, seed))
    assert torch.equal(got, abfp_matmul_packed(x, pack_abfp_weight(w, cfg),
                                               cfg, seed))


def _flash_inputs(b, sq, skv, h, kh, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(shape, device="cuda", generator=g).to(dtype)
                 for shape in ((b, sq, h, d), (b, skv, kh, d),
                               (b, skv, kh, d)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 100), (False, 130)])
@pytest.mark.parametrize("shape", [(2, 256, 256, 4, 4, 64),
                                   (2, 300, 300, 8, 2, 32),
                                   (1, 384, 640, 5, 1, 128),
                                   (4, 512, 512, 15, 5, 64),
                                   (2, 100, 100, 4, 4, 128),
                                   (1, 77, 200, 6, 3, 32),
                                   (1, 200, 77, 6, 3, 32),
                                   (2, 128, 1500, 8, 8, 64),
                                   (1, 300, 300, 4, 4, 96),
                                   (2, 300, 300, 10, 1, 256),
                                   (1, 200, 77, 4, 2, 256)])
def test_cuda_flash_attention_matches_plain(shape, causal, window, dtype):
    """MHA, GQA, MQA with Sq != Skv, the evaluation shape; D 32/64/96/128
    and 256 (recurrentgemma-2b's 10 / 1 heads: the query in shared memory,
    32-key tiles);
    whisper's cross-attention (128 decoder queries over 1,500 frames);
    query lengths that are not whole 64-row blocks; Sq > Skv + window,
    where rows from Skv + window - 1 on see no key and take the plain
    version's mean of v over its live blocks.  bf16 runs on the tensor
    cores, f32 on the FMA kernel."""
    _need_cuda()
    q, k, v = _flash_inputs(*shape, dtype=dtype, seed=sum(shape))
    ops.reset_launch_counts()
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    assert got.dtype == dtype and got.shape == q.shape
    tol = (dict(rtol=1e-5, atol=2e-5) if dtype == torch.float32
           else dict(rtol=2 ** -7, atol=1e-5))
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 100)])
@pytest.mark.parametrize("shape", [(2, 300, 300, 8, 2, 32),
                                   (4, 512, 512, 15, 5, 64),
                                   (1, 384, 640, 5, 1, 128),
                                   (1, 300, 300, 10, 1, 256)])
def test_cuda_flash_fma_route_on_bf16_matches_plain(shape, causal, window):
    """The FMA kernel (the f32 route) on bf16 inputs cast to f32, the A/B
    timing route against the tensor cores: within one bf16 ULP of the
    plain version on the bf16 inputs, like the default."""
    _need_cuda()
    q, k, v = _flash_inputs(*shape, dtype=torch.bfloat16, seed=sum(shape))
    got = flash_attention(q.float(), k.float(), v.float(), causal=causal,
                          window=window)
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=1e-5)


@pytest.mark.cuda
def test_cuda_flash_attention_refuses_other_head_dims():
    """Head dims outside ``HEAD_DIMS`` raise on the card (no fallback)."""
    _need_cuda()
    for d in (48, 160, 512):
        q, k, v = _flash_inputs(1, 64, 64, 2, 2, d, torch.bfloat16, d)
        with pytest.raises(ValueError, match="head dims"):
            flash_attention(q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("gains,noise", [(False, 0.0), (False, 0.5),
                                         (True, 0.0), (True, 0.5)])
@pytest.mark.parametrize("tile", [32, 128])
@pytest.mark.parametrize("m", [9, 40, 130, 512, 2048])
def test_cuda_fused_core_bit_equal_to_plain(m, tile, gains, noise):
    """Kernel 1 above decode size: the route the rule picks, the fused
    route at every row block and the two-launch route all equal the plain
    version bit for bit; ragged K (900) and N (1000)."""
    _need_cuda()
    cfg = QuantConfig(mode="abfp_fused" if gains else "abfp_packed",
                      tile_width=tile, gain=8.0, noise_lsb=noise)
    rng = np.random.default_rng(m + tile)
    pw = pack_abfp_weight(_weight(rng, 900, 1000), cfg, adaptive_gain=gains)
    x = torch.from_numpy(rng.normal(size=(m, 900)).astype(np.float32)).cuda()
    x = x.to(torch.bfloat16)
    seed = -7 if noise else None
    assert fused_rows(m, tile, pw.n_padded // 128, cfg, pw.num_tiles) == 16
    want = abfp_matmul_packed_ref(x, pw, cfg, seed)
    _assert_bits_equal(abfp_matmul_packed(x, pw, cfg, seed), want)
    for rows in (0, 16, 32, 64):
        _assert_bits_equal(_abfp_matmul_packed(x, pw, cfg, seed, rows), want)


@pytest.mark.cuda
@pytest.mark.parametrize("unpacked", [False, True])
@pytest.mark.parametrize("tile", [32, 128])
@pytest.mark.parametrize("m", [17, 40])
def test_cuda_lm_head_size_route_bit_equal_to_plain(m, tile, unpacked):
    """A weight of LM-head size (960 x 49152) does not stay in L2: the rule
    picks 32-row blocks, and the public wrappers (kernel 1 with gains,
    kernel 4) and the 64-row block equal the plain versions bit for
    bit."""
    _need_cuda()
    cfg = QuantConfig(mode="abfp_kernel" if unpacked else "abfp_fused",
                      tile_width=tile, gain=8.0, noise_lsb=0.5)
    rng = np.random.default_rng(m + tile)
    w = _weight(rng, 960, 49152).to(torch.bfloat16)
    x = torch.from_numpy(rng.normal(size=(m, 960)).astype(np.float32))
    x = x.cuda().to(torch.bfloat16)
    pw = pack_abfp_weight(w, cfg, adaptive_gain=not unpacked)
    rows = fused_rows(m, tile, pw.n_padded // 128, cfg, pw.num_tiles)
    assert rows == 32
    if unpacked:
        want = abfp_matmul_ref(x, w, cfg, 9)
        _assert_bits_equal(abfp_matmul(x, w, cfg, 9), want)
        _assert_bits_equal(_abfp_matmul(x, w, cfg, 9, 64), want)
    else:
        want = abfp_matmul_packed_ref(x, pw, cfg, 9)
        _assert_bits_equal(abfp_matmul_packed(x, pw, cfg, 9), want)
        _assert_bits_equal(_abfp_matmul_packed(x, pw, cfg, 9, 64), want)


@pytest.mark.cuda
@pytest.mark.parametrize("noise", [0.0, 0.5])
@pytest.mark.parametrize("m", [9, 40, 130])
def test_cuda_tile8_two_launch_route_bit_equal_to_plain(m, noise):
    """n = 8 (not a whole m16n8k32 step) takes the two-launch route at
    every M."""
    _need_cuda()
    cfg = QuantConfig(mode="abfp_fused", tile_width=8, gain=8.0,
                      noise_lsb=noise)
    rng = np.random.default_rng(m)
    pw = pack_abfp_weight(_weight(rng, 72, 200), cfg, adaptive_gain=True)
    x = torch.from_numpy(rng.normal(size=(m, 72)).astype(np.float32)).cuda()
    seed = 3 if noise else None
    assert fused_rows(m, 8, pw.n_padded // 128, cfg, pw.num_tiles) == 0
    _assert_bits_equal(abfp_matmul_packed(x, pw, cfg, seed),
                       abfp_matmul_packed_ref(x, pw, cfg, seed))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4, 8])
def test_cuda_decode_route_unchanged(m):
    """M <= 8 takes the one-launch decode route; its output is unchanged
    from the two-launch route's and equal to the plain version."""
    _need_cuda()
    rng = np.random.default_rng(m)
    pw = pack_abfp_weight(_weight(rng, 960, 2560), CFG, adaptive_gain=True)
    x = torch.from_numpy(rng.normal(size=(m, 960)).astype(np.float32)).cuda()
    assert fused_rows(m, 128, pw.n_padded // 128, CFG, pw.num_tiles) \
        == DECODE_ROWS
    got = abfp_matmul_packed(x, pw, CFG, 5)
    _assert_bits_equal(got, _abfp_matmul_packed(x, pw, CFG, 5, 0))
    _assert_bits_equal(got, abfp_matmul_packed_ref(x, pw, CFG, 5))


@pytest.mark.cuda
@pytest.mark.parametrize("gains,noise", [(False, 0.0), (False, 0.5),
                                         (True, 0.0), (True, 0.5)])
@pytest.mark.parametrize("k,n", [(1000, 1000), (2560, 960)])
@pytest.mark.parametrize("tile", [8, 16, 32, 128])
@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 8])
def test_cuda_decode_route_bit_equal_to_plain(m, tile, k, n, gains, noise):
    """Kernel 1 at decode size: the decode launch (one launch) equals the
    plain version and the two-launch route bit for bit, at every tile
    width, ragged K and N, per-tile gains (gain 8) or a scalar gain that is
    not a power of two (3.0), noise on and off; f32 and bf16 x."""
    _need_cuda()
    cfg = QuantConfig(mode="abfp_fused" if gains else "abfp_packed",
                      tile_width=tile, gain=8.0 if gains else 3.0,
                      noise_lsb=noise)
    rng = np.random.default_rng(m + tile + k)
    pw = pack_abfp_weight(_weight(rng, k, n), cfg, adaptive_gain=gains)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).cuda()
    seed = -11 if noise else None
    assert fused_rows(m, tile, pw.n_padded // 128, cfg, pw.num_tiles) \
        == DECODE_ROWS
    for xx in (x, x.to(torch.bfloat16)):
        want = abfp_matmul_packed_ref(xx, pw, cfg, seed)
        ops.reset_launch_counts()
        got = abfp_matmul_packed(xx, pw, cfg, seed)
        torch.cuda.synchronize()
        assert ops.launch_counts()["abfp_matmul_packed"] == 1
        _assert_bits_equal(got, want)
        _assert_bits_equal(_abfp_matmul_packed(xx, pw, cfg, seed, 0), want)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [32, 128])
@pytest.mark.parametrize("m", [1, 4, 8])
def test_cuda_fused_qkv_decode_route_bit_equal(m, tile):
    """Kernel 2 at decode size, three segments on the decode launch: each
    output equals the plain version, a stand-alone kernel-1 call with its
    seed and the two-launch route."""
    _need_cuda()
    cfg = QuantConfig(mode="abfp_fused", tile_width=tile, gain=8.0,
                      noise_lsb=0.5)
    rng = np.random.default_rng(m + tile)
    pws = [pack_abfp_weight(_weight(rng, 960, c), cfg, adaptive_gain=True)
           for c in (960, 320, 320)]
    x = torch.from_numpy(rng.normal(size=(m, 960)).astype(np.float32)).cuda()
    x = x.to(torch.bfloat16)
    seeds = (1, -2, 3)
    qkv = concat_qkv(pws, cfg)
    assert fused_rows(m, tile, sum(p.n_padded for p in pws) // 128, cfg,
                      pws[0].num_tiles) == DECODE_ROWS
    ops.reset_launch_counts()
    got = fused_qkv_packed(x, pws, cfg, seeds, qkv=qkv)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_qkv_packed"] == 1
    two = _fused_qkv_packed(x, pws, cfg, seeds, qkv, 0)
    for g, w, t, pw, sd in zip(got, fused_qkv_packed_ref(x, pws, cfg, seeds),
                               two, pws, seeds):
        _assert_bits_equal(g, w)
        _assert_bits_equal(g, t)
        _assert_bits_equal(g, abfp_matmul_packed(x, pw, cfg, sd))


@pytest.mark.cuda
@pytest.mark.parametrize("unpacked", [False, True])
@pytest.mark.parametrize("m", [1, 4, 8])
def test_cuda_decode_route_lm_head_bit_equal(m, unpacked):
    """The LM head's shape (960 x 49152, 1,536 blocks of 32 columns) on the
    decode route, through kernel 1 (gains) and kernel 4 (quantizer, then
    the decode launch): equal to the plain versions."""
    _need_cuda()
    cfg = QuantConfig(mode="abfp_kernel" if unpacked else "abfp_fused",
                      tile_width=128, gain=8.0, noise_lsb=0.5)
    rng = np.random.default_rng(m)
    w = _weight(rng, 960, 49152).to(torch.bfloat16)
    x = torch.from_numpy(rng.normal(size=(m, 960)).astype(np.float32))
    x = x.cuda().to(torch.bfloat16)
    if unpacked:
        _assert_bits_equal(abfp_matmul(x, w, cfg, 9),
                           abfp_matmul_ref(x, w, cfg, 9))
    else:
        pw = pack_abfp_weight(w, cfg, adaptive_gain=True)
        _assert_bits_equal(abfp_matmul_packed(x, pw, cfg, 9),
                           abfp_matmul_packed_ref(x, pw, cfg, 9))


@pytest.mark.cuda
@pytest.mark.parametrize("noise", [0.0, 0.5])
def test_cuda_unpacked_matmul_decode_route_bit_equal(noise):
    """Kernel 4 at M = 4: its weight quantizer, then the decode launch;
    equal to its plain version, to kernel 1 on the pack and to its
    two-launch route."""
    _need_cuda()
    cfg = QuantConfig(mode="abfp_kernel", tile_width=128, gain=8.0,
                      noise_lsb=noise)
    rng = np.random.default_rng(4)
    w = _weight(rng, 960, 2560).to(torch.bfloat16)
    x = torch.from_numpy(rng.normal(size=(4, 960)).astype(np.float32))
    x = x.cuda().to(torch.bfloat16)
    seed = 13 if noise else None
    ops.reset_launch_counts()
    got = abfp_matmul(x, w, cfg, seed)
    torch.cuda.synchronize()
    assert ops.launch_counts()["abfp_matmul"] == 1
    _assert_bits_equal(got, abfp_matmul_ref(x, w, cfg, seed))
    _assert_bits_equal(got, abfp_matmul_packed(x, pack_abfp_weight(w, cfg),
                                               cfg, seed))
    _assert_bits_equal(got, _abfp_matmul(x, w, cfg, seed, 0))


def _kv_cache(b, s_max, kh, d, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    codes = [torch.randint(-127, 128, (b, s_max, kh, d), dtype=torch.int8,
                           device="cuda", generator=g) for _ in "kv"]
    scales = [(torch.rand(b, s_max, kh, device="cuda", generator=g) * 4)
              .to(torch.bfloat16) for _ in "kv"]
    return codes[0], scales[0], codes[1], scales[1]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 96, 128])
@pytest.mark.parametrize("rep", [1, 3, 4])
@pytest.mark.parametrize("b", [1, 2, 4])
def test_cuda_decode_attention_split_kernel_matches_plain(b, rep, d, dtype):
    """Kernel 3 at lengths 0 (the uniform softmax over all S), 1, S and
    between, one launch per call (S = 512): within one bf16 ULP (rtol
    2**-7, atol 1e-5) of its plain version.  D = 96 (phi-3-vision) leaves
    two lanes of each warp idle."""
    _need_cuda()
    kh, s_max = 2, 512
    kc, ks, vc, vs = _kv_cache(b, s_max, kh, d, seed=b * rep + d)
    g = torch.Generator(device="cuda").manual_seed(rep)
    q = torch.randn(b, 1, kh * rep, d, device="cuda", generator=g).to(dtype)
    lengths = torch.tensor([0, 1, s_max, 173][:b] if b > 1 else [77],
                           dtype=torch.int32, device="cuda")
    assert decode_attention_split(b, s_max, kh * rep, kh)[2] == 1
    ops.reset_launch_counts()
    got = fused_quantized_decode_attention(q, kc, ks, vc, vs, lengths=lengths)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_quantized_decode_attention"] == 1
    want = quantized_decode_attention(q, kc, ks, vc, vs, lengths=lengths)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 96])
@pytest.mark.parametrize("lengths", [(32768, 0), (1, 20000), (4097, 32768)])
def test_cuda_decode_attention_long_cache_matches_plain(lengths, d, dtype):
    """S = 32,768 at rep 3 (past what an S-sized shared-memory design takes):
    split positions and the combine launch, within one bf16 ULP of the
    plain version."""
    _need_cuda()
    b, kh, rep, s_max = 2, 2, 3, 32768
    kc, ks, vc, vs = _kv_cache(b, s_max, kh, d, seed=sum(lengths))
    g = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn(b, 1, kh * rep, d, device="cuda", generator=g).to(dtype)
    assert decode_attention_split(b, s_max, kh * rep, kh)[2] > 1
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    got = fused_quantized_decode_attention(q, kc, ks, vc, vs, lengths=lens)
    want = quantized_decode_attention(q, kc, ks, vc, vs, lengths=lens)
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [40, 130])
def test_cuda_fused_qkv_above_decode_size_bit_equal(m):
    """Kernel 2's three segments on the fused route: each output equals
    the plain version and a stand-alone kernel-1 call with its seed."""
    _need_cuda()
    rng = np.random.default_rng(m)
    pws = [pack_abfp_weight(_weight(rng, 960, c), CFG, adaptive_gain=True)
           for c in (960, 320, 320)]
    x = torch.from_numpy(rng.normal(size=(m, 960)).astype(np.float32)).cuda()
    seeds = (1, -2, 3)
    assert fused_rows(m, 128, sum(p.n_padded for p in pws) // 128, CFG,
                      pws[0].num_tiles)
    got = fused_qkv_packed(x, pws, CFG, seeds, qkv=concat_qkv(pws, CFG))
    for g, w, pw, sd in zip(got, fused_qkv_packed_ref(x, pws, CFG, seeds),
                            pws, seeds):
        _assert_bits_equal(g, w)
        _assert_bits_equal(g, abfp_matmul_packed(x, pw, CFG, sd))


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,tile", [(960, 960, 128), (200, 136, 32),
                                      (2560, 960, 128), (72, 40, 8)])
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
def test_cuda_weight_quantizer_byte_equal_to_pack(k, n, tile, wdtype):
    _need_cuda()
    cfg = QuantConfig(mode="abfp_kernel", tile_width=tile, gain=8.0)
    w = _weight(np.random.default_rng(k + n), k, n).to(wdtype)
    w[:, 3] = 0.0                      # an all-zero column: scale 0
    geo, kcodes, scales = quantize_weight(w, cfg)
    pw = pack_abfp_weight(w, cfg)
    assert (geo.k, geo.kp, geo.num_tiles) == (pw.k, pw.kp, pw.num_tiles)
    assert torch.equal(kcodes, pw.kcodes)
    assert torch.equal(_bits(scales), _bits(pw.scales))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [16, 2048])
def test_cuda_unpacked_matmul_routes_bit_equal(m):
    """Kernel 4 at the evaluation shapes on every route equals kernel 1 on
    the packed weight."""
    _need_cuda()
    cfg = QuantConfig(mode="abfp_kernel", tile_width=128, gain=8.0,
                      noise_lsb=0.5)
    rng = np.random.default_rng(m)
    w = _weight(rng, 960, 2560).to(torch.bfloat16)
    x = torch.from_numpy(rng.normal(size=(m, 960)).astype(np.float32))
    x = x.cuda().to(torch.bfloat16)
    want = abfp_matmul_packed(x, pack_abfp_weight(w, cfg), cfg, 11)
    _assert_bits_equal(abfp_matmul(x, w, cfg, 11), want)
    for rows in (0, 16, 32, 64):
        _assert_bits_equal(_abfp_matmul(x, w, cfg, 11, rows), want)


@pytest.mark.cuda
def test_cuda_flash_attention_refuses_other_head_dims():
    _need_cuda()
    q, k, v = _flash_inputs(1, 16, 16, 2, 2, 48, torch.float32, 0)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["float", "abfp_kernel"])
def test_cuda_forward_through_the_kernels(mode):
    """The smoke config's teacher-forced forward with flash attention,
    through the kernels and through their plain versions: 2 x 7 + 1
    kernel-4 launches and 2 kernel-5 launches in ABFP; logits within
    1e-4 in float and 0.5 in ABFP (kernel 5's f32 sum order can move an
    activation code, as between the port and JAX)."""
    _need_cuda()
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.core import prng
    from repro_torch.models import Numerics, forward, init_params

    mcfg = dataclasses.replace(smoke_config("smollm-360m"),
                               use_flash_attention=True)
    params = init_params(0, mcfg, device="cuda")
    quant = (QuantConfig(mode="float") if mode == "float" else
             QuantConfig(mode=mode, tile_width=32, gain=8.0, noise_lsb=0.5))
    toks = torch.randint(1, mcfg.vocab_size, (2, 64), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(0))
    key = prng.PRNGKey(3)
    ops.reset_launch_counts()
    got, _ = forward(params, toks, mcfg, Numerics(quant, key))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    want, _ = forward(params, toks, mcfg, Numerics(quant, key, plain=True))
    assert counts["flash_attention"] == mcfg.num_layers
    assert counts["abfp_matmul"] == (0 if mode == "float"
                                     else 7 * mcfg.num_layers + 1)
    assert torch.isfinite(got).all()
    err = float((got - want).abs().max())
    assert err < (1e-4 if mode == "float" else 0.5), err


# ---------------------------------------------------------------------------
# Seeds in device memory; warmed passes (CUDA graphs) and the overlapped
# engine
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4, 8, 512])
def test_cuda_device_seeds_equal_int_seeds_and_plain(m):
    """Kernels 1 and 2 read their seeds from device memory: a seed-table
    slice (at an offset) gives the output of the same seeds passed as ints
    and of the plain version, bit for bit, at phase 3's weight shapes
    (tile 128, gains, noise 0.5)."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(7)
    table = torch.tensor([5, 11, -22, 33, 1234567, -7], dtype=torch.int32,
                         device="cuda")
    for k, n in ((960, 960), (960, 320), (960, 2560), (2560, 960)):
        w = torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5
        pw = pack_abfp_weight(w.to(torch.bfloat16), CFG, adaptive_gain=True)
        x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        got = abfp_matmul_packed(x, pw, CFG, table[4:5])
        _assert_bits_equal(got, abfp_matmul_packed(x, pw, CFG, 1234567))
        _assert_bits_equal(got, abfp_matmul_packed_ref(x, pw, CFG, 1234567))
    ws = [torch.randn(960, n, generator=gen, device="cuda") * 960 ** -0.5
          for n in (960, 320, 320)]
    pws = [pack_abfp_weight(w.to(torch.bfloat16), CFG, adaptive_gain=True)
           for w in ws]
    x = torch.randn(m, 960, generator=gen, device="cuda").to(torch.bfloat16)
    got = fused_qkv_packed(x, pws, CFG, table[1:4], qkv=concat_qkv(pws, CFG))
    for g, by_int, want in zip(got, fused_qkv_packed(x, pws, CFG,
                                                     (11, -22, 33)),
                               fused_qkv_packed_ref(x, pws, CFG,
                                                    (11, -22, 33))):
        _assert_bits_equal(g, by_int)
        _assert_bits_equal(g, want)


def _smoke_engines(**kw):
    """A graph engine and an eager twin (``_graphs=False``) on the same
    weights, both with ``kw``."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.models import init_params
    from repro_torch.serving import ServingEngine

    mcfg = dataclasses.replace(smoke_config("smollm-360m"), kv_quant=True)
    quant = QuantConfig(mode="abfp_fused", tile_width=32, gain=8.0,
                        noise_lsb=0.5)
    params = init_params(0, mcfg, device="cuda")
    common = dict(capacity=4, max_len=64, quant=quant, seed=0,
                  prefill_chunks=(4, 8), device="cuda", **kw)
    graph = ServingEngine(params, mcfg, **common)
    eager = ServingEngine(params, mcfg, _graphs=False, **common)
    return graph, eager, mcfg


@pytest.mark.cuda
@pytest.mark.parametrize("shape_key", [("decode", "draw"),
                                       ("prefill", 4, "draw"),
                                       ("prefill", 8, "draw"),
                                       ("decode",)],
                         ids=["decode", "prefill4", "prefill8",
                              "decode-greedy"])
def test_cuda_graph_replay_equals_eager_over_two_keys(shape_key):
    """Two consecutive passes of one shape with two keys, by replay and
    eagerly through the kernels, from the same state: logits and sampled
    tokens (the device draw at temperatures 0 / 0.7 / 1.3, or the greedy
    variant's argmax) equal bit for bit, and the two keys' logits differ
    (a graph that froze its first seeds would repeat them)."""
    _need_cuda()
    import time

    from repro_torch.core import prng

    # Overlapped engines: their passes sample on the device.
    graph, eager, mcfg = _smoke_engines(clock=time.perf_counter,
                                        overlap=True)
    b = graph.capacity
    width = 1 if shape_key[0] == "decode" else shape_key[1]
    rng = np.random.default_rng(1)
    fields = dict(tokens=rng.integers(1, mcfg.vocab_size, (b, width)),
                  n_tokens=np.array([width, 1, 0, 2][:b]),
                  prev_mask=np.zeros(b, bool),
                  temps=np.array([0.0, 0.7, 1.3, 0.0], np.float32),
                  uids=np.arange(b), idxs=np.arange(b))
    outs = []
    for t, key in enumerate((prng.PRNGKey(1), prng.PRNGKey(2))):
        got = []
        for eng in (graph, eager):
            io, _ = eng._call(shape_key, key, **fields)
            got.append((io.logits.clone(), io.sampled.clone()))
        torch.cuda.synchronize()
        assert graph._passes[shape_key].graph is not None
        assert eager._passes[shape_key].graph is None
        (lg, sg), (le, se) = got
        assert torch.equal(lg, le), f"pass {t}: logits differ"
        assert torch.equal(sg, se), f"pass {t}: sampled tokens differ"
        assert torch.isfinite(lg).all()
        outs.append(lg)
    assert not torch.equal(outs[0], outs[1])
    graph.close()
    eager.close()


@pytest.mark.cuda
def test_cuda_overlapped_graph_engine_equals_blocking_eager():
    """The overlapped engine on CUDA graphs serves the greedy streams of
    the blocking eager engine, and counts its replays' launches."""
    _need_cuda()
    import time

    from repro_torch.serving import Request

    graph, _, mcfg = _smoke_engines(clock=time.perf_counter, overlap=True)
    _, eager, _ = _smoke_engines()

    def reqs():
        return [Request(uid=i, prompt=list(range(1, 3 + 5 * i)),
                        max_new_tokens=6) for i in range(6)]

    ops.reset_launch_counts()
    want = {r.uid: r.generated for r in eager.run(reqs())}
    eager_counts = ops.launch_counts()
    graph.warmup()
    ops.reset_launch_counts()
    done = graph.run(reqs())
    graph.close()
    assert {r.uid: r.generated for r in done} == want
    counts = ops.launch_counts()
    for name in ("abfp_matmul_packed", "fused_qkv_packed",
                 "fused_quantized_decode_attention"):
        assert counts[name] > 0, counts
    # The same passes: each replay counts the launches its capture held.
    assert counts == eager_counts
    u = graph.metrics.tick_utilization()["value"]
    assert u is not None and 0.0 < u <= 1.0 + 1e-9


@pytest.mark.cuda
def test_cuda_capture_leaves_the_state_untouched():
    """Capturing every pass shape (``warmup``) runs each pass once, on a
    scratch copy of the state, and records it: the served state keeps its
    values and its storage."""
    _need_cuda()
    from repro_torch.serving.runners import state_tensors

    graph, _, _ = _smoke_engines()
    gen = torch.Generator(device="cuda").manual_seed(3)
    for t in state_tensors(graph.state):
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen,
                                  device="cuda", dtype=torch.int8))
        elif t.dtype == torch.int32:
            t.copy_(torch.randint(0, 20, t.shape, generator=gen,
                                  device="cuda", dtype=torch.int32))
        else:
            t.copy_(torch.rand(t.shape, generator=gen, device="cuda"))
    before = [t.clone() for t in state_tensors(graph.state)]
    ptrs = [t.data_ptr() for t in state_tensors(graph.state)]
    graph.warmup()
    torch.cuda.synchronize()
    assert all(wp.graph is not None for wp in graph._passes.values())
    assert [t.data_ptr() for t in state_tensors(graph.state)] == ptrs
    for t, b in zip(state_tensors(graph.state), before):
        assert torch.equal(t, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape_key", [("decode",), ("prefill", 8)],
                         ids=["decode", "prefill8"])
def test_cuda_paged_replay_equals_eager_under_two_tables(shape_key):
    """A paged pass reads its page table from device memory: two passes
    with two keys AND two different page tables, by replay and eagerly
    through the kernels, from the same state, give bit-equal logits,
    sampled tokens and page pools; the keys' logits differ (neither the
    seeds nor the first capture's pages are frozen)."""
    _need_cuda()
    import time

    from repro_torch.core import prng

    graph, eager, mcfg = _smoke_engines(clock=time.perf_counter,
                                        overlap=True, paged=True,
                                        page_size=16, pool_pages=12)
    b, mp = graph.capacity, graph.max_pages
    assert mp == 4 and graph.pool.num_pages == 12
    width = 1 if shape_key[0] == "decode" else shape_key[1]
    rng = np.random.default_rng(2)
    fields = dict(tokens=rng.integers(1, mcfg.vocab_size, (b, width)),
                  n_tokens=np.array([width, 1, 0, 2][:b]),
                  prev_mask=np.zeros(b, bool), temps=np.zeros(b, np.float32),
                  uids=np.arange(b), idxs=np.arange(b))
    # Two layouts of the 12 pages over the 4 rows (sentinel 12 elsewhere);
    # row 2 is dead in the first and live in the second.
    tables = (np.array([[3, 7, 12, 12], [0, 12, 12, 12],
                        [12, 12, 12, 12], [5, 9, 1, 12]], np.int32),
              np.array([[11, 2, 12, 12], [4, 6, 12, 12],
                        [8, 12, 12, 12], [10, 12, 12, 12]], np.int32))
    outs = []
    for t, (key, table) in enumerate(zip((prng.PRNGKey(1), prng.PRNGKey(2)),
                                         tables)):
        got = []
        for eng in (graph, eager):
            eng._table[:] = table
            io, _ = eng._call(shape_key, key, **fields)
            got.append((io.logits.clone(), io.sampled.clone()))
        torch.cuda.synchronize()
        assert graph._passes[shape_key].graph is not None
        (lg, sg), (le, se) = got
        assert torch.equal(lg, le), f"pass {t}: logits differ"
        assert torch.equal(sg, se), f"pass {t}: sampled tokens differ"
        assert torch.isfinite(lg).all()
        for la, le_ in zip(graph.state["layers"], eager.state["layers"]):
            for n, a in la["kv"].items():
                # The scratch page takes the dropped writes in no order.
                e = le_["kv"][n]
                if n.endswith("_pages"):
                    a, e = a[:-1], e[:-1]
                assert torch.equal(a, e), f"pass {t}: {n} differs"
        assert torch.equal(graph.state["page_table"].cpu(),
                           torch.from_numpy(table))
        outs.append(lg)
    assert not torch.equal(outs[0], outs[1])
    graph.close()
    eager.close()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_cuda_paged_scatter_drops_without_a_device_assert(dtype):
    """Sentinel entries, positions past the table and padding lanes go to
    the scratch page: on the card the scatter raises no device assert and
    writes what the plain CPU run writes."""
    _need_cuda()
    from repro_torch.models.layers import _paged_scatter

    np_, ps, kh, d = 6, 4, 2, 8
    table = torch.tensor([[2, 5, np_], [np_, np_, np_], [0, 1, 3]],
                         dtype=torch.int32)
    pos = torch.tensor([[5, 6, 7, 8, 9], [0, 1, 2, 3, 4],
                        [11, 12, 13, 40, 1000]], dtype=torch.int32)
    valid = torch.tensor([[True, True, False, True, False]] * 3)
    gen = torch.Generator().manual_seed(0)
    if dtype == torch.int8:
        vals = torch.randint(-127, 128, (3, 5, kh, d), generator=gen,
                             dtype=torch.int8)
    else:
        vals = torch.randn((3, 5, kh, d), generator=gen).to(dtype)
    outs = []
    for dev in ("cpu", "cuda"):
        pool = torch.zeros((np_ + 1, ps, kh, d), dtype=dtype, device=dev)
        _paged_scatter([pool], table.to(dev), pos.to(dev), [vals.to(dev)],
                       valid.to(dev))
        outs.append(pool[:np_].cpu())
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    assert outs[0].abs().sum() > 0          # the live lanes wrote


# ---------------------------------------------------------------------------
# The straight-through Functions over kernels 1 and 4 (QAT on the card)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(512, 960, 2560), (512, 2560, 960),
                                   (40, 960, 320)])
def test_cuda_dense_ste_over_kernel4(m, k, n):
    """``ops.dense`` in abfp_kernel mode under autograd: the forward is
    kernel 4 (one launch), bit-equal to its plain version; the backward
    is the straight-through f32 matmuls (no launch), equal to the plain
    run's gradients bit for bit and to ``x^T g`` / ``g w^T``."""
    _need_cuda()
    from repro_torch.core.abfp import ste_grads

    gen = torch.Generator(device="cuda").manual_seed(m + k + n)
    cfg = QuantConfig(mode="abfp_kernel", tile_width=128, gain=8.0,
                      noise_lsb=0.5)
    x0 = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    w0 = (torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5
          ).to(torch.bfloat16)
    g = torch.randn(m, n, generator=gen, device="cuda").to(torch.bfloat16)
    outs = []
    for plain in (False, True):
        x = x0.clone().requires_grad_(True)
        w = w0.clone().requires_grad_(True)
        ops.reset_launch_counts()
        y = ops.dense(x, w, cfg, 1234, plain=plain)
        fwd = ops.launch_counts()["abfp_matmul"]
        y.backward(g)
        torch.cuda.synchronize()
        assert ops.launch_counts()["abfp_matmul"] == fwd == (0 if plain
                                                              else 1)
        outs.append((y.detach(), x.grad, w.grad))
    (yk, dxk, dwk), (yp, dxp, dwp) = outs
    _assert_bits_equal(yk, yp)
    assert torch.equal(dxk, dxp) and torch.equal(dwk, dwp)
    assert dxk.dtype == dwk.dtype == torch.bfloat16
    dx, dw = ste_grads(g, x0, w0)
    assert torch.equal(dxk, dx) and torch.equal(dwk, dw)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 512])
def test_cuda_dense_packed_ste_over_kernel1(m):
    """``ops.dense_packed`` under autograd: kernel 1's output and ``dx``
    (against the dequantized lattice) equal the plain version's bit for
    bit; the packed weight takes no gradient and the backward launches
    nothing."""
    _need_cuda()
    from repro_torch.core.abfp import dequantize_packed

    rng = np.random.default_rng(m)
    w = _weight(rng, 960, 2560)
    pw = pack_abfp_weight(w, CFG, adaptive_gain=True)
    gen = torch.Generator(device="cuda").manual_seed(m)
    x0 = torch.randn(m, 960, generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.randn(m, 2560, generator=gen, device="cuda").to(torch.bfloat16)
    outs = []
    for plain in (False, True):
        x = x0.clone().requires_grad_(True)
        ops.reset_launch_counts()
        y = ops.dense_packed(x, pw, CFG, 99, plain=plain)
        y.backward(g)
        torch.cuda.synchronize()
        assert ops.launch_counts()["abfp_matmul_packed"] == (0 if plain
                                                             else 1)
        outs.append((y.detach(), x.grad))
    _assert_bits_equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    want = (g.float() @ dequantize_packed(pw).t()).to(torch.bfloat16)
    assert torch.equal(outs[0][1], want)


def _fault_model():
    """The smoke model packed as the fused engine serves it, on the card."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.models import init_params
    from repro_torch.models.packing import pack_model_params

    mcfg = dataclasses.replace(smoke_config("smollm-360m"), kv_quant=True)
    quant = QuantConfig(mode="abfp_fused", tile_width=32, gain=8.0,
                        noise_lsb=0.5)
    return pack_model_params(init_params(0, mcfg, device="cuda"), quant,
                             mcfg), quant


@pytest.mark.cuda
def test_cuda_faults_reach_all_three_copies_in_place():
    """Every inject and repair on the card writes the codes, the kernel
    layout and the fused QKV concatenation in place: ``kcodes ==
    kernel_layout(codes)``, each ``PackedQKV`` equal to a fresh
    ``concat_qkv``, no tensor moved; kernels 1 and 2 on the faulted
    operands equal their plain versions (which read ``codes``) bit for
    bit, stuck columns read exactly 0.0, and after repair the outputs
    equal the pre-fault ones."""
    _need_cuda()
    from repro_torch.core.abfp import kernel_layout
    from repro_torch.serving import faults as faultlib
    from repro_torch.serving.faults import FaultEvent

    params, quant = _fault_model()
    spare = faultlib.clone_sites(params)
    sites = faultlib.fault_sites(params)
    lp0 = params["layers"][0]

    def ptrs():
        out = []
        for site in sites:
            for leaf in faultlib.site_leaves(params, site.path):
                out += [leaf.codes.data_ptr(), leaf.scales.data_ptr(),
                        leaf.kcodes.data_ptr()]
        for lp in params["layers"]:
            out += [lp["attn"]["qkv"].kcodes.data_ptr(),
                    lp["attn"]["qkv"].scales.data_ptr()]
        return out

    want_ptrs = ptrs()

    def check_copies():
        for site in sites:
            for leaf in faultlib.site_leaves(params, site.path):
                assert torch.equal(leaf.kcodes, kernel_layout(leaf.codes))
        for lp in params["layers"]:
            a = lp["attn"]
            fresh = concat_qkv((a["wq"], a["wk"], a["wv"]), quant)
            assert torch.equal(a["qkv"].kcodes, fresh.kcodes)
            assert torch.equal(_bits(a["qkv"].scales), _bits(fresh.scales))
        assert ptrs() == want_ptrs

    gen = torch.Generator(device="cuda").manual_seed(5)
    x4 = torch.randn(4, lp0["attn"]["wq"].k, generator=gen,
                     device="cuda").to(torch.bfloat16)
    x512 = torch.randn(512, lp0["mlp"]["wi"].k, generator=gen,
                       device="cuda").to(torch.bfloat16)
    pws = (lp0["attn"]["wq"], lp0["attn"]["wk"], lp0["attn"]["wv"])

    def outputs():
        got = fused_qkv_packed(x4, pws, quant, (3, 4, 5),
                               qkv=lp0["attn"]["qkv"])
        for g, w in zip(got, fused_qkv_packed_ref(x4, pws, quant,
                                                  (3, 4, 5))):
            _assert_bits_equal(g, w)
        k1 = {}
        for name, pw, x in (("wi", lp0["mlp"]["wi"], x512),
                            ("lm_head", params["lm_head"], x4)):
            k1[name] = abfp_matmul_packed(x, pw, quant, 9)
            _assert_bits_equal(k1[name],
                               abfp_matmul_packed_ref(x, pw, quant, 9))
        return got, k1

    clean_qkv, clean_k1 = outputs()
    base = faultlib.fingerprint_round(params, sites)
    events = [FaultEvent(0, "stuck_col", "groups/0/attn/wq", cols=(3, 100)),
              FaultEvent(0, "scale_drift", "groups/0/attn/wv",
                         tiles=((0, 5), (3, 60)), factors=(1.2, 0.8)),
              FaultEvent(0, "scale_drift", "groups/0/mlp/wi",
                         tiles=((1, 7),), factors=(0.9,)),
              FaultEvent(0, "stuck_col", "lm_head", cols=(11, 200))]
    for ev in events:
        faultlib.apply_event(params, ev)
        check_copies()
        qkv_out, k1 = outputs()
        if ev.path == "groups/0/attn/wq":
            assert not qkv_out[0][:, [3, 100]].float().any()
        if ev.path == "lm_head":
            assert not k1["lm_head"][:, [11, 200]].float().any()
        site = next(s_ for s_ in sites if s_.path == ev.path)
        det = faultlib.detect_site(base[ev.path],
                                   faultlib.site_fingerprint(params, site))
        assert not det.clean
        if det.stuck_cols:
            faultlib.repair_stuck(params, spare, ev.path, det.stuck_cols)
        if det.drifted:
            faultlib.repair_drift(params, spare, ev.path, det.drifted)
        check_copies()
        qkv_out, k1 = outputs()
        for g, w in zip(qkv_out, clean_qkv):
            _assert_bits_equal(g, w)
        for name in k1:
            _assert_bits_equal(k1[name], clean_k1[name])
    faultlib.apply_event(params, FaultEvent(0, "shard_drop", "", shard=0))
    check_copies()
    faultlib.restore_sites(params, spare)
    check_copies()
    qkv_out, k1 = outputs()
    for g, w in zip(qkv_out, clean_qkv):
        _assert_bits_equal(g, w)


@pytest.mark.cuda
def test_cuda_graph_replay_after_reshard_equals_eager():
    """A graph engine and its eager twin serve one fault plan (a stuck
    LM-head column, a drifted MLP tile, a shard drop): equal streams and
    counters, the graphs captured before the reshard are the ones that
    replay after it (nothing captured again), and a replay after the
    reshard equals the eager pass bit for bit."""
    _need_cuda()
    from repro_torch.core import prng
    from repro_torch.serving import FaultConfig, FaultPlan, Request
    from repro_torch.serving.faults import FaultEvent

    plan = FaultPlan([FaultEvent(3, "stuck_col", "lm_head", cols=(5, 30)),
                      FaultEvent(5, "scale_drift", "groups/0/mlp/wi",
                                 tiles=((0, 3),), factors=(1.2,)),
                      FaultEvent(9, "shard_drop", "", shard=0)],
                     FaultConfig(rate=0.01))
    graph, eager, mcfg = _smoke_engines(faults=plan, detect_every=2)
    graph.warmup()
    captured = {k: wp.graph for k, wp in graph._passes.items()}

    def reqs():
        return [Request(uid=i, prompt=list(range(1, 3 + 5 * i)),
                        max_new_tokens=6) for i in range(6)]

    done = {}
    for eng in (graph, eager):
        done[eng is graph] = {r.uid: r.generated for r in eng.run(reqs())}
    assert done[True] == done[False]
    assert graph.metrics.faults == eager.metrics.faults
    assert graph.metrics.faults["reshards"] == 1
    assert graph.metrics.conservation()["ok"]
    for k, g in captured.items():
        assert graph._passes[k].graph is g
    b, rng = graph.capacity, np.random.default_rng(2)
    for shape_key in (("decode",), ("prefill", 8)):
        width = 1 if shape_key[0] == "decode" else 8
        fields = dict(tokens=rng.integers(1, mcfg.vocab_size, (b, width)),
                      n_tokens=np.array([width, 1, 0, 2][:b]),
                      prev_mask=np.zeros(b, bool),
                      temps=np.zeros(b, np.float32), uids=np.arange(b),
                      idxs=np.arange(b))
        got = []
        for eng in (graph, eager):
            io, _ = eng._call(shape_key, prng.PRNGKey(4), **fields)
            got.append(io.logits.clone())
        torch.cuda.synchronize()
        assert torch.equal(got[0], got[1]), shape_key
        assert torch.isfinite(got[0]).all()


_REFUSED_CAPTURE_SCRIPT = r"""
import sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from test_torch_cuda import _smoke_engines
from repro_torch.core import prng
from repro_torch.serving import runners

graph, eager, mcfg = _smoke_engines()
real = runners.decode_step

def syncing(*a, **kw):
    logits, state = real(*a, **kw)
    float(logits.sum())                 # a host sync: not capturable
    return logits, state

runners.decode_step = syncing
try:
    graph.warmup()
except Exception as e:
    print("REFUSED", type(e).__name__)
else:
    raise SystemExit("the capture of a syncing pass did not raise")
assert ("decode",) not in graph._passes
runners.decode_step = real
# The process stays usable: the default generator draws, and a fresh
# engine captures and replays its passes equal to the eager ones.
torch.randn(8, device="cuda").sum().item()
g2, x2, _ = _smoke_engines()
g2.warmup()
fields = dict(tokens=np.ones((g2.capacity, 1)),
              prev_mask=np.zeros(g2.capacity, bool),
              temps=np.zeros(g2.capacity, np.float32),
              uids=np.arange(g2.capacity), idxs=np.arange(g2.capacity))
got = [e._call(("decode",), prng.PRNGKey(4), **fields)[0].logits.clone()
       for e in (g2, x2)]
torch.cuda.synchronize()
assert torch.equal(got[0], got[1])
print("CAPTURE_AFTER_REFUSAL_OK")
"""


@pytest.mark.cuda
def test_cuda_failing_capture_raises():
    """A pass that cannot be captured (a host sync inside it) raises at
    capture; the engine does not fall back to eager launches.  After the
    refusal the process's CUDA state stays usable (the engine puts back
    the default generator and the current stream): a random draw works
    and a fresh engine's captured decode tick replays equal to its eager
    twin.  The refused capture runs in a process of its own, so a
    regression cannot reach the tests after this one."""
    _need_cuda()
    import os
    import subprocess
    import sys
    from pathlib import Path

    here = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(here.parent / "src"), os.environ.get("PYTHONPATH", "")]))
    r = subprocess.run([sys.executable, "-c", _REFUSED_CAPTURE_SCRIPT,
                        str(here)], capture_output=True, text=True,
                       timeout=600, env=env)
    assert "REFUSED" in r.stdout, r.stdout + r.stderr
    assert "CAPTURE_AFTER_REFUSAL_OK" in r.stdout, r.stdout + r.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(4, 2560, 256_000), (512, 2560, 256_000),
                                   (4, 2048, 8), (512, 2048, 8),
                                   (4, 7680, 2560), (512, 7680, 2560)],
                         ids=["head-m4", "head-m512", "w_if-m4",
                              "w_if-m512", "geglu-wo-m4", "geglu-wo-m512"])
def test_cuda_packed_matmul_at_recurrent_shapes(m, k, n):
    """Kernel 1 at the shapes the recurrent families bring: recurrentgemma-
    2b's tied head (N = 256,000), xLSTM's gate projection (N = 8, padded
    to 128 columns) and the GeGLU output (K = 7,680, inside the decode
    route's shared memory at M <= 8), at decode and prefill sizes: bit for
    bit its plain version, one launch."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(k + n)
    w = torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5
    pw = pack_abfp_weight(w.to(torch.bfloat16), CFG, adaptive_gain=True)
    del w
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    ops.reset_launch_counts()
    got = abfp_matmul_packed(x, pw, CFG, 77)
    want = abfp_matmul_packed_ref(x, pw, CFG, 77)
    torch.cuda.synchronize()
    assert ops.launch_counts()["abfp_matmul_packed"] == 1
    assert got.shape == (m, n)
    _assert_bits_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape_key", [("decode",), ("prefill", 16)],
                         ids=["decode", "prefill16"])
def test_cuda_recurrent_replay_equals_eager_over_two_keys(shape_key):
    """A three-layer recurrentgemma-2b at full width (RG-LRU, RG-LRU,
    windowed attention over an int8 ring of 2,048 slots), abfp_fused: two
    passes with two keys by replay and eagerly from the same state give
    bit-equal logits, sampled tokens and state, the keys' logits differ,
    and a decode replay launches kernel 1 only (2 x 8 + 7 + the head)."""
    _need_cuda()
    import dataclasses
    import time

    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.models import init_params
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.runners import state_tensors

    mcfg = dataclasses.replace(get_config("recurrentgemma-2b"), num_layers=3,
                               kv_quant=True)
    quant = QuantConfig(mode="abfp_fused", tile_width=128, gain=8.0,
                        noise_lsb=0.5)
    params = init_params(0, mcfg, device="cuda")
    kw = dict(capacity=4, max_len=64, quant=quant, device="cuda",
              clock=time.perf_counter, overlap=True)
    graph = ServingEngine(params, mcfg, **kw)
    eager = ServingEngine(graph.params, mcfg, _graphs=False, **kw)
    b, width = 4, 1 if shape_key[0] == "decode" else shape_key[1]
    rng = np.random.default_rng(3)
    fields = dict(tokens=rng.integers(1, mcfg.vocab_size, (b, width)),
                  n_tokens=np.array([width, 1, 0, 2]),
                  prev_mask=np.zeros(b, bool),
                  temps=np.zeros(b, np.float32), uids=np.arange(b),
                  idxs=np.arange(b))
    for t in state_tensors(graph.state):
        t.copy_(torch.randn(t.shape, device="cuda").to(t.dtype)
                if t.is_floating_point() else t)
    start = [t.clone() for t in state_tensors(graph.state)]
    outs = []
    for key in (prng.PRNGKey(1), prng.PRNGKey(2)):
        got = []
        for eng in (graph, eager):
            for dst, src in zip(state_tensors(eng.state), start):
                dst.copy_(src)
            io, _ = eng._call(shape_key, key, **fields)
            got.append((io.logits.clone(), io.sampled.clone(),
                        [t.clone() for t in state_tensors(eng.state)]))
        torch.cuda.synchronize()
        (lg, sg, stg), (le, se, ste) = got
        assert torch.equal(lg, le) and torch.equal(sg, se)
        assert all(torch.equal(a, b_) for a, b_ in zip(stg, ste))
        assert torch.isfinite(lg).all()
        outs.append(lg)
    assert not torch.equal(outs[0], outs[1])
    launches = graph._passes[shape_key].launches
    assert {k: v for k, v in launches.items() if v} == {
        "abfp_matmul_packed": 24}
    graph.close()
    eager.close()


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 512])
@pytest.mark.parametrize("k,n", [(1024, 512), (512, 1024)],
                         ids=["wi-wg", "wo"])
def test_cuda_packed_matmul_at_expert_shapes(m, k, n):
    """Kernel 1 on granite-moe-1b-a400m's expert weights (wi and wg 1,024
    x 512, wo 512 x 1,024), each expert packed alone as the MoE packing
    packs it, at a decode tick's M = 4 and a prefill pass's M = 512: bit
    for bit its plain version, one launch."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(k)
    w = torch.randn(4, k, n, generator=gen, device="cuda") * k ** -0.5
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    for ex in range(w.shape[0]):
        pw = pack_abfp_weight(w[ex].to(torch.bfloat16), CFG,
                              adaptive_gain=True)
        ops.reset_launch_counts()
        got = abfp_matmul_packed(x, pw, CFG, 11 + ex)
        want = abfp_matmul_packed_ref(x, pw, CFG, 11 + ex)
        torch.cuda.synchronize()
        assert ops.launch_counts()["abfp_matmul_packed"] == 1
        _assert_bits_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape_key", [("decode",), ("prefill", 16)],
                         ids=["decode", "prefill16"])
def test_cuda_moe_replay_equals_eager_over_two_keys(shape_key):
    """A two-layer granite-moe-1b-a400m at full width (32 experts, top-8),
    abfp_fused: two passes with two keys by replay and eagerly from the
    same state give bit-equal logits, sampled tokens and state, the keys'
    logits differ, and a replay launches kernel 1 2 x (1 + 96) + 1 times
    per decode tick (2 x (4 + 96) + 1 per prefill pass) and kernels 2-3
    twice per tick."""
    _need_cuda()
    import dataclasses
    import time

    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.models import init_params
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.runners import state_tensors

    mcfg = dataclasses.replace(get_config("granite-moe-1b-a400m"),
                               num_layers=2, kv_quant=True)
    params = init_params(0, mcfg, device="cuda")
    kw = dict(capacity=4, max_len=64, quant=CFG, device="cuda",
              clock=time.perf_counter, overlap=True)
    graph = ServingEngine(params, mcfg, **kw)
    eager = ServingEngine(graph.params, mcfg, _graphs=False, **kw)
    b, width = 4, 1 if shape_key[0] == "decode" else shape_key[1]
    rng = np.random.default_rng(3)
    fields = dict(tokens=rng.integers(1, mcfg.vocab_size, (b, width)),
                  n_tokens=np.array([width, 1, 0, 2]),
                  prev_mask=np.zeros(b, bool),
                  temps=np.zeros(b, np.float32), uids=np.arange(b),
                  idxs=np.arange(b))
    # A random int8 cache of 5 tokens per row (positions and lengths 5).
    for t in state_tensors(graph.state):
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, device="cuda"))
        elif t.dtype == torch.int32:
            t.fill_(5)
        else:
            t.copy_(torch.rand(t.shape, device="cuda").to(t.dtype))
    start = [t.clone() for t in state_tensors(graph.state)]
    outs = []
    for key in (prng.PRNGKey(1), prng.PRNGKey(2)):
        got = []
        for eng in (graph, eager):
            for dst, src in zip(state_tensors(eng.state), start):
                dst.copy_(src)
            io, _ = eng._call(shape_key, key, **fields)
            got.append((io.logits.clone(), io.sampled.clone(),
                        [t.clone() for t in state_tensors(eng.state)]))
        torch.cuda.synchronize()
        (lg, sg, stg), (le, se, ste) = got
        assert torch.equal(lg, le) and torch.equal(sg, se)
        assert all(torch.equal(a, b_) for a, b_ in zip(stg, ste))
        assert torch.isfinite(lg).all()
        outs.append(lg)
    assert not torch.equal(outs[0], outs[1])
    launches = {k: v for k, v in graph._passes[shape_key].launches.items()
                if v}
    if shape_key[0] == "decode":
        assert launches == {"abfp_matmul_packed": 2 * 97 + 1,
                            "fused_qkv_packed": 2,
                            "fused_quantized_decode_attention": 2}
    else:
        assert launches == {"abfp_matmul_packed": 2 * 100 + 1}
    graph.close()
    eager.close()


# ---------------------------------------------------------------------------
# abfp_ref served: the key chain and the tile scan's draws on the device
# ---------------------------------------------------------------------------


def _dev_key(key):
    return torch.from_numpy(np.asarray(key, np.uint32).astype(np.int64)
                            ).to("cuda")


@pytest.mark.cuda
def test_cuda_device_key_chain_equals_host_chain():
    """``split``, ``fold_in`` and ``key_bits`` on keys held in device
    memory equal the host chain's words and bits."""
    _need_cuda()
    from repro_torch.core import prng

    key = prng.fold_in(prng.PRNGKey(7), 3)
    dk = _dev_key(key)
    assert prng.split(dk, 9).cpu().numpy().tolist() == \
        prng.split(key, 9).astype(np.int64).tolist()
    for data in (0, 5, 999_983, 2**32 - 1):
        assert prng.fold_in(dk, data).cpu().numpy().tolist() == \
            prng.fold_in(key, data).astype(np.int64).tolist()
    keys = prng.split(key, 4)
    for shape in ((5,), (4, 512), (3, 128, 257)):
        assert torch.equal(prng.key_bits(dk, shape).cpu(),
                           prng.key_bits(key, shape))
        assert torch.equal(prng.key_bits(_dev_key(keys), shape).cpu(),
                           prng.key_bits(keys, shape))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 512])
@pytest.mark.parametrize("k,n", [(960, 2560), (2560, 960)])
def test_cuda_device_keyed_scan_equals_host_keyed_scan(m, k, n):
    """The ``abfp_ref`` scan on a device key-table row gives the host
    key's outputs bit for bit, at a decode tick's and a prefill pass's
    rows (smollm-360m's MLP shapes, tile 128)."""
    _need_cuda()
    from repro_torch.core import abfp as core_abfp
    from repro_torch.core import prng

    cfg = QuantConfig(mode="abfp_ref", tile_width=128, gain=8.0,
                      noise_lsb=0.5)
    g = torch.Generator(device="cuda").manual_seed(m + k)
    x = torch.randn(m, k, device="cuda", generator=g).to(torch.bfloat16)
    w = (torch.randn(k, n, device="cuda", generator=g) * 0.05
         ).to(torch.bfloat16)
    key = prng.fold_in(prng.PRNGKey(11), m)
    want = core_abfp.abfp_matmul(x, w, cfg, key)
    got = core_abfp.abfp_matmul(x, w, cfg, _dev_key(key))
    assert torch.equal(got, want)
    assert torch.isfinite(got.float()).all()


@pytest.mark.cuda
def test_cuda_captured_scan_draws_new_noise_per_staged_key():
    """A CUDA graph of the scan that reads its key from device memory:
    each replay after a new key is staged equals the eager scan under
    that key, and two keys' outputs differ (a key copied inside the
    capture would replay the capture's noise)."""
    _need_cuda()
    from repro_torch.core import abfp as core_abfp
    from repro_torch.core import prng

    cfg = QuantConfig(mode="abfp_ref", tile_width=128, gain=8.0,
                      noise_lsb=0.5)
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(4, 960, device="cuda", generator=g).to(torch.bfloat16)
    w = (torch.randn(960, 320, device="cuda", generator=g) * 0.05
         ).to(torch.bfloat16)
    slot = torch.zeros(2, dtype=torch.int64, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        core_abfp.abfp_matmul(x, w, cfg, slot)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = core_abfp.abfp_matmul(x, w, cfg, slot)
    outs = []
    for seed in (1, 2):
        key = prng.fold_in(prng.PRNGKey(seed), 9)
        slot.copy_(_dev_key(key))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, core_abfp.abfp_matmul(x, w, cfg, key))
        outs.append(out.clone())
    assert not torch.equal(outs[0], outs[1])
