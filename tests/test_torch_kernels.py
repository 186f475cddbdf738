"""The port's kernel plain versions against the JAX Pallas kernels.

Each plain PyTorch version (``repro_torch.kernels``) runs on the CPU
beside the JAX kernel it stands for, which runs in Pallas interpret mode
as the JAX package's own tests run it.  Inputs are made with numpy from a
seed and handed to both.

Bars (stated per test):
  * kernels 1, 2 and 4 (packed ABFP matmul, fused QKV, unpacked ABFP
    matmul): bf16 outputs equal bit for bit, except at most one element in
    1,000 that differs by exactly one bf16 ULP (f32 sum order; the count
    is printed);
  * kernel 3 (int8-KV decode attention): rtol 1e-5, atol 1e-6 in f32,
    because the softmax sums run in another order.

The CUDA kernels themselves run only on the card: ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.abfp import QuantConfig as JQuantConfig
from repro.core.abfp import pack_abfp_weight as j_pack
from repro.kernels.abfp_decode_fused import (
    fused_qkv_packed_pallas,
)
from repro.kernels.abfp_decode_fused import (
    fused_quantized_decode_attention as j_attn,
)
from repro.kernels.abfp_matmul import (
    abfp_matmul_packed_pallas,
    abfp_matmul_pallas,
)
from repro_torch.core.abfp import QuantConfig, pack_abfp_weight
from repro_torch.kernels import ops
from repro_torch.kernels.abfp_decode_fused import (
    SPLIT_POSITIONS,
    concat_qkv,
    decode_attention_split,
    fused_qkv_packed,
    fused_qkv_packed_ref,
    fused_quantized_decode_attention,
    quantized_decode_attention,
)
from repro_torch.kernels.abfp_matmul import (
    DECODE_ROWS,
    FUSED_L2_RESIDENT_BYTES,
    FUSED_ROWS,
    FUSED_MAX_TILES,
    abfp_matmul,
    abfp_matmul_packed,
    abfp_matmul_packed_ref,
    abfp_matmul_ref,
    fused_rows,
)
from repro_torch.kernels.flash_attention import flash_attention

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker


def bf16_bits(a) -> np.ndarray:
    """bf16 values (JAX array or torch tensor) as int32 bit patterns."""
    if isinstance(a, torch.Tensor):
        a = a.to(torch.bfloat16).view(torch.int16).numpy()
        return a.view(np.uint16).astype(np.int32)
    return np.asarray(a).view(np.uint16).astype(np.int32)


def assert_bf16_match(got, want, what=""):
    """Equal bits, except <= 1 in each started 1,000 elements one bf16 ULP
    apart."""
    g, w = bf16_bits(got), bf16_bits(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    diff = g != w
    n_diff = int(diff.sum())
    print(f"{what}: {n_diff}/{g.size} one-ULP flips")
    if n_diff:
        assert np.all(np.abs(g[diff] - w[diff]) == 1), \
            f"{what}: a difference larger than one bf16 ULP"
    assert n_diff <= -(-g.size // 1000), f"{what}: {n_diff}/{g.size} flips"


def _cfgs(tile, noise, gain):
    mode = "abfp_fused" if gain > 1 else "abfp_packed"
    return (JQuantConfig(mode=mode, tile_width=tile, gain=gain,
                         noise_lsb=noise),
            QuantConfig(mode=mode, tile_width=tile, gain=gain,
                        noise_lsb=noise))


def _weight(rng, k, n):
    return (rng.laplace(size=(k, n)) * 0.08).astype(np.float32)


# ---------------------------------------------------------------------------
# Kernel 1: packed ABFP matmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gains", [False, True])
@pytest.mark.parametrize("noise", [0.0, 0.5])
@pytest.mark.parametrize("tile,k,n", [(32, 200, 136), (128, 300, 136)])
@pytest.mark.parametrize("m", [1, 4, 8, 40])
def test_packed_matmul_matches_pallas(m, tile, k, n, noise, gains):
    rng = np.random.default_rng(1000 * m + k + tile)
    jcfg, cfg = _cfgs(tile, noise, 8.0 if gains else 1.0)
    x = (rng.normal(size=(m, k)) * 0.7).astype(np.float32)
    w = _weight(rng, k, n)
    seed = 1234567 if noise else None
    want = abfp_matmul_packed_pallas(
        jnp.asarray(x), j_pack(jnp.asarray(w), jcfg, adaptive_gain=gains),
        jcfg, None if seed is None else jnp.int32(seed))
    pw = pack_abfp_weight(torch.from_numpy(w), cfg, adaptive_gain=gains)
    got = abfp_matmul_packed_ref(torch.from_numpy(x), pw, cfg, seed)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    assert_bf16_match(got, want, f"m={m} tile={tile} noise={noise} "
                                 f"gains={gains}")


def test_packed_matmul_batched_input_and_negative_seed():
    """Leading axes flatten into rows; an int32 seed below 0 wraps the
    same way in both hashes."""
    rng = np.random.default_rng(7)
    jcfg, cfg = _cfgs(32, 0.5, 8.0)
    x = rng.normal(size=(2, 3, 96)).astype(np.float32)
    w = _weight(rng, 96, 40)
    want = abfp_matmul_packed_pallas(
        jnp.asarray(x), j_pack(jnp.asarray(w), jcfg, adaptive_gain=True),
        jcfg, jnp.int32(-5))
    pw = pack_abfp_weight(torch.from_numpy(w), cfg, adaptive_gain=True)
    got = abfp_matmul_packed_ref(torch.from_numpy(x), pw, cfg, -5)
    assert got.shape == (2, 3, 40)
    assert_bf16_match(got, want, "batched")


def test_noise_requires_seed():
    _, cfg = _cfgs(32, 0.5, 1.0)
    pw = pack_abfp_weight(torch.ones(32, 8), cfg)
    with pytest.raises(ValueError, match="seed"):
        abfp_matmul_packed_ref(torch.ones(1, 32), pw, cfg, None)


# ---------------------------------------------------------------------------
# Kernel 4: unpacked ABFP matmul (the abfp_kernel mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("noise,gain", [(0.0, 1.0), (0.5, 8.0), (0.5, 1.0)])
@pytest.mark.parametrize("tile,k,n", [(8, 72, 40), (32, 200, 136),
                                      (128, 300, 136)])
@pytest.mark.parametrize("m", [1, 8, 40])
def test_unpacked_matmul_matches_pallas(m, tile, k, n, noise, gain):
    """``abfp_matmul_ref`` against ``abfp_matmul_pallas`` in interpret
    mode, K and N off every block multiple; kernel 1's bf16 bar."""
    rng = np.random.default_rng(10 * m + k + tile)
    jcfg = JQuantConfig(mode="abfp_kernel", tile_width=tile, gain=gain,
                        noise_lsb=noise)
    cfg = QuantConfig(mode="abfp_kernel", tile_width=tile, gain=gain,
                      noise_lsb=noise)
    x = (rng.normal(size=(m, k)) * 0.7).astype(np.float32)
    w = _weight(rng, k, n)
    seed = 7654321 if noise else None
    want = abfp_matmul_pallas(jnp.asarray(x), jnp.asarray(w), jcfg,
                              None if seed is None else jnp.int32(seed))
    got = abfp_matmul_ref(torch.from_numpy(x), torch.from_numpy(w), cfg, seed)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    assert_bf16_match(got, want, f"unpacked m={m} tile={tile} "
                                 f"noise={noise} gain={gain}")


@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile", [8, 32, 128])
def test_unpacked_equals_packed_bit_for_bit(tile, wdtype, monkeypatch):
    """Kernel 4's plain version is kernel 1's on ``pack_abfp_weight(w)``:
    equal bits, with and without the plain version's row chunking (forced
    down to a few rows here)."""
    from repro_torch.kernels import abfp_matmul as am

    rng = np.random.default_rng(tile)
    cfg = QuantConfig(mode="abfp_kernel", tile_width=tile, gain=8.0,
                      noise_lsb=0.5)
    w = torch.from_numpy(_weight(rng, 2 * tile + 24, 300)).to(wdtype)
    x = torch.from_numpy(rng.normal(size=(2, 21, w.shape[0]))
                         .astype(np.float32))
    want = abfp_matmul_packed_ref(x, pack_abfp_weight(w, cfg), cfg, 3)
    assert torch.equal(abfp_matmul_ref(x, w, cfg, 3), want)
    monkeypatch.setattr(am, "REF_TERM_ELEMENTS", 3 * 384 * 5)
    assert torch.equal(abfp_matmul_ref(x, w, cfg, 3), want)


def test_dense_routes_abfp_kernel_to_the_unpacked_kernel():
    rng = np.random.default_rng(5)
    cfg = QuantConfig(mode="abfp_kernel", tile_width=32, gain=4.0,
                      noise_lsb=0.5)
    w = torch.from_numpy(_weight(rng, 64, 48))
    x = torch.from_numpy(rng.normal(size=(3, 64)).astype(np.float32))
    key = np.array([1, 2], np.uint32)
    assert torch.equal(ops.dense(x, w, cfg, key),
                       abfp_matmul_ref(x, w, cfg, 1 ^ 2))
    assert torch.equal(ops.dense(x, w, cfg, key, plain=True),
                       abfp_matmul_ref(x, w, cfg, 3))


# ---------------------------------------------------------------------------
# Kernel 2: fused QKV
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gains", [False, True])
@pytest.mark.parametrize("m", [1, 8])
def test_fused_qkv_matches_pallas(m, gains):
    rng = np.random.default_rng(50 + m)
    jcfg, cfg = _cfgs(32, 0.5, 8.0 if gains else 1.0)
    k = 160
    x = rng.normal(size=(m, k)).astype(np.float32)
    ws = [_weight(rng, k, c) for c in (160, 64, 64)]
    seeds = (11, -22, 33)
    want = fused_qkv_packed_pallas(
        jnp.asarray(x),
        tuple(j_pack(jnp.asarray(w), jcfg, adaptive_gain=gains) for w in ws),
        jcfg, tuple(jnp.int32(s) for s in seeds))
    pws = [pack_abfp_weight(torch.from_numpy(w), cfg, adaptive_gain=gains)
           for w in ws]
    got = fused_qkv_packed_ref(torch.from_numpy(x), pws, cfg, seeds)
    for name, g, wnt in zip("qkv", got, want):
        assert_bf16_match(g, wnt, f"fused {name} m={m} gains={gains}")


def test_concat_qkv_layout():
    """The pack-time concatenation keeps each weight's columns and gains
    side by side, in kernel layout."""
    rng = np.random.default_rng(3)
    _, cfg = _cfgs(32, 0.5, 8.0)
    pws = [pack_abfp_weight(torch.from_numpy(_weight(rng, 96, c)), cfg,
                            adaptive_gain=True) for c in (96, 32, 32)]
    qkv = concat_qkv(pws, cfg)
    assert qkv.njs == (1, 1, 1)
    assert qkv.kcodes.shape == (96 // 4, 384)
    assert torch.equal(qkv.scales[:, 128:256], pws[1].scales)
    assert torch.equal(qkv.gains[:, 2], pws[2].gains)
    # Word (q, c) packs codes rows 4q..4q+3 of column c, low byte first.
    b = qkv.kcodes.view(torch.int8).reshape(24, 384, 4)
    assert torch.equal(b.permute(0, 2, 1).reshape(96, 384)[:, :128],
                       pws[0].codes)


# ---------------------------------------------------------------------------
# Kernel 3: int8-KV decode attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rep", [1, 3])
def test_decode_attention_matches_pallas(rep):
    rng = np.random.default_rng(rep)
    b, s_max, kh, d = 4, 24, 2, 16
    h = kh * rep
    q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    kc = rng.integers(-127, 128, size=(b, s_max, kh, d), dtype=np.int8)
    vc = rng.integers(-127, 128, size=(b, s_max, kh, d), dtype=np.int8)
    ks = np.abs(rng.normal(size=(b, s_max, kh))).astype(np.float32)
    vs = np.abs(rng.normal(size=(b, s_max, kh))).astype(np.float32)
    lengths = np.array([1, s_max, 7, 13], np.int32)
    want = j_attn(jnp.asarray(q), jnp.asarray(kc),
                  jnp.asarray(ks, jnp.bfloat16), jnp.asarray(vc),
                  jnp.asarray(vs, jnp.bfloat16),
                  lengths=jnp.asarray(lengths))
    t = torch.from_numpy
    got = quantized_decode_attention(
        t(q), t(kc), t(ks).to(torch.bfloat16), t(vc),
        t(vs).to(torch.bfloat16), lengths=t(lengths))
    assert got.dtype == torch.float32 and got.shape == (b, 1, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dist", ["normal", "laplace", "uniform", "bf16"])
def test_decode_route_reciprocal_codes_equal_division(dist):
    """The decode launch's activation codes (``x_code_rcp`` in
    ``csrc/abfp_matmul.cu``): rint(RN(RN(x * RN(1 / s)) * 127)) wherever
    that value lies more than 2**-13 from a half-integer, else the IEEE
    division.  In f32 on the CPU, over 2**22 elements in tiles of 128
    with s = bf16(max |x|): every code equals the reference's rint(RN(RN(x
    / s) * 127)), and the division runs on under 0.1 % of them (1 % on
    bf16 inputs, whose quotients hit half-integers exactly more often)."""
    rng = np.random.default_rng(len(dist))
    shape = (1 << 15, 128)
    x = {"normal": rng.normal(size=shape),
         "laplace": rng.laplace(size=shape) * 3.0,
         "uniform": rng.uniform(-1e-3, 1e-3, size=shape),
         "bf16": rng.normal(size=shape) * 40.0}[dist]
    x = torch.from_numpy(x.astype(np.float32))
    if dist == "bf16":
        x = x.to(torch.bfloat16).float()
    s = x.abs().amax(-1, keepdim=True).to(torch.bfloat16).float()
    lx = torch.tensor(127.0)
    want = torch.clamp(torch.round((x / s) * lx), -127, 127)
    ta = (x * (1.0 / s)) * lx
    tie = ((ta - torch.floor(ta)) - 0.5).abs()
    fast = tie > 2.0 ** -13
    got = torch.where(fast, torch.round(ta), torch.round((x / s) * lx))
    assert torch.equal(torch.clamp(got, -127, 127), want)
    assert float((~fast).float().mean()) < (1e-2 if dist == "bf16" else 1e-3)


def _split_decode_attention(q, kc, ks, vc, vs, lengths, splits, warps=8):
    """Kernel 3's CUDA order in PyTorch, on the CPU, in f32.

    Per (row, KV head) and position split (whole block steps of
    ``warps * 512 / D`` positions over the first ``length``, or all S when
    length is 0): warp w takes steps of 512 / D positions at p_lo + w * PPW,
    p_lo + (w + warps) * PPW, ...; each step's scores (q * D^-0.5) . codes *
    (k_scale / 127) (-1e30 on a length-0 row), the step max, an online
    softmax (running max; denominator and PV accumulator rescaled by
    exp(m_old - m_new)), PV weights p * (v_scale / 127); the warps merged
    by exp(m_w - max m_w), then the splits the same way, and one division
    at the end."""
    b, _, h, d = q.shape
    s_max, kh = kc.shape[1], kc.shape[2]
    rep = h // kh
    ppw = 512 // d
    step = ppw * warps
    qs = (q.float() * torch.tensor(d ** -0.5)).reshape(b, kh, rep, d)
    kf, vf = kc.float(), vc.float()
    ksc, vsc = ks.float() / 127.0, vs.float() / 127.0
    out = torch.empty(b, kh, rep, d)

    def merge(parts):
        m = torch.stack([p[0] for p in parts]).amax(0)
        if bool(torch.isinf(m).all()):
            return m, torch.zeros(rep), torch.zeros(rep, d)
        e = [torch.exp(p[0] - m) for p in parts]
        return (m, sum(p[1] * w for p, w in zip(parts, e)),
                sum(p[2] * w[:, None] for p, w in zip(parts, e)))

    for bi in range(b):
        n = int(lengths[bi])
        length = s_max if n <= 0 else min(n, s_max)
        per = -(-(-(-length // splits)) // step) * step
        for g in range(kh):
            split_parts = []
            for z in range(splits):
                lo, hi = min(length, z * per), min(length, z * per + per)
                warp_parts = []
                for w in range(warps):
                    m = torch.full((rep,), -torch.inf)
                    den, acc = torch.zeros(rep), torch.zeros(rep, d)
                    for p in range(lo + w * ppw, hi, step):
                        pos = torch.arange(p, min(p + ppw, hi))
                        sc = qs[bi, g] @ kf[bi, pos, g].T * ksc[bi, pos, g]
                        if n <= 0:
                            sc = torch.full_like(sc, -1e30)
                        m_new = torch.maximum(m, sc.amax(1))
                        corr = torch.exp(m - m_new)
                        pr = torch.exp(sc - m_new[:, None])
                        den = den * corr + pr.sum(1)
                        acc = acc * corr[:, None] \
                            + (pr * vsc[bi, pos, g]) @ vf[bi, pos, g]
                        m = m_new
                    warp_parts.append((m, den, acc))
                split_parts.append(merge(warp_parts))
            _, den, acc = merge(split_parts)
            out[bi, g] = acc / den[:, None]
    return out.reshape(b, 1, h, d).to(q.dtype)


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("rep", [1, 3, 4, 16])
def test_split_decode_attention_order_matches_plain_and_pallas(rep, d,
                                                               splits):
    """Kernel 3's position split, online softmax and merges against the
    Pallas kernel in interpret mode and the plain version, lengths 0, 1, S
    and one between, one split and three; D = 256 (gemma-7b: two positions
    a warp step) and 16 query heads per KV head (chatglm3-6b: four blocks
    of four heads).  Bar: rtol 1e-5, atol 1e-6 in f32 (the kernel-3 bar
    above; only the sum order differs)."""
    rng = np.random.default_rng(100 * rep + d + splits)
    b, s_max, kh = 4, 300, 2
    h = kh * rep
    q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    kc = rng.integers(-127, 128, size=(b, s_max, kh, d), dtype=np.int8)
    vc = rng.integers(-127, 128, size=(b, s_max, kh, d), dtype=np.int8)
    ks = np.abs(rng.normal(size=(b, s_max, kh))).astype(np.float32)
    vs = np.abs(rng.normal(size=(b, s_max, kh))).astype(np.float32)
    lengths = np.array([0, 1, s_max, 173], np.int32)
    want = np.asarray(j_attn(jnp.asarray(q), jnp.asarray(kc),
                             jnp.asarray(ks, jnp.bfloat16), jnp.asarray(vc),
                             jnp.asarray(vs, jnp.bfloat16),
                             lengths=jnp.asarray(lengths)))
    t = torch.from_numpy
    args = (t(q), t(kc), t(ks).to(torch.bfloat16), t(vc),
            t(vs).to(torch.bfloat16))
    got = _split_decode_attention(*args, t(lengths), splits)
    plain = quantized_decode_attention(*args, lengths=t(lengths))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_decode_attention_split_rule():
    """One block per (row, KV head, head group) up to SPLIT_POSITIONS
    cached positions; past it, splits of at least SPLIT_POSITIONS that
    give the card about SPLIT_BLOCKS blocks; at most four query heads per
    block."""
    assert decode_attention_split(4, 512, 15, 5) == (3, 1, 1)
    assert decode_attention_split(4, SPLIT_POSITIONS, 32, 4) == (4, 2, 1)
    assert decode_attention_split(1, 32768, 6, 2) == (3, 1, 32)
    assert decode_attention_split(4, 32768, 15, 5) == (3, 1, 13)
    assert decode_attention_split(64, 4096, 8, 8) == (1, 1, 1)
    # chatglm3-6b's 16 query heads per KV head: four blocks of four heads;
    # gemma-7b's group of one.
    assert decode_attention_split(4, 512, 32, 2) == (4, 4, 1)
    assert decode_attention_split(4, 2048, 32, 2) == (4, 4, 2)
    assert decode_attention_split(4, 512, 16, 16) == (1, 1, 1)


# ---------------------------------------------------------------------------
# On the CPU the wrappers run the plain versions and launch nothing
# ---------------------------------------------------------------------------


def test_cpu_calls_launch_no_kernel():
    ops.reset_launch_counts()
    rng = np.random.default_rng(0)
    _, cfg = _cfgs(32, 0.5, 8.0)
    pws = [pack_abfp_weight(torch.from_numpy(_weight(rng, 64, c)), cfg,
                            adaptive_gain=True) for c in (64, 32, 32)]
    x = torch.from_numpy(rng.normal(size=(2, 64)).astype(np.float32))
    y = abfp_matmul_packed(x, pws[0], cfg, 5)
    assert torch.equal(y, abfp_matmul_packed_ref(x, pws[0], cfg, 5))
    outs = fused_qkv_packed(x, pws, cfg, (1, 2, 3))
    for o, r in zip(outs, fused_qkv_packed_ref(x, pws, cfg, (1, 2, 3))):
        assert torch.equal(o, r)
    q = torch.randn(2, 1, 4, 8)
    codes = torch.zeros(2, 5, 2, 8, dtype=torch.int8)
    sc = torch.ones(2, 5, 2, dtype=torch.bfloat16)
    fused_quantized_decode_attention(q, codes, sc, codes, sc,
                                     lengths=torch.tensor([1, 5]))
    w = torch.from_numpy(_weight(rng, 64, 32))
    assert torch.equal(abfp_matmul(x, w, cfg, 5),
                       abfp_matmul_ref(x, w, cfg, 5))
    qa = torch.randn(1, 8, 4, 32)
    flash_attention(qa, qa[:, :, :2], qa[:, :, :2])
    assert ops.launch_counts() == {
        "abfp_matmul_packed": 0, "fused_qkv_packed": 0,
        "fused_quantized_decode_attention": 0, "abfp_matmul": 0,
        "flash_attention": 0}


@pytest.mark.parametrize("tile", [8, 16, 32, 128])
@pytest.mark.parametrize("n_blocks", [1, 3, 8, 20, 384])
def test_route_rule(tile, n_blocks):
    """Decode sizes (M <= 8) take the one-launch decode route at every
    tile; above them, tiles that are not whole 32-deep MMA steps (n a power
    of two from 32) and more than FUSED_MAX_TILES K-tiles take the
    two-launch route; the fused route takes 16-row blocks for a weight
    that stays in L2 and 32 rows for a larger one: only row blocks the
    CUDA launch takes."""
    cfg = QuantConfig(mode="abfp_packed", tile_width=tile, gain=8.0)
    tiles = -(-960 // tile)
    for m in (1, 4, 8, 9, 16, 17, 32, 33, 40, 48, 130, 512, 2048, 8192):
        rows = fused_rows(m, tile, n_blocks, cfg, tiles)
        if m <= 8:
            assert rows == DECODE_ROWS
            continue
        if tile % 32:
            assert rows == 0
            continue
        assert rows in FUSED_ROWS
        resident = tiles * tile * n_blocks * 128 <= FUSED_L2_RESIDENT_BYTES
        assert rows == (16 if resident else 32)
    assert fused_rows(2048, 128, 384, cfg, 8) == 32     # the LM head
    assert fused_rows(2048, 128, 20, cfg, 8) == 16      # an MLP weight
    wide = QuantConfig(mode="abfp_packed", tile_width=512, gain=8.0)
    assert fused_rows(2048, 512, 8, wide, 2) == 0  # tile dot could reach 2**22
    assert fused_rows(2048, 96, 8, cfg, 10) == 0   # not a power of two
    assert fused_rows(2048, 128, 8, cfg, FUSED_MAX_TILES) > 0
    assert fused_rows(2048, 128, 8, cfg, FUSED_MAX_TILES + 1) == 0
    # The decode route at every tile, tile dot or tile count: its only limit
    # is a block's shared memory (M x Kp activation codes).
    assert fused_rows(4, 512, 8, wide, 2) == DECODE_ROWS
    assert fused_rows(8, 128, 8, cfg, FUSED_MAX_TILES + 1) == DECODE_ROWS
    assert fused_rows(8, 128, 8, cfg, 136) == DECODE_ROWS  # K = 17,408
    assert fused_rows(8, 128, 8, cfg, 140) == 0            # K = 17,920
    assert fused_rows(1, 128, 8, cfg, 256) == DECODE_ROWS  # K = 32,768
