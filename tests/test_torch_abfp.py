"""The port's ABFP numerics agree with the JAX package's, byte for byte.

``QuantConfig``'s float constants equal as float32; ``pack_abfp_weight``
gives the same int8 codes, bf16 scale bits and per-tile gains at tiles 8,
32 and 128 with ragged K and N and gain budgets 1 and 8; the noise hash is
bit-equal.  Exact equality everywhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.abfp as J
from repro.kernels.abfp_matmul import _hash_uniform as j_hash
from repro.kernels.abfp_matmul import auto_bm as j_auto_bm
from repro.kernels.abfp_matmul import default_bk as j_default_bk
from repro_torch.core import abfp as T
from repro_torch.kernels.abfp_matmul import _hash_uniform, auto_bm, default_bk

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker


def _f32(v):
    return np.float32(v)


@pytest.mark.parametrize("tile,bits,gain", [(8, 8, 1.0), (32, 8, 8.0),
                                            (128, 6, 4.0), (128, 8, 8.0)])
def test_quant_config_constants(tile, bits, gain):
    j = J.QuantConfig(tile_width=tile, bits_x=bits, bits_w=bits, gain=gain)
    t = T.QuantConfig(tile_width=tile, bits_x=bits, bits_w=bits, gain=gain)
    for name in ("delta_w", "delta_x", "delta_y", "adc_code_scale",
                 "adc_base_scale", "bin_y"):
        assert _f32(getattr(j, name)) == _f32(getattr(t, name)), name
        assert _f32(getattr(t, name)) == T.f32_const(getattr(t, name))
    assert T.quant_levels(bits) == J.quant_levels(bits)


def _bits(a):
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


PACK_CASES = [(8, 40, 24), (8, 200, 136), (32, 200, 320), (32, 96, 128),
              (128, 960, 320), (128, 300, 136)]


@pytest.mark.parametrize("gain", [1.0, 8.0])
@pytest.mark.parametrize("tile,k,n", PACK_CASES)
def test_pack_is_byte_equal(tile, k, n, gain):
    rng = np.random.default_rng(tile + k + n)
    w = (rng.laplace(size=(k, n)) * 0.05).astype(np.float32)
    w[:, 3] = 0.0                                  # an all-zero column
    jc = J.QuantConfig(mode="abfp_fused", tile_width=tile, gain=gain)
    tc = T.QuantConfig(mode="abfp_fused", tile_width=tile, gain=gain)
    jp = J.pack_abfp_weight(jnp.asarray(w), jc, adaptive_gain=True)
    tp = T.pack_abfp_weight(torch.from_numpy(w), tc, adaptive_gain=True)
    assert (tp.k, tp.n_cols, tp.kp, tp.n_padded, tp.num_tiles) == \
        (jp.k, jp.n_cols, jp.kp, jp.n_padded, jp.num_tiles)
    assert tp.codes.dtype == torch.int8
    np.testing.assert_array_equal(tp.codes.numpy(), np.asarray(jp.codes))
    np.testing.assert_array_equal(_bits(tp.scales), _bits(jp.scales))
    np.testing.assert_array_equal(tp.gains.numpy(), np.asarray(jp.gains))
    np.testing.assert_array_equal(
        T.dequantize_packed(tp).numpy(), np.asarray(J.dequantize_packed(jp)))
    assert tp.nbytes() == jp.nbytes()


def test_bf16_weight_packs_byte_equal():
    rng = np.random.default_rng(5)
    w = (rng.normal(size=(160, 96)) * 0.1).astype(np.float32)
    jc = J.QuantConfig(tile_width=32)
    tc = T.QuantConfig(tile_width=32)
    jp = J.pack_abfp_weight(jnp.asarray(w, jnp.bfloat16), jc)
    tp = T.pack_abfp_weight(torch.from_numpy(w).to(torch.bfloat16), tc)
    np.testing.assert_array_equal(tp.codes.numpy(), np.asarray(jp.codes))
    np.testing.assert_array_equal(_bits(tp.scales), _bits(jp.scales))
    assert tp.gains is None and jp.gains is None


def test_gain_at_a_power_of_two_boundary():
    """A tile whose headroom lands exactly on a power of two: both sides
    must take the same floor(log2) branch."""
    # Codes of +-L on every row make rms(w_hat) == 1 and headroom
    # n / (4 sqrt(n)) = sqrt(n) / 4 == 2 exactly at n = 64.
    w = np.where(np.arange(64 * 128).reshape(64, 128) % 2, 1.0, -1.0)
    w = w.astype(np.float32)
    jc = J.QuantConfig(mode="abfp_fused", tile_width=64, gain=8.0)
    tc = T.QuantConfig(mode="abfp_fused", tile_width=64, gain=8.0)
    jg = np.asarray(J.adaptive_tile_gains(J.pack_abfp_weight(
        jnp.asarray(w), jc), jc))
    tg = T.adaptive_tile_gains(T.pack_abfp_weight(torch.from_numpy(w), tc),
                               tc).numpy()
    np.testing.assert_array_equal(tg, jg)
    assert tg.tolist() == [2.0]


def test_helpers_match():
    rng = np.random.default_rng(9)
    v = rng.normal(size=(3, 5, 32)).astype(np.float32)
    np.testing.assert_array_equal(
        T.tile_scales(torch.from_numpy(v)).numpy(),
        np.asarray(J.tile_scales(jnp.asarray(v))))
    np.testing.assert_array_equal(
        T.pad_to_tiles(torch.from_numpy(v), 8, axis=1).numpy(),
        np.asarray(J.pad_to_tiles(jnp.asarray(v), 8, axis=1)))
    s = np.array([0.0, 2.0], np.float32)
    np.testing.assert_array_equal(T.safe_scale(torch.from_numpy(s)).numpy(),
                                  np.asarray(J.safe_scale(jnp.asarray(s))))
    vh = (rng.uniform(-1.2, 1.2, size=(64,)) // (1 / 254) * (1 / 254)
          ).astype(np.float32)     # many exact half-code ties
    np.testing.assert_array_equal(
        T.encode_codes(torch.from_numpy(vh), 8).numpy(),
        np.asarray(J.encode_codes(jnp.asarray(vh), 8), np.float32))
    for m in (1, 4, 8, 9, 40, 200):
        assert auto_bm(m) == j_auto_bm(m)
    for n in (8, 32, 128):
        for k in (40, 200, 960, 2560):
            assert default_bk(n, k) == j_default_bk(n, k)


@pytest.mark.parametrize("seed,salt", [(0, 0), (12345, 7), (-5, 2 ** 31 - 1),
                                       (2 ** 31 - 1, 123456789)])
def test_hash_uniform_bit_equal(seed, salt):
    want = np.asarray(j_hash((64, 128), jnp.int32(seed), jnp.uint32(salt)))
    rows = torch.arange(64)[:, None]
    cols = torch.arange(128)[None, :]
    got = _hash_uniform(rows, cols, seed, salt).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
