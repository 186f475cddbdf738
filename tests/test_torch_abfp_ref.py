"""The port's ``abfp_ref`` numerics, the einsum oracle and the
straight-through estimator against the JAX package's.

The analogues of ``tests/test_abfp_core.py``: the same numpy-seeded
inputs through ``repro.core.abfp`` and ``repro_torch.core.abfp``, with the
same PRNG key on both sides (the port's threefry chain).

Bars:
  * codes and scales (max-abs and percentile) equal bit for bit, and so do
    the ADC noise draws (``ams_noise``, the scan's per-tile ``uniform``);
  * the scan and the oracle's bf16 outputs equal JAX's but for one-ULP
    flips, at most one in each started 1,000 elements (XLA on the CPU
    contracts the ADC's multiply and noise add into a fused multiply-add;
    measured: 0 flips in every case here);
  * the STE gradients of ``dense`` (float, abfp_ref, abfp_kernel,
    abfp_packed) and of ``dense_packed`` against ``jax.grad``: rtol = atol
    = 1e-5 (f32 matmuls in another sum order);
  * ``QuantConfig()`` equals the JAX package's field for field.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.abfp as J
from repro.kernels import ops as jops
from repro.kernels.ref import abfp_matmul_ref as j_oracle
from repro_torch.core import abfp as T
from repro_torch.core import prng
from repro_torch.kernels import ops
from repro_torch.kernels.ref import abfp_matmul_ref as oracle
from repro_torch.models.layers import Numerics

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker

GRAD_TOL = 1e-5


def _bits(a):
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def assert_flips(got, want, what):
    """bf16 outputs equal but for one-ULP flips, at most one in each
    started 1,000 elements."""
    d = np.abs(_bits(got).astype(np.int32) - _bits(want).astype(np.int32))
    flips = int((d == 1).sum())
    print(f"{what}: {flips}/{d.size} one-ULP flips")
    assert d.max() <= 1, what
    assert flips <= -(-d.size // 1000), what


def _key(seed):
    k = prng.fold_in(prng.PRNGKey(seed), 3)
    return jnp.asarray(k, jnp.uint32), k


@pytest.mark.parametrize("pct", [None, 99.0, 90.0, 50.0])
@pytest.mark.parametrize("tile", [8, 32, 128])
def test_codes_and_scales_bit_equal(tile, pct):
    rng = np.random.default_rng(tile + int(pct or 0))
    x = rng.normal(size=(5, 200)).astype(np.float32)
    x[1, :tile] = 0.0                                   # an all-zero tile
    w = (rng.laplace(size=(200, 96)) * 0.05).astype(np.float32)
    jc = J.QuantConfig(tile_width=tile, scale_percentile=pct)
    tc = T.QuantConfig(tile_width=tile, scale_percentile=pct)
    for jf, tf, a in ((J.quantize_input_tiles, T.quantize_input_tiles, x),
                      (J.quantize_weight_tiles, T.quantize_weight_tiles, w)):
        jq, js = jf(jnp.asarray(a), jc)
        tq, ts = tf(torch.from_numpy(a), tc)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq, np.float32))
        np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                      np.asarray(js).view(np.int32))
    v = jnp.asarray(x)
    np.testing.assert_array_equal(
        T.quantize(torch.from_numpy(x), 0.25, 1.0).numpy(),
        np.asarray(J.quantize(v, 0.25, 1.0)))


@pytest.mark.parametrize("noise", [0.5, 0.25])
def test_ams_noise_equals_jax_uniform(noise):
    cfg_kw = dict(tile_width=32, noise_lsb=noise)
    for seed in range(4):
        jk, tk = _key(seed)
        want = np.asarray(J.ams_noise(jk, (7, 129), J.QuantConfig(**cfg_kw)))
        got = T.ams_noise(tk, (7, 129), T.QuantConfig(**cfg_kw)).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


def test_scan_tile_noise_equals_jax_uniform():
    """The scan's per-tile draw: ``uniform(split(key, T)[t], (M, N),
    -noise, noise)`` for all tiles at once equals JAX's tile by tile."""
    jk, tk = _key(9)
    got = prng.uniform(prng.split(tk, 5), (6, 40), -0.5, 0.5).numpy()
    for t, jkt in enumerate(jax.random.split(jk, 5)):
        want = np.asarray(jax.random.uniform(jkt, (6, 40), jnp.float32,
                                             minval=-0.5, maxval=0.5))
        np.testing.assert_array_equal(got[t].view(np.int32),
                                      want.view(np.int32))


@pytest.mark.parametrize("noise", [0.0, 0.5])
@pytest.mark.parametrize("gain", [1.0, 8.0, "tile"])
@pytest.mark.parametrize("tile", [8, 32, 128])
def test_scan_matches_jax(tile, gain, noise):
    rng = np.random.default_rng(tile + 7 * int(noise * 2))
    x = rng.normal(size=(2, 20, 300)).astype(np.float32)
    w = (rng.normal(size=(300, 136)) * 0.05).astype(np.float32)
    kw = dict(tile_width=tile, gain=8.0 if gain == "tile" else gain,
              noise_lsb=noise)
    jk, tk = _key(tile)
    tg = None
    if gain == "tile":
        tg = np.exp2(rng.integers(0, 4, size=-(-300 // tile))
                     ).astype(np.float32)
    want = J.abfp_matmul(jnp.asarray(x), jnp.asarray(w), J.QuantConfig(**kw),
                         jk if noise else None,
                         None if tg is None else jnp.asarray(tg))
    got = T.abfp_matmul(torch.from_numpy(x), torch.from_numpy(w),
                        T.QuantConfig(**kw), tk if noise else None,
                        None if tg is None else torch.from_numpy(tg))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 20, 136)
    assert_flips(got, want, f"scan tile={tile} gain={gain} noise={noise}")


def test_scan_tile_groups_give_the_scan(monkeypatch):
    """Tiles evaluated one group at a time (forced down to one tile) give
    the same bits as the default grouping."""
    rng = np.random.default_rng(3)
    cfg = T.QuantConfig(tile_width=32, gain=8.0, noise_lsb=0.5)
    x = torch.from_numpy(rng.normal(size=(9, 200)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(200, 70)) * 0.1)
                         .astype(np.float32))
    want = T.abfp_matmul(x, w, cfg, prng.PRNGKey(4))
    monkeypatch.setattr(T, "REF_GROUP_ELEMENTS", 1)
    assert torch.equal(T.abfp_matmul(x, w, cfg, prng.PRNGKey(4)), want)


def test_scan_requires_a_key_and_refuses_seeds():
    cfg = T.QuantConfig(tile_width=32, noise_lsb=0.5)
    x, w = torch.ones(2, 64), torch.ones(64, 8)
    with pytest.raises(ValueError, match="requires a PRNG key"):
        T.abfp_matmul(x, w, cfg)
    for seed in (5, torch.tensor([5], dtype=torch.int32)):
        with pytest.raises(ValueError, match="not an int seed"):
            ops.dense(x, w, cfg.replace(mode="abfp_ref"), seed)


@pytest.mark.parametrize("noise", [0.0, 0.5])
@pytest.mark.parametrize("tile", [8, 32])
def test_oracle_matches_jax_and_the_scan(tile, noise):
    rng = np.random.default_rng(tile)
    x = rng.normal(size=(12, 96)).astype(np.float32)
    w = (rng.normal(size=(96, 40)) * 0.1).astype(np.float32)
    kw = dict(tile_width=tile, gain=4.0, noise_lsb=noise)
    jk, tk = _key(tile + 1)
    want = j_oracle(jnp.asarray(x), jnp.asarray(w), J.QuantConfig(**kw),
                    jk if noise else None)
    got = oracle(torch.from_numpy(x), torch.from_numpy(w),
                 T.QuantConfig(**kw), tk if noise else None)
    assert_flips(got, want, f"oracle tile={tile} noise={noise}")
    scan = T.abfp_matmul(torch.from_numpy(x), torch.from_numpy(w),
                         T.QuantConfig(**kw), tk if noise else None)
    assert_flips(got, scan, f"oracle vs scan tile={tile} noise={noise}")


def _grad_inputs(seed, m=6, k=96, n=40):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * 0.1).astype(np.float32)
    g = rng.normal(size=(2, m, n)).astype(np.float32)
    return x, w, g


@pytest.mark.parametrize("mode", ["float", "abfp_ref", "abfp_kernel",
                                  "abfp_packed"])
def test_dense_ste_gradients_match_jax(mode):
    x, w, g = _grad_inputs(1)
    kw = dict(mode=mode, tile_width=32, gain=8.0, noise_lsb=0.5)
    jc, tc = J.QuantConfig(**kw), T.QuantConfig(**kw)
    jk, tk = _key(2)

    def jloss(xx, ww):
        return jnp.sum(jops.dense(xx, ww, jc, jk).astype(jnp.float32)
                       * jnp.asarray(g))

    jdx, jdw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    y = ops.dense(tx, tw, tc, tk)
    (y.float() * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx),
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw),
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    # The STE's gradients are those of the plain matmul (Eq. 8), taken
    # with the cotangent in the output's dtype.
    g_out = torch.from_numpy(g).to(y.dtype).float()
    want_dx = g_out @ torch.from_numpy(w).t()
    torch.testing.assert_close(tx.grad, want_dx, rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_ste_keeps_operand_dtypes(dtype):
    x, w, g = _grad_inputs(2)
    cfg = T.QuantConfig(mode="abfp_ref", tile_width=32)
    tx = torch.from_numpy(x).to(dtype).requires_grad_(True)
    tw = torch.from_numpy(w).to(dtype).requires_grad_(True)
    ops.dense(tx, tw, cfg).float().sum().backward()
    assert tx.grad.dtype == dtype and tw.grad.dtype == dtype


def test_dense_packed_ste_matches_jax():
    x, w, g = _grad_inputs(3)
    kw = dict(mode="abfp_fused", tile_width=32, gain=8.0, noise_lsb=0.5)
    jc, tc = J.QuantConfig(**kw), T.QuantConfig(**kw)
    jpw = J.pack_abfp_weight(jnp.asarray(w), jc, adaptive_gain=True)
    tpw = T.pack_abfp_weight(torch.from_numpy(w), tc, adaptive_gain=True)
    jk, tk = _key(4)

    def jloss(xx):
        return jnp.sum(jops.dense_packed(xx, jpw, jc, jk).astype(jnp.float32)
                       * jnp.asarray(g))

    jdx = jax.grad(jloss)(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    y = ops.dense(tx, tpw, tc, tk)
    (y.float() * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx),
                               rtol=GRAD_TOL, atol=GRAD_TOL)


def test_abfp_matmul_ste_matches_jax():
    x, w, g = _grad_inputs(5)
    kw = dict(tile_width=32, gain=8.0, noise_lsb=0.5)
    jc, tc = J.QuantConfig(**kw), T.QuantConfig(**kw)
    jk, tk = _key(6)

    def jloss(xx, ww):
        return jnp.sum(J.abfp_matmul_ste(xx, ww, jc, jk).astype(jnp.float32)
                       * jnp.asarray(g))

    (jv, (jdx, jdw)) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    y = T.abfp_matmul_ste(tx, tw, tc, tk)
    assert torch.equal(y, T.abfp_matmul(tx.detach(), tw.detach(), tc, tk))
    loss = (y.float() * torch.from_numpy(g)).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jv), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx),
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw),
                               rtol=GRAD_TOL, atol=GRAD_TOL)


def test_quantize_ste_identity_gradient():
    rng = np.random.default_rng(8)
    v = rng.normal(size=(4, 33)).astype(np.float32)
    jv, jg = jax.value_and_grad(
        lambda a: jnp.sum(J.quantize_ste(a, 0.125, 1.0) * 3.0))(
            jnp.asarray(v))
    tv = torch.from_numpy(v).requires_grad_(True)
    q = T.quantize_ste(tv, 0.125, 1.0)
    np.testing.assert_array_equal(q.detach().numpy(),
                                  np.asarray(J.quantize(jnp.asarray(v),
                                                        0.125, 1.0)))
    (q * 3.0).sum().backward()
    np.testing.assert_array_equal(tv.grad.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(tv.grad.numpy(), np.full_like(v, 3.0))


@pytest.mark.parametrize("tile", [8, 32, 128])
def test_digital_bfp_matmul_matches_jax(tile):
    rng = np.random.default_rng(tile + 2)
    x = rng.normal(size=(3, 5, 260)).astype(np.float32)
    w = (rng.normal(size=(260, 72)) * 0.1).astype(np.float32)
    want = J.digital_bfp_matmul(jnp.asarray(x), jnp.asarray(w),
                                J.QuantConfig(tile_width=tile))
    got = T.digital_bfp_matmul(torch.from_numpy(x), torch.from_numpy(w),
                               T.QuantConfig(tile_width=tile))
    assert_flips(got, want, f"digital tile={tile}")


def _field_value(v):
    if isinstance(v, torch.dtype):
        return str(v).replace("torch.", "")
    if hasattr(v, "dtype") and not isinstance(v, (int, float)):
        return np.dtype(v).name
    return v


def test_quant_config_defaults_equal_jax():
    j, t = J.QuantConfig(), T.QuantConfig()
    jf = {f.name: _field_value(getattr(j, f.name))
          for f in dataclasses.fields(j)}
    tf = {f.name: _field_value(getattr(t, f.name))
          for f in dataclasses.fields(t)}
    assert tf == jf
    assert t.mode == "abfp_ref"
    assert T.FLOAT == T.QuantConfig(mode="float")


def test_numerics_hands_abfp_ref_calls_their_keys():
    """In ``abfp_ref`` mode each dense call gets ``fold_in(layer key,
    counter)`` itself (JAX's ``Numerics``); a pass keeps it in key mode,
    and a seed table is refused."""
    cfg = T.QuantConfig(mode="abfp_ref", tile_width=32, noise_lsb=0.5)
    key = prng.fold_in(prng.PRNGKey(1), 2)
    nx = Numerics(cfg, key).fold(3)
    keys = nx.next_seeds(2)
    lk = prng.fold_in(key, 3)
    for c, k in enumerate(keys):
        np.testing.assert_array_equal(k, prng.fold_in(lk, c))
    assert Numerics(cfg, key).as_table(2, 7, "cpu").seeds is None
    tbl = Numerics(cfg.replace(mode="abfp_kernel"), key).as_table(2, 7, "cpu")
    table_ref = Numerics(cfg, seeds=tbl.seeds, calls=7)
    with pytest.raises(ValueError, match="not an int seed"):
        table_ref.fold(0).dense(torch.ones(1, 32), torch.ones(32, 8))
