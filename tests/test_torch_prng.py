"""The port's threefry key chain agrees with JAX's word for word.

``PRNGKey``, ``split`` and ``fold_in`` must give the ``key_data`` of
``jax.random`` (threefry2x32, partitionable variant), and ``key_to_seed``
the int32 seed of ``repro.kernels.ops._key_to_seed``: the noise lattice of
every matmul is a function of this chain.  Exact equality.
"""

import jax
import numpy as np
import pytest
import torch

from repro.kernels.ops import _key_to_seed as j_key_to_seed
from repro_torch.core import prng

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker


def _jdata(key):
    return np.asarray(jax.random.key_data(key), np.uint32)


def test_known_answers():
    assert prng.key_data(prng.split(prng.PRNGKey(0))[1]).tolist() == \
        [928981903, 3453687069]
    assert prng.key_data(prng.fold_in(prng.PRNGKey(0), 3)).tolist() == \
        [2467461003, 3840466878]
    assert prng.key_data(prng.PRNGKey(0)).tolist() == [0, 0]


@pytest.mark.parametrize("block", range(4))
def test_split_and_fold_in_match_jax(block):
    rng = np.random.default_rng(block)
    seeds = [int(s) for s in rng.integers(0, 2 ** 32, 25, dtype=np.uint64)]
    counters = [0, 1, 2, 999_983] + [
        int(c) for c in rng.integers(0, 2 ** 32, 4, dtype=np.uint64)]
    for seed in seeds:
        jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
        np.testing.assert_array_equal(prng.key_data(tk), _jdata(jk))
        for js, ts in zip(jax.random.split(jk, 3), prng.split(tk, 3)):
            np.testing.assert_array_equal(prng.key_data(ts), _jdata(js))
        for c in counters:
            np.testing.assert_array_equal(
                prng.key_data(prng.fold_in(tk, c)),
                _jdata(jax.random.fold_in(jk, c)))


def test_engine_and_numerics_chain_matches_jax():
    """split per pass, fold the layer, fold the call counter, xor."""
    jk, tk = jax.random.PRNGKey(7), prng.PRNGKey(7)
    for _ in range(5):
        jk, jsub = jax.random.split(jk)
        tk, tsub = prng.split(tk)
        for layer in (0, 31, 999_983):
            for call in range(7):
                jkey = jax.random.fold_in(jax.random.fold_in(jsub, layer),
                                          call)
                tkey = prng.fold_in(prng.fold_in(tsub, layer), call)
                assert prng.key_to_seed(tkey) == int(j_key_to_seed(jkey))
    assert prng.key_to_seed(None) is None


def test_seed_out_of_range_raises():
    with pytest.raises(ValueError):
        prng.PRNGKey(-1)


# ---------------------------------------------------------------------------
# A pass's seed table, and JAX's sampler on tensors
# ---------------------------------------------------------------------------


def _scalar_chain(key, layers, calls):
    """Every seed of a pass by the scalar chain ``Numerics`` followed
    before the seed table: layer folds, then call counters; the LM head's
    fold 999,983 last."""
    return [prng.key_to_seed(prng.fold_in(prng.fold_in(key, li), c))
            for li in range(layers) for c in range(calls)] + [
        prng.key_to_seed(prng.fold_in(prng.fold_in(key, 999_983), 0))]


@pytest.mark.parametrize("seed", range(4))
def test_seed_table_equals_scalar_chain_and_jax(seed):
    key = prng.split(prng.PRNGKey(seed))[1]
    tbl = prng.seed_table(key, 32, 7, 999_983)
    assert tbl.dtype == np.int32 and tbl.shape == (32 * 7 + 1,)
    assert tbl.tolist() == _scalar_chain(key, 32, 7)
    jkey = jax.random.split(jax.random.PRNGKey(seed))[1]
    for li, c, at in ((0, 0, 0), (31, 6, 32 * 7 - 1), (7, 3, 7 * 7 + 3)):
        jk = jax.random.fold_in(jax.random.fold_in(jkey, li), c)
        assert tbl[at] == int(j_key_to_seed(jk))
    jk = jax.random.fold_in(jax.random.fold_in(jkey, 999_983), 0)
    assert tbl[-1] == int(j_key_to_seed(jk))


@pytest.mark.parametrize("kind", ["decode", "prefill16", "prefill64",
                                  "prefill128"])
def test_every_pass_call_reads_the_scalar_chains_seed(kind, monkeypatch):
    """Run a pass on the smoke config (abfp_fused: the fused QKV call takes
    three seeds at once) and record the seed every dense call is handed:
    the table slots, in call order, hold exactly the scalar chain."""
    import dataclasses

    import torch

    from repro_torch.configs import smoke_config
    from repro_torch.core.abfp import QuantConfig
    from repro_torch.models import (
        Numerics,
        decode_step,
        init_decode_state,
        init_params,
        pack_model_params,
        prefill,
    )
    from repro_torch.models.lm import calls_per_layer

    mcfg = dataclasses.replace(smoke_config("smollm-360m"), kv_quant=True)
    quant = QuantConfig(mode="abfp_fused", tile_width=32, gain=8.0,
                        noise_lsb=0.5)
    params = pack_model_params(init_params(0, mcfg, device="cpu"), quant,
                               mcfg)
    state = init_decode_state(mcfg, 2, 160, device="cpu")
    got = []
    orig = Numerics.next_seeds

    def record(self, n):
        out = orig(self, n)
        assert isinstance(out, torch.Tensor) and out.dtype == torch.int32
        got.extend(int(v) for v in out)
        return out

    monkeypatch.setattr(Numerics, "next_seeds", record)
    key = prng.fold_in(prng.PRNGKey(3), 5)
    nx = Numerics(quant, key)
    if kind == "decode":
        decode_step(params, state, torch.tensor([3, 4], dtype=torch.int32),
                    mcfg, nx)
    else:
        s = int(kind[len("prefill"):])
        prefill(params, state, torch.ones((2, s), dtype=torch.int32),
                torch.tensor([s, 1], dtype=torch.int32), mcfg, nx)
    assert got == _scalar_chain(key, mcfg.num_layers, calls_per_layer(mcfg))


@pytest.mark.parametrize("n", [256, 49_152])
def test_random_bits_and_uniform_equal_jax_bit_for_bit(n):
    import jax.numpy as jnp
    import torch

    seed = 11
    uids = np.array([0, 5, 2 ** 31 - 1, 3], np.int32)
    idxs = np.array([0, 1, 7, 100], np.int32)
    k0, k1 = prng.row_keys(seed, torch.from_numpy(uids),
                           torch.from_numpy(idxs))
    bits = prng.random_bits(k0, k1, n)
    u = prng.uniform(bits).numpy()
    g = prng.gumbel(bits).numpy()
    tiny = np.finfo(np.float32).tiny
    for b in range(len(uids)):
        jk = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                   uids[b]), idxs[b])
        np.testing.assert_array_equal(
            bits[b].numpy(),
            np.asarray(jax.random.bits(jk, (n,), jnp.uint32), np.int64))
        ju = np.asarray(jax.random.uniform(jk, (n,), jnp.float32,
                                           minval=tiny, maxval=1.0))
        np.testing.assert_array_equal(u[b].view(np.int32), ju.view(np.int32))
        # -log(-log(u)): XLA's and PyTorch's f32 log part in the last bit
        # (about a quarter of the draws), never by more than 2**-22 of
        # max(1, |g|).
        jg = np.asarray(jax.random.gumbel(jk, (n,), jnp.float32))
        d = np.abs(g[b] - jg) / np.maximum(np.abs(jg), 1.0)
        assert d.max() <= 2.0 ** -22, d.max()


@pytest.mark.parametrize("start", [0, 2 ** 32 - 40, 3 * 2 ** 32 - 7])
def test_counter_bits_hash_64_bit_counters_as_jax(start):
    """``key_bits``' counter range is 64-bit: each flat index i hashes the
    pair (i >> 32, i & 0xFFFFFFFF), JAX's ``iota_2x32_shape``.  A window of
    80 counters (across 2**32 for the second and third starts) equals
    JAX's ``threefry2x32_p`` on the same (hi, lo) words under two keys;
    at start 0 it equals ``key_bits`` and JAX's ``random_bits``."""
    from jax._src.prng import threefry2x32_p

    n = 80
    keys = np.array([[0, 7], [928981903, 3453687069]], np.uint32)
    got = prng.counter_bits(torch.from_numpy(keys.astype(np.int64)), start,
                            n).numpy()
    i = np.arange(start, start + n, dtype=np.uint64)
    hi = (i >> np.uint64(32)).astype(np.uint32)
    lo = (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    for row, (k0, k1) in zip(got, keys):
        b0, b1 = threefry2x32_p.bind(
            jax.numpy.full(n, k0, np.uint32), jax.numpy.full(n, k1, np.uint32),
            jax.numpy.asarray(hi), jax.numpy.asarray(lo))
        np.testing.assert_array_equal(row, np.asarray(b0 ^ b1, np.int64))
    if start == 0:
        np.testing.assert_array_equal(got[1], prng.key_bits(keys[1], (n,))
                                      .numpy())
        jbits = jax.random.bits(jax.random.wrap_key_data(keys[1]), (n,))
        np.testing.assert_array_equal(got[1], np.asarray(jbits, np.int64))


def test_key_bits_draws_past_2_32_elements_on_meta():
    """A draw of more than 2**32 elements is taken (on ``meta``: nothing
    allocated), as JAX takes it; above 2**64 it is refused, as JAX's."""
    shape = (2 ** 16, 2 ** 16 + 3)
    bits = prng.key_bits(prng.PRNGKey(1), shape, device="meta")
    assert bits.shape == shape and bits.dtype == torch.int64
    u = prng.uniform(prng.PRNGKey(1), (2, 2 ** 32), -0.5, 0.5, "meta")
    assert u.shape == (2, 2 ** 32) and u.dtype == torch.float32
    with pytest.raises(NotImplementedError, match="2\\*\\*64"):
        prng.key_bits(prng.PRNGKey(1), (2 ** 33, 2 ** 32), device="meta")
