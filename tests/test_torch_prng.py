"""The port's threefry key chain agrees with JAX's word for word.

``PRNGKey``, ``split`` and ``fold_in`` must give the ``key_data`` of
``jax.random`` (threefry2x32, partitionable variant), and ``key_to_seed``
the int32 seed of ``repro.kernels.ops._key_to_seed``: the noise lattice of
every matmul is a function of this chain.  Exact equality.
"""

import jax
import numpy as np
import pytest

from repro.kernels.ops import _key_to_seed as j_key_to_seed
from repro_torch.core import prng


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
