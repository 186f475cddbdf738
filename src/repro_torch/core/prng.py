"""Counter-based PRNG keys: JAX's ``threefry2x32`` in plain Python.

The AMS noise of every noisy matmul is seeded from a key chain: the
serving engine splits its key once per pass, ``Numerics`` folds in the
layer index and then a per-call counter, the LM head folds in ``999_983``,
and ``key_to_seed`` xors the two key words into the kernel's int32 seed.
This module reproduces that chain word for word, so the port draws the
same noise lattice as the JAX package for the same engine seed.

The variant is JAX's ``threefry2x32`` with ``jax_threefry_partitionable``
on (the default since JAX 0.5): ``split(key, n)[i]`` and ``fold_in(key,
i)`` both hash the counter pair ``(0, i)`` under ``key``.

Keys are numpy ``uint32`` arrays of shape (2,), the layout
``jax.random.key_data`` returns.  The chain is scalar host work (a few
hundred hashes a pass), so plain Python integers are the fastest form.
"""

from __future__ import annotations

from typing import List

import numpy as np

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: int, r: int) -> int:
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k0: int, k1: int, x0: int, x1: int):
    """20-round Threefry-2x32 hash of the counter pair (x0, x1) under the
    key (k0, k1); returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _key(k0: int, k1: int) -> np.ndarray:
    return np.array([k0, k1], dtype=np.uint32)


def PRNGKey(seed: int) -> np.ndarray:  # noqa: N802 (JAX's name)
    """Key of a non-negative integer seed below 2**32: words (0, seed)."""
    seed = int(seed)
    if not 0 <= seed <= _M32:
        raise ValueError(f"seed must be in [0, 2**32), got {seed}")
    return _key(0, seed)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """New key from ``key`` and a uint32 ``data`` (JAX ``fold_in``)."""
    return _key(*threefry2x32(int(key[0]), int(key[1]), 0, int(data) & _M32))


def split(key: np.ndarray, num: int = 2) -> List[np.ndarray]:
    """``num`` new keys (JAX ``split`` in the partitionable variant)."""
    k0, k1 = int(key[0]), int(key[1])
    return [_key(*threefry2x32(k0, k1, 0, i)) for i in range(num)]


def key_data(key: np.ndarray) -> np.ndarray:
    """The raw uint32 words of a key."""
    return np.asarray(key, dtype=np.uint32)


def key_to_seed(key) -> int:
    """Xor of the two key words as an int32: the kernels' noise seed."""
    if key is None:
        return None
    v = (int(key[0]) ^ int(key[-1])) & _M32
    return v - (1 << 32) if v >= (1 << 31) else v
