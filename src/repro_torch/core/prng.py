"""Counter-based PRNG keys: JAX's ``threefry2x32`` in plain Python.

The AMS noise of every noisy matmul is seeded from a key chain: the
serving engine splits its key once per pass, ``Numerics`` folds in the
layer index and then a per-call counter, the LM head folds in ``999_983``,
and ``key_to_seed`` xors the two key words into the kernel's int32 seed.
This module reproduces that chain word for word, so the port draws the
same noise lattice as the JAX package for the same engine seed.

The variant is JAX's ``threefry2x32`` with ``jax_threefry_partitionable``
on (the default since JAX 0.5): ``split(key, n)[i]`` and ``fold_in(key,
i)`` both hash the counter pair ``(0, i)`` under ``key``, and
``random_bits(key, shape)`` hashes, for each flat index ``i`` of the
shape, the pair of its high and low 32-bit words ``(i >> 32, i &
0xFFFFFFFF)`` (JAX's ``iota_2x32_shape``).

Keys are numpy ``uint32`` arrays of shape (2,), the layout
``jax.random.key_data`` returns.  One key's chain is scalar host work, in
plain Python integers; ``key_table`` (and ``seed_table``, its keys'
seeds) evaluates a whole pass's chain (every layer, every call) in one
vectorised numpy pass.  ``split``, ``fold_in`` and ``key_bits`` also take
a key held as an int64 tensor of its uint32 words (a row of a pass's key
table on the card): they then run where the key lives, with no host copy
and no sync, so a captured pass draws fresh noise from each replay's
table.

The tensor functions at the end (``random_bits``, ``uniform``, ``gumbel``,
``row_keys``) run JAX's sampler on any device, inside a CUDA graph too:
``models.lm.sample_tokens`` draws with them what ``jax.random.categorical``
draws.  Their uint32 words are held in int64 tensors.  ``key_bits`` draws
JAX's ``random_bits(key, shape)`` for host keys (one or a stack), and
``uniform(key, shape, minval, maxval)``, ``randint`` and ``categorical``
build JAX's samplers on it, bit for bit: the ABFP scan's ADC noise, DNF's
histogram draws and the synthetic data; ``normal`` (the stub frontends'
features) to the last bit of ``erfinv``.  A shape's bits are those of its
flattened 64-bit counter range: any draw JAX takes (up to 2**64
elements), though on a card a draw still needs its int64 threefry chains
(several tensors of 8 bytes per element) to fit in device memory.
"""

from __future__ import annotations

import math

import numpy as np
import torch

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


def fold_in(key, data: int):
    """New key from ``key`` and a uint32 ``data`` (JAX ``fold_in``).  A
    stack of keys (..., 2) folds ``data`` into each.  A key held as an
    int64 tensor of uint32 words folds where it lives (no host copy, no
    sync) and returns a tensor of the same shape."""
    if isinstance(key, torch.Tensor):
        k = _words(key)
        b0, b1 = _threefry_t(k[..., 0], k[..., 1], 0, int(data) & _M32)
        return torch.stack([b0, b1], dim=-1)
    key = np.asarray(key, dtype=np.uint32)
    if key.ndim > 1:
        b0, b1 = _threefry_np(key[..., 0], key[..., 1], np.uint32(0),
                              np.uint32(int(data) & _M32))
        return np.stack([b0, b1], axis=-1)
    return _key(*threefry2x32(int(key[0]), int(key[1]), 0, int(data) & _M32))


def split(key, num: int = 2):
    """``num`` new keys as a (num, 2) array (JAX ``split`` in the
    partitionable variant); row i hashes the counter pair (0, i).  A key
    held as a (2,) int64 tensor of uint32 words splits where it lives
    (no host copy, no sync) into a (num, 2) tensor."""
    if isinstance(key, torch.Tensor):
        k = _words(key)
        i = torch.arange(num, dtype=torch.int64, device=k.device)
        b0, b1 = _threefry_t(k[..., :1], k[..., 1:], torch.zeros_like(i), i)
        return torch.stack([b0, b1], dim=-1)
    b0, b1 = _threefry_np(np.uint32(key[0]), np.uint32(key[1]),
                          np.uint32(0), np.arange(num, dtype=np.uint32))
    return np.stack([b0, b1], axis=-1)


def key_data(key: np.ndarray) -> np.ndarray:
    """The raw uint32 words of a key."""
    return np.asarray(key, dtype=np.uint32)


def key_to_seed(key) -> int:
    """Xor of the two key words as an int32: the kernels' noise seed."""
    if key is None:
        return None
    v = (int(key[0]) ^ int(key[-1])) & _M32
    return v - (1 << 32) if v >= (1 << 31) else v


# ---------------------------------------------------------------------------
# A pass's seed table, vectorised
# ---------------------------------------------------------------------------


def _threefry_np(k0, k1, x0, x1):
    """``threefry2x32`` over broadcast numpy uint32 arrays."""
    k0, k1, x0, x1 = (np.asarray(v, np.uint32) for v in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = x0 + x1
            x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def key_table(key: np.ndarray, num_layers: int, calls: int,
              head_fold: int, extra=(), root: bool = False) -> np.ndarray:
    """Every dense call's key of one pass, in one vectorised evaluation:
    ``fold_in(fold_in(key, fold), call)`` for the folds 0..num_layers-1,
    then the folds ``extra`` (an encoder's layers), and calls
    0..calls-1 (fold-major); with ``root`` then the root key's own calls,
    ``fold_in(key, call)``; last the LM head's ``fold_in(fold_in(key,
    head_fold), 0)``.  A (n, 2) uint32 array, n = (num_layers +
    len(extra) + root) * calls + 1: the table the ``abfp_ref`` scan's
    passes read on the device."""
    folds = np.concatenate([np.arange(num_layers, dtype=np.uint32),
                            np.asarray(extra, dtype=np.uint32),
                            [np.uint32(head_fold)]])
    zero = np.zeros((), np.uint32)
    calls_ = np.arange(calls, dtype=np.uint32)
    lk0, lk1 = _threefry_np(np.uint32(key[0]), np.uint32(key[1]), zero,
                            folds)
    c0, c1 = _threefry_np(lk0[:, None], lk1[:, None], zero, calls_[None, :])
    keys = np.stack([c0, c1], axis=-1)                 # (folds, calls, 2)
    parts = [keys[:-1].reshape(-1, 2)]
    if root:
        r0, r1 = _threefry_np(np.uint32(key[0]), np.uint32(key[1]), zero,
                              calls_)
        parts.append(np.stack([r0, r1], axis=-1))
    return np.concatenate(parts + [keys[-1, :1]])


def seed_table(key: np.ndarray, num_layers: int, calls: int,
               head_fold: int, extra=(), root: bool = False) -> np.ndarray:
    """Every noise seed of one pass: the int32 ``key_to_seed`` of each key
    of ``key_table`` (the same layout), shape (n,)."""
    keys = key_table(key, num_layers, calls, head_fold, extra, root)
    return (keys[:, 0] ^ keys[:, 1]).view(np.int32)


def normal(key, shape, device=None) -> torch.Tensor:
    """JAX's f32 ``jax.random.normal(key, shape)``: ``sqrt(2) *
    erfinv(u)`` of the uniform draw ``u`` on [nextafter(-1, 0), 1).  The
    uniform is bit-equal to JAX's; ``torch.erfinv`` and XLA's ``erf_inv``
    may differ in the last bit."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0, device)
    return torch.erfinv(u) * float(np.float32(np.sqrt(2)))


# ---------------------------------------------------------------------------
# JAX's sampler as tensor functions (uint32 words in int64 tensors)
# ---------------------------------------------------------------------------


def _threefry_t(k0, k1, x0, x1):
    """``threefry2x32`` over broadcast int64 tensors holding uint32 words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _words(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.int64) & _M32


def row_keys(seed: int, uids: torch.Tensor, idxs: torch.Tensor):
    """The (B,) key words of ``fold_in(fold_in(PRNGKey(seed), uid), idx)``
    per row, computed where ``uids``/``idxs`` live.  Returns (k0, k1)."""
    if not 0 <= int(seed) <= _M32:
        raise ValueError(f"seed must be in [0, 2**32), got {seed}")
    zero = torch.zeros_like(_words(uids))
    k0, k1 = _threefry_t(zero, zero + int(seed), zero, _words(uids))
    return _threefry_t(k0, k1, zero, _words(idxs))


def random_bits(k0: torch.Tensor, k1: torch.Tensor, n: int) -> torch.Tensor:
    """JAX's partitionable 32-bit ``random_bits(key, (n,))`` for each key of
    the (B,) words k0, k1: the xor of the two output words of the counter
    pair (0, i).  Returns (B, n) int64 holding uint32 values."""
    i = torch.arange(n, dtype=torch.int64, device=k0.device)[None, :]
    b0, b1 = _threefry_t(k0[:, None], k1[:, None], torch.zeros_like(i), i)
    return b0 ^ b1


_TINY = float(np.finfo(np.float32).tiny)


def counter_bits(kw: torch.Tensor, start: int, n: int) -> torch.Tensor:
    """The 32-bit words of the flat counters ``start .. start + n - 1``
    under each key of ``kw`` ((G, 2) int64 words): the xor of the two
    threefry words of each counter's pair ``(i >> 32, i & 0xFFFFFFFF)``.
    Returns (G, n) int64 holding uint32 values, where ``kw`` lives."""
    i = torch.arange(start, start + n, dtype=torch.int64, device=kw.device)
    b0, b1 = _threefry_t(kw[:, :1], kw[:, 1:], (i >> 32)[None],
                         (i & _M32)[None])
    return b0 ^ b1


def key_bits(keys, shape, device=None) -> torch.Tensor:
    """JAX's partitionable 32-bit ``random_bits(key, shape)`` for a key
    (2,), or for each key of a stack (G, 2) (then (G, *shape)): the
    ``counter_bits`` of the flattened shape's counters 0 .. n - 1.  int64
    tensor holding uint32 values.  A host key draws on ``device`` (its
    words go there by one pinned, non-blocking copy on a GPU); a key held
    as an int64 tensor draws where it lives, with no host copy and no sync
    (inside a captured pass too).  Below 2**32 elements every high word is
    0; above 2**64 JAX refuses the draw, and so does this."""
    shape = tuple(int(v) for v in shape)
    n = math.prod(shape)
    if n > 1 << 64:
        raise NotImplementedError(
            f"a draw of {n} elements exceeds 2**64 counters")
    if isinstance(keys, torch.Tensor):
        one = keys.dim() == 1
        kw = _words(keys).reshape(-1, 2)
    else:
        keys = np.asarray(keys, dtype=np.uint32)
        one = keys.ndim == 1
        dev = torch.device("cpu" if device is None else device)
        kw = torch.from_numpy(keys.reshape(-1, 2).astype(np.int64))
        if dev.type == "cuda":
            kw = kw.pin_memory().to(dev, non_blocking=True)
        elif dev.type != "cpu":
            kw = kw.to(dev)                  # a meta trace's draw
    bits = counter_bits(kw, 0, n).reshape((-1,) + shape)
    return bits[0] if one else bits


def bits_to_uniform(bits: torch.Tensor, minval: float,
                    maxval: float) -> torch.Tensor:
    """JAX's f32 ``uniform`` from 32 random bits: the top 23 bits as the
    mantissa of [1, 2), minus 1, times the f32 ``maxval - minval``, plus
    minval, then the max with minval.  XLA fuses the multiply and the add
    into one rounding (a fused multiply-add); here both run exactly in f64
    and round once to f32, which is the same whenever the exact sum fits
    53 bits (bounds within a factor 2**6 of each other, as the ADC noise's
    symmetric ones) or the product is exact in f32 (a power-of-two
    range)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)
    u = ((f - 1.0).double() * span + float(lo)).float()
    return torch.clamp(u, min=float(lo))


def uniform(key, shape=None, minval: float = 0.0, maxval: float = 1.0,
            device=None) -> torch.Tensor:
    """JAX's f32 ``jax.random.uniform(key, shape, minval=, maxval=)`` on
    ``device``, bit for bit.  Called with a tensor of random bits and no
    shape (the device sampler's form), it is ``uniform(minval=tiny,
    maxval=1)`` of those bits, the draw ``gumbel`` takes."""
    if shape is None:
        return bits_to_uniform(key, _TINY, 1.0)
    return bits_to_uniform(key_bits(key, shape, device), minval, maxval)


def gumbel(bits: torch.Tensor) -> torch.Tensor:
    """JAX's f32 ``gumbel`` (mode "low"): -log(-log(uniform))."""
    return -torch.log(-torch.log(uniform(bits)))


def randint(key, shape, minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """JAX's int32 ``jax.random.randint(key, shape, minval, maxval)``: two
    32-bit draws (keys ``split(key)``) folded into [minval, maxval) with
    JAX's uint32 remainder arithmetic.  Returns an int32 tensor."""
    if not (-(1 << 31) <= minval and maxval <= (1 << 31) - 1):
        raise ValueError("randint takes int32 bounds")
    k1, k2 = split(key)
    hi, lo = key_bits(k1, shape, device), key_bits(k2, shape, device)
    span = 1 if maxval <= minval else (maxval - minval) & _M32
    mult = (((1 << 16) % span) ** 2 & _M32) % span     # uint32 wrap
    off = ((((hi % span) * mult) & _M32) + lo % span) & _M32
    out = (minval + off % span) & _M32
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)


def categorical(key, logits: torch.Tensor, shape=None) -> torch.Tensor:
    """JAX's ``jax.random.categorical(key, logits, axis=-1, shape=)``: the
    argmax over the last axis of ``gumbel`` noise of shape ``(*shape,
    K)`` plus the logits (first index on ties).  Returns int64."""
    batch = tuple(logits.shape[:-1])
    shape = batch if shape is None else tuple(shape)
    g = gumbel(key_bits(key, shape + (logits.shape[-1],), logits.device))
    return torch.argmax(g + logits.float(), dim=-1)
