"""Model layers of the decoders and the encoder: the serving (KV-cache)
paths, the cacheless teacher-forced attention and cross-attention, and
the absolute (sinusoidal) and rotary positions.

Every weight-activation matmul goes through ``Numerics.dense``, so one
switch runs the model in ``float``, ``abfp_ref``, ``abfp_kernel``,
``abfp_packed`` or ``abfp_fused`` numerics, with the straight-through
gradients of ``kernels.ops`` under autograd.  Norms, softmax, rotary
embedding and the nonlinearities run in float32 (range-sensitive ops stay
digital, as in the paper).

The KV cache is a dict of tensors per layer, ``{"k", "v", "length"}`` plus
``"k_scale"``/``"v_scale"`` for the int8 cache, and is UPDATED IN PLACE:
a decode tick writes one slot per row instead of copying the whole cache
(about 84 MB per tick for smollm-360m at capacity 4, max_len 512 in bf16).
Rows whose ``n_tokens`` is 0 and padding lanes are never written.  A
windowed layer (``window > 0``, hybrid local attention) holds a RING
buffer of ``window`` slots: token ``length`` goes to slot ``length %
window``, and a chunk scans token by token through the decode core.  A
PAGED cache holds
per-layer page pools ``{"k_pages", "v_pages"}`` (plus the scale pools)
shared by all rows, addressed through a (B, MP) page table
(``paged_append_attend``).

Without a cache, attention runs over the whole sequence at once: the flash
kernel (``kernels.flash_attention``) with ``mcfg.use_flash_attention``,
else ``chunked_attention``, the JAX package's plain online-softmax scan;
in train mode (``mcfg.remat``) ``train_attention``, query chunks each
under ``torch.utils.checkpoint``.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import cost_trace
from repro_torch.core.abfp import PackedWeight, QuantConfig
from repro_torch.core.prng import fold_in, key_table, key_to_seed, seed_table
from repro_torch.kernels import ops
from repro_torch.kernels.abfp_decode_fused import (
    fused_quantized_decode_attention,
    quantized_decode_attention,
)
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_ref,
)

Tensor = torch.Tensor

NEG = -1e30     # the mask constant of every attention core


# ---------------------------------------------------------------------------
# Numerics context: quant mode + PRNG threading for AMS noise
# ---------------------------------------------------------------------------


# The fold of the LM head's noise key (the layers fold their index).
LM_HEAD_FOLD = 999_983


class Numerics:
    """Per-pass numerics state.

    Each ``dense`` call folds ``(base key, call counter)`` into its own
    noise key; the caller folds the layer index into the base key first,
    so streams are unique per (layer, call) and match the JAX package's.

    A pass hands its kernels the resulting seeds from a SEED TABLE: an
    int32 tensor on the pass's device holding every call's seed
    (``core.prng.seed_table``, fold-major, ``calls`` per fold, the LM
    head's last).  ``Numerics(quant, seeds=table, calls=C)`` gives each
    dense call a one-element slot of it, so no seed is a launch argument
    and a captured pass reads fresh seeds from the table on every replay.
    Row ``i`` holds fold ``i`` (layer ``i``); ``rows`` maps the folds past
    the layers (an encoder's ``ENCODER_FOLD + g``) to their rows, and
    ``base`` places the root's own calls (the cross K/V) on theirs
    (``table_numerics``).

    ``abfp_ref`` numerics read a KEY TABLE instead (``keys=``, the same
    layout from ``core.prng.key_table``: an (n, 2) int64 tensor of the
    keys' uint32 words): the tile scan splits each call's own key,
    ``fold_in(layer key, counter)``, as the JAX package does, and draws its
    noise on the device from the (2,) row it is handed.

    A key-mode ``Numerics(quant, key)`` turns into table mode at the top of
    a model pass (``as_table``); below a key-mode ``Numerics`` that was not
    turned (DNF's per-layer factories), each call gets its host key
    (``abfp_ref``) or that key's seed as a host int.

    ``plain=True`` runs every kernel's plain PyTorch version instead of its
    wrapper, on any device: the whole-model reference a kernel run on the
    card is compared with.

    ``mesh`` (a ``distributed.sharding.Mesh``; tensor-parallel serving):
    with a 'model' axis of size > 1 every dense call dispatches
    column-parallel through ``kernels.ops.dense_tp``, bit-identical to the
    one-device call at any mesh shape; a weight the mesh cannot split runs
    whole (replicated) in the same dispatch.
    """

    def __init__(self, quant: QuantConfig, key=None, plain: bool = False, *,
                 seeds: Optional[Tensor] = None,
                 keys: Optional[Tensor] = None, calls: int = 0,
                 base: int = 0, rows: Optional[dict] = None, mesh=None):
        self.quant = quant
        self._key = key
        self.plain = plain
        self.mesh = mesh
        self.seeds = seeds
        self.keys = keys
        self.calls = calls
        self._base = base
        self._rows = rows or {}
        self._count = 0

    @property
    def noisy(self) -> bool:
        return self.quant.noise_lsb > 0.0 and self.quant.mode != "float"

    @property
    def _table(self) -> Optional[Tensor]:
        return self.seeds if self.seeds is not None else self.keys

    def as_table(self, num_layers: int, calls: int, device, extra=(),
                 root: bool = False) -> "Numerics":
        """This root key's whole pass as a seed table on ``device`` (a key
        table in ``abfp_ref`` mode; one host-to-device copy, pinned and
        non-blocking on a GPU), with rows for the folds ``extra`` and,
        with ``root``, the root's own calls (``core.prng.seed_table``,
        ``key_table``); unchanged without a key, without noise or already
        in table mode."""
        if self._table is not None or self._key is None or not self.noisy:
            return self
        if self.quant.mode == "abfp_ref":
            tbl = torch.from_numpy(key_table(
                self._key, num_layers, calls, LM_HEAD_FOLD, extra,
                root).astype(np.int64))
        else:
            tbl = torch.from_numpy(seed_table(self._key, num_layers, calls,
                                              LM_HEAD_FOLD, extra, root))
        dev = torch.device(device)
        if dev.type == "cuda":
            tbl = tbl.pin_memory().to(dev, non_blocking=True)
        elif dev.type != "cpu":
            tbl = tbl.to(dev)                # a meta trace's pass
        return table_numerics(self.quant, tbl, num_layers, calls, extra,
                              root, plain=self.plain, mesh=self.mesh)

    def fold(self, idx: int) -> "Numerics":
        tbl = self._table
        if tbl is not None:
            base = (tbl.shape[0] - 1 if idx == LM_HEAD_FOLD
                    else self._rows.get(idx, idx) * self.calls)
            return Numerics(self.quant, plain=self.plain, seeds=self.seeds,
                            keys=self.keys, calls=self.calls, base=base,
                            rows=self._rows, mesh=self.mesh)
        key = None if self._key is None else fold_in(self._key, idx)
        return Numerics(self.quant, key, self.plain, mesh=self.mesh)

    def next_seeds(self, n: int):
        """The noise seeds of the next ``n`` dense calls, one counter step
        each: an (n,) int32 slice of the seed table ((n, 2) rows of the
        key table in ``abfp_ref`` mode), n host ints (n host keys in
        ``abfp_ref`` mode), or n Nones without noise."""
        c = self._count
        self._count += n
        if not self.noisy:
            return [None] * n
        tbl = self._table
        if tbl is not None:
            if self._base + c + n > min(tbl.shape[0],
                                        self._base + max(self.calls, 1)):
                raise ValueError(f"the seed table has no slot for call "
                                 f"{c + n - 1} at {self._base}")
            return tbl[self._base + c:self._base + c + n]
        if self._key is None:
            return [None] * n
        keys = [fold_in(self._key, c + i) for i in range(n)]
        if self.quant.mode == "abfp_ref":
            return keys
        return [key_to_seed(k) for k in keys]

    def dense(self, x: Tensor, w) -> Tensor:
        return self.dense_seeded(x, w, self.next_seeds(1)[0])

    def dense_seeded(self, x: Tensor, w, seed) -> Tensor:
        """A dense call with its noise seed (or key) given: column-parallel
        on a mesh (``kernels.ops.dense_tp``), else ``kernels.ops.dense``."""
        if ops.tp_size(self.mesh) > 1:
            return ops.dense_tp(x, w, self.quant, seed, self.mesh,
                                plain=self.plain)
        return ops.dense(x, w, self.quant, seed, plain=self.plain)


def table_numerics(quant: QuantConfig, table: Tensor, num_layers: int,
                   calls: int, extra=(), root: bool = False,
                   plain: bool = False, mesh=None) -> Numerics:
    """The root ``Numerics`` of a pass over ``table`` laid out as
    ``core.prng.seed_table(key, num_layers, calls, LM_HEAD_FOLD, extra,
    root)`` lays it out: a seed table (n,), or a key table (n, 2)."""
    rows = {f: num_layers + i for i, f in enumerate(extra)}
    base = (num_layers + len(extra)) * calls if root else 0
    kind = "keys" if table.dim() == 2 else "seeds"
    return Numerics(quant, plain=plain, calls=calls, base=base, rows=rows,
                    mesh=mesh, **{kind: table})


# ---------------------------------------------------------------------------
# Norms and positions (digital float32)
# ---------------------------------------------------------------------------


def rmsnorm(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return y.to(dtype)


def layernorm(x: Tensor, scale: Tensor, bias: Tensor,
              eps: float = 1e-5) -> Tensor:
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dtype)


def norm(x: Tensor, params: dict, kind: str) -> Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, params["scale"])
    return layernorm(x, params["scale"], params["bias"])


def sinusoidal_positions(positions: Tensor, d: int) -> Tensor:
    """Absolute sinusoidal position embedding at ``positions`` (B, S) ->
    (B, S, d) f32: sin on the even dims, cos on the odd ones."""
    pos = positions.float()[..., None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=positions.device)
    ang = pos / torch.pow(torch.full((), 10_000.0, device=positions.device),
                          dim / d)                             # (B, S, d/2)
    pe = torch.zeros(positions.shape + (d,), dtype=torch.float32,
                     device=positions.device)
    pe[..., 0::2] = torch.sin(ang)
    pe[..., 1::2] = torch.cos(ang)
    return pe


def rope(x: Tensor, positions: Tensor, theta: float,
         fraction: float) -> Tensor:
    """x: (B, S, H, D); positions: (B, S).  ``fraction`` < 1 rotates only
    the first fraction * D dims (partial rotary)."""
    d = x.shape[-1]
    rot_d = int(d * fraction)
    rot_d -= rot_d % 2
    if rot_d == 0:
        return x
    x_rot, x_pass = x[..., :rot_d], x[..., rot_d:]
    half = rot_d // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(torch.full((), theta, dtype=torch.float32,
                                device=x.device), exps)
    ang = positions[..., None].float() * freq                 # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1 = x_rot[..., :half].float()
    x2 = x_rot[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------------------
# Attention cores
# ---------------------------------------------------------------------------


def _repeat_kv(k: Tensor, num_heads: int) -> Tensor:
    """(B, S, KH, D) -> (B, S, H, D) for GQA/MQA."""
    kh = k.shape[2]
    if kh == num_heads:
        return k
    return torch.repeat_interleave(k, num_heads // kh, dim=2)


def chunked_attention(q: Tensor, k: Tensor, v: Tensor, *,
                      causal: bool = True, window: int = 0,
                      q_offset: int = 0, chunk: int = 512) -> Tensor:
    """Flash-semantics attention in plain PyTorch: a loop over KV chunks
    with an f32 online softmax, so the scores of one chunk at a time are
    held, O(B * H * Sq * chunk).

    q: (B, Sq, H, D); k, v: (B, Skv, KH, D).  ``window`` > 0 restricts keys
    to the last ``window`` positions; ``q_offset`` is the position of
    q[0].  Returns (B, Sq, H, D) in q's dtype."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    chunk = min(chunk, skv)
    pad = (-skv) % chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    dev = q.device
    qf = q.float() * (d ** -0.5)
    q_pos = q_offset + torch.arange(sq, device=dev)
    m = torch.full((b, h, sq), NEG, dtype=torch.float32, device=dev)
    den = torch.zeros((b, h, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=dev)
    for c0 in range(0, skv + pad, chunk):
        k_c = k[:, c0:c0 + chunk].float()
        v_c = v[:, c0:c0 + chunk].float()
        kpos = c0 + torch.arange(chunk, device=dev)
        s = torch.einsum("bshd,bchd->bhsc", qf, k_c)           # (B, H, Sq, c)
        valid = (kpos[None, :] < skv).expand(sq, chunk)
        if causal:
            valid = valid & (kpos[None, :] <= q_pos[:, None])
        if window > 0:
            valid = valid & (kpos[None, :] > q_pos[:, None] - window)
        s = torch.where(valid[None, None], s, torch.full_like(s, NEG))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        den = den * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhsc,bchd->bhsd", p, v_c)
        m = m_new
    out = acc / torch.clamp(den, min=1e-30)[..., None]      # (B, H, Sq, D)
    return out.transpose(1, 2).to(q.dtype)


def _train_attention_chunk(qc: Tensor, k: Tensor, v: Tensor, q0: int,
                           causal: bool, window: int) -> Tensor:
    """One query chunk of ``train_attention``: (B, qc, H, D) f32 queries
    (already scaled) against all keys."""
    nq, skv = qc.shape[1], k.shape[1]
    s_ = torch.einsum("bqhd,bkhd->bhqk", qc, k)               # (B, H, qc, S)
    qpos = q0 + torch.arange(nq, device=qc.device)
    kpos = torch.arange(skv, device=qc.device)
    valid = torch.ones((nq, skv), dtype=torch.bool, device=qc.device)
    if causal:
        valid = valid & (kpos[None, :] <= qpos[:, None])
    if window > 0:
        valid = valid & (kpos[None, :] > qpos[:, None] - window)
    s_ = torch.where(valid[None, None], s_, torch.full_like(s_, NEG))
    p = torch.softmax(s_, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def train_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: int = 0, q_chunk: int = 512) -> Tensor:
    """Training-path attention: QUERY chunks, each under
    ``torch.utils.checkpoint``, so the backward recomputes a chunk's
    (q_chunk, Skv) scores instead of storing them all (the JAX package's
    rematerialized scan).  ``q_chunk`` falls back to S when it does not
    divide S.  q: (B, S, H, D); k, v: (B, Skv, KH, D) -> (B, S, H, D) in
    q's dtype."""
    b, s, h, d = q.shape
    k = _repeat_kv(k, h).float()
    v = _repeat_kv(v, h).float()
    q_chunk = min(q_chunk, s)
    if s % q_chunk:
        q_chunk = s
    qf = q.float() * (d ** -0.5)
    outs = []
    for q0 in range(0, s, q_chunk):
        qc = qf[:, q0:q0 + q_chunk]
        if torch.is_grad_enabled():
            outs.append(checkpoint(_train_attention_chunk, qc, k, v, q0,
                                   causal, window, use_reentrant=False))
        else:
            outs.append(_train_attention_chunk(qc, k, v, q0, causal, window))
    return torch.cat(outs, dim=1).to(q.dtype)


def decode_attention(q: Tensor, k_cache: Tensor, v_cache: Tensor, *,
                     lengths: Tensor) -> Tensor:
    """One-token attention against a float KV cache.

    q: (B, 1, H, D); caches: (B, S_max, KH, D); ``lengths``: (B,) number of
    valid cache positions.  Returns (B, 1, H, D) in q's dtype."""
    _, _, h, d = q.shape
    s_max = k_cache.shape[1]
    k = _repeat_kv(k_cache, h).float()
    v = _repeat_kv(v_cache, h).float()
    qf = q.float() * (d ** -0.5)
    s = torch.einsum("bshd,bchd->bhsc", qf, k)[:, :, 0]       # (B, H, S_max)
    valid = torch.arange(s_max, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(valid[:, None], s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhc,bchd->bhd", p, v)
    return out[:, None].to(q.dtype)


def _kv_encode(v: Tensor):
    """(..., D) -> int8 codes + per-vector bf16 max-abs scale (..., )."""
    vf = v.float()
    s = vf.abs().amax(dim=-1).to(torch.bfloat16).float()
    s_safe = torch.where(s == 0.0, torch.ones_like(s), s)
    codes = torch.clamp(torch.round(vf / s_safe[..., None] * 127.0), -127, 127)
    return codes.to(torch.int8), s.to(torch.bfloat16)


def _kv_decode(codes: Tensor, scales: Tensor, dtype) -> Tensor:
    """int8 codes + scales -> the dequantized cache in ``dtype``."""
    return (codes.float() * (scales.float() / 127.0)[..., None]).to(dtype)


def chunk_cache_attention(q: Tensor, k_cache: Tensor, v_cache: Tensor, *,
                          q_pos: Tensor) -> Tensor:
    """S-query attention against a float cache buffer; query (b, t) attends
    cache slots <= q_pos[b, t].  q: (B, S, H, D) -> (B, S, H, D)."""
    _, _, h, d = q.shape
    s_max = k_cache.shape[1]
    k = _repeat_kv(k_cache, h).float()
    v = _repeat_kv(v_cache, h).float()
    qf = q.float() * (d ** -0.5)
    sc = torch.einsum("bshd,bchd->bhsc", qf, k)               # (B, H, S, C)
    mask = torch.arange(s_max, device=q.device)[None, None, :] \
        <= q_pos[:, :, None]
    sc = torch.where(mask[:, None], sc, torch.full_like(sc, NEG))
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhsc,bchd->bhsd", p, v)
    return out.transpose(1, 2).to(q.dtype)


def quantized_chunk_attention(q: Tensor, k_codes: Tensor, k_scale: Tensor,
                              v_codes: Tensor, v_scale: Tensor, *,
                              q_pos: Tensor) -> Tensor:
    """Chunked-prefill attention directly on int8 KV codes: the S-query
    form of ``quantized_decode_attention`` (scale factored out of both
    contractions)."""
    b, s, h, d = q.shape
    s_max, kh = k_codes.shape[1], k_codes.shape[2]
    rep = h // kh
    qg = (q.float() * (d ** -0.5)).reshape(b, s, kh, rep, d)
    sc = torch.einsum("bsgrd,bcgd->bgrsc", qg, k_codes.float())
    sc = sc * (k_scale.float().transpose(1, 2)[:, :, None, None, :] / 127.0)
    mask = torch.arange(s_max, device=q.device)[None, None, :] \
        <= q_pos[:, :, None]                                  # (B, S, C)
    sc = torch.where(mask[:, None, None], sc, torch.full_like(sc, NEG))
    p = torch.softmax(sc, dim=-1)
    pv = p * (v_scale.float().transpose(1, 2)[:, :, None, None, :] / 127.0)
    out = torch.einsum("bgrsc,bcgd->bsgrd", pv, v_codes.float())
    return out.reshape(b, s, h, d).to(q.dtype)


def _cache_values(kv_cache: dict, k: Tensor, v: Tensor) -> dict:
    """What the cache stores for K/V (..., KH, D): int8 codes and bf16
    scales (``k``, ``v``, ``k_scale``, ``v_scale``) for the int8 cache,
    else K/V in the cache's dtype."""
    if "k_scale" in kv_cache:
        kc, ks = _kv_encode(k)
        vc, vs = _kv_encode(v)
        return {"k": kc, "v": vc, "k_scale": ks, "v_scale": vs}
    return {"k": k.to(kv_cache["k"].dtype), "v": v.to(kv_cache["v"].dtype)}


def _attend_step(q: Tensor, vals: dict, kv_cache: dict, window: int,
                 ok: Optional[Tensor] = None):
    """Write one token's cache values per row (in place) and attend: the
    decode core.  q: (B, 1, H, D); ``vals`` from ``_cache_values`` (B,
    ...).  A ring buffer (``window`` > 0) writes slot ``length % S_max``
    and attends ``min(length + 1, S_max)`` slots.  Rows with ``ok`` False
    write back what their slot holds and keep their length.  Returns
    (out (B, 1, H, D), kv_cache)."""
    b = q.shape[0]
    s_max = kv_cache["k"].shape[1]
    length = kv_cache["length"]
    bidx = torch.arange(b, device=q.device)
    slot = (length % s_max if window > 0 else length).long()
    for name, val in vals.items():
        buf = kv_cache[name]
        if ok is not None:
            sel = ok.reshape((b,) + (1,) * (val.ndim - 1))
            val = torch.where(sel, val, buf[bidx, slot])
        buf[bidx, slot] = val
    filled = (torch.clamp(length + 1, max=s_max) if window > 0
              else length + 1)
    if "k_scale" in kv_cache:
        out = quantized_decode_attention(
            q, kv_cache["k"], kv_cache["k_scale"], kv_cache["v"],
            kv_cache["v_scale"], lengths=filled)
    else:
        out = decode_attention(q, kv_cache["k"], kv_cache["v"],
                               lengths=filled)
    length.add_(1 if ok is None else ok.to(length.dtype))
    return out, kv_cache


def _append_attend_one(q: Tensor, k: Tensor, v: Tensor, kv_cache: dict,
                       window: int = 0):
    """Append ONE token's K/V per row (in place) and attend: the decode
    tick core, a ring buffer with ``window`` > 0.  q: (B, 1, H, D); k, v:
    (B, 1, KH, D).  Returns (out, kv_cache) with the cache updated in
    place."""
    return _attend_step(q, _cache_values(kv_cache, k[:, 0], v[:, 0]),
                        kv_cache, window)


def chunk_append_attend(q: Tensor, k: Tensor, v: Tensor, kv_cache: dict, *,
                        n_tokens: Tensor, window: int = 0):
    """Append up to S new K/V per row (in place) and attend all S chunk
    queries: the chunked-prefill core.

    q: (B, S, H, D); k, v: (B, S, KH, D); ``n_tokens``: (B,) — tokens
    0..n-1 of row b's chunk are real, the rest padding.  Padding lanes and
    rows with n_tokens == 0 leave their cache slots bit-for-bit unchanged.
    Returns (out (B, S, H, D), kv_cache).

    A ring buffer (``window`` > 0) scans the chunk token by token through
    the decode core (``_attend_step``), padding lanes masked: a mid-chunk
    query may need keys that later chunk tokens evict, and the scan keeps
    the decode tick's buffer layout.  The cache values of the whole chunk
    are encoded at once (per vector, so the same values).

    An append-only cache scatters the chunk, then attends once.  No
    data-dependent shape and no host sync (the pass runs inside a CUDA
    graph): each of a row's first min(S, S_max) lanes owns the cache slot
    ``(length + lane) % S_max``, distinct within the row, and writes back
    the value already there unless it is a real token inside the buffer;
    this also covers the drop lane past the buffer when ``length +
    n_tokens == S_max``.  Lanes past S_max are never real."""
    b, s = q.shape[:2]
    if window > 0:
        vals = _cache_values(kv_cache, k, v)
        valid = (torch.arange(s, device=q.device)[None, :]
                 < n_tokens[:, None])
        outs = []
        for t in range(s):
            out_t, _ = _attend_step(q[:, t:t + 1],
                                    {n_: v_[:, t] for n_, v_ in vals.items()},
                                    kv_cache, window, valid[:, t])
            outs.append(out_t[:, 0])
        return torch.stack(outs, dim=1), kv_cache
    length = kv_cache["length"]
    s_max = kv_cache["k"].shape[1]
    offs = torch.arange(s, device=q.device)[None, :]
    q_pos = length[:, None] + offs                            # (B, S)
    w = min(s, s_max)
    valid = ((offs < n_tokens[:, None]) & (q_pos < s_max))[:, :w]
    bi = torch.arange(b, device=q.device)[:, None]
    pos = (q_pos[:, :w] % s_max).long()

    def scatter(buf, vals):
        sel = valid.reshape(valid.shape + (1,) * (buf.ndim - 2))
        buf[bi, pos] = torch.where(sel, vals[:, :w].to(buf.dtype),
                                   buf[bi, pos])

    if "k_scale" in kv_cache:
        kc, ks = _kv_encode(k)
        vc, vs = _kv_encode(v)
        scatter(kv_cache["k"], kc)
        scatter(kv_cache["v"], vc)
        scatter(kv_cache["k_scale"], ks)
        scatter(kv_cache["v_scale"], vs)
        out = quantized_chunk_attention(
            q, kv_cache["k"], kv_cache["k_scale"], kv_cache["v"],
            kv_cache["v_scale"], q_pos=q_pos)
    else:
        scatter(kv_cache["k"], k)
        scatter(kv_cache["v"], v)
        out = chunk_cache_attention(q, kv_cache["k"], kv_cache["v"],
                                    q_pos=q_pos)
    length.add_(n_tokens.to(length.dtype))
    return out, kv_cache


# ---------------------------------------------------------------------------
# Paged KV cache: pool + page-table indirection (``serving.pages`` owns the
# host-side allocator; these are the device-side scatter and gather).
# ---------------------------------------------------------------------------


def _paged_view(pools, table: Tensor) -> list:
    """Gather dense per-slot cache views out of page pools.

    pools: tensors (NP + 1, PS, ...) of one page geometry, the last page
    the scratch page; table: (B, MP) int32 physical page per logical page
    (the sentinel NP for unallocated entries).  The gather clamps to
    [0, NP - 1] as the JAX package's does; what it reads there sits at
    positions >= the slot's length, masked to -1e30 by the attention cores
    like unpaged out-of-range slots (pools start at zero, so nothing read
    is NaN).  Returns one (B, MP * PS, ...) view per pool; the index is
    computed once for all of them."""
    index = torch.clamp(table, 0, pools[0].shape[0] - 2).long()
    b, mp = table.shape
    return [p[index].reshape((b, mp * p.shape[1]) + tuple(p.shape[2:]))
            for p in pools]


def _paged_scatter(pools, table: Tensor, pos: Tensor, vals,
                   valid: Optional[Tensor] = None) -> None:
    """Scatter per-lane values into page pools at global cache positions,
    in place: ``vals[i]`` (B, S, ...) into ``pools[i]`` (NP + 1, PS, ...).

    table: (B, MP); pos: (B, S) global positions.  Lanes routed to a
    sentinel entry, past the table, or with ``valid`` False are DROPPED:
    they write the scratch page NP, which no gather reads, so the scatter
    keeps a fixed shape (a CUDA graph captures it) and no index is out of
    range.  Every other lane owns a distinct (page, offset): a slot writes
    only pages it holds exclusively (copy-on-write), so no two live lanes
    collide.  The lanes are computed once for all pools."""
    np_, ps = pools[0].shape[0] - 1, pools[0].shape[1]
    mp = table.shape[1]
    page_idx = torch.div(pos, ps, rounding_mode="floor")
    page = torch.gather(table, 1, torch.clamp(page_idx, 0, mp - 1).long())
    drop = page_idx >= mp
    if valid is not None:
        drop = drop | ~valid
    lanes = (torch.where(drop, torch.full_like(page, np_),
                         torch.clamp(page, 0, np_)).long(), (pos % ps).long())
    for pool, v in zip(pools, vals):
        pool[lanes] = v.to(pool.dtype)


def paged_append_attend(q: Tensor, k: Tensor, v: Tensor, kv_cache: dict,
                        table: Tensor, *, n_tokens: Optional[Tensor] = None):
    """Decode / chunked-prefill attention against a PAGED cache.

    kv_cache: {"k_pages": (NP + 1, PS, KH, D), "v_pages": ..., "length":
    (B,)} plus ``k_scale_pages``/``v_scale_pages`` (NP + 1, PS, KH) for the
    int8 cache; ``table``: (B, MP) slot -> page map.  New K/V are scattered
    at each slot's next positions (in place), then the pools are gathered
    through the table into dense (B, MP * PS, ...) views feeding the SAME
    attention cores as the unpaged cache; with MP * PS equal to the
    unpaged ``max_len`` a decode tick or chunk computes what the unpaged
    path computes, bit for bit.

    q: (B, S, H, D); S == 1 with ``n_tokens`` None is the decode tick,
    else the chunked-prefill append (tokens 0..n-1 of row b are real).
    Returns (out (B, S, H, D), kv_cache)."""
    b, s = q.shape[:2]
    dev = q.device
    length = kv_cache["length"]
    decode = s == 1 and n_tokens is None
    if decode:
        pos = length[:, None]
        valid = None
        n_add = torch.ones_like(length)
    else:
        n = n_tokens if n_tokens is not None else torch.full(
            (b,), s, dtype=torch.int32, device=dev)
        offs = torch.arange(s, device=dev)[None, :]
        valid = offs < n[:, None]
        pos = length[:, None] + torch.minimum(offs, n[:, None])
        n_add = n.to(length.dtype)
    q_pos = length[:, None] + torch.arange(s, device=dev)[None, :]
    if "k_scale_pages" in kv_cache:
        kc, ks = _kv_encode(k)
        vc, vs = _kv_encode(v)
        names = ("k_pages", "k_scale_pages", "v_pages", "v_scale_pages")
        pools = [kv_cache[n] for n in names]
        _paged_scatter(pools, table, pos, (kc, ks, vc, vs), valid)
        views = _paged_view(pools, table)
        if decode:
            out = quantized_decode_attention(q, *views, lengths=length + 1)
        else:
            out = quantized_chunk_attention(q, *views, q_pos=q_pos)
    else:
        pools = [kv_cache["k_pages"], kv_cache["v_pages"]]
        _paged_scatter(pools, table, pos, (k, v), valid)
        kv, vv = _paged_view(pools, table)
        if decode:
            out = decode_attention(q, kv, vv, lengths=length + 1)
        else:
            out = chunk_cache_attention(q, kv, vv, q_pos=q_pos)
    length.add_(n_add)
    return out, kv_cache


# ---------------------------------------------------------------------------
# The mesh forward's 'model' split (Megatron routes, ``kernels.ops``)
# ---------------------------------------------------------------------------
#
# ``split`` (an ``ops.ModelSplit``) routes each dense call by its weight's
# spec: a COLUMN call's outputs stay split (a list of ``split.size``
# shards), the ops between a column and a row call run per shard
# (``cost_trace.run_sharded``), and a ROW call contracts the shards.  A
# value a call needs whole is gathered (an all-gather); a whole value a
# row call needs split is sliced (each device reads its part).


_NEXT = object()       # split_dense's default: the next counter's seed


def split_dense(nx: Numerics, x, w, split, path: tuple, seed=_NEXT):
    """``nx.dense(x, w)`` on ``w``'s route: a list of column shards'
    outputs (COLUMN), else a whole tensor.  ``x`` is whole or a list of
    shards (gathered first).  ``seed``: the call's seed (None without
    noise), by default the next counter's."""
    if seed is _NEXT:
        seed = nx.next_seeds(1)[0]
    if isinstance(x, list):
        x = ops.gather_columns(x)
    if split is not None and split.dense_route(path, w) == ops.COLUMN:
        return ops.dense_column(x, w, nx.quant, seed, split.size)
    return nx.dense_seeded(x, w, seed)


def split_dense_row(nx: Numerics, x, w, split, path: tuple) -> Tensor:
    """``nx.dense(x, w)`` for a weight whose rows may split: ROW contracts
    ``x``'s shards (a whole ``x`` is sliced), else a whole call on the
    gathered ``x``."""
    seed = nx.next_seeds(1)[0]
    if split is not None and split.dense_route(path, w) == ops.ROW:
        xs = x if isinstance(x, list) else ops.split_columns(x, split.size)
        return ops.dense_row(xs, w, nx.quant, split.size)
    if isinstance(x, list):
        x = ops.gather_columns(x)
    return nx.dense_seeded(x, w, seed)


def split_heads(y, b: int, s: int, n: int, hd: int, tp: int):
    """A projection's output as heads: per shard (B, S, n / tp, hd) when
    its columns split on head boundaries, else whole (B, S, n, hd) (a
    split that cuts a head is gathered, as GSPMD reshards it)."""
    if isinstance(y, list):
        if n % tp == 0:
            return [p.reshape(b, s, n // tp, hd) for p in y]
        y = ops.gather_columns(y)
    return y.reshape(b, s, n, hd)


def _whole_heads(k):
    if not isinstance(k, list):
        return k
    out = torch.cat(k, dim=2)
    cost_trace.record_collective("all-gather", out, len(k))
    return out


def _kv_for_shard(k: Tensor, t: int, h: int, tp: int) -> Tensor:
    """The KV heads (B, S, KH, D) that query shard ``t`` of ``tp`` (heads
    ``t * h / tp ..``) reads: a slice when the shard holds whole GQA
    groups, else one KV head per query head."""
    rep = h // k.shape[2]
    hl = h // tp
    lo = t * hl
    if hl % rep == 0:
        return k[:, :, lo // rep:(lo + hl) // rep]
    idx = torch.arange(lo, lo + hl, device=k.device) // rep
    return k.index_select(2, idx)


def _attention_split(params, x, mcfg, nx: Numerics, split, *, positions,
                     causal: bool, window: int, cross_kv, train_mode: bool):
    """``attention_block`` without a cache on ``split``: q/k/v column
    shards, attention per query-head shard (each shard's KV heads its own
    shard, or read from the gathered K/V when the KV split cuts a head),
    ``wo`` row-parallel over the shards' outputs.  Query heads that do not
    split run whole (replicated)."""
    b, s, _ = x.shape
    h, kh, hd = mcfg.num_heads, mcfg.num_kv_heads, mcfg.resolved_head_dim
    tp = split.size
    block = "attn" if cross_kv is None else "cross"
    q = split_heads(split_dense(nx, x, params["wq"], split, (block, "wq")),
                    b, s, h, hd, tp)
    roped = mcfg.pos_type == "rope" and cross_kv is None
    if cross_kv is None:
        k, v = (split_heads(split_dense(nx, x, params[n], split,
                                        (block, n)), b, s, kh, hd, tp)
                for n in ("wk", "wv"))
    else:
        k, v = cross_kv
        causal, window = False, 0
    if not isinstance(q, list):
        k, v = _whole_heads(k), _whole_heads(v)

    def pos(t):
        return (rope(t, positions, mcfg.rope_theta, mcfg.rope_fraction)
                if roped else t)

    if not isinstance(k, list):
        k = pos(k)

    def core(qt, kt, vt, t=None):
        if t is None:
            kt = pos(kt)
        else:
            kt, vt = _kv_for_shard(kt, t, h, tp), _kv_for_shard(vt, t, h,
                                                                 tp)
        o = _cacheless_attention(pos(qt), kt, vt, mcfg, nx, causal=causal,
                                 window=window, train_mode=train_mode)
        return o.reshape(b, s, -1)

    if isinstance(q, list):
        kv_split = isinstance(k, list)
        out = [cost_trace.run_sharded(
            (ops.MODEL_AXIS,), core, q[t], k[t] if kv_split else k,
            v[t] if kv_split else v, None if kv_split else t)
            for t in range(tp)]
    else:
        out = _cacheless_attention(pos(q), k, v, mcfg, nx, causal=causal,
                                   window=window, train_mode=train_mode
                                   ).reshape(b, s, h * hd)
    return split_dense_row(nx, out, params["wo"], split, (block, "wo"))


def _decode_attention_split(params, x, mcfg, nx: Numerics, split, *,
                            positions, window: int, kv_cache: dict):
    """A decode tick of ``attention_block`` over a float cache on
    ``split``: the q/k/v column shards; per head shard (query and KV heads
    split) each shard writes its KV heads into its slice of the cache and
    attends them; where the KV heads do not split, per head-dim shard (the
    cache's spec splits its head dim, ``distributed.sharding.
    decode_state_spec_tree``): each shard writes its slice of every head,
    the partial scores are summed (an all-reduce), and each shard weighs
    its slice of V (the outputs gathered); ``wo`` row-parallel.  Without
    an even split of either it runs whole."""
    b = x.shape[0]
    h, kh, hd = mcfg.num_heads, mcfg.num_kv_heads, mcfg.resolved_head_dim
    tp = split.size
    q, k, v = (split_dense(nx, x, params[n], split, ("attn", n))
               for n in ("wq", "wk", "wv"))
    by_heads = (all(isinstance(y, list) for y in (q, k, v))
                and h % tp == 0 and kh % tp == 0)
    by_dims = not by_heads and hd % tp == 0
    length = kv_cache["length"]
    s_max = kv_cache["k"].shape[1]
    bidx = torch.arange(b, device=x.device)
    slot = (length % s_max if window > 0 else length).long()
    filled = (torch.clamp(length + 1, max=s_max) if window > 0
              else length + 1)

    def pos(y):
        return (rope(y, positions, mcfg.rope_theta, mcfg.rope_fraction)
                if mcfg.pos_type == "rope" else y)

    def write(kc, vc, kt, vt):
        kc[bidx, slot] = kt[:, 0].to(kc.dtype)
        vc[bidx, slot] = vt[:, 0].to(vc.dtype)

    if by_heads:
        hl, kl = h // tp, kh // tp

        def shard(t, qt, kt, vt):
            qt = pos(qt.reshape(b, 1, hl, hd))
            kt = pos(kt.reshape(b, 1, kl, hd))
            kc = kv_cache["k"][:, :, t * kl:(t + 1) * kl]
            vc = kv_cache["v"][:, :, t * kl:(t + 1) * kl]
            write(kc, vc, kt, vt.reshape(b, 1, kl, hd))
            return decode_attention(qt, kc, vc, lengths=filled).reshape(
                b, 1, hl * hd)

        out = [cost_trace.run_sharded((ops.MODEL_AXIS,), shard, t, q[t],
                                      k[t], v[t]) for t in range(tp)]
    elif by_dims:
        q, k, v = (ops.gather_columns(y) if isinstance(y, list) else y
                   for y in (q, k, v))
        q = pos(q.reshape(b, 1, h, hd))
        k = pos(k.reshape(b, 1, kh, hd))
        v = v.reshape(b, 1, kh, hd)
        dl = hd // tp

        def scores(t, qt, kt, vt):
            sl = slice(t * dl, (t + 1) * dl)
            kc, vc = kv_cache["k"][..., sl], kv_cache["v"][..., sl]
            write(kc, vc, kt[..., sl], vt[..., sl])
            qf = qt[..., sl].float() * (hd ** -0.5)
            return torch.einsum("bshd,bchd->bhsc", qf,
                                _repeat_kv(kc, h).float())[:, :, 0]

        sc = None
        for t in range(tp):
            part = cost_trace.run_sharded((ops.MODEL_AXIS,), scores, t, q,
                                          k, v)
            sc = part if sc is None else sc + part
        cost_trace.record_collective("all-reduce", sc, tp)
        valid = torch.arange(s_max, device=x.device)[None, :] \
            < filled[:, None]
        p = torch.softmax(torch.where(valid[:, None], sc,
                                      torch.full_like(sc, NEG)), dim=-1)

        def weigh(t, p):
            vc = kv_cache["v"][..., t * dl:(t + 1) * dl]
            return torch.einsum("bhc,bchd->bhd", p,
                                _repeat_kv(vc, h).float())

        out = torch.cat([cost_trace.run_sharded((ops.MODEL_AXIS,), weigh, t,
                                                p) for t in range(tp)], -1)
        cost_trace.record_collective("all-gather", out, tp)
        out = out[:, None].to(x.dtype).reshape(b, 1, h * hd)
    else:
        q, k, v = (ops.gather_columns(y) if isinstance(y, list) else y
                   for y in (q, k, v))
        out, _ = _append_attend_one(
            pos(q.reshape(b, 1, h, hd)), pos(k.reshape(b, 1, kh, hd)),
            v.reshape(b, 1, kh, hd), kv_cache, window)
        return split_dense_row(nx, out.reshape(b, 1, h * hd), params["wo"],
                               split, ("attn", "wo"))
    length.add_(1)
    return split_dense_row(nx, out, params["wo"], split, ("attn", "wo"))


# ---------------------------------------------------------------------------
# Attention block (projections through Numerics)
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, mcfg, device) -> dict:
    d, h, kh = mcfg.d_model, mcfg.num_heads, mcfg.num_kv_heads
    hd = mcfg.resolved_head_dim
    std = d ** -0.5

    def init(*shape):
        return (torch.randn(shape, generator=gen, device=device) * std
                ).to(mcfg.param_dtype)

    return {"wq": init(d, h * hd), "wk": init(d, kh * hd),
            "wv": init(d, kh * hd), "wo": init(h * hd, d)}


def _fused_decode_attention_block(params, x, mcfg, nx: Numerics, *,
                                  positions, kv_cache):
    """One fused-kernel decode tick of ``attention_block``: ONE fused QKV
    launch and the int8-KV decode-attention kernel in place of the three
    projection dispatches and the plain attention.

    PRNG contract: the fused launch consumes the same three (key, counter)
    pairs as three ``Numerics.dense`` calls for wq, wk, wv, so wo and every
    later layer see an unchanged stream.

    On a mesh the QKV runs per column shard (``ops.fused_qkv_dense``) and the
    attention kernel stays on: attention is not partitioned here (the JAX
    package swaps in its jnp form under a mesh only because a Pallas call
    does not partition under GSPMD; the two are bit-identical)."""
    b, s, _ = x.shape
    h, kh, hd = mcfg.num_heads, mcfg.num_kv_heads, mcfg.resolved_head_dim
    seeds = nx.next_seeds(3)
    pws = (params["wq"], params["wk"], params["wv"])
    yq, yk, yv = ops.fused_qkv_dense(x, pws, nx.quant, seeds, nx.mesh,
                                     qkv=params.get("qkv"), plain=nx.plain)
    q = yq.reshape(b, s, h, hd)
    k = yk.reshape(b, s, kh, hd)
    v = yv.reshape(b, s, kh, hd)
    if mcfg.pos_type == "rope":
        q = rope(q, positions, mcfg.rope_theta, mcfg.rope_fraction)
        k = rope(k, positions, mcfg.rope_theta, mcfg.rope_fraction)

    length = kv_cache["length"]
    bidx = torch.arange(b, device=x.device)
    slot = length.long()
    kc, ks = _kv_encode(k[:, 0])
    vc, vs = _kv_encode(v[:, 0])
    kv_cache["k"][bidx, slot] = kc
    kv_cache["v"][bidx, slot] = vc
    kv_cache["k_scale"][bidx, slot] = ks
    kv_cache["v_scale"][bidx, slot] = vs
    attend = (quantized_decode_attention if nx.plain
              else fused_quantized_decode_attention)
    out = attend(q, kv_cache["k"], kv_cache["k_scale"], kv_cache["v"],
                 kv_cache["v_scale"], lengths=length + 1)
    length.add_(1)
    return nx.dense(out.reshape(b, s, h * hd), params["wo"]), kv_cache


def _use_fused_decode(params, nx: Numerics, s, kv_cache, n_tokens,
                      window: int = 0) -> bool:
    """Does this call take the fused decode path?  ``abfp_fused`` mode, a
    single-token decode tick, an unpaged, un-windowed int8 KV cache and
    all three projection weights packed; anything else (a paged cache, a
    ring buffer or a cross-attention call, which has no cache, included,
    as in the JAX package) runs the packed chain."""
    return (kv_cache is not None and nx.quant.mode == "abfp_fused"
            and s == 1 and n_tokens is None and window == 0
            and "k_pages" not in kv_cache and "k_scale" in kv_cache
            and all(_packed(params[w]) for w in ("wq", "wk", "wv")))


def _packed(w) -> bool:
    """A packed weight, whole or in column shards."""
    return isinstance(w, PackedWeight) or (
        isinstance(w, ops.ColumnShards) and w.packed)


def _cacheless_attention(q, k, v, mcfg, nx: Numerics, *, causal: bool,
                         window: int, train_mode: bool) -> Tensor:
    """Attention over whole sequences: ``train_attention`` in train mode,
    the flash kernel with ``mcfg.use_flash_attention`` (its plain version
    under ``nx.plain``), else ``chunked_attention``."""
    if train_mode:
        return train_attention(q, k, v, causal=causal, window=window,
                               q_chunk=mcfg.attn_chunk)
    if mcfg.use_flash_attention:
        flash = flash_attention_ref if nx.plain else flash_attention
        return flash(q, k, v, causal=causal, window=window)
    return chunked_attention(q, k, v, causal=causal, window=window,
                             chunk=mcfg.attn_chunk)


def attention_block(params: dict, x: Tensor, mcfg, nx: Numerics, *,
                    positions: Tensor, causal: bool = True, window: int = 0,
                    kv_cache: Optional[dict] = None,
                    n_tokens: Optional[Tensor] = None, cross_kv=None,
                    train_mode: bool = False,
                    page_table: Optional[Tensor] = None, split=None):
    """Self-attention (causal unless ``causal`` is False: the encoder's),
    over a KV cache or over the whole sequence, or cross-attention.
    Returns (output, kv_cache).  ``window`` > 0 is local attention over
    the last ``window`` positions (a ring-buffer cache).

    With a cache and S == 1 and ``n_tokens`` None this is a decode tick;
    with a cache otherwise, x holds a prompt chunk of which ``n_tokens``
    (B,) tokens are real per row (None == all S), appended and attended in
    one pass.  Without a cache (the teacher-forced ``forward``, the
    encoder), each of the S queries attends the keys up to its own
    position (every key when not ``causal``): the flash
    kernel with ``mcfg.use_flash_attention`` (its plain version under
    ``nx.plain``), else ``chunked_attention``; ``train_mode`` (the
    training forward under ``mcfg.remat``) takes ``train_attention``
    instead.  The returned cache is None.

    A PAGED cache ({"k_pages", ...}, see ``serving.pages``) needs
    ``page_table`` (B, MP) and goes through ``paged_append_attend``.

    ``cross_kv`` (k, v), each (B, Skv, KH, D), makes it cross-attention
    (the decoder of an encoder-decoder): q from ``x`` through ``wq``, k
    and v as given, no rope and no cache, every query over all Skv keys
    (non-causal, cacheless), then ``wo``: two dense calls.

    ``split`` (an ``ops.ModelSplit``, the mesh forward's or decode
    step's) runs a cacheless call by the Megatron routes
    (``_attention_split``; ``cross_kv`` may then hold per-shard K/V lists,
    ``models.lm.encode_cross_kv``) and a decode tick over an unpaged float
    cache by ``_decode_attention_split``."""
    if split is not None and kv_cache is None:
        return _attention_split(params, x, mcfg, nx, split,
                                positions=positions, causal=causal,
                                window=window, cross_kv=cross_kv,
                                train_mode=train_mode), None
    if (split is not None and x.shape[1] == 1 and n_tokens is None
            and cross_kv is None and "k" in kv_cache
            and "k_scale" not in kv_cache
            and split.dense_route(("attn", "wq"), params["wq"])
            == ops.COLUMN):
        return _decode_attention_split(
            params, x, mcfg, nx, split, positions=positions, window=window,
            kv_cache=kv_cache), kv_cache
    b, s, _ = x.shape
    h, kh, hd = mcfg.num_heads, mcfg.num_kv_heads, mcfg.resolved_head_dim
    if cross_kv is None and _use_fused_decode(params, nx, s, kv_cache,
                                              n_tokens, window):
        return _fused_decode_attention_block(
            params, x, mcfg, nx, positions=positions, kv_cache=kv_cache)

    q = nx.dense(x, params["wq"]).reshape(b, s, h, hd)
    if cross_kv is not None:
        k, v = cross_kv
        out = _cacheless_attention(q, k, v, mcfg, nx, causal=False,
                                   window=0, train_mode=train_mode)
        return nx.dense(out.reshape(b, s, h * hd), params["wo"]), None
    k = nx.dense(x, params["wk"]).reshape(b, s, kh, hd)
    v = nx.dense(x, params["wv"]).reshape(b, s, kh, hd)
    if mcfg.pos_type == "rope":
        q = rope(q, positions, mcfg.rope_theta, mcfg.rope_fraction)
        k = rope(k, positions, mcfg.rope_theta, mcfg.rope_fraction)
    if kv_cache is None:
        out = _cacheless_attention(q, k, v, mcfg, nx, causal=causal,
                                   window=window, train_mode=train_mode)
    elif "k_pages" in kv_cache:
        if page_table is None:
            raise ValueError("a paged kv_cache needs a page_table")
        out, kv_cache = paged_append_attend(q, k, v, kv_cache, page_table,
                                            n_tokens=n_tokens)
    elif s == 1 and n_tokens is None:
        out, kv_cache = _append_attend_one(q, k, v, kv_cache, window)
    else:
        n = n_tokens if n_tokens is not None else torch.full(
            (b,), s, dtype=torch.int32, device=x.device)
        out, kv_cache = chunk_append_attend(q, k, v, kv_cache, n_tokens=n,
                                            window=window)
    return nx.dense(out.reshape(b, s, h * hd), params["wo"]), kv_cache


# ---------------------------------------------------------------------------
# MLP (swiglu / geglu / gelu)
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, mcfg, device) -> dict:
    d, f = mcfg.d_model, mcfg.d_ff

    def init(std, *shape):
        return (torch.randn(shape, generator=gen, device=device) * std
                ).to(mcfg.param_dtype)

    p = {"wi": init(d ** -0.5, d, f), "wo": init(f ** -0.5, f, d)}
    if mcfg.mlp_type in ("swiglu", "geglu"):
        p["wg"] = init(d ** -0.5, d, f)
    return p


def _mlp_act(mcfg, h: Tensor, g: Optional[Tensor] = None) -> Tensor:
    if mcfg.mlp_type == "swiglu":
        return F.silu(g.float()).to(h.dtype) * h
    if mcfg.mlp_type == "geglu":
        return F.gelu(g.float(), approximate="tanh").to(h.dtype) * h
    return F.gelu(h.float(), approximate="tanh").to(h.dtype)


def mlp_block(params: dict, x: Tensor, mcfg, nx: Numerics,
              split=None) -> Tensor:
    """The MLP: ``wi`` (and ``wg``), the activation, ``wo``.  On ``split``
    (the mesh forward's) ``wi`` / ``wg`` run column-parallel, the
    activation per shard and ``wo`` row-parallel, by their specs."""
    path = ("mlp",)
    h = split_dense(nx, x, params["wi"], split, path + ("wi",))
    g = (split_dense(nx, x, params["wg"], split, path + ("wg",))
         if mcfg.mlp_type in ("swiglu", "geglu") else None)
    if isinstance(h, list) and (g is None or isinstance(g, list)):
        h = [cost_trace.run_sharded((ops.MODEL_AXIS,),
                                    functools.partial(_mlp_act, mcfg), h[t],
                                    None if g is None else g[t])
             for t in range(len(h))]
    else:
        if isinstance(h, list):
            h = ops.gather_columns(h)
        if isinstance(g, list):
            g = ops.gather_columns(g)
        h = _mlp_act(mcfg, h, g)
    return split_dense_row(nx, h, params["wo"], split, path + ("wo",))


# ---------------------------------------------------------------------------
# im2col (how the paper maps convolutions onto tiled matmuls, Sec. V)
# ---------------------------------------------------------------------------


def im2col(x: Tensor, kh: int, kw: int, stride: int = 1) -> Tensor:
    """(B, H, W, C) -> (B, H', W', kh*kw*C) patches, so a convolution
    becomes a matmul that ABFP can tile: the paper's treatment of
    ResNet50's convolutions.  Patch features run over (kernel row, kernel
    column, channel), as the JAX package's ``im2col`` orders them."""
    b, hh, ww, c = x.shape
    oh = (hh - kh) // stride + 1
    ow = (ww - kw) // stride + 1
    idx_h = (torch.arange(oh, device=x.device) * stride)[:, None] \
        + torch.arange(kh, device=x.device)[None, :]
    idx_w = (torch.arange(ow, device=x.device) * stride)[:, None] \
        + torch.arange(kw, device=x.device)[None, :]
    patches = x[:, idx_h[:, None, :, None], idx_w[None, :, None, :], :]
    return patches.reshape(b, oh, ow, kh * kw * c)
