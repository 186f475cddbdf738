"""Recurrent temporal-mixing blocks: RG-LRU (Griffin / recurrentgemma),
mLSTM and sLSTM (xLSTM).

Projections run through ``Numerics.dense`` (so ABFP applies to them), in
the JAX package's call order, since a call's noise seed is
``fold_in(layer key, counter)``: RG-LRU ``w_gate, w_in, w_rg, w_ig,
w_out``; mLSTM ``w_up, w_gate, wq, wk, wv, w_if, w_down``; sLSTM ``w_x,
w_up, w_down``.  The recurrences stay in digital float32.

Two paths, as in the JAX package:

  * **serving** (a decode state and one token per row, or ``n_tokens``:
    a prompt chunk of which the first n_tokens[b] positions are real):
    the decode step or the chunked-prefill fold, sequential per token, so
    a chunk leaves the state a token-by-token run leaves.  The state is
    UPDATED IN PLACE (a replayed CUDA graph reads fixed storage): every
    block computes the new state as the JAX package does, masked per step
    with ``torch.where`` so padding positions and idle rows (n_tokens 0)
    keep their values bit for bit, and ``copy_``s it into the state's
    tensors;
  * **the parallel forms** (no state, or a state with S > 1 and no
    ``n_tokens``: the cacheless ``forward``, evaluation and training):
    RG-LRU's associative scan (``associative_scan``, the JAX package's
    odd/even recursion and so its association order), the chunkwise
    mLSTM at ``chunk = min(128, S)``, the sLSTM fold over all S
    positions, each from the JAX package's initial state when none is
    given.  They build fresh tensors and return a fresh state: autograd
    never sees an in-place write.

Function forms follow the JAX package's where PyTorch has a choice:
softplus is ``logaddexp(x, 0)``, log-sigmoid ``-softplus(-x)`` and SiLU
``x * sigmoid(x)``.

On a mesh (``split``, the mesh forward's ``ops.ModelSplit``; the parallel
forms without a state) each block runs by the JAX package's rules: the
wide projections column-parallel (their channels or heads stay split),
the recurrence per channel shard (RG-LRU: ``lam`` and ``conv_w`` split
with their channels) or per head shard (mLSTM, sLSTM: ``w_if`` and
``r_h`` replicated, each shard reads its heads), ``w_out`` / ``w_down``
row-parallel.  An input that column calls need whole is gathered once
(an all-gather).  The mesh route returns no state: the cacheless forward
discards it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import cost_trace
from repro_torch.kernels import ops
from repro_torch.models.layers import Numerics, split_dense, split_dense_row

Tensor = torch.Tensor

_RGLRU_C = 8.0


def _softplus(x: Tensor) -> Tensor:
    return torch.logaddexp(x, x.new_zeros(()))


def _log_sigmoid(x: Tensor) -> Tensor:
    return -_softplus(-x)


def _silu(x: Tensor) -> Tensor:
    return x * torch.sigmoid(x)


def _normal(gen, device, dtype, std, *shape) -> Tensor:
    return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)


def associative_scan(fn, elems: list, dim: int = 1) -> list:
    """Inclusive scan of the associative ``fn`` over ``dim`` of every
    tensor of ``elems`` (``fn(a_list, b_list) -> list``, ``a`` before
    ``b``), by the odd/even recursion of ``jax.lax.associative_scan``:
    combine adjacent pairs, scan the half-length result (the odd
    outputs), combine each odd output with the next even input (the even
    outputs), interleave.  About 2 log2 S rounds of whole-tensor ops, and
    JAX's association order."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def sl(t, start, stop=None, step=1):
        idx = [slice(None)] * t.ndim
        idx[dim] = slice(start, stop, step)
        return t[tuple(idx)]

    reduced = fn([sl(e, 0, n - 1, 2) for e in elems],
                 [sl(e, 1, None, 2) for e in elems])
    odd = associative_scan(fn, reduced, dim)
    if n % 2 == 0:
        even = fn([sl(e, 0, -1) for e in odd], [sl(e, 2, None, 2)
                                                for e in elems])
    else:
        even = fn(odd, [sl(e, 2, None, 2) for e in elems])
    even = [torch.cat([sl(e, 0, 1), r], dim=dim)
            for e, r in zip(elems, even)]
    out = []
    for e, o in zip(even, odd):
        m = o.shape[dim]
        pairs = torch.stack([sl(e, 0, m), o], dim=dim + 1).flatten(dim,
                                                                 dim + 1)
        out.append(torch.cat([pairs, sl(e, m)], dim=dim) if n % 2 else pairs)
    return out


def _linear_recurrence(a: Tensor, b: Tensor) -> Tensor:
    """h_t = a_t h_{t-1} + b_t over dim 1 from h_{-1} = 0, by the
    associative scan with the JAX package's operator ``(a1 a2, a2 b1 +
    b2)``; returns h (every t)."""
    def op(c1, c2):
        (a1, b1), (a2, b2) = c1, c2
        return [a1 * a2, a2 * b1 + b2]

    return associative_scan(op, [a, b], dim=1)[1]


# ---------------------------------------------------------------------------
# RG-LRU recurrent block (Griffin)
# ---------------------------------------------------------------------------


def init_rglru_block(gen: torch.Generator, mcfg, device) -> dict:
    """The JAX package's RG-LRU leaves, shapes, dtypes and standard
    deviations; lambda drawn so a = sigmoid(lam)^c is in about [0.9,
    0.999] (Griffin A.2)."""
    d = mcfg.d_model
    r = mcfg.lru_width or d
    dt = mcfg.param_dtype

    def init(fan_in, *shape):
        return _normal(gen, device, dt, fan_in ** -0.5, *shape)

    w_in, w_gate = init(d, d, r), init(d, d, r)
    conv_w = _normal(gen, device, dt, mcfg.conv_width ** -0.5,
                     mcfg.conv_width, r)
    w_rg, w_ig, w_out = init(r, r, r), init(r, r, r), init(r, r, d)
    lo, hi = 0.9 ** 2, 0.999 ** 2
    u = torch.rand(r, generator=gen, device=device) * (hi - lo) + lo
    root = u ** (1.0 / _RGLRU_C)
    lam = torch.log(root / (1 - root))
    return {"w_in": w_in, "w_gate": w_gate, "conv_w": conv_w, "w_rg": w_rg,
            "w_ig": w_ig, "w_out": w_out, "lam": lam.float()}


def _causal_depthwise_conv(u: Tensor, w: Tensor, state: Optional[Tensor],
                           n_tokens: Optional[Tensor] = None):
    """u: (B, S, R), w: (W, R) depthwise causal conv.  ``state``: the last
    W-1 inputs of the previous call.  Returns (out, new_state).

    The W products are summed in u's dtype from Python ``0``, in order, as
    the JAX package sums them.  ``n_tokens``: only the first n_tokens[b]
    positions are real, so the carried tail is the last W-1 inputs of the
    valid prefix (a per-row gather); a row with n == 0 keeps its state."""
    width = w.shape[0]
    b, s, r = u.shape
    if state is None:
        state = torch.zeros((b, width - 1, r), dtype=u.dtype, device=u.device)
    ext = torch.cat([state, u], dim=1)                        # (B, W-1+S, R)
    out = sum(ext[:, i:i + s] * w[i][None, None] for i in range(width))
    if width == 1:
        new_state = state
    elif n_tokens is None:
        new_state = ext[:, -(width - 1):]
    else:
        idx = (n_tokens.long()[:, None]
               + torch.arange(width - 1, device=u.device)[None, :])
        new_state = torch.gather(ext, 1, idx[:, :, None].expand(-1, -1, r))
    return out, new_state


def _shards(tp: int, fn, *parts):
    """``fn(t, *parts[i][t])`` for each model shard ``t`` of ``tp``, each
    one shard of 'model' (``cost_trace.run_sharded``); a whole (non-list)
    entry of ``parts`` goes whole to every shard."""
    return [cost_trace.run_sharded(
        (ops.MODEL_AXIS,), fn, t,
        *(p[t] if isinstance(p, list) else p for p in parts))
        for t in range(tp)]


def _splits(split, path: tuple, w) -> bool:
    return (split is not None
            and split.dense_route(path, w) == ops.COLUMN)


def _rglru_split(params, x, mcfg, nx, split, state=None):
    """The RG-LRU parallel form on ``split`` (module docstring), or with
    ``state`` a decode step whose channel shards update their slices of
    the state in place."""
    path = ("rglru",)
    tp = split.size
    gate = split_dense(nx, x, params["w_gate"], split, path + ("w_gate",))
    u = split_dense(nx, x, params["w_in"], split, path + ("w_in",))
    c = u[0].shape[-1]

    def conv(t, ut, w):
        sl = slice(t * c, (t + 1) * c)
        out, tail = _causal_depthwise_conv(
            ut, w[:, sl], None if state is None else state["conv"][..., sl])
        if state is not None:
            state["conv"][..., sl].copy_(tail)
        return out

    u = _shards(tp, conv, u, params["conv_w"])
    uw = ops.gather_columns(u)
    rg = split_dense(nx, uw, params["w_rg"], split, path + ("w_rg",))
    ig = split_dense(nx, uw, params["w_ig"], split, path + ("w_ig",))

    def shard(t, ut, gt, rgt, igt, lam):
        sl = slice(t * c, (t + 1) * c)
        g = F.gelu(gt.float(), approximate="tanh")
        r = torch.sigmoid(rgt.float())
        i = torch.sigmoid(igt.float())
        log_a = -_RGLRU_C * _softplus(lam[sl]) * r
        a = torch.exp(log_a)
        b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                   min=1e-12)) * (i * ut.float())
        if state is None:
            hs = _linear_recurrence(a, b)
        else:
            hs = (a[:, 0] * state["h"][:, sl] + b[:, 0])[:, None]
            state["h"][:, sl].copy_(hs[:, 0])
        return (hs * g).to(x.dtype)

    hs = _shards(tp, shard, u, gate, rg, ig, params["lam"])
    return split_dense_row(nx, hs, params["w_out"], split, path + ("w_out",))


def rglru_block(params: dict, x: Tensor, mcfg, nx: Numerics,
                state: Optional[dict] = None,
                n_tokens: Optional[Tensor] = None, split=None):
    """Griffin recurrent block.  Returns (y, state).

    Serving: the decode step (a state, S == 1) or, with ``n_tokens`` (B,),
    the chunked-prefill fold, one ``where(ok, a_t * h + b_t, h)`` per
    position; ``state`` ({"conv", "h"}) is updated in place.  Otherwise
    the associative scan over all S positions (a given state's h folded
    into position 0, as ``b.at[:, 0].add(a[:, 0] * h0)``), and the state
    returned is new.  ``split``: the mesh route (module docstring), taken
    without a state or for a decode step when the channels split."""
    if (n_tokens is None and (state is None or x.shape[1] == 1)
            and _splits(split, ("rglru", "w_in"), params["w_in"])):
        return _rglru_split(params, x, mcfg, nx, split, state), state
    serving = n_tokens is not None or (state is not None and x.shape[1] == 1)
    if n_tokens is not None and state is None:
        raise ValueError("chunked prefill needs a carried state")
    gate = F.gelu(nx.dense(x, params["w_gate"]).float(),
                  approximate="tanh")
    u = nx.dense(x, params["w_in"])
    u, new_conv = _causal_depthwise_conv(
        u, params["conv_w"], None if state is None else state["conv"],
        n_tokens=n_tokens)

    uf = u.float()
    r = torch.sigmoid(nx.dense(u, params["w_rg"]).float())
    i = torch.sigmoid(nx.dense(u, params["w_ig"]).float())
    log_a = -_RGLRU_C * _softplus(params["lam"]) * r           # (B, S, R)
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * uf)

    if not serving:
        if state is not None:
            b = torch.cat([b[:, :1] + a[:, :1] * state["h"][:, None],
                           b[:, 1:]], dim=1)
        hs = _linear_recurrence(a, b)
        y = nx.dense((hs * gate).to(x.dtype), params["w_out"])
        return y, {"conv": new_conv, "h": hs[:, -1]}

    h = state["h"]
    if n_tokens is None:
        h = a[:, 0] * h + b[:, 0]                              # decode step
        hs = h[:, None]
    else:
        valid = (torch.arange(x.shape[1], device=x.device)[None, :]
                 < n_tokens[:, None])                          # (B, S)
        steps = []
        for t in range(x.shape[1]):
            h = torch.where(valid[:, t, None], a[:, t] * h + b[:, t], h)
            steps.append(h)
        hs = torch.stack(steps, dim=1)
    state["conv"].copy_(new_conv)
    state["h"].copy_(h)
    y = nx.dense((hs * gate).to(x.dtype), params["w_out"])
    return y, state


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM): stabilized linear attention with exponential gates
# ---------------------------------------------------------------------------


def init_mlstm_block(gen: torch.Generator, mcfg, device) -> dict:
    d = mcfg.d_model
    inner = 2 * d                                   # xLSTM pf=2 up-projection
    nh = mcfg.num_heads
    dt = mcfg.param_dtype

    def init(fan, *shape):
        return _normal(gen, device, dt, fan ** -0.5, *shape)

    return {
        "w_up": init(d, d, inner),
        "w_gate": init(d, d, inner),
        "wq": init(inner, inner, inner),
        "wk": init(inner, inner, inner),
        "wv": init(inner, inner, inner),
        "w_if": init(inner, inner, 2 * nh),         # input+forget gate logits
        "w_down": init(inner, inner, d),
        "skip_scale": torch.zeros(inner, device=device),
    }


def _mlstm_chunk_scan(q, k, v, log_i, log_f, state, chunk: int, valid=None,
                      final_state: bool = True):
    """Chunkwise stabilized mLSTM.  q, k, v: (B, NH, S, D) f32; gates (B,
    NH, S).  state: (C (B, NH, D, D), n (B, NH, D), m (B, NH)).  Returns
    (h (B, NH, S, D), new_state), the new state as new tensors; without
    ``final_state`` the update after the last chunk is skipped (new_state
    is then the state before it: a caller that discards it).

    ``valid`` (B, S) bool needs chunk == 1 (each step one token): steps
    with valid False leave the carried state unchanged."""
    b, nh, s, dh = q.shape
    if valid is not None and chunk != 1:
        raise ValueError("a valid mask needs chunk == 1")
    pad = (-s) % chunk
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        log_i = F.pad(log_i, (0, pad), value=-1e30)
        log_f = F.pad(log_f, (0, pad))
    nc = (s + pad) // chunk
    scale = dh ** -0.5
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=q.device))
    cmat, n, m = state
    hs = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        qc, kc, vc = q[:, :, sl], k[:, :, sl], v[:, :, sl]
        li, lf = log_i[..., sl], log_f[..., sl]
        csum = torch.cumsum(lf, dim=-1)                       # (B, NH, c)
        total = csum[..., -1]
        # Decay from chunk start to position t (inclusive of f_t).
        m_inter = csum + m[..., None]
        # Intra-chunk log weights: A[t, s] = csum[t] - csum[s] + li[s].
        a_log = csum[..., :, None] - csum[..., None, :] + li[..., None, :]
        a_log = torch.where(tri[None, None], a_log,
                            torch.full_like(a_log, -1e30))
        m_intra = a_log.amax(dim=-1)                          # (B, NH, c)
        m_new = torch.maximum(m_inter, m_intra)
        a = torch.exp(a_log - m_new[..., None])               # (B, NH, c, c)
        inter_w = torch.exp(m_inter - m_new)                  # (B, NH, c)
        h_inter = torch.einsum("bhcd,bhde->bhce", qc, cmat) \
            * inter_w[..., None]
        n_inter = torch.einsum("bhcd,bhd->bhc", qc, n) * inter_w
        scores = torch.einsum("bhcd,bhsd->bhcs", qc, kc) * scale
        h_intra = torch.einsum("bhcs,bhse->bhce", scores * a, vc)
        n_intra = (scores * a).sum(dim=-1)
        denom = torch.maximum(torch.abs(n_inter + n_intra),
                              torch.exp(-m_new)) + 1e-6
        hs.append((h_inter + h_intra) / denom[..., None])
        if c == nc - 1 and not final_state:
            break
        # State update to the end of the chunk (stabilized by m_end).
        m_end = torch.maximum(total + m,
                              (csum[..., -1:] - csum + li).amax(dim=-1))
        decay = torch.exp(total + m - m_end)                  # (B, NH)
        k_w = torch.exp(total[..., None] - csum + li - m_end[..., None])
        ks = kc * scale
        cmat_new = cmat * decay[..., None, None] + torch.einsum(
            "bhsd,bhse->bhde", k_w[..., None] * ks, vc)
        n_new = n * decay[..., None] + torch.einsum("bhs,bhsd->bhd", k_w, ks)
        if valid is None:
            cmat, n, m = cmat_new, n_new, m_end
        else:
            ok = valid[:, c]
            cmat = torch.where(ok[:, None, None, None], cmat_new, cmat)
            n = torch.where(ok[:, None, None], n_new, n)
            m = torch.where(ok[:, None], m_end, m)
    h = torch.cat(hs, dim=2)[:, :, :s]
    return h, (cmat, n, m)


def _mlstm_split(params, x, mcfg, nx, split, chunk: int, state=None):
    """The mLSTM parallel form on ``split`` (module docstring): the scan
    per head shard from the zero state; with ``state`` a decode step whose
    head shards update their heads of the state in place."""
    b, s, _ = x.shape
    path = ("mlstm",)
    tp, nh = split.size, mcfg.num_heads
    up = split_dense(nx, x, params["w_up"], split, path + ("w_up",))
    gate = split_dense(nx, x, params["w_gate"], split, path + ("w_gate",))
    upw = ops.gather_columns(up)
    inner = upw.shape[-1]
    dh, hl, c = inner // nh, nh // tp, inner // tp
    q, k, v = (split_dense(nx, upw, params[n], split, path + (n,))
               for n in ("wq", "wk", "wv"))
    # GSPMD contracts the replicated w_if over up's shards (partial sums,
    # an all-reduce) rather than gathering up: float only (ABFP tiles do
    # not straddle shards).
    if nx.quant.mode == "float" and params["w_if"].shape[0] % tp == 0:
        nx.next_seeds(1)
        gl = ops.dense_row(up, params["w_if"], nx.quant, tp)
    else:
        gl = split_dense(nx, upw, params["w_if"], split, path + ("w_if",))
    gl = gl.float()
    log_i = gl[..., :nh].transpose(1, 2)                      # (B, NH, S)
    if state is None:
        log_f = _log_sigmoid(gl[..., nh:]).transpose(1, 2)
    else:                                       # the serving form's shape
        log_f = _log_sigmoid(gl[:, 0, nh:].contiguous())[..., None]

    def shard(t, qt, kt, vt, upt, gt, li, lf, skip):
        def heads(y):
            return y.reshape(b, s, hl, dh).transpose(1, 2).float()

        z = qt.new_zeros
        hh = slice(t * hl, (t + 1) * hl)
        if state is None:
            start = (z((b, hl, dh, dh), dtype=torch.float32),
                     z((b, hl, dh), dtype=torch.float32),
                     z((b, hl), dtype=torch.float32))
        else:
            start = tuple(state[n][:, hh] for n in ("C", "n", "m"))
        h, new = _mlstm_chunk_scan(
            heads(qt), heads(kt), heads(vt), li[:, hh], lf[:, hh], start,
            1 if state is not None else min(chunk, max(s, 1)),
            final_state=state is not None)
        if state is not None:
            for n_, v_ in zip(("C", "n", "m"), new):
                state[n_][:, hh].copy_(v_)
        h = h.transpose(1, 2).reshape(b, s, c)
        h = h + skip[t * c:(t + 1) * c][None, None].float() * upt.float()
        return (h * _silu(gt.float())).to(x.dtype)

    hs = _shards(tp, shard, q, k, v, up, gate, log_i, log_f,
                 params["skip_scale"])
    return split_dense_row(nx, hs, params["w_down"], split,
                           path + ("w_down",))


def mlstm_block(params: dict, x: Tensor, mcfg, nx: Numerics,
                state: Optional[dict] = None, chunk: int = 128,
                n_tokens: Optional[Tensor] = None, split=None):
    """xLSTM mLSTM block.  Returns (y, state).

    Serving runs the scan at chunk 1: the decode step (a state, S == 1)
    or, with ``n_tokens``, the chunked prefill with its padding masked;
    ``state`` ({"C", "n", "m"}) is updated in place.  Otherwise the
    chunkwise scan at ``min(chunk, S)`` from the given state or the JAX
    package's zero state, and the state returned is new.  ``split``: the
    mesh route (module docstring), taken without a state or for a decode
    step when the heads split."""
    b, s, _ = x.shape
    if (n_tokens is None and (state is None or s == 1)
            and _splits(split, ("mlstm", "wq"), params["wq"])
            and _splits(split, ("mlstm", "w_up"), params["w_up"])
            and mcfg.num_heads % split.size == 0):
        return _mlstm_split(params, x, mcfg, nx, split, chunk,
                            state), state
    serving = n_tokens is not None or (state is not None and s == 1)
    nh = mcfg.num_heads
    up = nx.dense(x, params["w_up"])
    gate = _silu(nx.dense(x, params["w_gate"]).float())
    inner = up.shape[-1]
    dh = inner // nh

    def heads(t):
        return t.reshape(b, s, nh, dh).transpose(1, 2).float()

    q = heads(nx.dense(up, params["wq"]))
    k = heads(nx.dense(up, params["wk"]))
    v = heads(nx.dense(up, params["wv"]))
    gl = nx.dense(up, params["w_if"]).float()                 # (B, S, 2NH)
    log_i = gl[..., :nh].transpose(1, 2)                      # (B, NH, S)
    if serving:
        if state is None:
            raise ValueError("chunked prefill needs a carried state")
        valid = (None if n_tokens is None else
                 torch.arange(s, device=x.device)[None, :]
                 < n_tokens[:, None])
        # One token at a time, so a chunk's forget gates see the decode
        # step's shapes: the CPU's elementwise kernels compute a vector's
        # tail elements by another routine, and a chunk must leave the
        # state a token-by-token run leaves.
        log_f = torch.stack([_log_sigmoid(gl[:, t, nh:].contiguous())
                             for t in range(s)], dim=-1)      # (B, NH, S)
        h, new = _mlstm_chunk_scan(q, k, v, log_i, log_f,
                                   (state["C"], state["n"], state["m"]), 1,
                                   valid)
        for name, t in zip(("C", "n", "m"), new):
            state[name].copy_(t)
        out_state = state
    else:
        log_f = _log_sigmoid(gl[..., nh:]).transpose(1, 2)
        if state is None:
            z = q.new_zeros
            start = (z((b, nh, dh, dh)), z((b, nh, dh)), z((b, nh)))
        else:
            start = (state["C"], state["n"], state["m"])
        h, new = _mlstm_chunk_scan(q, k, v, log_i, log_f, start,
                                   min(chunk, max(s, 1)))
        out_state = dict(zip(("C", "n", "m"), new))
    h = h.transpose(1, 2).reshape(b, s, inner)
    h = h + params["skip_scale"][None, None].float() * up.float()
    y = nx.dense((h * gate).to(x.dtype), params["w_down"])
    return y, out_state


# ---------------------------------------------------------------------------
# sLSTM block (xLSTM): sequential scalar-memory recurrence
# ---------------------------------------------------------------------------


def init_slstm_block(gen: torch.Generator, mcfg, device) -> dict:
    d = mcfg.d_model
    nh = mcfg.num_heads
    dh = d // nh
    dt = mcfg.param_dtype
    return {
        "w_x": _normal(gen, device, dt, d ** -0.5, d, 4 * d),
        "r_h": _normal(gen, device, dt, dh ** -0.5, nh, dh, 4 * dh),
        "b": torch.zeros(4 * d, device=device),
        "w_up": _normal(gen, device, dt, d ** -0.5, d, 2 * d),
        "w_down": _normal(gen, device, dt, d ** -0.5, d, d),
    }


def slstm_block(params: dict, x: Tensor, mcfg, nx: Numerics,
                state: Optional[dict] = None,
                n_tokens: Optional[Tensor] = None, split=None):
    """xLSTM sLSTM block with exponential input gate and stabilizer state,
    sequential over time.  Returns (y, state).  With a state (serving)
    ``state`` ({"h", "c", "n", "m"}) is updated in place, positions at or
    past n_tokens[b] leaving row b's state unchanged; without one the fold
    starts from the JAX package's h = c = n = 0, m = -1e30 and the state
    returned is new.  ``split``: the mesh route (module docstring), taken
    without a state or for a decode step when the heads split."""
    b, s, d = x.shape
    nh = mcfg.num_heads
    dh = d // nh
    if (n_tokens is None and (state is None or s == 1)
            and _splits(split, ("slstm", "w_x"), params["w_x"])
            and nh % split.size == 0):
        return _slstm_split(params, x, mcfg, nx, split, state), state
    gx = nx.dense(x, params["w_x"]).float() + params["b"][None, None]
    r_h = params["r_h"].float()                               # (NH, dh, 4dh)
    valid = (None if n_tokens is None else
             torch.arange(s, device=x.device)[None, :] < n_tokens[:, None])
    if state is None and n_tokens is not None:
        raise ValueError("chunked prefill needs a carried state")
    hs, (h, c, n, m) = _slstm_fold(gx, r_h, state, valid)
    if state is None:
        state = {"h": h, "c": c, "n": n, "m": m}
    else:
        for name, t in zip(("h", "c", "n", "m"), (h, c, n, m)):
            state[name].copy_(t)
    hs = hs.reshape(b, s, d).to(x.dtype)
    up = nx.dense(hs, params["w_up"])
    u1, u2 = torch.split(up, d, dim=-1)
    y = nx.dense(F.gelu(u1.float(), approximate="tanh").to(x.dtype) * u2,
                 params["w_down"])
    return y, state


def _slstm_fold(gx: Tensor, r_h: Tensor, state: Optional[dict], valid):
    """The sLSTM recurrence over gx (B, S, NH * 4dh) f32 with r_h (NH, dh,
    4dh) f32, from ``state``'s h, c, n, m (B, NH, dh) or the JAX package's
    zero state (m = -1e30).  Returns (hs (B, S, NH, dh), (h, c, n, m))."""
    b, s = gx.shape[:2]
    nh, dh = r_h.shape[0], r_h.shape[1]
    if state is None:
        zeros = torch.zeros((b, nh, dh), device=gx.device)
        h, c, n, m = zeros, zeros, zeros, torch.full_like(zeros, -1e30)
    else:
        h, c, n, m = (state[k] for k in ("h", "c", "n", "m"))
    hs = []
    for t in range(s):
        rec = torch.einsum("bhd,hde->bhe", h, r_h)            # (B, NH, 4dh)
        g = gx[:, t].reshape(b, nh, 4 * dh) + rec
        gi, gf, gz, go = torch.split(g, dh, dim=-1)
        log_f = _log_sigmoid(gf)
        m_new = torch.maximum(log_f + m, gi)                  # stabilizer
        i = torch.exp(gi - m_new)
        f = torch.exp(log_f + m - m_new)
        z = torch.tanh(gz)
        o = torch.sigmoid(go)
        c_new = f * c + i * z
        n_new = f * n + i
        h_new = o * c_new / torch.clamp(n_new, min=1.0)
        hs.append(h_new)
        if valid is None:
            h, c, n, m = h_new, c_new, n_new, m_new
        else:
            ok = valid[:, t, None, None]
            h, c, n, m = (torch.where(ok, new, old) for new, old in
                          ((h_new, h), (c_new, c), (n_new, n), (m_new, m)))
    return torch.stack(hs, dim=1), (h, c, n, m)


def _slstm_split(params, x, mcfg, nx, split, state=None):
    """The sLSTM parallel form on ``split`` (module docstring): the fold
    per head shard (with ``state`` a decode step updating its heads of the
    state in place); ``w_up``'s two halves meet in the GELU product, so
    its output is gathered and ``w_down`` contracts the product's
    slices."""
    b, s, d = x.shape
    path = ("slstm",)
    tp, nh = split.size, mcfg.num_heads
    hl, c = nh // tp, 4 * d // tp
    gx = split_dense(nx, x, params["w_x"], split, path + ("w_x",))

    def shard(t, gxt, bias, r_h):
        hh = slice(t * hl, (t + 1) * hl)
        g = gxt.float() + bias[t * c:(t + 1) * c][None, None]
        own = (None if state is None
               else {n: state[n][:, hh] for n in ("h", "c", "n", "m")})
        hs, new = _slstm_fold(g, r_h[hh].float(), own, None)
        if state is not None:
            for n, v in zip(("h", "c", "n", "m"), new):
                own[n].copy_(v)
        return hs.reshape(b, s, d // tp).to(x.dtype)

    hs = _shards(tp, shard, gx, params["b"], params["r_h"])
    up = split_dense(nx, hs, params["w_up"], split, path + ("w_up",))
    u1, u2 = torch.split(up if not isinstance(up, list)
                         else ops.gather_columns(up), d, dim=-1)
    act = F.gelu(u1.float(), approximate="tanh").to(x.dtype) * u2
    return split_dense_row(nx, act, params["w_down"], split,
                           path + ("w_down",))
