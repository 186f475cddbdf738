"""Forward flash attention: the CUDA kernel's wrapper and its plain version.

``flash_attention(q, k, v, causal=True, window=0)``: q (B, Sq, H, D), k and
v (B, Skv, KH, D) with H % KH == 0 (GQA through the KV-head index, no
repeated K/V), out (B, Sq, H, D) in q's dtype.  Scores ``(q * D^-0.5) . k``
and the online softmax run in f32; masked scores are -1e30 (key padding,
causal ``kpos <= qpos``, window ``kpos > qpos - window``; positions count
from 0 in both q and k); the denominator is guarded at 1e-30.

Replaces the TPU kernel ``flash_attention`` (``repro/kernels/
flash_attention.py``).  ``flash_attention_ref`` is the plain version: the
TPU kernel's block-wise online softmax over ``bq`` x ``bk`` blocks, in its
order, skipping the KV blocks it skips.  On a CPU tensor the wrapper runs
it; on a CUDA tensor it launches ``csrc/flash_attention.cu`` (see its
header for what bounds it and its design) or raises: bf16 inputs run on
the bf16 tensor cores (the scaled query and the softmax weights split into
bf16 hi + lo parts where one bf16 would round), f32 inputs on the f32 FMA
kernel.  ``flash_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.core.abfp import ceil_to
from repro_torch.kernels import _build

Tensor = torch.Tensor

DEFAULT_BQ = 512
DEFAULT_BK = 512
NEG = -1e30
HEAD_DIMS = (32, 64, 96, 128, 256)


def _check(q: Tensor, k: Tensor, v: Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B, Sq, H, D) and k, v (B, Skv, KH, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")


def flash_attention_ref(q: Tensor, k: Tensor, v: Tensor, *,
                        causal: bool = True, window: int = 0,
                        bq: int = DEFAULT_BQ, bk: int = DEFAULT_BK) -> Tensor:
    """Plain version of the flash kernel, block for block.

    For each KV block in order, every live (query block, KV block) pair
    updates the running max, denominator and accumulator of its query rows
    exactly as ``_flash_kernel`` does; pairs the TPU kernel skips (wholly
    in the causal future or before the window) leave them untouched."""
    _check(q, k, v)
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    rep = h // kh
    bq = min(bq, ceil_to(sq, 128))
    bk = min(bk, ceil_to(skv, 128))
    sqp, skvp = ceil_to(sq, bq), ceil_to(skv, bk)
    dev = q.device

    qt = q.float().permute(0, 2, 1, 3).reshape(b * h, sq, d) * (d ** -0.5)
    qt = torch.nn.functional.pad(qt, (0, 0, 0, sqp - sq))
    kv_idx = (torch.arange(b * h, device=dev) // h) * kh \
        + (torch.arange(b * h, device=dev) % h) // rep

    def heads(t):
        t = t.float().permute(0, 2, 1, 3).reshape(b * kh, skv, d)
        return torch.nn.functional.pad(t, (0, 0, 0, skvp - skv))[kv_idx]

    kt, vt = heads(k), heads(v)
    qpos = torch.arange(sqp, device=dev)
    q_start = (qpos // bq) * bq                                 # (Sqp,)
    m = torch.full((b * h, sqp), NEG, dtype=torch.float32, device=dev)
    den = torch.zeros((b * h, sqp), dtype=torch.float32, device=dev)
    acc = torch.zeros((b * h, sqp, d), dtype=torch.float32, device=dev)
    for k_start in range(0, skvp, bk):
        live = torch.ones_like(qpos, dtype=torch.bool)
        if causal:
            live = live & (k_start <= q_start + bq - 1)
        if window > 0:
            live = live & (k_start + bk - 1 > q_start - window)
        if not bool(live.any()):
            continue
        kb, vb = kt[:, k_start:k_start + bk], vt[:, k_start:k_start + bk]
        s = torch.matmul(qt, kb.transpose(1, 2))                # (BH, Sqp, bk)
        kpos = k_start + torch.arange(bk, device=dev)
        valid = (kpos < skv)[None, :].expand(sqp, bk)
        if causal:
            valid = valid & (kpos[None, :] <= qpos[:, None])
        if window > 0:
            valid = valid & (kpos[None, :] > qpos[:, None] - window)
        s = torch.where(valid[None], s, torch.full_like(s, NEG))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        den_new = den * corr + p.sum(dim=-1)
        acc_new = acc * corr[..., None] + torch.matmul(p, vb)
        m = torch.where(live[None], m_new, m)
        den = torch.where(live[None], den_new, den)
        acc = torch.where(live[None, :, None], acc_new, acc)
    out = acc / torch.clamp(den, min=1e-30)[..., None]
    out = out[:, :sq].reshape(b, h, sq, d).permute(0, 2, 1, 3)
    return out.to(q.dtype).contiguous()


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: int = 0) -> Tensor:
    """Flash attention; same arguments and result as ``flash_attention_ref``
    (default blocks).  CPU tensors run the plain version; CUDA tensors
    launch ``csrc/flash_attention.cu`` (one count per call) or raise."""
    if not q.is_cuda:
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    _check(q, k, v)
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head dims {HEAD_DIMS}, got {d}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")
    # cp.async reads 16-byte chunks: a view at an odd offset is copied.
    q, k, v = (t.contiguous() for t in (q, k, v))
    q, k, v = (t.clone() if t.data_ptr() % 16 else t for t in (q, k, v))
    out = torch.empty_like(q)
    err = _build.lib("flash_attention").flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), b, h, kh, sq, skv, d, d ** -0.5,
        int(causal), int(window), _build.stream_ptr(q.device))
    _build.check(err, "flash_attention_launch")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
