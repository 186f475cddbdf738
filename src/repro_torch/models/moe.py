"""Mixture-of-Experts FFN: routing, the per-expert ABFP loop and the float
route, as the JAX package's ``models/moe.py`` computes them.

One routing front end (``_route``: an f32 router matmul, softmax, top-k,
renormalized gates and the switch-style load-balance aux loss) feeds one
of two routes:

  * ABFP modes: ``_loop_moe``, the JAX package's per-expert loop.  Every
    token goes through every expert's wi, wg and wo (three
    ``Numerics.dense`` calls per expert, in that order, so each takes the
    noise counter JAX's takes) and is masked by its gate.  All T rows go
    through each call in JAX's row order: the kernels hash their noise by
    row, so gathering only the routed tokens would move it.
  * float: ``_float_moe`` computes what JAX's ``_ragged_moe`` computes
    (sort by expert, ``ragged_dot`` on the group sizes, scatter-add) as a
    masked loop of f32 matmuls over the experts: no data-dependent shape,
    no host sync (a CUDA graph captures it) and no float atomics.  The
    combine adds each token's contributions in ascending expert order,
    the order JAX's scatter-add meets them after its stable sort.

Expert weights are (E, K, N) tensors, or lists of E ``PackedWeight``s once
packed (``models.packing``); ``w[ex]`` picks expert ``ex`` from either.
The router stays a float (f32) weight: routing is digital.  The JAX
package's expert-parallel ``moe_block_sharded`` waits for tensor
parallelism (ROADMAP queue 1 item 5).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Numerics

Tensor = torch.Tensor

# The ABFP route runs every token through every expert: more than this
# many experts is refused, as in the JAX package.
MAX_LOOP_EXPERTS = 64


def init_moe(gen: torch.Generator, mcfg, device) -> dict:
    """The JAX package's leaves: ``router`` (d, E) f32, ``wi``/``wg`` (E,
    d, f) and ``wo`` (E, f, d) in ``param_dtype``; standard deviations
    d^-0.5 (f^-0.5 for ``wo``)."""
    e, d, f = mcfg.num_experts, mcfg.d_model, mcfg.d_ff

    def init(std, *shape, dtype=mcfg.param_dtype):
        return (torch.randn(shape, generator=gen, device=device) * std
                ).to(dtype)

    return {"router": init(d ** -0.5, d, e, dtype=torch.float32),
            "wi": init(d ** -0.5, e, d, f), "wg": init(d ** -0.5, e, d, f),
            "wo": init(f ** -0.5, e, f, d)}


def _f32_matmul(a: Tensor, b: Tensor) -> Tensor:
    """``a @ b`` in full f32; on a GPU, refuse to run with TF32 allowed
    (its 10-bit products would move the router's near-ties)."""
    if a.is_cuda and (torch.backends.cuda.matmul.allow_tf32
                      or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "the MoE router and float experts need full f32 matmuls: turn "
            "TF32 off (torch.backends.cuda.matmul.allow_tf32 = False, "
            "torch.set_float32_matmul_precision('highest'))")
    return torch.matmul(a.float(), b.float())


def _route(xf: Tensor, router_w: Tensor, mcfg):
    """(gates (T, k) f32, expert ids (T, k), aux loss f32 scalar).  Top-k
    breaks ties toward the lower expert index, as ``lax.top_k`` does (a
    stable descending sort)."""
    e, k = mcfg.num_experts, mcfg.experts_per_token
    probs = torch.softmax(_f32_matmul(xf, router_w), dim=-1)     # (T, E)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eids = top[:, :k], order[:, :k]
    gates = gates / gates.sum(dim=-1, keepdim=True)
    # Switch-transformer load-balance loss: E * sum_e f_e * p_e.
    density = (eids.reshape(-1, 1) == torch.arange(e, device=xf.device)
               ).sum(dim=0).float()
    density = density / torch.clamp(density.sum(), min=1.0)
    aux = e * torch.sum(density * probs.mean(dim=0))
    return gates, eids, aux


def _expert_gates(gates: Tensor, eids: Tensor, e: int) -> Tensor:
    """(T, E) f32: each token's gate of expert ``ex`` in column ``ex``, 0
    where it was not chosen; exactly JAX's ``sum(gates * (eids == ex),
    -1)`` (at most one nonzero term per token)."""
    sel = eids[:, :, None] == torch.arange(e, device=eids.device)
    return (gates[:, :, None] * sel).sum(dim=1)


def _act(mcfg):
    if mcfg.mlp_type == "geglu":
        return lambda v: F.gelu(v, approximate="tanh")
    return F.silu


def _loop_moe(xf: Tensor, params: dict, gates: Tensor, eids: Tensor, mcfg,
              nx: Numerics) -> Tensor:
    """The ABFP route: every expert matmul through ``nx.dense``."""
    if mcfg.num_experts > MAX_LOOP_EXPERTS:
        raise ValueError(
            f"ABFP-mode MoE runs every token through every expert; more "
            f"than {MAX_LOOP_EXPERTS} experts is refused "
            f"({mcfg.num_experts})")
    act = _act(mcfg)
    gate = _expert_gates(gates, eids, mcfg.num_experts)
    y = torch.zeros(xf.shape, dtype=torch.float32, device=xf.device)
    for ex in range(mcfg.num_experts):
        hi = nx.dense(xf, params["wi"][ex])
        hg = nx.dense(xf, params["wg"][ex])
        h = (act(hg.float()) * hi.float()).to(xf.dtype)
        out = nx.dense(h, params["wo"][ex]).float()
        y = y + out * gate[:, ex:ex + 1]
    return y.to(xf.dtype)


def _float_moe(xf: Tensor, params: dict, gates: Tensor, eids: Tensor,
               mcfg) -> Tensor:
    """The float route: JAX's grouped SwiGLU/GeGLU (weights cast to the
    activation dtype, f32 products, the hidden rounded to the activation
    dtype before ``wo``) for every token and expert, masked by the gates
    and summed in ascending expert order."""
    act = _act(mcfg)
    gate = _expert_gates(gates, eids, mcfg.num_experts)
    dt = xf.dtype
    y = torch.zeros(xf.shape, dtype=torch.float32, device=xf.device)
    for ex in range(mcfg.num_experts):
        hi = _f32_matmul(xf, params["wi"][ex].to(dt))
        hg = _f32_matmul(xf, params["wg"][ex].to(dt))
        h = (act(hg) * hi).to(dt)
        out = _f32_matmul(h, params["wo"][ex].to(dt))
        y = y + out * gate[:, ex:ex + 1]
    return y.to(dt)


def moe_block(params: dict, x: Tensor, mcfg, nx: Numerics):
    """Single-card MoE.  x: (B, S, d) -> (y (B, S, d), aux f32 scalar)."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    gates, eids, aux = _route(xf, params["router"], mcfg)
    if nx.quant.mode == "float":
        y = _float_moe(xf, params, gates, eids, mcfg)
    else:
        y = _loop_moe(xf, params, gates, eids, mcfg, nx)
    return y.reshape(b, s, d), aux
