"""Mixture-of-Experts FFN: routing, the per-expert ABFP loop, the float
route and the expert-parallel route, as the JAX package's
``models/moe.py`` computes them.

One routing front end (``_route``: an f32 router matmul, softmax, top-k,
renormalized gates and the switch-style load-balance aux loss) feeds one
of three routes:

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
  * on a mesh: ``moe_block_sharded``, the JAX package's expert-parallel
    route (its ``shard_map``) computed shard by shard on the mesh's one
    device: the experts split over 'model', the tokens over the data
    axes; each (data, expert) shard routes its tokens, keeps the pairs
    whose expert is local at a fixed capacity (GShard-style dropping),
    runs them through the grouped float FFN (``_expert_ffn_ragged``) and
    scatter-adds them; the expert shards' partial outputs are summed (the
    ``psum``) and ``aux`` is the mean over all shards (the ``pmean``).
    As in the JAX package this route ignores ``nx``: its experts are
    float under any quant mode.

Expert weights are (E, K, N) tensors, or lists of E ``PackedWeight``s once
packed (``models.packing``); ``w[ex]`` picks expert ``ex`` from either.
The router stays a float (f32) weight: routing is digital.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import cost_trace
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


# ---------------------------------------------------------------------------
# Expert-parallel route (the JAX package's shard_map over 'model')
# ---------------------------------------------------------------------------


def _expert_ffn_ragged(xf: Tensor, token: Tensor, expert: Tensor,
                       pos: Tensor, width: int, wi: Tensor, wg: Tensor,
                       wo: Tensor, mcfg) -> Tensor:
    """JAX's grouped SwiGLU/GeGLU over expert-sorted rows (its
    ``ragged_dot``): every kept row (token ``token``, expert ``expert``,
    place ``pos`` in its expert's group) through its expert's weights,
    cast to the rows' dtype, with f32 products and the hidden rounded to
    the rows' dtype before ``wo``.  The groups are computed as one batched
    matmul over all experts, each group padded with zero rows to
    ``width``; a padding row's output is never read.  Returns the rows'
    outputs in f32, shaped like ``token`` plus (d,)."""
    act, dt = _act(mcfg), xf.dtype
    d = xf.shape[-1]
    xpad = xf.new_zeros((wi.shape[0], width, d)).index_put(
        (expert.reshape(-1), pos.reshape(-1)), xf[token.reshape(-1)])
    hi = _f32_matmul(xpad, wi.to(dt))
    hg = _f32_matmul(xpad, wg.to(dt))
    h = (act(hg) * hi).to(dt)
    return _f32_matmul(h, wo.to(dt))[expert, pos]


def _local_pairs(gates: Tensor, eids: Tensor, lo: int, e_local: int,
                 capacity: int):
    """One expert shard's kept (token, expert) pairs, as JAX's local
    function keeps them: a stable sort of the pairs' local expert ids (a
    pair of another shard's expert sorts last), cut at ``capacity``.
    Returns (the kept pairs' flat indices, their local ids (e_local for a
    pair not the shard's), their gates (0 for those))."""
    local = eids - lo
    mine = (local >= 0) & (local < e_local)
    flat_local = torch.where(mine, local, e_local).reshape(-1)
    flat_gates = torch.where(mine, gates, 0.0).reshape(-1)
    rows = torch.argsort(flat_local, stable=True)[:capacity]
    ids = flat_local[rows]
    return rows, ids, torch.where(ids < e_local, flat_gates[rows], 0.0)


def moe_block_sharded(params: dict, x: Tensor, mcfg, nx: Numerics, mesh, *,
                      batch_axes=("pod", "data"), expert_axis="model"):
    """Expert-parallel MoE on ``mesh``: the experts split over
    ``expert_axis``, x's batch over ``batch_axes`` (evenly, as the JAX
    package's ``batch_spec`` splits it).  x: (B, S, d) -> (y (B, S, d),
    aux f32 scalar).  ``nx`` is not read: the experts are float.

    Each expert group is padded to the widest group, a host read of the
    group sizes.  On the ``meta`` device (the dry run's trace) nothing can
    be read: every group is padded to the shard's static capacity, the
    width JAX's shapes carry, so the dry run's expert FLOPs and bytes are
    an upper bound (every local expert at full capacity).  Under a cost
    trace each (data, expert) shard's work goes to its positions, the
    partial sums are an all-reduce over ``expert_axis`` and the aux mean
    one over the whole mesh (``core.cost_trace``)."""
    batch_axes = tuple(a for a in batch_axes if a in mesh.axis_names)
    n_shards = mesh.shape[expert_axis]
    n_data = int(np.prod([mesh.shape[a] for a in batch_axes]))
    e, k = mcfg.num_experts, mcfg.experts_per_token
    e_local = e // n_shards
    if e_local * n_shards != e:
        raise ValueError(f"{e} experts do not split over {n_shards} shards")
    b, s, d = x.shape
    if b % n_data:
        raise ValueError(f"a batch of {b} does not split over {n_data} "
                         f"data shards")
    bl = b // n_data
    t = bl * s
    capacity = min(int((t * k / n_shards) * mcfg.capacity_factor) + 1,
                   t * k)
    ys, auxes = [], []
    shard_lo = torch.arange(n_shards, device=x.device)[:, None] * e_local
    trace = cost_trace.active()
    for db in range(n_data):
        with cost_trace.scope(trace, *batch_axes):
            xf = x[db * bl:(db + 1) * bl].reshape(t, d)
            gates, eids, aux = _route(xf, params["router"], mcfg)
            with cost_trace.scope(trace, expert_axis):
                rows, ids, w_rows = (torch.stack(v) for v in zip(*(
                    _local_pairs(gates, eids, sh * e_local, e_local,
                                 capacity)
                    for sh in range(n_shards))))          # (shards, C)
                # Overflow and other shards' pairs fold into the last
                # local group with a zero gate; each row's place in its
                # group follows from the groups' sizes, of which the
                # widest is the one host read.
                group = ids.clamp(max=e_local - 1)
                sizes = torch.zeros((n_shards, e_local), dtype=torch.int64,
                                    device=x.device).scatter_add_(
                    1, group, torch.ones_like(group))
                pos = (torch.arange(capacity, device=x.device)
                       - (sizes.cumsum(1) - sizes).gather(1, group))
                token = rows // k
                width = (capacity if x.device.type == "meta"
                         else int(sizes.max()))
                out = _expert_ffn_ragged(xf, token, shard_lo + group, pos,
                                         width, params["wi"], params["wg"],
                                         params["wo"], mcfg)
            y = None            # the psum: the shards' partials in order
            for sh in range(n_shards):
                with cost_trace.scope(trace, expert_axis):
                    part = torch.zeros((t, d), dtype=torch.float32,
                                       device=x.device).index_add(
                        0, token[sh], out[sh] * w_rows[sh][:, None])
                y = part if y is None else y + part
            ys.append(y.reshape(bl, s, d).to(x.dtype))
        auxes += [aux] * n_shards
    cost_trace.record_collective("all-reduce", t * d * 4, n_shards)
    cost_trace.record_collective("all-reduce", 4, n_shards * n_data)
    return torch.cat(ys), torch.stack(auxes).mean()
