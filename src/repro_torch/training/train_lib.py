"""Train and serve step factories.

``make_train_step`` builds ``train_step(state, batch, key) -> (state,
metrics)``, the JAX package's functional signature, with gradients from
``torch.autograd``:
  * next-token cross-entropy in f32 through the chunked LM head (the head
    under fold 999,983), plus the weighted auxiliary loss;
  * microbatched gradient accumulation (microbatch i under ``fold_in(key,
    i)``, f32 sums);
  * optional gradient compression at the data-parallel boundary (bf16, or
    int8 with error feedback; ``distributed.collectives``);
  * any ``repro_torch.optim`` optimizer (f32 master weights and moments).
The quant config picks the forward's numerics: ``float``, or QAT with the
straight-through estimator (``abfp_ref``, the CUDA kernel's
``abfp_kernel``; ``kernels.ops``).

``make_train_step(..., mesh=)`` passes the mesh to ``forward`` (the MoE
layers take the expert-parallel route) while the loss's ``Numerics``
carries none, as in the JAX package; the mesh is virtual (one device,
``distributed.sharding``), and the moments' ZeRO-1 specs are
``distributed.sharding.zero1_state_sharding``'s.

``make_serve_steps`` builds prefill and decode callables.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.abfp import QuantConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.prng import fold_in
from repro_torch.core.tree import leaves, tree_map, unflatten_like
from repro_torch.distributed import collectives
from repro_torch.models.layers import Numerics
from repro_torch.models.lm import (
    check_supported,
    decode_step,
    forward,
    init_decode_state,
    lm_head_logits,
)
from repro_torch.optim.optimizers import global_norm

Tensor = torch.Tensor


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    ef: Optional[collectives.ErrorFeedbackState]
    step: Tensor            # 0-dim int32, CPU


def _nll(logits: Tensor, labels: Tensor) -> Tensor:
    ll = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(ll, -1, labels.long()[..., None])[..., 0]


def cross_entropy(logits: Tensor, labels: Tensor) -> Tensor:
    """Mean next-token NLL in f32."""
    return _nll(logits, labels).mean()


def chunked_cross_entropy(params, hidden: Tensor, labels: Tensor,
                          mcfg: ModelConfig, nx: Numerics,
                          chunk: int = 256) -> Tensor:
    """Cross-entropy without the whole (B, S, V) logits: the LM head over
    sequence chunks of ``chunk`` (S when ``chunk`` does not divide S).
    Every chunk's head call folds 999,983 into ``nx`` afresh, as the JAX
    package's scan traces one body."""
    b, s, _ = hidden.shape
    if s % chunk:
        chunk = s
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, chunk):
        logits = lm_head_logits(params, hidden[:, c0:c0 + chunk], mcfg, nx)
        total = total + _nll(logits, labels[:, c0:c0 + chunk]).sum()
    return total / (b * s)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    aux_loss_weight: float = 0.01
    compression: Optional[str] = None       # None | "bf16" | "int8"
    quant: QuantConfig = QuantConfig(mode="float")


def tokens_on(batch: dict, device) -> Tensor:
    """A batch's (B, S + 1) token ids on ``device`` as int64."""
    t = batch["tokens"]
    if not isinstance(t, Tensor):
        t = torch.from_numpy(np.asarray(t))
    return t.to(device=device, dtype=torch.int64)


def batch_on(batch: dict, device) -> dict:
    """A batch's tensors on ``device``: ``tokens`` (B, S + 1) and
    ``labels`` (B, S) as int64, a stub frontend's ``embeds`` (B, S, d) and
    an encoder-decoder's ``encoder_features`` (B, S_enc, d) as they are
    (numpy bfloat16 kept bit for bit)."""
    from repro_torch.models.convert import to_tensor
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, Tensor) else to_tensor(v, "cpu")
        out[k] = (t.to(device=device, dtype=torch.int64)
                  if k in ("tokens", "labels") else t.to(device))
    return out


def value_and_grad(loss_fn, params, *args):
    """(loss, aux, grads) of ``loss_fn(params, *args) -> (objective, loss,
    aux)`` with respect to every leaf of ``params``; a leaf the objective
    does not reach gets a zero gradient."""
    live = [p.detach().requires_grad_(True) for p in leaves(params)]
    with torch.enable_grad():
        obj, loss, aux = loss_fn(unflatten_like(params, live), *args)
        grads = torch.autograd.grad(obj, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(live, grads)]
    return loss.detach(), aux.detach(), unflatten_like(params, grads)


def make_train_step(mcfg: ModelConfig, optimizer, tcfg: TrainConfig,
                    device: DeviceLike = None, donate: bool = False,
                    mesh=None):
    """Returns (init_state, train_step): ``init_state(params) ->
    TrainState`` and ``train_step(state, batch, key) -> (state, metrics)``
    with metrics ``loss``, ``aux_loss`` and ``grad_norm`` (0-dim tensors
    on the device).  ``batch["tokens"]`` is (B, S + 1) (next-token
    prediction), or a stub frontend's ``batch["embeds"]`` (B, S, d) with
    ``batch["labels"]`` (B, S); an encoder-decoder's batch adds
    ``encoder_features``.  ``key`` is a host PRNG key (``core.prng``).  The
    parameters live on ``device``.  ``donate``: the step consumes its
    state, updating the parameters and the optimizer state in place
    (``update_``: the same bits, one optimizer state on the device), as
    the JAX package's ``launch/train.py`` donates its jitted step's
    state.  ``mesh`` goes to ``forward`` (expert-parallel MoE layers)."""
    check_supported(mcfg)
    dev = resolve_device(device)

    def loss_fn(params, batch, key):
        nx = Numerics(tcfg.quant, key)
        if "labels" in batch:
            inputs, labels = batch["embeds"], batch["labels"]
        else:
            inputs, labels = batch["tokens"][:, :-1], batch["tokens"][:, 1:]
        hidden, aux = forward(params, inputs, mcfg, nx,
                              encoder_features=batch.get("encoder_features"),
                              mesh=mesh, return_hidden=True)
        loss = chunked_cross_entropy(params, hidden, labels, mcfg, nx)
        return loss + tcfg.aux_loss_weight * aux, loss, aux

    def init_state(params) -> TrainState:
        ef = (collectives.init_error_feedback(params)
              if tcfg.compression == "int8" else None)
        return TrainState(params, optimizer.init(params), ef,
                          torch.zeros((), dtype=torch.int32))

    def train_step(state: TrainState, batch: dict, key):
        batch = batch_on(batch, dev)
        nm = tcfg.microbatches
        if nm > 1:
            b = next(iter(batch.values())).shape[0]
            if b % nm:
                raise ValueError(f"batch {b} does not split into {nm} "
                                 f"microbatches")
            mb = b // nm
            grads = tree_map(lambda p: torch.zeros(p.shape,
                                                   dtype=torch.float32,
                                                   device=p.device),
                             state.params)
            loss = aux = 0.0
            for i in range(nm):
                l_i, a_i, g_i = value_and_grad(
                    loss_fn, state.params,
                    {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()},
                    fold_in(key, i))
                grads = tree_map(torch.add, grads, g_i)
                loss, aux = loss + l_i, aux + a_i
            grads = tree_map(lambda g: g / nm, grads)
            loss, aux = loss / nm, aux / nm
        else:
            loss, aux, grads = value_and_grad(loss_fn, state.params, batch,
                                              key)
        grads, ef = collectives.apply_compression(grads, tcfg.compression,
                                                  state.ef)
        update = optimizer.update_ if donate else optimizer.update
        params, opt_state = update(grads, state.opt_state, state.params)
        metrics = {"loss": loss, "aux_loss": aux,
                   "grad_norm": global_norm(grads)}
        return TrainState(params, opt_state, ef, state.step + 1), metrics

    return init_state, train_step


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------


def make_serve_steps(mcfg: ModelConfig,
                     quant: QuantConfig = QuantConfig(mode="float"),
                     device: DeviceLike = None):
    """Returns (prefill_fn, decode_fn, init_state_fn):

    prefill_fn(params, tokens (B, S), key=None) -> logits (B, S, V)
    decode_fn(params, state, token (B,), key=None) -> (logits (B, V), state)
    init_state_fn(batch, max_len) -> decode state on ``device``
    """
    dev = resolve_device(device)

    def prefill(params, tokens, key=None):
        with torch.no_grad():
            return forward(params, tokens, mcfg, Numerics(quant, key))[0]

    def decode(params, state, token, key=None):
        with torch.no_grad():
            return decode_step(params, state, token, mcfg,
                               Numerics(quant, key))

    def init_state(batch, max_len):
        return init_decode_state(mcfg, batch, max_len, device=dev)

    return prefill, decode, init_state
