"""The recording points of a cost trace (``launch.cost_analysis``).

The model, kernel-dispatch and training code call these where a virtual
mesh combines its shards.  Outside a trace each is one context-variable
check and returns, so the served paths and their CUDA graphs are
unchanged.  The running trace (set by ``cost_analysis.traced_costs``)
does the accounting: this module only reaches it.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

_TRACE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_cost_trace", default=None)

_NULL = contextlib.nullcontext()


def active():
    """The running trace, or None (outside ``traced_costs``)."""
    return _TRACE.get()


def scope(trace, *axes):
    """Attribute the ops inside to one shard of the mesh axes ``axes``
    (``trace`` from ``active()``; a shared null context without one)."""
    if trace is None:
        return _NULL
    return trace.scope(axes)


def record_collective(kind: str, message, group: int) -> None:
    """Record one collective over ``group`` devices whose per-device result
    is ``message``: bytes, or a tensor whose bytes the per-device rule
    divides (a batch-leading tensor by the data axes)."""
    trace = _TRACE.get()
    if trace is None or group <= 1:
        return
    if isinstance(message, torch.Tensor):
        message = trace.per_device(message.numel() * message.element_size(),
                                   (message,))
    trace.collectives.append((kind, float(message), int(group)))


def run_sharded(axes, fn, *args):
    """``fn(*args)`` as one shard of the mesh axes ``axes``: its ops inside
    ``scope``, and under autograd the backward of every node between its
    outputs and its tensor arguments too (the autograd engine runs those
    outside any forward scope; a pre-hook enters the scope and a hook
    leaves it, node by node).  When an argument is batch-leading the
    shard's work is per batch row: the data axes split all of it (its
    inner products may lead with a head axis).  Outside a trace it is
    ``fn(*args)``.

    The walk stops at the arguments' own nodes, so every tensor the shard
    reads that carries a gradient must be an argument.  A rematerialized
    region upstream recomputes on its first saved-tensor read, which is a
    dense call's backward (no hooked node): its forward keeps its own
    scopes."""
    trace = _TRACE.get()
    if trace is None:
        return fn(*args)
    per_row = trace.batched([a for a in args if isinstance(a, torch.Tensor)])
    with trace.scope(axes, per_row):
        out = fn(*args)
    if torch.is_grad_enabled():
        stop = {a.grad_fn for a in args
                if isinstance(a, torch.Tensor) and a.grad_fn is not None}
        outs = out if isinstance(out, (tuple, list)) else (out,)
        _hook_shard(trace, axes, per_row,
                    [o.grad_fn for o in outs if isinstance(o, torch.Tensor)],
                    stop)
    return out


def _hook_shard(trace, axes, per_row, roots, stop) -> None:
    seen = set()
    stack = [n for n in roots if n is not None]
    while stack:
        node = stack.pop()
        if node in seen or node in stop:
            continue
        seen.add(node)
        if node.name().endswith("AccumulateGrad"):
            continue
        held = []

        def enter(grad_outputs, held=held):
            cm = trace.scope(axes, per_row)
            cm.__enter__()
            held.append(cm)

        def leave(grad_inputs, grad_outputs, held=held):
            held.pop().__exit__(None, None, None)

        node.register_prehook(enter)
        node.register_hook(leave)
        stack.extend(f for f, _ in node.next_functions if f is not None)


def data_size() -> int:
    """The running trace's data-axes size (1 outside a trace)."""
    trace = _TRACE.get()
    return 1 if trace is None else trace.data


def record_grad_reduction(grads, params, itemsize=None) -> None:
    """The data-parallel reduction of a train step's gradients ``grads``
    of ``params`` (``itemsize``: the compressed gradient's bytes per
    element); the trace records it by its cell's placements."""
    trace = _TRACE.get()
    if trace is None or trace.data <= 1:
        return
    trace.grad_reduction(grads, params, itemsize)
