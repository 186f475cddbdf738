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
