"""Cost analysis of a traced step: FLOPs, HBM bytes, peak memory and
collective traffic per device, the counterpart of the JAX package's
``launch/hlo_analysis.py``.

The JAX package compiles a cell over placeholder devices and parses the
compiled HLO.  The port has no compiler to ask: ``traced_costs`` runs the
step on the ``meta`` device (shapes and dtypes, no storage, no card) under
a ``TorchDispatchMode`` and counts what each aten op the step dispatches
would do:

  * FLOPs: matmul-class ops only, by ``torch.utils.flop_counter``'s
    formulas and its decompositions, so the count equals
    ``FlopCounterMode``'s on the card when both runs take the same route.
    The JAX package counts dot FLOPs only and ignores elementwise work; so
    does this count.
  * HBM bytes: each op that launches a kernel reads every tensor input
    once (its memory footprint: an expanded dim is read once) and writes
    every output once.  Views and metadata ops move nothing and are
    skipped, as ``_SKIP_BYTES_OPS`` skips them in the HLO.  Gathers
    (``index``, ``index_select``, ``gather``, ``embedding``) read the
    region they return, and in-place scatters (``index_put_``,
    ``index_add_``, ...) read and write the region of their values: the
    HLO rule for gathers and dynamic updates.  Eager PyTorch fuses
    nothing, so the fusion-optimistic and the pessimistic counts are the
    same count: ``hbm_bytes`` is reported under both names.  L2 reuse is
    not modelled.
  * Temp bytes: the peak of the bytes of storages allocated during the
    step and still referenced (autograd's saved tensors included),
    tracked from allocation to release.
  * Collectives: the events the step records (``core.cost_trace``'s
    recording points, which reach the running trace) at the points where
    a virtual mesh combines its shards (``ops.dense_tp``'s concatenation,
    ``fused_qkv_dense``'s, the Megatron routes' all-reduces (``ops.
    dense_column``'s backward, ``dense_row``'s shard sum) and gathers,
    ``moe_block_sharded``'s partial sums and aux mean, the train step's
    gradient reduction, placed by its cell's specs, and loss means).
    ``collective_stats`` applies the JAX package's ring formulas to them.
    Outside a trace every record is one context-variable check and
    returns.

Per-device accounting.  A virtual mesh runs every shard on one device, so
the trace sees the whole mesh's work; each op's costs go to the devices
that would run it:

  * work inside a shard scope (``scope``: one model shard of
    ``dense_tp`` / ``fused_qkv_dense`` / ``dense_column`` / ``dense_row``
    or of ``cost_trace.run_sharded``'s ops, forward and backward, one
    (data, expert) shard of ``moe_block_sharded``) goes to that shard's
    positions: divided by the sizes of the scoped axes, and, for a model
    shard of batch-leading work, by the data axes too;
  * otherwise, work whose leading dim is the batch that ``batch_spec``
    splits (a tensor input or output whose dim 0 is one of the step's
    batch row counts, or whose any dim is its token count, or a tensor of
    three or more dims whose dim 0 is a row count times a head count: the
    attention's batched products) is divided by the data axes' size;
  * everything else is replicated: every device does all of it.
A message's bytes are its per-device result bytes, as the HLO's result
shape gives them.  Argument bytes per device are each leaf's bytes over
the sizes of the axes its spec splits (``distributed.sharding``'s
``param_spec_tree``, ``abfp_param_spec_tree``, ``zero1_spec``,
``decode_state_spec_tree``, ``batch_spec``); output and alias bytes
follow (an output that is an argument's storage, updated in place, is
donated: alias).  ``live = argument + temp + output - alias``.

``roofline_terms`` is the JAX package's, unchanged.
"""

from __future__ import annotations

import contextlib
import time
import weakref
from collections import defaultdict

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.core.cost_trace import _TRACE
from repro_torch.kernels.ops import DATA_AXES

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten

# Ops FlopCounterMode hands back unexecuted (metadata queries).
_META_QUERIES = {
    _aten.sym_is_contiguous.default, _aten.is_contiguous.default,
    _aten.is_contiguous.memory_format, _aten.is_strides_like_format.default,
    _aten.is_non_overlapping_and_dense.default, _aten.size.default,
    _aten.sym_size.default, _aten.stride.default, _aten.sym_stride.default,
    _aten.storage_offset.default, _aten.sym_storage_offset.default,
    _aten.numel.default, _aten.sym_numel.default, _aten.dim.default,
    torch.ops.prim.layout.default}

# Allocations that launch nothing.
_NO_KERNEL = {"empty", "empty_strided", "empty_like", "new_empty",
              "new_empty_strided", "detach", "alias", "_unsafe_view",
              "lift_fresh"}

_GATHERS = {"index", "index_select", "gather", "embedding"}
_SCATTERS_INPLACE = {"index_put_", "_index_put_impl_", "index_add_",
                     "index_copy_", "scatter_", "scatter_add_",
                     "scatter_reduce_", "index_fill_", "masked_scatter_"}


def roofline_terms(flops: float, hbm_bytes: float, collective_bytes: float,
                   chips: int, *, peak_flops: float, hbm_bw: float,
                   ici_bw: float) -> dict:
    """The three roofline terms in seconds (per-device program costs)."""
    compute_s = flops / peak_flops
    memory_s = hbm_bytes / hbm_bw
    collective_s = collective_bytes / ici_bw
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    terms["bottleneck"] = max(
        terms, key=lambda k: terms[k] if k.endswith("_s") else -1)
    return terms


def wire_bytes(kind: str, size: float, group: int) -> int:
    """Per-device bytes on the wire of one collective of ``kind`` whose
    result is ``size`` bytes over a group of ``group`` devices (ring
    algorithms): all-reduce 2·size·(g−1)/g; all-gather, reduce-scatter and
    all-to-all size·(g−1)/g; collective-permute size."""
    if kind not in COLLECTIVES:
        raise ValueError(f"unknown collective {kind!r}")
    ring = (group - 1) / group if group > 1 else 0.0
    if kind == "all-reduce":
        return int(2 * size * ring)
    if kind == "collective-permute":
        return int(size)
    return int(size * ring)


def collective_stats(events) -> dict:
    """``{kind: {"count", "bytes"}, ..., "total": {...}}`` of recorded
    events ``(kind, message bytes, group size)``: the JAX package's
    ``collective_stats`` over the HLO's collectives, the wire bytes summed
    per event as it sums them per instruction."""
    colls: dict = defaultdict(lambda: {"count": 0, "bytes": 0})
    for kind, size, group in events:
        colls[kind]["count"] += 1
        colls[kind]["bytes"] += wire_bytes(kind, size, group)
    out = {k: dict(v) for k, v in colls.items()}
    out["total"] = {"count": sum(v["count"] for v in colls.values()),
                    "bytes": sum(v["bytes"] for v in colls.values())}
    return out


# ---------------------------------------------------------------------------
# Placements
# ---------------------------------------------------------------------------


def paired(tree, specs, out=None):
    """[(tensor, spec)] over ``tree``'s tensors in the port's leaf order
    (``core.tree``: dict keys sorted), each with the entry of ``specs``
    (a tree of the same structure, or None) at its place."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append((tree, specs))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            paired(tree[k], None if specs is None else specs[k], out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            paired(v, None if specs is None else specs[i], out)
    return out


def spec_split(spec, mesh) -> int:
    """How many pieces ``spec`` cuts a leaf into on ``mesh``."""
    if spec is None or mesh is None:
        return 1
    n = 1
    for e in spec:
        for a in (e if isinstance(e, tuple) else (e,)):
            if a is not None:
                n *= mesh.shape[a]
    return n


# ---------------------------------------------------------------------------
# The trace
# ---------------------------------------------------------------------------


def _footprint(t: torch.Tensor) -> int:
    """Bytes a kernel reads of ``t``: its elements, or the span its strides
    cover when that is smaller (an expanded dim is read once)."""
    n = t.numel()
    if n == 0:
        return 0
    span = 1 + sum((s - 1) * abs(st) for s, st in zip(t.shape, t.stride())
                   if s > 1)
    return min(n, span) * t.element_size()


def _flat_tensors(items, out):
    """The tensors among ``items`` and inside its lists, tuples and dicts."""
    for a in items:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            _flat_tensors(a, out)
        elif isinstance(a, dict):
            _flat_tensors(a.values(), out)
    return out


_WRITES: dict = {}


def _writes(func) -> bool:
    """Does ``func`` write into one of its arguments?"""
    w = _WRITES.get(func)
    if w is None:
        w = _WRITES[func] = any(
            a.alias_info is not None and a.alias_info.is_write
            for a in func._schema.arguments)
    return w


class _Trace:
    def __init__(self, mesh, batch_rows, token_rows, head_rows,
                 grad_specs=None):
        self.mesh = mesh
        self.grad_specs = grad_specs
        self.batch_rows = set(batch_rows)
        self.token_rows = set(token_rows)
        self.head_rows = set(head_rows)
        self.data = 1
        if mesh is not None:
            self.data = int(np.prod([mesh.shape[a] for a in DATA_AXES
                                     if a in mesh.axis_names]))
        # (divisor, scoped axes, per batch row): the shard scopes entered.
        self.divisors = [(1, frozenset(), False)]
        self.flops = 0
        self.flops_dev = 0.0
        self.hbm = 0
        self.hbm_dev = 0.0
        self.by_class = defaultdict(lambda: {"flops": 0, "hbm_bytes": 0})
        self.collectives = []
        self.known = set()            # ids of storages seen (args + new)
        self.new_dev = {}             # id -> per-device bytes, live ones
        self.live_dev = 0.0
        self.peak_dev = 0.0
        self.new_glob = {}            # id -> bytes, the whole mesh's
        self.live_glob = 0
        self.peak_glob = 0
        self.ops = 0

    @contextlib.contextmanager
    def scope(self, axes, per_row: bool = False):
        """Ops inside run on one shard of ``axes``; with ``per_row`` the
        shard's work is per batch row (a model shard of a batch-leading
        computation), so the data axes split all of it."""
        d = 1
        if self.mesh is not None:
            d = int(np.prod([self.mesh.shape[a] for a in axes
                             if a in self.mesh.axis_names]))
        div, scoped, rows = self.divisors[-1]
        self.divisors.append((div * d, scoped | frozenset(axes),
                              rows or per_row))
        try:
            yield
        finally:
            self.divisors.pop()

    def batched(self, tensors) -> bool:
        """Is any of ``tensors`` batch-leading (the rule above)?"""
        return any(t.dim() and (t.shape[0] in self.batch_rows
                                or any(s in self.token_rows for s in t.shape)
                                or (t.dim() > 2
                                    and t.shape[0] in self.head_rows))
                   for t in tensors)

    def _class(self, tensors):
        div, scoped, rows = self.divisors[-1]
        if len(self.divisors) > 1:
            # A shard of axes that leave the batch whole (a model shard)
            # still splits batch-leading work over the data axes.
            if not scoped & set(DATA_AXES) and (rows
                                                or self.batched(tensors)):
                div *= self.data
            return "sharded", div
        if self.batched(tensors):
            return "batch", self.data
        return "replicated", 1

    def per_device(self, nbytes, tensors) -> float:
        return nbytes / self._class(tensors)[1]

    def grad_reduction(self, grads, params, itemsize) -> None:
        """The gradients' reduction over the data axes, by the cell's
        placements (``grad_specs``: its validated param specs and its
        moments' ZeRO-1 specs).  Per leaf an all-reduce over the data
        axes; for a leaf whose ZeRO-1 spec puts 'data' on a dim, a
        reduce-scatter over 'data', an all-reduce of the scattered piece
        over 'pod' where the mesh has one, and an all-gather of the
        updated parameter over 'data'.  Each message is a result's bytes
        per device after the leaf's model split."""
        if self.grad_specs is None:
            raise ValueError("a train step traced on a data mesh needs its "
                             "cell's grad_specs")
        mesh = self.mesh
        pspec, z1 = self.grad_specs
        dp = mesh.shape["data"] if "data" in mesh.axis_names else 1
        pod = mesh.shape["pod"] if "pod" in mesh.axis_names else 1

        def add(kind, size, group):
            if group > 1:
                self.collectives.append((kind, float(size), int(group)))

        for (g, _), (p, spec), (_, zspec) in zip(
                paired(grads, None), paired(params, pspec),
                paired(params, z1)):
            split = spec_split(spec, mesh)
            local = g.numel() * (itemsize or g.element_size()) / split
            if "data" in tuple(zspec):
                add("reduce-scatter", local / dp, dp)
                add("all-reduce", local / dp, pod)
                add("all-gather", p.numel() * p.element_size() / split, dp)
            else:
                add("all-reduce", local, self.data)

    def _free(self, key):
        b = self.new_dev.pop(key, None)
        if b is not None:
            self.live_dev -= b
            self.live_glob -= self.new_glob.pop(key)

    def account(self, func, args, kwargs, out, flops):
        ins = _flat_tensors(args, [])
        if kwargs:
            _flat_tensors(kwargs.values(), ins)
        outs = _flat_tensors((out,), [])
        cls, div = self._class(ins + outs)
        name = func._overloadpacket.__name__
        if name in _NO_KERNEL:
            moves = False
        elif outs and not _writes(func):
            in_st = {id(t.untyped_storage()) for t in ins}
            moves = not all(id(t.untyped_storage()) in in_st for t in outs)
        else:
            moves = True
        nbytes = 0
        if moves:
            if name in _GATHERS:
                idx = [t for t in ins if not t.is_floating_point()]
                nbytes = 2 * sum(t.numel() * t.element_size() for t in outs)
                nbytes += sum(_footprint(t) for t in idx)
            elif name in _SCATTERS_INPLACE and len(ins) > 1:
                nbytes = sum(2 * _footprint(t) if t.is_floating_point()
                             or t.dtype == ins[0].dtype else _footprint(t)
                             for t in ins[1:])
            else:
                nbytes = (sum(_footprint(t) for t in ins)
                          + sum(t.numel() * t.element_size() for t in outs))
        self.ops += 1
        self.flops += flops
        self.flops_dev += flops / div
        self.hbm += nbytes
        self.hbm_dev += nbytes / div
        self.by_class[cls]["flops"] += flops
        self.by_class[cls]["hbm_bytes"] += nbytes
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in self.known:
                continue
            self.known.add(key)
            b = st.nbytes() / div
            self.new_dev[key] = b
            self.live_dev += b
            self.new_glob[key] = st.nbytes()
            self.live_glob += st.nbytes()
            weakref.finalize(st, self._forget, key)
        self.peak_dev = max(self.peak_dev, self.live_dev)
        self.peak_glob = max(self.peak_glob, self.live_glob)

    def _forget(self, key):
        self.known.discard(key)
        self._free(key)


_FUNCTIONAL: dict = {}


def _functional(func) -> bool:
    """Does ``func`` write nothing and return fresh tensors only?"""
    f = _FUNCTIONAL.get(func)
    if f is None:
        sch = func._schema
        f = _FUNCTIONAL[func] = (
            not _writes(func) and bool(sch.returns)
            and all(r.alias_info is None and str(r.type) in ("Tensor",
                                                              "Tensor[]")
                    for r in sch.returns))
    return f


def _meta_key(func, args, kwargs):
    """A hashable key of a functional op's inputs' metadata when every
    tensor among them is on ``meta`` (at least one); else None."""
    if not _functional(func):
        return None
    found = []

    def one(a):
        if isinstance(a, torch.Tensor):
            if a.device.type != "meta":
                raise TypeError
            found.append(True)
            return (tuple(a.shape), a.stride(), a.dtype, a.storage_offset())
        if isinstance(a, (list, tuple)):
            return tuple(one(v) for v in a)
        hash(a)
        return a

    try:
        key = (func, tuple(one(a) for a in args),
               tuple((k, one(v)) for k, v in sorted(kwargs.items())))
    except TypeError:
        return None
    return key if found else None


def _describe(out):
    if isinstance(out, torch.Tensor):
        return (tuple(out.shape), out.stride(), out.dtype)
    return [_describe(o) for o in out]


def _rebuild(desc):
    if isinstance(desc, tuple):
        shape, stride, dtype = desc
        return torch.empty_strided(shape, stride, dtype=dtype, device="meta")
    return [_rebuild(d) for d in desc]


class _CostMode(TorchDispatchMode):
    """Counts every dispatched op into a ``_Trace``; FLOPs as
    ``FlopCounterMode`` counts them (its skips, decompositions and
    formulas)."""

    def __init__(self, trace: _Trace):
        super().__init__()
        self.trace = trace
        self.shapes = {}

    def _run(self, func, args, kwargs):
        """``func(*args, **kwargs)``; a functional op on ``meta`` tensors
        whose inputs' metadata it has met before gets fresh outputs of the
        metadata it gave then (the meta kernels are Python and the traces
        repeat a few shapes many times)."""
        key = _meta_key(func, args, kwargs)
        if key is None:
            return func(*args, **kwargs)
        got = self.shapes.get(key)
        if got is None:
            out = func(*args, **kwargs)
            # An output on an input's storage (``_unsafe_view``) is not
            # fresh: such ops always run.
            ins = {id(t.untyped_storage())
                   for t in _flat_tensors((args, kwargs.values()), [])}
            fresh = all(id(t.untyped_storage()) not in ins
                        for t in _flat_tensors((out,), []))
            self.shapes[key] = _describe(out) if fresh else False
            return out
        if got is False:
            return func(*args, **kwargs)
        return _rebuild(got)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _META_QUERIES:
            return NotImplemented
        packet = func._overloadpacket
        if (packet not in flop_registry
                and func is not torch.ops.prim.device.default):
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = self._run(func, args, kwargs)
        flops = 0
        if packet in flop_registry:
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
        self.trace.account(func, args, kwargs, out, flops)
        return out


def traced_costs(fn, *args, mesh=None, batch_rows=(), token_rows=(),
                 head_rows=(), arg_specs=None, grad_specs=None,
                 **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` (on ``meta`` tensors: nothing computed,
    nothing allocated) under the cost mode and return its costs per device
    on ``mesh`` (see the module docstring): ``flops``, ``hbm_bytes``,
    ``hbm_bytes_pessimistic`` (the same count), ``collectives``
    (``collective_stats``), ``events``, ``memory`` (argument, output,
    temp and alias bytes), ``live_bytes``, the global (whole-mesh)
    ``flops_global`` / ``hbm_bytes_global`` / ``live_bytes_global`` (what
    one card holding every shard of a virtual mesh holds) and their split
    ``by_class`` (replicated / batch / sharded), ``ops`` and ``seconds``.
    ``batch_rows``: the leading dims of the batch that the data axes
    split; ``token_rows``: its token counts; ``head_rows``: its row
    counts times the head counts.  ``arg_specs``: a tree
    mirroring ``args`` with a spec (``distributed.sharding.P``) or None
    (replicated) at each tensor's place (``paired``).  ``grad_specs``: a
    train step's (param specs, ZeRO-1 specs) trees, the placements its
    gradient reduction is recorded by."""
    trace = _Trace(mesh, batch_rows, token_rows, head_rows, grad_specs)
    arg_dev, arg_glob = {}, {}
    for t, spec in paired(args, arg_specs):
        key = id(t.untyped_storage())
        arg_dev.setdefault(key, t.untyped_storage().nbytes()
                           / spec_split(spec, mesh))
        arg_glob[key] = t.untyped_storage().nbytes()
    trace.known.update(arg_dev)
    t0 = time.perf_counter()
    token = _TRACE.set(trace)
    try:
        with _CostMode(trace):
            out = fn(*args, **kwargs)
    finally:
        _TRACE.reset(token)
    seconds = time.perf_counter() - t0
    out_bytes = alias = new_out = new_out_glob = 0.0
    seen = set()
    for t in _flat_tensors((out,), []):
        key = id(t.untyped_storage())
        if key in seen:
            continue
        seen.add(key)
        if key in arg_dev:
            alias += arg_dev[key]
            out_bytes += arg_dev[key]
        else:
            b = trace.new_dev.get(
                key, t.untyped_storage().nbytes() / trace._class([t])[1])
            new_out += b
            out_bytes += b
            new_out_glob += trace.new_glob.get(key,
                                               t.untyped_storage().nbytes())
    argument = float(sum(arg_dev.values()))
    temp = max(0.0, trace.peak_dev - new_out)
    memory = {"argument_size_in_bytes": int(argument),
              "output_size_in_bytes": int(out_bytes),
              "temp_size_in_bytes": int(temp),
              "alias_size_in_bytes": int(alias)}
    live = argument + temp + out_bytes - alias
    return {"flops": float(trace.flops_dev),
            "hbm_bytes": float(trace.hbm_dev),
            "hbm_bytes_pessimistic": float(trace.hbm_dev),
            "collectives": collective_stats(trace.collectives),
            "events": list(trace.collectives),
            "memory": memory, "live_bytes": int(live),
            "live_bytes_global": int(sum(arg_glob.values())
                                     + max(trace.peak_glob, new_out_glob)),
            "flops_global": int(trace.flops),
            "hbm_bytes_global": int(trace.hbm),
            "by_class": {k: dict(v) for k, v in trace.by_class.items()},
            "ops": trace.ops, "seconds": seconds, "out": out}
