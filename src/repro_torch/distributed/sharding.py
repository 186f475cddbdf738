"""Sharding rules: parameter path -> partition spec, the serving placement,
and ZeRO-1 state specs, as the JAX package's ``distributed/sharding.py``
states them.

Megatron-style tensor parallelism over the 'model' axis and data
parallelism over ('pod', 'data'):

  wq/wk/wv        (d, heads*hd)  -> shard output (heads) over 'model'
  wo              (heads*hd, d)  -> shard input  (heads) over 'model'
  mlp wi/wg       (d, ff)        -> shard ff over 'model'
  mlp wo          (ff, d)        -> shard ff over 'model'
  moe wi/wg/wo    (E, d, ff)     -> shard experts over 'model' (EP)
  embed           (V, d)         -> shard vocab over 'model'
  lm_head         (d, V)         -> shard vocab over 'model'
  recurrent/xlstm projections    -> shard the wide axis over 'model'
  norms / scalars                -> replicated

The port's param and state trees hold per-layer lists where the JAX
package stacks ``groups/j`` (and ``encoder/layers``) along a leading scan
axis, so no port leaf is stacked: the spec of a port leaf is the JAX
package's spec of its path without that axis.  A spec is a ``P``, a tuple
per leaf: an axis name, a tuple of axis names, or None per dim; a
``NamedSharding`` pairs a spec with its mesh.

A ``Mesh`` is a (data, model) grid of device positions
(``launch.mesh.make_host_mesh``).  In this port every position is the
engine's one device: a mesh is virtual, and placing a tensor on it
(``shard_params``, ``shard_decode_state``) puts it on that device.  The
spec trees are computed and validated whole; what changes what runs is
the model axis: serving's column split of the dense weights
(``shard_serving_params``: ``kernels.ops.ColumnShards``, consumed by
``kernels.ops.dense_tp``), and the mesh forward's and train step's routes
(``tp_route``, ``model_split``: each 2-D leaf column-, row-parallel or
whole by its spec, run one shard at a time).  Every other spec (rows over
'data', ZeRO-1's moments) describes a placement that a one-device mesh
holds whole; spreading them over several cards is the multi-card
slice's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.abfp import PackedWeight
from repro_torch.kernels.abfp_decode_fused import PackedQKV, concat_qkv
from repro_torch.kernels.ops import (
    COLUMN,
    DATA_AXES,
    MODEL_AXIS,
    ROW,
    WHOLE,
    ColumnShards,
    ModelSplit,
    shard_columns,
    tp_col_quantum,
    tp_size,
)
from repro_torch.models.packing import DENSE_WEIGHT_NAMES

Pytree = Any

_LANE = 128                      # PackedWeight column alignment (core.abfp)


def _entry(e):
    """A spec entry as the JAX package's ``PartitionSpec`` keeps it: a
    group of one axis is that axis."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return e[0] if len(e) == 1 else e
    return e


class P(tuple):
    """A partition spec: one entry per dim (an axis name, a tuple of axis
    names, or None for a replicated dim)."""

    def __new__(cls, *parts):
        return super().__new__(cls, (_entry(e) for e in parts))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def canonical_device(device) -> torch.device:
    """``device`` with its index filled in (a bare ``cuda`` is the
    current card), as a tensor allocated there reports it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A grid of device positions with named axes: ``devices`` an object
    array of ``torch.device`` whose dims are ``axis_names``.  ``shape`` maps
    each axis to its size, as the JAX package's ``Mesh.shape`` does."""

    def __init__(self, devices: np.ndarray, axis_names):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-D device grid for axes "
                             f"{axis_names}")
        self.devices = devices
        self.axis_names = axis_names

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_set(self) -> set:
        """The distinct devices of the mesh's positions (canonical)."""
        return {canonical_device(d) for d in self.devices.flat}

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, as the JAX package's ``NamedSharding`` pairs
    them."""
    mesh: Mesh
    spec: P


def mesh_device(mesh: Mesh) -> torch.device:
    """The one device of a virtual mesh; a mesh over several devices
    raises (its placements come in the multi-card slice)."""
    devs = mesh.device_set()
    if len(devs) != 1:
        raise NotImplementedError(
            f"a mesh over several devices ({sorted(map(str, devs))}): "
            f"placements across cards come in the multi-card slice")
    return next(iter(devs))


def _data_axes(mesh: Mesh):
    return tuple(a for a in DATA_AXES if a in mesh.axis_names)


def _axis_size(mesh: Mesh, entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, (tuple, list)):
        return int(np.prod([mesh.shape[a] for a in entry]))
    return mesh.shape[entry]


def validate_spec(spec: P, shape: tuple, mesh: Mesh) -> P:
    """Drop sharding on any dim not divisible by its axis-group size (such
    a dim replicates instead)."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, parts[: len(shape)]):
        if entry is not None and dim % _axis_size(mesh, entry) != 0:
            entry = None
        out.append(entry)
    return P(*out)


def batch_spec(mesh: Mesh, shape: tuple) -> P:
    """Activations / token batches: batch dim over (pod, data), validated."""
    spec = P(_data_axes(mesh), *([None] * (len(shape) - 1)))
    return validate_spec(spec, tuple(shape), mesh)


# Rules matched against the *last* path components (innermost name wins);
# each value is the spec of the unstacked weight.
_RULES = [
    # attention projections
    (("attn", "wq"), P(None, MODEL_AXIS)),
    (("attn", "wk"), P(None, MODEL_AXIS)),
    (("attn", "wv"), P(None, MODEL_AXIS)),
    (("attn", "wo"), P(MODEL_AXIS, None)),
    (("cross", "wq"), P(None, MODEL_AXIS)),
    (("cross", "wk"), P(None, MODEL_AXIS)),
    (("cross", "wv"), P(None, MODEL_AXIS)),
    (("cross", "wo"), P(MODEL_AXIS, None)),
    # dense MLP
    (("mlp", "wi"), P(None, MODEL_AXIS)),
    (("mlp", "wg"), P(None, MODEL_AXIS)),
    (("mlp", "wo"), P(MODEL_AXIS, None)),
    # MoE: expert parallelism
    (("moe", "router"), P(None, None)),
    (("moe", "wi"), P(MODEL_AXIS, None, None)),
    (("moe", "wg"), P(MODEL_AXIS, None, None)),
    (("moe", "wo"), P(MODEL_AXIS, None, None)),
    # Griffin recurrent block
    (("rglru", "w_in"), P(None, MODEL_AXIS)),
    (("rglru", "w_gate"), P(None, MODEL_AXIS)),
    (("rglru", "w_rg"), P(None, MODEL_AXIS)),
    (("rglru", "w_ig"), P(None, MODEL_AXIS)),
    (("rglru", "w_out"), P(MODEL_AXIS, None)),
    (("rglru", "conv_w"), P(None, MODEL_AXIS)),
    (("rglru", "lam"), P(MODEL_AXIS)),
    # xLSTM
    (("mlstm", "w_up"), P(None, MODEL_AXIS)),
    (("mlstm", "w_gate"), P(None, MODEL_AXIS)),
    (("mlstm", "wq"), P(None, MODEL_AXIS)),
    (("mlstm", "wk"), P(None, MODEL_AXIS)),
    (("mlstm", "wv"), P(None, MODEL_AXIS)),
    (("mlstm", "w_if"), P(None, None)),
    (("mlstm", "w_down"), P(MODEL_AXIS, None)),
    (("mlstm", "skip_scale"), P(MODEL_AXIS)),
    (("slstm", "w_x"), P(None, MODEL_AXIS)),
    (("slstm", "r_h"), P(None, None, None)),   # block-diagonal, small
    (("slstm", "b"), P(None)),
    (("slstm", "w_up"), P(None, MODEL_AXIS)),
    (("slstm", "w_down"), P(MODEL_AXIS, None)),
    # embeddings / head
    (("embed",), P(MODEL_AXIS, None)),
    (("lm_head",), P(None, MODEL_AXIS)),
]


def _is_leaf(x) -> bool:
    return not isinstance(x, (dict, list, tuple)) or isinstance(
        x, (PackedWeight, PackedQKV, ColumnShards))


def map_with_path(fn, tree: Pytree, path: tuple = ()) -> Pytree:
    """``fn(path, leaf)`` over a tree of dicts and lists, ``path`` the
    tuple of dict keys and list indices (as strings) down to the leaf;
    ``PackedWeight``, ``PackedQKV`` and ``ColumnShards`` are leaves."""
    if _is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    return type(tree)(map_with_path(fn, v, path + (str(i),))
                      for i, v in enumerate(tree))


def _match(names: tuple) -> Optional[P]:
    filt = tuple(n for n in names if not n.isdigit())
    for pattern, spec in _RULES:
        if filt[-len(pattern):] == pattern:
            return spec
    return None


def _leaf_base_spec(names: tuple, ndim: int) -> P:
    """Rule-matched, rank-adjusted spec for one leaf (unvalidated)."""
    spec = _match(names)
    if spec is None:
        return P(*([None] * ndim))                  # norms, biases, scalars
    if len(spec) != ndim:
        parts = tuple(spec) + (None,) * max(0, ndim - len(spec))
        spec = P(*parts[:ndim])
    return spec


def _layer_period(tree: Pytree) -> int:
    """The period of ``tree["layers"]``' block pattern (of their sets of
    block names); 1 without layers."""
    layers = tree.get("layers") if isinstance(tree, dict) else None
    if not layers:
        return 1
    kinds = [tuple(sorted(lp)) for lp in layers]
    return next(p for p in range(1, len(kinds) + 1)
                if all(kinds[i] == kinds[i % p] for i in range(len(kinds))))


def _stacked_layers(tree: Pytree) -> int:
    """How many of ``tree["layers"]`` the JAX package stacks into its
    ``groups``: the whole periods of the layers' block pattern; the rest
    are its ``extra`` layers."""
    layers = tree.get("layers") if isinstance(tree, dict) else None
    if not layers:
        return 0
    period = _layer_period(tree)
    return len(layers) // period * period


def _scan_len(tree: Pytree, path: tuple) -> int:
    """The length of the JAX package's scan axis over the leaf at this
    port path (its ``groups`` count, or its encoder's layer count); 0 for
    a leaf the JAX package does not stack."""
    if path[:2] == ("encoder", "layers"):
        return len(tree["encoder"]["layers"])
    if path[:1] == ("layers",) and int(path[1]) < _stacked_layers(tree):
        return _stacked_layers(tree) // _layer_period(tree)
    return 0


def _stacked(path: tuple, n_stacked: int) -> bool:
    """Is the JAX package's leaf of this port path stacked along a scan
    axis (a ``groups`` layer's, or an encoder layer's)?"""
    if path[:2] == ("encoder", "layers"):
        return True
    return path[:1] == ("layers",) and int(path[1]) < n_stacked


def _leaf_demote_k(ndim: int, spec: P, stacked: bool) -> P:
    """Drop MODEL sharding from a weight's contraction (K) axis: ABFP tiles
    of width n must not straddle shards (see ``abfp_param_spec_tree``).
    As in the JAX package, the rule reads the leaf's rank with its scan
    axis: a stacked 1-D vector (RG-LRU's ``lam``) is demoted too."""
    parts = list(spec)
    if ndim + stacked >= 2 and parts and parts[0] == MODEL_AXIS:
        parts[0] = None
    return P(*parts)


def param_spec_tree(params: Pytree, mesh: Optional[Mesh] = None) -> Pytree:
    """Spec tree mirroring ``params`` (validated when ``mesh`` is given)."""

    def one(path, leaf):
        spec = _leaf_base_spec(path, leaf.ndim)
        if mesh is not None:
            spec = validate_spec(spec, tuple(leaf.shape), mesh)
        return spec

    return map_with_path(one, params)


def named_sharding_tree(params: Pytree, mesh: Mesh) -> Pytree:
    """``param_spec_tree(params)`` (unvalidated, as the JAX package's) on
    ``mesh``: a tree of ``NamedSharding``."""
    return map_with_path(
        lambda path, leaf: NamedSharding(
            mesh, _leaf_base_spec(path, leaf.ndim)), params)


def shard_params(params: Pytree, mesh: Mesh) -> Pytree:
    """Place a param tree on ``mesh`` by ``named_sharding_tree``'s specs:
    on a virtual mesh every leaf goes to the mesh's one device, whole."""
    dev = mesh_device(mesh)
    return map_with_path(lambda path, leaf: leaf.to(dev), params)


def abfp_param_spec_tree(params: Pytree,
                         mesh: Optional[Mesh] = None) -> Pytree:
    """Param specs for the ABFP numerics: the contraction (K) axis of every
    quantized matmul stays shard-local, so row-parallel specs (K over
    'model') are demoted to replicated; column-parallel specs stay."""
    n_stacked = _stacked_layers(params)

    def one(path, leaf):
        spec = _leaf_demote_k(leaf.ndim, _leaf_base_spec(path, leaf.ndim),
                              _stacked(path, n_stacked))
        if mesh is not None:
            spec = validate_spec(spec, tuple(leaf.shape), mesh)
        return spec

    return map_with_path(one, params)


def tp_route(path: tuple, shape: tuple, mesh: Mesh,
             demote: bool = False) -> str:
    """The route of the 2-D leaf at ``path`` (its tail is enough: the
    rules match the last names) on ``mesh``'s 'model' axis, as GSPMD
    partitions it under the JAX package's spec trees: its ``_RULES`` spec,
    with ``demote`` the ABFP tree's (``_leaf_demote_k``: no 'model' on the
    contraction axis), validated (``validate_spec``): ``ops.COLUMN`` when
    'model' is on its columns, ``ops.ROW`` when on its rows (an embedding
    table's vocab), else ``ops.WHOLE``."""
    if tp_size(mesh) <= 1 or len(shape) != 2:
        return WHOLE
    spec = _leaf_base_spec(tuple(path), 2)
    if demote:
        spec = _leaf_demote_k(2, spec, False)
    spec = validate_spec(spec, tuple(shape), mesh)
    if spec[1] == MODEL_AXIS:
        return COLUMN
    if spec[0] == MODEL_AXIS:
        return ROW
    return WHOLE


def model_split(mesh: Optional[Mesh], quant) -> Optional[ModelSplit]:
    """The mesh forward's 'model' split for numerics ``quant``: routes by
    ``param_spec_tree``'s rules, or ``abfp_param_spec_tree``'s in
    ``abfp_ref`` mode (the kernel modes' dense calls stay whole:
    ``ModelSplit.dense_route``); None without a mesh or at model 1."""
    tp = tp_size(mesh)
    if tp <= 1:
        return None
    demote = quant.mode != "float"
    return ModelSplit(tp, quant, lambda path, shape: tp_route(
        path, shape, mesh, demote))


# ---------------------------------------------------------------------------
# Serving placement: packed / float param trees and the decode state
# ---------------------------------------------------------------------------


def serving_param_spec_tree(params: Pytree, mesh: Mesh,
                            quant: Any = None) -> Pytree:
    """Column-parallel-only specs for a serving param tree (float or
    packed).  Float leaves follow the ABFP rules (output features over
    'model', K-sharding demoted); a ``PackedWeight``'s spec is a
    ``PackedWeight`` of specs whose codes and scales share one spec (the
    per-(tile, column) scales travel with their codes) and whose gains
    (they index K) replicate.  Shard or replicate is decided by the
    dispatch's predicate (``kernels.ops.tp_col_quantum`` at ``quant``;
    without it the noise-safe quantum, whole 128-lane blocks per shard,
    for packed weights).  A ``PackedQKV`` (the fused QKV's pack-time
    concatenation, rebuilt per shard by ``shard_serving_params``) gets
    None; a weight placed already (``ColumnShards``) keeps its columns
    over 'model'."""
    tp = tp_size(mesh)
    n_stacked = _stacked_layers(params)

    def col_quantum(packed: bool) -> Optional[int]:
        if quant is not None:
            return tp_col_quantum(quant, packed, tp)
        return tp * _LANE if packed else tp

    def one(path, leaf):
        if isinstance(leaf, PackedQKV):
            return None
        if isinstance(leaf, ColumnShards):
            return P(None, MODEL_AXIS)
        if isinstance(leaf, PackedWeight):
            lead = leaf.codes.ndim - 2
            q = col_quantum(True)
            col = (MODEL_AXIS
                   if tp > 1 and q is not None and leaf.n_padded % q == 0
                   else None)
            cs = P(*((None,) * (lead + 1)), col)
            gs = (None if leaf.gains is None
                  else P(*((None,) * leaf.gains.ndim)))
            return PackedWeight(cs, cs, leaf.k, leaf.n_cols,
                                leaf.tile_width, leaf.bits_w, gains=gs)
        spec = _leaf_demote_k(leaf.ndim, _leaf_base_spec(path, leaf.ndim),
                              _stacked(path, n_stacked))
        spec = validate_spec(spec, tuple(leaf.shape), mesh)
        parts = tuple(spec) + (None,) * (leaf.ndim - len(spec))
        if parts and parts[-1] == MODEL_AXIS:
            q = col_quantum(False)
            if q is None or leaf.shape[-1] % q != 0:
                spec = P(*parts[:-1], None)
        return spec

    return map_with_path(one, params)


def _column_sharded(spec) -> bool:
    if isinstance(spec, PackedWeight):
        spec = spec.codes
    return bool(spec) and spec[-1] == MODEL_AXIS


def shard_serving_params(params: Pytree, mesh: Mesh,
                         quant: Any = None) -> Pytree:
    """Place a serving param tree on ``mesh``: every dense weight (a 2-D
    ``PackedWeight``, or a 2-D float leaf named as a ``Numerics.dense``
    operand) whose spec puts 'model' on its columns becomes a
    ``kernels.ops.ColumnShards`` of ``tp`` local weights (codes, kernel
    codes and scales split together, gains whole), which ``dense_tp``
    runs shard by shard; every other leaf stays whole.  An attention
    block's ``PackedQKV`` is rebuilt per shard (a tuple of ``tp``
    concatenations of the local wq, wk, wv) when all three shard, and
    dropped otherwise (the fused QKV then makes three ``dense_tp``
    calls).  At tp 1 the tree is returned as it is."""
    tp = tp_size(mesh)
    if tp <= 1:
        return params
    specs = serving_param_spec_tree(params, mesh, quant)

    def walk(node, spec, name=None):
        if isinstance(node, dict):
            out = {k: walk(v, spec[k], k) for k, v in node.items()}
            if isinstance(out.get("qkv"), PackedQKV):
                parts = [out[w] for w in ("wq", "wk", "wv")]
                if quant is not None and all(
                        isinstance(p, ColumnShards) for p in parts):
                    out["qkv"] = tuple(
                        concat_qkv([p.shards[t] for p in parts], quant)
                        for t in range(tp))
                else:
                    del out["qkv"]
            return out
        if isinstance(node, list):
            return [walk(v, s, name) for v, s in zip(node, spec)]
        dense = (isinstance(node, PackedWeight) and node.codes.ndim == 2) or (
            isinstance(node, torch.Tensor) and node.ndim == 2
            and name in DENSE_WEIGHT_NAMES)
        if dense and _column_sharded(spec):
            return shard_columns(node, tp)
        return node

    return walk(params, specs)


def serving_state_spec_tree(state: Pytree, mesh: Mesh) -> Pytree:
    """Decode-state specs for serving: the slot (batch) axis over the data
    axes, everything else replicated; paged pools (their leading axis is
    the global page pool) replicate whole.  No state axis goes on
    'model': activations are whole between column-parallel matmuls."""
    dp = _data_axes(mesh)

    def one(path, leaf):
        if path[-1].endswith("_pages") or leaf.ndim == 0:
            return P(*([None] * leaf.ndim))
        core = (dp,) + (None,) * (leaf.ndim - 1)
        return validate_spec(P(*core), tuple(leaf.shape), mesh)

    return map_with_path(one, state)


def shard_decode_state(state: Pytree, mesh: Mesh) -> Pytree:
    """Place a decode state on ``mesh`` by ``serving_state_spec_tree``'s
    specs: on a virtual mesh every tensor goes to the mesh's one device,
    whole."""
    dev = mesh_device(mesh)
    return map_with_path(lambda path, leaf: leaf.to(dev), state)


def decode_state_spec_tree(state: Pytree, mesh: Mesh) -> Pytree:
    """Spec tree for a ``models.init_decode_state`` tree: batch over (pod,
    data); the widest per-token axis over 'model' when divisible (KV
    heads, else head_dim; recurrent state width; mLSTM head dim)."""
    dp = _data_axes(mesh)
    mp = mesh.shape[MODEL_AXIS]

    def one(path, leaf):
        name = path[-1]
        nd = leaf.ndim
        shape = tuple(leaf.shape)
        if name in ("length", "position"):
            core = (dp,)
        elif name in ("k", "v"):                   # (B, S, KH, HD)
            if shape[2] % mp == 0:
                core = (dp, None, MODEL_AXIS, None)
            elif shape[3] % mp == 0:
                core = (dp, None, None, MODEL_AXIS)
            else:
                core = (dp, None, None, None)
        elif name == "conv":                       # (B, W-1, R)
            core = (dp, None, MODEL_AXIS if shape[2] % mp == 0 else None)
        elif name == "C":                          # (B, NH, dh, dh)
            core = (dp, None, MODEL_AXIS if shape[2] % mp == 0 else None,
                    None)
        elif nd == 3:                              # h/c/n/m (B, NH, dh)
            core = (dp, None, MODEL_AXIS if shape[2] % mp == 0 else None)
        elif nd == 2:                              # h (B, R) / m (B, NH)
            core = (dp, MODEL_AXIS if shape[1] % mp == 0 else None)
        else:
            core = (dp,) + (None,) * (nd - 1)
        return validate_spec(P(*core), shape, mesh)

    return map_with_path(one, state)


# ---------------------------------------------------------------------------
# ZeRO-1: optimizer state also sharded over the data axis
# ---------------------------------------------------------------------------


def zero1_spec(spec: P, shape: tuple, mesh: Mesh) -> P:
    """Extend a param spec with 'data' sharding on the largest replicated,
    divisible axis (optimizer moments / master weights only)."""
    if "data" not in mesh.axis_names:
        return spec
    dp = mesh.shape["data"]
    parts = list(spec) + [None] * (len(shape) - len(spec))
    best, best_size = None, 0
    for i, (p, s) in enumerate(zip(parts, shape)):
        if p is None and s % dp == 0 and s > best_size:
            best, best_size = i, s
    if best is None:
        return spec
    parts[best] = "data"
    return P(*parts)


def zero1_state_sharding(params: Pytree, mesh: Mesh,
                         specs: Optional[Pytree] = None) -> Pytree:
    """``NamedSharding`` tree for the f32 moments and masters mirroring
    ``params``: each leaf's param spec (unvalidated) extended by
    ``zero1_spec``.  As in the JAX package the rule reads a stacked
    leaf's shape with its scan axis, which it may pick for 'data': that
    entry is then the scan axis's, and the port's leaf keeps the rest.
    ``specs`` (a spec tree mirroring ``params``) replaces the rule's
    specs: the dry run extends its validated ones, as the JAX package's
    dry run does."""

    def one(path, leaf):
        spec, shape = (_leaf_base_spec(path, leaf.ndim) if specs is None
                       else _at(specs, path)), tuple(leaf.shape)
        scan = _scan_len(params, path)
        if scan:
            spec = P(*zero1_spec(P(None, *spec), (scan,) + shape,
                                 mesh)[1:])
        else:
            spec = zero1_spec(spec, shape, mesh)
        return NamedSharding(mesh, spec)

    return map_with_path(one, params)


def _at(tree: Pytree, path: tuple):
    """The node of ``tree`` at ``map_with_path``'s ``path``."""
    for k in path:
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree
