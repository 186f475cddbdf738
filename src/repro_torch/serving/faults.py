"""Fault injection, detection and repair for the analog serving stack.

The paper's premise is that analog hardware drifts and breaks, and analog
faults are STRUCTURED: a dead column driver kills one output column,
conductance drift scales one tile's effective weights.  Structured faults
are detectable and recoverable.  This is the port's copy of the JAX
package's ``serving/faults.py``.

Fault model (``FAULT_KINDS``)
-----------------------------
  * ``stuck_col``   — stuck-at-zero output columns: the column's codes AND
    scales are zeroed (a dead column driver contributes nothing).
  * ``scale_drift`` — per-(tile, col) multiplicative drift on the
    ``PackedWeight`` scales, drawn outside the bf16 scale-storage
    tolerance so every drift is detectable.
  * ``shard_drop``  — a whole model-axis shard dies: on a mesh, every
    weight the JAX package's ``tp_shardable`` splits loses the shard's
    columns (a ``ColumnShards`` leaf its whole shard), and replicated
    weights survive; without a mesh the array dies and every site loses
    all its columns (the JAX package's single-array branch).

Sites
-----
A site is one dense weight of the JAX package's param tree, addressed by
its path, and the walk gives JAX's paths for every family.  JAX stacks
the layers of block-pattern position ``j`` on a leading axis under
``groups/j``, keeps the remainder layers (a pattern that does not divide
the depth) under ``extra/r`` and stacks an encoder's layers under
``encoder/layers``; the port keeps per-layer lists (``models.convert``).
So a ``groups/j/<block>/<name>`` site is the leaf ``<block>/<name>`` of
every layer ``g * len(pattern) + j``, ``extra/r/...`` the one remainder
layer ``n_groups * len(pattern) + r``, and ``encoder/layers/...`` every
encoder layer; a fault on a site lands in all of them, as JAX's
``.at[..., idx]`` does on the stacked leaf.  The pattern's length is the
period of the layers' block kinds (no registered pattern repeats within
itself).  An MoE block's packed ``wi``/``wg``/``wo`` are lists of E
``PackedWeight``s in the port and one stacked (E, K, N) leaf in JAX: the
site holds every expert of every layer (an unpacked (E, K, N) weight is
one leaf).  Sites come sorted by path, so ``make_fault_plan`` draws
JAX's events from the same seed.  The ``qkv`` entry
(``models.packing``) is not a site.  On a mesh a served weight may be a
``kernels.ops.ColumnShards`` (``distributed.sharding``): its site is the
whole weight, a column ``c`` lives in shard ``c // shard_cols``, and its
fingerprint is the shards' concatenated; the layer's ``qkv`` is then a
tuple of one ``PackedQKV`` per shard.

Injection and repair are in place
---------------------------------
The port keeps three copies of every packed weight that a fault must
reach: ``PackedWeight.codes`` (the plain versions read it), its
kernel-layout ``kcodes`` (kernel 1 reads it) and, for wq/wk/wv in
``abfp_fused`` mode, the layer's ``PackedQKV`` concatenation (kernel 2
reads it, the three pieces at column offsets 0, ``n_padded(wq)`` and
``n_padded(wq) + n_padded(wk)``).  Every write goes to all three, with
in-place ops (``index_fill_``, ``index_put_``, ``index_copy_``,
``copy_``) on the served tensors: a captured CUDA graph holds the
tensors' addresses, so a rebound tensor would leave its replays on the
old weights.  The writes are enqueued on the current (serving) stream, so
passes already in flight read the old values, as JAX's immutable arrays
give them.  Gains stay, as in JAX.  A float site rewrites its weight.

Plans are deterministic: ``make_fault_plan(params, cfg, tp)`` draws
every event (tick, kind, site, columns, tiles, drift factors, the lost
shard of a ``tp``-way model axis) from one seeded numpy generator, so
a trace replays exactly across runs and recovery settings.

Detection
---------
``site_fingerprint`` reduces each site to the per-(tile, col) probe
response ``R[t, j] = sum_i |codes[t, i, j]| * delta_w * scales[t, j]``
(``core.abfp.packed_tile_fingerprint``), per leaf on the device, summed
over the site's leaves in (layer, expert) order; ``fingerprint_round`` fetches a round of
sites in ONE device-to-host copy.  ``detect_site`` compares a fingerprint
with the healthy baseline taken at engine init: a relative deviation
beyond ``drift_detect_rtol`` flags a drifted tile; a column whose every
tile reads exactly zero against a nonzero baseline is stuck.

Repair (the engine drives it, ``serving.engine``)
-------------------------------------------------
  * ``repair_drift``  — restore ONLY the drifted (tile, col) scales from
    the clean spare (weights packed once at init: the spare IS the
    re-quantization);
  * ``repair_stuck``  — re-program the stuck columns' codes and scales
    from the spare;
  * ``restore_sites`` — re-program every site from the spare (shard-drop
    recovery).
The spare (``clone_sites``) is a device clone of every site's codes,
kcodes and scales and of each ``PackedQKV``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.abfp import (
    PackedWeight,
    packed_tile_fingerprint,
    scale_storage_eps,
)
from repro_torch.kernels.abfp_decode_fused import PackedQKV
from repro_torch.kernels.ops import ColumnShards, tp_shardable
from repro_torch.models.packing import DENSE_WEIGHT_NAMES

Tensor = torch.Tensor

FAULT_KINDS = ("stuck_col", "scale_drift", "shard_drop")

# Drift factors are drawn from [0.75, 0.95] and [1.05, 1.25]: far outside
# the bf16 scale-storage quantum (about 0.4 % relative), so every injected
# drift is detectable by the fingerprint probe at the default tolerance.
_DRIFT_LO, _DRIFT_HI = 0.05, 0.25

_QKV = ("wq", "wk", "wv")


def drift_detect_rtol() -> float:
    """Default detection tolerance: 4x the bf16 scale-storage quantum, far
    below the smallest injected drift (5 %), far above storage noise."""
    return 4.0 * scale_storage_eps()


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Seeded fault-injection spec the engine turns into a concrete plan.

    ``rate`` is the PER-TICK fault probability: each engine tick, one
    fault event lands somewhere in the array (site uniform over the dense
    weights, kind uniform over the enabled kinds) with probability
    ``rate``.  When ``rate > 0`` the plan always holds at least one event
    inside ``horizon`` (the schedule's length in ticks).
    ``max_shard_drops`` caps whole-array events per plan.
    """

    rate: float = 0.01
    kinds: Tuple[str, ...] = FAULT_KINDS
    seed: int = 0
    horizon: int = 512
    max_cols_per_event: int = 2
    max_tiles_per_event: int = 4
    max_shard_drops: int = 1

    def __post_init__(self):
        unknown = set(self.kinds) - set(FAULT_KINDS)
        if unknown:
            raise ValueError(
                f"unknown fault kinds {sorted(unknown)}; "
                f"expected a subset of {FAULT_KINDS}")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1] (got {self.rate})")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    tick: int                       # engine tick at which the fault lands
    kind: str                       # one of FAULT_KINDS
    path: str                       # site path ('' = shard_drop)
    cols: Tuple[int, ...] = ()      # stuck_col: logical output columns
    tiles: Tuple[Tuple[int, int], ...] = ()  # scale_drift: (tile, col)
    factors: Tuple[float, ...] = ()          # scale_drift: multipliers
    shard: int = -1                 # shard_drop: model-axis shard index


@dataclasses.dataclass
class FaultPlan:
    """A concrete, seeded fault trace: events sorted by tick."""

    events: List[FaultEvent]
    cfg: FaultConfig

    def due(self, tick: int, cursor: int) -> Tuple[List[FaultEvent], int]:
        """Events with ``event.tick <= tick`` starting at ``cursor``;
        returns (events, new cursor): the engine keeps the cursor so each
        event is applied exactly once."""
        out = []
        while cursor < len(self.events) and self.events[cursor].tick <= tick:
            out.append(self.events[cursor])
            cursor += 1
        return out, cursor


# ---------------------------------------------------------------------------
# Fault sites: the JAX package's paths over the port's per-layer leaves
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultSite:
    path: str
    packed: bool
    n_cols: int         # logical (un-padded) output columns
    n_padded: int       # storage columns (lane-aligned for packed)
    n_tiles: int        # ABFP K-tiles (1 for float sites)


def _group_len(layers: List[dict]) -> int:
    """The block pattern's length: the period of the layers' kinds (each
    layer's set of block names)."""
    kinds = [tuple(sorted(lp)) for lp in layers]
    return next(p for p in range(1, len(kinds) + 1)
                if all(kinds[i] == kinds[i % p] for i in range(len(kinds))))


def _layer_roots(params: Any) -> List[Tuple[str, List[dict]]]:
    """Every stacked layer root of the JAX package's tree, as (its path,
    the port's layers it stacks, in order): ``groups/j``, ``extra/r`` and
    ``encoder/layers``."""
    out = []
    layers = params.get("layers") or []
    if layers:
        glen = _group_len(layers)
        n_groups = len(layers) // glen
        for j in range(glen):
            out.append((f"groups/{j}",
                        [layers[g * glen + j] for g in range(n_groups)]))
        for r in range(len(layers) - n_groups * glen):
            out.append((f"extra/{r}", [layers[n_groups * glen + r]]))
    enc = (params.get("encoder") or {}).get("layers")
    if enc:
        out.append(("encoder/layers", list(enc)))
    return out


def fault_sites(params: Any) -> List[FaultSite]:
    """The faultable dense weights, sorted by path: every packed leaf (an
    MoE block's list of packed experts is one site), and every float leaf
    of >= 2 dims named as a dense-matmul weight
    (``models.packing.DENSE_WEIGHT_NAMES``).  A stacked site is enumerated
    once, from its first layer, under the JAX package's path."""
    sites: List[FaultSite] = []

    def visit(path: str, node, name: str):
        if isinstance(node, list) and node and isinstance(
                node[0], (PackedWeight, ColumnShards)):
            node = node[0]          # the experts share one geometry
        if isinstance(node, ColumnShards):
            sites.append(FaultSite(
                path, node.packed, node.n_cols, node.n_padded,
                node.shards[0].num_tiles if node.packed else 1))
        elif isinstance(node, PackedWeight):
            sites.append(FaultSite(path, True, node.n_cols, node.n_padded,
                                   node.num_tiles))
        elif isinstance(node, dict):
            for k, v in node.items():
                visit(f"{path}/{k}", v, k)
        elif (isinstance(node, Tensor) and name in DENSE_WEIGHT_NAMES
                and node.ndim >= 2):
            n = int(node.shape[-1])
            sites.append(FaultSite(path, False, n, n, 1))

    for prefix, layers in _layer_roots(params):
        visit(prefix, layers[0], prefix)
    for k, v in params.items():
        if k == "encoder":
            v = {n: x for n, x in v.items() if n != "layers"}
        if k != "layers":
            visit(k, v, k)
    return sorted(sites, key=lambda s: s.path)


@dataclasses.dataclass(frozen=True)
class _Leaf:
    """One served leaf of a site, with its layer's ``PackedQKV`` and the
    leaf's column offset in it (wq/wk/wv in ``abfp_fused`` mode).  On a
    mesh the leaf may be a ``ColumnShards`` and ``qkv`` a tuple of one
    ``PackedQKV`` per shard (``off`` the local offset in each)."""
    leaf: Any                       # PackedWeight, float Tensor, shards
    qkv: Any = None
    off: int = 0


def _parts(e: _Leaf) -> List[Tuple[_Leaf, int, int]]:
    """The stored pieces of a site leaf, as (piece, its first column of
    the whole weight, its columns of the whole weight): the leaf itself,
    or each shard of a ``ColumnShards`` with its own ``PackedQKV``."""
    if not isinstance(e.leaf, ColumnShards):
        return [(e, 0, _stored_cols(e.leaf))]
    w = e.leaf.shard_cols
    return [(_Leaf(sh, None if e.qkv is None else e.qkv[t], e.off), t * w, w)
            for t, sh in enumerate(e.leaf.shards)]


def _stored_cols(leaf) -> int:
    return leaf.n_padded if isinstance(leaf, PackedWeight) else int(
        leaf.shape[-1])


def _local(cols: Sequence[int], first: int, width: int) -> List[int]:
    """The columns of ``cols`` in ``[first, first + width)``, relative to
    ``first``."""
    return [int(c) - first for c in cols if first <= c < first + width]


def _leaves(params: Any, path: str) -> List[_Leaf]:
    """Every leaf of the site at ``path``, in (layer, expert) order: one
    per layer (per expert of each layer for a packed MoE weight) for a
    stacked path, else the one leaf.  KeyError if none."""
    for prefix, roots in _layer_roots(params):
        if path.startswith(prefix + "/"):
            parts = path[len(prefix) + 1:].split("/")
            break
    else:
        roots, parts = [params], path.split("/")
    out = []
    for node in roots:
        parent = node
        try:
            for p in parts[:-1]:
                parent = parent[p]
            leaf = parent[parts[-1]]
        except (KeyError, TypeError):
            raise KeyError(f"no param leaf at {path!r}") from None
        if isinstance(leaf, list):
            out.extend(_Leaf(x) for x in leaf)
            continue
        qkv, off = parent.get("qkv"), 0
        if isinstance(qkv, (PackedQKV, tuple)) and parts[-1] in _QKV:
            pws = (qkv if isinstance(qkv, PackedQKV) else qkv[0]).pws
            off = sum(pw.n_padded for pw in pws[:_QKV.index(parts[-1])])
        else:
            qkv = None
        out.append(_Leaf(leaf, qkv, off))
    if not out:
        raise KeyError(f"no param leaf at {path!r}")
    return out


def site_leaves(params: Any, path: str) -> List[Any]:
    """The served leaves of the site at ``path``, in (layer, expert)
    order: the rows of JAX's stacked leaf with its leading axes
    flattened."""
    return [e.leaf for e in _leaves(params, path)]


# ---------------------------------------------------------------------------
# Plan generation: one seeded generator draws the whole trace
# ---------------------------------------------------------------------------


def make_fault_plan(params: Any, cfg: FaultConfig,
                    tp: int = 1) -> FaultPlan:
    """Draw a deterministic fault trace for ``params``: the JAX package's
    ``make_fault_plan``, draw for draw.

    Each tick faults with probability ``cfg.rate`` (site uniform over the
    dense weights, kind uniform over the available kinds); when ``rate >
    0`` at least one event lands within the horizon.  ``scale_drift``
    applies to packed sites only; ``shard_drop`` fires at most
    ``max_shard_drops`` times and targets a uniform model-axis shard in
    [0, tp).
    """
    rng = np.random.default_rng(cfg.seed)
    sites = fault_sites(params)
    events: List[FaultEvent] = []
    if not sites or cfg.rate <= 0.0:
        return FaultPlan([], cfg)

    shard_drops = 0
    fault_ticks = list(np.flatnonzero(rng.random(cfg.horizon) < cfg.rate))
    if not fault_ticks:
        # rate > 0 must inject something: one early event, so a short
        # trace at a tiny rate still measures fault handling.
        fault_ticks = [min(8, cfg.horizon - 1)]
    for tick in fault_ticks:
        tick = int(tick)
        site = sites[int(rng.integers(len(sites)))]
        kinds = [k for k in cfg.kinds
                 if not (k == "scale_drift" and not site.packed)]
        if shard_drops >= cfg.max_shard_drops:
            kinds = [k for k in kinds if k != "shard_drop"]
        if not kinds:
            continue
        kind = kinds[int(rng.integers(len(kinds)))]
        if kind == "stuck_col":
            n = int(rng.integers(1, cfg.max_cols_per_event + 1))
            cols = rng.choice(site.n_cols, size=min(n, site.n_cols),
                              replace=False)
            events.append(FaultEvent(tick, kind, site.path,
                                     cols=tuple(int(c) for c in cols)))
        elif kind == "scale_drift":
            n = int(rng.integers(1, cfg.max_tiles_per_event + 1))
            ts = rng.integers(0, site.n_tiles, size=n)
            js = rng.integers(0, site.n_cols, size=n)
            mag = rng.uniform(_DRIFT_LO, _DRIFT_HI, size=n)
            sgn = rng.choice([-1.0, 1.0], size=n)
            f = 1.0 + sgn * mag
            pairs = tuple(sorted({(int(t), int(j))
                                  for t, j in zip(ts, js)}))
            events.append(FaultEvent(
                tick, kind, site.path, tiles=pairs,
                factors=tuple(float(v) for v in f[:len(pairs)])))
        else:   # shard_drop
            shard_drops += 1
            events.append(FaultEvent(tick, kind, "",
                                     shard=int(rng.integers(max(1, tp)))))
    events.sort(key=lambda e: (e.tick, e.path, e.kind))
    return FaultPlan(events, cfg)


# ---------------------------------------------------------------------------
# Injection: in-place rewrites of the served operands (all three copies)
# ---------------------------------------------------------------------------


def _index(values: Sequence[int], device) -> Tensor:
    return torch.as_tensor(list(values), dtype=torch.long, device=device)


def _device(e: _Leaf):
    return (e.leaf.codes if isinstance(e.leaf, PackedWeight)
            else e.leaf).device


def _zero_cols(e: _Leaf, cols: Sequence[int]) -> None:
    for part, first, width in _parts(e):
        local = _local(cols, first, width)
        if local:
            _zero_piece_cols(part, local)


def _zero_piece_cols(e: _Leaf, cols: Sequence[int]) -> None:
    idx = _index(cols, _device(e))
    if not isinstance(e.leaf, PackedWeight):
        e.leaf.index_fill_(-1, idx, 0)
        return
    for t in (e.leaf.codes, e.leaf.scales, e.leaf.kcodes):
        if t is not None:
            t.index_fill_(1, idx, 0)
    if e.qkv is not None:
        e.qkv.kcodes.index_fill_(1, idx + e.off, 0)
        e.qkv.scales.index_fill_(1, idx + e.off, 0)


def inject_stuck_cols(params: Any, path: str, cols: Sequence[int]) -> None:
    """Stuck-at-zero output columns in every leaf of the site: codes,
    kcodes and scales zeroed (packed), or the weight columns (float)."""
    for e in _leaves(params, path):
        _zero_cols(e, cols)


def inject_scale_drift(params: Any, path: str,
                       tiles: Sequence[Tuple[int, int]],
                       factors: Sequence[float]) -> None:
    """Multiply the (tile, col) scales of every leaf of the site by their
    drift factors: an f32 product rounded to the bf16 storage (conductance
    drift re-read through the same DACs)."""
    for e in _leaves(params, path):
        for part, first, width in _parts(e):
            if not isinstance(part.leaf, PackedWeight):
                raise ValueError(
                    f"scale_drift targets PackedWeight (got {path})")
            mine = [(p, f) for p, f in zip(tiles, factors)
                    if first <= p[1] < first + width]
            if not mine:
                continue
            s = part.leaf.scales
            t = _index([p[0] for p, _ in mine], s.device)
            j = _index([p[1] - first for p, _ in mine], s.device)
            f = torch.as_tensor([f for _, f in mine], dtype=torch.float32,
                                device=s.device)
            new = (s[t, j].float() * f).to(s.dtype)
            s.index_put_((t, j), new)
            if part.qkv is not None:
                part.qkv.scales.index_put_((t, j + part.off), new)


def _jax_shardable(params: Any, site: FaultSite, quant, mesh) -> bool:
    """The JAX package's ``tp_shardable`` on the site's own leaf: never
    for a leaf it stacks (a ``groups`` or encoder layer's, an MoE expert
    stack: more than two dims), else the dispatch's rule on the port's
    leaf (a ``ColumnShards`` of the mesh's shard count is split)."""
    if site.path.startswith(("groups/", "encoder/layers/")):
        return False
    leaves_ = _leaves(params, site.path)
    if len(leaves_) != 1:
        return False
    leaf = leaves_[0].leaf
    if isinstance(leaf, Tensor) and leaf.ndim != 2:
        return False
    return tp_shardable(leaf, quant, mesh)


def inject_shard_drop(params: Any, shard: int = 0, tp: int = 1,
                      quant=None, mesh=None) -> None:
    """Model-axis shard ``shard`` of a ``tp``-way mesh dies: every weight
    that the JAX package's ``tp_shardable`` splits at this mesh loses
    that shard's columns (a ``ColumnShards`` leaf its whole shard, the
    QKV concatenation's segment included), and replicated weights
    survive.  ``tp <= 1`` (or no mesh) is the JAX package's single-array
    branch: the array dies and every site loses all its columns."""
    for site in fault_sites(params):
        if tp <= 1 or mesh is None:
            cols = range(site.n_padded)
        elif quant is not None and not _jax_shardable(params, site, quant,
                                                      mesh):
            continue                    # replicated: survives the loss
        else:
            width = site.n_padded // tp
            cols = range(shard * width, (shard + 1) * width)
        for e in _leaves(params, site.path):
            _zero_cols(e, cols)


def apply_event(params: Any, ev: FaultEvent, *, tp: int = 1, quant=None,
                mesh=None) -> None:
    """Inject one event into ``params``, in place (``tp``, ``quant`` and
    ``mesh`` locate a shard drop's columns)."""
    if ev.kind == "stuck_col":
        inject_stuck_cols(params, ev.path, ev.cols)
    elif ev.kind == "scale_drift":
        inject_scale_drift(params, ev.path, ev.tiles, ev.factors)
    elif ev.kind == "shard_drop":
        inject_shard_drop(params, ev.shard, tp, quant=quant, mesh=mesh)
    else:
        raise ValueError(f"unknown fault kind {ev.kind!r}")


# ---------------------------------------------------------------------------
# Detection: fingerprint probes against the healthy baseline
# ---------------------------------------------------------------------------


def _site_fingerprint_dev(params: Any, site: FaultSite) -> Tensor:
    """A site's (T, Np) f32 fingerprint on the device: each leaf's, summed
    over the leaves in (layer, expert) order.  Float sites: the column L1
    norm, shaped (1, N)."""
    acc = None
    for e in _leaves(params, site.path):
        fp = torch.cat([_piece_fingerprint(part.leaf)[:, :width]
                        for part, _, width in _parts(e)], dim=1)
        acc = fp if acc is None else acc + fp
    return acc


def _piece_fingerprint(leaf) -> Tensor:
    if isinstance(leaf, PackedWeight):
        return packed_tile_fingerprint(leaf)
    return torch.sum(leaf.abs(), dim=tuple(range(leaf.ndim - 1)),
                     dtype=torch.float32)[None, :]


def fingerprint_round(params: Any,
                      sites: Sequence[FaultSite]) -> Dict[str, np.ndarray]:
    """Every site's fingerprint as host f32, fetched in one device-to-host
    copy."""
    fps = [_site_fingerprint_dev(params, s) for s in sites]
    if not fps:
        return {}
    host = torch.cat([f.reshape(-1) for f in fps]).cpu().numpy()
    out, at = {}, 0
    for s, f in zip(sites, fps):
        out[s.path] = host[at:at + f.numel()].reshape(f.shape)
        at += f.numel()
    return out


def site_fingerprint(params: Any, site: FaultSite) -> np.ndarray:
    """Per-(tile, col) probe response of one site, as host f32 (T, Np)
    (float sites (1, N))."""
    return fingerprint_round(params, [site])[site.path]


@dataclasses.dataclass
class Detection:
    """One detection round's verdict for one site."""

    path: str
    stuck_cols: Tuple[int, ...]                 # dead columns
    drifted: Tuple[Tuple[int, int], ...]        # drifted (tile, col)

    @property
    def clean(self) -> bool:
        return not self.stuck_cols and not self.drifted


def detect_site(baseline: np.ndarray, current: np.ndarray,
                rtol: Optional[float] = None) -> Detection:
    """Compare fingerprints: exact-zero columns against a nonzero baseline
    are stuck; other relative deviations beyond ``rtol`` are drift."""
    rtol = drift_detect_rtol() if rtol is None else rtol
    base = np.maximum(baseline, 1e-30)
    rel = np.abs(current - baseline) / base
    # Stuck = every tile that HAD signal now reads exactly zero (tiles
    # whose baseline was already zero carry no information either way).
    dead_or_silent = (current == 0.0) | (baseline == 0.0)
    col_alive_base = (baseline > 0.0).any(axis=0)
    stuck = np.flatnonzero(dead_or_silent.all(axis=0) & col_alive_base)
    stuck_set = set(int(c) for c in stuck)
    drifted = [(int(t), int(j)) for t, j in zip(*np.nonzero(rel > rtol))
               if j not in stuck_set]
    return Detection("", tuple(sorted(stuck_set)), tuple(sorted(drifted)))


# ---------------------------------------------------------------------------
# Repair: restore from the clean spare, in place
# ---------------------------------------------------------------------------


def clone_sites(params: Any) -> Any:
    """The clean spare: a device clone of every fault site (codes, kcodes
    and scales; float weights) and of each layer's ``PackedQKV``, in the
    params' nesting, so ``site_leaves`` addresses it as it does the
    params.  Every other leaf, and the gains, are shared: no fault touches
    them.  A ``ColumnShards`` is cloned shard by shard, a per-shard
    ``qkv`` tuple ``PackedQKV`` by ``PackedQKV``."""
    def clone_qkv(qkv, pws):
        return PackedQKV(kcodes=qkv.kcodes.clone(),
                         scales=qkv.scales.clone(), gains=qkv.gains,
                         pws=tuple(pws))

    def walk(node, name):
        if isinstance(node, PackedWeight):
            return dataclasses.replace(
                node, codes=node.codes.clone(), scales=node.scales.clone(),
                kcodes=None if node.kcodes is None else node.kcodes.clone())
        if isinstance(node, ColumnShards):
            return dataclasses.replace(node, shards=tuple(
                walk(sh, name) if isinstance(sh, PackedWeight)
                else sh.clone() for sh in node.shards))
        if isinstance(node, dict):
            out = {k: walk(v, k) for k, v in node.items()}
            qkv = node.get("qkv")
            if isinstance(qkv, PackedQKV):
                out["qkv"] = clone_qkv(qkv, (out[w] for w in _QKV))
            elif isinstance(qkv, tuple):
                out["qkv"] = tuple(
                    clone_qkv(q, (out[w].shards[t] for w in _QKV))
                    for t, q in enumerate(qkv))
            return out
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        if (isinstance(node, Tensor) and name in DENSE_WEIGHT_NAMES
                and node.ndim >= 2):
            return node.clone()
        return node

    return walk(params, None)


def _pairs(params: Any, clean: Any, path: str):
    """(served piece, spare piece, first column, columns) of every stored
    piece of the site's leaves (``_parts``)."""
    for e, c in zip(_leaves(params, path), _leaves(clean, path)):
        for (pe, first, width), (pc, _, _) in zip(_parts(e), _parts(c)):
            yield pe, pc, first, width


def repair_stuck(params: Any, clean: Any, path: str,
                 cols: Sequence[int]) -> None:
    """Remap stuck columns onto the spare: re-program codes, kcodes and
    scales (or float columns) of exactly those columns, in every leaf."""
    for e, c, first, width in _pairs(params, clean, path):
        local = _local(cols, first, width)
        if not local:
            continue
        idx = _index(local, _device(e))
        if not isinstance(e.leaf, PackedWeight):
            e.leaf.index_copy_(-1, idx, c.leaf.index_select(-1, idx))
            continue
        for dst, src in ((e.leaf.codes, c.leaf.codes),
                         (e.leaf.scales, c.leaf.scales),
                         (e.leaf.kcodes, c.leaf.kcodes)):
            if dst is not None:
                dst.index_copy_(1, idx, src.index_select(1, idx))
        if e.qkv is not None:
            q = idx + e.off
            e.qkv.kcodes.index_copy_(1, q, c.qkv.kcodes.index_select(1, q))
            e.qkv.scales.index_copy_(1, q, c.qkv.scales.index_select(1, q))


def repair_drift(params: Any, clean: Any, path: str,
                 tiles: Sequence[Tuple[int, int]]) -> None:
    """Re-quantize on drift: restore ONLY the drifted (tile, col) scales
    from the spare, in every leaf; codes and healthy tiles stay."""
    for e, c, first, width in _pairs(params, clean, path):
        if not isinstance(e.leaf, PackedWeight):
            raise ValueError(f"repair_drift targets PackedWeight (got {path})")
        mine = [p for p in tiles if first <= p[1] < first + width]
        if not mine:
            continue
        s = e.leaf.scales
        t, j = _index([p[0] for p in mine], s.device), _index(
            [p[1] - first for p in mine], s.device)
        s.index_put_((t, j), c.leaf.scales[t, j])
        if e.qkv is not None:
            e.qkv.scales.index_put_((t, j + e.off),
                                    c.qkv.scales[t, j + e.off])


def restore_sites(params: Any, clean: Any) -> None:
    """Re-program every fault site from the spare, in place: all three
    copies of every packed leaf, and every float site."""
    for site in fault_sites(params):
        for e, c, _, _ in _pairs(params, clean, site.path):
            if not isinstance(e.leaf, PackedWeight):
                e.leaf.copy_(c.leaf)
                continue
            for dst, src in ((e.leaf.codes, c.leaf.codes),
                             (e.leaf.scales, c.leaf.scales),
                             (e.leaf.kcodes, c.leaf.kcodes)):
                if dst is not None:
                    dst.copy_(src)
            if e.qkv is not None:
                cols = slice(e.off, e.off + e.leaf.n_padded)
                e.qkv.kcodes[:, cols].copy_(c.qkv.kcodes[:, cols])
                e.qkv.scales[:, cols].copy_(c.qkv.scales[:, cols])
