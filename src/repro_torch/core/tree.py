"""Pytrees of tensors: nested dicts, lists, tuples and NamedTuples.

The port's parameters, optimizer states and train states are plain
containers of tensors.  These helpers walk them in the JAX package's leaf
order (dict keys sorted, sequences and NamedTuple fields in order, None
holding no leaf), so a flattened state lines up with JAX's and the
checkpoint names its leaves as ``repro.checkpoint`` does.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node):
    """(path keys, children) of a container node, or None for a leaf."""
    if isinstance(node, dict):
        keys = sorted(node)
        return [str(k) for k in keys], [node[k] for k in keys]
    if _is_namedtuple(node):
        return [f".{f}" for f in node._fields], list(node)
    if isinstance(node, (list, tuple)):
        return [str(i) for i in range(len(node))], list(node)
    return None


def _rebuild(node, children):
    if isinstance(node, dict):
        return dict(zip(sorted(node), children))
    if _is_namedtuple(node):
        return type(node)(*children)
    return type(node)(children)


def flatten_with_names(tree) -> Tuple[List[str], List[Any]]:
    """(names, leaves) in leaf order; a name joins its path keys with "_"
    (a NamedTuple field as ".field"), as ``repro.checkpoint`` names them."""
    names, leaves = [], []
    _walk(tree, [], names, leaves)
    return names, leaves


# The walkers are module functions, not closures: a recursive closure is a
# reference cycle, which would keep its lists of tensors alive until the
# garbage collector runs (on the card, a whole gradient tree for a while).
def _walk(node, path, names, leaves):
    if node is None:
        return
    ch = _children(node)
    if ch is None:
        names.append("_".join(path))
        leaves.append(node)
        return
    for key, child in zip(*ch):
        _walk(child, path + [key], names, leaves)


def leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in leaf order."""
    return flatten_with_names(tree)[1]


def unflatten_like(tree, new_leaves) -> Any:
    """``tree``'s structure with ``new_leaves`` (in leaf order)."""
    it = iter(new_leaves)
    out = _build(tree, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def _build(node, it):
    if node is None:
        return None
    ch = _children(node)
    if ch is None:
        return next(it)
    return _rebuild(node, [_build(c, it) for c in ch[1]])


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and of each tree of ``rest``
    (same structure), rebuilt in ``tree``'s structure."""
    cols = [leaves(tree)] + [leaves(r) for r in rest]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("tree_map over trees of different structure")
    return unflatten_like(tree, [fn(*xs) for xs in zip(*cols)])
