"""Pytree helpers over nested dicts, lists and tuples, in JAX's order.

The port's trees are plain dicts that keep insertion order, while JAX
flattens a dict by its sorted keys. The optimizer's norm, the
checkpoint's leaf indices and every cross-package comparison need JAX's
order, so they all flatten through ``flatten`` here: dict keys sorted at
every level, lists and tuples in order, ``None`` a subtree without
leaves (as in JAX), anything else a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _children(node) -> List[Tuple[str, Any]]:
    """(key string, child) pairs of an inner node, in JAX's order; the
    key strings are ``jax.tree_util.keystr``'s parts."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    return [(f"[{i}]", c) for i, c in enumerate(node)]


def _inner(node) -> bool:
    return isinstance(node, (dict, list, tuple))


def _walk(node, path, leaves, paths) -> None:
    if node is None:
        return
    if _inner(node):
        for key, child in _children(node):
            _walk(child, path + key, leaves, paths)
    else:
        leaves.append(node)
        paths.append(path)


def flatten_with_paths(tree) -> Tuple[List[Any], List[str]]:
    """(leaves, paths) in JAX's flatten order; each path is the leaf's
    ``jax.tree_util.keystr`` (e.g. ``"['params']['embed']['tok']"``)."""
    leaves, paths = [], []
    # module-level recursion: a closure calling itself would be a
    # reference cycle holding the leaves until the cyclic collector runs
    _walk(tree, "", leaves, paths)
    return leaves, paths


def leaves(tree) -> List[Any]:
    return flatten_with_paths(tree)[0]


def _build(node, it):
    if node is None:
        return None
    if isinstance(node, dict):
        out = {k: _build(node[k], it) for k in sorted(node)}
        return {k: out[k] for k in node}       # keep like's key order
    if isinstance(node, (list, tuple)):
        return type(node)(_build(c, it) for c in node)
    return next(it)


def unflatten(like, new_leaves) -> Any:
    """A tree with ``like``'s structure (and container types) whose
    leaves, in JAX's order, are ``new_leaves``."""
    it = iter(new_leaves)
    out = _build(like, it)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree holds")
    return out


_END = object()


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, which must share its structure)."""
    flat = [leaves(tree)] + [leaves(r) for r in rest]
    n = len(flat[0])
    if any(len(f) != n for f in flat[1:]):
        raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*args) for args in zip(*flat)])


def treedef_str(tree) -> str:
    """``str(jax.tree_util.tree_structure(tree))`` for the port's trees:
    ``PyTreeDef({'a': *, 'b': [*, (*,)]})``."""
    def fmt(node):
        if node is None:
            return "None"
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {fmt(node[k])}"
                                   for k in sorted(node)) + "}"
        if isinstance(node, list):
            return "[" + ", ".join(fmt(c) for c in node) + "]"
        if isinstance(node, tuple):
            inner = ", ".join(fmt(c) for c in node)
            return "(" + inner + ("," if len(node) == 1 else "") + ")"
        return "*"

    return f"PyTreeDef({fmt(tree)})"
