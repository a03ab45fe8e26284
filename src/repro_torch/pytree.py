"""Nested dicts, lists and tuples of tensors as JAX pytrees.

The training substrate walks its parameter, gradient and optimizer trees
in ``jax.tree.flatten``'s order, so that a checkpoint's ``leaf_i`` and a
norm's sum over the leaves agree with the reference's: a dict's values in
the order of its sorted keys, a list's and a tuple's in their own order.
Anything else is a leaf; ``None`` is a node with no children.  A leaf's
path (:func:`flatten_with_path`) is the tuple of the dict keys and
sequence indices that lead to it, as ``jax.tree_util``'s ``DictKey.key``
and ``SequenceKey.idx`` give them.
"""

from __future__ import annotations

from typing import Any, Callable

_LEAF = object()


class TreeDef:
    """The structure of a tree with its leaves taken out."""

    def __init__(self, node):
        self._node = node

    def __repr__(self) -> str:
        """As ``str(jax.tree.structure(...))`` prints the same tree."""
        def fmt(n):
            if n is _LEAF:
                return "*"
            if n is None:
                return "None"
            if isinstance(n, dict):
                return "{" + ", ".join(f"{k!r}: {fmt(v)}"
                                       for k, v in n.items()) + "}"
            if isinstance(n, list):
                return "[" + ", ".join(fmt(v) for v in n) + "]"
            inner = ", ".join(fmt(v) for v in n)
            return f"({inner},)" if len(n) == 1 else f"({inner})"
        return f"PyTreeDef({fmt(self._node)})"

    def unflatten(self, leaves) -> Any:
        it = iter(leaves)
        out = _build(self._node, it)
        if next(it, _LEAF) is not _LEAF:
            raise ValueError("more leaves than the structure holds")
        return out

    def flatten_up_to(self, tree) -> list:
        """The subtrees of ``tree`` at this structure's leaves (a tree of
        the same structure gives its leaves)."""
        out: list = []
        _walk_up_to(self._node, tree, out)
        return out


# The walks are module functions that take their accumulators as
# arguments: a nested function that calls itself sits in a reference
# cycle with its closure, and the cycle would keep every leaf it saw (a
# train step's old state, its gradients) alive until the garbage
# collector's next pass.


def _build(n, it):
    if n is _LEAF:
        return next(it)
    if n is None:
        return None
    if isinstance(n, dict):
        return {k: _build(v, it) for k, v in n.items()}
    if isinstance(n, list):
        return [_build(v, it) for v in n]
    return tuple(_build(v, it) for v in n)


def _walk_up_to(n, t, out: list) -> None:
    if n is _LEAF:
        out.append(t)
    elif n is None:
        if t is not None:
            raise ValueError(f"expected None, got {type(t).__name__}")
    elif isinstance(n, dict):
        if sorted(t) != list(n):
            raise ValueError(f"keys {sorted(t)} != {list(n)}")
        for k, v in n.items():
            _walk_up_to(v, t[k], out)
    else:
        if len(t) != len(n):
            raise ValueError(f"{len(t)} children != {len(n)}")
        for v, s in zip(n, t):
            _walk_up_to(v, s, out)


def _flatten(tree, is_leaf) -> tuple[list, list, TreeDef]:
    leaves: list = []
    paths: list = []
    node = _walk(tree, (), is_leaf, leaves, paths)
    return leaves, paths, TreeDef(node)


def _walk(t, path, is_leaf, leaves: list, paths: list):
    if is_leaf is not None and is_leaf(t):
        leaves.append(t)
        paths.append(path)
        return _LEAF
    if t is None:
        return None
    if isinstance(t, dict):
        return {k: _walk(t[k], path + (k,), is_leaf, leaves, paths)
                for k in sorted(t)}
    if isinstance(t, list):
        return [_walk(v, path + (i,), is_leaf, leaves, paths)
                for i, v in enumerate(t)]
    if isinstance(t, tuple):
        return tuple(_walk(v, path + (i,), is_leaf, leaves, paths)
                     for i, v in enumerate(t))
    leaves.append(t)
    paths.append(path)
    return _LEAF


def flatten(tree, is_leaf: Callable[[Any], bool] | None = None
            ) -> tuple[list, TreeDef]:
    """(leaves in ``jax.tree.flatten``'s order, the structure)."""
    leaves, _, treedef = _flatten(tree, is_leaf)
    return leaves, treedef


def flatten_with_path(tree, is_leaf: Callable[[Any], bool] | None = None
                      ) -> tuple[list, TreeDef]:
    """([(path, leaf)] in :func:`flatten`'s order, the structure), a
    path being the tuple of keys and indices from the root to the leaf
    (``jax.tree_util.tree_flatten_with_path``'s, entries unwrapped)."""
    leaves, paths, treedef = _flatten(tree, is_leaf)
    return list(zip(paths, leaves)), treedef


def leaves(tree) -> list:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree) -> Any:
    """``fn`` over the leaves of ``tree``, in a tree of its structure."""
    flat, treedef = flatten(tree)
    return treedef.unflatten([fn(x) for x in flat])


def tree_map_with_path(fn: Callable, tree) -> Any:
    """``fn(path, leaf)`` over the leaves of ``tree``, in a tree of its
    structure (``jax.tree_util.tree_map_with_path``)."""
    flat, treedef = flatten_with_path(tree)
    return treedef.unflatten([fn(p, x) for p, x in flat])


def device(tree):
    """The device of the first leaf (the CPU for a tree of none)."""
    flat = leaves(tree)
    return flat[0].device if flat else "cpu"
