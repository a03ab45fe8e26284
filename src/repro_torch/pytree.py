"""Nested dicts, lists and tuples of tensors as JAX pytrees.

The training substrate walks its parameter, gradient and optimizer trees
in ``jax.tree.flatten``'s order, so that a checkpoint's ``leaf_i`` and a
norm's sum over the leaves agree with the reference's: a dict's values in
the order of its sorted keys, a list's and a tuple's in their own order.
Anything else is a leaf.
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

        def build(n):
            if n is _LEAF:
                return next(it)
            if isinstance(n, dict):
                return {k: build(v) for k, v in n.items()}
            if isinstance(n, list):
                return [build(v) for v in n]
            return tuple(build(v) for v in n)
        out = build(self._node)
        if next(it, _LEAF) is not _LEAF:
            raise ValueError("more leaves than the structure holds")
        return out

    def flatten_up_to(self, tree) -> list:
        """The subtrees of ``tree`` at this structure's leaves (a tree of
        the same structure gives its leaves)."""
        out: list = []

        def walk(n, t):
            if n is _LEAF:
                out.append(t)
            elif isinstance(n, dict):
                if sorted(t) != list(n):
                    raise ValueError(f"keys {sorted(t)} != {list(n)}")
                for k, v in n.items():
                    walk(v, t[k])
            else:
                if len(t) != len(n):
                    raise ValueError(f"{len(t)} children != {len(n)}")
                for v, s in zip(n, t):
                    walk(v, s)
        walk(self._node, tree)
        return out


def flatten(tree, is_leaf: Callable[[Any], bool] | None = None
            ) -> tuple[list, TreeDef]:
    """(leaves in ``jax.tree.flatten``'s order, the structure)."""
    leaves: list = []

    def walk(t):
        if is_leaf is not None and is_leaf(t):
            leaves.append(t)
            return _LEAF
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [walk(v) for v in t]
        if isinstance(t, tuple):
            return tuple(walk(v) for v in t)
        leaves.append(t)
        return _LEAF
    return leaves, TreeDef(walk(tree))


def leaves(tree) -> list:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree) -> Any:
    """``fn`` over the leaves of ``tree``, in a tree of its structure."""
    flat, treedef = flatten(tree)
    return treedef.unflatten([fn(x) for x in flat])


def device(tree):
    """The device of the first leaf (the CPU for a tree of none)."""
    flat = leaves(tree)
    return flat[0].device if flat else "cpu"
