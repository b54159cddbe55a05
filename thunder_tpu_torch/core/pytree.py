"""Pytree helpers of the port: flatten, unflatten and map over nested
tuples, lists and dicts.

The counterpart of ``thunder_tpu/core/pytree.py``, which wraps
``jax.tree_util``; the port keeps its own small implementation with the
same conventions: tuples (namedtuples included), lists and dicts are nodes,
dict entries are visited in sorted key order, ``None`` is a node with no
leaves, and everything else is a leaf. It leans on no private part of
``torch.utils._pytree``.
"""

from __future__ import annotations

from typing import Any, Callable


class TreeDef:
    """The structure of a flattened tree: hashable and comparable, so it can
    join a cache key."""

    __slots__ = ("kind", "meta", "children", "_hash")

    def __init__(self, kind: str, meta: Any, children: tuple):
        self.kind = kind            # "leaf" | "none" | "tuple" | "list" | "dict" | "namedtuple"
        self.meta = meta            # dict keys, or the namedtuple type
        self.children = children
        self._hash = hash((kind, meta if kind != "namedtuple" else id(meta), children))

    def __eq__(self, other):
        return (isinstance(other, TreeDef) and self._hash == other._hash
                and self.kind == other.kind and self.meta == other.meta
                and self.children == other.children)

    def __hash__(self):
        return self._hash

    @property
    def num_leaves(self) -> int:
        if self.kind == "leaf":
            return 1
        return sum(c.num_leaves for c in self.children)

    def __repr__(self):
        return f"TreeDef({self.kind}, {self.meta!r}, {self.children!r})"


_LEAF = TreeDef("leaf", None, ())
_NONE = TreeDef("none", None, ())


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _walk(x, leaves: list, is_leaf) -> TreeDef:
    if is_leaf is not None and is_leaf(x):
        leaves.append(x)
        return _LEAF
    if x is None:
        return _NONE
    t = type(x)
    if t is tuple or t is list:
        return TreeDef(t.__name__, None, tuple(_walk(i, leaves, is_leaf) for i in x))
    if t is dict:
        keys = tuple(sorted(x))
        return TreeDef("dict", keys, tuple(_walk(x[k], leaves, is_leaf) for k in keys))
    if _is_namedtuple(x):
        return TreeDef("namedtuple", t, tuple(_walk(i, leaves, is_leaf) for i in x))
    leaves.append(x)
    return _LEAF


def tree_flatten(tree, is_leaf: Callable[[Any], bool] | None = None):
    """``(leaves, treedef)``. The walk is a module-level function, not a
    closure that calls itself: such a closure is a reference cycle holding
    the leaves, which then outlive the call until the cyclic collector runs
    (card memory held by tensors nothing reads)."""
    leaves: list = []
    return leaves, _walk(tree, leaves, is_leaf)


def _build(td: TreeDef, it):
    k = td.kind
    if k == "leaf":
        return next(it)
    if k == "none":
        return None
    kids = [_build(c, it) for c in td.children]
    if k == "tuple":
        return tuple(kids)
    if k == "list":
        return kids
    if k == "dict":
        return dict(zip(td.meta, kids))
    return td.meta(*kids)


def tree_unflatten(treedef: TreeDef, leaves):
    return _build(treedef, iter(leaves))


def tree_leaves(tree, is_leaf=None) -> list:
    return tree_flatten(tree, is_leaf)[0]


def tree_map(fn: Callable, tree, is_leaf=None):
    leaves, td = tree_flatten(tree, is_leaf)
    return tree_unflatten(td, [fn(x) for x in leaves])


def leaf_positions(args: tuple, which) -> list[int]:
    """Flat positions, in ``tree_flatten((args, kwargs))`` order, of the
    leaves of ``args[i]`` for each ``i`` in ``which``."""
    out, off = [], 0
    for i, a in enumerate(args):
        n = len(tree_flatten(a)[0])
        if i in which:
            out.extend(range(off, off + n))
        off += n
    return out
