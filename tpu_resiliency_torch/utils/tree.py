"""Nested containers of tensors: the port's counterpart of ``jax.tree_util``.

A tree is made of dicts, lists, tuples and ``None``; everything else
(tensors, numpy arrays, scalars) is a leaf.  A ``DTensor`` (the sharded
model's state) is a leaf too, as a sharded ``jax.Array`` is: one leaf per
global tensor, whatever its placement.  :func:`flatten_with_path`
orders the leaves as ``jax.tree_util.tree_flatten_with_path`` does (dict
keys sorted, sequences in order, ``None`` an empty subtree) and names each
leaf's path as ``jax.tree_util.keystr`` does, e.g. ``['layers'][0]['wq']``.
A checkpoint's ``metadata.json`` keys leaves by these strings, so a
checkpoint written by either package restores in the other.  The repr of a
:class:`TreeDef` is the repr of JAX's ``PyTreeDef`` for the same tree.
"""

from __future__ import annotations

from typing import Any, List, Tuple


class TreeDef:
    """The structure of a tree with its leaves taken out."""

    __slots__ = ("kind", "keys", "children")

    def __init__(self, kind: str, keys: tuple = (), children: tuple = ()):
        self.kind = kind          # "leaf", "none", "dict", "list" or "tuple"
        self.keys = keys          # sorted dict keys
        self.children = children  # child TreeDefs

    @property
    def num_leaves(self) -> int:
        if self.kind == "leaf":
            return 1
        return sum(c.num_leaves for c in self.children)

    def __eq__(self, other) -> bool:
        return (isinstance(other, TreeDef) and self.kind == other.kind
                and self.keys == other.keys and self.children == other.children)

    def _body(self) -> str:
        if self.kind == "leaf":
            return "*"
        if self.kind == "none":
            return "None"
        parts = [c._body() for c in self.children]
        if self.kind == "dict":
            return "{" + ", ".join(
                f"{k!r}: {p}" for k, p in zip(self.keys, parts)) + "}"
        if self.kind == "list":
            return "[" + ", ".join(parts) + "]"
        if len(parts) == 1:
            return f"({parts[0]},)"
        return "(" + ", ".join(parts) + ")"

    def __repr__(self) -> str:
        return f"PyTreeDef({self._body()})"


def _flatten(node: Any, path: str, out: List[Tuple[str, Any]]) -> TreeDef:
    if node is None:
        return TreeDef("none")
    if isinstance(node, dict):
        keys = tuple(sorted(node))
        return TreeDef("dict", keys, tuple(
            _flatten(node[k], f"{path}[{k!r}]", out) for k in keys))
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        return TreeDef(kind, (), tuple(
            _flatten(c, f"{path}[{i}]", out) for i, c in enumerate(node)))
    out.append((path, node))
    return TreeDef("leaf")


def flatten_with_path(tree: Any) -> Tuple[List[Tuple[str, Any]], TreeDef]:
    """``([(path, leaf), ...], treedef)`` in JAX's leaf order."""
    out: List[Tuple[str, Any]] = []
    treedef = _flatten(tree, "", out)
    return out, treedef


def flatten(tree: Any) -> Tuple[List[Any], TreeDef]:
    """``(leaves, treedef)`` in JAX's leaf order."""
    pairs, treedef = flatten_with_path(tree)
    return [leaf for _, leaf in pairs], treedef


def leaves(tree: Any) -> List[Any]:
    return flatten(tree)[0]


def unflatten(treedef: TreeDef, leaves_: List[Any]) -> Any:
    """Rebuild a tree of ``treedef``'s structure from ``leaves_`` (in
    :func:`flatten` order)."""
    if len(leaves_) != treedef.num_leaves:
        raise ValueError(
            f"tree has {treedef.num_leaves} leaves, got {len(leaves_)}")
    it = iter(leaves_)

    def build(td: TreeDef) -> Any:
        if td.kind == "leaf":
            return next(it)
        if td.kind == "none":
            return None
        children = [build(c) for c in td.children]
        if td.kind == "dict":
            return dict(zip(td.keys, children))
        return children if td.kind == "list" else tuple(children)

    return build(treedef)
