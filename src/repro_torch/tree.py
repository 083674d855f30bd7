"""Pytree flattening with JAX's rules, for snapshot state trees.

Snapshots name their leaves and order their files by the flattening of the
state tree, and both packages must agree on it, so the port flattens as
``jax.tree_util`` does rather than as ``torch.utils._pytree`` (which keeps
dict insertion order):

* a dict's children come in sorted key order;
* lists, tuples and namedtuples are nodes, ``None`` is a node with no
  children, and anything else is a leaf;
* leaf names are ``jax.tree_util.keystr`` paths: ``['w']``, ``['a']['b']``,
  ``[0]`` and ``.field`` for a namedtuple.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class TreeDef:
    """The structure of a tree: a node kind, its metadata (dict keys or a
    namedtuple class) and child structures."""

    kind: str  # leaf | none | dict | list | tuple | namedtuple
    meta: Any = None
    children: tuple = ()

    @property
    def num_leaves(self) -> int:
        if self.kind == "leaf":
            return 1
        return sum(c.num_leaves for c in self.children)

    def _body(self) -> str:
        inner = [c._body() for c in self.children]
        if self.kind == "leaf":
            return "*"
        if self.kind == "none":
            return "None"
        if self.kind == "dict":
            return "{" + ", ".join(f"{k!r}: {v}" for k, v in zip(self.meta, inner)) + "}"
        if self.kind == "list":
            return "[" + ", ".join(inner) + "]"
        if self.kind == "tuple":
            return "(" + ", ".join(inner) + ("," if len(inner) == 1 else "") + ")"
        return f"CustomNode(namedtuple[{self.meta.__name__}], [{', '.join(inner)}])"

    def __str__(self) -> str:
        """The form ``str(jax.tree_util.tree_structure(tree))`` prints."""
        return f"PyTreeDef({self._body()})"


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _children(tree: Any) -> tuple[str, Any, list[tuple[str, Any]]]:
    """(kind, meta, [(key path part, child), ...]) of one node."""
    if tree is None:
        return "none", None, []
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return "dict", keys, [(f"[{k!r}]", tree[k]) for k in keys]
    if _is_namedtuple(tree):
        return "namedtuple", type(tree), [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return kind, None, [(f"[{i}]", c) for i, c in enumerate(tree)]
    return "leaf", None, []


def _walk(node: Any, path: str, out: list) -> TreeDef:
    kind, meta, kids = _children(node)
    if kind == "leaf":
        out.append((path, node))
        return TreeDef("leaf")
    return TreeDef(kind, meta, tuple(_walk(c, path + part, out) for part, c in kids))


def tree_flatten_with_path(tree: Any) -> tuple[list[tuple[str, Any]], TreeDef]:
    """``([(keystr path, leaf), ...], treedef)`` in JAX's leaf order."""
    # module-level recursion: a closure that calls itself is a reference
    # cycle, which would keep every leaf it saw alive until the next
    # garbage collection (a whole training state, step after step)
    out: list[tuple[str, Any]] = []
    return out, _walk(tree, "", out)


def tree_flatten(tree: Any) -> tuple[list[Any], TreeDef]:
    pairs, treedef = tree_flatten_with_path(tree)
    return [leaf for _, leaf in pairs], treedef


def tree_structure(tree: Any) -> TreeDef:
    return tree_flatten_with_path(tree)[1]


def tree_unflatten(treedef: TreeDef, leaves) -> Any:
    """Rebuild a tree of ``treedef``'s structure from ``leaves`` in order."""
    leaves = list(leaves)
    if len(leaves) != treedef.num_leaves:
        raise ValueError(f"tree structure has {treedef.num_leaves} leaves, got {len(leaves)}")
    return _build(treedef, iter(leaves))


def _build(td: TreeDef, it) -> Any:
    if td.kind == "leaf":
        return next(it)
    if td.kind == "none":
        return None
    kids = [_build(c, it) for c in td.children]
    if td.kind == "dict":
        return dict(zip(td.meta, kids))
    if td.kind == "list":
        return kids
    if td.kind == "tuple":
        return tuple(kids)
    return td.meta(*kids)
