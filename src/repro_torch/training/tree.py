"""Trees of tensors in ``jax.tree``'s order, for the optimizer and checkpoints.

A tree is nested dicts, lists, tuples and NamedTuples with tensors, arrays
or numbers at the leaves.  Leaves come out in the order ``jax.tree.leaves``
gives for the same tree: dict keys sorted, sequences and NamedTuple fields
in order.  Each leaf's path is the string the JAX package's checkpoints
store: dict keys and sequence indices as they are, NamedTuple fields as
``.name`` (``str`` of JAX's ``GetAttrKey``), joined by ``/``; so
``layers/0/wq`` for a parameter and ``.mu/layers/0/wq`` for its first
moment in ``AdamWState``.
"""
from __future__ import annotations

from typing import Any, Iterator, List, Tuple


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node) -> Iterator[Tuple[str, Any]]:
    if isinstance(node, dict):
        for k in sorted(node):
            yield str(k), node[k]
    elif _is_namedtuple(node):
        for f in node._fields:
            yield "." + f, getattr(node, f)
    else:
        for i, v in enumerate(node):
            yield str(i), v


def _is_node(node) -> bool:
    return isinstance(node, (dict, list, tuple))


def flatten_with_paths(tree) -> List[Tuple[str, Any]]:
    """[(path, leaf)] in ``jax.tree.leaves`` order."""
    out: List[Tuple[str, Any]] = []

    def walk(prefix: str, node):
        if not _is_node(node):
            out.append((prefix, node))
            return
        for key, child in _children(node):
            walk(f"{prefix}/{key}" if prefix else key, child)

    walk("", tree)
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten(like, new_leaves) -> Any:
    """``like``'s structure (its own dict key order kept) with its leaves
    replaced, in :func:`leaves` order, by ``new_leaves``."""
    new_leaves = list(new_leaves)
    if len(new_leaves) != len(flatten_with_paths(like)):
        raise ValueError(f"unflatten: {len(new_leaves)} leaves for a tree of "
                         f"{len(flatten_with_paths(like))}")
    it = iter(new_leaves)

    def build(node):
        if not _is_node(node):
            return next(it)
        rebuilt = {k: build(v) for k, v in _children(node)}
        if isinstance(node, dict):
            return {k: rebuilt[str(k)] for k in node}
        vals = list(rebuilt.values())
        if _is_namedtuple(node):
            return type(node)(*vals)
        return type(node)(vals)

    return build(like)
