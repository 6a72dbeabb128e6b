"""Trees of tensors in the order ``jax.tree.flatten`` walks them.

The port keeps the reference's parameter and state trees: dicts, lists,
tuples and NamedTuples whose leaves are tensors (or numpy arrays, or
Python numbers).  A dict is walked by sorted key, a list or tuple in
order, a NamedTuple field by field; ``None`` is an empty subtree.  So a
checkpoint's ``leaf_<i>`` is the same leaf in both packages.

The walks are module-level functions, not closures that call themselves:
such a closure is a reference cycle that would hold every leaf (a 5 GB
gradient, say) until the garbage collector ran.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _walk(node, leaves: List[Any]):
    if node is None:
        return None
    if isinstance(node, dict):
        keys = sorted(node)
        return ("dict", keys, [_walk(node[k], leaves) for k in keys])
    if _is_namedtuple(node):
        return ("namedtuple", type(node), [_walk(v, leaves) for v in node])
    if isinstance(node, (list, tuple)):
        return (type(node).__name__, None, [_walk(v, leaves) for v in node])
    leaves.append(node)
    return "leaf"


def _build(node, it: Iterator[Any]):
    if node is None:
        return None
    if node == "leaf":
        return next(it)
    kind, aux, children = node
    built = [_build(c, it) for c in children]
    if kind == "dict":
        return dict(zip(aux, built))
    if kind == "namedtuple":
        return aux(*built)
    return list(built) if kind == "list" else tuple(built)


def flatten(tree: Any) -> Tuple[List[Any], Any]:
    """The leaves of ``tree`` in JAX's order, and a structure that
    :func:`unflatten` rebuilds the tree from."""
    leaves: List[Any] = []
    return leaves, _walk(tree, leaves)


def unflatten(structure: Any, leaves: List[Any]) -> Any:
    """The tree of ``structure`` (from :func:`flatten`) holding ``leaves``."""
    it = iter(leaves)
    out = _build(structure, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in JAX's order."""
    return flatten(tree)[0]


def map(fn: Callable, tree: Any) -> Any:  # noqa: A001
    """``fn`` over the leaves of ``tree``, as ``jax.tree.map``."""
    flat, structure = flatten(tree)
    return unflatten(structure, [fn(x) for x in flat])
