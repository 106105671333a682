"""Parameter and state trees: nested dicts, lists and tuples of tensors.

The JAX package walks its pytrees with ``jax.tree``; the port's trees are
plain containers, walked here.  Dict keys are visited in sorted order, as
``jax.tree`` visits them, so leaf order (a global norm's summation order, a
checkpoint's keys) follows the JAX package's.
"""

from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves_with_path(tree: Any, path: tuple = ()) -> list[tuple[tuple, Any]]:
    """(path, leaf) pairs; a path holds dict keys, list/tuple indices and
    named-tuple field names."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in
                leaves_with_path(tree[k], path + (k,))]
    if _is_namedtuple(tree):
        return [pl for name, v in zip(tree._fields, tree) for pl in
                leaves_with_path(v, path + (name,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree) for pl in
                leaves_with_path(v, path + (i,))]
    return [(path, tree)]


def leaves(tree: Any) -> list[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def unflatten(tree: Any, flat: list) -> Any:
    """A tree like ``tree`` holding ``flat``'s items in leaf order."""
    it = iter(flat)
    return tree_map(lambda _: next(it), tree)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), keeping the structure; called
    in the order of ``leaves``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)
