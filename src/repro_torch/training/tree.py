"""Nested-dict trees of tensors, walked in the JAX package's leaf order.

JAX flattens a dict by its sorted keys, and so do these helpers: leaf i of
a port tree is leaf i of the reference's, so checkpoints, the optimizer's
moments and the gradients line up with the reference leaf for leaf.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a nested dict, keys sorted at every level."""
    return list(_walk(tree))


def _walk(tree: Any) -> Iterator[Any]:
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _walk(tree[key])
    else:
        yield tree


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of the same-shaped ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_unflatten(template: Any, leaves: List[Any]) -> Any:
    """``template``'s structure with ``leaves`` in :func:`tree_leaves`
    order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has")
    return out
