"""Nested-container helpers with ``jax.tree``'s leaf order.

Parameters, payloads and client states are nested ``dict``/``list``/
``tuple`` containers of tensors, the same trees the JAX package uses.  The
flat wire format (``core/flat.py``) lays leaves out in tree order, so the
order here must be JAX's, not ``torch.utils._pytree``'s:

* dict children come in *sorted key* order (``torch.utils._pytree`` keeps
  insertion order, which would permute every flat buffer against JAX's);
* list and tuple children come in index order;
* ``None`` is an empty node (no leaves), as in JAX;
* anything else — a tensor, a numpy array, a Python scalar — is a leaf.

Containers rebuilt by :func:`map` / :func:`unflatten` are dicts with sorted
keys, as JAX rebuilds them.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

Treedef = Tuple


# The recursive helpers are module functions, not closures: a nested
# function that calls itself sits in a reference cycle with its closure
# cell, which would keep the leaves it captured (a whole gradient tree)
# alive until the cycle collector runs.

def _walk(x, leaves: List[Any]) -> Treedef:
    if x is None:
        return ("none",)
    if isinstance(x, dict):
        keys = tuple(sorted(x))
        return ("dict", keys, tuple(_walk(x[k], leaves) for k in keys))
    if isinstance(x, (list, tuple)):
        kind = "list" if isinstance(x, list) else "tuple"
        return (kind, len(x), tuple(_walk(v, leaves) for v in x))
    leaves.append(x)
    return ("leaf",)


def flatten(tree: Any) -> Tuple[List[Any], Treedef]:
    """(leaves in JAX order, hashable structure)."""
    leaves: List[Any] = []
    treedef = _walk(tree, leaves)
    return leaves, treedef


def leaves(tree: Any) -> List[Any]:
    return flatten(tree)[0]


def structure(tree: Any) -> Treedef:
    return flatten(tree)[1]


def _build(td: Treedef, it) -> Any:
    kind = td[0]
    if kind == "none":
        return None
    if kind == "leaf":
        return next(it)
    if kind == "dict":
        return {k: _build(c, it) for k, c in zip(td[1], td[2])}
    children = [_build(c, it) for c in td[2]]
    return children if kind == "list" else tuple(children)


def unflatten(treedef: Treedef, leaves_: List[Any]) -> Any:
    it = iter(leaves_)
    out = _build(treedef, it)
    rest = next(it, _SENTINEL)
    if rest is not _SENTINEL:
        raise ValueError("more leaves than the structure holds")
    return out


_SENTINEL = object()


def map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:  # noqa: A001
    """``jax.tree.map``: apply ``fn`` leaf-wise over trees of one structure
    (the structure is ``tree``'s; ``rest`` must match it)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map(fn, tree[k], *[r[k] for r in rest])
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [map(fn, v, *[r[i] for r in rest]) for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)
