"""Nested containers of tensors, walked the way the JAX package's pytrees
are: a dict's entries in sorted key order, a NamedTuple's fields in order,
``None`` an empty subtree, anything else a leaf.

The training modules hold their state in such trees (``TrainState``, the
params dict in the reference's stacked layout), so AdamW, the global norm
and the checkpoint keys walk the leaves in the reference's order.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_paths(tree, prefix: Tuple[str, ...] = ()
                       ) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs: a path is the tuple of dict keys and field
    names from the root (``("opt", "m", "layers", "attn", "wq")``)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in flatten_with_paths(tree[k], prefix + (str(k),))]
    if _is_namedtuple(tree):
        return [pair for name in tree._fields
                for pair in flatten_with_paths(getattr(tree, name),
                                               prefix + (name,))]
    return [(prefix, tree)]


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten(template, new_leaves):
    """A tree of ``template``'s structure holding ``new_leaves`` in the
    order ``leaves(template)`` gives."""
    it = iter(new_leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if _is_namedtuple(t):
            return type(t)(*(build(getattr(t, n)) for n in t._fields))
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and trees of its structure."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(*args) for args in
                            zip(leaves(tree), *others, strict=True)])
