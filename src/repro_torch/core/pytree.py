"""The port's param trees walked in JAX's ``tree_flatten`` order.

A CNN's params are nested dicts whose leaves are tensors,
``SparseWeight``s and ``QuantizedWeight``s. The reference flattens them
with ``jax.tree_util``: dict keys sorted, a ``SparseWeight``'s children
``vals, idx[, scale]``, a ``QuantizedWeight``'s ``codes, scale``. The
param blob (``runtime/worker.py``) and the placed stage rows
(``core/pipeline.ParamFormat``) both lay leaves out in that order, so
either package reads what the other wrote.

Training adds two nodes. An optimizer state
(``optim/adamw.OptState``, a NamedTuple) flattens its fields under
``.m``, ``.v`` and ``.step``, as JAX flattens a NamedTuple. The moments
and the gradients of a weight container are :class:`SparseLeaves`: its
children without the container (the reference's moments are
SparseWeights whose children are f32 zeros, which the port's
SparseWeight, int32 idx only, cannot hold), flattened as the container's
children are. A gradient tree holds None where a leaf takes no gradient
(integer leaves, as JAX's float0).
"""
from __future__ import annotations

from repro_torch.core.quant import QuantizedWeight
from repro_torch.models.layers import SparseWeight

KEYSEP = "|"


class SparseLeaves(list):
    """The children of a weight container (vals, idx[, scale] or codes,
    scale) as another tensor each: the optimizer's moments or the
    gradients of a SparseWeight. Flattened with the container's keys."""


def is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def children(leaf):
    """A weight container's leaves in the reference's ``tree_flatten``
    order, or None for a plain tensor."""
    if isinstance(leaf, SparseLeaves):
        return list(leaf)
    if isinstance(leaf, SparseWeight):
        return [leaf.vals, leaf.idx] + (
            [] if leaf.scale is None else [leaf.scale])
    if isinstance(leaf, QuantizedWeight):
        return [leaf.codes, leaf.scale]
    return None


def keyed_leaves(tree, path=()):
    """``(key, tensor)`` for every leaf of ``tree``, in the order and
    with the key strings of JAX's ``tree_flatten_with_path``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from keyed_leaves(tree[k], path + (f"[{k!r}]",))
        return
    if is_namedtuple(tree):
        for f in tree._fields:
            yield from keyed_leaves(getattr(tree, f), path + (f".{f}",))
        return
    kids = children(tree)
    if kids is None:
        yield KEYSEP.join(path), tree
        return
    for i, kid in enumerate(kids):
        yield KEYSEP.join(path + (f"[<flat index {i}>]",)), kid


def leaves(tree) -> list:
    """The tensors of ``tree`` in JAX's ``tree_leaves`` order."""
    return [t for _, t in keyed_leaves(tree)]


def rebuild(tree, leaf_of, path=()):
    """``tree`` with every leaf replaced by ``leaf_of(key)``."""
    if isinstance(tree, dict):
        return {k: rebuild(v, leaf_of, path + (f"[{k!r}]",))
                for k, v in tree.items()}
    if is_namedtuple(tree):
        return type(tree)(*(rebuild(getattr(tree, f), leaf_of,
                                    path + (f".{f}",))
                            for f in tree._fields))
    kids = children(tree)
    if kids is None:
        return leaf_of(KEYSEP.join(path))
    new = [leaf_of(KEYSEP.join(path + (f"[<flat index {i}>]",)))
           for i in range(len(kids))]
    if isinstance(tree, SparseLeaves):
        return SparseLeaves(new)
    if isinstance(tree, SparseWeight):
        return SparseWeight(new[0], new[1], tree.d_in,
                            new[2] if len(new) > 2 else None,
                            tree.orig_dtype)
    return QuantizedWeight(new[0], new[1], tree.orig_dtype)


def map_leaves(fn, tree, *rest):
    """The tree of ``fn(leaf, *leaves of rest)`` over ``tree``'s leaves,
    ``rest`` being trees of the same keys (weight containers there may
    be :class:`SparseLeaves`, leaves None); every weight container of
    ``tree`` becomes :class:`SparseLeaves`."""
    others = [dict(keyed_leaves(r)) for r in rest]

    def as_leaves(t):
        if isinstance(t, dict):
            return {k: as_leaves(v) for k, v in t.items()}
        if is_namedtuple(t):
            return type(t)(*(as_leaves(getattr(t, f)) for f in t._fields))
        kids = children(t)
        return t if kids is None else SparseLeaves(kids)

    flat = dict(keyed_leaves(tree))
    return rebuild(as_leaves(tree),
                   lambda key: fn(flat[key], *(o[key] for o in others)))
