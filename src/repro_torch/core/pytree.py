"""The port's param trees walked in JAX's ``tree_flatten`` order.

A CNN's params are nested dicts whose leaves are tensors,
``SparseWeight``s and ``QuantizedWeight``s. The reference flattens them
with ``jax.tree_util``: dict keys sorted, a ``SparseWeight``'s children
``vals, idx[, scale]``, a ``QuantizedWeight``'s ``codes, scale``. The
param blob (``runtime/worker.py``) and the placed stage rows
(``core/pipeline.ParamFormat``) both lay leaves out in that order, so
either package reads what the other wrote.
"""
from __future__ import annotations

from repro_torch.core.quant import QuantizedWeight
from repro_torch.models.layers import SparseWeight

KEYSEP = "|"


def children(leaf):
    """A weight container's leaves in the reference's ``tree_flatten``
    order, or None for a plain tensor."""
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
    kids = children(tree)
    if kids is None:
        return leaf_of(KEYSEP.join(path))
    new = [leaf_of(KEYSEP.join(path + (f"[<flat index {i}>]",)))
           for i in range(len(kids))]
    if isinstance(tree, SparseWeight):
        return SparseWeight(new[0], new[1], tree.d_in,
                            new[2] if len(new) > 2 else None,
                            tree.orig_dtype)
    return QuantizedWeight(new[0], new[1], tree.orig_dtype)
