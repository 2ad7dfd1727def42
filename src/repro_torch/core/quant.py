"""Low-precision parameter storage: the port's copy of the reference's
``core/quant.py`` (and of ``core/costmodel.py::pytree_param_bytes``).

A store dtype says how the weights are held resident, not what math runs
on them:

- ``"native"``: every leaf as initialized (bf16 weights, int32 sparse
  indices);
- ``"f32"``: float leaves widened to f32;
- ``"bf16"``: float leaves narrowed to bf16 (a bitwise no-op on the
  native bf16 weights);
- ``"int8"``: symmetric per-channel int8. ``scale = amax / 127`` over
  the non-channel axes in f32 (1.0 for an all-zero channel), ``codes =
  clip(round(w / scale), -127, 127)`` rounded half to even. A dense
  leaf of two or more axes becomes a :class:`QuantizedWeight` with one
  scale per last-axis channel; a ``SparseWeight``'s vals become codes
  with one scale per true output channel, shape (ob, bn). Biases and
  other 1-D leaves, and integer leaves, stay native.

``quantize_tree`` is idempotent. ``tree_stored_bytes`` prices a tree at
a store dtype without building the quantized tree, and equals
``pytree_param_bytes`` of the tree it would build.

The port's params are nested dicts (``{name: {"w", "b"}}`` for a CNN)
whose leaves are tensors, ``SparseWeight``s and ``QuantizedWeight``s;
the functions here walk the dicts.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import SparseWeight

STORE_DTYPES = ("native", "f32", "bf16", "int8")

_SCALE_BYTES = 4


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy / JAX name of a torch dtype ("bfloat16", "float32")."""
    return str(dtype).removeprefix("torch.")


class QuantizedWeight:
    """int8 codes and one f32 scale per last-axis channel for a dense
    weight. ``orig_dtype`` names the dtype ``dequant()`` restores."""

    def __init__(self, codes: torch.Tensor, scale: torch.Tensor,
                 orig_dtype: str):
        self.codes = codes
        self.scale = scale
        self.orig_dtype = orig_dtype

    def dequant(self) -> torch.Tensor:
        """codes * scale in f32, rounded once to ``orig_dtype``."""
        return (self.codes.float() * self.scale.float()).to(
            getattr(torch, self.orig_dtype))

    def to(self, device) -> "QuantizedWeight":
        return QuantizedWeight(self.codes.to(device), self.scale.to(device),
                               self.orig_dtype)

    def __repr__(self):
        return (f"QuantizedWeight(shape={tuple(self.codes.shape)}, "
                f"orig_dtype={self.orig_dtype})")


def _check(store_dtype: str) -> None:
    if store_dtype not in STORE_DTYPES:
        raise ValueError(f"store_dtype must be one of {STORE_DTYPES}, "
                         f"got {store_dtype!r}")


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _symmetric_scale(w32: torch.Tensor, dims) -> torch.Tensor:
    amax = w32.abs().amax(dim=dims)
    scale = amax / 127.0
    # an all-zero channel: scale 1.0, so that it dequantizes to 0, not 0/0
    return torch.where(amax > 0, scale, torch.ones_like(scale)).float()


def _codes(w32: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)


def _quantize_dense(w: torch.Tensor) -> QuantizedWeight:
    """A float leaf of ndim >= 2 -> codes and a (last_dim,) scale."""
    w32 = w.float()
    scale = _symmetric_scale(w32, tuple(range(w.ndim - 1)))
    return QuantizedWeight(_codes(w32, scale), scale, dtype_name(w.dtype))


def _quantize_sparse(sw: SparseWeight) -> SparseWeight:
    """Float vals (ob, K, bm, bn) -> int8 codes and an (ob, bn) scale."""
    v32 = sw.vals.float()
    scale = _symmetric_scale(v32, (1, 2))
    return SparseWeight(_codes(v32, scale[:, None, None, :]), sw.idx,
                        sw.d_in, scale=scale,
                        orig_dtype=dtype_name(sw.vals.dtype))


def quantize_tree(tree, store_dtype: str):
    """Re-store every parameter leaf of ``tree`` at ``store_dtype``.
    Leaves that are already quantized pass through unchanged."""
    _check(store_dtype)
    if store_dtype == "native":
        return tree
    cast = {"f32": torch.float32, "bf16": torch.bfloat16}.get(store_dtype)

    def q(leaf):
        if isinstance(leaf, QuantizedWeight):
            return leaf
        if isinstance(leaf, SparseWeight):
            if leaf.scale is not None:
                return leaf
            if store_dtype == "int8":
                return _quantize_sparse(leaf)
            return SparseWeight(leaf.vals.to(cast), leaf.idx, leaf.d_in)
        if not leaf.is_floating_point():
            return leaf
        if cast is not None:
            return leaf.to(cast)
        # int8: a per-channel scale needs two axes; biases stay native
        return _quantize_dense(leaf) if leaf.ndim >= 2 else leaf

    return _map(q, tree)


def dequantize_tree(tree):
    """The int8 transform undone: QuantizedWeight -> dense tensor, int8
    SparseWeight -> float-vals SparseWeight. f32/bf16-stored leaves stay
    at their stored dtype."""
    def dq(leaf):
        if isinstance(leaf, QuantizedWeight):
            return leaf.dequant()
        if isinstance(leaf, SparseWeight) and leaf.scale is not None:
            return leaf.dequantized()
        return leaf

    return _map(dq, tree)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _leaf_native_bytes(leaf) -> int:
    if isinstance(leaf, QuantizedWeight):
        return _nbytes(leaf.codes) + _nbytes(leaf.scale)
    if isinstance(leaf, SparseWeight):
        return (_nbytes(leaf.vals) + _nbytes(leaf.idx)
                + (0 if leaf.scale is None else _nbytes(leaf.scale)))
    return _nbytes(leaf)


def tree_stored_bytes(tree, store_dtype: str = "native") -> int:
    """Bytes ``tree`` occupies stored at ``store_dtype``, computed from
    the shapes without building the quantized tree; equals
    ``pytree_param_bytes(quantize_tree(tree, store_dtype))``."""
    _check(store_dtype)
    total = 0
    for leaf in _leaves(tree):
        if isinstance(leaf, QuantizedWeight) or (
                isinstance(leaf, SparseWeight) and leaf.scale is not None):
            total += _leaf_native_bytes(leaf)      # already stored narrow
        elif isinstance(leaf, SparseWeight):
            n = leaf.vals.numel()
            if store_dtype == "int8":
                ob, _, _, bn = leaf.vals.shape
                total += n + _SCALE_BYTES * ob * bn + _nbytes(leaf.idx)
            elif store_dtype == "f32":
                total += 4 * n + _nbytes(leaf.idx)
            elif store_dtype == "bf16":
                total += 2 * n + _nbytes(leaf.idx)
            else:
                total += _leaf_native_bytes(leaf)
        elif store_dtype == "native" or not leaf.is_floating_point():
            total += _nbytes(leaf)
        elif store_dtype == "f32":
            total += 4 * leaf.numel()
        elif store_dtype == "bf16":
            total += 2 * leaf.numel()
        elif leaf.ndim >= 2:                       # int8
            total += leaf.numel() + _SCALE_BYTES * leaf.shape[-1]
        else:
            total += _nbytes(leaf)
    return total


def pytree_param_bytes(tree, store_dtype: str = "native") -> int:
    """Bytes of every leaf of ``tree`` (a SparseWeight counts vals, idx
    and scale; a QuantizedWeight codes and scale), priced at
    ``store_dtype`` (reference ``core/costmodel.py:139``)."""
    if store_dtype != "native":
        return tree_stored_bytes(tree, store_dtype)
    return sum(_leaf_native_bytes(leaf) for leaf in _leaves(tree))
