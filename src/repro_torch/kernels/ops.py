"""Dispatch from the model code to the kernels.

The tensor's device picks the path: a CPU tensor goes to the plain
PyTorch version, a CUDA tensor to the hand-written kernel, which
launches or raises. There is no fallback from one to the other and no
switch that sends a CUDA tensor down the plain path.

Under autograd a CUDA tensor goes through the kernel's
``torch.autograd.Function`` (``sparse_matmul.SparseMatmulFn``,
``flash_attention.FlashAttentionFn``): the forward is the kernel, the
backward a plain function beside the plain version (the reference has no
backward kernel). A CPU tensor's plain version differentiates through
autograd as it is.

``LAUNCHES`` counts kernel launches by name (a plain int each, reset
with ``reset_launches``): the CUDA wrappers add one per launch, so a
run can show that its main path went through the kernels.
``VARIANT_LAUNCHES`` counts the launches of ``sparse_conv``,
``sparse_matmul``, ``dw_pw`` and ``flash_attention`` by (name, variant),
the variants of each in ``_build.VARIANTS``.

Quantized weights (``core/quant.py``) take the reference's int8 fast
path by default: the int8 codes go into the kernel and the per-channel
scale multiplies the f32 sum of code products once, in the epilogue,
before bias, residual and activation (``sparse_matmul``: after the
kernel, as the reference applies it outside its Pallas kernel).
``config(int8_fast_path=False)`` dequantizes the weights on entry
instead, the reference's path that the fast one is tested against.

Tuned knobs (``core/tuning.py``): with a tuning cache active
(``config(tuning_cache=...)`` or ``set_tuning_cache``), ``sparse_conv``,
``dw_pw_conv`` and ``depthwise_conv`` look up the plan the autotuner
recorded for the call's shape on this card (:func:`_knob`) and hand it to
the kernel wrapper, which runs it or raises; where the cache has no entry
the wrapper's own ``plan()`` decides. The lookup happens when a kernel is
launched or captured, so a captured CUDA graph keeps the knobs of its
capture. CPU tensors take the plain versions, which have no knobs.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.core import tuning as _tuning
from repro_torch.kernels import depthwise_conv as _dw
from repro_torch.kernels import dw_pw_fused as _dwpw
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import sparse_conv as _sc
from repro_torch.kernels import sparse_matmul as _sm
from repro_torch.kernels._build import (  # noqa: F401
    LAUNCHES, VARIANT_LAUNCHES, reset_launches)


_INT8_FAST = {"on": True}


def set_tuning_cache(cache):
    """Install a :class:`repro_torch.core.tuning.TuningCache` whose tuned
    kernel plans the dispatchers below read (``None`` clears). Knobs are
    read when a kernel is launched or captured. Returns a context-manager
    guard that restores the previous cache."""
    return _tuning.set_tuning_cache(cache)


@contextlib.contextmanager
def config(*, tuning_cache=None, int8_fast_path: Optional[bool] = None):
    """Scope the dispatch knobs (the reference's ``kernels.config``):
    ``tuning_cache`` (a TuningCache) supplies the kernels' tuned plans;
    ``int8_fast_path`` True feeds int8 codes to the kernels and applies
    the scale in the epilogue, False dequantizes at op entry. ``None``
    leaves a knob as it is; every previous value comes back on exit."""
    prev = _INT8_FAST["on"]
    guard = None
    try:
        if int8_fast_path is not None:
            _INT8_FAST["on"] = bool(int8_fast_path)
        if tuning_cache is not None:
            guard = _tuning.set_tuning_cache(tuning_cache)
        yield
    finally:
        _INT8_FAST["on"] = prev
        if guard is not None:
            guard.__exit__(None, None, None)


def int8_fast_path() -> bool:
    return _INT8_FAST["on"]


def _knob(op: str, in_shape, dtype, name: str, default, *, device=None,
          **fields):
    """The tuned value of knob ``name`` at kernel key ``(op, in_shape,
    dtype, fields)`` on ``device`` (its signature) in the active tuning
    cache; ``default`` when no cache is active or it has no such entry
    (an entry for another shape or card never matches)."""
    cache = _tuning.current_tuning_cache()
    if cache is None:
        return default
    key = _tuning.kernel_key(op, in_shape, dtype,
                             device=_tuning.device_signature(device),
                             **fields)
    return cache.knob(key, name, default)


def _tuned(op: str, x: torch.Tensor, names, **fields):
    """The tuned knobs ``names`` at ``x``'s kernel key (the autotuners
    record them together), or None where the active cache has no such
    entry: the wrapper's ``plan()`` decides."""
    if _tuning.current_tuning_cache() is None:
        return None
    vals = tuple(_knob(op, x.shape, x.dtype, n, None, device=x.device,
                       **fields) for n in names)
    return None if None in vals else vals


def _route(x: torch.Tensor, op: str) -> bool:
    """True for the kernel (CUDA tensor), False for the plain version
    (CPU tensor); any other device raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{op}: no path for a tensor on {x.device}")


def sparse_matmul(x: torch.Tensor, sw) -> torch.Tensor:
    """x: (..., d_in) @ block-balanced SparseWeight -> (..., d_out).

    int8 ``sw``: the kernel sums the code products into x's dtype and
    the (ob, bn) scale multiplies that output in f32 afterwards, one
    multiply per output channel (reference ``ops.py:135-144``)."""
    if sw.scale is not None and not _INT8_FAST["on"]:
        sw = sw.dequantized()
    *lead, d_in = x.shape
    if d_in != sw.d_in:
        raise ValueError(f"sparse_matmul: x has {d_in} features, the "
                         f"weight takes {sw.d_in}")
    xm = x.reshape(-1, d_in).contiguous()
    fn = _sm.SparseMatmulFn.apply if _route(x, "sparse_matmul") \
        else _sm.sparse_matmul_torch
    y = fn(xm, sw.vals, sw.idx)
    if sw.scale is not None:
        y = (y.float() * sw.scale.reshape(-1)).to(y.dtype)
    return y.reshape(*lead, sw.d_out)


def sparse_conv(x, sw, bias, *, k: int, stride: int = 1, relu: bool = True,
                residual=None) -> torch.Tensor:
    """Fused implicit-GEMM block-sparse conv (HPIPE conv unit).

    x: (N, H, W, C) NHWC; sw: block-balanced SparseWeight over the
    HWIO-flattened (k*k*C, Cout) matrix (block rows divide C); bias:
    (Cout,). SAME padding; bias, optional ``residual`` (N, Ho, Wo, Cout)
    and optional ReLU fused into the epilogue. int8 ``sw``: the codes
    go into the kernel and its (ob, bn) scale multiplies the f32 sum in
    the epilogue, before bias and residual."""
    if sw.scale is not None and not _INT8_FAST["on"]:
        sw = sw.dequantized()
    c = x.shape[-1]
    if sw.d_in != k * k * c or c % sw.vals.shape[2]:
        raise ValueError(f"sparse_conv: weight d_in={sw.d_in} with blocks "
                         f"{tuple(sw.vals.shape[2:])} does not fit k={k}, "
                         f"C={c}")
    if not _route(x, "sparse_conv"):
        return _sc.sparse_conv_torch(x, sw.vals, sw.idx, bias, residual,
                                     sw.scale, k=k, stride=stride, relu=relu)
    ob, n_k, bm, bn = sw.vals.shape
    plan = _tuned("sconv", x, ("tm", "split"), k=k, s=stride,
                  b=f"{bm}x{bn}K{n_k}", co=ob * bn) \
        if _sc.variant(bm, bn, sw.vals.dtype) == "mma" else None
    return _sc.sparse_conv(x, sw.vals, sw.idx, bias, residual, sw.scale,
                           k=k, stride=stride, relu=relu, plan=plan)


def depthwise_conv(x, w, *, stride: int = 1) -> torch.Tensor:
    """NHWC depthwise conv (HPIPE's DepthwiseConv2D unit): x (N, H, W,
    C), w (k, k, C), SAME padding, f32 sums, output in x.dtype, no
    bias."""
    if not _route(x, "depthwise_conv"):
        return _dw.depthwise_conv_torch(x, w, stride=stride)
    plan = _tuned("dw", x, ("r", "threads"), k=w.shape[1], s=stride)
    return _dw.depthwise_conv(x, w, stride=stride, plan=plan)


def dw_pw_conv(x, dw_w, dw_b, pw_w, pw_b, *, stride: int = 1,
               dw_relu: bool = True, relu: bool = True,
               residual=None) -> torch.Tensor:
    """Fused depthwise -> pointwise MobileNet block body (the graph
    fusion pass's ``dw_pw`` node): the depthwise intermediate never
    reaches device memory on the card, and exists one row chunk at a
    time on the CPU.

    x: (N, H, W, C); dw_w: (k, k, C); dw_b: (C,); pw_w: (C, Cout) dense
    (or a QuantizedWeight: its codes go into the kernel and its (Cout,)
    scale joins the epilogue); pw_b: (Cout,); residual: optional fused
    (N, Ho, Wo, Cout) skip. A quantized dw_w is dequantized on entry
    (reference ``ops.py:320-326``)."""
    from repro_torch.core.quant import QuantizedWeight
    if isinstance(dw_w, QuantizedWeight):
        dw_w = dw_w.dequant()
    pw_scale = None
    if isinstance(pw_w, QuantizedWeight):
        if _INT8_FAST["on"]:
            pw_scale, pw_w = pw_w.scale, pw_w.codes
        else:
            pw_w = pw_w.dequant()
    if not _route(x, "dw_pw"):
        return _dwpw.dw_pw_torch(x, dw_w, dw_b, pw_w, pw_b, residual,
                                 pw_scale, stride=stride, dw_relu=dw_relu,
                                 relu=relu)
    n, h, w, c = x.shape
    k, co = dw_w.shape[0], pw_w.shape[-1]
    knobs = _tuned("dwpw", x, ("tm", "tn", "ck", "split"), k=dw_w.shape[1],
                   s=stride, co=co) \
        if _dwpw.variant(c, co, k, stride, pw_w.dtype) == "mma" else None
    plan = None if knobs is None else _dwpw.make_plan(
        n, -(-h // stride), -(-w // stride), c, co, k, stride, *knobs,
        codes=pw_w.dtype == torch.int8)
    return _dwpw.dw_pw(x, dw_w, dw_b, pw_w, pw_b, residual, pw_scale,
                       stride=stride, dw_relu=dw_relu, relu=relu, plan=plan)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """Causal or sliding-window attention with an online softmax in f32
    (the LM prefill's attention): q (B, Tq, H, D), k and v (B, Tk, H, D)
    with GQA already expanded; query t sits at ``q_offset + t``. The
    output has q's layout and dtype."""
    if _route(q, "flash_attention"):
        return _fa.FlashAttentionFn.apply(q, k, v, causal, window, q_offset)
    return _fa.flash_attention_torch(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
