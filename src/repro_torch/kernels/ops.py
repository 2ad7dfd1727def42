"""Dispatch from the model code to the kernels.

The tensor's device picks the path: a CPU tensor goes to the plain
PyTorch version, a CUDA tensor to the hand-written kernel, which
launches or raises. There is no fallback from one to the other and no
switch that sends a CUDA tensor down the plain path.

``LAUNCHES`` counts kernel launches by name (a plain int each, reset
with ``reset_launches``): the CUDA wrappers add one per launch, so a
run can show that its main path went through the kernels.
``VARIANT_LAUNCHES`` counts the launches of ``sparse_conv``,
``sparse_matmul``, ``dw_pw`` and ``flash_attention`` by (name, variant),
the variants of each in ``_build.VARIANTS``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import depthwise_conv as _dw
from repro_torch.kernels import dw_pw_fused as _dwpw
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import sparse_conv as _sc
from repro_torch.kernels import sparse_matmul as _sm
from repro_torch.kernels._build import (  # noqa: F401
    LAUNCHES, VARIANT_LAUNCHES, reset_launches)


def _route(x: torch.Tensor, op: str) -> bool:
    """True for the kernel (CUDA tensor), False for the plain version
    (CPU tensor); any other device raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{op}: no path for a tensor on {x.device}")


def sparse_matmul(x: torch.Tensor, sw) -> torch.Tensor:
    """x: (..., d_in) @ block-balanced SparseWeight -> (..., d_out)."""
    *lead, d_in = x.shape
    if d_in != sw.d_in:
        raise ValueError(f"sparse_matmul: x has {d_in} features, the "
                         f"weight takes {sw.d_in}")
    xm = x.reshape(-1, d_in).contiguous()
    fn = _sm.sparse_matmul if _route(x, "sparse_matmul") \
        else _sm.sparse_matmul_torch
    return fn(xm, sw.vals, sw.idx).reshape(*lead, sw.d_out)


def sparse_conv(x, sw, bias, *, k: int, stride: int = 1, relu: bool = True,
                residual=None) -> torch.Tensor:
    """Fused implicit-GEMM block-sparse conv (HPIPE conv unit).

    x: (N, H, W, C) NHWC; sw: block-balanced SparseWeight over the
    HWIO-flattened (k*k*C, Cout) matrix (block rows divide C); bias:
    (Cout,). SAME padding; bias, optional ``residual`` (N, Ho, Wo, Cout)
    and optional ReLU fused into the epilogue."""
    c = x.shape[-1]
    if sw.d_in != k * k * c or c % sw.vals.shape[2]:
        raise ValueError(f"sparse_conv: weight d_in={sw.d_in} with blocks "
                         f"{tuple(sw.vals.shape[2:])} does not fit k={k}, "
                         f"C={c}")
    fn = _sc.sparse_conv if _route(x, "sparse_conv") \
        else _sc.sparse_conv_torch
    return fn(x, sw.vals, sw.idx, bias, residual, k=k, stride=stride,
              relu=relu)


def depthwise_conv(x, w, *, stride: int = 1) -> torch.Tensor:
    """NHWC depthwise conv (HPIPE's DepthwiseConv2D unit): x (N, H, W,
    C), w (k, k, C), SAME padding, f32 sums, output in x.dtype, no
    bias."""
    fn = _dw.depthwise_conv if _route(x, "depthwise_conv") \
        else _dw.depthwise_conv_torch
    return fn(x, w, stride=stride)


def dw_pw_conv(x, dw_w, dw_b, pw_w, pw_b, *, stride: int = 1,
               dw_relu: bool = True, relu: bool = True,
               residual=None) -> torch.Tensor:
    """Fused depthwise -> pointwise MobileNet block body (the graph
    fusion pass's ``dw_pw`` node): the depthwise intermediate never
    reaches device memory on the card, and exists one row chunk at a
    time on the CPU.

    x: (N, H, W, C); dw_w: (k, k, C); dw_b: (C,); pw_w: (C, Cout) dense;
    pw_b: (Cout,); residual: optional fused (N, Ho, Wo, Cout) skip."""
    fn = _dwpw.dw_pw if _route(x, "dw_pw") else _dwpw.dw_pw_torch
    return fn(x, dw_w, dw_b, pw_w, pw_b, residual, stride=stride,
              dw_relu=dw_relu, relu=relu)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """Causal or sliding-window attention with an online softmax in f32
    (the LM prefill's attention): q (B, Tq, H, D), k and v (B, Tk, H, D)
    with GQA already expanded; query t sits at ``q_offset + t``. The
    output has q's layout and dtype."""
    fn = _fa.flash_attention if _route(q, "flash_attention") \
        else _fa.flash_attention_torch
    return fn(q, k, v, causal=causal, window=window, q_offset=q_offset)
