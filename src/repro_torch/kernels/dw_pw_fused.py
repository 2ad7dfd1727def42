"""Fused depthwise -> pointwise (1x1) convolution: the MobileNet block
body as one memory pass.

``dw_pw`` launches the CUDA kernel in ``csrc/dw_pw.cu``, which replaces
the reference's ``kernels/dw_pw_fused.py::dw_pw_pallas``.
``dw_pw_torch`` is the plain PyTorch version of the same function: the
CPU path and the check the kernel is held to on the card.

The order is the Pallas kernel's (``_kernel``): the depthwise sum as in
:mod:`repro_torch.kernels.depthwise_conv`, ``+ dw_b`` in f32, optional
ReLU, one round to the activation dtype (the dw->pw boundary the
unfused graph has), an f32 dot with the dense (C, Cout) pointwise
weight, ``+ pw_b``, optional residual (f32), optional ReLU, one round.
Neither version writes the (N, Ho, Wo, C) depthwise tensor: the kernel
keeps it in shared memory, and the plain version works one chunk of
output rows at a time, as the reference's XLA twin (``dw_pw_xla``) does.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.depthwise_conv import depthwise_acc, pad_same_nhwc
from repro_torch.kernels.sparse_conv import same_pads


def _row_chunk(ho: int, cap: int = 16) -> int:
    """Largest divisor of ho <= cap (output rows per chunk, as the
    reference's XLA twin picks them)."""
    for d in range(min(ho, cap), 0, -1):
        if ho % d == 0:
            return d
    return 1


def _refuse_scale(pw_scale) -> None:
    if pw_scale is not None:
        raise NotImplementedError(
            "int8 pw_scale in dw_pw: ROADMAP Queue 1 item 6, int8/bf16 "
            "storage")


def dw_pw_torch(x, dw_w, dw_b, pw_w, pw_b, residual=None, pw_scale=None, *,
                stride: int = 1, dw_relu: bool = True,
                relu: bool = True) -> torch.Tensor:
    """x: (N, H, W, C); dw_w: (k, k, C); dw_b: (C,); pw_w: (C, Cout)
    dense; pw_b: (Cout,); residual: optional (N, Ho, Wo, Cout). SAME
    padding on the depthwise. Returns (N, Ho, Wo, Cout) in x.dtype.

    Loops over chunks of at most 16 output rows; each chunk runs the depthwise on its (rows + halo) input slab and feeds
    the result straight into the pointwise product, so the working set
    is one chunk."""
    _refuse_scale(pw_scale)
    n = x.shape[0]
    k = dw_w.shape[0]
    co = pw_w.shape[-1]
    xp, ho, wo = pad_same_nhwc(x, k, stride)
    hb = _row_chunk(ho)
    rows_in = (hb - 1) * stride + k
    w32 = pw_w.float()
    out = torch.empty((n, ho, wo, co), dtype=x.dtype, device=x.device)
    for r0 in range(0, ho, hb):
        slab = xp[:, r0 * stride:r0 * stride + rows_in]
        d = depthwise_acc(slab, dw_w, stride=stride, ho=hb, wo=wo) \
            + dw_b.float()
        if dw_relu:
            d = torch.relu(d)
        d = d.to(x.dtype)                    # the dw->pw boundary round
        y = torch.matmul(d.float(), w32) + pw_b.float()
        if residual is not None:
            y = y + residual[:, r0:r0 + hb].float()
        if relu:
            y = torch.relu(y)
        out[:, r0:r0 + hb] = y.to(x.dtype)
    return out


_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("dw_pw")
    fn = lib.dw_pw_bf16
    fn.argtypes = [_P] * 7 + [_I] * 12 + [_P]
    fn.restype = _I
    return lib, fn


def dw_pw(x, dw_w, dw_b, pw_w, pw_b, residual=None, pw_scale=None, *,
          stride: int = 1, dw_relu: bool = True,
          relu: bool = True) -> torch.Tensor:
    """The CUDA kernel: same function and arguments as
    :func:`dw_pw_torch`, on contiguous bf16 CUDA tensors with a 3x3
    depthwise (every MobileNet block). Raises on
    anything the kernel does not take; it never falls back to the plain
    version. The output is allocated here and the kernel runs on the
    current stream without synchronising."""
    _refuse_scale(pw_scale)
    tensors = {"x": x, "dw_w": dw_w, "dw_b": dw_b, "pw_w": pw_w,
               "pw_b": pw_b}
    if residual is not None:
        tensors["residual"] = residual
    for name, t in tensors.items():
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"dw_pw: {name} must be on {x.device} "
                             f"(a CUDA device), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"dw_pw: {name} must be contiguous")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"dw_pw: {name} must be bfloat16, "
                             f"got {t.dtype}")
    if x.dim() != 4 or dw_w.dim() != 3 or pw_w.dim() != 2:
        raise ValueError(f"dw_pw: needs x (N, H, W, C), dw_w (k, k, C) and "
                         f"pw_w (C, Cout); got {tuple(x.shape)}, "
                         f"{tuple(dw_w.shape)}, {tuple(pw_w.shape)}")
    n, h, w, c = x.shape
    k = dw_w.shape[0]
    co = pw_w.shape[1]
    if (k != 3 or tuple(dw_w.shape) != (k, k, c)
            or tuple(dw_b.shape) != (c,) or pw_w.shape[0] != c
            or tuple(pw_b.shape) != (co,)):
        raise ValueError(f"dw_pw: dw_w {tuple(dw_w.shape)}, dw_b "
                         f"{tuple(dw_b.shape)}, pw_w {tuple(pw_w.shape)}, "
                         f"pw_b {tuple(pw_b.shape)} do not fit C={c} "
                         f"with a 3x3 depthwise")
    ho, ph, _ = same_pads(h, k, stride)
    wo, pw, _ = same_pads(w, k, stride)
    out = torch.empty((n, ho, wo, co), dtype=torch.bfloat16, device=x.device)
    if residual is not None and residual.shape != out.shape:
        raise ValueError(f"dw_pw: residual {tuple(residual.shape)} != "
                         f"output {tuple(out.shape)}")
    lib, fn = _kernel()
    err = fn(x.data_ptr(), dw_w.data_ptr(), dw_b.data_ptr(), pw_w.data_ptr(),
             pw_b.data_ptr(),
             None if residual is None else residual.data_ptr(),
             out.data_ptr(), n, h, w, c, ho, wo, stride, ph, pw, co,
             int(dw_relu), int(relu),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, "dw_pw", err)
    _build.LAUNCHES["dw_pw"] += 1
    return out
