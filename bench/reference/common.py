"""Plain PyTorch pieces of the reference forwards: f32 arithmetic with
TF32 off, and the bf16 roundings the configuration states. Nothing here
imports the program under test or JAX."""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F


class Layer(NamedTuple):
    """One weighted layer of a configuration, in execution order.

    kind: "conv" (weights (k*k*cin, cout), HWIO flattened), "dw" (depthwise,
    (k, k, C)) or "fc" ((cin, cout)). ``relu``: whether an activation
    follows the layer's own output (for a conv that takes a residual: the
    activation after the add). ``gain``: 2 where a ReLU follows the layer's
    sum, 1 where none does (the weights' He law)."""
    name: str
    kind: str
    cin: int
    cout: int
    k: int = 1
    stride: int = 1
    in_hw: int = 1
    relu: bool = True
    residual: bool = False
    gain: float = 2.0

    @property
    def out_hw(self) -> int:
        return -(-self.in_hw // self.stride)

    @property
    def fan_in(self) -> int:
        return self.k * self.k * (1 if self.kind == "dw" else self.cin)

    @property
    def w_shape(self) -> tuple:
        if self.kind == "dw":
            return (self.k, self.k, self.cin)
        return (self.fan_in, self.cout)


@contextlib.contextmanager
def exact_f32():
    """IEEE f32 products and convolutions: TF32 off for cuBLAS and cuDNN."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def bf16(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (nearest even) and keep computing in f32."""
    return t.to(torch.bfloat16).float()


def same_pads(n: int, k: int, stride: int) -> tuple[int, int, int]:
    """(out, lo, hi) of SAME padding: the extra pixel goes high."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return out, total // 2, total - total // 2


def _pad_nchw(x: torch.Tensor, k: int, stride: int, value: float = 0.0):
    _, hlo, hhi = same_pads(x.shape[2], k, stride)
    _, wlo, whi = same_pads(x.shape[3], k, stride)
    return F.pad(x, (wlo, whi, hlo, hhi), value=value)


def conv(x: torch.Tensor, w: torch.Tensor, k: int, stride: int):
    """NHWC f32 x, (k*k*cin, cout) f32 w -> NHWC f32 sums, SAME padding."""
    c = x.shape[-1]
    xn = _pad_nchw(x.permute(0, 3, 1, 2), k, stride)
    w4 = w.reshape(k, k, c, -1).permute(3, 2, 0, 1)
    return F.conv2d(xn, w4, stride=stride).permute(0, 2, 3, 1)


def depthwise(x: torch.Tensor, w: torch.Tensor, stride: int):
    """NHWC f32 x, (k, k, C) f32 w -> NHWC f32 sums, SAME padding."""
    k, c = w.shape[0], w.shape[-1]
    xn = _pad_nchw(x.permute(0, 3, 1, 2), k, stride)
    w4 = w.permute(2, 0, 1).unsqueeze(1)
    return F.conv2d(xn, w4, stride=stride, groups=c).permute(0, 2, 3, 1)


def maxpool(x: torch.Tensor, k: int, stride: int):
    xn = _pad_nchw(x.permute(0, 3, 1, 2), k, stride, float("-inf"))
    return F.max_pool2d(xn, k, stride).permute(0, 2, 3, 1)


def conv_node(x, p, layer: Layer, residual: Optional[torch.Tensor] = None):
    """A conv layer's bf16 output as the configuration states it: f32 sum
    plus bias; a pruned conv adds its residual in f32 and rounds once, a
    dense one rounds, adds the bf16 skip and rounds again."""
    acc = conv(x, p["w"], layer.k, layer.stride) + p["b"]
    if residual is not None and not p["pruned"]:
        y = bf16(bf16(acc) + residual)
        return torch.relu(y) if layer.relu else y
    if residual is not None:
        acc = acc + residual
    return bf16(torch.relu(acc) if layer.relu else acc)


def classifier(x, p):
    """bf16 features -> f32 logits (f32 products and sums)."""
    return x @ p["w"] + p["b"]


def prepare(raw: dict, device=None) -> dict:
    """The reference's weights from the benchmark's raw draws: each stored
    value rounded to bf16 as the native store keeps it, and each pruned
    weight densified with its dropped blocks at zero. ``raw[name]``:
    ``{"w": f32, "b": f32, "keep": (ob, K) block ids or None, "block":
    (bm, bn) or None}``."""
    out = {}
    for name, r in raw.items():
        w = bf16(r["w"].to(device))
        keep = r["keep"]
        if keep is not None:
            bm, bn = r["block"]
            d_in, d_out = w.shape
            ib, ob = d_in // bm, d_out // bn
            mask = torch.zeros((ob, ib), dtype=torch.bool, device=w.device)
            mask.scatter_(1, keep.to(w.device).long(), True)
            w = (w.reshape(ib, bm, ob, bn)
                 * mask.t()[:, None, :, None].float()).reshape(d_in, d_out)
        out[name] = {"w": w, "b": bf16(r["b"].to(device)),
                     "pruned": keep is not None}
    return out


def logits_in_blocks(forward, params, images: torch.Tensor, block: int,
                     device) -> torch.Tensor:
    """Run ``forward(params, x)`` over ``images`` (N, H, W, 3) ``block``
    images at a time on ``device``; returns (N, classes) f32 on the CPU."""
    outs = []
    with exact_f32():
        for i in range(0, images.shape[0], block):
            x = images[i:i + block].to(device).float()
            outs.append(forward(params, x).float().cpu())
    return torch.cat(outs)
