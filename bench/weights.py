"""Weights and images made from the seed, on the device, in a few large
calls: the benchmark's own law, handed as they are to the program (in its
types, ``to_port``) and to the reference (``reference.common.prepare``).

Weights: He-normal over the kept fan-in, N(0, g / fan_in), g = 2 where
a ReLU follows the layer's sum and 1 where none does (torchvision's
ResNet law, kaiming_normal_), so every layer keeps its input's scale and a
residual branch adds as much as its skip carries; biases N(0, 0.05^2). A
pruned weight is drawn dense and keeps, in every output block column, the
input blocks of largest norm (block-balanced, the configuration's
``sparsity``). Images: standard normal."""
from __future__ import annotations

import math
from typing import Optional

import torch

from bench.reference.common import Layer

BIAS_STD = 0.05


def _largest_div(n: int, cap: int) -> int:
    for b in range(min(cap, n), 0, -1):
        if n % b == 0:
            return b
    return 1


def blocks_of(layer: Layer, sp: Optional[dict]) -> Optional[tuple]:
    """(bm, bn, kept row blocks) of a pruned layer, None for a dense one:
    block rows divide the input channels (a conv's block is one tap's
    channel slice), at most the configured size; a layer with blocks under
    ``min_side`` or fewer than ``min_row_blocks`` row blocks stays dense."""
    if sp is None or layer.kind == "dw":
        return None
    d_in, d_out = layer.w_shape
    unit = layer.cin if layer.kind == "conv" else d_in
    bm = sp["block_m"] if unit % sp["block_m"] == 0 else \
        _largest_div(unit, sp["block_m"])
    bn = sp["block_n"] if d_out % sp["block_n"] == 0 else \
        _largest_div(d_out, sp["block_n"])
    if bm < sp["min_side"] or bn < sp["min_side"] or \
            d_in // bm < sp["min_row_blocks"]:
        return None
    keep = max(1, round((1.0 - sp["fraction"]) * (d_in // bm)))
    return bm, bn, keep


def make_raw(layers: list[Layer], sp: Optional[dict],
             generator: torch.Generator) -> dict:
    """``{name: {"w": f32, "b": f32, "keep": (ob, K) int64 or None,
    "block": (bm, bn) or None}}`` on the generator's device, all drawn in
    one call."""
    dev = generator.device
    sizes = [math.prod(ly.w_shape) + ly.cout for ly in layers]
    u = torch.randn(sum(sizes), device=dev, generator=generator)
    raw, at = {}, 0
    for ly, size in zip(layers, sizes):
        nw = size - ly.cout
        blk = blocks_of(ly, sp)
        fan = ly.fan_in if blk is None else blk[0] * blk[2]
        w = u[at:at + nw].reshape(ly.w_shape) * math.sqrt(ly.gain / fan)
        b = u[at + nw:at + size] * BIAS_STD
        at += size
        keep = None
        if blk is not None:
            bm, bn, k = blk
            d_in, d_out = ly.w_shape
            norms = w.to(torch.bfloat16).float().reshape(
                d_in // bm, bm, d_out // bn, bn).square().sum(dim=(1, 3))
            keep = torch.topk(norms.t(), k, dim=1).indices.sort(dim=1).values
        raw[ly.name] = {"w": w, "b": b, "keep": keep,
                        "block": None if blk is None else blk[:2]}
    return raw


def make_images(n: int, size: int, generator: torch.Generator):
    """(n, size, size, 3) f32 standard-normal images, on the host."""
    return torch.randn((n, size, size, 3), device=generator.device,
                       generator=generator).cpu()


def to_port(raw: dict) -> dict:
    """The program's parameter tree from the raw draws: bf16 values (the
    native store), a pruned weight as the program's ``SparseWeight`` of
    its kept blocks."""
    from repro_torch.models.layers import SparseWeight
    params = {}
    for name, r in raw.items():
        w = r["w"].to(torch.bfloat16)
        if r["keep"] is not None:
            bm, bn = r["block"]
            d_in, d_out = w.shape
            blocks = w.reshape(d_in // bm, bm, d_out // bn, bn).permute(
                2, 0, 1, 3)
            rows = torch.arange(blocks.shape[0], device=w.device)[:, None]
            w = SparseWeight(blocks[rows, r["keep"]].contiguous(),
                             r["keep"].to(torch.int32).contiguous(), d_in)
        params[name] = {"w": w, "b": r["b"].to(torch.bfloat16)}
    return params
