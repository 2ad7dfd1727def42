"""MobileNet-V2 1.0 (arXiv:1801.04381) in plain f32 PyTorch, with the
bf16 roundings its configuration states (ReLU in place of ReLU6, as the
configuration says)."""
from __future__ import annotations

import torch

from bench.reference.common import Layer, bf16, classifier, conv, \
    conv_node, depthwise


def _blocks(cfg: dict):
    """(prefix, expansion, cin, cout, stride, residual) of every block."""
    cin = cfg["stem"]["cout"]
    for si, (t, cout, n, stride) in enumerate(cfg["blocks"]):
        for bi in range(n):
            s = stride if bi == 0 else 1
            yield f"s{si}b{bi}", t, cin, cout, s, s == 1 and cin == cout
            cin = cout


def layers(cfg: dict, image_size: int) -> list[Layer]:
    st = cfg["stem"]
    out = [Layer("conv1", "conv", 3, st["cout"], st["k"], st["stride"],
                 image_size)]
    hw = -(-image_size // st["stride"])
    cin = st["cout"]
    for pre, t, cin, cout, s, res in _blocks(cfg):
        mid = cin * t
        if t != 1:
            out.append(Layer(f"{pre}_exp", "conv", cin, mid, 1, 1, hw))
        out += [Layer(f"{pre}_dw", "dw", mid, mid, 3, s, hw),
                Layer(f"{pre}_pj", "conv", mid, cout, 1, 1, -(-hw // s),
                      relu=False, residual=res, gain=1.0)]
        hw = -(-hw // s)
        cin = cout
    out += [Layer("conv_last", "conv", cin, cfg["last_width"], 1, 1, hw),
            Layer("fc", "fc", cfg["last_width"], cfg["classes"], relu=False,
                  gain=1.0)]
    return out


def forward(cfg: dict, params: dict, x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) f32 images -> (N, classes) f32 logits."""
    by = {ly.name: ly for ly in layers(cfg, x.shape[1])}
    x = conv_node(bf16(x), params["conv1"], by["conv1"])
    for pre, t, _cin, _cout, s, res in _blocks(cfg):
        y = x
        if t != 1:
            y = conv_node(y, params[f"{pre}_exp"], by[f"{pre}_exp"])
        dw, pj = params[f"{pre}_dw"], params[f"{pre}_pj"]
        d = bf16(torch.relu(depthwise(y, dw["w"], s) + dw["b"]))
        acc = conv(d, pj["w"], 1, 1) + pj["b"]
        x = bf16(acc + x if res else acc)
    x = conv_node(x, params["conv_last"], by["conv_last"])
    return classifier(bf16(x.mean(dim=(1, 2))), params["fc"])


def kernel_calls(cfg: dict, raw: dict, n: int,
                 image_size: int) -> dict[str, list[dict]]:
    """The hand-written kernels one forward of ``n`` images launches: every
    block's depthwise and projection as one ``dw_pw`` call."""
    by = {ly.name: ly for ly in layers(cfg, image_size)}
    calls: dict[str, list[dict]] = {"dw_pw": []}
    for pre, _t, _cin, cout, s, res in _blocks(cfg):
        dw = by[f"{pre}_dw"]
        calls["dw_pw"].append(
            {"n": n, "h": dw.in_hw, "w": dw.in_hw, "c": dw.cin, "cout": cout,
             "k": dw.k, "stride": s, "residual": res, "w_bytes": 2})
    return calls
