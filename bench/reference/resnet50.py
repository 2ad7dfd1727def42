"""ResNet-50 v1 (arXiv:1512.03385) in plain f32 PyTorch, with the bf16
roundings its configuration states. Pruned convs are dense matrices here,
their dropped blocks at zero (``common.prepare``)."""
from __future__ import annotations

import torch

from bench.reference.common import Layer, bf16, classifier, conv_node, \
    maxpool


def layers(cfg: dict, image_size: int) -> list[Layer]:
    st = cfg["stem"]
    hw = image_size
    out = [Layer("conv1", "conv", 3, st["cout"], st["k"], st["stride"], hw)]
    hw = -(-hw // st["stride"])
    hw = -(-hw // st["pool_stride"])
    cin = st["cout"]
    for si, (n, mid, wide, stride) in enumerate(cfg["stages"]):
        for bi in range(n):
            s = stride if bi == 0 else 1
            pre = f"s{si}b{bi}"
            out += [Layer(f"{pre}_c1", "conv", cin, mid, 1, s, hw),
                    Layer(f"{pre}_c2", "conv", mid, mid, 3, 1, -(-hw // s)),
                    Layer(f"{pre}_c3", "conv", mid, wide, 1, 1, -(-hw // s),
                          relu=True, residual=True, gain=1.0)]
            if bi == 0:
                out.append(Layer(f"{pre}_proj", "conv", cin, wide, 1, s, hw,
                                 relu=False, gain=1.0))
            hw = -(-hw // s)
            cin = wide
    out.append(Layer("fc", "fc", cin, cfg["classes"], relu=False, gain=1.0))
    return out


def forward(cfg: dict, params: dict, x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) f32 images -> (N, classes) f32 logits."""
    by = {ly.name: ly for ly in layers(cfg, x.shape[1])}
    st = cfg["stem"]
    x = conv_node(bf16(x), params["conv1"], by["conv1"])
    x = maxpool(x, st["pool_k"], st["pool_stride"])
    for si, (n, _mid, _wide, _stride) in enumerate(cfg["stages"]):
        for bi in range(n):
            pre = f"s{si}b{bi}"
            y = conv_node(x, params[f"{pre}_c1"], by[f"{pre}_c1"])
            y = conv_node(y, params[f"{pre}_c2"], by[f"{pre}_c2"])
            skip = x if bi else conv_node(x, params[f"{pre}_proj"],
                                          by[f"{pre}_proj"])
            x = conv_node(y, params[f"{pre}_c3"], by[f"{pre}_c3"],
                          residual=skip)
    return classifier(bf16(x.mean(dim=(1, 2))), params["fc"])


def kernel_calls(cfg: dict, raw: dict, n: int,
                 image_size: int) -> dict[str, list[dict]]:
    """The hand-written kernels one forward of ``n`` images launches, each
    call's shapes: every pruned conv through ``sparse_conv``, a pruned
    classifier through ``sparse_matmul``."""
    calls: dict[str, list[dict]] = {"sparse_conv": [], "sparse_matmul": []}
    for ly in layers(cfg, image_size):
        r = raw[ly.name]
        if r["keep"] is None:
            continue
        ob, n_k = r["keep"].shape
        bm, bn = r["block"]
        blocks = {"ob": ob, "n_k": n_k, "bm": bm, "bn": bn, "w_bytes": 2}
        if ly.kind == "fc":
            calls["sparse_matmul"].append(
                {"m": n, "d_in": ly.cin, "x_bytes": 4, **blocks})
        else:
            calls["sparse_conv"].append(
                {"n": n, "h": ly.in_hw, "w": ly.in_hw, "c": ly.cin,
                 "k": ly.k, "stride": ly.stride,
                 "residual": ly.residual, **blocks})
    return calls
