"""The hand-written kernels at the main paths' own shapes, timed on one
card, so that two trees can be set side by side in one call:

- ``sparse_conv`` at sparse ResNet-50's 47 pruned convs (32 x 32
  blocks, 224 px, n 1, summed) and its classifier (``sparse_matmul``,
  f32 x, M 1);
- ``sparse_matmul`` at SmolLM-360M's FFN (64 x 64 blocks) and
  Qwen3-32B's (128 x 128), w1 and w2, at M 4 and 2048;
- ``flash_attention``, B 1, T 2048, causal: SmolLM-360M (H 15, D 64),
  Qwen3-32B (H 64, D 128), zamba2-7b (H 32, D 112, window 4096).

Weights and inputs come from seed 0, the same on every tree. Times are
CUDA events around CUDA-graph replays (``chip_smoke.time_ms``). Prints
the card's name and power limit, then one JSON line ``{"src": ...,
"variants": {...}, "times_us": {...}}``.

    python3 tools/kernel_ab.py [--src TREE/src]

``--src`` picks the tree whose ``repro_torch`` (and kernel sources) are
built and timed; the default is this one's. To hold a parent commit
against this tree, unpack it with ``git archive`` into a directory that
``.gitignore`` lists and run parent, this tree, this tree, parent in one
call.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

FLASH = {"smollm-360m D 64": (15, 64, 0), "qwen3-32b D 128": (64, 128, 0),
         "zamba2-7b D 112": (32, 112, 4096)}
MM = {"smollm-360m": (960, 2560, 64), "qwen3-32b": (5120, 25600, 128)}
MM_M = (4, 2048)
T = 2048


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA card", file=sys.stderr)
        return 1
    # the tree's package first: chip_smoke (for time_ms) puts this tree's
    # src on the path when it is imported
    import repro_torch
    from repro_torch.configs import SparsityConfig, get_config
    from repro_torch.core.fusion import conv_part, fused_graph_for
    from repro_torch.core.sparsity import to_block_balanced
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import sparse_conv as sc
    from repro_torch.kernels import sparse_matmul as sm
    from repro_torch.models import cnn
    from repro_torch.models.layers import SparseWeight
    if not Path(repro_torch.__file__).resolve().is_relative_to(src):
        raise RuntimeError(f"repro_torch from {repro_torch.__file__}, "
                           f"not {src}")
    sys.path.insert(0, str(ROOT))
    from chip_smoke import time_ms

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    _build.build_all()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    times, variants = {}, {}
    # ResNet-50's 47 sparse convs at n 1, and the classifier at M 1
    cfg = get_config("resnet50")
    params = cnn.init_cnn(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    graph = fused_graph_for(cfg.name)
    shapes = cnn.node_shapes(cfg, None, (1, 224, 224, 3), graph=graph)
    total, n_conv = 0.0, 0
    for node, edge in zip(graph.nodes, graph.inputs):
        p = params.get(conv_part(node).name) if node.kind == "conv" else None
        if p is None or not isinstance(p["w"], SparseWeight):
            continue
        n_conv += 1
        sw, b = p["w"].to(dev), randn((node.cout,)) * 0.1
        x = randn(tuple(shapes[edge[0]].shape))
        ho = -(-x.shape[1] // node.stride)
        r = randn((1, ho, ho, node.cout)) if node.residual_from else None
        kw = dict(k=node.k, stride=node.stride, relu=node.relu)
        total += time_ms(lambda: sc.sparse_conv(x, sw.vals, sw.idx, b, r,
                                                **kw))
    times[f"sparse_conv x{n_conv} resnet50 n 1"] = total * 1e3
    fc = params["fc"]["w"].to(dev)
    x = randn((1, fc.d_in), torch.float32)
    times["sparse_matmul classifier M 1 f32"] = time_ms(
        lambda: sm.sparse_matmul(x, fc.vals, fc.idx)) * 1e3
    variants["classifier M 1"] = sm.variant(x.dtype, 1,
                                            *fc.vals.shape[2:])
    # the LM FFNs' blocks
    for name, (d, f, side) in MM.items():
        scfg = SparsityConfig(True, 0.85, side, side)
        for wname, (d_in, d_out) in (("w1", (d, f)), ("w2", (f, d))):
            w = (torch.rand((d_in, d_out), generator=gen, device=dev) * 2
                 - 1) / d_in ** 0.5
            sw = to_block_balanced(w.to(torch.bfloat16).cpu(), scfg).to(dev)
            del w
            for m in MM_M:
                x = randn((m, d_in))
                key = f"sparse_matmul {name} {wname} {side}x{side} M {m}"
                times[key] = time_ms(
                    lambda: sm.sparse_matmul(x, sw.vals, sw.idx)) * 1e3
                variants[key] = sm.variant(x.dtype, m, side, side)
    # flash at the LM layers' shapes
    for name, (h, d, window) in FLASH.items():
        q, k, v = (randn((1, T, h, d)) for _ in range(3))
        key = f"flash_attention {name} H {h} T {T} causal"
        times[key] = time_ms(lambda: fa.flash_attention(
            q, k, v, causal=True, window=window)) * 1e3
        variants[key] = fa.variant(torch.bfloat16, d)
    print(json.dumps({"src": str(src), "variants": variants,
                      "times_us": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
