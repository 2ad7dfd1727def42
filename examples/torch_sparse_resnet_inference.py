"""The paper's headline scenario on the PyTorch port: sparse ResNet-50
inference.

Prunes ResNet-50 to 85% block sparsity (HPIPE weight format), runs the
throughput-balancing compiler at the paper's 5000-DSP design point,
reports the balanced plan, and serves a batch of images through the
sparse-aware conv kernels (``sparse_conv`` for the 47 pruned convs,
``sparse_matmul`` for the pruned classifier) on the card.

    PYTHONPATH=src python examples/torch_sparse_resnet_inference.py
    PYTHONPATH=src python examples/torch_sparse_resnet_inference.py \\
        --device cpu       # the kernels' plain versions
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import planner  # noqa: E402
from repro_torch.core.device import resolve_device  # noqa: E402
from repro_torch.data.pipeline import image_batch  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

DSP_TARGET = 5000


def compile_plan(cfg, params) -> dict:
    """The HPIPE planner at ``DSP_TARGET``: the unbalanced bottleneck
    (every op at one split), the balanced plan and its five slowest
    nodes as (name, cycles, splits). Host-side: the same weights give
    the same plan on any device."""
    ops = planner.cnn_op_costs(cfg, params)
    unbal = max(op.cycles(1) for op in ops)
    plan = planner.plan_cnn(cfg, params, DSP_TARGET)
    print(f"unbalanced bottleneck: {unbal} cycles")
    print(f"balanced bottleneck  : {plan.bottleneck_cycles} cycles "
          f"({unbal / plan.bottleneck_cycles:.1f}x, paper: 30x)")
    print(f"resources            : {plan.resources}/{DSP_TARGET} DSPs")
    slowest = sorted(plan.cycles.items(), key=lambda kv: -kv[1])[:5]
    for name, cyc in slowest:
        print(f"  {name:12s} {cyc:8d} cycles @ {plan.splits[name]} splits")
    return {"unbalanced_cycles": unbal, "plan": plan,
            "slowest": [(n, c, plan.splits[n]) for n, c in slowest]}


def serve_batch(cfg, params, device) -> dict:
    """Two 64 px images through ``cnn_forward`` on ``device`` (where
    ``params`` live): the logits (on the host), top-1 ids, finite."""
    batch = image_batch(0, batch=2, size=64)
    logits = cnn.cnn_forward(cfg, params, batch["images"],
                             device=device).cpu()
    top1 = logits.argmax(-1).numpy()
    finite = bool(torch.isfinite(logits).all())
    print(f"logits: {tuple(logits.shape)}, top-1 ids: {top1}, "
          f"finite: {finite}")
    return {"images": batch["images"], "logits": logits, "top1": top1,
            "finite": finite}


def run(device="cuda") -> dict:
    """Prune, plan and serve on ``device``. The weights are drawn on the
    CPU from a generator seeded 0 and moved to ``device``, so the card
    and the CPU serve the same weights."""
    dev = resolve_device(device)
    cfg = get_config("resnet50")
    print("== pruning + compiling (HPIPE planner, 5000 DSP target) ==")
    params = cnn.init_cnn(cfg, torch.Generator().manual_seed(0), device=dev)
    out = compile_plan(cfg, params)
    print(f"== serving a batch through the sparse conv kernels on {dev} ==")
    out.update(serve_batch(cfg, params, dev))
    out["params"] = params
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.device)


if __name__ == "__main__":
    main()
