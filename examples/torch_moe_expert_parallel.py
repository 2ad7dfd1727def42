"""Beyond the paper, on the PyTorch port: HPIPE-style heterogeneous
stage balancing applied to a modern MoE + a hybrid SSM LM, showing the
planner's layer->stage cuts and a short training run for each on the
card.

    PYTHONPATH=src python examples/torch_moe_expert_parallel.py
    PYTHONPATH=src python examples/torch_moe_expert_parallel.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import planner  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402

ARCHS = ("granite-moe-3b-a800m", "zamba2-7b")


def plans() -> dict:
    """Each arch's 4-stage cut at its published size (seq 4096, batch
    16): the planner's output, the cuts and the layer-cost spread."""
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch)
        p = planner.plan_lm_stages(cfg, 4096, 16, n_stages=4)
        cuts = [p["stage_of"].index(s) for s in range(1, 4)]
        hetero = p["layer_flops"].max() / p["layer_flops"].min()
        print(f"{arch}: layer costs hetero {hetero:.2f}x, "
              f"4-stage cuts at layers {cuts}, "
              f"imbalance {p['imbalance']:.3f}")
        out[arch] = {"plan": p, "cuts": cuts, "hetero": float(hetero)}
    return out


def run(*, steps: int = 20, device="cuda") -> dict:
    """The cuts, then ``steps`` training steps of each arch's reduced
    config on ``device``. Returns {arch: {"plan", "cuts", "hetero",
    "losses"}}."""
    out = plans()
    print("\n== short training runs (reduced configs) ==")
    for arch in ARCHS:
        res = train(arch, steps=steps, batch=4, seq=32, lr=3e-3,
                    verbose=False, device=device)
        losses = [l for _, l in res["losses"]]
        print(f"{arch}: loss {losses[0]:.3f} -> {np.mean(losses[-3:]):.3f}")
        out[arch]["losses"] = losses
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(device=args.device)


if __name__ == "__main__":
    main()
