"""End-to-end run on the PyTorch port: train a reduced model for a few
hundred steps on the card with the full production substrate — async
checkpoints, TWO injected node failures with restart-from-checkpoint,
straggler detection, and int8 gradient compression.

The error-feedback state of the compression is not carried from step to
step (as in the reference's ``train()``): each step's gradients are
compressed afresh.

    PYTHONPATH=src python examples/torch_resilient_training.py
    PYTHONPATH=src python examples/torch_resilient_training.py --device cpu
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.launch.train import train  # noqa: E402


def run(device="cuda", *, steps: int = 200) -> dict:
    """``train()`` of reduced SmolLM-360M for ``steps`` steps, a checkpoint
    every 25 steps into a temporary directory and a simulated node
    failure at steps 60 and 140. Returns ``train()``'s result."""
    with tempfile.TemporaryDirectory() as ckpt_dir:
        out = train(
            "smollm-360m", steps=steps, batch=8, seq=128,
            ckpt_dir=ckpt_dir, ckpt_every=25,
            fail_at=(60, 140),          # two simulated node failures
            grad_compress=True,
            lr=3e-3, log_every=25, device=device,
        )
    losses = [l for _, l in out["losses"]]
    print(f"\nrestarts survived : {out['restarts']}")
    print(f"stragglers flagged: {len(out['stragglers'])}")
    print(f"loss              : {losses[0]:.3f} -> "
          f"{np.mean(losses[-10:]):.3f}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args.device)
    losses = [l for _, l in out["losses"]]
    assert out["restarts"] == 2
    assert np.mean(losses[-10:]) < losses[0]
    print("OK")


if __name__ == "__main__":
    main()
