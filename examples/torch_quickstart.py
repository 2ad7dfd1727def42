"""Quickstart on the PyTorch port: train a reduced LM for 30 steps, then
serve it, on the card (flash attention and the block-sparse FFN
kernels).

    PYTHONPATH=src python examples/torch_quickstart.py [--arch smollm-360m]
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402


def run(arch: str = "smollm-360m", *, steps: int = 30,
        device="cuda") -> dict:
    """Train ``arch`` (reduced) for ``steps`` steps, then serve a fresh
    draw of it through ``serve(arch, ...)``, the pre-ServeConfig form.
    Returns the training losses and the generated token ids."""
    print(f"== training {arch} (reduced) ==")
    out = train(arch, steps=steps, batch=8, seq=64, lr=3e-3, device=device)
    print(f"loss: {out['losses'][0][1]:.3f} -> {out['losses'][-1][1]:.3f}")
    print(f"== serving {arch} (reduced) ==")
    gen = serve(arch, batch=2, prompt_len=8, gen_tokens=8, max_seq=32,
                device=device)
    print("generated token ids:\n", gen["tokens"])
    return {"losses": out["losses"], "tokens": gen["tokens"]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.arch, device=args.device)


if __name__ == "__main__":
    main()
