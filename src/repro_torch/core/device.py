"""Device choice for the port's entry points: the card unless the caller
asks for the CPU, and never a silent move from one to the other."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; raises if it names CUDA and there is no
    card, instead of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but CUDA is not available: the port "
            "runs on the card; pass device='cpu' for its plain CPU path")
    return dev
