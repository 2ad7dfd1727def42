"""Plain oracles for the kernels of this package."""
from __future__ import annotations

import torch

from repro_torch.core.sparsity import densify


def sparse_matmul_ref(x: torch.Tensor, sw) -> torch.Tensor:
    """Densify-then-matmul oracle for the block-balanced sparse matmul."""
    w = densify(sw)
    return torch.einsum("...i,io->...o", x.float(), w.float()).to(x.dtype)
