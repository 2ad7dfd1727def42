"""Weight containers and initializers the CNN path reads
(counterpart of the reference's ``src/repro/models/layers.py``)."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class SparseWeight:
    """Block-balanced sparse weight for y = x @ W, W: (d_in, d_out).

    vals: (out_blocks, K, bm, bn) — the K surviving input blocks of each
          output block column (HPIPE: one channel split's weights,
          padded to equal length).
    idx:  (out_blocks, K) int32 — input block ids, ascending (HPIPE:
          decoded runlengths).
    d_in: input width of the dense matrix.

    ``scale``/``orig_dtype`` mark int8 codes in the reference; the int8
    path is not ported yet, so a weight that carries them is refused.
    """
    vals: torch.Tensor
    idx: torch.Tensor
    d_in: int
    scale: Optional[torch.Tensor] = None
    orig_dtype: Optional[str] = None

    def __post_init__(self):
        if self.scale is not None or self.orig_dtype is not None:
            raise NotImplementedError(
                "int8 SparseWeight (scale/orig_dtype): ROADMAP Queue 1, "
                "int8/bf16 storage")
        if self.idx.dtype != torch.int32:
            raise ValueError(f"idx must be int32, got {self.idx.dtype}")

    @property
    def d_out(self) -> int:
        return self.vals.shape[-4] * self.vals.shape[-1]

    def to(self, device) -> "SparseWeight":
        return SparseWeight(self.vals.to(device), self.idx.to(device),
                            self.d_in)


def dense_init(generator: torch.Generator, shape, in_axis_size: int,
               dtype=torch.bfloat16) -> torch.Tensor:
    """Uniform in [-1/sqrt(fan_in), 1/sqrt(fan_in)) drawn in f32 from
    ``generator``, then cast to ``dtype``. Same law as the reference's
    ``dense_init``; torch's generator gives other numbers than
    ``jax.random`` for the same seed. The tensor is made on the
    generator's device."""
    scale = 1.0 / math.sqrt(max(in_axis_size, 1))
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return w.uniform_(-scale, scale, generator=generator).to(dtype)
