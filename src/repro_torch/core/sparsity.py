"""HPIPE block-balanced weight sparsity (counterpart of the reference's
``src/repro/core/sparsity.py``): every output block column keeps exactly
K input blocks, chosen by Frobenius norm."""
from __future__ import annotations

import torch

from repro_torch.models.layers import SparseWeight


def n_keep_blocks(n_in_blocks: int, sparsity: float) -> int:
    return max(1, round((1.0 - sparsity) * n_in_blocks))


def to_block_balanced(w: torch.Tensor, cfg) -> SparseWeight:
    """Magnitude-prune dense w (d_in, d_out) to block-balanced sparsity.

    The reference's rule: block norms in f32, the top-K input blocks per
    output block column, indices sorted ascending, vals in ``w.dtype``.
    """
    d_in, d_out = w.shape
    bm, bn = cfg.block_m, cfg.block_n
    if d_in % bm or d_out % bn:
        raise ValueError(f"blocks ({bm}, {bn}) do not tile ({d_in}, {d_out})")
    ib, ob = d_in // bm, d_out // bn
    k = n_keep_blocks(ib, cfg.sparsity)
    blocks = w.reshape(ib, bm, ob, bn).permute(2, 0, 1, 3)   # (ob, ib, bm, bn)
    norms = blocks.float().square().sum(dim=(2, 3))
    idx = torch.topk(norms, k, dim=1).indices.sort(dim=1).values
    rows = torch.arange(ob, device=w.device)[:, None]
    vals = blocks[rows, idx]                                 # (ob, K, bm, bn)
    return SparseWeight(vals.contiguous(), idx.to(torch.int32).contiguous(),
                        d_in)


def densify(sw: SparseWeight) -> torch.Tensor:
    """Reconstruct the dense (d_in, d_out) matrix (pruned entries = 0)."""
    ob, _, bm, bn = sw.vals.shape
    ib = sw.d_in // bm
    dense = torch.zeros((ob, ib, bm, bn), dtype=sw.vals.dtype,
                        device=sw.vals.device)
    rows = torch.arange(ob, device=sw.vals.device)[:, None]
    dense[rows, sw.idx.long()] = sw.vals
    return dense.permute(1, 2, 0, 3).reshape(ib * bm, ob * bn)
