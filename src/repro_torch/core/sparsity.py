"""HPIPE block-balanced weight sparsity (counterpart of the reference's
``src/repro/core/sparsity.py``): every output block column keeps exactly
K input blocks, chosen by Frobenius norm; and the helpers the
reference's benchmarks read: the density of a pruned weight, the
paper's run-length weight stream, the per-split block counts of the
partition-aware cost model, and unstructured masks (numpy, so a mask
drawn from a seed is the reference's bit for bit)."""
from __future__ import annotations

import numpy as np
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


def density(sw: SparseWeight) -> float:
    """The kept fraction of a block-balanced weight's input rows."""
    _, k, bm, _ = sw.vals.shape
    return k * bm / sw.d_in


# --- the paper's weight stream format (storage layer) ----------------------

def encode_runlength(idx) -> np.ndarray:
    """Delta-encode ascending block indices per output column: (ob, K)
    -> run lengths (ob, K) int32, ``rl[j, 0] = idx[j, 0]`` and
    ``rl[j, k] = idx[j, k] - idx[j, k - 1]`` (HPIPE's weight-buffer
    run-length stream at block granularity)."""
    idx = np.asarray(idx)
    rl = np.diff(idx, axis=1, prepend=np.zeros((idx.shape[0], 1), idx.dtype))
    return rl.astype(np.int32)


def decode_runlength(rl) -> np.ndarray:
    return np.cumsum(rl, axis=1).astype(np.int32)


def partition_for_splits(sw: SparseWeight, n_splits: int):
    """Per-split block counts per output column when a sparse weight's
    input blocks are split over ``n_splits`` channel splits (split s
    owns input blocks ``[s*ib/n, (s+1)*ib/n)``). Returns ``(counts
    (ob, n_splits) int64, padded_len)``: the max count, which governs
    the cycles (the paper's partition-aware cost model)."""
    idx = sw.idx.detach().cpu().numpy()
    ib = sw.d_in // sw.vals.shape[2]
    bounds = (np.arange(1, n_splits + 1) * ib) // n_splits
    owner = np.searchsorted(bounds, idx, side="right")          # (ob, K)
    counts = np.zeros((idx.shape[0], n_splits), np.int64)
    for s in range(n_splits):
        counts[:, s] = (owner == s).sum(axis=1)
    padded = int(counts.max()) if counts.size else 0
    return counts, padded


def unstructured_mask(key, shape, sparsity: float, *, clump: float = 0.5):
    """An unstructured scalar pruning mask (d_in, d_out) whose zeros
    clump as magnitude pruning's do (per row band and column, a
    lognormal density perturbation; ``clump`` 0 is iid). Drawn from
    ``np.random.default_rng(int(key))``, so the reference's key gives
    its mask bit for bit."""
    rng = np.random.default_rng(int(key))
    d_in, d_out = shape
    bands = max(d_in // 16, 1)
    row_band = np.repeat(np.arange(bands), -(-d_in // bands))[:d_in]
    dens = 1.0 - sparsity
    pert = rng.lognormal(0.0, clump, size=(bands, d_out))
    p = np.clip(dens * pert / pert.mean(), 0.0, 1.0)
    u = rng.random((d_in, d_out))
    return u < p[row_band, :]
