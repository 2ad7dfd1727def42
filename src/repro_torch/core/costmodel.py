"""Per-layer analytic throughput model (paper Sec. IV): the CNN part of
the reference's ``src/repro/core/costmodel.py``, which the planner's
stage costs and weight budget read, and the measured model's
calibration fit (``fit_scale_factors``).

HPIPE stages process one output line (1 x W x Co) at a time; a layer with
``n_channel_splits = s`` partitions each output channel's surviving
weights across s splits and the *max-loaded* split governs the cycle
count (the compiler pads every split to that max). Two models:

  - ``naive``:  cycles(s) = lines * ceil(nnz_total / s)
  - ``aware``:  cycles(s) = lines * sum_co max_split nnz_split(co)

Everything here is numpy over the weights' structure (block ids and
shapes), never over their values, so a plan from the port's weights
equals the reference's plan from the same weights.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.quant import pytree_param_bytes
from repro_torch.kernels.sparse_conv import conv_block_coords


def _idx_numpy(sw) -> np.ndarray:
    return sw.idx.detach().cpu().numpy()


@dataclass
class OpCost:
    """One pipeline-stage candidate (a layer) for the planner."""
    name: str
    lines: int                    # output lines per image (H_out)
    width: int                    # output line width (W_out) = multipliers/split
    nnz_per_co: np.ndarray        # surviving weights per output channel (Co,)
    n_in_units: int               # partitionable input units (blocks/channels)
    idx: Optional[np.ndarray] = None   # (Co, K) surviving unit ids (for aware)
    mask: Optional[np.ndarray] = None  # (n_in_units, Co) unstructured mask

    def cycles(self, splits: int, model: str = "aware") -> int:
        splits = max(1, min(splits, self.n_in_units))
        if model == "naive" or (self.idx is None and self.mask is None):
            per_line = int(np.ceil(self.nnz_per_co / splits).sum())
            return max(1, self.lines * per_line)
        # partition-aware: split s owns units [s*n/splits, (s+1)*n/splits)
        bounds = (np.arange(1, splits + 1) * self.n_in_units) // splits
        if self.mask is not None:
            # unstructured: per co, max over splits of surviving weights
            owner = np.searchsorted(bounds,
                                    np.arange(self.n_in_units), side="right")
            seg = np.zeros((splits, self.mask.shape[1]), np.int64)
            np.add.at(seg, owner, self.mask.astype(np.int64))
            return max(1, self.lines * int(seg.max(axis=0).sum()))
        owner = np.searchsorted(bounds, self.idx, side="right")
        # per output channel, the max-loaded split (after padding)
        counts = np.apply_along_axis(
            lambda o: np.bincount(o, minlength=splits).max(), 1, owner)
        return max(1, self.lines * int(counts.sum()))

    def resource(self, splits: int) -> int:
        """DSP blocks consumed (2 multipliers per Stratix 10 DSP)."""
        return splits * max(1, -(-self.width // 2))


def op_cost_from_sparse(name: str, sw, lines: int, width: int) -> OpCost:
    """Build an OpCost from an actual pruned weight (a SparseWeight)."""
    idx = _idx_numpy(sw)                          # (Co_blocks, K)
    nnz = np.full(idx.shape[0], idx.shape[1], np.int64)
    return OpCost(name=name, lines=lines, width=width, nnz_per_co=nnz,
                  n_in_units=sw.d_in // sw.vals.shape[-2], idx=idx)


def op_cost_unstructured(name: str, mask, lines: int, width: int) -> OpCost:
    """Unstructured scalar sparsity (the paper's own format): ``mask``
    (d_in, Co) bool of surviving weights (reference
    ``core/costmodel.py:191``). Zeros clump, so split loads are uneven:
    what exposes the naive model's error."""
    mask = np.asarray(mask, bool)
    return OpCost(name=name, lines=lines, width=width,
                  nnz_per_co=mask.sum(axis=0).astype(np.int64),
                  n_in_units=mask.shape[0], mask=mask)


def op_cost_conv_sparse(name: str, sw, k: int, cin: int, lines: int,
                        width: int) -> OpCost:
    """Cost of the fused implicit-GEMM sparse conv.

    Each surviving block is one (ky, kx, channel-block) gather of the
    unexpanded activation, so the partitionable unit axis is ordered
    channel-block-major (flat id = cb*k*k + ky*k + kx): a channel split
    owns a contiguous range of line-buffer channel blocks, and its
    per-output-column load is its surviving-block *gather count*.
    """
    bm = sw.vals.shape[-2]
    assert cin % bm == 0, (cin, bm)
    cpb = cin // bm
    idx = _idx_numpy(sw)
    ky, kx, cb = conv_block_coords(idx, k, cin, bm)   # the kernel's decode
    gather_id = cb * (k * k) + ky * k + kx            # channel-major unit axis
    nnz = np.full(idx.shape[0], idx.shape[1], np.int64)
    return OpCost(name=name, lines=lines, width=width, nnz_per_co=nnz,
                  n_in_units=cpb * k * k, idx=gather_id)


def op_cost_dense(name: str, cin_units: int, cout: int, lines: int,
                  width: int, nnz_per_co: Optional[int] = None) -> OpCost:
    nnz = np.full(cout, nnz_per_co if nnz_per_co else cin_units, np.int64)
    return OpCost(name=name, lines=lines, width=width, nnz_per_co=nnz,
                  n_in_units=cin_units, idx=None)


def op_cost_dw(name: str, k: int, cin: int, lines: int, width: int) -> OpCost:
    """Depthwise conv (HPIPE's DepthwiseConv2D unit): one k*k MAC chain
    per channel, no cross-channel reduction — the partitionable unit
    axis is the k*k taps."""
    nnz = np.full(cin, k * k, np.int64)
    return OpCost(name=name, lines=lines, width=width, nnz_per_co=nnz,
                  n_in_units=k * k, idx=None)


def op_cost_fused_dw_pw(name: str, k: int, cin: int, cout: int, lines: int,
                        width: int, pw_sw=None) -> OpCost:
    """Fused depthwise->pointwise super-node: the two sub-units run in
    lockstep on the same output line, so the SLOWER one governs the
    cycle count. Returns the dominant sub-unit's OpCost renamed to the
    fused node."""
    dw = op_cost_dw(name + ".dw", k, cin, lines, width)
    if pw_sw is not None:
        pw = op_cost_from_sparse(name + ".pw", pw_sw, lines, width)
    else:
        pw = op_cost_dense(name + ".pw", max(cin // 8, 1), cout, lines,
                           width)
    dom = dw if dw.cycles(1) >= pw.cycles(1) else pw
    return dataclasses.replace(dom, name=name)


def node_weight_bytes(node, params, store_dtype: str = "native") -> int:
    """Weight-residency bytes of one (possibly fused) IR node: the param
    bytes of every part the node executes, priced at ``store_dtype``
    (the planner's ``max_stage_param_bytes`` budget prices stages with
    it)."""
    parts = node.parts or (node,)
    return sum(pytree_param_bytes(params[p.name], store_dtype)
               for p in parts if p.name in params)


def fit_scale_factors(measured_us, analytic_cycles, kinds) -> dict:
    """Calibration fit for the measured cost model (``core/tuning.py``):
    per-op-kind scale factors mapping analytic cycles to measured
    microseconds, plus a ``"*"`` global fallback.

    Each scale is the geometric mean of the measured / analytic ratios of
    that kind's profiled nodes (the minimizer of mean squared log error,
    so one slow outlier shifts the fit by its log, not its magnitude).
    Uncached shapes are then priced at ``analytic * scale[kind]``
    (falling back to ``scale["*"]``), which keeps the analytic model's
    order within a kind while taking the device's absolute rates."""
    ratios: dict[str, list] = {}
    for t, a, k in zip(measured_us, analytic_cycles, kinds):
        if t is None or t <= 0 or a <= 0:
            continue
        r = float(np.log(t / a))
        ratios.setdefault(k, []).append(r)
        ratios.setdefault("*", []).append(r)
    return {k: float(np.exp(np.mean(v))) for k, v in ratios.items()}
