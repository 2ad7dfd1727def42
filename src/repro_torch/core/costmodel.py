"""Per-layer analytic throughput model (paper Sec. IV): the CNN part of
the reference's ``src/repro/core/costmodel.py``, which the planner's
stage costs and weight budget read, and the measured model's
calibration fit (``fit_scale_factors``), the LM part the stage
planner of training reads (``lm_block_flops``, ``_logits_flops``,
``lm_decode_flops``) and the dry run's analytic terms
(``step_flops_global``, ``step_bytes_per_device``,
``hbm_estimate_per_device``; ``launch/dryrun.py``): the reference's
formulas, the same floats. ``pytree_param_bytes`` lives in
``core/quant.py``.

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


# --- LM-family: FLOPs per block kind (for pipeline stage assignment) -------

def lm_block_flops(cfg, seq: int, batch: int, layer_idx: int) -> float:
    """Forward FLOPs of layer ``layer_idx`` for one (batch, seq) slab.

    Heterogeneous per layer for hybrid archs (HPIPE's whole point)."""
    d, dh = cfg.d_model, cfg.head_dim
    t = seq * batch
    f = cfg.family
    dens = (1.0 - cfg.sparsity.sparsity) if cfg.sparsity.enabled else 1.0
    attn_proj = 2 * t * d * dh * (cfg.n_heads + 2 * cfg.kv_heads) \
        + 2 * t * dh * cfg.n_heads * d
    attn_sdpa = 4 * t * seq * cfg.n_heads * dh     # scores + pv
    if cfg.attn_window:
        attn_sdpa = 4 * t * min(seq, cfg.attn_window) * cfg.n_heads * dh
    if f in ("dense", "vlm", "audio"):
        ffn = 6 * t * d * cfg.d_ff * dens
        return attn_proj + attn_sdpa + ffn
    if f == "moe":
        ffn = 6 * t * d * cfg.moe_d_ff * cfg.top_k * dens
        router = 2 * t * d * cfg.n_experts
        return attn_proj + attn_sdpa + ffn + router
    if f == "ssm":      # rwkv6
        tmix = 2 * t * d * (4 * d) * dens
        wkv = 4 * t * dh * dh * cfg.n_heads
        cmix = 2 * t * d * (2 * cfg.d_ff) * dens
        return tmix + wkv + cmix
    if f == "hybrid":   # zamba2: mamba layer (+ shared attn block at sites)
        d_in = cfg.ssm_expand * d
        proj = 2 * t * d * (2 * d_in + 2 * cfg.ssm_state) * dens \
            + 2 * t * d_in * d * dens
        ssd = 6 * t * d_in * cfg.ssm_state
        cost = proj + ssd
        if cfg.hybrid_attn_every and (layer_idx + 1) % cfg.hybrid_attn_every == 0:
            cost += attn_proj + attn_sdpa + 6 * t * d * cfg.d_ff * dens
        return cost
    raise ValueError(f)


def _logits_flops(cfg, tokens: int) -> float:
    return 2.0 * tokens * cfg.d_model * cfg.vocab_size


def lm_decode_flops(cfg, kv_len: int, batch: int, layer_idx: int) -> float:
    """One-token decode FLOPs for layer ``layer_idx`` (cache len kv_len)."""
    d, dh = cfg.d_model, cfg.head_dim
    t = batch
    f = cfg.family
    dens = (1.0 - cfg.sparsity.sparsity) if cfg.sparsity.enabled else 1.0
    attn_proj = 2 * t * d * dh * (cfg.n_heads + 2 * cfg.kv_heads) \
        + 2 * t * dh * cfg.n_heads * d
    win = min(kv_len, cfg.attn_window) if cfg.attn_window else kv_len
    attn_sdpa = 4 * t * win * cfg.n_heads * dh
    if f in ("dense", "vlm", "audio"):
        ffn = 6 * t * d * cfg.d_ff * dens
        extra = attn_proj + attn_sdpa          # audio: + cross attn
        if f == "audio":
            extra += attn_proj + 4 * t * cfg.encoder_seq * cfg.n_heads * dh
        return extra + ffn
    if f == "moe":
        return attn_proj + attn_sdpa + 6 * t * d * cfg.moe_d_ff * cfg.top_k \
            * dens + 2 * t * d * cfg.n_experts
    if f == "ssm":      # rwkv6 single step: proj + state update
        return 2 * t * d * 4 * d * dens + 4 * t * cfg.n_heads * dh * dh \
            + 2 * t * d * 2 * cfg.d_ff * dens
    if f == "hybrid":
        d_in = cfg.ssm_expand * d
        cost = 2 * t * d * (2 * d_in + 2 * cfg.ssm_state) * dens \
            + 2 * t * d_in * d * dens + 6 * t * d_in * cfg.ssm_state
        if cfg.hybrid_attn_every and (layer_idx + 1) % cfg.hybrid_attn_every == 0:
            cost += attn_proj + attn_sdpa + 6 * t * d * cfg.d_ff * dens
        return cost
    raise ValueError(f)


# --- the dry run's analytic terms (the reference's formulas) ------------

def step_flops_global(cfg, shape) -> float:
    """Total FLOPs of the cell's program across the fleet."""
    b, t = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        per_layer = sum(lm_decode_flops(cfg, t, b, l)
                        for l in range(cfg.n_layers))
        return per_layer + _logits_flops(cfg, b)
    fwd = sum(lm_block_flops(cfg, t, b, l) for l in range(cfg.n_layers))
    if cfg.encoder_layers:
        enc = cfg.encoder_layers * lm_block_flops(
            cfg, cfg.encoder_seq, b, 0)
        fwd += enc
    if shape.kind == "prefill":
        return fwd + _logits_flops(cfg, b)     # last-token logits only
    # train: fwd + 2x bwd + ~1x remat recompute (remat="full")
    logits = 3.0 * _logits_flops(cfg, b * t)
    return 4.0 * fwd + logits


def _param_bytes_local(cfg, n_model_shards: int, pure_dp: bool) -> float:
    n = cfg.n_params()
    return 2.0 * n / (1 if pure_dp else n_model_shards)


def step_bytes_per_device(cfg, shape, *, n_chips: int, n_model_shards: int,
                          pure_dp: bool) -> float:
    """First-order HBM traffic per device per step."""
    b, t = shape.global_batch, shape.seq_len
    d = cfg.d_model
    w_local = _param_bytes_local(cfg, n_model_shards, pure_dp)
    dp = n_chips if pure_dp else max(n_chips // n_model_shards, 1)
    if shape.kind == "decode":
        toks_local = max(b // dp, 1)
        # weights once; KV/state cache read+write; small activations
        kvh, dh = cfg.kv_heads, cfg.head_dim
        if cfg.family in ("dense", "vlm", "moe", "audio"):
            cache = 2.0 * cfg.n_layers * b * t * kvh * dh * 2 / n_chips * \
                (1 + 1 / max(t, 1))            # read all, write 1 slot
        elif cfg.family == "ssm":
            cache = 2.0 * cfg.n_layers * b * cfg.n_heads * dh * dh * 4 \
                / n_chips
        else:
            nh = cfg.ssm_expand * d // dh
            cache = 2.0 * cfg.n_layers * b * (nh * cfg.ssm_state * dh * 4 +
                                              (cfg.attn_window or t) * kvh
                                              * dh * 2) / n_chips
        act = 20.0 * cfg.n_layers * toks_local * d * 2
        return w_local + cache + act
    toks_local = b * t / dp
    act_factor = 12.0                          # reads+writes per layer slab
    act = act_factor * cfg.n_layers * toks_local * d * 2
    logits = 2.0 * toks_local * cfg.vocab_size * 4 / (
        1 if pure_dp else n_model_shards)
    if shape.kind == "prefill":
        return w_local + act + logits / max(t, 1)
    # train: weights read 3x (fwd/bwd/remat), grads + opt state f32 rw
    opt = (4.0 + 16.0) * cfg.n_params() / (
        (1 if pure_dp else n_model_shards) * 1.0)
    return 3.0 * w_local + opt + 2.5 * act + logits


def hbm_estimate_per_device(cfg, shape, *, n_chips: int,
                            n_model_shards: int, pure_dp: bool) -> float:
    """Resident bytes per device, analytic: bf16 weights and caches,
    f32 moments sharded over data (ZeRO-1), f32 gradients, the remat
    boundaries and one layer's backward working set."""
    b, t = shape.global_batch, shape.seq_len
    d = cfg.d_model
    tp = 1 if pure_dp else n_model_shards
    dp = n_chips // tp
    dp_shards = dp
    n = cfg.n_params()
    params = 2.0 * n / tp
    b_loc = max(b // dp, 1)
    if shape.kind == "decode":
        kvh, dh = cfg.kv_heads, cfg.head_dim
        if cfg.family in ("dense", "vlm", "moe", "audio"):
            cache = 2.0 * cfg.n_layers * b * t * kvh * dh * 2 / n_chips
            if cfg.family == "audio":
                cache += 2.0 * cfg.n_layers * b * cfg.encoder_seq * kvh \
                    * dh * 2 / n_chips
        elif cfg.family == "ssm":
            cache = cfg.n_layers * b * cfg.n_heads * dh * dh * 4 / dp
        else:
            nh = cfg.ssm_expand * d // dh
            cache = cfg.n_layers * b * (nh * cfg.ssm_state * dh * 4) / dp \
                + 2.0 * (cfg.n_layers // max(cfg.hybrid_attn_every, 1)) \
                * b * min(cfg.attn_window or t, t) * kvh * dh * 2 / n_chips
        act = 8.0 * b_loc * d * 2 * 4                  # tiny decode slabs
        return params + 2.0 * cache + act              # in + out buffers
    t_loc = t / (1 if pure_dp else tp)
    if shape.kind == "prefill":
        live = 8.0 * b_loc * t_loc * d * 2             # flash working set
        return params + live
    opt = 8.0 * n / (tp * dp_shards)                   # m+v f32 (ZeRO-1)
    grads = 4.0 * n / tp                               # transient f32
    boundary = cfg.n_layers * b_loc * t_loc * d * 2    # remat saves
    live = 12.0 * b_loc * t_loc * max(d, 1) * 2        # one layer's bwd
    return params + opt + grads + boundary + live
