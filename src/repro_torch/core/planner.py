"""The HPIPE network compiler's stage planner on the port: the
layer -> pipeline-stage assignment of the reference's
``src/repro/core/planner.py`` (``assign_stages``, ``cnn_node_costs``,
``_plan_1d``, ``pipeline_throughput_rel``, ``PlanRequest``,
``PipelinePlan`` and ``plan()``), with the analytic cost model.

A contiguous partition of the fused layer graph minimizing the max
per-stage cycle sum (linear-partition DP): slow layers get more of the
device, as HPIPE gives them more DSPs. On one card the stages are CUDA
streams (``core/pipeline.py``), not devices.

Not ported yet, and raising ``NotImplementedError`` where they would
start: the (stages, replicas) co-planner and re-planner
(``PlanRequest(n_devices=...)``) and the measured cost model
(``model="measured"``, a tuning cache): ROADMAP Queue 1 item 5.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

from repro_torch.core.costmodel import (node_weight_bytes, op_cost_conv_sparse,
                                        op_cost_dense, op_cost_dw,
                                        op_cost_from_sparse,
                                        op_cost_fused_dw_pw)
from repro_torch.core.fusion import conv_part, fused_graph_for
from repro_torch.core.quant import STORE_DTYPES
from repro_torch.models.layers import SparseWeight

_CO_PLANNER = ("ROADMAP Queue 1 item 5 (the (stages, replicas) co-planner, "
               "the measured cost model and tuning)")


def assign_stages(costs: np.ndarray, n_stages: int, *,
                  weights: Optional[np.ndarray] = None,
                  weight_budget: Optional[float] = None) -> list[int]:
    """Contiguous linear partition of ``costs`` into AT MOST ``n_stages``
    groups minimizing the max group sum. Returns one stage id per layer.

    Contract: ``n_stages`` is clamped to ``len(costs)`` — asking for
    more stages than layers yields one layer per stage, never empty
    stages. Callers size downstream structures from
    ``max(stage_of) + 1``, not from the requested ``n_stages``.

    Memory-aware mode (``weights`` + ``weight_budget``): ``weights[l]``
    is layer l's weight-residency bytes; the DP only considers groups
    whose weight sum fits the budget, so cuts rebalance around the
    memory wall. Raises ``ValueError`` when no contiguous
    ``n_stages``-partition fits (a single layer over budget, or too few
    stages)."""
    n = len(costs)
    if n == 0:
        raise ValueError("assign_stages needs at least one layer cost")
    if n_stages < 1:
        raise ValueError(f"n_stages must be >= 1, got {n_stages}")
    budgeted = weights is not None and weight_budget is not None
    if budgeted:
        weights = np.asarray(weights, dtype=np.float64)
        if len(weights) != n:
            raise ValueError(f"{len(weights)} weights for {n} layers")
        over = [i for i in range(n) if weights[i] > weight_budget]
        if over:
            raise ValueError(
                f"layer(s) {over} alone exceed the per-stage weight "
                f"budget ({weights[over[0]]:.0f} > {weight_budget:.0f} "
                "bytes); a contiguous partition cannot fit — raise the "
                "budget or split the layer")
        wprefix = np.concatenate([[0.0], np.cumsum(weights)])
    if n_stages >= n:
        return list(range(n))             # one layer per stage: minimal
    prefix = np.concatenate([[0.0], np.cumsum(costs)])

    def group_cost(i, j):                 # layers [i, j)
        return prefix[j] - prefix[i]

    def group_fits(i, j):
        return (not budgeted
                or wprefix[j] - wprefix[i] <= weight_budget)

    INF = float("inf")
    dp = np.full((n_stages + 1, n + 1), INF)
    cut = np.zeros((n_stages + 1, n + 1), np.int64)
    dp[0, 0] = 0.0
    for s in range(1, n_stages + 1):
        for j in range(1, n + 1):
            for i in range(s - 1, j):
                if dp[s - 1, i] == INF or not group_fits(i, j):
                    continue
                c = max(dp[s - 1, i], group_cost(i, j))
                if c < dp[s, j]:
                    dp[s, j] = c
                    cut[s, j] = i
    if dp[n_stages, n] == INF:
        raise ValueError(
            f"no contiguous {n_stages}-stage partition of {n} layers "
            f"fits the per-stage weight budget {weight_budget:.0f} "
            "bytes; allow more stages or raise the budget")
    bounds = [n]
    j = n
    for s in range(n_stages, 0, -1):
        j = int(cut[s, j])
        bounds.append(j)
    bounds = bounds[::-1]                 # [0, ..., n]
    stage_of = []
    for s in range(n_stages):
        stage_of += [s] * (bounds[s + 1] - bounds[s])
    return stage_of


def cnn_node_costs(cfg, params, graph=None, *, model: str = "analytic"):
    """Per-IR-node cycle estimates for stage assignment (defaults to the
    FUSED graph, matching the interpreter).

    Sparse convs are priced from their true per-split gather counts
    (``op_cost_conv_sparse``), dense convs / fc from their dot-unit
    cycles, depthwise convs from their per-channel MAC chains, fused
    dw->pw super-nodes at the slower sub-unit's rate. A fused residual
    or pooling epilogue adds one line pass; pools and standalone adds
    are one pass over their output lines."""
    if model not in ("analytic", "measured"):
        raise ValueError(f"unknown cost model {model!r}")
    if model == "measured":
        raise NotImplementedError(f"model='measured': {_CO_PLANNER}")
    g = graph if graph is not None else fused_graph_for(cfg.name)
    costs = []
    for s in g.nodes:
        if s.kind == "conv":
            w = params[conv_part(s).name]["w"]
            # a pooled conv (fusion R4) computes at its own pre-pool
            # resolution; the pool epilogue is one extra line pass
            ohw = s.conv_out_hw
            if isinstance(w, SparseWeight):
                c = op_cost_conv_sparse(s.name, w, s.k, s.cin,
                                        ohw, ohw).cycles(1)
            else:
                c = op_cost_dense(s.name, max(s.k * s.k * s.cin // 8, 1),
                                  s.cout, ohw, ohw).cycles(1)
            if s.pool_k:
                c += max(ohw, 1)
        elif s.kind == "dw_pw":
            pw_w = params[conv_part(s).name]["w"]
            sw = pw_w if isinstance(pw_w, SparseWeight) else None
            c = op_cost_fused_dw_pw(s.name, s.k, s.cin, s.cout,
                                    s.out_hw, s.out_hw, pw_sw=sw).cycles(1)
        elif s.kind in ("fc", "avgpool_fc"):
            w = params[conv_part(s).name]["w"]
            if isinstance(w, SparseWeight):
                c = op_cost_from_sparse(s.name, w, 1, 1).cycles(1)
            else:
                c = op_cost_dense(s.name, max(s.cin // 8, 1), s.cout,
                                  1, 1).cycles(1)
            if s.kind == "avgpool_fc":      # fused pool: one line pass
                c += max(s.in_hw, 1)
        elif s.kind == "dw":
            c = op_cost_dw(s.name, s.k, s.cin, s.out_hw, s.out_hw).cycles(1)
        else:                       # maxpool/avgpool/add: line-rate companions
            c = max(s.out_hw, 1)
        if s.residual_from and s.kind != "add":
            c += max(s.out_hw, 1)           # fused residual epilogue
        costs.append(float(c))
    return np.asarray(costs)


def _plan_1d(cfg, params, n_stages: int, graph=None, *,
             max_stage_param_bytes: Optional[int] = None,
             model: str = "analytic", store_dtype: str = "native") -> dict:
    """Cost-balanced stage assignment for a CNN layer graph: contiguous
    partition of the (fused) IR minimizing the max per-stage cycle sum,
    with the weight-residency accounting (``node_param_bytes`` /
    ``stage_param_bytes``, priced at ``store_dtype``) and the optional
    per-stage byte budget ``max_stage_param_bytes``."""
    g = graph if graph is not None else fused_graph_for(cfg.name)
    costs = cnn_node_costs(cfg, params, graph=g, model=model)
    wbytes = np.array([node_weight_bytes(node, params, store_dtype)
                       for node in g.nodes], dtype=np.float64)
    stage_of = assign_stages(
        costs, n_stages,
        weights=wbytes if max_stage_param_bytes is not None else None,
        weight_budget=max_stage_param_bytes)
    used = max(stage_of) + 1
    stage_cost = np.zeros(used)
    stage_bytes = np.zeros(used)
    for l, s in enumerate(stage_of):
        stage_cost[s] += costs[l]
        stage_bytes[s] += wbytes[l]
    return {
        "stage_of": stage_of,
        "n_stages": used,
        "stage_cost": stage_cost,
        "imbalance": float(stage_cost.max() / max(stage_cost.mean(), 1.0)),
        "node_cycles": costs,
        "node_param_bytes": wbytes,
        "stage_param_bytes": stage_bytes,
        "param_budget_bytes": max_stage_param_bytes,
        # the ACHIEVED residency (largest stage), not the budget kwarg
        "placed_bytes_per_device": float(stage_bytes.max()),
        "cost_model": model,
        "measured_coverage": None,
        "store_dtype": store_dtype,
    }


def pipeline_throughput_rel(stage_cost, n_replicas: int,
                            n_microbatches: int) -> float:
    """Latency-bounded relative throughput of one (stages, replicas)
    split: images/cycle across R replicas of an S-stage pipeline fed M
    microbatches each. The bottleneck stage sets the tick rate, every
    replica delivers one microbatch per tick in steady state, and the
    fill/drain bubble scales it by M/(M + S - 1)."""
    stage_cost = np.asarray(stage_cost, dtype=np.float64)
    s = len(stage_cost)
    fill = n_microbatches / (n_microbatches + s - 1)
    return float(n_replicas * fill / max(stage_cost.max(), 1e-30))


@dataclass(frozen=True)
class PlanRequest:
    """The resources one planning call is given — the single argument
    of :func:`plan`. Exactly one of ``n_stages`` (fixed-depth cut) or
    ``n_devices`` (the co-plan, not ported) must be provided.
    ``store_dtype`` prices weight residency at the quantized width."""
    n_stages: Optional[int] = None
    n_devices: Optional[int] = None
    n_microbatches: int = 8
    max_stage_param_bytes: Optional[int] = None
    model: str = "analytic"
    tuning_cache: Any = None
    store_dtype: str = "native"
    prev: Optional[dict] = None

    def __post_init__(self):
        if self.store_dtype not in STORE_DTYPES:
            raise ValueError(f"store_dtype must be one of {STORE_DTYPES}, "
                             f"got {self.store_dtype!r}")
        if (self.n_stages is None) == (self.n_devices is None):
            raise ValueError("exactly one of n_stages / n_devices must "
                             "be set on a PlanRequest")


class PipelinePlan(dict):
    """A plan dict with attribute access (``p.stage_of`` ==
    ``p["stage_of"]``)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None


def plan(cfg, params, request: PlanRequest, *, graph=None) -> PipelinePlan:
    """THE planning entrypoint: the contiguous ``request.n_stages``-stage
    cut of the fused graph. ``n_devices`` (the (stages, replicas)
    co-plan and its re-plan) raises ``NotImplementedError``."""
    if request.n_devices is not None:
        raise NotImplementedError(f"PlanRequest(n_devices=...): {_CO_PLANNER}")
    return PipelinePlan(_plan_1d(
        cfg, params, request.n_stages, graph=graph,
        max_stage_param_bytes=request.max_stage_param_bytes,
        model=request.model, store_dtype=request.store_dtype))
