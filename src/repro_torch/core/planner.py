"""The HPIPE network compiler's planning passes on the port: the
reference's ``src/repro/core/planner.py`` for the CNNs.

1. ``balance()``: the paper's greedy throughput balancer: while the
   resource budget allows, give one more channel split to the slowest
   layer (Sec. IV); ``plan_cnn()`` runs it over the pruned weights (the
   Fig. 3 reproduction).
2. ``assign_stages()``: layer -> pipeline-stage assignment, a contiguous
   partition of the fused layer graph minimizing the max per-stage cost
   (linear-partition DP): slow layers get more of the device, as HPIPE
   gives them more DSPs. The costs are the analytic (FPGA cycle) model's
   or, with ``model="measured"``, a tuning cache's times measured on the
   device (``core/tuning.py``).
3. ``plan()``: the front door: the fixed-depth cut, the (stages,
   replicas) co-plan of ``n_devices`` and its degradation re-plan.
4. ``plan_lm_stages()``: an LM's layers cut into pipeline stages by
   their forward FLOPs (the stage-pipelined train step,
   ``launch/steps.make_pipeline_train_step``).

On one card the stages are CUDA streams (``core/pipeline.py``); a
co-plan over ``torch.cuda.device_count()`` devices gives S = 1, R = 1
there, as the reference does on one device.
"""
from __future__ import annotations

import heapq
import warnings
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

from repro_torch.core.costmodel import (OpCost, lm_block_flops,
                                        node_weight_bytes,
                                        op_cost_conv_sparse, op_cost_dense,
                                        op_cost_dw, op_cost_from_sparse,
                                        op_cost_fused_dw_pw)
from repro_torch.core.fusion import conv_part, fused_graph_for
from repro_torch.core.quant import STORE_DTYPES
from repro_torch.models.layers import SparseWeight



@dataclass
class Plan:
    splits: dict[str, int]
    cycles: dict[str, int]               # at chosen splits
    resources: int
    budget: int
    model: str

    @property
    def bottleneck_cycles(self) -> int:
        return max(self.cycles.values())

    @property
    def throughput_rel(self) -> float:
        """Images/cycle (relative units): 1 / slowest stage."""
        return 1.0 / self.bottleneck_cycles

    def balance_spread(self) -> float:
        """max/min cycle ratio over the balanced (split-incremented) ops."""
        inc = [c for n, c in self.cycles.items() if self.splits[n] > 1]
        vals = inc if len(inc) >= 2 else list(self.cycles.values())
        return max(vals) / max(min(vals), 1)


def balance(ops: list[OpCost], budget: int, *, model: str = "aware",
            max_splits: int = 4096) -> Plan:
    """Greedy: repeatedly add a split to the op with max cycles.

    Uses a heap keyed on (-cycles); stops when the next increment would
    exceed ``budget`` or the slowest op can no longer be split."""
    splits = {op.name: 1 for op in ops}
    cycles = {op.name: op.cycles(1, model) for op in ops}
    used = sum(op.resource(1) for op in ops)
    by_name = {op.name: op for op in ops}

    heap = [(-cycles[op.name], op.name) for op in ops]
    heapq.heapify(heap)
    frozen: set[str] = set()
    while heap:
        negc, name = heapq.heappop(heap)
        if -negc != cycles[name] or name in frozen:
            continue                                  # stale entry
        op = by_name[name]
        s = splits[name]
        if s >= min(max_splits, op.n_in_units):
            frozen.add(name)
            if len(frozen) == len(ops):
                break
            continue
        delta = op.resource(s + 1) - op.resource(s)
        if used + delta > budget:
            frozen.add(name)                          # can't afford: freeze
            if len(frozen) == len(ops):
                break
            continue
        used += delta
        splits[name] = s + 1
        cycles[name] = op.cycles(s + 1, model)
        heapq.heappush(heap, (-cycles[name], name))
    return Plan(splits=splits, cycles=cycles, resources=used, budget=budget,
                model=model)


def evaluate(ops: list[OpCost], splits: dict[str, int],
             model: str = "aware") -> dict[str, int]:
    """Cycle counts of a fixed plan under a (possibly different) model:
    the naive model's estimation error (the paper's 23%)."""
    return {op.name: op.cycles(splits[op.name], model) for op in ops}


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


def plan_lm_stages(cfg, seq: int, batch: int, n_stages: int) -> dict:
    """HPIPE stage assignment for an LM arch: balance per-layer FLOPs
    (heterogeneous for hybrid/MoE) across pipeline stages."""
    costs = np.array([lm_block_flops(cfg, seq, batch, l)
                      for l in range(cfg.n_layers)])
    stage_of = assign_stages(costs, n_stages)
    stage_cost = np.zeros(n_stages)
    for l, s in enumerate(stage_of):
        stage_cost[s] += costs[l]
    return {
        "stage_of": stage_of,
        "stage_cost": stage_cost,
        "imbalance": float(stage_cost.max() / max(stage_cost.mean(), 1.0)),
        "layer_flops": costs,
    }


def cnn_op_costs(cfg, params) -> list[OpCost]:
    """The DSP-planned ops of a CNN (its convs and classifier) from the
    pruned weights; depthwise convs, pools and adds are the FPGA's cheap
    companions and are not planned."""
    from repro_torch.models import cnn
    ops = []
    for s in cnn.specs_for(cfg.name):
        if s.kind == "conv":
            w = params[s.name]["w"]
            if isinstance(w, SparseWeight):
                # fused implicit-GEMM conv: cycles from the true per-split
                # (ky, kx, channel-block) gather counts
                ops.append(op_cost_conv_sparse(s.name, w, s.k, s.cin,
                                               s.out_hw, s.out_hw))
            else:
                units = max(s.k * s.k * s.cin // 8, 1)   # 8-wide dot units
                ops.append(op_cost_dense(s.name, units, s.cout, s.out_hw,
                                         s.out_hw))
        elif s.kind == "fc":
            w = params[s.name]["w"]
            if isinstance(w, SparseWeight):
                ops.append(op_cost_from_sparse(s.name, w, 1, 1))
            else:
                ops.append(op_cost_dense(s.name, max(s.cin // 8, 1), s.cout,
                                         1, 1))
    return ops


def plan_cnn(cfg, params, dsp_target: int = 5000, *,
             model: str = "aware") -> Plan:
    return balance(cnn_op_costs(cfg, params), dsp_target, model=model)


def cnn_node_costs(cfg, params, graph=None, *, model: str = "analytic",
                   tuning_cache=None, return_report: bool = False):
    """Per-IR-node cycle estimates for stage assignment (defaults to the
    FUSED graph, matching the interpreter).

    Sparse convs are priced from their true per-split gather counts
    (``op_cost_conv_sparse``), dense convs / fc from their dot-unit
    cycles, depthwise convs from their per-channel MAC chains, fused
    dw->pw super-nodes at the slower sub-unit's rate. A fused residual
    or pooling epilogue adds one line pass; pools and standalone adds
    are one pass over their output lines.

    ``model="measured"`` prices nodes from a ``core.tuning.TuningCache``
    of profiled per-node times instead (microseconds, not cycles; the
    active cache when ``tuning_cache`` is None): uncached nodes take the
    analytic estimate x the cache's fitted per-kind scale, and the
    coverage report says which. An empty cache gives the analytic costs
    bit for bit. ``return_report=True`` returns ``(costs, report)``; the
    report is None for the analytic model."""
    if model not in ("analytic", "measured"):
        raise ValueError(f"unknown cost model {model!r}")
    if model == "measured":
        from repro_torch.core import tuning
        costs, report = tuning.measured_node_costs(
            cfg, params, graph=graph, cache=tuning_cache)
        return (costs, report) if return_report else costs
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
    costs = np.asarray(costs)
    return (costs, None) if return_report else costs


def _plan_1d(cfg, params, n_stages: int, graph=None, *,
             max_stage_param_bytes: Optional[int] = None,
             model: str = "analytic", tuning_cache=None,
             store_dtype: str = "native") -> dict:
    """Cost-balanced stage assignment for a CNN layer graph: contiguous
    partition of the (fused) IR minimizing the max per-stage cost, with
    the weight-residency accounting (``node_param_bytes`` /
    ``stage_param_bytes``, priced at ``store_dtype``) and the optional
    per-stage byte budget ``max_stage_param_bytes``. ``model="measured"``
    with ``tuning_cache`` plans over profiled times; the plan records the
    cost model and the coverage report (``measured_coverage``)."""
    g = graph if graph is not None else fused_graph_for(cfg.name)
    costs, coverage = cnn_node_costs(cfg, params, graph=g, model=model,
                                     tuning_cache=tuning_cache,
                                     return_report=True)
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
        "measured_coverage": coverage,
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


def _plan_2d(cfg, params, n_devices: int, *,
             n_microbatches: int = 8, graph=None,
             max_stage_param_bytes: Optional[int] = None,
             model: str = "analytic",
             tuning_cache=None, store_dtype: str = "native") -> dict:
    """Co-plan the (n_stages, n_replicas) split of ``n_devices``: deeper
    cuts shrink per-stage work but inherit the graph's imbalance, while
    replicating a shallower pipeline scales throughput linearly. For
    every divisor split S x R = n_devices this plans the S-stage cut and
    scores ``pipeline_throughput_rel``.

    Budget-infeasible splits are skipped, not fatal, unless no split
    fits, which raises. A depth beyond the graph's node count is clamped
    by ``assign_stages``; ``n_devices_used = n_stages * n_replicas``
    records the devices such a split idles. Returns the winning split's
    plan (as ``plan``) and the scored candidate table."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    candidates, errors = [], []
    for s in range(1, n_devices + 1):
        if n_devices % s != 0:
            continue
        try:
            plan = _plan_1d(
                cfg, params, s, graph=graph,
                max_stage_param_bytes=max_stage_param_bytes,
                model=model, tuning_cache=tuning_cache,
                store_dtype=store_dtype)
        except ValueError as e:        # budget-infeasible at this depth
            errors.append((s, str(e)))
            continue
        s_used = plan["n_stages"]      # assign_stages clamps
        r = n_devices // s_used
        candidates.append({
            "n_stages": s_used,
            "n_replicas": r,
            "n_devices_used": s_used * r,   # < n_devices iff clamped
            "throughput_rel": pipeline_throughput_rel(
                plan["stage_cost"], r, n_microbatches),
            "imbalance": plan["imbalance"],
            "bottleneck_cycles": float(np.max(plan["stage_cost"])),
            "placed_bytes_per_device": plan["placed_bytes_per_device"],
            "plan": plan,
        })
    if not candidates:
        raise ValueError(
            f"no (stages, replicas) split of {n_devices} devices fits "
            f"the per-stage weight budget {max_stage_param_bytes}; "
            f"tried: {errors}")
    # clamped splits (s > n_nodes) all collapse to the same cut
    seen, uniq = set(), []
    for c in candidates:
        key = (c["n_stages"], c["n_replicas"])
        if key not in seen:
            seen.add(key)
            uniq.append(c)
    best = max(uniq, key=lambda c: c["throughput_rel"])
    return {
        "n_stages": best["n_stages"],
        "n_replicas": best["n_replicas"],
        "n_devices": n_devices,
        "n_devices_used": best["n_devices_used"],
        "n_microbatches": n_microbatches,
        "throughput_rel": best["throughput_rel"],
        "plan": best["plan"],
        "candidates": [{k: v for k, v in c.items() if k != "plan"}
                       for c in uniq],
    }


def _replan_2d(cfg, params, n_devices: int, *, prev=None,
               n_microbatches: int = 8, graph=None,
               max_stage_param_bytes: Optional[int] = None,
               model: str = "analytic",
               tuning_cache=None, store_dtype: str = "native") -> dict:
    """Degradation re-plan: a (stages, replicas) split for a reduced
    device pool, preferring stability over optimality. When the previous
    plan's cut still fits (its depth divides ``n_devices`` and its
    per-stage bytes respect the budget) it is reused (``reused: True``)
    with ``n_replicas = n_devices // n_stages``; otherwise the full
    co-planner decides (``reused: False``). The cut never changes the
    numerics: pipelined equals sequential at any depth."""
    if prev is not None:
        s = prev["n_stages"]
        bytes_ok = (max_stage_param_bytes is None or
                    max(prev["stage_param_bytes"]) <=
                    max_stage_param_bytes)
        if n_devices >= s and n_devices % s == 0 and bytes_ok:
            r = n_devices // s
            return {
                "n_stages": s,
                "n_replicas": r,
                "n_devices": n_devices,
                "n_devices_used": s * r,
                "n_microbatches": n_microbatches,
                "throughput_rel": pipeline_throughput_rel(
                    prev["stage_cost"], r, n_microbatches),
                "plan": prev,
                "reused": True,
            }
    out = _plan_2d(
        cfg, params, n_devices, n_microbatches=n_microbatches,
        graph=graph, max_stage_param_bytes=max_stage_param_bytes,
        model=model, tuning_cache=tuning_cache, store_dtype=store_dtype)
    out["reused"] = False
    return out


@dataclass(frozen=True)
class PlanRequest:
    """The resources one planning call is given — the single argument
    of :func:`plan`. Exactly one of ``n_stages`` (fixed-depth 1-D cut)
    or ``n_devices`` ((stages, replicas) co-plan; with ``prev`` set, a
    stability-preferring degradation re-plan) must be provided.
    ``store_dtype`` prices weight residency at the quantized width;
    ``model="measured"`` plans from ``tuning_cache``'s measured times."""
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
    """THE planning entry point, dispatching on what the request carries:

    - ``n_stages``: the contiguous S-stage cut;
    - ``n_devices``: the best divisor split S x R;
    - ``n_devices`` and ``prev``: reuse the previous cut where it still
      fits, else co-plan."""
    kw = dict(graph=graph,
              max_stage_param_bytes=request.max_stage_param_bytes,
              model=request.model, tuning_cache=request.tuning_cache,
              store_dtype=request.store_dtype)
    if request.n_stages is not None:
        out = _plan_1d(cfg, params, request.n_stages, **kw)
    elif request.prev is not None:
        out = _replan_2d(cfg, params, request.n_devices,
                         prev=request.prev,
                         n_microbatches=request.n_microbatches, **kw)
    else:
        out = _plan_2d(cfg, params, request.n_devices,
                       n_microbatches=request.n_microbatches, **kw)
    nested = out.get("plan")                    # 2-D results nest the cut
    if isinstance(nested, dict) and not isinstance(nested, PipelinePlan):
        out = dict(out, plan=PipelinePlan(nested))
    return PipelinePlan(out)


# --- deprecated entry points (use plan(cfg, params, PlanRequest)) ----------

def _deprecated(old: str, new: str) -> None:
    warnings.warn(
        f"{old} is deprecated; use {new}", DeprecationWarning, stacklevel=3)


def plan_cnn_pipeline(cfg, params, n_stages: int, graph=None, **kw) -> dict:
    """Deprecated shim — use ``plan(cfg, params,
    PlanRequest(n_stages=...))``."""
    _deprecated("plan_cnn_pipeline", "plan(cfg, params, "
                "PlanRequest(n_stages=...))")
    return _plan_1d(cfg, params, n_stages, graph=graph, **kw)


def plan_cnn_pipeline_2d(cfg, params, n_devices: int, **kw) -> dict:
    """Deprecated shim — use ``plan(cfg, params,
    PlanRequest(n_devices=...))``."""
    _deprecated("plan_cnn_pipeline_2d", "plan(cfg, params, "
                "PlanRequest(n_devices=...))")
    return _plan_2d(cfg, params, n_devices, **kw)


def replan_cnn_pipeline_2d(cfg, params, n_devices: int, **kw) -> dict:
    """Deprecated shim — use ``plan(cfg, params,
    PlanRequest(n_devices=..., prev=...))``."""
    _deprecated("replan_cnn_pipeline_2d", "plan(cfg, params, "
                "PlanRequest(n_devices=..., prev=...))")
    return _replan_2d(cfg, params, n_devices, **kw)
