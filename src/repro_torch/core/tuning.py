"""Profile-guided planner calibration and kernel autotuning on the port:
the reference's ``src/repro/core/tuning.py``.

HPIPE's stage cuts are only as good as the cycle estimates behind them.
The analytic cost model (``core/costmodel.py``) is the FPGA's cycle
model and knows nothing of the card. This module closes the loop:

1. **Profile**: :func:`measure_graph` times each fused IR node alone on
   the device it runs on and keeps the time in a JSON
   :class:`TuningCache` keyed on ``(op kind, shape, sparsity, dtype,
   device)``. On the card a time is device time: the node's call is
   captured in a CUDA graph and its replays are timed with CUDA events,
   so launches do not enter. On the CPU it is the median wall time of
   the plain path.
2. **Calibrate**: :func:`costmodel.fit_scale_factors` fits a scale per
   op kind (geometric mean of measured / analytic) so that shapes the
   cache has not seen still take the device's measured rates.
3. **Retune**: :func:`autotune_graph` times every plan the hand-written
   kernels can run at each distinct node shape (``sparse_conv``'s (tm,
   split), ``dw_pw``'s (tm, tn, ck, split), ``depthwise_conv``'s (r,
   threads)) and keeps the winner under a kernel key at that shape,
   batch included; :func:`autotune_microbatch` picks the serving
   microbatch count M. The dispatchers (``kernels/ops.py``) read the
   active cache when a kernel is launched or captured.

The planner reads all of it through ``model="measured"``
(:func:`measured_node_costs`): cached nodes are priced at their measured
time (us), the others at analytic cycles x the fitted scale, and an
empty cache gives the analytic costs bit for bit, so planning from a
cache file is deterministic.

Keys end in :func:`device_signature` (``<card name>:cuda`` on the card,
``cpu:plain`` on the CPU): times taken on one card never price a plan
on another. Given the same device string, every key equals the
reference's character for character.
"""
from __future__ import annotations

import contextlib
import functools
import json
import re
import statistics
import time
import warnings
from typing import Optional

import numpy as np
import torch

__all__ = [
    "TuningCache", "device_signature", "device_scope", "node_key",
    "kernel_key", "graph_node_keys", "calibration_kind", "measure_graph",
    "seed_from_analytic", "measured_node_costs", "autotune_depthwise_plan",
    "autotune_dw_pw_plan", "autotune_sparse_conv_plan",
    "autotune_microbatch", "autotune_graph", "calibrate",
    "set_tuning_cache", "current_tuning_cache",
]


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

class TuningCache:
    """JSON-persisted map from op keys to measured times and tuned
    kernel knobs.

    ``entries[key] = {"time_us": float, "knobs": {name: value}}``; either
    field may be absent (a node key usually carries only a time, a
    kernel key the winner's knobs and time). ``meta`` records how the
    measurements were taken (image_shape, device signature, iters), so a
    consumer can rebuild the same keys."""

    def __init__(self, entries: Optional[dict] = None,
                 meta: Optional[dict] = None):
        self.entries: dict = dict(entries or {})
        self.meta: dict = dict(meta or {})

    @classmethod
    def load(cls, path) -> "TuningCache":
        """Load a cache file; a missing file is a valid cold cache (the
        measured model then gives the analytic costs bit for bit)."""
        try:
            with open(path) as f:
                doc = json.load(f)
        except FileNotFoundError:
            return cls()
        return cls(doc.get("entries", {}), doc.get("meta", {}))

    def save(self, path) -> None:
        doc = {"meta": self.meta,
               "entries": {k: self.entries[k] for k in sorted(self.entries)}}
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")

    def __len__(self) -> int:
        return len(self.entries)

    def __contains__(self, key: str) -> bool:
        return key in self.entries

    def time_us(self, key: str) -> Optional[float]:
        e = self.entries.get(key)
        return None if e is None else e.get("time_us")

    def put_time(self, key: str, us: float) -> None:
        self.entries.setdefault(key, {})["time_us"] = float(us)

    def knob(self, key: str, name: str, default=None):
        e = self.entries.get(key)
        if e is None:
            return default
        return e.get("knobs", {}).get(name, default)

    def put_knob(self, key: str, name: str, value) -> None:
        self.entries.setdefault(key, {}).setdefault("knobs", {})[name] = value


# the process-global cache the kernel dispatchers (kernels/ops.py) read
# when a kernel is launched or captured: a captured CUDA graph keeps the
# knobs of its capture, whatever the cache says later
_ACTIVE: Optional[TuningCache] = None
# device_scope's signature, which device_signature() gives by default
_SCOPED_SIGNATURE: Optional[str] = None


class _CacheGuard:
    def __init__(self, prev):
        self._prev = prev

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = self._prev
        return False


def set_tuning_cache(cache: Optional[TuningCache]) -> _CacheGuard:
    """Install ``cache`` as the process-global tuning cache (``None``
    clears it). Usable as a context manager to scope the override."""
    global _ACTIVE
    guard = _CacheGuard(_ACTIVE)
    _ACTIVE = cache
    return guard


def current_tuning_cache() -> Optional[TuningCache]:
    return _ACTIVE


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _card_signature(index: int) -> str:
    name = torch.cuda.get_device_name(index)
    return f"{name.lower().replace(' ', '-')}:cuda"


def _is_device(spec) -> bool:
    return isinstance(spec, torch.device) or bool(
        re.fullmatch(r"(cpu|cuda)(:\d+)?", str(spec)))


def device_signature(device=None) -> str:
    """The validity domain of a measurement: ``<card name, lower-cased,
    spaces to dashes>:cuda`` for a CUDA device (the times are the
    hand-written kernels'), ``cpu:plain`` for the CPU (the plain
    versions'). ``device=None``: the signature :func:`device_scope` set,
    else the card's where there is one, else the CPU's. A signature
    string (``"cpu:xla"``) is returned as it is."""
    if device is None:
        if _SCOPED_SIGNATURE is not None:
            return _SCOPED_SIGNATURE
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if not _is_device(device):
        return str(device)
    dev = torch.device(device)
    if dev.type == "cuda":
        return _card_signature(dev.index if dev.index is not None
                               else torch.cuda.current_device())
    if dev.type == "cpu":
        return "cpu:plain"
    raise ValueError(f"no device signature for {dev}")


@contextlib.contextmanager
def device_scope(device):
    """Within the scope, :func:`device_signature()` without an argument
    gives ``device``'s signature (a ``torch.device`` or "cpu" / "cuda[:n]"),
    or ``device`` itself where it is a signature string such as the
    reference's ``"cpu:xla"``: the planner then prices nodes from that
    device's entries."""
    global _SCOPED_SIGNATURE
    prev = _SCOPED_SIGNATURE
    _SCOPED_SIGNATURE = device_signature(device)
    try:
        yield
    finally:
        _SCOPED_SIGNATURE = prev


def _shp(shape) -> str:
    return "x".join(str(int(s)) for s in shape)


def _dtype_name(dtype) -> str:
    """``bfloat16`` for torch.bfloat16 (numpy's name for the same type in
    the reference's keys), ``float32``, ``int8``, ..."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def _weight_sig(node, params) -> str:
    """Sparsity signature of the node's weight: block geometry and kept
    block count for a SparseWeight, ``dense`` otherwise, ``-`` for the
    param-free companions (add, pools)."""
    from repro_torch.core.fusion import conv_part
    from repro_torch.models.layers import SparseWeight
    if node.kind not in ("conv", "dw_pw", "fc", "avgpool_fc", "dw"):
        return "-"
    try:
        w = params[conv_part(node).name]["w"]
    except (StopIteration, KeyError):
        return "-"
    if isinstance(w, SparseWeight):
        ob, K, bm, bn = w.vals.shape
        return f"b{bm}x{bn}K{K}"
    return "dense"


def calibration_kind(node, params) -> str:
    """Scale-fit class of a node: ``kind/sparse`` vs ``kind/dense``.
    Sparsity splits the class: the analytic model prices a sparse conv
    at its surviving blocks, which the device does not run at the dense
    conv's rate."""
    ws = _weight_sig(node, params)
    if ws == "-":
        return node.kind
    return node.kind + ("/sparse" if ws.startswith("b") else "/dense")


def node_key(node, in_shape, dtype, wsig: str,
             device: Optional[str] = None) -> str:
    """Cache key of one fused IR node: ``(op kind, shape, sparsity,
    dtype, device)``, not the node's name, so two nodes with the same
    work (ResNet's repeated block shapes) share one measurement."""
    kind = node.kind
    if node.residual_from and node.kind != "add":
        kind += ".res"                      # fused residual epilogue
    if node.pool_k:
        kind += f".pool{node.pool_k}s{node.pool_stride}"
    dev = device or device_signature()
    return (f"node/{kind}/in{_shp(in_shape)}/k{node.k}s{node.stride}"
            f"/co{node.cout}/{wsig}/{_dtype_name(dtype)}/{dev}")


def kernel_key(op: str, in_shape, dtype, *, device: Optional[str] = None,
               **fields) -> str:
    """Cache key of one kernel-knob site (``op`` in dw | dwpw | sconv |
    microbatch), with the node keys' tail."""
    dev = device or device_signature()
    tail = "/".join(f"{k}{v}" for k, v in sorted(fields.items()))
    return (f"kern/{op}/in{_shp(in_shape)}/{tail}"
            f"/{_dtype_name(dtype)}/{dev}")


def graph_node_keys(cfg, params, image_shape, graph=None,
                    device: Optional[str] = None):
    """``[(node, key), ...]`` for every fused node at a concrete image
    shape (input shapes from ``cnn.node_shapes``: no device work)."""
    from repro_torch.core.fusion import fused_graph_for
    from repro_torch.models import cnn
    g = graph if graph is not None else fused_graph_for(cfg.name)
    shapes = cnn.node_shapes(cfg, params, image_shape, graph=g)
    dev = device or device_signature()
    return [(node, node_key(node, shapes[edge[0]].shape,
                            shapes[edge[0]].dtype,
                            _weight_sig(node, params), device=dev))
            for node, edge in zip(g.nodes, g.inputs)]


# ---------------------------------------------------------------------------
# the profiler
# ---------------------------------------------------------------------------

def _params_device(params) -> torch.device:
    """Where the parameters live (every node's bias is a tensor)."""
    for p in params.values():
        return p["b"].device
    raise ValueError("no parameters")


def _time_call(fn, *args, warmup: int = 2, iters: int = 5,
               reps: int = 20) -> float:
    """Median time of one ``fn(*args)`` in microseconds.

    CUDA tensors: ``warmup`` eager calls (they build the kernels and set
    their attributes), then ``reps`` calls captured in one CUDA graph,
    whose ``iters`` replays are each timed between two CUDA events: the
    device's time, with no launch from the host in it. CPU tensors:
    ``warmup`` calls, then the median of ``iters`` wall times of the
    plain path."""
    from repro_torch.core.device import graph_capture
    dev = args[0].device
    with torch.inference_mode():
        for _ in range(max(warmup, 1)):
            fn(*args)
        if dev.type != "cuda":
            ts = []
            for _ in range(iters):
                t0 = time.perf_counter()
                fn(*args)
                ts.append((time.perf_counter() - t0) * 1e6)
            return float(np.median(ts))
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        with graph_capture(graph, collect=False):
            for _ in range(reps):
                fn(*args)
        graph.replay()
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(max(iters, 1))]
        for start, end in events:
            start.record()
            graph.replay()
            end.record()
        torch.cuda.synchronize(dev)
        ms = [s.elapsed_time(e) for s, e in events]
        del graph
    return statistics.median(ms) * 1e3 / reps


def measure_graph(cfg, params, image_shape, *, graph=None,
                  cache: Optional[TuningCache] = None, iters: int = 5,
                  warmup: int = 2, verbose: bool = False) -> TuningCache:
    """Time every fused IR node alone where ``params`` live and record
    ``time_us`` under its :func:`node_key`. Inputs are ones at the node's
    shapes and dtypes (the sparse kernels' time depends on the weight's
    structure, not on the values). Repeated shapes are measured once.
    On the card the node runs its kernels under the active tuning cache's
    knobs."""
    from repro_torch.core.fusion import fused_graph_for
    from repro_torch.models import cnn
    g = graph if graph is not None else fused_graph_for(cfg.name)
    dev = _params_device(params)
    sig = device_signature(dev)
    shapes = cnn.node_shapes(cfg, params, image_shape, graph=g)
    cache = cache if cache is not None else TuningCache()
    cache.meta.update({"image_shape": [int(s) for s in image_shape],
                       "device": sig, "iters": int(iters)})
    for (node, key), edge in zip(
            graph_node_keys(cfg, params, image_shape, graph=g, device=sig),
            g.inputs):
        if key in cache and cache.time_us(key) is not None:
            continue
        args = [torch.ones(shapes[src].shape, dtype=shapes[src].dtype,
                           device=dev) for src in edge]
        us = _time_call(lambda *a, _n=node: cnn.run_node(_n, params, *a),
                        *args, warmup=warmup, iters=iters)
        cache.put_time(key, us)
        if verbose:
            print(f"  {node.name:<16} {us:>12.1f} us   {key}")
    return cache


def seed_from_analytic(cfg, params, image_shape, *, graph=None,
                       cache: Optional[TuningCache] = None) -> TuningCache:
    """Fill the cache with the analytic costs as if they were measured
    (no device work, no clock): a cache seeded this way must give the
    analytic plan exactly."""
    from repro_torch.core import planner
    from repro_torch.core.fusion import fused_graph_for
    g = graph if graph is not None else fused_graph_for(cfg.name)
    analytic = planner.cnn_node_costs(cfg, params, graph=g)
    cache = cache if cache is not None else TuningCache()
    cache.meta.update({"image_shape": [int(s) for s in image_shape],
                       "device": device_signature(), "seeded": "analytic"})
    for (node, key), c in zip(
            graph_node_keys(cfg, params, image_shape, graph=g), analytic):
        cache.put_time(key, float(c))
    return cache


# ---------------------------------------------------------------------------
# the measured cost model
# ---------------------------------------------------------------------------

def measured_node_costs(cfg, params, *, graph=None,
                        cache: Optional[TuningCache] = None):
    """Per-node costs for ``planner.cnn_node_costs(model="measured")``.

    Cached nodes are priced at their measured time (us); the others at
    ``analytic cycles x scale[calibration_kind]``, the scales fitted over
    the nodes that were measured (``costmodel.fit_scale_factors``). With
    an empty cache every scale is 1.0 and the result is the analytic
    cost vector bit for bit. The keys are :func:`device_signature()`'s.

    Returns ``(costs, report)``; the report names every fallback node,
    and a partly covered or an empty cache also warns."""
    from repro_torch.core import planner
    from repro_torch.core.costmodel import fit_scale_factors
    from repro_torch.core.fusion import fused_graph_for
    g = graph if graph is not None else fused_graph_for(cfg.name)
    cache = cache if cache is not None else (_ACTIVE or TuningCache())
    analytic = planner.cnn_node_costs(cfg, params, graph=g)
    image_shape = tuple(cache.meta.get("image_shape") or (1, 224, 224, 3))

    keyed = graph_node_keys(cfg, params, image_shape, graph=g)
    measured = [cache.time_us(key) for _, key in keyed]
    kinds = [calibration_kind(node, params) for node, _ in keyed]
    scales = fit_scale_factors(measured, analytic, kinds)

    costs, fallback = [], []
    for (node, _key), t, a, ck in zip(keyed, measured, analytic, kinds):
        if t is not None and t > 0:
            costs.append(float(t))
        else:
            costs.append(float(a) * scales.get(ck, scales.get("*", 1.0)))
            fallback.append(node.name)
    n = len(keyed)
    report = {
        "model": "measured",
        "n_nodes": n,
        "n_measured": n - len(fallback),
        "coverage": (n - len(fallback)) / max(n, 1),
        "fallback": fallback,
        "scales": scales,
        "cache_entries": len(cache),
        "units": "us" if len(cache) else "cycles",
    }
    if fallback and len(cache):
        warnings.warn(
            f"tuning cache covers {report['n_measured']}/{n} nodes of "
            f"{cfg.name}; analytic fallback (x calibrated scale) for: "
            f"{', '.join(fallback[:8])}"
            f"{'...' if len(fallback) > 8 else ''}", stacklevel=2)
    elif not len(cache):
        warnings.warn(
            f"tuning cache is empty: {cfg.name} planned from analytic "
            "costs (cold-cache fallback)", stacklevel=2)
    return np.asarray(costs), report


# ---------------------------------------------------------------------------
# the kernels' autotuners
# ---------------------------------------------------------------------------

def _require_card(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: the plain version on {x.device} has no "
                         "knobs; the autotuners time the card's kernels")


# a candidate replaces the kernel's default plan only where it is this
# much faster: closer than that is the timer's spread between two
# captures of the same launch (about 1-2% at a few microseconds on the
# H100), and a tuned plan that only won the noise is a worse plan half
# the time
MIN_GAIN = 0.02


def _search(cands, run, x, iters: int):
    """(best candidate, its us): each candidate timed in turn; the first
    (the kernel's default plan) is kept unless the fastest of the others
    beats it by MIN_GAIN."""
    times = [_time_call(lambda a, _c=cand: run(a, _c), x, warmup=1,
                        iters=iters) for cand in cands]
    best = min(range(len(cands)), key=times.__getitem__)
    if times[best] > (1.0 - MIN_GAIN) * times[0]:
        best = 0
    return cands[best], times[best]


def _default_first(default, cands):
    return [default] + [c for c in cands if c != default]


def autotune_depthwise_plan(x, w, *, stride: int = 1, cache: TuningCache,
                            iters: int = 3) -> tuple[int, int]:
    """The counterpart of the reference's ``autotune_depthwise_block_c``
    on the port's knobs: time the depthwise kernel at every (r, threads)
    it can run (``depthwise_conv.plan_candidates``: r in {1, 2, 4} x
    threads in {32, 64, 128, 256}) and record the winner's ``r``,
    ``threads`` and time under the ``dw`` kernel key of ``x``'s shape."""
    from repro_torch.kernels import depthwise_conv as dw
    from repro_torch.kernels.sparse_conv import same_pads
    _require_card(x, "autotune_depthwise_plan")
    n, h, wd, c = x.shape
    k = w.shape[0]
    ho, wo = same_pads(h, k, stride)[0], same_pads(wd, k, stride)[0]
    cands = _default_first(dw.plan(n, ho, wo, c, k, stride),
                           dw.plan_candidates(c, stride, k))
    best, best_us = _search(cands, lambda a, p: dw.depthwise_conv(
        a, w, stride=stride, plan=p), x, iters)
    key = kernel_key("dw", x.shape, x.dtype, device=device_signature(
        x.device), k=w.shape[1], s=stride)
    cache.put_knob(key, "r", int(best[0]))
    cache.put_knob(key, "threads", int(best[1]))
    cache.put_time(key, best_us)
    return int(best[0]), int(best[1])


def autotune_dw_pw_plan(x, dw_w, dw_b, pw_w, pw_b, *, stride: int = 1,
                        cache: TuningCache, iters: int = 3):
    """The counterpart of the reference's ``autotune_dw_pw_row_chunk``
    on the port's knobs: time the fused dw->pw kernel's mma variant at
    every plan it can run at ``x``'s shape (``dw_pw_fused.
    plan_candidates``, the set ``tools/sweep_dw_pw.py`` sweeps: tm x tn
    in {64, 128} x ck in {32, 64} x split) and record the winner's
    ``tm``, ``tn``, ``ck``, ``split`` and time under the ``dwpw`` kernel
    key. Returns the winning ``dw_pw_fused.Plan``."""
    from repro_torch.kernels import dw_pw_fused as f
    from repro_torch.kernels.sparse_conv import same_pads
    _require_card(x, "autotune_dw_pw_plan")
    n, h, wd, c = x.shape
    k, co = dw_w.shape[0], pw_w.shape[-1]
    if f.variant(c, co, k, stride, pw_w.dtype) != "mma":
        raise ValueError("autotune_dw_pw_plan: only the mma variant has "
                         "knobs")
    ho, wo = same_pads(h, k, stride)[0], same_pads(wd, k, stride)[0]
    cands = _default_first(f.plan(n, ho, wo, c, co, k, stride),
                           f.plan_candidates(n, ho, wo, c, co, k, stride))
    best, best_us = _search(cands, lambda a, p: f.dw_pw(
        a, dw_w, dw_b, pw_w, pw_b, stride=stride, plan=p), x, iters)
    key = kernel_key("dwpw", x.shape, x.dtype, device=device_signature(
        x.device), k=dw_w.shape[1], s=stride, co=co)
    for name in ("tm", "tn", "ck", "split"):
        cache.put_knob(key, name, int(getattr(best, name)))
    cache.put_time(key, best_us)
    return best


def autotune_sparse_conv_plan(x, sw, bias, *, k: int, stride: int = 1,
                              relu: bool = True, cache: TuningCache,
                              iters: int = 3) -> tuple[int, int]:
    """The counterpart of the reference's ``autotune_sparse_conv_block_k``
    on the port's knobs: time the sparse conv's mma variant at every (tm,
    split) it can run for the node's K surviving blocks a column
    (``sparse_conv.plan_candidates``: tm of TILES x split in {1, 2, 4, 8}
    up to its K steps, ``sparse_conv.k_steps``) and record the winner's
    ``tm``, ``split`` and time under the
    ``sconv`` kernel key."""
    from repro_torch.kernels import sparse_conv as sc
    from repro_torch.kernels.sparse_conv import same_pads
    _require_card(x, "autotune_sparse_conv_plan")
    ob, n_k, bm, bn = sw.vals.shape
    if sc.variant(bm, bn, sw.vals.dtype) != "mma":
        raise ValueError("autotune_sparse_conv_plan: only the mma variant "
                         "has knobs")
    n, h, wd, _ = x.shape
    m = n * same_pads(h, k, stride)[0] * same_pads(wd, k, stride)[0]
    steps = sc.k_steps(n_k, bm)
    cands = _default_first(sc.plan(m, ob, steps), sc.plan_candidates(steps))
    best, best_us = _search(cands, lambda a, p: sc.sparse_conv(
        a, sw.vals, sw.idx, bias, None, sw.scale, k=k, stride=stride,
        relu=relu, plan=p), x, iters)
    key = kernel_key("sconv", x.shape, x.dtype, device=device_signature(
        x.device), k=k, s=stride, b=f"{bm}x{bn}K{n_k}", co=ob * bn)
    cache.put_knob(key, "tm", int(best[0]))
    cache.put_knob(key, "split", int(best[1]))
    cache.put_time(key, best_us)
    return int(best[0]), int(best[1])


def autotune_microbatch(stage_cost, *, n_replicas: int = 1,
                        candidates=(2, 4, 8, 16, 32),
                        rel_tol: float = 0.05,
                        latency_cap_ticks: Optional[int] = None,
                        cache: Optional[TuningCache] = None,
                        arch: str = "") -> int:
    """The serving microbatch count M from the stage costs: throughput
    (``planner.pipeline_throughput_rel``) rises with M as the fill bubble
    amortizes, but a batch takes M + S - 1 ticks, so take the smallest M
    within ``rel_tol`` of the best candidate's throughput (the knee of
    the fill curve), optionally under a latency cap in ticks.
    Deterministic: arithmetic over the stage costs."""
    from repro_torch.core.planner import pipeline_throughput_rel
    s = len(np.asarray(stage_cost))
    cands = [m for m in sorted(set(candidates))
             if latency_cap_ticks is None or m + s - 1 <= latency_cap_ticks]
    if not cands:
        cands = [min(candidates)]
    thr = {m: pipeline_throughput_rel(stage_cost, n_replicas, m)
           for m in cands}
    peak = max(thr.values())
    best = next(m for m in cands if thr[m] >= (1.0 - rel_tol) * peak)
    if cache is not None:
        key = kernel_key("microbatch", (s, n_replicas), np.float32,
                         arch=arch or "any")
        cache.put_knob(key, "n_microbatches", int(best))
    return int(best)


def autotune_graph(cfg, params, image_shape, *, graph=None,
                   cache: Optional[TuningCache] = None, iters: int = 3,
                   verbose: bool = False) -> TuningCache:
    """Walk the graph and tune every kernel knob at each distinct
    ``(kind, x.shape, k, stride, cout)``, once, for the variants that
    have knobs: ``sparse_conv`` (mma) on the sparse convs, ``dw_pw``
    (mma) on the fused blocks with a dense pointwise weight,
    ``depthwise_conv`` on the standalone depthwise nodes (the unfused
    views). The winners land under kernel keys in the same cache as the
    node times. Where ``params`` live on the CPU the plain versions have
    no knobs, and nothing is tuned."""
    from repro_torch.core.fusion import conv_part, fused_graph_for
    from repro_torch.core.quant import QuantizedWeight
    from repro_torch.kernels import dw_pw_fused as f
    from repro_torch.kernels import sparse_conv as sc
    from repro_torch.models import cnn
    from repro_torch.models.layers import SparseWeight
    g = graph if graph is not None else fused_graph_for(cfg.name)
    cache = cache if cache is not None else TuningCache()
    dev = _params_device(params)
    if dev.type != "cuda":
        return cache
    shapes = cnn.node_shapes(cfg, params, image_shape, graph=g)

    def dense(w):
        return w.dequant() if isinstance(w, QuantizedWeight) else w

    seen = set()
    for node, edge in zip(g.nodes, g.inputs):
        s_in = shapes[edge[0]]
        sig = (node.kind, tuple(s_in.shape), node.k, node.stride, node.cout)
        if sig in seen or node.kind not in ("dw", "dw_pw", "conv"):
            continue
        seen.add(sig)
        x = torch.ones(s_in.shape, dtype=s_in.dtype, device=dev)
        if node.kind == "dw":
            best = autotune_depthwise_plan(
                x, dense(params[node.name]["w"]), stride=node.stride,
                cache=cache, iters=iters)
        elif node.kind == "dw_pw":
            dw_p = params[node.parts[0].name]
            pw_p = params[conv_part(node).name]
            pw_w = pw_p["w"]
            if isinstance(pw_w, SparseWeight):
                continue                    # sparse pw: the two-op path
            if isinstance(pw_w, QuantizedWeight):
                pw_w = pw_w.dequant()
            if f.variant(node.cin, node.cout, node.k, node.stride,
                         pw_w.dtype) != "mma":
                continue
            best = autotune_dw_pw_plan(
                x, dense(dw_p["w"]), dw_p["b"], pw_w, pw_p["b"],
                stride=node.stride, cache=cache, iters=iters)
        else:
            p = params[conv_part(node).name]
            w = p["w"]
            if not isinstance(w, SparseWeight) or sc.variant(
                    *w.vals.shape[2:], w.vals.dtype) != "mma":
                continue
            best = autotune_sparse_conv_plan(
                x, w, p["b"], k=node.k, stride=node.stride,
                relu=node.relu and not node.residual_from,
                cache=cache, iters=iters)
        if verbose:
            print(f"  tuned {node.name:<16} -> {best}")
    return cache


# ---------------------------------------------------------------------------
# the whole loop
# ---------------------------------------------------------------------------

def calibrate(cfg, params, image_shape, *, graph=None, path=None,
              cache: Optional[TuningCache] = None, measure: bool = True,
              autotune: bool = False, iters: int = 5,
              verbose: bool = False) -> TuningCache:
    """Profile, calibrate and (optionally) retune in one call: autotune
    the kernel knobs at ``image_shape`` (``autotune``), time every fused
    node (``measure``) and save to ``path``. The knobs are tuned first
    and the nodes timed under them (the reference times first, with
    knobs that then change), so a node's time is that of the kernels
    that will serve it. On the card the node times are the kernels'; on
    the CPU the plain versions', which have no knobs. The returned cache
    plugs into ``planner.plan(..., PlanRequest(model="measured",
    tuning_cache=...))`` and :func:`set_tuning_cache`."""
    cache = cache if cache is not None else (
        TuningCache.load(path) if path else TuningCache())
    if autotune:
        cache = autotune_graph(cfg, params, image_shape, graph=graph,
                               cache=cache, iters=max(iters // 2, 2),
                               verbose=verbose)
    if measure:
        with set_tuning_cache(cache):
            cache = measure_graph(cfg, params, image_shape, graph=graph,
                                  cache=cache, iters=iters, verbose=verbose)
    if path:
        cache.save(path)
    return cache


def resolve_cache(cfg, params, tuning_cache, run_calibration: bool, *,
                  image_size: int, device, verbose: bool = False
                  ) -> Optional[TuningCache]:
    """The cache a measured plan reads, or None for the analytic model:
    ``tuning_cache`` a :class:`TuningCache` or a path (a missing file
    loads as a cold cache); ``run_calibration`` first times every fused
    node of ``cfg`` on ``device`` at ``(1, image_size, image_size, 3)``
    with :func:`calibrate` (the card's kernels there, the plain versions
    on the CPU) and writes the cache back to a path."""
    from repro_torch.models import cnn
    if tuning_cache is None and not run_calibration:
        return None
    if isinstance(tuning_cache, TuningCache):
        path, cache = None, tuning_cache
    else:
        path = tuning_cache
        cache = TuningCache.load(path) if path else TuningCache()
    if run_calibration:
        if verbose:
            print(f"[tuning] calibrating {cfg.name} at {image_size}px on "
                  f"{device} ({len(cache)} cached entries)...")
        cache = calibrate(cfg, cnn.params_to(params, device),
                          (1, image_size, image_size, 3), cache=cache,
                          path=path, verbose=verbose)
    return cache
