"""Sharding rules on the port (counterpart of the reference's
``src/repro/launch/shardings.py``): param, batch and cache trees ->
specs, and the per-stage weight placement of the heterogeneous CNN
pipeline.

Megatron-style TP on the ``model`` axis, DP on ``data`` (and ``pod``
unless the pipeline owns it). Rules are (parent, name)-keyed with
divisibility fallbacks, so one table covers every family. A spec is a
tuple with one entry per dimension, an axis name, a tuple of axis names
or None; ``()`` is the reference's ``P()`` (``launch/mesh.py``). The
rules read only ``mesh.shape`` and ``mesh.axis_names``, so an abstract
mesh (the dry run's 16 x 16 and 2 x 16 x 16) takes them as a mesh of
slots does.

Paths are ``core/pytree.py``'s key strings (JAX's key-path strings
joined by ``|``) or sequences of names; a weight container's children
are ``#0``, ``#1``, as the reference names its flattened-index keys.
The tree functions return ``{key: spec}`` in the tree's leaf order.
"""
from __future__ import annotations

import math
import re

from repro_torch.core import pytree


def _axis_size(mesh, name: str) -> int:
    return mesh.shape.get(name, 1)


# (parent, leaf-name) -> candidate shard dims (tried in order) for 'model'
_DIMS = {
    ("attn", "wq"): (-2, -1), ("cross", "wq"): (-2, -1),   # heads, then dh
    ("attn", "wk"): (-2, -1), ("attn", "wv"): (-2, -1),    # kv-heads, then dh
    ("cross", "wk"): (-2, -1), ("cross", "wv"): (-2, -1),
    ("attn", "wo"): (-3, -2), ("cross", "wo"): (-3, -2),   # heads, then dh
    ("ffn", "w1"): (-1,), ("ffn", "w3"): (-1,), ("ffn", "w2"): (-2,),
    ("mamba", "in_z"): (-1,), ("mamba", "in_xbc"): (-1,),
    ("mamba", "in_dt"): (-1,), ("mamba", "conv_w"): (-1,),
    ("mamba", "out_proj"): (-2,),
    ("tmix", "wr"): (-1,), ("tmix", "wk"): (-1,), ("tmix", "wv"): (-1,),
    ("tmix", "wg"): (-1,), ("tmix", "wo"): (-2,),
    ("cmix", "wk"): (-1,), ("cmix", "wv"): (-2,),
    ("moe", "router"): (-1,),
    ("moe", "w1"): (-3,), ("moe", "w2"): (-3,), ("moe", "w3"): (-3,),
}

_KEY = re.compile(r"\['(.*)'\]|\[<flat index (\d+)>\]|\[(\d+)\]|\.(\w+)")


def _path_names(path) -> list[str]:
    """A key path's names: ``"['blocks']|['ffn']|['w1']|[<flat index
    0>]"`` -> ``["blocks", "ffn", "w1", "#0"]``; a sequence of names is
    returned as a list."""
    if not isinstance(path, str):
        return [str(p) for p in path]
    names = []
    for part in path.split(pytree.KEYSEP) if path else ():
        m = _KEY.fullmatch(part)
        if m is None:
            raise ValueError(f"not a key path entry: {part!r}")
        key, flat, idx, attr = m.groups()
        names.append(key if key is not None else
                     f"#{flat}" if flat is not None else
                     f"#{idx}" if idx is not None else attr)
    return names


def _spec_with_dim(shape, dim: int, axis: str, msize: int) -> tuple:
    dim = len(shape) + dim if dim < 0 else dim
    if 0 <= dim < len(shape) and shape[dim] % msize == 0 and \
            shape[dim] >= msize:
        spec = [None] * len(shape)
        spec[dim] = axis
        return tuple(spec)
    return ()


def use_pure_dp(cfg) -> bool:
    """Small models replicate params and use every chip for batch DP:
    TP would splinter sub-GB weights and (for head counts like 15) force
    replicated attention internals anyway."""
    try:
        return cfg.n_params() < 1e9
    except Exception:          # noqa: BLE001 — the reference's rule
        return False


def param_spec(path, leaf, mesh, *, pure_dp: bool = False) -> tuple:
    msize = _axis_size(mesh, "model")
    names = _path_names(path)
    shape = tuple(leaf.shape)
    if msize == 1 or not shape or pure_dp:
        return ()
    name = names[-1] if names else ""
    parent = ""
    for n in reversed(names[:-1]):
        if not n.startswith("#"):
            parent = n
            break
    # a SparseWeight's children under the weight's own name: .../w1/#0 =
    # vals (.., ob, K, bm, bn), .../w1/#1 = idx (.., ob, K); shard ob
    if name == "#0":
        return _spec_with_dim(shape, -4, "model", msize)
    if name == "#1":
        return _spec_with_dim(shape, -2, "model", msize)
    if name in ("embed", "head"):
        # embed shards d_model, not vocab: a vocab-sharded table turns
        # every lookup into a full-table all-gather
        return _spec_with_dim(shape, -1, "model", msize)
    for dim in _DIMS.get((parent, name), ()):
        spec = _spec_with_dim(shape, dim, "model", msize)
        if spec != ():
            return spec
    return ()


def params_shardings(params, mesh, *, pure_dp: bool = False) -> dict:
    """``{key: spec}`` for every leaf of ``params``."""
    return {k: param_spec(k, leaf, mesh, pure_dp=pure_dp)
            for k, leaf in pytree.keyed_leaves(params)}


def batch_axes(mesh, *, pod_is_dp: bool = True, pure_dp: bool = False):
    axes = []
    if "pod" in mesh.axis_names and pod_is_dp:
        axes.append("pod")
    axes.append("data")
    if pure_dp:
        axes.append("model")
    return tuple(axes) if len(axes) > 1 else axes[0]


def _batch_candidates(mesh, pod_is_dp: bool, pure_dp: bool) -> list:
    ax = batch_axes(mesh, pod_is_dp=pod_is_dp, pure_dp=pure_dp)
    return [ax] if isinstance(ax, str) else [ax[:i] for i in
                                             range(len(ax), 0, -1)]


def _divides(mesh, dim: int, cand: list):
    """The largest batch-axis combination that divides ``dim``, or None."""
    for a in cand:
        a_t = a if isinstance(a, tuple) else (a,)
        sz = math.prod(_axis_size(mesh, x) for x in a_t)
        if dim % sz == 0 and dim >= sz:
            return a if len(a_t) > 1 else a_t[0]
    return None


def data_spec(shape, mesh, *, pod_is_dp: bool = True,
              pure_dp: bool = False) -> tuple:
    """Batch-leading arrays (tokens, labels, frames, patches). Falls back
    to fewer batch axes when the batch does not divide."""
    a = _divides(mesh, shape[0], _batch_candidates(mesh, pod_is_dp,
                                                   pure_dp))
    if a is not None:
        return (a,) + (None,) * (len(shape) - 1)
    return (None,) * len(shape)


def cache_spec(path, leaf, mesh, *, pod_is_dp: bool = True,
               pure_dp: bool = False) -> tuple:
    """Decode-cache arrays. Batch dim -> data, heads/channels -> model."""
    msize = 1 if pure_dp else _axis_size(mesh, "model")
    names = _path_names(path)
    name = names[-1] if names else ""
    shape = tuple(leaf.shape)
    cand = _batch_candidates(mesh, pod_is_dp, pure_dp)

    def d(i):
        return _divides(mesh, shape[i], cand)

    if name in ("kv", "cross_kv", "attn_kv"):
        # (L|sites, 2, B, S, KVH, Dh): the SEQUENCE dim on 'model'
        # (context-parallel decode), else the heads, else the head dim
        spec = [None, None, d(2), None, None, None]
        if msize > 1:
            for i in (3, 4, 5):
                if shape[i] % msize == 0 and shape[i] >= msize:
                    spec[i] = "model"
                    break
        return tuple(spec)

    def mshard(i):
        return ("model" if msize > 1 and shape[i] % msize == 0
                and shape[i] >= msize else None)

    if name in ("wkv", "ssm"):     # (L, B, H, Dk, Dv) / (L, B, H, N, Dh)
        return (None, d(1), mshard(2), None, None)
    if name in ("conv", "x_prev_t", "x_prev_c"):   # (L, B, ., C)
        return (None, d(1), None, mshard(3))
    return (None,) * len(shape)


def cache_shardings(cache, mesh, **kw) -> dict:
    """``{key: spec}`` for every leaf of a decode cache."""
    return {k: cache_spec(k, leaf, mesh, **kw)
            for k, leaf in pytree.keyed_leaves(cache)}


# --- per-stage weight placement (the heterogeneous CNN pipeline) -----------

def stage_param_shardings(graph, plan, mesh, *, params=None,
                          stage_axis: str = "stage",
                          store_dtype: str = "native") -> dict:
    """Placement plan for a heterogeneous pipeline's weights: the spec
    that puts each stage's packed param row on that stage's slots, and
    the byte accounting (HPIPE's per-layer weight memories against a
    replicated model).

    ``plan``: ``planner.plan``'s dict (or any with "stage_of"), or the
    stage of each node. ``mesh`` must carry ``stage_axis`` with one slot
    a stage; a ``data`` axis replicates the rows across it (each
    replica's stage column holds its own stage's weights). Returns
    ``buffer`` (the spec to :func:`~repro_torch.launch.mesh.place` the
    (S, width) buffer of ``PlacedParams.pack()`` with), ``stage_parts``
    (per stage, the part names whose params live there) and, with
    ``params``: ``stage_param_bytes`` (live bytes a stage, priced at
    ``store_dtype``), ``replicated_bytes_per_device``,
    ``placed_bytes_per_device`` (the largest stage's) and
    ``placement_ratio``."""
    from repro_torch.core.quant import pytree_param_bytes
    from repro_torch.models.cnn import stage_part_names
    stage_of = list(plan["stage_of"]) if isinstance(plan, dict) else \
        list(plan)
    n_stages = max(stage_of) + 1
    if stage_axis not in mesh.shape:
        raise ValueError(f"mesh has no {stage_axis!r} axis "
                         f"(axes: {tuple(mesh.shape)})")
    if mesh.shape[stage_axis] != n_stages:
        raise ValueError(
            f"mesh {stage_axis!r} axis has {mesh.shape[stage_axis]} "
            f"slots for {n_stages} stages; one stage per slot required "
            "so each stage's weights land on exactly its devices")
    parts = stage_part_names(graph, stage_of)
    out = {"buffer": (stage_axis,), "stage_parts": parts}
    if params is not None:
        sb = [sum(pytree_param_bytes(params[n], store_dtype) for n in names)
              for names in parts]
        out["stage_param_bytes"] = sb
        out["replicated_bytes_per_device"] = sum(sb)
        out["placed_bytes_per_device"] = max(max(sb), 1)
        out["placement_ratio"] = out["placed_bytes_per_device"] / max(
            out["replicated_bytes_per_device"], 1)
    return out


def placed_stage_setup(cfg, params, plan, mb_shape, *,
                       stage_axis: str = "stage", n_replicas: int = 1,
                       data_axis: str = "data", devices=None,
                       quantize: str = "native", align: int = 1):
    """Placed-pipeline scaffolding of the server and the dry run: the
    placed stage programs (``cnn.stage_programs(placed=True)``), the
    stage mesh of ``devices`` (a ``(data, stage)`` grid when
    ``n_replicas`` > 1; by default the cards, ``mesh.make_stage_mesh``)
    and :func:`stage_param_shardings`'s dict with the byte accounting.
    ``align``: the rows' layout (``pipeline.ALIGN`` on a server).
    Returns ``(stage_fns, pack_in, unpack_out, width, pparams, mesh,
    sps)``; ``mesh.place(pparams.pack(), mesh, sps["buffer"])`` puts
    row k on the slots of stage k."""
    from repro_torch.core.fusion import fused_graph_for
    from repro_torch.launch.mesh import make_stage_mesh
    from repro_torch.models import cnn
    s = plan["n_stages"]
    stage_fns, pack_in, unpack_out, width, pparams = cnn.stage_programs(
        cfg, params, plan["stage_of"], mb_shape, placed=True,
        quantize=quantize, align=align)
    mesh = make_stage_mesh(s, n_replicas, stage_axis=stage_axis,
                           data_axis=data_axis, devices=devices)
    sps = stage_param_shardings(fused_graph_for(cfg.name), plan, mesh,
                                params=params, stage_axis=stage_axis,
                                store_dtype=quantize)
    return stage_fns, pack_in, unpack_out, width, pparams, mesh, sps
