"""LM step functions (counterpart of the reference's
``src/repro/launch/steps.py``): train, prefill and decode, and the
stage-pipelined train step (HPIPE's layer pipeline applied to training).

The reference's ``unroll`` shapes a traced program and the port runs
eagerly, so it has none; ``remat`` is :func:`repro_torch.models.lm.
remat_wrap`'s. A train step takes the gradient of every floating leaf
(``torch.autograd.grad``; an integer leaf such as a SparseWeight's idx
gets None, JAX's float0) and runs the forward and the backward under
``layers.full_f32()``, so no f32 product, forward or backward, takes
TF32 on the card. The hand-written kernels run in the forward and in
each recomputation; their backwards are plain torch
(``kernels/ops.py``)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import pipeline as pp
from repro_torch.core import planner
from repro_torch.core import pytree
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.optim import adamw


def _trainable(tree):
    """``tree`` with every floating leaf a fresh autograd leaf that
    shares its storage, and the list of those leaves in
    ``core/pytree.leaves`` order."""
    leaves = []

    def mark(t):
        if t.is_floating_point():
            t = t.detach().requires_grad_(True)
            leaves.append(t)
        return t

    flat = dict(pytree.keyed_leaves(tree))
    return pytree.rebuild(tree, lambda key: mark(flat[key])), leaves


def value_and_grad(loss_of, params):
    """(loss_of's outputs, grads): ``loss_of(params) -> (loss, metrics)``
    and the gradient of the loss for every floating leaf (zeros where
    the loss does not reach a leaf, None for integer leaves), as a tree
    of the params' keys (weight containers as ``pytree.SparseLeaves``)."""
    with L.full_f32():
        p, leaves = _trainable(params)
        loss, metrics = loss_of(p)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_id = {id(t): g if g is not None else torch.zeros_like(t)
             for t, g in zip(leaves, grads)}
    grad_tree = pytree.map_leaves(lambda t: by_id.get(id(t)), p)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), \
        grad_tree


def make_train_step(cfg, opt_cfg: Optional[adamw.AdamWConfig] = None, *,
                    remat: str = "full"):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: ``lm.loss_fn``'s gradient, then AdamW. metrics: "loss",
    "aux", "grad_norm", "lr"."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()

    def train_step(params, opt_state, batch):
        (_, metrics), grads = value_and_grad(
            lambda p: lm.loss_fn(cfg, p, batch, remat=remat), params)
        params, opt_state, om = adamw.update(opt_cfg, params, grads,
                                             opt_state)
        return params, opt_state, {**metrics, **om}

    return train_step


def make_prefill_step(cfg):
    """``prefill(params, tokens, **extra) -> (B, V)`` next-token logits
    (f32): one forward over the whole prompt, its attention through the
    flash kernel. ``extra``: ``patches=(B, Vt, d)`` for a VLM, in front
    of the tokens (the reference's prefill takes ``T - vision_tokens``
    tokens); ``frames=(B, Te, d)`` for whisper, which its encoder runs
    over and its decoder attends to."""
    def prefill(params, tokens, **extra):
        logits, _ = lm.forward(cfg, params, tokens, extra=extra or None,
                               logits_mode="last")
        return logits

    return prefill


def make_decode_step(cfg):
    """``decode(params, cache, tokens, pos) -> (logits, cache)``."""
    def decode(params, cache, tokens, pos):
        return lm.decode_step(cfg, params, cache, tokens, pos)

    return decode


# --- the dry run's abstract trees --------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def abstract_params(cfg, mesh, *, pure_dp=None):
    """``(params, specs)``: ``lm.abstract_params`` (meta tensors, nothing
    allocated) and ``{key: spec}`` from ``shardings.params_shardings``
    (``pure_dp`` by default ``shardings.use_pure_dp(cfg)``)."""
    from repro_torch.launch import shardings as sh
    if pure_dp is None:
        pure_dp = sh.use_pure_dp(cfg)
    params = lm.abstract_params(cfg)
    return params, sh.params_shardings(params, mesh, pure_dp=pure_dp)


def abstract_opt_state(params, specs: dict, mesh, *, zero1: bool = True):
    """``(opt_state, specs)`` of AdamW over ``params`` (meta): f32 m and v
    shaped as every leaf, an int32 step. ``zero1`` also shards m and v
    over ``data`` (ZeRO-1) along the first dimension the param spec
    leaves whole that the data axis divides: m and v are read only at
    the update, so the gather of fresh params replaces a full-size
    gradient all-reduce while the optimizer's bytes fall by the DP
    degree."""
    dsize = mesh.shape.get("data", 1)
    flat = dict(pytree.keyed_leaves(params))

    def f32_spec(key):
        shape = flat[key].shape
        spec = list(specs[key]) + [None] * (len(shape) - len(specs[key]))
        if zero1 and dsize > 1:
            for i, p in enumerate(spec):
                if p is None and shape[i] % dsize == 0 and shape[i] >= dsize:
                    spec[i] = "data"
                    break
        return tuple(spec)

    m = pytree.map_leaves(lambda t: _meta(t.shape, torch.float32), params)
    opt = adamw.OptState(m=m, v=m, step=_meta((), torch.int32))
    out = {}
    for key, _ in pytree.keyed_leaves(opt):
        field, _, rest = key.partition(pytree.KEYSEP)
        out[key] = () if field == ".step" else f32_spec(rest)
    return opt, out


def input_specs(cfg, shape, mesh, *, pod_is_dp: bool = True, pure_dp=None):
    """``(inputs, specs)`` for every model input of a cell, as meta
    tensors: train ``{"batch": {"tokens", "labels"[, "frames",
    "patches"]}}``, prefill ``{"tokens"[, ...]}``, decode ``{"cache",
    "tokens", "pos"}`` (the cache ``lm.init_cache``'s); the reference's
    shapes and dtypes, ``{key: spec}`` from ``shardings.data_spec`` /
    ``cache_spec``."""
    from repro_torch.launch import shardings as sh
    b, t = shape.global_batch, shape.seq_len
    d = cfg.d_model
    if pure_dp is None:
        pure_dp = sh.use_pure_dp(cfg)
    tx = t - cfg.vision_tokens if cfg.family == "vlm" else t

    def extras():
        out = {}
        if cfg.family == "audio":
            out["frames"] = _meta((b, cfg.encoder_seq, d), torch.bfloat16)
        if cfg.family == "vlm":
            out["patches"] = _meta((b, cfg.vision_tokens, d), torch.bfloat16)
        return out

    if shape.kind == "train":
        inputs = {"batch": {"tokens": _meta((b, tx), torch.int32),
                            "labels": _meta((b, tx), torch.int32),
                            **extras()}}
    elif shape.kind == "prefill":
        inputs = {"tokens": _meta((b, tx), torch.int32), **extras()}
    else:
        inputs = {"cache": lm.init_cache(cfg, b, t, device="meta"),
                  "tokens": _meta((b, 1), torch.int32),
                  "pos": _meta((), torch.int32)}
    kw = dict(pod_is_dp=pod_is_dp, pure_dp=pure_dp)
    specs = {}
    for key, leaf in pytree.keyed_leaves(inputs):
        top = sh._path_names(key)[0]
        if top == "cache":
            specs[key] = sh.cache_spec(key, leaf, mesh, **kw)
        elif top == "pos":
            specs[key] = ()
        else:
            specs[key] = sh.data_spec(tuple(leaf.shape), mesh, **kw)
    return inputs, specs


# --- HPIPE pipelined training ---------------------------------------------

def make_pipeline_train_step(cfg, mesh, shape,
                             opt_cfg: Optional[adamw.AdamWConfig] = None, *,
                             n_stages: Optional[int] = None,
                             n_microbatches: int = 8,
                             stage_axis: str = "pod"):
    """The reference's ``make_pipeline_train_step``: the block stack runs
    through the layer pipeline (``pipeline.pipeline_apply_gspmd``: M
    microbatches, S stages in turn each tick, M + S - 1 ticks), cut by
    ``planner.plan_lm_stages`` at ``shape``'s sequence and global batch.
    S is the size of ``mesh``'s ``stage_axis``, as in the reference
    (stage s runs on slot s, its staged params there: a mesh of slots on
    the device of the params, ``launch.mesh.device_slots``), or
    ``n_stages`` without a mesh.

    Returns (train_step, restructure, planout):
    ``restructure(params) -> (sparams, mask)`` moves the (L, ...)-stacked
    blocks to (S, Lmax, ...) stages under ``sparams["staged"]`` and gives
    the (S, Lmax) host mask; ``train_step(sparams, mask, opt_state,
    batch) -> (sparams, opt_state, metrics)`` with the reference's loss,
    the mean nll of a full ``log_softmax`` (no chunks, no aux). zamba2's
    ``_attn_flag`` (the reference folds it into the staged params as an
    int32 array) stays on the host: S lists of Lmax ints, joined to each
    stage's params as the stage runs; each flag is its site's number + 1,
    and each site runs the shared block on its own slice of a stack of
    the shared params, so each site's gradient sums its microbatches
    alone and the sites are added in order: the shared block's gradient
    does not depend on how the stages cut the layers.

    ``train_step.value_and_grad(sparams, mask, batch, executor=)`` gives
    ((loss, metrics), grads) without the update; ``executor=
    pipeline.sequential_apply`` runs the same microbatches through the
    stages in order, without the pipeline."""
    if mesh is not None:
        if stage_axis not in mesh.shape:
            raise ValueError(f"mesh has no {stage_axis!r} axis "
                             f"(axes: {tuple(mesh.shape)})")
        if n_stages is not None and n_stages != mesh.shape[stage_axis]:
            raise ValueError(f"n_stages={n_stages} but the mesh's "
                             f"{stage_axis!r} axis has "
                             f"{mesh.shape[stage_axis]} slots")
        if len(mesh.device_set()) > 1:
            raise ValueError(
                "the train step's embedding, positions and head live on "
                "one device; its stage mesh takes slots of that device "
                f"(got {sorted(map(str, mesh.device_set()))})")
        n_stages = mesh.shape[stage_axis]
    elif n_stages is None:
        raise ValueError("without a mesh, give n_stages")
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    planout = planner.plan_lm_stages(cfg, shape.seq_len, shape.global_batch,
                                     n_stages)
    stage_of = planout["stage_of"]
    flags, n_sites = None, 0
    if cfg.family == "hybrid" and cfg.hybrid_attn_every:
        site = []
        for f in lm.attn_flags(cfg):
            n_sites += f
            site.append(n_sites if f else 0)
        flags = pp.stack_stages({"_attn_flag": site}, stage_of,
                                n_stages)[0]["_attn_flag"]

    def restructure(params):
        staged, mask = pp.stack_stages(dict(params["blocks"]), stage_of,
                                       n_stages)
        rest = {k: v for k, v in params.items() if k != "blocks"}
        return {"staged": staged, **rest}, mask

    def loss(ps, mask, batch, executor=pp.pipeline_apply_gspmd):
        dev = ps["embed"].device
        with L.full_f32():
            h = lm._embed(cfg, ps, torch.as_tensor(batch["tokens"]))
            if cfg.family == "vlm":
                h = torch.cat([torch.as_tensor(batch["patches"]).to(
                    dev, h.dtype), h], dim=1)
            b, t, _ = h.shape
            positions = torch.arange(t, device=dev)[None]   # microbatch-safe
            shared_at = None
            if n_sites:
                sites = pytree.map_leaves(
                    lambda t: torch.stack([t] * n_sites), ps["shared"])
                sites = pytree.rebuild(ps["shared"], dict(
                    pytree.keyed_leaves(sites)).get)

                def shared_at(flag):
                    return {"shared": pp.index_tree(sites, flag - 1)}
            block_fn = lm.make_pipeline_block_fn(cfg, ps, positions,
                                                 shared_at=shared_at)
            stage_fn = pp.make_stage_fn(block_fn)
            staged = ps["staged"] if flags is None else dict(
                ps["staged"], _attn_flag=flags)
            out = executor(
                stage_fn, staged, mask, pp.microbatch(h, n_microbatches),
                n_stages=n_stages, stage_axis=stage_axis, mesh=mesh)
            logits = lm._logits(cfg, ps, out.reshape(b, t, -1))
            labels = torch.as_tensor(batch["labels"]).to(dev).long()
            if cfg.family == "vlm":
                logits = logits[:, -labels.shape[1]:]
            logp = F.log_softmax(logits, dim=-1)
            nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
            value = nll.mean()
            return value, {"loss": value}

    def grads(sparams, mask, batch, *, executor=pp.pipeline_apply_gspmd):
        return value_and_grad(lambda p: loss(p, mask, batch, executor),
                              sparams)

    def train_step(sparams, mask, opt_state, batch):
        (_, metrics), g = grads(sparams, mask, batch)
        sparams, opt_state, om = adamw.update(opt_cfg, sparams, g,
                                              opt_state)
        return sparams, opt_state, {**metrics, **om}

    train_step.value_and_grad = grads
    return train_step, restructure, planout
