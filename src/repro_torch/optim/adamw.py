"""AdamW and its schedule over the port's parameter trees (the
reference's ``src/repro/optim/adamw.py``).

Sparse values get moments of the same compressed shape: a pruned block
never has optimizer state, the memory analogue of HPIPE's compressed
weight buffers. The moments are f32; integer leaves (``SparseWeight``'s
idx) are not trained and their gradient is None. The update runs in f32
and casts each leaf back to its dtype, as the reference's does; it
makes new tensors and leaves its inputs as they were.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.core import pytree


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    m: Any
    v: Any
    step: torch.Tensor


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor): linear warmup,
    then a cosine down to ``min_lr_frac``; f32, as the reference."""
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = prog.clamp(0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params) -> OptState:
    """Zero f32 moments shaped as every leaf (idx too, as the reference's
    ``jax.tree.map`` gives them) and step 0, on the params' device."""
    leaves = pytree.leaves(params)
    dev = leaves[0].device

    def zeros(p):
        return pytree.map_leaves(
            lambda a: torch.zeros(a.shape, dtype=torch.float32,
                                  device=a.device), p)

    return OptState(m=zeros(params), v=zeros(params),
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in f32, the leaves summed
    in ``core/pytree.leaves`` order (the reference's); None leaves (no
    gradient) add nothing."""
    total = None
    for leaf in pytree.leaves(tree):
        if leaf is None:
            continue
        sq = torch.sum(torch.square(leaf.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def update(cfg: AdamWConfig, params, grads, state: OptState):
    """Returns (new_params, new_state, metrics {"grad_norm", "lr"})."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    new = {}

    def upd(key, p, g, m, v):
        if g is None or not p.is_floating_point():
            new[key] = (m, v)            # e.g. SparseWeight.idx: not trained
            return p
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mh = m / b1c
        vh = v / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * \
            p.float()
        new[key] = (m, v)
        return (p.float() - lr * delta).to(p.dtype)

    flat = [dict(pytree.keyed_leaves(t))
            for t in (params, grads, state.m, state.v)]
    new_params = pytree.rebuild(params, lambda key: upd(
        key, *(f[key] for f in flat)))
    new_m = pytree.rebuild(state.m, lambda key: new[key][0])
    new_v = pytree.rebuild(state.v, lambda key: new[key][1])
    return new_params, OptState(new_m, new_v, step), {
        "grad_norm": gnorm, "lr": lr}
