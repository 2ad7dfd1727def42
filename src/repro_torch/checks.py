"""Which MoE tokens two computations of the same model can be held to.

Two devices, two batch shapes, or the port and the reference, sum the
router's input in other orders. A token whose k-th and (k+1)-th router
probabilities lie close may then take another expert, and a drop at a
full expert may move to a later token of its routing group. These
helpers read :class:`repro_torch.models.layers.MoERoute` s (recorded by
``layers.record_moe``) and say which tokens do not hang on such a near
tie; ``chip_smoke.py`` and the tests compare outputs only there.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

#: the relative gap between a token's k-th and (k+1)-th router
#: probabilities under which two devices fed the same input may route it
#: otherwise: the f32 router sums taken in another order move a
#: probability by ~1e-6 of it
MOE_TIE_MARGIN = 1e-4


def gap(route) -> torch.Tensor:
    """(G, n): each token's k-th against its (k+1)-th probability,
    (p_k - p_k+1) / p_k; 1 when every expert is chosen."""
    k = route.eidx.shape[-1]
    if k >= route.probs.shape[-1]:
        return torch.ones(route.probs.shape[:2], device=route.probs.device)
    top = torch.topk(route.probs, k + 1, dim=-1).values
    return (top[..., k - 1] - top[..., k]) / top[..., k - 1]


def _reach(route, margin: float):
    """(near (G, n), reach (G, n, e)): the tokens whose gap() is below
    ``margin``, and for each the experts at its k-th and (k+1)-th places
    (a near token may take either)."""
    k, e = route.eidx.shape[-1], route.probs.shape[-1]
    near = gap(route) < margin
    cand = torch.topk(route.probs, min(k + 1, e), dim=-1).indices[..., k - 1:]
    return near, F.one_hot(cand, e).bool().any(2) & near[..., None]


def ties(route, margin: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Where another order of f32 sums may route otherwise: (near (G, n),
    touched (G, e)), the tokens whose gap() is below ``margin`` and the
    experts a near token may take."""
    near, reach = _reach(route, margin)
    return near, reach.any(1)


def clear(route, margin: float) -> torch.Tensor:
    """(G, n): the tokens of one layer fed the same input whose experts,
    kept slots and output do not hang on a near tie: not near themselves,
    and at none of their experts that is at or past capacity is a near
    token that may take it ahead of them (joining or leaving, it may move
    a drop to them; slots go in token order)."""
    near, reach = _reach(route, margin)
    n = near.shape[1]
    pos = torch.arange(n, device=near.device)
    first = torch.where(reach, pos[None, :, None], n).amin(1)      # (G, e)
    flat = route.eidx.flatten(1)
    ahead = torch.gather(first, 1, flat).reshape(route.eidx.shape)
    full = torch.gather(route.counts >= route.cap, 1, flat).reshape(
        route.eidx.shape)
    hit = (full & (pos[None, :, None] > ahead)).any(-1)
    return ~near & ~hit


def held_tokens(routes: list, b: int, t: int, margin: float,
                held_rows=None) -> np.ndarray:
    """(B, T) bool: the tokens of one call of a whole model whose output
    does not hang on a near tie. ``routes``: the call's routes layer by
    layer, its B * T tokens in contiguous groups; ``held_rows``: (B,) the
    rows held before the call (a decode row whose cache may already
    differ is not). A token is lost in a layer where its gap() is below
    ``margin``; then so is every later token of its group routed to an
    expert at or past capacity (the lost token may have taken or freed a
    slot there), and, from the next layer on, every later position of its
    row (attention reads it)."""
    ok = np.ones((b, t), bool) if held_rows is None else \
        np.repeat(np.asarray(held_rows, bool)[:, None], t, 1)
    for r in routes:
        ok = np.minimum.accumulate(ok, axis=1)
        g, n = r.eidx.shape[:2]
        bad = ~ok.reshape(g, n) | (gap(r).cpu().numpy() < margin)
        full = (r.counts >= r.cap).cpu().numpy()
        at_full = np.take_along_axis(
            full, r.eidx.flatten(1).cpu().numpy(), 1).reshape(g, n, -1).any(
            -1)
        first = np.where(bad.any(1), bad.argmax(1), n)
        bad |= (np.arange(n)[None] > first[:, None]) & at_full
        ok = ~bad.reshape(b, t)
    return ok
