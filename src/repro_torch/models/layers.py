"""Weight containers, initializers and the dense LM's layers
(counterpart of the reference's ``src/repro/models/layers.py``).

The LM layers keep the reference's dtype boundaries: ``fdot`` upcasts
both operands to f32, ``rms_norm`` and ``rope`` work in f32 and round
to x's dtype, the q/k/v projections round to bf16, decode attention
rounds the softmax to bf16 before the PV product, and the FFN's sparse
products go through ``kernels/ops.sparse_matmul``. The prefill
attention, and a multi-token step into a KV cache (the reference's
``kv_len`` branch, a chunk of a prompt), go through
``kernels/ops.flash_attention``, which computes what the reference's
Pallas flash kernel computes (p kept in f32), not what its XLA
``blockwise_attention`` computes (p rounded to bf16). A one-token step
takes one cache position for the batch or one a row (continuous
batching, ``runtime/scheduler.py``).
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops


@dataclass
class SparseWeight:
    """Block-balanced sparse weight for y = x @ W, W: (d_in, d_out).

    vals: (out_blocks, K, bm, bn) — the K surviving input blocks of each
          output block column (HPIPE: one channel split's weights,
          padded to equal length). Float natively; int8 codes when
          quantized (``core/quant.py``).
    idx:  (out_blocks, K) int32 — input block ids, ascending (HPIPE:
          decoded runlengths).
    d_in: input width of the dense matrix.
    scale: (out_blocks, bn) f32, one symmetric scale per output channel,
          present iff vals are int8 codes.
    orig_dtype: the dtype name that dequantization restores (None when
          not quantized).
    """
    vals: torch.Tensor
    idx: torch.Tensor
    d_in: int
    scale: Optional[torch.Tensor] = None
    orig_dtype: Optional[str] = None

    def __post_init__(self):
        if self.idx.dtype != torch.int32:
            raise ValueError(f"idx must be int32, got {self.idx.dtype}")
        if (self.scale is None) != (self.orig_dtype is None) or (
                self.scale is not None and self.vals.dtype != torch.int8):
            raise ValueError("scale and orig_dtype come together, with "
                             "int8 vals")

    @property
    def d_out(self) -> int:
        return self.vals.shape[-4] * self.vals.shape[-1]

    def dequant_vals(self) -> torch.Tensor:
        """vals at their original float dtype (the vals themselves if not
        quantized): codes * scale in f32, rounded once."""
        if self.scale is None:
            return self.vals
        return (self.vals.float() * self.scale[:, None, None, :].float()
                ).to(getattr(torch, self.orig_dtype))

    def dequantized(self) -> "SparseWeight":
        """The weight with float vals and no scale."""
        if self.scale is None:
            return self
        return SparseWeight(self.dequant_vals(), self.idx, self.d_in)

    def to(self, device) -> "SparseWeight":
        return SparseWeight(
            self.vals.to(device), self.idx.to(device), self.d_in,
            None if self.scale is None else self.scale.to(device),
            self.orig_dtype)


def dense_init(generator: torch.Generator, shape, in_axis_size: int,
               dtype=torch.bfloat16) -> torch.Tensor:
    """Uniform in [-1/sqrt(fan_in), 1/sqrt(fan_in)) drawn in f32 from
    ``generator``, then cast to ``dtype``. Same law as the reference's
    ``dense_init``; torch's generator gives other numbers than
    ``jax.random`` for the same seed. The tensor is made on the
    generator's device."""
    scale = 1.0 / math.sqrt(max(in_axis_size, 1))
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return w.uniform_(-scale, scale, generator=generator).to(dtype)


def tensor_from_numpy(a) -> torch.Tensor:
    """numpy -> torch, bit-exact; bf16 (numpy dtype name ``bfloat16``,
    what ``np.asarray`` of a JAX bf16 array gives) goes through int16."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


# ---------------------------------------------------------------------------
# f32 products, norms, rope
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def full_f32():
    """f32 products and convolutions in IEEE f32 on the card: TF32 off
    for cuBLAS and cuDNN (cuDNN's default is on) in scope, the
    reference's ``preferred_element_type=f32``, whatever values reach
    them."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


_ACCUM = {"dtype": torch.float32}


@contextlib.contextmanager
def accum_dtype(dtype):
    """Scope the dtype ``fdot`` sums in: f32 (the reference's default),
    or f64, to measure how far the order of f32 sums alone moves a
    result (the floor under any bar between two devices)."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"accum_dtype: f32 or f64, not {dtype}")
    prev = _ACCUM["dtype"]
    _ACCUM["dtype"] = dtype
    try:
        yield
    finally:
        _ACCUM["dtype"] = prev


def fdot(expr: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum with both operands upcast to the accumulation dtype (f32:
    the reference's ``fdot`` at its default); an f32 result."""
    ad = _ACCUM["dtype"]
    return torch.einsum(expr, a.to(ad), b.to(ad)).float()


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * gamma.float()).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., T, H, Dh), positions: (..., T) integer."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].float() * freq                # (..., T, half)
    ang = ang[..., None, :]                                  # (..., T, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def linear(x: torch.Tensor, w) -> torch.Tensor:
    """x: (..., d_in) @ w, where w is a dense tensor or a SparseWeight."""
    if isinstance(w, SparseWeight):
        return kops.sparse_matmul(x, w)
    return fdot("...i,io->...o", x, w).to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA + optional qk-norm + optional sliding window)
# ---------------------------------------------------------------------------

def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, KV, D) -> (B, S, KV * n_rep, D), each KV head repeated
    n_rep times; a copy, contiguous (with one KV head a reshape alone
    would be a stride-0 view, which the flash kernel refuses)."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d).contiguous()


def init_attention(generator: torch.Generator, cfg,
                   dtype=torch.bfloat16) -> dict:
    """3D projection weights (d, heads, dh), as in the reference."""
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(generator, (d, h, dh), d, dtype),
        "wk": dense_init(generator, (d, kv, dh), d, dtype),
        "wv": dense_init(generator, (d, kv, dh), d, dtype),
        "wo": dense_init(generator, (h, dh, d), h * dh, dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((dh,), dtype=dtype, device=generator.device)
        p["k_norm"] = torch.ones((dh,), dtype=dtype, device=generator.device)
    return p


def attention(p: dict, cfg, x: torch.Tensor, *, positions: torch.Tensor,
              causal: bool = True, window: int = 0, kv_cache=None,
              cache_pos=None):
    """GQA attention. Returns (out, new_kv): the (k, v) pair of this call
    (prefill) or the cache (a step into it).

    Without a cache (prefill) the whole sequence goes through
    ``ops.flash_attention``. With a cache (B, S, KV, Dh) the t new rows
    are written into it IN PLACE (the reference returns a new cache; the
    port saves the copy):

    - t == 1: at ``cache_pos``, an int for the batch or a (B,) tensor,
      one position a row; the query attends by a grouped einsum over
      the cache, masked per row to the first ``cache_pos + 1`` keys, in
      plain torch (the reference has no kernel there);
    - t > 1 (the reference's ``kv_len`` branch): at rows ``cache_pos``
      .. ``cache_pos + t - 1`` (an int); the queries attend through
      ``ops.flash_attention`` over the cache's first ``kv_len =
      cache_pos + t`` keys with ``q_offset = cache_pos``."""
    b, t, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    q = fdot("btd,dhk->bthk", x, p["wq"]).to(x.dtype)
    k = fdot("btd,dhk->bthk", x, p["wk"]).to(x.dtype)
    v = fdot("btd,dhk->bthk", x, p["wv"]).to(x.dtype)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if kv_cache is None:
        o = kops.flash_attention(q, _repeat_kv(k, h // kv),
                                 _repeat_kv(v, h // kv), causal=causal,
                                 window=window)
        new_cache = (k, v)
    elif t > 1:
        ck, cv = kv_cache                      # (B, S, KV, Dh)
        if isinstance(cache_pos, torch.Tensor) or \
                not 0 <= cache_pos <= ck.shape[1] - t:
            raise ValueError(f"a {t}-token step into a cache of "
                             f"{ck.shape[1]} rows takes one int cache_pos "
                             f"in [0, {ck.shape[1] - t}], got {cache_pos!r}")
        ck[:, cache_pos:cache_pos + t] = k.to(ck.dtype)
        cv[:, cache_pos:cache_pos + t] = v.to(cv.dtype)
        kv_len = cache_pos + t
        o = kops.flash_attention(
            q, _repeat_kv(ck[:, :kv_len], h // kv).contiguous(),
            _repeat_kv(cv[:, :kv_len], h // kv).contiguous(),
            causal=causal, window=window, q_offset=cache_pos)
        new_cache = (ck, cv)
    else:
        ck, cv = kv_cache                      # (B, S, KV, Dh)
        kpos = torch.arange(ck.shape[1], device=x.device)
        if isinstance(cache_pos, torch.Tensor):   # one position a row
            pos = cache_pos.to(x.device).long()
            rows = torch.arange(b, device=x.device)
            ck[rows, pos] = k[:, 0].to(ck.dtype)
            cv[rows, pos] = v[:, 0].to(cv.dtype)
            kv_len = (pos + 1)[:, None]           # (B, 1)
            mask = kpos[None] < kv_len            # (B, S)
            if window:
                mask &= kpos[None] > (kv_len - 1 - window)
            mask = mask[:, None, None, None]      # (B, 1, 1, 1, S)
        else:
            ck[:, cache_pos] = k[:, 0].to(ck.dtype)
            cv[:, cache_pos] = v[:, 0].to(cv.dtype)
            kv_len = cache_pos + 1
            mask = kpos < kv_len
            if window:
                mask &= kpos > (kv_len - 1 - window)
        g = h // kv
        s = fdot("bqkgd,bskd->bkgqs", q.reshape(b, t, kv, g, dh),
                 ck) / math.sqrt(dh)
        s = s.masked_fill(~mask, -math.inf)
        o = fdot("bkgqs,bskd->bqkgd", torch.softmax(s, dim=-1).to(cv.dtype),
                 cv)
        o = o.reshape(b, t, h, dh).to(x.dtype)
        new_cache = (ck, cv)
    out = fdot("bthk,hkd->btd", o, p["wo"]).to(x.dtype)
    return out, new_cache


# ---------------------------------------------------------------------------
# FFN (gated SiLU) — dense or HPIPE-sparse
# ---------------------------------------------------------------------------

def init_ffn(generator: torch.Generator, d_model: int, d_ff: int,
             sparsity=None, dtype=torch.bfloat16) -> dict:
    from repro_torch.core.sparsity import to_block_balanced
    w1 = dense_init(generator, (d_model, d_ff), d_model, dtype)
    w3 = dense_init(generator, (d_model, d_ff), d_model, dtype)
    w2 = dense_init(generator, (d_ff, d_model), d_ff, dtype)
    if sparsity is not None and sparsity.enabled and sparsity.prune_ffn:
        w1, w3, w2 = (to_block_balanced(w, sparsity) for w in (w1, w3, w2))
    return {"w1": w1, "w2": w2, "w3": w3}


def ffn(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(linear(x, p["w1"]).float()).to(x.dtype)
    h = h * linear(x, p["w3"])
    return linear(h, p["w2"])


# ---------------------------------------------------------------------------
# MoE (token-choice top-k, capacity dispatch)
# ---------------------------------------------------------------------------

def init_moe(generator: torch.Generator, cfg, dtype=torch.bfloat16) -> dict:
    """The router (d, e) in f32; the experts' w1, w3 (e, d, f) and w2
    (e, f, d) at ``dtype``; each drawn by ``dense_init`` with the
    reference's fan-in, in the reference's order."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    return {"router": dense_init(generator, (d, e), d, torch.float32),
            "w1": dense_init(generator, (e, d, f), d, dtype),
            "w3": dense_init(generator, (e, d, f), d, dtype),
            "w2": dense_init(generator, (e, f, d), f, dtype)}


# The reference's data-parallel degree for MoE dispatch: the routing
# groups ``moe`` takes when its caller names none.
_MOE = {"dp": 1}


def set_moe_dp(dp: int) -> None:
    """Set the ``groups`` of every later ``moe`` call that names none."""
    _MOE["dp"] = max(int(dp), 1)


@dataclass
class MoERoute:
    """One routing of G groups of n tokens each (tensors on the tokens'
    device).

    probs: (G, n, e) f32 router softmax; gate, eidx: (G, n, k) the top-k
    (descending) and their ids, gates renormalised; cap: the slots an
    expert has in a group; offsets: (G, e + 1) each expert's first
    position among the assignments sorted by expert (stably, so in token
    order); order: (G, n * k) the flat assignments (token-major) in that
    order, rank: (G, n * k) each one's position in it; tok_for_slot:
    (G, e, cap) the token in each slot, n where the slot is empty."""
    probs: torch.Tensor
    gate: torch.Tensor
    eidx: torch.Tensor
    cap: int
    offsets: torch.Tensor
    order: torch.Tensor
    rank: torch.Tensor
    tok_for_slot: torch.Tensor

    @property
    def counts(self) -> torch.Tensor:
        """(G, e) assignments each expert was chosen for."""
        return self.offsets[:, 1:] - self.offsets[:, :-1]

    @property
    def kept(self) -> torch.Tensor:
        """(G, n, k) whether each assignment got a slot (the others are
        dropped: their expert was full)."""
        first = torch.gather(self.offsets, 1, self.eidx.flatten(1))
        return (self.rank - first < self.cap).reshape(self.eidx.shape)

    @property
    def dropped(self) -> torch.Tensor:
        """Assignments dropped, over the groups (a device scalar)."""
        return (self.counts - self.cap).clamp_min(0).sum()


def moe_route(router: torch.Tensor, cfg, xg: torch.Tensor,
              capacity_factor: float) -> MoERoute:
    """The reference's ``_moe_local`` routing for each of G groups of
    tokens, xg (G, n, d): f32 router logits, softmax, top-k, gates
    renormalised by max(sum, 1e-9), cap = max(min(int(cf * n * k / e),
    n), 1), a stable sort of the flat expert ids, per-expert offsets by
    a left ``searchsorted``, the (e, cap) slot table."""
    g, n, _ = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax(fdot("gnd,de->gne", xg, router), dim=-1)
    gate, eidx = torch.topk(probs, k, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    cap = max(min(int(capacity_factor * n * k / e), n), 1)
    nk = n * k
    sorted_e, order = torch.sort(eidx.reshape(g, nk), dim=-1, stable=True)
    experts = torch.arange(e + 1, device=xg.device)
    offsets = torch.searchsorted(sorted_e, experts.expand(g, e + 1)
                                 .contiguous())
    slot = offsets[:, :-1, None] + torch.arange(cap, device=xg.device)
    valid = slot < offsets[:, 1:, None]
    sorted_tok = order // k
    tok = torch.gather(sorted_tok, 1, slot.clamp(0, nk - 1).reshape(g, -1))
    tok_for_slot = torch.where(valid, tok.reshape(g, e, cap), n)
    return MoERoute(probs, gate, eidx, cap, offsets, order,
                    torch.argsort(order, dim=-1), tok_for_slot)


_MOE_RECORD: list = []


@contextlib.contextmanager
def record_moe():
    """Collect the :class:`MoERoute` of every ``moe`` call in scope, in
    call order (the routes stay on their device: nothing is read back)."""
    routes: list = []
    _MOE_RECORD.append(routes)
    try:
        yield routes
    finally:
        _MOE_RECORD.remove(routes)


def _moe_groups(p: dict, cfg, xg: torch.Tensor, capacity_factor: float):
    """Route and run G groups of tokens, xg (G, n, d). Returns (out (G,
    n, d) at x's dtype, aux (G,) f32).

    Each expert runs on its whole (G * cap)-row buffer, empty slots on
    the zero pad row, as in the reference. The products keep the
    reference's dtype boundaries: silu of buf @ w1 in f32 rounded to x's
    dtype, times buf @ w3, then @ w2, each an f32 sum rounded once
    (``fdot``); each slot's output times its gate, rounded. The combine
    gathers each token's kept slots in ascending expert order and adds
    them in f32 one at a time (the order of the reference's scatter-add
    on the CPU), then rounds once: no atomics, so the bits do not change
    from run to run."""
    g, n, d = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    r = moe_route(p["router"], cfg, xg, capacity_factor)
    for routes in _MOE_RECORD:
        routes.append(r)
    cap, dt, dev = r.cap, xg.dtype, xg.device
    tok = r.tok_for_slot
    x_pad = torch.cat([xg, xg.new_zeros((g, 1, d))], dim=1)
    buf = torch.gather(x_pad, 1, tok.reshape(g, e * cap, 1).expand(
        g, e * cap, d))
    buf = buf.reshape(g, e, cap, d).transpose(0, 1).reshape(e, g * cap, d)
    h = F.silu(fdot("ecd,edf->ecf", buf, p["w1"]).to(dt).float()).to(dt)
    h = h * fdot("ecd,edf->ecf", buf, p["w3"]).to(dt)
    out_e = fdot("ecf,efd->ecd", h, p["w2"]).to(dt)
    out_e = out_e.reshape(e, g, cap, d).transpose(0, 1)       # (G, e, cap, d)
    # each slot's gate: the gate of the assignment sorted into it
    slot = r.offsets[:, :-1, None] + torch.arange(cap, device=dev)
    g_sorted = torch.gather(r.gate.reshape(g, -1), 1, r.order)
    g_slot = torch.where(tok < n, torch.gather(
        g_sorted, 1, slot.clamp(0, n * k - 1).reshape(g, -1)).reshape(
        g, e, cap), 0.0)
    contrib = (out_e * g_slot[..., None].to(dt)).reshape(g * e * cap, d)
    # combine: each token's assignments by ascending expert id
    eids, j = torch.sort(r.eidx, dim=-1)                       # (G, n, k)
    a = torch.arange(n, device=dev)[None, :, None] * k + j
    c = torch.gather(r.rank, 1, a.reshape(g, -1)).reshape(g, n, k) - \
        torch.gather(r.offsets, 1, eids.reshape(g, -1)).reshape(g, n, k)
    kept = c < cap
    row = (torch.arange(g, device=dev)[:, None, None] * e + eids) * cap + \
        c.clamp(max=cap - 1)
    acc = torch.zeros((g, n, d), dtype=torch.float32, device=dev)
    for m in range(k):
        v = contrib[row[:, :, m]].float()
        acc = acc + torch.where(kept[:, :, m, None], v, 0.0)
    # load-balance aux loss (Switch-style), per group
    counts = r.counts.float()
    ce = counts / counts.sum(-1, keepdim=True).clamp_min(1.0) * e
    aux = (r.probs.mean(1) * ce).sum(-1)
    return acc.to(dt), aux


def _moe_local(p: dict, cfg, x: torch.Tensor,
               capacity_factor: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_moe_local``: x's B * T tokens routed together.
    Returns (out (B, T, d), aux)."""
    return moe(p, cfg, x, capacity_factor=capacity_factor, groups=1)


def moe(p: dict, cfg, x: torch.Tensor, *, capacity_factor: float = 1.25,
        groups: Optional[int] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Token-choice top-k MoE with capacity dispatch. x: (B, T, d).
    Returns (out, aux).

    ``groups`` contiguous groups of the flattened tokens are routed each
    alone, each with its own capacity, and aux is their mean (the
    reference's dp > 1 branch); when B * T is no multiple of it, all
    tokens are routed together. A call that names no ``groups`` takes
    ``set_moe_dp``'s. ``decode_step`` with one position a row passes
    groups=B: each row alone, as the reference's batcher routes a slot
    (its decode is vmapped over the slots)."""
    b, t, d = x.shape
    g = _MOE["dp"] if groups is None else groups
    if g < 1 or (b * t) % g:
        g = 1
    out, aux = _moe_groups(p, cfg, x.reshape(g, b * t // g, d),
                           capacity_factor)
    return out.reshape(b, t, d), aux.mean()
