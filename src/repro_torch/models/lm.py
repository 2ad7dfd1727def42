"""Dense language model on the port (counterpart of the reference's
``src/repro/models/lm.py``, dense family only).

The parameters keep the reference's layout: ``embed`` (V, d), the layer
stack ``blocks`` with a leading L axis on every leaf (a sparse FFN
weight is one ``SparseWeight`` with vals (L, ob, K, bm, bn) and idx
(L, ob, K)), ``final_norm``, and ``head`` when the embeddings are not
tied. The layer loop is a Python loop over views of layer l.

    init_params(cfg, generator)             -> params
    init_cache(cfg, batch, max_seq)         -> decode cache (zeros)
    forward(cfg, params, tokens)            -> (logits, aux)  prefill
    decode_step(cfg, params, cache, tokens, pos) -> (logits, cache)
    prefill_chunk(cfg, params, cache, tokens, pos) -> (logits, cache)

``forward``, ``decode_step`` and ``prefill_chunk`` run where the
parameters are. ``decode_step`` takes one token a row, at one position
for the batch or one a row (continuous batching,
``runtime/scheduler.py``); ``prefill_chunk`` writes a chunk of T
tokens at positions pos .. pos + T - 1 into the cache (the reference's
``kv_len`` branch). The MoE, SSM, hybrid, encoder-decoder and VLM
families raise, naming their ROADMAP item
(``configs/base.py::UNPORTED_LM_FAMILIES``); ``loss_fn`` and remat are
not ported (ROADMAP Queue 1 item 8e, training).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import UNPORTED_LM_FAMILIES
from repro_torch.core.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.layers import SparseWeight, tensor_from_numpy

LOGITS_MODES = ("full", "last", "hidden")


def _check_family(cfg) -> None:
    if cfg.family != "dense":
        item = UNPORTED_LM_FAMILIES.get(cfg.family,
                                        "Queue 1, the rest of the LM side")
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet: ROADMAP "
            f"{item}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_block(cfg, generator: torch.Generator) -> dict:
    d = cfg.d_model
    sp = cfg.sparsity if cfg.sparsity.enabled else None
    ones = lambda: torch.ones((d,), dtype=torch.bfloat16,  # noqa: E731
                              device=generator.device)
    return {"ln1": ones(),
            "attn": L.init_attention(generator, cfg),
            "ln2": ones(),
            "ffn": L.init_ffn(generator, d, cfg.d_ff, sp)}


def _stack(trees: list):
    """Stack L per-layer trees into one tree with a leading L axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, SparseWeight):
        return SparseWeight(torch.stack([t.vals for t in trees]),
                            torch.stack([t.idx for t in trees]), first.d_in)
    return torch.stack(trees)


def _layer(tree, l: int):
    """Layer l of a stacked tree: views, no copies."""
    if isinstance(tree, dict):
        return {k: _layer(v, l) for k, v in tree.items()}
    if isinstance(tree, SparseWeight):
        return SparseWeight(tree.vals[l], tree.idx[l], tree.d_in)
    return tree[l]


def init_params(cfg, generator: torch.Generator) -> dict:
    """Random parameters drawn from ``generator``, made on its device.
    The reference's laws (``dense_init``, block-balanced pruning of the
    FFN); torch's numbers are not ``jax.random``'s."""
    _check_family(cfg)
    d = cfg.d_model
    p = {
        "embed": L.dense_init(generator, (cfg.vocab_size, d), d),
        "blocks": _stack([_init_block(cfg, generator)
                          for _ in range(cfg.n_layers)]),
        "final_norm": torch.ones((d,), dtype=torch.bfloat16,
                                 device=generator.device),
    }
    if not cfg.tie_embeddings:
        p["head"] = L.dense_init(generator, (d, cfg.vocab_size), d)
    return p


def params_from_numpy(tree: dict, *, device="cuda") -> dict:
    """The reference's LM params, given as numpy, as the port's, on
    ``device``. A sparse weight is given as ``{"vals", "idx", "d_in"}``
    (stacked leaves keep their L axis); every other dict is a subtree.
    Every leaf keeps its dtype and bits."""
    dev = resolve_device(device)

    def convert(node):
        if isinstance(node, dict) and set(node) == {"vals", "idx", "d_in"}:
            return SparseWeight(
                tensor_from_numpy(node["vals"]).to(dev),
                tensor_from_numpy(node["idx"]).to(torch.int32).to(dev),
                int(node["d_in"]))
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return tensor_from_numpy(node).to(dev)

    return convert(tree)


def params_to(tree, device):
    """A copy of a parameter tree on ``device``."""
    if isinstance(tree, dict):
        return {k: params_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def init_cache(cfg, batch: int, max_seq: int, *, device="cuda") -> dict:
    """Zeroed decode cache: kv (L, 2, B, S, KV, Dh) bf16."""
    _check_family(cfg)
    return {"kv": torch.zeros(
        (cfg.n_layers, 2, batch, max_seq, cfg.kv_heads, cfg.head_dim),
        dtype=torch.bfloat16, device=resolve_device(device))}


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def _embed(cfg, params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.to(params["embed"].device).long()]


def _logits(cfg, params, h: torch.Tensor) -> torch.Tensor:
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return L.fdot("btd,dv->btv", h, w)


def make_block_fn(cfg, positions: torch.Tensor):
    """Per-layer block function ``(h, p) -> (h, aux)`` over the whole
    sequence; aux is 0 for the dense family."""
    _check_family(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=positions.device)

    def block(h, p):
        a, _ = L.attention(p["attn"], cfg,
                           L.rms_norm(h, p["ln1"], cfg.norm_eps),
                           positions=positions, window=cfg.attn_window)
        h = h + a
        h = h + L.ffn(p["ffn"], L.rms_norm(h, p["ln2"], cfg.norm_eps))
        return h, aux

    return block


def forward(cfg, params, tokens: torch.Tensor, *, logits_mode: str = "full"):
    """Full-sequence forward -> (logits | hidden, aux).

    logits_mode: "full" (B, T, V) f32 | "last" (B, V) f32 | "hidden"
    (B, T, d)."""
    if logits_mode not in LOGITS_MODES:
        raise ValueError(f"logits_mode={logits_mode!r}: expected one of "
                         f"{LOGITS_MODES}")
    with L.full_f32():
        h = _embed(cfg, params, tokens)
        b, t, _ = h.shape
        positions = torch.arange(t, device=h.device)[None].expand(b, t)
        block = make_block_fn(cfg, positions)
        for l in range(cfg.n_layers):
            h, aux = block(h, _layer(params["blocks"], l))
        if logits_mode == "hidden":
            return h, aux
        if logits_mode == "last":
            return _logits(cfg, params, h[:, -1:])[:, 0], aux
        return _logits(cfg, params, h), aux


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def decode_block(cfg, p, h: torch.Tensor, kv: torch.Tensor,
                 positions: torch.Tensor, pos) -> torch.Tensor:
    """One layer of a step into the cache: p the layer's parameters, kv
    its cache (2, B, S, KV, Dh), written in place at ``pos`` (an int,
    or a (B,) tensor for a one-token step: one position a row)."""
    a, _ = L.attention(p["attn"], cfg, L.rms_norm(h, p["ln1"], cfg.norm_eps),
                       positions=positions, window=cfg.attn_window,
                       kv_cache=(kv[0], kv[1]), cache_pos=pos)
    h = h + a
    return h + L.ffn(p["ffn"], L.rms_norm(h, p["ln2"], cfg.norm_eps))


def _cache_step(cfg, params, cache, tokens, positions, pos):
    with L.full_f32():
        h = _embed(cfg, params, tokens)
        for l in range(cfg.n_layers):
            h = decode_block(cfg, _layer(params["blocks"], l), h,
                             cache["kv"][l], positions, pos)
        return _logits(cfg, params, h), cache


def decode_step(cfg, params, cache: dict, tokens: torch.Tensor, pos):
    """One-token decode. tokens: (B, 1); pos: the position, an int for
    every row, or a (B,) integer tensor (or array), one a row.

    Returns (logits (B, 1, V) f32, cache). The cache is updated IN PLACE
    and returned: the reference returns a new one. A step of T > 1
    tokens raises: the reference's ``decode_step`` ropes all T tokens
    at ``pos`` (its ``positions`` broadcast one position), which no
    caller wants; :func:`prefill_chunk` places them at pos .. pos+T-1."""
    _check_family(cfg)
    if tokens.shape[1] != 1:
        raise ValueError(
            f"decode_step takes one token a row, got {tokens.shape[1]}: the "
            "reference ropes every token of a multi-token step at pos; "
            "prefill_chunk writes a chunk at pos .. pos + T - 1")
    dev = params["embed"].device
    if isinstance(pos, int) or getattr(pos, "ndim", 1) == 0:
        pos = int(pos)
        positions = torch.full((tokens.shape[0], 1), pos, device=dev)
    else:
        pos = torch.as_tensor(pos).to(dev, torch.long)
        if pos.shape != (tokens.shape[0],):
            raise ValueError(f"decode_step: pos {tuple(pos.shape)} for "
                             f"{tokens.shape[0]} rows: one position a row")
        positions = pos[:, None]
    return _cache_step(cfg, params, cache, tokens, positions, pos)


def prefill_chunk(cfg, params, cache: dict, tokens: torch.Tensor,
                  pos: int):
    """A chunk of a prompt into the cache: tokens (B, T) at positions
    pos .. pos + T - 1, written into the cache IN PLACE; each attends to
    the cache's first pos + T keys through the flash kernel (the
    reference's ``kv_len`` branch). Returns (logits (B, T, V) f32,
    cache). The prompt in chunks gives the one-shot prefill's logits up
    to the order of sums."""
    _check_family(cfg)
    pos = int(pos)
    positions = torch.arange(pos, pos + tokens.shape[1],
                             device=params["embed"].device)[None].expand(
        tokens.shape[0], -1)
    return _cache_step(cfg, params, cache, tokens, positions, pos)
