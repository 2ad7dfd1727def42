"""Language models on the port (counterpart of the reference's
``src/repro/models/lm.py``): the dense, MoE and VLM families.

The parameters keep the reference's layout: ``embed`` (V, d), the layer
stack ``blocks`` with a leading L axis on every leaf (a sparse FFN
weight is one ``SparseWeight`` with vals (L, ob, K, bm, bn) and idx
(L, ob, K); an MoE block's ``moe`` holds the f32 router (L, d, e) and
the experts (L, e, d, f) / (L, e, f, d)), ``final_norm``, and ``head``
when the embeddings are not tied. The layer loop is a Python loop over
views of layer l. A VLM is the dense family with patch embeddings in
front of the tokens.

    init_params(cfg, generator)             -> params
    init_cache(cfg, batch, max_seq)         -> decode cache (zeros)
    forward(cfg, params, tokens, extra=)    -> (logits, aux)  prefill
    decode_step(cfg, params, cache, tokens, pos) -> (logits, cache)
    prefill_chunk(cfg, params, cache, tokens, pos) -> (logits, cache)

``forward``, ``decode_step`` and ``prefill_chunk`` run where the
parameters are. ``decode_step`` takes one token a row, at one position
for the batch or one a row (continuous batching,
``runtime/scheduler.py``); ``prefill_chunk`` writes a chunk of T
tokens at positions pos .. pos + T - 1 into the cache (the reference's
``kv_len`` branch). An MoE layer routes the tokens of one call together
(capacity per call), except in a step with one position a row, which
routes each row alone (``layers.moe``). The SSM, hybrid and
encoder-decoder families raise, naming their ROADMAP item
(``configs/base.py::UNPORTED_LM_FAMILIES``); ``loss_fn`` and remat are
not ported (ROADMAP Queue 1 item 8e, training).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import UNPORTED_LM_FAMILIES
from repro_torch.core.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.layers import SparseWeight, tensor_from_numpy

LOGITS_MODES = ("full", "last", "hidden")


#: the families the port runs, and the block each stacks
BLOCK_KINDS = {"dense": "dense", "vlm": "dense", "moe": "moe"}


def _check_family(cfg) -> None:
    if cfg.family not in BLOCK_KINDS:
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
    ones = lambda: torch.ones((d,), dtype=torch.bfloat16,  # noqa: E731
                              device=generator.device)
    block = {"ln1": ones(), "attn": L.init_attention(generator, cfg),
             "ln2": ones()}
    if BLOCK_KINDS[cfg.family] == "moe":
        block["moe"] = L.init_moe(generator, cfg)
    else:
        sp = cfg.sparsity if cfg.sparsity.enabled else None
        block["ffn"] = L.init_ffn(generator, d, cfg.d_ff, sp)
    return block


def _empty_stack(tree, n: int):
    """An uninitialised tree like ``tree`` with a leading axis of n."""
    if isinstance(tree, dict):
        return {k: _empty_stack(v, n) for k, v in tree.items()}
    if isinstance(tree, SparseWeight):
        return SparseWeight(_empty_stack(tree.vals, n),
                            _empty_stack(tree.idx, n), tree.d_in)
    return tree.new_empty((n,) + tuple(tree.shape))


def _copy_into(dst, src) -> None:
    """Copy a tree into views of the same structure (``_layer``'s)."""
    if isinstance(src, dict):
        for k, v in src.items():
            _copy_into(dst[k], v)
    elif isinstance(src, SparseWeight):
        if src.d_in != dst.d_in:
            raise ValueError(f"sparse weight d_in {src.d_in} != {dst.d_in}")
        dst.vals.copy_(src.vals)
        dst.idx.copy_(src.idx)
    else:
        dst.copy_(src)


def _init_blocks(cfg, generator: torch.Generator) -> dict:
    """The layer stack: layer l's tree drawn (layer by layer, in the
    reference's order of leaves) and copied into slice l of a stack
    allocated once, so the peak holds the stack and one layer, not two
    copies of the stack."""
    first = _init_block(cfg, generator)
    blocks = _empty_stack(first, cfg.n_layers)
    _copy_into(_layer(blocks, 0), first)
    del first
    for l in range(1, cfg.n_layers):
        _copy_into(_layer(blocks, l), _init_block(cfg, generator))
    return blocks


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
        "blocks": _init_blocks(cfg, generator),
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
    """Zeroed decode cache: kv (L, 2, B, S, KV, Dh) bf16 (every family
    the port runs)."""
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


def _mlp(cfg, p, h: torch.Tensor, groups=None):
    """The block's second half: h + ffn or h + moe of the normed h.
    Returns (h, aux); aux is None without experts. ``groups``: MoE
    routing groups (``layers.moe``)."""
    hn = L.rms_norm(h, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        mo, aux = L.moe(p["moe"], cfg, hn, groups=groups)
        return h + mo, aux
    return h + L.ffn(p["ffn"], hn), None


def make_block_fn(cfg, positions: torch.Tensor):
    """Per-layer block function ``(h, p) -> (h, aux)`` over the whole
    sequence; aux is the MoE load-balance loss, 0 for a dense block."""
    _check_family(cfg)
    zero = torch.zeros((), dtype=torch.float32, device=positions.device)

    def block(h, p):
        a, _ = L.attention(p["attn"], cfg,
                           L.rms_norm(h, p["ln1"], cfg.norm_eps),
                           positions=positions, window=cfg.attn_window)
        h, aux = _mlp(cfg, p, h + a)
        return h, zero if aux is None else aux

    return block


def _prefix(cfg, h: torch.Tensor, extra: Optional[dict]) -> torch.Tensor:
    """A VLM's patch embeddings (B, Vt, d), cast to h's dtype, in front
    of the token embeddings; every other family takes no extra input."""
    extra = extra or {}
    if cfg.family != "vlm":
        if extra:
            raise ValueError(f"{cfg.name}: family {cfg.family!r} takes no "
                             f"extra inputs, got {sorted(extra)}")
        return h
    if set(extra) != {"patches"}:
        raise ValueError(f"{cfg.name}: a VLM forward takes extra="
                         f"{{'patches': (B, Vt, d)}}, got {sorted(extra)}")
    patches = torch.as_tensor(extra["patches"]).to(h.device)
    if patches.dim() != 3 or patches.shape[0] != h.shape[0] or \
            patches.shape[2] != h.shape[2]:
        raise ValueError(f"{cfg.name}: patches {tuple(patches.shape)} for "
                         f"tokens of {tuple(h.shape[:2])}: expected (B, Vt, "
                         f"{h.shape[2]})")
    return torch.cat([patches.to(h.dtype), h], dim=1)


def forward(cfg, params, tokens: torch.Tensor, *,
            extra: Optional[dict] = None, logits_mode: str = "full"):
    """Full-sequence forward -> (logits | hidden, aux).

    extra: {"patches": (B, Vt, d)} for a VLM: the patch embeddings go in
    front of the tokens, positions run over Vt + T, and the output
    covers both. aux: the sum over layers of the MoE load-balance loss
    (0 for the dense family).
    logits_mode: "full" (B, T, V) f32 | "last" (B, V) f32 | "hidden"
    (B, T, d)."""
    if logits_mode not in LOGITS_MODES:
        raise ValueError(f"logits_mode={logits_mode!r}: expected one of "
                         f"{LOGITS_MODES}")
    with L.full_f32():
        h = _prefix(cfg, _embed(cfg, params, tokens), extra)
        b, t, _ = h.shape
        positions = torch.arange(t, device=h.device)[None].expand(b, t)
        block = make_block_fn(cfg, positions)
        auxs = []
        for l in range(cfg.n_layers):
            h, aux_l = block(h, _layer(params["blocks"], l))
            auxs.append(aux_l)
        aux = torch.stack(auxs).sum()
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
    or a (B,) tensor for a one-token step: one position a row). An MoE
    layer routes the call's B * T tokens together at an int ``pos``,
    and each row alone at a (B,) one (the reference's batcher vmaps its
    decode over the slots, so each slot is routed alone, with a
    capacity of its own)."""
    a, _ = L.attention(p["attn"], cfg, L.rms_norm(h, p["ln1"], cfg.norm_eps),
                       positions=positions, window=cfg.attn_window,
                       kv_cache=(kv[0], kv[1]), cache_pos=pos)
    groups = h.shape[0] if isinstance(pos, torch.Tensor) else None
    return _mlp(cfg, p, h + a, groups)[0]


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
    cache). For the dense family the prompt in chunks gives the one-shot
    prefill's logits up to the order of sums. Not for MoE: a chunk's B *
    T tokens are routed together, with a capacity of their own, so where
    an expert overflows, the chunks drop other assignments than the
    one-shot forward does; a chunk equals the reference's layers run on
    that chunk, not the reference's forward over the whole prompt."""
    _check_family(cfg)
    pos = int(pos)
    positions = torch.arange(pos, pos + tokens.shape[1],
                             device=params["embed"].device)[None].expand(
        tokens.shape[0], -1)
    return _cache_step(cfg, params, cache, tokens, positions, pos)
