"""Language models on the port (counterpart of the reference's
``src/repro/models/lm.py``): the dense, MoE, VLM, SSM (rwkv6), hybrid
(zamba2) and encoder-decoder (whisper) families.

The parameters keep the reference's layout: ``embed`` (V, d), the layer
stack ``blocks`` with a leading L axis on every leaf (a sparse FFN
weight is one ``SparseWeight`` with vals (L, ob, K, bm, bn) and idx
(L, ob, K); an MoE block's ``moe`` holds the f32 router (L, d, e) and
the experts (L, e, d, f) / (L, e, f, d)), ``final_norm``, ``head``
when the embeddings are not tied, ``shared`` (one dense block) for the
hybrid family and ``encoder`` (``blocks``, ``norm``) for the
encoder-decoder one. The layer loop is a Python loop over views of
layer l. A VLM is the dense family with patch embeddings in front of
the tokens; whisper's decoder blocks add cross-attention over the
encoder's output of the frames; zamba2 runs its one shared attention
block after every ``hybrid_attn_every``-th Mamba2 layer.

    init_params(cfg, generator)             -> params
    abstract_params(cfg)                    -> params on the meta device
    init_cache(cfg, batch, max_seq)         -> decode cache (zeros)
    forward(cfg, params, tokens, extra=)    -> (logits, aux)  prefill
    decode_step(cfg, params, cache, tokens, pos) -> (logits, cache)
    prefill_chunk(cfg, params, cache, tokens, pos) -> (logits, cache)
    fill_cross_kv(cfg, params, cache, frames)    -> cache     (whisper)
    loss_fn(cfg, params, batch, remat=)     -> (loss, metrics) training

``forward``, ``decode_step`` and ``prefill_chunk`` run where the
parameters are. ``decode_step`` takes one token a row, at one position
for the batch or one a row (continuous batching,
``runtime/scheduler.py``); ``prefill_chunk`` writes a chunk of T
tokens at positions pos .. pos + T - 1 into the KV cache (the
reference's ``kv_len`` branch; the dense and MoE families). An MoE
layer routes the tokens of one call together (capacity per call),
except in a step with one position a row, which routes each row alone
(``layers.moe``). The recurrent caches (rwkv6's token shifts and WKV
state, zamba2's conv and SSM states) carry a whole prompt: stepping it
through ``decode_step`` gives ``forward``'s logits up to the order of
f32 sums.

Training: ``loss_fn`` is the reference's: the hidden states, then a
cross entropy over sequence chunks (:func:`chunked_softmax_xent`, each
chunk checkpointed so neither the (B, T, V) f32 logits nor their log
softmax are stored), the MoE aux loss added at 0.01. ``forward``'s
``remat`` recomputes each block in the backward ("full") or keeps the
matmul outputs of each block ("dots"), with ``torch.utils.checkpoint``
(non-reentrant); the values are the same bits as "none".
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from repro_torch.core.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.layers import SparseWeight, tensor_from_numpy

LOGITS_MODES = ("full", "last", "hidden")
REMAT_MODES = ("none", "full", "dots")


#: the families the port runs, and the block each stacks
BLOCK_KINDS = {"dense": "dense", "vlm": "dense", "moe": "moe",
               "ssm": "rwkv", "hybrid": "mamba", "audio": "encdec"}
#: the recurrent leaves of the decode caches, each (L, B, ...): the
#: batch axis is 1
RECURRENT_LEAVES = ("x_prev_t", "x_prev_c", "wkv", "conv", "ssm")


def _check_family(cfg) -> None:
    if cfg.family not in BLOCK_KINDS:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is no LM family the port "
            f"runs ({sorted(BLOCK_KINDS)})")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_block(cfg, generator: torch.Generator,
                kind: Optional[str] = None) -> dict:
    """One block of ``kind`` (by default the family's), its leaves drawn
    in the reference's order."""
    kind = kind or BLOCK_KINDS[cfg.family]
    d = cfg.d_model
    ones = lambda: torch.ones((d,), dtype=torch.bfloat16,  # noqa: E731
                              device=generator.device)
    if kind == "rwkv":
        return {"ln1": ones(), "tmix": L.init_rwkv6(generator, cfg),
                "ln2": ones(), "cmix": L.init_rwkv_cmix(generator, cfg)}
    if kind == "mamba":
        return {"ln1": ones(), "mamba": L.init_mamba2(generator, cfg)}
    block = {"ln1": ones(), "attn": L.init_attention(generator, cfg)}
    if kind == "encdec":             # whisper's decoder block
        block["ln_c"] = ones()
        block["cross"] = L.init_attention(generator, cfg)
    block["ln2"] = ones()
    if kind == "moe":
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


def _init_blocks(cfg, generator: torch.Generator, kind: str,
                 n: int) -> dict:
    """A stack of n blocks of ``kind``: layer l's tree drawn (layer by
    layer, in the reference's order of leaves) and copied into slice l
    of a stack allocated once, so the peak holds the stack and one
    layer, not two copies of the stack."""
    first = _init_block(cfg, generator, kind)
    blocks = _empty_stack(first, n)
    _copy_into(_layer(blocks, 0), first)
    del first
    for l in range(1, n):
        _copy_into(_layer(blocks, l), _init_block(cfg, generator, kind))
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
    FFN, the recurrent families' f32 leaves); torch's numbers are not
    ``jax.random``'s."""
    _check_family(cfg)
    d = cfg.d_model
    ones = lambda: torch.ones((d,), dtype=torch.bfloat16,  # noqa: E731
                              device=generator.device)
    p = {
        "embed": L.dense_init(generator, (cfg.vocab_size, d), d),
        "blocks": _init_blocks(cfg, generator, BLOCK_KINDS[cfg.family],
                               cfg.n_layers),
        "final_norm": ones(),
    }
    if not cfg.tie_embeddings:
        p["head"] = L.dense_init(generator, (d, cfg.vocab_size), d)
    if cfg.family == "hybrid" and cfg.hybrid_attn_every:
        p["shared"] = _init_block(cfg, generator, "dense")
    if cfg.family == "audio":
        p["encoder"] = {"blocks": _init_blocks(cfg, generator, "dense",
                                               cfg.encoder_layers),
                        "norm": ones()}
    return p


class _MetaGenerator(torch.Generator):
    """A generator whose draws land on the meta device: shapes and
    dtypes, no storage, no numbers."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def abstract_params(cfg) -> dict:
    """:func:`init_params`'s tree on the meta device: every leaf's shape
    and dtype, nothing allocated (the dry run's; the reference's
    ``jax.eval_shape`` of its ``init_params``)."""
    return init_params(cfg, _MetaGenerator())


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


def attn_flags(cfg) -> list:
    """Per layer: whether the hybrid family's shared attention block runs
    after it ((l + 1) % hybrid_attn_every == 0); all False elsewhere."""
    every = cfg.hybrid_attn_every if cfg.family == "hybrid" else 0
    return [bool(every) and (l + 1) % every == 0
            for l in range(cfg.n_layers)]


def init_cache(cfg, batch: int, max_seq: int, *, device="cuda") -> dict:
    """Zeroed decode cache, the reference's leaves: kv (L, 2, B, S, KV,
    Dh) bf16 (dense, MoE, VLM; whisper also cross_kv (L, 2, B, Te, KV,
    Dh)); rwkv6: x_prev_t, x_prev_c (L, B, 1, d) bf16 and wkv (L, B, H,
    Dh, Dh) f32; zamba2: conv (L, B, W - 1, d_in + 2N) bf16, ssm (L, B,
    H, N, Dh) f32 and attn_kv (sites, 2, B, min(window, S), KV, Dh), a
    ring of the last keys for each shared-attention site."""
    _check_family(cfg)
    dev = resolve_device(device)
    bf, f32 = (dict(dtype=t, device=dev) for t in (torch.bfloat16,
                                                    torch.float32))
    n_l, d, kvh, dh = cfg.n_layers, cfg.d_model, cfg.kv_heads, cfg.head_dim
    f = cfg.family
    if f == "ssm":
        return {"x_prev_t": torch.zeros((n_l, batch, 1, d), **bf),
                "x_prev_c": torch.zeros((n_l, batch, 1, d), **bf),
                "wkv": torch.zeros((n_l, batch, cfg.n_heads, dh, dh), **f32)}
    if f == "hybrid":
        nh, hdh = L._mamba_heads(cfg)
        n = cfg.ssm_state
        ring = min(cfg.attn_window or max_seq, max_seq)
        sites = max(sum(attn_flags(cfg)), 1)
        return {"conv": torch.zeros((n_l, batch, cfg.ssm_conv - 1,
                                     cfg.ssm_expand * d + 2 * n), **bf),
                "ssm": torch.zeros((n_l, batch, nh, n, hdh), **f32),
                "attn_kv": torch.zeros((sites, 2, batch, ring, kvh, dh),
                                       **bf)}
    cache = {"kv": torch.zeros((n_l, 2, batch, max_seq, kvh, dh), **bf)}
    if f == "audio":
        cache["cross_kv"] = torch.zeros(
            (n_l, 2, batch, cfg.encoder_seq, kvh, dh), **bf)
    return cache


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


def rwkv_block(cfg, p, h: torch.Tensor, state: Optional[dict] = None):
    """One rwkv6 layer over h (B, T, d) from ``state`` ({"x_prev_t",
    "x_prev_c", "wkv"}, one layer's cache rows; None: zeros). Returns (h,
    the state after h)."""
    a, st = L.rwkv6_forward(
        p["tmix"], cfg, L.rms_norm(h, p["ln1"], cfg.norm_eps),
        state=None if state is None else {"x_prev": state["x_prev_t"],
                                          "wkv": state["wkv"]})
    h = h + a
    c, xc = L.rwkv_cmix(p["cmix"], L.rms_norm(h, p["ln2"], cfg.norm_eps),
                        x_prev=None if state is None else state["x_prev_c"])
    return h + c, {"x_prev_t": st["x_prev"], "x_prev_c": xc,
                   "wkv": st["wkv"]}


def mamba_block(cfg, p, h: torch.Tensor, state: Optional[dict] = None):
    """One Mamba2 layer over h (B, T, d) from ``state`` ({"conv", "ssm"},
    one layer's cache rows; None: zeros). Returns (h, the state after
    h)."""
    m, st = L.mamba2_forward(p["mamba"], cfg,
                             L.rms_norm(h, p["ln1"], cfg.norm_eps),
                             state=state)
    return h + m, st


def shared_attn_block(cfg, params, h: torch.Tensor,
                      positions: torch.Tensor) -> torch.Tensor:
    """zamba2's shared block over a whole sequence: windowed attention
    (``cfg.attn_window``) through the flash kernel, then the pruned
    FFN."""
    p = params["shared"]
    a, _ = L.attention(p["attn"], cfg, L.rms_norm(h, p["ln1"], cfg.norm_eps),
                       positions=positions, window=cfg.attn_window)
    return _mlp(cfg, p, h + a)[0]


def make_block_fn(cfg, positions: torch.Tensor,
                  enc_out: Optional[torch.Tensor] = None):
    """Per-layer block function ``(h, p) -> (h, aux)`` over the whole
    sequence from a zero state; aux is the MoE load-balance loss, 0
    otherwise. ``enc_out``: the encoder's output, which whisper's
    decoder blocks attend to."""
    _check_family(cfg)
    kind = BLOCK_KINDS[cfg.family]
    zero = torch.zeros((), dtype=torch.float32, device=positions.device)

    def block(h, p):
        if kind == "rwkv":
            return rwkv_block(cfg, p, h)[0], zero
        if kind == "mamba":
            return mamba_block(cfg, p, h)[0], zero
        a, _ = L.attention(p["attn"], cfg,
                           L.rms_norm(h, p["ln1"], cfg.norm_eps),
                           positions=positions, window=cfg.attn_window)
        h = h + a
        if kind == "encdec":
            h = h + L.cross_attention(
                p["cross"], cfg, L.rms_norm(h, p["ln_c"], cfg.norm_eps),
                enc_out)
        h, aux = _mlp(cfg, p, h)
        return h, zero if aux is None else aux

    return block


def make_pipeline_block_fn(cfg, shared_params, positions: torch.Tensor, *,
                           shared_at=None):
    """Block function ``(p, h) -> h`` for the stage pipeline (the
    reference's): p is one layer's parameters; zamba2's shared block runs
    after it where p carries a true ``"_attn_flag"``, a host-side int (no
    flag is read back from the card); the aux loss is dropped.
    ``shared_at(flag)``: the params (with "shared") that site's shared
    block runs on; by default ``shared_params`` at every site."""
    block = make_block_fn(cfg, positions)

    def fn(p, h):
        flag = p.get("_attn_flag") if isinstance(p, dict) else None
        if flag is not None:
            p = {k: v for k, v in p.items() if k != "_attn_flag"}
        h2, _ = block(h, p)
        if flag:
            h2 = shared_attn_block(
                cfg, shared_params if shared_at is None else shared_at(flag),
                h2, positions)
        return h2

    return fn


def encoder_block_fn(cfg, positions: torch.Tensor):
    """Whisper's encoder block ``(h, p) -> h``: non-causal attention
    (through the flash kernel), then the pruned FFN."""
    def block(h, p):
        a, _ = L.attention(p["attn"], cfg,
                           L.rms_norm(h, p["ln1"], cfg.norm_eps),
                           positions=positions, causal=False)
        return _mlp(cfg, p, h + a)[0]

    return block


def run_encoder(cfg, params, frames: torch.Tensor) -> torch.Tensor:
    """Whisper's encoder over frame embeddings (B, Te, d) (the
    reference's ``_run_encoder``): its blocks, then its norm."""
    b, te, _ = frames.shape
    block = encoder_block_fn(cfg, torch.arange(te, device=frames.device)[
        None].expand(b, te))
    h = frames
    for l in range(cfg.encoder_layers):
        h = block(h, _layer(params["encoder"]["blocks"], l))
    return L.rms_norm(h, params["encoder"]["norm"], cfg.norm_eps)


#: the extra input each family takes, in front of (vlm) or beside
#: (audio) the tokens
_EXTRA = {"vlm": "patches", "audio": "frames"}


def _extra_input(cfg, h: torch.Tensor, extra: Optional[dict]):
    """The family's extra input, (B, n, d) on h's device at h's dtype:
    a VLM's patch embeddings or whisper's frames (which the reference
    takes as given: its callers give bf16); None for every other family,
    which takes none."""
    extra = extra or {}
    key = _EXTRA.get(cfg.family)
    if key is None:
        if extra:
            raise ValueError(f"{cfg.name}: family {cfg.family!r} takes no "
                             f"extra inputs, got {sorted(extra)}")
        return None
    if set(extra) != {key}:
        raise ValueError(f"{cfg.name}: a {cfg.family} forward takes extra="
                         f"{{'{key}': (B, n, d)}}, got {sorted(extra)}")
    x = torch.as_tensor(extra[key]).to(h.device)
    if x.dim() != 3 or x.shape[0] != h.shape[0] or x.shape[2] != h.shape[2]:
        raise ValueError(f"{cfg.name}: {key} {tuple(x.shape)} for tokens "
                         f"of {tuple(h.shape[:2])}: expected (B, n, "
                         f"{h.shape[2]})")
    return x.to(h.dtype)


def _prefix(cfg, h: torch.Tensor, extra: Optional[dict]) -> torch.Tensor:
    """A VLM's patch embeddings (B, Vt, d), cast to h's dtype, in front
    of the token embeddings; whisper's frames are checked and go to the
    encoder, not in front; every other family takes no extra input."""
    x = _extra_input(cfg, h, extra)
    return torch.cat([x, h], dim=1) if cfg.family == "vlm" else h


#: the products whose outputs remat="dots" keeps: those without batch
#: dimensions (the reference's ``dots_with_no_batch_dims_saveable``)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat_wrap(fn, remat: str):
    """``fn`` run under activation checkpointing: "none" (as it is),
    "full" (nothing inside it kept for the backward: recomputed) or
    "dots" (the outputs of its unbatched matmuls kept, the rest
    recomputed)."""
    if remat not in REMAT_MODES:
        raise ValueError(f"remat={remat!r}: expected one of {REMAT_MODES}")
    if remat == "none":
        return fn
    kw = {} if remat == "full" else {"context_fn": functools.partial(
        ckpt.create_selective_checkpoint_contexts, _dots_policy)}
    return functools.partial(ckpt.checkpoint, fn, use_reentrant=False, **kw)


def forward(cfg, params, tokens: torch.Tensor, *,
            extra: Optional[dict] = None, logits_mode: str = "full",
            remat: str = "none"):
    """Full-sequence forward -> (logits | hidden, aux).

    extra: {"patches": (B, Vt, d)} for a VLM: the patch embeddings go in
    front of the tokens, positions run over Vt + T, and the output
    covers both; {"frames": (B, Te, d)} for whisper: the encoder runs
    over them and every decoder layer attends to its output. aux: the
    sum over layers of the MoE load-balance loss (0 for the other
    families).
    logits_mode: "full" (B, T, V) f32 | "last" (B, V) f32 | "hidden"
    (B, T, d).
    remat: "none" | "full" | "dots" (:func:`remat_wrap`, per layer with
    zamba2's shared block after it); the reference defaults to "full",
    which only changes what a backward recomputes, so the port's serving
    calls default to "none"."""
    if logits_mode not in LOGITS_MODES:
        raise ValueError(f"logits_mode={logits_mode!r}: expected one of "
                         f"{LOGITS_MODES}")
    with L.full_f32():
        h = _embed(cfg, params, tokens)
        enc_out = None
        if cfg.family == "audio":
            frames = _extra_input(cfg, h, extra)
            enc_out = run_encoder(cfg, params, frames)
        else:
            h = _prefix(cfg, h, extra)
        b, t, _ = h.shape
        positions = torch.arange(t, device=h.device)[None].expand(b, t)
        block = make_block_fn(cfg, positions, enc_out)

        def layer(h, l, shared):
            h, aux_l = block(h, _layer(params["blocks"], l))
            if shared:
                h = shared_attn_block(cfg, params, h, positions)
            return h, aux_l

        layer = remat_wrap(layer, remat)
        auxs = []
        for l, shared in enumerate(attn_flags(cfg)):
            h, aux_l = layer(h, l, shared)
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

def fill_cross_kv(cfg, params, cache: dict, frames) -> dict:
    """Run whisper's encoder over ``frames`` (B, Te, d) and write each
    decoder layer's cross-attention keys and values of its output into
    ``cache["cross_kv"]`` IN PLACE (enc @ wk, enc @ wv, no rope, as the
    reference's ``cross_attention`` computes them). Returns the cache.

    The reference never fills it: its ``init_cache`` zeroes cross_kv
    and its ``serve_lm`` draws frames but runs no encoder, so its decode
    attends over zeros. A deliberate difference (ROADMAP Queue 3 item
    4): the port's decode then attends over the encoder's output, as the
    reference's ``forward(extra={"frames"})`` does."""
    if cfg.family != "audio":
        raise ValueError(f"{cfg.name}: fill_cross_kv is for the audio "
                         f"family, not {cfg.family!r}")
    ckv = cache["cross_kv"]
    frames = torch.as_tensor(frames).to(ckv.device)
    if tuple(frames.shape) != (ckv.shape[2], ckv.shape[3], cfg.d_model):
        raise ValueError(f"{cfg.name}: frames {tuple(frames.shape)} for a "
                         f"cache of {ckv.shape[2]} rows and "
                         f"{ckv.shape[3]} encoder positions: expected "
                         f"({ckv.shape[2]}, {ckv.shape[3]}, {cfg.d_model})")
    with L.full_f32():
        enc = run_encoder(cfg, params, frames.to(torch.bfloat16))
        for l in range(cfg.n_layers):
            k, v = L.cross_kv(_layer(params["blocks"], l)["cross"], enc)
            ckv[l, 0].copy_(k)
            ckv[l, 1].copy_(v)
    return cache


def decode_block(cfg, p, h: torch.Tensor, kv: torch.Tensor,
                 positions: torch.Tensor, pos,
                 cross_kv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One attention layer of a step into the cache: p the layer's
    parameters, kv its cache (2, B, S, KV, Dh), written in place at
    ``pos`` (an int, or a (B,) tensor for a one-token step: one position
    a row); ``cross_kv`` (2, B, Te, KV, Dh): whisper's encoder keys and
    values, attended to after the self-attention. An MoE layer routes
    the call's B * T tokens together at an int ``pos``, and each row
    alone at a (B,) one (the reference's batcher vmaps its decode over
    the slots, so each slot is routed alone, with a capacity of its
    own)."""
    a, _ = L.attention(p["attn"], cfg, L.rms_norm(h, p["ln1"], cfg.norm_eps),
                       positions=positions, window=cfg.attn_window,
                       kv_cache=(kv[0], kv[1]), cache_pos=pos)
    h = h + a
    if "cross" in p:
        h = h + L.cross_decode(p["cross"], cfg,
                               L.rms_norm(h, p["ln_c"], cfg.norm_eps),
                               cross_kv[0], cross_kv[1])
    groups = h.shape[0] if isinstance(pos, torch.Tensor) else None
    return _mlp(cfg, p, h, groups)[0]


def ring_attn_block(cfg, params, h: torch.Tensor, positions: torch.Tensor,
                    kv: torch.Tensor, pos) -> torch.Tensor:
    """zamba2's shared block for one token against its ring of the last
    ``w`` keys, kv (2, B, w, KV, Dh) (the reference's
    ``_ring_attn_block``): k and v, roped at their absolute position, are
    written IN PLACE at slot pos % w; the query attends to the slots up
    to min(pos, w - 1), in plain torch (the reference has no kernel
    there). ``pos``: an int for the batch or a (B,) tensor, one a row."""
    p = params["shared"]
    pa = p["attn"]
    x = L.rms_norm(h, p["ln1"], cfg.norm_eps)
    b = x.shape[0]
    nh, kvh, dh = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    q = L.fdot("btd,dhk->bthk", x, pa["wq"]).to(x.dtype)
    k = L.fdot("btd,dhk->bthk", x, pa["wk"]).to(x.dtype)
    v = L.fdot("btd,dhk->bthk", x, pa["wv"]).to(x.dtype)
    if cfg.qk_norm:
        q = L.rms_norm(q, pa["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, pa["k_norm"], cfg.norm_eps)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    ck, cv = kv[0], kv[1]                              # (B, w, KV, Dh)
    w = ck.shape[1]
    slot = torch.arange(w, device=x.device)
    if isinstance(pos, torch.Tensor):                  # one position a row
        pos = pos.to(x.device).long()
        rows = torch.arange(b, device=x.device)
        ck[rows, pos % w] = k[:, 0].to(ck.dtype)
        cv[rows, pos % w] = v[:, 0].to(cv.dtype)
        valid = slot[None] <= pos.clamp(max=w - 1)[:, None]     # (B, w)
    else:
        ck[:, pos % w] = k[:, 0].to(ck.dtype)
        cv[:, pos % w] = v[:, 0].to(cv.dtype)
        valid = (slot <= min(pos, w - 1))[None]                  # (1, w)
    kk, vv = L._repeat_kv(ck, nh // kvh), L._repeat_kv(cv, nh // kvh)
    s = L.fdot("bqhd,bkhd->bhqk", q, kk) / math.sqrt(dh)
    s = s.masked_fill(~valid[:, None, None, :], -math.inf)
    o = L.fdot("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1).to(vv.dtype),
               vv).to(x.dtype)
    a = L.fdot("bthk,hkd->btd", o, pa["wo"]).to(x.dtype)
    return _mlp(cfg, p, h + a)[0]


def _cache_step(cfg, params, cache, tokens, positions, pos):
    with L.full_f32():
        h = _embed(cfg, params, tokens)
        ckv = cache.get("cross_kv")
        for l in range(cfg.n_layers):
            h = decode_block(cfg, _layer(params["blocks"], l), h,
                             cache["kv"][l], positions, pos,
                             None if ckv is None else ckv[l])
        return _logits(cfg, params, h), cache


def _state_step(cfg, params, cache, tokens, positions, pos):
    """A step of the recurrent families: each layer from its cache rows,
    its new state copied back IN PLACE; zamba2's shared block against
    its site's ring after the flagged layers."""
    rwkv = BLOCK_KINDS[cfg.family] == "rwkv"
    leaves = ("x_prev_t", "x_prev_c", "wkv") if rwkv else ("conv", "ssm")
    with L.full_f32():
        h = _embed(cfg, params, tokens)
        site = 0
        for l, shared in enumerate(attn_flags(cfg)):
            p = _layer(params["blocks"], l)
            state = {k: cache[k][l] for k in leaves}
            h, new = (rwkv_block if rwkv else mamba_block)(cfg, p, h, state)
            for k in leaves:
                cache[k][l].copy_(new[k])
            if shared:
                h = ring_attn_block(cfg, params, h, positions,
                                    cache["attn_kv"][site], pos)
                site += 1
        return _logits(cfg, params, h), cache


def decode_step(cfg, params, cache: dict, tokens: torch.Tensor, pos):
    """One-token decode. tokens: (B, 1); pos: the position, an int for
    every row, or a (B,) integer tensor (or array), one a row.

    Returns (logits (B, 1, V) f32, cache). The cache is updated IN PLACE
    and returned: the reference returns a new one. A step of T > 1
    tokens raises: the reference's ``decode_step`` ropes all T tokens
    at ``pos`` (its ``positions`` broadcast one position), which no
    caller wants; :func:`prefill_chunk` places them at pos .. pos+T-1.
    rwkv6 takes no position; zamba2's shared block takes it for its
    ring; whisper's decoder attends to ``cache["cross_kv"]``
    (:func:`fill_cross_kv` fills it)."""
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
    step = _state_step if BLOCK_KINDS[cfg.family] in ("rwkv", "mamba") \
        else _cache_step
    return step(cfg, params, cache, tokens, positions, pos)


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
    that chunk, not the reference's forward over the whole prompt. The
    SSM, hybrid and encoder-decoder families raise: the reference has
    no chunked prefill for them (ROADMAP Queue 1 item 8f)."""
    _check_family(cfg)
    if BLOCK_KINDS[cfg.family] not in ("dense", "moe"):
        raise NotImplementedError(
            f"{cfg.name}: prefill_chunk takes the dense and MoE families, "
            f"not {cfg.family!r}: ROADMAP Queue 1 item 8f")
    pos = int(pos)
    positions = torch.arange(pos, pos + tokens.shape[1],
                             device=params["embed"].device)[None].expand(
        tokens.shape[0], -1)
    return _cache_step(cfg, params, cache, tokens, positions, pos)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def chunked_softmax_xent(cfg, params, h: torch.Tensor, labels: torch.Tensor,
                         *, n_chunks: int = 16):
    """Cross entropy without keeping (B, T, V) logits: the sequence in
    ``n_chunks`` chunks (fewer where T does not divide), each chunk's
    logits, log softmax and picked labels under a checkpoint, so the
    backward recomputes them chunk by chunk. Labels < 0 are masked.
    Returns (sum of nll, number of labels counted), f32 scalars."""
    b, t, d = h.shape
    while t % n_chunks:
        n_chunks -= 1
    c = t // n_chunks

    def chunk(hh, ll):
        logp = F.log_softmax(_logits(cfg, params, hh), dim=-1)
        nll = -torch.gather(logp, -1, ll.clamp_min(0)[..., None])[..., 0]
        mask = (ll >= 0).float()
        return (nll * mask).sum(), mask.sum()

    s = n = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n_chunks):
        cs, cn = ckpt.checkpoint(chunk, h[:, i * c:(i + 1) * c],
                                 labels[:, i * c:(i + 1) * c],
                                 use_reentrant=False)
        s, n = s + cs, n + cn
    return s, n


def loss_fn(cfg, params, batch: dict, *, remat: str = "full"):
    """batch: {"tokens": (B, T), "labels": (B, T)} and, by family,
    "patches" (B, Vt, d) (VLM: its positions carry no loss) or "frames"
    (B, Te, d) (whisper). Returns (loss + 0.01 * aux, {"loss", "aux"}):
    the mean nll over labels >= 0 and the MoE load-balance loss."""
    dev = params["embed"].device
    extra = {k: batch[k] for k in ("frames", "patches") if k in batch}
    labels = torch.as_tensor(batch["labels"]).to(dev).long()
    with L.full_f32():
        h, aux = forward(cfg, params, torch.as_tensor(batch["tokens"]),
                         extra=extra or None, remat=remat,
                         logits_mode="hidden")
        if cfg.family == "vlm":                # the image prefix: no loss
            h = h[:, -labels.shape[1]:]
        s, n = chunked_softmax_xent(cfg, params, h, labels)
        loss = s / n.clamp_min(1.0)
        return loss + 0.01 * aux, {"loss": loss, "aux": aux}
