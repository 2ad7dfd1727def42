"""Blockwise causal attention (flash style): the LM prefill's attention.

``flash_attention`` launches the CUDA kernel in
``csrc/flash_attention.cu``, which replaces the reference's
``kernels/flash_attention.py::flash_attention_pallas``, in the variant
that :func:`variant` names: "mma" (tensor cores) for bf16, "simt" (f32
FMAs on the CUDA cores) for f32. ``flash_attention_torch`` is the plain
PyTorch version of the same function: the CPU path and the check both
variants are held to on the card.

Both compute what the Pallas kernel computes: scores in f32 scaled by
1/sqrt(D) after the product, masked scores at ``NEG_INF``, an online
softmax over key tiles with (m, l, acc) in f32, p kept in f32 (the
reference's XLA ``blockwise_attention`` rounds it to bf16 before the PV
product; the Pallas kernel does not), ``l`` floored at 1e-20, the
output in q's dtype. Unlike the Pallas kernel they take any lengths:
the tail of the last tile is masked, not asserted away. The mma
variant's P V product keeps p's f32 value as two bf16 terms, p_hi =
bf16(p) and p_lo = bf16(p - p_hi) (p to ~2^-17 relative), so it
computes the same function to far below the output's bf16 rounding.

Training: :class:`FlashAttentionFn` wraps the kernel for autograd. Its
backward is the plain :func:`flash_attention_backward_torch` (the
reference's Pallas kernel has no backward either), which recomputes the
probabilities in f32 under the same mask, a query chunk at a time.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
BLOCK_Q = 64        # the CUDA kernel's query tile
BLOCK_K = 64        # and key tile
#: the largest head the mma variant takes (the kernel pads D to a
#: multiple of 16 inside shared memory; the wrapper pads none, a copy the
#: plain version does not make); the Pallas kernel's blocks span the whole
#: head, so it, and the simt variant, take any D
MMA_MAX_D = 256


def variant(dtype: torch.dtype, d: int) -> str:
    """The kernel variant for q, k, v of ``dtype`` and head size ``d``:
    "mma" (tensor cores) for bf16 with d <= MMA_MAX_D, else "simt" (f32
    at any d; bf16 past MMA_MAX_D)."""
    return "mma" if dtype == torch.bfloat16 and d <= MMA_MAX_D else "simt"


def check_shapes(q_shape, k_shape, v_shape, *, window: int = 0,
                 q_offset: int = 0) -> None:
    """The wrapper's shape check, without a card: returns if the kernel
    takes these shapes, else ValueError. It takes any head size D >= 1
    and any lengths (the Pallas kernel takes any D, and lengths its
    blocks divide); it refuses shapes that do not fit together, empty
    ones, a negative window or offset, and more than 65535 query tiles."""
    if len(q_shape) != 4:
        raise ValueError(f"flash_attention: q {tuple(q_shape)} is not "
                         f"(B, T, H, D)")
    b, tq, h, d = q_shape
    tk = k_shape[1] if len(k_shape) == 4 else 0
    if tuple(k_shape) != (b, tk, h, d) or tuple(v_shape) != tuple(k_shape) \
            or min(b, h, d, tq, tk) < 1 or -(-tq // BLOCK_Q) > 65535:
        raise ValueError(f"flash_attention: q {tuple(q_shape)}, k "
                         f"{tuple(k_shape)}, v {tuple(v_shape)}: needs "
                         f"(B, T, H, D) with D >= 1, T >= 1")
    if window < 0 or q_offset < 0:
        raise ValueError(f"flash_attention: window={window}, q_offset="
                         f"{q_offset} must be >= 0")


def kv_tile_range(q_first: int, q_last: int, tk: int, *, causal: bool,
                  window: int) -> tuple[int, int]:
    """[begin, end) of the key tiles that some query at absolute
    position q_first..q_last can see; the others hold only masked keys
    and are skipped (for those, the Pallas kernel's masked steps leave
    (m, l, acc) as they were)."""
    kv_end = min(tk, q_last + 1) if causal else tk
    kv_begin = max(0, q_first - window + 1) if window > 0 else 0
    begin = kv_begin // BLOCK_K
    end = -(-kv_end // BLOCK_K) if kv_begin < kv_end else begin
    return begin, end


def flash_attention_torch(q, k, v, *, causal: bool = True, window: int = 0,
                          q_offset: int = 0) -> torch.Tensor:
    """q: (B, Tq, H, D); k, v: (B, Tk, H, D), GQA already expanded; any
    Tq, Tk, any D. Query t sits at absolute position ``q_offset + t``.
    Works on one (BLOCK_Q x BLOCK_K) score tile at a time, in the
    kernel's tiling: no (Tq, Tk) tensor."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    qf = q.permute(0, 2, 1, 3).float()                     # (B, H, Tq, D)
    kf = k.permute(0, 2, 1, 3).float()
    vf = v.permute(0, 2, 1, 3).float()
    out = torch.empty((b, h, tq, d), dtype=q.dtype, device=q.device)
    for q0 in range(0, tq, BLOCK_Q):
        qi = qf[:, :, q0:q0 + BLOCK_Q]
        n = qi.shape[2]
        qpos = q_offset + torch.arange(q0, q0 + n, device=q.device)
        m = torch.full((b, h, n), NEG_INF, device=q.device)
        l = torch.zeros((b, h, n), device=q.device)
        acc = torch.zeros((b, h, n, d), device=q.device)
        t_begin, t_end = kv_tile_range(q_offset + q0, q_offset + q0 + n - 1,
                                       tk, causal=causal, window=window)
        for k0 in range(t_begin * BLOCK_K, t_end * BLOCK_K, BLOCK_K):
            kpos = torch.arange(k0, min(k0 + BLOCK_K, tk), device=q.device)
            s = (qi @ kf[:, :, kpos].transpose(-1, -2)) * scale
            mask = torch.ones((n, kpos.numel()), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask &= kpos[None, :] <= qpos[:, None]
            if window:
                mask &= kpos[None, :] > qpos[:, None] - window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + p @ vf[:, :, kpos]
            m = m_new
        out[:, :, q0:q0 + n] = (acc / l.clamp_min(1e-20)[..., None]).to(
            q.dtype)
    return out.permute(0, 2, 1, 3).contiguous()


#: query rows the plain backward takes at a time: (B, H, 512, Tk) f32
#: score tensors, not (B, H, Tq, Tk)
BWD_CHUNK = 512


def flash_attention_backward_torch(q, k, v, dout, causal: bool = True,
                                   window: int = 0, q_offset: int = 0):
    """The gradients (dq, dk, dv) of :func:`flash_attention_torch` for
    the output gradient ``dout`` (q's layout). The probabilities are
    recomputed in f32 under the forward's mask, BWD_CHUNK query rows at a
    time over the keys they can see (``kv_tile_range``):
    p = softmax(q k^T / sqrt(D)), dp = dout v^T, ds = p (dp - rowsum(p
    dp)), dq = ds k / sqrt(D), dk = ds^T q / sqrt(D), dv = p^T dout.
    Products in f32; dk and dv summed over the chunks in order (no
    atomics: the same bits every run); each gradient in its input's
    dtype."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    qf = q.permute(0, 2, 1, 3).float()                     # (B, H, Tq, D)
    kf = k.permute(0, 2, 1, 3).float()
    vf = v.permute(0, 2, 1, 3).float()
    dof = dout.permute(0, 2, 1, 3).float()
    dq = torch.zeros((b, h, tq, d), device=q.device)
    dk = torch.zeros((b, h, tk, d), device=q.device)
    dv = torch.zeros((b, h, tk, d), device=q.device)
    for q0 in range(0, tq, BWD_CHUNK):
        n = min(BWD_CHUNK, tq - q0)
        t_begin, t_end = kv_tile_range(q_offset + q0, q_offset + q0 + n - 1,
                                       tk, causal=causal, window=window)
        k0, k1 = t_begin * BLOCK_K, min(t_end * BLOCK_K, tk)
        if k0 >= k1:
            continue
        qpos = q_offset + torch.arange(q0, q0 + n, device=q.device)
        kpos = torch.arange(k0, k1, device=q.device)
        mask = torch.ones((n, k1 - k0), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window:
            mask &= kpos[None, :] > qpos[:, None] - window
        qi, doi = qf[:, :, q0:q0 + n], dof[:, :, q0:q0 + n]
        kk, vv = kf[:, :, k0:k1], vf[:, :, k0:k1]
        s = torch.where(mask, (qi @ kk.transpose(-1, -2)) * scale, NEG_INF)
        p = torch.where(mask, torch.exp(s - s.amax(dim=-1, keepdim=True)),
                        0.0)
        p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
        dp = doi @ vv.transpose(-1, -2)
        ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
        dq[:, :, q0:q0 + n] = (ds @ kk) * scale
        dk[:, :, k0:k1] += (ds.transpose(-1, -2) @ qi) * scale
        dv[:, :, k0:k1] += p.transpose(-1, -2) @ doi
    return tuple(g.permute(0, 2, 1, 3).to(t.dtype).contiguous()
                 for g, t in ((dq, q), (dk, k), (dv, v)))


class FlashAttentionFn(torch.autograd.Function):
    """The CUDA kernel under autograd: forward :func:`flash_attention`
    (launches or raises), backward :func:`flash_attention_backward_torch`.
    q, k, v are saved after the launch, so a recomputation (activation
    checkpointing) launches the kernel again."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        out = flash_attention(q, k, v, causal=causal, window=window,
                              q_offset=q_offset)
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        grads = flash_attention_backward_torch(q, k, v, dout, *ctx.mask)
        return tuple(g if need else None for g, need in zip(
            grads, ctx.needs_input_grad[:3])) + (None, None, None)


_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("flash_attention")
    fns = {}
    for dtype, fn in ((torch.float32, lib.flash_attention_f32),
                      (torch.bfloat16, lib.flash_attention_bf16)):
        fn.argtypes = [_P] * 4 + [_I] * 8 + [ctypes.c_float, _I, _P]
        fn.restype = _I
        fns[dtype] = fn
    return lib, fns


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """The CUDA kernel: same function and arguments as
    :func:`flash_attention_torch`, with q, k, v of one dtype (f32 or
    bf16), contiguous on one CUDA device, any D, in the variant
    :func:`variant` names. Raises on anything the kernel does
    not take, and if the launch fails; it never falls back to the plain
    version or to the other variant."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be on "
                             f"{q.device} (a CUDA device), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if t.dtype != q.dtype or t.dtype not in (torch.float32,
                                                 torch.bfloat16):
            raise ValueError(f"flash_attention: q, k, v must all be f32 or "
                             f"all bf16; got {q.dtype}, {k.dtype}, "
                             f"{v.dtype}")
    check_shapes(q.shape, k.shape, v.shape, window=window,
                 q_offset=q_offset)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    lib, fns = _kernel()
    var = variant(q.dtype, d)
    if var == "mma":
        q, k, v = (_build.aligned16(t) for t in (q, k, v))
    out = torch.empty_like(q)
    err = fns[q.dtype](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), b, h, tq, tk, d, int(bool(causal)),
                       window, q_offset, 1.0 / math.sqrt(d),
                       _build.VARIANT_CODES[var],
                       torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "flash_attention", err)
    _build.LAUNCHES["flash_attention"] += 1
    _build.VARIANT_LAUNCHES[("flash_attention", var)] += 1
    return out
