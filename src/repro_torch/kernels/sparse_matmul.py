"""Gathered block-sparse matmul: the pruned classifier of ResNet-50 and
the pruned FFN of the LMs (64 x 64 blocks for SmolLM-360M, 128 x 128
for Mistral-Nemo-12B, Qwen3-32B and Granite-20B).

``sparse_matmul`` launches the CUDA kernel in ``csrc/sparse_matmul.cu``,
which replaces the reference's ``kernels/sparse_matmul.py::
sparse_matmul_pallas``, in the variant that :func:`variant` names:
"gemv" for at most ``SIMT_MAX_M`` rows (the f32 classifier, the LM
decode; one block per 8 output columns), "mma" (tensor
cores) for more bf16 rows with block sides that are multiples of 8 (the
LM prefill), "simt" (CUDA cores) otherwise. Every variant takes blocks
of any size, as the Pallas kernel does. ``sparse_matmul_torch`` is
the plain PyTorch version of the same function: the CPU path and the
check every variant is held to on the card.

Stored weights: bf16 vals, int8 codes (gemv, simt; the caller applies
the scale to the output, as the reference does outside its Pallas
kernel, ``ops.py:135-144``) or f32 vals (simt).

Training: :class:`SparseMatmulFn` wraps the kernel for autograd. Its
backward is the plain :func:`sparse_matmul_backward_torch` (the
reference has no backward kernel: it trains through its XLA twin), which
keeps the weight sparse and sums in a fixed order, so a step gives the
same bits every time.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np

import torch

from repro_torch.kernels import _build


def sparse_matmul_torch(x, vals, idx) -> torch.Tensor:
    """y[m, j*bn:+bn] = sum_k x[m, idx[j,k]*bm:+bm] @ vals[j,k].

    x: (M, d_in); vals: (ob, K, bm, bn) bf16, f32 or int8 codes; idx:
    (ob, K). f32 accumulation (on the CPU, f64 rounded once to f32:
    ``_build.plain_acc``), output in x.dtype. Each step of the K loop
    gathers one input block per output block column, (M, ob, bm): the
    size of the output."""
    m, d_in = x.shape
    ob, n_k, bm, bn = vals.shape
    ad = _build.plain_acc(x)
    xb = x.reshape(m, d_in // bm, bm)
    acc = torch.zeros((m, ob, bn), dtype=ad, device=x.device)
    for l in range(n_k):
        xg = xb[:, idx[:, l].long()]                          # (M, ob, bm)
        acc += torch.einsum("tjb,jbn->tjn", xg.to(ad), vals[:, l].to(ad))
    return acc.reshape(m, ob * bn).float().to(x.dtype)


def transposed_index(idx: torch.Tensor, n_in: int):
    """For each of the n_in input blocks, the (j, k) pairs with
    idx[j, k] == it, in ascending j: (jt, kt, valid), each (n_in, R) with
    R the most pairs any input block has (at least 1); padded slots hold
    (0, 0) and valid False. Built on the host once per weight (a read
    of idx back, the first time) and kept on idx's base tensor, keyed by
    the view's offset and shape and idx's version."""
    base = idx if idx._base is None else idx._base
    key = (idx.storage_offset(), tuple(idx.shape), n_in, idx._version)
    cache = getattr(base, "_repro_transposed", None)
    if cache is None:
        cache = {}
        base._repro_transposed = cache
    if key not in cache:
        ids = idx.cpu().numpy()
        pairs = [[] for _ in range(n_in)]
        for j in range(ids.shape[0]):
            for k in range(ids.shape[1]):
                pairs[int(ids[j, k])].append((j, k))
        r = max(1, max(len(p) for p in pairs))
        jt = np.zeros((n_in, r), np.int64)
        kt = np.zeros((n_in, r), np.int64)
        valid = np.zeros((n_in, r), bool)
        for i, pr in enumerate(pairs):
            for c, (j, k) in enumerate(pr):
                jt[i, c], kt[i, c], valid[i, c] = j, k, True
        cache[key] = tuple(torch.from_numpy(a).to(idx.device)
                           for a in (jt, kt, valid))
    return cache[key]


def sparse_matmul_backward_torch(x, vals, idx, dy):
    """The gradients of :func:`sparse_matmul_torch`: (dx, dvals) for
    y = x @ W and its output gradient dy (M, ob * bn); idx gets none.

    dvals[j, k] = x[:, idx[j,k]*bm:+bm]^T @ dy[:, j*bn:+bn] and dx the
    transposed block product: input block i sums dy[:, j-block] @
    vals[j, k]^T over the (j, k) that read it (:func:`transposed_index`),
    in ascending j. Sums in f32 (f64 on the CPU, rounded once, as the
    forward: ``_build.plain_acc``); dx in x's dtype, dvals in vals'. No
    dense (d_in, d_out) weight, no scatter-add and no atomics: each
    output element is summed in one fixed order."""
    m, d_in = x.shape
    ob, n_k, bm, bn = vals.shape
    n_in = d_in // bm
    ad = _build.plain_acc(x)
    xb = x.reshape(m, n_in, bm).to(ad)
    dyb = dy.reshape(m, ob, bn).to(ad)
    dvals = torch.empty(vals.shape, dtype=vals.dtype, device=vals.device)
    for l in range(n_k):
        xg = xb[:, idx[:, l].long()]                          # (M, ob, bm)
        dvals[:, l] = torch.einsum("tjb,tjn->jbn", xg, dyb).to(vals.dtype)
    del xb
    jt, kt, valid = transposed_index(idx, n_in)
    vf = vals.to(ad)
    dx = torch.zeros((m, n_in, bm), dtype=ad, device=x.device)
    for r in range(jt.shape[1]):
        w = torch.where(valid[:, r, None, None], vf[jt[:, r], kt[:, r]], 0.0)
        dx += torch.einsum("tin,ibn->tib", dyb[:, jt[:, r]], w)
    return dx.reshape(m, d_in).float().to(x.dtype), dvals


class SparseMatmulFn(torch.autograd.Function):
    """The CUDA kernel under autograd: forward :func:`sparse_matmul`
    (launches or raises), backward :func:`sparse_matmul_backward_torch`.
    Its inputs are saved after the launch, so a recomputation (activation
    checkpointing) launches the kernel again."""

    @staticmethod
    def forward(ctx, x, vals, idx):
        y = sparse_matmul(x, vals, idx)
        ctx.save_for_backward(x, vals, idx)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, vals, idx = ctx.saved_tensors
        dx, dvals = sparse_matmul_backward_torch(x, vals, idx,
                                                 dy.contiguous())
        return (dx if ctx.needs_input_grad[0] else None,
                dvals if ctx.needs_input_grad[1] else None, None)


SIMT_MAX_M = 8     # rows up to which the gemv variant runs (decode)
SUB_BLOCK = 64     # simt and mma walk a block as 64 x 64 pieces (csrc)


def variant(dtype: torch.dtype, m: int, bm: int, bn: int,
            w_dtype=torch.bfloat16) -> str:
    """The kernel variant for x of ``dtype`` with ``m`` rows and (bm, bn)
    weight blocks stored as ``w_dtype``: "gemv" for m <= SIMT_MAX_M
    (f32 or bf16 x, bf16 or int8 blocks of any size); "mma" for bf16 x
    and bf16 blocks whose sides are multiples of 8 (the mma.m16n8k16
    tiles, a ragged 8 rows zero-filled to 16); else "simt" (any side,
    e.g. the classifier's 125 at SparsityConfig's default; f32 weights
    always)."""
    if w_dtype == torch.float32:
        return "simt"
    if m <= SIMT_MAX_M:
        return "gemv"
    if dtype == torch.bfloat16 and w_dtype == torch.bfloat16 and \
            bm % 8 == 0 and bn % 8 == 0:
        return "mma"
    return "simt"


GEMV_COLS = 8          # output columns a gemv block owns (csrc)


def gemv_grid(ob: int, bn: int) -> tuple[int, int]:
    """The gemv variant's grid: one block per GEMV_COLS output columns of
    each of the ob block columns, every weight row in each block."""
    return -(-bn // GEMV_COLS), ob


def gemv_threads(rows: int, bn: int) -> int:
    """The gemv block's threads for ``rows`` = K * bm weight rows, as the
    kernel picks them: about two rows a thread where a row's 8 columns
    are one 16-byte load (bn % 8 == 0), one row a thread otherwise; 64,
    128 or 256. Thread t sums rows t, t + threads, ..."""
    want = -(-rows // 2) if bn % 8 == 0 else rows
    return 64 if want <= 64 else 128 if want <= 128 else 256


_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("sparse_matmul")
    fns = {}
    for dtype, fn in ((torch.float32, lib.sparse_matmul_f32),
                      (torch.bfloat16, lib.sparse_matmul_bf16)):
        fn.argtypes = [_P] * 4 + [_I] * 8 + [_P]
        fn.restype = _I
        fns[dtype] = fn
    return lib, fns


def check_shapes(x_shape, vals_shape, idx_shape) -> None:
    """The wrapper's shape check, without a card: returns if the kernel
    takes these shapes, else ValueError. It takes every block shape the
    Pallas kernel takes (its assert: bm divides d_in; any bn, any M),
    and refuses only shapes that do not fit together and sizes past the
    32-bit offsets and the grid (M * d_in < 2^31, ob * ceil(bn / 64) <=
    65535)."""
    if len(x_shape) != 2 or len(vals_shape) != 4:
        raise ValueError(f"sparse_matmul: needs x (M, d_in) and vals (ob, "
                         f"K, bm, bn); got {tuple(x_shape)}, "
                         f"{tuple(vals_shape)}")
    m, d_in = x_shape
    ob, n_k, bm, bn = vals_shape
    if bm < 1 or bn < 1 or d_in % bm or tuple(idx_shape) != (ob, n_k) \
            or m * d_in >= 2 ** 31 or ob * -(-bn // SUB_BLOCK) > 65535:
        raise ValueError(f"sparse_matmul: vals {tuple(vals_shape)} / idx "
                         f"{tuple(idx_shape)} do not fit x {tuple(x_shape)} "
                         f"(bm must divide d_in)")


def sparse_matmul(x, vals, idx) -> torch.Tensor:
    """The CUDA kernel: same function and arguments as
    :func:`sparse_matmul_torch`, with x f32 or bf16 and vals bf16, int8
    or f32 on a CUDA device, in the variant :func:`variant` names.
    Raises on
    anything the kernel does not take, and if the launch fails; it never
    falls back to the plain version or to another variant."""
    for name, t in (("x", x), ("vals", vals), ("idx", idx)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"sparse_matmul: {name} must be on {x.device} "
                             f"(a CUDA device), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"sparse_matmul: {name} must be contiguous")
    if x.dtype not in (torch.float32, torch.bfloat16) or vals.dtype not in (
            torch.bfloat16, torch.int8, torch.float32) \
            or idx.dtype != torch.int32:
        raise ValueError(f"sparse_matmul: needs x f32/bf16, vals bf16/int8/"
                         f"f32, idx int32; got {x.dtype}, {vals.dtype}, "
                         f"{idx.dtype}")
    check_shapes(x.shape, vals.shape, idx.shape)
    m, d_in = x.shape
    ob, n_k, bm, bn = vals.shape
    lib, fns = _kernel()
    v = variant(x.dtype, m, bm, bn, vals.dtype)
    if v == "mma":
        x, vals = _build.aligned16(x), _build.aligned16(vals)
    elif v == "gemv":               # 16-byte weight loads where bn % 8 == 0
        vals = _build.aligned16(vals)
    out = torch.empty((m, ob * bn), dtype=x.dtype, device=x.device)
    err = fns[x.dtype](x.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                       out.data_ptr(), m, d_in, ob, n_k, bm, bn,
                       _build.weight_code(vals.dtype),
                       _build.VARIANT_CODES[v],
                       torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, "sparse_matmul", err)
    _build.LAUNCHES["sparse_matmul"] += 1
    _build.VARIANT_LAUNCHES[("sparse_matmul", v)] += 1
    return out
