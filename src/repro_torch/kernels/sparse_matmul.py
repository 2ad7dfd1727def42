"""Gathered block-sparse matmul: the pruned classifier of ResNet-50 and
the pruned FFN of the LMs (64 x 64 blocks for SmolLM-360M, 128 x 128
for Mistral-Nemo-12B, Qwen3-32B and Granite-20B).

``sparse_matmul`` launches the CUDA kernel in ``csrc/sparse_matmul.cu``,
which replaces the reference's ``kernels/sparse_matmul.py::
sparse_matmul_pallas``, in the variant that :func:`variant` names:
"gemv" for at most ``SIMT_MAX_M`` rows (the f32 classifier, the LM
decode; one block per 8 output columns), "mma" (tensor
cores) for more bf16 rows with blocks the tensor-core tiles divide (the
LM prefill), "simt" (CUDA cores) otherwise. ``sparse_matmul_torch`` is
the plain PyTorch version of the same function: the CPU path and the
check every variant is held to on the card.

Stored weights: bf16 vals, int8 codes (gemv, simt; the caller applies
the scale to the output, as the reference does outside its Pallas
kernel, ``ops.py:135-144``) or f32 vals (simt).
"""
from __future__ import annotations

import ctypes
import functools

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


SIMT_MAX_M = 8     # rows up to which the gemv variant runs (decode)
BLOCK_MAX = 128    # the largest block side the kernel takes (csrc)
SUB_BLOCK = 64     # simt and mma walk a larger block as 64 x 64 pieces


def side_ok(b: int) -> bool:
    """A block side the simt and mma variants take: at most SUB_BLOCK,
    or a multiple of it up to BLOCK_MAX (gemv takes any side up to
    BLOCK_MAX)."""
    return 0 < b <= BLOCK_MAX and (b <= SUB_BLOCK or b % SUB_BLOCK == 0)


def variant(dtype: torch.dtype, m: int, bm: int, bn: int,
            w_dtype=torch.bfloat16) -> str:
    """The kernel variant for x of ``dtype`` with ``m`` rows and (bm, bn)
    weight blocks stored as ``w_dtype``: "gemv" for m <= SIMT_MAX_M
    (f32 or bf16 x, bf16 or int8 blocks up to 128 x 128); "mma" for bf16
    x and bf16 blocks, bm a multiple of 16 and bn of 8, each side
    :func:`side_ok` (the mma.m16n8k16 tiles); else "simt" (f32 weights
    always)."""
    if w_dtype == torch.float32:
        return "simt"
    if m <= SIMT_MAX_M:
        return "gemv"
    if dtype == torch.bfloat16 and w_dtype == torch.bfloat16 and \
            bm % 16 == 0 and bn % 8 == 0 and side_ok(bm) and side_ok(bn):
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
    return lib, fns, lib.sparse_matmul_max_bm(), lib.sparse_matmul_max_bn()


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
    m, d_in = x.shape
    ob, n_k, bm, bn = vals.shape
    lib, fns, max_bm, max_bn = _kernel()
    v = variant(x.dtype, m, bm, bn, vals.dtype)
    if d_in % bm or bm > max_bm or bn > max_bn \
            or (v != "gemv" and not (side_ok(bm) and side_ok(bn))) \
            or tuple(idx.shape) != (ob, n_k) or m * d_in >= 2 ** 31:
        raise ValueError(f"sparse_matmul: vals {tuple(vals.shape)} / idx "
                         f"{tuple(idx.shape)} do not fit x {tuple(x.shape)} "
                         f"(bm, bn <= {max_bm}, {max_bn}; past "
                         f"{SUB_BLOCK} a multiple of {SUB_BLOCK} in the "
                         f"{v} variant)")
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
