"""Depthwise 2D convolution: HPIPE's DepthwiseConv2D unit.

``depthwise_conv`` launches the CUDA kernel in ``csrc/depthwise_conv.cu``,
which replaces the reference's ``kernels/depthwise_conv.py::
depthwise_conv_pallas``. ``depthwise_conv_torch`` is the plain PyTorch
version of the same function: the CPU path and the check the kernel is
held to on the card.

Both follow the Pallas kernel's arithmetic, not the reference's XLA
oracle (a bf16 grouped ``lax.conv``): for each kernel row ky the k taps
of that row are summed from zero in f32 (:func:`shifted_row_mac`), that
row sum is added to an f32 accumulator, and the result is rounded once
to ``x.dtype``. No bias. The reference's VMEM budget and channel-tile
choice (``pick_block_c``) are TPU-only and have no counterpart here.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.sparse_conv import same_pads


def shifted_row_mac(rows, taps_ky, k: int, wo: int, stride: int):
    """One ky step of the line-buffered depthwise unit: the k shifted,
    strided (wo, C) windows of the input rows, times that kernel row's
    taps, summed from zero in f32. ``rows``: (..., wp, C) padded input
    rows; ``taps_ky``: (k, C). Returns (..., wo, C) f32. Shared by the
    depthwise and the fused dw->pw plain versions, as the reference
    shares its own (``depthwise_conv.py:42-55``)."""
    acc = torch.zeros(rows.shape[:-2] + (wo, rows.shape[-1]),
                      dtype=torch.float32, device=rows.device)
    for kx in range(k):
        win = rows[..., kx:kx + (wo - 1) * stride + 1:stride, :]
        acc = acc + win.float() * taps_ky[kx].float()
    return acc


def depthwise_acc(xp, w, *, stride: int, ho: int, wo: int):
    """The f32 depthwise sum over a SAME-padded NHWC slab ``xp`` for
    ``ho`` output rows: per ky one :func:`shifted_row_mac` over the rows
    ``ky, ky + stride, ...``, added into the accumulator in ky order."""
    k = w.shape[0]
    acc = None
    for ky in range(k):
        rows = xp[:, ky:ky + (ho - 1) * stride + 1:stride]
        r = shifted_row_mac(rows, w[ky], k, wo, stride)
        acc = r if acc is None else acc + r
    return acc


def pad_same_nhwc(x, k: int, stride: int):
    """SAME-pad the H/W axes of NHWC ``x`` (lo = total // 2);
    returns (xp, ho, wo)."""
    _, h, w, _ = x.shape
    ho, ph_lo, ph_hi = same_pads(h, k, stride)
    wo, pw_lo, pw_hi = same_pads(w, k, stride)
    return F.pad(x, (0, 0, pw_lo, pw_hi, ph_lo, ph_hi)), ho, wo


def depthwise_conv_torch(x, w, *, stride: int = 1) -> torch.Tensor:
    """x: (N, H, W, C) NHWC; w: (k, k, C). SAME padding, f32
    accumulation, output (N, ceil(H/stride), ceil(W/stride), C) in
    x.dtype."""
    xp, ho, wo = pad_same_nhwc(x, w.shape[0], stride)
    return depthwise_acc(xp, w, stride=stride, ho=ho, wo=wo).to(x.dtype)


MAX_K = 7              # the kernel sizes the kernel is built for: 1..MAX_K
MIN_BLOCKS = 132       # one block for each SM of the H100


@functools.lru_cache(maxsize=None)
def plan(n: int, ho: int, wo: int, c: int, k: int,
         stride: int) -> tuple[int, int]:
    """(r, threads): output pixels a thread and threads a block. A
    thread owns 8 channels of r neighbouring pixels of a row and reads
    each input column of its window once per kernel row; r is 2 at
    stride 1 where C is a multiple of 8, else 1 (the best of 1, 2 and 4
    at every MobileNet shape in a sweep on the H100). A block is the
    largest of 256, 128 and 64 threads that leaves MIN_BLOCKS blocks,
    else 32: the small 7x7 and 14x14 layers still fill the card."""
    r = 2 if stride == 1 and c % 8 == 0 else 1
    items = n * ho * -(-wo // r) * -(-c // 8)
    threads = next((t for t in (256, 128, 64)
                    if -(-items // t) >= MIN_BLOCKS), 32)
    return r, threads


_default_plan = plan   # the wrapper's ``plan`` argument shadows it

RS = (1, 2, 4)                 # pixels a thread: the kernel's instances
THREADS = (32, 64, 128, 256)   # threads a block the autotuner tries


def plan_candidates(c: int, stride: int) -> list[tuple[int, int]]:
    """Every (r, threads) the kernel can run: r of RS (r > 1 only at
    stride 1 where C is a multiple of 8) x threads of THREADS. The
    autotuner's search space (``core/tuning.autotune_depthwise_plan``)."""
    rs = RS if stride == 1 and c % 8 == 0 else (1,)
    return [(r, t) for r in rs for t in THREADS]


def check_plan(plan, c: int, stride: int) -> tuple[int, int]:
    """``plan`` as an int pair (r, threads) if the kernel can run it, else
    ValueError (the candidates of :func:`plan_candidates`)."""
    r, threads = (int(v) for v in plan)
    if (r, threads) not in plan_candidates(c, stride):
        raise ValueError(f"depthwise_conv: plan (r {r}, threads {threads}) "
                         f"needs r in {RS} (r > 1 at stride 1 with C % 8 "
                         f"== 0; here stride {stride}, C {c}) and threads "
                         f"in {THREADS}")
    return r, threads


_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("depthwise_conv")
    fn = lib.depthwise_conv_bf16
    fn.argtypes = [_P] * 3 + [_I] * 12 + [_P]
    fn.restype = _I
    return lib, fn


def depthwise_conv(x, w, *, stride: int = 1, plan=None) -> torch.Tensor:
    """The CUDA kernel: same function and arguments as
    :func:`depthwise_conv_torch`, on contiguous bf16 CUDA tensors with a
    k x k kernel, 1 <= k <= MAX_K, and any C (C not a multiple of 8 takes
    masked scalar loads). Raises on anything the kernel does not take; it
    never falls back to the plain version. The output is allocated here
    and the kernel runs on the current stream without synchronising.

    ``plan``: (r, threads) in place of :func:`plan`'s (a tuned plan,
    ``kernels/ops.py``); one it cannot run raises (:func:`check_plan`).
    The kernel never substitutes its own."""
    k = w.shape[0]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"depthwise_conv: a {k}x{k} kernel; the kernel is "
                         f"built for k from 1 to {MAX_K}")
    for name, t in (("x", x), ("w", w)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"depthwise_conv: {name} must be on {x.device} "
                             f"(a CUDA device), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"depthwise_conv: {name} must be contiguous")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"depthwise_conv: {name} must be bfloat16, "
                             f"got {t.dtype}")
    if x.dim() != 4 or w.dim() != 3 or tuple(w.shape) != (
            w.shape[0], w.shape[0], x.shape[-1]):
        raise ValueError(f"depthwise_conv: needs x (N, H, W, C) and w (k, "
                         f"k, C); got {tuple(x.shape)} and {tuple(w.shape)}")
    if stride < 1:
        raise ValueError(f"depthwise_conv: stride {stride} < 1")
    n, h, wd, c = x.shape
    ho, ph, _ = same_pads(h, k, stride)
    wo, pw, _ = same_pads(wd, k, stride)
    out = torch.empty((n, ho, wo, c), dtype=torch.bfloat16, device=x.device)
    if x.numel() >= 2 ** 31 or out.numel() >= 2 ** 31:
        raise ValueError("depthwise_conv: x and the output need < 2^31 "
                         "elements")
    if c % 8 == 0:                    # 16-byte vectors of 8 channels
        x, w = _build.aligned16(x), _build.aligned16(w)
    r, threads = check_plan(plan, c, stride) if plan is not None else \
        _default_plan(n, ho, wo, c, k, stride)
    lib, fn = _kernel()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), n, h, wd, c, ho, wo,
             k, stride, ph, pw, r, threads, stream)
    _build.check(lib, "depthwise_conv", err)
    _build.LAUNCHES["depthwise_conv"] += 1
    return out
