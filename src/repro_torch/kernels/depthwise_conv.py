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


MAX_K = 7              # the templated kernel sizes, 1..MAX_K; past it
                       # one kernel takes k at run time, one pixel a thread
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
    r = 2 if stride == 1 and c % 8 == 0 and k <= MAX_K else 1
    items = n * ho * -(-wo // r) * -(-c // 8)
    threads = next((t for t in (256, 128, 64)
                    if -(-items // t) >= MIN_BLOCKS), 32)
    return r, threads


_default_plan = plan   # the wrapper's ``plan`` argument shadows it

RS = (1, 2, 4)                 # pixels a thread: the kernel's instances
THREADS = (32, 64, 128, 256)   # threads a block the autotuner tries


def plan_candidates(c: int, stride: int,
                    k: int = 3) -> list[tuple[int, int]]:
    """Every (r, threads) the kernel can run: r of RS (r > 1 only at
    stride 1 where C is a multiple of 8 and k <= MAX_K) x threads of
    THREADS. The autotuner's search space
    (``core/tuning.autotune_depthwise_plan``)."""
    rs = RS if stride == 1 and c % 8 == 0 and k <= MAX_K else (1,)
    return [(r, t) for r in rs for t in THREADS]


def check_plan(plan, c: int, stride: int, k: int = 3) -> tuple[int, int]:
    """``plan`` as an int pair (r, threads) if the kernel can run it, else
    ValueError (the candidates of :func:`plan_candidates`)."""
    r, threads = (int(v) for v in plan)
    if (r, threads) not in plan_candidates(c, stride, k):
        raise ValueError(f"depthwise_conv: plan (r {r}, threads {threads}) "
                         f"needs r in {RS} (r > 1 at stride 1 with C % 8 "
                         f"== 0 and k <= {MAX_K}; here stride {stride}, C "
                         f"{c}, k {k}) and threads in {THREADS}")
    return r, threads


_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("depthwise_conv")
    fn = lib.depthwise_conv_bf16
    fn.argtypes = [_P] * 3 + [_I] * 12 + [_P]
    fn.restype = _I
    return lib, fn


def check_shapes(x_shape, w_shape, *,
                 stride: int = 1) -> tuple[int, int, int, int]:
    """The wrapper's shape check, without a card: ``(ho, wo, pad_h,
    pad_w)`` of the SAME output if the kernel takes these shapes, else
    ValueError. It takes every k >= 1, stride >= 1 and C (the Pallas
    kernel asserts only that its channel tile divides C, and picks one
    that does), and refuses only shapes that do not fit together and
    tensors of 2^31 elements or more (32-bit offsets)."""
    if len(x_shape) != 4 or len(w_shape) != 3 or w_shape[0] < 1 or \
            tuple(w_shape) != (w_shape[0], w_shape[0], x_shape[-1]):
        raise ValueError(f"depthwise_conv: needs x (N, H, W, C) and w (k, "
                         f"k, C), k >= 1; got {tuple(x_shape)} and "
                         f"{tuple(w_shape)}")
    if stride < 1:
        raise ValueError(f"depthwise_conv: stride {stride} < 1")
    n, h, wd, c = x_shape
    k = w_shape[0]
    ho, ph, _ = same_pads(h, k, stride)
    wo, pw, _ = same_pads(wd, k, stride)
    if n * h * wd * c >= 2 ** 31 or n * ho * wo * c >= 2 ** 31:
        raise ValueError("depthwise_conv: x and the output need < 2^31 "
                         "elements")
    return ho, wo, ph, pw


def depthwise_conv(x, w, *, stride: int = 1, plan=None) -> torch.Tensor:
    """The CUDA kernel: same function and arguments as
    :func:`depthwise_conv_torch`, on contiguous bf16 CUDA tensors with a
    k x k kernel, any k >= 1, and any C (C not a multiple of 8 takes
    masked scalar loads). Raises on anything the kernel does not take
    (:func:`check_shapes`); it never falls back to the plain version.
    The output is allocated here and the kernel runs on the current
    stream without synchronising.

    ``plan``: (r, threads) in place of :func:`plan`'s (a tuned plan,
    ``kernels/ops.py``); one it cannot run raises (:func:`check_plan`).
    The kernel never substitutes its own."""
    for name, t in (("x", x), ("w", w)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"depthwise_conv: {name} must be on {x.device} "
                             f"(a CUDA device), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"depthwise_conv: {name} must be contiguous")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"depthwise_conv: {name} must be bfloat16, "
                             f"got {t.dtype}")
    ho, wo, ph, pw = check_shapes(x.shape, w.shape, stride=stride)
    n, h, wd, c = x.shape
    k = w.shape[0]
    out = torch.empty((n, ho, wo, c), dtype=torch.bfloat16, device=x.device)
    if c % 8 == 0:                    # 16-byte vectors of 8 channels
        x, w = _build.aligned16(x), _build.aligned16(w)
    r, threads = check_plan(plan, c, stride, k) if plan is not None else \
        _default_plan(n, ho, wo, c, k, stride)
    lib, fn = _kernel()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), n, h, wd, c, ho, wo,
             k, stride, ph, pw, r, threads, stream)
    _build.check(lib, "depthwise_conv", err)
    _build.LAUNCHES["depthwise_conv"] += 1
    return out
