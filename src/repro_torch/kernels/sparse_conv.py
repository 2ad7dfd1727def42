"""Fused implicit-GEMM block-sparse convolution: the HPIPE conv unit.

``sparse_conv`` launches the CUDA kernel in ``csrc/sparse_conv.cu``,
which replaces the reference's ``kernels/sparse_conv.py::
sparse_conv_pallas``, in the variant that :func:`variant` names: "mma"
(tensor cores, with the tile and cluster split-K that :func:`plan`
picks) or "simt" (CUDA cores). ``sparse_conv_torch`` is the plain
PyTorch version of the same function: the CPU path and the check both
variants are held to on the card. Neither builds an im2col tensor: the plain
version gathers one shifted (ky, kx, channel-block) window per
surviving block, as the reference's XLA path does (``ops.py:228-276``).

Weight layout: the 2D conv weight is (k*k*cin, cout) with rows in HWIO
order — row f = (ky*k + kx)*cin + c — pruned block-balanced. The block
row size ``bm`` divides ``cin``, so every surviving block is exactly one
(ky, kx, channel-block) gather.

Stored weights: bf16 vals (native), int8 codes with an (ob, bn) f32
``scale`` that multiplies the f32 sum of code products in the epilogue
before bias and residual (the reference's flush, ``sparse_conv.py:
117-121``), or f32 vals with an f32 bias (the "f32" store).
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build


def conv_block_coords(idx, k: int, cin: int, bm: int):
    """Decompose flat HWIO block ids -> (ky, kx, cb) gather coordinates.

    idx: (ob, K) ints in [0, k*k*cin/bm)."""
    cpb = cin // bm                      # channel blocks per kernel position
    pos = idx // cpb
    return pos // k, pos % k, idx % cpb


def same_pads(size: int, k: int, stride: int) -> tuple[int, int, int]:
    """(out_size, pad_lo, pad_hi) matching lax SAME padding: the odd
    pixel of padding goes to the high side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return out, total // 2, total - total // 2


def sparse_conv_torch(x, vals, idx, bias, residual=None, scale=None, *,
                      k: int, stride: int = 1,
                      relu: bool = True) -> torch.Tensor:
    """y[n, oy, ox, j*bn:+bn] = act(scale[j] * sum_l win(x; ky,kx,cb)[oy,ox]
    @ vals[j,l] + b + residual), SAME padding, f32 accumulation, output
    in x.dtype (on the CPU the sum is taken in f64 and rounded once to
    f32: ``_build.plain_acc``).

    x: (N, H, W, C) NHWC; vals: (ob, K, bm, bn) bf16, f32 or int8 codes;
    idx: (ob, K) int flat HWIO block ids; bias: (ob*bn,); residual:
    optional (N, Ho, Wo, ob*bn); scale: (ob, bn) f32 with int8 codes,
    else None. Each step of the K loop gathers one window per output
    block column, (N, ob, Ho, Wo, bm): the size of the output, never k*k
    times the input."""
    n, h, w, c = x.shape
    ob, n_k, bm, bn = vals.shape
    ho, ph_lo, ph_hi = same_pads(h, k, stride)
    wo, pw_lo, pw_hi = same_pads(w, k, stride)
    xp = F.pad(x, (0, 0, pw_lo, pw_hi, ph_lo, ph_hi))
    ky, kx, cb = conv_block_coords(idx.long(), k, c, bm)
    dev = x.device
    oy = torch.arange(ho, device=dev) * stride
    ox = torch.arange(wo, device=dev) * stride
    ch = torch.arange(bm, device=dev)
    ad = _build.plain_acc(x)
    acc = torch.zeros((n, ho, wo, ob, bn), dtype=ad, device=dev)
    for l in range(n_k):
        rows = (ky[:, l, None] + oy)[:, :, None, None]         # (ob, Ho, 1, 1)
        cols = (kx[:, l, None] + ox)[:, None, :, None]         # (ob, 1, Wo, 1)
        chans = (cb[:, l, None] * bm + ch)[:, None, None, :]   # (ob, 1, 1, bm)
        a = xp[:, rows, cols, chans]                  # (N, ob, Ho, Wo, bm)
        acc += torch.einsum("njhwm,jmo->nhwjo", a.to(ad), vals[:, l].to(ad))
    acc = acc.float()
    if scale is not None:
        acc = acc * scale.float()                 # the code sum, re-realed
    y = acc.reshape(n, ho, wo, ob * bn) + bias.float()
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


PIECE = 32   # both variants walk a stored block as PIECE x PIECE pieces


def k_steps(n_k: int, bm: int) -> int:
    """The K loop's steps for n_k surviving blocks of bm rows a column:
    each block is ceil(bm / PIECE) row pieces (a 128-row block at tap
    (ky, kx) is four consecutive 32-channel gathers). :func:`plan` and
    the cluster split-K run over these."""
    return n_k * -(-bm // PIECE)


def variant(bm: int, bn: int, w_dtype=torch.bfloat16) -> str:
    """The kernel variant for (bm, bn) weight blocks stored as
    ``w_dtype``: "mma" for bf16 or int8 blocks (the codes are exact in
    bf16) when bm is a multiple of 16 and bn of 8 (the mma.m16n8k16
    tiles; every ResNet-50 layer at 32 x 32, and at SparsityConfig's
    default 128 x 128 / 64 x 64), else "simt" (any bm that divides C,
    any bn; f32 weights always)."""
    if w_dtype in (torch.bfloat16, torch.int8) and bm > 0 and bn > 0 and \
            bm % 16 == 0 and bn % 8 == 0:
        return "mma"
    return "simt"


TILES = (32, 16)       # output pixels a block (the kernel's instances)
MAX_SPLIT = 8          # the portable thread-block cluster size
STEPS_PER_SLICE = 3    # K steps a block walks at most, where S allows


def plan(m: int, ob: int, k_steps: int) -> tuple[int, int]:
    """(tm, split) of the mma variant for m output pixels, ob output
    block columns and k_steps steps a column (:func:`k_steps`: the
    surviving blocks at 32-row blocks and below).

    The grid is (ceil(m / tm), ob, split), split along a cluster. At
    batch 1 the time is latency: a chain of gathers and products per
    block, then (split > 1) one cluster barrier, ~0.5 us. So the K chain
    is cut into slices of at most STEPS_PER_SLICE steps (up to
    MAX_SPLIT), and the tile is 32 pixels, 16 where m fits in one: the
    best or within 0.15 us of the best tile and split at every
    ResNet-50 shape in a sweep on the H100 (PERF.md)."""
    split = min(MAX_SPLIT, max(1, -(-k_steps // STEPS_PER_SLICE)))
    return (16 if m <= 16 else 32), split


_default_plan = plan   # the wrapper's ``plan`` argument shadows it

SPLITS = (1, 2, 4, 8)  # the splits the autotuner tries (<= MAX_SPLIT)


def plan_candidates(k_steps: int) -> list[tuple[int, int]]:
    """Every (tm, split) the mma variant can run for a column of k_steps
    steps (:func:`k_steps`): each tile of TILES x each split of SPLITS up to
    k_steps (every rank walks at least one step). The autotuner's
    search space (``core/tuning.autotune_sparse_conv_plan``)."""
    return [(tm, split) for tm in TILES for split in SPLITS
            if split <= max(k_steps, 1)]


def check_plan(plan, k_steps: int) -> tuple[int, int]:
    """``plan`` as an int pair (tm, split) if the mma variant can run it
    for k_steps surviving blocks a column, else ValueError: tm one of
    TILES, 1 <= split <= MAX_SPLIT and split <= k_steps."""
    tm, split = (int(v) for v in plan)
    if tm not in TILES or not 1 <= split <= min(MAX_SPLIT, max(k_steps, 1)):
        raise ValueError(f"sparse_conv: plan (tm {tm}, split {split}) needs "
                         f"tm in {TILES} and 1 <= split <= "
                         f"min({MAX_SPLIT}, K steps {k_steps})")
    return tm, split


def k_slices(k_steps: int, split: int) -> list[tuple[int, int]]:
    """The K steps [lo, hi) that each cluster rank walks, in rank order:
    rank r takes [r*K//S, (r+1)*K//S), as the kernel does."""
    return [(r * k_steps // split, (r + 1) * k_steps // split)
            for r in range(split)]


_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("sparse_conv")
    fn = lib.sparse_conv_launch
    fn.argtypes = [_P] * 7 + [_I] * 19 + [_P]
    fn.restype = _I
    return lib, fn


def check_shapes(x_shape, vals_shape, idx_shape, bias_shape,
                 residual_shape=None, scale_shape=None, *, k: int,
                 stride: int = 1) -> tuple[int, int, int, int]:
    """The wrapper's shape check, without a card: ``(ho, wo, pad_h,
    pad_w)`` of the SAME output if the kernel takes these shapes, else
    ValueError. It takes every block shape the Pallas kernel takes (its
    one assert: bm divides C; any bn), and refuses only shapes that do
    not fit together, a kernel size or stride below 1, and tensors of
    2^31 elements or more (32-bit offsets)."""
    if len(x_shape) != 4 or len(vals_shape) != 4:
        raise ValueError(f"sparse_conv: needs x (N, H, W, C) and vals (ob, "
                         f"K, bm, bn); got {tuple(x_shape)}, "
                         f"{tuple(vals_shape)}")
    n, h, w, c = x_shape
    ob, n_k, bm, bn = vals_shape
    if bm < 1 or bn < 1 or c % bm:
        raise ValueError(f"sparse_conv: blocks ({bm}, {bn}) need bm | C={c}")
    if k < 1 or stride < 1:
        raise ValueError(f"sparse_conv: k={k}, stride={stride} must be >= 1")
    if tuple(idx_shape) != (ob, n_k) or tuple(bias_shape) != (ob * bn,) \
            or (scale_shape is not None and tuple(scale_shape) != (ob, bn)):
        raise ValueError(f"sparse_conv: idx {tuple(idx_shape)} / bias "
                         f"{tuple(bias_shape)} / scale "
                         f"{None if scale_shape is None else tuple(scale_shape)}"
                         f" do not match vals {tuple(vals_shape)}")
    ho, ph, _ = same_pads(h, k, stride)
    wo, pw, _ = same_pads(w, k, stride)
    if residual_shape is not None and \
            tuple(residual_shape) != (n, ho, wo, ob * bn):
        raise ValueError(f"sparse_conv: residual {tuple(residual_shape)} != "
                         f"output {(n, ho, wo, ob * bn)}")
    if n * h * w * c >= 2 ** 31 or n * ho * wo * ob * bn >= 2 ** 31 or \
            ob * -(-bn // PIECE) > 65535:
        raise ValueError("sparse_conv: x and the output need < 2^31 "
                         "elements, and ob * ceil(bn / 32) <= 65535")
    return ho, wo, ph, pw


def sparse_conv(x, vals, idx, bias, residual=None, scale=None, *, k: int,
                stride: int = 1, relu: bool = True,
                plan=None) -> torch.Tensor:
    """The CUDA kernel: same function and arguments as
    :func:`sparse_conv_torch`, on CUDA tensors (x, residual bf16; vals
    bf16 with a bf16 bias, int8 codes with a bf16 bias and an f32
    scale, or f32 with an f32 bias), in the variant :func:`variant`
    names. Raises on anything the kernel does not take, and if the
    launch fails (a cluster launch included); it never falls back to
    the plain version or to the other variant. The output is allocated
    here and the kernel runs on the current stream without
    synchronising.

    ``plan``: the mma variant's (tm, split) in place of :func:`plan`'s
    (a tuned plan, ``kernels/ops.py``); one it cannot run raises
    (:func:`check_plan`), and so does a plan for the simt variant, which
    has no knobs. The kernel never substitutes its own."""
    w_dtype = vals.dtype
    if w_dtype not in (torch.bfloat16, torch.int8, torch.float32):
        raise ValueError(f"sparse_conv: vals must be bf16, int8 or f32, "
                         f"got {w_dtype}")
    if (scale is not None) != (w_dtype == torch.int8):
        raise ValueError("sparse_conv: a scale comes with int8 vals, and "
                         "only with them")
    b_dtype = torch.float32 if w_dtype == torch.float32 else torch.bfloat16
    want = {"x": torch.bfloat16, "vals": w_dtype, "idx": torch.int32,
            "bias": b_dtype, "residual": torch.bfloat16,
            "scale": torch.float32}
    tensors = {"x": x, "vals": vals, "idx": idx, "bias": bias}
    if residual is not None:
        tensors["residual"] = residual
    if scale is not None:
        tensors["scale"] = scale
    for name, t in tensors.items():
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"sparse_conv: {name} must be on {x.device} "
                             f"(a CUDA device), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"sparse_conv: {name} must be contiguous")
        if t.dtype != want[name]:
            raise ValueError(f"sparse_conv: {name} must be {want[name]}, "
                             f"got {t.dtype}")
    n, h, w, c = x.shape
    ob, n_k, bm, bn = vals.shape
    ho, wo, ph, pw = check_shapes(
        x.shape, vals.shape, idx.shape, bias.shape,
        None if residual is None else residual.shape,
        None if scale is None else scale.shape, k=k, stride=stride)
    out = torch.empty((n, ho, wo, ob * bn), dtype=torch.bfloat16,
                      device=x.device)
    v = variant(bm, bn, w_dtype)
    if plan is not None and v != "mma":
        raise ValueError(f"sparse_conv: a plan for the {v} variant, which "
                         f"takes none")
    if v == "mma":
        steps = k_steps(n_k, bm)
        tm, split = check_plan(plan, steps) if plan is not None else \
            _default_plan(n * ho * wo, ob, steps)
    else:
        tm, split = 64, 1
    if v == "mma":
        x, vals, bias = (_build.aligned16(t) for t in (x, vals, bias))
        if residual is not None:
            residual = _build.aligned16(residual)
        if scale is not None:
            scale = _build.aligned16(scale)
    lib, fn = _kernel()
    err = fn(x.data_ptr(), vals.data_ptr(), idx.data_ptr(), bias.data_ptr(),
             None if residual is None else residual.data_ptr(),
             None if scale is None else scale.data_ptr(),
             out.data_ptr(), n, h, w, c, ho, wo, k, stride, ph, pw, ob, n_k,
             bm, bn, int(relu), _build.weight_code(w_dtype),
             _build.VARIANT_CODES[v], tm, split,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, "sparse_conv", err)
    _build.LAUNCHES["sparse_conv"] += 1
    _build.VARIANT_LAUNCHES[("sparse_conv", v)] += 1
    return out
