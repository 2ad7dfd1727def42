"""Fused depthwise -> pointwise (1x1) convolution: the MobileNet block
body as one memory pass.

``dw_pw`` launches the CUDA kernel in ``csrc/dw_pw.cu``, which replaces
the reference's ``kernels/dw_pw_fused.py::dw_pw_pallas``, in the variant
that :func:`variant` names: "mma" (tensor cores, the input halo in shared
memory, C split over a thread-block cluster as :func:`plan` picks) or
"simt" (CUDA cores). ``dw_pw_torch`` is the plain PyTorch version of the
same function: the CPU path and the check both variants are held to on
the card.

The order is the Pallas kernel's (``_kernel``): the depthwise sum as in
:mod:`repro_torch.kernels.depthwise_conv`, ``+ dw_b`` in f32, optional
ReLU, one round to the activation dtype (the dw->pw boundary the
unfused graph has), an f32 dot with the dense (C, Cout) pointwise
weight, ``+ pw_b``, optional residual (f32), optional ReLU, one round.
Neither version writes the (N, Ho, Wo, C) depthwise tensor: the kernel
keeps it in shared memory, and the plain version works one chunk of
output rows at a time, as the reference's XLA twin (``dw_pw_xla``) does.

Stored weights: all bf16 (native); int8 pointwise codes with a (Cout,)
f32 ``pw_scale`` that multiplies the f32 code product before ``pw_b``
(the reference's flush, ``dw_pw_fused.py:83-86``), the depthwise weight
and the biases bf16; or all weights and biases f32 (the "f32" store).
Every store takes any k, as the Pallas kernel does: bf16 at k 1..MAX_K
and int8 and f32 at k = QUANT_K (the MobileNets' depthwise) through
templated instances, every other k through the simt variant with k
given at run time.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.depthwise_conv import depthwise_acc, pad_same_nhwc
from repro_torch.kernels.sparse_conv import same_pads


def _row_chunk(ho: int, cap: int = 16) -> int:
    """Largest divisor of ho <= cap (output rows per chunk, as the
    reference's XLA twin picks them)."""
    for d in range(min(ho, cap), 0, -1):
        if ho % d == 0:
            return d
    return 1


def dw_pw_torch(x, dw_w, dw_b, pw_w, pw_b, residual=None, pw_scale=None, *,
                stride: int = 1, dw_relu: bool = True,
                relu: bool = True) -> torch.Tensor:
    """x: (N, H, W, C); dw_w: (k, k, C); dw_b: (C,); pw_w: (C, Cout)
    dense (int8 codes when ``pw_scale``, (Cout,) f32, is given); pw_b:
    (Cout,); residual: optional (N, Ho, Wo, Cout). SAME padding on the
    depthwise. Returns (N, Ho, Wo, Cout) in x.dtype.

    Loops over chunks of at most 16 output rows; each chunk runs the depthwise on its (rows + halo) input slab and feeds
    the result straight into the pointwise product, so the working set
    is one chunk. The pointwise sums are f32 (on the CPU f64 rounded
    once to f32: ``_build.plain_acc``)."""
    n = x.shape[0]
    k = dw_w.shape[0]
    co = pw_w.shape[-1]
    xp, ho, wo = pad_same_nhwc(x, k, stride)
    hb = _row_chunk(ho)
    rows_in = (hb - 1) * stride + k
    ad = _build.plain_acc(x)
    w_acc = pw_w.to(ad)
    out = torch.empty((n, ho, wo, co), dtype=x.dtype, device=x.device)
    for r0 in range(0, ho, hb):
        slab = xp[:, r0 * stride:r0 * stride + rows_in]
        d = depthwise_acc(slab, dw_w, stride=stride, ho=hb, wo=wo) \
            + dw_b.float()
        if dw_relu:
            d = torch.relu(d)
        d = d.to(x.dtype)                    # the dw->pw boundary round
        y = torch.matmul(d.to(ad), w_acc).float()
        if pw_scale is not None:
            y = y * pw_scale.float()          # the code product, re-realed
        y = y + pw_b.float()
        if residual is not None:
            y = y + residual[:, r0:r0 + hb].float()
        if relu:
            y = torch.relu(y)
        out[:, r0:r0 + hb] = y.to(x.dtype)
    return out


MAX_K = 7              # the templated bf16 kernel sizes, 1..MAX_K (the mma
                       # variant's); past it the simt variant, k at run time
TILES = (64, 32, 16)   # output pixels a block (the mma instances)
MAX_SPLIT = 8          # the portable thread-block cluster size
STEPS_PER_SLICE = 3    # channel chunks a block walks at most, where S allows
STAGES = 3             # the cp.async ring
MIN_BLOCKS = 128       # a grid this large fills the card (a sweep)
SMEM_MAX = 232448      # the shared memory one block may hold on sm_90
MAX_MMA_STRIDE = 4     # beyond it the halo of a 16-pixel tile may not fit
QUANT_K = 3            # the k with templated int8 and f32 instances


def variant(c: int, cout: int, k: int, stride: int = 1,
            w_dtype=torch.bfloat16) -> str:
    """The kernel variant for C input and Cout output channels, a k x k
    depthwise, ``stride`` and a pointwise weight stored as ``w_dtype``:
    "mma" for bf16 weights at k up to MAX_K and int8 weights (the codes
    are exact in bf16) at k = QUANT_K, when C and Cout are multiples of 8
    (16-byte copies of 8 channels; every MobileNet block) and the stride
    is at most MAX_MMA_STRIDE, else "simt" (f32 weights always; any
    k)."""
    mma_k = 1 <= k <= MAX_K if w_dtype == torch.bfloat16 else k == QUANT_K
    if w_dtype in (torch.bfloat16, torch.int8) and c % 8 == 0 and \
            cout % 8 == 0 and mma_k and 1 <= stride <= MAX_MMA_STRIDE:
        return "mma"
    return "simt"


def smem_bytes(k: int, tm: int, tn: int, hr: int, hc: int, ck: int,
               split: int, codes: bool = False) -> int:
    """Dynamic shared memory of one mma block: STAGES x (input halo of
    hr x hc pixels x ck channels, the taps, dw_b, the ck x tn pw_w tile
    with rows padded by 8), the tm x (ck + 8) A tile and the split slots
    of f32 partial rows (``MmaSmem`` in ``csrc/dw_pw.cu``). The int8
    instances (``codes``) take less: their ring holds the ck x tn codes,
    widened into one bf16 B tile outside it, plus tn f32 scales."""
    def r16(b):
        return -(-b // 16) * 16
    wt = ck * tn if codes else ck * (tn + 8) * 2
    stage = r16(hr * hc * ck * 2) + r16(k * k * ck * 2) + r16(ck * 2) + wt
    return (STAGES * stage + (ck * (tn + 8) * 2 if codes else 0)
            + tm * (ck + 8) * 2
            + split * -(-tm // split) * (tn + 4) * 4
            + (tn * 4 if codes else 0))


class Plan(NamedTuple):
    tm: int        # the A tile's rows: output pixels a block at most
    tn: int        # output channels a block (on 2 * tn threads)
    tr: int        # output rows of a pixel tile
    tw: int        # output columns of a pixel tile (tr * tw <= tm)
    ck: int        # channels a chunk
    split: int     # cluster size: the blocks that share one output tile
    blocks: int    # the grid's blocks
    steps: int     # chunks the busiest block walks
    smem: int      # dynamic shared memory a block, bytes


def tile_shape(tm: int, ho: int, wo: int) -> tuple[int, int]:
    """(tr, tw): whole output rows of one image where a row fits in tm
    pixels (so the halo is a rectangle), else tm columns of one row."""
    if wo >= tm:
        return 1, tm
    return min(tm // wo, ho), wo


@functools.lru_cache(maxsize=None)
def plan(n: int, ho: int, wo: int, c: int, cout: int, k: int,
         stride: int) -> Plan:
    """The mma variant's tiles and split for an (n, ho, wo) output.

    At batch 1 a block's time is a chain: a launch, then one dependent
    step (loads, depthwise, product) per chunk of channels, and (split >
    1) one cluster barrier, ~0.5 us on the H100. So C goes in chunks of
    64 channels (32 where C < 64, or where 64 do not fit), and the chunks
    are split over a cluster of the least power of two S <= MAX_SPLIT
    that leaves each block at most STEPS_PER_SLICE of them: for C <= 1536
    no block walks more than 3 chunks. A block takes 128 output channels
    on 256 threads where Cout > 64 (the depthwise, which each Cout tile
    recomputes, is then done half as often and by twice the threads),
    else 64 on 128. The pixel tile is the largest of
    TILES whose grid still has MIN_BLOCKS blocks, within the shared
    memory a block may hold; where even the smallest leaves SMs idle, S
    doubles (up to MAX_SPLIT and one chunk a block) until the grid has
    MIN_BLOCKS. Against a sweep of every tile, Cout tile, chunk and split
    that fits, at the 21 MobileNet block shapes on the H100, the plan is
    within 0.5 us of the best at 19 and within 0.8 us at all of them
    (tools/sweep_dw_pw.py; PERF.md)."""
    tn = 128 if cout > 64 else 64
    for ck in ((64, 32) if c >= 64 else (32,)):
        chunks = -(-c // ck)
        split = 1
        while split < MAX_SPLIT and split * STEPS_PER_SLICE < chunks:
            split *= 2
        fits = []
        for tm in TILES:
            tr, tw = tile_shape(tm, ho, wo)
            hr, hc = (tr - 1) * stride + k, (tw - 1) * stride + k
            smem = smem_bytes(k, tm, tn, hr, hc, ck, split)
            if smem > SMEM_MAX:
                continue
            blocks = (n * -(-ho // tr) * -(-wo // tw) * -(-cout // tn)
                      * split)
            fits.append(Plan(tm, tn, tr, tw, ck, split, blocks,
                             -(-chunks // split), smem))
        for p in fits:
            if p.blocks >= MIN_BLOCKS:
                return p
        while fits:
            # the smallest tile still leaves SMs idle: split C further,
            # which also shortens each block's chain
            p = fits[-1]
            if (p.blocks >= MIN_BLOCKS or p.split == MAX_SPLIT
                    or 2 * p.split > chunks):
                return p
            hr, hc = (p.tr - 1) * stride + k, (p.tw - 1) * stride + k
            smem = smem_bytes(k, p.tm, tn, hr, hc, ck, 2 * p.split)
            if smem > SMEM_MAX:
                return p
            fits[-1] = p._replace(split=2 * p.split, blocks=2 * p.blocks,
                                  steps=-(-chunks // (2 * p.split)),
                                  smem=smem)
    raise ValueError(f"dw_pw: no mma tile fits k={k}, stride={stride}, "
                     f"W_out={wo} in {SMEM_MAX} bytes of shared memory")


_default_plan = plan   # the wrapper's ``plan`` argument shadows it


TNS = (64, 128)        # Cout tiles a block (on 2 * tn threads)
CKS = (32, 64)         # channels a chunk
SPLITS = (1, 2, 4, 8)  # cluster sizes the autotuner tries (<= MAX_SPLIT)


def make_plan(n: int, ho: int, wo: int, c: int, cout: int, k: int,
              stride: int, tm: int, tn: int, ck: int, split: int,
              codes: bool = False) -> Plan:
    """The full :class:`Plan` of the knobs (tm, tn, ck, split) at an
    (n, ho, wo) output: the pixel tile's rows and columns
    (:func:`tile_shape`), the grid, the busiest block's chunks and the
    shared memory (int8 ``codes`` take less)."""
    tr, tw = tile_shape(tm, ho, wo)
    hr, hc = (tr - 1) * stride + k, (tw - 1) * stride + k
    chunks = -(-c // ck)
    blocks = n * -(-ho // tr) * -(-wo // tw) * -(-cout // tn) * split
    return Plan(tm, tn, tr, tw, ck, split, blocks, -(-chunks // split),
                smem_bytes(k, tm, tn, hr, hc, ck, split, codes))


def plan_candidates(n: int, ho: int, wo: int, c: int, cout: int, k: int,
                    stride: int, codes: bool = False) -> list[Plan]:
    """Every plan the mma variant can run at an (n, ho, wo) output: each
    tile of TILES x Cout tile of TNS x chunk of CKS x split of SPLITS
    whose split leaves every block a chunk and whose shared memory fits
    SMEM_MAX. The autotuner's search space
    (``core/tuning.autotune_dw_pw_plan``) and ``tools/sweep_dw_pw.py``'s."""
    out = []
    for tm in TILES:
        for tn in TNS:
            for ck in CKS:
                for split in SPLITS:
                    if split > -(-c // ck):
                        continue
                    p = make_plan(n, ho, wo, c, cout, k, stride, tm, tn, ck,
                                  split, codes)
                    if p.smem <= SMEM_MAX:
                        out.append(p)
    return out


def check_plan(plan, n: int, ho: int, wo: int, c: int, cout: int, k: int,
               stride: int, codes: bool = False) -> Plan:
    """``plan`` (a :class:`Plan`, or any (tm, tn, tr, tw, ck, split, ...)
    sequence) as a full Plan if the mma variant can run it, else
    ValueError: tm one of TILES, tn of TNS, ck of CKS, 1 <= tr, tw and tr
    x tw <= tm, 1 <= split <= MAX_SPLIT and <= the chunks of C, and the
    shared memory within SMEM_MAX."""
    tm, tn, tr, tw, ck, split = (int(v) for v in tuple(plan)[:6])
    chunks = -(-c // ck) if ck in CKS else 0
    ok = (tm in TILES and tn in TNS and ck in CKS and tr >= 1 and tw >= 1
          and tr * tw <= tm and 1 <= split <= min(MAX_SPLIT, chunks))
    hr, hc = (tr - 1) * stride + k, (tw - 1) * stride + k
    smem = smem_bytes(k, tm, tn, hr, hc, ck, split, codes) if ok else 0
    if not ok or smem > SMEM_MAX:
        raise ValueError(f"dw_pw: plan (tm {tm}, tn {tn}, tr {tr}, tw {tw}, "
                         f"ck {ck}, split {split}) cannot run at C={c}, "
                         f"k={k}, stride={stride}: needs tm in {TILES}, tn "
                         f"in {TNS}, ck in {CKS}, tr x tw <= tm, split <= "
                         f"min({MAX_SPLIT}, {chunks} chunks) and shared "
                         f"memory {smem} <= {SMEM_MAX}")
    blocks = n * -(-ho // tr) * -(-wo // tw) * -(-cout // tn) * split
    return Plan(tm, tn, tr, tw, ck, split, blocks, -(-chunks // split), smem)


_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("dw_pw")
    fn = lib.dw_pw_launch
    fn.argtypes = [_P] * 8 + [_I] * 21 + [_P]
    fn.restype = _I
    return lib, fn


def check_shapes(x_shape, dw_w_shape, dw_b_shape, pw_w_shape, pw_b_shape,
                 residual_shape=None, pw_scale_shape=None, *,
                 stride: int = 1) -> tuple[int, int, int, int]:
    """The wrapper's shape check, without a card: ``(ho, wo, pad_h,
    pad_w)`` of the SAME output if the kernel takes these shapes, else
    ValueError. It takes every k >= 1, stride >= 1, C and Cout, as the
    Pallas kernel (which asserts nothing of them) does, and refuses only
    shapes that do not fit together and tensors of 2^31 elements or
    more (32-bit offsets)."""
    if len(x_shape) != 4 or len(dw_w_shape) != 3 or len(pw_w_shape) != 2:
        raise ValueError(f"dw_pw: needs x (N, H, W, C), dw_w (k, k, C) and "
                         f"pw_w (C, Cout); got {tuple(x_shape)}, "
                         f"{tuple(dw_w_shape)}, {tuple(pw_w_shape)}")
    n, h, w, c = x_shape
    k = dw_w_shape[0]
    co = pw_w_shape[1]
    if (k < 1 or tuple(dw_w_shape) != (k, k, c) or tuple(dw_b_shape) != (c,)
            or pw_w_shape[0] != c or tuple(pw_b_shape) != (co,)
            or (pw_scale_shape is not None
                and tuple(pw_scale_shape) != (co,))):
        raise ValueError(f"dw_pw: dw_w {tuple(dw_w_shape)}, dw_b "
                         f"{tuple(dw_b_shape)}, pw_w {tuple(pw_w_shape)}, "
                         f"pw_b {tuple(pw_b_shape)} do not fit C={c}")
    if stride < 1:
        raise ValueError(f"dw_pw: stride {stride} < 1")
    ho, ph, _ = same_pads(h, k, stride)
    wo, pw, _ = same_pads(w, k, stride)
    if residual_shape is not None and \
            tuple(residual_shape) != (n, ho, wo, co):
        raise ValueError(f"dw_pw: residual {tuple(residual_shape)} != "
                         f"output {(n, ho, wo, co)}")
    if n * h * w * c >= 2 ** 31 or n * ho * wo * co >= 2 ** 31:
        raise ValueError("dw_pw: x and the output need < 2^31 elements")
    return ho, wo, ph, pw


def dw_pw(x, dw_w, dw_b, pw_w, pw_b, residual=None, pw_scale=None, *,
          stride: int = 1, dw_relu: bool = True, relu: bool = True,
          plan=None) -> torch.Tensor:
    """The CUDA kernel: same function and arguments as
    :func:`dw_pw_torch`, on contiguous CUDA tensors with a k x k
    depthwise, any k >= 1, in the variant :func:`variant` names.
    x and residual are bf16; the weights and biases bf16 (native), or
    pw_w int8 codes with an f32 ``pw_scale`` and the rest bf16, or all
    f32. Raises on anything the kernel does not take
    (:func:`check_shapes`), and if the launch fails (a cluster launch
    included); it never falls back to the plain version or to the other
    variant. The output is allocated here and the kernel runs on the
    current stream without synchronising.

    ``plan``: the mma variant's :class:`Plan` in place of :func:`plan`'s
    (a tuned plan, ``kernels/ops.py``); one it cannot run raises
    (:func:`check_plan`), and so does a plan for the simt variant, which
    has no knobs. The kernel never substitutes its own."""
    w_dtype = pw_w.dtype
    if w_dtype not in (torch.bfloat16, torch.int8, torch.float32):
        raise ValueError(f"dw_pw: pw_w must be bf16, int8 or f32, got "
                         f"{w_dtype}")
    if (pw_scale is not None) != (w_dtype == torch.int8):
        raise ValueError("dw_pw: a pw_scale comes with int8 pw_w, and only "
                         "with it")
    p_dtype = torch.float32 if w_dtype == torch.float32 else torch.bfloat16
    want = {"x": torch.bfloat16, "dw_w": p_dtype, "dw_b": p_dtype,
            "pw_w": w_dtype, "pw_b": p_dtype, "residual": torch.bfloat16,
            "pw_scale": torch.float32}
    tensors = {"x": x, "dw_w": dw_w, "dw_b": dw_b, "pw_w": pw_w,
               "pw_b": pw_b}
    if residual is not None:
        tensors["residual"] = residual
    if pw_scale is not None:
        tensors["pw_scale"] = pw_scale
    for name, t in tensors.items():
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"dw_pw: {name} must be on {x.device} "
                             f"(a CUDA device), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"dw_pw: {name} must be contiguous")
        if t.dtype != want[name]:
            raise ValueError(f"dw_pw: {name} must be {want[name]}, "
                             f"got {t.dtype}")
    ho, wo, ph, pw = check_shapes(
        x.shape, dw_w.shape, dw_b.shape, pw_w.shape, pw_b.shape,
        None if residual is None else residual.shape,
        None if pw_scale is None else pw_scale.shape, stride=stride)
    n, h, w, c = x.shape
    k, co = dw_w.shape[0], pw_w.shape[1]
    out = torch.empty((n, ho, wo, co), dtype=torch.bfloat16, device=x.device)
    v = variant(c, co, k, stride, w_dtype)
    if plan is not None and v != "mma":
        raise ValueError(f"dw_pw: a plan for the {v} variant, which takes "
                         f"none")
    if v != "mma":
        p = None
    elif plan is not None:
        p = check_plan(plan, n, ho, wo, c, co, k, stride,
                       codes=w_dtype == torch.int8)
    else:
        p = _default_plan(n, ho, wo, c, co, k, stride)
    if v == "mma":
        x, dw_w, dw_b, pw_w, pw_b = (_build.aligned16(t) for t in
                                     (x, dw_w, dw_b, pw_w, pw_b))
        if residual is not None:
            residual = _build.aligned16(residual)
        if pw_scale is not None:
            pw_scale = _build.aligned16(pw_scale)
    lib, fn = _kernel()
    err = fn(x.data_ptr(), dw_w.data_ptr(), dw_b.data_ptr(), pw_w.data_ptr(),
             pw_b.data_ptr(),
             None if residual is None else residual.data_ptr(),
             None if pw_scale is None else pw_scale.data_ptr(),
             out.data_ptr(), n, h, w, c, ho, wo, k, stride, ph, pw, co,
             int(dw_relu), int(relu), _build.weight_code(w_dtype),
             _build.VARIANT_CODES[v],
             *((p.tm, p.tn, p.tr, p.tw, p.ck, p.split) if p else
               (0, 0, 0, 0, 0, 1)),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, "dw_pw", err)
    _build.LAUNCHES["dw_pw"] += 1
    _build.VARIANT_LAUNCHES[("dw_pw", v)] += 1
    return out
