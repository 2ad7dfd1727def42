"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits nonzero:

1. device: require CUDA; print the card's name and power limit;
2. build: compile every CUDA kernel from ``src/repro_torch/kernels/csrc``
   with nvcc for sm_90a; print ptxas's registers, shared memory and
   spills per kernel function, and the HMMA (tensor-core) instructions
   in each one's SASS (``cuobjdump -sass``);
3. kernel checks: each kernel against its plain PyTorch version on the
   card, at every distinct shape its main paths give it: sparse_conv at
   every ResNet-50 layer shape (residual on and off, the "mma" variant,
   each layer's ``plan()`` printed) and at a block shape only "simt"
   takes, sparse_matmul at the classifier and at SmolLM-360M's decode
   shapes ("gemv", M 1 to 8) and at f32 M = 9 ("simt"), dw_pw at every
   MobileNet-V1/V2 block shape ("mma", each block's ``plan()`` printed),
   at k = 5 and 7 and at a C that is no multiple of 8 ("simt"),
   depthwise_conv at every dw shape of the unfused views, at odd C and at
   k = 5,
   flash_attention at SmolLM-360M's prefill shapes (T 2048 and a length
   that is no tile multiple), at short and odd lengths, windows and
   offsets, and on the reference's test grid, and sparse_matmul at
   SmolLM-360M's 64 x 64 FFN blocks and at 32 x 32 blocks, at M 4 to
   2048; flash_attention at D 128 (Qwen3-32B, Mistral-Nemo-12B and
   Granite-20B's heads at T 2048, Qwen3-32B's last cache chunk: Tq 512,
   q_offset 1536, Tk 2048; a Tk no tile multiple, a window, f32) and
   sparse_matmul at the three models' 128 x 128 FFN blocks at M 1-8
   ("gemv") and 2048 ("mma"); then the stored weights: int8 codes with their scales through
   sparse_conv "mma" at every ResNet-50 layer shape (residual on and
   off), the int8 classifier through "gemv", int8 dw_pw "mma" at every
   MobileNet block shape, and one "simt" shape each in int8 and in f32
   (sparse_conv, sparse_matmul, dw_pw); then the throughput paths'
   microbatch shapes, n 2 and 4: sparse_conv at every ResNet-50 layer
   shape, the classifier (M 2, 4) and dw_pw at every MobileNet block
   shape, bf16 and int8 (each shape's plan printed); each check also
   asserts the variant ("mma": tensor cores, "simt": CUDA cores, "gemv":
   M <= 8) that ``variant()`` names was the one launched;
4. main paths, each with the launch counters reset just before and read
   just after, every counter checked by name, and the variant counters
   of sparse_conv, sparse_matmul, dw_pw and flash_attention with them
   (a MobileNet request: 13 / 17 dw_pw "mma", no "simt"):
   ``serve(ServeConfig(arch=
   "resnet50" | "mobilenet_v1" | "mobilenet_v2", mode="latency",
   image_size=224, quantize=q))`` at q native and int8 (ResNet-50 also
   bf16 and f32), each request a replay of one CUDA graph, and the same
   requests eagerly (``_serve_cnn_latency(cfg, capture=False)``): the
   launches captured in the graph are one request's, checked by name and
   variant (the counters count the warm-up and the capture: a replay
   runs no Python), the graph's logits equal the eager ones bit for bit,
   and both are held against the port's plain CPU forward on the same
   stored weights and images; then one ``cnn_forward`` per MobileNet on
   the unfused view (``graph_for(name)``). Then throughput serving through
   the heterogeneous layer pipeline for each CNN at native and int8, each
   stage on its own CUDA stream and, for comparison, all on one:
   ``_serve_cnn`` (batch 16, M 4, S 4; the whole batch one CUDA graph,
   its launches M x one forward's) and ``_serve_cnn_continuous`` (16
   requests of 8 images, mb 2, and mb 1 for ResNet-50; one captured tick
   a microbatch, one forward's launches; the server's stage programs are
   PLACED, each reading its weights from its own packed uint8 row): the
   logits equal the sequential forward on the card, microbatch by
   microbatch, bit for bit, the one-stream run's too, and the plain CPU
   forward's within the bars above; the counters count the warm-ups and
   the captures. Before them, the frozen oracle
   (``cnn_forward_reference``) at batch 1 for each CNN: bit for bit the
   unfused view, with the unfused view's launches (13 / 17
   depthwise_conv). After them, for each CNN at native and int8 (mb 2,
   S 4), a server on its packed rows beside one on closures over a
   device copy: the same kernels a tick by name and variant, no
   aligned16 copy, wires and logits equal bit for bit; each stage's row
   width, ``stage_bytes``, ``padding_bytes`` and alignment bytes
   printed. Then
   SmolLM-360M at full width and depth: ``make_prefill_step`` on 2048
   random tokens (32 flash_attention + 96 sparse_matmul launches, all
   "mma"), a prefill at T 256 held against the port's CPU forward, and
   ``serve_lm(batch=4, prompt_len=32, gen_tokens=16)`` ((32 + 16) x 96
   sparse_matmul launches, all "gemv", no flash_attention), replayed
   teacher-forced on the CPU; the continuous batcher
   (``runtime/scheduler.ContinuousBatcher``) on SmolLM-360M, 8 slots and
   24 requests (steps x 96 sparse_matmul "gemv", no flash), every
   request teacher-forced alone in its own row on the card and on the
   CPU within 3e-2 of max |logit|; Qwen3-32B at full width and depth (64
   layers): a T 2048 prefill (64 flash "mma" + 192 sparse_matmul "mma"),
   a decode step, layer 0's prompt in 4 chunks of 512 through the cache
   against its one-shot prefill, ``serve_lm(use_reduced=False, batch 4,
   32 + 16)`` and the batcher (4 slots, 8 requests, replayed on the
   card); Mistral-Nemo-12B and Granite-20B at full width and depth (40
   and 52 layers): a prefill and a decode step;
   every layer of the three fed the card's own input within 1 bf16 ulp
   of the CPU layer (a 32-token prefill and decode step 0); then the MoE
   LMs and the VLM at full width and depth: granite-moe-3b-a800m (32
   layers, 40 experts top-8) through a T 2048 prefill (32 flash "mma",
   no sparse_matmul: its blocks hold experts, torch products under
   ``fdot``'s f32 rule), a batch-4 decode step (the rows routed
   together), ``serve_lm(use_reduced=False, batch 4, 32 + 16)`` and the
   continuous batcher (8 slots, 24 requests; one routing group a slot;
   each request held to its teacher-forced replay in the batcher's
   shapes: the same experts and the same bits at every position fed);
   layer 0's experts give the same bits twice at the prefill's and the
   step's shapes;
   moonshot-v1-16b-a3b (48 layers, 64 experts top-6, 28.06B
   parameters) through a prefill (48 flash) and a batch-4 step;
   llava-next-mistral-7b (32 layers) through a prefill of 576 patch
   embeddings and 1472 tokens (32 flash + 96 sparse_matmul "mma") and a
   batch-4 step (96 "gemv"); the share of expert assignments dropped at
   the prefill and the step; every layer against the CPU layer (an MoE
   layer in two halves, the experts fed the card's attention output on
   both devices: expert ids and kept assignments equal and the output
   within 1 bf16 ulp at every token clear of a near tie);
5. timings (CUDA events over CUDA-graph replays, L2-warm): each kernel at
   the main-path shapes beside its plain version, a library call that
   computes the same function (never called by the port; for dw_pw no
   single call does, and the two-call depthwise + 1x1 ``F.conv2d`` pair
   is timed as a labelled yardstick; for flash_attention
   ``F.scaled_dot_product_attention`` on the same expanded tensors) and
   its bound (sparse_conv per layer with its plan, and summed by K); the
   int8 kernels beside the bf16 ones at the same shapes, their bound
   counting a byte a weight; eager and graph p50/p99 of every serving run
   above and the stored bytes of each CNN at each store dtype; the
   kernels at the microbatch shapes (one microbatch forward's launches,
   n 2 and 4) beside their plain versions, bounds and library calls; where
   a tick's time goes (each stage program alone, the stages on one stream,
   one tick on S streams, the same tick of the placed programs on packed
   rows, the plain forward of the microbatch); the continuous server's
   images/s on rows against closures (native, mb 2, S 4, three turns
   each in alternation); SmolLM-360M's prefill latency and
   ``serve_lm``'s times; flash at D 128 and sparse_matmul at 128 x 128
   blocks (M 4, 2048) beside their plain versions, bounds, SDPA and
   ``torch.matmul`` on the densified weight (also at the MoE LMs' and
   the VLM's prefill shapes: flash at D 64 and 128, llava's FFN); the
   large LMs' prefill latencies, Qwen3-32B's ``serve_lm`` times and the
   batchers' tok/s and TTFT; the MoE LMs' and the VLM's prefill and
   decode-step latencies and granite-moe's ``serve_lm`` times;
6. the measured cost model and the tuned kernels: for each CNN at native
   weights, ``tuning.calibrate(..., autotune=True)`` at batch 1 and at mb
   4 (the MobileNets' dw_pw also tuned at n 2, their depthwise on the
   unfused view at n 1); every tuned plan against its plain version at
   the shape it was tuned at, timed beside ``plan()``'s default (dw_pw
   beside the cuDNN pair); S 4 cuts with ``model="measured"`` from each
   cache beside the analytic cut (and the mb-4 cut once more with
   plan()'s kernels), their predicted stage costs beside each stage
   program timed alone at mb 4; ``_serve_cnn`` (batch 16, M 4, S 4)
   under each cut, twice, in turns, its logits equal to the sequential
   forward under the same cache bit for bit, its images/s printed;
   ``n_microbatches=0`` and ``auto_split=True`` once each;
7. the fault-tolerant tier, ResNet-50 at 224 px, S 4, mb 2, its replicas
   on placed stage programs over one shared set of packed rows (the
   workers build theirs from the param blob), through ``serve()``: ``tier=True`` with 2 replicas at native and int8, clean
   and with replica 0 failed at tick 3 (16 requests of 8 images; the
   failed run == the clean run == the sequential forward, microbatch by
   microbatch, bit for bit; each replica's warm-up and capture counted);
   ``procs=2`` with worker 0 and ``hosts=2`` with worker 1 SIGKILLed at
   their first tick (4 requests; == the in-process tier bitwise; each
   worker's launches up to ``ready`` counted); two dial-in workers with
   worker 1's connection killed through a ``NetFaultProxy`` mid-stream
   (its frames swallowed from the submit to the kill, so work is
   outstanding), then a second stream once the respawned worker is ready; images/s of
   one ``CNNPipelineServer`` (built under ``deterministic_convs``, as the
   replicas are) against the tier at R 1, R 2 and R 2 with replica 0
   failed at its tick 120 on the same stream served 8 times, three times
   each, in turns, and the failure's cost in ms; a ``[tier]`` line each;
8. one ``{"kernels": [...]}`` line (each kernel with the knobs it was
   tuned to, and its launches in the tier phase), then the device line
   last.

Per-layer numbers are also written to ``build/chip_smoke.json``.

The first build compiles five sources, one nvcc each, in parallel; the
stored weight type is a template argument: sparse_conv's mma and simt
for bf16 and int8 (simt also f32), sparse_matmul's gemv for bf16 and
int8 x f32 and bf16 inputs at 4 row counts x 3 block sizes (48) and simt
for all three, dw_pw's mma at k 1-7 for bf16 (42) and at k 3 for int8
(6), its simt at k 1-7 for bf16 and at k 3 for int8 and f32.

Serving alone, on the card's machine from the root of a checkout:
``PYTHONPATH=src python -m repro_torch.launch.serve --arch mobilenet_v2
--quantize int8`` (50 requests at 224 px, each a CUDA graph replay;
``--quantize`` native, f32, bf16 or int8); add ``--device cpu
--image-size 32`` for the CPU's plain path.
"""
from __future__ import annotations

import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

# published peaks of one H100 SXM (dense): memory rate, bf16 tensor-core
# and f32 CUDA-core rates
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

IMAGE_SIZE = 224
N_REQUESTS = 50
# throughput serving: the batched executor's batch, microbatches, stages
# and timed replays; the continuous server's requests, images a request
# and microbatch sizes
PIPE_BATCH, PIPE_M, PIPE_S, PIPE_ITERS = 16, 4, 4, 20
PIPE_MB_SIZES = (2, PIPE_BATCH // PIPE_M)
CONT_REQUESTS, CONT_BATCH = 16, 8
# the fault-tolerant tier: requests, images a request and microbatch size
# (in process), requests through the worker processes
TIER_REQUESTS, TIER_BATCH, TIER_MB, TIER_PROC_REQUESTS = 16, 8, 2, 4
# times the 16 requests are served for the images/s comparison, and the
# tick of replica 0 (of ~32 a serving at R 2) at which it fails there
TIER_RATE_ROUNDS, TIER_FAIL_TICK = 8, 120
CONT_MB = {"resnet50": (1, 2), "mobilenet_v1": (2,), "mobilenet_v2": (2,)}
MOBILENETS = ("mobilenet_v1", "mobilenet_v2")
MB_BLOCKS = {"mobilenet_v1": 13, "mobilenet_v2": 17}   # dw_pw / dw nodes
SEED = 0
# the profiler's timed replays a node (calibrate; the autotuner takes half)
TUNE_ITERS = 4
# the port's logits vs its plain CPU forward: the two sum in f32 in other
# orders and may round a bf16 activation the other way, which the next
# layers carry on; at random init max |logit| is ~1e-3 of an activation,
# so the bar is relative to max |logit|
LOGIT_RTOL = 1e-3
# The MobileNets' end-to-end bar. At 224 px and random init their logits
# are ~1e-11 (V1) and ~1e-7 (V2) and hang on few paths, so a bf16
# activation rounded the other way by a sum taken in another order moves
# them by ~1e-3 of max |logit|: on MobileNet-V1 the card lands 1.8e-3
# from the CPU while every node, fed the card's own inputs, is within
# 1 bf16 ulp of the CPU node. check_nodes holds each node to that; it
# does not accumulate.
MB_LOGIT_RTOL = 1e-2
# SmolLM-360M: the card's logits vs the port's CPU path on the same
# weights, relative to max |logit|. 32 layers of bf16 activations whose
# f32 sums the two devices take in other orders: at random init the CPU
# alone moves the logits by 7e-3 (prefill) to 1.2e-2 (a serve_lm step)
# of max |logit| when fdot sums in f64 instead of f32 (measured in every
# run: "sum-order floor"), so the serve_lm steps are held to 3e-2, and
# every layer, fed the card's own input, to 1 bf16 ulp of the CPU layer
# (check_lm_layers), which does not accumulate.
LM = "smollm-360m"
LM_LOGIT_RTOL = 1e-2
LM_SERVE_RTOL = 3e-2
PREFILL_T = 2048
CHECK_T = 256
SERVE = dict(batch=4, prompt_len=32, gen_tokens=16, max_seq=128)


def bf16_tol(ref: torch.Tensor) -> torch.Tensor:
    """1 bf16 ulp: rtol 2**-7 plus an atol of the bf16 spacing at the
    output's scale (sums taken in another order may round either way)."""
    scale = float(ref.abs().max())
    atol = 2.0 ** (math.floor(math.log2(scale)) - 7) if scale > 0 else 0.0
    return 2.0 ** -7 * ref.abs() + atol


def logit_tol(ref: torch.Tensor) -> torch.Tensor:
    """LOGIT_RTOL of max |logit|, for every logit."""
    return torch.full_like(ref, LOGIT_RTOL * float(ref.abs().max()))


def f32_tol(ref: torch.Tensor) -> torch.Tensor:
    """f32 sums in another order: rtol 1e-5 plus 1e-5 of the output's
    scale."""
    return 1e-5 * ref.abs() + 1e-5 * float(ref.abs().max())


def compare(got: torch.Tensor, ref: torch.Tensor, tol_fn, what: str) -> float:
    got, ref = got.float(), ref.float()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{what}: shape {tuple(got.shape)} vs "
                             f"{tuple(ref.shape)} or non-finite output")
    err = (got - ref).abs()
    bad = err > tol_fn(ref)
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} elements beyond "
                             f"tolerance, max |err| {float(err.max()):.3e}")
    return float(err.max())


def time_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Device time of one ``fn()``: ``reps`` calls captured in a CUDA
    graph, replayed ``rounds`` times between two CUDA events, so host
    launch overhead does not enter."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * rounds)


def bound(nbytes: int, ops: int, dtype) -> tuple[float, float]:
    """(ms to move ``nbytes`` at the memory rate, ms to do ``ops`` at the
    peak rate for ``dtype``); the bound is the larger."""
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S[dtype] * 1e3


def bound_by(t_bytes: float, t_ops: float) -> str:
    return "bytes" if t_bytes >= t_ops else "operations"


def variant_str(variants: dict) -> str:
    """The nonzero (kernel, variant) counters as ``kernel/variant: n``."""
    return ", ".join(f"{n}/{v}: {c}" for (n, v), c in variants.items()
                     if c) or "none"


def kernel_name(mangled: str) -> str:
    """``flash_attention_mma<64>`` for a mangled kernel symbol (c++filt,
    where the toolkit's host has it; else the symbol)."""
    filt = shutil.which("c++filt")
    if not filt:
        return mangled
    name = subprocess.run([filt, mangled], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    name = name.replace("(anonymous namespace)::", "")
    return name.removeprefix("void ").split("(")[0]


def ptxas_resources(log: str) -> dict:
    """ptxas's report per entry function of one ``nvcc -Xptxas -v`` log:
    registers, shared memory bytes, spill stores and loads."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = kernel_name(m.group(1))
            out[fn] = {}
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[fn]["spill_stores"], out[fn]["spill_loads"] = map(
                int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[fn]["smem_bytes"] = int(m.group(1)) if m else 0
    return out


def sass_hmma(lib: Path) -> dict | None:
    """HMMA (tensor-core) instructions per kernel function in the SASS of
    ``lib``, or None where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = kernel_name(line.split("Function :")[1].strip())
            out[fn] = 0
        elif fn is not None and re.search(r"\bHMMA\b", line):
            out[fn] += 1
    return out


def conv_input_elems(x_shape, idx, k: int, stride: int, bm: int) -> int:
    """Elements of the NHWC input that the surviving blocks read: the
    union, over the distinct (ky, kx, channel block) of ``idx``, of the
    rows and columns the output pixels reach inside the image (a
    stride-2 1x1 conv reads a quarter of its input)."""
    from repro_torch.kernels.sparse_conv import conv_block_coords, same_pads
    n, h, w, c = x_shape
    ho, ph, _ = same_pads(h, k, stride)
    wo, pw, _ = same_pads(w, k, stride)
    ky, kx, cb = conv_block_coords(idx.long().cpu(), k, c, bm)
    mask = torch.zeros((h, w, c // bm), dtype=torch.bool)
    for a, b, q in set(zip(ky.flatten().tolist(), kx.flatten().tolist(),
                           cb.flatten().tolist())):
        rows = torch.arange(ho) * stride + a - ph
        cols = torch.arange(wo) * stride + b - pw
        rows = rows[(rows >= 0) & (rows < h)]
        cols = cols[(cols >= 0) & (cols < w)]
        mask[rows[:, None], cols[None, :], q] = True
    return n * int(mask.sum()) * bm


# The large dense LMs at full width and depth, 128-wide heads and 128 x
# 128 FFN blocks: Qwen3-32B through prefill, the cache-chunk step,
# serve_lm and the continuous batcher; Mistral-Nemo-12B and Granite-20B
# through a prefill and a decode step (no depth cut: the three take ~110
# s of the script). Every layer, fed the card's own input, is held to the
# CPU layer at 1 bf16 ulp (a prefill of LARGE_CHECK_T tokens and decode
# step 0).
QWEN = "qwen3-32b"
LARGE_LMS = ("qwen3-32b", "mistral-nemo-12b", "granite-20b")
LARGE_CHECK_T = 32
# the cache-chunk step: a prompt of PREFILL_T tokens in CHUNKS chunks
CHUNKS = 4
# the continuous batcher: slots, requests, prompt lengths and new tokens
# ([low, high) from the seed), cache rows
BATCHER = {LM: dict(slots=8, requests=24, prompt=(3, 65), new=(4, 33),
                    max_seq=128),
           QWEN: dict(slots=4, requests=8, prompt=(3, 33), new=(4, 17),
                      max_seq=64)}
QWEN_SERVE = dict(batch=4, prompt_len=32, gen_tokens=16, max_seq=64)
LARGE_MM_M = (1, 2, 3, 4, 5, 6, 7, 8, PREFILL_T)   # gemv rows, then mma
# The MoE LMs and the VLM at full width and depth: granite-moe-3b-a800m
# (40 experts top-8, f 512, D 64) through a prefill, a batch-4 decode
# step, serve_lm and the continuous batcher (BATCHER[LM]'s spec: one
# routing group a slot); moonshot-v1-16b-a3b (64 experts top-6, f 1408,
# D 128; 28.06B parameters) through a prefill and a batch-4 step;
# llava-next-mistral-7b through a prefill of its 576 patch embeddings
# (drawn from the seed) and 1472 tokens, and a batch-4 step. Every layer
# on the card's own input against the CPU layer; an MoE layer in two
# halves, attention, then the experts fed the card's attention output
# on both devices, held at the tokens clear of a near routing tie
# (checks.clear(route, MOE_TIE_MARGIN)).
GRANITE_MOE = "granite-moe-3b-a800m"
MOE_LMS = (GRANITE_MOE, "moonshot-v1-16b-a3b")
VLM = "llava-next-mistral-7b"
BATCHER[GRANITE_MOE] = dict(BATCHER[LM])
MOE_SERVE = dict(QWEN_SERVE)
STEP_BATCH = 4
# the models whose T = PREFILL_T flash (and 128 x 128 FFN) shapes phase 3
# checks and phase 5 times
PREFILL_LMS = LARGE_LMS + MOE_LMS + (VLM,)
FFN_128_LMS = LARGE_LMS + (VLM,)


def param_bytes(tree) -> int:
    """Bytes of every tensor of a parameter tree (a SparseWeight's vals
    and idx)."""
    from repro_torch.models.layers import SparseWeight
    if isinstance(tree, dict):
        return sum(param_bytes(v) for v in tree.values())
    if isinstance(tree, SparseWeight):
        return param_bytes(tree.vals) + param_bytes(tree.idx)
    return tree.numel() * tree.element_size()


def flash_ops(tq: int, tk: int, h: int, d: int, causal: bool,
              window: int, q_offset: int) -> int:
    """Operations of one flash call on this run's masks: 4 * H * D (two
    products of a multiply and an add) per (query, visible key) pair."""
    qpos = torch.arange(tq) + q_offset
    hi = torch.clamp(qpos + 1, max=tk) if causal else torch.full_like(
        qpos, tk)
    lo = torch.clamp(qpos - window + 1, min=0) if window else \
        torch.zeros_like(qpos)
    return 4 * h * d * int((hi - lo).clamp(min=0).sum())


def large_ffn_weights(dev, seed: int) -> dict:
    """{(arch, "w1" | "w2"): SparseWeight} at the FFN shapes of each
    large dense LM and the VLM
    (w3 has w1's), drawn by the models' own law: ``dense_init``, then
    block-balanced pruning at 128 x 128, 85%."""
    from repro_torch.configs import get_config
    from repro_torch.core.sparsity import to_block_balanced
    from repro_torch.models.layers import dense_init
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for name in FFN_128_LMS:
        cfg = get_config(name)
        for w, (d_in, d_out) in (("w1", (cfg.d_model, cfg.d_ff)),
                                 ("w2", (cfg.d_ff, cfg.d_model))):
            out[(name, w)] = to_block_balanced(
                dense_init(gen, (d_in, d_out), d_in), cfg.sparsity)
    return out


def check_lm_layers(cfg, params, layer_cpu, chains: dict, dev, *,
                    moe_log: dict | None = None) -> dict:
    """Each layer on the card against the same layer on the CPU
    (``layer_cpu(l)``: layer l's parameters there, fetched once for all
    chains), fed the card's own input: the bf16 output within 1 bf16
    ulp. ``chains``: {name: (tokens, decode, patches)}, a prefill over
    tokens (B, T) (a VLM's patches (B, Vt, d) in front), or decode step
    0 of tokens (B, 1) into a fresh cache. An MoE layer is held in two
    halves: the attention half, then the experts fed the card's
    attention output on both devices; there the expert ids and kept
    assignments are equal and the output within 1 bf16 ulp at every
    token clear of a near tie (``checks.clear(route, MOE_TIE_MARGIN)``; each
    layer's excluded tokens and drops go to ``moe_log[name]``). Returns
    {name: the worst error as a share of its bar}."""
    from repro_torch import checks
    from repro_torch.models import layers as lm_layers
    from repro_torch.models import lm
    worst = {name: 0.0 for name in chains}

    def held(name, what, got, want, rows=None):
        got, want = got.float(), want.float()
        if rows is not None:
            got = got.reshape(-1, got.shape[-1])[rows]
            want = want.reshape(-1, want.shape[-1])[rows]
            if not rows.any():
                return
        compare(got, want, bf16_tol, f"{cfg.name} {what}")
        share = (got - want).abs() / bf16_tol(want).clamp_min(1e-38)
        worst[name] = max(worst[name], float(share.max()))

    state = {}
    with torch.inference_mode(), lm_layers.full_f32():
        for name, (tokens, decode, patches) in chains.items():
            h = lm._embed(cfg, params, tokens.to(dev))
            if patches is not None:
                h = lm._prefix(cfg, h, {"patches": patches.to(dev)})
            b, t = h.shape[:2]
            pos = torch.arange(t)[None].expand(b, t)
            state[name] = [h, decode, pos, [
                lm.make_block_fn(cfg, pos.to(d)) for d in (dev, "cpu")],
                "decode step 0" if decode else f"prefill T={t}"]
        for l in range(cfg.n_layers):
            layer = ((dev, lm._layer(params["blocks"], l)),
                     ("cpu", layer_cpu(l)))
            for name, st in state.items():
                h, decode, pos, blocks, what = st
                b = h.shape[0]
                what = f"{what} layer {l}"
                fresh_kv = (lambda d: torch.zeros(
                    (2, b, 8, cfg.kv_heads, cfg.head_dim),
                    dtype=torch.bfloat16, device=d))
                if "moe" not in layer[0][1]:
                    outs = []
                    for (d, p), block in zip(layer, blocks):
                        x = h.to(d)
                        outs.append(lm.decode_block(cfg, p, x, fresh_kv(d),
                                                    pos.to(d), 0)
                                    if decode else block(x, p)[0])
                    torch.cuda.synchronize()
                    held(name, what, outs[0].cpu(), outs[1])
                    st[0] = outs[0]
                    continue
                halves = []
                for d, p in layer:
                    x = h.to(d)
                    kw = dict(positions=pos.to(d), window=cfg.attn_window)
                    if decode:
                        kv = fresh_kv(d)
                        kw.update(kv_cache=(kv[0], kv[1]), cache_pos=0)
                    a, _ = lm_layers.attention(p["attn"], cfg,
                                               lm_layers.rms_norm(
                                                   x, p["ln1"], cfg.norm_eps),
                                               **kw)
                    halves.append(x + a)
                torch.cuda.synchronize()
                held(name, f"{what} attention half", halves[0].cpu(),
                     halves[1])
                outs, routes = [], []
                for d, p in layer:
                    with lm_layers.record_moe() as rec:
                        outs.append(lm._mlp(cfg, p, halves[0].to(d))[0])
                    routes += rec
                torch.cuda.synchronize()
                clear = checks.clear(routes[1], checks.MOE_TIE_MARGIN)[0]
                ids = [r.eidx[0].cpu().sort(-1).values[clear] for r in routes]
                kept = [r.kept[0].cpu()[clear] for r in routes]
                if not (torch.equal(*ids) and torch.equal(*kept)):
                    raise AssertionError(
                        f"{cfg.name} {what}: the card routes "
                        f"{int((ids[0] != ids[1]).any(-1).sum())} clear "
                        f"tokens to other experts, keeps other assignments "
                        f"at {int((kept[0] != kept[1]).any(-1).sum())}")
                held(name, f"{what} experts", outs[0].cpu(), outs[1],
                     rows=clear)
                if moe_log is not None:
                    moe_log[name].append({
                        "layer": l, "tokens": int(clear.numel()),
                        "excluded": int((~clear).sum()),
                        "dropped": int(routes[1].dropped)})
                st[0] = outs[0]
    return worst


def batcher_requests(cfg, spec: dict, seed: int) -> list:
    """The batcher's requests, from ``seed``: prompt lengths and new
    tokens uniform in the spec's [low, high)."""
    rng = np.random.default_rng(seed)
    return [dict(rid=rid, prompt=rng.integers(
        0, cfg.vocab_size, size=int(rng.integers(*spec["prompt"]))
    ).astype(np.int32), max_new_tokens=int(rng.integers(*spec["new"])))
        for rid in range(spec["requests"])]


def step_routes(routes: list):
    """The routes of one decode step of one token a row, layer by layer:
    each row's sorted expert ids (B, L, k) on the host, or None without
    experts."""
    if not routes:
        return None
    return torch.stack([r.eidx.reshape(-1, r.eidx.shape[-1]).sort(-1).values
                        for r in routes], 1).cpu()


def run_batcher(cfg, params, reqs: list, spec: dict, dev):
    """Serve ``reqs`` through ``ContinuousBatcher`` on the card, every
    request submitted at the start. Returns (batcher, finished, {rid:
    {pos: its logits (V,) on the host}}, {rid: {pos: its sorted expert
    ids (L, k)}} for an MoE model): each step's logits are
    copied to the host for the check, beside the batcher's own argmax
    read."""
    from repro_torch.models import layers as lm_layers
    from repro_torch.runtime.scheduler import (ContinuousBatcher, Request,
                                               make_per_slot_decode,
                                               make_slot_cache)
    decode = make_per_slot_decode(cfg)
    by_req: dict = {r["rid"]: {} for r in reqs}
    routed: dict = {r["rid"]: {} for r in reqs}
    cb = None

    def recording(p, cache, toks, pos):
        with lm_layers.record_moe() as routes:
            lg, cache = decode(p, cache, toks, pos)
        rows, host = lg[:, -1].float().cpu(), pos.cpu().tolist()
        step = step_routes(routes)
        for i, st in enumerate(cb.state):
            if st.rid >= 0:
                by_req[st.rid][host[i]] = rows[i]
                if step is not None:
                    routed[st.rid][host[i]] = step[i]
        return lg, cache

    cb = ContinuousBatcher(
        cfg, params, slots=spec["slots"], max_seq=spec["max_seq"],
        decode_fn=recording,
        init_cache_fn=lambda c, s, m: make_slot_cache(c, s, m, device=dev))
    for kw in reqs:
        cb.submit(Request(**kw))
    with torch.inference_mode():
        done = cb.run()
    torch.cuda.synchronize()
    cb.decode_fn = None            # the closure holds cb: break the cycle
    return cb, done, by_req, routed


def replay_rows(cfg, params, seqs: list, device, *,
                group: int | None = None, max_seq: int | None = None):
    """Each sequence teacher-forced in its own row of a ``decode_step``
    batch from position 0 (its own cache row): (the logits (B, L, V) f32
    on the host, positions past a sequence's end padded and ignored; for
    an MoE model each row's sorted expert ids (B, L, layers, k), else
    None). A dense model takes all rows in one batch at an int position.
    An MoE model takes a (B,) position (each row routed alone, as the
    batcher routes a slot). Rows go in batches of ``group`` (default:
    all of them) over a cache of ``max_seq`` positions (default: the
    longest sequence); given the batcher's slots and max_seq, each step
    has the batcher's shapes, so a row's sums run in the batcher's order
    and give its bits."""
    from repro_torch.models import layers as lm_layers
    from repro_torch.models import lm
    moe = cfg.family == "moe"
    n = max(len(s) for s in seqs)
    group, max_seq = group or len(seqs), max_seq or n
    logits, ids = [], []
    for g0 in range(0, len(seqs), group):
        part = seqs[g0:g0 + group]
        toks = np.zeros((group, n), np.int64)
        for r, s in enumerate(part):
            toks[r, :len(s)] = s
        cache = lm.init_cache(cfg, group, max_seq, device=device)
        out, out_ids = [], []
        with torch.inference_mode():
            for i in range(max(len(s) for s in part)):
                pos = torch.full((group,), i, device=device) if moe else i
                with lm_layers.record_moe() as routes:
                    lg, cache = lm.decode_step(
                        cfg, params, cache,
                        torch.from_numpy(toks[:, i:i + 1]).to(device), pos)
                out.append(lg[:, 0].float().cpu())
                step = step_routes(routes)
                if step is not None:
                    out_ids.append(step)
        pad = n - len(out)
        lg = torch.stack(out, 1)[:len(part)]
        logits.append(F.pad(lg, (0, 0, 0, pad)))
        if out_ids:
            got = torch.stack(out_ids, 1)[:len(part)]
            ids.append(F.pad(got, (0, 0, 0, 0, 0, pad), value=-1))
    return torch.cat(logits), (torch.cat(ids) if ids else None)


def routing_equal(name: str, reqs: list, routed: dict, replay_ids) -> int:
    """Every request the batcher and its replay (in the batcher's shapes)
    route to the same experts in every layer at every position it was
    fed; returns the positions compared."""
    compared = 0
    for row, r in enumerate(reqs):
        for p, ids in sorted(routed[r["rid"]].items()):
            differ = (ids != replay_ids[row, p]).any(-1)
            if differ.any():
                raise AssertionError(
                    f"{name} batcher request {r['rid']} pos {p}: the batcher "
                    f"and its replay route it to other experts from layer "
                    f"{int(differ.nonzero()[0, 0])}")
            compared += 1
    return compared


def check_batcher(name: str, reqs: list, done: list, by_req: dict,
                  replays: dict, bar: float) -> dict:
    """Every request's logits at every position it was fed against its
    teacher-forced replay (``replays``: {where: (B, L, V)}, rows in the
    order of ``reqs``) within ``bar`` of max |logit|; its tokens are the
    argmax of its logits, and the replay's where the replay's top-2 gap
    exceeds the bar. Returns the worst errors, the token count checked
    and the positions bitwise the replay's, against each replay."""
    row = {r["rid"]: i for i, r in enumerate(reqs)}
    worst = {w: 0.0 for w in replays}
    gap_checked = {w: 0 for w in replays}
    bitwise = {w: 0 for w in replays}
    for req in done:
        tp = len(req.prompt)
        seq_len = tp + len(req.tokens) - 1        # positions fed
        if sorted(by_req[req.rid]) != list(range(seq_len)):
            raise AssertionError(f"{name} batcher request {req.rid}: fed "
                                 f"positions {sorted(by_req[req.rid])}")
        for p in range(seq_len):
            got = by_req[req.rid][p]
            if p >= tp - 1 and int(got.argmax()) != req.tokens[p - tp + 1]:
                raise AssertionError(f"{name} batcher request {req.rid} "
                                     f"pos {p}: token is not the argmax")
            for where, rep in replays.items():
                want = rep[row[req.rid], p]
                bitwise[where] += int(torch.equal(got, want))
                scale = float(want.abs().max())
                err = float((got - want).abs().max()) / scale
                worst[where] = max(worst[where], err)
                if not err <= bar:
                    raise AssertionError(
                        f"{name} batcher request {req.rid} pos {p}: vs its "
                        f"{where} replay max |err| / max |logit| {err:.3e} "
                        f"> {bar}")
                top2 = want.topk(2).values
                if p >= tp - 1 and float(top2[0] - top2[1]) > bar * scale:
                    if int(want.argmax()) != req.tokens[p - tp + 1]:
                        raise AssertionError(
                            f"{name} batcher request {req.rid} pos {p}: "
                            f"token differs from the {where} replay's where "
                            f"its top-2 gap exceeds the bar")
                    gap_checked[where] += 1
    return {"worst": worst, "tokens_checked": gap_checked,
            "tokens": sum(len(r.tokens) for r in done),
            "positions_bitwise": bitwise}


def large_lm_run(name: str, h) -> dict:
    """One large dense LM at full width on the card (``h``: the launch
    bookkeeping of ``main``): its weights from the seed, a T = 2048
    prefill and a decode step with their launches by name and variant,
    every layer against the CPU layer; for Qwen3-32B also the
    cache-chunk step, ``serve_lm`` and the continuous batcher."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_lm
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import layers as lm_layers
    from repro_torch.models import lm
    dev = h.dev
    cfg = get_config(name)
    n_l = cfg.n_layers
    res = {"layers": n_l}
    print(f"[main] {name}: d_model {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.head_dim} ({cfg.kv_heads} KV), d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, FFN blocks {cfg.sparsity.block_m} x "
          f"{cfg.sparsity.block_n} {cfg.sparsity.sparsity:.0%} pruned; "
          f"{n_l} layers, the published depth (no cut)")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED))
    torch.cuda.synchronize()
    res["init_s"] = time.perf_counter() - t0
    res["param_bytes"] = param_bytes(params)
    # the peak of drawing the weights (the stack allocated once, one
    # layer's tree at a time drawn into it), and what it added to what
    # the script held before
    res["init_peak_bytes"] = torch.cuda.max_memory_allocated()
    res["held_before_bytes"] = before
    toks = torch.randint(0, cfg.vocab_size, (1, PREFILL_T),
                         generator=torch.Generator().manual_seed(
                             SEED + 19)).to(dev)

    # the prompt in one forward: flash at D 128, the FFN through mma
    prefill = make_prefill_step(cfg)
    ops.reset_launches()
    t0 = time.perf_counter()
    last = prefill(params, toks)
    torch.cuda.synchronize()
    res["prefill_first_s"] = time.perf_counter() - t0
    res["prefill_launches"] = h.count(
        f"{name} prefill T={PREFILL_T}",
        {"flash_attention": n_l, "sparse_matmul": 3 * n_l},
        {("flash_attention", "mma"): n_l, ("sparse_matmul", "mma"): 3 * n_l})
    if last.shape != (1, cfg.vocab_size) or not torch.isfinite(last).all():
        raise AssertionError(f"{name} prefill: logits {tuple(last.shape)} "
                             f"not finite (1, {cfg.vocab_size})")
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        prefill(params, toks)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    res["prefill_s_runs"] = runs
    res["prefill_ms"] = sorted(runs)[1] * 1e3

    # one decode step: the FFN through gemv, no flash
    cache = lm.init_cache(cfg, 1, 8, device=dev)
    ops.reset_launches()
    lg, _ = lm.decode_step(cfg, params, cache, toks[:, :1], 0)
    torch.cuda.synchronize()
    res["decode_launches"] = h.count(
        f"{name} decode step", {"sparse_matmul": 3 * n_l},
        {("sparse_matmul", "gemv"): 3 * n_l})
    if not torch.isfinite(lg).all():
        raise AssertionError(f"{name} decode step: non-finite logits")
    del cache

    # every layer on the card's own input against the CPU layer
    def layer_cpu(l):
        return lm.params_to(lm._layer(params["blocks"], l), "cpu")

    check_toks = toks[:, :LARGE_CHECK_T].cpu()
    t0 = time.perf_counter()
    res["layer_err"] = check_lm_layers(
        cfg, params, layer_cpu, {"prefill": (check_toks, False, None),
                                 "decode": (check_toks[:, :1], True, None)},
        dev)
    res["layer_check_s"] = time.perf_counter() - t0
    print(f"[main] {name}: weights {res['param_bytes'] / 2**30:.2f} GiB in "
          f"{res['init_s']:.1f} s (peak {res['init_peak_bytes'] / 2**30:.2f} "
          f"GiB, of it {res['held_before_bytes'] / 2**30:.2f} GiB held before"
          f"); prefill T={PREFILL_T} launches "
          f"{res['prefill_launches']}, {res['prefill_ms']:.3f} ms (median of "
          f"3, first {res['prefill_first_s']:.3f} s); decode step launches "
          f"{res['decode_launches']}; every layer on the card's own input "
          f"within 1 bf16 ulp of the CPU layer (prefill T={LARGE_CHECK_T} "
          f"worst share {res['layer_err']['prefill']:.3f}, decode step 0 "
          f"{res['layer_err']['decode']:.3f}; {res['layer_check_s']:.1f} s)")
    if name != QWEN:
        del params
        torch.cuda.empty_cache()
        return res

    # the cache-chunk step: layer 0's prompt in CHUNKS chunks into its
    # cache (flash with q_offset over the cache prefix) against the
    # one-shot prefill of the same layer
    ct = PREFILL_T // CHUNKS
    p0 = lm._layer(params["blocks"], 0)
    with torch.inference_mode(), lm_layers.full_f32():
        x0 = lm._embed(cfg, params, toks)
        positions = torch.arange(PREFILL_T, device=dev)[None]
        one = lm.make_block_fn(cfg, positions)(x0, p0)[0]
        kv = torch.zeros((2, 1, PREFILL_T, cfg.kv_heads, cfg.head_dim),
                         dtype=torch.bfloat16, device=dev)
        ops.reset_launches()
        parts = [lm.decode_block(cfg, p0, x0[:, c * ct:(c + 1) * ct], kv,
                                 positions[:, c * ct:(c + 1) * ct], c * ct)
                 for c in range(CHUNKS)]
        torch.cuda.synchronize()
    res["chunk_launches"] = h.count(
        f"{name} layer 0 in {CHUNKS} chunks",
        {"flash_attention": CHUNKS, "sparse_matmul": 3 * CHUNKS},
        {("flash_attention", "mma"): CHUNKS,
         ("sparse_matmul", "mma"): 3 * CHUNKS})
    res["chunk_err"] = compare(torch.cat(parts, 1), one, bf16_tol,
                               f"{name} layer 0 in {CHUNKS} chunks vs one")
    res["chunk_bitwise"] = bool(torch.equal(torch.cat(parts, 1), one))
    del x0, one, kv, parts
    print(f"[main] {name} cache-chunk step: layer 0's {PREFILL_T}-token "
          f"prompt in {CHUNKS} chunks of {ct} (q_offset 0, {ct}, ...) "
          f"launches {res['chunk_launches']}; within 1 bf16 ulp of the "
          f"one-shot prefill (max |err| {res['chunk_err']:.3e}, bitwise "
          f"{res['chunk_bitwise']})")

    # serve_lm at full size: the prompts stepped through the cache, then
    # greedy decoding; every step through gemv, no flash
    ops.reset_launches()
    sout = serve_lm(name, use_reduced=False, params=params,
                    generator=torch.Generator(device=dev).manual_seed(SEED),
                    record_logits=True, verbose=False, device="cuda",
                    **QWEN_SERVE)
    n_steps = QWEN_SERVE["prompt_len"] + QWEN_SERVE["gen_tokens"]
    res["serve_launches"] = h.count(
        f"{name} serve_lm ({n_steps} decode steps)",
        {"sparse_matmul": n_steps * 3 * n_l},
        {("sparse_matmul", "gemv"): n_steps * 3 * n_l})
    slog = sout["logits"]
    if slog.shape != (QWEN_SERVE["batch"], n_steps, cfg.vocab_size) or \
            not torch.isfinite(slog).all():
        raise AssertionError(f"{name} serve_lm: logits {tuple(slog.shape)} "
                             f"not finite")
    gen_from = QWEN_SERVE["prompt_len"] - 1
    if not np.array_equal(sout["tokens"], slog[:, gen_from:-1].argmax(
            -1).numpy()):
        raise AssertionError(f"{name} serve_lm: tokens are not the argmax")
    res["serve"] = {k: sout[k] for k in ("prefill_s", "decode_s",
                                         "tokens_per_s")}
    print(f"[main] {name} serve_lm batch {QWEN_SERVE['batch']}, prompt "
          f"{QWEN_SERVE['prompt_len']}, {QWEN_SERVE['gen_tokens']} tokens: "
          f"launches {res['serve_launches']}; prefill "
          f"{sout['prefill_s']:.4f} s, decode {sout['decode_s']:.4f} s, "
          f"{sout['tokens_per_s']:.2f} tok/s; logits finite, tokens their "
          f"argmax")
    del sout, slog

    res["batcher"] = batcher_phase(name, cfg, params, n_l, h)
    del params
    torch.cuda.empty_cache()
    return res


def batcher_phase(name: str, cfg, params, n_l: int, h, params_cpu=None):
    """The continuous batcher on ``cfg`` (BATCHER[name]): launches
    counted over the run (steps x 3 x layers ``sparse_matmul`` gemv for
    a pruned FFN, nothing hand-written for MoE experts; no flash), every
    request replayed alone, teacher-forced in its own row, on the card
    (and on the CPU, given ``params_cpu``). An MoE model's card replay
    runs in the batcher's shapes (its slots, its max_seq, one routing
    group a row): every fed position routed alike and bitwise the
    batcher's."""
    from repro_torch.kernels import ops
    spec = BATCHER[name]
    reqs = batcher_requests(cfg, spec, SEED + 17)
    ops.reset_launches()
    cb, done, by_req, routed = run_batcher(cfg, params, reqs, spec, h.dev)
    ffn = cb.steps * 3 * n_l if "ffn" in params["blocks"] else 0
    launches = h.count(f"{name} ContinuousBatcher ({cb.steps} steps)",
                       {"sparse_matmul": ffn},
                       {("sparse_matmul", "gemv"): ffn} if ffn else {})
    if len(done) != len(reqs):
        raise AssertionError(f"{name} batcher: {len(done)} of {len(reqs)} "
                             f"requests finished")
    stats = cb.stats()
    fed = {r.rid: np.concatenate([r.prompt, np.asarray(r.tokens[:-1],
                                                       np.int32)])
           for r in done}
    seqs = [fed[r["rid"]] for r in reqs]
    moe = "moe" in params["blocks"]
    shapes = dict(group=spec["slots"], max_seq=spec["max_seq"]) if moe \
        else {}
    replays = {}
    replays["card"], replay_ids = replay_rows(cfg, params, seqs, h.dev,
                                              **shapes)
    if params_cpu is not None:
        replays["CPU"] = replay_rows(cfg, params_cpu, seqs, "cpu")[0]
    chk = check_batcher(name, reqs, done, by_req, replays, LM_SERVE_RTOL)
    steps_alone = sum(len(s) for s in seqs)
    if moe:
        chk["positions_routed_alike"] = routing_equal(name, reqs, routed,
                                                      replay_ids)
        if chk["positions_bitwise"]["card"] != steps_alone:
            raise AssertionError(
                f"{name} batcher: {chk['positions_bitwise']['card']} of "
                f"{steps_alone} fed positions bitwise their replay's in the "
                f"batcher's shapes")
    print(f"[main] {name} ContinuousBatcher {spec['slots']} slots, "
          f"{len(reqs)} requests (prompts {spec['prompt'][0]}-"
          f"{spec['prompt'][1] - 1}, {spec['new'][0]}-{spec['new'][1] - 1} "
          f"new tokens): {cb.steps} steps (one at a time: {steps_alone}), "
          f"{stats['tokens']} tokens, {stats['throughput_tok_s']:.2f} tok/s, "
          f"mean TTFT {stats['mean_ttft_s']:.4f} s, mean latency "
          f"{stats['mean_latency_s']:.4f} s; launches {launches}; every "
          f"request against its teacher-forced replay within "
          f"{LM_SERVE_RTOL} of max |logit| "
          f"({ {w: f'{e:.3e}' for w, e in chk['worst'].items()} }), tokens "
          f"equal where the replay's top-2 gap exceeds the bar "
          f"({chk['tokens_checked']} of {chk['tokens']})" +
          ("" if not moe else
           f"; each slot routed alone; the replay in the batcher's shapes "
           f"routes all {chk['positions_routed_alike']} fed positions "
           f"alike and gives their bits ({chk['positions_bitwise']})"))
    return {"spec": {k: list(v) if isinstance(v, tuple) else v
                     for k, v in spec.items()},
            "steps": cb.steps, "steps_one_at_a_time": steps_alone,
            "launches": launches, "stats": stats, "check": chk}


def dropped_share(routes: list) -> float:
    """Expert assignments dropped (their expert full) over those made,
    across ``routes`` (``MoERoute`` s)."""
    made = sum(r.eidx.numel() for r in routes)
    return sum(int(r.dropped) for r in routes) / max(made, 1)


def moe_vlm_run(name: str, h) -> dict:
    """An MoE LM or the VLM at full width and depth on the card (``h``:
    the launch bookkeeping of ``main``): its weights from the seed (their
    bytes and the peak of drawing them), a T = PREFILL_T prefill (the
    VLM: its patch embeddings, drawn from the seed, in front of PREFILL_T
    - vision_tokens tokens) and a batch-4 decode step at one int
    position (the 4 rows routed together), each with its launches by
    name and variant, its time and the share of expert assignments
    dropped; every layer against the CPU layer; for granite-moe also
    ``serve_lm`` and the continuous batcher (one routing group a
    slot)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_lm
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import layers as lm_layers
    from repro_torch.models import lm
    dev = h.dev
    cfg = get_config(name)
    n_l, vt = cfg.n_layers, cfg.vision_tokens
    moe = cfg.family == "moe"
    ffn = 0 if moe else 3 * n_l                 # sparse_matmul a prefill
    res = {"layers": n_l, "family": cfg.family}
    print(f"[main] {name} ({cfg.family}): d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.head_dim} ({cfg.kv_heads} KV), "
          + (f"{cfg.n_experts} experts top-{cfg.top_k}, expert FFN "
             f"{cfg.moe_d_ff}" if moe else
             f"d_ff {cfg.d_ff}, FFN blocks {cfg.sparsity.block_m} x "
             f"{cfg.sparsity.block_n} {cfg.sparsity.sparsity:.0%} pruned, "
             f"{vt} patch embeddings a prompt") +
          f", vocab {cfg.vocab_size}; {n_l} layers, the published depth "
          f"(no cut)")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res["held_before_bytes"] = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED))
    torch.cuda.synchronize()
    res["init_s"] = time.perf_counter() - t0
    res["param_bytes"] = param_bytes(params)
    res["init_peak_bytes"] = torch.cuda.max_memory_allocated()
    res["card_bytes"] = torch.cuda.get_device_properties(dev).total_memory
    toks = torch.randint(0, cfg.vocab_size, (1, PREFILL_T - vt),
                         generator=torch.Generator().manual_seed(
                             SEED + 19)).to(dev)
    extra = {}
    if vt:
        extra["patches"] = torch.randn(
            (1, vt, cfg.d_model), device=dev, generator=torch.Generator(
                device=dev).manual_seed(SEED + 23)).to(torch.bfloat16)

    # the prompt in one forward: flash (and the VLM's FFN through mma)
    prefill = make_prefill_step(cfg)
    ops.reset_launches()
    with lm_layers.record_moe() as routes:
        t0 = time.perf_counter()
        last = prefill(params, toks, **extra)
        torch.cuda.synchronize()
    res["prefill_first_s"] = time.perf_counter() - t0
    res["prefill_launches"] = h.count(
        f"{name} prefill T={PREFILL_T}",
        {"flash_attention": n_l, "sparse_matmul": ffn},
        {("flash_attention", "mma"): n_l,
         **({("sparse_matmul", "mma"): ffn} if ffn else {})})
    res["prefill_dropped"] = dropped_share(routes) if moe else None
    del routes
    if last.shape != (1, cfg.vocab_size) or not torch.isfinite(last).all():
        raise AssertionError(f"{name} prefill: logits {tuple(last.shape)} "
                             f"not finite (1, {cfg.vocab_size})")
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        prefill(params, toks, **extra)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    res["prefill_s_runs"] = runs
    res["prefill_ms"] = sorted(runs)[1] * 1e3

    # one decode step at batch 4, one int position: the rows routed
    # together (the VLM's FFN through gemv), then three more timed
    step_toks = torch.randint(0, cfg.vocab_size, (STEP_BATCH, 1),
                              generator=torch.Generator().manual_seed(
                                  SEED + 29)).to(dev)
    cache = lm.init_cache(cfg, STEP_BATCH, 8, device=dev)
    ops.reset_launches()
    with torch.inference_mode(), lm_layers.record_moe() as routes:
        lg, _ = lm.decode_step(cfg, params, cache, step_toks, 0)
    torch.cuda.synchronize()
    res["decode_launches"] = h.count(
        f"{name} decode step (batch {STEP_BATCH})", {"sparse_matmul": ffn},
        {("sparse_matmul", "gemv"): ffn} if ffn else {})
    res["step_dropped"] = dropped_share(routes) if moe else None
    res["step_cap"] = routes[0].cap if moe else None
    del routes
    if lg.shape != (STEP_BATCH, 1, cfg.vocab_size) or \
            not torch.isfinite(lg).all():
        raise AssertionError(f"{name} decode step: logits not finite")
    runs = []
    with torch.inference_mode():
        for i in range(1, 4):
            t0 = time.perf_counter()
            lm.decode_step(cfg, params, cache, step_toks, i)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
    res["step_ms"] = sorted(runs)[1] * 1e3
    del cache, lg

    # the MoE combine adds in one fixed order: layer 0's experts on the
    # prompt's normed embeddings give the same bits twice, at the
    # prefill's shape and at the batch-4 step's
    if moe:
        p0 = lm._layer(params["blocks"], 0)
        with torch.inference_mode():
            x0 = lm_layers.rms_norm(lm._embed(cfg, params, toks), p0["ln2"],
                                    cfg.norm_eps)
            for x in (x0, x0[0, :STEP_BATCH, None]):
                a, b = (lm_layers.moe(p0["moe"], cfg, x)[0] for _ in range(2))
                torch.cuda.synchronize()
                if not torch.equal(a.view(torch.int16), b.view(torch.int16)):
                    raise AssertionError(
                        f"{name} layer 0 experts at {tuple(x.shape)}: two "
                        f"runs give other bits")
        res["combine_bitwise"] = True
        del x0, a, b

    # every layer on the card's own input against the CPU layer (a VLM
    # prompt: half patches, half tokens)
    def layer_cpu(l):
        return lm.params_to(lm._layer(params["blocks"], l), "cpu")

    ct = LARGE_CHECK_T
    check_toks = toks[:, :ct // 2 if vt else ct].cpu()
    patches = extra["patches"][:, :ct // 2] if vt else None
    moe_log = {"prefill": [], "decode": []}
    t0 = time.perf_counter()
    res["layer_err"] = check_lm_layers(
        cfg, params, layer_cpu, {"prefill": (check_toks, False, patches),
                                 "decode": (check_toks[:, :1], True, None)},
        dev, moe_log=moe_log)
    res["layer_check_s"] = time.perf_counter() - t0
    res["layer_moe"] = moe_log
    excluded = {k: [r["excluded"] for r in v] for k, v in moe_log.items()}
    print(f"[main] {name}: weights {res['param_bytes'] / 2**30:.2f} GiB in "
          f"{res['init_s']:.1f} s (init peak "
          f"{res['init_peak_bytes'] / 2**30:.2f} GiB of "
          f"{res['card_bytes'] / 2**30:.2f}, of it "
          f"{res['held_before_bytes'] / 2**30:.2f} GiB held before); "
          f"prefill T={PREFILL_T}"
          + (f" ({vt} patches + {PREFILL_T - vt} tokens)" if vt else "") +
          f" launches {res['prefill_launches']}, {res['prefill_ms']:.3f} ms "
          f"(median of 3, first {res['prefill_first_s']:.3f} s); decode step "
          f"batch {STEP_BATCH} launches {res['decode_launches']}, "
          f"{res['step_ms']:.3f} ms (median of 3)" +
          (f"; assignments dropped: prefill {res['prefill_dropped']:.4f}, "
           f"batch-{STEP_BATCH} step {res['step_dropped']:.4f} (cap "
           f"{res['step_cap']}); layer 0's experts the same bits twice at "
           f"(1, {PREFILL_T - vt}) and ({STEP_BATCH}, 1) tokens"
           if moe else "") +
          f"; every layer on the card's own input within 1 bf16 ulp of the "
          f"CPU layer (prefill T={ct} worst share "
          f"{res['layer_err']['prefill']:.3f}, decode step 0 "
          f"{res['layer_err']['decode']:.3f}; {res['layer_check_s']:.1f} s)"
          + (f"; MoE halves: tokens excluded by the tie margin a layer "
             f"{excluded} of {ct} / 1, routing equal elsewhere"
             if moe else ""))
    if name != GRANITE_MOE:
        del params
        torch.cuda.empty_cache()
        return res

    # serve_lm at full size: the prompts stepped through the cache, the
    # batch's 4 rows routed together each step, then greedy decoding
    ops.reset_launches()
    sout = serve_lm(name, use_reduced=False, params=params,
                    generator=torch.Generator(device=dev).manual_seed(SEED),
                    record_logits=True, verbose=False, device=dev,
                    **MOE_SERVE)
    n_steps = MOE_SERVE["prompt_len"] + MOE_SERVE["gen_tokens"]
    res["serve_launches"] = h.count(
        f"{name} serve_lm ({n_steps} decode steps)", {}, {})
    slog = sout["logits"]
    if slog.shape != (MOE_SERVE["batch"], n_steps, cfg.vocab_size) or \
            not torch.isfinite(slog).all():
        raise AssertionError(f"{name} serve_lm: logits {tuple(slog.shape)} "
                             f"not finite")
    gen_from = MOE_SERVE["prompt_len"] - 1
    if not np.array_equal(sout["tokens"], slog[:, gen_from:-1].argmax(
            -1).numpy()):
        raise AssertionError(f"{name} serve_lm: tokens are not the argmax")
    res["serve"] = {k: sout[k] for k in ("prefill_s", "decode_s",
                                         "tokens_per_s")}
    print(f"[main] {name} serve_lm batch {MOE_SERVE['batch']}, prompt "
          f"{MOE_SERVE['prompt_len']}, {MOE_SERVE['gen_tokens']} tokens: "
          f"launches {res['serve_launches'] or 'none'} (no hand-written "
          f"kernel in an MoE decode step); TTFT (the prompts' "
          f"{MOE_SERVE['prompt_len']} steps and the first argmax) "
          f"{sout['prefill_s']:.4f} s, decode "
          f"{sout['decode_s']:.4f} s, {sout['tokens_per_s']:.2f} tok/s; "
          f"logits finite, tokens their argmax")
    del sout, slog
    res["batcher"] = batcher_phase(name, cfg, params, n_l, h)
    del params
    torch.cuda.empty_cache()
    return res


def large_timings(flash_inputs: dict, mm_inputs: dict) -> tuple[list, list]:
    """The new kernel shapes timed beside their plain versions, their
    bound and their library call: flash at D 128 (SDPA on the same
    expanded tensors; a cache chunk takes an explicit causal mask), the
    sparse matmul at 128 x 128 blocks (``torch.matmul`` on the densified
    bf16 weight)."""
    from repro_torch.core.sparsity import densify
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import sparse_matmul as sm
    flash_rows = []
    for what, (q, k, v, kw) in flash_inputs.items():
        b, tq, h, d = q.shape
        tk = k.shape[1]
        qt, kt, vt = (t.permute(0, 2, 1, 3) for t in (q, k, v))
        off = kw.get("q_offset", 0)
        if off == 0 and tq == tk:
            def lib():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True)
        else:
            mask = (torch.arange(tk, device=q.device)[None, :] <=
                    torch.arange(off, off + tq, device=q.device)[:, None])

            def lib():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=mask)
        ms = time_ms(lambda: fa.flash_attention(q, k, v, **kw))
        plain = time_ms(lambda: fa.flash_attention_torch(q, k, v, **kw),
                        reps=2, rounds=2)
        lib_ms = time_ms(lib)
        t_b, t_o = bound((2 * q.numel() + 2 * k.numel()) * q.element_size(),
                         b * flash_ops(tq, tk, h, d, True, 0, off),
                         torch.bfloat16)
        flash_rows.append({"what": what, "shape": [b, tq, tk, h, d],
                           "q_offset": off, "variant": fa.variant(q.dtype, d),
                           "ms": ms, "plain_ms": plain, "library_ms": lib_ms,
                           "bound_ms": max(t_b, t_o),
                           "bound_by": bound_by(t_b, t_o)})
        print(f"[time] flash_attention {what} (B {b}, Tq {tq}, Tk {tk}, H "
              f"{h}, D {d}, bf16, causal, {flash_rows[-1]['variant']}): "
              f"kernel {ms * 1e3:.3f} us, plain {plain * 1e3:.3f} us, SDPA "
              f"{lib_ms * 1e3:.3f} us, bound {max(t_b, t_o) * 1e3:.3f} us "
              f"({bound_by(t_b, t_o)})")
    mm_rows = []
    for (name, w, m), (x, sw) in mm_inputs.items():
        ob, n_k, bm, bn = sw.vals.shape
        w_dense = densify(sw)
        ms = time_ms(lambda: sm.sparse_matmul(x, sw.vals, sw.idx))
        plain = time_ms(lambda: sm.sparse_matmul_torch(x, sw.vals, sw.idx),
                        reps=2 if m > 8 else 20, rounds=2 if m > 8 else 5)
        lib_ms = time_ms(lambda: torch.matmul(x, w_dense))
        del w_dense
        x_elems = m * int(sw.idx.unique().numel()) * bm
        nbytes = (x_elems * 2 + sw.vals.numel() * 2 + sw.idx.numel() * 4
                  + m * ob * bn * 2)
        t_b, t_o = bound(nbytes, 2 * m * ob * n_k * bm * bn, torch.bfloat16)
        var = sm.variant(x.dtype, m, bm, bn)
        mm_rows.append({"arch": name, "weight": w, "M": m,
                        "vals": list(sw.vals.shape), "variant": var,
                        "ms": ms, "plain_ms": plain, "library_ms": lib_ms,
                        "bound_ms": max(t_b, t_o),
                        "bound_by": bound_by(t_b, t_o)})
        print(f"[time] sparse_matmul {name} {w} M={m} vals "
              f"{tuple(sw.vals.shape)} bf16 ({var}): kernel "
              f"{ms * 1e3:.3f} us, plain {plain * 1e3:.3f} us, torch.matmul "
              f"(dense bf16) {lib_ms * 1e3:.3f} us, bound "
              f"{max(t_b, t_o) * 1e3:.3f} us ({bound_by(t_b, t_o)})")
    return flash_rows, mm_rows


def main() -> int:
    # -- 1. device --------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "card", file=sys.stderr)
        return 1
    from repro_torch.configs import SparsityConfig, get_config
    from repro_torch.core import pipeline as pp
    from repro_torch.core import planner
    from repro_torch.core.fusion import conv_part, fused_graph_for
    from repro_torch.core.graph import INPUT, graph_for
    from repro_torch.core.quant import (STORE_DTYPES, pytree_param_bytes,
                                        quantize_tree)
    from repro_torch.core.sparsity import densify, to_block_balanced
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import depthwise_conv as dwk
    from repro_torch.kernels import dw_pw_fused as dwpw
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import sparse_conv as sc
    from repro_torch.kernels import sparse_matmul as sm
    from repro_torch.launch.serve import (CNNPipelineServer, ServeConfig,
                                          _init_native, _serve_cnn,
                                          _serve_cnn_continuous,
                                          _serve_cnn_latency, serve, serve_lm)
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import cnn, lm
    from repro_torch.models import layers as lm_layers
    from repro_torch.models.layers import SparseWeight, _repeat_kv

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    dev = torch.device("cuda", 0)

    # -- 2. build ---------------------------------------------------------
    build_s = _build.build_all()
    print(f"[build] {len(_build.SOURCES)} kernels in {build_s:.1f}s (each "
          f"source's nvcc, in parallel: "
          f"{ {n: round(t, 1) for n, t in _build.BUILD_SECONDS.items()} })")
    resources, hmma = {}, {}
    for name in _build.SOURCES:
        resources[name] = ptxas_resources(_build.BUILD_LOG.get(name, ""))
        hmma[name] = sass_hmma(_build._build_dir() / f"lib{name}.so")
        for fn in sorted(set(resources[name]) | set(hmma[name] or {})):
            r = resources[name].get(fn)
            ptxas = (f"{r['registers']} registers, {r['smem_bytes']} B "
                     f"static smem, spills {r['spill_stores']} B stored / "
                     f"{r['spill_loads']} B loaded" if r else
                     "ptxas: not built in this process")
            n_hmma = "no cuobjdump" if hmma[name] is None else \
                hmma[name].get(fn, 0)
            print(f"[build] {name}: {fn}: {ptxas}; HMMA {n_hmma}")
    for name in ("flash_attention", "sparse_matmul", "sparse_conv", "dw_pw"):
        if hmma[name] is not None and not any(
                n for fn, n in hmma[name].items() if "_mma" in fn):
            raise AssertionError(f"{name}: no HMMA in the mma variant's SASS")

    # -- 3. kernel checks at the main-path shapes -------------------------
    cfg = get_config("resnet50")
    params_cpu = cnn.init_cnn(cfg, torch.Generator().manual_seed(SEED),
                              device="cpu")
    graph = fused_graph_for(cfg.name)
    layers = []          # the 47 sparse conv nodes, in main-path order
    for node in graph.nodes:
        if node.kind == "conv" and isinstance(
                params_cpu[conv_part(node).name]["w"], SparseWeight):
            layers.append(node)
    if len(layers) != 47:
        raise AssertionError(f"expected 47 sparse convs, found {len(layers)}")

    def conv_part_params(node):
        p = params_cpu[conv_part(node).name]
        return p["w"].to(dev), p["b"].to(dev)

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)

    def randn(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    checked_variants = {}          # (kernel, variant) -> checks run

    def launch_checked(name: str, want_variant: str, launch, what: str):
        """``launch()`` launches kernel ``name`` once, in the variant
        ``want_variant`` that its ``variant()`` names for these inputs."""
        key = (name, want_variant)
        before = ops.VARIANT_LAUNCHES[key]
        out = launch()
        if ops.VARIANT_LAUNCHES[key] != before + 1:
            raise AssertionError(f"{name} {what}: the {want_variant} variant "
                                 f"did not launch: {ops.VARIANT_LAUNCHES}")
        checked_variants[key] = checked_variants.get(key, 0) + 1
        return out

    def check_conv(what, x, sw, b, r, relu, **kw) -> float:
        v = sc.variant(*sw.vals.shape[2:], sw.vals.dtype)
        got = launch_checked("sparse_conv", v, lambda: sc.sparse_conv(
            x, sw.vals, sw.idx, b, r, sw.scale, relu=relu, **kw), what)
        want = sc.sparse_conv_torch(x, sw.vals, sw.idx, b, r, sw.scale,
                                    relu=relu, **kw)
        torch.cuda.synchronize()
        return compare(got, want, bf16_tol, f"sparse_conv {what} ({v})")

    conv_err = 0.0
    seen = set()
    for node in layers:
        sw, _ = conv_part_params(node)
        key = (node.k, node.stride, node.cin, node.cout, sw.vals.shape[1],
               node.in_hw)
        if key in seen:
            continue
        seen.add(key)
        ho = node.conv_out_hw
        if sc.variant(*sw.vals.shape[2:]) != "mma":
            raise AssertionError(f"sparse_conv {node.name}: blocks "
                                 f"{tuple(sw.vals.shape[2:])} not mma")
        x = randn((1, node.in_hw, node.in_hw, node.cin))
        b = randn((node.cout,)) * 0.1
        res = randn((1, ho, ho, node.cout))
        for r, relu in ((None, node.relu), (res, True)):
            conv_err = max(conv_err, check_conv(
                f"{key} res={r is not None}", x, sw, b, r, relu, k=node.k,
                stride=node.stride))
        tm, split = sc.plan(ho * ho, sw.vals.shape[0], sw.vals.shape[1])
        print(f"[plan] sparse_conv {node.name:9s} M {ho * ho:5d} ob "
              f"{sw.vals.shape[0]:3d} K {sw.vals.shape[1]:3d}: tm {tm}, split "
              f"{split}, {-(-ho * ho // tm) * sw.vals.shape[0] * split} "
              f"blocks")
    # the CUDA-core variant: blocks the tensor-core tiles do not take
    w_simt = to_block_balanced(
        randn((9 * 64, 48)).cpu() / 24,
        SparsityConfig(True, 0.5, 8, 8)).to(dev)
    x = randn((2, 9, 9, 64))
    for r in (None, randn((2, 9, 9, 48))):
        conv_err = max(conv_err, check_conv(
            f"8x8 blocks batch 2 res={r is not None}", x, w_simt,
            randn((48,)) * 0.1, r, True, k=3, stride=1))
    print(f"[check] sparse_conv: {len(seen)} shapes (k, stride, C, Cout, K, "
          f"H) x residual on/off (mma) + 8x8 blocks (simt), max |err| "
          f"{conv_err:.3e} within 1 bf16 ulp")

    def check_mm(what: str, x, sw, tol) -> float:
        v = sm.variant(x.dtype, x.shape[0], *sw.vals.shape[2:],
                       sw.vals.dtype)
        got = launch_checked("sparse_matmul", v, lambda: sm.sparse_matmul(
            x, sw.vals, sw.idx), what)
        want = sm.sparse_matmul_torch(x, sw.vals, sw.idx)
        torch.cuda.synchronize()
        return compare(got, want, tol, f"sparse_matmul {what} ({v})")

    fc_w = params_cpu["fc"]["w"].to(dev)
    # the classifier (gemv, f32), its 32 x 25 blocks with bf16 x (gemv)
    # and f32 x past the decode rows (simt)
    mm_cases = [("fc M=1 f32", randn((1, 2048), torch.float32), fc_w,
                 f32_tol),
                ("fc blocks M=4 bf16", randn((4, 2048)), fc_w, bf16_tol),
                ("fc blocks M=9 f32", randn((9, 2048), torch.float32), fc_w,
                 f32_tol)]
    w_bf = SparseWeight(randn((16, 4, 32, 32)),
                        torch.stack([torch.randperm(32, generator=gen,
                                                    device=dev)[:4].sort()
                                     .values for _ in range(16)])
                        .to(torch.int32).contiguous(), 1024)
    for m in (9, 16, 64, 100, 129, 2048):
        mm_cases.append((f"32x32 M={m} bf16", randn((m, 1024)), w_bf,
                         bf16_tol))
    mm_err = 0.0
    for what, x, sw, tol in mm_cases:
        mm_err = max(mm_err, check_mm(what, x, sw, tol))
    print(f"[check] sparse_matmul: {[c[0] for c in mm_cases]}, max |err| "
          f"{mm_err:.3e} within tolerance")

    # the MobileNet blocks: every fused dw_pw node (main path) and every
    # standalone dw node of the unfused view, with their weights
    mb_params, mb_blocks, mb_dws = {}, {}, {}
    for name in MOBILENETS:
        mb_params[name] = cnn.init_cnn(
            get_config(name), torch.Generator().manual_seed(SEED),
            device="cpu")
        mb_blocks[name] = [n for n in fused_graph_for(name).nodes
                           if n.kind == "dw_pw"]
        mb_dws[name] = [n for n in graph_for(name).nodes if n.kind == "dw"]
        if len(mb_blocks[name]) != MB_BLOCKS[name] or \
                len(mb_dws[name]) != MB_BLOCKS[name]:
            raise AssertionError(f"{name}: expected {MB_BLOCKS[name]} dw_pw "
                                 f"and dw nodes")

    def dw_pw_args(name, node, n=1):
        """(x, dw_w, dw_b, pw_w, pw_b, residual, kwargs) on the card at
        the node's shape, batch n: the node's weights, random x, biases,
        skip."""
        dw_s, pw_s = node.parts[0], node.parts[1]
        p = mb_params[name]
        ho = node.conv_out_hw
        x = randn((n, node.in_hw, node.in_hw, node.cin))
        r = randn((n, ho, ho, node.cout)) if node.residual_from else None
        return (x, p[dw_s.name]["w"].to(dev), randn((node.cin,)) * 0.1,
                p[pw_s.name]["w"].to(dev), randn((node.cout,)) * 0.1, r,
                dict(stride=node.stride, dw_relu=dw_s.relu, relu=node.relu))

    def check_dw_pw(what, args, kw) -> float:
        x, dw_w, pw_w = args[0], args[1], args[3]
        v = dwpw.variant(x.shape[-1], pw_w.shape[1], dw_w.shape[0],
                         kw["stride"], pw_w.dtype)
        got = launch_checked("dw_pw", v, lambda: dwpw.dw_pw(*args, **kw),
                             what)
        want = dwpw.dw_pw_torch(*args, **kw)
        torch.cuda.synchronize()
        return compare(got, want, bf16_tol, f"dw_pw {what} ({v})")

    dw_pw_err, dw_pw_seen = 0.0, set()
    for name in MOBILENETS:
        for node in mb_blocks[name]:
            key = (node.cin, node.cout, node.in_hw, node.stride,
                   bool(node.residual_from), node.relu)
            if key in dw_pw_seen:
                continue
            dw_pw_seen.add(key)
            ho = node.conv_out_hw
            if dwpw.variant(node.cin, node.cout, node.k, node.stride) != \
                    "mma":
                raise AssertionError(f"dw_pw {name} {node.name}: not mma")
            *args, kw = dw_pw_args(name, node)
            dw_pw_err = max(dw_pw_err, check_dw_pw(str(key), args, kw))
            pl = dwpw.plan(1, ho, ho, node.cin, node.cout, node.k,
                           node.stride)
            print(f"[plan] dw_pw {name} {node.name:8s} C {node.cin:4d} Cout "
                  f"{node.cout:4d} out {ho:3d}x{ho:3d} s{node.stride}: {pl}")

    def dw_pw_rand(n, h, c, co, k, stride, residual):
        ho = -(-h // stride)
        return ((randn((n, h, h, c)), randn((k, k, c)) / k,
                 randn((c,)) * 0.1, randn((c, co)) * c ** -0.5,
                 randn((co,)) * 0.1,
                 randn((n, ho, ho, co)) if residual else None),
                dict(stride=stride, dw_relu=True, relu=not residual))

    # other kernel sizes through mma (at V2's 14x14 and 7x7 widths), and
    # the CUDA-core variant at a C that is no multiple of 8
    dw_pw_extra = [(1, 14, 384, 96, 5, 1, True), (1, 7, 960, 160, 7, 1, True),
                   (1, 28, 192, 64, 7, 2, False), (2, 9, 36, 24, 3, 1, True)]
    for n_, h, c, co, k, stride, residual in dw_pw_extra:
        args, kw = dw_pw_rand(n_, h, c, co, k, stride, residual)
        dw_pw_err = max(dw_pw_err, check_dw_pw(
            f"k={k} C={c} Cout={co} H={h} s{stride}", args, kw))
    print(f"[check] dw_pw: {len(dw_pw_seen)} shapes (C, Cout, H, stride, "
          f"residual, relu) of MobileNet-V1/V2 (mma) + k 5 and 7 (mma) + C "
          f"36 (simt), max |err| {dw_pw_err:.3e} within 1 bf16 ulp")

    def check_dw(what, x, w, stride) -> float:
        got = dwk.depthwise_conv(x, w, stride=stride)
        want = dwk.depthwise_conv_torch(x, w, stride=stride)
        torch.cuda.synchronize()
        return compare(got, want, bf16_tol, f"depthwise_conv {what}")

    dw_err, dw_seen = 0.0, set()
    for name in MOBILENETS:
        for node in mb_dws[name]:
            key = (node.cin, node.in_hw, node.stride)
            if key in dw_seen:
                continue
            dw_seen.add(key)
            x = randn((1, node.in_hw, node.in_hw, node.cin))
            w = mb_params[name][node.name]["w"].to(dev)
            dw_err = max(dw_err, check_dw(str(key), x, w, node.stride))
    # odd C (the masked scalar tail) and k = 5
    for n_, h, c, k, stride in ((1, 14, 1001, 3, 1), (2, 15, 37, 3, 2),
                                (1, 14, 576, 5, 1), (1, 28, 96, 5, 2)):
        dw_err = max(dw_err, check_dw(
            f"k={k} C={c} H={h} s{stride}", randn((n_, h, h, c)),
            randn((k, k, c)) / k, stride))
    print(f"[check] depthwise_conv: {len(dw_seen)} shapes (C, H, stride) of "
          f"the unfused MobileNet-V1/V2 + odd C + k 5, max |err| "
          f"{dw_err:.3e} within 1 bf16 ulp")

    # SmolLM-360M: its weights (on the card, from the seed), the flash
    # kernel at its prefill shapes (k, v from 5 KV heads expanded to 15)
    # and on the reference's test grid (tests/test_kernels.py), the
    # sparse matmul at its 64 x 64 FFN blocks
    lm_cfg = get_config(LM)
    n_l, n_h, n_kv, d_h = (lm_cfg.n_layers, lm_cfg.n_heads, lm_cfg.kv_heads,
                           lm_cfg.head_dim)
    lm_params = lm.init_params(lm_cfg,
                               torch.Generator(device=dev).manual_seed(SEED))

    def qkv(b, tq, tk, h, d, dtype, kv_heads):
        q = randn((b, tq, h, d), dtype)
        k, v = (_repeat_kv(randn((b, tk, kv_heads, d), dtype), h // kv_heads)
                for _ in range(2))
        return q, k, v

    flash_cases = [(f"{LM} T={t}", (1, t, t, n_h, d_h, torch.bfloat16, n_kv),
                    dict(causal=True)) for t in (PREFILL_T, 1000)]
    # the tensor-core variant at lengths 1, under a tile, a tile, a tile
    # + 1 and two tiles - 1, both head sizes, causal or not; windows and
    # query offsets
    for t in (1, 17, 64, 65, 127):
        for d in (32, 64):
            for causal in (True, False):
                flash_cases.append((f"T={t} D={d} causal={causal}",
                                    (2, t, t, 3, d, torch.bfloat16, 3),
                                    dict(causal=causal)))
    for b, tq, tk, h, d, causal, window, q_offset in (
            (2, 127, 127, 3, 32, True, 48, 0),
            (2, 1000, 1000, 2, 64, False, 200, 0),
            (1, 65, 300, 2, 64, True, 100, 235),
            (3, 17, 1000, 2, 64, True, 0, 983)):
        flash_cases.append((f"{tq}x{tk} D={d} causal={causal} window="
                            f"{window} q_offset={q_offset}",
                            (b, tq, tk, h, d, torch.bfloat16, h),
                            dict(causal=causal, window=window,
                                 q_offset=q_offset)))
    for tq, tk, causal, window in ((128, 128, True, 0), (128, 128, False, 0),
                                   (64, 256, True, 0), (128, 128, True, 48)):
        for dtype in (torch.float32, torch.bfloat16):
            flash_cases.append((
                f"grid {tq}x{tk} causal={causal} window={window} {dtype}",
                (2, tq, tk, 3, 32, dtype, 3),
                dict(causal=causal, window=window,
                     q_offset=tk - tq if tq != tk else 0)))
    flash_err = 0.0
    for what, shape, kw in flash_cases:
        q, k, v = qkv(*shape)
        var = fa.variant(q.dtype, q.shape[-1])
        got = launch_checked("flash_attention", var,
                             lambda: fa.flash_attention(q, k, v, **kw), what)
        want = fa.flash_attention_torch(q, k, v, **kw)
        torch.cuda.synchronize()
        tol = bf16_tol if q.dtype == torch.bfloat16 else f32_tol
        flash_err = max(flash_err, compare(got, want, tol,
                                           f"flash_attention {what} ({var})"))
    print(f"[check] flash_attention: {len(flash_cases)} cases ({LM} T="
          f"{PREFILL_T} and 1000; T 1 to 127, D 32 and 64, windows and "
          f"offsets in bf16; the reference's grid in f32 and bf16), max "
          f"|err| {flash_err:.3e} within 1 bf16 ulp / 1e-5 relative")

    lm_ffn = {name: lm_params["blocks"]["ffn"][name] for name in
              ("w1", "w2")}                           # w3 has w1's shape
    lm_mm = {}
    for name, sw in lm_ffn.items():
        sw0 = SparseWeight(sw.vals[0].contiguous(), sw.idx[0].contiguous(),
                           sw.d_in)
        for m in (1, SERVE["batch"], 8, 9, 16, 100, 129, PREFILL_T):
            x = randn((m, sw0.d_in))
            mm_err = max(mm_err, check_mm(f"{LM} {name} M={m}", x, sw0,
                                          bf16_tol))
            if m in (SERVE["batch"], PREFILL_T):
                lm_mm[(name, m)] = (x, sw0)
    print(f"[check] sparse_matmul: {LM} FFN blocks "
          f"{[tuple(s.vals.shape[1:]) for s in lm_ffn.values()]} at M=1, "
          f"{SERVE['batch']}, 8, 9, 16, 100, 129 and {PREFILL_T} bf16, max |err| "
          f"(all cases) {mm_err:.3e} within tolerance; checks by variant "
          f"{ {f'{n}/{v}': c for (n, v), c in checked_variants.items()} }")

    # the large dense LMs (Qwen3-32B, Mistral-Nemo-12B, Granite-20B): the
    # flash kernel at D 128, at each one's T = 2048 prefill (k, v from its
    # KV heads expanded), at the cache-chunk shape (the last of CHUNKS
    # chunks of a 2048-token prompt), at a key count that is no tile
    # multiple, windowed, and in f32; the sparse matmul at their 128 x
    # 128 FFN blocks, M 1-8 (gemv) and 2048 (mma)
    large_flash = []
    for name in PREFILL_LMS:
        c = get_config(name)
        large_flash.append((f"{name} T={PREFILL_T}",
                            (1, PREFILL_T, PREFILL_T, c.n_heads, c.head_dim,
                             torch.bfloat16, c.kv_heads), dict(causal=True)))
    qc, chunk_t = get_config(QWEN), PREFILL_T // CHUNKS
    large_flash += [
        (f"{QWEN} chunk Tq={chunk_t} q_offset={PREFILL_T - chunk_t} "
         f"Tk={PREFILL_T}", (1, chunk_t, PREFILL_T, qc.n_heads, qc.head_dim,
                             torch.bfloat16, qc.kv_heads),
         dict(causal=True, q_offset=PREFILL_T - chunk_t)),
        ("Tq=100 Tk=1000 q_offset=900 D=128",
         (2, 100, 1000, 8, 128, torch.bfloat16, 2),
         dict(causal=True, q_offset=900)),
        ("T=77 D=128 window=30 not causal",
         (2, 77, 77, 4, 128, torch.bfloat16, 4),
         dict(causal=False, window=30)),
        ("T=130 D=128 window=50 f32", (1, 130, 130, 2, 128, torch.float32, 2),
         dict(causal=True, window=50))]
    large_flash_err, large_flash_inputs = 0.0, {}
    for what, shape, kw in large_flash:
        q, k, v = qkv(*shape)
        var = fa.variant(q.dtype, q.shape[-1])
        if var != ("mma" if q.dtype == torch.bfloat16 else "simt"):
            raise AssertionError(f"flash_attention {what}: variant {var}")
        got = launch_checked("flash_attention", var,
                             lambda: fa.flash_attention(q, k, v, **kw), what)
        want = fa.flash_attention_torch(q, k, v, **kw)
        torch.cuda.synchronize()
        tol = bf16_tol if q.dtype == torch.bfloat16 else f32_tol
        large_flash_err = max(large_flash_err, compare(
            got, want, tol, f"flash_attention {what} ({var})"))
        if what.startswith(PREFILL_LMS):        # timed in phase 5
            large_flash_inputs[what] = (q, k, v, kw)
    flash_err = max(flash_err, large_flash_err)
    print(f"[check] flash_attention at the large, MoE and VLM prefills (D "
          f"64 and 128) and D=128 odd shapes: {[c[0] for c in large_flash]}, "
          f"max |err| {large_flash_err:.3e} within 1 bf16 ulp / 1e-5 "
          f"relative")
    large_w = large_ffn_weights(dev, SEED + 13)
    large_mm_err, large_mm_inputs = 0.0, {}
    for (name, w), sw in large_w.items():
        for m in LARGE_MM_M:
            x = randn((m, sw.d_in))
            if sm.variant(x.dtype, m, *sw.vals.shape[2:]) != (
                    "gemv" if m <= sm.SIMT_MAX_M else "mma"):
                raise AssertionError(f"sparse_matmul {name} {w} M={m}: "
                                     f"variant")
            large_mm_err = max(large_mm_err, check_mm(
                f"{name} {w} M={m}", x, sw, bf16_tol))
            if m in (QWEN_SERVE["batch"], PREFILL_T):   # timed in phase 5
                large_mm_inputs[(name, w, m)] = (x, sw)
    mm_err = max(mm_err, large_mm_err)
    print(f"[check] sparse_matmul 128x128 blocks: "
          f"{ {f'{n} {w}': tuple(sw.vals.shape) for (n, w), sw in large_w.items()} }"
          f" at M={LARGE_MM_M} bf16, max |err| {large_mm_err:.3e} within 1 "
          f"bf16 ulp; checks by variant "
          f"{ {f'{n}/{v}': c for (n, v), c in checked_variants.items()} }")
    del large_w

    # stored weights: int8 codes with their scale (the int8 store) at every
    # main-path shape through the tensor-core variants, the classifier
    # through gemv; int8 and f32 (the f32 store) once each through simt
    params_q = {"int8": quantize_tree(params_cpu, "int8"),
                "f32": quantize_tree(params_cpu, "f32")}
    q_err = {"sparse_conv": 0.0, "sparse_matmul": 0.0, "dw_pw": 0.0}
    conv_shapes = set()
    for node in layers:
        sw = params_q["int8"][conv_part(node).name]["w"].to(dev)
        key = (node.k, node.stride, node.cin, node.cout, sw.vals.shape[1],
               node.in_hw)
        if key in conv_shapes:
            continue
        conv_shapes.add(key)
        if sc.variant(*sw.vals.shape[2:], sw.vals.dtype) != "mma":
            raise AssertionError(f"int8 sparse_conv {node.name}: not mma")
        ho = node.conv_out_hw
        x = randn((1, node.in_hw, node.in_hw, node.cin))
        b = randn((node.cout,)) * 0.1
        res = randn((1, ho, ho, node.cout))
        for r, relu in ((None, node.relu), (res, True)):
            q_err["sparse_conv"] = max(q_err["sparse_conv"], check_conv(
                f"int8 {key} res={r is not None}", x, sw, b, r, relu,
                k=node.k, stride=node.stride))
    # simt: int8 8x8 blocks; f32 32x32 blocks (a ResNet-50 layer's)
    w8_simt = quantize_tree({"l": {"w": w_simt.to("cpu")}},
                            "int8")["l"]["w"].to(dev)
    q_err["sparse_conv"] = max(q_err["sparse_conv"], check_conv(
        "int8 8x8 blocks batch 2", randn((2, 9, 9, 64)), w8_simt,
        randn((48,)) * 0.1, randn((2, 9, 9, 48)), True, k=3, stride=1))
    node = layers[4]
    sw32 = params_q["f32"][conv_part(node).name]["w"].to(dev)
    q_err["sparse_conv"] = max(q_err["sparse_conv"], check_conv(
        f"f32 {node.name}", randn((1, node.in_hw, node.in_hw, node.cin)),
        sw32, (randn((node.cout,)) * 0.1).float(), None, node.relu,
        k=node.k, stride=node.stride))
    fc8 = params_q["int8"]["fc"]["w"].to(dev)
    fc32 = params_q["f32"]["fc"]["w"].to(dev)
    for what, x, sw in (("fc M=1 f32 x int8", randn((1, 2048), torch.float32),
                         fc8),
                        ("fc blocks M=9 f32 x int8",
                         randn((9, 2048), torch.float32), fc8),
                        ("fc M=1 f32 x f32", randn((1, 2048), torch.float32),
                         fc32)):
        q_err["sparse_matmul"] = max(q_err["sparse_matmul"],
                                     check_mm(what, x, sw, f32_tol))
    mb_q = {name: quantize_tree(mb_params[name], "int8")
            for name in MOBILENETS}
    for name in MOBILENETS:
        seen = set()
        for node in mb_blocks[name]:
            key = (node.cin, node.cout, node.in_hw, node.stride,
                   bool(node.residual_from), node.relu)
            if key in seen:
                continue
            seen.add(key)
            x, dw_w, dw_b, _, pw_b, r, kw = dw_pw_args(name, node)
            pw = mb_q[name][node.parts[1].name]["w"].to(dev)
            if dwpw.variant(node.cin, node.cout, node.k, node.stride,
                            pw.codes.dtype) != "mma":
                raise AssertionError(f"int8 dw_pw {name} {node.name}: "
                                     f"not mma")
            q_err["dw_pw"] = max(q_err["dw_pw"], check_dw_pw(
                f"int8 {key}", (x, dw_w, dw_b, pw.codes, pw_b, r,
                                pw.scale), kw))
    (x, dw_w, dw_b, pw_w, pw_b, r), kw = dw_pw_rand(2, 9, 36, 24, 3, 1, True)
    pw8 = quantize_tree({"l": {"w": pw_w.cpu()}}, "int8")["l"]["w"].to(dev)
    q_err["dw_pw"] = max(q_err["dw_pw"], check_dw_pw(
        "int8 C=36 Cout=24", (x, dw_w, dw_b, pw8.codes, pw_b, r, pw8.scale),
        kw))
    node = mb_blocks["mobilenet_v2"][5]
    x, dw_w, dw_b, pw_w, pw_b, r, kw = dw_pw_args("mobilenet_v2", node)
    q_err["dw_pw"] = max(q_err["dw_pw"], check_dw_pw(
        f"f32 mobilenet_v2 {node.name}", (x, dw_w.float(), dw_b.float(),
                                          pw_w.float(), pw_b.float(), r,
                                          None), kw))
    print(f"[check] stored weights: int8 sparse_conv at the {len(conv_shapes)} "
          f"ResNet-50 shapes x residual on/off (mma) and 8x8 blocks (simt), "
          f"f32 sparse_conv (simt); int8 classifier (gemv, and simt at M=9),"
          f" f32 classifier (simt); int8 dw_pw at every MobileNet block shape"
          f" (mma) and C 36 (simt), f32 dw_pw (simt): max |err| "
          f"{q_err} within 1 bf16 ulp / 1e-5 relative; checks by variant "
          f"{ {f'{n}/{v}': c for (n, v), c in checked_variants.items()} }")

    # the throughput paths' microbatch shapes: every kernel at n = the
    # batched executor's mb (batch 16 over M 4) and the continuous
    # server's mb 2 (its mb 1 is the latency shape above), bf16 and int8
    mb_err = {"sparse_conv": 0.0, "sparse_matmul": 0.0, "dw_pw": 0.0}
    n_mb_checks = 0
    for n_ in PIPE_MB_SIZES:
        seen = set()
        for node in layers:
            sw, _ = conv_part_params(node)
            key = (node.k, node.stride, node.cin, node.cout, sw.vals.shape[1],
                   node.in_hw, bool(node.residual_from))
            if key in seen:
                continue
            seen.add(key)
            ho = node.conv_out_hw
            x = randn((n_, node.in_hw, node.in_hw, node.cin))
            b = randn((node.cout,)) * 0.1
            r = randn((n_, ho, ho, node.cout)) if node.residual_from else None
            sw8 = params_q["int8"][conv_part(node).name]["w"].to(dev)
            for store, w in (("bf16", sw), ("int8", sw8)):
                mb_err["sparse_conv"] = max(mb_err["sparse_conv"], check_conv(
                    f"n={n_} {store} {key}", x, w, b, r, node.relu,
                    k=node.k, stride=node.stride))
                n_mb_checks += 1
            tm, split = sc.plan(n_ * ho * ho, sw.vals.shape[0],
                                sw.vals.shape[1])
            print(f"[plan] sparse_conv n={n_} {node.name:9s} M "
                  f"{n_ * ho * ho:6d}: tm {tm}, split {split}")
        for store, w in (("bf16", fc_w), ("int8", fc8)):
            mb_err["sparse_matmul"] = max(mb_err["sparse_matmul"], check_mm(
                f"fc M={n_} f32 x {store}", randn((n_, 2048), torch.float32),
                w, f32_tol))
            n_mb_checks += 1
        for name in MOBILENETS:
            seen = set()
            for node in mb_blocks[name]:
                key = (node.cin, node.cout, node.in_hw, node.stride,
                       bool(node.residual_from), node.relu)
                if key in seen:
                    continue
                seen.add(key)
                x, dw_w, dw_b, pw_w, pw_b, r, kw = dw_pw_args(name, node, n_)
                pw8 = mb_q[name][node.parts[1].name]["w"].to(dev)
                for store, args in (
                        ("bf16", (x, dw_w, dw_b, pw_w, pw_b, r)),
                        ("int8", (x, dw_w, dw_b, pw8.codes, pw_b, r,
                                  pw8.scale))):
                    mb_err["dw_pw"] = max(mb_err["dw_pw"], check_dw_pw(
                        f"n={n_} {store} {name} {key}", args, kw))
                    n_mb_checks += 1
                ho = node.conv_out_hw
                pl = dwpw.plan(n_, ho, ho, node.cin, node.cout, node.k,
                               node.stride)
                print(f"[plan] dw_pw n={n_} {name} {node.name:8s}: {pl}")
    print(f"[check] microbatch shapes n={PIPE_MB_SIZES}: {n_mb_checks} "
          f"checks (sparse_conv at every ResNet-50 layer shape, the "
          f"classifier, dw_pw at every MobileNet block shape; bf16 and "
          f"int8): max |err| {mb_err} within 1 bf16 ulp / 1e-5 relative")

    # -- 4. the main paths ------------------------------------------------
    def check_logits(logits, images, cfg_, params_, graph=None,
                     rtol=LOGIT_RTOL, n=2) -> float:
        """The card's logits of the first ``n`` requests against the plain
        CPU forward: within ``rtol`` of max |logit|, top-1 equal.
        Returns the larger max |err| / max |logit|."""
        if not torch.isfinite(logits).all():
            raise AssertionError(f"{cfg_.name}: non-finite logits")
        worst = 0.0
        for i in range(min(n, logits.shape[0])):
            ref = cnn.cnn_forward(cfg_, params_,
                                  torch.from_numpy(images[i:i + 1]),
                                  graph=graph, device="cpu")[0]
            scale = float(ref.abs().max())
            err = float((logits[i] - ref).abs().max())
            if scale == 0 or err > rtol * scale or int(
                    logits[i].argmax()) != int(ref.argmax()):
                raise AssertionError(
                    f"{cfg_.name} request {i}: card vs CPU logits max |err| "
                    f"{err:.3e} > {rtol} * {scale:.3e}, or top-1 differs")
            worst = max(worst, err / scale)
        return worst

    def check_launches(launches: dict, want: dict, what: str) -> None:
        """Every counter by name: the kernels ``want`` names launched
        exactly that often, and any counter it does not name not at all."""
        unknown = set(want) - set(launches)
        full = {k: want.get(k, 0) for k in launches}
        if unknown or launches != full:
            raise AssertionError(f"{what}: launches {launches} != {full}, "
                                 f"counters missing: {unknown or 'none'}")

    def check_variants(variants: dict, want: dict, what: str) -> None:
        """Every (kernel, variant) counter: those ``want`` names launched
        exactly that often, the others not at all."""
        full = {k: want.get(k, 0) for k in variants}
        if set(want) - set(variants) or variants != full:
            raise AssertionError(f"{what}: variant launches {variants} != "
                                 f"{full}")

    all_variants = {k: 0 for k in ops.VARIANT_LAUNCHES}

    def add_variants(variants: dict) -> None:
        for k, v in variants.items():
            all_variants[k] += v

    def check_nodes(cfg_, graph, params_dev, params_cpu_, image) -> float:
        """Each node of ``graph`` on the card against the same node on
        the CPU, fed the card's own input to that node: bf16 outputs
        within 1 bf16 ulp, the f32 logits within LOGIT_RTOL of max
        |logit|. Returns the worst error as a share of its bar."""
        env = {INPUT: torch.from_numpy(image).to(dev).to(torch.bfloat16)}
        worst = 0.0
        with torch.inference_mode():
            for node, srcs in zip(graph.nodes, graph.inputs):
                args = [env[s] for s in srcs]
                got = cnn.run_node(node, params_dev, *args)
                want = cnn.run_node(node, params_cpu_,
                                    *[a.cpu() for a in args])
                env[node.name] = got
                torch.cuda.synchronize()
                tol = bf16_tol if want.dtype == torch.bfloat16 else logit_tol
                compare(got.cpu(), want, tol, f"{cfg_.name} node {node.name}")
                err = (got.cpu().float() - want.float()).abs()
                share = err / tol(want.float()).clamp_min(1e-38)
                worst = max(worst, float(share.max()))
        return worst

    # Serving: every request after the warm-up replays one CUDA graph, so
    # the wrappers count the warm-up's launches and the capture's, and the
    # capture's are the launches of every replayed request. Each CNN runs
    # through serve() (the graph) and through the eager path at each store
    # dtype of STORE_RUNS; the graph's logits must equal the eager ones bit
    # for bit, and both the CPU forward on the same stored weights.
    def per_request_want(arch: str, q: str) -> tuple[dict, dict]:
        if arch == "resnet50":
            # f32 weights go to the CUDA-core variants
            conv_v, mm_v = ("simt", "simt") if q == "f32" else ("mma", "gemv")
            return ({"sparse_conv": 47, "sparse_matmul": 1},
                    {("sparse_conv", conv_v): 47, ("sparse_matmul", mm_v): 1})
        return ({"dw_pw": MB_BLOCKS[arch]}, {("dw_pw", "mma"): MB_BLOCKS[arch]})

    def serve_run(arch: str, q: str, capture: bool):
        """One ``serve`` at store dtype ``q`` (capture: the graph, as a
        user calls it; else the eager reference), its counters reset just
        before and read just after, each checked by name and variant."""
        what = f"{arch} {q} {'graph' if capture else 'eager'}"
        cfg_ = ServeConfig(arch=arch, mode="latency", image_size=IMAGE_SIZE,
                           n_requests=N_REQUESTS, seed=SEED, quantize=q,
                           device="cuda")
        ops.reset_launches()
        res = serve(cfg_) if capture else _serve_cnn_latency(cfg_,
                                                              capture=False)
        counted, variants = dict(ops.LAUNCHES), dict(ops.VARIANT_LAUNCHES)
        if res["captured"] != capture:
            raise AssertionError(f"{what}: captured {res['captured']}")
        want, want_v = per_request_want(arch, q)
        check_launches(res["launches_per_request"], want,
                       f"{what}: one request")
        check_variants(res["variant_launches_per_request"], want_v,
                       f"{what}: one request")
        # the warm-up and the capture, or the warm-up and every request
        runs = 2 if capture else N_REQUESTS + 1
        check_launches(counted, {k: v * runs for k, v in want.items()},
                       f"{what}: {runs} forwards")
        check_variants(variants, {k: v * runs for k, v in want_v.items()},
                       f"{what}: {runs} forwards")
        logits = torch.from_numpy(res["logits"])
        if logits.shape != (N_REQUESTS, 1000) or not torch.isfinite(
                logits).all():
            raise AssertionError(f"{what}: logits {tuple(logits.shape)} not "
                                 f"finite (N_REQUESTS, 1000)")
        return res, counted, variants

    cnn_params = {"resnet50": params_cpu, **mb_params}
    STORE_RUNS = {"resnet50": ("native", "int8", "bf16", "f32"),
                  "mobilenet_v1": ("native", "int8"),
                  "mobilenet_v2": ("native", "int8")}
    serving, main_runs = {}, {}
    for arch, qs in STORE_RUNS.items():
        mcfg = get_config(arch)
        rtol = LOGIT_RTOL if arch == "resnet50" else MB_LOGIT_RTOL
        for q in qs:
            graph_out, counted, variants = serve_run(arch, q, True)
            eager_out, _, _ = serve_run(arch, q, False)
            g_bits = graph_out["logits"].view(np.uint32)
            if not np.array_equal(g_bits, eager_out["logits"].view(np.uint32)):
                raise AssertionError(f"{arch} {q}: the graph's logits differ "
                                     f"from the eager requests'")
            stored = quantize_tree(cnn_params[arch], q)
            err = check_logits(torch.from_numpy(graph_out["logits"]),
                               graph_out["request_images"], mcfg, stored,
                               rtol=rtol, n=2 if q == "native" else 1)
            serving[(arch, q)] = {
                "graph_p50_ms": graph_out["latency_p50_s"] * 1e3,
                "graph_p99_ms": graph_out["latency_p99_s"] * 1e3,
                "eager_p50_ms": eager_out["latency_p50_s"] * 1e3,
                "eager_p99_ms": eager_out["latency_p99_s"] * 1e3,
                "param_bytes_stored": graph_out["param_bytes_stored"],
                "launches_per_request": graph_out["launches_per_request"],
                "logit_err": err}
            if q == "native":
                main_runs[arch] = (graph_out, counted, variants)
            row = serving[(arch, q)]
            print(f"[main] {arch} quantize={q}: {N_REQUESTS} requests at "
                  f"{IMAGE_SIZE}px: graph p50 {row['graph_p50_ms']:.4f} ms, "
                  f"p99 {row['graph_p99_ms']:.4f} ms; eager p50 "
                  f"{row['eager_p50_ms']:.4f} ms, p99 "
                  f"{row['eager_p99_ms']:.4f} ms; graph == eager bitwise; "
                  f"per request "
                  f"{variant_str(graph_out['variant_launches_per_request'])}"
                  f" (counted {variant_str(variants)}); logits vs CPU max "
                  f"|err| / max |logit| {err:.3e} (bar {rtol}), top-1 equal; "
                  f"stored {row['param_bytes_stored']} B")

    out, launches, resnet_variants = main_runs["resnet50"]
    add_variants(resnet_variants)
    p50_ms = out["latency_p50_s"] * 1e3
    p99_ms = out["latency_p99_s"] * 1e3
    param_bytes = {arch: {q: pytree_param_bytes(cnn_params[arch], q)
                          for q in STORE_DTYPES} for arch in STORE_RUNS}
    for arch, row in param_bytes.items():
        for q, n in row.items():
            if (arch, q) in serving and serving[(arch, q)][
                    "param_bytes_stored"] != n:
                raise AssertionError(f"{arch} {q}: param_bytes_stored")
        print(f"[main] {arch} param_bytes_stored: {row}")

    mb_main = {}
    all_launches = dict(launches)
    for name in MOBILENETS:
        mcfg = get_config(name)
        mout, served, served_variants = main_runs[name]
        add_variants(served_variants)
        err = serving[(name, "native")]["logit_err"]
        # the unfused view: every dw node through the depthwise kernel
        img = mout["request_images"][:1]
        params_dev = {k: {"w": v["w"].to(dev), "b": v["b"].to(dev)}
                      for k, v in mb_params[name].items()}
        ops.reset_launches()
        unfused = cnn.cnn_forward(mcfg, params_dev, torch.from_numpy(img),
                                  graph=graph_for(name), device="cuda").cpu()
        unfused_launches = dict(ops.LAUNCHES)
        check_launches(unfused_launches,
                       {"sparse_conv": 0, "sparse_matmul": 0, "dw_pw": 0,
                        "depthwise_conv": MB_BLOCKS[name]},
                       f"{name} unfused view")
        check_variants(dict(ops.VARIANT_LAUNCHES), {}, f"{name} unfused")
        unfused_err = check_logits(unfused, img, mcfg, mb_params[name],
                                   graph=graph_for(name), rtol=MB_LOGIT_RTOL)
        node_err = {view: check_nodes(mcfg, g, params_dev, mb_params[name],
                                      img)
                    for view, g in (("fused", fused_graph_for(name)),
                                    ("unfused", graph_for(name)))}
        for counts in (served, unfused_launches):
            for k, v in counts.items():
                all_launches[k] = all_launches.get(k, 0) + v
        mb_main[name] = {
            "p50_ms": mout["latency_p50_s"] * 1e3,
            "p99_ms": mout["latency_p99_s"] * 1e3,
            "latencies_s": mout["request_latencies_s"],
            "launches": served, "unfused_launches": unfused_launches,
            "logit_err": err, "unfused_logit_err": unfused_err,
            "node_err_share_of_bar": node_err}
        print(f"[main] {name}: {N_REQUESTS} requests at {IMAGE_SIZE}px: p50 "
              f"{mb_main[name]['p50_ms']:.4f} ms, p99 "
              f"{mb_main[name]['p99_ms']:.4f} ms; counted launches (warm-up"
              f" and capture) {served}, by "
              f"variant {variant_str(served_variants)}; logits "
              f"vs CPU max |err| / max |logit| {err:.3e} (bar "
              f"{MB_LOGIT_RTOL}), top-1 equal; unfused view launches "
              f"{unfused_launches}, logits {unfused_err:.3e}, top-1 equal; "
              f"every node on the card's own inputs within its bar (worst "
              f"share: fused {node_err['fused']:.3f}, unfused "
              f"{node_err['unfused']:.3f})")

    # The frozen oracle (cnn.cnn_forward_reference: the per-model forward
    # monoliths, no layer graph) at batch 1 and 224 px: bit for bit the
    # unfused view on the same image, and its launches the unfused
    # view's, counted (the MobileNets' depthwise nodes through
    # depthwise_conv, ResNet-50's pruned convs through sparse_conv and its
    # classifier through sparse_matmul).
    oracle_rows = {}
    for arch in STORE_RUNS:
        mcfg = get_config(arch)
        p_dev = cnn.params_to(cnn_params[arch], dev)
        img = torch.from_numpy(np.random.default_rng(SEED + 21).normal(
            size=(1, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32))
        ops.reset_launches()
        got = cnn.cnn_forward_reference(mcfg, p_dev, img, device=dev).cpu()
        o_launches = dict(ops.LAUNCHES)
        o_variants = dict(ops.VARIANT_LAUNCHES)
        want = {"sparse_conv": 47, "sparse_matmul": 1} \
            if arch == "resnet50" else {"depthwise_conv": MB_BLOCKS[arch]}
        check_launches(o_launches, want, f"{arch} oracle")
        check_variants(o_variants, per_request_want(arch, "native")[1]
                       if arch == "resnet50" else {}, f"{arch} oracle")
        add_variants(o_variants)
        for k, v in o_launches.items():
            all_launches[k] = all_launches.get(k, 0) + v
        ops.reset_launches()
        unfused = cnn.cnn_forward(mcfg, p_dev, img, graph=graph_for(arch),
                                  device=dev).cpu()
        if dict(ops.LAUNCHES) != o_launches or not torch.equal(got,
                                                                unfused):
            raise AssertionError(f"{arch} oracle: launches {o_launches} vs "
                                 f"the unfused view's {dict(ops.LAUNCHES)},"
                                 f" or its logits differ from the view's")
        for k, v in ops.LAUNCHES.items():
            all_launches[k] = all_launches.get(k, 0) + v
        rtol = LOGIT_RTOL if arch == "resnet50" else MB_LOGIT_RTOL
        o_err = check_logits(got, img.numpy(), mcfg, cnn_params[arch],
                             graph=graph_for(arch), rtol=rtol)
        oracle_rows[arch] = {"launches": o_launches, "logit_err": o_err}
        print(f"[main] {arch} oracle (cnn_forward_reference) batch 1 at "
              f"{IMAGE_SIZE}px: launches {o_launches}; == the unfused view "
              f"bitwise; vs CPU {o_err:.3e} (bar {rtol})")

    # Throughput serving through the heterogeneous layer pipeline, each
    # (stage, replica) slot on its own CUDA stream: the batched executor
    # (batch 16, M 4, S 4; the whole batch one CUDA graph) and the
    # continuous server (one captured tick a microbatch; mb 2 for every
    # CNN, mb 1 for ResNet-50), each with S streams and with one, at
    # native and int8. The counters are reset before each run and read
    # after: the warm-up and the capture count, a replay counts nothing.
    # The logits must equal the sequential forward on the card,
    # microbatch by microbatch, bit for bit (and the one-stream run's),
    # and the plain CPU forward's within the latency runs' bars.
    pipe = {}
    pipe_launches = {}
    for arch in STORE_RUNS:
        mcfg = get_config(arch)
        rtol = LOGIT_RTOL if arch == "resnet50" else MB_LOGIT_RTOL
        for q in ("native", "int8"):
            per_fwd, per_fwd_v = per_request_want(arch, q)
            stored = quantize_tree(cnn_params[arch], q)
            p_dev = cnn.params_to(stored, dev)

            def sequential(images, mb):
                """cnn_forward on the card, mb images at a time."""
                with torch.inference_mode():
                    return torch.cat([cnn.cnn_forward(
                        mcfg, p_dev, torch.from_numpy(images[i:i + mb]),
                        device=dev).cpu()
                        for i in range(0, images.shape[0], mb)])

            def counted_run(what, fn, per_capture, captures):
                """``fn()`` with the counters reset before and read after:
                ``captures`` forwards of ``per_capture`` launches each (the
                eager warm-ups and the captures); returns fn's result."""
                ops.reset_launches()
                res = fn()
                counted, variants = dict(ops.LAUNCHES), dict(
                    ops.VARIANT_LAUNCHES)
                check_launches(counted, {k: v * per_capture * captures
                                         for k, v in per_fwd.items()},
                               f"{what}: warm-up and capture")
                check_variants(variants, {k: v * per_capture * captures
                                          for k, v in per_fwd_v.items()},
                               f"{what}: warm-up and capture")
                add_variants(variants)
                for k, v in counted.items():
                    pipe_launches[k] = pipe_launches.get(k, 0) + v
                return res

            runs = {}
            for streams in (True, False):
                what = (f"{arch} {q} batched, "
                        f"{'S streams' if streams else 'one stream'}")
                res = counted_run(what, lambda: _serve_cnn(
                    arch, batch=PIPE_BATCH, n_microbatches=PIPE_M,
                    n_stages=PIPE_S, image_size=IMAGE_SIZE, iters=PIPE_ITERS,
                    seed=SEED, quantize=q, streams=streams), PIPE_M, 2)
                check_launches(res["launches_per_batch"],
                               {k: v * PIPE_M for k, v in per_fwd.items()},
                               f"{what}: one batch (its capture)")
                if not res["captured"] or res["streams"] != (
                        PIPE_S if streams else 1):
                    raise AssertionError(f"{what}: captured "
                                         f"{res['captured']}, streams "
                                         f"{res['streams']}")
                runs[streams] = res
            out_s, out_1 = runs[True], runs[False]
            mb = PIPE_BATCH // PIPE_M
            seq = sequential(out_s["images"], mb)
            if not torch.equal(torch.from_numpy(out_s["logits"]), seq) or \
                    not np.array_equal(out_s["logits"].view(np.uint32),
                                       out_1["logits"].view(np.uint32)):
                raise AssertionError(f"{arch} {q} batched: pipelined logits "
                                     f"differ from the sequential forward "
                                     f"(mb {mb}) or the one-stream run's")
            err = check_logits(torch.from_numpy(out_s["logits"]),
                               out_s["images"], mcfg, stored, rtol=rtol)
            row = {"images_per_s": out_s["images_per_s"],
                   "images_per_s_one_stream": out_1["images_per_s"],
                   "run_ms": out_s["run_s"] * 1e3,
                   "run_ms_one_stream": out_1["run_s"] * 1e3,
                   "bubble": out_s["bubble_fraction"],
                   "stage_of": out_s["stage_of"],
                   "imbalance": out_s["imbalance"],
                   "wire_width": out_s["wire_width"],
                   "stage_runs": out_s["stage_runs"], "ticks": out_s["ticks"],
                   "launches_per_batch": out_s["launches_per_batch"],
                   "logit_err": err, "continuous": {},
                   "latency_p50_ms": serving[(arch, q)]["graph_p50_ms"]}
            print(f"[main] {arch} {q} batched throughput: batch "
                  f"{PIPE_BATCH} at {IMAGE_SIZE}px, M {PIPE_M}, S {PIPE_S} "
                  f"(stage_of cuts {row['stage_of']}, imbalance "
                  f"{row['imbalance']:.3f}, wire {row['wire_width']} f32): "
                  f"{row['images_per_s']:.1f} im/s with {PIPE_S} streams "
                  f"({row['run_ms']:.4f} ms a batch), "
                  f"{row['images_per_s_one_stream']:.1f} im/s with one "
                  f"({row['run_ms_one_stream']:.4f} ms); bubble "
                  f"{row['bubble']:.3f}, {row['stage_runs']} stage runs in "
                  f"{row['ticks']} ticks; a batch's capture "
                  f"{variant_str(out_s['variant_launches_per_batch'])}; "
                  f"== sequential (mb {mb}) and one stream bitwise; vs CPU "
                  f"{err:.3e} (bar {rtol}); batch-1 latency p50 "
                  f"{row['latency_p50_ms']:.4f} ms")
            for mb in CONT_MB[arch]:
                for streams in (True, False):
                    what = (f"{arch} {q} continuous mb {mb}, "
                            f"{'S streams' if streams else 'one stream'}")
                    res = counted_run(what, lambda: _serve_cnn_continuous(
                        arch, n_requests=CONT_REQUESTS, batch=CONT_BATCH,
                        mb_size=mb, n_stages=PIPE_S, image_size=IMAGE_SIZE,
                        seed=SEED, quantize=q, streams=streams), 1, 4)
                    check_launches(res["launches_per_tick"][0], per_fwd,
                                   f"{what}: one tick (its capture)")
                    n_mb = CONT_REQUESTS * CONT_BATCH // mb
                    if res["ticks"] != n_mb + PIPE_S - 1 or \
                            res["injected_microbatches"] != n_mb:
                        raise AssertionError(f"{what}: {res['ticks']} ticks")
                    for x, got in zip(res["request_images"], res["logits"]):
                        if not torch.equal(torch.from_numpy(got),
                                           sequential(x, mb)):
                            raise AssertionError(f"{what}: logits differ "
                                                 f"from the sequential "
                                                 f"forward (mb {mb})")
                    c_err = check_logits(
                        torch.from_numpy(res["logits"][0]),
                        res["request_images"][0], mcfg, stored, rtol=rtol,
                        n=1)
                    row["continuous"][(mb, streams)] = {
                        "images_per_s": res["images_per_s"],
                        "steady_bubble": res["steady_bubble"],
                        "p50_ms": res["latency_p50_s"] * 1e3,
                        "p99_ms": res["latency_p99_s"] * 1e3,
                        "ticks": res["ticks"], "elapsed_s": res["elapsed_s"]}
                    c = row["continuous"][(mb, streams)]
                    print(f"[main] {what}: {CONT_REQUESTS} x {CONT_BATCH} "
                          f"images: {c['images_per_s']:.1f} im/s, steady "
                          f"bubble {c['steady_bubble']:.4f} ({c['ticks']} "
                          f"ticks), request p50 {c['p50_ms']:.3f} / p99 "
                          f"{c['p99_ms']:.3f} ms; == sequential (mb {mb}) "
                          f"bitwise; vs CPU {c_err:.3e}")
            pipe[(arch, q)] = row
    for k, v in pipe_launches.items():
        all_launches[k] = all_launches.get(k, 0) + v

    # Placed stage programs against closures: the continuous server (mb 2,
    # S 4) on its packed per-stage rows (the default: each stage unpacks
    # its weights from its own uint8 row, every leaf on a 16-byte
    # boundary) and on closures over one device copy of the weights, at
    # native and int8. Each server is counted while it warms up and
    # captures (2 eager ticks, 2 captured: 4 forwards). The captured
    # ticks must launch the same kernels, name by name and variant by
    # variant, with no aligned16 copy of a misaligned tensor, and the two
    # servers serve the same requests to the same state wires and logits
    # bit for bit. Phase 5 times the native pair.
    placed_rows, placed_servers = {}, {}
    for arch in STORE_RUNS:
        for q in ("native", "int8"):
            per_fwd, per_fwd_v = per_request_want(arch, q)
            reqs = [np.random.default_rng(SEED + 31 + i).normal(
                size=(CONT_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(
                    np.float32) for i in range(2)]
            srvs, outs, copies = {}, {}, {}
            for form in ("rows", "closures"):
                what = f"{arch} {q} continuous mb 2 on {form}"
                ops.reset_launches()
                c0 = _build.ALIGN_COPIES
                srv = CNNPipelineServer(
                    arch, mb_size=2, n_stages=PIPE_S, image_size=IMAGE_SIZE,
                    seed=SEED, quantize=q, device=dev,
                    params=cnn_params[arch], closures=form == "closures")
                copies[form] = _build.ALIGN_COPIES - c0
                counted = dict(ops.LAUNCHES)
                variants = dict(ops.VARIANT_LAUNCHES)
                check_launches(counted, {k: 4 * v for k, v in
                                         per_fwd.items()},
                               f"{what}: warm-up and capture")
                check_variants(variants, {k: 4 * v for k, v in
                                          per_fwd_v.items()},
                               f"{what}: warm-up and capture")
                add_variants(variants)
                for k, v in counted.items():
                    all_launches[k] = all_launches.get(k, 0) + v
                ids = [srv.submit(x) for x in reqs]
                srv.run()
                outs[form] = [srv.results(i) for i in ids]
                srvs[form] = srv
            rsrv, csrv = srvs["rows"], srvs["closures"]
            pparams = rsrv.pparams
            if rsrv.param_rows is None or csrv.param_rows is not None or \
                    len(rsrv.param_rows) != PIPE_S:
                raise AssertionError(f"{arch} {q}: rows server holds "
                                     f"{rsrv.param_rows!r:.80}")
            if rsrv.launches_per_tick != csrv.launches_per_tick:
                raise AssertionError(
                    f"{arch} {q}: a tick on rows launches "
                    f"{rsrv.launches_per_tick}, on closures "
                    f"{csrv.launches_per_tick}")
            if copies["rows"] or copies["closures"]:
                raise AssertionError(f"{arch} {q}: aligned16 copies while "
                                     f"the ticks were captured: {copies}")
            if not all(np.array_equal(a.view(np.uint32), b.view(np.uint32))
                       for a, b in zip(outs["rows"], outs["closures"])) or \
                    not all(torch.equal(a, b) for a, b in
                            zip(rsrv._bufs, csrv._bufs)):
                raise AssertionError(f"{arch} {q}: the rows server's logits "
                                     f"or state wires differ from the "
                                     f"closures'")
            misaligned = sum(o % 16 != 0 for f in pparams.formats
                             for o in f.offsets())
            placed_rows[f"{arch}/{q}"] = row = {
                "row_widths": list(pparams.row_widths),
                "stage_bytes": list(pparams.stage_bytes),
                "padding_bytes": pparams.padding_bytes,
                "align_bytes": pparams.align_bytes,
                "leaves": sum(len(f.leaves_meta) for f in pparams.formats),
                "leaves_off_16_in_reference_layout": misaligned,
                "launches_per_tick": rsrv.launches_per_tick[0],
                "variant_launches_per_tick": {
                    f"{n}/{v}": c for (n, v), c in
                    rsrv.launches_per_tick[1].items()}}
            print(f"[main] {arch} {q} placed tick (mb 2, S {PIPE_S}): rows "
                  f"{row['row_widths']} B (stage_bytes "
                  f"{row['stage_bytes']}, padding_bytes "
                  f"{row['padding_bytes']}, alignment bytes "
                  f"{row['align_bytes']}; {misaligned} of {row['leaves']} "
                  f"leaves off 16 B in the reference layout); a tick "
                  f"{variant_str(rsrv.launches_per_tick[1])} on rows and on "
                  f"closures, no aligned16 copy; wires and logits == "
                  f"closures bitwise")
            if q == "native":
                placed_servers[arch] = srvs

    # SmolLM-360M prefill: the whole prompt in one forward, attention
    # through the flash kernel, the FFN through the sparse matmul
    prefill = make_prefill_step(lm_cfg)
    lm_gen = torch.Generator().manual_seed(SEED + 11)
    toks = torch.randint(0, lm_cfg.vocab_size, (1, PREFILL_T),
                         generator=lm_gen).to(dev)
    per_prefill = {"flash_attention": n_l, "sparse_matmul": 3 * n_l}
    # bf16 attention; bf16 FFN inputs of B*T rows in 64 x 64 blocks
    prefill_want_variants = {("flash_attention", "mma"): n_l,
                             ("sparse_matmul", "mma"): 3 * n_l}
    ops.reset_launches()
    t0 = time.perf_counter()
    last = prefill(lm_params, toks)
    torch.cuda.synchronize()
    prefill_first_s = time.perf_counter() - t0
    prefill_launches = dict(ops.LAUNCHES)
    prefill_variants = dict(ops.VARIANT_LAUNCHES)
    check_launches(prefill_launches, per_prefill,
                   f"{LM} prefill T={PREFILL_T}")
    check_variants(prefill_variants, prefill_want_variants,
                   f"{LM} prefill T={PREFILL_T}")
    add_variants(prefill_variants)
    if last.shape != (1, lm_cfg.vocab_size) or not torch.isfinite(last).all():
        raise AssertionError(f"{LM} prefill: logits {tuple(last.shape)} not "
                             f"finite (1, {lm_cfg.vocab_size})")
    lm_cpu = lm.params_to(lm_params, "cpu")
    toks_check = torch.randint(0, lm_cfg.vocab_size, (1, CHECK_T),
                               generator=lm_gen)
    ops.reset_launches()
    card = prefill(lm_params, toks_check.to(dev)).cpu()
    check_launches(dict(ops.LAUNCHES), per_prefill,
                   f"{LM} prefill T={CHECK_T}")
    check_variants(dict(ops.VARIANT_LAUNCHES), prefill_want_variants,
                   f"{LM} prefill T={CHECK_T}")
    ref = prefill(lm_cpu, toks_check)
    scale = float(ref.abs().max())
    prefill_err = float((card - ref).abs().max()) / scale
    if not prefill_err <= LM_LOGIT_RTOL or not torch.equal(
            card.argmax(-1), ref.argmax(-1)):
        raise AssertionError(f"{LM} prefill T={CHECK_T}: card vs CPU logits "
                             f"max |err| / max |logit| {prefill_err:.3e} > "
                             f"{LM_LOGIT_RTOL}, or top-1 differs")
    def lm_layer_cpu(l):
        return lm._layer(lm_cpu["blocks"], l)

    layer_err = check_lm_layers(lm_cfg, lm_params, lm_layer_cpu,
                                {"prefill": (toks_check, False, None)}, dev)
    prefill_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        prefill(lm_params, toks)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
    prefill_ms = sorted(prefill_s)[1] * 1e3
    print(f"[main] {LM} prefill T={PREFILL_T}: launches {prefill_launches}, "
          f"by variant {variant_str(prefill_variants)}; "
          f"{prefill_ms:.3f} ms (median of 3, first {prefill_first_s:.3f} s)"
          f"; T={CHECK_T} logits vs CPU max |err| / max |logit| "
          f"{prefill_err:.3e} (bar {LM_LOGIT_RTOL}), top-1 equal; every "
          f"layer on the card's own input within 1 bf16 ulp of the CPU "
          f"layer (worst share {layer_err['prefill']:.3f})")

    # SmolLM-360M serving: the prompts stepped through the decode path,
    # then greedy decoding; replayed on the CPU, teacher-forced
    ops.reset_launches()
    sout = serve_lm(LM, use_reduced=False, params=lm_params,
                    generator=torch.Generator(device=dev).manual_seed(SEED),
                    record_logits=True, device="cuda", **SERVE)
    serve_launches = dict(ops.LAUNCHES)
    serve_variants = dict(ops.VARIANT_LAUNCHES)
    n_steps = SERVE["prompt_len"] + SERVE["gen_tokens"]
    check_launches(serve_launches, {"sparse_matmul": n_steps * 3 * n_l,
                                    "flash_attention": 0},
                   f"{LM} serve_lm ({n_steps} decode steps)")
    # decode: M = batch 4 rows, the skinny product
    check_variants(serve_variants,
                   {("sparse_matmul", "gemv"): n_steps * 3 * n_l},
                   f"{LM} serve_lm")
    add_variants(serve_variants)
    seq = torch.from_numpy(np.concatenate([sout["prompts"], sout["tokens"]],
                                          axis=1))
    layer_err.update(check_lm_layers(lm_cfg, lm_params, lm_layer_cpu,
                                     {"decode": (seq[:, :1], True, None)},
                                     dev))
    caches = [lm.init_cache(lm_cfg, SERVE["batch"], SERVE["max_seq"],
                            device="cpu") for _ in range(2)]
    serve_errs, floors, gap_checked = [], [], 0
    for i in range(n_steps):
        ref, _ = lm.decode_step(lm_cfg, lm_cpu, caches[0], seq[:, i:i + 1], i)
        with lm_layers.accum_dtype(torch.float64):
            ref64, _ = lm.decode_step(lm_cfg, lm_cpu, caches[1],
                                      seq[:, i:i + 1], i)
        ref, got = ref[:, 0], sout["logits"][:, i]
        scale = float(ref.abs().max())
        floors.append(float((ref64[:, 0] - ref).abs().max()) / scale)
        serve_errs.append(float((got - ref).abs().max()) / scale)
        bar = LM_SERVE_RTOL * scale
        if not serve_errs[-1] <= LM_SERVE_RTOL:
            raise AssertionError(f"{LM} serve_lm step {i}: card vs CPU logits "
                                 f"max |err| / max |logit| {serve_errs[-1]:.3e}"
                                 f" > {LM_SERVE_RTOL} (the CPU's sum-order "
                                 f"floor at this step: {floors[-1]:.3e})")
        top2 = ref.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > bar
        if not torch.equal(ref.argmax(-1)[clear], got.argmax(-1)[clear]):
            raise AssertionError(f"{LM} serve_lm step {i}: the card's token "
                                 f"differs from the CPU's where the CPU's "
                                 f"top-2 gap exceeds {bar:.3e}")
        gap_checked += int(clear.sum())
    for counts in (prefill_launches, serve_launches):
        for k, v in counts.items():
            all_launches[k] = all_launches.get(k, 0) + v
    serve_err = max(serve_errs)
    print(f"[main] {LM} serve_lm batch {SERVE['batch']}, prompt "
          f"{SERVE['prompt_len']}, {SERVE['gen_tokens']} tokens: launches "
          f"{serve_launches}, by variant {variant_str(serve_variants)}; "
          f"prefill {sout['prefill_s']:.4f} s, decode "
          f"{sout['decode_s']:.4f} s, {sout['tokens_per_s']:.2f} tok/s; "
          f"teacher-forced CPU replay: every step within {LM_SERVE_RTOL} of "
          f"max |logit| (worst {serve_err:.3e}, median "
          f"{sorted(serve_errs)[n_steps // 2]:.3e}, steps within "
          f"{LM_LOGIT_RTOL}: {sum(e <= LM_LOGIT_RTOL for e in serve_errs)} of "
          f"{n_steps}; the CPU's sum-order floor (f64 vs f32 fdot sums): "
          f"worst {max(floors):.3e}, median "
          f"{sorted(floors)[n_steps // 2]:.3e}), tokens equal at "
          f"{gap_checked} of {n_steps * SERVE['batch']} positions whose "
          f"CPU top-2 gap exceeds the bar; decode step 0 layer by layer on "
          f"the card's own inputs within 1 bf16 ulp (worst share "
          f"{layer_err['decode']:.3f})")

    def count_launches(what: str, want: dict, want_variants: dict) -> dict:
        """The counters since the last reset, checked by name and by
        variant, added to the run's totals; the nonzero ones."""
        launches, variants = dict(ops.LAUNCHES), dict(ops.VARIANT_LAUNCHES)
        check_launches(launches, want, what)
        check_variants(variants, want_variants, what)
        add_variants(variants)
        for k, v in launches.items():
            all_launches[k] = all_launches.get(k, 0) + v
        return {k: v for k, v in launches.items() if v}

    lm_h = types.SimpleNamespace(dev=dev, count=count_launches)
    # SmolLM-360M through the continuous batcher: one decode step of all
    # slots at a time, one cache position a slot; every request replayed
    # alone, teacher-forced, on the card and on the CPU
    batcher_main = {LM: batcher_phase(LM, lm_cfg, lm_params, n_l, lm_h,
                                      params_cpu=lm_cpu)}
    # the large dense LMs at full width, one at a time on the card
    large_main = {}
    for name in LARGE_LMS:
        t0 = time.perf_counter()
        large_main[name] = large_lm_run(name, lm_h)
        large_main[name]["phase_s"] = time.perf_counter() - t0
        print(f"[main] {name}: {large_main[name]['phase_s']:.1f} s")
    batcher_main[QWEN] = large_main[QWEN].pop("batcher")
    # the MoE LMs and the VLM at full width, one at a time on the card
    moe_main = {}
    for name in MOE_LMS + (VLM,):
        t0 = time.perf_counter()
        moe_main[name] = moe_vlm_run(name, lm_h)
        moe_main[name]["phase_s"] = time.perf_counter() - t0
        print(f"[main] {name}: {moe_main[name]['phase_s']:.1f} s")
    batcher_main[GRANITE_MOE] = moe_main[GRANITE_MOE].pop("batcher")

    # -- 5. timings at the main-path shapes -------------------------------
    rows = []
    sums = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
            "bytes_ms": 0.0, "ops_ms": 0.0}
    for node in layers:
        sw, b = conv_part_params(node)
        ob, n_k, bm, bn = sw.vals.shape
        ho = node.conv_out_hw
        x = randn((1, node.in_hw, node.in_hw, node.cin))
        r = randn((1, ho, ho, node.cout)) if node.residual_from else None
        kw = dict(k=node.k, stride=node.stride, relu=node.relu)
        w_lib = densify(sw).reshape(node.k, node.k, node.cin, node.cout) \
            .permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        x_nchw = x.permute(0, 3, 1, 2)        # channels_last view, no copy
        ms = time_ms(lambda: sc.sparse_conv(x, sw.vals, sw.idx, b, r, **kw))
        sw8 = params_q["int8"][conv_part(node).name]["w"].to(dev)
        ms8 = time_ms(lambda: sc.sparse_conv(x, sw8.vals, sw8.idx, b, r,
                                             sw8.scale, **kw))
        plain8 = time_ms(lambda: sc.sparse_conv_torch(
            x, sw8.vals, sw8.idx, b, r, sw8.scale, **kw))
        plain = time_ms(lambda: sc.sparse_conv_torch(x, sw.vals, sw.idx, b,
                                                     r, **kw))
        lib = time_ms(lambda: F.conv2d(x_nchw, w_lib, b, node.stride,
                                       node.k // 2))
        m = ho * ho
        x_elems = conv_input_elems(x.shape, sw.idx, node.k, node.stride, bm)
        nbytes = (x_elems * 2 + sw.vals.numel() * 2 + sw.idx.numel() * 4
                  + b.numel() * 2 + m * node.cout * 2
                  * (2 if r is not None else 1))
        nops = 2 * m * ob * n_k * bm * bn
        t_b, t_o = bound(nbytes, nops, torch.bfloat16)
        bms, by = max(t_b, t_o), bound_by(t_b, t_o)
        # int8: a byte a weight, plus the (ob, bn) f32 scales
        nbytes8 = nbytes - sw.vals.numel() + 4 * ob * bn
        t_b8, t_o8 = bound(nbytes8, nops, torch.bfloat16)
        tm, split = sc.plan(m, ob, n_k)
        rows.append({"layer": node.name, "k": node.k, "stride": node.stride,
                     "C": node.cin, "Cout": node.cout, "K": n_k,
                     "H": node.in_hw, "residual": r is not None,
                     "variant": sc.variant(bm, bn), "tm": tm, "split": split,
                     "ms": ms,
                     "plain_ms": plain, "library_ms": lib, "bound_ms": bms,
                     "bound_by": by, "bytes": nbytes, "ops": nops,
                     "input_read": x_elems / x.numel(),
                     "int8": {"ms": ms8, "plain_ms": plain8,
                              "bound_ms": max(t_b8, t_o8),
                              "bound_by": bound_by(t_b8, t_o8),
                              "bytes": nbytes8}})
        for key, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                       ("bound_ms", bms), ("bytes_ms", t_b), ("ops_ms", t_o),
                       ("int8_ms", ms8), ("int8_plain_ms", plain8),
                       ("int8_bound_ms", max(t_b8, t_o8)),
                       ("int8_bytes_ms", t_b8)):
            sums[key] = sums.get(key, 0.0) + v
        print(f"[time] {node.name:9s} k{node.k} s{node.stride} C{node.cin:5d}"
              f" Cout{node.cout:5d} K{n_k:3d} H{node.in_hw:4d} "
              f"res={int(r is not None)}: kernel {ms * 1e3:9.3f} us, plain "
              f"{plain * 1e3:9.3f} us, F.conv2d {lib * 1e3:9.3f} us, bound "
              f"{bms * 1e3:7.3f} us ({by}); int8 kernel {ms8 * 1e3:9.3f} us,"
              f" bound {max(t_b8, t_o8) * 1e3:7.3f} us; tm {tm} split "
              f"{split}")
    for what, keep in (("K >= 10", lambda k: k >= 10),
                       ("K 5", lambda k: k == 5),
                       ("K <= 3", lambda k: k <= 3)):
        sel = [r for r in rows if keep(r["K"])]
        print(f"[time] sparse_conv {what}: {len(sel)} layers, kernel "
              f"{sum(r['ms'] for r in sel) * 1e3:.3f} us (each "
              f"{min(r['ms'] for r in sel) * 1e3:.3f}-"
              f"{max(r['ms'] for r in sel) * 1e3:.3f}), F.conv2d "
              f"{sum(r['library_ms'] for r in sel) * 1e3:.3f} us, bound "
              f"{sum(r['bound_ms'] for r in sel) * 1e3:.3f} us")
    print(f"[time] sparse_conv x47: kernel {sums['ms']:.4f} ms, F.conv2d "
          f"{sums['library_ms']:.4f} ms, bound {sums['bound_ms']:.5f} ms; "
          f"int8 kernel {sums['int8_ms']:.4f} ms, bound "
          f"{sums['int8_bound_ms']:.5f} ms")

    x_fc = randn((1, 2048), torch.float32)
    w_fc_dense = densify(fc_w).float()
    fc_ms = time_ms(lambda: sm.sparse_matmul(x_fc, fc_w.vals, fc_w.idx))
    fc_plain = time_ms(lambda: sm.sparse_matmul_torch(x_fc, fc_w.vals,
                                                      fc_w.idx))
    fc_lib = time_ms(lambda: torch.matmul(x_fc, w_fc_dense))
    ob, n_k, bm, bn = fc_w.vals.shape
    # only the input blocks some surviving weight block reads
    x_fc_elems = x_fc.shape[0] * int(fc_w.idx.unique().numel()) * bm
    fc_bytes = (x_fc_elems * 4 + fc_w.vals.numel() * 2
                + fc_w.idx.numel() * 4 + ob * bn * 4)
    fc_ops = 2 * ob * n_k * bm * bn
    t_b, t_o = bound(fc_bytes, fc_ops, torch.float32)
    fc_bound, fc_by = max(t_b, t_o), bound_by(t_b, t_o)
    print(f"[time] fc        M=1 f32 vals {tuple(fc_w.vals.shape)} "
          f"({sm.variant(x_fc.dtype, 1, bm, bn)}, grid "
          f"{sm.gemv_grid(ob, bn)} x {sm.gemv_threads(n_k * bm, bn)} "
          f"threads): kernel "
          f"{fc_ms * 1e3:.3f} us, plain {fc_plain * 1e3:.3f} us, torch.matmul"
          f" (dense f32) {fc_lib * 1e3:.3f} us, bound {fc_bound * 1e3:.3f} us"
          f" ({fc_by})")
    fc8_w = params_q["int8"]["fc"]["w"].to(dev)
    fc8_ms = time_ms(lambda: sm.sparse_matmul(x_fc, fc8_w.vals, fc8_w.idx))
    fc8_plain = time_ms(lambda: sm.sparse_matmul_torch(x_fc, fc8_w.vals,
                                                       fc8_w.idx))
    t_b, t_o = bound(fc_bytes - fc_w.vals.numel(), fc_ops, torch.float32)
    fc8 = {"ms": fc8_ms, "plain_ms": fc8_plain, "bound_ms": max(t_b, t_o),
           "bound_by": bound_by(t_b, t_o)}
    print(f"[time] fc        M=1 f32 x, int8 codes "
          f"({sm.variant(x_fc.dtype, 1, bm, bn, torch.int8)}): kernel "
          f"{fc8_ms * 1e3:.3f} us, plain {fc8_plain * 1e3:.3f} us, bound "
          f"{fc8['bound_ms'] * 1e3:.3f} us ({fc8['bound_by']}); the scale "
          f"is applied after it, as in the reference")
    per_req = sums["ms"] + fc_ms
    print(f"[time] per request: kernels {per_req:.4f} ms (sparse_conv x47 "
          f"{sums['ms']:.4f} + sparse_matmul {fc_ms:.4f}) vs request p50 "
          f"{p50_ms:.4f} ms: the rest is the dense convs, pools, launch "
          f"overhead, host time and H2D/D2H")

    def add_sums(acc: dict, row: dict) -> None:
        for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms",
                    "ops_ms", "int8_ms", "int8_plain_ms", "int8_bound_ms",
                    "int8_bytes_ms"):
            if key in row:
                acc[key] = acc.get(key, 0.0) + row[key]

    dw_pw_rows, dw_pw_sums = [], {}
    dw_rows, dw_sums = [], {}
    for name in MOBILENETS:
        per_req, dw_per_req = {}, {}
        for node in mb_blocks[name]:
            x, dw_w, dw_b, pw_w, pw_b, r, kw = dw_pw_args(name, node)
            c, co, ho = node.cin, node.cout, node.conv_out_hw
            m = ho * ho
            x_cl = x.permute(0, 3, 1, 2)      # channels_last view, no copy
            w_dw = dw_w.permute(2, 0, 1).unsqueeze(1).contiguous(
                memory_format=torch.channels_last)           # (C, 1, 3, 3)
            w_pw = pw_w.t().reshape(co, c, 1, 1).contiguous(
                memory_format=torch.channels_last)
            ms = time_ms(lambda: dwpw.dw_pw(x, dw_w, dw_b, pw_w, pw_b, r,
                                            **kw))
            pw8 = mb_q[name][node.parts[1].name]["w"].to(dev)
            ms8 = time_ms(lambda: dwpw.dw_pw(x, dw_w, dw_b, pw8.codes, pw_b,
                                             r, pw8.scale, **kw))
            plain8 = time_ms(lambda: dwpw.dw_pw_torch(
                x, dw_w, dw_b, pw8.codes, pw_b, r, pw8.scale, **kw))
            plain = time_ms(lambda: dwpw.dw_pw_torch(x, dw_w, dw_b, pw_w,
                                                     pw_b, r, **kw))
            pair = time_ms(lambda: F.conv2d(
                F.conv2d(x_cl, w_dw, dw_b, node.stride, 1, groups=c),
                w_pw, pw_b))
            nbytes = 2 * (x.numel() + dw_w.numel() + c + pw_w.numel() + co
                          + m * co * (2 if r is not None else 1))
            nops = 2 * m * c * (9 + co)
            t_b, t_o = bound(nbytes, nops, torch.bfloat16)
            nbytes8 = nbytes - pw_w.numel() + 4 * co     # codes + scales
            t_b8, t_o8 = bound(nbytes8, nops, torch.bfloat16)
            pl = dwpw.plan(1, ho, ho, c, co, node.k, node.stride)
            row = {"arch": name, "layer": node.name, "C": c, "Cout": co,
                   "H": node.in_hw, "stride": node.stride,
                   "residual": r is not None, "relu": node.relu,
                   "variant": dwpw.variant(c, co, node.k, node.stride),
                   "plan": pl._asdict(), "ms": ms,
                   "plain_ms": plain, "library_ms": pair,
                   "bound_ms": max(t_b, t_o), "bound_by": bound_by(t_b, t_o),
                   "bytes": nbytes, "ops": nops, "bytes_ms": t_b,
                   "ops_ms": t_o, "int8_ms": ms8, "int8_plain_ms": plain8,
                   "int8_bound_ms": max(t_b8, t_o8), "int8_bytes_ms": t_b8,
                   "int8_bytes": nbytes8}
            dw_pw_rows.append(row)
            add_sums(per_req, row)
            add_sums(dw_pw_sums, row)
            print(f"[time] {name} {node.name:8s} dw_pw C{c:5d} Cout{co:5d} "
                  f"H{node.in_hw:4d} s{node.stride} res={int(r is not None)}"
                  f": kernel {ms * 1e3:9.3f} us, plain {plain * 1e3:9.3f} us,"
                  f" F.conv2d dw+1x1 pair {pair * 1e3:9.3f} us, bound "
                  f"{row['bound_ms'] * 1e3:7.3f} us ({row['bound_by']}); int8"
                  f" kernel {ms8 * 1e3:9.3f} us, bound "
                  f"{max(t_b8, t_o8) * 1e3:7.3f} us; tm "
                  f"{pl.tm} ({pl.tr}x{pl.tw}) ck {pl.ck} split {pl.split}, "
                  f"{pl.blocks} blocks, {pl.steps} steps")
        for node in mb_dws[name]:
            c, ho = node.cin, node.conv_out_hw
            x = randn((1, node.in_hw, node.in_hw, c))
            w = mb_params[name][node.name]["w"].to(dev)
            x_cl = x.permute(0, 3, 1, 2)
            w_dw = w.permute(2, 0, 1).unsqueeze(1).contiguous(
                memory_format=torch.channels_last)
            ms = time_ms(lambda: dwk.depthwise_conv(x, w, stride=node.stride))
            plain = time_ms(lambda: dwk.depthwise_conv_torch(
                x, w, stride=node.stride))
            lib = time_ms(lambda: F.conv2d(x_cl, w_dw, None, node.stride, 1,
                                           groups=c))
            nbytes = 2 * (x.numel() + w.numel() + ho * ho * c)
            nops = 2 * ho * ho * c * 9
            t_b, t_o = bound(nbytes, nops, torch.bfloat16)
            r_px, threads = dwk.plan(1, ho, ho, c, node.k, node.stride)
            row = {"arch": name, "layer": node.name, "C": c,
                   "H": node.in_hw, "stride": node.stride, "r": r_px,
                   "threads": threads, "ms": ms,
                   "plain_ms": plain, "library_ms": lib,
                   "bound_ms": max(t_b, t_o), "bound_by": bound_by(t_b, t_o),
                   "bytes": nbytes, "ops": nops, "bytes_ms": t_b,
                   "ops_ms": t_o}
            dw_rows.append(row)
            add_sums(dw_per_req, row)
            add_sums(dw_sums, row)
            print(f"[time] {name} {node.name:8s} depthwise C{c:5d} "
                  f"H{node.in_hw:4d} s{node.stride}: kernel "
                  f"{ms * 1e3:9.3f} us, plain {plain * 1e3:9.3f} us, "
                  f"F.conv2d(groups=C) {lib * 1e3:9.3f} us, bound "
                  f"{row['bound_ms'] * 1e3:7.3f} us ({row['bound_by']}); "
                  f"{r_px} px x {threads} threads")
        mb_main[name]["dw_pw_per_request"] = per_req
        mb_main[name]["depthwise_per_request"] = dw_per_req
        print(f"[time] {name} per request: dw_pw x{MB_BLOCKS[name]} "
              f"{per_req['ms']:.4f} ms (plain {per_req['plain_ms']:.4f}, "
              f"F.conv2d pairs {per_req['library_ms']:.4f}, bound "
              f"{per_req['bound_ms']:.5f}; int8 {per_req['int8_ms']:.4f}, "
              f"bound {per_req['int8_bound_ms']:.5f}) vs request p50 "
              f"{mb_main[name]['p50_ms']:.4f} ms; unfused depthwise "
              f"x{MB_BLOCKS[name]} {dw_per_req['ms']:.4f} ms (plain "
              f"{dw_per_req['plain_ms']:.4f}, F.conv2d(groups=C) "
              f"{dw_per_req['library_ms']:.4f}, bound "
              f"{dw_per_req['bound_ms']:.5f})")

    # batch-1 serving, eager beside the graph (both above, same requests),
    # and the device time of one forward (no copies, no host) at each
    # store dtype: what a graph request costs on the card
    for (arch, q), row in serving.items():
        mcfg = get_config(arch)
        p_dev = cnn.params_to(quantize_tree(cnn_params[arch], q), dev)
        img = torch.zeros((1, IMAGE_SIZE, IMAGE_SIZE, 3), device=dev)
        row["forward_ms"] = time_ms(lambda: cnn.cnn_forward(
            mcfg, p_dev, img, device=dev))
        print(f"[time] serve {arch:12s} {q:6s}: eager p50 "
              f"{row['eager_p50_ms']:.4f} / p99 {row['eager_p99_ms']:.4f} ms,"
              f" graph p50 {row['graph_p50_ms']:.4f} / p99 "
              f"{row['graph_p99_ms']:.4f} ms; one forward on the device "
              f"{row['forward_ms']:.4f} ms; stored "
              f"{row['param_bytes_stored']} B")

    # The kernels at the throughput paths' microbatch shapes (n = 2, 4):
    # one microbatch forward's launches of each, bf16, beside the plain
    # versions, the bound and the library call, as at batch 1 above.
    mb_times = {}
    for n_ in PIPE_MB_SIZES:
        t = {"sparse_conv": {}, "sparse_matmul": {}, "dw_pw": {}}
        for node in layers:
            sw, b = conv_part_params(node)
            ob, n_k, bm, bn = sw.vals.shape
            ho = node.conv_out_hw
            x = randn((n_, node.in_hw, node.in_hw, node.cin))
            r = randn((n_, ho, ho, node.cout)) if node.residual_from else None
            kw = dict(k=node.k, stride=node.stride, relu=node.relu)
            w_lib = densify(sw).reshape(node.k, node.k, node.cin, node.cout) \
                .permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
            x_nchw = x.permute(0, 3, 1, 2)
            m = n_ * ho * ho
            x_elems = conv_input_elems(x.shape, sw.idx, node.k, node.stride,
                                       bm)
            nbytes = (x_elems * 2 + sw.vals.numel() * 2 + sw.idx.numel() * 4
                      + b.numel() * 2 + m * node.cout * 2
                      * (2 if r is not None else 1))
            t_b, t_o = bound(nbytes, 2 * m * ob * n_k * bm * bn,
                             torch.bfloat16)
            add_sums(t["sparse_conv"], {
                "ms": time_ms(lambda: sc.sparse_conv(x, sw.vals, sw.idx, b,
                                                     r, **kw)),
                "plain_ms": time_ms(lambda: sc.sparse_conv_torch(
                    x, sw.vals, sw.idx, b, r, **kw), reps=5, rounds=2),
                "library_ms": time_ms(lambda: F.conv2d(
                    x_nchw, w_lib, b, node.stride, node.k // 2)),
                "bound_ms": max(t_b, t_o), "bytes_ms": t_b, "ops_ms": t_o})
        x_fc = randn((n_, 2048), torch.float32)
        ob, n_k, bm, bn = fc_w.vals.shape
        t_b, t_o = bound(n_ * int(fc_w.idx.unique().numel()) * bm * 4
                         + fc_w.vals.numel() * 2 + fc_w.idx.numel() * 4
                         + n_ * ob * bn * 4, 2 * n_ * ob * n_k * bm * bn,
                         torch.float32)
        add_sums(t["sparse_matmul"], {
            "ms": time_ms(lambda: sm.sparse_matmul(x_fc, fc_w.vals,
                                                   fc_w.idx)),
            "plain_ms": time_ms(lambda: sm.sparse_matmul_torch(
                x_fc, fc_w.vals, fc_w.idx)),
            "library_ms": time_ms(lambda: torch.matmul(x_fc, w_fc_dense)),
            "bound_ms": max(t_b, t_o), "bytes_ms": t_b, "ops_ms": t_o})
        for name in MOBILENETS:
            for node in mb_blocks[name]:
                x, dw_w, dw_b, pw_w, pw_b, r, kw = dw_pw_args(name, node, n_)
                c, co, ho = node.cin, node.cout, node.conv_out_hw
                m = n_ * ho * ho
                x_cl = x.permute(0, 3, 1, 2)
                w_dw = dw_w.permute(2, 0, 1).unsqueeze(1).contiguous(
                    memory_format=torch.channels_last)
                w_pw = pw_w.t().reshape(co, c, 1, 1).contiguous(
                    memory_format=torch.channels_last)
                t_b, t_o = bound(2 * (x.numel() + dw_w.numel() + c
                                      + pw_w.numel() + co
                                      + m * co * (2 if r is not None else 1)),
                                 2 * m * c * (9 + co), torch.bfloat16)
                add_sums(t["dw_pw"], {
                    "ms": time_ms(lambda: dwpw.dw_pw(x, dw_w, dw_b, pw_w,
                                                     pw_b, r, **kw)),
                    "plain_ms": time_ms(lambda: dwpw.dw_pw_torch(
                        x, dw_w, dw_b, pw_w, pw_b, r, **kw), reps=5,
                        rounds=2),
                    "library_ms": time_ms(lambda: F.conv2d(F.conv2d(
                        x_cl, w_dw, dw_b, node.stride, 1, groups=c), w_pw,
                        pw_b)),
                    "bound_ms": max(t_b, t_o), "bytes_ms": t_b,
                    "ops_ms": t_o})
        for name, row in t.items():
            row["bound_by"] = bound_by(row["bytes_ms"], row["ops_ms"])
            print(f"[time] microbatch n={n_}: {name} (one forward's "
                  f"launches{' of both MobileNets' if name == 'dw_pw' else ''}"
                  f"): kernel {row['ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.4f} ms, library "
                  f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.5f} "
                  f"ms ({row['bound_by']})")
        mb_times[n_] = t

    # Where a tick's time goes, for each CNN (native) at the continuous
    # server's mb 2 and the batched executor's mb 4: each stage program
    # alone (its kernels, its wire unpack and pack), the S stages one
    # after another on one stream, one tick with the stages on their own
    # streams (fork, S stages, join), and the plain forward of the same
    # microbatch without any wire.
    ticks = {}
    for arch in STORE_RUNS:
        mcfg = get_config(arch)
        p_dev = cnn.params_to(cnn_params[arch], dev)
        plan_ = planner.plan(mcfg, cnn_params[arch], planner.PlanRequest(
            n_stages=PIPE_S))
        for mb in sorted({2, PIPE_BATCH // PIPE_M}):
            fns, pack_in, _, width = cnn.stage_programs(
                mcfg, p_dev, plan_["stage_of"],
                (mb, IMAGE_SIZE, IMAGE_SIZE, 3))
            img = randn((mb, IMAGE_SIZE, IMAGE_SIZE, 3), torch.float32)
            with torch.inference_mode():
                wires = [pack_in(img)]
                for fn in fns:
                    wires.append(fn(wires[-1]))
            state = torch.stack(wires[:PIPE_S])
            nxt = torch.empty_like(state)
            slots = pp.slot_streams(PIPE_S, 1, dev)
            stage_ms = [time_ms(lambda k=k: fns[k](state[k], out=nxt[k]))
                        for k in range(PIPE_S)]
            pfns, _, _, _, pparams = cnn.stage_programs(
                mcfg, cnn_params[arch], plan_["stage_of"],
                (mb, IMAGE_SIZE, IMAGE_SIZE, 3), placed=True,
                align=pp.ALIGN)
            prow = tuple(r.to(dev) for r in pparams.pack_ragged())
            row = {"stage_ms": stage_ms, "wire_width": width,
                   "chain_ms": time_ms(lambda: pp.pipeline_step_hetero(
                       fns, state, None, n_stages=PIPE_S, out=nxt)),
                   "tick_ms": time_ms(lambda: pp.pipeline_step_hetero(
                       fns, state, None, n_stages=PIPE_S, out=nxt,
                       streams=slots)),
                   "placed_tick_ms": time_ms(lambda: pp.pipeline_step_hetero(
                       pfns, state, None, n_stages=PIPE_S, out=nxt,
                       streams=slots, stage_params=prow)),
                   "forward_ms": time_ms(lambda: cnn.cnn_forward(
                       mcfg, p_dev, img, device=dev))}
            ticks[(arch, mb)] = row
            print(f"[time] tick {arch} mb {mb} (wire {width} f32): stages "
                  f"{[round(s, 4) for s in stage_ms]} ms (sum "
                  f"{sum(stage_ms):.4f}, max {max(stage_ms):.4f}); one "
                  f"stream {row['chain_ms']:.4f} ms, {PIPE_S} streams "
                  f"{row['tick_ms']:.4f} ms (placed programs on rows "
                  f"{row['placed_tick_ms']:.4f} ms); the plain forward of "
                  f"the microbatch {row['forward_ms']:.4f} ms")

    # The continuous server on its packed rows against closures (native,
    # mb 2, S 4; the servers of phase 4): the same 16 requests of 8 images,
    # three turns each, in alternation (rows, closures, closures, rows,
    # rows, closures); images/s of each run and their medians.
    placed_rates = {}
    for arch, srvs in placed_servers.items():
        reqs = [np.random.default_rng(SEED + 41 + i).normal(
            size=(CONT_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32)
            for i in range(CONT_REQUESTS)]
        rates = {"rows": [], "closures": []}
        first = {}
        for form in ("rows", "closures", "closures", "rows", "rows",
                     "closures"):
            srv = srvs[form]
            ids = [srv.submit(x) for x in reqs]
            m = srv.run()
            got = [srv.results(i) for i in ids]
            first.setdefault(form, got)
            rates[form].append(m["images_per_s"])
        if not all(np.array_equal(a.view(np.uint32), b.view(np.uint32))
                   for a, b in zip(first["rows"], first["closures"])):
            raise AssertionError(f"{arch}: rows and closures served other "
                                 f"logits")
        placed_rates[arch] = dict(
            rates, rows_median=statistics.median(rates["rows"]),
            closures_median=statistics.median(rates["closures"]))
        pr = placed_rates[arch]
        print(f"[time] continuous {arch} mb 2, S {PIPE_S}: on rows "
              f"{[round(v, 1) for v in rates['rows']]} im/s (median "
              f"{pr['rows_median']:.1f}), on closures "
              f"{[round(v, 1) for v in rates['closures']]} im/s (median "
              f"{pr['closures_median']:.1f}); rows / closures "
              f"{pr['rows_median'] / pr['closures_median']:.4f}")
    del placed_servers

    # SmolLM-360M: the flash kernel per layer of a T=2048 prefill, beside
    # its plain version and SDPA on the same expanded tensors; the sparse
    # matmul at its FFN shapes beside torch.matmul on the densified weight
    q, k, v = qkv(1, PREFILL_T, PREFILL_T, n_h, d_h, torch.bfloat16, n_kv)
    qt, kt, vt = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    flash_ms = time_ms(lambda: fa.flash_attention(q, k, v))
    flash_plain = time_ms(lambda: fa.flash_attention_torch(q, k, v), reps=2,
                          rounds=2)
    flash_lib = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    t_b, t_o = bound(4 * q.numel() * q.element_size(),
                     2 * n_h * PREFILL_T ** 2 * d_h, torch.bfloat16)
    flash_bound, flash_by = max(t_b, t_o), bound_by(t_b, t_o)
    print(f"[time] flash_attention {LM} layer B=1 T={PREFILL_T} H={n_h} "
          f"D={d_h} bf16 causal ({fa.variant(q.dtype, d_h)}): kernel "
          f"{flash_ms * 1e3:.3f} us, plain "
          f"{flash_plain * 1e3:.3f} us, SDPA {flash_lib * 1e3:.3f} us, bound "
          f"{flash_bound * 1e3:.3f} us ({flash_by}); x{n_l} per prefill: "
          f"{flash_ms * n_l:.4f} ms")
    def gemv_shape(ob, n_k, bm, bn) -> str:
        return (f", grid {sm.gemv_grid(ob, bn)} x "
                f"{sm.gemv_threads(n_k * bm, bn)} threads")

    lm_mm_rows = []
    for (name, m), (x, sw0) in lm_mm.items():
        ob, n_k, bm, bn = sw0.vals.shape
        w_dense = densify(sw0)
        ms = time_ms(lambda: sm.sparse_matmul(x, sw0.vals, sw0.idx))
        plain = time_ms(lambda: sm.sparse_matmul_torch(x, sw0.vals, sw0.idx))
        lib = time_ms(lambda: torch.matmul(x, w_dense))
        x_elems = m * int(sw0.idx.unique().numel()) * bm
        nbytes = (x_elems * 2 + sw0.vals.numel() * 2 + sw0.idx.numel() * 4
                  + m * ob * bn * 2)
        t_b, t_o = bound(nbytes, 2 * m * ob * n_k * bm * bn, torch.bfloat16)
        lm_mm_rows.append({"weight": name, "M": m,
                           "vals": list(sw0.vals.shape),
                           "variant": sm.variant(x.dtype, m, bm, bn),
                           "ms": ms,
                           "plain_ms": plain, "library_ms": lib,
                           "bound_ms": max(t_b, t_o),
                           "bound_by": bound_by(t_b, t_o)})
        print(f"[time] sparse_matmul {LM} {name} M={m} vals "
              f"{tuple(sw0.vals.shape)} bf16 ({lm_mm_rows[-1]['variant']}"
              f"{gemv_shape(ob, n_k, bm, bn) if m <= 8 else ''}): "
              f"kernel {ms * 1e3:.3f} us, plain "
              f"{plain * 1e3:.3f} us, torch.matmul (dense bf16) "
              f"{lib * 1e3:.3f} us, bound {max(t_b, t_o) * 1e3:.3f} us "
              f"({bound_by(t_b, t_o)})")
    mm_t = {(r["weight"], r["M"]): r for r in lm_mm_rows}
    ffn_prefill = {key: n_l * (2 * mm_t[("w1", PREFILL_T)][key]
                               + mm_t[("w2", PREFILL_T)][key])
                   for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    print(f"[time] {LM} prefill T={PREFILL_T}: {prefill_ms:.3f} ms; kernels: "
          f"flash_attention x{n_l} {flash_ms * n_l:.3f} ms, sparse_matmul "
          f"x{3 * n_l} {ffn_prefill['ms']:.3f} ms (torch.matmul on the "
          f"densified weights {ffn_prefill['library_ms']:.3f} ms); serve_lm "
          f"prefill_s {sout['prefill_s']:.4f}, decode_s "
          f"{sout['decode_s']:.4f}, {sout['tokens_per_s']:.2f} tok/s")
    lm_main = {"prefill_T": PREFILL_T, "prefill_ms": prefill_ms,
               "prefill_s_runs": prefill_s, "prefill_launches":
               prefill_launches, "check_T": CHECK_T,
               "prefill_logit_err": prefill_err, "serve": SERVE,
               "serve_launches": serve_launches,
               "serve_prefill_s": sout["prefill_s"],
               "serve_decode_s": sout["decode_s"],
               "serve_tokens_per_s": sout["tokens_per_s"],
               "serve_logit_err": serve_errs,
               "serve_sum_order_floor": floors,
               "layer_err_share_of_bar": layer_err,
               "flash": {"ms": flash_ms, "plain_ms": flash_plain,
                         "library_ms": flash_lib, "bound_ms": flash_bound,
                         "bound_by": flash_by},
               "sparse_matmul": lm_mm_rows,
               "ffn_per_prefill": ffn_prefill}

    # the large dense LMs: flash at D 128 and the sparse matmul at 128 x
    # 128 blocks (M 4: the serve_lm batch; M 2048: the prefill), each
    # beside its plain version, bound and library call; Qwen3-32B's
    # prefill latency and serve_lm times, the batchers' tok/s and TTFT
    # (phase 4's runs)
    large_flash_rows, large_mm_rows = large_timings(large_flash_inputs,
                                                    large_mm_inputs)
    del large_flash_inputs, large_mm_inputs
    for name, r in large_main.items():
        t_flash = next(x["ms"] for x in large_flash_rows
                       if x["what"] == f"{name} T={PREFILL_T}")
        t_mm = {w: next(x["ms"] for x in large_mm_rows
                        if (x["arch"], x["weight"], x["M"]) ==
                        (name, w, PREFILL_T)) for w in ("w1", "w2")}
        r["prefill_kernels_ms"] = {
            "flash_attention": r["layers"] * t_flash,
            "sparse_matmul": r["layers"] * (2 * t_mm["w1"] + t_mm["w2"])}
        print(f"[time] {name} ({r['layers']} layers) prefill T={PREFILL_T}: "
              f"{r['prefill_ms']:.3f} ms (median of 3); kernels: "
              f"flash_attention x{r['layers']} "
              f"{r['prefill_kernels_ms']['flash_attention']:.3f} ms, "
              f"sparse_matmul x{3 * r['layers']} "
              f"{r['prefill_kernels_ms']['sparse_matmul']:.3f} ms" +
              ("" if "serve" not in r else
               f"; serve_lm prefill_s {r['serve']['prefill_s']:.4f}, "
               f"decode_s {r['serve']['decode_s']:.4f}, "
               f"{r['serve']['tokens_per_s']:.2f} tok/s"))
    for name, r in moe_main.items():
        t_flash = next(x["ms"] for x in large_flash_rows
                       if x["what"] == f"{name} T={PREFILL_T}")
        r["prefill_kernels_ms"] = {"flash_attention": r["layers"] * t_flash}
        if name in FFN_128_LMS:
            t_mm = {w: next(x["ms"] for x in large_mm_rows
                            if (x["arch"], x["weight"], x["M"]) ==
                            (name, w, PREFILL_T)) for w in ("w1", "w2")}
            r["prefill_kernels_ms"]["sparse_matmul"] = r["layers"] * (
                2 * t_mm["w1"] + t_mm["w2"])
        print(f"[time] {name} ({r['layers']} layers) prefill T={PREFILL_T}: "
              f"{r['prefill_ms']:.3f} ms (median of 3); kernels: " +
              ", ".join(f"{k} {v:.3f} ms" for k, v in
                        r["prefill_kernels_ms"].items()) +
              f"; decode step batch {STEP_BATCH} {r['step_ms']:.3f} ms" +
              ("" if "serve" not in r else
               f"; serve_lm TTFT {r['serve']['prefill_s']:.4f} s, decode_s "
               f"{r['serve']['decode_s']:.4f}, "
               f"{r['serve']['tokens_per_s']:.2f} tok/s"))
    for name, b in batcher_main.items():
        st = b["stats"]
        print(f"[time] {name} ContinuousBatcher: {st['throughput_tok_s']:.2f}"
              f" tok/s, mean TTFT {st['mean_ttft_s']:.4f} s, mean latency "
              f"{st['mean_latency_s']:.4f} s ({b['steps']} steps, "
              f"{st['tokens']} tokens; every request submitted at the start)")

    # -- 6. the measured cost model and the tuned kernels -----------------
    # For each CNN at native weights: calibrate (the autotuner times every
    # plan each kernel can run at each distinct node shape, then every
    # fused node is timed on the card under the winners) at batch 1 and at
    # the batched cell's microbatch (mb 4); the MobileNets' dw_pw is also
    # tuned at n 2 and their depthwise on the unfused view at n 1. Every
    # tuned plan runs against its plain version at the shape it was tuned
    # at, and is timed beside plan()'s default (dw_pw beside the cuDNN
    # pair). Then S 4 cuts from each cache beside the analytic one, each
    # stage program timed alone at mb 4 under its cache, and the batched
    # executor (batch 16, M 4) under each cut, twice: launches counted
    # with the counters reset just before and read just after, the logits
    # equal to the sequential forward under the same cache bit for bit.
    # Last, n_microbatches=0 and auto_split=True once each.
    from repro_torch.core import tuning
    t_phase = time.perf_counter()
    tune_mb = PIPE_BATCH // PIPE_M
    sig = tuning.device_signature(dev)
    tuned = {"sparse_conv": [], "dw_pw": [], "depthwise_conv": []}

    def tuned_sites(arch, graph_, cache, n_img, p_dev):
        """Every knob site of ``graph_`` at batch ``n_img``: the plan the
        cache holds against the plain version and timed beside plan()'s
        default; dw_pw also beside the cuDNN pair."""
        mcfg_ = get_config(arch)
        shapes = cnn.node_shapes(mcfg_, None,
                                 (n_img, IMAGE_SIZE, IMAGE_SIZE, 3),
                                 graph=graph_)
        sites = {}
        for node, edge in zip(graph_.nodes, graph_.inputs):
            s_in = tuple(shapes[edge[0]].shape)
            site = (node.kind, s_in, node.k, node.stride, node.cout)
            if site in sites:
                sites[site][1] += 1
            else:
                sites[site] = [node, 1]
        for (kind, s_in, k_, stride, co), (node, count) in sites.items():
            x = randn(s_in)
            ho = -(-s_in[1] // stride)
            pair_ms = None
            if kind == "conv":
                p = p_dev[conv_part(node).name]
                sw = p["w"]
                if not isinstance(sw, SparseWeight):
                    continue
                ob, n_k, bm, bn = sw.vals.shape
                key = tuning.kernel_key(
                    "sconv", s_in, torch.bfloat16, device=sig, k=k_,
                    s=stride, b=f"{bm}x{bn}K{n_k}", co=ob * bn)
                plan_t = (cache.knob(key, "tm"), cache.knob(key, "split"))
                plan_d = sc.plan(n_img * ho * ho, ob, n_k)
                kw = dict(k=k_, stride=stride, relu=node.relu)

                def run(pl, x=x, sw=sw, b=p["b"], kw=kw):
                    return sc.sparse_conv(x, sw.vals, sw.idx, b, plan=pl,
                                          **kw)
                want = sc.sparse_conv_torch(x, sw.vals, sw.idx, p["b"], **kw)
                name, fmt = "sparse_conv", (lambda pl: f"tm{pl[0]} s{pl[1]}")
            elif kind == "dw_pw":
                dw_p = p_dev[node.parts[0].name]
                pw_p = p_dev[conv_part(node).name]
                c = s_in[-1]
                key = tuning.kernel_key("dwpw", s_in, torch.bfloat16,
                                        device=sig, k=k_, s=stride, co=co)
                knobs = [cache.knob(key, n) for n in ("tm", "tn", "ck",
                                                      "split")]
                plan_d = dwpw.plan(n_img, ho, ho, c, co, k_, stride)
                plan_t = None if None in knobs else dwpw.make_plan(
                    n_img, ho, ho, c, co, k_, stride, *knobs)
                kw = dict(stride=stride, dw_relu=node.parts[0].relu,
                          relu=node.relu)
                args = (x, dw_p["w"], dw_p["b"], pw_p["w"], pw_p["b"])

                def run(pl, args=args, kw=kw):
                    return dwpw.dw_pw(*args, plan=pl, **kw)
                want = dwpw.dw_pw_torch(*args, **kw)
                x_cl = x.permute(0, 3, 1, 2)
                w_dw = dw_p["w"].permute(2, 0, 1).unsqueeze(1).contiguous(
                    memory_format=torch.channels_last)
                w_pw = pw_p["w"].t().reshape(co, c, 1, 1).contiguous(
                    memory_format=torch.channels_last)
                pair_ms = time_ms(lambda: F.conv2d(F.conv2d(
                    x_cl, w_dw, dw_p["b"], stride, 1, groups=c), w_pw,
                    pw_p["b"]))
                name = "dw_pw"

                def fmt(pl):
                    return f"tm{pl.tm} tn{pl.tn} ck{pl.ck} s{pl.split}"
            elif kind == "dw":
                w = p_dev[node.name]["w"]
                key = tuning.kernel_key("dw", s_in, torch.bfloat16,
                                        device=sig, k=k_, s=stride)
                plan_t = (cache.knob(key, "r"), cache.knob(key, "threads"))
                plan_d = dwk.plan(n_img, ho, ho, s_in[-1], k_, stride)

                def run(pl, x=x, w=w, stride=stride):
                    return dwk.depthwise_conv(x, w, stride=stride, plan=pl)
                want = dwk.depthwise_conv_torch(x, w, stride=stride)
                name, fmt = "depthwise_conv", (
                    lambda pl: f"r{pl[0]} t{pl[1]}")
            else:
                continue
            if plan_t is None or None in tuple(plan_t):
                raise AssertionError(f"{arch} {node.name} n={n_img}: the "
                                     f"cache holds no tuned plan at {key}")
            got = run(plan_t)
            torch.cuda.synchronize()
            err = compare(got, want, bf16_tol,
                          f"tuned {name} {arch} {node.name} n={n_img} "
                          f"{fmt(plan_t)}")
            row = {"arch": arch, "node": node.name, "n": n_img,
                   "count": count, "plan": fmt(plan_t),
                   "default": fmt(plan_d), "max_abs_err": err,
                   "ms": time_ms(lambda: run(plan_t)),
                   "default_ms": time_ms(lambda: run(plan_d)),
                   "tuner_us": cache.time_us(key), "pair_ms": pair_ms}
            tuned[name].append(row)

    caches = {}
    for arch in STORE_RUNS:
        mcfg = get_config(arch)
        p_dev = cnn.params_to(cnn_params[arch], dev)
        shapes_n = (1, 2, tune_mb) if arch in MOBILENETS else (1, tune_mb)
        for n_img in shapes_n:
            t0 = time.perf_counter()
            shape = (n_img, IMAGE_SIZE, IMAGE_SIZE, 3)
            if n_img == 2:         # dw_pw at the continuous cell's mb
                cache = tuning.autotune_graph(mcfg, p_dev, shape)
            else:
                cache = tuning.calibrate(mcfg, p_dev, shape, autotune=True,
                                         iters=TUNE_ITERS)
            if arch in MOBILENETS and n_img == 1:
                tuning.autotune_graph(mcfg, p_dev, shape,
                                      graph=graph_for(arch), cache=cache)
            caches[(arch, n_img)] = cache
            tuning.set_tuning_cache(None)
            n_kern = sum(k.startswith("kern/") for k in cache.entries)
            print(f"[tune] {arch} n={n_img}: {len(cache) - n_kern} node "
                  f"times, {n_kern} tuned kernel sites in "
                  f"{time.perf_counter() - t0:.1f}s")
            tuned_sites(arch, fused_graph_for(arch), cache, n_img, p_dev)
            if arch in MOBILENETS and n_img == 1:
                tuned_sites(arch, graph_for(arch), cache, n_img, p_dev)
    for name, rows_ in tuned.items():
        for r_ in rows_:
            print(f"[tune] {name} {r_['arch']} {r_['node']:8s} n={r_['n']} "
                  f"(x{r_['count']}): tuned {r_['plan']} "
                  f"{r_['ms'] * 1e3:.2f} us, plan() {r_['default']} "
                  f"{r_['default_ms'] * 1e3:.2f} us"
                  + (f", cuDNN pair {r_['pair_ms'] * 1e3:.2f} us"
                     if r_["pair_ms"] is not None else "")
                  + f"; vs plain {r_['max_abs_err']:.2e}")
    tuned_sums = {}
    for name, rows_ in tuned.items():
        for n_img in sorted({r_["n"] for r_ in rows_}):
            rs = [r_ for r_ in rows_ if r_["n"] == n_img]
            s_ = {key: sum(r_[key] * r_["count"] for r_ in rs)
                  for key in ("ms", "default_ms")}
            if name == "dw_pw":
                s_["pair_ms"] = sum(r_["pair_ms"] * r_["count"] for r_ in rs)
            s_["changed"] = sum(r_["plan"] != r_["default"] for r_ in rs)
            s_["sites"] = len(rs)
            tuned_sums[(name, n_img)] = s_
            print(f"[tune] {name} n={n_img}, one forward of "
                  f"{'both MobileNets' if name != 'sparse_conv' else 'ResNet-50'}"
                  f": tuned {s_['ms']:.4f} ms, plan() {s_['default_ms']:.4f}"
                  f" ms" + (f", cuDNN pair {s_['pair_ms']:.4f} ms"
                            if name == "dw_pw" else "")
                  + f"; {s_['changed']} of {s_['sites']} sites tuned away "
                  f"from plan()")

    plans_run = {}
    for arch in STORE_RUNS:
        mcfg = get_config(arch)
        p_dev = cnn.params_to(cnn_params[arch], dev)
        per_fwd, per_fwd_v = per_request_want(arch, "native")
        analytic = planner.plan(mcfg, cnn_params[arch], planner.PlanRequest(
            n_stages=PIPE_S))
        cuts = {"analytic": (analytic, None)}
        for n_img in (1, tune_mb):
            cache = caches[(arch, n_img)]
            with tuning.device_scope(dev):
                cuts[f"measured n{n_img}"] = (planner.plan(
                    mcfg, cnn_params[arch], planner.PlanRequest(
                        n_stages=PIPE_S, model="measured",
                        tuning_cache=cache)), cache)
        # the mb-4 cut with plan()'s kernels: the same node times, no
        # tuned kernel plans, so the cut and the knobs show apart
        cache = caches[(arch, tune_mb)]
        bare = tuning.TuningCache({k: v for k, v in cache.entries.items()
                                   if k.startswith("node/")}, cache.meta)
        cuts[f"measured n{tune_mb}, plan() kernels"] = (
            cuts[f"measured n{tune_mb}"][0], bare)
        rows_ = {}
        for label, (plan_, cache) in cuts.items():
            cov = plan_["measured_coverage"]
            if cache is not None and cov["coverage"] != 1.0:
                raise AssertionError(f"{arch} {label}: coverage {cov}")
            tuning.set_tuning_cache(cache)
            fns, pack_in, _, width = cnn.stage_programs(
                mcfg, p_dev, plan_["stage_of"],
                (tune_mb, IMAGE_SIZE, IMAGE_SIZE, 3))
            img = randn((tune_mb, IMAGE_SIZE, IMAGE_SIZE, 3), torch.float32)
            with torch.inference_mode():
                wires = [pack_in(img)]
                for fn in fns:
                    wires.append(fn(wires[-1]))
            s_used = len(fns)
            state = torch.stack(wires[:s_used])
            nxt = torch.empty_like(state)
            stage_ms = [time_ms(lambda k=k: fns[k](state[k], out=nxt[k]))
                        for k in range(s_used)]
            tuning.set_tuning_cache(None)
            rows_[label] = {
                "stage_of": plan_["stage_of"],
                "predicted": [float(c) for c in plan_["stage_cost"]],
                "predicted_ratio": plan_["imbalance"], "stage_ms": stage_ms,
                "measured_ratio": max(stage_ms) / (sum(stage_ms) / s_used),
                "images_per_s_runs": []}
        # each cut served twice, in turns (a, b, c, d, d, c, b, a), so the
        # spread within the run shows beside the differences
        for label in list(cuts) + list(reversed(cuts)):
            plan_, cache = cuts[label]
            ops.reset_launches()
            res = _serve_cnn(arch, batch=PIPE_BATCH, n_microbatches=PIPE_M,
                             n_stages=PIPE_S, image_size=IMAGE_SIZE,
                             iters=PIPE_ITERS, seed=SEED, tuning_cache=cache)
            counted, variants = dict(ops.LAUNCHES), dict(ops.VARIANT_LAUNCHES)
            what = f"{arch} batched, {label} cut"
            check_launches(counted, {k: v * PIPE_M * 2
                                     for k, v in per_fwd.items()}, what)
            check_variants(variants, {k: v * PIPE_M * 2
                                      for k, v in per_fwd_v.items()}, what)
            add_variants(variants)
            for k, v in counted.items():
                all_launches[k] = all_launches.get(k, 0) + v
            if res["stage_of"] != plan_["stage_of"]:
                raise AssertionError(f"{what}: served {res['stage_of']}")
            if tuning.current_tuning_cache() is not cache:
                raise AssertionError(f"{what}: the cache is not installed")
            with torch.inference_mode():
                seq = torch.cat([cnn.cnn_forward(
                    mcfg, p_dev, torch.from_numpy(res["images"][i:i + tune_mb]),
                    device=dev).cpu() for i in range(0, PIPE_BATCH, tune_mb)])
            tuning.set_tuning_cache(None)
            if not torch.equal(torch.from_numpy(res["logits"]), seq):
                raise AssertionError(f"{what}: logits differ from the "
                                     f"sequential forward under the cache")
            rows_[label]["images_per_s_runs"].append(res["images_per_s"])
        for label, row in rows_.items():
            row["images_per_s"] = statistics.median(row["images_per_s_runs"])
            plans_run[(arch, label)] = row
            unit = "cycles" if cuts[label][1] is None else "us"
            print(f"[plan] {arch} S {PIPE_S} {label} cut {row['stage_of']}: "
                  f"predicted stages {[round(c, 1) for c in row['predicted']]}"
                  f" {unit} (max/mean {row['predicted_ratio']:.3f}); on the "
                  f"card at mb {tune_mb} "
                  f"{[round(t_ * 1e3, 1) for t_ in row['stage_ms']]} us "
                  f"(max/mean {row['measured_ratio']:.3f}); batched "
                  f"{PIPE_BATCH} M {PIPE_M}: "
                  f"{[round(v, 1) for v in row['images_per_s_runs']]} im/s; "
                  f"== sequential (mb {tune_mb}) under the same cache bitwise")

    # n_microbatches=0 (M from the measured stage costs) and auto_split
    # (one card: S 1, R 1), each once, under the mb-4 cache
    for arch, kw in (("mobilenet_v1", {"n_microbatches": 0}),
                     ("resnet50", {"n_microbatches": PIPE_M,
                                   "auto_split": True})):
        mcfg = get_config(arch)
        p_dev = cnn.params_to(cnn_params[arch], dev)
        per_fwd, _ = per_request_want(arch, "native")
        cache = caches[(arch, tune_mb)]
        ops.reset_launches()
        res = _serve_cnn(arch, batch=PIPE_BATCH, n_stages=PIPE_S,
                         image_size=IMAGE_SIZE, iters=PIPE_ITERS, seed=SEED,
                         tuning_cache=cache, **kw)
        m_ = res["n_microbatches"]
        check_launches(dict(ops.LAUNCHES), {k: v * m_ * 2
                                            for k, v in per_fwd.items()},
                       f"{arch} {kw}")
        for k, v in ops.LAUNCHES.items():
            all_launches[k] = all_launches.get(k, 0) + v
        mb_ = -(-PIPE_BATCH // m_)
        with torch.inference_mode():
            seq = torch.cat([cnn.cnn_forward(
                mcfg, p_dev, torch.from_numpy(res["images"][i:i + mb_]),
                device=dev).cpu() for i in range(0, PIPE_BATCH, mb_)])
        tuning.set_tuning_cache(None)
        if not torch.equal(torch.from_numpy(res["logits"]), seq):
            raise AssertionError(f"{arch} {kw}: logits differ from the "
                                 f"sequential forward (mb {mb_})")
        if kw.get("auto_split") and (res["n_stages"], res["n_replicas"]) != \
                (1, 1):
            raise AssertionError(f"{arch} auto_split: S {res['n_stages']}, "
                                 f"R {res['n_replicas']} on one card")
        plans_run[(arch, str(kw))] = {"n_microbatches": m_,
                                      "n_stages": res["n_stages"],
                                      "images_per_s": res["images_per_s"]}
        print(f"[plan] {arch} {kw}: M {m_}, S {res['n_stages']}, R "
              f"{res['n_replicas']}: {res['images_per_s']:.1f} im/s; == "
              f"sequential (mb {mb_}) under the cache bitwise")
    print(f"[tune] phase 6 in {time.perf_counter() - t_phase:.1f}s")

    # -- 7. the fault-tolerant tier (runtime/tier.py) ---------------------
    # ResNet-50 at 224 px, S 4, mb 2. Through serve(): the in-process tier
    # (R 2) at native and int8, without a failure and with replica 0
    # failed at tick 3, every request equal to the no-failure run's and
    # to the sequential forward, microbatch by microbatch, bit for bit;
    # procs=2 with worker 0 SIGKILLed at its first tick and hosts=2 with
    # worker 1 SIGKILLed, equal to the in-process tier's bits. Then two
    # dial-in workers, one of them through a NetFaultProxy whose
    # connections are killed mid-stream; the respawned worker, once ready,
    # serves a second stream, bitwise again. Last, images/s of one
    # CNNPipelineServer against the in-process tier at R 1 and R 2 on the
    # same stream, in turns. The counters are reset just before each
    # in-process serve and read just after: the replicas' warm-ups and
    # captures (a replay runs no Python); the workers report theirs with
    # ``ready``.
    import socket as _socket
    from repro_torch.core.device import deterministic_convs
    from repro_torch.runtime import fault as rt_fault
    from repro_torch.runtime import tier as rt_tier
    t_phase = time.perf_counter()
    r50 = get_config("resnet50")
    per_fwd, per_fwd_v = per_request_want("resnet50", "native")
    tier_rows = {}
    tier_launches = {k: 0 for k in ops.LAUNCHES}
    worker_launches = {k: 0 for k in ops.LAUNCHES}
    tier_kw = dict(arch="resnet50", n_stages=PIPE_S, mb_size=TIER_MB,
                   image_size=IMAGE_SIZE, batch=TIER_BATCH, seed=SEED,
                   device="cuda", verbose=False)

    def bits_equal(a, b) -> bool:
        return a.shape == b.shape and np.array_equal(a.view(np.uint32),
                                                     b.view(np.uint32))

    def tier_line(what, m, extra=""):
        print(f"[tier] {what}: {m['images']} images, {m['images_per_s']:.1f}"
              f" im/s ({m['elapsed_s']:.3f} s), respawns {m['respawns']}, "
              f"recovered microbatches {m['recovered_microbatches']}"
              + extra)

    def secs(v):
        return "none" if v is None else f"{v:.3f} s"

    def ready_str(m):
        return ", spawn-to-ready " + ", ".join(
            f"w{r['idx']} gen {r['generation']} {r['seconds']:.2f} s"
            for r in m["ready_times"])

    def add_worker_launches(ready_times, what):
        for r in ready_times:
            check_launches(r["launches"], {k: v * 4 for k, v in
                                           per_fwd.items()},
                           f"{what}: worker {r['idx']} gen "
                           f"{r['generation']} up to ready")
            for k, v in r["launches"].items():
                worker_launches[k] += v

    tier_logits = {}
    for q in ("native", "int8"):
        outs = []
        for label, fail in (("no failure", {}),
                            ("replica 0 failed at tick 3",
                             {"fail_replica": 0, "fail_at_tick": 3})):
            ops.reset_launches()
            m = serve(ServeConfig(tier=True, replicas=2,
                                  n_requests=TIER_REQUESTS, quantize=q,
                                  **tier_kw, **fail))
            counted, variants = dict(ops.LAUNCHES), dict(ops.VARIANT_LAUNCHES)
            what = f"tier R 2 {q}, {label}"
            # each replica: 2 eager warm-up ticks and 2 captured ticks
            check_launches(counted, {k: v * 8 for k, v in per_fwd.items()},
                           what)
            check_variants(variants, {k: v * 8 for k, v in
                                      per_fwd_v.items()}, what)
            add_variants(variants)
            for k, v in counted.items():
                tier_launches[k] += v
                all_launches[k] = all_launches.get(k, 0) + v
            if (m["completed"], m["failed"]) != (TIER_REQUESTS, 0) or \
                    m["respawns"] != (1 if fail else 0) or \
                    (fail and not m["recovered_microbatches"]):
                raise AssertionError(f"{what}: {m}")
            outs.append(m)
            tier_line(what, m)
            tier_rows[f"inprocess/{q}/{'failure' if fail else 'clean'}"] = {
                k: m[k] for k in ("images_per_s", "elapsed_s", "respawns",
                                  "recovered_microbatches", "rounds",
                                  "replica_ticks", "latency_p50_s",
                                  "latency_p99_s")}
        params_q = cnn.params_to(quantize_tree(
            _init_native(r50, SEED), q), dev)
        def sequential(x):
            with torch.inference_mode():
                return torch.cat([cnn.cnn_forward(
                    r50, params_q, torch.from_numpy(x[j:j + TIER_MB]),
                    device=dev).cpu() for j in range(0, len(x), TIER_MB)
                ]).numpy()
        # the sequential forward under the replicas' cuDNN setting is the
        # contract; the one under the process's own setting only says
        # whether that setting changes a bit here
        same_outside = 0
        for i, (x, a, b) in enumerate(zip(outs[0]["request_images"],
                                          outs[0]["logits"],
                                          outs[1]["logits"])):
            with deterministic_convs():
                seq = sequential(x)
            if not (bits_equal(a, b) and bits_equal(b, seq)) or \
                    not np.isfinite(b).all():
                raise AssertionError(f"tier {q} request {i}: the failed "
                                     f"run, the clean run and the sequential"
                                     f" forward differ")
            same_outside += bits_equal(b, sequential(x))
        tier_logits[q] = outs[0]["logits"]
        tier_images = outs[0]["request_images"]
        tier_rows[f"inprocess/{q}/same_bits_outside_deterministic_convs"] = \
            same_outside
        print(f"[tier] {q}: {TIER_REQUESTS} requests, failed run == clean "
              f"run == sequential forward (mb {TIER_MB}) bitwise; the "
              f"sequential forward outside deterministic_convs (cudnn "
              f"benchmark={torch.backends.cudnn.benchmark}, deterministic="
              f"{torch.backends.cudnn.deterministic}) gives the same bits "
              f"on {same_outside} of {TIER_REQUESTS} requests")

    for label, kw in (("procs=2, worker 0 SIGKILLed at tick 1",
                       {"procs": 2, "kill_worker": 0}),
                      ("hosts=2, worker 1 SIGKILLed at tick 1",
                       {"hosts": 2, "kill_worker": 1})):
        ops.reset_launches()
        m = serve(ServeConfig(n_requests=TIER_PROC_REQUESTS, kill_at_tick=1,
                              **tier_kw, **kw))
        if any(ops.LAUNCHES.values()):
            raise AssertionError(f"{label}: the supervisor launched kernels")
        [death] = m["worker_exits"]
        if (m["completed"], m["failed"], m["respawns"]) != (
                TIER_PROC_REQUESTS, 0, 1) or death["exit_code"] != -9 or \
                death["idx"] != kw["kill_worker"]:
            raise AssertionError(f"{label}: {m}")
        add_worker_launches(m["ready_times"], label)
        for i, (a, b) in enumerate(zip(tier_logits["native"], m["logits"])):
            if not bits_equal(a, b):
                raise AssertionError(f"{label} request {i}: differs from "
                                     f"the in-process tier")
        tier_line(label, m, ready_str(m) + f"; detection to the first "
                  f"recovered result {secs(m['recovery_s'])} "
                  f"(detected via {death['detected_via']}); == in-process "
                  f"tier bitwise")
        tier_rows[label] = {k: m[k] for k in (
            "images_per_s", "elapsed_s", "respawns", "recovered_microbatches",
            "recovery_s", "worker_exits", "ready_times")}

    # a connection cut mid-stream: worker 1 dials through the proxy
    sock = _socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    proxy = rt_fault.NetFaultProxy(("127.0.0.1", port))
    reqs = tier_images[:TIER_PROC_REQUESTS]
    label = "hosts=2, worker 1's connection killed"
    try:
        with rt_tier.HostServingTier(
                "resnet50", n_procs=2, n_stages=PIPE_S, mb_size=TIER_MB,
                image_size=IMAGE_SIZE, seed=SEED,
                listen=("127.0.0.1", port),
                dial_addrs={1: proxy.address}) as ht:
            # worker 1's frames (results, heartbeats) are swallowed from
            # the submit to the kill, so the kill lands with its work
            # outstanding whatever the timing
            proxy.sever("c2s")
            rids = [ht.submit(x) for x in reqs]
            ht.run(max_rounds=2)
            proxy.heal("c2s")
            t_kill = time.perf_counter()
            proxy.kill_connections()
            deadline = t_kill + 600
            while ht._live_rids() and time.perf_counter() < deadline:
                ht.run(max_rounds=20)
            got = [ht.results(r) for r in rids]
            done_s = time.perf_counter() - t_kill
            m = {"images": len(reqs) * TIER_BATCH, "respawns": ht.respawns,
                 "recovered_microbatches": ht.recovered_microbatches,
                 "recovery_s": ht.recovery_times[0]
                 if ht.recovery_times else None}
            ht._wait_ready()               # the respawned worker warms up
            # worker 0 sits idle past the death bound before the second
            # stream: idle time must not read as a stalled tick
            idle_until = t_kill + done_s + ht.detector.dead_after_s + 0.5
            while time.perf_counter() < idle_until:
                ht._wait_events(0.1)
            idle_s = time.perf_counter() - t_kill - done_s
            rids = [ht.submit(x) for x in reqs]
            again = ht.run()
            got2 = [ht.results(r) for r in rids]
            m.update(images_per_s=again["images_per_s"],
                     elapsed_s=again["elapsed_s"],
                     ready_times=list(ht.ready_times),
                     worker_exits=list(ht.worker_exits),
                     blob_bytes_served=ht.blob_bytes_served)
    finally:
        proxy.close()
    if m["respawns"] < 1 or not m["recovered_microbatches"] or \
            [d["idx"] for d in m["worker_exits"]] != [1]:
        raise AssertionError(f"{label}: {m}")
    add_worker_launches(m["ready_times"], label)
    for i, (a, b, c) in enumerate(zip(tier_logits["native"], got, got2)):
        if not (bits_equal(a, b) and bits_equal(a, c)):
            raise AssertionError(f"{label} request {i}: differs from the "
                                 f"in-process tier")
    tier_line(label + f", then a second stream after {idle_s:.1f} s idle",
              m, ready_str(m) +
              f"; kill to the last result {done_s:.3f} s, to the first "
              f"recovered result {secs(m['recovery_s'])} after detection; "
              f"blob {m['blob_bytes_served']} B served; both streams == "
              f"in-process tier bitwise")
    tier_rows[label] = dict(m, kill_to_done_s=done_s, idle_s=idle_s)

    # images/s: one server against the tier at R 1 and R 2, and R 2 with
    # replica 0 failed mid-stream (at its tick TIER_FAIL_TICK, in the
    # TIER_RATE_ROUNDS // 2-th serving or so), each serving the 16 requests
    # TIER_RATE_ROUNDS times (the queue never deeper than one stream), in
    # turns; the tier's host time a scheduler round. The server is built
    # under deterministic_convs, as every tier replica is, so all four run
    # the same cuDNN algorithms. A failure's cost: the serving it fell in
    # against the median of the other servings of that stream.
    reqs = tier_images
    rates = {"server": [], "tier R 1": [], "tier R 2": [],
             "tier R 2 failed": []}
    round_ms = {k: [] for k in rates if k != "server"}
    fail_cost_ms, slept_ms, servings_ms, ticks_of = [], [], {}, {}
    for label in list(rates) + list(reversed(rates)) + list(rates):
        slept = []
        if label == "server":
            with deterministic_convs():
                obj = CNNPipelineServer(
                    "resnet50", mb_size=TIER_MB, n_stages=PIPE_S,
                    image_size=IMAGE_SIZE, seed=SEED, device=dev)
        else:
            fail = label.endswith("failed")
            obj = rt_tier.ServingTier(
                "resnet50", n_replicas=2 if "R 2" in label else 1,
                n_stages=PIPE_S, mb_size=TIER_MB, image_size=IMAGE_SIZE,
                seed=SEED, injectors={0: rt_fault.FailureInjector(
                    fail_at_steps=(TIER_FAIL_TICK,))} if fail else None,
                sleep=lambda t: (slept.append(t), time.sleep(t)))
        n_img, elapsed, n_rounds, per_serving = 0, 0.0, 0, []
        for _ in range(TIER_RATE_ROUNDS):
            rids = [obj.submit(x) for x in reqs]
            m = obj.run()
            got = [obj.results(r) for r in rids]
            if not all(bits_equal(a, b) for a, b in
                       zip(tier_logits["native"], got)):
                raise AssertionError(f"{label}: logits differ from the "
                                     f"tier's")
            n_img += m["images"]
            elapsed += m["elapsed_s"]
            n_rounds += m.get("rounds", 0)
            per_serving.append((m["elapsed_s"], m.get("respawns", 0)))
        rates[label].append(n_img / elapsed)
        servings_ms.setdefault(label, []).append(
            [round(e * 1e3, 3) for e, _ in per_serving])
        if label in round_ms:
            round_ms[label].append(elapsed / n_rounds * 1e3)
            ticks_of.setdefault(label, []).append(m["replica_ticks"])
        if label == "tier R 2 failed":
            # the serving in which the respawn count first moved
            hit = next((i for i, (_, r) in enumerate(per_serving) if r), 0)
            if per_serving[-1][1] != 1 or hit in (0, TIER_RATE_ROUNDS - 1):
                raise AssertionError(f"{label}: the failure did not fall "
                                     f"mid-stream: {per_serving}")
            rest = [e for i, (e, _) in enumerate(per_serving) if i != hit]
            fail_cost_ms.append((per_serving[hit][0] - float(np.median(
                rest))) * 1e3)
            slept_ms.append(sum(slept) * 1e3)
    tier_rows["images_per_s"] = rates
    tier_rows["round_ms"] = round_ms
    tier_rows["failure_cost_ms"] = fail_cost_ms
    tier_rows["failure_slept_ms"] = slept_ms
    tier_rows["servings_ms"] = servings_ms
    tier_rows["replica_ticks"] = ticks_of
    print(f"[tier] images/s, {TIER_RATE_ROUNDS} x {len(reqs)} x {TIER_BATCH}"
          f" images at mb {TIER_MB}, S {PIPE_S}, in turns: " + "; ".join(
              f"{k} {[round(v, 1) for v in vs]}" for k, vs in rates.items())
          + "; ms a scheduler round: " + "; ".join(
              f"{k} {[round(v, 4) for v in vs]}"
              for k, vs in round_ms.items())
          + "; all == the tier's logits bitwise")
    print(f"[tier] R 2, replica 0 failed at its tick {TIER_FAIL_TICK}: the "
          f"serving it fell in took {[round(v, 3) for v in fail_cost_ms]} "
          f"ms over the median of the other {TIER_RATE_ROUNDS - 1}; the "
          f"tier slept {[round(v, 3) for v in slept_ms]} ms in all")
    for k in ("tier R 2", "tier R 2 failed"):
        print(f"[tier] {k}: ticks a replica {ticks_of[k]}; ms a serving "
              f"{servings_ms[k]}")
    def counts_str(d):
        return ", ".join(f"{k}: {v}" for k, v in d.items() if v) or "none"
    print(f"[tier] phase 7 in {time.perf_counter() - t_phase:.1f}s; "
          f"launches in this process {counts_str(tier_launches)}, in the "
          f"workers up to ready {counts_str(worker_launches)}")

    (ROOT / "build").mkdir(exist_ok=True)
    (ROOT / "build" / "chip_smoke.json").write_text(json.dumps({
        "device": smi, "build_s": build_s,
        "build_s_by_source": _build.BUILD_SECONDS, "p50_ms": p50_ms,
        "p99_ms": p99_ms, "latencies_s": out["request_latencies_s"],
        "launches": launches, "conv_layers": rows,
        "fc": {"ms": fc_ms, "plain_ms": fc_plain, "library_ms": fc_lib,
               "bound_ms": fc_bound, "bound_by": fc_by},
        "mobilenet": mb_main, "dw_pw_layers": dw_pw_rows,
        "serving": {f"{a}/{q}": row for (a, q), row in serving.items()},
        "param_bytes_stored": param_bytes, "fc_int8": fc8,
        "depthwise_layers": dw_rows, "smollm": lm_main,
        "large_lms": large_main, "batcher": batcher_main,
        "moe_vlm": moe_main,
        "large_lm_kernels": {"flash": large_flash_rows,
                             "sparse_matmul": large_mm_rows},
        "throughput": {f"{a}/{q}": dict(row, continuous={
            f"mb{mb}/{'streams' if st else 'one_stream'}": c
            for (mb, st), c in row["continuous"].items()})
            for (a, q), row in pipe.items()},
        "microbatch_kernel_times": mb_times,
        "ticks": {f"{a}/mb{mb}": row for (a, mb), row in ticks.items()},
        "variant_launches": {f"{n}/{v}": c for (n, v), c in
                             all_variants.items()},
        "ptxas": resources, "hmma": hmma,
        "tuned_kernels": tuned,
        "tuned_sums": {f"{n}/n{k}": v for (n, k), v in tuned_sums.items()},
        "cuts": {f"{a}/{lbl}": row for (a, lbl), row in plans_run.items()},
        "oracle": oracle_rows, "placed": placed_rows,
        "placed_rates": placed_rates,
        "tier": tier_rows}, indent=1, default=str))

    # -- 8. the kernels line, then the device line ------------------------
    kernels = [
        {"name": "sparse_conv", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sparse_conv.cu",
         "replaces": "src/repro/kernels/sparse_conv.py:203",
         "launches": all_launches["sparse_conv"],
         "launches_per_request": 47,
         "max_abs_err": conv_err, "max_err": conv_err, "ok": True,
         "ms": sums["ms"], "plain_ms": sums["plain_ms"],
         "bound_ms": sums["bound_ms"],
         "bound_by": bound_by(sums["bytes_ms"], sums["ops_ms"]),
         "library_ms": sums["library_ms"],
         "int8": {"ms": sums["int8_ms"], "plain_ms": sums["int8_plain_ms"],
                  "bound_ms": sums["int8_bound_ms"],
                  "bound_by": bound_by(sums["int8_bytes_ms"],
                                       sums["ops_ms"])},
         "note": "ms, plain_ms, bound_ms, library_ms: sums over the 47 "
                 "main-path layers of one request (all mma); int8: the "
                 "same with the int8 store's codes and scales; launches: "
                 "counted by the wrappers (warm-up and capture of each "
                 "graph, every request of the eager runs excluded); "
                 "variants: "
                 "launches by variant over the main paths; ptxas, hmma: per "
                 "kernel function"},
        {"name": "sparse_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sparse_matmul.cu",
         "replaces": "src/repro/kernels/sparse_matmul.py:68",
         "launches": all_launches["sparse_matmul"],
         "launches_per_request": 1,
         "launches_per_prefill": 3 * n_l,
         "max_abs_err": mm_err, "max_err": mm_err, "ok": True,
         "ms": fc_ms, "plain_ms": fc_plain, "bound_ms": fc_bound,
         "bound_by": fc_by, "library_ms": fc_lib,
         "int8": fc8,
         "smollm": lm_mm_rows,
         "large_lms": large_mm_rows,
         "note": "ms, plain_ms, bound_ms, library_ms: the ResNet-50 "
                 "classifier (M=1 f32, gemv); smollm: per call at "
                 "SmolLM-360M's FFN shapes (M=4 gemv, M=2048 mma), library "
                 "torch.matmul on the densified bf16 weight; large_lms: "
                 "the same at the 128x128 FFN blocks of Qwen3-32B, "
                 "Mistral-Nemo-12B, Granite-20B and llava-next-mistral-7b "
                 "(M=4 gemv, M=2048 mma); "
                 "variants: launches by variant over the main paths; "
                 "ptxas, hmma: per kernel function"},
        {"name": "dw_pw", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/dw_pw.cu",
         "replaces": "src/repro/kernels/dw_pw_fused.py:137",
         "launches": all_launches["dw_pw"],
         "launches_per_request": dict(MB_BLOCKS),
         "max_abs_err": dw_pw_err, "max_err": dw_pw_err, "ok": True,
         "ms": dw_pw_sums["ms"], "plain_ms": dw_pw_sums["plain_ms"],
         "bound_ms": dw_pw_sums["bound_ms"],
         "bound_by": bound_by(dw_pw_sums["bytes_ms"], dw_pw_sums["ops_ms"]),
         "library_ms": None,
         "library_pair_ms": dw_pw_sums["library_ms"],
         "library_pair": "F.conv2d(groups=C) then 1x1 F.conv2d, channels-"
                         "last bf16: two calls, no single call computes "
                         "the fused function",
         "int8": {"ms": dw_pw_sums["int8_ms"],
                  "plain_ms": dw_pw_sums["int8_plain_ms"],
                  "bound_ms": dw_pw_sums["int8_bound_ms"],
                  "bound_by": bound_by(dw_pw_sums["int8_bytes_ms"],
                                       dw_pw_sums["ops_ms"])},
         "ms_per_request": {n: mb_main[n]["dw_pw_per_request"]["ms"]
                            for n in MOBILENETS},
         "note": "ms, plain_ms, bound_ms, library_pair_ms: sums over one "
                 "request of MobileNet-V1 (13 layers) and one of "
                 "MobileNet-V2 (17 layers), all mma; variants: launches "
                 "by variant over the main paths; ptxas, hmma: per kernel "
                 "function"},
        {"name": "depthwise_conv", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/depthwise_conv.cu",
         "replaces": "src/repro/kernels/depthwise_conv.py:121",
         "launches": all_launches["depthwise_conv"],
         "launches_per_request": dict(MB_BLOCKS),
         "max_abs_err": dw_err, "max_err": dw_err, "ok": True,
         "ms": dw_sums["ms"], "plain_ms": dw_sums["plain_ms"],
         "bound_ms": dw_sums["bound_ms"],
         "bound_by": bound_by(dw_sums["bytes_ms"], dw_sums["ops_ms"]),
         "library_ms": dw_sums["library_ms"],
         "ms_per_request": {n: mb_main[n]["depthwise_per_request"]["ms"]
                            for n in MOBILENETS},
         "note": "ms, plain_ms, bound_ms, library_ms: sums over one "
                 "unfused forward of MobileNet-V1 (13 dw nodes) and one of "
                 "MobileNet-V2 (17); library: F.conv2d(groups=C)"},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:92",
         "launches": all_launches["flash_attention"],
         "launches_per_prefill": n_l,
         "max_abs_err": flash_err, "max_err": flash_err, "ok": True,
         "ms": flash_ms, "plain_ms": flash_plain, "bound_ms": flash_bound,
         "bound_by": flash_by, "library_ms": flash_lib,
         "large_lms": large_flash_rows,
         "note": f"ms, plain_ms, bound_ms, library_ms: one layer of a "
                 f"{LM} prefill (B=1, T={PREFILL_T}, H={n_h}, D={d_h}, "
                 f"bf16, causal; the mma variant); library: "
                 f"F.scaled_dot_product_attention on the same expanded "
                 f"tensors; large_lms: the same at a T={PREFILL_T} layer "
                 f"of Qwen3-32B, Mistral-Nemo-12B, Granite-20B, "
                 f"granite-moe-3b-a800m (D=64), moonshot-v1-16b-a3b and "
                 f"llava-next-mistral-7b, and at Qwen3-32B's last cache "
                 f"chunk (SDPA with a causal mask there); variants: "
                 f"launches by variant over the main paths; ptxas, hmma: "
                 f"per kernel function"},
    ]
    for entry in kernels:
        name = entry["name"]
        # the throughput paths: launches counted over every batched and
        # continuous run (warm-ups and captures), the checks at the
        # microbatch shapes, one microbatch forward's launches timed there
        entry["throughput"] = {
            "launches": pipe_launches.get(name, 0),
            "max_abs_err": mb_err.get(name),
            "by_microbatch": {n: mb_times[n].get(name)
                              for n in PIPE_MB_SIZES}}
        rows_ = tuned.get(name)
        # the plans the autotuner chose at each site (arch/node/batch),
        # and plan()'s where they differ; sparse_matmul and flash have no
        # knobs
        entry["tuned"] = {
            "knobs": {f"{r['arch']}/{r['node']}/n{r['n']}": r["plan"]
                      for r in rows_},
            "defaults_where_changed": {
                f"{r['arch']}/{r['node']}/n{r['n']}": r["default"]
                for r in rows_ if r["plan"] != r["default"]},
            "max_abs_err": max(r["max_abs_err"] for r in rows_),
            "by_n": {n_: tuned_sums[(name, n_)] for n_ in sorted(
                {r["n"] for r in rows_})}} if rows_ else None
        # the tier (phase 7): launches counted in this process while the
        # replicas warmed up and captured, and by the workers up to ready
        entry["tier"] = {"launches": tier_launches.get(name, 0),
                         "worker_launches": worker_launches.get(name, 0)}
        entry["ptxas"] = resources[name]
        entry["hmma"] = hmma[name]
        if name in _build.VARIANTS:
            entry["variants"] = {v: all_variants[(name, v)]
                                 for v in _build.VARIANTS[name]}
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"[chip_smoke] {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    sys.exit(rc)
