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
   ("gemv") and 2048 ("mma"); flash_attention at D 112 (zamba2-7b's
   heads: T 2048 under its window of 4096, a window shorter than T, a
   windowed cache chunk with q_offset, f32) and at whisper-large-v3's
   shapes (D 64: non-causal 1500 x 1500, causal 448, cross 448 x 1500),
   sparse_matmul at whisper's 64 x 64 FFN blocks (M 1-4, 448, 1500) and
   zamba2's 128 x 128 ones (M 1-4, 2048); then the stored weights: int8 codes with their scales through
   sparse_conv "mma" at every ResNet-50 layer shape (residual on and
   off), the int8 classifier through "gemv", int8 dw_pw "mma" at every
   MobileNet block shape, and one "simt" shape each in int8 and in f32
   (sparse_conv, sparse_matmul, dw_pw); then the throughput paths'
   microbatch shapes, n 2 and 4: sparse_conv at every ResNet-50 layer
   shape, the classifier (M 2, 4) and dw_pw at every MobileNet block
   shape, bf16 and int8 (each shape's plan printed); then the sparse
   ResNet-50 example's shapes: sparse_conv at every layer's input at 64
   px, batch 2 (spatial 16x16 down to 2x2), residual on and off, and the
   classifier at M 2; each check also
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
   moonshot-v1-16b-a3b (12 of its 48 layers, 64 experts top-6: a depth
   cut, ``DEPTH``) through a prefill (12 flash) and a batch-4 step;
   llava-next-mistral-7b (32 layers) through a prefill of 576 patch
   embeddings and 1472 tokens (32 flash + 96 sparse_matmul "mma") and a
   batch-4 step (96 "gemv"); the share of expert assignments dropped at
   the prefill and the step; every layer against the CPU layer (an MoE
   layer in two halves, the experts fed the card's attention output on
   both devices: expert ids and kept assignments equal and the output
   within 1 bf16 ulp at every token clear of a near tie); then the
   recurrent and encoder-decoder LMs at full width and depth:
   rwkv6-1.6b (24 layers) through a T 2048 prefill (no hand-written
   kernel: its chunked WKV and dense projections are plain torch), a
   batch-4 decode step, ``serve_lm`` and the continuous batcher (8
   slots, 24 requests, the admitted slot's state zeroed; every request
   within 3e-2 of its teacher-forced replay); zamba2-7b (42 of its 81
   Mamba2 layers, a depth cut, ``DEPTH``: 7 of its 13 shared-attention
   sites) through a T 2048 prefill (7 flash "mma" at D 112, 21
   sparse_matmul "mma"), a batch-4 step (21 "gemv"), ``serve_lm`` and the
   batcher; whisper-large-v3 (32 + 32 layers)
   through a prefill of 1500 frames and 448 tokens (96 flash: 32
   non-causal 1500 x 1500, 32 causal, 32 cross 448 x 1500; 192
   sparse_matmul "mma" at 64 x 64), ``lm.fill_cross_kv`` and a batch-4
   step on the filled cache (96 "gemv"), ``serve_lm`` with the encoder's
   fill; every layer of the three, with its state, on the card's own
   input within 1 bf16 ulp of the CPU layer, and the chunked WKV and SSD
   scans alone at T 2048 from a carried state within 1e-4 of the CPU's;
   then LM training (``train_run``): each kernel's
   ``torch.autograd.Function`` (the kernel forward, a plain backward)
   against autograd through its plain version at the training shapes
   (flash (4, 4096, 15, 64) causal, sparse_matmul at M 16384 on
   SmolLM-360M's w1 and w2), forward and every input gradient within 1
   bf16 ulp; SmolLM-360M at full width and depth through
   ``launch.train.train`` (12 steps of batch 4 x seq 4096, remat "full",
   Markov tokens: 64 flash + 192 sparse_matmul "mma" a step, the loss
   finite and falling) and 3 more steps through ``make_train_step``
   (timed); a checkpoint of the full state saved and restored bit for
   bit; one step at T 256 against the port's CPU step (the loss within
   1e-3, every gradient within 5e-2 relative L2 beside the CPU's f64
   floor, the update fed the card's gradients within 1 bf16 ulp of the
   CPU's; int8 compression of those gradients within scale / 2); the
   stage-pipelined step (S 4, M 4, T 1024, batch 4, the ``plan_lm_stages``
   cut) bit for bit its sequential run and within 1e-3 of
   ``make_train_step``'s loss; at 4 layers (a depth cut) 10 steps with
   checkpoints every 3 and failures at steps 4 and 7 (2 restarts) bit for
   bit the clean run, and 5 steps with int8 gradients; every LM family at
   ``reduced()`` through one train step on the card, its launches
   counted, against the plain versions on the card;
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
   decode-step latencies and granite-moe's ``serve_lm`` times; flash
   at zamba2's D 112 prefill and whisper's three shapes, sparse_matmul
   at their FFN blocks (SDPA with the same masks, ``torch.matmul`` on the
   densified weight), the three models' prefill and step latencies and
   ``serve_lm`` times, the batchers' tok/s and TTFT; the training shapes
   (flash (4, 4096, 15, 64), sparse_matmul at M 16384) beside their plain
   versions, bounds, SDPA and ``torch.matmul``, and the plain backwards;
   the train step's time, tokens/s and the share of it in the kernels'
   forwards and in the plain backwards; checkpoint save and restore; the
   pipelined step;
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
7b. the mesh tooling and the placed tier (``placed_tier_run``,
   ``dryrun_lines``): ResNet-50 at 224 px, S 4 x R 2 on 8 device slots
   of the card (``launch.mesh.device_slots``), each replica's even param
   buffer placed on its 4 slots: phase 7's 16 requests through it equal
   the unplaced tier's logits bit for bit; the same stream with 4 slots
   lost after 2 scheduler rounds (``lose_devices``: the cut reused, one
   replica respawned on slots {0, 1, 6, 7}, its buffer re-placed by
   ``_remesh_buffer``) and with 5 lost (3 survivors: a new cut, every
   replica rebuilt), each bit for bit the no-failure run; each tier's
   launches exactly 4 forwards' a server it built (2 warm-up ticks, 2
   captures); images/s placed and unplaced in turns, the re-plan's and
   the remesh's times, the loss to the first recovered result; then the
   analytic dry run (``launch.dryrun.run_cell``) of every applicable
   (arch, shape) at 16 x 16 and 2 x 16 x 16 on the H100's numbers, one
   line each, and ResNet-50's placed pipeline cell on 4 slots. (Phase 4's
   training path also runs the pipelined step on a stage mesh of 4 slots:
   bit for bit the mesh-less step, its launches counted; phase 5 times
   the plain backwards' library calls and states their bounds.)
7c. the examples (``examples_run``; ``examples/torch_*.py``, each
   example's function at the reference example's own arguments, its
   launches counted by name and variant, an ``[example]`` line each with
   its wall time): first flash at D 32 (H 4; B x T 8 x 64, 8 x 128, 4 x
   32, and 4 x 32 under zamba2's window 64) and sparse_matmul at reduced
   SmolLM-360M's 16 x 16 FFN blocks (M 2 "gemv", 128, 512, 1024 "mma")
   against their plain versions, then timed with the 47 convs at 64 px,
   batch 2; the sparse ResNet-50 (the plan equal to the CPU's on the same
   weights, the logits within LOGIT_RTOL of max |logit| of the plain CPU
   forward with top-1 equal, 47 sparse_conv + 1 sparse_matmul a
   forward); the quickstart (30 steps, the loss falling, ``serve(arch,
   ...)`` giving (2, 8) tokens); the resilient run (200 steps, 2
   restarts, int8 gradients, the mean of the last 10 losses below the
   first; the stragglers printed); the MoE / hybrid plans (equal to the
   CPU's) and 20 steps each (finite); the dry run's CNN cell planned
   from phase 6's batch-1 cache (its stage costs phase 6's measured
   plan);
7d. the kernels' whole domains (``domain_run``, ``domain_kernels``):
   sparse ResNet-50 with SparsityConfig's default 128 x 128 blocks at
   full width, 224 px (30 convs at 128 x 128, 3 at 64 x 64, the
   classifier at 128 x 125), native and int8: 50 batch-1 requests, each a
   replay of one CUDA graph of ``cnn.cnn_forward`` (captured as
   ``latency_request`` captures it), and the same requests eagerly, graph
   == eager bit for bit; ``CNNPipelineServer(cfg=, params=, plan=)`` at mb
   2, S 4 on ``planner.plan``'s cut, 16 requests of 8 images, == the
   sequential forward at mb 2 bit for bit; launches exactly 33
   sparse_conv "mma" + 1 sparse_matmul "gemv" a forward; the first
   request's logits within LOGIT_RTOL of max |logit| of the plain CPU
   forward, top-1 equal, every node fed the card's own input within 1
   bf16 ulp; p50 / p99 and images/s beside the 32 x 32 cell's of this
   run (a ``[domain]`` line each); then each kernel at the shapes only
   its widened variants take, against its plain version (1 bf16 ulp, f32
   1e-5 relative) and timed beside its bound and a library call: the 33
   convs at n 1 / 2 / 4 (``F.conv2d`` on the densified weight), the
   classifier's 128 x 125 blocks at M 1 / 4 / 16 and square blocks of
   side 96 and 256 at M 4 and 2048 (``torch.matmul``), flash at D 80, 96
   (H 32) and 256 (H 16), T 2048 causal, and at D 16 and 40 (T 256) in
   both dtypes (SDPA), dw_pw int8 and f32 at k 5 and 7 and bf16 at k 9
   (the cuDNN depthwise + 1x1 pair), depthwise_conv at k 9
   (``F.conv2d(groups=C)``); ``[time] domain`` lines;
8. one ``{"kernels": [...]}`` line (each kernel with the knobs it was
   tuned to, its launches in the tier phase, in phase 7b and the mesh
   step, in phase 7c's examples, and in phase 7d with the shapes only its
   widened variants take), then the device line last.

Per-layer numbers are also written to ``build/chip_smoke.json``.

The first build compiles five sources, one nvcc each, in parallel; the
stored weight type is a template argument: sparse_conv's mma and simt
for bf16 and int8 (simt also f32; mma once for one-piece blocks, bm and
bn <= 32, and once for any other), sparse_matmul's gemv for bf16 and
int8 x f32 and bf16 inputs at 4 row counts x 3 block sizes (48) and simt
for all three (and its mma for whole 64 x 64 pieces and for ragged
ones), dw_pw's mma at k 1-7 for bf16 (42) and at k 3 for int8
(6), its simt at k 1-7 for bf16, at k 3 for int8 and f32, and at a
run-time k for all three stores (every other k); flash's mma at 11
padded head sizes, each for D equal to it and for a smaller D, and its
simt at 6 column chunks in f32 and one in
bf16; depthwise_conv's templated kernel at k 1-7 and the run-time k one.

Serving alone, on the card's machine from the root of a checkout:
``PYTHONPATH=src python -m repro_torch.launch.serve --arch mobilenet_v2
--quantize int8`` (50 requests at 224 px, each a CUDA graph replay;
``--quantize`` native, f32, bf16 or int8); add ``--device cpu
--image-size 32`` for the CPU's plain path.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import io
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


def scan_tol(ref: torch.Tensor) -> torch.Tensor:
    """A chunked scan's f32 sums in another order: 1e-4 of the output's
    max."""
    return torch.full_like(ref, 1e-4 * float(ref.abs().max()))


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


CHECKED_VARIANTS: dict = {}     # (kernel, variant) -> checks run


def launch_checked(name: str, want_variant: str, launch, what: str):
    """``launch()`` launches kernel ``name`` once, in the variant
    ``want_variant`` that its ``variant()`` names for these inputs."""
    from repro_torch.kernels import ops
    key = (name, want_variant)
    before = ops.VARIANT_LAUNCHES[key]
    out = launch()
    if ops.VARIANT_LAUNCHES[key] != before + 1:
        raise AssertionError(f"{name} {what}: the {want_variant} variant "
                             f"did not launch: {ops.VARIANT_LAUNCHES}")
    CHECKED_VARIANTS[key] = CHECKED_VARIANTS.get(key, 0) + 1
    return out


def check_logits(logits, images, cfg_, params_, graph=None,
                 rtol=LOGIT_RTOL, n=2) -> float:
    """The card's logits of the first ``n`` requests against the plain
    CPU forward: within ``rtol`` of max |logit|, top-1 equal.
    Returns the larger max |err| / max |logit|."""
    from repro_torch.models import cnn
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


def check_nodes(dev, cfg_, graph, params_dev, params_cpu_, image) -> float:
    """Each node of ``graph`` on the card ``dev`` against the same node
    on the CPU, fed the card's own input to that node: bf16 outputs
    within 1 bf16 ulp, the f32 logits within LOGIT_RTOL of max |logit|.
    Returns the worst error as a share of its bar."""
    from repro_torch.core.graph import INPUT
    from repro_torch.models import cnn
    env = {INPUT: torch.from_numpy(image).to(dev).to(torch.bfloat16)}
    worst = 0.0
    with torch.inference_mode():
        for node, srcs in zip(graph.nodes, graph.inputs):
            args = [env[s] for s in srcs]
            got = cnn.run_node(node, params_dev, *args)
            want = cnn.run_node(node, params_cpu_, *[a.cpu() for a in args])
            env[node.name] = got
            torch.cuda.synchronize()
            tol = bf16_tol if want.dtype == torch.bfloat16 else logit_tol
            compare(got.cpu(), want, tol, f"{cfg_.name} node {node.name}")
            err = (got.cpu().float() - want.float()).abs()
            share = err / tol(want.float()).clamp_min(1e-38)
            worst = max(worst, float(share.max()))
    return worst


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


def time_conv(node, sw, b, x, r, plain_reps: dict | None = None) -> dict:
    """One sparse conv of ``node`` (NHWC bf16 ``x``, residual ``r`` or
    None) timed on the card: the kernel, its plain version (``time_ms``
    with ``plain_reps``) and ``F.conv2d`` on the densified weights; the
    bound from the bytes (the input the surviving blocks read, weights,
    index and bias, the output and residual once each) and the kept
    blocks' operations, in bf16."""
    from repro_torch.core.sparsity import densify
    from repro_torch.kernels import sparse_conv as sc
    ob, n_k, bm, bn = sw.vals.shape
    kw = dict(k=node.k, stride=node.stride, relu=node.relu)
    w_lib = densify(sw).reshape(node.k, node.k, node.cin, node.cout) \
        .permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    x_nchw = x.permute(0, 3, 1, 2)        # channels_last view, no copy
    ms = time_ms(lambda: sc.sparse_conv(x, sw.vals, sw.idx, b, r, **kw))
    plain = time_ms(lambda: sc.sparse_conv_torch(x, sw.vals, sw.idx, b, r,
                                                 **kw), **(plain_reps or {}))
    lib = time_ms(lambda: F.conv2d(x_nchw, w_lib, b, node.stride,
                                   node.k // 2))
    ho = -(-x.shape[1] // node.stride)
    m = x.shape[0] * ho * ho
    x_elems = conv_input_elems(x.shape, sw.idx, node.k, node.stride, bm)
    nbytes = (x_elems * 2 + sw.vals.numel() * 2 + sw.idx.numel() * 4
              + b.numel() * 2 + m * node.cout * 2
              * (2 if r is not None else 1))
    nops = 2 * m * ob * n_k * bm * bn
    t_b, t_o = bound(nbytes, nops, torch.bfloat16)
    return {"ms": ms, "plain_ms": plain, "library_ms": lib,
            "bound_ms": max(t_b, t_o), "bound_by": bound_by(t_b, t_o),
            "bytes_ms": t_b, "ops_ms": t_o, "bytes": nbytes, "ops": nops,
            "input_read": x_elems / x.numel()}


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
# D 128; 28.06B parameters at its 48 layers, 12 run: ``DEPTH``) through
# a prefill and a batch-4 step;
# llava-next-mistral-7b through a prefill of its 576 patch embeddings
# (drawn from the seed) and 1472 tokens, and a batch-4 step. Every layer
# on the card's own input against the CPU layer; an MoE layer in two
# halves, attention, then the experts fed the card's attention output
# on both devices, held at the tokens clear of a near routing tie
# (checks.clear(route, MOE_TIE_MARGIN)).
GRANITE_MOE = "granite-moe-3b-a800m"
MOONSHOT = "moonshot-v1-16b-a3b"
MOE_LMS = (GRANITE_MOE, MOONSHOT)
# Depth cuts of earlier paths, to keep the script well inside its time
# limit as it grows, measured on one H100: moonshot runs 12 of its 48
# layers (at full depth its CPU layer check alone took 56-112 s of a
# 538-851 s script and its weights 52.27 GiB; at 24 layers the check took
# 40-43 s); zamba2-7b runs 42 of its 81 layers, 7 of its 13
# shared-attention sites (its phase took 108-126 s of a 703-851 s script
# at full depth, 74 s at 42 layers), since the training phase added ~150
# s. Set below, with zamba2's name.
DEPTH = {MOONSHOT: 12}
VLM = "llava-next-mistral-7b"
BATCHER[GRANITE_MOE] = dict(BATCHER[LM])
MOE_SERVE = dict(QWEN_SERVE)
STEP_BATCH = 4
# the models whose T = PREFILL_T flash (and 128 x 128 FFN) shapes phase 3
# checks and phase 5 times
PREFILL_LMS = LARGE_LMS + MOE_LMS + (VLM,)
FFN_128_LMS = LARGE_LMS + (VLM,)
# The recurrent and encoder-decoder LMs at full width and depth:
# rwkv6-1.6b (24 layers, d 2048, 32 heads of 64; its chunked WKV and its
# dense projections are plain torch: no hand-written kernel), zamba2-7b
# (81 Mamba2 layers, 42 run: ``DEPTH``; the shared attention block after
# every 6th: 13 sites, 7 run, flash at D 112 with its window of 4096, its
# FFN pruned at 128 x 128) and whisper-large-v3 (32 encoder and 32 decoder layers, d 1280,
# 20 heads of 64: flash non-causal over the 1500 frames, causal over the
# tokens and across, Tq 448 x Tk 1500; the FFNs pruned at 64 x 64), each
# through a prefill (whisper: 1500 frames and its published 448 decoder
# positions), a batch-4 decode step (whisper's on a cross_kv filled by
# its encoder), serve_lm (whisper's with the encoder's fill) and, for
# rwkv6 and zamba2, the continuous batcher (BATCHER[LM]'s spec; the
# admitted slot's recurrent state zeroed); every layer, with its state,
# on the card's own input against the CPU layer.
RWKV, ZAMBA, WHISPER = "rwkv6-1.6b", "zamba2-7b", "whisper-large-v3"
STATE_LMS = (RWKV, ZAMBA, WHISPER)
DEPTH[ZAMBA] = 42
WHISPER_T = 448          # whisper's max_target_positions
BATCHER[RWKV] = dict(BATCHER[LM])
BATCHER[ZAMBA] = dict(BATCHER[LM])
STATE_SERVE = dict(QWEN_SERVE)
# sparse_matmul rows phase 3 checks at the new FFN shapes: gemv at the
# decode rows, mma at whisper's decoder (448) and encoder (1500) rows and
# zamba2's prefill (2048)
STATE_MM_M = {WHISPER: (1, 2, 3, 4, WHISPER_T, 1500),
              ZAMBA: (1, 2, 3, 4, PREFILL_T)}


# LM training (phase 4's last path): SmolLM-360M at full width and depth
# through ``launch.train.train`` (remat "full", the AdamW config train()
# builds, Markov tokens with branching 8), seq 4096 (SHAPES["train_4k"])
# at batch 4 a card (cut from that shape's global batch of 256)
TRAIN_T = 4096
TRAIN_B = 4
TRAIN_STEPS = 12
TIMED_STEPS = 3          # make_train_step after the 12, host clock each
# train()'s AdamW config (warmup steps // 10, cosine to 0.1 lr) at
# AdamWConfig's own lr, 3e-4, not train()'s default 3e-3 (which the
# reference's tests use at reduced() size): at full width 3e-3 after a
# 1-step warmup moves every bf16 weight ~10% a step, and the loss rose
# 10.96 -> 11.63 over the first 4 steps before falling back to 11.07 at
# step 11 (an H100 run, PERF.md)
TRAIN_LR = 3e-4
# the restart run and the compression run: full width, 4 layers (a depth
# cut; the restart contract is bit for bit, stricter than the
# reference's 1e-3 loss bar)
CUT_LAYERS = 4
RESTART = dict(steps=10, ckpt_every=3, fail_at=(4, 7))
COMPRESS_STEPS = 5
# the stage-pipelined step: full width and depth, S 4, M 4, T 1024, B 4
PIPE_TRAIN = dict(stages=4, microbatches=4, seq=1024, batch=4)
# one step on the card against the port's CPU step (CHECK_T tokens,
# batch 1, full width): the loss within TRAIN_LOSS_RTOL relative; each
# floating leaf's gradient within GRAD_L2_RTOL relative L2. The CPU's own
# floor (its f32 fdot sums against f64 ones) is printed beside it: bf16
# gradients rounded at other ops part by ~1e-2 relative L2 (on an H100:
# worst 9.2e-3, the CPU's floor worst 8.4e-3, PERF.md; the CPU tests
# measure 0.7-3.0e-2 between the port and the reference), so the bar is
# 5e-2
TRAIN_LOSS_RTOL = 1e-3
GRAD_L2_RTOL = 5e-2
# the pipelined step's loss (a full log_softmax) against make_train_step's
# (chunked) on the same batch: other sums, the same function
PIPE_LOSS_RTOL = 1e-3
# every LM family at reduced() size: one make_train_step (remat "full")
# on the card through the kernels against the plain versions on the card
FAMILY_LMS = ("smollm-360m", "qwen3-32b", "mistral-nemo-12b", "granite-20b",
              "granite-moe-3b-a800m", "moonshot-v1-16b-a3b",
              "llava-next-mistral-7b", "rwkv6-1.6b", "zamba2-7b",
              "whisper-large-v3")
FAMILY_BT = (2, 64)
# Phase 7c, the examples (``examples/torch_*.py``) at the reference
# examples' own arguments: the sparse ResNet-50 example's batch and image
# size (its 47 conv shapes at 64 px, spatial 16x16 down to 2x2, and the
# classifier at M 2 are checked in phase 3), and the LM examples' kernel
# shapes on the reduced() configs (d_model 128, 4 heads of 32, FFN 256 in
# 16 x 16 blocks): flash at the training (B, T) of the quickstart (8 x
# 64), the resilient run (8 x 128) and the MoE / hybrid runs (4 x 32;
# zamba2's window 64), the FFN at those B x T rows and at 2 decoding
EXAMPLES = ("torch_sparse_resnet_inference", "torch_quickstart",
            "torch_resilient_training", "torch_moe_expert_parallel")
EX_BATCH, EX_IMAGE = 2, 64
EX_FLASH = ((8, 64, 0), (8, 128, 0), (4, 32, 0), (4, 32, 64))
EX_MM_M = (2, 128, 512, 1024)

# Phase 7d, the kernels' whole domains: sparse ResNet-50 with
# SparsityConfig's default 128 x 128 blocks at full width, 224 px (30
# convs at 128 x 128, the 3 whose 64 input channels 128 does not divide at
# 64 x 64, the classifier at 128 x 125), built through the entry points
# that take a config; then every kernel at the shapes only the widened
# variants take: the 33 convs at n 1 / 2 / 4, the classifier's blocks at
# M 1 / 4 / 16, square blocks of side 96 and 256 at M 4 and 2048, flash at
# the public head sizes 80, 96 and 256 (Phi-2, Phi-3-mini, Gemma-7B) at T
# 2048 and at 16 and 40 in both dtypes, dw_pw int8 and f32 at k 5 and 7
# and bf16 at k 9, depthwise_conv at k 9
DOMAIN_BLOCKS = {(128, 128): 30, (64, 64): 3, (128, 125): 1}
DOMAIN_CONV_N = (1, 2, 4)
DOMAIN_FC_M = (1, 4, 16)
DOMAIN_MM = ((96, 960, 1920), (256, 2048, 2048))   # (side, d_in, d_out)
DOMAIN_MM_M = (4, 2048)
DOMAIN_FLASH = ((1, 2048, 32, 80), (1, 2048, 32, 96), (1, 2048, 16, 256))
DOMAIN_FLASH_SMALL = ((1, 256, 8, 16), (1, 256, 8, 40))   # both dtypes
DOMAIN_DW_PW = (("int8", 5), ("int8", 7), ("f32", 5), ("f32", 7),
                ("bf16", 9))
DOMAIN_DW_PW_SHAPES = ((128, 128, 56, 1), (512, 512, 14, 2))  # C, Cout, H, s
DOMAIN_DW_SHAPES = ((256, 28, 1), (144, 56, 2))                # C, H, s
DOMAIN_DW_K = 9
# what each kernel took on in the closing slice (the kernels line)
DOMAIN_INSTANCES = {
    "sparse_conv": "mma and simt walk any block as 32 x 32 pieces: mma at "
                   "bm % 16 == 0 and bn % 8 == 0 of any size (split-K over "
                   "K x ceil(bm / 32) steps; a one-piece instance for bm, "
                   "bn <= 32), simt at any bm | C and bn",
    "sparse_matmul": "simt and mma walk any block as 64 x 64 pieces, the "
                     "last ragged: mma at bm, bn % 8 == 0 (8 rows "
                     "zero-filled to 16; an instance for whole pieces of "
                     "16-row multiples), simt at any side; gemv any block",
    "dw_pw": "mma in bf16 at k 1-7 and int8 at k 3; simt templated in bf16 "
             "at k 1-7 and int8 and f32 at k 3, and with k at run time in "
             "all three stores at every other k",
    "depthwise_conv": "the templated kernel at k 1-7; one kernel with k at "
                      "run time past 7",
    "flash_attention": "mma at any bf16 D <= 256, padded in shared memory "
                       "to 16, 32, 48, ..., 128, 160, 192 or 256 (an "
                       "instance each for D equal to the padded size); simt at "
                       "any f32 D, and bf16 past 256, in 256-column chunks "
                       "past 256"}


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


def large_ffn_weights(dev, seed: int, names=FFN_128_LMS) -> dict:
    """{(arch, "w1" | "w2"): SparseWeight} at the FFN shapes of each
    arch of ``names`` (by default the large dense LMs and the VLM; w3
    has w1's), drawn by the models' own law: ``dense_init``, then
    block-balanced pruning at the config's blocks (128 x 128, whisper's
    64 x 64), 85%."""
    from repro_torch.configs import get_config
    from repro_torch.core.sparsity import to_block_balanced
    from repro_torch.models.layers import dense_init
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for name in names:
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


def ffn_per_step(cfg, params) -> int:
    """``sparse_matmul`` launches of one decode step: three for each
    pruned FFN it runs (every layer's; zamba2's shared block's at each
    of its sites; none for MoE experts or rwkv6's channel-mix)."""
    from repro_torch.models import lm
    if "ffn" in params["blocks"]:
        return 3 * cfg.n_layers
    if "shared" in params:
        return 3 * sum(lm.attn_flags(cfg))
    return 0


def batcher_phase(name: str, cfg, params, n_l: int, h, params_cpu=None):
    """The continuous batcher on ``cfg`` (BATCHER[name]): launches
    counted over the run (steps x ``ffn_per_step`` ``sparse_matmul``
    gemv; no flash), every
    request replayed alone, teacher-forced in its own row, on the card
    (and on the CPU, given ``params_cpu``). An MoE model's card replay
    runs in the batcher's shapes (its slots, its max_seq, one routing
    group a row): every fed position routed alike and bitwise the
    batcher's. So does a recurrent model's (rwkv6, zamba2), from the zero
    state its slot is reset to: its per-token norm of the scan's output
    (ln_x, the gated norm) carries a bf16 rounding that a product of
    other rows sums the other way to unit scale (24 rows against the
    batcher's 8 parted by 3.02e-2 of max |logit| at a request's 5th
    position, measured on one H100), so the shapes are kept and the
    positions bitwise the batcher's are counted."""
    from repro_torch.kernels import ops
    spec = BATCHER[name]
    reqs = batcher_requests(cfg, spec, SEED + 17)
    ops.reset_launches()
    cb, done, by_req, routed = run_batcher(cfg, params, reqs, spec, h.dev)
    ffn = cb.steps * ffn_per_step(cfg, params)
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
    same_shapes = moe or cfg.family in ("ssm", "hybrid")
    shapes = dict(group=spec["slots"], max_seq=spec["max_seq"]) \
        if same_shapes else {}
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
          (f"; each slot routed alone; the replay in the batcher's shapes "
           f"routes all {chk['positions_routed_alike']} fed positions "
           f"alike and gives their bits ({chk['positions_bitwise']})" if moe
           else f"; the slot's state zeroed at admission; the replay in the "
           f"batcher's shapes from the zero state gives the bits of "
           f"{chk['positions_bitwise']['card']} of {steps_alone} fed "
           f"positions" if same_shapes else ""))
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
    published = cfg.n_layers
    if name in DEPTH:
        cfg = dataclasses.replace(cfg, n_layers=DEPTH[name])
    n_l, vt = cfg.n_layers, cfg.vision_tokens
    moe = cfg.family == "moe"
    ffn = 0 if moe else 3 * n_l                 # sparse_matmul a prefill
    res = {"layers": n_l, "published_layers": published,
           "family": cfg.family}
    print(f"[main] {name} ({cfg.family}): d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.head_dim} ({cfg.kv_heads} KV), "
          + (f"{cfg.n_experts} experts top-{cfg.top_k}, expert FFN "
             f"{cfg.moe_d_ff}" if moe else
             f"d_ff {cfg.d_ff}, FFN blocks {cfg.sparsity.block_m} x "
             f"{cfg.sparsity.block_n} {cfg.sparsity.sparsity:.0%} pruned, "
             f"{vt} patch embeddings a prompt") +
          f", vocab {cfg.vocab_size}; " +
          (f"{n_l} of its {published} layers (depth cut: DEPTH)"
           if n_l < published else
           f"{n_l} layers, the published depth (no cut)"))
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


def check_state_layers(cfg, params, toks, frames, dev) -> dict:
    """Each layer of a recurrent or encoder-decoder LM on the card
    against the same layer on the CPU, fed the card's own input, with its
    state: a prefill over ``toks`` (1, T) from the zero state and decode
    step 0 of its first token. The bf16 output and every state within 1
    bf16 ulp: an f32 state (rwkv6's WKV, Mamba2's SSM) sums products of
    the layer's bf16 projections, which the two devices, summing in other
    orders, may round to either side (the scans themselves are held at
    1e-4 of their max on identical inputs: ``check_scans``). zamba2's shared block after each flagged layer (the prefill
    through flash, the step against a fresh ring); whisper's encoder
    layers over ``frames`` (1, Te, d) first, its decoder layers then
    attending to the card's encoder output (at step 0 through cross
    keys and values each device computes from it). Returns {"prefill",
    "decode": the worst error as a share of its bar}."""
    from repro_torch.models import layers as lm_layers
    from repro_torch.models import lm
    kind = lm.BLOCK_KINDS[cfg.family]
    worst = {"prefill": 0.0, "decode": 0.0}

    def held(chain, what, got, want):
        got, want = got.cpu().float(), want.float()
        compare(got, want, bf16_tol, f"{cfg.name} {chain} {what}")
        share = (got - want).abs() / bf16_tol(want).clamp_min(1e-38)
        worst[chain] = max(worst[chain], float(share.max()))

    devs = (dev, torch.device("cpu"))
    with torch.inference_mode(), lm_layers.full_f32():
        enc = None
        if kind == "encdec":
            te = frames.shape[1]
            h = frames.to(dev)
            for l in range(cfg.encoder_layers):
                p_dev = lm._layer(params["encoder"]["blocks"], l)
                ps = (p_dev, lm.params_to(p_dev, "cpu"))
                outs = [lm.encoder_block_fn(cfg, torch.arange(
                    te, device=d)[None])(h.to(d), p) for d, p in zip(devs, ps)]
                torch.cuda.synchronize()
                held("prefill", f"encoder layer {l}", outs[0], outs[1])
                h = outs[0]
            enc = lm_layers.rms_norm(h, params["encoder"]["norm"],
                                     cfg.norm_eps)
        shared = {"shared": (params["shared"], lm.params_to(
            params["shared"], "cpu"))} if "shared" in params else {}
        state = {"prefill": lm._embed(cfg, params, toks.to(dev)),
                 "decode": lm._embed(cfg, params, toks[:, :1].to(dev))}
        for l, flag in enumerate(lm.attn_flags(cfg)):
            p_dev = lm._layer(params["blocks"], l)
            ps = (p_dev, lm.params_to(p_dev, "cpu"))
            for chain, h in state.items():
                b, t = h.shape[:2]
                outs = []
                for d, p in zip(devs, ps):
                    x = h.to(d)
                    pos = torch.arange(t, device=d)[None].expand(b, t)
                    if kind in ("rwkv", "mamba"):
                        st = None
                        if chain == "decode":
                            c0 = lm.init_cache(cfg, b, 8, device=d)
                            st = {k: v[0] for k, v in c0.items()
                                  if k in lm.RECURRENT_LEAVES}
                        block = lm.rwkv_block if kind == "rwkv" else \
                            lm.mamba_block
                        outs.append(block(cfg, p, x, st))
                    elif chain == "decode":
                        kv = torch.zeros((2, b, 8, cfg.kv_heads,
                                          cfg.head_dim), dtype=torch.bfloat16,
                                         device=d)
                        ckv = torch.stack(lm_layers.cross_kv(p["cross"],
                                                             enc.to(d)))
                        outs.append((lm.decode_block(cfg, p, x, kv, pos, 0,
                                                     ckv), {}))
                    else:
                        outs.append((lm.make_block_fn(cfg, pos, enc.to(d))(
                            x, p)[0], {}))
                torch.cuda.synchronize()
                (got, gst), (want, wst) = outs
                held(chain, f"layer {l}", got, want)
                for k in wst:
                    held(chain, f"layer {l} state {k}", gst[k], wst[k])
                state[chain] = got
            if not flag:
                continue
            for chain, h in state.items():
                b, t = h.shape[:2]
                outs = []
                for i, d in enumerate(devs):
                    sp = {"shared": shared["shared"][i]}
                    x = h.to(d)
                    pos = torch.arange(t, device=d)[None].expand(b, t)
                    if chain == "prefill":
                        outs.append(lm.shared_attn_block(cfg, sp, x, pos))
                    else:
                        ring = torch.zeros((2, b, 8, cfg.kv_heads,
                                            cfg.head_dim),
                                           dtype=torch.bfloat16, device=d)
                        outs.append(lm.ring_attn_block(cfg, sp, x, pos, ring,
                                                       0))
                torch.cuda.synchronize()
                held(chain, f"shared block after layer {l}", outs[0], outs[1])
                state[chain] = outs[0]
    return worst


def check_scans(cfg, dev) -> float:
    """The model's scan alone (rwkv6's chunked WKV, Mamba2's chunked SSD)
    at its main-path shape (B 1, T PREFILL_T, the config's heads and
    state), from a carried state, on the card against the CPU on the
    same f32 inputs: output and final state within 1e-4 of their max.
    Both sum in f32 over a chunk's positions and the state's channels in
    other orders; the CPU tests hold each scan within 1e-4 of an f64
    token-by-token recurrence (tests/test_torch_rwkv.py, _zamba.py), and
    at 1e-5 Mamba2's output missed by one element of 2^21 (2.8e-3,
    measured on one H100). Returns the worst error as a share of the
    bar."""
    from repro_torch.models import layers as lm_layers
    gen = torch.Generator().manual_seed(SEED + 37)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen) * scale

    t = PREFILL_T
    if cfg.family == "ssm":
        h, dh = cfg.n_heads, cfg.head_dim
        args = [randn(1, t, h, dh) for _ in range(3)] + [
            -torch.exp(torch.rand((1, t, h, dh), generator=gen) * 4 - 8),
            randn(h, dh, scale=0.5)]
        kw = {"S0": randn(1, h, dh, dh, scale=0.1)}
        scan = lm_layers.rwkv6_wkv_chunked
    else:
        nh, dh = lm_layers._mamba_heads(cfg)
        n = cfg.ssm_state
        args = [randn(1, t, nh, dh),
                torch.nn.functional.softplus(randn(1, t, nh)),
                torch.log(torch.arange(1, nh + 1, dtype=torch.float32)),
                randn(1, t, n), randn(1, t, n)]
        kw = {"h0": randn(1, nh, n, dh, scale=0.1)}
        scan = lm_layers.mamba2_chunked
    worst = 0.0
    with torch.inference_mode(), lm_layers.full_f32():
        got = scan(*(a.to(dev) for a in args),
                   **{k: v.to(dev) for k, v in kw.items()})
        want = scan(*args, **kw)
        torch.cuda.synchronize()
        for what, g, w in zip(("output", "state"), got, want):
            compare(g.cpu(), w, scan_tol, f"{cfg.name} scan {what}")
            worst = max(worst, float(((g.cpu() - w).abs() / scan_tol(
                w)).max()))
    return worst


def state_lm_run(name: str, h) -> dict:
    """One recurrent or encoder-decoder LM at full width and depth on the
    card (``h``: the launch bookkeeping of ``main``): its weights from
    the seed (their bytes and the peak of drawing them), a prefill
    (rwkv6 and zamba2: PREFILL_T tokens; whisper: its 1500 frames, drawn
    from the seed, and WHISPER_T tokens) and a batch-4 decode step (the
    recurrent families from the zero state; whisper's on a cross_kv that
    ``lm.fill_cross_kv`` filled from batch-4 frames), each with its
    launches by name and variant and its time; every layer with its
    state against the CPU layer; ``serve_lm`` (whisper's with the
    encoder's fill); for rwkv6 and zamba2 the continuous batcher."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_lm
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import lm
    dev = h.dev
    cfg = get_config(name)
    published = cfg.n_layers
    if name in DEPTH:
        cfg = dataclasses.replace(cfg, n_layers=DEPTH[name])
    n_l, ne = cfg.n_layers, cfg.encoder_layers
    audio = cfg.family == "audio"
    sites = sum(lm.attn_flags(cfg))
    # launches: flash at each attention (zamba2's sites; whisper's
    # encoder layers, and twice a decoder layer), sparse_matmul three a
    # pruned FFN (zamba2's sites; whisper's encoder and decoder layers)
    flash = ne + 2 * n_l if audio else sites
    mm_prefill = 3 * (ne + n_l) if audio else 3 * sites
    mm_step = 3 * n_l if audio else 3 * sites
    res = {"layers": n_l, "published_layers": published,
           "family": cfg.family, "encoder_layers": ne, "attn_sites": sites}
    t_tok = WHISPER_T if audio else PREFILL_T

    def count(key, what, want, want_variants):
        """``h.count`` (the counters since the reset, checked by name and
        by variant), and the variants kept as ``<key>_variants``."""
        res[f"{key}_variants"] = variant_str(dict(ops.VARIANT_LAUNCHES))
        return h.count(what, want, want_variants)

    def launched(key) -> str:
        n = res[f"{key}_launches"]
        return f"{n} by variant {res[f'{key}_variants']}" if n else "none"

    print(f"[main] {name} ({cfg.family}): d_model {cfg.d_model}, "
          + {"ssm": f"{cfg.n_heads} WKV heads of {cfg.head_dim}, d_ff "
                    f"{cfg.d_ff} (channel-mix, dense)",
             "hybrid": f"Mamba2 d_inner {cfg.ssm_expand * cfg.d_model}, "
                       f"state {cfg.ssm_state}, {sites} shared-attention "
                       f"sites ({cfg.n_heads} heads of {cfg.head_dim}, "
                       f"window {cfg.attn_window}, FFN {cfg.d_ff} in "
                       f"{cfg.sparsity.block_m} x {cfg.sparsity.block_n} "
                       f"blocks)",
             "audio": f"{ne} encoder layers over {cfg.encoder_seq} frames, "
                      f"{cfg.n_heads} heads of {cfg.head_dim}, FFN "
                      f"{cfg.d_ff} in {cfg.sparsity.block_m} x "
                      f"{cfg.sparsity.block_n} blocks"}[cfg.family] +
          f", vocab {cfg.vocab_size}; " +
          (f"{n_l} of its {published} layers (depth cut: DEPTH)"
           if n_l < published else
           f"{n_l} layers, the published depth (no cut)"))
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
    toks = torch.randint(0, cfg.vocab_size, (1, t_tok),
                         generator=torch.Generator().manual_seed(
                             SEED + 19)).to(dev)
    frame_gen = torch.Generator(device=dev).manual_seed(SEED + 23)

    def draw_frames(b):
        return torch.randn((b, cfg.encoder_seq, cfg.d_model), device=dev,
                           generator=frame_gen).to(torch.bfloat16)

    extra = {"frames": draw_frames(1)} if audio else {}

    # the prompt in one forward
    prefill = make_prefill_step(cfg)
    ops.reset_launches()
    t0 = time.perf_counter()
    last = prefill(params, toks, **extra)
    torch.cuda.synchronize()
    res["prefill_first_s"] = time.perf_counter() - t0
    what = f"{name} prefill " + (f"{cfg.encoder_seq} frames + {t_tok} "
                                 f"tokens" if audio else f"T={t_tok}")
    res["prefill_launches"] = count("prefill", 
        what, {"flash_attention": flash, "sparse_matmul": mm_prefill},
        {("flash_attention", "mma"): flash,
         ("sparse_matmul", "mma"): mm_prefill} if flash else {})
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

    # one decode step at batch 4 (whisper's on the encoder's fill), then
    # three more timed
    step_toks = torch.randint(0, cfg.vocab_size, (STEP_BATCH, 1),
                              generator=torch.Generator().manual_seed(
                                  SEED + 29)).to(dev)
    cache = lm.init_cache(cfg, STEP_BATCH, 8, device=dev)
    if audio:
        ops.reset_launches()
        with torch.inference_mode():
            lm.fill_cross_kv(cfg, params, cache, draw_frames(STEP_BATCH))
        torch.cuda.synchronize()
        res["fill_launches"] = count("fill", 
            f"{name} fill_cross_kv (batch {STEP_BATCH})",
            {"flash_attention": ne, "sparse_matmul": 3 * ne},
            {("flash_attention", "mma"): ne, ("sparse_matmul", "mma"): 3 * ne})
        if not cache["cross_kv"].any():
            raise AssertionError(f"{name}: cross_kv not filled")
    ops.reset_launches()
    with torch.inference_mode():
        lg, _ = lm.decode_step(cfg, params, cache, step_toks, 0)
    torch.cuda.synchronize()
    res["decode_launches"] = count("decode", 
        f"{name} decode step (batch {STEP_BATCH})", {"sparse_matmul": mm_step},
        {("sparse_matmul", "gemv"): mm_step} if mm_step else {})
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

    # every layer with its state on the card's own input against the CPU
    # layer (whisper: LARGE_CHECK_T frames and tokens)
    ct = LARGE_CHECK_T
    t0 = time.perf_counter()
    res["layer_err"] = check_state_layers(
        cfg, params, toks[:, :ct].cpu(),
        extra["frames"][:, :ct] if audio else None, dev)
    res["layer_check_s"] = time.perf_counter() - t0
    res["scan_err"] = None if audio else check_scans(cfg, dev)
    print(f"[main] {name}: weights {res['param_bytes'] / 2**30:.2f} GiB in "
          f"{res['init_s']:.1f} s (init peak "
          f"{res['init_peak_bytes'] / 2**30:.2f} GiB of "
          f"{res['card_bytes'] / 2**30:.2f}, of it "
          f"{res['held_before_bytes'] / 2**30:.2f} GiB held before); "
          f"{what} launches {launched('prefill')}"
          + (" (no hand-written kernel: the chunked WKV and the dense "
             "projections are plain torch)" if cfg.family == "ssm" else "")
          + f", {res['prefill_ms']:.3f} ms (median of 3, first "
          f"{res['prefill_first_s']:.3f} s)"
          + (f"; fill_cross_kv batch {STEP_BATCH} launches "
             f"{launched('fill')}" if audio else "") +
          f"; decode step batch {STEP_BATCH} launches "
          f"{launched('decode')}, "
          f"{res['step_ms']:.3f} ms "
          f"(median of 3); every layer with its state on the card's own "
          f"input within 1 bf16 ulp of the CPU layer (prefill T={ct} worst "
          f"share {res['layer_err']['prefill']:.3f}, decode step 0 "
          f"{res['layer_err']['decode']:.3f}; {res['layer_check_s']:.1f} s)"
          + ("" if audio else f"; the scan alone at T={PREFILL_T} from a "
             f"carried state within 1e-4 of max of the CPU's (worst share "
             f"{res['scan_err']:.3f})"))

    # serve_lm at full size: whisper's encoder fills cross_kv first (in
    # prefill_s), the prompts stepped through the cache, greedy decoding
    n_steps = STATE_SERVE["prompt_len"] + STATE_SERVE["gen_tokens"]
    enc = {"flash_attention": ne, "sparse_matmul": 3 * ne}
    want = {"sparse_matmul": n_steps * mm_step + enc["sparse_matmul"],
            "flash_attention": enc["flash_attention"]}
    want_var = {("sparse_matmul", "gemv"): n_steps * mm_step}
    if audio:
        want_var.update({("flash_attention", "mma"): ne,
                         ("sparse_matmul", "mma"): 3 * ne})
    ops.reset_launches()
    sout = serve_lm(name, use_reduced=False, params=params, cfg=cfg,
                    generator=torch.Generator(device=dev).manual_seed(SEED),
                    record_logits=True, verbose=False, device=dev,
                    **STATE_SERVE)
    res["serve_launches"] = count("serve", 
        f"{name} serve_lm ({n_steps} decode steps"
        + (", the encoder's fill" if audio else "") + ")", want,
        {k: v for k, v in want_var.items() if v})
    slog = sout["logits"]
    if slog.shape != (STATE_SERVE["batch"], n_steps, cfg.vocab_size) or \
            not torch.isfinite(slog).all():
        raise AssertionError(f"{name} serve_lm: logits {tuple(slog.shape)} "
                             f"not finite")
    gen_from = STATE_SERVE["prompt_len"] - 1
    if not np.array_equal(sout["tokens"], slog[:, gen_from:-1].argmax(
            -1).numpy()):
        raise AssertionError(f"{name} serve_lm: tokens are not the argmax")
    res["serve"] = {k: sout[k] for k in ("prefill_s", "decode_s",
                                         "tokens_per_s")}
    print(f"[main] {name} serve_lm batch {STATE_SERVE['batch']}, prompt "
          f"{STATE_SERVE['prompt_len']}, {STATE_SERVE['gen_tokens']} tokens"
          + (f" (the encoder over {cfg.encoder_seq} frames a row fills "
             f"cross_kv first)" if audio else "") +
          f": launches {launched('serve')}; TTFT (the "
          f"prompts' {STATE_SERVE['prompt_len']} steps"
          + (", the encoder" if audio else "") + " and the first argmax) "
          f"{sout['prefill_s']:.4f} s, decode {sout['decode_s']:.4f} s, "
          f"{sout['tokens_per_s']:.2f} tok/s; logits finite, tokens their "
          f"argmax")
    del sout, slog
    if not audio:
        res["batcher"] = batcher_phase(name, cfg, params, n_l, h)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return res


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want||, in f64."""
    got, want = got.double(), want.double().to(got.device)
    return float((got - want).norm() / want.norm().clamp_min(1e-300))


def grads_through(fn, inputs, dout):
    """(out, the gradient of every input) of ``fn(*inputs)`` for
    ``dout``, under ``full_f32``; raises if the output has no autograd
    history (a kernel called without its Function)."""
    from repro_torch.models import layers as L
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    with L.full_f32():
        out = fn(*leaves)
        if out.grad_fn is None:
            raise AssertionError("the output has no autograd history: the "
                                 "kernel ran without its Function")
        return out.detach(), torch.autograd.grad(out, leaves, dout)


def family_launches(cfg) -> dict:
    """The kernel launches of one ``make_train_step`` (remat "full": each
    decoder layer's forward and its recomputation) for a reduced LM:
    flash at each attention, sparse_matmul three a pruned FFN; whisper's
    encoder runs outside the remat, once."""
    from repro_torch.models import lm
    n_l, ne = cfg.n_layers, cfg.encoder_layers
    kind = lm.BLOCK_KINDS[cfg.family]
    sites = sum(lm.attn_flags(cfg))
    ffn = cfg.sparsity.enabled and cfg.sparsity.prune_ffn
    flash = {"dense": 2 * n_l, "moe": 2 * n_l, "rwkv": 0,
             "mamba": 2 * sites, "encdec": ne + 4 * n_l}[kind]
    mm = {"dense": 6 * n_l, "moe": 0, "rwkv": 0, "mamba": 6 * sites,
          "encdec": 3 * ne + 6 * n_l}[kind] if ffn else 0
    return {k: v for k, v in (("flash_attention", flash),
                              ("sparse_matmul", mm)) if v}


def train_run(h) -> dict:
    """LM training at full width on the card (``h``: the launch
    bookkeeping of ``main``): each kernel's Function against autograd
    through its plain version at the training shapes; SmolLM-360M through
    ``train()`` (TRAIN_STEPS steps of TRAIN_B x TRAIN_T, remat "full",
    every step's launches counted) and TIMED_STEPS more through
    ``make_train_step``; one step against the port's CPU step (the loss,
    every gradient, the update fed the card's gradients); the restart run
    against the clean one at CUT_LAYERS layers, bit for bit; checkpoint
    save and restore at full width; int8 gradient compression; the
    stage-pipelined step against its sequential executor and
    make_train_step's loss; every LM family's reduced step through the
    kernels against the plain versions on the card."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import pipeline as pp
    from repro_torch.core import pytree
    from repro_torch.data.pipeline import DataConfig, MarkovStream
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import sparse_matmul as sm
    from repro_torch.launch import steps
    from repro_torch.launch.train import train
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.models.layers import SparseWeight
    from repro_torch.optim import adamw
    from repro_torch.runtime import fault
    dev = h.dev
    cfg = get_config(LM)
    n_l = cfg.n_layers
    per_step = {"flash_attention": 2 * n_l, "sparse_matmul": 6 * n_l}
    per_var = {("flash_attention", "mma"): 2 * n_l,
               ("sparse_matmul", "mma"): 6 * n_l}
    res = {"arch": LM, "layers": n_l, "seq": TRAIN_T, "batch": TRAIN_B}
    opt_cfg = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=max(
        TRAIN_STEPS // 10, 1), total_steps=TRAIN_STEPS)

    def times(per, n):
        return {k: v * n for k, v in per.items()}

    def data(seq, batch):
        return MarkovStream(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=seq, global_batch=batch,
                                       seed=SEED, branching=8))

    def on_dev(b):
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    gc.collect()
    torch.cuda.empty_cache()
    res["held_before_bytes"] = torch.cuda.memory_allocated()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED))
    res["param_bytes"] = param_bytes(params)
    print(f"[main] {LM} training: {n_l} layers, d_model {cfg.d_model}, FFN "
          f"{cfg.d_ff} in {cfg.sparsity.block_m} x {cfg.sparsity.block_n} "
          f"blocks ({cfg.sparsity.sparsity:.0%} pruned), "
          f"{res['param_bytes'] / 2**20:.1f} MiB of weights; seq "
          f"{TRAIN_T}, batch {TRAIN_B} (cut from train_4k's global batch "
          f"256), remat full")

    # -- each kernel's Function against autograd through its plain version
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    m = TRAIN_B * TRAIN_T
    layer0 = lm._layer(params["blocks"], 0)["ffn"]
    fn_err = {}
    inputs = {"flash": None, "mm": {}}
    for w in ("w1", "w2"):
        sw = layer0[w]
        x = (torch.randn((m, sw.d_in), generator=gen, device=dev) / 4).to(
            torch.bfloat16)
        dy = torch.randn((m, sw.d_out), generator=gen, device=dev).to(
            torch.bfloat16)
        got, g = grads_through(lambda a, v: ops.sparse_matmul(
            a, SparseWeight(v, sw.idx, sw.d_in)), (x, sw.vals), dy)
        want, wg = grads_through(
            lambda a, v: sm.sparse_matmul_torch(a, v, sw.idx), (x, sw.vals),
            dy)
        torch.cuda.synchronize()
        what = f"sparse_matmul Function {w} M={m} vals {tuple(sw.vals.shape)}"
        fn_err[f"sparse_matmul/{w}"] = max(
            compare(got, want, bf16_tol, f"{what} forward"),
            compare(g[0], wg[0], bf16_tol, f"{what} dx"),
            compare(g[1], wg[1], bf16_tol, f"{what} dvals"))
        inputs["mm"][(LM, w, m)] = (x, SparseWeight(
            sw.vals.contiguous(), sw.idx.contiguous(), sw.d_in))
        inputs[f"dy_{w}"] = dy
        del got, g, want, wg
    q, k, v, do = (torch.randn((TRAIN_B, TRAIN_T, cfg.n_heads,
                                cfg.head_dim), generator=gen,
                               device=dev).to(torch.bfloat16)
                   for _ in range(4))
    got, g = grads_through(lambda a, b_, c: ops.flash_attention(a, b_, c),
                           (q, k, v), do)
    want, wg = grads_through(
        lambda a, b_, c: fa.flash_attention_torch(a, b_, c), (q, k, v), do)
    torch.cuda.synchronize()
    what = f"flash_attention Function {tuple(q.shape)} causal"
    fn_err["flash_attention"] = max(
        [compare(got, want, bf16_tol, f"{what} forward")] +
        [compare(a, b_, bf16_tol, f"{what} d{n}")
         for a, b_, n in zip(g, wg, "qkv")])
    inputs["flash"] = (q, k, v, do)
    del got, g, want, wg
    gc.collect()
    torch.cuda.empty_cache()
    res["function_max_abs_err"] = fn_err
    print(f"[check] training Functions on the card against autograd "
          f"through the plain versions (forward and every input gradient "
          f"within 1 bf16 ulp): " + ", ".join(
              f"{k} {v:.3e}" for k, v in fn_err.items()))

    # -- the main path: train() at full width, its launches counted -------
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = train(LM, steps=TRAIN_STEPS, batch=TRAIN_B, seq=TRAIN_T,
                use_reduced=False, remat="full", seed=SEED, log_every=1,
                device=dev, lr=TRAIN_LR)
    torch.cuda.synchronize()
    res["train_s"] = time.perf_counter() - t0
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    res["launches"] = h.count(f"{LM} train() x{TRAIN_STEPS}",
                              times(per_step, TRAIN_STEPS),
                              times(per_var, TRAIN_STEPS))
    losses = [l for _, l in out["losses"]]
    res["losses"] = losses
    if not all(math.isfinite(l) for l in losses) or not (
            statistics.mean(losses[-3:]) < statistics.mean(losses[:3])):
        raise AssertionError(f"{LM} train(): losses not finite or not "
                             f"falling: {losses}")
    print(f"[main] {LM} train() {TRAIN_STEPS} steps of {TRAIN_B} x "
          f"{TRAIN_T} in {res['train_s']:.1f} s: launches "
          f"{res['launches']} ({per_step} a step, all mma: forward and "
          f"the remat recompute; the backwards plain); loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} (first 3 mean "
          f"{statistics.mean(losses[:3]):.4f}, last 3 "
          f"{statistics.mean(losses[-3:]):.4f}); peak "
          f"{res['peak_bytes'] / 2**30:.2f} GiB of the card "
          f"({res['held_before_bytes'] / 2**30:.2f} held before)")
    state = out["state"]
    step = steps.make_train_step(cfg, opt_cfg, remat="full")
    stream = data(TRAIN_T, TRAIN_B)
    ops.reset_launches()
    step_s = []
    p_, o_ = state["params"], state["opt"]
    for i in range(TIMED_STEPS):
        b = on_dev(stream.batch(TRAIN_STEPS + i))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_, o_, met = step(p_, o_, b)
        float(met["loss"])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    h.count(f"{LM} make_train_step x{TIMED_STEPS}",
            times(per_step, TIMED_STEPS), times(per_var, TIMED_STEPS))
    del p_, o_
    res["step_s"] = step_s
    res["tokens_per_s"] = TRAIN_B * TRAIN_T / statistics.median(step_s)
    # checkpoint save / restore of the full state
    ck_dir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ck_dir, ignore_errors=True)
    t0 = time.perf_counter()
    ckpt.save(state, str(ck_dir), TRAIN_STEPS)
    res["ckpt_save_s"] = time.perf_counter() - t0
    template = pytree.map_leaves(torch.empty_like, state)
    template = {"params": pytree.rebuild(state["params"], dict(
        pytree.keyed_leaves(template["params"])).get),
        "opt": template["opt"]}
    t0 = time.perf_counter()
    back, _ = ckpt.restore(template, str(ck_dir))
    torch.cuda.synchronize()
    res["ckpt_restore_s"] = time.perf_counter() - t0
    res["ckpt_bytes"] = sum(f.stat().st_size for f in ck_dir.rglob("*")
                            if f.is_file())
    for (key, a), (_, b_) in zip(pytree.keyed_leaves(back),
                                 pytree.keyed_leaves(state)):
        if not torch.equal(a, b_):
            raise AssertionError(f"checkpoint round trip: {key} differs")
    del back, template
    shutil.rmtree(ck_dir, ignore_errors=True)
    print(f"[main] checkpoint of the full state ({res['ckpt_bytes'] / 2**20:.0f}"
          f" MiB on disk): save {res['ckpt_save_s']:.2f} s, restore "
          f"{res['ckpt_restore_s']:.2f} s, bit for bit")
    del state, out
    gc.collect()
    torch.cuda.empty_cache()

    # -- one step on the card against the port's CPU step ----------------
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED))
    cpu = lm.params_to(params, "cpu")
    b256 = data(CHECK_T, 1).batch(0)

    def loss_of(p, device, remat):
        bt = {k: torch.from_numpy(v).to(device) for k, v in b256.items()}
        return lambda p_: lm.loss_fn(cfg, p_, bt, remat=remat)

    ops.reset_launches()
    (loss_c, _), g_c = steps.value_and_grad(loss_of(params, dev, "full"),
                                            params)
    torch.cuda.synchronize()
    h.count(f"{LM} value_and_grad T={CHECK_T}", per_step, per_var)
    t0 = time.perf_counter()
    (loss_p, _), g_p = steps.value_and_grad(loss_of(cpu, "cpu", "none"), cpu)
    with L.accum_dtype(torch.float64):
        (loss_64, _), g_64 = steps.value_and_grad(
            loss_of(cpu, "cpu", "none"), cpu)
    res["cpu_step_s"] = time.perf_counter() - t0
    loss_err = abs(float(loss_c) - float(loss_p)) / abs(float(loss_p))
    if loss_err > TRAIN_LOSS_RTOL:
        raise AssertionError(f"{LM} T={CHECK_T} loss card {float(loss_c)} vs "
                             f"CPU {float(loss_p)}: {loss_err:.3e} > "
                             f"{TRAIN_LOSS_RTOL}")
    flat_p, flat_64 = (dict(pytree.keyed_leaves(t)) for t in (g_p, g_64))
    grad_err, floor = {}, {}
    for key, gc_ in pytree.keyed_leaves(g_c):
        if gc_ is None:
            continue
        grad_err[key] = rel_l2(gc_.cpu(), flat_p[key])
        floor[key] = rel_l2(flat_p[key], flat_64[key])
    worst = max(grad_err, key=grad_err.get)
    res["step_vs_cpu"] = {"loss_card": float(loss_c), "loss_cpu": float(
        loss_p), "loss_cpu_f64": float(loss_64), "loss_rel_err": loss_err,
        "grad_rel_l2": grad_err, "grad_floor_rel_l2": floor}
    bad = {k: v for k, v in grad_err.items() if v > GRAD_L2_RTOL}
    if bad:
        raise AssertionError(f"{LM} T={CHECK_T} gradients beyond "
                             f"{GRAD_L2_RTOL} relative L2: {bad}")
    # the update on the card and on the CPU, both fed the card's gradients
    g_cpu = pytree.map_leaves(lambda t: None if t is None else t.cpu(), g_c)
    p_card, _, _ = adamw.update(opt_cfg, params, g_c, adamw.init(params))
    p_cpu, _, _ = adamw.update(opt_cfg, cpu, g_cpu, adamw.init(cpu))
    lr = float(adamw.schedule(opt_cfg, torch.tensor(1)))
    upd_err = 0.0
    flat_cpu = dict(pytree.keyed_leaves(p_cpu))
    for key, t in pytree.keyed_leaves(p_card):
        want = flat_cpu[key]
        if not t.is_floating_point():
            if not torch.equal(t.cpu(), want):
                raise AssertionError(f"update changed {key}")
            continue
        w = want.double()
        a = w.abs()
        ulp = torch.where(a > 0, torch.exp2(torch.floor(torch.log2(
            torch.where(a > 0, a, torch.ones_like(a)))) - 7), 2.0 ** -133)
        lr_ulp = 2.0 ** (math.floor(math.log2(lr)) - 7)
        err = ((t.cpu().double() - w).abs() / (ulp + lr_ulp)).max()
        upd_err = max(upd_err, float(err))
    if upd_err > 1.0:
        raise AssertionError(f"the update on the card parts from the CPU's "
                             f"fed the same gradients by {upd_err:.3f} ulp")
    res["update_ulp_share"] = upd_err
    # compression of the card's gradients
    (qg, sg), _ = fault.compress_grads(g_c, fault.init_error(g_c))
    back = fault.decompress_grads((qg, sg))
    flat_s = dict(pytree.keyed_leaves(sg))
    comp_err = 0.0
    for key, d in pytree.keyed_leaves(back):
        if d is None:
            continue
        g = dict(pytree.keyed_leaves(g_c))[key].float()
        s = float(flat_s[key])
        e = float((d - g).abs().max())
        if e > s / 2 + 2.0 ** -23 * float(g.abs().max()):
            raise AssertionError(f"compress/decompress {key}: {e} > {s}/2")
        comp_err = max(comp_err, e / s)
    res["compress_err_scale_share"] = comp_err
    print(f"[check] {LM} one step T={CHECK_T} B=1, card vs the port's CPU "
          f"step from the same weights: loss {float(loss_c):.6f} vs "
          f"{float(loss_p):.6f} ({loss_err:.3e} <= {TRAIN_LOSS_RTOL}); "
          f"gradients relative L2 worst {grad_err[worst]:.3e} ({worst}) <= "
          f"{GRAD_L2_RTOL}, median {statistics.median(grad_err.values()):.3e}"
          f"; the CPU's sum-order floor (f64 vs f32 fdot sums) worst "
          f"{max(floor.values()):.3e}, median "
          f"{statistics.median(floor.values()):.3e}; the update fed the "
          f"card's gradients within 1 bf16 ulp of the CPU's (worst share "
          f"{upd_err:.3f}); int8 compress/decompress of the card's "
          f"gradients within scale/2 (worst share {comp_err:.3f}); CPU "
          f"steps {res['cpu_step_s']:.1f} s")
    del cpu, g_p, g_64, g_cpu, p_card, p_cpu, qg, sg, back

    # -- the stage-pipelined step against its sequential executor --------
    pt = PIPE_TRAIN
    shape = ShapeConfig("train_1k", "train", pt["seq"], pt["batch"])
    ts, restructure, plan = steps.make_pipeline_train_step(
        cfg, None, shape, opt_cfg, n_stages=pt["stages"],
        n_microbatches=pt["microbatches"])
    sp, mask = restructure(params)
    bp = on_dev(data(pt["seq"], pt["batch"]).batch(0))
    mb_launch = {k: v * pt["microbatches"] for k, v in per_step.items()}
    ops.reset_launches()
    (l_pipe, _), g_pipe = ts.value_and_grad(sp, mask, bp)
    torch.cuda.synchronize()
    h.count(f"{LM} pipelined value_and_grad S={pt['stages']} "
            f"M={pt['microbatches']}", mb_launch,
            {(n, "mma"): c for n, c in mb_launch.items()})
    (l_seq, _), g_seq = ts.value_and_grad(sp, mask, bp,
                                          executor=pp.sequential_apply)
    torch.cuda.synchronize()
    if float(l_pipe) != float(l_seq):
        raise AssertionError(f"pipelined loss {float(l_pipe)} != sequential "
                             f"{float(l_seq)}")
    flat_seq = dict(pytree.keyed_leaves(g_seq))
    for key, g in pytree.keyed_leaves(g_pipe):
        if g is not None and not torch.equal(g, flat_seq[key]):
            raise AssertionError(f"pipelined gradient {key} != sequential")
    with torch.no_grad():
        l_chunk, _ = lm.loss_fn(cfg, params, bp, remat="none")
    pipe_err = abs(float(l_pipe) - float(l_chunk)) / abs(float(l_chunk))
    if pipe_err > PIPE_LOSS_RTOL:
        raise AssertionError(f"pipelined loss {float(l_pipe)} vs "
                             f"make_train_step's {float(l_chunk)}")
    del g_seq
    # the same step on a stage mesh of 4 slots of the card: S from the
    # mesh's "pod" axis, stage s on slot s; bit for bit the mesh-less step
    from repro_torch.launch.mesh import device_slots, make_stage_mesh
    mesh = make_stage_mesh(pt["stages"], stage_axis="pod",
                           devices=device_slots(pt["stages"], dev))
    ts_m, _, plan_m = steps.make_pipeline_train_step(
        cfg, mesh, shape, opt_cfg, n_microbatches=pt["microbatches"])
    if plan_m["stage_of"] != plan["stage_of"]:
        raise AssertionError("the mesh step's cut differs from n_stages'")
    ops.reset_launches()
    t0 = time.perf_counter()
    (l_mesh, _), g_mesh = ts_m.value_and_grad(sp, mask, bp)
    torch.cuda.synchronize()
    mesh_s = time.perf_counter() - t0
    mesh_launches = h.count(
        f"{LM} pipelined value_and_grad on a stage mesh of "
        f"{pt['stages']} slots", mb_launch,
        {(n, "mma"): c for n, c in mb_launch.items()})
    if float(l_mesh) != float(l_pipe):
        raise AssertionError(f"mesh step loss {float(l_mesh)} != mesh-less "
                             f"{float(l_pipe)}")
    flat_pipe = dict(pytree.keyed_leaves(g_pipe))
    for key, g in pytree.keyed_leaves(g_mesh):
        if (g is None) != (flat_pipe[key] is None) or (
                g is not None and not torch.equal(g, flat_pipe[key])):
            raise AssertionError(f"mesh step gradient {key} != mesh-less")
    res["mesh_step"] = {"slots": [str(sl) for sl in mesh.devices.ravel()],
                        "loss": float(l_mesh), "value_and_grad_s": mesh_s,
                        "launches": mesh_launches}
    print(f"[main] {LM} make_pipeline_train_step on a stage mesh of "
          f"{pt['stages']} slots of {dev} (S from the mesh's pod axis): "
          f"loss and every gradient bit for bit the mesh-less step's; "
          f"launches {mesh_launches}; value_and_grad {mesh_s:.3f} s")
    del g_pipe, g_mesh
    opt_p = adamw.init(sp)
    pipe_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sp2, _, met = ts(sp, mask, opt_p, bp)
        float(met["loss"])
        torch.cuda.synchronize()
        pipe_s.append(time.perf_counter() - t0)
        del sp2
    ops.reset_launches()
    res["pipeline"] = {
        "stage_of": plan["stage_of"],
        "stage_cost": [float(c) for c in plan["stage_cost"]],
        "imbalance": plan["imbalance"], "loss": float(l_pipe),
        "loss_make_train_step": float(l_chunk), "loss_rel_err": pipe_err,
        "step_s": pipe_s}
    cuts = [plan["stage_of"].index(s) for s in range(pt["stages"])]
    print(f"[main] {LM} make_pipeline_train_step S={pt['stages']} "
          f"M={pt['microbatches']} T={pt['seq']} B={pt['batch']}: "
          f"plan_lm_stages cut at layers {cuts} (imbalance "
          f"{plan['imbalance']:.4f}); loss and every gradient bit for bit "
          f"the same microbatches through the stages in order; loss "
          f"{float(l_pipe):.6f} vs make_train_step's {float(l_chunk):.6f} "
          f"({pipe_err:.2e} <= {PIPE_LOSS_RTOL})")
    del sp, opt_p, params, g_c
    gc.collect()
    torch.cuda.empty_cache()

    # -- restart and compression at CUT_LAYERS layers ----------------------
    cut = dataclasses.replace(cfg, n_layers=CUT_LAYERS)
    per_cut = {k: v * CUT_LAYERS // n_l for k, v in per_step.items()}
    kw = dict(batch=TRAIN_B, seq=TRAIN_T, use_reduced=False, remat="full",
              seed=SEED, verbose=False, device=dev, cfg=cut, lr=TRAIN_LR)
    ops.reset_launches()
    clean = train(LM, steps=RESTART["steps"], **kw)
    shutil.rmtree(ck_dir, ignore_errors=True)
    t0 = time.perf_counter()
    faulty = train(LM, steps=RESTART["steps"], ckpt_dir=str(ck_dir),
                   ckpt_every=RESTART["ckpt_every"],
                   fail_at=RESTART["fail_at"], **kw)
    res["restart_run_s"] = time.perf_counter() - t0
    shutil.rmtree(ck_dir, ignore_errors=True)
    h.count(f"{LM} {CUT_LAYERS} layers: clean and restarted train()",
            times(per_cut, 2 * RESTART["steps"]),
            {(n, "mma"): c for n, c in times(
                per_cut, 2 * RESTART["steps"]).items()})
    if faulty["restarts"] != 2:
        raise AssertionError(f"restarts {faulty['restarts']} != 2")
    flat_clean = dict(pytree.keyed_leaves(clean["state"]))
    n_leaves = 0
    for key, t in pytree.keyed_leaves(faulty["state"]):
        if t.dtype != flat_clean[key].dtype or not torch.equal(
                t, flat_clean[key]):
            raise AssertionError(f"restarted run: {key} differs from the "
                                 f"clean run")
        n_leaves += 1
    res["restart"] = {"restarts": faulty["restarts"], "leaves": n_leaves,
                      "losses_clean": [l for _, l in clean["losses"]],
                      "losses_restarted": [l for _, l in faulty["losses"]]}
    del clean, faulty
    ops.reset_launches()
    t0 = time.perf_counter()
    comp = train(LM, steps=COMPRESS_STEPS, grad_compress=True, **kw)
    res["compress_run_s"] = time.perf_counter() - t0
    comp_losses = [l for _, l in comp["losses"]]
    if not all(math.isfinite(l) for l in comp_losses):
        raise AssertionError(f"grad_compress losses {comp_losses}")
    h.count(f"{LM} {CUT_LAYERS} layers: train(grad_compress=True)",
            times(per_cut, COMPRESS_STEPS),
            {(n, "mma"): c for n, c in times(
                per_cut, COMPRESS_STEPS).items()})
    res["compress_losses"] = comp_losses
    del comp
    print(f"[main] {LM} at {CUT_LAYERS} layers (a depth cut): train() of "
          f"{RESTART['steps']} steps with checkpoints every "
          f"{RESTART['ckpt_every']} and failures at {RESTART['fail_at']}: "
          f"2 restarts, the final params and moments ({n_leaves} leaves) "
          f"bit for bit the clean run's ({res['restart_run_s']:.1f} s); "
          f"{COMPRESS_STEPS} steps with int8 gradients: losses "
          f"{[round(l, 4) for l in comp_losses]}")
    gc.collect()
    torch.cuda.empty_cache()

    # -- every LM family at reduced(): kernels against the plain versions
    fam = {}
    for arch in FAMILY_LMS:
        rcfg = reduced(get_config(arch))
        rp = lm.init_params(rcfg, torch.Generator(device=dev).manual_seed(
            SEED))
        fg = torch.Generator().manual_seed(SEED + 41)
        b, t = FAMILY_BT
        fb = {k: torch.randint(0, rcfg.vocab_size, (b, t), generator=fg).to(
            dev) for k in ("tokens", "labels")}
        if rcfg.family == "vlm":
            fb["patches"] = torch.randn((b, rcfg.vision_tokens, rcfg.d_model),
                                        generator=fg).to(torch.bfloat16).to(
                dev)
        if rcfg.family == "audio":
            fb["frames"] = torch.randn((b, rcfg.encoder_seq, rcfg.d_model),
                                       generator=fg).to(torch.bfloat16).to(dev)

        def vg():
            return steps.value_and_grad(
                lambda p: lm.loss_fn(rcfg, p, fb, remat="full"), rp)

        want = family_launches(rcfg)
        ops.reset_launches()
        (loss_k, _), g_k = vg()
        torch.cuda.synchronize()
        launched = h.count(f"{arch} reduced train step", want,
                           {(n, "mma"): c for n, c in want.items()})
        ops.reset_launches()
        with plain_on_card(ops):
            (loss_pl, _), g_pl = vg()
        torch.cuda.synchronize()
        if any(ops.LAUNCHES.values()):
            raise AssertionError(f"{arch}: the plain run launched "
                                 f"{ops.LAUNCHES}")
        l_err = abs(float(loss_k) - float(loss_pl)) / abs(float(loss_pl))
        flat_pl = dict(pytree.keyed_leaves(g_pl))
        errs = {key: rel_l2(g, flat_pl[key]) for key, g in
                pytree.keyed_leaves(g_k) if g is not None}
        if l_err > TRAIN_LOSS_RTOL or max(errs.values()) > GRAD_L2_RTOL:
            raise AssertionError(f"{arch} reduced: loss {l_err:.3e}, worst "
                                 f"gradient {max(errs.values()):.3e}")
        step_k = steps.make_train_step(rcfg)
        _, _, met = step_k(rp, adamw.init(rp), fb)
        if not math.isfinite(float(met["loss"])):
            raise AssertionError(f"{arch}: train step loss {met}")
        ops.reset_launches()
        fam[arch] = {"launches": launched, "loss_rel_err": l_err,
                     "grad_rel_l2_worst": max(errs.values())}
        print(f"[main] {arch} reduced train step on the card (B {b}, T "
              f"{t}): launches {launched or 'none'}; against the plain "
              f"versions on the card: loss {l_err:.2e}, gradients worst "
              f"relative L2 {max(errs.values()):.2e}")
        del rp, g_k, g_pl
    res["families"] = fam
    res["_timing_inputs"] = inputs
    return res


@contextlib.contextmanager
def plain_on_card(ops):
    """In scope, CUDA tensors take the kernels' plain versions: the
    comparison the reduced families' train steps are held to on the
    card. The port has no such switch; this script sets ``ops._route``
    aside for the scope and puts it back."""
    prev = ops._route
    ops._route = lambda x, op: False
    try:
        yield
    finally:
        ops._route = prev


def train_timings(res: dict, n_l: int) -> dict:
    """Phase 5's training numbers: the two kernels at the training
    shapes beside their plain versions, bounds and library calls
    (``large_timings``), their plain backwards, the share of a step in
    the kernels' forwards (forward and recompute) against the plain
    backwards, and the step, checkpoint and pipelined-step times phase 4
    measured."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import sparse_matmul as sm
    inputs = res.pop("_timing_inputs")
    q, k, v, do = inputs["flash"]
    flash_rows, mm_rows = large_timings(
        {f"{LM} train B={TRAIN_B} T={TRAIN_T}": (q, k, v, {})}, inputs["mm"])
    bwd = {"flash_attention": time_ms(
        lambda: fa.flash_attention_backward_torch(q, k, v, do), reps=2,
        rounds=2)}
    for (_, w, _), (x, sw) in inputs["mm"].items():
        dy = inputs[f"dy_{w}"]
        bwd[w] = time_ms(lambda: sm.sparse_matmul_backward_torch(
            x, sw.vals, sw.idx, dy), reps=2, rounds=2)
    bwd_rows = backward_bounds(q, k, v, do, inputs, bwd)
    fwd = {"flash_attention": flash_rows[0]["ms"]}
    for row in mm_rows:
        fwd[row["weight"]] = row["ms"]
    # a step: each layer's flash and w1, w3, w2 forward twice (remat), the
    # plain backwards once
    kernel_ms = n_l * (2 * fwd["flash_attention"] + 2 * (2 * fwd["w1"]
                                                         + fwd["w2"]))
    backward_ms = n_l * (bwd["flash_attention"] + 2 * bwd["w1"] + bwd["w2"])
    step_ms = statistics.median(res["step_s"]) * 1e3
    res["times"] = {"flash": flash_rows, "sparse_matmul": mm_rows,
                    "plain_backward_ms": bwd,
                    "plain_backward_rows": bwd_rows,
                    "kernel_forward_ms_a_step":
                    kernel_ms, "plain_backward_ms_a_step": backward_ms,
                    "step_ms": step_ms}
    print(f"[time] plain backwards at the training shapes: flash_attention "
          f"{bwd['flash_attention']:.3f} ms, sparse_matmul w1 "
          f"{bwd['w1']:.3f} ms, w2 {bwd['w2']:.3f} ms (the kernels' "
          f"forwards: {fwd['flash_attention']:.3f} / {fwd['w1']:.3f} / "
          f"{fwd['w2']:.3f} ms)")
    print(f"[time] {LM} train step (B {TRAIN_B}, T {TRAIN_T}, {n_l} layers, "
          f"remat full): median {step_ms:.1f} ms of {len(res['step_s'])} "
          f"({', '.join(f'{s * 1e3:.1f}' for s in res['step_s'])}), "
          f"{res['tokens_per_s']:.0f} tokens/s; the kernels' forwards "
          f"{kernel_ms:.1f} ms ({kernel_ms / step_ms:.1%}), their plain "
          f"backwards {backward_ms:.1f} ms ({backward_ms / step_ms:.1%}); "
          f"peak {res['peak_bytes'] / 2**30:.2f} GiB")
    print(f"[time] checkpoint of the full state: save {res['ckpt_save_s']:.2f}"
          f" s, restore {res['ckpt_restore_s']:.2f} s; pipelined step "
          f"S={PIPE_TRAIN['stages']} M={PIPE_TRAIN['microbatches']} "
          f"T={PIPE_TRAIN['seq']} B={PIPE_TRAIN['batch']}: "
          f"{', '.join(f'{s:.3f}' for s in res['pipeline']['step_s'])} s")
    return res["times"]


def time_eager_ms(fn, reps: int = 5) -> float:
    """Device time of one ``fn()`` run eagerly: CUDA events around
    ``reps`` calls after two warm-ups (for work a CUDA graph cannot hold,
    such as an autograd backward; at these sizes, milliseconds a call,
    the host's launches do not hold the device back)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def backward_bounds(q, k, v, do, inputs: dict, bwd: dict) -> dict:
    """The plain backwards' bounds and library calls at the training
    shapes. Flash: 10 * H * D operations a visible (query, key) pair (the
    five products of the backward, 2.5x the forward's two), q, k, v and
    dout read and dq, dk, dv written once, bf16; the library call
    autograd through ``scaled_dot_product_attention`` (causal) on the same
    tensors (a SmolLM layer's q, k and v all have its 15 heads here).
    Sparse matmul: dx and dvals, 4 * M * K * bm * bn operations a
    weight (two products over the kept blocks), x, dy, vals and idx read
    and dx, dvals written once; the library call the backward of a dense
    bf16 ``x @ W`` on the densified weight (dx and dW)."""
    from repro_torch.core.sparsity import densify
    b, t, h, d = q.shape
    t_b, t_o = bound(7 * q.numel() * q.element_size(),
                     b * flash_ops(t, t, h, d, True, 0, 0) * 5 // 2,
                     torch.bfloat16)
    qt, kt, vt = (x.permute(0, 2, 1, 3).detach().requires_grad_(True)
                  for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.permute(0, 2, 1, 3)
    lib = time_eager_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True))
    rows = {"flash_attention": {
        "shape": [b, t, h, d], "causal": True, "ms": bwd["flash_attention"],
        "bound_ms": max(t_b, t_o), "bound_by": bound_by(t_b, t_o),
        "library_ms": lib,
        "library": "autograd through F.scaled_dot_product_attention"}}
    del qt, kt, vt, out
    for (_, w, m), (x, sw) in inputs["mm"].items():
        ob, n_k, bm, bn = sw.vals.shape
        dy = inputs[f"dy_{w}"]
        nbytes = 2 * (x.numel() * x.element_size()
                      + sw.vals.numel() * sw.vals.element_size()) + \
            sw.idx.numel() * 4 + dy.numel() * dy.element_size()
        t_b, t_o = bound(nbytes, 4 * m * ob * n_k * bm * bn, torch.bfloat16)
        xg = x.detach().requires_grad_(True)
        wg = densify(sw).detach().requires_grad_(True)
        y = xg @ wg
        lib = time_eager_ms(lambda: torch.autograd.grad(
            y, (xg, wg), dy, retain_graph=True))
        rows[f"sparse_matmul_{w}"] = {
            "M": m, "vals": list(sw.vals.shape), "ms": bwd[w],
            "bound_ms": max(t_b, t_o), "bound_by": bound_by(t_b, t_o),
            "library_ms": lib,
            "library": "autograd through a dense bf16 x @ W (densified)"}
        del xg, wg, y
    for name, row in rows.items():
        print(f"[time] plain backward {name}: {row['ms']:.3f} ms, bound "
              f"{row['bound_ms'] * 1e3:.1f} us ({row['bound_by']}), "
              f"library ({row['library']}) {row['library_ms']:.3f} ms")
    return rows


def large_timings(flash_inputs: dict, mm_inputs: dict) -> tuple[list, list]:
    """The new kernel shapes timed beside their plain versions, their
    bound and their library call: flash (SDPA on the same expanded
    tensors: ``is_causal`` for a causal prefill, no mask for non-causal
    attention, an explicit mask for a cache chunk or a window), the
    sparse matmul (``torch.matmul`` on the densified bf16 weight)."""
    from repro_torch.core.sparsity import densify
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import sparse_matmul as sm
    flash_rows = []
    for what, (q, k, v, kw) in flash_inputs.items():
        b, tq, h, d = q.shape
        tk = k.shape[1]
        qt, kt, vt = (t.permute(0, 2, 1, 3) for t in (q, k, v))
        off = kw.get("q_offset", 0)
        causal, window = kw.get("causal", True), kw.get("window", 0)
        qpos = torch.arange(off, off + tq, device=q.device)[:, None]
        kpos = torch.arange(tk, device=q.device)[None, :]
        # a window no query reaches past masks nothing
        reach = window if window and window < off + tq else 0
        mask = None
        if causal and (off or tq != tk or reach):
            mask = kpos <= qpos
        if reach:
            near = kpos > qpos - reach
            mask = near if mask is None else mask & near

        def lib():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask,
                is_causal=causal and mask is None)
        ms = time_ms(lambda: fa.flash_attention(q, k, v, **kw))
        plain = time_ms(lambda: fa.flash_attention_torch(q, k, v, **kw),
                        reps=2, rounds=2)
        lib_ms = time_ms(lib)
        t_b, t_o = bound((2 * q.numel() + 2 * k.numel()) * q.element_size(),
                         b * flash_ops(tq, tk, h, d, causal, reach, off),
                         q.dtype)
        flash_rows.append({"what": what, "shape": [b, tq, tk, h, d],
                           "q_offset": off, "causal": causal,
                           "window": window,
                           "variant": fa.variant(q.dtype, d),
                           "ms": ms, "plain_ms": plain, "library_ms": lib_ms,
                           "bound_ms": max(t_b, t_o),
                           "bound_by": bound_by(t_b, t_o)})
        masks = ("causal" if causal else "not causal") + (
            f", window {window}" if window else "")
        print(f"[time] flash_attention {what} (B {b}, Tq {tq}, Tk {tk}, H "
              f"{h}, D {d}, {str(q.dtype).removeprefix('torch.')}, {masks}, "
              f"{flash_rows[-1]['variant']}): "
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


def placed_tier_run(h) -> dict:
    """Phase 7b, the placed tier (``h``: the card ``dev``, phase 7's
    request ``images`` and unplaced tier's ``logits``, one ResNet-50
    forward's launches ``per_fwd`` / ``per_fwd_v`` and the launch check
    ``count``): ResNet-50 at 224 px, S 4 x R 2 on 8 device slots of the
    card. The stream without a failure (== the unplaced tier bitwise);
    with 4 slots lost after 2 rounds (the cut reused: 1 replica on slots
    {0, 1, 6, 7}, its buffer re-placed by ``_remesh_buffer``), and with
    5 lost (3 survivors: a new cut, everything rebuilt), each == the
    no-failure run bitwise; images/s placed and unplaced in turns. A
    server's warm-up runs 2 eager ticks and captures 2 (a replay runs no
    Python), so a tier launches 4 forwards' kernels a server it built."""
    from repro_torch.core import planner
    from repro_torch.launch import mesh as meshlib
    from repro_torch.runtime import tier as rt_tier
    t_phase = time.perf_counter()
    slots = meshlib.device_slots(2 * PIPE_S, h.dev)
    kw = dict(n_stages=PIPE_S, mb_size=TIER_MB, image_size=IMAGE_SIZE,
              seed=SEED, device=h.dev)
    res, launches = {}, {}

    def bitwise(a, b):
        return len(a) == len(b) and all(
            x.shape == y.shape and np.array_equal(
                x.view(np.uint32), y.view(np.uint32)) for x, y in zip(a, b))

    def counted(what, tier):
        n = 4 * len(tier.workers)
        got = h.count(what, {k: v * n for k, v in h.per_fwd.items()},
                      {k: v * n for k, v in h.per_fwd_v.items()})
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        return got

    def serve(tier, lose=None):
        rids = [tier.submit(x) for x in h.images]
        info = {}
        if lose is not None:
            tier.run(max_rounds=2)             # the stream is mid-flight
            timed = {"replan_s": [], "remesh_s": []}

            def timer(fn, key):
                def run(*a, **k):
                    t0 = time.perf_counter()
                    out = fn(*a, **k)
                    torch.cuda.synchronize()
                    timed[key].append(time.perf_counter() - t0)
                    return out
                return run
            plan_fn, remesh_fn = planner.plan, tier._remesh_buffer
            planner.plan = timer(plan_fn, "replan_s")
            tier._remesh_buffer = timer(remesh_fn, "remesh_s")
            t0 = time.perf_counter()
            try:
                info["replan"] = tier.lose_devices(lose)
            finally:
                planner.plan = plan_fn
                del tier._remesh_buffer
            info["lose_devices_s"] = time.perf_counter() - t0
            info.update(timed)
        m = tier.run()
        info["metrics"] = m
        return [tier.results(r) for r in rids], info

    # no failure: the placed tier, then the unplaced one, in turns
    rates = {"placed": [], "unplaced": []}
    ops_reset = h.reset
    ops_reset()
    placed = rt_tier.ServingTier("resnet50", n_replicas=2, devices=slots,
                                 **kw)
    if not placed.placed or [[s_.id for s_ in w.devices]
                             for w in placed.workers] != [[0, 1, 2, 3],
                                                          [4, 5, 6, 7]]:
        raise AssertionError("the placed tier's replicas are not on slots "
                             "0-3 and 4-7")
    launches_placed = counted("placed tier R 2 on 8 slots", placed)
    ops_reset()
    unplaced = rt_tier.ServingTier("resnet50", n_replicas=2, **kw)
    counted("unplaced tier R 2", unplaced)
    base = None
    for label, tier in (("placed", placed), ("unplaced", unplaced),
                        ("unplaced", unplaced), ("placed", placed)) * 2:
        got, info = serve(tier)
        m = info["metrics"]
        if (m["failed"], m["respawns"]) != (0, 0):
            raise AssertionError(f"{label} tier: {m}")
        if base is None:
            base = got
        if not (bitwise(got, base) and bitwise(got, h.logits)):
            raise AssertionError(f"{label} tier: logits differ from the "
                                 f"unplaced tier of phase 7")
        rates[label].append(m["images_per_s"])
    res["images_per_s"] = rates
    res["param_buffer_bytes_per_slot"] = \
        placed.workers[0].server.param_buffer.nbytes_per_slot
    del placed, unplaced
    gc.collect()
    print(f"[placed] ResNet-50 {IMAGE_SIZE} px, S {PIPE_S} x R 2 on 8 slots of "
          f"{h.dev}"
          f" (each replica's even buffer placed, "
          f"{res['param_buffer_bytes_per_slot']} B a slot): "
          f"{len(h.images)} requests == the unplaced tier bitwise; im/s "
          f"in turns placed {[round(r, 1) for r in rates['placed']]}, "
          f"unplaced {[round(r, 1) for r in rates['unplaced']]}; launches "
          f"{launches_placed}")

    # the losses: 4 slots (the cut reused), then 5 (3 survivors: rebuilt)
    for label, lost, reused in (("8 -> 4", slots[2:6], True),
                                ("8 -> 3", slots[3:], False)):
        ops_reset()
        tier = rt_tier.ServingTier("resnet50", n_replicas=2, devices=slots,
                                   **kw)
        got, info = serve(tier, lose=lost)
        m, replan = info["metrics"], info["replan"]
        what = f"placed tier, {label} slots lost after 2 rounds"
        alive = [w for w in tier.workers if w.alive]
        if replan["reused"] != reused or m["failed"] or \
                tier.remeshes != (1 if reused else 0) or not \
                m["recovered_microbatches"]:
            raise AssertionError(f"{what}: {replan}, {m}")
        if reused and ([sorted(s_.id for s_ in w.devices) for w in alive]
                       != [[0, 1, 6, 7]] or replan["n_replicas"] != 1):
            raise AssertionError(f"{what}: replicas on "
                                 f"{[w.devices for w in alive]}")
        if not bitwise(got, base):
            raise AssertionError(f"{what}: logits differ from the no-failure "
                                 f"run")
        counted(what, tier)
        res[label] = {
            "reused": replan["reused"], "n_stages": tier.plan["n_stages"],
            "n_replicas": replan["n_replicas"],
            "alive_slots": [[s_.id for s_ in w.devices] for w in alive],
            "replan_s": info["replan_s"], "remesh_s": info["remesh_s"],
            "lose_devices_s": info["lose_devices_s"],
            "loss_to_first_recovered_s": min(tier.recovery_times),
            "recovered_microbatches": m["recovered_microbatches"],
            "images_per_s": m["images_per_s"]}
        r = res[label]
        print(f"[placed] {what}: re-plan {'reused' if reused else 'a new'} "
              f"cut, S {r['n_stages']} x R {r['n_replicas']} on slots "
              f"{r['alive_slots']}; re-plan "
              f"{sum(r['replan_s']) * 1e3:.2f} ms, remesh "
              f"{sum(r['remesh_s']) * 1e3:.2f} ms, lose_devices (drain, "
              f"re-plan, remesh, respawn) {r['lose_devices_s']:.3f} s; loss "
              f"to the first recovered result "
              f"{r['loss_to_first_recovered_s']:.3f} s; "
              f"{r['recovered_microbatches']} microbatches recovered; == the "
              f"no-failure run bitwise")
        del tier
        gc.collect()
    torch.cuda.empty_cache()
    res["launches"] = launches
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"[placed] phase 7b in {res['phase_s']:.1f} s; launches {launches}")
    return res


def dryrun_lines(dev) -> list:
    """The analytic dry run on the H100's numbers: every applicable (arch,
    shape) at 16 x 16 and 2 x 16 x 16, one line each, and ResNet-50's
    placed pipeline cell on 4 slots of the card at 224 px."""
    from repro_torch.configs import SHAPES, all_configs
    from repro_torch.launch import dryrun
    rows = []
    gib = 2 ** 30
    for arch, cfg in sorted(all_configs().items()):
        if cfg.family == "cnn":
            continue
        for shape in SHAPES:
            for mp in (False, True):
                r = dryrun.run_cell(arch, shape, multi_pod=mp, verbose=False)
                if r["status"] != "ok":
                    continue
                rows.append(r)
                b, rf = r["per_device_bytes"], r["roofline"]
                print(f"[dryrun] {arch} {shape} {r['mesh']}: a device holds "
                      + ", ".join(f"{k} {v / gib:.3f}" for k, v in b.items())
                      + f" GiB; estimate {r['hbm_est_per_device'] / gib:.2f} "
                      f"GiB of {r['chip_hbm_bytes'] / gib:.2f} "
                      f"({'fits' if r['hbm_ok'] else 'does not fit'}); "
                      f"compute {rf['t_compute_s'] * 1e3:.3f} ms, memory "
                      f"{rf['t_memory_s'] * 1e3:.3f} ms ({rf['dominant']}), "
                      f"MFU bound {rf['mfu_bound']:.3f}")
    cell = dryrun.run_cnn_pipeline_cell(
        "resnet50", n_stages=PIPE_S, n_microbatches=PIPE_M, batch=PIPE_BATCH,
        image_size=IMAGE_SIZE, device=dev, verbose=False)
    print(f"[dryrun] resnet50 pipeline_cnn {cell['mesh']} at {IMAGE_SIZE} px "
          f"on slots of {cell['device']}: params a slot "
          f"{cell['param_bytes_placed_per_device']} B placed against "
          f"{cell['param_bytes_replicated_per_device']} B replicated (ratio "
          f"{cell['param_placement_ratio']:.3f}); wire {cell['wire_width']} "
          f"f32, imbalance {cell['imbalance']:.3f}")
    rows.append(cell)
    return rows


def load_example(name: str):
    """The module of ``examples/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example_step_launches(cfg) -> dict:
    """The kernel launches of one ``train()`` step of a reduced LM (remat
    "none": each layer's forward once, half a remat "full" step's)."""
    return {k: v // 2 for k, v in family_launches(cfg).items()}


def example_kernels(h) -> dict:
    """The examples' new kernel shapes on the card (``h``: ``dev``,
    ResNet-50's ``params_dev``, main's ``launch_checked``): flash at D 32
    and the FFN's 16 x 16 blocks of reduced SmolLM-360M, each against
    its plain version (1 bf16 ulp) in the variant ``variant()`` names,
    then timed
    beside it, a library call and the bound (``large_timings``); the
    sparse ResNet-50 example's 47 convs at 64 px, batch 2 (checked in
    phase 3), timed the same way and summed."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.fusion import conv_part, fused_graph_for
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import sparse_matmul as sm
    from repro_torch.models import cnn, lm
    from repro_torch.models.layers import SparseWeight
    dev = h.dev
    gen = torch.Generator(device=dev).manual_seed(SEED + 53)

    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    err = {"flash_attention": 0.0, "sparse_matmul": 0.0}
    rcfg = reduced(get_config(LM))
    flash_inputs = {}
    for b, t, window in EX_FLASH:
        q, k, v = (randn((b, t, rcfg.n_heads, rcfg.head_dim))
                   for _ in range(3))
        kw = {"window": window} if window else {}
        what = f"example B {b} T {t}" + (f" window {window}" if window
                                         else "")
        got = h.launch_checked(
            "flash_attention", fa.variant(q.dtype, q.shape[-1]),
            lambda: fa.flash_attention(q, k, v, **kw), what)
        want = fa.flash_attention_torch(q, k, v, **kw)
        torch.cuda.synchronize()
        err["flash_attention"] = max(err["flash_attention"], compare(
            got, want, bf16_tol, f"flash_attention {what}"))
        flash_inputs[what] = (q, k, v, kw)
    params = lm.init_params(rcfg, torch.Generator(device=dev).manual_seed(
        SEED))
    ffn = lm._layer(params["blocks"], 0)["ffn"]
    mm_inputs = {}
    for w in ("w1", "w2"):
        sw = ffn[w]
        sw = SparseWeight(sw.vals.contiguous(), sw.idx.contiguous(),
                          sw.d_in)
        for m in EX_MM_M:
            x = randn((m, sw.d_in)) / 4
            var = sm.variant(x.dtype, m, *sw.vals.shape[2:])
            got = h.launch_checked("sparse_matmul", var,
                                   lambda: sm.sparse_matmul(x, sw.vals,
                                                            sw.idx),
                                   f"example {w} M={m}")
            want = sm.sparse_matmul_torch(x, sw.vals, sw.idx)
            torch.cuda.synchronize()
            err["sparse_matmul"] = max(err["sparse_matmul"], compare(
                got, want, bf16_tol, f"sparse_matmul example {w} M={m} "
                f"vals {tuple(sw.vals.shape)} ({var})"))
            mm_inputs[(f"{LM} reduced", w, m)] = (x, sw)
    print(f"[check] the LM examples' shapes: flash_attention "
          f"{list(flash_inputs)} (H {rcfg.n_heads}, D {rcfg.head_dim}), "
          f"sparse_matmul {LM} reduced w1 / w2 at M {EX_MM_M} (16 x 16 "
          f"blocks): max |err| {err} within 1 bf16 ulp")
    flash_rows, mm_rows = large_timings(flash_inputs, mm_inputs)
    del params, flash_inputs, mm_inputs

    # the 47 convs at the 64 px example's shapes, batch 2, timed
    cfg = get_config("resnet50")
    graph = fused_graph_for(cfg.name)
    shapes = cnn.node_shapes(cfg, None, (EX_BATCH, EX_IMAGE, EX_IMAGE, 3),
                             graph=graph)
    sums = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms",
                          "bytes_ms", "ops_ms"), 0.0)
    n_conv = 0
    for node, edge in zip(graph.nodes, graph.inputs):
        p = h.params_dev.get(conv_part(node).name) if node.kind == "conv" \
            else None
        if p is None or not isinstance(p["w"], SparseWeight):
            continue
        n_conv += 1
        s_in = tuple(shapes[edge[0]].shape)
        ho = -(-s_in[1] // node.stride)
        r = randn((EX_BATCH, ho, ho, node.cout)) if node.residual_from \
            else None
        row = time_conv(node, p["w"], p["b"], randn(s_in), r,
                        dict(reps=5, rounds=2))
        for key in sums:
            sums[key] += row[key]
    if n_conv != 47:
        raise AssertionError(f"{n_conv} sparse convs at 64 px, not 47")
    sums["bound_by"] = bound_by(sums.pop("bytes_ms"), sums.pop("ops_ms"))
    print(f"[time] sparse_conv x47 at the example's {EX_IMAGE} px, batch "
          f"{EX_BATCH}: kernel {sums['ms']:.4f} ms, plain "
          f"{sums['plain_ms']:.4f} ms, F.conv2d (densified) "
          f"{sums['library_ms']:.4f} ms, bound {sums['bound_ms']:.5f} ms "
          f"({sums['bound_by']})")
    return {"max_abs_err": err, "flash": flash_rows, "sparse_matmul":
            mm_rows, "sparse_conv": sums}


def examples_run(h) -> dict:
    """Phase 7c, the four examples on the card at the reference examples'
    own arguments (``h``: the card ``dev``, ResNet-50's native weights
    on the card ``params_dev``, the launch checks ``check(what, want,
    want_variants)`` and ``launch_checked``, phase 6's batch-1 cache
    ``cache_n1`` and the stage
    costs it planned, ``measured_n1``). Each example's counters are reset
    just before it runs and read just after, checked by name and
    variant: the sparse ResNet-50 (the plan equal to the CPU's on the same
    weights, the 64 px logits within LOGIT_RTOL of max |logit| of the
    plain CPU forward, top-1 equal, 47 sparse_conv "mma" + 1
    sparse_matmul "gemv"), the quickstart (the loss falls over its 30
    steps, the serve() shim's (2, 8) tokens), the resilient run (2
    restarts, the mean of the last 10 losses below the first), the MoE /
    hybrid plans (equal to the CPU's) and their 20-step runs (finite);
    then the dry run's CNN cell planned from phase 6's cache, its stage
    costs phase 6's measured plan."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import planner, tuning
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.models import cnn
    t_phase = time.perf_counter()
    dev = h.dev
    res = {"kernels": example_kernels(h), "wall_s": {}}
    launches = {}

    def run(name, fn, want):
        """``fn()`` timed, its launches checked against ``want``
        ({(kernel, variant): n}, or a function of ``fn()``'s result that
        gives it) and added to the phase's."""
        ops.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        res["wall_s"][name] = time.perf_counter() - t0
        if callable(want):
            want = want(out)
        by_name = {}
        for (k, _), n in want.items():
            by_name[k] = by_name.get(k, 0) + n
        got = h.check(f"example {name}", by_name, want)
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
        return out, got

    # the sparse ResNet-50: one forward, 47 convs and the classifier
    ex = load_example("torch_sparse_resnet_inference")
    out, got = run(EXAMPLES[0], lambda: ex.run(dev),
                   {("sparse_conv", "mma"): 47, ("sparse_matmul", "gemv"): 1})
    cfg = get_config("resnet50")
    p_cpu = cnn.params_to(out["params"], "cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        cpu = ex.compile_plan(cfg, p_cpu)
    plan, plan_cpu = out["plan"], cpu["plan"]
    if (out["unbalanced_cycles"], plan.cycles, plan.splits, plan.resources,
            out["slowest"]) != (cpu["unbalanced_cycles"], plan_cpu.cycles,
                                plan_cpu.splits, plan_cpu.resources,
                                cpu["slowest"]):
        raise AssertionError("sparse ResNet-50 example: the plan on the "
                             "card's weights differs from the CPU's")
    ref = cnn.cnn_forward(cfg, p_cpu, out["images"], device="cpu")
    logits = out["logits"]
    scale = float(ref.abs().max())
    err = float((logits - ref).abs().max())
    if not out["finite"] or tuple(logits.shape) != (EX_BATCH, 1000) or \
            scale == 0 or err > LOGIT_RTOL * scale or not np.array_equal(
                out["top1"], ref.argmax(-1).numpy()):
        raise AssertionError(f"sparse ResNet-50 example: logits "
                             f"{tuple(logits.shape)}, max |err| {err:.3e} "
                             f"against {LOGIT_RTOL} * {scale:.3e}, top-1 "
                             f"{out['top1']} vs {ref.argmax(-1).tolist()}")
    res["sparse_resnet"] = {
        "unbalanced_cycles": out["unbalanced_cycles"],
        "bottleneck_cycles": plan.bottleneck_cycles,
        "resources": plan.resources, "slowest": out["slowest"],
        "logit_rel_err": err / scale, "top1": out["top1"].tolist(),
        "launches": got}
    print(f"[example] {EXAMPLES[0]}: {res['wall_s'][EXAMPLES[0]]:.1f} s; "
          f"plan == the CPU's (bottleneck {out['unbalanced_cycles']} -> "
          f"{plan.bottleneck_cycles} cycles, resources {plan.resources}); "
          f"{EX_IMAGE} px batch {EX_BATCH} logits within "
          f"{err / scale:.2e} of max |logit| of the plain CPU forward, top-1 "
          f"{out['top1'].tolist()} equal; launches {got}")
    del out, p_cpu

    # the quickstart: train() of 30 steps, then the serve(arch) shim
    ex = load_example("torch_quickstart")
    rcfg = reduced(get_config(LM))
    per = example_step_launches(rcfg)
    n_dec = 8 + 8                    # prompt_len + gen_tokens decode steps
    out, got = run(EXAMPLES[1], lambda: ex.run(device=dev), {
        ("flash_attention", "mma"): 30 * per["flash_attention"],
        ("sparse_matmul", "mma"): 30 * per["sparse_matmul"],
        ("sparse_matmul", "gemv"): n_dec * per["sparse_matmul"]})
    losses = [l for _, l in out["losses"]]
    if len(losses) != 30 or not all(map(math.isfinite, losses)) or \
            not losses[-1] < losses[0] or out["tokens"].shape != (2, 8):
        raise AssertionError(f"quickstart: losses {losses}, tokens "
                             f"{out['tokens'].shape}")
    res["quickstart"] = {"losses": losses, "tokens": out["tokens"].tolist(),
                         "launches": got}
    print(f"[example] {EXAMPLES[1]}: {res['wall_s'][EXAMPLES[1]]:.1f} s; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f} over 30 steps; serve("
          f"arch) {out['tokens'].shape} tokens; launches {got}")

    # the resilient run: 200 steps, 2 failures, int8 gradients
    ex = load_example("torch_resilient_training")
    # the steps run (replays included) are known after the run
    out, got = run(EXAMPLES[2], lambda: ex.run(dev), lambda o: {
        ("flash_attention", "mma"): len(o["losses"]) *
        per["flash_attention"],
        ("sparse_matmul", "mma"): len(o["losses"]) * per["sparse_matmul"]})
    n_run = len(out["losses"])
    losses = [l for _, l in out["losses"]]
    if out["restarts"] != 2 or not np.mean(losses[-10:]) < losses[0]:
        raise AssertionError(f"resilient training: restarts "
                             f"{out['restarts']}, loss {losses[0]} -> "
                             f"{np.mean(losses[-10:])}")
    res["resilient"] = {"restarts": out["restarts"], "steps_run": n_run,
                        "stragglers": len(out["stragglers"]),
                        "loss_first": losses[0],
                        "loss_last10": float(np.mean(losses[-10:])),
                        "launches": got}
    print(f"[example] {EXAMPLES[2]}: {res['wall_s'][EXAMPLES[2]]:.1f} s; "
          f"{out['restarts']} restarts, {n_run} steps run for 200, "
          f"stragglers flagged {len(out['stragglers'])}; loss "
          f"{losses[0]:.4f} -> {np.mean(losses[-10:]):.4f} (last 10); "
          f"launches {got}")
    del out

    # the MoE / hybrid stage plans and their 20-step runs
    ex = load_example("torch_moe_expert_parallel")
    want = {}
    for arch in ex.ARCHS:
        for k, v in example_step_launches(reduced(get_config(arch))).items():
            want[(k, "mma")] = want.get((k, "mma"), 0) + 20 * v
    out, got = run(EXAMPLES[3], lambda: ex.run(device=dev), want)
    rows = {}
    for arch in ex.ARCHS:
        cpu = planner.plan_lm_stages(get_config(arch), 4096, 16, n_stages=4)
        row = out[arch]
        if row["plan"]["stage_of"] != cpu["stage_of"] or \
                row["plan"]["imbalance"] != cpu["imbalance"] or \
                row["cuts"] != [cpu["stage_of"].index(s) for s in (1, 2, 3)]:
            raise AssertionError(f"{arch}: the plan differs from the CPU's")
        if len(row["losses"]) != 20 or not all(map(math.isfinite,
                                                   row["losses"])):
            raise AssertionError(f"{arch}: losses {row['losses']}")
        rows[arch] = {"cuts": row["cuts"], "imbalance": row["plan"][
            "imbalance"], "hetero": row["hetero"], "losses": row["losses"]}
    res["moe"] = dict(rows, launches=got)
    print(f"[example] {EXAMPLES[3]}: {res['wall_s'][EXAMPLES[3]]:.1f} s; "
          + "; ".join(f"{a} cuts {r['cuts']} imbalance "
                      f"{r['imbalance']:.3f} == the CPU's, loss "
                      f"{r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}"
                      for a, r in rows.items()) + f"; launches {got}")
    del out

    # the dry run's CNN cell planned from phase 6's measured cache
    prev = tuning.current_tuning_cache()
    t0 = time.perf_counter()
    cell = dryrun.run_cnn_pipeline_cell(
        "resnet50", n_stages=PIPE_S, n_microbatches=PIPE_M, batch=PIPE_BATCH,
        image_size=IMAGE_SIZE, device=dev, verbose=False,
        tuning_cache=h.cache_n1)
    if cell["stage_cost_cycles"] != h.measured_n1:
        raise AssertionError(f"dry run's measured cell: stage costs "
                             f"{cell['stage_cost_cycles']} != phase 6's "
                             f"{h.measured_n1}")
    if tuning.current_tuning_cache() is not prev:
        raise AssertionError("the dry run left its cache installed")
    res["dryrun_measured"] = {"stage_cost": cell["stage_cost_cycles"],
                              "imbalance": cell["imbalance"],
                              "s": time.perf_counter() - t0}
    print(f"[dryrun] resnet50 pipeline_cnn {cell['mesh']} from phase 6's "
          f"batch-1 cache: stage costs "
          f"{[round(c, 1) for c in cell['stage_cost_cycles']]} us == phase "
          f"6's measured plan (imbalance {cell['imbalance']:.3f}) in "
          f"{res['dryrun_measured']['s']:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    res["launches"] = launches
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"[example] phase 7c in {res['phase_s']:.1f} s; launches "
          f"{launches}")
    return res


def domain_kernels(dev, cfg, params_cpu) -> dict:
    """Every kernel at the shapes only its widened variants take, against
    its plain version on the same card inputs (1 bf16 ulp; 1e-5 relative
    in f32), in the variant ``variant()`` names, then timed beside that
    plain version, its bound and one library call on the card ``dev``.
    Returns per kernel the rows, the sums and the worst error."""
    from repro_torch.core.fusion import conv_part, fused_graph_for
    from repro_torch.core.quant import quantize_tree
    from repro_torch.core.sparsity import densify, to_block_balanced
    from repro_torch.configs import SparsityConfig
    from repro_torch.kernels import depthwise_conv as dwk
    from repro_torch.kernels import dw_pw_fused as dwpw
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import sparse_conv as sc
    from repro_torch.kernels import sparse_matmul as sm
    from repro_torch.models import cnn
    from repro_torch.models.layers import SparseWeight
    gen = torch.Generator(device=dev).manual_seed(SEED + 61)

    def randn(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def checked(name, what, launch, plain, tol):
        """``launch()`` in the variant ``variant()`` names, against
        ``plain()``; returns (max |err|, the variant)."""
        got = launch_checked(name, what[1], launch, what[0])
        want = plain()
        torch.cuda.synchronize()
        return compare(got, want, tol, f"{name} {what[0]} ({what[1]})")

    err = dict.fromkeys(("sparse_conv", "sparse_matmul", "flash_attention",
                         "dw_pw", "depthwise_conv"), 0.0)
    res = {}

    # the 33 convs at n 1 / 2 / 4, checked, then timed (summed over a
    # forward's convs at each n) beside F.conv2d on the densified weight
    graph = fused_graph_for(cfg.name)
    conv_rows, conv_sums = [], {}
    for n in DOMAIN_CONV_N:
        shapes = cnn.node_shapes(cfg, None, (n, IMAGE_SIZE, IMAGE_SIZE, 3),
                                 graph=graph)
        sums = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms",
                              "bytes_ms", "ops_ms"), 0.0)
        n_conv = 0
        for node, edge in zip(graph.nodes, graph.inputs):
            p = params_cpu.get(conv_part(node).name) \
                if node.kind == "conv" else None
            if p is None or not isinstance(p["w"], SparseWeight):
                continue
            n_conv += 1
            sw, b = p["w"].to(dev), (randn((node.cout,)) * 0.1)
            x = randn(tuple(shapes[edge[0]].shape))
            ho = -(-x.shape[1] // node.stride)
            r = randn((n, ho, ho, node.cout)) if node.residual_from else None
            v = sc.variant(*sw.vals.shape[2:])
            kw = dict(k=node.k, stride=node.stride, relu=node.relu)
            err["sparse_conv"] = max(err["sparse_conv"], checked(
                "sparse_conv", (f"{node.name} n={n} blocks "
                                f"{tuple(sw.vals.shape[2:])}", v),
                lambda: sc.sparse_conv(x, sw.vals, sw.idx, b, r, **kw),
                lambda: sc.sparse_conv_torch(x, sw.vals, sw.idx, b, r, **kw),
                bf16_tol))
            row = time_conv(node, sw, b, x, r, dict(reps=2, rounds=2))
            steps = sc.k_steps(sw.vals.shape[1], sw.vals.shape[2])
            row.update(layer=node.name, n=n, vals=list(sw.vals.shape),
                       variant=v, plan=list(sc.plan(
                           n * ho * ho, sw.vals.shape[0], steps)))
            conv_rows.append(row)
            for key in sums:
                sums[key] += row[key]
        if n_conv != 33:
            raise AssertionError(f"{n_conv} sparse convs at 128 x 128 "
                                 f"blocks, not 33")
        sums["bound_by"] = bound_by(sums.pop("bytes_ms"), sums.pop("ops_ms"))
        conv_sums[n] = sums
        print(f"[time] domain sparse_conv x33 at 128 x 128 / 64 x 64 blocks, "
              f"{IMAGE_SIZE} px, n {n} (mma): kernel {sums['ms']:.4f} ms, "
              f"plain {sums['plain_ms']:.4f} ms, F.conv2d (densified) "
              f"{sums['library_ms']:.4f} ms, bound {sums['bound_ms']:.5f} ms "
              f"({sums['bound_by']})")
    res["sparse_conv"] = {"rows": conv_rows, "by_n": conv_sums}

    # sparse_matmul: the classifier's 128 x 125 blocks (f32 x, as the
    # forward gives it), square blocks of side 96 and 256 (bf16 x)
    fc = params_cpu["fc"]["w"].to(dev)
    mm_cases = [(f"fc 128x125 M={m} f32", randn((m, fc.d_in), torch.float32),
                 fc, f32_tol) for m in DOMAIN_FC_M]
    for side, d_in, d_out in DOMAIN_MM:
        w = (torch.rand((d_in, d_out), generator=gen, device=dev) * 2 - 1) \
            / math.sqrt(d_in)
        sw = to_block_balanced(w.to(torch.bfloat16).cpu(), SparsityConfig(
            True, 0.5, side, side)).to(dev)
        for m in DOMAIN_MM_M:
            mm_cases.append((f"{side}x{side} M={m} bf16",
                             randn((m, d_in)) / 4, sw, bf16_tol))
    mm_rows = []
    for what, x, sw, tol in mm_cases:
        ob, n_k, bm, bn = sw.vals.shape
        m = x.shape[0]
        v = sm.variant(x.dtype, m, bm, bn)
        err["sparse_matmul"] = max(err["sparse_matmul"], checked(
            "sparse_matmul", (what, v),
            lambda: sm.sparse_matmul(x, sw.vals, sw.idx),
            lambda: sm.sparse_matmul_torch(x, sw.vals, sw.idx), tol))
        w_dense = densify(sw).to(x.dtype)
        ms = time_ms(lambda: sm.sparse_matmul(x, sw.vals, sw.idx))
        plain = time_ms(lambda: sm.sparse_matmul_torch(x, sw.vals, sw.idx),
                        reps=2, rounds=2)
        lib = time_ms(lambda: torch.matmul(x, w_dense))
        del w_dense
        x_elems = m * int(sw.idx.unique().numel()) * bm
        nbytes = ((x_elems + m * ob * bn) * x.element_size()
                  + sw.vals.numel() * sw.vals.element_size()
                  + sw.idx.numel() * 4)
        t_b, t_o = bound(nbytes, 2 * m * ob * n_k * bm * bn, x.dtype)
        mm_rows.append({"what": what, "M": m, "vals": list(sw.vals.shape),
                        "variant": v, "ms": ms, "plain_ms": plain,
                        "library_ms": lib, "bound_ms": max(t_b, t_o),
                        "bound_by": bound_by(t_b, t_o)})
        print(f"[time] domain sparse_matmul {what} vals {tuple(sw.vals.shape)}"
              f" ({v}): kernel {ms * 1e3:.3f} us, plain {plain * 1e3:.3f} us,"
              f" torch.matmul (dense) {lib * 1e3:.3f} us, bound "
              f"{max(t_b, t_o) * 1e3:.3f} us ({bound_by(t_b, t_o)})")
    res["sparse_matmul"] = {"rows": mm_rows}

    # flash at the public head sizes (causal T 2048) and at 16 and 40 in
    # both dtypes, against SDPA on the same tensors (large_timings)
    flash_inputs = {}
    cases = [(shape, torch.bfloat16) for shape in DOMAIN_FLASH] + [
        (shape, dt) for shape in DOMAIN_FLASH_SMALL
        for dt in (torch.bfloat16, torch.float32)]
    for (b, t, heads, d), dt in cases:
        q, k, v = (randn((b, t, heads, d), dt) for _ in range(3))
        what = f"D {d} {str(dt).removeprefix('torch.')}"
        var = fa.variant(dt, d)
        tol = bf16_tol if dt == torch.bfloat16 else f32_tol
        err["flash_attention"] = max(err["flash_attention"], checked(
            "flash_attention", (f"{what} (B {b}, T {t}, H {heads})", var),
            lambda: fa.flash_attention(q, k, v),
            lambda: fa.flash_attention_torch(q, k, v), tol))
        flash_inputs[what] = (q, k, v, {})
    flash_rows, _ = large_timings(flash_inputs, {})
    res["flash_attention"] = {"rows": flash_rows}
    del flash_inputs

    # dw_pw: int8 and f32 at k 5 and 7, bf16 at k 9 (each the run-time k),
    # beside the cuDNN depthwise + 1x1 pair in the store's compute dtype
    dw_pw_rows = []
    for store, k in DOMAIN_DW_PW:
        for c, co, hw, stride in DOMAIN_DW_PW_SHAPES:
            x = randn((1, hw, hw, c))
            dw_w = randn((k, k, c)) / k
            dw_b = randn((c,)) * 0.1
            pw_w = randn((c, co)) / math.sqrt(c)
            pw_b = randn((co,)) * 0.1
            scale = None
            if store == "int8":
                qw = quantize_tree({"l": {"w": pw_w.cpu()}}, "int8")["l"]["w"]
                pw_w, scale = qw.codes.to(dev), qw.scale.to(dev)
                w_lib = qw.dequant().to(dev, torch.bfloat16)
            elif store == "f32":
                dw_w, dw_b, pw_w, pw_b = (t.float() for t in
                                          (dw_w, dw_b, pw_w, pw_b))
                w_lib = pw_w
            else:
                w_lib = pw_w
            args = (x, dw_w, dw_b, pw_w, pw_b, None, scale)
            var = dwpw.variant(c, co, k, stride, pw_w.dtype)
            what = f"{store} k {k} C {c} Cout {co} H {hw} s {stride}"
            err["dw_pw"] = max(err["dw_pw"], checked(
                "dw_pw", (what, var),
                lambda: dwpw.dw_pw(*args, stride=stride),
                lambda: dwpw.dw_pw_torch(*args, stride=stride), bf16_tol))
            ldt = torch.float32 if store == "f32" else torch.bfloat16
            x_cl = x.to(ldt).permute(0, 3, 1, 2)
            w_dw = dw_w.to(ldt).permute(2, 0, 1).unsqueeze(1).contiguous(
                memory_format=torch.channels_last)
            w_pw = w_lib.to(ldt).t().reshape(co, c, 1, 1).contiguous(
                memory_format=torch.channels_last)
            b_dw, b_pw = dw_b.to(ldt), pw_b.to(ldt)
            ms = time_ms(lambda: dwpw.dw_pw(*args, stride=stride))
            plain = time_ms(lambda: dwpw.dw_pw_torch(*args, stride=stride),
                            reps=2, rounds=2)
            pair = time_ms(lambda: F.conv2d(
                F.conv2d(x_cl, w_dw, b_dw, stride, k // 2, groups=c),
                w_pw, b_pw))
            ho = -(-hw // stride)
            m = ho * ho
            pb = dw_w.element_size()
            nbytes = (2 * (x.numel() + m * co) + pb * (dw_w.numel() + c + co)
                      + pw_w.numel() * pw_w.element_size()
                      + (4 * co if scale is not None else 0))
            nops = 2 * m * c * (k * k + co)
            t_b, t_o = bound(nbytes, nops, ldt)
            dw_pw_rows.append({"what": what, "variant": var, "ms": ms,
                               "plain_ms": plain, "library_ms": pair,
                               "bound_ms": max(t_b, t_o),
                               "bound_by": bound_by(t_b, t_o)})
            print(f"[time] domain dw_pw {what} ({var}): kernel "
                  f"{ms * 1e3:.3f} us, plain {plain * 1e3:.3f} us, F.conv2d "
                  f"dw+1x1 pair {pair * 1e3:.3f} us, bound "
                  f"{max(t_b, t_o) * 1e3:.3f} us ({bound_by(t_b, t_o)})")
    res["dw_pw"] = {"rows": dw_pw_rows}

    # depthwise_conv at k 9 (the run-time k) beside F.conv2d(groups=C)
    dw_rows = []
    k = DOMAIN_DW_K
    for c, hw, stride in DOMAIN_DW_SHAPES:
        x, w = randn((1, hw, hw, c)), randn((k, k, c)) / k
        what = f"k {k} C {c} H {hw} s {stride}"
        got = dwk.depthwise_conv(x, w, stride=stride)
        want = dwk.depthwise_conv_torch(x, w, stride=stride)
        torch.cuda.synchronize()
        err["depthwise_conv"] = max(err["depthwise_conv"], compare(
            got, want, bf16_tol, f"depthwise_conv {what}"))
        x_cl = x.permute(0, 3, 1, 2)
        w_dw = w.permute(2, 0, 1).unsqueeze(1).contiguous(
            memory_format=torch.channels_last)
        ms = time_ms(lambda: dwk.depthwise_conv(x, w, stride=stride))
        plain = time_ms(lambda: dwk.depthwise_conv_torch(x, w,
                                                         stride=stride),
                        reps=2, rounds=2)
        lib = time_ms(lambda: F.conv2d(x_cl, w_dw, None, stride, k // 2,
                                       groups=c))
        ho = -(-hw // stride)
        t_b, t_o = bound(2 * (x.numel() + w.numel() + ho * ho * c),
                         2 * ho * ho * c * k * k, torch.bfloat16)
        dw_rows.append({"what": what, "ms": ms, "plain_ms": plain,
                        "library_ms": lib, "bound_ms": max(t_b, t_o),
                        "bound_by": bound_by(t_b, t_o)})
        print(f"[time] domain depthwise_conv {what}: kernel {ms * 1e3:.3f} "
              f"us, plain {plain * 1e3:.3f} us, F.conv2d(groups=C) "
              f"{lib * 1e3:.3f} us, bound {max(t_b, t_o) * 1e3:.3f} us "
              f"({bound_by(t_b, t_o)})")
    res["depthwise_conv"] = {"rows": dw_rows}
    print(f"[check] domain: every new kernel shape within its bar of its "
          f"plain version (1 bf16 ulp; f32 1e-5 relative): max |err| {err}")
    res["max_abs_err"] = err
    return res


def domain_run(dev, cell32=None) -> dict:
    """Phase 7d: sparse ResNet-50 with SparsityConfig's default 128 x 128
    blocks at full width, 224 px, on the card, through the entry points
    that take a config, on the card ``dev`` (``cell32``: the 32 x 32
    cell's numbers of this run by store, printed beside; None when the
    phase runs alone). Native and int8: 50 batch-1 requests, each a replay of one
    CUDA graph of ``cnn.cnn_forward`` (captured as ``latency_request``
    captures it) and the same requests eagerly, graph == eager bit for
    bit; the continuous ``CNNPipelineServer(cfg=, params=, plan=)`` at mb
    2, S 4 on the planner's cut, 16 requests of 8 images, == the
    sequential forward at mb 2 bit for bit. Launches are counted exactly
    (33 sparse_conv + 1 sparse_matmul a forward, by variant); the logits
    of the first request of each run are held to the plain CPU forward
    (1e-3 of max |logit|, top-1 equal) and every node, fed the card's own
    input, to 1 bf16 ulp. Then ``domain_kernels``."""
    from repro_torch.configs import get_config
    from repro_torch.core import planner
    from repro_torch.core.device import graph_capture
    from repro_torch.core.fusion import fused_graph_for
    from repro_torch.core.quant import quantize_tree
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import CNNPipelineServer
    from repro_torch.models import cnn
    from repro_torch.models.layers import SparseWeight
    t_phase = time.perf_counter()
    base = get_config("resnet50")
    cfg = dataclasses.replace(base, sparsity=dataclasses.replace(
        base.sparsity, block_m=128, block_n=128))
    params_cpu = cnn.init_cnn(cfg, torch.Generator().manual_seed(SEED),
                              device="cpu")
    blocks = {}
    for p in params_cpu.values():
        if isinstance(p["w"], SparseWeight):
            key = tuple(p["w"].vals.shape[2:])
            blocks[key] = blocks.get(key, 0) + 1
    if blocks != DOMAIN_BLOCKS:
        raise AssertionError(f"ResNet-50 at 128 x 128: blocks {blocks}")
    graph = fused_graph_for(cfg.name)
    per_fwd = {"sparse_conv": 33, "sparse_matmul": 1}
    per_fwd_v = {("sparse_conv", "mma"): 33, ("sparse_matmul", "gemv"): 1}
    rng = np.random.default_rng(SEED + 71)
    images = rng.normal(size=(N_REQUESTS, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(
        np.float32)
    res = {"blocks": {f"{a}x{b}": n for (a, b), n in blocks.items()},
           "stores": {}}
    launches, variants = {}, {}

    def counted(what, fn, forwards):
        """``fn()`` with the counters reset just before and read just
        after: ``forwards`` forwards' launches by name and variant."""
        ops.reset_launches()
        out = fn()
        got, got_v = dict(ops.LAUNCHES), dict(ops.VARIANT_LAUNCHES)
        check_launches(got, {k: v * forwards for k, v in per_fwd.items()},
                       what)
        check_variants(got_v, {k: v * forwards for k, v in
                               per_fwd_v.items()}, what)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        for k, v in got_v.items():
            variants[k] = variants.get(k, 0) + v
        return out

    for q in ("native", "int8"):
        stored = quantize_tree(params_cpu, q)
        p_dev = cnn.params_to(stored, dev)

        def forward(img):
            return cnn.cnn_forward(cfg, p_dev, img, device=dev)

        # batch 1: the warm-up on a side stream, then the forward captured
        # into one CUDA graph, as latency_request does it
        img_shape = (1, IMAGE_SIZE, IMAGE_SIZE, 3)
        static_in = torch.zeros(img_shape, device=dev)
        cuda_graph = torch.cuda.CUDAGraph()

        def capture():
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                forward(torch.zeros(img_shape)).cpu()
            torch.cuda.current_stream(dev).wait_stream(side)
            with graph_capture(cuda_graph):
                return forward(static_in)

        static_out = counted(f"domain {q} warm-up and capture", capture, 2)
        lat, g_logits = [], []
        for i in range(N_REQUESTS):
            t0 = time.perf_counter()
            static_in.copy_(torch.from_numpy(images[i:i + 1]))
            cuda_graph.replay()
            g_logits.append(static_out.cpu())
            lat.append(time.perf_counter() - t0)
        e_lat, e_logits = [], []

        def eager():
            for i in range(N_REQUESTS):
                t0 = time.perf_counter()
                e_logits.append(forward(torch.from_numpy(
                    images[i:i + 1])).cpu())
                e_lat.append(time.perf_counter() - t0)

        counted(f"domain {q} eager requests", eager, N_REQUESTS)
        g_logits, e_logits = torch.cat(g_logits), torch.cat(e_logits)
        if not torch.equal(g_logits, e_logits):
            raise AssertionError(f"domain {q}: the graph's logits differ "
                                 f"from the eager requests'")
        logit_err = check_logits(g_logits, images, cfg, stored, n=1)
        node_err = check_nodes(dev, cfg, graph, p_dev, stored, images[:1])
        row = {"graph_p50_ms": float(np.percentile(lat, 50)) * 1e3,
               "graph_p99_ms": float(np.percentile(lat, 99)) * 1e3,
               "graph_images_per_s": N_REQUESTS / sum(lat),
               "eager_p50_ms": float(np.percentile(e_lat, 50)) * 1e3,
               "eager_p99_ms": float(np.percentile(e_lat, 99)) * 1e3,
               "logit_err": logit_err, "node_err_share": node_err}

        # the continuous server on the planner's cut of this config
        plan = planner.plan(cfg, params_cpu, planner.PlanRequest(
            n_stages=PIPE_S, store_dtype=q))
        srv = counted(f"domain {q} continuous warm-up and capture",
                      lambda: CNNPipelineServer(
                          cfg.name, mb_size=2, n_stages=PIPE_S,
                          image_size=IMAGE_SIZE, seed=SEED, quantize=q,
                          device=dev, cfg=cfg, params=params_cpu, plan=plan),
                      4)
        warm = srv.submit(np.zeros((2, IMAGE_SIZE, IMAGE_SIZE, 3),
                                   np.float32))
        srv.run()
        srv.results(warm)
        reqs = [rng.normal(size=(CONT_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3))
                .astype(np.float32) for _ in range(CONT_REQUESTS)]
        ids = [srv.submit(x) for x in reqs]
        metrics = srv.run()
        outs = [srv.results(i) for i in ids]
        with torch.inference_mode():
            for x, got in zip(reqs, outs):
                seq = torch.cat([forward(torch.from_numpy(x[i:i + 2])).cpu()
                                 for i in range(0, CONT_BATCH, 2)])
                if not torch.equal(torch.from_numpy(got), seq):
                    raise AssertionError(f"domain {q} continuous: logits "
                                         f"differ from the sequential "
                                         f"forward (mb 2)")
        c_err = check_logits(torch.from_numpy(outs[0]), reqs[0], cfg,
                             stored, n=1)
        lat_c = metrics["request_latencies_s"]
        row["continuous"] = {
            "images_per_s": metrics["images_per_s"],
            "p50_ms": float(np.percentile(lat_c, 50)) * 1e3,
            "p99_ms": float(np.percentile(lat_c, 99)) * 1e3,
            "stage_of": list(plan["stage_of"]), "logit_err": c_err,
            "launches_per_tick": srv.launches_per_tick[0]}
        del srv
        res["stores"][q] = row
        print(f"[domain] resnet50 128x128 blocks {q}: {N_REQUESTS} batch-1 "
              f"requests at {IMAGE_SIZE}px: graph p50 "
              f"{row['graph_p50_ms']:.4f} ms, p99 {row['graph_p99_ms']:.4f} "
              f"ms ({row['graph_images_per_s']:.1f} im/s), eager p50 "
              f"{row['eager_p50_ms']:.4f} ms; graph == eager bitwise; "
              f"33 sparse_conv mma + 1 sparse_matmul gemv a forward; vs CPU "
              f"{logit_err:.3e} of max |logit| (bar {LOGIT_RTOL}), top-1 "
              f"equal; every node within {node_err:.3f} of its 1 bf16 ulp "
              f"bar; continuous mb 2 S {PIPE_S} (cuts {plan['stage_of']}): "
              f"{row['continuous']['images_per_s']:.1f} im/s, request p50 "
              f"{row['continuous']['p50_ms']:.3f} / p99 "
              f"{row['continuous']['p99_ms']:.3f} ms, == sequential bitwise, "
              f"vs CPU {c_err:.3e}" + ("" if cell32 is None else (
                  f"; the 32 x 32 cell in this run: graph p50 "
                  f"{cell32[q]['graph_p50_ms']:.4f} / p99 "
                  f"{cell32[q]['graph_p99_ms']:.4f} ms, continuous "
                  f"{cell32[q]['continuous_images_per_s']:.1f} im/s")))
        del p_dev, cuda_graph, static_in, static_out
        gc.collect()
        torch.cuda.empty_cache()
    res["launches"] = launches
    res["variant_launches"] = {f"{k}/{v}": n for (k, v), n in
                               variants.items() if n}
    res["kernels"] = domain_kernels(dev, cfg, params_cpu)
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"[domain] phase 7d in {res['phase_s']:.1f} s; launches {launches}")
    return res


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
    from repro_torch.core.graph import graph_for
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
          f"{ {f'{n}/{v}': c for (n, v), c in CHECKED_VARIANTS.items()} }")

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
          f"{ {f'{n}/{v}': c for (n, v), c in CHECKED_VARIANTS.items()} }")
    del large_w

    # the recurrent and encoder-decoder LMs: flash at zamba2's D 112 (its
    # T = 2048 prefill under its window of 4096, a window shorter than T,
    # a cache chunk with q_offset, f32) and at whisper's three shapes (D
    # 64: the encoder's non-causal 1500 x 1500, whose keys end 28 into a
    # tile; the decoder's causal 448; cross-attention 448 x 1500); the
    # sparse matmul at whisper's 64 x 64 FFN blocks (M 1-4 gemv, 448 and
    # 1500 mma) and zamba2's 128 x 128 ones (M 1-4, 2048)
    zc, wc = get_config(ZAMBA), get_config(WHISPER)
    zs = (zc.n_heads, zc.head_dim, torch.bfloat16, zc.kv_heads)
    ws = (wc.n_heads, wc.head_dim, torch.bfloat16, wc.kv_heads)
    te = wc.encoder_seq
    state_flash = [
        (f"{ZAMBA} T={PREFILL_T} window={zc.attn_window}",
         (1, PREFILL_T, PREFILL_T) + zs,
         dict(causal=True, window=zc.attn_window)),
        (f"{ZAMBA} heads T=1000 window=300", (1, 1000, 1000) + zs,
         dict(causal=True, window=300)),
        (f"{ZAMBA} heads chunk Tq=256 q_offset=768 Tk=1024 window=512",
         (1, 256, 1024) + zs, dict(causal=True, window=512, q_offset=768)),
        ("T=130 D=112 window=50 f32", (1, 130, 130, 2, 112, torch.float32,
                                       2), dict(causal=True, window=50)),
        (f"{WHISPER} encoder {te}x{te}", (1, te, te) + ws,
         dict(causal=False)),
        (f"{WHISPER} decoder T={WHISPER_T}", (1, WHISPER_T, WHISPER_T) + ws,
         dict(causal=True)),
        (f"{WHISPER} cross {WHISPER_T}x{te}", (1, WHISPER_T, te) + ws,
         dict(causal=False)),
    ]
    timed_state_flash = (f"{ZAMBA} T=", WHISPER)
    state_flash_err, state_flash_inputs = 0.0, {}
    for what, shape, kw in state_flash:
        q, k, v = qkv(*shape)
        var = fa.variant(q.dtype, q.shape[-1])
        if var != ("mma" if q.dtype == torch.bfloat16 else "simt"):
            raise AssertionError(f"flash_attention {what}: variant {var}")
        got = launch_checked("flash_attention", var,
                             lambda: fa.flash_attention(q, k, v, **kw), what)
        want = fa.flash_attention_torch(q, k, v, **kw)
        torch.cuda.synchronize()
        tol = bf16_tol if q.dtype == torch.bfloat16 else f32_tol
        state_flash_err = max(state_flash_err, compare(
            got, want, tol, f"flash_attention {what} ({var})"))
        if what.startswith(timed_state_flash):   # timed in phase 5
            state_flash_inputs[what] = (q, k, v, kw)
    flash_err = max(flash_err, state_flash_err)
    print(f"[check] flash_attention at D 112 ({ZAMBA}) and at {WHISPER}'s "
          f"encoder, decoder and cross shapes: {[c[0] for c in state_flash]}"
          f", max |err| {state_flash_err:.3e} within 1 bf16 ulp / 1e-5 "
          f"relative")
    state_w = large_ffn_weights(dev, SEED + 31, names=(WHISPER, ZAMBA))
    state_mm_err, state_mm_inputs = 0.0, {}
    for (name, w), sw in state_w.items():
        for m in STATE_MM_M[name]:
            x = randn((m, sw.d_in))
            if sm.variant(x.dtype, m, *sw.vals.shape[2:]) != (
                    "gemv" if m <= sm.SIMT_MAX_M else "mma"):
                raise AssertionError(f"sparse_matmul {name} {w} M={m}: "
                                     f"variant")
            state_mm_err = max(state_mm_err, check_mm(
                f"{name} {w} M={m}", x, sw, bf16_tol))
            if m == STEP_BATCH or m > sm.SIMT_MAX_M:   # timed in phase 5
                state_mm_inputs[(name, w, m)] = (x, sw)
    mm_err = max(mm_err, state_mm_err)
    print(f"[check] sparse_matmul at {WHISPER}'s 64x64 and {ZAMBA}'s 128x128 "
          f"FFN blocks: "
          f"{ {f'{n} {w}': tuple(sw.vals.shape) for (n, w), sw in state_w.items()} }"
          f" at M={STATE_MM_M}, bf16, max |err| {state_mm_err:.3e} within 1 "
          f"bf16 ulp; checks by variant "
          f"{ {f'{n}/{v}': c for (n, v), c in CHECKED_VARIANTS.items()} }")
    del state_w

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
          f"{ {f'{n}/{v}': c for (n, v), c in CHECKED_VARIANTS.items()} }")

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

    # the sparse ResNet-50 example's shapes (phase 7c runs it): every
    # sparse conv at its input at 64 px, batch 2 (spatial 16x16 down to
    # 2x2), residual on and off, each shape's plan printed; the classifier
    # at M 2
    ex_shapes = cnn.node_shapes(cfg, None, (EX_BATCH, EX_IMAGE, EX_IMAGE, 3),
                                graph=graph)
    edge_of = {n.name: e for n, e in zip(graph.nodes, graph.inputs)}
    ex_err, ex_seen = {"sparse_conv": 0.0, "sparse_matmul": 0.0}, set()
    for node in layers:
        sw, _ = conv_part_params(node)
        s_in = tuple(ex_shapes[edge_of[node.name][0]].shape)
        key = (node.k, node.stride, node.cin, node.cout, sw.vals.shape[1],
               s_in[1])
        if key in ex_seen:
            continue
        ex_seen.add(key)
        ho = -(-s_in[1] // node.stride)
        x = randn(s_in)
        b = randn((node.cout,)) * 0.1
        for r, relu in ((None, node.relu),
                        (randn((EX_BATCH, ho, ho, node.cout)), True)):
            ex_err["sparse_conv"] = max(ex_err["sparse_conv"], check_conv(
                f"{EX_IMAGE} px n={EX_BATCH} {key} res={r is not None}", x,
                sw, b, r, relu, k=node.k, stride=node.stride))
        tm, split = sc.plan(EX_BATCH * ho * ho, sw.vals.shape[0],
                            sw.vals.shape[1])
        print(f"[plan] sparse_conv {EX_IMAGE} px n={EX_BATCH} "
              f"{node.name:9s} M {EX_BATCH * ho * ho:5d}: tm {tm}, split "
              f"{split}")
    ex_err["sparse_matmul"] = check_mm(
        f"fc M={EX_BATCH} f32 ({EX_IMAGE} px example)",
        randn((EX_BATCH, 2048), torch.float32), fc_w, f32_tol)
    print(f"[check] the sparse ResNet-50 example's shapes ({EX_IMAGE} px, "
          f"batch {EX_BATCH}): sparse_conv at {len(ex_seen)} shapes x "
          f"residual on/off (mma), the classifier at M {EX_BATCH} (gemv): "
          f"max |err| {ex_err} within 1 bf16 ulp / 1e-5 relative")

    # -- 4. the main paths ------------------------------------------------
    all_variants = {k: 0 for k in ops.VARIANT_LAUNCHES}

    def add_variants(variants: dict) -> None:
        for k, v in variants.items():
            all_variants[k] += v

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
        node_err = {view: check_nodes(dev, mcfg, g, params_dev, mb_params[name],
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
    # the recurrent and encoder-decoder LMs at full width, one at a time
    state_main = {}
    for name in STATE_LMS:
        t0 = time.perf_counter()
        state_main[name] = state_lm_run(name, lm_h)
        state_main[name]["phase_s"] = time.perf_counter() - t0
        print(f"[main] {name}: {state_main[name]['phase_s']:.1f} s")
    for name in (RWKV, ZAMBA):
        batcher_main[name] = state_main[name].pop("batcher")
    # LM training at full width: train(), the restart, the pipelined step
    t0 = time.perf_counter()
    train_main = train_run(lm_h)
    train_main["phase_s"] = time.perf_counter() - t0
    print(f"[main] training: {train_main['phase_s']:.1f} s")

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
        row = time_conv(node, sw, b, x, r)
        ms, plain, lib = row["ms"], row["plain_ms"], row["library_ms"]
        nbytes, nops, t_b, t_o = (row["bytes"], row["ops"], row["bytes_ms"],
                                  row["ops_ms"])
        bms, by = row["bound_ms"], row["bound_by"]
        sw8 = params_q["int8"][conv_part(node).name]["w"].to(dev)
        ms8 = time_ms(lambda: sc.sparse_conv(x, sw8.vals, sw8.idx, b, r,
                                             sw8.scale, **kw))
        plain8 = time_ms(lambda: sc.sparse_conv_torch(
            x, sw8.vals, sw8.idx, b, r, sw8.scale, **kw))
        m = ho * ho
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
                     "input_read": row["input_read"],
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
            ho = node.conv_out_hw
            x = randn((n_, node.in_hw, node.in_hw, node.cin))
            r = randn((n_, ho, ho, node.cout)) if node.residual_from else None
            add_sums(t["sparse_conv"], time_conv(node, sw, b, x, r,
                                                 dict(reps=5, rounds=2)))
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
    # the recurrent and encoder-decoder LMs: flash at zamba2's D 112 and
    # whisper's shapes, the sparse matmul at their FFN blocks, each beside
    # its plain version, bound and library call; then each model's prefill
    # and decode-step latency with its kernels' share, and serve_lm
    state_flash_rows, state_mm_rows = large_timings(state_flash_inputs,
                                                    state_mm_inputs)
    del state_flash_inputs, state_mm_inputs
    t_fl = {r["what"]: r["ms"] for r in state_flash_rows}
    t_mm = {(r["arch"], r["weight"], r["M"]): r["ms"] for r in state_mm_rows}
    for name, r in state_main.items():
        if name == ZAMBA:
            sites = r["attn_sites"]
            r["prefill_kernels_ms"] = {
                "flash_attention": sites * t_fl[
                    f"{ZAMBA} T={PREFILL_T} window={zc.attn_window}"],
                "sparse_matmul": sites * (2 * t_mm[(ZAMBA, "w1", PREFILL_T)]
                                          + t_mm[(ZAMBA, "w2", PREFILL_T)])}
        elif name == WHISPER:
            n, ne = r["layers"], r["encoder_layers"]
            r["prefill_kernels_ms"] = {
                "flash_attention": ne * t_fl[f"{WHISPER} encoder {te}x{te}"]
                + n * (t_fl[f"{WHISPER} decoder T={WHISPER_T}"]
                       + t_fl[f"{WHISPER} cross {WHISPER_T}x{te}"]),
                "sparse_matmul": ne * (2 * t_mm[(WHISPER, "w1", te)]
                                       + t_mm[(WHISPER, "w2", te)])
                + n * (2 * t_mm[(WHISPER, "w1", WHISPER_T)]
                       + t_mm[(WHISPER, "w2", WHISPER_T)])}
        else:
            r["prefill_kernels_ms"] = {}
        print(f"[time] {name} ({r['layers']} layers) prefill: "
              f"{r['prefill_ms']:.3f} ms (median of 3); kernels: " +
              (", ".join(f"{k} {v:.3f} ms" for k, v in
                         r["prefill_kernels_ms"].items()) or "none") +
              f"; decode step batch {STEP_BATCH} {r['step_ms']:.3f} ms; "
              f"serve_lm TTFT {r['serve']['prefill_s']:.4f} s, decode_s "
              f"{r['serve']['decode_s']:.4f}, "
              f"{r['serve']['tokens_per_s']:.2f} tok/s")
    for name, b in batcher_main.items():
        st = b["stats"]
        print(f"[time] {name} ContinuousBatcher: {st['throughput_tok_s']:.2f}"
              f" tok/s, mean TTFT {st['mean_ttft_s']:.4f} s, mean latency "
              f"{st['mean_latency_s']:.4f} s ({b['steps']} steps, "
              f"{st['tokens']} tokens; every request submitted at the start)")
    # LM training: the kernels at the training shapes, their plain
    # backwards, the step's time and where it goes
    train_times = train_timings(train_main, lm_cfg.n_layers)

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

    # -- 7b. the placed tier on device slots, the dry run -----------------
    placed_main = placed_tier_run(types.SimpleNamespace(
        dev=dev, images=tier_images, logits=tier_logits["native"],
        per_fwd=per_fwd, per_fwd_v=per_fwd_v, count=count_launches,
        reset=ops.reset_launches))
    t0 = time.perf_counter()
    dry_rows = dryrun_lines(dev)
    print(f"[dryrun] {len(dry_rows)} cells in "
          f"{time.perf_counter() - t0:.1f} s")
    mesh_launches = dict(placed_main["launches"])
    for k, v in train_main["mesh_step"]["launches"].items():
        mesh_launches[k] = mesh_launches.get(k, 0) + v

    # -- 7c. the examples -------------------------------------------------
    def check_counted(what: str, want: dict, want_variants: dict) -> dict:
        """The counters since the last reset, checked by name and by
        variant; the nonzero ones."""
        launches_, variants_ = dict(ops.LAUNCHES), dict(ops.VARIANT_LAUNCHES)
        check_launches(launches_, want, what)
        check_variants(variants_, want_variants, what)
        return {k: v for k, v in launches_.items() if v}

    examples_main = examples_run(types.SimpleNamespace(
        dev=dev, params_dev=cnn.params_to(params_cpu, dev),
        check=check_counted, launch_checked=launch_checked,
        cache_n1=caches[("resnet50", 1)],
        measured_n1=plans_run[("resnet50", "measured n1")]["predicted"]))
    ex_max = examples_main["kernels"]["max_abs_err"]
    for k, v in ex_err.items():
        ex_max[k] = max(ex_max.get(k, 0.0), v)

    # -- 7d. the kernels' whole domains -----------------------------------
    cell32 = {q: {"graph_p50_ms": serving[("resnet50", q)]["graph_p50_ms"],
                  "graph_p99_ms": serving[("resnet50", q)]["graph_p99_ms"],
                  "continuous_images_per_s": pipe[("resnet50", q)][
                      "continuous"][(2, True)]["images_per_s"]}
              for q in ("native", "int8")}
    domain_main = domain_run(dev, cell32)

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
        "moe_vlm": moe_main, "state_lms": state_main, "train": train_main,
        "large_lm_kernels": {"flash": large_flash_rows,
                             "sparse_matmul": large_mm_rows},
        "state_lm_kernels": {"flash": state_flash_rows,
                             "sparse_matmul": state_mm_rows},
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
        "tier": tier_rows, "placed_tier": placed_main, "dryrun": dry_rows,
        "examples": examples_main, "domain": domain_main},
        indent=1, default=str))

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
         "state_lms": state_mm_rows,
         "train": {"rows": train_times["sparse_matmul"],
                   "plain_backward_ms": {
                       w: train_times["plain_backward_ms"][w]
                       for w in ("w1", "w2")},
                   "plain_backward": {
                       w: train_times["plain_backward_rows"][
                           f"sparse_matmul_{w}"] for w in ("w1", "w2")},
                   "launches_per_step": 6 * n_l,
                   "function_max_abs_err": {
                       k: v for k, v in train_main[
                           "function_max_abs_err"].items()
                       if k.startswith("sparse_matmul")}},
         "note": "ms, plain_ms, bound_ms, library_ms: the ResNet-50 "
                 "classifier (M=1 f32, gemv); smollm: per call at "
                 "SmolLM-360M's FFN shapes (M=4 gemv, M=2048 mma), library "
                 "torch.matmul on the densified bf16 weight; large_lms: "
                 "the same at the 128x128 FFN blocks of Qwen3-32B, "
                 "Mistral-Nemo-12B, Granite-20B and llava-next-mistral-7b "
                 "(M=4 gemv, M=2048 mma); state_lms: whisper-large-v3's "
                 "64x64 blocks (M=4 gemv, M=448 and 1500 mma) and "
                 "zamba2-7b's 128x128 (M=4, 2048); train: SmolLM-360M's "
                 "FFN at the training rows (M=16384, mma), the plain "
                 "backward beside them; "
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
         "state_lms": state_flash_rows,
         "train": {"rows": train_times["flash"],
                   "plain_backward_ms": train_times["plain_backward_ms"][
                       "flash_attention"],
                   "plain_backward": train_times["plain_backward_rows"][
                       "flash_attention"],
                   "launches_per_step": 2 * n_l,
                   "function_max_abs_err": train_main[
                       "function_max_abs_err"]["flash_attention"]},
         "note": f"ms, plain_ms, bound_ms, library_ms: one layer of a "
                 f"{LM} prefill (B=1, T={PREFILL_T}, H={n_h}, D={d_h}, "
                 f"bf16, causal; the mma variant); library: "
                 f"F.scaled_dot_product_attention on the same expanded "
                 f"tensors; large_lms: the same at a T={PREFILL_T} layer "
                 f"of Qwen3-32B, Mistral-Nemo-12B, Granite-20B, "
                 f"granite-moe-3b-a800m (D=64), moonshot-v1-16b-a3b and "
                 f"llava-next-mistral-7b, and at Qwen3-32B's last cache "
                 f"chunk (SDPA with a causal mask there); state_lms: "
                 f"zamba2-7b's D=112 T={PREFILL_T} prefill under its "
                 f"window and whisper-large-v3's encoder (non-causal "
                 f"1500x1500), decoder (causal 448) and cross (448x1500) "
                 f"shapes; train: SmolLM-360M's training attention "
                 f"(B={TRAIN_B}, T={TRAIN_T}), the plain backward beside "
                 f"it; variants: "
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
        # phase 7b and the mesh train step: the placed tier's warm-ups and
        # captures, the step on a stage mesh of slots
        entry["mesh"] = {"launches": mesh_launches.get(name, 0)}
        # phase 7c: the four examples' main paths; the new shapes' checks
        # and times (sparse_conv: the 47 convs at 64 px, batch 2, summed)
        ex_k = examples_main["kernels"]
        entry["examples"] = {
            "launches": examples_main["launches"].get(name, 0),
            "max_abs_err": ex_k["max_abs_err"].get(name),
            "times": {"sparse_conv": ex_k["sparse_conv"],
                      "sparse_matmul": ex_k["sparse_matmul"],
                      "flash_attention": ex_k["flash"]}.get(name)}
        # phase 7d: the shapes only the widened variants take (the domain
        # main path's launches: sparse ResNet-50 at 128 x 128 blocks)
        dom = domain_main["kernels"][name]
        entry["domain"] = {
            "launches": domain_main["launches"].get(name, 0),
            "variants": {v: domain_main["variant_launches"].get(
                f"{name}/{v}", 0) for v in _build.VARIANTS.get(name, ())},
            "max_abs_err": domain_main["kernels"]["max_abs_err"][name],
            "instances": DOMAIN_INSTANCES[name],
            **({"by_n": dom["by_n"]} if "by_n" in dom else
               {"rows": dom["rows"]})}
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
