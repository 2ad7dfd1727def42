"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits nonzero:

1. device: require CUDA; print the card's name and power limit;
2. build: compile every CUDA kernel from ``src/repro_torch/kernels/csrc``
   with nvcc for sm_90a;
3. kernel checks: each kernel against its plain PyTorch version on the
   card, at every distinct shape the ResNet-50 main path gives it;
4. main path: ``serve(ServeConfig(arch="resnet50", mode="latency",
   image_size=224))`` with the launch counters reset just before and read
   just after; the card's logits are held against the port's plain CPU
   forward on the same weights and images;
5. timings (CUDA events over CUDA-graph replays, L2-warm): each kernel at
   the main-path shapes beside its plain version, a library call that
   computes the same function (never called by the port) and its bound;
6. one ``{"kernels": [...]}`` line, then the device line last.

Per-layer numbers are also written to ``build/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

# published peaks of one H100 SXM (dense): memory rate, bf16 tensor-core
# and f32 CUDA-core rates
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

IMAGE_SIZE = 224
N_REQUESTS = 50
SEED = 0
# the port's logits vs its plain CPU forward: the two sum in f32 in other
# orders and may round a bf16 activation the other way, which the next
# layers carry on; at random init max |logit| is ~1e-3 of an activation,
# so the bar is relative to max |logit|
LOGIT_RTOL = 1e-3


def bf16_tol(ref: torch.Tensor) -> torch.Tensor:
    """1 bf16 ulp: rtol 2**-7 plus an atol of the bf16 spacing at the
    output's scale (sums taken in another order may round either way)."""
    scale = float(ref.abs().max())
    atol = 2.0 ** (math.floor(math.log2(scale)) - 7) if scale > 0 else 0.0
    return 2.0 ** -7 * ref.abs() + atol


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


def main() -> int:
    # -- 1. device --------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "card", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.core.fusion import conv_part, fused_graph_for
    from repro_torch.core.sparsity import densify
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import sparse_conv as sc
    from repro_torch.kernels import sparse_matmul as sm
    from repro_torch.launch.serve import ServeConfig, serve
    from repro_torch.models import cnn
    from repro_torch.models.layers import SparseWeight

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
    print(f"[build] {len(_build.SOURCES)} kernels in {build_s:.1f}s")
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

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
        x = randn((1, node.in_hw, node.in_hw, node.cin))
        b = randn((node.cout,)) * 0.1
        res = randn((1, ho, ho, node.cout))
        for r, relu in ((None, node.relu), (res, True)):
            got = sc.sparse_conv(x, sw.vals, sw.idx, b, r, k=node.k,
                                 stride=node.stride, relu=relu)
            want = sc.sparse_conv_torch(x, sw.vals, sw.idx, b, r, k=node.k,
                                        stride=node.stride, relu=relu)
            torch.cuda.synchronize()
            conv_err = max(conv_err, compare(
                got, want, bf16_tol, f"sparse_conv {key} res={r is not None}"))
    print(f"[check] sparse_conv: {len(seen)} shapes (k, stride, C, Cout, K, "
          f"H) x residual on/off, max |err| {conv_err:.3e} within 1 bf16 ulp")

    fc_w = params_cpu["fc"]["w"].to(dev)
    mm_cases = [("fc M=1 f32", randn((1, 2048), torch.float32), fc_w,
                 f32_tol)]
    w_bf = SparseWeight(randn((16, 4, 32, 32)),
                        torch.stack([torch.randperm(32, generator=gen,
                                                    device=dev)[:4].sort()
                                     .values for _ in range(16)])
                        .to(torch.int32).contiguous(), 1024)
    mm_cases.append(("M=64 bf16", randn((64, 1024)), w_bf, bf16_tol))
    mm_err = 0.0
    for what, x, sw, tol in mm_cases:
        got = sm.sparse_matmul(x, sw.vals, sw.idx)
        want = sm.sparse_matmul_torch(x, sw.vals, sw.idx)
        torch.cuda.synchronize()
        mm_err = max(mm_err, compare(got, want, tol, f"sparse_matmul {what}"))
    print(f"[check] sparse_matmul: {[c[0] for c in mm_cases]}, max |err| "
          f"{mm_err:.3e} within tolerance")

    # -- 4. the main path -------------------------------------------------
    ops.reset_launches()
    out = serve(ServeConfig(arch="resnet50", mode="latency",
                            image_size=IMAGE_SIZE, n_requests=N_REQUESTS,
                            seed=SEED, device="cuda"))
    launches = dict(ops.LAUNCHES)
    n_runs = N_REQUESTS + 1                       # + the warm-up request
    want_launches = {"sparse_conv": 47 * n_runs, "sparse_matmul": n_runs}
    if launches != want_launches:
        raise AssertionError(f"launches {launches} != {want_launches} "
                             f"({n_runs} requests incl. warm-up)")
    logits = torch.from_numpy(out["logits"])
    if logits.shape != (N_REQUESTS, 1000) or not torch.isfinite(logits).all():
        raise AssertionError(f"logits {tuple(logits.shape)} not finite "
                             f"(N_REQUESTS, 1000)")
    logit_err = 0.0
    for i in range(2):
        ref = cnn.cnn_forward(cfg, params_cpu,
                              torch.from_numpy(out["request_images"][i:i + 1]),
                              device="cpu")[0]
        scale = float(ref.abs().max())
        err = float((logits[i] - ref).abs().max())
        if err > LOGIT_RTOL * scale or int(logits[i].argmax()) != int(
                ref.argmax()):
            raise AssertionError(
                f"request {i}: card vs CPU logits max |err| {err:.3e} > "
                f"{LOGIT_RTOL} * {scale:.3e}, or top-1 differs")
        logit_err = max(logit_err, err / scale)
    p50_ms = out["latency_p50_s"] * 1e3
    p99_ms = out["latency_p99_s"] * 1e3
    print(f"[main] {N_REQUESTS} requests at {IMAGE_SIZE}px: p50 {p50_ms:.4f}"
          f" ms, p99 {p99_ms:.4f} ms; launches {launches}; logits vs CPU "
          f"max |err| / max |logit| {logit_err:.3e} (bar {LOGIT_RTOL}), "
          f"top-1 equal")

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
        rows.append({"layer": node.name, "k": node.k, "stride": node.stride,
                     "C": node.cin, "Cout": node.cout, "K": n_k,
                     "H": node.in_hw, "residual": r is not None, "ms": ms,
                     "plain_ms": plain, "library_ms": lib, "bound_ms": bms,
                     "bound_by": by, "bytes": nbytes, "ops": nops,
                     "input_read": x_elems / x.numel()})
        for key, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                       ("bound_ms", bms), ("bytes_ms", t_b), ("ops_ms", t_o)):
            sums[key] += v
        print(f"[time] {node.name:9s} k{node.k} s{node.stride} C{node.cin:5d}"
              f" Cout{node.cout:5d} K{n_k:3d} H{node.in_hw:4d} "
              f"res={int(r is not None)}: kernel {ms * 1e3:9.3f} us, plain "
              f"{plain * 1e3:9.3f} us, F.conv2d {lib * 1e3:9.3f} us, bound "
              f"{bms * 1e3:7.3f} us ({by})")

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
    print(f"[time] fc        M=1 f32 vals {tuple(fc_w.vals.shape)}: kernel "
          f"{fc_ms * 1e3:.3f} us, plain {fc_plain * 1e3:.3f} us, torch.matmul"
          f" (dense f32) {fc_lib * 1e3:.3f} us, bound {fc_bound * 1e3:.3f} us"
          f" ({fc_by})")
    per_req = sums["ms"] + fc_ms
    print(f"[time] per request: kernels {per_req:.4f} ms (sparse_conv x47 "
          f"{sums['ms']:.4f} + sparse_matmul {fc_ms:.4f}) vs request p50 "
          f"{p50_ms:.4f} ms: the rest is the dense convs, pools, launch "
          f"overhead, host time and H2D/D2H")

    (ROOT / "build").mkdir(exist_ok=True)
    (ROOT / "build" / "chip_smoke.json").write_text(json.dumps({
        "device": smi, "build_s": build_s, "p50_ms": p50_ms,
        "p99_ms": p99_ms, "latencies_s": out["request_latencies_s"],
        "launches": launches, "conv_layers": rows,
        "fc": {"ms": fc_ms, "plain_ms": fc_plain, "library_ms": fc_lib,
               "bound_ms": fc_bound, "bound_by": fc_by}}, indent=1))

    # -- 6. the kernels line, then the device line ------------------------
    kernels = [
        {"name": "sparse_conv", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sparse_conv.cu",
         "replaces": "src/repro/kernels/sparse_conv.py:203",
         "launches": launches["sparse_conv"],
         "launches_per_request": 47,
         "max_abs_err": conv_err, "max_err": conv_err, "ok": True,
         "ms": sums["ms"], "plain_ms": sums["plain_ms"],
         "bound_ms": sums["bound_ms"],
         "bound_by": bound_by(sums["bytes_ms"], sums["ops_ms"]),
         "library_ms": sums["library_ms"],
         "note": "ms, plain_ms, bound_ms, library_ms: sums over the 47 "
                 "main-path layers of one request"},
        {"name": "sparse_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sparse_matmul.cu",
         "replaces": "src/repro/kernels/sparse_matmul.py:68",
         "launches": launches["sparse_matmul"],
         "launches_per_request": 1,
         "max_abs_err": mm_err, "max_err": mm_err, "ok": True,
         "ms": fc_ms, "plain_ms": fc_plain, "bound_ms": fc_bound,
         "bound_by": fc_by, "library_ms": fc_lib},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"[chip_smoke] {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    sys.exit(rc)
