"""Where a batch-1 CNN request's time goes on one NVIDIA card:
``torch.profiler`` over 20 requests of ``launch.serve.latency_request``
(224 px; each a CUDA graph replay between the image's H2D and the
logits' D2H, or eager where asked) for ResNet-50, MobileNet-V1 and
MobileNet-V2 at the native and int8 stores: device time by kernel a
request, its sum, and the device's idle share of the profiled wall time.
The same requests unprofiled (median) are printed beside it, since the
profiler adds host time of its own.

    python3 tools/profile_cnn.py [--eager]   # needs a card; writes build/profile_cnn.json
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from profile_lm import _device_us  # noqa: E402

REQUESTS = 20
TOP = 10
ARCHS = ("resnet50", "mobilenet_v1", "mobilenet_v2")


def profile_requests(request, img) -> dict:
    for _ in range(3):
        request(img)
    walls = []
    for _ in range(REQUESTS):
        t0 = time.perf_counter()
        request(img)
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(REQUESTS):
            request(img)
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / REQUESTS
    kernels = [(e.key, _device_us(e) / 1e3 / REQUESTS, e.count / REQUESTS)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and _device_us(e) > 0]
    kernels.sort(key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels)
    return {"wall_ms": sorted(walls)[REQUESTS // 2],
            "profiled_wall_ms": prof_wall_ms, "device_ms": busy_ms,
            "idle_share": (1 - busy_ms / prof_wall_ms) if busy_ms else None,
            "kernels": [{"name": n, "ms": ms, "count": c}
                        for n, ms, c in kernels]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--eager", action="store_true",
                    help="also profile the eager requests")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_cnn: CUDA is not available; this script runs on the "
              "card", file=sys.stderr)
        return 1
    from repro_torch.launch.serve import ServeConfig, latency_request

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    img = torch.randn((1, 224, 224, 3),
                      generator=torch.Generator().manual_seed(1))
    out = {}
    for arch in ARCHS:
        for q in ("native", "int8"):
            for capture in (True, False) if args.eager else (True,):
                cfg = ServeConfig(arch=arch, mode="latency", image_size=224,
                                  quantize=q, device="cuda", verbose=False)
                request, _ = latency_request(cfg, capture=capture)
                name = f"{arch} {q} {'graph' if capture else 'eager'}"
                r = profile_requests(request, img)
                out[name] = r
                idle = ("not measured (no device time in the trace)"
                        if r["idle_share"] is None
                        else f"{r['idle_share']:.3f}")
                print(f"[profile] {name}: wall {r['wall_ms']:.4f} ms a "
                      f"request (profiled {r['profiled_wall_ms']:.4f} ms), "
                      f"device {r['device_ms']:.4f} ms, idle share of the "
                      f"profiled wall {idle}")
                for k in r["kernels"][:TOP]:
                    print(f"[profile]   {k['ms'] * 1e3:9.2f} us  "
                          f"x{k['count']:<5.1f} {k['name'][:90]}")
    (ROOT / "build").mkdir(exist_ok=True)
    (ROOT / "build" / "profile_cnn.json").write_text(json.dumps(out,
                                                                indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
