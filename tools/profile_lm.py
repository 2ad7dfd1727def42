"""Where SmolLM-360M's time goes on one NVIDIA card: ``torch.profiler``
over one prefill (B 1, T 2048) and one decode step (batch 4), after a
warm-up of each: device time by kernel, its sum, and the device's idle
share of the profiled wall time. The same call unprofiled (median of 3)
is printed beside it, since the profiler adds host time of its own.

    python3 tools/profile_lm.py        # needs a card; writes build/profile_lm.json
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

TOP = 12


def _wall_ms(fn, n: int = 3) -> float:
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[n // 2]


def _device_us(event) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def profile_call(fn) -> dict:
    fn()
    torch.cuda.synchronize()
    wall_ms = _wall_ms(fn)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, _device_us(e) / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and _device_us(e) > 0]
    kernels.sort(key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels)
    return {"wall_ms": wall_ms, "profiled_wall_ms": prof_wall_ms,
            "device_ms": busy_ms,
            "idle_share": (1 - busy_ms / prof_wall_ms) if busy_ms else None,
            "kernels": [{"name": n, "ms": ms, "count": c}
                        for n, ms, c in kernels]}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_lm: CUDA is not available; this script runs on the "
              "card", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import lm

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    cfg = get_config("smollm-360m")
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator().manual_seed(11)
    toks = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen).to(dev)
    tok4 = torch.randint(0, cfg.vocab_size, (4, 1), generator=gen).to(dev)
    cache = lm.init_cache(cfg, 4, 128, device=dev)
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    out = {}
    for name, fn in (("prefill B=1 T=2048", lambda: prefill(params, toks)),
                     ("decode step B=4", lambda: decode(params, cache, tok4,
                                                        0))):
        r = profile_call(fn)
        out[name] = r
        idle = ("not measured (no device time in the trace)"
                if r["idle_share"] is None else f"{r['idle_share']:.3f}")
        print(f"[profile] {name}: wall {r['wall_ms']:.3f} ms (profiled "
              f"{r['profiled_wall_ms']:.3f} ms), device {r['device_ms']:.3f} "
              f"ms, idle share of the profiled wall {idle}")
        for k in r["kernels"][:TOP]:
            print(f"[profile]   {k['ms']:9.3f} ms  x{k['count']:<5d} "
                  f"{k['name'][:100]}")
    (ROOT / "build").mkdir(exist_ok=True)
    (ROOT / "build" / "profile_lm.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
