"""Phase 7d of ``chip_smoke.py`` alone on one card, in ~2 minutes of
command (about 40 s of it the kernels' build): sparse ResNet-50 with
SparsityConfig's default 128 x 128 blocks at 224 px through the batch-1
CUDA graph, the eager requests and the continuous server, native and
int8 (``chip_smoke.domain_run``), then every kernel at the shapes only
its widened variants take (``chip_smoke.domain_kernels``). The checks
are ``chip_smoke.py``'s own: launches by name and variant, the logits and
every node against the CPU, each new shape against its plain version.
The 32 x 32 cell is not run here, so nothing is printed beside it.

Fails on the first check that fails; prints the card's name and power
limit and each source's build time first.

    python3 tools/domain_phase.py
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("domain_phase: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    t0 = time.perf_counter()
    build_s = _build.build_all()
    print(f"[build] {build_s:.1f} s: "
          f"{ {n: round(t, 1) for n, t in _build.BUILD_SECONDS.items()} }")
    res = cs.domain_run(torch.device("cuda", 0))
    print(f"[domain] variants {res['variant_launches']}; "
          f"{time.perf_counter() - t0:.1f} s with the build")
    return 0


if __name__ == "__main__":
    sys.exit(main())
