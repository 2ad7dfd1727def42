"""The continuous server on packed per-stage rows against the same server
on closures, on one card: where a difference in images/s comes from.

For each CNN (native, 224 px, mb 2, S 4) it builds two
``CNNPipelineServer``s on the same weights (``closures=False``, the
default, and ``closures=True``; in the order given by ``--closures-first``)
and then, in ``--pairs`` pairs alternating which form runs first:

- serves the same 16 requests of 8 images through each (host clock
  around ``run()``: images/s);
- replays each server's captured tick ``--replays`` times back to back
  on its own stream between CUDA events (the device time of a tick,
  without the host loop or the copies).

Prints one ``[rates]`` line per CNN and writes ``build/placed_rates.json``.

    python3 tools/placed_rates.py [--pairs 10] [--replays 200]
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def tick_ms(srv, replays: int) -> float:
    """Mean device time of one captured tick, replayed back to back."""
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    srv._quiesce()
    with torch.cuda.stream(srv._stream):
        srv._step(0)
        start.record()
        for i in range(replays):
            srv._step(i % 2)
        end.record()
    end.synchronize()
    srv.respawn()
    return start.elapsed_time(end) / replays


def serve_rate(srv, reqs) -> float:
    ids = [srv.submit(x) for x in reqs]
    m = srv.run()
    for i in ids:
        srv.results(i)
    return m["images_per_s"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--replays", type=int, default=200)
    ap.add_argument("--closures-first", action="store_true",
                    help="build the closure server before the rows one")
    ap.add_argument("--arch", nargs="*",
                    default=["resnet50", "mobilenet_v1", "mobilenet_v2"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("placed_rates: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import CNNPipelineServer, _init_native
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    out = {"device": smi, "closures_first": args.closures_first}
    for arch in args.arch:
        params = _init_native(get_config(arch), 0)
        forms = ["closures", "rows"] if args.closures_first \
            else ["rows", "closures"]
        srvs = {f: CNNPipelineServer(arch, mb_size=2, n_stages=4,
                                     image_size=224, params=params,
                                     closures=f == "closures")
                for f in forms}
        reqs = [np.random.default_rng(100 + i).normal(
            size=(8, 224, 224, 3)).astype(np.float32) for i in range(16)]
        for srv in srvs.values():               # one warm serving each
            serve_rate(srv, reqs)
        rate = {"rows": [], "closures": []}
        dev_ms = {"rows": [], "closures": []}
        for k in range(args.pairs):
            order = ("rows", "closures") if k % 2 == 0 \
                else ("closures", "rows")
            for f in order:
                rate[f].append(serve_rate(srvs[f], reqs))
                dev_ms[f].append(tick_ms(srvs[f], args.replays))
        wins = sum(a > b for a, b in zip(rate["rows"], rate["closures"]))
        row = {"images_per_s": rate, "tick_ms": dev_ms,
               "rows_faster_pairs": wins,
               "median_images_per_s": {f: statistics.median(v)
                                       for f, v in rate.items()},
               "median_tick_ms": {f: statistics.median(v)
                                  for f, v in dev_ms.items()}}
        out[arch] = row
        mi, mt = row["median_images_per_s"], row["median_tick_ms"]
        print(f"[rates] {arch} mb 2, S 4, {args.pairs} pairs (built "
              f"{forms[0]} first): images/s rows {mi['rows']:.1f}, "
              f"closures {mi['closures']:.1f} (rows / closures "
              f"{mi['rows'] / mi['closures']:.4f}; rows faster in {wins} "
              f"of {args.pairs} pairs; rows "
              f"{[round(v, 1) for v in rate['rows']]}, closures "
              f"{[round(v, 1) for v in rate['closures']]}); a captured "
              f"tick {mt['rows']:.4f} vs {mt['closures']:.4f} ms (rows / "
              f"closures {mt['rows'] / mt['closures']:.4f})")
        del srvs
    (ROOT / "build").mkdir(exist_ok=True)
    (ROOT / "build" / "placed_rates.json").write_text(json.dumps(out,
                                                                 indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
