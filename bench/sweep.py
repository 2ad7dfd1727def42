"""The rate a request cell's program sustains, found once when the cell
is defined: the cell's traffic at each offered rate for a few seconds,
the latency p50 / p95 and how far the last request started behind its
due time. A fixed rate at about four fifths of the highest one that
keeps the queue from growing is the cell's rate.

    python3 -m bench.sweep --workload resnet50.request \\
        --rates 1000,1200,1400,1600 --seconds 3
"""
from __future__ import annotations

import argparse
import sys

from bench import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(run.ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        run.err("bench.sweep: needs a CUDA device")
        return 3
    run.err(f"[card] {run.power_limit()}")
    manifest = run.load_json(run.ROOT / "BENCHMARK.json")
    for rate in (float(r) for r in args.rates.split(",")):
        logs = []
        line = run.run_cell(manifest, args.workload, args.seed, args.seconds,
                            False, traffic_overrides={"rate_per_s": rate},
                            log=logs.append)
        m = line["metrics"]
        print(f"[sweep] {args.workload} {rate:g}/s: p50 "
              f"{m['request_ms_p50']['value']:.4f} ms, p95 "
              f"{m['request_ms_p95']['value']:.4f} ms, correct "
              f"{line['correct']}; {logs[-1]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
