"""Readings that the limits of ``correct`` are set from (PERF.md): each
cell's compared numbers on sound runs over many seeds, and on its control,
the program's own int8 weight store (the precision below the configured
bf16), all at the cell's own size, in one process.

    python3 -m bench.control --workload resnet50.request --seeds 1-12 \\
        --control-seeds 101-103 --seconds 2 --out bench/out/control.json
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from bench import run


def seeds(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b) + 1)) if b else [int(a)]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seeds", default="1-12")
    ap.add_argument("--control-seeds", default="101-103")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(run.ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        run.err("bench.control: needs a CUDA device")
        return 3
    run.err(f"[card] {run.power_limit()}")
    manifest = run.load_json(run.ROOT / "BENCHMARK.json")
    rows = []
    for cell in args.workload:
        for side, ss, store in (("sound", args.seeds, None),
                                ("control", args.control_seeds, "int8")):
            for seed in seeds(ss):
                t = time.perf_counter()
                line = run.run_cell(manifest, cell, seed, args.seconds,
                                    False, quantize=store,
                                    log=lambda m: None)
                row = {"cell": cell, "side": side, "seed": seed,
                       "correct": line["correct"],
                       "attempted": line["attempted"],
                       **{k: v["value"] for k, v in line["checks"].items()},
                       "s": time.perf_counter() - t}
                rows.append(row)
                print(json.dumps(row), flush=True)
    for cell in args.workload:
        for side in ("sound", "control"):
            got = [r for r in rows if r["cell"] == cell and r["side"] == side]
            for k in ("worst_logit_err", "mean_logit_err", "systematic_err"):
                vals = [r[k] for r in got]
                print(f"[{cell} {side}] {k}: min {min(vals):.4e} max "
                      f"{max(vals):.4e} over {len(vals)} seeds", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
