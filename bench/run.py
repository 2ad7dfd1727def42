"""The port's benchmark: one cell of ``BENCHMARK.json`` on this machine.

    python3 -m bench.run --workload resnet50.request --seed 7 --seconds 10 \\
        --trace 0

Run from the root of a checkout. Everything a cell is made of is found by
name: ``BENCHMARK.json``'s workload names its configuration
(``bench/configs/<config>.json``, whose ``model`` names the plain reference
``bench/reference/<model>.py``) and its traffic (``bench/traffic/
<traffic>.json``, whose ``kind`` names the driver ``bench/drivers/
<kind>.py``, which refuses a key it does not read); each per-layer
metric ``<quantity>.<suffix>`` has its reader in ``bench/metrics/
<quantity>.py`` and each hand-written kernel its work count in
``bench/work/``.

A run: weights and an image pool from ``--seed`` on the card, the program
built and warmed up (its kernels build once into the checkout's
``build/``), then ``--seconds`` of the traffic; with ``--trace 1`` a
bounded span of it under the profiler first, whose device readings the
per-layer metrics set against the window's times. Then the reference
checks every answer, and that there is one for every image sent. The last line of standard output is the result, with the
``--trace 0`` end-to-end metrics or the ``--trace 1`` per-layer ones; the
last lines of standard error are the compared numbers and their limits."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level modules that must not be loaded in a run: JAX and the JAX
#: package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def err(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclass
class Setup:
    """What a driver builds the program from."""
    config: dict
    traffic: dict
    device: str
    image_size: int
    quantize: str
    port_params: dict
    pool: object           # (P, H, W, 3) f32 images on the host
    rng: object            # numpy Generator from the seed


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def cell_metrics(manifest: dict, cell: str, kind: str) -> list:
    """The cell's declared end-to-end (``kind`` "end_to_end") or per-layer
    metrics: those that list it, or, without a list, every cell that
    reports the metric they move."""
    e2e = {m["name"]: m for m in manifest["end_to_end"]
           if cell in m.get("workloads", [cell])}
    out = []
    for m in manifest[kind]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def reader_path(name: str) -> Path:
    """``metrics/<quantity>.py`` reads every ``<quantity>.<suffix>``."""
    return BENCH / "metrics" / f"{name.split('.')[0]}.py"


def check_port_config(config: dict) -> None:
    """The program's registered model must be the configuration's: same
    pruning (or none)."""
    from repro_torch.configs import get_config
    sp, want = get_config(config["port_arch"]).sparsity, config["sparsity"]
    have = None if not sp.enabled else {
        "fraction": sp.sparsity, "block_m": sp.block_m, "block_n": sp.block_n}
    if (want is None) != (have is None) or (have is not None and any(
            have[k] != want[k] for k in have)):
        raise RuntimeError(f"the program's {config['port_arch']} prunes "
                           f"{have}, the configuration {want}")


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def per_layer(manifest, cell, driver, span_of, calls, window, model_ops,
              log):
    """Every declared per-layer metric from one bounded span; a metric
    whose source saw nothing gets the next span of the same run, and one
    still empty ends the run."""
    from bench.trace import Context, breakdown, reader
    wanted = cell_metrics(manifest, cell, "per_layer")
    for attempt in (1, 2):
        span = span_of()
        ctx = Context(span, calls, driver.launches, window, model_ops, log)
        got = {m["name"]: reader(reader_path(m["name"]))(ctx)
               for m in wanted}
        missing = [n for n, v in got.items() if v is None]
        log(f"[trace] span {attempt}: {span.units} {driver.unit}s, "
            f"{span.images} images, {len(span.events)} events, window "
            f"{span.window_s:.6f} s, busy {span.busy_s:.6f} s"
            + (f"; nothing read for {missing}" if missing else ""))
        if not missing:
            return {m["name"]: {"value": got[m["name"]], "unit": m["unit"]}
                    for m in wanted}, span, breakdown(span)
    raise SystemExit(f"bench: no reading for {missing} in two spans")


def build(manifest: dict, cell_name: str, seed: int, *, device: str = "cuda",
          image_size=None, traffic_overrides=None, quantize=None,
          fault=None) -> tuple:
    """The cell's program under test, built and warmed up from the seed:
    (config, traffic, reference module, layers, raw weights, image pool,
    driver)."""
    import numpy as np
    import torch

    from bench.weights import make_images, make_raw, to_port

    cell = next(w for w in manifest["workloads"] if w["name"] == cell_name)
    config = load_json(BENCH / "configs" / f"{cell['config']}.json")
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    drv = importlib.import_module(f"bench.drivers.{traffic['kind']}")
    unknown = sorted(set(traffic) - set(drv.KEYS) - {"kind", "about"})
    if unknown:
        raise ValueError(f"traffic {cell['traffic']!r} sets {unknown}, "
                         f"which the {traffic['kind']} driver does not read")
    traffic.update(traffic_overrides or {})
    model = importlib.import_module(f"bench.reference.{config['model']}")
    size = image_size or config["image_size"]
    check_port_config(config)
    layers = model.layers(config, size)
    gen = torch.Generator(device=device).manual_seed(seed)
    raw = make_raw(layers, config["sparsity"], gen)
    pool = make_images(int(traffic["pool_images"]), size, gen)
    setup = Setup(config, traffic, device, size, quantize or config["store"],
                  to_port(raw), pool, np.random.default_rng(seed))
    return (config, traffic, model, layers, raw, pool,
            drv.Driver(setup, fault=fault))


def run_cell(manifest: dict, cell_name: str, seed: int, seconds: float,
             trace: bool, *, device: str = "cuda", t_start=None,
             image_size=None, traffic_overrides=None, quantize=None,
             fault=None, log=err) -> dict:
    """Run one cell and return its result line (a dict). ``image_size``,
    ``traffic_overrides``, ``quantize`` (a store of the program's own, the
    control) and ``fault`` (wraps the program's entry) are for tests and
    the control; a cell's own run leaves them unset."""
    import torch

    from bench import checks
    from bench.reference import common

    t_start = time.perf_counter() if t_start is None else t_start
    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    config, traffic, model, layers, raw, pool, driver = build(
        manifest, cell_name, seed, device=device, image_size=image_size,
        traffic_overrides=traffic_overrides, quantize=quantize, fault=fault)
    size = pool.shape[1]
    sync()
    setup_s = time.perf_counter() - t_start
    log(f"[setup] {setup_s:.3f} s: {cell_name}, seed {seed}, "
        f"{size} px, store {driver.setup.quantize}; launches a "
        f"{driver.unit}: "
        + ", ".join(f"{k} {v}" for k, v in driver.launches.items() if v))

    metrics, dev_extra, brk = {}, {}, None
    traced = []           # every traced span: their answers are checked too

    def span_of():
        traced.append(driver.trace(sync))
        return traced[-1]

    # the traced span right after warm-up, then the window, whose counters
    # and times the readers and whose answers the check take; the harness
    # keeps every answer, so no collector pass walks them inside either
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        first = [span_of()] if trace else []
        res = driver.window(seconds)
    finally:
        gc.enable()
        gc.unfreeze()
    if trace:
        from bench.work.model import ops_per_image
        n = 1 if driver.unit == "request" else int(traffic["mb_size"])
        metrics, span, brk = per_layer(
            manifest, cell_name, driver,
            lambda: first.pop() if first else span_of(),
            model.kernel_calls(config, raw, n, size), res["window"],
            ops_per_image(layers, raw), log)
        dev_extra = {"busy_s": span.busy_s, "window_s": span.window_s}
    log(f"[window] {res['log']}")
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    keys, logits = driver.answers()
    driver.close()
    del driver
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    ref = common.logits_in_blocks(
        lambda p, x: model.forward(config, p, x),
        common.prepare(raw, device), pool, 16, device).numpy()
    due = res["window"]["images"] + sum(sp.images for sp in traced)
    correct, compared = checks.compare(keys, logits, ref, config["limits"],
                                       due, res["failed"])
    if not trace:
        wanted = cell_metrics(manifest, cell_name, "end_to_end")
        values = {**res["metrics"], "setup_s": setup_s}
        missing = [m["name"] for m in wanted if m["name"] not in values]
        if missing:
            raise SystemExit(f"bench: the driver gave no {missing}")
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in wanted}
    line = {"correct": bool(correct), "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics,
            "device": {"platform": "gpu" if on_card else "cpu",
                       "kind": torch.cuda.get_device_name() if on_card
                       else "cpu",
                       "count": 1, "memory_peak_bytes": int(peak),
                       **dev_extra}}
    if brk is not None:
        line["breakdown"] = brk
    line["checks"] = compared
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if args.workload not in cells:
        err(f"bench: no workload {args.workload!r}; have {sorted(cells)}")
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        err(f"bench: the program (src/repro_torch) is not in {ROOT}")
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    need = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        err(f"bench: this cell needs {need} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            " available")
        return 3
    err(f"[card] {power_limit()}")
    line = run_cell(manifest, args.workload, args.seed, args.seconds,
                    bool(args.trace), t_start=T_START)
    left = forbidden_modules()
    if left:
        err(f"bench: modules of JAX or the JAX package are loaded: {left}")
        return 4
    for name, c in line["checks"].items():
        err(f"[check] {name} {c['value']!r} limit {c['limit']!r}")
    err(f"[check] correct {line['correct']}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
