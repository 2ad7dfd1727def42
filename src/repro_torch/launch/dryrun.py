"""The analytic dry run (counterpart of the reference's
``src/repro/launch/dryrun.py``): every (arch x shape x mesh) cell's
per-device bytes and roofline terms on the H100's numbers, without a
model in memory.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b \\
        --shape train_4k [--multi-pod] [--pipeline] [--out results.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out F]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch resnet50 \\
        --pipeline-cnn --device cpu

A cell (``run_cell``) lays the model's parameters, optimizer state and
inputs on the meta device (``launch/steps.py``: shapes and dtypes,
nothing allocated), places them on the reference's abstract production
mesh (16 x 16 ``(data, model)``, or 2 x 16 x 16 with ``pod``) by the
reference's sharding rules (``launch/shardings.py``) and sums each
leaf's bytes per device. The compute and memory terms are the
reference's analytic model (``core/costmodel.py``: FLOPs and HBM
traffic of the step) over the card's peak rates (``launch/mesh.py``).

What has no torch counterpart: the reference lowers and compiles each
cell with XLA and reads the compiled program (``_lower_cell``,
``probe_costs``, ``collective_bytes`` / ``_op_output_bytes`` over the
HLO text, ``memory_analysis``). The port compiles no program, so a cell
has no collective bytes (``"collectives": null``, with the reason), no
measured memory and no HLO FLOPs; ``dominant`` is chosen over the
compute and memory terms alone. Nothing stands in for them.

``run_cnn_pipeline_cell`` plans the heterogeneous CNN pipeline, builds
its placed stage programs on a stage mesh of device slots and reports
the bytes a slot holds, placed against replicated.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import torch

from repro_torch.configs import SHAPES, all_configs, applicable, get_config
from repro_torch.core import costmodel as cm
from repro_torch.core import pytree
from repro_torch.core.device import resolve_device
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import shardings as sh
from repro_torch.launch import steps as steplib

#: why a cell has no collective bytes
NO_COLLECTIVES = ("the reference reads them from XLA's compiled HLO; the "
                  "port compiles no program for a cell")


def roofline(cost: dict, coll, n_chips: int, *, model_flops: float) -> dict:
    """The roofline terms (seconds) of one step per device: ``cost``'s
    "flops" over the bf16 peak, its "bytes accessed" over the HBM rate
    and, where ``coll`` gives them (``{"total_bytes": ...}``), the
    collective bytes over one NVLink direction; ``coll`` None leaves the
    collective term None and out of ``dominant``. The global figures are
    per-device x ``n_chips``."""
    flops = float(cost.get("flops", 0.0))              # per device
    nbytes = float(cost.get("bytes accessed", 0.0))    # per device
    t_compute = flops / meshlib.PEAK_FLOPS_BF16
    t_memory = nbytes / meshlib.HBM_BW
    terms = [("compute", t_compute), ("memory", t_memory)]
    t_coll = coll_bytes = None
    if coll is not None:
        coll_bytes = coll["total_bytes"]
        t_coll = coll_bytes / meshlib.NVLINK_BW
        terms.append(("collective", t_coll))
    dom = max(terms, key=lambda kv: kv[1])
    denom = max(max(t for _, t in terms), 1e-30)
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dom[0],
        "bound_s": dom[1],
        "flops_per_dev": flops,
        "bytes_per_dev": nbytes,
        "collective_bytes_per_dev": coll_bytes,
        "flops_global": flops * n_chips,
        "model_flops": model_flops,
        "useful_flops_frac": (model_flops / (flops * n_chips)
                              if flops else 0.0),
        "roofline_frac": t_compute / denom,
        # model FLOPs against what the fleet could do in the bound time:
        # the MFU the terms allow at most
        "mfu_bound": model_flops / (n_chips * meshlib.PEAK_FLOPS_BF16
                                    * max(dom[1], 1e-30)),
    }


def model_flops_for(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6ND train / 2ND per generated token."""
    n = cfg.n_active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * shape.global_batch          # decode: one token


def bytes_per_device(tree, specs: dict, mesh) -> int:
    """Bytes one slot of ``mesh`` holds of ``tree`` placed by ``specs``:
    each leaf's bytes over the slots its spec splits it across."""
    total = 0
    for key, leaf in pytree.keyed_leaves(tree):
        split = 1
        for entry in specs[key]:
            for axis in meshlib._axes(entry):
                split *= mesh.shape[axis]
        total += leaf.numel() * leaf.element_size() // split
    return total


def _staged_specs(cfg, shape, mesh, params, pure_dp):
    """The pipelined train step's params (stage axis ``pod``): the blocks
    restructured to (S, Lmax, ...) stages on the meta device, each staged
    leaf's first dimension on ``pod``, the rest by ``param_spec``."""
    _, restructure, _ = steplib.make_pipeline_train_step(
        cfg, None, shape, n_stages=mesh.shape["pod"])
    sparams, _ = restructure(params)
    specs = {}
    for key, leaf in pytree.keyed_leaves(sparams):
        names = sh._path_names(key)
        if names and names[0] == "staged":
            base = sh.param_spec(names[1:], leaf, mesh, pure_dp=pure_dp)
            base += (None,) * (leaf.dim() - len(base))
            specs[key] = ("pod",) + tuple(base[1:])
        else:
            specs[key] = sh.param_spec(key, leaf, mesh, pure_dp=pure_dp)
    return sparams, specs


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             pipeline: bool = False, verbose: bool = True) -> dict:
    """One (arch, shape, mesh) cell, analytic: per-device bytes of the
    params, the optimizer state (train) and the inputs from their meta
    trees and specs; the cost model's HBM estimate against the card's
    memory (``hbm_ok``); the roofline terms of the cost model's FLOPs
    and bytes. ``pipeline`` (train, multi-pod): the blocks staged over
    ``pod`` (``make_pipeline_train_step``'s cut), the batch on data
    alone."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if not applicable(cfg, shape):
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": "inapplicable (see DESIGN.md)"}
    mesh = meshlib.make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.size
    t0 = time.perf_counter()
    pure_dp = sh.use_pure_dp(cfg)
    params, pspecs = steplib.abstract_params(cfg, mesh, pure_dp=pure_dp)
    staged = pipeline and shape.kind == "train" and "pod" in mesh.shape
    if staged:
        params, pspecs = _staged_specs(cfg, shape, mesh, params, pure_dp)
    inputs, ispecs = steplib.input_specs(cfg, shape, mesh,
                                         pod_is_dp=not pipeline,
                                         pure_dp=pure_dp)
    per_dev = {"params": bytes_per_device(params, pspecs, mesh),
               "inputs": bytes_per_device(inputs, ispecs, mesh)}
    if shape.kind == "train":
        opt, ospecs = steplib.abstract_opt_state(params, pspecs, mesh)
        per_dev["opt_state"] = bytes_per_device(opt, ospecs, mesh)
    n_model = mesh.shape.get("model", 1)
    flops_per_dev = cm.step_flops_global(cfg, shape) / n_chips
    bytes_per_dev = cm.step_bytes_per_device(
        cfg, shape, n_chips=n_chips, n_model_shards=n_model,
        pure_dp=pure_dp)
    rf = roofline({"flops": flops_per_dev, "bytes accessed": bytes_per_dev},
                  None, n_chips, model_flops=model_flops_for(cfg, shape))
    hbm_est = cm.hbm_estimate_per_device(cfg, shape, n_chips=n_chips,
                                         n_model_shards=n_model,
                                         pure_dp=pure_dp)
    res = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "pipeline": pipeline,
        "status": "ok",
        "analysis_s": round(time.perf_counter() - t0, 3),
        "n_chips": int(n_chips),
        "pure_dp": pure_dp,
        "per_device_bytes": {k: int(v) for k, v in per_dev.items()},
        "hbm_est_per_device": int(hbm_est),
        "chip_hbm_bytes": meshlib.chip_hbm(),
        "hbm_ok": bool(hbm_est < meshlib.chip_hbm()),
        "collectives": None,
        "collectives_reason": NO_COLLECTIVES,
        "roofline": rf,
    }
    if verbose:
        print(json.dumps(res, default=float))
    return res


def run_cnn_pipeline_cell(arch: str, *, n_stages: int = 4,
                          n_microbatches: int = 8, batch: int = 16,
                          image_size: int = 64, placed: bool = True,
                          param_budget_frac=None, n_replicas: int = 1,
                          quantize: str = "native", device="cuda",
                          verbose: bool = True, tuning_cache=None,
                          calibrate: bool = False) -> dict:
    """The heterogeneous CNN layer pipeline as a cell: the plan
    (``planner.plan``, with ``param_budget_frac`` of the model's bytes
    as a bound on any stage), the placed stage programs on a stage mesh
    of ``n_stages * n_replicas`` slots on ``device``
    (``shardings.placed_stage_setup``), the even buffer placed row k on
    the slots of stage k, and the parameter bytes a slot holds, placed
    against replicated. ``placed=False`` reports what the replicated
    executor holds and what placement would hold.

    Profile-guided cuts, as in the reference: ``tuning_cache`` (a path or
    a ``core.tuning.TuningCache``) plans with ``model="measured"`` from
    the cache's node times on ``device``; ``calibrate`` first times every
    fused node there at ``(1, image_size, image_size, 3)`` and writes the
    cache back to a path. A missing or cold cache gives the analytic plan
    bit for bit. The cache is installed while the cell plans (the
    analytic cell installs none) and the previous one restored after."""
    from repro_torch.core import pipeline as pp
    from repro_torch.core import planner, tuning
    from repro_torch.core.quant import pytree_param_bytes
    from repro_torch.launch.serve import _init_native
    cfg = get_config(arch)
    if cfg.family != "cnn":
        return {"arch": arch, "shape": "pipeline_cnn", "status": "skipped",
                "reason": "not a CNN arch"}
    if batch % (n_microbatches * n_replicas) != 0:
        raise ValueError(
            f"batch {batch} must be divisible by n_replicas "
            f"{n_replicas} * n_microbatches {n_microbatches} for the "
            "dry-run cell (serve pads instead)")
    t0 = time.perf_counter()
    params = _init_native(cfg, 0)
    total_bytes = pytree_param_bytes(params, quantize)
    budget = (int(param_budget_frac * total_bytes)
              if param_budget_frac else None)
    dev = resolve_device(device)
    cache = tuning.resolve_cache(cfg, params, tuning_cache, calibrate,
                                 image_size=image_size, device=dev,
                                 verbose=verbose)
    model = "analytic" if cache is None else "measured"
    with tuning.set_tuning_cache(cache), tuning.device_scope(dev):
        plan = planner.plan(cfg, params, planner.PlanRequest(
            n_stages=n_stages, max_stage_param_bytes=budget,
            store_dtype=quantize, model=model, tuning_cache=cache))
    s, r = plan["n_stages"], n_replicas
    mb_shape = (batch // (n_microbatches * r), image_size, image_size, 3)
    slots = meshlib.device_slots(s * r, dev)
    stage_fns, pack_in, unpack_out, width, pparams, mesh, sps = \
        sh.placed_stage_setup(cfg, params, plan, mb_shape, n_replicas=r,
                              devices=slots, quantize=quantize,
                              align=pp.ALIGN)
    if placed:
        buf = meshlib.place(pparams.pack(), mesh, sps["buffer"])
        placed_bytes = buf.nbytes_per_slot
    else:
        placed_bytes = int(plan["placed_bytes_per_device"])
    res = {
        "arch": arch, "shape": "pipeline_cnn", "status": "ok",
        "mesh": (f"{r}x{s}(data,stage)" if r > 1 else f"{s}x1(stage)"),
        "device": str(slots[0].device),
        "pipeline": True,
        "setup_s": round(time.perf_counter() - t0, 3),
        "n_stages": int(s),
        "n_replicas": int(r),
        "n_microbatches": int(n_microbatches),
        "image_size": int(image_size),
        "wire_width": int(width),
        "stage_cost_cycles": [float(c) for c in plan["stage_cost"]],
        "imbalance": plan["imbalance"],
        "bubble_fraction": pp.bubble_fraction(n_microbatches, s),
        "collectives": None,
        "collectives_reason": NO_COLLECTIVES,
        "params_placed": bool(placed),
        "param_budget_bytes": budget,
        "stage_param_bytes": [int(b) for b in sps["stage_param_bytes"]],
        "param_bytes_replicated_per_device": int(total_bytes),
        "param_bytes_placed_per_device": int(placed_bytes),
        "param_placement_ratio": placed_bytes / max(total_bytes, 1),
    }
    if verbose:
        print(json.dumps(res, default=float))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--pipeline", action="store_true")
    ap.add_argument("--pipeline-cnn", action="store_true",
                    help="CNN layer-pipeline cell (family=cnn archs)")
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--image-size", type=int, default=64)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--replicated-params", action="store_true",
                    help="pipeline-cnn: report replicated params instead "
                         "of per-stage placement")
    ap.add_argument("--param-budget-frac", type=float, default=None)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="pipeline-cnn: the device of the stage slots")
    ap.add_argument("--tuning-cache", type=str, default=None,
                    metavar="PATH",
                    help="pipeline-cnn: plan stages from this profiled "
                         "tuning cache (model='measured'; missing file "
                         "= cold cache = analytic plan)")
    ap.add_argument("--calibrate", action="store_true",
                    help="pipeline-cnn: profile every fused node on the "
                         "device and write --tuning-cache first")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    results = []
    if args.all:
        for arch, cfg in sorted(all_configs().items()):
            if cfg.family == "cnn":
                continue
            for sname in SHAPES:
                for mp in (False, True):
                    try:
                        r = run_cell(arch, sname, multi_pod=mp)
                    except Exception as e:   # noqa: BLE001 — report, go on
                        r = {"arch": arch, "shape": sname,
                             "mesh": "2x16x16" if mp else "16x16",
                             "status": "error", "error": f"{e}"[:500]}
                        traceback.print_exc()
                        print(json.dumps(r))
                    results.append(r)
    elif args.pipeline_cnn or (args.arch and
                               get_config(args.arch).family == "cnn"):
        if not args.arch:
            ap.error("--pipeline-cnn requires --arch (resnet50, "
                     "mobilenet_v1 or mobilenet_v2)")
        results.append(run_cnn_pipeline_cell(
            args.arch, n_stages=args.stages,
            n_microbatches=args.microbatches, batch=args.batch,
            image_size=args.image_size,
            placed=not args.replicated_params,
            param_budget_frac=args.param_budget_frac,
            n_replicas=args.replicas, device=args.device,
            tuning_cache=args.tuning_cache, calibrate=args.calibrate))
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        results.append(run_cell(args.arch, args.shape,
                                multi_pod=args.multi_pod,
                                pipeline=args.pipeline))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=float)
    return 1 if any(r.get("status") == "error" for r in results) else 0


if __name__ == "__main__":
    torch.set_grad_enabled(False)
    sys.exit(main())
