"""The mesh pieces of ``chip_smoke.py`` alone on one card, in ~2 minutes
of command (about 40 s of it the kernels' build):

- the stage-pipelined SmolLM-360M step (full width, S 4, M 4, T 1024,
  batch 4) without a mesh and on a stage mesh of 4 slots of the card:
  the loss and every gradient bit for bit, the launches of each;
- the plain backwards at the training shapes (flash (4, 4096, 15, 64)
  causal, ``sparse_matmul`` w1 and w2 at M 16384), timed beside their
  bounds and library calls (``chip_smoke.backward_bounds``);
- the placed tier (``chip_smoke.placed_tier_run``: ResNet-50 at 224 px,
  S 4 x R 2 on 8 slots, the 8 -> 4 and 8 -> 3 losses) against a fresh
  unplaced tier's stream of 16 requests of 8 images (numpy, seeds
  0-15), its launches checked by name and variant;
- the analytic dry run of every cell (``chip_smoke.dryrun_lines``).

Fails on the first check that fails; prints the card's name and power
limit first.

    python3 tools/mesh_phase.py
"""
from __future__ import annotations

import gc
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("mesh_phase: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import pytree
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import sparse_matmul as sm
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import device_slots, make_stage_mesh
    from repro_torch.models import lm
    from repro_torch.models.layers import SparseWeight
    from repro_torch.runtime import tier as rt_tier
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    dev = torch.device("cuda", 0)
    print(f"[build] {_build.build_all():.1f} s")

    # the pipelined step without a mesh and on 4 slots of the card
    t0 = time.perf_counter()
    cfg = get_config(cs.LM)
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(cs.SEED))
    pt = cs.PIPE_TRAIN
    shape = ShapeConfig("train_1k", "train", pt["seq"], pt["batch"])
    rng = np.random.default_rng(cs.SEED)
    batch = {k: torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (pt["batch"], pt["seq"]))).to(dev)
        for k in ("tokens", "labels")}
    mesh = make_stage_mesh(pt["stages"], stage_axis="pod",
                           devices=device_slots(pt["stages"], dev))
    got = {}
    for name, m, kw in (("mesh-less", None, {"n_stages": pt["stages"]}),
                        ("mesh", mesh, {})):
        ts, restructure, _ = steps.make_pipeline_train_step(
            cfg, m, shape, n_microbatches=pt["microbatches"], **kw)
        sp, mask = restructure(params)
        ops.reset_launches()
        (loss, _), grads = ts.value_and_grad(sp, mask, batch)
        torch.cuda.synchronize()
        got[name] = (float(loss), dict(pytree.keyed_leaves(grads)))
        print(f"[mesh] {name} step: loss {float(loss):.6f}, launches "
              f"{ {k: v for k, v in ops.LAUNCHES.items() if v} }")
    (la, ga), (lb, gb) = got["mesh-less"], got["mesh"]
    if la != lb or any((g is None) != (gb[k] is None) or (
            g is not None and not torch.equal(g, gb[k]))
            for k, g in ga.items()):
        raise AssertionError("the mesh step differs from the mesh-less one")
    del got, ga, gb, sp
    print(f"[mesh] the step on 4 slots bit for bit the mesh-less step "
          f"({time.perf_counter() - t0:.1f} s)")

    # the plain backwards at the training shapes
    gen = torch.Generator(dev).manual_seed(1)
    m = cs.TRAIN_B * cs.TRAIN_T
    inputs, bwd = {"mm": {}}, {}
    for w in ("w1", "w2"):
        full = params["blocks"]["ffn"][w]
        sw = SparseWeight(full.vals[0].contiguous(),
                          full.idx[0].contiguous(), full.d_in)
        x = (torch.randn((m, sw.d_in), generator=gen, device=dev) / 4).to(
            torch.bfloat16)
        dy = torch.randn((m, sw.d_out), generator=gen, device=dev).to(
            torch.bfloat16)
        inputs["mm"][(cs.LM, w, m)] = (x, sw)
        inputs[f"dy_{w}"] = dy
        bwd[w] = cs.time_ms(lambda: sm.sparse_matmul_backward_torch(
            x, sw.vals, sw.idx, dy), reps=2, rounds=2)
    q, k, v, do = (torch.randn((cs.TRAIN_B, cs.TRAIN_T, cfg.n_heads,
                                cfg.head_dim), generator=gen,
                               device=dev).to(torch.bfloat16)
                   for _ in range(4))
    bwd["flash_attention"] = cs.time_ms(
        lambda: fa.flash_attention_backward_torch(q, k, v, do), reps=2,
        rounds=2)
    cs.backward_bounds(q, k, v, do, inputs, bwd)
    del params, inputs, q, k, v, do
    gc.collect()
    torch.cuda.empty_cache()

    # the placed tier against an unplaced tier's stream
    kw = dict(n_stages=cs.PIPE_S, mb_size=cs.TIER_MB,
              image_size=cs.IMAGE_SIZE, seed=cs.SEED, device=dev)
    base = rt_tier.ServingTier("resnet50", n_replicas=2, **kw)
    images = [np.random.default_rng(i).standard_normal(
        (cs.TIER_BATCH, cs.IMAGE_SIZE, cs.IMAGE_SIZE, 3)).astype(np.float32)
        for i in range(cs.TIER_REQUESTS)]
    rids = [base.submit(x) for x in images]
    base.run()
    logits = [base.results(r) for r in rids]
    del base
    gc.collect()
    per_fwd = {n: 0 for n in ops.LAUNCHES}
    per_fwd.update(sparse_conv=47, sparse_matmul=1)
    per_fwd_v = {key: 0 for key in ops.VARIANT_LAUNCHES}
    per_fwd_v.update({("sparse_conv", "mma"): 47,
                      ("sparse_matmul", "gemv"): 1})

    def count(what, want, want_variants):
        launches, variants = dict(ops.LAUNCHES), dict(ops.VARIANT_LAUNCHES)
        for have, wanted in ((launches, want), (variants, want_variants)):
            bad = {n: (have.get(n, 0), c) for n, c in wanted.items()
                   if have.get(n, 0) != c}
            if bad:
                raise AssertionError(f"{what}: launches (got, want) {bad}")
        return {n: c for n, c in launches.items() if c}

    cs.placed_tier_run(types.SimpleNamespace(
        dev=dev, images=images, logits=logits, per_fwd=per_fwd,
        per_fwd_v=per_fwd_v, count=count, reset=ops.reset_launches))
    cs.dryrun_lines(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
