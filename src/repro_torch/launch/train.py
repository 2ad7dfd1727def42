"""Training launcher (the reference's ``src/repro/launch/train.py``):
deterministic synthetic data, AdamW, async checkpoints, failure
injection and restart, straggler detection and optional int8 gradient
compression, on the card unless asked for the CPU.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --steps 100 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --full    # published size

``--reduced`` (the default) trains ``configs.reduced(cfg)``; ``--full``
the published widths and depth. The parameters are drawn from a
``torch.Generator`` seeded with ``seed`` on the device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import DataConfig, MarkovStream
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.runtime import fault


def train(arch: str, *, steps: int = 50, batch: int = 8, seq: int = 128,
          use_reduced: bool = True, ckpt_dir: str | None = None,
          ckpt_every: int = 20, lr: float = 3e-3, seed: int = 0,
          fail_at: tuple = (), grad_compress: bool = False,
          log_every: int = 10, remat: str = "none", verbose: bool = True,
          device="cuda", cfg=None, params=None):
    """Train ``arch`` for ``steps`` steps on Markov tokens (branching 8).
    Returns {"state": {"params", "opt"}, "losses": [(step, loss)],
    "restarts", "stragglers"}.

    ``cfg``: a config to train instead of ``arch``'s (a depth cut);
    ``params``: the initial parameters instead of a draw from ``seed``
    (the tests carry the reference's weights in); each is copied to
    ``device`` and left as it was."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = get_config(arch)
        if use_reduced:
            cfg = reduced(cfg)
    opt_cfg = adamw.AdamWConfig(lr=lr, warmup_steps=max(steps // 10, 1),
                                total_steps=steps)
    data = MarkovStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                   global_batch=batch, seed=seed,
                                   branching=8))

    def make_state():
        if params is not None:
            p = lm.params_to(params, dev)
        else:
            p = lm.init_params(cfg, torch.Generator(dev).manual_seed(seed))
        return {"params": p, "opt": adamw.init(p)}

    def step_fn(state, batch_arrs):
        (_, metrics), grads = value_and_grad(
            lambda p: lm.loss_fn(cfg, p, batch_arrs, remat=remat),
            state["params"])
        if grad_compress:
            err = state.get("err") or fault.init_error(grads)
            qg, err = fault.compress_grads(grads, err)
            grads = fault.decompress_grads(qg)
        new_params, opt, om = adamw.update(opt_cfg, state["params"], grads,
                                           state["opt"])
        return {"params": new_params, "opt": opt}, {**metrics, **om}

    injector = fault.FailureInjector(fail_at_steps=tuple(fail_at))
    straggler = fault.StragglerDetector()
    losses = []

    def run_step(state, i):
        t0 = time.time()
        injector.maybe_fail(i)
        b = {k: torch.from_numpy(v).to(dev) for k, v in data.batch(i).items()}
        state, metrics = step_fn(state, b)
        loss = float(metrics["loss"])           # waits for the step
        dt = time.time() - t0
        straggler.record(0, i, dt)
        losses.append((i, loss))
        if verbose and i % log_every == 0:
            print(f"step {i:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} {dt*1e3:.0f}ms")
        return state

    if ckpt_dir:
        state, restarts, _ = fault.run_with_restarts(
            make_state, run_step, n_steps=steps, ckpt_dir=ckpt_dir,
            ckpt_every=ckpt_every, injector=injector)
    else:
        state = make_state()
        restarts = 0
        for i in range(steps):
            state = run_step(state, i)
    return {"state": state, "losses": losses, "restarts": restarts,
            "stragglers": straggler.flagged}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = train(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
                use_reduced=args.reduced, ckpt_dir=args.ckpt_dir,
                lr=args.lr, fail_at=tuple(args.fail_at),
                grad_compress=args.grad_compress, device=args.device)
    first = out["losses"][0][1]
    last = np.mean([l for _, l in out["losses"][-5:]])
    print(f"loss {first:.3f} -> {last:.3f} "
          f"(restarts={out['restarts']})")


if __name__ == "__main__":
    main()
