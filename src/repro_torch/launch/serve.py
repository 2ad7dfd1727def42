"""Image serving on the port: ``serve(ServeConfig(...)) -> dict``.

Counterpart of the reference's ``src/repro/launch/serve.py``. This slice
runs the paper's headline regime, batch-1 latency mode for a CNN: one
image in flight, the next request admitted only after this one's logits
are on the host. The other modes raise ``NotImplementedError`` naming
the ROADMAP item that ports them.

    python -m repro_torch.launch.serve --arch resnet50 --mode latency \\
        --requests 50 --image-size 224

``--arch`` is any of the paper's CNNs: ``resnet50`` (sparse),
``mobilenet_v1`` or ``mobilenet_v2`` (dense).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.models import cnn
from repro_torch.models.layers import SparseWeight


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Everything ``serve()`` needs, in one frozen value; the reference's
    field names, plus ``device``. ``n_stages`` defaults to 1 here: the
    stage pipeline is not ported yet, and in latency mode the reference's
    composed stages equal the sequential forward bitwise, so one chain
    is the same function."""
    arch: str
    mode: str = "throughput"            # "latency" | "throughput"
    continuous: bool = False
    tier: bool = False
    procs: int = 0
    hosts: int = 0
    quantize: str = "native"
    n_requests: int = 4
    n_stages: int = 1
    image_size: int = 224
    seed: int = 0
    verbose: bool = True
    device: str = "cuda"

    def __post_init__(self):
        if self.mode not in ("latency", "throughput"):
            raise ValueError(f"mode={self.mode!r}: expected 'latency' "
                             "or 'throughput'")
        if self.mode == "latency" and (self.continuous or self.tier or
                                       self.procs or self.hosts):
            raise ValueError("mode='latency' serves one image at a time "
                             "— continuous/tier/procs/hosts are "
                             "throughput-mode knobs")
        if self.n_requests < 1:
            raise ValueError(f"n_requests={self.n_requests}: need >= 1")


def _check_ported(cfg: ServeConfig) -> None:
    if cfg.tier or cfg.procs or cfg.hosts:
        raise NotImplementedError(
            "tier/procs/hosts: ROADMAP Queue 1, fault-tolerant tier")
    if cfg.continuous:
        raise NotImplementedError(
            "continuous: ROADMAP Queue 1, throughput and continuous serving")
    if cfg.mode != "latency":
        raise NotImplementedError(
            "mode='throughput': ROADMAP Queue 1, throughput and continuous "
            "serving")
    if cfg.quantize != "native":
        raise NotImplementedError(
            f"quantize={cfg.quantize!r}: ROADMAP Queue 1, int8/bf16 storage")
    if cfg.n_stages > 1:
        raise NotImplementedError(
            f"n_stages={cfg.n_stages}: ROADMAP Queue 1, stage pipeline")


def serve(cfg: ServeConfig) -> dict:
    """THE serving entry point. Runs on ``cfg.device`` (the card by
    default; raises ``RuntimeError`` without one)."""
    get_config(cfg.arch)       # an LM arch raises NotImplementedError
    _check_ported(cfg)
    return _serve_cnn_latency(cfg)


def _param_bytes(params: dict) -> int:
    total = 0
    for p in params.values():
        w = p["w"]
        leaves = (w.vals, w.idx) if isinstance(w, SparseWeight) else (w,)
        for t in leaves + (p["b"],):
            total += t.numel() * t.element_size()
    return total


def _serve_cnn_latency(cfg: ServeConfig) -> dict:
    """Batch-1 latency serving — the paper's headline regime.

    Each request is one (1, H, W, 3) f32 image on the host. Its latency
    is the wall time of H2D, the forward through the fused graph, and
    D2H of the logits (``.cpu()`` waits for the device), so the
    p50/p99 are round trips with nothing queued. One warm-up request
    runs first and is not counted (on the card it builds the kernels)."""
    dev = resolve_device(cfg.device)
    mcfg = get_config(cfg.arch)
    params = cnn.init_cnn(mcfg, torch.Generator().manual_seed(cfg.seed),
                          device=dev)
    img_shape = (1, cfg.image_size, cfg.image_size, 3)

    def request(img: torch.Tensor) -> torch.Tensor:
        return cnn.cnn_forward(mcfg, params, img, device=dev).cpu()

    t0 = time.perf_counter()
    request(torch.zeros(img_shape))
    warmup_s = time.perf_counter() - t0
    reqs = torch.randn((cfg.n_requests,) + img_shape[1:],
                       generator=torch.Generator().manual_seed(cfg.seed + 1))
    lats, logits = [], []
    for i in range(cfg.n_requests):
        t0 = time.perf_counter()
        y = request(reqs[i:i + 1])
        lats.append(time.perf_counter() - t0)
        logits.append(y)
    p50 = float(np.percentile(lats, 50))
    p99 = float(np.percentile(lats, 99))
    if cfg.verbose:
        print(f"{cfg.arch}: batch-1 latency on {dev} at {cfg.image_size}px: "
              f"p50 {p50 * 1e3:.3f}ms / p99 {p99 * 1e3:.3f}ms over "
              f"{cfg.n_requests} requests (warm-up {warmup_s:.2f}s)")
    return {"mode": "latency", "quantize": cfg.quantize,
            "device": str(dev),
            "latency_p50_s": p50, "latency_p99_s": p99,
            "request_latencies_s": lats,
            "logits": torch.cat(logits).numpy(),
            "request_images": reqs.numpy(),
            "n_stages": 1, "warmup_s": warmup_s,
            "param_bytes_stored": _param_bytes(params)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="resnet50")
    ap.add_argument("--mode", choices=("latency", "throughput"),
                    default="latency")
    ap.add_argument("--requests", type=int, default=50)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    serve(ServeConfig(arch=args.arch, mode=args.mode,
                      n_requests=args.requests, image_size=args.image_size,
                      seed=args.seed, device=args.device))


if __name__ == "__main__":
    main()
