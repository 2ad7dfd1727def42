"""Serving on the port: ``serve(ServeConfig(...)) -> dict`` and
``serve_lm(arch, ...)``.

Counterpart of the reference's ``src/repro/launch/serve.py``. For a CNN
it runs the paper's headline regime, batch-1 latency mode: one image in
flight, the next request admitted only after this one's logits are on
the host, with the weights stored at ``quantize`` (native, f32, bf16 or
int8). On the card each request replays one CUDA graph of the whole
forward, PyTorch's counterpart of the reference's single jitted
request. The other CNN modes raise ``NotImplementedError`` naming the
ROADMAP item that ports them. An LM arch (``smollm-360m``) runs
``serve_lm``: the prompts stepped through the decode path, then greedy
decoding.

    python -m repro_torch.launch.serve --arch resnet50 --mode latency \\
        --requests 50 --image-size 224 --quantize int8
    python -m repro_torch.launch.serve --arch smollm-360m --full-size \\
        --batch 4 --prompt-len 32 --gen 16

``--arch`` is any of the paper's CNNs: ``resnet50`` (sparse),
``mobilenet_v1`` or ``mobilenet_v2`` (dense), or ``smollm-360m``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.device import resolve_device
from repro_torch.core.quant import STORE_DTYPES, pytree_param_bytes, \
    quantize_tree
from repro_torch.kernels import ops
from repro_torch.models import cnn, lm


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Everything ``serve()`` needs, in one frozen value; the reference's
    field names, defaults and validation, plus ``device``. ``image_size``
    is the reference's 64: ``main()``'s ``--image-size`` and
    ``chip_smoke.py`` ask for the paper's 224 explicitly. ``n_stages``
    defaults to 1 here: the stage pipeline is not ported yet, and in
    latency mode the reference's composed stages equal the sequential
    forward bitwise, so one chain is the same function."""
    arch: str
    mode: str = "throughput"            # "latency" | "throughput"
    continuous: bool = False
    tier: bool = False
    procs: int = 0
    hosts: int = 0
    quantize: str = "native"
    batch: int = 16                     # LM archs: sequences per batch
    n_requests: int = 4
    n_stages: int = 1
    image_size: int = 64
    seed: int = 0
    verbose: bool = True
    device: str = "cuda"

    def __post_init__(self):
        if self.mode not in ("latency", "throughput"):
            raise ValueError(f"mode={self.mode!r}: expected 'latency' "
                             "or 'throughput'")
        if self.quantize not in STORE_DTYPES:
            raise ValueError(f"quantize={self.quantize!r}: expected one "
                             f"of {STORE_DTYPES}")
        if self.mode == "latency" and (self.continuous or self.tier or
                                       self.procs or self.hosts):
            raise ValueError("mode='latency' serves one image at a time "
                             "— continuous/tier/procs/hosts are "
                             "throughput-mode knobs")
        if self.procs and self.hosts:
            raise ValueError("procs and hosts are exclusive: same-host "
                             "socketpair workers OR TCP dial-in workers")
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
    if cfg.n_stages > 1:
        raise NotImplementedError(
            f"n_stages={cfg.n_stages}: ROADMAP Queue 1, stage pipeline")


def serve(cfg: ServeConfig) -> dict:
    """THE serving entry point. Runs on ``cfg.device`` (the card by
    default; raises ``RuntimeError`` without one). An LM arch runs
    ``serve_lm`` (reduced size, as the reference's dispatch does); an
    LM arch that is not ported raises ``NotImplementedError``."""
    if get_config(cfg.arch).family != "cnn":
        return serve_lm(cfg.arch, batch=cfg.batch, seed=cfg.seed,
                        verbose=cfg.verbose, device=cfg.device)
    _check_ported(cfg)
    return _serve_cnn_latency(cfg)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_lm(arch: str, *, batch: int = 4, prompt_len: int = 32,
             gen_tokens: int = 16, max_seq: int = 128,
             use_reduced: bool = True, seed: int = 0, verbose: bool = True,
             prompts=None, params=None, generator=None,
             record_logits: bool = False, device="cuda") -> dict:
    """Step a batch of prompts through the decode path (filling the KV
    cache), then decode ``gen_tokens`` greedily. Returns tokens and
    timings.

    ``params``: the model's parameters (on ``device``); by default drawn
    from ``generator`` (by default ``torch.Generator(device)`` seeded
    with ``seed``). ``prompts``: (B, T) token ids; by default drawn from
    the same generator, (batch, prompt_len). ``record_logits`` also
    returns every step's logits, (B, T + gen_tokens, V) f32, kept on the
    device until the end. Times end in a device synchronisation."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if use_reduced:
        cfg = reduced(cfg)
    gen = generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(seed)
    if params is None:
        params = lm.init_params(cfg, gen)
    if prompts is None:
        prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                                generator=gen, device=dev)
    prompts = torch.as_tensor(prompts).to(dev, torch.long)
    batch, prompt_len = prompts.shape
    if prompt_len < 1 or gen_tokens < 1 or prompt_len + gen_tokens > max_seq:
        raise ValueError(f"prompt_len {prompt_len}, gen_tokens {gen_tokens}: "
                         f"need >= 1 each, and their sum <= max_seq "
                         f"{max_seq}")
    cache = lm.init_cache(cfg, batch, max_seq, device=dev)
    steps = []

    _sync(dev)
    t0 = time.perf_counter()
    logits = None
    for i in range(prompt_len):
        logits, cache = lm.decode_step(cfg, params, cache,
                                       prompts[:, i:i + 1], i)
        if record_logits:
            steps.append(logits[:, 0])
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    out_tokens = []
    t0 = time.perf_counter()
    tok = logits[:, -1].argmax(dim=-1)[:, None]
    for i in range(gen_tokens):
        out_tokens.append(tok[:, 0].cpu().numpy())
        logits, cache = lm.decode_step(cfg, params, cache, tok,
                                       prompt_len + i)
        if record_logits:
            steps.append(logits[:, 0])
        tok = logits[:, -1].argmax(dim=-1)[:, None]
    _sync(dev)
    decode_s = time.perf_counter() - t0
    toks_per_s = batch * gen_tokens / max(decode_s, 1e-9)
    if verbose:
        print(f"{arch}: prefill {prompt_len} toks in {prefill_s:.2f}s, "
              f"decode {gen_tokens} toks/seq at {toks_per_s:.1f} tok/s "
              f"(batch={batch}, {dev})")
    out = {"tokens": np.stack(out_tokens, 1), "prompts": prompts.cpu().numpy(),
           "prefill_s": prefill_s, "decode_s": decode_s,
           "tokens_per_s": toks_per_s, "device": str(dev)}
    if record_logits:
        out["logits"] = torch.stack(steps, 1).cpu()
    return out


def _launch_counts() -> tuple[dict, dict]:
    return dict(ops.LAUNCHES), dict(ops.VARIANT_LAUNCHES)


def _launch_delta(before: tuple[dict, dict]) -> tuple[dict, dict]:
    after = _launch_counts()
    return tuple({k: a[k] - b.get(k, 0) for k in a}
                 for a, b in zip(after, before))


def latency_request(cfg: ServeConfig, *, capture: bool = True):
    """The batch-1 request of ``cfg``'s CNN, ready to serve: ``(request,
    info)``, where ``request(img)`` takes one (1, H, W, 3) f32 image on
    the host and returns its (1, 1000) f32 logits on the host.

    The weights are drawn from ``cfg.seed`` and stored at
    ``cfg.quantize`` once, before the warm-up (reference ``cnn.py:
    433-435``). One eager warm-up request runs here (on the card it
    builds the kernels and sets their shared-memory limits). On the
    card, with ``capture``, the forward from a static device input is
    then captured into one CUDA graph, and ``request`` copies its image
    into that input, replays the graph and copies the logits out: one
    launch from the host a request, as the reference's one jitted
    request is one dispatch. ``capture=False`` runs every request
    eagerly, the reference the graph is held against; on the CPU
    requests are always eager.

    ``info``: ``captured``, ``warmup_s``, ``param_bytes_stored`` (the
    reference's number), and ``launches_per_request`` /
    ``variant_launches_per_request``, the kernel launches of one request
    counted while the graph was captured (a replay counts nothing: the
    counters are Python integers), or during the warm-up when nothing is
    captured."""
    dev = resolve_device(cfg.device)
    mcfg = get_config(cfg.arch)
    native = cnn.init_cnn(mcfg, torch.Generator().manual_seed(cfg.seed),
                          device="cpu")
    params = cnn.params_to(quantize_tree(native, cfg.quantize), dev)
    img_shape = (1, cfg.image_size, cfg.image_size, 3)
    graph = capture and dev.type == "cuda"

    def forward(img: torch.Tensor) -> torch.Tensor:
        return cnn.cnn_forward(mcfg, params, img, device=dev)

    before = _launch_counts()
    side = torch.cuda.Stream(dev) if graph else None
    t0 = time.perf_counter()
    if side is not None:
        # the warm-up on a side stream, as PyTorch's capture recipe asks
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            forward(torch.zeros(img_shape)).cpu()
        torch.cuda.current_stream(dev).wait_stream(side)
    else:
        forward(torch.zeros(img_shape)).cpu()
    warmup_s = time.perf_counter() - t0
    per_request = _launch_delta(before)

    if graph:
        static_in = torch.zeros(img_shape, device=dev)
        cuda_graph = torch.cuda.CUDAGraph()
        before = _launch_counts()
        with torch.cuda.graph(cuda_graph):
            static_out = forward(static_in)
        per_request = _launch_delta(before)

        def request(img: torch.Tensor) -> torch.Tensor:
            static_in.copy_(img)
            cuda_graph.replay()
            return static_out.cpu()
    else:
        def request(img: torch.Tensor) -> torch.Tensor:
            return forward(img).cpu()

    return request, {
        "captured": graph, "warmup_s": warmup_s,
        "param_bytes_stored": pytree_param_bytes(native, cfg.quantize),
        "launches_per_request": per_request[0],
        "variant_launches_per_request": per_request[1]}


def _serve_cnn_latency(cfg: ServeConfig, *, capture: bool = True) -> dict:
    """Batch-1 latency serving — the paper's headline regime: the
    requests of :func:`latency_request` (a CUDA graph replay each on the
    card unless ``capture=False``), one in flight. Each request's
    latency is the wall time of H2D, the forward through the fused graph,
    and D2H of the logits (which waits for the device), so the p50/p99
    are round trips with nothing queued; the warm-up is not counted."""
    request, info = latency_request(cfg, capture=capture)
    img_shape = (1, cfg.image_size, cfg.image_size, 3)
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
        print(f"{cfg.arch}: batch-1 latency on {cfg.device} at "
              f"{cfg.image_size}px (quantize={cfg.quantize}, "
              f"{'CUDA graph' if info['captured'] else 'eager'}): p50 "
              f"{p50 * 1e3:.3f}ms / p99 {p99 * 1e3:.3f}ms over "
              f"{cfg.n_requests} requests (warm-up {info['warmup_s']:.2f}s)")
    return {"mode": "latency", "quantize": cfg.quantize,
            "device": str(resolve_device(cfg.device)),
            "latency_p50_s": p50, "latency_p99_s": p99,
            "request_latencies_s": lats,
            "logits": torch.cat(logits).numpy(),
            "request_images": reqs.numpy(), "n_stages": 1, **info}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="resnet50")
    ap.add_argument("--mode", choices=("latency", "throughput"),
                    default="latency")
    ap.add_argument("--requests", type=int, default=50)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--quantize", choices=STORE_DTYPES, default="native")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    lm_args = ap.add_argument_group("LM archs")
    lm_args.add_argument("--batch", type=int, default=4)
    lm_args.add_argument("--prompt-len", type=int, default=32)
    lm_args.add_argument("--gen", type=int, default=16)
    lm_args.add_argument("--max-seq", type=int, default=128)
    lm_args.add_argument("--full-size", action="store_true",
                         help="the config as published, not reduced()")
    args = ap.parse_args(argv)
    if get_config(args.arch).family != "cnn":
        serve_lm(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                 gen_tokens=args.gen, max_seq=args.max_seq,
                 use_reduced=not args.full_size, seed=args.seed,
                 device=args.device)
        return
    serve(ServeConfig(arch=args.arch, mode=args.mode,
                      n_requests=args.requests, image_size=args.image_size,
                      quantize=args.quantize, seed=args.seed,
                      device=args.device))


if __name__ == "__main__":
    main()
