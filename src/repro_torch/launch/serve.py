"""Serving on the port: ``serve(ServeConfig(...)) -> dict`` and
``serve_lm(arch, ...)``.

Counterpart of the reference's ``src/repro/launch/serve.py``. A CNN arch
serves images in the mode the config names, with the weights stored at
``quantize`` (native, f32, bf16 or int8):

- ``mode="throughput"`` (the default): the heterogeneous layer pipeline.
  The planner cuts the fused layer graph into ``n_stages`` cost-balanced
  stages (``core/planner.py``), each stage runs its own program on its
  own CUDA stream (``core/pipeline.py``), and microbatches stream
  through them. The batched executor (``_serve_cnn``) captures a whole
  batch, all M + S - 1 ticks, as one CUDA graph and times its replays;
  ``continuous=True`` serves back-to-back requests through a
  never-draining pipeline (``CNNPipelineServer``): one captured tick
  replayed per microbatch, the next microbatch's H2D and the previous
  one's D2H on a copy stream beside the tick in flight.
- ``mode="latency"``: batch 1, one image in flight, the next request
  admitted only after this one's logits are on the host; each request
  replays one CUDA graph of the whole forward.

Planning (``_plan_cnn_serving``): the analytic cut by default;
``tuning_cache`` (a path or a ``core.tuning.TuningCache``) plans from the
times measured on the device and installs the cache, whose tuned kernel
plans the kernels then run; ``calibrate`` measures every fused node
first; ``auto_split`` lets the (stages, replicas) co-planner split the
devices (one card: S = 1, R = 1); ``n_microbatches=0`` autotunes M from
the plan's stage costs.

The fault-tolerant tier (``tier=True``, ``procs=N``, ``hosts=N``;
``runtime/tier.py``) routes requests across replicas of
``CNNPipelineServer``: in this process, in OS-process workers, or in
workers that dial in over TCP, with drain-and-respawn recovery that
replays a failed replica's microbatches bitwise.

Weights on the card: the continuous server and the tier's replicas run
PLACED stage programs, as the reference's single-host server does: each
stage unpacks its params from its own packed uint8 row
(``pipeline.PlacedParams``), every leaf on a 16-byte boundary, and no
stage program closes over a weight. With one device slot per (stage,
replica) (``devices=`` slots, ``launch.mesh.device_slots``; S = R = 1 on
one card) they run on a stage mesh of those slots, row k of the even
``(S, width)`` buffer placed on slot k, as in the reference's placed
path; ``_serve_cnn`` takes that path there too and otherwise closes over
one device copy of the weights.

On the CPU (``device="cpu"``) the same calls run the plain versions,
eagerly. An LM arch (``smollm-360m``) runs
``serve_lm``: the prompts stepped through the decode path, then greedy
decoding.

    python -m repro_torch.launch.serve --arch resnet50 --batch 16 \\
        --microbatches 4 --stages 4
    python -m repro_torch.launch.serve --arch resnet50 --continuous \\
        --requests 8 --batch 8 --mb-size 2
    python -m repro_torch.launch.serve --arch resnet50 --mode latency \\
        --requests 50 --quantize int8
    python -m repro_torch.launch.serve --arch resnet50 --calibrate \\
        --tuning-cache build/resnet50_h100.json --microbatches 0
    python -m repro_torch.launch.serve --arch resnet50 --tier \\
        --replicas 2 --fail-replica 0 --fail-at-tick 3
    python -m repro_torch.launch.serve --arch resnet50 --procs 2 \\
        --kill-worker 0
    python -m repro_torch.launch.serve --arch resnet50 --hosts 2
    python -m repro_torch.launch.serve --arch smollm-360m --full-size \\
        --batch 4 --prompt-len 32 --gen 16

``--arch`` is any of the paper's CNNs: ``resnet50`` (sparse),
``mobilenet_v1`` or ``mobilenet_v2`` (dense), or ``smollm-360m``; add
``--device cpu --image-size 32`` to run on the CPU.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time
import warnings
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.device import graph_capture as _capture
from repro_torch.core.device import resolve_device
from repro_torch.core.quant import STORE_DTYPES, pytree_param_bytes, \
    quantize_tree
from repro_torch.core import pipeline as pp
from repro_torch.core import planner, tuning
from repro_torch.core.fusion import fused_graph_for
from repro_torch.kernels import ops
from repro_torch.models import cnn, lm


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Everything ``serve()`` needs, in one frozen value; the reference's
    field names, defaults and validation, plus ``device``. ``image_size``
    is the reference's 64: ``main()``'s ``--image-size`` and
    ``chip_smoke.py`` ask for the paper's 224 explicitly. ``placed=None``
    places when there is one device per (stage, replica), as in the
    reference; ``placed=True`` without them raises its ``ValueError``."""
    arch: str
    mode: str = "throughput"            # "latency" | "throughput"
    continuous: bool = False
    tier: bool = False
    replicas: int = 1
    procs: int = 0                      # >0: OS-process replica workers
    hosts: int = 0                      # >0: TCP dial-in replica workers
    listen: Optional[str] = None        # hosts mode: "host:port" to bind
    quantize: str = "native"
    batch: int = 16                     # LM archs: sequences per batch
    n_requests: int = 4
    n_microbatches: int = 4
    mb_size: int = 2
    n_stages: int = 4
    image_size: int = 64
    iters: int = 3
    seed: int = 0
    placed: Optional[bool] = None
    param_budget_frac: Optional[float] = None
    auto_split: bool = False
    # fault-injection knobs (tier / procs / hosts modes)
    fail_replica: Optional[int] = None
    fail_at_tick: Optional[int] = None
    kill_worker: Optional[int] = None
    kill_at_tick: int = 1
    # procs / hosts liveness knobs
    heartbeat_interval_s: float = 0.1
    suspect_after_s: float = 0.5
    dead_after_s: float = 10.0
    ledger_dir: Optional[str] = None
    tuning_cache: Optional[object] = None
    calibrate: bool = False
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
        if self.listen is not None and not self.hosts:
            raise ValueError("listen= names a bind address for hosts "
                             "mode; set hosts > 0")
        if self.n_requests < 1:
            raise ValueError(f"n_requests={self.n_requests}: need >= 1")


def serve(cfg, **kw) -> dict:
    """THE serving entry point: ``serve(ServeConfig(...)) -> dict``. Runs
    on ``cfg.device`` (the card by default; raises ``RuntimeError``
    without one). A CNN arch runs the mode the config names: ``latency``
    (batch 1, p50/p99), or ``throughput`` through the fault-tolerant tier
    (``tier`` / ``procs`` / ``hosts``), the continuous (``continuous``)
    or the one-shot batched executor. An LM arch (every family: dense,
    MoE, VLM, rwkv6, zamba2, whisper) runs ``serve_lm`` (reduced size, as
    the reference's dispatch does).

    ``serve("arch-name", **kw)`` (the pre-ServeConfig signature) still
    works as a DeprecationWarning shim over ``serve_lm(arch, **kw)``."""
    if isinstance(cfg, str):
        warnings.warn(
            "serve(arch, ...) is deprecated; LM serving moved to "
            "serve_lm(arch, ...) and serve() now takes a ServeConfig",
            DeprecationWarning, stacklevel=2)
        return serve_lm(cfg, **kw)
    if kw:
        raise TypeError(f"serve(ServeConfig) takes no extra kwargs "
                        f"(got {sorted(kw)})")
    if get_config(cfg.arch).family != "cnn":
        return serve_lm(cfg.arch, batch=cfg.batch, seed=cfg.seed,
                        verbose=cfg.verbose, device=cfg.device)
    if cfg.mode == "latency":
        return _serve_cnn_latency(cfg)
    if cfg.tier or cfg.procs or cfg.hosts:
        return _serve_cnn_tier(
            cfg.arch, n_requests=cfg.n_requests, batch=cfg.batch,
            mb_size=cfg.mb_size, n_stages=cfg.n_stages,
            n_replicas=cfg.replicas, image_size=cfg.image_size,
            seed=cfg.seed, fail_replica=cfg.fail_replica,
            fail_at_tick=cfg.fail_at_tick, procs=cfg.procs,
            hosts=cfg.hosts, listen=cfg.listen,
            kill_worker=cfg.kill_worker, kill_at_tick=cfg.kill_at_tick,
            heartbeat_interval_s=cfg.heartbeat_interval_s,
            suspect_after_s=cfg.suspect_after_s,
            dead_after_s=cfg.dead_after_s, ledger_dir=cfg.ledger_dir,
            quantize=cfg.quantize, verbose=cfg.verbose, device=cfg.device)
    common = dict(n_stages=cfg.n_stages, n_replicas=cfg.replicas,
                  image_size=cfg.image_size, seed=cfg.seed,
                  placed=cfg.placed, param_budget_frac=cfg.param_budget_frac,
                  auto_split=cfg.auto_split, tuning_cache=cfg.tuning_cache,
                  calibrate=cfg.calibrate, quantize=cfg.quantize,
                  verbose=cfg.verbose, device=cfg.device)
    if cfg.continuous:
        return _serve_cnn_continuous(cfg.arch, n_requests=cfg.n_requests,
                                     batch=cfg.batch, mb_size=cfg.mb_size,
                                     **common)
    return _serve_cnn(cfg.arch, batch=cfg.batch,
                      n_microbatches=cfg.n_microbatches, iters=cfg.iters,
                      **common)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_lm(arch: str, *, batch: int = 4, prompt_len: int = 32,
             gen_tokens: int = 16, max_seq: int = 128,
             use_reduced: bool = True, seed: int = 0, greedy: bool = True,
             verbose: bool = True, prompts=None, params=None,
             generator=None, frames=None, record_logits: bool = False,
             device="cuda", cfg=None) -> dict:
    """Step a batch of prompts through the decode path (filling the KV
    cache), then decode ``gen_tokens`` greedily. Returns tokens and
    timings. Decoding is greedy either way: ``greedy`` is taken, as the
    reference's is, and read nowhere.

    ``cfg``: a config to serve instead of ``arch``'s (a depth cut, as
    ``launch.train.train`` takes one). ``params``: the model's parameters
    (on ``device``); by default drawn from ``generator`` (by default ``torch.Generator(device)`` seeded
    with ``seed``). ``prompts``: (B, T) token ids; by default drawn from
    the same generator, (batch, prompt_len). ``record_logits`` also
    returns every step's logits, (B, T + gen_tokens, V) f32, kept on the
    device until the end. Times end in a device synchronisation.

    Every step is ``decode_step`` at one int position for the batch, so
    an MoE model routes the batch's B tokens of a step together (one
    capacity a step), as the reference's ``serve_lm`` does. A VLM is
    served on its tokens alone: the reference draws patch embeddings
    here, but its decode step never reads them, so the port draws
    none.

    Whisper (the audio family): ``frames`` (B, Te, d), by default drawn
    from the generator after the prompts (bf16, standard normal); the
    encoder runs over them and fills the cache's ``cross_kv``
    (``lm.fill_cross_kv``) before the prompt, inside ``prefill_s``. A
    deliberate difference: the reference draws frames here too but runs
    no encoder, so its decode attends over a zero ``cross_kv`` and its
    tokens come from zeros; the port's come from the encoder (ROADMAP
    Queue 3 item 4)."""
    dev = resolve_device(device)
    if cfg is None:
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
    if cfg.family == "audio" and frames is None:
        frames = torch.randn((batch, cfg.encoder_seq, cfg.d_model),
                             generator=gen, device=dev).to(torch.bfloat16)
    cache = lm.init_cache(cfg, batch, max_seq, device=dev)
    steps = []

    _sync(dev)
    t0 = time.perf_counter()
    if cfg.family == "audio":
        lm.fill_cross_kv(cfg, params, cache, frames)
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


def _init_native(mcfg, seed: int) -> dict:
    """The serving weights: drawn from ``seed`` on the CPU, native."""
    return cnn.init_cnn(mcfg, torch.Generator().manual_seed(seed),
                        device="cpu")


def latency_request(cfg: ServeConfig, *, capture: bool = True,
                    native: Optional[dict] = None):
    """The batch-1 request of ``cfg``'s CNN, ready to serve: ``(request,
    info)``, where ``request(img)`` takes one (1, H, W, 3) f32 image on
    the host and returns its (1, 1000) f32 logits on the host.

    The weights (``native``, on the CPU, by default drawn from
    ``cfg.seed``) are stored at ``cfg.quantize`` once, before the
    warm-up (reference ``cnn.py:433-435``). One eager warm-up request
    runs here (on the card it
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
    if native is None:
        native = _init_native(mcfg, cfg.seed)
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
        with _capture(cuda_graph):
            static_out = forward(static_in)
        per_request = _launch_delta(before)

        def request(img: torch.Tensor) -> torch.Tensor:
            static_in.copy_(img)
            cuda_graph.replay()
            return static_out.cpu()
        # the graph reads the weights' addresses: they live as long as it
        request.params = params
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
    are round trips with nothing queued; the warm-up is not counted.

    The plan's ``n_stages`` is reported, as the reference's; the request
    stays the direct forward, which is bitwise the reference's composed
    stage chain (pipelined == sequential)."""
    mcfg, native, plan, _, _ = _plan_cnn_serving(
        cfg.arch, n_stages=cfg.n_stages, n_replicas=1, n_microbatches=1,
        param_budget_frac=cfg.param_budget_frac, auto_split=False,
        seed=cfg.seed, tuning_cache=cfg.tuning_cache,
        calibrate=cfg.calibrate, image_size=cfg.image_size,
        store_dtype=cfg.quantize, verbose=cfg.verbose, device=cfg.device)
    request, info = latency_request(cfg, capture=capture, native=native)
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
              f"{'CUDA graph' if info['captured'] else 'eager'}, plan of "
              f"{plan['n_stages']} stages): p50 {p50 * 1e3:.3f}ms / p99 "
              f"{p99 * 1e3:.3f}ms over {cfg.n_requests} requests (warm-up "
              f"{info['warmup_s']:.2f}s)")
    return {"mode": "latency", "quantize": cfg.quantize,
            "device": str(resolve_device(cfg.device)),
            "latency_p50_s": p50, "latency_p99_s": p99,
            "request_latencies_s": lats,
            "logits": torch.cat(logits).numpy(),
            "request_images": reqs.numpy(),
            "n_stages": int(plan["n_stages"]), **info}


# ---------------------------------------------------------------------------
# throughput serving: the heterogeneous layer pipeline
# ---------------------------------------------------------------------------

def _plan_cnn_serving(arch: str, *, n_stages: int, n_replicas: int,
                      n_microbatches: int, param_budget_frac,
                      auto_split: bool, seed: int, tuning_cache=None,
                      calibrate: bool = False, image_size: int = 64,
                      store_dtype: str = "native",
                      params: Optional[dict] = None, verbose: bool = False,
                      device="cuda", n_devices: Optional[int] = None):
    """Shared serving preamble of every CNN executor (reference
    ``serve.py:245-303``): the weights (drawn from ``seed`` on the CPU,
    native, unless ``params`` gives them), the weight budget
    (``param_budget_frac`` of the bytes stored at ``store_dtype``) and
    the (stages, replicas) split: the co-planner's over ``n_devices``
    (by default the devices of ``device``'s kind; one card: S = 1, R =
    1) when ``auto_split``, the caller's otherwise. Returns ``(cfg, params, plan, n_replicas,
    total_bytes)``.

    Profile-guided planning: ``tuning_cache`` (a path or a TuningCache)
    plans with ``model="measured"`` over the cache's node times and
    installs the cache for dispatch (``tuning.set_tuning_cache``: the
    kernels run its tuned plans from then on, as in the reference);
    ``calibrate=True`` first times every fused node on ``device`` at
    ``(1, image_size, image_size, 3)`` (the card's kernels there, the
    plain versions on the CPU) and writes the cache back to a path. A
    missing or cold cache gives the analytic plan bit for bit."""
    cfg = get_config(arch)
    if cfg.family != "cnn":
        raise ValueError(f"{arch} is not a CNN arch")
    dev = resolve_device(device)
    if params is None:
        params = _init_native(cfg, seed)
    total_bytes = pytree_param_bytes(params, store_dtype)
    budget = (int(param_budget_frac * total_bytes)
              if param_budget_frac else None)
    cache = tuning.resolve_cache(cfg, params, tuning_cache, calibrate,
                                 image_size=image_size, device=dev,
                                 verbose=verbose)
    model = "analytic" if cache is None else "measured"
    if cache is not None:
        tuning.set_tuning_cache(cache)      # the kernels' tuned plans
    with tuning.device_scope(dev):
        if auto_split:
            n_dev = n_devices if n_devices is not None else \
                torch.cuda.device_count() if dev.type == "cuda" else 1
            plan2d = planner.plan(cfg, params, planner.PlanRequest(
                n_devices=n_dev, n_microbatches=n_microbatches,
                max_stage_param_bytes=budget, model=model,
                tuning_cache=cache, store_dtype=store_dtype))
            plan, n_replicas = plan2d["plan"], plan2d["n_replicas"]
        else:
            plan = planner.plan(cfg, params, planner.PlanRequest(
                n_stages=n_stages, max_stage_param_bytes=budget,
                model=model, tuning_cache=cache, store_dtype=store_dtype))
    return cfg, params, plan, n_replicas, total_bytes


def _placement(placed, n_stages: int, n_replicas: int,
               dev: torch.device, devices=None) -> bool:
    """Whether to place the even ``(S, width)`` buffer on a stage mesh:
    with ``placed=None`` when the pool holds one device slot a (stage,
    replica), as in the reference; ``placed=True`` without them raises
    the reference's ``ValueError``. The pool: ``devices`` (slots,
    ``launch.mesh.device_slots``), else the cards of ``dev``'s kind (one
    CPU device)."""
    if devices is not None:
        n_dev = len(devices)
    else:
        n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    need = n_stages * n_replicas
    if placed is None:
        return n_dev >= need
    if placed and n_dev < need:
        raise ValueError(
            f"placed=True needs >= {need} devices ({n_stages} stages x "
            f"{n_replicas} replicas), have {n_dev}; pass devices="
            "launch.mesh.device_slots(n, device) or drop "
            "placement/replication")
    return bool(placed)


def _mesh_on(mesh, dev: torch.device) -> bool:
    """Whether every slot of ``mesh`` lies on ``dev`` (a CUDA graph, and
    a state tensor, hold one device's work)."""
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return mesh.device_set() == {dev}


def _stage_pool(dev: torch.device, devices, need: int) -> list:
    """The first ``need`` slots of the pool ``_placement`` counted."""
    from repro_torch.launch import mesh as meshlib
    if devices is not None:
        return list(devices)[:need]
    if dev.type == "cuda":
        return meshlib.default_pool()[:need]
    return meshlib.device_slots(need, dev)


def _serve_cnn(arch: str, *, batch: int = 16, n_microbatches: int = 4,
               n_stages: int = 4, image_size: int = 64, iters: int = 3,
               seed: int = 0, verbose: bool = True, placed=None,
               param_budget_frac=None, n_replicas: int = 1,
               auto_split: bool = False, tuning_cache=None,
               calibrate: bool = False, quantize: str = "native",
               device="cuda", streams: bool = True,
               params: Optional[dict] = None, images=None,
               devices=None) -> dict:
    """Batched image serving through the heterogeneous layer pipeline.

    Plans cost-balanced stage cuts over the fused layer graph, compiles
    per-stage wire programs (``cnn.stage_programs``) and streams M
    microbatches of the batch through them: M + S - 1 ticks of
    ``pipeline.pipeline_step_hetero``, each stage on its own CUDA stream
    (``streams=False``: all on one stream). A stage runs only on the
    ticks where its slot holds a microbatch (M x S x R stage runs).

    Weights: with one device slot per (stage, replica) (``placed=None``
    and enough slots, or ``placed=True``) the placed stage programs run
    on a stage mesh of those slots (``devices``: slots,
    ``launch.mesh.device_slots``; by default the cards, or the one CPU)
    and read row k of the even ``(S, width)`` buffer
    (``PlacedParams.pack()``, leaves 16-byte aligned) placed on the
    slots of stage k, as the reference's placed path; otherwise the
    stage programs close over one device copy of the stored weights, as
    the reference's do.

    On the card the whole batch, from a static device input to the
    logits, is captured as one CUDA graph after an eager warm-up on a
    side stream, and ``run_s`` is the mean of ``iters`` replays with the
    images already on the card, as the reference times its jitted
    ``run``. On the CPU it runs eagerly. ``images_per_s`` = batch /
    run_s. A batch the microbatch count does not divide is zero-padded
    and the padded outputs dropped.

    ``params``: the native weights on the CPU (default: drawn from
    ``seed``); ``images``: (B, H, W, 3) f32 (default: drawn from
    ``seed`` with a CPU ``torch.Generator``). ``n_microbatches=0``
    autotunes M from the plan's stage costs
    (``tuning.autotune_microbatch``); ``tuning_cache``, ``calibrate``
    and ``auto_split`` as in :func:`_plan_cnn_serving`."""
    dev = resolve_device(device)
    cfg, native, plan, r, total_bytes = _plan_cnn_serving(
        arch, n_stages=n_stages, n_replicas=n_replicas,
        n_microbatches=n_microbatches or 8,
        param_budget_frac=param_budget_frac, auto_split=auto_split,
        seed=seed, tuning_cache=tuning_cache, calibrate=calibrate,
        image_size=image_size, store_dtype=quantize, params=params,
        verbose=verbose, device=dev)
    if not n_microbatches:
        # the knee of the fill curve over the plan's (measured or
        # analytic) stage costs
        n_microbatches = tuning.autotune_microbatch(
            plan["stage_cost"], n_replicas=r,
            cache=tuning.current_tuning_cache(), arch=arch)
        if verbose:
            print(f"[serve] autotuned n_microbatches={n_microbatches}")
    s = plan["n_stages"]
    use_placed = _placement(placed, s, r, dev, devices)
    if images is None:
        images = torch.randn((batch, image_size, image_size, 3),
                             generator=torch.Generator().manual_seed(seed))
    if not isinstance(images, torch.Tensor):
        images = torch.from_numpy(np.array(images, np.float32))
    images = images.float()
    batch = images.shape[0]
    x_mb = pp.microbatch(images.to(dev), n_microbatches, pad=True,
                         n_replicas=r)
    lead = (r, n_microbatches) if r > 1 else (n_microbatches,)
    mb_shape = tuple(x_mb.shape[len(lead):])
    rows = mesh = None
    if use_placed:
        from repro_torch.launch import mesh as meshlib
        from repro_torch.launch.shardings import placed_stage_setup
        stage_fns, pack_in, unpack_out, width, pparams, mesh, sps = \
            placed_stage_setup(cfg, native, plan, mb_shape, n_replicas=r,
                               devices=_stage_pool(dev, devices, s * r),
                               quantize=quantize, align=pp.ALIGN)
        rows = meshlib.place(pparams.pack(), mesh, sps["buffer"])
        placed_bytes = pparams.width
    else:
        dparams = cnn.params_to(quantize_tree(native, quantize), dev)
        stage_fns, pack_in, unpack_out, width = cnn.stage_programs(
            cfg, dparams, plan["stage_of"], mb_shape, quantize=quantize)
        # what placement WOULD hold per device
        placed_bytes = int(plan["placed_bytes_per_device"])
    cuda = dev.type == "cuda"
    slots = pp.slot_streams(s, r, dev, mesh=mesh) if streams and cuda \
        else None

    def run(xmb: torch.Tensor) -> torch.Tensor:
        wires = torch.zeros(lead + (mb_shape[0], width), device=dev)
        for idx in np.ndindex(*lead):
            pack_in(xmb[idx], out=wires[idx])
        outs = pp.pipeline_apply_gspmd_hetero(
            stage_fns, wires, n_stages=s, n_replicas=r, streams=slots,
            stage_axis="stage", mesh=mesh, stage_params=rows)
        return pp.concat_hetero_outputs(outs, unpack_out, n_microbatches,
                                        n_replicas=r)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    graph = cuda and (mesh is None or _mesh_on(mesh, dev))
    before = _launch_counts()
    t0 = time.perf_counter()
    if graph:
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            run(x_mb)
        torch.cuda.current_stream(dev).wait_stream(side)
        sync()
        cuda_graph = torch.cuda.CUDAGraph()
        before = _launch_counts()
        with _capture(cuda_graph):
            static_out = run(x_mb)
        per_batch = _launch_delta(before)
        go = cuda_graph.replay
    else:
        static_out = run(x_mb)
        per_batch = _launch_delta(before)

        def go():
            static_out.copy_(run(x_mb))
    go()
    sync()
    logits = static_out[:batch].cpu()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(max(iters, 1)):
        go()
        sync()
    run_s = (time.perf_counter() - t0) / max(iters, 1)

    ims_per_s = batch / max(run_s, 1e-9)
    bub = pp.bubble_fraction(n_microbatches, s)
    n_streams = s * r if slots is not None else 1
    if verbose:
        rep = f" x{r} replicas" if r > 1 else ""
        print(f"{arch}: {batch} imgs @{image_size}px through {s} stages"
              f"{rep} (M={n_microbatches}, {n_streams} streams, "
              f"{'CUDA graph' if graph else 'eager'}, "
              f"quantize={quantize}) on {dev}: {ims_per_s:.1f} im/s "
              f"(warm-up {compile_s:.2f}s, bubble {bub:.2f}, imbalance "
              f"{plan['imbalance']:.2f}, wire {width} f32, "
              f"{'placed rows' if use_placed else 'closures'})")
    return {"logits": logits.numpy(), "images": images.numpy(),
            "images_per_s": ims_per_s, "compile_s": compile_s,
            "run_s": run_s, "bubble_fraction": bub, "n_stages": s,
            "n_replicas": r, "n_microbatches": n_microbatches,
            "imbalance": plan["imbalance"], "stage_of": plan["stage_of"],
            "placed": use_placed, "quantize": quantize, "device": str(dev),
            "param_bytes_replicated_per_device": int(total_bytes),
            "param_bytes_placed_per_device": placed_bytes,
            "param_placement_ratio": placed_bytes / max(total_bytes, 1),
            "ticks": n_microbatches + s - 1,
            "stage_runs": n_microbatches * s * r, "streams": n_streams,
            "wire_width": width, "captured": graph,
            "launches_per_batch": per_batch[0],
            "variant_launches_per_batch": per_batch[1]}


_EXTERNAL = object()


class CNNPipelineServer:
    """Continuous-batching image server over the heterogeneous layer
    pipeline — the steady state HPIPE's throughput numbers describe (a
    pipeline that is always full, not one that fills and drains per
    batch).

    ``submit()`` cuts each request's images into fixed-size microbatches
    (the last one zero-padded, the pad rows dropped on output) and
    queues them; ``run()`` ticks the pipeline once per queued
    microbatch, injecting request K+1's first microbatch on the tick
    right after request K's last (the pipeline never drains between
    requests), plus S-1 flush ticks.

    A tick (parity p = tick % 2) packs the staged images ``_img[p]``
    into state ``_bufs[p]`` slot 0, runs ``pipeline_step_hetero`` into
    ``_bufs[1 - p]`` (each (stage, replica) slot on its own CUDA stream)
    and unpacks the emitted wire into ``_out[p]``: every buffer is
    preallocated and written in place. On the card each parity's tick is
    captured once as a CUDA graph (after an eager warm-up on a side
    stream) and replayed per microbatch. The next tick's H2D (from
    pinned memory) and this tick's D2H run on a copy stream, ordered by
    events, so both overlap the tick in flight; the D2H is read back one
    tick late, as the reference's ``_tick_once`` arranges. Each server
    replays its ticks on a stream of its own. On the CPU the tick runs
    eagerly.

    The serving tier's hooks (``runtime/tier.py``): ``enqueue(key, ...)``
    queues one microbatch whose logits go to ``on_result(key, logits)``;
    ``injector`` fires first in ``_tick_once``; ``recover_work()`` drains
    every undelivered microbatch once nothing is in flight on the card,
    ``respawn()`` zeroes the state in place, ``purge(pred)`` drops queued
    ones. With ``plan=`` (and ``cfg=``, ``params=``) the server serves
    that plan and those weights as given, and ``param_rows=`` hands it
    rows already on the card, so the tier's replicas share one plan and
    one set of rows.

    Params: the stage programs are PLACED
    (``cnn.stage_programs(placed=True)``): stage k unpacks its weights
    from its own uint8 row, every leaf on a 16-byte boundary
    (``pipeline.ALIGN``), and no stage program closes over a weight.
    With ``placed=None`` or ``False`` and fewer device slots than S x R
    the rows are ``pparams.pack_ragged()`` on ``device`` (the reference's
    single-host branch). Where the slots suffice (``devices=``, S x R
    slots, ``launch.mesh.device_slots``; by default the cards, so S = R
    = 1 on one card) or with ``placed=True``, the server runs on a stage
    mesh of those slots (``self.mesh``) and row k of the even ``(S,
    width)`` buffer ``pparams.pack()`` lies on slot k
    (``param_buffer``, a ``launch.mesh.Sharded``; ``param_buffer=``
    takes one placed in advance on the same slots, as the tier's remesh
    gives it), as the reference's placed path; ``placed=True`` without
    the slots raises its ``ValueError``. ``param_rows`` is replica 0's
    row a stage either way. ``closures=True`` compiles the closure
    programs over one device copy of the weights instead, the form the
    two are held against.

    Bitwise contract: continuous serving equals isolated requests and
    the sequential forward at the same microbatch size (slots never
    mix)."""

    def __init__(self, arch: str, *, mb_size: int = 2, n_stages: int = 4,
                 n_replicas: int = 1, image_size: int = 64, seed: int = 0,
                 placed=None, param_budget_frac=None,
                 auto_split: bool = False, verbose: bool = False,
                 params=None, tuning_cache=None,
                 calibrate: bool = False, quantize: str = "native",
                 device="cuda", streams: bool = True, injector=None,
                 cfg=None, plan=None, param_rows=None,
                 closures: bool = False, devices=None, param_buffer=None):
        dev = resolve_device(device)
        if plan is not None:
            # the serving tier plans ONCE and hands every replica the
            # same (cfg, params, plan): identical weights and stage cuts
            # are what make failure replay bitwise
            if cfg is None or params is None:
                raise ValueError("plan= requires cfg= and params=")
        else:
            cfg, params, plan, n_replicas, _ = _plan_cnn_serving(
                arch, n_stages=n_stages, n_replicas=n_replicas,
                # the co-planner's fill term wants the microbatches a
                # stream brings, not one request's: continuous injection
                # amortizes the fill (as in the reference)
                n_microbatches=32,
                param_budget_frac=param_budget_frac,
                auto_split=auto_split, seed=seed, tuning_cache=tuning_cache,
                calibrate=calibrate, image_size=image_size,
                store_dtype=quantize, params=params, verbose=verbose,
                device=dev)
        self.cfg = cfg
        self.quantize = quantize
        self.n_stages = s = plan["n_stages"]
        self.n_replicas = r = n_replicas
        self.mb_size = mb_size
        self.image_size = image_size
        self.plan = plan
        self.device = dev
        self.devices = list(devices) if devices is not None else None
        self.placed = _placement(placed, s, r, dev, self.devices)
        mb_shape = (mb_size, image_size, image_size, 3)
        self.pparams = self.param_buffer = self.mesh = rows = None
        buffer = None
        if closures:
            dparams = cnn.params_to(quantize_tree(params, quantize), dev)
            stage_fns, pack_in, unpack_out, width = cnn.stage_programs(
                cfg, dparams, plan["stage_of"], mb_shape, quantize=quantize)
        elif self.placed:
            from repro_torch.launch import mesh as meshlib
            from repro_torch.launch.shardings import placed_stage_setup
            if param_rows is not None:
                raise ValueError("param_rows= are a single device's rows; "
                                 "a placed server takes param_buffer=")
            stage_fns, pack_in, unpack_out, width, self.pparams, \
                self.mesh, sps = placed_stage_setup(
                    cfg, params, plan, mb_shape, n_replicas=r,
                    devices=_stage_pool(dev, self.devices, s * r),
                    quantize=quantize, align=pp.ALIGN)
            if param_buffer is None:
                param_buffer = meshlib.place(self.pparams.pack(), self.mesh,
                                             sps["buffer"])
            elif not isinstance(param_buffer, meshlib.Sharded) or \
                    param_buffer.shape != (s, self.pparams.buffer_width) or \
                    param_buffer.mesh.shape != self.mesh.shape or any(
                        param_buffer.mesh.slot(c) != self.mesh.slot(c)
                        for c in self.mesh.indices()):
                raise ValueError(
                    f"param_buffer: {param_buffer!r}, need the ({s}, "
                    f"{self.pparams.buffer_width}) buffer placed on the "
                    f"slots of {self.mesh!r}")
            # a buffer placed in advance (the tier's remesh) runs as it is
            self.param_buffer = buffer = param_buffer
            rows = tuple(param_buffer.shard({"stage": k})[0]
                         for k in range(s))
        else:
            stage_fns, pack_in, unpack_out, width, self.pparams = \
                cnn.stage_programs(cfg, params, plan["stage_of"], mb_shape,
                                   placed=True, quantize=quantize,
                                   align=pp.ALIGN)
            rows = param_rows
            if rows is None:
                rows = tuple(row.to(dev) for row in
                             self.pparams.pack_ragged())
            elif len(rows) != s or any(
                    row.numel() < w or row.device.type != dev.type
                    for row, w in zip(rows, self.pparams.row_widths)):
                raise ValueError(
                    f"param_rows: {len(rows)} rows of "
                    f"{[row.numel() for row in rows]} bytes on "
                    f"{[str(row.device) for row in rows]}, need {s} of "
                    f">= {list(self.pparams.row_widths)} on {dev}")
        # one packed row per stage (replica 0's on a mesh; None: closures)
        self.param_rows = rows
        tick_params = buffer if buffer is not None else rows
        self.width = width
        lead = (r,) if r > 1 else ()
        self._img_shape = lead + mb_shape
        self._state_shape = (s,) + lead + (mb_size, width)
        # a state tensor (and a CUDA graph) holds one device's work; slots
        # on several devices take per-slot buffers and eager ticks
        one_device = self.mesh is None or _mesh_on(self.mesh, dev)
        if one_device:
            self._bufs = [torch.zeros(self._state_shape, device=dev)
                          for _ in range(2)]
        else:
            slot_grid = pp.mesh_slots(self.mesh, s, r)
            self._bufs = [pp.slot_buffers((mb_size, width), slot_grid)
                          for _ in range(2)]
        self._img = [torch.zeros(self._img_shape, device=dev)
                     for _ in range(2)]
        logits = cnn.node_shapes(cfg, None, mb_shape)[
            fused_graph_for(cfg.name).output]
        out_shape = lead + tuple(logits.shape)
        self._out = [torch.zeros(out_shape, device=dev) for _ in range(2)]
        self._cuda = dev.type == "cuda"
        slots = pp.slot_streams(s, r, dev, mesh=self.mesh) \
            if streams and self._cuda else None
        self.streams = s * r if slots is not None else 1
        bufs, img, outs, mesh = self._bufs, self._img, self._out, self.mesh

        # (the tick holds no reference to the server: no cycle, so a
        # server is freed, graphs and pools with it, when it is dropped;
        # the server holds the tick, and through it every tensor its
        # captured graphs read that is not theirs: the closures' weights)
        def tick(p: int) -> None:
            src, dst = bufs[p], bufs[1 - p]
            for q in range(r):
                pack_in(img[p][q] if r > 1 else img[p],
                        out=pp.slot_at(src, 0, q, r > 1))
            pp.pipeline_step_hetero(stage_fns, src, None, n_stages=s,
                                    n_replicas=r, out=dst, streams=slots,
                                    stage_axis="stage", mesh=mesh,
                                    stage_params=tick_params)
            for q in range(r):
                (outs[p][q] if r > 1 else outs[p]).copy_(
                    unpack_out(pp.slot_at(dst, 0, q, r > 1)))

        self.captured = self._cuda and one_device
        self.launches_per_tick = None
        if self._cuda:
            ev = torch.cuda.Event
            # each server replays its ticks on a stream of its own, so the
            # replicas of a tier on one card overlap on it
            self._stream = torch.cuda.Stream(dev)
            self._copy = torch.cuda.Stream(dev)
            self._h2d_done = [ev(), ev()]
            self._tick_done = [ev(), ev()]
            self._d2h_done = [ev(), ev()]
            self._pin_in = [torch.zeros(self._img_shape).pin_memory()
                            for _ in range(2)]
            self._pin_out = [torch.zeros(out_shape).pin_memory()
                             for _ in range(2)]
            cur = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(cur)
            before = _launch_counts()
            with torch.cuda.stream(side):
                tick(0)
            self.launches_per_tick = _launch_delta(before)
            with torch.cuda.stream(side):
                tick(1)
            cur.wait_stream(side)
            torch.cuda.synchronize(dev)
        if self.captured:
            graphs = []
            for p in range(2):
                g = torch.cuda.CUDAGraph()
                before = _launch_counts()
                with _capture(g):
                    tick(p)
                if p == 0:
                    self.launches_per_tick = _launch_delta(before)
                graphs.append(g)
            self._step = lambda p: graphs[p].replay()
        else:
            self._step = tick
        self._tick = tick
        self._reset()
        # FIFO of (req_id, mb_index, n_valid, images) microbatch slots; a
        # tier's slot (enqueue()) has req _EXTERNAL and its key for index
        self._queue = deque()
        self._results = {}
        self._pending = {}
        self._next_req = 0
        self.ticks = 0
        self.injected_slots = 0
        self.verbose = verbose
        self._req_submit = {}
        self._req_done = {}
        # failure injection fires first in the tick path
        # (maybe_fail(ticks)), where a real mid-stream crash would surface
        self.injector = injector
        # tier hook: enqueue()d slots deliver through on_result(key,
        # logits) instead of the results() store
        self.on_result = None

    @property
    def idle_slots(self) -> int:
        """Pipeline slots that ran empty over the server's lifetime
        (fill/flush ticks + unfilled replica slots)."""
        return self.ticks * self.n_replicas - self.injected_slots

    def _reset(self) -> None:
        """A zero pipeline state, written in place (the captured ticks
        read these addresses), and empty tracking."""
        with torch.cuda.stream(self._stream) if self._cuda else \
                contextlib.nullcontext():
            for b in self._bufs:
                for t in [b] if isinstance(b, torch.Tensor) else \
                        [t for row in b for t in row]:
                    t.zero_()
        self._staged = None
        self._inflight = deque()
        self._emitted = None

    def _quiesce(self) -> None:
        """Wait until no copy and no tick of this server is in flight on
        the card: an H2D of a staged microbatch, the D2H of an emitted
        one, or a tick. After this every buffer may be reused."""
        if self._cuda:
            self._copy.synchronize()
            self._stream.synchronize()

    # -- request intake ----------------------------------------------------

    def submit(self, images) -> int:
        """Queue one request (B, H, W, 3). Returns a request id whose
        logits ``results()`` yields after ``run()``."""
        images = np.asarray(images, np.float32)
        b = images.shape[0]
        if b == 0:
            raise ValueError("empty request (batch 0)")
        if images.shape[1:] != (self.image_size, self.image_size, 3):
            raise ValueError(f"request shape {images.shape[1:]} != "
                             f"({self.image_size}, {self.image_size}, 3)")
        req = self._next_req
        self._next_req += 1
        n_mb = -(-b // self.mb_size)
        self._pending[req] = n_mb
        self._results[req] = [None] * n_mb
        self._req_submit[req] = time.perf_counter()
        for i in range(n_mb):
            chunk = images[i * self.mb_size:(i + 1) * self.mb_size]
            n_valid = chunk.shape[0]
            if n_valid < self.mb_size:
                chunk = np.concatenate(
                    [chunk, np.zeros((self.mb_size - n_valid,)
                                     + chunk.shape[1:], np.float32)])
            self._queue.append((req, i, n_valid, chunk))
        return req

    def enqueue(self, key, images, *, n_valid=None) -> None:
        """Tier hook: queue ONE microbatch whose logits are delivered to
        ``on_result(key, logits)`` instead of the results() store.
        ``images`` may be short (padded here) or already the padded
        ``(mb_size, H, W, 3)`` chunk with ``n_valid`` real rows."""
        if self.on_result is None:
            raise ValueError("enqueue() needs on_result set")
        images = np.asarray(images, np.float32)
        if images.shape[0] > self.mb_size:
            raise ValueError(f"enqueue() takes one microbatch "
                             f"(<= {self.mb_size} rows), got "
                             f"{images.shape[0]}")
        if n_valid is None:
            n_valid = images.shape[0]
        if images.shape[0] < self.mb_size:
            images = np.concatenate(
                [images, np.zeros((self.mb_size - images.shape[0],)
                                  + images.shape[1:], np.float32)])
        self._queue.append((_EXTERNAL, key, n_valid, images))

    @property
    def busy(self) -> bool:
        """True while any microbatch is queued, staged, in flight, or
        emitted-but-uncollected."""
        return bool(self._queue) or self._staged is not None or \
            any(s is not None for s in self._inflight) or \
            self._emitted is not None

    # -- the device side of a tick -----------------------------------------

    def _put(self, p: int, imgs: Optional[np.ndarray]) -> None:
        """Stage the images of the next parity-p tick (zeros for an idle
        tick) into ``_img[p]``: on the card from pinned memory on the copy
        stream, once the parity-p tick before has read it."""
        if not self._cuda:
            if imgs is None:
                self._img[p].zero_()
            else:
                self._img[p].copy_(torch.from_numpy(imgs))
            return
        self._h2d_done[p].synchronize()       # _pin_in[p] is free again
        with torch.cuda.stream(self._copy):
            self._copy.wait_event(self._tick_done[p])
            if imgs is None:
                self._img[p].zero_()
            else:
                self._pin_in[p].copy_(torch.from_numpy(imgs))
                self._img[p].copy_(self._pin_in[p], non_blocking=True)
            self._h2d_done[p].record(self._copy)

    def _dispatch(self, p: int) -> None:
        if self._cuda:
            st = self._stream
            st.wait_event(self._h2d_done[p])
            st.wait_event(self._d2h_done[p])   # _out[p] read back
            with torch.cuda.stream(st):
                self._step(p)
            self._tick_done[p].record(st)
        else:
            self._step(p)

    def _fetch(self, p: int) -> None:
        """Start the D2H of the logits the parity-p tick emitted."""
        if self._cuda:
            with torch.cuda.stream(self._copy):
                self._copy.wait_event(self._tick_done[p])
                self._pin_out[p].copy_(self._out[p], non_blocking=True)
                self._d2h_done[p].record(self._copy)

    def _read(self, p: int) -> np.ndarray:
        if self._cuda:
            self._d2h_done[p].synchronize()
            return self._pin_out[p].numpy().copy()
        return self._out[p].numpy().copy()

    # -- the serving loop --------------------------------------------------

    def _stage_next(self):
        """Pop the next tick's worth of slots (R microbatches) and start
        their H2D — called right after the CURRENT tick is dispatched,
        so the transfer overlaps the step."""
        if not self._queue:
            return None
        r = self.n_replicas
        slots = [self._queue.popleft() if self._queue else None
                 for _ in range(r)] if r > 1 else [self._queue.popleft()]
        zeros = np.zeros((self.mb_size, self.image_size, self.image_size, 3),
                         np.float32)
        imgs = np.stack([sl[3] if sl is not None else zeros
                         for sl in slots]) if r > 1 else slots[0][3]
        p = self.ticks % 2
        self._put(p, imgs)
        return slots, p

    def _collect(self, slots, p: int) -> None:
        """Record one tick's emitted microbatch(es). Blocks on the D2H —
        deferred one tick, so the next tick is already dispatched."""
        if slots is None:
            return
        logits = self._read(p)
        for k, slot in enumerate(slots):
            if slot is None:
                continue
            req, i, n_valid, _ = slot
            lg = logits[k] if self.n_replicas > 1 else logits
            if req is _EXTERNAL:
                self.on_result(i, lg[:n_valid])      # i is the tier's key
                continue
            self._results[req][i] = lg[:n_valid]
            self._pending[req] -= 1
            if self._pending[req] == 0:
                self._req_done[req] = time.perf_counter()

    def _tick_once(self) -> bool:
        """One pipeline tick (the serving tier drives this directly;
        run() loops it). Returns True if a device tick was dispatched,
        False when the pipe was idle and only the trailing emitted output
        remained to collect. The injector fires FIRST, so an injected
        replica failure surfaces where a real mid-stream crash would:
        with the next microbatch's H2D and the last one's D2H possibly
        still in flight on the copy stream (``recover_work`` waits for
        them)."""
        if self.injector is not None:
            self.injector.maybe_fail(self.ticks)
        if self._staged is None:
            self._staged = self._stage_next()
        if self._staged is None and not any(
                s is not None for s in self._inflight):
            if self._emitted is not None:
                self._collect(*self._emitted)
                self._emitted = None
            return False
        if self._staged is not None:
            slots, p = self._staged
        else:
            slots, p = None, self.ticks % 2
            self._put(p, None)                 # an idle slot: zero wire
        self._dispatch(p)
        self.ticks += 1
        if slots is not None:
            self.injected_slots += sum(1 for s in slots if s is not None)
        self._inflight.append(slots)
        self._staged = self._stage_next()     # H2D overlaps the step
        if self._emitted is not None:
            self._collect(*self._emitted)
            self._emitted = None
        if len(self._inflight) >= self.n_stages:
            done = self._inflight.popleft()
            if done is not None:
                self._fetch(p)
            self._emitted = (done, p)
        return True

    def run(self) -> dict:
        """Drain the queue: one pipeline tick per queued microbatch plus
        S-1 flush ticks. Returns throughput/bubble metrics for the run."""
        t0 = time.perf_counter()
        n_imgs = sum(s[2] for s in self._queue)
        ticks_before = self.ticks
        injected_before = self.injected_slots
        done_before = set(self._req_done)
        if self._staged is None:
            self._staged = self._stage_next()
        while self._staged is not None or any(
                s is not None for s in self._inflight):
            self._tick_once()
        if self._emitted is not None:
            self._collect(*self._emitted)
            self._emitted = None
        elapsed = time.perf_counter() - t0
        ticks = self.ticks - ticks_before
        injected = self.injected_slots - injected_before
        slot_ticks = ticks * self.n_replicas
        bubble = 1.0 - injected / max(slot_ticks, 1)
        lat = [self._req_done[r] - self._req_submit[r]
               for r in self._req_done if r not in done_before]
        metrics = {
            "request_latencies_s": lat,
            "images": int(n_imgs),
            "ticks": int(ticks),
            "injected_microbatches": int(injected),
            "images_per_s": n_imgs / max(elapsed, 1e-9),
            "elapsed_s": elapsed,
            "steady_bubble": bubble,
            "fill_bubble_single_batch": None,
            "n_stages": self.n_stages,
            "n_replicas": self.n_replicas,
        }
        if self.verbose:
            print(f"{self.cfg.name}: served {n_imgs} imgs in {ticks} "
                  f"ticks ({metrics['images_per_s']:.1f} im/s, steady "
                  f"bubble {bubble:.3f})")
        return metrics

    def results(self, req: int) -> np.ndarray:
        """(B, 1000) logits of a completed request. One-shot: the entry
        is evicted on delivery."""
        if req not in self._pending:
            raise KeyError(f"unknown request id {req}")
        if self._pending[req] != 0:
            raise ValueError(f"request {req} incomplete "
                             f"({self._pending[req]} microbatches "
                             "outstanding); call run() first")
        del self._pending[req]
        self._req_submit.pop(req, None)
        self._req_done.pop(req, None)
        return np.concatenate(self._results.pop(req), axis=0)

    # -- failure recovery (the tier's drain-and-respawn contract) ----------

    def recover_work(self):
        """Drain every undelivered microbatch after a failure, in
        submission order: emitted-but-uncollected first (recomputed, its
        output never read), then in flight, staged and queued. Waits
        first until no copy or tick of this server is in flight, so no
        late H2D can land on a buffer that is staged again. Internal
        (submit()) slots are re-queued here; external (enqueue()) slots
        are RETURNED as ``[(key, n_valid, padded_chunk)]`` for the tier
        to re-route onto a healthy replica. After this the server is
        drained and ``respawn()`` makes it serve again.

        A real fault of the card (a sticky CUDA error) poisons the whole
        process's context: the wait here raises it, and no server of that
        process can serve again. Recovering from that is the process
        tier's job (a worker process dies and is respawned), not this
        method's."""
        self._quiesce()
        drained = []
        if self._emitted is not None:
            slots, _ = self._emitted          # never read the output
            if slots is not None:
                drained.extend(s for s in slots if s is not None)
            self._emitted = None
        for slots in self._inflight:
            if slots is not None:
                drained.extend(s for s in slots if s is not None)
        self._inflight.clear()
        if self._staged is not None:
            slots, _ = self._staged
            drained.extend(s for s in slots if s is not None)
            self._staged = None
        drained.extend(self._queue)
        self._queue.clear()
        external = []
        for req, i, n_valid, chunk in drained:
            if req is _EXTERNAL:
                external.append((i, n_valid, chunk))
            else:
                self._queue.append((req, i, n_valid, chunk))
        return external

    def respawn(self) -> None:
        """Reset the pipeline after a failure: the state buffers zeroed
        in place (the captured ticks read their addresses, so nothing is
        reallocated) once nothing of this server is in flight, and empty
        tracking. Queued work (anything recover_work() re-queued)
        survives; the captured ticks and the weights are reused."""
        self._quiesce()
        self._reset()

    def purge(self, pred) -> int:
        """Drop queued EXTERNAL microbatches whose key matches ``pred``
        (the tier's request shedding: timeout/deadline). Returns the
        number removed; in-flight slots finish and are dropped at
        delivery."""
        kept, n = deque(), 0
        for slot in self._queue:
            if slot[0] is _EXTERNAL and pred(slot[1]):
                n += 1
            else:
                kept.append(slot)
        self._queue = kept
        return n


def _serve_cnn_continuous(arch: str, *, n_requests: int = 4,
                          batch: int = 8, mb_size: int = 2,
                          n_stages: int = 4, n_replicas: int = 1,
                          image_size: int = 64, seed: int = 0,
                          placed=None, param_budget_frac=None,
                          auto_split: bool = False, verbose: bool = True,
                          tuning_cache=None, calibrate: bool = False,
                          quantize: str = "native", device="cuda",
                          streams: bool = True,
                          params: Optional[dict] = None,
                          requests=None, devices=None) -> dict:
    """Continuous-batching serving run: K back-to-back requests through
    one :class:`CNNPipelineServer` (the pipeline never drains between
    them), after one warm-up request. Returns the per-request logits,
    throughput, the steady-state bubble (below the single-batch fill
    bubble (S-1)/(M+S-1) for K > 1) and the request latencies' p50/p99.

    ``params``: the native weights on the CPU (default: drawn from
    ``seed``); ``requests``: K arrays (B, H, W, 3) f32 (default: drawn
    from ``seed + 1`` with a CPU ``torch.Generator``). ``devices``: the
    pool of device slots a placed server runs on (``CNNPipelineServer``)."""
    srv = CNNPipelineServer(arch, mb_size=mb_size, n_stages=n_stages,
                            n_replicas=n_replicas, image_size=image_size,
                            seed=seed, placed=placed,
                            param_budget_frac=param_budget_frac,
                            auto_split=auto_split, verbose=False,
                            tuning_cache=tuning_cache, calibrate=calibrate,
                            quantize=quantize, device=device,
                            streams=streams, params=params,
                            devices=devices)
    warm = srv.submit(np.zeros((mb_size, image_size, image_size, 3),
                               np.float32))
    srv.run()
    srv.results(warm)
    if requests is None:
        gen = torch.Generator().manual_seed(seed + 1)
        requests = [torch.randn((batch, image_size, image_size, 3),
                                generator=gen).numpy()
                    for _ in range(n_requests)]
    reqs = [srv.submit(imgs) for imgs in requests]
    metrics = srv.run()
    m_per_req = -(-int(np.asarray(requests[0]).shape[0]) // mb_size)
    metrics["fill_bubble_single_batch"] = pp.bubble_fraction(
        m_per_req, srv.n_stages)
    metrics["logits"] = [srv.results(rq) for rq in reqs]
    metrics["request_images"] = [np.asarray(x, np.float32)
                                 for x in requests]
    lat = metrics["request_latencies_s"]
    metrics["latency_p50_s"] = float(np.percentile(lat, 50))
    metrics["latency_p99_s"] = float(np.percentile(lat, 99))
    metrics.update(quantize=quantize, device=str(srv.device),
                   placed=srv.placed, mb_size=mb_size, streams=srv.streams,
                   captured=srv.captured, wire_width=srv.width,
                   stage_of=srv.plan["stage_of"],
                   launches_per_tick=srv.launches_per_tick)
    if verbose:
        print(f"{arch}: continuous {len(reqs)} x {batch} imgs "
              f"(mb {mb_size}, {srv.n_stages} stages, {srv.streams} "
              f"streams, quantize={quantize}) on {srv.device}: "
              f"{metrics['images_per_s']:.1f} im/s, steady bubble "
              f"{metrics['steady_bubble']:.3f} vs single-batch fill "
              f"{metrics['fill_bubble_single_batch']:.3f}, latency p50 "
              f"{metrics['latency_p50_s'] * 1e3:.3f}ms / p99 "
              f"{metrics['latency_p99_s'] * 1e3:.3f}ms")
    return metrics


def _serve_cnn_tier(arch: str, *, n_requests: int = 8, batch: int = 8,
                    mb_size: int = 2, n_stages: int = 4,
                    n_replicas: int = 2, image_size: int = 64,
                    seed: int = 0, fail_replica=None, fail_at_tick=None,
                    procs: int = 0, hosts: int = 0, listen=None,
                    kill_worker=None, kill_at_tick: int = 1,
                    heartbeat_interval_s: float = 0.1,
                    suspect_after_s: float = 0.5,
                    dead_after_s: float = 10.0,
                    ledger_dir=None, quantize: str = "native",
                    verbose: bool = True, device="cuda") -> dict:
    """Fault-tolerant serving (reference ``serve.py:1005-1080``): K
    requests through a :class:`~repro_torch.runtime.tier.ServingTier` of
    R :class:`CNNPipelineServer` replicas, optionally failing one
    mid-stream with a ``FailureInjector`` (``fail_replica`` at
    ``fail_at_tick``) to show drain-and-respawn keep every request's
    logits intact.

    ``procs > 0``: OS-process replica workers
    (:class:`~repro_torch.runtime.tier.ProcessServingTier`): heartbeat
    liveness, the framed transport and, with ``kill_worker``, a real
    mid-tick ``SIGKILL`` of that worker at serving tick ``kill_at_tick``.
    ``hosts > 0``: workers dial the supervisor over TCP
    (:class:`~repro_torch.runtime.tier.HostServingTier`; ``listen``
    "host:port", by default a loopback ephemeral port), handshake on the
    serving fingerprint and fetch the param blob by SHA-256 first.

    The weights are drawn from ``seed``, the K requests of ``batch``
    images from ``seed + 1`` with a CPU ``torch.Generator``. Returns the
    tier's metrics with ``logits`` and ``request_images`` per request,
    and for worker processes ``ready_times`` (each generation's
    spawn-to-ready seconds and the kernel launches it counted)."""
    from repro_torch.runtime.fault import FailureInjector
    from repro_torch.runtime.tier import (HostServingTier,
                                          ProcessServingTier, ServingTier)
    common = dict(n_stages=n_stages, mb_size=mb_size,
                  image_size=image_size, seed=seed, quantize=quantize,
                  verbose=verbose, device=device)
    if procs > 0 or hosts > 0:
        hooks = {}
        if kill_worker is not None:
            hooks[kill_worker] = {"kill_at_tick": kill_at_tick}
        live = dict(worker_hooks=hooks,
                    heartbeat_interval_s=heartbeat_interval_s,
                    suspect_after_s=suspect_after_s,
                    dead_after_s=dead_after_s, ledger_dir=ledger_dir,
                    **common)
        if hosts > 0:
            bind = ("127.0.0.1", 0)
            if listen:
                host, _, port = str(listen).rpartition(":")
                bind = (host or "127.0.0.1", int(port))
            tier = HostServingTier(arch, n_procs=hosts, listen=bind, **live)
        else:
            tier = ProcessServingTier(arch, n_procs=procs, **live)
    else:
        injectors = {}
        if fail_replica is not None and fail_at_tick is not None:
            injectors[fail_replica] = FailureInjector(
                fail_at_steps=(fail_at_tick,))
        tier = ServingTier(arch, n_replicas=n_replicas,
                           injectors=injectors, **common)
    gen = torch.Generator().manual_seed(seed + 1)
    requests = [torch.randn((batch, image_size, image_size, 3),
                            generator=gen).numpy()
                for _ in range(n_requests)]
    try:
        rids = [tier.submit(imgs) for imgs in requests]
        metrics = tier.run()
        metrics["logits"] = [tier.results(r) for r in rids]
        if procs > 0 or hosts > 0:
            metrics["ready_times"] = list(tier.ready_times)
    finally:
        if procs > 0 or hosts > 0:
            tier.close()
    metrics["request_images"] = [np.asarray(x, np.float32)
                                 for x in requests]
    return metrics


# --- deprecated per-mode entry points (use serve(ServeConfig(...))) --------

def _serve_deprecated(old: str) -> None:
    warnings.warn(f"{old}() is deprecated; use "
                  "serve(ServeConfig(arch=..., ...)): one config, one "
                  "dispatcher", DeprecationWarning, stacklevel=3)


def serve_cnn(arch: str, **kw):
    """Deprecated shim: ``serve(ServeConfig(arch, mode='throughput'))``."""
    _serve_deprecated("serve_cnn")
    return _serve_cnn(arch, **kw)


def serve_cnn_continuous(arch: str, **kw):
    """Deprecated shim: ``serve(ServeConfig(arch, continuous=True))``."""
    _serve_deprecated("serve_cnn_continuous")
    return _serve_cnn_continuous(arch, **kw)


def serve_cnn_tier(arch: str, **kw):
    """Deprecated shim: ``serve(ServeConfig(arch, tier=True))``."""
    _serve_deprecated("serve_cnn_tier")
    return _serve_cnn_tier(arch, **kw)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="resnet50")
    ap.add_argument("--mode", choices=("latency", "throughput"),
                    default="throughput",
                    help="latency: batch-1 single-image serving, "
                         "measured p50/p99; throughput: the batched / "
                         "continuous pipelines")
    ap.add_argument("--batch", type=int, default=4,
                    help="images per batch (CNN), sequences (LM)")
    ap.add_argument("--requests", type=int, default=4,
                    help="latency and continuous modes: request count")
    ap.add_argument("--microbatches", type=int, default=4,
                    help="microbatches per batch (0 = autotune the count "
                         "from the plan's stage costs)")
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--replicas", type=int, default=1,
                    help="run this many whole pipelines side by side, "
                         "each slot on its own stream")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching serving loop: requests "
                         "stream through a never-draining pipeline")
    ap.add_argument("--mb-size", type=int, default=2,
                    help="continuous mode: images per microbatch")
    ap.add_argument("--placed", action="store_true", default=None,
                    help="force per-stage weight placement (needs one "
                         "device per stage; default: auto)")
    ap.add_argument("--replicated-params", dest="placed",
                    action="store_false",
                    help="force replicated params")
    ap.add_argument("--param-budget-frac", type=float, default=None,
                    help="bound any stage's weight bytes to this "
                         "fraction of the model (memory-aware planner)")
    ap.add_argument("--auto-split", action="store_true",
                    help="let the (stages, replicas) co-planner pick "
                         "the split for the devices there are")
    ap.add_argument("--tuning-cache", type=str, default=None,
                    metavar="PATH",
                    help="plan stages from this profiled tuning cache "
                         "(model='measured') and run its tuned kernel "
                         "plans; missing file = cold cache = analytic "
                         "plan")
    ap.add_argument("--calibrate", action="store_true",
                    help="profile every fused node on the device first "
                         "and write the results to --tuning-cache (then "
                         "plan from them)")
    tier = ap.add_argument_group("fault-tolerant tier")
    tier.add_argument("--tier", action="store_true",
                      help="route requests across --replicas pipeline "
                           "replicas with drain-and-respawn recovery")
    tier.add_argument("--fail-replica", type=int, default=None,
                      help="tier mode: replica to fail via "
                           "FailureInjector")
    tier.add_argument("--fail-at-tick", type=int, default=None,
                      help="tier mode: tick at which that replica fails")
    tier.add_argument("--procs", type=int, default=0,
                      help="serve through this many OS-process replica "
                           "workers (heartbeats, framed transport)")
    tier.add_argument("--hosts", type=int, default=0,
                      help="serve through this many TCP dial-in replica "
                           "workers (fingerprint handshake, the param "
                           "blob fetched by SHA-256)")
    tier.add_argument("--listen", type=str, default=None,
                      metavar="HOST:PORT",
                      help="hosts mode: bind the worker listener here "
                           "(default 127.0.0.1 on an ephemeral port)")
    tier.add_argument("--dial", type=str, default=None,
                      metavar="HOST:PORT",
                      help="run as a dial-in WORKER of a --hosts "
                           "supervisor at this address instead (with "
                           "--token / --blob-sha / --blob-cache)")
    tier.add_argument("--token", type=int, default=0,
                      help="--dial: worker slot token to register as")
    tier.add_argument("--blob-sha", type=str, default=None,
                      help="--dial: SHA-256 of the supervisor's param "
                           "blob (fetched and verified before warm-up)")
    tier.add_argument("--blob-cache", type=str, default=None,
                      help="--dial: content-addressed blob cache dir")
    tier.add_argument("--kill-worker", type=int, default=None,
                      help="procs/hosts mode: worker that SIGKILLs "
                           "itself mid-tick")
    tier.add_argument("--kill-at-tick", type=int, default=1,
                      help="procs/hosts mode: serving tick at which "
                           "--kill-worker fires")
    tier.add_argument("--heartbeat-interval", type=float, default=0.1,
                      help="procs/hosts mode: worker heartbeat period (s)")
    tier.add_argument("--suspect-after", type=float, default=0.5,
                      help="procs/hosts mode: silence that flags a "
                           "worker as a straggler (s)")
    tier.add_argument("--dead-after", type=float, default=10.0,
                      help="procs/hosts mode: silence or stall that "
                           "declares a worker dead (s; > 2x the "
                           "heartbeat interval)")
    tier.add_argument("--ledger-dir", type=str, default=None,
                      help="procs/hosts mode: keep the replay ledger "
                           "here (a restarted supervisor resumes it)")
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--quantize", choices=STORE_DTYPES, default="native")
    ap.add_argument("--seed", type=int, default=0,
                    help="weight seed (part of the tier's handshake "
                         "fingerprint: equal on both ends)")
    ap.add_argument("--device", default="cuda")
    lm_args = ap.add_argument_group("LM archs")
    lm_args.add_argument("--prompt-len", type=int, default=32)
    lm_args.add_argument("--gen", type=int, default=16)
    lm_args.add_argument("--max-seq", type=int, default=128)
    lm_args.add_argument("--reduced", action="store_true", default=True,
                         help="the reduced() config (the default)")
    lm_args.add_argument("--full-size", dest="reduced",
                         action="store_false",
                         help="the config as published, not reduced()")
    args = ap.parse_args(argv)
    if args.dial:
        # a dial-in worker of a --hosts tier: the worker's entry point,
        # with the serving cell this command line names
        from repro_torch.runtime import worker as worker_mod
        wargv = ["--dial", args.dial, "--token", str(args.token),
                 "--arch", args.arch, "--stages", str(args.stages),
                 "--mb-size", str(args.mb_size),
                 "--image-size", str(args.image_size),
                 "--seed", str(args.seed), "--quantize", args.quantize,
                 "--heartbeat-interval", str(args.heartbeat_interval),
                 "--device", args.device]
        if args.blob_sha:
            wargv += ["--blob-sha", args.blob_sha]
        if args.blob_cache:
            wargv += ["--blob-cache", args.blob_cache]
        return worker_mod.main(wargv)
    if get_config(args.arch).family != "cnn":
        serve_lm(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                 gen_tokens=args.gen, max_seq=args.max_seq,
                 use_reduced=args.reduced, seed=args.seed,
                 device=args.device)
        return
    tiered = args.tier or args.procs or args.hosts
    serve(ServeConfig(arch=args.arch, mode=args.mode,
                      continuous=args.continuous, tier=args.tier,
                      procs=args.procs, hosts=args.hosts,
                      listen=args.listen,
                      replicas=(max(args.replicas, 2) if tiered
                                else args.replicas),
                      fail_replica=args.fail_replica,
                      fail_at_tick=args.fail_at_tick,
                      kill_worker=args.kill_worker,
                      kill_at_tick=args.kill_at_tick,
                      heartbeat_interval_s=args.heartbeat_interval,
                      suspect_after_s=args.suspect_after,
                      dead_after_s=args.dead_after,
                      ledger_dir=args.ledger_dir,
                      batch=args.batch, n_requests=args.requests,
                      n_microbatches=args.microbatches,
                      mb_size=args.mb_size, n_stages=args.stages,
                      placed=args.placed,
                      param_budget_frac=args.param_budget_frac,
                      auto_split=args.auto_split,
                      tuning_cache=args.tuning_cache,
                      calibrate=args.calibrate,
                      image_size=args.image_size, quantize=args.quantize,
                      seed=args.seed, device=args.device))


if __name__ == "__main__":
    raise SystemExit(main())
