"""Fault-tolerant multi-replica serving tier: the port's counterpart of
the reference's ``src/repro/runtime/tier.py``.

A tier of R replica pipelines (:class:`~repro_torch.launch.serve
.CNNPipelineServer`) behind one front end that survives a replica dying
mid-stream without draining the fleet or dropping requests:

- **Admission** (:class:`AdmissionQueue`): priority/deadline-aware
  per-tenant queues over microbatch :class:`WorkItem`\\ s, bounded depth
  with typed load shedding (:class:`QueueFullError`).
- **Health**: per-replica heartbeats (every tick stamps
  ``last_heartbeat`` and feeds the :class:`~repro_torch.runtime.fault
  .StragglerDetector`); a stale heartbeat or a raised tick is a replica
  failure.
- **Drain-and-respawn**: on a replica failure the tier recovers every
  microbatch the replica had queued or in flight
  (``CNNPipelineServer.recover_work``, which first waits for the
  replica's copies and ticks on the card) and re-enqueues it at the front
  of the dispatch queue; healthy replicas absorb the work. A microbatch's
  logits are a pure function of its content (slots never mix; every
  replica shares one ``(cfg, params, plan)``), so the replayed stream is
  **bitwise identical** to a no-failure run. The replica then respawns
  (its state buffers zeroed in place: its captured ticks read those
  addresses) behind a full-jitter exponential backoff;
  ``max_respawns`` consecutive failures retire it.

Three fault domains share that request-facing core (:class:`_TierBase`):

- :class:`ServingTier`: the replicas in this process, on one device.
  They share one set of packed param rows on the device (each replica
  runs placed stage programs over them), one plan and the process's one
  tuning cache (the kernels' plans): different plans per replica would
  break replay bitwise. An injected failure is recovered in
  process; a real CUDA fault poisons the process's context, which only
  the process tiers recover from.
- :class:`ProcessServingTier`: each replica an OS process
  (:mod:`repro_torch.runtime.worker`, started by exec), heartbeats,
  ``SIGKILL`` / ``SIGSTOP`` hooks, a crash-safe replay ledger.
- :class:`HostServingTier`: workers dial in over TCP, handshake on the
  serving fingerprint and fetch the param blob by SHA-256.

Every replica, in process or in a worker, is built (its warm-up ticks
and tick captures, where cuDNN chooses) under
:func:`~repro_torch.core.device.deterministic_convs`, which changes no
setting outside that scope; on the card the supervisor builds the kernels
before it starts any worker.

Not ported: the placed tier across devices (``placed=True``,
``devices=``, ``lose_devices``, ``_remesh_buffer``) needs one device per
stage and raises, naming ROADMAP Queue 1 item 9's second half.
"""
from __future__ import annotations

import os
import select
import signal
import socket
import subprocess
import sys
import tempfile
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.launch.serve import _PLACEMENT
from repro_torch.runtime import transport
from repro_torch.runtime.fault import FailureDetector, StragglerDetector


# --- typed serving errors ----------------------------------------------------

class TierError(RuntimeError):
    """Base of the serving tier's typed request failures."""


class QueueFullError(TierError):
    """Bounded-queue load shedding: the tenant's queue cannot admit the
    request (raised synchronously at submit — backpressure, not a
    silent drop)."""


class DeadlineExceededError(TierError):
    """The request's own deadline passed before its results were
    complete; remaining work was shed."""


class RequestTimeoutError(TierError):
    """The tier-wide per-request timeout elapsed before completion."""


class ReplicaFailedError(TierError):
    """The request's work exhausted its retries across replica
    failures (or its replica's devices were permanently lost with no
    healthy capacity left to replay onto)."""


class NoHealthyReplicaError(TierError):
    """Every replica is permanently dead while work is still pending —
    a tier-level outage, raised from ``run()`` rather than recorded
    per-request."""


# --- generalized request + admission (refactored out of scheduler.py) -------

@dataclass
class Request:
    """Payload-agnostic serving request: the admission/accounting core
    shared by every workload the tier fronts (the reference's LM decode
    ``Request`` subclasses it; ``runtime/scheduler.py`` is not ported
    yet, ROADMAP Queue 1 item 8). The CNN tier wraps it as
    :class:`ImageRequest`. ``deadline_s`` is a relative budget from
    ``submitted_at`` (the tier's clock, monotonic by default)."""
    rid: int
    tenant: str = "default"
    priority: int = 0
    deadline_s: Optional[float] = None
    submitted_at: float = 0.0
    done_at: Optional[float] = None
    retries: int = 0


@dataclass
class ImageRequest(Request):
    """One CNN serving request: ``n_images`` rows split into ``n_mb``
    fixed-size microbatch :class:`WorkItem` slots."""
    n_images: int = 0
    n_mb: int = 0


@dataclass
class WorkItem:
    """One routable microbatch: the tier's unit of dispatch, retry and
    recovery. ``images`` is the zero-padded ``(mb_size, H, W, 3)``
    chunk; ``n_valid`` rows of its logits are real. ``deadline_at`` is
    absolute (tier clock); ``seq`` preserves global FIFO order among
    equal (priority, deadline) items."""
    rid: int
    mb_index: int
    n_valid: int
    images: np.ndarray
    tenant: str = "default"
    priority: int = 0
    deadline_at: Optional[float] = None
    seq: int = 0
    retries: int = 0

    @property
    def key(self) -> tuple:
        return (self.rid, self.mb_index)

    def order(self) -> tuple:
        """Dispatch order: higher priority first, then earliest
        deadline (None sorts last), then submission order."""
        dl = self.deadline_at if self.deadline_at is not None else \
            float("inf")
        return (-self.priority, dl, self.seq)


class AdmissionQueue:
    """Priority/deadline-aware per-tenant microbatch queues.

    ``push`` bounds each tenant's queued depth (``max_per_tenant``
    items) and raises :class:`QueueFullError` past it — except for
    ``front=True`` re-enqueues of RECOVERED work, which was already
    admitted once and must not be shed by its own replica's death.
    ``pop`` picks the globally best item by (priority desc, deadline
    asc, least-recently-served tenant, seq): at equal urgency tenants
    ROTATE — one tenant's backlog cannot starve the rest — while a
    single tenant's items stay strictly FIFO."""

    def __init__(self, max_per_tenant: Optional[int] = None):
        self.max_per_tenant = max_per_tenant
        self._q: dict[str, deque[WorkItem]] = {}
        self._served: dict[str, int] = {}
        self._serve_seq = 0

    def __len__(self) -> int:
        return sum(len(q) for q in self._q.values())

    def depth(self, tenant: str) -> int:
        return len(self._q.get(tenant, ()))

    def admit_check(self, tenant: str, n_items: int):
        """Raise QueueFullError unless ``n_items`` more fit — checked
        request-atomically BEFORE pushing, so a shed request never
        half-enters the queue."""
        if self.max_per_tenant is not None and \
                self.depth(tenant) + n_items > self.max_per_tenant:
            raise QueueFullError(
                f"tenant {tenant!r} queue full: {self.depth(tenant)} "
                f"queued + {n_items} requested > bound "
                f"{self.max_per_tenant}; retry later or raise "
                "max_queue_per_tenant")

    def push(self, item: WorkItem, *, front: bool = False):
        q = self._q.setdefault(item.tenant, deque())
        if front:
            q.appendleft(item)
        else:
            q.append(item)

    def pop(self) -> Optional[WorkItem]:
        best_t, best_i, best_key = None, None, None
        for tenant, q in self._q.items():
            if not q:
                continue
            for idx, item in enumerate(q):
                pr, dl, seq = item.order()
                key = (pr, dl, self._served.get(tenant, -1), seq)
                if best_key is None or key < best_key:
                    best_t, best_i, best_key = tenant, idx, key
        if best_t is None:
            return None
        q = self._q[best_t]
        item = q[best_i]
        del q[best_i]
        self._serve_seq += 1
        self._served[best_t] = self._serve_seq
        return item

    def purge(self, rid: int) -> int:
        """Drop every queued item of one request (timeout/deadline
        shedding). Returns the number removed."""
        n = 0
        for tenant, q in self._q.items():
            kept = deque(i for i in q if i.rid != rid)
            n += len(q) - len(kept)
            self._q[tenant] = kept
        return n


# --- shared tier core (bookkeeping + recovery, worker-type agnostic) ---------

class _TierBase:
    """Everything the serving tier does that does NOT depend on how a
    replica runs: request intake and microbatch splitting, delivery
    accounting, typed request failure, deadline/timeout sweeps,
    recovered-work re-enqueue with retry bounds, and full-jitter
    respawn backoff. :class:`ServingTier` (in-process replicas) and
    :class:`ProcessServingTier` (OS-process replicas) both inherit
    this, so the request-facing semantics are one implementation —
    only the fault domain differs.

    Subclass hooks: ``self.workers`` (objects with ``outstanding`` and
    ``alive``) and ``_purge_worker(w, rid)`` (drop one request's queued
    work inside the replica)."""

    def _init_bookkeeping(self, *, max_queue_per_tenant,
                          request_timeout_s, max_retries,
                          backoff_base_s, backoff_max_s, jitter_seed,
                          clock, sleep, verbose):
        if backoff_base_s < 0 or backoff_max_s < 0:
            raise ValueError("backoff_base_s and backoff_max_s must "
                             f"be >= 0, got {backoff_base_s}/"
                             f"{backoff_max_s}")
        self.max_queue_per_tenant = max_queue_per_tenant
        self.request_timeout_s = request_timeout_s
        self.max_retries = max_retries
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.verbose = verbose
        self._clock = clock
        self._sleep = sleep
        self.queue = AdmissionQueue(max_per_tenant=max_queue_per_tenant)
        self._requests: dict[int, ImageRequest] = {}
        self._results: dict[int, list] = {}
        self._pending: dict[int, int] = {}
        self._errors: dict[int, TierError] = {}
        self._completed: list[int] = []
        self._next_rid = 0
        self._next_seq = 0
        self.respawns = 0
        self.recovered_microbatches = 0
        self.retried_microbatches = 0
        # full-jitter backoff randomness: seeded so a test run is
        # reproducible, distinct per tier instance via the seed
        self._rng = np.random.default_rng(jitter_seed)
        # recovery-latency accounting: key -> clock() at requeue; the
        # delta to its (re)delivery is the per-microbatch recovery time
        self._recover_marks: dict = {}
        self.recovery_times: list[float] = []

    # -- request intake ------------------------------------------------------

    def submit(self, images, *, tenant: str = "default",
               priority: int = 0,
               deadline_s: Optional[float] = None) -> int:
        """Admit one request (B, H, W, 3). Raises
        :class:`QueueFullError` when the tenant's queue cannot hold the
        request's microbatches (request-atomic: nothing is enqueued on
        a shed). Returns the request id ``results()`` serves."""
        images = np.asarray(images, np.float32)
        if images.ndim != 4 or images.shape[0] == 0:
            raise ValueError(f"request must be (B>0, H, W, 3), got "
                             f"{images.shape}")
        if images.shape[1:] != (self.image_size, self.image_size, 3):
            raise ValueError(f"request shape {images.shape[1:]} != "
                             f"({self.image_size}, {self.image_size}, 3)")
        b = images.shape[0]
        n_mb = -(-b // self.mb_size)
        self.queue.admit_check(tenant, n_mb)
        now = self._clock()
        rid = self._next_rid
        self._next_rid += 1
        req = ImageRequest(rid=rid, tenant=tenant, priority=priority,
                           deadline_s=deadline_s, submitted_at=now,
                           n_images=b, n_mb=n_mb)
        deadline_at = now + deadline_s if deadline_s is not None else None
        self._requests[rid] = req
        self._results[rid] = [None] * n_mb
        self._pending[rid] = n_mb
        for i in range(n_mb):
            chunk = images[i * self.mb_size:(i + 1) * self.mb_size]
            n_valid = chunk.shape[0]
            if n_valid < self.mb_size:
                chunk = np.concatenate(
                    [chunk, np.zeros((self.mb_size - n_valid,)
                                     + chunk.shape[1:], np.float32)])
            self._next_seq += 1
            self.queue.push(WorkItem(
                rid=rid, mb_index=i, n_valid=n_valid, images=chunk,
                tenant=tenant, priority=priority,
                deadline_at=deadline_at, seq=self._next_seq))
        return rid

    # -- delivery + request failure ------------------------------------------

    def _deliver(self, w, key, logits):
        w.outstanding.pop(key, None)
        rid, mb = key
        if rid in self._errors or rid not in self._pending:
            return                    # shed/cancelled: drop late result
        if self._results[rid][mb] is not None:
            return                    # duplicate (drained + replayed —
            #                           same bits either way)
        self._results[rid][mb] = logits
        mark = self._recover_marks.pop(key, None)
        if mark is not None:
            self.recovery_times.append(self._clock() - mark)
        self._pending[rid] -= 1
        if self._pending[rid] == 0:
            self._requests[rid].done_at = self._clock()
            self._completed.append(rid)

    def _purge_worker(self, w, rid: int):
        raise NotImplementedError

    def _fail_request(self, rid: int, err: TierError):
        if rid in self._errors or rid not in self._pending:
            return
        self._errors[rid] = err
        self.queue.purge(rid)
        for w in self.workers:
            self._purge_worker(w, rid)
            for k in [k for k in w.outstanding if k[0] == rid]:
                del w.outstanding[k]

    # -- deadline / timeout sweeps -------------------------------------------

    def _check_timeouts(self):
        now = self._clock()
        for rid, req in list(self._requests.items()):
            if rid in self._errors or self._pending.get(rid, 0) == 0:
                continue
            age = now - req.submitted_at
            # the request's OWN deadline outranks the tier-wide
            # timeout: a missed SLA reports as the SLA error even when
            # both have elapsed
            if req.deadline_s is not None and age > req.deadline_s:
                self._fail_request(rid, DeadlineExceededError(
                    f"request {rid} missed its {req.deadline_s}s "
                    f"deadline (waited {age:.3f}s)"))
            elif self.request_timeout_s is not None and \
                    age > self.request_timeout_s:
                self._fail_request(rid, RequestTimeoutError(
                    f"request {rid} exceeded the tier timeout "
                    f"{self.request_timeout_s}s (waited {age:.3f}s)"))

    def _live_rids(self) -> list[int]:
        return [r for r, n in self._pending.items()
                if n > 0 and r not in self._errors]

    # -- recovery + backoff ----------------------------------------------------

    def _requeue_recovered(self, items, exc):
        """Re-enqueue recovered microbatches at the queue front (they
        were already admitted), bounding each item's retries; past the
        bound its request fails typed."""
        self.recovered_microbatches += len(items)
        now = self._clock()
        for item in reversed(list(items)):   # front-push keeps order
            if item.rid in self._errors:
                continue
            item.retries += 1
            self.retried_microbatches += 1
            if item.retries > self.max_retries:
                self._fail_request(item.rid, ReplicaFailedError(
                    f"request {item.rid} microbatch {item.mb_index} "
                    f"failed {item.retries}x across replica failures "
                    f"(last: {exc!r})"))
            else:
                self.queue.push(item, front=True)
                self._recover_marks.setdefault(item.key, now)

    def _backoff_s(self, consecutive: int) -> float:
        """FULL-JITTER exponential backoff: uniform on [0, min(cap,
        base * 2^(n-1))]. N replicas felled by one event draw
        independent delays instead of respawning in lockstep and
        re-stampeding whatever killed them."""
        cap = min(self.backoff_max_s,
                  self.backoff_base_s * (2 ** (consecutive - 1)))
        if cap <= 0:
            return 0.0
        return float(self._rng.uniform(0.0, cap))

    # -- results ---------------------------------------------------------------

    def results(self, rid: int) -> np.ndarray:
        """(B, 1000) logits of a completed request, or raise its typed
        failure. One-shot like the server's: the entry is evicted."""
        if rid in self._errors:
            err = self._errors.pop(rid)
            self._pending.pop(rid, None)
            self._results.pop(rid, None)
            self._requests.pop(rid, None)
            raise err
        if rid not in self._pending:
            raise KeyError(f"unknown request id {rid}")
        if self._pending[rid] != 0:
            raise ValueError(f"request {rid} incomplete "
                             f"({self._pending[rid]} microbatches "
                             "outstanding); call run() first")
        del self._pending[rid]
        self._requests.pop(rid)
        return np.concatenate(self._results.pop(rid), axis=0)


# --- replica workers ---------------------------------------------------------

@dataclass
class ReplicaWorker:
    """One pipeline replica: the failure domain the tier tracks."""
    idx: int
    server: Any
    permanent_dead: bool = False
    straggler: bool = False
    failures: int = 0
    consecutive_failures: int = 0
    unavailable_until: float = 0.0
    last_heartbeat: float = 0.0
    last_error: Optional[BaseException] = None
    outstanding: dict = field(default_factory=dict)   # key -> WorkItem

    @property
    def alive(self) -> bool:
        return not self.permanent_dead

    def available(self, now: float) -> bool:
        return self.alive and now >= self.unavailable_until


class ServingTier(_TierBase):
    """Front end over R in-process :class:`~repro_torch.launch.serve
    .CNNPipelineServer` replicas on one device: deadline-aware routing,
    health tracking, and drain-and-respawn recovery (see the module
    docstring for the fault model).

    The weights (``params``: native, on the CPU; by default drawn from
    ``seed``) are stored at ``quantize`` and packed into per-stage rows
    on ``device`` ONCE, by the first replica (``param_rows``); every
    replica runs its placed stage programs over those rows under one
    plan, so R replicas hold the weights on the card once. Each replica
    captures its own two tick graphs and replays them on a stream of its
    own, so replicas overlap on the card. ``placed=True`` and
    ``devices=`` raise ``NotImplementedError`` (Queue 1 item 9, second
    half)."""

    def __init__(self, arch: str, *, n_replicas: int = 2,
                 n_stages: int = 4, mb_size: int = 2,
                 image_size: int = 64, seed: int = 0,
                 placed: Optional[bool] = None, devices=None,
                 auto_split: bool = False,
                 param_budget_frac: Optional[float] = None,
                 max_queue_per_tenant: Optional[int] = None,
                 request_timeout_s: Optional[float] = None,
                 max_retries: int = 2, max_respawns: int = 3,
                 backoff_base_s: float = 0.05,
                 backoff_max_s: float = 2.0,
                 max_worker_queue: int = 2,
                 straggler_threshold: float = 2.0,
                 heartbeat_timeout_s: float = 30.0,
                 injectors: Optional[dict] = None,
                 jitter_seed: int = 0,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 quantize: str = "native",
                 verbose: bool = False, device="cuda",
                 params: Optional[dict] = None):
        if heartbeat_timeout_s <= 0:
            raise ValueError(f"heartbeat_timeout_s must be > 0, got "
                             f"{heartbeat_timeout_s}")
        if placed or devices is not None:
            raise NotImplementedError(f"placed=True / devices=: "
                                      f"{_PLACEMENT}")
        from repro_torch.core.device import resolve_device
        from repro_torch.core.quant import quantize_tree
        from repro_torch.launch.serve import _plan_cnn_serving
        dev = resolve_device(device)
        cfg, native, self.plan, n_replicas, _ = _plan_cnn_serving(
            arch, n_stages=n_stages, n_replicas=n_replicas,
            n_microbatches=32, param_budget_frac=param_budget_frac,
            auto_split=auto_split, seed=seed, image_size=image_size,
            store_dtype=quantize, params=params, device=dev)
        self.arch = arch
        self.cfg = cfg
        self.quantize = quantize
        self.device = dev
        # the stored weights on the CPU: the first replica packs them into
        # the rows on the card that every replica then shares
        self.params = quantize_tree(native, quantize)
        self.param_rows = None
        self.mb_size = mb_size
        self.image_size = image_size
        self.seed = seed
        self.placed = False
        self.max_respawns = max_respawns
        self.max_worker_queue = max_worker_queue
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self._init_bookkeeping(
            max_queue_per_tenant=max_queue_per_tenant,
            request_timeout_s=request_timeout_s,
            max_retries=max_retries, backoff_base_s=backoff_base_s,
            backoff_max_s=backoff_max_s, jitter_seed=jitter_seed,
            clock=clock, sleep=sleep, verbose=verbose)
        self.detector = StragglerDetector(threshold=straggler_threshold)
        self.workers: list[ReplicaWorker] = []
        injectors = injectors or {}
        for r in range(n_replicas):
            self._spawn_worker(injector=injectors.get(r))

    # -- worker construction -------------------------------------------------

    def _spawn_worker(self, *, injector=None) -> ReplicaWorker:
        from repro_torch.core.device import deterministic_convs
        from repro_torch.launch.serve import CNNPipelineServer
        idx = len(self.workers)
        with deterministic_convs():          # cuDNN chooses as the workers
            server = CNNPipelineServer(
                self.arch, mb_size=self.mb_size, image_size=self.image_size,
                seed=self.seed, cfg=self.cfg, params=self.params,
                plan=self.plan, injector=injector, quantize=self.quantize,
                device=self.device, param_rows=self.param_rows)
        self.param_rows = server.param_rows
        w = ReplicaWorker(idx=idx, server=server,
                          last_heartbeat=self._clock())
        server.on_result = lambda key, logits, _w=w: \
            self._deliver(_w, key, logits)
        self.workers.append(w)
        return w

    def _purge_worker(self, w: ReplicaWorker, rid: int):
        w.server.purge(lambda k, _r=rid: k[0] == _r)

    # -- health + failure handling -------------------------------------------

    def _check_health(self):
        now = self._clock()
        for w in self.workers:
            if w.alive and (w.outstanding or w.server.busy) and \
                    now - w.last_heartbeat > self.heartbeat_timeout_s:
                self._on_failure(w, RequestTimeoutError(
                    f"replica {w.idx} heartbeat stale "
                    f"({now - w.last_heartbeat:.1f}s > "
                    f"{self.heartbeat_timeout_s}s)"))

    def _on_failure(self, w: ReplicaWorker, exc: BaseException,
                    *, permanent: bool = False):
        """Drain-and-respawn: recover every undelivered microbatch the
        replica held, re-enqueue it (front: it was already admitted),
        and either respawn the replica behind a backoff or retire it."""
        w.failures += 1
        w.consecutive_failures += 1
        w.last_error = exc
        lost = w.server.recover_work()
        items = []
        for key, _n_valid, _imgs in lost:
            item = w.outstanding.pop(key, None)
            if item is not None:
                items.append(item)
        # anything the server no longer knows about but the tier does
        # (defensive: recover_work() is the source of truth)
        items.extend(w.outstanding.values())
        w.outstanding.clear()
        self._requeue_recovered(items, exc)
        if permanent or w.consecutive_failures > self.max_respawns:
            w.permanent_dead = True
            if self.verbose:
                print(f"tier: replica {w.idx} retired permanently "
                      f"({exc!r})")
            return
        w.server.respawn()
        self.respawns += 1
        backoff = self._backoff_s(w.consecutive_failures)
        w.unavailable_until = self._clock() + backoff
        if self.verbose:
            print(f"tier: replica {w.idx} respawned after {exc!r}, "
                  f"backoff {backoff:.3f}s")

    # -- routing + the serving loop ------------------------------------------

    def _pick_worker(self) -> Optional[ReplicaWorker]:
        now = self._clock()
        avail = [w for w in self.workers if w.available(now) and
                 len(w.outstanding) <
                 w.server.n_stages + self.max_worker_queue]
        if not avail:
            return None
        pref = [w for w in avail if not w.straggler] or avail
        return min(pref, key=lambda w: (len(w.outstanding), w.idx))

    def _dispatch(self):
        while len(self.queue):
            w = self._pick_worker()
            if w is None:
                return
            item = self.queue.pop()
            if item is None:
                return
            w.outstanding[item.key] = item
            w.server.enqueue(item.key, item.images,
                             n_valid=item.n_valid)

    def _tick_worker(self, w: ReplicaWorker) -> bool:
        t0 = time.perf_counter()
        try:
            ticked = w.server._tick_once()
        except Exception as e:            # noqa: BLE001 — fault domain
            self._on_failure(w, e)
            return False
        w.last_heartbeat = self._clock()
        w.consecutive_failures = 0
        if ticked:
            w.straggler = self.detector.record(
                w.idx, w.server.ticks, time.perf_counter() - t0)
        return ticked

    def run(self, *, max_rounds: Optional[int] = None) -> dict:
        """Drive the fleet until every admitted request is delivered or
        shed (or ``max_rounds`` scheduler rounds elapse — the hook
        tests use to interrupt a stream mid-flight). Raises
        :class:`NoHealthyReplicaError` if work remains while every
        replica is permanently dead."""
        t0 = self._clock()
        done_before = len(self._completed)
        rounds = 0
        while True:
            self._check_timeouts()
            self._check_health()
            if not self._live_rids():
                break
            if not any(w.alive for w in self.workers):
                raise NoHealthyReplicaError(
                    f"all {len(self.workers)} replicas permanently "
                    f"dead with requests {self._live_rids()} pending "
                    f"(last error: {self.workers[-1].last_error!r})")
            self._dispatch()
            now = self._clock()
            busy = [w for w in self.workers
                    if w.alive and w.server.busy]
            ready = [w for w in busy if w.available(now)]
            if not ready:
                if busy or len(self.queue):
                    # every holder of work is backing off — wait out
                    # the earliest backoff rather than spinning
                    alive = [w for w in self.workers if w.alive]
                    wake = min(w.unavailable_until for w in alive)
                    self._sleep(max(0.0, min(wake - now, 1.0)))
                    continue
                break
            for w in ready:
                self._tick_worker(w)
            rounds += 1
            if max_rounds is not None and rounds >= max_rounds:
                break
        elapsed = self._clock() - t0
        completed = self._completed[done_before:]
        lats = [self._requests[r].done_at - self._requests[r].submitted_at
                for r in completed]
        images = sum(self._requests[r].n_images for r in completed)
        metrics = {
            "completed": len(completed),
            "failed": len(self._errors),
            "images": images,
            "elapsed_s": elapsed,
            "images_per_s": images / max(elapsed, 1e-9),
            "rounds": rounds,
            "respawns": self.respawns,
            "recovered_microbatches": self.recovered_microbatches,
            "retried_microbatches": self.retried_microbatches,
            "latency_p50_s": float(np.percentile(lats, 50)) if lats
            else None,
            "latency_p99_s": float(np.percentile(lats, 99)) if lats
            else None,
            "replica_ticks": [w.server.ticks for w in self.workers],
            "replicas_alive": sum(w.alive for w in self.workers),
            "stragglers": list(self.detector.flagged),
        }
        if self.verbose:
            print(f"tier: {metrics['completed']} requests "
                  f"({images} imgs) in {elapsed:.2f}s, "
                  f"{metrics['failed']} failed, "
                  f"{self.respawns} respawns, "
                  f"{metrics['replicas_alive']} replicas alive")
        return metrics

    # -- permanent device loss + degradation ---------------------------------

    def lose_devices(self, lost) -> dict:
        """Permanent device loss re-plans a placed tier onto the
        surviving devices: not ported (Queue 1 item 9, second half)."""
        raise NotImplementedError(f"lose_devices: {_PLACEMENT}")

    def _remesh_buffer(self, donor, devs, s):
        raise NotImplementedError(f"_remesh_buffer: {_PLACEMENT}")


# --- cross-process serving: OS-process replica workers -----------------------

class _WorkerFatal(Exception):
    """A worker reported an application-level exception before dying
    (internal: converted to a replica failure by the supervisor)."""


@dataclass
class ProcWorker:
    """One OS-process pipeline replica: the hard failure domain the
    cross-process tier supervises. ``generation`` counts respawns (log
    files and fault hooks are per-generation); ``detected_via``
    records HOW the last death was noticed — ``"exit"`` (waitpid),
    ``"transport"`` (channel EOF), ``"heartbeat"`` (liveness
    timeout — the wedged-process path), or ``"fatal"`` (the worker
    reported its own exception before dying)."""
    idx: int
    proc: Any = None
    channel: Any = None
    pid: Optional[int] = None
    generation: int = 0
    ready: bool = False
    spawned_at: float = 0.0
    permanent_dead: bool = False
    straggler: bool = False
    failures: int = 0
    consecutive_failures: int = 0
    unavailable_until: float = 0.0
    last_error: Optional[BaseException] = None
    exit_code: Optional[int] = None
    detected_via: Optional[str] = None
    log_path: Optional[str] = None
    missed_seen: int = 0
    capabilities: Optional[dict] = None   # cross-host: register report
    outstanding: dict = field(default_factory=dict)   # key -> WorkItem

    @property
    def alive(self) -> bool:
        return not self.permanent_dead

    def available(self, now: float) -> bool:
        return self.alive and self.ready and \
            now >= self.unavailable_until


class ProcessServingTier(_TierBase):
    """Supervisor over N replica workers running as REAL OS processes
    (:mod:`repro_torch.runtime.worker` children over the framed transport
    of :mod:`repro_torch.runtime.transport`) — the cross-process promotion of
    :class:`ServingTier`, same request API, hard fault domains.

    What changes across the process boundary:

    - **Liveness is observed, not assumed.** Workers heartbeat
      ``(last completed tick)`` every ``heartbeat_interval_s``; the
      supervisor's :class:`~repro_torch.runtime.fault.FailureDetector` bands
      silence/stall into alive / suspect (straggler: deprioritized by
      the router, never killed) / dead (drain-and-respawn). A SIGKILL
      is additionally caught immediately via ``waitpid`` or channel
      EOF; a SIGSTOP'd (wedged) worker is only catchable via the
      heartbeat band — that path is the tentpole.
    - **Recovery replays from the supervisor-side ledger.** Every
      dispatched microbatch stays in ``w.outstanding`` (its padded
      chunk included) until its logits land, so a worker that dies at
      ANY instant — even mid-tick, holding half-computed state — loses
      nothing: the supervisor re-enqueues the chunks and a healthy
      worker recomputes them. Logits are a pure function of
      (chunk, cfg, params, plan), and every worker loads the identical
      param blob and derives the identical plan, so the recovered
      stream is BITWISE equal to the no-failure run.
    - **The ledger can outlive the supervisor.** With ``ledger_dir``
      set, undelivered chunks + delivered logits persist through
      :func:`repro_torch.checkpoint.ckpt.save_ledger` (crash-safe pointer
      swap) on every state change; a NEW tier pointed at the same
      directory resumes the stream where the dead supervisor left it.

    Workers share weights through one memory-mapped packed param blob
    (written once by the supervisor; the OS page cache shares the
    physical pages), so N processes cost one model's host RAM.

    On the card (``device="cuda"``) the supervisor builds the kernels
    before it starts any worker (N workers would otherwise run ``nvcc``
    at once and miss ``ready``); each worker is its own process with its
    own CUDA context, started by exec, and captures its tick graphs and
    warms up before it reports ``ready``. Logits come back as numpy
    arrays. ``params``: the native weights on the CPU (default: drawn
    from ``seed``); each worker reads them from the blob.
    ``ready_times`` records each worker generation's spawn-to-ready
    seconds and the kernel launches it counted up to ``ready`` (its
    warm-up and captures)."""

    def __init__(self, arch: str, *, n_procs: int = 2,
                 n_stages: int = 2, mb_size: int = 2,
                 image_size: int = 32, seed: int = 0,
                 max_queue_per_tenant: Optional[int] = None,
                 request_timeout_s: Optional[float] = None,
                 max_retries: int = 2, max_respawns: int = 3,
                 backoff_base_s: float = 0.05,
                 backoff_max_s: float = 2.0,
                 max_worker_queue: int = 2,
                 heartbeat_interval_s: float = 0.1,
                 suspect_after_s: Optional[float] = 0.5,
                 dead_after_s: Optional[float] = 10.0,
                 spawn_timeout_s: float = 300.0,
                 io_deadline_s: float = 60.0,
                 max_frame: int = transport.DEFAULT_MAX_FRAME,
                 worker_hooks: Optional[dict] = None,
                 ledger_dir: Optional[str] = None,
                 jitter_seed: int = 0,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 quantize: str = "native",
                 verbose: bool = False, device="cuda",
                 params: Optional[dict] = None):
        # liveness config validates FIRST: a bad threshold set must be
        # a cheap loud ValueError, not a failure after N process spawns
        self.detector = FailureDetector(
            interval_s=heartbeat_interval_s,
            suspect_after_s=suspect_after_s, dead_after_s=dead_after_s)
        if n_procs < 1:
            raise ValueError(f"n_procs must be >= 1, got {n_procs}")
        from repro_torch.configs import get_config
        from repro_torch.core import planner
        from repro_torch.core.device import resolve_device
        from repro_torch.core.quant import quantize_tree
        from repro_torch.launch.serve import _init_native
        from repro_torch.runtime import worker as worker_mod
        cfg = get_config(arch)
        if cfg.family != "cnn":
            raise ValueError(f"{arch} is not a CNN arch")
        self.device = resolve_device(device)
        self.arch = arch
        self.cfg = cfg
        self.seed = seed
        self.mb_size = mb_size
        self.image_size = image_size
        self.quantize = quantize
        # quantize ONCE, supervisor-side, and ship the stored leaves in
        # the blob: every worker maps the same codes and scales, and N
        # processes page-cache ONE int8 model
        self.params = quantize_tree(
            params if params is not None else _init_native(cfg, seed),
            quantize)
        self.plan = planner.plan(cfg, self.params, planner.PlanRequest(
            n_stages=n_stages, store_dtype=quantize))
        self.max_respawns = max_respawns
        self.max_worker_queue = max_worker_queue
        self.spawn_timeout_s = spawn_timeout_s
        self.io_deadline_s = io_deadline_s
        self.max_frame = max_frame
        self.ledger_dir = ledger_dir
        self.worker_hooks = dict(worker_hooks or {})
        self._init_bookkeeping(
            max_queue_per_tenant=max_queue_per_tenant,
            request_timeout_s=request_timeout_s,
            max_retries=max_retries, backoff_base_s=backoff_base_s,
            backoff_max_s=backoff_max_s, jitter_seed=jitter_seed,
            clock=clock, sleep=sleep, verbose=verbose)
        # supervisor-only counters (the process tier's observability)
        self.missed_heartbeats = 0
        self.worker_exits: list[dict] = []
        self.straggler_events: list[tuple] = []
        self.ready_times: list[dict] = []
        if self.device.type == "cuda":
            from repro_torch.kernels import _build
            _build.build_all()
        self._dir = tempfile.mkdtemp(prefix="hpipe-proctier-")
        self._blob = worker_mod.write_param_blob(
            self.params, os.path.join(self._dir, "params.blob"))
        self.workers: list[ProcWorker] = []
        for i in range(n_procs):
            w = ProcWorker(idx=i)
            self.workers.append(w)
            self._spawn_proc(w)
        try:
            self._wait_ready()
        except Exception:
            self.close()
            raise
        if self.ledger_dir is not None:
            self._resume_from_ledger()

    # -- process lifecycle ---------------------------------------------------

    def _worker_args(self) -> list[str]:
        """The CLI args every replica worker shares, whichever
        transport carries them — the worker re-derives the plan from
        these, so they ARE the bitwise contract."""
        return ["--arch", self.arch,
                "--stages", str(self.plan["n_stages"]),
                "--mb-size", str(self.mb_size),
                "--image-size", str(self.image_size),
                "--seed", str(self.seed),
                "--quantize", self.quantize,
                "--max-frame", str(self.max_frame),
                "--heartbeat-interval", str(self.detector.interval_s),
                "--io-deadline", str(self.io_deadline_s),
                "--device", str(self.device)]

    def _hook_args(self, w: ProcWorker) -> list[str]:
        """Fault hooks (--kill-at-tick / --stop-at-tick) arm only on
        generation 0 — a respawned worker must come back healthy."""
        hook = self.worker_hooks.get(w.idx) \
            if w.generation == 0 else None
        args = []
        if hook:
            if "kill_at_tick" in hook:
                args += ["--kill-at-tick", str(hook["kill_at_tick"])]
            if "stop_at_tick" in hook:
                args += ["--stop-at-tick", str(hook["stop_at_tick"])]
        return args

    def _launch(self, w: ProcWorker, cmd: list[str], *, pass_fds=()):
        """Start one worker interpreter (exec, not fork) with the
        repro_torch package on its path and a per-generation log file."""
        env = dict(os.environ)
        import repro_torch
        src = os.path.dirname(os.path.dirname(
            os.path.abspath(repro_torch.__file__)))
        env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
        w.log_path = os.path.join(
            self._dir, f"worker-{w.idx}-g{w.generation}.log")
        with open(w.log_path, "ab") as logf:
            w.proc = subprocess.Popen(
                cmd, pass_fds=pass_fds, env=env,
                stdin=subprocess.DEVNULL, stdout=logf, stderr=logf,
                close_fds=True)
        w.pid = w.proc.pid
        w.ready = False
        w.missed_seen = 0
        w.spawned_at = self._clock()
        if self.verbose:
            print(f"tier: spawned worker {w.idx} gen {w.generation} "
                  f"pid {w.pid}")

    def _spawn_proc(self, w: ProcWorker):
        """Fork one replica worker over a fresh socketpair."""
        sup, child = socket.socketpair()
        cmd = [sys.executable, "-m", "repro_torch.runtime.worker",
               "--fd", str(child.fileno()),
               "--param-blob", self._blob] \
            + self._worker_args() + self._hook_args(w)
        self._launch(w, cmd, pass_fds=(child.fileno(),))
        child.close()
        w.channel = transport.Channel(sup, max_frame=self.max_frame)

    def _log_tail(self, w: ProcWorker, n: int = 12) -> str:
        try:
            with open(w.log_path, "rb") as f:
                return b"\n".join(
                    f.read().splitlines()[-n:]).decode(errors="replace")
        except OSError:
            return "<no worker log>"

    def _wait_ready(self):
        """Block until every worker has built + warmed its pipeline
        and reported ready (startup only; respawns re-arm async)."""
        deadline = self._clock() + self.spawn_timeout_s
        while True:
            pend = [w for w in self.workers
                    if w.alive and not w.ready]
            if not pend:
                return
            for w in pend:
                rc = w.proc.poll()
                if rc is not None:
                    self._pump(w)     # surface a ("fatal", ...) if sent
                    raise RuntimeError(
                        f"worker {w.idx} died during startup "
                        f"(exit {rc}); log tail:\n{self._log_tail(w)}")
            if self._clock() > deadline:
                raise RuntimeError(
                    f"workers {[w.idx for w in pend]} not ready within "
                    f"spawn_timeout_s={self.spawn_timeout_s}s; log "
                    f"tail of worker {pend[0].idx}:\n"
                    f"{self._log_tail(pend[0])}")
            r, _, _ = select.select([w.channel for w in pend], [], [],
                                    0.25)
            for ch in r:
                self._pump(next(w for w in pend if w.channel is ch))

    def kill_worker(self, idx: int, sig: int = signal.SIGKILL):
        """Deliver a signal to one worker process (fault injection
        from outside: ``launch/serve.py --kill-worker``, tests,
        benchmarks)."""
        os.kill(self.workers[idx].pid, sig)

    def close(self):
        """Stop every worker (graceful ``stop``, then SIGKILL; a worker
        still starting up has nothing to finish and is killed at once)
        and release the channels + scratch dir. Idempotent."""
        for w in self.workers:
            if w.proc is None or w.proc.poll() is not None:
                continue
            if w.ready and w.channel is not None:
                try:
                    w.channel.send(("stop",), deadline_s=1.0)
                except Exception:            # noqa: BLE001 best effort
                    pass
            else:
                w.proc.kill()
        for w in self.workers:
            if w.proc is not None:
                try:
                    w.proc.wait(timeout=5.0)
                except Exception:            # noqa: BLE001
                    try:
                        w.proc.kill()
                        w.proc.wait(timeout=5.0)
                    except Exception:        # noqa: BLE001
                        pass
            if w.channel is not None:
                w.channel.close()
        import shutil
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- supervisor-side message handling ------------------------------------

    def _handle_msg(self, w: ProcWorker, m):
        tag = m[0]
        now = self._clock()
        if tag == "ready":
            w.ready = True
            w.pid = m[1]
            w.missed_seen = 0
            self.detector.reset(w.idx, now)
            self.ready_times.append({
                "idx": w.idx, "generation": w.generation,
                "seconds": now - w.spawned_at,
                "launches": m[2] if len(m) > 2 else None})
        elif tag == "hb":
            w.missed_seen = 0
            self.detector.beat(w.idx, now, m[1])
        elif tag == "result":
            w.consecutive_failures = 0
            self.detector.beat(w.idx, now, -1)   # results ARE liveness
            self._deliver(w, tuple(m[1]), m[2])
            self._save_ledger()
        elif tag == "fatal":
            raise _WorkerFatal(m[1], m[2] if len(m) > 2 else "")
        else:
            raise _WorkerFatal(f"unknown message tag {tag!r}", "")

    def _pump(self, w: ProcWorker):
        """Deliver every message the worker has sent; convert channel
        death / a fatal report into a replica failure."""
        if w.channel is None or not w.alive:
            return
        try:
            for m in w.channel.drain():
                self._handle_msg(w, m)
        except _WorkerFatal as e:
            self._fail_proc(w, "fatal", ReplicaFailedError(
                f"replica {w.idx} raised in-worker: {e.args[0]}\n"
                f"{e.args[1]}"))
        except transport.TransportError as e:
            self._fail_proc(w, "transport", ReplicaFailedError(
                f"replica {w.idx} channel failed: {e!r}"))

    # -- failure detection + drain-and-respawn -------------------------------

    def _reap_and_detect(self):
        """One supervisor health sweep: deliver pending messages, reap
        exited processes, classify heartbeat silence/stall into the
        straggler band or death."""
        now = self._clock()
        for w in self.workers:
            if not w.alive:
                continue
            # drain FIRST: results a dying worker already emitted must
            # land before its remaining work is declared lost
            self._pump(w)
            if not w.alive or w.proc is None:
                continue
            rc = w.proc.poll()
            if rc is not None:
                self._fail_proc(w, "exit", ReplicaFailedError(
                    f"replica {w.idx} (pid {w.pid}) exited with "
                    f"{rc}"))
                continue
            if not w.ready:
                if now - w.spawned_at > self.spawn_timeout_s:
                    self._fail_proc(w, "spawn-timeout",
                                    ReplicaFailedError(
                                        f"replica {w.idx} never "
                                        f"reported ready within "
                                        f"{self.spawn_timeout_s}s"))
                continue
            missed = self.detector.missed(w.idx, now)
            if missed > w.missed_seen:
                self.missed_heartbeats += missed - w.missed_seen
                w.missed_seen = missed
            state = self.detector.state(w.idx, now,
                                        busy=bool(w.outstanding))
            if state == "dead":
                self._fail_proc(w, "heartbeat", ReplicaFailedError(
                    f"replica {w.idx} (pid {w.pid}) silent/stalled "
                    f"past dead_after_s="
                    f"{self.detector.dead_after_s}s "
                    f"({missed} heartbeats missed) — wedged or dead"))
            elif state == "suspect":
                if not w.straggler:
                    w.straggler = True
                    self.straggler_events.append(
                        (w.idx, w.generation, missed))
                    if self.verbose:
                        print(f"tier: replica {w.idx} suspected "
                              f"straggler ({missed} heartbeats "
                              "missed) — deprioritized, not killed")
            else:
                w.straggler = False

    def _fail_proc(self, w: ProcWorker, via: str, exc: TierError,
                   *, permanent: bool = False):
        """Terminate + reap one worker process, record how the death
        was detected, then run drain-and-respawn on its ledger."""
        rc = w.proc.poll() if w.proc is not None else None
        if rc is not None:
            w.exit_code = rc
            if via == "transport":
                via = "exit"          # EOF because the process is gone
        elif w.proc is not None:
            try:                      # SIGKILL reaps SIGSTOP'd corpses
                w.proc.kill()         # too (the wedged-worker path)
                w.exit_code = w.proc.wait(timeout=10.0)
            except Exception:         # noqa: BLE001
                pass
        w.detected_via = via
        self.worker_exits.append(
            {"idx": w.idx, "generation": w.generation, "pid": w.pid,
             "exit_code": w.exit_code, "detected_via": via})
        if w.channel is not None:
            w.channel.close()
            w.channel = None
        self._on_proc_failure(w, exc, permanent=permanent)

    def _on_proc_failure(self, w: ProcWorker, exc: TierError,
                         *, permanent: bool = False):
        w.failures += 1
        w.consecutive_failures += 1
        w.last_error = exc
        w.ready = False
        w.straggler = False
        items = sorted(w.outstanding.values(), key=lambda it: it.seq)
        w.outstanding.clear()
        self._requeue_recovered(items, exc)
        if permanent or w.consecutive_failures > self.max_respawns:
            w.permanent_dead = True
            if self.verbose:
                print(f"tier: replica {w.idx} retired permanently "
                      f"({exc!r})")
            self._save_ledger()
            return
        w.generation += 1
        self._spawn_proc(w)           # async: usable once "ready" lands
        self.respawns += 1
        w.unavailable_until = self._clock() + \
            self._backoff_s(w.consecutive_failures)
        self._save_ledger()
        if self.verbose:
            print(f"tier: replica {w.idx} respawning (gen "
                  f"{w.generation}) after {exc!r}")

    def _purge_worker(self, w: ProcWorker, rid: int):
        if w.alive and w.ready and w.channel is not None:
            try:
                w.channel.send(("purge", rid), deadline_s=1.0)
            except transport.TransportError:
                pass                  # its death sweep will handle it

    # -- routing + the serving loop ------------------------------------------

    def _pick_worker(self) -> Optional[ProcWorker]:
        now = self._clock()
        bound = self.plan["n_stages"] + self.max_worker_queue
        avail = [w for w in self.workers if w.available(now) and
                 len(w.outstanding) < bound]
        if not avail:
            return None
        pref = [w for w in avail if not w.straggler] or avail
        return min(pref, key=lambda w: (len(w.outstanding), w.idx))

    def _dispatch(self):
        while len(self.queue):
            w = self._pick_worker()
            if w is None:
                return
            item = self.queue.pop()
            if item is None:
                return
            try:
                w.channel.send(("work", item.key, item.images,
                                item.n_valid),
                               deadline_s=self.io_deadline_s)
            except transport.TransportError as e:
                self.queue.push(item, front=True)
                self._fail_proc(w, "transport", ReplicaFailedError(
                    f"replica {w.idx} send failed: {e!r}"))
                continue
            if not w.outstanding:        # idle until now: not a stall
                self.detector.work_started(w.idx, self._clock())
            w.outstanding[item.key] = item

    def _wait_events(self, timeout_s: float):
        chans = [w.channel for w in self.workers
                 if w.alive and w.channel is not None]
        if not chans:
            self._sleep(timeout_s)
            return
        r, _, _ = select.select(chans, [], [], max(timeout_s, 0.0))
        for ch in r:
            w = next(w for w in self.workers if w.channel is ch)
            self._pump(w)

    def run(self, *, max_rounds: Optional[int] = None) -> dict:
        """Drive the fleet until every admitted request is delivered
        or shed (or ``max_rounds`` supervisor rounds elapse). Raises
        :class:`NoHealthyReplicaError` on a tier-wide outage."""
        t0 = self._clock()
        done_before = len(self._completed)
        rounds = 0
        while True:
            self._check_timeouts()
            self._reap_and_detect()
            if not self._live_rids():
                break
            if not any(w.alive for w in self.workers):
                raise NoHealthyReplicaError(
                    f"all {len(self.workers)} replica processes "
                    f"permanently dead with requests "
                    f"{self._live_rids()} pending (last error: "
                    f"{self.workers[-1].last_error!r})")
            self._dispatch()
            # half the heartbeat interval: fast enough to never be the
            # detector's bottleneck, slow enough to not busy-spin
            self._wait_events(self.detector.interval_s / 2.0)
            rounds += 1
            if max_rounds is not None and rounds >= max_rounds:
                break
        elapsed = self._clock() - t0
        completed = self._completed[done_before:]
        lats = [self._requests[r].done_at - self._requests[r].submitted_at
                for r in completed if r in self._requests]
        images = sum(self._requests[r].n_images for r in completed
                     if r in self._requests)
        metrics = {
            "completed": len(completed),
            "failed": len(self._errors),
            "images": images,
            "elapsed_s": elapsed,
            "images_per_s": images / max(elapsed, 1e-9),
            "rounds": rounds,
            "respawns": self.respawns,
            "recovered_microbatches": self.recovered_microbatches,
            "retried_microbatches": self.retried_microbatches,
            "missed_heartbeats": self.missed_heartbeats,
            "worker_exits": list(self.worker_exits),
            "straggler_events": list(self.straggler_events),
            "latency_p50_s": float(np.percentile(lats, 50)) if lats
            else None,
            "latency_p99_s": float(np.percentile(lats, 99)) if lats
            else None,
            # detection-to-first-recovered-emit (the supervisor cannot
            # observe the kill instant itself; benchmarks measure the
            # outer kill-to-emit wall clock around this)
            "recovery_s": self.recovery_times[0]
            if self.recovery_times else None,
            "recovery_times_s": list(self.recovery_times),
            "replicas_alive": sum(w.alive for w in self.workers),
            "replica_pids": [w.pid for w in self.workers],
        }
        if self.verbose:
            print(f"tier[proc]: {metrics['completed']} requests "
                  f"({images} imgs) in {elapsed:.2f}s, "
                  f"{metrics['failed']} failed, "
                  f"{self.respawns} respawns, "
                  f"{self.missed_heartbeats} heartbeats missed")
        return metrics

    # -- supervisor ledger persistence ---------------------------------------

    def submit(self, images, **kw) -> int:
        """:meth:`_TierBase.submit`, then the ledger saved: a request is
        in the ledger from its admission, so a supervisor that dies
        before any of its results lands loses nothing (the reference
        saves at the first result or failure)."""
        rid = super().submit(images, **kw)
        self._save_ledger()
        return rid

    def _save_ledger(self):
        """Persist the replay ledger (crash-safe pointer swap): every
        live request's undelivered padded chunks + delivered logits.
        A supervisor that dies between any two syscalls leaves a
        loadable ledger a fresh tier resumes from."""
        if self.ledger_dir is None:
            return
        from repro_torch.checkpoint import ckpt
        arrays = {}
        reqs = {}
        for rid, req in self._requests.items():
            if rid in self._errors:
                continue
            reqs[str(rid)] = {
                "tenant": req.tenant, "priority": req.priority,
                "n_images": req.n_images, "n_mb": req.n_mb,
                "n_valid": {}, "done": self._pending.get(rid) == 0,
            }
            for mb, logits in enumerate(self._results.get(rid, [])):
                if logits is not None:
                    arrays[f"logits_{rid}_{mb}"] = logits
        undelivered = []
        for q in self.queue._q.values():
            undelivered.extend(q)
        for w in self.workers:
            undelivered.extend(w.outstanding.values())
        for item in undelivered:
            meta = reqs.get(str(item.rid))
            if meta is None:
                continue
            arrays[f"chunk_{item.rid}_{item.mb_index}"] = item.images
            meta["n_valid"][str(item.mb_index)] = item.n_valid
        ckpt.save_ledger(self.ledger_dir,
                         {"next_rid": self._next_rid,
                          "next_seq": self._next_seq,
                          "requests": reqs},
                         arrays)

    def _resume_from_ledger(self):
        """Adopt a prior supervisor's ledger: completed microbatches
        keep their recorded logits, undelivered chunks re-enter the
        dispatch queue — the resumed stream finishes bitwise equal to
        an uninterrupted one."""
        from repro_torch.checkpoint import ckpt
        rec = ckpt.load_ledger(self.ledger_dir)
        if rec is None:
            return
        meta, arrays = rec
        self._next_rid = int(meta["next_rid"])
        self._next_seq = int(meta["next_seq"])
        now = self._clock()
        for rid_s, r in meta["requests"].items():
            rid = int(rid_s)
            n_mb = int(r["n_mb"])
            req = ImageRequest(rid=rid, tenant=r["tenant"],
                               priority=int(r["priority"]),
                               submitted_at=now,
                               n_images=int(r["n_images"]), n_mb=n_mb)
            self._requests[rid] = req
            self._results[rid] = [None] * n_mb
            npend = 0
            for mb in range(n_mb):
                lk = f"logits_{rid}_{mb}"
                if lk in arrays:
                    self._results[rid][mb] = arrays[lk]
                    continue
                npend += 1
                self._next_seq += 1
                self.queue.push(WorkItem(
                    rid=rid, mb_index=mb,
                    n_valid=int(r["n_valid"][str(mb)]),
                    images=np.asarray(arrays[f"chunk_{rid}_{mb}"],
                                      np.float32),
                    tenant=r["tenant"], priority=int(r["priority"]),
                    seq=self._next_seq))
            self._pending[rid] = npend
            if npend == 0:
                req.done_at = now
                self._completed.append(rid)
        if self.verbose:
            print(f"tier[proc]: resumed {len(meta['requests'])} "
                  f"request(s) from ledger at {self.ledger_dir}")


# --- cross-host serving: workers dial in over TCP ----------------------------

class _PendingConn:
    """One accepted-but-unregistered inbound connection, advancing
    through ``hello`` (handshake) → ``register`` (blob fetch + slot
    claim) before it is bound to a :class:`ProcWorker` slot."""

    def __init__(self, ch, now: float):
        self.ch = ch
        self.state = "hello"
        self.since = now


class HostServingTier(ProcessServingTier):
    """The cross-host promotion of :class:`ProcessServingTier`: the
    same supervisor semantics (heartbeat failure detector, bitwise
    drain-and-respawn, crash-safe ledger), but workers **dial in over
    TCP** instead of inheriting a socketpair fd — nothing about the
    tier assumes a shared kernel or a shared filesystem anymore.

    What the host boundary changes:

    - **Discovery is dial-in registration, not fork-time wiring.** The
      supervisor listens (:class:`~repro_torch.runtime.transport.Listener`);
      each worker connects, handshakes (protocol version + model/plan
      fingerprint — a worker from a different build or configured for
      different weights is refused with a typed ``HandshakeError``
      before any work is routed), then registers its slot token with a
      **capability report** (device count, mapped blob hash). Only an
      admitted worker enters the :class:`FailureDetector` machinery;
      everything after admission — heartbeats, suspect/dead banding,
      respawn — is the inherited supervisor, unchanged.
    - **Params travel by content hash.** There is no shared path to
      memmap: workers request the packed blob by SHA-256 over the
      channel (chunked, each chunk CRC-framed; resumable — a transfer
      cut by a connection loss resumes from the cached partial on the
      next attempt) and verify the hash before warmup, so a torn or
      stale blob is a typed ``CheckpointCorruptError``, never wrong
      logits.
    - **The network is now a fault domain.** A severed direction (one-
      way partition) starves heartbeats → suspect → dead →
      drain-and-respawn, without wedging the tick loop: recovery after
      a mid-tick connection kill replays the supervisor-side ledger
      bitwise, exactly as the process tier does.
      :class:`~repro_torch.runtime.fault.NetFaultProxy` injects these faults
      in tests.

    By default the tier spawns its workers as local child processes
    that dial ``127.0.0.1`` (the test/CI topology — same protocol,
    loopback wire); ``dial_addrs`` reroutes individual workers through
    a proxy, and a worker started BY HAND on another machine with
    ``python -m repro_torch.runtime.worker --dial host:port --token i
    --blob-sha …`` joins identically, because the supervisor never
    looks past the channel."""

    def __init__(self, arch: str, *,
                 listen: tuple[str, int] = ("127.0.0.1", 0),
                 dial_addrs: Optional[dict] = None,
                 blob_chunk_bytes: int = 4 * 1024 * 1024,
                 handshake_timeout_s: float = 60.0,
                 max_frame: int = transport.DEFAULT_MAX_FRAME,
                 **kw):
        if blob_chunk_bytes <= 0 or \
                blob_chunk_bytes + 4096 > max_frame:
            raise ValueError(
                f"blob_chunk_bytes ({blob_chunk_bytes}) must be > 0 "
                f"and leave frame headroom under max_frame "
                f"({max_frame})")
        # listener first: spawned workers dial it immediately
        self.listener = transport.Listener(
            listen[0], listen[1], max_frame=max_frame)
        self._dial_addrs = dict(dial_addrs or {})
        self.blob_chunk_bytes = blob_chunk_bytes
        self.handshake_timeout_s = handshake_timeout_s
        self._pending_conns: list[_PendingConn] = []
        self._blob_sha: Optional[str] = None
        self._fingerprint: Optional[str] = None
        self.blob_bytes_served = 0
        self.rejected_connections: list[str] = []
        try:
            super().__init__(arch, max_frame=max_frame, **kw)
        except BaseException:
            for pc in self._pending_conns:
                pc.ch.close()
            self.listener.close()
            raise

    @property
    def address(self) -> tuple[str, int]:
        """The (host, port) workers dial — advertise this."""
        return self.listener.address

    # -- worker launch (dial-in, no inherited fd) -----------------------------

    def _spawn_proc(self, w: ProcWorker):
        if self._blob_sha is None:
            from repro_torch.checkpoint import ckpt
            from repro_torch.runtime import worker as worker_mod
            self._blob_sha = ckpt.file_sha256(self._blob)
            self._fingerprint = worker_mod.serving_fingerprint(
                arch=self.arch, stages=self.plan["n_stages"],
                mb_size=self.mb_size, image_size=self.image_size,
                seed=self.seed, quantize=self.quantize,
                blob_sha256=self._blob_sha, device=str(self.device))
        host, port = self._dial_addrs.get(w.idx, self.listener.address)
        cmd = [sys.executable, "-m", "repro_torch.runtime.worker",
               "--dial", f"{host}:{port}",
               "--token", str(w.idx),
               "--blob-sha", self._blob_sha,
               # per-SLOT cache: generation g+1 resumes the partial
               # transfer generation g died holding, while two slots
               # never race on one .part file
               "--blob-cache",
               os.path.join(self._dir, f"blobcache-{w.idx}")] \
            + self._worker_args() + self._hook_args(w)
        self._launch(w, cmd)
        w.channel = None          # bound at registration, not at fork

    # -- inbound connections: accept → handshake → register -------------------

    def _reject_pending(self, pc: _PendingConn, reason: str):
        self.rejected_connections.append(reason)
        try:
            pc.ch.send(("reject", reason), deadline_s=1.0)
        except transport.TransportError:
            pass
        pc.ch.close()
        if pc in self._pending_conns:
            self._pending_conns.remove(pc)
        if self.verbose:
            print(f"tier[host]: rejected connection: {reason}")

    def _serve_blob_chunk(self, pc: _PendingConn, m):
        _tag, sha, offset = m
        if sha != self._blob_sha:
            pc.ch.send(("blobreject",
                        f"blob {str(sha)[:16]}… unknown (serving "
                        f"{self._blob_sha[:16]}…)"),
                       deadline_s=self.io_deadline_s)
            return
        total = os.path.getsize(self._blob)
        offset = max(0, int(offset))
        with open(self._blob, "rb") as f:
            f.seek(offset)
            data = f.read(self.blob_chunk_bytes)
        pc.ch.send(("blobchunk", offset, total, data),
                   deadline_s=self.io_deadline_s)
        self.blob_bytes_served += len(data)

    def _admit(self, pc: _PendingConn, m):
        """Bind a registering connection to its worker slot iff its
        token names a live, unbound slot and its capability report
        proves it mapped the exact planned blob."""
        if not (isinstance(m, tuple) and len(m) == 3):
            return self._reject_pending(pc, f"malformed register {m!r}")
        _tag, token, caps = m
        if not isinstance(token, int) or \
                not (0 <= token < len(self.workers)):
            return self._reject_pending(
                pc, f"unknown worker token {token!r}")
        w = self.workers[token]
        if not w.alive:
            return self._reject_pending(
                pc, f"worker slot {token} is permanently retired")
        if w.channel is not None:
            return self._reject_pending(
                pc, f"worker slot {token} is already bound")
        got_sha = (caps or {}).get("blob_sha256")
        if got_sha != self._blob_sha:
            return self._reject_pending(
                pc, f"capability report blob {str(got_sha)[:16]}… != "
                    f"planned blob {self._blob_sha[:16]}…")
        try:
            pc.ch.send(("admit",), deadline_s=self.io_deadline_s)
        except transport.TransportError as e:
            self.rejected_connections.append(
                f"admit send failed: {e!r}")
            pc.ch.close()
            self._pending_conns.remove(pc)
            return
        w.channel = pc.ch
        w.capabilities = dict(caps)
        self._pending_conns.remove(pc)
        if self.verbose:
            print(f"tier[host]: worker {token} registered "
                  f"(gen {w.generation}, caps {caps})")

    def _pump_pending(self, pc: _PendingConn):
        try:
            msgs = pc.ch.drain()
        except transport.TransportError as e:
            self.rejected_connections.append(
                f"pending connection dropped: {e!r}")
            pc.ch.close()
            if pc in self._pending_conns:
                self._pending_conns.remove(pc)
            return
        for m in msgs:
            if pc not in self._pending_conns:
                return                    # bound or rejected mid-batch
            try:
                if pc.state == "hello":
                    try:
                        reply = transport.check_hello(
                            m, fingerprint=self._fingerprint)
                    except transport.HandshakeError as e:
                        return self._reject_pending(pc, str(e))
                    pc.ch.send(reply, deadline_s=self.io_deadline_s)
                    pc.state = "register"
                elif isinstance(m, tuple) and m and m[0] == "blob":
                    self._serve_blob_chunk(pc, m)
                elif isinstance(m, tuple) and m and m[0] == "register":
                    self._admit(pc, m)
                else:
                    return self._reject_pending(
                        pc, f"unexpected pre-admission message {m!r}")
            except transport.TransportError as e:
                self.rejected_connections.append(
                    f"pending connection failed: {e!r}")
                pc.ch.close()
                if pc in self._pending_conns:
                    self._pending_conns.remove(pc)
                return

    def _poll_network(self, timeout_s: float):
        """One network sweep: select over the listener + every pending
        and bound channel, accept new dial-ins, advance pending
        handshakes/registrations, deliver bound workers' messages, and
        expire pendings that never completed the handshake."""
        socks = [self.listener] \
            + [pc.ch for pc in self._pending_conns] \
            + [w.channel for w in self.workers
               if w.alive and w.channel is not None]
        r, _, _ = select.select(socks, [], [], max(timeout_s, 0.0))
        while True:
            ch = self.listener.try_accept()
            if ch is None:
                break
            self._pending_conns.append(_PendingConn(ch, self._clock()))
        for pc in list(self._pending_conns):
            self._pump_pending(pc)
        now = self._clock()
        for pc in list(self._pending_conns):
            if now - pc.since > self.handshake_timeout_s:
                self._reject_pending(
                    pc, f"handshake not completed within "
                        f"{self.handshake_timeout_s}s")
        for ch in r:
            for w in self.workers:
                if w.channel is ch and w.alive:
                    self._pump(w)

    def _wait_events(self, timeout_s: float):
        self._poll_network(timeout_s)

    def _wait_ready(self):
        """Startup barrier: keep accepting/advancing registrations
        until every slot's worker has dialed in, fetched + verified
        the blob, warmed up, and reported ready."""
        deadline = self._clock() + self.spawn_timeout_s
        while True:
            pend = [w for w in self.workers if w.alive and not w.ready]
            if not pend:
                return
            for w in pend:
                rc = w.proc.poll()
                if rc is not None:
                    self._pump(w)     # surface a ("fatal", ...) if sent
                    raise RuntimeError(
                        f"worker {w.idx} died during startup "
                        f"(exit {rc}); log tail:\n{self._log_tail(w)}")
            if self._clock() > deadline:
                raise RuntimeError(
                    f"workers {[w.idx for w in pend]} not ready within "
                    f"spawn_timeout_s={self.spawn_timeout_s}s; log "
                    f"tail of worker {pend[0].idx}:\n"
                    f"{self._log_tail(pend[0])}")
            self._poll_network(0.25)

    def close(self):
        for pc in self._pending_conns:
            pc.ch.close()
        self._pending_conns = []
        self.listener.close()
        super().close()

    def run(self, *, max_rounds: Optional[int] = None) -> dict:
        metrics = super().run(max_rounds=max_rounds)
        metrics["blob_bytes_served"] = self.blob_bytes_served
        metrics["rejected_connections"] = list(
            self.rejected_connections)
        metrics["worker_capabilities"] = [
            w.capabilities for w in self.workers]
        return metrics
