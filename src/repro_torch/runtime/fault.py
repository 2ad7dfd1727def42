"""Fault injection and failure detection for the serving tier: the
port's copy of the serving part of the reference's
``src/repro/runtime/fault.py``, which imports no framework here.

- :class:`FailureInjector`: raises :class:`InjectedFailure` at chosen
  ticks inside a replica's tick path (``CNNPipelineServer.injector``);
- :class:`StragglerDetector`: per-host step-time windows judged against
  the fleet median (the in-process tier's straggler flag);
- :func:`validate_heartbeat_config` and :class:`FailureDetector`: the
  process tier's heartbeat bands, alive / suspect / dead;
- :class:`NetFaultProxy` and the frame rules (:func:`drop_frames` …
  :func:`truncate_frames`): network faults at frame granularity for the
  host tier.

Training (torch imported where they run):

- :func:`run_with_restarts`: the checkpoint / restart loop;
- :func:`compress_grads` / :func:`decompress_grads` /
  :func:`init_error`: per-leaf symmetric int8 gradients with error
  feedback.

Elastic re-meshing: :func:`remesh` re-places a tree from one device
mesh onto another (``launch/mesh.py``), as the placed tier does after
losing slots.
"""
from __future__ import annotations

import socket
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np


class InjectedFailure(RuntimeError):
    """Simulated node failure (SIGKILL-equivalent for tests)."""


@dataclass
class FailureInjector:
    fail_at_steps: tuple = ()
    _fired: set = field(default_factory=set)

    def maybe_fail(self, step: int):
        if step in self.fail_at_steps and step not in self._fired:
            self._fired.add(step)
            raise InjectedFailure(f"injected failure at step {step}")


def run_with_restarts(make_state: Callable[[], Any],
                      step_fn: Callable[[Any, int], Any],
                      *, n_steps: int, ckpt_dir: str, ckpt_every: int = 10,
                      max_restarts: int = 5,
                      injector: Optional[FailureInjector] = None,
                      saver=None):
    """Generic resilient loop: state = step_fn(state, step); checkpoints
    every ``ckpt_every``; on failure, restores the latest checkpoint and
    resumes (replaying at most ckpt_every-1 steps). Returns (state,
    restart_count, steps_executed)."""
    from repro_torch.checkpoint import ckpt
    if saver is None:
        saver = ckpt.AsyncSaver()
    restarts = 0
    executed = 0
    state = make_state()
    start = 0
    last = ckpt.latest_step(ckpt_dir)
    if last is not None:
        state, start = ckpt.restore(state, ckpt_dir, last)
        start += 1
    step = start
    while step < n_steps:
        try:
            if injector is not None:
                injector.maybe_fail(step)
            state = step_fn(state, step)
            executed += 1
            if step % ckpt_every == 0:
                saver.save(state, ckpt_dir, step)
            step += 1
        except InjectedFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
            saver.wait()
            last = ckpt.latest_step(ckpt_dir)
            if last is None:                      # failed before 1st ckpt
                state, step = make_state(), 0
            else:
                state, last_step = ckpt.restore(make_state(), ckpt_dir, last)
                step = last_step + 1
    saver.wait()
    return state, restarts, executed


@dataclass
class StragglerDetector:
    """Flags slow steps/hosts. At fleet scale the per-host step times
    arrive via the coordinator heartbeat; here we feed them directly.

    Windows are PER HOST and each sample is judged against the fleet
    median — the median of the OTHER hosts' window medians. Pooling
    every host into one window (the original implementation) let a
    persistently slow host drag the shared median up and mask itself:
    a host at a steady 10x fills the pool with its own samples until
    10x IS the median. With per-host windows its samples never pollute
    its reference. A lone host (single-process training loops) falls
    back to its own window median, preserving the self-relative
    slow-step detection those loops rely on."""
    threshold: float = 2.0          # x fleet median
    window: int = 32
    _times: dict = field(default_factory=dict)   # host -> recent dts
    flagged: list = field(default_factory=list)

    def _fleet_median(self, host: int) -> float:
        others = [float(np.median(v)) for h, v in self._times.items()
                  if h != host and v]
        if others:
            return float(np.median(others))
        return float(np.median(self._times[host]))

    def record(self, host: int, step: int, dt: float) -> bool:
        w = self._times.setdefault(host, [])
        w.append(dt)
        del w[:-self.window]
        med = self._fleet_median(host)
        n_total = sum(len(v) for v in self._times.values())
        slow = n_total >= 4 and dt > self.threshold * med
        if slow:
            self.flagged.append((host, step, dt, med))
        return slow


# --- heartbeat failure detection (cross-process serving tier) ---------------

def validate_heartbeat_config(interval_s: float, suspect_after_s: float,
                              dead_after_s: float) -> None:
    """Loud construction-time validation of the liveness thresholds.

    The invariants are the ones that keep the detector sound:
    ``dead_after_s`` must exceed **2x the heartbeat interval** (below
    that, one scheduling hiccup on a healthy worker reads as death and
    the tier respawn-storms itself), and the suspect (straggler)
    threshold must sit strictly between the interval and the death
    bound — otherwise slow and dead are indistinguishable and a
    SIGSTOP'd worker would be declared dead instead of flagged."""
    if interval_s <= 0:
        raise ValueError(
            f"heartbeat_interval_s must be > 0, got {interval_s}")
    if suspect_after_s < interval_s:
        raise ValueError(
            f"suspect_after_s ({suspect_after_s}) must be >= the "
            f"heartbeat interval ({interval_s}): a worker cannot be "
            "suspected faster than it is required to beat")
    if dead_after_s <= 2 * interval_s:
        raise ValueError(
            f"dead_after_s ({dead_after_s}) must exceed 2x the "
            f"heartbeat interval (2x{interval_s} = {2 * interval_s}): "
            "anything tighter declares healthy workers dead on a "
            "single missed beat")
    if dead_after_s <= suspect_after_s:
        raise ValueError(
            f"dead_after_s ({dead_after_s}) must exceed "
            f"suspect_after_s ({suspect_after_s}): the straggler band "
            "must be non-empty, or slow == dead")


class FailureDetector:
    """Timeout-band failure detector over worker heartbeats: the
    supervisor-side half of the cross-process liveness protocol.

    Workers emit ``(heartbeat, progress)`` on an interval; the
    supervisor feeds each into :meth:`beat` and classifies via
    :meth:`state`:

    - ``alive``   — beating, and (when busy) making tick progress;
    - ``suspect`` — silent for ``suspect_after_s`` (a SIGSTOP'd or
      overloaded worker: the router deprioritizes it — the straggler
      path), or beating but tick-stalled that long (wedged-but-alive);
    - ``dead``    — silent or progress-stalled past ``dead_after_s``
      (SIGKILL'd, OOM'd, or hard-wedged: drain-and-respawn).

    Distinguishing *slow* from *dead* is the whole point: declaring a
    straggler dead loses its in-flight work for nothing, while waiting
    forever on a corpse stalls the stream. The two thresholds bound
    both mistakes, and :func:`validate_heartbeat_config` keeps them
    ordered."""

    def __init__(self, *, interval_s: float = 0.1,
                 suspect_after_s: Optional[float] = None,
                 dead_after_s: Optional[float] = None):
        if suspect_after_s is None:
            suspect_after_s = 4.0 * interval_s
        if dead_after_s is None:
            dead_after_s = 25.0 * interval_s
        validate_heartbeat_config(interval_s, suspect_after_s,
                                  dead_after_s)
        self.interval_s = interval_s
        self.suspect_after_s = suspect_after_s
        self.dead_after_s = dead_after_s
        self._last_beat: dict = {}
        self._last_progress: dict = {}      # key -> (ticks, t)

    def reset(self, key, now: float):
        """(Re)arm a worker's liveness clock — called when it reports
        ready (spawn and every respawn)."""
        self._last_beat[key] = now
        self._last_progress[key] = (-1, now)

    def beat(self, key, now: float, progress: int):
        """Record one heartbeat carrying the worker's last completed
        tick count."""
        self._last_beat[key] = now
        last = self._last_progress.get(key)
        if last is None or progress > last[0]:
            self._last_progress[key] = (progress, now)

    def work_started(self, key, now: float):
        """Restart a worker's stall clock when it is handed work after
        sitting idle. An idle worker's tick count cannot advance, so
        without this the idle time counts as a stall and a worker idle
        past ``dead_after_s`` is declared dead the moment it is busy
        again."""
        last = self._last_progress.get(key)
        self._last_progress[key] = (-1 if last is None else last[0], now)

    def silent_for(self, key, now: float) -> float:
        last = self._last_beat.get(key)
        return 0.0 if last is None else max(0.0, now - last)

    def missed(self, key, now: float) -> int:
        """Whole heartbeat intervals elapsed since the last beat."""
        return int(self.silent_for(key, now) / self.interval_s)

    def state(self, key, now: float, *, busy: bool = True) -> str:
        silent = self.silent_for(key, now)
        stalled = 0.0
        if busy and key in self._last_progress:
            stalled = max(0.0, now - self._last_progress[key][1])
        worst = max(silent, stalled)
        if worst > self.dead_after_s:
            return "dead"
        if worst > self.suspect_after_s:
            return "suspect"
        return "alive"


# --- network fault injection (cross-host serving tier) ----------------------

class SeveredConnection(Exception):
    """Raised by a :class:`NetFaultProxy` rule to tear the connection
    down — optionally after forwarding ``partial`` bytes first, which
    produces the torn-mid-frame close the transport must surface as a
    distinguishable :class:`~repro_torch.runtime.transport.PeerClosedError`."""

    def __init__(self, partial: bytes = b""):
        super().__init__(f"rule severed connection "
                         f"({len(partial)} partial bytes forwarded)")
        self.partial = partial


class _DropConn(Exception):
    """Internal: terminate one proxied connection's pump threads."""


def drop_frames(indices):
    """Rule: silently swallow the numbered frames (per direction, per
    connection) — a lossy link the framing must survive or time out on,
    never mis-parse."""
    def rule(conn_idx, frame_idx, frame):
        return [] if frame_idx in indices else [frame]
    return rule


def duplicate_frames(indices):
    """Rule: deliver the numbered frames twice — retransmit-style
    duplication the tier's delivery dedup must absorb (same bits either
    way)."""
    def rule(conn_idx, frame_idx, frame):
        return [frame, frame] if frame_idx in indices else [frame]
    return rule


def delay_frames(indices, delay_s: float):
    """Rule: hold the numbered frames for ``delay_s`` before
    forwarding (per-direction ordering is preserved — TCP semantics)."""
    def rule(conn_idx, frame_idx, frame):
        if frame_idx in indices:
            time.sleep(delay_s)
        return [frame]
    return rule


def bitflip_frames(indices):
    """Rule: flip one payload bit of the numbered frames, header and
    CRC left intact — exactly the in-flight corruption the frame
    checksum exists to catch (the receiver must raise a typed
    ChecksumError, never deliver the mutated payload)."""
    from repro_torch.runtime import transport
    def rule(conn_idx, frame_idx, frame):
        if frame_idx not in indices:
            return [frame]
        b = bytearray(frame)
        i = transport.HEADER.size if len(b) > transport.HEADER.size \
            else len(b) - 1
        b[i] ^= 0x01
        return [bytes(b)]
    return rule


def truncate_frames(indices, keep: int = 7):
    """Rule: forward only the first ``keep`` bytes of the numbered
    frame, then kill the connection — a peer dying mid-``send``. The
    receiver sees a torn mid-frame close (PeerClosedError naming the
    buffered partial), NOT a parseable-but-wrong message."""
    def rule(conn_idx, frame_idx, frame):
        if frame_idx in indices:
            raise SeveredConnection(frame[:keep])
        return [frame]
    return rule


class NetFaultProxy:
    """A frame-aware TCP proxy between dialing workers and the serving
    supervisor: the network fault injector of the cross-host tier.

    Tests point a worker's dial address at :attr:`address`; every
    connection is shuttled to ``upstream`` with per-direction *rules*
    applied at frame granularity — drop, delay, duplicate, truncate
    (torn close), bit-flip — plus two dynamic controls:

    - :meth:`sever` drops every frame of one direction while leaving
      the other flowing (an asymmetric partition: the worker still
      hears the supervisor but its heartbeats vanish, or vice versa);
    - :meth:`kill_connections` hard-closes every live socket at an
      arbitrary byte boundary (a mid-tick connection loss).

    Directions are named from the dialing side: ``"c2s"`` is
    worker→supervisor, ``"s2c"`` supervisor→worker. Rules receive
    ``(conn_idx, frame_idx, frame_bytes)`` and return the byte chunks
    to forward (frame counters are per connection per direction). The
    proxy accepts any number of sequential connections, so a respawned
    worker re-dials through the same injected network."""

    def __init__(self, upstream, *, host: str = "127.0.0.1",
                 rules: Optional[dict] = None):
        self.upstream = tuple(upstream)
        self.rules = dict(rules or {})
        self.frames_forwarded = {"c2s": 0, "s2c": 0}
        self.frames_dropped = {"c2s": 0, "s2c": 0}
        self.connections = 0
        self._severed: set = set()
        self._lock = threading.Lock()
        self._socks: list = []
        self._closed = False
        self._ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._ls.bind((host, 0))
        self._ls.listen(16)
        threading.Thread(target=self._accept_loop, daemon=True).start()

    @property
    def address(self) -> tuple:
        return self._ls.getsockname()[:2]

    # -- dynamic controls ----------------------------------------------------

    def sever(self, direction: str):
        """Start dropping every frame flowing in ``direction`` (the
        connection stays open — a one-way partition, not a close)."""
        if direction not in ("c2s", "s2c"):
            raise ValueError(f"direction must be 'c2s' or 's2c', "
                             f"got {direction!r}")
        with self._lock:
            self._severed.add(direction)

    def heal(self, direction: Optional[str] = None):
        """Stop severing (one direction, or all)."""
        with self._lock:
            if direction is None:
                self._severed.clear()
            else:
                self._severed.discard(direction)

    def kill_connections(self):
        """Hard-close every live proxied socket NOW — both endpoints
        see the connection die at whatever byte boundary the kill
        lands on."""
        with self._lock:
            socks, self._socks = self._socks, []
        for s in socks:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass

    def close(self):
        with self._lock:
            self._closed = True
        try:
            self._ls.close()
        except OSError:
            pass
        self.kill_connections()

    # -- internals -----------------------------------------------------------

    def _accept_loop(self):
        while True:
            try:
                c, _addr = self._ls.accept()
            except OSError:
                return
            try:
                u = socket.create_connection(self.upstream, timeout=10.0)
            except OSError:
                c.close()
                continue
            # the connect timeout must NOT linger as a recv timeout: an
            # idle link (a worker warming its compile says nothing for
            # tens of seconds) is healthy, not dead
            u.settimeout(None)
            for s in (c, u):
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                if self._closed:
                    c.close()
                    u.close()
                    return
                self._socks += [c, u]
                ci = self.connections
                self.connections += 1
            threading.Thread(target=self._pump, args=(c, u, "c2s", ci),
                             daemon=True).start()
            threading.Thread(target=self._pump, args=(u, c, "s2c", ci),
                             daemon=True).start()

    def _pump(self, src, dst, direction: str, conn_idx: int):
        from repro_torch.runtime import transport
        buf = bytearray()
        frame_idx = 0
        try:
            while True:
                try:
                    chunk = src.recv(1 << 16)
                except OSError:
                    return
                if not chunk:
                    return
                buf += chunk
                while len(buf) >= transport.HEADER.size:
                    _m, length, _c = transport.HEADER.unpack_from(buf)
                    end = transport.HEADER.size + length
                    if len(buf) < end:
                        break
                    frame = bytes(buf[:end])
                    del buf[:end]
                    self._forward(dst, direction, conn_idx,
                                  frame_idx, frame)
                    frame_idx += 1
        except _DropConn:
            for s in (src, dst):
                # shutdown BEFORE close: the peer's FIN must land even
                # while the opposite direction's pump thread is still
                # blocked in recv() on the same socket
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    s.close()
                except OSError:
                    pass
        finally:
            # half-close toward the receiver so EOF propagates even
            # when the other direction's pump is still alive
            try:
                dst.shutdown(socket.SHUT_WR)
            except OSError:
                pass

    def _forward(self, dst, direction, conn_idx, frame_idx, frame):
        with self._lock:
            severed = direction in self._severed
            rule = self.rules.get(direction)
        if severed:
            self.frames_dropped[direction] += 1
            return
        try:
            chunks = [frame] if rule is None \
                else rule(conn_idx, frame_idx, frame)
        except SeveredConnection as e:
            if e.partial:
                try:
                    dst.sendall(e.partial)
                except OSError:
                    pass
            raise _DropConn from e
        if not chunks:
            self.frames_dropped[direction] += 1
            return
        # counted before the send: a receiver that has the frame must
        # find it counted (counting after the send raced the reader)
        self.frames_forwarded[direction] += 1
        try:
            for c in chunks:
                if c:
                    dst.sendall(c)
        except OSError as e:
            self.frames_forwarded[direction] -= 1
            raise _DropConn from e


# --- gradient compression (int8 + error feedback) ---------------------------

def compress_grads(grads, error):
    """Per-leaf symmetric int8 quantization with error feedback (the
    reference's). Returns ((q_grads, scales), new_error): each floating
    leaf g + e as int8 codes round(x / s) clipped to +-127 with s =
    max(|x|.max() / 127, 1e-12) (f32, round half to even), the error x -
    q * s; a leaf with no gradient (None) gives None, scale 1 and no
    error."""
    import torch

    from repro_torch.core import pytree

    def one(g, e):
        if g is None or not g.is_floating_point():
            return (g, torch.ones((), dtype=torch.float32), None)
        gf = g.float() + e
        scale = torch.clamp(gf.abs().max() / 127.0, min=1e-12)
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        return (q, scale, gf - q.float() * scale)

    triples = pytree.map_leaves(one, grads, error)
    q, s, e = (pytree.map_leaves(lambda t, i=i: t[i], triples)
               for i in range(3))
    return (q, s), e


def decompress_grads(qg):
    """int8 codes times their scale, in f32; other leaves as they are."""
    import torch

    from repro_torch.core import pytree
    q, s = qg
    return pytree.map_leaves(
        lambda qq, ss: qq.float() * ss
        if qq is not None and qq.dtype == torch.int8 else qq, q, s)


def init_error(grads_like):
    """Zero f32 error of every gradient leaf's shape (None stays None)."""
    import torch

    from repro_torch.core import pytree
    return pytree.map_leaves(
        lambda g: None if g is None else torch.zeros(
            g.shape, dtype=torch.float32, device=g.device), grads_like)


# --- elastic re-meshing ------------------------------------------------------

def remesh(tree, old_mesh, new_mesh, spec_fn):
    """Re-place a tree from ``old_mesh`` onto ``new_mesh`` (after losing
    slots: a replica's 4 slots onto 4 surviving ones). ``spec_fn(path,
    leaf) -> spec`` on the NEW mesh (``path``: ``core/pytree.py``'s key
    string). Each leaf, a tensor or a ``launch.mesh.Sharded`` placed on
    ``old_mesh``, is gathered whole and placed by its spec
    (``launch.mesh.place``): a leaf with spec ``("stage",)`` puts row k
    on new slot k. Every returned shard is a fresh copy: none aliases
    the donor's storage."""
    from repro_torch.core import pytree
    from repro_torch.launch.mesh import Sharded, place
    out = {}
    for key, leaf in pytree.keyed_leaves(tree):
        if isinstance(leaf, Sharded) and leaf.mesh.shape != old_mesh.shape:
            raise ValueError(f"{key}: placed on {leaf.mesh!r}, not on the "
                             f"old mesh {old_mesh!r}")
        out[key] = place(leaf, new_mesh, spec_fn(key, leaf))
    return pytree.rebuild(tree, out.__getitem__)
