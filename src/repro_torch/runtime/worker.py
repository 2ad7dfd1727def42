"""Replica worker process for the cross-process serving tier: the port's
counterpart of the reference's ``src/repro/runtime/worker.py``.

One OS process per pipeline replica: each replica owns its interpreter,
its CUDA context and its pipeline state, so a SIGKILL'd, OOM'd or wedged
worker (or one whose CUDA context took a sticky fault) cannot corrupt the
supervisor or its siblings. The supervisor
(:class:`~repro_torch.runtime.tier.ProcessServingTier`) starts this
module as ``python -m repro_torch.runtime.worker --fd N ...`` (exec, never
a fork of a process that holds a CUDA context) with one end of a
``socketpair`` inherited on fd N, and drives it over the framed transport
(:mod:`repro_torch.runtime.transport`).

**Startup.** The worker rebuilds the serving cell the supervisor planned:
the weights come from the supervisor's packed param blob
(``--param-blob``, memory-mapped copy-on-write: one file shared by every
replica through the OS page cache), and the stage plan is re-derived from
the same ``(cfg, params, n_stages, quantize)``. The server is built
(warm-up ticks and captures, where cuDNN chooses its algorithms) under
:func:`~repro_torch.core.device.deterministic_convs`, as the in-process
tier builds its replicas. The server captures its tick graphs and runs one discarded
microbatch BEFORE ``ready`` is reported, so capture time never
masquerades as a missed heartbeat.

**Serve loop.** Each iteration drains control messages (``work`` /
``purge`` / ``stop``), emits a ``hb`` heartbeat carrying the last completed
tick, and runs one pipeline tick when busy. Results stream back as
``("result", key, logits)``, logits a numpy array (never a CUDA tensor),
the moment their microbatch emerges.

**Cross-host mode.** With ``--dial host:port`` the worker connects over
TCP instead (:class:`~repro_torch.runtime.tier.HostServingTier`):
handshake (protocol version + serving fingerprint), the param blob fetched
**by SHA-256** over the channel (chunked, CRC-framed, resumable through
``--blob-cache``) and verified before warm-up, then registration of its
slot token with a capability report.

**Fault hooks.** ``--kill-at-tick`` / ``--stop-at-tick`` send a real
``SIGKILL`` / ``SIGSTOP`` to the worker's own pid inside the tick path.

**The param blob** (:func:`write_param_blob` / :func:`read_param_blob`)
is the reference's format byte for byte: ``HPIPEPB1``, the manifest length
(little-endian u64), a JSON manifest of ``(key, dtype, shape, offset,
nbytes)`` per leaf, then the C-order leaf bytes. Keys are JAX's key-path
strings (``['s0b0_c1']|['w']``; the children of a ``SparseWeight`` or a
``QuantizedWeight`` ``[<flat index i>]`` in the reference's flatten
order), in JAX's order (dict keys sorted); the dtype tag is
``"bfloat16"`` by name, otherwise numpy's ``.str``. So either package
reads a blob the other wrote.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import struct
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from repro_torch.core.quant import QuantizedWeight
from repro_torch.models.layers import SparseWeight
from repro_torch.runtime import transport

_BLOB_MAGIC = b"HPIPEPB1"
_KEYSEP = "|"


# --- the packed param blob -----------------------------------------------------

def _children(leaf):
    """A weight container's leaves in the reference's ``tree_flatten``
    order, or None for a plain tensor."""
    if isinstance(leaf, SparseWeight):
        return [leaf.vals, leaf.idx] + (
            [] if leaf.scale is None else [leaf.scale])
    if isinstance(leaf, QuantizedWeight):
        return [leaf.codes, leaf.scale]
    return None


def _keyed_leaves(tree, path=()):
    """``(key, tensor)`` for every leaf of ``tree``, in the order and
    with the key strings of JAX's ``tree_flatten_with_path``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _keyed_leaves(tree[k], path + (f"[{k!r}]",))
        return
    kids = _children(tree)
    if kids is None:
        yield _KEYSEP.join(path), tree
        return
    for i, kid in enumerate(kids):
        yield _KEYSEP.join(path + (f"[<flat index {i}>]",)), kid


def _rebuild(tree, leaf_of, path=()):
    """``tree`` with every leaf replaced by ``leaf_of(key)``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaf_of, path + (f"[{k!r}]",))
                for k, v in tree.items()}
    kids = _children(tree)
    if kids is None:
        return leaf_of(_KEYSEP.join(path))
    new = [leaf_of(_KEYSEP.join(path + (f"[<flat index {i}>]",)))
           for i in range(len(kids))]
    if isinstance(tree, SparseWeight):
        return SparseWeight(new[0], new[1], tree.d_in,
                            new[2] if len(new) > 2 else None,
                            tree.orig_dtype)
    return QuantizedWeight(new[0], new[1], tree.orig_dtype)


def _leaf_bytes(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A tensor's C-order bytes as numpy, and the manifest's dtype tag."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    a = t.numpy()
    return a, a.dtype.str


def write_param_blob(params, path: str) -> str:
    """Pack a param tree into one flat file (the module docstring's
    format). Written temp-then-rename, so workers never map a
    half-written blob."""
    leaves, manifest, off = [], [], 0
    for key, leaf in _keyed_leaves(params):
        a, tag = _leaf_bytes(leaf)
        manifest.append({"key": key, "dtype": tag, "shape": list(a.shape),
                         "offset": off, "nbytes": int(a.nbytes)})
        leaves.append(a)
        off += a.nbytes
    mjson = json.dumps({"leaves": manifest, "total": off}).encode()
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(_BLOB_MAGIC)
        f.write(struct.pack("<Q", len(mjson)))
        f.write(mjson)
        for a in leaves:
            f.write(a.tobytes())
    os.replace(tmp, path)
    return path


def read_param_blob(template, path: str):
    """Rebuild ``template``'s tree with its leaf VALUES memory-mapped
    from the blob, copy-on-write (the OS page cache shares the pages
    across every worker on the host until one is written). ``template``
    gives the structure and what is not stored (``d_in``,
    ``orig_dtype``); leaves are matched by key, and a leaf whose dtype or
    shape differs from the template's raises. bf16 leaves are read as
    16-bit integers and viewed as ``torch.bfloat16``."""
    with open(path, "rb") as f:
        magic = f.read(len(_BLOB_MAGIC))
        if magic != _BLOB_MAGIC:
            raise ValueError(f"{path} is not a param blob "
                             f"(magic {magic!r})")
        (mlen,) = struct.unpack("<Q", f.read(8))
        manifest = json.loads(f.read(mlen))
        base = f.tell()
    by_key = {m["key"]: m for m in manifest["leaves"]}
    want = dict(_keyed_leaves(template))

    def leaf_of(key):
        m = by_key[key]
        bf16 = m["dtype"] == "bfloat16"
        dt = np.dtype(np.int16) if bf16 else np.dtype(m["dtype"])
        shape = tuple(m["shape"])
        if m["nbytes"] == 0:
            arr = np.zeros(shape, dt)
        else:
            arr = np.memmap(path, dtype=dt, mode="c",
                            offset=base + m["offset"], shape=shape)
        t = torch.from_numpy(arr)
        if bf16:
            t = t.view(torch.bfloat16)
        ref = want[key]
        if t.dtype != ref.dtype or tuple(t.shape) != tuple(ref.shape):
            raise ValueError(
                f"{path}: leaf {key} is {t.dtype} {tuple(t.shape)}, the "
                f"template's {ref.dtype} {tuple(ref.shape)}")
        return t

    return _rebuild(template, leaf_of)


# --- cross-host startup: fingerprint + blob-by-hash fetch --------------------

def serving_fingerprint(*, arch: str, stages: int, mb_size: int,
                        image_size: int, seed: int, quantize: str,
                        blob_sha256: str, device: str = "cuda") -> str:
    """The serving fingerprint both ends of a cross-host connection must
    agree on at handshake time: every input that determines the serving
    cell's bits. That is the reference's list (arch, stage cut,
    microbatch geometry, seed, stored dtype, the params' content hash)
    and the device type, since the card's kernels and the CPU's plain
    versions sum in other orders."""
    kind = torch.device(device).type
    return (f"hpipe-serve/{arch}/s{stages}/mb{mb_size}/i{image_size}/"
            f"r{seed}/{quantize}/{kind}/{blob_sha256[:16]}")


def fetch_param_blob(ch: "transport.Channel", sha256: str,
                     cache_dir: str, *,
                     io_deadline_s: float = 60.0) -> str:
    """Ensure ``cache_dir`` holds the param blob whose content hash is
    ``sha256``, fetching it over ``ch`` if needed, and return its path.

    The transfer is chunked (each chunk one CRC-framed message),
    content-addressed (the worker asks for a HASH, not a path) and
    **resumable**: progress accretes in ``<sha>.part``, and a fetch cut
    by a connection loss resumes from the partial file's size on the next
    attempt (the respawned next generation of this worker included). The
    assembled file is SHA-256-verified before the final rename, so
    ``<sha>.blob`` existing means its bytes ARE that hash; a failed check
    deletes the partial and raises a typed ``CheckpointCorruptError``. A
    cached blob is verified too, and evicted and fetched again if it
    fails."""
    from repro_torch.checkpoint import ckpt
    os.makedirs(cache_dir, exist_ok=True)
    final = os.path.join(cache_dir, f"{sha256}.blob")
    if os.path.exists(final):
        try:
            return ckpt.verify_blob(final, sha256)
        except ckpt.CheckpointCorruptError:
            os.remove(final)
    part = os.path.join(cache_dir, f"{sha256}.part")
    offset = os.path.getsize(part) if os.path.exists(part) else 0
    with open(part, "ab") as f:
        while True:
            ch.send(("blob", sha256, offset), deadline_s=io_deadline_s)
            m = ch.recv(deadline_s=io_deadline_s)
            tag = m[0]
            if tag == "blobreject":
                raise ckpt.CheckpointCorruptError(
                    f"supervisor refused blob {sha256[:16]}…: {m[1]}")
            if tag != "blobchunk":
                raise transport.ProtocolError(
                    f"unexpected message {tag!r} during blob fetch")
            _, off, total, data = m
            if off != offset:
                raise transport.ProtocolError(
                    f"blob chunk at offset {off}, expected {offset}")
            f.write(data)
            f.flush()
            offset += len(data)
            if offset >= total:
                break
    try:
        ckpt.verify_blob(part, sha256)
    except ckpt.CheckpointCorruptError:
        os.remove(part)
        raise
    os.replace(part, final)
    return final


# --- signal fault hooks ------------------------------------------------------

class SignalAtTick:
    """Deliver a real signal to our own pid when the server's tick
    counter hits ``at`` — plugged into ``CNNPipelineServer.injector``
    so it fires inside ``_tick_once``, i.e. genuinely mid-tick."""

    def __init__(self, at: int, sig: int):
        self.at = at
        self.sig = sig
        self._fired = False

    def maybe_fail(self, tick: int):
        if not self._fired and tick >= self.at:
            self._fired = True
            os.kill(os.getpid(), self.sig)


# --- the worker --------------------------------------------------------------

def build_server(args):
    """The replica's serving cell exactly as the supervisor planned it:
    the blob's weights (their structure from the seed's, re-stored at
    ``--quantize`` like the supervisor's), the plan re-derived from them,
    a ``CNNPipelineServer`` on ``--device``."""
    from repro_torch.configs import get_config
    from repro_torch.core import planner
    from repro_torch.core.device import deterministic_convs, resolve_device
    from repro_torch.core.quant import quantize_tree
    from repro_torch.launch.serve import CNNPipelineServer, _init_native
    dev = resolve_device(args.device)        # no card: raise, never the CPU
    cfg = get_config(args.arch)
    params = quantize_tree(_init_native(cfg, args.seed), args.quantize)
    if args.param_blob:
        params = read_param_blob(params, args.param_blob)
    plan = planner.plan(cfg, params, planner.PlanRequest(
        n_stages=args.stages, store_dtype=args.quantize))
    with deterministic_convs():              # cuDNN chooses as in process
        return CNNPipelineServer(
            args.arch, mb_size=args.mb_size, image_size=args.image_size,
            seed=args.seed, cfg=cfg, params=params, plan=plan,
            quantize=args.quantize, device=dev)


def warmup(server) -> None:
    """One discarded microbatch through the captured ticks, then the
    state zeroed: after this the server is bitwise fresh."""
    server.on_result = lambda key, logits: None
    server.enqueue(("__warmup__", -1),
                   np.zeros((server.mb_size, server.image_size,
                             server.image_size, 3), np.float32))
    server.run()
    server.respawn()


def serve(ch: transport.Channel, server, *, heartbeat_interval_s: float,
          io_deadline_s: float) -> int:
    """The worker's main loop; returns the exit code. The ``ready``
    message carries the pid and the kernel launches this process counted
    (warm-up and captures: a replay runs no Python)."""
    from repro_torch.kernels import ops
    server.on_result = lambda key, logits: ch.send(
        ("result", key, np.asarray(logits)), deadline_s=io_deadline_s)
    ch.send(("ready", os.getpid(), dict(ops.LAUNCHES)),
            deadline_s=io_deadline_s)
    last_hb = 0.0
    while True:
        try:
            msgs = ch.drain()
        except transport.PeerClosedError:
            return 0                      # supervisor is gone: retire
        for m in msgs:
            tag = m[0]
            if tag == "work":
                _, key, imgs, n_valid = m
                server.enqueue(tuple(key), imgs, n_valid=n_valid)
            elif tag == "purge":
                rid = m[1]
                server.purge(lambda k, _r=rid: k[0] == _r)
            elif tag == "stop":
                return 0
            else:
                raise transport.ProtocolError(
                    f"unknown control message {tag!r}")
        now = time.monotonic()
        if now - last_hb >= heartbeat_interval_s:
            ch.send(("hb", server.ticks, now), deadline_s=io_deadline_s)
            last_hb = now
        if server.busy:
            server._tick_once()
        else:
            ch.poll(heartbeat_interval_s)


def _join_supervisor(args) -> transport.Channel:
    """Cross-host startup: dial the supervisor, handshake (protocol
    version + serving fingerprint), ensure the param blob by content
    hash, then register with a capability report and wait for admission.
    Returns the admitted channel; ``args.param_blob`` is pointed at the
    verified local blob. Any failure closes the channel and re-raises."""
    ch = transport.connect(args.dial, deadline_s=args.io_deadline,
                           max_frame=args.max_frame)
    try:
        fp = serving_fingerprint(
            arch=args.arch, stages=args.stages, mb_size=args.mb_size,
            image_size=args.image_size, seed=args.seed,
            quantize=args.quantize, blob_sha256=args.blob_sha or "",
            device=args.device)
        transport.client_handshake(ch, fingerprint=fp,
                                   deadline_s=args.io_deadline)
        if args.blob_sha:
            cache = args.blob_cache or os.path.join(
                tempfile.gettempdir(), "hpipe-blobcache")
            args.param_blob = fetch_param_blob(
                ch, args.blob_sha, cache, io_deadline_s=args.io_deadline)
        cuda = torch.device(args.device).type == "cuda"
        caps = {"pid": os.getpid(),
                "device_count": torch.cuda.device_count() if cuda else 1,
                "device": args.device,
                "blob_sha256": args.blob_sha}
        ch.send(("register", args.token, caps),
                deadline_s=args.io_deadline)
        reply = ch.recv(deadline_s=args.io_deadline)
        if not (isinstance(reply, tuple) and reply
                and reply[0] == "admit"):
            reason = reply[1] if isinstance(reply, tuple) \
                and len(reply) > 1 else reply
            raise transport.HandshakeError(
                f"registration refused: {reason}")
        return ch
    except BaseException:
        ch.close()
        raise


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="serving-tier replica worker (started by "
                    "ProcessServingTier / HostServingTier, or by hand "
                    "with --dial)")
    ap.add_argument("--fd", type=int, default=None,
                    help="inherited socketpair fd to the supervisor "
                         "(same-host mode)")
    ap.add_argument("--dial", default=None,
                    help="supervisor host:port to dial over TCP "
                         "(cross-host mode; exactly one of --fd/--dial)")
    ap.add_argument("--token", type=int, default=None,
                    help="worker slot token to register as (cross-host "
                         "mode)")
    ap.add_argument("--blob-sha", default=None,
                    help="SHA-256 of the packed param blob to fetch over "
                         "the channel and verify before warm-up "
                         "(cross-host mode)")
    ap.add_argument("--blob-cache", default=None,
                    help="directory for the content-addressed blob cache "
                         "(resumable .part files live here)")
    ap.add_argument("--max-frame", type=int,
                    default=transport.DEFAULT_MAX_FRAME,
                    help="channel frame-size bound (must match the "
                         "supervisor's)")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--stages", type=int, default=2)
    ap.add_argument("--mb-size", type=int, default=2)
    ap.add_argument("--image-size", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--param-blob", default=None)
    ap.add_argument("--quantize", default="native",
                    help="stored weight dtype: must match the "
                         "supervisor's, so the blob's tree agrees with "
                         "the template")
    ap.add_argument("--device", default="cuda",
                    help="where to serve; a worker told cuda that finds "
                         "no card exits non-zero")
    ap.add_argument("--heartbeat-interval", type=float, default=0.1)
    ap.add_argument("--io-deadline", type=float, default=30.0)
    ap.add_argument("--kill-at-tick", type=int, default=None,
                    help="fault hook: SIGKILL our own pid mid-tick, "
                         "N serving ticks after warm-up")
    ap.add_argument("--stop-at-tick", type=int, default=None,
                    help="fault hook: SIGSTOP (wedge) ourselves "
                         "mid-tick, N serving ticks after warm-up")
    args = ap.parse_args(argv)
    if (args.fd is None) == (args.dial is None):
        ap.error("exactly one of --fd / --dial is required")
    ch = None
    try:
        if args.fd is not None:
            import socket
            sock = socket.socket(family=socket.AF_UNIX,
                                 type=socket.SOCK_STREAM, fileno=args.fd)
            ch = transport.Channel(sock, max_frame=args.max_frame)
        else:
            ch = _join_supervisor(args)
        server = build_server(args)
        warmup(server)
        # arm fault hooks only now: warm-up ticks must never trip them
        if args.kill_at_tick is not None:
            server.injector = SignalAtTick(server.ticks + args.kill_at_tick,
                                           signal.SIGKILL)
        elif args.stop_at_tick is not None:
            server.injector = SignalAtTick(server.ticks + args.stop_at_tick,
                                           signal.SIGSTOP)
        return serve(ch, server,
                     heartbeat_interval_s=args.heartbeat_interval,
                     io_deadline_s=args.io_deadline)
    except transport.HandshakeError as e:
        print(f"worker: refused by supervisor: {e}", file=sys.stderr)
        return 1
    except transport.TransportError as e:
        # supervisor-side teardown, or a poisoned channel: either way the
        # supervisor owns the respawn decision, so log and retire
        print(f"worker: transport failed: {e!r}", file=sys.stderr)
        return 0
    except Exception as e:                # noqa: BLE001 — report + die
        try:
            if ch is not None:
                ch.send(("fatal", repr(e), traceback.format_exc()),
                        deadline_s=5.0)
        except Exception:                 # noqa: BLE001 — best effort
            pass
        print(f"worker: fatal: {e!r}\n{traceback.format_exc()}",
              file=sys.stderr)
        return 1
    finally:
        if ch is not None:
            ch.close()


if __name__ == "__main__":
    raise SystemExit(main())
