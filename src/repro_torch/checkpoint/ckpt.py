"""Checksummed files: the port's copy of the reference's
``src/repro/checkpoint/ckpt.py``.

- :func:`save` / :func:`restore` / :class:`AsyncSaver` /
  :func:`latest_step`: training checkpoints. Layout
  ``<dir>/step_<n>/shard_<host>.npz`` + ``MANIFEST.json``; each leaf is
  keyed by its JAX key path (``core/pytree.keyed_leaves``: ``"['params']|
  ['embed']"``, ``"['opt']|.m|..."``), bf16 stored as f32; the step is
  written to ``.tmp-step_<n>-<host>`` and renamed, so a failure mid-write
  never corrupts the latest checkpoint; the manifest holds each shard's
  CRC32 and byte count, checked (:func:`_verify_shard`) before the shard
  is parsed. The files are the reference's: either package restores what
  the other wrote.

- :func:`file_sha256` / :func:`verify_blob`: the content address of the
  packed param blob (``runtime/worker.py``), checked before a worker maps
  it, so a torn or stale blob is a typed :class:`CheckpointCorruptError`
  and never wrong logits.
- :func:`save_ledger` / :func:`load_ledger`: the supervisor's replay
  ledger, crash-safe by pointer swap. The payload (numpy ``.npz``) is
  written to a content-addressed file first, then a one-file JSON pointer
  naming it and its checksum is atomically replaced, so a crash between
  the two writes leaves the pointer at the previous intact ledger, never
  at a torn one. The files are the reference's: either package resumes a
  ledger the other wrote.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
import zlib
from typing import Optional

import numpy as np


class CheckpointCorruptError(RuntimeError):
    """A checkpoint/ledger file failed validation (truncated, checksum
    mismatch, or unparseable): the caller must treat it as ABSENT or
    pick an older one — never load it as state."""


def _file_crc(path: str) -> tuple[int, int]:
    """(crc32, nbytes) of a file, streamed."""
    crc, n = 0, 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                return crc & 0xFFFFFFFF, n
            crc = zlib.crc32(chunk, crc)
            n += len(chunk)


def file_sha256(path: str) -> str:
    """Hex SHA-256 of a file, streamed — the content address under
    which the serving tier distributes its packed param blob. CRC32
    frames catch bits corrupted in flight; the SHA-256 names WHICH
    bytes a worker must end up holding."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                return h.hexdigest()
            h.update(chunk)


def verify_blob(path: str, sha256: str) -> str:
    """Verify a param blob against its content hash BEFORE it is
    memory-mapped: a mismatch (torn transfer, stale cache entry, disk
    rot) raises :class:`CheckpointCorruptError` — the worker must die
    loudly rather than warm up on wrong weights. Returns ``path``."""
    try:
        got = file_sha256(path)
    except OSError as e:
        raise CheckpointCorruptError(
            f"param blob {path} unreadable ({e!r})") from e
    if got != sha256:
        raise CheckpointCorruptError(
            f"param blob {path} SHA-256 {got[:16]}… != expected "
            f"{sha256[:16]}… — torn or stale content; refusing to map "
            "it (wrong logits are worse than a dead worker)")
    return path


# --- training checkpoints ----------------------------------------------------

def _flatten(tree) -> dict[str, np.ndarray]:
    """{JAX key path: numpy array} of a tree's leaves, bf16 as f32
    (``np.savez`` stores no bf16): copies on the host, so the caller may
    change its tensors in place once this returns."""
    import torch

    from repro_torch.core import pytree
    out = {}
    for key, leaf in pytree.keyed_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach()
            if leaf.dtype == torch.bfloat16:
                leaf = leaf.float()
            leaf = leaf.to("cpu", copy=True).numpy()
        out[key] = np.asarray(leaf)
    return out


def _write(arrs: dict, directory: str, step: int, host: int,
           keep: int) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = os.path.join(directory, f".tmp-step_{step:08d}-{host}")
    os.makedirs(tmp, exist_ok=True)
    shard = os.path.join(tmp, f"shard_{host}.npz")
    np.savez(shard, **arrs)
    crc, nbytes = _file_crc(shard)
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump({"step": step, "n_leaves": len(arrs),
                   "time": time.time(),
                   "shards": {f"shard_{host}.npz":
                              {"crc32": crc, "nbytes": nbytes}}}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _gc(directory, keep)
    return final


def save(tree, directory: str, step: int, *, host: int = 0,
         keep: int = 3) -> str:
    """Write ``tree`` as step ``step`` (keeping the last ``keep`` steps);
    returns the step's directory."""
    return _write(_flatten(tree), directory, step, host, keep)


class AsyncSaver:
    """Serialize checkpoints on a background thread; at most one
    outstanding save (back-pressure instead of an unbounded queue). The
    tree is read back to the host before the thread starts, so the
    caller may update its tensors right after."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self.last_path: Optional[str] = None

    def save(self, tree, directory: str, step: int, *, host: int = 0,
             keep: int = 3):
        self.wait()
        arrs = _flatten(tree)

        def run():
            self.last_path = _write(arrs, directory, step, host, keep)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_")]
    return max(steps) if steps else None


def restore(template, directory: str, step: Optional[int] = None, *,
            host: int = 0):
    """Restore into the structure of ``template`` (a tree of tensors):
    each leaf at the template leaf's dtype, on its device. Returns (tree,
    step)."""
    import torch

    from repro_torch.core import pytree
    from repro_torch.models.layers import tensor_from_numpy
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    step_dir = os.path.join(directory, f"step_{step:08d}")
    path = os.path.join(step_dir, f"shard_{host}.npz")
    _verify_shard(step_dir, f"shard_{host}.npz")
    try:
        data = np.load(path)
        data.files                        # force the zip directory read
    except Exception as e:
        raise CheckpointCorruptError(
            f"checkpoint shard {path} is unreadable ({e!r}); the file "
            "passed its size/CRC check, so the manifest itself is "
            "stale — treat this step as lost") from e
    flat = dict(pytree.keyed_leaves(template))

    def leaf_of(key):
        want = flat[key]
        arr = data[key]
        got = tensor_from_numpy(arr).reshape(arr.shape)
        if isinstance(want, torch.Tensor):
            return got.to(want.dtype).to(want.device)
        return got
    return pytree.rebuild(template, leaf_of), step


def _verify_shard(step_dir: str, shard_name: str):
    """Validate one shard against the step's manifest: size first
    (cheap truncation check), then CRC32. Any mismatch, or a missing or
    unparseable manifest, raises :class:`CheckpointCorruptError`."""
    manifest_path = os.path.join(step_dir, "MANIFEST.json")
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except FileNotFoundError as e:
        raise CheckpointCorruptError(
            f"{step_dir} has no MANIFEST.json — a torn checkpoint "
            "directory (the atomic rename never completed)") from e
    except (json.JSONDecodeError, OSError) as e:
        raise CheckpointCorruptError(
            f"unreadable MANIFEST.json in {step_dir}: {e!r}") from e
    expect = (manifest.get("shards") or {}).get(shard_name)
    if expect is None:
        # a checkpoint without per-shard checksums: nothing to verify
        # against; np.load's own failures are wrapped by the caller
        return
    path = os.path.join(step_dir, shard_name)
    try:
        nbytes = os.path.getsize(path)
    except OSError as e:
        raise CheckpointCorruptError(
            f"missing checkpoint shard {path}") from e
    if nbytes != expect["nbytes"]:
        raise CheckpointCorruptError(
            f"checkpoint shard {path} is {nbytes} bytes, manifest "
            f"says {expect['nbytes']} — truncated write")
    crc, _ = _file_crc(path)
    if crc != expect["crc32"]:
        raise CheckpointCorruptError(
            f"checkpoint shard {path} CRC32 0x{crc:08x} != manifest "
            f"0x{expect['crc32']:08x} — corrupt contents")


def _gc(directory: str, keep: int):
    steps = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


# --- serving-tier supervisor ledger ------------------------------------------

_LEDGER_PTR = "ledger.json"


def save_ledger(directory: str, meta: dict, arrays: dict) -> str:
    """Atomically persist the serving supervisor's replay ledger:
    ``meta`` (JSON-able request bookkeeping) + ``arrays`` (the
    undelivered microbatch chunks / delivered logits, numpy).

    The payload lands in a content-addressed ``ledger-<crc>-<n>.npz``
    first (temp + ``os.replace``), then the one-file JSON pointer naming
    it is atomically replaced: a crash at ANY instant leaves the pointer
    at a complete, checksummed payload — old or new, never torn."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp-ledger-{os.getpid()}.npz")
    with open(tmp, "wb") as f:
        np.savez(f, **{k: np.asarray(v) for k, v in arrays.items()})
    crc, nbytes = _file_crc(tmp)
    payload = f"ledger-{crc:08x}-{nbytes}.npz"
    os.replace(tmp, os.path.join(directory, payload))
    ptr_tmp = os.path.join(directory, f".tmp-ptr-{os.getpid()}")
    with open(ptr_tmp, "w") as f:
        json.dump({"payload": payload, "crc32": crc, "nbytes": nbytes,
                   "time": time.time(), "meta": meta}, f)
    ptr = os.path.join(directory, _LEDGER_PTR)
    os.replace(ptr_tmp, ptr)
    # GC payloads the pointer no longer references
    for name in os.listdir(directory):
        if name.startswith("ledger-") and name.endswith(".npz") \
                and name != payload:
            try:
                os.remove(os.path.join(directory, name))
            except OSError:
                pass
    return ptr


def load_ledger(directory: str) -> Optional[tuple[dict, dict]]:
    """Load the supervisor ledger: ``(meta, arrays)``, or ``None``
    when no ledger was ever written. Validation failures (torn
    pointer, missing/truncated/corrupt payload) raise
    :class:`CheckpointCorruptError` — resuming from a corrupt ledger
    must be a loud decision, not silent garbage work."""
    ptr = os.path.join(directory, _LEDGER_PTR)
    if not os.path.exists(ptr):
        return None
    try:
        with open(ptr) as f:
            rec = json.load(f)
    except (json.JSONDecodeError, OSError) as e:
        raise CheckpointCorruptError(
            f"unreadable ledger pointer {ptr}: {e!r}") from e
    path = os.path.join(directory, rec["payload"])
    try:
        nbytes = os.path.getsize(path)
    except OSError as e:
        raise CheckpointCorruptError(
            f"ledger payload {path} named by the pointer is "
            "missing") from e
    if nbytes != rec["nbytes"]:
        raise CheckpointCorruptError(
            f"ledger payload {path} is {nbytes} bytes, pointer says "
            f"{rec['nbytes']} — truncated write")
    crc, _ = _file_crc(path)
    if crc != rec["crc32"]:
        raise CheckpointCorruptError(
            f"ledger payload {path} CRC32 0x{crc:08x} != pointer "
            f"0x{rec['crc32']:08x} — corrupt contents")
    try:
        with np.load(path) as data:
            arrays = {k: data[k] for k in data.files}
    except Exception as e:
        raise CheckpointCorruptError(
            f"ledger payload {path} unparseable despite a clean "
            f"checksum: {e!r}") from e
    return rec["meta"], arrays
