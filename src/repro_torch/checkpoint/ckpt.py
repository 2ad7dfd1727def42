"""Checksummed files for the serving tier: the port's copy of the serving
part of the reference's ``src/repro/checkpoint/ckpt.py``.

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

The training checkpoints (``save``, ``restore``, ``AsyncSaver``,
``latest_step``) are not ported yet (ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

import hashlib
import json
import os
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
