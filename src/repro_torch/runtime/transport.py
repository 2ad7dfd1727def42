"""Crash-safe message transport for the cross-process serving tier: the
port's copy of the reference's ``src/repro/runtime/transport.py``, which
imports no framework. The bytes on the wire are the reference's (frame
header, magic, CRC, pickled messages, the handshake), so a port endpoint
and a reference endpoint understand each other.

The supervisor (:class:`~repro_torch.runtime.tier.ProcessServingTier`)
and its replica worker processes (:mod:`repro_torch.runtime.worker`)
talk over a ``socketpair`` with **length-prefixed, CRC-checked
frames**: a worker that is SIGKILL'd mid-send leaves at worst a
truncated frame, and a
garbled byte stream can never be silently mis-parsed into a wrong
message — every corruption mode maps to a *distinct typed error* the
supervisor turns into a replica-failure event instead of a crash or,
worse, wrong logits.

Frame layout (all big-endian)::

    +---------+-----------+-----------+--------------------+
    | magic   | length    | crc32     | payload            |
    | 4 bytes | 4 bytes   | 4 bytes   | ``length`` bytes   |
    +---------+-----------+-----------+--------------------+

- zero-length payloads are legal (heartbeat-sized frames stay tiny);
- ``length`` above the channel's ``max_frame`` raises
  :class:`FrameTooLargeError` on the send side before any byte moves,
  and on the recv side before the payload is buffered (a garbled
  length cannot make the reader allocate unboundedly);
- a CRC mismatch raises :class:`ChecksumError`;
- a wrong magic raises :class:`ProtocolError` (the stream lost
  framing — after any ProtocolError the channel is poisoned and every
  later call re-raises, because resynchronizing a corrupt byte stream
  is guessing);
- EOF raises :class:`PeerClosedError`, whether the peer closed cleanly
  between frames or died mid-frame (the message distinguishes them);
- every ``send``/``recv`` takes an optional deadline; an expired one
  raises :class:`TransportTimeout` — a wedged peer cannot wedge the
  supervisor.

Messages are pickled Python objects (tuples of primitives and numpy
arrays — both endpoints are this repo's own processes, so pickle's
trust model is the OS process boundary itself).
"""
from __future__ import annotations

import pickle
import select
import socket
import struct
import time
import zlib

MAGIC = 0x48504950                       # "HPIP"
HEADER = struct.Struct(">III")           # magic, payload length, crc32
DEFAULT_MAX_FRAME = 64 * 1024 * 1024

# Cross-host wire protocol version: bumped whenever the framing or the
# control-message vocabulary changes incompatibly. Checked first thing
# in the connect/accept handshake so a worker from another build is
# refused with a typed HandshakeError instead of a garbled-stream
# ProtocolError three messages later.
PROTOCOL_VERSION = 1


class TransportError(RuntimeError):
    """Base of every typed transport failure."""


class ProtocolError(TransportError):
    """The byte stream is garbled (bad magic / unframeable): the
    channel has lost framing and cannot be trusted again."""


class ChecksumError(ProtocolError):
    """A frame's payload CRC32 does not match its header."""


class FrameTooLargeError(ProtocolError):
    """A frame's declared (or attempted) payload exceeds the channel's
    ``max_frame`` bound."""


class PeerClosedError(TransportError):
    """The peer's end of the channel is gone (clean close or death —
    possibly mid-frame)."""


class TransportTimeout(TransportError):
    """A per-call send/recv deadline expired."""


class HandshakeError(TransportError):
    """The connect/accept handshake failed: protocol version or
    model/plan fingerprint mismatch, or a malformed hello. The
    connection was refused cleanly — nothing about the byte stream is
    suspect, so this is NOT a :class:`ProtocolError`."""


def encode_frame(payload: bytes, *, max_frame: int = DEFAULT_MAX_FRAME
                 ) -> bytes:
    if len(payload) > max_frame:
        raise FrameTooLargeError(
            f"payload of {len(payload)} bytes exceeds the frame bound "
            f"{max_frame}")
    return HEADER.pack(MAGIC, len(payload),
                       zlib.crc32(payload) & 0xFFFFFFFF) + payload


class Channel:
    """One framed, deadline-aware endpoint over a connected stream
    socket (``socket.socketpair`` in the serving tier).

    The receive side is buffered: partial frames accumulate across
    reads (interleaved/short reads are reassembled), and
    :meth:`drain` returns every complete message currently available
    without blocking — the supervisor ``select``\\ s on :meth:`fileno`
    and drains whichever workers are readable."""

    def __init__(self, sock, *, max_frame: int = DEFAULT_MAX_FRAME):
        self._sock = sock
        self._sock.setblocking(False)
        self.max_frame = max_frame
        self._buf = bytearray()
        self._poisoned: TransportError | None = None
        self._closed = False
        self._eof = False

    def fileno(self) -> int:
        return self._sock.fileno()

    def close(self):
        if not self._closed:
            self._closed = True
            try:
                self._sock.close()
            except OSError:
                pass

    # -- send ----------------------------------------------------------------

    def send_bytes(self, payload: bytes, *, deadline_s=None):
        """Send one frame; ``deadline_s`` is a relative bound on the
        whole send (partial progress past it raises
        :class:`TransportTimeout`)."""
        self._check_usable()
        frame = encode_frame(payload, max_frame=self.max_frame)
        deadline = (time.monotonic() + deadline_s
                    if deadline_s is not None else None)
        view = memoryview(frame)
        while view:
            try:
                n = self._sock.send(view)
                view = view[n:]
            except (BlockingIOError, InterruptedError):
                self._wait(write=True, deadline=deadline,
                           what=f"send of {len(frame)}-byte frame")
            except (BrokenPipeError, ConnectionResetError, OSError) as e:
                raise PeerClosedError(
                    f"peer closed while sending ({e!r})") from e

    def send(self, obj, *, deadline_s=None):
        self.send_bytes(pickle.dumps(obj, pickle.HIGHEST_PROTOCOL),
                        deadline_s=deadline_s)

    # -- recv ----------------------------------------------------------------

    def recv_bytes(self, *, deadline_s=None) -> bytes:
        """Block (up to ``deadline_s``) until one complete frame is
        assembled; returns its payload."""
        self._check_usable()
        deadline = (time.monotonic() + deadline_s
                    if deadline_s is not None else None)
        while True:
            payload = self._pop_frame()
            if payload is not None:
                return payload
            if self._eof:
                raise self._eof_error()
            if not self._fill():
                self._wait(write=False, deadline=deadline,
                           what="recv")

    def recv(self, *, deadline_s=None):
        return pickle.loads(self.recv_bytes(deadline_s=deadline_s))

    def try_recv_bytes(self):
        """Non-blocking: one payload if a complete frame is available
        (buffered or immediately readable), else ``None``."""
        self._check_usable()
        payload = self._pop_frame()
        if payload is not None:
            return payload
        self._fill_nonblock()
        return self._pop_frame()

    def drain(self) -> list:
        """Non-blocking: every complete message currently available,
        in order. Reads the socket dry, then parses the buffer dry.
        Messages the peer sent before dying are delivered first; once
        none remain after EOF, :class:`PeerClosedError` is raised —
        a crashed worker's already-emitted results are never lost."""
        self._check_usable()
        self._fill_nonblock()
        out = []
        while True:
            payload = self._pop_frame()
            if payload is None:
                if not out and self._eof:
                    raise self._eof_error()
                return out
            out.append(pickle.loads(payload))

    def poll(self, timeout_s: float) -> bool:
        """True if a complete frame is buffered, the socket becomes
        readable within ``timeout_s``, or EOF was reached (so the
        caller's next recv/drain surfaces the typed error)."""
        if self._eof:
            return True
        if len(self._buf) >= HEADER.size:
            magic, length, _ = HEADER.unpack_from(self._buf)
            if len(self._buf) >= HEADER.size + length:
                return True
        r, _, _ = select.select([self._sock], [], [], max(timeout_s, 0.0))
        return bool(r)

    # -- internals -----------------------------------------------------------

    def _check_usable(self):
        if self._poisoned is not None:
            raise type(self._poisoned)(
                f"channel poisoned by earlier framing error: "
                f"{self._poisoned}")
        if self._closed:
            raise PeerClosedError("channel is closed")

    def _poison(self, err: TransportError):
        self._poisoned = err
        raise err

    def _pop_frame(self):
        """Parse one complete frame out of the buffer, if present."""
        if len(self._buf) < HEADER.size:
            return None
        magic, length, crc = HEADER.unpack_from(self._buf)
        if magic != MAGIC:
            self._poison(ProtocolError(
                f"bad frame magic 0x{magic:08x} (expected "
                f"0x{MAGIC:08x}): stream lost framing"))
        if length > self.max_frame:
            self._poison(FrameTooLargeError(
                f"incoming frame declares {length} bytes > bound "
                f"{self.max_frame}"))
        if len(self._buf) < HEADER.size + length:
            return None
        payload = bytes(self._buf[HEADER.size:HEADER.size + length])
        del self._buf[:HEADER.size + length]
        if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            self._poison(ChecksumError(
                f"frame CRC mismatch on a {length}-byte payload: "
                "corrupt in flight"))
        return payload

    def _eof_error(self) -> PeerClosedError:
        if self._buf:
            return PeerClosedError(
                f"peer closed mid-frame ({len(self._buf)} bytes of an "
                "incomplete frame buffered)")
        return PeerClosedError("peer closed")

    def _fill(self) -> bool:
        """One read attempt; True if bytes landed. EOF sets the flag
        (callers surface it via :meth:`_eof_error` once the buffer is
        out of complete frames)."""
        if self._eof:
            return False
        try:
            chunk = self._sock.recv(1 << 16)
        except (BlockingIOError, InterruptedError):
            return False
        except (ConnectionResetError, OSError) as e:
            raise PeerClosedError(f"peer reset ({e!r})") from e
        if chunk == b"":
            self._eof = True
            return False
        self._buf += chunk
        return True

    def _fill_nonblock(self):
        """Read the socket dry without blocking."""
        while self._fill():
            pass

    def _wait(self, *, write: bool, deadline, what: str):
        timeout = None
        if deadline is not None:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                raise TransportTimeout(f"deadline expired during {what}")
        rw = [self._sock]
        r, w, _ = select.select([] if write else rw, rw if write else [],
                                [], timeout)
        if deadline is not None and not (r or w) and \
                time.monotonic() >= deadline:
            raise TransportTimeout(f"deadline expired during {what}")


# --- cross-host TCP: listen / dial / handshake -------------------------------

class Listener:
    """A TCP accept socket whose connections come up as the SAME
    :class:`Channel` the socketpair tier uses — one framing, one error
    vocabulary, whether the peer shares a kernel or a datacenter.

    ``port=0`` binds an ephemeral port; :attr:`address` reports the
    bound ``(host, port)`` to advertise to dialing workers. ``accept``
    returns a raw (pre-handshake) channel — callers run
    :func:`server_handshake` (blocking) or feed the first message into
    :func:`check_hello` (non-blocking supervisors)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 backlog: int = 16, max_frame: int = DEFAULT_MAX_FRAME):
        self.max_frame = max_frame
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(backlog)
        self._sock.setblocking(False)
        self._closed = False

    @property
    def address(self) -> tuple[str, int]:
        return self._sock.getsockname()[:2]

    def fileno(self) -> int:
        return self._sock.fileno()

    def _wrap(self, sock) -> "Channel":
        # per-frame control messages dominate this protocol; Nagle
        # would batch heartbeats behind result payloads
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return Channel(sock, max_frame=self.max_frame)

    def try_accept(self):
        """Non-blocking: one inbound connection as a raw Channel, or
        ``None`` — the supervisor polls this inside its event loop."""
        try:
            sock, _addr = self._sock.accept()
        except (BlockingIOError, InterruptedError):
            return None
        except OSError as e:
            raise PeerClosedError(f"listener failed ({e!r})") from e
        return self._wrap(sock)

    def accept(self, *, deadline_s=None) -> "Channel":
        """Block (up to ``deadline_s``) for one inbound connection."""
        deadline = (time.monotonic() + deadline_s
                    if deadline_s is not None else None)
        while True:
            ch = self.try_accept()
            if ch is not None:
                return ch
            timeout = None
            if deadline is not None:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    raise TransportTimeout(
                        "deadline expired waiting for an inbound "
                        "connection")
            select.select([self._sock], [], [], timeout)

    def close(self):
        if not self._closed:
            self._closed = True
            try:
                self._sock.close()
            except OSError:
                pass


def connect(address: tuple[str, int] | str, *, deadline_s=None,
            max_frame: int = DEFAULT_MAX_FRAME) -> Channel:
    """Dial ``(host, port)`` (or ``"host:port"``) and return a raw
    (pre-handshake) :class:`Channel`. Refused/unreachable connections
    are retried until ``deadline_s`` (a supervisor mid-restart is a
    transient, not an error), then surface as
    :class:`TransportTimeout`; with no deadline a refusal raises
    :class:`PeerClosedError` immediately."""
    if isinstance(address, str):
        host, _, port = address.rpartition(":")
        address = (host, int(port))
    deadline = (time.monotonic() + deadline_s
                if deadline_s is not None else None)
    while True:
        try:
            timeout = None
            if deadline is not None:
                timeout = max(deadline - time.monotonic(), 0.001)
            sock = socket.create_connection(address, timeout=timeout)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            return Channel(sock, max_frame=max_frame)
        except (ConnectionRefusedError, ConnectionResetError,
                socket.timeout, OSError) as e:
            if deadline is None:
                raise PeerClosedError(
                    f"connect to {address} failed ({e!r})") from e
            if time.monotonic() >= deadline:
                raise TransportTimeout(
                    f"connect to {address} not accepted within "
                    f"{deadline_s}s (last: {e!r})") from e
            time.sleep(0.02)


def check_hello(msg, *, fingerprint: str):
    """Validate a client hello against this endpoint's protocol
    version + model/plan fingerprint. Returns the ``welcome`` reply to
    send on success; raises :class:`HandshakeError` on any mismatch
    (send ``("reject", str(err))`` to the peer before closing so the
    dialer fails typed too, not on EOF)."""
    if not (isinstance(msg, tuple) and len(msg) == 3
            and msg[0] == "hello"):
        raise HandshakeError(f"malformed hello {msg!r}")
    _, version, fp = msg
    if version != PROTOCOL_VERSION:
        raise HandshakeError(
            f"protocol version mismatch: peer speaks {version}, "
            f"this endpoint speaks {PROTOCOL_VERSION}")
    if fp != fingerprint:
        raise HandshakeError(
            f"model/plan fingerprint mismatch: peer built "
            f"{fp!r}, this endpoint serves {fingerprint!r} — "
            "refusing before any work is routed to wrong weights")
    return ("welcome", PROTOCOL_VERSION, fingerprint)


def client_handshake(ch: Channel, *, fingerprint: str,
                     deadline_s=None):
    """Dial-side handshake: offer (version, fingerprint), require a
    matching welcome. A ``reject`` or mismatched welcome raises
    :class:`HandshakeError`."""
    ch.send(("hello", PROTOCOL_VERSION, fingerprint),
            deadline_s=deadline_s)
    reply = ch.recv(deadline_s=deadline_s)
    if isinstance(reply, tuple) and reply and reply[0] == "reject":
        raise HandshakeError(f"peer rejected handshake: {reply[1]}")
    if reply != ("welcome", PROTOCOL_VERSION, fingerprint):
        raise HandshakeError(f"unexpected handshake reply {reply!r}")


def server_handshake(ch: Channel, *, fingerprint: str,
                     deadline_s=None):
    """Accept-side handshake (blocking form): validate the hello and
    welcome or reject the peer. Non-blocking supervisors instead feed
    the first drained message into :func:`check_hello`."""
    hello = ch.recv(deadline_s=deadline_s)
    try:
        reply = check_hello(hello, fingerprint=fingerprint)
    except HandshakeError as e:
        try:
            ch.send(("reject", str(e)), deadline_s=deadline_s)
        except TransportError:
            pass
        raise
    ch.send(reply, deadline_s=deadline_s)
