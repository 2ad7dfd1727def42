"""The port's cross-host serving tier (``runtime/tier.HostServingTier``):
workers (``python -m repro_torch.runtime.worker --dial ... --device
cpu``) dial the supervisor over real localhost TCP, handshake on the
serving fingerprint, fetch the packed param blob by SHA-256, and serve
through the port's frame-aware network fault injector
(``runtime/fault.NetFaultProxy``): the cases of the reference's
``tests/test_netserving.py``.

- TCP bitwise parity: the dial-in tier's logits equal the port's
  in-process ``ServingTier``'s bit for bit;
- a mid-stream connection kill is detected, the workers respawn and
  re-dial, and the recovered stream is bitwise identical;
- a one-way partition walks the cut-off worker through suspect into dead
  on the heartbeat path without wedging the tick loop; after the
  partition heals the stream completes bitwise (decided by margins: the
  death bound is seconds, a healthy worker's silence one tick);
- a bit-flipped param transfer is a typed startup failure, never wrong
  logits;
- the proxy's rules, the blob fetch (resume, cache, corruption,
  refusal) and the tier's frame-geometry check, unit by unit.

The tier-level cases carry the ``netfault`` marker; the workers run one
intra-op thread each. At most two workers per test."""
import hashlib
import os
import socket
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.runtime import fault as F  # noqa: E402
from repro_torch.runtime import tier as T  # noqa: E402
from repro_torch.runtime import transport  # noqa: E402
from repro_torch.runtime import worker as W  # noqa: E402


def _netfault(fn):
    """Tier-level tests start real worker interpreters."""
    fn = pytest.mark.netfault(fn)
    return pytest.mark.skipif(
        os.name != "posix",
        reason="worker process control needs POSIX")(fn)


ARCH = "mobilenet_v1"
IMG = 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread here and in every worker the tiers start (they
    inherit the environment)."""
    n = torch.get_num_threads()
    old = os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(n)
    if old is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = old


def _imgs(seed, batch):
    return np.random.default_rng(seed).standard_normal(
        (batch, IMG, IMG, 3)).astype(np.float32)


def _host_tier(**kw):
    kw.setdefault("n_procs", 2)
    kw.setdefault("n_stages", 2)
    kw.setdefault("mb_size", 2)
    kw.setdefault("image_size", IMG)
    kw.setdefault("device", "cpu")
    return T.HostServingTier(ARCH, **kw)


@pytest.fixture(scope="module")
def reference():
    """The port's in-process single-replica tier on the shared request
    stream: the bitwise ground truth of every cross-host case."""
    ref = T.ServingTier(ARCH, n_replicas=1, n_stages=2, mb_size=2,
                        image_size=IMG, device="cpu")
    rids = [ref.submit(_imgs(10 + i, 4)) for i in range(3)]
    ref.run()
    return [ref.results(r) for r in rids]


def _submit_stream(tier, n_req=3, batch=4, seed0=10):
    return [tier.submit(_imgs(seed0 + i, batch)) for i in range(n_req)]


# --- bitwise parity across the TCP boundary ----------------------------------

@_netfault
def test_host_tier_bitwise_matches_inprocess(reference):
    with _host_tier() as tier:
        assert tier.address[1] > 0           # a real bound TCP port
        blob_size = os.path.getsize(tier._blob)
        rids = _submit_stream(tier)
        m = tier.run()
        got = [tier.results(r) for r in rids]
    assert m["completed"] == 3 and m["failed"] == 0
    assert m["respawns"] == 0
    assert len(set(m["replica_pids"]) | {os.getpid()}) == 3
    # every worker proved its blob over the wire before admission
    assert len(m["worker_capabilities"]) == 2
    for caps in m["worker_capabilities"]:
        assert caps["blob_sha256"] == tier._blob_sha
        assert caps["device_count"] >= 1
    # the blob really travelled the channel (once per worker)
    assert m["blob_bytes_served"] == 2 * blob_size
    for a, b in zip(reference, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --- mid-tick connection kill ------------------------------------------------

def _free_port() -> int:
    """Pre-pick a port for the tier's listener so the fault proxy can
    be built in front of it BEFORE the tier spawns dialing workers."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@_netfault
def test_connection_kill_mid_stream_recovers_bitwise(reference):
    """Hard-close every proxied socket mid-stream: both workers' links
    die at an arbitrary byte boundary. The supervisor must detect the
    loss, respawn, the new generations must re-dial THROUGH the same
    proxy, resume the blob from their slot caches, and the delivered
    stream must be bitwise identical to the no-failure run."""
    port = _free_port()
    proxy = F.NetFaultProxy(("127.0.0.1", port))
    try:
        tier = _host_tier(listen=("127.0.0.1", port),
                          dial_addrs={0: proxy.address,
                                      1: proxy.address})
        try:
            rids = _submit_stream(tier)
            tier.run(max_rounds=2)        # let the stream start moving
            proxy.kill_connections()      # every link dies NOW
            deadline = time.monotonic() + 300
            while tier._live_rids() and time.monotonic() < deadline:
                tier.run(max_rounds=20)
            got = [tier.results(r) for r in rids]
            assert tier.respawns >= 1
            assert all(v == "transport" or v == "exit" for v in
                       [d["detected_via"] for d in tier.worker_exits])
            assert proxy.connections >= 3     # gen-0 pair + re-dials
        finally:
            tier.close()
    finally:
        proxy.close()
    for a, b in zip(reference, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --- one-way partition -------------------------------------------------------

@_netfault
def test_one_way_partition_suspected_dead_then_heals_bitwise(reference):
    """Sever only the worker→supervisor direction of worker 1's link:
    its heartbeats and results vanish while it still hears the
    supervisor (an asymmetric partition, the nastiest liveness case).
    The tick loop must keep serving through worker 0, walk worker 1
    through suspect into dead on the HEARTBEAT path, respawn it; after
    the partition heals the new generation re-registers and the full
    stream finishes bitwise."""
    port = _free_port()
    proxy = F.NetFaultProxy(("127.0.0.1", port))
    try:
        tier = _host_tier(listen=("127.0.0.1", port),
                          dial_addrs={1: proxy.address},
                          heartbeat_interval_s=0.1,
                          suspect_after_s=0.4, dead_after_s=4.0)
        try:
            rids = _submit_stream(tier)
            proxy.sever("c2s")            # worker 1 goes silent
            healed = False
            deadline = time.monotonic() + 300
            while tier._live_rids() and time.monotonic() < deadline:
                tier.run(max_rounds=10)   # must never wedge
                if not healed and tier.respawns >= 1:
                    proxy.heal()
                    healed = True
            got = [tier.results(r) for r in rids]
            assert healed, "worker 1 was never declared dead/respawned"
            assert tier.missed_heartbeats >= 1
            deaths = [d for d in tier.worker_exits if d["idx"] == 1]
            assert deaths and deaths[0]["detected_via"] == "heartbeat"
            assert proxy.frames_dropped["c2s"] >= 1
            assert tier.workers[1].generation >= 1
            assert tier.workers[1].capabilities is not None  # re-admitted
        finally:
            tier.close()
    finally:
        proxy.close()
    for a, b in zip(reference, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --- corrupted param transfer ------------------------------------------------

@_netfault
def test_bitflipped_param_transfer_refused_before_ready():
    """Flip one payload bit of the first blob chunk in flight
    (supervisor→worker). The frame CRC must catch it at the worker —
    a typed ChecksumError BEFORE the worker ever reports ready — and
    the tier's startup barrier must surface the death rather than
    admit a worker holding corrupt bits."""
    port = _free_port()
    # s2c frame 0 is the welcome; frame 1 is the first blobchunk
    proxy = F.NetFaultProxy(("127.0.0.1", port),
                            rules={"s2c": F.bitflip_frames({1})})
    try:
        with pytest.raises(RuntimeError) as ei:
            _host_tier(n_procs=1, listen=("127.0.0.1", port),
                       dial_addrs={0: proxy.address},
                       max_respawns=0, spawn_timeout_s=120.0)
        msg = str(ei.value)
        assert "died during startup" in msg or "not ready" in msg
        assert "ChecksumError" in msg     # the worker's typed refusal
    finally:
        proxy.close()


# =============================================================================
# cheap unit tests: proxy rules, handshake wiring, blob fetch
# =============================================================================

def _proxied_pair(proxy_rules=None):
    """A (client, server, proxy, listener) quad: client dials through
    a NetFaultProxy into a transport.Listener."""
    ls = transport.Listener()
    proxy = F.NetFaultProxy(ls.address, rules=proxy_rules)
    cl = transport.connect(proxy.address, deadline_s=5.0)
    sv = ls.accept(deadline_s=5.0)
    return cl, sv, proxy, ls


def _close_all(*objs):
    for o in objs:
        o.close()


def test_proxy_passthrough_and_frame_counters():
    cl, sv, proxy, ls = _proxied_pair()
    try:
        for i in range(3):
            cl.send(("hb", i))
        for i in range(3):
            assert sv.recv(deadline_s=5.0) == ("hb", i)
        sv.send(("ack",))
        assert cl.recv(deadline_s=5.0) == ("ack",)
        assert proxy.frames_forwarded["c2s"] == 3
        assert proxy.frames_forwarded["s2c"] == 1
        assert proxy.connections == 1
    finally:
        _close_all(cl, sv, proxy, ls)


def test_proxy_drop_rule_swallows_named_frames():
    cl, sv, proxy, ls = _proxied_pair({"c2s": F.drop_frames({0})})
    try:
        cl.send(("lost",))
        cl.send(("kept",))
        assert sv.recv(deadline_s=5.0) == ("kept",)
        assert proxy.frames_dropped["c2s"] == 1
    finally:
        _close_all(cl, sv, proxy, ls)


def test_proxy_duplicate_rule_redelivers():
    cl, sv, proxy, ls = _proxied_pair({"c2s": F.duplicate_frames({0})})
    try:
        cl.send(("twice",))
        assert sv.recv(deadline_s=5.0) == ("twice",)
        assert sv.recv(deadline_s=5.0) == ("twice",)
    finally:
        _close_all(cl, sv, proxy, ls)


def test_proxy_bitflip_rule_is_checksum_error_at_receiver():
    """In-flight corruption must surface as the transport's typed
    ChecksumError — the mutated payload is never delivered."""
    cl, sv, proxy, ls = _proxied_pair({"c2s": F.bitflip_frames({0})})
    try:
        cl.send(("precious", np.arange(8)))
        with pytest.raises(transport.ChecksumError):
            sv.recv(deadline_s=5.0)
    finally:
        _close_all(cl, sv, proxy, ls)


def test_proxy_truncate_rule_is_torn_midframe_close():
    cl, sv, proxy, ls = _proxied_pair({"c2s": F.truncate_frames({0})})
    try:
        cl.send(("torn-away",))
        with pytest.raises(transport.PeerClosedError) as ei:
            sv.recv(deadline_s=5.0)
        assert "mid-frame" in str(ei.value)
    finally:
        _close_all(cl, sv, proxy, ls)


def test_proxy_sever_is_oneway_and_healable():
    cl, sv, proxy, ls = _proxied_pair()
    try:
        proxy.sever("c2s")
        cl.send(("into the void",))
        with pytest.raises(transport.TransportTimeout):
            sv.recv(deadline_s=0.3)
        sv.send(("downstream still flows",))    # other direction lives
        assert cl.recv(deadline_s=5.0) == ("downstream still flows",)
        proxy.heal()
        cl.send(("back",))                      # dropped frame is gone
        assert sv.recv(deadline_s=5.0) == ("back",)
        assert proxy.frames_dropped["c2s"] == 1
    finally:
        _close_all(cl, sv, proxy, ls)


def test_proxy_kill_connections_kills_both_ends():
    cl, sv, proxy, ls = _proxied_pair()
    try:
        cl.send(("pre-kill",))
        assert sv.recv(deadline_s=5.0) == ("pre-kill",)
        proxy.kill_connections()
        with pytest.raises(transport.TransportError):
            for _ in range(64):            # until the RST/EOF lands
                cl.send(("doomed",), deadline_s=0.5)
                time.sleep(0.02)
        with pytest.raises(transport.TransportError):
            sv.recv(deadline_s=2.0)
    finally:
        _close_all(cl, sv, proxy, ls)


def test_proxy_accepts_sequential_connections():
    """Respawned worker generations re-dial the same proxy address:
    it must keep accepting after earlier connections die."""
    ls = transport.Listener()
    proxy = F.NetFaultProxy(ls.address)
    try:
        for gen in range(3):
            cl = transport.connect(proxy.address, deadline_s=5.0)
            sv = ls.accept(deadline_s=5.0)
            cl.send(("gen", gen))
            assert sv.recv(deadline_s=5.0) == ("gen", gen)
            cl.close(), sv.close()
        assert proxy.connections == 3
    finally:
        proxy.close()
        ls.close()


# --- the blob-by-hash fetch --------------------------------------------------

def _serve_blob(ch, blob, sha, chunk, *, close_after=None,
                corrupt_chunk=None, reject=False):
    """Minimal supervisor side of the blob protocol, over one channel.
    Returns the offsets requested (the resume evidence)."""
    offsets = []
    sent = 0
    while True:
        try:
            m = ch.recv(deadline_s=10.0)
        except transport.TransportError:
            return offsets
        if not (isinstance(m, tuple) and m[0] == "blob"):
            return offsets
        _tag, got_sha, off = m
        if reject or got_sha != sha:
            ch.send(("blobreject", f"unknown blob {got_sha[:8]}"))
            return offsets
        offsets.append(off)
        data = blob[off:off + chunk]
        if corrupt_chunk is not None and sent == corrupt_chunk:
            # corrupt CONTENT before framing: the CRC is computed over
            # the corrupted bytes, so only the end-to-end SHA-256
            # can catch it (a stale/torn cache file looks like this)
            data = bytes([data[0] ^ 0xFF]) + data[1:]
        ch.send(("blobchunk", off, len(blob), data))
        sent += 1
        if close_after is not None and sent >= close_after:
            ch.close()
            return offsets
        if off + len(data) >= len(blob):
            return offsets


def _fetch_pair():
    a, b = socket.socketpair()
    return transport.Channel(a), transport.Channel(b)


def test_fetch_param_blob_roundtrip_and_cache_hit(tmp_path):
    blob = np.random.default_rng(0).bytes(300_000)
    sha = hashlib.sha256(blob).hexdigest()
    wch, sch = _fetch_pair()
    t = threading.Thread(target=_serve_blob,
                         args=(sch, blob, sha, 65_536))
    t.start()
    path = W.fetch_param_blob(wch, sha, str(tmp_path))
    t.join(10.0)
    with open(path, "rb") as f:
        assert f.read() == blob
    # second call: pure cache hit, no channel traffic at all
    dead_a, dead_b = socket.socketpair()
    dead = transport.Channel(dead_a)
    dead_b.close()
    assert W.fetch_param_blob(dead, sha, str(tmp_path)) == path


def test_fetch_param_blob_resumes_from_partial(tmp_path):
    """Kill the transfer after two chunks; the retry must request the
    byte it actually has (offset == partial size), not byte 0 — the
    respawned generation inherits its predecessor's progress."""
    blob = np.random.default_rng(1).bytes(300_000)
    sha = hashlib.sha256(blob).hexdigest()
    chunk = 65_536
    wch, sch = _fetch_pair()
    t = threading.Thread(target=_serve_blob,
                         args=(sch, blob, sha, chunk),
                         kwargs={"close_after": 2})
    t.start()
    with pytest.raises(transport.TransportError):
        W.fetch_param_blob(wch, sha, str(tmp_path))
    t.join(10.0)
    part = tmp_path / f"{sha}.part"
    assert part.exists() and part.stat().st_size == 2 * chunk
    # reconnect (a fresh channel: the old connection is gone)
    wch2, sch2 = _fetch_pair()
    offsets = []
    t2 = threading.Thread(
        target=lambda: offsets.extend(
            _serve_blob(sch2, blob, sha, chunk)))
    t2.start()
    path = W.fetch_param_blob(wch2, sha, str(tmp_path))
    t2.join(10.0)
    assert offsets[0] == 2 * chunk       # resumed, not restarted
    with open(path, "rb") as f:
        assert f.read() == blob
    assert not part.exists()


def test_fetch_param_blob_content_corruption_is_typed(tmp_path):
    """A chunk whose CONTENT is wrong but whose frame CRC is fine
    (stale/torn at the source) must fail the end-to-end SHA-256 check
    as a CheckpointCorruptError, and must NOT leave a poisoned partial
    behind for the next generation to resume onto."""
    blob = np.random.default_rng(2).bytes(200_000)
    sha = hashlib.sha256(blob).hexdigest()
    wch, sch = _fetch_pair()
    t = threading.Thread(target=_serve_blob,
                         args=(sch, blob, sha, 65_536),
                         kwargs={"corrupt_chunk": 1})
    t.start()
    with pytest.raises(ckpt.CheckpointCorruptError) as ei:
        W.fetch_param_blob(wch, sha, str(tmp_path))
    t.join(10.0)
    assert "SHA-256" in str(ei.value)
    assert not (tmp_path / f"{sha}.part").exists()
    assert not (tmp_path / f"{sha}.blob").exists()


def test_fetch_param_blob_supervisor_reject_is_typed(tmp_path):
    blob = b"z" * 1000
    sha = hashlib.sha256(blob).hexdigest()
    wch, sch = _fetch_pair()
    t = threading.Thread(target=_serve_blob,
                         args=(sch, blob, sha, 512),
                         kwargs={"reject": True})
    t.start()
    with pytest.raises(ckpt.CheckpointCorruptError):
        W.fetch_param_blob(wch, sha, str(tmp_path))
    t.join(10.0)


def test_fetch_param_blob_evicts_stale_cache_entry(tmp_path):
    """A cached ``<sha>.blob`` whose bytes do NOT hash to <sha> (torn
    write, bitrot, tampering) must be evicted and refetched — serving
    from it would be exactly the wrong-logits failure this protocol
    exists to prevent."""
    blob = np.random.default_rng(3).bytes(100_000)
    sha = hashlib.sha256(blob).hexdigest()
    stale = tmp_path / f"{sha}.blob"
    stale.write_bytes(b"not the real bits")
    wch, sch = _fetch_pair()
    t = threading.Thread(target=_serve_blob,
                         args=(sch, blob, sha, 65_536))
    t.start()
    path = W.fetch_param_blob(wch, sha, str(tmp_path))
    t.join(10.0)
    with open(path, "rb") as f:
        assert f.read() == blob              # the REAL bits, refetched


def test_verify_blob_and_file_sha256(tmp_path):
    p = tmp_path / "b.bin"
    p.write_bytes(b"some param bytes")
    sha = hashlib.sha256(b"some param bytes").hexdigest()
    assert ckpt.file_sha256(str(p)) == sha
    assert ckpt.verify_blob(str(p), sha) == str(p)
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.verify_blob(str(p), "0" * 64)
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.verify_blob(str(tmp_path / "missing.bin"), sha)


def test_host_tier_rejects_bad_chunk_frame_geometry():
    with pytest.raises(ValueError):
        T.HostServingTier(ARCH, blob_chunk_bytes=1 << 20,
                          max_frame=1 << 20)    # no frame headroom
    with pytest.raises(ValueError):
        T.HostServingTier(ARCH, blob_chunk_bytes=0)
    with pytest.raises(ValueError):            # before any spawn
        T.HostServingTier(ARCH, device="cpu", heartbeat_interval_s=0.0)
