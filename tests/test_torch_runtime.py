"""The port's serving-tier runtime beside the reference's: the framed
transport, the replay ledger, the fault injectors and detectors, and the
packed param blob.

- frames: the port encodes every payload to the reference's bytes, and a
  port channel and a reference channel over one socketpair (or one TCP
  connection, handshake included) understand each other;
- ledger: a round trip, each typed corruption, and a ledger written by
  either package loaded by the other;
- ``fault.py``: the detectors' bands, the heartbeat-config invariants,
  the injector, and every frame rule, each beside the reference's;
- the param blob both ways: the reference writes, the port reads, equal
  to ``params_from_numpy`` bit for bit; the port writes the same bytes
  and the reference reads them. ResNet-50 native and int8 (a
  ``SparseWeight`` with its scale), MobileNet-V1 int8 (a
  ``QuantizedWeight``)."""
import functools
import json
import os
import pickle
import socket
import threading
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint import ckpt as ref_ckpt  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core.quant import QuantizedWeight as RefQuantizedWeight  # noqa: E402
from repro.core.quant import quantize_tree as ref_quantize_tree  # noqa: E402
from repro.models import cnn as ref_cnn  # noqa: E402
from repro.models.layers import SparseWeight as RefSparseWeight  # noqa: E402
from repro.runtime import fault as ref_fault  # noqa: E402
from repro.runtime import tier as ref_tier  # noqa: E402
from repro.runtime import transport as ref_transport  # noqa: E402
from repro.runtime import worker as ref_worker  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.core import pytree  # noqa: E402
from repro_torch.core.quant import QuantizedWeight  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.models.layers import SparseWeight  # noqa: E402
from repro_torch.runtime import fault  # noqa: E402
from repro_torch.runtime import tier  # noqa: E402
from repro_torch.runtime import transport  # noqa: E402
from repro_torch.runtime import worker  # noqa: E402


# --- frames and channels -------------------------------------------------------

_MESSAGES = [
    ("hb", 3, 1.25), ("ready", 4242), ("work", (0, 1),
                                       np.arange(24, dtype=np.float32)
                                       .reshape(2, 2, 2, 3), 2),
    ("result", (7, 0), np.linspace(-1, 1, 10, dtype=np.float32)),
    ("purge", 5), ("stop",), ("hello", transport.PROTOCOL_VERSION, "fp"),
    ("blobchunk", 0, 3, b"\x00\xff\x10"), ("fatal", "boom", "tb"),
]


@pytest.mark.parametrize("payload", [b"", b"x", b"abc" * 1000,
                                     bytes(range(256))])
def test_frames_byte_identical_to_the_reference(payload):
    assert transport.encode_frame(payload) == \
        ref_transport.encode_frame(payload)
    frame = transport.encode_frame(payload)
    magic, length, crc = transport.HEADER.unpack(frame[:12])
    assert (magic, length, crc) == (ref_transport.MAGIC, len(payload),
                                    zlib.crc32(payload) & 0xFFFFFFFF)
    assert (transport.MAGIC, transport.PROTOCOL_VERSION,
            transport.DEFAULT_MAX_FRAME, transport.HEADER.format) == (
        ref_transport.MAGIC, ref_transport.PROTOCOL_VERSION,
        ref_transport.DEFAULT_MAX_FRAME, ref_transport.HEADER.format)


def test_messages_and_handshake_replies_equal_the_reference():
    for m in _MESSAGES:
        payload = pickle.dumps(m, pickle.HIGHEST_PROTOCOL)
        assert transport.encode_frame(payload) == \
            ref_transport.encode_frame(payload)
    hello = ("hello", transport.PROTOCOL_VERSION, "fp")
    assert transport.check_hello(hello, fingerprint="fp") == \
        ref_transport.check_hello(hello, fingerprint="fp")
    for bad in [("hello", 99, "fp"), ("hello", 1, "other"), ("nope",)]:
        with pytest.raises(transport.HandshakeError) as got:
            transport.check_hello(bad, fingerprint="fp")
        with pytest.raises(ref_transport.HandshakeError) as want:
            ref_transport.check_hello(bad, fingerprint="fp")
        assert str(got.value) == str(want.value)


def _assert_same(a, b):
    assert type(a) is type(b) and len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
        else:
            assert x == y


def test_port_and_reference_channels_understand_each_other():
    a, b = socket.socketpair()
    port, ref = transport.Channel(a), ref_transport.Channel(b)
    try:
        for m in _MESSAGES:
            port.send(m)
            _assert_same(ref.recv(deadline_s=5.0), m)
            ref.send(m)
            _assert_same(port.recv(deadline_s=5.0), m)
        for m in _MESSAGES[:3]:
            ref.send(m)
        got = []
        while len(got) < 3:
            port.poll(1.0)
            got += port.drain()
        for g, m in zip(got, _MESSAGES[:3]):
            _assert_same(g, m)
        ref.close()
        with pytest.raises(transport.PeerClosedError):
            port.recv(deadline_s=5.0)
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("dial", ["port", "reference"])
def test_tcp_handshake_across_the_packages(dial):
    """A port worker dials a reference listener and the reverse: the
    handshake admits equal fingerprints, and a mismatch is a typed
    refusal on both ends."""
    listen_mod = ref_transport if dial == "port" else transport
    dial_mod = transport if dial == "port" else ref_transport
    for fp_server, fp_client, ok in (("fp", "fp", True),
                                     ("fp", "other", False)):
        ls = listen_mod.Listener()
        errors = []

        def accept():
            ch = ls.accept(deadline_s=5.0)
            try:
                listen_mod.server_handshake(ch, fingerprint=fp_server,
                                            deadline_s=5.0)
                ch.send(("admit",))
            except listen_mod.HandshakeError as e:
                errors.append(e)
            finally:
                ch.close()
        t = threading.Thread(target=accept)
        t.start()
        cl = dial_mod.connect(ls.address, deadline_s=5.0)
        try:
            if ok:
                dial_mod.client_handshake(cl, fingerprint=fp_client,
                                          deadline_s=5.0)
                assert cl.recv(deadline_s=5.0) == ("admit",)
            else:
                with pytest.raises(dial_mod.HandshakeError):
                    dial_mod.client_handshake(cl, fingerprint=fp_client,
                                              deadline_s=5.0)
        finally:
            t.join(10.0)
            cl.close()
            ls.close()
        assert bool(errors) != ok


def test_transport_errors_are_typed_like_the_reference():
    """A bit flipped in flight, bad magic, a frame over the bound and a
    torn close, each the reference's error type and message."""
    def pair():
        a, b = socket.socketpair()
        return transport.Channel(a, max_frame=64), b
    ch, raw = pair()
    frame = bytearray(transport.encode_frame(b"payload"))
    frame[-1] ^= 1
    raw.sendall(bytes(frame))
    with pytest.raises(transport.ChecksumError):
        ch.recv(deadline_s=5.0)
    with pytest.raises(transport.ChecksumError, match="poisoned"):
        ch.drain()
    ch, raw = pair()
    raw.sendall(b"\x00" * 12)
    with pytest.raises(transport.ProtocolError, match="magic"):
        ch.recv(deadline_s=5.0)
    ch, raw = pair()
    with pytest.raises(transport.FrameTooLargeError):
        ch.send_bytes(b"x" * 65)
    raw.sendall(transport.encode_frame(b"x" * 65, max_frame=1 << 10))
    with pytest.raises(transport.FrameTooLargeError):
        ch.recv(deadline_s=5.0)
    ch, raw = pair()
    raw.sendall(transport.encode_frame(b"complete")[:7])
    raw.close()
    with pytest.raises(transport.PeerClosedError, match="mid-frame"):
        ch.recv(deadline_s=5.0)
    ch, raw = pair()
    with pytest.raises(transport.TransportTimeout):
        ch.recv(deadline_s=0.05)
    for name in ("TransportError", "ProtocolError", "ChecksumError",
                 "FrameTooLargeError", "PeerClosedError",
                 "TransportTimeout", "HandshakeError"):
        got = [c.__name__ for c in getattr(transport, name).__mro__]
        want = [c.__name__ for c in getattr(ref_transport, name).__mro__]
        assert got == want


# --- the replay ledger ---------------------------------------------------------

def _ledger_arrays():
    return {"chunk_0_1": np.arange(2 * 4 * 4 * 3, dtype=np.float32)
            .reshape(2, 4, 4, 3),
            "logits_0_0": np.linspace(-3, 3, 20, dtype=np.float32)
            .reshape(2, 10)}


def test_ledger_roundtrip_and_pointer_gc(tmp_path):
    d = str(tmp_path)
    assert ckpt.load_ledger(d) is None
    ckpt.save_ledger(d, {"next_rid": 1, "requests": {}},
                     {"chunk_0_0": np.zeros((2, 4, 4, 3), np.float32)})
    ckpt.save_ledger(d, {"next_rid": 2, "requests": {}}, _ledger_arrays())
    meta, arrays = ckpt.load_ledger(d)
    assert meta == {"next_rid": 2, "requests": {}}
    assert sorted(arrays) == sorted(_ledger_arrays())
    for k, v in _ledger_arrays().items():
        np.testing.assert_array_equal(arrays[k], v)
    payloads = [n for n in os.listdir(d)
                if n.startswith("ledger-") and n.endswith(".npz")]
    assert len(payloads) == 1                # the superseded one went


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_ledger_written_by_one_package_loads_in_the_other(tmp_path, writer):
    save = (ckpt if writer == "port" else ref_ckpt).save_ledger
    load = (ref_ckpt if writer == "port" else ckpt).load_ledger
    meta = {"next_rid": 3, "next_seq": 9,
            "requests": {"2": {"tenant": "a", "priority": 1,
                               "n_images": 3, "n_mb": 2,
                               "n_valid": {"1": 1}, "done": False}}}
    save(str(tmp_path), meta, _ledger_arrays())
    got_meta, arrays = load(str(tmp_path))
    assert got_meta == meta
    for k, v in _ledger_arrays().items():
        np.testing.assert_array_equal(arrays[k], v)


def _corrupt(d, how):
    with open(os.path.join(d, "ledger.json")) as f:
        payload = os.path.join(d, json.load(f)["payload"])
    if how == "truncated":
        with open(payload, "r+b") as f:
            f.truncate(os.path.getsize(payload) - 16)
    elif how == "missing":
        os.remove(payload)
    elif how == "bitflip":
        with open(payload, "r+b") as f:
            f.seek(100)
            b = f.read(1)
            f.seek(100)
            f.write(bytes([b[0] ^ 0x40]))
    elif how == "pointer":
        with open(os.path.join(d, "ledger.json"), "w") as f:
            f.write('{"payload": "led')
    elif how == "unparseable":
        # a payload of the right size and CRC that is no .npz
        junk = b"\x00" * 64
        os.remove(payload)
        crc = zlib.crc32(junk) & 0xFFFFFFFF
        name = f"ledger-{crc:08x}-{len(junk)}.npz"
        with open(os.path.join(d, name), "wb") as f:
            f.write(junk)
        with open(os.path.join(d, "ledger.json"), "w") as f:
            json.dump({"payload": name, "crc32": crc, "nbytes": len(junk),
                       "time": 0.0, "meta": {}}, f)


@pytest.mark.parametrize("how,match", [
    ("truncated", "truncated"), ("missing", "missing"),
    ("bitflip", "CRC32"), ("pointer", "pointer"),
    ("unparseable", "unparseable")])
def test_ledger_corruption_is_typed(tmp_path, how, match):
    """Each way a ledger can break raises CheckpointCorruptError with the
    reference's message, in both packages."""
    for mod in (ckpt, ref_ckpt):
        d = str(tmp_path / mod.__name__.split(".")[0])
        ckpt.save_ledger(d, {"k": 1}, {"x": np.arange(1000)})
        _corrupt(d, how)
        with pytest.raises(mod.CheckpointCorruptError, match=match):
            mod.load_ledger(d)


def test_blob_hash_and_verify_match_the_reference(tmp_path):
    p = tmp_path / "b.bin"
    p.write_bytes(np.random.default_rng(0).bytes(3 << 20))
    sha = ckpt.file_sha256(str(p))
    assert sha == ref_ckpt.file_sha256(str(p))
    assert ckpt._file_crc(str(p)) == ref_ckpt._file_crc(str(p))
    assert ckpt.verify_blob(str(p), sha) == str(p)
    with pytest.raises(ckpt.CheckpointCorruptError, match="SHA-256"):
        ckpt.verify_blob(str(p), "0" * 64)
    with pytest.raises(ckpt.CheckpointCorruptError, match="unreadable"):
        ckpt.verify_blob(str(tmp_path / "missing"), sha)


# --- fault.py: detectors, injector, frame rules --------------------------------

def _detector_trace(mod):
    d = mod.FailureDetector(interval_s=0.1, suspect_after_s=0.4,
                            dead_after_s=1.0)
    out = []
    d.reset("w", 0.0)
    d.beat("w", 0.1, progress=1)
    for t in (0.2, 0.6, 1.2):
        out.append((d.state("w", t), d.missed("w", t), d.silent_for("w", t)))
    t = 1.2
    while t < 2.7:                           # beats, but the tick is stuck
        t += 0.1
        d.beat("w", t, progress=3)
    out.append((d.state("w", t, busy=True), d.state("w", t, busy=False)))
    d.reset("w", 5.0)
    d.beat("w", 5.5, progress=4)
    d.beat("w", 6.0, progress=5)
    out.append((d.state("w", 6.1), d.state("w", 7.0)))
    return out


def test_failure_detector_bands_equal_the_reference():
    got, want = _detector_trace(fault), _detector_trace(ref_fault)
    assert got == want
    assert [s[0] for s in got[:3]] == ["alive", "suspect", "dead"]
    assert got[3] == ("dead", "alive")       # wedged only when busy
    d = fault.FailureDetector(interval_s=0.1)
    assert (d.suspect_after_s, d.dead_after_s) == (
        pytest.approx(0.4), pytest.approx(2.5))


def test_failure_detector_idle_time_is_not_a_stall():
    """A worker handed work after sitting idle past ``dead_after_s`` is
    alive: its stall clock starts at the hand-over, not at its last tick
    before the idle spell."""
    d = fault.FailureDetector(interval_s=0.1, suspect_after_s=0.4,
                              dead_after_s=1.0)
    d.reset("w", 0.0)
    d.beat("w", 0.1, progress=1)
    t = 0.1
    while t < 5.0:                           # idle: beats, no new ticks
        t += 0.1
        d.beat("w", t, progress=1)
    assert d.state("w", t, busy=False) == "alive"
    assert d.state("w", t, busy=True) == "dead"  # what idle time reads as
    d.work_started("w", t)
    assert d.state("w", t + 0.1, busy=True) == "alive"
    d.beat("w", t + 0.6, progress=1)           # busy, and the tick stuck
    assert d.state("w", t + 0.6, busy=True) == "suspect"
    d.beat("w", t + 1.2, progress=1)
    assert d.state("w", t + 1.2, busy=True) == "dead"
    d.work_started("new", 7.0)               # never beat: progress -1
    assert d.state("new", 7.3, busy=True) == "alive"


@pytest.mark.parametrize("iv,sus,dead", [
    (0.0, 0.4, 1.0), (-0.1, 0.4, 1.0), (0.5, 0.1, 5.0), (0.5, 0.6, 1.0),
    (0.1, 0.5, 0.5), (0.1, 0.6, 0.5), (0.1, 0.4, 1.0), (0.1, 0.5, 10.0)])
def test_heartbeat_config_invariants_equal_the_reference(iv, sus, dead):
    def outcome(mod):
        try:
            mod.validate_heartbeat_config(iv, sus, dead)
            return None
        except ValueError as e:
            return str(e)
    assert outcome(fault) == outcome(ref_fault)


def test_straggler_detector_and_injector_equal_the_reference():
    rng = np.random.default_rng(0)
    samples = [(int(h), step, float(dt)) for step in range(40)
               for h, dt in zip(range(3), rng.uniform(0.9, 1.1, 3)
                                * np.array([1.0, 1.0, 3.0 if step > 10
                                            else 1.0]))]
    got, want = fault.StragglerDetector(), ref_fault.StragglerDetector()
    flags = [(got.record(*s), want.record(*s)) for s in samples]
    assert all(a == b for a, b in flags)
    assert got.flagged == want.flagged and got.flagged
    assert {h for h, *_ in got.flagged} == {2}
    inj = fault.FailureInjector(fail_at_steps=(2, 5))
    fired = []
    for step in (0, 1, 2, 2, 3, 5, 5):
        try:
            inj.maybe_fail(step)
        except fault.InjectedFailure:
            fired.append(step)
    assert fired == [2, 5]                   # once each


@pytest.mark.parametrize("rule", ["drop", "duplicate", "delay", "bitflip",
                                  "truncate"])
def test_frame_rules_equal_the_reference(rule):
    frames = [transport.encode_frame(pickle.dumps(("hb", i)))
              for i in range(4)]
    make = {"drop": lambda m: m.drop_frames({1, 3}),
            "duplicate": lambda m: m.duplicate_frames({0}),
            "delay": lambda m: m.delay_frames({2}, 0.0),
            "bitflip": lambda m: m.bitflip_frames({1}),
            "truncate": lambda m: m.truncate_frames({2}, keep=5)}[rule]

    def apply(mod):
        f, out = make(mod), []
        for i, fr in enumerate(frames):
            try:
                out.append(f(0, i, fr))
            except mod.SeveredConnection as e:
                out.append(("severed", e.partial))
        return out
    got, want = apply(fault), apply(ref_fault)
    assert got == want
    if rule == "bitflip":
        assert got[1][0] != frames[1] and len(got[1][0]) == len(frames[1])
    if rule == "truncate":
        assert got[2] == ("severed", frames[2][:5])


def test_proxy_bitflip_is_checksum_error_at_a_reference_receiver():
    """A port worker's channel through the port's proxy into a reference
    listener: a flipped bit is the receiver's ChecksumError."""
    ls = ref_transport.Listener()
    proxy = fault.NetFaultProxy(ls.address,
                                rules={"c2s": fault.bitflip_frames({1})})
    cl = transport.connect(proxy.address, deadline_s=5.0)
    sv = ls.accept(deadline_s=5.0)
    try:
        cl.send(("intact",))
        cl.send(("precious", np.arange(8)))
        assert sv.recv(deadline_s=5.0) == ("intact",)
        with pytest.raises(ref_transport.ChecksumError):
            sv.recv(deadline_s=5.0)
    finally:
        for o in (cl, sv, proxy, ls):
            o.close()


def test_backoff_and_admission_equal_the_reference():
    """The request-facing core is the reference's: the full-jitter
    backoff draws the same schedule from the same seed, and admission
    pops the same order (priority, deadline, tenant rotation, FIFO)."""
    def backoff(mod):
        t = object.__new__(mod.ServingTier)
        t._init_bookkeeping(max_queue_per_tenant=None,
                            request_timeout_s=None, max_retries=2,
                            backoff_base_s=0.1, backoff_max_s=2.0,
                            jitter_seed=7, clock=lambda: 0.0,
                            sleep=lambda s: None, verbose=False)
        return [t._backoff_s(n) for n in (1, 2, 3, 4, 12) for _ in range(20)]
    assert backoff(tier) == backoff(ref_tier)

    def order(mod):
        q = mod.AdmissionQueue()
        for seq, (tenant, pr, dl) in enumerate(
                [("a", 0, None), ("a", 0, 5.0), ("b", 1, None),
                 ("a", 0, 2.0), ("b", 0, None), ("c", 0, None),
                 ("c", 0, None), ("b", 0, 2.0)]):
            q.push(mod.WorkItem(rid=seq, mb_index=0, n_valid=1, images=None,
                                tenant=tenant, priority=pr, deadline_at=dl,
                                seq=seq))
        return [q.pop().rid for _ in range(8)]
    assert order(tier) == order(ref_tier)


# --- the packed param blob -----------------------------------------------------

def _numpy_tree(params):
    tree = {}
    for name, p in params.items():
        w = p["w"]
        if isinstance(w, RefSparseWeight):
            d = {"vals": np.asarray(w.vals), "idx": np.asarray(w.idx),
                 "d_in": w.d_in}
            if w.scale is not None:
                d.update(scale=np.asarray(w.scale), orig_dtype=w.orig_dtype)
            w = d
        elif isinstance(w, RefQuantizedWeight):
            w = {"codes": np.asarray(w.codes), "scale": np.asarray(w.scale),
                 "orig_dtype": w.orig_dtype}
        else:
            w = np.asarray(w)
        tree[name] = {"w": w, "b": np.asarray(p["b"])}
    return tree


@functools.lru_cache(maxsize=None)
def _ref_params(arch, quantize):
    p = jax.jit(lambda k: ref_cnn.init_cnn(ref_get_config(arch), k))(
        jax.random.PRNGKey(0))
    return ref_quantize_tree(p, quantize) if quantize != "native" else p


def _port_leaves(tree):
    """Every leaf as (key, bits): bf16 viewed as int16."""
    out = {}
    for key, t in pytree.keyed_leaves(tree):
        t = t.detach()
        out[key] = (str(t.dtype),
                    (t.view(torch.int16) if t.dtype == torch.bfloat16
                     else t).numpy())
    return out


def _assert_same_tree(got, want):
    g, w = _port_leaves(got), _port_leaves(want)
    assert list(g) == list(w)
    for key in w:
        assert g[key][0] == w[key][0], key
        np.testing.assert_array_equal(g[key][1], w[key][1], err_msg=key)
    for name in want:
        gw, ww = got[name]["w"], want[name]["w"]
        assert type(gw) is type(ww), name
        if isinstance(ww, SparseWeight):
            assert (gw.d_in, gw.orig_dtype) == (ww.d_in, ww.orig_dtype)
        if isinstance(ww, QuantizedWeight):
            assert gw.orig_dtype == ww.orig_dtype


_BLOB_CASES = [("resnet50", "native"), ("resnet50", "int8"),
               ("mobilenet_v1", "int8")]


@pytest.mark.parametrize("arch,quantize", _BLOB_CASES, ids=str)
def test_reference_blob_read_by_the_port_bitwise(tmp_path, arch, quantize):
    ref = _ref_params(arch, quantize)
    path = ref_worker.write_param_blob(ref, str(tmp_path / "ref.blob"))
    want = cnn.params_from_numpy(_numpy_tree(ref), device="cpu")
    kinds = {(type(p["w"]).__name__, getattr(p["w"], "scale", None)
              is not None) for p in want.values()}
    assert kinds == {
        ("resnet50", "native"): {("SparseWeight", False), ("Tensor", False)},
        ("resnet50", "int8"): {("SparseWeight", True),
                               ("QuantizedWeight", True)},
        ("mobilenet_v1", "int8"): {("QuantizedWeight", True)}}[
            (arch, quantize)]
    # the template's values do not matter, only its structure
    template = {n: {k: (v if not isinstance(v, torch.Tensor)
                        else torch.zeros_like(v)) for k, v in p.items()}
                for n, p in want.items()}
    got = worker.read_param_blob(template, path)
    _assert_same_tree(got, want)


@pytest.mark.parametrize("arch,quantize", _BLOB_CASES, ids=str)
def test_port_blob_is_the_references_bytes(tmp_path, arch, quantize):
    """The port writes the same tree to the same bytes as the reference
    (so the same SHA-256), and the reference's reader maps it back to
    its own arrays bit for bit."""
    ref = _ref_params(arch, quantize)
    port = cnn.params_from_numpy(_numpy_tree(ref), device="cpu")
    p_path = worker.write_param_blob(port, str(tmp_path / "port.blob"))
    r_path = ref_worker.write_param_blob(ref, str(tmp_path / "ref.blob"))
    assert ckpt.file_sha256(p_path) == ref_ckpt.file_sha256(r_path)
    back = ref_worker.read_param_blob(ref, p_path)
    flat_r = jax.tree_util.tree_leaves(ref)
    flat_b = jax.tree_util.tree_leaves(back)
    assert len(flat_r) == len(flat_b)
    for a, b in zip(flat_r, flat_b):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), np.asarray(b)
                                      .view(np.uint8))


def test_blob_round_trip_and_refusals(tmp_path):
    from repro_torch.configs import get_config
    from repro_torch.core.quant import quantize_tree
    from repro_torch.launch.serve import _init_native
    native = _init_native(get_config("mobilenet_v2"), 3)
    for q in ("native", "bf16", "f32", "int8"):
        params = quantize_tree(native, q)
        path = worker.write_param_blob(params, str(tmp_path / f"{q}.blob"))
        _assert_same_tree(worker.read_param_blob(params, path), params)
    (tmp_path / "junk").write_bytes(b"NOTABLOB" + b"\x00" * 16)
    with pytest.raises(ValueError, match="not a param blob"):
        worker.read_param_blob(native, str(tmp_path / "junk"))
    with pytest.raises(ValueError, match="template"):
        worker.read_param_blob(quantize_tree(native, "f32"),
                               str(tmp_path / "native.blob"))


def test_serving_fingerprint_covers_every_bit_determining_input():
    base = dict(arch="m", stages=2, mb_size=2, image_size=32, seed=0,
                quantize="native", blob_sha256="a" * 64, device="cuda")
    fp = worker.serving_fingerprint(**base)
    assert worker.serving_fingerprint(**{**base, "device": "cuda:0"}) == fp
    for key, other in [("arch", "n"), ("stages", 4), ("mb_size", 1),
                       ("image_size", 64), ("seed", 7),
                       ("quantize", "int8"), ("blob_sha256", "b" * 64),
                       ("device", "cpu")]:
        assert worker.serving_fingerprint(**{**base, key: other}) != fp
