"""The port's cross-process serving tier
(``runtime/tier.ProcessServingTier``): real OS-process replica workers
(``python -m repro_torch.runtime.worker --device cpu``) under real
signals, the cases of the reference's ``tests/test_procserving.py``.

- cross-process bitwise parity: the process tier's logits equal the
  port's in-process ``ServingTier``'s bit for bit (one param blob, one
  re-derived plan);
- SIGKILL mid-tick: detected by waitpid or channel EOF, respawned,
  replayed, bitwise;
- SIGSTOP: flagged suspect (straggler), not dead, while ``dead_after_s``
  is generous; after SIGCONT it finishes its work;
- a worker wedged for good crosses into dead on the heartbeat path;
- a worker idle past the death bound and then handed work is alive;
- supervisor restart: a fresh tier adopts the crash-safe ledger and
  finishes bitwise;
- bad heartbeat and backoff settings refused before any spawn, and a
  worker told ``cuda`` without a card exits non-zero.

The heartbeat cases are decided by margins, not by tight sleeps: a
healthy worker's longest silence is one tick of MobileNet-V1 at 32 px
(tens of milliseconds alone, well under a second when the suite runs six
files side by side), and the death bounds here are seconds. The workers
run one intra-op thread each (``OMP_NUM_THREADS=1``), as the test
process does. At most two workers per test."""
import os
import signal
import socket
import tempfile
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.runtime import tier as T  # noqa: E402
from repro_torch.runtime import worker as W  # noqa: E402

pytestmark = [
    pytest.mark.procfault,
    pytest.mark.skipif(os.name != "posix",
                       reason="SIGKILL/SIGSTOP fault hooks need POSIX"),
]

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


def _proc_tier(**kw):
    kw.setdefault("n_procs", 2)
    kw.setdefault("n_stages", 2)
    kw.setdefault("mb_size", 2)
    kw.setdefault("image_size", IMG)
    kw.setdefault("device", "cpu")
    return T.ProcessServingTier(ARCH, **kw)


@pytest.fixture(scope="module")
def reference():
    """The port's in-process single-replica tier on the shared request
    stream: the bitwise ground truth of every case here."""
    ref = T.ServingTier(ARCH, n_replicas=1, n_stages=2, mb_size=2,
                        image_size=IMG, device="cpu")
    rids = [ref.submit(_imgs(10 + i, 4)) for i in range(3)]
    ref.run()
    return [ref.results(r) for r in rids]


def _submit_stream(tier, n_req=3, batch=4, seed0=10):
    return [tier.submit(_imgs(seed0 + i, batch)) for i in range(n_req)]


def _assert_bitwise(reference, got):
    assert len(reference) == len(got)
    for a, b in zip(reference, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --- bitwise parity across the process boundary ------------------------------

def test_process_tier_bitwise_matches_inprocess(reference):
    with _proc_tier() as tier:
        rids = _submit_stream(tier)
        m = tier.run()
        got = [tier.results(r) for r in rids]
        ready = list(tier.ready_times)
    assert m["completed"] == 3 and m["failed"] == 0
    assert m["respawns"] == 0
    assert len(m["replica_pids"]) == 2
    assert len(set(m["replica_pids"]) | {os.getpid()}) == 3  # real procs
    assert sorted(r["idx"] for r in ready) == [0, 1]
    assert all(r["seconds"] > 0 for r in ready)
    # the CPU runs the plain versions: no kernel launches in a worker
    assert all(set(r["launches"].values()) == {0} for r in ready)
    _assert_bitwise(reference, got)


# --- SIGKILL mid-stream ------------------------------------------------------

def test_sigkill_mid_tick_recovers_bitwise(reference):
    with _proc_tier(worker_hooks={1: {"kill_at_tick": 1}}) as tier:
        rids = _submit_stream(tier)
        m = tier.run()
        got = [tier.results(r) for r in rids]
    assert m["completed"] == 3 and m["failed"] == 0
    assert m["respawns"] == 1
    assert m["recovered_microbatches"] >= 1
    [death] = m["worker_exits"]
    assert death["idx"] == 1 and death["exit_code"] == -signal.SIGKILL
    assert death["detected_via"] in ("exit", "transport")
    assert m["recovery_s"] is not None and 0.0 < m["recovery_s"] < 60.0
    _assert_bitwise(reference, got)


# --- SIGSTOP: slow is not dead -----------------------------------------------

def test_sigstop_flags_straggler_not_dead(reference):
    with _proc_tier(heartbeat_interval_s=0.1, suspect_after_s=0.4,
                    dead_after_s=30.0,
                    worker_hooks={1: {"stop_at_tick": 1}}) as tier:
        rids = _submit_stream(tier)
        deadline = time.monotonic() + 120
        resumed = False
        while tier._live_rids() and time.monotonic() < deadline:
            tier.run(max_rounds=20)
            w = tier.workers[1]
            if not resumed and w.straggler:
                os.kill(w.pid, signal.SIGCONT)
                resumed = True
        got = [tier.results(r) for r in rids]
        assert resumed, "worker 1 was never flagged straggler"
        assert tier.respawns == 0          # slow != dead
        assert tier.missed_heartbeats >= 1
        assert tier.straggler_events
        assert tier.workers[1].generation == 0
    _assert_bitwise(reference, got)


def test_wedged_worker_declared_dead_via_heartbeats(reference):
    """A worker SIGSTOP'd for good crosses suspect into dead on the
    HEARTBEAT path (no exit, no channel EOF), is killed and replaced, and
    the stream finishes bitwise. ``dead_after_s`` is 6 s: the wedged
    worker's silence grows without bound and reaches it, the healthy
    worker's (one tick) stays far below it however loaded the host."""
    with _proc_tier(heartbeat_interval_s=0.1, suspect_after_s=0.3,
                    dead_after_s=6.0,
                    worker_hooks={1: {"stop_at_tick": 1}}) as tier:
        rids = _submit_stream(tier)
        m = tier.run()
        got = [tier.results(r) for r in rids]
    assert m["completed"] == 3 and m["failed"] == 0
    assert m["respawns"] == 1
    [death] = m["worker_exits"]
    assert death["idx"] == 1
    assert death["detected_via"] == "heartbeat"
    assert death["exit_code"] == -signal.SIGKILL   # the supervisor's kill
    assert m["missed_heartbeats"] >= 3
    _assert_bitwise(reference, got)


def test_worker_idle_past_dead_after_is_not_declared_dead(reference):
    """Workers that sat idle for longer than ``dead_after_s`` and are
    then handed work stay alive: an idle worker's tick count cannot
    advance, and its stall clock starts when the work arrives. The idle
    spell is made by moving the tier's clock forward a minute, not by
    sleeping; the supervisor first reads a heartbeat from each worker on
    the moved clock, so their silence is not what is judged."""
    skew = [0.0]

    def clock():
        return time.monotonic() + skew[0]

    with _proc_tier(heartbeat_interval_s=0.1, dead_after_s=6.0,
                    clock=clock) as tier:
        rids = _submit_stream(tier, n_req=1)
        first = tier.run()
        skew[0] += 60.0
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline and any(
                tier.detector.silent_for(w.idx, clock()) > 1.0
                for w in tier.workers):
            tier._wait_events(0.1)
        rids += _submit_stream(tier, n_req=2, seed0=11)
        m = tier.run()
        got = [tier.results(r) for r in rids]
    assert first["completed"] == 1
    assert m["completed"] == 2 and m["failed"] == 0
    assert m["worker_exits"] == [] and m["respawns"] == 0
    _assert_bitwise(reference, got)


# --- supervisor restart from the ledger --------------------------------------

@pytest.mark.parametrize("rounds", [0, 2])
def test_supervisor_restart_resumes_ledger_bitwise(reference, rounds):
    """A fresh tier pointed at the ledger of a supervisor that died
    right after admission (0 rounds) or mid-stream (2 rounds: some
    results may have landed, however loaded the host) finishes the
    stream bitwise: a request is in the ledger from its admission."""
    with tempfile.TemporaryDirectory() as ldir:
        tier1 = _proc_tier(n_procs=1, ledger_dir=ldir)
        try:
            rids = _submit_stream(tier1)
            if rounds:
                tier1.run(max_rounds=rounds)
        finally:
            tier1.close()
        with _proc_tier(n_procs=1, ledger_dir=ldir) as tier2:
            tier2.run()
            got = [tier2.results(r) for r in rids]
    _assert_bitwise(reference, got)


# --- construction-time validation (cheap: fails before any spawn) ------------

@pytest.mark.parametrize("bad", [
    dict(heartbeat_interval_s=0.0),
    dict(heartbeat_interval_s=-1.0),
    dict(heartbeat_interval_s=0.5, suspect_after_s=0.1),
    dict(heartbeat_interval_s=0.5, dead_after_s=1.0),    # <= 2x interval
    dict(suspect_after_s=5.0, dead_after_s=5.0),         # slow == dead
    dict(suspect_after_s=6.0, dead_after_s=5.0),
])
def test_heartbeat_config_validated_before_spawn(bad, monkeypatch):
    monkeypatch.setattr(T.ProcessServingTier, "_spawn_proc", None)
    with pytest.raises(ValueError):
        _proc_tier(**bad)
    with pytest.raises(ValueError):        # before the device is looked at
        _proc_tier(device="cuda", **bad)


def test_backoff_config_validated(monkeypatch):
    monkeypatch.setattr(T.ProcessServingTier, "_spawn_proc", None)
    with pytest.raises(ValueError):
        _proc_tier(backoff_base_s=-0.1)
    with pytest.raises(ValueError):
        _proc_tier(backoff_max_s=-1.0)


def test_worker_told_cuda_without_a_card_exits_nonzero():
    """The worker never serves on the CPU when told ``cuda``: without a
    card it reports a fatal error to the supervisor and exits 1."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    sup, child = socket.socketpair()
    fd = os.dup(child.fileno())            # the worker closes its own fd
    child.close()
    try:
        rc = W.main(["--fd", str(fd), "--arch", ARCH,
                     "--image-size", str(IMG), "--device", "cuda"])
        from repro_torch.runtime import transport
        ch = transport.Channel(sup)
        [msg] = ch.drain()
        assert rc == 1
        assert msg[0] == "fatal" and "CUDA is not available" in msg[1]
    finally:
        sup.close()
