"""The port's in-process serving tier (``runtime/tier.ServingTier``) and
its hooks on ``CNNPipelineServer``, on the CPU: the non-placed cases of
the reference's ``tests/test_serving_tier.py`` on MobileNet-V1 at 32 px,
S 2, mb 2, and the tier beside the reference's.

- admission, request-atomic submit, deadline / timeout shedding and
  retry exhaustion, typed as in the reference;
- drain-and-respawn: killing one of two replicas mid-stream, and a
  respawned replica serving again, deliver logits bitwise equal to the
  no-failure stream, and both equal the port's own ``CNNPipelineServer``
  and its sequential forward on the same microbatches;
- against the reference: ResNet-50 on the reference's weights (carried
  across with ``params_from_numpy``) within the parity bar of the
  reference's ``ServingTier`` (1e-3 of max |logit|, top-1 equal), and the
  metric keys equal;
- the server's hooks: ``enqueue`` / ``on_result``, ``purge``,
  ``recover_work`` and a ``respawn`` that reallocates nothing.

Images are drawn with numpy from fixed seeds."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.models import cnn as ref_cnn  # noqa: E402
from repro.models.layers import SparseWeight as RefSparseWeight  # noqa: E402
from repro.runtime import tier as ref_tier  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import planner  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.runtime import tier as T  # noqa: E402
from repro_torch.runtime.fault import (FailureInjector,  # noqa: E402
                                       InjectedFailure)

ARCH = "mobilenet_v1"
IMG = 32
LOGIT_RTOL = 1e-3          # the parity bar of tests/test_torch_cnn.py


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread (xdist runs files side by side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _imgs(seed, batch, size=IMG):
    return np.random.default_rng(seed).standard_normal(
        (batch, size, size, 3)).astype(np.float32)


def _stream(tier, n_req=3, batch=4, seed0=10):
    rids = [tier.submit(_imgs(seed0 + i, batch)) for i in range(n_req)]
    metrics = tier.run()
    return [tier.results(r) for r in rids], metrics


def _tier(**kw):
    kw.setdefault("n_replicas", 2)
    kw.setdefault("n_stages", 2)
    kw.setdefault("mb_size", 2)
    kw.setdefault("image_size", IMG)
    kw.setdefault("device", "cpu")
    return T.ServingTier(ARCH, **kw)


class _AlwaysFail(FailureInjector):
    def maybe_fail(self, step):
        raise InjectedFailure("always")


# --- admission queue (pure python, no pipelines) ----------------------------

def test_admission_queue_priority_deadline_fifo():
    q = T.AdmissionQueue()
    mk = lambda rid, pr, dl, seq: T.WorkItem(  # noqa: E731
        rid=rid, mb_index=0, n_valid=1, images=None, priority=pr,
        deadline_at=dl, seq=seq)
    q.push(mk(0, 0, None, 1))          # plain FIFO
    q.push(mk(1, 0, 5.0, 2))           # deadline beats no-deadline
    q.push(mk(2, 1, None, 3))          # priority beats both
    q.push(mk(3, 0, 2.0, 4))           # earlier deadline beats later
    assert [q.pop().rid for _ in range(4)] == [2, 3, 1, 0]
    assert q.pop() is None


def test_admission_queue_tenant_fairness_on_ties():
    q = T.AdmissionQueue()
    for seq in range(6):
        q.push(T.WorkItem(rid=seq, mb_index=0, n_valid=1, images=None,
                          tenant="a" if seq < 3 else "b", seq=seq))
    assert [q.pop().tenant for _ in range(6)] == \
        ["a", "b", "a", "b", "a", "b"]


def test_admission_queue_bound_and_recovery_bypass():
    q = T.AdmissionQueue(max_per_tenant=2)
    q.push(T.WorkItem(rid=0, mb_index=0, n_valid=1, images=None, seq=1))
    q.push(T.WorkItem(rid=0, mb_index=1, n_valid=1, images=None, seq=2))
    with pytest.raises(T.QueueFullError):
        q.admit_check("default", 1)
    q.push(T.WorkItem(rid=1, mb_index=0, n_valid=1, images=None, seq=0),
           front=True)
    assert len(q) == 3
    assert q.pop().rid == 1
    assert q.purge(0) == 2 and len(q) == 0


# --- typed shedding (no tick ever runs) -------------------------------------

def test_submit_queue_full_is_request_atomic():
    tier = _tier(n_replicas=1, max_queue_per_tenant=3)
    tier.submit(_imgs(0, 4))           # 2 microbatches admitted
    with pytest.raises(T.QueueFullError):
        tier.submit(_imgs(1, 4))       # 2 more would exceed 3
    assert len(tier.queue) == 2        # nothing half-enqueued
    tier.submit(_imgs(2, 2))           # 1 microbatch still fits
    with pytest.raises(ValueError):
        tier.submit(_imgs(3, 2, size=16))


def test_deadline_and_timeout_shed_typed():
    now = [0.0]
    tier = _tier(n_replicas=1, clock=lambda: now[0], request_timeout_s=5.0)
    r_dl = tier.submit(_imgs(0, 2), deadline_s=1.0)
    r_to = tier.submit(_imgs(1, 2))
    now[0] = 6.0
    m = tier.run()
    assert m["failed"] == 2
    assert tier.workers[0].server.ticks == 0
    with pytest.raises(T.DeadlineExceededError):
        tier.results(r_dl)
    with pytest.raises(T.RequestTimeoutError):
        tier.results(r_to)
    assert sum(tier._pending.get(r, 0) for r in (r_dl, r_to)) == 0


def test_retry_exhaustion_and_no_healthy_replica():
    tier = _tier(n_replicas=1, injectors={0: _AlwaysFail()},
                 max_retries=1, max_respawns=1,
                 backoff_base_s=0.0, sleep=lambda s: None)
    rid = tier.submit(_imgs(0, 2))
    tier.run()
    with pytest.raises(T.ReplicaFailedError):
        tier.results(rid)
    rid2 = tier.submit(_imgs(1, 2))
    with pytest.raises(T.NoHealthyReplicaError):
        tier.run()
    assert rid2 in tier._pending       # work survives the outage


# --- drain-and-respawn: the bitwise bar -------------------------------------

@pytest.fixture(scope="module")
def ref_tier_():
    """One no-failure port tier reused for every reference stream."""
    return _tier()


def _sequential(tier, images):
    """The port's sequential forward of ``images``, microbatch by
    microbatch, on the tier's own weights."""
    cfg = get_config(tier.arch)
    return np.concatenate([cnn.cnn_forward(
        cfg, tier.params, torch.from_numpy(images[i:i + tier.mb_size]),
        device="cpu").numpy() for i in range(0, len(images), tier.mb_size)])


def test_kill_one_of_two_replicas_bitwise(ref_tier_):
    ref, m0 = _stream(ref_tier_)
    tier = _tier(injectors={1: FailureInjector(fail_at_steps=(2,))})
    got, m1 = _stream(tier)
    assert m1["respawns"] == 1
    assert m1["recovered_microbatches"] > 0
    assert m1["completed"] == m0["completed"] == 3
    assert m1["failed"] == 0
    for i, (a, b) in enumerate(zip(ref, got)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, _sequential(tier, _imgs(10 + i, 4)))


def test_killed_replica_respawns_and_serves_again(ref_tier_):
    tier = _tier(injectors={0: FailureInjector(fail_at_steps=(1,))},
                 backoff_base_s=0.0)
    bufs = [b.data_ptr() for b in tier.workers[0].server._bufs]
    _, m = _stream(tier, n_req=2)
    assert m["respawns"] == 1
    assert all(w.alive for w in tier.workers)
    # respawn zeroed the state in place: the same buffers, no new ones
    assert [b.data_ptr() for b in tier.workers[0].server._bufs] == bufs
    ref, _ = _stream(ref_tier_, n_req=2, seed0=50)
    got, _ = _stream(tier, n_req=2, seed0=50)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)


def test_tier_equals_the_ports_own_server(ref_tier_):
    """The tier's logits equal one CNNPipelineServer's on the same
    weights and plan, request by request, bitwise; all replicas share one
    plan and one copy of the weights."""
    got, m = _stream(ref_tier_, n_req=2, batch=5, seed0=70)
    srv = port_serve.CNNPipelineServer(
        ARCH, mb_size=2, n_stages=2, image_size=IMG, device="cpu",
        params=port_serve._init_native(get_config(ARCH), 0))
    assert srv.plan["stage_of"] == ref_tier_.plan["stage_of"]
    rids = [srv.submit(_imgs(70 + i, 5)) for i in range(2)]
    srv.run()
    for r, g in zip(rids, got):
        np.testing.assert_array_equal(srv.results(r), g)
    servers = [w.server for w in ref_tier_.workers]
    assert all(s.plan is ref_tier_.plan for s in servers)
    assert m["replica_ticks"] == [s.ticks for s in servers]


@pytest.mark.parametrize("before", [(False, False), (True, False),
                                    (False, True)])
def test_tier_leaves_the_processes_cudnn_setting(before):
    """The replicas are built under ``deterministic_convs`` (benchmark
    off, deterministic on), and the process's own setting, whatever it
    was, is back once the tier and each respawn are built: a serving
    object changes no global state."""
    from repro_torch.core.device import deterministic_convs
    flags = torch.backends.cudnn
    prev = (flags.benchmark, flags.deterministic)
    seen = []
    orig = port_serve.CNNPipelineServer.__init__

    def spy(self, *a, **kw):
        seen.append((flags.benchmark, flags.deterministic))
        orig(self, *a, **kw)
    try:
        flags.benchmark, flags.deterministic = before
        with deterministic_convs():
            assert (flags.benchmark, flags.deterministic) == (False, True)
        assert (flags.benchmark, flags.deterministic) == before
        port_serve.CNNPipelineServer.__init__ = spy
        tier = _tier(injectors={0: FailureInjector(fail_at_steps=(1,))},
                     backoff_base_s=0.0)
        assert (flags.benchmark, flags.deterministic) == before
        _, m = _stream(tier, n_req=1)
        assert m["respawns"] == 1
        assert (flags.benchmark, flags.deterministic) == before
        assert seen == [(False, True)] * 2
    finally:
        port_serve.CNNPipelineServer.__init__ = orig
        flags.benchmark, flags.deterministic = prev


def test_replan_reuses_feasible_cut():
    cfg = get_config(ARCH)
    params = port_serve._init_native(cfg, 0)
    prev = planner.plan(cfg, params, planner.PlanRequest(n_stages=4))
    out = planner.plan(cfg, params,
                       planner.PlanRequest(n_devices=4, prev=prev))
    assert out["reused"] and out["plan"] is prev
    assert (out["n_stages"], out["n_replicas"]) == (4, 1)
    out3 = planner.plan(cfg, params,
                        planner.PlanRequest(n_devices=3, prev=prev))
    assert not out3["reused"]
    assert out3["n_stages"] * out3["n_replicas"] <= 3


def test_placement_raises_naming_its_roadmap_item(ref_tier_):
    for kw in ({"placed": True}, {"devices": ["cpu"]}):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP Queue 1 item 9, second half"):
            _tier(**kw)
    with pytest.raises(NotImplementedError,
                       match="ROADMAP Queue 1 item 9, second half"):
        ref_tier_.lose_devices(["cpu"])
    with pytest.raises(ValueError):
        _tier(heartbeat_timeout_s=0.0)


# --- the server's tier hooks ------------------------------------------------

def test_server_hooks_enqueue_purge_recover_respawn():
    srv = port_serve.CNNPipelineServer(
        ARCH, mb_size=2, n_stages=2, image_size=IMG, device="cpu",
        params=port_serve._init_native(get_config(ARCH), 0))
    with pytest.raises(ValueError, match="on_result"):
        srv.enqueue((0, 0), _imgs(0, 2))
    got = {}
    srv.on_result = lambda key, logits: got.setdefault(key, logits)
    with pytest.raises(ValueError, match="one microbatch"):
        srv.enqueue((0, 0), _imgs(0, 3))
    srv.enqueue((0, 0), _imgs(1, 1))                 # padded here
    srv.enqueue((0, 1), _imgs(2, 2), n_valid=1)
    srv.enqueue((1, 0), _imgs(3, 2))
    internal = srv.submit(_imgs(4, 2))
    assert srv.purge(lambda k: k[0] == 1) == 1       # external only
    srv._tick_once()                                 # one slot in flight
    assert srv.busy
    lost = srv.recover_work()
    assert [k for k, _, _ in lost] == [(0, 0), (0, 1)]
    assert [n for _, n, _ in lost] == [1, 1]
    assert all(c.shape == (2, IMG, IMG, 3) for _, _, c in lost)
    assert len(srv._queue) == 1                      # submit()'s requeued
    bufs = [b.data_ptr() for b in srv._bufs]
    srv.respawn()
    assert [b.data_ptr() for b in srv._bufs] == bufs
    assert all(float(b.abs().sum()) == 0.0 for b in srv._bufs)
    for key, n_valid, chunk in lost:
        srv.enqueue(key, chunk, n_valid=n_valid)
    srv.run()
    cfg = get_config(ARCH)
    params = port_serve._init_native(cfg, 0)
    for key, chunk in (((0, 0), _imgs(1, 1)), ((0, 1), _imgs(2, 2))):
        pad = np.zeros((2 - len(chunk), IMG, IMG, 3), np.float32)
        want = cnn.cnn_forward(cfg, params, torch.from_numpy(
            np.concatenate([chunk, pad])), device="cpu").numpy()
        assert got[key].shape == (1, 1000)
        np.testing.assert_array_equal(got[key], want[:1])
    assert srv.results(internal).shape == (2, 1000)


def test_serve_tier_with_a_failure_equals_no_failure():
    """``serve(ServeConfig(tier=True, fail_replica, fail_at_tick))``: the
    injected failure respawns the replica and every request's logits
    equal the no-failure run's and the sequential forward's, bitwise."""
    kw = dict(arch=ARCH, tier=True, replicas=2, n_stages=2, mb_size=2,
              image_size=IMG, batch=3, n_requests=3, device="cpu",
              verbose=False)
    base = port_serve.serve(port_serve.ServeConfig(**kw))
    hit = port_serve.serve(port_serve.ServeConfig(
        **kw, fail_replica=0, fail_at_tick=1))
    assert (base["respawns"], hit["respawns"]) == (0, 1)
    assert hit["completed"] == 3 and hit["failed"] == 0
    cfg = get_config(ARCH)
    params = port_serve._init_native(cfg, 0)
    for x, a, b in zip(base["request_images"], base["logits"],
                       hit["logits"]):
        np.testing.assert_array_equal(a, b)
        seq = np.concatenate([cnn.cnn_forward(
            cfg, params, torch.from_numpy(
                np.concatenate([x[i:i + 2], np.zeros(
                    (2 - len(x[i:i + 2]), IMG, IMG, 3), np.float32)])),
            device="cpu").numpy()[:len(x[i:i + 2])]
            for i in range(0, len(x), 2)])
        np.testing.assert_array_equal(b, seq)


# --- against the reference's tier -------------------------------------------

def _numpy_tree(params):
    tree = {}
    for name, p in params.items():
        w = p["w"]
        if isinstance(w, RefSparseWeight):
            w = {"vals": np.asarray(w.vals), "idx": np.asarray(w.idx),
                 "d_in": w.d_in}
        else:
            w = np.asarray(w)
        tree[name] = {"w": w, "b": np.asarray(p["b"])}
    return tree


@functools.lru_cache(maxsize=None)
def _ref_weights(arch):
    ref = jax.jit(lambda k: ref_cnn.init_cnn(ref_get_config(arch), k))(
        jax.random.PRNGKey(0))
    return cnn.params_from_numpy(_numpy_tree(ref), device="cpu")


def test_tier_within_the_parity_bar_of_the_reference_tier():
    """ResNet-50 at 32 px on the reference's weights: the port tier (two
    replicas, one failed mid-stream) against the reference's no-failure
    ``ServingTier`` on the same images: within 1e-3 of max |logit|, top-1
    equal, and the metric keys equal."""
    arch = "resnet50"
    reqs = [_imgs(90 + i, 3) for i in range(2)]
    with ref_ops.config(impl="xla"):
        rt = ref_tier.ServingTier(arch, n_replicas=1, n_stages=2,
                                  mb_size=2, image_size=IMG, placed=False)
        rids = [rt.submit(x) for x in reqs]
        want_m = rt.run()
        want = [rt.results(r) for r in rids]
    tier = T.ServingTier(arch, n_replicas=2, n_stages=2, mb_size=2,
                         image_size=IMG, device="cpu",
                         params=_ref_weights(arch),
                         injectors={1: FailureInjector(fail_at_steps=(1,))})
    rids = [tier.submit(x) for x in reqs]
    got_m = tier.run()
    got = [tier.results(r) for r in rids]
    assert sorted(got_m) == sorted(want_m)
    assert got_m["respawns"] == 1 and got_m["failed"] == 0
    assert tier.plan["stage_of"] == rt.plan["stage_of"]
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape == (3, 1000) and np.isfinite(g).all()
        assert np.abs(g - w).max() <= LOGIT_RTOL * np.abs(w).max()
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))


def test_workers_entry_points_default_to_the_card():
    """Without a card the tiers refuse ``device="cuda"`` (the default)
    before anything is built or spawned."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.ServingTier(ARCH, image_size=IMG)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.ProcessServingTier(ARCH, image_size=IMG)
