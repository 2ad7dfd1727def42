"""The port's placed serving tier on CPU device slots: the placed cases of
the reference's ``tests/test_serving_tier.py`` (MobileNet-V1 at 32 px,
S 4, mb 2, eight slots), held port against port (the reference's V1
logits part from the port's by its own rounding, ROADMAP Queue 3 item 2).

- a placed 2 x 4 tier (each replica its own slots and its own placed
  buffer) equals the unplaced tier bit for bit, with and without one
  replica killed mid-stream;
- the 8 -> 4 loss: ``lose_devices(slots[2:6])`` mid-stream retires both
  replicas, re-plans with ``prev=`` (the cut reused), respawns one
  replica on slots {0, 1, 6, 7} with the buffer re-placed by
  ``fault.remesh`` (a fresh copy), and the stream finishes bit for bit;
- three survivors: the cut is not reused, everything is rebuilt, and
  the stream finishes bit for bit;
- the batched executor and the continuous server on a stage mesh of
  slots (``devices=``) equal their closures; a buffer placed elsewhere
  is refused;
- against the reference: a placed ResNet-50 server on the reference's
  weights within 1e-3 of max |logit| of the reference's single-device
  ``cnn_forward``, top-1 equal.

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
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.runtime import tier as T  # noqa: E402
from repro_torch.runtime.fault import FailureInjector  # noqa: E402

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


@functools.lru_cache(maxsize=None)
def _params(arch=ARCH):
    return port_serve._init_native(get_config(arch), 0)


def _tier(**kw):
    return T.ServingTier(ARCH, n_replicas=2, n_stages=4, mb_size=2,
                         image_size=IMG, device="cpu", params=_params(),
                         **kw)


def _stream(tier, n_req=4, seed0=20, rounds=None):
    rids = [tier.submit(_imgs(seed0 + i, 4)) for i in range(n_req)]
    m = tier.run(max_rounds=rounds)
    return rids, m


@pytest.fixture(scope="module")
def slots():
    return M.device_slots(8, "cpu")


@pytest.fixture(scope="module")
def unplaced():
    """The no-failure stream through the unplaced tier (shared rows)."""
    tier = _tier()
    assert not tier.placed
    rids, m = _stream(tier)
    assert m["failed"] == 0
    return [tier.results(r) for r in rids]


def _same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_placed_tier_equals_unplaced_bitwise(slots, unplaced):
    tier = _tier(devices=slots)
    assert tier.placed
    assert [[d.id for d in w.devices] for w in tier.workers] == \
        [[0, 1, 2, 3], [4, 5, 6, 7]]
    for w in tier.workers:
        srv = w.server
        assert srv.mesh.shape == {"stage": 4}
        assert srv.param_buffer.shape == (4, srv.pparams.buffer_width)
        for k in range(4):
            assert srv.mesh.slot({"stage": k}) is w.devices[k]
            assert torch.equal(srv.param_rows[k],
                               srv.param_buffer.shard({"stage": k})[0])
    rids, m = _stream(tier)
    assert m["failed"] == 0 and m["replicas_alive"] == 2
    _same([tier.results(r) for r in rids], unplaced)


def test_placed_tier_kill_replica_bitwise(slots, unplaced):
    tier = _tier(devices=slots,
                 injectors={1: FailureInjector(fail_at_steps=(1,))})
    rids, m = _stream(tier)
    assert m["respawns"] == 1 and m["failed"] == 0
    _same([tier.results(r) for r in rids], unplaced)


def test_placed_tier_device_loss_degrades_and_finishes(slots, unplaced):
    """The 8 -> 4 bar: a placed 2 x 4 tier loses 4 slots mid-stream
    (killing BOTH replicas), re-plans with prev= (the cut reused),
    respawns one replica on the surviving slots with a re-placed buffer
    and finishes the stream bit for bit."""
    tier = _tier(devices=slots)
    donor = tier.workers[0].server.param_buffer
    rids, _ = _stream(tier, rounds=2)            # mid-flight
    replan = tier.lose_devices(slots[2:6])
    assert replan["reused"] and replan["n_replicas"] == 1
    assert tier.remeshes == 1
    m = tier.run()
    assert m["failed"] == 0 and m["replicas_alive"] == 1
    new = tier.workers[-1]
    assert {d.id for d in new.devices} == {0, 1, 6, 7}
    buf = new.server.param_buffer
    assert torch.equal(buf.gather(), donor.gather())
    donor_ptrs = {t.untyped_storage().data_ptr() for t in donor.shards()}
    assert not donor_ptrs & {t.untyped_storage().data_ptr()
                             for t in buf.shards()}
    _same([tier.results(r) for r in rids], unplaced)


def test_placed_tier_three_survivors_rebuild(slots, unplaced):
    tier = _tier(devices=slots)
    rids, _ = _stream(tier, rounds=2)
    replan = tier.lose_devices(slots[3:])
    assert not replan["reused"] and tier.remeshes == 0
    m = tier.run()
    assert m["failed"] == 0
    assert m["replicas_alive"] == replan["n_replicas"] >= 1
    assert tier.plan["n_stages"] * replan["n_replicas"] <= 3
    _same([tier.results(r) for r in rids], unplaced)


def test_executors_on_slots_equal_closures(slots):
    kw = dict(batch=8, n_microbatches=2, n_stages=4, image_size=IMG,
              iters=1, verbose=False, device="cpu", params=_params())
    placed = port_serve._serve_cnn(ARCH, n_replicas=2, placed=True,
                                   devices=slots, **kw)
    closures = port_serve._serve_cnn(ARCH, n_replicas=2, placed=False, **kw)
    assert placed["placed"] and not closures["placed"]
    np.testing.assert_array_equal(placed["logits"], closures["logits"])
    reqs = [_imgs(40, 3), _imgs(41, 5)]
    out = {}
    for name, extra in (("placed", dict(devices=slots[4:], placed=True)),
                        ("closures", dict(closures=True))):
        srv = port_serve.CNNPipelineServer(
            ARCH, mb_size=2, n_stages=4, image_size=IMG, device="cpu",
            params=_params(), **extra)
        ids = [srv.submit(x) for x in reqs]
        srv.run()
        out[name] = [srv.results(i) for i in ids]
    _same(out["placed"], out["closures"])
    srv = port_serve.CNNPipelineServer(
        ARCH, mb_size=2, n_stages=4, image_size=IMG, device="cpu",
        params=_params(), devices=slots[:4])
    with pytest.raises(ValueError, match="param_buffer"):
        port_serve.CNNPipelineServer(
            ARCH, mb_size=2, n_stages=4, image_size=IMG, device="cpu",
            params=_params(), devices=slots[4:], cfg=srv.cfg, plan=srv.plan,
            param_buffer=srv.param_buffer)
    with pytest.raises(ValueError, match="placed=True needs >= 4"):
        port_serve.CNNPipelineServer(
            ARCH, mb_size=2, n_stages=4, image_size=IMG, device="cpu",
            params=_params(), devices=slots[:3], placed=True)


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


def test_placed_resnet50_within_the_bar_of_the_reference(slots):
    arch = "resnet50"
    rcfg = ref_get_config(arch)
    rparams = jax.jit(lambda k: ref_cnn.init_cnn(rcfg, k))(
        jax.random.PRNGKey(0))
    images = _imgs(90, 4)
    with ref_ops.config(impl="xla"):
        want = np.asarray(jax.jit(lambda p, x: ref_cnn.cnn_forward(
            rcfg, p, x))(rparams, images), np.float32)
    srv = port_serve.CNNPipelineServer(
        arch, mb_size=2, n_stages=4, image_size=IMG, device="cpu",
        params=cnn.params_from_numpy(_numpy_tree(rparams), device="cpu"),
        devices=slots[:4], placed=True)
    assert srv.placed and srv.mesh.shape == {"stage": 4}
    rid = srv.submit(images)
    srv.run()
    got = srv.results(rid)
    assert got.shape == want.shape == (4, 1000) and np.isfinite(got).all()
    assert np.abs(got - want).max() <= LOGIT_RTOL * np.abs(want).max()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
