"""The port's slice as a whole vs the JAX reference: sparse ResNet-50 at
full width and 32 px, on the reference's own weights carried across with
``params_from_numpy``; the port's serving path; and the entry points'
refusal to run anywhere but the card unless asked; ``ServeConfig``
refusing what the reference's refuses."""
import functools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.launch.serve import ServeConfig as RefServeConfig  # noqa: E402
from repro.models import cnn as ref_cnn  # noqa: E402
from repro.models.layers import SparseWeight as RefSparseWeight  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import ServeConfig, serve  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.models.layers import SparseWeight  # noqa: E402

IMAGE = 32
# Bar on the logits: max |diff| <= 1e-3 * max |ref logit|, and equal top-1.
# The reference agrees with itself (XLA vs Pallas interpret) to ~1.6e-7 of
# max |logit|, so both frameworks do the same f32 sums and bf16 rounds;
# what is left is f32 summation order, which can flip a bf16 rounding that
# later layers carry on. The bar is relative because random-init logits
# are ~1e-3 in scale (uniform init, zero biases, no batch norm).
LOGIT_RTOL = 1e-3


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


@pytest.fixture(scope="module")
def weights():
    """(reference cfg, reference params, numpy tree, port params)."""
    ref_cfg = ref_get_config("resnet50")
    # jit gives the eager init's weights bit for bit, in a fraction of
    # its time
    ref_params = jax.jit(lambda k: ref_cnn.init_cnn(ref_cfg, k))(
        jax.random.PRNGKey(0))
    tree = _numpy_tree(ref_params)
    return ref_cfg, ref_params, tree, cnn.params_from_numpy(tree,
                                                            device="cpu")


def _images(n, seed):
    return np.random.default_rng(seed).normal(
        size=(n, IMAGE, IMAGE, 3)).astype(np.float32)


def _assert_logits_close(got, ref):
    got = got.numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= LOGIT_RTOL * scale, \
        (np.abs(got - ref).max(), scale)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


def test_params_from_numpy_keeps_every_bit(weights):
    _, _, tree, params = weights
    assert params.keys() == tree.keys()
    n_sparse = 0
    for name, p in params.items():
        w, want = p["w"], tree[name]["w"]
        if isinstance(want, dict):
            assert isinstance(w, SparseWeight) and w.d_in == want["d_in"]
            assert w.idx.dtype == torch.int32
            np.testing.assert_array_equal(w.idx.numpy(), want["idx"])
            leaves = [(w.vals, want["vals"])]
            n_sparse += 1
        else:
            leaves = [(w, want)]
        for t, a in leaves + [(p["b"], tree[name]["b"])]:
            assert t.dtype == torch.bfloat16 and a.dtype.name == "bfloat16"
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          a.view(np.int16))
    # 47 sparse convs + the pruned classifier
    assert n_sparse == 48
    assert tuple(params["fc"]["w"].vals.shape) == (40, 10, 32, 25)


@pytest.mark.parametrize("batch", [1, 2])
def test_forward_matches_reference_xla(weights, batch):
    ref_cfg, ref_params, _, params = weights
    x = _images(batch, seed=batch)
    with ref_ops.config(impl="xla"):
        ref = jax.jit(lambda p, im: ref_cnn.cnn_forward(ref_cfg, p, im))(
            ref_params, x)
    got = cnn.cnn_forward(get_config("resnet50"), params, x, device="cpu")
    _assert_logits_close(got, ref)


def test_forward_matches_reference_pallas(weights):
    ref_cfg, ref_params, _, params = weights
    x = _images(1, seed=11)
    with ref_ops.config(impl="pallas"):
        ref = ref_cnn.cnn_forward(ref_cfg, ref_params, x)
    got = cnn.cnn_forward(get_config("resnet50"), params, x, device="cpu")
    _assert_logits_close(got, ref)


def test_unfused_graph_matches_reference(weights):
    """The unfused view runs the standalone node kinds the fused graph
    folds into epilogues: maxpool, add (reading its residual edge),
    avgpool and fc."""
    from repro.core.graph import graph_for as ref_graph_for
    from repro_torch.core.graph import graph_for
    ref_cfg, ref_params, _, params = weights
    g = graph_for("resnet50")
    kinds = [n.kind for n in g.nodes]
    assert (kinds.count("maxpool"), kinds.count("add"), kinds.count("avgpool"),
            kinds.count("fc")) == (1, 16, 1, 1)
    x = _images(1, seed=5)
    with ref_ops.config(impl="xla"):
        ref = jax.jit(lambda p, im: ref_cnn.cnn_forward(
            ref_cfg, p, im, graph=ref_graph_for("resnet50")))(ref_params, x)
    got = cnn.cnn_forward(get_config("resnet50"), params, x, graph=g,
                          device="cpu")
    _assert_logits_close(got, ref)


def test_init_cnn_prunes_like_reference():
    """Same pruning decisions as the reference's init: 47 sparse convs
    with the same block shapes, 6 dense convs, the classifier as
    (40, 10, 32, 25); one seed gives one set of weights."""
    cfg = get_config("resnet50")
    a = cnn.init_cnn(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = cnn.init_cnn(cfg, torch.Generator().manual_seed(3), device="cpu")
    ref = jax.eval_shape(
        lambda k: ref_cnn.init_cnn(ref_get_config("resnet50"), k),
        jax.random.PRNGKey(0))
    assert a.keys() == ref.keys()
    for name, p in a.items():
        w, rw = p["w"], ref[name]["w"]
        assert isinstance(w, SparseWeight) == isinstance(rw, RefSparseWeight)
        if isinstance(w, SparseWeight):
            assert tuple(w.vals.shape) == tuple(rw.vals.shape)
            assert torch.equal(w.vals, b[name]["w"].vals)
        else:
            assert tuple(w.shape) == tuple(rw.shape)
    dense = sorted(n for n, p in a.items()
                   if not isinstance(p["w"], SparseWeight))
    assert dense == ["conv1", "s0b0_c1", "s0b0_c3", "s0b0_proj", "s0b1_c3",
                     "s0b2_c3"]


def test_serve_latency_matches_forward():
    out = serve(ServeConfig(arch="resnet50", mode="latency", device="cpu",
                            image_size=IMAGE, n_requests=2, verbose=False))
    assert out["logits"].shape == (2, 1000)
    assert out["request_images"].shape == (2, IMAGE, IMAGE, 3)
    assert 0 < out["latency_p50_s"] <= out["latency_p99_s"]
    cfg = get_config("resnet50")
    params = cnn.init_cnn(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    for i in range(2):
        want = cnn.cnn_forward(
            cfg, params, torch.from_numpy(out["request_images"][i:i + 1]),
            device="cpu")
        assert torch.equal(torch.from_numpy(out["logits"][i:i + 1]), want)


@pytest.mark.parametrize("entry", ["serve", "cnn_forward", "init_cnn",
                                   "params_from_numpy"])
def test_entry_points_default_to_the_card(entry):
    """Without a card the default device raises; nothing carries on on
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = get_config("resnet50")
    calls = {
        "serve": lambda: serve(ServeConfig(arch="resnet50", mode="latency")),
        "cnn_forward": lambda: cnn.cnn_forward(cfg, {}, np.zeros(
            (1, IMAGE, IMAGE, 3), np.float32)),
        "init_cnn": lambda: cnn.init_cnn(cfg, torch.Generator()),
        "params_from_numpy": lambda: cnn.params_from_numpy({}),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


@functools.lru_cache(maxsize=None)
def _ref_forward_jit(ref_cfg):
    return jax.jit(lambda p, im: ref_cnn.cnn_forward(ref_cfg, p, im))


@pytest.mark.parametrize("kw", [
    {"mode": "throughput", "auto_split": True},
    {"mode": "throughput", "continuous": True, "tuning_cache": "c.json"},
    {"mode": "throughput", "tier": True},
    {"mode": "latency", "n_stages": 2, "calibrate": True},
    {"arch": "rwkv6-1.6b", "mode": "latency"},
], ids=["throughput", "continuous", "tier", "stages", "lm"])
def test_unported_modes_name_their_roadmap_item(kw, weights, monkeypatch,
                                                tmp_path):
    """The co-planner's split, the tuning cache and calibration now run in
    the throughput, continuous and latency modes, serving the reference's
    weights: each plan equals the reference planner's under the same
    request (the calibrated one read from the port's own measurements,
    whose keys the reference reads too), and the logits the reference's
    forward within the parity bar, top-1 equal. The tier serves since it
    was ported: one request of the reference's weights, its logits the
    reference forward's within the bar. Every LM family is ported now (an
    SSM arch raised here, naming its ROADMAP item, before): ``serve``
    takes reduced rwkv6 to ``serve_lm`` on the CPU, on the reference's
    weights and prompts, and its greedy tokens are the reference
    ``serve_lm``'s up to where the two part, which is only at a near tie
    of the reference's own logits (top-2 gap within 3e-2 of max |logit|,
    the serve bar), teacher-forced on the port's tokens."""
    ref_cfg, ref_params, _, params = weights
    kw = {"arch": "resnet50", "device": "cpu", "image_size": IMAGE,
          "batch": 2, "n_microbatches": 2, "n_requests": 1, "mb_size": 2,
          "verbose": False, **kw}
    if kw["arch"] != "resnet50":
        _check_lm_serving(kw, monkeypatch)
        return
    from repro.core import planner as ref_planner
    from repro.core import tuning as ref_tuning
    from repro_torch.core import tuning
    from repro_torch.launch import serve as port_serve
    monkeypatch.chdir(tmp_path)                # c.json: a missing file
    monkeypatch.setattr(port_serve, "_init_native", lambda cfg, seed: params)
    if kw.get("tier"):
        out = serve(ServeConfig(**kw))
        assert (out["completed"], out["failed"], out["respawns"]) == (1, 0, 0)
        ref = _ref_forward_jit(ref_cfg)(ref_params,
                                        out["request_images"][0][:1])
        _assert_logits_close(torch.from_numpy(out["logits"][0][:1]), ref)
        return
    tuning.set_tuning_cache(None)
    try:
        out = serve(ServeConfig(**kw))
        cache = tuning.current_tuning_cache()
    finally:
        tuning.set_tuning_cache(None)
    if kw.get("auto_split"):
        want = ref_planner.plan(ref_cfg, ref_params, ref_planner.PlanRequest(
            n_devices=1, n_microbatches=2))
        assert (out["n_stages"], out["n_replicas"]) == (
            want["n_stages"], want["n_replicas"]) == (1, 1)
        want = want["plan"]
    else:
        # the port's measured times under the reference's device string
        sig = ref_tuning.device_signature()
        ref_cache = ref_tuning.TuningCache(
            {k.replace("/cpu:plain", f"/{sig}"): v
             for k, v in cache.entries.items()}, dict(cache.meta))
        calibrated = kw.get("calibrate", False)
        assert len(cache) > 0 if calibrated else len(cache) == 0
        from repro_torch.core import planner
        with warnings.catch_warnings(), tuning.device_scope("cpu"):
            warnings.simplefilter("ignore")
            req = dict(n_stages=kw.get("n_stages", 4), model="measured")
            want = ref_planner.plan(ref_cfg, ref_params,
                                    ref_planner.PlanRequest(
                                        **req, tuning_cache=ref_cache))
            got = planner.plan(get_config("resnet50"), params,
                               planner.PlanRequest(**req,
                                                   tuning_cache=cache))
        assert got["stage_of"] == want["stage_of"]
        np.testing.assert_array_equal(got["stage_cost"], want["stage_cost"])
        assert got["measured_coverage"]["coverage"] == (
            1.0 if calibrated else 0.0)
        if "stage_of" in out:
            assert out["stage_of"] == got["stage_of"]
    assert out["n_stages"] == want["n_stages"]
    logits = out["logits"][0] if kw.get("continuous") else out["logits"]
    images = out["request_images"][0] if kw.get("continuous") else \
        out.get("images", out.get("request_images"))
    ref = _ref_forward_jit(ref_cfg)(ref_params, images[:1])
    _assert_logits_close(torch.from_numpy(np.asarray(logits[:1])), ref)


def _check_lm_serving(kw, monkeypatch):
    import _torch_lm_ref as R
    from repro.launch import serve as ref_serve
    from repro.models import lm as ref_lm
    from repro_torch.launch import serve as port_serve
    rcfg, _, rparams, lm_params = R.model(kw["arch"])
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (2, 32),
                                            0, rcfg.vocab_size))
    real = port_serve.serve_lm
    monkeypatch.setattr(port_serve, "serve_lm", lambda *a, **k: real(
        *a, params=lm_params, prompts=prompts, **k))
    out = serve(ServeConfig(**kw))
    ref = ref_serve.serve_lm(kw["arch"], batch=2, seed=0, verbose=False)
    assert out["tokens"].shape == ref["tokens"].shape == (2, 16)
    seq = np.concatenate([prompts, out["tokens"]], 1)
    step, cache = R.ref_decode(rcfg), ref_lm.init_cache(rcfg, 2, 128)
    parted = [False, False]
    for i in range(seq.shape[1] - 1):
        lg, cache = step(rparams, cache, jax.numpy.asarray(seq[:, i:i + 1]),
                         jax.numpy.int32(i))
        if i < 31:
            continue
        lg = np.asarray(lg[:, 0], np.float32)
        top2 = np.sort(lg, -1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > R.SERVE_RTOL * np.abs(lg).max()
        for r in range(2):
            if clear[r]:
                assert lg[r].argmax() == seq[r, i + 1], (r, i)
            if not parted[r] and out["tokens"][r, i - 31] != \
                    ref["tokens"][r, i - 31]:
                assert not clear[r], (r, i)
                parted[r] = True
    np.testing.assert_array_equal(out["prompts"], prompts)


# keyword sets that both ServeConfigs take (the port's extra ``device``
# aside): each is refused by both or accepted by both
_SERVE_CONFIG_KW = [
    {}, {"mode": "latency"}, {"mode": "bogus"},
    {"quantize": "bogus"}, {"quantize": "int8"}, {"quantize": "bf16"},
    {"quantize": "f32"}, {"mode": "latency", "quantize": "bogus"},
    {"procs": 1, "hosts": 1}, {"procs": 2}, {"hosts": 2},
    {"mode": "latency", "procs": 1}, {"mode": "latency", "hosts": 1},
    {"mode": "latency", "continuous": True}, {"mode": "latency", "tier": True},
    {"continuous": True, "tier": True}, {"image_size": 224},
    {"replicas": 2}, {"n_microbatches": 8}, {"mb_size": 4}, {"iters": 1},
    {"placed": True}, {"placed": False}, {"param_budget_frac": 0.25},
    {"auto_split": True}, {"tuning_cache": "cache.json"},
    {"calibrate": True}, {"n_stages": 8}, {"mode": "latency",
                                           "n_stages": 2},
    {"continuous": True, "replicas": 2, "mb_size": 1},
    {"listen": "x:1"}, {"listen": "127.0.0.1:0", "hosts": 2},
    {"listen": "127.0.0.1:0", "procs": 2}, {"listen": "h:1", "tier": True},
    {"tier": True, "replicas": 2, "fail_replica": 0, "fail_at_tick": 3},
    {"procs": 2, "kill_worker": 0, "kill_at_tick": 2},
    {"hosts": 2, "kill_worker": 1}, {"procs": 2, "ledger_dir": "ledger"},
    {"procs": 2, "heartbeat_interval_s": 0.0},
    {"procs": 2, "suspect_after_s": 5.0, "dead_after_s": 5.0},
    {"mode": "latency", "fail_replica": 0},
]


@pytest.mark.parametrize("kw", _SERVE_CONFIG_KW, ids=str)
def test_serve_config_refuses_what_the_reference_refuses(kw):
    """The port's ServeConfig and the reference's, side by side on the
    same keywords: both raise ValueError or neither does, and the
    accepted ones agree on every shared field's value."""
    def build(cls):
        try:
            return cls(arch="resnet50", **kw)
        except ValueError:
            return None
    ref, port = build(RefServeConfig), build(ServeConfig)
    assert (ref is None) == (port is None), (ref, port)
    if port is not None:
        for field in ("mode", "quantize", "procs", "hosts", "image_size",
                      "seed", "n_requests", "batch", "continuous", "tier",
                      "replicas", "n_microbatches", "mb_size", "n_stages",
                      "iters", "placed", "param_budget_frac", "auto_split",
                      "tuning_cache", "calibrate", "listen", "fail_replica",
                      "fail_at_tick", "kill_worker", "kill_at_tick",
                      "heartbeat_interval_s", "suspect_after_s",
                      "dead_after_s", "ledger_dir"):
            assert getattr(port, field) == getattr(ref, field), field


def test_serve_config_defaults_and_refusals():
    assert ServeConfig(arch="resnet50").image_size == 64
    assert ServeConfig(arch="resnet50").n_stages == 4
    with pytest.raises(ValueError, match="quantize"):
        ServeConfig(arch="resnet50", quantize="bogus")
    with pytest.raises(ValueError, match="exclusive"):
        ServeConfig(arch="resnet50", procs=1, hosts=1)
    with pytest.raises(ValueError, match="listen"):
        ServeConfig(arch="resnet50", listen="127.0.0.1:0")
