"""The port's heterogeneous layer pipeline (``core/pipeline.py``,
``cnn.stage_programs``) and its throughput serving (``launch/serve.py``:
``_serve_cnn``, ``CNNPipelineServer``, ``_serve_cnn_continuous``) on the
CPU: pipelined == sequential bitwise for all three CNNs (and dense
ResNet-50), native and int8, at the reference's test size (32 px, batch
4, S = 3, M = 2); R = 2 == R = 1 bitwise; the tick primitive's roll
semantics and the batch executor against the reference's; continuous
back-to-back == isolated requests bitwise; ``serve()`` and ``main()``
in both throughput modes. The serving runs against the reference's own
are in tests/test_torch_pipeline_serve.py."""
import dataclasses
import functools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import pipeline as ref_pp  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import pipeline as pp  # noqa: E402
from repro_torch.core import planner  # noqa: E402
from repro_torch.core.quant import quantize_tree  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.launch.mesh import Mesh, device_slots  # noqa: E402
from repro_torch.launch.serve import (CNNPipelineServer, ServeConfig,  # noqa: E402
                                      serve)
from repro_torch.models import cnn  # noqa: E402

ARCHS = ["resnet50", "mobilenet_v1", "mobilenet_v2"]
IMAGE = 32


def _cfg(arch, sparse):
    cfg = get_config(arch)
    return dataclasses.replace(
        cfg, sparsity=dataclasses.replace(cfg.sparsity, enabled=sparse))


@functools.lru_cache(maxsize=None)
def _port_params(arch, sparse):
    return cnn.init_cnn(_cfg(arch, sparse), torch.Generator().manual_seed(0),
                        device="cpu")


def _images(n, seed):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(n, IMAGE, IMAGE, 3)).astype(np.float32))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs files side by side in worker
    processes, and a full torch thread pool in each oversubscribes the
    cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- pipelined == sequential ---------------------------------------------------

@pytest.mark.parametrize("quantize", ["native", "int8"])
@pytest.mark.parametrize("arch,sparse", [("resnet50", True),
                                         ("resnet50", False),
                                         ("mobilenet_v1", False),
                                         ("mobilenet_v2", False)],
                         ids=["resnet50", "resnet50-dense", "mobilenet_v1",
                              "mobilenet_v2"])
def test_pipelined_equals_sequential_bitwise(arch, sparse, quantize):
    """Four microbatch-wires through the three-stage pipeline give the
    logits of ``cnn_forward`` on the whole batch bit for bit (the
    reference's tests/test_cnn_pipeline.py contract); the stage chain
    composed back to back (latency mode's semantics) too."""
    cfg = _cfg(arch, sparse)
    params = _port_params(arch, sparse)
    plan = planner.plan(cfg, params, planner.PlanRequest(
        n_stages=3, store_dtype=quantize))
    s = plan["n_stages"]
    assert s == 3
    imgs = _images(4, seed=1)
    x_mb = pp.microbatch(imgs, 2)
    stage_fns, pack_in, unpack_out, width = cnn.stage_programs(
        cfg, params, plan["stage_of"], tuple(x_mb.shape[1:]),
        quantize=quantize)
    x_wire = torch.stack([pack_in(x_mb[i]) for i in range(2)])
    assert x_wire.shape == (2, 2, width)
    ref = cnn.cnn_forward(cfg, quantize_tree(params, quantize), imgs,
                          device="cpu")
    out_w = pp.pipeline_apply_gspmd_hetero(stage_fns, x_wire, n_stages=s)
    logits = pp.concat_hetero_outputs(out_w, unpack_out, 2)
    assert logits.dtype == torch.float32
    assert torch.equal(logits, ref)
    wire = x_wire[1]
    for fn in stage_fns:
        wire = fn(wire)
    assert torch.equal(unpack_out(wire), ref[2:])


@pytest.mark.parametrize("arch", ARCHS)
def test_replicated_equals_single_replica_bitwise(arch):
    """R = 2 pipelines side by side (replica r owns batch slice r) give
    the 1-replica logits bit for bit at the same microbatch size."""
    kw = dict(batch=8, n_stages=3, image_size=IMAGE, iters=1, verbose=False,
              device="cpu", images=_images(8, seed=2))
    one = port_serve._serve_cnn(arch, n_microbatches=4, **kw)
    two = port_serve._serve_cnn(arch, n_microbatches=2, n_replicas=2, **kw)
    assert two["n_replicas"] == 2 and two["stage_runs"] == 2 * 2 * 3
    np.testing.assert_array_equal(two["logits"], one["logits"])
    want = cnn.cnn_forward(get_config(arch), port_serve._init_native(
        get_config(arch), 0), _images(8, seed=2), device="cpu")
    np.testing.assert_array_equal(one["logits"], want.numpy())


# -- the tick primitive --------------------------------------------------------

def _toy_stages(n, lib):
    """Stage k adds k + 1 and scales by 2 (distinct, order-sensitive)."""
    if lib == "jax":
        return [lambda w, k=k: (w + (k + 1)) * 2.0 for k in range(n)]

    def make(k):
        def stage(w, out=None):
            y = (w + (k + 1)) * 2.0
            return y if out is None else out.copy_(y)
        return stage
    return [make(k) for k in range(n)]


@pytest.mark.parametrize("n_replicas", [1, 2])
def test_step_rolls_as_the_reference(n_replicas):
    """pipeline_step_hetero ticked six times, injecting three wires then
    zero wires: every state and emitted wire equal the reference's tick
    (in place, with the roll done by where stage k writes)."""
    s, mb, w = 3, 2, 5
    rep = n_replicas > 1
    lead = (s, n_replicas) if rep else (s,)
    rng = np.random.default_rng(0)
    injects = [rng.normal(size=((n_replicas,) if rep else ()) + (mb, w))
               .astype(np.float32) for _ in range(3)]
    state = torch.zeros(lead + (mb, w))
    ref_state = jnp.zeros(lead + (mb, w))
    for t in range(6):
        x = injects[t] if t < 3 else np.zeros_like(injects[0])
        ref_state, ref_out = ref_pp.pipeline_step_hetero(
            _toy_stages(s, "jax"), ref_state, jnp.asarray(x), n_stages=s,
            n_replicas=n_replicas)
        state, out = pp.pipeline_step_hetero(
            _toy_stages(s, "torch"), state, torch.from_numpy(x), n_stages=s,
            n_replicas=n_replicas, out=torch.empty_like(state))
        np.testing.assert_array_equal(state.numpy(), np.asarray(ref_state))
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref_out))


@pytest.mark.parametrize("n_replicas", [1, 2])
@pytest.mark.parametrize("m", [1, 2, 5])
def test_batch_executor_matches_the_reference(m, n_replicas):
    """The port's pipeline_apply_gspmd_hetero (M + S - 1 ticks) equals
    the reference's mesh-less one on order-sensitive toy
    stage programs (the port skips the idle stage runs, the reference
    runs them on stale slots)."""
    s, mb, w = 3, 2, 4
    rep = n_replicas > 1
    shape = ((n_replicas,) if rep else ()) + (m, mb, w)
    x = np.random.default_rng(m).normal(size=shape).astype(np.float32)
    want = np.asarray(ref_pp.pipeline_apply_gspmd_hetero(
        _toy_stages(s, "jax"), jnp.asarray(x), n_stages=s,
        n_replicas=n_replicas))
    got = pp.pipeline_apply_gspmd_hetero(_toy_stages(s, "torch"),
                                         torch.from_numpy(x), n_stages=s,
                                         n_replicas=n_replicas)
    np.testing.assert_array_equal(got.numpy(), want)


def test_executors_refuse_what_the_reference_refuses():
    fns = _toy_stages(1, "torch")
    xw = torch.zeros((2, 1, 4))
    with pytest.raises(ValueError, match="requires a mesh"):
        pp.pipeline_apply_gspmd_hetero(fns, xw, n_stages=1,
                                       stage_params=torch.zeros((1, 8)))
    with pytest.raises(ValueError, match="mesh has no 'pod' axis"):
        pp.pipeline_apply_gspmd_hetero(fns, xw, n_stages=1, mesh=Mesh(
            ("stage",), (1,), device_slots(1, "cpu")))
    with pytest.raises(ValueError, match="1 stage programs for 2"):
        pp.pipeline_apply_gspmd_hetero(fns, xw, n_stages=2)
    with pytest.raises(ValueError, match="n_replicas"):
        pp.pipeline_apply_gspmd_hetero(fns, torch.zeros((3, 2, 1, 4)),
                                       n_stages=1, n_replicas=2)
    with pytest.raises(ValueError, match="state leading dims"):
        pp.pipeline_step_hetero(fns, torch.zeros((2, 1, 4)), None,
                                n_stages=1)


# -- serving -------------------------------------------------------------------

@pytest.mark.parametrize("arch,n_replicas", [("resnet50", 1),
                                             ("mobilenet_v1", 1),
                                             ("mobilenet_v2", 1),
                                             ("mobilenet_v1", 2)])
def test_continuous_back_to_back_equals_isolated(arch, n_replicas):
    """Requests of 3, 2 and 5 images streamed back to back (the pipeline
    never drains between them) give the logits each gives alone, bit for
    bit, and those of the sequential forward; the slot counters add up."""
    srv = CNNPipelineServer(arch, mb_size=2, n_stages=3, image_size=IMAGE,
                            n_replicas=n_replicas, device="cpu")
    reqs = [_images(n, seed=10 + n).numpy() for n in (3, 2, 5)]
    ids = [srv.submit(x) for x in reqs]
    m = srv.run()
    streamed = [srv.results(i) for i in ids]
    n_mb = 2 + 1 + 3
    assert m["images"] == 10 and m["injected_microbatches"] == n_mb
    assert srv.idle_slots == srv.ticks * n_replicas - srv.injected_slots
    if n_replicas == 1:
        assert m["ticks"] == n_mb + 2
        assert m["steady_bubble"] == pp.steady_bubble_fraction(n_mb, 3)
    params = port_serve._init_native(get_config(arch), 0)
    for x, got in zip(reqs, streamed):
        alone = srv.submit(x)
        srv.run()
        np.testing.assert_array_equal(srv.results(alone), got)
        want = cnn.cnn_forward(get_config(arch), params,
                               torch.from_numpy(x), device="cpu")
        np.testing.assert_array_equal(got, want.numpy())
    assert not srv.busy
    with pytest.raises(KeyError, match="unknown request"):
        srv.results(ids[0])
    with pytest.raises(ValueError, match="empty request"):
        srv.submit(np.zeros((0, IMAGE, IMAGE, 3), np.float32))
    with pytest.raises(ValueError, match="request shape"):
        srv.submit(np.zeros((1, 8, 8, 3), np.float32))


@pytest.mark.parametrize("quantize", ["native", "f32", "bf16", "int8"])
def test_serve_throughput_and_continuous_at_every_store_dtype(quantize):
    """``serve()`` in both throughput modes on the CPU, at every store
    dtype, gives the sequential forward on the stored weights bitwise."""
    cfg = get_config("mobilenet_v1")
    params = quantize_tree(port_serve._init_native(cfg, 0), quantize)
    out = serve(ServeConfig(arch="mobilenet_v1", device="cpu",
                            image_size=IMAGE, batch=4, n_microbatches=2,
                            n_stages=3, iters=1, quantize=quantize,
                            verbose=False))
    want = cnn.cnn_forward(cfg, params, torch.from_numpy(out["images"]),
                           device="cpu")
    np.testing.assert_array_equal(out["logits"], want.numpy())
    assert out["quantize"] == quantize and out["n_stages"] == 3
    cont = serve(ServeConfig(arch="mobilenet_v1", device="cpu",
                             image_size=IMAGE, continuous=True, batch=3,
                             n_requests=2, n_stages=3, quantize=quantize,
                             verbose=False))
    for x, got in zip(cont["request_images"], cont["logits"]):
        want = cnn.cnn_forward(cfg, params, torch.from_numpy(x),
                               device="cpu")
        np.testing.assert_array_equal(got, want.numpy())


def _ref_tree(params):
    """The port's dense weights as the reference's arrays, bit for bit."""
    def arr(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
        return jnp.asarray(t.numpy())
    return {n: {"w": arr(p["w"]), "b": arr(p["b"])}
            for n, p in params.items()}


@pytest.mark.parametrize("kw", [
    {"auto_split": True}, {"tuning_cache": "cache.json"},
    {"calibrate": True}, {"n_microbatches": 0},
    {"placed": True, "n_stages": 1}, {"continuous": True, "placed": True,
                                      "n_stages": 1},
    {"continuous": True, "auto_split": True}, {"tier": True},
], ids=str)
def test_unported_throughput_knobs_name_their_roadmap_item(kw, monkeypatch,
                                                           tmp_path):
    """The co-planner's split, a tuning cache (here a missing file: a
    cold cache), calibration and the autotuned microbatch count now run:
    the plan (and M) equal the reference planner's on the same weights
    under the same request, the calibrated plan read from the port's own
    measurements, and the logits the sequential forward's bitwise.
    Per-stage placement with one device per stage (S = 1) now runs: the
    placed stage program reads the row of the even (1, width) buffer,
    and its logits are the sequential forward's bitwise; the tier serves
    since it was ported, every request the sequential forward's
    bitwise."""
    base = dict(arch="mobilenet_v1", device="cpu", image_size=IMAGE,
                batch=4, n_requests=2, mb_size=2, verbose=False)
    if kw.get("placed"):
        out = serve(ServeConfig(**base, **kw))
        assert out["placed"] is True and out["n_stages"] == 1
        cfg = get_config("mobilenet_v1")
        params = port_serve._init_native(cfg, 0)
        images = out["request_images"] if kw.get("continuous") \
            else [out["images"]]
        logits = out["logits"] if kw.get("continuous") else [out["logits"]]
        for x, got in zip(images, logits):
            np.testing.assert_array_equal(got, cnn.cnn_forward(
                cfg, params, torch.from_numpy(x), device="cpu").numpy())
        return
    if kw.get("tier"):
        out = serve(ServeConfig(**base, **kw))
        assert (out["completed"], out["failed"]) == (2, 0)
        cfg = get_config("mobilenet_v1")
        params = port_serve._init_native(cfg, 0)
        for x, got in zip(out["request_images"], out["logits"]):
            np.testing.assert_array_equal(got, np.concatenate([
                cnn.cnn_forward(cfg, params, torch.from_numpy(x[i:i + 2]),
                                device="cpu").numpy()
                for i in range(0, len(x), 2)]))
        return
    from repro.configs import get_config as ref_get_config
    from repro.core import planner as ref_planner
    from repro.core import tuning as ref_tuning
    from repro_torch.core import tuning
    monkeypatch.chdir(tmp_path)              # cache.json: a missing file
    cfg = get_config("mobilenet_v1")
    params = port_serve._init_native(cfg, 0)
    ref_cfg, ref_params = ref_get_config("mobilenet_v1"), _ref_tree(params)
    tuning.set_tuning_cache(None)
    try:
        out = serve(ServeConfig(**base, **kw))
        cache = tuning.current_tuning_cache()
    finally:
        tuning.set_tuning_cache(None)
    m = 32 if kw.get("continuous") else 4
    if kw.get("auto_split"):
        want = ref_planner.plan(ref_cfg, ref_params, ref_planner.PlanRequest(
            n_devices=1, n_microbatches=m))
        assert (out["n_stages"], out["n_replicas"]) == (
            want["n_stages"], want["n_replicas"]) == (1, 1)
        want = want["plan"]
    elif "tuning_cache" in kw or kw.get("calibrate"):
        sig = ref_tuning.device_signature()
        ref_cache = ref_tuning.TuningCache(
            {k.replace("/cpu:plain", f"/{sig}"): v
             for k, v in cache.entries.items()}, dict(cache.meta))
        assert len(cache) > 0 if kw.get("calibrate") else len(cache) == 0
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = ref_planner.plan(ref_cfg, ref_params,
                                    ref_planner.PlanRequest(
                                        n_stages=4, model="measured",
                                        tuning_cache=ref_cache))
        if kw.get("calibrate"):
            assert want["measured_coverage"]["coverage"] == 1.0
    else:
        want = ref_planner.plan(ref_cfg, ref_params,
                                ref_planner.PlanRequest(n_stages=4))
        assert out["n_microbatches"] == ref_tuning.autotune_microbatch(
            want["stage_cost"], n_replicas=1)
    assert out["n_stages"] == want["n_stages"]
    assert out["stage_of"] == want["stage_of"]
    if kw.get("continuous"):
        for x, got in zip(out["request_images"], out["logits"]):
            np.testing.assert_array_equal(got, cnn.cnn_forward(
                cfg, params, torch.from_numpy(x), device="cpu").numpy())
    else:
        want_logits = cnn.cnn_forward(cfg, params,
                                      torch.from_numpy(out["images"]),
                                      device="cpu")
        np.testing.assert_array_equal(out["logits"], want_logits.numpy())


@pytest.mark.parametrize("continuous", [False, True])
def test_placed_without_a_device_per_stage_raises_the_reference_error(
        continuous):
    with pytest.raises(ValueError, match="placed=True needs >= 3 devices"):
        serve(ServeConfig(arch="mobilenet_v1", device="cpu",
                          image_size=IMAGE, batch=4, n_stages=3,
                          placed=True, continuous=continuous, verbose=False))


@pytest.mark.parametrize("argv", [
    ["--microbatches", "2", "--stages", "3", "--batch", "4"],
    ["--continuous", "--requests", "2", "--batch", "3", "--mb-size", "2",
     "--stages", "2"],
    ["--mode", "latency", "--requests", "2", "--stages", "3"],
    ["--microbatches", "1", "--stages", "4", "--batch", "4",
     "--replicas", "2", "--param-budget-frac", "0.5"],
], ids=["throughput", "continuous", "latency", "replicas-budget"])
def test_main_flags(argv, capsys):
    port_serve.main(["--arch", "mobilenet_v1", "--device", "cpu",
                     "--image-size", str(IMAGE)] + argv)
    out = capsys.readouterr().out
    assert "mobilenet_v1:" in out and ("im/s" in out or "p50" in out)
