"""The port's measured cost model, kernel autotuning and the rest of the
planner (``core/tuning.py``, ``core/costmodel.fit_scale_factors``,
``core/planner.py``: ``model="measured"``, ``_plan_2d``, ``_replan_2d``,
``PlanRequest(n_devices=...)``, the DSP balancer) against the JAX
reference on the reference's own weights carried across with
``params_from_numpy``: cache persistence, every key string, cold /
seeded / partial / checked-in caches planning key for key as the
reference does, the co-planner at 1-8 devices, ``balance`` /
``evaluate`` / ``plan_cnn``, the autotuners' candidate sets, the knob
lookup, and ``serve(device="cpu")`` with a tuning cache, calibration,
the co-planner's split and an autotuned microbatch count."""
import functools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import costmodel as ref_costmodel  # noqa: E402
from repro.core import planner as ref_planner  # noqa: E402
from repro.core import tuning as ref_tuning  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.models import cnn as ref_cnn  # noqa: E402
from repro.models.layers import SparseWeight as RefSparseWeight  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import costmodel, planner, tuning  # noqa: E402
from repro_torch.core.fusion import conv_part, fused_graph_for  # noqa: E402
from repro_torch.core.graph import graph_for  # noqa: E402
from repro_torch.kernels import depthwise_conv as dwk  # noqa: E402
from repro_torch.kernels import dw_pw_fused as dwpw  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import sparse_conv as sc  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.launch.serve import ServeConfig, serve  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.models.layers import SparseWeight  # noqa: E402

ARCHS = ["resnet50", "mobilenet_v1", "mobilenet_v2"]
IMAGE = 32
# one device string for both sides, so keys can be compared as strings
DEV = "cpu:xla"
PLAN_KEYS = ("stage_of", "n_stages", "stage_cost", "node_cycles",
             "imbalance", "node_param_bytes", "stage_param_bytes",
             "placed_bytes_per_device", "param_budget_bytes", "store_dtype",
             "cost_model", "measured_coverage")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs files side by side in worker
    processes, and a full torch thread pool in each oversubscribes the
    cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_active_cache():
    """serve() installs its cache process-wide, as the reference's does;
    each test starts and ends without one."""
    tuning.set_tuning_cache(None)
    yield
    tuning.set_tuning_cache(None)


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
def _weights(arch):
    """(reference cfg, reference params, port cfg, port params), the
    reference's weights from seed 0 carried across."""
    ref_cfg = ref_get_config(arch)
    ref = jax.jit(lambda k: ref_cnn.init_cnn(ref_cfg, k))(
        jax.random.PRNGKey(0))
    return (ref_cfg, ref, get_config(arch),
            cnn.params_from_numpy(_numpy_tree(ref), device="cpu"))


def _quiet(fn):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn()


def _same(got, want, what=""):
    """Equal key for key, arrays exactly, dicts recursively."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, what
        np.testing.assert_array_equal(got, want, err_msg=what)
    elif isinstance(want, dict):
        assert set(got) == set(want), (what, set(got) ^ set(want))
        for k in want:
            _same(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, list) and want and isinstance(want[0], dict):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{what}[{i}]")
    else:
        assert type(got) is type(want) and got == want, (what, got, want)


def _same_plan(got, want):
    for key in PLAN_KEYS:
        _same(got[key], want[key], key)


def _port_cache(ref_cache):
    return tuning.TuningCache(
        {k: dict(v) for k, v in ref_cache.entries.items()},
        meta=dict(ref_cache.meta))


# -- the cache ---------------------------------------------------------------

def test_cache_round_trip_and_bytes_equal_the_reference(tmp_path):
    c = tuning.TuningCache()
    c.put_time("node/x", 12.5)
    c.put_knob("kern/y", "tm", 16)
    c.put_knob("kern/y", "split", 2)
    c.meta.update({"device": "cpu:plain", "image_shape": [1, 64, 64, 3]})
    p = tmp_path / "cache.json"
    c.save(p)
    c2 = tuning.TuningCache.load(p)
    assert c2.time_us("node/x") == 12.5 and c2.time_us("kern/z") is None
    assert c2.knob("kern/y", "tm", 0) == 16 and c2.knob("kern/y", "r", 7) == 7
    assert c2.meta["image_shape"] == [1, 64, 64, 3]
    assert len(c2) == len(c) == 2 and "node/x" in c2
    p2 = tmp_path / "cache2.json"
    c2.save(p2)
    assert p.read_text() == p2.read_text()
    ref = ref_tuning.TuningCache(c.entries, c.meta)
    ref.save(tmp_path / "ref.json")
    assert (tmp_path / "ref.json").read_text() == p.read_text()


def test_missing_file_loads_as_a_cold_cache(tmp_path):
    c = tuning.TuningCache.load(tmp_path / "nope.json")
    assert len(c) == 0 and c.time_us("anything") is None and c.meta == {}


# -- keys --------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_keys_equal_the_reference(arch):
    """Every node key of the fused graph at batch 1 and of the unfused
    view at batch 4, and the kernel keys of each knob site, character for character, given
    one device string; the dtype is ``bfloat16``."""
    ref_cfg, ref_params, cfg, params = _weights(arch)
    for shape, g, rg in (((1, 64, 64, 3), None, None),
                         ((4, IMAGE, IMAGE, 3), graph_for(arch),
                          ref_cnn.graph_for(arch))):
        got = tuning.graph_node_keys(cfg, params, shape, graph=g,
                                     device=DEV)
        want = ref_tuning.graph_node_keys(ref_cfg, ref_params, shape,
                                          graph=rg, device=DEV)
        assert [k for _, k in got] == [k for _, k in want]
        assert [tuning.calibration_kind(n, params) for n, _ in got] == \
            [ref_tuning.calibration_kind(n, ref_params) for n, _ in want]
    assert "/bfloat16/" in got[0][1]
    x = (2, 28, 28, 128)
    for op, fields in (("sconv", dict(k=3, s=1, b="32x32K12", co=128)),
                       ("dwpw", dict(k=3, s=2, co=256)),
                       ("dw", dict(k=3, s=1)),
                       ("microbatch", dict(arch=arch))):
        assert tuning.kernel_key(op, x, torch.bfloat16, device=DEV,
                                 **fields) == ref_tuning.kernel_key(
            op, x, jnp.bfloat16, device=DEV, **fields)
    assert tuning.kernel_key("microbatch", (4, 1), np.float32, device=DEV,
                             arch=arch) == ref_tuning.kernel_key(
        "microbatch", (4, 1), np.float32, device=DEV, arch=arch)


def test_device_signature():
    assert tuning.device_signature("cpu") == "cpu:plain"
    if not torch.cuda.is_available():
        assert tuning.device_signature() == "cpu:plain"
    with tuning.device_scope(DEV):
        assert tuning.device_signature() == DEV
        assert tuning.device_signature("cpu") == "cpu:plain"
        with tuning.device_scope("cpu"):
            assert tuning.device_signature() == "cpu:plain"
        assert tuning.device_signature() == DEV


# -- the measured cost model -------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_cold_cache_is_the_analytic_plan(arch):
    """An empty cache: the measured costs are the analytic ones bit for
    bit, with the reference's warning and report, and the plan equals
    the analytic plan and the reference's measured plan key for key."""
    ref_cfg, ref_params, cfg, params = _weights(arch)
    analytic = planner.cnn_node_costs(cfg, params)
    with pytest.warns(UserWarning, match="cold-cache") as got_w:
        costs, report = tuning.measured_node_costs(
            cfg, params, cache=tuning.TuningCache())
    with pytest.warns(UserWarning, match="cold-cache") as want_w:
        want_costs, want_report = ref_tuning.measured_node_costs(
            ref_cfg, ref_params, cache=ref_tuning.TuningCache())
    assert [str(w.message) for w in got_w] == [str(w.message) for w in want_w]
    np.testing.assert_array_equal(costs, analytic)
    np.testing.assert_array_equal(costs, want_costs)
    _same(report, want_report)
    assert report["coverage"] == 0.0 and report["units"] == "cycles"
    pa = planner.plan(cfg, params, planner.PlanRequest(n_stages=4))
    pm = _quiet(lambda: planner.plan(cfg, params, planner.PlanRequest(
        n_stages=4, model="measured", tuning_cache=tuning.TuningCache())))
    want = _quiet(lambda: ref_planner.plan(
        ref_cfg, ref_params, ref_planner.PlanRequest(
            n_stages=4, model="measured",
            tuning_cache=ref_tuning.TuningCache())))
    assert pm["stage_of"] == pa["stage_of"]
    np.testing.assert_array_equal(pm["node_cycles"], pa["node_cycles"])
    _same_plan(pm, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_seeded_cache_plans_identically(arch):
    """seed_from_analytic's cache equals the reference's (given one
    device string) and gives the analytic cut, twice over."""
    ref_cfg, ref_params, cfg, params = _weights(arch)
    with tuning.device_scope(DEV):
        cache = tuning.seed_from_analytic(cfg, params, (1, 64, 64, 3))
    ref_cache = ref_tuning.seed_from_analytic(
        ref_cfg, ref_params, (1, 64, 64, 3))
    assert cache.meta["seeded"] == "analytic" and len(cache) > 0
    assert cache.entries == {k.replace(ref_cache.meta["device"], DEV): v
                             for k, v in ref_cache.entries.items()}
    pa = planner.plan(cfg, params, planner.PlanRequest(n_stages=4))
    with tuning.device_scope(DEV):
        pm = planner.plan(cfg, params, planner.PlanRequest(
            n_stages=4, model="measured", tuning_cache=cache))
        pm2 = planner.plan(cfg, params, planner.PlanRequest(
            n_stages=4, model="measured", tuning_cache=cache))
    assert pm["stage_of"] == pa["stage_of"] == pm2["stage_of"]
    assert pm["measured_coverage"]["coverage"] == 1.0
    assert pm["measured_coverage"]["fallback"] == []
    np.testing.assert_array_equal(pm2["node_cycles"], pm["node_cycles"])
    want = ref_planner.plan(ref_cfg, ref_params, ref_planner.PlanRequest(
        n_stages=4, model="measured", tuning_cache=ref_cache))
    _same_plan(pm, want)


@pytest.mark.parametrize("n_stages", [2, 4, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_partial_cache_matches_the_reference(arch, n_stages):
    """Every other node key kept and its time scaled by a node-dependent
    factor: the fallback list, the fitted scales (fit_scale_factors), the
    warning, the costs and the plan equal the reference's."""
    ref_cfg, ref_params, cfg, params = _weights(arch)
    full = ref_tuning.seed_from_analytic(ref_cfg, ref_params,
                                         (1, 64, 64, 3))
    keys = sorted(full.entries)
    partial = ref_tuning.TuningCache(
        {k: {"time_us": full.entries[k]["time_us"] * (1.5 + (i % 5) / 4)}
         for i, k in enumerate(keys) if i % 2 == 0}, dict(full.meta))
    sig = full.meta["device"]
    with warnings.catch_warnings(record=True) as want_w:
        warnings.simplefilter("always")
        want_costs, want_report = ref_tuning.measured_node_costs(
            ref_cfg, ref_params, cache=partial)
        want = ref_planner.plan(ref_cfg, ref_params, ref_planner.PlanRequest(
            n_stages=n_stages, model="measured", tuning_cache=partial))
    with tuning.device_scope(sig), warnings.catch_warnings(
            record=True) as got_w:
        warnings.simplefilter("always")
        costs, report = tuning.measured_node_costs(
            cfg, params, cache=_port_cache(partial))
        got = planner.plan(cfg, params, planner.PlanRequest(
            n_stages=n_stages, model="measured",
            tuning_cache=_port_cache(partial)))
    assert 0.0 < report["coverage"] < 1.0 and report["fallback"]
    assert [str(w.message) for w in got_w] == [str(w.message) for w in want_w]
    np.testing.assert_array_equal(costs, want_costs)
    _same(report, want_report)
    _same_plan(got, want)
    kinds = [tuning.calibration_kind(n, params)
             for n in fused_graph_for(arch).nodes]
    measured = [None if n.name in report["fallback"] else c
                for n, c in zip(fused_graph_for(arch).nodes, costs)]
    analytic = planner.cnn_node_costs(cfg, params)
    assert costmodel.fit_scale_factors(measured, analytic, kinds) == \
        ref_costmodel.fit_scale_factors(measured, analytic, kinds) == \
        report["scales"]


def test_calibration_kind_splits_sparse_from_dense():
    _, _, cfg, params = _weights("resnet50")
    kinds = {tuning.calibration_kind(n, params)
             for n in fused_graph_for("resnet50").nodes}
    assert {"conv/sparse", "conv/dense", "avgpool_fc/sparse"} <= kinds
    _, _, cfg, params = _weights("mobilenet_v1")
    kinds = {tuning.calibration_kind(n, params)
             for n in fused_graph_for("mobilenet_v1").nodes}
    assert "dw_pw/dense" in kinds and not any("sparse" in k for k in kinds)


@pytest.mark.parametrize("n_stages", [2, 4, 8])
def test_checked_in_cache_plans_as_the_reference(n_stages):
    """``tuning/resnet50_cpu.json``, read unchanged with its own device
    string, gives the reference's measured plan key for key. Its
    ``kern/...`` entries (the reference's XLA row_chunk) name no knob of
    the port's kernels and stay inert."""
    ref_cfg, ref_params, cfg, params = _weights("resnet50")
    path = "tuning/resnet50_cpu.json"
    cache = tuning.TuningCache.load(path)
    sig = cache.meta["device"]
    assert sig == "cpu:xla" and len(cache) > 0
    with ref_ops.config(impl="xla"):
        want = _quiet(lambda: ref_planner.plan(
            ref_cfg, ref_params, ref_planner.PlanRequest(
                n_stages=n_stages, model="measured",
                tuning_cache=ref_tuning.TuningCache.load(path))))
    with tuning.device_scope(sig):
        got = _quiet(lambda: planner.plan(cfg, params, planner.PlanRequest(
            n_stages=n_stages, model="measured", tuning_cache=cache)))
    _same_plan(got, want)
    assert got["measured_coverage"]["n_measured"] > 0
    analytic = planner.plan(cfg, params, planner.PlanRequest(
        n_stages=n_stages))
    if n_stages == 4:
        assert got["imbalance"] < analytic["imbalance"]
    kern = [k for k in cache.entries if k.startswith("kern/")]
    assert kern
    with tuning.set_tuning_cache(cache):
        for key in kern:
            _, op, shape, *_ = key.split("/")
            shp = tuple(int(v) for v in shape[2:].split("x"))
            for name in ("tm", "tn", "ck", "split", "r", "threads"):
                assert ops._knob(op, shp, torch.bfloat16, name, None,
                                 device=sig, k=3, s=1) is None


# -- the co-planner and the re-planner ---------------------------------------

@pytest.mark.parametrize("budget", [False, True], ids=["nobudget", "budget"])
@pytest.mark.parametrize("arch", ARCHS)
def test_co_planner_matches_the_reference(arch, budget):
    """plan(PlanRequest(n_devices=1..8)), with and without a budget and a
    previous plan, key for key: the split, the scored candidate table,
    the nested cut, ``reused``; where nothing fits, the same error."""
    ref_cfg, ref_params, cfg, params = _weights(arch)
    total = ref_costmodel.pytree_param_bytes(ref_params, "native")
    cap = int(0.4 * total) if budget else None
    prevs = {s: (planner.plan(cfg, params, planner.PlanRequest(n_stages=s)),
                 ref_planner.plan(ref_cfg, ref_params,
                                  ref_planner.PlanRequest(n_stages=s)))
             for s in (2, 4)}
    for n_dev in range(1, 9):
        for prev in (None, 2, 4):
            def req(mod, p):
                return mod.PlanRequest(n_devices=n_dev, n_microbatches=4,
                                       max_stage_param_bytes=cap, prev=p)
            try:
                want = ref_planner.plan(ref_cfg, ref_params, req(
                    ref_planner, prevs[prev][1] if prev else None))
            except ValueError as e:
                with pytest.raises(ValueError) as got_e:
                    planner.plan(cfg, params, req(
                        planner, prevs[prev][0] if prev else None))
                assert str(got_e.value) == str(e)
                continue
            got = planner.plan(cfg, params, req(
                planner, prevs[prev][0] if prev else None))
            assert isinstance(got, planner.PipelinePlan)
            assert isinstance(got.plan, planner.PipelinePlan)
            for key in set(want) - {"plan"}:
                _same(got[key], want[key], key)
            assert set(got) == set(want)
            _same_plan(got["plan"], want["plan"])
            assert got.n_stages * got.n_replicas == got.n_devices_used


def test_deprecated_shims_warn_and_plan_as_plan():
    _, _, cfg, params = _weights("mobilenet_v1")
    for shim, arg, req in (
            (planner.plan_cnn_pipeline, 3, planner.PlanRequest(n_stages=3)),
            (planner.plan_cnn_pipeline_2d, 4,
             planner.PlanRequest(n_devices=4)),
            (planner.replan_cnn_pipeline_2d, 4,
             planner.PlanRequest(n_devices=4))):
        with pytest.warns(DeprecationWarning, match="deprecated"):
            old = shim(cfg, params, arg)
        new = planner.plan(cfg, params, req)
        assert old["n_stages"] == new["n_stages"]
        if "plan" in new:
            assert old["plan"]["stage_of"] == new["plan"]["stage_of"]


# -- the paper's DSP balancer ------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_balance_evaluate_and_plan_cnn_match_the_reference(arch):
    ref_cfg, ref_params, cfg, params = _weights(arch)
    ops_ = planner.cnn_op_costs(cfg, params)
    ref_ops_ = ref_planner.cnn_op_costs(ref_cfg, ref_params)
    assert [o.name for o in ops_] == [o.name for o in ref_ops_]
    for model in ("aware", "naive"):
        got = planner.plan_cnn(cfg, params, 5000, model=model)
        want = ref_planner.plan_cnn(ref_cfg, ref_params, 5000, model=model)
        assert (got.splits, got.cycles, got.resources, got.budget,
                got.model) == (want.splits, want.cycles, want.resources,
                               want.budget, want.model)
        assert got.bottleneck_cycles == want.bottleneck_cycles
        assert got.throughput_rel == want.throughput_rel
        assert got.balance_spread() == want.balance_spread()
        for m in ("aware", "naive"):
            assert planner.evaluate(ops_, got.splits, m) == \
                ref_planner.evaluate(ref_ops_, want.splits, m)
    small = planner.balance(ops_, 500)
    assert small.splits == ref_planner.balance(ref_ops_, 500).splits


# -- the microbatch autotuner ------------------------------------------------

@pytest.mark.parametrize("costs", [[1.0] * 4, [3.0, 1.0, 1.0, 2.0],
                                   [5.0], [1.0, 9.0, 2.0]], ids=str)
def test_autotune_microbatch_matches_the_reference(costs):
    for kw in ({}, {"latency_cap_ticks": 11}, {"latency_cap_ticks": 2},
               {"n_replicas": 2, "rel_tol": 0.2}, {"candidates": (1, 3, 9)}):
        assert tuning.autotune_microbatch(costs, **kw) == \
            ref_tuning.autotune_microbatch(costs, **kw)
    cache = tuning.TuningCache()
    m = tuning.autotune_microbatch(costs, n_replicas=2, cache=cache,
                                   arch="resnet50")
    (key,) = cache.entries
    assert key == tuning.kernel_key("microbatch", (len(costs), 2),
                                    np.float32, arch="resnet50")
    assert cache.knob(key, "n_microbatches") == m


def test_autotune_microbatch_knee_and_cap():
    sc_ = np.ones(4)
    assert tuning.autotune_microbatch(sc_) == 32
    assert tuning.autotune_microbatch(sc_, latency_cap_ticks=11) == 8
    assert tuning.autotune_microbatch(sc_, latency_cap_ticks=2) == 2


# -- the kernel autotuners' candidates ---------------------------------------

def _mobilenet_blocks():
    for arch in ("mobilenet_v1", "mobilenet_v2"):
        for node in fused_graph_for(arch).nodes:
            if node.kind == "dw_pw":
                yield node


def test_autotuner_candidates_fit_the_kernels():
    """Every candidate of the three autotuners is a plan its kernel runs:
    sparse_conv's at the 47 ResNet-50 layers' K (split <= K, <=
    MAX_SPLIT, tm in TILES), dw_pw's at every MobileNet block at n 1, 2,
    4 and int8 (shared memory within SMEM_MAX, split <= MAX_SPLIT and the
    chunks of C), depthwise's (r, threads); each kernel's default plan is
    one of its candidates, and check_plan refuses what it cannot run."""
    _, _, cfg, params = _weights("resnet50")
    n_layers = 0
    for node in fused_graph_for("resnet50").nodes:
        w = params[conv_part(node).name]["w"] if node.kind == "conv" \
            else None
        if not isinstance(w, SparseWeight):
            continue
        ob, n_k = w.vals.shape[:2]
        cands = sc.plan_candidates(n_k)
        assert len(cands) == len(set(cands)) >= len(sc.TILES)
        for tm, split in cands:
            assert sc.check_plan((tm, split), n_k) == (tm, split)
            assert tm in sc.TILES and 1 <= split <= min(sc.MAX_SPLIT, n_k)
        for n in (1, 2, 4):
            m = n * node.conv_out_hw ** 2
            assert sc.plan(m, ob, n_k) in cands
        n_layers += 1
    assert n_layers == 47
    for bad in ((8, 1), (32, 0), (16, 9)):
        with pytest.raises(ValueError, match="plan"):
            sc.check_plan(bad, 12)
    with pytest.raises(ValueError, match="plan"):
        sc.check_plan((32, 4), 3)
    n_blocks = 0
    for node in _mobilenet_blocks():
        ho = node.conv_out_hw
        for n in (1, 2, 4):
            for codes in (False, True):
                args = (n, ho, ho, node.cin, node.cout, node.k, node.stride)
                cands = dwpw.plan_candidates(*args, codes=codes)
                assert len(cands) >= 8
                for p in cands:
                    assert p.smem <= dwpw.SMEM_MAX
                    assert 1 <= p.split <= dwpw.MAX_SPLIT
                    assert p.split <= -(-node.cin // p.ck)
                    assert p.tr * p.tw <= p.tm
                    assert dwpw.check_plan(p, *args, codes=codes) == p
                if not codes:
                    assert dwpw.plan(*args) in cands
        n_blocks += 1
    assert n_blocks == 30
    args = (1, 56, 56, 128, 128, 3, 1)
    good = dwpw.plan(*args)
    for bad in (good._replace(split=16), good._replace(ck=48),
                good._replace(tn=96), good._replace(tm=8),
                good._replace(tr=good.tm, tw=2),
                good._replace(ck=64, split=4)):    # 2 chunks of 64
        with pytest.raises(ValueError, match="plan"):
            dwpw.check_plan(bad, *args)
    # a halo that does not fit: a 64-pixel tile of a wide stride-4 row
    with pytest.raises(ValueError, match="shared memory"):
        dwpw.check_plan(dwpw.Plan(64, 128, 1, 64, 64, 1, 0, 0, 0),
                        1, 1, 64, 2048, 128, 7, 4)
    for c, stride in ((32, 1), (36, 1), (64, 2)):
        cands = dwk.plan_candidates(c, stride)
        assert dwk.plan(1, 56, 56, c, 3, stride) in cands
        assert {r for r, _ in cands} == ({1, 2, 4} if stride == 1 and
                                         c % 8 == 0 else {1})
        for r, t in cands:
            assert t in (32, 64, 128, 256)
    for bad, c, stride in (((4, 64), 32, 2), ((2, 64), 36, 1),
                           ((1, 96), 32, 1), ((3, 64), 32, 1)):
        with pytest.raises(ValueError, match="plan"):
            dwk.check_plan(bad, c, stride)


def test_sweep_tool_uses_the_autotuners_candidates():
    """tools/sweep_dw_pw.py sweeps the same candidate set, not a second
    enumeration."""
    src = open("tools/sweep_dw_pw.py").read()
    assert "plan_candidates(" in src and "for split in (1, 2, 4, 8)" not in src


def test_autotuners_refuse_the_plain_version():
    """On CPU tensors there is no kernel to tune: the autotuners refuse,
    autotune_graph records nothing, and calibrate only measures."""
    x = torch.ones((1, 8, 8, 16), dtype=torch.bfloat16)
    w = torch.ones((3, 3, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no knobs"):
        tuning.autotune_depthwise_plan(x, w, cache=tuning.TuningCache())
    _, _, cfg, params = _weights("mobilenet_v1")
    cache = tuning.autotune_graph(cfg, params, (1, IMAGE, IMAGE, 3),
                                  graph=graph_for("mobilenet_v1"))
    assert len(cache) == 0
    cache = tuning.calibrate(cfg, params, (1, IMAGE, IMAGE, 3),
                             autotune=True, iters=1)
    assert cache.meta["device"] == "cpu:plain"
    assert all(k.startswith("node/") and k.endswith("/cpu:plain")
               for k in cache.entries)
    assert len(cache) == len({k for _, k in tuning.graph_node_keys(
        cfg, params, (1, IMAGE, IMAGE, 3))})


# -- the knob lookup ---------------------------------------------------------

def test_knob_respects_the_active_cache_and_ignores_a_stale_key():
    shape = (2, 28, 28, 128)
    sig = tuning.device_signature("cpu")
    fields = dict(k=3, s=1, b="32x32K12", co=128)
    key = tuning.kernel_key("sconv", shape, torch.bfloat16, device=sig,
                            **fields)
    cache = tuning.TuningCache()
    cache.put_knob(key, "tm", 16)
    # the same site on another card, and another batch: stale for here
    cache.put_knob(key.replace(sig, "nvidia-other:cuda"), "split", 4)
    cache.put_knob(tuning.kernel_key("sconv", (4, 28, 28, 128),
                                     torch.bfloat16, device=sig, **fields),
                   "split", 8)

    def knob(name):
        return ops._knob("sconv", shape, torch.bfloat16, name, -1,
                         device="cpu", **fields)

    assert knob("tm") == -1                       # no active cache
    with ops.config(tuning_cache=cache):
        assert tuning.current_tuning_cache() is cache
        assert knob("tm") == 16 and knob("split") == -1
        with ops.config(int8_fast_path=False):
            assert knob("tm") == 16 and not ops.int8_fast_path()
        assert ops.int8_fast_path()
    assert tuning.current_tuning_cache() is None and knob("tm") == -1
    with ops.set_tuning_cache(cache):
        assert knob("tm") == 16
    assert tuning.current_tuning_cache() is None


def test_knobs_are_inert_on_the_cpu():
    """A cache full of plans for every kernel site leaves the plain path
    bitwise as it is (the plain versions have no tiles)."""
    _, _, cfg, params = _weights("mobilenet_v1")
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, IMAGE, IMAGE, 3)).astype(np.float32))
    want = cnn.cnn_forward(cfg, params, x, device="cpu")
    cache = tuning.TuningCache()
    for node in _mobilenet_blocks():
        key = tuning.kernel_key("dwpw", (1, 16, 16, node.cin),
                                torch.bfloat16, device="cpu:plain", k=3,
                                s=node.stride, co=node.cout)
        for name, v in (("tm", 7), ("tn", 3), ("ck", 5), ("split", 99)):
            cache.put_knob(key, name, v)
    with ops.config(tuning_cache=cache):
        got = cnn.cnn_forward(cfg, params, x, device="cpu")
    assert torch.equal(got, want)


# -- serving with the measured model -----------------------------------------

_SERVE_KW = [
    {"tuning_cache": "cache.json", "calibrate": True},
    {"tuning_cache": "object"}, {"auto_split": True},
    {"n_microbatches": 0}, {"continuous": True, "calibrate": True},
    {"continuous": True, "auto_split": True},
    {"mode": "latency", "tuning_cache": "cache.json", "calibrate": True},
]


@pytest.mark.parametrize("kw", _SERVE_KW, ids=str)
def test_serve_with_the_measured_model(kw, tmp_path):
    """serve(device="cpu") with a tuning cache (a path, written back, or
    an object), calibration, the co-planner's split and an autotuned M,
    in the batched, continuous and latency modes: each runs, plans as
    asked, and its logits equal the analytic run's bitwise."""
    kw = dict(kw)
    if kw.get("tuning_cache") == "cache.json":
        kw["tuning_cache"] = str(tmp_path / "cache.json")
    elif kw.get("tuning_cache") == "object":
        with tuning.device_scope("cpu"):
            kw["tuning_cache"] = tuning.seed_from_analytic(
                get_config("mobilenet_v1"),
                port_serve._init_native(get_config("mobilenet_v1"), 0),
                (1, IMAGE, IMAGE, 3))
    base = dict(arch="mobilenet_v1", device="cpu", image_size=IMAGE, batch=4,
                n_microbatches=2, n_stages=3, n_requests=2, mb_size=2,
                iters=1, verbose=False)
    mode = {k: kw[k] for k in ("mode", "continuous") if k in kw}
    want = serve(ServeConfig(**base, **mode))
    tuning.set_tuning_cache(None)
    got = serve(ServeConfig(**{**base, **kw}))
    if "tuning_cache" in kw or kw.get("calibrate"):
        assert tuning.current_tuning_cache() is not None
    if isinstance(kw.get("tuning_cache"), str):
        saved = tuning.TuningCache.load(kw["tuning_cache"])
        assert saved.meta["device"] == "cpu:plain" and len(saved) > 0
    if kw.get("auto_split"):
        assert got["n_stages"] == 1 and got["n_replicas"] == 1
    if kw.get("n_microbatches") == 0:
        cfg = get_config("mobilenet_v1")
        costs = planner.plan(cfg, port_serve._init_native(cfg, 0),
                             planner.PlanRequest(n_stages=3))["stage_cost"]
        assert got["n_microbatches"] == ref_tuning.autotune_microbatch(
            costs) == tuning.autotune_microbatch(costs)
    if isinstance(got["logits"], list):
        for g, w in zip(got["logits"], want["logits"]):
            np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_array_equal(got["logits"], want["logits"])


def test_main_tuning_flags(tmp_path, capsys):
    path = tmp_path / "c.json"
    port_serve.main(["--arch", "mobilenet_v1", "--device", "cpu",
                     "--image-size", str(IMAGE), "--batch", "4",
                     "--stages", "3", "--microbatches", "0", "--calibrate",
                     "--tuning-cache", str(path), "--auto-split"])
    out = capsys.readouterr().out
    assert "calibrating mobilenet_v1" in out and "autotuned" in out
    assert "through 1 stages" in out and path.exists()
