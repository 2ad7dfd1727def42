"""The port's stage planner (``core/graph.py`` partitioner,
``core/costmodel.py``, ``core/planner.py``) and the pipeline's plain
contracts (``core/pipeline.py``: ``microbatch``, the bubble formulas,
``WireFormat``) against the JAX reference, on the reference's own
weights carried across with ``params_from_numpy``: the analytic plan key
for key at every stage count, budget and store dtype, the stage slices
and live values, ``node_shapes`` and the wire widths, and the
reference's own contract tests mirrored."""
import dataclasses
import functools
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import costmodel as ref_costmodel  # noqa: E402
from repro.core import pipeline as ref_pp  # noqa: E402
from repro.core import planner as ref_planner  # noqa: E402
from repro.core.fusion import fused_graph_for as ref_fused_graph_for  # noqa: E402
from repro.core.graph import graph_for as ref_graph_for  # noqa: E402
from repro.models import cnn as ref_cnn  # noqa: E402
from repro.models.layers import SparseWeight as RefSparseWeight  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import costmodel  # noqa: E402
from repro_torch.core import pipeline as pp  # noqa: E402
from repro_torch.core import planner  # noqa: E402
from repro_torch.core.fusion import fused_graph_for  # noqa: E402
from repro_torch.core.graph import graph_for  # noqa: E402
from repro_torch.core.quant import STORE_DTYPES, pytree_param_bytes  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

ARCHS = ["resnet50", "mobilenet_v1", "mobilenet_v2"]
STAGES = [1, 2, 3, 4, 8]
# a per-stage byte budget of 0.4 of the stored model: no 1- or 2-stage
# cut fits it (both planners raise), deeper cuts rebalance around it
BUDGET_FRAC = 0.4
PLAN_KEYS = ("stage_of", "n_stages", "stage_cost", "node_cycles",
             "imbalance", "node_param_bytes", "stage_param_bytes",
             "placed_bytes_per_device", "param_budget_bytes", "store_dtype",
             "cost_model")


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


def _plan_or_error(plan_fn):
    try:
        return plan_fn(), None
    except ValueError as e:
        return None, str(e)


def _assert_same_plan(got, want):
    for key in PLAN_KEYS:
        g, w = got[key], want[key]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype, key
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            assert type(g) is type(w) and g == w, (key, g, w)


@pytest.mark.parametrize("store", STORE_DTYPES)
@pytest.mark.parametrize("budget", [False, True], ids=["nobudget", "budget"])
@pytest.mark.parametrize("n_stages", STAGES)
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_matches_reference(arch, n_stages, budget, store):
    """The analytic plan equals the reference's key for key, exactly: the
    cycle model over the same pruned block ids, the byte accounting at
    the store dtype, the memory-aware DP. Where no cut fits the budget,
    both raise the same ValueError."""
    ref_cfg, ref_params, cfg, params = _weights(arch)
    total = ref_costmodel.pytree_param_bytes(ref_params, store)
    assert pytree_param_bytes(params, store) == total
    cap = int(BUDGET_FRAC * total) if budget else None
    want, want_err = _plan_or_error(lambda: ref_planner.plan(
        ref_cfg, ref_params, ref_planner.PlanRequest(
            n_stages=n_stages, max_stage_param_bytes=cap,
            store_dtype=store)))
    got, got_err = _plan_or_error(lambda: planner.plan(
        cfg, params, planner.PlanRequest(
            n_stages=n_stages, max_stage_param_bytes=cap,
            store_dtype=store)))
    assert got_err == want_err
    if want is not None:
        assert isinstance(got, planner.PipelinePlan)
        assert got.stage_of == got["stage_of"]
        _assert_same_plan(got, want)
        assert got["measured_coverage"] is None
    if budget and n_stages <= 2:
        assert want_err is not None         # the budget's premise
    if not budget:
        assert want is not None and got["n_stages"] == min(
            n_stages, len(fused_graph_for(arch).nodes))


@pytest.mark.parametrize("unfused", [False, True], ids=["fused", "unfused"])
@pytest.mark.parametrize("n_stages", STAGES)
@pytest.mark.parametrize("arch", ARCHS)
def test_partition_and_live_values_match_reference(arch, n_stages, unfused):
    """partition() slices (bounds, live-in and live-out values, residual
    skips included), live_at at every boundary and consumers() equal the
    reference's, for the plan's cut of the fused or the unfused graph."""
    ref_cfg, ref_params, cfg, params = _weights(arch)
    g = graph_for(arch) if unfused else fused_graph_for(arch)
    rg = ref_graph_for(arch) if unfused else ref_fused_graph_for(arch)
    stage_of = planner.plan(cfg, params, planner.PlanRequest(
        n_stages=n_stages), graph=g)["stage_of"]
    assert stage_of == ref_planner.plan(
        ref_cfg, ref_params, ref_planner.PlanRequest(n_stages=n_stages),
        graph=rg)["stage_of"]
    got = [dataclasses.astuple(sl) for sl in g.partition(stage_of)]
    assert got == [dataclasses.astuple(sl) for sl in rg.partition(stage_of)]
    assert g.consumers() == rg.consumers()
    for b in range(len(g.nodes) + 1):
        assert g.live_at(b) == rg.live_at(b)
    assert [g.index(n.name) for n in g.nodes] == list(range(len(g.nodes)))
    assert [n.macs() for n in g.nodes] == [n.macs() for n in rg.nodes]


def test_live_at_carries_the_residual_skip():
    """A cut inside a ResNet block carries the block input (the skip)
    beside the running activation."""
    g = graph_for("resnet50")
    assert g.live_at(g.index("s0b1_c2")) == ("s0b0_add", "s0b1_c1")
    assert g.live_at(0) == ("__images__",)
    assert g.live_at(len(g.nodes)) == ("fc",)


def test_partition_refuses_bad_stage_ids():
    g = fused_graph_for("mobilenet_v1")
    n = len(g.nodes)
    for bad in ([0] * (n - 1), [1] * n, [0] * (n - 1) + [2],
                [0, 1] + [0] * (n - 2)):
        with pytest.raises(ValueError):
            g.partition(bad)
        with pytest.raises(ValueError):
            ref_fused_graph_for("mobilenet_v1").partition(bad)


@pytest.mark.parametrize("image_shape", [(4, 32, 32, 3), (1, 224, 224, 3),
                                         (2, 64, 64, 3)], ids=str)
@pytest.mark.parametrize("unfused", [False, True], ids=["fused", "unfused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_node_shapes_match_reference(arch, unfused, image_shape):
    """Every IR value's shape and dtype, derived from the specs, equals
    the reference's ``jax.eval_shape`` of its interpreter."""
    ref_cfg, ref_params, cfg, params = _weights(arch)
    g = graph_for(arch) if unfused else fused_graph_for(arch)
    rg = ref_graph_for(arch) if unfused else ref_fused_graph_for(arch)
    got = cnn.node_shapes(cfg, params, image_shape, graph=g)
    want = ref_cnn.node_shapes(ref_cfg, ref_params, image_shape, graph=rg)
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].shape == tuple(w.shape), name
        assert str(got[name].dtype) == f"torch.{w.dtype}", name


@pytest.mark.parametrize("n_stages", [1, 3, 4, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_wire_widths_match_reference(arch, n_stages):
    """The stage programs' wire width and every boundary's WireFormat
    width equal the reference's at the reference's test size (mb 2,
    32 px)."""
    ref_cfg, ref_params, cfg, params = _weights(arch)
    mb_shape = (2, 32, 32, 3)
    stage_of = planner.plan(cfg, params, planner.PlanRequest(
        n_stages=n_stages))["stage_of"]
    *_, width = cnn.stage_programs(cfg, params, stage_of, mb_shape)
    *_, ref_width = ref_cnn.stage_programs(ref_cfg, ref_params, stage_of,
                                           mb_shape)
    assert width == ref_width
    shapes = cnn.node_shapes(cfg, params, mb_shape)
    ref_shapes = ref_cnn.node_shapes(ref_cfg, ref_params, mb_shape)
    for sl in fused_graph_for(arch).partition(stage_of):
        for names in (sl.in_live, sl.out_live):
            got = pp.WireFormat.for_values(
                [(n, shapes[n].shape, shapes[n].dtype) for n in names])
            want = ref_pp.WireFormat.for_values(
                [(n, ref_shapes[n].shape, ref_shapes[n].dtype)
                 for n in names])
            assert (got.width, got.mb) == (want.width, want.mb)


def test_wire_format_round_trip_and_refusals():
    """pack -> unpack gives back every value bit for bit (bf16 through
    f32 exactly), into a given buffer too; the reference's refusals."""
    gen = torch.Generator().manual_seed(0)
    a = torch.randn((2, 3, 3, 4), generator=gen).to(torch.bfloat16)
    b = torch.randn((2, 5), generator=gen)
    fmt = pp.WireFormat.for_values([("a", a.shape, a.dtype),
                                    ("b", b.shape, b.dtype)])
    assert (fmt.mb, fmt.width) == (2, 41)
    wire = fmt.pack([a, b], 48)
    assert wire.shape == (2, 48) and wire.dtype == torch.float32
    assert not wire[:, 41:].any()
    out = torch.full((2, 48), 7.0)
    assert fmt.pack([a, b], 48, out=out) is out
    for w in (wire, out):
        ga, gb = fmt.unpack(w)
        assert ga.dtype == torch.bfloat16 and torch.equal(ga, a)
        assert ga.is_contiguous() and torch.equal(gb, b)
    with pytest.raises(ValueError, match="width"):
        fmt.pack([a, b], 40)
    with pytest.raises(ValueError, match="expected 2 values"):
        fmt.pack([a], 48)
    with pytest.raises(ValueError, match="at least one"):
        pp.WireFormat.for_values([])
    with pytest.raises(ValueError, match="mixed microbatch"):
        pp.WireFormat.for_values([("a", (2, 3), torch.float32),
                                  ("b", (3, 3), torch.float32)])


# -- the reference's contract tests, mirrored ---------------------------------

def test_assign_stages_clamps_when_overprovisioned():
    costs = np.array([3.0, 1.0, 2.0])
    assert planner.assign_stages(costs, 8) == [0, 1, 2]
    assert planner.assign_stages(costs, 8) == \
        ref_planner.assign_stages(costs, 8)
    with pytest.raises(ValueError, match=">= 1"):
        planner.assign_stages(costs, 0)
    with pytest.raises(ValueError, match="at least one"):
        planner.assign_stages(np.array([]), 2)


def test_assign_stages_weight_budget_rebalances():
    costs = np.array([1.0, 1.0, 8.0])
    weights = np.array([6.0, 6.0, 1.0])
    assert planner.assign_stages(costs, 2) == [0, 0, 1]
    assert planner.assign_stages(costs, 2, weights=weights,
                                 weight_budget=10.0) == [0, 1, 1]
    cases = [(costs, 3, np.array([1.0, 20.0, 1.0]), 10.0, "alone exceed"),
             (np.ones(3), 2, np.array([6.0, 6.0, 6.0]), 7.0,
              "fits the per-stage weight")]
    for c, s, w, cap, match in cases:
        with pytest.raises(ValueError, match=match) as got:
            planner.assign_stages(c, s, weights=w, weight_budget=cap)
        with pytest.raises(ValueError) as want:
            ref_planner.assign_stages(c, s, weights=w, weight_budget=cap)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="2 weights for 3 layers"):
        planner.assign_stages(costs, 2, weights=np.ones(2), weight_budget=5)


@pytest.mark.parametrize("seed", range(6))
def test_assign_stages_optimal_and_equal_to_reference(seed):
    """The DP matches brute force and the reference, with and without a
    budget, on small random instances."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 9))
    costs = rng.uniform(0.1, 100.0, n)
    weights = rng.uniform(1.0, 10.0, n)
    for n_stages in range(1, n + 1):
        stage_of = planner.assign_stages(costs, n_stages)
        assert stage_of == ref_planner.assign_stages(costs, n_stages)
        got = max(costs[np.array(stage_of) == s].sum()
                  for s in range(max(stage_of) + 1))
        best = min(max(costs[a:b].sum() for a, b in
                       zip((0,) + cuts, cuts + (n,)))
                   for cuts in itertools.combinations(range(1, n),
                                                      n_stages - 1))
        assert got <= best + 1e-9
        cap = float(weights.sum() / n_stages * 1.3)
        got_b, err = _plan_or_error(lambda: planner.assign_stages(
            costs, n_stages, weights=weights, weight_budget=cap))
        want_b, want_err = _plan_or_error(lambda: ref_planner.assign_stages(
            costs, n_stages, weights=weights, weight_budget=cap))
        assert (got_b, err) == (want_b, want_err)


def test_microbatch_contract():
    """The reference's microbatch contract and messages
    (tests/test_cnn_pipeline.py), on torch tensors."""
    x = torch.arange(12.0).reshape(6, 2)
    with pytest.raises(ValueError, match="not divisible") as got:
        pp.microbatch(x, 4)
    with pytest.raises(ValueError) as want:
        ref_pp.microbatch(jnp.asarray(x.numpy()), 4)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match=">= 1"):
        pp.microbatch(x, 0)
    padded = pp.microbatch(x, 4, pad=True)
    assert padded.shape == (4, 2, 2)
    assert torch.equal(padded.reshape(8, 2)[:6], x)
    assert not padded.reshape(8, 2)[6:].any()
    assert pp.microbatch(x, 3).shape == (3, 2, 2)


def test_microbatch_replication_contract():
    x = torch.arange(12.0).reshape(6, 2)
    with pytest.raises(ValueError) as got:
        pp.microbatch(x, 2, n_replicas=2)
    with pytest.raises(ValueError) as want:
        ref_pp.microbatch(jnp.asarray(x.numpy()), 2, n_replicas=2)
    assert str(got.value) == str(want.value)
    assert "n_replicas 2" in str(got.value)
    assert "n_microbatches 2" in str(got.value)
    with pytest.raises(ValueError, match=">= 1"):
        pp.microbatch(x, 3, n_replicas=0)
    padded = pp.microbatch(x, 2, n_replicas=2, pad=True)
    assert padded.shape == (2, 2, 2, 2)
    flat = padded.reshape(8, 2)
    assert torch.equal(flat[:6], x) and not flat[6:].any()
    assert pp.microbatch(x, 3, n_replicas=1).shape == (3, 2, 2)
    ok2 = pp.microbatch(torch.arange(16.0).reshape(8, 2), 2, n_replicas=2)
    assert ok2.shape == (2, 2, 2, 2)
    assert torch.equal(ok2[1].reshape(4, 2),
                       torch.arange(16.0).reshape(8, 2)[4:])


def test_bubble_formulas_match_reference():
    for m, s in itertools.product([1, 2, 4, 8, 32], [1, 2, 3, 4, 8]):
        assert pp.bubble_fraction(m, s) == ref_pp.bubble_fraction(m, s)
        assert pp.steady_bubble_fraction(m, s) == \
            ref_pp.steady_bubble_fraction(m, s)


def test_pipeline_throughput_rel_tradeoff():
    """The reference's co-planner rule, and the same numbers."""
    m = 8
    thr_4x2 = planner.pipeline_throughput_rel([25, 25, 25, 25], 2, m)
    thr_8x1 = planner.pipeline_throughput_rel([40, 10, 10, 10, 10, 10,
                                               5, 15], 1, m)
    assert thr_4x2 > thr_8x1
    thr_8x1_bal = planner.pipeline_throughput_rel([12.5] * 8, 1, m)
    assert thr_4x2 > thr_8x1_bal > thr_8x1
    assert planner.pipeline_throughput_rel([12.5] * 8, 1, 64) > \
        planner.pipeline_throughput_rel([12.5] * 8, 1, 4)
    for costs, r, mm in [([25] * 4, 2, 8), ([40, 10, 5], 1, 3), ([1.0], 4, 1)]:
        assert planner.pipeline_throughput_rel(costs, r, mm) == \
            ref_planner.pipeline_throughput_rel(costs, r, mm)


def test_plan_request_validation_and_unported_requests():
    """PlanRequest keeps the reference's validation; the co-plan and the
    measured model (no cache active: a cold one) plan as the reference's
    (tests/test_torch_tuning.py holds every other case)."""
    for kw in ({"n_stages": 2, "store_dtype": "bogus"}, {},
               {"n_stages": 2, "n_devices": 4}):
        with pytest.raises(ValueError) as got:
            planner.PlanRequest(**kw)
        with pytest.raises(ValueError) as want:
            ref_planner.PlanRequest(**kw)
        assert str(got.value) == str(want.value)
    ref_cfg, ref_params, cfg, params = _weights("mobilenet_v1")
    got = planner.plan(cfg, params, planner.PlanRequest(n_devices=4))
    want = ref_planner.plan(ref_cfg, ref_params,
                            ref_planner.PlanRequest(n_devices=4))
    assert got["candidates"] == want["candidates"]
    assert (got.n_stages, got.n_replicas) == (want["n_stages"],
                                              want["n_replicas"])
    _assert_same_plan(got.plan, want["plan"])
    with pytest.warns(UserWarning, match="cold-cache"):
        got = planner.plan(cfg, params, planner.PlanRequest(
            n_stages=2, model="measured"))
    with pytest.warns(UserWarning, match="cold-cache"):
        want = ref_planner.plan(ref_cfg, ref_params, ref_planner.PlanRequest(
            n_stages=2, model="measured"))
    _assert_same_plan(got, want)
    assert got["measured_coverage"] == want["measured_coverage"]
    with pytest.raises(ValueError, match="unknown cost model"):
        planner.cnn_node_costs(cfg, params, model="bogus")


@pytest.mark.parametrize("arch", ARCHS)
def test_op_costs_match_reference(arch):
    """Every conv / fc node's OpCost of both models at several split
    counts, and every node's weight bytes at every store dtype."""
    from repro.core.fusion import conv_part as ref_conv_part
    from repro_torch.core.fusion import conv_part
    from repro_torch.models.layers import SparseWeight
    ref_cfg, ref_params, cfg, params = _weights(arch)
    n_ops = 0
    for node, rnode in zip(fused_graph_for(arch).nodes,
                           ref_fused_graph_for(arch).nodes):
        for sd in STORE_DTYPES:
            assert costmodel.node_weight_bytes(node, params, sd) == \
                ref_costmodel.node_weight_bytes(rnode, ref_params, sd)
        if node.kind not in ("conv", "fc", "avgpool_fc", "dw_pw"):
            continue
        w = params[conv_part(node).name]["w"]
        rw = ref_params[ref_conv_part(rnode).name]["w"]
        hw = node.conv_out_hw
        if node.kind == "dw_pw":
            pair = (costmodel.op_cost_fused_dw_pw(
                node.name, node.k, node.cin, node.cout, hw, hw),
                ref_costmodel.op_cost_fused_dw_pw(
                    node.name, node.k, node.cin, node.cout, hw, hw))
        elif isinstance(w, SparseWeight) and node.kind == "conv":
            pair = (costmodel.op_cost_conv_sparse(node.name, w, node.k,
                                                  node.cin, hw, hw),
                    ref_costmodel.op_cost_conv_sparse(
                        node.name, rw, node.k, node.cin, hw, hw))
        elif isinstance(w, SparseWeight):
            pair = (costmodel.op_cost_from_sparse(node.name, w, 1, 1),
                    ref_costmodel.op_cost_from_sparse(node.name, rw, 1, 1))
        else:
            units = max(node.k * node.k * node.cin // 8, 1)
            pair = (costmodel.op_cost_dense(node.name, units, node.cout,
                                            hw, hw),
                    ref_costmodel.op_cost_dense(node.name, units, node.cout,
                                                hw, hw))
        got, want = pair
        for splits in (1, 2, 3, 7, 64):
            for model in ("aware", "naive"):
                assert got.cycles(splits, model) == \
                    want.cycles(splits, model), (node.name, splits, model)
            assert got.resource(splits) == want.resource(splits)
        n_ops += 1
    assert n_ops > 0
