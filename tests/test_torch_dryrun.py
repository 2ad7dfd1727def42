"""The port's analytic dry run against the JAX reference on the CPU.

- ``costmodel.step_flops_global``, ``_param_bytes_local``,
  ``step_bytes_per_device``, ``hbm_estimate_per_device`` and
  ``dryrun.model_flops_for`` equal the reference's to 1e-12 relative
  over every applicable (arch, shape) cell on both production meshes,
  ``pure_dp`` both ways;
- ``dryrun.roofline`` equals the reference's formula with the
  reference module's constants patched to the port's (H100: bf16 peak,
  HBM rate, one NVLink direction); without collective bytes its
  ``dominant`` is chosen over the compute and memory terms;
- ``python -m repro_torch.launch.dryrun --all`` (``main``) on the CPU:
  every cell ``ok``, its terms the reference's formulas, no collective
  bytes;
- the CNN pipeline cell on CPU slots: the placement accounting of
  ``stage_param_shardings`` equals the reference's on the same plan.

Importing ``repro.launch.dryrun`` appends a 512-device ``XLA_FLAGS`` to
the environment (``src/repro/launch/dryrun.py:1-4``); the fixture starts
JAX first and restores the variable, so no later subprocess inherits
it."""
import json
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import costmodel as ref_cm  # noqa: E402
from repro.core.fusion import fused_graph_for as ref_fused  # noqa: E402
from repro.launch import mesh as ref_mesh  # noqa: E402
from repro.launch import shardings as ref_sh  # noqa: E402
from repro.models import cnn as ref_cnn  # noqa: E402
from repro_torch.configs import SHAPES, all_configs, applicable  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import costmodel as cm  # noqa: E402
from repro_torch.core.fusion import fused_graph_for  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import shardings as sh  # noqa: E402

RTOL = 1e-12
LMS = sorted(n for n, c in all_configs().items() if c.family != "cnn")
CELLS = [(a, s) for a in LMS for s in SHAPES
         if applicable(get_config(a), SHAPES[s])]
# (n_chips, n_model_shards) of the 16 x 16 and 2 x 16 x 16 meshes
MESHES = ((256, 16), (512, 16))


@pytest.fixture(scope="module")
def ref_dryrun():
    jax.devices()                     # the device count is fixed from here
    prev = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as mod
    finally:
        if prev is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = prev
    return mod


def _close(a, b):
    return a == b or abs(a - b) <= RTOL * max(abs(a), abs(b))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_costmodel_matches_reference(arch, shape, ref_dryrun):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    sc, rsc = SHAPES[shape], REF_SHAPES[shape]
    assert _close(cm.step_flops_global(cfg, sc),
                  ref_cm.step_flops_global(rcfg, rsc))
    assert _close(dryrun.model_flops_for(cfg, sc),
                  ref_dryrun.model_flops_for(rcfg, rsc))
    for n_chips, n_model in MESHES:
        for pure_dp in (False, True):
            kw = dict(n_chips=n_chips, n_model_shards=n_model,
                      pure_dp=pure_dp)
            assert _close(cm._param_bytes_local(cfg, n_model, pure_dp),
                          ref_cm._param_bytes_local(rcfg, n_model, pure_dp))
            assert _close(cm.step_bytes_per_device(cfg, sc, **kw),
                          ref_cm.step_bytes_per_device(rcfg, rsc, **kw))
            assert _close(cm.hbm_estimate_per_device(cfg, sc, **kw),
                          ref_cm.hbm_estimate_per_device(rcfg, rsc, **kw))


_SAME_KEYS = ("t_compute_s", "t_memory_s", "dominant", "bound_s",
              "model_flops", "useful_flops_frac", "roofline_frac",
              "mfu_bound")


def test_roofline_is_the_references_formula(ref_dryrun, monkeypatch):
    monkeypatch.setattr(ref_mesh, "PEAK_FLOPS_BF16", M.PEAK_FLOPS_BF16)
    monkeypatch.setattr(ref_mesh, "HBM_BW", M.HBM_BW)
    monkeypatch.setattr(ref_mesh, "ICI_BW", M.NVLINK_BW)
    rng = np.random.default_rng(0)
    for _ in range(50):
        cost = {"flops": float(rng.uniform(0, 1e16)),
                "bytes accessed": float(rng.uniform(0, 1e13))}
        coll = {"total_bytes": float(rng.uniform(0, 1e12))}
        n, mf = int(rng.integers(1, 513)), float(rng.uniform(0, 1e18))
        got = dryrun.roofline(cost, coll, n, model_flops=mf)
        want = ref_dryrun.roofline(cost, coll, n, model_flops=mf)
        for k in _SAME_KEYS + ("t_collective_s",):
            assert got[k] == want[k], k
        assert got["flops_global"] == want["hlo_flops_global"]
        # no collective bytes: the reference's terms at zero collectives
        got = dryrun.roofline(cost, None, n, model_flops=mf)
        want = ref_dryrun.roofline(cost, {"total_bytes": 0.0}, n,
                                   model_flops=mf)
        assert got["t_collective_s"] is None
        assert got["dominant"] in ("compute", "memory")
        for k in _SAME_KEYS:
            assert got[k] == want[k], k


@pytest.fixture(scope="module")
def all_cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "cells.json"
    assert dryrun.main(["--all", "--out", str(out)]) == 0
    return json.loads(out.read_text())


def test_main_all_runs_every_cell(all_cells, ref_dryrun):
    assert len(all_cells) == len(LMS) * len(SHAPES) * 2
    ok = [r for r in all_cells if r["status"] == "ok"]
    assert len(ok) == len(CELLS) * 2
    assert {r["status"] for r in all_cells} == {"ok", "skipped"}
    for r in ok:
        cfg, rcfg = get_config(r["arch"]), ref_get_config(r["arch"])
        shape = SHAPES[r["shape"]]
        n_chips = 512 if r["mesh"] == "2x16x16" else 256
        kw = dict(n_chips=n_chips, n_model_shards=16,
                  pure_dp=sh.use_pure_dp(cfg))
        assert r["n_chips"] == n_chips and r["collectives"] is None
        assert r["hbm_est_per_device"] == int(ref_cm.hbm_estimate_per_device(
            rcfg, REF_SHAPES[r["shape"]], **kw))
        rf = r["roofline"]
        assert _close(rf["t_compute_s"], ref_cm.step_flops_global(
            rcfg, REF_SHAPES[r["shape"]]) / n_chips / M.PEAK_FLOPS_BF16)
        assert _close(rf["t_memory_s"], ref_cm.step_bytes_per_device(
            rcfg, REF_SHAPES[r["shape"]], **kw) / M.HBM_BW)
        assert rf["dominant"] == max(("compute", rf["t_compute_s"]),
                                     ("memory", rf["t_memory_s"]),
                                     key=lambda kv: kv[1])[0]
        b = r["per_device_bytes"]
        assert b["params"] > 0 and b["inputs"] > 0
        assert ("opt_state" in b) == (shape.kind == "train")


def test_pipelined_cell_stages_the_blocks():
    flat = dryrun.run_cell("qwen3-32b", "train_4k", multi_pod=True,
                           verbose=False)
    staged = dryrun.run_cell("qwen3-32b", "train_4k", multi_pod=True,
                             pipeline=True, verbose=False)
    assert staged["status"] == "ok" and staged["pipeline"]
    # the blocks split over the 2 pods (padded to the longer stage)
    assert staged["per_device_bytes"]["params"] < \
        flat["per_device_bytes"]["params"]


def test_cnn_pipeline_cell_places_rows():
    res = dryrun.run_cnn_pipeline_cell(
        "resnet50", n_stages=4, n_microbatches=2, batch=4, image_size=32,
        device="cpu", verbose=False)
    assert res["status"] == "ok" and res["collectives"] is None
    assert res["param_bytes_placed_per_device"] < \
        res["param_bytes_replicated_per_device"]
    assert sum(res["stage_param_bytes"]) == \
        res["param_bytes_replicated_per_device"]


_CELL = dict(n_stages=4, n_microbatches=2, batch=4, image_size=32,
             device="cpu", verbose=False)


def _cell_keys(res):
    return {k: v for k, v in res.items() if k != "setup_s"}


@pytest.fixture(scope="module")
def analytic_cell():
    return dryrun.run_cnn_pipeline_cell("mobilenet_v1", **_CELL)


@pytest.mark.parametrize("cache", ["missing", "empty"])
def test_cnn_cell_cold_cache_is_the_analytic_cell(cache, analytic_cell,
                                                  tmp_path):
    """A missing cache file or an empty cache: the cell equals the
    analytic cell key for key (the plan bit for bit), and the cache
    installed before the cell is back after it."""
    from repro_torch.core import tuning
    cold = (str(tmp_path / "missing.json") if cache == "missing"
            else tuning.TuningCache())
    before = tuning.TuningCache()
    with tuning.set_tuning_cache(before), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = dryrun.run_cnn_pipeline_cell("mobilenet_v1",
                                           tuning_cache=cold, **_CELL)
        assert tuning.current_tuning_cache() is before
    assert _cell_keys(got) == _cell_keys(analytic_cell)
    assert not (tmp_path / "missing.json").exists()


def test_cnn_cell_plans_from_a_measured_cache(analytic_cell):
    """A hand-built cache (the analytic seed, each node's time scaled by a
    node-dependent factor): the cell's stage costs and cut are
    ``planner.plan(model="measured")``'s on the same cache, not the
    analytic ones."""
    from repro_torch.core import planner, tuning
    from repro_torch.launch.serve import _init_native
    cfg = get_config("mobilenet_v1")
    params = _init_native(cfg, 0)
    with tuning.device_scope("cpu"):
        seed = tuning.seed_from_analytic(cfg, params, (1, 64, 64, 3))
        cache = tuning.TuningCache(
            {k: {"time_us": v["time_us"] * (1.0 + 3.0 * (i % 7 == 0))}
             for i, (k, v) in enumerate(sorted(seed.entries.items()))},
            dict(seed.meta))
        want = planner.plan(cfg, params, planner.PlanRequest(
            n_stages=4, model="measured", tuning_cache=cache))
    got = dryrun.run_cnn_pipeline_cell("mobilenet_v1", tuning_cache=cache,
                                       **_CELL)
    assert want["measured_coverage"]["coverage"] == 1.0
    assert got["stage_cost_cycles"] == [float(c) for c in want["stage_cost"]]
    assert got["imbalance"] == want["imbalance"]
    assert got["stage_cost_cycles"] != analytic_cell["stage_cost_cycles"]


def test_main_calibrates_and_plans_from_the_cache(tmp_path):
    """``main --calibrate --tuning-cache PATH``: every fused node timed on
    the CPU's plain path and written to PATH, and the cell planned from
    what was written."""
    from repro_torch.core import planner, tuning
    from repro_torch.launch.serve import _init_native
    path, out = tmp_path / "c.json", tmp_path / "cell.json"
    assert dryrun.main(["--arch", "mobilenet_v1", "--pipeline-cnn",
                        "--device", "cpu", "--image-size", "32", "--batch",
                        "4", "--microbatches", "2", "--stages", "3",
                        "--calibrate", "--tuning-cache", str(path),
                        "--out", str(out)]) == 0
    cache = tuning.TuningCache.load(str(path))
    assert cache.meta["device"] == "cpu:plain" and len(cache) > 0
    cfg = get_config("mobilenet_v1")
    with tuning.device_scope("cpu"):
        want = planner.plan(cfg, _init_native(cfg, 0), planner.PlanRequest(
            n_stages=3, model="measured", tuning_cache=cache))
    assert want["measured_coverage"]["coverage"] == 1.0
    (res,) = json.loads(out.read_text())
    assert res["stage_cost_cycles"] == [float(c) for c in want["stage_cost"]]


def test_stage_param_shardings_match_reference():
    """The placement accounting on one plan: stage parts, stage bytes,
    replicated and placed bytes (structure only, so the reference's own
    weights price the port's cut)."""
    from repro_torch.core import planner
    from repro_torch.launch.serve import _init_native
    cfg, rcfg = get_config("resnet50"), ref_get_config("resnet50")
    params = _init_native(cfg, 0)
    rparams = jax.eval_shape(lambda k: ref_cnn.init_cnn(rcfg, k),
                             jax.random.PRNGKey(0))
    for s in (2, 4):
        plan = planner.plan(cfg, params, planner.PlanRequest(n_stages=s))
        mesh = M.make_stage_mesh(s, devices=M.device_slots(s, "cpu"))
        for store in ("native", "int8"):
            got = sh.stage_param_shardings(fused_graph_for("resnet50"), plan,
                                           mesh, params=params,
                                           store_dtype=store)
            want = ref_sh.stage_param_shardings(
                ref_fused("resnet50"), {"stage_of": plan["stage_of"]},
                AbstractMesh((s,), ("stage",)),
                params=rparams, store_dtype=store)
            assert got["buffer"] == tuple(want["buffer"].spec)
            for k in ("stage_parts", "stage_param_bytes",
                      "replicated_bytes_per_device",
                      "placed_bytes_per_device", "placement_ratio"):
                assert got[k] == want[k], (s, store, k)
    with pytest.raises(ValueError, match="slots for 4 stages"):
        sh.stage_param_shardings(fused_graph_for("resnet50"), plan,
                                 M.make_stage_mesh(
                                     2, devices=M.device_slots(2, "cpu")))
