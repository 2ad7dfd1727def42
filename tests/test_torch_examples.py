"""The port's examples (``examples/torch_*.py``) and the entry points'
surface they use, on the CPU, against the JAX reference.

- ``torch_sparse_resnet_inference``: on the reference's ResNet-50 weights
  (carried across with ``params_from_numpy``) the plan equals the
  reference's ``planner.plan_cnn`` (bottlenecks, resources, the five
  slowest nodes' cycles and splits), and the 64 px batch-2 forward is
  within 1e-3 of max |logit| of the reference's XLA forward, top-1 equal
  (the bar of tests/test_torch_cnn.py);
- ``torch_moe_expert_parallel``: ``plan_lm_stages`` equal to the
  reference's for both archs; the LM examples run a few steps;
- ``torch_resilient_training``: at its arguments, two restarts, and the
  final state and each step's last loss bit for bit a run without
  failures;
- the LM examples call ``train`` / ``serve`` with the reference
  examples' arguments;
- ``serve("arch", **kw)`` warns and serves as ``serve_lm``;
  ``serve(ServeConfig, **kw)`` raises as the reference's; ``serve.main``'s
  ``--placed`` / ``--replicated-params`` / ``--reduced`` flags.
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_lm_ref import numpy_tree, one_torch_thread  # noqa: E402,F401
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import planner as ref_planner  # noqa: E402
from repro.data.pipeline import image_batch as ref_image_batch  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import cnn as ref_cnn  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import pytree  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.launch.serve import ServeConfig, serve, serve_lm  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
LOGIT_RTOL = 1e-3


def _example(name: str):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def resnet():
    """(reference cfg, reference params, port params on the CPU)."""
    ref_cfg = ref_get_config("resnet50")
    ref_params = jax.jit(lambda k: ref_cnn.init_cnn(ref_cfg, k))(
        jax.random.PRNGKey(0))
    return ref_cfg, ref_params, cnn.params_from_numpy(
        numpy_tree(ref_params), device="cpu")


def test_sparse_resnet_plan_matches_reference(resnet):
    ref_cfg, ref_params, params = resnet
    got = _example("torch_sparse_resnet_inference").compile_plan(
        get_config("resnet50"), params)
    ops = ref_planner.cnn_op_costs(ref_cfg, ref_params)
    want = ref_planner.plan_cnn(ref_cfg, ref_params, 5000)
    assert got["unbalanced_cycles"] == max(op.cycles(1) for op in ops)
    plan = got["plan"]
    assert plan.bottleneck_cycles == want.bottleneck_cycles
    assert plan.resources == want.resources <= 5000
    assert plan.cycles == want.cycles and plan.splits == want.splits
    slowest = sorted(want.cycles.items(), key=lambda kv: -kv[1])[:5]
    assert got["slowest"] == [(n, c, want.splits[n]) for n, c in slowest]


def test_sparse_resnet_forward_matches_reference_xla(resnet):
    ref_cfg, ref_params, params = resnet
    got = _example("torch_sparse_resnet_inference").serve_batch(
        get_config("resnet50"), params, "cpu")
    images = ref_image_batch(0, batch=2, size=64)["images"]
    np.testing.assert_array_equal(got["images"], images)
    with ref_ops.config(impl="xla"):
        ref = np.asarray(jax.jit(
            lambda p, x: ref_cnn.cnn_forward(ref_cfg, p, x))(
                ref_params, images), np.float32)
    logits = got["logits"].numpy()
    assert logits.shape == (2, 1000) and got["finite"]
    scale = np.abs(ref).max()
    assert np.abs(logits - ref).max() <= LOGIT_RTOL * scale, \
        (np.abs(logits - ref).max(), scale)
    np.testing.assert_array_equal(got["top1"], ref.argmax(-1))


def test_sparse_resnet_main_on_the_cpu(capsys):
    _example("torch_sparse_resnet_inference").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "balanced bottleneck" in out and "finite: True" in out


def test_moe_plans_match_reference():
    got = _example("torch_moe_expert_parallel").plans()
    assert list(got) == ["granite-moe-3b-a800m", "zamba2-7b"]
    for arch, row in got.items():
        want = ref_planner.plan_lm_stages(ref_get_config(arch), 4096, 16,
                                          n_stages=4)
        assert row["plan"]["stage_of"] == want["stage_of"]
        np.testing.assert_array_equal(row["plan"]["stage_cost"],
                                      want["stage_cost"])
        np.testing.assert_array_equal(row["plan"]["layer_flops"],
                                      want["layer_flops"])
        assert row["plan"]["imbalance"] == want["imbalance"]
        assert row["cuts"] == [want["stage_of"].index(s) for s in (1, 2, 3)]


def test_lm_examples_run_on_the_cpu():
    with pytest.warns(DeprecationWarning, match=r"serve\(arch"):
        qs = _example("torch_quickstart").run(steps=3, device="cpu")
    assert len(qs["losses"]) == 3
    assert all(math.isfinite(l) for _, l in qs["losses"])
    assert qs["tokens"].shape == (2, 8)
    moe = _example("torch_moe_expert_parallel").run(steps=3, device="cpu")
    for arch in ("granite-moe-3b-a800m", "zamba2-7b"):
        assert len(moe[arch]["losses"]) == 3
        assert all(math.isfinite(l) for l in moe[arch]["losses"])


def _record(monkeypatch, module, results: dict) -> list:
    """Replace each ``module.<name>`` of ``results`` by a stub that
    records its call as ``(name, args, kwargs)`` and returns
    ``results[name]``; the list of calls."""
    calls = []
    for name, result in results.items():
        def stub(*args, _name=name, _result=result, **kw):
            calls.append((_name, args, kw))
            return _result
        monkeypatch.setattr(module, name, stub)
    return calls


# what the stubs return: enough for each example's prints and asserts
_STUB = {"train": {"losses": [(i, 2.0 - i / 100) for i in range(20)],
                   "restarts": 2, "stragglers": [], "state": None},
         "serve": {"tokens": np.zeros((2, 8), np.int32)}}


@pytest.mark.parametrize("name", ["quickstart", "resilient_training",
                                  "moe_expert_parallel"])
def test_lm_example_calls_match_the_reference(name, monkeypatch):
    """Each LM example calls ``train`` / ``serve`` with the reference
    example's arguments, the device aside (and the temporary checkpoint
    directory's name); nothing is run."""
    monkeypatch.setattr("sys.argv", [f"{name}.py"])
    ref = _example(name)
    want = _record(monkeypatch, ref, {k: v for k, v in _STUB.items()
                                      if hasattr(ref, k)})
    ref.main()
    port = _example(f"torch_{name}")
    got = _record(monkeypatch, port, {k: v for k, v in _STUB.items()
                                      if hasattr(port, k)})
    port.run(device="cpu")
    assert want and len(got) == len(want)
    for (g_name, g_args, g_kw), (w_name, w_args, w_kw) in zip(got, want):
        assert g_kw.pop("device") == "cpu"
        if "ckpt_dir" in w_kw:
            assert isinstance(g_kw.pop("ckpt_dir"), str)
            assert isinstance(w_kw.pop("ckpt_dir"), str)
        assert (g_name, g_args, g_kw) == (w_name, w_args, w_kw)


def test_resilient_training_restarts_bit_for_bit(monkeypatch, tmp_path):
    """The resilient example's ``train()`` arguments at 12 steps, run with
    a checkpoint every 3 steps and failures at 4 and 9, and without
    failures."""
    from repro_torch.launch.train import train
    ex = _example("torch_resilient_training")
    calls = _record(monkeypatch, ex, {"train": _STUB["train"]})
    ex.run("cpu", steps=12)
    ((_, args, kw),) = calls
    assert kw["steps"] == 12 and kw["device"] == "cpu"
    kw.update(ckpt_every=3)
    faulty = train(*args, **dict(kw, ckpt_dir=str(tmp_path / "faulty"),
                                 fail_at=(4, 9)))
    clean = train(*args, **dict(kw, ckpt_dir=str(tmp_path / "clean"),
                                fail_at=()))
    assert faulty["restarts"] == 2 and clean["restarts"] == 0
    # checkpoints after steps 0, 3, 6, 9: the failure at 4 resumes at 4,
    # the one at 9 (before step 9 ran) replays 7 and 8
    assert [i for i, _ in faulty["losses"]] == \
        list(range(9)) + [7, 8] + list(range(9, 12))
    assert [i for i, _ in clean["losses"]] == list(range(12))
    last = dict(faulty["losses"])
    assert last == dict(clean["losses"])
    want = dict(pytree.keyed_leaves(clean["state"]))
    n = 0
    for key, t in pytree.keyed_leaves(faulty["state"]):
        assert t.dtype == want[key].dtype and torch.equal(t, want[key]), key
        n += 1
    assert n == len(want) > 0


_LM_KW = dict(batch=2, prompt_len=8, gen_tokens=8, max_seq=32,
              device="cpu", verbose=False)


def test_serve_arch_string_is_a_deprecated_serve_lm():
    with pytest.warns(DeprecationWarning, match=r"serve\(arch, \.\.\.\) is "
                      r"deprecated; LM serving moved to serve_lm"):
        got = serve("smollm-360m", **_LM_KW)
    want = serve_lm("smollm-360m", **_LM_KW)
    assert got["tokens"].shape == (2, 8)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    # the reference's keyword, read by neither
    np.testing.assert_array_equal(
        serve_lm("smollm-360m", greedy=False, **_LM_KW)["tokens"],
        want["tokens"])


def test_serve_config_with_kwargs_raises_as_the_reference():
    with pytest.raises(TypeError) as got:
        serve(ServeConfig("resnet50", device="cpu"), batch=2, x=1)
    with pytest.raises(TypeError) as want:
        ref_serve.serve(ref_serve.ServeConfig("resnet50"), batch=2, x=1)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("flags,placed", [([], None), (["--placed"], True),
                                          (["--replicated-params"], False)])
def test_main_placement_flags_reach_the_config(flags, placed, monkeypatch):
    seen = []
    monkeypatch.setattr(port_serve, "serve", seen.append)
    port_serve.main(["--arch", "resnet50", "--device", "cpu", *flags])
    (cfg,) = seen
    assert isinstance(cfg, ServeConfig) and cfg.placed is placed
    # the reference's parser takes the same flags to the same value
    ref_seen = []
    monkeypatch.setattr(ref_serve, "serve", ref_seen.append)
    ref_serve.main(["--arch", "resnet50", *flags])
    assert ref_seen[0].placed is placed


@pytest.mark.parametrize("flags,use_reduced", [([], True),
                                               (["--reduced"], True),
                                               (["--full-size"], False)])
def test_main_reduced_flag(flags, use_reduced, monkeypatch):
    seen = []
    monkeypatch.setattr(port_serve, "serve_lm",
                        lambda arch, **kw: seen.append(kw))
    port_serve.main(["--arch", "smollm-360m", "--device", "cpu", *flags])
    assert seen[0]["use_reduced"] is use_reduced


@pytest.mark.parametrize("name", ["torch_sparse_resnet_inference",
                                  "torch_quickstart",
                                  "torch_resilient_training",
                                  "torch_moe_expert_parallel"])
def test_examples_run_on_the_card_by_default(name):
    """Without ``--device`` an example asks for the card, and without one
    it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _example(name).main([])
