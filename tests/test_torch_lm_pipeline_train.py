"""The stage-pipelined LM train step (HPIPE's layer pipeline applied to
training) against the JAX reference on the CPU: the per-layer FLOP
counts the planner balances, ``plan_lm_stages`` at S 1-8, the re-packing
of the layer stack into stages, the pipelined step at S 1 against the
reference's on a one-device mesh, and the port's pipelined step at S 2
and 4 (and the same microbatches through the stages in order, without
the pipeline) bit for bit its S 1.

Bars: FLOP counts, plans and stacks are equal; against the reference's
jitted step the loss within 1e-4 relative, the global norm within 2e-3
relative (the gradients' f32 sums in other orders, and the reference's
flash twin rounds p to bf16), the params after the default
``AdamWConfig``'s first update (lr 3e-6) within 1 bf16 ulp plus 2 lr:
the first update moves each element by lr times the sign of its
gradient, so an element whose tiny gradient the two packages sum to
opposite signs parts by 2 lr (tests/test_torch_optim.py holds the update
itself within 1 ulp fed the same gradients); across stage counts and
executors the loss and every gradient bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_lm_ref import model, one_torch_thread  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import ShapeConfig as RefShapeConfig  # noqa: E402
from repro.core import costmodel as ref_cost  # noqa: E402
from repro.core import pipeline as ref_pp  # noqa: E402
from repro.core import planner as ref_planner  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import costmodel, planner  # noqa: E402
from repro_torch.core import pipeline as pp  # noqa: E402
from repro_torch.core import pytree  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import device_slots, make_stage_mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

LMS = ["smollm-360m", "qwen3-32b", "mistral-nemo-12b", "granite-20b",
       "granite-moe-3b-a800m", "moonshot-v1-16b-a3b",
       "llava-next-mistral-7b", "rwkv6-1.6b", "zamba2-7b",
       "whisper-large-v3"]
LOSS_RTOL = 1e-4
GNORM_RTOL = 2e-3


@pytest.mark.parametrize("arch", LMS)
def test_lm_flops_equal(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for seq, batch in ((4096, 4), (1024, 1)):
        for l in range(cfg.n_layers):
            assert costmodel.lm_block_flops(cfg, seq, batch, l) == \
                ref_cost.lm_block_flops(rcfg, seq, batch, l)
            assert costmodel.lm_decode_flops(cfg, seq, batch, l) == \
                ref_cost.lm_decode_flops(rcfg, seq, batch, l)
        assert costmodel._logits_flops(cfg, seq * batch) == \
            ref_cost._logits_flops(rcfg, seq * batch)


@pytest.mark.parametrize("arch", LMS)
def test_plan_lm_stages_equal(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for s in range(1, 9):
        got = planner.plan_lm_stages(cfg, 4096, 4, s)
        want = ref_planner.plan_lm_stages(rcfg, 4096, 4, s)
        assert set(got) == set(want)
        assert got["stage_of"] == want["stage_of"]
        np.testing.assert_array_equal(got["stage_cost"], want["stage_cost"])
        np.testing.assert_array_equal(got["layer_flops"],
                                      want["layer_flops"])
        assert got["imbalance"] == want["imbalance"]


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def test_stack_stages_equal():
    rcfg, cfg, rparams, params = model("zamba2-7b")
    stage_of = [0, 1, 1, 1]
    got, mask = pp.stack_stages(params["blocks"], stage_of, 2)
    want, rmask = ref_pp.stack_stages(rparams["blocks"], stage_of, 2)
    np.testing.assert_array_equal(mask, np.asarray(rmask))
    rflat = {"|".join(str(p) for p in path): np.asarray(
        jnp.asarray(leaf).astype(jnp.float32) if leaf.dtype == jnp.bfloat16
        else leaf) for path, leaf in jax.tree_util.tree_leaves_with_path(
            want)}
    flat = dict(pytree.keyed_leaves(got))
    assert set(flat) == set(rflat)
    for key, t in flat.items():
        np.testing.assert_array_equal(_np(t), rflat[key], err_msg=key)
    flags, _ = pp.stack_stages({"f": [0, 1, 0, 2]}, stage_of, 2)
    assert flags["f"] == [[0, 0, 0], [1, 0, 2]]
    for fn in (pp.stack_stages, ref_pp.stack_stages):
        with pytest.raises(ValueError, match="own no layers"):
            fn(params["blocks"] if fn is pp.stack_stages
               else rparams["blocks"], [0, 0, 2, 2], 3)


def _batch(cfg, b, t, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, t), np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, t), np.int32)}


def bf16_ulp(w):
    a = np.abs(np.asarray(w, np.float64))
    return np.where(a > 0, 2.0 ** (np.floor(np.log2(np.where(a > 0, a, 1)))
                                   - 7), 2.0 ** -133)


@pytest.mark.parametrize("arch", ["smollm-360m", "zamba2-7b"])
def test_pipeline_step_s1_matches_reference(arch):
    rcfg, cfg, rparams, params = model(arch)
    b, t, m = 4, 16, 2
    batch = _batch(cfg, b, t)
    opt = {}                  # AdamWConfig(): the steps' default
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("pod", "data"))
    rstep, rrestr, rplan = ref_steps.make_pipeline_train_step(
        rcfg, mesh, RefShapeConfig("t", "train", t, b),
        ref_adamw.AdamWConfig(**opt), n_microbatches=m)
    rsp, rmask = rrestr(rparams)
    with jax.set_mesh(mesh):
        rsp2, _, rmet = jax.jit(rstep)(rsp, rmask, ref_adamw.init(rsp),
                                       {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    step, restr, plan = steps.make_pipeline_train_step(
        cfg, None, ShapeConfig("t", "train", t, b), adamw.AdamWConfig(**opt),
        n_stages=1, n_microbatches=m)
    assert plan["stage_of"] == rplan["stage_of"]
    sp, mask = restr(params)
    sp2, st, met = step(sp, mask, adamw.init(sp), batch)
    assert int(st.step) == 1
    assert abs(float(met["loss"]) - float(rmet["loss"])) <= \
        LOSS_RTOL * abs(float(rmet["loss"]))
    assert abs(float(met["grad_norm"]) - float(rmet["grad_norm"])) <= \
        GNORM_RTOL * float(rmet["grad_norm"])
    rflat = {"|".join(str(p) for p in path): leaf for path, leaf in
             jax.tree_util.tree_leaves_with_path(rsp2)
             if "_attn_flag" not in str(path)}
    flat = dict(pytree.keyed_leaves(sp2))
    assert set(flat) == set(rflat)
    for key, got in flat.items():
        want = np.asarray(jnp.asarray(rflat[key]).astype(jnp.float32)) \
            if got.is_floating_point() else np.asarray(rflat[key])
        if not got.is_floating_point():
            np.testing.assert_array_equal(got.numpy(), want)
            continue
        bar = bf16_ulp(want) + 2 * float(met["lr"])
        assert (np.abs(_np(got) - want) <= bar).all(), key


def _unstaged_grads(cfg, grads, stage_of, n_stages):
    """{key: gradient} with each staged leaf back in layer order."""
    per_stage = [[l for l in range(cfg.n_layers) if stage_of[l] == s]
                 for s in range(n_stages)]
    out = {}
    for key, g in pytree.keyed_leaves(grads):
        if g is None:
            continue
        if key.startswith("['staged']"):
            g = torch.stack([g[s, i] for s in range(n_stages)
                             for i in range(len(per_stage[s]))])
        out[key] = g
    return out


@pytest.mark.parametrize("arch", ["smollm-360m", "zamba2-7b"])
def test_pipeline_stages_bitwise(arch):
    """S 2 and 4 (and each stage count's sequential executor) give the
    loss and every gradient of S 1 bit for bit."""
    _, cfg, _, params = model(arch)
    b, t = 4, 16
    batch = _batch(cfg, b, t, seed=1)
    shape = ShapeConfig("t", "train", t, b)
    base = None
    for s in (1, 2, 4):
        if s > cfg.n_layers:
            continue
        step, restr, plan = steps.make_pipeline_train_step(
            cfg, None, shape, n_stages=s, n_microbatches=4)
        assert max(plan["stage_of"]) == s - 1
        sp, mask = restr(params)
        # at S 1 the two executors run the same schedule
        for executor in ((pp.pipeline_apply_gspmd,) if s == 1 else
                         (pp.pipeline_apply_gspmd, pp.sequential_apply)):
            (loss, _), g = step.value_and_grad(sp, mask, batch,
                                               executor=executor)
            got = (float(loss), _unstaged_grads(cfg, g, plan["stage_of"], s))
            if base is None:
                base = got
                continue
            assert got[0] == base[0], (s, executor)
            assert set(got[1]) == set(base[1])
            for key, gk in got[1].items():
                assert torch.equal(gk, base[1][key]), (s, executor, key)


def test_pipeline_mesh_sets_the_stages():
    """As the reference: S is the size of the mesh's stage axis (a mesh
    of slots), the plan the mesh-less one at that S; a mesh without the
    axis, or an n_stages that disagrees with it, is refused."""
    cfg = get_config("smollm-360m")
    shape = ShapeConfig("t", "train", 16, 4)
    mesh = make_stage_mesh(4, stage_axis="pod",
                           devices=device_slots(4, "cpu"))
    _, _, plan = steps.make_pipeline_train_step(cfg, mesh, shape)
    _, _, want = steps.make_pipeline_train_step(cfg, None, shape, n_stages=4)
    assert plan["stage_of"] == want["stage_of"] and max(plan["stage_of"]) == 3
    with pytest.raises(ValueError, match="no 'pod' axis"):
        steps.make_pipeline_train_step(cfg, make_stage_mesh(
            1, devices=device_slots(1, "cpu")), shape)
    with pytest.raises(ValueError, match="give n_stages"):
        steps.make_pipeline_train_step(cfg, None, shape)
    x = torch.arange(6.0).reshape(3, 1, 2)
    one = make_stage_mesh(1, stage_axis="pod", devices=device_slots(1, "cpu"))
    got = pp.pipeline_apply_gspmd(lambda p, m, h: h * 2, {},
                                  np.ones((1, 1), bool), x, n_stages=1,
                                  mesh=one)
    assert torch.equal(got, x * 2)


def test_pipeline_block_fn_flag_is_host_side():
    """zamba2's shared block runs where the host-side flag is true and
    nowhere else: the block fn over the layers with the flags is the
    forward's hidden state."""
    _, cfg, _, params = model("zamba2-7b")
    toks = torch.from_numpy(_batch(cfg, 2, 16)["tokens"])
    want, _ = lm.forward(cfg, params, toks, logits_mode="hidden")
    h = lm._embed(cfg, params, toks)
    fn = lm.make_pipeline_block_fn(cfg, params,
                                   torch.arange(16)[None])
    for l, flag in enumerate(lm.attn_flags(cfg)):
        p = dict(lm._layer(params["blocks"], l), _attn_flag=int(flag))
        h = fn(p, h)
    assert torch.equal(h, want)
