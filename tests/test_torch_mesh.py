"""The port's mesh tooling against the JAX reference on the CPU.

- the sharding rules: ``steps.abstract_params`` / ``abstract_opt_state``
  / ``input_specs`` (meta trees and ``{key: spec}``) equal the
  reference's (``jax.eval_shape`` trees with their ``PartitionSpec``s on
  a ``jax.sharding.AbstractMesh``) key for key, shape, dtype and spec,
  for every LM config at full width on the 16 x 16 and 2 x 16 x 16
  production meshes, ``pure_dp`` both ways, ``pod_is_dp`` both ways;
  ``batch_axes`` and ``data_spec`` at batches the axes do and do not
  divide;
- the meshes: ``make_stage_mesh``'s shapes and the reference's error
  text, the abstract production and test meshes;
- ``fault.remesh``: bit for bit, and no shard shares storage with the
  donor's;
- the executors on a mesh of CPU slots equal the mesh-less executors bit
  for bit (the even buffer placed, R 1 and 2, per-slot state buffers),
  and refuse bad meshes with the reference's texts;
- the stage-pipelined train step (reduced SmolLM) on a stage mesh of
  slots equals the mesh-less step bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from _torch_lm_ref import one_torch_thread  # noqa: E402,F401
from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import pipeline as ref_pp  # noqa: E402
from repro.launch import mesh as ref_mesh  # noqa: E402
from repro.launch import shardings as ref_sh  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro_torch.configs import SHAPES, applicable, get_config  # noqa: E402
from repro_torch.configs import reduced  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import pipeline as pp  # noqa: E402
from repro_torch.core import pytree  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import shardings as sh  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.runtime.fault import remesh  # noqa: E402

LMS = ["smollm-360m", "qwen3-32b", "mistral-nemo-12b", "granite-20b",
       "granite-moe-3b-a800m", "moonshot-v1-16b-a3b",
       "llava-next-mistral-7b", "rwkv6-1.6b", "zamba2-7b",
       "whisper-large-v3"]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _abstract_mesh(sizes, names):
    try:
        return AbstractMesh(sizes, names)
    except TypeError:                      # jax 0.4.x: ((name, size), ...)
        return AbstractMesh(tuple(zip(names, sizes)))


def _port_mesh(name):
    sizes, names = MESHES[name]
    return M.make_production_mesh(multi_pod=len(sizes) == 3)


def _ref_flat(tree):
    """{key: (shape, dtype name, spec)} of a reference tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    out = {}
    for path, leaf in flat:
        spec = getattr(leaf.sharding, "spec", ())
        out["|".join(str(k) for k in path)] = (
            tuple(leaf.shape), jnp.dtype(leaf.dtype).name, tuple(spec))
    return out


def _port_flat(tree, specs):
    return {key: (tuple(leaf.shape), str(leaf.dtype).split(".")[1],
                  specs[key])
            for key, leaf in pytree.keyed_leaves(tree)}


def _assert_same(got, want, what):
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for key in want:
        g, w = got[key], want[key]
        # a trailing run of None is the same placement as none at all
        gs, ws = list(g[2]), list(w[2])
        while gs and gs[-1] is None:
            gs.pop()
        while ws and ws[-1] is None:
            ws.pop()
        assert (g[:2], gs) == (w[:2], ws), (what, key, g, w)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", LMS)
def test_abstract_trees_and_specs_match_reference(arch, mesh_name):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    mesh, rmesh = _port_mesh(mesh_name), _abstract_mesh(*MESHES[mesh_name])
    assert sh.use_pure_dp(cfg) == ref_sh.use_pure_dp(rcfg)
    for pure_dp in (sh.use_pure_dp(cfg), not sh.use_pure_dp(cfg)):
        params, specs = steps.abstract_params(cfg, mesh, pure_dp=pure_dp)
        assert all(t.is_meta for t in pytree.leaves(params))
        rparams = ref_steps.abstract_params(rcfg, rmesh, pure_dp=pure_dp)
        _assert_same(_port_flat(params, specs), _ref_flat(rparams),
                     f"params pure_dp={pure_dp}")
    params, specs = steps.abstract_params(cfg, mesh)
    rparams = ref_steps.abstract_params(rcfg, rmesh)
    opt, ospecs = steps.abstract_opt_state(params, specs, mesh)
    _assert_same(_port_flat(opt, ospecs),
                 _ref_flat(ref_steps.abstract_opt_state(rparams, rmesh)),
                 "opt_state")
    for sname, shape in SHAPES.items():
        if not applicable(cfg, shape):
            continue
        for pod_is_dp in (True, False):
            inputs, ispecs = steps.input_specs(cfg, shape, mesh,
                                               pod_is_dp=pod_is_dp)
            want = ref_steps.input_specs(rcfg, REF_SHAPES[sname], rmesh,
                                         pod_is_dp=pod_is_dp)
            _assert_same(_port_flat(inputs, ispecs), _ref_flat(want),
                         f"{sname} pod_is_dp={pod_is_dp}")


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_rules_match_reference(mesh_name):
    mesh, rmesh = _port_mesh(mesh_name), _abstract_mesh(*MESHES[mesh_name])
    for pod_is_dp in (True, False):
        for pure_dp in (True, False):
            kw = dict(pod_is_dp=pod_is_dp, pure_dp=pure_dp)
            assert sh.batch_axes(mesh, **kw) == ref_sh.batch_axes(rmesh, **kw)
            for b in (1, 2, 3, 16, 32, 48, 128, 256, 512, 1024):
                for shape in ((b,), (b, 7), (b, 3, 5)):
                    assert sh.data_spec(shape, mesh, **kw) == \
                        tuple(ref_sh.data_spec(shape, rmesh, **kw)), \
                        (shape, kw)


def test_meshes():
    slots = M.device_slots(8, "cpu")
    assert [s.id for s in slots] == list(range(8))
    m1 = M.make_stage_mesh(4, devices=slots[:4])
    m2 = M.make_stage_mesh(4, 2, devices=slots)
    assert (m1.shape, m1.axis_names, m1.size) == ({"stage": 4}, ("stage",), 4)
    assert (m2.shape, m2.size) == ({"data": 2, "stage": 4}, 8)
    assert m2.slot({"data": 1, "stage": 2}).id == 6
    assert m2.devices.shape == (2, 4)
    with pytest.raises(ValueError) as err:
        M.make_stage_mesh(4, 2, devices=slots[:5])
    with pytest.raises(ValueError) as ref_err:
        ref_mesh.make_stage_mesh(4, 2, devices=list(range(5)))
    assert str(err.value) == str(ref_err.value)
    for multi_pod, want in ((False, {"data": 16, "model": 16}),
                            (True, {"pod": 2, "data": 16, "model": 16})):
        m = M.make_production_mesh(multi_pod=multi_pod)
        assert (m.shape, m.devices, m.size) == (want, None, 256 * (
            1 + multi_pod))
    assert M.make_test_mesh(n_pod=2).shape == {"pod": 2, "data": 2,
                                               "model": 2}
    with pytest.raises(ValueError, match="abstract"):
        M.make_production_mesh().slot({})
    assert M.default_pool() == [] or torch.cuda.is_available()


def test_remesh_is_bitwise_and_copies():
    slots = M.device_slots(8, "cpu")
    old = M.make_stage_mesh(4, devices=slots[:4])
    new = M.make_stage_mesh(4, devices=slots[4:])
    buf = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (4, 48), dtype=np.uint8))
    bias = torch.randn(5, dtype=torch.bfloat16)
    tree = {"buf": M.place(buf, old, ("stage",)), "bias": bias}
    out = remesh(tree, old, new, lambda path, leaf:
                 ("stage",) if "buf" in path else ())
    assert out["buf"].mesh is new and out["buf"].spec == ("stage", None)
    assert torch.equal(out["buf"].gather(), buf)
    for k in range(4):
        row = out["buf"].shard({"stage": k})
        assert torch.equal(row, buf[k:k + 1])
        assert row.untyped_storage().data_ptr() not in {
            t.untyped_storage().data_ptr() for t in tree["buf"].shards()}
    donors = [t.clone() for t in tree["buf"].shards()]
    for t in tree["buf"].shards():
        t.fill_(0)
    assert torch.equal(out["buf"].gather(), torch.cat(donors))
    assert torch.equal(out["bias"].shard({"stage": 3}).view(torch.int16),
                       bias.view(torch.int16))
    assert out["bias"].shard({"stage": 0}).data_ptr() != bias.data_ptr()


# -- the executors on a mesh of slots -------------------------------------------

def _placed_stages(n):
    """Stage k reads its row: adds the row's first W bytes, then k + 1."""
    def make(k):
        def stage(row, w, out=None):
            y = (w + row[:w.shape[-1]].float()) * 0.5 + (k + 1)
            return y if out is None else out.copy_(y)
        return stage
    return [make(k) for k in range(n)]


def _wires(lead, mb, w, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=lead + (mb, w)).astype(np.float32))


@pytest.mark.parametrize("n_replicas", [1, 2])
def test_mesh_executors_equal_meshless_bitwise(n_replicas):
    s, m, mb, w = 3, 4, 2, 6
    rep = n_replicas > 1
    slots = M.device_slots(s * n_replicas, "cpu")
    mesh = M.make_stage_mesh(s, n_replicas, devices=slots)
    buf = torch.from_numpy(np.random.default_rng(1).integers(
        0, 50, (s, 16), dtype=np.uint8))
    x = _wires((n_replicas, m) if rep else (m,), mb, w)
    fns = _placed_stages(s)
    want = pp.pipeline_apply_gspmd_hetero(fns, x, n_stages=s,
                                          n_replicas=n_replicas,
                                          stage_params=tuple(buf))
    placed = M.place(buf, mesh, ("stage",))
    assert placed.nbytes_per_slot == 16
    for got in (
            pp.pipeline_apply_gspmd_hetero(
                fns, x, n_stages=s, stage_axis="stage", mesh=mesh,
                stage_params=buf, n_replicas=n_replicas),
            pp.pipeline_apply_gspmd_hetero(
                fns, x, n_stages=s, stage_axis="stage", mesh=mesh,
                stage_params=placed, n_replicas=n_replicas),
            pp.pipeline_apply_hetero(fns, x, mesh=mesh, stage_axis="stage",
                                     n_stages=s, stage_params=placed,
                                     n_replicas=n_replicas)):
        assert torch.equal(got, want)
    # one tick on per-slot state buffers equals one on a state tensor
    lead = (s, n_replicas) if rep else (s,)
    state = _wires(lead, mb, w, seed=2)
    grid = pp.mesh_slots(mesh, s, n_replicas)
    lists = pp.slot_buffers((mb, w), grid)
    for k in range(s):
        for r in range(n_replicas):
            lists[k][r].copy_(state[k, r] if rep else state[k])
    inj = _wires((n_replicas,) if rep else (), mb, w, seed=3)
    out_t, emit_t = pp.pipeline_step_hetero(
        fns, state.clone(), inj, n_stages=s, n_replicas=n_replicas,
        stage_axis="stage", mesh=mesh, stage_params=placed)
    out_l, emit_l = pp.pipeline_step_hetero(
        fns, lists, inj, n_stages=s, n_replicas=n_replicas,
        stage_axis="stage", mesh=mesh, stage_params=placed)
    for k in range(s):
        for r in range(n_replicas):
            assert torch.equal(pp.slot_at(out_t, k, r, rep), out_l[k][r])


def test_mesh_executors_refuse_what_the_reference_refuses():
    fns = _placed_stages(2)
    x = _wires((2,), 2, 4)
    slots = M.device_slots(4, "cpu")
    stage2 = M.make_stage_mesh(2, devices=slots[:2])
    stage3 = M.make_stage_mesh(3, devices=slots[:3])
    rmesh2 = _abstract_mesh((2,), ("stage",))
    rows = (torch.zeros(8, dtype=torch.uint8),) * 2
    buf = torch.zeros((2, 8), dtype=torch.uint8)
    data_mesh = M.Mesh(("data",), (2,), slots[:2])
    cases = [
        # ragged rows on a stage axis
        (lambda: pp.pipeline_apply_gspmd_hetero(
            fns, x, n_stages=2, stage_axis="stage", mesh=stage2,
            stage_params=rows),
         lambda: ref_pp.pipeline_apply_gspmd_hetero(
             [lambda p, w: w] * 2, jnp.zeros((2, 2, 4)), n_stages=2,
             stage_axis="stage", mesh=rmesh2,
             stage_params=tuple(jnp.zeros(8, jnp.uint8) for _ in range(2)))),
        # the even buffer on a mesh without the stage axis
        (lambda: pp.pipeline_apply_gspmd_hetero(
            fns, x, n_stages=2, stage_axis="stage", mesh=data_mesh,
            stage_params=buf),
         lambda: ref_pp.pipeline_apply_gspmd_hetero(
             [lambda p, w: w] * 2, jnp.zeros((2, 2, 4)), n_stages=2,
             stage_axis="stage", mesh=_abstract_mesh((2,), ("data",)),
             stage_params=jnp.zeros((2, 8), jnp.uint8))),
        # R 2 without a data axis (the shard_map executor)
        (lambda: pp.pipeline_apply_hetero(
            _placed_stages(2), _wires((2, 2), 2, 4), mesh=stage2,
            stage_axis="stage", n_stages=2, stage_params=buf, n_replicas=2),
         lambda: ref_pp.pipeline_apply_hetero(
             [lambda p, w: w] * 2, jnp.zeros((2, 2, 2, 4)), mesh=rmesh2,
             stage_axis="stage", n_stages=2,
             stage_params=jnp.zeros((2, 8), jnp.uint8), n_replicas=2)),
    ]
    for port_call, ref_call in cases:
        with pytest.raises(ValueError) as err:
            port_call()
        with pytest.raises(ValueError) as ref_err:
            ref_call()
        # the reference's message up to where it names its own API
        cut = lambda e: str(e.value).split(";")[0].split(", got")[0]  # noqa
        assert cut(err) == cut(ref_err)
    with pytest.raises(ValueError, match="3 slots for 2 stages"):
        pp.pipeline_apply_gspmd_hetero(fns, x, n_stages=2, stage_axis="stage",
                                       mesh=stage3, stage_params=buf)
    with pytest.raises(ValueError, match="ragged rows only run"):
        pp.pipeline_apply_hetero(fns, x, mesh=None, stage_axis="stage",
                                 n_stages=2, stage_params=rows)
    with pytest.raises(ValueError, match="abstract"):
        pp.pipeline_apply_gspmd_hetero(
            fns, x, n_stages=2, stage_axis="stage",
            mesh=M.Mesh(("stage",), (2,)), stage_params=buf)


def test_homogeneous_executors_on_a_mesh_bitwise():
    """pipeline_apply (shard_map form) and pipeline_apply_gspmd(mesh=) on 3
    slots: outputs and gradients bit for bit the mesh-less executor's."""
    s, lmax, m, d = 3, 2, 4, 8
    gen = torch.Generator().manual_seed(0)
    w = torch.randn((s, lmax, d, d), generator=gen) * 0.3
    mask = np.array([[True, True], [True, False], [True, True]])
    x = torch.randn((m, 2, d), generator=gen)

    def block(p, h):
        return torch.tanh(h @ p["w"])

    stage_fn = pp.make_stage_fn(block)
    mesh = M.make_stage_mesh(s, stage_axis="pod",
                             devices=M.device_slots(s, "cpu"))
    outs = []
    for run in (lambda p: pp.pipeline_apply_gspmd(
                    stage_fn, p, mask, x, n_stages=s),
                lambda p: pp.pipeline_apply_gspmd(
                    stage_fn, p, mask, x, n_stages=s, mesh=mesh),
                lambda p: pp.pipeline_apply(
                    stage_fn, p, mask, x, mesh=mesh, stage_axis="pod",
                    n_stages=s)):
        wt = w.clone().requires_grad_(True)
        y = run({"w": wt})
        (g,) = torch.autograd.grad(y.square().sum(), [wt])
        outs.append((y.detach(), g))
    for y, g in outs[1:]:
        assert torch.equal(y, outs[0][0]) and torch.equal(g, outs[0][1])
    with pytest.raises(ValueError, match="no mesh"):
        pp.pipeline_apply(stage_fn, {"w": w}, mask, x, mesh=None,
                          stage_axis="pod", n_stages=s)


def test_mesh_train_step_equals_meshless_bitwise(one_torch_thread):
    cfg = reduced(get_config("smollm-360m"))
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    shape = ShapeConfig("t", "train", 16, 4)
    mesh = M.make_stage_mesh(2, stage_axis="pod",
                             devices=M.device_slots(2, "cpu"))
    rng = np.random.default_rng(5)
    batch = {k: rng.integers(0, cfg.vocab_size, (4, 16), dtype=np.int32)
             for k in ("tokens", "labels")}
    got = {}
    for name, m, kw in (("mesh", mesh, {}),
                        ("meshless", None, {"n_stages": 2})):
        ts, restructure, plan = steps.make_pipeline_train_step(
            cfg, m, shape, n_microbatches=2, **kw)
        sp, mask = restructure(params)
        (loss, _), grads = ts.value_and_grad(sp, mask, batch)
        _, _, met = ts(sp, mask, steps.adamw.init(sp), batch)
        got[name] = (float(loss), dict(pytree.keyed_leaves(grads)),
                     float(met["grad_norm"]), plan["stage_of"])
    a, b = got["mesh"], got["meshless"]
    assert a[0] == b[0] and a[2] == b[2] and a[3] == b[3]
    for key, g in a[1].items():
        assert (g is None and b[1][key] is None) or torch.equal(g, b[1][key])
    with pytest.raises(ValueError, match="no 'pod' axis"):
        steps.make_pipeline_train_step(cfg, M.make_stage_mesh(
            2, devices=M.device_slots(2, "cpu")), shape)
    with pytest.raises(ValueError, match="n_stages=3"):
        steps.make_pipeline_train_step(cfg, mesh, shape, n_stages=3)
