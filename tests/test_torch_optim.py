"""The port's training substrate against the JAX reference on the CPU:
the Markov stream and image batches (bit for bit), the AdamW schedule and
update, int8 gradient compression, checkpoints written by one package
and restored by the other (both ways, a full {"params", "opt"} state),
their validation errors, the async saver, the step GC and the restart
loop.

Bars: the data, the codes and the scales of compression, and restored
checkpoints are bit for bit; the schedule within 1e-6 relative (cos of
f32 on two libraries); an AdamW update within 1 bf16 ulp of the
reference's params (or of lr, where an update cancels a value to near 0) (the global norm within GNORM_RTOL, and the f32
moments, which the clip scale of that norm multiplies, within GNORM_RTOL
of each element and of the leaf's largest), fed the same gradients.
"""
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_lm_ref import bf16, model, one_torch_thread  # noqa: E402
from repro.checkpoint import ckpt as ref_ckpt  # noqa: E402
from repro.data import pipeline as ref_data  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.runtime import fault as ref_fault  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.core import pytree  # noqa: E402
from repro_torch.data import pipeline as data  # noqa: E402
from repro_torch.models.layers import tensor_from_numpy  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import fault  # noqa: E402

ARCH = "smollm-360m"
#: the global norm: f32 sums of each leaf's squares, taken in other orders
#: by XLA and torch (1.6e-6 apart measured)
GNORM_RTOL = 1e-5


def _np(t):
    """A port tensor as numpy, bf16 as its f32 value."""
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def bf16_ulp(w):
    """The bf16 spacing at each value of w (f32 holding bf16 values)."""
    a = np.abs(np.asarray(w, np.float64))
    return np.where(a > 0, 2.0 ** (np.floor(np.log2(np.where(a > 0, a, 1)))
                                   - 7), 2.0 ** -133)


def _ref_flat(tree):
    """{JAX key path: numpy} of a reference tree (bf16 as f32)."""
    return {"|".join(str(p) for p in path): np.asarray(
        jnp.asarray(leaf).astype(jnp.float32) if jnp.asarray(leaf).dtype
        == jnp.bfloat16 else leaf)
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _grads(params, seed):
    """Random gradients for ``params`` (numpy, each leaf's dtype; None
    for integer leaves): the port's tree and the reference's."""
    rng = np.random.default_rng(seed)
    port = pytree.map_leaves(
        lambda t: None if not t.is_floating_point() else tensor_from_numpy(
            bf16(rng.standard_normal(t.shape) * 0.1)).to(t.dtype), params)
    flat = dict(pytree.keyed_leaves(port))
    _, _, rparams, _ = model(ARCH)

    def ref_leaf(path, leaf):
        g = flat["|".join(str(p) for p in path)]
        if g is None:
            return jnp.zeros(leaf.shape, leaf.dtype)
        return jnp.asarray(_np(g)).astype(leaf.dtype)
    return port, jax.tree_util.tree_map_with_path(ref_leaf, rparams)


@pytest.mark.parametrize("seed,step,shards,shard", [
    (0, 0, 1, 0), (0, 5, 1, 0), (3, 2, 2, 1), (7, 11, 4, 3)])
def test_markov_stream_and_images_bitwise(seed, step, shards, shard):
    kw = dict(vocab_size=1000, seq_len=17, global_batch=8, seed=seed,
              n_shards=shards, shard_id=shard, branching=8)
    got = data.MarkovStream(data.DataConfig(**kw)).batch(step)
    want = ref_data.MarkovStream(ref_data.DataConfig(**kw)).batch(step)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
    gi = data.image_batch(step, batch=2, size=8, seed=seed)
    wi = ref_data.image_batch(step, batch=2, size=8, seed=seed)
    for k in ("images", "labels"):
        np.testing.assert_array_equal(gi[k], wi[k])


def test_schedule_matches_reference():
    cfg = dict(lr=3e-3, warmup_steps=10, total_steps=80)
    pc, rc = adamw.AdamWConfig(**cfg), ref_adamw.AdamWConfig(**cfg)
    for s in range(0, 101):
        got = float(adamw.schedule(pc, torch.tensor(s, dtype=torch.int32)))
        want = float(ref_adamw.schedule(rc, jnp.int32(s)))
        assert abs(got - want) <= 1e-6 * abs(want), (s, got, want)


def test_update_matches_reference():
    """Three AdamW updates of a tree with bf16 leaves and SparseWeights
    fed the same gradients: params within 1 bf16 ulp, moments within
    GNORM_RTOL, idx untouched, the step counted."""
    _, _, rparams, params = model(ARCH)
    cfg = dict(lr=3e-3, warmup_steps=1, total_steps=10)
    pc, rc = adamw.AdamWConfig(**cfg), ref_adamw.AdamWConfig(**cfg)
    state, rstate = adamw.init(params), ref_adamw.init(rparams)
    p, rp = params, rparams
    for i in range(3):
        g, rg = _grads(p, i)
        p, state, m = adamw.update(pc, p, g, state)
        rp, rstate, rm = ref_adamw.update(rc, rp, rg, rstate)
        assert abs(float(m["grad_norm"]) - float(rm["grad_norm"])) <= \
            GNORM_RTOL * float(rm["grad_norm"])
        assert float(m["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
    assert int(state.step) == int(rstate.step) == 3
    want = _ref_flat({"params": rp, "m": rstate.m, "v": rstate.v})
    moved = 0
    for key, got in pytree.keyed_leaves({"params": p, "m": state.m,
                                         "v": state.v}):
        w, gt = want[key], _np(got)
        if key.endswith("[<flat index 1>]") and key.startswith("['params']"):
            np.testing.assert_array_equal(gt, w)           # idx
            assert got is dict(pytree.keyed_leaves(params))[
                key[len("['params']|"):]]
            continue
        if got.dtype == torch.bfloat16:
            # 1 ulp of the value, or of lr where p - lr * delta cancels
            bar = bf16_ulp(w) + bf16_ulp(cfg["lr"])
            assert (np.abs(gt - w) <= bar).all(), key
            moved += int((gt != _np(dict(pytree.keyed_leaves(params))[
                key[len("['params']|"):]])).sum())
        else:             # moments: the clip scale carries the norm's
            bar = GNORM_RTOL * (np.abs(w) + np.abs(w).max())
            assert (np.abs(gt - w) <= bar).all(), key
    assert moved > 0


def test_compress_grads_matches_reference():
    _, _, _, params = model(ARCH)
    g, rg = _grads(params, 5)
    e = fault.init_error(g)
    (q, s), err = fault.compress_grads(g, e)
    (rq, rs), rerr = ref_fault.compress_grads(rg, ref_fault.init_error(rg))
    want_q, want_s = _ref_flat(rq), _ref_flat(rs)
    flat_g = dict(pytree.keyed_leaves(g))
    for key, qq in pytree.keyed_leaves(q):
        if flat_g[key] is None:
            assert qq is None
            continue
        assert qq.dtype == torch.int8
        np.testing.assert_array_equal(qq.numpy(), want_q[key])
    for key, ss in pytree.keyed_leaves(s):
        if flat_g[key] is not None:
            assert float(ss) == float(want_s[key]), key
    back = fault.decompress_grads((q, s))
    for key, d in pytree.keyed_leaves(back):
        if d is None:
            continue
        gf = flat_g[key].float()         # scale / 2 and q * s's rounding
        assert (d - gf).abs().max() <= float(dict(pytree.keyed_leaves(s))[
            key]) / 2 + 2.0 ** -23 * float(gf.abs().max())


def _states():
    """(port state, reference state) of the same values: the reference's
    params and an optimizer state after one update."""
    _, _, rparams, params = model(ARCH)
    g, rg = _grads(params, 9)
    cfg = dict(lr=3e-3, warmup_steps=1, total_steps=10)
    p, st, _ = adamw.update(adamw.AdamWConfig(**cfg), params, g,
                            adamw.init(params))
    rp, rst, _ = ref_adamw.update(ref_adamw.AdamWConfig(**cfg), rparams, rg,
                                  ref_adamw.init(rparams))
    return {"params": p, "opt": st}, {"params": rp, "opt": rst}


def _assert_state_equal(port_state, ref_state):
    want = _ref_flat(ref_state)
    got = dict(pytree.keyed_leaves(port_state))
    assert set(got) == set(want)
    for key, t in got.items():
        np.testing.assert_array_equal(_np(t), want[key], err_msg=key)
        assert tuple(t.shape) == want[key].shape, key


def test_checkpoint_port_to_reference(tmp_path):
    state, rstate = _states()
    ckpt.save(state, str(tmp_path), 3)
    template = jax.tree.map(jnp.zeros_like, rstate)
    got, step = ref_ckpt.restore(template, str(tmp_path))
    assert step == 3
    _assert_state_equal(state, got)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(rstate)):
        assert a.dtype == b.dtype


def test_checkpoint_reference_to_port(tmp_path):
    state, rstate = _states()
    ref_ckpt.save(rstate, str(tmp_path), 7)
    template = pytree.map_leaves(torch.zeros_like, state)
    template = {"params": pytree.rebuild(state["params"], lambda k: dict(
        pytree.keyed_leaves(template["params"]))[k]), "opt": template["opt"]}
    got, step = ckpt.restore(template, str(tmp_path))
    assert step == 7
    _assert_state_equal(got, rstate)
    for (_, a), (_, b) in zip(pytree.keyed_leaves(got),
                              pytree.keyed_leaves(state)):
        assert a.dtype == b.dtype and a.shape == b.shape


def _one_step_dir(tmp_path):
    state = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "s": torch.tensor(4, dtype=torch.int32)}
    return state, ckpt.save(state, str(tmp_path), 1)


def test_checkpoint_crc_mismatch_raises(tmp_path):
    state, d = _one_step_dir(tmp_path)
    shard = os.path.join(d, "shard_0.npz")
    raw = bytearray(open(shard, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(shard, "wb").write(bytes(raw))
    with pytest.raises(ckpt.CheckpointCorruptError, match="CRC32"):
        ckpt.restore(state, str(tmp_path))
    with pytest.raises(ref_ckpt.CheckpointCorruptError, match="CRC32"):
        ref_ckpt.restore({"w": jnp.zeros((2, 3)), "s": jnp.int32(0)},
                         str(tmp_path))


def test_checkpoint_truncation_raises(tmp_path):
    state, d = _one_step_dir(tmp_path)
    shard = os.path.join(d, "shard_0.npz")
    raw = open(shard, "rb").read()
    open(shard, "wb").write(raw[:-10])
    with pytest.raises(ckpt.CheckpointCorruptError, match="truncated"):
        ckpt.restore(state, str(tmp_path))


def test_checkpoint_missing_manifest_raises(tmp_path):
    state, d = _one_step_dir(tmp_path)
    os.remove(os.path.join(d, "MANIFEST.json"))
    with pytest.raises(ckpt.CheckpointCorruptError, match="MANIFEST"):
        ckpt.restore(state, str(tmp_path))
    shutil.rmtree(d)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(state, str(tmp_path))


def test_async_saver_and_gc(tmp_path):
    saver = ckpt.AsyncSaver()
    state = {"w": torch.zeros(4)}
    for step in range(5):
        state = {"w": state["w"] + 1}
        saver.save(state, str(tmp_path), step, keep=2)
        state["w"].add_(100)           # the saved tree was read already
        state = {"w": state["w"] - 100}
    saver.wait()
    assert saver.last_path == os.path.join(str(tmp_path), "step_00000004")
    assert sorted(os.listdir(tmp_path)) == ["step_00000003",
                                            "step_00000004"]
    assert ckpt.latest_step(str(tmp_path)) == 4
    got, step = ckpt.restore({"w": torch.zeros(4)}, str(tmp_path))
    assert step == 4 and got["w"].tolist() == [5.0] * 4
    got, _ = ckpt.restore({"w": torch.zeros(4)}, str(tmp_path), 3)
    assert got["w"].tolist() == [4.0] * 4
    assert ckpt.latest_step(str(tmp_path / "none")) is None


def _counter_run(tmp_path, fail_at, max_restarts=5):
    def make_state():
        return {"x": torch.zeros((), dtype=torch.float32),
                "n": torch.zeros((), dtype=torch.int32)}

    def step_fn(state, i):
        return {"x": state["x"] * 0.5 + i, "n": state["n"] + 1}

    return fault.run_with_restarts(
        make_state, step_fn, n_steps=9, ckpt_dir=str(tmp_path),
        ckpt_every=3, max_restarts=max_restarts,
        injector=fault.FailureInjector(fail_at_steps=fail_at))


def test_run_with_restarts_recovers(tmp_path):
    clean, r0, n0 = _counter_run(tmp_path / "a", ())
    state, restarts, executed = _counter_run(tmp_path / "b", (4, 7))
    assert (r0, n0) == (0, 9)
    assert restarts == 2 and executed == 9     # each failure before a step
    assert float(state["x"]) == float(clean["x"])
    assert int(state["n"]) == int(clean["n"]) == 9
    # the same loop in the reference package restarts as often
    rstate, rr, rn = ref_fault.run_with_restarts(
        lambda: {"x": jnp.float32(0.0)},
        lambda s, i: {"x": s["x"] * 0.5 + i}, n_steps=9,
        ckpt_dir=str(tmp_path / "c"), ckpt_every=3,
        injector=ref_fault.FailureInjector(fail_at_steps=(4, 7)))
    assert (rr, rn) == (restarts, executed)
    assert float(rstate["x"]) == float(state["x"])


def test_run_with_restarts_gives_up(tmp_path):
    with pytest.raises(fault.InjectedFailure):
        _counter_run(tmp_path, (1, 2, 3), max_restarts=2)
