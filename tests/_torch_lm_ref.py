"""Helpers shared by the port's state-family LM tests
(tests/test_torch_rwkv.py, test_torch_zamba.py, test_torch_whisper.py)
and its training tests (tests/test_torch_train*.py): the reference's
weights carried across, inputs made with numpy, the bars, and the
continuous batcher driven on both packages."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.kernels import ref as ref_kref
from repro.models import layers as ref_layers
from repro.models import lm as ref_lm
from repro.runtime import scheduler as ref_sched
from repro_torch.configs import get_config, reduced
from repro_torch.launch.serve import serve_lm
from repro_torch.models import lm
from repro_torch.runtime.scheduler import (ContinuousBatcher, Request,
                                           make_per_slot_decode,
                                           make_slot_cache)

# the LM bars of tests/test_torch_lm.py: forward and decode steps 1e-2 of
# max |logit|, serve_lm and the batcher (teacher-forced) 3e-2
LOGIT_RTOL = 1e-2
SERVE_RTOL = 3e-2
# The reference's jitted program is not its own ops run one at a time:
# XLA's fusions keep f32 values across elementwise ops that, run alone,
# round to bf16 (a residual add before its norm, the products of the
# token shift). In rwkv6 and Mamba2 a per-token norm of the scan's output
# (ln_x, the gated norm) carries such a rounding to unit scale, so the
# reference's jitted forward parts from its eager one by 1.5e-2 (rwkv6)
# and 1.3e-2 (zamba2) of max |logit| on these tests' inputs, while the
# port lands 6.0e-3 / 6.9e-3 from the eager one. Layer and whole-model
# checks hold the port to the eager reference (ops one at a time,
# ``jax.disable_jit``, as the port runs them) at their bars, and the
# whole model to the jitted one at SERVE_RTOL as well.


def numpy_tree(tree):
    """A reference parameter tree as numpy, sparse weights as dicts."""
    if isinstance(tree, ref_layers.SparseWeight):
        return {"vals": np.asarray(tree.vals), "idx": np.asarray(tree.idx),
                "d_in": tree.d_in}
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


@functools.lru_cache(maxsize=None)
def model(arch: str):
    """(reference cfg, port cfg, reference params, port params) at
    ``reduced()`` size, the port's carried across bit for bit."""
    rcfg = ref_reduced(ref_get_config(arch))
    cfg = reduced(get_config(arch))
    rparams = jax.jit(lambda k: ref_lm.init_params(rcfg, k))(
        jax.random.PRNGKey(0))
    return rcfg, cfg, rparams, lm.params_from_numpy(numpy_tree(rparams),
                                                    device="cpu")


def port_leaves(tree, path=()):
    """{path: tensor} of a port tree; a SparseWeight gives vals and idx."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(port_leaves(v, path + (k,)))
        return out
    if isinstance(tree, lm.SparseWeight):
        return {path + ("vals",): tree.vals, path + ("idx",): tree.idx}
    return {path: tree}


def ref_leaves(tree):
    """{path: numpy array} of a reference tree, keyed as port_leaves."""
    def name(k):
        k = k.key
        return ("vals", "idx")[k] if isinstance(k, int) else k
    return {tuple(map(name, path)): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def check_round_trip(arch: str) -> dict:
    """The reference's tree carried across: the same leaves, shapes and
    bits. Returns the port's leaves."""
    _, _, rparams, params = model(arch)
    port, ref = port_leaves(params), ref_leaves(rparams)
    assert set(port) == set(ref)
    for key, want in ref.items():
        got = port[key]
        assert tuple(got.shape) == want.shape, key
        if want.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16, key
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          want.view(np.int16))
        else:
            assert str(got.dtype).split(".")[1] == want.dtype.name, key
            np.testing.assert_array_equal(got.numpy(), want)
    return port


def check_init_layout(arch: str) -> None:
    """``lm.init_params`` gives the reference's tree of shapes and
    dtypes."""
    _, cfg, rparams, _ = model(arch)
    port = port_leaves(lm.init_params(cfg, torch.Generator().manual_seed(0)))
    ref = ref_leaves(rparams)
    assert set(port) == set(ref)
    for key, want in ref.items():
        assert tuple(port[key].shape) == want.shape, key
        assert str(port[key].dtype).split(".")[1] == want.dtype.name, key


def tokens(seed, b, t, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, t),
                                                dtype=np.int32)


def bf16(a):
    """numpy f32 -> numpy bf16 with JAX's rounding."""
    return np.asarray(jnp.asarray(np.asarray(a, np.float32)).astype(
        jnp.bfloat16))


def t_(a):
    """numpy (bf16 too) -> torch, bit for bit."""
    return lm.tensor_from_numpy(np.asarray(a))


def within(got, want, rtol=LOGIT_RTOL):
    """max |got - want| within ``rtol`` of max |want|; the error."""
    got, want = (a.float().numpy() if isinstance(a, torch.Tensor) else
                 np.asarray(a, np.float32) for a in (got, want))
    assert got.shape == want.shape and np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()), (err, rtol)
    return err


def ref_decode(rcfg):
    return jax.jit(lambda p, c, tk, i: ref_lm.decode_step(rcfg, p, c, tk, i))


def eager(fn, *args, **kw):
    """``fn`` of the reference with its ops run one at a time."""
    with jax.disable_jit():
        return fn(*args, **kw)


def check_forward(arch: str, toks: np.ndarray, extra=None):
    """The port's forward against the reference's, eager at LOGIT_RTOL
    and jitted at SERVE_RTOL; returns the port's logits."""
    rcfg, cfg, rparams, params = model(arch)
    got, aux = lm.forward(cfg, params, torch.from_numpy(toks),
                          extra={k: t_(v) for k, v in (extra or {}).items()}
                          or None)
    assert float(aux) == 0.0
    rex = {k: jnp.asarray(v) for k, v in (extra or {}).items()} or None
    want, _ = eager(ref_lm.forward, rcfg, rparams, jnp.asarray(toks),
                    extra=rex)
    within(got, want)
    want, _ = jax.jit(lambda p, t, e: ref_lm.forward(rcfg, p, t, extra=e))(
        rparams, jnp.asarray(toks), rex)
    within(got, want, SERVE_RTOL)
    return got


def check_decode_steps(arch: str, toks: np.ndarray, max_seq: int,
                       fill=None) -> tuple:
    """``toks`` (B, T) stepped through the port's and the reference's
    decode_step (the reference eager), every step's logits within
    LOGIT_RTOL; ``fill(cache, rcache) -> (cache, rcache)`` prepares the
    caches first. Returns the two caches at the end."""
    rcfg, cfg, rparams, params = model(arch)
    b, t = toks.shape
    rcache = ref_lm.init_cache(rcfg, b, max_seq)
    cache = lm.init_cache(cfg, b, max_seq, device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == {
        k: (v.shape, getattr(torch, v.dtype.name)) for k, v in rcache.items()}
    if fill is not None:
        cache, rcache = fill(cache, rcache)
    for i in range(t):
        want, rcache = eager(ref_lm.decode_step, rcfg, rparams, rcache,
                             jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        got, cache = lm.decode_step(cfg, params, cache,
                                    torch.from_numpy(toks[:, i:i + 1]), i)
        within(got, want)
    return cache, rcache


def stepped_logits(cfg, params, toks: np.ndarray, cache=None):
    """The prompt toks (B, T) stepped through the port's decode_step from
    a zero cache (or ``cache``): (B, T, V) f32, and the cache."""
    b, t = toks.shape
    cache = cache if cache is not None else lm.init_cache(
        cfg, b, t, device="cpu")
    out = []
    for i in range(t):
        lg, cache = lm.decode_step(cfg, params, cache,
                                   torch.from_numpy(toks[:, i:i + 1]), i)
        out.append(lg[:, 0])
    return torch.stack(out, 1), cache


def check_serve_lm(arch: str, prompts: np.ndarray, gen: int, max_seq: int,
                   rcache=None, **kw) -> dict:
    """``serve_lm`` on the reference's weights against the reference's
    decode_step (jitted) fed the port's prompt and tokens, teacher-forced
    from ``rcache`` (default: zeros): every step's logits within
    SERVE_RTOL of max |logit|, and each greedy token the reference's
    argmax where the reference's top-2 gap exceeds the bar. Returns
    serve_lm's output."""
    rcfg, cfg, rparams, params = model(arch)
    b, tp = prompts.shape
    out = serve_lm(arch, prompts=prompts, params=params, gen_tokens=gen,
                   max_seq=max_seq, record_logits=True, verbose=False,
                   device="cpu", **kw)
    assert out["tokens"].shape == (b, gen)
    step = ref_decode(rcfg)
    rcache = rcache if rcache is not None else ref_lm.init_cache(
        rcfg, b, max_seq)
    seq = np.concatenate([prompts, out["tokens"]], 1)
    for i in range(tp + gen):
        want, rcache = step(rparams, rcache, jnp.asarray(seq[:, i:i + 1]),
                            jnp.int32(i))
        want = np.asarray(want[:, 0], np.float32)
        within(out["logits"][:, i], want, SERVE_RTOL)
        if tp - 1 <= i < tp + gen - 1:
            top2 = np.sort(want, -1)[:, -2:]
            clear = top2[:, 1] - top2[:, 0] > SERVE_RTOL * np.abs(want).max()
            np.testing.assert_array_equal(want.argmax(-1)[clear],
                                          seq[clear, i + 1])
    return out


# --- the continuous batcher ----------------------------------------------

def requests(seed, n, vocab, prompt=(2, 9), new=(2, 7)):
    rng = np.random.default_rng(seed)
    return [dict(rid=rid, prompt=rng.integers(
        0, vocab, size=rng.integers(*prompt)).astype(np.int32),
        max_new_tokens=int(rng.integers(*new))) for rid in range(n)]


def run_batchers(arch: str, reqs: list, slots: int, max_seq: int):
    """The requests through the port's batcher, and the reference's
    per-slot decode (the one its batcher vmaps over the slots) replayed
    on the same schedule: fed the port's tokens and positions step by
    step, teacher-forced, from its own zeroed slot cache, which it never
    resets. Returns (the port's finished requests, {rid: {pos: its
    logits (V,)}} of the port, the same of the reference's replay).
    Every slot is reused when there are more requests than slots."""
    rcfg, cfg, rparams, params = model(arch)
    decode = make_per_slot_decode(cfg)
    steps, logs = [], {}
    cb = None

    def recording(p, cache, toks, pos):
        lg, cache = decode(p, cache, toks, pos)
        rids = [s.rid for s in cb.state]
        steps.append((toks.numpy().copy(), pos.numpy().copy(), rids))
        _log(logs, rids, pos.numpy(), lg[:, -1].float().numpy())
        return lg, cache

    cb = ContinuousBatcher(
        cfg, params, slots=slots, max_seq=max_seq, decode_fn=recording,
        init_cache_fn=lambda c, s, m: make_slot_cache(c, s, m, device="cpu"))
    for kw in reqs:
        cb.submit(Request(**kw))
    done = cb.run()
    ref_step = ref_sched.make_per_slot_decode(rcfg)
    rcache = ref_sched.make_slot_cache(rcfg, slots, max_seq)
    rlogs = {}
    for toks, pos, rids in steps:
        lg, rcache = ref_step(rparams, rcache, jnp.asarray(toks.astype(
            np.int32)), jnp.asarray(pos.astype(np.int32)))
        _log(rlogs, rids, pos, np.asarray(lg[:, -1], np.float32))
    return done, logs, rlogs


def _log(out, rids, pos, lg):
    for i, rid in enumerate(rids):
        if rid >= 0:
            out.setdefault(rid, {})[int(pos[i])] = lg[i]


def alone(arch: str, req, n_pos: int):
    """One request's first ``n_pos`` logits, teacher-forced alone on the
    port from a zero state (its prompt, then its tokens): (n_pos, V)."""
    _, cfg, _, params = model(arch)
    seq = np.concatenate([req.prompt, np.asarray(req.tokens, np.int32)])
    lg, _ = stepped_logits(cfg, params, seq[None, :n_pos])
    return lg[0]


def check_batcher_against_alone(arch: str, done: list, logs: dict) -> int:
    """Every request of the port's batcher equals its own run from a zero
    state: every fed position's logits within SERVE_RTOL of max |logit|,
    its tokens the argmax, and the alone run's where that run's top-2 gap
    exceeds the bar; ``serve_lm`` of the prompt gives the first token
    where it clears the bar. Returns the tokens checked."""
    _, cfg, _, params = model(arch)
    checked = 0
    for req in done:
        n = len(req.prompt) + len(req.tokens) - 1
        assert sorted(logs[req.rid]) == list(range(n))
        want = alone(arch, req, n)
        for p in range(n):
            got = logs[req.rid][p]
            w = want[p]
            bar = SERVE_RTOL * float(w.abs().max())
            assert float(np.abs(got - w.numpy()).max()) <= bar, (req.rid, p)
            if p >= len(req.prompt) - 1:
                tok = req.tokens[p - len(req.prompt) + 1]
                assert int(got.argmax()) == tok
                top2 = w.topk(2).values
                if float(top2[0] - top2[1]) > bar:
                    assert int(w.argmax()) == tok, (req.rid, p)
                    checked += 1
    # serve_lm on one prompt: the batcher's first token
    req = done[-1]
    out = serve_lm(cfg.name, prompts=req.prompt[None], params=params,
                   gen_tokens=1, max_seq=len(req.prompt) + 1,
                   record_logits=True, verbose=False, device="cpu",
                   use_reduced=True)
    last = out["logits"][0, len(req.prompt) - 1]
    top2 = last.topk(2).values
    if float(top2[0] - top2[1]) > SERVE_RTOL * float(last.abs().max()):
        assert int(out["tokens"][0, 0]) == req.tokens[0]
    return checked


def first_wave(reqs: list, slots: int) -> list:
    """The rids admitted at the first step: each starts from the zero
    state in both batchers."""
    return [r["rid"] for r in reqs[:slots]]


#: the LM archs every training test runs, at ``reduced()`` size
TRAIN_LMS = ["smollm-360m", "qwen3-32b", "mistral-nemo-12b", "granite-20b",
             "granite-moe-3b-a800m", "moonshot-v1-16b-a3b",
             "llava-next-mistral-7b", "rwkv6-1.6b", "zamba2-7b",
             "whisper-large-v3"]


def train_batch(cfg, b=2, t=16, seed=3, masked=()):
    """A training batch for both packages: numpy tokens and labels
    (labels -1 at ``masked`` positions of row 0) and the family's extra
    input (bf16 patches or frames). Returns (port batch, reference
    batch)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, t), np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (b, t), np.int32)}
    batch["labels"][0, list(masked)] = -1
    if cfg.family == "vlm":
        batch["patches"] = bf16(rng.standard_normal(
            (b, cfg.vision_tokens, cfg.d_model)))
    if cfg.family == "audio":
        batch["frames"] = bf16(rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)))
    port = {k: t_(v) if k in ("patches", "frames") else v
            for k, v in batch.items()}
    return port, {k: jnp.asarray(v) for k, v in batch.items()}


def attention_as_pallas(monkeypatch):
    """Patch, in this test process, the reference's model attention to
    what its Pallas flash kernel computes (p in f32; its test oracle
    ``kernels/ref.py::attention_ref``), which is what the port's kernel
    computes: the reference's XLA twin ``blockwise_attention`` rounds p
    to bf16 before the PV product."""
    def attention(q, k, v, *, causal, window=0, q_offset=0, kv_len=None,
                  **_):
        assert kv_len is None                  # training: no cache
        return ref_kref.attention_ref(q, k, v, causal=causal, window=window,
                                      q_offset=q_offset)
    monkeypatch.setattr(ref_layers, "blockwise_attention", attention)


def bf16_ulp(w):
    """The bf16 spacing at each value of w (f32 holding bf16 values)."""
    a = np.abs(np.asarray(w, np.float64))
    return np.where(a > 0, 2.0 ** (np.floor(np.log2(np.where(a > 0, a, 1)))
                                   - 7), 2.0 ** -133)


# the modules that import the LM helpers take the one-thread pin from here
from _torch_threads import one_torch_thread  # noqa: E402,F401


# --- the loss and its gradients against the reference ----------------------
# (tests/test_torch_train_loss.py states the bars and why)
LOSS_RTOL = 1e-4
GRAD_RTOL = 5e-2


def _ref_grads(rcfg, rparams, rbatch):
    (_, _), g = jax.jit(jax.value_and_grad(
        lambda p: ref_lm.loss_fn(rcfg, p, rbatch, remat="none"),
        has_aux=True, allow_int=True))(rparams)
    return {"|".join(str(p) for p in path): np.asarray(
        jnp.asarray(leaf).astype(jnp.float32))
        for path, leaf in jax.tree_util.tree_leaves_with_path(g)
        if jnp.issubdtype(leaf.dtype, jnp.floating)}


def check_loss_and_grads(arch: str, monkeypatch) -> None:
    """``lm.loss_fn`` (remat "none", B 2, T 16) and its gradients on the
    port against the reference: the loss within LOSS_RTOL of the
    reference run op by op with its attention as its Pallas kernel
    computes it, each floating leaf's gradient within GRAD_RTOL relative
    L2 of the jitted reference's (the worst printed)."""
    from repro_torch.core import pytree
    from repro_torch.launch import steps
    rcfg, cfg, rparams, params = model(arch)
    batch, rbatch = train_batch(cfg)
    (loss, metrics), grads = steps.value_and_grad(
        lambda p: lm.loss_fn(cfg, p, batch, remat="none"), params)
    rgrads = _ref_grads(rcfg, rparams, rbatch)
    attention_as_pallas(monkeypatch)
    want, _ = eager(ref_lm.loss_fn, rcfg, rparams, rbatch, remat="none")
    assert abs(float(loss) - float(want)) <= LOSS_RTOL * abs(float(want))
    if cfg.family == "moe":
        assert float(metrics["aux"]) > 0
    worst = 0.0
    flat = {k: g for k, g in pytree.keyed_leaves(grads) if g is not None}
    assert set(flat) == set(rgrads)
    for key, g in flat.items():
        w = rgrads[key]
        rel = float(np.linalg.norm(g.float().numpy() - w) /
                    max(np.linalg.norm(w), 1e-30))
        worst = max(worst, rel)
        assert rel <= GRAD_RTOL, (key, rel)
    print(f"{arch}: loss {float(loss):.6f} vs {float(want):.6f}; worst "
          f"gradient relative L2 {worst:.3e}")
