"""The port's mixture-of-experts and VLM families against the JAX
reference on the CPU, at ``reduced()`` sizes (4 experts, top-2, expert
FFN 64, 2 layers), on the reference's own weights carried across with
``lm.params_from_numpy``: the MoE layer (routing, capacity drops, the
``set_moe_dp`` groups, the Switch aux loss), an independent no-drop
check, the MoE and VLM ``forward``, ``decode_step``, ``prefill_chunk``,
``serve_lm`` and the continuous batcher (one routing group a slot, as
the reference's vmapped per-slot decode).

Bars. The MoE layer on the same input: the expert ids and kept slots
equal, the output within 1 bf16 ulp and aux within 1e-6 relative,
wherever a token's routing does not hang on a near tie
(``checks.clear``: its k-th and (k+1)-th router probabilities more
than ``checks.MOE_TIE_MARGIN`` apart, relative; f32 router sums taken in
another order move a probability by ~1e-6 of it, and ``lax.top_k`` and
``torch.topk`` may break exact ties in other orders). Whole models: the
LM bars of tests/test_torch_lm.py, 1e-2 of max |logit| (forward, decode
steps) and 3e-2 (``serve_lm`` and the batcher, teacher-forced; tokens
equal where the reference's top-2 gap exceeds the bar).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.runtime import scheduler as ref_sched  # noqa: E402
from repro_torch import checks as C  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.serve import ServeConfig, serve, serve_lm  # noqa: E402
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.layers import SparseWeight  # noqa: E402
from repro_torch.models.layers import tensor_from_numpy as _t  # noqa: E402
from repro_torch.runtime.scheduler import (ContinuousBatcher, Request,  # noqa: E402
                                           make_per_slot_decode,
                                           make_slot_cache)

MOE_ARCHS = ["granite-moe-3b-a800m", "moonshot-v1-16b-a3b"]
VLM = "llava-next-mistral-7b"
LOGIT_RTOL = 1e-2
SERVE_RTOL = 3e-2
# Whole models: the router's input differs from the reference's by the
# LM bar's activations (by design in the prefill attention, by bf16
# roundings taken in other orders elsewhere; the reference's own
# compiled forward is not its eager layers to the bit), so a token
# whose k-th and (k+1)-th probabilities lie close (relative) may take
# another expert there. Over this file's whole-model inputs the port
# and the reference route 5 tokens otherwise, at gaps of 5.9e-3
# (forward), 4.2e-3 (decode steps) and 1.4e-3 (serve_lm); the margin is
# 1.7x the largest
MODEL_TIE_MARGIN = 1e-2
# Each whole-model test holds at least the tokens it held when measured
# at this margin, less 10% (rounded down); the measured counts stand
# beside each floor.


def _numpy_tree(tree):
    if isinstance(tree, ref_layers.SparseWeight):
        return {"vals": np.asarray(tree.vals), "idx": np.asarray(tree.idx),
                "d_in": tree.d_in}
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


@functools.lru_cache(maxsize=None)
def _model(arch: str):
    """(reference cfg, port cfg, reference params, port params)."""
    rcfg = ref_reduced(ref_get_config(arch))
    cfg = reduced(get_config(arch))
    rparams = jax.jit(lambda k: ref_lm.init_params(rcfg, k))(
        jax.random.PRNGKey(0))
    return rcfg, cfg, rparams, lm.params_from_numpy(_numpy_tree(rparams),
                                                    device="cpu")


def _layer0_moe(arch=MOE_ARCHS[0]):
    rcfg, cfg, rparams, params = _model(arch)
    rp = jax.tree.map(lambda a: a[0], rparams["blocks"]["moe"])
    return rcfg, cfg, rp, lm._layer(params["blocks"], 0)["moe"]


def _bf16(a):
    return np.asarray(jnp.asarray(np.asarray(a, np.float32)).astype(
        jnp.bfloat16))


def _tokens(seed, b, t, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, t),
                                                dtype=np.int32)


def _within(got, want, rtol=LOGIT_RTOL):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()), err
    return err


def _ulp_close(got, want, rows=None):
    """Within 1 bf16 ulp (rtol 2**-7 plus the bf16 spacing at the
    output's scale), on ``rows`` of the (n, d) outputs if given."""
    got = got.float().numpy().reshape(-1, got.shape[-1])
    want = np.asarray(want, np.float32).reshape(got.shape)
    if rows is not None:
        got, want = got[rows], want[rows]
    scale = float(np.abs(want).max()) if want.size else 0.0
    atol = 2.0 ** (np.floor(np.log2(scale)) - 7) if scale > 0 else 0.0
    assert np.isfinite(got).all()
    np.testing.assert_array_less(np.abs(got - want),
                                 2.0 ** -7 * np.abs(want) + atol + 1e-30)


def _held(routes, b, t, margin=MODEL_TIE_MARGIN, held_rows=None):
    return C.held_tokens(routes, b, t, margin, held_rows)


def _ref_route(rp, rcfg, x, capacity_factor):
    """The reference's routing in ``_moe_local``
    (src/repro/models/layers.py:501-518), step for step: (expert ids (n,
    k), the (e, cap) slot table, n in an empty slot)."""
    b, t, d = x.shape
    e, k = rcfg.n_experts, rcfg.top_k
    n = b * t
    logits = jnp.einsum("nd,de->ne", x.reshape(n, d).astype(jnp.float32),
                        rp["router"])
    _, eidx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    cap = max(min(int(capacity_factor * n * k / e), n), 1)
    flat_e = eidx.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    offsets = jnp.searchsorted(flat_e[order], jnp.arange(e + 1))
    slot = offsets[:-1, None] + jnp.arange(cap)[None]
    valid = slot < offsets[1:, None]
    tok = jnp.where(valid, (order // k)[jnp.clip(slot, 0, n * k - 1)], n)
    return np.asarray(eidx), np.asarray(tok)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("b,t", [(2, 24), (4, 1), (1, 1)])
def test_moe_matches_reference(b, t, capacity_factor):
    """The MoE layer on the same bf16 input as the reference's: the same
    expert ids, slot table and kept assignments, the output within 1
    bf16 ulp, aux within 1e-6 relative; at capacity factor 0.5 experts
    overflow and assignments are dropped. (4, 1) is a decode step of 4
    rows routed together: cap = 1 at 0.5; (1, 1) one token, whose 2
    assignments leave 2 of the 4 experts unchosen (they run on pad rows)."""
    rcfg, cfg, rp, p = _layer0_moe()
    x = _bf16(np.random.default_rng([b, t]).normal(size=(b, t,
                                                         cfg.d_model)))
    want, raux = ref_layers.moe(rp, rcfg, jnp.asarray(x),
                                capacity_factor=capacity_factor)
    with L.record_moe() as routes:
        got, aux = L.moe(p, cfg, _t(x), capacity_factor=capacity_factor)
    (r,) = routes
    assert got.dtype == torch.bfloat16 and got.shape == (b, t, cfg.d_model)
    near, touched = C.ties(r, C.MOE_TIE_MARGIN)
    clear = C.clear(r, C.MOE_TIE_MARGIN)[0].numpy()
    print(f"tokens excluded by the tie margin: {int((~clear).sum())} of "
          f"{clear.size}")
    assert clear.mean() >= 0.9
    reidx, rtok = _ref_route(rp, rcfg, jnp.asarray(x), capacity_factor)
    np.testing.assert_array_equal(r.eidx[0].numpy()[clear], reidx[clear])
    same = ~touched[0].numpy()
    np.testing.assert_array_equal(r.tok_for_slot[0].numpy()[same],
                                  rtok[same])
    rkept = np.array([[(rtok[ex] == i).any() for ex in reidx[i]]
                      for i in range(b * t)])
    np.testing.assert_array_equal(r.kept[0].numpy()[clear], rkept[clear])
    dropped = int(r.dropped)
    assert dropped == int((~rkept).sum())
    if capacity_factor < 1 and b * t > 1:     # one token never overflows
        assert dropped > 0
    _ulp_close(got, want, rows=clear)
    assert abs(float(aux) - float(raux)) <= 1e-6 * abs(float(raux))


@pytest.mark.parametrize("b,t", [(1, 1), (4, 1), (2, 2), (3, 5)])
def test_moe_with_unchosen_experts_matches_reference(b, t):
    """16 experts top-3 at decode-step shapes: with fewer assignments
    than experts (1 or 4 tokens) some experts are chosen by no token and
    run on pad rows alone, adding nothing; the output is the reference's
    within 1 bf16 ulp, aux within 1e-6; 15 tokens make 45 assignments."""
    rcfg, cfg = (dataclasses.replace(c, n_experts=16, top_k=3) for c in (
        ref_reduced(ref_get_config(MOE_ARCHS[1])),
        reduced(get_config(MOE_ARCHS[1]))))
    rp = ref_layers.init_moe(jax.random.PRNGKey(7), rcfg)
    p = lm.params_from_numpy(_numpy_tree(rp), device="cpu")
    x = _bf16(np.random.default_rng([b, t, 7]).normal(
        size=(b, t, cfg.d_model)))
    want, raux = ref_layers.moe(rp, rcfg, jnp.asarray(x), capacity_factor=1.0)
    with L.record_moe() as routes:
        got, aux = L.moe(p, cfg, _t(x), capacity_factor=1.0)
    if b * t * 3 < 16:
        assert torch.unique(routes[0].eidx).numel() < 16
    clear = C.clear(routes[0], C.MOE_TIE_MARGIN)[0].numpy()
    _ulp_close(got, want, rows=clear)
    assert abs(float(aux) - float(raux)) <= 1e-6 * abs(float(raux))


@pytest.mark.parametrize("b,t", [(2, 24), (3, 5)])
def test_moe_dp_groups_match_reference(b, t):
    """``set_moe_dp(2)`` on both: two contiguous groups of the flattened
    tokens, each with its own capacity, aux their mean; 15 tokens do not
    split in two, so both route them together."""
    rcfg, cfg, rp, p = _layer0_moe()
    x = _bf16(np.random.default_rng(4).normal(size=(b, t, cfg.d_model)))
    try:
        ref_layers.set_moe_dp(2)
        L.set_moe_dp(2)
        want, raux = ref_layers.moe(rp, rcfg, jnp.asarray(x),
                                    capacity_factor=0.5)
        with L.record_moe() as routes:
            got, aux = L.moe(p, cfg, _t(x), capacity_factor=0.5)
    finally:
        ref_layers.set_moe_dp(1)
        L.set_moe_dp(1)
    (r,) = routes
    assert r.eidx.shape[0] == (2 if (b * t) % 2 == 0 else 1)
    clear = C.clear(r, C.MOE_TIE_MARGIN).reshape(-1).numpy()
    assert clear.mean() >= 0.9
    _ulp_close(got, want, rows=clear)
    assert abs(float(aux) - float(raux)) <= 1e-6 * abs(float(raux))
    assert L._MOE["dp"] == 1


def test_moe_without_drops_is_each_tokens_gated_expert_sum():
    """At capacity factor e / k every expert has a slot for every token,
    so nothing is dropped, and ``moe`` is each token's sum over its top-k
    experts of gate x expert(x), computed here directly, token by token,
    at the same dtype boundaries (no sort, no slot table)."""
    _, cfg, _, p = _layer0_moe()
    e, k = cfg.n_experts, cfg.top_k
    x = _t(_bf16(np.random.default_rng(9).normal(size=(3, 7, cfg.d_model))))
    with L.record_moe() as routes:
        got, _ = L.moe(p, cfg, x, capacity_factor=e / k)
    assert int(routes[0].dropped) == 0
    want = torch.empty_like(got)
    for i, row in enumerate(x.reshape(-1, cfg.d_model)):
        probs = torch.softmax(row.float() @ p["router"], dim=-1)
        gate, ids = torch.topk(probs, k)
        gate = gate / gate.sum()
        acc = torch.zeros(cfg.d_model)
        for g, ex in sorted(zip(gate.tolist(), ids.tolist()),
                            key=lambda ge: ge[1]):
            h = torch.nn.functional.silu(
                (row.float() @ p["w1"][ex].float()).bfloat16().float()
            ).bfloat16()
            h = h * (row.float() @ p["w3"][ex].float()).bfloat16()
            y = (h.float() @ p["w2"][ex].float()).bfloat16()
            acc = acc + (y * torch.tensor(g).bfloat16()).float()
        want.view(-1, cfg.d_model)[i] = acc.bfloat16()
    _ulp_close(got, want.float().numpy())


def _within_held(got, want, held, rtol=LOGIT_RTOL):
    """``got`` within rtol of max |logit| at the held positions (the
    leading axes of the (..., V) logits)."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max(-1)[held]
    bad = err > rtol * float(np.abs(want).max())
    assert not bad.any(), err[bad]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_matches_reference(arch):
    """Reduced granite-moe (tied embeddings) and moonshot (untied), six
    prompts of 4 x 8 tokens: the prefill forward's logits within the LM
    bar at every held token (``_held``; 113 of 192 held); aux
    (the sum over layers of each layer's load-balance loss) that of the
    port's routes, and, where every token is held (the same routing),
    the reference's within 1e-4 relative (its router probabilities move
    with activations that differ at the LM bar); ``make_prefill_step``
    the forward's last position."""
    rcfg, cfg, rparams, params = _model(arch)
    held_total = whole = 0
    for seed in range(6):
        toks = _tokens(seed, 4, 8, cfg.vocab_size)
        ops.reset_launches()
        with L.record_moe() as routes:
            got, aux = lm.forward(cfg, params, torch.from_numpy(toks))
        assert not any(ops.LAUNCHES.values())      # CPU: the plain versions
        assert len(routes) == cfg.n_layers
        want, raux = ref_lm.forward(rcfg, rparams, jnp.asarray(toks))
        held = _held(routes, 4, 8)
        _within_held(got, want, held)
        held_total += int(held.sum())
        if held.all():
            whole += 1
            assert abs(float(aux) - float(raux)) <= 1e-4 * abs(float(raux))
        assert float(aux) == pytest.approx(sum(
            float((r.probs.mean(1) * r.counts / r.counts.sum(
                -1, keepdim=True) * cfg.n_experts).sum()) for r in routes),
            rel=1e-6)
    print(f"held tokens: {held_total} of {6 * 32}; prompts held whole: "
          f"{whole}")
    assert held_total >= 101 and whole >= 2        # measured 113 of 192, 2
    last = make_prefill_step(cfg)(params, torch.from_numpy(toks))
    torch.testing.assert_close(last, got[:, -1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_steps_match_reference(arch):
    """Four prompts of 3 rows, 10 decode steps each at an int position
    (the batch's 3 tokens routed together, cap 1, as in the reference's
    ``decode_step``): within the bar at every held row (a row stays lost
    once a near tie may have moved its activations: its cache holds
    them), and the held rows' KV cache."""
    rcfg, cfg, rparams, params = _model(arch)
    step = jax.jit(lambda p, c, tk, i: ref_lm.decode_step(rcfg, p, c, tk, i))
    compared = 0
    for seed in range(4):
        toks = _tokens(11 + seed, 3, 10, cfg.vocab_size)
        rcache = ref_lm.init_cache(rcfg, 3, 16)
        cache = lm.init_cache(cfg, 3, 16, device="cpu")
        rows = np.ones(3, bool)
        for i in range(10):
            want, rcache = step(rparams, rcache,
                                jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
            with L.record_moe() as routes:
                got, cache = lm.decode_step(
                    cfg, params, cache, torch.from_numpy(toks[:, i:i + 1]),
                    i)
            assert got.shape == (3, 1, cfg.vocab_size)
            assert all(r.eidx.shape[:2] == (1, 3) and r.cap == 1
                       for r in routes)
            rows = _held(routes, 3, 1, MODEL_TIE_MARGIN, rows)[:, 0]
            _within_held(got[:, 0], want[:, 0], rows)
            compared += int(rows.sum())
        if rows.any():
            _within(cache["kv"][:, :, rows],
                    np.asarray(rcache["kv"])[:, :, rows])
    print(f"row steps compared: {compared} of 120")
    assert compared >= 45                  # measured 51 of 120


def _teacher_forced(rcfg, rparams, prompts, out, gen, held_log):
    """The reference's decode loop fed the port's tokens: every step's
    logits within the serve bar at the rows held (``held_log``: one (B,)
    mask a step), the port's tokens the reference's there where its
    top-2 gap exceeds the bar. Returns the tokens so checked."""
    step = jax.jit(lambda p, c, tk, i: ref_lm.decode_step(rcfg, p, c, tk, i))
    b, tp = prompts.shape
    cache = ref_lm.init_cache(rcfg, b, tp + gen)
    fed = np.concatenate([prompts, out["tokens"][:, :-1]], 1)
    checked = 0
    for i in range(tp + gen - 1):
        want, cache = step(rparams, cache, jnp.asarray(fed[:, i:i + 1]),
                           jnp.int32(i))
        want = np.asarray(want[:, 0], np.float32)
        rows = held_log[i]
        _within_held(out["logits"][:, i], want, rows, rtol=SERVE_RTOL)
        if i >= tp - 1:
            bar = SERVE_RTOL * float(np.abs(want).max())
            top2 = np.sort(want, -1)[:, -2:]
            clear = (top2[:, 1] - top2[:, 0] > bar) & rows
            np.testing.assert_array_equal(
                out["tokens"][:, i - tp + 1][clear], want.argmax(-1)[clear])
            checked += int(clear.sum())
    return checked


@pytest.mark.parametrize("arch", MOE_ARCHS + [VLM])
def test_serve_lm_matches_reference(arch):
    """``serve_lm`` on the reference's weights and explicit prompts,
    replayed teacher-forced through the reference's decode: every step
    within 3e-2 of max |logit| at the held rows (``_held`` over each
    step's routing, the batch's rows routed together), tokens equal
    there where the top-2 gap clears the bar. The VLM is served on its
    tokens alone: the reference's ``serve_lm`` draws patches that its
    decode step never reads; it has no router, so every row is held."""
    rcfg, cfg, rparams, params = _model(arch)
    prompts = _tokens(13, 4, 8, cfg.vocab_size)
    gen = 6
    ops.reset_launches()
    with L.record_moe() as routes:
        out = serve_lm(arch, prompts=prompts, params=params, gen_tokens=gen,
                       max_seq=16, record_logits=True, verbose=False,
                       device="cpu")
    assert not any(ops.LAUNCHES.values())
    assert out["tokens"].shape == (4, gen)
    np.testing.assert_array_equal(
        out["tokens"], out["logits"][:, 7:-1].argmax(-1).numpy())
    n_l = cfg.n_layers if cfg.family == "moe" else 0
    assert len(routes) == n_l * (8 + gen)
    rows, held_log = np.ones(4, bool), []
    for s in range(8 + gen):
        rows = _held(routes[s * n_l:(s + 1) * n_l], 4, 1, MODEL_TIE_MARGIN,
                     rows)[:, 0]
        held_log.append(rows)
    checked = _teacher_forced(rcfg, rparams, prompts, out, gen, held_log)
    held_steps = int(np.sum(held_log[:-1]))
    print(f"row steps held: {held_steps} of {4 * (7 + gen)}; tokens "
          f"checked: {checked} of {4 * gen}")
    # measured: granite-moe 40 of 52 row steps held, 12 tokens checked;
    # moonshot 32, 2; llava 52, 18
    floors = {"granite-moe-3b-a800m": (36, 10), "moonshot-v1-16b-a3b": (28, 1),
              VLM: (52, 18)}[arch]
    assert held_steps >= floors[0] and checked >= floors[1]


def test_serve_dispatches_moe_and_vlm_archs_to_serve_lm():
    for arch in (MOE_ARCHS[0], VLM):
        out = serve(ServeConfig(arch=arch, batch=2, device="cpu",
                                verbose=False))
        assert out["tokens"].shape == (2, 16) and out["device"] == "cpu"


def _batcher(cfg, params, slots, max_seq, decode_fn):
    return ContinuousBatcher(
        cfg, params, slots=slots, max_seq=max_seq, decode_fn=decode_fn,
        init_cache_fn=lambda c, s, m: make_slot_cache(c, s, m, device="cpu"))


def _recording(decode, logs):
    def rec(params, cache, toks, pos):
        lg, cache = decode(params, cache, toks, pos)
        logs.append((np.asarray(toks).copy(), np.asarray(pos).copy(),
                     np.asarray(lg[:, -1], np.float32)))
        return lg, cache
    return rec


def test_moe_batcher_matches_reference_batcher():
    """Reduced granite-moe through the reference's batcher and the
    port's, the same requests: the same schedule, each step routed one
    slot a group (3 groups of one token: nothing is dropped), and the
    reference's vmapped per-slot decode, fed the port's tokens and
    positions, gives every step's logits within the serve bar and the
    same token where its top-2 gap clears the bar, for each request up
    to its first near tie (its cache may differ from there)."""
    rcfg, cfg, rparams, params = _model(MOE_ARCHS[0])
    rng = np.random.default_rng(1)
    reqs = [dict(rid=rid, prompt=rng.integers(
        0, cfg.vocab_size, size=rng.integers(2, 9)).astype(np.int32),
        max_new_tokens=int(rng.integers(2, 7))) for rid in range(6)]
    rlogs, logs, slot_rids = [], [], []
    rcb = ref_sched.ContinuousBatcher(
        rcfg, rparams, slots=3, max_seq=32,
        decode_fn=_recording(ref_sched.make_per_slot_decode(rcfg), rlogs),
        init_cache_fn=lambda c, s, m: ref_sched.make_slot_cache(c, s, m))
    record = _recording(make_per_slot_decode(cfg), logs)

    def decode(p, cache, toks, pos):
        slot_rids.append([st.rid for st in cb.state])
        return record(p, cache, toks, pos)

    cb = _batcher(cfg, params, 3, 32, decode)
    for kw in reqs:
        rcb.submit(ref_sched.Request(**kw))
        cb.submit(Request(**kw))
    rdone = rcb.run()
    with L.record_moe() as routes:
        done = cb.run()
    n_l = cfg.n_layers
    assert len(routes) == cb.steps * n_l
    assert all(r.eidx.shape[:2] == (3, 1) and int(r.dropped) == 0
               for r in routes)
    assert cb.steps == rcb.steps == len(logs) == len(rlogs)
    assert [r.rid for r in done] == [r.rid for r in rdone]
    decode_ref = ref_sched.make_per_slot_decode(rcfg)
    rcache = ref_sched.make_slot_cache(rcfg, 3, 32)
    lost, compared = set(), 0
    for s, ((toks, pos, got), (_, rpos, _)) in enumerate(zip(logs, rlogs)):
        np.testing.assert_array_equal(pos, rpos)
        want, rcache = decode_ref(rparams, rcache, jnp.asarray(toks),
                                  jnp.asarray(pos.astype(np.int32)))
        want = np.asarray(want[:, -1], np.float32)
        near = np.stack([C.gap(r)[:, 0].numpy() < MODEL_TIE_MARGIN
                         for r in routes[s * n_l:(s + 1) * n_l]]).any(0)
        lost |= {rid for rid, nr in zip(slot_rids[s], near) if nr}
        rows = np.array([rid >= 0 and rid not in lost
                         for rid in slot_rids[s]])
        bar = SERVE_RTOL * float(np.abs(want).max())
        _within_held(torch.from_numpy(got), want, rows, rtol=SERVE_RTOL)
        top2 = np.sort(want, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0] > bar) & rows
        np.testing.assert_array_equal(got.argmax(-1)[clear],
                                      want.argmax(-1)[clear])
        compared += int(clear.sum())
    print(f"requests lost to a near tie: {sorted(lost)}; tokens compared "
          f"{compared} of {3 * len(logs)}")
    assert compared >= 23                  # measured 26 of 60


def test_per_slot_routing_differs_from_joint_routing_where_a_drop_occurs():
    """Four equal rows at position 0: routed together (an int position,
    the reference's ``decode_step``) each of their two experts gets 4
    assignments for cap = 2, so rows 2 and 3 lose both and their logits
    part from rows 0 and 1; routed one row a group (a (B,) position,
    the reference's vmapped per-slot decode) nothing is dropped and the
    four rows agree. Each against its reference counterpart."""
    rcfg, cfg, rparams, params = _model(MOE_ARCHS[0])
    toks = np.full((4, 1), 7, np.int32)
    with L.record_moe() as joint_routes:
        joint, _ = lm.decode_step(cfg, params,
                                  lm.init_cache(cfg, 4, 8, device="cpu"),
                                  torch.from_numpy(toks), 0)
    with L.record_moe() as slot_routes:
        per_slot, _ = lm.decode_step(cfg, params,
                                     lm.init_cache(cfg, 4, 8, device="cpu"),
                                     torch.from_numpy(toks),
                                     torch.zeros(4, dtype=torch.long))
    assert joint_routes[0].cap == 2 and int(joint_routes[0].dropped) == 4
    assert all(int(r.dropped) == 0 for r in slot_routes)
    rjoint, _ = ref_lm.decode_step(rcfg, rparams,
                                   ref_lm.init_cache(rcfg, 4, 8),
                                   jnp.asarray(toks), jnp.int32(0))
    rslot, _ = ref_sched.make_per_slot_decode(rcfg)(
        rparams, ref_sched.make_slot_cache(rcfg, 4, 8), jnp.asarray(toks),
        jnp.zeros(4, jnp.int32))
    _within(joint[:, 0], rjoint[:, 0])
    _within(per_slot[:, 0], np.asarray(rslot)[:, -1])
    scale = float(joint.abs().max())
    assert float((joint[2:] - joint[:2]).abs().max()) > LOGIT_RTOL * scale
    assert torch.equal(joint[:2], per_slot[:2])
    assert all(torch.equal(per_slot[0], per_slot[r]) for r in range(1, 4))


def _ref_chunk(rcfg, rparams, kv, toks, pos):
    """The reference's layers composed on one chunk of tokens at pos ..
    pos + T - 1 (its ``kv_len`` attention, then its ``moe`` over the
    chunk's B * T tokens): (logits, the new kv stack)."""
    b, t = toks.shape
    positions = jnp.broadcast_to(jnp.arange(pos, pos + t)[None], (b, t))
    h = ref_lm._embed(rcfg, rparams, jnp.asarray(toks))
    new = []
    for l in range(rcfg.n_layers):
        p = jax.tree.map(lambda a: a[l], rparams["blocks"])
        a, (ck, cv) = ref_layers.attention(
            p["attn"], rcfg, ref_layers.rms_norm(h, p["ln1"], rcfg.norm_eps),
            positions=positions, kv_cache=(kv[l, 0], kv[l, 1]),
            cache_pos=jnp.int32(pos))
        h = h + a
        mo, _ = ref_layers.moe(p["moe"], rcfg, ref_layers.rms_norm(
            h, p["ln2"], rcfg.norm_eps))
        h = h + mo
        new.append(jnp.stack([ck, cv]))
    return ref_lm._logits(rcfg, rparams, h), jnp.stack(new)


def test_moe_prefill_chunk_matches_reference_layers_on_the_chunk():
    """``prefill_chunk`` on an MoE model routes a chunk's B * T tokens
    together: held to the reference's layers composed on the same chunk
    (within the bar at the held tokens, a row lost from a near tie on;
    the held rows' cache too), not to the one-shot forward, whose
    routing group is the whole prompt."""
    rcfg, cfg, rparams, params = _model(MOE_ARCHS[0])
    toks = _tokens(21, 2, 14, cfg.vocab_size)
    cache = lm.init_cache(cfg, 2, 16, device="cpu")
    rkv = jnp.zeros_like(ref_lm.init_cache(rcfg, 2, 16)["kv"])
    rows = np.ones(2, bool)
    compared = 0
    for a, b in ((0, 5), (5, 6), (6, 14)):
        with L.record_moe() as routes:
            got, cache = lm.prefill_chunk(cfg, params, cache,
                                          torch.from_numpy(toks[:, a:b]), a)
        assert all(r.eidx.shape[:2] == (1, 2 * (b - a)) for r in routes)
        want, rkv = _ref_chunk(rcfg, rparams, rkv, toks[:, a:b], a)
        held = _held(routes, 2, b - a, MODEL_TIE_MARGIN, rows)
        _within_held(got, want, held)
        compared += int(held.sum())
        rows = held[:, -1]
    print(f"tokens compared: {compared} of {2 * 14}")
    assert compared >= 25                  # measured 28 of 28
    _within(cache["kv"][:, :, rows], np.asarray(rkv)[:, :, rows])


def _patches(seed, b, cfg):
    return _bf16(np.random.default_rng(seed).normal(
        size=(b, cfg.vision_tokens, cfg.d_model)))


def test_vlm_forward_with_patches_matches_reference():
    """Reduced llava: 16 patch embeddings in front of 12 tokens, the
    positions over all 28; the logits within the bar, and
    ``make_prefill_step(**extra)`` the reference's prefill step (its
    tokens are T - vision_tokens)."""
    rcfg, cfg, rparams, params = _model(VLM)
    assert cfg.family == "vlm" and "ffn" in params["blocks"]
    assert isinstance(params["blocks"]["ffn"]["w1"], SparseWeight)
    toks = _tokens(41, 2, 12, cfg.vocab_size)
    patches = _patches(42, 2, cfg)
    got, aux = lm.forward(cfg, params, torch.from_numpy(toks),
                          extra={"patches": _t(patches)})
    want, _ = ref_lm.forward(rcfg, rparams, jnp.asarray(toks),
                             extra={"patches": jnp.asarray(patches)})
    assert got.shape == (2, cfg.vision_tokens + 12, cfg.vocab_size)
    assert float(aux) == 0.0
    _within(got, want)
    last = make_prefill_step(cfg)(params, torch.from_numpy(toks),
                                  patches=_t(patches))
    rlast = ref_steps.make_prefill_step(rcfg)(
        rparams, jnp.asarray(toks), patches=jnp.asarray(patches))
    assert last.shape == (2, cfg.vocab_size)
    _within(last, rlast)
    # f32 patches are cast to bf16, as the reference's astype(h.dtype)
    f32, _ = lm.forward(cfg, params, torch.from_numpy(toks),
                        extra={"patches": _t(patches).float()})
    assert torch.equal(f32, got)


def test_extra_inputs_are_checked():
    """A VLM forward without patches, or with patches of another width,
    and patches to a family that takes none are refused."""
    _, cfg, _, params = _model(VLM)
    toks = torch.zeros(2, 3, dtype=torch.long)
    with pytest.raises(ValueError, match="patches"):
        lm.forward(cfg, params, toks)
    with pytest.raises(ValueError, match="expected"):
        lm.forward(cfg, params, toks, extra={
            "patches": torch.zeros(2, 4, cfg.d_model + 1)})
    _, mcfg, _, mparams = _model(MOE_ARCHS[0])
    with pytest.raises(ValueError, match="takes no extra inputs"):
        lm.forward(mcfg, mparams, toks, extra={
            "patches": torch.zeros(2, 4, mcfg.d_model)})


def _port_leaves(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_leaves(v, path + (k,)))
        return out
    if isinstance(tree, SparseWeight):
        return {path + ("vals",): tree.vals, path + ("idx",): tree.idx}
    return {path: tree}


def _ref_leaves(tree):
    def name(k):
        k = k.key
        return ("vals", "idx")[k] if isinstance(k, int) else k
    return {tuple(map(name, path)): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("arch", MOE_ARCHS + [VLM])
def test_params_round_trip_and_init_layout(arch):
    """``params_from_numpy`` carries the reference's MoE and VLM trees
    bit for bit (the f32 router (L, d, e), the bf16 experts (L, e, d, f)
    and (L, e, f, d)); ``init_params`` draws the same leaves, shapes and
    dtypes."""
    _, cfg, rparams, params = _model(arch)
    ref = _ref_leaves(rparams)
    for port in (_port_leaves(params), _port_leaves(
            lm.init_params(cfg, torch.Generator().manual_seed(0)))):
        assert set(port) == set(ref)
        for key, want in ref.items():
            assert tuple(port[key].shape) == want.shape, key
            assert str(port[key].dtype).split(".")[1] == want.dtype.name, key
    port = _port_leaves(params)
    if cfg.family == "moe":
        assert port[("blocks", "moe", "router")].dtype == torch.float32
        assert tuple(port[("blocks", "moe", "w2")].shape) == (
            cfg.n_layers, cfg.n_experts, cfg.moe_d_ff, cfg.d_model)
    for key, want in ref.items():
        got = port[key]
        if want.dtype.name == "bfloat16":
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          want.view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ["smollm-360m", MOE_ARCHS[0], VLM])
def test_init_params_stack_is_each_layers_draws(arch):
    """``init_params`` allocates each stacked leaf once and draws layer l
    into its slice: the stack equals the per-layer trees drawn in turn
    from the same generator, bit for bit (the law and the order of draws
    unchanged)."""
    cfg = reduced(get_config(arch))
    params = lm.init_params(cfg, torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    lm.L.dense_init(gen, (cfg.vocab_size, cfg.d_model), cfg.d_model)
    for l in range(cfg.n_layers):
        want = _port_leaves(lm._init_block(cfg, gen))
        got = _port_leaves(lm._layer(params["blocks"], l))
        assert set(got) == set(want)
        for key in want:
            assert torch.equal(got[key], want[key]), (l, key)


def test_moe_combine_is_the_same_bits_run_to_run():
    """The combine sums each token's kept slots in one fixed order (no
    scatter-add): two runs give the same bits."""
    _, cfg, _, p = _layer0_moe()
    x = _t(_bf16(np.random.default_rng(3).normal(size=(2, 40, cfg.d_model))))
    a, _ = L.moe(p, cfg, x, capacity_factor=0.75)
    b, _ = L.moe(p, cfg, x, capacity_factor=0.75)
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_moe_config_reduced_sizes():
    """The reduced MoE configs the tests run: 4 experts, top-2, expert
    FFN 64, 2 layers (the published ones: 40 experts top-8, f 512;
    64 top-6, f 1408)."""
    for arch, full in zip(MOE_ARCHS, [(40, 8, 512), (64, 6, 1408)]):
        cfg = get_config(arch)
        assert (cfg.n_experts, cfg.top_k, cfg.moe_d_ff) == full
        r = reduced(cfg)
        assert (r.n_experts, r.top_k, r.moe_d_ff, r.n_layers) == (4, 2, 64, 2)
        assert dataclasses.asdict(r) == dataclasses.asdict(
            dataclasses.replace(r))


def test_tie_rules_of_clear_and_held_tokens():
    """Four one-token rows, 3 experts top-1, cap 1: row 1 sits within
    1e-5 of a tie between experts 1 and 0, and expert 0 overflows (rows
    0 and 2 chose it, row 2 is dropped). ``clear`` loses row 1 and row
    2 (its expert is full and the near row may join it), keeps row 0
    (it holds the slot) and row 3 (expert 2 is out of the near row's
    reach); ``held_tokens`` loses every token after the first near one
    that sits at a full expert, and everything after a row lost before
    the call."""
    cfg = dataclasses.replace(reduced(get_config(MOE_ARCHS[0])),
                              n_experts=3, top_k=1)
    x = torch.tensor([[[1.0, 0.0, -1.0], [0.5, 0.5 + 1e-5, 0.0],
                       [2.0, 0.0, 0.0], [0.0, 0.0, 2.0]]])
    r = L.moe_route(torch.eye(3), cfg, x, 1.0)
    assert r.cap == 1 and r.eidx[0, :, 0].tolist() == [0, 1, 0, 2]
    assert r.kept[0, :, 0].tolist() == [True, True, False, True]
    assert int(r.dropped) == 1
    near, touched = C.ties(r, 1e-4)
    assert near[0].tolist() == [False, True, False, False]
    assert touched[0].tolist() == [True, True, False]
    assert C.clear(r, 1e-4)[0].tolist() == [True, False, False, True]
    assert C.clear(r, 1e-6)[0].all()
    held = C.held_tokens([r], 4, 1, 1e-4)
    assert held[:, 0].tolist() == [True, False, False, False]
    assert C.held_tokens([r], 4, 1, 1e-6).all()
    assert not C.held_tokens([r], 4, 1, 1e-6,
                             held_rows=[False, True, True, True]).any()
    # one row of 4 tokens: the next layer's attention carries a loss on
    assert C.held_tokens([r, r], 1, 4, 1e-4)[0].tolist() == [
        True, False, False, False]
