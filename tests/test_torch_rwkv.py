"""The port's SSM family (rwkv6) against the JAX reference on the CPU, at
``reduced()`` size (2 layers, d 128, 4 heads of 32), on the reference's
own weights carried across with ``lm.params_from_numpy``: the chunked
WKV and its one-token step, the time-mix and channel-mix layers (outputs
and states, from a zero and from a carried state, at T no multiple of
the chunk of 64), an independent f64 token-by-token recurrence, the
whole model's ``forward``, ``decode_step`` and ``serve_lm``, the prompt
stepped through the cache against the one-shot forward, and the
continuous batcher with the state reset at admission.

Bars. The reference runs its ops one at a time (``jax.disable_jit``),
as the port does: its jitted program keeps f32 across ops that round to
bf16 alone (tests/_torch_lm_ref.py). The scans, fed the same f32 inputs,
sum in f32 in other orders: the WKV output and state within 1e-5 of
their max, 1e-4 against the f64 recurrence. A layer rounds its
projections to bf16, and a sum taken in another order may round an
element to the other side: its bf16 output within 1e-2 of its max
(measured 3.1e-3), its f32 WKV state within 1e-5 (measured 1.5e-7).
Whole models: the LM bars of tests/test_torch_lm.py, 1e-2 of max
|logit| (forward, decode steps; 3e-2 against the reference's jitted
forward, which parts from its own ops by 1.5e-2) and 3e-2 (``serve_lm``
and the batcher, teacher-forced).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_lm_ref as R  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.serve import ServeConfig, serve  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402

ARCH = "rwkv6-1.6b"
STATE_RTOL = 1e-5          # f32 sums in another order
LAYER_RTOL = 1e-2          # a layer's bf16 output, relative to its max


def _layer0():
    rcfg, cfg, rparams, params = R.model(ARCH)
    rp = jax.tree.map(lambda a: a[0], rparams["blocks"])
    return rcfg, cfg, rp, lm._layer(params["blocks"], 0)


def _wkv_inputs(seed, b, t, h, dh):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, t, h, dh)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.uniform(-6, 0.5, size=(b, t, h, dh))).astype(
        np.float32)
    u = rng.normal(size=(h, dh)).astype(np.float32) * 0.5
    s0 = rng.normal(size=(b, h, dh, dh)).astype(np.float32)
    return r, k, v, logw, u, s0


def _wkv_f64(r, k, v, logw, u, s0):
    """o_t = r_t . (S_{t-1} + diag(u) k_t v_t^T), S_t = diag(w_t) S_{t-1}
    + k_t v_t^T, token by token in f64."""
    r, k, v, w = (np.asarray(a, np.float64) for a in (r, k, v,
                                                      np.exp(logw)))
    S = np.asarray(s0, np.float64).copy()
    o = np.zeros_like(r)
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]       # (B, H, Dk, Dv)
        o[:, t] = np.einsum("bhd,bhde->bhe", r[:, t],
                            S + u[None, :, :, None] * kv)
        S = w[:, t, :, :, None] * S + kv
    return o, S


@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
def test_wkv_chunked_matches_reference(carried):
    """T 100: one full chunk of 64 and a padded one."""
    r, k, v, logw, u, s0 = _wkv_inputs(1, 2, 100, 3, 16)
    s0 = s0 if carried else None
    o, S = L.rwkv6_wkv_chunked(*map(torch.from_numpy, (r, k, v, logw, u)),
                               S0=None if s0 is None else torch.from_numpy(s0))
    ro, rS = ref_layers.rwkv6_wkv_chunked(*map(jnp.asarray,
                                                (r, k, v, logw, u)),
                                          S0=None if s0 is None
                                          else jnp.asarray(s0))
    R.within(o, ro, STATE_RTOL)
    R.within(S, rS, STATE_RTOL)


@pytest.mark.parametrize("t", [1, 70])
def test_wkv_scans_match_an_f64_recurrence(t):
    """Independent of the reference: the chunked WKV (T 70 over chunks of
    64, and T 1) and the one-token step of ``rwkv6_forward`` stepped T
    times against the recurrence written out token by token in f64."""
    r, k, v, logw, u, s0 = _wkv_inputs(2, 2, t, 3, 16)
    want_o, want_S = _wkv_f64(r, k, v, logw, u, s0)
    o, S = L.rwkv6_wkv_chunked(*map(torch.from_numpy, (r, k, v, logw, u)),
                               S0=torch.from_numpy(s0))
    R.within(o, want_o, 1e-4)
    R.within(S, want_S, 1e-4)
    # the one-token step's arithmetic (rwkv6_forward's t == 1 branch)
    S = torch.from_numpy(s0)
    for i in range(t):
        r1, k1, v1 = (torch.from_numpy(a[:, i]) for a in (r, k, v))
        o1 = L.fdot("bhd,bhde->bhe", r1, S) + L.fdot(
            "bhd,bhd,bhe->bhe", r1, torch.from_numpy(u)[None] * k1, v1)
        R.within(o1, want_o[:, i], 1e-4)
        S = S * torch.exp(torch.from_numpy(logw[:, i]))[..., None] + \
            L.fdot("bhd,bhe->bhde", k1, v1)
    R.within(S, want_S, 1e-4)


def _state(rcfg, seed, b):
    rng = np.random.default_rng(seed)
    x_prev = R.bf16(rng.normal(size=(b, 1, rcfg.d_model)))
    wkv = (rng.normal(size=(b, rcfg.n_heads, rcfg.head_dim, rcfg.head_dim))
           * 0.1).astype(np.float32)
    return x_prev, wkv


@pytest.mark.parametrize("t,carried", [(100, False), (100, True),
                                       (1, True)],
                         ids=["chunked-zero", "chunked-carried", "one-token"])
def test_rwkv6_forward_matches_reference(t, carried):
    """The time-mix layer: its output and its WKV state within the layer
    bars, its carried token shift bit for bit."""
    rcfg, cfg, rp, p = _layer0()
    x = R.bf16(np.random.default_rng(t).normal(size=(2, t, cfg.d_model)))
    x_prev, wkv = _state(rcfg, 3, 2)
    rstate = {"x_prev": jnp.asarray(x_prev), "wkv": jnp.asarray(wkv)} \
        if carried else None
    state = {"x_prev": R.t_(x_prev), "wkv": torch.from_numpy(wkv)} \
        if carried else None
    want, rst = R.eager(ref_layers.rwkv6_forward, rp["tmix"], rcfg,
                        jnp.asarray(x), state=rstate)
    got, st = L.rwkv6_forward(p["tmix"], cfg, R.t_(x), state=state)
    assert got.dtype == torch.bfloat16 and st["wkv"].dtype == torch.float32
    R.within(got, want, LAYER_RTOL)
    R.within(st["wkv"], rst["wkv"], STATE_RTOL)
    np.testing.assert_array_equal(st["x_prev"].view(torch.int16).numpy(),
                                  np.asarray(rst["x_prev"]).view(np.int16))


@pytest.mark.parametrize("carried", [False, True])
def test_rwkv_cmix_matches_reference(carried):
    rcfg, cfg, rp, p = _layer0()
    x = R.bf16(np.random.default_rng(5).normal(size=(2, 37, cfg.d_model)))
    x_prev = R.bf16(np.random.default_rng(6).normal(size=(2, 1, cfg.d_model)))
    want, rxp = ref_layers.rwkv_cmix(
        rp["cmix"], jnp.asarray(x),
        x_prev=jnp.asarray(x_prev) if carried else None)
    got, xp = L.rwkv_cmix(p["cmix"], R.t_(x),
                          x_prev=R.t_(x_prev) if carried else None)
    R.within(got, want, LAYER_RTOL)
    assert torch.equal(xp, R.t_(x)[:, -1:])
    np.testing.assert_array_equal(np.asarray(rxp).view(np.int16),
                                  xp.view(torch.int16).numpy())


def test_params_carry_across_bit_for_bit():
    """The f32 leaves (t_mix, c_mix, the decay LoRA and bias, bonus_u)
    and the bf16 ones keep their bits."""
    port = R.check_round_trip(ARCH)
    for leaf in ("t_mix", "decay_w1", "decay_w2", "decay_bias", "bonus_u"):
        assert port[("blocks", "tmix", leaf)].dtype == torch.float32
    assert port[("blocks", "cmix", "c_mix")].dtype == torch.float32


def test_forward_matches_reference():
    """T 70: a chunk of 64 and a padded one, in each of the two layers;
    no kernel launched (the CPU's plain path)."""
    _, cfg, _, _ = R.model(ARCH)
    ops.reset_launches()
    R.check_forward(ARCH, R.tokens(7, 2, 70, cfg.vocab_size))
    assert not any(ops.LAUNCHES.values())


def test_decode_steps_match_reference():
    """Ten steps through the cache: every step's logits, and at the end
    the token shifts and the WKV state of both layers."""
    _, cfg, _, _ = R.model(ARCH)
    cache, rcache = R.check_decode_steps(
        ARCH, R.tokens(11, 2, 10, cfg.vocab_size), 16)
    for k in ("x_prev_t", "x_prev_c", "wkv"):
        R.within(cache[k], rcache[k], R.LOGIT_RTOL)


def test_forward_equals_the_prompt_stepped_through_decode():
    """T 70 > the chunk of 64: the chunked scans of ``forward`` against
    the one-token recurrence of ``decode_step``, position by position
    (the reference's own consistency bar is 2e-2)."""
    _, cfg, _, params = R.model(ARCH)
    toks = R.tokens(12, 1, 70, cfg.vocab_size)
    full, _ = lm.forward(cfg, params, torch.from_numpy(toks))
    stepped, _ = R.stepped_logits(cfg, params, toks)
    R.within(stepped, full)


def test_serve_lm_matches_reference_decode_loop():
    """Explicit prompts on the reference's weights: every step's logits
    (teacher-forced on the port's tokens) within the serve bar, the
    greedy tokens the reference's where its top-2 gap clears the bar."""
    _, cfg, _, _ = R.model(ARCH)
    R.check_serve_lm(ARCH, R.tokens(13, 2, 8, cfg.vocab_size), 6, 16)


def test_serve_takes_rwkv6():
    """``serve`` dispatches the arch to ``serve_lm`` on the CPU: greedy
    tokens from the recurrent decode path, no kernel launched."""
    ops.reset_launches()
    out = serve(ServeConfig(arch=ARCH, batch=2, device="cpu", verbose=False))
    assert out["tokens"].shape == (2, 16) and out["device"] == "cpu"
    assert not any(ops.LAUNCHES.values())


def test_batcher_requests_equal_their_runs_from_a_zero_state():
    """8 requests through 3 slots, every slot reused: with the state
    reset at admission, each request's logits at every fed position
    equal its own run alone from a zero state (teacher-forced) within the
    serve bar, its tokens the alone run's where that run's top-2 gap
    clears the bar (26 of the 39 tokens when measured; the rest hang on
    near ties of these small random logits)."""
    _, cfg, _, _ = R.model(ARCH)
    reqs = R.requests(21, 8, cfg.vocab_size)
    done, logs, _ = R.run_batchers(ARCH, reqs, 3, 32)
    assert len(done) == 8
    assert R.check_batcher_against_alone(ARCH, done, logs) >= 23


def test_batcher_first_wave_matches_reference_batcher():
    """The requests admitted at the first step start from the zero state
    in both packages: their logits at every fed position within the
    serve bar of the reference's per-slot decode (its batcher's vmapped
    step) fed the same schedule."""
    _, cfg, _, _ = R.model(ARCH)
    reqs = R.requests(21, 8, cfg.vocab_size)
    _, logs, rlogs = R.run_batchers(ARCH, reqs, 3, 32)
    for rid in R.first_wave(reqs, 3):
        assert sorted(logs[rid]) == sorted(rlogs[rid])
        for p, want in rlogs[rid].items():
            R.within(logs[rid][p], want, R.SERVE_RTOL)


def test_reference_batcher_carries_state_into_a_reused_slot():
    """The reference resets a slot's position and nothing in its cache,
    so a request admitted into a reused slot starts from the state the
    slot's previous request left (and the token-0 steps it ran while
    free): at its first position its logits part from the port's, which
    start from the zero state, by far more than the bar."""
    _, cfg, _, _ = R.model(ARCH)
    reqs = R.requests(21, 8, cfg.vocab_size)
    _, logs, rlogs = R.run_batchers(ARCH, reqs, 3, 32)
    later = [r["rid"] for r in reqs if r["rid"] not in R.first_wave(reqs, 3)]
    errs = [float(np.abs(rlogs[rid][0] - logs[rid][0]).max()
                  / np.abs(logs[rid][0]).max()) for rid in later]
    assert min(errs) > 10 * R.SERVE_RTOL, errs
