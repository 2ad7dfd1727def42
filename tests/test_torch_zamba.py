"""The port's hybrid family (zamba2) against the JAX reference on the
CPU, at ``reduced()`` size (4 Mamba2 layers of 8 heads of 32, state 16,
the shared attention block after layers 1 and 3, window 64), on the
reference's own weights carried across with ``lm.params_from_numpy``:
the causal conv (its bf16 sums), the chunked SSD scan and the Mamba2
layer (outputs and states, from a zero and from a carried state, at T no
multiple of the chunk of 128, and the one-token step), an independent
f64 token-by-token recurrence, the whole model's ``forward``, the
per-slot decode step and the continuous batcher with the state reset at
admission. ``decode_step`` and ``serve_lm`` past the window and the
prompt stepped through the cache are in
``tests/test_torch_zamba_decode.py`` (split off so the two run side by
side).

Bars: as tests/test_torch_rwkv.py, against the reference's ops run one
at a time. The scan within 1e-5 of its max (f32 sums in another order),
1e-4 against the f64 recurrence; the layer's bf16 output within 1e-2 of
its max (measured 1.7e-3) and its f32 SSM state within 1e-5 (measured
6.6e-7); whole models 1e-2 of max |logit| (3e-2 against the reference's
jitted forward, which parts from its own ops by 1.3e-2), 3e-2 for
``serve_lm`` and the batcher.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_lm_ref as R  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.runtime.scheduler import (ContinuousBatcher,  # noqa: E402
                                           Request, make_per_slot_decode,
                                           make_slot_cache)

ARCH = "zamba2-7b"
STATE_RTOL = 1e-5
LAYER_RTOL = 1e-2
MIN_CLEAR = 20      # batcher tokens clear of a near tie: 23 measured, less 10%


def _layer0():
    rcfg, cfg, rparams, params = R.model(ARCH)
    rp = jax.tree.map(lambda a: a[0], rparams["blocks"])
    return rcfg, cfg, rp, lm._layer(params["blocks"], 0)


def test_reduced_config_has_two_sites_and_a_window_of_64():
    _, cfg, _, _ = R.model(ARCH)
    assert lm.attn_flags(cfg) == [False, True, False, True]
    assert (cfg.attn_window, cfg.head_dim, L._mamba_heads(cfg)) == \
        (64, 32, (8, 32))


@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
def test_causal_conv_sums_in_bf16_as_the_reference(carried):
    """The four taps summed in bf16, each product and partial sum rounded:
    bit for bit the reference's, and not what an f32 sum rounded once
    gives."""
    rng = np.random.default_rng(1)
    x = R.bf16(rng.normal(size=(2, 37, 48)))
    w = R.bf16(rng.normal(size=(4, 48)) * 0.5)
    st = R.bf16(rng.normal(size=(2, 3, 48))) if carried else None
    want, wst = ref_layers._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                        None if st is None
                                        else jnp.asarray(st))
    got, gst = L._causal_conv(R.t_(x), R.t_(w), None if st is None
                              else R.t_(st))
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))
    np.testing.assert_array_equal(gst.view(torch.int16).numpy(),
                                  np.asarray(wst).view(np.int16))
    xp = torch.cat([torch.zeros(2, 3, 48) if st is None
                    else R.t_(st).float(), R.t_(x).float()], 1)
    once = sum(xp[:, i:i + 37] * R.t_(w).float()[i]
               for i in range(4)).to(torch.bfloat16)
    assert not torch.equal(once, got)


def _ssd_inputs(seed, b, t, h, dh, n):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, h, dh)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, t, h)))).astype(np.float32)
    a_log = np.log(np.arange(1, h + 1, dtype=np.float32))
    B, C = (rng.normal(size=(b, t, n)).astype(np.float32) for _ in range(2))
    h0 = rng.normal(size=(b, h, n, dh)).astype(np.float32)
    return x, dt, a_log, B, C, h0


def _ssd_f64(x, dt, a_log, B, C, h0):
    """h_t = exp(a dt_t) h_{t-1} + dt_t B_t x_t^T, y_t = C_t . h_t, token by
    token in f64 (a = -exp(a_log))."""
    x, dt, B, C = (np.asarray(v, np.float64) for v in (x, dt, B, C))
    a = -np.exp(np.asarray(a_log, np.float64))
    h = np.asarray(h0, np.float64).copy()
    y = np.zeros_like(x)
    for t in range(x.shape[1]):
        h = np.exp(a[None] * dt[:, t])[:, :, None, None] * h + \
            dt[:, t, :, None, None] * B[:, t, None, :, None] * \
            x[:, t, :, None, :]
        y[:, t] = np.einsum("bn,bhnd->bhd", C[:, t], h)
    return y, h


@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
def test_ssd_chunked_matches_reference(carried):
    """T 150: a chunk of 128 and a padded one."""
    x, dt, a_log, B, C, h0 = _ssd_inputs(2, 2, 150, 3, 8, 5)
    h0 = h0 if carried else None
    y, hT = L.mamba2_chunked(*map(torch.from_numpy, (x, dt, a_log, B, C)),
                             h0=None if h0 is None else torch.from_numpy(h0))
    ry, rh = ref_layers.mamba2_chunked(*map(jnp.asarray, (x, dt, a_log, B, C)),
                                       h0=None if h0 is None
                                       else jnp.asarray(h0))
    R.within(y, ry, STATE_RTOL)
    R.within(hT, rh, STATE_RTOL)


@pytest.mark.parametrize("t", [1, 150])
def test_ssd_scans_match_an_f64_recurrence(t):
    """Independent of the reference: the chunked scan and the one-token
    step of ``mamba2_forward`` stepped T times against the recurrence
    written out token by token in f64."""
    x, dt, a_log, B, C, h0 = _ssd_inputs(3, 2, t, 3, 8, 5)
    want_y, want_h = _ssd_f64(x, dt, a_log, B, C, h0)
    y, hT = L.mamba2_chunked(*map(torch.from_numpy, (x, dt, a_log, B, C)),
                             h0=torch.from_numpy(h0))
    R.within(y, want_y, 1e-4)
    R.within(hT, want_h, 1e-4)
    # the one-token step's arithmetic (mamba2_forward's t == 1 branch)
    h = torch.from_numpy(h0)
    for i in range(t):
        dt1 = torch.from_numpy(dt[:, i])
        decay = torch.exp(dt1 * -torch.exp(torch.from_numpy(a_log))[None])
        h = h * decay[:, :, None, None] + L.fdot(
            "bn,bh,bhd->bhnd", torch.from_numpy(B[:, i]), dt1,
            torch.from_numpy(x[:, i]))
        R.within(L.fdot("bn,bhnd->bhd", torch.from_numpy(C[:, i]), h),
                 want_y[:, i], 1e-4)
    R.within(h, want_h, 1e-4)


@pytest.mark.parametrize("t,carried", [(150, False), (40, True),
                                       (1, True)],
                         ids=["chunked-zero", "chunked-carried", "one-token"])
def test_mamba2_forward_matches_reference(t, carried):
    """The Mamba2 layer: its output and its SSM state within the layer
    bars, its conv state bit for bit (T 40 from a carried state: short
    enough that the carried state still weighs in the state at the
    end)."""
    rcfg, cfg, rp, p = _layer0()
    rng = np.random.default_rng(t)
    x = R.bf16(rng.normal(size=(2, t, cfg.d_model)))
    nh, dh = L._mamba_heads(cfg)
    width = cfg.ssm_expand * cfg.d_model + 2 * cfg.ssm_state
    conv = R.bf16(rng.normal(size=(2, cfg.ssm_conv - 1, width)))
    ssm = (rng.normal(size=(2, nh, cfg.ssm_state, dh)) * 0.1).astype(
        np.float32)
    rstate = {"conv": jnp.asarray(conv), "ssm": jnp.asarray(ssm)} \
        if carried else None
    state = {"conv": R.t_(conv), "ssm": torch.from_numpy(ssm)} \
        if carried else None
    want, rst = R.eager(ref_layers.mamba2_forward, rp["mamba"], rcfg,
                        jnp.asarray(x), state=rstate)
    got, st = L.mamba2_forward(p["mamba"], cfg, R.t_(x), state=state)
    assert got.dtype == torch.bfloat16 and st["ssm"].dtype == torch.float32
    R.within(got, want, LAYER_RTOL)
    R.within(st["ssm"], rst["ssm"], STATE_RTOL)
    np.testing.assert_array_equal(st["conv"].view(torch.int16).numpy(),
                                  np.asarray(rst["conv"]).view(np.int16))


def test_params_carry_across_bit_for_bit():
    """The shared block's tree (its FFN pruned at 16 x 16 here) and the
    Mamba2 layers' f32 leaves (A_log, D, dt_bias) keep their bits."""
    port = R.check_round_trip(ARCH)
    for leaf in ("A_log", "D", "dt_bias"):
        assert port[("blocks", "mamba", leaf)].dtype == torch.float32
    assert ("shared", "ffn", "w1", "vals") in port


def test_forward_matches_reference():
    """T 80 > the window of 64: the shared block's windowed attention
    (through flash's window) at both sites; the FFN pruned."""
    _, cfg, _, _ = R.model(ARCH)
    R.check_forward(ARCH, R.tokens(7, 2, 80, cfg.vocab_size))


def test_per_slot_positions_give_the_batch_step():
    """``decode_step`` with a (B,) position whose rows agree is the int
    step bit for bit, rings included; rows apart write their own ring
    slots."""
    _, cfg, _, params = R.model(ARCH)
    toks = torch.from_numpy(R.tokens(3, 3, 70, cfg.vocab_size).astype(
        np.int64))
    caches = [lm.init_cache(cfg, 3, 70, device="cpu") for _ in range(2)]
    for i in range(70):
        a, _ = lm.decode_step(cfg, params, caches[0], toks[:, i:i + 1], i)
        b, _ = lm.decode_step(cfg, params, caches[1], toks[:, i:i + 1],
                              torch.full((3,), i))
        assert torch.equal(a, b)
    for k in caches[0]:
        assert torch.equal(caches[0][k], caches[1][k])


def test_batcher_requests_equal_their_runs_from_a_zero_state():
    """8 requests through 3 slots, every slot reused: each request
    equals its own run alone from a zero state (see
    tests/test_torch_rwkv.py); measured 23 of the 39 tokens clear of a
    near tie."""
    _, cfg, _, _ = R.model(ARCH)
    reqs = R.requests(22, 8, cfg.vocab_size)
    done, logs, _ = R.run_batchers(ARCH, reqs, 3, 32)
    assert len(done) == 8
    assert R.check_batcher_against_alone(ARCH, done, logs) >= MIN_CLEAR


def test_batcher_first_wave_matches_reference_batcher():
    _, cfg, _, _ = R.model(ARCH)
    reqs = R.requests(22, 8, cfg.vocab_size)
    _, logs, rlogs = R.run_batchers(ARCH, reqs, 3, 32)
    for rid in R.first_wave(reqs, 3):
        assert sorted(logs[rid]) == sorted(rlogs[rid])
        for p, want in rlogs[rid].items():
            R.within(logs[rid][p], want, R.SERVE_RTOL)


def test_reference_batcher_carries_state_into_a_reused_slot():
    """The reference's carried conv and SSM states move a reused slot's
    first logits far past the bar; the port's reset does not."""
    _, cfg, _, _ = R.model(ARCH)
    reqs = R.requests(22, 8, cfg.vocab_size)
    _, logs, rlogs = R.run_batchers(ARCH, reqs, 3, 32)
    later = [r["rid"] for r in reqs if r["rid"] not in R.first_wave(reqs, 3)]
    errs = [float(np.abs(rlogs[rid][0] - logs[rid][0]).max()
                  / np.abs(logs[rid][0]).max()) for rid in later]
    assert min(errs) > 10 * R.SERVE_RTOL, errs


def test_admission_zeroes_only_the_slots_recurrent_rows():
    """A request admitted into slot 1 zeroes rows 1 of conv and ssm, and
    leaves the other slots' rows and the rings as they were."""
    _, cfg, _, params = R.model(ARCH)
    cb = ContinuousBatcher(
        cfg, params, slots=3, max_seq=16,
        decode_fn=make_per_slot_decode(cfg),
        init_cache_fn=lambda c, s, m: make_slot_cache(c, s, m, device="cpu"))
    for v in cb.cache.values():
        v.fill_(1)
    cb.state[0].rid = cb.state[2].rid = 99          # busy
    cb.submit(Request(rid=0, prompt=np.array([1, 2], np.int32),
                      max_new_tokens=1))
    cb._admit()
    for name in ("conv", "ssm"):
        assert not cb.cache[name][:, 1].any()
        assert (cb.cache[name][:, [0, 2]] == 1).all()
    assert (cb.cache["attn_kv"] == 1).all()

