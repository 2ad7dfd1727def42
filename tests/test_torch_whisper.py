"""The port's encoder-decoder family (whisper) against the JAX reference
on the CPU, at ``reduced()`` size (2 encoder and 2 decoder layers, d
128, 4 heads of 32, 32 frames, the FFNs pruned at 16 x 16), on the
reference's own weights carried across with ``lm.params_from_numpy``:
cross-attention, the encoder, ``forward(extra={"frames"})``, decode
steps on a ``cross_kv`` filled from the encoder and on a zeroed one,
``serve_lm`` with the encoder's fill, and what the port refuses.

The reference never fills ``cross_kv`` (its ``serve_lm`` draws frames
and runs no encoder, so its decode attends over zeros); the port's
``lm.fill_cross_kv`` runs the encoder and fills it, a deliberate
difference (ROADMAP Queue 3 item 4). So the filled case holds the
port's decode against the reference's ``decode_step`` on a cache the
test fills with JAX from the reference's ``_run_encoder``, and the
zeroed case against the reference's decode as it runs.

Bars. Cross-attention and the encoder differ by design in their
attention: the port computes what the reference's Pallas flash kernel
computes (p in f32), the reference's ``blockwise_attention`` rounds p to
bf16; their bf16 outputs are held to 1e-2 of their max. Whole models:
the LM bars, 1e-2 of max |logit| against the reference's ops run one at
a time (3e-2 against its jitted forward), 3e-2 for ``serve_lm``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_lm_ref as R  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.serve import ServeConfig, serve, serve_lm  # noqa: E402
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.runtime.scheduler import (ContinuousBatcher,  # noqa: E402
                                           make_per_slot_decode,
                                           make_slot_cache)

ARCH = "whisper-large-v3"
LAYER_RTOL = 1e-2


def _frames(seed, b, cfg):
    return R.bf16(np.random.default_rng(seed).normal(
        size=(b, cfg.encoder_seq, cfg.d_model)))


def _ref_fill(rcfg, rparams, rcache, frames):
    """The reference's cache with cross_kv filled as its
    ``cross_attention`` computes K and V from ``_run_encoder``'s output
    (einsum with wk, wv, rounded to the encoder's dtype), in JAX."""
    enc = R.eager(ref_lm._run_encoder, rcfg, rparams, jnp.asarray(frames))
    cross = rparams["blocks"]["cross"]
    k = jnp.einsum("btd,ldhk->lbthk", enc, cross["wk"]).astype(enc.dtype)
    v = jnp.einsum("btd,ldhk->lbthk", enc, cross["wv"]).astype(enc.dtype)
    return dict(rcache, cross_kv=jnp.stack([k, v], 1)), enc


def test_params_carry_across_bit_for_bit():
    """The encoder's stack (its FFN pruned too) and the decoder's
    cross-attention keep their bits."""
    port = R.check_round_trip(ARCH)
    assert ("encoder", "blocks", "ffn", "w1", "vals") in port
    assert ("blocks", "cross", "wq") in port
    assert port[("encoder", "blocks", "ffn", "w1", "vals")].shape[-2:] == \
        (16, 16)


def test_cross_attention_matches_reference():
    """40 queries over 32 encoder rows (Tq != Tk), non-causal."""
    rcfg, cfg, rparams, params = R.model(ARCH)
    rp = jax.tree.map(lambda a: a[0], rparams["blocks"]["cross"])
    p = lm._layer(params["blocks"], 0)["cross"]
    rng = np.random.default_rng(4)
    x = R.bf16(rng.normal(size=(2, 40, cfg.d_model)))
    enc = R.bf16(rng.normal(size=(2, 32, cfg.d_model)))
    want = R.eager(ref_layers.cross_attention, rp, rcfg, jnp.asarray(x),
                   jnp.asarray(enc))
    got = L.cross_attention(p, cfg, R.t_(x), R.t_(enc))
    assert got.dtype == torch.bfloat16
    R.within(got, want, LAYER_RTOL)
    # against the cached keys and values: the decode's plain path
    ck, cv = L.cross_kv(p, R.t_(enc))
    R.within(L.cross_decode(p, cfg, R.t_(x), ck, cv), got, LAYER_RTOL)


def test_encoder_matches_reference():
    rcfg, cfg, rparams, params = R.model(ARCH)
    frames = _frames(5, 2, cfg)
    want = R.eager(ref_lm._run_encoder, rcfg, rparams, jnp.asarray(frames))
    got = lm.run_encoder(cfg, params, R.t_(frames))
    assert got.shape == (2, cfg.encoder_seq, cfg.d_model)
    R.within(got, want, LAYER_RTOL)


def test_forward_matches_reference():
    """T 40 tokens over 32 frames: the encoder, then the decoder's
    causal self-attention and its cross-attention over the encoder."""
    _, cfg, _, params = R.model(ARCH)
    toks = R.tokens(7, 2, 40, cfg.vocab_size)
    frames = _frames(8, 2, cfg)
    got = R.check_forward(ARCH, toks, extra={"frames": frames})
    last = make_prefill_step(cfg)(params, torch.from_numpy(toks),
                                  frames=R.t_(frames))
    torch.testing.assert_close(last, got[:, -1], rtol=1e-5, atol=1e-5)


def test_decode_on_a_filled_cross_kv_matches_reference():
    """The port fills cross_kv by running its encoder; the reference's
    cache is filled by the test from the reference's encoder. The two
    fills within 1e-2 of their max, then every step's logits."""
    rcfg, cfg, rparams, params = R.model(ARCH)
    frames = _frames(9, 2, cfg)

    def fill(cache, rcache):
        lm.fill_cross_kv(cfg, params, cache, R.t_(frames))
        rcache, _ = _ref_fill(rcfg, rparams, rcache, frames)
        R.within(cache["cross_kv"], rcache["cross_kv"], LAYER_RTOL)
        return cache, rcache

    R.check_decode_steps(ARCH, R.tokens(11, 2, 10, cfg.vocab_size), 16,
                         fill=fill)


def test_decode_on_a_zeroed_cross_kv_matches_reference():
    """Nothing filled: the reference's decode as it runs in its own
    ``serve_lm`` (attending over zeros)."""
    _, cfg, _, _ = R.model(ARCH)
    cache, _ = R.check_decode_steps(ARCH, R.tokens(12, 2, 10, cfg.vocab_size),
                                    16)
    assert not cache["cross_kv"].any()


def test_serve_lm_fills_cross_kv_from_the_encoder():
    """``serve_lm`` with frames: every step (teacher-forced) within the
    serve bar of the reference's decode on the JAX-filled cache, and its
    first token the argmax of ``forward(extra={"frames"})``'s last
    logits where their top-2 gap clears the bar; the encoder runs once,
    inside ``prefill_s``."""
    rcfg, cfg, rparams, params = R.model(ARCH)
    prompts = R.tokens(13, 2, 8, cfg.vocab_size)
    frames = _frames(14, 2, cfg)
    rcache, _ = _ref_fill(rcfg, rparams, ref_lm.init_cache(rcfg, 2, 16),
                          frames)
    out = R.check_serve_lm(ARCH, prompts, 6, 16, rcache=rcache,
                           frames=R.t_(frames))
    full, _ = lm.forward(cfg, params, torch.from_numpy(prompts),
                         extra={"frames": R.t_(frames)})
    last = full[:, -1]
    R.within(out["logits"][:, 7], last, R.SERVE_RTOL)
    top2 = last.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > R.SERVE_RTOL * float(
        last.abs().max())
    assert clear.any()
    np.testing.assert_array_equal(out["tokens"][clear.numpy(), 0],
                                  last.argmax(-1)[clear].numpy())


def test_serve_lm_draws_frames_when_given_none():
    """``serve`` takes whisper on the CPU: frames drawn from the seed's
    generator after the prompts, the encoder's fill, greedy tokens, no
    kernel launched; the same seed gives the same tokens, and the drawn
    frames are the ones given explicitly."""
    ops.reset_launches()
    out = serve(ServeConfig(arch=ARCH, batch=2, device="cpu", verbose=False))
    assert out["tokens"].shape == (2, 16) and out["device"] == "cpu"
    assert not any(ops.LAUNCHES.values())
    cfg = R.model(ARCH)[1]
    gen = torch.Generator().manual_seed(0)
    params = lm.init_params(cfg, gen)
    prompts = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen)
    frames = torch.randn((2, cfg.encoder_seq, cfg.d_model),
                         generator=gen).to(torch.bfloat16)
    again = serve_lm(ARCH, params=params, prompts=prompts, frames=frames,
                     verbose=False, device="cpu")
    np.testing.assert_array_equal(again["tokens"], out["tokens"])


def test_audio_inputs_are_checked():
    _, cfg, _, params = R.model(ARCH)
    toks = torch.from_numpy(R.tokens(1, 2, 4, cfg.vocab_size))
    with pytest.raises(ValueError, match="frames"):
        lm.forward(cfg, params, toks)
    with pytest.raises(ValueError, match="frames"):
        lm.forward(cfg, params, toks, extra={"patches": torch.zeros(2, 3)})
    with pytest.raises(ValueError, match="expected"):
        lm.forward(cfg, params, toks,
                   extra={"frames": torch.zeros(2, 5, cfg.d_model + 1)})
    cache = lm.init_cache(cfg, 2, 8, device="cpu")
    with pytest.raises(ValueError, match="frames"):
        lm.fill_cross_kv(cfg, params, cache,
                         torch.zeros(2, cfg.encoder_seq - 1, cfg.d_model))


def test_the_batcher_refuses_audio_requests():
    _, cfg, _, params = R.model(ARCH)
    with pytest.raises(NotImplementedError, match="Queue 1 item 8f"):
        ContinuousBatcher(
            cfg, params, slots=2, max_seq=8,
            decode_fn=make_per_slot_decode(cfg),
            init_cache_fn=lambda c, s, m: make_slot_cache(c, s, m,
                                                          device="cpu"))


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-7b", ARCH])
def test_prefill_chunk_refuses_the_new_families(arch):
    _, cfg, _, params = R.model(arch)
    cache = lm.init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 8f"):
        lm.prefill_chunk(cfg, params, cache,
                         torch.zeros((1, 4), dtype=torch.long), 0)
