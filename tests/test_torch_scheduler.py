"""The port's continuous batcher (``runtime/scheduler.py``) on the CPU:
the reference's own cases (tests/test_scheduler.py) on the port, and
the port's ``ContinuousBatcher`` against the reference's on the same
weights (carried across with ``lm.params_from_numpy``) and the same
requests: every step's logits within the ``serve_lm`` bar, 1e-2 of max
|logit| (the same f32 sums and bf16 rounds taken in other orders; see
tests/test_torch_lm.py), and equal tokens."""
import dataclasses
import functools
import time as _time
from collections import deque

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.runtime import scheduler as ref_sched  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.runtime import scheduler as S  # noqa: E402
from repro_torch.runtime.scheduler import (ContinuousBatcher, Request,  # noqa: E402
                                           make_per_slot_decode,
                                           make_slot_cache)
from repro_torch.runtime.tier import Request as TierRequest  # noqa: E402

LOGIT_RTOL = 1e-2


def _numpy_tree(tree):
    from repro.models import layers as ref_layers
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


def _batcher(cfg, params, slots, max_seq, decode_fn=None):
    return ContinuousBatcher(
        cfg, params, slots=slots, max_seq=max_seq,
        decode_fn=decode_fn or make_per_slot_decode(cfg),
        init_cache_fn=lambda c, s, m: make_slot_cache(c, s, m, device="cpu"))


def _requests(seed, n, vocab, prompt=(3, 8), new=(2, 6)):
    rng = np.random.default_rng(seed)
    return [dict(rid=rid, prompt=rng.integers(
        0, vocab, size=rng.integers(*prompt)).astype(np.int32),
        max_new_tokens=int(rng.integers(*new))) for rid in range(n)]


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-32b"])
def test_continuous_batching_completes_all(arch):
    """The reference's case (its rwkv6 case waits for rwkv6, ROADMAP
    Queue 1 item 8d; reduced qwen3-32b stands in)."""
    _, cfg, _, params = _model(arch)
    cb = _batcher(cfg, params, 2, 48)
    n_req = 5                               # > slots: forces queueing
    for kw in _requests(0, n_req, cfg.vocab_size):
        cb.submit(Request(**kw))
    ops.reset_launches()
    done = cb.run(max_steps=500)
    assert not any(ops.LAUNCHES.values())   # CPU: the plain versions
    assert len(done) == n_req
    for r in done:
        assert 1 <= len(r.tokens) <= r.max_new_tokens
        assert all(0 <= t < cfg.vocab_size for t in r.tokens)
    st = cb.stats()
    assert st["finished"] == n_req
    assert st["throughput_tok_s"] > 0
    # continuous batching: total steps well under the sequential sum
    assert cb.steps < sum(len(r.prompt) + r.max_new_tokens for r in done)


def test_freed_slots_token_feed_is_inert():
    """A retired slot zeroes its ``_next_tok`` row: a free slot still runs
    through decode_fn every step, and a stale token would make a freed
    slot's buffers depend on a retired request."""
    _, cfg, _, params = _model("smollm-360m")
    cb = _batcher(cfg, params, 2, 32)
    cb.submit(Request(rid=0, prompt=np.array([3, 5], np.int32),
                      max_new_tokens=1))
    cb.submit(Request(rid=1, prompt=np.array([2, 9, 4], np.int32),
                      max_new_tokens=8))
    cb.run(max_steps=5)
    assert cb.state[0].rid == -1              # slot 0 freed mid-run
    assert cb.state[1].rid == 1               # slot 1 still active
    assert cb._next_tok[0, 0] == 0            # freed row is inert
    cb.run()
    assert all(s.rid < 0 for s in cb.state)
    assert (cb._next_tok == 0).all()          # every freed row zeroed


def test_scheduler_matches_unbatched_decode():
    """A single request through the scheduler equals plain greedy decode
    (``decode_step`` at an int position), token for token."""
    _, cfg, _, params = _model("smollm-360m")
    prompt = np.array([3, 7, 11, 2], np.int32)
    cb = _batcher(cfg, params, 1, 32)
    cb.submit(Request(rid=0, prompt=prompt, max_new_tokens=5))
    done = cb.run()
    cache = lm.init_cache(cfg, 1, 32, device="cpu")
    logits = None
    for i, t in enumerate(prompt):
        logits, cache = lm.decode_step(cfg, params, cache,
                                       torch.tensor([[int(t)]]), i)
    out = []
    for j in range(5):
        nxt = int(logits[0, -1].argmax())
        out.append(nxt)
        logits, cache = lm.decode_step(cfg, params, cache,
                                       torch.tensor([[nxt]]),
                                       len(prompt) + j)
    assert done[0].tokens == out


def test_latency_stamps_survive_wall_clock_jump(monkeypatch):
    """Latency math runs on time.monotonic(): a step of the wall clock
    (time.time jumping a million seconds) does not reach the stamps."""
    cb = object.__new__(ContinuousBatcher)
    cb.queue = deque()
    jumped = _time.time() + 1_000_000.0
    monkeypatch.setattr(S.time, "time", lambda: jumped)
    req = Request(rid=0, prompt=np.array([1], np.int32), max_new_tokens=1)
    cb.submit(req)
    assert abs(req.submitted_at - _time.monotonic()) < 5.0
    assert abs(req.submitted_at - jumped) > 100_000.0


def _recording(decode, logs):
    """``decode`` that also logs each step's (tokens, positions, last
    logits) as numpy."""
    def rec(params, cache, toks, pos):
        lg, cache = decode(params, cache, toks, pos)
        logs.append((np.asarray(toks).copy(), np.asarray(pos).copy(),
                     np.asarray(lg[:, -1], np.float32)))
        return lg, cache
    return rec


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-32b"])
def test_batcher_matches_reference_batcher(arch):
    """The same requests through the reference's batcher and the port's:
    the same slot positions every step and the same number of steps (the
    schedule does not depend on the tokens: no eos). The reference's
    per-slot decode, fed the port's tokens and positions step by step
    (teacher-forced), gives every step's logits within the bar, and the
    same token wherever its top-2 gap exceeds the bar; where it does not
    (a near tie) either token is right and the free-running batchers may
    part there."""
    rcfg, cfg, rparams, params = _model(arch)
    reqs = _requests(1, 6, cfg.vocab_size, prompt=(2, 9), new=(2, 7))
    rlogs, logs = [], []
    rcb = ref_sched.ContinuousBatcher(
        rcfg, rparams, slots=3, max_seq=32,
        decode_fn=_recording(ref_sched.make_per_slot_decode(rcfg), rlogs),
        init_cache_fn=lambda c, s, m: ref_sched.make_slot_cache(c, s, m))
    cb = _batcher(cfg, params, 3, 32,
                  _recording(make_per_slot_decode(cfg), logs))
    for kw in reqs:
        rcb.submit(ref_sched.Request(**kw))
        cb.submit(Request(**kw))
    rdone, done = rcb.run(), cb.run()
    assert cb.steps == rcb.steps == len(logs) == len(rlogs)
    assert [r.rid for r in done] == [r.rid for r in rdone]
    assert [len(r.tokens) for r in done] == [len(r.tokens) for r in rdone]
    decode = ref_sched.make_per_slot_decode(rcfg)
    rcache = ref_sched.make_slot_cache(rcfg, 3, 32)
    compared = 0
    for (toks, pos, got), (_, rpos, _) in zip(logs, rlogs):
        np.testing.assert_array_equal(pos, rpos)
        want, rcache = decode(rparams, rcache, jax.numpy.asarray(toks),
                              jax.numpy.asarray(pos.astype(np.int32)))
        want = np.asarray(want[:, -1], np.float32)
        bar = LOGIT_RTOL * float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= bar
        top2 = np.sort(want, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > bar
        np.testing.assert_array_equal(got.argmax(-1)[clear],
                                      want.argmax(-1)[clear])
        compared += int(clear.sum())
    assert compared >= 0.9 * 3 * len(logs)


def test_per_slot_decode_at_one_position_is_the_batch_decode():
    """``decode_step`` with a (B,) position tensor whose rows agree is
    the int-position step bit for bit; with rows apart each row is its
    own one-row decode (within the bar: other row counts, other sums)."""
    _, cfg, _, params = _model("smollm-360m")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (3, 6), dtype=np.int64))
    caches = [lm.init_cache(cfg, 3, 8, device="cpu") for _ in range(2)]
    for i in range(6):
        a, _ = lm.decode_step(cfg, params, caches[0], toks[:, i:i + 1], i)
        b, _ = lm.decode_step(cfg, params, caches[1], toks[:, i:i + 1],
                              torch.full((3,), i))
        assert torch.equal(a, b)
    assert torch.equal(caches[0]["kv"], caches[1]["kv"])
    # rows at positions 0, 2, 4: each as its own single-row decode
    pos = torch.tensor([0, 2, 4])
    cache = lm.init_cache(cfg, 3, 8, device="cpu")
    singles = []
    for r in range(3):
        c1 = lm.init_cache(cfg, 1, 8, device="cpu")
        for i in range(int(pos[r]) + 1):
            lg, c1 = lm.decode_step(cfg, params, c1, toks[r:r + 1, i:i + 1],
                                    i)
        singles.append(lg[0, -1])
        cache["kv"][:, :, r] = c1["kv"][:, :, 0]
        cache["kv"][:, :, r, int(pos[r])] = 0      # rewritten by the step
    got, cache = lm.decode_step(
        cfg, params, cache, toks[torch.arange(3), pos][:, None], pos)
    want = torch.stack(singles)
    assert float((got[:, 0] - want).abs().max()) <= \
        LOGIT_RTOL * float(want.abs().max())


def test_request_is_the_tiers_and_the_cache_defaults_to_the_card(
        monkeypatch):
    assert issubclass(Request, TierRequest)
    assert [f.name for f in dataclasses.fields(Request)] == \
        [f.name for f in dataclasses.fields(ref_sched.Request)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config("smollm-360m"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_slot_cache(cfg, 2, 8)
