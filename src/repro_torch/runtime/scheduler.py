"""Continuous-batching LM serving (counterpart of the reference's
``src/repro/runtime/scheduler.py``).

A fixed pool of cache slots: new requests are admitted into free slots
every step and finished sequences retire at once, so no sequence waits
for the longest one of a batch. Every step is one ``decode_step`` of
shape (slots, 1) with one cache position a slot: a slot still in its
prompt consumes its next prompt token, a generating slot the token it
sampled. Admission and retirement live in the host's buffers (numpy,
as in the reference); each step reads the argmax back once. Admission
zeroes the slot's recurrent state (rwkv6, zamba2), which the reference
carries over from the slot's previous request; an audio config
(whisper) is refused.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.runtime.tier import Request as _TierRequest


@dataclass
class Request(_TierRequest):
    """LM decode request: the tier's admission and accounting
    :class:`repro_torch.runtime.tier.Request` (tenant, priority,
    deadline, timestamps, retries) plus the decode payload. The fields
    carry defaults because the base's do; ``prompt`` and
    ``max_new_tokens`` are required in practice."""
    prompt: np.ndarray = None           # (Tp,) int32
    max_new_tokens: int = 0
    eos_id: int = -1                    # -1: never stops early
    # filled by the scheduler
    tokens: list = field(default_factory=list)
    first_token_at: Optional[float] = None


@dataclass
class SlotState:
    rid: int = -1                       # -1 = free
    pos: int = 0                        # next cache position
    remaining: int = 0
    prompt: Optional[np.ndarray] = None
    prompt_idx: int = 0                 # how much of the prompt is fed


class ContinuousBatcher:
    """Drives a per-slot decode over a slot pool, greedily (each slot's
    next token is the argmax of its logits).

    ``decode_fn(params, cache, tokens (S, 1), pos (S,)) -> (logits,
    cache)``: one position a slot (:func:`make_per_slot_decode`).
    ``init_cache_fn(cfg, slots, max_seq)`` makes the slot cache
    (:func:`make_slot_cache`); the tokens and positions go to the
    device of its first tensor."""

    def __init__(self, cfg, params, *, slots: int, max_seq: int,
                 decode_fn: Callable, init_cache_fn: Callable):
        if cfg.family == "audio":
            raise NotImplementedError(
                f"{cfg.name}: the batcher takes no audio requests (a "
                f"Request carries no frames to fill its slot's cross_kv): "
                f"ROADMAP Queue 1 item 8f")
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_seq = max_seq
        self.decode_fn = decode_fn
        self.cache = init_cache_fn(cfg, slots, max_seq)
        self.device = next(iter(self.cache.values())).device
        self.state = [SlotState() for _ in range(slots)]
        self.queue: deque[Request] = deque()
        self.active: dict[int, Request] = {}
        self.finished: list[Request] = []
        self._next_tok = np.zeros((slots, 1), np.int32)
        self.steps = 0

    def submit(self, req: Request):
        # monotonic: these stamps feed latency math; the wall clock would
        # make latencies jump with NTP steps
        req.submitted_at = time.monotonic()
        self.queue.append(req)

    def _admit(self):
        for i, st in enumerate(self.state):
            if st.rid >= 0 or not self.queue:
                continue
            req = self.queue.popleft()
            self.state[i] = SlotState(rid=req.rid, pos=0,
                                      remaining=req.max_new_tokens,
                                      prompt=req.prompt, prompt_idx=0)
            self.active[req.rid] = req
            self._next_tok[i, 0] = req.prompt[0]
            self._reset_slot(i)

    def _reset_slot(self, i: int) -> None:
        """Zero slot i's rows of every recurrent leaf of the cache (rwkv6's
        token shifts and WKV state, zamba2's conv and SSM states), so the
        admitted request starts from the zero state ``serve_lm`` starts
        from. A KV cache needs nothing: rows past the new position are
        masked, and the request overwrites the others before it reads
        them. The reference resets only the slot's position, so its
        recurrent state runs on from the slot's previous request (or from
        the token-0 steps of a free slot): a deliberate difference
        (ROADMAP Queue 3 item 4)."""
        from repro_torch.models.lm import RECURRENT_LEAVES
        for name in RECURRENT_LEAVES:
            if name in self.cache:
                self.cache[name][:, i].zero_()

    @property
    def busy(self) -> bool:
        return bool(self.queue) or any(s.rid >= 0 for s in self.state)

    def step(self):
        """One decode step across all slots (prefilling slots consume
        their next prompt token; generating slots the sampled token).
        Always (slots, 1): a free slot runs too, on token 0 at pos 0."""
        self._admit()
        pos = np.array([s.pos for s in self.state], np.int64)
        toks = torch.from_numpy(self._next_tok).to(self.device)
        logits, self.cache = self.decode_fn(
            self.params, self.cache, toks, torch.from_numpy(pos).to(
                self.device))
        nxt = logits[:, -1].argmax(dim=-1).cpu().numpy()   # one read-back
        self.steps += 1
        now = time.monotonic()
        for i, st in enumerate(self.state):
            if st.rid < 0:
                continue
            req = self.active[st.rid]
            st.pos += 1
            if st.prompt_idx + 1 < len(st.prompt):
                # still prefilling: feed the next prompt token
                st.prompt_idx += 1
                self._next_tok[i, 0] = st.prompt[st.prompt_idx]
                continue
            # generating
            tok = int(nxt[i])
            if req.first_token_at is None:
                req.first_token_at = now
            req.tokens.append(tok)
            st.remaining -= 1
            self._next_tok[i, 0] = tok
            if (st.remaining <= 0 or tok == req.eos_id
                    or st.pos >= self.max_seq - 1):
                req.done_at = now
                self.finished.append(req)
                del self.active[st.rid]
                self.state[i] = SlotState()    # slot free next step
                # a free slot still runs through decode_fn every step:
                # zero its token feed, so no buffer of a freed slot
                # depends on a retired request
                self._next_tok[i, 0] = 0

    def run(self, *, max_steps: int = 100_000):
        while self.busy and self.steps < max_steps:
            self.step()
        return self.finished

    def stats(self) -> dict:
        done = [r for r in self.finished if r.done_at]
        if not done:
            return {"finished": 0}
        lat = [r.done_at - r.submitted_at for r in done]
        ttft = [r.first_token_at - r.submitted_at for r in done
                if r.first_token_at]
        toks = sum(len(r.tokens) for r in done)
        span = max(r.done_at for r in done) - min(r.submitted_at
                                                  for r in done)
        return {"finished": len(done), "tokens": toks,
                "throughput_tok_s": toks / max(span, 1e-9),
                "mean_latency_s": float(np.mean(lat)),
                "mean_ttft_s": float(np.mean(ttft)) if ttft else None,
                "decode_steps": self.steps}


def make_per_slot_decode(cfg):
    """``decode(params, cache, tokens (S, 1), pos (S,))``: ``decode_step``
    with one cache position a slot. The reference vmaps its decode over
    the slot axis; the port's ``decode_step`` takes the (S,) positions
    itself (a per-row KV or ring write, mask and rope; rwkv6 takes no
    position)."""
    from repro_torch.models import lm

    def per_slot(params, cache, toks, pos):
        return lm.decode_step(cfg, params, cache, toks, pos)

    return per_slot


def make_slot_cache(cfg, slots: int, max_seq: int, *, device="cuda"):
    """The per-slot cache: the decode cache with the slot axis where the
    batch axis was, on ``device``."""
    from repro_torch.models import lm
    return lm.init_cache(cfg, slots, max_seq, device=device)
