"""LM step functions for serving (counterpart of the reference's
``src/repro/launch/steps.py``, prefill and decode; training is not
ported, ROADMAP Queue 1, the rest of the LM side).

The reference's ``remat`` and ``unroll`` knobs shape a traced program;
the port runs eagerly and has neither."""
from __future__ import annotations

from repro_torch.models import lm


def make_prefill_step(cfg):
    """``prefill(params, tokens, **extra) -> (B, V)`` next-token logits
    (f32): one forward over the whole prompt, its attention through the
    flash kernel. ``extra``: ``patches=(B, Vt, d)`` for a VLM, in front
    of the tokens (the reference's prefill takes ``T - vision_tokens``
    tokens)."""
    def prefill(params, tokens, **extra):
        logits, _ = lm.forward(cfg, params, tokens, extra=extra or None,
                               logits_mode="last")
        return logits

    return prefill


def make_decode_step(cfg):
    """``decode(params, cache, tokens, pos) -> (logits, cache)``."""
    def decode(params, cache, tokens, pos):
        return lm.decode_step(cfg, params, cache, tokens, pos)

    return decode
