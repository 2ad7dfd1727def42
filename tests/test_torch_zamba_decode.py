"""The port's hybrid family (zamba2) stepped through its decode cache,
against the JAX reference on the CPU at ``reduced()`` size, on the
reference's own weights (split from ``tests/test_torch_zamba.py``, whose
docstring states the bars): ``decode_step`` and ``serve_lm`` past the
window of 64 (the ring wraps), and the prompt stepped through the cache
against the one-shot ``forward``."""
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import _torch_lm_ref as R  # noqa: E402
from repro_torch.models import lm  # noqa: E402

ARCH = "zamba2-7b"


def test_decode_steps_match_reference_past_the_window():
    """80 steps through a cache of 96 rows: the ring of the window's 64
    keys wraps after step 63; every step's logits, and at the end the
    conv and SSM states and the rings."""
    _, cfg, _, _ = R.model(ARCH)
    cache, rcache = R.check_decode_steps(
        ARCH, R.tokens(11, 2, 80, cfg.vocab_size), 96)
    assert cache["attn_kv"].shape[3] == 64
    for k in ("conv", "ssm", "attn_kv"):
        R.within(cache[k], rcache[k], R.LOGIT_RTOL)


def test_forward_equals_the_prompt_stepped_through_decode():
    """T 80 > the window: the chunked scan and the windowed flash of
    ``forward`` against the recurrent step and the wrapped ring of
    ``decode_step``, position by position."""
    _, cfg, _, params = R.model(ARCH)
    toks = R.tokens(12, 1, 80, cfg.vocab_size)
    full, _ = lm.forward(cfg, params, torch.from_numpy(toks))
    stepped, cache = R.stepped_logits(cfg, params, toks)
    assert cache["attn_kv"].shape[3] == 64        # min(window, 80)
    R.within(stepped, full)


def test_serve_lm_matches_reference_decode_loop():
    _, cfg, _, _ = R.model(ARCH)
    R.check_serve_lm(ARCH, R.tokens(13, 2, 8, cfg.vocab_size), 6, 16)
