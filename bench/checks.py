"""Whether what the timed path produced is correct: every answer of the
traced span and the window against the plain reference's logits for the
same image.

For each answer, the gap is max |logit - reference logit| over the
classes, over max |reference logit|. ``worst_logit_err`` is the largest
gap of the run, ``mean_logit_err`` the mean over its answers.
``systematic_err`` is the largest, over the classes, of the mean signed
difference over the answers, over the mean of max |reference logit|: a
precision lost in the weights shifts every answer alike, where rounding
in the activations differs from image to image. Each is held to the
configuration's limit (PERF.md gives the readings each was set
from)."""
from __future__ import annotations

import math

import numpy as np

NUMBERS = ("worst_logit_err", "mean_logit_err", "systematic_err")


def gaps(keys: np.ndarray, logits: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Each answer's gap to the reference row of its image."""
    want = ref[keys]
    diff = np.abs(logits.astype(np.float64) - want).max(axis=1)
    return diff / np.abs(want).max(axis=1)


def systematic(keys, logits, ref) -> float:
    if not len(keys):
        return math.inf
    want = ref[keys]
    shift = (logits.astype(np.float64) - want).mean(axis=0)
    return float(np.abs(shift).max() / np.abs(want).max(axis=1).mean())


def compare(keys, logits, ref, limits: dict, due: int,
            failed: int) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}). A run is correct when it
    has exactly one answer for each of the ``due`` images its traffic sent
    (the window's and every traced span's), none failed, and each number
    is within its limit; a gap that is not finite, or a run whose answers
    do not match what was sent, counts as 1e308."""
    whole = failed == 0 and due > 0 and len(keys) == len(logits) == due
    g = gaps(keys, logits, ref) if whole else np.array([math.inf])
    vals = {"worst_logit_err": float(np.max(g)),
            "mean_logit_err": float(np.mean(g)),
            "systematic_err": systematic(keys, logits, ref) if whole
            else math.inf}
    checks = {}
    ok = whole
    for name in NUMBERS:
        v = vals[name] if math.isfinite(vals[name]) else 1e308
        checks[name] = {"value": v, "limit": limits[name]}
        ok = ok and v <= limits[name]
    return ok, checks
