"""Deterministic synthetic data, shardable by (host, step): the port's
copy of the reference's ``src/repro/data/pipeline.py`` (pure numpy, the
same bits for the same (seed, step, shard)).

Tokens come from a fixed first-order Markov chain over the vocab, so the
LM loss is learnable. Every batch is a pure function of (seed, step,
shard): after a failure the restored step re-reads identical data, with
no data state in the checkpoint.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1          # data-parallel shards
    shard_id: int = 0
    branching: int = 32        # markov successors per token (lower = easier)


class MarkovStream:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        self._succ = rng.integers(0, v, size=(v, cfg.branching), dtype=np.int32)

    def batch(self, step: int) -> dict:
        """Global batch slice for this shard at ``step``."""
        cfg = self.cfg
        assert cfg.global_batch % cfg.n_shards == 0
        local = cfg.global_batch // cfg.n_shards
        rng = np.random.default_rng(
            (cfg.seed, step, cfg.shard_id, 0xD1E5E1))
        v = cfg.vocab_size
        toks = np.empty((local, cfg.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, v, size=local)
        choices = rng.integers(0, cfg.branching,
                               size=(local, cfg.seq_len))
        for t in range(cfg.seq_len):
            toks[:, t + 1] = self._succ[toks[:, t], choices[:, t]]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def image_batch(step: int, *, batch: int, size: int = 224, seed: int = 0):
    """Deterministic synthetic images for the CNN path."""
    rng = np.random.default_rng((seed, step, 0x1A6E))
    x = rng.standard_normal((batch, size, size, 3), dtype=np.float32)
    y = rng.integers(0, 1000, size=batch)
    return {"images": x, "labels": y.astype(np.int32)}
