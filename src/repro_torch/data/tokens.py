"""Deterministic synthetic LM data pipeline (the port's copy of
``repro.data.tokens``, numpy only: ``batch_at`` gives the reference's
arrays exactly).

The stream is a pure function of (seed, step): resuming after a failure
needs only the step counter from the checkpoint — no iterator pickling, no
skipped or duplicated batches.
Token statistics follow a Zipf-like marginal with short-range Markov
structure so losses move (uniform tokens give a flat loss surface).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2


class TokenPipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # Zipf marginal (stable across steps)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._p = p / p.sum()

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """Pure function of step -> {tokens, labels} int32 (B, S)."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        b, s = cfg.global_batch, cfg.seq_len
        base = rng.choice(cfg.vocab, size=(b, s + 1), p=self._p).astype(np.int32)
        # short-range Markov structure: 25% of tokens copy their predecessor
        copy = rng.random((b, s + 1)) < 0.25
        for t in range(1, s + 1):
            base[:, t] = np.where(copy[:, t], base[:, t - 1], base[:, t])
        return {"tokens": base[:, :-1], "labels": base[:, 1:]}

    def iterate(self, start_step: int = 0) -> Iterator[dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


def frontend_stub(cfg, batch: int, seed: int, kind: str) -> np.ndarray:
    """Precomputed frame/patch embeddings for audio/vlm archs (the frontend
    is a stub per the assignment: input_specs supplies embeddings)."""
    rng = np.random.default_rng((seed, 17))
    if kind == "audio":
        return rng.normal(size=(batch, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    if kind == "vlm":
        return rng.normal(size=(batch, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    raise ValueError(kind)
