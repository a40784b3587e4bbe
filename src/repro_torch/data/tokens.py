"""Synthetic token pipeline for the LM wing (the trainer and its tests).

Kept in numpy, bit for bit the generator of the JAX package, so one seed
gives both packages the same batches.  A deterministic stand-in for a
tokenized corpus: a Zipf-distributed token stream with short-range
structure (with p = 0.5 the next token repeats the current one shifted by
a per-sequence constant), so next-token prediction is learnable and the
loss of a working trainer visibly falls.  Yields {tokens, labels}, labels
the tokens shifted left with -100 (ignored by the loss) last.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

IGNORE = -100


def _zipf_probs(vocab: int, alpha: float = 1.1) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    return (p / p.sum()).astype(np.float64)


def synthetic_token_batches(*, batch: int, seq_len: int, vocab: int,
                            seed: int = 0, structured: bool = True,
                            ) -> Iterator[dict[str, np.ndarray]]:
    """Infinite iterator of {tokens (B, L) int32, labels (B, L) int32}."""
    rng = np.random.default_rng(seed)
    base_vocab = min(vocab, 4096)          # sample in a small head for speed
    probs = _zipf_probs(base_vocab)
    while True:
        toks = rng.choice(base_vocab, size=(batch, seq_len), p=probs)
        if structured:
            shift = rng.integers(1, 17, size=(batch, 1))
            repeat = rng.random((batch, seq_len)) < 0.5
            shifted = (toks + shift) % base_vocab
            toks[:, 1:] = np.where(repeat[:, 1:], shifted[:, :-1], toks[:, 1:])
        toks = toks.astype(np.int32)
        labels = np.concatenate(
            [toks[:, 1:], np.full((batch, 1), IGNORE, np.int32)], axis=1)
        yield {"tokens": toks, "labels": labels}

