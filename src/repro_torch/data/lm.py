"""LM token pipeline for the transformer training path.

The port's copy of the JAX package's `data/lm.py` (numpy only, the same
draws): a deterministic synthetic corpus, Zipfian unigram draws with
short repeated motifs pasted in, so a small model has next-token
structure to learn. Batches are host arrays (tokens, targets, valid); the
trainer copies them to the model's device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class TokenPipeline:
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    zipf_a: float = 1.3
    motif_len: int = 8
    n_motifs: int = 64

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        effective = min(self.vocab, 32768)           # cap the hot vocab
        self._motifs = rng.integers(2, effective,
                                    size=(self.n_motifs, self.motif_len))
        self._effective = effective

    def batches(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed + 1)
        while True:
            yield self.sample(rng)

    def sample(self, rng: np.random.Generator) -> dict:
        B, T = self.batch, self.seq_len
        toks = (rng.zipf(self.zipf_a, size=(B, T)) % (self._effective - 2)) + 2
        # Paste motifs at random offsets: learnable bigram structure.
        n_paste = max(1, T // (4 * self.motif_len))
        for b in range(B):
            for _ in range(n_paste):
                m = self._motifs[rng.integers(self.n_motifs)]
                off = rng.integers(0, T - self.motif_len)
                toks[b, off:off + self.motif_len] = m
        toks = toks.astype(np.int32)
        tokens = toks[:, :-1] if T > 1 else toks
        targets = toks[:, 1:] if T > 1 else toks
        valid = np.ones_like(targets, np.float32)
        return {"tokens": tokens, "targets": targets, "valid": valid}


def make_lm_batch_iterator(vocab: int, seq_len: int, batch: int,
                           seed: int = 0) -> Iterator[dict]:
    """Batches of `seq_len` input tokens and their next tokens."""
    return TokenPipeline(vocab=vocab, seq_len=seq_len + 1, batch=batch,
                         seed=seed).batches()
