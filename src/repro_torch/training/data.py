"""Synthetic-corpus data pipeline: tokenizer-free document generator with
learnable structure, sequence packing, and a deterministic batch iterator.
A copy of the JAX package's ``training/data.py`` (numpy only, the same
draws from the same seeds): the batches are identical.

Documents are emitted by a seeded order-1 Markov chain over the vocab with
a power-law stationary distribution plus periodic copy motifs — structured
enough that a ~100M model's loss visibly drops within a few hundred steps
while requiring no external data.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np


@dataclass
class SyntheticCorpus:
    vocab_size: int
    seed: int = 0
    branch: int = 16          # out-degree of the Markov chain
    motif_period: int = 64    # every ~period tokens, repeat a recent span

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = self.vocab_size
        # per-state successor table (sparse transition structure)
        self._succ = rng.integers(0, v, size=(v, self.branch))
        # zipfian state-visit tendencies
        p = 1.0 / np.arange(1, self.branch + 1) ** 1.2
        self._succ_p = p / p.sum()

    def document(self, rng: np.random.Generator, length: int) -> np.ndarray:
        toks = np.empty(length, np.int64)
        toks[0] = rng.integers(0, self.vocab_size)
        i = 1
        while i < length:
            if i % self.motif_period == 0 and i >= 16 and rng.random() < 0.5:
                # copy motif: repeat a recent span (teaches induction)
                span = min(8, length - i)
                start = rng.integers(max(0, i - 32), i - span + 1)
                toks[i:i + span] = toks[start:start + span]
                i += span
                continue
            prev = toks[i - 1]
            toks[i] = self._succ[prev, rng.choice(self.branch, p=self._succ_p)]
            i += 1
        return toks


@dataclass
class PackedDataset:
    """Packs variable-length documents into fixed (batch, seq+1) examples;
    targets are inputs shifted by one. A BOS token (id 0) separates docs and
    the loss mask zeroes predictions across document boundaries."""

    corpus: SyntheticCorpus
    seq_len: int
    batch_size: int
    seed: int = 0
    mean_doc_len: int = 512

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        rng = np.random.default_rng(self.seed)
        buf = np.empty(0, np.int64)
        bound = np.empty(0, bool)
        need = self.batch_size * (self.seq_len + 1)
        while True:
            while len(buf) < need:
                n = max(16, int(rng.exponential(self.mean_doc_len)))
                doc = self.corpus.document(rng, n)
                b = np.zeros(n + 1, bool)
                b[0] = True
                buf = np.concatenate([buf, [0], doc])
                bound = np.concatenate([bound, b])
            chunk, buf = buf[:need], buf[need:]
            bchunk, bound = bound[:need], bound[need:]
            x = chunk.reshape(self.batch_size, self.seq_len + 1)
            bm = bchunk.reshape(self.batch_size, self.seq_len + 1)
            tokens = x[:, :-1].astype(np.int32)
            targets = x[:, 1:].astype(np.int32)
            mask = ~bm[:, 1:]          # don't predict across doc starts
            yield tokens, targets, mask
