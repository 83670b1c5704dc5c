"""Synthetic 20_newsgroups-like corpora with ground-truth topic labels.

The port's own copy of the JAX package's numpy-only ``text/synth.py``
(without the streaming generator): the same seed gives byte-identical
counts.

The paper evaluates on 20_newsgroups (n~20k, 20 groups, 80.2MB of vectors) and
a ~1GB synthetic collection built by replicating it (n~250k). Instead of
downloading it, we generate statistically similar data from a topic model:
each topic is a sparse Dirichlet distribution over the vocabulary; documents
mix their topic with a shared background distribution and draw multinomial
token counts. Ground-truth labels enable purity/NMI evaluation beyond the
paper's RSS-only reporting.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Corpus(NamedTuple):
    counts: np.ndarray  # (n, d) float32 token counts
    labels: np.ndarray  # (n,) int32 ground-truth topic
    n_topics: int


def _corpus_prefix(
    n_docs: int,
    vocab: int,
    n_topics: int,
    doc_len: int,
    topic_sharpness: float,
    background_weight: float,
    seed: int,
):
    """Up-front draws shared by the resident and streaming generators.

    Everything O(n) or smaller (labels, lengths) is drawn here in a FIXED rng
    order; the O(n·d) counts are drawn per block afterwards, row by row, so
    the emitted rows are bit-identical for ANY block size.
    """
    rng = np.random.default_rng(seed)
    topics = rng.dirichlet(np.full(vocab, topic_sharpness), size=n_topics)
    background = rng.dirichlet(np.full(vocab, 1.0))
    labels = rng.integers(0, n_topics, size=n_docs).astype(np.int32)
    mix = (1.0 - background_weight) * topics + background_weight * background
    lengths = rng.poisson(doc_len, size=n_docs).clip(min=16)
    return rng, mix, labels, lengths


def iter_corpus_blocks(
    n_docs: int,
    vocab: int = 2048,
    n_topics: int = 20,
    *,
    doc_len: int = 120,
    topic_sharpness: float = 0.05,
    background_weight: float = 0.35,
    seed: int = 0,
    batch: int = 8192,
):
    """Yield (counts (≤batch, vocab) f32, labels (≤batch,) i32) blocks.

    The chunk-yielding generator behind both ``make_corpus`` (which
    concatenates it): rows are bit-identical across block sizes.
    """
    rng, mix, labels, lengths = _corpus_prefix(
        n_docs, vocab, n_topics, doc_len, topic_sharpness, background_weight, seed
    )
    for start in range(0, n_docs, batch):
        stop = min(start + batch, n_docs)
        p = mix[labels[start:stop]]
        yield _multinomial_rows(rng, lengths[start:stop], p), labels[start:stop]


def make_corpus(
    n_docs: int,
    vocab: int = 2048,
    n_topics: int = 20,
    *,
    doc_len: int = 120,
    topic_sharpness: float = 0.05,
    background_weight: float = 0.35,
    seed: int = 0,
    batch: int = 8192,
) -> Corpus:
    """Generate a topic-model corpus (resident: concat of the block stream).

    topic_sharpness: Dirichlet alpha for topic-word distributions (lower =
      more distinctive topics; 0.05 gives 20NG-like separability).
    background_weight: mixture weight of the shared background distribution
      (stopword mass — what makes real text clustering hard).
    """
    counts = np.zeros((n_docs, vocab), np.float32)
    labels = np.zeros((n_docs,), np.int32)
    start = 0
    for block, lab in iter_corpus_blocks(
        n_docs,
        vocab,
        n_topics,
        doc_len=doc_len,
        topic_sharpness=topic_sharpness,
        background_weight=background_weight,
        seed=seed,
        batch=batch,
    ):
        counts[start : start + block.shape[0]] = block
        labels[start : start + block.shape[0]] = lab
        start += block.shape[0]
    return Corpus(counts=counts, labels=labels, n_topics=n_topics)


def _multinomial_rows(
    rng: np.random.Generator, lengths: np.ndarray, p: np.ndarray
) -> np.ndarray:
    """Row-wise multinomial draws (numpy requires a loop over distinct n)."""
    out = np.empty(p.shape, np.float32)
    for i in range(p.shape[0]):
        out[i] = rng.multinomial(int(lengths[i]), p[i])
    return out


def paper_20ng_shape() -> dict:
    """The 20_newsgroups analogue used across benchmarks (paper Tables 1-3,5-7)."""
    return dict(n_docs=20_000, vocab=2048, n_topics=20, seed=20)


def paper_1gb_shape(scale: float = 1.0) -> dict:
    """The ~1GB synthetic analogue (paper Tables 4, 8). `scale` < 1 shrinks the
    document count for CPU-bound CI runs; the full shape is n=250k."""
    return dict(
        n_docs=max(1000, int(250_000 * scale)), vocab=2048, n_topics=50, seed=21
    )
