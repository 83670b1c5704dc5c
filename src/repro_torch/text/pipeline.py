"""Corpus preparation: counts -> tf-idf rows on a device, resident or
streamed."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.common import resolve_device
from repro_torch.text import synth, tfidf


def prepare_local(
    corpus: synth.Corpus, device: str | torch.device | None = None
) -> tuple[torch.Tensor, np.ndarray]:
    """(x (n, d) L2-normalized tf-idf on ``device``, ground-truth labels
    (n,) on the host). ``device=None`` means the CUDA device."""
    dev = resolve_device(device)
    x = tfidf.tfidf(torch.from_numpy(corpus.counts).to(dev))
    return x, corpus.labels


class PreparedStream(NamedTuple):
    x: object  # CorpusStream of L2-normalized tf-idf chunks (on the device)
    labels: np.ndarray  # (n,) ground truth (host)
    n: int  # real document count


def prepare_synthetic_stream(
    *,
    n_docs: int,
    vocab: int = 2048,
    n_topics: int = 20,
    seed: int = 0,
    chunk: int = 8192,
    mesh=None,
    axes: tuple[str, ...] = ("data",),
    device: str | torch.device | None = None,
    **synth_kwargs,
) -> PreparedStream:
    """Out-of-core corpus preparation: generate -> streaming two-pass tf-idf.

    Nothing (n, d)-sized ever exists: counts regenerate per chunk on each
    pass and the tf-idf rescale runs per chunk on ``device`` (``None`` means
    the CUDA device). ``mesh``/``axes`` match the JAX package's signature;
    the mesh route comes with distributed streaming (ROADMAP queue 1 item
    10), so a mesh raises."""
    if mesh is not None:
        raise NotImplementedError(
            "prepare_synthetic_stream(mesh=...) is not ported yet"
            " (distributed streaming, ROADMAP queue 1 item 10)"
        )
    del axes
    counts_stream, labels = synth.stream_corpus(
        n_docs, vocab=vocab, n_topics=n_topics, seed=seed, chunk=chunk,
        **synth_kwargs,
    )
    x_stream = tfidf.tfidf_stream(counts_stream, device=device)
    return PreparedStream(x=x_stream, labels=labels, n=n_docs)
