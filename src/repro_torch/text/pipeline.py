"""Corpus preparation: counts -> tf-idf rows on a device or on a mesh,
resident or streamed."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.common import resolve_device
from repro_torch.text import synth, tfidf


class PreparedCorpus(NamedTuple):
    x: torch.Tensor  # (n_padded / P, d) this rank's L2-normalized tf-idf rows
    w: torch.Tensor  # (n_padded / P,) 1.0 real / 0.0 padding, this rank's block
    labels: np.ndarray  # (n,) ground truth (host)
    n: int  # real document count


def prepare_synthetic(
    mesh,
    axes: tuple[str, ...],
    *,
    n_docs: int,
    vocab: int = 2048,
    n_topics: int = 20,
    seed: int = 0,
    **synth_kwargs,
) -> PreparedCorpus:
    """Generate a corpus, weight it, and shard it over the mesh. Every rank
    generates the same seeded corpus and keeps its row block (padded to a
    shard multiple; pad rows have w == 0 and zero rows), on the mesh's
    device."""
    from repro_torch.distrib.sharding import (
        mesh_axis_size,
        mesh_device,
        pad_rows_to_multiple,
        shard_rows,
    )

    corpus = synth.make_corpus(n_docs, vocab=vocab, n_topics=n_topics, seed=seed,
                               **synth_kwargs)
    counts = torch.from_numpy(corpus.counts).to(mesh_device(mesh))
    counts, w = pad_rows_to_multiple(counts, mesh_axis_size(mesh, axes))
    counts, w = shard_rows(mesh, axes, counts), shard_rows(mesh, axes, w)
    x = tfidf.tfidf_distributed(mesh, axes, counts, w)
    x = x * w[:, None]  # zero out padding rows so they have no norm
    return PreparedCorpus(x=x, w=w, labels=corpus.labels, n=n_docs)


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
    the CUDA device). With ``mesh`` the df/n pass runs as the engine's fold
    job (one all-reduce for the whole pass) and the rescale on the mesh's
    device, ``device`` unused; the distributed drivers cut each weighted
    chunk to the rank's block on arrival (e.g.
    ``distrib.cluster.kmeans_distributed_stream``)."""
    counts_stream, labels = synth.stream_corpus(
        n_docs, vocab=vocab, n_topics=n_topics, seed=seed, chunk=chunk,
        **synth_kwargs,
    )
    if mesh is None:
        x_stream = tfidf.tfidf_stream(counts_stream, device=device)
    else:
        x_stream = tfidf.tfidf_distributed_stream(mesh, axes, counts_stream)
    return PreparedStream(x=x_stream, labels=labels, n=n_docs)
