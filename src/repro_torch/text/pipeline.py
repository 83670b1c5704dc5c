"""Corpus preparation: counts -> tf-idf rows on a device."""

from __future__ import annotations

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
