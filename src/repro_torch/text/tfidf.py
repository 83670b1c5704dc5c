"""TF-IDF weighting in the vector space model (paper §2: 'most of them are
based on the vector space model representation with tf-idf weights').

Single-device subset of the JAX package's ``text/tfidf.py``.
"""

from __future__ import annotations

import torch

from repro_torch.common import l2_normalize


def tf_weight(counts: torch.Tensor) -> torch.Tensor:
    """Sub-linear tf: 1 + log(tf) for tf > 0 (Manning et al. [28])."""
    return torch.where(counts > 0, 1.0 + torch.log(torch.clamp(counts, min=1.0)), 0.0)


def idf_weight(df: torch.Tensor, n_docs: int | float) -> torch.Tensor:
    """Smoothed idf: log(n / (1 + df))."""
    n = torch.tensor(n_docs, dtype=torch.float32, device=df.device)
    return torch.log(n / (1.0 + df))


def document_frequency(counts: torch.Tensor) -> torch.Tensor:
    return torch.sum((counts > 0).float(), dim=0)


def tfidf(counts: torch.Tensor) -> torch.Tensor:
    """counts (n, d) -> L2-normalized tf-idf vectors (n, d) f32.

    n == 0 is rejected: idf would be log(0) = -inf for every term. An
    all-zero row (an empty document) stays the zero vector."""
    if counts.shape[0] == 0:
        raise ValueError("tfidf: empty collection (n == 0 documents)")
    df = document_frequency(counts)
    x = tf_weight(counts) * idf_weight(df, counts.shape[0])
    x = torch.clamp(x, min=0.0)  # idf can go negative for terms in >n/e docs
    return l2_normalize(x)
