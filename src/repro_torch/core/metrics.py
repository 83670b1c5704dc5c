"""Clustering quality metrics: RSS (the paper's metric), cosine objective,
purity, NMI.

For unit-norm documents RSS decomposes as ``RSS = sum ||x||^2 - sum_k n_k
||mean_k||^2`` (means over members, not renormalized), so RSS costs one
stats pass and no residuals.
"""

from __future__ import annotations

import torch

from repro_torch.common import bincount
from repro_torch.kernels import ops


def rss(x: torch.Tensor, idx: torch.Tensor, k: int) -> torch.Tensor:
    """Residual sum of squares vs member-mean centroids (any norm)."""
    sums, counts = ops.label_stats(x, idx, k)
    means = sums / torch.clamp(counts, min=1.0)[:, None]
    sq_norm_x = torch.sum(x.float() ** 2)
    sq_norm_m = torch.sum(counts * torch.sum(means * means, dim=1))
    return sq_norm_x - sq_norm_m


def cosine_objective(best_sim: torch.Tensor) -> torch.Tensor:
    """Sum of (1 - cos(x, assigned center)); lower is better."""
    return torch.sum(1.0 - best_sim)


def contingency(
    pred: torch.Tensor, true: torch.Tensor, k_pred: int, k_true: int
) -> torch.Tensor:
    """(k_pred, k_true) f32 label co-occurrence counts."""
    flat = pred.long() * k_true + true.long()
    return bincount(flat, k_pred * k_true).reshape(k_pred, k_true).float()


def purity(pred: torch.Tensor, true: torch.Tensor, k_pred: int, k_true: int) -> torch.Tensor:
    c = contingency(pred, true, k_pred, k_true)
    return torch.sum(torch.amax(c, dim=1)) / torch.sum(c)


def nmi(pred: torch.Tensor, true: torch.Tensor, k_pred: int, k_true: int) -> torch.Tensor:
    """Normalized mutual information (sqrt normalization)."""
    c = contingency(pred, true, k_pred, k_true)
    p = c / torch.sum(c)
    pi = torch.sum(p, dim=1)  # pred marginal
    pj = torch.sum(p, dim=0)  # true marginal

    def _safe_xlogx(v):
        return torch.where(v > 0, v * torch.log(torch.clamp(v, min=1e-30)), 0.0)

    outer = torch.clamp(pi[:, None] * pj[None, :], min=1e-30)
    mi = torch.sum(torch.where(
        p > 0, p * (torch.log(torch.clamp(p, min=1e-30)) - torch.log(outer)), 0.0
    ))
    h_pred = -torch.sum(_safe_xlogx(pi))
    h_true = -torch.sum(_safe_xlogx(pj))
    return mi / torch.clamp(torch.sqrt(h_pred * h_true), min=1e-30)


def rss_from_assignment_stats(
    sums: torch.Tensor, counts: torch.Tensor, sq_norm_x: torch.Tensor, k: int
) -> torch.Tensor:
    """RSS from already-reduced cluster stats."""
    del k
    means = sums / torch.clamp(counts, min=1.0)[:, None]
    return sq_norm_x - torch.sum(counts * torch.sum(means * means, dim=1))
