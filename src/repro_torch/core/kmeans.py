"""Spherical K-Means over the MapReduce pattern (PKMeans, Zhao et al. [26]).

One iteration is one fused pass over the documents:
  map+combine -> nearest center + cluster stats (``ops.assign_stats``)
  reduce      -> new centers, renormalized (spherical K-Means)

Single-device counterpart of the JAX package's ``core/kmeans.py``. Documents
are expected L2-normalized (cosine semantics, paper §3.1).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.common import l2_normalize
from repro_torch.core import metrics, sampling
from repro_torch.kernels import ops


class KMeansResult(NamedTuple):
    centers: torch.Tensor  # (k, d) unit-norm centers used for assignment
    assignment: torch.Tensor  # (n,) int32
    best_sim: torch.Tensor  # (n,) f32 cos(doc, center)
    rss: torch.Tensor  # scalar Euclidean RSS vs member means
    objective: torch.Tensor  # scalar cosine objective
    iterations: int  # iterations actually run


def init_random_centers(
    x: torch.Tensor, k: int, generator: torch.Generator
) -> torch.Tensor:
    """Paper's init: k documents drawn at random from the collection."""
    idx = sampling.sample_indices(x.shape[0], k, generator, device=x.device)
    return l2_normalize(x[idx])


def _split_empty_centers(
    centers: torch.Tensor,
    sums: torch.Tensor,
    counts: torch.Tensor,
    sumsq: torch.Tensor,
) -> torch.Tensor:
    """Reseed each empty cluster by splitting the highest-RSS cluster: the
    empty center j becomes the donor's center nudged along basis vector
    j mod d. No-op when no cluster is empty."""
    k, d = centers.shape
    rss_c = sumsq - torch.sum(sums * sums, dim=1) / torch.clamp(counts, min=1.0)
    donor = torch.argmax(torch.where(counts > 0, rss_c, float("-inf")))
    basis = torch.arange(k, device=centers.device) % d
    nudge = 1e-3 * (basis[:, None] == torch.arange(d, device=centers.device)).to(centers.dtype)
    split = l2_normalize(centers[donor][None, :] + nudge)
    return torch.where((counts <= 0)[:, None], split, centers)


def kmeans_step(
    x: torch.Tensor,
    centers: torch.Tensor,
    k: int,
    *,
    fused: bool = True,
    reseed: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One map/combine/reduce iteration on one device.

    fused=True makes one ``ops.assign_stats`` call. fused=False is the
    two-pass path (assignment, then ``label_stats``); its assignment kernel
    is not ported yet, so it runs on the CPU only. reseed="split" recovers
    empty clusters (``_split_empty_centers``); the default keeps the stale
    center.

    Returns (new_centers, idx, best_sim, sums, counts).
    """
    if reseed not in (None, "split"):
        raise ValueError(f"unknown reseed policy {reseed!r}: expected 'split'")
    if reseed and not fused:
        raise ValueError("reseed='split' needs fused=True (donor uses sumsq)")
    if fused:
        st = ops.assign_stats(x, centers)
        idx, best_sim, sums, counts = st.idx, st.best_sim, st.sums, st.counts
    else:
        idx, best_sim = ops.assign_argmax(x, centers)
        sums, counts = ops.label_stats(x, idx, k)
    means = sums / torch.clamp(counts, min=1.0)[:, None]
    new_centers = torch.where(counts[:, None] > 0, l2_normalize(means), centers)
    if reseed == "split":
        new_centers = _split_empty_centers(new_centers, sums, counts, st.sumsq)
    return new_centers, idx, best_sim, sums, counts


def kmeans_fit(
    x: torch.Tensor,
    init_centers: torch.Tensor,
    k: int,
    *,
    max_iters: int = 8,
    tol: float = 1e-4,
    fused: bool = True,
) -> KMeansResult:
    """Iterate until the largest squared center movement is <= tol**2, or
    max_iters. The first iteration always runs."""
    centers = init_centers
    prev = init_centers + 10.0  # force the first iteration
    it = 0
    while it < max_iters:
        moved = torch.amax(torch.sum((centers - prev) ** 2, dim=1))
        if not bool(moved > tol * tol):
            break
        new_centers = kmeans_step(x, centers, k, fused=fused)[0]
        prev, centers = centers, new_centers
        it += 1
    if fused:
        # final assignment AND the RSS stats from the same single pass
        st = ops.assign_stats(x, centers)
        idx, best_sim = st.idx, st.best_sim
        rss = metrics.rss_from_assignment_stats(st.sums, st.counts, torch.sum(st.sumsq), k)
    else:
        idx, best_sim = ops.assign_argmax(x, centers)
        rss = metrics.rss(x, idx, k)
    return KMeansResult(
        centers=centers,
        assignment=idx,
        best_sim=best_sim,
        rss=rss,
        objective=metrics.cosine_objective(best_sim),
        iterations=it,
    )


def kmeans(
    x: torch.Tensor,
    k: int,
    generator: torch.Generator,
    *,
    max_iters: int = 8,
    tol: float = 1e-4,
    init_centers: torch.Tensor | None = None,
    fused: bool = True,
) -> KMeansResult:
    """Convenience entry point with the paper's random-document init."""
    if init_centers is None:
        init_centers = init_random_centers(x, k, generator)
    return kmeans_fit(
        x, init_centers, k, max_iters=max_iters, tol=tol, fused=fused
    )
