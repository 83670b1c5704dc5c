"""Buckshot clustering for big text (paper §4, Fig. 2).

  Phase 1: sample s = sqrt(k n) docs, run single-link HAC on the sample down
    to k clusters, take their centroids as initial centers.
  Phase 2: K-Means assignment of the whole collection, 2-3 iterations.

Phase 1 is matrix-free by default (``hac="boruvka"``): O(log s) rounds of
the fused sim+best-edge kernel, so the (s, s) sample similarity never
exists. ``hac="prim"`` keeps the dense Prim path as the exact oracle. The
initial centers come from one ``label_stats`` pass over the sample. Phase 2
is ``kmeans_fit``; ``bounded=True`` runs it through the bound-pruned pass
(iteration 1 seeds the bounds, the next ones prune against them).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.common import l2_normalize
from repro_torch.core import sampling
from repro_torch.core.hac import single_link_labels, single_link_labels_boruvka
from repro_torch.core.kmeans import KMeansResult, kmeans_fit
from repro_torch.kernels import ops


class BuckshotResult(NamedTuple):
    kmeans: KMeansResult
    sample_idx: torch.Tensor  # (s,) indices of the HAC sample
    sample_labels: torch.Tensor  # (s,) HAC cluster of each sampled doc
    init_centers: torch.Tensor  # (k, d) centers handed to phase 2


def phase1_from_sample(
    xs: torch.Tensor, k: int, *, hac: str = "boruvka"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Phase 1 on already-collected sample rows (s, d): HAC labels (s,) and
    initial centers (k, d)."""
    xs = l2_normalize(xs)
    if hac == "prim":
        labels = single_link_labels(xs @ xs.T, k)
    elif hac == "boruvka":
        labels = single_link_labels_boruvka(xs, k)
    else:
        raise ValueError(f"unknown hac implementation: {hac!r}")
    sums, counts = ops.label_stats(xs, labels, k)
    init_centers = torch.where(counts[:, None] > 0, l2_normalize(sums), 0.0)
    return labels, init_centers


def buckshot_phase1(
    x: torch.Tensor, sample_idx: torch.Tensor, k: int, *, hac: str = "boruvka"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Phase 1 alone: sample HAC labels (s,) + initial centers (k, d)."""
    return phase1_from_sample(x[sample_idx.long()], k, hac=hac)


def buckshot_fit(
    x: torch.Tensor,
    sample_idx: torch.Tensor,
    k: int,
    *,
    kmeans_iters: int = 3,
    fused: bool = True,
    hac: str = "boruvka",
    bounded: bool = False,
) -> BuckshotResult:
    """Run Buckshot given the sampled document indices."""
    labels, init_centers = buckshot_phase1(x, sample_idx, k, hac=hac)
    km = kmeans_fit(
        x, init_centers, k, max_iters=kmeans_iters, tol=0.0, fused=fused,
        bounded=bounded,
    )
    return BuckshotResult(
        kmeans=km,
        sample_idx=sample_idx,
        sample_labels=labels,
        init_centers=init_centers,
    )


def buckshot(
    x: torch.Tensor,
    k: int,
    generator: torch.Generator,
    *,
    sample_size: int | None = None,
    kmeans_iters: int = 3,
    fused: bool = True,
    hac: str = "boruvka",
    bounded: bool | None = None,
) -> BuckshotResult:
    """Paper defaults: s = sqrt(k n), 2-3 assignment iterations. The sample
    is drawn with ``generator`` (a CPU generator) onto x's device.
    ``bounded=None`` defers to REPRO_ASSIGN_BOUNDS (``ops.bounds_enabled``)."""
    n = x.shape[0]
    s = sample_size or sampling.buckshot_sample_size(n, k)
    sample_idx = sampling.sample_indices(n, s, generator, device=x.device)
    return buckshot_fit(
        x, sample_idx, k, kmeans_iters=kmeans_iters, fused=fused, hac=hac,
        bounded=ops.bounds_enabled(bounded),
    )
