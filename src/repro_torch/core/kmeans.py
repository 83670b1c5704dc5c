"""Spherical K-Means over the MapReduce pattern (PKMeans, Zhao et al. [26]).

One iteration is one fused pass over the documents:
  map+combine -> nearest center + cluster stats (``ops.assign_stats``)
  reduce      -> new centers, renormalized (spherical K-Means)

``fused=False`` is the two-pass path (``assign_argmax``, then
``label_stats``); ``bounded=True`` carries per-row Elkan/Hamerly bounds
through ``ops.assign_stats_bounded``, with the same centers and labels.

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


def _split_empty_centers_info(
    centers: torch.Tensor,
    sums: torch.Tensor,
    counts: torch.Tensor,
    sumsq: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reseed each empty cluster by splitting the highest-RSS cluster: the
    empty center j becomes the donor's center nudged along basis vector
    j mod d. No-op when no cluster is empty.

    Returns (new_centers, donor id, (k,) bool reseeded-slot mask); the last
    two drive the bounded path's carry invalidation."""
    k, d = centers.shape
    rss_c = sumsq - torch.sum(sums * sums, dim=1) / torch.clamp(counts, min=1.0)
    donor = torch.argmax(torch.where(counts > 0, rss_c, float("-inf")))
    basis = torch.arange(k, device=centers.device) % d
    nudge = 1e-3 * (basis[:, None] == torch.arange(d, device=centers.device)).to(centers.dtype)
    split = l2_normalize(centers[donor][None, :] + nudge)
    reseeded = counts <= 0
    return torch.where(reseeded[:, None], split, centers), donor, reseeded


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
    two-pass path (``assign_argmax``, then ``label_stats``). reseed="split" recovers
    empty clusters (``_split_empty_centers_info``); the default keeps the stale
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
        new_centers = _split_empty_centers_info(new_centers, sums, counts, st.sumsq)[0]
    return new_centers, idx, best_sim, sums, counts


def kmeans_step_bounded(
    x: torch.Tensor,
    centers: torch.Tensor,
    prev_centers: torch.Tensor,
    bounds: ops.Bounds,
    k: int,
    *,
    reseed: str | None = None,
    index: ops.CenterIndex | None = None,
) -> tuple[torch.Tensor, ops.AssignStatsBounded]:
    """Bound-pruned sibling of ``kmeans_step``: the carried bounds are
    deflated by each center's drift ``|centers - prev_centers|`` and rows
    they prove settled skip the center sweep. Labels, statistics and new
    centers equal the brute-force step's for ANY carried bounds state.

    reseed="split" also sends the refreshed bounds of every row assigned to
    the donor or to a reseeded slot back to the unknown sentinel: those
    centers were rewritten by the split, not moved by a drift.

    Returns (new_centers, AssignStatsBounded); ``st.bounds`` is the carry for
    the next step, valid against ``centers``.
    """
    if reseed not in (None, "split"):
        raise ValueError(f"unknown reseed policy {reseed!r}: expected 'split'")
    drift = torch.sqrt(torch.sum((centers - prev_centers) ** 2, dim=1))
    st = ops.assign_stats_bounded(x, centers, bounds, drift, index=index)
    means = st.sums / torch.clamp(st.counts, min=1.0)[:, None]
    new_centers = torch.where(st.counts[:, None] > 0, l2_normalize(means), centers)
    if reseed == "split":
        new_centers, donor, reseeded = _split_empty_centers_info(
            new_centers, st.sums, st.counts, st.sumsq
        )
        stale = reseeded[st.idx.long()] | (reseeded.any() & (st.idx == donor))
        st = st._replace(bounds=ops.bounds_invalidate(st.bounds, stale))
    return new_centers, st


def _moved(centers: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    return torch.amax(torch.sum((centers - prev) ** 2, dim=1))


def kmeans_fit(
    x: torch.Tensor,
    init_centers: torch.Tensor,
    k: int,
    *,
    max_iters: int = 8,
    tol: float = 1e-4,
    fused: bool = True,
    bounded: bool = False,
) -> KMeansResult:
    """Iterate until the largest squared center movement is <= tol**2, or
    max_iters. The first iteration always runs.

    bounded=True carries the Elkan/Hamerly bounds from pass to pass
    (``kmeans_step_bounded``): the same centers and labels, with the sweep
    pruned once the drift settles.
    """
    centers = init_centers
    prev = init_centers + 10.0  # force the first iteration
    bounds = ops.bounds_identity(x.shape[0], x.device) if bounded else None
    it = 0
    while it < max_iters and bool(_moved(centers, prev) > tol * tol):
        if bounded:
            new_centers, st = kmeans_step_bounded(
                x, centers, prev, bounds, k, index=ops.center_index_for(x, centers)
            )
            bounds = st.bounds
        else:
            new_centers = kmeans_step(x, centers, k, fused=fused)[0]
        prev, centers = centers, new_centers
        it += 1
    # final assignment AND the RSS stats from the same single pass
    if bounded:
        drift = torch.sqrt(torch.sum((centers - prev) ** 2, dim=1))
        st = ops.assign_stats_bounded(
            x, centers, bounds, drift, index=ops.center_index_for(x, centers)
        )
    elif fused:
        st = ops.assign_stats(x, centers)
    if bounded or fused:
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
    bounded: bool | None = None,
) -> KMeansResult:
    """Convenience entry point with the paper's random-document init.

    ``bounded=None`` defers to REPRO_ASSIGN_BOUNDS (``ops.bounds_enabled``)."""
    if init_centers is None:
        init_centers = init_random_centers(x, k, generator)
    return kmeans_fit(
        x, init_centers, k, max_iters=max_iters, tol=tol, fused=fused,
        bounded=ops.bounds_enabled(bounded),
    )


def assign_batch(
    x: torch.Tensor,
    centers: torch.Tensor,
    w: torch.Tensor | None = None,
    *,
    index: ops.CenterIndex | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One serving micro-batch: nearest-center assignment through the
    bound-pruned pass. Batch rows are new every call, so the sentinel bounds
    go in, with zero drift; pruning comes from the slab skipping that
    ``index`` steers. Labels equal the brute-force sweep's.

    Returns ``(idx, best_sim)`` for the batch; weight-0 (padding) rows get
    whatever the sweep computes and must be sliced off by the caller.
    """
    st = ops.assign_stats_bounded(
        x,
        centers,
        ops.bounds_identity(x.shape[0], x.device),
        torch.zeros((centers.shape[0],), dtype=torch.float32, device=x.device),
        w,
        index=index,
    )
    return st.idx, st.best_sim
