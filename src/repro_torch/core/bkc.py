"""BigKClustering for documents (paper §3, Fig. 1).

Pipeline (two full passes over the data + a small BigK x BigK group phase):
  1. randomly select BigK centers from the dataset
  2. assign all docs to the most similar center (pass 1)
  3. build BigK micro-clusters
  4. connection similarity s0 = mean of min_i
  5. joinToGroups: equivalence-relation components, adapt s until #groups == k
  6. group centroids become the k final centers
  7. assign all docs to the final centers (pass 2)

Step 5 is a BISECTION on s over min-label-propagation connected components:
#groups(s) is monotone non-decreasing in s, so the bisection finds an exact-k
threshold whenever one exists; otherwise it takes the smallest s with
#groups >= k and absorbs the smallest surplus groups into their most similar
anchor group. Single-device counterpart of the JAX package's ``core/bkc.py``;
the bisection keeps its f32 arithmetic step for step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.common import l2_normalize, segment_sum
from repro_torch.core import metrics, sampling
from repro_torch.core.connected_components import (
    compact_labels,
    label_components,
    num_components,
)
from repro_torch.core.microcluster import MicroClusters, build_microclusters, pair_similarity
from repro_torch.kernels import ops


class BKCResult(NamedTuple):
    centers: torch.Tensor  # (k, d)
    assignment: torch.Tensor  # (n,) int32
    best_sim: torch.Tensor  # (n,)
    rss: torch.Tensor
    objective: torch.Tensor
    group_of_mc: torch.Tensor  # (BigK,) final group id per micro-cluster
    threshold: torch.Tensor  # f32 connection similarity actually used


def _adjacency(
    pair: torch.Tensor, escape: torch.Tensor, s: torch.Tensor, use_escape: bool
) -> torch.Tensor:
    """Equivalence relation at threshold s (paper's joinToGroups conditions)."""
    edge = (pair > 0.0) & (pair >= s)
    return edge | escape if use_escape else edge


def _groups_at(pair, escape, s, use_escape) -> int:
    return int(num_components(label_components(_adjacency(pair, escape, s, use_escape))))


def _bisect_threshold(
    pair: torch.Tensor, escape: torch.Tensor, k: int, use_escape: bool, iters: int = 40
) -> tuple[torch.Tensor, int]:
    """Find s with #groups(s) == k if possible, else the smallest s with
    #groups >= k. Returns (s, #groups at s). Raising s removes edges, so
    #groups is non-decreasing in s. lo, hi and mid stay f32 tensors: a
    Python float would compute the midpoints in f64 and move the threshold.
    """
    lo = torch.zeros((), dtype=torch.float32, device=pair.device)
    hi = torch.amax(pair) + 1e-3  # no threshold edges -> most groups
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        # too few groups -> raise the threshold; enough -> lower it
        if _groups_at(pair, escape, mid, use_escape) < k:
            lo = mid
        else:
            hi = mid
    return hi, _groups_at(pair, escape, hi, use_escape)


def join_to_groups(mc: MicroClusters, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Paper Fig. 1 joinToGroups: group micro-clusters into exactly k groups.

    Returns ((BigK,) int32 group id per micro-cluster in [0, k), the f32
    threshold used). Invalid (empty) micro-clusters get group k-1 (harmless:
    zero CF mass).
    """
    pair, escape = pair_similarity(mc)

    # Escape-clause edges do not depend on s; if they over-connect the graph
    # so that even the largest s yields < k groups, bisect without them.
    s, g = _bisect_threshold(pair, escape, k, True)
    use_escape = g >= k
    if not use_escape:
        s, _ = _bisect_threshold(pair, escape, k, False)

    labels = label_components(_adjacency(pair, escape, s, use_escape))
    dense = compact_labels(labels)  # [0, G)
    big_k = pair.shape[0]

    # Group mass and centroid directions (CF1 sums through the fixed-order
    # fold; the masses are whole numbers, exact in any order).
    g_n = segment_sum(mc.n, dense, big_k)
    g_dir = l2_normalize(ops.label_stats(mc.cf1, dense, big_k)[0])

    # Keep the k heaviest groups as anchors (stable: ties keep group order);
    # absorb the rest into the most similar anchor by centroid cosine.
    order = torch.argsort(-g_n, stable=True)
    anchors = order[:k]
    anchor_rank = torch.full((big_k,), big_k, dtype=torch.int32, device=pair.device)
    anchor_rank[anchors] = torch.arange(anchors.shape[0], dtype=torch.int32, device=pair.device)
    is_anchor = anchor_rank < k
    nearest_anchor = torch.argmax(g_dir @ g_dir[anchors].T, dim=1).to(torch.int32)
    group_to_final = torch.where(is_anchor, anchor_rank, nearest_anchor)

    final = group_to_final[dense.long()]
    final = torch.where(mc.valid, final, k - 1).to(torch.int32)
    return final, s


def _group_centers(
    mc: MicroClusters, k: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """joinToGroups + step 6 on the (BigK)-sized micro-cluster state."""
    group, s = join_to_groups(mc, k)
    sums = ops.label_stats(mc.cf1, group, k)[0]
    counts = segment_sum(mc.n, group, k)
    centers = torch.where(counts[:, None] > 0, l2_normalize(sums), 0.0)
    return centers, group, s


def bkc_fit(
    x: torch.Tensor,
    init_centers: torch.Tensor,
    big_k: int,
    k: int,
    *,
    fused: bool = True,
    bounded: bool = False,
) -> BKCResult:
    """Run BKC-for-documents given the BigK sampled center documents.

    bounded=True routes both data passes through the bound-pruned op with
    sentinel bounds and, on the card, a two-level center index per pass:
    single passes carry nothing to prune with, so only slab skipping could
    save work. On an H100 at BigK = 800 over the 1 GB collection it saved
    none (58.69 ms with the index against 58.41 ms without), and the route
    is slower than ``fused=True``; it is kept for parity with the reference.
    fused=False runs both passes as ``assign_argmax`` plus separate folds.
    """
    mc, _, _ = build_microclusters(x, init_centers, big_k, fused=fused, bounded=bounded)
    centers, group, s = _group_centers(mc, k)

    # Step 7: final assignment pass (one K-Means-style iteration); the fused
    # path takes assignment AND the RSS stats from the same single read of x.
    if fused:
        if bounded:
            index = ops.center_index_for(x, centers)
            st = ops.assign_stats_bounded(
                x, centers, ops.bounds_identity(x.shape[0], x.device),
                torch.zeros((k,), dtype=torch.float32, device=x.device), index=index,
            )
        else:
            st = ops.assign_stats(x, centers)
        idx, best_sim = st.idx, st.best_sim
        rss = metrics.rss_from_assignment_stats(st.sums, st.counts, torch.sum(st.sumsq), k)
    else:
        idx, best_sim = ops.assign_argmax(x, centers)
        rss = metrics.rss(x, idx, k)
    return BKCResult(
        centers=centers,
        assignment=idx,
        best_sim=best_sim,
        rss=rss,
        objective=metrics.cosine_objective(best_sim),
        group_of_mc=group,
        threshold=s,
    )


def bkc(
    x: torch.Tensor,
    big_k: int,
    k: int,
    generator: torch.Generator,
    *,
    fused: bool = True,
    bounded: bool | None = None,
) -> BKCResult:
    """Convenience entry point: draw BigK center documents with
    ``generator`` (a CPU generator) onto x's device, then fit.
    ``bounded=None`` defers to REPRO_ASSIGN_BOUNDS (``ops.bounds_enabled``)."""
    idx = sampling.sample_indices(x.shape[0], big_k, generator, device=x.device)
    centers = l2_normalize(x[idx])
    return bkc_fit(
        x, centers, big_k, k, fused=fused, bounded=ops.bounds_enabled(bounded)
    )
