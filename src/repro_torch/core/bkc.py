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
anchor group. ``bkc_fit_stream`` streams steps 2 and 7 over a
``CorpusStream``. Single-device counterpart of the JAX package's
``core/bkc.py``; the bisection keeps its f32 arithmetic step for step.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
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


# ------------------------------------------------------------------ streaming


def bkc_fit_stream(
    stream,
    init_centers: torch.Tensor,
    big_k: int,
    k: int,
    *,
    checkpoint=None,
    guard=None,
    bounded: bool | None = None,
) -> BKCResult:
    """Out-of-core BKC: passes 1 and 3 stream chunks through the fused
    kernel with carried accumulators on the centers' device (the executor
    prefetches and copies chunk i+1 while chunk i folds); the K×K group
    phase runs on the O(BigK·d) micro-cluster statistics as in ``bkc_fit``.
    Peak residency O(chunk·d + BigK·d) for any collection size.

    ``bounded`` (None → REPRO_ASSIGN_BOUNDS) routes both passes through the
    bound-pruned op with sentinel bounds (and, on the card, a center index):
    the same groups and labels bit for bit. Assignment and best_sim come back
    as host tensors.

    ``checkpoint`` and ``guard`` reach both data passes (pass ids ``bkc/mc``
    and ``bkc/final``); pass 1's micro-cluster statistics are stored as the
    pass result ``bkc/mc``, bound to the initial centers' token and the
    device type, so a restart killed in pass 3 skips pass 1. The result is
    deleted when the run ends.
    """
    from repro_torch.core.kmeans import _host_labels, _stream_pass
    from repro_torch.resilience.checkpoint import array_token

    bounded = ops.bounds_enabled(bounded)
    dev = init_centers.device

    # pass 1: micro-cluster statistics folded over the stream (CF additivity
    # is the chunk monoid)
    mc_stats = None
    if checkpoint is not None:
        mc_meta = {"centers": array_token(init_centers), "device": dev.type}
        mc_stats = checkpoint.load_result("bkc/mc", meta=mc_meta, device=dev)
    if mc_stats is None:
        out = _stream_pass(
            stream, init_centers, big_k, pass_id="bkc/mc", checkpoint=checkpoint,
            guard=guard, bounded=bounded,
            index=ops.center_index_for(init_centers, init_centers) if bounded else None,
        )
        mc_stats = out.stats
        if checkpoint is not None:
            checkpoint.save_result("bkc/mc", mc_stats, meta=mc_meta)
    sums, counts, min_sim, sumsq = mc_stats
    valid = counts > 0
    mc = MicroClusters(
        n=counts,
        cf1=sums,
        cf2=sumsq,
        centers=init_centers,
        min_sim=torch.where(valid, min_sim, 1.0),
        valid=valid,
    )
    centers, group, s = _group_centers(mc, k)

    # pass 3: final assignment — the same streaming pass against the k centers
    out = _stream_pass(
        stream, centers, k, True, pass_id="bkc/final", checkpoint=checkpoint,
        guard=guard, bounded=bounded,
        index=ops.center_index_for(centers, centers) if bounded else None,
    )
    if checkpoint is not None:
        checkpoint.delete_result("bkc/mc")  # the run is over
    sums, counts, _, sumsq = out.stats
    rss = metrics.rss_from_assignment_stats(sums, counts, torch.sum(sumsq), k)
    return BKCResult(
        centers=centers,
        assignment=_host_labels(out.idx, np.int32),
        best_sim=_host_labels(out.best_sim, np.float32),
        rss=rss,
        objective=out.objective,
        group_of_mc=group,
        threshold=s,
    )


def bkc_stream(
    stream,
    big_k: int,
    k: int,
    generator: torch.Generator | None = None,
    *,
    uniforms=None,
    device: str | torch.device | None = None,
    checkpoint=None,
    guard=None,
    bounded: bool | None = None,
) -> BKCResult:
    """Streaming entry point: the BigK random center documents come from the
    one-pass reservoir (``generator`` a CPU generator, or the draws
    ``uniforms`` gives) onto ``device`` (``None`` means the CUDA device),
    then the streaming fit."""
    rows, _ = sampling.reservoir_sample_stream(
        stream, big_k, generator, uniforms=uniforms, device=device,
        checkpoint=checkpoint, guard=guard,
    )
    result = bkc_fit_stream(
        stream, l2_normalize(rows), big_k, k, checkpoint=checkpoint, guard=guard,
        bounded=bounded,
    )
    if checkpoint is not None:
        checkpoint.delete_result("reservoir")  # the run is over
    return result
