"""Micro-clusters for BKC-for-documents (paper §3.1).

A micro-cluster is the (2d+3)-vector (n_i, CF1_i, CF2_i, Center_i, min_i):
  n_i      member count
  CF1_i    linear sum of member vectors
  CF2_i    sum of squared norms of members
  Center_i the ORIGINAL randomly selected document serving as center
  min_i    the lowest cosine similarity between a member and Center_i seen
           during the assignment pass ('longest distance' -> 'lowest
           similarity')

Stored struct-of-arrays. Single-device counterpart of the JAX package's
``core/microcluster.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.common import segment_min
from repro_torch.kernels import ops


class MicroClusters(NamedTuple):
    n: torch.Tensor  # (K,) f32 member counts
    cf1: torch.Tensor  # (K, d) f32 linear sums
    cf2: torch.Tensor  # (K,) f32 sum of squared norms
    centers: torch.Tensor  # (K, d) original sampled center documents (unit norm)
    min_sim: torch.Tensor  # (K,) f32 lowest member->center cosine similarity
    valid: torch.Tensor  # (K,) bool, False for empty micro-clusters


def build_microclusters(
    x: torch.Tensor,
    centers: torch.Tensor,
    big_k: int,
    *,
    fused: bool = True,
    bounded: bool = False,
) -> tuple[MicroClusters, torch.Tensor, torch.Tensor]:
    """BKC steps 2-3: assign every doc to its most similar center, build MCs.

    fused=True gets assignment, CF1, counts, CF2 and min_sim from ONE
    ``assign_stats`` pass. bounded=True routes that pass through the
    bound-pruned op with sentinel bounds; on the card a two-level center
    index orders the slabs so that whole slabs may be skipped (on the 1 GB
    collection at BigK = 800 none were: see ``bkc_fit``). fused=False is the
    multi-pass path:
    ``assign_argmax``, ``label_stats`` for CF1 and counts, a segment sum of
    squared norms and a segment min. The plain-tensor sums on the card go
    through ``label_stats``, a fold in a fixed order.

    Returns (micro_clusters, idx, best_sim).
    """
    if bounded and fused:
        index = ops.center_index_for(x, centers)
        st = ops.assign_stats_bounded(
            x, centers, ops.bounds_identity(x.shape[0], x.device),
            torch.zeros((big_k,), dtype=torch.float32, device=x.device), index=index,
        )
        idx, best_sim = st.idx, st.best_sim
        sums, counts, cf2, min_sim = st.sums, st.counts, st.sumsq, st.min_sim
    elif fused:
        st = ops.assign_stats(x, centers)
        idx, best_sim = st.idx, st.best_sim
        sums, counts, cf2, min_sim = st.sums, st.counts, st.sumsq, st.min_sim
    else:
        idx, best_sim = ops.assign_argmax(x, centers)
        sums, counts = ops.label_stats(x, idx, big_k)
        xf = x.float()
        sq = torch.einsum("nd,nd->n", xf, xf)
        cf2 = ops.label_stats(sq[:, None], idx, big_k)[0][:, 0]
        min_sim = segment_min(best_sim, idx, big_k)
    valid = counts > 0
    min_sim = torch.where(valid, min_sim, 1.0)  # empty MC: neutral
    return (
        MicroClusters(
            n=counts, cf1=sums, cf2=cf2, centers=centers, min_sim=min_sim, valid=valid
        ),
        idx,
        best_sim,
    )


def merge_stats(a: MicroClusters, b: MicroClusters) -> MicroClusters:
    """CF additivity: elementwise merge of partial micro-cluster statistics
    computed on different chunks or shards."""
    return MicroClusters(
        n=a.n + b.n,
        cf1=a.cf1 + b.cf1,
        cf2=a.cf2 + b.cf2,
        centers=a.centers,  # centers are replicated, not partial
        min_sim=torch.minimum(a.min_sim, b.min_sim),
        valid=a.valid | b.valid,
    )


def pair_similarity(mc: MicroClusters) -> tuple[torch.Tensor, torch.Tensor]:
    """Paper §3.1: sim(Si,Sj) = cos(Center_i, Center_j) - min_i - min_j,
    clamped at 0; plus the escape-clause mask
    (sim == 0) & (cos >= min(min_i, min_j)).

    Returns (pair_sim (K,K), escape (K,K) bool). Diagonal excluded; invalid
    (empty) micro-clusters are isolated.
    """
    cos = mc.centers @ mc.centers.T  # centers are unit-norm documents
    pair = cos - mc.min_sim[:, None] - mc.min_sim[None, :]
    pair = torch.clamp(pair, min=0.0)
    escape = (pair == 0.0) & (cos >= torch.minimum(mc.min_sim[:, None], mc.min_sim[None, :]))
    k = pair.shape[0]
    eye = torch.eye(k, dtype=torch.bool, device=pair.device)
    keep = ~eye & (mc.valid[:, None] & mc.valid[None, :])
    return torch.where(keep, pair, 0.0), escape & keep
