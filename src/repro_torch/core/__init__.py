"""The paper's clustering algorithms in PyTorch (single device).

  kmeans      — spherical K-Means over the PKMeans map/combine/reduce pattern
  bkc         — BigKClustering: micro-clusters -> joinToGroups -> final pass
  buckshot    — sample -> single-link HAC -> few K-Means iterations
  hac         — single-link via Borůvka (matrix-free) or dense Prim MST
  metrics     — RSS / cosine objective / purity / NMI
"""

from repro_torch.core import metrics, sampling
from repro_torch.core.bkc import BKCResult, bkc, bkc_fit, join_to_groups
from repro_torch.core.buckshot import (
    BuckshotResult,
    buckshot,
    buckshot_fit,
    buckshot_phase1,
    phase1_from_sample,
)
from repro_torch.core.hac import (
    MSTEdges,
    boruvka_mst,
    cut_mst_edges,
    mst_prim,
    single_link_labels,
    single_link_labels_boruvka,
)
from repro_torch.core.connected_components import (
    compact_labels,
    label_components,
    label_components_np,
    num_components,
)
from repro_torch.core.kmeans import (
    KMeansResult,
    assign_batch,
    kmeans,
    kmeans_fit,
    kmeans_step,
    kmeans_step_bounded,
)
from repro_torch.core.microcluster import (
    MicroClusters,
    build_microclusters,
    merge_stats,
    pair_similarity,
)

__all__ = [
    "BKCResult",
    "BuckshotResult",
    "KMeansResult",
    "MSTEdges",
    "MicroClusters",
    "assign_batch",
    "bkc",
    "bkc_fit",
    "boruvka_mst",
    "build_microclusters",
    "buckshot",
    "buckshot_fit",
    "buckshot_phase1",
    "compact_labels",
    "cut_mst_edges",
    "join_to_groups",
    "kmeans",
    "kmeans_fit",
    "kmeans_step",
    "kmeans_step_bounded",
    "label_components",
    "label_components_np",
    "merge_stats",
    "metrics",
    "mst_prim",
    "num_components",
    "pair_similarity",
    "phase1_from_sample",
    "sampling",
    "single_link_labels",
    "single_link_labels_boruvka",
]
