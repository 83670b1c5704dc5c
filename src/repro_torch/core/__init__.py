"""The paper's clustering algorithms in PyTorch (single device).

  kmeans      — spherical K-Means over the PKMeans map/combine/reduce pattern
  buckshot    — sample -> single-link HAC -> few K-Means iterations
  hac         — single-link via Borůvka (matrix-free) or dense Prim MST
  metrics     — RSS / cosine objective / purity / NMI
"""

from repro_torch.core import metrics, sampling
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
from repro_torch.core.kmeans import KMeansResult, kmeans, kmeans_fit, kmeans_step

__all__ = [
    "BuckshotResult",
    "KMeansResult",
    "MSTEdges",
    "boruvka_mst",
    "buckshot",
    "buckshot_fit",
    "buckshot_phase1",
    "cut_mst_edges",
    "kmeans",
    "kmeans_fit",
    "kmeans_step",
    "metrics",
    "mst_prim",
    "phase1_from_sample",
    "sampling",
    "single_link_labels",
    "single_link_labels_boruvka",
]
