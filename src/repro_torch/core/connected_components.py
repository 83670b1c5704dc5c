"""Connected components via min-label propagation (+ pointer jumping).

Replaces BKC's sequential single-reducer union-find (joinToGroups) with the
logarithmic-round connected components of the paper's reference [15]. Dense
adjacency is fine: the graph has BigK <= ~800 nodes (micro-clusters), not
documents. Single-device counterpart of the JAX package's
``core/connected_components.py``.
"""

from __future__ import annotations

import numpy as np
import torch


def label_components(adj: torch.Tensor) -> torch.Tensor:
    """Component labels (min node id in component) for a dense bool adjacency.

    adj: (m, m) bool, symmetric; self-loops implied.
    Returns: (m,) int32 labels; label[i] == min index of i's component.
    Each propagation step reads one flag back to the host.
    """
    m = adj.shape[0]
    labels = torch.arange(m, dtype=torch.int32, device=adj.device)
    if m == 0:
        return labels
    while True:
        # min over neighbours' labels (and own)
        neigh = torch.where(adj, labels[None, :], m)
        new = torch.minimum(labels, torch.amin(neigh, dim=1)).to(torch.int32)
        # pointer jumping doubles convergence speed: label <- label of label
        new = torch.minimum(new, new[new.long()])
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            return labels


def num_components(labels: torch.Tensor) -> torch.Tensor:
    """Count components from min-id labels (roots satisfy label[i] == i)."""
    m = labels.shape[0]
    roots = labels == torch.arange(m, dtype=labels.dtype, device=labels.device)
    return torch.sum(roots).to(torch.int32)


def compact_labels(labels: torch.Tensor) -> torch.Tensor:
    """Map min-id labels to dense [0, n_components) ids, order-preserving."""
    m = labels.shape[0]
    is_root = labels == torch.arange(m, dtype=labels.dtype, device=labels.device)
    rank = torch.cumsum(is_root.to(torch.int32), dim=0).to(torch.int32) - 1
    return rank[labels.long()]


def label_components_np(adj) -> np.ndarray:
    """Host union-find oracle (tests and tiny host-side paths)."""
    a = adj.cpu().numpy() if isinstance(adj, torch.Tensor) else np.asarray(adj)
    m = a.shape[0]
    parent = np.arange(m)

    def find(v):
        while parent[v] != v:
            parent[v] = parent[parent[v]]
            v = parent[v]
        return v

    ii, jj = np.nonzero(a)
    for u, v in zip(ii, jj):
        ru, rv = find(u), find(v)
        if ru != rv:
            parent[max(ru, rv)] = min(ru, rv)
    # canonicalize to min-id labels
    return np.array([find(v) for v in range(m)], dtype=np.int32)
