"""Single-link hierarchical agglomerative clustering via the MST (paper §4).

Single-link HAC is the maximum-similarity spanning tree with its k-1
weakest edges cut. Counterpart of the JAX package's ``core/hac.py``:

  * ``boruvka_mst`` / ``single_link_labels_boruvka``: the production path,
    matrix-free Borůvka over ``ops.sim_best_edge`` in O(log s) rounds; the
    (s, s) similarity matrix never exists.
  * ``mst_prim`` / ``single_link_labels``: dense O(s^2) Prim, the exact
    oracle for callers that already hold a similarity matrix.
  * ``components_from_edges``: min-label propagation + pointer jumping.
  * ``_round_prep``, ``_merge_round_pre``, ``_merge_round_comp`` and
    ``_expand_round_edges``: the round helpers of distributed Borůvka
    (``distrib/hac_parallel.py``), on pre-reduced per-component winners.

Tie handling (Borůvka): edges are ordered by (weight desc, row asc, col
asc), so each component's proposal is unique and the only duplicate
proposals are mutual pairs (dropped on the higher root). With distinct
weights Borůvka emits a max spanning forest of s-1 edges. The order is per
component, not one order over undirected edges: where two components are
joined by two different edges of exactly equal weight, both may be kept (one
edge too many), as in the JAX package.

JAX's loops become Python loops that keep their early exits; each exit test
reads one flag back from the device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.common import l2_normalize
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG


class MSTEdges(NamedTuple):
    u: torch.Tensor  # (E,) int32 row endpoint (global point id)
    v: torch.Tensor  # (E,) int32 col endpoint
    w: torch.Tensor  # (E,) f32 similarity
    valid: torch.Tensor  # (E,) bool — exactly s-1 True after a full run


def mst_prim(sim: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Maximum spanning tree of a dense (s, s) symmetric similarity
    (diagonal ignored): (s-1,) endpoints and similarities in Prim's order."""
    s = sim.shape[0]
    dev = sim.device
    sim = sim.float()
    in_tree = torch.zeros((s,), dtype=torch.bool, device=dev)
    in_tree[0] = True
    best_sim = sim[0].clone()
    best_sim[0] = NEG
    best_from = torch.zeros((s,), dtype=torch.int32, device=dev)
    eu = torch.zeros((s - 1,), dtype=torch.int32, device=dev)
    ev = torch.zeros((s - 1,), dtype=torch.int32, device=dev)
    ew = torch.zeros((s - 1,), dtype=torch.float32, device=dev)
    for i in range(s - 1):
        cand = torch.where(in_tree, NEG, best_sim)
        j = torch.argmax(cand)
        eu[i] = best_from[j]
        ev[i] = j
        ew[i] = cand[j]
        in_tree[j] = True
        better = sim[j] > best_sim
        best_sim = torch.where(better, sim[j], best_sim)
        best_from = torch.where(better, j.int(), best_from)
    return eu, ev, ew


def components_from_edges(
    n: int, eu: torch.Tensor, ev: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """(n,) int32 min-id component labels of the graph with edges
    (eu[i], ev[i]) where mask[i]."""
    dev = eu.device
    labels = torch.arange(n, dtype=torch.int32, device=dev)
    eu = eu.long()
    ev = ev.long()
    big = torch.tensor(n, dtype=torch.int32, device=dev)
    while True:
        m = torch.where(mask, torch.minimum(labels[eu], labels[ev]), big)
        new = labels.scatter_reduce(0, eu, m, "amin", include_self=True)
        new = new.scatter_reduce(0, ev, m, "amin", include_self=True)
        new = torch.minimum(new, new[new.long()])  # pointer jumping
        if torch.equal(new, labels):
            return labels
        labels = new


def _dense(labels: torch.Tensor) -> torch.Tensor:
    """Min-id labels -> dense ids in root order."""
    rows = torch.arange(labels.shape[0], dtype=labels.dtype, device=labels.device)
    is_root = (labels == rows).int()
    return (torch.cumsum(is_root, 0) - 1).int()[labels.long()]


def _rank_desc(w: torch.Tensor) -> torch.Tensor:
    """Position of each entry in the stable strongest-first order."""
    order = torch.argsort(-w, stable=True)
    return torch.argsort(order, stable=True)


def cut_forest(
    eu: torch.Tensor, ev: torch.Tensor, ew: torch.Tensor, n: int, k: int
) -> torch.Tensor:
    """Cut the k-1 weakest MST edges -> exactly k components; dense labels."""
    del n  # the forest's s-1 edges fix the point count
    keep = _rank_desc(ew) < (eu.shape[0] + 1 - k)  # the s-k strongest edges
    return _dense(components_from_edges(eu.shape[0] + 1, eu, ev, keep))


def single_link_labels(sim: torch.Tensor, k: int) -> torch.Tensor:
    """Exact single-link HAC cut at k clusters for a dense similarity matrix."""
    eu, ev, ew = mst_prim(sim)
    return cut_forest(eu, ev, ew, sim.shape[0], k)


# ----------------------------------------------------------------- Borůvka


def _align_merge(
    labels: torch.Tensor,  # (s,) current component labels (min-id)
    eu: torch.Tensor,  # (s,) proposed edge row endpoint, slotted at the root id
    ev: torch.Tensor,  # (s,) proposed edge col endpoint
    ew: torch.Tensor,  # (s,) proposed edge weight (NEG where no proposal)
    propose: torch.Tensor,  # (s,) bool, True iff slot's root proposes an edge
) -> tuple[torch.Tensor, ...]:
    """Borůvka alignment tail: mutual-edge dedupe + label propagation."""
    s = labels.shape[0]
    rows = torch.arange(s, dtype=torch.int32, device=labels.device)
    target = labels[ev.long()]  # component the edge lands in
    tl = target.long()
    # mutual dedupe: if the target proposes back the same undirected edge,
    # keep only the lower root's copy
    mutual_same = (eu[tl] == ev) & (ev[tl] == eu)
    drop = propose & propose[tl] & mutual_same & (rows > target)
    evalid = propose & ~drop
    new_labels = components_from_edges(s, rows, target, propose)
    return new_labels[labels.long()], eu, ev, ew, evalid


def _merge_round(
    labels: torch.Tensor,  # (s,) current component labels (min-id)
    row_w: torch.Tensor,  # (s,) best cross-edge weight per row (NEG if none)
    row_j: torch.Tensor,  # (s,) best cross-edge col per row (-1 if none)
) -> tuple[torch.Tensor, ...]:
    """One Borůvka alignment: per-component best edge, dedupe, merge.

    Returns (new_labels, eu, ev, ew, evalid) with one slot per point id
    (slot c used iff c is a component root that proposed an edge).
    """
    s = labels.shape[0]
    dev = labels.device
    rows = torch.arange(s, dtype=torch.int32, device=dev)
    # per-component best by (label asc, w desc, row asc): stable sorts from
    # the minor key up (rows are already in ascending order)
    by_w = torch.argsort(-row_w, stable=True)
    order = by_w[torch.argsort(labels[by_w], stable=True)]
    lab_sorted = labels[order]
    first = torch.ones((s,), dtype=torch.bool, device=dev)
    first[1:] = lab_sorted[1:] != lab_sorted[:-1]
    # winner row per component root; other positions go to a sink slot
    win_row = torch.zeros((s + 1,), dtype=torch.int32, device=dev)
    win_row[torch.where(first, lab_sorted, s).long()] = order.int()
    win_row = win_row[:s].long()

    propose = (row_j[win_row] >= 0) & (labels == rows)
    eu = torch.where(propose, win_row.int(), 0).int()
    ev = torch.where(propose, row_j[win_row], 0).int()
    ew = torch.where(propose, row_w[win_row], NEG)
    return _align_merge(labels, eu, ev, ew, propose)


def _scatter_slots(n: int, slot: torch.Tensor, values: torch.Tensor, fill) -> torch.Tensor:
    """(n,) tensor filled with ``fill``, ``values`` written at ``slot``;
    slots outside [0, n) go to a sink entry and are dropped."""
    out = torch.full((n + 1,), fill, dtype=values.dtype, device=values.device)
    out[torch.where((slot >= 0) & (slot < n), slot, n).long()] = values
    return out[:n]


def _merge_round_pre(
    labels: torch.Tensor,  # (s,) current component labels (min-id)
    best_w: torch.Tensor,  # (c,) pre-reduced best weight per dense component
    best_row: torch.Tensor,  # (c,) winning global row id per dense component
    best_j: torch.Tensor,  # (c,) winning col per dense component (-1 if none)
    comp_to_root: torch.Tensor,  # (c,) dense component id -> root point id
) -> tuple[torch.Tensor, ...]:
    """Pre-reduced Borůvka alignment: per-COMPONENT winners off the
    distributed combiner are scattered into the point-id slots that
    ``_align_merge`` takes. The winner order (w desc, row asc) is
    ``_merge_round``'s, so both build the same forest."""
    s = labels.shape[0]
    has_edge = best_j >= 0
    slot = torch.where(has_edge, comp_to_root, s)  # no-edge comps are dropped
    eu = _scatter_slots(s, slot, best_row.int(), 0)
    ev = _scatter_slots(s, slot, torch.clamp(best_j, min=0).int(), 0)
    ew = _scatter_slots(s, slot, best_w.float(), NEG)
    propose = _scatter_slots(s, slot, has_edge, False)
    return _align_merge(labels, eu, ev, ew, propose)


def _merge_round_comp(
    best_w: torch.Tensor,  # (cap,) pre-reduced best weight per dense component
    best_row: torch.Tensor,  # (cap,) winning global row id per dense component
    best_j: torch.Tensor,  # (cap,) winning col per dense component (-1 if none)
    best_tcomp: torch.Tensor,  # (cap,) dense component id of the winning col
    comp_to_root: torch.Tensor,  # (cap,) dense component id -> root point id
    n_real: torch.Tensor,  # () real component count entering the round (<= cap)
    *,
    next_cap: int,  # halving bound entering the NEXT round
) -> tuple[torch.Tensor, ...]:
    """Component-graph Borůvka alignment: dedupe, propagation and densify on
    (cap,) arrays, never on an (s,) one. Point labels follow through one
    gather by the returned ``relabel`` map.

    Old dense ids are root ranks, so the min-old-dense-id representative is
    the min-root-point-id one ``_align_merge`` picks; expanded through
    ``_expand_round_edges`` the forest equals the point-level path's.

    Slots [n_real, cap) are PHANTOM ids: empty segments (no proposal) that
    stay isolated singletons. Every real id is below every phantom id, so the
    densify ranks real roots first; phantom roots past ``next_cap`` are
    dropped from the new root map, and ``n_real`` counts only live ones.

    Returns (relabel (cap,) old dense -> new dense id, new_comp_to_root
    (next_cap,), eu, ev, ew, evalid (cap,) compact edge slots indexed by OLD
    dense id, n_real () LIVE component count after the merge).
    """
    cap = best_w.shape[0]
    u = torch.arange(cap, dtype=torch.int32, device=best_w.device)
    propose = best_j >= 0
    target = torch.where(propose, best_tcomp, u).int()
    tl = target.long()
    # mutual dedupe on the POINT-level endpoints, _align_merge's rule: the
    # higher old dense id (the higher root point id) drops its copy
    mutual_same = (best_row[tl] == best_j) & (best_j[tl] == best_row)
    drop = propose & propose[tl] & mutual_same & (u > target)
    evalid = propose & ~drop
    eu = torch.where(propose, best_row, 0).int()
    ev = torch.where(propose, torch.clamp(best_j, min=0), 0).int()
    ew = torch.where(propose, best_w, NEG)

    group = components_from_edges(cap, u, target, propose)  # min old dense id
    is_root = group == u
    dense = (torch.cumsum(is_root.int(), 0) - 1).int()  # rank of each new root
    relabel = dense[group.long()]
    new_root = _scatter_slots(next_cap, torch.where(is_root, dense, next_cap),
                              comp_to_root.int(), 0)
    n_real_new = torch.sum(is_root & (u < n_real)).int()
    return relabel, new_root, eu, ev, ew, evalid, n_real_new


def _expand_round_edges(
    slots: torch.Tensor | int,  # (s,) template tensor OR the slot count itself
    eu: torch.Tensor,  # (cap,) compact edge slots, indexed by dense comp id
    ev: torch.Tensor,
    ew: torch.Tensor,
    evalid: torch.Tensor,
    comp_to_root: torch.Tensor,  # (cap,) dense comp id -> root point id
) -> tuple[torch.Tensor, ...]:
    """Scatter one round's compact (cap,) edges into the (s,) point-id slot
    layout ``_merge_round_pre`` emits: the parity bridge between the
    component-level and point-level merges. ``slots`` may be the count
    itself: the sharded sweep keeps no (s,) array to pass."""
    s = slots if isinstance(slots, int) else slots.shape[0]
    slot = torch.where(ew > NEG, comp_to_root, s)
    return (
        _scatter_slots(s, slot, eu.int(), 0),
        _scatter_slots(s, slot, ev.int(), 0),
        _scatter_slots(s, slot, ew.float(), NEG),
        _scatter_slots(s, slot, evalid, False),
    )


def _round_prep(labels: torch.Tensor, cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense component ids for one Borůvka round: (comp (s,) dense id per
    point, comp_to_root (cap,) dense id -> root point id), with cap the
    halving bound ceil(s / 2^round) >= #components."""
    s = labels.shape[0]
    rows = torch.arange(s, dtype=torch.int32, device=labels.device)
    is_root = labels == rows
    dense = (torch.cumsum(is_root.int(), 0) - 1).int()  # rank of each root
    comp = dense[labels.long()]
    comp_to_root = _scatter_slots(cap, torch.where(is_root, dense, cap), rows, 0)
    return comp, comp_to_root


def _rounds_for(s: int) -> int:
    return max(1, math.ceil(math.log2(max(s, 2)))) + 1


def boruvka_mst(xs: torch.Tensor) -> MSTEdges:
    """Max spanning forest of the cosine graph of xs (s, d) on one device.

    O(log s) rounds of the fused sim+best-edge search, each one pass that
    never builds the (s, s) matrix. The loop stops early once every point
    has merged into one component.
    """
    s = xs.shape[0]
    dev = xs.device
    xs = l2_normalize(xs)
    rounds = _rounds_for(s)
    labels = torch.arange(s, dtype=torch.int32, device=dev)
    eu = torch.zeros((rounds, s), dtype=torch.int32, device=dev)
    ev = torch.zeros((rounds, s), dtype=torch.int32, device=dev)
    ew = torch.full((rounds, s), NEG, dtype=torch.float32, device=dev)
    evalid = torch.zeros((rounds, s), dtype=torch.bool, device=dev)
    for r in range(rounds):
        # labels are min-id: a single component means everyone carries 0
        if not bool(torch.any(labels != 0)):
            break
        bj, bw = ops.sim_best_edge(xs, xs, labels, labels)
        labels, eu[r], ev[r], ew[r], evalid[r] = _merge_round(labels, bw, bj)
    return MSTEdges(
        u=eu.reshape(-1), v=ev.reshape(-1), w=ew.reshape(-1),
        valid=evalid.reshape(-1),
    )


def cut_mst_edges(edges: MSTEdges, n: int, k: int) -> torch.Tensor:
    """Single-link labels at k clusters from a masked MST edge set: keep the
    n-k strongest valid edges, label components densely in [0, k)."""
    w = torch.where(edges.valid, edges.w, NEG)
    keep = edges.valid & (_rank_desc(w) < (n - k))
    return _dense(components_from_edges(n, edges.u, edges.v, keep))


def single_link_labels_boruvka(xs: torch.Tensor, k: int) -> torch.Tensor:
    """Drop-in equivalent of single_link_labels, matrix-free Borůvka-style."""
    return cut_mst_edges(boruvka_mst(xs), xs.shape[0], k)
