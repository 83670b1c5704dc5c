"""Public wrappers of the kernel layer, with the dispatch by device.

A tensor on the CPU takes the plain version in ``ref.py``; a tensor on a
CUDA device launches the hand-written kernel, and a failed build or launch
raises. There is no fallback from the kernel to the plain version. Core
code imports only this module, never the kernels directly.

``launch_counts()`` reads each kernel wrapper's count of launches and
``reset_launch_counts()`` sets them to 0, so a run can show that it went
through the kernels; both hold the lock the wrappers count under.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from repro_torch.common import resolve_device
from repro_torch.kernels import assign_argmax as _assign_argmax_k
from repro_torch.kernels import assign_stats as _assign_stats_k
from repro_torch.kernels import best_edge as _best_edge_k
from repro_torch.kernels import component_reduce as _component_reduce_k
from repro_torch.kernels import flash_decode as _flash_decode_k
from repro_torch.kernels import ref
from repro_torch.kernels import sim_best_edge as _sim_best_edge_k


def launch_counts() -> dict[str, int]:
    from repro_torch.kernels import _build

    with _build.COUNT_LOCK:
        return {
            "sim_best_edge": _sim_best_edge_k.launches,
            "label_stats": _assign_stats_k.launches["label_stats"],
            "assign_stats": _assign_stats_k.launches["assign_stats"],
            "assign_argmax": _assign_argmax_k.launches,
            "assign_stats_bounded": _assign_stats_k.launches["assign_stats_bounded"],
            "component_best_edge": _component_reduce_k.launches,
            "best_edge": _best_edge_k.launches,
            "flash_decode": _flash_decode_k.launches,
        }


def reset_launch_counts() -> None:
    from repro_torch.kernels import _build

    with _build.COUNT_LOCK:
        _sim_best_edge_k.launches = 0
        _assign_argmax_k.launches = 0
        _component_reduce_k.launches = 0
        _best_edge_k.launches = 0
        _flash_decode_k.launches = 0
        for name in _assign_stats_k.launches:
            _assign_stats_k.launches[name] = 0


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}: expected cpu or cuda")


# ---------------------------------------------------------------- assign


def assign_argmax(
    x: torch.Tensor, centers: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(n,d),(k,d) -> ((n,) best center idx, ties -> lowest; (n,) best
    similarity)."""
    if _on_card(x):
        return _assign_argmax_k.assign_argmax_cuda(x.contiguous(), centers.contiguous())
    return ref.assign_argmax(x, centers)


class AssignStats(NamedTuple):
    """Everything one K-Means iteration needs from a pass over x."""

    idx: torch.Tensor  # (n,) int32 nearest-center assignment
    best_sim: torch.Tensor  # (n,) f32 best similarity
    sums: torch.Tensor  # (k, d) f32 weighted per-cluster sums
    counts: torch.Tensor  # (k,) f32 per-cluster weight totals
    min_sim: torch.Tensor  # (k,) f32 lowest member similarity (ref.BIG if empty)
    sumsq: torch.Tensor  # (k,) f32 weighted sum of squared row norms


def assign_stats(
    x: torch.Tensor, centers: torch.Tensor, w: torch.Tensor | None = None
) -> AssignStats:
    """Fused map+combine: nearest center AND cluster statistics.

    ``w`` optionally weights rows; weight-0 rows are excluded everywhere.
    """
    if _on_card(x):
        return AssignStats(*_assign_stats_k.assign_stats_cuda(
            x.contiguous(), centers.contiguous(),
            None if w is None else w.float().contiguous(),
        ))
    return AssignStats(*ref.assign_stats_scatter(x, centers, w))


def stats_identity(
    k: int, d: int, device: str | torch.device
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Identity of the carried (sums, counts, min_sim, sumsq) fold."""
    return (
        torch.zeros((k, d), dtype=torch.float32, device=device),
        torch.zeros((k,), dtype=torch.float32, device=device),
        torch.full((k,), ref.BIG, dtype=torch.float32, device=device),
        torch.zeros((k,), dtype=torch.float32, device=device),
    )


def merge_stats(
    carry: tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
    st: AssignStats,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fold one chunk's AssignStats into the carried accumulators."""
    sums, counts, min_sim, sumsq = carry
    return (
        sums + st.sums,
        counts + st.counts,
        torch.minimum(min_sim, st.min_sim),
        sumsq + st.sumsq,
    )


def assign_stats_chunked(
    x: torch.Tensor,
    centers: torch.Tensor,
    w: torch.Tensor | None = None,
    *,
    chunk: int = 65_536,
) -> AssignStats:
    """The fused pass over row blocks of ``chunk`` rows, folded with
    ``merge_stats`` from ``stats_identity``: one ``assign_stats`` call per
    block, the per-row (idx, best_sim) concatenated. Labels are those of the
    one-shot pass; the statistics are equal bit for bit on integer-valued
    data (another summation order otherwise)."""
    n, d = x.shape
    k = centers.shape[0]
    if n <= chunk:
        return assign_stats(x, centers, w)
    carry = stats_identity(k, d, x.device)
    idxs, sims = [], []
    for lo in range(0, n, chunk):
        st = assign_stats(
            x[lo:lo + chunk], centers, None if w is None else w[lo:lo + chunk]
        )
        carry = merge_stats(carry, st)
        idxs.append(st.idx)
        sims.append(st.best_sim)
    return AssignStats(torch.cat(idxs), torch.cat(sims), *carry)


# ---------------------------------------------------------------- label stats


def label_stats(
    x: torch.Tensor, idx: torch.Tensor, k: int, w: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """(n,d),(n,)[,(n,)] -> ((k,d) weighted sums, (k,) weight totals).

    Labels outside [0, k) (e.g. -1 padding) and weight-0 rows contribute
    nothing.
    """
    if _on_card(x):
        return _assign_stats_k.label_stats_cuda(
            x.contiguous(), idx.to(torch.int32).contiguous(), k,
            None if w is None else w.float().contiguous(),
        )
    return ref.label_stats_scatter(x, idx, k, w)


# ---------------------------------------------------------------- best edge


def best_edge(
    sim: torch.Tensor, labels_row: torch.Tensor, labels_col: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row best cross-component edge of an already-built (r, c)
    similarity block (the single-link / Borůvka inner step): ((r,) int32
    column, ties -> lowest, -1 if none; (r,) f32 similarity, NEG if none)."""
    args = (sim.float().contiguous(), labels_row.to(torch.int32).contiguous(),
            labels_col.to(torch.int32).contiguous())
    if _on_card(sim):
        return _best_edge_k.best_edge_cuda(*args)
    return ref.best_edge(*args)


# ---------------------------------------------------------------- fused sim+edge


def sim_best_edge(
    xs_rows: torch.Tensor,
    xs_all: torch.Tensor,
    labels_row: torch.Tensor,
    labels_col: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row best cross-component edge with the similarity build fused in.

    On the card the (r, c) similarity matrix never reaches device memory; on
    the CPU the plain version builds it.
    """
    lr = labels_row.to(torch.int32)
    lc = labels_col.to(torch.int32)
    if _on_card(xs_rows):
        return _sim_best_edge_k.sim_best_edge_cuda(
            xs_rows.contiguous(), xs_all.contiguous(), lr.contiguous(),
            lc.contiguous(),
        )
    return ref.sim_best_edge(xs_rows, xs_all, lr, lc)


# ---------------------------------------------------------------- component pre-reduce


def component_best_edge(
    row_w: torch.Tensor,
    row_j: torch.Tensor,
    rows: torch.Tensor,
    comp: torch.Tensor,
    c: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-shard Borůvka combiner: per-COMPONENT lexicographic best candidate.

    Folds a shard's per-row best-edge candidates into one (weight, row, col)
    triple per dense component id, ordered (w desc, row asc), so only
    O(#components) values cross the shuffle instead of O(rows). Ids outside
    [0, c) (pad rows) contribute nothing; empty segments get
    (f32.min, BIG_I, -1). On the CPU: the three segment passes of
    ``ref.component_best_edge_segment``.
    """
    args = (
        row_w.float().contiguous(), row_j.to(torch.int32).contiguous(),
        rows.to(torch.int32).contiguous(), comp.to(torch.int32).contiguous(), c,
    )
    if _on_card(row_w):
        return _component_reduce_k.component_best_edge_cuda(*args)
    return ref.component_best_edge_segment(*args)


# ---------------------------------------------------------------- flash decode


def flash_decode(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, length: int | torch.Tensor
) -> torch.Tensor:
    """One-token GQA attention against a KV cache: q (h, dh), k and v
    (s, hk, dh), positions below ``length`` attended (``length`` > s means
    s; ``length`` <= 0 weighs every position alike). Output (h, dh) in q's
    dtype. On the card ``length`` may be a 0-d int32 tensor there, which the
    kernel reads without a host sync; a tensor on the CPU is read here."""
    if _on_card(q):
        if isinstance(length, torch.Tensor) and length.device.type == "cpu":
            length = int(length)
        return _flash_decode_k.flash_decode_cuda(
            q.contiguous(), k.contiguous(), v.contiguous(), length
        )
    return ref.flash_decode(q, k, v, length)


# ---------------------------------------------------------------- bounded


def bounds_enabled(flag: bool | None = None) -> bool:
    """Resolve the bound-pruned assignment default: an explicit flag wins;
    otherwise REPRO_ASSIGN_BOUNDS=1 turns it on process-wide."""
    if flag is not None:
        return bool(flag)
    return os.environ.get("REPRO_ASSIGN_BOUNDS", "") == "1"


class Bounds(NamedTuple):
    """Per-row Elkan/Hamerly carry for bound-pruned assignment.

    ``idx == -1`` marks the unknown sentinel (first pass, or invalidated
    after a reseed); sentinel rows always take the full sweep, so the bounds
    state is a pure performance hint.
    """

    idx: torch.Tensor  # (n,) int32 prior assignment; -1 = unknown
    lo: torch.Tensor  # (n,) f32 lower bound on sim(x, c_idx)
    hi: torch.Tensor  # (n,) f32 upper bound on sim(x, any OTHER center)


def bounds_identity(n: int, device: str | torch.device | None = None) -> Bounds:
    """The unknown-sentinel Bounds every bounded pass can start from.
    ``device=None`` means the CUDA device."""
    dev = resolve_device(device)
    return Bounds(
        torch.full((n,), -1, dtype=torch.int32, device=dev),
        torch.full((n,), -ref.BIG, dtype=torch.float32, device=dev),
        torch.full((n,), ref.BIG, dtype=torch.float32, device=dev),
    )


def bounds_invalidate(b: Bounds, rows: torch.Tensor) -> Bounds:
    """Force the unknown sentinel on a (n,) bool row mask (reseed guard)."""
    return Bounds(
        torch.where(rows, -1, b.idx).to(torch.int32),
        torch.where(rows, -ref.BIG, b.lo),
        torch.where(rows, ref.BIG, b.hi),
    )


class CenterIndex(NamedTuple):
    """Two-level center index: a clustered ORDER over the centers.

    ``perm[slot] = original center id``: similar centers (the same ~sqrt(k)
    Lloyd group) sit in the same slab, so the kernel can bound whole slabs
    and skip those that cannot hold a row's winner. The index changes only
    the visit order: labels stay in original ids, equal to the flat sweep's.
    """

    perm: torch.Tensor  # (k,) int32 original center id per slab-ordered slot
    group_of: torch.Tensor  # (k,) int32 Lloyd group of each original center


# mini-Lloyd rounds that refine the index's group representatives
INDEX_LLOYD_ROUNDS = 2


def build_center_index(centers: torch.Tensor) -> CenterIndex:
    """Cluster the k centers into round(sqrt(k)) groups (mini-Lloyd over
    ``assign_argmax`` and ``label_stats``, the kernels on the card) and emit
    the slab order. Deterministic: the representatives start as a fixed
    stride of the centers, ties go to the lowest index."""
    k = centers.shape[0]
    dev = centers.device
    g = max(1, int(round(k ** 0.5)))
    arange_k = torch.arange(k, dtype=torch.int32, device=dev)
    if g >= k:
        return CenterIndex(arange_k, arange_k)
    stride = -(-k // g)  # ceil
    cf = centers.float().contiguous()
    reps = cf[::stride]
    g = reps.shape[0]
    for _ in range(INDEX_LLOYD_ROUNDS):
        gidx, _ = assign_argmax(cf, reps)
        sums, cnts = label_stats(cf, gidx, g)
        norm = torch.sqrt(torch.sum(sums * sums, dim=1, keepdim=True))
        reps = torch.where(cnts[:, None] > 0, sums / torch.clamp(norm, min=1e-12), reps)
    gidx, _ = assign_argmax(cf, reps)
    # (group, original id) order; the keys are distinct, so the sort is exact
    perm = torch.argsort(gidx.long() * k + arange_k, stable=True).to(torch.int32)
    return CenterIndex(perm, gidx.to(torch.int32))


def center_index_for(x: torch.Tensor, centers: torch.Tensor) -> CenterIndex | None:
    """The slab order ``assign_stats_bounded`` takes for rows x: built where
    x lies on the card, whose kernel skips slabs; None on the CPU, whose
    plain version sweeps every center."""
    return build_center_index(centers) if _on_card(x) else None


class AssignStatsBounded(NamedTuple):
    """AssignStats + the refreshed bounds carry + the prune mask."""

    idx: torch.Tensor  # (n,) int32 nearest-center assignment (original ids)
    best_sim: torch.Tensor  # (n,) f32 best similarity
    sums: torch.Tensor  # (k, d) f32 weighted per-cluster sums
    counts: torch.Tensor  # (k,) f32 per-cluster weight totals
    min_sim: torch.Tensor  # (k,) f32 lowest member similarity (ref.BIG if empty)
    sumsq: torch.Tensor  # (k,) f32 weighted sum of squared row norms
    bounds: Bounds  # refreshed carry, valid against THESE centers
    pruned: torch.Tensor  # (n,) bool: the row skipped the center sweep


def _pack_bounded(raw) -> AssignStatsBounded:
    idx, sim, sums, counts, min_sim, sumsq, bidx, lo, hi, pruned = raw
    return AssignStatsBounded(
        idx, sim, sums, counts, min_sim, sumsq, Bounds(bidx, lo, hi), pruned
    )


def assign_stats_bounded(
    x: torch.Tensor,
    centers: torch.Tensor,
    bounds: Bounds,
    drift: torch.Tensor,
    w: torch.Tensor | None = None,
    *,
    index: CenterIndex | None = None,
) -> AssignStatsBounded:
    """Bound-pruned fused pass: ``assign_stats`` plus an Elkan/Hamerly carry
    that lets provably settled rows skip the center sweep.

    Labels and statistics equal ``assign_stats``' for ANY bounds state. On
    the card the kernel skips the work of pruned rows and of slabs whose
    cone bound cannot reach a row's running best (``index`` orders the
    slabs); the plain version on the CPU sweeps everything and ignores
    ``index``.
    """
    if _on_card(x):
        return _pack_bounded(_assign_stats_k.assign_stats_bounded_cuda(
            x.contiguous(), centers.contiguous(),
            bounds.idx.to(torch.int32).contiguous(), bounds.lo.contiguous(),
            bounds.hi.contiguous(), drift.float().contiguous(),
            None if w is None else w.float().contiguous(),
            perm=None if index is None else index.perm,
        ))
    return _pack_bounded(ref.assign_stats_bounded_scatter(
        x, centers, bounds.idx, bounds.lo, bounds.hi, drift, w
    ))


def assign_stats_bounded_chunked(
    x: torch.Tensor,
    centers: torch.Tensor,
    bounds: Bounds,
    drift: torch.Tensor,
    w: torch.Tensor | None = None,
    *,
    chunk: int = 65_536,
    index: CenterIndex | None = None,
) -> AssignStatsBounded:
    """``assign_stats_bounded`` over row blocks of ``chunk`` rows, the
    bounds sliced per block. Every row's sweep is independent, so labels,
    bounds and the prune mask equal the one-shot pass's; the statistics fold
    through ``merge_stats`` as in ``assign_stats_chunked``."""
    n, d = x.shape
    k = centers.shape[0]
    if n <= chunk:
        return assign_stats_bounded(x, centers, bounds, drift, w, index=index)
    carry = stats_identity(k, d, x.device)
    parts = []
    for lo in range(0, n, chunk):
        sl = slice(lo, lo + chunk)
        st = assign_stats_bounded(
            x[sl], centers, Bounds(bounds.idx[sl], bounds.lo[sl], bounds.hi[sl]),
            drift, None if w is None else w[sl], index=index,
        )
        carry = merge_stats(carry, st)
        parts.append((st.idx, st.best_sim, st.bounds.lo, st.bounds.hi, st.pruned))
    idx, sim, lo_b, hi_b, pruned = (torch.cat(p) for p in zip(*parts))
    return AssignStatsBounded(idx, sim, *carry, Bounds(idx, lo_b, hi_b), pruned)
