"""Spherical K-Means over the MapReduce pattern (PKMeans, Zhao et al. [26]).

One iteration is one fused pass over the documents:
  map+combine -> nearest center + cluster stats (``ops.assign_stats``)
  reduce      -> new centers, renormalized (spherical K-Means)

``fused=False`` is the two-pass path (``assign_argmax``, then
``label_stats``); ``bounded=True`` carries per-row Elkan/Hamerly bounds
through ``ops.assign_stats_bounded``, with the same centers and labels.

``kmeans_fit_stream`` runs the same iterations out of core, one streaming
pass over a ``CorpusStream`` per iteration.

Single-device counterpart of the JAX package's ``core/kmeans.py``. Documents
are expected L2-normalized (cosine semantics, paper §3.1).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
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


# ------------------------------------------------------------------ streaming


def _stream_fold_chunk(carry, x, w, centers):
    """Fold one chunk: ONE fused kernel call, merged into the carry.

    Also returns the chunk's (idx, best_sim, weighted objective term) — they
    fall out of the same single read of the chunk, so the final pass collects
    assignments at no extra cost.
    """
    st = ops.assign_stats(x, centers, w)
    obj = torch.sum(w * (1.0 - st.best_sim))  # pad rows carry w == 0
    return ops.merge_stats(carry, st), (st.idx, st.best_sim, obj)


def _stream_fold_chunk_bounded(carry, x, w, centers, bounds, drift, *, index=None):
    """Bounded sibling of ``_stream_fold_chunk``: the same fold, plus the
    refreshed per-row bounds and the chunk's (pruned, real) row counts for
    the prune rate."""
    st = ops.assign_stats_bounded(x, centers, bounds, drift, w, index=index)
    obj = torch.sum(w * (1.0 - st.best_sim))  # pad rows carry w == 0
    real = w > 0
    pruned = torch.sum((st.pruned & real).float())
    rows = torch.sum(real.float())
    return ops.merge_stats(carry, st), (
        st.idx, st.best_sim, obj, st.bounds, pruned, rows,
    )


class StreamPassOut(NamedTuple):
    """What one streaming assignment pass returns (see ``_stream_pass``)."""

    stats: tuple  # (sums, counts, min_sim, sumsq) folded accumulators
    idx: "np.ndarray | None"  # (n,) collected labels (None unless collect)
    best_sim: "np.ndarray | None"  # (n,) collected similarities
    objective: torch.Tensor  # weighted cosine objective
    bounds: "list | None"  # per-chunk host (idx, lo, hi) blocks (bounded only)
    pruned: float  # real rows that skipped the sweep (bounded only)
    rows: float  # real rows seen (bounded only)


def _stream_pass(
    stream,
    centers: torch.Tensor,
    k: int,
    collect: bool = False,
    *,
    pass_id: str = "kmeans/pass",
    checkpoint=None,
    guard=None,
    bounded: bool = False,
    bounds_blocks=None,
    drift=None,
    index=None,
) -> StreamPassOut:
    """One full pass driven by the streaming executor
    (text/stream.run_pass): the prefetcher's background thread regenerates
    chunk i+1 and copies it to the centers' device while that device folds
    chunk i into the carried f32 accumulators — O(chunk·d + k·d) resident.
    idx/best_sim come back as host arrays only if ``collect``.

    bounded=True carries per-row Elkan/Hamerly bounds: each chunk's prior
    bounds come from ``bounds_blocks`` (the previous pass's per-chunk host
    blocks, aligned by chunk index — the unknown sentinel when absent),
    deflated by the (k,) ``drift`` vector, and the refreshed blocks ride the
    fold carry as host arrays.

    The collected idx/sim blocks and the refreshed bound blocks live INSIDE
    the run_pass carry, so a checkpoint's snapshot captures them with the
    stats and a pass killed mid-collection resumes with its prefix intact;
    the snapshot is bound to ``array_token(centers)``."""
    from repro_torch.resilience.checkpoint import array_token
    from repro_torch.text.stream import run_pass, to_device

    dev = centers.device
    meta = {"centers": array_token(centers)} if checkpoint is not None else None
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    if bounded:
        drift_dev = torch.zeros((k,), dtype=torch.float32, device=dev) if drift is None else drift

        def fold(state, ch, ci):
            carry, obj, idxs, sims, blocks, pruned, rows = state
            x = to_device(ch.x, dev)
            if bounds_blocks is not None and ci < len(bounds_blocks):
                b = ops.Bounds(*(to_device(a, dev) for a in bounds_blocks[ci]))
            else:
                b = ops.bounds_identity(x.shape[0], dev)
            carry, (idx, sim, o, nb, p, r) = _stream_fold_chunk_bounded(
                carry, x, to_device(ch.w, dev), centers, b, drift_dev, index=index
            )
            blocks = blocks + [tuple(t.cpu().numpy() for t in nb)]
            if collect:
                idxs = idxs + [idx.cpu().numpy()]
                sims = sims + [sim.cpu().numpy()]
            return carry, obj + o, idxs, sims, blocks, pruned + p, rows + r

        carry, obj, idxs, sims, blocks, pruned, rows = run_pass(
            stream,
            fold,
            (ops.stats_identity(k, stream.dim, dev), zero, [], [], [], zero, zero),
            copy_to=dev,
            pass_id=pass_id,
            checkpoint=checkpoint,
            guard=guard,
            meta=meta,
        )
    else:

        def fold(state, ch, ci):
            carry, obj, idxs, sims = state
            carry, (idx, sim, o) = _stream_fold_chunk(
                carry, to_device(ch.x, dev), to_device(ch.w, dev), centers
            )
            if collect:
                idxs = idxs + [idx.cpu().numpy()]
                sims = sims + [sim.cpu().numpy()]
            return carry, obj + o, idxs, sims

        carry, obj, idxs, sims = run_pass(
            stream,
            fold,
            (ops.stats_identity(k, stream.dim, dev), zero, [], []),
            copy_to=dev,
            pass_id=pass_id,
            checkpoint=checkpoint,
            guard=guard,
            meta=meta,
        )
        blocks, pruned, rows = None, zero, zero
    return StreamPassOut(
        stats=carry,
        idx=np.concatenate(idxs)[: stream.n] if collect else None,
        best_sim=np.concatenate(sims)[: stream.n] if collect else None,
        objective=obj,
        bounds=blocks,
        pruned=float(pruned),
        rows=float(rows),
    )


def _host_labels(a: np.ndarray | None, dtype: np.dtype) -> torch.Tensor:
    """Collected per-row output as a host tensor ((0,) for an empty stream)."""
    return torch.from_numpy(np.zeros((0,), dtype) if a is None else a)


def _moving(moved: float, tol: float) -> bool:
    """The convergence test of ``kmeans_fit``: the largest squared center
    movement, an f32 value, compared in f32 with tol**2."""
    return bool(torch.tensor(moved, dtype=torch.float32) > tol * tol)


def kmeans_fit_stream(
    stream,
    init_centers: torch.Tensor,
    k: int,
    *,
    max_iters: int = 8,
    tol: float = 1e-4,
    checkpoint=None,
    guard=None,
    bounded: bool | None = None,
    profile: dict | None = None,
) -> KMeansResult:
    """Out-of-core ``kmeans_fit``: the host drives iterations, each
    iteration is one streaming pass through the fused assign+stats kernel
    with carried accumulators on the centers' device — peak residency
    O(chunk·d + k·d), any n.

    The same convergence rule as the resident path (stop when the largest
    squared center movement is <= tol**2); assignment and best_sim come back
    as host tensors trimmed to the real rows. On a one-chunk stream the
    result equals ``kmeans_fit``'s bit for bit.

    With a ``checkpoint`` (``resilience.Checkpointer``) each iteration's
    outcome is stored as the pass result ``kmeans/iter{i}`` (the new centers
    and their movement, keyed by the token of the iteration's INPUT centers
    and bound to the device type) and each pass snapshots its carry: a
    killed job restarted with the same stream and initial centers replays
    the finished iterations from their results, with no data pass, resumes
    the killed pass from its last snapshot, and ends on the uninterrupted
    run's bits. The results are deleted when the run ends.

    ``bounded`` (None → REPRO_ASSIGN_BOUNDS) carries per-chunk
    Elkan/Hamerly bounds between iterations as host blocks: the same labels
    and centers bit for bit. An iteration replayed from its result resets
    them to the unknown sentinel (only pruning suffers). ``profile`` (a
    dict) receives a per-pass ``prune_rate`` list. ``guard='finite'`` raises
    GuardError naming the pass and chunk that first produced a non-finite
    accumulator.
    """
    from repro_torch.resilience.checkpoint import array_token

    bounded = ops.bounds_enabled(bounded)
    dev = init_centers.device
    result_meta = {"device": dev.type}
    centers = init_centers
    prev_centers = None  # None -> unknown drift -> sentinel bounds
    bblocks = None
    iters = 0

    def _drift():
        if prev_centers is None:
            return None
        return torch.sqrt(torch.sum((centers - prev_centers) ** 2, dim=1))

    def _pass(collect, pass_id):
        index = ops.center_index_for(centers, centers) if bounded else None
        out = _stream_pass(
            stream, centers, k, collect, pass_id=pass_id, checkpoint=checkpoint,
            guard=guard, bounded=bounded, bounds_blocks=bblocks, drift=_drift(),
            index=index,
        )
        if profile is not None and bounded:
            profile.setdefault("prune_rate", []).append(out.pruned / max(out.rows, 1.0))
        return out

    for i in range(max_iters):
        pid = f"kmeans/iter{i}"
        if checkpoint is not None:
            done = checkpoint.load_result(pid, meta=result_meta, device=dev)
            if done is not None and done["token"] == array_token(centers):
                centers, moved = done["centers"], done["moved"]
                prev_centers, bblocks = None, None  # no pass ran: bounds unknown
                iters += 1
                if not _moving(moved, tol):
                    break
                continue
        out = _pass(False, pid)
        sums, counts = out.stats[0], out.stats[1]
        means = sums / torch.clamp(counts, min=1.0)[:, None]
        new_centers = torch.where(counts[:, None] > 0, l2_normalize(means), centers)
        moved = float(_moved(new_centers, centers))
        if checkpoint is not None:
            checkpoint.save_result(
                pid,
                {"token": array_token(centers), "centers": new_centers, "moved": moved},
                meta=result_meta,
            )
        prev_centers, bblocks = centers, out.bounds
        centers = new_centers
        iters += 1
        if not _moving(moved, tol):
            break
    # final assignment AND the RSS stats from the same streaming pass
    out = _pass(True, "kmeans/final")
    if checkpoint is not None:
        for i in range(max_iters):  # the run is over: drop iteration results
            checkpoint.delete_result(f"kmeans/iter{i}")
    sums, counts, _, sumsq = out.stats
    rss = metrics.rss_from_assignment_stats(sums, counts, torch.sum(sumsq), k)
    return KMeansResult(
        centers=centers,
        assignment=_host_labels(out.idx, np.int32),
        best_sim=_host_labels(out.best_sim, np.float32),
        rss=rss,
        objective=out.objective,
        iterations=iters,
    )


def kmeans_stream(
    stream,
    k: int,
    generator: torch.Generator | None = None,
    *,
    uniforms=None,
    max_iters: int = 8,
    tol: float = 1e-4,
    device: str | torch.device | None = None,
    checkpoint=None,
    guard=None,
) -> KMeansResult:
    """Streaming entry point: the paper's random-document init drawn by the
    one-pass reservoir (exact uniform k-sample, ``generator`` a CPU
    generator, or the draws ``uniforms`` gives) onto ``device`` (``None``
    means the CUDA device), then the streaming fit."""
    rows, _ = sampling.reservoir_sample_stream(
        stream, k, generator, uniforms=uniforms, device=device,
        checkpoint=checkpoint, guard=guard,
    )
    result = kmeans_fit_stream(
        stream, l2_normalize(rows), k, max_iters=max_iters, tol=tol,
        checkpoint=checkpoint, guard=guard,
    )
    if checkpoint is not None:
        checkpoint.delete_result("reservoir")  # the run is over
    return result
