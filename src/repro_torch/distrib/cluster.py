"""Distributed K-Means / BKC / Buckshot: the paper's MapReduce jobs on the
engine, resident (every rank holds its row block of the collection).

Each rank passes its own rows ``x`` (n_local, d) and weights ``w`` (1.0
for real rows, 0.0 for padding: ``sharding.pad_rows_to_multiple`` then
``sharding.shard_rows``); centers and micro-cluster statistics are
replicated. Job structure mirrors the paper:

  K-Means   : one job per iteration (map=assign, combine=partial stats,
              reduce=sum) — PKMeans [26].
  BKC       : job 1 = micro-cluster statistics (sum/min of CF stats);
              job 2 = joinToGroups on the replicated (BigK)-sized state
              (the paper's single reducer, run by every rank);
              job 3 = final assignment (shard labels + RSS stats).
  Buckshot  : job 0a = distributed uniform sample (local top-s, gathered
              global top-s); job 0b = sample row collection (sum of
              one-owner buffers); phase 1 HAC on the replicated sample;
              phase 2 = 2-3 K-Means jobs.

Every algorithm also has an out-of-core ``*_distributed_stream`` twin: the
same jobs in the engine's fold mode, driven chunk by chunk by the shared
streaming executor (``text/stream.run_pass``: each chunk cut to the rank's
block on arrival while the prefetcher stages the next one), with ONE
collective per pass. Buckshot's streaming sample is the sharded running
reservoir (``reservoir_sample_distributed_stream``, fold-mode 'topk').

Counterpart of the JAX package's ``distrib/cluster.py``. ``assignment`` in
a resident result is this rank's block; a streaming driver's is the whole
(n,) host tensor on every rank, as the JAX package's drivers return it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.common import l2_normalize
from repro_torch.core.bkc import _group_centers
from repro_torch.core.hac import single_link_labels_boruvka
from repro_torch.core.microcluster import MicroClusters
from repro_torch.distrib.engine import _gather, _top, make_fold_job, make_job
from repro_torch.distrib.sharding import (
    axis_groups,
    check_stream_shardable,
    mesh_axis_size,
    mesh_device,
    shard_index,
    shard_stream,
)
from repro_torch.kernels import ops


class DistClusterResult(NamedTuple):
    centers: torch.Tensor  # (k, d) replicated
    assignment: torch.Tensor  # (n_local,) this rank's rows
    rss: torch.Tensor  # scalar (replicated)
    objective: torch.Tensor  # scalar cosine objective
    iterations: int


# ----------------------------------------------------------------- common jobs


def _assign_stats_map():
    """map+combine for one K-Means iteration (also BKC job 3): ONE fused
    ``assign_stats`` pass per shard gives assignment, weighted sums, counts
    and squared norms from a single read of the shard."""

    def map_combine(data, bcast):
        x, w = data["x"], data["w"]
        st = ops.assign_stats(x, bcast["centers"], w)
        return {
            "sums": st.sums,
            "counts": st.counts,
            "sumsq": st.sumsq,
            "obj": torch.sum(w * (1.0 - st.best_sim)),
            "idx": st.idx,
            "sim": st.best_sim,
        }

    kinds = {"sums": "sum", "counts": "sum", "sumsq": "sum", "obj": "sum",
             "idx": "shard", "sim": "shard"}
    return map_combine, kinds


def _assign_stats_bounded_map():
    """Bound-pruned twin of ``_assign_stats_map``. The bounds are
    SHARD-LOCAL row state riding the data tree (kind 'shard' on the way
    out), so pruning adds no collective: only the (k,) drift rides the
    bcast, and a scalar 'pruned' count joins the sums. A center index, when
    the bcast carries one ('perm', 'group_of'), orders the slabs."""

    def map_combine(data, bcast):
        x, w = data["x"], data["w"]
        bounds = ops.Bounds(data["bidx"], data["blo"], data["bhi"])
        index = (
            ops.CenterIndex(bcast["perm"], bcast["group_of"]) if "perm" in bcast else None
        )
        st = ops.assign_stats_bounded(x, bcast["centers"], bounds, bcast["drift"], w,
                                      index=index)
        return {
            "sums": st.sums,
            "counts": st.counts,
            "sumsq": st.sumsq,
            "obj": torch.sum(w * (1.0 - st.best_sim)),
            "pruned": torch.sum(torch.where(st.pruned & (w > 0), 1.0, 0.0)),
            "idx": st.idx,
            "sim": st.best_sim,
            "bidx": st.bounds.idx,
            "blo": st.bounds.lo,
            "bhi": st.bounds.hi,
        }

    kinds = {"sums": "sum", "counts": "sum", "sumsq": "sum", "obj": "sum", "pruned": "sum",
             "idx": "shard", "sim": "shard", "bidx": "shard", "blo": "shard", "bhi": "shard"}
    return map_combine, kinds


def _bounds_bcast(centers, drift, index):
    """Broadcast tree of a bounded job: drift defaults to zeros (sentinel
    bounds never prune, so zeros are exact for a first pass)."""
    k = centers.shape[0]
    b = {
        "centers": centers,
        "drift": (
            torch.zeros((k,), dtype=torch.float32, device=centers.device)
            if drift is None else drift
        ),
    }
    if index is not None:
        b["perm"], b["group_of"] = index.perm, index.group_of
    return b


def _new_centers(sums, counts, old):
    means = sums / torch.clamp(counts, min=1.0)[:, None]
    return torch.where(counts[:, None] > 0, l2_normalize(means), old)


def _rss(sums, counts, sumsq):
    """RSS from the reduced (k,) statistics. The squared norms travel per
    cluster (the JAX package sums them to one scalar per shard) and are
    summed here, as every single-device path of the port sums them: at one
    rank the distributed RSS has the single-device bits."""
    means = sums / torch.clamp(counts, min=1.0)[:, None]
    return torch.sum(sumsq) - torch.sum(counts * torch.sum(means * means, dim=1))


# ----------------------------------------------------------------- K-Means


def kmeans_distributed(
    mesh: DeviceMesh,
    axes: tuple[str, ...],
    x: torch.Tensor,
    w: torch.Tensor,
    init_centers: torch.Tensor,
    k: int,
    *,
    max_iters: int = 8,
    tol: float = 1e-4,
    bounded: bool | None = None,
) -> DistClusterResult:
    """PKMeans: the host drives iterations (the paper's job-chaining
    driver); each iteration is ONE MapReduce job on the mesh.

    ``bounded`` (None -> REPRO_ASSIGN_BOUNDS) carries shard-local
    triangle-inequality bounds between iterations, with a center index per
    pass where x lies on the card; labels equal the brute sweep's."""
    bounded = ops.bounds_enabled(bounded)
    if bounded:
        map_combine, kinds = _assign_stats_bounded_map()
    else:
        map_combine, kinds = _assign_stats_map()
    job = make_job(mesh, axes, map_combine, kinds, name="kmeans_iter")

    def run(centers, bounds, drift):
        if not bounded:
            return job({"x": x, "w": w}, {"centers": centers})
        index = ops.center_index_for(x, centers)
        data = {"x": x, "w": w, "bidx": bounds.idx, "blo": bounds.lo, "bhi": bounds.hi}
        return job(data, _bounds_bcast(centers, drift, index))

    centers = init_centers
    bounds = ops.bounds_identity(x.shape[0], x.device) if bounded else None
    drift = None
    it = 0
    for it in range(1, max_iters + 1):
        out = run(centers, bounds, drift)
        if bounded:
            bounds = ops.Bounds(out["bidx"], out["blo"], out["bhi"])
        new_centers = _new_centers(out["sums"], out["counts"], centers)
        sq_moved = torch.sum((new_centers - centers) ** 2, dim=1)
        moved = float(torch.amax(sq_moved))
        if bounded:
            drift = torch.sqrt(sq_moved)
        centers = new_centers
        if moved <= tol * tol:
            break
    # final assignment against the converged centers
    out = run(centers, bounds, drift)
    return DistClusterResult(
        centers=centers,
        assignment=out["idx"],
        rss=_rss(out["sums"], out["counts"], out["sumsq"]),
        objective=out["obj"],
        iterations=it,
    )


# ----------------------------------------------------------------- BKC


def bkc_distributed(
    mesh: DeviceMesh,
    axes: tuple[str, ...],
    x: torch.Tensor,
    w: torch.Tensor,
    init_centers: torch.Tensor,
    big_k: int,
    k: int,
    *,
    bounded: bool | None = None,
) -> DistClusterResult:
    """BKC-for-documents as the paper's three MapReduce jobs.

    ``bounded`` routes both data jobs through the bound-pruned op with
    sentinel bounds (and a center index where x lies on the card)."""
    bounded = ops.bounds_enabled(bounded)

    def mc_map(data, bcast):
        if bounded:
            index = (
                ops.CenterIndex(bcast["perm"], bcast["group_of"]) if "perm" in bcast else None
            )
            st = ops.assign_stats_bounded(
                data["x"], bcast["centers"], ops.Bounds(data["bidx"], data["blo"], data["bhi"]),
                bcast["drift"], data["w"], index=index,
            )
        else:
            st = ops.assign_stats(data["x"], bcast["centers"], data["w"])
        return {"n": st.counts, "cf1": st.sums, "cf2": st.sumsq, "min_sim": st.min_sim}

    # ---- job 1: micro-cluster statistics (one fused pass per shard)
    job1 = make_job(mesh, axes, mc_map,
                    {"n": "sum", "cf1": "sum", "cf2": "sum", "min_sim": "min"},
                    name="bkc_microclusters")

    def data_pass(job, centers):
        if not bounded:
            return job({"x": x, "w": w}, {"centers": centers})
        b = ops.bounds_identity(x.shape[0], x.device)
        return job({"x": x, "w": w, "bidx": b.idx, "blo": b.lo, "bhi": b.hi},
                   _bounds_bcast(centers, None, ops.center_index_for(x, centers)))

    stats = data_pass(job1, init_centers)
    valid = stats["n"] > 0
    mc = MicroClusters(
        n=stats["n"],
        cf1=stats["cf1"],
        cf2=stats["cf2"],
        centers=init_centers,
        min_sim=torch.where(valid, stats["min_sim"], 1.0),
        valid=valid,
    )

    # ---- job 2: joinToGroups on the replicated (BigK)-sized state; the
    # paper's single reducer, run by every rank on the same values
    centers, _, _ = _group_centers(mc, k)

    # ---- job 3: final assignment pass
    map_combine, kinds = _assign_stats_bounded_map() if bounded else _assign_stats_map()
    out = data_pass(make_job(mesh, axes, map_combine, kinds, name="bkc_final_assign"), centers)
    return DistClusterResult(
        centers=centers,
        assignment=out["idx"],
        rss=_rss(out["sums"], out["counts"], out["sumsq"]),
        objective=out["obj"],
        iterations=2,  # two full passes over the data
    )


# ----------------------------------------------------------------- Buckshot


def shard_generator(seed: int, shard: int) -> torch.Generator:
    """The CPU generator of one shard's sample scores: seeded with
    ``numpy.random.SeedSequence((seed, shard)).generate_state(1)[0]``, so
    every (seed, shard) pair draws its own stream (the JAX package folds the
    shard index into its key)."""
    state = int(np.random.SeedSequence((seed, shard)).generate_state(1)[0])
    return torch.Generator().manual_seed(state)


def sample_indices_distributed(
    mesh: DeviceMesh,
    axes: tuple[str, ...],
    w: torch.Tensor,
    s: int,
    seed: int,
) -> torch.Tensor:
    """(s,) int32 global row ids of a uniform sample (without replacement)
    of s real rows, replicated on every rank: ids index the padded row
    blocks in rank order.

    Exactness: the global top-s of iid uniform scores is a uniform s-subset,
    and it lies in the union of the per-shard top-s sets. Shard i scores its
    rows from ``shard_generator(seed, i)``.
    """
    n_local = w.shape[0]
    count = make_job(mesh, axes, lambda data, _: {"n": torch.sum(data["w"] > 0).int()},
                     {"n": "sum"}, name="sample_count")
    n_real = int(count({"w": w})["n"])
    if s > n_real:
        raise ValueError(f"cannot sample {s} rows from {n_real} real rows without replacement")
    me = shard_index(mesh, axes)

    def sample_map(data, bcast):
        ws = data["w"]
        u = torch.rand(ws.shape, generator=shard_generator(bcast["seed"], me)).to(ws.device)
        # pad rows score -1, strictly below any real row's [0, 1) draw
        u = torch.where(ws > 0, u, -1.0)
        li = _top(u, min(s, n_local))
        return {"scores": u[li], "gidx": (li + me * n_local).int()}

    job = make_job(mesh, axes, sample_map, {"scores": "gather", "gidx": "gather"},
                   name="sample_topk")
    cand = job({"w": w}, {"seed": seed})
    return cand["gidx"][_top(cand["scores"], s)]


def sample_rows_distributed(
    mesh: DeviceMesh,
    axes: tuple[str, ...],
    x: torch.Tensor,
    w: torch.Tensor,
    s: int,
    seed: int,
) -> torch.Tensor:
    """Uniform sample (without replacement) of s real rows -> (s, d),
    replicated on every rank: the rows of ``sample_indices_distributed``.
    Each winner row is owned by one shard, so the sum of per-shard
    one-owner buffers reconstructs the sample.
    """
    n_local = x.shape[0]
    me = shard_index(mesh, axes)
    sample_gidx = sample_indices_distributed(mesh, axes, w, s, seed)

    def collect_map(data, bcast):
        gidx = bcast["gidx"].long()
        mine = (gidx // n_local) == me
        local = torch.where(mine, gidx % n_local, 0)
        return {"rows": torch.where(mine[:, None], data["x"][local], 0.0)}

    job = make_job(mesh, axes, collect_map, {"rows": "sum"}, name="sample_collect")
    return job({"x": x}, {"gidx": sample_gidx})["rows"]


def _phase1_init_centers(
    mesh: DeviceMesh,
    axes: tuple[str, ...],
    xs: torch.Tensor,
    k: int,
    *,
    hac: str,
    sweep: str = "auto",
    overlap: bool = True,
) -> torch.Tensor:
    """Buckshot phase 1 on the replicated (s, d) sample -> (k, d) initial
    centers. Both flavours are matrix-free:

    hac = "replicated": phase 1 runs on every rank, the resident Borůvka.
    hac = "boruvka": the per-row edge search is sharded over the mesh
      (``hac_parallel``): the paper's PARABLE partition + align, the same
      labels bit for bit. ``sweep``/``overlap`` pass through to
      ``boruvka_mst_distributed``.
    """
    xs = l2_normalize(xs)
    if hac == "boruvka":
        from repro_torch.distrib.hac_parallel import single_link_labels_distributed

        labels = single_link_labels_distributed(mesh, axes, xs, k, sweep=sweep, overlap=overlap)
    elif hac == "replicated":
        labels = single_link_labels_boruvka(xs, k)
    else:
        raise ValueError(f"hac must be 'replicated' or 'boruvka', got {hac!r}")
    sums, counts = ops.label_stats(xs, labels, k)
    return torch.where(counts[:, None] > 0, l2_normalize(sums), 0.0)


def buckshot_distributed(
    mesh: DeviceMesh,
    axes: tuple[str, ...],
    x: torch.Tensor,
    w: torch.Tensor,
    k: int,
    seed: int,
    *,
    sample_size: int,
    kmeans_iters: int = 3,
    hac: str = "replicated",
    sweep: str = "auto",
    overlap: bool = True,
    sample_rows: torch.Tensor | None = None,
    bounded: bool | None = None,
) -> DistClusterResult:
    """Buckshot: distributed sample -> single-link HAC -> 2-3 distributed
    K-Means iterations (phase-1 flavours: ``_phase1_init_centers``).

    ``sample_rows`` (s, d) replaces the sampler: the parity hook, since
    torch cannot draw the JAX package's samples."""
    if sample_rows is None:
        sample_rows = sample_rows_distributed(mesh, axes, x, w, sample_size, seed)
    init_centers = _phase1_init_centers(
        mesh, axes, sample_rows, k, hac=hac, sweep=sweep, overlap=overlap,
    )
    return kmeans_distributed(
        mesh, axes, x, w, init_centers, k, max_iters=kmeans_iters, tol=0.0, bounded=bounded,
    )


# ------------------------------------------------------- streaming passes


def _gather_rows(mesh: DeviceMesh, axes: tuple[str, ...], blocks: list, n: int, dev):
    """Every rank's per-chunk row blocks -> the whole (n,) host array in
    global row order: ONE all-gather of the stacked (chunks, chunk/P)
    blocks (4 bytes a row for int32 labels), laid out chunk by chunk, shard
    by shard within a chunk."""
    local = torch.from_numpy(np.stack(blocks)).to(dev)
    every = _gather(local, axis_groups(mesh, axes))  # (P · chunks, chunk/P)
    n_shards = mesh_axis_size(mesh, axes)
    every = every.reshape(n_shards, *local.shape).transpose(0, 1)
    return every.reshape(-1)[:n].cpu()


def _fold_pass(
    job,
    mesh,
    axes,
    stream,
    centers,
    collect: bool,
    *,
    pass_id: str = "fold",
    checkpoint=None,
    guard=None,
    bounded: bool = False,
    bounds_blocks=None,
    drift=None,
    index=None,
):
    """One streaming pass of the fold job, driven by the shared executor
    (``text/stream.run_pass``): every chunk is cut to this rank's block on
    arrival, the prefetcher stages the next block onto the rank's device
    while map+combine folds this one into the rank's carry, and ONE
    collective (finalize) closes the pass.

    ``bounded`` expects a job built from ``_assign_stats_bounded_map``: each
    chunk's prior (idx, lo, hi) bounds for this rank's rows come from
    ``bounds_blocks[ci]`` (host numpy, or the sentinel when None: a fresh
    run, or a resume past a stored result), and come back per chunk as
    'shard' outputs. Nothing about pruning crosses the wire beyond the (k,)
    drift in the bcast and the pruned count in the finalize.

    The run_pass carry is (job carry, collected idx blocks, bounds blocks),
    all this rank's own. Returns (out, idx, bounds blocks): ``idx`` (when
    ``collect``) is the whole (n,) assignment as a host tensor on every
    rank, all-gathered at the end of the pass; the resident
    ``kmeans_distributed`` returns its rank's block instead.

    Checkpoints across ranks. The JAX package's single controller writes
    one snapshot of the stacked (P, ...) carry; here each rank runs the
    pass and holds only its partial, so each rank snapshots its own carry
    under a scope named for the rank (``resilience.RankCheckpointer``). A
    kill can land between two ranks' writes, so on entry the ranks agree
    on the chunk with a min and a max all-reduce and resume only if all of
    them hold a snapshot of the same chunk; otherwise all cold-start. A
    restored carry goes back onto the rank's device through
    ``FoldJob.carry_device``. Pass results are replicated: rank 0 alone
    writes them and broadcasts what it reads."""
    from repro_torch.resilience.checkpoint import RankCheckpointer, array_token
    from repro_torch.text.stream import run_pass, to_device

    dev = centers.device
    ck = RankCheckpointer.of(checkpoint)
    meta = {"centers": array_token(centers)} if ck is not None else None
    bcast = _bounds_bcast(centers, drift, index) if bounded else {"centers": centers}

    def fold(state, ch, ci):
        carry, idxs, bblocks = state
        data = {"x": to_device(ch.x, dev), "w": to_device(ch.w, dev)}
        if bounded:
            if bounds_blocks is None:
                b = ops.bounds_identity(data["x"].shape[0], dev)
            else:
                b = ops.Bounds(*(to_device(a, dev) for a in bounds_blocks[ci]))
            data.update(bidx=b.idx, blo=b.lo, bhi=b.hi)
        carry, so = job.step(carry, data, bcast)
        if collect:
            idxs = idxs + [so["idx"].cpu().numpy()]
        if bounded:
            bblocks = bblocks + [tuple(so[f].cpu().numpy() for f in ("bidx", "blo", "bhi"))]
        return carry, idxs, bblocks

    def restore(host):
        carry, idxs, bblocks = host
        return (None if carry is None else job.carry_device(carry)), idxs, bblocks

    carry, idxs, bblocks = run_pass(
        shard_stream(stream, mesh, axes),
        fold,
        (None, [], []),
        copy_to=dev,
        pass_id=pass_id,
        checkpoint=ck,
        guard=guard,
        meta=meta,
        restore_carry=restore,
    )
    out = job.finalize(carry)
    idx = _gather_rows(mesh, axes, idxs, stream.n, dev) if collect else None
    return out, idx, (bblocks if bounded else None)


def _note_prune(profile, bounded, out, n):
    if bounded and profile is not None:
        profile.setdefault("prune_rate", []).append(float(out["pruned"]) / max(n, 1))


# ------------------------------------------------------- streaming K-Means


def kmeans_distributed_stream(
    mesh: DeviceMesh,
    axes: tuple[str, ...],
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
) -> DistClusterResult:
    """Out-of-core PKMeans on the mesh: each iteration is one streaming fold
    job. Chunks are cut to the rank's block on arrival, each rank's partials
    carry across chunks, and the k·d statistics cross the wire ONCE per pass
    instead of once per chunk. Device residency O(chunk·d / P + k·d).

    Every rank passes the same stream and ``init_centers`` (on its device)
    and gets the same result; ``assignment`` is the whole (n,) host tensor
    on every rank (the resident ``kmeans_distributed`` returns the rank's
    block).

    Resilience as ``core.kmeans.kmeans_fit_stream``: each iteration's
    centers persist as the pass result ``kmeans/iter{i}`` (keyed by the
    token of its input centers, bound to the device type), the in-flight
    pass snapshots each rank's carry (see ``_fold_pass`` for the ranks'
    agreement), and a restart replays only the killed pass, bit for bit.
    ``bounded`` (None -> REPRO_ASSIGN_BOUNDS) carries the per-chunk bounds
    blocks between passes (host numpy, the rank's rows); an iteration
    skipped through its stored result restarts the next pass from sentinel
    bounds, which changes no label. ``profile`` (a dict) collects a
    per-pass ``prune_rate``."""
    from repro_torch.resilience.checkpoint import RankCheckpointer, array_token

    check_stream_shardable(stream, mesh, axes)
    bounded = ops.bounds_enabled(bounded)
    map_combine, kinds = _assign_stats_bounded_map() if bounded else _assign_stats_map()
    job = make_fold_job(mesh, axes, map_combine, kinds, name="kmeans_fold")
    ck = RankCheckpointer.of(checkpoint)
    dev = init_centers.device
    result_meta = {"device": dev.type}

    def bkwargs(centers, drift, bblocks):
        if not bounded:
            return {}
        return {"bounded": True, "bounds_blocks": bblocks, "drift": drift,
                "index": ops.center_index_for(centers, centers)}

    centers = init_centers
    bblocks = None
    drift = None
    it = 0
    for it in range(1, max_iters + 1):
        pid = f"kmeans/iter{it - 1}"
        done = ck.load_result(pid, meta=result_meta, device=dev) if ck is not None else None
        if done is not None and done["token"] == array_token(centers):
            centers, moved = done["centers"], done["moved"]
            bblocks, drift = None, None  # no pass ran: restart from sentinel bounds
            if moved <= tol * tol:
                break
            continue
        out, _, nb = _fold_pass(
            job, mesh, axes, stream, centers, False, pass_id=pid, checkpoint=ck,
            guard=guard, **bkwargs(centers, drift, bblocks),
        )
        _note_prune(profile, bounded, out, stream.n)
        new_centers = _new_centers(out["sums"], out["counts"], centers)
        sq_moved = torch.sum((new_centers - centers) ** 2, dim=1)
        moved = float(torch.amax(sq_moved))
        if ck is not None:
            ck.save_result(
                pid,
                {"token": array_token(centers), "centers": new_centers, "moved": moved},
                meta=result_meta,
            )
        if bounded:
            bblocks, drift = nb, torch.sqrt(sq_moved)
        centers = new_centers
        if moved <= tol * tol:
            break
    # final assignment against the converged centers
    out, idx, _ = _fold_pass(
        job, mesh, axes, stream, centers, True, pass_id="kmeans/final", checkpoint=ck,
        guard=guard, **bkwargs(centers, drift, bblocks),
    )
    _note_prune(profile, bounded, out, stream.n)
    if ck is not None:
        for i in range(max_iters):  # the run is over: drop iteration results
            ck.delete_result(f"kmeans/iter{i}")
    return DistClusterResult(
        centers=centers,
        assignment=idx,
        rss=_rss(out["sums"], out["counts"], out["sumsq"]),
        objective=out["obj"],
        iterations=it,
    )


# ------------------------------------------------------- streaming BKC


def bkc_distributed_stream(
    mesh: DeviceMesh,
    axes: tuple[str, ...],
    stream,
    init_centers: torch.Tensor,
    big_k: int,
    k: int,
    *,
    checkpoint=None,
    guard=None,
    bounded: bool | None = None,
) -> DistClusterResult:
    """Out-of-core distributed BKC: jobs 1 and 3 are streaming fold jobs
    (chunks cut to the rank's block on arrival, one collective per pass);
    job 2 runs on the replicated O(BigK·d) micro-cluster statistics as the
    resident path does. Pass 1's statistics persist as the pass result
    ``bkc/mc``, so a restart killed in pass 3 never re-streams pass 1.
    ``bounded`` routes both passes through the bound-pruned op with
    sentinel bounds. ``assignment`` is the whole (n,) host tensor on every
    rank."""
    from repro_torch.resilience.checkpoint import RankCheckpointer, array_token

    check_stream_shardable(stream, mesh, axes)
    bounded = ops.bounds_enabled(bounded)
    ck = RankCheckpointer.of(checkpoint)
    dev = init_centers.device

    # ---- job 1: micro-cluster statistics folded over the chunk stream (one
    # fused kernel per rank per chunk, CF additivity as the chunk monoid)
    def mc_map(data, bcast):
        if bounded:
            index = ops.CenterIndex(bcast["perm"], bcast["group_of"]) if "perm" in bcast else None
            st = ops.assign_stats_bounded(
                data["x"], bcast["centers"], ops.Bounds(data["bidx"], data["blo"], data["bhi"]),
                bcast["drift"], data["w"], index=index,
            )
        else:
            st = ops.assign_stats(data["x"], bcast["centers"], data["w"])
        out = {"n": st.counts, "cf1": st.sums, "cf2": st.sumsq, "min_sim": st.min_sim}
        if bounded:  # the fold protocol wants the bounded route's shard kinds
            out.update(bidx=st.bounds.idx, blo=st.bounds.lo, bhi=st.bounds.hi, idx=st.idx)
        return out

    mc_kinds = {"n": "sum", "cf1": "sum", "cf2": "sum", "min_sim": "min"}
    if bounded:
        mc_kinds.update(bidx="shard", blo="shard", bhi="shard", idx="shard")
    job1 = make_fold_job(mesh, axes, mc_map, mc_kinds, name="bkc_mc_fold")

    def bkwargs(centers):
        if not bounded:
            return {}
        return {"bounded": True, "bounds_blocks": None, "drift": None,
                "index": ops.center_index_for(centers, centers)}

    stats = None
    if ck is not None:
        mc_meta = {"centers": array_token(init_centers), "device": dev.type}
        stats = ck.load_result("bkc/mc", meta=mc_meta, device=dev)
    if stats is None:
        stats, _, _ = _fold_pass(
            job1, mesh, axes, stream, init_centers, False, pass_id="bkc/mc", checkpoint=ck,
            guard=guard, **bkwargs(init_centers),
        )
        stats = {f: v for f, v in stats.items() if v is not None}  # drop 'shard' slots
        if ck is not None:
            ck.save_result("bkc/mc", stats, meta=mc_meta)
    valid = stats["n"] > 0
    mc = MicroClusters(
        n=stats["n"],
        cf1=stats["cf1"],
        cf2=stats["cf2"],
        centers=init_centers,
        min_sim=torch.where(valid, stats["min_sim"], 1.0),
        valid=valid,
    )
    centers, _, _ = _group_centers(mc, k)

    # ---- job 3: final assignment pass (streamed)
    map_combine, kinds = _assign_stats_bounded_map() if bounded else _assign_stats_map()
    job3 = make_fold_job(mesh, axes, map_combine, kinds, name="bkc_final_fold")
    out, idx, _ = _fold_pass(
        job3, mesh, axes, stream, centers, True, pass_id="bkc/final", checkpoint=ck,
        guard=guard, **bkwargs(centers),
    )
    if ck is not None:
        ck.delete_result("bkc/mc")  # the run is over
    return DistClusterResult(
        centers=centers,
        assignment=idx,
        rss=_rss(out["sums"], out["counts"], out["sumsq"]),
        objective=out["obj"],
        iterations=2,  # two full passes over the data
    )


# ------------------------------------------------------- streaming Buckshot


def reservoir_finalize_bytes(
    s: int, d: int, n_shards: int, *, owner_scatter: bool = True
) -> int:
    """Analytic wire bytes of the reservoir's finalize collective.

    owner_scatter (the shipped path): the (P·s,) f32 score vector is
    gathered whole (every rank must rank identically), then the s winning
    payload rows, a (d,) f32 row and an i32 gidx each, move once from their
    owners. The whole-payload gather it replaced moved all P per-shard
    top-s candidate sets, rows included: O(P·s + s·d) against O(P·s·d)."""
    score_bytes = n_shards * s * 4
    if owner_scatter:
        return score_bytes + s * (d * 4 + 4)
    return score_bytes + n_shards * s * (d * 4 + 4)


def reservoir_sample_distributed_stream(
    mesh: DeviceMesh,
    axes: tuple[str, ...],
    stream,
    s: int,
    seed: int | None = None,
    *,
    uniforms=None,
    checkpoint=None,
    guard=None,
) -> tuple[torch.Tensor, np.ndarray]:
    """Sharded ONE-pass uniform s-sample of a chunk stream, without
    replacement: each rank's running top-s reservoir on the engine's
    fold-mode 'topk' kind.

    Per chunk, each rank scores its rows with iid uniforms (chunk-padding
    rows score -1 and lose to every real uniform) and emits its local top-s
    (score, global index, row) candidates (``core.sampling.local_top_s``);
    the carry keeps the rank's running top s, and the owner-scatter finalize
    picks the global top s once at the end of the pass (``FoldJob``). The
    global top s of iid uniforms is an exact uniform s-subset. O(s·d) carry
    per rank; the finalize moves O(P·s + s·d) bytes
    (``reservoir_finalize_bytes``).

    Chunk ``ci`` on shard p draws ``sampling.shard_uniforms(seed, ci, p,
    chunk/P)``, a CPU generator of its own, so the draw depends on neither
    the thread nor the prefetch (the JAX package keys it
    ``fold_in(fold_in(key, ci), p)``). ``uniforms(ci, p)`` -> (chunk/P,)
    replaces those draws: the seam through which tests feed the JAX
    package's own. With a ``checkpoint`` the sample is stored as the pass
    result ``reservoir``, bound to ``seed`` and ``s``, or with ``uniforms``
    to the token of ``uniforms(0, 0)`` and ``s``.

    Returns (rows (s, d) on the rank's device, replicated; global indices
    (s,) np.int32), by descending score: a uniformly shuffled order."""
    from repro_torch.core.sampling import local_top_s, shard_uniforms
    from repro_torch.resilience.checkpoint import RankCheckpointer, array_token
    from repro_torch.text.stream import run_pass, to_device

    if s > stream.n:
        raise ValueError(f"sample size {s} exceeds stream rows {stream.n}")
    check_stream_shardable(stream, mesh, axes)
    chunk_local = stream.chunk // mesh_axis_size(mesh, axes)
    me = shard_index(mesh, axes)
    dev = mesh_device(mesh)
    if uniforms is None:
        if seed is None:
            raise ValueError("reservoir_sample_distributed_stream needs a seed or uniforms")
        draws = {"seed": int(seed)}

        def uniforms(ci, shard):
            return shard_uniforms(seed, ci, shard, chunk_local)
    else:
        draws = None

    ck = RankCheckpointer.of(checkpoint)
    meta = None
    if ck is not None:
        meta = {**(draws or {"uniforms": array_token(np.asarray(uniforms(0, 0)))}), "s": s}
        done = ck.load_result("reservoir", meta=meta, device=dev)
        if done is not None:
            return done["rows"], done["gidx"]

    def sample_map(data, bcast):
        scores = torch.where(data["w"] > 0, bcast["u"], -1.0)
        gidx = bcast["start"] + me * chunk_local + torch.arange(
            chunk_local, dtype=torch.int32, device=dev)
        rows = data["x"]
        if chunk_local < s:
            # pad the candidates to s; fillers score below even the chunk-pad
            # sentinel, so they never survive a merge
            pad = s - chunk_local
            scores = torch.cat([scores, torch.full((pad,), -2.0, device=dev)])
            gidx = torch.cat([gidx, torch.full((pad,), -1, dtype=torch.int32, device=dev)])
            rows = torch.cat([rows, rows.new_zeros((pad, rows.shape[1]))])
        top, pos = local_top_s(scores, s)
        pos = pos.long()
        return {"sample": {"score": top, "gidx": gidx[pos], "rows": rows[pos]}}

    job = make_fold_job(mesh, axes, sample_map, {"sample": "topk"}, name="sample_reservoir")

    def fold(carry, ch, ci):
        data = {"x": to_device(ch.x, dev), "w": to_device(ch.w, dev)}
        u = torch.as_tensor(np.asarray(uniforms(ci, me)), dtype=torch.float32).to(dev)
        carry, _ = job.step(carry, data, {"u": u, "start": int(ch.start)})
        return carry

    carry = run_pass(
        shard_stream(stream, mesh, axes),
        fold,
        None,
        copy_to=dev,
        pass_id="reservoir",
        checkpoint=ck,
        guard=guard,
        meta=meta,
        restore_carry=job.carry_device,
    )
    out = job.finalize(carry)["sample"]
    gidx = out["gidx"].cpu().numpy()
    if ck is not None:
        ck.save_result("reservoir", {"rows": out["rows"], "gidx": gidx}, meta=meta)
    return out["rows"], gidx


def buckshot_distributed_stream(
    mesh: DeviceMesh,
    axes: tuple[str, ...],
    stream,
    k: int,
    seed: int | None = None,
    *,
    sample_size: int,
    kmeans_iters: int = 3,
    hac: str = "replicated",
    sweep: str = "auto",
    overlap: bool = True,
    sample_rows: torch.Tensor | None = None,
    uniforms=None,
    checkpoint=None,
    guard=None,
    bounded: bool | None = None,
) -> DistClusterResult:
    """Out-of-core distributed Buckshot. Phase 1's s = √(kn) sample comes
    from the sharded one-pass streaming reservoir (drawn from ``seed``, or
    the draws ``uniforms`` gives), the sample HAC runs matrix-free
    (``_phase1_init_centers``), and phase 2 rides the streaming distributed
    K-Means fold. Peak device residency O(chunk·d/P + s·d + k·d) at any n.

    Handed the same ``sample_rows``, the labels equal the resident
    ``buckshot_distributed``'s. ``checkpoint`` covers the reservoir pass
    (its sample stored as a result) and phase 2's passes, under the
    ``buckshot/`` namespace; the sample's result is deleted when the run
    ends."""
    from repro_torch.resilience.checkpoint import RankCheckpointer

    check_stream_shardable(stream, mesh, axes)
    ck = RankCheckpointer.of(checkpoint)
    if sample_rows is None:
        sample_rows, _ = reservoir_sample_distributed_stream(
            mesh, axes, stream, sample_size, seed, uniforms=uniforms, checkpoint=ck,
            guard=guard,
        )
    init_centers = _phase1_init_centers(
        mesh, axes, sample_rows, k, hac=hac, sweep=sweep, overlap=overlap,
    )
    result = kmeans_distributed_stream(
        mesh, axes, stream, init_centers, k, max_iters=kmeans_iters, tol=0.0,
        checkpoint=ck.scoped("buckshot") if ck is not None else None, guard=guard,
        bounded=bounded,
    )
    if ck is not None:
        ck.delete_result("reservoir")  # the run is over
    return result
