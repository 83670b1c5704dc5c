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

Counterpart of the resident half of the JAX package's
``distrib/cluster.py``; the ``*_distributed_stream`` drivers wait for the
streaming slice. ``assignment`` in a result is this rank's block.
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
from repro_torch.distrib.engine import make_job
from repro_torch.distrib.sharding import shard_index
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
            "sq": torch.sum(st.sumsq),
            "obj": torch.sum(w * (1.0 - st.best_sim)),
            "idx": st.idx,
            "sim": st.best_sim,
        }

    kinds = {"sums": "sum", "counts": "sum", "sq": "sum", "obj": "sum",
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
            "sq": torch.sum(st.sumsq),
            "obj": torch.sum(w * (1.0 - st.best_sim)),
            "pruned": torch.sum(torch.where(st.pruned & (w > 0), 1.0, 0.0)),
            "idx": st.idx,
            "sim": st.best_sim,
            "bidx": st.bounds.idx,
            "blo": st.bounds.lo,
            "bhi": st.bounds.hi,
        }

    kinds = {"sums": "sum", "counts": "sum", "sq": "sum", "obj": "sum", "pruned": "sum",
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


def _rss(sums, counts, sq):
    means = sums / torch.clamp(counts, min=1.0)[:, None]
    return sq - torch.sum(counts * torch.sum(means * means, dim=1))


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
        rss=_rss(out["sums"], out["counts"], out["sq"]),
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
        rss=_rss(out["sums"], out["counts"], out["sq"]),
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


def _top(scores: torch.Tensor, s: int) -> torch.Tensor:
    """Positions of the s highest scores, ties in position order (a stable
    sort: ``torch.topk`` promises no order among ties)."""
    return torch.sort(scores, descending=True, stable=True).indices[:s]


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
