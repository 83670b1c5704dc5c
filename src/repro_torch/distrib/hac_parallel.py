"""Parallel single-link HAC via Borůvka MST over the engine (paper §4.2.1).

For single-link the dendrogram IS the maximum spanning tree, and the
paper's "local clustering + alignment" is one Borůvka round: every
component finds its best outgoing edge locally and the merge aligns them
globally, in O(log s) rounds. The single-device machinery (merge rounds,
edge cut, matrix-free candidate search) lives in ``core/hac.py``; this
module lifts the per-round edge search onto the mesh.

Each rank owns a ROW BLOCK of the (s, s) similarity matrix, which never
exists anywhere: ``ops.sim_best_edge`` folds the similarity tiles straight
into a per-row (max, argmax). Under the default SHARDED sweep the columns
are sharded too: each rank keeps its (s/P, d) slice and block copies rotate
through the ranks (``engine.ring_sweep``), so no (s, d) copy lands anywhere
but the caller's input. ``sweep='bcast'`` reads the columns from the full
replicated sample. Per round:

  map     : per-row best cross-component edge on the local rows; sharded
            sweep: a fold of the visiting blocks keeping the (w desc,
            global col asc) winner — the replicated argmax's tie order
  combine : per-shard per-COMPONENT pre-reduce (``ops.component_best_edge``):
            only O(#components) candidates leave the shard
  reduce  : the engine's 'component' fold, tiered on a pod mesh
  merge   : merge='comp' (default) aligns on the COMPONENT graph
            (``core.hac._merge_round_comp``), point state touched only by a
            shard-local relabel gather; merge='point' is the replicated
            (s,)-slot alignment (``core.hac._merge_round_pre``)

Component ids are densified each round and capped by the halving bound
ceil(s / 2^round). The fully-merged flag is computed on the device every
round, but the host reads it only every ``CHECK_EVERY`` rounds, as in the
JAX package, so the round count (and with it every launch count) is the
reference's.

The sample is PADDED to a shard multiple: pad rows carry label -1, which
the edge search masks out, and a component id the combiner drops.

Under merge='comp' the round loop checkpoints (``checkpoint=``): at a host
read of the flag after which the loop goes on, it snapshots the comp state
(the sharded sweep's slices gathered from every rank), ``comp_to_root``,
the live count and the compact edge lists, all replicated, so rank 0 alone
writes the snapshot (``resilience.RankCheckpointer`` with ``shared=True``).

Counterpart of the JAX package's ``distrib/hac_parallel.py``. Left out:
the AOT pre-warm (``prewarm``, ``impl``: PyTorch runs eagerly) and the
benchmark paths ``pre_reduce=False`` (row gather) and
``synthetic_merge_rounds``.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.common import l2_normalize
from repro_torch.core.hac import (
    MSTEdges,
    _expand_round_edges,
    _merge_round_comp,
    _merge_round_pre,
    _round_prep,
    _rounds_for,
    _scatter_slots,
    cut_mst_edges,
)
from repro_torch.distrib.engine import _gather, make_job, ring_sweep
from repro_torch.distrib.sharding import (
    axis_groups,
    mesh_axis_size,
    ring_block_rows,
    shard_rows,
    tier_sizes,
)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import BIG_I, NEG


# rounds between the host's reads of the device-side "fully merged" flag
CHECK_EVERY = 3


def round_cap(s: int, r: int) -> int:
    """Borůvka halving bound: #components entering round r is <= ceil(s/2^r)."""
    return max(1, math.ceil(s / (1 << r)))


def _combine(bw, bj, rowid, seg, cap, s):
    """The per-shard pre-reduce of the replicated sweeps. In round 0 every
    point is its own component, so the segmented reduce is the identity:
    each row's candidate goes straight to its slot (ids outside [0, cap),
    the pad rows, are dropped)."""
    if cap == s:
        return (_scatter_slots(cap, seg, bw, NEG), _scatter_slots(cap, seg, rowid, BIG_I),
                _scatter_slots(cap, seg, bj, -1))
    return ops.component_best_edge(bw, bj, rowid, seg, cap)


def _cand_map_pre(data, bcast):
    """merge='point': point labels mask the search; pad rows carry
    comp == cap."""
    bj, bw = ops.sim_best_edge(
        data["rows"], bcast["xs"], data["labels"], bcast["all_labels"]
    )
    cap = bcast["comp_to_root"].shape[0]
    w, row, col = _combine(bw, bj, data["rowid"], data["comp"], cap, bcast["xs"].shape[0])
    return {"best": {"w": w, "row": row, "col": col}}


def _cand_map_comp(data, bcast):
    """Replicated sweep, dense comp ids as the masking labels (they induce
    the same partition as min-id point labels). Pad rows carry comp == -1,
    redirected to the dropped segment cap for the combiner."""
    comp = data["comp"]
    bj, bw = ops.sim_best_edge(data["rows"], bcast["xs"], comp, bcast["comp_all"])
    cap = bcast["comp_to_root"].shape[0]
    seg = torch.where(comp < 0, cap, comp)
    w, row, col = _combine(bw, bj, data["rowid"], seg, cap, bcast["xs"].shape[0])
    return {"best": {"w": w, "row": row, "col": col}}


def sharded_row_winners(
    data: dict, cap: int, visit: Callable[[dict, Callable, dict], dict]
) -> dict:
    """One shard's per-row winners under the sharded sweep: the inputs of
    its combiner (``sharded_candidates``).

    ``data`` is the shard's block: {'rows' (B, d) unit rows, 'rowid' (B,)
    global ids, 'comp' (B,) dense comp ids, -1 on pad rows}.
    ``visit(block, fold, acc)`` folds every row block of the sample into
    ``acc``, this one included; in the job it is ``engine.ring_sweep``, and
    a caller without a process group may pass the blocks itself. The fold
    keeps the per-row (w desc, global col asc) winner, the order the
    replicated argmax resolves ties by, so the result does not depend on the
    visit order. The winner's TARGET component rides along as payload
    ('tcomp'), since no replicated comp array exists to look it up in.

    Returns {'w', 'col' (global, -1 where none), 'tcomp', 'rowid', 'seg'
    (comp with pad rows sent to the dropped segment ``cap``)}.
    """
    rows, rowid, comp = data["rows"], data["rowid"], data["comp"]
    b = comp.shape[0]
    dev = comp.device
    acc0 = {
        "w": torch.full((b,), NEG, dtype=torch.float32, device=dev),
        "col": torch.full((b,), BIG_I, dtype=torch.int32, device=dev),
        "tcomp": torch.full((b,), -1, dtype=torch.int32, device=dev),
    }

    def fold(acc, vis):
        # the visiting block's pad rows carry comp -1: masked as columns
        bj, bw = ops.sim_best_edge(rows, vis["rows"], comp, vis["comp"])
        found = bj >= 0
        safe = torch.clamp(bj, min=0).long()
        gcol = torch.where(found, vis["rowid"][safe], BIG_I)  # local -> global
        tc = torch.where(found, vis["comp"][safe], -1)
        take = (bw > acc["w"]) | ((bw == acc["w"]) & (gcol < acc["col"]))
        return {
            "w": torch.where(take, bw, acc["w"]),
            "col": torch.where(take, gcol, acc["col"]),
            "tcomp": torch.where(take, tc, acc["tcomp"]),
        }

    acc = visit({"rows": rows, "rowid": rowid, "comp": comp}, fold, acc0)
    return {"w": acc["w"], "col": torch.where(acc["col"] == BIG_I, -1, acc["col"]),
            "tcomp": acc["tcomp"], "rowid": rowid, "seg": torch.where(comp < 0, cap, comp)}


def sharded_candidates(
    data: dict, cap: int, visit: Callable[[dict, Callable, dict], dict]
) -> dict:
    """One shard's per-component winners under the sharded sweep: its
    per-row winners (``sharded_row_winners``) pre-reduced by
    ``ops.component_best_edge``."""
    rw = sharded_row_winners(data, cap, visit)
    w, row, col = ops.component_best_edge(rw["w"], rw["col"], rw["rowid"], rw["seg"], cap)
    # the same (w, rowid, seg) keys pick the same winner: the second call
    # only swaps the payload (target comp instead of col)
    _, _, tcomp = ops.component_best_edge(rw["w"], rw["tcomp"], rw["rowid"], rw["seg"], cap)
    return {"w": w, "row": row, "col": col, "tcomp": tcomp}


def _cand_job(mesh: DeviceMesh, axes: tuple[str, ...], mode: str, overlap: bool):
    """The per-round candidate job. Modes: 'comp_sharded' (ring-sharded
    sweep), 'comp' (replicated sweep, dense component ids), 'pre' (point
    labels + per-component pre-reduce)."""
    if mode == "comp_sharded":
        groups = axis_groups(mesh, axes)

        def visit(block, fold, acc):
            return ring_sweep(groups, block, fold, acc, overlap=overlap)

        def cand_map(data, bcast):
            cap = bcast["comp_to_root"].shape[0]
            return {"best": sharded_candidates(data, cap, visit)}

        return make_job(mesh, axes, cand_map, {"best": "component"}, name="boruvka_cand_ring")
    if mode == "comp":
        return make_job(mesh, axes, _cand_map_comp, {"best": "component"},
                        name="boruvka_cand_compid")
    if mode == "pre":
        return make_job(mesh, axes, _cand_map_pre, {"best": "component"},
                        name="boruvka_cand_comp")
    raise ValueError(f"unknown candidate-job mode {mode!r}")


def _relabel_map(data, bcast):
    comp = data["comp"]
    new = bcast["relabel"][torch.clamp(comp, min=0).long()]
    return {"comp": torch.where(comp < 0, -1, new)}


def _relabel_job(mesh: DeviceMesh, axes: tuple[str, ...]):
    """Shard-local component relabel after a comp-mode merge: each rank
    gathers its O(s/P) comp slice through the (cap,) ``relabel`` map, the
    only thing that crosses the wire."""
    return make_job(mesh, axes, _relabel_map, {"comp": "shard"}, name="comp_relabel")


# ------------------------------------------------------- analytic accounting


def shuffle_bytes_per_round(s: int, n_shards: int, rounds: int) -> list[int]:
    """Per-round shuffle footprint of the pre-reduced candidate exchange:
    one (w f32, row i32, col i32) triple per component per shard, capped by
    the halving bound: O(c·P) bytes, shrinking geometrically."""
    return [n_shards * round_cap(s, r) * 12 for r in range(rounds)]


def shuffle_bytes_per_tier(
    s: int, tiers: tuple[int, ...], rounds: int, *, merge: str = "comp"
) -> dict[str, list[int]]:
    """Per-round shuffle footprint of the tiered candidate exchange, split
    intra-pod / cross-pod (``tiers`` outermost first, as ``tier_sizes``).

      intra: n_pods · pod_size · cap · 12 bytes over the fast links.
      cross: n_pods · cap · 12 bytes (only per-pod winners cross pods).

    A flat mesh has no intra tier and all P shards on the cross tier.
    merge='comp' adds the (cap,) relabel map back (cross, 4 B per entry).
    """
    if len(tiers) == 1:
        intra_shards, cross_shards = 0, tiers[0]
    else:
        intra_shards = int(math.prod(tiers))
        cross_shards = int(math.prod(tiers[:-1]))
    intra, cross = [], []
    for r in range(rounds):
        cap = round_cap(s, r)
        intra.append(intra_shards * cap * 12)
        relabel = cap * 4 if merge == "comp" else 0
        cross.append(cross_shards * cap * 12 + relabel)
    return {"intra": intra, "cross": cross}


def bcast_bytes_per_round(
    s: int, d: int, n_shards: int, rounds: int, *,
    sweep: str = "sharded", merge: str = "comp",
) -> list[int]:
    """Per-round bytes REPLICATED onto the shards by the candidate sweep.

    sweep='bcast': the full (s, d) f32 xs, the (s,) i32 comp labels and the
    (cap,) i32 comp_to_root on every shard, n_shards·(s·d·4 + s·4 + cap·4).
    sweep='sharded': only the (cap,) comp_to_root in and, under
    merge='comp', the (cap,) relabel map back, n_shards·(1 or 2)·cap·4.
    """
    if sweep not in ("sharded", "bcast"):
        raise ValueError(f"sweep must be 'sharded' or 'bcast', got {sweep!r}")
    out = []
    for r in range(rounds):
        cap = round_cap(s, r)
        if sweep == "bcast":
            out.append(n_shards * (s * d * 4 + s * 4 + cap * 4))
        else:
            relabel = cap * 4 if merge == "comp" else 0
            out.append(n_shards * (cap * 4 + relabel))
    return out


def sweep_peak_bytes_per_device(
    s: int, d: int, n_shards: int, *, sweep: str = "sharded", overlap: bool = True,
) -> int:
    """Peak per-device residency of one round's (·, d) f32 point data:
    'bcast' the own slice plus the full sample, B·d·4 + s·d·4; 'sharded'
    the own slice, the visiting block, and (overlap) the prefetched next
    block plus the outer ring's panel, k·B·d·4 with k = 4 (3 without
    overlap), B = ring_block_rows(s, n_shards)."""
    if sweep not in ("sharded", "bcast"):
        raise ValueError(f"sweep must be 'sharded' or 'bcast', got {sweep!r}")
    b = ring_block_rows(s, n_shards)
    if sweep == "bcast":
        return b * d * 4 + s * d * 4
    return (4 if overlap else 3) * b * d * 4


# ---------------------------------------------------------------- driver


def boruvka_mst_distributed(
    mesh: DeviceMesh,
    axes: tuple[str, ...],
    xs: torch.Tensor,
    *,
    merge: str = "comp",
    sweep: str = "auto",
    overlap: bool = True,
    compact: bool = True,
    checkpoint=None,
    pass_id: str = "boruvka_mst",
) -> MSTEdges:
    """Borůvka MST with the per-row edge search sharded over the mesh.

    Every rank passes the same (s, d) sample ``xs`` and gets the same edges.
    Rounds are host-chained like the paper's job driver, with a device-side
    early exit read by the host every ``CHECK_EVERY`` rounds.

    sweep: 'sharded' (what 'auto' gives under merge='comp') — each rank
    keeps its (s/P, d) slice and block copies rotate through the ranks;
    'bcast' — every rank's rows search the full sample. Edges are
    bit-identical either way. ``overlap`` (sharded sweep) issues the next
    ring hop before folding the current block; the fold is
    order-independent, so overlap on or off gives the same bits.

    merge: 'comp' (default) merges on the component graph; with
    ``compact=True`` the edges hold one slot per component per round (~2s
    over a run), and ``compact=False`` re-expands each round into the
    (s,)-slot layout, bit-identical to merge='point' and to the resident
    ``boruvka_mst`` for the rounds run. 'point': the replicated point-level
    alignment.

    checkpoint (merge='comp' only): a ``resilience.Checkpointer``; the round
    loop snapshots its carry at every ``CHECK_EVERY`` host read after which
    it continues, so a resume replays the uninterrupted run's rounds and
    gives its edges bit for bit. Rank 0 writes the (replicated) snapshot;
    it is deleted when the loop completes. ``pass_id`` names it in the
    store.
    """
    if merge not in ("comp", "point"):
        raise ValueError(f"merge must be 'comp' or 'point', got {merge!r}")
    if sweep not in ("auto", "sharded", "bcast"):
        raise ValueError(f"sweep must be 'auto', 'sharded' or 'bcast', got {sweep!r}")
    mode = "comp" if merge == "comp" else "pre"
    if sweep == "sharded" and mode != "comp":
        raise ValueError(
            "sweep='sharded' requires merge='comp' (the ring sweep carries "
            "component ids, not point labels)"
        )
    if mode == "comp" and sweep != "bcast":
        mode = "comp_sharded"
    if checkpoint is not None and mode not in ("comp", "comp_sharded"):
        raise ValueError(
            "checkpointed Borůvka requires merge='comp' (the comp-graph "
            "carry is the snapshot unit)"
        )
    s, d = xs.shape
    xs = l2_normalize(xs)
    pad = (-s) % mesh_axis_size(mesh, axes)
    xs_p = torch.cat([xs, xs.new_zeros((pad, d))]) if pad else xs
    rowid_p = torch.arange(s + pad, dtype=torch.int32, device=xs.device)
    job = _cand_job(mesh, axes, mode, overlap)
    from repro_torch.resilience.checkpoint import RankCheckpointer

    ck = RankCheckpointer.of(checkpoint, shared=True)
    edges, _ = _boruvka_rounds(
        job, mesh, axes, xs, xs_p, rowid_p, s, pad, _rounds_for(s), mode,
        compact, ck, pass_id,
    )
    if ck is not None:
        ck.delete(pass_id)  # the loop completed
    return edges


def _boruvka_rounds(
    job, mesh, axes, xs, xs_p, rowid_p, s, pad, rounds, mode, compact,
    checkpoint=None, pass_id="boruvka_mst",
) -> tuple[MSTEdges, int]:
    """The host-chained round loop of ``boruvka_mst_distributed``.

    Returns (edges, rounds_run): compact edges do not give the round count
    by their length.
    """
    dev = xs.device

    def sharded(t):
        return shard_rows(mesh, axes, t)

    def padded(t, fill):
        return torch.cat([t, torch.full((pad,), fill, dtype=t.dtype, device=dev)]) if pad else t

    rows_l, rowid_l = sharded(xs_p), sharded(rowid_p)
    labels = torch.arange(s, dtype=torch.int32, device=dev)
    # comp-mode state: dense component ids replace point labels. Under the
    # sharded sweep only this rank's slice of them exists (comp_l), updated
    # through the (cap,) relabel map; the reduce carries the winner's target
    # comp, so nothing gathers it.
    comp_all = torch.arange(s, dtype=torch.int32, device=dev)
    comp_to_root = torch.arange(s, dtype=torch.int32, device=dev)
    n_real = torch.tensor(s, dtype=torch.int32, device=dev)
    relabel_job = _relabel_job(mesh, axes) if mode == "comp_sharded" else None
    comp_l = sharded(padded(comp_all, -1)) if mode == "comp_sharded" else None
    eus, evs, ews, evalids = [], [], [], []
    rounds_run = 0
    start_r = 0
    ck_fp = None
    if checkpoint is not None:
        from repro_torch.resilience.checkpoint import carry_from_host, carry_to_host

        # structural fingerprint (the reference's): the round schedule and
        # every carry shape follow from these, and the shapes shrink per
        # round, so a static string rather than carry_fingerprint
        ck_fp = (
            f"boruvka:{mode}:tiers{tier_sizes(mesh, axes)}:s{s}:d{xs.shape[1]}:pad{pad}"
            f":compact{int(compact)}:ck{CHECK_EVERY}"
        )
        snap = checkpoint.load(pass_id, fingerprint=ck_fp)
        if snap is not None:
            carry = carry_from_host(snap["carry"], device=dev)
            start_r = int(snap["chunk"]) + 1
            rounds_run = start_r
            comp_to_root, n_real = carry["comp_to_root"], carry["n_real"]
            eus, evs = list(carry["eu"]), list(carry["ev"])
            ews, evalids = list(carry["ew"]), list(carry["evalid"])
            if mode == "comp_sharded":
                comp_l = sharded(carry["comp"])
            else:
                comp_all = carry["comp"]
    for r in range(start_r, rounds):
        rounds_run = r + 1
        cap = round_cap(s, r)
        if mode in ("comp", "comp_sharded"):
            if mode == "comp":
                data = {"rows": rows_l, "rowid": rowid_l,
                        "comp": sharded(padded(comp_all, -1))}
                bcast = {"xs": xs, "comp_all": comp_all, "comp_to_root": comp_to_root}
            else:
                data = {"rows": rows_l, "rowid": rowid_l, "comp": comp_l}
                bcast = {"comp_to_root": comp_to_root}
            best = job(data, bcast)["best"]
            # the ring sweep carries the target comp through the reduce; the
            # replicated sweep gathers it (the merge never reads it where
            # col < 0)
            tcomp = (
                best["tcomp"] if mode == "comp_sharded"
                else comp_all[torch.clamp(best["col"], min=0).long()]
            )
            relabel, new_root, eu, ev, ew, evalid, n_real = _merge_round_comp(
                best["w"], best["row"], best["col"], tcomp, comp_to_root, n_real,
                next_cap=round_cap(s, r + 1),
            )
            if not compact:
                eu, ev, ew, evalid = _expand_round_edges(
                    s if mode == "comp_sharded" else comp_all, eu, ev, ew, evalid,
                    comp_to_root,
                )
            if mode == "comp":
                comp_all = relabel[comp_all.long()]
            else:
                comp_l = relabel_job({"comp": comp_l}, {"relabel": relabel})["comp"]
            comp_to_root = new_root
            done = n_real == 1
        else:  # 'pre'
            comp, comp_to_root_r = _round_prep(labels, cap)
            data = {"rows": rows_l, "labels": sharded(padded(labels, -1)),
                    "rowid": rowid_l, "comp": sharded(padded(comp, cap))}
            bcast = {"xs": xs, "all_labels": labels, "comp_to_root": comp_to_root_r}
            best = job(data, bcast)["best"]
            labels, eu, ev, ew, evalid = _merge_round_pre(
                labels, best["w"], best["row"], best["col"], comp_to_root_r
            )
            done = torch.all(labels == 0)  # single component: forest complete
        eus.append(eu)
        evs.append(ev)
        ews.append(ew)
        evalids.append(evalid)
        # the done flag is computed on the device every round; the host reads
        # it every CHECK_EVERY rounds: a late exit costs at most
        # CHECK_EVERY - 1 no-op rounds, and the round count is deterministic
        if (r + 1) % CHECK_EVERY == 0 or r == rounds - 1:
            if bool(done):
                break
            if checkpoint is not None:
                # only when the loop goes on: a snapshot always names a round
                # the uninterrupted run executes, so a resume replays it
                comp = (
                    _gather(comp_l, axis_groups(mesh, axes)) if mode == "comp_sharded"
                    else comp_all
                )
                carry = {"comp": comp, "comp_to_root": comp_to_root, "n_real": n_real,
                         "eu": eus, "ev": evs, "ew": ews, "evalid": evalids}
                checkpoint.save(pass_id, chunk=r, carry_host=carry_to_host(carry),
                                fingerprint=ck_fp)
    edges = MSTEdges(
        u=torch.cat(eus), v=torch.cat(evs), w=torch.cat(ews), valid=torch.cat(evalids)
    )
    return edges, rounds_run


def single_link_labels_distributed(
    mesh: DeviceMesh, axes: tuple[str, ...], xs: torch.Tensor, k: int, *,
    sweep: str = "auto", overlap: bool = True,
) -> torch.Tensor:
    """(s,) single-link labels at k clusters of the sample ``xs``."""
    edges = boruvka_mst_distributed(mesh, axes, xs, sweep=sweep, overlap=overlap)
    return cut_mst_edges(edges, xs.shape[0], k)
