"""MapReduce on ``torch.distributed``: the paper's execution model as an
SPMD job.

A job is ``map_combine`` (runs on each rank's row block: the paper's map
task + combiner) plus a per-output reduction kind (the shuffle+reduce):

  'sum' / 'min' / 'max'  -> all_reduce over the data axes (replicated result)
  'gather'               -> all_gather, concatenated in row-block order
  'shard'                -> stays on its rank like the input rows
  'component'            -> segmented lexicographic best-edge merge: the leaf
                            is a {'w', 'row', 'col', ...} dict of per-shard
                            per-component winners; max/min passes pick the
                            global (w desc, row asc) winner per segment —
                            O(#components) wire traffic, never O(rows). On a
                            (pod, data) mesh the passes run per tier,
                            innermost first (``_component_reduce``).

Every leaf travels in its own dtype, bf16 included, over NCCL and gloo
alike: the only bf16 sum is ``sample_rows_distributed``'s one-owner row
sum, a row plus zeros, which is exact in bf16 (a -0.0 entry comes back
+0.0, as from the JAX package's psum). torch 2.11's and 2.13's gloo both
carry bf16 (``python -m repro_torch.distrib.selftest --bf16``).

Reduce kinds may sit at any PREFIX of the output tree of dicts: one kind
covers the whole subtree below it ('component' sees its w/row/col triple
together). Every reduce runs per mesh axis over ``mesh.get_group(axis)``,
innermost axis first, whatever the world size (a group of one rank too).
Fold mode (``FoldJob`` below) consumes a stream of chunks with one
collective pass at the end, and adds the 'topk' running-reservoir kind,
which has a chunk monoid but no one-shot reduce; make_job rejects it.

Counterpart of the JAX package's ``distrib/engine.py`` (``make_job``,
``run_job``, ``ring_sweep``, ``FoldJob``/``make_fold_job``).
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.distrib.sharding import (
    axis_groups,
    mesh_device,
    ring_permutation,
    shard_index,
)
from repro_torch.kernels.ref import BIG_I

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


def _map_tree(fn: Callable[[torch.Tensor], torch.Tensor], tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree: Any) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _unflatten(tree: Any, leaves: list[torch.Tensor]) -> Any:
    it = iter(leaves)
    return _map_tree(lambda _: next(it), tree)


def _all_reduce(t: torch.Tensor, op: str, group: dist.ProcessGroup) -> torch.Tensor:
    """Out-of-place all_reduce (``dist.all_reduce`` writes into its input,
    which callers still read). Bools travel as int32."""
    out = t.to(torch.int32) if t.dtype == torch.bool else t.clone()
    dist.all_reduce(out, op=_OPS[op], group=group)
    return out.bool() if t.dtype == torch.bool else out


def _reduce(kind: str) -> Callable[[Any, Sequence[dist.ProcessGroup]], Any]:
    def reduce(v, groups):
        def leaf(t):
            for g in reversed(groups):  # innermost axis first
                t = _all_reduce(t, kind, g)
            return t

        return _map_tree(leaf, v)

    return reduce


def _gather(v: Any, groups: Sequence[dist.ProcessGroup]) -> Any:
    """Concatenate every shard's leaf along dim 0 in row-block order: the
    inner axis first, then the outer, gives the row-major shard order."""

    def leaf(t):
        for g in reversed(groups):
            parts = [torch.empty_like(t) for _ in range(dist.get_world_size(g))]
            dist.all_gather(parts, t.contiguous(), group=g)
            t = torch.cat(parts)
        return t

    return _map_tree(leaf, v)


def _component_reduce(v: dict, groups: Sequence[dist.ProcessGroup]) -> dict:
    """Cross-shard fold of per-component best edges, (w desc, row asc).

    Each shard contributes its local winner per dense component id
    (``ops.component_best_edge``; empty segments carry (f32.min, BIG_I, -1),
    which lose every comparison). Global row ids are unique across shards,
    so after the (w, row) fold the winner is unique and every other leaf
    ('col', and payload such as the sharded sweep's 'tcomp') follows by one
    more MIN each. The fold runs per axis, innermost first; the order is
    total, so the tiered fold equals a flat one bit for bit.
    """
    payload = [k for k in v if k not in ("w", "row")]
    for g in reversed(groups):
        w = _all_reduce(v["w"], "max", g)
        on_max = v["w"] == w  # the LOCAL w against the reduced one
        row = _all_reduce(torch.where(on_max, v["row"], BIG_I), "min", g)
        mine = on_max & (v["row"] == row)
        out = {"w": w, "row": row}
        for k in payload:
            pk = _all_reduce(torch.where(mine, v[k], BIG_I), "min", g)
            out[k] = torch.where(pk == BIG_I, -1, pk)
        v = out
    return v


_REDUCERS: dict[str, Callable[[Any, Sequence[dist.ProcessGroup]], Any]] = {
    "sum": _reduce("sum"),
    "min": _reduce("min"),
    "max": _reduce("max"),
    "gather": _gather,
    "component": _component_reduce,
}


def _kinds(reduce_kinds: Any) -> list[str]:
    if isinstance(reduce_kinds, dict):
        return [k for v in reduce_kinds.values() for k in _kinds(v)]
    return [reduce_kinds]


def _apply(kinds: Any, out: Any, groups) -> Any:
    if isinstance(kinds, dict):
        if set(kinds) != set(out):
            raise ValueError(f"reduce kinds {sorted(kinds)} do not match outputs {sorted(out)}")
        return {k: _apply(kinds[k], out[k], groups) for k in kinds}
    return out if kinds == "shard" else _REDUCERS[kinds](out, groups)


def make_job(
    mesh: DeviceMesh,
    axes: tuple[str, ...],
    map_combine: Callable,
    reduce_kinds: Any,
    *,
    name: str = "job",
) -> Callable:
    """Build a MapReduce job.

    Args:
      mesh: device mesh over the ranks.
      axes: mesh axis name(s) the data rows are sharded over.
      map_combine: (data_block_tree, bcast_tree) -> out_tree. Runs on each
        rank's row block; must do its own local aggregation (the combiner).
      reduce_kinds: dict tree PREFIX of out_tree with
        'sum'|'min'|'max'|'gather'|'component'|'shard' string leaves.
      name: debugging label.

    Returns:
      fn (data_tree, bcast_tree) -> out_tree. Every rank passes its own row
      block as data and the same replicated bcast.
    """
    bad = sorted({k for k in _kinds(reduce_kinds) if k != "shard" and k not in _REDUCERS})
    if bad:
        raise ValueError(
            f"make_job supports {sorted(_REDUCERS)}/shard reduce kinds"
            f" ('topk' is fold-mode only), got {bad}"
        )
    groups = axis_groups(mesh, axes)

    def run(data, bcast=()):
        return _apply(reduce_kinds, map_combine(data, bcast), groups)

    run.__name__ = f"mr_job_{name}"
    return run


def run_job(
    mesh: DeviceMesh,
    axes: tuple[str, ...],
    map_combine: Callable,
    reduce_kinds: Any,
    data: Any,
    bcast: Any = (),
    *,
    name: str = "job",
) -> Any:
    """One-shot convenience wrapper around make_job."""
    return make_job(mesh, axes, map_combine, reduce_kinds, name=name)(data, bcast)


# ------------------------------------------------------- sharded-bcast path


def _rotate(tree: Any, group: dist.ProcessGroup):
    """Start one ring hop: send this rank's copy of every leaf to the next
    rank of ``group``, receive the previous rank's. Returns (the receive
    buffers as a tree, the pending works)."""
    pairs = ring_permutation(dist.get_world_size(group))  # (sender, receiver)
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, dict(pairs)[me])
    prv = dist.get_global_rank(group, {j: i for i, j in pairs}[me])
    sends = [t.contiguous() for t in _leaves(tree)]
    recvs = [torch.empty_like(t) for t in sends]
    p2p = []
    for tag, (snd, rcv) in enumerate(zip(sends, recvs)):
        p2p.append(dist.P2POp(dist.isend, snd, nxt, group, tag))
        p2p.append(dist.P2POp(dist.irecv, rcv, prv, group, tag))
    return _unflatten(tree, recvs), dist.batch_isend_irecv(p2p)


def ring_sweep(
    groups: Sequence[dist.ProcessGroup],
    block: Any,
    fold: Callable[[Any, Any], Any],
    acc: Any,
    *,
    overlap: bool = True,
) -> Any:
    """Visit every shard's row block of a dim-0-sharded tree via nested
    point-to-point rings: the sharded-bcast data path.

    ``block`` is this rank's resident slice; copies rotate through the ranks
    (block i moves to rank i+1 of the axis group) and ``fold(acc, visiting)``
    consumes each as it arrives, so no rank ever holds the full array.
    ``groups`` are the axis groups OUTERMOST first; on a (pod, data) mesh the
    inner 'data' ring rotates a copy of the current panel around the pod, and
    between inner rings the pristine panel rotates once across pods.

    ``overlap=True`` issues the next hop before folding the block in hand
    (with NCCL the exchange then runs beside the fold's kernels);
    ``overlap=False`` issues it after the fold. Both fold the same blocks in
    the same order, so an order-independent fold gives the same bits. A
    group of one rank folds its own block and sends nothing.
    """
    if not groups:
        return fold(acc, block)
    group, rest = groups[0], groups[1:]
    size = dist.get_world_size(group)
    cur = block
    for step in range(size):
        last = step == size - 1
        if not last and overlap:
            nxt, works = _rotate(cur, group)
        acc = ring_sweep(rest, cur, fold, acc, overlap=overlap)
        if not last and not overlap:
            nxt, works = _rotate(cur, group)
        if not last:
            for w in works:
                w.wait()
            cur = nxt
    return acc


def _component_merge(a: dict, b: dict) -> dict:
    """Per-segment lexicographic best of two {'w','row','col',...} winner
    sets, (w desc, row asc). Global row ids are unique, so the order is
    total and the merge associative and commutative: folding shards' winner
    sets in any order gives the flat reduce's winners."""
    take_b = (b["w"] > a["w"]) | ((b["w"] == a["w"]) & (b["row"] < a["row"]))
    return {k: torch.where(take_b, b[k], a[k]) for k in a}


# --------------------------------------------------------------- fold mode

_MONOID: dict[str, Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = {
    "sum": torch.add,
    "min": torch.minimum,
    "max": torch.maximum,
}


def _zip_tree(fn: Callable, a: Any, b: Any) -> Any:
    if isinstance(a, dict):
        return {k: _zip_tree(fn, a[k], b[k]) for k in a}
    if isinstance(a, (tuple, list)):
        return type(a)(_zip_tree(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


def _top(scores: torch.Tensor, s: int) -> torch.Tensor:
    """Positions of the s highest scores, ties to the lower position (a
    stable descending sort, as ``jax.lax.top_k`` breaks them; ``torch.topk``
    promises no order among ties)."""
    return torch.sort(scores, descending=True, stable=True).indices[:s]


def _topk_merge(a: dict, b: dict) -> dict:
    """Chunk monoid of the 'topk' fold kind: top-s (by the 'score' leaf) of
    the union of two fixed-size candidate sets, a's before b's among ties.
    Every other leaf of the subtree is payload, carried along dim 0:
    top_s(A ∪ B) = top_s(top_s(A) ∪ top_s(B)), the monoid of
    ``core/sampling.merge_top_s``."""
    pos = _top(torch.cat([a["score"], b["score"]]), a["score"].shape[0])
    return _zip_tree(lambda av, bv: torch.cat([av, bv])[pos], a, b)


def _check_component(subtree: Any) -> None:
    if not (isinstance(subtree, dict) and {"w", "row", "col"} <= set(subtree)):
        raise ValueError(
            "'component' fold kind expects a dict subtree with at least"
            " {'w','row','col'} per-segment winners"
            " (ops.component_best_edge layout, extra int32 payload leaves"
            f" allowed), got {type(subtree).__name__}"
        )


def _check_topk(subtree: Any) -> None:
    if not (isinstance(subtree, dict) and "score" in subtree):
        raise ValueError(
            "'topk' fold kind expects a dict subtree with a 'score' leaf"
            " (plus payload arrays aligned on axis 0), got"
            f" {type(subtree).__name__}"
        )
    s = subtree["score"].shape[0]

    def check(path: str, leaf: Any) -> None:
        if isinstance(leaf, dict):
            for k, v in leaf.items():
                check(f"{path}[{k!r}]", v)
        elif tuple(leaf.shape[:1]) != (s,):
            # a misaligned payload would otherwise survive the merge as an
            # index error or garbage rows
            raise ValueError(
                "'topk' payload leaves must share the score leaf's axis-0"
                f" length {s}; leaf {path} has shape {tuple(leaf.shape)}"
            )

    check("", subtree)


def _split(kinds: Any, out: Any, folds: list) -> Any:
    """Walk the kinds prefix tree over ``out``: fold-kind subtrees go to
    ``folds`` in kind order; the returned tree keeps the 'shard' subtrees
    and holds None at fold positions."""
    if isinstance(kinds, dict):
        if set(kinds) != set(out):
            raise ValueError(f"reduce kinds {sorted(kinds)} do not match outputs {sorted(out)}")
        return {k: _split(kinds[k], out[k], folds) for k in kinds}
    if kinds == "shard":
        return out
    folds.append(out)
    return None


def _fill(kinds: Any, reduced: Any) -> Any:
    if isinstance(kinds, dict):
        return {k: _fill(v, reduced) for k, v in kinds.items()}
    return None if kinds == "shard" else next(reduced)


class FoldJob:
    """Streaming fold mode of a MapReduce job (out-of-core chunk streams).

    ``make_job`` maps ONE resident row block and reduces at once; a FoldJob
    consumes a SEQUENCE of same-shaped chunks:

      step(carry, data_chunk, bcast) -> (carry, shard_outs)
          map this rank's block of the chunk and merge its partials into
          this rank's carry, ``op(carry, chunk_partial)``: no collective
          runs in a step. ``carry=None`` opens the fold. 'shard' outputs
          pass through per chunk; fold positions in ``shard_outs`` are None.
      finalize(carry) -> out
          ONE collective pass per fold entry over the per-axis groups,
          innermost axis first. 'shard' positions in the result are None.

    The paper's combiner discipline lifted across chunks: a mapper folds
    every split it is handed before anything shuffles, so a whole
    multi-chunk pass costs the wire one resident job. Kinds: 'sum' | 'min'
    | 'max' | 'topk' | 'component' (+ 'shard' passthrough), at any prefix
    of the output tree; 'gather' has no chunk-monoid form.

    'component' carries this rank's running per-segment best edge, (w desc,
    row asc), a total order since rows are globally unique, and finalizes
    through the tiered ``_component_reduce``.

    'topk' is the running reservoir: a dict subtree with a 'score' leaf of
    fixed size s and payload leaves aligned on dim 0. The carry keeps this
    rank's top s; finalize owner-scatters: ONE all-gather of the P·s scores
    in flat shard order, ranked the same way on every rank, then each
    owner contributes its winning payload rows to a sum all-reduce and
    every other rank zeros (one non-zero addend per slot: the sum is an
    exact move). Wire O(P·s + s·d) instead of the O(P·s·d) payload gather.

    The JAX package stacks every shard's partial into one (P, ...) carry;
    under ``torch.distributed`` each rank holds only its own slice, so the
    carry is this rank's partial: a tuple with one entry per fold kind.
    """

    def __init__(
        self,
        mesh: DeviceMesh,
        axes: tuple[str, ...],
        map_combine: Callable,
        reduce_kinds: Any,
        *,
        name: str = "fold",
    ):
        flat = _kinds(reduce_kinds)
        bad = sorted({k for k in flat if k not in ("shard", "topk", "component", *_MONOID)})
        if bad:
            raise ValueError(
                f"fold mode supports sum/min/max/topk/component/shard reduce kinds, got {bad}"
            )
        self.name = name
        self.mesh = mesh
        self.axes = axes
        self.map_combine = map_combine
        self.reduce_kinds = reduce_kinds
        self.fold_kinds = [k for k in flat if k != "shard"]
        self.groups = axis_groups(mesh, axes)
        self.me = shard_index(mesh, axes)
        self.device = mesh_device(mesh)

    def _split(self, out: Any) -> tuple[list, Any]:
        folds: list = []
        shards = _split(self.reduce_kinds, out, folds)
        return folds, shards

    def step(self, carry, data, bcast=()):
        """Fold one chunk; ``carry=None`` opens the fold."""
        folds, shards = self._split(self.map_combine(data, bcast))
        if carry is None:
            for f, k in zip(folds, self.fold_kinds):
                if k == "topk":
                    _check_topk(f)
                elif k == "component":
                    _check_component(f)
            return tuple(folds), shards
        merged = []
        for c, f, k in zip(carry, folds, self.fold_kinds):
            if k == "topk":  # joint merge across the subtree, not leafwise
                merged.append(_topk_merge(c, f))
            elif k == "component":  # joint: the selector reads w and row together
                merged.append(_component_merge(c, f))
            else:
                merged.append(_zip_tree(_MONOID[k], c, f))
        return tuple(merged), shards

    def _topk_finalize(self, v: dict) -> dict:
        s = v["score"].shape[0]
        g_score = _gather(v["score"], self.groups)  # flat shard order
        pos = _top(g_score, s)
        mine = (pos // s) == self.me
        local = torch.where(mine, pos % s, 0)

        def collect(x):
            rows = x[local]
            keep = mine.reshape(mine.shape + (1,) * (rows.ndim - 1))
            return _REDUCERS["sum"](torch.where(keep, rows, torch.zeros_like(rows)), self.groups)

        out = _map_tree(collect, v)
        out["score"] = g_score[pos]  # already exact from the ranked gather
        return out

    def finalize(self, carry):
        """One collective pass over this rank's carried partials."""
        if carry is None:
            raise ValueError("finalize before any step: empty stream")
        reduced = (
            self._topk_finalize(c) if k == "topk" else _REDUCERS[k](c, self.groups)
            for c, k in zip(carry, self.fold_kinds)
        )
        return _fill(self.reduce_kinds, iter(reduced))

    def carry_device(self, host_carry):
        """The ``restore_carry`` hook of ``run_pass``: a snapshot's carry
        (this rank's partials on the host) back on this rank's device, so
        the resumed fold is the one that never stopped."""
        from repro_torch.resilience.checkpoint import carry_from_host

        return carry_from_host(host_carry, device=self.device)


def make_fold_job(
    mesh: DeviceMesh,
    axes: tuple[str, ...],
    map_combine: Callable,
    reduce_kinds: Any,
    *,
    name: str = "fold",
) -> FoldJob:
    """Streaming fold mode: map each chunk, combine monoid partials locally,
    one collective at the end (see FoldJob). Supports
    sum/min/max/topk/component/shard reduce kinds."""
    return FoldJob(mesh, axes, map_combine, reduce_kinds, name=name)
