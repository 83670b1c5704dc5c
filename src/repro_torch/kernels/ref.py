"""Plain PyTorch versions of the port's kernels: the semantic ground truth.

Each function mirrors its namesake in the JAX package's ``kernels/ref.py``.
``ops`` runs these for tensors on the CPU; on the card it launches the
hand-written kernels, and ``chip_smoke.py`` holds each kernel against its
plain version here on the same CUDA tensors.

Two JAX behaviours need explicit care in PyTorch:
  * ``jax.nn.one_hot`` maps an out-of-range label to a zero row, where
    ``torch.nn.functional.one_hot`` raises; ``_one_hot`` compares instead.
  * ``jax.ops.segment_sum/segment_min`` drop out-of-range ids, where
    ``index_add_``/``scatter_reduce_`` raise; ``common.segment_*`` mask first.
"""

from __future__ import annotations

import torch

from repro_torch.common import segment_min, segment_sum

# "No member seen": min-reducible and finite, so arithmetic stays finite.
BIG = float(torch.finfo(torch.float32).max)
# "No row seen" in segmented argmin folds.
BIG_I = int(torch.iinfo(torch.int32).max)
# Masked similarity: every real similarity beats it.
NEG = float(torch.finfo(torch.float32).min)
# Rows prune only when the deflated bounds clear each other by this much, so
# f32 rounding in the bounds cannot move a label.
PRUNE_MARGIN = 1e-4


def _sims(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n, d) x (m, d) -> (n, m) f32 dot products (f32 accumulation)."""
    return a.float() @ b.float().T


def _one_hot(idx: torch.Tensor, k: int, w: torch.Tensor | None) -> torch.Tensor:
    """(n, k) f32 one-hot, zero rows for labels outside [0, k), scaled by w."""
    bins = torch.arange(k, device=idx.device)
    hot = (idx.long()[:, None] == bins[None, :]).float()
    if w is not None:
        hot = hot * w.float()[:, None]
    return hot


def assign_argmax(
    x: torch.Tensor, centers: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest center by dot product: ((n,) int32 index, ties -> lowest;
    (n,) f32 similarity)."""
    sims = _sims(x, centers)
    return torch.argmax(sims, dim=1).int(), torch.amax(sims, dim=1)


def cluster_stats(
    x: torch.Tensor, idx: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The one-hot combiner, the oracle ``label_stats`` is held to: ((k, d)
    f32 per-cluster sums, (k,) f32 counts) of the rows of ``x`` under the
    labels ``idx`` in [0, k)."""
    hot = _one_hot(idx, k, None)
    return hot.T @ x.float(), hot.sum(dim=0)


def assign_stats(
    x: torch.Tensor, centers: torch.Tensor, w: torch.Tensor | None = None
) -> tuple[torch.Tensor, ...]:
    """One-hot oracle of the fused pass: (idx, best_sim, sums, counts,
    min_sim, sumsq). Weight-0 rows count nowhere; empty clusters get BIG."""
    k = centers.shape[0]
    idx, best_sim = assign_argmax(x, centers)
    hot = _one_hot(idx, k, w)
    xf = x.float()
    sums = hot.T @ xf
    counts = hot.sum(dim=0)
    sumsq = hot.T @ (xf * xf).sum(dim=1)
    member = torch.where(hot > 0, best_sim[:, None], BIG)
    if x.shape[0]:
        min_sim = member.amin(dim=0)
    else:
        min_sim = torch.full((k,), BIG, device=x.device)
    min_sim = torch.where(counts > 0, min_sim, BIG)
    return idx, best_sim, sums, counts, min_sim, sumsq


def assign_stats_scatter(
    x: torch.Tensor, centers: torch.Tensor, w: torch.Tensor | None = None
) -> tuple[torch.Tensor, ...]:
    """The fused pass with segment reductions: O(n*d) adds instead of the
    oracle's O(n*k*d). Same contract as ``assign_stats``."""
    k = centers.shape[0]
    idx, best_sim = assign_argmax(x, centers)
    xf = x.float()
    rowsq = (xf * xf).sum(dim=1)
    if w is not None:
        wf = w.float()
        xf = xf * wf[:, None]
        rowsq = rowsq * wf
        counts = segment_sum(wf, idx, k)
        sim_m = torch.where(wf > 0, best_sim, BIG)
    else:
        counts = segment_sum(torch.ones_like(best_sim), idx, k)
        sim_m = best_sim
    sums = segment_sum(xf, idx, k)
    sumsq = segment_sum(rowsq, idx, k)
    min_sim = torch.where(counts > 0, segment_min(sim_m, idx, k), BIG)
    return idx, best_sim, sums, counts, min_sim, sumsq


def deflate_bounds(
    prev_idx: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    rownorm: torch.Tensor,
    drift: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Deflate carried similarity bounds by per-center drift (Cauchy-Schwarz).

    lo bounds sim(x, c_prev_idx) from below and hi bounds the similarity to
    every other center from above, both under the centers of the pass that
    produced them. |sim(x, c') - sim(x, c)| <= |x| |c' - c| moves them to the
    current centers: lo' = lo - |x| drift[prev_idx], hi' = hi + |x| max of
    the other centers' drift. prev_idx outside [0, k) is the unknown sentinel.

    Returns (ok (n,) bool: prev_idx is real, pidx (n,) int32 clipped into
    [0, k), lo_adj, hi_adj (n,) f32).
    """
    k = drift.shape[0]
    ok = (prev_idx >= 0) & (prev_idx < k)
    pidx = torch.clamp(prev_idx, 0, k - 1).to(torch.int32)
    argd = torch.argmax(drift)
    maxd = torch.amax(drift)
    # largest drift among the centers OTHER than the row's own (top-2)
    others = torch.where(torch.arange(k, device=drift.device) == argd, -1.0, drift)
    sec = torch.clamp(torch.amax(others), min=0.0)
    d_other = torch.where(pidx == argd, sec, maxd)
    lo_adj = lo - rownorm * drift[pidx.long()]
    hi_adj = hi + rownorm * d_other
    return ok, pidx, lo_adj, hi_adj


def _bounded_assign(
    x: torch.Tensor,
    centers: torch.Tensor,
    prev_idx: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    drift: torch.Tensor,
    margin: float,
) -> tuple[torch.Tensor, ...]:
    """Assignment half of the bounded plain versions: (idx, best_sim, lo_out,
    hi_out, pruned, rowsq). The full (n, k) sweep is computed; pruned rows
    take their carried index, so a pruning fault shows in the labels."""
    k = centers.shape[0]
    xf = x.float()
    rowsq = torch.sum(xf * xf, dim=1)
    ok, pidx, lo_adj, hi_adj = deflate_bounds(prev_idx, lo, hi, torch.sqrt(rowsq), drift)
    pruned = ok & (lo_adj > hi_adj + margin)
    sims = _sims(x, centers)
    brute_idx = torch.argmax(sims, dim=1).int()
    brute_best = torch.amax(sims, dim=1)
    # second-best VALUE: mask one instance of the winner column only, so a
    # duplicate center counts as the second best
    cols = torch.arange(k, device=x.device)
    second = torch.amax(torch.where(cols[None, :] == brute_idx[:, None], NEG, sims), dim=1)
    idx = torch.where(pruned, pidx, brute_idx)
    at_prev = torch.gather(sims, 1, pidx.long()[:, None])[:, 0]
    best_sim = torch.where(pruned, at_prev, brute_best)
    # refreshed bounds against THESE centers: lo is the winner's similarity,
    # hi the exact second value where the sweep ran, the deflated carry
    # (still an upper bound) where the row was pruned
    hi_out = torch.where(pruned, hi_adj, second)
    return idx, best_sim, best_sim, hi_out, pruned, rowsq


def assign_stats_bounded(
    x: torch.Tensor,
    centers: torch.Tensor,
    prev_idx: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    drift: torch.Tensor,
    w: torch.Tensor | None = None,
    *,
    margin: float = PRUNE_MARGIN,
) -> tuple[torch.Tensor, ...]:
    """One-hot oracle of the bound-pruned pass: (idx, best_sim, sums, counts,
    min_sim, sumsq, idx, lo_out, hi_out, pruned). The first six are exactly
    ``assign_stats``' for ANY bounds state: a row prunes only when its
    deflated bounds prove the carried winner unchanged, with ``margin`` to
    spare (lo' > hi' + margin; at ``inf`` nothing prunes)."""
    k = centers.shape[0]
    idx, best_sim, lo_out, hi_out, pruned, rowsq = _bounded_assign(
        x, centers, prev_idx, lo, hi, drift, margin
    )
    hot = _one_hot(idx, k, w)
    sums = hot.T @ x.float()
    counts = hot.sum(dim=0)
    sumsq = hot.T @ rowsq
    member = torch.where(hot > 0, best_sim[:, None], BIG)
    if x.shape[0]:
        min_sim = member.amin(dim=0)
    else:
        min_sim = torch.full((k,), BIG, device=x.device)
    min_sim = torch.where(counts > 0, min_sim, BIG)
    return idx, best_sim, sums, counts, min_sim, sumsq, idx, lo_out, hi_out, pruned


def assign_stats_bounded_scatter(
    x: torch.Tensor,
    centers: torch.Tensor,
    prev_idx: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    drift: torch.Tensor,
    w: torch.Tensor | None = None,
    *,
    margin: float = PRUNE_MARGIN,
) -> tuple[torch.Tensor, ...]:
    """``assign_stats_bounded`` with segment reductions for the statistics
    (the contract of ``assign_stats_scatter``)."""
    k = centers.shape[0]
    idx, best_sim, lo_out, hi_out, pruned, rowsq = _bounded_assign(
        x, centers, prev_idx, lo, hi, drift, margin
    )
    xf = x.float()
    if w is not None:
        wf = w.float()
        xf = xf * wf[:, None]
        rowsq = rowsq * wf
        counts = segment_sum(wf, idx, k)
        sim_m = torch.where(wf > 0, best_sim, BIG)
    else:
        counts = segment_sum(torch.ones_like(best_sim), idx, k)
        sim_m = best_sim
    sums = segment_sum(xf, idx, k)
    sumsq = segment_sum(rowsq, idx, k)
    min_sim = torch.where(counts > 0, segment_min(sim_m, idx, k), BIG)
    return idx, best_sim, sums, counts, min_sim, sumsq, idx, lo_out, hi_out, pruned


def label_stats(
    x: torch.Tensor, idx: torch.Tensor, k: int, w: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """One-hot oracle: ((k, d) per-label weighted sums, (k,) weight totals).
    Labels outside [0, k) and weight-0 rows contribute nothing."""
    hot = _one_hot(idx, k, w)
    return hot.T @ x.float(), hot.sum(dim=0)


def label_stats_scatter(
    x: torch.Tensor, idx: torch.Tensor, k: int, w: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """``label_stats`` with segment reductions (O(n*d) adds)."""
    xf = x.float()
    if w is not None:
        wf = w.float()
        xf = xf * wf[:, None]
    else:
        wf = torch.ones((x.shape[0],), dtype=torch.float32, device=x.device)
    return segment_sum(xf, idx, k), segment_sum(wf, idx, k)


def fold_rows_per_chunk(n: int, chunks: int) -> int:
    """Rows of each of the fold's ``chunks`` row chunks (the last may hold
    fewer): ceil(n / chunks) rounded up to a multiple of 128, as
    ``csrc/label_stats.cuh``'s ``launch_stats`` cuts them."""
    per = -(-n // chunks)
    return -(-per // 128) * 128


def fold_in_order(
    x: torch.Tensor,
    idx: torch.Tensor,
    k: int,
    chunks: int,
    w: torch.Tensor | None = None,
    rowsq: torch.Tensor | None = None,
    sim: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None, torch.Tensor | None]:
    """The kernels' fold (``csrc/label_stats.cuh``), add for add: (sums,
    counts, sumsq, min_sim), the last two None without ``rowsq``, ``sim``.

    Rows with a label in [0, k) and a weight other than 0 (a null ``w``
    weighs 1) fold into their label. Within each row chunk
    (``fold_rows_per_chunk``) a label's rows are added in row order from 0,
    ``acc + w * x`` (``acc + x`` without ``w``) with the product rounded to
    f32 before the add; counts add ``w``, sumsq ``w * rowsq``, and min_sim
    keeps the lowest ``sim`` of the rows with w > 0. The chunk partials are
    then added in chunk order from 0 (min_sim: the lowest; BIG where the
    count is 0). Plain tensor code for tests and ``chip_smoke.py``: step j
    adds every label's j-th row of a chunk at once, multiply and add as two
    operations (never fused), on x's device; bf16 rows are upcast exactly."""
    n, d = x.shape
    dev = x.device
    lab = idx.long()
    own = (lab >= 0) & (lab < k)
    if w is not None:
        own &= w != 0
    wf = torch.ones((n,), device=dev) if w is None else w.float()
    rpc = fold_rows_per_chunk(n, chunks)
    sums = torch.zeros((k, d), device=dev)
    counts = torch.zeros((k,), device=dev)
    sumsq = torch.zeros((k,), device=dev)
    mins = torch.full((k,), BIG, device=dev)
    for c in range(chunks):
        r0 = min(n, c * rpc)
        r1 = min(n, r0 + rpc)
        rows = r0 + torch.nonzero(own[r0:r1]).flatten()
        labs, order = torch.sort(lab[rows], stable=True)  # each label's rows in row order
        rows = rows[order]
        _, run = torch.unique_consecutive(labs, return_counts=True)
        rank = torch.arange(rows.numel(), device=dev) - torch.repeat_interleave(
            torch.cumsum(run, 0) - run, run)
        rank, order = torch.sort(rank, stable=True)  # step j: every label's j-th row
        rows, labs = rows[order], labs[order]
        part = torch.zeros((k, d), device=dev)
        pc = torch.zeros((k,), device=dev)
        psq = torch.zeros((k,), device=dev)
        pmin = torch.full((k,), BIG, device=dev)
        at = 0
        for m in torch.bincount(rank).tolist():
            r, lj = rows[at:at + m], labs[at:at + m]  # distinct labels
            at += m
            xj, wj = x[r].float(), wf[r]
            part[lj] = part[lj] + (xj if w is None else wj[:, None] * xj)
            pc[lj] = pc[lj] + wj
            if rowsq is not None:
                psq[lj] = psq[lj] + (rowsq[r] if w is None else wj * rowsq[r])
            if sim is not None:
                pmin[lj] = torch.where(wj > 0, torch.fmin(pmin[lj], sim[r]), pmin[lj])
        sums = sums + part
        counts = counts + pc
        sumsq = sumsq + psq
        mins = torch.fmin(mins, pmin)
    return (sums, counts, None if rowsq is None else sumsq,
            None if sim is None else torch.where(counts > 0, mins, BIG))


def best_edge(
    sim: torch.Tensor, labels_row: torch.Tensor, labels_col: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row best cross-component edge of a similarity block.

    A column is a candidate iff its label differs from the row's and both
    are >= 0 (negative labels mark padding). Returns ((r,) int32 column,
    ties -> lowest, -1 if none; (r,) f32 similarity, NEG if none). c = 0
    gives every row (-1, NEG), where the JAX package's version raises."""
    if sim.shape[1] == 0:  # no column: no row has a candidate
        r = sim.shape[0]
        return (torch.full((r,), -1, dtype=torch.int32, device=sim.device),
                torch.full((r,), NEG, dtype=torch.float32, device=sim.device))
    lr = labels_row[:, None]
    lc = labels_col[None, :]
    cross = (lr != lc) & (lr >= 0) & (lc >= 0)
    masked = torch.where(cross, sim.float(), NEG)
    best_s = torch.amax(masked, dim=1)
    best_j = torch.argmax(masked, dim=1).int()
    return torch.where(best_s == NEG, -1, best_j).int(), best_s


def sim_best_edge(
    xs_rows: torch.Tensor,
    xs_all: torch.Tensor,
    labels_row: torch.Tensor,
    labels_col: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``best_edge(xs_rows @ xs_all.T, ...)``: this version does build the
    (r, c) similarity block; the kernel never does."""
    return best_edge(_sims(xs_rows, xs_all), labels_row, labels_col)


def component_best_edge(
    row_w: torch.Tensor,
    row_j: torch.Tensor,
    rows: torch.Tensor,
    comp: torch.Tensor,
    c: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-COMPONENT lexicographic best candidate, (w desc, row asc): the
    combiner of distributed Borůvka. Lexsort oracle, made of stable sorts.

    ``rows`` are GLOBAL row ids, assumed unique; ids of ``comp`` outside
    [0, c) (pad rows) fall into no segment. Returns (c,) f32 best_w, (c,)
    int32 best_row, (c,) int32 best_j; an empty segment gets (NEG, BIG_I,
    -1). The winner's w is the row's own bits (-0.0 included); -0.0 and
    +0.0 tie, as they compare equal.
    """
    dev = row_w.device
    w = row_w.float()
    # comp asc, w desc, row asc: stable sorts from the minor key up
    order = torch.argsort(rows, stable=True)
    order = order[torch.argsort(-w[order], stable=True)]
    order = order[torch.argsort(comp[order], stable=True)]
    comp_s = comp[order].long()
    first = torch.ones(comp_s.shape, dtype=torch.bool, device=dev)
    first[1:] = comp_s[1:] != comp_s[:-1]
    slot = torch.where(first & (comp_s >= 0) & (comp_s < c), comp_s, c)  # c: sink
    best_w = torch.full((c + 1,), NEG, dtype=torch.float32, device=dev)
    best_row = torch.full((c + 1,), BIG_I, dtype=torch.int32, device=dev)
    best_j = torch.full((c + 1,), -1, dtype=torch.int32, device=dev)
    best_w[slot] = w[order]
    best_row[slot] = rows[order].int()
    best_j[slot] = row_j[order].int()
    return best_w[:c], best_row[:c], best_j[:c]


def component_best_edge_segment(
    row_w: torch.Tensor,
    row_j: torch.Tensor,
    rows: torch.Tensor,
    comp: torch.Tensor,
    c: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``component_best_edge`` in three segment passes, O(r) and no sort:
    a max on w, a min on row among the w-winners, then the unique winner
    writes its w and column. Dropped ids go to a sink slot c.

    The JAX package's XLA path writes the segment max as w, which is +0.0
    where the winner's w is -0.0; here, as in the lexsort oracle and the
    kernel, the winner writes its own bits.
    """
    dev = row_w.device
    w = row_w.float()
    rows = rows.int()
    seg = torch.where((comp >= 0) & (comp < c), comp, c).long()
    w_max = torch.full((c + 1,), float("-inf"), dtype=torch.float32, device=dev)
    w_max = w_max.scatter_reduce(0, seg, w, "amax")
    on_max = w == w_max[seg]
    best_row = torch.full((c + 1,), BIG_I, dtype=torch.int32, device=dev)
    best_row = best_row.scatter_reduce(0, seg, torch.where(on_max, rows, BIG_I), "amin")
    winner = on_max & (rows == best_row[seg]) & (seg < c)  # unique per segment
    slot = torch.where(winner, seg, c)
    best_w = torch.full((c + 1,), NEG, dtype=torch.float32, device=dev)
    best_j = torch.full((c + 1,), -1, dtype=torch.int32, device=dev)
    best_w[slot] = w
    best_j[slot] = row_j.int()
    return best_w[:c], best_row[:c], best_j[:c]


def flash_decode(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, length: int | torch.Tensor
) -> torch.Tensor:
    """One-token attention against a (possibly padded) KV cache.

    q (h, dh) query of the new token; k, v (s, hk, dh) caches; positions
    >= ``length`` are masked to NEG. GQA: query head i reads kv head
    i // (h // hk). Logits and softmax in f32, output in q's dtype. At
    length <= 0 every logit is NEG, so the softmax is uniform and the output
    is the mean of v over all s positions (the Pallas kernel of the JAX
    package returns zeros there).
    """
    s, hk, dh = k.shape
    group = q.shape[0] // hk
    kq = k.repeat_interleave(group, dim=1).float()  # (s, h, dh)
    vq = v.repeat_interleave(group, dim=1).float()
    scale = torch.sqrt(torch.tensor(dh, dtype=torch.float32, device=q.device))
    logits = torch.einsum("hd,shd->hs", q.float(), kq) / scale
    mask = torch.arange(s, device=q.device)[None, :] < length
    logits = torch.where(mask, logits, NEG)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("hs,shd->hd", w, vq).to(q.dtype)
