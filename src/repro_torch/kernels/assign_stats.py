"""Host wrappers of the CUDA kernels ``csrc/label_stats.cu`` (per-label
weighted sums and weight totals), ``csrc/assign_stats.cu`` (nearest center
plus per-cluster statistics) and ``csrc/assign_stats_bounded.cu`` (the same
pass pruned by carried bounds and by the slabs' cone bounds).

Counterpart of the JAX package's ``kernels/assign_stats.py``. ``launches``
counts, per kernel, the calls that launched it.
"""

from __future__ import annotations

from ctypes import c_float as F
from ctypes import c_int as I
from ctypes import c_void_p as P

import torch

from repro_torch.kernels import ref

launches = {"label_stats": 0, "assign_stats": 0, "assign_stats_bounded": 0}

# C entries: pointers and the stream as c_void_p, sizes as c_int
_SIGNATURES = {
    "label_stats": {
        "label_stats_chunks": [I, I, I],
        "label_stats": [P, P, P, I, I, I, I, P, P, P, P, P],
    },
    "assign_stats": {
        "assign_stats_chunks": [I, I, I],
        "assign_stats": [P, P, P, I, I, I, I, P, P, P, P, P, P, P, P, P, P],
    },
    "assign_stats_bounded": {
        "assign_stats_bounded_slab": [],
        "assign_stats_bounded_chunks": [I, I, I],
        "assign_stats_bounded": [P, P, P, P, P, P, P, P, I, I, I, I, F, I]
        + [P] * 11,
    },
}


def _lib(name: str):
    from repro_torch.kernels import _build

    return _build.library(name, _SIGNATURES[name])


def _weights(w: torch.Tensor | None, n: int, dev: torch.device) -> torch.Tensor:
    if w is None:
        return torch.ones((n,), dtype=torch.float32, device=dev)
    return w


def _check_k_d(k: int, d: int) -> None:
    if k < 1 or d < 1:
        raise ValueError(f"the kernels need k >= 1 and d >= 1, got k={k}, d={d}")


def label_stats_cuda(
    x: torch.Tensor, idx: torch.Tensor, k: int, w: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """(n, d) f32, (n,) int32[, (n,) f32] -> ((k, d) sums, (k,) weight
    totals). Contract of ``ref.label_stats``."""
    from repro_torch.kernels import _build

    n, d = x.shape
    dev = x.device
    _check_k_d(k, d)
    w = _weights(w, n, dev)
    _build.require(x, "x", torch.float32, (n, d), dev)
    _build.require(idx, "idx", torch.int32, (n,), dev)
    _build.require(w, "w", torch.float32, (n,), dev)
    lib = _lib("label_stats")
    chunks = lib.label_stats_chunks(n, k, d)
    part = torch.empty((chunks, k, d), dtype=torch.float32, device=dev)
    part_k = torch.empty((chunks, 3, k), dtype=torch.float32, device=dev)
    sums = torch.empty((k, d), dtype=torch.float32, device=dev)
    counts = torch.empty((k,), dtype=torch.float32, device=dev)
    err = lib.label_stats(
        x.data_ptr(), idx.data_ptr(), w.data_ptr(), n, d, k, chunks,
        part.data_ptr(), part_k.data_ptr(), sums.data_ptr(), counts.data_ptr(),
        _build.stream(x),
    )
    _build.check(err, "label_stats")
    launches["label_stats"] += 1
    return sums, counts


def assign_stats_cuda(
    x: torch.Tensor, centers: torch.Tensor, w: torch.Tensor | None = None
) -> tuple[torch.Tensor, ...]:
    """(n, d), (k, d) f32[, (n,) f32] -> (idx, best_sim, sums, counts,
    min_sim, sumsq). Contract of ``ref.assign_stats``."""
    from repro_torch.kernels import _build

    n, d = x.shape
    k = centers.shape[0]
    dev = x.device
    _check_k_d(k, d)
    w = _weights(w, n, dev)
    _build.require(x, "x", torch.float32, (n, d), dev)
    _build.require(centers, "centers", torch.float32, (k, d), dev)
    _build.require(w, "w", torch.float32, (n,), dev)
    lib = _lib("assign_stats")
    chunks = lib.assign_stats_chunks(n, k, d)
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    best_sim = torch.empty((n,), dtype=torch.float32, device=dev)
    rowsq = torch.empty((n,), dtype=torch.float32, device=dev)
    part = torch.empty((chunks, k, d), dtype=torch.float32, device=dev)
    part_k = torch.empty((chunks, 3, k), dtype=torch.float32, device=dev)
    sums = torch.empty((k, d), dtype=torch.float32, device=dev)
    counts = torch.empty((k,), dtype=torch.float32, device=dev)
    min_sim = torch.empty((k,), dtype=torch.float32, device=dev)
    sumsq = torch.empty((k,), dtype=torch.float32, device=dev)
    err = lib.assign_stats(
        x.data_ptr(), centers.data_ptr(), w.data_ptr(), n, d, k, chunks,
        idx.data_ptr(), best_sim.data_ptr(), rowsq.data_ptr(), part.data_ptr(),
        part_k.data_ptr(), sums.data_ptr(), counts.data_ptr(),
        min_sim.data_ptr(), sumsq.data_ptr(), _build.stream(x),
    )
    _build.check(err, "assign_stats")
    launches["assign_stats"] += 1
    return idx, best_sim, sums, counts, min_sim, sumsq


def slab_cones(
    centers: torch.Tensor, perm: torch.Tensor | None, slab: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The bounded kernel's view of the centers, in plain tensor code.

    Centers go in ``perm`` order (identity if None) into slabs of ``slab``
    slots, the last padded with zero rows whose id is -1. For each slab: its
    unit mean direction ``rep`` and the cone constants a_pos, a_neg, b_max
    (max and min member component along ``rep``, max norm of the rest), so
    that every member c satisfies x . c <= max(a_pos s, a_neg s) + b_max t
    with s = x . rep, t = sqrt(|x|^2 - s^2). An empty slab gets 0s.

    Returns (cp (ns * slab, d), perm_p (ns * slab,) int32, reps (ns, d),
    cone (3, ns)).
    """
    k, d = centers.shape
    dev = centers.device
    if perm is None:
        perm = torch.arange(k, dtype=torch.int32, device=dev)
    ns = -(-k // slab)
    cf = centers.float()
    cp = torch.zeros((ns * slab, d), dtype=torch.float32, device=dev)
    cp[:k] = cf[perm.long()]
    perm_p = torch.full((ns * slab,), -1, dtype=torch.int32, device=dev)
    perm_p[:k] = perm.to(torch.int32)
    c3 = cp.view(ns, slab, d)
    m3 = (perm_p >= 0).view(ns, slab)
    cnt = m3.sum(dim=1).float()
    mean = c3.sum(dim=1) / torch.clamp(cnt, min=1.0)[:, None]  # pad rows are 0
    mnorm = torch.linalg.vector_norm(mean, dim=1, keepdim=True)
    reps = mean / torch.clamp(mnorm, min=1e-12)
    a = torch.einsum("sbd,sd->sb", c3, reps)
    bperp = torch.sqrt(torch.clamp(torch.sum(c3 * c3, dim=2) - a * a, min=0.0))
    nonempty = cnt > 0
    a_pos = torch.where(m3, a, ref.NEG).amax(dim=1)
    a_neg = torch.where(m3, a, ref.BIG).amin(dim=1)
    b_max = torch.where(m3, bperp, 0.0).amax(dim=1)
    cone = torch.stack([
        torch.where(nonempty, v, 0.0) for v in (a_pos, a_neg, b_max)
    ])
    return cp, perm_p, reps.contiguous(), cone.contiguous()


def assign_stats_bounded_cuda(
    x: torch.Tensor,
    centers: torch.Tensor,
    prev_idx: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    drift: torch.Tensor,
    w: torch.Tensor | None = None,
    *,
    perm: torch.Tensor | None = None,
) -> tuple[torch.Tensor, ...]:
    """(n, d), (k, d) f32; carried (n,) prev_idx int32, lo, hi f32; (k,)
    drift[; (n,) w] -> (idx, best_sim, sums, counts, min_sim, sumsq, idx,
    lo_out, hi_out, pruned). Contract of ``ref.assign_stats_bounded``, except
    that hi_out of a row whose slab was skipped is that slab's cone bound: a
    valid upper bound, at least the plain version's exact second value.

    ``perm`` orders the centers into slabs (``ops.build_center_index``); it
    changes which slabs can be skipped, never a label.
    """
    from repro_torch.kernels import _build

    n, d = x.shape
    k = centers.shape[0]
    dev = x.device
    _check_k_d(k, d)
    w = _weights(w, n, dev)
    _build.require(x, "x", torch.float32, (n, d), dev)
    _build.require(centers, "centers", torch.float32, (k, d), dev)
    _build.require(w, "w", torch.float32, (n,), dev)
    for name, t, dtype in (("prev_idx", prev_idx, torch.int32), ("lo", lo, torch.float32),
                           ("hi", hi, torch.float32)):
        _build.require(t, name, dtype, (n,), dev)
    _build.require(drift, "drift", torch.float32, (k,), dev)
    lib = _lib("assign_stats_bounded")

    # row prep: which carried assignments the deflated bounds prove settled
    rownorm = torch.linalg.vector_norm(x, dim=1)
    ok, pidx, lo_adj, hi_adj = ref.deflate_bounds(prev_idx, lo, hi, rownorm, drift)
    pruned = ok & (lo_adj > hi_adj + ref.PRUNE_MARGIN)
    idx0 = torch.where(pruned, pidx, -1).to(torch.int32)
    cp, perm_p, reps, cone = slab_cones(centers, perm, lib.assign_stats_bounded_slab())
    ns = reps.shape[0]

    chunks = lib.assign_stats_bounded_chunks(n, k, d)
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    best_sim = torch.empty((n,), dtype=torch.float32, device=dev)
    sec = torch.empty((n,), dtype=torch.float32, device=dev)
    rowsq = torch.empty((n,), dtype=torch.float32, device=dev)
    part = torch.empty((chunks, k, d), dtype=torch.float32, device=dev)
    part_k = torch.empty((chunks, 3, k), dtype=torch.float32, device=dev)
    sums = torch.empty((k, d), dtype=torch.float32, device=dev)
    counts = torch.empty((k,), dtype=torch.float32, device=dev)
    min_sim = torch.empty((k,), dtype=torch.float32, device=dev)
    sumsq = torch.empty((k,), dtype=torch.float32, device=dev)
    err = lib.assign_stats_bounded(
        x.data_ptr(), centers.data_ptr(), cp.data_ptr(), perm_p.data_ptr(),
        reps.data_ptr(), cone.data_ptr(), idx0.data_ptr(), w.data_ptr(),
        n, d, k, ns, ref.PRUNE_MARGIN, chunks, idx.data_ptr(), best_sim.data_ptr(),
        sec.data_ptr(), rowsq.data_ptr(), part.data_ptr(), part_k.data_ptr(),
        sums.data_ptr(), counts.data_ptr(), min_sim.data_ptr(),
        sumsq.data_ptr(), _build.stream(x),
    )
    _build.check(err, "assign_stats_bounded")
    launches["assign_stats_bounded"] += 1
    hi_out = torch.where(pruned, hi_adj, sec)
    return idx, best_sim, sums, counts, min_sim, sumsq, idx, best_sim, hi_out, pruned
