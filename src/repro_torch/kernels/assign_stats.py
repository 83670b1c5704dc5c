"""Host wrappers of the CUDA kernels ``csrc/label_stats.cu`` (per-label
weighted sums and weight totals), ``csrc/assign_stats.cu`` (nearest center
plus per-cluster statistics) and ``csrc/assign_stats_bounded.cu`` (the same
pass pruned by carried bounds and by the slabs' cone bounds).

Counterpart of the JAX package's ``kernels/assign_stats.py``. ``launches``
counts, per kernel, the calls that launched it, ``bf16_launches`` those of
them on bf16 rows of x.

The three kernels take x in f32 or bf16 (``assign_stats_cuda`` and
``assign_stats_bounded_cuda`` bf16 x with f32 or bf16 centers): bf16 rows
are read as they are, with no f32 copy, and every output is f32.
``label_stats_cuda`` on bf16 rows has the bits of the f32 call on the
upcast rows. ``assign_stats_cuda`` on bf16 x runs its products on the
tensor cores (bf16 products exact, f32 sums in another order; f32 centers
go in as the three bf16 parts of ``split_bf16x3``): on integer-valued rows
every output equals the f32 call on the upcast inputs; on unit rows the
similarities are within 1e-5 of it, and wherever idx agrees the sums,
counts and sumsq keep its bits. ``assign_stats_bounded_cuda`` on bf16 x
computes every similarity it keeps by the same tensor-core products:
labels and statistics equal ``assign_stats_cuda``'s on the same inputs for
any bounds state, as in the f32 mode.

The three kernels fold through one partials buffer per device. A call holds
the device's lock (``_build.device_lock``) from taking the buffer to the
return of its C entry, which enqueues the fold and the reduce of the
partials: calls from several threads then enqueue their launches one call
after another, never a fold of one between the fold and the reduce of
another.
"""

from __future__ import annotations

import functools
from ctypes import c_float as F
from ctypes import c_int as I
from ctypes import c_void_p as P

import torch

from repro_torch.kernels import ref

launches = {"label_stats": 0, "assign_stats": 0, "assign_stats_bounded": 0}
bf16_launches = {"label_stats": 0, "assign_stats": 0, "assign_stats_bounded": 0}

# C entries: pointers and the stream as c_void_p, sizes as c_int
_SIGNATURES = {
    "label_stats": {
        "label_stats_chunks": [I, I, I],
        "label_stats_lists": [I, I, I],
        "label_stats": [P, I, P, P, I, I, I, I, P, P, P, P, P],
    },
    "assign_stats": {
        "assign_stats_chunks": [I, I, I],
        "assign_stats_lists": [I, I, I],
        "assign_stats_scratch": [I],
        "assign_stats_split_stride": [I],
        "assign_stats": [P, P, I, I, P, I, I, I, I] + [P] * 11,
    },
    "assign_stats_bounded": {
        "assign_stats_bounded_slab": [],
        "assign_stats_bounded_rep_chunk": [],
        "assign_stats_bounded_rows": [P, P, P, I, I, I, I, P, P, P, P, P, P],
        "assign_stats_bounded_chunks": [I, I, I],
        "assign_stats_bounded_lists": [I, I, I],
        "assign_stats_bounded": [P] * 10 + [I, I, P, I, I, I, I, F, I] + [P] * 11,
    },
}


def _count(name: str, x: torch.Tensor) -> None:
    from repro_torch.kernels import _build

    with _build.COUNT_LOCK:
        launches[name] += 1
        if x.dtype == torch.bfloat16:
            bf16_launches[name] += 1


def _lib(name: str):
    from repro_torch.kernels import _build

    return _build.library(name, _SIGNATURES[name])


def _weights(w: torch.Tensor | None, n: int, dev: torch.device) -> int | None:
    """The pointer the kernels take for ``w``: None (a null pointer, read as
    weight 1 by the kernels) when ``w`` is None."""
    from repro_torch.kernels import _build

    if w is None:
        return None
    _build.require(w, "w", torch.float32, (n,), dev)
    return w.data_ptr()


@functools.cache
def _chunks(name: str, n: int, k: int, d: int, device: int) -> int:
    """Row chunks of the fold, planned once per (n, k, d, card)."""
    with torch.cuda.device(device):
        return getattr(_lib(name), f"{name}_chunks")(n, k, d)


def partials_size(name: str, n: int, k: int, d: int, chunks: int, bf16: bool) -> int:
    """Floats of the fold's scratch: (chunks, k, d) sums and (chunks, 3, k)
    scalars, then, for bf16 x, from the next multiple of 32 floats, the
    lists of the bf16 route (``csrc/label_stats.cuh``, ``stats_lists_at``)."""
    size = chunks * k * (d + 3)
    if not bf16:
        return size
    return -(-size // 32) * 32 + getattr(_lib(name), f"{name}_lists")(n, k, chunks)


# per device: the stream it was last used on and the fold's partials buffer
_workspace: dict[int, tuple[int, torch.Tensor]] = {}


def _scratch(name: str, x: torch.Tensor, k: int, stream: int):
    """The fold's partials (``partials_size``) in one buffer per device.
    Returns (chunks, buf, part, part_k); the caller holds the device's lock
    and ``buf`` until its launch is enqueued.

    The buffer lives until a call on another stream, or a larger call,
    replaces it: calls on one stream run in order, so each reuses it. It is
    allocated on the stream of the call, and PyTorch's caching allocator
    hands a freed block out again only to that stream, so a fold enqueued
    there before it is replaced is safe."""
    n, d = x.shape
    dev = x.device
    chunks = _chunks(name, n, k, d, dev.index)
    size = partials_size(name, n, k, d, chunks, x.dtype == torch.bfloat16)
    held = _workspace.get(dev.index)
    if held is None or held[0] != stream or held[1].numel() < size:
        _workspace.pop(dev.index, None)
        held = (stream, torch.empty((size,), dtype=torch.float32, device=dev))
        _workspace[dev.index] = held
    part = held[1].data_ptr()
    return chunks, held[1], part, part + 4 * chunks * k * d


_ELEM_SPLIT3 = 2  # kElemSplit3 (csrc/tma.cuh): f32 centers as three bf16 parts


def split_stride(d: int) -> int:
    """Row stride (elements) of ``split_bf16x3``'s parts: d padded to a
    multiple of 8 (16-byte rows, which the copy engine takes) and to at
    least 64 (one ring stage's columns). ``csrc/assign_tile.cuh``'s
    ``split_stride`` is the same."""
    return 64 if d < 64 else -(-d // 8) * 8


def _truncate_bf16(v: torch.Tensor) -> torch.Tensor:
    """f32 values cut to their top 16 bits: bf16 values, rounded toward 0."""
    return torch.bitwise_and(v.view(torch.int32), -65536).view(torch.float32)


def split_bf16x3(centers: torch.Tensor) -> torch.Tensor:
    """(k, d) f32 -> (3, k, split_stride(d)) bf16 parts hi, mid, lo, zeros in
    the pad columns, with hi + mid + lo == c exactly for every finite c with
    |c| >= 2^-110 and for zeros (below 2^-110 lo loses the bits under
    bf16's smallest step, 2^-133). Each part takes the top 8 significant
    bits of what the ones before left (rounded toward 0, so the largest f32
    does not round up to inf and every part has c's sign): 8 + 8 + 8 of
    the 24. bf16 x times each part is exact in f32, so assign_stats' bf16
    mode multiplies by f32 centers on the tensor cores exactly. Plain tensor
    code on the centers only."""
    k, d = centers.shape
    c = centers.contiguous()
    hi = _truncate_bf16(c)
    rest = c - hi  # exact: c's low 16 significand bits
    mid = _truncate_bf16(rest)
    parts = torch.zeros((3, k, split_stride(d)), dtype=torch.bfloat16, device=c.device)
    for p, v in enumerate((hi, mid, rest - mid)):
        parts[p, :, :d] = v
    return parts


def center_operand(x: torch.Tensor, centers: torch.Tensor) -> tuple[torch.Tensor, int]:
    """The centers as the kernels' product tile takes them, and their
    element code: as they are, except f32 centers of bf16 x, which go in as
    ``split_bf16x3``'s parts (split once a call)."""
    from repro_torch.kernels import _build

    if x.dtype == torch.bfloat16 and centers.dtype == torch.float32:
        return split_bf16x3(centers), _ELEM_SPLIT3
    return centers, _build.ELEM[centers.dtype]


def _padded_bf16(t: torch.Tensor) -> torch.Tensor:
    """(rows, d) bf16 -> (rows, split_stride(d)): zeros in the pad columns
    (``t`` itself where there are none), the rows the bounded kernel gathers
    and boxes by 16-byte copies."""
    rows, d = t.shape
    if split_stride(d) == d:
        return t.contiguous()
    out = torch.zeros((rows, split_stride(d)), dtype=torch.bfloat16, device=t.device)
    out[:, :d] = t
    return out


def _check_k_d(k: int, d: int) -> None:
    if k < 1 or d < 1:
        raise ValueError(f"the kernels need k >= 1 and d >= 1, got k={k}, d={d}")


def label_stats_cuda(
    x: torch.Tensor, idx: torch.Tensor, k: int, w: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """(n, d) f32 or bf16, (n,) int32[, (n,) f32] -> ((k, d) f32 sums, (k,)
    weight totals). Contract of ``ref.label_stats``."""
    from repro_torch.kernels import _build

    n, d = x.shape
    dev = x.device
    _check_k_d(k, d)
    _build.require(x, "x", _build.ROWS, (n, d), dev)
    _build.require(idx, "idx", torch.int32, (n,), dev)
    wp = _weights(w, n, dev)
    lib = _lib("label_stats")
    stream = _build.stream(x)
    sums = torch.empty((k, d), dtype=torch.float32, device=dev)
    counts = torch.empty((k,), dtype=torch.float32, device=dev)
    with _build.device_lock(dev.index):
        chunks, buf, part, part_k = _scratch("label_stats", x, k, stream)
        err = lib.label_stats(
            x.data_ptr(), _build.ELEM[x.dtype], idx.data_ptr(), wp, n, d, k, chunks, part, part_k,
            sums.data_ptr(), counts.data_ptr(), stream,
        )
    _build.check(err, "label_stats")
    _count("label_stats", x)
    return sums, counts


def assign_stats_cuda(
    x: torch.Tensor, centers: torch.Tensor, w: torch.Tensor | None = None
) -> tuple[torch.Tensor, ...]:
    """(n, d) f32 and (k, d) f32, or (n, d) bf16 and (k, d) f32 or bf16[,
    (n,) f32] -> (idx, best_sim, sums, counts, min_sim, sumsq), all f32 but
    idx. Contract of ``ref.assign_stats``; bf16 x as the module says (f32
    centers are split by ``split_bf16x3`` once a call)."""
    from repro_torch.kernels import _build

    n, d = x.shape
    k = centers.shape[0]
    dev = x.device
    _check_k_d(k, d)
    _build.require(x, "x", _build.ROWS, (n, d), dev)
    _build.require(centers, "centers",
                   _build.ROWS if x.dtype == torch.bfloat16 else torch.float32, (k, d), dev)
    wp = _weights(w, n, dev)
    lib = _lib("assign_stats")
    stream = _build.stream(x)
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    best_sim = torch.empty((n,), dtype=torch.float32, device=dev)
    rowsq = torch.empty((n,), dtype=torch.float32, device=dev)
    sums = torch.empty((k, d), dtype=torch.float32, device=dev)
    counts = torch.empty((k,), dtype=torch.float32, device=dev)
    min_sim = torch.empty((k,), dtype=torch.float32, device=dev)
    sumsq = torch.empty((k,), dtype=torch.float32, device=dev)
    # the center tiles' winners, merged by launch 1's second kernel
    tile = torch.empty((n * lib.assign_stats_scratch(k),), dtype=torch.float32, device=dev)
    c, celem = center_operand(x, centers)
    with _build.device_lock(dev.index):
        chunks, buf, part, part_k = _scratch("assign_stats", x, k, stream)
        err = lib.assign_stats(
            x.data_ptr(), c.data_ptr(), _build.ELEM[x.dtype], celem,
            wp, n, d, k, chunks,
            idx.data_ptr(), best_sim.data_ptr(), rowsq.data_ptr(), part,
            part_k, tile.data_ptr() or None, sums.data_ptr(), counts.data_ptr(),
            min_sim.data_ptr(), sumsq.data_ptr(), stream,
        )
    _build.check(err, "assign_stats")
    _count("assign_stats", x)
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


def settled_rows(
    prev_idx: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, rownorm: torch.Tensor,
    drift: torch.Tensor, margin: float = ref.PRUNE_MARGIN,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The bounded pass's row prep, in plain tensor code: which carried
    assignments the deflated bounds prove settled (lo' > hi' + margin),
    given the rows' f32 norms. Returns ((n,) int32 idx0, the carried
    center of a settled row and -1 for an active one; the (n,) bool pruned
    mask; the deflated hi)."""
    ok, pidx, lo_adj, hi_adj = ref.deflate_bounds(prev_idx, lo, hi, rownorm, drift)
    pruned = ok & (lo_adj > hi_adj + margin)
    return torch.where(pruned, pidx, -1).to(torch.int32), pruned, hi_adj


def active_rows(idx0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The rows a bounded pass must search (``idx0 < 0``), listed for the
    bf16 walk without a host read: a cumsum places each active row, a
    scatter writes it there. Returns ((n,) int32 rows whose first ``count``
    entries are the active rows in ascending order, the settled ones after
    them; (1,) int64 ``count``), both on idx0's device."""
    n = idx0.shape[0]
    dev = idx0.device
    active = idx0 < 0
    pos = torch.cumsum(active, 0)  # an active row's place in the list, from 1
    count = pos[-1:] if n else torch.zeros((1,), dtype=torch.int64, device=dev)
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    # a settled row goes after the list, in order: every place written once
    dest = torch.where(active, pos - 1, count + ids - pos)
    rows = torch.empty((n,), dtype=torch.int32, device=dev)
    rows.scatter_(0, dest, ids)
    return rows, count


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
    blocks: torch.Tensor | None = None,
    margin: float = ref.PRUNE_MARGIN,
) -> tuple[torch.Tensor, ...]:
    """(n, d), (k, d) f32, or (n, d) bf16 and (k, d) bf16 or f32; carried
    (n,) prev_idx int32, lo, hi f32; (k,) drift[; (n,) w] -> (idx, best_sim,
    sums, counts, min_sim, sumsq, idx, lo_out, hi_out, pruned). Contract of
    ``ref.assign_stats_bounded``, except that hi_out of a row whose slab was
    skipped is that slab's cone bound: a valid upper bound, at least the
    plain version's exact second value. bf16 x as the module says.

    ``perm`` orders the centers into slabs (``ops.build_center_index``); it
    changes which slabs can be skipped, never a label. ``blocks``, a zeroed
    (2, ceil(n / 128)) int32 tensor on x's device, takes on bf16 x a 1 for
    each block of launch 1 that worked: row 0 the row pass's (the 128-row
    blocks holding a row with a carried center), row 1 the walk's (one a
    128 active rows, in list order). ``margin`` is the plain version's: a
    row prunes when lo' > hi' + margin, and a slab is swept for a row when
    its cone bound reaches the row's best - margin.
    """
    from repro_torch.kernels import _build

    n, d = x.shape
    k = centers.shape[0]
    dev = x.device
    _check_k_d(k, d)
    _build.require(x, "x", _build.ROWS, (n, d), dev)
    _build.require(centers, "centers",
                   _build.ROWS if x.dtype == torch.bfloat16 else torch.float32, (k, d), dev)
    wp = _weights(w, n, dev)
    for name, t, dtype in (("prev_idx", prev_idx, torch.int32), ("lo", lo, torch.float32),
                           ("hi", hi, torch.float32)):
        _build.require(t, name, dtype, (n,), dev)
    _build.require(drift, "drift", torch.float32, (k,), dev)
    if blocks is not None:
        _build.require(blocks, "blocks", torch.int32, (2, -(-n // 128)), dev)
    lib = _lib("assign_stats_bounded")

    cp, perm_p, reps, cone = slab_cones(centers, perm, lib.assign_stats_bounded_slab())
    ns = reps.shape[0]
    stream = _build.stream(x)
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    best_sim = torch.empty((n,), dtype=torch.float32, device=dev)
    sec = torch.empty((n,), dtype=torch.float32, device=dev)
    sums = torch.empty((k, d), dtype=torch.float32, device=dev)
    counts = torch.empty((k,), dtype=torch.float32, device=dev)
    min_sim = torch.empty((k,), dtype=torch.float32, device=dev)
    sumsq = torch.empty((k,), dtype=torch.float32, device=dev)
    work = None if blocks is None else blocks.data_ptr()
    cg, celem = centers, _build.ELEM[torch.float32]
    listed = count = None
    if x.dtype == torch.float32:
        rowsq = torch.empty((n,), dtype=torch.float32, device=dev)
        rownorm = torch.linalg.vector_norm(x, dim=1)
    else:
        # the tensor cores' operands, rows padded to split_stride(d): the
        # carried centers and the permuted ones as they are (bf16) or split
        # (f32), the slab directions split, padded to the chunk of directions
        rc = lib.assign_stats_bounded_rep_chunk()
        reps_p = torch.zeros((-(-ns // rc) * rc, d), dtype=torch.float32, device=dev)
        reps_p[:ns] = reps
        reps = split_bf16x3(reps_p)
        if centers.dtype == torch.bfloat16:
            cg, cp = _padded_bf16(centers), _padded_bf16(cp.bfloat16())
            celem = _build.ELEM[torch.bfloat16]
        else:
            cg, cp, celem = split_bf16x3(centers), split_bf16x3(cp), _ELEM_SPLIT3
        # launch 1a: every carried row's similarity to its center, and the
        # norms (f32 fmaf chains over the bf16 rows) the deflation reads
        rowsq = torch.zeros((n,), dtype=torch.float32, device=dev)
        err = lib.assign_stats_bounded_rows(
            x.data_ptr(), cg.data_ptr(), prev_idx.data_ptr(), celem, n, d, k, idx.data_ptr(),
            best_sim.data_ptr(), sec.data_ptr(), rowsq.data_ptr(), work, stream,
        )
        _build.check(err, "assign_stats_bounded")
        rownorm = torch.sqrt(rowsq)
    idx0, pruned, hi_adj = settled_rows(prev_idx, lo, hi, rownorm, drift, margin)
    if x.dtype == torch.bfloat16:
        listed, count = active_rows(idx0)
    with _build.device_lock(dev.index):
        chunks, buf, part, part_k = _scratch("assign_stats_bounded", x, k, stream)
        err = lib.assign_stats_bounded(
            x.data_ptr(), cg.data_ptr(), cp.data_ptr(), perm_p.data_ptr(),
            reps.data_ptr(), cone.data_ptr(), idx0.data_ptr(),
            None if listed is None else listed.data_ptr(),
            None if count is None else count.data_ptr(), work, _build.ELEM[x.dtype], celem, wp,
            n, d, k, ns, margin, chunks, idx.data_ptr(), best_sim.data_ptr(),
            sec.data_ptr(), rowsq.data_ptr(), part, part_k,
            sums.data_ptr(), counts.data_ptr(), min_sim.data_ptr(),
            sumsq.data_ptr(), stream,
        )
    _build.check(err, "assign_stats_bounded")
    _count("assign_stats_bounded", x)
    hi_out = torch.where(pruned, hi_adj, sec)
    return idx, best_sim, sums, counts, min_sim, sumsq, idx, best_sim, hi_out, pruned
