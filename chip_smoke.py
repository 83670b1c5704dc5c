#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU and check it.

Run from the repository root, with no arguments:  python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:
  1. Device: the card's name and power limit; build the CUDA kernels from
     src/repro_torch/kernels/csrc with nvcc (one process per source).
  2. Kernel parity: each kernel against its plain PyTorch version on the same
     CUDA tensors, at the main paths' shapes and on integer-valued edge cases
     (ties across tiles, pad labels, weight-0 rows, empty clusters, sizes off
     the tiles; for the bounded pass also duplicate centers visited out of id
     order, sentinel, carried and invalidated bounds; for component_best_edge
     f32.min rows, row-id ties on either side, ids -1 and c, c > r, -0.0
     against +0.0, r = 0); each kernel runs twice and must repeat its bits.
     component_best_edge's main-path shapes are held in phase 4.
  3. Timing (CUDA events): kernel, plain version, one library call, and the
     card's lower bound for the same work (component_best_edge's in phase 4,
     on round 1's candidates: r = 3,536, c = 1,768).
  4. Paths at full size on the ~1 GB collection (n = 250,000, d = 2,048,
     50 topics), each with its launch counters set to 0 just before and read
     just after: tf-idf on the card, Buckshot with k = 50 (s = 3,536) and the
     K-Means baseline; then BKC with k = 400, BigK = 800 through the
     bound-pruned pass, its fused and two-pass routes, bounded against
     unbounded K-Means at k = 400, bounded Buckshot, and assign_batch in
     64-row micro-batches; then distributed Buckshot (k = 50, s = 3,536)
     through the multi-device engine over a NCCL group of world size 1 made
     from a FileStore: the distributed sample (s distinct real rows, equal to
     x at their ids), the sharded Borůvka phase 1 and distributed K-Means,
     held against the resident fit from the same ids (K-Means labels equal,
     RSS within 1e-5 relative); the sharded sweep, sweep="bcast" and
     merge="point" against the resident phase 1 (expanded MST edges bit for
     bit, labels and initial centers equal); and, every round of one run,
     component_best_edge on the job's candidates against both plain versions
     bit for bit, and three row blocks of the sample folded on the one card,
     merged in two orders, against the world-size-1 reduce.
  5. End-to-end oracles at the 20 Newsgroups shape: Buckshot (k = 20) and BKC
     (Table 1: k = 50, BigK = 250) on the card against the plain path on the
     CPU, on the same draws; BKC also on that collection with 5 % off-topic
     documents added, where joinToGroups bisects over real pair values
     (threshold above 1e-3, pair values on both sides of it; thresholds of
     card and CPU within 1e-5, groups equal but at a near-tie).
  6. Summary: a {"kernels": [...]} line, then {"ok": true, "device": ...} last.

Tolerances. Integer-valued inputs make every product and sum exact in f32, so
there the kernels must equal the plain versions bit for bit (the bounded
pass's hi excepted: where a slab was skipped it is the slab's cone bound, an
upper bound on the exact second value). On real tf-idf rows the kernels add
in another order than the plain versions, so: similarities within 1e-5
absolute; sums, weight totals and squared norms within 1e-4 relative + 1e-5
absolute (non-negative sums of up to ~10^4 terms); an index may differ only at
a near-tie, where the plain similarity of the kernel's pick is within 1e-5 of
the plain best (such rows are counted and printed); a pruned mask only where
the deflated bounds clear the margin by less than 1e-5. Kernels that compute
similarities by the same fmaf chain (assign_stats, assign_argmax,
assign_stats_bounded) must agree with each other bit for bit. End to end:
assignment agreement >= 99.9% and RSS within 1e-4 relative, for the same
reason.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

K = 50  # clusters on the main path
SEED = 21  # the 1 GB shape's own seed
BKC_K, BIG_K = 400, 800  # Table 4's BKC width (k = 400, BigK = 2k)
BATCH = 64  # the online service's max_batch
SIM_TOL = 1e-5
SUM_RTOL, SUM_ATOL = 1e-4, 1e-5
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 without tensor cores (data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 (data sheet)


def log(msg: str) -> None:
    print(msg, flush=True)


def sync_time(fn, *args, **kwargs):
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def event_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


# ------------------------------------------------------------------ checks


def check_equal(name, got, want):
    import torch

    for i, (g, w) in enumerate(zip(got, want)):
        if not torch.equal(g, w):
            bad = (g != w).sum().item()
            raise AssertionError(f"{name}: output {i} differs in {bad} entries")


def check_repeat(name, a, b):
    import torch

    for i, (x, y) in enumerate(zip(a, b)):
        if not torch.equal(x, y):
            raise AssertionError(f"{name}: output {i} is not bit-identical on a repeat run")


def check_close(name, got, want, rtol, atol) -> float:
    err = (got.double() - want.double()).abs()
    excess = err - (atol + rtol * want.double().abs())
    if excess.max().item() > 0:
        raise AssertionError(f"{name}: max abs err {err.max().item()} beyond rtol={rtol} atol={atol}")
    return err.max().item()


def check_argmax(name, got_idx, got_val, want_idx, want_val, plain_at) -> int:
    """Indices equal except at near-ties; returns the near-tie count."""
    diff = got_idx != want_idx
    n_diff = int(diff.sum())
    if n_diff:
        rows = diff.nonzero().flatten()
        gap = (want_val[rows] - plain_at(rows, got_idx[rows].long())).abs()
        if gap.max().item() > SIM_TOL:
            raise AssertionError(f"{name}: {n_diff} indices differ, not at near-ties")
    return n_diff


# ------------------------------------------------------------------ phases


def phase_device():
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    t = time.perf_counter()
    _build.build()
    log(f"phase 1 device: built {', '.join(_build.SOURCES)} in {time.perf_counter() - t:.1f} s")
    return smi


def phase_parity_edges(dev):
    """Integer-valued edge cases: exact agreement and repeat bits."""
    import numpy as np
    import torch

    from repro_torch import interop
    from repro_torch.kernels import ref
    from repro_torch.kernels.assign_stats import assign_stats_cuda, label_stats_cuda
    from repro_torch.kernels.sim_best_edge import sim_best_edge_cuda

    rng = np.random.default_rng(0)

    def ints(shape, lo, hi):
        return interop.data(rng.integers(lo, hi + 1, size=shape), dev)

    for r, c, d in [(300, 270, 70), (1, 129, 16), (257, 3, 2049)]:
        xr, xc = ints((r, d), -3, 3), ints((c, d), -3, 3)
        if c > 128:
            xc[c - 1] = xc[0]  # a tie across column tiles
        lr = interop.labels(rng.integers(-1, 5, size=r), dev)  # -1 = pad
        lc = interop.labels(rng.integers(-1, 5, size=c), dev)
        a, b = sim_best_edge_cuda(xr, xc, lr, lc), sim_best_edge_cuda(xr, xc, lr, lc)
        check_repeat("sim_best_edge", a, b)
        check_equal(f"sim_best_edge {r}x{c}x{d}", a, ref.sim_best_edge(xr, xc, lr, lc))
    for n, d, k in [(1000, 200, 70), (37, 5, 3), (0, 8, 4)]:
        x = ints((n, d), -8, 8)
        idx = interop.labels(rng.integers(-2, k + 2, size=n), dev)  # out of range too
        w = ints((n,), 0, 2)  # weight-0 rows
        a, b = label_stats_cuda(x, idx, k, w), label_stats_cuda(x, idx, k, w)
        check_repeat("label_stats", a, b)
        check_equal(f"label_stats {n}x{d} k={k}", a, ref.label_stats(x, idx, k, w))
    for n, d, k in [(1000, 130, 70), (300, 16, 5), (0, 4, 2)]:
        x, centers = ints((n, d), -4, 4), ints((k, d), -4, 4)
        centers[k - 1] = centers[0]  # loses every tie: an empty cluster
        if k > 64:
            centers[65] = centers[1]  # a tie across center tiles
        w = ints((n,), 0, 2)
        a, b = assign_stats_cuda(x, centers, w), assign_stats_cuda(x, centers, w)
        check_repeat("assign_stats", a, b)
        check_equal(f"assign_stats {n}x{d} k={k}", a, ref.assign_stats(x, centers, w))
        if n and not (a[3][k - 1] == 0 and a[4][k - 1] == ref.BIG):
            raise AssertionError("assign_stats: an empty cluster must have count 0, min_sim BIG")
    log("phase 2 parity: integer edge cases exact, repeats bit-identical")


def phase_parity_main(x, xs, dev):
    """The three kernels at the main path's shapes on real tf-idf rows."""
    import torch

    from repro_torch.common import segment_min, segment_sum
    from repro_torch.kernels import ref
    from repro_torch.kernels.assign_stats import assign_stats_cuda, label_stats_cuda
    from repro_torch.kernels.sim_best_edge import sim_best_edge_cuda

    g = torch.Generator().manual_seed(1)
    s = xs.shape[0]
    errs, ties = {}, {}

    # sim_best_edge: round 1 (every point its own component) and a later
    # round (components of several points, some pad rows)
    comp = torch.randint(0, s // 7, (s,), generator=g, dtype=torch.int32)
    comp[torch.randperm(s, generator=g)[:40]] = -1
    err, n_tie = 0.0, 0
    for labels in (torch.arange(s, dtype=torch.int32), comp):
        labels = labels.to(dev)
        a = sim_best_edge_cuda(xs, xs, labels, labels)
        check_repeat("sim_best_edge", a, sim_best_edge_cuda(xs, xs, labels, labels))
        want = ref.sim_best_edge(xs, xs, labels, labels)
        n_tie += check_argmax(
            "sim_best_edge", a[0], a[1], want[0], want[1],
            lambda rows, cols: (xs[rows] * xs[cols]).sum(1),
        )
        err = max(err, check_close("sim_best_edge best_s", a[1], want[1], 0.0, SIM_TOL))
    errs["sim_best_edge"], ties["sim_best_edge"] = err, n_tie

    idx = torch.randint(-1, K + 1, (s,), generator=g, dtype=torch.int32).to(dev)
    w = torch.randint(0, 2, (s,), generator=g).float().to(dev)
    a = label_stats_cuda(xs, idx, K, w)
    check_repeat("label_stats", a, label_stats_cuda(xs, idx, K, w))
    want = ref.label_stats_scatter(xs, idx, K, w)
    errs["label_stats"] = max(
        check_close(f"label_stats {n}", got, ref_t, SUM_RTOL, SUM_ATOL)
        for n, got, ref_t in zip(("sums", "counts"), a, want)
    )

    n = x.shape[0]
    centers = xs[:K].contiguous()
    w = torch.ones((n,), device=dev)
    w[torch.randperm(n, generator=g)[:1000].to(dev)] = 0.0
    a = assign_stats_cuda(x, centers, w)
    check_repeat("assign_stats", a, assign_stats_cuda(x, centers, w))
    want = ref.assign_stats_scatter(x, centers, w)
    ties["assign_stats"] = check_argmax(
        "assign_stats", a[0], a[1], want[0], want[1],
        lambda rows, cols: (x[rows] * centers[cols]).sum(1),
    )
    err = check_close("assign_stats best_sim", a[1], want[1], 0.0, SIM_TOL)
    # the statistics are held against the plain fold over the kernel's own
    # assignment, so a near-tie row cannot move a sum across clusters
    idx_k, sim_k = a[0], a[1]
    xf = x * w[:, None]
    plain = (
        segment_sum(xf, idx_k, K),
        segment_sum(w, idx_k, K),
        torch.where(segment_sum(w, idx_k, K) > 0,
                    segment_min(torch.where(w > 0, sim_k, ref.BIG), idx_k, K), ref.BIG),
        segment_sum((x * x).sum(1) * w, idx_k, K),
    )
    del xf
    for name, got, ref_t, tol in zip(
        ("sums", "counts", "min_sim", "sumsq"), a[2:], plain,
        ((SUM_RTOL, SUM_ATOL), (SUM_RTOL, SUM_ATOL), (0.0, SIM_TOL), (SUM_RTOL, SUM_ATOL)),
    ):
        err = max(err, check_close(f"assign_stats {name}", got, ref_t, *tol))
    errs["assign_stats"] = err
    log(f"phase 2 parity: main-path shapes within tolerance; max abs err {errs}; "
        f"near-tie index differences {ties}")
    return errs


def phase_timing(x, xs, dev):
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.assign_stats import assign_stats_cuda, label_stats_cuda
    from repro_torch.kernels.sim_best_edge import sim_best_edge_cuda

    s, d = xs.shape
    n = x.shape[0]
    g = torch.Generator().manual_seed(2)
    ids = torch.arange(s, dtype=torch.int32, device=dev)
    labels = torch.randint(0, K, (s,), generator=g, dtype=torch.int32).to(dev)
    centers = xs[:K].contiguous()
    f4 = 4
    rows = {}

    flops = 2.0 * s * s * d
    nbytes = 2 * s * d * f4 + 2 * s * f4 + s * 8
    rows["sim_best_edge"] = dict(
        ms=event_ms(lambda: sim_best_edge_cuda(xs, xs, ids, ids), 20),
        plain_ms=event_ms(lambda: ref.sim_best_edge(xs, xs, ids, ids), 20),
        library_ms=event_ms(lambda: xs @ xs.T, 20),
        bound=bound_ms(flops, nbytes),
    )
    flops = 2.0 * s * d
    nbytes = s * d * f4 + s * f4 + K * d * f4 + K * f4
    lib_idx = labels.long()
    rows["label_stats"] = dict(
        ms=event_ms(lambda: label_stats_cuda(xs, labels, K), 50),
        plain_ms=event_ms(lambda: ref.label_stats_scatter(xs, labels, K), 50),
        library_ms=event_ms(
            lambda: torch.zeros((K, d), device=dev).index_add_(0, lib_idx, xs), 50),
        bound=bound_ms(flops, nbytes),
    )
    flops = 2.0 * n * K * d + 4.0 * n * d
    nbytes = n * d * f4 + K * d * f4 + n * f4 + n * 8 + K * d * f4 + 3 * K * f4
    rows["assign_stats"] = dict(
        ms=event_ms(lambda: assign_stats_cuda(x, centers), 10),
        plain_ms=event_ms(lambda: ref.assign_stats_scatter(x, centers), 10),
        library_ms=event_ms(lambda: x @ centers.T, 10),
        bound=bound_ms(flops, nbytes),
    )
    # assign_stats = the assignment tile + label_stats' fold with two extra
    # scalars; the fold alone at n = 250,000 splits its time between the two
    assigned = assign_stats_cuda(x, centers)[0]
    fold_ms = event_ms(lambda: label_stats_cuda(x, assigned, K), 10)
    log(f"phase 3 timing label_stats at n={n} (the fold inside assign_stats): {fold_ms:.4f} ms")
    for name, r in rows.items():
        log(f"phase 3 timing {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms ({r['bound'][1]})")
    return rows


def phase_main_path(corpus, dev):
    import torch

    from repro_torch.core import metrics
    from repro_torch.core.buckshot import buckshot, buckshot_phase1
    from repro_torch.core.kmeans import kmeans, kmeans_fit
    from repro_torch.kernels import ops
    from repro_torch.text import pipeline

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    (x, truth), t_prep = sync_time(pipeline.prepare_local, corpus, dev)
    res, t_buck = sync_time(buckshot, x, K, torch.Generator().manual_seed(SEED))
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n, d = x.shape
    truth_t = torch.from_numpy(truth).to(dev)
    km = res.kmeans
    check_result("buckshot", km, n, d)
    quality = dict(
        rss=km.rss.item(),
        purity=metrics.purity(km.assignment, truth_t, K, corpus.n_topics).item(),
        nmi=metrics.nmi(km.assignment, truth_t, K, corpus.n_topics).item(),
    )
    rounds = counts["sim_best_edge"]
    log(f"phase 4 main path: n={n} d={d} k={K} s={res.sample_idx.shape[0]}; "
        f"x {x.numel() * 4 / 2**30:.2f} GiB; prepare_local {t_prep:.3f} s, "
        f"buckshot {t_buck:.3f} s ({rounds} Borůvka rounds, {km.iterations} K-Means "
        f"iterations); launches {counts}; peak device memory {peak / 2**30:.2f} GiB; "
        f"quality {quality}")
    # one Borůvka round per sim_best_edge launch; one assign_stats launch
    # per K-Means iteration plus the final assignment
    if not (counts["sim_best_edge"] >= 1 and counts["label_stats"] >= 1
            and counts["assign_stats"] == km.iterations + 1):
        raise AssertionError(f"the main path did not go through every kernel: {counts}")

    _, t_p1 = sync_time(buckshot_phase1, x, res.sample_idx, K)
    _, t_p2 = sync_time(lambda: kmeans_fit(x, res.init_centers, K, max_iters=3, tol=0.0))
    log(f"phase 4 buckshot phases (separate runs): phase 1 {t_p1:.3f} s, phase 2 {t_p2:.3f} s")
    profile_buckshot(x, res.sample_idx)

    ops.reset_launch_counts()
    base, t_km = sync_time(kmeans, x, K, torch.Generator().manual_seed(SEED))
    km_counts = ops.launch_counts()
    check_result("kmeans", base, n, d)
    log(f"phase 4 kmeans baseline: {t_km:.3f} s, {base.iterations} iterations, "
        f"rss {base.rss.item()}, purity "
        f"{metrics.purity(base.assignment, truth_t, K, corpus.n_topics).item()}, launches {km_counts}")
    if km_counts["assign_stats"] != base.iterations + 1:
        raise AssertionError(f"kmeans did not go through assign_stats: {km_counts}")
    return counts, km.assignment, x, truth


def profile_buckshot(x, sample_idx):
    from repro_torch.core.buckshot import buckshot_fit

    profile_run("buckshot_fit", buckshot_fit, x, sample_idx, K)


def profile_run(label, fn, *args, **kwargs):
    """One warm call under torch.profiler: the device's busy share of the
    wall time and the device ops that took the most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = sync_time(lambda: fn(*args, **kwargs))
    # device-side events only (kernels, copies): the ATen rows repeat their
    # kernels' time. One stream, so the events do not overlap.
    rows = sorted(
        ((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        reverse=True,
    )
    busy = sum(r[0] for r in rows) / 1e6
    if not rows:
        log(f"phase 4 profile {label}: the profiler recorded no device time (not measured)")
        return
    top = "; ".join(f"{key[:60]} x{cnt} {us / 1e3:.3f} ms" for us, cnt, key in rows[:8])
    log(f"phase 4 profile (warm {label}, profiled): wall {wall:.4f} s, device busy "
        f"{busy:.4f} s ({100 * busy / wall:.1f}%); top device ops: {top}")


def check_result(name, km, n, d, k=None):
    import torch

    k = K if k is None else k
    a = km.assignment
    if a.shape != (n,) or int(a.min()) < 0 or int(a.max()) >= k:
        raise AssertionError(f"{name}: assignment out of shape or range")
    if km.centers.shape != (k, d) or not torch.isfinite(km.centers).all():
        raise AssertionError(f"{name}: centers not finite or of the wrong shape")
    norms = km.centers.norm(dim=1)
    if not (((norms - 1).abs() < 1e-4) | (norms == 0)).all():
        raise AssertionError(f"{name}: centers are not unit-norm")
    for v in (km.rss, km.objective):
        if not torch.isfinite(v) or v.item() < 0:
            raise AssertionError(f"{name}: rss/objective not finite and non-negative")


def phase_oracle(dev):
    import torch

    from repro_torch.core import sampling
    from repro_torch.core.buckshot import buckshot_fit
    from repro_torch.text import pipeline, synth

    shape = synth.paper_20ng_shape()
    corpus = synth.make_corpus(**shape)
    x_cpu, _ = pipeline.prepare_local(corpus, device="cpu")
    k = shape["n_topics"]
    n = x_cpu.shape[0]
    s = sampling.buckshot_sample_size(n, k)
    sidx = sampling.sample_indices(n, s, torch.Generator().manual_seed(0), device="cpu")
    want = buckshot_fit(x_cpu, sidx, k)
    got = buckshot_fit(x_cpu.to(dev), sidx.to(dev), k)
    agree = (got.kmeans.assignment.cpu() == want.kmeans.assignment).double().mean().item()
    rel = abs(got.kmeans.rss.item() - want.kmeans.rss.item()) / abs(want.kmeans.rss.item())
    log(f"phase 5 oracle at n={n} k={k} s={s}: assignment agreement {agree}, "
        f"RSS card {got.kmeans.rss.item()} vs CPU {want.kmeans.rss.item()} (rel {rel:.2e})")
    if agree < 0.999 or rel > 1e-4:
        raise AssertionError("the card's Buckshot disagrees with the plain CPU path")


# ------------------------------------------------------------ the BKC slice


def _sentinel(n, dev):
    from repro_torch.kernels import ops

    return ops.bounds_identity(n, dev)


def check_bounded_hi(name, hi, exact, rows=None) -> None:
    """hi is an upper bound on the exact second value (the cone bound of a
    skipped slab, or the kernel's own second value, which may differ from
    the plain one by rounding)."""
    if rows is not None:
        hi, exact = hi[rows], exact[rows]
    slack = SIM_TOL * (1 + exact.abs())
    if not (hi >= exact - slack).all():
        raise AssertionError(f"{name}: hi is below the exact second value")


def plain_stats(x, idx, sim, k, w=None):
    """(sums, counts, min_sim, sumsq) of the rows under the given labels, by
    plain segment reductions."""
    import torch

    from repro_torch.common import segment_min, segment_sum
    from repro_torch.kernels import ref

    if w is None:
        w = torch.ones((x.shape[0],), device=x.device)
    counts = segment_sum(w, idx, k)
    return (
        segment_sum(x * w[:, None], idx, k),
        counts,
        torch.where(counts > 0, segment_min(torch.where(w > 0, sim, ref.BIG), idx, k), ref.BIG),
        segment_sum((x * x).sum(1) * w, idx, k),
    )


def bounded_bytes(n, k, d, f4=4):
    """Bytes the bounded pass must move: x, centers, the carried bounds, w
    and drift in; labels, similarities, the refreshed bounds, the pruned
    mask and the statistics out."""
    return (n * d * f4 + k * d * f4 + 4 * n * f4 + k * f4
            + 5 * n * f4 + n + k * d * f4 + 3 * k * f4)


def phase_parity_edges_bkc(dev):
    """Integer-valued edge cases of assign_argmax and assign_stats_bounded:
    exact agreement (hi: an upper bound, exact where the centers fit one slab
    or the row was pruned) and repeat bits."""
    import numpy as np
    import torch

    from repro_torch import interop
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.assign_argmax import assign_argmax_cuda
    from repro_torch.kernels.assign_stats import assign_stats_bounded_cuda, assign_stats_cuda

    rng = np.random.default_rng(1)
    for n, d, k in [(1000, 130, 70), (300, 16, 5), (0, 4, 2)]:
        x = interop.data(rng.integers(-4, 5, size=(n, d)), dev)
        centers = interop.data(rng.integers(-4, 5, size=(k, d)), dev)
        if k > 64:
            centers[65] = centers[1]  # a tie across center tiles
        a = assign_argmax_cuda(x, centers)
        check_repeat("assign_argmax", a, assign_argmax_cuda(x, centers))
        check_equal(f"assign_argmax {n}x{d} k={k}", a, ref.assign_argmax(x, centers))

    def run(name, args, perm, k):
        got = assign_stats_bounded_cuda(*args, perm=perm)
        check_repeat(name, got, assign_stats_bounded_cuda(*args, perm=perm))
        want = ref.assign_stats_bounded(*args)
        check_equal(name, got[:8] + got[9:], want[:8] + want[9:])
        check_bounded_hi(name, got[8], want[8])
        exact = got[9] if k > 64 else torch.ones_like(got[9])  # pruned rows, or one slab
        if not torch.equal(got[8][exact], want[8][exact]):
            raise AssertionError(f"{name}: hi differs where it must be exact")
        return got, want

    for n, d, k in [(1000, 130, 70), (300, 16, 5), (257, 40, 130), (0, 8, 3)]:
        centers_i = rng.integers(-4, 5, size=(k, d))
        rows = centers_i[rng.integers(0, k, size=n)] + rng.integers(-1, 2, size=(n, d))
        x = interop.data(rows, dev)
        centers = interop.data(centers_i, dev)
        centers[k - 1] = centers[0]  # loses every tie to center 0: an empty cluster
        if k > 9:
            centers[9] = centers[3]  # a duplicate visited before its twin when reversed
        w = interop.data(rng.integers(0, 3, size=n), dev)  # weight-0 rows
        for order in ("identity", "reversed", "index"):
            perm = {
                "identity": None,
                "reversed": torch.arange(k - 1, -1, -1, dtype=torch.int32, device=dev),
                "index": ops.build_center_index(centers).perm,
            }[order]
            name = f"assign_stats_bounded {n}x{d} k={k} {order}"
            b = _sentinel(n, dev)
            _, want = run(name + " sentinel", (x, centers, b.idx, b.lo, b.hi,
                                               torch.zeros(k, device=dev), w), perm, k)
            moved = centers.clone()
            moved[0, 0] += 1
            moved[k // 2, d - 1] -= 1
            drift = torch.linalg.vector_norm(moved - centers, dim=1)
            stale = torch.zeros(n, dtype=torch.bool, device=dev)
            stale[::5] = True
            b = ops.bounds_invalidate(ops.Bounds(*want[6:9]), stale)
            got, want = run(name + " carried", (x, moved, b.idx, b.lo, b.hi, drift, w), perm, k)
            if n and not (want[9].any() and not want[9][stale].any()):
                raise AssertionError(f"{name}: carried bounds must prune, "
                                     "invalidated rows must not")
            check_equal(name + " vs assign_stats", got[:6], assign_stats_cuda(x, moved, w))
    log("phase 2 parity: assign_argmax and assign_stats_bounded integer edge cases exact, "
        "repeats bit-identical")


def phase_parity_main_bkc(x, dev):
    """The two new kernels on real tf-idf rows at n = 250,000."""
    import torch

    from repro_torch.common import l2_normalize
    from repro_torch.core import sampling
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.assign_argmax import assign_argmax_cuda
    from repro_torch.kernels.assign_stats import assign_stats_bounded_cuda, assign_stats_cuda

    n = x.shape[0]
    g = torch.Generator().manual_seed(3)
    pick = sampling.sample_indices(n, BIG_K, g, dev)
    c800 = l2_normalize(x[pick]).contiguous()
    c400 = c800[:BKC_K].contiguous()
    errs, ties = {}, {}

    a = assign_argmax_cuda(x, c400)
    check_repeat("assign_argmax", a, assign_argmax_cuda(x, c400))
    want = ref.assign_argmax(x, c400)
    ties["assign_argmax"] = check_argmax(
        "assign_argmax", a[0], a[1], want[0], want[1],
        lambda rows, cols: (x[rows] * c400[cols]).sum(1),
    )
    errs["assign_argmax"] = check_close("assign_argmax best_sim", a[1], want[1], 0.0, SIM_TOL)
    del want

    # sentinel bounds at BigK through a center index: the same labels and
    # statistics as assign_stats, bit for bit; the plain version within the
    # stated tolerances
    index = ops.build_center_index(c800)
    b = _sentinel(n, dev)
    zero = torch.zeros(BIG_K, device=dev)
    got = assign_stats_bounded_cuda(x, c800, b.idx, b.lo, b.hi, zero, perm=index.perm)
    check_repeat("assign_stats_bounded",
                 got, assign_stats_bounded_cuda(x, c800, b.idx, b.lo, b.hi, zero, perm=index.perm))
    check_equal("assign_stats_bounded vs assign_stats", got[:6], assign_stats_cuda(x, c800))
    want = ref.assign_stats_bounded_scatter(x, c800, b.idx, b.lo, b.hi, zero)
    ties["assign_stats_bounded"] = check_argmax(
        "assign_stats_bounded", got[0], got[1], want[0], want[1],
        lambda rows, cols: (x[rows] * c800[cols]).sum(1),
    )
    err = check_close("assign_stats_bounded best_sim", got[1], want[1], 0.0, SIM_TOL)
    same = got[0] == want[0]
    check_bounded_hi("assign_stats_bounded", got[8], want[8], same)
    if got[9].any():
        raise AssertionError("assign_stats_bounded: sentinel bounds pruned a row")
    # the statistics against the plain fold over the kernel's own labels, so
    # a near-tie row cannot move a sum across clusters
    for name, gt, wt, tol in zip(
        ("sums", "counts", "min_sim", "sumsq"), got[2:6], plain_stats(x, got[0], got[1], BIG_K),
        ((SUM_RTOL, SUM_ATOL), (SUM_RTOL, SUM_ATOL), (0.0, SIM_TOL), (SUM_RTOL, SUM_ATOL)),
    ):
        err = max(err, check_close(f"assign_stats_bounded {name}", gt, wt, *tol))
    errs["assign_stats_bounded"] = err
    del got, want

    # carried bounds after one K-Means step at k = 400
    st0 = ops.assign_stats_bounded(x, c400, _sentinel(n, dev), zero[:BKC_K])
    means = st0.sums / torch.clamp(st0.counts, min=1.0)[:, None]
    c1 = torch.where(st0.counts[:, None] > 0, l2_normalize(means), c400).contiguous()
    drift = torch.linalg.vector_norm(c1 - c400, dim=1)
    bnd = st0.bounds
    args = (x, c1, bnd.idx, bnd.lo, bnd.hi, drift)
    got = assign_stats_bounded_cuda(*args)
    check_repeat("assign_stats_bounded carried", got, assign_stats_bounded_cuda(*args))
    check_equal("assign_stats_bounded carried vs assign_stats", got[:6], assign_stats_cuda(x, c1))
    want = ref.assign_stats_bounded_scatter(*args)
    xf = x.float()
    rownorm = torch.sqrt(torch.sum(xf * xf, dim=1))
    del xf
    _, _, lo_adj, hi_adj = ref.deflate_bounds(bnd.idx, bnd.lo, bnd.hi, rownorm, drift)
    near = (lo_adj - hi_adj - ref.PRUNE_MARGIN).abs() < 1e-5
    off = got[9] != want[9]
    if bool((off & ~near).any()):
        raise AssertionError("assign_stats_bounded: pruned mask differs away from the margin")
    ties["assign_stats_bounded carried"] = check_argmax(
        "assign_stats_bounded carried", got[0], got[1], want[0], want[1],
        lambda rows, cols: (x[rows] * c1[cols]).sum(1),
    )
    keep = ~off & (got[0] == want[0])
    check_bounded_hi("assign_stats_bounded carried", got[8], want[8], keep)
    share = got[9].float().mean().item()
    log(f"phase 2 parity: assign_argmax k={BKC_K} and assign_stats_bounded k={BIG_K} (index) "
        f"within tolerance, equal to assign_stats; max abs err {errs}; near-tie index "
        f"differences {ties}; carried bounds after one step at k={BKC_K}: pruned share "
        f"{share:.4f}, pruned-mask differences {int(off.sum())} (rows within 1e-5 of the "
        f"margin: {int(near.sum())})")
    return errs, (c400, c800, index, st0.bounds, c1, drift)


def phase_timing_bkc(x, state, dev):
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.assign_argmax import assign_argmax_cuda
    from repro_torch.kernels.assign_stats import assign_stats_bounded_cuda

    c400, c800, index, bnd, c1, drift = state
    n, d = x.shape
    f4 = 4
    rows = {}
    k = BKC_K
    rows["assign_argmax"] = dict(
        ms=event_ms(lambda: assign_argmax_cuda(x, c400), 10),
        plain_ms=event_ms(lambda: ref.assign_argmax(x, c400), 10),
        library_ms=event_ms(lambda: x @ c400.T, 10),
        bound=bound_ms(2.0 * n * k * d, n * d * f4 + k * d * f4 + 2 * n * f4),
    )
    # the bounded pass at BigK: sentinel bounds in identity order (the table
    # row: a full sweep), sentinel bounds through the index, carried bounds
    k = BIG_K
    b = _sentinel(n, dev)
    zero = torch.zeros(k, device=dev)
    # carried bounds at zero drift (the centers a converged fit ends on):
    # every row whose gap clears the margin is settled
    first = assign_stats_bounded_cuda(x, c800, b.idx, b.lo, b.hi, zero)
    settings = {
        "sentinel": ((x, c800, b.idx, b.lo, b.hi, zero), None),
        "sentinel+index": ((x, c800, b.idx, b.lo, b.hi, zero), index.perm),
        "carried, zero drift": ((x, c800, first[6], first[7], first[8], zero), None),
        "carried, zero drift+index": ((x, c800, first[6], first[7], first[8], zero), index.perm),
        # after one K-Means step at k = 400: the work is the unpruned rows'
        "carried after one K-Means step": ((x, c1, bnd.idx, bnd.lo, bnd.hi, drift), None),
    }
    del first
    for name, (args, perm) in settings.items():
        kk = args[1].shape[0]
        active = n - int(assign_stats_bounded_cuda(*args, perm=perm)[9].sum())
        ms = event_ms(lambda: assign_stats_bounded_cuda(*args, perm=perm), 5)
        plain = event_ms(lambda: ref.assign_stats_bounded_scatter(*args), 5)
        lib = event_ms(lambda: x @ args[1].T, 5)
        bnd_ms = bound_ms(2.0 * active * kk * d + 4.0 * n * d, bounded_bytes(n, kk, d))
        log(f"phase 3 timing assign_stats_bounded {name} (k={kk}): kernel {ms:.4f} ms, "
            f"plain {plain:.4f} ms, library {lib:.4f} ms, bound {bnd_ms[0]:.4f} ms "
            f"({bnd_ms[1]}; 2*n_active*k*d + 4*n*d flops), pruned share {1 - active / n:.4f}")
        if name == "sentinel":  # the table row: a full sweep
            rows["assign_stats_bounded"] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound=bnd_ms)
    for name, r in rows.items():
        log(f"phase 3 timing {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms ({r['bound'][1]})")
    return rows


def phase_bkc_path(x, truth, n_topics, buckshot_labels, dev):
    """BKC at Table 4's width through the bound-pruned pass, its other
    routes, bounded K-Means and Buckshot, and assign_batch."""
    import statistics

    import torch

    from repro_torch.common import l2_normalize
    from repro_torch.core import metrics, sampling
    from repro_torch.core.bkc import _group_centers, bkc, bkc_fit
    from repro_torch.core.buckshot import buckshot
    from repro_torch.core.kmeans import (
        assign_batch,
        init_random_centers,
        kmeans,
        kmeans_step_bounded,
    )
    from repro_torch.core.microcluster import build_microclusters
    from repro_torch.kernels import ops, ref

    n, d = x.shape
    truth_t = torch.from_numpy(truth).to(dev)

    def quality(labels, k):
        return dict(purity=metrics.purity(labels, truth_t, k, n_topics).item(),
                    nmi=metrics.nmi(labels, truth_t, k, n_topics).item())

    # (a) the entry point, bound-pruned
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res, t_bkc = sync_time(bkc, x, BIG_K, BKC_K, torch.Generator().manual_seed(SEED), bounded=True)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check_result("bkc", res, n, d, BKC_K)
    log(f"phase 4 bkc: n={n} d={d} k={BKC_K} BigK={BIG_K} bounded: {t_bkc:.3f} s (cold), "
        f"threshold {res.threshold.item()!r}, rss {res.rss.item()}, "
        f"{quality(res.assignment, BKC_K)}; "
        f"launches {counts}; peak device memory {peak / 2**30:.2f} GiB")
    if not (counts["assign_stats_bounded"] == 2 and counts["assign_argmax"] > 0
            and counts["label_stats"] > 0):
        raise AssertionError(f"bkc did not go through the bounded kernels: {counts}")
    # the same draw as bkc's
    pick = sampling.sample_indices(n, BIG_K, torch.Generator().manual_seed(SEED), dev)
    init = l2_normalize(x[pick])
    (mc, _, _), t1 = sync_time(lambda: build_microclusters(x, init, BIG_K, bounded=True))
    (centers, group, _), tj = sync_time(_group_centers, mc, BKC_K)

    def pass2():
        index = ops.build_center_index(centers)
        return ops.assign_stats_bounded(x, centers, _sentinel(n, dev),
                                        torch.zeros(BKC_K, device=dev), index=index)

    _, t2 = sync_time(pass2)
    warm, t_warm = sync_time(bkc_fit, x, init, BIG_K, BKC_K, bounded=True)
    log(f"phase 4 bkc phases (separate warm runs): pass 1 {t1:.4f} s, join_to_groups + "
        f"centers {tj:.4f} s, pass 2 (index + bounded pass) {t2:.4f} s; "
        f"warm bkc_fit {t_warm:.4f} s")
    if not (torch.equal(group, res.group_of_mc) and torch.equal(warm.assignment, res.assignment)):
        raise AssertionError("bkc: a repeat run gave another grouping or assignment")
    profile_run("bkc_fit bounded", bkc_fit, x, init, BIG_K, BKC_K, bounded=True)

    # (b) the fused and two-pass routes from the same draw
    for route, kw in (("fused", {}), ("two-pass", {"fused": False})):
        ops.reset_launch_counts()
        other, t_o = sync_time(bkc_fit, x, init, BIG_K, BKC_K, **kw)
        rc = ops.launch_counts()
        if not (torch.equal(other.group_of_mc, res.group_of_mc)
                and torch.equal(other.assignment, res.assignment)):
            raise AssertionError(f"bkc {route} route disagrees with the bounded route")
        if route == "two-pass" and rc["assign_argmax"] != 2:
            raise AssertionError(f"bkc two-pass did not go through assign_argmax: {rc}")
        log(f"phase 4 bkc {route} route: {t_o:.4f} s, same groups and labels; launches {rc}")

    # (c) bounded against unbounded K-Means at k = 400, from the same seed
    ops.reset_launch_counts()
    kb, t_kb = sync_time(kmeans, x, BKC_K, torch.Generator().manual_seed(SEED), bounded=True)
    kb_counts = ops.launch_counts()
    ku, t_ku = sync_time(kmeans, x, BKC_K, torch.Generator().manual_seed(SEED), bounded=False)
    if not (torch.equal(kb.centers, ku.centers) and torch.equal(kb.assignment, ku.assignment)
            and kb.iterations == ku.iterations):
        raise AssertionError("bounded and unbounded K-Means differ")
    if kb_counts["assign_stats_bounded"] != kb.iterations + 1:
        raise AssertionError(f"bounded kmeans did not go through its kernel: {kb_counts}")
    log(f"phase 4 kmeans k={BKC_K}: bounded {t_kb:.4f} s, unbounded {t_ku:.4f} s (cold); "
        f"{kb.iterations} iterations, centers and labels bit-identical; rss {kb.rss.item()}, "
        f"{quality(kb.assignment, BKC_K)}; launches {kb_counts}")
    # the same fit step by step: each pass's pruned share, and why the bounds
    # prune or not (a row settles when its carried gap lo - hi clears its own
    # center's drift plus the largest other drift)
    centers = init_random_centers(x, BKC_K, torch.Generator().manual_seed(SEED))
    prev, bounds, diag = centers + 10.0, _sentinel(n, dev), []
    for _ in range(kb.iterations):
        new, st = kmeans_step_bounded(x, centers, prev, bounds, BKC_K,
                                      index=ops.center_index_for(x, centers))
        drift = torch.linalg.vector_norm(new - centers, dim=1)
        gap = st.bounds.lo - st.bounds.hi
        clear = (gap > 2 * drift.max() + ref.PRUNE_MARGIN).float().mean().item()
        diag.append(f"pruned {st.pruned.float().mean().item():.4f} drift max "
                    f"{drift.max().item():.4f} median {drift.median().item():.4f} gap median "
                    f"{gap.median().item():.4f} clear {clear:.4f}")
        prev, centers, bounds = centers, new, st.bounds
    if not torch.equal(centers, kb.centers):
        raise AssertionError("bounded K-Means step by step differs from kmeans()")
    log(f"phase 4 kmeans k={BKC_K} per pass (pruned share; center drift; carried gap "
        f"lo - hi; share of rows whose gap clears twice the largest drift): {'; '.join(diag)}")

    # (d) bounded Buckshot gives the unbounded run's labels
    ops.reset_launch_counts()
    bb, t_bb = sync_time(buckshot, x, K, torch.Generator().manual_seed(SEED), bounded=True)
    if not torch.equal(bb.kmeans.assignment, buckshot_labels):
        raise AssertionError("bounded Buckshot differs from the unbounded run")
    log(f"phase 4 buckshot bounded: {t_bb:.4f} s, labels equal the unbounded run; "
        f"launches {ops.launch_counts()}")

    # (e) the service's micro-batches against (c)'s centers
    index = ops.build_center_index(kb.centers)
    times = []
    for lo in range(0, 300 * BATCH, BATCH):
        (idx, _), t = sync_time(assign_batch, x[lo:lo + BATCH], kb.centers, index=index)
        if not torch.equal(idx, kb.assignment[lo:lo + BATCH]):
            raise AssertionError("assign_batch disagrees with the full bounded pass")
        times.append(t)
    log(f"phase 4 assign_batch: 300 batches of {BATCH} rows at k={BKC_K}, labels equal the "
        f"full pass; median {1e3 * statistics.median(times):.4f} ms per batch, "
        f"min {1e3 * min(times):.4f} ms")
    return counts


def off_topic_corpus(shape: dict, share: float, doc_len: int = 120):
    """The collection of ``shape`` plus ``share`` of it again in off-topic
    documents: words drawn uniformly from the vocabulary (mail that belongs
    to no newsgroup). A micro-cluster that takes one gets a low min_i, so
    centers of one topic have pair values cos - min_i - min_j above 0."""
    import numpy as np

    from repro_torch.text import synth

    c = synth.make_corpus(**shape)
    vocab = shape["vocab"]
    m = int(share * shape["n_docs"])
    noise = np.random.default_rng(shape["seed"] + 1).multinomial(
        doc_len, np.full(vocab, 1.0 / vocab), size=m).astype(np.float32)
    return synth.Corpus(counts=np.concatenate([c.counts, noise]),
                        labels=np.concatenate([c.labels, np.full(m, c.n_topics, np.int32)]),
                        n_topics=c.n_topics + 1)


def phase_oracle_bkc(dev):
    """BKC at Table 1's shape, card against CPU on the same draw: on the 20
    Newsgroups collection (every pair value is 0 there, so the bisection
    ends at its lowest step) and on the same collection with 5 % off-topic
    documents, where the threshold lies between real pair values."""
    import torch

    from repro_torch.common import l2_normalize
    from repro_torch.core import sampling
    from repro_torch.core.bkc import bkc_fit
    from repro_torch.core.microcluster import build_microclusters, pair_similarity
    from repro_torch.text import pipeline, synth

    k, big_k = 50, 250  # Table 1
    for name, corpus in (
        ("20ng", synth.make_corpus(**synth.paper_20ng_shape())),
        ("20ng+off-topic", off_topic_corpus(synth.paper_20ng_shape(), 0.05)),
    ):
        x_cpu, _ = pipeline.prepare_local(corpus, device="cpu")
        n = x_cpu.shape[0]
        pick = sampling.sample_indices(n, big_k, torch.Generator().manual_seed(0), device="cpu")
        init = l2_normalize(x_cpu[pick])
        want = bkc_fit(x_cpu, init, big_k, k, bounded=True)
        got = bkc_fit(x_cpu.to(dev), init.to(dev), big_k, k, bounded=True)
        agree = (got.assignment.cpu() == want.assignment).double().mean().item()
        rel = abs(got.rss.item() - want.rss.item()) / abs(want.rss.item())
        same_groups = torch.equal(got.group_of_mc.cpu(), want.group_of_mc)
        thr, thr_cpu = got.threshold, want.threshold.to(dev)
        pair = pair_similarity(build_microclusters(x_cpu.to(dev), init.to(dev), big_k)[0])[0]
        above = int((pair >= thr).sum()) // 2
        below = int(((pair > 0) & (pair < thr)).sum()) // 2
        log(f"phase 5 bkc oracle {name} at n={n} k={k} BigK={big_k}: assignment agreement "
            f"{agree}, RSS card {got.rss.item()} vs CPU {want.rss.item()} (rel {rel:.2e}), "
            f"threshold card {thr.item()!r} vs CPU {thr_cpu.item()!r}, pair values above / "
            f"below it {above} / {below}, group_of_mc equal: {same_groups}")
        if not same_groups:
            # the groups may differ only through an edge whose pair value lies
            # within 1e-5 of the threshold (a near-tie of the bisection)
            pair_cpu = pair_similarity(build_microclusters(x_cpu, init, big_k)[0])[0].to(dev)
            flipped = (pair >= thr) != (pair_cpu >= thr_cpu)
            gap = (pair[flipped] - thr).abs().max().item() if flipped.any() else float("inf")
            log(f"phase 5 bkc oracle {name}: {int(flipped.sum()) // 2} edges differ, the "
                f"farthest {gap!r} from the threshold")
            if gap >= 1e-5:
                raise AssertionError(f"{name}: the card's BKC groups differ from the CPU's, "
                                     "not at a near-tie")
        if agree < 0.999 or rel > 1e-4 or abs(thr.item() - thr_cpu.item()) > 1e-5:
            raise AssertionError(f"{name}: the card's BKC disagrees with the plain CPU path")
        if name != "20ng" and not (thr.item() > 1e-3 and above > 0 and below > 0):
            raise AssertionError(f"{name}: the bisection did not run over real pair values")



# ------------------------------------------- the multi-device engine slice


def cbe_bits_equal(name, got, want):
    """component_best_edge outputs equal bit for bit (w compared as bits)."""
    import torch

    check_equal(name, (got[0].view(torch.int32),) + tuple(got[1:]),
                (want[0].view(torch.int32),) + tuple(want[1:]))


def check_cbe(name, args, c):
    """The kernel against both plain versions, bit for bit, and its repeat.
    Returns the outputs and the largest |kernel - plain| over them."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.component_reduce import component_best_edge_cuda

    got = component_best_edge_cuda(*args, c)
    check_repeat(name, got, component_best_edge_cuda(*args, c))
    err = 0.0
    for plain, want in (("lexsort", ref.component_best_edge(*args, c)),
                        ("segment", ref.component_best_edge_segment(*args, c))):
        if got[0].numel():
            err = max([err] + [(g.double() - w.double()).abs().max().item()
                               for g, w in zip(got, want)])
        cbe_bits_equal(f"{name} vs {plain}", got, want)
    return got, err


def phase_parity_edges_cbe(dev):
    """component_best_edge on the reference's edge cases: f32.min rows,
    duplicate weights with lower row ids on either side, ids -1 and c, c > r,
    r off any block size, -0.0 against +0.0, r = 0."""
    import numpy as np
    import torch

    from repro_torch import interop
    from repro_torch.kernels import ref

    rng = np.random.default_rng(4)
    err = 0.0
    for r, c in [(7, 3), (64, 64), (130, 9), (513, 40), (300, 700), (257, 1), (0, 5)]:
        w = rng.normal(size=r).astype(np.float32)
        w[::5] = ref.NEG
        if r > 10:
            w[3] = w[8]  # duplicate weight
            w[1], w[2] = -0.0, 0.0
        args = (interop.data(w, dev), interop.labels(rng.integers(-1, 64, size=r), dev),
                interop.labels(rng.permutation(2 * r)[:r], dev),
                interop.labels(rng.integers(-1, c + 1, size=r), dev))
        err = max(err, check_cbe(f"component_best_edge r={r} c={c}", args, c)[1])
    # equal weights, the winner's lower row ids on either side; -0.0 vs +0.0
    r = 40
    rows = torch.arange(r - 1, -1, -1, dtype=torch.int32, device=dev)
    rows[[0, 39]] = rows[[39, 0]]
    w = torch.full((r,), 0.5, device=dev)
    w[::2] = -0.0
    w[1::2] = 0.0
    comp = (torch.arange(r, device=dev) % 3).int()
    col = torch.arange(100, 100 + r, dtype=torch.int32, device=dev)
    got, e = check_cbe("component_best_edge ties", (w, col, rows, comp), 3)
    err = max(err, e)
    lowest = [int(rows[comp == j].min()) for j in range(3)]  # all weights tie
    if got[1].tolist() != lowest:
        raise AssertionError(f"component_best_edge ties: winners {got[1].tolist()}, not {lowest}")
    log(f"phase 2 parity: component_best_edge edge cases bit for bit against both plain "
        f"versions (max |kernel - plain| {err}), repeats bit-identical")
    return err


def l2_normalize_twice(xs):
    """The sample as phase 1 searches it: ``_phase1_init_centers`` normalizes,
    and ``boruvka_mst_distributed`` normalizes again."""
    from repro_torch.common import l2_normalize

    return l2_normalize(l2_normalize(xs)).contiguous()


def timing_cbe(args, cap):
    """component_best_edge at round 1 of the main path (r = 3,536, c = 1,768)."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.component_reduce import component_best_edge_cuda

    bw = args[0]
    r = bw.shape[0]
    seg = args[3].long()
    lib_out = torch.full((cap + 1,), float("-inf"), device=bw.device)
    row = dict(
        ms=event_ms(lambda: component_best_edge_cuda(*args, cap), 200),
        plain_ms=event_ms(lambda: ref.component_best_edge_segment(*args, cap), 50),
        # no single PyTorch call computes the whole function: the library
        # yardstick is its first pass, one segment max of w (a sink slot
        # takes the dropped ids)
        library_ms=event_ms(lambda: lib_out.scatter_reduce_(0, seg, bw, "amax"), 200),
        bound=bound_ms(0.0, 16 * r + 12 * cap),
    )
    lex = event_ms(lambda: ref.component_best_edge(*args, cap), 50)
    log(f"phase 4 timing component_best_edge r={r} c={cap}: kernel {row['ms']:.4f} ms, plain "
        f"(segment) {row['plain_ms']:.4f} ms, plain (lexsort) {lex:.4f} ms, library "
        f"(scatter_reduce_ amax) {row['library_ms']:.4f} ms, bound {row['bound'][0]:.6f} ms "
        f"({row['bound'][1]}: 16 B per row + 12 B per segment)")
    return row


def nccl_world_1(tmp):
    """A NCCL group of one rank, from a FileStore in ``tmp``: no network."""
    import os

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                            rank=0, world_size=1)


def phase_distributed(x, dev):
    """Distributed Buckshot on the 1 GB collection through the engine over
    NCCL at world size 1, as a user calls it (the distributed sample, then
    the sharded Borůvka phase 1, then distributed K-Means), held against the
    resident path on the card from the same sample indices. Returns the
    launch counts of that run, and component_best_edge's parity error and
    timing row from the three-shard fold."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.common import l2_normalize
    from repro_torch.core import sampling
    from repro_torch.core.buckshot import buckshot_fit, phase1_from_sample
    from repro_torch.core.hac import boruvka_mst, cut_mst_edges, single_link_labels_boruvka
    from repro_torch.distrib import cluster as dc
    from repro_torch.distrib.hac_parallel import boruvka_mst_distributed
    from repro_torch.distrib.sharding import make_flat_mesh
    from repro_torch.kernels import ops

    n, d = x.shape
    s = sampling.buckshot_sample_size(n, K)
    w = torch.ones((n,), device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        nccl_world_1(tmp)
        try:
            mesh, axes = make_flat_mesh(), ("data",)

            # the distributed sample: its collectives are the group's first,
            # which set up the NCCL communicator
            gidx, t_idx_cold = sync_time(dc.sample_indices_distributed, mesh, axes, w, s, SEED)
            rows, t_rows = sync_time(dc.sample_rows_distributed, mesh, axes, x, w, s, SEED)
            sidx = gidx.long()
            if not (gidx.shape == (s,) and gidx.dtype == torch.int32
                    and int(gidx.min()) >= 0 and int(gidx.max()) < n
                    and bool((w[sidx] > 0).all()) and torch.unique(gidx).shape[0] == s):
                raise AssertionError("sample_indices_distributed: not s distinct real rows")
            if not torch.equal(rows, x[sidx]):
                raise AssertionError("sample_rows_distributed: rows differ from x[ids]")
            again_idx, t_idx = sync_time(dc.sample_indices_distributed, mesh, axes, w, s, SEED)
            if not torch.equal(again_idx, gidx):
                raise AssertionError("sample_indices_distributed: a repeat draw differs")
            xs = x[sidx]

            def fit():
                return dc.buckshot_distributed(mesh, axes, x, w, K, SEED, sample_size=s,
                                               hac="boruvka")

            _, t_p1_cold = sync_time(dc._phase1_init_centers, mesh, axes, xs, K, hac="boruvka")
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            res, t_cold = sync_time(fit)
            counts = ops.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            again, t_warm = sync_time(fit)
            check_result("buckshot_distributed", res, n, d)
            if not (torch.equal(again.assignment, res.assignment)
                    and torch.equal(again.rss, res.rss)):
                raise AssertionError("buckshot_distributed: a repeat run gave other bits")
            _, t_p1 = sync_time(dc._phase1_init_centers, mesh, axes, xs, K, hac="boruvka")

            # the resident path on the card, from the same sample indices;
            # phase 1 normalizes the sample once before the Borůvka call
            xs1 = l2_normalize(xs)
            ops.reset_launch_counts()
            ref_edges = boruvka_mst(xs1)
            rounds_resident = ops.launch_counts()["sim_best_edge"]
            want, t_res = sync_time(buckshot_fit, x, sidx, K)
            (labels_res, centers_res), t_res_p1 = sync_time(phase1_from_sample, xs, K)
            rounds = counts["sim_best_edge"]  # one ring step per round at world size 1
            expect = min(len(ref_edges.u) // s, 3 * -(-rounds_resident // 3))
            if not (rounds == expect and counts["component_best_edge"] == 2 * rounds
                    and counts["label_stats"] >= 1
                    and counts["assign_stats"] == res.iterations + 1):
                raise AssertionError(f"distributed Buckshot: launches {counts}, rounds "
                                     f"{rounds}, expected {expect}")
            same = torch.equal(res.assignment, want.kmeans.assignment)
            rel = abs(res.rss.item() - want.kmeans.rss.item()) / abs(want.kmeans.rss.item())
            if not same or rel > 1e-5:
                raise AssertionError(f"distributed Buckshot: labels equal {same}, rss rel {rel}")
            log(f"phase 4 distributed buckshot (NCCL, world size 1): n={n} d={d} k={K} s={s}; "
                f"sample ids first call (the group's first collectives) {t_idx_cold:.4f} s, "
                f"again {t_idx:.4f} s; sample rows (ids drawn anew, then collected) "
                f"{t_rows:.4f} s: {s} distinct real rows, equal to x[ids]; "
                f"phase 1 alone first call {t_p1_cold:.4f} s, warm {t_p1:.4f} s; whole fit "
                f"first call {t_cold:.4f} s, warm {t_warm:.4f} s; resident buckshot_fit "
                f"(warm, same ids) {t_res:.4f} s, phase 1 {t_res_p1:.4f} s; {rounds} Borůvka "
                f"rounds (resident {rounds_resident}), {res.iterations} K-Means iterations; "
                f"launches {counts}; peak device memory {peak / 2**30:.2f} GiB; labels equal "
                f"the resident fit, rss {res.rss.item()} vs {want.kmeans.rss.item()} "
                f"(rel {rel:.2e})")
            profile_run("buckshot_distributed", fit)

            # each mode's expanded edges, and its compact edges cut into the
            # labels and initial centers of phase 1
            for kw in ({}, {"sweep": "bcast"}, {"merge": "point"}):
                edges, t_e = sync_time(boruvka_mst_distributed, mesh, axes, xs1,
                                       compact=False, **kw)
                m = edges.u.shape[0]
                for f, got in edges._asdict().items():
                    ref_f = getattr(ref_edges, f)[:m]
                    if got.dtype == torch.float32:
                        got, ref_f = got.view(torch.int32), ref_f.view(torch.int32)
                    if not torch.equal(got, ref_f):
                        raise AssertionError(f"boruvka_mst_distributed {kw}: {f} differs")
                if ref_edges.valid[m:].any():
                    raise AssertionError(f"boruvka_mst_distributed {kw}: stopped early")
                labels = cut_mst_edges(boruvka_mst_distributed(mesh, axes, xs1, **kw), s, K)
                if not torch.equal(labels, single_link_labels_boruvka(xs1, K)):
                    raise AssertionError(f"single-link labels {kw} differ")
                sums, cnt = ops.label_stats(xs1, labels, K)
                centers = torch.where(cnt[:, None] > 0, l2_normalize(sums), 0.0)
                if not (torch.equal(centers, centers_res)
                        and torch.equal(labels, labels_res)):
                    raise AssertionError(f"phase 1 {kw}: labels or centers differ")
                log(f"phase 4 distributed {kw or 'sharded'}: expanded edges ({m // s} rounds) "
                    f"equal resident boruvka_mst bit for bit in {t_e:.4f} s; labels and initial "
                    f"centers equal")
            err, timing = three_shard_fold(mesh, axes, l2_normalize_twice(xs))
        finally:
            dist.destroy_process_group()
    return counts, err, timing


def three_shard_fold(mesh, axes, xs, n_shards=3):
    """P = 3 on one card, in one process: every round of one run, each of
    three row blocks (3,536 does not divide by 3: one pad row) folds the
    other blocks in ring order and pre-reduces with the kernel; the three
    winner sets merged in two orders equal the world-size-1 reduce. Each
    round also holds the kernel against both plain versions on the inputs
    the world-size-1 job's shard passes it, and round 1's are timed.
    Returns (max |kernel - plain|, the timing row)."""
    import functools

    import torch

    from repro_torch.core.hac import _merge_round_comp, _rounds_for
    from repro_torch.distrib.engine import _component_merge
    from repro_torch.distrib.hac_parallel import (
        CHECK_EVERY,
        _cand_job,
        _relabel_job,
        round_cap,
        sharded_candidates,
        sharded_row_winners,
    )

    s, d = xs.shape
    dev = xs.device
    job = _cand_job(mesh, axes, "comp_sharded", True)
    relabel_job = _relabel_job(mesh, axes)
    pad = (-s) % n_shards
    b = (s + pad) // n_shards
    xs3 = torch.cat([xs, xs.new_zeros((pad, d))])
    rowid = torch.arange(s + pad, dtype=torch.int32, device=dev)
    comp = rowid[:s].clone()
    c2r = rowid[:s].clone()
    n_real = torch.tensor(s, dtype=torch.int32, device=dev)
    caps, err, timed = [], 0.0, None
    for r in range(_rounds_for(s)):
        cap = round_cap(s, r)
        caps.append(cap)
        data = {"rows": xs, "rowid": rowid[:s], "comp": comp}
        best = job(data, {"comp_to_root": c2r})["best"]
        # the one shard's combiner inputs (its ring has one step: its own block)
        rw = sharded_row_winners(data, cap, lambda block, fold, acc: fold(acc, block))
        for payload in ("col", "tcomp"):
            args = (rw["w"], rw[payload], rw["rowid"], rw["seg"])
            got, e = check_cbe(f"component_best_edge cap={cap} ({payload})", args, cap)
            err = max(err, e)
            want = (best["w"], best["row"], best[payload])
            cbe_bits_equal(f"component_best_edge cap={cap} ({payload}) vs the job", got, want)
            if r == 1 and payload == "col":
                timed = (args, cap)
        comp3 = torch.cat([comp, torch.full((pad,), -1, dtype=torch.int32, device=dev)])
        blocks = [{"rows": xs3[i * b:(i + 1) * b], "rowid": rowid[i * b:(i + 1) * b],
                   "comp": comp3[i * b:(i + 1) * b]} for i in range(n_shards)]

        def visit(i):
            ring = [blocks[(i - t) % n_shards] for t in range(n_shards)]  # the ring's order
            return lambda block, fold, acc: functools.reduce(fold, ring, acc)

        wins = [sharded_candidates(blocks[i], cap, visit(i)) for i in range(n_shards)]
        for order in ((0, 1, 2), (2, 1, 0)):
            merged = functools.reduce(_component_merge, [wins[i] for i in order])
            for key in best:
                g, want = merged[key], best[key]
                if g.dtype == torch.float32:
                    g, want = g.view(torch.int32), want.view(torch.int32)
                if not torch.equal(g, want):
                    raise AssertionError(f"three-shard fold, order {order}, cap {cap}: "
                                         f"{key} differs from the world-size-1 reduce")
        relabel, c2r, *_, n_real = _merge_round_comp(
            best["w"], best["row"], best["col"], best["tcomp"], c2r, n_real,
            next_cap=round_cap(s, r + 1))
        comp = relabel_job({"comp": comp}, {"relabel": relabel})["comp"]
        if (r + 1) % CHECK_EVERY == 0 and int(n_real) == 1:
            break
    log(f"phase 4 component_best_edge on the main path's candidates, r={s}, caps {caps}: bit "
        f"for bit against both plain versions (max |kernel - plain| {err}) and the job's "
        "reduce, repeats bit-identical")
    log(f"phase 4 three-shard fold: {n_shards} row blocks of {b} rows ({pad} pad), caps {caps}: "
        "the winner sets merged in two orders equal the world-size-1 reduce bit for bit")
    return err, timing_cbe(*timed)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.common import l2_normalize
    from repro_torch.core import sampling
    from repro_torch.text import pipeline, synth

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    phase_device()

    t = time.perf_counter()
    corpus = synth.make_corpus(**synth.paper_1gb_shape())
    log(f"set-up: generated the 1 GB corpus on the host in {time.perf_counter() - t:.1f} s")
    x, _ = pipeline.prepare_local(corpus, dev)
    n = x.shape[0]
    s = sampling.buckshot_sample_size(n, K)
    sidx = sampling.sample_indices(n, s, torch.Generator().manual_seed(SEED), dev)
    xs = l2_normalize(x[sidx])

    t = time.perf_counter()
    phase_parity_edges(dev)
    errs = phase_parity_main(x, xs, dev)
    phase_parity_edges_bkc(dev)
    errs_bkc, state = phase_parity_main_bkc(x, dev)
    errs.update(errs_bkc)
    errs["component_best_edge"] = phase_parity_edges_cbe(dev)
    log(f"phase 2 parity took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    times = phase_timing(x, xs, dev)
    times.update(phase_timing_bkc(x, state, dev))
    log(f"phase 3 timing took {time.perf_counter() - t:.1f} s")
    del x, xs, state
    torch.cuda.empty_cache()
    t = time.perf_counter()
    counts, buckshot_labels, x, truth = phase_main_path(corpus, dev)
    bkc_counts = phase_bkc_path(x, truth, corpus.n_topics, buckshot_labels, dev)
    for name in ("assign_argmax", "assign_stats_bounded"):  # the kernels BKC brings
        counts[name] = bkc_counts[name]
    # the kernel distributed Buckshot brings; its main-path parity and
    # timing come from the three-shard fold's rounds
    dist_counts, err, times["component_best_edge"] = phase_distributed(x, dev)
    counts["component_best_edge"] = dist_counts["component_best_edge"]
    errs["component_best_edge"] = max(errs["component_best_edge"], err)
    log(f"phase 4 paths took {time.perf_counter() - t:.1f} s")
    del x
    torch.cuda.empty_cache()
    t = time.perf_counter()
    phase_oracle(dev)
    phase_oracle_bkc(dev)
    log(f"phase 5 oracles took {time.perf_counter() - t:.1f} s")

    replaces = {
        "sim_best_edge": ("src/repro_torch/kernels/csrc/sim_best_edge.cu",
                          "src/repro/kernels/sim_best_edge.py:145"),
        "label_stats": ("src/repro_torch/kernels/csrc/label_stats.cu",
                        "src/repro/kernels/assign_stats.py:614"),
        "assign_stats": ("src/repro_torch/kernels/csrc/assign_stats.cu",
                         "src/repro/kernels/assign_stats.py:191"),
        "assign_argmax": ("src/repro_torch/kernels/csrc/assign_argmax.cu",
                          "src/repro/kernels/assign_argmax.py:98"),
        "assign_stats_bounded": ("src/repro_torch/kernels/csrc/assign_stats_bounded.cu",
                                 "src/repro/kernels/assign_stats.py:481"),
        "component_best_edge": ("src/repro_torch/kernels/csrc/component_reduce.cu",
                                "src/repro/kernels/component_reduce.py:130"),
    }
    kernels = []
    for name, (source, tpu) in replaces.items():
        r = times[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=tpu,
            launches=counts[name], max_abs_err=errs[name], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound"][0], bound_by=r["bound"][1],
            library_ms=r["library_ms"],
        ))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
