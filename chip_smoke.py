#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU and check it.

Run from the repository root, with no arguments:  python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:
  1. Device: the card's name and power limit; build the CUDA kernels from
     src/repro_torch/kernels/csrc with nvcc.
  2. Kernel parity: each kernel against its plain PyTorch version on the same
     CUDA tensors, at the main path's shapes and on integer-valued edge cases
     (ties across tiles, pad labels, weight-0 rows, empty clusters, sizes off
     the tiles); each kernel runs twice and must repeat its bits.
  3. Timing (CUDA events): kernel, plain version, one library call, and the
     card's lower bound for the same work.
  4. Main path at full size: the ~1 GB collection (n = 250,000, d = 2,048,
     50 topics), tf-idf on the card, Buckshot with k = 50 (s = 3,536), then
     the K-Means baseline; every kernel's launch counter must move.
  5. End-to-end oracle at the 20 Newsgroups shape: the kernel path on the
     card against the plain path on the CPU, on the same sample.
  6. Summary: a {"kernels": [...]} line, then {"ok": true, "device": ...} last.

Tolerances. Integer-valued inputs make every product and sum exact in f32, so
there the kernels must equal the plain versions bit for bit. On real tf-idf
rows the kernels add in another order than the plain versions, so:
similarities within 1e-5 absolute (unit-norm rows, d = 2,048); sums, weight
totals and squared norms within 1e-4 relative + 1e-5 absolute (non-negative
sums of up to ~10^4 terms); an index may differ only at a near-tie, where the
plain similarity of the kernel's pick is within 1e-5 of the plain best (such
rows are counted and printed). End to end: assignment agreement >= 99.9% and
RSS within 1e-4 relative, for the same reason.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

K = 50  # clusters on the main path
SEED = 21  # the 1 GB shape's own seed
SIM_TOL = 1e-5
SUM_RTOL, SUM_ATOL = 1e-4, 1e-5
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 without tensor cores (data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 (data sheet)


def log(msg: str) -> None:
    print(msg, flush=True)


def sync_time(fn, *args):
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn(*args)
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
    return counts


def profile_buckshot(x, sample_idx):
    """One warm buckshot_fit under torch.profiler: the device's busy share
    of the wall time and the device ops that took the most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.buckshot import buckshot_fit

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = sync_time(buckshot_fit, x, sample_idx, K)
    # device-side events only (kernels, copies): the ATen rows repeat their
    # kernels' time. One stream, so the events do not overlap.
    rows = sorted(
        ((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        reverse=True,
    )
    busy = sum(r[0] for r in rows) / 1e6
    if not rows:
        log("phase 4 profile: the profiler recorded no device time (not measured)")
        return
    top = "; ".join(f"{key[:60]} x{cnt} {us / 1e3:.3f} ms" for us, cnt, key in rows[:8])
    log(f"phase 4 profile (warm buckshot_fit, profiled): wall {wall:.4f} s, device busy "
        f"{busy:.4f} s ({100 * busy / wall:.1f}%); top device ops: {top}")


def check_result(name, km, n, d):
    import torch

    a = km.assignment
    if a.shape != (n,) or int(a.min()) < 0 or int(a.max()) >= K:
        raise AssertionError(f"{name}: assignment out of shape or range")
    if km.centers.shape != (K, d) or not torch.isfinite(km.centers).all():
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

    phase_parity_edges(dev)
    errs = phase_parity_main(x, xs, dev)
    times = phase_timing(x, xs, dev)
    del x, xs
    torch.cuda.empty_cache()
    counts = phase_main_path(corpus, dev)
    phase_oracle(dev)

    replaces = {
        "sim_best_edge": ("src/repro_torch/kernels/csrc/sim_best_edge.cu",
                          "src/repro/kernels/sim_best_edge.py:145"),
        "label_stats": ("src/repro_torch/kernels/csrc/label_stats.cu",
                        "src/repro/kernels/assign_stats.py:614"),
        "assign_stats": ("src/repro_torch/kernels/csrc/assign_stats.cu",
                         "src/repro/kernels/assign_stats.py:191"),
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
