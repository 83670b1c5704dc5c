#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU and check it.

Run from the repository root, with no arguments:  python3 chip_smoke.py
(``python3 chip_smoke.py --kernels`` runs phase 1 and phase 3's timings of
sim_best_edge, component_best_edge, label_stats, assign_stats, best_edge,
assign_argmax, assign_stats_bounded and flash_decode on random unit rows of
the 1 GB shape, then Buckshot on the 1 GB collection (its RSS and a digest of
its labels), and stops: copied into an older tree's root it times that
tree's kernels too.)

Phases, in order; any failure raises and exits non-zero:
  1. Device: the card's name and power limit; build the CUDA kernels from
     src/repro_torch/kernels/csrc with nvcc (one process per source).
  2. Kernel parity: each kernel against its plain PyTorch version on the same
     CUDA tensors, at the main paths' shapes and on integer-valued edge cases
     (ties across tiles, pad labels, weight-0 rows, empty clusters, sizes off
     the tiles; for the bounded pass also duplicate centers visited out of id
     order, sentinel, carried and invalidated bounds; for sim_best_edge
     the self-search (tiles on and above the diagonal) and the full grid on
     s x s x d, s in {1, 127, 128, 129, 257, 3,536}, d in {1, 3, 33, 130,
     2,048}, equal columns across the diagonal tile, pads and one
     component; for component_best_edge f32.min rows, row-id ties on either
     side, ids -1 and c, c > r, -0.0 against +0.0, r = 0, and both grids
     (one block; the cooperative grid past its keys or rows, r = 200,000,
     several calls in a row); for best_edge every alignment of a row start
     (c = 4,097 to 4,100), c = 70,001 past the labels' staging in shared
     memory, r = 1, 131, 132, 133 and 20,000 around the persistent grid,
     ties across warp steps and row blocks, rows all in one component, -0.0,
     rows of NaN and of -inf, a block and labels off 16 bytes, r = 0 and
     c = 0, the main path's round-1 block xs @ xs.T and a block with round-2
     labels, all with torch.equal (NaN equal to NaN); for flash_decode
     lengths 0, 1, 511, 512, 513, 20,000, s and s + 7 with g = 1, 3 and 4,
     and at g = 12, dh = 64, 256 and 30, in f32 within 2e-5 and in bf16
     within one bf16 ulp of the plain value (for the g = 12 and dh cases
     plus 16 f32 ulps, 2^-20, of the size of each
     output's terms, sum p|v| / sum p: an output that cancels far below its
     terms moves past a bf16 ulp by the logits' f32 rounding alone), and two
     equal calls around a call of another shape, so the ticket counters are
     seen to reset; label_stats also at k = 800 and 1,600, d = 1 and 130,
     k = 1,000 and 2,000 over 60,000 rows (a three-stage ring wrapped many
     times, four runs), sorted label runs and w = None against ones; assign_stats and
     assign_stats_bounded at k = 800; assign_argmax, assign_stats and
     assign_stats_bounded on the pipelined tile's edges, n in {1, 127, 129,
     1,000} x k in {1, 63, 64, 65, 127, 128, 129, 400, 800} x d in {1, 3,
     33, 130, 2,048}, equal centers on both sides of every slab and tile
     boundary, assign_argmax equal to assign_stats and bounded equal to
     unbounded on each, carried bounds at d = 33 and 2,048; on the 1 GB rows
     assign_argmax equal to assign_stats at k = 400); each kernel runs twice
     and must repeat its bits. component_best_edge's main-path shapes are held in
     phase 4.
  3. Timing (CUDA events): kernel, plain version, one library call, and the
     card's lower bound for the same work (sim_best_edge's self-search
     against the half product, the full grid on a copy of the rows beside
     it; component_best_edge's in phase 4, on round 1's candidates:
     r = 3,536, c = 1,768, back to back and its kernels alone, profiled;
     best_edge at the kernel
     bench's 2,000 x 2,000 block and the main path's 3,536 x 3,536, with the
     L2 cache flushed before each call by a 512 MB write (the kernels line)
     and, beside it, by a 512 MB read, which leaves no dirty line, with
     torch.max(sim, 1) under both flushes; flash_decode at the kernel bench's
     cache, f32, and at llama3.2-3b's heads, bf16, length 20,000 of 32,768,
     with the kernel alone, profiled; label_stats at Buckshot's centers
     also with the L2 flushed and profiled, and the fold alone at
     n = 250,000 for k = 50 and k = 800).
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
     merged in two orders, against the world-size-1 reduce. Then the public
     ops.best_edge and ops.flash_decode at the phase 3 shapes. Then the
     streaming paths: the collection's tf-idf rows held in host memory as a
     CorpusStream of 8 chunks of 32,768 rows, through kmeans_fit_stream
     (k = 50, the baseline's initial centers: iterations equal, agreement
     >= 99.9 % and RSS within 1e-4 relative of the resident fit; prefetch on
     and off bit-identical; one chunk equal to kmeans_fit bit for bit;
     assign_stats launches = passes x chunks), buckshot_stream (k = 50: the
     reservoir's ids distinct and real, its rows equal to x at them, the
     resident buckshot_fit on those ids within the same limits) and
     bkc_fit_stream (k = 400, BigK = 800, bounded equal to unbounded bit for
     bit, groups equal to the resident fit's but at a near-tie); each with
     its time per pass, bytes copied, device memory and launches, and a
     profiled run (device busy share, copy time and its overlap with the
     kernels). Then the same streaming fits checkpointed: kmeans_fit_stream,
     bounded bkc_fit_stream and buckshot_stream cut by an injected producer
     fault (raise@gN) inside an iteration pass and, on the resumed run,
     inside the final pass, then run to the end from a MemoryCheckpointer
     (every=2): each result equal to the uninterrupted run's bit for bit,
     the store empty, and each run's assign_stats (bounded: its own kernel)
     launches equal to the chunks it folded, which shows it resumed from its
     snapshot; kmeans_fit_stream in a child process (the port alone, x
     memory-mapped from build/) SIGKILLed in its final pass (kill@gN), which
     must die by signal 9 leaving snapshot files, then rerun on its
     DiskCheckpointer directory: equal to the uninterrupted fit bit for bit,
     no .ckpt left; and the cost: one iteration pass with no checkpoint,
     every=2 and every=8 in turns, and one snapshot's bytes and time for the
     K-Means carries and the reservoir's. Then distributed streaming over a
     NCCL group of world size 1 (a FileStore under build/), each against its
     single-device stream bit for bit: kmeans_distributed_stream (k = 50,
     bounded and not; seconds per pass against kmeans_fit_stream's, in the
     order single, distributed, distributed, single), bkc_distributed_stream
     (k = 400, BigK = 800, both routes), reservoir_sample_distributed_stream
     fed the single-device reservoir's draws (the same indices in the same
     order), buckshot_distributed_stream on that sample (also against the
     resident buckshot_distributed on the sample's rows, agreement >= 99.9 %
     and RSS within 1e-4 relative, and under hac="boruvka"), df_fold_distributed
     and tfidf_distributed_stream on the regenerated stream at
     paper_1gb_shape(scale=0.1) (df, n and every chunk's rows equal);
     kmeans_distributed_stream and buckshot_distributed_stream cut twice by
     raise@gN and resumed from a DiskCheckpointer under build/ (launches per
     run equal to the chunks folded); one profiled distributed K-Means fit.
     Last the quickstart's chain on a regenerated stream:
     prepare_synthetic_stream (its tf-idf chunks equal to the resident tfidf
     of make_corpus bit for bit, prefetch on and off) -> kmeans_stream,
     bkc_stream (BigK = 2k), buckshot_stream. That chain runs at
     paper_1gb_shape(scale=0.1), n = 25,000, chunks of 8,192: every pass
     regenerates the multinomial draws on the host, and the whole 1 GB
     corpus takes 22-28 s to generate, so at full size its ~20 passes would
     not fit the smoke's time.
     Then the online service (repro_torch.serve.ClusterService) on the card
     at the 20 Newsgroups shape (20,000 docs, 20 topics, seed 20), each count
     row written as a text of tokens t{j}, dim = 2,048, k = 20, chunks of
     4,096, micro-batches of 64, a queue of 256 rows, s = sqrt(kn), 3 K-Means
     iterations: (a) 300 serial requests of 64 docs, each answer equal to
     assign_batch on the same rescaled rows under the served model bit for
     bit, the labels equal to the plain version's on the CPU but at near-ties
     within 1e-5; (b) 8 caller threads sending requests of 8 docs while
     ingest (batches of 500 of a drifted corpus, seed 21, tokens u{j}, until
     the detector trips, and two more) and the refit run, each answer equal
     to that oracle under the version that served it; (c) the swapped
     centers equal to an offline buckshot_stream on the card over base +
     absorbed rows with the refit's generator, bit for bit, version 1
     serving. Printed: assign p50/p99 idle and during the refit, assign_batch
     alone on 64 rows (median of 300), the fit's and refit's seconds, ingest
     docs/s, the launches of fit, assign, ingest and the refit's window; then
     the refit's K-Means bounded against unbounded on the combined rows held
     in host memory (from its Buckshot centers and from the live centers,
     with the pruned share per pass) and its buckshot_stream both ways.
     Then the LM zoo's serving path (repro_torch.models, ServeEngine) at
     qwen2-1.5b's full width and depth (28 layers, d_model 1,536, 1.54 B
     params, f32 weights drawn on the card from a seeded generator, no TF32):
     generate on 8 requests of 32-token prompts and 16 new tokens (prefill ms,
     decode ms a step, tokens/s, each beside the card's bound: model_flops
     over 67 TFLOP/s, the params and cache read once over 3.35 TB/s, and the
     host's CPU seconds over wall and involuntary context switches), 5 decode steps of 8 rows at a 32,768-slot f32 cache
     against their bound, one prefill and one decode step at each context
     profiled, the plain flash_attention beside SDPA (not on the path);
     prefill(T) + decode against prefill(T + 1) and greedy decode against
     the teacher-forced argmax within 2e-3, one 8-token prefill against the
     port on the CPU with the same weights; then embed-and-cluster (the
     pipeline of examples/torch_embed_and_cluster.py): 512 synthetic
     documents (8 topics, 64 tokens) embedded through ServeEngine.embed,
     Buckshot k = 8 on the card with its launch counts set to 0 just before
     (sim_best_edge, label_stats and assign_stats must each launch); the
     labels equal to the plain CPU Buckshot's on the same embeddings and
     sample but at near-ties, the initial and last centers within the sum
     tolerance, the final similarities within 1e-5; each of the three
     kernels against its plain version at the path's shapes; purity and NMI
     beside tf-idf's. Then the zoo's other families (phase_lm_families) at
     their published widths, f32 weights drawn on the card from SEED, each
     model freed before the next: zamba2-2.7b (hybrid) and rwkv6-3b whole,
     moonshot-v1-16b-a3b cut to 16 of 48 layers and mixtral-8x22b to 2 of
     56 (neither fits one card whole in f32): generate as above against
     per-family bounds (lm_bounds: attention caches, SSM and RWKV states,
     every expert's weights), the dropped MoE choices of one prefill, one
     prefill and one step profiled; prefill(T) + decode against prefill(T +
     1) and greedy against teacher-forced within 2e-3 (MoE at a capacity
     factor that drops nothing); one 8-token prefill against the port on the
     CPU at a shallower depth with the same weights.
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

import collections
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

K = 50  # clusters on the main path
SEED = 21  # the 1 GB shape's own seed
BKC_K, BIG_K = 400, 800  # Table 4's BKC width (k = 400, BigK = 2k)
BATCH = 64  # the online service's max_batch
SIM_TOL = 1e-5
SUM_RTOL, SUM_ATOL = 1e-4, 1e-5
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 without tensor cores (data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 (data sheet)
LM_ARCH = "qwen2-1.5b"  # the LM serve phase's model, at full width
LM_REQUESTS, LM_PROMPT, LM_NEW = 8, 32, 16
EMBED_DOCS, EMBED_TOPICS, EMBED_SEQ = 512, 8, 64
LM_TOL = 2e-3  # full-width f32 logits: 28 layers of sums in another order
LM_LONG_CTX, LM_LONG_STEPS = 32_768, 5  # decode_32k's context, 8 rows: ~15 GB f32 cache
# the zoo's other families at their published widths: (arch, layers run on
# the card (None: all), layers of the card-vs-CPU check). moonshot and mixtral
# do not fit one 80 GB card whole in f32 (110.3 and 562.5 GB): their depth is cut.
LM_FAMILIES = (
    ("zamba2-2.7b", None, 6),  # 54 mamba layers, 9 shared-block calls; CPU: one group
    ("rwkv6-3b", None, 2),
    ("moonshot-v1-16b-a3b", 16, 2),  # 1 dense + 15 MoE; CPU: dense + 1 MoE
    ("mixtral-8x22b", 2, 1),  # the 16 x 6,144 x 8,192 virtual experts
)


def log(msg: str) -> None:
    print(msg, flush=True)


def sync_time(fn, *args, **kwargs):
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def host_usage() -> tuple[float, int]:
    """(CPU seconds of this process, its involuntary context switches so
    far): beside a wall time, the share the host spent computing and how
    often other work took its cores."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime, ru.ru_nivcsw


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


def same(a, b) -> bool:
    """torch.equal, with NaN equal to NaN in the same place (best_edge
    passes a row's first NaN on, as torch.amax does)."""
    import torch

    if a.is_floating_point() and a.dtype == b.dtype and a.shape == b.shape:
        return bool(((a == b) | (a.isnan() & b.isnan())).all())
    return torch.equal(a, b)


def check_equal(name, got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        if not same(g, w):
            bad = (g != w).sum().item()
            raise AssertionError(f"{name}: output {i} differs in {bad} entries")


def check_repeat(name, a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        if not same(x, y):
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


def check_stats_fold(name, x, w, k, st) -> float:
    """A fused pass's statistics (sums, counts, min_sim, sumsq) against the
    plain fold over the kernel's own assignment, so that a near-tie row
    cannot move a sum across clusters; returns the max abs error."""
    return max(
        check_close(f"{name} {part}", got, want, *tol)
        for part, got, want, tol in zip(
            ("sums", "counts", "min_sim", "sumsq"), st[2:], plain_stats(x, st[0], st[1], k, w),
            ((SUM_RTOL, SUM_ATOL), (SUM_RTOL, SUM_ATOL), (0.0, SIM_TOL), (SUM_RTOL, SUM_ATOL)),
        )
    )


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
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.assign_stats import (
        assign_stats_bounded_cuda,
        assign_stats_cuda,
        label_stats_cuda,
    )
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
    phase_parity_sim_self(dev)
    # k = 800 in one read, k = 1,600 past one block's shared memory (two
    # label tiles), d = 1 and d = 130 (plain loads: rows off 16 bytes)
    for n, d, k in [(1000, 200, 70), (37, 5, 3), (0, 8, 4), (5000, 128, 800), (3000, 1, 50),
                    (2000, 130, 1600)]:
        x = ints((n, d), -8, 8)
        idx = interop.labels(rng.integers(-2, k + 2, size=n), dev)  # out of range too
        w = ints((n,), 0, 2)  # weight-0 rows
        a, b = label_stats_cuda(x, idx, k, w), label_stats_cuda(x, idx, k, w)
        check_repeat("label_stats", a, b)
        check_equal(f"label_stats {n}x{d} k={k}", a, ref.label_stats(x, idx, k, w))
        # w = None reads as weight 1
        check_equal(f"label_stats {n}x{d} k={k} w=None", label_stats_cuda(x, idx, k),
                    label_stats_cuda(x, idx, k, torch.ones((n,), device=dev)))
    # k = 1,000 and 2,000: a ring of three stages, which each block of
    # 60,000 rows wraps dozens of times; four runs, each equal to the plain
    # (their own generator, so the other cases keep their data)
    ring_rng = np.random.default_rng(10)
    for k in (1000, 2000):
        x = interop.data(ring_rng.integers(-8, 9, size=(60_000, 256)), dev)
        idx = interop.labels(ring_rng.integers(-1, k + 1, size=60_000), dev)
        w = interop.data(ring_rng.integers(0, 3, size=60_000), dev)
        want = ref.label_stats(x, idx, k, w)
        for _ in range(4):
            check_equal(f"label_stats 60000x256 k={k}", label_stats_cuda(x, idx, k, w), want)
    # sorted labels: long runs of one label in one warp's register
    x = ints((6000, 256), -8, 8)
    idx = torch.sort(interop.labels(rng.integers(0, 40, size=6000), dev))[0]
    check_equal("label_stats sorted runs", label_stats_cuda(x, idx, 40), ref.label_stats(x, idx, 40))
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
    # both stats kernels at k = 800 through the shared fold
    x, centers = ints((3000, 96), -4, 4), ints((800, 96), -4, 4)
    w = ints((3000,), 0, 2)
    a = assign_stats_cuda(x, centers, w)
    check_repeat("assign_stats k=800", a, assign_stats_cuda(x, centers, w))
    check_equal("assign_stats k=800", a, ref.assign_stats(x, centers, w))
    b0 = ops.bounds_identity(3000, dev)
    zero = torch.zeros((800,), device=dev)
    bnd = assign_stats_bounded_cuda(x, centers, b0.idx, b0.lo, b0.hi, zero, w)
    check_equal("assign_stats_bounded k=800", bnd[:6], a)
    log("phase 2 parity: integer edge cases exact (label_stats at k = 800 and 1,600, d = 1 and "
        "130, k = 1,000 and 2,000 over 60,000 rows four times each, sorted runs, w = None; "
        "assign_stats and assign_stats_bounded at k = 800), repeats bit-identical")


def phase_parity_sim_self(dev):
    """sim_best_edge's two grids on integer rows, s x s x d for s in {1, 127,
    128, 129, 257, 3,536} and d in {1, 3, 33, 130, 2,048}: the self-search
    (one tensor for both row matrices and both label vectors: the tiles on
    and above the diagonal) and the full grid (a copy of the same rows and
    labels), each equal to the plain version bit for bit and repeating its
    bits. Labels hold pads (-1); past one tile a row of tile 0 is repeated in
    tiles 1 and 2, so equal columns sit on both sides of the diagonal tile;
    one more self-search has every row in one component."""
    import numpy as np
    import torch

    from repro_torch import interop
    from repro_torch.kernels import ref
    from repro_torch.kernels.sim_best_edge import sim_best_edge_cuda

    rng = np.random.default_rng(17)
    cases = 0
    for s in (1, 127, 128, 129, 257, 3536):
        for d in (1, 3, 33, 130, 2048):
            x = interop.data(rng.integers(-3, 4, size=(s, d)), dev)
            if s > 256:
                x[130] = x[5]  # the same column in tile 0, tile 1 ...
                x[s - 1] = x[5]  # ... and the last tile
            lab = interop.labels(rng.integers(-1, 6, size=s), dev)  # -1 = pad
            want = ref.sim_best_edge(x, x, lab, lab)
            got = sim_best_edge_cuda(x, x, lab, lab)
            check_repeat(f"sim_best_edge self {s}x{d}", got, sim_best_edge_cuda(x, x, lab, lab))
            check_equal(f"sim_best_edge self {s}x{d}", got, want)
            check_equal(f"sim_best_edge full grid {s}x{d}",
                        sim_best_edge_cuda(x, x.clone(), lab, lab.clone()), want)
            cases += 1
    x = interop.data(rng.integers(-3, 4, size=(300, 40)), dev)
    one = torch.zeros((300,), dtype=torch.int32, device=dev)  # every row in one component
    got = sim_best_edge_cuda(x, x, one, one)
    check_equal("sim_best_edge self, one component", got, ref.sim_best_edge(x, x, one, one))
    if not ((got[0] == -1).all() and (got[1] == ref.NEG).all()):
        raise AssertionError("sim_best_edge self, one component: a row found a candidate")
    log(f"phase 2 parity: sim_best_edge self-search and full grid on {cases} integer cases "
        "(s up to 3,536, d up to 2,048, pads, equal columns across the diagonal tile) and one "
        "component: bit for bit against the plain version, repeats bit-identical")


def phase_parity_main(x, xs, dev):
    """The three kernels at the main path's shapes on real tf-idf rows."""
    import torch

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
        check_equal("sim_best_edge self-search vs full grid (tf-idf rows)", a,
                    sim_best_edge_cuda(xs.clone(), xs, labels.clone(), labels))
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
    errs["assign_stats"] = max(err, check_stats_fold("assign_stats", x, w, K, a))
    log(f"phase 2 parity: main-path shapes within tolerance; max abs err {errs}; "
        f"near-tie index differences {ties}")
    return errs


def phase_timing(x, xs, dev):
    import torch

    s = xs.shape[0]
    g = torch.Generator().manual_seed(2)
    ids = torch.arange(s, dtype=torch.int32, device=dev)
    labels = torch.randint(0, K, (s,), generator=g, dtype=torch.int32).to(dev)
    centers = xs[:K].contiguous()
    rows = {}

    rows["sim_best_edge"] = timing_sim_best_edge(xs, ids)
    rows["label_stats"] = timing_label_stats(x, xs, labels, dev)
    rows["assign_stats"] = timing_assign_stats(x, centers)
    for name, r in rows.items():
        log(f"phase 3 timing {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms ({r['bound'][1]})")
    return rows


def timing_sim_best_edge(xs, labels):
    """sim_best_edge at Buckshot's sample (3,536 x 2,048) with ``labels``:
    the self-search (the resident round's call), the kernels alone
    (profiled), and the full grid on a copy of the rows; the plain version,
    xs @ xs.T, and two bounds: the half product (s(s+1)/2 dot products, what
    the self-search needs) in the kernels line, the full one beside it.
    Only the wrapper's public signature: an older tree is timed the same way."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.sim_best_edge import sim_best_edge_cuda

    s, d = xs.shape
    xc, lc = xs.clone(), labels.clone()
    nbytes = s * d * 4 + s * 4 + s * 8

    def call():
        return sim_best_edge_cuda(xs, xs, labels, labels)

    row = dict(
        ms=event_ms(call, 20),
        distinct_ms=event_ms(lambda: sim_best_edge_cuda(xc, xs, lc, labels), 20),
        profiled_ms=profiled_kernel_ms(call, 10, ("sim_best_edge",)),
        plain_ms=event_ms(lambda: ref.sim_best_edge(xs, xs, labels, labels), 20),
        library_ms=event_ms(lambda: xs @ xs.T, 20),
        bound=bound_ms(1.0 * s * (s + 1) * d, nbytes),
        full_bound=bound_ms(2.0 * s * s * d, nbytes + s * d * 4 + s * 4),
    )
    log(f"phase 3 timing sim_best_edge {s}x{s}x{d}: self-search {row['ms']:.4f} ms (the "
        f"kernels alone, profiled: {row['profiled_ms']:.4f} ms), full grid (a copy of the rows) "
        f"{row['distinct_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, xs @ xs.T "
        f"{row['library_ms']:.4f} ms, bound {row['bound'][0]:.4f} ms ({row['bound'][1]}: half "
        f"product) / {row['full_bound'][0]:.4f} ms (full product)")
    return row


def timing_cbe_round1(xs):
    """component_best_edge at round 1 of Buckshot's sample: the round-0
    merge of the self-search's edges gives the components, a second search
    under them the candidates (w, column), row ids 0..s-1, cap s / 2."""
    import torch

    from repro_torch.core.hac import _dense, _merge_round
    from repro_torch.kernels.sim_best_edge import sim_best_edge_cuda

    s = xs.shape[0]
    ids = torch.arange(s, dtype=torch.int32, device=xs.device)
    bj, bw = sim_best_edge_cuda(xs, xs, ids, ids)
    labels = _merge_round(ids, bw, bj)[0]
    comp = _dense(labels).to(torch.int32)
    bj, bw = sim_best_edge_cuda(xs, xs, labels, labels)
    return timing_cbe((bw, bj, ids, comp), -(-s // 2))


def buckshot_digest(dev):
    """Buckshot (k = 50) on the 1 GB collection through the public entry
    points, as the main path runs it: its RSS and a digest of its labels,
    so two trees timed in one call show the same result."""
    import hashlib

    import torch

    from repro_torch.core.buckshot import buckshot
    from repro_torch.text import pipeline, synth

    corpus = synth.make_corpus(**synth.paper_1gb_shape())
    x, _ = pipeline.prepare_local(corpus, dev)
    res = buckshot(x, K, torch.Generator().manual_seed(SEED))
    labels = res.kmeans.assignment.to(torch.int32).cpu().numpy().tobytes()
    log(f"phase 4 buckshot 1 GB: rss {res.kmeans.rss.item()!r}, labels sha256 "
        f"{hashlib.sha256(labels).hexdigest()[:16]}, sample sha256 "
        f"{hashlib.sha256(res.sample_idx.cpu().numpy().tobytes()).hexdigest()[:16]}")


def timing_assign_stats(x, centers):
    """assign_stats over x at Buckshot's k: kernel, plain, product, bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.assign_stats import assign_stats_cuda

    n, d = x.shape
    k, f4 = centers.shape[0], 4
    flops = 2.0 * n * k * d + 4.0 * n * d
    nbytes = n * d * f4 + k * d * f4 + n * f4 + n * 8 + k * d * f4 + 3 * k * f4
    return dict(
        ms=event_ms(lambda: assign_stats_cuda(x, centers), 10),
        plain_ms=event_ms(lambda: ref.assign_stats_scatter(x, centers), 10),
        library_ms=event_ms(lambda: x @ centers.T, 10),
        bound=bound_ms(flops, nbytes),
    )


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


# the pipelined product tile's edges: rows around a 128-row block, centers
# around the 64-center slab and the 128-center tile, d off the 32-column
# stage and the 16-byte stride (d = 1, 3, 33, 130 go by 4-byte copies;
# 2,048 by the copy engine through a ring wrapped many times)
PIPE_N = (1, 127, 129, 1000)
PIPE_K = (1, 63, 64, 65, 127, 128, 129, 400, 800)
PIPE_D = (1, 3, 33, 130, 2048)


def pipe_edge_case(n, k, d, dev):
    """Integer rows near integer centers, with equal centers on both sides of
    every 64-center slab and 128-center tile boundary and the last center
    equal to the first (it loses every tie: an empty cluster); weights 0-2."""
    import numpy as np

    from repro_torch import interop

    rng = np.random.default_rng(1000 * n + 10 * k + d)
    c = rng.integers(-4, 5, size=(k, d))
    for b in range(64, k, 64):
        c[b] = c[b - 1]
    if k > 1:
        c[k - 1] = c[0]
    x = c[rng.integers(0, k, size=n)] + rng.integers(-1, 2, size=(n, d))
    w = rng.integers(0, 3, size=n)
    return interop.data(x, dev), interop.data(c, dev), interop.data(w, dev)


def phase_parity_pipe_edges(dev) -> None:
    """assign_argmax, assign_stats and assign_stats_bounded on the pipelined
    tile's edges, each run twice and bit-identical: equal to the plain
    versions (bounded: hi an upper bound, exact where the centers fit one
    slab), assign_argmax equal to assign_stats' (idx, best_sim), bounded equal
    to unbounded; at d = 33 and 2,048 also with carried bounds after a move
    (settled rows through the row pass and its gathered centers)."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.assign_argmax import assign_argmax_cuda
    from repro_torch.kernels.assign_stats import assign_stats_bounded_cuda, assign_stats_cuda

    cases = 0
    for d in PIPE_D:
        for n in PIPE_N:
            for k in PIPE_K:
                name = f"pipe edge n={n} k={k} d={d}"
                x, c, w = pipe_edge_case(n, k, d, dev)
                a = assign_argmax_cuda(x, c)
                check_repeat(name + " assign_argmax", a, assign_argmax_cuda(x, c))
                check_equal(name + " assign_argmax", a, ref.assign_argmax(x, c))
                s = assign_stats_cuda(x, c, w)
                check_repeat(name + " assign_stats", s, assign_stats_cuda(x, c, w))
                check_equal(name + " assign_stats", s, ref.assign_stats(x, c, w))
                check_equal(name + " assign_argmax vs assign_stats", a,
                            assign_stats_cuda(x, c)[:2])
                b = _sentinel(n, dev)
                args = (x, c, b.idx, b.lo, b.hi, torch.zeros(k, device=dev), w)
                runs = [("sentinel", args)]
                if d in (33, 2048) and n == 1000:
                    want = ref.assign_stats_bounded(*args)
                    moved = c.clone()
                    moved[0, 0] += 1
                    drift = torch.linalg.vector_norm(moved - c, dim=1)
                    runs.append(("carried", (x, moved, *want[6:9], drift, w)))
                for kind, bargs in runs:
                    got = assign_stats_bounded_cuda(*bargs)
                    check_repeat(f"{name} bounded {kind}", got, assign_stats_bounded_cuda(*bargs))
                    want = ref.assign_stats_bounded(*bargs)
                    check_equal(f"{name} bounded {kind}", got[:8] + got[9:], want[:8] + want[9:])
                    check_bounded_hi(f"{name} bounded {kind}", got[8], want[8])
                    exact = got[9] if k > 64 else torch.ones_like(got[9])
                    if not torch.equal(got[8][exact], want[8][exact]):
                        raise AssertionError(f"{name} bounded {kind}: hi differs where exact")
                    check_equal(f"{name} bounded {kind} vs assign_stats", got[:6],
                                assign_stats_cuda(*bargs[:2], w))
                    if kind == "carried" and k > 1 and not got[9].any():
                        raise AssertionError(f"{name}: carried bounds pruned no row")
                cases += 1
    log(f"phase 2 parity: the pipelined tile's edges exact on {cases} cases (n in {PIPE_N}, k "
        f"in {PIPE_K}, d in {PIPE_D}; ties across slab and tile boundaries), repeats "
        "bit-identical, assign_argmax equal to assign_stats, bounded equal to unbounded")


def bkc_state(x, dev):
    """The BKC slice's centers and bounds over x: BigK = 800 sampled rows
    (k = 400 the first half), their center index, and the carried bounds,
    centers and drift after one bounded K-Means step at k = 400. Only the
    wrappers' and ops' public signatures, so an older tree's kernels take
    the same inputs."""
    import torch

    from repro_torch.common import l2_normalize
    from repro_torch.core import sampling
    from repro_torch.kernels import ops

    n = x.shape[0]
    g = torch.Generator().manual_seed(3)
    pick = sampling.sample_indices(n, BIG_K, g, dev)
    c800 = l2_normalize(x[pick]).contiguous()
    c400 = c800[:BKC_K].contiguous()
    index = ops.build_center_index(c800)
    st0 = ops.assign_stats_bounded(x, c400, _sentinel(n, dev), torch.zeros(BKC_K, device=dev))
    means = st0.sums / torch.clamp(st0.counts, min=1.0)[:, None]
    c1 = torch.where(st0.counts[:, None] > 0, l2_normalize(means), c400).contiguous()
    drift = torch.linalg.vector_norm(c1 - c400, dim=1)
    return c400, c800, index, st0.bounds, c1, drift


def phase_parity_main_bkc(x, dev):
    """The two new kernels on real tf-idf rows at n = 250,000."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.assign_argmax import assign_argmax_cuda
    from repro_torch.kernels.assign_stats import assign_stats_bounded_cuda, assign_stats_cuda

    n = x.shape[0]
    state = bkc_state(x, dev)
    c400, c800, index, bnd, c1, drift = state
    errs, ties = {}, {}

    a = assign_argmax_cuda(x, c400)
    check_repeat("assign_argmax", a, assign_argmax_cuda(x, c400))
    check_equal("assign_argmax vs assign_stats", a, assign_stats_cuda(x, c400)[:2])
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
    return errs, state


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
    err = max(err, parity_cbe_grids(dev, rng))
    log(f"phase 2 parity: component_best_edge edge cases bit for bit against both plain "
        f"versions (max |kernel - plain| {err}), repeats bit-identical")
    return err


def parity_cbe_grids(dev, rng) -> float:
    """component_best_edge's two grids: c and r on either side of the one
    block's limits (its keys in shared memory, its rows in registers), and
    r = 200,000; calls in a row, so the cooperative grid's two key buffers
    alternate and each is found zeroed; -0.0 against +0.0 in every case."""
    import numpy as np

    from repro_torch import interop
    from repro_torch.kernels import ref
    from repro_torch.kernels.component_reduce import _lib

    _, keys, block_rows = _lib()
    err = 0.0
    cases = [(3000, keys), (3000, keys + 1), (block_rows, 300), (block_rows + 1, 300),
             (200_000, 1768), (200_000, keys + 1000), (500, 7), (200_000, 60_000)]
    for r, c in cases:
        w = rng.normal(size=r).astype(np.float32)
        w[::7] = ref.NEG
        w[1], w[2], w[3] = -0.0, 0.0, -0.0
        w[10:20] = w[9]  # duplicate weights: the row id decides
        args = (interop.data(w, dev), interop.labels(rng.integers(-1, 64, size=r), dev),
                interop.labels(rng.permutation(2 * r)[:r], dev),
                interop.labels(rng.integers(-1, c + 1, size=r), dev))
        err = max(err, check_cbe(f"component_best_edge r={r} c={c}", args, c)[1])
    log(f"phase 2 parity: component_best_edge on both grids (one block up to c = {keys}, "
        f"r = {block_rows}; cases {cases}) bit for bit against both plain versions")
    return err


def l2_normalize_twice(xs):
    """The sample as phase 1 searches it: ``_phase1_init_centers`` normalizes,
    and ``boruvka_mst_distributed`` normalizes again."""
    from repro_torch.common import l2_normalize

    return l2_normalize(l2_normalize(xs)).contiguous()


# component_best_edge's kernels by name: this tree's one launch (either
# grid), and the three launches (fill, claim, write_winner) of the earlier
# design, so an older tree's kernels are profiled the same way
CBE_KERNELS = ("cbe_block", "cbe_grid", "fill", "claim", "write_winner")


def timing_cbe(args, cap):
    """component_best_edge at round 1 of the main path (r = 3,536, c = 1,768):
    back to back (for this kernel mostly the host's time to call it), the
    kernels alone on the card (profiled), the plain versions, the library
    yardstick and the bound."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.component_reduce import component_best_edge_cuda

    bw = args[0]
    r = bw.shape[0]
    seg = args[3].long()
    lib_out = torch.full((cap + 1,), float("-inf"), device=bw.device)

    def call():
        return component_best_edge_cuda(*args, cap)

    row = dict(
        ms=event_ms(call, 200),
        profiled_ms=profiled_kernel_ms(call, 50, CBE_KERNELS),
        plain_ms=event_ms(lambda: ref.component_best_edge_segment(*args, cap), 50),
        # no single PyTorch call computes the whole function: the library
        # yardstick is its first pass, one segment max of w (a sink slot
        # takes the dropped ids)
        library_ms=event_ms(lambda: lib_out.scatter_reduce_(0, seg, bw, "amax"), 200),
        bound=bound_ms(0.0, 16 * r + 12 * cap),
    )
    lex = event_ms(lambda: ref.component_best_edge(*args, cap), 50)
    log(f"phase 4 timing component_best_edge r={r} c={cap}: kernel {row['ms']:.4f} ms back to "
        f"back (the kernels alone, profiled: {row['profiled_ms']:.4f} ms), plain (segment) "
        f"{row['plain_ms']:.4f} ms, plain (lexsort) {lex:.4f} ms, library (scatter_reduce_ "
        f"amax) {row['library_ms']:.4f} ms, bound {row['bound'][0]:.6f} ms ({row['bound'][1]}: "
        f"16 B per row + 12 B per segment)")
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


# ------------------------------------------------------ the streaming slice

STREAM_CHUNK = 32_768  # host-resident stream: 8 chunks of the 1 GB collection
REGEN_CHUNK = 8_192  # the JAX package's default chunk for regenerated streams
DECODE_TOL = 2e-5  # flash_decode f32: another summation order and exp
# flash_decode shapes: the kernel bench's cache (f32, length = s) and
# llama3.2-3b's heads (bf16, length 20,000 of a 32,768-slot cache)
DECODE_CASES = {
    "kernel_bench f32": (32, 8, 128, 32_768, "float32", 32_768),
    "llama3.2-3b bf16": (24, 8, 128, 32_768, "bfloat16", 20_000),
}


def event_ms_cold(fn, iters: int, warmup: int = 2, flush_by: str = "write") -> float:
    """Mean device time of one call with the 50 MB L2 flushed before each
    (a pass over 512 MB between calls, outside the timed events; it keeps
    the device busy ~0.2 ms, long enough for the host to enqueue the call,
    so the events time the device and not the host). ``flush_by="write"``
    zeroes the buffer, which leaves up to 50 MB of dirty lines whose
    write-back may share HBM with the timed call; ``"read"`` sums it, which
    leaves the L2 clean."""
    import torch

    flush = torch.zeros(128 * 2**20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        if flush_by == "read":
            flush.sum()
        else:
            flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def profiled_kernel_ms(fn, iters: int, names: tuple[str, ...]) -> float:
    """Device time per call of the kernels whose names contain one of
    ``names``, from torch.profiler over ``iters`` calls: the kernels alone,
    without launch gaps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and any(n in e.key for n in names))
    return us / 1e3 / iters


def check_bf16_ulp(name, got, want) -> float:
    """|got - want| within one bf16 ulp of the plain value: both versions
    round an f32 result to bf16 once."""
    import torch

    w = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=1e-30))) - 7)
    err = (got.float() - w).abs()
    if not (err <= ulp).all():
        i = int((err - ulp).flatten().argmax())
        raise AssertionError(f"{name}: {int((err > ulp).sum())} values beyond one bf16 ulp, "
                             f"the worst {err.flatten()[i].item()!r} at {w.flatten()[i].item()!r}")
    return err.max().item()


def decode_scale(q, k, v, length):
    """For each output, sum_i p_i |v_i| / sum_i p_i in float64: the size of
    the terms the output is summed from, which bounds an f32 summation's
    rounding where the output cancels far below them."""
    import torch

    s, hk, dh = k.shape
    g = q.shape[0] // hk
    logits = torch.einsum("hd,shd->hs", q.double(), k.double().repeat_interleave(g, 1)) / dh**0.5
    if length <= 0:
        logits = torch.zeros_like(logits)
    logits[:, min(length, s) if length > 0 else s:] = -torch.inf
    return torch.einsum("hs,shd->hd", torch.softmax(logits, -1),
                        v.double().abs().repeat_interleave(g, 1))


def check_bf16_scaled(name, got, want, scale) -> float:
    """One bf16 ulp of the plain value plus 16 f32 ulps (2^-20) of the size
    of the output's terms: each logit is an f32 dot product rounded ~10 f32
    ulps from the exact one in either version, so where an output cancels
    far below its terms two right f32 computations differ by more than a
    bf16 ulp; elsewhere the allowance is far below the ulp."""
    import torch

    w = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=1e-30))) - 7)
    err = (got.double() - want.double()).abs()
    bad = err > ulp.double() + 2.0**-20 * scale
    if bad.any():
        i = int(bad.flatten().to(torch.uint8).argmax())
        raise AssertionError(f"{name}: {int(bad.sum())} values beyond one bf16 ulp of the plain value "
                             f"plus one f32 rounding of their terms; the first: kernel "
                             f"{got.flatten()[i].item()!r}, plain {want.flatten()[i].item()!r}")
    return err.max().item()


def best_edge_inputs(xs, dev):
    """The kernel bench's 2,000 x 2,000 N(0, 1) block with 40 components, and
    the main path's round-1 block xs @ xs.T with labels arange(s)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(5)
    sim = torch.randn((2000, 2000), generator=g, device=dev)
    lab = torch.randint(0, 40, (2000,), generator=g, device=dev, dtype=torch.int32)
    s = xs.shape[0]
    return {
        "2000x2000": (sim, lab, lab),
        f"{s}x{s}": (xs @ xs.T, *(2 * [torch.arange(s, dtype=torch.int32, device=dev)])),
    }


def decode_inputs(name, dev):
    import torch

    h, hk, dh, s, dtype, length = DECODE_CASES[name]
    g = torch.Generator(device=dev).manual_seed(6)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(dt)
               for shape in ((h, dh), (s, hk, dh), (s, hk, dh)))  # distinct k and v
    return q, k, v, torch.tensor(length, dtype=torch.int32, device=dev)


def phase_parity_best_edge(xs, dev) -> float:
    """best_edge against its plain version with torch.equal (NaN equal to
    NaN), on integer and float blocks: sizes off the tiles, every alignment
    of a row start (c = 4,097 to 4,100), columns past the labels' staging in
    shared memory (c = 70,001), rows fewer than, equal to and far more than
    the persistent grid's blocks (r = 1, 131, 132, 133, 20,000), ties across
    warp steps and row blocks, rows all in one component, labels -1 on rows
    and columns, -0.0 against +0.0, rows of NaN and of -inf, a block and
    labels that start off 16 bytes, r = 0 and c = 0, the main path's round-1
    block and a block with round-2 labels. Each case runs twice and repeats
    its bits."""
    import numpy as np
    import torch

    from repro_torch import interop
    from repro_torch.core.hac import components_from_edges
    from repro_torch.kernels import ref
    from repro_torch.kernels.best_edge import best_edge_cuda

    rng = np.random.default_rng(3)

    def check(name, sim, lr, lc):
        got = best_edge_cuda(sim, lr, lc)
        check_repeat(f"best_edge {name}", got, best_edge_cuda(sim, lr, lc))
        check_equal(f"best_edge {name}", got, ref.best_edge(sim, lr, lc))
        return got

    shapes = [(300, 270), (1, 129), (33, 1), (13, 1000), (257, 4097), (0, 5), (5, 0),
              (9, 4098), (9, 4099), (9, 4100), (5, 70_001), (131, 257), (132, 257),
              (133, 257), (20_000, 257)]
    for r, c in shapes:
        lr = interop.labels(rng.integers(-1, 5, size=r), dev)  # -1 = pad
        lc = interop.labels(rng.integers(-1, 5, size=c), dev)
        check(f"{r}x{c} integer", interop.data(rng.integers(-3, 4, size=(r, c)), dev), lr, lc)
        check(f"{r}x{c} float", interop.data(rng.normal(size=(r, c)), dev), lr, lc)
    r, c = 70, 1500
    sim = torch.full((r, c), -1.0, device=dev)
    sim[:, [37, 300, 1300]] = 2.0  # the row max in three warp steps
    sim[11] = 0.0
    sim[11, :200] = -0.0  # -0.0 and +0.0 tie
    lr = torch.zeros((r,), dtype=torch.int32, device=dev)
    lc = torch.ones((c,), dtype=torch.int32, device=dev)
    lc[37] = -1  # a pad column: 300 wins
    lr[5], lr[9] = 1, -1  # a row in the columns' component, a pad row
    j, _ = check("ties", sim, lr, lc)
    if j[[0, 69, 5, 9, 11]].tolist() != [300, 300, -1, -1, 0]:
        raise AssertionError(f"best_edge ties: {j[[0, 69, 5, 9, 11]].tolist()}")
    # the same block and labels one float past a 16-byte boundary
    off = [torch.empty((t.numel() + 1,), dtype=t.dtype, device=dev) for t in (sim, lc)]
    off[0][1:], off[1][1:] = sim.flatten(), lc
    check("ties, off 16 bytes", off[0][1:].view(r, c), lr, off[1][1:])
    # every column a candidate: a row of -inf (column 0), -inf but one f32.min
    # (none), NaN at 333 and 555 (333), NaN in a pad row and in a row of one
    # component (none); with a pad column: -inf everywhere (none)
    r, c = 6, 1003
    sim = interop.data(rng.normal(size=(r, c)), dev)
    sim[0] = sim[1] = sim[5] = -torch.inf
    sim[1, 777] = ref.NEG
    sim[2:5, 333] = sim[2:5, 555] = torch.nan
    lr = torch.tensor([0, 0, 0, -1, 1, 0], dtype=torch.int32, device=dev)
    lc = torch.ones((c,), dtype=torch.int32, device=dev)
    j, v = check("NaN and -inf rows", sim[:5].contiguous(), lr[:5].contiguous(), lc)
    lc[900] = -1
    j5, _ = check("-inf with a pad column", sim[5:].contiguous(), lr[5:].contiguous(), lc)
    if (j.tolist() + j5.tolist() != [0, -1, 333, -1, -1, -1] or v[0].item() != -torch.inf
            or not v[2].isnan().item()):
        raise AssertionError(f"best_edge NaN and -inf rows: {j.tolist()}, {v.tolist()}")
    s = xs.shape[0]
    ids = torch.arange(s, dtype=torch.int32, device=dev)
    sim = xs @ xs.T
    j1, _ = check("main path round 1", sim, ids, ids)
    comp = components_from_edges(s, ids, torch.where(j1 >= 0, j1, ids), j1 >= 0)
    check("main path round 2", sim, comp, comp)
    log(f"phase 2 parity: best_edge equal to its plain version on every case ({len(shapes)} "
        f"shapes: every row alignment, c = 70,001 past the staged labels, r = 1 to 20,000 "
        f"around the grid; ties across warp steps and row blocks, pads, one component, -0.0, "
        f"NaN and -inf rows, a block and labels off 16 bytes, r = 0, c = 0, the main path's "
        f"round-1 block and its round-2 labels: {int(torch.unique(comp).shape[0])} "
        f"components), repeats bit-identical")
    return 0.0


def phase_parity_flash_decode(dev) -> float:
    """flash_decode against its plain version at length 0, 1, 511, 512, 513,
    20,000, s and s + 7 with g = 1, 3 and 4, f32 (max abs err <= 2e-5) and
    bf16 (within one bf16 ulp); the length as a device tensor and as an int
    give the same bits."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_decode import flash_decode_cuda

    hk, dh, s = 8, 128, 32_768
    g = torch.Generator(device=dev).manual_seed(4)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        k, v = (torch.randn((s, hk, dh), generator=g, device=dev).to(dtype) for _ in range(2))
        for grp in (1, 3, 4):
            q = torch.randn((hk * grp, dh), generator=g, device=dev).to(dtype)
            for length in (0, 1, 511, 512, 513, 20_000, s, s + 7):
                got = flash_decode_cuda(q, k, v, torch.tensor(length, dtype=torch.int32, device=dev))
                check_repeat("flash_decode", (got,), (flash_decode_cuda(q, k, v, length),))
                want = ref.flash_decode(q, k, v, length)
                name = f"flash_decode {dtype} g={grp} length={length}"
                if dtype == torch.float32:
                    err = (got - want).abs().max().item()
                    if err > DECODE_TOL:
                        raise AssertionError(f"{name}: max abs err {err} > {DECODE_TOL}")
                else:
                    err = check_bf16_ulp(name, got, want)
                errs[str(dtype)] = max(errs.get(str(dtype), 0.0), err)
    # g = 12 (two blocks of heads), dh = 64, 256 and 30 (no copy engine: rows
    # off 128 bytes), lengths at a tile and a range boundary and past s
    for h, hk, dh, s in [(96, 8, 128, 4096), (16, 4, 64, 4096), (8, 2, 256, 4096), (6, 2, 30, 700)]:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
                       for shape in ((h, dh), (s, hk, dh), (s, hk, dh)))
            for length in (0, 1, 64, 65, 1024, 1025, s, s + 7):
                got = flash_decode_cuda(q, k, v, length)
                want = ref.flash_decode(q, k, v, length)
                name = f"flash_decode {dtype} h={h} hk={hk} dh={dh} s={s} length={length}"
                if dtype == torch.float32:
                    err = (got - want).abs().max().item()
                    if err > DECODE_TOL:
                        raise AssertionError(f"{name}: max abs err {err} > {DECODE_TOL}")
                else:
                    err = check_bf16_scaled(name, got, want, decode_scale(q, k, v, length))
                errs[str(dtype)] = max(errs.get(str(dtype), 0.0), err)
    # the per-kv-head ticket counters are back at 0 after every call: a call
    # of another shape between two equal calls on one stream changes nothing
    q, k, v = (torch.randn(shape, generator=g, device=dev) for shape in ((24, 128), (3000, 8, 128),
                                                                         (3000, 8, 128)))
    first = flash_decode_cuda(q, k, v, 2500)
    flash_decode_cuda(q[:4].contiguous(), k[:, :2].contiguous(), v[:, :2].contiguous(), 900)
    check_repeat("flash_decode after another shape", (first,), (flash_decode_cuda(q, k, v, 2500),))
    log(f"phase 2 parity: flash_decode at 8 lengths x g = 1, 3, 4 (hk = 8, dh = 128, s = 32,768), "
        f"and at g = 12, dh = 64, 256, 30 (8 lengths each, the tile and range boundaries and "
        f"past s; bf16 plus 16 f32 ulps of each output's terms): max abs err "
        f"{errs} (f32 limit {DECODE_TOL}; bf16 within one ulp), repeats "
        f"bit-identical, the ticket counters reset between calls")
    return errs["torch.float32"]


def phase_timing_stream_kernels(xs, dev):
    """best_edge and flash_decode: kernel, plain version, one library call
    and the bound, at the kernel bench's and the main path's shapes. Returns
    the rows of the kernels line (best_edge at the main path's block,
    flash_decode at the kernel bench's cache) and the others."""
    rows = timing_best_edge(xs, dev)
    rows.update(timing_flash_decode(dev))
    return rows


def timing_best_edge(xs, dev):
    """best_edge at the kernel bench's 2,000 x 2,000 block and at
    xs @ xs.T with round-1 labels: the kernel and torch.max(sim, 1) with the
    L2 flushed before each call by a 512 MB write (the kernels line) and by a
    512 MB read (the L2 left clean), the kernel back to back and alone
    (profiled), the plain version and the bound. Only best_edge_cuda's
    public signature: an older tree's kernel is timed the same way."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.best_edge import best_edge_cuda

    rows = {}
    one = torch.zeros((1, 1), device=dev), *(2 * [torch.zeros((1,), dtype=torch.int32, device=dev)])
    floor = event_ms_cold(lambda: best_edge_cuda(*one), 30, flush_by="read")
    for name, (sim, lr, lc) in best_edge_inputs(xs, dev).items():
        r, c = sim.shape

        def call():
            return best_edge_cuda(sim, lr, lc)

        def library():
            return torch.max(sim, dim=1)

        # bytes: the rows a candidate can come from (a pad row's answer
        # needs none of its columns), both label vectors, both outputs
        live = int((lr >= 0).sum())
        row = dict(
            ms=event_ms_cold(call, 30),
            plain_ms=event_ms_cold(lambda: ref.best_edge(sim, lr, lc), 10),
            library_ms=event_ms_cold(library, 30),
            warm_ms=event_ms(call, 30),
            bound=bound_ms(0.0, live * c * 4 + (r + c) * 4 + r * 8),
            profiled_ms=profiled_kernel_ms(call, 20, ("best_edge_rows",)),
            clean_ms=event_ms_cold(call, 30, flush_by="read"),
            library_clean_ms=event_ms_cold(library, 30, flush_by="read"),
            read_ms=event_ms_cold(lambda: torch.amax(sim), 30, flush_by="read"),
        )
        rows[f"best_edge {name}"] = row
        b = row["bound"][0]
        log(f"phase 3 timing best_edge {name} (L2 flushed before each call): kernel "
            f"{row['ms']:.4f} ms after a 512 MB write, {100 * b / row['ms']:.1f} % of the bound; "
            f"{row['clean_ms']:.4f} ms after a 512 MB read (the L2 left clean), "
            f"{100 * b / row['clean_ms']:.1f} % of the bound (back to back, L2 warm: "
            f"{row['warm_ms']:.4f} ms; the kernel alone, profiled, L2 warm: "
            f"{row['profiled_ms']:.4f} ms), plain {row['plain_ms']:.4f} ms, library "
            f"torch.max(sim, dim=1) {row['library_ms']:.4f} ms after the write, "
            f"{row['library_clean_ms']:.4f} ms after the read (the unmasked row max only), "
            f"bound {b:.4f} ms ({row['bound'][1]}: {live}*{c}*4 B read, no arithmetic); "
            f"after the read, torch.amax(sim) (one read of the block) {row['read_ms']:.4f} ms "
            f"and the kernel on a 1 x 1 block (launch and events) {floor:.4f} ms")
    return rows


def phase_ops_stream_kernels(xs, dev):
    """The two kernels' path: ops.best_edge and ops.flash_decode at the
    phase 3 shapes, with the launch counters set to 0 before and read
    after."""
    import torch

    from repro_torch.kernels import ops, ref

    be = best_edge_inputs(xs, dev)
    dec = {name: decode_inputs(name, dev) for name in DECODE_CASES}
    ops.reset_launch_counts()
    outs = [ops.best_edge(*args) for args in be.values()]
    dec_outs = [ops.flash_decode(*args) for args in dec.values()]
    counts = ops.launch_counts()
    for got, args in zip(outs, be.values()):
        check_equal("ops.best_edge", got, ref.best_edge(*args))
    for got, (name, args) in zip(dec_outs, dec.items()):
        want = ref.flash_decode(*args)
        if got.dtype == torch.float32:
            if (got - want).abs().max().item() > DECODE_TOL:
                raise AssertionError(f"ops.flash_decode {name}: beyond {DECODE_TOL}")
        else:
            check_bf16_ulp(f"ops.flash_decode {name}", got, want)
    others = {k: v for k, v in counts.items() if k not in ("best_edge", "flash_decode")}
    if counts["best_edge"] != 2 or counts["flash_decode"] != 2 or any(others.values()):
        raise AssertionError(f"ops.best_edge / ops.flash_decode did not run on their kernels: {counts}")
    log(f"phase 4 ops.best_edge ({', '.join(be)}) and ops.flash_decode ({', '.join(dec)}): "
        f"outputs held to the plain versions; launches {counts}")
    return counts


def stream_run(fn, *args, **kwargs):
    """One streaming fit: (result, wall s, launch counts, device memory it
    took above what was allocated before it)."""
    import torch

    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out, wall = sync_time(fn, *args, **kwargs)
    return out, wall, ops.launch_counts(), torch.cuda.max_memory_allocated() - base


def profile_stream(label, fn, *args, **kwargs) -> str:
    """One streaming fit under torch.profiler: the device's busy share (the
    union of kernel and copy intervals over the wall time: the copies run on
    a side stream), the host-to-device copies' time and bytes, and how much
    of the copy time overlapped kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = sync_time(lambda: fn(*args, **kwargs))
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ev:
        return f"{label}: the profiler recorded no device time (not measured)"
    spans = sorted((e.time_range.start, e.time_range.end) for e in ev)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for a, b in spans[1:]:
        if a > cur_e:
            busy, cur_s, cur_e = busy + cur_e - cur_s, a, b
        else:
            cur_e = max(cur_e, b)
    busy = (busy + cur_e - cur_s) / 1e6
    copies = [e for e in ev if "HtoD" in e.name]
    copy_s = sum(e.time_range.end - e.time_range.start for e in copies) / 1e6
    kern_s = sum(e.time_range.end - e.time_range.start for e in ev if "Memcpy" not in e.name
                 and "Memset" not in e.name) / 1e6
    overlap = max(0.0, kern_s + copy_s - busy)
    return (f"{label} (profiled): wall {wall:.4f} s, device busy {busy:.4f} s "
            f"({100 * busy / wall:.1f}%), kernels {kern_s:.4f} s, host-to-device copies "
            f"{len(copies)} taking {copy_s:.4f} s, overlap of copies and kernels ~{overlap:.4f} s")


def stream_report(name, wall, passes, pass_bytes, counts, peak, extra=""):
    log(f"phase 4 {name}: {wall:.4f} s, {passes} passes, {wall / passes:.4f} s per pass; "
        f"{passes * pass_bytes / 2**30:.2f} GiB copied to the card "
        f"({passes * pass_bytes / wall / 1e9:.1f} GB/s of wall time); device memory above the "
        f"resident state {peak / 2**20:.0f} MiB; launches {counts}{extra}")


def agreement(a, b) -> float:
    return (a.cpu() == b.cpu()).double().mean().item()


def rel(a, b) -> float:
    return abs(float(a) - float(b)) / abs(float(b))


def phase_stream_host(x, dev):
    """Streaming K-Means, Buckshot and BKC over the 1 GB collection's tf-idf
    rows held in host memory (CorpusStream.from_array, 8 chunks of 32,768
    rows, the last with 12,144 pad rows), held against the resident fits on
    the card. Returns the stream, its host rows and each fit with its
    initial centers, for the checkpoint phase."""
    import os

    import torch

    from repro_torch.common import l2_normalize
    from repro_torch.core import sampling
    from repro_torch.core.bkc import bkc_fit, bkc_fit_stream
    from repro_torch.core.buckshot import buckshot_fit, buckshot_stream
    from repro_torch.core.kmeans import init_random_centers, kmeans_fit, kmeans_fit_stream
    from repro_torch.text.stream import CorpusStream

    n, d = x.shape
    t = time.perf_counter()
    x_host = x.cpu().numpy()
    st = CorpusStream.from_array(x_host, chunk=STREAM_CHUNK)
    nch = st.n_chunks
    pass_bytes = nch * STREAM_CHUNK * (d + 1) * 4  # x and w of every chunk
    log(f"phase 4 streaming from host memory: x {x_host.nbytes / 1e9:.2f} GB on the host "
        f"({time.perf_counter() - t:.2f} s to copy it there), {nch} chunks of {STREAM_CHUNK} "
        f"rows, the last with {nch * STREAM_CHUNK - n} pad rows")

    # (1) K-Means, k = 50, from the baseline's initial centers
    init = init_random_centers(x, K, torch.Generator().manual_seed(SEED))
    res, t_res = sync_time(kmeans_fit, x, init, K)
    km, wall, counts, peak = stream_run(kmeans_fit_stream, st, init, K)
    passes = km.iterations + 1
    check_result("kmeans_fit_stream", km, n, d)
    agree, r = agreement(km.assignment, res.assignment), rel(km.rss, res.rss)
    stream_report(f"kmeans_fit_stream k={K}", wall, passes, pass_bytes, counts, peak,
                  f"; resident kmeans_fit {t_res:.4f} s ({t_res / passes:.4f} s per pass); "
                  f"{km.iterations} iterations (resident {res.iterations}), agreement {agree}, "
                  f"rss {km.rss.item()} vs {res.rss.item()} (rel {r:.2e})")
    if not (km.iterations == res.iterations and agree >= 0.999 and r <= 1e-4):
        raise AssertionError("kmeans_fit_stream disagrees with the resident fit")
    if counts["assign_stats"] != passes * nch:
        raise AssertionError(f"kmeans_fit_stream: {counts['assign_stats']} assign_stats "
                             f"launches, expected {passes} passes x {nch} chunks")
    os.environ["REPRO_STREAM_PREFETCH"] = "0"
    try:
        off, wall_off, _, peak_off = stream_run(kmeans_fit_stream, st, init, K)
    finally:
        del os.environ["REPRO_STREAM_PREFETCH"]
    if not (torch.equal(off.centers, km.centers) and torch.equal(off.assignment, km.assignment)
            and torch.equal(off.rss, km.rss)):
        raise AssertionError("kmeans_fit_stream: prefetch on and off give other bits")
    one, wall_one, _, peak_one = stream_run(kmeans_fit_stream, CorpusStream.from_array(x_host),
                                            init, K)
    if not (torch.equal(one.centers, res.centers)
            and torch.equal(one.assignment, res.assignment.cpu())
            and torch.equal(one.rss, res.rss) and one.iterations == res.iterations):
        raise AssertionError("kmeans_fit_stream on one chunk differs from kmeans_fit")
    log(f"phase 4 kmeans_fit_stream: prefetch off {wall_off:.4f} s ({wall_off / passes:.4f} s per "
        f"pass, {peak_off / 2**20:.0f} MiB), the same bits as prefetch on; one chunk of {n} rows "
        f"{wall_one:.4f} s ({peak_one / 2**20:.0f} MiB), equal to kmeans_fit bit for bit")
    log("phase 4 profile " + profile_stream("kmeans_fit_stream", kmeans_fit_stream, st, init, K))
    ctx = {"st": st, "x_host": x_host, "kmeans": (init, km)}

    # (2) Buckshot, k = 50 (s = 3,536), 3 K-Means iterations
    s = sampling.buckshot_sample_size(n, K)
    bs, wall, counts, peak = stream_run(
        buckshot_stream, st, K, torch.Generator().manual_seed(SEED), device=dev)
    check_result("buckshot_stream", bs.kmeans, n, d)
    rows, ids = sampling.reservoir_sample_stream(
        st, s, torch.Generator().manual_seed(SEED), device=dev)
    if not (torch.equal(torch.from_numpy(ids), bs.sample_idx) and ids.shape == (s,)
            and len(set(ids.tolist())) == s and 0 <= ids.min() and ids.max() < n):
        raise AssertionError("reservoir_sample_stream: not s distinct real rows, or not repeated")
    if not torch.equal(rows.cpu(), torch.from_numpy(x_host[ids])):
        raise AssertionError("reservoir_sample_stream: rows differ from x at their ids")
    want = buckshot_fit(x, torch.from_numpy(ids).to(dev).long(), K)
    passes = 1 + bs.kmeans.iterations + 1
    agree, r = agreement(bs.kmeans.assignment, want.kmeans.assignment), rel(bs.kmeans.rss, want.kmeans.rss)
    stream_report(f"buckshot_stream k={K}", wall, passes, pass_bytes, counts, peak,
                  f"; s={s} distinct real ids, rows equal x_host at them; agreement with resident "
                  f"buckshot_fit on those ids {agree}, rss rel {r:.2e}")
    if agree < 0.999 or r > 1e-4:
        raise AssertionError("buckshot_stream disagrees with the resident fit on its sample")
    if not (counts["sim_best_edge"] >= 1 and counts["label_stats"] >= 1
            and counts["assign_stats"] == (bs.kmeans.iterations + 1) * nch):
        raise AssertionError(f"buckshot_stream did not go through its kernels: {counts}")
    log("phase 4 profile " + profile_stream(
        "buckshot_stream", buckshot_stream, st, K, torch.Generator().manual_seed(SEED), device=dev))
    ctx["buckshot"] = bs

    # (3) BKC, k = 400, BigK = 800, from phase 4's BKC draw, bounded and not
    pick = sampling.sample_indices(n, BIG_K, torch.Generator().manual_seed(SEED), dev)
    init = l2_normalize(x[pick])
    want, t_res = sync_time(bkc_fit, x, init, BIG_K, BKC_K)
    got = {}
    for bounded in (True, False):
        got[bounded], wall, counts, peak = stream_run(
            bkc_fit_stream, st, init, BIG_K, BKC_K, bounded=bounded)
        kernel = "assign_stats_bounded" if bounded else "assign_stats"
        stream_report(f"bkc_fit_stream k={BKC_K} BigK={BIG_K} bounded={bounded}", wall, 2,
                      pass_bytes, counts, peak, f"; resident bkc_fit {t_res:.4f} s")
        if counts[kernel] != 2 * nch:
            raise AssertionError(f"bkc_fit_stream: {counts[kernel]} {kernel} launches, "
                                 f"expected 2 passes x {nch} chunks")
    a, b = got[True], got[False]
    if not all(torch.equal(getattr(a, f), getattr(b, f)) for f in
               ("centers", "assignment", "group_of_mc", "threshold", "rss")):
        raise AssertionError("bkc_fit_stream: bounded and unbounded differ")
    check_result("bkc_fit_stream", a, n, d, BKC_K)
    same_groups = torch.equal(a.group_of_mc, want.group_of_mc)
    agree, r = agreement(a.assignment, want.assignment), rel(a.rss, want.rss)
    log(f"phase 4 bkc_fit_stream: bounded and unbounded equal bit for bit; threshold "
        f"{a.threshold.item()!r} (resident {want.threshold.item()!r}); groups equal the resident "
        f"bkc_fit's: {same_groups}; agreement {agree}, rss rel {r:.2e}")
    if not same_groups:
        from repro_torch.core.kmeans import _stream_pass
        from repro_torch.core.microcluster import (
            MicroClusters,
            build_microclusters,
            pair_similarity,
        )

        sums, counts_mc, min_sim, sumsq = _stream_pass(st, init, BIG_K).stats
        valid = counts_mc > 0
        mc = MicroClusters(counts_mc, sums, sumsq, init, torch.where(valid, min_sim, 1.0), valid)
        pair = pair_similarity(mc)[0]
        pair_res = pair_similarity(build_microclusters(x, init, BIG_K)[0])[0]
        flipped = (pair >= a.threshold) != (pair_res >= want.threshold)
        gap = (pair[flipped] - a.threshold).abs().max().item() if flipped.any() else float("inf")
        log(f"phase 4 bkc_fit_stream: {int(flipped.sum()) // 2} edges differ, the farthest "
            f"{gap!r} from the threshold")
        if gap >= 1e-5:
            raise AssertionError("bkc_fit_stream: groups differ from the resident fit's, "
                                 "not at a near-tie")
    elif agree < 0.999 or r > 1e-4:
        raise AssertionError("bkc_fit_stream disagrees with the resident fit")
    log("phase 4 profile " + profile_stream(
        "bkc_fit_stream bounded", bkc_fit_stream, st, init, BIG_K, BKC_K, bounded=True))
    ctx["bkc"] = (init, a)
    return ctx


# ---------------------------------------------------- the resilience slice

# the killed and resumed child of phase_stream_checkpoint: the port alone, on
# the card, over the rows the parent wrote (memory-mapped)
RESUME_CHILD = """
import json, os, sys

import numpy as np
import torch

sys.path.insert(0, os.environ["SRC"])
from repro_torch.core.kmeans import kmeans_fit_stream
from repro_torch.kernels import ops
from repro_torch.resilience import DiskCheckpointer
from repro_torch.text.stream import CorpusStream

assert "jax" not in sys.modules and "repro" not in sys.modules
d = os.environ["DIR"]
st = CorpusStream.from_array(np.load(os.path.join(d, "x.npy"), mmap_mode="r"),
                             chunk=int(os.environ["CHUNK"]))
init = torch.from_numpy(np.load(os.path.join(d, "init.npy"))).cuda()
ck = DiskCheckpointer(os.path.join(d, "ckpt"), every=2)
ops.reset_launch_counts()
res = kmeans_fit_stream(st, init, int(os.environ["K"]), checkpoint=ck)
torch.cuda.synchronize()
np.savez(os.path.join(d, "out.npz"), centers=res.centers.cpu().numpy(),
         assignment=res.assignment.numpy(), best_sim=res.best_sim.numpy(),
         rss=res.rss.cpu().numpy(), iterations=res.iterations)
print(json.dumps(ops.launch_counts()))
"""


def same_bits(name, got, want, fields):
    """Every field of two results equal bit for bit (tensors moved to the
    host)."""
    import torch

    differ = [f for f in fields if not torch.equal(torch.as_tensor(getattr(got, f)).cpu(),
                                                   torch.as_tensor(getattr(want, f)).cpu())]
    if differ:
        raise AssertionError(f"{name}: the resumed run differs from the uninterrupted one in {differ}")


def stored(ck) -> list:
    """What a MemoryCheckpointer or DiskCheckpointer still holds."""
    import os

    if hasattr(ck, "_store"):
        return sorted(ck._store)
    return sorted(f for f in os.listdir(ck.directory) if f.endswith(".ckpt"))


def cut_and_resume(name, run, specs, expect, kernel, want, fields, ck=None):
    """Cut ``run(checkpoint)`` by an injected producer fault at each of
    ``specs`` in turn, then run it to its end; every run resumes from the
    checkpointer's state (``ck``, a MemoryCheckpointer with every=2 by
    default). ``expect`` is each run's count of ``kernel`` launches (one a
    folded chunk). The last run must give ``want``'s bits and leave the
    store empty; it is returned."""
    from repro_torch.kernels import ops
    from repro_torch.resilience import MemoryCheckpointer
    from repro_torch.testing import faults
    from repro_torch.testing.faults import InjectedFault

    store = type(ck).__name__ if ck is not None else "MemoryCheckpointer"
    ck = MemoryCheckpointer(every=2) if ck is None else ck
    launches = []
    for spec in specs:
        ops.reset_launch_counts()
        with faults.inject(spec):
            try:
                run(ck)
            except InjectedFault:
                pass
            else:
                raise AssertionError(f"{name}: {spec} did not cut the run")
        launches.append(ops.launch_counts()[kernel])
        if not stored(ck):
            raise AssertionError(f"{name}: nothing was stored before the cut at {spec}")
    got, wall, counts, _ = stream_run(run, ck)
    launches.append(counts[kernel])
    same_bits(name, got, want, fields)
    if stored(ck):
        raise AssertionError(f"{name}: the store still holds {stored(ck)}")
    if launches != expect:
        raise AssertionError(f"{name}: {kernel} launches {launches}, expected {expect} (the "
                             "chunks each run folds)")
    log(f"phase 4 checkpoint {name}: cut at {', '.join(specs)} ({store}, every=2) "
        f"and resumed: equal to the uninterrupted run bit for bit ({', '.join(fields)}); "
        f"{kernel} launches per run {launches}, the chunks each folded; the resumed run "
        f"{wall:.4f} s; store empty")
    return got


def snapshot_ms(ck, carry, reps: int = 5) -> tuple[int, float]:
    """(pickled bytes, median seconds) of one snapshot of ``carry`` into
    ``ck``: the copy to the host, the pickle and the store's write."""
    import torch

    from repro_torch.resilience import carry_fingerprint, carry_to_host

    fp, ts = carry_fingerprint(carry), []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ck.save("probe", chunk=2, carry_host=carry_to_host(carry), fingerprint=fp, meta={})
        ts.append(time.perf_counter() - t)
    nbytes = len(ck._get("snap/probe"))
    ck.delete("probe")
    return nbytes, sorted(ts)[reps // 2]


def phase_stream_checkpoint(ctx, card: str, dev):
    """Checkpointed streaming fits over phase 4's host rows (8 chunks of
    32,768): kmeans_fit_stream, bounded bkc_fit_stream and buckshot_stream
    cut in process inside an iteration pass and inside the final pass and
    resumed; kmeans_fit_stream SIGKILLed in a child process and resumed from
    its DiskCheckpointer directory; the cost of the snapshots."""
    import os
    import shutil
    import signal
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core.bkc import bkc_fit_stream
    from repro_torch.core.buckshot import buckshot_stream
    from repro_torch.core.kmeans import _stream_pass, kmeans_fit_stream
    from repro_torch.resilience import DiskCheckpointer

    st, nch = ctx["st"], ctx["st"].n_chunks
    km_fields = ("centers", "assignment", "best_sim", "rss", "objective", "iterations")

    # (1) in process. K-Means: chunk 5 of iteration 2 (snapshot at 4), then
    # on the resumed run chunk 7 of the final pass (snapshot at 6)
    init, km = ctx["kmeans"]
    it = km.iterations
    if it < 3:
        raise AssertionError(f"kmeans_fit_stream ran {it} iterations; the cuts need 3")
    cut_and_resume(
        f"kmeans_fit_stream k={K}", lambda ck: kmeans_fit_stream(st, init, K, checkpoint=ck),
        [f"raise@g{2 * nch + 5}", f"raise@g{(it - 2) * nch + 7}"],
        [2 * nch + 5, (nch - 4) + (it - 3) * nch + 7, nch - 6], "assign_stats", km, km_fields)
    # BKC bounded: chunk 5 of the micro-cluster pass, then chunk 7 of pass 3
    init_b, bkc = ctx["bkc"]
    cut_and_resume(
        f"bkc_fit_stream k={BKC_K} BigK={BIG_K} bounded",
        lambda ck: bkc_fit_stream(st, init_b, BIG_K, BKC_K, bounded=True, checkpoint=ck),
        ["raise@g5", f"raise@g{nch + 7}"], [5, (nch - 4) + 7, nch - 6], "assign_stats_bounded",
        bkc, km_fields[:-1] + ("group_of_mc", "threshold"))
    # Buckshot: chunk 5 of phase 2's iteration 0 (after the reservoir's
    # pass), then chunk 7 of its final pass (the sample from its result)
    bs = ctx["buckshot"]
    ib = bs.kmeans.iterations
    sample = {}

    def run(ck):
        out = buckshot_stream(st, K, torch.Generator().manual_seed(SEED), device=dev, checkpoint=ck)
        sample["last"] = out
        return out.kmeans

    cut_and_resume(
        f"buckshot_stream k={K}", run, [f"raise@g{nch + 5}", f"raise@g{ib * nch + 7}"],
        [5, (nch - 4) + (ib - 1) * nch + 7, nch - 6], "assign_stats", bs.kmeans, km_fields)
    same_bits("buckshot_stream", sample["last"], bs, ("sample_idx", "sample_labels", "init_centers"))

    # (2) across a real SIGKILL: the child dies at chunk 7 of the final pass
    root = Path(__file__).resolve().parent
    (root / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="ckpt_smoke_", dir=root / "build")
    try:
        t = time.perf_counter()
        np.save(os.path.join(tmp, "x.npy"), ctx["x_host"])
        np.save(os.path.join(tmp, "init.npy"), init.cpu().numpy())
        t_write = time.perf_counter() - t
        env = dict(os.environ, SRC=str(root / "src"), DIR=tmp, CHUNK=str(STREAM_CHUNK), K=str(K),
                   REPRO_FAULTS=f"kill@g{it * nch + 7}")
        env.pop("REPRO_STREAM_PREFETCH", None)
        t = time.perf_counter()
        killed = subprocess.run([sys.executable, "-c", RESUME_CHILD], env=env,
                                capture_output=True, text=True, timeout=600)
        t_killed = time.perf_counter() - t
        ckdir = os.path.join(tmp, "ckpt")
        left = sorted(os.listdir(ckdir)) if os.path.isdir(ckdir) else []
        if killed.returncode != -signal.SIGKILL:
            raise AssertionError(f"the child was to die by SIGKILL, rc={killed.returncode}:\n"
                                 f"{killed.stdout}\n{killed.stderr}")
        if not any(f.startswith("snap_kmeans_final") for f in left):
            raise AssertionError(f"the killed child left no snapshot of its final pass: {left}")
        del env["REPRO_FAULTS"]
        t = time.perf_counter()
        resumed = subprocess.run([sys.executable, "-c", RESUME_CHILD], env=env,
                                 capture_output=True, text=True, timeout=600)
        t_resumed = time.perf_counter() - t
        if resumed.returncode != 0:
            raise AssertionError(f"the resumed child failed:\n{resumed.stdout}\n{resumed.stderr}")
        counts = json.loads(resumed.stdout.strip().splitlines()[-1])
        out = np.load(os.path.join(tmp, "out.npz"))
        got = {f: torch.from_numpy(out[f]) for f in ("centers", "assignment", "best_sim", "rss")}
        got["iterations"] = int(out["iterations"])
        same_bits("SIGKILLed kmeans_fit_stream", SimpleNamespace(**got), km,
                  ("centers", "assignment", "best_sim", "rss", "iterations"))
        after = [f for f in os.listdir(ckdir) if f.endswith(".ckpt")]
        if after or counts["assign_stats"] not in (nch - 4, nch - 6):
            raise AssertionError(f"the resumed child left {after}, or folded "
                                 f"{counts['assign_stats']} chunks")
        log(f"phase 4 checkpoint SIGKILL: x ({ctx['x_host'].nbytes / 1e9:.2f} GB) and the initial "
            f"centers written to {Path(tmp).name}/ in {t_write:.2f} s; the child "
            f"(kmeans_fit_stream, DiskCheckpointer every=2, REPRO_FAULTS=kill@g{it * nch + 7}) died "
            f"by SIGKILL after {t_killed:.2f} s leaving {len(left)} files ({', '.join(left)}); "
            f"rerun without the fault {t_resumed:.2f} s (the process included): equal to the "
            f"uninterrupted fit bit for bit, {counts['assign_stats']} assign_stats launches (the "
            f"final pass from its snapshot), no .ckpt left")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (3) the cost: one iteration pass at the fit's centers, with no
    # checkpoint, every=2 (3 snapshots) and every=8 (none: the load and the
    # delete only), in turns, five times
    tmp = tempfile.mkdtemp(prefix="ckpt_cost_", dir=root / "build")
    try:
        stores = {"none": None, "every=2": DiskCheckpointer(os.path.join(tmp, "a"), every=2),
                  "every=8": DiskCheckpointer(os.path.join(tmp, "b"), every=8)}
        walls = {name: [] for name in stores}
        for _ in range(5):
            for name, ck in stores.items():
                _, wall = sync_time(_stream_pass, st, km.centers, K, pass_id="cost", checkpoint=ck)
                walls[name].append(wall)
        out = _stream_pass(st, km.centers, K, collect=True)
        zero, s, six = torch.zeros((), device=dev), bs.sample_idx.shape[0], 6 * STREAM_CHUNK
        probes = {  # the carries run_pass snapshots, at their sizes
            "kmeans iteration carry": (out.stats, zero, [], []),
            "kmeans final carry at chunk 6": (out.stats, zero, [out.idx[:six]],
                                              [out.best_sim[:six]]),
            "reservoir carry": (torch.zeros(s, device=dev), bs.sample_idx.to(dev, torch.int32),
                                torch.zeros((s, st.dim), device=dev)),
        }
        snaps = {name: snapshot_ms(stores["every=2"], carry) for name, carry in probes.items()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    base = sorted(walls["none"])[2]
    log(f"phase 4 checkpoint cost ({card}; DiskCheckpointer under build/, one kmeans_fit_stream "
        f"iteration pass, k={K}, {nch} chunks, five runs each in turns): "
        + "; ".join(f"{name} {', '.join(f'{w:.4f}' for w in ws)} s (median "
                    f"{sorted(ws)[2]:.4f}, {100 * (sorted(ws)[2] / base - 1):+.1f} %)"
                    for name, ws in walls.items())
        + "; one snapshot (copy to the host, pickle, write, fsync, rename): "
        + "; ".join(f"{name} {b / 2**20:.2f} MiB in {1e3 * t:.2f} ms"
                    for name, (b, t) in snaps.items()))


def phase_distributed_stream(ctx, x, card, dev):
    """Distributed streaming over a NCCL group of world size 1 (a FileStore
    under build/: no network), on phase 4's host rows (8 chunks of 32,768),
    each fit against its single-device stream bit for bit: at one rank both
    fold the chunk partials in chunk order and the collective is a copy.
    K-Means (k = 50, the baseline's initial centers) unbounded and bounded,
    BKC (k = 400, BigK = 800) on both routes, the reservoir fed the
    single-device reservoir's chunk_uniforms draws for shard 0, Buckshot
    on that sample (also against the resident buckshot_distributed on the
    sample's rows, and under hac="boruvka"), tf-idf on the regenerated
    stream at paper_1gb_shape(scale=0.1); then K-Means and Buckshot cut by
    raise@gN inside a pass and resumed from a DiskCheckpointer under
    build/, and one profiled K-Means fit. Returns the launch counts of the
    unbounded K-Means fit."""
    import os
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import sampling
    from repro_torch.core.bkc import bkc_fit_stream
    from repro_torch.core.kmeans import kmeans_fit_stream
    from repro_torch.distrib import cluster as dc
    from repro_torch.distrib.sharding import make_flat_mesh
    from repro_torch.resilience import DiskCheckpointer
    from repro_torch.text import synth, tfidf

    st, nch = ctx["st"], ctx["st"].n_chunks
    n, d = x.shape
    s = sampling.buckshot_sample_size(n, K)
    init, km = ctx["kmeans"]
    fields = ("centers", "assignment", "rss", "objective", "iterations")
    pass_bytes = nch * STREAM_CHUNK * (d + 1) * 4
    root = Path(__file__).resolve().parent
    (root / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="dstream_", dir=root / "build") as tmp:
        nccl_world_1(tmp)
        try:
            mesh, axes = make_flat_mesh(), ("data",)
            warm = torch.zeros(1, device=dev)
            dist.all_reduce(warm)  # the group's first collective sets up NCCL
            torch.cuda.synchronize()

            # (1) K-Means, k = 50: single, distributed, distributed, single
            walls = {"single": [], "distributed": []}
            for who in ("single", "distributed", "distributed", "single"):
                if who == "single":
                    r, wall, c, _ = stream_run(kmeans_fit_stream, st, init, K)
                else:
                    r, wall, c, peak = stream_run(dc.kmeans_distributed_stream, mesh, axes, st,
                                                  init, K)
                    got, counts = r, c
                walls[who].append(wall)
            same_bits("kmeans_distributed_stream", got, km, fields)
            passes = got.iterations + 1
            if counts["assign_stats"] != passes * nch:
                raise AssertionError(f"kmeans_distributed_stream: launches {counts}")
            per = {w: [t / passes for t in ts] for w, ts in walls.items()}
            stream_report(f"kmeans_distributed_stream k={K} (NCCL, world size 1)",
                          walls["distributed"][0], passes, pass_bytes, counts, peak,
                          f"; equal to kmeans_fit_stream bit for bit ({', '.join(fields)}); "
                          f"s per pass, in the order run: single {per['single'][0]:.4f}, "
                          f"distributed {per['distributed'][0]:.4f}, "
                          f"{per['distributed'][1]:.4f}, single {per['single'][1]:.4f} "
                          f"(distributed / single {sum(per['distributed']) / sum(per['single']):.3f})")
            want_b, wall_sb, _, _ = stream_run(kmeans_fit_stream, st, init, K, bounded=True)
            got_b, wall_b, counts_b, _ = stream_run(dc.kmeans_distributed_stream, mesh, axes, st,
                                                    init, K, bounded=True)
            same_bits("kmeans_distributed_stream bounded", got_b, want_b, fields)
            if counts_b["assign_stats_bounded"] != (got_b.iterations + 1) * nch:
                raise AssertionError(f"kmeans_distributed_stream bounded: launches {counts_b}")
            log(f"phase 4 kmeans_distributed_stream bounded: equal to kmeans_fit_stream bounded "
                f"bit for bit; {wall_b / (got_b.iterations + 1):.4f} s per pass against "
                f"{wall_sb / (want_b.iterations + 1):.4f}; launches {counts_b}")

            # (2) BKC, k = 400, BigK = 800, both routes
            init_b, bkc = ctx["bkc"]
            for bounded in (True, False):
                got_k, wall_k, counts_k, _ = stream_run(
                    dc.bkc_distributed_stream, mesh, axes, st, init_b, BIG_K, BKC_K,
                    bounded=bounded)
                same_bits(f"bkc_distributed_stream bounded={bounded}", got_k, bkc,
                          fields[:-1])
                kernel = "assign_stats_bounded" if bounded else "assign_stats"
                if counts_k[kernel] != 2 * nch:
                    raise AssertionError(f"bkc_distributed_stream: launches {counts_k}")
                log(f"phase 4 bkc_distributed_stream k={BKC_K} BigK={BIG_K} bounded={bounded}: "
                    f"equal to bkc_fit_stream bit for bit; {wall_k:.4f} s ({wall_k / 2:.4f} s "
                    f"per pass); launches {counts_k}")

            # (3) the reservoir, fed the single-device reservoir's draws
            bs = ctx["buckshot"]
            base = int(torch.randint(0, 2**62, (1,), generator=torch.Generator().manual_seed(SEED)))

            def unif(ci, shard):
                return sampling.chunk_uniforms(base, ci, STREAM_CHUNK)

            (rows, gidx), t_res = sync_time(dc.reservoir_sample_distributed_stream, mesh, axes,
                                            st, s, uniforms=unif)
            if not (np.array_equal(gidx, bs.sample_idx.numpy())
                    and torch.equal(rows.cpu(), torch.from_numpy(ctx["x_host"][gidx]))):
                raise AssertionError("reservoir_sample_distributed_stream: the sample differs "
                                     "from reservoir_sample_stream's")
            log(f"phase 4 reservoir_sample_distributed_stream s={s}: the single-device "
                f"reservoir's indices in its order, rows equal x at them; {t_res:.4f} s (one pass)")

            # (4) Buckshot on that sample: the single-device buckshot_stream's bits
            got_s, wall_s, counts_s, _ = stream_run(
                dc.buckshot_distributed_stream, mesh, axes, st, K, uniforms=unif, sample_size=s)
            same_bits("buckshot_distributed_stream", got_s, bs.kmeans, fields)
            if not (counts_s["sim_best_edge"] >= 1 and counts_s["label_stats"] >= 1
                    and counts_s["assign_stats"] == (got_s.iterations + 1) * nch):
                raise AssertionError(f"buckshot_distributed_stream: launches {counts_s}")
            w = torch.ones((n,), device=dev)
            res = dc.buckshot_distributed(mesh, axes, x, w, K, SEED, sample_size=s,
                                          sample_rows=rows)
            agree, r = agreement(got_s.assignment, res.assignment), rel(got_s.rss, res.rss)
            if agree < 0.999 or r > 1e-4:
                raise AssertionError("buckshot_distributed_stream disagrees with the resident "
                                     "buckshot_distributed on its sample")
            got_h, wall_h, counts_h, _ = stream_run(
                dc.buckshot_distributed_stream, mesh, axes, st, K, uniforms=unif, sample_size=s,
                hac="boruvka")
            same_bits("buckshot_distributed_stream hac=boruvka", got_h, got_s, fields)
            if counts_h["component_best_edge"] < 1:
                raise AssertionError(f"hac='boruvka' launched {counts_h}")
            passes_s = 1 + got_s.iterations + 1
            log(f"phase 4 buckshot_distributed_stream k={K} s={s}: equal to buckshot_stream bit "
                f"for bit; labels agree with the resident buckshot_distributed on the same rows "
                f"{agree} (rss rel {r:.2e}); "
                f"{wall_s:.4f} s ({wall_s / passes_s:.4f} s per pass), launches {counts_s}; "
                f"hac='boruvka' the same bits, {wall_h:.4f} s, launches {counts_h}")

            # (5) tf-idf on the regenerated stream
            shape = synth.paper_1gb_shape(scale=0.1)
            cst, _ = synth.stream_corpus(**shape, chunk=REGEN_CHUNK)
            (df, n_docs), t_df = sync_time(tfidf.df_stream, cst, device=dev)
            stats, t_fold = sync_time(tfidf.df_fold_distributed, mesh, axes, cst)
            if not (torch.equal(stats["df"], df) and torch.equal(stats["n"], n_docs)):
                raise AssertionError("df_fold_distributed: df or n differ from df_stream's")
            a, t_a = sync_time(lambda: tfidf.tfidf_distributed_stream(mesh, axes, cst).materialize())
            b, t_b = sync_time(lambda: tfidf.tfidf_stream(cst, device=dev).materialize())
            if not np.array_equal(a, b):
                raise AssertionError("tfidf_distributed_stream: rows differ from tfidf_stream's")
            log(f"phase 4 tfidf_distributed_stream at n={shape['n_docs']} "
                f"(paper_1gb_shape(scale=0.1)), chunks of {REGEN_CHUNK}: df and n equal "
                f"df_stream's (df pass {t_fold:.2f} s against {t_df:.2f} s), every chunk's rows "
                f"equal tfidf_stream's bit for bit ({t_a:.2f} s against {t_b:.2f} s, two passes "
                f"each)")

            # (6) cut and resumed from a DiskCheckpointer under build/
            it, ib = got.iterations, bs.kmeans.iterations
            cut_and_resume(
                "kmeans_distributed_stream",
                lambda ck: dc.kmeans_distributed_stream(mesh, axes, st, init, K, checkpoint=ck),
                [f"raise@g{2 * nch + 5}", f"raise@g{(it - 2) * nch + 7}"],
                [2 * nch + 5, (nch - 4) + (it - 3) * nch + 7, nch - 6], "assign_stats", got,
                fields, DiskCheckpointer(os.path.join(tmp, "kmeans"), every=2))
            cut_and_resume(
                "buckshot_distributed_stream",
                lambda ck: dc.buckshot_distributed_stream(mesh, axes, st, K, uniforms=unif,
                                                          sample_size=s, checkpoint=ck),
                [f"raise@g{nch + 5}", f"raise@g{ib * nch + 7}"],
                [5, (nch - 4) + (ib - 1) * nch + 7, nch - 6], "assign_stats", got_s, fields,
                DiskCheckpointer(os.path.join(tmp, "buckshot"), every=2))

            log("phase 4 profile " + profile_stream(
                "kmeans_distributed_stream", dc.kmeans_distributed_stream, mesh, axes, st, init, K))
        finally:
            dist.destroy_process_group()
    return counts


def phase_stream_regen(dev):
    """The quickstart's chain, regenerating the corpus on every pass:
    prepare_synthetic_stream -> kmeans_stream / bkc_stream (BigK = 2k) /
    buckshot_stream, at a tenth of the 1 GB shape (see the module
    docstring), chunks of 8,192 rows."""
    import torch

    from repro_torch.core import metrics
    from repro_torch.core.bkc import bkc_stream
    from repro_torch.core.buckshot import buckshot_stream
    from repro_torch.core.kmeans import kmeans_stream
    from repro_torch.text import pipeline, synth, tfidf
    from repro_torch.text.stream import run_pass, to_device

    shape = synth.paper_1gb_shape(scale=0.1)
    n, d, topics = shape["n_docs"], shape["vocab"], shape["n_topics"]
    prep, t_prep = sync_time(pipeline.prepare_synthetic_stream, **shape, chunk=REGEN_CHUNK,
                             device=dev)
    nch = prep.x.n_chunks
    t = time.perf_counter()
    corpus = synth.make_corpus(**shape)
    t_gen = time.perf_counter() - t
    want = tfidf.tfidf(torch.from_numpy(corpus.counts).to(dev))
    for prefetch in (2, 0):  # the mapped stream's rescale runs on the producer thread when 2
        chunks, t_pass = sync_time(run_pass, prep.x, lambda acc, ch, ci: acc + [to_device(ch.x, dev)],
                                   [], copy_to=dev, prefetch=prefetch)
        if not torch.equal(torch.cat(chunks)[:n], want):
            raise AssertionError(f"tfidf_stream (prefetch {prefetch}) differs from the resident tfidf")
        log(f"phase 4 regenerated stream: tf-idf chunks with prefetch {prefetch} equal the "
            f"resident tfidf of make_corpus bit for bit ({t_pass:.2f} s a pass)")
    del chunks, want
    log(f"phase 4 regenerated stream at n={n} (paper_1gb_shape(scale=0.1)), {nch} chunks of "
        f"{REGEN_CHUNK}: prepare_synthetic_stream (the df pass) {t_prep:.2f} s; make_corpus of "
        f"the same shape {t_gen:.2f} s on the host")
    truth = torch.from_numpy(prep.labels)
    pass_bytes = nch * REGEN_CHUNK * (d + 1) * 4
    runs = (
        ("kmeans_stream", lambda: kmeans_stream(prep.x, K, torch.Generator().manual_seed(SEED),
                                                device=dev), K),
        ("bkc_stream", lambda: bkc_stream(prep.x, 2 * K, K, torch.Generator().manual_seed(SEED),
                                          device=dev), K),
        ("buckshot_stream", lambda: buckshot_stream(prep.x, K, torch.Generator().manual_seed(SEED),
                                                    kmeans_iters=2, device=dev), K),
    )
    for name, fn, k in runs:
        out, wall, counts, peak = stream_run(fn)
        km = out.kmeans if name == "buckshot_stream" else out
        check_result(name, km, n, d, k)
        iters = getattr(km, "iterations", 1)
        passes = {"kmeans_stream": 1 + iters + 1, "bkc_stream": 3,
                  "buckshot_stream": 1 + iters + 1}[name]
        assign = passes - 1  # every pass but the reservoir's runs assign_stats
        if counts["assign_stats"] != assign * nch:
            raise AssertionError(f"{name}: {counts['assign_stats']} assign_stats launches, "
                                 f"expected {assign} passes x {nch} chunks")
        quality = dict(rss=km.rss.item(),
                       purity=metrics.purity(km.assignment, truth, k, topics).item(),
                       nmi=metrics.nmi(km.assignment, truth, k, topics).item())
        stream_report(f"regenerated {name}", wall, passes, pass_bytes, counts, peak,
                      f"; quality {quality}")


# ------------------------------------------------------ the redesign slice


# ------------------------------------------------------------ the online service

SERVE_DIM, SERVE_CHUNK = 2048, 4096  # the service's hashing width and stream chunk
DRIFT_BATCH = 500  # docs per ingest batch


def corpus_texts(counts, prefix: str) -> list[str]:
    """Each count row as a text: the token f"{prefix}{j}" repeated by the
    row's count of term j."""
    import numpy as np

    texts = []
    for row in counts:
        cols = np.nonzero(row)[0]
        texts.append(" ".join(" ".join([f"{prefix}{j}"] * int(row[j])) for j in cols))
    return texts


def p50_p99_ms(lat) -> str:
    import numpy as np

    if not lat:
        return "no requests"
    a = np.asarray(lat, np.float64) * 1e3
    return f"p50 {np.percentile(a, 50):.3f} ms, p99 {np.percentile(a, 99):.3f} ms ({a.size} requests)"


def delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def serve_oracle(model, docs, max_batch, dev):
    """What the service must answer for ``docs`` served alone under
    ``model``: assign_batch on the rescaled rows of its zero-padded
    ``max_batch`` slab. Returns host (idx, best_sim) and the rows."""
    import numpy as np
    import torch

    from repro_torch.core.kmeans import assign_batch
    from repro_torch.text import hashing, tfidf

    counts = hashing.vectorize(docs, model.df.shape[0])
    m = counts.shape[0]
    slab = np.zeros((max_batch, counts.shape[1]), np.float32)
    slab[:m] = counts
    x = tfidf._rescale(torch.from_numpy(slab).to(dev), model.df, model.n_docs)
    idx, sim = assign_batch(x, model.centers, index=model.index)
    return idx[:m].cpu().numpy(), sim[:m].cpu().numpy(), x[:m]


def phase_serve(card: str, dev, shape=None, requests: int = 300, drift_docs: int = 5000):
    """The online clustering service (repro_torch.serve) at the paper's 20
    Newsgroups shape: fit, 300 serial assigns (a), assigns from 8 threads
    while ingest and the drift-triggered refit run (b), the swapped centers
    against an offline buckshot_stream (c), then the refit's K-Means bounded
    against unbounded. The launch counts are set to 0 before the fit and
    read after each endpoint; the oracles' launches are left out."""
    import threading

    import numpy as np
    import torch

    from repro_torch.core.buckshot import buckshot_stream
    from repro_torch.core.kmeans import assign_batch, kmeans_fit_stream
    from repro_torch.kernels import ops
    from repro_torch.serve import ClusterService, ServiceConfig
    from repro_torch.serve.cluster_service import draw_generator
    from repro_torch.text import synth, tfidf
    from repro_torch.text.stream import CorpusStream

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    shape = shape or synth.paper_20ng_shape()
    seed = shape["seed"]
    t = time.perf_counter()
    base = corpus_texts(synth.make_corpus(**shape).counts, "t")
    drift_shape = {**shape, "n_docs": drift_docs, "seed": seed + 1}
    drifted = corpus_texts(synth.make_corpus(**drift_shape).counts, "u")
    log(f"phase 4 serve set-up: {len(base)} base and {len(drifted)} drifted texts in "
        f"{time.perf_counter() - t:.1f} s")
    # validate_slack: any finite candidate swaps, as in the reference's
    # determinism tests (the RSS gate has its own tests); both RSS are printed
    cfg = ServiceConfig(k=shape["n_topics"], dim=SERVE_DIM, chunk=SERVE_CHUNK,
                        max_batch=BATCH, queue_cap=256, sample_size=None, kmeans_iters=3,
                        validate_slack=100.0)
    path = dict.fromkeys(ops.launch_counts(), 0)  # the service's own launches

    def add(part):
        for k, v in part.items():
            path[k] += v

    ops.reset_launch_counts()
    t = time.perf_counter()
    svc = ClusterService.fit(base, seed, config=cfg, device=dev)
    sync()
    t_fit = time.perf_counter() - t
    fit_counts = ops.launch_counts()
    add(fit_counts)
    try:
        m0 = svc.model
        if m0.centers.device.type != dev.type or (cfg.bounded and dev.type == "cuda"
                                                    and m0.index is None):
            raise AssertionError("serve: the model is not on the card with its index")
        log(f"phase 4 serve fit ({card}): n={len(base)} k={cfg.k} dim={cfg.dim} "
            f"chunk={cfg.chunk}: {t_fit:.3f} s, rss {m0.rss}, launches {fit_counts}")

        # (a) serial requests of BATCH docs at version 0
        c = ops.launch_counts()
        answers = []
        for r in range(requests):
            lo = (r * BATCH) % (len(base) - BATCH)
            docs = base[lo:lo + BATCH]
            answers.append((docs, svc.assign(docs)))
        assign_counts = delta(ops.launch_counts(), c)
        add(assign_counts)
        rows, got = [], []
        for docs, out in answers:
            idx, sim, x = serve_oracle(m0, docs, cfg.max_batch, dev)
            if out.version != 0 or not np.array_equal(out.idx, idx) \
                    or out.best_sim.tobytes() != sim.tobytes():
                raise AssertionError("serve (a): an answer differs from assign_batch")
            rows.append(x.cpu())
            got.append(torch.from_numpy(out.idx))
        xc, cc = torch.cat(rows), m0.centers.cpu()
        pidx, psim = assign_batch(xc, cc)  # the plain version, on the CPU
        sims = xc @ cc.T
        near = check_argmax("serve (a) labels against the plain version", torch.cat(got), None,
                            pidx, psim, lambda r, k: sims[r, k])
        # micro-batch latency: assign_batch alone on one request's rows
        x64 = serve_oracle(m0, answers[0][0], cfg.max_batch, dev)[2]
        ab = []
        for _ in range(requests):
            sync()
            t = time.perf_counter()
            assign_batch(x64, m0.centers, index=m0.index)
            sync()
            ab.append(time.perf_counter() - t)
        log(f"phase 4 serve (a) ({card}): {requests} serial requests of {BATCH} docs equal "
            f"assign_batch bit for bit; labels equal the plain version's but {near} near-ties "
            f"of {xc.shape[0]}; assign idle {p50_p99_ms([o.latency_s for _, o in answers])}; "
            f"assign_batch alone on {BATCH} rows {p50_p99_ms(ab)}; launches {assign_counts}")

        # one ingest batch of in-distribution docs, alone
        ingested = list(base[:DRIFT_BATCH])
        c = ops.launch_counts()
        t = time.perf_counter()
        rec = svc.ingest(ingested)
        t_ing = [time.perf_counter() - t]
        ingest_counts = delta(ops.launch_counts(), c)
        add(ingest_counts)
        if rec.drift or rec.idx.shape != (DRIFT_BATCH,):
            raise AssertionError("serve: an in-distribution batch tripped the drift detector")

        # (b) 8 caller threads of 8-doc requests while ingest and the refit run
        stop = threading.Event()
        results, errors = [], []

        def caller(i):
            j = 0
            while not stop.is_set():
                lo = (1000 * i + 8 * j) % (len(base) - 8)
                docs = base[lo:lo + 8]
                try:
                    out = svc.assign(docs, deadline=120.0)
                    results.append((docs, out, time.monotonic() - out.latency_s))
                except BaseException as e:  # noqa: BLE001
                    errors.append(e)
                    return
                j += 1

        c = ops.launch_counts()
        callers = [threading.Thread(target=caller, args=(i,)) for i in range(8)]
        for th in callers:
            th.start()
        time.sleep(0.5)
        rid, batches = None, 0
        while rid is None:
            if batches * DRIFT_BATCH >= len(drifted):
                raise AssertionError("serve (b): the drifted corpus never tripped the detector")
            docs = drifted[batches * DRIFT_BATCH:(batches + 1) * DRIFT_BATCH]
            t = time.perf_counter()
            rec = svc.ingest(docs)
            t_ing.append(time.perf_counter() - t)
            ingested += docs
            batches += 1
            rid = rec.refit_id
        t_refit0 = time.monotonic()
        during = 0
        for _ in range(2):  # ingest goes on while the refit runs
            docs = drifted[batches * DRIFT_BATCH:(batches + 1) * DRIFT_BATCH]
            if not docs:
                break
            t = time.perf_counter()
            svc.ingest(docs)
            t_ing.append(time.perf_counter() - t)
            ingested += docs
            batches += 1
            during += 1
        if not svc.refit_wait(rid, timeout=600.0):
            raise AssertionError("serve (b): the refit did not end")
        t_refit1 = time.monotonic()
        time.sleep(0.5)  # requests at the new version
        stop.set()
        for th in callers:
            th.join()
        window = delta(ops.launch_counts(), c)
        add(window)
        refits = dict(svc._refits)
        m1 = svc.model
        if errors or m1.version != 1 or refits.get("swapped") != 1:
            raise AssertionError(f"serve (b): errors {errors[:3]}, refits {refits}, "
                                 f"version {m1.version}")
        models = {0: m0, 1: m1}
        for docs, out, _ in results:
            idx, sim, _ = serve_oracle(models[out.version], docs, cfg.max_batch, dev)
            if not np.array_equal(out.idx, idx) or out.best_sim.tobytes() != sim.tobytes():
                raise AssertionError("serve (b): an answer differs from its version's oracle")
        in_refit = [o.latency_s for _, o, s in results if t_refit0 <= s <= t_refit1]
        versions = collections.Counter(o.version for _, o, _ in results)
        n_ing = DRIFT_BATCH * (len(t_ing) - 1)
        log(f"phase 4 serve (b) ({card}): {len(results)} requests of 8 docs from 8 threads "
            f"(versions {dict(versions)}) equal their version's oracle bit for bit; assign "
            f"during the refit {p50_p99_ms(in_refit)}; refit {t_refit1 - t_refit0:.3f} s "
            f"(from the tripping batch, {batches} drifted batches, {during} during the refit; "
            f"refits {refits}); ingest alone {DRIFT_BATCH / t_ing[0]:.0f} docs/s, beside the "
            f"callers and the refit {n_ing / sum(t_ing[1:]):.0f} docs/s over {len(t_ing) - 1} "
            f"batches of {DRIFT_BATCH}; launches: ingest alone {ingest_counts}, the window "
            f"(refit + {during + batches} ingests + assigns) {window}")

        # (c) the swapped centers against an offline buckshot_stream
        absorbed = svc._absorbed
        stream = CorpusStream.from_texts(base + ingested[:absorbed], dim=cfg.dim,
                                         chunk=cfg.chunk)
        xs = tfidf.tfidf_stream(stream, device=dev)
        t = time.perf_counter()
        res = buckshot_stream(xs, cfg.k, draw_generator(seed, rid), kmeans_iters=3, tol=0.0,
                              device=dev, bounded=True)
        sync()
        t_off = time.perf_counter() - t
        if not torch.equal(res.kmeans.centers, m1.centers):
            raise AssertionError("serve (c): the swapped centers differ from buckshot_stream")
        old_rss = float(kmeans_fit_stream(xs, m0.centers, cfg.k, max_iters=0).rss)
        log(f"phase 4 serve (c) ({card}): swapped centers equal an offline buckshot_stream "
            f"over {stream.n} docs bit for bit ({t_off:.3f} s on the regenerated stream); "
            f"version {m1.version} serves; RSS on the combined stream: swapped {m1.rss}, "
            f"old centers {old_rss}")
    finally:
        svc.close()
    missing = [k for k in ("sim_best_edge", "label_stats", "assign_stats", "assign_argmax",
                           "assign_stats_bounded") if path[k] == 0]
    if dev.type == "cuda" and (missing or assign_counts["assign_stats_bounded"] != requests
                               or ingest_counts["assign_stats"] != 1):
        raise AssertionError(f"serve: the path did not go through its kernels: {path}, "
                             f"assign {assign_counts}, ingest {ingest_counts}")
    log(f"phase 4 serve launches ({card}): {path}")
    serve_bounded_decision(card, dev, xs, res, m0, cfg.k, lambda: draw_generator(seed, rid), sync)


def serve_bounded_decision(card, dev, xs, res, m0, k, draws, sync):
    """The refit's K-Means bounded against unbounded, on the combined
    stream's tf-idf rows held in host memory (no hashing in the way): from
    the refit's own Buckshot initial centers and warm-started from the live
    centers, 3 iterations each, five times each way in turns, with the
    pruned share per pass; and buckshot_stream itself."""
    import torch

    from repro_torch.core.buckshot import buckshot_stream
    from repro_torch.core.kmeans import kmeans_fit_stream
    from repro_torch.text.stream import CorpusStream

    def median(runs):
        return statistics.median(r[0] for r in runs)

    hs = CorpusStream.from_array(xs.materialize(), chunk=xs.chunk)
    for label, init in (("refit init", res.init_centers), ("live centers", m0.centers)):
        runs = {True: [], False: []}
        for bounded in (True, False) * 5:
            prof = {}
            sync()
            t = time.perf_counter()
            km = kmeans_fit_stream(hs, init, k, max_iters=3, tol=0.0, bounded=bounded,
                                   profile=prof)
            sync()
            runs[bounded].append((time.perf_counter() - t, km, prof.get("prune_rate")))
        kb, ku = runs[True][0][1], runs[False][0][1]
        if not (torch.equal(kb.centers, ku.centers) and torch.equal(kb.assignment, ku.assignment)):
            raise AssertionError(f"serve K-Means ({label}): bounded and unbounded differ")
        log(f"phase 4 serve K-Means from the {label} ({card}), {hs.n} rows in {hs.n_chunks} "
            f"host chunks, {kb.iterations} iterations: bounded "
            f"{[round(r[0], 4) for r in runs[True]]} s, unbounded "
            f"{[round(r[0], 4) for r in runs[False]]} s (medians {median(runs[True]):.4f} and "
            f"{median(runs[False]):.4f} s); pruned share per pass "
            f"{[round(p, 4) for p in runs[True][0][2]]}")
    walls = {True: [], False: []}
    for bounded in (True, False) * 5:
        sync()
        t = time.perf_counter()
        r = buckshot_stream(hs, k, draws(), kmeans_iters=3, tol=0.0, device=dev,
                            bounded=bounded)
        sync()
        walls[bounded].append(time.perf_counter() - t)
        if bounded:
            want = r.kmeans.centers
        elif not torch.equal(r.kmeans.centers, want):
            raise AssertionError("serve buckshot_stream: bounded and unbounded differ")
    log(f"phase 4 serve buckshot_stream on the host rows ({card}): bounded "
        f"{[round(w, 4) for w in walls[True]]} s, unbounded {[round(w, 4) for w in walls[False]]} s "
        f"(medians {statistics.median(walls[True]):.4f} and "
        f"{statistics.median(walls[False]):.4f} s)")


def lm_state_bytes(cfg, b: int, cache_len: int) -> tuple[int, int]:
    """The f32 decode state a model carries for b rows: (attention cache
    bytes, recurrent state bytes). Attention: k and v of every slot of each
    attention layer (a window layer min(W, cache_len) slots; hybrid's
    n_layers / attn_every shared-block calls). Recurrent: hybrid's (B, H, N,
    P) SSM state and (B, W-1, d_in + 2N) conv tail a layer; rwkv's (B, H,
    hd, hd) state and two (B, 1, D) shifts a layer; 0 for the others."""
    f4 = 4
    slot = 2 * cfg.n_kv_heads * cfg.head_dim * f4  # one position's k and v
    if cfg.family == "rwkv":
        hd = cfg.rwkv.head_size
        return 0, cfg.n_layers * b * ((cfg.d_model // hd) * hd * hd + 2 * cfg.d_model) * f4
    if cfg.family == "hybrid":
        ssm = cfg.ssm
        d_in = ssm.expand * cfg.d_model
        state = (d_in // ssm.head_dim) * ssm.d_state * ssm.head_dim
        conv = (ssm.conv_width - 1) * (d_in + 2 * ssm.d_state)
        return ((cfg.n_layers // cfg.attn_every) * b * cache_len * slot,
                cfg.n_layers * b * (state + conv) * f4)
    return sum(b * (min(w, cache_len) if w else cache_len) * slot for w in cfg.layer_windows()), 0


def lm_bounds(cfg, b: int, t: int, cache_len: int, param_bytes: int) -> dict:
    """The card's least time for one prefill of b x t tokens and for one
    decode step at the end of a cache_len cache: model_flops (active params,
    attention, the SSM/RWKV sequence mix) plus the LM head on one position a
    row, against every param read once (a MoE's static-capacity dispatch runs
    every expert's slots, so all experts' weights count) and the decode
    state (lm_state_bytes): a prefill writes it once; a step reads the
    attention caches and reads and rewrites the recurrent states."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.configs.flops import model_flops

    head = 2.0 * b * cfg.d_model * cfg.vocab
    attn, rec = lm_state_bytes(cfg, b, cache_len)
    pre = model_flops(cfg, ShapeCell("serve_prefill", "prefill", t, b))["model_flops"] + head
    dec = model_flops(cfg, ShapeCell("serve_decode", "decode", cache_len, b))["model_flops"] + head
    pre_bytes, dec_bytes = param_bytes + attn + rec, param_bytes + attn + 2 * rec
    return {
        "prefill": bound_ms(pre, pre_bytes), "decode": bound_ms(dec, dec_bytes),
        "prefill_flops": pre, "decode_bytes": dec_bytes,
    }


def lm_attention_vs_sdpa(cfg, dev) -> None:
    """A finding, not on the path: the port's plain flash_attention (the
    reference's chunked online softmax) against SDPA on one layer's causal
    attention at the embed batch's shape (64 docs x 64 tokens)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models.attention import flash_attention

    g = torch.Generator(device=dev).manual_seed(SEED)
    b, s, hk, grp, dh = 64, EMBED_SEQ, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    q = torch.randn((b, s, hk, grp, dh), generator=g, device=dev)
    k, v = (torch.randn((b, s, hk, dh), generator=g, device=dev) for _ in range(2))
    qs = q.reshape(b, s, hk * grp, dh).transpose(1, 2)
    ks, vs = k.transpose(1, 2), v.transpose(1, 2)
    ours = event_ms(lambda: flash_attention(q, k, v, chunk=cfg.attn_chunk), 20)
    sdpa = event_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                           enable_gqa=True), 20)
    want = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)
    err = (flash_attention(q, k, v, chunk=cfg.attn_chunk).reshape(b, s, hk * grp, dh)
           - want.transpose(1, 2)).abs().max().item()
    log(f"phase 4 LM attention ({b} x {s} tokens, {cfg.n_heads}/{hk} heads of {dh}, causal): "
        f"plain flash_attention {ours:.4f} ms, SDPA {sdpa:.4f} ms (max abs diff {err:.3g}; "
        f"SDPA is not on the path)")


def check_near_ties(name, got, want, logits, tol) -> int:
    """Greedy tokens equal to the teacher-forced argmax, but where the
    teacher-forced logit of the greedy token is within ``tol`` of the max."""
    import torch

    diff = got != want
    n_diff = int(diff.sum())
    if n_diff:
        at = torch.gather(logits, -1, got[..., None].long())[..., 0]
        gap = (logits.amax(-1) - at)[diff]
        if gap.max().item() > tol:
            raise AssertionError(f"{name}: {n_diff} tokens differ, not at near-ties")
    return n_diff


def phase_lm_serve(card: str, dev):
    """The LM zoo's serving path (repro_torch.models, repro_torch.serve.engine)
    at qwen2-1.5b's full width and depth, f32 weights drawn on the card from
    a seeded generator: (a) ServeEngine.generate on 8 requests of 32-token
    prompts and 16 new tokens, three timed runs after a warm-up: prefill ms,
    decode ms a step (median), tokens/s against the bounds, the host's CPU
    share and involuntary context switches beside them; then decode at a 32,768-token context (lm_decode_long);
    (b) prefill(T) + decode = prefill(T + 1) and greedy decode = the
    teacher-forced argmax, at full width; the prefill logits of one request
    against the port on the CPU with the same weights; (c) embed-and-cluster
    (lm_embed_and_cluster)."""
    import os

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.models.layers import lm_logits
    from repro_torch.models.registry import get_model
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = get_config(LM_ARCH)
    model = get_model(cfg)
    t = time.perf_counter()
    lm = model.init_params(torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in lm.parameters())
    p_bytes = sum(p.numel() * p.element_size() for p in lm.parameters())
    if n_params != model.param_count():
        raise AssertionError(f"LM serve: {n_params} params built, {model.param_count()} in the recs")
    log(f"phase 4 LM serve: {cfg.name} full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}): {n_params:,} params, {p_bytes:,} bytes f32, drawn on "
        f"the device in {time.perf_counter() - t:.2f} s; {card}")

    # (a) generate
    engine = ServeEngine(cfg=cfg, params=lm, device=dev)
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(1, cfg.vocab, size=(LM_REQUESTS, LM_PROMPT + 1))
    reqs = [Request(prompt=[int(v) for v in p[:-1]], max_new_tokens=LM_NEW) for p in prompts]
    toks, runs = lm_generate_runs(engine, reqs)
    if toks.shape != (LM_REQUESTS, LM_NEW) or not bool(((toks >= 0) & (toks < cfg.vocab)).all()):
        raise AssertionError(f"LM serve: completions of shape {tuple(toks.shape)}")
    wall = statistics.median(r[0] for r in runs)
    pre_ms = 1e3 * statistics.median(r[1]["prefill_s"] for r in runs)
    steps = [s for r in runs for s in r[1]["decode_s"]]
    dec_ms = 1e3 * statistics.median(steps)
    pre_runs = ", ".join(f"{1e3 * r[1]['prefill_s']:.3f}" for r in runs)
    cache_len = LM_PROMPT + LM_NEW
    bnd = lm_bounds(cfg, LM_REQUESTS, LM_PROMPT, cache_len, p_bytes)
    log(f"phase 4 LM serve generate: {LM_REQUESTS} requests x {LM_PROMPT}-token prompts, "
        f"{LM_NEW} new tokens, f32 weights and cache, no TF32: wall {1e3 * wall:.2f} ms "
        f"(median of 3) -> {LM_REQUESTS * LM_NEW / wall:.1f} tokens/s; prefill "
        f"{pre_ms:.3f} ms (runs {pre_runs}), "
        f"bound {bnd['prefill'][0]:.3f} ms ({bnd['prefill'][1]}: {bnd['prefill_flops']:.4g} flops); "
        f"decode {dec_ms:.3f} ms a step (median of {len(steps)}; min {1e3 * min(steps):.3f}, "
        f"max {1e3 * max(steps):.3f}), bound {bnd['decode'][0]:.3f} ms ({bnd['decode'][1]}: "
        f"{bnd['decode_bytes']:,} bytes), {bnd['decode'][0] / dec_ms:.1%} of it; host CPU "
        f"seconds over wall, each run: {', '.join(f'{r[2]:.2f}' for r in runs)}, involuntary "
        f"context switches {', '.join(str(r[3]) for r in runs)} ({os.cpu_count()} cores)")
    lm_decode_long(lm, cfg, p_bytes, dev)

    # (b) the caches carry the forward's state, greedy = teacher-forced
    full = {"tokens": torch.from_numpy(prompts.astype(np.int32)).to(dev)}
    pre = {"tokens": full["tokens"][:, :-1]}
    # where the time goes: one prefill, one decode step
    profile_run(f"LM prefill {LM_REQUESTS} x {LM_PROMPT}", transformer.prefill, lm, cfg,
                pre, torch.float32, cache_len=cache_len)
    _, caches, pos = transformer.prefill(lm, cfg, pre, torch.float32, cache_len=cache_len)
    profile_run(f"LM decode step, {LM_REQUESTS} rows", transformer.decode_step, lm, cfg,
                full["tokens"][:, -1:], caches, pos)
    lm_attention_vs_sdpa(cfg, dev)
    want, _, _ = transformer.prefill(lm, cfg, full, torch.float32)
    _, caches, pos = transformer.prefill(lm, cfg, pre, torch.float32, cache_len=LM_PROMPT + 8)
    got, _ = transformer.decode_step(lm, cfg, full["tokens"][:, -1:], caches, pos)
    err = check_close("LM prefill(T)+decode vs prefill(T+1)", got, want, LM_TOL, LM_TOL)
    seq = torch.cat([pre["tokens"], toks[:, :-1].to(dev, torch.int32)], dim=1)
    with torch.no_grad():
        h, _, _ = transformer.forward(lm, cfg, {"tokens": seq})
        tf_logits = lm_logits(lm.embed, h[:, LM_PROMPT - 1 :], cfg)
    ties = check_near_ties("LM greedy vs teacher-forced", toks.to(dev), tf_logits.argmax(-1),
                           tf_logits, LM_TOL)
    del h, tf_logits
    cpu = model.init_params(torch.Generator(device=dev).manual_seed(SEED), "cpu")
    one = {"tokens": pre["tokens"][:1, :8]}
    t = time.perf_counter()
    ref_logits = transformer.prefill(cpu, cfg, {"tokens": one["tokens"].cpu()}, torch.float32)[0]
    t_cpu = time.perf_counter() - t
    err_cpu = check_close("LM prefill card vs CPU", transformer.prefill(
        lm, cfg, one, torch.float32)[0].cpu(), ref_logits, LM_TOL, LM_TOL)
    del cpu
    log(f"phase 4 LM serve checks: prefill(T)+decode vs prefill(T+1) max abs err {err:.3g} "
        f"(tol {LM_TOL}); greedy = teacher-forced argmax on {toks.numel()} tokens, "
        f"{ties} at near-ties; one 8-token prefill card vs the port on the CPU (same weights, "
        f"{t_cpu:.1f} s there) max abs err {err_cpu:.3g}")
    return lm_embed_and_cluster(engine, p_bytes, dev)


def lm_generate_runs(engine, reqs):
    """generate: one warm-up, then three timed runs (host clock, each ending
    in a host read), each with the process's CPU seconds over wall and its
    involuntary context switches. Returns (first completions' tokens, runs)."""
    import torch

    first = engine.generate(reqs)  # warm-up: cuBLAS handles, the allocator's pool
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t, (cpu, csw) = time.perf_counter(), host_usage()
        outs = engine.generate(reqs)
        wall_s = time.perf_counter() - t
        cpu1, csw1 = host_usage()
        runs.append((wall_s, dict(engine.stats), (cpu1 - cpu) / wall_s, csw1 - csw))
        if [o.tokens for o in outs] != [o.tokens for o in first]:
            raise AssertionError(f"{engine.cfg.name}: generate is not deterministic")
    return torch.tensor([o.tokens for o in first]), runs


def moe_drops(fn, *args, **kwargs) -> tuple[int, int]:
    """(dropped choices, choices) over every MoE layer of one call of fn:
    the dispatch's sink slot counted layer by layer (a host read each, so
    not timed)."""
    from repro_torch.models import moe

    seen = []
    dispatch = moe._dispatch_group

    def counting(xf, gate, eids, e, k, cap):
        out = dispatch(xf, gate, eids, e, k, cap)
        seen.append((int((out[1] == e * cap).sum()), out[1].numel()))
        return out

    moe._dispatch_group = counting
    try:
        fn(*args, **kwargs)
    finally:
        moe._dispatch_group = dispatch
    return sum(d for d, _ in seen), sum(n for _, n in seen)


def no_drop_config(cfg):
    """A moe config whose capacity factor gives every expert t slots (cap =
    t: int(t * k / E * E) + 1 > t), so no choice drops; others unchanged."""
    import dataclasses

    if cfg.family != "moe":
        return cfg
    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=float(cfg.moe.n_experts)))


def phase_lm_families(card: str, dev) -> None:
    """The zoo's moe, hybrid and rwkv families (models/moe.py, ssm.py,
    rwkv.py through transformer.py and ServeEngine) at their published
    widths, f32 weights drawn on the card from SEED, one model at a time
    (each freed before the next). Per model: (a) ServeEngine.generate on
    LM_REQUESTS x LM_PROMPT + LM_NEW, a warm-up and three timed runs:
    prefill ms, decode ms a step (median), tokens/s, each beside its bound
    (lm_bounds), the host's CPU seconds over wall and involuntary context
    switches; for a MoE the choices one prefill drops at the published
    capacity factor; one prefill and one decode step profiled. (b)
    prefill(T) + decode within LM_TOL of prefill(T + 1), greedy decode equal
    to the teacher-forced argmax but at near-ties (a MoE at a copy of its
    config whose capacity factor drops nothing: at the published one the
    longer prefill drops other choices, as the reference's would). (c) one
    8-token prefill on the card against the port on the CPU, the same
    weights drawn from SEED at a shallower depth (host memory <= ~12 GB)."""
    import os

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.models.layers import lm_logits
    from repro_torch.models.moe import capacity
    from repro_torch.models.registry import get_model
    from repro_torch.serve.engine import Request, ServeEngine

    t_phase = time.perf_counter()
    for arch, depth, cpu_depth in LM_FAMILIES:
        t_model = time.perf_counter()
        full = get_config(arch)
        cfg = full.replace(n_layers=depth) if depth else full
        model = get_model(cfg)
        t = time.perf_counter()
        lm = model.init_params(torch.Generator(device=dev).manual_seed(SEED), dev)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in lm.parameters())
        p_bytes = sum(p.numel() * p.element_size() for p in lm.parameters())
        if n_params != model.param_count():
            raise AssertionError(f"{arch}: {n_params} params built, {model.param_count()} in the recs")
        cut = (f"cut to {depth} of {full.n_layers} layers: the whole model is "
               f"{4 * get_model(full).param_count():,} bytes in f32" if depth else "whole")
        log(f"phase 4 LM families: {arch} ({cfg.family}) at its published widths (d_model "
            f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff "
            f"{cfg.d_ff}, vocab {cfg.vocab}), {cfg.n_layers} layers ({cut}): {n_params:,} params, "
            f"{p_bytes:,} bytes f32, drawn on the device in {time.perf_counter() - t:.2f} s; {card}")

        # (a) generate
        engine = ServeEngine(cfg=cfg, params=lm, device=dev)
        rng = np.random.default_rng(SEED)
        prompts = rng.integers(1, cfg.vocab, size=(LM_REQUESTS, LM_PROMPT + 1))
        reqs = [Request(prompt=[int(v) for v in p[:-1]], max_new_tokens=LM_NEW) for p in prompts]
        toks, runs = lm_generate_runs(engine, reqs)
        if toks.shape != (LM_REQUESTS, LM_NEW) or not bool(((toks >= 0) & (toks < cfg.vocab)).all()):
            raise AssertionError(f"{arch}: completions of shape {tuple(toks.shape)}")
        wall = statistics.median(r[0] for r in runs)
        pre_ms = 1e3 * statistics.median(r[1]["prefill_s"] for r in runs)
        steps = [st for r in runs for st in r[1]["decode_s"]]
        dec_ms = 1e3 * statistics.median(steps)
        cache_len = LM_PROMPT + LM_NEW
        bnd = lm_bounds(cfg, LM_REQUESTS, LM_PROMPT, cache_len, p_bytes)
        tok_bound = LM_REQUESTS * LM_NEW * 1e3 / (bnd["prefill"][0] + len(runs[0][1]["decode_s"])
                                                   * bnd["decode"][0])
        pre_runs = ", ".join(f"{1e3 * r[1]['prefill_s']:.3f}" for r in runs)
        log(f"phase 4 LM families {arch} generate: {LM_REQUESTS} requests x {LM_PROMPT}-token "
            f"prompts, {LM_NEW} new tokens, f32: wall {1e3 * wall:.2f} ms (median of 3) -> "
            f"{LM_REQUESTS * LM_NEW / wall:.1f} tokens/s (bound {tok_bound:.1f}); prefill "
            f"{pre_ms:.3f} ms (runs {pre_runs}), "
            f"bound {bnd['prefill'][0]:.3f} ms ({bnd['prefill'][1]}: {bnd['prefill_flops']:.4g} "
            f"flops); decode {dec_ms:.3f} ms a step (median of {len(steps)}; min "
            f"{1e3 * min(steps):.3f}, max {1e3 * max(steps):.3f}), bound {bnd['decode'][0]:.3f} ms "
            f"({bnd['decode'][1]}: {bnd['decode_bytes']:,} bytes), {bnd['decode'][0] / dec_ms:.1%} "
            f"of it; host CPU seconds over wall {', '.join(f'{r[2]:.2f}' for r in runs)}, "
            f"involuntary context switches {', '.join(str(r[3]) for r in runs)} "
            f"({os.cpu_count()} cores)")
        full_b = {"tokens": torch.from_numpy(prompts.astype(np.int32)).to(dev)}
        pre = {"tokens": full_b["tokens"][:, :-1]}
        if cfg.family == "moe":
            dropped, choices = moe_drops(transformer.prefill, lm, cfg, pre, torch.float32,
                                         cache_len=cache_len)
            t_tok = LM_REQUESTS * LM_PROMPT
            log(f"phase 4 LM families {arch}: one prefill of {LM_REQUESTS} x {LM_PROMPT} at the "
                f"published capacity factor {cfg.moe.capacity_factor} ({t_tok} tokens, "
                f"{capacity(cfg.moe, t_tok)} slots an expert) dropped {dropped} of {choices} choices over "
                f"{cfg.n_layers - cfg.moe.first_k_dense} MoE layers; a decode step of "
                f"{LM_REQUESTS} rows drops none (cap = t)")
        profile_run(f"{arch} prefill {LM_REQUESTS} x {LM_PROMPT}", transformer.prefill, lm, cfg,
                    pre, torch.float32, cache_len=cache_len)
        _, caches, pos = transformer.prefill(lm, cfg, pre, torch.float32, cache_len=cache_len)
        profile_run(f"{arch} decode step, {LM_REQUESTS} rows", transformer.decode_step, lm, cfg,
                    full_b["tokens"][:, -1:], caches, pos)
        del caches

        # (b) the caches carry the forward's state; greedy = teacher-forced
        ccfg = no_drop_config(cfg)
        if ccfg is not cfg:
            outs = ServeEngine(cfg=ccfg, params=lm, device=dev).generate(reqs)
            toks = torch.tensor([o.tokens for o in outs])
        want, _, _ = transformer.prefill(lm, ccfg, full_b, torch.float32)
        _, caches, pos = transformer.prefill(lm, ccfg, pre, torch.float32, cache_len=LM_PROMPT + 8)
        got, _ = transformer.decode_step(lm, ccfg, full_b["tokens"][:, -1:], caches, pos)
        del caches
        err = check_close(f"{arch} prefill(T)+decode vs prefill(T+1)", got, want, LM_TOL, LM_TOL)
        seq = torch.cat([pre["tokens"], toks[:, :-1].to(dev, torch.int32)], dim=1)
        with torch.no_grad():
            h, _, _ = transformer.forward(lm, ccfg, {"tokens": seq})
            tf_logits = lm_logits(lm.embed, h[:, LM_PROMPT - 1 :], ccfg)
        ties = check_near_ties(f"{arch} greedy vs teacher-forced", toks.to(dev),
                               tf_logits.argmax(-1), tf_logits, LM_TOL)
        del h, tf_logits, engine, lm
        torch.cuda.empty_cache()

        # (c) card against CPU, the same weights at a shallower depth
        dcfg = full.replace(n_layers=cpu_depth)
        dmodel = get_model(dcfg)
        on_card = dmodel.init_params(torch.Generator(device=dev).manual_seed(SEED), dev)
        on_cpu = dmodel.init_params(torch.Generator(device=dev).manual_seed(SEED), "cpu")
        one = pre["tokens"][:1, :8]
        t = time.perf_counter()
        ref_logits = transformer.prefill(on_cpu, dcfg, {"tokens": one.cpu()}, torch.float32)[0]
        t_cpu = time.perf_counter() - t
        err_cpu = check_close(f"{arch} prefill card vs CPU", transformer.prefill(
            on_card, dcfg, {"tokens": one}, torch.float32)[0].cpu(), ref_logits, LM_TOL, LM_TOL)
        del on_card, on_cpu
        torch.cuda.empty_cache()
        log(f"phase 4 LM families {arch} checks: prefill(T)+decode vs prefill(T+1) max abs err "
            f"{err:.3g} (tol {LM_TOL}); greedy = teacher-forced argmax on {toks.numel()} tokens, "
            f"{ties} at near-ties"
            + (f" (both at capacity factor {ccfg.moe.capacity_factor}: cap = t, no drops)"
               if ccfg is not cfg else "")
            + f"; one 8-token prefill card vs the port on the CPU at {cpu_depth} of "
            f"{full.n_layers} layers (same weights, {t_cpu:.1f} s there) max abs err {err_cpu:.3g}; "
            f"{arch} took {time.perf_counter() - t_model:.1f} s")
    log(f"phase 4 LM families took {time.perf_counter() - t_phase:.1f} s")


def lm_decode_long(lm, cfg, p_bytes: int, dev) -> None:
    """Decode at a long context: LM_REQUESTS rows one step at the end of an
    LM_LONG_CTX-slot f32 cache per layer (decode_32k's context at the batch
    one card holds in f32: ~15 GB of cache), its contents drawn from a seeded
    generator. LM_LONG_STEPS steps timed on the host clock as generate runs
    them, then one profiled; beside the bound (params and cache read once)
    and the host's CPU share."""
    import os

    import torch

    from repro_torch.models import transformer

    b, ctx = LM_REQUESTS, LM_LONG_CTX
    g = torch.Generator(device=dev).manual_seed(SEED)
    caches = transformer.init_cache(cfg, b, ctx, torch.float32, dev)
    for c in caches:
        c["k"].normal_(generator=g)
        c["v"].normal_(generator=g)
    cache_bytes = sum(c[n].numel() * c[n].element_size() for c in caches for n in ("k", "v"))
    tok = torch.randint(0, cfg.vocab, (b, 1), generator=g, device=dev, dtype=torch.int32)
    pos = ctx - 1  # the step fills the last slot: every slot is valid
    logits, _ = transformer.decode_step(lm, cfg, tok, caches, pos)  # warm-up
    if logits.shape != (b, cfg.vocab) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"LM long decode: logits {tuple(logits.shape)} not finite")
    cpu, csw = host_usage()
    steps = [1e3 * sync_time(transformer.decode_step, lm, cfg, tok, caches, pos)[1]
             for _ in range(LM_LONG_STEPS)]
    cpu1, csw1 = host_usage()
    bnd = lm_bounds(cfg, b, 1, ctx, p_bytes)
    if bnd["decode_bytes"] != p_bytes + cache_bytes:
        raise AssertionError("LM long decode: the bound's bytes are not the params and cache")
    med = statistics.median(steps)
    log(f"phase 4 LM serve long decode: {b} rows at a {ctx:,}-token f32 cache "
        f"({cache_bytes:,} bytes) on {cfg.name}: {med:.3f} ms a step (median of {len(steps)}; "
        f"min {min(steps):.3f}, max {max(steps):.3f}) -> {b * 1e3 / med:.1f} tokens/s; bound "
        f"{bnd['decode'][0]:.3f} ms ({bnd['decode'][1]}: {bnd['decode_bytes']:,} bytes), "
        f"{bnd['decode'][0] / med:.1%} of it; host CPU seconds over wall "
        f"{1e3 * (cpu1 - cpu) / sum(steps):.2f}, involuntary context switches {csw1 - csw} "
        f"({os.cpu_count()} cores)")
    profile_run(f"LM decode step, {b} rows at {ctx:,}", transformer.decode_step, lm, cfg,
                tok, caches, pos)
    del caches
    torch.cuda.empty_cache()


def lm_embed_and_cluster(engine, p_bytes: int, dev) -> dict:
    """Embed-and-cluster through the engine's model: 512 synthetic documents
    (8 topics, 64 tokens) embedded through ServeEngine.embed, Buckshot k = 8
    on the card with its launch counts set to 0 just before and read just
    after (sim_best_edge, label_stats, assign_stats must each launch). Held
    against the port's plain CPU Buckshot on the same embeddings and sample:
    the HAC labels equal, the assignment equal but at near-ties, the initial
    centers (label_stats' sums) and the last centers (the K-Means passes)
    within the sum tolerance, the final similarities within SIM_TOL where
    both assign alike. Then each kernel against its plain version on the
    card at the path's shapes (launches made after the counts were read):
    label_stats on the sample and its labels, the final assign_stats pass
    (it must repeat the path's bit for bit, RSS included) against the plain
    fold over its own assignment, and sim_best_edge's round 1 on the sample
    (indices but at near-ties, similarities within SIM_TOL). Returns the
    launch counts."""
    import torch

    from repro_torch.common import l2_normalize
    from repro_torch.configs.base import ShapeCell
    from repro_torch.configs.flops import model_flops
    from repro_torch.core import metrics, sampling
    from repro_torch.core.buckshot import buckshot_fit
    from repro_torch.kernels import ops, ref
    from repro_torch.serve.engine import embed_documents
    from repro_torch.text import pipeline, synth

    cfg = engine.cfg
    corpus = synth.make_corpus(EMBED_DOCS, vocab=512, n_topics=EMBED_TOPICS, seed=1)
    tokens = synth.tokens_from_counts(corpus.counts, cfg.vocab, EMBED_SEQ, seed=2)
    embed_documents(engine, tokens[:64])  # warm-up
    x, t_embed = sync_time(embed_documents, engine, tokens)
    n = x.shape[0]
    if x.shape != (EMBED_DOCS, cfg.d_model) or not bool(torch.isfinite(x).all()):
        raise AssertionError(f"LM embed: {tuple(x.shape)} rows, finite {bool(torch.isfinite(x).all())}")
    k = EMBED_TOPICS
    s = sampling.buckshot_sample_size(n, k)
    sidx = sampling.sample_indices(n, s, torch.Generator().manual_seed(SEED), dev)
    ops.reset_launch_counts()
    res, t_fit = sync_time(buckshot_fit, x, sidx, k, kmeans_iters=2)
    counts = ops.launch_counts()
    path = {name: counts[name] for name in ("sim_best_edge", "label_stats", "assign_stats")}
    if min(path.values()) == 0:
        raise AssertionError(f"LM embed-and-cluster did not launch every kernel: {path}")

    # the path against the plain CPU path
    plain = buckshot_fit(x.cpu(), sidx.cpu(), k, kmeans_iters=2)
    if not torch.equal(res.sample_labels.cpu(), plain.sample_labels):
        raise AssertionError("LM embed-and-cluster: HAC labels differ from the plain path's")
    xc, centers = x.cpu(), plain.kmeans.centers
    near = check_argmax("LM embed-and-cluster assignment", res.kmeans.assignment.cpu(),
                        None, plain.kmeans.assignment, (xc @ centers.T).amax(1),
                        lambda rows, cols: (xc[rows] * centers[cols]).sum(1))
    alike = res.kmeans.assignment.cpu() == plain.kmeans.assignment
    errs = {
        "init_centers": check_close("LM embed-and-cluster init_centers", res.init_centers.cpu(),
                                    plain.init_centers, SUM_RTOL, SUM_ATOL),
        "centers": check_close("LM embed-and-cluster centers", res.kmeans.centers.cpu(),
                               plain.kmeans.centers, SUM_RTOL, SUM_ATOL),
        "best_sim": check_close("LM embed-and-cluster best_sim", res.kmeans.best_sim.cpu()[alike],
                                plain.kmeans.best_sim[alike], 0.0, SIM_TOL),
    }

    # each kernel against its plain version at the path's shapes
    xs = l2_normalize(x[sidx.long()])
    got = ops.label_stats(xs, res.sample_labels, k)
    want = ref.label_stats_scatter(xs, res.sample_labels, k)
    errs["label_stats"] = max(
        check_close(f"LM embed-and-cluster label_stats {name}", a, b, SUM_RTOL, SUM_ATOL)
        for name, a, b in zip(("sums", "counts"), got, want)
    )
    st = ops.assign_stats(x, res.kmeans.centers)
    rss = metrics.rss_from_assignment_stats(st.sums, st.counts, torch.sum(st.sumsq), k)
    if not (torch.equal(st.idx, res.kmeans.assignment)
            and torch.equal(st.best_sim, res.kmeans.best_sim) and torch.equal(rss, res.kmeans.rss)):
        raise AssertionError("LM embed-and-cluster: the final assign_stats pass does not repeat")
    errs["assign_stats"] = check_stats_fold(
        "LM embed-and-cluster assign_stats", x, torch.ones((n,), device=dev), k, st)
    lab = torch.arange(s, dtype=torch.int32, device=dev)
    got = ops.sim_best_edge(xs, xs, lab, lab)
    want = ref.sim_best_edge(xs, xs, lab, lab)
    near_edge = check_argmax("LM embed-and-cluster sim_best_edge", got[0], got[1], want[0],
                             want[1], lambda rows, cols: (xs[rows] * xs[cols]).sum(1))
    errs["sim_best_edge"] = check_close("LM embed-and-cluster sim_best_edge best_s", got[1],
                                        want[1], 0.0, SIM_TOL)

    def quality(assignment):
        t = torch.from_numpy(truth).to(dev)
        return (float(metrics.purity(assignment, t, k, k)),
                float(metrics.nmi(assignment, t, k, k)))

    embed_flops = model_flops(cfg, ShapeCell("embed", "prefill", EMBED_SEQ, n))["model_flops"]
    embed_bound = bound_ms(embed_flops, p_bytes + x.numel() * 4)
    x_tfidf, truth = pipeline.prepare_local(corpus, dev)
    pur, nmi = quality(buckshot_fit(x_tfidf, sidx, k, kmeans_iters=2).kmeans.assignment)
    pur2, nmi2 = quality(res.kmeans.assignment)
    log(f"phase 4 LM embed-and-cluster: {n} docs x {EMBED_SEQ} tokens embedded in "
        f"{t_embed:.3f} s ({n * EMBED_SEQ / t_embed:.0f} tokens/s; bound "
        f"{embed_bound[0] / 1e3:.3f} s by {embed_bound[1]}), Buckshot k = {k} "
        f"(s = {s}) in {t_fit:.4f} s; launches {path}; labels equal to the plain CPU path's "
        f"but {near} at near-ties; max abs err against the plain path and, per kernel, "
        f"against its plain version at these shapes {errs} (sim_best_edge round 1: {near_edge} "
        f"at near-ties); tf-idf + Buckshot purity={pur:.3f} nmi={nmi:.3f}; "
        f"{cfg.name} + Buckshot purity={pur2:.3f} nmi={nmi2:.3f} (random weights)")
    return path


def timing_label_stats(x, xs, labels, dev):
    """label_stats at Buckshot's centers (3,536 x 2,048, k = 50): back to
    back, with the L2 flushed before each call, the two kernels alone
    (profiled), the plain version and index_add_; then the fold alone at the
    1 GB shape for k = 50 and k = BigK = 800, over nearest-center labels (the
    labels a K-Means or BKC pass folds). Returns the kernels line's row."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.assign_argmax import assign_argmax_cuda
    from repro_torch.kernels.assign_stats import label_stats_cuda

    s, d = xs.shape
    n = x.shape[0]
    names = ("stats_fold", "stats_reduce")
    lib_idx = labels.long()

    def call():
        return label_stats_cuda(xs, labels, K)

    def library():
        return torch.zeros((K, d), device=dev).index_add_(0, lib_idx, xs)

    row = dict(
        ms=event_ms(call, 50),
        plain_ms=event_ms(lambda: ref.label_stats_scatter(xs, labels, K), 50),
        library_ms=event_ms(library, 50),
        bound=bound_ms(2.0 * s * d, s * d * 4 + s * 4 + K * d * 4 + K * 4),
        cold_ms=event_ms_cold(call, 30),
        library_cold_ms=event_ms_cold(library, 30),
        profiled_ms=profiled_kernel_ms(call, 20, names),
    )
    log(f"phase 3 timing label_stats {s}x{d} k={K}: kernel {row['ms']:.4f} ms back to back "
        f"(L2 flushed before each call: {row['cold_ms']:.4f} ms; the fold and reduce alone, "
        f"profiled: {row['profiled_ms']:.4f} ms), index_add_ {row['library_ms']:.4f} ms (L2 "
        f"flushed: {row['library_cold_ms']:.4f} ms), plain {row['plain_ms']:.4f} ms, bound "
        f"{row['bound'][0]:.4f} ms ({row['bound'][1]})")
    g = torch.Generator().manual_seed(7)
    for k in (K, BIG_K):
        lab = assign_argmax_cuda(x, x[torch.randperm(n, generator=g)[:k].to(dev)])[0]
        ms = event_ms(lambda: label_stats_cuda(x, lab, k), 10)
        prof = profiled_kernel_ms(lambda: label_stats_cuda(x, lab, k), 5, names)
        lib = event_ms(lambda: torch.zeros((k, d), device=dev).index_add_(0, lab.long(), x), 5)
        bnd = bound_ms(2.0 * n * d, n * d * 4 + n * 4 + k * d * 4 + k * 4)
        log(f"phase 3 timing label_stats fold at n={n} d={d} k={k}: kernel {ms:.4f} ms "
            f"(profiled {prof:.4f} ms), index_add_ {lib:.4f} ms, bound {bnd[0]:.4f} ms "
            f"({bnd[1]}): {ms / bnd[0]:.2f}x the bound")
    return row


def timing_flash_decode(dev):
    """flash_decode at the kernel bench's cache (f32) and llama3.2-3b's heads
    (bf16): kernel, the kernel alone (profiled), plain version, SDPA over
    k[:length] and the bound."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_decode import flash_decode_cuda

    rows = {}
    for name in DECODE_CASES:
        h, hk, dh, s, _, length = DECODE_CASES[name]
        q, k, v, ln = decode_inputs(name, dev)
        kt, vt = (a[:length].permute(1, 0, 2).contiguous()[None] for a in (k, v))
        qt = q[None, :, None, :]
        nb = k.element_size()

        def library():
            return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True)

        def call():
            return flash_decode_cuda(q, k, v, ln)

        want = ref.flash_decode(q, k, v, length)
        lib_err = (library()[0, :, 0, :].float() - want.float()).abs().max().item()
        row = dict(
            ms=event_ms(call, 30),
            plain_ms=event_ms(lambda: ref.flash_decode(q, k, v, ln), 5),
            library_ms=event_ms(library, 30),
            bound=bound_ms(4.0 * h * length * dh, 2 * length * hk * dh * nb + 2 * h * dh * nb),
            profiled_ms=profiled_kernel_ms(call, 10, ("flash_decode",)),
        )
        rows[f"flash_decode {name}"] = row
        del kt, vt
        log(f"phase 3 timing flash_decode {name} (h={h} hk={hk} dh={dh} s={s} length={length}): "
            f"kernel {row['ms']:.4f} ms (alone, profiled: {row['profiled_ms']:.4f} ms), plain "
            f"{row['plain_ms']:.4f} ms, library "
            f"scaled_dot_product_attention(enable_gqa=True) over k[:length] {row['library_ms']:.4f} "
            f"ms (|library - plain| {lib_err:.2e}), bound {row['bound'][0]:.4f} ms "
            f"({row['bound'][1]}: 2*length*hk*dh*{nb} B)")
    return rows


def kernels_only(dev) -> None:
    """``--kernels``: phase 1, then phase 3's timings of sim_best_edge (the
    self-search and the full grid), component_best_edge (round 1 of that
    search), label_stats, assign_stats (k = 50), best_edge (2,000 x 2,000
    and xs @ xs.T), assign_argmax (k = 400), assign_stats_bounded (BigK =
    800, the five settings of phase_timing_bkc) and flash_decode, on random unit rows of the 1 GB shape, without the
    paths; last Buckshot on the 1 GB collection, its RSS and a digest of its
    labels: the tool for timing two trees' kernels in one call. It uses only
    the wrappers' and ops' public signatures, so it also times an older
    tree's kernels when copied into that tree's root."""
    import torch

    from repro_torch.common import l2_normalize

    g = torch.Generator(device=dev).manual_seed(SEED)
    n, d = 250_000, 2048
    x = l2_normalize(torch.rand((n, d), generator=g, device=dev))
    s = 3536
    xs = l2_normalize(x[torch.randperm(n, generator=g, device=dev)[:s]])
    labels = torch.randint(0, K, (s,), generator=g, device=dev, dtype=torch.int32)
    timing_sim_best_edge(xs, torch.arange(s, dtype=torch.int32, device=dev))
    timing_cbe_round1(xs)
    timing_label_stats(x, xs, labels, dev)
    r = timing_assign_stats(x, xs[:K].contiguous())
    log(f"phase 3 timing assign_stats (k={K}): kernel {r['ms']:.4f} ms, plain "
        f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, bound "
        f"{r['bound'][0]:.4f} ms ({r['bound'][1]})")
    timing_best_edge(xs, dev)
    del xs
    phase_timing_bkc(x, bkc_state(x, dev), dev)
    del x
    torch.cuda.empty_cache()
    timing_flash_decode(dev)
    torch.cuda.empty_cache()
    buckshot_digest(dev)


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
    card = phase_device()
    if sys.argv[1:] == ["--kernels"]:
        kernels_only(dev)
        return 0

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
    phase_parity_pipe_edges(dev)
    errs_bkc, state = phase_parity_main_bkc(x, dev)
    errs.update(errs_bkc)
    errs["component_best_edge"] = phase_parity_edges_cbe(dev)
    errs["best_edge"] = phase_parity_best_edge(xs, dev)
    errs["flash_decode"] = phase_parity_flash_decode(dev)
    log(f"phase 2 parity took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    times = phase_timing(x, xs, dev)
    times.update(phase_timing_bkc(x, state, dev))
    stream_rows = phase_timing_stream_kernels(xs, dev)
    times["best_edge"] = stream_rows[f"best_edge {s}x{s}"]
    times["flash_decode"] = stream_rows["flash_decode kernel_bench f32"]
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
    # the two kernels' own path: their public ops at the phase 3 shapes
    op_counts = phase_ops_stream_kernels(l2_normalize(x[sidx]), dev)
    counts["best_edge"], counts["flash_decode"] = op_counts["best_edge"], op_counts["flash_decode"]
    log(f"phase 4 paths took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    ctx = phase_stream_host(x, dev)
    phase_stream_checkpoint(ctx, card, dev)
    t_d = time.perf_counter()
    phase_distributed_stream(ctx, x, card, dev)
    log(f"phase 4 distributed streaming took {time.perf_counter() - t_d:.1f} s")
    del x, ctx
    torch.cuda.empty_cache()
    phase_stream_regen(dev)
    log(f"phase 4 streaming paths took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_serve(card, dev)
    log(f"phase 4 serve took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_lm_serve(card, dev)
    torch.cuda.empty_cache()
    log(f"phase 4 LM serve took {time.perf_counter() - t:.1f} s")
    phase_lm_families(card, dev)
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
        "best_edge": ("src/repro_torch/kernels/csrc/best_edge.cu",
                      "src/repro/kernels/best_edge.py:97"),
        "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                         "src/repro/kernels/flash_decode.py:124"),
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
