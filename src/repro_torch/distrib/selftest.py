"""SPMD equivalence self-test: ``python -m repro_torch.distrib.selftest``.

Starts ``--world`` ranks (default 4) as processes on the CPU, joined by a
gloo group through a file in a temporary directory (no network), and holds
the distributed K-Means, BKC and Buckshot (both phase-1 flavours) against
the port's resident fits on the same inits, with padded (weight-0) rows,
and the bound-pruned K-Means and BKC jobs against the unbounded ones (equal):
RSS within 2e-4 relative (the ranks' partial sums are added in another
order than one device adds them), assignments equal on >= 99.9 % of rows.
Prints ``SELFTEST OK`` and exits 0 when every rank passes.

``--bf16`` holds the bf16 mode instead: on exact unit rows (integers over 8,
norm 1: bf16 values, every similarity and sum exact in any order) every
Borůvka mode, the sampled rows and the K-Means, BKC and Buckshot jobs on
bf16 shards give the bits of the same jobs on the f32 rows, and the sampled
rows are bf16 and equal the rows at the sampled ids. Rank 0 prints what the
collectives carried in each mode (``wire_log``): the check that the host's
gloo moves bf16 tensors as they are.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import os
import sys
import tempfile


@contextlib.contextmanager
def wire_log():
    """Count what this rank's collectives send while the block runs:
    {(op, dtype): [calls, bytes]}, an all_reduce's and an all_gather's input,
    each isend of a ring hop. It wraps ``torch.distributed``'s functions,
    which the engine looks up at each call."""
    import torch.distributed as dist

    seen: dict = collections.defaultdict(lambda: [0, 0])
    real = {name: getattr(dist, name) for name in ("all_reduce", "all_gather",
                                                   "batch_isend_irecv")}

    def note(op, t):
        entry = seen[(op, str(t.dtype).removeprefix("torch."))]
        entry[0] += 1
        entry[1] += t.numel() * t.element_size()

    def all_reduce(t, *args, **kwargs):
        note("all_reduce", t)
        return real["all_reduce"](t, *args, **kwargs)

    def all_gather(parts, t, *args, **kwargs):
        note("all_gather", t)
        return real["all_gather"](parts, t, *args, **kwargs)

    def batch_isend_irecv(ops):
        for op in ops:
            if op.op is dist.isend:
                note("isend", op.tensor)
        return real["batch_isend_irecv"](ops)

    dist.all_reduce, dist.all_gather = all_reduce, all_gather
    dist.batch_isend_irecv = batch_isend_irecv
    try:
        yield seen
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)


def format_wire(seen: dict) -> str:
    return "; ".join(f"{op} {dt} x{calls} {nbytes:,} B"
                     for (op, dt), (calls, nbytes) in sorted(seen.items()))


def _checks(rank: int, world: int) -> list[str]:
    import numpy as np
    import torch

    from repro_torch.common import l2_normalize
    from repro_torch.core import bkc_fit, buckshot_fit, kmeans_fit, metrics
    from repro_torch.distrib import cluster as dc
    from repro_torch.distrib.sharding import make_flat_mesh, pad_rows_to_multiple, shard_rows

    mesh = make_flat_mesh()
    axes = ("data",)
    rng = np.random.default_rng(0)
    k, n, d = 10, 1999, 96  # n does not divide over the ranks: the pad path
    blobs = rng.normal(size=(k, d))
    lab = rng.integers(0, k, size=n)
    x1 = l2_normalize(torch.from_numpy(
        (blobs[lab] + 0.4 * rng.normal(size=(n, d))).astype(np.float32)))
    xp, w = pad_rows_to_multiple(x1, world)
    x_l, w_l = shard_rows(mesh, axes, xp), shard_rows(mesh, axes, w)
    b = x_l.shape[0]
    lo = rank * b
    hi = max(lo, min(lo + b, n))  # this rank's real rows: [lo, hi)
    failures = []

    def same_rss(name, want, got):
        if not np.isclose(float(want), float(got), rtol=2e-4):
            failures.append(f"{name} rss mismatch: {float(want)} vs {float(got)}")

    def same_labels(name, want, got):
        if (want[lo:hi] != got[: hi - lo]).float().mean() > 0.001:
            failures.append(f"{name} assignment mismatch > 0.1%")

    # ---- K-Means: distributed == resident given the same init
    init = l2_normalize(x1[rng.choice(n, k, replace=False)])
    ref = kmeans_fit(x1, init, k, max_iters=6, tol=1e-4)
    got = dc.kmeans_distributed(mesh, axes, x_l, w_l, init, k, max_iters=6, tol=1e-4)
    same_rss("kmeans", ref.rss, got.rss)
    same_labels("kmeans", ref.assignment, got.assignment)
    # the bounds are shard-local row state: the same labels and centers
    bnd = dc.kmeans_distributed(mesh, axes, x_l, w_l, init, k, max_iters=6, tol=1e-4,
                                bounded=True)
    if not (torch.equal(bnd.assignment, got.assignment) and torch.equal(bnd.centers, got.centers)):
        failures.append("bounded kmeans differs from the unbounded distributed run")
    pur = float(metrics.purity(got.assignment[: hi - lo], torch.from_numpy(lab[lo:hi]), k, k))
    if pur < 0.5:
        failures.append(f"kmeans purity suspiciously low: {pur}")

    # ---- BKC: three-job pipeline == resident bkc_fit
    big_k = 64
    cinit = l2_normalize(x1[rng.choice(n, big_k, replace=False)])
    ref_b = bkc_fit(x1, cinit, big_k, k)
    got_b = dc.bkc_distributed(mesh, axes, x_l, w_l, cinit, big_k, k)
    same_rss("bkc", ref_b.rss, got_b.rss)
    same_labels("bkc", ref_b.assignment, got_b.assignment)
    bnd_b = dc.bkc_distributed(mesh, axes, x_l, w_l, cinit, big_k, k, bounded=True)
    if not torch.equal(bnd_b.assignment, got_b.assignment):
        failures.append("bounded bkc differs from the unbounded distributed run")

    # ---- Buckshot: the distributed sample is a uniform subset of real rows,
    # and the pipeline matches the resident one seeded with the same rows
    s, seed = 160, 7
    xs = dc.sample_rows_distributed(mesh, axes, x_l, w_l, s, seed)
    dist2 = ((xs[:, None, :] - x1[None, :, :]) ** 2).sum(-1)
    match = torch.argmin(dist2, dim=1)
    if not (dist2[torch.arange(s), match] < 1e-10).all():
        failures.append("sampled rows not found in the dataset (or padding sampled)")
    if torch.unique(match).shape[0] != s:
        failures.append("the sample repeats a row")
    ref_bs = buckshot_fit(x1, match, k, kmeans_iters=3)
    for hac in ("replicated", "boruvka"):
        got_bs = dc.buckshot_distributed(mesh, axes, x_l, w_l, k, seed, sample_size=s,
                                         kmeans_iters=3, hac=hac)
        same_rss(f"buckshot ({hac})", ref_bs.kmeans.rss, got_bs.rss)
        same_labels(f"buckshot ({hac})", ref_bs.kmeans.assignment, got_bs.assignment)
    return failures


def _exact_unit(rng, s: int, d: int = 16):
    """(s, d) rows k / 8 with integer k in [-3, 3] and sum(k^2) = 64."""
    import numpy as np

    rows: list = []
    while len(rows) < s:
        k = rng.integers(-3, 4, size=(4 * s, d))
        rows.extend(k[(k * k).sum(1) == 64])
    return (np.asarray(rows[:s]) / 8).astype(np.float32)


# boruvka_mst_distributed's four candidate modes, then the sharded sweep's
# other settings
BF16_MODES = {"sharded": {}, "bcast": {"sweep": "bcast"}, "point": {"merge": "point"},
              "rowgather": {"pre_reduce": False}, "expanded": {"compact": False},
              "no-overlap": {"overlap": False}}


def _bf16_run(mesh, axes, xs, x, w) -> dict:
    """Every resident distributed route on rows of one dtype: {name: tensor}."""
    from repro_torch.distrib import cluster as dc
    from repro_torch.distrib.hac_parallel import boruvka_mst_distributed
    from repro_torch.distrib.sharding import shard_rows

    k, big_k, s, seed = 5, 16, 40, 3
    x_l, w_l = shard_rows(mesh, axes, x), shard_rows(mesh, axes, w)
    out = {}
    for mode, kw in BF16_MODES.items():
        for f, v in boruvka_mst_distributed(mesh, axes, xs, **kw)._asdict().items():
            out[f"boruvka {mode} {f}"] = v
    out["sample"] = dc.sample_rows_distributed(mesh, axes, x_l, w_l, s, seed)
    n = int(w.sum())
    fits = {
        "kmeans": lambda: dc.kmeans_distributed(mesh, axes, x_l, w_l, x[:k], k, max_iters=6),
        "kmeans bounded": lambda: dc.kmeans_distributed(mesh, axes, x_l, w_l, x[:k], k,
                                                        max_iters=6, bounded=True),
        "bkc": lambda: dc.bkc_distributed(mesh, axes, x_l, w_l, x[n - big_k:n], big_k, k),
        "bkc bounded": lambda: dc.bkc_distributed(mesh, axes, x_l, w_l, x[n - big_k:n], big_k,
                                                  k, bounded=True),
        "buckshot replicated": lambda: dc.buckshot_distributed(
            mesh, axes, x_l, w_l, k, seed, sample_size=s, hac="replicated"),
        "buckshot boruvka": lambda: dc.buckshot_distributed(
            mesh, axes, x_l, w_l, k, seed, sample_size=s, hac="boruvka"),
    }
    for name, fit in fits.items():
        res = fit()
        for f in ("centers", "assignment", "rss", "objective"):
            out[f"{name} {f}"] = getattr(res, f)
    return out


def _bf16_checks(rank: int, world: int) -> list[str]:
    import numpy as np
    import torch

    from repro_torch.distrib import cluster as dc
    from repro_torch.distrib.sharding import make_flat_mesh, pad_rows_to_multiple, shard_rows

    mesh, axes = make_flat_mesh(), ("data",)
    rng = np.random.default_rng(0)
    xs32 = torch.from_numpy(_exact_unit(rng, 70))  # 70 rows pad over 3 and 4 ranks
    x32 = torch.from_numpy(_exact_unit(rng, 202))
    failures = []
    runs, wires = {}, {}
    for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        xp, w = pad_rows_to_multiple(x32.to(dt), world)
        with wire_log() as seen:
            runs[name] = _bf16_run(mesh, axes, xs32.to(dt), xp, w)
        wires[name] = seen
    xp, w = pad_rows_to_multiple(x32.bfloat16(), world)
    ids = dc.sample_indices_distributed(mesh, axes, shard_rows(mesh, axes, w), 40, 3).long()
    sample = runs["bf16"]["sample"]
    if sample.dtype != torch.bfloat16 or not torch.equal(sample.view(torch.int16),
                                                         xp[ids].view(torch.int16)):
        failures.append(f"bf16 sample rows ({sample.dtype}) are not the rows at the ids")
    for key, got in runs["bf16"].items():
        want = runs["f32"][key]
        if key == "sample":
            got = got.float()
        if got.dtype != want.dtype:
            failures.append(f"{key}: {got.dtype} in the bf16 mode, {want.dtype} in f32")
        elif not torch.equal(got.view(torch.int32) if got.dtype == torch.float32 else got,
                             want.view(torch.int32) if want.dtype == torch.float32 else want):
            failures.append(f"{key}: the bf16 mode's bits differ from the f32 mode's")
    if rank == 0:
        for name, seen in wires.items():
            print(f"rank 0 wire {name}: {format_wire(seen)}", flush=True)
    return failures


def _rank_main(rank: int, world: int, init_file: str, bf16: bool = False) -> int:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        failures = (_bf16_checks if bf16 else _checks)(rank, world)
    finally:
        dist.destroy_process_group()
    for f in failures:
        print(f"rank {rank}: {f}", flush=True)
    return 1 if failures else 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--world", type=int, default=4)
    p.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    p.add_argument("--init-file", help=argparse.SUPPRESS)
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--bf16", action="store_true",
                   help="hold the bf16 mode to the f32 mode on exact rows")
    args = p.parse_args(argv)
    if args.rank is not None:
        return _rank_main(args.rank, args.world, args.init_file, args.bf16)
    import subprocess

    env = dict(os.environ, OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory() as tmp:
        init = os.path.join(tmp, "init")
        procs = [
            subprocess.Popen([sys.executable, "-m", "repro_torch.distrib.selftest",
                              "--world", str(args.world), "--rank", str(r),
                              "--init-file", init] + ["--bf16"] * args.bf16, env=env)
            for r in range(args.world)
        ]
        try:
            codes = [pr.wait(timeout=args.timeout) for pr in procs]
        finally:
            for pr in procs:
                if pr.poll() is None:
                    pr.kill()
                    pr.wait()
    if any(codes):
        print("SELFTEST FAIL")
        return 1
    if args.bf16:
        print(f"SELFTEST OK: bf16 shards == f32 shards bit for bit, Borůvka in every mode, "
              f"the sample, kmeans/bkc/buckshot ({args.world} ranks)")
    else:
        print(f"SELFTEST OK: kmeans/bkc/buckshot distributed == resident ({args.world} ranks)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
