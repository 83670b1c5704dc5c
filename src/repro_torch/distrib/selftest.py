"""SPMD equivalence self-test: ``python -m repro_torch.distrib.selftest``.

Starts ``--world`` ranks (default 4) as processes on the CPU, joined by a
gloo group through a file in a temporary directory (no network), and holds
the distributed K-Means, BKC and Buckshot (both phase-1 flavours) against
the port's resident fits on the same inits, with padded (weight-0) rows,
and the bound-pruned K-Means and BKC jobs against the unbounded ones (equal):
RSS within 2e-4 relative (the ranks' partial sums are added in another
order than one device adds them), assignments equal on >= 99.9 % of rows.
Prints ``SELFTEST OK`` and exits 0 when every rank passes.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile


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


def _rank_main(rank: int, world: int, init_file: str) -> int:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        failures = _checks(rank, world)
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
    args = p.parse_args(argv)
    if args.rank is not None:
        return _rank_main(args.rank, args.world, args.init_file)
    import subprocess

    env = dict(os.environ, OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory() as tmp:
        init = os.path.join(tmp, "init")
        procs = [
            subprocess.Popen([sys.executable, "-m", "repro_torch.distrib.selftest",
                              "--world", str(args.world), "--rank", str(r),
                              "--init-file", init], env=env)
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
    print(f"SELFTEST OK: kmeans/bkc/buckshot distributed == resident ({args.world} ranks)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
