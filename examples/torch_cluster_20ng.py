"""End-to-end distributed clustering driver on the port — the paper's main
experiment.

    PYTHONPATH=src python examples/torch_cluster_20ng.py                  # one card
    PYTHONPATH=src python examples/torch_cluster_20ng.py --cpu --ranks 8 --n 20000 --k 50

The same driver as ``cluster_20ng.py``, on ``repro_torch``: ``--ranks N``
processes (gloo on the CPU, NCCL on cards, one card a rank) form a flat
mesh, prepare the corpus with DISTRIBUTED tf-idf, then run parallel
K-Means, BKC (3 MapReduce jobs) and Buckshot (distributed sample -> HAC ->
2 K-Means iterations), reporting the paper's metrics (time, RSS) plus
purity/NMI against ground truth. Timings include each job's first call
(the card's kernels build once a process; Hadoop's per-job setup is the
analogue).
"""

import argparse
import os
import sys
import tempfile
import time

import torch

from repro_torch.launch.ranks import spawn_ranks


def run(args, rank: int, world: int) -> None:
    import torch.distributed as dist

    from repro_torch.core import metrics
    from repro_torch.core.sampling import buckshot_sample_size
    from repro_torch.distrib import cluster as dc
    from repro_torch.distrib.sharding import axis_groups, make_flat_mesh
    from repro_torch.text.pipeline import prepare_synthetic

    if args.cpu:
        device = torch.device("cpu")
    else:
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group("gloo" if args.cpu else "nccl",
                            init_method=f"file://{args.init_file}", rank=rank,
                            world_size=world)
    try:
        mesh = make_flat_mesh()
        axes = ("data",)
        (group,) = axis_groups(mesh, axes)
        if rank == 0:
            name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
            print(f"mesh: {world} ranks on {name}; corpus: n={args.n}, vocab={args.vocab}",
                  flush=True)
        prep = prepare_synthetic(mesh, axes, n_docs=args.n, vocab=args.vocab, n_topics=20,
                                 seed=20)
        labels = torch.as_tensor(prep.labels).long()
        k = args.k

        def quality(assignment):
            parts = [torch.empty_like(assignment) for _ in range(world)]
            dist.all_gather(parts, assignment.contiguous(), group=group)
            a = torch.cat(parts)[: prep.n].cpu().long()
            return (float(metrics.purity(a, labels, k, 20)),
                    float(metrics.nmi(a, labels, k, 20)))

        def timed(fn):
            dist.barrier(group=group)
            t0 = time.perf_counter()
            res = fn()
            if device.type == "cuda":
                torch.cuda.synchronize()
            return res, time.perf_counter() - t0

        def show(line):
            if rank == 0:
                print(line, flush=True)

        # ---- parallel K-Means (PKMeans baseline), from k random documents
        init = dc.sample_rows_distributed(mesh, axes, prep.x, prep.w, k, 0)
        km, t_km = timed(lambda: dc.kmeans_distributed(mesh, axes, prep.x, prep.w, init, k,
                                                       max_iters=8))
        pur, nmi = quality(km.assignment)
        show(f"K-Means   {t_km*1e3:9.1f} ms  RSS={float(km.rss):9.2f} "
             f"iters={km.iterations}  purity={pur:.3f} nmi={nmi:.3f}")

        # ---- BKC (the paper's three MapReduce jobs)
        cinit = dc.sample_rows_distributed(mesh, axes, prep.x, prep.w, args.big_k, 1)
        bk, t_bk = timed(lambda: dc.bkc_distributed(mesh, axes, prep.x, prep.w, cinit,
                                                    args.big_k, k))
        pur, nmi = quality(bk.assignment)
        show(f"BKC       {t_bk*1e3:9.1f} ms  RSS={float(bk.rss):9.2f} "
             f"({100*(1-t_bk/t_km):5.1f}% faster)  purity={pur:.3f} nmi={nmi:.3f}")

        # ---- Buckshot (distributed sample -> single-link HAC -> 2 iterations)
        s = buckshot_sample_size(args.n, k)
        s -= s % world  # shard-aligned sample
        bs, t_bs = timed(lambda: dc.buckshot_distributed(
            mesh, axes, prep.x, prep.w, k, 2, sample_size=s, kmeans_iters=2, hac=args.hac))
        pur, nmi = quality(bs.assignment)
        show(f"Buckshot  {t_bs*1e3:9.1f} ms  RSS={float(bs.rss):9.2f} "
             f"({100*(1-t_bs/t_km):5.1f}% faster, s={s}, hac={args.hac})  "
             f"purity={pur:.3f} nmi={nmi:.3f}")
    finally:
        dist.destroy_process_group()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain PyTorch)")
    ap.add_argument("--ranks", type=int, default=1, help="processes (gloo on the CPU, NCCL on cards)")
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--k", type=int, default=50)
    ap.add_argument("--big-k", type=int, default=250)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--hac", choices=["replicated", "boruvka"], default="replicated")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--init-file", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        run(args, args.rank, args.ranks)
        return 0
    if args.ranks == 1:
        args.init_file = os.path.join(tempfile.mkdtemp(), "init")
        run(args, 0, 1)
        return 0
    return spawn_ranks([__file__, *(argv if argv is not None else sys.argv[1:])], args.ranks)


if __name__ == "__main__":
    sys.exit(main())
