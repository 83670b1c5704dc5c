"""Quickstart on the port: cluster a synthetic 20-newsgroups-like corpus
three ways, OUT-OF-CORE — the dense (n, d) matrix never exists.

    PYTHONPATH=src python examples/torch_quickstart.py            # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --cpu      # on the CPU
    PYTHONPATH=src python examples/torch_quickstart.py --cpu --ranks 4

The same demo as ``quickstart.py``, on ``repro_torch``. It generates 4000
documents from a 12-topic model as a chunked stream (4 chunks of 1000),
weights them with streaming two-pass tf-idf, and runs the paper's three
algorithms through their streaming entry points (K-Means baseline, BKC,
Buckshot), printing time / RSS / purity / NMI for each. Peak residency is
O(chunk·d), so the same script runs at n = 1M by changing ``--n``.

With ``--ranks N`` (N > 1) it starts N processes joined by gloo (``--cpu``)
or NCCL (one card a rank), and the same stream also runs the DISTRIBUTED
streaming Buckshot (chunks sharded on arrival, sample drawn by the sharded
one-pass reservoir, one collective per pass) on a flat mesh, or a (2, N/2)
pod mesh where N >= 4 is even.
"""

import argparse
import sys
import time

import torch

from repro_torch.launch.ranks import spawn_ranks


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(args, rank: int, world: int) -> None:
    import torch.distributed as dist

    from repro_torch.core import bkc_stream, buckshot_stream, kmeans_stream, metrics
    from repro_torch.text import pipeline

    if args.cpu:
        device = torch.device("cpu")
    else:
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if world > 1:
        dist.init_process_group("gloo" if args.cpu else "nccl",
                                init_method=f"file://{args.init_file}", rank=rank,
                                world_size=world)
    n, k, chunk = args.n, 12, args.chunk
    labels = None

    def report(name, fn):
        fn()  # warm: the first call builds the kernels
        t0 = time.perf_counter()
        res = fn()
        _sync(device)
        dt = time.perf_counter() - t0
        km = res.kmeans if hasattr(res, "kmeans") else res
        a = torch.as_tensor(km.assignment).cpu().long()
        pur = float(metrics.purity(a, labels, k, k))
        nmi = float(metrics.nmi(a, labels, k, k))
        print(f"{name:22s} {dt*1e3:8.1f} ms   RSS={float(km.rss):8.2f}   "
              f"purity={pur:.3f}   nmi={nmi:.3f}", flush=True)
        return dt, float(km.rss)

    if rank == 0:
        name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        print(f"streaming corpus: n={n}, topics={k}, chunks of {chunk}; on {name}")
        prep = pipeline.prepare_synthetic_stream(
            n_docs=n, vocab=2048, n_topics=k, seed=0, chunk=chunk, device=device)
        xs, labels = prep.x, torch.as_tensor(prep.labels).long()

        def gen(seed):  # the streaming fits draw their samples on the host
            return torch.Generator().manual_seed(seed)

        t_km, rss_km = report("K-Means (8 iters)",
                              lambda: kmeans_stream(xs, k, gen(0), max_iters=8, device=device))
        t_bk, rss_bk = report("BKC (BigK=64)", lambda: bkc_stream(xs, 64, k, gen(0), device=device))
        t_bs, rss_bs = report("Buckshot (2 iters)",
                              lambda: buckshot_stream(xs, k, gen(0), kmeans_iters=2, device=device))
        print(f"\nBKC:      {100*(1-t_bk/t_km):5.1f}% faster, "
              f"RSS loss {100*(rss_bk/rss_km-1):+5.2f}%")
        print(f"Buckshot: {100*(1-t_bs/t_km):5.1f}% faster, "
              f"RSS loss {100*(rss_bs/rss_km-1):+5.2f}%")

    if world > 1:
        from repro_torch.core.sampling import buckshot_sample_size
        from repro_torch.distrib.cluster import buckshot_distributed_stream
        from repro_torch.distrib.sharding import make_flat_mesh, make_pod_mesh

        if world >= 4 and world % 2 == 0:
            # pod mesh: collectives resolve intra-pod before anything crosses pods
            mesh, axes, layout = make_pod_mesh(2, world // 2), ("pod", "data"), \
                f"pod 2x{world // 2}"
        else:
            mesh, axes, layout = make_flat_mesh(), ("data",), f"flat {world}"
        prep = pipeline.prepare_synthetic_stream(
            n_docs=n, vocab=2048, n_topics=k, seed=0, chunk=chunk, mesh=mesh, axes=axes)
        labels = torch.as_tensor(prep.labels).long()
        res = buckshot_distributed_stream(
            mesh, axes, prep.x, k, 0, sample_size=buckshot_sample_size(n, k), kmeans_iters=2)
        if rank == 0:
            a = torch.as_tensor(res.assignment).cpu().long()
            print(f"\ndistributed streaming Buckshot ({layout} mesh): "
                  f"RSS={float(res.rss):8.2f}   purity={float(metrics.purity(a, labels, k, k)):.3f}"
                  f"   nmi={float(metrics.nmi(a, labels, k, k)):.3f}")
        dist.destroy_process_group()
    elif rank == 0:
        print("\n(--ranks N, N > 1, a count dividing the chunk size, also runs the "
              "distributed streaming Buckshot; see the module docstring)")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain PyTorch)")
    ap.add_argument("--ranks", type=int, default=1, help="processes (gloo on the CPU, NCCL on cards)")
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--chunk", type=int, default=1000)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--init-file", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.chunk % args.ranks:
        raise SystemExit(f"--ranks {args.ranks} must divide the chunk ({args.chunk})")
    if args.rank is not None:
        run(args, args.rank, args.ranks)
        return 0
    if args.ranks == 1:
        run(args, 0, 1)
        return 0
    return spawn_ranks([__file__, *(argv if argv is not None else sys.argv[1:])], args.ranks)


if __name__ == "__main__":
    sys.exit(main())
