"""Quickstart: run the port's resident-model clustering SERVICE (DESIGN.md §14)
on the GPU.

    PYTHONPATH=src python examples/torch_serve_quickstart.py          # on the card
    PYTHONPATH=src python examples/torch_serve_quickstart.py --cpu    # on the CPU

The same demo as ``serve_quickstart.py``, on ``repro_torch``. It fits a
Buckshot model over a small synthetic corpus once, then keeps it resident on
the device behind the two online endpoints:

  assign(docs)   micro-batched bound-pruned nearest-center under the fitted
                 tf-idf weighting — bounded admission queue, optional
                 per-request deadline, shedding when overloaded
  ingest(docs)   folds the batch into the live cluster-feature stats and
                 feeds the drift detector; enough drifted mass triggers an
                 async refit that hot-swaps the model only after validation

The demo ingests a batch from a DISJOINT vocabulary (genuine topic drift),
waits for the triggered refit, and shows the model version flip — while
assign keeps answering throughout, including during the refit. With a
``DiskCheckpointer`` the same service resumes a SIGKILLed refit from its
last snapshot on restart (see tests/test_torch_service.py).
"""

import argparse
import time

import numpy as np

from repro_torch.kernels import ops
from repro_torch.serve import ClusterService, ServiceConfig

rng = np.random.default_rng(0)


def texts(n: int, lo: int = 0, hi: int = 40) -> list[str]:
    return [
        " ".join(f"tok{v}" for v in rng.integers(lo, hi, 12)) for _ in range(n)
    ]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain PyTorch)")
    args = ap.parse_args()
    device = "cpu" if args.cpu else None  # None: the CUDA device
    cfg = ServiceConfig(
        k=4, dim=128, chunk=64, max_batch=32, queue_cap=128,
        sample_size=24, kmeans_iters=2,
        drift_mass=0.2,  # refit once new per-cluster mass reaches 20%
        validate_slack=100.0,  # demo: accept any finite candidate
    )
    print(f"fitting k={cfg.k} service on 240 docs ...")
    ops.reset_launch_counts()
    with ClusterService.fit(texts(240), 0, config=cfg, device=device) as svc:
        print(f"model on {svc.model.centers.device}")
        out = svc.assign(texts(8), deadline=5.0)
        print(f"assign  v{out.version}: clusters={out.idx.tolist()} "
              f"({out.latency_s * 1e3:.1f} ms)")

        print("ingesting 80 docs from a drifted (disjoint) vocabulary ...")
        rec = svc.ingest(texts(80, lo=40, hi=80))
        print(f"ingest  objective={rec.objective:.3f} drift={rec.drift} "
              f"refit_id={rec.refit_id}")

        while rec.refit_id is not None and not svc.refit_wait(rec.refit_id, 0.1):
            out = svc.assign(texts(4))  # still serving during the refit
            print(f"  ... refit running, assign answered under v{out.version}")

        out = svc.assign(texts(8, lo=40, hi=80))
        st = svc.stats()
        print(f"assign  v{out.version}: clusters={out.idx.tolist()}")
        print(f"stats   version={st['version']} completed={st['completed']} "
              f"shed={st['shed']} p50={st['p50_ms']:.1f}ms "
              f"p99={st['p99_ms']:.1f}ms refits={st['refits']}")
        t0 = time.monotonic()
    print(f"closed in {time.monotonic() - t0:.2f}s")
    print(f"kernel launches: {ops.launch_counts()}")


if __name__ == "__main__":
    main()
