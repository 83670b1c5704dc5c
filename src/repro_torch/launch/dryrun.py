"""Multi-pod dry-run: run every (arch x shape x mesh) cell on a fake pod.

The port of the JAX package's ``launch/dryrun.py``. The reference lowers and
compiles each cell for 512 simulated host devices; here one process joins a
``"fake"`` process group of the mesh's size (256 or 512 ranks, every
collective a no-op of the right shape) and runs the step eagerly, as rank 0
of the pod, on DTensors whose local shards live on the ``meta`` device:
every op computes its output's shape and nothing is allocated. (Meta
tensors, not ``FakeTensorMode``: DTensor's own shard arithmetic builds
index tensors and reads them back, which a fake mode refuses.) For each
cell this shows, without hardware:
  * the sharding config is coherent (every op of the step has placements),
  * whether it fits an H100's 80 GB (the peak of live local storage,
    followed op by op),
  * and it yields the roofline terms (per-device flops, bytes and
    collective bytes from ``op_costs.OpCounter``).

Deliberate differences: there is no compile, so ``compile_s`` becomes
``trace_s`` (the fake step's wall time) and the raw ``xla_*_unscaled``
costs have no counterpart; ``fits_16gb`` (v5e) becomes ``fits_80gb``.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out reports/dryrun]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch

# H100 SXM hardware constants (per device)
PEAK_FLOPS = 989e12  # bf16 dense tensor-core FLOP/s (NVIDIA H100 SXM datasheet)
HBM_BW = 3.35e12  # bytes/s HBM3 (NVIDIA H100 SXM datasheet)
# bytes/s per device across the model axis: a 16-wide axis leaves an 8-GPU
# NVLink node, so each GPU's 400 Gb/s network link (one ConnectX-7 NIC per
# GPU in a DGX H100) bounds it
LINK_BW = 50e9
HBM_BYTES = 80e9  # H100 SXM memory


@contextlib.contextmanager
def fake_pod(shape: tuple[int, ...]):
    """A ``"fake"`` process group of prod(shape) ranks in this process (rank
    0) and its mesh, yielded; inside, new tensors default to the ``meta``
    device. Torn down on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_debug_mesh

    if dist.is_initialized():
        raise RuntimeError("the dry-run needs a process without a process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=math.prod(shape))
    try:
        mesh = make_debug_mesh(shape)
        # a boolean mask's selection has a data-dependent size: take every
        # element as selected (the plain kernels mask out-of-range ids only)
        from torch.fx.experimental import _config as fx_config

        flag = "meta_nonzero_assume_all_nonzero"
        patch = (fx_config.patch(**{flag: True}) if hasattr(fx_config, flag)
                 else contextlib.nullcontext())
        with torch.device("meta"), patch:
            yield mesh
    finally:
        dist.destroy_process_group()


def _storages(tree) -> dict[int, int]:
    """id -> bytes of the (local) storages of ``tree``'s tensors."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.op_costs import _tensors

    out = {}
    for t in _tensors(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        st = t.untyped_storage()
        out[id(st)] = st.nbytes()
    return out


def _measure(fn, args: tuple):
    """Run ``fn(*args)`` under a memory-tracking ``OpCounter``; returns
    (trace seconds, costs, memory dict, result). A model among the
    arguments counts as its stacked param tree."""
    from repro_torch.launch.op_costs import OpCounter
    from repro_torch.models import transformer

    held = tuple(a.stacked if isinstance(a, transformer.LM) else a for a in args)
    arg_st = _storages(held)
    with OpCounter(track_memory=True) as counter:
        counter.track(held)
        t0 = time.time()
        out = fn(*args)
        trace_s = time.time() - t0
    out_st = _storages(out)
    arg_b = sum(arg_st.values())
    out_b = sum(out_st.values())
    alias_b = sum(n for k, n in out_st.items() if k in arg_st)
    temp_b = max(counter.peak - arg_b - (out_b - alias_b), 0)
    mem = {
        "argument_bytes": arg_b,
        "output_bytes": out_b,
        "temp_bytes": temp_b,
        "alias_bytes": alias_b,
    }
    return trace_s, counter.costs(), mem, out


def _finish_report(
    *, arch, shape, kind, mesh_name, n_dev, costs, mem, t_lower, t_trace, mf, out_dir,
):
    """Shared roofline/memory/collective reporting for any traced cell."""
    coll = costs["collectives"]
    flops_dev = costs["flops"]
    bytes_dev = costs["bytes"]

    compute_term = flops_dev / PEAK_FLOPS
    memory_term = bytes_dev / HBM_BW
    collective_term = coll["total"] / LINK_BW
    dominant = max(
        [("compute", compute_term), ("memory", memory_term),
         ("collective", collective_term)],
        key=lambda kv: kv[1],
    )[0]

    hbm_per_dev = (
        mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"] - mem["alias_bytes"]
    )
    report = {
        "arch": arch,
        "shape": shape,
        "kind": kind,
        "mesh": mesh_name,
        "n_devices": n_dev,
        "ok": True,
        "lower_s": round(t_lower, 1),
        "trace_s": round(t_trace, 1),
        "memory": {**mem, "hbm_per_device": hbm_per_dev,
                   "fits_80gb": bool(hbm_per_dev < HBM_BYTES)},
        "cost": {
            "flops_per_device": flops_dev,
            "bytes_per_device": bytes_dev,
        },
        "collectives": coll,
        "model_flops": mf,
        "roofline": {
            "compute_s": compute_term,
            "memory_s": memory_term,
            "collective_s": collective_term,
            "dominant": dominant,
            "useful_flops_ratio": (
                mf["model_flops"] / (flops_dev * n_dev) if flops_dev else 0.0
            ),
        },
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{arch}__{shape}__{mesh_name}.json")
        with open(path, "w") as f:
            json.dump(report, f, indent=1)
    return report


def _mesh_shape(multi_pod: bool, mesh_shape) -> tuple[tuple[int, ...], str]:
    if mesh_shape is not None:
        shape = tuple(mesh_shape)
        return shape, "mesh_" + "x".join(map(str, shape))
    if multi_pod:
        return (2, 16, 16), "multipod_2x16x16"
    return (16, 16), "pod_16x16"


def run_cell(
    arch: str, shape: str, multi_pod: bool = False, out_dir: str | None = None, *,
    mesh_shape=None, cfg=None, cell=None, dtype: torch.dtype = torch.bfloat16,
) -> dict:
    """One model cell. ``mesh_shape``, ``cfg`` (e.g. a REDUCED config),
    ``cell`` (a ``ShapeCell``) and ``dtype`` (of the params) override the
    production choices, for tests and for checking the memory model on a
    card."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.configs.flops import model_flops
    from repro_torch.launch.mesh import policy_for
    from repro_torch.launch.specs import cell_inputs
    from repro_torch.models import transformer
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import make_decode_step, make_prefill_step, make_train_step

    cfg = cfg or get_config(arch)
    cell = cell or SHAPES[shape]
    mshape, mesh_name = _mesh_shape(multi_pod, mesh_shape)
    n_dev = math.prod(mshape)
    with fake_pod(mshape) as mesh:
        policy = policy_for(mesh)
        t0 = time.time()
        inputs = cell_inputs(cfg, cell, policy, dtype)
        inputs["params"] = transformer.LM(cfg, inputs["params"])
        if cell.kind == "train":
            fn = make_train_step(cfg, AdamWConfig(), policy)
            args = (inputs["params"], inputs["opt_state"], inputs["batch"])
        elif cell.kind == "prefill":
            fn = make_prefill_step(cfg, policy)
            args = (inputs["params"], inputs["batch"])
        else:
            fn = make_decode_step(cfg, policy)
            args = (inputs["params"], inputs["tokens"], inputs["caches"], inputs["pos"])
        t_lower = time.time() - t0
        if cell.kind == "train":  # the train step leaves .grad on the params
            fn = _train_outputs(fn)
        t_trace, costs, mem, _ = _measure(fn, args)

    return _finish_report(
        arch=arch, shape=shape, kind=cell.kind, mesh_name=mesh_name,
        n_dev=n_dev, costs=costs, mem=mem, t_lower=t_lower, t_trace=t_trace,
        mf=model_flops(cfg, cell), out_dir=out_dir,
    )


def _train_outputs(fn):
    """The train step with its outputs as the reference's (params tree,
    optimizer state, metrics)."""

    def step(params, opt_state, batch):
        params, opt_state, metrics = fn(params, opt_state, batch)
        return params.stacked, opt_state, metrics

    return step


# ------------------------------------------------------------- cluster cells

# The paper's own workload at production scale: n = 16.7M tf-idf documents
# (d=2048) sharded over every device of the pod, k=400 clusters (paper's 1GB
# setting, scaled to a pod). One cell per MapReduce job kind.
CLUSTER_N = 1 << 24
CLUSTER_D = 2048
CLUSTER_K = 400
CLUSTER_BIGK = 800
CLUSTER_S = 81920  # Buckshot sample = sqrt(k n) rounded to shard multiple

CLUSTER_SHAPES = ("kmeans_iter", "bkc_microclusters", "boruvka_round",
                  "kmeans_iter_opt", "bkc_microclusters_opt")


def run_cluster_cell(
    shape: str, multi_pod: bool = False, out_dir: str | None = None, *,
    mesh_shape=None, n: int = CLUSTER_N, s: int = CLUSTER_S,
) -> dict:
    """One rank's map and combine of the port's engine on its local shard.
    ``mesh_shape``, ``n`` and ``s`` (the sample) override the production
    sizes, for tests. Meta tensors are not on a card, so ``ops`` takes its
    plain versions (``kernels/ref.py``), as the reference lowers
    ``impl="xla"``."""
    from repro_torch.distrib import cluster as dc
    from repro_torch.distrib.engine import make_job
    from repro_torch.kernels import ops

    mshape, mesh_name = _mesh_shape(multi_pod, mesh_shape)
    n_dev = math.prod(mshape)
    with fake_pod(mshape) as mesh:
        # clustering has no tensor-parallel dimension: ALL mesh axes carry rows
        # (the paper's 'nodes' == every device in the pod)
        axes = tuple(mesh.mesh_dim_names)
        t0 = time.time()
        opt = shape.endswith("_opt")
        # optimized variant: documents unit-norm and stored bf16 on the wire
        # and in memory, with f32 accumulation
        doc_dtype = torch.bfloat16 if opt else torch.float32
        if shape.startswith(("kmeans_iter", "bkc_microclusters")):
            # K-Means' iteration at k, or BKC job 1 at BigK micro-clusters
            k = CLUSTER_K if shape.startswith("kmeans_iter") else CLUSTER_BIGK
            map_combine, kinds = dc._assign_stats_map(unit_norm=opt)
            job = make_job(mesh, axes, map_combine, kinds, name=shape)
            data = {"x": torch.empty((n // n_dev, CLUSTER_D), dtype=doc_dtype),
                    "w": torch.empty((n // n_dev,), dtype=torch.float32)}
            bcast = {"centers": torch.empty((k, CLUSTER_D), dtype=doc_dtype)}
            # useful work: the similarity matmul + the weighted sums' adds (the
            # port accumulates sums by row, never by the reference's one-hot
            # matmul, on the card as in its plain version)
            mf = 2.0 * n * CLUSTER_D * k + 2.0 * n * CLUSTER_D
        elif shape == "boruvka_round":
            # one sharded Borůvka candidate round on the Buckshot sample —
            # matrix-free: the fused sim+best-edge op
            def cand_map(data, bcast):
                return dict(zip(("j", "w"), ops.sim_best_edge(
                    data["rows"], bcast["xs"], data["labels"], bcast["all_labels"])))

            job = make_job(mesh, axes, cand_map, {"j": "shard", "w": "shard"}, name="boruvka")
            data = {"rows": torch.empty((s // n_dev, CLUSTER_D)),
                    "labels": torch.empty((s // n_dev,), dtype=torch.int32)}
            bcast = {"xs": torch.empty((s, CLUSTER_D)),
                     "all_labels": torch.empty((s,), dtype=torch.int32)}
            mf = 2.0 * s * s * CLUSTER_D
        else:
            raise KeyError(shape)
        t_lower = time.time() - t0
        t_trace, costs, mem, _ = _measure(job, (data, bcast))

    return _finish_report(
        arch="cluster-tfidf", shape=shape, kind="cluster", mesh_name=mesh_name,
        n_dev=n_dev, costs=costs, mem=mem, t_lower=t_lower, t_trace=t_trace,
        mf={"model_flops": mf, "n": n, "d": CLUSTER_D, "k": CLUSTER_K},
        out_dir=out_dir,
    )


def summary_line(tag: str, r: dict) -> str:
    rf = r["roofline"]
    return (
        f"OK   {tag:55s} trace={r['trace_s']:7.1f}s "
        f"hbm/dev={r['memory']['hbm_per_device']/2**30:6.2f}GiB "
        f"flops/dev={r['cost']['flops_per_device']:.3e} "
        f"coll={r['collectives']['total']:.3e}B "
        f"dom={rf['dominant']}"
    )


def main(argv: list[str] | None = None) -> int:
    from repro_torch.configs import cells_for, list_archs

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--cluster", action="store_true",
                    help="run the clustering-engine cells (the paper's jobs)")
    ap.add_argument("--out", default="reports/dryrun")
    args = ap.parse_args(argv)

    cells: list[tuple[str, str, bool]] = []
    if not args.cluster:
        archs = list_archs() if (args.all or not args.arch) else [args.arch]
        for arch in archs:
            shapes = (
                cells_for(arch) if (args.all or not args.shape) else [args.shape]
            )
            for shape in shapes:
                if args.both_meshes:
                    cells.append((arch, shape, False))
                    cells.append((arch, shape, True))
                else:
                    cells.append((arch, shape, args.multi_pod))
    if args.cluster or args.all:
        shapes = CLUSTER_SHAPES if not (args.cluster and args.shape) else [args.shape]
        for shape in shapes:
            if args.both_meshes:
                cells.append(("cluster-tfidf", shape, False))
                cells.append(("cluster-tfidf", shape, True))
            else:
                cells.append(("cluster-tfidf", shape, args.multi_pod))

    failures = 0
    for arch, shape, mp in cells:
        tag = f"{arch} x {shape} x {'2x16x16' if mp else '16x16'}"
        try:
            if arch == "cluster-tfidf":
                r = run_cluster_cell(shape, mp, args.out)
            else:
                r = run_cell(arch, shape, mp, args.out)
            print(summary_line(tag, r), flush=True)
        except Exception as e:
            failures += 1
            print(f"FAIL {tag}: {type(e).__name__}: {str(e)[:300]}")
            traceback.print_exc()
    print(f"\n{len(cells) - failures}/{len(cells)} cells passed")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
