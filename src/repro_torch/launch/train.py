"""Sharded training launcher — the production entry point.

    python -m repro_torch.launch.train --arch qwen2-1.5b --steps 20 \\
        [--mesh DxM | PxDxM] [--reduced | --full] [--grad-compress] [--cpu]

The port of the JAX package's ``launch/train.py``. The ranks are processes
started here, joined through a file in a temporary directory (no network):
gloo on the CPU, NCCL on cards (rank r on card r mod the card count). No
TF32: matmuls run in full f32.

``--mesh DxM`` or ``PxDxM``. Where the mesh shards something, by a model
axis (M > 1) or by FSDP (the config's ``fsdp``) over more than one data
rank, the run takes the mesh policy: the ranks form a ``DeviceMesh`` with
the reference's axes; params (FSDP-sharded too where the config says so),
moments (ZeRO-1) and each global batch are DTensors placed by the same
``MeshPolicy`` the dry-run reports on, and every rank runs the same step
(``train/step.py`` under the policy). Otherwise (the default ``--mesh
1x1``, and ``Dx1`` or ``PxDx1``) every rank holds the whole model and
takes equal, contiguous slices of every global batch; the grads (and the
reported loss) are averaged by an all-reduce before the optimizer step.
Both share one step loop and one checkpoint writer. Either way
``--grad-compress`` sends the mean grad through the int8 wire format, the
reference's arithmetic, and a checkpoint is written whole, in the
reference's layout.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile
import time

from repro_torch.launch.ranks import spawn_ranks


def _mesh(spec: str) -> tuple[int, ...]:
    shape = tuple(int(v) for v in spec.split("x"))
    if len(shape) not in (2, 3) or min(shape) < 1:
        raise SystemExit(f"--mesh {spec}: want DxM (or PxDxM), e.g. 2x2")
    return shape


def _device(args, rank: int):
    import torch

    from repro_torch.common import resolve_device

    torch.backends.cuda.matmul.allow_tf32 = False
    if args.cpu:
        return resolve_device("cpu")
    resolve_device(None)  # raises without a card
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def uses_policy(cfg, shape: tuple[int, ...]) -> bool:
    """Whether a mesh of ``shape`` takes the mesh policy: only where
    something is sharded, by a model axis (M > 1) or by FSDP over more than
    one data rank. Otherwise every rank holds the whole model, and the
    plain data-parallel step (the pod axis one more data axis) does the
    same work without DTensor's cost."""
    *data, m = shape
    return m > 1 or (bool(cfg.fsdp) and math.prod(data) > 1)


def run_rank(args, rank: int, shape: tuple[int, ...], placed: bool) -> int:
    """One rank of a run on a mesh of ``shape``: through the mesh policy
    where ``placed``, else data-parallel with whole replicas (equal,
    contiguous slices of every global batch; grads and the reported loss
    averaged by an all-reduce before the optimizer step)."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model
    from repro_torch.train import checkpoint as ckpt_mod
    from repro_torch.train import data as data_mod
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.loop import batch_at
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import make_train_step

    dev = _device(args, rank)
    world = math.prod(shape)
    grouped = placed or world > 1
    if grouped:
        init = args.init_file or os.path.join(tempfile.mkdtemp(), "init")
        dist.init_process_group("gloo" if args.cpu else "nccl", init_method=f"file://{init}",
                                rank=rank, world_size=world)
    try:
        cfg = get_config(args.arch, reduced=args.reduced)
        model = get_model(cfg)
        opt_cfg = AdamWConfig(total_steps=args.steps, warmup_steps=max(args.steps // 10, 1))
        if placed:
            from repro_torch.launch.mesh import make_debug_mesh, policy_for

            mesh = make_debug_mesh(shape)
            policy = policy_for(mesh)
            sizes = str({n: int(mesh.size(i)) for i, n in enumerate(mesh.mesh_dim_names)})
            params, opt_state = placed_setup(cfg, policy, dev)
            step_fn = make_train_step(cfg, opt_cfg, policy, grad_compress=args.grad_compress)
            feed = lambda b: place_batch(b, policy)  # noqa: E731
        else:
            from repro_torch.distrib.sharding import make_flat_mesh

            if args.batch % world:
                raise SystemExit(f"--batch {args.batch} does not split over {world} ranks")
            lo, hi = rank * args.batch // world, (rank + 1) * args.batch // world
            sizes = f"{{'data': {world}, 'model': 1}}"
            params = model.init_params(torch.Generator(device=dev).manual_seed(0), dev)
            opt_state = opt_mod.init(params.stacked)
            group = make_flat_mesh().get_group("data") if world > 1 else None
            step_fn = make_train_step(cfg, opt_cfg, grad_compress=args.grad_compress,
                                      dp_group=group)
            feed = lambda b: {k: v[lo:hi] for k, v in b.items()}  # noqa: E731
        if rank == 0:
            _banner(sizes, cfg, model, args, dev)
        dcfg = data_mod.DataConfig(vocab=cfg.vocab, batch=args.batch, seq=args.seq, seed=0)
        loss = float("nan")
        for step in range(args.steps):
            t0 = time.perf_counter()
            batch = feed(batch_at(cfg, dcfg, step, dev))
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            if rank == 0 and args.log_every and step % args.log_every == 0:
                print(f"step {step:4d} loss {loss:.4f} "
                      f"({(time.perf_counter() - t0) * 1e3:.0f} ms)", flush=True)
        if args.ckpt_dir:
            state = full_tree({"params": params.stacked, "opt": opt_state})
            if rank == 0:
                ckpt_mod.save(args.ckpt_dir, args.steps, state)
                print(f"saved checkpoint at step {args.steps} -> {args.ckpt_dir}")
        if rank == 0:
            print(f"done: final loss {loss:.4f}")
    finally:
        if grouped:
            dist.destroy_process_group()
    return 0


def _banner(mesh: str, cfg, model, args, dev) -> None:
    import torch

    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"mesh {mesh}; arch {cfg.name} "
          f"({model.param_count()/1e6:.1f}M params, reduced={args.reduced}) on {name}")


def full_tree(tree):
    """A tree of DTensors (or tensors) as full tensors: every rank takes part
    in the gathers and holds the whole tree after."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models.common import tree_map

    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor) else t, tree)


def placed_setup(cfg, policy, dev, seed: int = 0):
    """The policy path's state: every rank draws the same full weights from
    ``seed`` on ``dev`` and keeps its shards (FSDP too where ``cfg.fsdp``);
    zero moments placed by ZeRO-1. Returns (model, optimizer state)."""
    import torch

    from repro_torch.models.registry import get_model
    from repro_torch.train import optimizer as opt_mod

    model = get_model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(seed), dev)
    return model.place_params(params, policy), opt_mod.init_placed(model._placed_recs(), policy)


def place_batch(batch: dict, policy) -> dict:
    """A global batch (the same on every rank) -> DTensors sharded over dp."""
    from repro_torch.models.common import place

    return {k: place(v, policy, ("dp",) + (None,) * (v.ndim - 1)) for k, v in batch.items()}


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--mesh", default="1x1", help="DxM or PxDxM, e.g. 2x2 (D*M ranks)")
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks to start; must equal the mesh's size (the default)")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (gloo between ranks)")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--init-file", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    shape = _mesh(args.mesh)
    world = math.prod(shape)
    if args.devices is not None and args.devices != world:
        print(f"--devices {args.devices} does not match the mesh's {world} ranks",
              file=sys.stderr)
        return 2
    if args.rank is not None or world == 1:
        from repro_torch.configs import get_config

        placed = uses_policy(get_config(args.arch, reduced=args.reduced), shape)
        return run_rank(args, args.rank or 0, shape, placed)
    return spawn_ranks(["-m", "repro_torch.launch.train",
                        *(argv if argv is not None else sys.argv[1:])], world)


if __name__ == "__main__":
    sys.exit(main())
