"""Data-parallel training launcher — the production entry point.

    python -m repro_torch.launch.train --arch qwen2-1.5b --steps 20 \\
        [--mesh Dx1] [--reduced | --full] [--grad-compress] [--cpu]

The port of the JAX package's ``launch/train.py``. ``--mesh DxM``: D ranks
hold the whole model each and take equal, contiguous slices of every
global batch; their grads (and the reported loss) are averaged by an
all-reduce over ``torch.distributed`` before the optimizer step, and
``--grad-compress`` sends the mean through the int8 wire format, the
reference's arithmetic. The ranks are processes started here, joined
through a file in a temporary directory (no network): gloo on the CPU,
NCCL on cards (rank r on card r mod the card count). The port places no
tensor shards, so M must be 1 (ROADMAP item 12d); the default mesh is 1x1,
one process. No TF32: matmuls run in full f32.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time


def _mesh(spec: str) -> tuple[int, int]:
    shape = [int(v) for v in spec.split("x")]
    if len(shape) < 2 or min(shape) < 1:
        raise SystemExit(f"--mesh {spec}: want DxM (or PxDxM), e.g. 2x1")
    d = 1
    for v in shape[:-1]:
        d *= v
    return d, shape[-1]


def _spawn(argv: list[str], world: int) -> int:
    env = dict(os.environ, OMP_NUM_THREADS=os.environ.get("OMP_NUM_THREADS", "1"))
    with tempfile.TemporaryDirectory() as tmp:
        init = os.path.join(tmp, "init")
        procs = [
            subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.train", *argv,
                 "--rank", str(r), "--init-file", init],
                env=env,
            )
            for r in range(world)
        ]
        try:
            codes = [p.wait() for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return max(codes)


def _run(args, rank: int, world: int) -> int:
    import torch
    import torch.distributed as dist

    from repro_torch.common import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model
    from repro_torch.train import checkpoint as ckpt_mod
    from repro_torch.train import data as data_mod
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.loop import batch_at
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    if args.cpu:
        dev = resolve_device("cpu")
    else:
        resolve_device(None)  # raises without a card
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    group = None
    if world > 1:
        from repro_torch.distrib.sharding import make_flat_mesh

        dist.init_process_group("gloo" if args.cpu else "nccl",
                                init_method=f"file://{args.init_file}", rank=rank,
                                world_size=world)
        group = make_flat_mesh().get_group("data")
    try:
        cfg = get_config(args.arch, reduced=args.reduced)
        model = get_model(cfg)
        if args.batch % world:
            raise SystemExit(f"--batch {args.batch} does not split over {world} ranks")
        lo, hi = rank * args.batch // world, (rank + 1) * args.batch // world
        if rank == 0:
            name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
            print(f"mesh {{'data': {world}, 'model': 1}}; arch {cfg.name} "
                  f"({model.param_count()/1e6:.1f}M params, reduced={args.reduced}) on {name}")
        params = model.init_params(torch.Generator(device=dev).manual_seed(0), dev)
        opt_state = opt_mod.init(params.stacked)
        opt_cfg = AdamWConfig(total_steps=args.steps, warmup_steps=max(args.steps // 10, 1))
        step_fn = make_train_step(cfg, opt_cfg, grad_compress=args.grad_compress, dp_group=group)
        dcfg = data_mod.DataConfig(vocab=cfg.vocab, batch=args.batch, seq=args.seq, seed=0)
        loss = float("nan")
        for step in range(args.steps):
            t0 = time.perf_counter()
            batch = {k: v[lo:hi] for k, v in batch_at(cfg, dcfg, step, dev).items()}
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            if rank == 0 and args.log_every and step % args.log_every == 0:
                print(f"step {step:4d} loss {loss:.4f} "
                      f"({(time.perf_counter() - t0) * 1e3:.0f} ms)", flush=True)
        if args.ckpt_dir and rank == 0:
            ckpt_mod.save(args.ckpt_dir, args.steps, {"params": params.stacked, "opt": opt_state})
            print(f"saved checkpoint at step {args.steps} -> {args.ckpt_dir}")
        if rank == 0:
            print(f"done: final loss {loss:.4f}")
    finally:
        if world > 1:
            dist.destroy_process_group()
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--mesh", default="1x1", help="DxM, e.g. 2x1 (M > 1 is not ported)")
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks to start; must equal the mesh's D (the default)")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (gloo between ranks)")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--init-file", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    d, m = _mesh(args.mesh)
    if m > 1:
        print(f"--mesh {args.mesh}: a model axis of {m} needs tensor-parallel shards, which "
              f"the port does not place yet (ROADMAP queue 1, item 12d); use --mesh {d}x1",
              file=sys.stderr)
        return 2
    if args.devices is not None and args.devices != d:
        print(f"--devices {args.devices} does not match the mesh's {d} data ranks",
              file=sys.stderr)
        return 2
    if args.rank is not None:
        return _run(args, args.rank, d)
    if d == 1:
        return _run(args, 0, 1)
    return _spawn(argv if argv is not None else sys.argv[1:], d)


if __name__ == "__main__":
    sys.exit(main())
