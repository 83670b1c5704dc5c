"""Train a small LM end to end with the port's fault-tolerance stack.

    PYTHONPATH=src python examples/torch_train_lm.py --arch qwen2-1.5b --steps 200 [--cpu]

The PyTorch port of ``examples/train_lm.py``, with the same flags: the
REDUCED config of the chosen architecture scaled up to ~10M params (pass
--full-width for the real config), a few hundred AdamW steps with a cosine
schedule and checkpoints; with --preempt, a simulated preemption at 60 %
and a resume from the latest checkpoint. Runs on the CUDA device; --cpu
runs on the CPU.
"""

import argparse
import tempfile


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=256, help="width override")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--full-width", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--preempt", action="store_true",
                    help="simulate preemption at 60%% and auto-resume")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args()

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model
    from repro_torch.train.loop import train

    torch.backends.cuda.matmul.allow_tf32 = False
    device = "cpu" if args.cpu else None
    cfg = get_config(args.arch, reduced=not args.full_width)
    if not args.full_width:
        cfg = cfg.replace(
            n_layers=args.layers,
            d_model=args.d_model,
            n_heads=max(cfg.n_heads, 4),
            head_dim=args.d_model // max(cfg.n_heads, 4),
            d_ff=args.d_model * 3,
            vocab=8192,
        )
    n_params = get_model(cfg).param_count()
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"({cfg.n_layers}L d={cfg.d_model}) on {'cpu' if args.cpu else 'cuda'}")

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    print(f"checkpoints -> {ckpt_dir}")

    if args.preempt:
        try:
            train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                  ckpt_dir=ckpt_dir, ckpt_every=25, log_every=20,
                  preempt_at=int(args.steps * 0.6), device=device)
        except KeyboardInterrupt as e:
            print(f"!! {e} — restarting from latest checkpoint")

    res = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                ckpt_dir=ckpt_dir, ckpt_every=25, log_every=20, device=device)
    if res.resumed_from is not None:
        print(f"resumed from step {res.resumed_from}")
    print(f"final loss {res.losses[-1]:.4f} (first {res.losses[0]:.4f}); "
          f"stragglers detected: {len(res.straggler_events)}")


if __name__ == "__main__":
    main()
