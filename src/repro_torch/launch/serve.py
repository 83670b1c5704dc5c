"""Serving launcher — batched generation with the ServeEngine.

    python -m repro_torch.launch.serve --arch qwen2-1.5b --full

Builds a model of the zoo from a seeded generator (reduced config unless
``--full``) on the CUDA device (``--cpu`` for the CPU), runs the
pad-and-prefill + lockstep-decode engine on random prompts and reports
tokens/s. No TF32: matmuls run in full f32, as the parity checks need.
"""

import argparse
import sys
import time


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.common import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model
    from repro_torch.serve.engine import Request, ServeEngine

    dev = resolve_device("cpu" if args.cpu else None)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch, reduced=args.reduced)
    model = get_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init_params(gen, dev)
    engine = ServeEngine(cfg=cfg, params=params, device=dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"arch {cfg.name} ({model.param_count()/1e6:.1f}M params) on {name}")

    rng = np.random.default_rng(0)
    reqs = [
        Request(
            prompt=[int(t) for t in rng.integers(1, cfg.vocab, args.prompt_len)],
            max_new_tokens=args.max_new,
        )
        for _ in range(args.requests)
    ]
    engine.generate(reqs[:1])  # warm-up
    t0 = time.perf_counter()
    outs = engine.generate(reqs)
    dt = time.perf_counter() - t0
    total = sum(len(o.tokens) for o in outs)
    steps = engine.stats["decode_s"]
    print(f"{len(outs)} requests, {total} tokens in {dt*1e3:.1f} ms "
          f"-> {total/dt:.1f} tok/s (batched greedy); prefill "
          f"{engine.stats['prefill_s']*1e3:.2f} ms, decode "
          f"{1e3*float(np.median(steps)) if steps else 0.0:.2f} ms a step (median)")
    for i, o in enumerate(outs[:3]):
        print(f"  req{i}: {o.tokens[:8]}{'...' if len(o.tokens) > 8 else ''}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
