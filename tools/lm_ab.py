"""Time the LM zoo's plain (no mesh) paths of two trees of the port on one
card, alternating: the training step and the MoE models' serving.

    python tools/lm_ab.py --tree parent=build/ab/parent --tree change=. \\
        [--order parent,change,change,parent] [--out chiprun_out/lm_ab.json]

Each run is a fresh process that imports ``repro_torch`` from
``<tree>/src`` and measures, f32 and no TF32, as ``chip_smoke.py``'s
phases do:

  * ``train``: qwen2-1.5b whole, ``train()`` for 6 steps of 8 x 128
    (remat full, grad_accum 2, AdamW); the median of steps 2-6 (host
    clock, each step ending in a host read of the loss) and the peak
    device memory;
  * ``serve``: moonshot-v1-16b-a3b at 16 layers and mixtral-8x22b at 2,
    at their published widths, ``ServeEngine.generate`` on 8 requests of
    32-token prompts and 16 new tokens: one warm-up, then three runs;
    the median prefill ms and the median decode step ms.

Weights are drawn on the card from seed 21. One JSON line a run is
printed, and the medians of each tree's runs side by side at the end,
beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

SEED = 21
TRAIN_B, TRAIN_SEQ, TRAIN_STEPS = 8, 128, 6
REQUESTS, PROMPT, NEW = 8, 32, 16
MOE = (("moonshot-v1-16b-a3b", 16), ("mixtral-8x22b", 2))


def measure() -> dict:
    """One tree's numbers, in this process (``repro_torch`` on sys.path)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.train.loop import train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    out: dict = {}
    cfg = get_config("qwen2-1.5b")
    torch.cuda.reset_peak_memory_stats()
    res = train(cfg, steps=TRAIN_STEPS, batch=TRAIN_B, seq=TRAIN_SEQ, seed=SEED, log_every=0,
                device=dev)
    out["train_step_ms"] = 1e3 * statistics.median(res.step_s[1:])
    out["train_steps_ms"] = [1e3 * s for s in res.step_s]
    out["train_peak_bytes"] = torch.cuda.max_memory_allocated()
    out["train_losses"] = res.losses
    del res
    torch.cuda.empty_cache()
    for arch, depth in MOE:
        cfg = get_config(arch).replace(n_layers=depth)
        lm = get_model(cfg).init_params(torch.Generator(device=dev).manual_seed(SEED), dev)
        engine = ServeEngine(cfg=cfg, params=lm, device=dev)
        rng = np.random.default_rng(SEED)
        prompts = rng.integers(1, cfg.vocab, size=(REQUESTS, PROMPT))
        reqs = [Request(prompt=[int(v) for v in p], max_new_tokens=NEW) for p in prompts]
        first = engine.generate(reqs)
        pre, dec = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            outs = engine.generate(reqs)
            pre.append(engine.stats["prefill_s"])
            dec.extend(engine.stats["decode_s"])
            if [o.tokens for o in outs] != [o.tokens for o in first]:
                raise AssertionError(f"{arch}: generate is not deterministic")
        out[f"{arch}_prefill_ms"] = 1e3 * statistics.median(pre)
        out[f"{arch}_decode_ms"] = 1e3 * statistics.median(dec)
        out[f"{arch}_tokens"] = [o.tokens for o in first][0]
        del engine, lm
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[], help="name=path (repeatable)")
    ap.add_argument("--order", default=None, help="names, comma-separated (default: ABBA)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--measure", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        print("LMAB " + json.dumps(measure()), flush=True)
        return 0
    trees = dict(t.split("=", 1) for t in args.tree)
    names = list(trees)
    order = args.order.split(",") if args.order else [names[0], *names[1:] * 2, names[0]]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    runs: dict[str, list[dict]] = {n: [] for n in names}
    for name in order:
        src = os.path.join(os.path.abspath(trees[name]), "src")
        t = time.perf_counter()
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure"],
                           capture_output=True, text=True, timeout=900,
                           env=dict(os.environ, PYTHONPATH=src))
        line = next((ln for ln in p.stdout.splitlines() if ln.startswith("LMAB ")), None)
        if p.returncode or line is None:
            print(p.stdout[-3000:], p.stderr[-5000:], file=sys.stderr)
            return 1
        r = json.loads(line[5:])
        r["wall_s"] = time.perf_counter() - t
        runs[name].append(r)
        print(json.dumps({"tree": name, **r}), flush=True)
    keys = ["train_step_ms"] + [f"{a}_{k}_ms" for a, _ in MOE for k in ("prefill", "decode")]
    summary = {n: {k: statistics.median(r[k] for r in runs[n]) for k in keys} for n in names}
    same = {k: all(r[k] == runs[names[0]][0][k] for n in names for r in runs[n])
            for k in ["train_losses"] + [f"{a}_tokens" for a, _ in MOE]}
    print(json.dumps({"card": card, "medians": summary, "identical_outputs": same}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "order": order, "runs": runs, "medians": summary,
                       "identical_outputs": same}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
