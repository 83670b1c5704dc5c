"""Where the time of one bound-pruned pass on bf16 rows goes, kernel by kernel.

Runs ``assign_stats_bounded_cuda`` on the 1 GB shape (n = 250,000, d = 2,048,
random unit rows rounded to bf16, the draws of ``chip_smoke.py --kernels``) at
BigK = 800 in the settings of ``chip_smoke.phase_timing_bf16_routes``: a full
sweep with bf16 and with f32 centers, carried bounds at zero drift, and the
bounds after one K-Means step at k = 400 (f32 centers). For each it prints
the call's time by CUDA events (5 calls after warm-up) and, from one call
under ``torch.profiler``, the device time of every kernel it launched, the
largest first, with the card's name and power limit.

It uses only the wrapper's public signature, so copied into an older tree's
``tools/`` (beside that tree's ``chip_smoke.py``) it profiles that tree's
kernels. On a CUDA machine, from the root of a checkout:

    python3 tools/bounded_profile.py [--out chiprun_out/bounded_profile.json]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def kernel_times(fn) -> dict[str, float]:
    """Device ms of each kernel one call of ``fn`` launched, by name."""
    import torch

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
        if us > 0:
            out[e.key] = out.get(e.key, 0.0) + us / 1000
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the results to this JSON file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bounded_profile: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.common import l2_normalize
    from repro_torch.kernels.assign_stats import assign_stats_bounded_cuda

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    n, d = 250_000, 2048
    x = l2_normalize(torch.rand((n, d), generator=g, device=dev))
    state = cs.bkc_state(x, dev)
    xb = x.bfloat16()
    c400, c800b, index, bnd, c1, drift = cs.bkc_state_bf16(x, xb, state, dev)
    c800f = state[1]
    del x, state
    torch.cuda.empty_cache()
    b = cs._sentinel(n, dev)
    zero = torch.zeros(cs.BIG_K, device=dev)
    first = assign_stats_bounded_cuda(xb, c800b, b.idx, b.lo, b.hi, zero)
    settings = {
        "sentinel, bf16 centers": (xb, c800b, b.idx, b.lo, b.hi, zero),
        "sentinel, f32 centers": (xb, c800f, b.idx, b.lo, b.hi, zero),
        "carried, zero drift, bf16 centers": (xb, c800b, first[6], first[7], first[8], zero),
        "carried after one K-Means step, f32 centers": (xb, c1, bnd.idx, bnd.lo, bnd.hi, drift),
    }
    results = {"card": card(), "settings": {}}
    print(results["card"], flush=True)
    for name, call_args in settings.items():
        pruned = assign_stats_bounded_cuda(*call_args)[9].float().mean().item()
        ms = cs.event_ms(lambda: assign_stats_bounded_cuda(*call_args), 5)
        kernels = kernel_times(lambda: assign_stats_bounded_cuda(*call_args))
        results["settings"][name] = {"ms": ms, "pruned_share": pruned,
                                     "device_ms": sum(kernels.values()), "kernels": kernels}
        top = "; ".join(f"{k[:60]} {v:.4f}" for k, v in list(kernels.items())[:8])
        print(f"{name} (k={call_args[1].shape[0]}): {ms:.4f} ms by events, pruned share "
              f"{pruned:.4f}, device {sum(kernels.values()):.4f} ms: {top}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
