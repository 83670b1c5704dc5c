"""best_edge on the main path's block, build against build, on one card.

Builds ``csrc/best_edge.cu`` of each tree named with ``--tree NAME=PATH``
(and of each ``--patch NAME BASE OLD NEW``: BASE's source with the text OLD
replaced by NEW, which must occur in it) with nvcc, ``-Xptxas -v`` printed,
into ``build/best_edge_probe/<NAME>/``, one nvcc per build, all at once.
Each library's C entry ``best_edge`` is then called through ctypes on the
blocks of ``chip_smoke.py --kernels``: the round-1 block ``xs @ xs.T`` of
3,536 random unit rows (the 1 GB shape's sample, seed 21) in bf16 and in
f32, with labels ``arange(s)`` (narrow: every label in the int16 range) and
``arange(s) + 40,000`` (wide), the bf16 block's first 3,535 columns (rows
off 16 bytes: every row alignment) and the bf16 block twice over (7,072
rows: what a call costs past its fixed part). For each build and block it checks
the result against ``ref.best_edge`` on the block's f32 upcast (torch.equal)
and prints the mean time of a call with the L2 flushed by a 512 MB write
before each call, by a 512 MB read, and the kernel alone (torch.profiler),
in ``--rounds`` rounds that take the builds in turn, with the card's name
and power limit. On a CUDA machine, from the root of a checkout:

    python3 tools/best_edge_probe.py --tree parent=build/parent --tree change=. \\
        [--patch nolabels parent 'lab[j + e], j + e' '(j + e) & 3, j + e'] [--out probe.json]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = Path("src/repro_torch/kernels/csrc")
OUT = ROOT / "build" / "best_edge_probe"


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def sources(trees: list[str], patches: list[list[str]]) -> dict[str, tuple[Path, Path]]:
    """name -> (the source to compile, the directory of its headers)."""
    out = {}
    for spec in trees:
        name, path = spec.split("=", 1)
        src = Path(path).resolve() / CSRC / "best_edge.cu"
        out[name] = (src, src.parent)
    for name, base, old, new in patches:
        src, inc = out[base]
        text = src.read_text()
        if old not in text:
            raise SystemExit(f"--patch {name}: {old!r} is not in {src}")
        dst = OUT / name / "best_edge.cu"
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_text(text.replace(old, new))
        out[name] = (dst, inc)
    return out


def build(srcs: dict[str, tuple[Path, Path]]) -> dict[str, ctypes.CDLL]:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    procs = {}
    for name, (src, inc) in srcs.items():
        lib = OUT / name / "libbest_edge.so"
        lib.parent.mkdir(parents=True, exist_ok=True)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(inc),
               "-o", str(lib), str(src)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        regs = [line.strip() for line in log.splitlines()
                if "registers" in line or "spill" in line or "error" in line]
        print(f"build {name}: rc {proc.returncode}\n  " + "\n  ".join(regs), flush=True)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
        P, I = ctypes.c_void_p, ctypes.c_int
        libs[name].best_edge.argtypes = [P, I, P, P, I, I, P, P, P]
        libs[name].best_edge.restype = ctypes.c_int
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[], help="NAME=PATH of a tree")
    ap.add_argument("--patch", action="append", nargs=4, default=[],
                    metavar=("NAME", "BASE", "OLD", "NEW"))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--only", action="append", help="time only this block (repeatable)")
    ap.add_argument("--out", help="also write the results to this JSON file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("best_edge_probe: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.common import l2_normalize
    from repro_torch.kernels import ref

    name_limit = card()
    print(name_limit, flush=True)
    libs = build(sources(args.tree or [f"this={ROOT}"], args.patch))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    x = l2_normalize(torch.rand((250_000, 2048), generator=g, device=dev))
    s = 3536
    xs = l2_normalize(x[torch.randperm(250_000, generator=g, device=dev)[:s]])
    del x
    torch.cuda.empty_cache()
    sim = xs @ xs.T
    ids = torch.arange(s, dtype=torch.int32, device=dev)
    odd = sim.bfloat16()[:, :s - 1].contiguous()
    blocks = {
        "bf16 narrow": (sim.bfloat16(), ids, ids),
        "bf16 wide": (sim.bfloat16(), ids + 40_000, ids + 40_000),
        "bf16 narrow, c = 3,535": (odd, ids, ids[:s - 1].contiguous()),
        "bf16 narrow, 2 r": (sim.bfloat16().repeat(2, 1), ids.repeat(2), ids),
        "f32 narrow": (sim, ids, ids),
        "f32 wide": (sim, ids + 40_000, ids + 40_000),
    }
    if args.only:
        blocks = {k: v for k, v in blocks.items() if any(o == k for o in args.only)}
    elem = {torch.float32: 0, torch.bfloat16: 1}

    def caller(lib, block, lr, lc):
        r, c = block.shape
        bj = torch.empty((r,), dtype=torch.int32, device=dev)
        bs = torch.empty((r,), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            err = lib.best_edge(block.data_ptr(), elem[block.dtype], lr.data_ptr(),
                                lc.data_ptr(), r, c, bj.data_ptr(), bs.data_ptr(), stream)
            if err:
                raise RuntimeError(f"best_edge: CUDA error {err}")
            return bj, bs
        return call

    results = {"card": name_limit, "times": {}}
    for (bname, (block, lr, lc)) in blocks.items():
        want = ref.best_edge(block.float(), lr, lc)
        for name, lib in libs.items():
            got = caller(lib, block, lr, lc)()
            torch.cuda.synchronize()
            same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            print(f"{bname} {name}: equal to ref.best_edge: {same}", flush=True)
            results.setdefault("equal", {})[f"{bname} {name}"] = same
    for rnd in range(args.rounds):
        for bname, (block, lr, lc) in blocks.items():
            for name, lib in libs.items():
                call = caller(lib, block, lr, lc)
                row = dict(write_ms=cs.event_ms_cold(call, 30),
                           read_ms=cs.event_ms_cold(call, 30, flush_by="read"),
                           alone_ms=cs.profiled_kernel_ms(call, 20, ("best_edge_rows",)))
                results["times"].setdefault(f"{bname} {name}", []).append(row)
                print(f"round {rnd} {bname} {name}: after a 512 MB write "
                      f"{row['write_ms']:.4f} ms, after a read {row['read_ms']:.4f} ms, alone "
                      f"{row['alone_ms']:.4f} ms ({name_limit})", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
