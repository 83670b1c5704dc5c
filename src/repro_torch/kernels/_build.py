"""Build the CUDA sources in ``csrc/`` with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` becomes ``lib<name>.so`` with a plain C interface,
compiled for Hopper (``sm_90a``) into ``build/repro_torch_kernels/<hash>/``
at the repository root, where ``<hash>`` covers every source, header and
flag and the output of ``nvcc --version``, so an edited source or another
toolkit is rebuilt and an unchanged one is not. Builds
start at first use; ``build()`` compiles the named libraries in parallel,
one nvcc process per source. Only sources in the repository are compiled.

Every C entry returns ``cudaGetLastError()`` after its launches, and
``check(err, name)`` raises when it is not 0.

Kernel calls may come from several threads at once (the online service's
assign worker, its callers' ``ingest`` and its refit). A wrapper that keeps
buffers per device holds ``device_lock(index)`` from taking them to the
return of the C entry that enqueues its launches on them, so two calls never
interleave their launches on one buffer; every wrapper adds to its launch
count under ``COUNT_LOCK``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from functools import cache
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
SOURCES = (
    "sim_best_edge", "label_stats", "assign_stats", "assign_argmax",
    "assign_stats_bounded", "component_reduce", "best_edge", "flash_decode",
)
# debug builds, for tests only: library -> (source, extra nvcc flags).
# label_stats_delay issues each odd ring stage's copies of the fold after the
# next stage's and after a pause, so a later stage's copies land first.
VARIANTS = {
    "label_stats_delay": ("label_stats", ("-DREPRO_FOLD_DELAY_STAGES=1",)),
}

_loaded: dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()
_device_locks: dict[int, threading.Lock] = {}
_device_locks_guard = threading.Lock()
COUNT_LOCK = threading.Lock()


def device_lock(index: int) -> threading.Lock:
    """The lock of the wrappers' held buffers on CUDA device ``index``."""
    lock = _device_locks.get(index)
    if lock is None:
        with _device_locks_guard:
            lock = _device_locks.setdefault(index, threading.Lock())
    return lock


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


@cache
def _nvcc_version() -> str:
    return subprocess.run(
        [_nvcc(), "--version"], capture_output=True, text=True, check=True
    ).stdout


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(_nvcc_version().encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build(names: tuple[str, ...] = SOURCES) -> dict[str, Path]:
    """Compile the libraries not built yet, one nvcc per source, in parallel.

    Returns the path of every named library; raises with nvcc's output if a
    build fails.
    """
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {name: out_dir / f"lib{name}.so" for name in names}
    procs = {}
    for name, path in paths.items():
        if path.exists():
            continue
        source, flags = VARIANTS.get(name, (name, ()))
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-o", str(tmp), str(CSRC / f"{source}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def library(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """Load ``lib<name>.so`` (building it first if needed) and declare the
    argument types of its C entries; every entry returns int. The first
    call builds and loads under a lock, so threads share one build."""
    lib = _loaded.get(name)
    if lib is None:
        with _load_lock:
            lib = _loaded.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(build((name,))[name]))
                for fn, argtypes in signatures.items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
                _loaded[name] = lib
    return lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as the pointer the C
    entries take (read without making a ``torch.cuda.Stream``)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


# The element types of the document rows that sim_best_edge, label_stats,
# assign_argmax, assign_stats and assign_stats_bounded take (and of
# best_edge's similarity block), and their codes in the C entries
# (csrc/tma.cuh).
ROWS = (torch.float32, torch.bfloat16)
ELEM = {torch.float32: 0, torch.bfloat16: 1}


def require(t: torch.Tensor, name: str, dtype: torch.dtype | tuple[torch.dtype, ...],
            shape: tuple, device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` (or of one of
    the dtypes of a tuple) and ``shape`` on ``device``: what the kernels
    take. The test that passes comes first and in one expression (every
    wrapper makes it on every call); the messages are made only for a tensor
    that fails it."""
    if ((t.dtype is dtype or (type(dtype) is tuple and t.dtype in dtype))
            and t.shape == shape and t.is_cuda and t.device == device and t.is_contiguous()):
        return
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name} must lie on {device} (a CUDA device), not {t.device}")
    allowed = dtype if type(dtype) is tuple else (dtype,)
    if t.dtype not in allowed:
        raise TypeError(f"{name} must be {' or '.join(map(str, allowed))}, not {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, not {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
