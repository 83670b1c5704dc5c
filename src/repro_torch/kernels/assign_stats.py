"""Host wrappers of the CUDA kernels ``csrc/label_stats.cu`` (per-label
weighted sums and weight totals) and ``csrc/assign_stats.cu`` (nearest center
plus per-cluster statistics).

Counterpart of the JAX package's ``kernels/assign_stats.py``. ``launches``
counts, per kernel, the calls that launched it.
"""

from __future__ import annotations

from ctypes import c_int as I
from ctypes import c_void_p as P

import torch

launches = {"label_stats": 0, "assign_stats": 0}

# C entries: pointers and the stream as c_void_p, sizes as c_int
_SIGNATURES = {
    "label_stats": {
        "label_stats_chunks": [I, I, I],
        "label_stats": [P, P, P, I, I, I, I, P, P, P, P, P],
    },
    "assign_stats": {
        "assign_stats_chunks": [I, I, I],
        "assign_stats": [P, P, P, I, I, I, I, P, P, P, P, P, P, P, P, P, P],
    },
}


def _lib(name: str):
    from repro_torch.kernels import _build

    return _build.library(name, _SIGNATURES[name])


def _weights(w: torch.Tensor | None, n: int, dev: torch.device) -> torch.Tensor:
    if w is None:
        return torch.ones((n,), dtype=torch.float32, device=dev)
    return w


def _check_k_d(k: int, d: int) -> None:
    if k < 1 or d < 1:
        raise ValueError(f"the kernels need k >= 1 and d >= 1, got k={k}, d={d}")


def label_stats_cuda(
    x: torch.Tensor, idx: torch.Tensor, k: int, w: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """(n, d) f32, (n,) int32[, (n,) f32] -> ((k, d) sums, (k,) weight
    totals). Contract of ``ref.label_stats``."""
    from repro_torch.kernels import _build

    n, d = x.shape
    dev = x.device
    _check_k_d(k, d)
    w = _weights(w, n, dev)
    _build.require(x, "x", torch.float32, (n, d), dev)
    _build.require(idx, "idx", torch.int32, (n,), dev)
    _build.require(w, "w", torch.float32, (n,), dev)
    lib = _lib("label_stats")
    chunks = lib.label_stats_chunks(n, k, d)
    part = torch.empty((chunks, k, d), dtype=torch.float32, device=dev)
    part_k = torch.empty((chunks, 3, k), dtype=torch.float32, device=dev)
    sums = torch.empty((k, d), dtype=torch.float32, device=dev)
    counts = torch.empty((k,), dtype=torch.float32, device=dev)
    err = lib.label_stats(
        x.data_ptr(), idx.data_ptr(), w.data_ptr(), n, d, k, chunks,
        part.data_ptr(), part_k.data_ptr(), sums.data_ptr(), counts.data_ptr(),
        _build.stream(x),
    )
    _build.check(err, "label_stats")
    launches["label_stats"] += 1
    return sums, counts


def assign_stats_cuda(
    x: torch.Tensor, centers: torch.Tensor, w: torch.Tensor | None = None
) -> tuple[torch.Tensor, ...]:
    """(n, d), (k, d) f32[, (n,) f32] -> (idx, best_sim, sums, counts,
    min_sim, sumsq). Contract of ``ref.assign_stats``."""
    from repro_torch.kernels import _build

    n, d = x.shape
    k = centers.shape[0]
    dev = x.device
    _check_k_d(k, d)
    w = _weights(w, n, dev)
    _build.require(x, "x", torch.float32, (n, d), dev)
    _build.require(centers, "centers", torch.float32, (k, d), dev)
    _build.require(w, "w", torch.float32, (n,), dev)
    lib = _lib("assign_stats")
    chunks = lib.assign_stats_chunks(n, k, d)
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    best_sim = torch.empty((n,), dtype=torch.float32, device=dev)
    rowsq = torch.empty((n,), dtype=torch.float32, device=dev)
    part = torch.empty((chunks, k, d), dtype=torch.float32, device=dev)
    part_k = torch.empty((chunks, 3, k), dtype=torch.float32, device=dev)
    sums = torch.empty((k, d), dtype=torch.float32, device=dev)
    counts = torch.empty((k,), dtype=torch.float32, device=dev)
    min_sim = torch.empty((k,), dtype=torch.float32, device=dev)
    sumsq = torch.empty((k,), dtype=torch.float32, device=dev)
    err = lib.assign_stats(
        x.data_ptr(), centers.data_ptr(), w.data_ptr(), n, d, k, chunks,
        idx.data_ptr(), best_sim.data_ptr(), rowsq.data_ptr(), part.data_ptr(),
        part_k.data_ptr(), sums.data_ptr(), counts.data_ptr(),
        min_sim.data_ptr(), sumsq.data_ptr(), _build.stream(x),
    )
    _build.check(err, "assign_stats")
    launches["assign_stats"] += 1
    return idx, best_sim, sums, counts, min_sim, sumsq
