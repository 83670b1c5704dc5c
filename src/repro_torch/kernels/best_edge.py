"""Host wrapper of the CUDA kernel ``csrc/best_edge.cu``: per row of an
already-built similarity block, the best column in another component.

Counterpart of the JAX package's ``kernels/best_edge.py``. ``launches``
counts the calls that launched the kernel.
"""

from __future__ import annotations

from ctypes import c_int as I
from ctypes import c_void_p as P

import torch

from repro_torch.kernels import ref

launches = 0

# C entry: pointers and the stream as c_void_p, sizes as c_int
_SIGNATURES = {"best_edge": [P, P, P, I, I, P, P, P]}


def best_edge_cuda(
    sim: torch.Tensor, labels_row: torch.Tensor, labels_col: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(r, c) f32, (r,), (c,) int32 -> ((r,) int32 best column, (r,) f32
    its similarity). Contract of ``ref.best_edge``; r = 0 and c = 0 are
    answered without a launch."""
    global launches
    from repro_torch.kernels import _build

    r, c = sim.shape
    dev = sim.device
    _build.require(sim, "sim", torch.float32, (r, c), dev)
    _build.require(labels_row, "labels_row", torch.int32, (r,), dev)
    _build.require(labels_col, "labels_col", torch.int32, (c,), dev)
    if r == 0 or c == 0:  # no row, or no candidate for any row
        return (torch.full((r,), -1, dtype=torch.int32, device=dev),
                torch.full((r,), ref.NEG, dtype=torch.float32, device=dev))
    best_j = torch.empty((r,), dtype=torch.int32, device=dev)
    best_s = torch.empty((r,), dtype=torch.float32, device=dev)
    err = _build.library("best_edge", _SIGNATURES).best_edge(
        sim.data_ptr(), labels_row.data_ptr(), labels_col.data_ptr(), r, c,
        best_j.data_ptr(), best_s.data_ptr(), _build.stream(sim),
    )
    _build.check(err, "best_edge")
    with _build.COUNT_LOCK:
        launches += 1
    return best_j, best_s
