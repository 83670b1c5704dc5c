"""Host wrapper of the CUDA kernel ``csrc/component_reduce.cu``: the
per-component (w desc, row asc) best of a shard's Borůvka candidates.

Counterpart of the JAX package's ``kernels/component_reduce.py``.
``launches`` counts the calls that launched the kernel.
"""

from __future__ import annotations

from ctypes import c_int as I
from ctypes import c_void_p as P

import torch

launches = 0

# C entry: pointers and the stream as c_void_p, sizes as c_int
_SIGNATURES = {
    "component_best_edge": [P, P, P, P, I, I, P, P, P, P, P],
}


def _lib():
    from repro_torch.kernels import _build

    return _build.library("component_reduce", _SIGNATURES)


def component_best_edge_cuda(
    row_w: torch.Tensor,
    row_j: torch.Tensor,
    rows: torch.Tensor,
    comp: torch.Tensor,
    c: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(r,) f32 w, (r,) int32 column, global row id and component id ->
    ((c,) f32 best_w, (c,) int32 best_row, (c,) int32 best_j). Contract of
    ``ref.component_best_edge``."""
    global launches
    from repro_torch.kernels import _build

    r = row_w.shape[0]
    dev = row_w.device
    _build.require(row_w, "row_w", torch.float32, (r,), dev)
    _build.require(row_j, "row_j", torch.int32, (r,), dev)
    _build.require(rows, "rows", torch.int32, (r,), dev)
    _build.require(comp, "comp", torch.int32, (r,), dev)
    best_w = torch.empty((c,), dtype=torch.float32, device=dev)
    best_row = torch.empty((c,), dtype=torch.int32, device=dev)
    best_j = torch.empty((c,), dtype=torch.int32, device=dev)
    if c == 0:
        return best_w, best_row, best_j
    key = torch.empty((c,), dtype=torch.int64, device=dev)  # u64 keys
    err = _lib().component_best_edge(
        row_w.data_ptr(), row_j.data_ptr(), rows.data_ptr(), comp.data_ptr(),
        r, c, key.data_ptr(), best_w.data_ptr(), best_row.data_ptr(),
        best_j.data_ptr(), _build.stream(row_w),
    )
    _build.check(err, "component_best_edge")
    launches += 1
    return best_w, best_row, best_j
