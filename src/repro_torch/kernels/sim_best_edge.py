"""Host wrapper of the CUDA kernel ``csrc/sim_best_edge.cu``: one Borůvka
round's per-row best cross-component edge, matrix-free.

Counterpart of the JAX package's ``kernels/sim_best_edge.py``. ``launches``
counts the calls that launched the kernel.
"""

from __future__ import annotations

from ctypes import c_int as I
from ctypes import c_void_p as P

import torch

launches = 0

# C entries: pointers and the stream as c_void_p, sizes as c_int
_SIGNATURES = {
    "sim_best_edge_col_tile": [],
    "sim_best_edge": [P, P, P, P, I, I, I, P, P, P, P, P],
}


def _lib():
    from repro_torch.kernels import _build

    return _build.library("sim_best_edge", _SIGNATURES)


def sim_best_edge_cuda(
    xs_rows: torch.Tensor,
    xs_all: torch.Tensor,
    labels_row: torch.Tensor,
    labels_col: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(r, d), (c, d) f32; (r,), (c,) int32 -> ((r,) int32 best column,
    (r,) f32 best similarity). Contract of ``ref.sim_best_edge``."""
    global launches
    from repro_torch.kernels import _build

    r, d = xs_rows.shape
    c = xs_all.shape[0]
    dev = xs_rows.device
    _build.require(xs_rows, "xs_rows", torch.float32, (r, d), dev)
    _build.require(xs_all, "xs_all", torch.float32, (c, d), dev)
    _build.require(labels_row, "labels_row", torch.int32, (r,), dev)
    _build.require(labels_col, "labels_col", torch.int32, (c,), dev)
    best_j = torch.empty((r,), dtype=torch.int32, device=dev)
    best_s = torch.empty((r,), dtype=torch.float32, device=dev)
    if r == 0:
        return best_j, best_s
    lib = _lib()
    tiles = -(-c // lib.sim_best_edge_col_tile())
    part_s = torch.empty((tiles, r), dtype=torch.float32, device=dev)
    part_j = torch.empty((tiles, r), dtype=torch.int32, device=dev)
    err = lib.sim_best_edge(
        xs_rows.data_ptr(), xs_all.data_ptr(), labels_row.data_ptr(),
        labels_col.data_ptr(), r, c, d, part_s.data_ptr(), part_j.data_ptr(),
        best_j.data_ptr(), best_s.data_ptr(), _build.stream(xs_rows),
    )
    _build.check(err, "sim_best_edge")
    launches += 1
    return best_j, best_s
