"""Host wrapper of the CUDA kernel ``csrc/best_edge.cu``: per row of an
already-built similarity block, the best column in another component.

Counterpart of the JAX package's ``kernels/best_edge.py``. ``launches``
counts the calls that launched the kernel, ``bf16_launches`` those of them
on a bf16 block, which the kernel reads as it lies: the bits of the call on
the block's ``float()``. On a bf16 block the kernel stages the column labels
in shared memory as int16 when every one lies in the int16 range (negative
labels as -1) and the block has at most ``BF16_STAGED_NARROW`` columns, as
their low and high halves when one does not and it has at most
``BF16_STAGED_WIDE``, and otherwise reads them from global memory; it finds
which while it stages (``bf16_label_path`` says which, for a report).
"""

from __future__ import annotations

from ctypes import c_int as I
from ctypes import c_void_p as P

import torch

from repro_torch.kernels import ref

launches = 0
bf16_launches = 0

# C entry: pointers and the stream as c_void_p, sizes and the element code as c_int
_SIGNATURES = {"best_edge": [P, I, P, P, I, I, P, P, P]}

# the columns a block stages for a bf16 block (csrc/best_edge.cu:
# kMaxStagedWide, kMaxStaged16)
BF16_STAGED_WIDE, BF16_STAGED_NARROW = 58_104, 116_216


def bf16_label_path(labels_col: torch.Tensor) -> str:
    """How the kernel reads the labels of a bf16 block's columns (reads the
    labels back: for reports, not for the call)."""
    c = labels_col.numel()
    narrow = c == 0 or int(labels_col.max()) <= 32_767
    if narrow and c <= BF16_STAGED_NARROW:
        return "int16 staged"
    if c <= BF16_STAGED_WIDE:
        return "int16 halves staged"
    return "int32 global"


def best_edge_cuda(
    sim: torch.Tensor, labels_row: torch.Tensor, labels_col: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(r, c) f32 or bf16, (r,), (c,) int32 -> ((r,) int32 best column,
    (r,) f32 its similarity). Contract of ``ref.best_edge``; r = 0 and c = 0
    are answered without a launch."""
    global launches, bf16_launches
    from repro_torch.kernels import _build

    r, c = sim.shape
    dev = sim.device
    _build.require(sim, "sim", _build.ROWS, (r, c), dev)
    _build.require(labels_row, "labels_row", torch.int32, (r,), dev)
    _build.require(labels_col, "labels_col", torch.int32, (c,), dev)
    if r == 0 or c == 0:  # no row, or no candidate for any row
        return (torch.full((r,), -1, dtype=torch.int32, device=dev),
                torch.full((r,), ref.NEG, dtype=torch.float32, device=dev))
    best_j = torch.empty((r,), dtype=torch.int32, device=dev)
    best_s = torch.empty((r,), dtype=torch.float32, device=dev)
    err = _build.library("best_edge", _SIGNATURES).best_edge(
        sim.data_ptr(), _build.ELEM[sim.dtype], labels_row.data_ptr(), labels_col.data_ptr(), r, c,
        best_j.data_ptr(), best_s.data_ptr(), _build.stream(sim),
    )
    _build.check(err, "best_edge")
    with _build.COUNT_LOCK:
        launches += 1
        bf16_launches += sim.dtype == torch.bfloat16
    return best_j, best_s
