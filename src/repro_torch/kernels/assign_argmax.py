"""Host wrapper of the CUDA kernel ``csrc/assign_argmax.cu``: nearest center
per row, without statistics.

Counterpart of the JAX package's ``kernels/assign_argmax.py``. ``launches``
counts the calls that launched the kernel, ``bf16_launches`` those of them
on bf16 rows.

x is f32 with f32 centers, or bf16 with bf16 or f32 centers (the JAX
kernel's bf16 mode). bf16 rows are read as they are, with no f32 copy, and
multiplied on the tensor cores, f32 centers as the three bf16 parts of
``assign_stats.split_bf16x3``: idx and best_sim have the bits of
``assign_stats_cuda`` on the same inputs, in either mode. ``tile_plan`` is
the bf16 kernel's plan (its center tiles, their widths and its grid),
which the C entry checks against its own.
"""

from __future__ import annotations

from ctypes import c_int as I
from ctypes import c_longlong as L
from ctypes import c_void_p as P
from typing import NamedTuple

import torch

from repro_torch.kernels.assign_stats import center_operand

launches = 0
bf16_launches = 0

# C entry: pointers and the stream as c_void_p, sizes and element codes as c_int
_SIGNATURES = {
    "assign_argmax_scratch": [I],
    "assign_argmax": [P, P, I, I, I, I, I, I, I, I, L, P, P, P, P],
}

TILE = 128  # centers of a full center tile
WIDTHS = (16, 32, 64, 128)  # the widths the tile computes (the width probe's)
# rows of x a block, by the centers' bf16 parts (``csrc/assign_argmax.cu``'s
# kArgmaxRows: three consumer warpgroups for f32 centers' parts, two for bf16)
ROWS = {1: 128, 3: 192}


class TilePlan(NamedTuple):
    """The bf16 kernel's grid: center tile c is columns
    [tiles[c][0], tiles[c][0] + tiles[c][1]), of which those below k are
    centers; a row tile is ROWS[parts] rows. A row tile's blocks run side
    by side, one a center tile, but where ``folded`` the block of the last
    128-wide tile also computes the narrow last one: ``blocks`` =
    ``row_tiles`` * (len(tiles) - folded)."""

    tiles: tuple[tuple[int, int], ...]
    folded: bool
    row_tiles: int
    blocks: int


def tile_width(cols: int) -> int:
    """The narrowest width in WIDTHS that holds ``cols`` (1 .. 128) columns:
    ``csrc/assign_tile.cuh``'s ``wg_tile_n``."""
    return next(w for w in WIDTHS if cols <= w)


def tile_plan(n: int, k: int, parts: int) -> TilePlan:
    """Plan of the bf16 kernel for n rows and k >= 1 centers of ``parts``
    bf16 parts (1: bf16 centers; 3: f32 ones): center tiles of 128, the
    last as narrow as its centers allow and, for bf16 centers and a last
    tile of 16 or 32 columns, computed by the block of the tile before it
    (``csrc/assign_argmax.cu``'s ``argmax_folds``)."""
    if k < 1 or n < 0 or parts not in (1, 3):
        raise ValueError(f"the plan needs n >= 0, k >= 1 and 1 or 3 parts, got {n}, {k}, {parts}")
    count = -(-k // TILE)
    first = TILE * (count - 1)
    last = tile_width(k - first)
    tiles = tuple((c * TILE, TILE) for c in range(count - 1)) + ((first, last),)
    folded = parts == 1 and count > 1 and last <= 32
    row_tiles = -(-n // ROWS[parts])
    return TilePlan(tiles, folded, row_tiles, row_tiles * (count - folded))


def assign_argmax_cuda(
    x: torch.Tensor, centers: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(n, d) f32 and (k, d) f32, or (n, d) bf16 and (k, d) bf16 or f32 ->
    ((n,) int32 best center, (n,) f32 its similarity). Contract of
    ``ref.assign_argmax``; bf16 x as the module says."""
    global launches, bf16_launches
    from repro_torch.kernels import _build

    n, d = x.shape
    k = centers.shape[0]
    dev = x.device
    if k < 1 or d < 1:
        raise ValueError(f"the kernel needs k >= 1 and d >= 1, got k={k}, d={d}")
    _build.require(x, "x", _build.ROWS, (n, d), dev)
    _build.require(centers, "centers",
                   _build.ROWS if x.dtype == torch.bfloat16 else torch.float32, (k, d), dev)
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    best_sim = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return idx, best_sim
    lib = _build.library("assign_argmax", _SIGNATURES)
    # the center tiles' winners, merged by the kernel's second launch
    scratch = torch.empty((n * lib.assign_argmax_scratch(k),), dtype=torch.float32, device=dev)
    c, celem = center_operand(x, centers)
    plan = (0, 0, 0, 0)  # unread for f32 x
    if x.dtype == torch.bfloat16:
        p = tile_plan(n, k, 3 if centers.dtype == torch.float32 else 1)
        plan = (len(p.tiles), p.tiles[-1][1], int(p.folded), p.blocks)
    err = lib.assign_argmax(
        x.data_ptr(), c.data_ptr(), _build.ELEM[x.dtype], celem, n, d, k, *plan, idx.data_ptr(),
        best_sim.data_ptr(), scratch.data_ptr() or None, _build.stream(x),
    )
    _build.check(err, "assign_argmax")
    with _build.COUNT_LOCK:
        launches += 1
        bf16_launches += x.dtype == torch.bfloat16
    return idx, best_sim
