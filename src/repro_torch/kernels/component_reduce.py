"""Host wrapper of the CUDA kernel ``csrc/component_reduce.cu``: the
per-component (w desc, row asc) best of a shard's Borůvka candidates.

Counterpart of the JAX package's ``kernels/component_reduce.py``.
``launches`` counts the calls that launched the kernel (one launch a call).

The kernel is bound by the host's time to call it, so a call does the least
it can: one check a tensor, one allocation for the three outputs (views of
one buffer) and one ctypes call. Where the keys fit in one block's shared
memory it takes nothing else; a larger call takes the cooperative grid,
whose key buffers are kept here.
"""

from __future__ import annotations

import functools
from ctypes import c_int as I
from ctypes import c_void_p as P

import torch

launches = 0

# C entries: pointers and the stream as c_void_p, sizes as c_int
_SIGNATURES = {
    "component_best_edge_block_keys": [],
    "component_best_edge_block_rows": [],
    "component_best_edge_block": [P, P, P, P, I, I, P, P],
    "component_best_edge_grid": [P, P, P, P, I, I, P, P, P, I, P, P],
}

# per device: the stream it was last used on, the cooperative grid's two key
# buffers (2, capacity), its barrier counters, which buffer the next call
# takes, and the number of keys the last call used (the next one zeroes them)
_grid_state: dict[int, list] = {}


@functools.cache
def _lib():
    """The library and the one-block grid's limits (keys, rows)."""
    from repro_torch.kernels import _build

    lib = _build.library("component_reduce", _SIGNATURES)
    return lib, lib.component_best_edge_block_keys(), lib.component_best_edge_block_rows()


def _grid_keys(dev: torch.device, stream: int, c: int) -> list:
    """The cooperative grid's state for ``dev``: [stream, keys (2, capacity)
    int64, barrier (2,) int32, next buffer, keys the last call used].

    Every call leaves its own buffer's keys set and zeroes the other's, so
    the next call, which takes that other buffer, finds it zero. The state is
    made anew (zeroed) on another stream or for a larger c: calls on one
    stream run in order, and PyTorch's caching allocator hands a freed block
    out again only to the stream it was allocated on."""
    held = _grid_state.get(dev.index)
    if held is None or held[0] != stream or held[1].shape[1] < c:
        cap = c if held is None else max(c, held[1].shape[1])
        held = [stream, torch.zeros((2, cap), dtype=torch.int64, device=dev),
                torch.zeros((2,), dtype=torch.int32, device=dev), 0, 0]
        _grid_state[dev.index] = held
    return held


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
    out = torch.empty((3, c), dtype=torch.int32, device=dev)
    w_bits, best_row, best_j = out.unbind(0)
    best_w = w_bits.view(torch.float32)
    if c == 0:
        return best_w, best_row, best_j
    lib, block_keys, block_rows = _lib()
    args = (row_w.data_ptr(), row_j.data_ptr(), rows.data_ptr(), comp.data_ptr(), r, c,
            out.data_ptr())
    if c <= block_keys and r <= block_rows:
        err = lib.component_best_edge_block(*args, _build.stream(row_w))
    else:
        stream = _build.stream(row_w)
        with _build.device_lock(dev.index):  # the grid's state is the device's
            held = _grid_keys(dev, stream, c)
            keys, bar, cur, last_c = held[1], held[2], held[3], held[4]
            err = lib.component_best_edge_grid(
                *args, keys[cur].data_ptr(), keys[1 - cur].data_ptr(), last_c,
                bar.data_ptr(), stream,
            )
            if err == 0:
                held[3], held[4] = 1 - cur, c
    _build.check(err, "component_best_edge")
    with _build.COUNT_LOCK:
        launches += 1
    return best_w, best_row, best_j
