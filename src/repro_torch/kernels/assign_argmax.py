"""Host wrapper of the CUDA kernel ``csrc/assign_argmax.cu``: nearest center
per row, without statistics.

Counterpart of the JAX package's ``kernels/assign_argmax.py``. ``launches``
counts the calls that launched the kernel, ``bf16_launches`` those of them
on bf16 rows.

x is f32 with f32 centers, or bf16 with bf16 or f32 centers (the JAX
kernel's bf16 mode). bf16 rows are read as they are, with no f32 copy, and
multiplied on the tensor cores, f32 centers as the three bf16 parts of
``assign_stats.split_bf16x3``: idx and best_sim have the bits of
``assign_stats_cuda`` on the same inputs, in either mode.
"""

from __future__ import annotations

from ctypes import c_int as I
from ctypes import c_void_p as P

import torch

from repro_torch.kernels.assign_stats import center_operand

launches = 0
bf16_launches = 0

# C entry: pointers and the stream as c_void_p, sizes and element codes as c_int
_SIGNATURES = {"assign_argmax_scratch": [I], "assign_argmax": [P, P, I, I, I, I, I, P, P, P, P]}


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
    err = lib.assign_argmax(
        x.data_ptr(), c.data_ptr(), _build.ELEM[x.dtype], celem, n, d, k, idx.data_ptr(),
        best_sim.data_ptr(), scratch.data_ptr() or None, _build.stream(x),
    )
    _build.check(err, "assign_argmax")
    with _build.COUNT_LOCK:
        launches += 1
        bf16_launches += x.dtype == torch.bfloat16
    return idx, best_sim
