"""Host wrapper of the CUDA kernel ``csrc/assign_argmax.cu``: nearest center
per row, without statistics.

Counterpart of the JAX package's ``kernels/assign_argmax.py``. ``launches``
counts the calls that launched the kernel.
"""

from __future__ import annotations

from ctypes import c_int as I
from ctypes import c_void_p as P

import torch

launches = 0

# C entry: pointers and the stream as c_void_p, sizes as c_int
_SIGNATURES = {"assign_argmax": [P, P, I, I, I, P, P, P]}


def assign_argmax_cuda(
    x: torch.Tensor, centers: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(n, d), (k, d) f32 -> ((n,) int32 best center, (n,) f32 its
    similarity). Contract of ``ref.assign_argmax``."""
    global launches
    from repro_torch.kernels import _build

    n, d = x.shape
    k = centers.shape[0]
    dev = x.device
    if k < 1 or d < 1:
        raise ValueError(f"the kernel needs k >= 1 and d >= 1, got k={k}, d={d}")
    _build.require(x, "x", torch.float32, (n, d), dev)
    _build.require(centers, "centers", torch.float32, (k, d), dev)
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    best_sim = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return idx, best_sim
    lib = _build.library("assign_argmax", _SIGNATURES)
    err = lib.assign_argmax(
        x.data_ptr(), centers.data_ptr(), n, d, k, idx.data_ptr(),
        best_sim.data_ptr(), _build.stream(x),
    )
    _build.check(err, "assign_argmax")
    launches += 1
    return idx, best_sim
