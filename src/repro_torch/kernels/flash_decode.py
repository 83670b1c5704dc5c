"""Host wrapper of the CUDA kernel ``csrc/flash_decode.cu``: one-token
grouped-query attention against a KV cache.

Counterpart of the JAX package's ``kernels/flash_decode.py``. ``launches``
counts the calls that launched the kernel (one call is two launches: the
position splits, then their merge).
"""

from __future__ import annotations

from ctypes import c_int as I
from ctypes import c_void_p as P

import torch

launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# C entries: pointers and the stream as c_void_p, sizes as c_int
_SIGNATURES = {
    "flash_decode_split_len": [],
    "flash_decode_heads_per_block": [],
    "flash_decode_max_dh": [],
    "flash_decode": [P, P, P, P, I, I, I, I, I, I, P, P, P, P, P],
}


def flash_decode_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, length: int | torch.Tensor
) -> torch.Tensor:
    """q (h, dh), k and v (s, hk, dh), all f32 or all bf16; ``length`` a
    Python int or a 0-d int32 tensor on q's device, read by the kernel
    without a host sync -> (h, dh) in q's dtype. Contract of
    ``ref.flash_decode``."""
    global launches
    from repro_torch.kernels import _build

    s, hk, dh = k.shape
    h = q.shape[0]
    dev = q.device
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, not {q.dtype}")
    if hk < 1 or h % hk:
        raise ValueError(f"h = {h} query heads must be a multiple of hk = {hk} kv heads")
    _build.require(q, "q", q.dtype, (h, dh), dev)
    _build.require(k, "k", q.dtype, (s, hk, dh), dev)
    _build.require(v, "v", q.dtype, (s, hk, dh), dev)
    lib = _build.library("flash_decode", _SIGNATURES)
    if not 0 < dh <= lib.flash_decode_max_dh():
        raise ValueError(f"the kernel takes 0 < dh <= {lib.flash_decode_max_dh()}, got {dh}")
    if isinstance(length, torch.Tensor):
        _build.require(length, "length", torch.int32, (), dev)
        len_ptr, len_val = length.data_ptr(), 0
    else:
        len_ptr, len_val = None, max(-1, min(int(length), s))
    if s == 0:
        return torch.zeros((h, dh), dtype=q.dtype, device=dev)
    g = h // hk
    heads = lib.flash_decode_heads_per_block()
    slots = hk * -(-g // heads) * -(-s // lib.flash_decode_split_len()) * heads
    part_m = torch.empty((slots,), dtype=torch.float32, device=dev)
    part_l = torch.empty((slots,), dtype=torch.float32, device=dev)
    part_acc = torch.empty((slots, dh), dtype=torch.float32, device=dev)
    out = torch.empty((h, dh), dtype=q.dtype, device=dev)
    err = lib.flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), len_ptr, len_val, s, hk, g,
        dh, _DTYPES[q.dtype], part_m.data_ptr(), part_l.data_ptr(),
        part_acc.data_ptr(), out.data_ptr(), _build.stream(q),
    )
    _build.check(err, "flash_decode")
    launches += 1
    return out
