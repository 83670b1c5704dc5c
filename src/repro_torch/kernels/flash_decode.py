"""Host wrapper of the CUDA kernel ``csrc/flash_decode.cu``: one-token
grouped-query attention against a KV cache.

Counterpart of the JAX package's ``kernels/flash_decode.py``. ``launches``
counts the calls that launched the kernel (one launch a call: the block that
finishes last merges the position splits).
"""

from __future__ import annotations

import functools
from ctypes import c_int as I
from ctypes import c_void_p as P

import torch

launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# C entries: pointers and the stream as c_void_p, sizes as c_int
_SIGNATURES = {
    "flash_decode_splits": [I, I, I, I, I],
    "flash_decode_heads_per_block": [],
    "flash_decode_max_dh": [],
    "flash_decode": [P, P, P, P, I, I, I, I, I, I, I, P, P, P, P],
}

# per device: the stream it was last used on, the partials buffer and the
# kv-head blocks' ticket counters, which every call leaves at 0 for the next
_workspace: dict[int, tuple[int, torch.Tensor, torch.Tensor]] = {}


@functools.cache
def _lib():
    """The library, its query heads per block and its largest dh."""
    from repro_torch.kernels import _build

    lib = _build.library("flash_decode", _SIGNATURES)
    return lib, lib.flash_decode_heads_per_block(), lib.flash_decode_max_dh()


@functools.cache
def _splits(s: int, hk: int, g: int, dh: int, dtype: int, device: int) -> int:
    """Position splits per kv-head block, planned once per shape and card."""
    with torch.cuda.device(device):
        return _lib()[0].flash_decode_splits(s, hk, g, dh, dtype)


def _scratch(dev: torch.device, stream: int, floats: int, blocks: int):
    """The partials and the ticket counters, one pair per device.

    They live until a call on another stream, or a larger call, replaces
    them: calls on one stream run in order, so each reuses them, and new
    counters start at 0. They are allocated on the stream of the call, and
    PyTorch's caching allocator hands a freed block out again only to that
    stream, so a launch still running there when they are replaced is
    safe."""
    held = _workspace.get(dev.index)
    if held is None or held[0] != stream:
        _workspace.pop(dev.index, None)
        held = (stream, None, None)
    _, part, tickets = held
    if part is None or part.numel() < floats:
        part = torch.empty((floats,), dtype=torch.float32, device=dev)
    if tickets is None or tickets.numel() < blocks:
        tickets = torch.zeros((blocks,), dtype=torch.int32, device=dev)
    _workspace[dev.index] = (stream, part, tickets)
    return part, tickets


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
    lib, heads, max_dh = _lib()
    if not 0 < dh <= max_dh:
        raise ValueError(f"the kernel takes 0 < dh <= {max_dh}, got {dh}")
    if isinstance(length, torch.Tensor):
        _build.require(length, "length", torch.int32, (), dev)
        len_ptr, len_val = length.data_ptr(), 0
    else:
        len_ptr, len_val = None, max(-1, min(int(length), s))
    if s == 0:
        return torch.zeros((h, dh), dtype=q.dtype, device=dev)
    g = h // hk
    dtype = _DTYPES[q.dtype]
    nsplit = _splits(s, hk, g, dh, dtype, dev.index)
    blocks = hk * -(-g // heads)
    stream = _build.stream(q)
    out = torch.empty((h, dh), dtype=q.dtype, device=dev)
    # the partials and tickets are the device's: held from here to the
    # launch's enqueue, so a call from another thread cannot share them
    with _build.device_lock(dev.index):
        part, tickets = _scratch(dev, stream, blocks * nsplit * heads * (dh + 2), blocks)
        err = lib.flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), len_ptr, len_val, s, hk, g,
            dh, dtype, nsplit, part.data_ptr(), tickets.data_ptr(), out.data_ptr(), stream,
        )
    _build.check(err, "flash_decode")
    with _build.COUNT_LOCK:
        launches += 1
    return out
