"""Gradient compression: int8 quantization with error feedback.

The port of the JAX package's ``distrib/compression.py``. Per-tensor
symmetric int8: ``scale = max|g| / 127`` (at least 1e-12 / 127), ``q =
round(g / scale)`` clipped to [-127, 127]. ``torch.round`` rounds half to
even, as ``jnp.round`` does, so ``q`` is the reference's bit for bit.
Error feedback (Seide et al.) carries each step's quantization residual into
the next.

``fake_compress`` applies the wire format to every gradient leaf in a train
step (the arithmetic of quantize -> sum -> dequantize with per-tensor
scales); ``compressed_psum`` is the explicit collective over a mesh's axes.
Trees are nested dicts (or lists) of tensors. Scalars that divide a tensor
are 0-d tensors on its device: CUDA divides by a Python number as a product
with its reciprocal, which is not the reference's rounding.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.distributed as dist

from repro_torch.distrib.sharding import axis_groups


def _map(fn, *trees):
    head = trees[0]
    if isinstance(head, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in head}
    if isinstance(head, (list, tuple)):
        return type(head)(_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def _scale(g32: torch.Tensor) -> torch.Tensor:
    amax = torch.clamp(torch.max(torch.abs(g32)), min=1e-12)
    return amax / torch.full((), 127.0, device=g32.device)


def _q(g32: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)


def quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8. Returns (q, scale)."""
    g32 = g.float()
    scale = _scale(g32)
    return _q(g32, scale), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def fake_compress(grads: Any) -> Any:
    """Round-trip every gradient leaf through the int8 wire format."""

    def f(g):
        q, s = quantize(g)
        return dequantize(q, s).to(g.dtype)

    return _map(f, grads)


def init_error_feedback(grads_like: Any) -> Any:
    return _map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads_like)


def compress_with_feedback(grads: Any, errors: Any) -> tuple[Any, Any]:
    """(grads, residuals) -> (wire-format grads, new residuals)."""

    residuals = []

    def f(g, e):
        corrected = g.float() + e
        q, s = quantize(corrected)
        deq = dequantize(q, s)
        residuals.append(corrected - deq)
        return deq.to(g.dtype)

    wire = _map(f, grads, errors)
    it = iter(residuals)  # _map visits the leaves in the same order again
    return wire, _map(lambda _: next(it), grads)


def compressed_psum(g: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """The sum of ``g`` over the mesh's ``axes``, int8 on the wire and int32
    accumulated (every rank gets it).

    The scale is SHARED before quantizing (an all-reduce MAX of the local
    scales, one scalar), since int8 values quantized with different scales
    cannot be summed; then the int8 values are summed as int32."""
    g32 = g.float()
    scale = _scale(g32)
    groups = axis_groups(mesh, axes)
    for grp in groups:
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=grp)
    total = _q(g32, scale).to(torch.int32)
    for grp in groups:
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=grp)
    return total.float() * scale
