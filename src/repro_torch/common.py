"""Shared small utilities: device choice, normalization, segment reductions."""

from __future__ import annotations

import torch

EPS = 1e-12


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the CUDA device; it is never replaced by the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = EPS) -> torch.Tensor:
    """L2-normalize along ``dim``; zero vectors stay zero."""
    norm = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def _in_range(ids: torch.Tensor, k: int) -> torch.Tensor:
    return (ids >= 0) & (ids < k)


def segment_sum(data: torch.Tensor, ids: torch.Tensor, k: int) -> torch.Tensor:
    """Sum rows of ``data`` into ``k`` bins; ids outside [0, k) are dropped."""
    keep = _in_range(ids, k)
    out = torch.zeros((k,) + tuple(data.shape[1:]), dtype=data.dtype, device=data.device)
    return out.index_add_(0, ids[keep].long(), data[keep])


def segment_min(data: torch.Tensor, ids: torch.Tensor, k: int) -> torch.Tensor:
    """Per-bin minimum; empty bins hold +inf, ids outside [0, k) are dropped."""
    keep = _in_range(ids, k)
    out = torch.full((k,), float("inf"), dtype=data.dtype, device=data.device)
    return out.scatter_reduce_(0, ids[keep].long(), data[keep], "amin", include_self=True)


def bincount(ids: torch.Tensor, k: int) -> torch.Tensor:
    """(k,) int32 occurrence counts; ids outside [0, k) are dropped."""
    ones = torch.ones(ids.shape, dtype=torch.int32, device=ids.device)
    return segment_sum(ones, ids, k)
