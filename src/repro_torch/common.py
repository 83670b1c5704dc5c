"""Shared small utilities: device choice, normalization, tree sizes,
segment reductions."""

from __future__ import annotations

from typing import Any, Iterator

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


def f32_row_blocks(x: torch.Tensor, elems: int = 1 << 24) -> Iterator[torch.Tensor]:
    """The rows of (n, d) ``x`` as f32: x itself when it is f32, else blocks
    of rows of about ``elems`` elements (64 MB in f32) upcast one at a time,
    so no f32 copy of all of a bf16 x is held."""
    if x.dtype == torch.float32:
        yield x
        return
    step = max(1, elems // max(1, x.shape[1]))
    for lo in range(0, max(x.shape[0], 1), step):
        yield x[lo:lo + step].float()


def sq_row_norms(x: torch.Tensor) -> torch.Tensor:
    """(n, d) -> (n,) f32 squared row norms of x's f32 values
    (``einsum("nd,nd->n")``), over ``f32_row_blocks``."""
    return torch.cat([torch.einsum("nd,nd->n", b, b) for b in f32_row_blocks(x)])


def cosine_sim_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n, d) x (m, d) -> (n, m) cosine similarity (inputs need not be
    normalized)."""
    return l2_normalize(a) @ l2_normalize(b).T


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    """The tensors of a tree of dicts, lists and tuples (None: no leaf)."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif tree is not None:
        yield tree


def count_params(tree: Any) -> int:
    """Elements over every tensor of the tree."""
    return sum(t.numel() for t in _tensors(tree))


def tree_bytes(tree: Any) -> int:
    """Bytes over every tensor of the tree."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def pretty_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0:
            return f"{n:.2f}{unit}"
        n /= 1024.0
    return f"{n:.2f}PiB"


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
