"""Carry state between the JAX package and the port, through numpy.

The system has no model weights: its state is the data and the fit (x or
token counts, ``sample_idx``, initial or fitted centers, labels). Data is
f32 (bf16 where the source is bf16: document rows in bf16), labels int32,
and indices that torch uses to index are int64. Each
function puts its tensor on the CUDA device unless ``device`` names another
(``"cpu"``, as the tests pass); with no card, ``device=None`` raises.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.common import resolve_device


def data(a, device: str | torch.device | None = None) -> torch.Tensor:
    """f32 tensor of a numpy (or JAX, via ``np.asarray``) float array; a bf16
    array (numpy names its dtype "bfloat16", as JAX's bf16 arrays give it)
    becomes a bf16 tensor. Both go through f32, which holds every bf16 value
    exactly. The dtype is told by its name: numpy has no bf16 of its own."""
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    if getattr(getattr(a, "dtype", None), "name", None) == "bfloat16":
        t = t.bfloat16()
    return t.to(resolve_device(device))


def labels(a, device: str | torch.device | None = None) -> torch.Tensor:
    """int32 tensor of labels (cluster ids, component ids, pad -1)."""
    return torch.from_numpy(np.array(a, dtype=np.int32)).to(resolve_device(device))


def index(a, device: str | torch.device | None = None) -> torch.Tensor:
    """int64 tensor of row indices (``sample_idx``)."""
    return torch.from_numpy(np.array(a, dtype=np.int64)).to(resolve_device(device))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host numpy copy of a tensor, on any device; a bf16 tensor's values
    come back as f32 (exact), since numpy has no bf16."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
