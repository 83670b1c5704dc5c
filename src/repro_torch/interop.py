"""Carry state between the JAX package and the port, through numpy.

The system has no model weights: its state is the data and the fit (x or
token counts, ``sample_idx``, initial or fitted centers, labels). Data is
f32, labels int32, and indices that torch uses to index are int64. Each
function puts its tensor on the CUDA device unless ``device`` names another
(``"cpu"``, as the tests pass); with no card, ``device=None`` raises.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.common import resolve_device


def data(a, device: str | torch.device | None = None) -> torch.Tensor:
    """f32 tensor of a numpy (or JAX, via ``np.asarray``) float array."""
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(resolve_device(device))


def labels(a, device: str | torch.device | None = None) -> torch.Tensor:
    """int32 tensor of labels (cluster ids, component ids, pad -1)."""
    return torch.from_numpy(np.array(a, dtype=np.int32)).to(resolve_device(device))


def index(a, device: str | torch.device | None = None) -> torch.Tensor:
    """int64 tensor of row indices (``sample_idx``)."""
    return torch.from_numpy(np.array(a, dtype=np.int64)).to(resolve_device(device))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host numpy copy of a tensor, on any device."""
    return t.detach().cpu().numpy()
