"""Carry state between the JAX package and the port, through numpy.

The system has no model weights: its state is the data and the fit (x or
token counts, ``sample_idx``, initial or fitted centers, labels). Data is
f32, labels int32, and indices that torch uses to index are int64.
"""

from __future__ import annotations

import numpy as np
import torch


def data(a, device: str | torch.device = "cpu") -> torch.Tensor:
    """f32 tensor of a numpy (or JAX, via ``np.asarray``) float array."""
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def labels(a, device: str | torch.device = "cpu") -> torch.Tensor:
    """int32 tensor of labels (cluster ids, component ids, pad -1)."""
    return torch.from_numpy(np.array(a, dtype=np.int32)).to(device)


def index(a, device: str | torch.device = "cpu") -> torch.Tensor:
    """int64 tensor of row indices (``sample_idx``)."""
    return torch.from_numpy(np.array(a, dtype=np.int64)).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host numpy copy of a tensor, on any device."""
    return t.detach().cpu().numpy()
