"""Sampling: the Buckshot sample of s distinct documents.

JAX's ``jax.random.choice`` stream cannot be reproduced in torch; the port
draws with an explicit ``torch.Generator`` and its tests hold it to the JAX
package through the entry points that take the draws as inputs
(``buckshot_fit(x, sample_idx, k)``, ``kmeans_fit(x, init_centers, k)``).
"""

from __future__ import annotations

import math

import torch

from repro_torch.common import resolve_device


def sample_indices(
    n: int,
    s: int,
    generator: torch.Generator,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """(s,) int64 distinct indices uniform over [0, n).

    ``generator`` is a CPU generator; the draw is moved to ``device``
    (``None`` means the CUDA device).
    """
    dev = resolve_device(device)
    if not 0 <= s <= n:
        raise ValueError(f"cannot draw {s} distinct indices from {n}")
    return torch.randperm(n, generator=generator)[:s].to(dev)


def buckshot_sample_size(n: int, k: int) -> int:
    """Paper's sample size s = sqrt(k * n)."""
    return max(k, int(math.ceil(math.sqrt(float(k) * float(n)))))
