"""Deterministic LM data pipeline with O(1) skip-ahead.

The port of the JAX package's ``train/data.py``. Every batch is a pure
function of (seed, step): its draws come from a ``torch.Generator`` on the
CPU seeded from both (through ``numpy.random.SeedSequence``), so resuming
after a failure sees the same batches without replaying the stream, and
the CPU and the card see the same tokens. Torch cannot reproduce
``jax.random``, so the batches differ from the reference's; the transform
from draws to tokens is the seam that matches it (``tokens_from_draws``,
the reference's lines on its own uniforms and coin flips). The synthetic
stream is a Zipf-like token distribution with induced bigram structure (so
the loss actually falls).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.common import resolve_device

U_MIN = 1e-6  # the reference's minval of its uniforms


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    batch: int
    seq: int
    seed: int = 0


def _generator(seed: int, step: int) -> torch.Generator:
    state = np.random.SeedSequence([seed, int(step)]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))


def draws(cfg: DataConfig, step: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The batch's randomness, on the CPU: uniforms u in [1e-6, 1) (B, S)
    f32, drawn as the reference draws its own (r * (1 - 1e-6) + 1e-6, at
    least 1e-6), and fair coin flips ``mix`` (B, S) bool."""
    g = _generator(cfg.seed, step)
    r = torch.rand((cfg.batch, cfg.seq), generator=g)
    span = float(np.float32(1.0) - np.float32(U_MIN))
    u = torch.clamp(r * span + U_MIN, min=U_MIN)
    mix = torch.rand((cfg.batch, cfg.seq), generator=g) < 0.5
    return u, mix


def tokens_from_draws(u: torch.Tensor, mix: torch.Tensor, vocab: int) -> torch.Tensor:
    """(u, mix) -> tokens (B, S) int32: a Zipf-ish marginal by an exponential
    transform of u; where ``mix`` is false, a token is a function of its
    predecessor's marginal draw."""
    base = torch.floor((u ** (-0.5) - 1.0) * vocab / 40.0).to(torch.int32)
    base = torch.clamp(base, 0, vocab - 1)
    shifted = torch.roll(base, 1, dims=1)
    return torch.where(mix, base, (shifted * 7 + 11) % vocab).to(torch.int32)


def lm_batch(cfg: DataConfig, step: int, device: str | torch.device | None = None) -> dict:
    """Batch at ``step``: {"tokens": (B, S) int32} on ``device`` (``None``
    means the CUDA device)."""
    dev = resolve_device(device)
    u, mix = draws(cfg, step)
    return {"tokens": tokens_from_draws(u, mix, cfg.vocab).to(dev)}


def frontend_batch(
    cfg: DataConfig, step: int, n_tokens: int, dim: int, device: str | torch.device | None = None
) -> torch.Tensor:
    """The vlm/encdec stub's prefix embeddings at ``step``: (B, n_tokens,
    dim) f32 standard normals from (seed + 1, step)."""
    dev = resolve_device(device)
    g = _generator(cfg.seed + 1, step)
    return torch.randn((cfg.batch, n_tokens, dim), generator=g).to(dev)
