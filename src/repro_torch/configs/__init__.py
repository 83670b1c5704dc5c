"""Config registry: the 10 assigned architectures (a copy of the JAX
package's ``configs``, held to it by ``tests/test_torch_models.py``)."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    LONG_CONTEXT_ARCHS,
    ModelConfig,
    SHAPES,
    ShapeCell,
    cells_for,
)

_MODULES = {
    "paligemma-3b": "paligemma_3b",
    "qwen2-1.5b": "qwen2_1_5b",
    "minitron-8b": "minitron_8b",
    "llama3.2-3b": "llama3_2_3b",
    "gemma3-4b": "gemma3_4b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "mixtral-8x22b": "mixtral_8x22b",
    "whisper-base": "whisper_base",
    "zamba2-2.7b": "zamba2_2_7b",
    "rwkv6-3b": "rwkv6_3b",
}


def list_archs() -> list[str]:
    return list(_MODULES)


def get_config(arch: str, *, reduced: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {list(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    if reduced:
        # CPU-scale smoke configs never microbatch or FSDP-shard
        return mod.REDUCED.replace(grad_accum=1, fsdp=False)
    return mod.CONFIG


__all__ = [
    "LONG_CONTEXT_ARCHS",
    "ModelConfig",
    "SHAPES",
    "ShapeCell",
    "cells_for",
    "get_config",
    "list_archs",
]
