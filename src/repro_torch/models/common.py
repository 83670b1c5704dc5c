"""Param records: shape + init rule per leaf, and their materialization.

A copy of the records of the JAX package's ``models/common.py``. The
symbolic partition spec (``sym``) is kept as data so that the two rec trees
compare equal; the port places no shards (the mesh policy, ``hint``,
``abstract`` and ``fsdp_recs`` serve XLA's SPMD partitioner and are not
ported). Leaves are drawn from an explicit ``torch.Generator`` in the order
of the tree's sorted keys, as JAX flattens a dict; torch cannot reproduce
``jax.random`` streams, so weights are carried across with
``models.interop.params_from_jax`` where the two packages must agree.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterator

import numpy as np
import torch

from repro_torch.common import resolve_device


@dataclass(frozen=True)
class Rec:
    """A parameter leaf: shape + symbolic spec + init rule."""

    shape: tuple[int, ...]
    sym: tuple = ()  # symbolic partition spec, () -> fully replicated
    init: str = "normal"  # normal | zeros | ones | embed | small
    scale: float = 1.0  # multiplier on the fan-in init


def is_rec(x: Any) -> bool:
    return isinstance(x, Rec)


def leaves(tree: Any, path: tuple[str, ...] = ()) -> Iterator[tuple[tuple[str, ...], Any]]:
    """(path, leaf) pairs of a nested dict, keys sorted at every level."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from leaves(tree[key], path + (key,))
    else:
        yield path, tree


def tree_map(fn, tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, v) for key, v in tree.items()}
    return fn(tree)


def _init_leaf(generator: torch.Generator, rec: Rec, dtype: torch.dtype) -> torch.Tensor:
    dev = generator.device
    if rec.init == "zeros":
        return torch.zeros(rec.shape, dtype=dtype, device=dev)
    if rec.init == "ones":
        return torch.ones(rec.shape, dtype=dtype, device=dev)
    draw = torch.randn(rec.shape, generator=generator, device=dev)
    if rec.init == "embed":
        return (draw * 0.02 * rec.scale).to(dtype)
    # fan-in scaled normal
    fan_in = rec.shape[0] if len(rec.shape) >= 2 else max(rec.shape[-1], 1)
    if len(rec.shape) == 3:  # stacked/expert weights: fan-in is dim -2
        fan_in = rec.shape[-2]
    std = rec.scale / np.sqrt(fan_in)
    return (draw * std).to(dtype)


def materialize(
    generator: torch.Generator,
    recs: Any,
    device: str | torch.device | None = None,
    dtype: torch.dtype = torch.float32,
) -> Any:
    """Rec tree -> tensor tree on ``device`` (``None`` means the CUDA device).

    Leaves are drawn on the generator's device in sorted-key order, then
    moved; a generator on ``device`` avoids the copy."""
    dev = resolve_device(device)
    out: dict = {}
    for path, rec in leaves(recs):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _init_leaf(generator, rec, dtype).to(dev)
    return out


def stack(recs: Any, n: int) -> Any:
    """Prepend a stacked-layer dim (replicated) to every Rec."""
    return tree_map(lambda r: Rec((n,) + r.shape, (None,) + tuple(r.sym), r.init, r.scale), recs)


def param_count(recs: Any) -> int:
    return sum(int(np.prod(r.shape)) for _, r in leaves(recs))
