"""Abstract inputs (empty DTensors with their placements) for every dry-run
cell.

The port of the JAX package's ``launch/specs.py``. Nothing here allocates
when called in a ``torch.device("meta")`` context (as the dry-run does): params and
optimizer state come from Rec trees, caches from ``transformer.init_cache``
placed leaf by leaf, batches from ``registry.batch_specs``.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.models import transformer
from repro_torch.models.common import MeshPolicy, _contiguous_stride, abstract, local_device
from repro_torch.models.registry import batch_specs, get_model
from repro_torch.train import optimizer as opt_mod


def _cache_syms(cfg: ModelConfig, batch: int) -> Any:
    """Sym-spec tree structurally matching transformer.init_cache output."""
    attn = {"k": ("dp", None, "tp", None), "v": ("dp", None, "tp", None)}
    if batch < 8:  # long-context: sequence-sharded KV
        attn = {"k": (None, "tp", None, None), "v": (None, "tp", None, None)}
    fam = cfg.family
    if fam in ("dense", "vlm", "moe"):
        return [attn for _ in range(cfg.n_layers)]
    if fam == "hybrid":
        out = []
        for i in range(cfg.n_layers):
            c: dict[str, Any] = {
                "mamba": {
                    "state": ("dp", "tp", None, None),
                    "conv": ("dp", None, "tp"),
                }
            }
            if cfg.attn_every and (i + 1) % cfg.attn_every == 0:
                c["attn"] = attn
            out.append(c)
        return out
    if fam == "rwkv":
        one = {
            "time": {
                "shift": ("dp", None, "tp"),
                "state": ("dp", None, None, None),
            },
            "chan": {"shift": ("dp", None, "tp")},
        }
        return [one for _ in range(cfg.n_layers)]
    if fam == "encdec":
        return {
            "self": [attn for _ in range(cfg.n_layers)],
            "enc_out": ("dp", None, None),
        }
    raise ValueError(fam)


def empty(shape, dtype: torch.dtype, policy: MeshPolicy, sym) -> DTensor:
    """An empty DTensor of global ``shape`` placed as ``sharding_for`` says."""
    shape = tuple(shape)
    local = torch.empty(policy.shard_shape(shape, sym), dtype=dtype,
                        device=local_device(policy))
    return DTensor.from_local(local, policy.mesh, policy.sharding_for(shape, sym),
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def _map2(fn, tree: Any, syms: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map2(fn, tree[k], syms[k]) for k in tree}
    if isinstance(tree, list):
        return [_map2(fn, t, s) for t, s in zip(tree, syms, strict=True)]
    return fn(tree, syms)


def abstract_cache(cfg: ModelConfig, cell: ShapeCell, policy: MeshPolicy):
    """Decode-cell cache: capacity = cell.seq_len, each leaf placed by
    ``_cache_syms``."""
    b, s = cell.global_batch, cell.seq_len
    shapes = transformer.init_cache(cfg, b, s, torch.bfloat16, "meta")
    return _map2(lambda t, sym: empty(t.shape, t.dtype, policy, sym), shapes,
                 _cache_syms(cfg, b))


def cell_inputs(
    cfg: ModelConfig, cell: ShapeCell, policy: MeshPolicy, dtype: torch.dtype = torch.bfloat16
) -> dict:
    """All abstract inputs for one (arch x shape) dry-run cell: "params" is
    the stacked param tree (the reference's layout; ``transformer.LM``
    takes it) of placed DTensors of ``dtype`` (bf16, as the reference's)."""
    model = get_model(cfg)
    out: dict[str, Any] = {"params": abstract(model._placed_recs(), policy, dtype)}
    if cell.kind == "train":
        out["opt_state"] = opt_mod.abstract_opt_state(model._placed_recs(), policy)
        out["batch"] = batch_specs(cfg, cell.global_batch, cell.seq_len, policy)
    elif cell.kind == "prefill":
        out["batch"] = batch_specs(cfg, cell.global_batch, cell.seq_len, policy)
    else:  # decode
        b = cell.global_batch
        out["tokens"] = empty((b, 1), torch.int32, policy, ("dp", None))
        out["caches"] = abstract_cache(cfg, cell, policy)
        out["pos"] = cell.seq_len - 1
    return out
