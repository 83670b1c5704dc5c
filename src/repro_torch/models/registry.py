"""Registry: config -> bound model functions + abstract (dry-run) params.

The port of the JAX package's ``models/registry.py``. ``init_params`` returns
the model itself (``transformer.LM``, an ``nn.Module``), and the bound
functions take it where the reference takes its param tree. Under a mesh
policy, ``place_params`` puts a model's weights on the mesh as DTensors
(FSDP-sharded too when ``cfg.fsdp``), and ``abstract_params`` makes them
empty (on the ``meta`` device in the dry-run).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch.distributed.tensor import DTensor

from repro_torch.common import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import common, transformer
from repro_torch.models.common import MeshPolicy


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    recs: Any

    def init_params(
        self,
        generator: torch.Generator,
        device: str | torch.device | None = None,
        dtype: torch.dtype = torch.float32,
    ) -> transformer.LM:
        """Weights drawn from ``generator`` by the reference's init rules, on
        ``device`` (``None`` means the CUDA device)."""
        tree = common.materialize(generator, self.recs, device, dtype)
        return transformer.LM(self.cfg, tree).eval()

    def _placed_recs(self):
        return common.fsdp_recs(self.recs) if self.cfg.fsdp else self.recs

    def abstract_params(self, policy: MeshPolicy, dtype=torch.bfloat16) -> transformer.LM:
        """The model on empty DTensors placed under ``policy`` (no values;
        in a ``meta`` device context, no allocation)."""
        return transformer.LM(self.cfg, common.abstract(self._placed_recs(), policy, dtype)).eval()

    def param_shardings(self, policy: MeshPolicy):
        return common.sharding_tree(self._placed_recs(), policy)

    def place_params(self, params: transformer.LM, policy: MeshPolicy) -> transformer.LM:
        """``params`` (the same full weights on every rank) as a model whose
        parameters are DTensors placed as ``param_shardings`` says."""
        tree = common.place_tree(params.stacked, self._placed_recs(), policy)
        return transformer.LM(self.cfg, tree).train(params.training)

    def param_count(self) -> int:
        return common.param_count(self.recs)

    def forward(self, params: transformer.LM, batch: dict):
        h, aux, _ = transformer.forward(params, self.cfg, batch)
        return h, aux

    def loss(self, params: transformer.LM, batch: dict):
        return transformer.loss_fn(params, self.cfg, batch)

    def prefill(self, params: transformer.LM, batch: dict, cache_dtype=torch.bfloat16):
        return transformer.prefill(params, self.cfg, batch, cache_dtype)

    def decode_step(self, params: transformer.LM, tokens, caches, pos: int):
        return transformer.decode_step(params, self.cfg, tokens, caches, pos)

    def init_cache(self, batch: int, seq_len: int, dtype=torch.bfloat16, device=None):
        return transformer.init_cache(self.cfg, batch, seq_len, dtype, device)


def get_model(cfg: ModelConfig) -> Model:
    """The bound functions of any of the ten configs (every family is ported);
    an unknown family raises ValueError, as in the reference."""
    return Model(cfg=cfg, recs=transformer.model_recs(cfg))


def make_batch(
    cfg: ModelConfig,
    batch: int,
    seq: int,
    generator: torch.Generator,
    device: str | torch.device | None = None,
) -> dict:
    """Random batch drawn from ``generator`` (smoke tests / examples)."""
    dev = resolve_device(device)
    text_len = seq - cfg.n_frontend_tokens if cfg.family == "vlm" else seq
    out = {
        "tokens": torch.randint(
            0, cfg.vocab, (batch, text_len), generator=generator,
            device=generator.device, dtype=torch.int32,
        ).to(dev)
    }
    if cfg.family in ("vlm", "encdec"):
        out["frontend"] = torch.randn(
            (batch, cfg.n_frontend_tokens, cfg.frontend_dim), generator=generator,
            device=generator.device,
        ).to(dev)
    return out


def batch_specs(cfg: ModelConfig, batch: int, seq: int, policy: MeshPolicy | None):
    """Empty inputs for every model input (the dry-run: in a ``meta``
    device context, no allocation), placed under ``policy`` when given."""
    def sds(shape, dtype, sym):
        if policy is None:
            return torch.empty(shape, dtype=dtype)
        local = torch.empty(policy.shard_shape(shape, sym), dtype=dtype,
                            device=common.local_device(policy))
        return DTensor.from_local(local, policy.mesh, policy.sharding_for(shape, sym),
                                  run_check=False, shape=torch.Size(shape),
                                  stride=common._contiguous_stride(shape))

    text_len = seq - cfg.n_frontend_tokens if cfg.family == "vlm" else seq
    out = {"tokens": sds((batch, text_len), torch.int32, ("dp", None))}
    if cfg.family in ("vlm", "encdec"):
        out["frontend"] = sds(
            (batch, cfg.n_frontend_tokens, cfg.frontend_dim), torch.float32, ("dp", None, None)
        )
    return out
