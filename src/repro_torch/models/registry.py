"""Registry: config -> bound model functions.

The port of the JAX package's ``models/registry.py``. ``init_params`` returns
the model itself (``transformer.LM``, an ``nn.Module``), and the bound
functions take it where the reference takes its param tree.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.common import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import common, transformer


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
