"""Carry a model's weights from the JAX package to the port.

The reference's param tree (nested dicts, layer weights stacked on axis 0)
maps onto ``transformer.LM`` by name: ``params["layers"]["attn"]["wq"][i]``
is ``layers.i.attn.wq``. Leaves are numpy arrays, or anything
``np.asarray`` reads (a JAX array).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.common import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import common, transformer


def params_from_jax(
    cfg: ModelConfig, tree: Any, device: str | torch.device | None = None
) -> transformer.LM:
    """The port's model holding the reference's weights, on ``device``
    (``None`` means the CUDA device). Each leaf keeps its dtype."""
    dev = resolve_device(device)
    recs = transformer.model_recs(cfg)
    want = {path: rec.shape for path, rec in common.leaves(recs)}
    got = {path: tuple(np.shape(a)) for path, a in common.leaves(tree)}
    if want != got:
        raise ValueError(f"{cfg.name}: param tree does not match the config's recs")
    tensors = common.tree_map(lambda a: torch.from_numpy(np.array(a)).to(dev), tree)
    return transformer.LM(cfg, tensors).eval()
