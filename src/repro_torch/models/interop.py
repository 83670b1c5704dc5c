"""Carry a model's weights between the JAX package and the port.

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
    cfg: ModelConfig, tree: Any, device: str | torch.device | None = None, policy=None
) -> transformer.LM:
    """The port's model holding the reference's weights, on ``device``
    (``None`` means the CUDA device). Each leaf keeps its dtype. With a
    ``MeshPolicy`` the leaves are placed on its mesh as DTensors
    (``Model.place_params``: the reference's shardings, FSDP where the
    config says so); every rank must pass the same tree."""
    dev = resolve_device(device)
    recs = transformer.model_recs(cfg)
    want = {path: rec.shape for path, rec in common.leaves(recs)}
    got = {path: tuple(np.shape(a)) for path, a in common.leaves(tree)}
    if want != got:
        raise ValueError(f"{cfg.name}: param tree does not match the config's recs")
    tensors = common.tree_map(lambda a: torch.from_numpy(np.array(a)).to(dev), tree)
    lm = transformer.LM(cfg, tensors).eval()
    if policy is None:
        return lm
    from repro_torch.models.registry import get_model

    return get_model(cfg).place_params(lm, policy)


def params_to_tree(params: transformer.LM) -> dict:
    """The inverse of ``params_from_jax``: the model's stacked tree as numpy
    arrays (copies), in the reference's layout and names."""
    return common.tree_map(lambda t: t.detach().cpu().numpy().copy(), params.stacked)
