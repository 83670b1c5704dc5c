"""train_step / serve-step factories.

The port of the JAX package's ``train/step.py``. A train step takes the
model (``transformer.LM``), the optimizer state and a batch, and updates the
model and the state in place:

  * gradient accumulation over ``cfg.grad_accum`` equal microbatches (the
    batch's rows in order, as the reference's reshape cuts them): backward
    adds each microbatch's grads into the stacked f32 buffers of
    ``transformer.grad_buffers`` (zeroed first, so the sum is the
    reference's ``0 + g1 + g2 ...``), which are divided by the count; the
    loss and metrics are the microbatches' means. Params must be f32 (every
    entry point draws them so): their buffers are the accumulators;
  * with ``dp_group``, the grads and the loss metrics are averaged over the
    data-parallel ranks of that process group (an all-reduce SUM, then a
    division by the world size);
  * with ``grad_compress``, every gradient leaf goes through the int8 wire
    format (``fake_compress``) after that mean, before ``update``.

Metrics: ``loss``, ``ce``, ``aux`` (0-d device tensors), ``lr`` and
``grad_norm``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.distrib.compression import fake_compress
from repro_torch.models import transformer
from repro_torch.models.common import leaves
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.optimizer import AdamWConfig


def _div(t: torch.Tensor, n: int) -> torch.Tensor:
    """t / n, in place, by a true division (a 0-d divisor on t's device)."""
    return t.div_(torch.full((), float(n), device=t.device))


def _microbatches(batch: dict, n_mb: int) -> list[dict]:
    b = batch["tokens"].shape[0]
    if b % n_mb:
        raise ValueError(f"batch of {b} rows does not split into {n_mb} microbatches")
    parts = {k: torch.chunk(v, n_mb, dim=0) for k, v in batch.items()}
    return [{k: parts[k][i] for k in batch} for i in range(n_mb)]


def _mean(values: list[torch.Tensor]) -> torch.Tensor:
    return _div(torch.stack(values).sum(), len(values))


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    *,
    grad_compress: bool = False,
    dp_group: dist.ProcessGroup | None = None,
):
    """(params, opt_state, batch) -> (params, opt_state, metrics)."""
    n_mb = max(cfg.grad_accum, 1)

    def train_step(params: transformer.LM, opt_state: dict, batch: dict):
        acc = [g for _, g in leaves(transformer.grad_buffers(params))]
        if any(g.dtype != torch.float32 for g in acc):
            raise TypeError("the port trains f32 params: its grad buffers are the f32 accumulators")
        for g in acc:
            g.zero_()
        losses, metricses = [], []
        for mb in _microbatches(batch, n_mb):
            loss, metrics = transformer.loss_fn(params, cfg, mb)
            loss.backward()
            losses.append(loss.detach())
            metricses.append({k: v.detach() for k, v in metrics.items()})
        with torch.no_grad():
            if n_mb > 1:
                for a in acc:
                    _div(a, n_mb)
                loss = _mean(losses)
                metrics = {k: _mean([m[k] for m in metricses]) for k in metricses[0]}
            else:
                loss, metrics = losses[0], metricses[0]
            if dp_group is not None:
                world = dist.get_world_size(dp_group)
                for a in acc:
                    dist.all_reduce(a, group=dp_group)
                    _div(a, world)
                keys = ["loss", *metrics]
                vals = torch.stack([loss, *metrics.values()])
                dist.all_reduce(vals, group=dp_group)
                _div(vals, world)
                loss, metrics = vals[0], dict(zip(keys[1:], vals[1:]))
            grads = fake_compress(acc) if grad_compress else acc
            _, opt_state, stats = opt_mod.update(opt_cfg, params.stacked, grads, opt_state)
        return params, opt_state, {"loss": loss, **metrics, **stats}

    return train_step


def make_eval_step(cfg: ModelConfig):
    @torch.no_grad()
    def eval_step(params: transformer.LM, batch: dict):
        loss, metrics = transformer.loss_fn(params, cfg, batch)
        return {"loss": loss, **metrics}

    return eval_step


def make_prefill_step(cfg: ModelConfig):
    """Serving prefill: batch -> (last-token logits, decode caches, pos)."""

    def prefill_step(params: transformer.LM, batch: dict):
        return transformer.prefill(params, cfg, batch)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """Serving decode: one token for every sequence in the batch."""

    def decode_step(params: transformer.LM, tokens, caches, pos: int):
        return transformer.decode_step(params, cfg, tokens, caches, pos)

    return decode_step
