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
    format (``fake_compress``) after that mean, before ``update``;
  * with ``policy`` (a ``MeshPolicy``), params, moments and batch are
    DTensors on its mesh (``Model.place_params``, ``optimizer.init_placed``,
    ``common.place``). The step runs under the policy, so the model's
    ``hint``s redistribute, and DTensor's own collectives make the
    data-parallel mean: a grad that is a partial sum over the dp-sharded
    batch is all-reduced into its replicated buffer. Each microbatch is cut
    from the global batch and re-sharded over dp (the reference's hint
    ``(None, "dp", ...)``), and the metrics come back as full tensors.

Metrics: ``loss``, ``ce``, ``aux`` (0-d device tensors), ``lr`` and
``grad_norm``.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ModelConfig
from repro_torch.distrib.compression import fake_compress
from repro_torch.models import transformer
from repro_torch.models.common import MeshPolicy, hint, leaves, use_policy
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.optimizer import AdamWConfig


def _div(t: torch.Tensor, n: int) -> torch.Tensor:
    """t / n, in place, by a true division (a 0-d divisor on t's device)."""
    return t.div_(torch.full((), float(n), device=t.device))


def _microbatches(batch: dict, n_mb: int) -> list[dict]:
    """The batch's rows cut into ``n_mb`` equal runs, in order (the
    reference's reshape); under a policy each run is sharded over dp."""
    b = batch["tokens"].shape[0]
    if b % n_mb:
        raise ValueError(f"batch of {b} rows does not split into {n_mb} microbatches")
    if n_mb == 1:
        return [batch]
    # DTensor cannot split a dp-sharded dim into (n_mb, rows): gather the
    # batch first (the reference's reshape is the same reshuffle)
    mb = {
        k: hint(hint(v, *(None,) * v.ndim).reshape((n_mb, b // n_mb) + tuple(v.shape[1:])),
                None, "dp", *(None,) * (v.ndim - 1))
        for k, v in batch.items()
    }
    return [{k: v[i] for k, v in mb.items()} for i in range(n_mb)]


def _full(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


def _mean(values: list[torch.Tensor]) -> torch.Tensor:
    return _div(torch.stack(values).sum(), len(values))


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    policy: MeshPolicy | None = None,
    *,
    grad_compress: bool = False,
    dp_group: dist.ProcessGroup | None = None,
):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    Grad buffers of another dtype than f32 (the dry-run's bf16 params) take
    each microbatch's grads in their own dtype, which are summed into
    separate f32 accumulators, the reference's arithmetic. Such params are
    only traced, on the meta device: the step updates params in place, and
    a bf16 param would round most of AdamW's steps away, so real ones are
    refused."""
    n_mb = max(cfg.grad_accum, 1)
    if policy is not None and dp_group is not None:
        raise ValueError("under a mesh policy DTensor makes the dp mean: pass no dp_group")

    def train_step(params: transformer.LM, opt_state: dict, batch: dict):
        if policy is None:
            return _step(params, opt_state, batch)
        with _placed(policy):
            params, opt_state, metrics = _step(params, opt_state, batch)
        return params, opt_state, {k: _full(v) for k, v in metrics.items()}

    def _step(params: transformer.LM, opt_state: dict, batch: dict):
        bufs = [g for _, g in leaves(transformer.grad_buffers(params))]
        f32 = all(g.dtype == torch.float32 for g in bufs)
        if not f32 and not all(g.is_meta for g in bufs):
            raise TypeError("the port trains f32 params: a bf16 param would round AdamW's "
                            "steps away (non-f32 params are only traced, on the meta device)")
        acc = bufs if f32 else [torch.zeros_like(g, dtype=torch.float32) for g in bufs]
        for g in bufs:
            g.zero_()
        losses, metricses = [], []
        for mb in _microbatches(batch, n_mb):
            loss, metrics = transformer.loss_fn(params, cfg, mb)
            loss.backward()
            if not f32:
                for a, g in zip(acc, bufs):
                    a.add_(g.float())
                    g.zero_()
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


def _placed(policy: MeshPolicy | None):
    """The policy active, and plain tensors (rope tables, 0-d divisors)
    taken as replicated beside DTensors; nothing without a policy."""
    if policy is None:
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(use_policy(policy))
    stack.enter_context(implicit_replication())
    return stack


def make_eval_step(cfg: ModelConfig, policy: MeshPolicy | None = None):
    @torch.no_grad()
    def eval_step(params: transformer.LM, batch: dict):
        with _placed(policy):
            loss, metrics = transformer.loss_fn(params, cfg, batch)
        return {"loss": loss, **metrics}

    return eval_step


def make_prefill_step(cfg: ModelConfig, policy: MeshPolicy | None = None):
    """Serving prefill: batch -> (last-token logits, decode caches, pos)."""

    def prefill_step(params: transformer.LM, batch: dict):
        with _placed(policy):
            return transformer.prefill(params, cfg, batch)

    return prefill_step


def make_decode_step(cfg: ModelConfig, policy: MeshPolicy | None = None):
    """Serving decode: one token for every sequence in the batch."""

    def decode_step(params: transformer.LM, tokens, caches, pos: int):
        with _placed(policy):
            return transformer.decode_step(params, cfg, tokens, caches, pos)

    return decode_step
