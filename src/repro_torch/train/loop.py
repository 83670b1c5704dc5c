"""Training loop with the fault-tolerance features a long run needs.

The port of the JAX package's ``train/loop.py``:

  * checkpoint every N steps (atomic, manifest'd) + resume-from-latest;
    the resumed run equals an uninterrupted one bit for bit
  * deterministic data skip-ahead (no stream replay on restart)
  * straggler monitor: EWMA step-time outlier detection + pluggable callback
  * optional int8 gradient compression
  * simulated preemption hook for testing restart paths
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from repro_torch.common import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import leaves, tree_map
from repro_torch.models.registry import get_model
from repro_torch.models.transformer import LM
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import data as data_mod
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import make_train_step


@dataclass
class StragglerMonitor:
    """EWMA step-time watchdog. In production the callback triggers hot-spare
    swap / mesh re-slice; the detection logic is identical."""

    threshold: float = 2.5  # x EWMA -> straggler
    alpha: float = 0.1
    ewma: float | None = None
    events: list = field(default_factory=list)
    callback: Callable[[int, float, float], None] | None = None

    def observe(self, step: int, dt: float) -> bool:
        if self.ewma is None:
            self.ewma = dt
            return False
        is_straggler = dt > self.threshold * self.ewma
        if is_straggler:
            self.events.append((step, dt, self.ewma))
            if self.callback:
                self.callback(step, dt, self.ewma)
        else:  # only track healthy steps in the EWMA
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return is_straggler


@dataclass
class TrainResult:
    params: Any
    opt_state: Any
    step: int
    losses: list
    straggler_events: list
    resumed_from: int | None
    step_s: list = field(default_factory=list)  # host seconds of each step run


def batch_at(cfg: ModelConfig, dcfg: data_mod.DataConfig, step: int, device) -> dict:
    """The training batch at ``step``: tokens, and the stub prefix for
    vlm/encdec."""
    b = data_mod.lm_batch(dcfg, step, device)
    if cfg.family in ("vlm", "encdec"):
        b["frontend"] = data_mod.frontend_batch(
            dcfg, step, cfg.n_frontend_tokens, cfg.frontend_dim, device
        )
    return b


def _state(params: LM, opt_state: dict) -> dict:
    return {"params": params.stacked, "opt": opt_state}


def train(
    cfg: ModelConfig,
    *,
    steps: int,
    batch: int = 8,
    seq: int = 128,
    opt_cfg: AdamWConfig | None = None,
    ckpt_dir: str | None = None,
    ckpt_every: int = 50,
    seed: int = 0,
    grad_compress: bool = False,
    preempt_at: int | None = None,
    log_every: int = 10,
    params: LM | None = None,
    device: str | torch.device | None = None,
) -> TrainResult:
    """Single-process training loop on ``device`` (``None`` means the CUDA
    device; ``params``, when given, must live there and are trained in
    place). Weights are drawn from ``seed`` on the device."""
    dev = resolve_device(device)
    opt_cfg = opt_cfg or AdamWConfig(total_steps=steps, warmup_steps=max(steps // 20, 5))
    dcfg = data_mod.DataConfig(vocab=cfg.vocab, batch=batch, seq=seq, seed=seed)
    if params is None:
        params = get_model(cfg).init_params(torch.Generator(device=dev).manual_seed(seed), dev)
    elif params.embed["table"].device.type != dev.type:
        raise ValueError(f"params live on {params.embed['table'].device}, training runs on {dev}")
    opt_state = opt_mod.init(params.stacked)
    start_step = 0
    resumed_from = None

    if ckpt_dir:
        restored, at = ckpt_mod.restore_latest(ckpt_dir, _state(params, opt_state), "cpu")
        if restored is not None:
            with torch.no_grad():
                for (_, dst), (_, src) in zip(leaves(params.stacked), leaves(restored["params"])):
                    dst.copy_(src)
            opt_state = {
                "m": tree_map(lambda t: t.to(dev), restored["opt"]["m"]),
                "v": tree_map(lambda t: t.to(dev), restored["opt"]["v"]),
                "step": restored["opt"]["step"],
            }
            start_step = at
            resumed_from = at

    step_fn = make_train_step(cfg, opt_cfg, grad_compress=grad_compress)
    monitor = StragglerMonitor()
    losses: list[float] = []
    step_s: list[float] = []

    for step in range(start_step, steps):
        if preempt_at is not None and step == preempt_at:
            raise KeyboardInterrupt(f"simulated preemption at step {step}")
        t0 = time.perf_counter()
        b = batch_at(cfg, dcfg, step, dev)
        params, opt_state, metrics = step_fn(params, opt_state, b)
        loss = float(metrics["loss"])
        losses.append(loss)
        step_s.append(time.perf_counter() - t0)
        monitor.observe(step, step_s[-1])

        if ckpt_dir and (step + 1) % ckpt_every == 0:
            ckpt_mod.save(
                ckpt_dir, step + 1, _state(params, opt_state),
                meta={"loss": loss, "arch": cfg.name},
            )
        if log_every and step % log_every == 0:
            print(
                f"step {step:5d} loss {loss:.4f} "
                f"lr {float(metrics['lr']):.2e} gnorm {float(metrics['grad_norm']):.2f}"
            )

    if ckpt_dir:
        ckpt_mod.save(ckpt_dir, steps, _state(params, opt_state), meta={"arch": cfg.name})
    return TrainResult(
        params=params,
        opt_state=opt_state,
        step=steps,
        losses=losses,
        straggler_events=monitor.events,
        resumed_from=resumed_from,
        step_s=step_s,
    )
