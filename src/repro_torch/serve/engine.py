"""Batched serving engine: pad-and-prefill, then lockstep greedy decode.

The port of the JAX package's ``serve/engine.py``. The serving analogue of
the paper's workload is embedding extraction (the embed-and-cluster
pipeline), but the engine also does standard generation: requests are
left-padded with token 0 to a common prompt length (the pads are not
masked, as in the reference), prefilled once with an f32 cache of
``prompt + budget`` slots, decoded in lockstep with per-sequence done flags
(EOS or budget), and results are detached as they finish. Each step's argmax
is read on the host. ``stats`` holds the host seconds of the last
``generate``'s prefill and of each decode step.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.common import l2_normalize, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


@dataclass
class Request:
    prompt: list[int]
    max_new_tokens: int = 32
    eos_id: int | None = None


@dataclass
class Completion:
    prompt: list[int]
    tokens: list[int]
    steps: int


@dataclass
class ServeEngine:
    """``params``: the model (``Model.init_params`` or ``params_from_jax``),
    moved to ``device`` (``None`` means the CUDA device)."""

    cfg: ModelConfig
    params: transformer.LM
    device: str | torch.device | None = None
    stats: dict = field(init=False, default_factory=dict)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.params = self.params.to(self.device)

    def _frontend(self, b: int) -> dict:
        cfg = self.cfg
        if cfg.family not in ("vlm", "encdec"):
            return {}
        shape = (b, cfg.n_frontend_tokens, cfg.frontend_dim)
        return {"frontend": torch.zeros(shape, dtype=torch.float32, device=self.device)}

    @torch.no_grad()
    def generate(self, requests: list[Request]) -> list[Completion]:
        """Serve a batch of requests to completion (greedy decoding)."""
        cfg = self.cfg
        b = len(requests)
        plen = max(len(r.prompt) for r in requests)
        budget = max(r.max_new_tokens for r in requests)
        toks = np.zeros((b, plen), np.int32)
        for i, r in enumerate(requests):
            toks[i, plen - len(r.prompt) :] = r.prompt

        t = time.perf_counter()
        batch = {"tokens": torch.from_numpy(toks).to(self.device), **self._frontend(b)}
        logits, caches, pos = transformer.prefill(
            self.params, cfg, batch, torch.float32, cache_len=plen + budget
        )
        next_tok = logits.argmax(-1).cpu().numpy().astype(np.int32)
        self.stats = {"prefill_s": time.perf_counter() - t, "decode_s": []}
        done = np.zeros(b, bool)
        outs: list[list[int]] = [[] for _ in range(b)]

        for _ in range(budget):
            for i, r in enumerate(requests):
                if done[i]:
                    continue
                outs[i].append(int(next_tok[i]))
                if (
                    (r.eos_id is not None and next_tok[i] == r.eos_id)
                    or len(outs[i]) >= r.max_new_tokens
                ):
                    done[i] = True
            if done.all():
                break
            t = time.perf_counter()
            step = torch.from_numpy(next_tok).to(self.device)[:, None]
            logits, caches = transformer.decode_step(self.params, cfg, step, caches, pos)
            pos += 1
            next_tok = logits.argmax(-1).cpu().numpy().astype(np.int32)
            self.stats["decode_s"].append(time.perf_counter() - t)

        return [
            Completion(prompt=r.prompt, tokens=outs[i], steps=len(outs[i]))
            for i, r in enumerate(requests)
        ]

    @torch.no_grad()
    def embed(self, batch: dict) -> torch.Tensor:
        """Mean-pooled final hidden states (over prefix and text) — the
        clustering front-end. (B, D) f32 on the engine's device."""
        batch = {k: v.to(self.device) for k, v in batch.items()}
        h, _, _ = transformer.forward(self.params, self.cfg, batch)
        return torch.mean(h.float(), dim=1)


def embed_documents(engine: ServeEngine, tokens: np.ndarray, batch: int = 64) -> torch.Tensor:
    """The embed-and-cluster front-end: token rows (n, seq) through
    ``engine.embed`` in batches of ``batch`` (a zero frontend for vlm and
    encdec), unit-normed. (n, d_model) f32 on the engine's device."""
    cfg = engine.cfg
    parts = []
    for i in range(0, tokens.shape[0], batch):
        b = {"tokens": torch.from_numpy(tokens[i : i + batch])}
        if cfg.family in ("vlm", "encdec"):
            shape = (b["tokens"].shape[0], cfg.n_frontend_tokens, cfg.frontend_dim)
            b["frontend"] = torch.zeros(shape)
        parts.append(engine.embed(b))
    return l2_normalize(torch.cat(parts))
