"""Model/config system: one frozen dataclass covers all 10 assigned families.

A copy of the JAX package's ``configs/base.py`` (the port imports nothing of
that package); ``tests/test_torch_models.py`` holds every field to the
original. The sharding and microbatching knobs (``fsdp``, ``remat``,
``grad_accum``) are kept as data and have no meaning on the port's serving
path.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    first_k_dense: int = 0  # leading dense layers (Moonlight style)
    d_ff_dense: int = 0  # ff of those dense layers
    router_z_weight: float = 1e-3


@dataclass(frozen=True)
class SSMCfg:  # Mamba2 (SSD)
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 128


@dataclass(frozen=True)
class RWKVCfg:  # RWKV-6 "Finch"
    head_size: int = 64
    chunk: int = 32  # chunked-parallel WKV length (§Perf H1); 0 = per-token scan


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | rwkv | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    # attention layout
    window: int = 0  # 0 = full causal; >0 = sliding-window size
    global_every: int = 0  # >0: every Nth layer is full/global (gemma3 5:1)
    qkv_bias: bool = False
    qk_norm: bool = False
    embed_scale: bool = False  # gemma family: h *= sqrt(d_model)
    rope_theta: float = 10_000.0
    mlp_act: str = "silu"  # silu | gelu | relu2 ; gated unless relu2
    tie_embeddings: bool = True
    # family extensions
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    rwkv: Optional[RWKVCfg] = None
    attn_every: int = 0  # hybrid: shared attention block every Nth layer
    encoder_layers: int = 0  # encdec: encoder depth
    n_frontend_tokens: int = 0  # vlm/audio stub: prefix embeddings count
    frontend_dim: int = 0  # stub embedding dim before projection
    # numerics / perf knobs (hillclimb levers)
    dtype: str = "bfloat16"
    remat: str = "full"  # none | full | dots
    attn_chunk: int = 1024  # flash-attention KV/Q chunk
    fsdp: bool = False  # shard params over dp too (ZeRO-3); GSPMD regathers
    grad_accum: int = 1  # microbatches per step (peak activations / N)
    # bookkeeping
    source: str = ""

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def layer_windows(self) -> list[int]:
        """Per-layer attention window (0 = full). gemma3: 5 local : 1 global."""
        ws = []
        for i in range(self.n_layers):
            if self.global_every and (i + 1) % self.global_every == 0:
                ws.append(0)  # global layer
            elif self.window:
                ws.append(self.window)
            else:
                ws.append(0)
        return ws


# ------------------------------------------------------------------ shapes

@dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524_288, 1),
}

# long_500k needs sub-quadratic attention / bounded state: run only for these
# (SSM / hybrid / SWA archs); skip + note for pure full-attention archs.
LONG_CONTEXT_ARCHS = {"zamba2-2.7b", "rwkv6-3b", "gemma3-4b", "mixtral-8x22b"}


def cells_for(arch: str) -> list[str]:
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if arch in LONG_CONTEXT_ARCHS:
        cells.append("long_500k")
    return cells
