"""Mixtral-8x22B [arXiv:2401.04088; hf] — 8-expert top-2 MoE with SWA.

56L d_model=6144 48H GQA(kv=8) head_dim=128 d_ff=16384 vocab=32768.
Assignment specifies SWA (window 4096) -> bounded KV, runs long_500k."""

from repro_torch.configs.base import ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=32768,
    window=4096,
    rope_theta=1_000_000.0,
    moe=MoECfg(n_experts=8, top_k=2, d_ff_expert=16384),
    mlp_act="silu",
    tie_embeddings=False,
    fsdp=True,
    grad_accum=8,
    source="arXiv:2401.04088; hf",
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8, d_ff=128,
    vocab=512, window=64, attn_chunk=32,
    moe=MoECfg(n_experts=4, top_k=2, d_ff_expert=128, capacity_factor=8.0),
)
