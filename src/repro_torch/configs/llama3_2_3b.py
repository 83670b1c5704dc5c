"""Llama-3.2-3B [hf:meta-llama/Llama-3.2-1B; unverified] — small Llama-3.

28L d_model=3072 24H GQA(kv=8) head_dim=128 d_ff=8192 vocab=128256."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=128256,
    rope_theta=500_000.0,
    mlp_act="silu",
    tie_embeddings=True,
    grad_accum=4,
    source="hf:meta-llama/Llama-3.2-1B; unverified",
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=48, n_heads=6, n_kv_heads=2, head_dim=8, d_ff=96,
    vocab=512, attn_chunk=32,
)
