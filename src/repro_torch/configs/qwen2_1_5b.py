"""Qwen2-1.5B [arXiv:2407.10671; hf] — dense GQA decoder with QKV bias.

28L d_model=1536 12H GQA(kv=2) head_dim=128 d_ff=8960 vocab=151936."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mlp_act="silu",
    tie_embeddings=True,
    grad_accum=2,
    source="arXiv:2407.10671; hf",
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=48, n_heads=6, n_kv_heads=2, head_dim=8, d_ff=96,
    vocab=512, attn_chunk=32,
)
