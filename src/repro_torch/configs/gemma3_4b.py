"""Gemma-3-4B [hf:google/gemma-3-1b-pt; unverified] — 5:1 local(SWA 1024):global.

34L d_model=2560 8H GQA(kv=4) head_dim=256 d_ff=10240 vocab=262144, QK-norm,
128k context. Sub-quadratic (mostly SWA) -> runs the long_500k cell."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab=262144,
    window=1024,
    global_every=6,  # layers 6,12,... are global; rest SWA-1024
    qk_norm=True,
    rope_theta=1_000_000.0,
    mlp_act="gelu",
    embed_scale=True,
    tie_embeddings=True,
    grad_accum=4,
    source="hf:google/gemma-3-1b-pt; unverified",
)

REDUCED = CONFIG.replace(
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab=512, window=64, attn_chunk=32,
)
