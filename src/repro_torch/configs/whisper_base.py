"""Whisper-base [arXiv:2212.04356; unverified] — encoder-decoder; conv frontend
is a STUB (input_specs() supplies precomputed frame embeddings (B,1500,512)).

6L enc + 6L dec, d_model=512 8H MHA head_dim=64 d_ff=2048 vocab=51865.
Absolute (learned) positions, no RoPE. decode_32k exceeds Whisper's real
448-position decoder; honored as the backbone-shape contract (DESIGN.md)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,  # decoder layers
    encoder_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab=51865,
    rope_theta=0.0,  # 0 -> learned absolute positions
    mlp_act="gelu",
    tie_embeddings=True,
    n_frontend_tokens=1500,  # mel frames after the (stubbed) conv downsample
    frontend_dim=512,
    source="arXiv:2212.04356; unverified",
)

REDUCED = CONFIG.replace(
    n_layers=2, encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128, vocab=512, n_frontend_tokens=16, frontend_dim=64,
    attn_chunk=32,
)
