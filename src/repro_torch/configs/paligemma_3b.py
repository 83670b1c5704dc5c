"""PaliGemma-3B [arXiv:2407.07726; hf] — SigLIP frontend (STUB) + Gemma-2B LM.

18L d_model=2048 8H MQA(kv=1) head_dim=256 d_ff=16384 vocab=257216.
The vision tower is a stub: input_specs() supplies 256 precomputed patch
embeddings (SigLIP-so400m width 1152) which a linear connector projects to
d_model and prepends to the token sequence."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=257216,
    mlp_act="gelu",
    embed_scale=True,
    tie_embeddings=True,
    n_frontend_tokens=256,
    frontend_dim=1152,
    grad_accum=2,
    source="arXiv:2407.07726; hf",
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16, d_ff=128,
    vocab=512, n_frontend_tokens=8, frontend_dim=24, attn_chunk=32,
)
