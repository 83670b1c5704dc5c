"""Zamba2-2.7B [arXiv:2411.15242; hf] — Mamba2 backbone + shared attention.

54 Mamba2 layers d_model=2560 (ssm_state=64), with ONE shared attention+MLP
block (32H MHA head_dim=80, d_ff=10240) invoked every 6th layer — the Zamba
weight-sharing trick. vocab=32000. SSM -> runs long_500k."""

from repro_torch.configs.base import ModelConfig, SSMCfg

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab=32000,
    ssm=SSMCfg(d_state=64, head_dim=64, expand=2, conv_width=4, chunk=128),
    attn_every=6,  # shared attention block after every 6th mamba layer
    mlp_act="gelu",
    tie_embeddings=False,
    grad_accum=2,
    source="arXiv:2411.15242; hf",
)

REDUCED = CONFIG.replace(
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
    vocab=512, ssm=SSMCfg(d_state=16, head_dim=16, expand=2, conv_width=4, chunk=16),
    attn_every=3, attn_chunk=32,
)
