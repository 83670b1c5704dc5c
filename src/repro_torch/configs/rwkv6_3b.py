"""RWKV-6 (Finch) 3B [arXiv:2404.05892; hf] — attention-free, data-dependent
decay. 32L d_model=2560 head_size=64 (40 heads) channel-mix ff=8960
vocab=65536. Constant state -> runs long_500k."""

from repro_torch.configs.base import ModelConfig, RWKVCfg

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="rwkv",
    n_layers=32,
    d_model=2560,
    n_heads=40,  # d_model / head_size
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab=65536,
    rwkv=RWKVCfg(head_size=64),
    mlp_act="relu2",  # rwkv channel-mix uses squared relu
    tie_embeddings=False,
    grad_accum=4,
    source="arXiv:2404.05892; hf",
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
    vocab=512, rwkv=RWKVCfg(head_size=16), attn_chunk=32,
)
