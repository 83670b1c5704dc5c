"""Minitron-8B [arXiv:2407.14679; hf] — pruned Nemotron-4: squared-ReLU MLP.

32L d_model=4096 32H GQA(kv=8) head_dim=128 d_ff=16384 vocab=256000."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=256000,
    mlp_act="relu2",  # Nemotron squared-ReLU, ungated
    tie_embeddings=False,
    fsdp=True,
    grad_accum=4,
    source="arXiv:2407.14679; hf",
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8, d_ff=128,
    vocab=512, attn_chunk=32,
)
