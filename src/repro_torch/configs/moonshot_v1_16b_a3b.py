"""Moonlight-16B-A3B [hf:moonshotai/Moonlight-16B-A3B; hf] — DeepSeek-style MoE.

48L d_model=2048 16H MHA(kv=16) head_dim=128, MoE 64 experts top-6 with
d_ff_expert=1408, first layer dense (d_ff=11264), vocab=163840."""

from repro_torch.configs.base import ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,  # per-expert ff
    vocab=163840,
    moe=MoECfg(
        n_experts=64,
        top_k=6,
        d_ff_expert=1408,
        first_k_dense=1,
        d_ff_dense=11264,
    ),
    mlp_act="silu",
    tie_embeddings=False,
    fsdp=True,
    grad_accum=4,
    source="hf:moonshotai/Moonlight-16B-A3B; hf",
)

REDUCED = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=64,
    vocab=512, attn_chunk=32,
    # capacity_factor high enough that reduced-config tests never drop tokens
    # (prefill-with-drops vs drop-free decode would otherwise diverge)
    moe=MoECfg(n_experts=8, top_k=2, d_ff_expert=64, first_k_dense=1,
               d_ff_dense=128, capacity_factor=8.0),
)
