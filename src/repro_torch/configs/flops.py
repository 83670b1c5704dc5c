"""Analytic MODEL_FLOPS per (arch x shape) — the roofline 'useful work' term.

Conventions (documented in EXPERIMENTS.md §Roofline):
  train  : 6 * N_active * tokens  + 3 * attention_fwd
  prefill: 2 * N_active * tokens  +     attention_fwd
  decode : 2 * N_active * B       +     decode_attention
Attention fwd = 4*B*S*W_eff*Hq*dh per attention layer, W_eff = S/2 for full
causal, min(window, S) for SWA. SSM/RWKV sequence-mix terms use their matmul
counts. N_active excludes embedding/LM-head params and inactive experts.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeCell


def param_counts(cfg: ModelConfig) -> dict:
    """Analytic parameter counts (matches models.registry within rounding)."""
    d, f, v, L = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers
    hq, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    embed = v * d if cfg.tie_embeddings else 2 * v * d
    attn = d * (hq * dh) * 2 + d * (hk * dh) * 2  # wq,wo + wk,wv

    def mlp_params(ff):
        return (2 if cfg.mlp_act == "relu2" else 3) * d * ff

    total_layers = 0.0
    active_layers = 0.0
    if cfg.family in ("dense", "vlm"):
        per = attn + mlp_params(f)
        total_layers = active_layers = L * per
    elif cfg.family == "moe":
        m = cfg.moe
        dense_l = m.first_k_dense
        per_dense = attn + mlp_params(m.d_ff_dense or f)
        per_moe_total = attn + m.n_experts * mlp_params(m.d_ff_expert) + d * m.n_experts
        per_moe_active = attn + m.top_k * mlp_params(m.d_ff_expert) + d * m.n_experts
        total_layers = dense_l * per_dense + (L - dense_l) * per_moe_total
        active_layers = dense_l * per_dense + (L - dense_l) * per_moe_active
    elif cfg.family == "hybrid":
        s = cfg.ssm
        d_in = s.expand * d
        h_ssm = d_in // s.head_dim
        n = s.d_state
        mamba = (
            2 * d * d_in  # w_z, w_x
            + 2 * d * n + d * h_ssm  # w_B, w_C, w_dt
            + d_in * d  # out proj
        )
        shared = attn + mlp_params(f)
        total_layers = active_layers = L * mamba + shared
    elif cfg.family == "rwkv":
        per = 5 * d * d + mlp_params(f)  # r,k,v,g,o + channel mix
        total_layers = active_layers = L * per
    elif cfg.family == "encdec":
        per = attn + mlp_params(f)
        per_dec = per + attn  # + cross attention
        total_layers = active_layers = cfg.encoder_layers * per + L * per_dec
        embed += cfg.n_frontend_tokens * d + 32768 * d  # pos tables
    return {
        "embed": float(embed),
        "total": float(embed + total_layers),
        "active": float(active_layers),
    }


def _attn_layers(cfg: ModelConfig) -> list[int]:
    """window per attention layer (0=full causal)."""
    if cfg.family == "hybrid":
        return [0] * (cfg.n_layers // cfg.attn_every)
    if cfg.family == "rwkv":
        return []
    if cfg.family == "encdec":
        return [0] * (cfg.encoder_layers + 2 * cfg.n_layers)  # self+cross approx
    return cfg.layer_windows()


def model_flops(cfg: ModelConfig, cell: ShapeCell) -> dict:
    b, s = cell.global_batch, cell.seq_len
    counts = param_counts(cfg)
    n_act = counts["active"]
    hq, dh = cfg.n_heads, cfg.head_dim

    def attn_fwd(seq_q, seq_kv):
        total = 0.0
        for w in _attn_layers(cfg):
            w_eff = (seq_kv / 2) if w == 0 else min(w, seq_kv)
            total += 4.0 * b * seq_q * w_eff * hq * dh
        return total

    seqmix = 0.0  # SSM / RWKV sequence-mix matmuls (fwd)
    if cfg.family == "hybrid":
        ss = cfg.ssm
        d_in = ss.expand * cfg.d_model
        seqmix = cfg.n_layers * 2.0 * b * s * ss.chunk * (d_in + ss.d_state * 2)
    if cfg.family == "rwkv":
        hd = cfg.rwkv.head_size
        seqmix = cfg.n_layers * 4.0 * b * s * cfg.d_model * hd

    if cell.kind == "train":
        mf = 6.0 * n_act * b * s + 3.0 * (attn_fwd(s, s) + seqmix)
    elif cell.kind == "prefill":
        mf = 2.0 * n_act * b * s + attn_fwd(s, s) + seqmix
    else:  # decode: one token against an s-long cache / state
        dec_attn = 0.0
        for w in _attn_layers(cfg):
            w_eff = s if w == 0 else min(w, s)
            dec_attn += 4.0 * b * w_eff * hq * dh
        dec_seqmix = seqmix / max(s, 1)
        mf = 2.0 * n_act * b + dec_attn + dec_seqmix
    return {"model_flops": mf, **counts}
