"""Shared layers: norms, MLPs, embeddings/logits, attention block params.

The port of the JAX package's ``models/layers.py``. Weights keep the
reference's layout, (in, out), and are applied as ``x @ w``. ``p`` is any
mapping of name to tensor: a dict, or one of the model's
``nn.ParameterDict`` groups (``models/transformer.py``).
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import Rec

Params = Mapping[str, torch.Tensor]


# ------------------------------------------------------------------ norms


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """Population variance, as ``jnp.var`` (never torch's unbiased one)."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


# ------------------------------------------------------------------ MLP


def mlp_recs(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    f = d_ff or cfg.d_ff
    d = cfg.d_model
    if cfg.mlp_act == "relu2":  # ungated (Nemotron / RWKV channel mix)
        return {
            "w_in": Rec((d, f), (None, "tp")),
            "w_out": Rec((f, d), ("tp", None)),
        }
    return {
        "w_gate": Rec((d, f), (None, "tp")),
        "w_in": Rec((d, f), (None, "tp")),
        "w_out": Rec((f, d), ("tp", None)),
    }


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def mlp_apply(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.mlp_act == "relu2":
        h = torch.relu(x @ p["w_in"])
        return (h * h) @ p["w_out"]
    act = F.silu if cfg.mlp_act == "silu" else _gelu
    return (act(x @ p["w_gate"]) * (x @ p["w_in"])) @ p["w_out"]


# ------------------------------------------------------------------ embed


def embed_recs(cfg: ModelConfig) -> dict:
    v, d = cfg.vocab, cfg.d_model
    if cfg.tie_embeddings:
        return {"table": Rec((v, d), ("tp", None), "embed")}
    return {
        "table": Rec((v, d), (None, "tp"), "embed"),
        "head": Rec((d, v), (None, "tp")),
    }


def embed_lookup(p: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """tokens: int64 ids (the model's entry converts the reference's int32)."""
    return F.embedding(tokens, p["table"])


def lm_logits(p: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(B,S,D) -> (B,S,V) logits, f32."""
    h32 = h.float()
    if cfg.tie_embeddings:
        return h32 @ p["table"].float().T
    return h32 @ p["head"].float()


# ------------------------------------------------------------------ attention block


def attn_recs(cfg: ModelConfig) -> dict:
    d, hq, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    recs = {
        "wq": Rec((d, hq * dh), (None, "tp")),
        "wk": Rec((d, hk * dh), (None, "tp")),
        "wv": Rec((d, hk * dh), (None, "tp")),
        "wo": Rec((hq * dh, d), ("tp", None)),
    }
    if cfg.qkv_bias:
        recs["bq"] = Rec((hq * dh,), ("tp",), "zeros")
        recs["bk"] = Rec((hk * dh,), ("tp",), "zeros")
        recs["bv"] = Rec((hk * dh,), ("tp",), "zeros")
    if cfg.qk_norm:
        recs["q_norm"] = Rec((dh,), (), "ones")
        recs["k_norm"] = Rec((dh,), (), "ones")
    return recs


def qkv_project(
    p: Params, x: torch.Tensor, cfg: ModelConfig
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B,S,D) -> q (B,S,Hk,G,dh), k/v (B,S,Hk,dh) (pre-RoPE)."""
    b, s, _ = x.shape
    hq, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = hq // hk
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, hk, g, dh)
    k = k.reshape(b, s, hk, dh)
    v = v.reshape(b, s, hk, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    return q, k, v


def attn_out(p: Params, o: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """o (B,S,Hk,G,dh) -> (B,S,D)."""
    b, s = o.shape[:2]
    return o.reshape(b, s, cfg.n_heads * cfg.head_dim) @ p["wo"]
