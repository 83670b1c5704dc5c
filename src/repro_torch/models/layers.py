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
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import Rec, contiguous_grad, current_policy, hint

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
    return hint(F.embedding(tokens, p["table"]), "dp", None, None)


def lm_logits(p: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(B,S,D) -> (B,S,V) vocab-sharded logits, f32."""
    h32 = h.float()
    if cfg.tie_embeddings:
        out = h32 @ p["table"].float().T
    else:
        out = h32 @ p["head"].float()
    if isinstance(out, DTensor):  # the hint's backward may hand the product a sliced grad
        out = contiguous_grad(out)
    return hint(out, "dp", None, "tp")


def _ce_sum(p: Params, h: torch.Tensor, labels: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Summed CE of one chunk: h (B,C,D), labels (B,C)."""
    logits = lm_logits(p, h, cfg)  # (B,C,V) f32
    return torch.sum(_logsumexp(logits) - _pick(logits, labels))


def _pick(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logits[..., label]``, (B,C). On vocab-sharded DTensor logits each
    rank picks from its own vocab slice (zero where the label lies in
    another's) and the (B, C) partial sums are reduced: Megatron's
    vocab-parallel pick. DTensor's own gather would, in backward, build a
    zero grad of the global (B, C, V) shape on every rank."""
    if not isinstance(logits, DTensor):
        return torch.gather(logits, -1, labels[..., None].long())[..., 0]
    from torch.distributed.tensor import Partial

    mesh, places = logits.device_mesh, logits.placements
    # logits come hinted ("dp", None, "tp"): the labels' rows are the same shards
    lab = hint(labels, "dp", None)
    local = logits.to_local()
    coord, offset, chunk = mesh.get_coordinate(), 0, logits.shape[-1]
    for i, q in enumerate(places):  # the vocab's shards in the mesh's major order
        if isinstance(q, Shard) and q.dim == 2:
            chunk //= mesh.size(i)
            offset += coord[i] * chunk
    idx = lab.to_local().long() - offset
    inside = (idx >= 0) & (idx < local.shape[-1])
    picked = torch.gather(local, -1, torch.where(inside, idx, 0)[..., None])[..., 0]
    picked = torch.where(inside, picked, 0.0)
    out = [Partial() if isinstance(q, Shard) and q.dim == 2 else q for q in places]
    return hint(DTensor.from_local(picked, mesh, out, run_check=False), "dp", None)


def _logsumexp(x: torch.Tensor) -> torch.Tensor:
    """``torch.logsumexp(x, -1)``. A DTensor's ranks call it on their local
    logits where the vocab is whole there (off a model axis, or on a 1 x 1
    mesh) and wrap the (B, C) result; where mesh dims of size > 1 split
    the vocab, only the (B, C) max and sum are reduced across the slices
    (Megatron's vocab-parallel CE): DTensor would gather each chunk's
    logits whole for the max."""
    if not isinstance(x, DTensor):
        return torch.logsumexp(x, dim=-1)
    mesh = x.device_mesh
    vocab = [isinstance(q, Shard) and q.dim == x.ndim - 1 for q in x.placements]
    rows = [Replicate() if v else q for v, q in zip(vocab, x.placements)]  # (B, C) placements
    if not any(v and mesh.size(i) > 1 for i, v in enumerate(vocab)):
        return DTensor.from_local(torch.logsumexp(x.to_local(), dim=-1), mesh, rows,
                                  run_check=False)
    return _logsumexp_sharded(x, vocab, rows)


def _logsumexp_sharded(x: DTensor, vocab: list[bool], rows: list) -> DTensor:
    """The max is a constant shift (it cancels in the value and the grad),
    so it is taken without a graph."""
    from torch.distributed.tensor import Partial

    from repro_torch.models.common import _ReducePartial

    mesh = x.device_mesh

    def across(t: torch.Tensor, op: str) -> DTensor:
        part = [Partial(op) if v else q for v, q in zip(vocab, x.placements)]
        return DTensor.from_local(t, mesh, part, run_check=False)

    local = x.to_local()
    with torch.no_grad():
        m = across(torch.amax(local, dim=-1, keepdim=True), "max").redistribute(mesh, rows)
        m = m.to_local()
        m = torch.where(torch.abs(m) == float("inf"), 0.0, m)
    s = _ReducePartial.apply(across(torch.sum(torch.exp(local - m), dim=-1), "sum")).to_local()
    return DTensor.from_local(torch.log(s) + m[..., 0], mesh, rows, run_check=False)


def chunked_ce(
    p: Params, h: torch.Tensor, labels: torch.Tensor, cfg: ModelConfig, chunk: int = 512
) -> torch.Tensor:
    """Mean next-token CE without ever building the (B,S,V) logits.

    Sums over sequence chunks; when a graph is built each chunk is
    checkpointed, so backward recomputes its logits tile and live memory is
    O(B * chunk * V). h (B,T,D), labels (B,T). The reference pads T to a
    multiple of the chunk with weight-0 rows, which add exactly 0; the port
    runs the last chunk short instead."""
    b, t, _ = h.shape
    grad = torch.is_grad_enabled() and (h.requires_grad or any(w.requires_grad for w in p.values()))
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for s in range(0, t, chunk):
        args = (p, h[:, s : s + chunk], labels[:, s : s + chunk], cfg)
        if grad:
            total = total + checkpoint(_ce_sum, *args, use_reentrant=False,
                                       preserve_rng_state=False)
        else:
            total = total + _ce_sum(*args)
    # a 0-d divisor on the device: a Python one is a reciprocal product on CUDA
    return total / torch.full((), float(b * t), device=h.device)


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
    policy = current_policy()
    if policy is not None and hk % policy.axes_size("tp"):
        # kv heads that do not divide the model axis cannot keep a
        # tensor-parallel cut of (heads * dh) through the split into heads
        q, k, v = (hint(t, "dp", None, None) for t in (q, k, v))
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
    # the hint pins the grad of the merged heads to a layout the reshape's
    # backward can split back into heads (wo's backward shards it over tp)
    return hint(o.reshape(b, s, cfg.n_heads * cfg.head_dim), "dp", None, "tp") @ p["wo"]
