"""Model assembly for the dense, vlm and encdec families: recs, modules,
forward, prefill, decode.

The port of the JAX package's ``models/transformer.py``. The reference scans
over stacked layer params; the port holds one ``Block`` module per layer
(``LM.layers``), each parameter a view of the stacked tensor, so its names
are the reference's (``layers.3.attn.wq`` is ``params["layers"]["attn"]["wq"][3]``)
and ``models.interop.params_from_jax`` is a rename plus an unstack. Layers
run in a Python loop, prefill collects each layer's roped K/V, and decode
writes one token into each layer's cache in place.

Decode caches: a list of ``{"k", "v"}`` per layer, (B, Sc, Hk, dh). Window
layers keep a W-slot ring written at ``pos mod W``; full-attention layers
are padded at the end to ``cache_len``. encdec adds ``enc_out``, which decode
re-projects through each layer's cross attention on every step, as the
reference does. The moe, hybrid and rwkv families are not ported yet.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn as nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import apply_rope, cache_attention, flash_attention, rope_tables
from repro_torch.models.common import Rec, stack
from repro_torch.models.layers import (
    attn_out,
    attn_recs,
    embed_lookup,
    embed_recs,
    layer_norm,
    lm_logits,
    mlp_apply,
    mlp_recs,
    qkv_project,
    rms_norm,
)

ENCDEC_POS_TABLE = 32_768  # whisper learned-position table (backbone contract)
PORTED_FAMILIES = ("dense", "vlm", "encdec")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            "(ROADMAP queue 1 item 12b: models/moe.py, ssm.py, rwkv.py)"
        )


# ================================================================== norms


def norm_recs(cfg: ModelConfig) -> dict:
    if cfg.family == "encdec":  # whisper uses LN with bias
        return {
            "scale": Rec((cfg.d_model,), (), "ones"),
            "bias": Rec((cfg.d_model,), (), "zeros"),
        }
    return {"scale": Rec((cfg.d_model,), (), "ones")}


def norm_apply(p, x: torch.Tensor) -> torch.Tensor:
    if "bias" in p:
        return layer_norm(x, p["scale"], p["bias"])
    return rms_norm(x, p["scale"])


# ================================================================== recs


def block_recs(cfg: ModelConfig, *, cross: bool = False) -> dict:
    recs = {"ln1": norm_recs(cfg), "attn": attn_recs(cfg), "ln2": norm_recs(cfg)}
    if cross:
        recs["lnx"] = norm_recs(cfg)
        recs["xattn"] = attn_recs(cfg)
    recs["mlp"] = mlp_recs(cfg)
    return recs


def model_recs(cfg: ModelConfig) -> dict:
    _check_family(cfg)
    d = cfg.d_model
    base: dict[str, Any] = {"embed": embed_recs(cfg), "out_norm": norm_recs(cfg)}
    if cfg.family in ("dense", "vlm"):
        base["layers"] = stack(block_recs(cfg), cfg.n_layers)
        if cfg.family == "vlm":
            base["connector"] = Rec((cfg.frontend_dim, d), (None, None))
    else:  # encdec
        base["enc_pos"] = Rec((cfg.n_frontend_tokens, d), (None, None), "embed")
        base["dec_pos"] = Rec((ENCDEC_POS_TABLE, d), (None, None), "embed")
        base["enc_norm"] = norm_recs(cfg)
        base["enc_layers"] = stack(block_recs(cfg), cfg.encoder_layers)
        base["layers"] = stack(block_recs(cfg, cross=True), cfg.n_layers)
        if cfg.frontend_dim != d:
            base["frontend_proj"] = Rec((cfg.frontend_dim, d), (None, None))
    return base


# ================================================================== modules


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _group(tree: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: _param(v) for k, v in tree.items()})


def _layer(stacked: dict, i: int) -> dict:
    """Layer i of a stacked tree: views, no copy."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in stacked.items()}


class Block(nn.Module):
    """Pre-norm transformer block: ln1 -> attn, [lnx -> xattn], ln2 -> mlp."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__()
        self.cfg = cfg
        for name in ("ln1", "attn", "ln2", "lnx", "xattn", "mlp"):
            if name in tree:
                setattr(self, name, _group(tree[name]))

    def forward(
        self,
        h: torch.Tensor,
        *,
        window: int,
        rot: tuple[torch.Tensor, torch.Tensor] | None,
        causal: bool = True,
        cross_ctx: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
        """Returns (h, (k_roped, v)) — kv for prefill caches. ``rot``: the
        sequence's ``rope_tables``."""
        cfg = self.cfg
        x = norm_apply(self.ln1, h)
        q, k, v = qkv_project(self.attn, x, cfg)
        q = apply_rope(q, rot)
        k = apply_rope(k, rot)
        o = flash_attention(q, k, v, window=window, causal=causal, chunk=cfg.attn_chunk)
        h = h + attn_out(self.attn, o, cfg)
        if cross_ctx is not None:
            h = h + self._cross(h, cross_ctx)
        return h + mlp_apply(self.mlp, norm_apply(self.ln2, h), cfg), (k, v)

    def _cross(self, h: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        cq, _, _ = qkv_project(self.xattn, norm_apply(self.lnx, h), cfg)
        _, ck, cv = qkv_project(self.xattn, ctx, cfg)
        co = flash_attention(cq, ck, cv, window=0, causal=False, chunk=cfg.attn_chunk)
        return attn_out(self.xattn, co, cfg)

    def decode(
        self,
        h: torch.Tensor,
        cache: dict,
        pos: int,
        rot: tuple[torch.Tensor, torch.Tensor] | None,
        enc_out: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """One token, h (B,1,D), at position ``pos`` (``rot``: its
        ``rope_tables``) against this layer's cache (written in place)."""
        cfg = self.cfg
        q, k, v = qkv_project(self.attn, norm_apply(self.ln1, h), cfg)
        q = apply_rope(q, rot)
        k = apply_rope(k, rot)
        _cache_write(cache, k, v, pos)
        n_valid = min(pos + 1, cache["k"].shape[1])
        o = cache_attention(q[:, 0], cache["k"], cache["v"], n_valid=n_valid)
        h = h + attn_out(self.attn, o[:, None], cfg)
        if enc_out is not None:
            xq, _, _ = qkv_project(self.xattn, norm_apply(self.lnx, h), cfg)
            _, ek, ev = qkv_project(self.xattn, enc_out, cfg)
            o = cache_attention(xq[:, 0], ek, ev, n_valid=enc_out.shape[1])
            h = h + attn_out(self.xattn, o[:, None], cfg)
        return h + mlp_apply(self.mlp, norm_apply(self.ln2, h), cfg)


class LM(nn.Module):
    """A model of the zoo: its parameters under the reference's names, one
    ``Block`` a layer. Built from a tensor tree shaped as ``model_recs``."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        self.embed = _group(tree["embed"])
        self.out_norm = _group(tree["out_norm"])
        self.layers = nn.ModuleList(
            Block(cfg, _layer(tree["layers"], i)) for i in range(cfg.n_layers)
        )
        if cfg.family == "vlm":
            self.connector = _param(tree["connector"])
        if cfg.family == "encdec":
            self.enc_pos = _param(tree["enc_pos"])
            self.dec_pos = _param(tree["dec_pos"])
            self.enc_norm = _group(tree["enc_norm"])
            self.enc_layers = nn.ModuleList(
                Block(cfg, _layer(tree["enc_layers"], i)) for i in range(cfg.encoder_layers)
            )
            if "frontend_proj" in tree:
                self.frontend_proj = _param(tree["frontend_proj"])


# ================================================================== forward


def _embed(params: LM, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    h = embed_lookup(params.embed, tokens.long(), cfg)
    if cfg.embed_scale:
        h = h * float(np.sqrt(np.float32(cfg.d_model)))
    return h


def forward(params: LM, cfg: ModelConfig, batch: dict, collect: bool = False):
    """Full-sequence forward -> (hidden (B,S,D) post-norm, aux, raw_caches).

    batch: {"tokens": (B,S_text)} + {"frontend": (B,F,fd)} for vlm/encdec.
    raw_caches (when collect): per-layer roped (k, v), converted to decode
    caches by ``prefill``; encdec adds the encoder output.
    """
    tokens = batch["tokens"]
    b = tokens.shape[0]
    h = _embed(params, cfg, tokens)
    if cfg.family == "vlm":
        prefix = batch["frontend"].to(h.dtype) @ params.connector.to(h.dtype)
        h = torch.cat([prefix, h], dim=1)
    s = h.shape[1]
    rot = rope_tables(torch.arange(s, device=h.device)[None, :].expand(b, s),
                      cfg.head_dim, cfg.rope_theta)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    kvs = []
    cross = None

    if cfg.family == "encdec":
        enc_h = batch["frontend"].to(h.dtype)
        if hasattr(params, "frontend_proj"):
            enc_h = enc_h @ params.frontend_proj.to(enc_h.dtype)
        enc_h = enc_h + params.enc_pos[None].to(enc_h.dtype)
        f = enc_h.shape[1]
        enc_rot = rope_tables(torch.arange(f, device=h.device)[None, :].expand(b, f),
                              cfg.head_dim, cfg.rope_theta)
        for block in params.enc_layers:
            enc_h, _ = block(enc_h, window=0, rot=enc_rot, causal=False)
        cross = norm_apply(params.enc_norm, enc_h)
        h = h + params.dec_pos[:s][None].to(h.dtype)

    for block, window in zip(params.layers, cfg.layer_windows()):
        h, kv = block(h, window=window, rot=rot, cross_ctx=cross)
        if collect:
            kvs.append(kv)

    raw: Any = None
    if collect:
        raw = {"self": kvs, "enc_out": cross} if cfg.family == "encdec" else kvs
    return norm_apply(params.out_norm, h), aux, raw


# ================================================================== caches


def _attn_cache_init(cfg, batch, seq_len, window, dtype, device):
    sc = min(window, seq_len) if window > 0 else seq_len
    shape = (batch, sc, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def init_cache(
    cfg: ModelConfig,
    batch: int,
    seq_len: int,
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device | None = None,
):
    """Per-layer decode cache (zeros) on ``device``."""
    from repro_torch.common import resolve_device

    _check_family(cfg)
    dev = resolve_device(device)
    if cfg.family == "encdec":
        return {
            "self": [
                _attn_cache_init(cfg, batch, seq_len, 0, dtype, dev)
                for _ in range(cfg.n_layers)
            ],
            "enc_out": torch.zeros(
                (batch, cfg.n_frontend_tokens, cfg.d_model), dtype=dtype, device=dev
            ),
        }
    return [_attn_cache_init(cfg, batch, seq_len, w, dtype, dev) for w in cfg.layer_windows()]


# ================================================================== prefill


def _ring_slice(
    k: torch.Tensor, v: torch.Tensor, window: int, dtype: torch.dtype, cache_len: int
) -> dict:
    """Full-seq roped K/V (B,S,hk,dh) -> decode cache.

    Window layers keep a W-slot ring (requires W | S for slot alignment);
    full-attention layers are padded at the END to ``cache_len`` capacity so
    decode can append (padding is masked by n_valid)."""
    s = k.shape[1]
    pad = 0
    if window > 0:
        cap = min(window, cache_len)
        if s >= cap:
            if s % cap:
                raise ValueError(f"ring alignment needs cap | S (cap {cap}, S {s})")
            k, v = k[:, -cap:], v[:, -cap:]
        else:  # short prompt: positions p < cap sit at slot p
            pad = cap - s
    elif cache_len > s:
        pad = cache_len - s
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    return {"k": k.to(dtype).contiguous(), "v": v.to(dtype).contiguous()}


@torch.no_grad()
def prefill(
    params: LM,
    cfg: ModelConfig,
    batch: dict,
    cache_dtype: torch.dtype = torch.bfloat16,
    cache_len: int | None = None,
):
    """Process the prompt -> (last-token logits (B,V), decode caches, next_pos).

    cache_len: total decode capacity for full-attention caches (default: the
    prompt length — pass prompt + max_new_tokens for generation)."""
    h, _aux, raw = forward(params, cfg, batch, collect=True)
    s_total = h.shape[1]
    cache_len = cache_len or s_total
    kvs = raw["self"] if cfg.family == "encdec" else raw
    windows = [0] * cfg.n_layers if cfg.family == "encdec" else cfg.layer_windows()
    layers = [
        _ring_slice(k, v, w, cache_dtype, cache_len) for (k, v), w in zip(kvs, windows)
    ]
    if cfg.family == "encdec":
        caches: Any = {"self": layers, "enc_out": raw["enc_out"].to(cache_dtype)}
    else:
        caches = layers
    logits = lm_logits(params.embed, h[:, -1:], cfg)[:, 0]
    return logits, caches, s_total


# ================================================================== decode


def _cache_write(cache: dict, k: torch.Tensor, v: torch.Tensor, pos: int) -> None:
    """Write one token's k/v (B,1,hk,dh) at ring slot ``pos mod Sc``, in place."""
    slot = pos % cache["k"].shape[1]
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)


@torch.no_grad()
def decode_step(params: LM, cfg: ModelConfig, tokens: torch.Tensor, caches, pos: int):
    """One decoding step. tokens (B,1) -> (logits (B,V), caches).

    ``pos`` (an int) is the position of ``tokens``; the caches are written in
    place and returned."""
    h = _embed(params, cfg, tokens)
    enc_out = None
    layer_caches = caches
    if cfg.family == "encdec":
        h = h + params.dec_pos[pos][None, None, :].to(h.dtype)
        enc_out, layer_caches = caches["enc_out"], caches["self"]
    posb = torch.full((h.shape[0], 1), pos, dtype=torch.int64, device=h.device)
    rot = rope_tables(posb, cfg.head_dim, cfg.rope_theta)
    for block, cache in zip(params.layers, layer_caches):
        h = block.decode(h, cache, pos, rot, enc_out)
    h = norm_apply(params.out_norm, h)
    return lm_logits(params.embed, h, cfg)[:, 0], caches
