"""Model assembly for all ten configs' families (dense, vlm, encdec, moe,
hybrid, rwkv): recs, modules, forward, prefill, decode.

The port of the JAX package's ``models/transformer.py``. The reference scans
over stacked layer params; the port holds one module per layer
(``LM.layers``), each parameter a view of the stacked tensor, so its names
are the reference's (``layers.3.attn.wq`` is ``params["layers"]["attn"]["wq"][3]``,
``layers.3.time.w_r`` is ``params["layers"]["time"]["w_r"][3]``) and
``models.interop.params_from_jax`` is a rename plus an unstack. Layers run in
a Python loop; every function takes ``cfg`` as the reference's do, and the
modules hold only weights.

Families: a moe model runs its ``dense_layers`` (``first_k_dense``) and then
its MoE ``layers`` as ``Block``s, summing the router's aux losses; hybrid
(Zamba2) runs Mamba2 layers and calls its one ``shared`` attention+MLP
``Block`` after every ``attn_every``-th; rwkv normalises the embeddings
(``ln_in``) and runs time-mix + channel-mix layers.

Decode caches, one entry a layer: ``{"k", "v"}``, (B, Sc, Hk, dh), for an
attention layer. Window layers keep a W-slot ring written at ``pos mod W``;
full-attention layers are padded at the end to ``cache_len``. encdec adds
``enc_out``, which decode re-projects through each layer's cross attention on
every step, as the reference does. hybrid: ``{"mamba": {"state", "conv"}}``,
plus ``"attn"`` on every ``attn_every``-th layer; rwkv: ``{"time": {"shift",
"state"}, "chan": {"shift"}}``. Decode writes the attention caches in place;
the SSM and RWKV states come back as new tensors in the returned caches.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn as nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
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


def block_recs(
    cfg: ModelConfig, *, d_ff: int | None = None, use_moe: bool = False, cross: bool = False
) -> dict:
    recs = {"ln1": norm_recs(cfg), "attn": attn_recs(cfg), "ln2": norm_recs(cfg)}
    if cross:
        recs["lnx"] = norm_recs(cfg)
        recs["xattn"] = attn_recs(cfg)
    recs["mlp"] = moe_mod.moe_recs(cfg) if use_moe else mlp_recs(cfg, d_ff)
    return recs


def model_recs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    base: dict[str, Any] = {"embed": embed_recs(cfg), "out_norm": norm_recs(cfg)}
    fam = cfg.family
    if fam in ("dense", "vlm"):
        base["layers"] = stack(block_recs(cfg), cfg.n_layers)
        if fam == "vlm":
            base["connector"] = Rec((cfg.frontend_dim, d), (None, None))
    elif fam == "moe":
        fkd = cfg.moe.first_k_dense
        if fkd:
            base["dense_layers"] = stack(block_recs(cfg, d_ff=cfg.moe.d_ff_dense), fkd)
        base["layers"] = stack(block_recs(cfg, use_moe=True), cfg.n_layers - fkd)
    elif fam == "hybrid":
        if cfg.n_layers % cfg.attn_every:
            raise ValueError(f"{cfg.name}: attn_every must divide n_layers")
        base["layers"] = stack(
            {"ln": norm_recs(cfg), "mamba": ssm_mod.mamba_recs(cfg)}, cfg.n_layers
        )
        base["shared"] = block_recs(cfg)  # ONE shared attn+MLP block (Zamba)
    elif fam == "rwkv":
        base["ln_in"] = norm_recs(cfg)
        base["layers"] = stack(
            {
                "ln1": norm_recs(cfg),
                "time": rwkv_mod.timemix_recs(cfg),
                "ln2": norm_recs(cfg),
                "chan": rwkv_mod.channelmix_recs(cfg),
            },
            cfg.n_layers,
        )
    elif fam == "encdec":
        base["enc_pos"] = Rec((cfg.n_frontend_tokens, d), (None, None), "embed")
        base["dec_pos"] = Rec((ENCDEC_POS_TABLE, d), (None, None), "embed")
        base["enc_norm"] = norm_recs(cfg)
        base["enc_layers"] = stack(block_recs(cfg), cfg.encoder_layers)
        base["layers"] = stack(block_recs(cfg, cross=True), cfg.n_layers)
        if cfg.frontend_dim != d:
            base["frontend_proj"] = Rec((cfg.frontend_dim, d), (None, None))
    else:
        raise ValueError(f"unknown family {fam}")
    return base


# ================================================================== modules


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _group(tree: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: _param(v) for k, v in tree.items()})


def _layer(stacked: dict, i: int) -> dict:
    """Layer i of a stacked tree: views, no copy."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in stacked.items()}


class Groups(nn.Module):
    """One layer's parameter groups, each an ``nn.ParameterDict`` under its
    name in the tree (a Mamba2 layer's ``ln`` and ``mamba``; an RWKV layer's
    ``ln1``, ``time``, ``ln2``, ``chan``)."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, sub in tree.items():
            setattr(self, name, _group(sub))


class Block(Groups):
    """Pre-norm transformer block: ln1 -> attn, [lnx -> xattn], ln2 -> mlp
    (dense, or MoE where the group holds a ``router``)."""

    def forward(
        self,
        h: torch.Tensor,
        cfg: ModelConfig,
        *,
        window: int,
        rot: tuple[torch.Tensor, torch.Tensor] | None,
        causal: bool = True,
        cross_ctx: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor], torch.Tensor | None]:
        """Returns (h, (k_roped, v), aux) — kv for prefill caches, aux the
        MoE router's loss (None for a dense MLP). ``rot``: the sequence's
        ``rope_tables``."""
        x = norm_apply(self.ln1, h)
        q, k, v = qkv_project(self.attn, x, cfg)
        q = apply_rope(q, rot)
        k = apply_rope(k, rot)
        o = flash_attention(q, k, v, window=window, causal=causal, chunk=cfg.attn_chunk)
        h = h + attn_out(self.attn, o, cfg)
        if cross_ctx is not None:
            h = h + self._cross(h, cross_ctx, cfg)
        out, aux = self._ffn(norm_apply(self.ln2, h), cfg)
        return h + out, (k, v), aux

    def _ffn(self, x: torch.Tensor, cfg: ModelConfig):
        if "router" in self.mlp:
            return moe_mod.moe_apply(self.mlp, x, cfg)
        return mlp_apply(self.mlp, x, cfg), None

    def _cross(self, h: torch.Tensor, ctx: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        cq, _, _ = qkv_project(self.xattn, norm_apply(self.lnx, h), cfg)
        _, ck, cv = qkv_project(self.xattn, ctx, cfg)
        co = flash_attention(cq, ck, cv, window=0, causal=False, chunk=cfg.attn_chunk)
        return attn_out(self.xattn, co, cfg)

    def decode(
        self,
        h: torch.Tensor,
        cfg: ModelConfig,
        cache: dict,
        pos: int,
        rot: tuple[torch.Tensor, torch.Tensor] | None,
        enc_out: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """One token, h (B,1,D), at position ``pos`` (``rot``: its
        ``rope_tables``) against this layer's cache (written in place)."""
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
        return h + self._ffn(norm_apply(self.ln2, h), cfg)[0]


class LM(nn.Module):
    """A model of the zoo: its parameters under the reference's names, one
    module a layer. Built from a tensor tree shaped as ``model_recs``."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__()
        self.cfg = cfg
        fam = cfg.family
        self.embed = _group(tree["embed"])
        self.out_norm = _group(tree["out_norm"])
        fkd = cfg.moe.first_k_dense if fam == "moe" else 0
        layer = Groups if fam in ("hybrid", "rwkv") else Block
        self.layers = nn.ModuleList(
            layer(_layer(tree["layers"], i)) for i in range(cfg.n_layers - fkd)
        )
        if fkd:
            self.dense_layers = nn.ModuleList(
                Block(_layer(tree["dense_layers"], i)) for i in range(fkd)
            )
        if fam == "hybrid":
            self.shared = Block(tree["shared"])
        if fam == "rwkv":
            self.ln_in = _group(tree["ln_in"])
        if fam == "vlm":
            self.connector = _param(tree["connector"])
        if fam == "encdec":
            self.enc_pos = _param(tree["enc_pos"])
            self.dec_pos = _param(tree["dec_pos"])
            self.enc_norm = _group(tree["enc_norm"])
            self.enc_layers = nn.ModuleList(
                Block(_layer(tree["enc_layers"], i)) for i in range(cfg.encoder_layers)
            )
            if "frontend_proj" in tree:
                self.frontend_proj = _param(tree["frontend_proj"])

    def blocks(self) -> list:
        """The attention layers in order (a moe model's dense ones first)."""
        return [*getattr(self, "dense_layers", []), *self.layers]


# ================================================================== forward


def _embed(params: LM, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    h = embed_lookup(params.embed, tokens.long(), cfg)
    if cfg.embed_scale:
        h = h * float(np.sqrt(np.float32(cfg.d_model)))
    return h


def _rot(cfg: ModelConfig, positions: torch.Tensor):
    """RoPE tables for ``positions`` (B, S); None for rwkv, which has no attention."""
    if cfg.family == "rwkv":
        return None
    return rope_tables(positions, cfg.head_dim, cfg.rope_theta)


def forward(params: LM, cfg: ModelConfig, batch: dict, collect: bool = False):
    """Full-sequence forward -> (hidden (B,S,D) post-norm, aux, raw_caches).

    batch: {"tokens": (B,S_text)} + {"frontend": (B,F,fd)} for vlm/encdec.
    aux: the MoE layers' router losses summed (0 for the other families).
    raw_caches (when collect), converted to decode caches by ``prefill``: the
    attention layers' roped (k, v) (encdec adds the encoder output); hybrid
    {"mamba": each layer's SSM cache, "kv": each shared-block call's (k, v)};
    rwkv each layer's {"time", "chan"} cache.
    """
    fam = cfg.family
    tokens = batch["tokens"]
    b = tokens.shape[0]
    h = _embed(params, cfg, tokens)
    if fam == "vlm":
        prefix = batch["frontend"].to(h.dtype) @ params.connector.to(h.dtype)
        h = torch.cat([prefix, h], dim=1)
    s = h.shape[1]
    rot = _rot(cfg, torch.arange(s, device=h.device)[None, :].expand(b, s))
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    raw: Any = None

    if fam == "hybrid":
        mcs, kvs = [], []
        for i, layer in enumerate(params.layers):
            out = ssm_mod.mamba_apply(
                layer.mamba, norm_apply(layer.ln, h), cfg, return_cache=collect
            )
            if collect:
                out, mc = out
                mcs.append(mc)
            h = h + out
            if (i + 1) % cfg.attn_every == 0:
                h, kv, _ = params.shared(h, cfg, window=0, rot=rot)
                if collect:
                    kvs.append(kv)
        raw = {"mamba": mcs, "kv": kvs}
    elif fam == "rwkv":
        h = norm_apply(params.ln_in, h)
        raw = []
        for layer in params.layers:
            t, tc = rwkv_mod.timemix_apply(layer.time, norm_apply(layer.ln1, h), cfg)
            h = h + t
            c, cc = rwkv_mod.channelmix_apply(layer.chan, norm_apply(layer.ln2, h), cfg)
            h = h + c
            if collect:
                raw.append({"time": tc, "chan": cc})
    else:  # dense, vlm, moe, encdec: attention blocks
        cross = None
        if fam == "encdec":
            enc_h = batch["frontend"].to(h.dtype)
            if hasattr(params, "frontend_proj"):
                enc_h = enc_h @ params.frontend_proj.to(enc_h.dtype)
            enc_h = enc_h + params.enc_pos[None].to(enc_h.dtype)
            f = enc_h.shape[1]
            enc_rot = rope_tables(torch.arange(f, device=h.device)[None, :].expand(b, f),
                                  cfg.head_dim, cfg.rope_theta)
            for block in params.enc_layers:
                enc_h, _, _ = block(enc_h, cfg, window=0, rot=enc_rot, causal=False)
            cross = norm_apply(params.enc_norm, enc_h)
            h = h + params.dec_pos[:s][None].to(h.dtype)
        kvs = []
        for block, window in zip(params.blocks(), cfg.layer_windows()):
            h, kv, a = block(h, cfg, window=window, rot=rot, cross_ctx=cross)
            if a is not None:
                aux = aux + a
            if collect:
                kvs.append(kv)
        raw = {"self": kvs, "enc_out": cross} if fam == "encdec" else kvs

    return norm_apply(params.out_norm, h), aux, (raw if collect else None)


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

    dev = resolve_device(device)
    fam = cfg.family
    if fam == "hybrid":
        caches = []
        for i in range(cfg.n_layers):
            c: dict[str, Any] = {"mamba": ssm_mod.mamba_cache_init(cfg, batch, dtype, dev)}
            if (i + 1) % cfg.attn_every == 0:
                c["attn"] = _attn_cache_init(cfg, batch, seq_len, 0, dtype, dev)
            caches.append(c)
        return caches
    if fam == "rwkv":
        return [rwkv_mod.rwkv_cache_init(cfg, batch, dtype, dev) for _ in range(cfg.n_layers)]
    if fam == "encdec":
        return {
            "self": [
                _attn_cache_init(cfg, batch, seq_len, 0, dtype, dev)
                for _ in range(cfg.n_layers)
            ],
            "enc_out": torch.zeros(
                (batch, cfg.n_frontend_tokens, cfg.d_model), dtype=dtype, device=dev
            ),
        }
    if fam not in ("dense", "vlm", "moe"):
        raise ValueError(fam)
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
    prompt length — pass prompt + max_new_tokens for generation). The SSM
    and RWKV states keep the forward's dtypes, as in the reference."""
    h, _aux, raw = forward(params, cfg, batch, collect=True)
    fam = cfg.family
    s_total = h.shape[1]
    cache_len = cache_len or s_total
    caches: Any
    if fam == "hybrid":
        caches = []
        for i, mc in enumerate(raw["mamba"]):
            c: dict[str, Any] = {"mamba": mc}
            gi, li = divmod(i, cfg.attn_every)
            if li == cfg.attn_every - 1:
                k, v = raw["kv"][gi]
                c["attn"] = _ring_slice(k, v, 0, cache_dtype, cache_len)
            caches.append(c)
    elif fam == "rwkv":
        caches = raw
    else:
        kvs = raw["self"] if fam == "encdec" else raw
        windows = [0] * cfg.n_layers if fam == "encdec" else cfg.layer_windows()
        layers = [
            _ring_slice(k, v, w, cache_dtype, cache_len) for (k, v), w in zip(kvs, windows)
        ]
        if fam == "encdec":
            caches = {"self": layers, "enc_out": raw["enc_out"].to(cache_dtype)}
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

    ``pos`` (an int) is the position of ``tokens``. Attention caches are
    written in place; hybrid and rwkv return their new SSM/RWKV states in a
    new list of caches (the given list is not changed)."""
    fam = cfg.family
    h = _embed(params, cfg, tokens)
    posb = torch.full((h.shape[0], 1), pos, dtype=torch.int64, device=h.device)
    rot = _rot(cfg, posb)
    if fam == "hybrid":
        new = []
        for layer, cache in zip(params.layers, caches):
            out, mc = ssm_mod.mamba_decode(layer.mamba, norm_apply(layer.ln, h), cache["mamba"], cfg)
            h = h + out
            c: dict[str, Any] = {"mamba": mc}
            if "attn" in cache:
                h = params.shared.decode(h, cfg, cache["attn"], pos, rot)
                c["attn"] = cache["attn"]
            new.append(c)
        caches = new
    elif fam == "rwkv":
        h = norm_apply(params.ln_in, h)
        new = []
        for layer, cache in zip(params.layers, caches):
            t, tc = rwkv_mod.timemix_apply(layer.time, norm_apply(layer.ln1, h), cfg, cache["time"])
            h = h + t
            c2, cc = rwkv_mod.channelmix_apply(
                layer.chan, norm_apply(layer.ln2, h), cfg, cache["chan"]
            )
            h = h + c2
            new.append({"time": tc, "chan": cc})
        caches = new
    else:
        enc_out = None
        layer_caches = caches
        if fam == "encdec":
            h = h + params.dec_pos[pos][None, None, :].to(h.dtype)
            enc_out, layer_caches = caches["enc_out"], caches["self"]
        for block, cache in zip(params.blocks(), layer_caches):
            h = block.decode(h, cfg, cache, pos, rot, enc_out)
    h = norm_apply(params.out_norm, h)
    return lm_logits(params.embed, h, cfg)[:, 0], caches
