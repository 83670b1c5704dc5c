"""Attention: RoPE, chunked (flash-style) attention, cache decode.

The port of the JAX package's ``models/attention.py``, in plain PyTorch: the
reference's two ``jax.lax.scan``s over query and KV chunks become two Python
loops with the same online softmax, and ``cache_attention`` stays two
einsums. Neither is a Pallas kernel in the reference, so neither is a CUDA
kernel here (the port's ``flash_decode`` kernel is not on this path, as the
reference's decode does not call its own).

GQA layout convention: q (B,S,Hk,G,dh), kv (B,S,Hk,dh) — query head (k,g)
reads kv head k. Window w > 0 means each position attends to the previous w
positions (inclusive of itself); w == 0 means full causal (or full
bidirectional when causal=False). Masked logits take ``NEG`` (not -inf), so
fully masked and padded rows give the reference's values and never NaN.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

NEG = -1e30


def _scale(dh: int) -> float:
    return float(np.float32(1.0) / np.sqrt(np.float32(dh)))


# ------------------------------------------------------------------ RoPE


def rope_tables(
    positions: torch.Tensor, dh: int, theta: float
) -> tuple[torch.Tensor, torch.Tensor] | None:
    """RoPE's (cos, sin), each (..., S, dh/2), for ``positions`` (..., S);
    ``None`` when ``theta <= 0`` (absolute-position archs: whisper). Built
    once a forward or decode step and shared by every layer."""
    if theta <= 0:
        return None
    half = dh // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freq  # (..., S, half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, tables: tuple[torch.Tensor, torch.Tensor] | None) -> torch.Tensor:
    """Rotate the two halves of dh of x (..., S, H, dh) by ``rope_tables``."""
    if tables is None:
        return x
    cos, sin = tables
    half = x.shape[-1] // 2
    # insert singleton axes for every head dim between S and dh
    shape = cos.shape[:-1] + (1,) * (x.ndim - cos.ndim) + (half,)
    cos, sin = cos.reshape(shape), sin.reshape(shape)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over the two halves of dh. x: (..., S, H, dh),
    positions: (..., S)."""
    return apply_rope(x, rope_tables(positions, x.shape[-1], theta))


# ------------------------------------------------------------------ masks


def _chunk_mask(
    qpos: torch.Tensor, kpos: torch.Tensor, window: int, causal: bool
) -> torch.Tensor:
    """(Cq, Ck) validity mask for one (q-chunk, kv-chunk) pair."""
    d = qpos[:, None] - kpos[None, :]
    ok = d >= 0 if causal else torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if window > 0:  # window w: attend to positions (qpos-w, qpos]
        ok = ok & (d < window)
    return ok


# ------------------------------------------------------------------ flash


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window: int = 0,
    causal: bool = True,
    chunk: int = 1024,
    q_offset: int = 0,
) -> torch.Tensor:
    """Chunked online-softmax attention.

    q: (B, Sq, Hk, G, dh); k, v: (B, Sk, Hk, dh). Returns (B, Sq, Hk, G, dh).
    q_offset: absolute position of q[0] relative to k[0] (cross/enc: 0).
    """
    b, sq, hk, g, dh = q.shape
    sk = k.shape[1]
    cq = min(chunk, sq)
    ck = min(chunk, sk)
    # pad sequences up to chunk multiples; padded KV positions are masked off
    pq = (-sq) % cq
    pk = (-sk) % ck
    if pq:
        q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, pq))
    if pk:
        k = F.pad(k, (0, 0, 0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, 0, 0, pk))
    nq, nk = (sq + pq) // cq, (sk + pk) // ck
    scale = _scale(dh)
    dev = q.device
    ar_q = torch.arange(cq, dtype=torch.int64, device=dev)
    ar_k = torch.arange(ck, dtype=torch.int64, device=dev)

    outs = []
    for qi in range(nq):
        q_i = q[:, qi * cq : (qi + 1) * cq]
        qpos = q_offset + qi * cq + ar_q
        m = torch.full((b, hk, g, cq), NEG, dtype=torch.float32, device=dev)
        l = torch.zeros((b, hk, g, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hk, g, cq, dh), dtype=torch.float32, device=dev)
        for kj in range(nk):
            k_j = k[:, kj * ck : (kj + 1) * ck]
            v_j = v[:, kj * ck : (kj + 1) * ck]
            kpos = kj * ck + ar_k
            logits = torch.einsum("bqhgd,bchd->bhgqc", q_i.float(), k_j.float()) * scale
            mask = _chunk_mask(qpos, kpos, window, causal) & (kpos < sk)[None, :]
            logits = torch.where(mask, logits, NEG)
            m_new = torch.maximum(m, torch.amax(logits, dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhgqc,bchd->bhgqd", p, v_j.float())
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]  # (B,Hk,G,Cq,dh)
        outs.append(out.permute(0, 3, 1, 2, 4).to(q.dtype))
    return torch.cat(outs, dim=1)[:, :sq]


def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window: int = 0,
    causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    """O(S^2)-memory oracle for flash_attention (tests)."""
    sq, sk, dh = q.shape[1], k.shape[1], q.shape[-1]
    logits = torch.einsum("bqhgd,bchd->bhgqc", q.float(), k.float()) * _scale(dh)
    qpos = q_offset + torch.arange(sq, device=q.device)
    kpos = torch.arange(sk, device=q.device)
    logits = torch.where(_chunk_mask(qpos, kpos, window, causal), logits, NEG)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhgqc,bchd->bqhgd", w, v.float()).to(q.dtype)


# ------------------------------------------------------------------ decode


def cache_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    *,
    n_valid: int | torch.Tensor,
) -> torch.Tensor:
    """One-token attention against a cache.

    q: (B, Hk, G, dh); caches (B, Sc, Hk, dh); n_valid: int or (B,) count of
    valid cache slots. For ring (window) caches all slots are valid once warm
    and positions are encoded in RoPE, so ordering is irrelevant.
    Returns (B, Hk, G, dh).
    """
    sc = k_cache.shape[1]
    logits = torch.einsum("bhgd,bshd->bhgs", q.float(), k_cache.float()) * _scale(q.shape[-1])
    slots = torch.arange(sc, device=q.device)
    if isinstance(n_valid, torch.Tensor):
        valid = slots[None, :] < n_valid.reshape(-1, 1)
    else:
        valid = (slots < n_valid)[None, :]
    logits = torch.where(valid[:, None, None, :], logits, NEG)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhgs,bshd->bhgd", w, v_cache.float()).to(q.dtype)
