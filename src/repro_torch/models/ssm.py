"""Mamba2 (SSD) block: chunked state-space duality forward + O(1) decode.

The port of the JAX package's ``models/ssm.py``, in plain PyTorch (the
reference's is plain ``jnp``; no Pallas kernel lies here). It follows the
minimal-SSD formulation (Dao & Gu 2024): within a chunk the computation is
batched matmuls; across chunks a Python loop over S/chunk steps carries the
(B, H, N, P) f32 state (the reference's ``lax.scan``). One B/C group, as
Mamba2 uses at these sizes. Every einsum of three operands is written as two
explicit steps, so that their order and peak memory do not depend on how
``torch.einsum`` pairs its operands.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, SSMCfg
from repro_torch.models.common import Rec
from repro_torch.models.layers import Params, rms_norm


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), with no threshold (unlike
    ``F.softplus``, which returns x itself above 20)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def ssm_dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    ssm: SSMCfg = cfg.ssm
    d_in = ssm.expand * cfg.d_model
    n_heads = d_in // ssm.head_dim
    return d_in, n_heads, ssm.head_dim, ssm.d_state


def mamba_recs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    d_in, h, _p, n = ssm_dims(cfg)
    w = cfg.ssm.conv_width
    return {
        "w_z": Rec((d, d_in), (None, "tp")),
        "w_x": Rec((d, d_in), (None, "tp")),
        "w_b": Rec((d, n), (None, None)),
        "w_c": Rec((d, n), (None, None)),
        "w_dt": Rec((d, h), (None, None)),
        "conv": Rec((w, d_in + 2 * n), (None, None), "normal", 0.5),
        "a_log": Rec((h,), (), "zeros"),
        "dt_bias": Rec((h,), (), "zeros"),
        "d_skip": Rec((h,), (), "ones"),
        "norm": Rec((d_in,), (), "ones"),
        "w_out": Rec((d_in, d), ("tp", None)),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor, cache: torch.Tensor | None):
    """Depthwise causal conv. u (B,S,C), w (W,C). cache (B,W-1,C) for decode."""
    width = w.shape[0]
    if cache is None:
        pad = torch.zeros((u.shape[0], width - 1, u.shape[2]), dtype=u.dtype, device=u.device)
    else:
        pad = cache.to(u.dtype)
    full = torch.cat([pad, u], dim=1)  # (B, S+W-1, C)
    s = u.shape[1]
    out = sum(full[:, i : i + s, :] * w[i][None, None, :] for i in range(width))
    return F.silu(out), full[:, -(width - 1) :, :]


def _project(p: Params, x: torch.Tensor):
    """z, x, B, C projections and the step sizes dt (f32)."""
    dt = _softplus((x @ p["w_dt"]).float() + p["dt_bias"].float())
    return x @ p["w_z"], x @ p["w_x"], x @ p["w_b"], x @ p["w_c"], dt


def mamba_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, return_cache: bool = False):
    """Prefill forward. x (B,S,D) -> (B,S,D) [, decode cache].

    Sequences that don't divide the SSD chunk are FRONT-padded with zeros:
    a zero prefix leaves the (zero) state and every real token's output
    unchanged, so the final decode state stays exact."""
    s_real = x.shape[1]
    c = min(cfg.ssm.chunk, s_real)
    pad = (-s_real) % c
    if pad:
        x = F.pad(x, (0, 0, pad, 0))
    b, s, _ = x.shape
    d_in, h, hp, n = ssm_dims(cfg)
    nc = s // c

    z, xi, bb, cc, dt = _project(p, x)  # dt (B,S,H)
    conv_in = torch.cat([xi, bb, cc], dim=-1)
    # the decode conv cache, taken before the conv (a copy: the slice would hold conv_in)
    conv_tail = conv_in[:, -(cfg.ssm.conv_width - 1) :, :].clone()
    conv_out, _ = _causal_conv(conv_in, p["conv"], None)
    xi, bb, cc = torch.split(conv_out, [d_in, n, n], dim=-1)

    xh = xi.reshape(b, s, h, hp).float()
    a = -torch.exp(p["a_log"].float())  # (H,) negative
    la = dt * a[None, None, :]  # log decay per step (B,S,H), <= 0

    # chunk views
    xc = (xh * dt[..., None]).reshape(b, nc, c, h, hp)  # dt-weighted inputs
    bc = bb.reshape(b, nc, c, n).float()
    cc_ = cc.reshape(b, nc, c, n).float()
    cum = torch.cumsum(la.reshape(b, nc, c, h), dim=2)  # (B,nc,c,H) cumulative log decay

    # ---- intra-chunk (lower-triangular attention-like term)
    # M[t,s] = exp(cum_t - cum_s) for t >= s; above the diagonal exp can
    # overflow, and torch.where (not a multiply by the mask) drops it
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,t,s,H)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))
    m = torch.where(tri[None, None, :, :, None], torch.exp(diff), 0.0)
    cb = cc_ @ bc.transpose(-1, -2)  # (B,nc,t,s)
    wts = cb[..., None] * m  # (B,nc,t,s,H)
    del diff, m
    y_intra = torch.einsum("bntsh,bnshp->bnthp", wts, xc)
    del wts

    # ---- chunk summary states: S_n = sum_s exp(cum_end - cum_s) B_s (dt x)_s
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # (B,nc,c,H)
    xd = decay_to_end[..., None] * xc  # (B,nc,s,H,P)
    s_chunk = torch.einsum("bnsN,bnshp->bnhNp", bc, xd)

    # ---- inter-chunk scan: the state entering each chunk
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B,nc,H)
    state = torch.zeros((b, h, n, hp), dtype=torch.float32, device=x.device)
    prev = []
    for i in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, i, :, None, None] + s_chunk[:, i]
    prev_states = torch.stack(prev, dim=1)  # (B,nc,H,N,P)

    y_inter = torch.einsum("bntN,bnhNp->bnthp", cc_, prev_states) * torch.exp(cum)[..., None]

    y = (y_intra + y_inter).reshape(b, s, h, hp)
    y = y + xh * p["d_skip"].float()[None, None, :, None]
    y = y.reshape(b, s, d_in).to(x.dtype)

    y = rms_norm(y * F.silu(z), p["norm"])
    out = y @ p["w_out"]
    if pad:
        out = out[:, pad:]
    if return_cache:
        return out, {"state": state, "conv": conv_tail}
    return out


def mamba_decode(
    p: Params, x: torch.Tensor, cache: dict, cfg: ModelConfig
) -> tuple[torch.Tensor, dict]:
    """One-token step. x (B,1,D); cache {'state': (B,H,N,P), 'conv': (B,W-1,C)};
    returns the new cache (new tensors; the given one is not written)."""
    b = x.shape[0]
    d_in, h, hp, n = ssm_dims(cfg)

    z, xi, bb, cc, dt = _project(p, x)
    dt = dt[:, 0]  # (B,H)
    conv_in = torch.cat([xi, bb, cc], dim=-1)
    conv_out, new_conv = _causal_conv(conv_in, p["conv"], cache["conv"])
    xi, bb, cc = torch.split(conv_out[:, 0], [d_in, n, n], dim=-1)

    xh = xi.reshape(b, h, hp).float()
    a = -torch.exp(p["a_log"].float())
    dec = torch.exp(dt * a[None, :])  # (B,H)

    upd = bb.float()[:, None, :, None] * (dt[..., None] * xh)[:, :, None, :]  # (B,H,N,P)
    state = cache["state"] * dec[..., None, None] + upd
    y = (cc.float()[:, None, None, :] @ state)[:, :, 0]  # (B,H,P)
    y = y + xh * p["d_skip"].float()[None, :, None]
    y = y.reshape(b, 1, d_in).to(x.dtype)

    y = rms_norm(y * F.silu(z), p["norm"])
    return y @ p["w_out"], {"state": state, "conv": new_conv}


def mamba_cache_init(
    cfg: ModelConfig, batch: int, dtype: torch.dtype = torch.float32,
    device: str | torch.device | None = None,
) -> dict:
    d_in, h, hp, n = ssm_dims(cfg)
    w = cfg.ssm.conv_width
    return {
        "state": torch.zeros((batch, h, n, hp), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, w - 1, d_in + 2 * n), dtype=dtype, device=device),
    }
