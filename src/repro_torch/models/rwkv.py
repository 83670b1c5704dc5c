"""RWKV-6 (Finch) block: time-mix with data-dependent decay + channel-mix.

The port of the JAX package's ``models/rwkv.py``, in plain PyTorch (the
reference's is plain ``jnp``; no Pallas kernel lies here). Token-shift
interpolation, per-channel data-dependent decay w_t = exp(-exp(base +
LoRA(x))), the WKV linear recurrence with bonus u, squared-ReLU channel mix.
Two WKV routes, as in the reference: the chunked-parallel form for a prefill
(``cfg.rwkv.chunk`` and S > 1; the prompt front-padded to a chunk multiple
with identity tokens), and the per-token scan for decode. Both carry the
(B, H, hd, hd) f32 state; the reference's ``lax.scan``s become Python loops
over tokens or chunks. Every einsum of three operands is written as two
explicit steps, so that their order and peak memory do not depend on how
``torch.einsum`` pairs its operands.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import Rec
from repro_torch.models.layers import Params

LORA = 64


def rwkv_dims(cfg: ModelConfig) -> tuple[int, int]:
    hd = cfg.rwkv.head_size
    return cfg.d_model // hd, hd


def timemix_recs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    h, hd = rwkv_dims(cfg)
    lora = min(LORA, d)
    return {
        "mu_r": Rec((d,), (), "zeros"),
        "mu_k": Rec((d,), (), "zeros"),
        "mu_v": Rec((d,), (), "zeros"),
        "mu_w": Rec((d,), (), "zeros"),
        "mu_g": Rec((d,), (), "zeros"),
        "w_r": Rec((d, d), (None, "tp")),
        "w_k": Rec((d, d), (None, "tp")),
        "w_v": Rec((d, d), (None, "tp")),
        "w_g": Rec((d, d), (None, "tp")),
        "w_o": Rec((d, d), ("tp", None)),
        "decay_base": Rec((d,), (), "zeros"),
        "decay_lora_a": Rec((d, lora), (None, None), "normal", 0.1),
        "decay_lora_b": Rec((lora, d), (None, None), "zeros"),
        "bonus_u": Rec((h, hd), (), "zeros"),
        "ln_x": Rec((d,), (), "ones"),  # group-norm-ish post scale
    }


def channelmix_recs(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": Rec((d,), (), "zeros"),
        "w_in": Rec((d, f), (None, "tp")),
        "w_out": Rec((f, d), ("tp", None)),
    }


def _shift(x: torch.Tensor, last: torch.Tensor | None) -> torch.Tensor:
    """x_{t-1} stream. x (B,S,D); last (B,1,D) carries across decode steps."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last, x[:, :-1]], dim=1)


def _mix(x, xp, mu):
    return x + (xp - x) * mu  # lerp(x, x_prev, mu)


def _wkv_scan(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
    state0: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """WKV6 recurrence. r,k,v,w: (B,S,H,hd) f32; u: (H,hd); state (B,H,hd,hd).

    y_t = r_t^T (state + (u*k_t) outer v_t);  state' = diag(w_t) state + k_t outer v_t
    """
    state = state0
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]  # (B,H,K,V)
        y = torch.einsum("bhk,bhkv->bhv", r[:, t], state + u[None, :, :, None] * kv)
        state = state * w[:, t, :, :, None] + kv
        ys.append(y)
    return torch.stack(ys, dim=1), state  # (B,S,H,hd), final state


def _wkv_chunked(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lw: torch.Tensor, u: torch.Tensor,
    state0: torch.Tensor, chunk: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked-parallel WKV6, exact (the SSD trick for Finch).

    Within a chunk of C tokens the output splits into three terms whose
    exponents are all <= 0:

      y_i = (r_i . exp(ex_i)) S0                         [inter: carry readout]
          + sum_{j<i} <r_i, k_j . exp(ex_i - cum_j)> v_j [intra]
          + <r_i . u, k_i> v_i                           [diagonal bonus]
      S' = exp(cum_last) . S0 + sum_j (k_j . exp(cum_last - cum_j))^T v_j

    where lw = log w <= 0 (exactly -exp(dd)), cum the inclusive cumsum of lw
    within the chunk, ex the exclusive one. Above the diagonal exp(ex_i -
    cum_j) can overflow: it is selected away by ``torch.where`` (a multiply
    by the mask would give inf * 0 = NaN).

    r,k,v,lw: (B,S,H,hd) f32; u (H,hd); state0 (B,H,hd,hd). S % chunk == 0.
    """
    b, s, h, hd = r.shape
    c = chunk
    nc = s // c

    def chunks(x):  # (B,S,H,hd) -> (B,nc,H,C,hd)
        return x.reshape(b, nc, c, h, hd).permute(0, 1, 3, 2, 4)

    rc, kc, vc, lwc = chunks(r), chunks(k), chunks(v), chunks(lw)
    cum = torch.cumsum(lwc, dim=3)  # inclusive
    ex = cum - lwc  # exclusive
    last = cum[:, :, :, -1:, :]  # (B,nc,H,1,hd)

    r_ex = rc * torch.exp(ex)  # exponent <= 0: safe
    # intra scores A[i,j] = sum_k r_i[k] k_j[k] exp(ex_i[k] - cum_j[k]), j < i
    diff = ex[..., :, None, :] - cum[..., None, :, :]  # (B,nc,H,C,C,hd)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device), -1)
    dmat = torch.where(tri[:, :, None], torch.exp(diff), 0.0)
    kd = dmat * kc[..., None, :, :]  # (B,nc,H,i,j,hd): k_j exp(ex_i - cum_j)
    a = torch.einsum("bnhik,bnhijk->bnhij", rc, kd)
    del diff, dmat, kd
    diag = torch.sum(rc * u[None, None, :, None, :] * kc, dim=-1)  # (B,nc,H,C)
    a = a + diag[..., None] * torch.eye(c, dtype=a.dtype, device=a.device)
    y_intra = a @ vc  # (B,nc,H,C,hd)

    k_dec = kc * torch.exp(last - cum)  # exponent <= 0
    s_chunk = k_dec.transpose(-1, -2) @ vc  # (B,nc,H,K,V)
    decay = torch.exp(last[:, :, :, 0, :])  # (B,nc,H,hd)

    state = state0
    ys = []
    for n in range(nc):
        ys.append(y_intra[:, n] + r_ex[:, n] @ state)
        state = state * decay[:, n, :, :, None] + s_chunk[:, n]
    y = torch.stack(ys, dim=1).permute(0, 1, 3, 2, 4).reshape(b, s, h, hd)
    return y, state


def timemix_apply(
    p: Params, x: torch.Tensor, cfg: ModelConfig, cache: dict | None = None
) -> tuple[torch.Tensor, dict]:
    """x (B,S,D) -> (B,S,D). cache: {'shift': (B,1,D), 'state': (B,H,hd,hd)};
    returns the new cache (new tensors; the given one is not written)."""
    b, s, d = x.shape
    h, hd = rwkv_dims(cfg)
    xp = _shift(x, None if cache is None else cache["shift"])

    r = _mix(x, xp, p["mu_r"]) @ p["w_r"]
    k = _mix(x, xp, p["mu_k"]) @ p["w_k"]
    v = _mix(x, xp, p["mu_v"]) @ p["w_v"]
    g = F.silu(_mix(x, xp, p["mu_g"]) @ p["w_g"])
    xw = _mix(x, xp, p["mu_w"])
    dd = p["decay_base"].float() + torch.tanh(
        xw.float() @ p["decay_lora_a"].float()
    ) @ p["decay_lora_b"].float()
    lw = -torch.exp(dd)  # log-decay (B,S,D), <= 0: exact, no log(w) round trip

    rh = r.reshape(b, s, h, hd).float()
    kh = k.reshape(b, s, h, hd).float()
    vh = v.reshape(b, s, h, hd).float()
    lwh = lw.reshape(b, s, h, hd)

    if cache is None:
        state0 = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=x.device)
    else:
        state0 = cache["state"]
    u = p["bonus_u"].float()
    chunk = cfg.rwkv.chunk
    if chunk and s > 1:
        # chunked-parallel WKV. Front-pad to a chunk multiple with identity
        # tokens (k = v = 0 leave the state untouched; lw = 0 is no decay),
        # then drop the padded outputs.
        c = min(chunk, s)
        pad = (-s) % c
        if pad:
            rh, kh, vh, lwh = (F.pad(a, (0, 0, 0, 0, pad, 0)) for a in (rh, kh, vh, lwh))
        y, state = _wkv_chunked(rh, kh, vh, lwh, u, state0, c)
        if pad:
            y = y[:, pad:]
    else:
        y, state = _wkv_scan(rh, kh, vh, torch.exp(lwh), u, state0)
    y = y.reshape(b, s, d).to(x.dtype)
    # the reference's "group norm": an RMS per head (eps 1e-6), then a learned scale
    yh = y.reshape(b, s, h, hd).float()
    yh = yh * torch.rsqrt(torch.mean(yh * yh, dim=-1, keepdim=True) + 1e-6)
    y = (yh.reshape(b, s, d) * p["ln_x"].float()).to(x.dtype)
    out = (y * g) @ p["w_o"]
    return out, {"shift": x[:, -1:].clone(), "state": state}


def channelmix_apply(
    p: Params, x: torch.Tensor, cfg: ModelConfig, cache: dict | None = None
) -> tuple[torch.Tensor, dict]:
    xp = _shift(x, None if cache is None else cache["shift"])
    k = torch.relu(_mix(x, xp, p["mu_k"]) @ p["w_in"])
    return (k * k) @ p["w_out"], {"shift": x[:, -1:].clone()}


def rwkv_cache_init(
    cfg: ModelConfig, batch: int, dtype: torch.dtype = torch.float32,
    device: str | torch.device | None = None,
) -> dict:
    h, hd = rwkv_dims(cfg)
    d = cfg.d_model
    return {
        "time": {
            "shift": torch.zeros((batch, 1, d), dtype=dtype, device=device),
            "state": torch.zeros((batch, h, hd, hd), dtype=torch.float32, device=device),
        },
        "chan": {"shift": torch.zeros((batch, 1, d), dtype=dtype, device=device)},
    }
