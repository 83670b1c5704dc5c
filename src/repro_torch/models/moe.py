"""Mixture-of-Experts FFN: top-k routing, sort-based static-capacity dispatch.

The port of the JAX package's ``models/moe.py``, in plain PyTorch (the
reference's is plain ``jnp``; no Pallas kernel lies here). Every expert owns
cap = t*k/E*cf token slots (at least 8, at most t); choices past an expert's
capacity are dropped (zero contribution), as in the reference.

Two of the reference's layout decisions, and what the port keeps of them:

1. Local dispatch: the reference groups the token axis by the data-parallel
   shard count G of its active mesh policy and dispatches each group alone.
   The port has no mesh policy, so G is 1, the reference's value off a mesh:
   one group of all B*S tokens.
2. Virtual experts: where the tensor-parallel width TP = 16 is a multiple of
   E (mixtral's 8 experts), each expert is split into TP/E virtual experts
   of width f/(TP/E), and the split outputs are summed back. The weights
   keep that layout, so the port computes it the same way; where E % TP == 0
   (moonshot's 64) experts are not split.

Ties follow the reference's ``jax.lax.top_k`` (the lowest index first): the
top k are the first k of a stable descending sort, never ``torch.topk``.
Kept choices land on distinct slots, written by index assignment (no
atomics); dropped ones would land on a sink row that is thrown away, so the
port does not write them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoECfg
from repro_torch.models.common import Rec
from repro_torch.models.layers import Params, _gelu

# model-axis size the reference's production mesh uses; only divisibility matters
TP = 16


def _split_factor(moe: MoECfg) -> int:
    e, f = moe.n_experts, moe.d_ff_expert
    if e % TP == 0:
        return 1  # already expert-parallel
    if TP % e == 0 and f % (TP // e) == 0:
        return TP // e  # virtual experts
    return 1


def moe_recs(cfg: ModelConfig) -> dict:
    moe = cfg.moe
    d, f, e = cfg.d_model, moe.d_ff_expert, moe.n_experts
    split = _split_factor(moe)
    if e % TP == 0 or split > 1:  # expert dim (possibly virtual) shards
        ev, fv = e * split, f // split
        return {
            "router": Rec((d, e), (None, None)),
            "w_gate": Rec((ev, d, fv), ("tp", None, None)),
            "w_in": Rec((ev, d, fv), ("tp", None, None)),
            "w_out": Rec((ev, fv, d), ("tp", None, None)),
        }
    # fallback: tensor parallel inside each expert (f cut)
    return {
        "router": Rec((d, e), (None, None)),
        "w_gate": Rec((e, d, f), (None, None, "tp")),
        "w_in": Rec((e, d, f), (None, None, "tp")),
        "w_out": Rec((e, f, d), (None, "tp", None)),
    }


def capacity(moe: MoECfg, t: int) -> int:
    """Slots per expert for t tokens (the floor of 8 keeps small decode
    batches drop-free); the reference's Python float expression, in order."""
    return min(max(int(t * moe.top_k / moe.n_experts * moe.capacity_factor) + 1, 8), t)


def _dispatch_group(
    xf: torch.Tensor, gate: torch.Tensor, eids: torch.Tensor, e: int, k: int, cap: int
):
    """Sort-based dispatch for one token group. xf (t, d), eids (t, k) ->
    (buf (E*cap, d), dest (t*k,), tok (t*k,)); a dropped choice's dest is
    the sink slot E*cap. ``gate`` is unused, as in the reference."""
    t = xf.shape[0]
    flat_e = eids.reshape(-1)  # (t*k,)
    order = torch.sort(flat_e, stable=True).indices
    counts = torch.bincount(flat_e, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    ar = torch.arange(t * k, device=xf.device)
    rank = torch.empty_like(flat_e)
    rank[order] = ar - starts[flat_e[order]]
    keep = rank < cap
    dest = torch.where(keep, flat_e * cap + rank, e * cap)
    tok = ar // k
    buf = torch.zeros((e * cap, xf.shape[1]), dtype=xf.dtype, device=xf.device)
    buf[dest[keep]] = xf[tok[keep]]  # kept slots are distinct
    return buf, dest, tok


def route(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """Router: x (t, d) -> (logits, probs, gate, eids), f32; gate and eids
    (t, k), renormalised gates of the top k, ties to the lowest index."""
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    gate, eids = top.values[:, :k], top.indices[:, :k]
    gate = gate / torch.clamp(torch.sum(gate, dim=-1, keepdim=True), min=1e-9)
    return logits, probs, gate, eids


def moe_apply(p: Params, x: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,D) -> (out (B,S,D), aux_loss scalar)."""
    moe: MoECfg = cfg.moe
    b, s, d = x.shape
    e, k = moe.n_experts, moe.top_k
    split = p["w_gate"].shape[0] // e  # virtual-expert factor (from the weights)
    t = b * s
    xf = x.reshape(t, d)
    logits, probs, gate, eids = route(p, xf, cfg)

    # ---- aux losses: load balance (Switch) + router z-loss
    me = torch.mean(probs, dim=0)
    ce = torch.mean(F.one_hot(eids[:, 0], e).float(), dim=0)
    aux = e * torch.sum(me * ce) + moe.router_z_weight * torch.mean(
        torch.log(torch.sum(torch.exp(logits), dim=-1)) ** 2
    )

    cap = capacity(moe, t)
    buf, dest, _tok = _dispatch_group(xf, gate, eids, e, k, cap)
    eb = buf.reshape(e, cap, d)
    if split > 1:  # each virtual expert computes an f/split slice of its expert
        eb = torch.repeat_interleave(eb, split, dim=0)  # (E*split, cap, d)

    if cfg.mlp_act == "relu2":
        hid = torch.relu(torch.bmm(eb, p["w_in"]))
        hid = hid * hid
    else:
        act = F.silu if cfg.mlp_act == "silu" else _gelu
        hid = act(torch.bmm(eb, p["w_gate"])) * torch.bmm(eb, p["w_in"])
    out_e = torch.bmm(hid, p["w_out"])  # (E*split, cap, d)
    if split > 1:
        out_e = out_e.reshape(e, split, cap, d).sum(dim=1)

    # ---- combine: gather back, weight by gates; dropped choices read the zero row
    flat = torch.cat([out_e.reshape(e * cap, d), out_e.new_zeros((1, d))], dim=0)
    per_choice = flat[dest].reshape(t, k, d)
    combined = torch.sum(per_choice * gate[..., None].to(out_e.dtype), dim=1)
    return combined.reshape(b, s, d), aux
