"""Mixture-of-Experts FFN: top-k routing, sort-based static-capacity dispatch.

The port of the JAX package's ``models/moe.py``, in plain PyTorch (the
reference's is plain ``jnp``; no Pallas kernel lies here). Every expert owns
cap = t*k/E*cf token slots (at least 8, at most t); choices past an expert's
capacity are dropped (zero contribution), as in the reference.

Two of the reference's layout decisions, and what the port keeps of them:

1. Local dispatch: the token axis is grouped by the data-parallel shard
   count G of the active mesh policy (1 where G does not divide the
   batch), and each group is dispatched alone with its own capacity.
   DTensor has no sharding rule for the dispatch's sort, bincount and
   index writes, so they run on each rank's local groups (``to_local``:
   the G axis is the dp-sharded one, so no group crosses ranks) and their
   results are wrapped back as DTensors with the groups' placements: the
   shard_map the reference's vmap over a dp-sharded G amounts to. Only the
   expert buffers move: sharded over the model axis for the expert
   matmuls, gathered back for the combine. Without a policy there is one
   group of all B*S tokens, on plain tensors (``moe_apply``'s own body:
   kept choices only, the expert matmuls as ``bmm``).
2. Virtual experts: where the tensor-parallel width TP = 16 is a multiple of
   E (mixtral's 8 experts), each expert is split into TP/E virtual experts
   of width f/(TP/E), and the split outputs are summed back. The weights
   keep that layout, so the port computes it the same way; where E % TP == 0
   (moonshot's 64) experts are not split.

Ties follow the reference's ``jax.lax.top_k`` (the lowest index first): the
top k are the first k of a stable descending sort, never ``torch.topk``.
Kept choices land on distinct slots, written by index assignment (no
atomics); dropped ones are not written, or (under a policy, whose shapes
must be static) land on a sink row that is thrown away.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig, MoECfg
from repro_torch.models.common import Rec, current_policy, hint
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
    xf: torch.Tensor, gate: torch.Tensor, eids: torch.Tensor, e: int, k: int, cap: int,
    static: bool = False,
):
    """Sort-based dispatch for one token group. xf (t, d), eids (t, k) ->
    (buf (E*cap, d), dest (t*k,), tok (t*k,)); a dropped choice's dest is
    the sink slot E*cap. ``gate`` is unused, as in the reference.
    ``static``: every shape is static (the counts a scatter-add, every
    choice written, the dropped ones to a sink row), so the dry-run's meta
    tensors run it; the policy path uses it."""
    t = xf.shape[0]
    flat_e = eids.reshape(-1)  # (t*k,)
    order = torch.sort(flat_e, stable=True).indices
    if static:
        counts = torch.zeros(e, dtype=flat_e.dtype, device=xf.device).scatter_add_(
            0, flat_e, torch.ones_like(flat_e))
    else:
        counts = torch.bincount(flat_e, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    ar = torch.arange(t * k, device=xf.device)
    rank = torch.empty_like(flat_e)
    rank[order] = ar - starts[flat_e[order]]
    keep = rank < cap
    dest = torch.where(keep, flat_e * cap + rank, e * cap)
    tok = ar // k
    if static:
        buf = torch.zeros((e * cap + 1, xf.shape[1]), dtype=xf.dtype, device=xf.device)
        buf[dest] = xf[tok]  # kept slots are distinct; the sink row is thrown away
        return buf[: e * cap], dest, tok
    buf = torch.zeros((e * cap, xf.shape[1]), dtype=xf.dtype, device=xf.device)
    buf[dest[keep]] = xf[tok[keep]]  # kept slots are distinct
    return buf, dest, tok


def route(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """Router: x (..., t, d) -> (logits, probs, gate, eids), f32; gate and
    eids (..., t, k), renormalised gates of the top k, ties to the lowest
    index. The top-k runs on local tensors (a DTensor's own groups)."""
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(_local(probs), dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    gate, eids = top.values[..., :k], top.indices[..., :k]
    gate = gate / torch.clamp(torch.sum(gate, dim=-1, keepdim=True), min=1e-9)
    return logits, probs, gate, eids


def _local(x: torch.Tensor) -> torch.Tensor:
    return x.to_local() if isinstance(x, DTensor) else x


def _like(local: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``local`` (this rank's groups) as a DTensor placed as ``ref``, whose
    dim 0 is the group axis; a plain tensor beside a plain ``ref``."""
    if not isinstance(ref, DTensor):
        return local
    shape = (ref.shape[0],) + tuple(local.shape[1:])
    return DTensor.from_local(local, ref.device_mesh, ref.placements, run_check=False,
                              shape=torch.Size(shape), stride=local.stride())


def _aux_loss(moe: MoECfg, logits, probs, top1_share) -> torch.Tensor:
    """Load balance (Switch) + router z-loss; ``top1_share`` (E,) is the
    share of tokens whose first choice is each expert."""
    return moe.n_experts * torch.sum(probs * top1_share) + moe.router_z_weight * torch.mean(
        torch.log(torch.sum(torch.exp(logits), dim=-1)) ** 2
    )


def _experts(p: Params, eb: torch.Tensor, cfg: ModelConfig, mm) -> torch.Tensor:
    """The expert FFN on dispatched slots ``eb``; ``mm`` multiplies them by
    an (E', a, b) weight."""
    if cfg.mlp_act == "relu2":
        hid = torch.relu(mm(eb, p["w_in"]))
        hid = hid * hid
    else:
        act = F.silu if cfg.mlp_act == "silu" else _gelu
        hid = act(mm(eb, p["w_gate"])) * mm(eb, p["w_in"])
    return mm(hid, p["w_out"])


def moe_apply(p: Params, x: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,D) -> (out (B,S,D), aux_loss scalar)."""
    policy = current_policy()
    if policy is not None:
        return _moe_placed(p, x, cfg, policy)
    moe: MoECfg = cfg.moe
    b, s, d = x.shape
    e, k = moe.n_experts, moe.top_k
    split = p["w_gate"].shape[0] // e  # virtual-expert factor (from the weights)
    t = b * s
    xf = x.reshape(t, d)
    logits, probs, gate, eids = route(p, xf, cfg)
    aux = _aux_loss(moe, logits, torch.mean(probs, dim=0),
                    torch.mean(F.one_hot(eids[:, 0], e).float(), dim=0))

    cap = capacity(moe, t)
    buf, dest, _tok = _dispatch_group(xf, gate, eids, e, k, cap)
    eb = buf.reshape(e, cap, d)
    if split > 1:  # each virtual expert computes an f/split slice of its expert
        eb = torch.repeat_interleave(eb, split, dim=0)  # (E*split, cap, d)
    out_e = _experts(p, eb, cfg, torch.bmm)  # (E*split, cap, d)
    if split > 1:
        out_e = out_e.reshape(e, split, cap, d).sum(dim=1)

    # ---- combine: gather back, weight by gates; dropped choices read the zero row
    flat = torch.cat([out_e.reshape(e * cap, d), out_e.new_zeros((1, d))], dim=0)
    per_choice = flat[dest].reshape(t, k, d)
    combined = torch.sum(per_choice * gate[..., None].to(out_e.dtype), dim=1)
    return combined.reshape(b, s, d), aux


def _moe_placed(p: Params, x: torch.Tensor, cfg: ModelConfig, policy) -> tuple:
    """``moe_apply`` under a mesh policy: the tokens in G groups (the dp
    size, 1 where it does not divide the batch), each rank dispatching its
    own groups with static shapes; only the expert buffers move."""
    moe: MoECfg = cfg.moe
    b, s, d = x.shape
    e, k = moe.n_experts, moe.top_k
    split = p["w_gate"].shape[0] // e
    g = policy.axes_size("dp")
    if b % g:
        g = 1  # tiny batches (long-context decode): replicated dispatch
    x = hint(x, "dp", None, None)
    xg = hint(x.reshape(g, (b // g) * s, d), "dp", None, None)
    t = xg.shape[1]
    logits, probs, gate, eids = route(p, xg, cfg)  # gate, eids: this rank's groups
    top1 = _like(torch.mean(F.one_hot(eids[..., 0], e).float(), dim=1), xg)
    aux = _aux_loss(moe, logits, torch.mean(probs, dim=(0, 1)), torch.mean(top1, dim=0))

    cap = capacity(moe, t)
    xl = _local(xg)
    groups = [_dispatch_group(xl[i], gate[i], eids[i], e, k, cap, static=True)
              for i in range(xl.shape[0])]
    dest = torch.stack([dg for _, dg, _ in groups])
    eb = _like(torch.stack([buf for buf, _, _ in groups]).reshape(-1, e, cap, d), xg)
    if split > 1:
        eb = torch.repeat_interleave(eb, split, dim=1)  # (G, E*split, cap, d)
    eb = hint(eb, "dp", "tp", None, None)
    out_e = _experts(p, eb, cfg, lambda a, w: torch.einsum("gecd,edf->gecf", a, w))
    # gathered back before the split sum: DTensor cannot cut an expert dim
    # sharded over tp into (E, split) where E does not divide the axis
    out_e = hint(out_e, "dp", None, None, None)
    if split > 1:
        out_e = out_e.reshape(-1, e, split, cap, d).sum(dim=2)
    out_e = _local(out_e)

    flat = torch.cat([out_e.reshape(-1, e * cap, d), out_e.new_zeros((out_e.shape[0], 1, d))], 1)
    per_choice = torch.gather(flat, 1, dest[..., None].expand(-1, -1, d)).reshape(-1, t, k, d)
    combined = torch.sum(per_choice * gate[..., None].to(out_e.dtype), dim=2)
    # the hint pins the grad's placements for the reshape's backward, which
    # DTensor cannot follow from a batch sharded over both mesh axes
    return hint(_like(combined, xg).reshape(b, s, d), "dp", None, None), aux
