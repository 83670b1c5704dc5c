"""Param records, symbolic sharding specs, and the active mesh policy.

The port of the JAX package's ``models/common.py``. Symbolic spec entries:
  None  — replicated dim
  "tp"  — shard over the model axis
  "dp"  — shard over the data axes (("pod","data") on the multi-pod mesh)
Resolved against a ``MeshPolicy`` at run time, so model code is
mesh-agnostic. The reference's ``NamedSharding`` plus GSPMD becomes a
``torch.distributed.tensor`` (DTensor) placement per mesh dimension on a
``DeviceMesh``: a dim resolved to mesh axes is ``Shard(dim)`` on each of
them (several axes shard it in the mesh's major order, as the reference's
tuple entries do), and every other mesh dimension is ``Replicate()``.
``sharding_for``'s rule is the reference's: a dim that its axes do not
divide is demoted to replicated (DTensor's uneven shards are never used).
``hint`` is ``with_sharding_constraint``'s counterpart: a redistribute of a
DTensor when a policy is active, else the identity.

Leaves are drawn from an explicit ``torch.Generator`` in the order of the
tree's sorted keys, as JAX flattens a dict; torch cannot reproduce
``jax.random`` streams, so weights are carried across with
``models.interop.params_from_jax`` where the two packages must agree, and
placed under a policy with ``place_tree``.
"""

from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass
from typing import Any, Iterator, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Placement, Replicate, Shard, distribute_tensor

from repro_torch.common import resolve_device

# ------------------------------------------------------------------ policy

_STATE = threading.local()


@dataclass(frozen=True)
class MeshPolicy:
    mesh: DeviceMesh
    dp: tuple[str, ...] = ("data",)
    tp: str = "model"

    def resolve(self, sym: Sequence) -> tuple:
        """The reference's PartitionSpec, as a tuple: per dim None, an axis
        name, or a tuple of axis names (one name stands alone, as a
        PartitionSpec normalizes it)."""
        out: list = []
        for e in sym:
            if e is None:
                out.append(None)
            elif e == "tp":
                out.append(self.tp)
            elif e == "dp":
                out.append(self.dp if len(self.dp) > 1 else self.dp[0])
            elif isinstance(e, tuple):  # e.g. ("dp","tp") -> shard over both
                flat: list[str] = []
                for s in e:
                    flat.extend(self.dp if s == "dp" else (self.tp,))
                out.append(tuple(flat))
            else:
                raise ValueError(f"bad sym spec entry {e!r}")
        return tuple(out)

    def _axis_size(self, name: str) -> int:
        return int(self.mesh.size(self.mesh.mesh_dim_names.index(name)))

    def placements(self, spec: Sequence) -> tuple[Placement, ...]:
        """A resolved spec -> one placement per mesh dimension. An axis of
        size 1 shards nothing: it stays ``Replicate()`` (the same local
        shapes, and DTensor has no layout to reason about there)."""
        out: list[Placement] = [Replicate()] * self.mesh.ndim
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            for name in entry if isinstance(entry, tuple) else (entry,):
                i = self.mesh.mesh_dim_names.index(name)
                if not isinstance(out[i], Replicate):
                    raise ValueError(f"mesh axis {name!r} shards two dims of {spec}")
                if self._axis_size(name) > 1:
                    out[i] = Shard(dim)
        return tuple(out)

    def sharding(self, sym: Sequence) -> tuple[Placement, ...]:
        return self.placements(self.resolve(sym))

    def axes_size(self, entry) -> int:
        spec = self.resolve((entry,))
        names = spec[0] if isinstance(spec[0], tuple) else (spec[0],)
        return math.prod(self._axis_size(nm) for nm in names)

    def fixed_sym(self, shape: Sequence[int], sym: Sequence) -> tuple:
        """``sym`` cut to ``shape``'s rank, padded with None, with every dim
        that its axes do not divide demoted to replicated."""
        sym = tuple(sym[: len(shape)])
        fixed = [
            None if e is None or shape[dim] % self.axes_size(e) else e
            for dim, e in enumerate(sym)
        ]
        return tuple(fixed) + (None,) * (len(shape) - len(fixed))

    def sharding_for(self, shape: Sequence[int], sym: Sequence) -> tuple[Placement, ...]:
        """Placements with non-divisible dims silently demoted to replicated."""
        return self.sharding(self.fixed_sym(shape, sym))

    def shard_shape(self, shape: Sequence[int], sym: Sequence) -> tuple[int, ...]:
        """Each device's local shape under ``sharding_for(shape, sym)``."""
        out = list(shape)
        for e, dim in zip(self.fixed_sym(shape, sym), range(len(shape))):
            if e is not None:
                out[dim] //= self.axes_size(e)
        return tuple(out)


def current_policy() -> Optional[MeshPolicy]:
    return getattr(_STATE, "policy", None)


@contextlib.contextmanager
def use_policy(policy: Optional[MeshPolicy]):
    prev = current_policy()
    _STATE.policy = policy
    try:
        yield
    finally:
        _STATE.policy = prev


def hint(x: torch.Tensor, *sym) -> torch.Tensor:
    """A redistribute to ``sharding_for(x.shape, sym)`` if a policy is active
    and ``x`` is a DTensor, else the identity.

    Dims whose size does not divide the requested axes are silently left
    replicated (e.g. batch=1 long-context decode on a 32-way dp axis)."""
    policy = current_policy()
    if policy is None or not isinstance(x, DTensor):
        return x
    if any(type(p) is Partial and p.reduce_op in ("sum", "avg") for p in x.placements):
        x = _ReducePartial.apply(x)
    # a redistribute even to the same placements: its backward pins the
    # grad to them, where DTensor's own choice may not divide (a batch
    # sharded over both mesh axes)
    return x.redistribute(policy.mesh, policy.sharding_for(x.shape, sym))


class _ContiguousGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        if isinstance(g, DTensor):  # its own contiguous() reads the global strides only
            return DTensor.from_local(g.to_local().contiguous(), g.device_mesh, g.placements,
                                      run_check=False, shape=g.shape, stride=g.stride())
        return g.contiguous()


def contiguous_grad(x: torch.Tensor) -> torch.Tensor:
    """The identity, whose backward makes the grad contiguous. DTensor runs
    a reshape's or a matmul's backward on its grad's local shard as a
    ``view``, which a permuted or sliced grad (an einsum's, a slice's)
    refuses."""
    return _ContiguousGrad.apply(x)


class _ReducePartial(torch.autograd.Function):
    """Partial sums (or means) reduced to a replicated tensor; the grad
    passes back as it comes, replicated: the tensor is the same global
    value, only its layout changes (Megatron's all-reduce, the identity in
    backward). DTensor's own redistribute would turn the grad back into
    partial sums, and the row-parallel matmul that made them would then
    gather its weight whole rather than reduce them."""

    @staticmethod
    def forward(ctx, x: DTensor) -> DTensor:
        want = [Replicate() if type(p) is Partial else p for p in x.placements]
        return x.redistribute(x.device_mesh, want)

    @staticmethod
    def backward(ctx, g: DTensor) -> DTensor:
        return g


def place(x: torch.Tensor, policy: MeshPolicy, sym: Sequence) -> torch.Tensor:
    """A full tensor that every rank holds alike -> its DTensor under
    ``policy`` (each rank keeps its own shard; no communication)."""
    return distribute_tensor(
        x, policy.mesh, policy.sharding_for(x.shape, sym), src_data_rank=None
    )


@dataclass(frozen=True)
class Rec:
    """A parameter leaf: shape + symbolic spec + init rule."""

    shape: tuple[int, ...]
    sym: tuple = ()  # symbolic partition spec, () -> fully replicated
    init: str = "normal"  # normal | zeros | ones | embed | small
    scale: float = 1.0  # multiplier on the fan-in init


def is_rec(x: Any) -> bool:
    return isinstance(x, Rec)


def leaves(tree: Any, path: tuple[str, ...] = ()) -> Iterator[tuple[tuple[str, ...], Any]]:
    """(path, leaf) pairs of a nested dict, keys sorted at every level."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from leaves(tree[key], path + (key,))
    else:
        yield path, tree


def tree_map(fn, tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, v) for key, v in tree.items()}
    return fn(tree)


def _init_leaf(generator: torch.Generator, rec: Rec, dtype: torch.dtype) -> torch.Tensor:
    dev = generator.device
    if rec.init == "zeros":
        return torch.zeros(rec.shape, dtype=dtype, device=dev)
    if rec.init == "ones":
        return torch.ones(rec.shape, dtype=dtype, device=dev)
    draw = torch.randn(rec.shape, generator=generator, device=dev)
    if rec.init == "embed":
        return (draw * 0.02 * rec.scale).to(dtype)
    # fan-in scaled normal
    fan_in = rec.shape[0] if len(rec.shape) >= 2 else max(rec.shape[-1], 1)
    if len(rec.shape) == 3:  # stacked/expert weights: fan-in is dim -2
        fan_in = rec.shape[-2]
    std = rec.scale / np.sqrt(fan_in)
    return (draw * std).to(dtype)


def materialize(
    generator: torch.Generator,
    recs: Any,
    device: str | torch.device | None = None,
    dtype: torch.dtype = torch.float32,
) -> Any:
    """Rec tree -> tensor tree on ``device`` (``None`` means the CUDA device).

    Leaves are drawn on the generator's device in sorted-key order, then
    moved; a generator on ``device`` avoids the copy."""
    dev = resolve_device(device)
    out: dict = {}
    for path, rec in leaves(recs):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _init_leaf(generator, rec, dtype).to(dev)
    return out


def materialize_stacked(
    generator: torch.Generator,
    recs_one: Any,
    n: int,
    device: str | torch.device | None = None,
    dtype: torch.dtype = torch.float32,
) -> Any:
    """n layers of ``recs_one``, drawn one after another from ``generator``
    (each as ``materialize`` draws it), stacked leaf by leaf on dim 0."""
    layers = [materialize(generator, recs_one, device, dtype) for _ in range(n)]

    def stack(parts: list) -> Any:
        if isinstance(parts[0], dict):
            return {k: stack([p[k] for p in parts]) for k in parts[0]}
        return torch.stack(parts)

    return stack(layers)


def abstract(
    recs: Any, policy: MeshPolicy, dtype: torch.dtype = torch.bfloat16, factory=torch.empty
) -> Any:
    """Rec tree -> DTensor tree of local shards (``factory``: empty) with
    their placements.

    Called in a ``torch.device("meta")`` context (the dry-run) it allocates
    nothing. Non-
    divisible dims demote to replicated (sharding_for) — e.g. whisper's
    51865 vocab on a 16-way model axis."""
    dev = local_device(policy)

    def f(r: Rec) -> DTensor:
        local = factory(policy.shard_shape(r.shape, r.sym), dtype=dtype, device=dev)
        return DTensor.from_local(
            local, policy.mesh, policy.sharding_for(r.shape, r.sym), run_check=False,
            shape=torch.Size(r.shape), stride=_contiguous_stride(r.shape),
        )

    return tree_map(f, recs)


def local_device(policy: MeshPolicy) -> torch.device:
    """Where a rank's shards live: its mesh's device, or ``meta`` inside a
    ``torch.device("meta")`` context (the dry-run: nothing is allocated)."""
    from repro_torch.distrib.sharding import mesh_device

    if torch.get_default_device().type == "meta":
        return torch.device("meta")
    return mesh_device(policy.mesh)


def _contiguous_stride(shape: Sequence[int]) -> tuple[int, ...]:
    out, acc = [], 1
    for n in reversed(shape):
        out.append(acc)
        acc *= max(int(n), 1)
    return tuple(reversed(out))


def spec_tree(recs: Any, policy: MeshPolicy) -> Any:
    """Rec tree -> resolved spec tree (the reference's ``.spec`` per leaf)."""
    return tree_map(lambda r: policy.resolve(policy.fixed_sym(r.shape, r.sym)), recs)


class NamedSharding(NamedTuple):
    """The reference's ``NamedSharding``: a mesh and one placement per mesh
    dimension, what ``distribute_tensor`` takes."""

    mesh: DeviceMesh
    placements: tuple[Placement, ...]


def sharding_tree(recs: Any, policy: MeshPolicy) -> Any:
    """Rec tree -> tree of ``NamedSharding`` (what an elastic
    ``train.checkpoint.restore`` takes as ``shardings``)."""
    return tree_map(lambda r: NamedSharding(policy.mesh, policy.sharding_for(r.shape, r.sym)), recs)


def place_tree(tree: Any, recs: Any, policy: MeshPolicy) -> Any:
    """A full tensor tree (every rank holds it alike) -> DTensors placed as
    ``recs`` say (``place`` leaf by leaf)."""
    return tree_map(lambda pair: place(pair[0], policy, pair[1].sym), _zip(tree, recs))


def _zip(a: Any, b: Any) -> Any:
    if isinstance(a, dict):
        return {k: _zip(a[k], b[k]) for k in a}
    return (a, b)


def fsdp_recs(recs: Any) -> Any:
    """ZeRO-3-style param sharding: each Rec additionally shards its first
    replicated dim over dp (resolved at abstract() time; non-divisible dims
    demote back to replicated via sharding_for). DTensor's redistributes
    gather each layer's weights where they are used — params/device drop
    ~dp-fold at the cost of gather traffic."""

    def f(r: Rec) -> Rec:
        if len(r.shape) < 2 or r.init == "embed":
            # token/position tables stay out: gathers from a dp-sharded vocab
            # turn into per-shard masked lookups + all-reduce — worse than the
            # (already tp-sharded) table itself.
            return r
        sym = list(r.sym) + [None] * (len(r.shape) - len(r.sym))
        # never shard the stacked-layer dim (dim 0 of ndim>=3 params — each
        # layer's slice must stay local); pick the LARGEST replicated dim
        # (best odds of dividing the dp axes).
        first = 1 if len(r.shape) >= 3 else 0
        cands = [
            (r.shape[d], d)
            for d in range(first, len(r.shape))
            if sym[d] is None and r.shape[d] > 1
        ]
        if cands:
            _, dim = max(cands)
            sym[dim] = "dp"
        return Rec(r.shape, tuple(sym), r.init, r.scale)

    return tree_map(f, recs)


def stack(recs: Any, n: int) -> Any:
    """Prepend a stacked-layer dim (replicated) to every Rec."""
    return tree_map(lambda r: Rec((n,) + r.shape, (None,) + tuple(r.sym), r.init, r.scale), recs)


def param_count(recs: Any) -> int:
    return sum(int(np.prod(r.shape)) for _, r in leaves(recs))
