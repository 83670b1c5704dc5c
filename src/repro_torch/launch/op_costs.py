"""Op-level cost model: per-device flops, bytes and collective bytes of a step.

The port's counterpart of the JAX package's ``launch/hlo_costs.py``, which
parses a compiled, partitioned HLO module. There is no HLO here: the step
runs eagerly (on fake tensors in the dry-run) under ``OpCounter``, a
``TorchDispatchMode`` that sees every aten op below DTensor's dispatch. An
op whose arguments are DTensors is handed back to DTensor (the mode returns
``NotImplemented``), and the ops DTensor then runs on its local shards, and
the collectives its redistributes issue, come through the mode one by one:
every count is per device, as the reference's. The ops DTensor runs on
fake global tensors to learn an op's output shape are not counted. A layer loop needs no
trip-count scaling, because eager execution runs every layer.

Cost model per op (the reference's conventions):
  flops:
    mm / addmm / bmm / baddbmm   2 * numel(result) * contracted size
    convolution                  2 * numel(result) * (C_in / groups) * kernel size
    pointwise (``Tag.pointwise``) 1 * numel(result)
    reduction (``Tag.reduction``) numel(operand)
    sort                         numel * log2(numel) comparisons
    scatter-add / index_add      1 * numel(update)
  bytes accessed (HBM traffic model):
    each op reads its tensor operands and writes its result. Eager torch
    does not fuse, so every op is a kernel and this is the traffic the card
    sees. Views, ``empty`` and other free ops move nothing; a gather or
    index read moves its result twice (read + write), a scatter or index
    write its update twice.
  collectives:
    result bytes, classified by the reference's kinds, from the
    ``_c10d_functional`` and ``c10d`` ops; ``wait_tensor`` is skipped (the
    reference skips ``-done``).

``OpCounter(track_memory=True)`` also follows every storage the step
creates (a weak reference each, freed when the storage dies): the peak of
live bytes, which is what ``torch.cuda.max_memory_allocated`` measures on a
card.
"""

from __future__ import annotations

import math
import weakref
from typing import Any, Callable

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVE_KINDS = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute", "collective-broadcast", "ragged-all-to-all",
)

_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce", "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "broadcast": "collective-broadcast", "broadcast_": "collective-broadcast",
    "send": "collective-permute", "recv_": "collective-permute",
}
_COLLECTIVE_NS = ("_c10d_functional", "c10d", "_c10d_functional_autograd")

_aten = torch.ops.aten
_FREE = {
    _aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default,
    _aten.lift_fresh.default, _aten._local_scalar_dense.default, _aten.detach.default,
    _aten.alias.default, _aten.set_.source_Storage_storage_offset,
}
_DOTS = {_aten.mm.default: 0, _aten.bmm.default: 0, _aten.addmm.default: 1,
         _aten.baddbmm.default: 1}
_READS = {
    _aten.index_select.default, _aten.gather.default, _aten.embedding.default,
    _aten.index.Tensor,
}
_WRITES = {  # op -> position of the update operand
    _aten.index_put_.default: 2, _aten.index_put.default: 2, _aten._index_put_impl_.default: 2,
    _aten.scatter.src: 3, _aten.scatter_.src: 3, _aten.scatter_add.default: 3,
    _aten.scatter_add_.default: 3, _aten.index_add_.default: 3, _aten.index_add.default: 3,
    _aten.index_copy_.default: 3, _aten.scatter_reduce_.two: 3, _aten.scatter_reduce.two: 3,
}
_ASSIGNS = {_aten.index_put_.default, _aten.index_put.default, _aten._index_put_impl_.default,
            _aten.scatter.src, _aten.scatter_.src, _aten.index_copy_.default}


def _tensors(tree: Any) -> list[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """Counts per-device flops, bytes and collective bytes of the ops run
    under it (see the module docstring); with ``track_memory`` it also
    tracks live storage bytes and their peak."""

    def __init__(self, track_memory: bool = False):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.coll: dict[str, float] = {}
        self.coll_ops = 0
        self.largest = 0.0  # bytes of the largest output one counted op wrote
        self.track_memory = track_memory
        self.live = 0
        self.peak = 0
        self._seen: dict[int, tuple[weakref.ref, int]] = {}

    # ---------------------------------------------------------- memory
    def track(self, tree: Any) -> int:
        """Count the storages of ``tree``'s tensors (DTensors: their local
        shards) as live; returns the bytes newly counted."""
        added = 0
        for t in _tensors(tree):
            if isinstance(t, DTensor):
                t = t.to_local()
            added += self._add_storage(t)
        return added

    def _add_storage(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = id(st)
        hit = self._seen.get(key)
        if hit is not None and hit[0]() is st:
            return 0
        n = st.nbytes()
        self._seen[key] = (weakref.ref(st), n)
        weakref.finalize(st, self._free, key, n)
        self.live += n
        self.peak = max(self.peak, self.live)
        return n

    def _free(self, key: int, n: int) -> None:
        hit = self._seen.get(key)
        if hit is not None and hit[0]() is None:
            del self._seen[key]
            self.live -= n

    # ---------------------------------------------------------- dispatch
    def __enter__(self):
        # DTensor learns each op's global output shape by running it once on
        # fake or meta global tensors (``_propagate_tensor_meta_non_cached``):
        # a wrapper marks those calls, which are not the step's work
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        if not callable(getattr(ShardingPropagator, "_propagate_tensor_meta_non_cached", None)):
            raise RuntimeError("this torch's DTensor propagates shapes by another route: the "
                               "counter would count its global tensors as the step's work")
        self._depth = 0
        self._orig = ShardingPropagator._propagate_tensor_meta_non_cached

        def marked(prop, *args, **kwargs):
            self._depth += 1
            try:
                return self._orig(prop, *args, **kwargs)
            finally:
                self._depth -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = marked
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        ShardingPropagator._propagate_tensor_meta_non_cached = self._orig
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it on local shards, seen below
        out = func(*args, **kwargs)
        if self._depth or any(isinstance(t, FakeTensor) for t in _tensors((args, kwargs))):
            return out  # DTensor's shape propagation on global tensors: not the step's
        self._count(func, args, kwargs, out)
        if self.track_memory:
            for t in _tensors(out):
                self._add_storage(t)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if ns in _COLLECTIVE_NS:
            kind = _COLLECTIVES.get(name)
            if kind is None:
                return  # wait_tensor, barrier, ...
            res = outs if not name.endswith("_") else _tensors(args[0])
            nb = float(sum(_nbytes(t) for t in res))
            self.coll[kind] = self.coll.get(kind, 0.0) + nb
            self.coll_ops += 1
            ids = {id(t) for t in res}
            self.bytes += nb + sum(_nbytes(t) for t in ins if id(t) not in ids)
            return
        if func in _FREE or func.is_view or not outs:  # metadata queries return no tensor
            return
        out_numel = sum(t.numel() for t in outs)
        if func in _DOTS:
            a = args[_DOTS[func]]
            self.flops += 2.0 * out_numel * a.shape[-1]
        elif func is _aten.convolution.default:
            w = args[1]  # (C_out, C_in / groups, *kernel)
            self.flops += 2.0 * out_numel * math.prod(w.shape[1:])
        elif func in _WRITES and func not in _ASSIGNS:
            upd = args[_WRITES[func]]  # an add or a compare per update element
            self.flops += float(upd.numel()) if isinstance(upd, torch.Tensor) else 0.0
        elif func is _aten.sort.default or func is _aten.sort.stable:
            n = max(float(args[0].numel()), 2.0)
            self.flops += n * math.log2(n)
        elif torch.Tag.reduction in func.tags:
            self.flops += float(ins[0].numel()) if ins else 0.0
        elif torch.Tag.pointwise in func.tags:
            self.flops += float(out_numel)
        out_bytes = float(sum(_nbytes(t) for t in outs))
        self.largest = max(self.largest, max(float(_nbytes(t)) for t in outs))
        if func in _READS:
            self.bytes += 2.0 * out_bytes
        elif func in _WRITES:
            upd = args[_WRITES[func]] if len(args) > _WRITES[func] else None
            self.bytes += 2.0 * (_nbytes(upd) if isinstance(upd, torch.Tensor) else out_bytes)
        else:
            self.bytes += float(sum(_nbytes(t) for t in ins)) + out_bytes

    # ---------------------------------------------------------- result
    def costs(self) -> dict:
        """``parse_hlo_costs``'s dict: {"flops", "bytes", "collectives":
        {kind: bytes, "total", "n_ops"}}, per device."""
        coll = dict(self.coll)
        coll["total"] = sum(coll.values())
        coll["n_ops"] = self.coll_ops
        for kind in COLLECTIVE_KINDS:
            coll.setdefault(kind, 0.0)
        return {"flops": self.flops, "bytes": self.bytes, "collectives": coll}


def op_costs(fn: Callable, *args, **kwargs) -> tuple[Any, dict]:
    """Run ``fn(*args, **kwargs)`` under an ``OpCounter``; returns (its
    result, the per-device costs)."""
    with OpCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter.costs()
