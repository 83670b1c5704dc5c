"""Meshes, tiers and row blocks of the multi-device engine.

The JAX package's ``jax.sharding.Mesh`` becomes a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group, with the reference's axis names as ``mesh_dim_names``. The
port is SPMD: every rank runs the same program, and an array "sharded over
axes" is each rank's own row block of it, in the row-major order of the
mesh coordinates over those axes (outermost first), as ``shard_map`` lays
rows out. The caller starts the process group (gloo on the CPU, NCCL on
the card; with NCCL, ``torch.cuda.set_device`` comes first).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_flat_mesh(axis: str = "data") -> DeviceMesh:
    """1-D mesh over every rank (each rank is one device): the clustering
    layout."""
    return init_device_mesh(_device_type(), (dist.get_world_size(),), mesh_dim_names=(axis,))


def make_pod_mesh(
    n_pods: int,
    pod_size: int | None = None,
    axes: tuple[str, str] = ("pod", "data"),
) -> DeviceMesh:
    """2-D (n_pods, pod_size) mesh: the two-tier collective layout. Rows
    shard over both axes; the tiered 'component' reduce resolves the inner
    ``data`` axis (intra-pod links) before anything crosses pods.
    ``pod_size=None`` divides the world size by ``n_pods``."""
    world = dist.get_world_size()
    if pod_size is None:
        if world % n_pods:
            raise ValueError(f"{world} ranks do not split into {n_pods} pods")
        pod_size = world // n_pods
    if n_pods * pod_size != world:
        raise ValueError(
            f"a ({n_pods}, {pod_size}) pod mesh needs {n_pods * pod_size} ranks,"
            f" the world has {world}"
        )
    return init_device_mesh(_device_type(), (n_pods, pod_size), mesh_dim_names=axes)


def _dim(mesh: DeviceMesh, axis: str) -> int:
    return mesh.mesh_dim_names.index(axis)


def tier_sizes(mesh: DeviceMesh, axes: Sequence[str]) -> tuple[int, ...]:
    """Per-tier shard counts, outermost first: (n_pods, pod_size) on a pod
    mesh, (P,) on a flat one. The analytic shuffle accounting splits bytes
    across it."""
    return tuple(int(mesh.size(_dim(mesh, a))) for a in axes)


def mesh_axis_size(mesh: DeviceMesh, axes: Sequence[str]) -> int:
    return int(math.prod(tier_sizes(mesh, axes)))


def axis_groups(mesh: DeviceMesh, axes: Sequence[str]) -> list[dist.ProcessGroup]:
    """This rank's process group along each axis, outermost first."""
    return [mesh.get_group(a) for a in axes]


def shard_index(mesh: DeviceMesh, axes: Sequence[str]) -> int:
    """This rank's row-block index over ``axes``: its mesh coordinates
    raveled row-major, outermost axis first (``jax.lax.axis_index``)."""
    coord = mesh.get_coordinate()
    idx = 0
    for a in axes:
        i = _dim(mesh, a)
        idx = idx * int(mesh.size(i)) + int(coord[i])
    return idx


def ring_permutation(size: int) -> list[tuple[int, int]]:
    """Pairs of a one-step rotation along an axis: shard i's block moves to
    shard i+1 (mod size), so ``size`` rotations visit every block on every
    shard (the exchange schedule of ``engine.ring_sweep``)."""
    return [(i, (i + 1) % size) for i in range(size)]


def ring_block_rows(s: int, n_shards: int) -> int:
    """Rows of one ring block: the padded sample splits evenly, so every
    visiting block (and every hop) is the same ceil-to-multiple slice."""
    return (s + ((-s) % n_shards)) // n_shards


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on: its current CUDA device under a
    NCCL mesh, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def shard_rows(mesh: DeviceMesh, axes: Sequence[str], x: torch.Tensor) -> torch.Tensor:
    """This rank's row block of a full tensor or numpy array (a view). The
    row count must divide over the shards: pad first
    (``pad_rows_to_multiple``)."""
    n_shards = mesh_axis_size(mesh, axes)
    if x.shape[0] % n_shards:
        raise ValueError(f"{x.shape[0]} rows do not divide over {n_shards} shards")
    b = x.shape[0] // n_shards
    i = shard_index(mesh, axes)
    return x[i * b:(i + 1) * b]


def check_stream_shardable(stream, mesh: DeviceMesh, axes: Sequence[str]) -> None:
    """Streaming entry points shard each fixed-size chunk on arrival; the
    chunk row count must divide over the data shards."""
    n_shards = mesh_axis_size(mesh, axes)
    if stream.chunk % n_shards:
        raise ValueError(f"stream chunk {stream.chunk} must divide over {n_shards} shards")


def shard_stream(stream, mesh: DeviceMesh, axes: Sequence[str]):
    """The chunk stream as this rank sees it: every chunk cut to this rank's
    row block on arrival (``shard_rows``; ``start`` stays the chunk's first
    global row), so the streaming executor stages only this rank's rows
    onto its device. It keeps the source's n, dim and chunk: snapshots and
    fault triggers count the source's chunks."""
    from repro_torch.text.stream import CorpusStream

    check_stream_shardable(stream, mesh, axes)

    def chunks():
        for ch in stream.chunks():
            yield ch._replace(x=shard_rows(mesh, axes, ch.x), w=shard_rows(mesh, axes, ch.w))

    return CorpusStream(chunks, n=stream.n, dim=stream.dim, chunk=stream.chunk)


def pad_rows_to_multiple(
    x: torch.Tensor, multiple: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pad rows with zeros to a multiple of the shard count; returns
    (padded, weights). Weights are 1.0 for real rows and 0.0 for padding:
    every distributed job threads them, so padding never contributes."""
    n = x.shape[0]
    pad = (-n) % multiple
    w = torch.ones((n + pad,), dtype=torch.float32, device=x.device)
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        w[n:] = 0.0
    return x, w
