"""Fault-tolerant checkpointing: atomic per-step directories + manifest,
latest-checkpoint discovery, restore onto a device or, elastically, onto
any mesh (``shardings=``).

The port of the JAX package's ``train/checkpoint.py``, in its format:

  <dir>/step_000120/
      manifest.json   {step, treedef, n_leaves, meta}
      arrays.npz      flat leaves keyed by index
      .complete       written LAST -> crash-safe marker

A tree is a nested dict of tensors or numpy arrays, flattened as JAX
flattens a dict (keys sorted at every level), so the npz keys are the
reference's leaf indices: ``{"params": ..., "opt": {"m", "step", "v"}}``
with layer weights stacked on axis 0 (``LM.stacked``) writes the same file
as the reference's train loop, and a checkpoint written by either package
restores in the other. A directory is written under ``.tmp_*`` and renamed
into place; a second save of a step replaces the first.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any

import numpy as np
import torch

from repro_torch.common import resolve_device
from repro_torch.models.common import leaves


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _treedef(tree: Any) -> str:
    """The structure as JAX prints a PyTreeDef of nested dicts."""

    def node(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {node(t[k])}" for k in sorted(t)) + "}"
        return "*"

    return f"PyTreeDef({node(tree)})"


def _unflatten(paths: list, flat: list) -> dict:
    out: dict = {}
    for path, x in zip(paths, flat):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = x
    return out


def save(ckpt_dir: str, step: int, tree: Any, meta: dict | None = None) -> str:
    """Atomically write a checkpoint; returns its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        flat = [x for _, x in leaves(tree)]
        arrays = {str(i): _numpy(x) for i, x in enumerate(flat)}
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {
            "step": step,
            "treedef": _treedef(tree),
            "n_leaves": len(flat),
            "meta": meta or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, ".complete"), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def latest_step(ckpt_dir: str) -> int | None:
    """Newest COMPLETE checkpoint step (incomplete ones are ignored)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and os.path.exists(os.path.join(ckpt_dir, name, ".complete")):
            steps.append(int(name[5:]))
    return max(steps) if steps else None


def restore(
    ckpt_dir: str,
    step: int,
    tree_like: Any,
    device: str | torch.device | None = None,
    shardings: Any = None,
) -> dict:
    """The checkpoint at ``step`` in the structure of ``tree_like``, each leaf
    in its stored dtype: tensors on ``device`` (``None`` means the CUDA
    device), or, with ``shardings``, DTensors. ``shardings`` is a tree of
    ``models.common.NamedSharding`` in the same structure (``sharding_tree``
    gives one): the elastic restore, which places each leaf on that mesh
    whatever mesh wrote the checkpoint (a checkpoint holds whole arrays, so
    every rank cuts its own shard and nothing is sent). Pass ``device`` or
    ``shardings``, not both."""
    if device is not None and shardings is not None:
        raise ValueError("restore: pass device= or shardings=, not both")
    dev = resolve_device(device) if shardings is None else torch.device("cpu")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    paths = [p for p, _ in leaves(tree_like)]
    with np.load(os.path.join(path, "arrays.npz")) as data:
        if len(paths) != len(data.files):
            raise ValueError(f"checkpoint has {len(data.files)} leaves, expected {len(paths)}")
        flat = [torch.from_numpy(data[str(i)]).to(dev) for i in range(len(paths))]
    if shardings is not None:
        flat = [_place(x, _at(shardings, p)) for p, x in zip(paths, flat)]
    return _unflatten(paths, flat)


def _at(tree: Any, path: tuple[str, ...]) -> Any:
    for key in path:
        tree = tree[key]
    return tree


def _place(x: torch.Tensor, sharding) -> torch.Tensor:
    """A whole leaf -> its DTensor on ``sharding.mesh`` (this rank's shard)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distrib.sharding import mesh_device

    return distribute_tensor(
        x.to(mesh_device(sharding.mesh)), sharding.mesh, sharding.placements, src_data_rank=None
    )


def restore_latest(
    ckpt_dir: str,
    tree_like: Any,
    device: str | torch.device | None = None,
    shardings: Any = None,
):
    """(tree, step) of the newest complete checkpoint, or (None, None);
    ``device`` and ``shardings`` as ``restore`` takes them."""
    step = latest_step(ckpt_dir)
    if step is None:
        return None, None
    return restore(ckpt_dir, step, tree_like, device, shardings), step
