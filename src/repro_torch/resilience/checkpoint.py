"""Checkpointed streaming passes: the port's copy of the JAX package's
``resilience/checkpoint.py``.

Every streaming pass folds a monoid, so the carry after chunk i is a
COMPLETE mid-pass state: snapshotting ``(pass_id, next_chunk, carry)`` every
N chunks and replaying chunks ``>= next_chunk`` on restart reproduces the
uninterrupted pass bit for bit (the f32 folds re-execute the same adds in
the same order; per-chunk draws are pure functions of the chunk index, so
nothing else needs saving).

Two stores share one format:
  ``MemoryCheckpointer``  an in-process dict (tests, warm restarts within
                          one process)
  ``DiskCheckpointer``    one pickle file per key under a job directory,
                          written atomically (tmp + ``fsync`` +
                          ``os.replace`` + directory ``fsync``), so a
                          SIGKILL mid-write never leaves a torn snapshot

Invalidation is structural: a snapshot is ignored unless its carry
FINGERPRINT (tensor shapes and dtypes, list contents collapsed: lists grow
as collected per-chunk outputs accumulate) and its caller's META (stream
signature, centers or draw digests, the pass's device type) both match the
restarting pass. A torn, corrupt or mismatched record degrades to a cold
start, never to an exception or a silently wrong carry.

Multi-pass fits also store PASS RESULTS (``save_result``): the finished
output of each pass (the centers after K-Means iteration i), so a restart
skips completed passes and replays only the killed one from its last
snapshot.

The format version, the ``snap/`` and ``result/`` key namespaces, the
fingerprint strings and ``array_token`` are the reference's: a carry of
tensors fingerprints as the same shapes in numpy would, and a tensor's token
equals the token of the same numpy array. Tensor leaves are held on the host
as numpy copies with their dtype and device (``_DeviceLeaf``) and walked by
the port's own tree walk over dicts, tuples, NamedTuples and lists.

``RankCheckpointer`` has no counterpart in the JAX package, whose single
controller writes one snapshot of the whole mesh: under ``torch.distributed``
every rank runs the driver, so it is the view of a store that one rank of
the group uses (see its docstring).
"""

from __future__ import annotations

import hashlib
import os
import pickle
import re
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

_FORMAT_VERSION = 1


class _DeviceLeaf:
    """Host stand-in for a tensor carry leaf (picklable): its values as a
    numpy array, its dtype and the device it lay on."""

    __slots__ = ("value", "dtype", "device")

    def __init__(self, value: np.ndarray, dtype: torch.dtype, device: str):
        self.value = value
        self.dtype = dtype
        self.device = device


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name for a torch dtype: torch names its dtypes as numpy does
    (``torch.float32`` -> ``float32``, ``torch.bool`` -> ``bool``), and
    ``bfloat16`` is the name numpy's bfloat16 extension type carries."""
    return str(dtype).removeprefix("torch.")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor's values on the host, exactly (bfloat16, which numpy lacks,
    as its 16-bit patterns)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _tree_map(fn: Callable[[Any], Any], tree: Any, is_leaf: Callable[[Any], bool]) -> Any:
    """``fn`` over the leaves of a carry: dicts, tuples (NamedTuples keep
    their class) and lists are walked, everything else is a leaf."""
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, tuple):
        items = [_tree_map(fn, t, is_leaf) for t in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    if isinstance(tree, list):
        return [_tree_map(fn, t, is_leaf) for t in tree]
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, is_leaf) for k, v in tree.items()}
    return tree


def carry_to_host(carry: Any) -> Any:
    """Carry -> picklable host tree (tensor leaves -> ``_DeviceLeaf``).

    The copy of an f32 tensor to numpy is exact, so the round trip through
    a snapshot keeps every accumulator bit. A CUDA leaf's copy waits for the
    work that produced it."""
    return _tree_map(
        lambda t: _DeviceLeaf(_to_numpy(t), t.dtype, str(t.device)),
        carry,
        lambda v: isinstance(v, torch.Tensor),
    )


def carry_from_host(host: Any, *, device: str | torch.device | None = None) -> Any:
    """Inverse of ``carry_to_host``: each ``_DeviceLeaf`` becomes a tensor of
    its dtype on ``device``, or on the device it was taken from when
    ``device`` is None."""

    def restore(leaf: _DeviceLeaf) -> torch.Tensor:
        t = torch.from_numpy(leaf.value)
        if leaf.dtype == torch.bfloat16:
            t = t.view(torch.bfloat16)
        return t.to(leaf.device if device is None else device)

    return _tree_map(restore, host, lambda v: isinstance(v, _DeviceLeaf))


def carry_fingerprint(carry: Any) -> str:
    """Structural signature of a carry: array shapes and dtypes, container
    shape.

    List CONTENTS are collapsed to ``[*]``: collected per-chunk outputs live
    in lists that grow every fold, so a snapshot taken at chunk i must still
    match the (empty-list) initial carry of the restarting pass."""

    def sig(obj: Any) -> str:
        if isinstance(obj, torch.Tensor):
            return f"a{tuple(obj.shape)}:{_dtype_name(obj.dtype)}"
        if isinstance(obj, np.ndarray):
            return f"a{tuple(obj.shape)}:{obj.dtype.name}"
        if isinstance(obj, dict):
            items = ",".join(f"{k}={sig(v)}" for k, v in sorted(obj.items()))
            return "{" + items + "}"
        if isinstance(obj, tuple):
            # NamedTuples are tagged by class name: a carry layout change
            # that swaps a plain tuple for a typed one must invalidate old
            # snapshots, not restore into the wrong structure
            tag = type(obj).__name__ if hasattr(obj, "_fields") else ""
            return tag + "(" + ",".join(sig(v) for v in obj) + ")"
        if isinstance(obj, list):
            return "[*]"
        return type(obj).__name__

    return sig(carry)


def array_token(arr: Any) -> str:
    """Content digest of an array or tensor: binds a snapshot to the state
    it was folded under (centers, draws), not just to its shape. A tensor's
    token is the token of the same values as a numpy array."""
    if isinstance(arr, torch.Tensor):
        a, name = np.ascontiguousarray(_to_numpy(arr)), _dtype_name(arr.dtype)
    else:
        a = np.ascontiguousarray(np.asarray(arr))
        name = str(a.dtype)
    return hashlib.sha1(a.tobytes() + name.encode()).hexdigest()


class Checkpointer:
    """Snapshot store base class; subclasses provide ``_put/_get/_del``.

    ``every`` is the snapshot cadence in chunks. Mid-pass snapshots and pass
    results share the store under distinct key namespaces."""

    def __init__(self, *, every: int = 8):
        if every <= 0:
            raise ValueError(f"checkpoint cadence must be positive, got {every}")
        self.every = int(every)

    # -- storage primitives (override) ------------------------------------
    def _put(self, key: str, payload: bytes) -> None:
        raise NotImplementedError

    def _get(self, key: str) -> bytes | None:
        raise NotImplementedError

    def _del(self, key: str) -> None:
        raise NotImplementedError

    def _state(self, key: str, pass_id: str, meta: dict | None) -> dict | None:
        """The record under ``key`` iff it unpickles to this format, pass id
        and meta; anything else reads as absent."""
        raw = self._get(key)
        if raw is None:
            return None
        try:
            state = pickle.loads(raw)
        except Exception:
            return None
        if (
            not isinstance(state, dict)
            or state.get("version") != _FORMAT_VERSION
            or state.get("pass_id") != pass_id
            or state.get("meta") != (meta or {})
        ):
            return None
        return state

    # -- mid-pass snapshots ------------------------------------------------
    def save(
        self,
        pass_id: str,
        *,
        chunk: int,
        carry_host: Any,
        fingerprint: str,
        meta: dict | None = None,
    ) -> None:
        state = {
            "version": _FORMAT_VERSION,
            "pass_id": pass_id,
            "chunk": int(chunk),
            "carry": carry_host,
            "fingerprint": fingerprint,
            "meta": meta or {},
        }
        self._put(f"snap/{pass_id}", pickle.dumps(state, protocol=4))

    def load(
        self, pass_id: str, *, fingerprint: str, meta: dict | None = None
    ) -> dict | None:
        """The snapshot dict iff it matches this pass, else None: a torn,
        corrupt or mismatched snapshot is a cold start."""
        state = self._state(f"snap/{pass_id}", pass_id, meta)
        if state is None or state.get("fingerprint") != fingerprint:
            return None
        return state

    def delete(self, pass_id: str) -> None:
        """Drop the mid-pass snapshot (the pass completed)."""
        self._del(f"snap/{pass_id}")

    # -- pass-level results ------------------------------------------------
    def save_result(self, pass_id: str, value: Any, *, meta: dict | None = None) -> None:
        """Record a completed pass's output so a restart skips the pass."""
        state = {
            "version": _FORMAT_VERSION,
            "pass_id": pass_id,
            "value": carry_to_host(value),
            "meta": meta or {},
        }
        self._put(f"result/{pass_id}", pickle.dumps(state, protocol=4))

    def load_result(
        self,
        pass_id: str,
        *,
        meta: dict | None = None,
        device: str | torch.device | None = None,
    ) -> Any | None:
        """The stored result iff it matches, its tensors on ``device`` (None:
        where they were taken)."""
        state = self._state(f"result/{pass_id}", pass_id, meta)
        if state is None:
            return None
        return carry_from_host(state["value"], device=device)

    def delete_result(self, pass_id: str) -> None:
        """Drop a stored pass result (the whole run completed)."""
        self._del(f"result/{pass_id}")

    # -- composition -------------------------------------------------------
    def scoped(self, prefix: str) -> "Checkpointer":
        """A view that prefixes every pass id: nested fits (Buckshot's
        phase-2 K-Means) checkpoint under their own namespace in one store."""
        return _ScopedCheckpointer(self, prefix)


class _ScopedCheckpointer(Checkpointer):
    def __init__(self, parent: Checkpointer, prefix: str):
        super().__init__(every=parent.every)
        self._parent = parent
        self._prefix = prefix.rstrip("/")

    def _key(self, key: str) -> str:
        kind, _, pid = key.partition("/")
        return f"{kind}/{self._prefix}/{pid}"

    def _put(self, key: str, payload: bytes) -> None:
        self._parent._put(self._key(key), payload)

    def _get(self, key: str) -> bytes | None:
        return self._parent._get(self._key(key))

    def _del(self, key: str) -> None:
        self._parent._del(self._key(key))


class MemoryCheckpointer(Checkpointer):
    """In-process snapshot store (tests; warm restarts within one process)."""

    def __init__(self, *, every: int = 8):
        super().__init__(every=every)
        self._store: dict[str, bytes] = {}

    def _put(self, key: str, payload: bytes) -> None:
        self._store[key] = payload

    def _get(self, key: str) -> bytes | None:
        return self._store.get(key)

    def _del(self, key: str) -> None:
        self._store.pop(key, None)

    def clear(self) -> None:
        self._store.clear()


def _safe_name(key: str) -> str:
    """Filesystem name for a store key: readable slug + collision-proof hash."""
    slug = re.sub(r"[^A-Za-z0-9_.-]+", "_", key)[:80]
    return f"{slug}.{hashlib.sha1(key.encode()).hexdigest()[:12]}.ckpt"


class DiskCheckpointer(Checkpointer):
    """One atomically written pickle file per key under a job directory.

    The directory is PER JOB: two jobs sharing a directory with identical
    pass ids, carry shapes and meta would resume from each other's state
    (the fingerprint and meta checks catch shape and parameter drift, not
    same-shaped different data)."""

    def __init__(self, directory: str | os.PathLike, *, every: int = 8):
        super().__init__(every=every)
        self.directory = os.fspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.directory, _safe_name(key))

    def _put(self, key: str, payload: bytes) -> None:
        path = self._path(key)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)  # atomic: a kill mid-write leaves only the tmp
        # the rename lives in the directory inode: fsync it too, or a crash
        # after the replace can roll the entry back
        self._fsync_dir()

    def _fsync_dir(self) -> None:
        try:
            fd = os.open(self.directory, os.O_RDONLY)
        except OSError:
            return  # platforms that refuse O_RDONLY on directories
        try:
            os.fsync(fd)
        except OSError:
            pass  # best effort on filesystems without directory fsync
        finally:
            os.close(fd)

    def _get(self, key: str) -> bytes | None:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except OSError:
            return None

    def _del(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except OSError:
            pass

    def clear(self) -> None:
        for name in os.listdir(self.directory):
            if name.endswith(".ckpt"):
                try:
                    os.remove(os.path.join(self.directory, name))
                except OSError:
                    pass


class RankCheckpointer(Checkpointer):
    """One rank's view of a store, for drivers that every rank of the
    default ``torch.distributed`` group runs (SPMD).

    Snapshots. A fold pass's carry is this rank's partial, so each rank
    writes its own snapshot under the scope ``rank{r}``. A kill can land
    between two ranks' writes and leave snapshots of different chunks, so
    ``load`` is a collective: the ranks all-reduce the chunk of what they
    loaded (-1 for none) to its min and max, and resume only if every rank
    holds a snapshot of the same chunk; otherwise every rank cold-starts.
    With ``shared=True`` the snapshot is replicated state (the distributed
    Borůvka loop): rank 0 alone writes and deletes it, and ``load``
    broadcasts rank 0's record.

    Pass results are replicated: rank 0 alone writes and deletes them (two
    writers would race on one file of a shared ``DiskCheckpointer``
    directory), and ``load_result`` broadcasts rank 0's record, so every
    rank takes the same branch even when each rank holds its own
    ``MemoryCheckpointer``. Every call of ``load`` and ``load_result`` is a
    collective of the whole group: every rank makes it, in the same order.
    """

    def __init__(self, parent: Checkpointer, *, shared: bool = False):
        super().__init__(every=parent.every)
        self.parent = parent
        self.shared = shared
        self.rank = dist.get_rank()

    @classmethod
    def of(cls, checkpoint: Checkpointer | None, *, shared: bool = False):
        """``checkpoint`` as a RankCheckpointer (None stays None)."""
        if checkpoint is None:
            return None
        if isinstance(checkpoint, RankCheckpointer):
            checkpoint = checkpoint.parent
        return cls(checkpoint, shared=shared)

    def _own(self) -> Checkpointer:
        return self.parent if self.shared else self.parent.scoped(f"rank{self.rank}")

    def _writes(self) -> bool:
        return not self.shared or self.rank == 0

    def save(self, pass_id, *, chunk, carry_host, fingerprint, meta=None) -> None:
        if self._writes():
            self._own().save(pass_id, chunk=chunk, carry_host=carry_host,
                             fingerprint=fingerprint, meta=meta)

    def load(self, pass_id, *, fingerprint, meta=None):
        if self.shared:
            return _broadcast(
                self.parent.load(pass_id, fingerprint=fingerprint, meta=meta)
                if self.rank == 0 else None
            )
        snap = self._own().load(pass_id, fingerprint=fingerprint, meta=meta)
        lo, hi = _agree(-1 if snap is None else int(snap["chunk"]))
        return snap if lo == hi >= 0 else None

    def delete(self, pass_id) -> None:
        if self._writes():
            self._own().delete(pass_id)

    def save_result(self, pass_id, value, *, meta=None) -> None:
        if self.rank == 0:
            self.parent.save_result(pass_id, value, meta=meta)

    def load_result(self, pass_id, *, meta=None, device=None):
        state = (
            self.parent._state(f"result/{pass_id}", pass_id, meta) if self.rank == 0 else None
        )
        state = _broadcast(state)
        return None if state is None else carry_from_host(state["value"], device=device)

    def delete_result(self, pass_id) -> None:
        if self.rank == 0:
            self.parent.delete_result(pass_id)

    def scoped(self, prefix: str) -> "RankCheckpointer":
        return RankCheckpointer(self.parent.scoped(prefix), shared=self.shared)


def _broadcast(obj: Any) -> Any:
    """Rank 0's ``obj`` on every rank of the default group."""
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _agree(chunk: int) -> tuple[int, int]:
    """(min, max) of ``chunk`` over the default group: one MAX all-reduce of
    (chunk, -chunk), on the card under NCCL."""
    dev = (
        torch.device("cuda", torch.cuda.current_device())
        if dist.get_backend() == "nccl" else torch.device("cpu")
    )
    t = torch.tensor([chunk, -chunk], dtype=torch.int64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    hi, neg_lo = (int(v) for v in t.cpu())
    return -neg_lo, hi
