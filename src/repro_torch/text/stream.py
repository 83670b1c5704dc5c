"""Out-of-core corpus streaming, and the one executor every streaming pass
runs through.

A ``CorpusStream`` is a RE-ITERABLE stream of fixed-shape ``(chunk, dim)``
host blocks plus per-row weights (1.0 real / 0.0 padding; only the last
chunk is padded). Multi-pass algorithms (two-pass tf-idf, K-Means
iterations) recompute chunks instead of storing them, so peak residency is
O(chunk·d), never O(n·d). Port of the JAX package's ``text/stream.py``.

Consumers (core/kmeans, core/bkc, core/buckshot, core/sampling, text/tfidf)
duck-type on ``.chunks()`` / ``.n`` / ``.dim`` / ``.chunk`` and drive every
pass through ``run_pass``: a bounded double-buffered prefetcher whose
background thread regenerates chunk ``i+1`` while the caller's thread folds
chunk ``i`` on the device. When the fold runs on a CUDA device
(``copy_to``), the producer thread also stages each host chunk there: it
pins the block, copies it on a side stream, and the fold waits on that
copy's event, so the copy of chunk ``i+1`` overlaps the fold of chunk ``i``.
Mapped streams (``tfidf_stream``) issue their CUDA work from the producer
thread too, on the consumer's stream, so their chunks arrive in order
behind it. Chunk order and values are untouched: prefetch on and off give
the same bits. ``REPRO_STREAM_PREFETCH=0`` (or ``prefetch=0``) turns the
prefetcher off. ``CorpusStream.from_array(x)`` yields the whole array as one
chunk, and every streaming entry point run on it reproduces the resident
path. ``run_pass(checkpoint=...)`` snapshots the carry every N chunks
(``resilience/checkpoint.py``), so a killed pass resumes from its last
snapshot bit for bit.
"""

from __future__ import annotations

import math
import os
import queue
import threading
from typing import Any, Callable, Iterable, Iterator, NamedTuple, Sequence

import numpy as np
import torch


class StreamChunk(NamedTuple):
    """One fixed-shape block of the corpus.

    ``x`` and ``w`` are host numpy blocks for source streams; mapped streams
    (tf-idf pass 2) carry tensors already on the device, and the executor's
    producer may stage host blocks onto the fold's device."""

    x: Any  # (chunk, dim) f32 rows (padding rows all-zero)
    w: Any  # (chunk,) f32, 1.0 real / 0.0 padding
    start: int  # global row index of this chunk's first row


def host(a) -> np.ndarray:
    """A chunk field (numpy array or tensor on any device) on the host."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def to_device(a, device: torch.device) -> torch.Tensor:
    """A chunk field as a tensor on ``device``: a tensor already there is
    returned as it is; a host block is copied, without blocking the host
    when it is pinned."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    return t.to(device, non_blocking=True)


def _pad_block(block: np.ndarray, chunk: int) -> tuple[np.ndarray, np.ndarray]:
    r = block.shape[0]
    w = np.ones((r,), np.float32)
    if r < chunk:
        block = np.concatenate(
            [block, np.zeros((chunk - r,) + block.shape[1:], block.dtype)]
        )
        w = np.concatenate([w, np.zeros((chunk - r,), np.float32)])
    return block, w


class CorpusStream:
    """Re-iterable stream of fixed-shape corpus chunks.

    ``make_chunks`` returns a FRESH iterator of ``StreamChunk`` on every call
    (each pass over the stream regenerates the data — the out-of-core
    contract). Use the constructors below instead of calling this directly.
    """

    def __init__(
        self,
        make_chunks: Callable[[], Iterator[StreamChunk]],
        *,
        n: int,
        dim: int,
        chunk: int,
    ):
        if chunk <= 0:
            raise ValueError(f"chunk must be positive, got {chunk}")
        self._make_chunks = make_chunks
        self.n = int(n)
        self.dim = int(dim)
        self.chunk = int(chunk)

    @property
    def n_chunks(self) -> int:
        return -(-self.n // self.chunk)

    def chunks(self) -> Iterator[StreamChunk]:
        """A fresh pass over the stream."""
        return self._make_chunks()

    # ------------------------------------------------------------ builders

    @staticmethod
    def from_blocks(
        make_blocks: Callable[[], Iterable[np.ndarray]],
        *,
        n: int,
        dim: int,
        chunk: int,
    ) -> "CorpusStream":
        """Wrap a factory of raw row blocks (≤ chunk rows each, ``n`` total;
        only the final block may be short). Pads each block to the fixed
        chunk shape and threads the weights. The contract is ENFORCED — a
        short mid-stream block would put pad rows in the middle of the
        logical row order, which every consumer's tail-trim would silently
        mis-read as real documents."""

        def gen() -> Iterator[StreamChunk]:
            start = 0
            short_at = -1
            for block in make_blocks():
                r = block.shape[0]
                if short_at >= 0:
                    raise ValueError(
                        f"short block ({short_at} rows) before the final one:"
                        f" only the last block may have < {chunk} rows"
                    )
                if r > chunk:
                    raise ValueError(f"block of {r} rows exceeds chunk {chunk}")
                if r < chunk:
                    short_at = r
                x, w = _pad_block(np.asarray(block, np.float32), chunk)
                yield StreamChunk(x=x, w=w, start=start)
                start += r
            if start != n:
                raise ValueError(f"stream yielded {start} rows, declared n={n}")

        return CorpusStream(gen, n=n, dim=dim, chunk=chunk)

    @staticmethod
    def from_array(x, *, chunk: int | None = None) -> "CorpusStream":
        """Resident host array -> stream. ``chunk=None`` keeps the whole
        array as ONE chunk — the thin wrapper that makes every resident path
        a one-chunk specialization of the streaming path."""
        x = np.asarray(x, np.float32)
        n, dim = x.shape
        chunk = n if chunk is None else chunk

        def blocks() -> Iterator[np.ndarray]:
            for start in range(0, n, chunk):
                yield x[start : start + chunk]

        return CorpusStream.from_blocks(blocks, n=n, dim=dim, chunk=chunk)

    @staticmethod
    def from_texts(
        texts: Sequence[str], *, dim: int = 2048, chunk: int = 4096
    ) -> "CorpusStream":
        """Chunked hashing ingest: texts -> (chunk, dim) unsigned hashed token
        count blocks (text/hashing.vectorize_chunks)."""
        from repro_torch.text import hashing

        return CorpusStream.from_blocks(
            lambda: hashing.vectorize_chunks(texts, dim, chunk=chunk),
            n=len(texts),
            dim=dim,
            chunk=chunk,
        )

    # ------------------------------------------------------------ transforms

    def map(self, fn: Callable, *, dim: int | None = None) -> "CorpusStream":
        """Lazily transform every chunk: ``fn(x, w) -> x'`` (same row count;
        fn is applied per chunk on arrival, e.g. the tf-idf pass-2 rescale
        on the device)."""

        def gen() -> Iterator[StreamChunk]:
            for ch in self.chunks():
                yield ch._replace(x=fn(ch.x, ch.w))

        return CorpusStream(
            gen, n=self.n, dim=self.dim if dim is None else dim, chunk=self.chunk
        )

    def concat(self, *others: "CorpusStream") -> "CorpusStream":
        """``concat_streams(self, *others)`` with this stream's chunk size."""
        return concat_streams(self, *others, chunk=self.chunk)

    def materialize(self) -> np.ndarray:
        """Concatenate the stream back into a resident (n, dim) host array —
        tests/oracles only; defeats the point everywhere else."""
        parts = [host(ch.x) for ch in self.chunks()]
        if not parts:  # an n == 0 stream yields no chunks
            return np.zeros((0, self.dim), np.float32)
        return np.concatenate(parts, axis=0)[: self.n]


def concat_streams(*streams, chunk: int | None = None) -> "CorpusStream":
    """Concatenate row streams into ONE fixed-chunk stream.

    Chunks are re-packed: padding rows (w == 0) are stripped and real rows
    re-blocked at the target chunk size, preserving global row order. The
    result is re-iterable like any stream and byte-identical to a single
    stream built over the concatenated rows with the same chunk size, so
    every downstream fold matches that stream bit for bit.
    """
    if not streams:
        raise ValueError("concat_streams needs at least one stream")
    dims = {s.dim for s in streams}
    if len(dims) != 1:
        raise ValueError(f"streams disagree on dim: {sorted(dims)}")
    dim = dims.pop()
    chunk = int(chunk if chunk is not None else streams[0].chunk)
    n = sum(s.n for s in streams)

    def blocks() -> Iterator[np.ndarray]:
        buf: list[np.ndarray] = []
        have = 0
        for s in streams:
            for ch in s.chunks():
                rows = host(ch.x).astype(np.float32, copy=False)[host(ch.w) > 0]
                if rows.shape[0] == 0:
                    continue
                buf.append(rows)
                have += rows.shape[0]
                while have >= chunk:
                    block = buf[0] if len(buf) == 1 else np.concatenate(buf)
                    yield block[:chunk]
                    rest = block[chunk:]
                    buf = [rest] if rest.shape[0] else []
                    have = rest.shape[0]
        if have:
            yield buf[0] if len(buf) == 1 else np.concatenate(buf)

    return CorpusStream.from_blocks(blocks, n=n, dim=dim, chunk=chunk)


# ------------------------------------------------------------------ executor


class _Raise:
    """Producer-side exception, carried through the queue and re-raised on
    the consumer thread (the from_blocks contract checks must surface)."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


_END = object()  # producer-exhausted sentinel


class _CardStager:
    """Stages host chunks onto a CUDA device from the producer thread.

    Built on the consumer's thread, it captures the consumer's current
    stream: the producer runs the stream's own CUDA work (a mapped chunk's
    rescale) on that stream, so it is ordered before the fold that reads it.
    Each host numpy field (x, w) is pinned and copied on a side stream, and
    an event marks the copy's end; ``arrive`` (consumer side) makes the
    consumer's stream wait for that event and records the stream on the
    copies, so the caching allocator does not hand their memory to the side
    stream while the fold still reads it."""

    def __init__(self, device: torch.device):
        self.device = device
        self.main = torch.cuda.current_stream(device)
        self.side = torch.cuda.Stream(device)

    def producer_context(self):
        return torch.cuda.stream(self.main)

    def stage(self, item: tuple[int, StreamChunk]):
        ci, ch = item
        fields = {}
        with torch.cuda.stream(self.side):
            for name in ("x", "w"):
                a = getattr(ch, name)
                if isinstance(a, np.ndarray):
                    pinned = torch.from_numpy(a).pin_memory()
                    fields[name] = pinned.to(self.device, non_blocking=True)
            if not fields:
                return item, None
            done = torch.cuda.Event()
            done.record(self.side)
        return (ci, ch._replace(**fields)), (done, tuple(fields.values()))

    def arrive(self, staged):
        item, ticket = staged
        if ticket is not None:
            done, tensors = ticket
            self.main.wait_event(done)
            for t in tensors:
                t.record_stream(self.main)
        return item


class _PrefetchIter:
    """Iterator over ``source`` with up to ``depth`` items produced ahead by
    a daemon thread. ``close()`` stops the producer early (abandoned pass).

    ``timeout`` arms the consumer-side watchdog: if the producer goes silent
    past the deadline, ``__next__`` raises ``queue.Empty`` (run_pass maps it
    to ``StreamTimeout`` with pass/chunk attribution) instead of blocking the
    pass forever behind a wedged generator. ``stager`` (a ``_CardStager``)
    stages every item onto the fold's CUDA device in the producer thread."""

    def __init__(
        self,
        source: Iterator[Any],
        depth: int,
        *,
        timeout: float | None = None,
        stager: _CardStager | None = None,
    ):
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._done = False
        self._timeout = timeout
        self._stager = stager
        self._thread = threading.Thread(
            target=self._produce, args=(source,), daemon=True,
            name="corpus-stream-prefetch",
        )
        self._thread.start()

    def _produce(self, source: Iterator[Any]) -> None:
        try:
            if self._stager is None:
                for item in source:
                    if not self._put(item):
                        return  # consumer closed the pass
            else:
                with self._stager.producer_context():
                    for item in source:
                        if not self._put(self._stager.stage(item)):
                            return
            self._put(_END)
        except BaseException as e:  # noqa: BLE001 — forwarded, not swallowed
            self._put(_Raise(e))

    def _put(self, item: Any) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self) -> "_PrefetchIter":
        return self

    def __next__(self) -> Any:
        if self._done:
            raise StopIteration
        # watchdog: queue.Empty escapes to run_pass, which owns attribution
        item = self._q.get(timeout=self._timeout)
        if item is _END:
            self._done = True
            self._thread.join()
            raise StopIteration
        if isinstance(item, _Raise):
            self._done = True
            self._thread.join()
            raise item.exc
        return item if self._stager is None else self._stager.arrive(item)

    def close(self) -> None:
        """Stop the producer without draining the pass (early exit)."""
        if self._done:
            return
        self._done = True
        self._stop.set()
        while True:  # unblock a producer stuck in put()
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)

    def __del__(self) -> None:  # pragma: no cover — GC safety net
        try:
            self.close()
        except Exception:
            pass


def _resolve_prefetch(prefetch: Any) -> int:
    """Prefetch depth: explicit arg wins, else ``REPRO_STREAM_PREFETCH``
    (unset -> 2, the double buffer; 0/'off' disables — the bench switch)."""
    if prefetch is None:
        env = os.environ.get("REPRO_STREAM_PREFETCH", "").strip().lower()
        if env in ("", "on", "true"):
            return 2
        if env in ("off", "false"):
            return 0
        try:
            return max(0, int(env))
        except ValueError:
            raise ValueError(
                f"REPRO_STREAM_PREFETCH={env!r}: expected an integer depth"
                " (0 disables) or on/true/off/false"
            ) from None
    if prefetch is True:
        return 2
    if prefetch is False:
        return 0
    return max(0, int(prefetch))


def iter_chunks(stream, *, prefetch: Any = None) -> Iterator[StreamChunk]:
    """A fresh prefetched pass over any ``.chunks()`` duck-typed stream.

    Each call opens a NEW pass (fresh generator, fresh prefetch thread), so
    multi-pass algorithms see fresh chunks and never an exhausted
    iterator."""
    it = stream.chunks()
    depth = _resolve_prefetch(prefetch)
    if depth <= 0:
        return it
    return _PrefetchIter(it, depth)


def _chunk_source(
    stream, pass_id: str, policy, start_chunk: int
) -> Iterator[tuple[int, StreamChunk]]:
    """Producer generator: ``(chunk_index, chunk)`` pairs with per-chunk
    retry and fault injection applied.

    Chunks below ``start_chunk`` (already folded into a restored snapshot's
    carry) are regenerated and pass through the fault plan, so ``@gN``
    counts them, but they are never yielded: never folded, never staged to
    the card. A producer exception at chunk ``ci`` re-opens the pass (fresh
    ``stream.chunks()``), fast-forwards to ``ci``, and retries after
    exponential backoff; past the budget the original error surfaces
    (retries=0, fail fast) or a StreamFault with chunk attribution
    (retries>0, the cause chained)."""
    from repro_torch.testing import faults as _faults

    def opened(skip: int) -> Iterator[tuple[int, StreamChunk]]:
        plan = _faults.active()
        for ci, ch in enumerate(stream.chunks()):
            if plan is not None:
                ch = plan.on_chunk(pass_id, ci, ch)
            if ci < skip:
                continue
            yield ci, ch

    ci = start_chunk
    attempts = 0
    it = opened(start_chunk)
    while True:
        try:
            item = next(it)
        except StopIteration:
            return
        except Exception as e:
            attempts += 1
            if attempts > policy.retries:
                if policy.retries == 0:
                    raise  # fail-fast: surface the original error unwrapped
                from repro_torch.resilience import StreamFault

                raise StreamFault(pass_id, ci, attempts, e) from e
            policy.sleep(attempts)
            it = opened(ci)  # replay up to the failed chunk, then retry it
        else:
            ci = item[0] + 1
            attempts = 0
            yield item


def _leaves(tree: Any) -> Iterator[Any]:
    """The leaves of a carry: tuples (NamedTuples too), lists and dicts are
    walked, everything else is a leaf."""
    if isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _leaves(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _leaves(t)
    else:
        yield tree


def _carry_finite(carry: Any, seen: set | None = None) -> bool:
    """All floating leaves of the carry are finite. A tensor leaf reduces to
    one flag where it lies (only the flag syncs to the host).

    ``seen`` memoizes verified HOST numpy arrays by identity across folds:
    collected per-chunk output blocks accumulate in carry lists but never
    mutate, so re-scanning them every chunk would make the guard
    O(chunks²) over a pass. Tensor leaves are always re-checked (the
    running accumulators DO change)."""
    for leaf in _leaves(carry):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
                return False
        elif isinstance(leaf, np.ndarray):
            if seen is not None and id(leaf) in seen:
                continue
            if np.issubdtype(leaf.dtype, np.inexact) and not np.all(np.isfinite(leaf)):
                return False
            if seen is not None:
                seen.add(id(leaf))
        elif isinstance(leaf, float):
            if not math.isfinite(leaf):
                return False
    return True


def _pass_device(carry: Any, copy_to) -> torch.device | None:
    """The device a pass folds on: ``copy_to``, else the first tensor leaf's
    device of the initial carry (None for a host-only carry)."""
    if copy_to is not None:
        return torch.device(copy_to)
    return next((t.device for t in _leaves(carry) if isinstance(t, torch.Tensor)), None)


def run_pass(
    stream,
    fold: Callable,
    carry: Any,
    *,
    copy_to: torch.device | None = None,
    prefetch: Any = None,
    pass_id: str = "pass",
    checkpoint: Any = None,
    retry: Any = None,
    timeout: Any = None,
    guard: Any = None,
    meta: dict | None = None,
    restore_carry: Callable | None = None,
):
    """One full pass over ``stream``: ``fold(carry, chunk, index) -> carry``.

    ``fold`` runs on the caller's thread while the prefetcher's background
    thread regenerates the next chunk. Returns the final carry (the initial
    ``carry`` for an n == 0 stream). The pass is closed on any exit, so a
    fold that raises does not leave a producer thread spinning.

      copy_to     the device the fold works on. A CUDA device makes the
                  prefetch producer pin each host chunk and copy it there on
                  a side stream (the fold then receives tensors on the card;
                  without prefetch it copies them itself, ``to_device``).
      pass_id     names the pass in checkpoint keys and error attribution.
      checkpoint  a ``resilience.Checkpointer``: the carry is snapshotted
                  after every ``checkpoint.every`` folded chunks (not after
                  the last); on entry a matching snapshot restores the carry
                  and the producer skips the chunks already folded, so a
                  killed pass resumes bit for bit. The snapshot is deleted
                  when the pass completes.
      retry       RetryPolicy | int budget | None (env REPRO_STREAM_RETRIES;
                  default 0 = fail fast with the original exception).
      timeout     producer watchdog seconds (env REPRO_STREAM_TIMEOUT;
                  default off) -> StreamTimeout instead of a hang. Forces the
                  source through a (depth >= 1) prefetch thread so the
                  deadline can be enforced from the consumer side.
      guard       'finite' (env REPRO_STREAM_GUARD) checks every floating
                  carry leaf after each fold -> GuardError(pass, chunk).
      meta        extra snapshot-validity keys beside the stream's
                  signature: a snapshot folded under other centers or draws
                  must not resume this pass.
      restore_carry  snapshot carry -> live carry, replacing the default
                  restore (a distributed fold re-places its leaves).

    The snapshot's meta also holds the pass's device type (``copy_to``, else
    the initial carry's), a key the JAX package's snapshots do not have: f32
    adds run in another order on another device, so a snapshot taken on the
    card cold-starts a CPU pass and the reverse. A restored leaf goes to the
    pass's device, not to the device its snapshot names.
    """
    from repro_torch.resilience import policy as _policy

    policy = _policy.RetryPolicy.resolve(retry)
    wd = _policy.resolve_timeout(timeout)
    guard = _policy.resolve_guard(guard)

    start_chunk = 0
    if checkpoint is not None:
        from repro_torch.resilience.checkpoint import (
            carry_fingerprint,
            carry_from_host,
            carry_to_host,
        )

        dev = _pass_device(carry, copy_to)
        fingerprint = carry_fingerprint(carry)
        full_meta = {
            "stream": {"n": stream.n, "dim": stream.dim, "chunk": stream.chunk},
            "device": "cpu" if dev is None else dev.type,
            **(meta or {}),
        }
        snap = checkpoint.load(pass_id, fingerprint=fingerprint, meta=full_meta)
        if snap is not None:
            if restore_carry is not None:
                carry = restore_carry(snap["carry"])
            else:
                carry = carry_from_host(snap["carry"], device=dev)
            start_chunk = snap["chunk"]

    source = _chunk_source(stream, pass_id, policy, start_chunk)
    depth = _resolve_prefetch(prefetch)
    if wd is not None:
        depth = max(depth, 1)  # the watchdog needs the producer on a thread
    stager = (
        _CardStager(copy_to)
        if copy_to is not None and torch.device(copy_to).type == "cuda" and depth > 0
        else None
    )
    it: Any = (
        _PrefetchIter(source, depth, timeout=wd, stager=stager)
        if depth > 0 else source
    )
    expect = start_chunk
    guard_seen: set | None = set() if guard == "finite" else None
    try:
        while True:
            try:
                item = next(it)
            except StopIteration:
                break
            except queue.Empty:
                from repro_torch.resilience import StreamTimeout

                raise StreamTimeout(pass_id, expect, wd) from None
            ci, ch = item
            carry = fold(carry, ch, ci)
            if guard == "finite" and not _carry_finite(carry, guard_seen):
                from repro_torch.resilience import GuardError

                raise GuardError(pass_id, ci)
            expect = ci + 1
            if (
                checkpoint is not None
                and expect % checkpoint.every == 0
                and expect < stream.n_chunks
            ):
                checkpoint.save(
                    pass_id,
                    chunk=expect,
                    carry_host=carry_to_host(carry),
                    fingerprint=fingerprint,
                    meta=full_meta,
                )
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()
    if checkpoint is not None:
        checkpoint.delete(pass_id)  # the pass completed: its snapshot is stale
    return carry
