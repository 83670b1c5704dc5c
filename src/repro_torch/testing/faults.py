"""Deterministic fault injection for the streaming/resilience layer.

The port's own copy of the JAX package's numpy-only ``testing/faults.py``,
without its ``pallas`` kind: the port's kernel dispatch has no fallback for
a fault to exercise, so ``pallasx2`` is rejected as an unknown kind. The
same spec strings give the same plans otherwise.

A ``FaultPlan`` is a list of faults, each armed at a deterministic trigger
point, parsed from a compact spec (the ``REPRO_FAULTS`` env var or
``FaultPlan.from_spec``):

  kind        effect at the trigger point
  ----        -------------------------------------------------------------
  raise       producer raises ``InjectedFault`` (exercises retry/fail-fast)
  nan / inf   chunk block's first row corrupted with NaN / Inf (guard path)
  stall:T     producer sleeps T seconds before yielding (watchdog path)
  kill        ``SIGKILL`` the process (checkpoint/resume path)

Chunk faults address their trigger as ``@cI`` (chunk index I within ANY pass
— every pass re-counts from 0) or ``@gN`` (the Nth chunk SERVED process-wide,
0-based across passes — the way to hit a specific later pass). An ``xK``
suffix bounds how many times the fault fires (default 1; ``x*`` = unlimited),
which is what lets a bounded retry succeed after K injected failures.

SERVE-scoped faults (the online clustering service, serve/cluster_service.py)
address a NAMED trigger point instead of a chunk index: ``assign`` (the
micro-batch worker, before it runs a batch), ``ingest`` (an ingest batch's
rows, before the finite check), ``refit`` (inside the background refit
worker, at the top of each attempt), ``validate`` (the candidate centers,
before hot-swap validation). At a serve point ``kill`` raises exactly like
``raise`` — a worker THREAD cannot be SIGKILLed, so "kill the refit worker"
means its attempt dies with an unhandled exception (the crash-retry path);
process-level SIGKILL during a refit still goes through ``kill@gN`` on the
refit's own chunk stream. ``nan``/``inf`` at a serve point corrupt the array
handed to ``on_serve`` (an ingest batch, candidate centers) instead of a
stream chunk.

Spec grammar (comma-separated entries)::

  raise@c2x3      raise on chunk 2 of any pass, first 3 times it is produced
  nan@g17         NaN-corrupt the 18th chunk served in this process
  stall@c0:1.5    sleep 1.5 s before yielding chunk 0 (once)
  kill@g9         SIGKILL before yielding the 10th chunk served
  kill@refit      the refit worker's next attempt dies (InjectedFault)
  stall@assign:2  the assign worker sleeps 2 s before its next batch
  nan@ingest      the next ingest batch's first row becomes NaN

Wiring: ``text/stream.run_pass``'s producer calls ``on_chunk`` for every
chunk it generates; the online service calls ``serve_point`` at the four
named points above. All consult ``active()``, which is ``None`` unless a
plan was installed programmatically (``install``/``inject``) or via
``REPRO_FAULTS`` — the no-plan fast path is a single global read.
"""

from __future__ import annotations

import contextlib
import os
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Iterator

import numpy as np

_CHUNK_KINDS = ("raise", "nan", "inf", "stall", "kill")
_KINDS = _CHUNK_KINDS
# named trigger points of the online service (see module docstring)
_SERVE_POINTS = ("assign", "ingest", "refit", "validate")


class InjectedFault(RuntimeError):
    """The exception raised by 'raise' faults."""


@dataclass
class Fault:
    kind: str
    # trigger: ("c", chunk_index) | ("g", global_serve_index)
    #        | ("s", serve_point_name)
    where: tuple[str, int] | tuple[str, str] | None = None
    seconds: float = 0.0  # stall duration
    times: int | None = 1  # remaining firings; None = unlimited
    fired: int = 0  # total firings so far (test observability)

    def _matches(self, ci: int, served: int) -> bool:
        if self.where is None or self.where[0] == "s":
            return False
        mode, at = self.where
        return (ci if mode == "c" else served) == at

    def _consume(self) -> bool:
        if self.times is not None:
            if self.times <= 0:
                return False
            self.times -= 1
        self.fired += 1
        return True


def _parse_entry(entry: str) -> Fault:
    entry = entry.strip()
    if not entry:
        raise ValueError("empty fault entry")
    head, _, where = entry.partition("@")
    # stall carries its duration after ':' on the TRIGGER part (stall@c0:1.5)
    seconds = 0.0
    if where and ":" in where:
        where, _, secs = where.partition(":")
        seconds = float(secs)
    times: int | None = 1

    # xK multiplicity may suffix either the kind (raisex2@c0) or the
    # trigger (raise@c2x3); '*' means unlimited
    def split_times(s: str) -> tuple[str, int | None, bool]:
        if "x" in s:
            base, _, mult = s.rpartition("x")
            if mult == "*":
                return base, None, True
            if mult.isdigit():
                return base, int(mult), True
        return s, 1, False

    kind, t, found = split_times(head)
    if found:
        times = t
    if where:
        where2, t, found = split_times(where)
        if found:
            where, times = where2, t
    kind = kind.strip()
    if kind not in _KINDS:
        raise ValueError(
            f"unknown fault kind {kind!r} in {entry!r}; expected one of {_KINDS}"
        )
    if not where:
        raise ValueError(
            f"chunk fault {entry!r} needs a trigger: @cI, @gN, or a serve"
            f" point {_SERVE_POINTS}"
        )
    if kind == "stall" and seconds <= 0:
        raise ValueError(f"stall fault {entry!r} needs a duration: stall@c0:SECS")
    if where in _SERVE_POINTS:
        return Fault(kind=kind, where=("s", where), seconds=seconds, times=times)
    mode, idx = where[0], where[1:]
    if mode not in ("c", "g"):
        if where.isdigit():  # bare integer = chunk index
            mode, idx = "c", where
        else:
            raise ValueError(
                f"bad trigger {where!r} in {entry!r}: use @cI, @gN, or one"
                f" of {_SERVE_POINTS}"
            )
    if not idx.isdigit():
        raise ValueError(f"bad trigger index {idx!r} in {entry!r}")
    return Fault(kind=kind, where=(mode, int(idx)), seconds=seconds, times=times)


@dataclass
class FaultPlan:
    """A set of armed faults plus the process-wide served-chunk counter."""

    faults: list[Fault] = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    served: int = 0  # chunks handed to any pass so far (for @gN triggers)

    @classmethod
    def from_spec(cls, spec: str) -> "FaultPlan":
        entries = [e for e in spec.split(",") if e.strip()]
        if not entries:
            raise ValueError(f"empty REPRO_FAULTS spec: {spec!r}")
        return cls(faults=[_parse_entry(e) for e in entries])

    # -- chunk-side --------------------------------------------------------
    def on_chunk(self, pass_id: str, ci: int, ch: Any) -> Any:
        """Apply armed faults to one produced chunk; called from the producer
        (so 'raise' is a producer-side exception the retry layer sees)."""
        with self._lock:
            served = self.served
            self.served += 1
            hits = [
                f
                for f in self.faults
                if f.kind in _CHUNK_KINDS and f._matches(ci, served) and f._consume()
            ]
        for f in hits:
            if f.kind == "kill":
                os.kill(os.getpid(), signal.SIGKILL)
            if f.kind == "stall":
                time.sleep(f.seconds)
            elif f.kind == "raise":
                raise InjectedFault(
                    f"injected producer fault at pass {pass_id!r} chunk {ci}"
                )
            elif f.kind in ("nan", "inf"):
                bad = np.nan if f.kind == "nan" else np.inf
                if hasattr(ch.x, "clone"):  # a mapped chunk: a torch tensor
                    x = ch.x.clone()
                else:
                    x = np.array(np.asarray(ch.x), dtype=np.float32, copy=True)
                x[0, :] = bad
                ch = ch._replace(x=x)
        return ch

    # -- serve-side --------------------------------------------------------
    def on_serve(self, point: str, arr: Any = None) -> Any:
        """Apply armed faults at a named serve point; returns ``arr`` (maybe
        corrupted). 'kill' and 'raise' both raise ``InjectedFault`` here — a
        worker thread cannot be SIGKILLed, so "kill the worker" means its
        attempt dies with an unhandled exception; 'stall' sleeps; 'nan'/'inf'
        corrupt the passed array's first row (ingest batch, candidate
        centers) when one is given."""
        if point not in _SERVE_POINTS:
            raise ValueError(
                f"unknown serve point {point!r}: expected one of {_SERVE_POINTS}"
            )
        with self._lock:
            hits = [
                f
                for f in self.faults
                if f.where == ("s", point) and f._consume()
            ]
        for f in hits:
            if f.kind == "stall":
                time.sleep(f.seconds)
            elif f.kind in ("raise", "kill"):
                raise InjectedFault(
                    f"injected {f.kind} fault at serve point {point!r}"
                )
            elif f.kind in ("nan", "inf") and arr is not None:
                arr = np.array(np.asarray(arr), dtype=np.float32, copy=True)
                bad = np.nan if f.kind == "nan" else np.inf
                if arr.ndim >= 1 and arr.shape[0] > 0:
                    arr[0, ...] = bad
        return arr

    # -- observability -----------------------------------------------------
    def fired(self, kind: str | None = None) -> int:
        with self._lock:
            return sum(f.fired for f in self.faults if kind in (None, f.kind))


_UNSET = object()
_PLAN: Any = _UNSET
_PLAN_LOCK = threading.Lock()


def active() -> FaultPlan | None:
    """The installed plan, initialized lazily from ``REPRO_FAULTS``."""
    global _PLAN
    if _PLAN is _UNSET:
        with _PLAN_LOCK:
            if _PLAN is _UNSET:
                spec = os.environ.get("REPRO_FAULTS", "").strip()
                _PLAN = FaultPlan.from_spec(spec) if spec else None
    return _PLAN


def install(plan: FaultPlan | str) -> FaultPlan:
    """Install a plan programmatically (tests); returns it for observability."""
    global _PLAN
    if isinstance(plan, str):
        plan = FaultPlan.from_spec(plan)
    with _PLAN_LOCK:
        _PLAN = plan
    return plan


def clear() -> None:
    """Remove any installed plan (env spec will NOT re-arm until re-install)."""
    global _PLAN
    with _PLAN_LOCK:
        _PLAN = None


def serve_point(point: str, arr: Any = None) -> Any:
    """The service-side hook (serve/cluster_service.py): apply any armed
    faults at the named point via the active plan; a no-op pass-through of
    ``arr`` when no plan is installed."""
    plan = active()
    return arr if plan is None else plan.on_serve(point, arr)


@contextlib.contextmanager
def inject(spec: str) -> Iterator[FaultPlan]:
    """Scoped installation: ``with inject("raise@c2"): ...``."""
    plan = install(spec)
    try:
        yield plan
    finally:
        clear()
