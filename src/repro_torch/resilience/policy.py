"""Failure taxonomy + retry policy of the streaming executor.

The port's own copy of the JAX package's numpy-only
``resilience/policy.py``: the same classes, the same ``REPRO_STREAM_*``
variables.

Three failure classes, three surfaces:

  transient producer faults  -> retried per ``RetryPolicy``; exhausted
                                retries raise ``StreamFault`` (chunk index,
                                attempt count, original cause chained)
  wedged producers           -> ``StreamTimeout`` from the consumer-side
                                watchdog (queue get with a deadline) instead
                                of an unbounded hang
  numeric corruption         -> ``GuardError`` from the opt-in
                                ``guard="finite"`` carry check, attributed to
                                the offending pass and chunk

Env knobs (explicit arguments always win):
  REPRO_STREAM_RETRIES  int   per-chunk retry budget      (default 0: fail fast,
                              the seed behavior — the original exception
                              surfaces unwrapped)
  REPRO_STREAM_TIMEOUT  secs  producer watchdog deadline  (default off)
  REPRO_STREAM_GUARD    str   'finite' enables the carry guard (default off)
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any


class StreamError(RuntimeError):
    """Base class of the resilience layer's own failures."""


class StreamFault(StreamError):
    """A chunk's production kept failing after the retry budget ran out."""

    def __init__(self, pass_id: str, chunk: int, attempts: int, cause: BaseException):
        self.pass_id = pass_id
        self.chunk = chunk
        self.attempts = attempts
        super().__init__(
            f"pass {pass_id!r}: chunk {chunk} failed {attempts} time(s)"
            f" (retry budget exhausted): {cause!r}"
        )


class StreamTimeout(StreamError):
    """The producer went silent past the watchdog deadline."""

    def __init__(self, pass_id: str, chunk: int, seconds: float):
        self.pass_id = pass_id
        self.chunk = chunk
        self.seconds = seconds
        super().__init__(
            f"pass {pass_id!r}: no chunk within {seconds:g}s"
            f" (waiting for chunk {chunk}) — producer wedged?"
        )


class GuardError(StreamError):
    """``guard='finite'`` found NaN/Inf in the carry after folding a chunk."""

    def __init__(self, pass_id: str, chunk: int):
        self.pass_id = pass_id
        self.chunk = chunk
        super().__init__(
            f"pass {pass_id!r}: non-finite values in the carry after folding"
            f" chunk {chunk} — upstream data or kernel produced NaN/Inf"
        )


@dataclass(frozen=True)
class RetryPolicy:
    """Per-chunk retry with bounded exponential backoff.

    Attempt i (1-based) sleeps ``min(base_delay * 2**(i-1), max_delay)``
    before re-opening the pass and fast-forwarding to the failed chunk
    (recompute-over-store makes replay legal — every pass regenerates).
    ``retries=0`` is fail-fast: the original exception surfaces unwrapped,
    exactly the pre-resilience behavior.
    """

    retries: int = 0
    base_delay: float = 0.05
    max_delay: float = 5.0

    def delay(self, attempt: int) -> float:
        return min(self.base_delay * (2.0 ** max(attempt - 1, 0)), self.max_delay)

    def sleep(self, attempt: int) -> None:
        d = self.delay(attempt)
        if d > 0:
            time.sleep(d)

    @staticmethod
    def resolve(retry: Any) -> "RetryPolicy":
        """Normalize an argument: policy | int budget | None (env/default)."""
        if isinstance(retry, RetryPolicy):
            return retry
        if retry is None:
            env = os.environ.get("REPRO_STREAM_RETRIES", "").strip()
            return RetryPolicy(retries=int(env)) if env else RetryPolicy()
        return RetryPolicy(retries=int(retry))


def resolve_timeout(timeout: Any) -> float | None:
    """Watchdog deadline in seconds; None/0 disables."""
    if timeout is None:
        env = os.environ.get("REPRO_STREAM_TIMEOUT", "").strip()
        if not env:
            return None
        timeout = float(env)
    t = float(timeout)
    return t if t > 0 else None


def resolve_guard(guard: Any) -> str | None:
    """Guard mode: 'finite' or None (off). Unknown modes raise."""
    if guard is None:
        guard = os.environ.get("REPRO_STREAM_GUARD", "").strip().lower() or None
    if guard in (None, "", "off", "none"):
        return None
    if guard != "finite":
        raise ValueError(f"unknown guard mode {guard!r}: expected 'finite'")
    return "finite"
