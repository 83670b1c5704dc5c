"""Fault tolerance of the streaming executor: the failure taxonomy and the
retry policy (``policy.py``). ``text/stream.run_pass`` retries producer
faults per chunk, turns a wedged producer into ``StreamTimeout`` and, with
``guard="finite"``, raises ``GuardError`` at the first non-finite carry.

Checkpointing (the JAX package's ``resilience/checkpoint.py``) is not
ported yet: every ``checkpoint=`` argument of the port raises
``NotImplementedError`` (ROADMAP queue 1 item 7).
"""

from repro_torch.resilience.policy import (
    GuardError,
    RetryPolicy,
    StreamError,
    StreamFault,
    StreamTimeout,
    resolve_guard,
    resolve_timeout,
)

__all__ = [
    "GuardError",
    "RetryPolicy",
    "StreamError",
    "StreamFault",
    "StreamTimeout",
    "resolve_guard",
    "resolve_timeout",
]
