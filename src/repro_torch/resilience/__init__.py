"""Fault tolerance of the streaming executor: checkpointed passes
(``checkpoint.py``), the failure taxonomy and the retry policy
(``policy.py``). Everything attaches at ``text/stream.run_pass``:

  - ``Checkpointer``: snapshots ``(pass_id, chunk_idx, carry)`` every N
    chunks; a killed job resumes mid-pass and gives the uninterrupted
    result bit for bit.
  - ``RetryPolicy``: producer faults become per-chunk retries; past the
    budget ``StreamFault`` names the pass and chunk.
  - a producer watchdog turns a wedged producer into ``StreamTimeout``;
  - ``guard="finite"`` raises ``GuardError`` at the first non-finite carry.

Deterministic fault injection for all of these lives in
``repro_torch/testing/faults.py`` (the ``REPRO_FAULTS`` knob).
"""

from repro_torch.resilience.checkpoint import (
    Checkpointer,
    DiskCheckpointer,
    MemoryCheckpointer,
    RankCheckpointer,
    array_token,
    carry_fingerprint,
    carry_from_host,
    carry_to_host,
)
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
    "Checkpointer",
    "DiskCheckpointer",
    "MemoryCheckpointer",
    "RankCheckpointer",
    "array_token",
    "carry_fingerprint",
    "carry_to_host",
    "carry_from_host",
    "GuardError",
    "RetryPolicy",
    "StreamError",
    "StreamFault",
    "StreamTimeout",
    "resolve_guard",
    "resolve_timeout",
]
