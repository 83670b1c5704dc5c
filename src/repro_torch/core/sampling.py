"""Sampling: the Buckshot sample of s distinct documents.

JAX's ``jax.random.choice`` stream cannot be reproduced in torch; the port
draws with an explicit ``torch.Generator`` and its tests hold it to the JAX
package through the entry points that take the draws as inputs
(``buckshot_fit(x, sample_idx, k)``, ``kmeans_fit(x, init_centers, k)``,
``reservoir_sample_stream(..., uniforms=...)``).

Streaming (``reservoir_sample_stream``): top-s of iid uniforms is a monoid
(top_s(A ∪ B) = top_s(top_s(A) ∪ top_s(B))), so carrying the s best (score,
index, row) triples across chunks computes the exact global top-s, i.e. an
exact uniform s-sample without replacement, with O(s·d + chunk·d)
residency and one pass.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from repro_torch.common import resolve_device


def sample_indices(
    n: int,
    s: int,
    generator: torch.Generator,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """(s,) int64 distinct indices uniform over [0, n).

    ``generator`` is a CPU generator; the draw is moved to ``device``
    (``None`` means the CUDA device).
    """
    dev = resolve_device(device)
    if not 0 <= s <= n:
        raise ValueError(f"cannot draw {s} distinct indices from {n}")
    return torch.randperm(n, generator=generator)[:s].to(dev)


def local_top_s(u: torch.Tensor, s: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-shard step of distributed sampling: (scores, local indices int32)
    of the top min(s, n_local) of the shard's uniforms ``u``. The JAX
    package draws ``u`` from a key; the port takes the draws as an input.
    Ties go to the lower index (a stable descending sort, as
    ``jax.lax.top_k``; never ``torch.topk``)."""
    idx = torch.sort(u, descending=True, stable=True).indices[: min(s, u.shape[0])]
    return u[idx], idx.to(torch.int32)


def buckshot_sample_size(n: int, k: int) -> int:
    """Paper's sample size s = sqrt(k * n)."""
    return max(k, int(math.ceil(math.sqrt(float(k) * float(n)))))


# ---------------------------------------------------------------- streaming


def merge_top_s(
    carry: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    scores: torch.Tensor,
    gidx: torch.Tensor,
    rows: torch.Tensor,
    s: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One step of the running top-s reservoir: fold a chunk's candidates in.

    carry = (scores (s,), gidx (s,), rows (s, d)); the chunk contributes
    per-row scores (pad rows -1, so they lose to every real uniform in
    [0, 1)). The top s of the (s + chunk) union, by a STABLE descending sort
    (ties keep carry-then-chunk order, as ``jax.lax.top_k`` does; never
    ``torch.topk``, which promises no order among ties), is the exact top s
    of everything seen.
    """
    c_scores, c_gidx, c_rows = carry
    all_scores = torch.cat([c_scores, scores])
    order = torch.sort(all_scores, descending=True, stable=True).indices[:s]
    all_gidx = torch.cat([c_gidx, gidx.to(torch.int32)])
    all_rows = torch.cat([c_rows, rows])
    return all_scores[order], all_gidx[order], all_rows[order]


def chunk_uniforms(base_seed: int, ci: int, chunk: int) -> torch.Tensor:
    """Chunk ``ci``'s (chunk,) f32 uniforms in [0, 1): a CPU generator seeded
    from (base_seed, ci), so the draw depends on neither the thread nor the
    prefetch."""
    seed = int(np.random.SeedSequence((base_seed, ci)).generate_state(1, np.uint64)[0])
    g = torch.Generator().manual_seed(seed & (2**63 - 1))
    return torch.rand((chunk,), generator=g, dtype=torch.float32)


def shard_uniforms(seed: int, ci: int, shard: int, n: int) -> torch.Tensor:
    """Shard ``shard``'s (n,) f32 uniforms in [0, 1) for chunk ``ci`` of the
    distributed reservoir: a CPU generator seeded from (seed, ci, shard), in
    the manner of ``chunk_uniforms``."""
    state = int(np.random.SeedSequence((seed, ci, shard)).generate_state(1, np.uint64)[0])
    g = torch.Generator().manual_seed(state & (2**63 - 1))
    return torch.rand((n,), generator=g, dtype=torch.float32)


def _chunk_scores(
    u: torch.Tensor, w: torch.Tensor, start: int, chunk: int
) -> tuple[torch.Tensor, torch.Tensor]:
    scores = torch.where(w > 0, u, -1.0)  # padding loses every comparison
    gidx = start + torch.arange(chunk, dtype=torch.int32, device=w.device)
    return scores, gidx


def reservoir_sample_stream(
    stream,
    s: int,
    generator: torch.Generator | None = None,
    *,
    uniforms: Callable[[int], object] | None = None,
    device: str | torch.device | None = None,
    checkpoint=None,
    guard=None,
) -> tuple[torch.Tensor, np.ndarray]:
    """Exact uniform s-sample (without replacement) of a chunk stream's real
    rows, in ONE pass with an O(s·d) carry on ``device`` (``None`` means the
    CUDA device).

    Chunk ci's uniforms come from ``chunk_uniforms(base, ci, chunk)``, where
    ``base`` is one draw from ``generator`` (a CPU generator): the same
    generator state and chunk size give the same sample. ``uniforms`` (a
    function of the chunk index giving its (chunk,) uniforms) replaces them
    — the seam through which tests feed the JAX package's own draws.

    Pad rows score -1.0, strictly below any real row's [0, 1) draw, and the
    carry's -2.0 filler loses to both, so ``s == stream.n`` returns exactly
    the real rows; ``s > stream.n`` is rejected. Returns (rows (s, d) on the
    device, global indices (s,) np.int32, by descending score — a uniformly
    shuffled order).

    With a ``checkpoint`` the pass snapshots its carry and stores the sample
    as the pass result ``"reservoir"``, bound to its draws: to ``base`` and
    ``s`` (the JAX package binds its rng key; the port has none, and
    ``base`` is all the generator gives the pass, so a generator in another
    state cold-starts), or with ``uniforms`` to ``array_token(uniforms(0))``
    and ``s`` (chunk 0's draws stand for the function).
    """
    from repro_torch.resilience.checkpoint import array_token
    from repro_torch.text.stream import run_pass, to_device

    if s > stream.n:
        raise ValueError(f"sample size {s} exceeds stream rows {stream.n}")
    draws = None
    if uniforms is None:
        if generator is None:
            raise ValueError("reservoir_sample_stream needs a generator or uniforms")
        base = int(torch.randint(0, 2**62, (1,), generator=generator))
        draws = {"base": base}

        def uniforms(ci):
            return chunk_uniforms(base, ci, stream.chunk)

    dev = resolve_device(device)
    meta = None
    if checkpoint is not None:
        meta = {**(draws or {"uniforms": array_token(uniforms(0))}), "s": s}
        done = checkpoint.load_result("reservoir", meta=meta, device=dev)
        if done is not None:
            return done["rows"], done["gidx"]

    def fold(carry, ch, ci):
        w = to_device(ch.w, dev)
        u = torch.as_tensor(np.asarray(uniforms(ci)), dtype=torch.float32).to(dev)
        scores, gidx = _chunk_scores(u, w, ch.start, stream.chunk)
        return merge_top_s(carry, scores, gidx, to_device(ch.x, dev), s)

    _, gidx, rows = run_pass(
        stream,
        fold,
        (
            torch.full((s,), -2.0, dtype=torch.float32, device=dev),  # below pads
            torch.full((s,), -1, dtype=torch.int32, device=dev),
            torch.zeros((s, stream.dim), dtype=torch.float32, device=dev),
        ),
        copy_to=dev,
        pass_id="reservoir",
        checkpoint=checkpoint,
        guard=guard,
        meta=meta,
    )
    gidx = gidx.cpu().numpy()
    if checkpoint is not None:
        checkpoint.save_result("reservoir", {"rows": rows, "gidx": gidx}, meta=meta)
    return rows, gidx
