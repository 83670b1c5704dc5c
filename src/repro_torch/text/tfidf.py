"""TF-IDF weighting in the vector space model (paper §2: 'most of them are
based on the vector space model representation with tf-idf weights').

Counterpart of the JAX package's ``text/tfidf.py``: the single-device entry
point plus the distributed document-frequency job, where df is a per-rank
partial summed across the data axes (the combiner discipline again: the
reduce payload is (d,), not (n, d)).

The streaming (out-of-core) form is TWO passes over a
``text/stream.CorpusStream``: pass 1 folds (df, n) over chunks, on one
device or through the engine's fold job on a mesh (one all-reduce for the
whole pass), and pass 2 is a lazily mapped stream that rescales and
L2-normalizes each chunk on the device as it arrives. df and n are
integer-valued, so the chunked f32 fold is exact and the streamed rows equal
the resident ``tfidf``'s bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.common import l2_normalize, resolve_device


def tf_weight(counts: torch.Tensor) -> torch.Tensor:
    """Sub-linear tf: 1 + log(tf) for tf > 0 (Manning et al. [28])."""
    return torch.where(counts > 0, 1.0 + torch.log(torch.clamp(counts, min=1.0)), 0.0)


def idf_weight(df: torch.Tensor, n_docs: int | float | torch.Tensor) -> torch.Tensor:
    """Smoothed idf: log(n / (1 + df))."""
    n = torch.as_tensor(n_docs, dtype=torch.float32, device=df.device)
    return torch.log(n / (1.0 + df))


def document_frequency(counts: torch.Tensor) -> torch.Tensor:
    return torch.sum((counts > 0).float(), dim=0)


def tfidf(counts: torch.Tensor) -> torch.Tensor:
    """counts (n, d) -> L2-normalized tf-idf vectors (n, d) f32.

    n == 0 is rejected: idf would be log(0) = -inf for every term. An
    all-zero row (an empty document) stays the zero vector."""
    if counts.shape[0] == 0:
        raise ValueError("tfidf: empty collection (n == 0 documents)")
    return _rescale(counts, document_frequency(counts), counts.shape[0])


def _rescale(counts: torch.Tensor, df: torch.Tensor, n) -> torch.Tensor:
    x = tf_weight(counts) * idf_weight(df, n)
    x = torch.clamp(x, min=0.0)  # idf can go negative for terms in >n/e docs
    return l2_normalize(x)


# ------------------------------------------------------------------ streaming


def _df_map(counts: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk's weighted presence: ((d,) df, n); pad rows carry w == 0."""
    present = (counts > 0).float() * w[:, None]
    return torch.sum(present, dim=0), torch.sum(w)


def df_stream(
    stream, *, device: str | torch.device | None = None, checkpoint=None, guard=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pass 1 over a count-chunk stream: fold (df (d,), n) on ``device``
    (``None`` means the CUDA device) — exact, since both are integer-valued
    however the chunks split the rows. Checkpoints under pass id
    ``tfidf/df``; guard='finite' attributes the first non-finite accumulator
    to its chunk."""
    from repro_torch.text.stream import run_pass, to_device

    dev = resolve_device(device)
    if stream.n == 0:
        raise ValueError("df_stream: empty stream (n == 0 documents)")

    def fold(carry, ch, ci):
        df, n = _df_map(to_device(ch.x, dev), to_device(ch.w, dev))
        return carry[0] + df, carry[1] + n

    return run_pass(
        stream,
        fold,
        (torch.zeros((stream.dim,), dtype=torch.float32, device=dev),
         torch.zeros((), dtype=torch.float32, device=dev)),
        copy_to=dev,
        pass_id="tfidf/df",
        checkpoint=checkpoint,
        guard=guard,
    )


def tfidf_stream(
    stream, *, device: str | torch.device | None = None, checkpoint=None, guard=None
):
    """Streaming two-pass tf-idf: the (df, n) fold, then a lazily mapped
    stream whose chunks are rescaled and L2-normalized on ``device`` on
    arrival. Equal to the resident ``tfidf`` bit for bit: pass 1 folds
    integers, pass 2 applies the same elementwise rescale per chunk. Peak
    residency O(chunk·d)."""
    dev = resolve_device(device)
    df, n = df_stream(stream, device=dev, checkpoint=checkpoint, guard=guard)
    from repro_torch.text.stream import to_device

    return stream.map(lambda c, w: _rescale(to_device(c, dev), df, n))


# ------------------------------------------------------------------ mesh


def _df_job_map(data, bcast):
    """map+combine of the (df, n) job: this rank's weighted presence."""
    df, n = _df_map(data["counts"], data["w"])
    return {"df": df, "n": n}


def tfidf_distributed(mesh, axes: tuple[str, ...], counts: torch.Tensor, w: torch.Tensor):
    """Distributed tf-idf: one MapReduce job for (df, n), then a local
    rescale. Each rank passes its row block of the counts and weights
    (padding rows have w == 0) and gets its block of the rows."""
    from repro_torch.distrib.engine import make_job

    job = make_job(mesh, axes, _df_job_map, {"df": "sum", "n": "sum"}, name="tfidf_df")
    stats = job({"counts": counts, "w": w}, {})
    return _rescale(counts, stats["df"], stats["n"])


def df_fold_distributed(mesh, axes: tuple[str, ...], stream) -> dict:
    """Distributed pass 1: the engine's fold job. Each chunk is cut to the
    rank's block and folded into the rank's (df, n); ONE all-reduce closes
    the pass (not one per chunk). Pass id ``tfidf/df``. Returns {"df", "n"}
    on the rank's device, replicated."""
    from repro_torch.distrib.engine import make_fold_job
    from repro_torch.distrib.sharding import mesh_device, shard_stream
    from repro_torch.text.stream import run_pass, to_device

    dev = mesh_device(mesh)
    job = make_fold_job(mesh, axes, _df_job_map, {"df": "sum", "n": "sum"},
                        name="tfidf_df_fold")

    def fold(carry, ch, ci):
        data = {"counts": to_device(ch.x, dev), "w": to_device(ch.w, dev)}
        return job.step(carry, data, {})[0]

    carry = run_pass(shard_stream(stream, mesh, axes), fold, None, copy_to=dev,
                     pass_id="tfidf/df")
    return job.finalize(carry)


def tfidf_distributed_stream(mesh, axes: tuple[str, ...], stream):
    """Streaming distributed tf-idf: the fold-job pass 1, then a lazily
    mapped stream that rescales each chunk on the rank's device. Its chunks
    are whole; the distributed drivers cut each to the rank's block on
    arrival."""
    from repro_torch.distrib.sharding import mesh_device
    from repro_torch.text.stream import to_device

    dev = mesh_device(mesh)
    stats = df_fold_distributed(mesh, axes, stream)
    df, n = stats["df"], stats["n"]
    return stream.map(lambda c, w: _rescale(to_device(c, dev), df, n))
