"""Hashing vectorizer for real text (host-side; the torch pipeline starts
at count matrices). The port's own copy of the JAX package's numpy-only
``text/hashing.py``: the same texts give byte-identical counts. Vocabulary-free and deterministic across processes, which is
what a 1000-node ingest pipeline needs — no global vocab shuffle.

Counts use UNSIGNED buckets: the earlier signed-hashing scheme summed signed
contributions and then took ``np.abs``, but under a collision the absolute
value of a signed SUM is not the unsigned count (+1 and -1 tokens cancel to 0
instead of counting 2), which silently deflated tf weights on colliding
buckets. Signed hashing is the right trick for feature VALUES fed straight to
a linear model, not for tf counts that a log-tf transform re-weights.

The per-token Python loop is gone: tokens are hashed once each (process-wide
cache) and a whole chunk of documents lands in one batched ``np.add.at``
scatter — the ingest step is chunk-aware (``vectorize_chunks``) so it plugs
into ``text/stream.CorpusStream`` without ever building the (n, dim) matrix.
"""

from __future__ import annotations

import re
import zlib
from typing import Iterable, Iterator, Sequence

import numpy as np

_TOKEN = re.compile(r"[a-z0-9]+")

# token -> raw crc32, filled lazily; tokens repeat heavily in real text so the
# zlib call happens once per distinct token. Bounded: distinct-token count
# grows with corpus size (Heap's law), and an unbounded dict would quietly
# break the O(chunk·dim) streaming-ingest residency this module exists for.
_CRC_CACHE: dict[str, int] = {}
_CRC_CACHE_MAX = 1 << 20


def tokenize(text: str) -> list[str]:
    return _TOKEN.findall(text.lower())


def hash_token(tok: str, dim: int) -> tuple[int, float]:
    """(bucket, sign). The sign is retained for API compatibility (feature
    hashing for linear models); ``vectorize`` no longer uses it — see the
    module docstring for why signed buckets are wrong for tf counts."""
    h = zlib.crc32(tok.encode("utf-8"))
    return h % dim, 1.0 if (h >> 31) & 1 == 0 else -1.0


def hash_buckets(tokens: Sequence[str], dim: int) -> np.ndarray:
    """Token list -> (len,) int64 bucket ids (cached crc32, then mod dim)."""
    out = np.empty(len(tokens), np.int64)
    cache = _CRC_CACHE
    if len(cache) > _CRC_CACHE_MAX:
        cache.clear()  # rare full reset beats per-entry LRU bookkeeping
    for i, tok in enumerate(tokens):
        h = cache.get(tok)
        if h is None:
            h = cache[tok] = zlib.crc32(tok.encode("utf-8"))
        out[i] = h
    return out % dim


def _counts_block(bucket_rows: list[np.ndarray], dim: int) -> np.ndarray:
    """One batched scatter for a whole block: (docs, dim) unsigned counts."""
    out = np.zeros((len(bucket_rows), dim), np.float32)
    lens = np.fromiter((len(b) for b in bucket_rows), np.int64, len(bucket_rows))
    if lens.sum():
        rows = np.repeat(np.arange(len(bucket_rows), dtype=np.int64), lens)
        cols = np.concatenate([b for b in bucket_rows if len(b)])
        np.add.at(out, (rows, cols), 1.0)
    return out


def vectorize_chunks(
    texts: Iterable[str], dim: int = 2048, *, chunk: int = 4096
) -> Iterator[np.ndarray]:
    """Texts -> (≤chunk, dim) unsigned hashed-count blocks, in order.

    The chunk-aware ingest path: peak memory is O(chunk·dim) however many
    documents stream through. Only the final block may be short.
    """
    bucket_rows: list[np.ndarray] = []
    for text in texts:
        bucket_rows.append(hash_buckets(tokenize(text), dim))
        if len(bucket_rows) == chunk:
            yield _counts_block(bucket_rows, dim)
            bucket_rows = []
    if bucket_rows:
        yield _counts_block(bucket_rows, dim)


def vectorize(texts: Iterable[str], dim: int = 2048) -> np.ndarray:
    """Texts -> (n, dim) unsigned hashed token counts (f32).

    Thin wrapper over the chunked path: blocks fill one preallocated array
    in place (no transient second copy of the resident matrix)."""
    texts = texts if isinstance(texts, (list, tuple)) else list(texts)
    out = np.zeros((len(texts), dim), np.float32)
    start = 0
    for block in vectorize_chunks(texts, dim):
        out[start : start + block.shape[0]] = block
        start += block.shape[0]
    return out
