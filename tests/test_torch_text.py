"""The port's text layer against the JAX package's, on the CPU.

``synth`` is a numpy copy and must give byte-identical counts for a seed.
tf-idf: document frequencies are integer-valued and equal; the JAX
package's CPU ``log`` is not correctly rounded (about 2% of f32 inputs come
out one ulp from the correctly rounded value) while torch's nearly always
is, so tf and idf agree within 1 ulp, and the unit-norm tf-idf rows, after
their product and the normalization, within 2 ulp of 1.0.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.text import synth as jsynth
from repro.text import tfidf as jtfidf
from repro_torch import interop
from repro_torch.text import pipeline, synth, tfidf

ULP1 = float(np.spacing(np.float32(1.0)))


def _ulps(got, want):
    got, want = interop.to_numpy(got), np.asarray(want)
    return np.max(np.abs(got - want) / np.spacing(np.abs(want).astype(np.float32)))


@pytest.mark.parametrize("n,vocab,topics,seed,batch", [
    (800, 256, 6, 11, 8192), (333, 64, 4, 3, 100), (50, 2048, 20, 20, 7),
])
def test_synth_counts_byte_identical(n, vocab, topics, seed, batch):
    got = synth.make_corpus(n, vocab=vocab, n_topics=topics, seed=seed, batch=batch)
    want = jsynth.make_corpus(n, vocab=vocab, n_topics=topics, seed=seed)
    assert got.counts.tobytes() == want.counts.tobytes()
    assert got.labels.tobytes() == want.labels.tobytes()
    assert got.n_topics == want.n_topics


def test_synth_paper_shapes_match():
    assert synth.paper_20ng_shape() == jsynth.paper_20ng_shape()
    for scale in (1.0, 0.01):
        assert synth.paper_1gb_shape(scale) == jsynth.paper_1gb_shape(scale)
    blocks = list(synth.iter_corpus_blocks(100, 32, 3, seed=4, batch=30))
    jblocks = list(jsynth.iter_corpus_blocks(100, 32, 3, seed=4, batch=30))
    assert len(blocks) == len(jblocks) == 4
    for (c, lab), (jc, jlab) in zip(blocks, jblocks):
        assert c.tobytes() == jc.tobytes() and lab.tobytes() == jlab.tobytes()


def test_tfidf_matches_jax(small_corpus):
    counts = small_corpus.counts
    ct, cj = torch.from_numpy(counts), jnp.asarray(counts)
    df = jtfidf.document_frequency(cj)
    np.testing.assert_array_equal(interop.to_numpy(tfidf.document_frequency(ct)), np.asarray(df))
    assert _ulps(tfidf.tf_weight(ct), jtfidf.tf_weight(cj)) <= 1
    idf = tfidf.idf_weight(interop.data(df, "cpu"), counts.shape[0])
    assert _ulps(idf, jtfidf.idf_weight(df, counts.shape[0])) <= 1
    got, want = tfidf.tfidf(ct), np.asarray(jtfidf.tfidf(cj))
    np.testing.assert_allclose(interop.to_numpy(got), want, rtol=0, atol=2 * ULP1)
    np.testing.assert_allclose(interop.to_numpy(got.norm(dim=1)), 1.0, atol=1e-6)


def test_tfidf_rejects_empty_collection():
    with pytest.raises(ValueError, match="empty"):
        tfidf.tfidf(torch.zeros((0, 5)))


def test_tfidf_zero_row_stays_zero():
    counts = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 2.0], [0.0, 3.0, 0.0]])
    x = tfidf.tfidf(counts)
    assert (x[0] == 0).all() and torch.isfinite(x).all()


def test_prepare_local_on_the_cpu(small_corpus):
    x, labels = pipeline.prepare_local(small_corpus, device="cpu")
    assert x.device.type == "cpu" and x.shape == small_corpus.counts.shape
    assert labels is small_corpus.labels
    assert torch.equal(x, tfidf.tfidf(torch.from_numpy(small_corpus.counts)))


def test_prepare_local_defaults_to_the_card(small_corpus):
    """device=None means CUDA; without a card that raises, never falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.prepare_local(small_corpus)
