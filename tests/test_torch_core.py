"""The port's clustering core against the JAX package's, on the CPU.

HAC, K-Means, Buckshot and the metrics get the same numpy inputs in both
packages (tf-idf rows computed once by the JAX package, the same sample
indices, the same initial centers). Labels and MST edges must be equal;
centers within 1e-6; RSS, purity and NMI within 1e-5 relative.
"""

from __future__ import annotations

import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.buckshot  # noqa: F401  (the modules, not the re-exported functions)
import repro.core.hac  # noqa: F401
import repro.core.kmeans  # noqa: F401
import repro_torch.core.buckshot  # noqa: F401
import repro_torch.core.hac  # noqa: F401
import repro_torch.core.kmeans  # noqa: F401
from repro.core import metrics as jmetrics
from repro.text import pipeline as jpipeline
from repro_torch import interop
from repro_torch.common import l2_normalize
from repro_torch.core import metrics, sampling

jb, jh, jk = (sys.modules[f"repro.core.{m}"] for m in ("buckshot", "hac", "kmeans"))
tb, th, tk = (sys.modules[f"repro_torch.core.{m}"] for m in ("buckshot", "hac", "kmeans"))

REL = 1e-5


@pytest.fixture
def rng(request):
    """This module's generator, seeded from the test's own name (and its
    parameters): its draws do not depend on which tests a worker ran before
    (conftest's session-wide generator's do)."""
    name = f"{request.module.__name__}::{request.node.name}"
    return np.random.default_rng(zlib.crc32(name.encode()))


@pytest.fixture(scope="module")
def corpus_x(small_corpus):
    """make_corpus(800, vocab=256, n_topics=6, seed=11) tf-idf, from JAX."""
    x, labels = jpipeline.prepare_local(small_corpus)
    return np.asarray(x), labels


def _np(t):
    return interop.to_numpy(t)


def _unit_rows(rng, s, d):
    x = rng.normal(size=(s, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


# ------------------------------------------------------------------ HAC


@pytest.mark.parametrize("s,k", [(40, 3), (120, 7), (300, 12)])
def test_boruvka_mst_matches_jax(rng, s, k):
    xs = _unit_rows(rng, s, 24)
    want = jh.boruvka_mst(jnp.asarray(xs))
    got = th.boruvka_mst(interop.data(xs, "cpu"))
    for f in ("u", "v", "valid"):
        np.testing.assert_array_equal(_np(getattr(got, f)), np.asarray(getattr(want, f)))
    np.testing.assert_allclose(_np(got.w), np.asarray(want.w), rtol=REL, atol=REL)
    assert int(got.valid.sum()) == s - 1  # a spanning tree

    labels = th.single_link_labels_boruvka(interop.data(xs, "cpu"), k)
    np.testing.assert_array_equal(
        _np(labels), np.asarray(jh.single_link_labels_boruvka(jnp.asarray(xs), k))
    )
    sim = interop.data(xs, "cpu") @ interop.data(xs, "cpu").T
    np.testing.assert_array_equal(_np(labels), _np(th.single_link_labels(sim, k)))


def test_mst_prim_matches_jax(rng):
    xs = _unit_rows(rng, 60, 16)
    sim = xs @ xs.T
    got = th.mst_prim(interop.data(sim, "cpu"))
    want = jh.mst_prim(jnp.asarray(sim))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    np.testing.assert_allclose(_np(got[2]), np.asarray(want[2]), rtol=REL)
    for k in (1, 5, 60):
        np.testing.assert_array_equal(
            _np(th.cut_forest(*got, 60, k)), np.asarray(jh.cut_forest(*want, 60, k))
        )


def test_components_from_edges_matches_jax(rng):
    n = 50
    eu = rng.integers(0, n, size=70).astype(np.int32)
    ev = rng.integers(0, n, size=70).astype(np.int32)
    mask = rng.random(70) < 0.6
    want = jh.components_from_edges(n, eu, ev, mask)
    got = th.components_from_edges(
        n, interop.labels(eu, "cpu"), interop.labels(ev, "cpu"), torch.from_numpy(mask)
    )
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_merge_round_ties_match_jax():
    """Rows of one component proposing equal weights: the lowest row wins."""
    labels = np.array([0, 0, 0, 3, 3, 5], np.int32)
    row_w = np.array([0.5, 0.7, 0.7, 0.7, 0.1, 0.2], np.float32)
    row_j = np.array([3, 4, 3, 1, 0, 0], np.int32)
    want = jh._merge_round(jnp.asarray(labels), jnp.asarray(row_w), jnp.asarray(row_j))
    got = th._merge_round(
        interop.labels(labels, "cpu"), interop.data(row_w, "cpu"), interop.labels(row_j, "cpu")
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


# ------------------------------------------------------------------ K-Means


def test_kmeans_fit_matches_jax(corpus_x):
    x, _ = corpus_x
    init = x[np.random.default_rng(3).choice(x.shape[0], 6, replace=False)]
    want = jk.kmeans_fit(jnp.asarray(x), jnp.asarray(init), 6)
    got = tk.kmeans_fit(interop.data(x, "cpu"), interop.data(init, "cpu"), 6)
    np.testing.assert_array_equal(_np(got.assignment), np.asarray(want.assignment))
    np.testing.assert_allclose(_np(got.centers), np.asarray(want.centers), atol=1e-6)
    np.testing.assert_allclose(_np(got.best_sim), np.asarray(want.best_sim), rtol=REL, atol=1e-6)
    np.testing.assert_allclose(got.rss.item(), float(want.rss), rtol=REL)
    np.testing.assert_allclose(got.objective.item(), float(want.objective), rtol=REL)
    assert got.iterations == int(want.iterations)


def test_kmeans_two_pass_path_matches_jax(corpus_x):
    x, _ = corpus_x
    init = x[:5]
    want = jk.kmeans_fit(jnp.asarray(x), jnp.asarray(init), 5, max_iters=3, fused=False)
    got = tk.kmeans_fit(
        interop.data(x, "cpu"), interop.data(init, "cpu"), 5, max_iters=3, fused=False
    )
    np.testing.assert_array_equal(_np(got.assignment), np.asarray(want.assignment))
    np.testing.assert_allclose(got.rss.item(), float(want.rss), rtol=REL)


def test_kmeans_step_split_reseed_matches_jax(rng):
    x = np.abs(_unit_rows(rng, 200, 12))
    centers = np.concatenate([x[:3], -x[:2]])  # negative centers stay empty
    want = jk.kmeans_step(jnp.asarray(x), jnp.asarray(centers), 5, reseed="split")
    got = tk.kmeans_step(interop.data(x, "cpu"), interop.data(centers, "cpu"), 5, reseed="split")
    np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), atol=1e-6)
    assert (_np(got[4])[3:] == 0).all()
    with pytest.raises(ValueError, match="reseed"):
        tk.kmeans_step(interop.data(x, "cpu"), interop.data(centers, "cpu"), 5, reseed="bogus")


def test_kmeans_entry_point_is_seeded(corpus_x):
    x = interop.data(corpus_x[0], "cpu")
    a = tk.kmeans(x, 6, torch.Generator().manual_seed(0), max_iters=3)
    b = tk.kmeans(x, 6, torch.Generator().manual_seed(0), max_iters=3)
    assert torch.equal(a.assignment, b.assignment) and 1 <= a.iterations <= 3


# ------------------------------------------------------------------ Buckshot


@pytest.mark.parametrize("hac", ["boruvka", "prim"])
def test_buckshot_fit_matches_jax(corpus_x, hac):
    x, truth = corpus_x
    k = 6
    sidx = np.random.default_rng(0).choice(x.shape[0], 70, replace=False)
    want = jb.buckshot_fit(jnp.asarray(x), jnp.asarray(sidx), k, hac=hac)
    got = tb.buckshot_fit(interop.data(x, "cpu"), interop.index(sidx, "cpu"), k, hac=hac)
    np.testing.assert_array_equal(_np(got.sample_labels), np.asarray(want.sample_labels))
    np.testing.assert_allclose(_np(got.init_centers), np.asarray(want.init_centers), atol=1e-6)
    np.testing.assert_array_equal(_np(got.kmeans.assignment), np.asarray(want.kmeans.assignment))
    np.testing.assert_allclose(_np(got.kmeans.centers), np.asarray(want.kmeans.centers), atol=1e-6)
    np.testing.assert_allclose(got.kmeans.rss.item(), float(want.kmeans.rss), rtol=REL)
    pred, true = got.kmeans.assignment, interop.labels(truth, "cpu")
    jpred = want.kmeans.assignment
    np.testing.assert_allclose(
        metrics.purity(pred, true, k, 6).item(), float(jmetrics.purity(jpred, truth, k, 6)), rtol=REL
    )
    np.testing.assert_allclose(
        metrics.nmi(pred, true, k, 6).item(), float(jmetrics.nmi(jpred, truth, k, 6)), rtol=REL
    )


def test_buckshot_entry_point_samples_sqrt_kn(corpus_x):
    x = interop.data(corpus_x[0], "cpu")
    res = tb.buckshot(x, 6, torch.Generator().manual_seed(1), kmeans_iters=2)
    s = sampling.buckshot_sample_size(800, 6)
    assert res.sample_idx.shape == (s,) and res.sample_labels.shape == (s,)
    assert len(set(res.sample_idx.tolist())) == s
    assert set(res.sample_labels.tolist()) == set(range(6))


def test_buckshot_rejects_unknown_hac(corpus_x):
    with pytest.raises(ValueError, match="hac"):
        tb.phase1_from_sample(interop.data(corpus_x[0][:20], "cpu"), 3, hac="ward")


# ------------------------------------------------------------------ metrics


def test_metrics_match_jax(rng, corpus_x):
    x, truth = corpus_x
    pred = rng.integers(0, 7, size=x.shape[0]).astype(np.int32)
    tp, tt, tx = interop.labels(pred, "cpu"), interop.labels(truth, "cpu"), interop.data(x, "cpu")
    np.testing.assert_array_equal(
        _np(metrics.contingency(tp, tt, 7, 6)), np.asarray(jmetrics.contingency(pred, truth, 7, 6))
    )
    for name in ("purity", "nmi"):
        np.testing.assert_allclose(
            getattr(metrics, name)(tp, tt, 7, 6).item(),
            float(getattr(jmetrics, name)(pred, truth, 7, 6)), rtol=REL,
        )
    np.testing.assert_allclose(
        metrics.rss(tx, tp, 7).item(), float(jmetrics.rss(jnp.asarray(x), pred, 7)), rtol=REL
    )
    best = rng.uniform(-1, 1, size=50).astype(np.float32)
    np.testing.assert_allclose(
        metrics.cosine_objective(interop.data(best, "cpu")).item(),
        float(jmetrics.cosine_objective(best)), rtol=REL,
    )


# ------------------------------------------------------------------ sampling


def test_sample_indices_distinct_and_seeded():
    a = sampling.sample_indices(1000, 40, torch.Generator().manual_seed(5), device="cpu")
    b = sampling.sample_indices(1000, 40, torch.Generator().manual_seed(5), device="cpu")
    assert a.dtype == torch.int64 and torch.equal(a, b)
    assert len(set(a.tolist())) == 40 and 0 <= int(a.min()) and int(a.max()) < 1000
    assert sampling.buckshot_sample_size(250_000, 50) == 3536
    with pytest.raises(ValueError):
        sampling.sample_indices(5, 6, torch.Generator(), device="cpu")


def test_creators_default_to_the_card():
    """device=None means CUDA; without a card that raises, never falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        sampling.sample_indices(10, 3, torch.Generator())
    x = l2_normalize(torch.ones(4, 3))
    assert tk.init_random_centers(x, 2, torch.Generator()).device.type == "cpu"
