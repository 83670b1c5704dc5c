"""The port's BKC (connected components, micro-clusters, joinToGroups, the
three final-pass routes) against the JAX package's, on the CPU.

Both packages get the same numpy inputs: tf-idf rows computed once by the
JAX package, the same BigK initial centers. Labels, group ids and component
labels must be equal; the bisection's f32 threshold equal bit for bit;
statistics and RSS within 1e-5 relative.
"""

from __future__ import annotations

import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.bkc  # noqa: F401  (the modules, not the re-exported functions)
import repro.core.connected_components  # noqa: F401
import repro.core.microcluster  # noqa: F401
import repro_torch.core.bkc  # noqa: F401
import repro_torch.core.connected_components  # noqa: F401
import repro_torch.core.microcluster  # noqa: F401
from repro.text import pipeline as jpipeline
from repro_torch import interop
from repro_torch.text import pipeline, synth

jbkc, jcc, jmc = (
    sys.modules[f"repro.core.{m}"] for m in ("bkc", "connected_components", "microcluster")
)
tbkc, tcc, tmc = (
    sys.modules[f"repro_torch.core.{m}"] for m in ("bkc", "connected_components", "microcluster")
)

REL = 1e-5
BIG_K, K = 40, 6
ROUTES = [dict(fused=True), dict(fused=False), dict(fused=True, bounded=True)]


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


@pytest.fixture(scope="module")
def init(corpus_x):
    x = corpus_x[0]
    return x[np.random.default_rng(7).choice(x.shape[0], BIG_K, replace=False)]


def _np(t):
    return interop.to_numpy(t)


def _sym_adjacency(rng, m, p):
    a = rng.random((m, m)) < p
    a = a | a.T
    np.fill_diagonal(a, False)
    return a


# ------------------------------------------------------------------ components


@pytest.mark.parametrize("m,p", [(1, 0.5), (30, 0.02), (120, 0.01), (200, 0.05)])
def test_label_components_matches_jax_and_union_find(rng, m, p):
    adj = _sym_adjacency(rng, m, p)
    got = tcc.label_components(torch.from_numpy(adj))
    want = jcc.label_components(jnp.asarray(adj))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_array_equal(_np(got), tcc.label_components_np(adj))
    np.testing.assert_array_equal(_np(got), jcc.label_components_np(adj))
    assert int(tcc.num_components(got)) == int(jcc.num_components(want))
    np.testing.assert_array_equal(
        _np(tcc.compact_labels(got)), np.asarray(jcc.compact_labels(want))
    )


def test_label_components_empty_graph():
    got = tcc.label_components(torch.zeros((0, 0), dtype=torch.bool))
    assert got.shape == (0,) and int(tcc.num_components(got)) == 0


@pytest.mark.parametrize("use_escape", [True, False])
def test_bisect_threshold_same_f32_bits(rng, use_escape):
    """The same pair/escape matrices give the same f32 threshold bits."""
    m = 60
    pair = np.triu(rng.uniform(0.0, 0.3, size=(m, m)) * (rng.random((m, m)) < 0.3), 1)
    pair = (pair + pair.T).astype(np.float32)
    escape = _sym_adjacency(rng, m, 0.01) & (pair == 0)
    for k in (4, 15, 40):
        s, g = tbkc._bisect_threshold(
            torch.from_numpy(pair), torch.from_numpy(escape), k, use_escape)
        js, jg = jbkc._bisect_threshold(
            jnp.asarray(pair), jnp.asarray(escape), k, jnp.bool_(use_escape))
        assert s.dtype == torch.float32
        assert _np(s).tobytes() == np.asarray(js, np.float32).tobytes()
        assert g == int(jg)


# ------------------------------------------------------------------ micro-clusters


@pytest.mark.parametrize("route", ROUTES, ids=["fused", "two_pass", "bounded"])
def test_build_microclusters_matches_jax(corpus_x, init, route):
    x = corpus_x[0]
    mc, idx, sim = tmc.build_microclusters(
        interop.data(x, "cpu"), interop.data(init, "cpu"), BIG_K, **route
    )
    jmc_, jidx, jsim = jmc.build_microclusters(jnp.asarray(x), jnp.asarray(init), BIG_K, **route)
    np.testing.assert_array_equal(_np(idx), np.asarray(jidx))
    np.testing.assert_allclose(_np(sim), np.asarray(jsim), rtol=REL, atol=1e-6)
    for f in ("n", "valid"):
        np.testing.assert_array_equal(_np(getattr(mc, f)), np.asarray(getattr(jmc_, f)))
    for f in ("cf1", "cf2", "centers", "min_sim"):
        np.testing.assert_allclose(
            _np(getattr(mc, f)), np.asarray(getattr(jmc_, f)), rtol=REL, atol=1e-6, err_msg=f
        )


def test_merge_stats_and_pair_similarity_match_jax(corpus_x, init):
    x = corpus_x[0]
    halves = [slice(0, 300), slice(300, None)]
    parts = [tmc.build_microclusters(interop.data(x[h], "cpu"), interop.data(init, "cpu"), BIG_K)[0]
             for h in halves]
    jparts = [jmc.build_microclusters(jnp.asarray(x[h]), jnp.asarray(init), BIG_K)[0]
              for h in halves]
    merged, jmerged = tmc.merge_stats(*parts), jmc.merge_stats(*jparts)
    for g, w in zip(merged, jmerged):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=REL, atol=1e-6)
    pair, esc = tmc.pair_similarity(merged)
    jpair, jesc = jmc.pair_similarity(jmerged)
    np.testing.assert_allclose(_np(pair), np.asarray(jpair), rtol=REL, atol=1e-6)
    np.testing.assert_array_equal(_np(esc), np.asarray(jesc))


# ------------------------------------------------------------------ BKC


@pytest.mark.parametrize("route", ROUTES, ids=["fused", "two_pass", "bounded"])
def test_bkc_fit_matches_jax(corpus_x, init, route):
    x = corpus_x[0]
    got = tbkc.bkc_fit(interop.data(x, "cpu"), interop.data(init, "cpu"), BIG_K, K, **route)
    want = jbkc.bkc_fit(jnp.asarray(x), jnp.asarray(init), BIG_K, K, **route)
    np.testing.assert_array_equal(_np(got.group_of_mc), np.asarray(want.group_of_mc))
    np.testing.assert_array_equal(_np(got.assignment), np.asarray(want.assignment))
    assert _np(got.threshold).tobytes() == np.asarray(want.threshold, np.float32).tobytes()
    np.testing.assert_allclose(_np(got.centers), np.asarray(want.centers), atol=1e-6)
    np.testing.assert_allclose(got.rss.item(), float(want.rss), rtol=REL)
    np.testing.assert_allclose(got.objective.item(), float(want.objective), rtol=REL)
    # every route gives the fused route's answer
    fused = tbkc.bkc_fit(interop.data(x, "cpu"), interop.data(init, "cpu"), BIG_K, K)
    assert torch.equal(got.group_of_mc, fused.group_of_mc)
    assert torch.equal(got.assignment, fused.assignment)


def _loose_blobs(n, d, topics, seed):
    """Unit rows around ``topics`` directions: most tight, 5 % loose. A
    micro-cluster that takes a loose row gets a low min_i, so centers of one
    topic have pair values cos - min_i - min_j above 0, and the bisection
    runs over real pair values (the small_corpus tf-idf gives only 0s)."""
    r = np.random.default_rng(seed)
    c = r.standard_normal((topics, d))
    lab = r.integers(0, topics, n)
    sig = np.where(r.random(n) < 0.05, 3.0, 0.15)
    x = c[lab] + sig[:, None] * r.standard_normal((n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("route,k", [
    (ROUTES[0], 40), (ROUTES[0], 50), (ROUTES[1], 50), (ROUTES[2], 50),
], ids=["fused-k40", "fused-k50", "two_pass-k50", "bounded-k50"])
def test_bkc_fit_bisects_real_pair_values_like_jax(route, k):
    """A threshold strictly inside the pair values: the f32 bisection, the
    groups and the labels equal the JAX package's."""
    big_k = 60
    x = _loose_blobs(800, 64, 6, 1)
    init = x[np.random.default_rng(7).choice(x.shape[0], big_k, replace=False)]
    got = tbkc.bkc_fit(interop.data(x, "cpu"), interop.data(init, "cpu"), big_k, k, **route)
    want = jbkc.bkc_fit(jnp.asarray(x), jnp.asarray(init), big_k, k, **route)
    jmc_ = jmc.build_microclusters(jnp.asarray(x), jnp.asarray(init), big_k)[0]
    jpair, jesc = (np.array(a) for a in jmc.pair_similarity(jmc_))
    thr = float(got.threshold)
    assert thr > 0.1 and (jpair >= thr).any() and (jpair[jpair > 0] < thr).any()
    np.testing.assert_allclose(thr, float(want.threshold), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(_np(got.group_of_mc), np.asarray(want.group_of_mc))
    np.testing.assert_array_equal(_np(got.assignment), np.asarray(want.assignment))
    np.testing.assert_allclose(got.rss.item(), float(want.rss), rtol=REL)
    # the same pair values give the same threshold bits
    s, g = tbkc._bisect_threshold(torch.from_numpy(jpair), torch.from_numpy(jesc), k, False)
    js, jg = jbkc._bisect_threshold(jnp.asarray(jpair), jnp.asarray(jesc), k, jnp.bool_(False))
    assert _np(s).tobytes() == np.asarray(js, np.float32).tobytes() and g == int(jg) == k


def test_join_to_groups_without_escape_edges(corpus_x, init):
    """k close to BigK: the escape edges over-connect the graph, so the
    bisection runs again without them; valid micro-clusters only, k groups."""
    x = corpus_x[0]
    mc = tmc.build_microclusters(interop.data(x, "cpu"), interop.data(init, "cpu"), BIG_K)[0]
    jmc_ = jmc.build_microclusters(jnp.asarray(x), jnp.asarray(init), BIG_K)[0]
    k = int(mc.valid.sum())
    assert tbkc._bisect_threshold(*tmc.pair_similarity(mc), k, True)[1] < k
    group, s = tbkc.join_to_groups(mc, k)
    jgroup, js = jbkc.join_to_groups(jmc_, k)
    np.testing.assert_array_equal(_np(group), np.asarray(jgroup))
    assert _np(s).tobytes() == np.asarray(js, np.float32).tobytes()
    assert set(_np(group).tolist()) <= set(range(k))


def test_bkc_entry_point_is_seeded_and_runs_where_x_lies(corpus_x):
    x = interop.data(corpus_x[0], "cpu")
    a = tbkc.bkc(x, BIG_K, K, torch.Generator().manual_seed(0))
    b = tbkc.bkc(x, BIG_K, K, torch.Generator().manual_seed(0), bounded=True)
    assert a.assignment.device.type == "cpu"
    assert torch.equal(a.assignment, b.assignment)
    assert set(a.assignment.tolist()) <= set(range(K))
    assert a.group_of_mc.shape == (BIG_K,)


def test_bkc_creators_default_to_the_card():
    """device=None means CUDA: without a card the BKC flow's creators raise
    and never fall back to the CPU; given CPU rows, bkc stays on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    corpus = synth.make_corpus(50, vocab=32, n_topics=2, seed=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.prepare_local(corpus)
    with pytest.raises(RuntimeError, match="CUDA"):
        tbkc.ops.bounds_identity(50)
    x, _ = pipeline.prepare_local(corpus, device="cpu")
    assert tbkc.bkc(x, 8, 2, torch.Generator(), bounded=True).centers.device.type == "cpu"
