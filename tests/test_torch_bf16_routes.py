"""bf16 document rows through the two-pass and bounded routes, against the
JAX package, on the CPU: the port's plain ``assign_argmax``,
``assign_stats_bounded`` and ``best_edge`` on bf16 inputs, then BKC on its
three routes, K-Means two-pass and bounded, and bounded Buckshot.

The same numpy draws, rounded to bf16 once, go through ``repro.kernels.ref``
and the Pallas kernels in interpret mode, and through the port's plain
versions (what a CPU tensor takes; on the card the kernels take the same
rows, held to assign_stats' bf16 pass bit for bit by
``tests/test_torch_gpu.py``). The tolerances are ``test_torch_bf16.py``'s:
integer rows with |v| <= 256 exact; unit rows: similarities within 1e-5,
sums within 1e-4 relative + 1e-5, labels equal (the draws hold no near-tie)
and, end to end, centers within 1e-6.
"""

from __future__ import annotations

import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.bkc  # noqa: F401  (the modules, not the re-exported functions)
import repro.core.buckshot  # noqa: F401
import repro.core.kmeans  # noqa: F401
import repro_torch.core.bkc  # noqa: F401
import repro_torch.core.buckshot  # noqa: F401
import repro_torch.core.kmeans  # noqa: F401
from repro.kernels import ref as jref
from repro.kernels.assign_argmax import assign_argmax_pallas
from repro.kernels.assign_stats import assign_stats_bounded_pallas
from repro.kernels.best_edge import best_edge_pallas
from repro.text import pipeline as jpipeline
from repro_torch import interop
from repro_torch.kernels import ops
from repro_torch.kernels.best_edge import BF16_STAGED_NARROW, BF16_STAGED_WIDE, bf16_label_path

jbkc, jb, jk = (sys.modules[f"repro.core.{m}"] for m in ("bkc", "buckshot", "kmeans"))
tbkc, tb, tk = (sys.modules[f"repro_torch.core.{m}"] for m in ("bkc", "buckshot", "kmeans"))

SIM_TOL = 1e-5
SUM_RTOL, SUM_ATOL = 1e-4, 1e-5
CENTER_ATOL = 1e-6
SIM = (0.0, SIM_TOL)
SUM = (SUM_RTOL, SUM_ATOL)


@pytest.fixture
def rng(request):
    """Seeded from the test's own name and parameters."""
    name = f"{request.module.__name__}::{request.node.name}"
    return np.random.default_rng(zlib.crc32(name.encode()))


def _port(j):
    """The port's tensor of a JAX array (bf16 -> f32 -> bf16 is exact)."""
    t = torch.from_numpy(np.array(j.astype(jnp.float32)))
    return t.bfloat16() if j.dtype == jnp.bfloat16 else t


def _rows(rng, shape, kind, dtype=jnp.bfloat16):
    """One draw as (JAX, port) with the same bits: integers in [-256, 256]
    (exact in bf16) or unit rows rounded to ``dtype``."""
    if kind == "int":
        a = rng.integers(-256, 257, size=shape).astype(np.float32)
    else:
        a = rng.normal(size=shape).astype(np.float32)
        a /= np.linalg.norm(a, axis=1, keepdims=True)
    j = jnp.asarray(a, dtype)
    return j, _port(j)


def _np(t):
    return interop.to_numpy(t.float() if t.dtype == torch.bfloat16 else t)


def _check(got, want, kind, tols):
    """Port outputs against JAX ones: exact on integer rows, else each
    within its (rtol, atol); integer and bool outputs always equal."""
    for g, w, tol in zip(got, want, tols):
        g, w = _np(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        if kind == "int" or w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=tol[0], atol=tol[1])


# d off the tiles: 40, 130 (a bf16 row off 16 bytes), 257 (odd)
CASES = [("int", 6, 6, 40), ("int", 90, 70, 130), ("float", 90, 70, 40), ("float", 160, 65, 257)]
CENTER_TYPES = [jnp.bfloat16, jnp.float32]


@pytest.mark.parametrize("cdt", CENTER_TYPES, ids=["bf16_centers", "f32_centers"])
@pytest.mark.parametrize("kind,n,k,d", CASES)
def test_assign_argmax_bf16_matches_jax(rng, kind, n, k, d, cdt):
    """bf16 x with bf16 centers (BKC's first pass) or f32 centers (its
    second pass, K-Means after its first)."""
    jx, x = _rows(rng, (n, d), kind)
    jc, c = _rows(rng, (k, d), kind, cdt)
    got = ops.assign_argmax(x, c)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.float32
    for want in (jref.assign_argmax(jx, jc), assign_argmax_pallas(jx, jc, interpret=True)):
        _check(got, want, kind, (None, SIM))


BOUNDED_TOLS = (None, SIM, SUM, SUM, SIM, SUM, None, SIM, SIM, None)


def _near(rng, n, k, d, kind, cdt):
    """bf16 rows near their centers, so carried bounds prune."""
    lab = rng.integers(0, k, size=n)
    if kind == "int":
        c = rng.integers(-4, 5, size=(k, d)).astype(np.float32)
        a = c[lab] + rng.integers(-1, 2, size=(n, d))
    else:
        c = rng.normal(size=(k, d)).astype(np.float32)
        c /= np.linalg.norm(c, axis=1, keepdims=True)
        a = c[lab] + 0.1 * rng.normal(size=(n, d)) / np.sqrt(d)
        a /= np.linalg.norm(a, axis=1, keepdims=True)
    jx, jc = jnp.asarray(a, jnp.bfloat16), jnp.asarray(c, cdt)
    return jx, _port(jx), jc, _port(jc)


@pytest.mark.parametrize("cdt", CENTER_TYPES, ids=["bf16_centers", "f32_centers"])
@pytest.mark.parametrize("kind,n,k,d", [("int", 90, 70, 130), ("float", 160, 65, 40)])
def test_assign_stats_bounded_bf16_matches_jax(rng, kind, n, k, d, cdt):
    """Under sentinel bounds, the bounds it carries after two centers move,
    and those bounds with every fifth row invalidated: the ten outputs of
    assign_stats_bounded_pallas in interpret mode (hi within SIM of it; the
    pruned rows equal)."""
    jx, x, jc, c = _near(rng, n, k, d, kind, cdt)
    wa = (rng.random(n) > 0.2).astype(np.float32)  # weight-0 rows
    jw, w = jnp.asarray(wa), interop.data(wa, "cpu")
    zero = np.zeros((k,), np.float32)
    jbounds = (jnp.full((n,), -1, jnp.int32), jnp.full((n,), -jref.BIG, jnp.float32),
               jnp.full((n,), jref.BIG, jnp.float32))
    bounds = ops.bounds_identity(n, "cpu")
    first = ops.assign_stats_bounded(x, c, bounds, torch.from_numpy(zero), w)
    want = assign_stats_bounded_pallas(jx, jc, *jbounds, jnp.asarray(zero), jw, interpret=True)
    _check(first[:6] + tuple(first.bounds) + (first.pruned,), want, kind, BOUNDED_TOLS)
    assert not first.pruned.any()

    step = 1.0 if kind == "int" else 0.01
    moved = np.array(jc.astype(jnp.float32))
    moved[0, 0] += step
    moved[k // 2, d - 1] -= step
    jm = jnp.asarray(moved, cdt)
    m = _port(jm)
    drift = np.linalg.norm(np.array(jm.astype(jnp.float32)) - np.array(jc.astype(jnp.float32)),
                           axis=1).astype(np.float32)
    stale = np.zeros((n,), bool)
    stale[::5] = True
    carried = ops.Bounds(*(t.clone() for t in first.bounds))
    for b in (carried, ops.bounds_invalidate(carried, torch.from_numpy(stale))):
        got = ops.assign_stats_bounded(x, m, b, torch.from_numpy(drift), w)
        jb_ = tuple(jnp.asarray(_np(t)) for t in b)
        want = assign_stats_bounded_pallas(jx, jm, *jb_, jnp.asarray(drift), jw, interpret=True)
        _check(got[:6] + tuple(got.bounds) + (got.pruned,), want, kind, BOUNDED_TOLS)
        assert got.pruned.any() and not got.pruned[b.idx < 0].any()
        _check(got[:6], jref.assign_stats(jx, jm, jw), kind, BOUNDED_TOLS)


@pytest.mark.parametrize("r,c", [(40, 70), (33, 129)])
def test_best_edge_bf16_block_matches_jax(rng, r, c):
    """A bf16 block (the JAX kernel upcasts it in its body): equal, since
    the kernel only compares; pad labels -1 and ties from integer values;
    then labels past the int16 range (32,767 to 32,771 among small ones, and
    row labels 65,536 + b whose low 16 bits equal column labels b) and
    labels below -1 (every negative label is padding): what the card's
    kernel stages as int16 labels, as their two halves, and as -1."""
    for a in (rng.integers(-3, 4, size=(r, c)), rng.normal(size=(r, c))):
        js = jnp.asarray(a, jnp.bfloat16)
        pad = rng.integers(-1, 4, size=r), rng.integers(-1, 4, size=c)
        wide = (rng.integers(-1, 4, size=r) + 65_536 * rng.integers(0, 2, size=r),
                rng.integers(-1, 4, size=c) + np.where(rng.random(c) < 0.3, 32_768, 0))
        pool = np.array([-2, -3, -32_768, -32_769, -65_537, -(2**31), 0, 1, 2, 3])
        below = rng.choice(pool, size=r), rng.choice(pool, size=c)
        for lr, lc in (pad, wide, below):
            jlr, jlc = jnp.asarray(lr, jnp.int32), jnp.asarray(lc, jnp.int32)
            got = ops.best_edge(_port(js), interop.labels(lr, "cpu"), interop.labels(lc, "cpu"))
            for want in (jref.best_edge(js, jlr, jlc),
                         best_edge_pallas(js, jlr, jlc, interpret=True)):
                _check(got, want, "int", (None, None))


@pytest.mark.parametrize("c,top,path", [
    (3536, 32_767, "int16 staged"),
    (3536, 32_768, "int16 halves staged"),
    (BF16_STAGED_NARROW, 5, "int16 staged"),
    (BF16_STAGED_NARROW + 1, 5, "int32 global"),
    (BF16_STAGED_WIDE, 70_000, "int16 halves staged"),
    (BF16_STAGED_WIDE + 1, 70_000, "int32 global"),
    (0, 0, "int16 staged"),
])
def test_best_edge_bf16_label_path(c, top, path):
    """What the card's kernel does with a bf16 block's column labels, as the
    wrapper reports it: int16 while every label fits (negative ones as -1)
    and the block has at most BF16_STAGED_NARROW columns, their two halves
    up to BF16_STAGED_WIDE columns, else the int32 labels from global
    memory."""
    lc = torch.full((c,), -7, dtype=torch.int32)
    if c:
        lc[c // 2] = top
    assert bf16_label_path(lc) == path


# ------------------------------------------------------------------ end to end


@pytest.fixture(scope="module")
def corpus_bf16(small_corpus):
    """make_corpus(800, vocab=256, n_topics=6, seed=11) tf-idf from JAX,
    rounded to bf16 once: (JAX bf16, port bf16)."""
    x, _ = jpipeline.prepare_local(small_corpus)
    j = jnp.asarray(x, jnp.bfloat16)
    return j, _port(j)


@pytest.fixture(scope="module")
def blobs_bf16():
    """800 x 64 unit rows around 6 topics, 5 % loose (pair values above 0,
    so BKC's bisection runs over real values), rounded to bf16 once."""
    r = np.random.default_rng(1)
    c = r.standard_normal((6, 64))
    lab = r.integers(0, 6, 800)
    sig = np.where(r.random(800) < 0.05, 3.0, 0.15)
    x = c[lab] + sig[:, None] * r.standard_normal((800, 64))
    j = jnp.asarray(x / np.linalg.norm(x, axis=1, keepdims=True), jnp.bfloat16)
    return j, _port(j)


ROUTES = [dict(fused=True), dict(fused=False), dict(fused=True, bounded=True)]


@pytest.mark.parametrize("data,big_k,k", [("tfidf", 40, 6), ("blobs", 60, 50)])
@pytest.mark.parametrize("route", ROUTES, ids=["fused", "two_pass", "bounded"])
def test_bkc_fit_bf16_matches_jax(corpus_bf16, blobs_bf16, data, big_k, k, route):
    """bf16 x with bf16 initial centers (the sampled documents): pass 1 on
    bf16 centers, pass 2 on the f32 centers of the groups, as in the JAX
    package. Groups and labels equal, centers within 1e-6, RSS within 1e-4;
    every route gives the fused route's answer. The threshold is held within
    1e-6 relative (measured: equal bits in both cases). The JAX package's
    pair matrix is jitted, and XLA's excess precision drops the bf16
    rounding of the centers' cosines, so its pair values are those of the
    f32 product; the port takes the f32 product. With the bf16 product the
    "blobs" threshold read 0.42873648 against 0.43017671 (2^-8 apart)."""
    jx, x = corpus_bf16 if data == "tfidf" else blobs_bf16
    rows = np.random.default_rng(7).choice(x.shape[0], big_k, replace=False)
    jinit = jx[jnp.asarray(rows)]
    got = tbkc.bkc_fit(x, _port(jinit), big_k, k, **route)
    want = jbkc.bkc_fit(jx, jinit, big_k, k, **route)
    np.testing.assert_array_equal(_np(got.group_of_mc), np.asarray(want.group_of_mc))
    np.testing.assert_array_equal(_np(got.assignment), np.asarray(want.assignment))
    np.testing.assert_allclose(_np(got.threshold), np.asarray(want.threshold), rtol=1e-6, atol=0)
    np.testing.assert_allclose(_np(got.centers), np.asarray(want.centers), atol=CENTER_ATOL)
    np.testing.assert_allclose(_np(got.best_sim), np.asarray(want.best_sim), atol=SIM_TOL)
    np.testing.assert_allclose(got.rss.item(), float(want.rss), rtol=SUM_RTOL)
    assert got.centers.dtype == torch.float32
    if route != ROUTES[0]:
        fused = tbkc.bkc_fit(x, _port(jinit), big_k, k)
        assert torch.equal(got.group_of_mc, fused.group_of_mc)
        assert torch.equal(got.assignment, fused.assignment)


def _same_fit(got, want):
    np.testing.assert_array_equal(_np(got.assignment), np.asarray(want.assignment))
    np.testing.assert_allclose(_np(got.centers), np.asarray(want.centers), atol=CENTER_ATOL)
    np.testing.assert_allclose(_np(got.best_sim), np.asarray(want.best_sim), atol=SIM_TOL)
    np.testing.assert_allclose(got.rss.item(), float(want.rss), rtol=SUM_RTOL)
    assert got.iterations == int(want.iterations)


@pytest.mark.parametrize("route", ROUTES[1:], ids=["two_pass", "bounded"])
def test_kmeans_fit_bf16_routes_match_jax(corpus_bf16, route):
    """bf16 x with f32 initial centers (the JAX kmeans_fit raises at its
    while_loop carry on bf16 ones), two-pass and bounded."""
    jx, x = corpus_bf16
    rows = np.random.default_rng(3).choice(800, 6, replace=False)
    init = np.asarray(jx.astype(jnp.float32))[rows]
    init /= np.linalg.norm(init, axis=1, keepdims=True)
    want = jk.kmeans_fit(jx, jnp.asarray(init), 6, **route)
    got = tk.kmeans_fit(x, interop.data(init, "cpu"), 6, **route)
    _same_fit(got, want)


def test_buckshot_fit_bounded_bf16_matches_jax(corpus_bf16):
    jx, x = corpus_bf16
    sidx = np.random.default_rng(0).choice(x.shape[0], 70, replace=False)
    want = jb.buckshot_fit(jx, jnp.asarray(sidx), 6, bounded=True)
    got = tb.buckshot_fit(x, interop.index(sidx, "cpu"), 6, bounded=True)
    np.testing.assert_array_equal(_np(got.sample_labels), np.asarray(want.sample_labels))
    np.testing.assert_allclose(_np(got.init_centers), np.asarray(want.init_centers),
                               atol=CENTER_ATOL)
    _same_fit(got.kmeans, want.kmeans)


def test_two_pass_row_norms_take_no_f32_copy(monkeypatch):
    """The two-pass routes' squared row norms (BKC's CF2, the RSS) go over
    row blocks of a bf16 x, never an f32 copy of all of it, and equal the
    f32 upcast's to f32 rounding; f32 x goes through whole."""
    from repro_torch import common

    x = torch.randn(1000, 48, generator=torch.Generator().manual_seed(2)).bfloat16()
    blocks = list(common.f32_row_blocks(x, elems=48 * 300))
    assert [b.shape[0] for b in blocks] == [300, 300, 300, 100]
    assert all(b.dtype == torch.float32 for b in blocks)
    xf = x.float()
    torch.testing.assert_close(common.sq_row_norms(x), (xf * xf).sum(1), rtol=1e-6, atol=0)
    (only,) = common.f32_row_blocks(xf)
    assert only is xf
    seen = []
    real = common.f32_row_blocks
    monkeypatch.setattr(common, "f32_row_blocks",
                        lambda t, elems=1 << 24: seen.append(t.dtype) or real(t, 48 * 300))
    import repro_torch.core.metrics as tmetrics
    import repro_torch.core.microcluster as tmc

    monkeypatch.setattr(tmetrics, "f32_row_blocks", common.f32_row_blocks)
    labels = torch.randint(0, 5, (1000,), generator=torch.Generator().manual_seed(3))
    rss = tmetrics.rss(x, labels, 5)
    sums = torch.zeros(5, 48).index_add_(0, labels, xf)
    counts = torch.bincount(labels, minlength=5).float()
    want = (xf * xf).sum() - (sums * sums).sum(1).div(counts.clamp(min=1)).sum()
    torch.testing.assert_close(rss, want, rtol=1e-5, atol=0)
    mc = tmc.build_microclusters(x, x[:5], 5, fused=False)[0]
    torch.testing.assert_close(mc.cf2, torch.zeros(5).index_add_(
        0, ops.assign_argmax(x, x[:5])[0].long(), (xf * xf).sum(1)), rtol=1e-5, atol=0)
    assert seen and all(dt == torch.bfloat16 for dt in seen)
