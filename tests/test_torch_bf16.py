"""bf16 document rows through the port's plain kernels, Buckshot and K-Means,
against the JAX package, on the CPU.

The JAX package's document kernels take bf16 rows and accumulate in f32
(``DESIGN.md``: "bf16 x/centers are accepted and accumulated in f32"). The
same numpy draws, rounded to bf16 once, go through ``repro.kernels.ref`` and
the Pallas kernels in interpret mode, and through the port's plain versions
(what a CPU tensor takes; on the card the kernels take the same rows, held
to their f32 mode bit for bit by ``tests/test_torch_gpu.py``).

Tolerances: integer-valued rows with |v| <= 256 are exact in bf16 and every
product and sum of them is exact in f32, so there every output is equal.
Float rows (unit rows, as documents are): similarities within 1e-5
absolute; sums, counts and squared norms within 1e-4 relative + 1e-5
absolute (the libraries add in other orders); labels equal (the draws hold
no near-tie). End to end: labels
equal, centers within 1e-6 (a few f32 ulp of a unit vector's entries).
"""

from __future__ import annotations

import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.buckshot  # noqa: F401  (the modules, not the re-exported functions)
import repro.core.kmeans  # noqa: F401
import repro_torch.core.buckshot  # noqa: F401
import repro_torch.core.kmeans  # noqa: F401
from repro.kernels import ref as jref
from repro.kernels.assign_stats import assign_stats_pallas, label_stats_pallas
from repro.kernels.sim_best_edge import sim_best_edge_pallas
from repro.text import pipeline as jpipeline
from repro_torch import interop
from repro_torch.kernels import ops, ref

jb, jk = (sys.modules[f"repro.core.{m}"] for m in ("buckshot", "kmeans"))
tb, tk = (sys.modules[f"repro_torch.core.{m}"] for m in ("buckshot", "kmeans"))

SIM_TOL = 1e-5
SUM_RTOL, SUM_ATOL = 1e-4, 1e-5
CENTER_ATOL = 1e-6


@pytest.fixture
def rng(request):
    """Seeded from the test's own name and parameters."""
    name = f"{request.module.__name__}::{request.node.name}"
    return np.random.default_rng(zlib.crc32(name.encode()))


def _rows(rng, shape, kind):
    """One draw as (JAX bf16, port bf16) with the same bits: integers in
    [-256, 256] (exact in bf16) or unit rows (documents) rounded to bf16."""
    if kind == "int":
        a = rng.integers(-256, 257, size=shape).astype(np.float32)
    else:
        a = rng.normal(size=shape).astype(np.float32)
        a /= np.linalg.norm(a, axis=1, keepdims=True)
    j = jnp.asarray(a, jnp.bfloat16)
    return j, _port(j)


def _port(j):
    """The port's bf16 tensor of a JAX bf16 array (bf16 -> f32 -> bf16 is
    exact both ways)."""
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()
    assert np.array_equal(t.float().numpy(), np.asarray(j.astype(jnp.float32)))
    return t


def _labels(rng, lo, hi, n):
    a = rng.integers(lo, hi, size=n).astype(np.int32)
    return jnp.asarray(a), interop.labels(a, "cpu")


def _np(t):
    return interop.to_numpy(t.float() if t.dtype == torch.bfloat16 else t)


def _check(got, want, kind, tols):
    """Port outputs against JAX ones: exact on integer rows, else each within
    its (rtol, atol); integer outputs always equal."""
    for g, w, tol in zip(got, want, tols):
        g, w = _np(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        if kind == "int" or w.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=tol[0], atol=tol[1])


SIM = (0.0, SIM_TOL)
SUM = (SUM_RTOL, SUM_ATOL)
# d off every tile: 40 (not a multiple of 32 columns), 130 (not of 8: a bf16
# row off 16 bytes), 257 (odd)
CASES = [("int", 6, 6, 40), ("int", 90, 121, 130), ("int", 33, 257, 257),
         ("float", 90, 121, 40), ("float", 256, 256, 130), ("float", 300, 70, 257)]


@pytest.mark.parametrize("kind,r,c,d", CASES)
def test_sim_best_edge_bf16_matches_jax(rng, kind, r, c, d):
    jxr, xr = _rows(rng, (r, d), kind)
    jxc, xc = _rows(rng, (c, d), kind)
    jlr, lr = _labels(rng, -1, 5, r)  # -1 = pad
    jlc, lc = _labels(rng, -1, 5, c)
    got = ops.sim_best_edge(xr, xc, lr, lc)
    assert got[1].dtype == torch.float32
    for want in (jref.sim_best_edge(jxr, jxc, jlr, jlc),
                 sim_best_edge_pallas(jxr, jxc, jlr, jlc, interpret=True)):
        _check(got, want, kind, (None, SIM))
    # and the self-search form of the resident Borůvka round
    jl, lab = _labels(rng, 0, r // 3 + 1, r)
    _check(ops.sim_best_edge(xr, xr, lab, lab),
           sim_best_edge_pallas(jxr, jxr, jl, jl, interpret=True), kind, (None, SIM))


@pytest.mark.parametrize("kind,n,k,d", [(kind, r, min(c, 70), d) for kind, r, c, d in CASES])
def test_label_stats_bf16_matches_jax(rng, kind, n, k, d):
    jx, x = _rows(rng, (n, d), kind)
    jidx, idx = _labels(rng, -2, k + 2, n)  # out of range too
    wa = rng.integers(0, 3, size=n).astype(np.float32)  # weight-0 rows
    for jw, w in ((None, None), (jnp.asarray(wa), interop.data(wa, "cpu"))):
        got = ops.label_stats(x, idx, k, w)
        assert got[0].dtype == torch.float32
        _check(got, ref.label_stats(x, idx, k, w), kind, (SUM, SUM))
        for want in (jref.label_stats(jx, jidx, k, jw),
                     label_stats_pallas(jx, jidx, k, jw, interpret=True)):
            _check(got, want, kind, (SUM, SUM))


STATS_TOLS = (None, SIM, SUM, SUM, SIM, SUM)


@pytest.mark.parametrize("centers_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kind,n,k,d", [(kind, r, min(c, 70), d) for kind, r, c, d in CASES])
def test_assign_stats_bf16_matches_jax(rng, kind, n, k, d, centers_dtype):
    """x in bf16 with bf16 centers (the JAX sweep) or f32 centers (what
    K-Means passes after its first iteration)."""
    jx, x = _rows(rng, (n, d), kind)
    jc, c = _rows(rng, (k, d), kind)
    if centers_dtype == "float32":
        jc, c = jc.astype(jnp.float32), c.float()
    wa = (rng.random(n) > 0.2).astype(np.float32)  # weight-0 rows
    for jw, w in ((None, None), (jnp.asarray(wa), interop.data(wa, "cpu"))):
        got = ops.assign_stats(x, c, w)
        assert all(t.dtype == torch.float32 for t in got[1:])
        _check(got, ref.assign_stats(x, c, w), kind, STATS_TOLS)
        wants = [jref.assign_stats(jx, jc, jw)]
        if centers_dtype == "bfloat16":  # the Pallas kernel takes one dtype
            wants.append(assign_stats_pallas(jx, jc, jw, interpret=True))
        for want in wants:
            _check(got, want, kind, STATS_TOLS)


# ------------------------------------------------------------------ end to end


@pytest.fixture(scope="module")
def corpus_bf16(small_corpus):
    """make_corpus(800, vocab=256, n_topics=6, seed=11) tf-idf from JAX,
    rounded to bf16 once: (JAX bf16, port bf16)."""
    x, _ = jpipeline.prepare_local(small_corpus)
    j = jnp.asarray(x, jnp.bfloat16)
    return j, _port(j)


def _same_fit(got, want):
    np.testing.assert_array_equal(_np(got.assignment), np.asarray(want.assignment))
    np.testing.assert_allclose(_np(got.centers), np.asarray(want.centers), atol=CENTER_ATOL)
    np.testing.assert_allclose(_np(got.best_sim), np.asarray(want.best_sim), atol=SIM_TOL)
    np.testing.assert_allclose(got.rss.item(), float(want.rss), rtol=SUM_RTOL)
    assert got.iterations == int(want.iterations)


@pytest.mark.parametrize("fused", [True, False])
def test_buckshot_fit_bf16_matches_jax(corpus_bf16, fused):
    jx, x = corpus_bf16
    k = 6
    sidx = np.random.default_rng(0).choice(x.shape[0], 70, replace=False)
    want = jb.buckshot_fit(jx, jnp.asarray(sidx), k, fused=fused)
    got = tb.buckshot_fit(x, interop.index(sidx, "cpu"), k, fused=fused)
    np.testing.assert_array_equal(_np(got.sample_labels), np.asarray(want.sample_labels))
    np.testing.assert_allclose(_np(got.init_centers), np.asarray(want.init_centers),
                               atol=CENTER_ATOL)
    _same_fit(got.kmeans, want.kmeans)


def test_kmeans_fit_bf16_matches_jax(corpus_bf16):
    """bf16 x with f32 initial centers (the JAX kmeans_fit raises at its
    while_loop carry when the initial centers are bf16)."""
    jx, x = corpus_bf16
    rows = np.random.default_rng(3).choice(800, 6, replace=False)
    init = np.asarray(jx.astype(jnp.float32))[rows]
    init /= np.linalg.norm(init, axis=1, keepdims=True)
    want = jk.kmeans_fit(jx, jnp.asarray(init), 6)
    got = tk.kmeans_fit(x, interop.data(init, "cpu"), 6)
    _same_fit(got, want)


def test_kmeans_bf16_initial_centers_take_f32_after_one_step(corpus_bf16):
    """The port's own baseline (``kmeans`` draws its centers from bf16 x):
    the first pass takes bf16 centers, held to the reference's assign_stats
    on the same bf16 centers; the next ones take the f32 centers it
    computed. The fit equals kmeans_fit from the f32 upcast of those first
    centers in every label (the products are the same), the port's and the
    JAX package's (whose kmeans_fit raises on bf16 initial centers)."""
    jx, x = corpus_bf16
    res = tk.kmeans(x, 6, torch.Generator().manual_seed(4), max_iters=4)
    init = tk.init_random_centers(x, 6, torch.Generator().manual_seed(4))
    assert init.dtype == torch.bfloat16 and res.centers.dtype == torch.float32
    jinit = jnp.asarray(_np(init), jnp.bfloat16)
    _check(ops.assign_stats(x, init), jref.assign_stats(jx, jinit), "float", STATS_TOLS)
    again = tk.kmeans_fit(x, init.float(), 6, max_iters=4)
    assert torch.equal(res.assignment, again.assignment)
    assert res.iterations == again.iterations
    _same_fit(res, jk.kmeans_fit(jx, jinit.astype(jnp.float32), 6, max_iters=4))
