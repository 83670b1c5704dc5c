"""The port's bound-pruned assignment against the JAX package's, on the CPU.

The same numpy inputs go through ``repro`` (its plain versions, its XLA path
and its Pallas kernel in interpret mode) and through ``repro_torch`` (the
plain versions a CPU tensor takes). Integer outputs (labels, the pruned mask,
the carried bounds' index) must be equal; floats exact on integer-valued
inputs and within 1e-6 relative otherwise (1e-6 absolute near 0), since the
two libraries add in different orders. The Pallas kernel's hi is an upper
bound that may exceed the exact second value where it skipped a slab, so
there the port's exact hi must not exceed it.
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
from repro.common import l2_normalize as jl2
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import interop
from repro_torch.kernels import ops, ref

jb, jk = (sys.modules[f"repro.core.{m}"] for m in ("buckshot", "kmeans"))
tb, tk = (sys.modules[f"repro_torch.core.{m}"] for m in ("buckshot", "kmeans"))

RTOL = ATOL = 1e-6
NAMES = ("idx", "best_sim", "sums", "counts", "min_sim", "sumsq", "b.idx", "lo", "hi", "pruned")


@pytest.fixture
def rng(request):
    """This module's generator, seeded from the test's own name (and its
    parameters): its draws do not depend on which tests a worker ran before
    (conftest's session-wide generator's do)."""
    name = f"{request.module.__name__}::{request.node.name}"
    return np.random.default_rng(zlib.crc32(name.encode()))


def _np(t):
    return interop.to_numpy(t)


def _t(a):
    a = np.asarray(a)
    if a.dtype == bool:
        return torch.from_numpy(a.copy())
    return interop.labels(a, "cpu") if a.dtype.kind in "iu" else interop.data(a, "cpu")


def _blobs(rng, n, k, d, noise=0.3):
    """Clustered unit rows: the drift settles fast, so carried bounds prune."""
    c = rng.normal(size=(k, d)) * 3.0
    x = c[rng.integers(0, k, size=n)] + noise * rng.normal(size=(n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _flat(st):
    """An AssignStatsBounded (either package) as its ten outputs."""
    return (st.idx, st.best_sim, st.sums, st.counts, st.min_sim, st.sumsq,
            st.bounds.idx, st.bounds.lo, st.bounds.hi, st.pruned)


def _same(got, want, *, exact, skip=()):
    for name, g, w in zip(NAMES, got, want):
        if name in skip:
            continue
        g, w = _np(g), np.asarray(w)
        assert g.shape == w.shape, name
        if exact or w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=name)


def _update(centers, sums, counts):
    means = sums / np.maximum(counts, 1.0)[:, None]
    norm = np.maximum(np.linalg.norm(means, axis=1, keepdims=True), 1e-12)
    return np.where(counts[:, None] > 0, means / norm, centers).astype(np.float32)


def _sentinel(n):
    return (np.full(n, -1, np.int32), np.full(n, -ref.BIG, np.float32),
            np.full(n, ref.BIG, np.float32))


# ------------------------------------------------------------------ plain op


def test_deflate_bounds_matches_jax(rng):
    n, k = 50, 9
    prev = rng.integers(-2, k + 2, size=n).astype(np.int32)  # sentinel and oob
    lo, hi = rng.normal(size=n).astype(np.float32), rng.normal(size=n).astype(np.float32)
    rownorm = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    drift = rng.uniform(0.0, 0.1, size=k).astype(np.float32)
    drift[7] = drift[2] = drift.max() + 0.01  # two largest: argmax takes the first
    got = ref.deflate_bounds(_t(prev), _t(lo), _t(hi), _t(rownorm), _t(drift))
    want = jref.deflate_bounds(prev, lo, hi, rownorm, drift)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=RTOL, atol=0)
    assert _np(got[0]).sum() < n  # some sentinels


@pytest.mark.parametrize("plain", ["assign_stats_bounded", "assign_stats_bounded_scatter"])
@pytest.mark.parametrize("n,k,d", [(7, 3, 5), (64, 16, 32), (300, 17, 70), (260, 130, 24)])
def test_bounded_sentinel_matches_jax(rng, plain, n, k, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    c = rng.normal(size=(k, d)).astype(np.float32)
    drift = np.zeros(k, np.float32)
    b = _sentinel(n)
    got = getattr(ref, plain)(_t(x), _t(c), *map(_t, b), _t(drift))
    want = getattr(jref, plain)(x, c, *b, drift)
    _same(got, want, exact=False)
    assert not _np(got[9]).any()
    np.testing.assert_array_equal(_np(got[0]), np.asarray(jref.assign_argmax(x, c)[0]))


def test_bounded_ops_match_xla_and_pallas_interpret(rng):
    """The port's dispatch on the CPU against JAX's XLA path and its Pallas
    kernel run by the interpreter, sentinel and carried, weight-0 rows in,
    with a center index (which only JAX's kernel uses)."""
    n, k, d = 300, 130, 24  # two of the Pallas kernel's 128-wide slabs
    x = _blobs(rng, n, 12, d)
    c = x[rng.choice(n, k, replace=False)]
    w = (rng.random(n) > 0.2).astype(np.float32)
    drift = np.zeros(k, np.float32)
    bounds = _sentinel(n)
    index = jops.build_center_index(jnp.asarray(c))
    for step in range(3):
        got = ops.assign_stats_bounded(_t(x), _t(c), ops.Bounds(*map(_t, bounds)), _t(drift), _t(w))
        jb_ = jops.Bounds(*map(jnp.asarray, bounds))
        xla = jops.assign_stats_bounded(x, c, jb_, drift, jnp.asarray(w), impl="xla")
        _same(_flat(got), _flat(xla), exact=False)
        pal = jops.assign_stats_bounded(
            x, c, jb_, drift, jnp.asarray(w), index=index, impl="pallas_interpret")
        _same(_flat(got), _flat(pal), exact=False, skip=("hi",))
        assert (_np(got.bounds.hi) <= np.asarray(pal.bounds.hi) + 1e-6).all()
        if step == 1:
            assert _np(got.pruned).any()  # unmoved centers: settled rows prune
        # next step: the carried bounds, with the centers first kept, then moved
        new_c = c if step == 0 else _update(c, np.asarray(xla.sums), np.asarray(xla.counts))
        drift = np.linalg.norm(new_c - c, axis=1).astype(np.float32)
        c, bounds = new_c, tuple(np.asarray(a) for a in xla.bounds)


def _lloyd_bounded(rng, near_ties):
    """Eight Lloyd iterations; each step both packages get the same centers
    and the same input bounds (JAX's from the step before). Returns the rows
    whose labels differ (iteration, row), each a near-tie, and the rows
    pruned over all steps. Without near_ties labels equal JAX's and the brute
    sweep's every step."""
    n, k, d = 600, 16, 48
    x = _blobs(rng, n, k, d)
    centers = x[:k].copy()
    w = np.ones(n, np.float32)
    w[::11] = 0.0  # pad rows of a streaming chunk
    bounds, drift = _sentinel(n), np.zeros(k, np.float32)
    pruned, differ = 0, []
    for it in range(8):
        got = ref.assign_stats_bounded_scatter(
            _t(x), _t(centers), *map(_t, bounds), _t(drift), _t(w))
        want = jref.assign_stats_bounded_scatter(x, centers, *bounds, drift, jnp.asarray(w))
        brute = np.asarray(jref.assign_argmax(x, centers)[0])
        if near_ties:
            rows = np.nonzero(_np(got[0]) != np.asarray(want[0]))[0]
            for r in rows:
                differ.append((it, int(r)))
                s64 = x[r].astype(np.float64) @ centers.astype(np.float64).T
                pick, other = s64[_np(got[0])[r]], s64[np.asarray(want[0])[r]]
                # a near-tie of two f32 libraries: the picks' exact similarities
                # lie within 4 f32 ulps, the port's pick within that of the best
                assert abs(pick - other) <= 4 * np.spacing(np.float32(s64.max())), (it, r)
                assert s64.max() - pick <= 4 * np.spacing(np.float32(s64.max())), (it, r)
            keep = np.ones(n, bool)
            keep[rows] = False
            for name, g, wv in zip(NAMES, got, want):
                g, wv = _np(g), np.asarray(wv)
                if name in ("idx", "b.idx"):
                    np.testing.assert_array_equal(g[keep], wv[keep], err_msg=name)
                elif name == "pruned":
                    np.testing.assert_array_equal(g, wv, err_msg=name)
            # the statistics are those of the port's own labels
            lab = _np(got[0])
            np.testing.assert_allclose(
                _np(got[3]), np.bincount(lab, weights=w, minlength=k), rtol=0, atol=0)
        else:
            _same(got, want, exact=False)
            np.testing.assert_array_equal(_np(got[0]), brute, err_msg=f"it{it}")
        pruned += int(_np(got[9]).sum())
        new_c = _update(centers, np.asarray(want[2]), np.asarray(want[3]))
        drift = np.linalg.norm(new_c - centers, axis=1).astype(np.float32)
        centers, bounds = new_c, tuple(np.asarray(a) for a in want[6:9])
    return differ, pruned


def test_bounded_carried_over_lloyd_iterations(rng):
    """Labels, bounds and statistics equal JAX's every step, and pruning
    fires once the centers settle."""
    differ, pruned = _lloyd_bounded(rng, near_ties=False)
    assert not differ and pruned > 0


# The session generator's state at the start of the test above when it
# failed in a whole-suite run (6 workers, --dist loadfile), before the
# module drew its own: at iteration 2 row 25's two best centers (0 and 7)
# lie 1.24e-7 apart in float64, 2.07 f32 ulps of 0.9955, and the two
# packages' f32 sums pick different ones.
_CAPTURED_LLOYD = {
    "bit_generator": "PCG64",
    "state": {"state": 185112854581694410313412410634648233266,
              "inc": 87136372517582989555478159403783844777},
    "has_uint32": 1, "uinteger": 2604231736,
}


def test_bounded_carried_over_lloyd_iterations_captured_near_tie():
    """The captured draw: every label but the near-tie's equals JAX's (that
    one may go either way, within 4 f32 ulps of the best), the pruned masks
    equal, pruning fires."""
    rng = np.random.default_rng()
    rng.bit_generator.state = _CAPTURED_LLOYD
    differ, pruned = _lloyd_bounded(rng, near_ties=True)
    assert set(differ) <= {(2, 25)} and pruned > 0


@pytest.mark.parametrize("weighted", [False, True])
def test_bounded_integer_data_exact(rng, weighted):
    """Integer-valued data: all ten outputs equal JAX's plain versions bit for
    bit, sentinel and carried; against the Pallas kernel all but hi."""
    n, k, d = 300, 17, 70
    c = rng.integers(-4, 5, size=(k, d)).astype(np.float32)
    x = (c[rng.integers(0, k, size=n)] + rng.integers(-1, 2, size=(n, d))).astype(np.float32)
    c[k - 1] = c[0]  # loses every tie to center 0: an empty cluster
    w = rng.integers(0, 3, size=n).astype(np.float32) if weighted else None
    tw, jw = (None, None) if w is None else (_t(w), jnp.asarray(w))
    bounds, drift = _sentinel(n), np.zeros(k, np.float32)
    for step in range(2):
        for plain in ("assign_stats_bounded", "assign_stats_bounded_scatter"):
            got = getattr(ref, plain)(_t(x), _t(c), *map(_t, bounds), _t(drift), tw)
            want = getattr(jref, plain)(x, c, *bounds, drift, jw)
            _same(got, want, exact=True)
        pal = jops.assign_stats_bounded(
            x, c, jops.Bounds(*map(jnp.asarray, bounds)), drift, jw, impl="pallas_interpret")
        _same(got, _flat(pal), exact=True, skip=("hi",))
        moved = c.copy()
        moved[1, 0] += 1.0
        drift = np.linalg.norm(moved - c, axis=1).astype(np.float32)
        c, bounds = moved, tuple(np.asarray(a) for a in want[6:9])
    assert _np(got[9]).any()
    assert _np(got[4])[k - 1] == ref.BIG


def test_bounded_duplicate_center_tie(rng):
    """A duplicate best center: the lowest ORIGINAL id wins, and the duplicate
    counts as the second best, so such a row can never prune."""
    c = rng.normal(size=(20, 16)).astype(np.float32)
    c[13] = c[2]
    x = np.repeat(c[2:3], 5, axis=0)
    got = ops.assign_stats_bounded(_t(x), _t(c), ops.bounds_identity(5, "cpu"), torch.zeros(20))
    assert (_np(got.idx) == 2).all()
    np.testing.assert_array_equal(_np(got.bounds.hi), _np(got.best_sim))
    again = ops.assign_stats_bounded(_t(x), _t(c), got.bounds, torch.zeros(20))
    assert not _np(again.pruned).any() and (_np(again.idx) == 2).all()
    want = jops.assign_stats_bounded(
        x, c, jops.bounds_identity(5), np.zeros(20, np.float32), impl="pallas_interpret")
    np.testing.assert_array_equal(_np(got.idx), np.asarray(want.idx))


def test_bounds_invalidate_forces_full_sweep(rng):
    n, k, d = 200, 8, 32
    x = _blobs(rng, n, k, d)
    c = _t(x[:k])
    zero = torch.zeros(k)
    first = ops.assign_stats_bounded(_t(x), c, ops.bounds_identity(n, "cpu"), zero)
    again = ops.assign_stats_bounded(_t(x), c, first.bounds, zero)
    assert _np(again.pruned).any()  # zero drift: most rows prune
    stale = torch.from_numpy(np.arange(n) % 2 == 0)
    inv = ops.bounds_invalidate(first.bounds, stale)
    want = jops.bounds_invalidate(
        jops.Bounds(*(np.asarray(_np(a)) for a in first.bounds)), np.asarray(stale))
    for g, w in zip(inv, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    third = ops.assign_stats_bounded(_t(x), c, inv, zero)
    assert not _np(third.pruned)[::2].any()
    assert torch.equal(third.idx, first.idx)


def test_bounds_identity_and_env_default(monkeypatch):
    b = ops.bounds_identity(4, "cpu")
    jb_ = jops.bounds_identity(4)
    for g, w in zip(b, jb_):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    monkeypatch.delenv("REPRO_ASSIGN_BOUNDS", raising=False)
    assert ops.bounds_enabled(None) is False and ops.bounds_enabled(True) is True
    monkeypatch.setenv("REPRO_ASSIGN_BOUNDS", "1")
    assert ops.bounds_enabled(None) is True
    assert ops.bounds_enabled(False) is False  # an explicit flag wins
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ops.bounds_identity(4)  # a creator: device=None means the card


# ------------------------------------------------------------------ center index


@pytest.mark.parametrize("k,d", [(5, 8), (16, 32), (100, 24), (257, 16)])
def test_build_center_index_matches_jax(rng, k, d):
    c = np.asarray(jl2(jnp.asarray(rng.normal(size=(k, d)).astype(np.float32))))
    got = ops.build_center_index(_t(c))
    want = jops.build_center_index(jnp.asarray(c))
    np.testing.assert_array_equal(_np(got.perm), np.asarray(want.perm))
    np.testing.assert_array_equal(_np(got.group_of), np.asarray(want.group_of))
    np.testing.assert_array_equal(np.sort(_np(got.perm)), np.arange(k))
    # one center makes one group: the identity order, as in JAX
    trivial = ops.build_center_index(_t(c[:1]))
    np.testing.assert_array_equal(_np(trivial.perm), np.asarray(
        jops.build_center_index(jnp.asarray(c[:1])).perm))
    np.testing.assert_array_equal(_np(trivial.group_of), [0])


@pytest.mark.parametrize("k,slab", [(5, 64), (70, 64), (130, 16)])
def test_slab_cones_bound_every_member(rng, k, slab):
    """The bounded kernel's prep: centers in perm order in whole slabs (pad
    id -1), and each slab's cone bound caps x . c for every member."""
    from repro_torch.kernels.assign_stats import slab_cones

    d = 24
    c = _blobs(rng, k, 4, d)
    x = torch.from_numpy(rng.normal(size=(200, d)).astype(np.float32))
    perm = ops.build_center_index(_t(c)).perm
    cp, perm_p, reps, cone = slab_cones(_t(c), perm, slab)
    ns = -(-k // slab)
    assert cp.shape == (ns * slab, d) and reps.shape == (ns, d) and cone.shape == (3, ns)
    np.testing.assert_array_equal(_np(perm_p[:k]), _np(perm))
    assert (_np(perm_p[k:]) == -1).all() and (_np(cp[k:]) == 0).all()
    np.testing.assert_array_equal(_np(cp[:k]), c[_np(perm)])
    s = x @ reps.T  # (n, ns)
    t = torch.sqrt(torch.clamp((x * x).sum(1, keepdim=True) - s * s, min=0.0))
    ub = torch.maximum(cone[0] * s, cone[1] * s) + cone[2] * t
    sims = (x @ cp.T).view(200, ns, slab)
    member = (perm_p >= 0).view(ns, slab)
    assert (torch.where(member, sims, -np.inf) <= ub[:, :, None] + 1e-5).all()


# ------------------------------------------------------------------ K-Means


def _two_blobs(rng):
    d = 8
    x = np.zeros((80, d), np.float32)
    x[:40, 0] = 1.0
    x[40:, 1] = 1.0
    x = x + 0.05 * rng.normal(size=(80, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    init = np.zeros((3, d), np.float32)
    init[0, 0] = init[1, 1] = 1.0
    init[2, 0] = -1.0  # antipodal: no document picks it -> reseeds
    return x, init


def test_kmeans_step_bounded_reseed_invalidates(rng):
    """reseed='split': the rows of the donor cluster come out with sentinel
    bounds, and the next bounded step still matches the unbounded one."""
    x, init = _two_blobs(rng)
    c_b, st = tk.kmeans_step_bounded(
        _t(x), _t(init), _t(init), ops.bounds_identity(80, "cpu"), 3, reseed="split")
    jc_b, jst = jk.kmeans_step_bounded(
        jnp.asarray(x), jnp.asarray(init), jnp.asarray(init), jops.bounds_identity(80), 3,
        reseed="split")
    c_u, idx_u = tk.kmeans_step(_t(x), _t(init), 3, reseed="split")[:2]
    assert torch.equal(c_b, c_u) and torch.equal(st.idx, idx_u)
    np.testing.assert_allclose(_np(c_b), np.asarray(jc_b), atol=1e-6)
    _same(_flat(st), _flat(jst), exact=False)
    stale = _np(st.bounds.idx) == -1
    labs = _np(st.idx)
    donors = set(labs[stale].tolist())
    assert len(donors) == 1 and (stale == (labs == donors.pop())).all()

    c_b2, st2 = tk.kmeans_step_bounded(_t(x), c_b, _t(init), st.bounds, 3, reseed="split")
    c_u2, idx_u2 = tk.kmeans_step(_t(x), c_b, 3, reseed="split")[:2]
    assert torch.equal(c_b2, c_u2) and torch.equal(st2.idx, idx_u2)
    with pytest.raises(ValueError, match="reseed"):
        tk.kmeans_step_bounded(_t(x), c_b, c_b, st.bounds, 3, reseed="bogus")


def test_kmeans_fit_bounded_matches_jax_and_unbounded(blob_data):
    x, _, k = blob_data
    x = np.asarray(x)
    init = x[:k]
    got = tk.kmeans_fit(_t(x), _t(init), k, tol=0.0, bounded=True)
    plain = tk.kmeans_fit(_t(x), _t(init), k, tol=0.0)
    want = jk.kmeans_fit(jnp.asarray(x), jnp.asarray(init), k, tol=0.0, bounded=True)
    assert torch.equal(got.assignment, plain.assignment)
    assert torch.equal(got.centers, plain.centers)
    assert got.iterations == plain.iterations == int(want.iterations)
    np.testing.assert_array_equal(_np(got.assignment), np.asarray(want.assignment))
    np.testing.assert_allclose(_np(got.centers), np.asarray(want.centers), atol=1e-6)
    np.testing.assert_allclose(got.rss.item(), float(want.rss), rtol=1e-5)


def test_kmeans_entry_point_defers_to_the_environment(blob_data, monkeypatch):
    x = _t(np.asarray(blob_data[0]))
    monkeypatch.setenv("REPRO_ASSIGN_BOUNDS", "1")
    a = tk.kmeans(x, 8, torch.Generator().manual_seed(0), max_iters=3)
    monkeypatch.delenv("REPRO_ASSIGN_BOUNDS")
    b = tk.kmeans(x, 8, torch.Generator().manual_seed(0), max_iters=3)
    assert torch.equal(a.assignment, b.assignment) and torch.equal(a.centers, b.centers)


def test_buckshot_fit_bounded_matches_jax(rng):
    x = _blobs(rng, 300, 6, 32)
    sidx = rng.choice(300, size=60, replace=False)
    got = tb.buckshot_fit(_t(x), interop.index(sidx, "cpu"), 8, bounded=True)
    plain = tb.buckshot_fit(_t(x), interop.index(sidx, "cpu"), 8)
    want = jb.buckshot_fit(jnp.asarray(x), jnp.asarray(sidx.astype(np.int32)), 8, bounded=True)
    assert torch.equal(got.kmeans.assignment, plain.kmeans.assignment)
    np.testing.assert_array_equal(_np(got.kmeans.assignment), np.asarray(want.kmeans.assignment))
    np.testing.assert_allclose(_np(got.kmeans.centers), np.asarray(want.kmeans.centers), atol=1e-6)


@pytest.mark.parametrize("indexed", [False, True])
def test_assign_batch_matches_jax(rng, indexed):
    x = _blobs(rng, 64, 5, 32)
    c = x[rng.choice(64, 20, replace=False)]
    w = np.ones(64, np.float32)
    w[50:] = 0.0  # padding rows of a short batch
    index = ops.build_center_index(_t(c)) if indexed else None
    jindex = jops.build_center_index(jnp.asarray(c)) if indexed else None
    got = tk.assign_batch(_t(x), _t(c), _t(w), index=index)
    want = jk.assign_batch(jnp.asarray(x), jnp.asarray(c), jnp.asarray(w), index=jindex)
    np.testing.assert_array_equal(_np(got[0]), np.asarray(want[0]))
    np.testing.assert_allclose(_np(got[1]), np.asarray(want[1]), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(_np(got[0]), _np(ops.assign_argmax(_t(x), _t(c))[0]))
