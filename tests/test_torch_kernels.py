"""The port's kernel layer against the JAX package's, on the CPU.

The same numpy inputs go through ``repro.kernels`` (its plain versions, and
at one shape each its Pallas kernels in interpret mode) and through
``repro_torch.kernels`` (the plain versions a CPU tensor takes). Integer
outputs must be equal; float outputs exact on integer-valued inputs (every
product and sum is exact in f32) and within rtol 1e-5 otherwise (the two
libraries add in different orders).
"""

from __future__ import annotations

import subprocess
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.assign_stats import label_stats_pallas
from repro.kernels.best_edge import best_edge_pallas
from repro.kernels.flash_decode import flash_decode_pallas
from repro_torch import interop
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.assign_argmax import assign_argmax_cuda
from repro_torch.kernels.assign_stats import (
    assign_stats_bounded_cuda,
    assign_stats_cuda,
    label_stats_cuda,
)
from repro_torch.kernels.best_edge import best_edge_cuda
from repro_torch.kernels.component_reduce import component_best_edge_cuda
from repro_torch.kernels.flash_decode import flash_decode_cuda
from repro_torch.kernels.sim_best_edge import sim_best_edge_cuda

RTOL = 1e-5


@pytest.fixture
def rng(request):
    """This module's generator, seeded from the test's own name (and its
    parameters): its draws do not depend on which tests a worker ran before
    (conftest's session-wide generator's do)."""
    name = f"{request.module.__name__}::{request.node.name}"
    return np.random.default_rng(zlib.crc32(name.encode()))


def _ints(rng, shape, lo=-8, hi=8):
    return rng.integers(lo, hi + 1, size=shape).astype(np.float32)


def _floats(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _t(a):
    """numpy -> port tensor: f32 data, int32 labels."""
    a = np.asarray(a)
    return interop.labels(a, "cpu") if a.dtype.kind in "iu" else interop.data(a, "cpu")


def _same(got, want, *, exact):
    for g, w in zip(got, want):
        g, w = interop.to_numpy(g), np.asarray(w)
        assert g.shape == w.shape
        if exact or w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=RTOL)


# ------------------------------------------------------------------ assign


@pytest.mark.parametrize("n,k,d", [(7, 3, 5), (300, 17, 70), (513, 129, 130)])
def test_assign_argmax_matches_jax(rng, n, k, d):
    x, c = _floats(rng, (n, d)), _floats(rng, (k, d))
    _same(ref.assign_argmax(_t(x), _t(c)), jref.assign_argmax(x, c), exact=False)


def test_assign_argmax_tie_breaks_lowest_index(rng):
    c = _ints(rng, (20, 16))
    c[13] = c[2]
    x = np.repeat(c[2:3], 5, axis=0)
    idx, _ = ref.assign_argmax(_t(x), _t(c))
    assert (interop.to_numpy(idx) == 2).all()


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("plain", ["assign_stats", "assign_stats_scatter"])
@pytest.mark.parametrize("n,k,d", [(7, 3, 5), (300, 17, 70), (0, 4, 6)])
def test_assign_stats_integer_data_exact(rng, plain, weighted, n, k, d):
    x, c = _ints(rng, (n, d), -4, 4), _ints(rng, (k, d), -4, 4)
    c[k - 1] = c[0]  # loses every tie to center 0: an empty cluster
    w = _ints(rng, (n,), 0, 2) if weighted else None  # weight-0 rows
    want = getattr(jref, plain)(x, c, None if w is None else jnp.asarray(w))
    got = getattr(ref, plain)(_t(x), _t(c), None if w is None else _t(w))
    _same(got, want, exact=True)
    assert interop.to_numpy(got[4])[k - 1] == ref.BIG


@pytest.mark.parametrize("plain", ["assign_stats", "assign_stats_scatter"])
def test_assign_stats_float_data(rng, plain):
    x, c = _floats(rng, (200, 40)), _floats(rng, (9, 40))
    w = rng.uniform(0.0, 2.0, size=200).astype(np.float32)
    w[::7] = 0.0
    want = getattr(jref, plain)(x, c, jnp.asarray(w))
    _same(getattr(ref, plain)(_t(x), _t(c), _t(w)), want, exact=False)


# ------------------------------------------------------------------ label stats


@pytest.mark.parametrize("plain", ["label_stats", "label_stats_scatter"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("n,k,d", [(40, 4, 3), (600, 70, 130), (0, 3, 2)])
def test_label_stats_integer_data_exact(rng, plain, weighted, n, k, d):
    x = _ints(rng, (n, d))
    idx = rng.integers(-2, k + 2, size=n).astype(np.int32)  # pads and oob
    w = _ints(rng, (n,), 0, 2) if weighted else None
    want = getattr(jref, plain)(x, idx, k, None if w is None else jnp.asarray(w))
    got = getattr(ref, plain)(_t(x), _t(idx), k, None if w is None else _t(w))
    _same(got, want, exact=True)


@pytest.mark.parametrize("n,k,d", [(40, 4, 3), (600, 70, 130), (0, 3, 2)])
def test_cluster_stats_matches_jax_and_label_stats(rng, n, k, d):
    """The one-hot combiner, the JAX package's oracle for label_stats: equal
    to it on integer rows, and to the port's plain label_stats (unweighted)
    bit for bit; within RTOL on float rows."""
    x, idx = _ints(rng, (n, d)), rng.integers(0, k, size=n).astype(np.int32)
    got = ref.cluster_stats(_t(x), _t(idx), k)
    _same(got, jref.cluster_stats(jnp.asarray(x), jnp.asarray(idx), k), exact=True)
    _same(got, ref.label_stats(_t(x), _t(idx), k), exact=True)
    xf = _floats(rng, (n, d))
    _same(ref.cluster_stats(_t(xf), _t(idx), k),
          jref.cluster_stats(jnp.asarray(xf), jnp.asarray(idx), k), exact=False)


def test_label_stats_float_data(rng):
    x = _floats(rng, (300, 50))
    idx = rng.integers(-1, 6, size=300).astype(np.int32)
    w = rng.uniform(0.0, 1.0, size=300).astype(np.float32)
    want = jref.label_stats_scatter(x, idx, 6, jnp.asarray(w))
    _same(ref.label_stats_scatter(_t(x), _t(idx), 6, _t(w)), want, exact=False)


@pytest.mark.parametrize("case", ["k800", "d1", "sorted"])
@pytest.mark.parametrize("weighted", [False, True])
def test_label_stats_plain_versions_match_pallas_interpret(rng, case, weighted):
    """The plain versions the card's tests trust, at the shapes the fold's
    new cases use: every label in one block (k = 800), one column (the
    microclusters' squared norms) and sorted labels with long runs."""
    n, d, k = {"k800": (1200, 8, 800), "d1": (500, 1, 50), "sorted": (600, 130, 40)}[case]
    x = _ints(rng, (n, d))
    idx = rng.integers(-1, k + 1, size=n).astype(np.int32)
    if case == "sorted":
        idx = np.sort(rng.integers(0, k, size=n)).astype(np.int32)
    w = _ints(rng, (n,), 0, 2) if weighted else None
    jw = None if w is None else jnp.asarray(w)
    want = label_stats_pallas(jnp.asarray(x), jnp.asarray(idx), k, jw, interpret=True)
    for a, b in zip(want, jref.label_stats(x, idx, k, jw)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for plain in ("label_stats", "label_stats_scatter"):
        got = getattr(ref, plain)(_t(x), _t(idx), k, None if w is None else _t(w))
        _same(got, want, exact=True)


# ------------------------------------------------------------------ best edge


@pytest.mark.parametrize("r,c", [(5, 9), (130, 70), (64, 300), (3, 4097), (7, 1023), (2, 70_001)])
def test_best_edge_matches_jax(rng, r, c):
    sim = _ints(rng, (r, c), -3, 3)  # ties everywhere
    lr = rng.integers(-1, 4, size=r).astype(np.int32)  # -1 = pad
    lc = rng.integers(-1, 4, size=c).astype(np.int32)
    want = jref.best_edge(sim, lr, lc)
    _same(ref.best_edge(_t(sim), _t(lr), _t(lc)), want, exact=True)


@pytest.mark.parametrize("r,c", [(257, 513), (33, 7), (300, 260)])
def test_best_edge_plain_version_matches_pallas_interpret(rng, r, c):
    """The plain version the card's tests trust, against the Pallas kernel
    at shapes off its 256 x 256 tiles: ties everywhere (across column
    tiles too), pad rows and columns, a row all in the columns' component."""
    sim = _ints(rng, (r, c), -3, 3)
    sim[:, c // 2] = sim[:, c - 1] = 4  # the row max twice, in two column tiles at c > 256
    lr = rng.integers(-1, 4, size=r).astype(np.int32)
    lc = rng.integers(-1, 4, size=c).astype(np.int32)
    lc[c // 2] = 3
    lr[0] = 3  # column c // 2 is in row 0's component: c - 1 or another wins
    lc[c - 1] = 0
    want = best_edge_pallas(jnp.asarray(sim), jnp.asarray(lr), jnp.asarray(lc), interpret=True)
    for a, b in zip(want, jref.best_edge(sim, lr, lc)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    _same(ref.best_edge(_t(sim), _t(lr), _t(lc)), want, exact=True)


def test_best_edge_all_same_component(rng):
    sim = _floats(rng, (6, 6))
    same = np.zeros(6, np.int32)
    j, s = ref.best_edge(_t(sim), _t(same), _t(same))
    assert (interop.to_numpy(j) == -1).all() and (interop.to_numpy(s) == ref.NEG).all()


def test_best_edge_empty_inputs(rng):
    """r = 0 gives the empty result, as the JAX package's plain version does;
    c = 0 gives every row (-1, NEG), where that version raises."""
    lab = rng.integers(0, 3, size=5).astype(np.int32)
    want = jref.best_edge(np.zeros((0, 5), np.float32), np.zeros(0, np.int32), lab)
    got = ops.best_edge(_t(np.zeros((0, 5), np.float32)), _t(np.zeros(0, np.int32)), _t(lab))
    _same(got, want, exact=True)
    j, s = ops.best_edge(_t(np.zeros((5, 0), np.float32)), _t(lab), _t(np.zeros(0, np.int32)))
    assert (interop.to_numpy(j) == -1).all() and (interop.to_numpy(s) == ref.NEG).all()
    with pytest.raises(ValueError):
        jref.best_edge(np.zeros((5, 0), np.float32), lab, np.zeros(0, np.int32))


def test_best_edge_float_data_and_signed_zeros(rng):
    sim = _floats(rng, (40, 70))
    sim[3, 10], sim[3, 2] = 0.0, -0.0  # -0.0 and +0.0 tie: the lower column wins
    sim[3, :] = np.where(np.abs(sim[3]) > 0, -5.0, sim[3])
    sim[7, :] = -np.inf  # a row of -inf candidates: the first column wins
    lr = rng.integers(-1, 4, size=40).astype(np.int32)
    lr[3] = lr[7] = 9
    lc = rng.integers(-1, 4, size=70).astype(np.int32)
    lc[2] = lc[10] = 0
    lc[:] = np.where(np.arange(70) == 0, 1, lc)
    want = jref.best_edge(sim, lr, lc)
    got = ops.best_edge(_t(sim), _t(lr), _t(lc))
    _same(got, want, exact=True)
    assert interop.to_numpy(got[0])[3] == 2


@pytest.mark.parametrize("r,c,d", [(9, 11, 4), (200, 150, 70)])
def test_sim_best_edge_matches_jax(rng, r, c, d):
    xr, xc = _ints(rng, (r, d), -3, 3), _ints(rng, (c, d), -3, 3)
    lr = rng.integers(-1, 5, size=r).astype(np.int32)
    lc = rng.integers(-1, 5, size=c).astype(np.int32)
    want = jref.sim_best_edge(xr, xc, lr, lc)
    _same(ref.sim_best_edge(_t(xr), _t(xc), _t(lr), _t(lc)), want, exact=True)
    # the dispatcher's CPU path agrees with the JAX package's chunked path
    got = ops.sim_best_edge(_t(xr), _t(xc), _t(lr), _t(lc))
    _same(got, jops.sim_best_edge(xr, xc, lr, lc, impl="xla", block=7), exact=True)


def test_sim_best_edge_float_data(rng):
    xr, xc = _floats(rng, (80, 30)), _floats(rng, (90, 30))
    lr = rng.integers(0, 10, size=80).astype(np.int32)
    lc = rng.integers(0, 10, size=90).astype(np.int32)
    want = jref.sim_best_edge(xr, xc, lr, lc)
    _same(ref.sim_best_edge(_t(xr), _t(xc), _t(lr), _t(lc)), want, exact=False)


# ------------------------------------------------------------------ flash decode


def _decode_case(rng, h, hk, dh, s):
    return (_floats(rng, (h, dh)), _floats(rng, (s, hk, dh)), _floats(rng, (s, hk, dh)))


def _bf16(a):
    """A JAX bf16 array and the port's bf16 tensor of the same values."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j.astype(jnp.float32))).bfloat16()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("h,hk", [(8, 8), (24, 8), (8, 2)])  # g = 1, 3, 4
@pytest.mark.parametrize("length", [0, 1, 13, 40, 45])  # 0, 1, mid-tile, s, > s
def test_flash_decode_matches_jax(rng, h, hk, dtype, length):
    s, dh = 40, 16
    q, k, v = _decode_case(rng, h, hk, dh, s)
    if dtype == "f32":
        want = np.asarray(jref.flash_decode(q, k, v, length))
        got = ops.flash_decode(_t(q), _t(k), _t(v), length)
        np.testing.assert_allclose(interop.to_numpy(got), want, rtol=0, atol=2e-6)
        return
    (jq, tq), (jk_, tk_), (jv, tv) = _bf16(q), _bf16(k), _bf16(v)
    want = np.asarray(jref.flash_decode(jq, jk_, jv, length).astype(jnp.float32))
    got = ops.flash_decode(tq, tk_, tv, torch.tensor(length, dtype=torch.int32))
    assert got.dtype == torch.bfloat16
    # both compute in f32 and round once to bf16: at most one bf16 ulp apart
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got.float().numpy() - want) <= ulp).all()


def _decode_scale(q, k, v, length):
    """For each output, sum_i p_i |v_i| / sum_i p_i in float64: the size of
    the terms the output is summed from."""
    s, hk, dh = k.shape
    g = q.shape[0] // hk
    logits = np.einsum("hd,shd->hs", q, np.repeat(k, g, 1)) / np.sqrt(dh)
    if length <= 0:
        logits[:] = 0.0
    logits[:, s if length <= 0 else min(length, s):] = -np.inf
    p = np.exp(logits - logits.max(axis=1, keepdims=True))
    return np.einsum("hs,shd->hd", p / p.sum(axis=1, keepdims=True), np.abs(np.repeat(v, g, 1)))


@pytest.mark.parametrize("length", [0, 1, 64, 65, 300, 307])  # tile/range edges, s, > s
def test_flash_decode_llama_heads_bf16_match_jax(rng, length):
    """g = 3 and dh = 128 in bf16, llama3.2-3b's head layout (h = 24,
    hk = 8), against the JAX package's plain version: one bf16 ulp plus 16
    f32 ulps (2^-20) of the size of the output's terms. Where an output
    cancels far below its terms, two plain f32 versions that sum in other
    orders differ by more than a bf16 ulp (by a few f32 ulps of the terms'
    size); elsewhere the allowance is far below the ulp."""
    h, hk, dh, s = 24, 8, 128, 300
    q, k, v = _decode_case(rng, h, hk, dh, s)
    (jq, tq), (jk_, tk_), (jv, tv) = _bf16(q), _bf16(k), _bf16(v)
    want = np.asarray(jref.flash_decode(jq, jk_, jv, length).astype(jnp.float32))
    got = ops.flash_decode(tq, tk_, tv, length)
    assert got.dtype == torch.bfloat16
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    scale = _decode_scale(*(np.asarray(a.astype(jnp.float32), np.float64) for a in (jq, jk_, jv)),
                          length)
    assert (np.abs(got.float().numpy() - want) <= ulp + 2.0**-20 * scale).all()


@pytest.mark.parametrize("seed,length", [(1, 64), (1, 300), (5, 64)])
def test_flash_decode_bf16_cancelling_outputs_match_jax(seed, length):
    """Captured draws (llama's heads, s = 300) where one bf16 ulp alone does
    not hold: an output cancels far below its terms, and the two packages'
    plain versions differ there by 2, 5 and 11 bf16 ulps of the output (at
    -1.2e-5, -2.9e-6 and -7.7e-7), which is 2.6, 1.6 and 1.1 f32 ulps (2^-24)
    of the terms' size sum p|v| / sum p. The gate in force, one bf16 ulp
    plus 2^-20 of that size, holds."""
    h, hk, dh, s = 24, 8, 128, 300
    q, k, v = _decode_case(np.random.default_rng(seed), h, hk, dh, s)
    (jq, tq), (jk_, tk_), (jv, tv) = _bf16(q), _bf16(k), _bf16(v)
    want = np.asarray(jref.flash_decode(jq, jk_, jv, length).astype(jnp.float32))
    got = ops.flash_decode(tq, tk_, tv, length).float().numpy()
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    scale = _decode_scale(*(np.asarray(a.astype(jnp.float32), np.float64) for a in (jq, jk_, jv)),
                          length)
    assert (np.abs(got - want) <= ulp + 2.0**-20 * scale).all()


@pytest.mark.parametrize("h,hk,s,length", [(8, 8, 40, 1), (24, 8, 600, 300), (8, 2, 1024, 1024),
                                           (8, 2, 1030, 700), (12, 4, 40, 40)])
def test_flash_decode_matches_pallas_interpret(rng, h, hk, s, length):
    """The Pallas kernel (interpret mode) for 1 <= length <= s."""
    q, k, v = _decode_case(rng, h, hk, 16, s)
    want = np.asarray(flash_decode_pallas(q, k, v, length, interpret=True))
    got = ops.flash_decode(_t(q), _t(k), _t(v), length)
    np.testing.assert_allclose(interop.to_numpy(got), want, rtol=0, atol=2e-6)


def test_flash_decode_references_disagree_where_the_port_follows_ref(rng):
    """At length <= 0 the JAX package's plain version gives the mean of v
    (a uniform softmax over masked logits) and its Pallas kernel zeros; past
    s, on a cache whose s is off the kernel's 512-position tile, the kernel
    also attends the zero pad positions. The port follows the plain version:
    the mean of v at length <= 0, length > s read as s."""
    h, hk, dh, s = 8, 2, 16, 40
    q, k, v = _decode_case(rng, h, hk, dh, s)
    mean = np.repeat(v.mean(axis=0), h // hk, axis=0)
    for length in (0, -3):
        got = interop.to_numpy(ops.flash_decode(_t(q), _t(k), _t(v), length))
        np.testing.assert_allclose(got, mean, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got, np.asarray(jref.flash_decode(q, k, v, length)), atol=1e-6)
        assert not np.asarray(flash_decode_pallas(q, k, v, length, interpret=True)).any()
    s = 700  # two 512-position tiles, the second one padded
    q, k, v = _decode_case(rng, h, hk, dh, s)
    got = interop.to_numpy(ops.flash_decode(_t(q), _t(k), _t(v), s + 5))
    np.testing.assert_array_equal(got, interop.to_numpy(ops.flash_decode(_t(q), _t(k), _t(v), s)))
    np.testing.assert_allclose(got, np.asarray(jref.flash_decode(q, k, v, s + 5)), atol=2e-6)
    pallas = np.asarray(flash_decode_pallas(q, k, v, s + 5, interpret=True))
    assert np.abs(pallas - got).max() > 1e-4


# ------------------------------------------------------------------ vs Pallas


def test_ops_match_pallas_interpret(rng):
    """One shape per kernel: the port's CPU dispatch against the Pallas
    kernels run by the interpreter, on integer data (exact)."""
    r, c, d = 40, 35, 20
    xr, xc = _ints(rng, (r, d), -3, 3), _ints(rng, (c, d), -3, 3)
    xc[c - 1] = xc[0]
    lr = rng.integers(-1, 4, size=r).astype(np.int32)
    lc = rng.integers(-1, 4, size=c).astype(np.int32)
    want = jops.sim_best_edge(xr, xc, lr, lc, impl="pallas_interpret")
    _same(ops.sim_best_edge(_t(xr), _t(xc), _t(lr), _t(lc)), want, exact=True)

    n, k = 50, 6
    x = _ints(rng, (n, d), -4, 4)
    idx = rng.integers(-1, k + 1, size=n).astype(np.int32)
    w = _ints(rng, (n,), 0, 2)
    want = jops.label_stats(x, idx, k, jnp.asarray(w), impl="pallas_interpret")
    _same(ops.label_stats(_t(x), _t(idx), k, _t(w)), want, exact=True)

    cen = _ints(rng, (k, d), -4, 4)
    cen[k - 1] = cen[0]
    want = jops.assign_stats(x, cen, jnp.asarray(w), impl="pallas_interpret")
    _same(ops.assign_stats(_t(x), _t(cen), _t(w)), want, exact=True)


def test_merge_stats_folds_chunks_like_jax(rng):
    x, c = _ints(rng, (60, 8), -4, 4), _ints(rng, (5, 8), -4, 4)
    carry = ops.stats_identity(5, 8, "cpu")
    jcarry = jops.stats_identity(5, 8)
    for lo, hi in ((0, 25), (25, 60)):
        carry = ops.merge_stats(carry, ops.assign_stats(_t(x[lo:hi]), _t(c)))
        jcarry = jops.merge_stats(jcarry, jops.assign_stats(x[lo:hi], c, impl="xla"))
    _same(carry, jcarry, exact=True)
    _same(carry, ops.assign_stats(_t(x), _t(c))[2:], exact=True)


# ------------------------------------------------------------------ dispatch


def test_cpu_tensors_take_the_plain_versions(rng):
    x = _t(_ints(rng, (30, 6)))
    lab = _t(rng.integers(0, 3, size=30).astype(np.int32))
    ops.reset_launch_counts()
    ops.sim_best_edge(x, x, lab, lab)
    ops.label_stats(x, lab, 3)
    ops.assign_stats(x, x[:3])
    ops.assign_argmax(x, x[:3])
    ops.assign_stats_bounded(x, x[:3], ops.bounds_identity(30, "cpu"), torch.zeros(3))
    ops.build_center_index(x[:9])
    ops.component_best_edge(x[:, 0], lab, torch.arange(30, dtype=torch.int32), lab, 3)
    ops.best_edge(x @ x.T, lab, lab)
    ops.flash_decode(x[:4, :3], x.reshape(30, 2, 3), x.reshape(30, 2, 3), 7)
    assert set(ops.launch_counts()) == {
        "sim_best_edge", "label_stats", "assign_stats", "assign_argmax",
        "assign_stats_bounded", "component_best_edge", "best_edge", "flash_decode",
    }
    assert not any(ops.launch_counts().values())


def test_kernel_wrappers_refuse_cpu_tensors(rng):
    x = _t(_ints(rng, (30, 6)))
    lab = _t(rng.integers(0, 3, size=30).astype(np.int32))
    with pytest.raises(ValueError, match="CUDA"):
        sim_best_edge_cuda(x, x, lab, lab)
    with pytest.raises(ValueError, match="CUDA"):
        label_stats_cuda(x, lab, 3)
    with pytest.raises(ValueError, match="CUDA"):
        component_best_edge_cuda(x[:, 0].contiguous(), lab, lab, lab, 3)
    with pytest.raises(ValueError, match="CUDA"):
        assign_stats_cuda(x, x[:3])
    with pytest.raises(ValueError, match="CUDA"):
        assign_argmax_cuda(x, x[:3])
    b = ops.bounds_identity(30, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        assign_stats_bounded_cuda(x, x[:3], b.idx, b.lo, b.hi, torch.zeros(3))
    with pytest.raises(ValueError, match="CUDA"):
        best_edge_cuda(x @ x.T, lab, lab)
    kv = x.reshape(30, 2, 3)
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode_cuda(x[:4, :3].contiguous(), kv, kv, 7)


@pytest.mark.parametrize("name", _build.SOURCES)
def test_kernel_sources_state_what_they_replace(name):
    src = (_build.CSRC / f"{name}.cu").read_text()
    assert "Replaces the TPU kernel src/repro/kernels/" in src
    assert "What bounds it on an H100" in src
    assert "atomicAdd" not in src


def test_interop_round_trip(rng):
    x = _floats(rng, (4, 3))
    lab = rng.integers(-1, 5, size=4)
    assert interop.data(x, "cpu").dtype == torch.float32
    assert interop.labels(lab, "cpu").dtype == torch.int32
    assert interop.index(lab, "cpu").dtype == torch.int64
    np.testing.assert_array_equal(interop.to_numpy(interop.data(x, "cpu")), x)
    np.testing.assert_array_equal(interop.to_numpy(interop.labels(lab, "cpu")), lab)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import pkgutil, importlib, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "new = ['text.stream', 'resilience.policy', 'testing.faults', 'text.hashing',\n"
        "       'kernels.best_edge', 'kernels.flash_decode', 'configs.flops',\n"
        "       'configs.qwen2_1_5b', 'models.transformer', 'models.interop',\n"
        "       'serve.engine', 'launch.serve', 'train.step', 'train.loop',\n"
        "       'train.checkpoint', 'distrib.compression', 'launch.train',\n"
        "       'launch.mesh', 'launch.specs', 'launch.op_costs', 'launch.dryrun']\n"
        "assert all('repro_torch.' + m in sys.modules for m in new)\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(_build.CSRC.parents[2]), "PATH": "/usr/bin:/bin"},
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 30  # every module of the port was imported
