"""The fold's order of adds, as a plain model, against the JAX package on
the CPU.

``ref.fold_in_order`` adds each label's rows of a row chunk in row order,
then the chunk partials in chunk order, as the card's fold does
(``csrc/label_stats.cuh``); ``tests/test_torch_gpu.py`` holds the card's
fold to it bit for bit. Here the model is held to the JAX package's
oracles and its Pallas ``label_stats`` kernel in interpret mode: on
integer-valued rows every product and sum is exact in f32, whatever the
order, so there the model must equal them bit for bit; on float unit rows
(documents) within the parity contract's 1e-4 relative + 1e-5 absolute,
since the libraries add in other orders. Against the oracles "equal" is
equal as values, NaN never: a one-hot product gives -0 where a label's
only terms are 0 times a negative entry (one row), and the fold starts
from +0. bf16 rows are upcast exactly, so the model on bf16 rows equals
itself on the f32 upcast bit for bit.
"""

from __future__ import annotations

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.assign_stats import label_stats_pallas
from repro_torch.kernels import ref

SUM_RTOL, SUM_ATOL = 1e-4, 1e-5
CHUNKS = (1, 2, 3, 7)
SIZES = (0, 1, 127, 128, 129, 257)
K, D = 5, 40


@pytest.fixture
def rng(request):
    """Seeded from the test's own name and parameters."""
    name = f"{request.module.__name__}::{request.node.name}"
    return np.random.default_rng(zlib.crc32(name.encode()))


def _case(rng, n, weighted, kind="int", k=K, d=D):
    """Rows (integers in [-8, 8] or unit rows), labels with some outside
    [0, k), and weights in {0, 1, 2} (weight-0 rows) or None, as numpy."""
    if kind == "int":
        x = rng.integers(-8, 9, size=(n, d)).astype(np.float32)
    else:
        x = rng.normal(size=(n, d)).astype(np.float32)
        x /= np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-30)
    idx = rng.integers(-2, k + 2, size=n).astype(np.int32)
    w = rng.integers(0, 3, size=n).astype(np.float32) if weighted else None
    return x, idx, w


def _torch(x, idx, w):
    return (torch.from_numpy(x), torch.from_numpy(idx),
            None if w is None else torch.from_numpy(w))


def _jax(x, idx, w):
    return jnp.asarray(x), jnp.asarray(idx), None if w is None else jnp.asarray(w)


def _equal(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got, want)


def _bits(got, want):
    _equal(got, want)
    assert np.array_equal(got.numpy().view(np.int32), np.asarray(want).view(np.int32))


@pytest.mark.parametrize("weighted", [True, False], ids=["w", "w_none"])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("chunks", CHUNKS)
def test_fold_in_order_equals_the_oracle_on_integer_rows(rng, chunks, n, weighted):
    x, idx, w = _case(rng, n, weighted)
    xt, it, wt = _torch(x, idx, w)
    sums, counts, sumsq, min_sim = ref.fold_in_order(xt, it, K, chunks, wt)
    jx, jidx, jw = _jax(x, idx, w)
    want = jref.label_stats(jx, jidx, K, jw)
    _equal(sums, want[0])
    _equal(counts, want[1])
    assert sumsq is None and min_sim is None


@pytest.mark.parametrize("weighted", [True, False], ids=["w", "w_none"])
@pytest.mark.parametrize("n", SIZES)
def test_fold_in_order_equals_the_pallas_kernel_on_integer_rows(rng, n, weighted):
    """One interpret-mode run of the TPU kernel a size, against the model at
    every chunk count."""
    x, idx, w = _case(rng, n, weighted)
    jx, jidx, jw = _jax(x, idx, w)
    if n == 0:  # the Pallas grid has no row tile: the oracle stands in
        want = jref.label_stats(jx, jidx, K, jw)
    else:
        want = label_stats_pallas(jx, jidx, K, jw, interpret=True)
    for chunks in CHUNKS:
        xt, it, wt = _torch(x, idx, w)
        sums, counts, _, _ = ref.fold_in_order(xt, it, K, chunks, wt)
        _equal(sums, want[0])
        _equal(counts, want[1])


@pytest.mark.parametrize("weighted", [True, False], ids=["w", "w_none"])
@pytest.mark.parametrize("n", SIZES)
def test_fold_in_order_equals_assign_stats_fold_on_integer_rows(rng, n, weighted):
    """The fused pass's statistics: the model folds the oracle's own labels,
    best similarities and squared norms (exact sums of integer squares)."""
    x, _, w = _case(rng, n, weighted)
    centers = rng.integers(-8, 9, size=(K, D)).astype(np.float32)
    jw = None if w is None else jnp.asarray(w)
    idx, best, sums, counts, min_sim, sumsq = jref.assign_stats(
        jnp.asarray(x), jnp.asarray(centers), jw)
    rowsq = torch.from_numpy((x.astype(np.float64) ** 2).sum(1).astype(np.float32))
    for chunks in CHUNKS:
        got = ref.fold_in_order(
            torch.from_numpy(x), torch.from_numpy(np.asarray(idx)), K, chunks,
            None if w is None else torch.from_numpy(w), rowsq,
            torch.from_numpy(np.asarray(best)))
        for g, want in zip(got, (sums, counts, sumsq, min_sim)):
            _equal(g, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("chunks", CHUNKS)
def test_fold_in_order_on_unit_rows_within_the_parity_contract(rng, chunks, dtype):
    """Documents: float unit rows (f32, or rounded to bf16 once), the JAX
    oracle fed the same bits."""
    x, idx, w = _case(rng, 600, True, kind="unit", k=9, d=70)
    xt = torch.from_numpy(x).to(dtype)
    xj = jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                                 else jnp.float32)
    sums, counts, _, _ = ref.fold_in_order(xt, torch.from_numpy(idx), 9, chunks,
                                           torch.from_numpy(w))
    want = jref.label_stats(xj, jnp.asarray(idx), 9, jnp.asarray(w))
    for g, ww in zip((sums, counts), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(ww), rtol=SUM_RTOL, atol=SUM_ATOL)


@pytest.mark.parametrize("weighted", [True, False], ids=["w", "w_none"])
@pytest.mark.parametrize("chunks", CHUNKS)
def test_fold_in_order_on_bf16_rows_equals_itself_on_the_upcast(rng, chunks, weighted):
    x, idx, w = _case(rng, 300, weighted, kind="unit", k=7, d=33)
    xb = torch.from_numpy(x).bfloat16()
    w_t = None if w is None else torch.from_numpy(w)
    rowsq = torch.from_numpy(rng.random(300).astype(np.float32))
    sim = torch.from_numpy(rng.normal(size=300).astype(np.float32))
    got = ref.fold_in_order(xb, torch.from_numpy(idx), 7, chunks, w_t, rowsq, sim)
    want = ref.fold_in_order(xb.float(), torch.from_numpy(idx), 7, chunks, w_t, rowsq, sim)
    for g, ww in zip(got, want):
        _bits(g, ww.numpy())
