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

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import interop
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.assign_argmax import assign_argmax_cuda
from repro_torch.kernels.assign_stats import (
    assign_stats_bounded_cuda,
    assign_stats_cuda,
    label_stats_cuda,
)
from repro_torch.kernels.component_reduce import component_best_edge_cuda
from repro_torch.kernels.sim_best_edge import sim_best_edge_cuda

RTOL = 1e-5


def _ints(rng, shape, lo=-8, hi=8):
    return rng.integers(lo, hi + 1, size=shape).astype(np.float32)


def _floats(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _t(a):
    """numpy -> port tensor: f32 data, int32 labels."""
    a = np.asarray(a)
    return interop.labels(a) if a.dtype.kind in "iu" else interop.data(a)


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


def test_label_stats_float_data(rng):
    x = _floats(rng, (300, 50))
    idx = rng.integers(-1, 6, size=300).astype(np.int32)
    w = rng.uniform(0.0, 1.0, size=300).astype(np.float32)
    want = jref.label_stats_scatter(x, idx, 6, jnp.asarray(w))
    _same(ref.label_stats_scatter(_t(x), _t(idx), 6, _t(w)), want, exact=False)


# ------------------------------------------------------------------ best edge


@pytest.mark.parametrize("r,c", [(5, 9), (130, 70), (64, 300)])
def test_best_edge_matches_jax(rng, r, c):
    sim = _ints(rng, (r, c), -3, 3)  # ties everywhere
    lr = rng.integers(-1, 4, size=r).astype(np.int32)  # -1 = pad
    lc = rng.integers(-1, 4, size=c).astype(np.int32)
    want = jref.best_edge(sim, lr, lc)
    _same(ref.best_edge(_t(sim), _t(lr), _t(lc)), want, exact=True)


def test_best_edge_all_same_component(rng):
    sim = _floats(rng, (6, 6))
    same = np.zeros(6, np.int32)
    j, s = ref.best_edge(_t(sim), _t(same), _t(same))
    assert (interop.to_numpy(j) == -1).all() and (interop.to_numpy(s) == ref.NEG).all()


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
    assert set(ops.launch_counts()) == {
        "sim_best_edge", "label_stats", "assign_stats", "assign_argmax",
        "assign_stats_bounded", "component_best_edge",
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


@pytest.mark.parametrize("name", _build.SOURCES)
def test_kernel_sources_state_what_they_replace(name):
    src = (_build.CSRC / f"{name}.cu").read_text()
    assert "Replaces the TPU kernel src/repro/kernels/" in src
    assert "What bounds it on an H100" in src
    assert "atomicAdd" not in src


def test_interop_round_trip(rng):
    x = _floats(rng, (4, 3))
    lab = rng.integers(-1, 5, size=4)
    assert interop.data(x).dtype == torch.float32
    assert interop.labels(lab).dtype == torch.int32
    assert interop.index(lab).dtype == torch.int64
    np.testing.assert_array_equal(interop.to_numpy(interop.data(x)), x)
    np.testing.assert_array_equal(interop.to_numpy(interop.labels(lab)), lab)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import pkgutil, importlib, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(_build.CSRC.parents[2]), "PATH": "/usr/bin:/bin"},
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 15  # every module of the port was imported
