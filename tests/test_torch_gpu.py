"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA Hopper card (compute capability >= 9.0)
and nvcc; elsewhere it skips. Run them on a card with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.

Inputs are integer-valued f32, so every product and sum is exact in f32 and
the kernels must agree with the plain versions bit for bit whatever order
they add in; ties are everywhere, which pins the lowest-index rules. The
shapes are not multiples of the kernels' tiles (128 rows/columns, 64
centers/labels, 16 columns of d).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.kernels import ops, ref
from repro_torch.kernels.assign_stats import assign_stats_cuda, label_stats_cuda
from repro_torch.kernels.sim_best_edge import sim_best_edge_cuda

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs a Hopper card (sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ints(rng, shape, lo, hi, device):
    return interop.data(rng.integers(lo, hi + 1, size=shape), device)


def _equal(got, want):
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _twice(fn, *args):
    """Run a kernel twice; the two results must be bit-identical."""
    a, b = fn(*args), fn(*args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    return a


@pytest.mark.parametrize("r,c,d", [(300, 270, 70), (1, 129, 16), (130, 1, 3)])
def test_sim_best_edge_matches_plain(card, r, c, d):
    rng = np.random.default_rng(r + c + d)
    xr = _ints(rng, (r, d), -3, 3, card)
    xc = _ints(rng, (c, d), -3, 3, card)
    lr = interop.labels(rng.integers(-1, 5, size=r), card)  # -1 = pad
    lc = interop.labels(rng.integers(-1, 5, size=c), card)
    got = _twice(sim_best_edge_cuda, xr, xc, lr, lc)
    _equal(got, ref.sim_best_edge(xr, xc, lr, lc))


def test_sim_best_edge_tie_across_column_tiles(card):
    rng = np.random.default_rng(1)
    xc = _ints(rng, (300, 40), -8, 8, card)
    xc[200] = xc[5]  # the same best column in tile 0 and tile 1
    xr = xc[5:6].repeat(4, 1)
    lr = torch.full((4,), 7, dtype=torch.int32, device=card)
    lc = torch.zeros((300,), dtype=torch.int32, device=card)
    bj, bs = sim_best_edge_cuda(xr, xc, lr, lc)
    assert (bj == 5).all()
    _equal((bj, bs), ref.sim_best_edge(xr, xc, lr, lc))


def test_sim_best_edge_no_candidate(card):
    x = _ints(np.random.default_rng(2), (150, 20), -2, 2, card)
    same = torch.zeros((150,), dtype=torch.int32, device=card)
    bj, bs = sim_best_edge_cuda(x, x, same, same)
    assert (bj == -1).all() and (bs == ref.NEG).all()


def test_sim_best_edge_symmetric_bits(card):
    """sim(i, j) and sim(j, i) come out bit-identical, which Borůvka's
    mutual-edge dedupe relies on."""
    x = torch.nn.functional.normalize(
        torch.randn(500, 300, generator=torch.Generator().manual_seed(3)), dim=1
    ).to(card)
    ids = torch.arange(500, dtype=torch.int32, device=card)
    bj, bs = sim_best_edge_cuda(x, x, ids, ids)
    zero = torch.zeros((1,), dtype=torch.int32, device=card)
    for i in range(0, 500, 37):  # score (best partner, i) the other way round
        j = int(bj[i])
        _, back = sim_best_edge_cuda(x[j:j + 1], x[i:i + 1], zero, zero + 1)
        assert torch.equal(back[0], bs[i])


@pytest.mark.parametrize("n,d,k", [(1000, 200, 70), (37, 5, 3), (0, 8, 4)])
def test_label_stats_matches_plain(card, n, d, k):
    rng = np.random.default_rng(n + d + k)
    x = _ints(rng, (n, d), -8, 8, card)
    idx = interop.labels(rng.integers(-2, k + 2, size=n), card)  # some oob
    w = _ints(rng, (n,), 0, 2, card)  # weight-0 rows
    got = _twice(label_stats_cuda, x, idx, k, w)
    _equal(got, ref.label_stats(x, idx, k, w))
    _equal(label_stats_cuda(x, idx, k), ref.label_stats(x, idx, k))


@pytest.mark.parametrize("n,d,k", [(1000, 130, 70), (300, 16, 5), (0, 4, 2)])
def test_assign_stats_matches_plain(card, n, d, k):
    rng = np.random.default_rng(n + d + k)
    x = _ints(rng, (n, d), -4, 4, card)
    centers = _ints(rng, (k, d), -4, 4, card)
    centers[k - 1] = centers[0]  # loses every tie to center 0: empty
    if k > 64:
        centers[64 + 1] = centers[1]  # the same center in two center tiles
    w = _ints(rng, (n,), 0, 2, card)
    got = _twice(assign_stats_cuda, x, centers, w)
    _equal(got, ref.assign_stats(x, centers, w))
    _equal(assign_stats_cuda(x, centers), ref.assign_stats(x, centers))
    if n:
        assert got[3][k - 1] == 0 and got[4][k - 1] == ref.BIG


def test_ops_dispatch_counts_launches(card):
    rng = np.random.default_rng(5)
    x = _ints(rng, (64, 32), -2, 2, card)
    lab = interop.labels(rng.integers(0, 4, size=64), card)
    ops.reset_launch_counts()
    ops.sim_best_edge(x, x, lab, lab)
    ops.label_stats(x, lab, 4)
    ops.assign_stats(x, x[:4].contiguous())
    assert ops.launch_counts() == {"sim_best_edge": 1, "label_stats": 1, "assign_stats": 1}
    with pytest.raises(TypeError):
        ops.assign_stats(x.double(), x[:4].double())
    with pytest.raises(NotImplementedError, match="queue 2"):
        ops.assign_argmax(x, x[:4])


def test_buckshot_card_matches_cpu(card):
    from repro_torch.core.buckshot import buckshot_fit
    from repro_torch.text import pipeline, synth

    corpus = synth.make_corpus(1200, vocab=256, n_topics=6, seed=11)
    x, _ = pipeline.prepare_local(corpus, device="cpu")
    sidx = interop.index(np.random.default_rng(0).choice(1200, 85, replace=False))
    want = buckshot_fit(x, sidx, 6)
    got = buckshot_fit(x.to(card), sidx.to(card), 6)
    agree = (got.kmeans.assignment.cpu() == want.kmeans.assignment).float().mean()
    assert agree >= 0.999
    torch.testing.assert_close(got.kmeans.rss.cpu(), want.kmeans.rss, rtol=1e-4, atol=0)
