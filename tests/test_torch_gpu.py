"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA Hopper card (compute capability >= 9.0)
and nvcc; elsewhere it skips. Run them on a card with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.

Inputs are integer-valued f32, so every product and sum is exact in f32 and
the kernels must agree with the plain versions bit for bit whatever order
they add in; ties are everywhere, which pins the lowest-index rules. The
shapes are not multiples of the kernels' tiles (128 rows/columns, 64
centers/labels, 16 or 32 columns of d).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.kernels import ops, ref
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


@pytest.mark.parametrize("s", [129, 300, 1000, 5000])  # 5,000: 40 tiles, 820 blocks
def test_sim_best_edge_self_search_equals_distinct_storage(card, s):
    """The resident round's call (one tensor for both row matrices, one for
    both label vectors) computes only the tiles on and above the diagonal;
    it must give the bits of the full grid, which a copy of the same rows
    takes."""
    rng = np.random.default_rng(s)
    x = torch.nn.functional.normalize(
        interop.data(rng.normal(size=(s, 70)), card), dim=1
    ).contiguous()
    lab = interop.labels(rng.integers(-1, s // 9 + 2, size=s), card)  # -1 = pad
    for labels in (lab, torch.arange(s, dtype=torch.int32, device=card)):
        got = _twice(sim_best_edge_cuda, x, x, labels, labels)
        full = sim_best_edge_cuda(x.clone(), x.clone(), labels.clone(), labels.clone())
        assert torch.equal(got[0], full[0])
        assert torch.equal(got[1].view(torch.int32), full[1].view(torch.int32))
    xi = _ints(rng, (s, 33), -3, 3, card)  # integer rows: equal to the plain version too
    got = sim_best_edge_cuda(xi, xi, lab, lab)
    _equal(got, ref.sim_best_edge(xi, xi, lab, lab))
    _equal(got, sim_best_edge_cuda(xi, xi.clone(), lab, lab.clone()))


@pytest.mark.parametrize("n,d,k", [(1000, 200, 70), (37, 5, 3), (0, 8, 4),
                                   (5000, 128, 800),  # every label in one block: x read once
                                   (2000, 130, 1600),  # past one block's shared memory
                                   (3000, 1, 50), (500, 130, 7),  # rows off 16 bytes
                                   # a ring of three stages, wrapped dozens of times a block
                                   (60_000, 256, 1000), (60_000, 256, 2000), (60_000, 130, 1000)])
def test_label_stats_matches_plain(card, n, d, k):
    rng = np.random.default_rng(n + d + k)
    x = _ints(rng, (n, d), -8, 8, card)
    idx = interop.labels(rng.integers(-2, k + 2, size=n), card)  # some oob
    w = _ints(rng, (n,), 0, 2, card)  # weight-0 rows
    got = _twice(label_stats_cuda, x, idx, k, w)
    _equal(got, ref.label_stats(x, idx, k, w))
    _equal(label_stats_cuda(x, idx, k), ref.label_stats(x, idx, k))



def test_label_stats_sorted_runs(card):
    """Long runs of one label are added in one warp's register."""
    rng = np.random.default_rng(11)
    x = _ints(rng, (6000, 256), -8, 8, card)
    idx = interop.labels(np.sort(rng.integers(0, 40, size=6000)), card)
    w = _ints(rng, (6000,), 0, 2, card)
    _equal(_twice(label_stats_cuda, x, idx, 40, w), ref.label_stats(x, idx, 40, w))
    _equal(_twice(label_stats_cuda, x, idx, 40), ref.label_stats(x, idx, 40))


@pytest.mark.parametrize("n,d,k", [(3000, 96, 50), (2000, 1, 800)])
def test_label_stats_null_weights_equal_ones(card, n, d, k):
    """w = None reads as weight 1 in the kernel: the same bits as explicit ones."""
    rng = np.random.default_rng(n + k)
    x = interop.data(rng.normal(size=(n, d)), card)
    idx = interop.labels(rng.integers(-1, k, size=n), card)
    ones = torch.ones((n,), device=card)
    _equal(label_stats_cuda(x, idx, k), label_stats_cuda(x, idx, k, ones))


@pytest.mark.parametrize("n,d,k", [(1000, 130, 70), (300, 16, 5), (0, 4, 2), (3000, 96, 800)])
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
    ops.assign_argmax(x, x[:4])
    ops.assign_stats_bounded(x, x[:4], ops.bounds_identity(64), torch.zeros(4, device=card))
    rows = torch.arange(64, dtype=torch.int32, device=card)
    ops.component_best_edge(x[:, 0], lab, rows, lab, 4)
    ops.best_edge(x @ x.T, lab, lab)
    kv = x.reshape(64, 4, 8)
    ops.flash_decode(x[:8, :8].contiguous(), kv, kv, torch.tensor(9, dtype=torch.int32, device=card))
    assert ops.launch_counts() == {
        "sim_best_edge": 1, "label_stats": 1, "assign_stats": 1,
        "assign_argmax": 1, "assign_stats_bounded": 1, "component_best_edge": 1,
        "best_edge": 1, "flash_decode": 1,
    }
    with pytest.raises(TypeError):
        ops.assign_stats(x.double(), x[:4].double())
    with pytest.raises(TypeError):
        ops.assign_argmax(x.double(), x[:4].double())


@pytest.mark.parametrize("n,d,k", [(1000, 130, 70), (300, 16, 5), (0, 4, 2)])
def test_assign_argmax_matches_plain(card, n, d, k):
    rng = np.random.default_rng(n + d + k + 1)
    x = _ints(rng, (n, d), -4, 4, card)
    centers = _ints(rng, (k, d), -4, 4, card)
    if k > 64:
        centers[65] = centers[1]  # the same center in two center tiles
    got = _twice(assign_argmax_cuda, x, centers)
    _equal(got, ref.assign_argmax(x, centers))


def test_assign_argmax_has_assign_stats_bits(card):
    """Both kernels compute each similarity by the same fmaf chain."""
    g = torch.Generator().manual_seed(4)
    x = torch.nn.functional.normalize(torch.rand(700, 300, generator=g), dim=1).to(card)
    centers = x[torch.randperm(700, generator=g)[:90].to(card)].contiguous()
    _equal(assign_argmax_cuda(x, centers), assign_stats_cuda(x, centers)[:2])


def _clustered_ints(rng, n, k, d, card):
    """Integer rows near integer centers: every sum is exact in f32, and the
    gaps between similarities are wide enough for carried bounds to prune."""
    centers = rng.integers(-4, 5, size=(k, d))
    lab = rng.integers(0, k, size=n)
    x = centers[lab] + rng.integers(-1, 2, size=(n, d))
    return interop.data(x, card), interop.data(centers, card)


def _check_bounded(got, want, k):
    """Every output but hi equal; hi an upper bound on the exact second value
    (a skipped slab gives its cone bound), equal where the row was pruned or
    the centers fit one slab."""
    _equal(got[:8], want[:8])
    _equal(got[9:], want[9:])
    hi, exact = got[8], want[8]
    assert (hi >= exact - 1e-5 * (1 + exact.abs())).all()
    pruned = got[9]
    assert torch.equal(hi[pruned], exact[pruned])
    if k <= 64:
        assert torch.equal(hi, exact)


@pytest.mark.parametrize(
    "n,d,k",
    [(1000, 130, 70), (300, 16, 5), (257, 40, 130), (0, 8, 3),
     (300, 24, 4200),  # more than one tile of slab directions (64 slabs)
     (1500, 48, 800)],  # BigK: the fold's accumulators of all labels in one block
)
@pytest.mark.parametrize("order", ["identity", "reversed", "index"])
def test_assign_stats_bounded_matches_plain(card, n, d, k, order):
    rng = np.random.default_rng(n + d + k)
    x, centers = _clustered_ints(rng, n, k, d, card)
    centers[k - 1] = centers[0]  # loses every tie to center 0: an empty cluster
    if k > 9:
        centers[9] = centers[3]  # a duplicate whose higher id comes first when reversed
    if k > 64:
        centers[65] = centers[1]
    w = _ints(rng, (n,), 0, 2, card)  # weight-0 rows
    perm = {
        "identity": None,
        "reversed": torch.arange(k - 1, -1, -1, dtype=torch.int32, device=card),
        "index": ops.build_center_index(centers).perm,
    }[order]
    zero = torch.zeros((k,), device=card)
    b0 = ops.bounds_identity(n, card)
    args = (x, centers, b0.idx, b0.lo, b0.hi, zero, w)
    got = _twice(lambda: assign_stats_bounded_cuda(*args, perm=perm))
    want = ref.assign_stats_bounded(*args)
    _check_bounded(got, want, k)
    assert not want[9].any()  # the sentinel prunes nothing

    # carried bounds after a move of two centers by one unit each
    moved = centers.clone()
    moved[0, 0] += 1
    moved[k // 2, d - 1] -= 1
    drift = torch.linalg.vector_norm(moved - centers, dim=1)
    carried = (want[6], want[7], want[8])
    stale = torch.zeros((n,), dtype=torch.bool, device=card)
    stale[::5] = True  # invalidated rows take the full sweep
    b1 = ops.bounds_invalidate(ops.Bounds(*carried), stale)
    args = (x, moved, b1.idx, b1.lo, b1.hi, drift, w)
    got = _twice(lambda: assign_stats_bounded_cuda(*args, perm=perm))
    want = ref.assign_stats_bounded(*args)
    _check_bounded(got, want, k)
    if n:
        assert want[9].any() and not want[9][stale].any()
    # labels and statistics are the unpruned pass's
    _equal(got[:6], assign_stats_cuda(x, moved, w))


def test_assign_stats_bounded_all_rows_pruned(card):
    """A block whose rows are all settled sweeps nothing and still writes
    every row."""
    rng = np.random.default_rng(8)
    centers = 4 * np.eye(20, 24)  # own similarity >= 12, any other <= 4
    x = centers[rng.integers(0, 20, size=300)] + rng.integers(-1, 2, size=(300, 24))
    x, centers = interop.data(x, card), interop.data(centers, card)
    zero = torch.zeros((20,), device=card)
    first = ref.assign_stats_bounded(x, centers, *ops.bounds_identity(300, card), zero)
    args = (x, centers, first[6], first[7], first[8], zero)
    want = ref.assign_stats_bounded(*args)
    assert want[9].all()
    got = _twice(lambda: assign_stats_bounded_cuda(*args))
    _check_bounded(got, want, 20)


PIPE_K = (1, 63, 64, 65, 127, 128, 129, 400, 800)


def _pipe_case(n, k, d, card):
    """Integer rows near integer centers, equal centers on both sides of
    every 64-center slab and 128-center tile boundary, the last center equal
    to the first (an empty cluster), weights 0-2."""
    rng = np.random.default_rng(1000 * n + 10 * k + d)
    c = rng.integers(-4, 5, size=(k, d))
    for b in range(64, k, 64):
        c[b] = c[b - 1]
    if k > 1:
        c[k - 1] = c[0]
    x = c[rng.integers(0, k, size=n)] + rng.integers(-1, 2, size=(n, d))
    return interop.data(x, card), interop.data(c, card), _ints(rng, (n,), 0, 2, card)


@pytest.mark.parametrize("n", [1, 127, 129, 1000])
@pytest.mark.parametrize("d", [1, 3, 33, 130, 2048])
def test_pipe_tile_edges_match_plain(card, n, d):
    """The pipelined tile at the edges of its row block (128), slab (64),
    center tile (128), stage (32 columns of d) and copy width: d = 1, 3, 33
    and 130 go by 4-byte copies, 2,048 by the copy engine through a ring
    wrapped many times. assign_argmax, assign_stats and the bounded pass
    (sentinel bounds) equal their plain versions, assign_argmax equals
    assign_stats and bounded equals unbounded, for every k of PIPE_K."""
    for k in PIPE_K:
        x, c, w = _pipe_case(n, k, d, card)
        a = _twice(assign_argmax_cuda, x, c)
        _equal(a, ref.assign_argmax(x, c))
        s = _twice(assign_stats_cuda, x, c, w)
        _equal(s, ref.assign_stats(x, c, w))
        _equal(a, assign_stats_cuda(x, c)[:2])
        b0 = ops.bounds_identity(n, card)
        args = (x, c, b0.idx, b0.lo, b0.hi, torch.zeros((k,), device=card), w)
        got = _twice(lambda: assign_stats_bounded_cuda(*args))
        _check_bounded(got, ref.assign_stats_bounded(*args), k)
        _equal(got[:6], s)


@pytest.mark.parametrize("d", [33, 130, 2048])
@pytest.mark.parametrize("k", [65, 129, 800])
def test_bounded_row_pass_ring_wraps(card, d, k):
    """Carried bounds after a move: settled rows take their similarity from
    the row pass (their carried centers gathered by 16-byte copies at
    d = 2,048, 4-byte ones otherwise), the rest sweep; the ring runs on
    across the row pass, the slab directions and the slabs. Equal to the
    plain version and, labels and statistics, to the unbounded pass."""
    x, c, w = _pipe_case(1000, k, d, card)
    b0 = ops.bounds_identity(1000, card)
    first = ref.assign_stats_bounded(x, c, b0.idx, b0.lo, b0.hi, torch.zeros((k,), device=card), w)
    moved = c.clone()
    moved[0, 0] += 1
    moved[k // 2, d - 1] -= 1
    drift = torch.linalg.vector_norm(moved - c, dim=1)
    args = (x, moved, first[6], first[7], first[8], drift, w)
    got = _twice(lambda: assign_stats_bounded_cuda(*args))
    want = ref.assign_stats_bounded(*args)
    assert want[9].any() and not want[9].all()
    _check_bounded(got, want, k)
    _equal(got[:6], assign_stats_cuda(x, moved, w))


def test_buckshot_card_matches_cpu(card):
    from repro_torch.core.buckshot import buckshot_fit
    from repro_torch.text import pipeline, synth

    corpus = synth.make_corpus(1200, vocab=256, n_topics=6, seed=11)
    x, _ = pipeline.prepare_local(corpus, device="cpu")
    sidx = interop.index(np.random.default_rng(0).choice(1200, 85, replace=False), "cpu")
    want = buckshot_fit(x, sidx, 6)
    got = buckshot_fit(x.to(card), sidx.to(card), 6)
    agree = (got.kmeans.assignment.cpu() == want.kmeans.assignment).float().mean()
    assert agree >= 0.999
    torch.testing.assert_close(got.kmeans.rss.cpu(), want.kmeans.rss, rtol=1e-4, atol=0)


def _blobs_on(card, n, k, d, seed):
    g = torch.Generator().manual_seed(seed)
    c = 3.0 * torch.randn(k, d, generator=g)
    x = c[torch.randint(0, k, (n,), generator=g)] + 0.3 * torch.randn(n, d, generator=g)
    return torch.nn.functional.normalize(x, dim=1).to(card)


def test_kmeans_routes_agree_on_card(card):
    """Bounded, fused and two-pass K-Means compute every similarity by the
    same fmaf chain and fold the statistics in the same order: bit-identical
    centers and labels."""
    from repro_torch.core.kmeans import kmeans_fit

    x = _blobs_on(card, 3000, 40, 96, 6)
    init = x[:40].contiguous()
    ops.reset_launch_counts()
    bounded = kmeans_fit(x, init, 40, tol=0.0, bounded=True)
    assert ops.launch_counts()["assign_stats_bounded"] == bounded.iterations + 1
    fused = kmeans_fit(x, init, 40, tol=0.0)
    two_pass = kmeans_fit(x, init, 40, tol=0.0, fused=False)
    for other in (fused, two_pass):
        assert torch.equal(bounded.assignment, other.assignment)
        assert torch.equal(bounded.centers, other.centers)
        assert bounded.iterations == other.iterations


def _loose_blobs(n, d, topics, seed):
    """Unit rows around ``topics`` directions, 5 % of them loose: micro-
    clusters that take a loose row get a low min_i, so pair values
    cos - min_i - min_j above 0 exist and the bisection runs over them."""
    r = np.random.default_rng(seed)
    c = r.standard_normal((topics, d))
    lab = r.integers(0, topics, n)
    sig = np.where(r.random(n) < 0.05, 3.0, 0.15)
    x = c[lab] + sig[:, None] * r.standard_normal((n, d))
    return interop.data(x / np.linalg.norm(x, axis=1, keepdims=True), "cpu")


@pytest.mark.parametrize("data,big_k,k", [("tfidf", 60, 6), ("loose", 80, 2), ("loose", 80, 50)],
                         ids=["tfidf", "loose-escape", "loose"])
def test_bkc_routes_agree_on_card_and_match_cpu(card, data, big_k, k):
    """The three routes agree on the card, and the card agrees with the CPU.
    On the tf-idf rows every pair value is 0 (the bisection ends at its
    lowest step); on the loose blobs the threshold lies between real pair
    values, through the escape edges at k = 2 and without them at k = 50."""
    from repro_torch.core.bkc import bkc_fit
    from repro_torch.core.microcluster import build_microclusters, pair_similarity
    from repro_torch.text import pipeline, synth

    if data == "tfidf":
        corpus = synth.make_corpus(1500, vocab=256, n_topics=6, seed=12)
        x, _ = pipeline.prepare_local(corpus, device="cpu")
    else:
        x = _loose_blobs(1500, 96, 8, 5)
    init = x[interop.index(np.random.default_rng(3).choice(1500, big_k, replace=False), "cpu")]
    want = bkc_fit(x, init, big_k, k)
    xc, ic = x.to(card), init.to(card)
    ops.reset_launch_counts()
    got = {name: bkc_fit(xc, ic, big_k, k, **kw) for name, kw in (
        ("fused", {}), ("two_pass", {"fused": False}), ("bounded", {"bounded": True}))}
    counts = ops.launch_counts()
    assert counts["assign_argmax"] >= 2 and counts["assign_stats_bounded"] == 2
    for res in got.values():
        assert torch.equal(res.group_of_mc, got["fused"].group_of_mc)
        assert torch.equal(res.assignment, got["fused"].assignment)
        assert torch.equal(res.threshold, got["fused"].threshold)
    res = got["bounded"]
    agree = (res.assignment.cpu() == want.assignment).float().mean()
    assert agree >= 0.999
    torch.testing.assert_close(res.rss.cpu(), want.rss, rtol=1e-4, atol=0)
    assert torch.equal(res.group_of_mc.cpu(), want.group_of_mc)
    torch.testing.assert_close(res.threshold.cpu(), want.threshold, rtol=0, atol=1e-5)
    if data == "loose":
        pair = pair_similarity(build_microclusters(xc, ic, big_k)[0])[0]
        thr = res.threshold
        assert thr > 0.1 and (pair >= thr).any() and ((pair > 0) & (pair < thr)).any()


def test_assign_batch_matches_the_full_pass_on_card(card):
    from repro_torch.core.kmeans import assign_batch

    x = _blobs_on(card, 1000, 30, 64, 7)
    centers = x[:200].contiguous()
    index = ops.build_center_index(centers)
    full = assign_stats_cuda(x, centers)
    for lo in range(0, 1000, 64):
        idx, sim = assign_batch(x[lo:lo + 64], centers, index=index)
        assert torch.equal(idx, full[0][lo:lo + 64])
        assert torch.equal(sim, full[1][lo:lo + 64])


# ------------------------------------------------------ component pre-reduce


def _cbe_case(rng, r, c, card):
    w = rng.normal(size=r).astype(np.float32)
    w[::5] = ref.NEG  # real rows at f32.min: they beat the empty sentinel
    if r > 10:
        w[3] = w[8]  # duplicate weight: the row id breaks the tie
        w[1], w[2] = -0.0, 0.0  # -0.0 ties with +0.0
    col = rng.integers(-1, 64, size=r)
    rows = rng.permutation(2 * r)[:r]
    comp = rng.integers(-1, c + 1, size=r)  # -1 and c: dropped
    return (interop.data(w, card), interop.labels(col, card), interop.labels(rows, card),
            interop.labels(comp, card))


def _bits_equal(got, want):
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    _equal(got[1:], want[1:])


@pytest.mark.parametrize("r,c", [(7, 3), (64, 64), (130, 9), (513, 40), (300, 700), (0, 5),
                                 (3536, 1768)])
def test_component_best_edge_matches_plain(card, r, c):
    """Bit for bit against both plain versions, -0.0 included."""
    args = _cbe_case(np.random.default_rng(r + c), r, c, card)
    got = _twice(component_best_edge_cuda, *args, c)
    _bits_equal(got, ref.component_best_edge(*args, c))
    _bits_equal(got, ref.component_best_edge_segment(*args, c))


def test_component_best_edge_row_ties(card):
    """Equal weights, lower row ids on either side of the winner."""
    r = 40
    w = torch.full((r,), 0.5, device=card)
    col = torch.arange(100, 100 + r, dtype=torch.int32, device=card)
    rows = torch.arange(r - 1, -1, -1, dtype=torch.int32, device=card)
    comp = (torch.arange(r, device=card) % 3).int()
    got = component_best_edge_cuda(w, col, rows, comp, 3)
    _bits_equal(got, ref.component_best_edge(w, col, rows, comp, 3))
    assert got[1].tolist() == [0, 2, 1]  # the lowest row id of each segment


@pytest.mark.parametrize("r,c", [(900, 30_000),  # keys past one block's shared memory
                                 (200_000, 1_768),  # rows past one block's registers
                                 (200_000, 60_000)])
def test_component_best_edge_cooperative_grid(card, r, c):
    """The cooperative grid, whose keys live in device memory and are zeroed
    by the call after: several calls in a row, on alternating buffers and
    growing c, each equal to both plain versions bit for bit."""
    rng = np.random.default_rng(r + c)
    for cc in (c, c // 3, c, c + 7):
        args = _cbe_case(rng, r, cc, card)
        got = _twice(component_best_edge_cuda, *args, cc)
        _bits_equal(got, ref.component_best_edge(*args, cc))
        _bits_equal(got, ref.component_best_edge_segment(*args, cc))
    # one block again after the grid: it leaves the grid's keys alone
    args = _cbe_case(rng, 300, 40, card)
    _bits_equal(component_best_edge_cuda(*args, 40), ref.component_best_edge(*args, 40))
    args = _cbe_case(rng, r, c, card)
    _bits_equal(component_best_edge_cuda(*args, c), ref.component_best_edge(*args, c))


@pytest.mark.parametrize("b,cap", [(3536, 1768), (20_000, 9_000)])
def test_sharded_candidates_two_calls_pick_the_same_winners(card, b, cap):
    """sharded_candidates runs component_best_edge twice on the same keys,
    once with the column and once with the target component as payload: both
    calls must pick the same row in every segment."""
    from repro_torch.distrib.hac_parallel import sharded_candidates, sharded_row_winners

    rng = np.random.default_rng(b)
    rows = torch.nn.functional.normalize(
        interop.data(rng.integers(-2, 3, size=(b, 24)), card), dim=1
    ).contiguous()  # integer directions: many equal similarities
    comp = interop.labels(rng.integers(0, cap, size=b), card)
    comp[rng.permutation(b)[:50]] = -1  # pad rows
    data = {"rows": rows, "rowid": interop.labels(rng.permutation(4 * b)[:b], card),
            "comp": comp}

    def visit(block, fold, acc):  # one shard: it folds only its own block
        return fold(acc, block)

    rw = sharded_row_winners(data, cap, visit)
    by_col = component_best_edge_cuda(rw["w"], rw["col"], rw["rowid"], rw["seg"], cap)
    by_tcomp = component_best_edge_cuda(rw["w"], rw["tcomp"], rw["rowid"], rw["seg"], cap)
    _bits_equal(by_col[:2], by_tcomp[:2])
    won = by_col[1] != ref.BIG_I
    where = {int(g): i for i, g in enumerate(rw["rowid"].tolist())}
    at = torch.tensor([where[int(g)] for g in by_col[1][won].tolist()], device=card)
    assert torch.equal(by_col[2][won], rw["col"][at])
    assert torch.equal(by_tcomp[2][won], rw["tcomp"][at])
    got = sharded_candidates(data, cap, visit)
    _bits_equal((got["w"], got["row"], got["col"]), by_col)
    assert torch.equal(got["tcomp"], by_tcomp[2])


def test_boruvka_distributed_nccl_world_1_matches_resident(card, tmp_path):
    """World-size-1 NCCL group from a FileStore: every mode's expanded edges
    equal the resident boruvka_mst bit for bit on the card."""
    import torch.distributed as dist

    from repro_torch.core.hac import boruvka_mst
    from repro_torch.distrib.hac_parallel import boruvka_mst_distributed
    from repro_torch.distrib.sharding import make_flat_mesh

    rng = np.random.default_rng(5)
    xs = interop.data(rng.normal(size=(500, 64)), card)
    want = boruvka_mst(xs)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        mesh = make_flat_mesh()
        for kw in ({}, {"sweep": "bcast"}, {"merge": "point"}):
            ops.reset_launch_counts()
            got = boruvka_mst_distributed(mesh, ("data",), xs, compact=False, **kw)
            n = got.u.shape[0]
            assert n % 500 == 0
            for g, w in zip(got, want):
                assert torch.equal(g.view(torch.int32) if g.dtype == torch.float32 else g,
                                   (w.view(torch.int32) if w.dtype == torch.float32 else w)[:n])
            assert not want.valid[n:].any()
            assert ops.launch_counts()["component_best_edge"] > 0
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("r,c", [(300, 270), (1, 129), (33, 1), (2000, 2000), (0, 5), (5, 0),
                                 (7, 4097), (7, 4098), (7, 4099), (7, 4100), (5, 70_001),
                                 (131, 257), (132, 257), (133, 257), (20_000, 257)])
def test_best_edge_matches_plain(card, r, c):
    """Exact on integer and on float blocks: the kernel only compares. The
    shapes take every alignment of a row start (c = 4,097 to 4,100), the
    labels past what shared memory stages (c = 70,001), and rows fewer than,
    equal to and far more than the persistent grid's blocks."""
    rng = np.random.default_rng(r + c)
    lr = interop.labels(rng.integers(-1, 5, size=r), card)
    lc = interop.labels(rng.integers(-1, 5, size=c), card)
    for sim in (_ints(rng, (r, c), -3, 3, card), interop.data(rng.normal(size=(r, c)), card)):
        _equal(_twice(best_edge_cuda, sim, lr, lc), ref.best_edge(sim, lr, lc))


def test_best_edge_ties_and_signed_zeros(card):
    r, c = 64, 700
    sim = torch.full((r, c), -1.0, device=card)
    sim[:, 650] = 2.0
    sim[:, 40] = 2.0  # the same best value in another warp step: column 40 wins
    sim[1, :] = 0.0
    sim[1, 300] = -0.0  # -0.0 and +0.0 tie: column 0 wins
    lr = torch.zeros((r,), dtype=torch.int32, device=card)
    lc = torch.ones((c,), dtype=torch.int32, device=card)
    lr[2] = 1  # all one component: no candidate
    lr[3] = -1  # a pad row
    got = best_edge_cuda(sim, lr, lc)
    _equal(got, ref.best_edge(sim, lr, lc))
    assert got[0][0] == 40 and got[0][1] == 0 and got[0][2] == -1 and got[0][3] == -1
    assert got[1][2] == ref.NEG
    # the same block and labels one float past a 16-byte boundary
    sim_off = torch.empty((r * c + 1,), device=card)
    lc_off = torch.empty((c + 1,), dtype=torch.int32, device=card)
    sim_off[1:], lc_off[1:] = sim.flatten(), lc
    _equal(_twice(best_edge_cuda, sim_off[1:].view(r, c), lr, lc_off[1:]), got)
    # every column a candidate: all -inf (column 0), -inf but one f32.min
    # (none), NaN at 333 and 555 (the first), NaN in a pad row and in a row
    # of the columns' component (none)
    sim = torch.randn((5, 1003), generator=torch.Generator().manual_seed(5)).to(card)
    sim[0] = sim[1] = -torch.inf
    sim[1, 777] = ref.NEG
    sim[2:, 333] = sim[2:, 555] = torch.nan
    lr = torch.tensor([0, 0, 0, -1, 1], dtype=torch.int32, device=card)
    lc = torch.ones((1003,), dtype=torch.int32, device=card)
    got, again = best_edge_cuda(sim, lr, lc), best_edge_cuda(sim, lr, lc)
    for g, a, w in zip(got, again, ref.best_edge(sim, lr, lc)):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
        torch.testing.assert_close(a, g, rtol=0, atol=0, equal_nan=True)
    assert got[0].tolist() == [0, -1, 333, -1, -1]
    assert got[1][0] == -torch.inf and got[1][2].isnan()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hk,dh,s", [(8, 2, 16, 40), (24, 8, 128, 1300), (9, 9, 64, 513),
                                       (20, 2, 200, 700), (6, 2, 30, 300)])
def test_flash_decode_matches_plain(card, dtype, h, hk, dh, s):
    g = torch.Generator().manual_seed(h + s)
    q, k, v = (torch.randn(shape, generator=g).to(card, dtype)
               for shape in ((h, dh), (s, hk, dh), (s, hk, dh)))
    # 64, 65, 1024 and 1025: tile and range boundaries
    for length in (0, 1, 64, 65, 511, 512, 513, 1024, 1025, s, s + 7):
        want = ref.flash_decode(q, k, v, length)
        got = flash_decode_cuda(q, k, v, torch.tensor(length, dtype=torch.int32, device=card))
        assert torch.equal(got, flash_decode_cuda(q, k, v, length))  # repeat bits
        err = (got.float() - want.float()).abs()
        if dtype == torch.float32:
            assert err.max().item() <= 2e-5
        else:  # one bf16 ulp of the plain value
            ulp = torch.exp2(torch.floor(torch.log2(want.float().abs().clamp(min=1e-30))) - 7)
            assert (err <= ulp).all()


def _decode_scale(q, k, v, length):
    """For each output, sum_i p_i |v_i| / sum_i p_i in float64: the size of
    the terms the output is summed from, which bounds an f32 summation's
    rounding where the output cancels far below them."""
    s, hk, dh = k.shape
    g = q.shape[0] // hk
    logits = torch.einsum("hd,shd->hs", q.double(), k.double().repeat_interleave(g, 1)) / dh**0.5
    if length <= 0:
        logits = torch.zeros_like(logits)
    logits[:, min(length, s) if length > 0 else s:] = -torch.inf
    return torch.einsum("hs,shd->hd", torch.softmax(logits, -1),
                        v.double().abs().repeat_interleave(g, 1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hk,dh,s", [(24, 8, 128, 4096),  # llama3.2-3b's heads, s cut
                                       (32, 8, 128, 700),  # g = 4
                                       (96, 8, 128, 700),  # g = 12: two blocks of heads
                                       (16, 4, 64, 700), (8, 2, 256, 700)])
def test_flash_decode_heads_and_widths_match_plain(card, dtype, h, hk, dh, s):
    """f32 within 2e-5 of the plain version; bf16 within one bf16 ulp of the
    plain value plus 16 f32 ulps (2^-20) of the size of its terms, sum p|v| /
    sum p. Each logit is an f32 dot product of 128 O(1) terms, rounded ~10
    f32 ulps away from the exact one in either version, so an output that
    cancels far below its terms (~1e-6 here, against terms ~0.05) differs by
    more than a bf16 ulp between two right f32 computations; elsewhere the
    allowance is far below the ulp."""
    g = torch.Generator().manual_seed(h + s)
    q, k, v = (torch.randn(shape, generator=g).to(card, dtype)
               for shape in ((h, dh), (s, hk, dh), (s, hk, dh)))
    for length in (0, 1, 64, 65, 511, 512, 513, 1024, 1025, s, s + 7):
        want = ref.flash_decode(q, k, v, length)
        got = flash_decode_cuda(q, k, v, torch.tensor(length, dtype=torch.int32, device=card))
        assert torch.equal(got, flash_decode_cuda(q, k, v, length))  # repeat bits
        if dtype == torch.float32:
            assert (got - want).abs().max().item() <= 2e-5
            continue
        ulp = torch.exp2(torch.floor(torch.log2(want.float().abs().clamp(min=1e-30))) - 7)
        allow = ulp.double() + 2.0**-20 * _decode_scale(q, k, v, length)
        bad = (got.double() - want.double()).abs() > allow
        i = int(bad.flatten().to(torch.uint8).argmax())
        assert not bad.any(), (length, int(bad.sum()), got.flatten()[i].item(),
                               want.flatten()[i].item())


def test_kmeans_fit_stream_prefetch_on_off_bits_on_card(card, monkeypatch):
    """Host chunks staged by the prefetch producer (pinned, side stream) and
    copied by the fold itself give the same bits; so does the mapped tf-idf
    stream, and a one-chunk stream equals the resident fit."""
    from repro_torch.core.kmeans import kmeans_fit, kmeans_fit_stream
    from repro_torch.text import pipeline
    from repro_torch.text.stream import CorpusStream

    prep = {}
    fits = {}
    for mode in ("0", "2"):
        monkeypatch.setenv("REPRO_STREAM_PREFETCH", mode)
        p = pipeline.prepare_synthetic_stream(n_docs=3000, vocab=256, n_topics=8, seed=3,
                                              chunk=700, device=card)
        prep[mode] = p.x.materialize()
        x = prep[mode]
        init = interop.data(x[:8], card)
        fits[mode] = kmeans_fit_stream(CorpusStream.from_array(x, chunk=700), init, 8)
        fits[mode + "mapped"] = kmeans_fit_stream(p.x, init, 8)
    assert np.array_equal(prep["0"], prep["2"])
    for a, b in ((fits["0"], fits["2"]), (fits["0mapped"], fits["2mapped"]),
                 (fits["0"], fits["2mapped"])):
        assert torch.equal(a.centers, b.centers) and torch.equal(a.assignment, b.assignment)
        assert a.iterations == b.iterations
    x = interop.data(prep["0"], card)
    res = kmeans_fit(x, x[:8].contiguous(), 8)
    one = kmeans_fit_stream(CorpusStream.from_array(prep["0"]), x[:8].contiguous(), 8)
    assert torch.equal(one.centers, res.centers)
    assert torch.equal(one.assignment, res.assignment.cpu())


def test_flash_decode_unaligned_cache(card):
    """k and v starting one element past an aligned address take the
    one-value loads; the result equals the aligned copy's."""
    g = torch.Generator().manual_seed(2)
    s, hk, dh = 600, 2, 64
    q = torch.randn((8, dh), generator=g).to(card)
    flat = torch.randn((2, s * hk * dh + 1), generator=g).to(card)
    k, v = (flat[i, 1:].view(s, hk, dh) for i in (0, 1))
    assert k.is_contiguous() and k.data_ptr() % 16 != 0
    got = flash_decode_cuda(q, k, v, 450)
    assert (got - ref.flash_decode(q, k, v, 450)).abs().max().item() <= 2e-5
    assert torch.equal(got, flash_decode_cuda(q, k.clone(), v.clone(), 450))


def test_flash_decode_unaligned_bf16_cache(card):
    """A bf16 cache one element past an aligned address takes the plain
    loads into the same shared-memory layout: the aligned copy's bits."""
    g = torch.Generator().manual_seed(3)
    s, hk, dh = 900, 2, 128
    q = torch.randn((6, dh), generator=g).to(card, torch.bfloat16)
    flat = torch.randn((2, s * hk * dh + 1), generator=g).to(card, torch.bfloat16)
    k, v = (flat[i, 1:].view(s, hk, dh) for i in (0, 1))
    assert k.is_contiguous() and k.data_ptr() % 16 != 0
    got = flash_decode_cuda(q, k, v, 700)
    assert torch.equal(got, flash_decode_cuda(q, k.clone(), v.clone(), 700))
    want = ref.flash_decode(q, k, v, 700).float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=1e-30))) - 7)
    assert ((got.float() - want).abs() <= ulp).all()


def test_flash_decode_ticket_counters_reset(card):
    """The last block of each kv head leaves its ticket counter at 0: two
    calls of one shape on one stream, around calls of other shapes, give the
    same bits."""
    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(shape, generator=g).to(card)
               for shape in ((24, 128), (3000, 8, 128), (3000, 8, 128)))
    first = flash_decode_cuda(q, k, v, 2500)
    second = flash_decode_cuda(q, k, v, 2500)
    flash_decode_cuda(q[:4].contiguous(), k[:, :2].contiguous(), v[:, :2].contiguous(), 900)
    flash_decode_cuda(q, k, v, torch.tensor(17, dtype=torch.int32, device=card))
    assert torch.equal(first, second)
    assert torch.equal(first, flash_decode_cuda(q, k, v, 2500))
    assert (first - ref.flash_decode(q, k, v, 2500)).abs().max().item() <= 2e-5


def test_kmeans_fit_stream_cut_and_resumed_bit_for_bit_on_card(card):
    """kmeans_fit_stream on the card, cut by an injected producer fault
    inside iteration 2's pass and, on the resumed run, inside the final
    pass, then resumed from a MemoryCheckpointer: the uninterrupted fit's
    bits, an empty store, and assign_stats launched only for the final
    pass's chunks after its snapshot."""
    from repro_torch.core.kmeans import kmeans_fit_stream
    from repro_torch.resilience import MemoryCheckpointer
    from repro_torch.testing import faults
    from repro_torch.testing.faults import InjectedFault
    from repro_torch.text.stream import CorpusStream

    rng = np.random.default_rng(18)
    c = rng.standard_normal((8, 96))
    x = c[rng.integers(0, 8, 4000)] + 0.6 * rng.standard_normal((4000, 96))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    st = CorpusStream.from_array(x, chunk=512)  # 8 chunks, the last with 96 pad rows
    init = interop.data(x[:8], card)
    want = kmeans_fit_stream(st, init, 8)
    iters, nch = want.iterations, st.n_chunks
    assert iters >= 3
    ck = MemoryCheckpointer(every=2)
    for spec in (f"raise@g{2 * nch + 5}", f"raise@g{(iters - 2) * nch + 7}"):
        with faults.inject(spec), pytest.raises(InjectedFault):
            kmeans_fit_stream(st, init, 8, checkpoint=ck)
        assert ck._store
    ops.reset_launch_counts()
    got = kmeans_fit_stream(st, init, 8, checkpoint=ck)
    assert ops.launch_counts()["assign_stats"] == nch - 6
    assert got.iterations == iters and not ck._store
    for f in ("centers", "assignment", "best_sim", "rss", "objective"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_kmeans_distributed_stream_nccl_world_1_equals_single_device(card, tmp_path):
    """kmeans_distributed_stream over a NCCL group of one rank (a FileStore:
    no network), bounded and not, equals the single-device
    kmeans_fit_stream on the same stream bit for bit: both fold the chunk
    partials in chunk order, the collective is a copy, and both sum the
    per-cluster squared norms for the RSS. Cut by a producer fault in
    iteration 1 and resumed, it gives the same bits again."""
    import torch.distributed as dist

    from repro_torch.core.kmeans import kmeans_fit_stream
    from repro_torch.distrib import cluster as dc
    from repro_torch.distrib.sharding import make_flat_mesh
    from repro_torch.resilience import MemoryCheckpointer
    from repro_torch.testing import faults
    from repro_torch.testing.faults import InjectedFault
    from repro_torch.text.stream import CorpusStream

    rng = np.random.default_rng(19)
    c = rng.standard_normal((8, 96))
    x = c[rng.integers(0, 8, 4000)] + 0.6 * rng.standard_normal((4000, 96))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    st = CorpusStream.from_array(x, chunk=512)
    init = interop.data(x[:8], card)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        mesh = make_flat_mesh()
        fits = {}
        for bounded in (True, False):
            want = kmeans_fit_stream(st, init, 8, bounded=bounded)
            got = fits[bounded] = dc.kmeans_distributed_stream(mesh, ("data",), st, init, 8,
                                                               bounded=bounded)
            assert got.iterations == want.iterations >= 2
            for f in ("centers", "assignment", "rss", "objective"):
                assert torch.equal(getattr(got, f), getattr(want, f)), (bounded, f)
        got = fits[False]
        ck = MemoryCheckpointer(every=2)
        with faults.inject(f"raise@g{st.n_chunks + 3}"), pytest.raises(InjectedFault):
            dc.kmeans_distributed_stream(mesh, ("data",), st, init, 8, checkpoint=ck)
        ops.reset_launch_counts()
        again = dc.kmeans_distributed_stream(mesh, ("data",), st, init, 8, checkpoint=ck)
        assert ops.launch_counts()["assign_stats"] == (got.iterations + 1) * st.n_chunks - (
            st.n_chunks + 2)
        assert torch.equal(again.centers, got.centers) and torch.equal(again.rss, got.rss)
        assert torch.equal(again.assignment, got.assignment) and not ck._store
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------ calls from several threads


def _thread_case(rng, n, d, k, card):
    """One thread's inputs: integer-valued rows, centers, labels, weights."""
    x = _ints(rng, (n, d), -3, 3, card)
    centers = _ints(rng, (k, d), -3, 3, card)
    lab = interop.labels(rng.integers(-1, k + 1, size=n), card)
    w = _ints(rng, (n,), 0, 2, card)
    bounds = ops.bounds_identity(n, card)
    drift = torch.zeros((k,), device=card)
    calls = (
        lambda: label_stats_cuda(x, lab, k, w),
        lambda: assign_stats_cuda(x, centers, w),
        lambda: assign_stats_bounded_cuda(x, centers, bounds.idx, bounds.lo, bounds.hi,
                                          drift, w),
    )
    return calls, [call() for call in calls]  # each call made alone


def test_fold_kernels_from_two_threads_equal_each_call_alone(card):
    """Two threads on the default stream make 200 calls each of label_stats,
    assign_stats and assign_stats_bounded at different shapes: the fold's
    partials buffer is the device's, so a call that enqueued its fold
    between another's fold and reduce would take that call's partials. The
    launch counts, added to from both threads, must count every call."""
    import sys
    import threading

    cases = [_thread_case(np.random.default_rng(s), n, d, k, card)
             for s, (n, d, k) in enumerate([(3000, 96, 50), (1700, 130, 300)])]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    bad, errors = [], []

    def work(t):
        calls, alone = cases[t]
        try:
            for i in range(200):
                for c, (call, want) in enumerate(zip(calls, alone)):
                    got = call()
                    if not all(torch.equal(g, w_) for g, w_ in zip(got, want)):
                        bad.append((t, i, c))
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    ts = [threading.Thread(target=work, args=(t,)) for t in range(2)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as the interpreter can
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=600)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    assert not errors, errors
    assert not bad, bad[:10]
    counts = ops.launch_counts()
    assert [counts[n] for n in ("label_stats", "assign_stats", "assign_stats_bounded")] == [400] * 3


@pytest.mark.parametrize("d", [96, 130])  # the TMA path, and plain loads
def test_label_stats_first_call_of_a_fresh_thread(card, d):
    """A thread whose CUDA work so far only reused cached memory has no
    context current; the fold's tensor-map encode (cuTensorMapEncodeTiled)
    must bind one first."""
    import threading

    rng = np.random.default_rng(d)
    x = _ints(rng, (3000, d), -3, 3, card)
    lab = interop.labels(rng.integers(0, 50, size=3000), card)
    want = label_stats_cuda(x, lab, 50)
    label_stats_cuda(x, lab, 50)  # its outputs' blocks go back to the cache, for the thread
    torch.cuda.synchronize()
    got, errors = [], []

    def run():
        try:
            got.append(label_stats_cuda(x, lab, 50))
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and not errors, errors
    _equal(got[0], want)


# ------------------------------------------------------ the fold's sorter race


def _label_stats_delayed(x, idx, k, w):
    """label_stats through the debug build whose producer issues each odd
    ring stage's copies after the next stage's (``_build.VARIANTS``)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import assign_stats as ak

    lib = _build.library("label_stats_delay", ak._SIGNATURES["label_stats"])
    n, d = x.shape
    chunks = lib.label_stats_chunks(n, k, d)
    part = torch.empty((chunks * k * (d + 3),), dtype=torch.float32, device=x.device)
    sums = torch.empty((k, d), dtype=torch.float32, device=x.device)
    counts = torch.empty((k,), dtype=torch.float32, device=x.device)
    err = lib.label_stats(
        x.data_ptr(), idx.data_ptr(), None if w is None else w.data_ptr(), n, d, k, chunks,
        part.data_ptr(), part.data_ptr() + 4 * chunks * k * d, sums.data_ptr(),
        counts.data_ptr(), _build.stream(x),
    )
    _build.check(err, "label_stats_delay")
    return sums, counts


@pytest.mark.parametrize("k", [1000, 2000, 4200])  # label tiles of 1,000-1,050: 3 stages
@pytest.mark.parametrize("weighted", [False, True])
def test_label_stats_sorters_with_later_stages_landing_first(card, k, weighted):
    """Each sorter warp must wait on every phase of the ring slots it owns:
    with a three-stage ring a sorter that took alternate stages would find
    a later stage's copies landed and read a slot whose copies had not.
    The debug build lands them in that order on every odd stage."""
    rng = np.random.default_rng(k + weighted)
    n, d = 60_000, 256
    x = _ints(rng, (n, d), -3, 3, card)
    idx = interop.labels(rng.integers(-1, k + 1, size=n), card)
    w = _ints(rng, (n,), 0, 2, card) if weighted else None
    want = ref.label_stats(x, idx, k, w)
    for _ in range(2):
        _equal(_label_stats_delayed(x, idx, k, w), want)


# ------------------------------------------------------ the online service


def test_cluster_service_on_card_matches_assign_batch_and_offline_buckshot(card):
    """The service on the card (device=None): each answer equals
    assign_batch on the same rescaled slab bit for bit, and the swapped
    centers equal an offline buckshot_stream on the card with the same
    generator bit for bit."""
    from repro_torch.core.buckshot import buckshot_stream
    from repro_torch.core.kmeans import assign_batch
    from repro_torch.serve import ClusterService, ServiceConfig
    from repro_torch.serve.cluster_service import draw_generator
    from repro_torch.text import hashing, tfidf
    from repro_torch.text.stream import CorpusStream

    def texts(n, seed, lo, hi):
        r = np.random.default_rng(seed)
        return [" ".join(f"t{v}" for v in r.integers(lo, hi, 30)) for _ in range(n)]

    base, new = texts(900, 0, 0, 300), texts(200, 1, 250, 500)
    cfg = ServiceConfig(k=6, dim=256, chunk=128, max_batch=32, sample_size=60,
                        kmeans_iters=3, drift_mass=0.2, validate_slack=100.0)
    ops.reset_launch_counts()
    with ClusterService.fit(base, 11, config=cfg) as svc:
        m = svc.model
        assert m.centers.is_cuda and m.index is not None
        docs = texts(32, 2, 0, 300)
        out = svc.assign(docs)
        x = tfidf._rescale(interop.data(hashing.vectorize(docs, 256), card), m.df, m.n_docs)
        idx, sim = assign_batch(x, m.centers, index=m.index)
        np.testing.assert_array_equal(out.idx, idx.cpu().numpy())
        np.testing.assert_array_equal(out.best_sim, sim.cpu().numpy())
        rec = svc.ingest(new)
        assert rec.drift and rec.refit_id == 1
        assert svc.refit_wait(1, timeout=300.0) and svc.model.version == 1
        stream = CorpusStream.from_texts(base + new, dim=256, chunk=128)
        want = buckshot_stream(tfidf.tfidf_stream(stream), 6, draw_generator(11, 1),
                               sample_size=60, kmeans_iters=3, bounded=True)
        assert torch.equal(svc.model.centers, want.kmeans.centers)
    counts = ops.launch_counts()
    for name in ("sim_best_edge", "label_stats", "assign_stats", "assign_argmax",
                 "assign_stats_bounded"):
        assert counts[name] > 0, counts


# ------------------------------------------------------------------ LM zoo


LM_NEW_FAMILIES = ["mixtral-8x22b", "moonshot-v1-16b-a3b", "zamba2-2.7b", "rwkv6-3b"]
LM_ARCHS = ["qwen2-1.5b", "llama3.2-3b", "minitron-8b", "gemma3-4b", "paligemma-3b",
            "whisper-base", *LM_NEW_FAMILIES]


def _lm(arch, device, seed=0):
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model

    cfg = get_config(arch, reduced=True)
    return cfg, get_model(cfg).init_params(torch.Generator().manual_seed(seed), device)


def test_lm_serve_on_card_matches_the_cpu(card):
    """qwen2-1.5b REDUCED, the same weights on the card and the CPU: prefill
    and decode logits and embeddings within rtol/atol 1e-4 (f32, no TF32),
    greedy completions equal."""
    from repro_torch.models import transformer
    from repro_torch.models.registry import make_batch
    from repro_torch.serve import Request, ServeEngine

    cfg, cpu = _lm("qwen2-1.5b", "cpu")
    _, gpu = _lm("qwen2-1.5b", card)
    batch = make_batch(cfg, 3, 20, torch.Generator().manual_seed(1), "cpu")
    on_card = {k: v.to(card) for k, v in batch.items()}
    want = transformer.prefill(cpu, cfg, batch, torch.float32, cache_len=24)
    got = transformer.prefill(gpu, cfg, on_card, torch.float32, cache_len=24)
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-4, atol=1e-4)
    step = batch["tokens"][:, -1:]
    want_d = transformer.decode_step(cpu, cfg, step, want[1], want[2])[0]
    got_d = transformer.decode_step(gpu, cfg, step.to(card), got[1], got[2])[0]
    torch.testing.assert_close(got_d.cpu(), want_d, rtol=1e-4, atol=1e-4)
    reqs = [Request(prompt=[1, 2, 3, 4], max_new_tokens=6), Request(prompt=[7, 8], max_new_tokens=3)]
    e_cpu = ServeEngine(cfg=cfg, params=cpu, device="cpu")
    e_gpu = ServeEngine(cfg=cfg, params=gpu)  # device=None: the card
    assert [o.tokens for o in e_gpu.generate(reqs)] == [o.tokens for o in e_cpu.generate(reqs)]
    emb = e_gpu.embed(batch)
    assert emb.is_cuda
    torch.testing.assert_close(emb.cpu(), e_cpu.embed(batch), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_prefill_decode_consistent_on_card(card, arch):
    """logits(prefill(T) + decode) == logits(prefill(T + 1)) on the card."""
    from repro_torch.models import transformer
    from repro_torch.models.registry import make_batch

    cfg, lm = _lm(arch, card, seed=3)
    batch = make_batch(cfg, 2, 25, torch.Generator().manual_seed(4), card)
    prefix = {**batch, "tokens": batch["tokens"][:, :-1]}
    want = transformer.prefill(lm, cfg, batch, torch.float32)[0]
    _, caches, pos = transformer.prefill(lm, cfg, prefix, torch.float32, cache_len=pos_cap(cfg, 24))
    got, _ = transformer.decode_step(lm, cfg, batch["tokens"][:, -1:], caches, pos)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def pos_cap(cfg, t):
    """Cache capacity past a prompt of t text tokens (and a vlm's prefix)."""
    return t + 8 + (cfg.n_frontend_tokens if cfg.family == "vlm" else 0)


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree(v, fn) for v in tree]
    return fn(tree)


def _flat(tree) -> list:
    out = []
    _tree(tree, out.append)
    return out


@pytest.mark.parametrize("arch", LM_NEW_FAMILIES)
def test_lm_family_on_card_matches_the_cpu(card, arch):
    """moe, hybrid and rwkv at REDUCED, the same weights on the card and the
    CPU: forward (and the MoE aux), prefill logits and every cache leaf
    (K/V, SSM and RWKV states, conv tails, shifts), and one decode step
    within rtol/atol 1e-4 (f32, no TF32)."""
    from repro_torch.models import transformer
    from repro_torch.models.registry import make_batch

    cfg, cpu = _lm(arch, "cpu", seed=5)
    _, gpu = _lm(arch, card, seed=5)
    batch = make_batch(cfg, 2, 21, torch.Generator().manual_seed(6), "cpu")
    on_card = {k: v.to(card) for k, v in batch.items()}
    tol = dict(rtol=1e-4, atol=1e-4)
    h_c, aux_c, _ = transformer.forward(cpu, cfg, batch)
    h_g, aux_g, _ = transformer.forward(gpu, cfg, on_card)
    torch.testing.assert_close(h_g.cpu(), h_c, **tol)
    torch.testing.assert_close(aux_g.cpu(), aux_c, **tol)
    want = transformer.prefill(cpu, cfg, batch, torch.float32, cache_len=28)
    got = transformer.prefill(gpu, cfg, on_card, torch.float32, cache_len=28)
    torch.testing.assert_close(got[0].cpu(), want[0], **tol)
    for g, w in zip(_flat(got[1]), _flat(want[1]), strict=True):
        torch.testing.assert_close(g.cpu(), w, **tol)
    step = batch["tokens"][:, -1:]
    want_d = transformer.decode_step(cpu, cfg, step, want[1], want[2])
    got_d = transformer.decode_step(gpu, cfg, step.to(card), got[1], got[2])
    torch.testing.assert_close(got_d[0].cpu(), want_d[0], **tol)
    for g, w in zip(_flat(got_d[1]), _flat(want_d[1]), strict=True):
        torch.testing.assert_close(g.cpu(), w, **tol)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "moonshot-v1-16b-a3b"])
def test_moe_prefill_on_card_is_deterministic(card, arch):
    """Two MoE prefills on the card equal bit for bit, at the published
    capacity factor (1.25), where tokens drop: the dispatch (stable sort,
    bincount, distinct slots written by index) has no order to vary."""
    import dataclasses

    from repro_torch.models import transformer
    from repro_torch.models.registry import make_batch

    cfg, gpu = _lm(arch, card, seed=7)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=1.25))
    batch = make_batch(cfg, 4, 32, torch.Generator().manual_seed(8), card)
    a = transformer.prefill(gpu, cfg, batch, torch.float32)
    b = transformer.prefill(gpu, cfg, batch, torch.float32)
    assert torch.equal(a[0], b[0])
    for x, y in zip(_flat(a[1]), _flat(b[1]), strict=True):
        assert torch.equal(x, y)
