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
from repro_torch.kernels.assign_argmax import assign_argmax_cuda
from repro_torch.kernels.assign_stats import (
    assign_stats_bounded_cuda,
    assign_stats_cuda,
    label_stats_cuda,
)
from repro_torch.kernels.component_reduce import component_best_edge_cuda
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
    ops.assign_argmax(x, x[:4])
    ops.assign_stats_bounded(x, x[:4], ops.bounds_identity(64), torch.zeros(4, device=card))
    rows = torch.arange(64, dtype=torch.int32, device=card)
    ops.component_best_edge(x[:, 0], lab, rows, lab, 4)
    assert ops.launch_counts() == {
        "sim_best_edge": 1, "label_stats": 1, "assign_stats": 1,
        "assign_argmax": 1, "assign_stats_bounded": 1, "component_best_edge": 1,
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
     (300, 24, 4200)],  # more than one tile of slab directions (64 slabs)
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
    init = x[interop.index(np.random.default_rng(3).choice(1500, big_k, replace=False))]
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
