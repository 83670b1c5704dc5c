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

import zlib

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
    split_bf16x3,
)
from repro_torch.kernels.best_edge import (
    BF16_STAGED_NARROW,
    BF16_STAGED_WIDE,
    best_edge_cuda,
)
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


# ------------------------------------------------------------------ bf16 rows
#
# sim_best_edge, label_stats and assign_stats take bf16 document rows.
# label_stats, assign_stats' fold and its row norms convert each element to
# f32 exactly and keep the f32 mode's order: bit for bit with the f32 mode on
# the upcast rows. sim_best_edge and assign_stats' nearest-center tile
# multiply on the tensor cores, the JAX kernels' contract (bf16 products
# exact, f32 sums in the tensor cores' order), held to the f32 mode on the
# upcast inputs by these gates, each a case of the tests below:
#   (a) "integer": x's entries in {-3, ..., 3}, centers too or f32 values
#       of 24 significant bits (_split_exact_rows), so every product and
#       partial sum is exact in f32: every output torch.equal to the f32
#       mode's, ties (everywhere) to the lowest index;
#   (b) "unit": unit rows rounded to bf16 (f32 centers: unit rows in f32,
#       not rounded): similarities within SIM_TOL of the f32 mode's, an
#       index differing only at a near-tie (chip_smoke.py's check_argmax
#       rule) and, wherever idx agrees on every row, assign_stats' sums,
#       counts and sumsq bit for bit, min_sim within SIM_TOL;
#   (c) every call repeats its bits (_twice);
#   (d) "symmetry" (sim_best_edge): the full grid on a copy equals the
#       self-search bit for bit, whichever operand a row is;
#   (e) "rows_at": the same rows 1 and 37 rows further into x (another place
#       in the tiles and in a warpgroup's 64 rows) give the same bits.
# chip_smoke.py's phase 2 runs these tests and the gates at the main shapes.

SIM_TOL = 1e-5  # the plain versions' tolerance on unit rows (chip_smoke.py)
SUM_RTOL, SUM_ATOL = 1e-4, 1e-5
ROW_SHIFTS = (1, 37)


def _at_offset(t, offset):
    """``t`` copied to start ``offset`` elements into a fresh allocation (a
    base off 16 bytes); ``t`` itself for offset 0."""
    if not offset:
        return t
    flat = torch.empty((t.numel() + offset,), dtype=t.dtype, device=t.device)
    return flat[offset:].view(t.shape).copy_(t)


def _unit_rows(rng, shape, card):
    """Unit rows in f32 on the card, full 24-bit significands."""
    a = rng.normal(size=shape).astype(np.float32)
    a /= np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-30)
    return torch.from_numpy(a).to(card)


def _bf16_rows(rng, shape, card, offset=0):
    """Unit rows rounded to bf16 on the card; with ``offset`` the rows start
    that many elements into their allocation (a base off 16 bytes)."""
    return _at_offset(_unit_rows(rng, shape, card).bfloat16(), offset)


def _split_exact_rows(rng, shape, card):
    """f32 center rows with all three bf16 parts (split_bf16x3) in use whose
    dot products with rows of integers in {-3, ..., 3} sum exactly in f32
    in any order. Up to 16 entries a row are +-(1 + b 2^-8 + e 2^-16), b in
    {0, ..., 3}, e in {1, 3} (hi holds 1 and 2^-7, mid 2^-8 and 2^-15, lo
    2^-16: never 0); the others b' 2^-8 + e' 2^-16, b', e' in {-3, ..., 3}.
    Every value is a multiple of 2^-16 and 3 * sum |c| of a row stays under
    2^7 up to d = 2,048, so every product and partial sum has at most 23
    significant bits."""
    k, d = shape
    c = (rng.integers(-3, 4, size=shape) * 256 + rng.integers(-3, 4, size=shape)).astype(np.int64)
    m = min(d, 16)
    pos = np.argsort(rng.random(shape), axis=1)[:, :m]
    big = 65536 + rng.integers(0, 4, size=(k, m)) * 256 + rng.choice([1, 3], size=(k, m))
    np.put_along_axis(c, pos, rng.choice([-1, 1], size=(k, m)) * big, axis=1)
    assert k == 0 or 3 * np.abs(c).sum(1).max() < 2**23
    return torch.from_numpy((c / 65536.0).astype(np.float32)).to(card)


def _three_parts(centers):
    """Fail unless f32 centers carry bits in the mid and lo parts of their
    split, so a kernel that read only the hi part would disagree."""
    parts = split_bf16x3(centers)
    assert (parts[1] != 0).any() and (parts[2] != 0).any(), "f32 centers with no mid or lo bits"


def _bf16_ints(rng, shape, card, offset=0):
    """Rows of integers in {-3, ..., 3} in bf16, placed as _bf16_rows."""
    return _at_offset(_ints(rng, shape, -3, 3, card).bfloat16(), offset)


def _same_bits(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _near_ties(name, got_idx, want_idx, want_val, sim_at):
    """Indices equal except where the bf16 call's pick scores, in f32, within
    SIM_TOL of the f32 mode's best; returns how many differ."""
    assert torch.equal(got_idx < 0, want_idx < 0), f"{name}: a row lost or gained its candidate"
    rows = (got_idx != want_idx).nonzero().flatten()
    if rows.numel():
        gap = (want_val[rows] - sim_at(rows, got_idx[rows].long())).abs()
        assert gap.max().item() <= SIM_TOL, f"{name}: {rows.numel()} indices differ, not at near-ties"
    return int(rows.numel())


def _close(name, got, want, rtol, atol):
    err = (got.double() - want.double()).abs()
    assert (err <= atol + rtol * want.double().abs()).all(), (
        f"{name}: max abs err {err.max().item()} beyond rtol={rtol} atol={atol}")
    return err.max().item() if err.numel() else 0.0


def _shifted(x, shift):
    """x's rows ``shift`` rows further down, after rows of zeros."""
    return torch.cat([x.new_zeros((shift, x.shape[1])), x])


def bf16_sim_gate(gate, xr, xc, lr, lc, self_labels):
    """Gate ``gate`` (with (c)) of sim_best_edge on bf16 rows: the full grid
    xr by xc (labels lr, lc) and the self-search on xr under each of
    ``self_labels``. Returns (max |best_s - the f32 mode's|, indices that
    differ at near-ties)."""
    xrf, xcf = xr.float(), xc.float()
    calls = [(xr, xc, lr, lc, xrf, xcf)] + [(xr, xr, lab, lab, xrf, xrf) for lab in self_labels]
    err, ties = 0.0, 0
    for a, b, la, lb, af, bf in calls:
        self_search = a is b
        got = _twice(sim_best_edge_cuda, a, b, la, lb)
        if gate == "integer":  # (the f32 mode of a self-search is one too)
            _same_bits(got, sim_best_edge_cuda(af, bf, la, lb))
        elif gate == "unit":
            want = sim_best_edge_cuda(af, bf, la, lb)
            ties += _near_ties("sim_best_edge bf16", got[0], want[0], want[1],
                               lambda rows, cols: (af[rows] * bf[cols]).sum(1))
            err = max(err, _close("sim_best_edge bf16 best_s", got[1], want[1], 0.0, SIM_TOL))
        elif gate == "symmetry":
            if self_search:  # the full grid on a copy, every pair both ways
                _same_bits(got, sim_best_edge_cuda(a, b.clone(), la, lb.clone()))
        elif gate == "rows_at":
            for shift in ROW_SHIFTS:
                pad = torch.full((shift,), -1, dtype=torch.int32, device=a.device)
                a2 = _shifted(a, shift)
                la2 = torch.cat([pad, la])
                if self_search:
                    moved = sim_best_edge_cuda(a2, a2, la2, la2)
                else:
                    moved = sim_best_edge_cuda(a2, _shifted(b, shift), la2,
                                               torch.cat([pad, lb]))
                j, s = moved[0][shift:], moved[1][shift:]
                _same_bits((torch.where(j >= 0, j - shift, j), s), got)
        else:
            raise ValueError(gate)
    return err, ties


def bf16_assign_gate(gate, x, centers, w):
    """Gate ``gate`` (with (c)) of assign_stats on bf16 x (bf16 or f32
    centers, weights w). Returns (max abs err of best_sim and min_sim
    against the f32 mode, and of the fold against the f32 fold over its own
    assignment; near-tie index differences)."""
    xf, cf = x.float(), centers.float()
    got = _twice(assign_stats_cuda, x, centers, w)
    if gate == "integer":
        _same_bits(got, assign_stats_cuda(xf, cf, w))
        _same_bits(assign_stats_cuda(x, centers), assign_stats_cuda(xf, cf))
        return 0.0, 0
    if gate == "rows_at":
        for shift in ROW_SHIFTS:
            w2 = None if w is None else torch.cat([w.new_zeros((shift,)), w])
            moved = assign_stats_cuda(_shifted(x, shift), centers, w2)
            _same_bits((moved[0][shift:], moved[1][shift:]), got[:2])
        return 0.0, 0
    assert gate == "unit", gate
    want = assign_stats_cuda(xf, cf, w)
    ties = _near_ties("assign_stats bf16", got[0], want[0], want[1],
                      lambda rows, cols: (xf[rows] * cf[cols]).sum(1))
    err = _close("assign_stats bf16 best_sim", got[1], want[1], 0.0, SIM_TOL)
    if not ties:  # the fold and the row norms are the f32 mode's
        _same_bits((got[0], got[2], got[3], got[5]), (want[0], want[2], want[3], want[5]))
        err = max(err, _close("assign_stats bf16 min_sim", got[4], want[4], 0.0, SIM_TOL))
    else:  # the f32 fold over the bf16 call's own assignment
        sums, counts = label_stats_cuda(xf, got[0], centers.shape[0], w)
        err = max(err, _close("assign_stats bf16 sums", got[2], sums, SUM_RTOL, SUM_ATOL))
        _close("assign_stats bf16 counts", got[3], counts, SUM_RTOL, SUM_ATOL)
    return err, ties


# (r, c, d, offset): odd d, d off 8 and 32 (no copy engine: plain loads),
# bases off 16 bytes, sizes off the 128-row and 128-column tiles
BF16_SIM_CASES = [(300, 270, 70, 0), (257, 257, 257, 0), (129, 129, 2048, 1),
                  (1, 129, 16, 0), (1000, 1000, 130, 0), (3536, 3536, 2048, 0)]
BF16_SIM_GATES = ("integer", "unit", "symmetry", "rows_at")


@pytest.mark.parametrize("gate", BF16_SIM_GATES)
@pytest.mark.parametrize("r,c,d,offset", BF16_SIM_CASES)
def test_bf16_sim_best_edge_equals_f32_mode(card, r, c, d, offset, gate):
    """sim_best_edge on bf16 rows against its f32 mode on the upcast rows,
    under gate (a), (b), (d) or (e), each with (c)."""
    rng = np.random.default_rng(r + c + d + offset)
    rows = _bf16_ints if gate == "integer" else _bf16_rows
    xr = rows(rng, (r, d), card, offset)
    xc = rows(rng, (c, d), card)
    lr = interop.labels(rng.integers(-1, 5, size=r), card)  # -1 = pad
    lc = interop.labels(rng.integers(-1, 5, size=c), card)
    self_labels = (torch.arange(r, dtype=torch.int32, device=card),
                   interop.labels(rng.integers(-1, r // 7 + 2, size=r), card))
    bf16_sim_gate(gate, xr, xc, lr, lc, self_labels)


# (n, k, d, offset) for the fold and the fused pass
BF16_STATS_CASES = [(1000, 70, 130, 0), (300, 129, 257, 0), (129, 1, 33, 1),
                    (1000, 50, 2048, 1), (3000, 50, 2048, 0), (127, 64, 8, 0),
                    (1, 5, 64, 0), (0, 3, 40, 0), (3000, 800, 96, 0), (2000, 1600, 130, 0)]
BF16_STATS_GATES = ("integer", "unit", "rows_at")


@pytest.mark.parametrize("n,k,d,offset", BF16_STATS_CASES)
def test_bf16_label_stats_equals_f32_mode(card, n, k, d, offset):
    rng = np.random.default_rng(n + k + d + offset + 1)
    x = _bf16_rows(rng, (n, d), card, offset)
    idx = interop.labels(rng.integers(-2, k + 2, size=n), card)  # out of range too
    w = _ints(rng, (n,), 0, 2, card)  # weight-0 rows
    _same_bits(_twice(label_stats_cuda, x, idx, k, w), label_stats_cuda(x.float(), idx, k, w))
    _same_bits(label_stats_cuda(x, idx, k), label_stats_cuda(x.float(), idx, k))


@pytest.mark.parametrize("gate", BF16_STATS_GATES)
@pytest.mark.parametrize("centers_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,k,d,offset", BF16_STATS_CASES)
def test_bf16_assign_stats_equals_f32_mode(card, n, k, d, offset, centers_dtype, gate):
    """bf16 x with bf16 centers (the JAX sweep) or f32 centers (K-Means
    after its first pass: three bf16 parts, all in use) against the f32
    mode on the upcast inputs, under gate (a), (b) or (e), each with (c);
    equal centers across tiles, weight-0 rows."""
    rng = np.random.default_rng(n + k + d + offset + 2)
    rows = _bf16_ints if gate == "integer" else _bf16_rows
    x = rows(rng, (n, d), card, offset)
    if centers_dtype == torch.float32:  # not bf16 values: mid and lo carry bits
        centers = (_split_exact_rows if gate == "integer" else _unit_rows)(rng, (k, d), card)
        _three_parts(centers)
    else:
        centers = rows(rng, (k, d), card)
    if k > 65:
        centers[65] = centers[1]  # a tie across center tiles
    w = _ints(rng, (n,), 0, 1, card)
    bf16_assign_gate(gate, x, centers, w)


@pytest.mark.parametrize("d", [1, 8, 31, 33, 63, 64, 65, 130, 2048])
def test_bf16_split_stride_matches_the_kernel(card, d):
    """The wrapper's parts have the row stride the C entry assumes."""
    from repro_torch.kernels import assign_stats as ak

    assert ak._lib("assign_stats").assign_stats_split_stride(d) == ak.split_stride(d)


def test_bf16_assign_stats_holds_no_f32_copy_of_x(card):
    """At the 1 GB shape (n = 250,000, d = 2,048, k = 50) a bf16 pass through
    ops.assign_stats allocates less than n * d * 2 bytes above what was
    allocated before it: no f32 copy of x (n * d * 4) is made."""
    n, d, k = 250_000, 2048, 50
    g = torch.Generator(device=card).manual_seed(0)
    x = torch.nn.functional.normalize(torch.rand((n, d), generator=g, device=card), dim=1)
    x = x.bfloat16()
    centers = x[:k].float()
    ops.assign_stats(x, centers)  # the build and the fold's workspace
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    st = ops.assign_stats(x, centers)
    torch.cuda.synchronize()
    assert ops.launch_counts()["assign_stats"] == 1
    assert torch.cuda.max_memory_allocated() - base < n * d * 2
    assert st.sums.dtype == torch.float32 and int(st.counts.sum()) == n


def test_bf16_rows_refused_where_not_ported(card):
    """Only f32 and bf16 rows are ported: f16 and f64 rows, a bf16 row
    matrix beside an f32 one in sim_best_edge, and f32 rows with bf16
    centers in assign_stats, assign_argmax and assign_stats_bounded raise
    TypeError in every wrapper."""
    rng = np.random.default_rng(5)
    x = _bf16_rows(rng, (64, 40), card)
    lab = interop.labels(rng.integers(0, 3, size=64), card)
    b = ops.bounds_identity(64, card)
    zero = torch.zeros((4,), device=card)
    with pytest.raises(TypeError):
        sim_best_edge_cuda(x, x.float(), lab, lab)
    cb = x[:4].contiguous()
    for call in (lambda: assign_stats_cuda(x.float(), cb),  # f32 rows take f32 centers only
                 lambda: assign_argmax_cuda(x.float(), cb),
                 lambda: assign_stats_bounded_cuda(x.float(), cb, b.idx, b.lo, b.hi, zero)):
        with pytest.raises(TypeError):
            call()
    for dtype in (torch.float16, torch.float64):
        xd = x.to(dtype)
        cd = xd[:4].contiguous()
        for call in (lambda: sim_best_edge_cuda(xd, xd, lab, lab),
                     lambda: label_stats_cuda(xd, lab, 3),
                     lambda: assign_stats_cuda(xd, cd),
                     lambda: assign_stats_cuda(x, cd),
                     lambda: assign_argmax_cuda(xd, cd),
                     lambda: assign_argmax_cuda(x, cd),
                     lambda: assign_stats_bounded_cuda(xd, cd, b.idx, b.lo, b.hi, zero),
                     lambda: assign_stats_bounded_cuda(x, cd, b.idx, b.lo, b.hi, zero),
                     lambda: best_edge_cuda(xd, lab, lab[:40].contiguous())):
            with pytest.raises(TypeError):
                call()


# ------------------------------------------- bf16 rows: the two-pass and bounded routes
#
# assign_argmax and assign_stats_bounded on bf16 x run the tile of
# assign_stats' bf16 pass: assign_argmax has its bits (idx, best_sim), and
# the bounded pass equals it on every output but hi and the carry for any
# bounds state. Both hold only if the tensor cores give a product the same
# bits whatever the tile's width N and wherever the row and column sit: the
# width probe checks that first. best_edge reads a bf16 block as it lies.


@pytest.mark.parametrize("centers_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [130, 2048])
def test_bf16_tile_width_probe(card, d, centers_dtype):
    """One bf16 row by one center gives the same bits at every computed
    width N of the tile (k = 1 .. 16: N = 16, 17 .. 32: 32, 33 .. 64: 64,
    more: 128 a tile) and at every column of it: each probe center sits
    alone among zero centers (similarity 0 < its own), at the first and the
    last column of each width and inside the second 128-column tile."""
    rng = np.random.default_rng(d + (centers_dtype == torch.float32))
    x = torch.nn.functional.normalize(
        torch.from_numpy(np.abs(rng.normal(size=(300, d))).astype(np.float32)), dim=1).to(card)
    x = x.bfloat16()
    probes = torch.nn.functional.normalize(
        torch.from_numpy(np.abs(rng.normal(size=(3, d))).astype(np.float32)), dim=1).to(card)
    probes = probes.to(centers_dtype)
    if centers_dtype == torch.float32:
        _three_parts(probes)
    for q in range(probes.shape[0]):
        want = None
        for k, j in ((1, 0), (16, 15), (17, 0), (32, 31), (33, 5), (64, 63), (65, 64),
                     (128, 127), (129, 128), (300, 255), (300, 299)):
            centers = torch.zeros((k, d), dtype=centers_dtype, device=card)
            centers[j] = probes[q]
            idx, sim = assign_argmax_cuda(x, centers)
            assert (idx == j).all(), (k, j)
            if want is None:
                want = sim
            _same_bits((sim,), (want,))
            _same_bits((sim,), (assign_stats_cuda(x, centers)[1],))


def bf16_argmax_gate(gate, x, centers):
    """Gate ``gate`` (with (c)) of assign_argmax on bf16 x against its f32
    mode on the upcast inputs, and its bits against assign_stats' bf16
    pass. Returns (max |best_sim - the f32 mode's|, near-tie index
    differences)."""
    xf, cf = x.float(), centers.float()
    got = _twice(assign_argmax_cuda, x, centers)
    _same_bits(got, assign_stats_cuda(x, centers)[:2])
    if gate == "integer":
        _same_bits(got, assign_argmax_cuda(xf, cf))
        return 0.0, 0
    if gate == "rows_at":
        for shift in ROW_SHIFTS:
            moved = assign_argmax_cuda(_shifted(x, shift), centers)
            _same_bits((moved[0][shift:], moved[1][shift:]), got)
        return 0.0, 0
    assert gate == "unit", gate
    want = assign_argmax_cuda(xf, cf)
    ties = _near_ties("assign_argmax bf16", got[0], want[0], want[1],
                      lambda rows, cols: (xf[rows] * cf[cols]).sum(1))
    return _close("assign_argmax bf16 best_sim", got[1], want[1], 0.0, SIM_TOL), ties


@pytest.mark.parametrize("gate", BF16_STATS_GATES)
@pytest.mark.parametrize("centers_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,k,d,offset", BF16_STATS_CASES)
def test_bf16_assign_argmax_equals_f32_mode(card, n, k, d, offset, centers_dtype, gate):
    """assign_argmax on bf16 x (bf16 centers, or f32 ones with all three
    split parts in use) under gate (a), (b) or (e), each with (c), and bit
    for bit equal to assign_stats' bf16 pass on the same inputs."""
    rng = np.random.default_rng(n + k + d + offset + 3)
    rows = _bf16_ints if gate == "integer" else _bf16_rows
    x = rows(rng, (n, d), card, offset)
    if centers_dtype == torch.float32:
        centers = (_split_exact_rows if gate == "integer" else _unit_rows)(rng, (k, d), card)
        _three_parts(centers)
    else:
        centers = rows(rng, (k, d), card)
    if k > 65:
        centers[65] = centers[1]  # a tie across center tiles
    bf16_argmax_gate(gate, x, centers)


# (n, k, d, offset) around assign_argmax's own bf16 plan (kernels/
# assign_argmax.py tile_plan): the last center tile narrowed to 16 (k = 129,
# 144, 400), 32 (800) or 64 (1,600) columns, computed in the block of the
# tile before it for bf16 centers; n off the row tiles of 128 and 192 rows
# (n = 1, 129, 257, 1,000, 3,000); d = 96, 130 and 40 and bases off 16
# bytes, which the copy engine does not take.
ARGMAX_PLAN_CASES = [(1, 129, 2048, 0), (129, 144, 96, 0), (257, 400, 130, 0),
                     (1000, 400, 2048, 1), (3000, 800, 2048, 0), (257, 800, 40, 37),
                     (1000, 1600, 96, 0), (129, 1600, 2048, 0), (3000, 400, 40, 0),
                     (1000, 144, 2048, 37)]


@pytest.mark.parametrize("gate", BF16_STATS_GATES)
@pytest.mark.parametrize("centers_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,k,d,offset", ARGMAX_PLAN_CASES)
def test_bf16_assign_argmax_plan_equals_assign_stats(card, n, k, d, offset, centers_dtype, gate):
    """assign_argmax on bf16 x at its plan's seams under gate (a), (b) or
    (e), each with (c), and bit for bit equal to assign_stats' bf16 pass:
    center 128 = center 127, center 384 = center 1 (a tie across the
    narrowed last tile at k = 400), rows 128 and 192 = row 0 (one row in
    two row tiles of 128 rows, or of 192 for f32 centers' parts)."""
    rng = np.random.default_rng(n + k + d + offset + 4)
    rows = _bf16_ints if gate == "integer" else _bf16_rows
    x = rows(rng, (n, d), card, offset)
    if centers_dtype == torch.float32:
        centers = (_split_exact_rows if gate == "integer" else _unit_rows)(rng, (k, d), card)
        _three_parts(centers)
    else:
        centers = rows(rng, (k, d), card)
    centers[128] = centers[127]
    if k > 384:
        centers[384] = centers[1]
    for r in (128, 192):
        if n > r:
            x[r] = x[0]
    bf16_argmax_gate(gate, x, centers)


@pytest.mark.parametrize("centers_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [130, 2048])
def test_bf16_tile_width_probe_narrowed_tail(card, d, centers_dtype):
    """The width probe at k = 128 t + r: one bf16 row by one center has the
    bits of the one-tile call (k = 1) at the first and the last column of a
    narrowed last tile (16, 32 or 64 wide; with bf16 centers of 16 or 32
    computed beside the tile before it) and in the full tile before it, and
    equals assign_stats' bf16 pass there."""
    rng = np.random.default_rng(d + 2 * (centers_dtype == torch.float32) + 5)
    x = torch.nn.functional.normalize(
        torch.from_numpy(np.abs(rng.normal(size=(300, d))).astype(np.float32)), dim=1).to(card)
    x = x.bfloat16()
    probes = torch.nn.functional.normalize(
        torch.from_numpy(np.abs(rng.normal(size=(3, d))).astype(np.float32)), dim=1).to(card)
    probes = probes.to(centers_dtype)
    if centers_dtype == torch.float32:
        _three_parts(probes)
    for q in range(probes.shape[0]):
        one = torch.zeros((1, d), dtype=centers_dtype, device=card)
        one[0] = probes[q]
        want = assign_argmax_cuda(x, one)[1]
        for t in (1, 2, 3, 6):
            for r in (1, 16, 17, 32, 33, 64):
                k = 128 * t + r
                for j in (128 * t, k - 1, 128 * t - 1):
                    centers = torch.zeros((k, d), dtype=centers_dtype, device=card)
                    centers[j] = probes[q]
                    idx, sim = assign_argmax_cuda(x, centers)
                    assert (idx == j).all(), (k, j)
                    _same_bits((sim,), (want,))
                    _same_bits((sim,), (assign_stats_cuda(x, centers)[1],))


def bounded_case(rng, n, k, d, card, centers_dtype, kind, offset=0):
    """Rows near their centers, so carried bounds prune: integer rows
    (entries in {-4, ..., 5}) near integer centers, or unit rows 0.1 off
    unit centers; in bf16, at ``offset`` elements into their allocation.
    Equal centers on both sides of every 64-center slab edge, the last
    center equal to the first (an empty cluster), weights 0-2. f32 centers
    of unit rows carry all three split parts."""
    lab = rng.integers(0, k, size=n)
    if kind == "integer":
        c = rng.integers(-4, 5, size=(k, d)).astype(np.float32)
    else:
        c = rng.normal(size=(k, d)).astype(np.float32)
        c /= np.linalg.norm(c, axis=1, keepdims=True)
    for b in range(64, k, 64):
        c[b] = c[b - 1]
    if k > 1:
        c[k - 1] = c[0]
    if kind == "integer":
        x = c[lab] + rng.integers(-1, 2, size=(n, d))
    else:
        x = c[lab] + 0.1 * rng.normal(size=(n, d)) / np.sqrt(d)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    x = _at_offset(interop.data(x, card).bfloat16(), offset)
    centers = interop.data(c, card)
    centers = centers.bfloat16() if centers_dtype == torch.bfloat16 else centers
    return x, centers, _ints(rng, (n,), 0, 2, card)


def check_bounded_bf16(x, centers, bounds, drift, w, perm=None):
    """The bounded bf16 pass against assign_stats' bf16 pass on the same
    inputs: every output but hi and the carry bit for bit; hi an upper bound
    on the exact second value (the plain version's full sweep of the upcast
    inputs), less the bf16 sums' SIM_TOL. Returns the bounded pass's
    outputs."""
    got = _twice(lambda: assign_stats_bounded_cuda(x, centers, *bounds, drift, w, perm=perm))
    _same_bits(got[:6], assign_stats_cuda(x, centers, w))
    _same_bits(got[6:8], got[:2])  # the carry: idx, lo = best_sim
    exact = ref.assign_stats_bounded(x.float(), centers.float(),
                                     *ops.bounds_identity(x.shape[0], x.device), drift, w)[8]
    assert (got[8] >= exact - SIM_TOL - 1e-5 * exact.abs()).all()
    return got


BOUNDED_K = (1, 16, 17, 63, 64, 65, 128, 129, 400, 800)
# (n, d, offset): odd d, d off 8 and 32 (plain stores), a base off 16
# bytes, n off the 128-row block
BOUNDED_SHAPES = [(300, 257, 0), (1000, 130, 0), (129, 40, 1), (1000, 2048, 1), (127, 96, 0)]


@pytest.mark.parametrize("kind", ["integer", "unit"])
@pytest.mark.parametrize("centers_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,d,offset", BOUNDED_SHAPES)
def test_bf16_bounded_equals_unbounded(card, n, d, offset, centers_dtype, kind):
    """The bounded pass on bf16 x equals assign_stats' bf16 pass on every
    output but hi and the carry, bit for bit, for every k of BOUNDED_K:
    under the sentinel bounds; under the bounds it carries after two
    centers move (settled rows take their similarity from the row pass's
    diagonal); with every fifth row invalidated; and in a slab order that
    puts duplicate centers on either side of slab edges (the center
    index). Integer rows also equal the plain version on the upcast
    inputs."""
    rng = np.random.default_rng(n + d + offset + (kind == "unit") + 2 * (
        centers_dtype == torch.float32))
    for k in BOUNDED_K:
        x, centers, w = bounded_case(rng, n, k, d, card, centers_dtype, kind, offset)
        zero = torch.zeros((k,), device=card)
        b0 = ops.bounds_identity(n, card)
        first = check_bounded_bf16(x, centers, b0, zero, w)
        assert not first[9].any()
        if kind == "integer":
            want = ref.assign_stats_bounded(x.float(), centers.float(), *b0, zero, w)
            _check_bounded(first, want, k)
        moved = centers.clone()
        moved[0, 0] += 1 if kind == "integer" else 0.01
        moved[k // 2, d - 1] -= 1 if kind == "integer" else 0.01
        drift = torch.linalg.vector_norm(moved.float() - centers.float(), dim=1)
        stale = torch.zeros((n,), dtype=torch.bool, device=card)
        stale[::5] = True
        carried = ops.Bounds(first[6], first[7], first[8])
        for bounds in (carried, ops.bounds_invalidate(carried, stale)):
            for perm in (None, ops.build_center_index(moved).perm):
                got = check_bounded_bf16(x, moved, bounds, drift, w, perm)
                if k > 1:
                    assert got[9].any(), (k, "no row was pruned: the row pass went untested")
                assert not got[9][bounds.idx < 0].any()


@pytest.mark.parametrize("centers_dtype", [torch.bfloat16, torch.float32])
def test_bf16_bounded_all_rows_pruned(card, centers_dtype):
    """A block whose rows are all settled sweeps nothing and still writes
    every row, on bf16 x."""
    rng = np.random.default_rng(9)
    c = 4 * np.eye(20, 24)
    x = c[rng.integers(0, 20, size=300)] + rng.integers(-1, 2, size=(300, 24))
    x = interop.data(x, card).bfloat16()
    centers = interop.data(c, card).to(centers_dtype)
    zero = torch.zeros((20,), device=card)
    first = check_bounded_bf16(x, centers, ops.bounds_identity(300, card), zero, None)
    again = check_bounded_bf16(x, centers, ops.Bounds(first[6], first[7], first[8]), zero, None)
    assert again[9].all()


# --------------------------------- bf16 bounded pass: the row pass and the compacted walk
#
# On bf16 x launch 1 is a row pass over blocks of 128 consecutive rows (only
# blocks holding a row with a carried center work; it gives the norms the
# deflation reads) and a walk over the active rows, listed in order and cut
# into blocks of 128, which sweeps slabs in pairs. Here the
# settled rows are chosen row by row: integer rows near integer centers
# whose gaps clear the margin, carried bounds from the plain version's full
# sweep (exact), so at zero drift every row is settled until invalidated.


def compact_case(rng, n, k, d, card, centers_dtype, offset=0):
    """bf16 integer rows (at ``offset`` elements into their allocation) near
    integer centers, weights 0-2, and the carried bounds of the plain full
    sweep: every row settles at zero drift."""
    c = rng.integers(-4, 5, size=(k, d)).astype(np.float32)
    x = c[rng.integers(0, k, size=n)] + rng.integers(-1, 2, size=(n, d))
    x = _at_offset(interop.data(x, card).bfloat16(), offset)
    centers = interop.data(c, card).to(centers_dtype)
    w = _ints(rng, (n,), 0, 2, card)
    full = ref.assign_stats_bounded(x.float(), centers.float(), *ops.bounds_identity(n, card),
                                    torch.zeros((k,), device=card), w)
    return x, centers, w, ops.Bounds(full[6], full[7], full[8])


def check_compacted(x, centers, w, bounds, drift, perm=None):
    """check_bounded_bf16, integer rows equal to the plain version (hi
    exact where pruned or k <= 64), and the blocks of launch 1 that worked:
    the row pass's = the 128-row blocks holding a row with a carried center,
    the walk's = ceil(active rows / 128). Returns the pass's outputs."""
    n, k = x.shape[0], centers.shape[0]
    got = check_bounded_bf16(x, centers, bounds, drift, w, perm)
    _check_bounded(got, ref.assign_stats_bounded(x.float(), centers.float(), *bounds, drift, w), k)
    nb = -(-n // 128)
    blocks = torch.zeros((2, nb), dtype=torch.int32, device=x.device)
    again = assign_stats_bounded_cuda(x, centers, *bounds, drift, w, perm=perm, blocks=blocks)
    _same_bits(again, got)
    carried = torch.nn.functional.pad((bounds.idx >= 0) & (bounds.idx < k), (0, nb * 128 - n))
    assert torch.equal(blocks[0].bool(), carried.view(nb, 128).any(1))
    active = n - int(got[9].sum())
    assert torch.equal(blocks[1].bool(), torch.arange(nb, device=x.device) < -(-active // 128))
    return got


COMPACT_PATTERNS = ["one_per_block", "active_128", "active_129", "runs_across_borders",
                    "all_active", "all_settled"]
# (n, d, offset): x by the copy engine and 16-byte gathers; d < 64 (plain
# stores, 16-byte gathers with zeros past d); d < 64 and a base off 16
# bytes (plain stores, 2-byte gathers); d off 8 (the same)
COMPACT_SHAPES = [(1000, 64, 0), (300, 40, 0), (300, 40, 1), (700, 130, 0)]


@pytest.mark.parametrize("pattern", COMPACT_PATTERNS)
@pytest.mark.parametrize("centers_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,d,offset", COMPACT_SHAPES)
def test_bf16_bounded_compacted_walk(card, n, d, offset, centers_dtype, pattern):
    """The bounded bf16 pass at BigK = 800 with the active rows laid out
    against the 128-row blocks: one per block, exactly 128 and 129 active
    rows at random, runs across block borders, all active, all settled;
    every output but hi equal to assign_stats' bf16 pass and (integer rows)
    to the plain version, the working blocks those the design asks for."""
    rng = np.random.default_rng(n + d + offset + COMPACT_PATTERNS.index(pattern) + 10 * (
        centers_dtype == torch.float32))
    k = 800
    x, centers, w, carried = compact_case(rng, n, k, d, card, centers_dtype, offset)
    stale = np.zeros(n, dtype=bool)
    if pattern == "one_per_block":
        stale[37::128] = True
    elif pattern in ("active_128", "active_129"):
        stale[rng.choice(n, int(pattern[-3:]), replace=False)] = True
    elif pattern == "runs_across_borders":
        for b in range(128, n + 128, 128):
            stale[max(0, b - 5):b + 3] = True
    elif pattern == "all_active":
        stale[:] = True
    stale = torch.from_numpy(stale).to(card)
    bounds = ops.bounds_invalidate(carried, stale)
    zero = torch.zeros((k,), device=card)
    for perm in (None, ops.build_center_index(centers.float()).perm):
        got = check_compacted(x, centers, w, bounds, zero, perm)
        assert torch.equal(got[9], ~stale)  # every row not invalidated is settled


@pytest.mark.parametrize("centers_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [1, 17, 64, 65, 129, 800, 4200])
def test_bf16_bounded_walk_pairs(card, k, centers_dtype):
    """The walk's pairs of slabs: one slab (k <= 64: hi exact), a pair
    (65), a last pair of one slab (129, 800), more than one chunk of 32
    slab directions (4,200: 66 slabs, the last chunk 2); under the sentinel
    (a full sweep), carried bounds after two centers move with every fifth
    row invalidated, and through the center index."""
    rng = np.random.default_rng(k + 2 * (centers_dtype == torch.float32))
    n, d = 300, 64
    x, centers, w, _ = compact_case(rng, n, k, d, card, centers_dtype)
    zero = torch.zeros((k,), device=card)
    first = check_compacted(x, centers, w, ops.bounds_identity(n, card), zero)
    assert not first[9].any()
    moved = centers.clone()
    moved[0, 0] += 1
    moved[k // 2, d - 1] -= 1
    drift = torch.linalg.vector_norm(moved.float() - centers.float(), dim=1)
    stale = torch.zeros((n,), dtype=torch.bool, device=card)
    stale[::5] = True
    bounds = ops.bounds_invalidate(ops.Bounds(first[6], first[7], first[8]), stale)
    for perm in (None, ops.build_center_index(moved.float()).perm):
        got = check_compacted(x, moved, w, bounds, drift, perm)
        if k > 1:
            assert got[9].any()
        assert not got[9][stale].any()


# (r, c): every alignment of a bf16 row start (c = 4,097 to 4,104), labels
# past what shared memory stages, rows around the persistent grid
BF16_BEST_EDGE_CASES = [(300, 270), (1, 129), (33, 1), (2000, 2000), (0, 5), (5, 0), (7, 4097),
                        (7, 4098), (7, 4099), (7, 4100), (7, 4101), (7, 4103), (7, 4104),
                        (5, 70_001), (131, 257), (20_000, 257)]


@pytest.mark.parametrize("r,c", BF16_BEST_EDGE_CASES)
def test_bf16_best_edge_equals_its_float(card, r, c):
    """best_edge on a bf16 block is torch.equal to the kernel on the block's
    float(): every alignment of a bf16 row start (c = 4,097 to 4,104), the
    labels past what shared memory stages, pad rows and columns (-1), ties
    from integer blocks, and one element past a 16-byte boundary."""
    rng = np.random.default_rng(r + c + 1)
    lr = interop.labels(rng.integers(-1, 5, size=r), card)
    lc = interop.labels(rng.integers(-1, 5, size=c), card)
    for sim in (_ints(rng, (r, c), -3, 3, card), interop.data(rng.normal(size=(r, c)), card)):
        sb = sim.bfloat16()
        got = _twice(best_edge_cuda, sb, lr, lc)
        _same_bits(got, best_edge_cuda(sb.float(), lr, lc))
        _equal(got, ref.best_edge(sb.float(), lr, lc))
        if r and c:
            _same_bits(best_edge_cuda(_at_offset(sb, 1), lr, lc), got)


def test_bf16_best_edge_nan_inf_and_ties(card):
    """NaN and -inf rows and signed zeros, as test_best_edge_ties_and_signed_zeros
    holds them in f32: the bf16 block gives the bits of its float()."""
    sim = torch.randn((5, 1003), generator=torch.Generator().manual_seed(5)).to(card)
    sim[0] = sim[1] = -torch.inf
    sim[1, 777] = -3.0e38  # a bf16 value below every other, above -inf
    sim[2:, 333] = sim[2:, 555] = torch.nan
    sim[4, :] = 0.0
    sim[4, 10] = -0.0
    sb = sim.bfloat16()
    lr = torch.tensor([0, 0, 0, -1, 0], dtype=torch.int32, device=card)
    lc = torch.ones((1003,), dtype=torch.int32, device=card)
    got, want = best_edge_cuda(sb, lr, lc), best_edge_cuda(sb.float(), lr, lc)
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0, equal_nan=True)
    assert got[0].tolist() == [0, 777, 333, -1, 0]


# best_edge on a bf16 block stages its column labels as int16 when every one
# fits (negative labels as -1), as their low and high halves up to
# BF16_STAGED_WIDE columns when one does not, and past that reads them from
# global memory; one int16 copy holds BF16_STAGED_NARROW columns.


def _bf16_best_edge_labels(rng, kind, r, c):
    """Row and column labels (numpy int64) of one kind: "narrow" (in [-1,
    32,767], the top of the int16 range included), "wide_one" (narrow but
    one column, and some rows, at 32,768), "wide" (labels 65,536 a + b: low
    halves shared across labels), "below" (negative labels down to -2^31),
    "row_wide" (int16 column labels; row labels past the int16 range whose
    low halves equal column labels), "wide_low" (column labels 65,536 + b
    beside row labels b)."""
    lr, lc = rng.integers(-1, 5, size=r), rng.integers(-1, 5, size=c)
    if kind == "narrow":
        lc[rng.integers(0, c, size=3)] = 32_767
        lr[::3] = 32_767
    elif kind == "wide_one":
        lc[rng.integers(0, c)] = 32_768
        lr[::3] = 32_768
    elif kind == "wide":
        lr = 65_536 * rng.integers(0, 3, size=r) + rng.integers(-1, 3, size=r)
        lc = 65_536 * rng.integers(0, 3, size=c) + rng.integers(-1, 3, size=c)
    elif kind == "below":
        pool = np.array([-2, -3, -32_768, -32_769, -65_536, -65_537, -(2**31)])
        lr = np.where(rng.random(r) < 0.3, rng.choice(pool, size=r), lr)
        lc = np.where(rng.random(c) < 0.3, rng.choice(pool, size=c), lc)
    elif kind == "row_wide":
        lr = rng.choice(np.array([32_768, 65_536, 65_537, 65_540, 2**31 - 1]), size=r)
    elif kind == "wide_low":
        lc = np.where(lc >= 0, lc + 65_536, lc)
    return lr, lc


def _check_bf16_best_edge(sb, lr, lc, offset=True):
    """The bf16 block's result, twice: the bits of the kernel on
    sb.float() (best_s as int32, so -0.0 and NaN payloads count), equal to
    ref.best_edge (NaN equal to NaN), and, at an offset of 1 element, the
    same again. Returns it."""
    def bits(a, b):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1].view(torch.int32),
                                                       b[1].view(torch.int32))

    got = best_edge_cuda(sb, lr, lc)
    bits(got, best_edge_cuda(sb, lr, lc))
    bits(got, best_edge_cuda(sb.float(), lr, lc))
    plain = ref.best_edge(sb.float(), lr, lc)
    assert torch.equal(got[0], plain[0])
    torch.testing.assert_close(got[1], plain[1], rtol=0, atol=0, equal_nan=True)
    if offset and sb.numel():
        bits(best_edge_cuda(_at_offset(sb, 1), lr, lc), got)
    return got


BF16_LABEL_KINDS = ["narrow", "wide_one", "wide", "below", "row_wide", "wide_low"]


@pytest.mark.parametrize("kind", BF16_LABEL_KINDS)
@pytest.mark.parametrize("c", range(4097, 4105))
def test_bf16_best_edge_label_ranges(card, c, kind):
    """Every row alignment of a bf16 block (c = 4,097 to 4,104, 9 rows)
    under each kind of labels, on integer and N(0, 1) blocks, with the
    column labels also at an offset of one int (staged one by one)."""
    r = 9
    rng = np.random.default_rng(c + 31 * BF16_LABEL_KINDS.index(kind))
    lr_np, lc_np = _bf16_best_edge_labels(rng, kind, r, c)
    lr, lc = interop.labels(lr_np, card), interop.labels(lc_np, card)
    for sim in (_ints(rng, (r, c), -3, 3, card), interop.data(rng.normal(size=(r, c)), card)):
        sb = sim.bfloat16()
        got = _check_bf16_best_edge(sb, lr, lc)
        _same_bits(best_edge_cuda(sb, lr, _at_offset(lc, 1)), got)


@pytest.mark.parametrize("kind", ["narrow", "wide"])
@pytest.mark.parametrize("c", [BF16_STAGED_WIDE, BF16_STAGED_WIDE + 1, BF16_STAGED_NARROW,
                               BF16_STAGED_NARROW + 1])
def test_bf16_best_edge_staged_limits(card, c, kind):
    """c just at and past what one block stages: two int16 copies (wide
    labels) and one (narrow), on 5 rows of N(0, 1) values with ties."""
    rng = np.random.default_rng(c + (kind == "wide"))
    lr_np, lc_np = _bf16_best_edge_labels(rng, kind, 5, c)
    sim = interop.data(rng.normal(size=(5, c)), card)
    sim[:, rng.integers(0, c, size=40)] = 4.0  # ties at the top
    _check_bf16_best_edge(sim.bfloat16(), interop.labels(lr_np, card),
                          interop.labels(lc_np, card))


def test_bf16_best_edge_masked_beside_neg_inf(card):
    """A masked column (f32.min) ranks above -inf candidates and below the
    lowest finite bf16 (-3.3895e38): rows of -inf with and without a masked
    column, with -3.39e38 candidates, a masked +5 and a masked NaN."""
    c = 37
    low = torch.tensor(-3.39e38).bfloat16().float().item()  # 0xff7f
    sim = torch.full((7, c), -torch.inf)
    lc = torch.zeros((c,), dtype=torch.int32)
    lc[[3, 20]] = 1
    lc[30] = -7  # a pad column: masked for every row
    lr = torch.tensor([1, 2, 1, 1, 2, 1, 2], dtype=torch.int32)
    # row 0: -inf candidates, masked 3, 20, 30 -> (-1, f32.min)
    # row 1: lc is 0 or 1, lr 2: every column but 30 a candidate -> masked
    #        30 is above the -inf ones -> (-1, f32.min)
    sim[2, 11] = low  # row 2: a -3.39e38 candidate beats the masked columns
    sim[3, [3, 20]] = 5.0  # row 3: masked +5 (label 1 = the row's) -> (-1, f32.min)
    sim[4, [9, 15]] = low  # row 4: two -3.39e38 candidates -> the first
    sim[5, 3] = torch.nan  # row 5: a masked NaN, a -3.39e38 candidate
    sim[5, 36] = low
    sim[6, 30] = torch.nan  # row 6: a NaN in the pad column only
    sb = sim.bfloat16().to(card)
    lr, lc = lr.to(card), lc.to(card)
    got = _check_bf16_best_edge(sb, lr, lc)
    assert got[0].tolist() == [-1, -1, 11, -1, 9, 36, -1]
    neg = torch.finfo(torch.float32).min
    assert got[1].tolist() == [neg, neg, low, neg, low, low, neg]
    # no masked column: every candidate -inf -> column 0 at -inf
    lc_all = torch.zeros((c,), dtype=torch.int32, device=card)
    row = torch.full((1, c), -torch.inf, device=card).bfloat16()
    got = _check_bf16_best_edge(row, torch.ones((1,), dtype=torch.int32, device=card), lc_all)
    assert got[0].tolist() == [0] and got[1].tolist() == [-torch.inf]


@pytest.mark.parametrize("c", [4097, 4100, 4104])
def test_bf16_best_edge_signed_zero_ties(card, c):
    """Rows whose maximum is 0 and whose first column at it is -0.0 (at a
    vector's first and last column, a head column, the row's last column):
    that column, with its sign; a bf16 subnormal above +0.0 wins over it."""
    pos = [0, 1, 7, 8, 9, 15, 16, 255, 256, 2049, c - 1]
    r = len(pos) + 1
    sim = torch.full((r, c), -1.0)
    for i, p in enumerate(pos):
        sim[i, p] = -0.0
        sim[i, p + 1:] = torch.where(torch.arange(p + 1, c) % 3 == 0, 0.0, -1.0)
    sim[-1, 5] = 0.0
    sim[-1, 3000] = 1e-40  # subnormal in bf16 too
    sb = sim.bfloat16().to(card)
    lab = torch.zeros((r,), dtype=torch.int32, device=card)
    lc = torch.ones((c,), dtype=torch.int32, device=card)
    got = _check_bf16_best_edge(sb, lab, lc)
    assert got[0].tolist() == pos + [3000]
    assert torch.signbit(got[1][:-1]).all() and got[1][-1].item() > 0


def test_bf16_best_edge_nan_in_vector_lanes(card):
    """NaN at the first and the last column of a 16-byte vector, in the first
    and the last lane of a batch, and two NaNs (the first wins); rows at
    every alignment by the offsets of _check_bf16_best_edge."""
    c = 4104
    sim = torch.randn((8, c), generator=torch.Generator().manual_seed(3))
    nans = [[0], [7], [8 * 31], [8 * 31 + 7], [8 * 128], [8 * 255 + 7, 8 * 256], [c - 1],
            [4000, 17]]
    for i, cols in enumerate(nans):
        sim[i, cols] = torch.nan
    sb = sim.bfloat16().to(card)
    lab = torch.zeros((8,), dtype=torch.int32, device=card)
    lc = torch.ones((c,), dtype=torch.int32, device=card)
    got = _check_bf16_best_edge(sb, lab, lc)
    assert got[0].tolist() == [cols[0] if i < 7 else 17 for i, cols in enumerate(nans)]
    assert torch.isnan(got[1]).all()


@pytest.mark.parametrize("kernel", ["assign_argmax", "assign_stats_bounded"])
def test_bf16_routes_hold_no_f32_copy_of_x(card, kernel):
    """At the 1 GB shape (n = 250,000, d = 2,048) one bf16 call of
    ops.assign_argmax (k = 400, f32 centers) or of ops.assign_stats_bounded
    (BigK = 800, sentinel bounds and the center index) raises the peak
    device memory by less than n * d * 2 bytes: no f32 copy of x."""
    n, d = 250_000, 2048
    k = 400 if kernel == "assign_argmax" else 800
    g = torch.Generator(device=card).manual_seed(1)
    x = torch.nn.functional.normalize(torch.rand((n, d), generator=g, device=card), dim=1)
    x = x.bfloat16()
    centers = x[:k].float()

    def call():
        if kernel == "assign_argmax":
            return ops.assign_argmax(x, centers)
        return ops.assign_stats_bounded(x, centers, ops.bounds_identity(n, card),
                                        torch.zeros((k,), device=card), index=index)

    index = ops.build_center_index(centers)
    call()  # the build and the fold's workspace
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    out = call()
    torch.cuda.synchronize()
    assert ops.bf16_launch_counts()[kernel] == 1
    assert torch.cuda.max_memory_allocated() - base < n * d * 2
    assert out[1].dtype == torch.float32 and out[1].shape == (n,)


def test_bf16_bkc_and_kmeans_routes_on_card(card):
    """bf16 documents through BKC's three routes and K-Means' three routes
    on the card: the routes equal each other bit for bit (every similarity
    is the one tile's, every sum the one fold's), launches on bf16 rows
    counted, and the card agrees with the port's plain path on the CPU on
    the same bf16 rows (agreement >= 99.9 %, RSS within 1e-4)."""
    from repro_torch.core.bkc import bkc_fit
    from repro_torch.core.kmeans import kmeans_fit

    x = _loose_blobs(1500, 96, 8, 5).bfloat16()
    init = x[interop.index(np.random.default_rng(3).choice(1500, 80, replace=False), "cpu")]
    xc, ic = x.to(card), init.to(card)
    want = bkc_fit(x, init, 80, 8)
    ops.reset_launch_counts()
    got = {name: bkc_fit(xc, ic, 80, 8, **kw) for name, kw in (
        ("fused", {}), ("two_pass", {"fused": False}), ("bounded", {"bounded": True}))}
    on_bf16 = ops.bf16_launch_counts()
    assert on_bf16["assign_argmax"] >= 2 and on_bf16["assign_stats_bounded"] == 2
    for res in got.values():
        for field in ("group_of_mc", "assignment", "threshold", "centers", "best_sim"):
            assert torch.equal(getattr(res, field), getattr(got["fused"], field)), field
    res = got["two_pass"]
    assert (res.assignment.cpu() == want.assignment).float().mean() >= 0.999
    torch.testing.assert_close(res.rss.cpu(), want.rss, rtol=1e-4, atol=0)

    kinit = x[:8].float()
    kwant = kmeans_fit(x, kinit, 8, tol=0.0)
    runs = {name: kmeans_fit(xc, kinit.to(card), 8, tol=0.0, **kw) for name, kw in (
        ("fused", {}), ("two_pass", {"fused": False}), ("bounded", {"bounded": True}))}
    for res in runs.values():
        assert torch.equal(res.assignment, runs["fused"].assignment)
        assert torch.equal(res.centers, runs["fused"].centers)
        assert res.iterations == runs["fused"].iterations
    assert (runs["bounded"].assignment.cpu() == kwant.assignment).float().mean() >= 0.999
    torch.testing.assert_close(runs["bounded"].rss.cpu(), kwant.rss, rtol=1e-4, atol=0)


def test_bf16_buckshot_card_matches_cpu(card):
    """bf16 documents through buckshot_fit on the card (the three kernels
    launch) against the port's plain path on the CPU on the same bf16 rows:
    the smoke's end-to-end rule, agreement >= 99.9 % and RSS within 1e-4."""
    from repro_torch.core.buckshot import buckshot_fit
    from repro_torch.text import pipeline, synth

    corpus = synth.make_corpus(1200, vocab=256, n_topics=6, seed=11)
    x, _ = pipeline.prepare_local(corpus, device="cpu")
    x = x.bfloat16()
    sidx = interop.index(np.random.default_rng(0).choice(1200, 85, replace=False), "cpu")
    want = buckshot_fit(x, sidx, 6)
    ops.reset_launch_counts()
    got = buckshot_fit(x.to(card), sidx.to(card), 6)
    counts = ops.launch_counts()
    assert counts["sim_best_edge"] >= 1 and counts["label_stats"] == 1
    assert counts["assign_stats"] == got.kmeans.iterations + 1
    assert ops.bf16_launch_counts() == {name: counts[name] for name in ops.bf16_launch_counts()}
    agree = (got.kmeans.assignment.cpu() == want.kmeans.assignment).float().mean()
    assert agree >= 0.999
    torch.testing.assert_close(got.kmeans.rss.cpu(), want.kmeans.rss, rtol=1e-4, atol=0)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_boruvka_distributed_nccl_world_1_matches_resident(card, tmp_path, dtype):
    """World-size-1 NCCL group from a FileStore: every mode's expanded edges
    equal the resident boruvka_mst bit for bit on the card, on f32 rows and
    on bf16 rows (sim_best_edge's bf16 mode: the launches counted apart)."""
    import torch.distributed as dist

    from repro_torch.core.hac import boruvka_mst
    from repro_torch.distrib.hac_parallel import boruvka_mst_distributed
    from repro_torch.distrib.sharding import make_flat_mesh

    rng = np.random.default_rng(5)
    xs = interop.data(rng.normal(size=(500, 64)), card).to(dtype)
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
            launched = ops.launch_counts()["sim_best_edge"]
            assert launched > 0 and ops.bf16_launch_counts()["sim_best_edge"] == (
                launched if dtype == torch.bfloat16 else 0)
    finally:
        dist.destroy_process_group()


def test_cluster_fits_distributed_bf16_nccl_world_1_equal_single_device(card, tmp_path):
    """bf16 documents through kmeans_distributed (bf16 initial centers),
    bkc_distributed and buckshot_distributed (both phase-1 flavours), each
    bounded and not, over a NCCL group of one rank: labels, centers,
    iterations, and BKC's groups and threshold equal the single-device bf16
    fits on the card; the sampled rows are bf16 and equal x[ids]; the four
    row kernels launch on bf16 rows."""
    import torch.distributed as dist

    from repro_torch.core.bkc import bkc_fit
    from repro_torch.core.buckshot import buckshot_fit
    from repro_torch.core.kmeans import kmeans_fit
    from repro_torch.distrib import cluster as dc
    from repro_torch.distrib.sharding import make_flat_mesh

    n, k, big_k, s, seed = 1500, 8, 80, 110, 4
    x = _loose_blobs(n, 96, k, 5).bfloat16().to(card)
    w = torch.ones(n, device=card)
    pick = interop.index(np.random.default_rng(3).choice(n, big_k, replace=False), card)
    init = x[pick]
    seen = []
    group_centers = dc._group_centers

    def capture(mc, kk):  # bkc_distributed's groups and threshold
        seen.append(group_centers(mc, kk))
        return seen[-1]

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        mesh, axes = make_flat_mesh(), ("data",)
        ops.reset_launch_counts()
        for bounded in (False, True):
            got = dc.kmeans_distributed(mesh, axes, x, w, init[:k], k, bounded=bounded)
            want = kmeans_fit(x, init[:k], k, bounded=bounded)
            assert torch.equal(got.assignment, want.assignment)
            assert torch.equal(got.centers, want.centers)
            assert got.iterations == want.iterations and got.centers.dtype == torch.float32
            torch.testing.assert_close(got.rss, want.rss, rtol=1e-6, atol=0)

            seen.clear()
            dc._group_centers = capture
            try:
                got = dc.bkc_distributed(mesh, axes, x, w, init, big_k, k, bounded=bounded)
            finally:
                dc._group_centers = group_centers
            want = bkc_fit(x, init, big_k, k, bounded=bounded)
            _, groups, threshold = seen[0]
            assert torch.equal(groups, want.group_of_mc)
            assert torch.equal(threshold, want.threshold)
            assert torch.equal(got.assignment, want.assignment)
            assert torch.equal(got.centers, want.centers)

            ids = dc.sample_indices_distributed(mesh, axes, w, s, seed).long()
            rows = dc.sample_rows_distributed(mesh, axes, x, w, s, seed)
            assert rows.dtype == torch.bfloat16
            assert torch.equal(rows.view(torch.int16), x[ids].view(torch.int16))
            want = buckshot_fit(x, ids, k, bounded=bounded)
            for hac in ("replicated", "boruvka"):
                got = dc.buckshot_distributed(mesh, axes, x, w, k, seed, sample_size=s,
                                              hac=hac, bounded=bounded)
                assert torch.equal(got.assignment, want.kmeans.assignment), hac
                assert torch.equal(got.centers, want.kmeans.centers), hac
                torch.testing.assert_close(got.rss, want.kmeans.rss, rtol=1e-5, atol=0)
        on_bf16 = ops.bf16_launch_counts()
        for name in ("sim_best_edge", "label_stats", "assign_stats", "assign_stats_bounded"):
            assert on_bf16[name] > 0, on_bf16
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
    size = ak.partials_size("label_stats", n, k, d, chunks, x.dtype == torch.bfloat16)
    part = torch.empty((size,), dtype=torch.float32, device=x.device)
    sums = torch.empty((k, d), dtype=torch.float32, device=x.device)
    counts = torch.empty((k,), dtype=torch.float32, device=x.device)
    err = lib.label_stats(
        x.data_ptr(), _build.ELEM[x.dtype], idx.data_ptr(), None if w is None else w.data_ptr(),
        n, d, k, chunks,
        part.data_ptr(), part.data_ptr() + 4 * chunks * k * d, sums.data_ptr(),
        counts.data_ptr(), _build.stream(x),
    )
    _build.check(err, "label_stats_delay")
    return sums, counts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("k", [1000, 2000, 4200])  # label tiles of 1,000-1,050: 3 stages (f32)
@pytest.mark.parametrize("weighted", [False, True])
def test_label_stats_sorters_with_later_stages_landing_first(card, k, weighted, dtype):
    """Each sorter warp must wait on every phase of the ring slots it owns:
    with a three-stage ring a sorter that took alternate stages would find
    a later stage's copies landed and read a slot whose copies had not.
    The debug build lands them in that order on every odd stage; on bf16
    rows (the bf16 route: no sorter warps, four stages here) the consumers
    must likewise wait on each slot's own phase."""
    rng = np.random.default_rng(k + weighted)
    n, d = 60_000, 256
    x = _ints(rng, (n, d), -3, 3, card).to(dtype)
    idx = interop.labels(rng.integers(-1, k + 1, size=n), card)
    w = _ints(rng, (n,), 0, 2, card) if weighted else None
    want = ref.label_stats(x, idx, k, w)
    for _ in range(2):
        _equal(_label_stats_delayed(x, idx, k, w), want)


# ------------------------------------------------------ the fold's order of adds


def _fold_bits_equal(name, got, want):
    assert got.dtype == want.dtype and got.shape == want.shape, name
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (
        f"{name}: {int((got.view(torch.int32) != want.view(torch.int32)).sum())} elements differ")


def _fold_chunks(name, n, k, d):
    from repro_torch.kernels import assign_stats as ak

    return ak._chunks(name, n, k, d, torch.cuda.current_device())


def _assign_stats_with_rowsq(x, centers, w):
    """assign_stats_cuda through its C entry, also returning the row norms
    launch 1 hands the fold (the wrapper keeps them to itself)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import assign_stats as ak

    n, d = x.shape
    k = centers.shape[0]
    dev = x.device
    lib = _build.library("assign_stats", ak._SIGNATURES["assign_stats"])
    chunks = _fold_chunks("assign_stats", n, k, d)
    part = torch.empty((ak.partials_size("assign_stats", n, k, d, chunks,
                                         x.dtype == torch.bfloat16),), device=dev)
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    best, rowsq = (torch.empty((n,), device=dev) for _ in range(2))
    sums = torch.empty((k, d), device=dev)
    counts, min_sim, sumsq = (torch.empty((k,), device=dev) for _ in range(3))
    tile = torch.empty((n * lib.assign_stats_scratch(k),), device=dev)
    c, celem = ak.center_operand(x, centers)
    err = lib.assign_stats(
        x.data_ptr(), c.data_ptr(), _build.ELEM[x.dtype], celem,
        None if w is None else w.data_ptr(), n, d, k, chunks, idx.data_ptr(), best.data_ptr(),
        rowsq.data_ptr(), part.data_ptr(), part.data_ptr() + 4 * chunks * k * d,
        tile.data_ptr() or None, sums.data_ptr(), counts.data_ptr(), min_sim.data_ptr(),
        sumsq.data_ptr(), _build.stream(x),
    )
    _build.check(err, "assign_stats")
    return (idx, best, sums, counts, min_sim, sumsq), rowsq, chunks


# (n, k, d, offset): n across the 128- and 256-row stages and the chunk
# borders ("border": the last chunk one row long, "border-1": one row
# short), label tiles (k = 1,600 on f32), d with odd column tiles and off
# the copy engine (d = 31), x 1 or 37 elements into its allocation; from
# 65,536 rows the bf16 route deals the labels to its warps by a sample (per
# label tile: k = 2,000 has two in both modes)
FOLD_ORDER_CASES = [(255, 50, 2048, 0), (256, 50, 2048, 1), (257, 800, 2048, 0),
                    ("border", 50, 2048, 0), ("border-1", 800, 2048, 37),
                    ("border", 800, 96, 0), ("border-1", 1, 130, 0), (3000, 1, 31, 0),
                    (4097, 1600, 130, 0), (2000, 1600, 96, 37), (5000, 50, 31, 1),
                    (6000, 800, 130, 1), (70_000, 800, 96, 0), (100_000, 50, 64, 1),
                    (70_000, 2000, 64, 0)]


def _fold_rows(case_n, name, k, d):
    """n of a case: as given, or placed on a chunk border of the card's plan
    at 40,000 rows (the chunk count is the card's for the n returned)."""
    if isinstance(case_n, int):
        return case_n
    n0 = 40_000
    c = _fold_chunks(name, n0, k, d)
    r = ref.fold_rows_per_chunk(n0, c)
    return (c - 1) * r + 1 if case_n == "border" else c * r - 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["label_stats", "assign_stats"])
@pytest.mark.parametrize("n,k,d,offset", FOLD_ORDER_CASES)
def test_fold_equals_its_in_order_model(card, n, k, d, offset, kernel, dtype):
    """The fold of label_stats and of assign_stats on float rows (unit rows,
    f32 or rounded to bf16; float weights with zeros and negatives; labels
    outside [0, k), a quarter of the rows in one cluster) equals
    ref.fold_in_order at the card's chunk count bit for bit: each label's
    rows of a chunk added in row order, the chunks in chunk order.
    assign_stats' fold is held on its own labels, best similarities and row
    norms."""
    rng = np.random.default_rng(zlib.crc32(repr((n, k, d, offset)).encode()))
    n = _fold_rows(n, kernel, k, d)
    x = _at_offset(_unit_rows(rng, (n, d), card).to(dtype), offset)
    w = torch.from_numpy(np.where(rng.random(n) < 0.1, 0.0, rng.uniform(-0.5, 2.0, n))
                         .astype(np.float32)).to(card)
    fields = ("sums", "counts", "sumsq", "min_sim")
    if kernel == "label_stats":
        lab = rng.integers(-2, k + 2, size=n)
        lab[rng.random(n) < 0.25] = min(1, k - 1)  # a large cluster: runs of one label
        idx = interop.labels(lab, card)
        chunks = _fold_chunks("label_stats", n, k, d)
        for wi in (w, None):
            got = label_stats_cuda(x, idx, k, wi)
            want = ref.fold_in_order(x, idx, k, chunks, wi)
            for name, g, v in zip(fields, got, want):
                _fold_bits_equal(f"label_stats {name} w={wi is not None}", g, v)
        return
    centers = _unit_rows(rng, (k, d), card)  # f32: split into three bf16 parts for bf16 x
    (idx, best, sums, counts, min_sim, sumsq), rowsq, chunks = _assign_stats_with_rowsq(
        x, centers, w)
    for name, g, v in zip(("idx", "best_sim", "sums", "counts", "min_sim", "sumsq"),
                          (idx, best, sums, counts, min_sim, sumsq),
                          assign_stats_cuda(x, centers, w)):
        _fold_bits_equal(f"assign_stats {name} through its C entry", g, v)
    want = ref.fold_in_order(x, idx, k, chunks, w, rowsq, best)
    for name, g, v in zip(fields, (sums, counts, sumsq, min_sim), want):
        _fold_bits_equal(f"assign_stats {name}", g, v)


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


# ------------------------------------------------------------------ LM training


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_loss_grads_on_card_match_the_cpu(card, arch):
    """loss_fn and its grads at REDUCED, the same weights and batch on the
    card and the CPU: the loss within rtol 1e-5, every stacked gradient leaf
    within 1e-4 of its max |g| (f32, no TF32)."""
    from repro_torch.models import transformer
    from repro_torch.models.common import leaves
    from repro_torch.models.registry import make_batch

    cfg, cpu = _lm(arch, "cpu", seed=8)
    _, gpu = _lm(arch, card, seed=8)
    batch = make_batch(cfg, 2, 24, torch.Generator().manual_seed(9), "cpu")
    out = []
    for lm, b in ((cpu, batch), (gpu, {k: v.to(card) for k, v in batch.items()})):
        bufs = transformer.grad_buffers(lm)
        loss, _ = transformer.loss_fn(lm, cfg, b)
        loss.backward()
        out.append((float(loss.detach()), [g.cpu() for _, g in leaves(bufs)]))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-5)
    for g, w in zip(out[1][1], out[0][1], strict=True):
        assert float((g - w).abs().max()) <= 1e-4 * max(float(w.abs().max()), 1e-30)


@pytest.mark.parametrize("grad_compress", [False, True])
def test_lm_train_step_on_card_matches_the_cpu(card, grad_compress):
    """Two train steps of qwen2 at REDUCED with grad_accum=2, on the card
    and the CPU from the same weights on the same batches, the default
    schedule (lr 3e-6 and 6e-6): losses within rtol 1e-5 and params within
    1e-5 absolute (the reference's own grad-accumulation bound; a gradient
    entry near 0 whose sign differs moves its param by at most 2 lr), m and
    v too without compression. With grad_compress an entry at a rounding
    boundary of the int8 grid may land one step of max|g| / 127 apart, so
    the moments are not compared there."""
    from repro_torch.models.common import leaves
    from repro_torch.train import data, optimizer
    from repro_torch.train.step import make_train_step

    cfg, cpu = _lm("qwen2-1.5b", "cpu", seed=10)
    cfg = cfg.replace(grad_accum=2)
    _, gpu = _lm("qwen2-1.5b", card, seed=10)
    dcfg = data.DataConfig(vocab=cfg.vocab, batch=4, seq=32, seed=3)
    fn = make_train_step(cfg, optimizer.AdamWConfig(), grad_compress=grad_compress)
    states = [optimizer.init(cpu.stacked), optimizer.init(gpu.stacked)]
    for step in range(2):
        m_c = fn(cpu, states[0], data.lm_batch(dcfg, step, "cpu"))[2]
        m_g = fn(gpu, states[1], data.lm_batch(dcfg, step, card))[2]
        np.testing.assert_allclose(float(m_g["loss"]), float(m_c["loss"]), rtol=1e-5)
    trees = [(gpu.stacked, cpu.stacked)]
    if not grad_compress:
        trees += [(states[1]["m"], states[0]["m"]), (states[1]["v"], states[0]["v"])]
    for tree_g, tree_c in trees:
        for (_, g), (_, w) in zip(leaves(tree_g), leaves(tree_c), strict=True):
            torch.testing.assert_close(g.cpu(), w, rtol=0, atol=1e-5)
    assert int(states[1]["step"]) == 2


def test_lm_policy_step_on_a_1x1_mesh_equals_the_plain_step(card, tmp_path):
    """Two qwen2 REDUCED steps (grad_accum 2) through the mesh policy on a
    1 x 1 NCCL mesh (DTensor params, ZeRO-1 moments, the batch placed, the
    step under ``policy_for``) and through the plain step, from the same
    weights on the same batches: losses, params, m and v torch.equal."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh, policy_for
    from repro_torch.launch.train import full_tree
    from repro_torch.models.common import leaves, place
    from repro_torch.models.registry import get_model
    from repro_torch.train import data, optimizer
    from repro_torch.train.step import make_train_step

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        policy = policy_for(make_debug_mesh((1, 1)))
        cfg, plain = _lm("qwen2-1.5b", card, seed=10)
        cfg = cfg.replace(grad_accum=2)
        model = get_model(cfg)
        placed = model.place_params(_lm("qwen2-1.5b", card, seed=10)[1], policy)
        dcfg = data.DataConfig(vocab=cfg.vocab, batch=4, seq=32, seed=3)
        f1 = make_train_step(cfg, optimizer.AdamWConfig())
        f2 = make_train_step(cfg, optimizer.AdamWConfig(), policy)
        s1, s2 = optimizer.init(plain.stacked), optimizer.init_placed(model._placed_recs(), policy)
        for step in range(2):
            b = data.lm_batch(dcfg, step, card)
            m1 = f1(plain, s1, b)[2]
            m2 = f2(placed, s2, {k: place(v, policy, ("dp", None)) for k, v in b.items()})[2]
            assert torch.equal(m1["loss"], m2["loss"])
        full = full_tree({"p": placed.stacked, "m": s2["m"], "v": s2["v"]})
        want = {"p": plain.stacked, "m": s1["m"], "v": s1["v"]}
        for (_, a), (_, b) in zip(leaves(want), leaves(full), strict=True):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()


def test_lm_train_resumes_bitwise_on_card(card, tmp_path):
    """train() on the card, preempted after a checkpoint and resumed: params
    and moments equal to an uninterrupted run's (torch.equal)."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import leaves
    from repro_torch.train.loop import train

    cfg = get_config("qwen2-1.5b", reduced=True)
    kw = dict(steps=6, batch=4, seq=32, log_every=0, seed=2, device=card)
    full = train(cfg, **kw)
    with pytest.raises(KeyboardInterrupt):
        train(cfg, ckpt_dir=str(tmp_path), ckpt_every=2, preempt_at=5, **kw)
    resumed = train(cfg, ckpt_dir=str(tmp_path), ckpt_every=2, **kw)
    assert resumed.resumed_from == 4 and resumed.losses == full.losses[4:]
    for a, b in ((full.params.stacked, resumed.params.stacked),
                 (full.opt_state["m"], resumed.opt_state["m"]),
                 (full.opt_state["v"], resumed.opt_state["v"])):
        for (_, x), (_, y) in zip(leaves(a), leaves(b), strict=True):
            assert torch.equal(x, y)


# ------------------------------------------- the reference's parameter-level modes


def margin_case(rng, n, k, d, card, rows):
    """Integer rows near integer centers (every similarity and sum exact, f32
    or bf16 rows), weights 0-2, and valid carried bounds whose gaps sit
    around the margins: the plain full sweep's, with lo lowered to hi + g,
    g in {5e-5, 5e-3, 0.5, 2}, where the row's gap allows it."""
    c = rng.integers(-4, 5, size=(k, d)).astype(np.float32)
    c[k - 1] = c[0]  # loses every tie to center 0: an empty cluster
    x = c[rng.integers(0, k, size=n)] + rng.integers(-1, 2, size=(n, d))
    x, centers = interop.data(x, card), interop.data(c, card)
    if rows == "bf16":
        x, centers = x.bfloat16(), centers.bfloat16()
    w = _ints(rng, (n,), 0, 2, card)
    full = ref.assign_stats_bounded(x.float(), centers.float(), *ops.bounds_identity(n, card),
                                    torch.zeros((k,), device=card), w)
    g = torch.tensor([5e-5, 5e-3, 0.5, 2.0], device=card)[
        torch.from_numpy(rng.integers(0, 4, size=n)).to(card)]
    lo = torch.where(full[7] - full[8] > 2 * g, full[8] + g, full[7])
    return x, centers, w, ops.Bounds(full[6], lo, full[8])


@pytest.mark.parametrize("margin", [0.0, 1e-2, float("inf")], ids=["0", "1e-2", "inf"])
@pytest.mark.parametrize("rows", ["f32", "bf16"])
@pytest.mark.parametrize("k", [17, 130, 800])
def test_bounded_margin_matches_plain(card, margin, rows, k):
    """The kernels take the plain version's margin: a row prunes when
    lo' > hi' + margin, a slab is swept for a row when its bound reaches the
    row's best - margin. Every output but hi equals the plain version's at
    the same margin (hi an upper bound, exact where pruned), and the labels
    and statistics equal assign_stats'; at inf nothing prunes, every slab is
    swept and all ten outputs equal the plain version's. In id order and
    through a center index."""
    rng = np.random.default_rng(k + 7 * (rows == "bf16"))
    n, d = 1000, 40
    x, centers, w, bounds = margin_case(rng, n, k, d, card, rows)
    zero = torch.zeros((k,), device=card)
    for perm in (None, ops.build_center_index(centers.float()).perm):
        got = _twice(lambda: assign_stats_bounded_cuda(x, centers, *bounds, zero, w, perm=perm,
                                                        margin=margin))
        want = ref.assign_stats_bounded(x.float(), centers.float(), *bounds, zero, w,
                                        margin=margin)
        _check_bounded(got, want, k)
        _same_bits(got[:6], assign_stats_cuda(x, centers, w))
        if margin == float("inf"):
            assert not got[9].any()
            _equal(got, want)
        else:
            assert got[9].any() and not got[9].all()


@pytest.mark.parametrize("iters", [0, 1, 3])
@pytest.mark.parametrize("groups", [1, 3, 8, "k", "k+5"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_build_center_index_groups_iters_on_the_kernels(card, groups, iters, dtype):
    """build_center_index(groups=, iters=) runs its mini-Lloyd on the card's
    assign_argmax (iters + 1 launches) and label_stats (iters): perm and
    group_of equal the plain version's (the same call on a CPU copy); at
    groups >= k the identity, with no launch."""
    rng = np.random.default_rng(11 + iters)
    k, d = 200, 48
    blobs = rng.normal(size=(12, d)) * 3.0
    c = blobs[rng.integers(0, 12, size=k)] + rng.normal(size=(k, d))
    c = torch.from_numpy((c / np.linalg.norm(c, axis=1, keepdims=True)).astype(np.float32))
    c = c.to(dtype)
    g = {"k": k, "k+5": k + 5}.get(groups, groups)
    ops.reset_launch_counts()
    got = ops.build_center_index(c.to(card), groups=g, iters=iters)
    counts = ops.launch_counts()
    want = ops.build_center_index(c, groups=g, iters=iters)
    assert torch.equal(got.perm.cpu(), want.perm)
    assert torch.equal(got.group_of.cpu(), want.group_of)
    launched = (0, 0) if g >= k else (iters + 1, iters)
    assert (counts["assign_argmax"], counts["label_stats"]) == launched
