"""The reference's parameter-level modes in the port, against the JAX package
on the CPU:

  * the bounded pass's ``margin`` (``ops.assign_stats_bounded`` and
    ``_chunked``) at 0, 1e-4 (the default), 1e-2 and inf, weighted and not:
    on rows of sixteenths, whose similarities and sums are exact in f32, the
    outputs equal the JAX package's XLA path at the same margin, the pruned
    masks too (a pruned row's deflated hi within 1e-6, as in
    ``test_torch_bounds.py``), with carried gaps placed around the margins;
    the masks shrink as the margin grows, and at inf
    nothing prunes and the pass equals ``assign_stats``;
  * ``build_center_index(groups=, iters=)``: ``perm`` and ``group_of`` equal
    the reference's for groups 1, 3, 8, k, k + 5 and iters 0, 1, 3;
  * ``boruvka_mst_distributed(check_every=)`` at 1, 2, 3 over four gloo
    ranks: the edges (compact and expanded) and the round count equal the
    reference's on four host devices (``prewarm=False``), and a snapshot
    taken under one ``check_every`` does not resume under another;
  * the elastic ``train.checkpoint.restore(shardings=)``: a small model's
    checkpoint written from a (4, 1) mesh and restored onto a (2, 2) one,
    every rank's shard equal to the reference's ``restore(shardings=)``
    shard at the same mesh coordinate, and the whole leaves equal to the
    plain restore.

The gloo ranks and the JAX subprocess start with the module's first test and
run beside the in-process ones.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch import interop
from repro_torch.kernels import ops, ref

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300  # seconds for each subprocess
S, D = 150, 16  # the Borůvka sample: 4 rounds at check_every 1 and 2, 6 at 3
CHECKS = (1, 2, 3)
STEP = 7  # the checkpoint's step
NAMES = ("idx", "best_sim", "sums", "counts", "min_sim", "sumsq", "b.idx", "lo", "hi", "pruned")
MARGINS = (0.0, ref.PRUNE_MARGIN, 1e-2, float("inf"))


def _env(**extra) -> dict:
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1", **extra}


def _exact_unit(rng, s, d=D):
    """(s, d) rows k / 8 with integer k in [-3, 3] and sum(k^2) = 64."""
    rows = []
    while len(rows) < s:
        k = rng.integers(-3, 4, size=(4 * s, d))
        rows.extend(k[(k * k).sum(1) == 64])
    return (np.asarray(rows[:s]) / 8).astype(np.float32)


def _params():
    """qwen2-1.5b at REDUCED with FSDP on (both mesh axes shard a leaf), drawn
    from a seed, as a flat {"a/b": array} dict."""
    from repro_torch import configs
    from repro_torch.models.common import leaves
    from repro_torch.models.registry import get_model

    cfg = configs.get_config("qwen2-1.5b", reduced=True).replace(fsdp=True)
    lm = get_model(cfg).init_params(torch.Generator().manual_seed(3), "cpu")
    return {"/".join(p): t.numpy() for p, t in leaves(lm.stacked)}


_UNFLAT = """
def unflat(z):
    out = {}
    for key in z.files:
        node, parts = out, key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = z[key]
    return out
"""

_RANK = textwrap.dedent("""
    import sys
    from pathlib import Path
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, tmp = int(sys.argv[1]), Path(sys.argv[2])
    dist.init_process_group("gloo", init_method=f"file://{tmp / 'init'}", rank=rank, world_size=4)
    from repro_torch import configs
    from repro_torch.distrib import hac_parallel as hp
    from repro_torch.distrib.sharding import make_flat_mesh
    from repro_torch.launch.mesh import make_debug_mesh, policy_for
    from repro_torch.launch.train import full_tree
    from repro_torch.models.common import leaves, place_tree
    from repro_torch.models.registry import get_model
    from repro_torch.resilience import MemoryCheckpointer
    from repro_torch.train import checkpoint as ckpt
    assert "jax" not in sys.modules and "repro" not in sys.modules
    """) + _UNFLAT + textwrap.dedent("""
    out = {}
    xs = torch.from_numpy(np.load(tmp / "xs.npy"))
    mesh = make_flat_mesh()
    for c in (1, 2, 3):
        for compact in (1, 0):
            e = hp.boruvka_mst_distributed(mesh, ("data",), xs, check_every=c, compact=bool(compact))
            for f in ("u", "v", "w", "valid"):
                out[f"bv/{c}/{compact}/{f}"] = getattr(e, f).numpy()
    # a snapshot taken under check_every=1 (the loop cut in its 4th round)
    # resumes under check_every=1 and is refused under 3 (a cold start)
    merge, rounds, cut = hp._merge_round_comp, [], []
    def counted(*a, **kw):
        rounds.append(1)
        if cut and len(rounds) == cut[0]:
            raise RuntimeError("cut")
        return merge(*a, **kw)
    hp._merge_round_comp = counted
    for resume in (1, 3):
        ck = MemoryCheckpointer()
        rounds.clear()
        cut[:] = [4]
        try:
            hp.boruvka_mst_distributed(mesh, ("data",), xs, check_every=1, checkpoint=ck)
            raise AssertionError("not cut")
        except RuntimeError as e:
            assert str(e) == "cut"
        rounds.clear()
        cut.clear()
        e = hp.boruvka_mst_distributed(mesh, ("data",), xs, check_every=resume, checkpoint=ck)
        out[f"resume/{resume}/rounds"] = np.asarray(len(rounds))
        for f in ("u", "v", "w", "valid"):
            out[f"resume/{resume}/{f}"] = getattr(e, f).numpy()
    hp._merge_round_comp = merge
    # the elastic restore: written from a (4, 1) mesh, restored onto (2, 2)
    cfg = configs.get_config("qwen2-1.5b", reduced=True).replace(fsdp=True)
    model = get_model(cfg)
    def tensors(t):
        return {k: tensors(v) for k, v in t.items()} if isinstance(t, dict) else torch.from_numpy(t)
    full = tensors(unflat(np.load(tmp / "params.npz")))
    written = full_tree(place_tree(full, model._placed_recs(), policy_for(make_debug_mesh((4, 1)))))
    if rank == 0:
        ckpt.save(str(tmp / "ck41"), 7, written)
    dist.barrier()
    p22 = policy_for(make_debug_mesh((2, 2)))
    got = ckpt.restore(str(tmp / "ck41"), 7, full, shardings=model.param_shardings(p22))
    plain, step = ckpt.restore_latest(str(tmp / "ck41"), full, "cpu")
    assert step == 7
    out["coord"] = np.asarray(p22.mesh.get_coordinate())
    for (path, g), (_, p) in zip(leaves(got), leaves(plain), strict=True):
        key = "/".join(path)
        assert torch.equal(g.full_tensor(), p), key
        out[f"rs/{key}"] = g.to_local().numpy()
        out[f"shape/{key}"] = np.asarray(p.shape)
    try:
        ckpt.restore(str(tmp / "ck41"), 7, full, "cpu", model.param_shardings(p22))
        raise AssertionError("device= and shardings= both taken")
    except ValueError:
        pass
    np.savez(tmp / f"rank{rank}.npz", **out)
    dist.destroy_process_group()
    """)

_JAX = _UNFLAT + textwrap.dedent("""
    import sys
    from pathlib import Path
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro import configs
    from repro.distrib.hac_parallel import boruvka_mst_distributed
    from repro.distrib.sharding import make_flat_mesh
    from repro.launch.mesh import make_debug_mesh, policy_for
    from repro.models.registry import get_model
    from repro.train import checkpoint as ckpt
    tmp = Path(sys.argv[1])
    out = {}
    xs = jnp.asarray(np.load(tmp / "xs.npy"))
    mesh = make_flat_mesh(4)
    for c in (1, 2, 3):
        for compact in (1, 0):
            e = boruvka_mst_distributed(mesh, ("data",), xs, check_every=c, compact=bool(compact),
                                        prewarm=False)
            for f in ("u", "v", "w", "valid"):
                out[f"bv/{c}/{compact}/{f}"] = np.asarray(getattr(e, f))
    cfg = configs.get_config("qwen2-1.5b", reduced=True).replace(fsdp=True)
    policy = policy_for(make_debug_mesh((2, 2)))
    like = unflat(np.load(tmp / "params.npz"))
    tree = ckpt.restore(str(tmp / "ck_whole"), 7, like,
                        shardings=get_model(cfg).param_shardings(policy))
    devs = np.asarray(policy.mesh.devices)
    where = {devs[i, j].id: (i, j) for i in range(2) for j in range(2)}
    for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(p.key for p in path)
        for sh in a.addressable_shards:
            i, j = where[sh.device.id]
            out[f"rs/{key}/{i}{j}"] = np.asarray(sh.data)
    np.savez(tmp / "jax.npz", **out)
    """)


@pytest.fixture(scope="module", autouse=True)
def _procs(tmp_path_factory):
    """Four gloo ranks and one JAX subprocess on four forced host devices,
    started before the module's first test. Output goes to files (a full
    pipe would block a rank)."""
    from repro_torch.train import checkpoint as ckpt

    tmp = tmp_path_factory.mktemp("modes")
    np.save(tmp / "xs.npy", _exact_unit(np.random.default_rng(zlib.crc32(b"modes")), S))
    flat = _params()
    np.savez(tmp / "params.npz", **flat)
    whole: dict = {}
    for key, a in flat.items():
        node, parts = whole, key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = a
    ckpt.save(str(tmp / "ck_whole"), STEP, whole)  # the reference's copy, from no mesh
    procs = {}

    def start(name, args, env):
        with open(tmp / f"{name}.log", "w") as log:
            procs[name] = subprocess.Popen([sys.executable, "-c", *args], env=env,
                                           stdout=log, stderr=subprocess.STDOUT, cwd=ROOT)

    try:
        start("jax", [_JAX, str(tmp)], _env(XLA_FLAGS="--xla_force_host_platform_device_count=4",
                                            JAX_PLATFORMS="cpu"))
        for r in range(4):
            start(f"rank{r}", [_RANK, str(r), str(tmp)], _env())
        yield tmp, procs
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def results(_procs):
    tmp, procs = _procs
    for name, p in procs.items():
        try:
            p.wait(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            pytest.fail(f"{name} did not finish in {TIMEOUT} s:\n{(tmp / f'{name}.log').read_text()}")
        assert p.returncode == 0, f"{name} failed:\n{(tmp / f'{name}.log').read_text()}"
    return {name: dict(np.load(tmp / f"{name}.npz")) for name in procs}


@pytest.fixture
def rng(request):
    name = f"{request.module.__name__}::{request.node.name}"
    return np.random.default_rng(zlib.crc32(name.encode()))


def _t(a):
    a = np.asarray(a)
    return interop.labels(a, "cpu") if a.dtype.kind in "iu" else interop.data(a, "cpu")


def _flat(st):
    return (st.idx, st.best_sim, st.sums, st.counts, st.min_sim, st.sumsq,
            st.bounds.idx, st.bounds.lo, st.bounds.hi, st.pruned)


# ------------------------------------------------------------------ margin


def _sixteenths(rng, n, k, d):
    """Centers of sixteenths in [-1/2, 1/2] and rows of sixteenths within
    1/8 of one of them: every similarity is a multiple of 1/256 below 2^3,
    exact in f32 in any order, so near-ties are exact ties (lowest index).
    Center k - 1 repeats center 0 (it never wins)."""
    c = rng.integers(-8, 9, size=(k, d)) / 16
    c[k - 1] = c[0]
    x = c[rng.integers(0, k - 1, size=n)] + rng.integers(-2, 3, size=(n, d)) / 16
    return x.astype(np.float32), c.astype(np.float32)


def _carried(x, c, rng, moved=True):
    """Valid carried bounds with gaps placed around the margins: a sentinel
    pass's (prev_idx the winner, lo its similarity, hi the second value),
    then lo lowered to hi + g where the row's gap allows it, g drawn from
    5e-5, 5e-3 and 0.5 (a lower lo is still a lower bound). ``moved`` adds
    a drift of a few 2^-16 steps to three centers, which deflates every
    row's gap a little."""
    n, k = x.shape[0], c.shape[0]
    first = jops.assign_stats_bounded(
        x, c, jops.bounds_identity(n), np.zeros(k, np.float32), impl="xla")
    idx, lo, hi = (np.asarray(a) for a in first.bounds)
    g = rng.choice(np.asarray([5e-5, 5e-3, 0.5], np.float32), size=n)
    lo = np.where(lo - hi > 2 * g, hi + g, lo).astype(np.float32)
    drift = np.zeros(k, np.float32)
    if moved:
        drift[rng.choice(k, 3, replace=False)] = rng.integers(1, 4, size=3) / 65536
    return (idx, lo, hi), drift


@pytest.mark.parametrize("chunked", [False, True], ids=["one_shot", "chunked"])
@pytest.mark.parametrize("weighted", [False, True], ids=["w_none", "w"])
@pytest.mark.parametrize("margin", MARGINS, ids=["0", "1e-4", "1e-2", "inf"])
def test_bounded_margin_matches_jax(rng, margin, weighted, chunked):
    """All ten outputs equal the JAX package's at the same margin (the
    pruned mask too); at inf nothing prunes and the pass is ``assign_stats``'."""
    n, k, d = 300, 17, 24
    x, c = _sixteenths(rng, n, k, d)
    bounds, drift = _carried(x, c, rng)
    w = rng.integers(0, 3, size=n).astype(np.float32) if weighted else None
    tw, jw = (None, None) if w is None else (_t(w), jnp.asarray(w))
    tb, jb = ops.Bounds(*map(_t, bounds)), jops.Bounds(*map(jnp.asarray, bounds))
    if chunked:
        got = ops.assign_stats_bounded_chunked(_t(x), _t(c), tb, _t(drift), tw, chunk=128,
                                               margin=margin)
        want = jops.assign_stats_bounded_chunked(x, c, jb, drift, jw, chunk=128, impl="xla",
                                                 margin=margin)
    else:
        got = ops.assign_stats_bounded(_t(x), _t(c), tb, _t(drift), tw, margin=margin)
        want = jops.assign_stats_bounded(x, c, jb, drift, jw, impl="xla", margin=margin)
    for name, g, wv in zip(NAMES, _flat(got), _flat(want)):
        if name == "hi":  # a pruned row's deflated hi: XLA may fuse its multiply-add
            np.testing.assert_allclose(interop.to_numpy(g), np.asarray(wv), rtol=1e-6,
                                       atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(interop.to_numpy(g), np.asarray(wv), err_msg=name)
    pruned = int(got.pruned.sum())
    if margin == float("inf"):
        assert pruned == 0
        full = ops.assign_stats(_t(x), _t(c), tw)
        for name, g, f in zip(NAMES, _flat(got), full):
            assert torch.equal(g, f), name
    else:
        assert pruned > 0


def test_bounded_margin_orders_the_pruned_masks(rng):
    """A wider margin prunes a subset of a narrower one's rows, strictly
    fewer at each step here: a gap of 5e-5 prunes at 0 only, 5e-3 at 0 and
    1e-4, 0.5 at every finite margin; nothing prunes at inf."""
    x, c = _sixteenths(rng, 300, 17, 24)
    bounds, drift = _carried(x, c, rng, moved=False)
    masks = [interop.to_numpy(ops.assign_stats_bounded(
        _t(x), _t(c), ops.Bounds(*map(_t, bounds)), _t(drift), margin=m).pruned) for m in MARGINS]
    for wide, narrow in zip(masks[1:], masks[:-1]):
        assert not (wide & ~narrow).any()
    counts = [int(m.sum()) for m in masks]
    assert counts[0] > counts[1] > counts[2] > counts[3] == 0, counts


# ------------------------------------------------------------- center index


@pytest.mark.parametrize("iters", [0, 1, 3])
@pytest.mark.parametrize("groups", [1, 3, 8, "k", "k+5"])
def test_build_center_index_groups_iters_match_jax(rng, groups, iters):
    """``perm`` and ``group_of`` equal the reference's: the stride start, the
    mini-Lloyd rounds, the (group, id) order, the identity at groups >= k."""
    k, d = 40, 16
    blobs = rng.normal(size=(6, d)) * 3.0
    c = blobs[rng.integers(0, 6, size=k)] + rng.normal(size=(k, d))
    c = (c / np.linalg.norm(c, axis=1, keepdims=True)).astype(np.float32)
    g = {"k": k, "k+5": k + 5}.get(groups, groups)
    got = ops.build_center_index(_t(c), groups=g, iters=iters)
    want = jops.build_center_index(jnp.asarray(c), groups=g, iters=iters, impl="xla")
    np.testing.assert_array_equal(interop.to_numpy(got.perm), np.asarray(want.perm))
    np.testing.assert_array_equal(interop.to_numpy(got.group_of), np.asarray(want.group_of))
    if g >= k:
        np.testing.assert_array_equal(interop.to_numpy(got.perm), np.arange(k))
    default = ops.build_center_index(_t(c))
    assert torch.equal(default.perm, ops.build_center_index(
        _t(c), groups=round(k ** 0.5), iters=ops.INDEX_LLOYD_ROUNDS).perm)


# ------------------------------------------------ Borůvka's check_every


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("check_every", CHECKS)
def test_boruvka_check_every_matches_jax(results, check_every):
    """Every rank's edges, compact and expanded, equal the reference's at the
    same ``check_every``; the expanded edges hold s slots a round, so their
    length gives the round count, which grows with ``check_every`` here."""
    want = results["jax"]
    for r in range(4):
        got = results[f"rank{r}"]
        for compact in (1, 0):
            for f in ("u", "v", "valid"):
                key = f"bv/{check_every}/{compact}/{f}"
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
            key = f"bv/{check_every}/{compact}/w"
            np.testing.assert_array_equal(_bits(got[key]), _bits(want[key]), err_msg=key)
    rounds = {c: want[f"bv/{c}/0/u"].shape[0] // S for c in CHECKS}
    assert results["rank0"][f"bv/{check_every}/0/u"].shape[0] == rounds[check_every] * S
    assert rounds[1] < rounds[3], rounds


def test_boruvka_snapshot_resumes_only_under_its_check_every(results):
    """Cut in round 4 under check_every=1: the snapshot of round 3 resumes
    under 1 (one round left to run), and under 3 it is refused, so the loop
    starts cold and runs every round; both give the uninterrupted edges."""
    want = results["jax"]
    n_rounds = want["bv/3/0/u"].shape[0] // S
    for r in range(4):
        got = results[f"rank{r}"]
        assert int(got["resume/1/rounds"]) == want["bv/1/0/u"].shape[0] // S - 3
        assert int(got["resume/3/rounds"]) == n_rounds
        for c in (1, 3):
            for f in ("u", "v", "valid"):
                np.testing.assert_array_equal(got[f"resume/{c}/{f}"], want[f"bv/{c}/1/{f}"])
            np.testing.assert_array_equal(_bits(got[f"resume/{c}/w"]), _bits(want[f"bv/{c}/1/w"]))


# ------------------------------------------------------ elastic restore


def test_elastic_restore_shards_match_jax(results):
    """Each rank's shard of every leaf equals the reference's shard at the
    rank's (data, model) coordinate; some leaves are cut on both axes."""
    want = results["jax"]
    cuts = set()
    for r in range(4):
        got = results[f"rank{r}"]
        i, j = got["coord"]
        keys = sorted(k for k in got if k.startswith("rs/"))
        assert keys and len(keys) == len([k for k in want if k.startswith("rs/")]) // 4
        for key in keys:
            np.testing.assert_array_equal(got[key], want[f"{key}/{i}{j}"], err_msg=key)
            cuts.add(int(np.prod(got[f"shape/{key[3:]}"])) // max(got[key].size, 1))
    assert cuts == {1, 2, 4}, cuts  # replicated, cut on one axis, cut on both
