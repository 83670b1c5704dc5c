"""The port's multi-device engine and distributed Borůvka against the JAX
package's, on the CPU.

In-process: the plain ``component_best_edge`` versions against the JAX
package's lexsort oracle, XLA path and Pallas kernel (interpret mode); the
Borůvka round helpers against ``repro.core.hac``'s; and, in a gloo group of
one rank in this process, ``boruvka_mst_distributed`` in each mode against
the JAX package's on a one-device mesh.

Several ranks: gloo ranks in subprocesses (P = 4 flat, a (2, 2) pod mesh,
P = 3 with a padded sample) against one JAX subprocess with four forced host
devices: Borůvka edges and labels, the engine's reducers, and, on the flat
meshes with padded rows, distributed K-Means (bounded and not), BKC and
Buckshot from the same rows and inits. Then ``python -m
repro_torch.distrib.selftest``. Every subprocess has its own timeout, so a
hung collective fails its test.

The sample rows for Borůvka are integer vectors over 8 with a norm of
exactly 1 (16 entries in [-3, 3], squares summing to 64): normalizing them
changes nothing and every similarity is a multiple of 1/64, exact in f32
in any order. So edges must be EQUAL, weights included. On rows of
N(0, 1) noise the two libraries' CPU products differ by up to 6 ulp, which
no tight tolerance holds; here the weights are many-way tied, which pins
the tie rules instead.
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
import torch.distributed as dist

import repro.core.hac  # noqa: F401  (the module, not the re-exported functions)
import repro_torch.core.hac  # noqa: F401
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.component_reduce import component_best_edge_pallas
from repro_torch import interop
from repro_torch.kernels import ops, ref

jh = sys.modules["repro.core.hac"]
th = sys.modules["repro_torch.core.hac"]

ROOT = Path(__file__).resolve().parents[1]
NEG = float(np.finfo(np.float32).min)
TIMEOUT = 300  # seconds for each subprocess


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
    return interop.labels(a, "cpu") if a.dtype.kind in "iu" else interop.data(a, "cpu")


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.int32)


# ------------------------------------------------------ component pre-reduce


def _cbe_inputs(rng, r, c):
    w = rng.normal(size=r).astype(np.float32)
    w[::5] = NEG  # rows with no cross-component edge
    if r > 10:
        w[3] = w[8]  # duplicate weight: the row id breaks the tie
    col = rng.integers(-1, 64, size=r).astype(np.int32)
    rows = rng.permutation(2 * r)[:r].astype(np.int32)
    comp = rng.integers(-1, c + 1, size=r).astype(np.int32)  # -1 and c: dropped
    return w, col, rows, comp


def _cbe_check(w, col, rows, comp, c, **pallas_kw):
    """Both plain versions equal the JAX lexsort oracle bit for bit, and the
    JAX XLA path and Pallas kernel in value (they write the segment max as
    w, +0.0 where the winner holds -0.0)."""
    args = [jnp.asarray(a) for a in (w, col, rows, comp)]
    want = jref.component_best_edge(*args, c)
    others = [jops.component_best_edge(*args, c, impl="xla")]
    if len(w):  # the Pallas kernel takes no empty input (ROADMAP queue 3)
        # its wrapper pads with comp -1 and drops ids >= c itself
        others.append(component_best_edge_pallas(*args, c, interpret=True, **pallas_kw))
    targs = [_t(a) for a in (w, col, rows, comp)]
    for got in (ref.component_best_edge(*targs, c), ref.component_best_edge_segment(*targs, c),
                ops.component_best_edge(*targs, c)):
        np.testing.assert_array_equal(_bits(_np(got[0])), _bits(want[0]))
        for g, wnt in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(_np(g), np.asarray(wnt))
        for other in others:
            for g, o in zip(got, other):
                np.testing.assert_array_equal(_np(g), np.asarray(o))


@pytest.mark.parametrize("r,c", [(7, 3), (64, 64), (130, 9), (513, 40), (300, 700), (0, 5)])
def test_component_best_edge_matches_jax(rng, r, c):
    _cbe_check(*_cbe_inputs(rng, r, c), c)


def test_component_best_edge_empty_and_pad_segments():
    w = np.asarray([1.0, 2.0, 3.0, 9.0, 8.0], np.float32)
    col = np.asarray([5, 6, 7, 8, 9], np.int32)
    rows = np.asarray([0, 1, 2, 3, 4], np.int32)
    comp = np.asarray([0, 0, 2, 4, -1], np.int32)  # 1, 3 empty; 4 == c and -1 pad
    _cbe_check(w, col, rows, comp, 4)
    bw, brow, bcol = ref.component_best_edge_segment(*(_t(a) for a in (w, col, rows, comp)), 4)
    np.testing.assert_array_equal(_np(bw), np.asarray([2.0, NEG, 3.0, NEG], np.float32))
    np.testing.assert_array_equal(_np(brow), [1, ref.BIG_I, 2, ref.BIG_I])
    np.testing.assert_array_equal(_np(bcol), [6, -1, 7, -1])


def test_component_best_edge_lexicographic_tie():
    """Equal weights in a segment, lower row ids on either side: the lowest
    global row id wins (bn=8 puts them in different Pallas row tiles)."""
    r = 40
    w = np.full((r,), 0.5, np.float32)
    w[::7] = NEG  # f32.min rows: real candidates, the lowest weight
    col = (np.arange(r) + 100).astype(np.int32)
    rows = np.arange(r)[::-1].astype(np.int32)  # descending
    comp = (np.arange(r) % 3).astype(np.int32)
    comp[::7] = 3  # a segment of f32.min rows only: they beat the empty sentinel
    _cbe_check(w, col, rows, comp, 4, bn=8)
    got = ref.component_best_edge_segment(*(_t(a) for a in (w, col, rows, comp)), 4)
    assert _np(got[1])[3] == 4 and _np(got[2])[3] == 135  # lowest row of segment 3


def test_component_best_edge_signed_zero():
    """-0.0 ties with +0.0 (row asc decides) and the winner keeps its bits."""
    w = np.asarray([-0.0, 0.0, 0.0, -0.0], np.float32)
    col = np.asarray([5, 6, 7, 8], np.int32)
    rows = np.asarray([1, 3, 2, 0], np.int32)
    comp = np.asarray([0, 0, 1, 1], np.int32)
    _cbe_check(w, col, rows, comp, 2)
    bw, brow, _ = ref.component_best_edge_segment(*(_t(a) for a in (w, col, rows, comp)), 2)
    np.testing.assert_array_equal(_np(brow), [1, 0])
    assert np.signbit(_np(bw)).all()


# ------------------------------------------------------ Borůvka round helpers


def _round_inputs(rng, s=60, groups=17, phantoms=5):
    """A mid-run Borůvka state: min-id labels, the round's dense ids, and the
    per-component winners off the JAX package's plain combiner."""
    xs = rng.normal(size=(s, 8)).astype(np.float32)
    g = rng.integers(0, groups, size=s)
    first = {int(v): i for i, v in reversed(list(enumerate(g)))}
    labels = np.asarray([first[int(v)] for v in g], np.int32)
    n_roots = len(first)
    cap = n_roots + phantoms
    bj, bw = jref.sim_best_edge(jnp.asarray(xs), jnp.asarray(xs), jnp.asarray(labels),
                                jnp.asarray(labels))
    comp, c2r = jh._round_prep(jnp.asarray(labels), cap)
    best = jref.component_best_edge(bw, bj.astype(jnp.int32), jnp.arange(s, dtype=jnp.int32),
                                    comp, cap)
    return labels, cap, n_roots, comp, c2r, best


def test_round_prep_matches_jax(rng):
    labels, cap, _, comp, c2r, _ = _round_inputs(rng)
    got = th._round_prep(_t(labels), cap)
    np.testing.assert_array_equal(_np(got[0]), np.asarray(comp))
    np.testing.assert_array_equal(_np(got[1]), np.asarray(c2r))


def test_merge_round_pre_matches_jax(rng):
    labels, _, _, _, c2r, best = _round_inputs(rng)
    want = jh._merge_round_pre(jnp.asarray(labels), *best, c2r)
    got = th._merge_round_pre(_t(labels), *(_t(b) for b in best), _t(c2r))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_merge_round_comp_and_expand_match_jax(rng):
    """With phantom slots [n_real, cap): they stay isolated singletons."""
    labels, cap, n_roots, comp, c2r, best = _round_inputs(rng)
    tcomp = np.asarray(comp)[np.maximum(np.asarray(best[2]), 0)]
    next_cap = -(-cap // 2)
    want = jh._merge_round_comp(*best, jnp.asarray(tcomp), c2r, jnp.int32(n_roots),
                                next_cap=next_cap)
    got = th._merge_round_comp(*(_t(b) for b in best), _t(tcomp), _t(c2r),
                               torch.tensor(n_roots, dtype=torch.int32), next_cap=next_cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    relabel = _np(got[0])
    assert len(set(relabel[n_roots:])) == cap - n_roots  # phantoms: singletons
    s = labels.shape[0]
    want_e = jh._expand_round_edges(s, *want[2:6], c2r)
    got_e = th._expand_round_edges(s, *got[2:6], _t(c2r))
    for g, w in zip(got_e, want_e):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


# ------------------------------------------------------ analytic accounting


@pytest.mark.parametrize("s,tiers", [(3536, (1,)), (322, (3,)), (320, (2, 2)), (4096, (2, 4))])
def test_analytic_bytes_match_jax(s, tiers):
    import repro.distrib.hac_parallel as jhp
    import repro_torch.distrib.hac_parallel as thp

    p, d, rounds = int(np.prod(tiers)), 2048, 8
    assert thp.shuffle_bytes_per_round(s, p, rounds) == jhp.shuffle_bytes_per_round(s, p, rounds)
    for merge in ("comp", "point"):
        assert (thp.shuffle_bytes_per_tier(s, tiers, rounds, merge=merge)
                == jhp.shuffle_bytes_per_tier(s, tiers, rounds, merge=merge))
        for sweep in ("sharded", "bcast"):
            assert (thp.bcast_bytes_per_round(s, d, p, rounds, sweep=sweep, merge=merge)
                    == jhp.bcast_bytes_per_round(s, d, p, rounds, sweep=sweep, merge=merge))
    for sweep, overlap in (("sharded", True), ("sharded", False), ("bcast", True)):
        assert (thp.sweep_peak_bytes_per_device(s, d, p, sweep=sweep, overlap=overlap)
                == jhp.sweep_peak_bytes_per_device(s, d, p, sweep=sweep, overlap=overlap))
    assert [thp.round_cap(s, r) for r in range(rounds)] == [
        jhp.round_cap(s, r) for r in range(rounds)]


# ------------------------------------------------------ world size 1, in process


def _exact_unit(rng, s, d=16):
    """(s, d) rows k / 8 with integer k in [-3, 3] and sum(k^2) = 64."""
    rows = []
    while len(rows) < s:
        k = rng.integers(-3, 4, size=(4 * s, d))
        rows.extend(k[(k * k).sum(1) == 64])
    return (np.asarray(rows[:s]) / 8).astype(np.float32)


def _same_edges(got, want):
    for f in ("u", "v", "valid"):
        np.testing.assert_array_equal(np.asarray(got[f]), np.asarray(want[f]), err_msg=f)
    np.testing.assert_array_equal(_bits(got["w"]), _bits(want["w"]), err_msg="w")


@pytest.fixture
def gloo_world_1(tmp_path):
    from repro_torch.distrib.sharding import make_flat_mesh

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield make_flat_mesh()
    finally:
        dist.destroy_process_group()


# the three candidate modes, then the sharded sweep's other settings
MODES = {
    "sharded": {},
    "bcast": {"sweep": "bcast"},
    "point": {"merge": "point"},
    "expanded": {"compact": False},
    "no-overlap": {"overlap": False},
}
SAME_AS = {"no-overlap": "sharded"}  # overlap does not change the bits


def test_boruvka_distributed_world_1_matches_jax(gloo_world_1, rng):
    from repro.distrib.hac_parallel import boruvka_mst_distributed as jbmd
    from repro.distrib.sharding import make_flat_mesh as jflat
    from repro_torch.distrib.hac_parallel import (
        boruvka_mst_distributed,
        single_link_labels_distributed,
    )

    xs = _exact_unit(rng, 40)
    jmesh = jflat(1)
    for name in ("sharded", "bcast", "point"):
        kw = MODES[name]
        want = jbmd(jmesh, ("data",), jnp.asarray(xs), prewarm=False, **kw)._asdict()
        got = boruvka_mst_distributed(gloo_world_1, ("data",), _t(xs), **kw)._asdict()
        _same_edges({k: _np(v) for k, v in got.items()}, want)
    got = single_link_labels_distributed(gloo_world_1, ("data",), _t(xs), 5)
    np.testing.assert_array_equal(
        _np(got), np.asarray(jh.single_link_labels_boruvka(jnp.asarray(xs), 5)))


# ------------------------------------------------------ several ranks


# (name, world, mesh, s, modes): s = 70 and 322 do not divide over the shards
CONFIGS = [
    ("flat4", 4, "flat", 70, tuple(MODES)),
    ("pod22", 4, "pod", 70, ("sharded", "bcast", "no-overlap")),  # tiered ring and reduce
    ("flat3", 3, "flat", 322, ("sharded", "point")),
]
SEED = 7
# the cluster jobs' sizes: n rows, k clusters, BigK micro-clusters, s sample rows
CLUSTER = dict(cn=202, ck=5, cbk=16, cs=40)
FITS = ("kmeans", "kmeans_bounded", "bkc", "buckshot")

_COMMON = """
import sys
import numpy as np
rng = np.random.default_rng({seed})
def unit(s, d=16):
    rows = []
    while len(rows) < s:
        k = rng.integers(-3, 4, size=(4 * s, d))
        rows.extend(k[(k * k).sum(1) == 64])
    return (np.asarray(rows[:s]) / 8).astype(np.float32)
XS = {{name: unit(s) for name, _, _, s, _ in {configs}}}
RC = np.random.default_rng(3)
R, C = 64, 11
CW = RC.normal(size=R).astype(np.float32)
CW[::6] = np.finfo(np.float32).min
CW[17] = CW[50]  # cross-shard duplicate weight: the row id breaks the tie
CCOL = RC.integers(-1, 40, size=R).astype(np.int32)
CCOMP = RC.integers(0, C + 1, size=R).astype(np.int32)
MODES = {modes}
SAME_AS = {same_as}
# the cluster jobs: unit rows of {ck} blobs, n = {cn} (pads over 3 and 4 shards)
RK = np.random.default_rng(11)
KX = RK.normal(size=({ck}, 24))[RK.integers(0, {ck}, size={cn})] + 0.3 * RK.normal(size=({cn}, 24))
KX = (KX / np.linalg.norm(KX, axis=1, keepdims=True)).astype(np.float32)
KINIT = KX[RK.choice({cn}, {ck}, replace=False)]
KBINIT = KX[RK.choice({cn}, {cbk}, replace=False)]
KSAMPLE = KX[RK.choice({cn}, {cs}, replace=False)]
def cluster_fits(dc, mesh, axes, xp, w, key, to):
    init, binit, sample = to(KINIT), to(KBINIT), to(KSAMPLE)
    return {{
        "kmeans": lambda: dc.kmeans_distributed(mesh, axes, xp, w, init, {ck}, max_iters=6,
                                                tol=1e-4, bounded=False),
        "kmeans_bounded": lambda: dc.kmeans_distributed(mesh, axes, xp, w, init, {ck},
                                                        max_iters=6, tol=1e-4, bounded=True),
        "bkc": lambda: dc.bkc_distributed(mesh, axes, xp, w, binit, {cbk}, {ck}),
        "buckshot": lambda: dc.buckshot_distributed(
            mesh, axes, xp, w, {ck}, key, sample_size={cs}, kmeans_iters=3, hac="boruvka",
            sample_rows=sample),
    }}
"""

_JAX = """
import jax, jax.numpy as jnp
from repro.distrib import cluster as dc
from repro.distrib.engine import make_job
from repro.distrib.hac_parallel import boruvka_mst_distributed, single_link_labels_distributed
from repro.distrib.sharding import make_flat_mesh, make_pod_mesh, pad_rows_to_multiple, shard_rows
from repro.kernels import ops
out = {{}}
for name, world, kind, s, modes in {configs}:
    if name != sys.argv[2]:
        continue
    mesh, axes = (make_flat_mesh(world), ("data",)) if kind == "flat" else (
        make_pod_mesh(2, 2), ("pod", "data"))
    xs = jnp.asarray(XS[name])
    for mode in modes:
        if mode in SAME_AS:
            continue
        e = boruvka_mst_distributed(mesh, axes, xs, prewarm=False, **MODES[mode])
        for f, v in e._asdict().items():
            out[f"{{name}}/{{mode}}/{{f}}"] = np.asarray(v)
    out[f"{{name}}/labels"] = np.asarray(single_link_labels_distributed(mesh, axes, xs, 9))
    sh = lambda v: shard_rows(mesh, axes, v)
    if kind == "flat":
        xp, w = pad_rows_to_multiple(jnp.asarray(KX), world)
        for fit, run in cluster_fits(dc, mesh, axes, sh(xp), sh(w), jax.random.PRNGKey(0),
                                     jnp.asarray).items():
            res = run()
            for f in ("centers", "assignment", "rss"):
                out[f"{{name}}/{{fit}}/{{f}}"] = np.asarray(getattr(res, f))
            out[f"{{name}}/{{fit}}/iterations"] = np.asarray(res.iterations)
    if world != 4:
        continue
    def mc(data, bcast):
        v = data["x"]
        return {{"sum": jnp.sum(v), "min": jnp.min(v), "max": jnp.max(v), "rows": v * 2.0,
                "cat": jnp.sum(v, keepdims=True)}}
    job = make_job(mesh, axes, mc, {{"sum": "sum", "min": "min", "max": "max",
                                    "rows": "shard", "cat": "gather"}})
    red = job({{"x": sh(jnp.arange(64, dtype=jnp.float32))}}, {{}})
    for f, v in red.items():
        out[f"{{name}}/reduce/{{f}}"] = np.asarray(v)
    def cmc(data, bcast):
        bw, brow, bcol = ops.component_best_edge(
            data["w"], data["col"], data["rows"], data["comp"], C, impl="xla")
        return {{"best": {{"w": bw, "row": brow, "col": bcol}}}}
    cjob = make_job(mesh, axes, cmc, {{"best": "component"}})
    best = cjob({{"w": sh(jnp.asarray(CW)), "col": sh(jnp.asarray(CCOL)),
                "rows": sh(jnp.arange(R, dtype=jnp.int32)), "comp": sh(jnp.asarray(CCOMP))}}, {{}})
    for f, v in best["best"].items():
        out[f"{{name}}/component/{{f}}"] = np.asarray(v)
np.savez(sys.argv[1], **out)
"""

_TORCH = """
import torch, torch.distributed as dist
from repro_torch.distrib import cluster as dc
from repro_torch.distrib.engine import make_job
from repro_torch.distrib.hac_parallel import (boruvka_mst_distributed,
                                              single_link_labels_distributed)
from repro_torch.distrib.sharding import (make_flat_mesh, make_pod_mesh, pad_rows_to_multiple,
                                          shard_rows)
from repro_torch.kernels import ops
rank, world, init, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + init, rank=rank, world_size=world)
out = {{}}
for name, w_, kind, s, modes in {configs}:
    if w_ != world:
        continue
    mesh, axes = (make_flat_mesh(), ("data",)) if kind == "flat" else (
        make_pod_mesh(2), ("pod", "data"))
    xs = torch.from_numpy(XS[name])
    for mode in modes:
        e = boruvka_mst_distributed(mesh, axes, xs, **MODES[mode])
        for f, v in e._asdict().items():
            out[f"{{name}}/{{mode}}/{{f}}"] = v.numpy()
    out[f"{{name}}/labels"] = single_link_labels_distributed(mesh, axes, xs, 9).numpy()
    sh = lambda v: shard_rows(mesh, axes, v)
    if kind == "flat":
        xp, w = pad_rows_to_multiple(torch.from_numpy(KX), world)
        for fit, run in cluster_fits(dc, mesh, axes, sh(xp), sh(w), 0,
                                     torch.from_numpy).items():
            res = run()
            for f in ("centers", "assignment", "rss"):
                out[f"{{name}}/{{fit}}/{{f}}"] = getattr(res, f).numpy()
            out[f"{{name}}/{{fit}}/iterations"] = np.asarray(res.iterations)
    if world != 4:
        continue
    def mc(data, bcast):
        v = data["x"]
        return {{"sum": torch.sum(v), "min": torch.min(v), "max": torch.max(v),
                "rows": v * 2.0, "cat": torch.sum(v, 0, keepdim=True)}}
    job = make_job(mesh, axes, mc, {{"sum": "sum", "min": "min", "max": "max",
                                    "rows": "shard", "cat": "gather"}})
    red = job({{"x": sh(torch.arange(64, dtype=torch.float32))}}, {{}})
    for f, v in red.items():
        out[f"{{name}}/reduce/{{f}}"] = v.numpy()
    def cmc(data, bcast):
        bw, brow, bcol = ops.component_best_edge(
            data["w"], data["col"], data["rows"], data["comp"], C)
        return {{"best": {{"w": bw, "row": brow, "col": bcol}}}}
    cjob = make_job(mesh, axes, cmc, {{"best": "component"}})
    best = cjob({{"w": sh(torch.from_numpy(CW)), "col": sh(torch.from_numpy(CCOL)),
                "rows": sh(torch.arange(R, dtype=torch.int32)),
                "comp": sh(torch.from_numpy(CCOMP))}}, {{}})
    for f, v in best["best"].items():
        out[f"{{name}}/component/{{f}}"] = v.numpy()
dist.destroy_process_group()
np.savez(path, **out)
"""


def _script(body):
    fmt = dict(seed=SEED, configs=repr(CONFIGS), modes=repr(MODES), same_as=repr(SAME_AS),
               **CLUSTER)
    return textwrap.dedent(_COMMON.format(**fmt)) + textwrap.dedent(body.format(**fmt))


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu", **extra)
    return env


@pytest.fixture(scope="module", autouse=True)
def _multirank_procs(tmp_path_factory):
    """A JAX subprocess on four forced host devices for each mesh (their
    compiles take most of the time, so they run side by side) and the gloo
    ranks of world sizes 4 and 3, started with the module's first test so
    that they run beside the in-process tests. Output goes to files (a full
    pipe would block a rank)."""
    tmp = tmp_path_factory.mktemp("multirank")
    procs = {}

    def start(name, args, env):
        with open(tmp / f"{name}.log", "w") as log:
            procs[name] = subprocess.Popen([sys.executable, "-c", *args], env=env,
                                           stdout=log, stderr=subprocess.STDOUT, cwd=ROOT)

    try:
        jax_script = _script(_JAX)
        for name, *_ in CONFIGS:
            start(f"jax_{name}", [jax_script, str(tmp / f"jax_{name}.npz"), name],
                  _env(XLA_FLAGS="--xla_force_host_platform_device_count=4"))
        torch_script = _script(_TORCH)
        for world in (4, 3):
            for r in range(world):
                start(f"w{world}r{r}", [torch_script, str(r), str(world),
                                        str(tmp / f"init{world}"), str(tmp / f"w{world}r{r}.npz")],
                      _env())
        yield tmp, procs
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def multirank(_multirank_procs):
    tmp, procs = _multirank_procs
    for name, p in procs.items():
        try:
            p.wait(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            pytest.fail(f"{name} did not finish in {TIMEOUT} s:\n{(tmp / f'{name}.log').read_text()}")
        assert p.returncode == 0, f"{name} failed:\n{(tmp / f'{name}.log').read_text()}"
    out = {name: dict(np.load(tmp / f"{name}.npz")) for name in procs}
    out["jax"] = {k: v for name, *_ in CONFIGS for k, v in out.pop(f"jax_{name}").items()}
    return out


@pytest.mark.parametrize("name,world,kind,s,modes", CONFIGS)
def test_boruvka_distributed_several_ranks_matches_jax(multirank, name, world, kind, s, modes):
    want = multirank["jax"]
    for r in range(world):  # every rank ends with the same replicated edges
        got = multirank[f"w{world}r{r}"]
        for mode in modes:
            ref_mode = SAME_AS.get(mode, mode)
            _same_edges({f: got[f"{name}/{mode}/{f}"] for f in ("u", "v", "w", "valid")},
                        {f: want[f"{name}/{ref_mode}/{f}"] for f in ("u", "v", "w", "valid")})
        np.testing.assert_array_equal(got[f"{name}/labels"], want[f"{name}/labels"])


@pytest.mark.parametrize("name", ["flat4", "pod22"])
def test_engine_reducers_several_ranks_match_jax(multirank, name):
    """sum/min/max replicated, 'shard' rows in row-block order, 'gather' in
    row-block order, and the tiered 'component' reduce (w desc, row asc)."""
    want = multirank["jax"]
    rows = np.concatenate([multirank[f"w4r{r}"][f"{name}/reduce/rows"] for r in range(4)])
    np.testing.assert_array_equal(rows, want[f"{name}/reduce/rows"])
    for r in range(4):
        got = multirank[f"w4r{r}"]
        for f in ("sum", "min", "max", "cat"):
            np.testing.assert_array_equal(got[f"{name}/reduce/{f}"], want[f"{name}/reduce/{f}"])
        for f in ("w", "row", "col"):
            np.testing.assert_array_equal(got[f"{name}/component/{f}"],
                                          want[f"{name}/component/{f}"])


# Measured between the two packages on these jobs (blob seeds 11, 12, 13,
# P = 4 and 3): labels and iteration counts equal, centers within 8.9e-8
# (1.5 ulp at 1.0) and RSS within 9.1e-7 relative, from the ranks' partial
# sums added in other orders. The bounds below leave about 3x and 5x room.
CENTER_ATOL, RSS_RTOL = 3e-7, 5e-6


@pytest.mark.parametrize("name,world", [("flat4", 4), ("flat3", 3)])
@pytest.mark.parametrize("fit", FITS)
def test_cluster_jobs_several_ranks_match_jax(multirank, name, world, fit):
    """kmeans_distributed (bounded and not), bkc_distributed and
    buckshot_distributed (hac='boruvka', sample rows given) from the same
    rows, weights and inits: each rank's block of labels equals the JAX
    package's, centers and RSS agree within the measured bounds, and the
    replicated results are the same bits on every rank."""
    want = {f: multirank["jax"][f"{name}/{fit}/{f}"]
            for f in ("centers", "assignment", "rss", "iterations")}
    b = want["assignment"].shape[0] // world
    first = multirank[f"w{world}r0"]
    for r in range(world):
        got = {f: multirank[f"w{world}r{r}"][f"{name}/{fit}/{f}"]
               for f in ("centers", "assignment", "rss", "iterations")}
        np.testing.assert_array_equal(got["assignment"], want["assignment"][r * b:(r + 1) * b])
        assert int(got["iterations"]) == int(want["iterations"])
        np.testing.assert_allclose(got["centers"], want["centers"], rtol=0, atol=CENTER_ATOL)
        np.testing.assert_allclose(got["rss"], want["rss"], rtol=RSS_RTOL)
        for f in ("centers", "rss"):
            np.testing.assert_array_equal(_bits(got[f]), _bits(first[f"{name}/{fit}/{f}"]))


def test_distributed_selftest():
    """Distributed K-Means, BKC and Buckshot == the resident fits (4 gloo ranks)."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.distrib.selftest", "--timeout", str(TIMEOUT)],
        capture_output=True, text=True, timeout=TIMEOUT + 30, env=_env(), cwd=ROOT,
    )
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr}"
    assert "SELFTEST OK" in out.stdout
