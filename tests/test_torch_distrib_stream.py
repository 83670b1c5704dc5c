"""The port's distributed streaming against the JAX package's, on the CPU:
the engine's fold mode, the four ``*_distributed_stream`` drivers, the mesh
routes of tf-idf and corpus preparation, and the checkpointed resumes.

In-process: ``_topk_merge``, ``local_top_s`` and ``reservoir_finalize_bytes``
against the JAX package's; the fold job's rejections; and, in a gloo group
of one rank in this process, each streaming driver against its
single-device counterpart bit for bit (at one rank the collective is a
copy) and a checkpointed ``boruvka_mst_distributed`` cut and resumed.

Several ranks: gloo ranks in subprocesses (P = 4 flat and a (2, 2) pod mesh
in one world of 4, P = 3 in a world of 3, all with padded rows) against one
JAX subprocess with four forced host devices for each mesh. Both sides fold
the same numpy rows in the same chunks from the same initial centers, and
the reservoir takes the JAX package's own ``fold_in(fold_in(key, ci),
shard)`` uniforms, drawn in this process. In the world of 4 the ranks also
check the port against itself: a one-chunk stream against the resident fit,
prefetch on against off, and each driver cut by ``raise@gN`` and resumed
from a ``MemoryCheckpointer`` per rank (bit for bit, the store empty at the
end, only the chunks after the snapshot folded), a resume whose ranks hold
snapshots of different chunks (a cold start), and a checkpointed Borůvka
loop cut in a round. A world of 2 ranks SIGKILLed by ``kill@gN`` resumes
from a shared ``DiskCheckpointer`` directory. Every subprocess has its own
timeout, so a hung collective fails its test.

The parity contract is the ROADMAP's: integer outputs equal, f32 exact on
integer-valued rows (the fold kinds) and within a few ulp otherwise (the
blob rows of the fits); tf-idf rows within 5 ulp (the JAX package's XLA CPU
``log`` is not correctly rounded for ~2 % of f32 inputs), df and n exact.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300  # seconds for each subprocess

# (name, world, mesh kind, chunk): the chunks divide over the shards, and the
# blob collection's 202 rows fill neither 40- nor 36-row chunks
CONFIGS = [("flat4", 4, "flat", 40), ("pod22", 4, "pod", 40), ("flat3", 3, "flat", 36)]
N, D, K, BIG_K, S = 202, 24, 5, 16, 40  # fits: rows, width, k, BigK, sample
KEY = 5  # the JAX reservoir's PRNGKey
FN, FS, FC = 96, 4, 11  # fold kinds: rows, top-s, components
# Measured between the two packages' resident distributed fits on these
# blob rows (tests/test_torch_distrib.py): centers within 8.9e-8, RSS within
# 9.1e-7 relative, from the ranks' partial sums added in other orders.
CENTER_ATOL, RSS_RTOL = 3e-7, 5e-6
TFIDF_ULP = 5


@pytest.fixture
def rng(request):
    """This module's generator, seeded from the test's own name."""
    name = f"{request.module.__name__}::{request.node.name}"
    return np.random.default_rng(zlib.crc32(name.encode()))


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.int32)


def _ulps(a, b):
    """Largest distance in f32 ulps between same-signed arrays."""
    return int(np.max(np.abs(_bits(a).astype(np.int64) - _bits(b).astype(np.int64)), initial=0))


# ------------------------------------------------------------------ in process


def test_topk_merge_ties_match_jax(rng):
    """The chunk monoid of 'topk' ranks like ``jax.lax.top_k``: ties go to
    the lower position, the carry's before the chunk's."""
    from repro.distrib.engine import _topk_merge as jmerge
    from repro_torch.distrib.engine import _topk_merge

    for _ in range(20):
        a = {"score": rng.integers(-2, 3, 8).astype(np.float32),
             "tag": rng.integers(0, 100, 8).astype(np.int32),
             "rows": rng.normal(size=(8, 3)).astype(np.float32)}
        b = {k: rng.permutation(v) for k, v in a.items()}
        want = jmerge({k: jnp.asarray(v) for k, v in a.items()},
                      {k: jnp.asarray(v) for k, v in b.items()})
        got = _topk_merge({k: torch.from_numpy(v) for k, v in a.items()},
                          {k: torch.from_numpy(v) for k, v in b.items()})
        for k in a:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("n,s", [(37, 5), (12, 40), (64, 64)])
def test_local_top_s_matches_jax(n, s):
    """The body of the JAX package's ``local_top_s`` on the same uniforms
    (its jitted wrapper traces ``n_local``, which it needs as a shape, so
    it does not run as written)."""
    from repro_torch.core.sampling import local_top_s

    u = jax.random.uniform(jax.random.PRNGKey(n), (n,))
    want = jax.lax.top_k(u, min(s, n))
    got = local_top_s(torch.from_numpy(np.array(u)), s)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    ties = np.asarray([0.5, 0.25, 0.5, 0.75, 0.25, 0.5], np.float32)
    top, pos = jax.lax.top_k(jnp.asarray(ties), 4)
    got = local_top_s(torch.from_numpy(ties), 4)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(pos))
    assert got[1].dtype == torch.int32


@pytest.mark.parametrize("s,d,p", [(3536, 2048, 1), (40, 24, 4), (322, 16, 3), (64, 8, 8)])
def test_reservoir_finalize_bytes_matches_jax(s, d, p):
    from repro.distrib.cluster import reservoir_finalize_bytes as jbytes
    from repro_torch.distrib.cluster import reservoir_finalize_bytes

    for owner in (True, False):
        assert reservoir_finalize_bytes(s, d, p, owner_scatter=owner) == jbytes(
            s, d, p, owner_scatter=owner)


@pytest.fixture
def world_1(tmp_path):
    from repro_torch.distrib.sharding import make_flat_mesh

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield make_flat_mesh()
    finally:
        dist.destroy_process_group()


def test_fold_job_rejections(world_1):
    from repro.distrib import engine as je
    from repro_torch.distrib import engine as te
    from repro_torch.distrib.sharding import check_stream_shardable
    from repro_torch.text.stream import CorpusStream

    with pytest.raises(ValueError, match="fold mode"):
        te.make_fold_job(world_1, ("data",), lambda d, b: d, {"x": "gather"})
    with pytest.raises(ValueError, match="fold mode"):
        je.make_fold_job(je.jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("data",)),
                         ("data",), lambda d, b: d, {"x": "gather"})
    with pytest.raises(ValueError, match="'topk' is fold-mode only"):
        te.make_job(world_1, ("data",), lambda d, b: d, {"x": "topk"})
    with pytest.raises(ValueError, match="score"):
        te._check_topk({"gidx": torch.zeros(3)})
    with pytest.raises(ValueError, match="score"):
        te._check_topk(torch.zeros(3))
    job = te.make_fold_job(world_1, ("data",), lambda d, b: {"best": d}, {"best": "topk"})
    with pytest.raises(ValueError, match="axis-0 length 3"):  # the JAX package's message
        job.step(None, {"score": torch.zeros(3), "rows": torch.zeros(4, 2)})
    with pytest.raises(ValueError, match="axis-0"):
        je._check_topk({"score": jnp.zeros(3), "rows": jnp.zeros((4, 2))})
    cjob = te.make_fold_job(world_1, ("data",), lambda d, b: {"c": d}, {"c": "component"})
    with pytest.raises(ValueError, match="'component' fold kind"):
        cjob.step(None, {"w": torch.zeros(2), "row": torch.zeros(2)})
    with pytest.raises(ValueError, match="empty stream"):
        job.finalize(None)
    check_stream_shardable(CorpusStream.from_array(np.zeros((10, 2)), chunk=5), world_1,
                           ("data",))


def _unit_blobs(rng, n=300, d=16, k=5):
    c = rng.normal(size=(k, d))
    x = c[rng.integers(0, k, n)] + 0.3 * rng.normal(size=(n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def test_world_1_drivers_equal_single_device_streams(world_1, rng):
    """At one rank each streaming driver equals its single-device
    counterpart bit for bit: both fold chunk partials in chunk order, the
    collective is a copy and the RSS sums the same per-cluster norms."""
    from repro_torch.core import sampling
    from repro_torch.core.bkc import bkc_fit_stream
    from repro_torch.core.kmeans import kmeans_fit_stream
    from repro_torch.distrib import cluster as dc
    from repro_torch.text.stream import CorpusStream

    x = _unit_blobs(rng)
    st = CorpusStream.from_array(x, chunk=64)
    init = torch.from_numpy(x[rng.choice(len(x), 5, replace=False)])
    for bounded in (False, True):
        got = dc.kmeans_distributed_stream(world_1, ("data",), st, init, 5, bounded=bounded)
        want = kmeans_fit_stream(st, init, 5, bounded=bounded)
        assert got.iterations == want.iterations
        for f in ("centers", "assignment", "rss", "objective"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    binit = torch.from_numpy(x[rng.choice(len(x), 16, replace=False)])
    for bounded in (False, True):
        got = dc.bkc_distributed_stream(world_1, ("data",), st, binit, 16, 4, bounded=bounded)
        want = bkc_fit_stream(st, binit, 16, 4, bounded=bounded)
        for f in ("centers", "assignment", "rss", "objective"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    rows, gidx = dc.reservoir_sample_distributed_stream(
        world_1, ("data",), st, 40, uniforms=lambda ci, p: sampling.chunk_uniforms(9, ci, 64))
    wrows, wgidx = sampling.reservoir_sample_stream(
        st, 40, uniforms=lambda ci: sampling.chunk_uniforms(9, ci, 64), device="cpu")
    np.testing.assert_array_equal(gidx, wgidx)
    assert torch.equal(rows, wrows)
    # the default draws: a seed gives one sample, every time
    a = dc.reservoir_sample_distributed_stream(world_1, ("data",), st, 40, 3)[1]
    b = dc.reservoir_sample_distributed_stream(world_1, ("data",), st, 40, 3)[1]
    np.testing.assert_array_equal(a, b)
    assert len(set(a.tolist())) == 40 and a.max() < len(x)


def test_world_1_tfidf_stream_equals_single_device(world_1):
    from repro_torch.text import pipeline, synth, tfidf

    st, _ = synth.stream_corpus(150, vocab=64, n_topics=4, seed=2, chunk=40)
    df, n = tfidf.df_stream(st, device="cpu")
    got = tfidf.df_fold_distributed(world_1, ("data",), st)
    assert torch.equal(got["df"], df) and torch.equal(got["n"], n)
    want = tfidf.tfidf_stream(st, device="cpu").materialize()
    np.testing.assert_array_equal(
        tfidf.tfidf_distributed_stream(world_1, ("data",), st).materialize(), want)
    prep = pipeline.prepare_synthetic_stream(n_docs=150, vocab=64, n_topics=4, seed=2, chunk=40,
                                             mesh=world_1)
    np.testing.assert_array_equal(prep.x.materialize(), want)
    res = pipeline.prepare_synthetic(world_1, ("data",), n_docs=150, vocab=64, n_topics=4,
                                     seed=2)
    np.testing.assert_array_equal(res.x.numpy(), want)
    assert res.n == 150 and res.labels.shape == (150,) and bool((res.w == 1).all())


def test_world_1_boruvka_checkpoint_resumes(world_1, rng, monkeypatch):
    """A checkpointed Borůvka loop cut in round 4 resumes from its round-2
    snapshot (the host read after which the loop went on) and gives the
    uninterrupted edges bit for bit, running rounds 3-5 only; only
    merge='comp' takes a checkpoint."""
    from repro_torch.distrib import hac_parallel as hp
    from repro_torch.resilience import MemoryCheckpointer

    xs = torch.from_numpy(rng.normal(size=(70, 16)).astype(np.float32))
    merge = hp._merge_round_comp
    rounds, cut_at = [], []

    def counted(*a, **kw):
        rounds.append(1)
        if len(rounds) == (cut_at or [0])[0]:
            raise RuntimeError("cut")
        return merge(*a, **kw)

    monkeypatch.setattr(hp, "_merge_round_comp", counted)
    for sweep in ("auto", "bcast"):
        rounds.clear()
        cut_at.clear()
        want = hp.boruvka_mst_distributed(world_1, ("data",), xs, sweep=sweep)
        assert len(rounds) == 6  # the flag read after round 2 found work left
        ck = MemoryCheckpointer()
        rounds.clear()
        cut_at.append(5)
        with pytest.raises(RuntimeError, match="cut"):
            hp.boruvka_mst_distributed(world_1, ("data",), xs, sweep=sweep, checkpoint=ck)
        assert list(ck._store) == ["snap/boruvka_mst"]
        rounds.clear()
        cut_at.clear()
        got = hp.boruvka_mst_distributed(world_1, ("data",), xs, sweep=sweep, checkpoint=ck)
        assert len(rounds) == 3  # rounds 0-2 came from the snapshot
        for f in ("u", "v", "valid"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        np.testing.assert_array_equal(_bits(got.w.numpy()), _bits(want.w.numpy()))
        assert ck._store == {}
    with pytest.raises(ValueError, match="merge='comp'"):
        hp.boruvka_mst_distributed(world_1, ("data",), xs, merge="point",
                                   checkpoint=MemoryCheckpointer())


# ------------------------------------------------------------------ several ranks

_COMMON = """
import os
import sys
import numpy as np
CONFIGS = __CONFIGS__
N, D, K, BIG_K, S = __FITS__
FN, FS, FC = __FOLD__
NEG = np.finfo(np.float32).min
name_arg = sys.argv[2] if len(sys.argv) > 2 else None
# the fold kinds: integer-valued rows, scores tied by the dozen, a component
# weight repeated across chunks and shards, f32.min rows, ids -1 and FC
R = np.random.default_rng(3)
FX = (np.arange(FN, dtype=np.float32) - 17.0).reshape(FN, 1)
FSCORE = R.integers(0, 6, FN).astype(np.float32)
FVEC = R.normal(size=(FN, 3)).astype(np.float32)
FW = R.normal(size=FN).astype(np.float32)
FW[::7] = NEG
FW[5] = FW[70]
FCOL = R.integers(-1, 30, FN).astype(np.int32)
FCOMP = R.integers(-1, FC + 1, FN).astype(np.int32)
FDATA = {"x": FX, "score": FSCORE, "vec": FVEC, "cw": FW, "col": FCOL, "comp": FCOMP,
         "rid": np.arange(FN, dtype=np.int32)}
FOLD_KINDS = {"sum": "sum", "min": "min", "max": "max", "rows": "shard", "stats": "sum",
              "best": "topk", "comp": "component"}
# the fits: unit rows of K blobs (tests/test_torch_distrib.py's draw)
RK = np.random.default_rng(11)
KX = RK.normal(size=(K, D))[RK.integers(0, K, N)] + 0.3 * RK.normal(size=(N, D))
KX = (KX / np.linalg.norm(KX, axis=1, keepdims=True)).astype(np.float32)
KINIT = KX[RK.choice(N, K, replace=False)]
KBINIT = KX[RK.choice(N, BIG_K, replace=False)]
DRIVERS = {"flat4": ("kmeans", "bkc", "reservoir", "buckshot"),
           "pod22": ("kmeans", "reservoir"),
           "flat3": ("kmeans", "bkc", "reservoir", "buckshot")}
CORPUS = dict(vocab=64, n_topics=4, seed=2)
N_DOCS = 203
"""

_JAX = """
import jax
import jax.numpy as jnp
from repro.distrib import cluster as dc
from repro.distrib.engine import make_fold_job
from repro.distrib.sharding import make_flat_mesh, make_pod_mesh, pad_rows_to_multiple, shard_rows
from repro.kernels import ops
from repro.text import pipeline, synth, tfidf
from repro.text.stream import CorpusStream

name, world, kind, chunk = [c for c in CONFIGS if c[0] == name_arg][0]
mesh, axes = (make_flat_mesh(world), ("data",)) if kind == "flat" else (
    make_pod_mesh(2, 2), ("pod", "data"))
sh = lambda v: shard_rows(mesh, axes, jnp.asarray(v))
out = {}

def mc(data, bcast):
    v = data["x"]
    top, pos = jax.lax.top_k(data["score"], FS)
    bw, brow, bcol = ops.component_best_edge(data["cw"], data["col"], data["rid"], data["comp"],
                                             FC, impl="xla")
    return {"sum": jnp.sum(v), "min": jnp.min(v), "max": jnp.max(v), "rows": v * 2.0,
            "stats": {"a": jnp.sum(v), "b": jnp.sum(v * v)},
            "best": {"score": top, "tag": data["rid"][pos], "vec": data["vec"][pos]},
            "comp": {"w": bw, "row": brow, "col": bcol}}

fold = make_fold_job(mesh, axes, mc, FOLD_KINDS)
carry, rows = None, []
fchunk = 8 * world
for start in range(0, FN, fchunk):
    carry, so = fold.step(carry, {k: sh(v[start:start + fchunk]) for k, v in FDATA.items()}, {})
    rows.append(np.asarray(so["rows"]))
res = fold.finalize(carry)
out["fold/rows"] = np.concatenate(rows)
for f in ("sum", "min", "max"):
    out[f"fold/{f}"] = np.asarray(res[f])
for grp in ("stats", "best", "comp"):
    for f, v in res[grp].items():
        out[f"fold/{grp}/{f}"] = np.asarray(v)

st = CorpusStream.from_array(KX, chunk=chunk)
key = jax.random.PRNGKey(__KEY__)
fits = {}
if "kmeans" in DRIVERS[name]:
    for b in (False, True):
        fits[f"kmeans{int(b)}"] = dc.kmeans_distributed_stream(
            mesh, axes, st, jnp.asarray(KINIT), K, max_iters=6, tol=1e-4, bounded=b)
if "bkc" in DRIVERS[name]:
    for b in (False, True):
        fits[f"bkc{int(b)}"] = dc.bkc_distributed_stream(
            mesh, axes, st, jnp.asarray(KBINIT), BIG_K, K, bounded=b)
if "buckshot" in DRIVERS[name]:
    fits["buckshot"] = dc.buckshot_distributed_stream(mesh, axes, st, K, key, sample_size=S,
                                                      kmeans_iters=3)
for fit, r in fits.items():
    for f in ("centers", "assignment", "rss"):
        out[f"{fit}/{f}"] = np.asarray(getattr(r, f))
    out[f"{fit}/iterations"] = np.asarray(r.iterations)
rrows, rgidx = dc.reservoir_sample_distributed_stream(mesh, axes, st, S, key)
out["reservoir/rows"], out["reservoir/gidx"] = np.asarray(rrows), np.asarray(rgidx)

c = synth.make_corpus(N_DOCS, **CORPUS)
cst, _ = synth.stream_corpus(N_DOCS, chunk=chunk, **CORPUS)
stats = tfidf.df_fold_distributed(mesh, axes, cst)
out["tfidf/df"], out["tfidf/n"] = np.asarray(stats["df"]), np.asarray(stats["n"])
cp, w = pad_rows_to_multiple(jnp.asarray(c.counts), world)
out["tfidf/rows"] = np.asarray(tfidf.tfidf_distributed(mesh, axes, sh(cp), sh(w)))
out["tfidf/stream"] = tfidf.tfidf_distributed_stream(mesh, axes, cst).materialize()
prep = pipeline.prepare_synthetic(mesh, axes, n_docs=N_DOCS, **CORPUS)
out["prep/x"], out["prep/w"] = np.asarray(prep.x), np.asarray(prep.w)
out["prep/labels"] = np.asarray(prep.labels)
np.savez(sys.argv[1], **out)
"""

_TORCH = """
import torch
import torch.distributed as dist
from repro_torch.core import sampling
from repro_torch.distrib import cluster as dc
from repro_torch.distrib import hac_parallel as hp
from repro_torch.distrib.engine import make_fold_job
from repro_torch.distrib.sharding import (make_flat_mesh, make_pod_mesh, pad_rows_to_multiple,
                                          shard_rows)
from repro_torch.kernels import ops
from repro_torch.resilience import MemoryCheckpointer
from repro_torch.testing import faults
from repro_torch.text import pipeline, synth, tfidf
from repro_torch.text.stream import CorpusStream

rank, world, init, path, upath = int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6]
assert "jax" not in sys.modules and "repro" not in sys.modules
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + init, rank=rank, world_size=world)
U = dict(np.load(upath))
folds = []  # chunks folded: one assign_stats or local_top_s call each
for mod, fn in ((ops, "assign_stats"), (ops, "assign_stats_bounded"), (sampling, "local_top_s")):
    setattr(mod, fn, lambda *a, _f=getattr(mod, fn), **kw: folds.append(1) or _f(*a, **kw))
out = {}

def save(prefix, r):
    for f in ("centers", "assignment", "rss"):
        out[f"{prefix}/{f}"] = getattr(r, f).numpy()
    out[f"{prefix}/iterations"] = np.asarray(r.iterations)

def mc(data, bcast):
    v = data["x"]
    top, pos = sampling.local_top_s(data["score"], FS)
    pos = pos.long()
    bw, brow, bcol = ops.component_best_edge(data["cw"], data["col"], data["rid"], data["comp"], FC)
    return {"sum": torch.sum(v), "min": torch.min(v), "max": torch.max(v), "rows": v * 2.0,
            "stats": {"a": torch.sum(v), "b": torch.sum(v * v)},
            "best": {"score": top, "tag": data["rid"][pos], "vec": data["vec"][pos]},
            "comp": {"w": bw, "row": brow, "col": bcol}}

for name, w_, kind, chunk in CONFIGS:
    if w_ != world:
        continue
    mesh, axes = (make_flat_mesh(), ("data",)) if kind == "flat" else (
        make_pod_mesh(2), ("pod", "data"))
    sh = lambda v: shard_rows(mesh, axes, torch.from_numpy(np.asarray(v)))
    p = lambda key: f"{name}/{key}"
    fold = make_fold_job(mesh, axes, mc, FOLD_KINDS)
    carry, rows = None, []
    fchunk = 8 * world
    for start in range(0, FN, fchunk):
        carry, so = fold.step(carry, {k: sh(v[start:start + fchunk]) for k, v in FDATA.items()})
        rows.append(so["rows"].numpy())
        assert so["sum"] is None and so["best"] is None
    res = fold.finalize(carry)
    assert res["rows"] is None
    out[p("fold/rows")] = np.concatenate(rows)
    for f in ("sum", "min", "max"):
        out[p(f"fold/{f}")] = res[f].numpy()
    for grp in ("stats", "best", "comp"):
        for f, v in res[grp].items():
            out[p(f"fold/{grp}/{f}")] = v.numpy()

    st = CorpusStream.from_array(KX, chunk=chunk)
    init_c, binit = torch.from_numpy(KINIT), torch.from_numpy(KBINIT)
    unif = lambda ci, shard: U[name][ci, shard]
    runs = {
        "kmeans0": lambda ck=None: dc.kmeans_distributed_stream(
            mesh, axes, st, init_c, K, max_iters=6, tol=1e-4, bounded=False, checkpoint=ck),
        "kmeans1": lambda ck=None: dc.kmeans_distributed_stream(
            mesh, axes, st, init_c, K, max_iters=6, tol=1e-4, bounded=True, checkpoint=ck),
        "bkc0": lambda ck=None: dc.bkc_distributed_stream(
            mesh, axes, st, binit, BIG_K, K, bounded=False, checkpoint=ck),
        "bkc1": lambda ck=None: dc.bkc_distributed_stream(
            mesh, axes, st, binit, BIG_K, K, bounded=True, checkpoint=ck),
        "buckshot": lambda ck=None: dc.buckshot_distributed_stream(
            mesh, axes, st, K, uniforms=unif, sample_size=S, kmeans_iters=3, checkpoint=ck),
    }
    for fit, run in runs.items():
        if fit.rstrip("01") in DRIVERS[name]:
            save(p(fit), run())
    reservoir = lambda ck=None: dc.reservoir_sample_distributed_stream(
        mesh, axes, st, S, uniforms=unif, checkpoint=ck)
    rrows, rgidx = reservoir()
    out[p("reservoir/rows")], out[p("reservoir/gidx")] = rrows.numpy(), rgidx

    c = synth.make_corpus(N_DOCS, **CORPUS)
    cst, _ = synth.stream_corpus(N_DOCS, chunk=chunk, **CORPUS)
    stats = tfidf.df_fold_distributed(mesh, axes, cst)
    out[p("tfidf/df")], out[p("tfidf/n")] = stats["df"].numpy(), stats["n"].numpy()
    cp, w = pad_rows_to_multiple(torch.from_numpy(c.counts), world)
    out[p("tfidf/rows")] = tfidf.tfidf_distributed(mesh, axes, shard_rows(mesh, axes, cp),
                                                   shard_rows(mesh, axes, w)).numpy()
    out[p("tfidf/stream")] = tfidf.tfidf_distributed_stream(mesh, axes, cst).materialize()
    out[p("tfidf/single")] = tfidf.tfidf_stream(cst, device="cpu").materialize()
    prep = pipeline.prepare_synthetic(mesh, axes, n_docs=N_DOCS, **CORPUS)
    out[p("prep/x")], out[p("prep/w")] = prep.x.numpy(), prep.w.numpy()
    out[p("prep/labels")] = prep.labels
    if name != "flat4":
        continue

    # ---- the port against itself, at P = 4
    # one chunk of the padded rows against the resident fits
    one = CorpusStream.from_array(KX, chunk=N + (-N) % world)
    xp, w = pad_rows_to_multiple(torch.from_numpy(KX), world)
    save(p("one/kmeans"), dc.kmeans_distributed_stream(mesh, axes, one, init_c, K, max_iters=6,
                                                       tol=1e-4, bounded=False))
    save(p("res/kmeans"), dc.kmeans_distributed(mesh, axes, sh(xp), sh(w), init_c, K,
                                                max_iters=6, tol=1e-4, bounded=False))
    save(p("one/bkc"), dc.bkc_distributed_stream(mesh, axes, one, binit, BIG_K, K))
    save(p("res/bkc"), dc.bkc_distributed(mesh, axes, sh(xp), sh(w), binit, BIG_K, K))
    # prefetch off
    os.environ["REPRO_STREAM_PREFETCH"] = "0"
    save(p("off/kmeans1"), runs["kmeans1"]())
    save(p("off/buckshot"), runs["buckshot"]())
    del os.environ["REPRO_STREAM_PREFETCH"]

    # cut by raise@gN and resumed from each rank's MemoryCheckpointer (every=2)
    def cut(run, spec):
        ck = MemoryCheckpointer(every=2)
        try:
            with faults.inject(spec):
                run(ck)
        except faults.InjectedFault:
            return ck
        raise AssertionError(f"{spec} did not cut the run")

    def resume(key, run, spec, ck=None):
        folds.clear()
        run()
        total = len(folds)
        ck = ck or cut(run, spec)
        folds.clear()
        r = run(ck)
        out[p(f"resume/{key}/folds")] = np.asarray([total, len(folds)])
        out[p(f"resume/{key}/left")] = np.asarray(len(ck._store))
        return r

    for fit, spec in (("kmeans0", "raise@g8"), ("kmeans1", "raise@g9"), ("bkc0", "raise@g8"),
                      ("bkc1", "raise@g3"), ("buckshot", "raise@g14")):
        save(p(f"resume/{fit}"), resume(fit, runs[fit], spec))
    r = resume("reservoir", reservoir, "raise@g3")
    out[p("resume/reservoir/rows")], out[p("resume/reservoir/gidx")] = r[0].numpy(), r[1]
    # ranks whose snapshots name different chunks cold-start the pass
    ck = cut(runs["kmeans0"], "raise@g8")
    if rank == 1:
        ck.scoped("rank1").delete("kmeans/iter1")
    save(p("resume/mismatch"), resume("mismatch", runs["kmeans0"], None, ck))

    # the checkpointed Borůvka loop (sharded sweep) cut in round 4
    xs = torch.from_numpy(np.random.default_rng(1).normal(size=(70, 16)).astype(np.float32))
    merge = hp._merge_round_comp
    calls, cut_at = [], []

    def counted(*a, **kw):
        calls.append(1)
        if len(calls) == (cut_at or [0])[0]:
            raise faults.InjectedFault("cut")
        return merge(*a, **kw)

    hp._merge_round_comp = counted
    e_want = hp.boruvka_mst_distributed(mesh, axes, xs)
    rounds = len(calls)
    ck = MemoryCheckpointer()
    calls.clear()
    cut_at.append(5)
    try:
        hp.boruvka_mst_distributed(mesh, axes, xs, checkpoint=ck)
    except faults.InjectedFault:
        pass
    snap = sorted(ck._store)
    calls.clear()
    cut_at.clear()
    e_got = hp.boruvka_mst_distributed(mesh, axes, xs, checkpoint=ck)
    hp._merge_round_comp = merge
    out[p("boruvka/rounds")] = np.asarray([rounds, len(calls), len(snap), len(ck._store)])
    for f in ("u", "v", "w", "valid"):
        out[p(f"boruvka/want/{f}")] = getattr(e_want, f).numpy()
        out[p(f"boruvka/got/{f}")] = getattr(e_got, f).numpy()
dist.destroy_process_group()
np.savez(path, **out)
"""


def _script(body):
    common = (_COMMON.replace("__CONFIGS__", repr(CONFIGS))
              .replace("__FITS__", repr((N, D, K, BIG_K, S))).replace("__FOLD__", repr((FN, FS, FC))))
    return common + body.replace("__KEY__", repr(KEY))


def _env(**extra):
    drop = ("REPRO_FAULTS", "REPRO_ASSIGN_BOUNDS", "REPRO_STREAM_PREFETCH")
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu", **extra)
    return env


def _jax_uniforms(world, chunk):
    """The JAX package's reservoir draws: chunk ci on shard p takes
    ``uniform(fold_in(fold_in(key, ci), p), (chunk / P,))``; (chunks, P,
    chunk / P)."""
    key = jax.random.PRNGKey(KEY)
    return np.stack([
        np.stack([np.asarray(jax.random.uniform(
            jax.random.fold_in(jax.random.fold_in(key, ci), p), (chunk // world,)))
            for p in range(world)])
        for ci in range(-(-N // chunk))
    ])


@pytest.fixture(scope="module", autouse=True)
def _multirank_procs(tmp_path_factory):
    """A JAX subprocess on four forced host devices for each mesh and the
    gloo ranks of worlds 4 and 3, started with the module's first test so
    that they run beside the in-process tests. Output goes to files (a full
    pipe would block a rank)."""
    tmp = tmp_path_factory.mktemp("stream_multirank")
    np.savez(tmp / "u.npz", **{name: _jax_uniforms(world, chunk)
                               for name, world, _, chunk in CONFIGS})
    procs = {}

    def start(name, args, env):
        with open(tmp / f"{name}.log", "w") as log:
            procs[name] = subprocess.Popen([sys.executable, "-c", *args], env=env,
                                           stdout=log, stderr=subprocess.STDOUT, cwd=ROOT)

    try:
        for name, *_ in CONFIGS:
            start(f"jax_{name}", [_script(_JAX), str(tmp / f"jax_{name}.npz"), name],
                  _env(XLA_FLAGS="--xla_force_host_platform_device_count=4"))
        for world in (4, 3):
            for r in range(world):
                start(f"w{world}r{r}", [_script(_TORCH), str(r), str(world),
                                        str(tmp / f"init{world}"), str(tmp / f"w{world}r{r}.npz"),
                                        str(tmp / "u.npz")], _env())
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
    return {name: dict(np.load(tmp / f"{name}.npz")) for name in procs}


def _ranks(multirank, world):
    return [multirank[f"w{world}r{r}"] for r in range(world)]


def _blocks(ranks, key):
    return np.concatenate([r[key] for r in ranks])


@pytest.mark.parametrize("name,world,kind,chunk", CONFIGS)
def test_fold_kinds_match_jax(multirank, name, world, kind, chunk):
    """Every fold kind over chunks, kinds at a prefix of the output tree:
    sum/min/max and the 'stats' subtree exact on integer rows, 'shard' rows
    in row-block order, 'topk' (owner-scatter finalize; on the pod mesh the
    owner spans two axes) with the reference's tie order, and the
    'component' (w desc, row asc) winners."""
    want = multirank[f"jax_{name}"]
    ranks = _ranks(multirank, world)
    local = ranks[0][f"{name}/fold/rows"].shape[0]
    np.testing.assert_array_equal(  # chunk by chunk, each rank's 8-row block
        np.concatenate([r[f"{name}/fold/rows"][i:i + 8] for i in range(0, local, 8)
                        for r in ranks]),
        want["fold/rows"])
    for r in ranks:
        for f in ("sum", "min", "max", "stats/a", "stats/b", "best/score", "best/tag",
                  "best/vec", "comp/w", "comp/row", "comp/col"):
            np.testing.assert_array_equal(r[f"{name}/fold/{f}"], want[f"fold/{f}"], err_msg=f)


FITS = ["kmeans0", "kmeans1", "bkc0", "bkc1", "buckshot"]


def _same_fit(got, want, prefix_got, prefix_want="", exact=False):
    np.testing.assert_array_equal(got[f"{prefix_got}/assignment"],
                                  want[f"{prefix_want}assignment"])
    assert int(got[f"{prefix_got}/iterations"]) == int(want[f"{prefix_want}iterations"])
    if exact:
        for f in ("centers", "rss"):
            np.testing.assert_array_equal(_bits(got[f"{prefix_got}/{f}"]),
                                          _bits(want[f"{prefix_want}{f}"]), err_msg=f)
    else:
        np.testing.assert_allclose(got[f"{prefix_got}/centers"], want[f"{prefix_want}centers"],
                                   rtol=0, atol=CENTER_ATOL)
        np.testing.assert_allclose(got[f"{prefix_got}/rss"], want[f"{prefix_want}rss"],
                                   rtol=RSS_RTOL)


# the pod mesh runs K-Means only (its owner-scatter reservoir is below)
DRIVER_CASES = [(name, world, fit) for name, world, _, _ in CONFIGS for fit in FITS
                if name != "pod22" or fit.startswith("kmeans")]


@pytest.mark.parametrize("name,world,fit", DRIVER_CASES)
def test_stream_drivers_match_jax(multirank, name, world, fit):
    """kmeans_distributed_stream and bkc_distributed_stream (bounded and
    not) and buckshot_distributed_stream (the reservoir fed the JAX
    package's uniforms) from the same rows, chunks and inits: the whole
    (n,) labels and the iteration count equal on every rank, centers and
    RSS within the measured bounds, and the same bits on every rank."""
    ranks = _ranks(multirank, world)
    for r in ranks:
        _same_fit(r, multirank[f"jax_{name}"], f"{name}/{fit}", f"{fit}/")
        for f in ("centers", "assignment", "rss"):
            np.testing.assert_array_equal(r[f"{name}/{fit}/{f}"], ranks[0][f"{name}/{fit}/{f}"])


@pytest.mark.parametrize("name,world,kind,chunk", CONFIGS)
def test_reservoir_matches_jax(multirank, name, world, kind, chunk):
    """The sharded reservoir fed the JAX package's per-(chunk, shard)
    uniforms: the same global ids in the same order and the same rows, on
    every rank (on the pod mesh the owner-scatter finalize decodes owners
    over two axes)."""
    want = multirank[f"jax_{name}"]
    for r in _ranks(multirank, world):
        np.testing.assert_array_equal(r[f"{name}/reservoir/gidx"], want["reservoir/gidx"])
        np.testing.assert_array_equal(r[f"{name}/reservoir/rows"], want["reservoir/rows"])
    gidx = want["reservoir/gidx"]
    assert len(set(gidx.tolist())) == S and gidx.max() < N


@pytest.mark.parametrize("name,world,kind,chunk", CONFIGS)
def test_tfidf_and_prepare_synthetic_match_jax(multirank, name, world, kind, chunk):
    """df_fold_distributed's df and n exact; tfidf_distributed's rows (each
    rank's block), tfidf_distributed_stream's chunks and prepare_synthetic's
    rows within 5 ulp of the JAX package's, its weights and labels equal;
    the streamed rows equal the port's single-device tfidf_stream bit for
    bit."""
    want = multirank[f"jax_{name}"]
    ranks = _ranks(multirank, world)
    for r in ranks:
        np.testing.assert_array_equal(r[f"{name}/tfidf/df"], want["tfidf/df"])
        np.testing.assert_array_equal(r[f"{name}/tfidf/n"], want["tfidf/n"])
        assert _ulps(r[f"{name}/tfidf/stream"], want["tfidf/stream"]) <= TFIDF_ULP
        np.testing.assert_array_equal(r[f"{name}/tfidf/stream"], r[f"{name}/tfidf/single"])
        np.testing.assert_array_equal(r[f"{name}/prep/labels"], want["prep/labels"])
    assert _ulps(_blocks(ranks, f"{name}/tfidf/rows"), want["tfidf/rows"]) <= TFIDF_ULP
    assert _ulps(_blocks(ranks, f"{name}/prep/x"), want["prep/x"]) <= TFIDF_ULP
    np.testing.assert_array_equal(_blocks(ranks, f"{name}/prep/w"), want["prep/w"])


@pytest.mark.parametrize("fit", ["kmeans", "bkc"])
def test_one_chunk_stream_equals_resident_fit(multirank, fit):
    """At P = 4, a stream of one chunk (the padded rows) equals the resident
    distributed fit bit for bit; the resident fit returns each rank's block
    of labels, the stream the whole (n,) labels."""
    for rank, r in enumerate(_ranks(multirank, 4)):
        b = r[f"flat4/res/{fit}/assignment"].shape[0]
        np.testing.assert_array_equal(r[f"flat4/one/{fit}/assignment"][rank * b:(rank + 1) * b],
                                      r[f"flat4/res/{fit}/assignment"][: N - rank * b])
        for f in ("centers", "rss", "iterations"):
            np.testing.assert_array_equal(r[f"flat4/one/{fit}/{f}"], r[f"flat4/res/{fit}/{f}"])


@pytest.mark.parametrize("fit", ["kmeans1", "buckshot"])
def test_prefetch_off_equals_on(multirank, fit):
    for r in _ranks(multirank, 4):
        _same_fit(r, {f"{f}": r[f"flat4/{fit}/{f}"] for f in ("centers", "assignment", "rss",
                                                              "iterations")},
                  f"flat4/off/{fit}", exact=True)


# (fit, chunks re-folded on the resumed run beyond those after the cut):
# the cut at gN leaves N chunks folded, a snapshot every 2 chunks of a pass
RESUMES = [("kmeans0", 8, 0), ("kmeans1", 9, 1), ("bkc0", 8, 0), ("bkc1", 3, 1),
           ("buckshot", 14, 0), ("reservoir", 3, 1), ("mismatch", 8, 2)]


@pytest.mark.parametrize("fit,cut,refold", RESUMES)
def test_cut_runs_resume_bit_for_bit(multirank, fit, cut, refold):
    """Each driver cut by raise@gN at P = 4 and rerun on each rank's
    MemoryCheckpointer gives the uninterrupted run's bits, folds only the
    chunks after its snapshot (the passes before come from stored results)
    and leaves the store empty, but for the reservoir's own sample, which
    rank 0 keeps as its result until a caller's run ends. 'mismatch': rank 1
    lost its snapshot, so the ranks disagree and every rank cold-starts the
    killed pass."""
    for rank, r in enumerate(_ranks(multirank, 4)):
        total, folded = r[f"flat4/resume/{fit}/folds"]
        # the reservoir's 6 chunks before Buckshot's cut were folded and
        # counted, and its resumed run replays the sample from its result
        assert folded == total - cut + refold, (total, folded)
        assert int(r[f"flat4/resume/{fit}/left"]) == (fit == "reservoir" and rank == 0)
        if fit == "reservoir":
            np.testing.assert_array_equal(r["flat4/resume/reservoir/gidx"],
                                          r["flat4/reservoir/gidx"])
            np.testing.assert_array_equal(r["flat4/resume/reservoir/rows"],
                                          r["flat4/reservoir/rows"])
        else:
            want = {f: r[f"flat4/{'kmeans0' if fit == 'mismatch' else fit}/{f}"]
                    for f in ("centers", "assignment", "rss", "iterations")}
            _same_fit(r, want, f"flat4/resume/{fit}", exact=True)


def test_boruvka_checkpoint_resumes_several_ranks(multirank):
    """The sharded sweep's Borůvka loop at P = 4, cut in round 4, resumes
    from the round-2 snapshot (the comp slices gathered from every rank,
    written by rank 0 only) and gives the uninterrupted edges bit for bit."""
    for rank, r in enumerate(_ranks(multirank, 4)):
        rounds, resumed, snaps, left = r["flat4/boruvka/rounds"]
        assert (rounds, resumed, left) == (6, 3, 0)
        assert snaps == (1 if rank == 0 else 0)
        for f in ("u", "v", "w", "valid"):
            np.testing.assert_array_equal(r[f"flat4/boruvka/got/{f}"], r[f"flat4/boruvka/want/{f}"])


_KILL = """
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distrib import cluster as dc
from repro_torch.distrib.sharding import make_flat_mesh
from repro_torch.kernels import ops
from repro_torch.resilience import DiskCheckpointer
from repro_torch.text.stream import CorpusStream

assert "jax" not in sys.modules and "repro" not in sys.modules
rank, init, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + init, rank=rank, world_size=2)
folds = []
ops.assign_stats = lambda *a, _f=ops.assign_stats, **kw: folds.append(1) or _f(*a, **kw)
x = np.load(os.environ["X"])
st = CorpusStream.from_array(x, chunk=40)
init_c = torch.from_numpy(np.load(os.environ["INIT"]))
mesh = make_flat_mesh()
fit = lambda ck: dc.kmeans_distributed_stream(mesh, ("data",), st, init_c, 5, max_iters=6,
                                              tol=1e-4, checkpoint=ck)
got = fit(DiskCheckpointer(os.environ["CKPT_DIR"], every=2))
resumed = len(folds)
folds.clear()
want = fit(None)
np.savez(out, folds=np.asarray([len(folds), resumed]), iterations=[got.iterations, want.iterations],
         **{f"{k}_{f}": getattr(r, f).numpy() for k, r in (("got", got), ("want", want))
            for f in ("centers", "assignment", "rss")})
dist.destroy_process_group()
"""


def test_sigkilled_two_ranks_resume_from_disk(tmp_path, rng):
    """Two gloo ranks of kmeans_distributed_stream, SIGKILLed by kill@g8
    (iteration 1's chunk 2; prefetch off, so each rank's snapshot at chunk 2
    is on disk before its producer reaches the fault), both die by signal
    9 leaving snapshot files in one shared DiskCheckpointer directory; rerun
    without the fault they resume from iteration 0's stored result and the
    ranks' agreed snapshot, fold only the chunks after it, leave no .ckpt,
    and equal an uninterrupted run bit for bit."""
    x = _unit_blobs(rng, n=N, d=D)
    np.save(tmp_path / "x.npy", x)
    np.save(tmp_path / "init.npy", x[rng.choice(N, 5, replace=False)])
    ckpt = tmp_path / "ckpt"
    env = _env(X=str(tmp_path / "x.npy"), INIT=str(tmp_path / "init.npy"), CKPT_DIR=str(ckpt),
               REPRO_STREAM_PREFETCH="0")

    def launch(tag, extra):
        procs = [subprocess.Popen(
            [sys.executable, "-c", _KILL, str(r), str(tmp_path / f"init_{tag}"),
             str(tmp_path / f"{tag}{r}.npz")], env={**env, **extra}, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
        try:
            return [(p.wait(timeout=TIMEOUT), p.stdout.read()) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()

    for rc, log in launch("killed", {"REPRO_FAULTS": "kill@g8"}):
        assert rc == -signal.SIGKILL, f"expected a SIGKILL death, got rc={rc}\n{log}"
    names = sorted(os.listdir(ckpt))
    assert [n for n in names if n.startswith("snap_rank0")] and [
        n for n in names if n.startswith("snap_rank1")], names
    for rc, log in launch("resumed", {}):
        assert rc == 0, log
    assert not [n for n in os.listdir(ckpt) if n.endswith(".ckpt")]
    for r in range(2):
        out = np.load(tmp_path / f"resumed{r}.npz")
        total, resumed = out["folds"]
        assert resumed == total - 8, (total, resumed)
        assert out["iterations"][0] == out["iterations"][1]
        for f in ("centers", "assignment", "rss"):
            np.testing.assert_array_equal(out[f"got_{f}"], out[f"want_{f}"], err_msg=f)
