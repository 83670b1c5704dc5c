"""bf16 document rows through the port's distributed resident routes,
against the JAX package, on the CPU: ``sample_rows_distributed``, every mode
of ``boruvka_mst_distributed`` and ``single_link_labels_distributed``,
``kmeans_distributed`` (f32 and bf16 initial centers, bounded or not),
``bkc_distributed`` (fused and bounded) and ``buckshot_distributed``
(``hac="replicated"`` and ``"boruvka"``) on bf16 shards, and
``pad_rows_to_multiple`` on bf16 rows.

World size 1: a gloo group of one rank in this process against the JAX
package on a one-device mesh. Several ranks: gloo ranks in subprocesses
(P = 4 flat, a (2, 2) pod mesh, P = 3 with padded rows). The JAX side of
each mesh, the one-device mesh too, runs in a subprocess of its own on four
forced host devices, as ``tests/test_torch_distrib.py`` runs them: their
compiles take most of the time, so they run side by side, beside the
in-process tests. Every subprocess has its own timeout.

Rows: ``test_torch_distrib.py``'s exact unit rows (integers over 8, norm 1)
are bf16 values, so every similarity is exact in any order and Borůvka's
edges must be EQUAL, weights included, to the JAX package's bf16 edges and
to the port's own f32 edges on the same rows. The cluster fits run on its
blob rows (``KX``) rounded to bf16 once, with the tolerances of
``tests/test_torch_bf16_routes.py``: labels equal, centers within 1e-6, RSS
within 1e-4 relative, the cosine objective (a sum of n best similarities)
within n · 1e-5. Every result is f32, as the JAX package's.

The JAX package's Borůvka pre-warm compiles each round with f32 rows and
raises ``TypeError`` on a bf16 sample ("compiled with float32[...] and
called with bfloat16[...]"); ``single_link_labels_distributed`` turns it on
by default on a host with four or more CPUs. So the JAX side turns it off
(``_auto_prewarm``) and passes ``prewarm=False``, as the f32 tests do; the
port has no pre-warm.
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

from repro_torch import interop
from repro_torch.distrib.selftest import BF16_MODES

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 240  # seconds for each subprocess
CENTER_ATOL, RSS_RTOL, SIM_TOL = 1e-6, 1e-4, 1e-5


@pytest.fixture
def rng(request):
    """Seeded from the test's own name and parameters."""
    name = f"{request.module.__name__}::{request.node.name}"
    return np.random.default_rng(zlib.crc32(name.encode()))


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.int32)


def _same_edges(got, want, what=""):
    for f in ("u", "v", "valid"):
        np.testing.assert_array_equal(np.asarray(got[f]), np.asarray(want[f]),
                                      err_msg=f"{what} {f}")
    np.testing.assert_array_equal(_bits(got["w"]), _bits(want["w"]), err_msg=f"{what} w")


# the four candidate modes, then the sharded sweep's other settings
MODES = BF16_MODES
SAME_AS = {"no-overlap": "sharded"}  # overlap does not change the bits


# the cluster jobs' sizes: n rows, k clusters, BigK micro-clusters, s sample rows
CLUSTER = dict(cn=202, ck=5, cbk=16, cs=40)
FITS = ("kmeans", "kmeans_bf16_init", "kmeans_bounded", "kmeans_bounded_bf16_init",
        "bkc", "bkc_bounded", "buckshot_replicated", "buckshot_boruvka")
FIELDS = ("centers", "assignment", "rss", "objective", "iterations")
# (name, world, mesh, s, modes the JAX side runs): s = 70 does not divide
# over 4 or 3 shards; the port runs every mode on every mesh ("one" in this
# process, the others in gloo subprocesses)
CONFIGS = [
    ("one", 1, "flat", 40, ("sharded", "bcast", "point", "rowgather", "expanded")),
    ("flat4", 4, "flat", 70, ("sharded", "bcast", "point", "rowgather", "expanded")),
    ("pod22", 4, "pod", 70, ("sharded", "rowgather")),
    ("flat3", 3, "flat", 70, ("sharded", "rowgather")),
]
# The JAX side runs the fits on the one-device mesh and on a flat mesh of
# four, not on every mesh: its compiles would double this file's time. They
# run in the (2, 2) and P = 3 processes, whose Borůvka work is the least.
# The port's fits on every mesh of several ranks are held to the JAX
# package's fits on four (the same tolerances; each of those meshes pads the
# 202 rows to 204, so the labels line up).
JAX_FITS = {"pod22": ("one", 1), "flat3": ("flat4", 4)}  # process -> (key, world)
SEED = 17
SAMPLE_S = 30  # rows sampled by sample_rows_distributed on every mesh

# the rows, blobs and fits of both sides, from one source so that both see
# the same draws; `f32` is the package's cast to f32
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
MODES = {modes}
RK = np.random.default_rng(11)
KX = RK.normal(size=({ck}, 24))[RK.integers(0, {ck}, size={cn})] + 0.3 * RK.normal(size=({cn}, 24))
KX = (KX / np.linalg.norm(KX, axis=1, keepdims=True)).astype(np.float32)
KROWS = RK.choice({cn}, {ck}, replace=False)
KBROWS = RK.choice({cn}, {cbk}, replace=False)
KSROWS = RK.choice({cn}, {cs}, replace=False)
def cluster_fits(dc, mesh, axes, xp, w, key, xb, f32):
    init_b, binit, sample = xb[KROWS], xb[KBROWS], xb[KSROWS]
    init = f32(init_b)  # the same values as f32 initial centers
    def km(c, bounded):
        return lambda: dc.kmeans_distributed(mesh, axes, xp, w, c, {ck}, max_iters=6,
                                             tol=1e-4, bounded=bounded)
    def bs(hac):
        return lambda: dc.buckshot_distributed(mesh, axes, xp, w, {ck}, key, sample_size={cs},
                                               kmeans_iters=3, hac=hac, sample_rows=sample)
    return {{
        "kmeans": km(init, False),
        "kmeans_bf16_init": km(init_b, False),
        "kmeans_bounded": km(init, True),
        "kmeans_bounded_bf16_init": km(init_b, True),
        "bkc": lambda: dc.bkc_distributed(mesh, axes, xp, w, binit, {cbk}, {ck}, bounded=False),
        "bkc_bounded": lambda: dc.bkc_distributed(mesh, axes, xp, w, binit, {cbk}, {ck},
                                                  bounded=True),
        "buckshot_replicated": bs("replicated"),
        "buckshot_boruvka": bs("boruvka"),
    }}
"""

_JAX = """
import jax, jax.numpy as jnp
import repro.distrib.hac_parallel as jhp
from repro.core.hac import single_link_labels_boruvka
from repro.distrib import cluster as dc
from repro.distrib.sharding import make_flat_mesh, make_pod_mesh, pad_rows_to_multiple, shard_rows
# The pre-warm compiles every round with f32 rows and raises TypeError on a
# bf16 sample ("compiled with float32[...] and called with bfloat16[...]");
# single_link_labels_distributed (Buckshot's hac="boruvka") turns it on by
# default on a host with four or more CPUs.
jhp._auto_prewarm = lambda: False
out = {{}}
for name, world, kind, s, modes in {configs}:
    if name != sys.argv[2]:
        continue
    mesh, axes = (make_flat_mesh(world), ("data",)) if kind == "flat" else (
        make_pod_mesh(2, 2), ("pod", "data"))
    xs = jnp.asarray(XS[name], jnp.bfloat16)
    for mode in modes:
        e = jhp.boruvka_mst_distributed(mesh, axes, xs, prewarm=False, **MODES[mode])
        for f, v in e._asdict().items():
            out[f"{{name}}/{{mode}}/{{f}}"] = np.asarray(v)
    out[f"{{name}}/labels"] = np.asarray(jhp.single_link_labels_distributed(mesh, axes, xs, 9))
    out[f"{{name}}/resident"] = np.asarray(single_link_labels_boruvka(xs, 9))
    sh = lambda v: shard_rows(mesh, axes, v)
    xb = jnp.asarray(KX, jnp.bfloat16)
    xp, w = pad_rows_to_multiple(xb, world)
    rows = dc.sample_rows_distributed(mesh, axes, sh(xp), sh(w), {sample_s},
                                      jax.random.PRNGKey(1))
    out[f"{{name}}/sample/dtype"] = np.asarray(str(rows.dtype))
    out[f"{{name}}/sample/rows"] = np.asarray(rows.astype(jnp.float32))
    if name not in {jax_fits}:
        continue
    key, world = {jax_fits}[name]
    mesh, axes = make_flat_mesh(world), ("data",)
    sh = lambda v: shard_rows(mesh, axes, v)
    xp, w = pad_rows_to_multiple(xb, world)
    for fit, run in cluster_fits(dc, mesh, axes, sh(xp), sh(w), jax.random.PRNGKey(0), xb,
                                 lambda a: a.astype(jnp.float32)).items():
        res = run()
        for f in ("centers", "assignment", "rss", "objective"):
            out[f"{{key}}/{{fit}}/{{f}}"] = np.asarray(getattr(res, f))
        out[f"{{key}}/{{fit}}/iterations"] = np.asarray(res.iterations)
np.savez(sys.argv[1], **out)
"""

# the port's side of every mesh; the gloo subprocesses call it with their
# own group, the in-process tests with the group of one rank
_PORT = """
import torch
from repro_torch.distrib import cluster as dc
from repro_torch.distrib.hac_parallel import (boruvka_mst_distributed,
                                              single_link_labels_distributed)
from repro_torch.distrib.sharding import (make_flat_mesh, make_pod_mesh, pad_rows_to_multiple,
                                          shard_rows)
def port_side(name, kind, world, mesh):
    out = {{}}
    axes = ("data",) if kind == "flat" else ("pod", "data")
    xs = torch.from_numpy(XS[name]).bfloat16()
    for mode, kw in MODES.items():
        for dt, rows in (("bf16", xs), ("f32", xs.float())):
            e = boruvka_mst_distributed(mesh, axes, rows, **kw)
            for f, v in e._asdict().items():
                out[f"{{name}}/{{dt}}/{{mode}}/{{f}}"] = v.numpy()
    for key, pre in (("labels", True), ("labels_rg", False)):
        out[f"{{name}}/{{key}}"] = single_link_labels_distributed(
            mesh, axes, xs, 9, pre_reduce=pre).numpy()
    sh = lambda v: shard_rows(mesh, axes, v)
    xb = torch.from_numpy(KX).bfloat16()
    xp, w = pad_rows_to_multiple(xb, world)
    rows = dc.sample_rows_distributed(mesh, axes, sh(xp), sh(w), {sample_s}, 1)
    ids = dc.sample_indices_distributed(mesh, axes, sh(w), {sample_s}, 1).long()
    out[f"{{name}}/sample/dtype"] = np.asarray(str(rows.dtype))
    out[f"{{name}}/sample/bits"] = rows.view(torch.int16).numpy()
    out[f"{{name}}/sample/want"] = xp[ids].view(torch.int16).numpy()
    for fit, run in cluster_fits(dc, mesh, axes, sh(xp), sh(w), 0, xb,
                                 lambda t: t.float()).items():
        res = run()
        out[f"{{name}}/{{fit}}/dtype"] = np.asarray(str(res.centers.dtype))
        for f in ("centers", "rss", "objective"):
            out[f"{{name}}/{{fit}}/{{f}}"] = getattr(res, f).float().numpy()
        out[f"{{name}}/{{fit}}/assignment"] = res.assignment.numpy()
        out[f"{{name}}/{{fit}}/iterations"] = np.asarray(res.iterations)
    return out
"""

_RANK = """
import torch.distributed as dist
rank, world, init, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + init, rank=rank, world_size=world)
out = {{}}
for name, w_, kind, s, _ in {configs}:
    if w_ == world:
        mesh = make_flat_mesh() if kind == "flat" else make_pod_mesh(2)
        out.update(port_side(name, kind, world, mesh))
dist.destroy_process_group()
np.savez(path, **out)
"""


def _script(*bodies):
    fmt = dict(seed=SEED, configs=repr(CONFIGS), modes=repr(MODES), sample_s=SAMPLE_S,
               jax_fits=repr(JAX_FITS), **CLUSTER)
    return "".join(textwrap.dedent(b.format(**fmt)) for b in (_COMMON, *bodies))


def _env(**extra):
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
                JAX_PLATFORMS="cpu", **extra)


@pytest.fixture(scope="module", autouse=True)
def _multirank_procs(tmp_path_factory):
    """A JAX subprocess on four forced host devices for each mesh and the
    gloo ranks of world sizes 4 and 3, started with the module's first test
    so that they run beside the in-process tests. Output goes to files (a
    full pipe would block a rank)."""
    tmp = tmp_path_factory.mktemp("multirank_bf16")
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
        rank_script = _script(_PORT, _RANK)
        for world in (4, 3):
            for r in range(world):
                start(f"w{world}r{r}", [rank_script, str(r), str(world),
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


def _ns():
    """The names the subprocesses see (rows, blobs, ``cluster_fits``,
    ``port_side``), in this process."""
    ns: dict = {}
    exec(_script(_PORT), ns)
    return ns


# ------------------------------------------------------ world size 1, in process


@pytest.fixture(scope="module")
def world_1(tmp_path_factory):
    """The port's side of the one-rank mesh, in a gloo group of one rank in
    this process (destroyed after)."""
    from repro_torch.distrib.sharding import make_flat_mesh

    store = dist.FileStore(str(tmp_path_factory.mktemp("world1") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        return _ns()["port_side"]("one", "flat", 1, make_flat_mesh())
    finally:
        dist.destroy_process_group()


def test_pad_rows_to_multiple_keeps_bf16_rows(rng):
    """bf16 rows stay bf16, pad rows are zeros, the weights f32."""
    from repro.distrib.sharding import pad_rows_to_multiple as jpad
    from repro_torch.distrib.sharding import pad_rows_to_multiple

    jx = jnp.asarray(rng.normal(size=(10, 7)), jnp.bfloat16)
    for multiple in (1, 3, 4, 10, 16):
        xp, w = pad_rows_to_multiple(interop.data(jx, "cpu"), multiple)
        jxp, jw = jpad(jx, multiple)
        assert xp.dtype == torch.bfloat16 and w.dtype == torch.float32
        assert xp.shape[0] % multiple == 0
        np.testing.assert_array_equal(_bits(interop.to_numpy(xp)), _bits(jxp))
        np.testing.assert_array_equal(interop.to_numpy(w), np.asarray(jw))


def test_rows_carried_from_jax_are_the_ranks_rows():
    """The subprocesses round the rows to bf16 with torch, the in-process
    checks carry JAX's bf16 arrays through ``interop.data``: the same bits."""
    ns = _ns()
    for a in (ns["KX"], ns["XS"]["one"], ns["XS"]["flat3"]):
        got = interop.data(jnp.asarray(a, jnp.bfloat16), "cpu")
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), torch.from_numpy(a).bfloat16().view(torch.int16))


def _check_fit(got, want, n):
    """One fit of the port against the JAX package's: labels and iteration
    counts equal, centers within 1e-6, RSS within 1e-4 relative, the
    objective within n · 1e-5; f32 results."""
    assert got["centers"].dtype == np.float32 and want["centers"].dtype == np.float32
    np.testing.assert_array_equal(got["assignment"], want["assignment"])
    assert int(got["iterations"]) == int(want["iterations"])
    np.testing.assert_allclose(got["centers"], want["centers"], rtol=0, atol=CENTER_ATOL)
    np.testing.assert_allclose(got["rss"], want["rss"], rtol=RSS_RTOL)
    np.testing.assert_allclose(got["objective"], want["objective"], rtol=0, atol=n * SIM_TOL)


def _ranks(multirank, world_1, world):
    return [world_1] if world == 1 else [multirank[f"w{world}r{r}"] for r in range(world)]


# ------------------------------------------------------ every mesh


@pytest.mark.parametrize("name,world,kind,s,jax_modes", CONFIGS)
def test_boruvka_bf16_matches_jax_and_f32_mode(multirank, world_1, name, world, kind, s,
                                               jax_modes):
    """Every rank, every mode: the bf16 edges equal the port's f32 edges on
    the same rows and the JAX package's bf16 edges where it ran the mode;
    the labels at k = 9 (both candidate paths) equal the JAX package's
    distributed and resident labels."""
    want = multirank["jax"]
    np.testing.assert_array_equal(want[f"{name}/labels"], want[f"{name}/resident"])
    for r, got in enumerate(_ranks(multirank, world_1, world)):
        for mode in MODES:
            edges = {f: got[f"{name}/bf16/{mode}/{f}"] for f in ("u", "v", "w", "valid")}
            assert edges["w"].dtype == np.float32
            _same_edges(edges, {f: got[f"{name}/f32/{mode}/{f}"] for f in edges},
                        f"rank {r} {mode} f32 mode")
            ref_mode = SAME_AS.get(mode, mode)
            if ref_mode in jax_modes:
                _same_edges(edges, {f: want[f"{name}/{ref_mode}/{f}"] for f in edges},
                            f"rank {r} {mode} jax")
        for key in ("labels", "labels_rg"):
            np.testing.assert_array_equal(got[f"{name}/{key}"], want[f"{name}/labels"])


@pytest.mark.parametrize("name,world", [(c[0], c[1]) for c in CONFIGS])
def test_sample_rows_bf16_matches_jax(multirank, world_1, name, world):
    """Both packages return bf16 rows; the port's are its padded x's rows at
    the sampled ids, bit for bit, the same on every rank; the JAX package's
    are rows of the same bf16 collection (the draws differ: the fits take
    the rows through ``sample_rows=``)."""
    want = multirank["jax"]
    assert str(want[f"{name}/sample/dtype"]) == "bfloat16"
    xb = np.asarray(jnp.asarray(_ns()["KX"], jnp.bfloat16).astype(jnp.float32))
    pool = {r.tobytes() for r in xb}
    assert all(r.tobytes() in pool for r in want[f"{name}/sample/rows"])
    ranks = _ranks(multirank, world_1, world)
    first = ranks[0][f"{name}/sample/bits"]
    assert first.shape == (SAMPLE_S, 24)
    for got in ranks:
        assert str(got[f"{name}/sample/dtype"]) == "torch.bfloat16"
        np.testing.assert_array_equal(got[f"{name}/sample/bits"], got[f"{name}/sample/want"])
        np.testing.assert_array_equal(got[f"{name}/sample/bits"], first)


@pytest.mark.parametrize("name,world", [(c[0], c[1]) for c in CONFIGS])
@pytest.mark.parametrize("fit", FITS)
def test_cluster_fits_bf16_match_jax(multirank, world_1, name, world, fit):
    """Each rank's block of labels equals the JAX package's (on one device,
    or on four for every mesh of several ranks), the replicated results
    agree within the stated tolerances and are the same bits on every rank,
    and the centers are f32."""
    want = {f: multirank["jax"][f"{'one' if world == 1 else 'flat4'}/{fit}/{f}"]
            for f in FIELDS}
    assert want["assignment"].shape[0] % world == 0
    b = want["assignment"].shape[0] // world
    ranks = _ranks(multirank, world_1, world)
    for r, res in enumerate(ranks):
        got = {f: res[f"{name}/{fit}/{f}"] for f in FIELDS}
        assert str(res[f"{name}/{fit}/dtype"]) == "torch.float32"
        _check_fit(got, dict(want, assignment=want["assignment"][r * b:(r + 1) * b]),
                   CLUSTER["cn"])
        for f in ("centers", "rss", "objective"):
            np.testing.assert_array_equal(_bits(got[f]), _bits(ranks[0][f"{name}/{fit}/{f}"]))


@pytest.mark.parametrize("world", [4, 3])
def test_distributed_selftest_bf16(world):
    """``python -m repro_torch.distrib.selftest --bf16``: on exact unit rows
    every route on bf16 shards gives the f32 shards' bits (gloo ranks), and
    rank 0 reports bf16 tensors on the wire (the sample's row sum and the
    ring's rotated blocks) where the f32 mode sends f32."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.distrib.selftest", "--bf16", "--world", str(world),
         "--timeout", str(TIMEOUT)],
        capture_output=True, text=True, timeout=TIMEOUT + 30, env=_env(), cwd=ROOT,
    )
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr}"
    assert "SELFTEST OK: bf16" in out.stdout
    wire = dict(line.split(": ", 1) for line in out.stdout.splitlines()
                if line.startswith("rank 0 wire"))
    assert "all_reduce bfloat16" in wire["rank 0 wire bf16"]
    assert "isend bfloat16" in wire["rank 0 wire bf16"]
    assert "bfloat16" not in wire["rank 0 wire f32"]
