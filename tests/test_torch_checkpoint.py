"""The port's checkpointed streaming passes against the JAX package's, on the
CPU, in process.

The copies in ``repro_torch.resilience.checkpoint`` are held to the
originals on the same numpy data: fingerprint strings and array tokens
equal, snapshots and results round-trip through both packages, and both
stores invalidate (fingerprint, meta, pass id, corruption, version skew) in
the same cases. Then every streaming entry point of the port is cut with
``raise@gN`` inside a pass, once or more, and resumed from a
``MemoryCheckpointer``: the resumed result must equal the port's
uninterrupted run bit for bit, the resumed pass must fold only the chunks
after its snapshot, and the store must be empty at the end. On
integer-valued counts the port's cut and resumed K-Means and BKC equal the
JAX package's cut and resumed fits from the same initial centers: labels,
iterations and groups equal, centers within 1e-6, RSS within 1e-5 relative
(after the first exact pass the two packages' f32 products may differ in
the last bits).
"""

from __future__ import annotations

import os
import pickle
import sys
import zlib
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.bkc  # noqa: F401  (the modules, not the re-exported functions)
import repro.core.kmeans  # noqa: F401
import repro_torch.core.bkc  # noqa: F401
import repro_torch.core.buckshot  # noqa: F401
import repro_torch.core.kmeans  # noqa: F401
from repro import resilience as jres
from repro.core import sampling as jsampling
from repro.testing import faults as jfaults
from repro.text import stream as jstream
from repro.text import synth as jsynth
from repro_torch import interop
from repro_torch import resilience as res
from repro_torch.core import sampling
from repro_torch.resilience import checkpoint as ckpt
from repro_torch.testing import faults
from repro_torch.testing.faults import InjectedFault
from repro_torch.text import tfidf
from repro_torch.text.stream import CorpusStream, run_pass

jk, jbk = (sys.modules[f"repro.core.{m}"] for m in ("kmeans", "bkc"))
tk, tbk, tbs = (sys.modules[f"repro_torch.core.{m}"] for m in ("kmeans", "bkc", "buckshot"))

N, D, CHUNK = 600, 16, 64  # 10 chunks, the last with 40 pad rows
NCH = -(-N // CHUNK)


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


@pytest.fixture
def rng(request):
    """This module's generator, seeded from the test's own name (and its
    parameters), so its draws do not depend on the test order."""
    name = f"{request.module.__name__}::{request.node.name}"
    return np.random.default_rng(zlib.crc32(name.encode()))


def _rows(rng, n=N, d=D, topics=6):
    """Unit rows around ``topics`` directions (f32 numpy)."""
    c = rng.standard_normal((topics, d))
    x = c[rng.integers(0, topics, n)] + 0.3 * rng.standard_normal((n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _cpu(a):
    return interop.data(a, "cpu")


def _equal(a, b, fields):
    for f in fields:
        assert torch.equal(torch.as_tensor(getattr(a, f)), torch.as_tensor(getattr(b, f))), f


KM_FIELDS = ("centers", "assignment", "best_sim", "rss", "objective")
BKC_FIELDS = KM_FIELDS + ("group_of_mc", "threshold")


def _cut(run, specs, ck, fault_module=faults):
    """Run ``run(ck)`` once per spec with that fault armed (each must raise
    the injected fault and leave a snapshot or a result behind), then once
    without: the resumed result."""
    for spec in specs:
        with fault_module.inject(spec) as plan:
            with pytest.raises(Exception) as err:
                run(ck)
        assert "injected producer fault" in str(err.value) and plan.fired("raise") == 1, spec
        assert ck._store, spec
    return run(ck)


# ------------------------------------------------------ the copies themselves


class _Pair(NamedTuple):
    a: object
    b: object


def _carries():
    """(name, make) pairs: each ``make`` maps an array constructor (numpy
    to tensor, or numpy to jax) to a carry of the same structure."""
    r = np.random.default_rng(0)
    f = r.standard_normal((5, 16)).astype(np.float32)
    i = r.integers(0, 9, (7,)).astype(np.int32)
    host = [r.standard_normal((3,)).astype(np.float32)]
    return {
        "stats": lambda t: ((t(f), t(f[0]), t(f[1]), t(f[2])), t(np.array(0.0, np.float32)),
                            host, []),
        "bounded": lambda t: (t(f), t(i), [], host, _Pair(t(i), t(f[:, 0])),
                              t(np.array(1.0, np.float32))),
        "dict": lambda t: {"b": t(i), "a": (t(f), [t(f)]), "c": 2.5},
        "scalar": lambda t: 0.0,
        "dtypes": lambda t: (t(i.astype(np.int64)), t(i > 3), t(f.astype(np.float64)),
                             t(np.zeros((0, 4), np.float32))),
        "host": lambda t: (f, i, None, "x"),
    }


@pytest.mark.parametrize("name", list(_carries()))
def test_carry_fingerprint_copy_equals_the_original(name):
    build = _carries()[name]
    got = res.carry_fingerprint(build(torch.from_numpy))
    assert got == jres.carry_fingerprint(build(np.asarray))
    if name != "dtypes":  # JAX without x64 holds int64 and float64 in 32 bits
        assert got == jres.carry_fingerprint(build(jnp.asarray))
    if name == "stats":
        assert got == ("((a(5, 16):float32,a(16,):float32,a(16,):float32,a(16,):float32),"
                       "a():float32,[*],[*])")


@pytest.mark.parametrize("kind", ["float32", "int32", "int64", "bool", "float64", "transposed",
                                  "empty", "bfloat16"])
def test_array_token_copy_equals_the_original(kind, rng):
    a = rng.standard_normal((6, 5)).astype(np.float32)
    if kind == "transposed":
        t, want = torch.from_numpy(a).T, jres.array_token(np.ascontiguousarray(a.T))
    elif kind == "empty":
        t, want = torch.zeros((0, 3)), jres.array_token(np.zeros((0, 3), np.float32))
    elif kind == "bfloat16":
        j = jnp.asarray(a, jnp.bfloat16)
        t = torch.from_numpy(np.asarray(j).view(np.int16).copy()).view(torch.bfloat16)
        want = jres.array_token(j)
    else:
        b = (a > 0) if kind == "bool" else (a * 100).astype(kind)
        t, want = torch.from_numpy(b), jres.array_token(b)
    assert res.array_token(t) == want
    if kind not in ("bfloat16", "transposed"):
        assert res.array_token(t.numpy()) == want
    if kind != "empty":
        assert res.array_token(t.flip(0)) != want


@pytest.mark.parametrize("store", ["memory", "disk"])
def test_snapshot_round_trips_through_both_packages(store, tmp_path, rng):
    f = rng.standard_normal((4, 8)).astype(np.float32)
    i = rng.integers(-5, 5, (4,)).astype(np.int32)
    blocks = [rng.standard_normal((3,)).astype(np.float32)]
    carry = ((torch.from_numpy(f), torch.from_numpy(i)), torch.tensor(1.5), blocks, [])
    jcarry = ((jnp.asarray(f), jnp.asarray(i)), jnp.float32(1.5), blocks, [])
    mk = {"memory": lambda m, sub: m.MemoryCheckpointer(every=3),
          "disk": lambda m, sub: m.DiskCheckpointer(tmp_path / sub, every=3)}[store]
    ck, jck = mk(res, "port"), mk(jres, "jax")
    meta = {"centers": res.array_token(f), "stream": {"n": 4}}
    fp = res.carry_fingerprint(carry)
    assert fp == jres.carry_fingerprint(jcarry)
    ck.save("p", chunk=6, carry_host=res.carry_to_host(carry), fingerprint=fp, meta=meta)
    jck.save("p", chunk=6, carry_host=jres.carry_to_host(jcarry), fingerprint=fp, meta=meta)
    snap, jsnap = ck.load("p", fingerprint=fp, meta=meta), jck.load("p", fingerprint=fp, meta=meta)
    assert snap["chunk"] == jsnap["chunk"] == 6 and snap["version"] == jsnap["version"] == 1
    (a, b), s, hb, empty = res.carry_from_host(snap["carry"])
    (ja, jb), js, jhb, jempty = jres.carry_from_host(jsnap["carry"])
    assert a.dtype == torch.float32 and b.dtype == torch.int32 and s.dtype == torch.float32
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    assert s.item() == float(js) == 1.5 and empty == jempty == []
    np.testing.assert_array_equal(hb[0], jhb[0])
    assert a.numpy().tobytes() == f.tobytes()
    ck.delete("p")
    jck.delete("p")
    for m in (ck, jck):
        assert m.load("p", fingerprint=fp, meta=meta) is None


@pytest.mark.parametrize("store", ["memory", "disk"])
def test_result_round_trips_through_both_packages(store, tmp_path, rng):
    c = rng.standard_normal((2, 3)).astype(np.float32)
    mk = {"memory": lambda m, sub: m.MemoryCheckpointer(),
          "disk": lambda m, sub: m.DiskCheckpointer(tmp_path / sub)}[store]
    ck, jck = mk(res, "port"), mk(jres, "jax")
    ck.save_result("iter0", {"token": res.array_token(torch.from_numpy(c)),
                             "centers": torch.from_numpy(c), "moved": 0.25}, meta={"m": 1})
    jck.save_result("iter0", {"token": jres.array_token(c), "centers": c, "moved": 0.25},
                    meta={"m": 1})
    got, want = ck.load_result("iter0", meta={"m": 1}), jck.load_result("iter0", meta={"m": 1})
    assert got["token"] == want["token"] and got["moved"] == want["moved"]
    assert isinstance(got["centers"], torch.Tensor)
    np.testing.assert_array_equal(got["centers"].numpy(), want["centers"])
    for m in (ck, jck):
        assert m.load_result("iter0", meta={"m": 2}) is None  # other meta
        assert m.load_result("missing") is None
        m.delete_result("iter0")
        assert m.load_result("iter0", meta={"m": 1}) is None


def test_carry_from_host_keeps_structure_dtype_and_places_leaves():
    bf = torch.tensor([1.5, -2.25, 3.0], dtype=torch.bfloat16)
    carry = {"p": _Pair(torch.arange(3, dtype=torch.int64), bf), "l": [torch.ones(2)], "f": 2.0}
    host = pickle.loads(pickle.dumps(res.carry_to_host(carry)))
    back = res.carry_from_host(host)
    assert isinstance(back["p"], _Pair) and back["f"] == 2.0 and isinstance(back["l"], list)
    assert back["p"].a.dtype == torch.int64 and back["p"].b.dtype == torch.bfloat16
    assert torch.equal(back["p"].b, bf) and torch.equal(back["l"][0], torch.ones(2))
    assert res.carry_fingerprint(back) == res.carry_fingerprint(carry)
    # the leaf's own device is only the default: ``device=`` places it
    host["l"][0].device = "cuda:3"
    assert res.carry_from_host(host, device="cpu")["l"][0].device.type == "cpu"


# ----------------------------------------------------------- invalidation


def _sum_fold(state, ch, ci):
    return state + float(np.sum(ch.x * ch.w[:, None]))


def _tensor_fold(state, ch, ci):
    return state + torch.from_numpy(ch.x * ch.w[:, None]).sum(0)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_checkpoint_invalidated_by_fingerprint_meta_and_pass_id(pkg, rng):
    x = rng.standard_normal((64, 8)).astype(np.float32)
    m, fl, rp = ((res, faults, run_pass) if pkg == "port"
                 else (jres, jfaults, jstream.run_pass))
    st = (CorpusStream if pkg == "port" else jstream.CorpusStream).from_array(x, chunk=16)
    ck = m.MemoryCheckpointer(every=1)
    with fl.inject("raise@c2"), pytest.raises(Exception, match="injected"):
        rp(st, _sum_fold, 0.0, pass_id="p", checkpoint=ck, meta={"token": "a"})
    fp = m.carry_fingerprint(0.0)
    full = {"stream": {"n": 64, "dim": 8, "chunk": 16}, "token": "a"}
    if pkg == "port":
        full["device"] = "cpu"  # the port's own key
    assert ck.load("p", fingerprint=fp, meta=full)["chunk"] == 2
    assert ck.load("p", fingerprint=fp, meta={**full, "token": "b"}) is None
    assert ck.load("p", fingerprint=m.carry_fingerprint((0.0, [])), meta=full) is None
    assert ck.load("q", fingerprint=fp, meta=full) is None
    # a resume under other meta starts cold and still gives the full sum
    assert rp(st, _sum_fold, 0.0, pass_id="p", checkpoint=ck, meta={"token": "b"}) == \
        rp(st, _sum_fold, 0.0)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_disk_corruption_and_version_skew_start_cold(pkg, tmp_path):
    m = res if pkg == "port" else jres
    ck = m.DiskCheckpointer(tmp_path, every=1)
    ck.save("p", chunk=3, carry_host=1.25, fingerprint="float", meta={})
    snap = ck.load("p", fingerprint="float", meta={})
    assert snap["chunk"] == 3 and snap["carry"] == 1.25
    (path,) = [p for p in os.listdir(tmp_path) if p.endswith(".ckpt")]
    assert path == jres.checkpoint._safe_name("snap/p") == ckpt._safe_name("snap/p")
    with open(tmp_path / path, "wb") as f:
        f.write(b"\x80garbage")
    assert ck.load("p", fingerprint="float", meta={}) is None
    for skew in ({"version": 999}, {"pass_id": "q"}, "not a dict"):
        state = {"version": 1, "pass_id": "p", "chunk": 3, "carry": 1.25,
                 "fingerprint": "float", "meta": {}}
        with open(tmp_path / path, "wb") as f:
            f.write(pickle.dumps({**state, **skew} if isinstance(skew, dict) else skew))
        assert ck.load("p", fingerprint="float", meta={}) is None
    ck.save_result("r", {"v": 1})
    (rpath,) = [p for p in os.listdir(tmp_path) if p.startswith("result")]
    with open(tmp_path / rpath, "wb") as f:
        f.write(b"torn")
    assert ck.load_result("r") is None
    ck.clear()
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".ckpt")]


def test_port_reads_a_torn_write_as_the_previous_snapshot(tmp_path):
    """A kill between the temporary file and the rename leaves only the
    temporary file: the previous snapshot is what a restart reads."""
    ck = res.DiskCheckpointer(tmp_path, every=1)
    ck.save("p", chunk=2, carry_host=1.0, fingerprint="float", meta={})
    (path,) = os.listdir(tmp_path)
    with open(tmp_path / f"{path}.tmp.123", "wb") as f:
        f.write(b"\x80half a pickle")
    assert ck.load("p", fingerprint="float", meta={})["chunk"] == 2


def test_scoped_checkpointers_keep_their_namespaces():
    for m in (res, jres):
        ck = m.MemoryCheckpointer(every=4)
        sub = ck.scoped("buckshot/")
        assert sub.every == 4
        sub.save("kmeans/iter0", chunk=1, carry_host=1.0, fingerprint="f", meta={})
        ck.save("kmeans/iter0", chunk=2, carry_host=2.0, fingerprint="f", meta={})
        sub.save_result("reservoir", 3.0)
        assert sub.load("kmeans/iter0", fingerprint="f", meta={})["carry"] == 1.0
        assert ck.load("kmeans/iter0", fingerprint="f", meta={})["carry"] == 2.0
        assert ck.load_result("reservoir") is None and sub.load_result("reservoir") == 3.0
        assert set(ck._store) == {"snap/buckshot/kmeans/iter0", "snap/kmeans/iter0",
                                  "result/buckshot/reservoir"}
        sub.delete("kmeans/iter0")
        assert ck.load("kmeans/iter0", fingerprint="f", meta={}) is not None


def _spy(store, every):
    """A ``store`` (either package's MemoryCheckpointer class) that records
    the chunk of every snapshot it saves."""

    class Spy(store):
        def save(self, pass_id, *, chunk, **kw):
            self.saved.append(chunk)
            super().save(pass_id, chunk=chunk, **kw)

    spy = Spy(every=every)
    spy.saved = []
    return spy


@pytest.mark.parametrize("every", [1, 2, 3, 9, 10, 11])
def test_cadence_is_the_reference_s(every, rng):
    """A snapshot after every ``every`` folded chunks, never after the last
    one, none left when the pass completes: as in the JAX package."""
    x = rng.standard_normal((150, 4)).astype(np.float32)  # 10 chunks of 15
    spy, jspy = _spy(res.MemoryCheckpointer, every), _spy(jres.MemoryCheckpointer, every)
    got = run_pass(CorpusStream.from_array(x, chunk=15), _sum_fold, 0.0, checkpoint=spy)
    want = jstream.run_pass(jstream.CorpusStream.from_array(x, chunk=15), _sum_fold, 0.0,
                            checkpoint=jspy)
    assert spy.saved == jspy.saved == [c for c in range(every, 10, every)]
    assert got == want and not spy._store and not jspy._store


def test_cadence_must_be_positive():
    for m in (res, jres):
        for bad in (0, -2):
            with pytest.raises(ValueError, match="positive"):
                m.MemoryCheckpointer(every=bad)


def test_snapshot_of_another_device_type_starts_cold(rng):
    """A snapshot whose meta names another device type (one taken on the
    card) is not resumed by a CPU pass."""
    x = rng.standard_normal((64, 8)).astype(np.float32)
    st = CorpusStream.from_array(x, chunk=16)
    ck = res.MemoryCheckpointer(every=1)
    carry = torch.zeros(8)
    meta = {"stream": {"n": 64, "dim": 8, "chunk": 16}, "device": "cuda"}
    ck.save("p", chunk=3, carry_host=res.carry_to_host(torch.full((8,), 1e6)),
            fingerprint=res.carry_fingerprint(carry), meta=meta)
    got = run_pass(st, _tensor_fold, carry, pass_id="p", checkpoint=ck)
    assert torch.equal(got, run_pass(st, _tensor_fold, carry))
    assert not ck._store


def test_restore_goes_to_the_pass_device_not_the_pickled_one(rng):
    """A snapshot's leaves are restored onto the live carry's device: a leaf
    recorded on a CUDA device resumes a CPU pass (same device type in the
    meta) on the CPU, without a card."""
    x = rng.standard_normal((64, 8)).astype(np.float32)
    st = CorpusStream.from_array(x, chunk=16)
    ck = res.MemoryCheckpointer(every=2)
    carry = torch.zeros(8)
    with faults.inject("raise@c3"), pytest.raises(InjectedFault):
        run_pass(st, _tensor_fold, carry, pass_id="p", checkpoint=ck)
    snap = pickle.loads(ck._store["snap/p"])
    assert snap["meta"]["device"] == "cpu" and snap["chunk"] == 2
    snap["carry"].device = "cuda:0"
    ck._store["snap/p"] = pickle.dumps(snap)
    got = run_pass(st, _tensor_fold, carry, pass_id="p", checkpoint=ck)
    assert got.device.type == "cpu" and torch.equal(got, run_pass(st, _tensor_fold, carry))


# ------------------------------------------------ cut and resumed entry points


def test_df_and_tfidf_stream_resume_bit_for_bit(rng):
    counts = rng.integers(0, 4, (N, D)).astype(np.float32)
    st = CorpusStream.from_array(counts, chunk=CHUNK)
    df, n = tfidf.df_stream(st, device="cpu")
    ck = res.MemoryCheckpointer(every=3)
    gdf, gn = _cut(lambda c: tfidf.df_stream(st, device="cpu", checkpoint=c), ["raise@g7"], ck)
    assert torch.equal(gdf, df) and torch.equal(gn, n) and not ck._store
    want = tfidf.tfidf_stream(st, device="cpu").materialize()
    got = _cut(lambda c: tfidf.tfidf_stream(st, device="cpu", checkpoint=c),
               ["raise@g4"], ck).materialize()
    assert got.tobytes() == want.tobytes() and not ck._store


def test_reservoir_resumes_and_replays_its_result(rng):
    x = _rows(rng)
    st = CorpusStream.from_array(x, chunk=CHUNK)
    gen = lambda: torch.Generator().manual_seed(11)  # noqa: E731
    rows, ids = sampling.reservoir_sample_stream(st, 40, gen(), device="cpu")
    ck = res.MemoryCheckpointer(every=2)
    grows, gids = _cut(lambda c: sampling.reservoir_sample_stream(
        st, 40, gen(), device="cpu", checkpoint=c), ["raise@g5", "raise@g7"], ck)
    assert torch.equal(grows, rows) and np.array_equal(gids, ids)
    assert list(ck._store) == ["result/reservoir"]
    # the stored sample is returned without a pass; another generator state
    # is another sample
    with faults.inject("raise@g0"):
        again = sampling.reservoir_sample_stream(st, 40, gen(), device="cpu", checkpoint=ck)
    assert torch.equal(again[0], rows) and np.array_equal(again[1], ids)
    other = sampling.reservoir_sample_stream(
        st, 40, torch.Generator().manual_seed(12), device="cpu", checkpoint=ck)
    assert not np.array_equal(other[1], ids)
    assert torch.equal(other[0], sampling.reservoir_sample_stream(
        st, 40, torch.Generator().manual_seed(12), device="cpu")[0])


def test_reservoir_with_draws_binds_to_them(rng):
    x = _rows(rng)
    st = CorpusStream.from_array(x, chunk=CHUNK)
    key = jax.random.PRNGKey(4)
    draws = lambda k: lambda ci: np.asarray(  # noqa: E731
        jax.random.uniform(jax.random.fold_in(k, ci), (CHUNK,)))
    want = sampling.reservoir_sample_stream(st, 25, uniforms=draws(key), device="cpu")
    ck = res.MemoryCheckpointer(every=4)
    got = _cut(lambda c: sampling.reservoir_sample_stream(
        st, 25, uniforms=draws(key), device="cpu", checkpoint=c), ["raise@g9"], ck)
    assert torch.equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    jwant = jsampling.reservoir_sample_stream(jstream.CorpusStream.from_array(x, chunk=CHUNK),
                                                25, key)
    np.testing.assert_array_equal(got[1], jwant[1])
    other = sampling.reservoir_sample_stream(st, 25, uniforms=draws(jax.random.PRNGKey(5)),
                                             device="cpu", checkpoint=ck)
    assert not np.array_equal(other[1], want[1])


def _km_specs(iters, bounded):
    """A cut inside iteration 2's pass (chunk 5; snapshot at 4), then, on
    the resumed run, inside the final pass (chunk 7; snapshot at 6): the
    resumed run serves iteration 2 from chunk 0 again, the later ones and
    the final pass."""
    assert iters >= 3
    return [f"raise@g{2 * NCH + 5}", f"raise@g{(iters - 2) * NCH + 7}"]


@pytest.mark.parametrize("bounded", [False, True])
def test_kmeans_fit_stream_resumes_bit_for_bit(bounded, rng, monkeypatch):
    x = _rows(rng)
    st = CorpusStream.from_array(x, chunk=CHUNK)
    init = _cpu(x[rng.choice(N, 6, replace=False)])
    want = tk.kmeans_fit_stream(st, init, 6, bounded=bounded)
    ck = res.MemoryCheckpointer(every=2)
    run = lambda c: tk.kmeans_fit_stream(st, init, 6, bounded=bounded, checkpoint=c)  # noqa: E731
    for spec in _km_specs(want.iterations, bounded):
        with faults.inject(spec), pytest.raises(InjectedFault):
            run(ck)
    # the resumed run folds only the final pass's chunks after its snapshot
    name = "_stream_fold_chunk_bounded" if bounded else "_stream_fold_chunk"
    real, folds = getattr(tk, name), []
    monkeypatch.setattr(tk, name, lambda *a, **kw: folds.append(1) or real(*a, **kw))
    got = run(ck)
    assert len(folds) == NCH - 6
    assert got.iterations == want.iterations
    _equal(got, want, KM_FIELDS)
    assert not ck._store


def test_kmeans_fit_stream_resume_replays_convergence_and_cold_starts_on_other_centers(rng):
    x = _rows(rng)
    st = CorpusStream.from_array(x, chunk=CHUNK)
    init = _cpu(x[rng.choice(N, 5, replace=False)])
    want = tk.kmeans_fit_stream(st, init, 5, max_iters=20, tol=1e-3)
    assert want.iterations < 20  # converged by tol
    ck = res.MemoryCheckpointer(every=3)
    final = want.iterations * NCH + 4
    got = _cut(lambda c: tk.kmeans_fit_stream(st, init, 5, max_iters=20, tol=1e-3, checkpoint=c),
               [f"raise@g{final}"], ck)
    assert got.iterations == want.iterations
    _equal(got, want, KM_FIELDS)
    # results keyed by other initial centers are never replayed
    other = _cpu(x[:5])
    with faults.inject(f"raise@g{NCH + 1}"), pytest.raises(InjectedFault):
        tk.kmeans_fit_stream(st, init, 5, checkpoint=ck)
    _equal(tk.kmeans_fit_stream(st, other, 5, checkpoint=ck), tk.kmeans_fit_stream(st, other, 5),
           KM_FIELDS)


@pytest.mark.parametrize("bounded", [False, True])
def test_bkc_fit_stream_resumes_bit_for_bit(bounded, rng):
    x = _rows(rng)
    st = CorpusStream.from_array(x, chunk=CHUNK)
    init = _cpu(x[rng.choice(N, 30, replace=False)])
    want = tbk.bkc_fit_stream(st, init, 30, 6, bounded=bounded)
    ck = res.MemoryCheckpointer(every=2)
    # inside pass 1 (chunk 5), then inside pass 3 of the resumed run (chunk 9)
    got = _cut(lambda c: tbk.bkc_fit_stream(st, init, 30, 6, bounded=bounded, checkpoint=c),
               ["raise@g5", f"raise@g{NCH + 9}"], ck)
    _equal(got, want, BKC_FIELDS)
    assert not ck._store


def test_buckshot_stream_resumes_bit_for_bit(rng):
    x = _rows(rng)
    st = CorpusStream.from_array(x, chunk=CHUNK)
    key = jax.random.PRNGKey(2)
    draws = lambda ci: np.asarray(  # noqa: E731
        jax.random.uniform(jax.random.fold_in(key, ci), (CHUNK,)))
    run = lambda c: tbs.buckshot_stream(st, 6, uniforms=draws, kmeans_iters=3,  # noqa: E731
                                        device="cpu", checkpoint=c)
    want = run(None)
    iters = want.kmeans.iterations
    assert iters >= 2
    ck = res.MemoryCheckpointer(every=2)
    # inside the reservoir pass (chunk 7); inside phase 2's iteration 1 of the
    # resumed run (the reservoir replayed from chunk 0, iteration 0 whole,
    # then chunk 3 of iteration 1); inside its final pass (iteration 1
    # replayed from chunk 0, the later iterations whole, then chunk 8)
    specs = ["raise@g7", f"raise@g{2 * NCH + 3}", f"raise@g{(iters - 1) * NCH + 8}"]
    got = _cut(run, specs, ck)
    assert torch.equal(got.sample_idx, want.sample_idx)
    assert torch.equal(got.sample_labels, want.sample_labels)
    assert torch.equal(got.init_centers, want.init_centers)
    _equal(got.kmeans, want.kmeans, KM_FIELDS)
    assert not ck._store


def test_kmeans_and_bkc_stream_resume_and_drop_the_reservoir(rng):
    x = _rows(rng)
    st = CorpusStream.from_array(x, chunk=CHUNK)
    gen = lambda: torch.Generator().manual_seed(6)  # noqa: E731
    ck = res.MemoryCheckpointer(every=2)
    want = tk.kmeans_stream(st, 6, gen(), device="cpu")
    # inside iteration 0's pass, after the reservoir
    got = _cut(lambda c: tk.kmeans_stream(st, 6, gen(), device="cpu", checkpoint=c),
               [f"raise@g{NCH + 5}"], ck)
    _equal(got, want, KM_FIELDS)
    assert not ck._store
    want = tbk.bkc_stream(st, 30, 6, gen(), device="cpu", bounded=True)
    got = _cut(lambda c: tbk.bkc_stream(st, 30, 6, gen(), device="cpu", bounded=True,
                                        checkpoint=c), [f"raise@g{NCH + 3}"], ck)
    _equal(got, want, BKC_FIELDS)
    assert not ck._store


# ------------------------------------------- against the JAX package's resume


def _both_streams(x):
    return CorpusStream.from_array(x, chunk=CHUNK), jstream.CorpusStream.from_array(x, chunk=CHUNK)


@pytest.fixture(scope="module")
def counts():
    """Integer-valued term counts (600 x 64, 6 topics) as f32 numpy."""
    return jsynth.make_corpus(N, vocab=64, n_topics=6, seed=3).counts.astype(np.float32)


def test_cut_and_resumed_kmeans_equals_the_jax_package_s(counts):
    x = counts
    init = x[np.random.default_rng(1).choice(N, 6, replace=False)]
    st, jst = _both_streams(x)
    want = tk.kmeans_fit_stream(st, _cpu(init), 6, max_iters=4, tol=0.0)
    specs = _km_specs(want.iterations, False)
    ck, jck = res.MemoryCheckpointer(every=2), jres.MemoryCheckpointer(every=2)
    got = _cut(lambda c: tk.kmeans_fit_stream(st, _cpu(init), 6, max_iters=4, tol=0.0,
                                              checkpoint=c), specs, ck)
    jgot = _cut(lambda c: jk.kmeans_fit_stream(jst, jnp.asarray(init), 6, max_iters=4, tol=0.0,
                                               checkpoint=c), specs, jck, jfaults)
    _equal(got, want, KM_FIELDS)
    assert got.iterations == int(jgot.iterations) == 4
    np.testing.assert_array_equal(got.assignment.numpy(), np.asarray(jgot.assignment))
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(jgot.centers), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(got.rss), float(jgot.rss), rtol=1e-5)
    assert not ck._store and not jck._store


def test_cut_and_resumed_bkc_equals_the_jax_package_s(counts):
    x = counts
    init = x[np.random.default_rng(2).choice(N, 30, replace=False)]
    st, jst = _both_streams(x)
    specs = ["raise@g5", f"raise@g{NCH + 9}"]
    ck, jck = res.MemoryCheckpointer(every=2), jres.MemoryCheckpointer(every=2)
    got = _cut(lambda c: tbk.bkc_fit_stream(st, _cpu(init), 30, 6, checkpoint=c), specs, ck)
    jgot = _cut(lambda c: jbk.bkc_fit_stream(jst, jnp.asarray(init), 30, 6, checkpoint=c),
                specs, jck, jfaults)
    _equal(got, tbk.bkc_fit_stream(st, _cpu(init), 30, 6), BKC_FIELDS)
    np.testing.assert_array_equal(got.group_of_mc.numpy(), np.asarray(jgot.group_of_mc))
    np.testing.assert_array_equal(got.assignment.numpy(), np.asarray(jgot.assignment))
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(jgot.centers), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(got.rss), float(jgot.rss), rtol=1e-5)
    assert not ck._store and not jck._store


def test_port_exports_the_reference_s_resilience_names():
    assert set(jres.__all__) <= set(res.__all__)


def test_restore_carry_replaces_the_default_restore(rng):
    """``restore_carry`` receives the snapshot's host carry and returns the
    live one (a distributed fold re-places it); the pass resumes from it."""
    x = rng.standard_normal((64, 8)).astype(np.float32)
    st = CorpusStream.from_array(x, chunk=16)
    ck = res.MemoryCheckpointer(every=2)
    carry = torch.zeros(8)
    with faults.inject("raise@c3"), pytest.raises(InjectedFault):
        run_pass(st, _tensor_fold, carry, pass_id="p", checkpoint=ck)
    seen = []

    def restore(host):
        seen.append(host)
        return res.carry_from_host(host)

    got = run_pass(st, _tensor_fold, carry, pass_id="p", checkpoint=ck, restore_carry=restore)
    assert len(seen) == 1 and isinstance(seen[0], ckpt._DeviceLeaf)
    assert torch.equal(got, run_pass(st, _tensor_fold, carry)) and not ck._store
