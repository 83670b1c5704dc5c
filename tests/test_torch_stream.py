"""The port's streaming (out-of-core) path against the JAX package's, on the
CPU.

The same numpy inputs (a synthetic corpus of 600 documents over 64 terms,
its tf-idf rows computed once by the JAX package, chunks of 128 rows, the
same initial centers and the same reservoir uniforms) go through
``repro`` and ``repro_torch``. Labels, iterations, sample ids, document
frequencies and group ids must be equal; centers within 1e-6; RSS within
1e-5 relative; the port's streamed tf-idf equal to its resident ``tfidf``
bit for bit; one-chunk streams equal to the resident fits bit for bit;
bounded equal to unbounded bit for bit; stats folds bit-exact on
integer-valued data. The executor's contract (chunk shape, re-iteration,
prefetch, retry, watchdog, guard) and the numpy copies (``stream_corpus``,
``hashing``, ``faults``) are held to the JAX package's on the same inputs.
"""

from __future__ import annotations

import sys
import threading
import time
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.bkc  # noqa: F401  (the modules, not the re-exported functions)
import repro.core.buckshot  # noqa: F401
import repro.core.kmeans  # noqa: F401
import repro_torch.core.bkc  # noqa: F401
import repro_torch.core.buckshot  # noqa: F401
import repro_torch.core.kmeans  # noqa: F401
from repro.kernels import ops as jops
from repro.testing import faults as jfaults
from repro.text import hashing as jhashing
from repro.text import stream as jstream
from repro.text import synth as jsynth
from repro.text import tfidf as jtfidf
from repro_torch import interop
from repro_torch.common import l2_normalize
from repro_torch.core import sampling
from repro_torch.kernels import ops
from repro_torch.resilience import GuardError, RetryPolicy, StreamFault, StreamTimeout
from repro_torch.resilience import policy
from repro_torch.testing import faults
from repro_torch.text import hashing, pipeline, stream, synth, tfidf
from repro_torch.text.stream import CorpusStream, run_pass

jk, jbk, jbs = (sys.modules[f"repro.core.{m}"] for m in ("kmeans", "bkc", "buckshot"))
tk, tbk, tbs = (sys.modules[f"repro_torch.core.{m}"] for m in ("kmeans", "bkc", "buckshot"))

N, D, TOPICS, SEED, CHUNK = 600, 64, 6, 5, 128
CPU = torch.device("cpu")
REL = 1e-5


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


@pytest.fixture(scope="module")
def corpus():
    """(counts, labels, tf-idf rows from the JAX package) as numpy."""
    c = jsynth.make_corpus(N, vocab=D, n_topics=TOPICS, seed=SEED)
    return c.counts, c.labels, np.asarray(jtfidf.tfidf(jnp.asarray(c.counts)))


def _streams(x, chunk=CHUNK):
    return jstream.CorpusStream.from_array(x, chunk=chunk), CorpusStream.from_array(x, chunk=chunk)


def _np(t):
    return interop.to_numpy(t) if isinstance(t, torch.Tensor) else np.asarray(t)


def _pick(x, m, seed):
    return x[np.random.default_rng(seed).choice(x.shape[0], m, replace=False)]


def _uniforms(key, chunk=CHUNK):
    """The JAX package's per-chunk reservoir draws, as the port's seam takes
    them."""
    return lambda ci: np.asarray(jax.random.uniform(jax.random.fold_in(key, ci), (chunk,)))


def _collect(st, **kw):
    return run_pass(st, lambda acc, ch, ci: acc + [(ci, stream.host(ch.x).copy())], [], **kw)


def _sum_fold(state, ch, ci):
    return state + float(np.sum(stream.host(ch.x) * stream.host(ch.w)[:, None]))


# ------------------------------------------------------------------ the stream


def test_stream_corpus_chunks_equal_the_jax_package(corpus):
    counts, labels, _ = corpus
    st, lab = synth.stream_corpus(N, vocab=D, n_topics=TOPICS, seed=SEED, chunk=96)
    jst, jlab = jsynth.stream_corpus(N, vocab=D, n_topics=TOPICS, seed=SEED, chunk=96)
    np.testing.assert_array_equal(lab, jlab)
    np.testing.assert_array_equal(lab, labels)
    got, want = list(st.chunks()), list(jst.chunks())
    assert len(got) == len(want) == st.n_chunks == 7
    for g, w in zip(got, want):
        assert g.x.shape == (96, D) and g.x.dtype == np.float32
        assert g.x.tobytes() == w.x.tobytes() and g.w.tobytes() == w.w.tobytes()
        assert g.start == w.start
        assert (g.x[g.w == 0] == 0).all()
    np.testing.assert_array_equal(st.materialize(), counts)


@pytest.mark.parametrize("chunk", [600, 127, 1024])
def test_stream_corpus_rows_equal_make_corpus_any_chunk(corpus, chunk):
    st, _ = synth.stream_corpus(N, vocab=D, n_topics=TOPICS, seed=SEED, chunk=chunk)
    assert st.materialize().tobytes() == corpus[0].tobytes()


def test_from_array_one_chunk_wrapper(corpus):
    st = CorpusStream.from_array(corpus[2])
    assert st.n_chunks == 1 and st.chunk == N
    np.testing.assert_array_equal(st.materialize(), corpus[2])


@pytest.mark.parametrize("case", ["short_mid", "too_long", "declared_n"])
def test_from_blocks_contract_errors_like_jax(case):
    z = lambda r: np.zeros((r, 4), np.float32)  # noqa: E731
    blocks, n = {
        "short_mid": ([z(3), z(8)], 11),
        "too_long": ([z(12)], 12),
        "declared_n": ([z(8), z(3)], 20),
    }[case]
    for mod in (jstream, stream):
        st = mod.CorpusStream.from_blocks(lambda: iter(blocks), n=n, dim=4, chunk=8)
        with pytest.raises(ValueError):
            st.materialize()
        with pytest.raises(ValueError):  # through the prefetch thread too
            mod.run_pass(st, lambda a, ch, ci: a, None, prefetch=2)
    ok = CorpusStream.from_blocks(lambda: iter([z(8), z(3)]), n=11, dim=4, chunk=8)
    assert ok.materialize().shape == (11, 4)


def test_concat_streams_equals_one_stream_and_the_jax_package():
    rng = np.random.default_rng(11)
    rows = rng.random((57, 6)).astype(np.float32)
    cuts = [(0, 20, 7), (20, 23, 9), (23, 57, 13)]
    cat = stream.concat_streams(*[CorpusStream.from_array(rows[a:b], chunk=c) for a, b, c in cuts], chunk=10)
    jcat = jstream.concat_streams(
        *[jstream.CorpusStream.from_array(rows[a:b], chunk=c) for a, b, c in cuts], chunk=10
    )
    oracle = CorpusStream.from_array(rows, chunk=10)
    assert cat.n == oracle.n == 57 and cat.n_chunks == oracle.n_chunks
    for _ in range(2):  # re-iterable
        for g, o, j in zip(cat.chunks(), oracle.chunks(), jcat.chunks()):
            for a in (o, j):
                np.testing.assert_array_equal(g.x, a.x)
                np.testing.assert_array_equal(g.w, a.w)
                assert g.start == a.start


def test_concat_streams_rejects_dim_mismatch_and_empty():
    a = CorpusStream.from_array(np.zeros((4, 3), np.float32))
    b = CorpusStream.from_array(np.zeros((4, 5), np.float32))
    with pytest.raises(ValueError, match="dim"):
        stream.concat_streams(a, b)
    with pytest.raises(ValueError):
        stream.concat_streams()
    c = a.concat(CorpusStream.from_array(np.zeros((2, 3), np.float32)))
    assert c.n == 6 and c.chunk == a.chunk


def test_stream_reiterable():
    st, _ = synth.stream_corpus(N, vocab=D, n_topics=TOPICS, seed=SEED, chunk=256)
    np.testing.assert_array_equal(st.materialize(), st.materialize())


def test_empty_stream():
    st = CorpusStream.from_blocks(lambda: iter([]), n=0, dim=4, chunk=8)
    assert st.n_chunks == 0
    assert _collect(st, prefetch=2) == []
    assert st.materialize().shape == (0, 4)
    with pytest.raises(ValueError, match="empty stream"):
        tfidf.df_stream(st, device="cpu")


@pytest.mark.parametrize("depth", [1, 2, 16])
def test_prefetch_on_off_chunks_identical(depth):
    st, _ = synth.stream_corpus(500, vocab=D, n_topics=4, seed=1, chunk=96)
    off = _collect(st, prefetch=0)
    on = _collect(st, prefetch=depth)
    assert [ci for ci, _ in on] == [ci for ci, _ in off] == list(range(6))
    for (_, a), (_, b) in zip(on, off):
        np.testing.assert_array_equal(a, b)
    for ch, (_, b) in zip(stream.iter_chunks(st, prefetch=depth), off, strict=True):
        np.testing.assert_array_equal(ch.x, b)


def test_mapped_stream_reiterates_under_prefetch():
    st, _ = synth.stream_corpus(500, vocab=D, n_topics=4, seed=1, chunk=96)
    mapped = st.map(lambda x, w: torch.from_numpy(x) * 2.0)
    a, b = _collect(mapped, prefetch=2), _collect(mapped, prefetch=2)
    assert len(a) == len(b) == mapped.n_chunks
    for (_, xa), (_, xb) in zip(a, b):
        np.testing.assert_array_equal(xa, xb)
    np.testing.assert_array_equal(np.concatenate([x for _, x in a])[:500], mapped.materialize())


def test_abandoned_producer_is_closed():
    st, _ = synth.stream_corpus(500, vocab=D, n_topics=4, seed=1, chunk=96)

    def boom(acc, ch, ci):
        raise RuntimeError("abandon pass")

    before = threading.active_count()
    with pytest.raises(RuntimeError, match="abandon pass"):
        run_pass(st, boom, None, prefetch=2)
    assert threading.active_count() <= before


# ------------------------------------------------------------------ resilience


def _small(n=96, dim=8, chunk=16):
    x = np.random.default_rng(0).normal(size=(n, dim)).astype(np.float32)
    return jstream.CorpusStream.from_array(x, chunk=chunk), CorpusStream.from_array(x, chunk=chunk)


def test_retry_recovers_like_jax():
    jst, st = _small()
    oracle = run_pass(st, _sum_fold, 0.0)
    assert oracle == jstream.run_pass(jst, _sum_fold, 0.0)
    plan = faults.install("raise@c2x2")
    jplan = jfaults.install("raise@c2x2")
    assert run_pass(st, _sum_fold, 0.0, retry=3) == oracle
    assert jstream.run_pass(jst, _sum_fold, 0.0, retry=3) == oracle
    assert plan.fired("raise") == jplan.fired("raise") == 2


def test_fail_fast_and_stream_fault_like_jax():
    jst, st = _small()
    faults.install("raise@c1")
    with pytest.raises(faults.InjectedFault):  # the original error, unwrapped
        run_pass(st, _sum_fold, 0.0)
    faults.install("raise@c1x*")
    jfaults.install("raise@c1x*")
    with pytest.raises(StreamFault) as ei:
        run_pass(st, _sum_fold, 0.0, pass_id="p", retry=2)
    from repro.resilience import StreamFault as JStreamFault

    with pytest.raises(JStreamFault) as ej:
        jstream.run_pass(jst, _sum_fold, 0.0, pass_id="p", retry=2)
    got, want = ei.value, ej.value
    assert (got.pass_id, got.chunk, got.attempts) == (want.pass_id, want.chunk, want.attempts) == ("p", 1, 3)
    assert isinstance(got.__cause__, faults.InjectedFault)


def test_watchdog_turns_a_stall_into_timeout():
    _, st = _small()
    faults.install("stall@c1:1.0")
    t0 = time.monotonic()
    with pytest.raises(StreamTimeout) as ei:
        run_pass(st, _sum_fold, 0.0, pass_id="wd", timeout=0.2)
    assert time.monotonic() - t0 < 8.0
    assert ei.value.pass_id == "wd" and ei.value.chunk == 1


@pytest.mark.parametrize("spec,chunk", [("nan@c3", 3), ("inf@c2", 2)])
def test_guard_attributes_pass_and_chunk_like_jax(spec, chunk):
    jst, st = _small()
    faults.install(spec)
    jfaults.install(spec)

    def fold(state, ch, ci):  # a tensor carry leaf, as the drivers have
        return state + torch.sum(stream.to_device(ch.x, CPU) * stream.to_device(ch.w, CPU)[:, None])

    with pytest.raises(GuardError) as ei:
        run_pass(st, fold, torch.zeros(()), pass_id="g", guard="finite")
    from repro.resilience import GuardError as JGuardError

    with pytest.raises(JGuardError) as ej:
        jstream.run_pass(jst, _sum_fold, jnp.float32(0.0), pass_id="g", guard="finite")
    assert (ei.value.pass_id, ei.value.chunk) == (ej.value.pass_id, ej.value.chunk) == ("g", chunk)


def test_guard_off_lets_nan_flow_and_env_turns_it_on(monkeypatch):
    _, st = _small()
    faults.install("nan@c1")
    assert np.isnan(run_pass(st, _sum_fold, 0.0))
    faults.install("nan@c1")
    monkeypatch.setenv("REPRO_STREAM_GUARD", "finite")
    with pytest.raises(GuardError):
        run_pass(st, _sum_fold, 0.0, pass_id="env")


def test_guard_in_a_driver_names_its_pass(corpus):
    _, st = _streams(corpus[2])
    faults.install("nan@c2")
    with pytest.raises(GuardError) as ei:
        tk.kmeans_fit_stream(st, interop.data(_pick(corpus[2], 6, 1), "cpu"), 6, guard="finite")
    assert ei.value.pass_id == "kmeans/iter0" and ei.value.chunk == 2


def test_carry_finite_walks_tuples_lists_and_host_blocks():
    ok = (torch.zeros(3), [np.ones(2, np.float32)], {"a": 1.0}, torch.tensor([1, 2]))
    assert stream._carry_finite(ok, set())
    assert not stream._carry_finite((torch.tensor([0.0, float("inf")]),))
    assert not stream._carry_finite([[np.array([np.nan], np.float32)]], set())
    assert not stream._carry_finite({"x": float("nan")})


SPECS = [
    "raise@c2x3, nan@g17, stall@c0:1.5",
    "raise@c1x*",
    "raise@3",
    "inf@g4x2",
    "kill@refit, stall@assign:2, nan@ingest, raise@validatex*",
    "kill@g9",
]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_parser_copy_equals_the_original(spec):
    got, want = faults.FaultPlan.from_spec(spec), jfaults.FaultPlan.from_spec(spec)
    assert [(f.kind, f.where, f.seconds, f.times) for f in got.faults] == [
        (f.kind, f.where, f.seconds, f.times) for f in want.faults
    ]


@pytest.mark.parametrize("bad", ["", "frobnicate@c1", "raise", "raise@z9", "stall@c0", "raise@cx", "pallasx2"])
def test_fault_parser_rejects(bad):
    with pytest.raises(ValueError):
        faults.FaultPlan.from_spec(bad)
    if bad != "pallasx2":  # the port has no Pallas path to fault
        with pytest.raises(ValueError):
            jfaults.FaultPlan.from_spec(bad)


def test_policy_copy_resolves_like_the_original(monkeypatch):
    from repro.resilience import policy as jpolicy

    p = RetryPolicy(retries=4, base_delay=0.05, max_delay=0.12)
    assert [p.delay(i) for i in (1, 2, 3)] == [0.05, 0.10, 0.12]
    monkeypatch.setenv("REPRO_STREAM_RETRIES", "3")
    monkeypatch.setenv("REPRO_STREAM_TIMEOUT", "2.5")
    monkeypatch.setenv("REPRO_STREAM_GUARD", "finite")
    for mod in (policy, jpolicy):
        assert mod.RetryPolicy.resolve(None).retries == 3
        assert mod.RetryPolicy.resolve(5).retries == 5
        assert mod.resolve_timeout(None) == 2.5 and mod.resolve_timeout(0) is None
        assert mod.resolve_guard(None) == "finite"
        with pytest.raises(ValueError):
            mod.resolve_guard("bogus")


# ------------------------------------------------------------------ hashing


TEXTS = [
    "The quick brown fox jumps over the lazy dog",
    "GPU kernels: sim_best_edge, label_stats and assign_stats!",
    "",
    "hadoop spark hadoop spark mapreduce 2021 2021 2021",
    "Ünïcödé tokens and ASCII tokens",
] * 7


@pytest.mark.parametrize("dim", [1, 16, 2048])
def test_hashing_copy_is_byte_identical(dim):
    assert hashing.vectorize(TEXTS, dim).tobytes() == jhashing.vectorize(TEXTS, dim).tobytes()
    got = list(hashing.vectorize_chunks(TEXTS, dim, chunk=8))
    want = list(jhashing.vectorize_chunks(TEXTS, dim, chunk=8))
    assert [g.tobytes() for g in got] == [w.tobytes() for w in want]
    assert hashing.hash_token("spark", dim) == jhashing.hash_token("spark", dim)
    st = CorpusStream.from_texts(TEXTS, dim=dim, chunk=8)
    jst = jstream.CorpusStream.from_texts(TEXTS, dim=dim, chunk=8)
    assert st.materialize().tobytes() == jst.materialize().tobytes()


# ------------------------------------------------------------------ tf-idf


@pytest.mark.parametrize("chunk", [128, 250])
def test_df_stream_equals_the_jax_package(corpus, chunk):
    st, _ = synth.stream_corpus(N, vocab=D, n_topics=TOPICS, seed=SEED, chunk=chunk)
    jst, _ = jsynth.stream_corpus(N, vocab=D, n_topics=TOPICS, seed=SEED, chunk=chunk)
    df, n = tfidf.df_stream(st, device="cpu")
    jdf, jn = jtfidf.df_stream(jst)
    np.testing.assert_array_equal(_np(df), np.asarray(jdf))
    assert float(n) == float(jn) == N


def _logged(st, passes: list) -> CorpusStream:
    """``st`` whose every pass appends the crc32 of each chunk's rows to a
    new list in ``passes`` (read in place, no copy)."""

    def chunks():
        crcs: list[int] = []
        passes.append(crcs)
        for ch in st.chunks():
            crcs.append(zlib.crc32(np.ascontiguousarray(stream.host(ch.x))))
            yield ch

    return CorpusStream(chunks, n=st.n, dim=st.dim, chunk=st.chunk)


def _tfidf_mismatch(got, want, counts, passes, df_n, restream) -> str:
    """What a streamed-against-resident tf-idf mismatch looked like: the
    first differing elements with their ulp distance, pass 1's (df, n)
    against the resident's, whether the two passes over the stream read the
    same rows, and whether streaming again gives the resident's bits (a
    difference that does not recur points at the memory, not the data)."""
    g32, w32 = got.view(np.int32), want.view(np.int32)
    bad = np.argwhere(g32 != w32)
    first = ", ".join(
        f"({r}, {c}): {got[r, c]!r} vs {want[r, c]!r}, {int(g32[r, c]) - int(w32[r, c])} ulp"
        for r, c in bad[:8])
    df, n = (_np(t) for t in df_n[0]) if df_n else (None, None)
    rdf = _np(tfidf.document_frequency(torch.from_numpy(counts)))
    df_note = "not recorded" if df is None else (
        f"equal to the resident's: {np.array_equal(df, rdf)}, terms differing "
        f"{np.nonzero(df != rdf)[0].tolist()[:16]}; n {float(n)!r} against {counts.shape[0]}")
    read = (f"chunk crc32 by pass: {passes}; the passes read the same rows: "
            f"{len(passes) >= 2 and passes[0] == passes[1]}")
    again = restream()
    return (f"{len(bad)} of {got.size} elements differ, in rows "
            f"{sorted(set(bad[:, 0].tolist()))[:16]}; first {first}\n"
            f"pass 1's df: {df_note}\n{read}\n"
            f"streamed again, equal to the resident: {again.tobytes() == want.tobytes()}")


@pytest.mark.parametrize("chunk", [97, 128, 600])
def test_tfidf_stream_equals_resident_tfidf_bit_for_bit(corpus, chunk, monkeypatch):
    passes: list = []
    df_n: list = []
    df_stream = tfidf.df_stream

    def kept_df_stream(*a, **kw):
        df_n.append(df_stream(*a, **kw))
        return df_n[-1]

    monkeypatch.setattr(tfidf, "df_stream", kept_df_stream)

    def streamed():
        st, _ = synth.stream_corpus(N, vocab=D, n_topics=TOPICS, seed=SEED, chunk=chunk)
        return tfidf.tfidf_stream(_logged(st, passes), device="cpu").materialize()

    got = streamed()
    want = _np(tfidf.tfidf(torch.from_numpy(corpus[0])))
    assert got.tobytes() == want.tobytes(), _tfidf_mismatch(
        got, want, corpus[0], passes, df_n, streamed)


def test_tfidf_stream_bits_hold_beside_other_passes_and_thread_counts(corpus):
    """The conditions suspected of a one-time failure of the equality above
    at chunk 97 in a whole-suite run, each kept here: another pass running
    on a second thread (its prefetch producer live, its chunks stalled by a
    fault) while this one streams, and intra-op thread counts that cut the
    resident tensor's elementwise passes off the vector width (3 and 7 of
    the 8 cores). The bits stay equal in each."""
    want = _np(tfidf.tfidf(torch.from_numpy(corpus[0])))
    threads = torch.get_num_threads()
    plan = faults.install("stall@c1:0.5")
    side_out = []
    try:
        side = threading.Thread(target=lambda: side_out.append(run_pass(
            synth.stream_corpus(N, vocab=D, n_topics=TOPICS, seed=SEED, chunk=64)[0],
            lambda acc, ch, ci: acc + torch.sum(stream.to_device(ch.x, CPU)), 0.0, prefetch=2)))
        side.start()
        deadline = time.monotonic() + 30.0
        while not plan.fired("stall") and time.monotonic() < deadline:
            time.sleep(0.005)  # the side pass's producer is now asleep in chunk 1
        faults.clear()  # passes opened from here on see no plan
        for t in (1, 3, 7, threads):
            torch.set_num_threads(t)
            st, _ = synth.stream_corpus(N, vocab=D, n_topics=TOPICS, seed=SEED, chunk=97)
            got = tfidf.tfidf_stream(st, device="cpu").materialize()
            resident = _np(tfidf.tfidf(torch.from_numpy(corpus[0])))
            assert got.tobytes() == resident.tobytes() == want.tobytes()
        side.join(timeout=30.0)
        assert not side.is_alive() and len(side_out) == 1 and plan.fired("stall") == 1
    finally:
        torch.set_num_threads(threads)
        faults.clear()


def test_prepare_synthetic_stream(corpus, tmp_path):
    """The single-device route, then the mesh route in a gloo group of one
    rank: both give the resident tfidf's rows bit for bit."""
    import torch.distributed as dist

    from repro_torch.distrib.sharding import make_flat_mesh

    prep = pipeline.prepare_synthetic_stream(
        n_docs=N, vocab=D, n_topics=TOPICS, seed=SEED, chunk=CHUNK, device="cpu"
    )
    assert prep.n == N and prep.x.n_chunks == 5
    np.testing.assert_array_equal(prep.labels, corpus[1])
    want = _np(tfidf.tfidf(torch.from_numpy(corpus[0])))
    assert prep.x.materialize().tobytes() == want.tobytes()
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        mesh_prep = pipeline.prepare_synthetic_stream(
            n_docs=N, vocab=D, n_topics=TOPICS, seed=SEED, chunk=CHUNK, mesh=make_flat_mesh()
        )
        assert mesh_prep.x.materialize().tobytes() == want.tobytes()
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------------ stats fold


@pytest.mark.parametrize("chunk", [256, 250, 1000])
def test_stream_stats_fold_bitexact_integer_data(chunk):
    rng = np.random.default_rng(0)
    x = rng.integers(-8, 9, size=(1000, 33)).astype(np.float32)
    c = rng.integers(-8, 9, size=(11, 33)).astype(np.float32)
    one = ops.assign_stats(interop.data(x, "cpu"), interop.data(c, "cpu"))
    out = tk._stream_pass(CorpusStream.from_array(x, chunk=chunk), interop.data(c, "cpu"), 11, True)
    jout = jk._stream_pass(jstream.CorpusStream.from_array(x, chunk=chunk), jnp.asarray(c), 11, "xla", True)
    for got, want, jwant in zip(out.stats, one[2:], jout.stats):
        assert torch.equal(got, want)
        np.testing.assert_array_equal(_np(got), np.asarray(jwant))
    np.testing.assert_array_equal(out.idx, _np(one.idx))
    np.testing.assert_array_equal(out.idx, jout.idx)
    np.testing.assert_array_equal(out.best_sim, _np(one.best_sim))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("n,chunk", [(300, 64), (300, 300), (257, 100)])
def test_assign_stats_chunked_matches_jax(n, chunk, weighted):
    rng = np.random.default_rng(n + chunk)
    x = rng.integers(-4, 5, size=(n, 12)).astype(np.float32)
    c = rng.integers(-4, 5, size=(7, 12)).astype(np.float32)
    w = rng.integers(0, 3, size=n).astype(np.float32) if weighted else None
    got = ops.assign_stats_chunked(
        interop.data(x, "cpu"), interop.data(c, "cpu"),
        None if w is None else interop.data(w, "cpu"), chunk=chunk,
    )
    want = jops.assign_stats_chunked(x, c, None if w is None else jnp.asarray(w), chunk=chunk, impl="xla")
    for g, wv in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(wv))


@pytest.mark.parametrize("chunk", [64, 100, 400])
def test_assign_stats_bounded_chunked_matches_jax(chunk):
    """Both packages take the JAX package's own bounds: the blocks one bounded
    step leaves against the previous centers, and their drift."""
    rng = np.random.default_rng(chunk)
    n, d, k = 300, 16, 9
    x = rng.normal(size=(n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    c0 = x[:k].copy()
    c1 = c0 + 0.01 * rng.normal(size=c0.shape).astype(np.float32)
    c1 /= np.linalg.norm(c1, axis=1, keepdims=True)
    drift = np.linalg.norm(c1 - c0, axis=1).astype(np.float32)
    prev = jops.assign_stats_bounded(x, c0, jops.bounds_identity(n), jnp.zeros(k), impl="xla")
    jb = prev.bounds
    want = jops.assign_stats_bounded_chunked(x, c1, jb, jnp.asarray(drift), chunk=chunk, impl="xla")
    got = ops.assign_stats_bounded_chunked(
        interop.data(x, "cpu"), interop.data(c1, "cpu"),
        ops.Bounds(
            interop.labels(jb.idx, "cpu"), interop.data(jb.lo, "cpu"), interop.data(jb.hi, "cpu")
        ),
        interop.data(drift, "cpu"), chunk=chunk,
    )
    np.testing.assert_array_equal(_np(got.idx), np.asarray(want.idx))
    np.testing.assert_array_equal(_np(got.pruned), np.asarray(want.pruned))
    assert _np(got.pruned).any()  # the carried bounds do prune here
    np.testing.assert_array_equal(_np(got.bounds.idx), np.asarray(want.bounds.idx))
    for g, wv in [(got.best_sim, want.best_sim), (got.bounds.lo, want.bounds.lo),
                  (got.bounds.hi, want.bounds.hi), (got.sums, want.sums),
                  (got.counts, want.counts), (got.sumsq, want.sumsq)]:
        np.testing.assert_allclose(_np(g), np.asarray(wv), rtol=REL, atol=1e-6)


# ------------------------------------------------------------------ reservoir


def test_merge_top_s_ties_like_jax():
    rng = np.random.default_rng(3)
    carry = (np.array([0.9, 0.5, 0.5, -2.0], np.float32), np.array([4, 1, 2, -1], np.int32),
             rng.random((4, 3)).astype(np.float32))
    scores = np.array([0.5, 0.9, -1.0, 0.7, 0.5], np.float32)  # ties with the carry
    gidx = np.arange(10, 15, dtype=np.int32)
    rows = rng.random((5, 3)).astype(np.float32)
    want = jbs.sampling.merge_top_s(tuple(map(jnp.asarray, carry)), jnp.asarray(scores),
                                    jnp.asarray(gidx), jnp.asarray(rows), 4)
    got = sampling.merge_top_s(
        (interop.data(carry[0], "cpu"), interop.labels(carry[1], "cpu"),
         interop.data(carry[2], "cpu")),
        interop.data(scores, "cpu"), interop.labels(gidx, "cpu"), interop.data(rows, "cpu"), 4,
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


@pytest.mark.parametrize("s,chunk", [(50, 96), (7, 128), (600, 128)])
def test_reservoir_with_the_jax_draws_equals_the_jax_package(corpus, s, chunk):
    x = corpus[2]
    jst, st = _streams(x, chunk)
    key = jax.random.PRNGKey(7)
    jrows, jidx = jbs.sampling.reservoir_sample_stream(jst, s, key)
    rows, idx = sampling.reservoir_sample_stream(st, s, uniforms=_uniforms(key, chunk), device="cpu")
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(_np(rows), np.asarray(jrows))
    np.testing.assert_array_equal(_np(rows), x[idx])


def test_reservoir_s_equals_n_returns_exactly_the_real_rows():
    x = np.random.default_rng(5).random((13, 4)).astype(np.float32)  # 3 pad rows
    rows, gidx = sampling.reservoir_sample_stream(
        CorpusStream.from_array(x, chunk=8), 13, torch.Generator().manual_seed(2), device="cpu"
    )
    np.testing.assert_array_equal(np.sort(gidx), np.arange(13))
    np.testing.assert_array_equal(_np(rows)[np.argsort(gidx)], x)


def test_reservoir_rejects_oversample_and_needs_draws():
    st = CorpusStream.from_array(np.zeros((10, 4), np.float32))
    with pytest.raises(ValueError, match="exceeds"):
        sampling.reservoir_sample_stream(st, 11, torch.Generator(), device="cpu")
    with pytest.raises(ValueError, match="generator or uniforms"):
        sampling.reservoir_sample_stream(st, 3, device="cpu")


def test_reservoir_default_draws_depend_on_the_generator_only(corpus):
    st = CorpusStream.from_array(corpus[2], chunk=CHUNK)
    draws = {}
    for prefetch in ("0", "2"):
        for seed in (0, 1):
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("REPRO_STREAM_PREFETCH", prefetch)
                rows, idx = sampling.reservoir_sample_stream(
                    st, 40, torch.Generator().manual_seed(seed), device="cpu"
                )
            draws[prefetch, seed] = idx
            assert len(set(idx.tolist())) == 40 and 0 <= idx.min() and idx.max() < N
            np.testing.assert_array_equal(_np(rows), corpus[2][idx])
    np.testing.assert_array_equal(draws["0", 0], draws["2", 0])
    assert not np.array_equal(draws["0", 0], draws["0", 1])
    u = sampling.chunk_uniforms(123, 4, CHUNK)
    assert u.shape == (CHUNK,) and torch.equal(u, sampling.chunk_uniforms(123, 4, CHUNK))
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0


# ------------------------------------------------------------------ drivers


def _close(got, want, *, centers=1e-6):
    np.testing.assert_array_equal(_np(got.assignment), np.asarray(want.assignment))
    np.testing.assert_allclose(_np(got.centers), np.asarray(want.centers), rtol=0, atol=centers)
    np.testing.assert_allclose(float(got.rss), float(want.rss), rtol=REL)
    np.testing.assert_allclose(float(got.objective), float(want.objective), rtol=REL)


def _equal(a, b, fields=("centers", "assignment", "best_sim", "rss", "objective")):
    for f in fields:
        assert torch.equal(torch.as_tensor(getattr(a, f)), torch.as_tensor(getattr(b, f))), f


@pytest.mark.parametrize("bounded", [False, True])
def test_kmeans_fit_stream_matches_jax(corpus, bounded):
    x = corpus[2]
    jst, st = _streams(x)
    init = _pick(x, 6, 1)
    prof, jprof = {}, {}
    want = jk.kmeans_fit_stream(jst, jnp.asarray(init), 6, bounded=bounded, profile=jprof)
    got = tk.kmeans_fit_stream(st, interop.data(init, "cpu"), 6, bounded=bounded, profile=prof)
    assert got.iterations == int(want.iterations) >= 2
    _close(got, want)
    assert len(prof.get("prune_rate", [])) == len(jprof.get("prune_rate", []))
    np.testing.assert_allclose(prof.get("prune_rate", []), jprof.get("prune_rate", []), atol=1e-6)


def test_kmeans_fit_stream_bounded_equals_unbounded_and_one_chunk_equals_resident(corpus):
    x = corpus[2]
    st = CorpusStream.from_array(x, chunk=CHUNK)
    init = interop.data(_pick(x, 6, 2), "cpu")
    plain = tk.kmeans_fit_stream(st, init, 6)
    _equal(tk.kmeans_fit_stream(st, init, 6, bounded=True), plain)
    one = CorpusStream.from_array(x)
    for bounded in (False, True):
        res = tk.kmeans_fit(interop.data(x, "cpu"), init, 6, bounded=bounded)
        got = tk.kmeans_fit_stream(one, init, 6, bounded=bounded)
        assert got.iterations == res.iterations
        _equal(got, res)


@pytest.mark.parametrize("bounded", [False, True])
def test_bkc_fit_stream_matches_jax(corpus, bounded):
    x = corpus[2]
    jst, st = _streams(x)
    init = _pick(x, 30, 3)
    want = jbk.bkc_fit_stream(jst, jnp.asarray(init), 30, 6, bounded=bounded)
    got = tbk.bkc_fit_stream(st, interop.data(init, "cpu"), 30, 6, bounded=bounded)
    _close(got, want)
    np.testing.assert_array_equal(_np(got.group_of_mc), np.asarray(want.group_of_mc))
    assert float(got.threshold) == pytest.approx(float(want.threshold), rel=1e-6, abs=1e-12)


def test_bkc_fit_stream_bisects_real_pair_values_like_jax():
    """Unit rows around 6 directions, 5 % of them loose: micro-clusters that
    take a loose row get a low min_i, so the pair values are not all 0 and
    the bisection compares them (the tf-idf corpus's threshold is ~1e-15)."""
    r = np.random.default_rng(1)
    c = r.standard_normal((6, D))
    lab = r.integers(0, 6, 800)
    sig = np.where(r.random(800) < 0.05, 3.0, 0.15)
    x = c[lab] + sig[:, None] * r.standard_normal((800, D))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    jst, st = _streams(x)
    init = _pick(x, 60, 7)
    want = jbk.bkc_fit_stream(jst, jnp.asarray(init), 60, 40)
    got = tbk.bkc_fit_stream(st, interop.data(init, "cpu"), 60, 40)
    assert float(want.threshold) > 0.05
    _close(got, want)
    np.testing.assert_array_equal(_np(got.group_of_mc), np.asarray(want.group_of_mc))
    assert float(got.threshold) == pytest.approx(float(want.threshold), rel=1e-6)


def test_bkc_fit_stream_bounded_equals_unbounded_and_one_chunk_equals_resident(corpus):
    x = corpus[2]
    init = interop.data(_pick(x, 30, 3), "cpu")
    st = CorpusStream.from_array(x, chunk=CHUNK)
    fields = ("centers", "assignment", "best_sim", "rss", "objective", "group_of_mc", "threshold")
    _equal(tbk.bkc_fit_stream(st, init, 30, 6, bounded=True), tbk.bkc_fit_stream(st, init, 30, 6), fields)
    one = CorpusStream.from_array(x)
    for bounded in (False, True):
        res = tbk.bkc_fit(interop.data(x, "cpu"), init, 30, 6, bounded=bounded)
        _equal(tbk.bkc_fit_stream(one, init, 30, 6, bounded=bounded), res, fields)


@pytest.mark.parametrize("bounded", [False, True])
def test_buckshot_stream_with_the_jax_draws_matches_jax(corpus, bounded):
    x = corpus[2]
    jst, st = _streams(x)
    key = jax.random.PRNGKey(0)
    want = jbs.buckshot_stream(jst, 6, key, kmeans_iters=3, bounded=bounded)
    got = tbs.buckshot_stream(st, 6, uniforms=_uniforms(key), kmeans_iters=3,
                              bounded=bounded, device="cpu")
    np.testing.assert_array_equal(_np(got.sample_idx), np.asarray(want.sample_idx))
    np.testing.assert_array_equal(_np(got.sample_labels), np.asarray(want.sample_labels))
    np.testing.assert_allclose(_np(got.init_centers), np.asarray(want.init_centers), atol=1e-6)
    assert got.kmeans.iterations == int(want.kmeans.iterations)
    _close(got.kmeans, want.kmeans)


def test_buckshot_stream_one_chunk_equals_resident_fit(corpus):
    x = corpus[2]
    got = tbs.buckshot_stream(CorpusStream.from_array(x), 6, torch.Generator().manual_seed(3),
                              device="cpu")
    res = tbs.buckshot_fit(interop.data(x, "cpu"), got.sample_idx.long(), 6)
    assert torch.equal(got.sample_labels, res.sample_labels)
    assert torch.equal(got.init_centers, res.init_centers)
    _equal(got.kmeans, res.kmeans)


def test_kmeans_and_bkc_stream_with_the_jax_draws_match_jax(corpus):
    x = corpus[2]
    jst, st = _streams(x)
    key = jax.random.PRNGKey(9)
    _close(tk.kmeans_stream(st, 6, uniforms=_uniforms(key), device="cpu"), jk.kmeans_stream(jst, 6, key))
    got = tbk.bkc_stream(st, 30, 6, uniforms=_uniforms(key), device="cpu")
    want = jbk.bkc_stream(jst, 30, 6, key)
    _close(got, want)
    np.testing.assert_array_equal(_np(got.group_of_mc), np.asarray(want.group_of_mc))


def test_prefetch_on_and_off_give_the_same_bits(corpus, monkeypatch):
    x = corpus[2]
    st = CorpusStream.from_array(x, chunk=96)  # 600 % 96 != 0: a padded tail
    init = interop.data(_pick(x, 6, 1), "cpu")
    out = {}
    for mode in ("0", "2"):
        monkeypatch.setenv("REPRO_STREAM_PREFETCH", mode)
        out[mode] = (
            tk.kmeans_fit_stream(st, init, 6, max_iters=4),
            tbk.bkc_fit_stream(st, l2_normalize(interop.data(x[:32], "cpu")), 32, 6),
            tbs.buckshot_stream(st, 6, torch.Generator().manual_seed(0), kmeans_iters=2, device="cpu"),
        )
    (k0, b0, s0), (k1, b1, s1) = out["0"], out["2"]
    _equal(k0, k1)
    _equal(b0, b1, ("centers", "assignment", "group_of_mc"))
    assert torch.equal(s0.sample_idx, s1.sample_idx)
    _equal(s0.kmeans, s1.kmeans)


def test_checkpoint_is_not_ported_yet(corpus):
    """Named for the stub it once held (every checkpoint= raised): each
    streaming entry point now takes a Checkpointer, gives the unchecked
    run's bits, and leaves its store empty when it completes, but for the
    bare reservoir's result, which its caller deletes
    (tests/test_torch_checkpoint.py cuts and resumes them)."""
    from repro_torch.resilience import MemoryCheckpointer

    st = CorpusStream.from_array(corpus[2], chunk=CHUNK)
    init = interop.data(_pick(corpus[2], 6, 1), "cpu")
    calls = [
        lambda ck: run_pass(st, _sum_fold, 0.0, checkpoint=ck),
        lambda ck: tk.kmeans_fit_stream(st, init, 6, checkpoint=ck).centers,
        lambda ck: tbk.bkc_fit_stream(st, init, 6, 2, checkpoint=ck).assignment,
        lambda ck: tbs.buckshot_stream(st, 6, torch.Generator().manual_seed(0), checkpoint=ck,
                                       device="cpu").kmeans.assignment,
        lambda ck: tfidf.df_stream(st, checkpoint=ck, device="cpu")[0],
        lambda ck: sampling.reservoir_sample_stream(st, 3, torch.Generator().manual_seed(0),
                                                    checkpoint=ck, device="cpu")[0],
    ]
    for call in calls:
        ck = MemoryCheckpointer(every=1)
        got, want = call(ck), call(None)
        assert torch.equal(torch.as_tensor(got), torch.as_tensor(want))
        assert set(ck._store) <= {"result/reservoir"}
        assert ("result/reservoir" in ck._store) == (call is calls[-1])


def test_streaming_creators_default_to_the_card(corpus):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    st = CorpusStream.from_array(corpus[2], chunk=CHUNK)
    for call in (
        lambda: tfidf.df_stream(st),
        lambda: sampling.reservoir_sample_stream(st, 3, torch.Generator()),
        lambda: tbs.buckshot_stream(st, 6, torch.Generator()),
        lambda: pipeline.prepare_synthetic_stream(n_docs=50, vocab=8),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
