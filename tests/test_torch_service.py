"""The port's online clustering service (``repro_torch/serve``) on the CPU,
held to its own contracts and to the JAX package's service.

The first part mirrors ``tests/test_cluster_service.py`` test for test, on
the port with ``device="cpu"`` and its own draws (``draw_generator``):

  * assign answers through ``assign_batch`` on the rescaled rows, across
    micro-batch coalescing and large-request splitting.
  * an ACCEPTED request is always answered: shedding happens only at
    admission, a missed deadline only stops the caller's wait, and injected
    worker crashes are retried then DELIVERED (never dropped).
  * ingest folds the merge_stats monoid and rejects poisoned batches before
    any state mutates.
  * drift-triggered refit hot-swaps centers BIT-IDENTICAL to an
    uninterrupted offline ``buckshot_stream`` over base + ingested rows;
    crashes retry, stalls are abandoned (late swap refused by token),
    validation failure rolls back — in every failure the service keeps
    serving the last validated model.

The second part feeds the JAX service (``impl="xla"``, fitted once for the
module) and the port's the same texts, the port drawing the JAX service's
own ``fold_in`` uniforms through ``uniforms=``: fitted and swapped centers
within 1e-6, ``assign``/``ingest`` labels equal, similarities and objectives
within 1e-6 (tf-idf's ``log`` may differ by a few ulp between the two
packages), and the same ``stats()`` keys.

The last part SIGKILLs a refit in a child process that imports only the
port (the JAX draws handed over in a ``.npz``; prefetch off, so the refit's
reservoir snapshot is on disk before the kill chunk is served), resumes it
in a second child from the ``DiskCheckpointer`` directory, and holds the
swapped centers to the port's offline ``buckshot_stream`` bit for bit and to
the JAX package's offline refit within 1e-6.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import textwrap
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.core.buckshot import buckshot_stream as jbuckshot_stream
from repro.serve import ClusterService as JService
from repro.serve import ServiceConfig as JConfig
from repro.text import stream as jstream
from repro.text import tfidf as jtfidf
from repro_torch.core.buckshot import buckshot_stream
from repro_torch.core.kmeans import assign_batch
from repro_torch.serve import (
    ClusterService,
    DeadlineError,
    FittedModel,
    IngestError,
    ServiceConfig,
    ShedError,
)
from repro_torch.serve.cluster_service import draw_generator
from repro_torch.testing import faults
from repro_torch.testing.faults import InjectedFault
from repro_torch.text import hashing, tfidf
from repro_torch.text.stream import CorpusStream

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

K, DIM, CHUNK = 3, 64, 32
BASE_CFG = dict(
    k=K, dim=DIM, chunk=CHUNK, max_batch=16, queue_cap=64,
    sample_size=16, kmeans_iters=2, tol=0.0,
    drift_mass=1e9, drift_obj=1e9,  # drift off unless a test opts in
    refit_backoff=0.01,
)
SEED = 7  # the port's draws (draw_generator)
KEY = jax.random.PRNGKey(7)  # the JAX service's
TOL = 1e-6


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    faults.clear()
    yield
    faults.clear()


def _texts(n: int, seed: int, lo: int = 0, hi: int = 40, words: int = 12):
    """Synthetic docs over tokens [lo, hi) — disjoint ranges give disjoint
    vocabularies, i.e. genuinely drifted content."""
    rng = np.random.default_rng(seed)
    return [
        " ".join(f"tok{v}" for v in rng.integers(lo, hi, words))
        for _ in range(n)
    ]


BASE = _texts(120, seed=0)
NEW = _texts(40, seed=1, lo=40, hi=80)  # the drifted batch of the refit tests


def _service(checkpoint=None, **over) -> ClusterService:
    cfg = ServiceConfig(**{**BASE_CFG, **over})
    return ClusterService.fit(BASE, SEED, config=cfg, checkpoint=checkpoint, device="cpu")


def _oracle_assign(svc: ClusterService, docs):
    """What the batch pipeline would answer for these docs under the
    service's fitted model."""
    return _oracle_assign_model(svc.model, docs, svc.cfg.max_batch)


def _oracle_assign_model(m: FittedModel, docs, max_batch: int):
    """``assign_batch`` on the rescaled rows, in the zero-padded slabs of
    ``max_batch`` rows a request served alone goes through: on the CPU the
    plain product may round a row differently at another batch shape (the
    card's kernels compute each similarity alike at any shape)."""
    counts = hashing.vectorize(list(docs), m.df.shape[0])
    idx, sim = [], []
    for lo in range(0, counts.shape[0], max_batch):
        part = counts[lo:lo + max_batch]
        slab = np.zeros((max_batch, counts.shape[1]), np.float32)
        slab[: part.shape[0]] = part
        w = torch.zeros((max_batch,))
        w[: part.shape[0]] = 1.0
        x = tfidf._rescale(torch.from_numpy(slab), m.df, m.n_docs)
        i, s = assign_batch(x, m.centers, w, index=m.index)
        idx.append(i[: part.shape[0]].numpy())
        sim.append(s[: part.shape[0]].numpy())
    return np.concatenate(idx), np.concatenate(sim)


def _offline_refit_oracle(new_docs, rid: int, **draws):
    """Uninterrupted offline Buckshot over base + ingested — the centers a
    validated hot-swap must reproduce bit for bit."""
    stream = CorpusStream.from_texts(BASE + list(new_docs), dim=DIM, chunk=CHUNK)
    xs = tfidf.tfidf_stream(stream, device="cpu")
    res = buckshot_stream(
        xs, K, **(draws or {"generator": draw_generator(SEED, rid)}),
        sample_size=BASE_CFG["sample_size"],
        kmeans_iters=BASE_CFG["kmeans_iters"],
        tol=0.0, device="cpu", bounded=True,
    )
    return res.kmeans.centers.numpy()


# ---------------------------------------------------------------- assign


def test_assign_matches_offline_oracle():
    with _service() as svc:
        docs = _texts(10, seed=3)
        out = svc.assign(docs)
        oidx, osim = _oracle_assign(svc, docs)
        np.testing.assert_array_equal(out.idx, oidx)
        np.testing.assert_array_equal(out.best_sim, osim)
        assert out.version == 0 and out.latency_s >= 0.0


def test_assign_splits_and_coalesces_across_micro_batches():
    with _service() as svc:
        # one request larger than max_batch (split into 3 slabs) ...
        big = _texts(40, seed=4)
        out = svc.assign(big)
        oidx, _ = _oracle_assign(svc, big)
        np.testing.assert_array_equal(out.idx, oidx)
        # ... and many small concurrent requests (coalesced into slabs)
        reqs = [_texts(3, seed=100 + i) for i in range(8)]
        outs = [None] * len(reqs)

        def call(i):
            outs[i] = svc.assign(reqs[i])

        ts = [threading.Thread(target=call, args=(i,)) for i in range(len(reqs))]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        for r, o in zip(reqs, outs):
            np.testing.assert_array_equal(o.idx, _oracle_assign(svc, r)[0])
        st = svc.stats()
        assert st["completed"] == st["accepted"] == 1 + len(reqs)
        assert st["queue_rows"] == 0 and st["shed"] == 0


def test_assign_empty_request():
    with _service() as svc:
        out = svc.assign([])
        assert out.idx.shape == (0,) and out.version == 0


def test_deadline_miss_still_completes_the_request():
    with _service() as svc:
        faults.install("stall@assign:0.4")
        with pytest.raises(DeadlineError):
            svc.assign(_texts(4, seed=5), deadline=0.05)
        # the worker finishes the batch anyway — accepted, never dropped
        deadline = time.monotonic() + 10.0
        while svc.stats()["completed"] < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        st = svc.stats()
        assert st["completed"] == 1 and st["deadline_miss"] == 1
        # and the service is healthy afterwards
        assert svc.assign(_texts(2, seed=6)).idx.shape == (2,)


def test_queue_full_sheds_but_every_accepted_request_completes():
    with _service(queue_cap=32, max_batch=16) as svc:
        faults.install("stall@assignx*:0.25")
        results, sheds, errors = [], [], []

        def call(i):
            docs = _texts(16, seed=200 + i)
            try:
                results.append((docs, svc.assign(docs, deadline=30.0)))
            except ShedError:
                sheds.append(i)
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        ts = [threading.Thread(target=call, args=(i,)) for i in range(8)]
        for t in ts:
            t.start()
            time.sleep(0.02)  # arrive faster than the stalled worker drains
        for t in ts:
            t.join()
        faults.clear()
        assert not errors, errors
        assert sheds, "queue pressure under a stalled worker must shed"
        assert results, "some requests must still be admitted"
        for docs, out in results:  # every accepted request answered correctly
            np.testing.assert_array_equal(out.idx, _oracle_assign(svc, docs)[0])
        st = svc.stats()
        assert st["shed"] == len(sheds)
        assert st["completed"] == st["accepted"] == len(results)


def test_assign_worker_crash_retries_then_infinite_fault_is_delivered():
    with _service() as svc:
        docs = _texts(4, seed=7)
        faults.install("raise@assign")  # one crash: retried, request answered
        out = svc.assign(docs)
        np.testing.assert_array_equal(out.idx, _oracle_assign(svc, docs)[0])
        assert svc.stats()["assign_faults"] == 1
        faults.install("raise@assignx*")  # unbounded: DELIVERED, not dropped
        with pytest.raises(InjectedFault):
            svc.assign(docs)
        faults.clear()
        assert svc.assign(docs).idx.shape == (4,)  # healthy again


# ---------------------------------------------------------------- ingest


def test_ingest_folds_stats_monoid_and_reports_objective():
    with _service() as svc:
        docs = _texts(9, seed=8)
        before = svc._live_stats[1].clone()
        rec = svc.ingest(docs)
        oidx, osim = _oracle_assign(svc, docs)
        np.testing.assert_array_equal(rec.idx, oidx)
        assert rec.objective == pytest.approx(float(np.mean(1.0 - osim)))
        assert not rec.drift and rec.refit_id is None
        after = svc._live_stats[1]
        assert float(after.sum() - before.sum()) == pytest.approx(9.0)
        np.testing.assert_allclose(
            svc._new_counts, np.bincount(oidx, minlength=K).astype(np.float32)
        )
        assert svc.stats()["ingested"] == 9


def test_nan_ingest_rejected_before_any_state_mutation():
    with _service() as svc:
        snap = (
            svc._ingested.shape[0],
            svc._live_stats[1].clone(),
            svc._new_counts.copy(),
        )
        faults.install("nan@ingest")
        with pytest.raises(IngestError):
            svc.ingest(_texts(5, seed=9))
        assert svc._ingested.shape[0] == snap[0]
        assert torch.equal(svc._live_stats[1], snap[1])
        np.testing.assert_array_equal(svc._new_counts, snap[2])
        st = svc.stats()
        assert st["ingest_rejected"] == 1 and st["ingested"] == 0
        assert svc.ingest(_texts(5, seed=9)).idx.shape == (5,)  # clean retry


# ---------------------------------------------------------------- refit


def test_drift_triggers_refit_and_swap_is_bit_identical_to_offline_oracle():
    # validate_slack is large: swap-vs-rollback POLICY is covered separately
    # (test_nan_validate_rolls_back...); here the contract is determinism.
    with _service(drift_mass=0.05, validate_slack=100.0) as svc:
        rec = svc.ingest(NEW)  # disjoint vocab: real drift
        assert rec.drift and rec.refit_id == 1
        assert svc.refit_wait(rec.refit_id, timeout=120.0)
        m = svc.model
        assert m.version == 1
        assert svc._refits["swapped"] == 1
        np.testing.assert_array_equal(m.centers.numpy(), _offline_refit_oracle(NEW, rid=1))
        # post-swap serving answers under the new model, drift state reset
        out = svc.assign(_texts(4, seed=2))
        assert out.version == 1
        assert svc._absorbed == 40 and float(svc._new_counts.sum()) == 0.0


def test_refit_crash_is_retried_and_then_swaps():
    with _service(validate_slack=100.0, refit_retries=2) as svc:
        svc.ingest(_texts(30, seed=1, lo=40, hi=80))
        faults.install("kill@refit")  # thread "kill" == crash; retried
        rid = svc.trigger_refit(wait=True, timeout=120.0)
        assert svc._refits["crashed"] == 1 and svc._refits["swapped"] == 1
        assert svc.model.version == 1 and svc.refit_wait(rid, 0.0)


def test_refit_exhausted_retries_keeps_serving_stale_model():
    with _service(refit_retries=1) as svc:
        faults.install("raise@refitx*")
        svc.trigger_refit(wait=True, timeout=60.0)
        faults.clear()
        r = svc._refits
        assert r["crashed"] == 2 and r["failed"] == 1 and r["swapped"] == 0
        assert svc.model.version == 0  # stale-but-valid serves on
        docs = _texts(4, seed=11)
        np.testing.assert_array_equal(
            svc.assign(docs).idx, _oracle_assign(svc, docs)[0]
        )


def test_refit_stall_abandoned_by_watchdog_and_late_swap_refused():
    with _service(
        refit_watchdog=0.2, refit_retries=0, validate_slack=100.0
    ) as svc:
        faults.install("stall@refit:1.0")
        svc.trigger_refit(wait=True, timeout=60.0)
        r = svc._refits
        assert r["stalled"] == 1 and r["failed"] == 1
        assert svc.model.version == 0  # abandoned: stale model kept
        # the stalled attempt eventually finishes its refit and tries to
        # swap — the revoked token must refuse it
        deadline = time.monotonic() + 60.0
        while svc._refits["refused"] < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert svc._refits["refused"] == 1 and svc._refits["swapped"] == 0
        assert svc.model.version == 0
        assert svc.assign(_texts(2, seed=12)).version == 0


def test_nan_validate_rolls_back_then_clean_refit_swaps():
    with _service(validate_slack=100.0) as svc:
        svc.ingest(_texts(20, seed=1, lo=40, hi=80))
        faults.install("nan@validate")
        svc.trigger_refit(wait=True, timeout=120.0)
        r = svc._refits
        assert r["rolled_back"] == 1 and r["swapped"] == 0
        assert svc.model.version == 0  # rollback: old centers keep serving
        svc.trigger_refit(wait=True, timeout=120.0)  # clean retry swaps
        assert svc._refits["swapped"] == 1 and svc.model.version == 1


def test_worse_candidate_rss_rolls_back():
    # validate_slack=-1 makes the RSS gate impossible (cand.rss > old*0):
    # the refit must roll back and leave the model untouched.
    with _service(validate_slack=-1.0) as svc:
        svc.ingest(_texts(10, seed=13, lo=40, hi=80))
        svc.trigger_refit(wait=True, timeout=120.0)
        assert svc._refits["rolled_back"] == 1 and svc.model.version == 0


# ---------------------------------------------------------------- the port's own


def test_exports_and_fields_match_the_jax_package():
    import repro.serve as jserve
    import repro_torch.serve as tserve

    assert sorted(tserve.__all__) == sorted(jserve.__all__)
    for name in ("FittedModel", "AssignResult", "IngestReceipt"):
        assert getattr(tserve, name)._fields == getattr(jserve, name)._fields
    jfields = set(JConfig.__dataclass_fields__)
    assert set(ServiceConfig.__dataclass_fields__) == jfields - {"impl"}
    for f in ServiceConfig.__dataclass_fields__.values():
        assert f.default == JConfig.__dataclass_fields__[f.name].default, f.name


def test_fit_defaults_to_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ClusterService.fit(BASE, SEED, config=ServiceConfig(**BASE_CFG))


def test_draw_generator_is_fixed_across_processes():
    code = ("from repro_torch.serve.cluster_service import draw_generator; import torch;"
            "print([int(torch.randint(0, 2**62, (1,), generator=draw_generator(7, r)))"
            " for r in (0, 1, 2)])")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")),
                         check=True, timeout=60).stdout
    here = [int(torch.randint(0, 2**62, (1,), generator=draw_generator(7, r))) for r in (0, 1, 2)]
    assert out.strip() == str(here) and len(set(here)) == 3
    assert here[0] == int(torch.randint(0, 2**62, (1,), generator=torch.Generator().manual_seed(7)))


# ---------------------------------------------------------------- against the JAX service


def _jax_uniforms(rid: int):
    """The draws of the JAX service's fit ``rid``: its reservoir's
    ``uniform(fold_in(key, ci))`` with key = KEY for the fit and
    ``fold_in(KEY, rid)`` for refit ``rid``."""
    key = KEY if rid == 0 else jax.random.fold_in(KEY, rid)
    cache = {}

    def draw(ci):
        if ci not in cache:
            cache[ci] = np.array(jax.random.uniform(jax.random.fold_in(key, ci), (CHUNK,)))
        return cache[ci]

    return draw


PARITY_CFG = dict(BASE_CFG, validate_slack=100.0)
ASSIGN_DOCS = _texts(40, seed=3)  # three slabs
INGEST_DOCS = _texts(9, seed=8)
AFTER_DOCS = _texts(12, seed=2, lo=20, hi=80)


def _drive(svc, centers_of):
    """The same sequence on either service: assign, two ingests (drift off),
    a refit, assign under the swapped model."""
    out = {"fit_centers": centers_of(svc.model.centers), "fit_counts": svc.model.fitted_counts,
           "fit_rss": svc.model.rss, "fit_obj": svc.model.base_obj,
           "df": centers_of(svc.model.df), "n_docs": float(svc.model.n_docs)}
    out["assign"] = svc.assign(ASSIGN_DOCS)
    out["ingest"] = svc.ingest(INGEST_DOCS)
    rec = svc.ingest(NEW)
    out["drift"] = (rec.drift, rec.refit_id, svc.trigger_refit(wait=True, timeout=120.0))
    out["swap_centers"] = centers_of(svc.model.centers)
    out["swap_rss"] = svc.model.rss
    out["after"] = svc.assign(AFTER_DOCS)
    out["stats"] = svc.stats()
    return out


@pytest.fixture(scope="module")
def jax_run():
    """The JAX service, fitted once for the module, through ``_drive``."""
    with JService.fit(BASE, KEY, config=JConfig(**PARITY_CFG, impl="xla")) as svc:
        return _drive(svc, np.asarray)


@pytest.fixture(scope="module")
def port_run():
    cfg = ServiceConfig(**PARITY_CFG)
    with ClusterService.fit(BASE, 0, config=cfg, device="cpu", uniforms=_jax_uniforms) as svc:
        return _drive(svc, lambda t: t.numpy())


def test_fitted_model_matches_the_jax_service(jax_run, port_run):
    np.testing.assert_array_equal(port_run["df"], jax_run["df"])
    assert port_run["n_docs"] == jax_run["n_docs"]
    np.testing.assert_allclose(port_run["fit_centers"], jax_run["fit_centers"], rtol=0, atol=TOL)
    np.testing.assert_array_equal(port_run["fit_counts"], jax_run["fit_counts"])
    assert port_run["fit_rss"] == pytest.approx(jax_run["fit_rss"], rel=1e-5)
    assert port_run["fit_obj"] == pytest.approx(jax_run["fit_obj"], rel=1e-5)


@pytest.mark.parametrize("step", ["assign", "ingest", "after"])
def test_assign_and_ingest_answers_match_the_jax_service(jax_run, port_run, step):
    got, want = port_run[step], jax_run[step]
    np.testing.assert_array_equal(got.idx, want.idx)
    np.testing.assert_allclose(got.best_sim, want.best_sim, rtol=0, atol=TOL)
    if step == "ingest":
        assert got.objective == pytest.approx(want.objective, abs=TOL)
        assert (got.drift, got.refit_id) == (want.drift, want.refit_id) == (False, None)
    else:
        assert got.version == want.version == (1 if step == "after" else 0)


def test_swapped_centers_match_the_jax_service_and_the_offline_oracle(jax_run, port_run):
    assert port_run["drift"] == jax_run["drift"] == (False, None, 1)
    np.testing.assert_allclose(port_run["swap_centers"], jax_run["swap_centers"],
                               rtol=0, atol=TOL)
    assert port_run["swap_rss"] == pytest.approx(jax_run["swap_rss"], rel=1e-5)
    want = _offline_refit_oracle(INGEST_DOCS + NEW, 1, uniforms=_jax_uniforms(1))
    assert port_run["swap_centers"].tobytes() == want.tobytes()


def test_stats_have_the_jax_service_keys(jax_run, port_run):
    got, want = port_run["stats"], jax_run["stats"]
    assert set(got) == set(want)
    for key in ("version", "accepted", "completed", "shed", "ingested", "refits"):
        assert got[key] == want[key], key


# ---------------------------------------------------------------- SIGKILL refit resume

_CHILD = """
import os, sys
import numpy as np

from repro_torch.resilience import DiskCheckpointer
from repro_torch.serve import ClusterService, ServiceConfig
from repro_torch.testing import faults

assert "jax" not in sys.modules and "repro" not in sys.modules
draws = np.load(os.environ["DRAWS"])
rng = np.random.default_rng(0)
base = [" ".join(f"tok{v}" for v in rng.integers(0, 40, 12)) for _ in range(120)]
rng = np.random.default_rng(1)
new = [" ".join(f"tok{v}" for v in rng.integers(40, 80, 12)) for _ in range(40)]

cfg = ServiceConfig(
    k=3, dim=64, chunk=32, max_batch=16, queue_cap=64,
    sample_size=16, kmeans_iters=2, tol=0.0,
    drift_mass=1e9, drift_obj=1e9, refit_backoff=0.01,
    validate_slack=100.0,
)
ck = DiskCheckpointer(os.environ["CKPT"], every=1)
svc = ClusterService.fit(base, 0, config=cfg, checkpoint=ck, device="cpu",
                         uniforms=lambda rid: draws[f"u{rid}"].__getitem__)
svc.ingest(new)
if os.environ.get("ARM"):
    faults.install(os.environ["ARM"])  # armed AFTER fit: fires mid-refit
rid = svc.trigger_refit(wait=True, timeout=300)
m = svc.model
assert m.version == 1, m.version
np.save(os.environ["OUT"], m.centers.numpy())
svc.close()
print("SERVED OK")
"""


def _jax_offline_refit_oracle():
    stream = jstream.CorpusStream.from_texts(BASE + NEW, dim=DIM, chunk=CHUNK)
    res = jbuckshot_stream(
        jtfidf.tfidf_stream(stream), K, jax.random.fold_in(KEY, 1),
        sample_size=BASE_CFG["sample_size"], kmeans_iters=BASE_CFG["kmeans_iters"],
        tol=0.0, impl="xla", bounded=True,
    )
    return np.asarray(res.kmeans.centers)


def test_sigkilled_refit_resumes_from_checkpoint_and_matches_oracle(tmp_path):
    ckpt = tmp_path / "svc-ckpt"
    out_path = tmp_path / "centers.npy"
    # the JAX draws of the fit (4 chunks of the base) and refit 1 (5 chunks)
    u = {f"u{rid}": np.stack([_jax_uniforms(rid)(ci) for ci in range(n)])
         for rid, n in ((0, 4), (1, 5))}
    np.savez(tmp_path / "draws.npz", **u)
    env = {k: v for k, v in os.environ.items()
           if k not in ("REPRO_FAULTS", "REPRO_ASSIGN_BOUNDS")}
    env.update(PYTHONPATH=os.path.join(REPO, "src"), CKPT=str(ckpt), OUT=str(out_path),
               DRAWS=str(tmp_path / "draws.npz"), REPRO_STREAM_PREFETCH="0",
               OMP_NUM_THREADS=str(torch.get_num_threads()))

    def run(arm: str | None):
        e = dict(env)
        if arm:
            e["ARM"] = arm
        return subprocess.run(
            [sys.executable, "-c", textwrap.dedent(_CHILD)],
            capture_output=True, text=True, timeout=300, env=e, cwd=REPO,
        )

    # run 1: SIGKILL mid-refit. The refit's df pass serves g0-g4, its
    # reservoir pass g5-g9; without prefetch the reservoir's snapshots after
    # chunks 0 and 1 are on disk before g7 (its chunk 2) is served.
    first = run("kill@g7")
    assert first.returncode == -signal.SIGKILL, (
        first.returncode, first.stdout, first.stderr,
    )
    refit_files = [n for n in os.listdir(ckpt) if "refit" in n]
    assert refit_files, "killed refit must leave scoped('refit') state behind"
    assert not out_path.exists()

    # run 2: same directory, no fault — resumes and completes the swap
    second = run(None)
    assert second.returncode == 0, (second.stdout, second.stderr)
    assert "SERVED OK" in second.stdout
    got = np.load(out_path)
    want = _offline_refit_oracle(NEW, 1, uniforms=lambda ci: u["u1"][ci])
    assert got.tobytes() == want.tobytes()
    np.testing.assert_allclose(got, _jax_offline_refit_oracle(), rtol=0, atol=TOL)
    assert not [n for n in os.listdir(ckpt) if n.endswith(".ckpt")]


def test_concurrent_assigns_during_ingest_and_refit_match_their_version():
    """Callers on 8 threads, ``ingest`` and a refit at once: each answer
    equals the oracle under the model version that served it."""
    with _service(validate_slack=100.0, max_batch=8, queue_cap=512) as svc:
        models = {0: svc.model}
        answers, errors = [], []

        def caller(i):
            for j in range(6):
                docs = _texts(8, seed=1000 + 10 * i + j)
                try:
                    answers.append((docs, svc.assign(docs, deadline=60.0)))
                except BaseException as e:  # noqa: BLE001
                    errors.append(e)

        ts = [threading.Thread(target=caller, args=(i,)) for i in range(8)]
        for t in ts:
            t.start()
        svc.ingest(NEW)
        rid = svc.trigger_refit()
        svc.ingest(_texts(6, seed=14, lo=40, hi=80))  # during the refit
        for t in ts:
            t.join()
        assert svc.refit_wait(rid, timeout=120.0)
        models[1] = svc.model
        assert not errors, errors
        assert svc._refits["swapped"] == 1 and svc.model.version == 1
        for docs, out in answers:
            oidx, osim = _oracle_assign_model(models[out.version], docs, 8)
            np.testing.assert_array_equal(out.idx, oidx)
            np.testing.assert_array_equal(out.best_sim, osim)
        st = svc.stats()
        assert st["completed"] == st["accepted"] == len(answers) == 48
