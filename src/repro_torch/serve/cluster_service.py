"""Resident-model online clustering service (DESIGN.md §14), on the port.

The port's counterpart of the JAX package's ``serve/cluster_service.py``. A
``ClusterService`` holds the fitted state resident on one device (unit-norm
centers, the per-cluster ``merge_stats`` accumulators, the tf-idf (df, n)
weighting, and the two-level center index for bound-pruned assignment)
behind two endpoints:

  assign(docs)  vectorize on the host → copy the fixed-shape micro-batch
                slab to the device → tf-idf rescale under the fitted (df, n)
                → ``core.kmeans.assign_batch``, the bound-pruned sweep.
                Requests enter a bounded admission queue; a single worker
                thread coalesces them into slabs (continuous
                micro-batching). Admission sheds (``ShedError``) when the
                queue is full; each caller may bound its wait with a deadline
                (``DeadlineError``: the batch still completes, the caller
                just stops waiting). An ACCEPTED request is always answered.

  ingest(docs)  fold the batch's cluster stats into the carried
                ``merge_stats`` monoid, append the rows to the ingested tail,
                and feed the drift detector: per-cluster new-mass fraction or
                objective degradation past threshold triggers an async refit.
                A non-finite batch is rejected BEFORE any state mutates.

Refit is a background ``buckshot_stream`` over base corpus + ingested rows
(``text/stream.concat_streams``), checkpointed under ``scoped("refit")`` so a
killed process resumes mid-refit, retried with bounded backoff when an
attempt crashes, and abandoned (stale-but-valid centers keep serving) when an
attempt stalls past the watchdog; a late finisher's swap is refused by
token. Candidate centers hot-swap ATOMICALLY only after validation (finite
guard + RSS-not-worse-than-old-centers on the SAME combined stream);
validation failure rolls back to the serving model. The combined stream
re-chunks to the fit chunk size, so the swapped centers equal an
uninterrupted offline ``buckshot_stream`` over the same corpus with the same
draws bit for bit.

Where the port differs from the reference:

  - The device. ``fit(device=None)`` means the CUDA device, and every tensor
    of the model lives there; the assign worker, the refit attempts and
    ``ingest`` enter that device before they launch, so a service on
    ``cuda:1`` never launches on ``cuda:0``. There is no ``impl`` switch:
    the kernel layer dispatches by device (``kernels/ops.py``). On the card
    the center index is built whenever ``bounded`` is set.
  - The draws. The reference takes a ``jax.random`` key and draws refit
    ``rid`` from ``fold_in(key, rid)``. Here fit ``rid`` (0 for the initial
    fit) draws its reservoir from ``draw_generator(seed, rid)``, or, when
    ``uniforms`` is given, from ``uniforms(rid)``: the reservoir's per-chunk
    draw function (``core/sampling.reservoir_sample_stream``), the seam
    through which tests feed the JAX package's own draws.
  - The kernels are launched from several threads at once (the worker,
    ``ingest``, the refit); the wrappers serialise the calls that share a
    device's buffers (``kernels/_build.device_lock``).

Deterministic fault injection (``testing/faults.py``) hooks the four serve
points: ``kill@refit``/``stall@refit`` (worker crash/stall),
``stall@assign`` (slow worker → queue growth → shedding), ``nan@ingest``
(poisoned batch), ``nan@validate`` (corrupt candidate → rollback).
"""

from __future__ import annotations

import collections
import contextlib
import sys
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch

import repro_torch.core.buckshot  # noqa: F401  (the modules, not the functions)
import repro_torch.core.kmeans  # noqa: F401
from repro_torch.common import resolve_device
from repro_torch.core import metrics
from repro_torch.kernels import ops
from repro_torch.resilience import RetryPolicy
from repro_torch.testing import faults as _faults
from repro_torch.text import hashing as _hashing
from repro_torch.text import tfidf as _tfidf
from repro_torch.text.stream import CorpusStream, concat_streams, host, to_device

# the package namespace shadows both module names with same-named functions
_buckshot = sys.modules["repro_torch.core.buckshot"]
_kmeans = sys.modules["repro_torch.core.kmeans"]


class ShedError(RuntimeError):
    """Admission queue full: the request was REJECTED, not accepted."""


class DeadlineError(RuntimeError):
    """The caller's deadline expired before its batch completed (the worker
    still finishes the batch — accepted requests are never dropped)."""


class IngestError(RuntimeError):
    """The ingest batch was rejected (non-finite rows); state is untouched."""


@dataclass(frozen=True)
class ServiceConfig:
    k: int
    dim: int = 512
    chunk: int = 1024  # stream chunk for fit/refit passes
    max_batch: int = 64  # rows per micro-batch slab
    queue_cap: int = 256  # admission queue capacity, in ROWS
    bounded: bool = True  # serve assigns through the bound-pruned kernel
    sample_size: int | None = None  # buckshot sample (None = paper sqrt(kn))
    kmeans_iters: int = 3
    tol: float = 0.0
    drift_mass: float = 0.25  # per-cluster new-mass fraction trigger
    drift_obj: float = 1.5  # ingest-objective / fitted-objective trigger
    refit_retries: int = 2
    refit_backoff: float = 0.05
    refit_watchdog: float | None = 30.0  # seconds per refit attempt
    validate_slack: float = 1e-4  # relative RSS tolerance for hot-swap
    latency_window: int = 4096  # completed-request latencies kept for p50/p99


class FittedModel(NamedTuple):
    """One immutable serving snapshot; ``assign`` reads it with a single
    attribute load, so hot-swap is one reference assignment — atomic."""

    version: int
    centers: torch.Tensor  # (k, d) unit-norm, on the service's device
    index: "ops.CenterIndex | None"  # two-level index (on the card, if bounded)
    df: torch.Tensor  # (d,) document frequency of the fitted corpus
    n_docs: torch.Tensor  # f32 scalar — idf denominator
    stats: tuple  # (sums, counts, min_sim, sumsq) of the final fit pass
    fitted_counts: np.ndarray  # (k,) host copy — drift-detector baseline
    base_obj: float  # per-doc (1 - best_sim) of the fitted corpus
    rss: float


class AssignResult(NamedTuple):
    idx: np.ndarray  # (m,) int32 nearest-center ids
    best_sim: np.ndarray  # (m,) f32
    version: int  # model version that served the batch
    latency_s: float


class IngestReceipt(NamedTuple):
    idx: np.ndarray
    best_sim: np.ndarray
    objective: float  # per-doc (1 - best_sim) of this batch
    drift: bool  # did this batch trip the drift detector
    refit_id: int | None  # refit scheduled/running after this batch


def draw_generator(seed: int, rid: int) -> torch.Generator:
    """The CPU generator fit ``rid`` draws its reservoir from: the initial
    fit (``rid == 0``) is seeded by ``seed`` itself, refit ``rid`` by a fixed
    mix of (seed, rid) (``np.random.SeedSequence``), the same in every
    process, so a killed refit draws the same sample when it resumes."""
    if rid == 0:
        return torch.Generator().manual_seed(seed)
    mixed = int(np.random.SeedSequence((seed, rid)).generate_state(1, np.uint64)[0])
    return torch.Generator().manual_seed(mixed & (2**63 - 1))


def _on(dev: torch.device):
    """This thread's launches go to ``dev`` (nothing to enter on the CPU)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _assign_slab(slab: np.ndarray, w: np.ndarray, model: FittedModel):
    """The assign hot path over one fixed-shape slab: copy it to the model's
    device, tf-idf rescale under the FITTED (df, n), then the bound-pruned
    sweep. Returns host (idx, best_sim)."""
    dev = model.centers.device
    x = _tfidf._rescale(torch.from_numpy(slab).to(dev), model.df, model.n_docs)
    idx, sim = _kmeans.assign_batch(
        x, model.centers, torch.from_numpy(w).to(dev), index=model.index
    )
    return host(idx), host(sim)


@dataclass
class _Request:
    counts: np.ndarray  # (m, dim) hashed token counts
    idx: np.ndarray
    sim: np.ndarray
    remaining: int  # slab items still outstanding
    done: threading.Event
    submit_t: float
    version: int = -1
    error: BaseException | None = None


class _Item(NamedTuple):
    """One ≤ max_batch row span of a request — the unit the worker packs."""

    req: _Request
    lo: int
    hi: int


class ClusterService:
    """See the module docstring. Build with ``ClusterService.fit``."""

    def __init__(self, config: ServiceConfig):
        raise TypeError("use ClusterService.fit(texts, seed, config=...)")

    @classmethod
    def fit(
        cls,
        texts: Sequence[str],
        seed: int,
        *,
        config: ServiceConfig,
        checkpoint=None,
        device: str | torch.device | None = None,
        uniforms: Callable[[int], Callable[[int], Any]] | None = None,
    ) -> "ClusterService":
        """Fit the initial model on ``device`` (``None`` means the CUDA
        device; checkpointed under ``scoped("fit")``, so a killed cold start
        resumes) and start the serving worker. ``uniforms``, when given, maps
        a fit id (0 for this fit, ``rid`` for refit ``rid``) to the
        reservoir's per-chunk draw function, in place of
        ``draw_generator(seed, rid)``."""
        self = object.__new__(cls)
        self.cfg = config
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:  # the threads resolve it alike
            dev = torch.device("cuda", torch.cuda.current_device())
        self._dev = dev
        self._seed = seed
        self._uniforms = uniforms
        self._checkpoint = checkpoint
        self._base_texts = list(texts)

        # -- serving state (all mutated under _state_lock except the queue)
        self._state_lock = threading.RLock()
        self._ingested = np.zeros((0, config.dim), np.float32)
        self._absorbed = 0  # ingested rows already inside the fitted base
        self._refit_seq = 0
        self._refit_token: tuple[int, int] | None = None
        self._refit_thread: threading.Thread | None = None
        self._refit_done: dict[int, threading.Event] = {}

        # -- admission queue (its own condition: assign must not block on refit)
        self._qcond = threading.Condition()
        self._q: collections.deque[_Item] = collections.deque()
        self._qrows = 0
        self._stop = threading.Event()

        # -- counters / latency window
        self._latencies: collections.deque[float] = collections.deque(
            maxlen=config.latency_window
        )
        self._n = collections.Counter()
        self._refits = collections.Counter()

        stream = CorpusStream.from_texts(
            self._base_texts, dim=config.dim, chunk=config.chunk
        )
        ck = checkpoint.scoped("fit") if checkpoint is not None else None
        with _on(self._dev):
            self._model = self._fit_model(stream, 0, version=0, checkpoint=ck)
        self._live_stats = self._model.stats
        self._new_counts = np.zeros((config.k,), np.float32)
        self._obj_ema: float | None = None

        self._worker = threading.Thread(
            target=self._assign_worker, daemon=True, name="cluster-assign"
        )
        self._worker.start()
        return self

    # ------------------------------------------------------------- fitting

    def _draws(self, rid: int) -> dict:
        """buckshot_stream's draw arguments for fit ``rid``."""
        if self._uniforms is not None:
            return {"uniforms": self._uniforms(rid)}
        return {"generator": draw_generator(self._seed, rid)}

    def _weigh(self, counts_stream):
        """tf-idf pass 1 over the counts stream, and the lazily rescaled
        stream of pass 2 (on the service's device)."""
        dev = self._dev
        df, n = _tfidf.df_stream(counts_stream, device=dev)
        xs = counts_stream.map(lambda c, w: _tfidf._rescale(to_device(c, dev), df, n))
        return df, n, xs

    def _buckshot(self, xs, rid: int, checkpoint):
        cfg = self.cfg
        return _buckshot.buckshot_stream(
            xs, cfg.k, **self._draws(rid),
            sample_size=cfg.sample_size,
            kmeans_iters=cfg.kmeans_iters,
            tol=cfg.tol,
            device=self._dev,
            checkpoint=checkpoint,
            bounded=cfg.bounded,
        )

    def _fit_model(self, counts_stream, rid: int, *, version: int, checkpoint):
        """Shared by cold start and refit: tf-idf over the counts stream,
        buckshot, then one stats pass with the final centers (the CF baseline
        the drift detector and ingest folds start from)."""
        df, n, xs = self._weigh(counts_stream)
        res = self._buckshot(xs, rid, checkpoint)
        return self._snapshot_model(xs, res.kmeans.centers, df, n, version)

    def _snapshot_model(self, xs, centers, df, n, version: int) -> FittedModel:
        k = self.cfg.k
        out = _kmeans._stream_pass(xs, centers, k)
        counts = host(out.stats[1])
        rss = float(
            metrics.rss_from_assignment_stats(
                out.stats[0], out.stats[1], torch.sum(out.stats[3]), k
            )
        )
        return FittedModel(
            version=version,
            centers=centers,
            index=ops.center_index_for(centers, centers) if self.cfg.bounded else None,
            df=df,
            n_docs=n,
            stats=out.stats,
            fitted_counts=counts,
            base_obj=float(out.objective) / max(float(np.sum(counts)), 1.0),
            rss=rss,
        )

    # ------------------------------------------------------------- assign

    def assign(
        self, docs: Sequence[str], *, deadline: float | None = None
    ) -> AssignResult:
        """Blocking assign: admit (or shed), wait for the worker's slab.

        ``deadline`` bounds THIS CALLER's wait in seconds from submission;
        on expiry the request keeps its queue slot and still completes —
        only the caller stops waiting (DeadlineError)."""
        counts = _hashing.vectorize(list(docs), self.cfg.dim)
        m = counts.shape[0]
        if m == 0:
            return AssignResult(
                np.zeros((0,), np.int32), np.zeros((0,), np.float32),
                self._model.version, 0.0,
            )
        req = _Request(
            counts=np.asarray(counts, np.float32),
            idx=np.zeros((m,), np.int32),
            sim=np.zeros((m,), np.float32),
            remaining=0,
            done=threading.Event(),
            submit_t=time.monotonic(),
        )
        items = [
            _Item(req, lo, min(lo + self.cfg.max_batch, m))
            for lo in range(0, m, self.cfg.max_batch)
        ]
        req.remaining = len(items)
        with self._qcond:
            if self._qrows + m > self.cfg.queue_cap:
                self._n["shed"] += 1
                raise ShedError(
                    f"admission queue full ({self._qrows} rows queued,"
                    f" cap {self.cfg.queue_cap}): request of {m} rows shed"
                )
            self._q.extend(items)
            self._qrows += m
            self._n["accepted"] += 1
            self._qcond.notify_all()
        if not req.done.wait(deadline):
            with self._qcond:
                self._n["deadline_miss"] += 1
            raise DeadlineError(
                f"request not served within {deadline:g}s"
                " (still queued/in flight; it will complete)"
            )
        if req.error is not None:
            raise req.error
        return AssignResult(
            idx=req.idx,
            best_sim=req.sim,
            version=req.version,
            latency_s=time.monotonic() - req.submit_t,
        )

    def _assign_worker(self) -> None:
        with _on(self._dev):
            while not self._stop.is_set():
                with self._qcond:
                    while not self._q and not self._stop.is_set():
                        self._qcond.wait(0.05)
                    if self._stop.is_set():
                        return
                    items = [self._q.popleft()]
                    rows = items[0].hi - items[0].lo
                    while self._q and (
                        rows + (self._q[0].hi - self._q[0].lo) <= self.cfg.max_batch
                    ):
                        it = self._q.popleft()
                        rows += it.hi - it.lo
                        items.append(it)
                    self._qrows -= rows
                    self._qcond.notify_all()
                self._run_batch(items)

    def _run_batch(self, items: list[_Item]) -> None:
        # injected worker faults: stall sleeps here; a crash retries the
        # batch (bounded — beyond the cap the error is DELIVERED, the
        # accepted requests are still answered, never dropped)
        err: BaseException | None = None
        for _ in range(16):
            try:
                _faults.serve_point("assign")
                err = None
                break
            except _faults.InjectedFault as e:
                self._n["assign_faults"] += 1
                err = e
        model = self._model  # one read: the whole batch serves one version
        idx = sim = None
        if err is None:
            slab = np.zeros((self.cfg.max_batch, self.cfg.dim), np.float32)
            w = np.zeros((self.cfg.max_batch,), np.float32)
            ofs = 0
            for it in items:
                r = it.hi - it.lo
                slab[ofs : ofs + r] = it.req.counts[it.lo : it.hi]
                w[ofs : ofs + r] = 1.0
                ofs += r
            try:
                idx, sim = _assign_slab(slab, w, model)
            except Exception as e:  # noqa: BLE001 — delivered, not swallowed
                err = e
        ofs = 0
        now = time.monotonic()
        for it in items:
            r = it.hi - it.lo
            req = it.req
            if err is not None:
                req.error = err
            else:
                req.idx[it.lo : it.hi] = idx[ofs : ofs + r]
                req.sim[it.lo : it.hi] = sim[ofs : ofs + r]
            ofs += r
            req.remaining -= 1
            if req.remaining == 0:
                req.version = model.version
                self._latencies.append(now - req.submit_t)
                self._n["completed"] += 1
                req.done.set()

    # ------------------------------------------------------------- ingest

    def ingest(self, docs: Sequence[str]) -> IngestReceipt:
        """Fold a batch into the live CF stats and the ingested tail; trip
        the drift detector. A non-finite batch raises ``IngestError`` before
        ANY state mutates — a poisoned batch cannot poison the carry."""
        counts = _hashing.vectorize(list(docs), self.cfg.dim)
        counts = _faults.serve_point("ingest", counts)
        m = counts.shape[0]
        if m == 0:
            return IngestReceipt(
                np.zeros((0,), np.int32), np.zeros((0,), np.float32),
                0.0, False, None,
            )
        if not np.all(np.isfinite(counts)):
            self._n["ingest_rejected"] += 1
            raise IngestError(
                "non-finite ingest batch rejected; model state untouched"
            )
        counts = np.asarray(counts, np.float32)
        with self._state_lock, _on(self._dev):
            model = self._model
            x = _tfidf._rescale(to_device(counts, self._dev), model.df, model.n_docs)
            st = ops.assign_stats(x, model.centers)
            self._live_stats = ops.merge_stats(self._live_stats, st)
            self._new_counts = self._new_counts + host(st.counts)
            self._ingested = np.concatenate([self._ingested, counts])
            self._n["ingested"] += m
            obj = float(torch.mean(1.0 - st.best_sim))
            self._obj_ema = (
                obj if self._obj_ema is None else 0.8 * self._obj_ema + 0.2 * obj
            )
            drift = self._drift_tripped()
            rid = self._schedule_refit_locked() if drift else None
            idx, best_sim = host(st.idx), host(st.best_sim)
        return IngestReceipt(
            idx=idx, best_sim=best_sim, objective=obj, drift=drift, refit_id=rid
        )

    def _drift_tripped(self) -> bool:
        """Per-cluster new-mass fraction OR objective degradation."""
        base = np.maximum(self._model.fitted_counts, 1.0)
        if float(np.max(self._new_counts / base)) >= self.cfg.drift_mass:
            return True
        floor = max(self._model.base_obj, 1e-6)
        return (
            self._obj_ema is not None
            and self._obj_ema >= self.cfg.drift_obj * floor
        )

    # ------------------------------------------------------------- refit

    def trigger_refit(
        self, *, wait: bool = False, timeout: float | None = None
    ) -> int:
        """Force a refit (the drift detector calls the same path). Returns
        the refit id; ``wait=True`` blocks until that refit reaches a
        terminal state (swapped, rolled back, or given up)."""
        with self._state_lock:
            rid = self._schedule_refit_locked()
        if wait:
            self._refit_done[rid].wait(timeout)
        return rid

    def refit_wait(self, rid: int, timeout: float | None = None) -> bool:
        ev = self._refit_done.get(rid)
        return ev.wait(timeout) if ev is not None else True

    def _schedule_refit_locked(self) -> int:
        if self._refit_thread is not None and self._refit_thread.is_alive():
            return self._refit_seq  # one in flight; it covers this trigger
        self._refit_seq += 1
        rid = self._refit_seq
        snap_m = self._ingested.shape[0]  # rows this refit will absorb
        self._refit_done[rid] = threading.Event()
        self._refits["started"] += 1
        t = threading.Thread(
            target=self._refit_supervisor,
            args=(rid, snap_m),
            daemon=True,
            name="cluster-refit",
        )
        self._refit_thread = t
        t.start()
        return rid

    def _refit_supervisor(self, rid: int, snap_m: int) -> None:
        """Watchdog + retry around refit attempts. A crashed attempt retries
        with backoff; a stalled one is abandoned (its token is revoked, so a
        late finish cannot swap) — either way the serving model stays the
        last validated one."""
        policy = RetryPolicy(
            retries=self.cfg.refit_retries, base_delay=self.cfg.refit_backoff
        )
        try:
            for attempt in range(policy.retries + 1):
                token = (rid, attempt)
                with self._state_lock:
                    self._refit_token = token
                box: dict[str, Any] = {}
                t = threading.Thread(
                    target=self._refit_attempt,
                    args=(rid, token, snap_m, box),
                    daemon=True,
                    name=f"cluster-refit-{rid}.{attempt}",
                )
                t.start()
                t.join(self.cfg.refit_watchdog)
                if t.is_alive():
                    with self._state_lock:
                        self._refit_token = None  # revoke: late swap refused
                    self._refits["stalled"] += 1
                    policy.sleep(attempt + 1)
                    continue
                if "error" not in box:
                    return  # terminal: swapped or rolled back
                self._refits["crashed"] += 1
                if attempt < policy.retries:
                    policy.sleep(attempt + 1)
            self._refits["failed"] += 1  # exhausted: stale-but-valid serves on
        finally:
            with self._state_lock:
                self._refit_token = None
                self._refit_thread = None
            self._refit_done[rid].set()

    def _refit_stream(self, snap_m: int):
        base = CorpusStream.from_texts(
            self._base_texts, dim=self.cfg.dim, chunk=self.cfg.chunk
        )
        if snap_m == 0:
            return base
        tail = CorpusStream.from_array(
            self._ingested[:snap_m], chunk=self.cfg.chunk
        )
        return concat_streams(base, tail, chunk=self.cfg.chunk)

    def _refit_attempt(
        self, rid: int, token: tuple[int, int], snap_m: int, box: dict
    ) -> None:
        try:
            with _on(self._dev):
                _faults.serve_point("refit")
                cfg = self.cfg
                old = self._model
                df, n, xs = self._weigh(self._refit_stream(snap_m))
                ck = (
                    self._checkpoint.scoped("refit")
                    if self._checkpoint is not None
                    else None
                )
                res = self._buckshot(xs, rid, ck)
                # validation baseline: the OLD centers' RSS on the SAME stream
                # (max_iters=0 skips the loop and runs only the final pass)
                base = _kmeans.kmeans_fit_stream(
                    xs, old.centers, cfg.k, max_iters=0, bounded=cfg.bounded,
                )
                cand = self._snapshot_model(
                    xs, res.kmeans.centers, df, n, old.version + 1
                )
                self._try_swap(token, cand, float(base.rss), snap_m)
        except BaseException as e:  # noqa: BLE001 — supervisor owns retry
            box["error"] = e

    def _try_swap(
        self, token: tuple[int, int], cand: FittedModel,
        old_rss: float, snap_m: int,
    ) -> bool:
        """Validate then atomically install ``cand`` — or roll back."""
        centers = _faults.serve_point("validate", host(cand.centers))
        with self._state_lock:
            if self._refit_token != token:
                self._refits["refused"] += 1  # superseded/abandoned attempt
                return False
            if not np.all(np.isfinite(centers)):
                self._refits["rolled_back"] += 1
                return False
            if cand.rss > old_rss * (1.0 + self.cfg.validate_slack) + 1e-12:
                self._refits["rolled_back"] += 1
                return False
            self._model = cand
            self._absorbed = snap_m
            self._live_stats = cand.stats
            self._new_counts = np.zeros((self.cfg.k,), np.float32)
            self._obj_ema = None
            # rows ingested DURING the refit stay pending: re-fold their
            # stats against the new model so drift keeps counting them
            rest = self._ingested[snap_m:]
            if rest.shape[0]:
                x = _tfidf._rescale(to_device(rest, self._dev), cand.df, cand.n_docs)
                st = ops.assign_stats(x, cand.centers)
                self._live_stats = ops.merge_stats(self._live_stats, st)
                self._new_counts = self._new_counts + host(st.counts)
            self._refits["swapped"] += 1
            return True

    # ------------------------------------------------------------- admin

    @property
    def model(self) -> FittedModel:
        return self._model

    def stats(self) -> dict:
        lat = np.asarray(self._latencies, np.float64)
        with self._qcond:
            depth = self._qrows
        return {
            "version": self._model.version,
            "queue_rows": depth,
            "accepted": self._n["accepted"],
            "completed": self._n["completed"],
            "shed": self._n["shed"],
            "deadline_miss": self._n["deadline_miss"],
            "assign_faults": self._n["assign_faults"],
            "ingested": self._n["ingested"],
            "ingest_rejected": self._n["ingest_rejected"],
            "p50_ms": float(np.percentile(lat, 50) * 1e3) if lat.size else 0.0,
            "p99_ms": float(np.percentile(lat, 99) * 1e3) if lat.size else 0.0,
            "refits": dict(self._refits),
        }

    def close(self, timeout: float = 5.0) -> None:
        """Stop the assign worker (in-queue requests finish first) and wait
        for an in-flight refit supervisor to reach a terminal state."""
        deadline = time.monotonic() + timeout
        with self._qcond:
            while self._q and time.monotonic() < deadline:
                self._qcond.wait(0.05)
        self._stop.set()
        with self._qcond:
            self._qcond.notify_all()
        self._worker.join(timeout=max(deadline - time.monotonic(), 0.1))
        t = self._refit_thread
        if t is not None:
            t.join(timeout=max(deadline - time.monotonic(), 0.1))

    def __enter__(self) -> "ClusterService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
