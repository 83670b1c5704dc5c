"""A streaming fit of the port SIGKILLed mid-pass resumes from its
``DiskCheckpointer`` directory and gives the uninterrupted fit bit for bit,
on the CPU.

The job runs in a subprocess that imports the port only (no JAX) and passes
``device="cpu"``: ``REPRO_FAULTS=kill@gN`` kills it as the producer reaches
the Nth chunk served, it is started again on the same directory without the
fault, and its centers, labels, similarities and RSS must equal the
uninterrupted fit computed in the test process, with no ``.ckpt`` left
behind, and it must fold only the chunks after the killed pass's snapshot.
Covered: ``kmeans_fit_stream`` killed in its final pass,
``kmeans_fit_stream`` bounded killed in an iteration pass (the bound blocks
ride the snapshot), and ``buckshot_stream`` killed in phase 2's final pass
(the reservoir's sample replayed from its stored result). The child runs
with the test process's thread count, so the CPU products add alike.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro_torch.core.buckshot  # noqa: F401  (the modules, not the functions)
import repro_torch.core.kmeans  # noqa: F401
from repro_torch.testing import faults
from repro_torch.text.stream import CorpusStream

tk, tbs = (sys.modules[f"repro_torch.core.{m}"] for m in ("kmeans", "buckshot"))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, D, CHUNK, K = 512, 16, 64, 5  # 8 chunks a pass
NCH = N // CHUNK

_JOB = """
    import os
    import sys

    import numpy as np
    import torch

    import repro_torch.core.buckshot
    import repro_torch.core.kmeans
    from repro_torch.kernels import ops
    from repro_torch.resilience import DiskCheckpointer
    from repro_torch.text.stream import CorpusStream

    assert "jax" not in sys.modules and "repro" not in sys.modules
    folds = []  # chunks folded: one assign_stats call each
    for name in ("assign_stats", "assign_stats_bounded"):
        setattr(ops, name, lambda *a, _f=getattr(ops, name), **kw: folds.append(1) or _f(*a, **kw))
    tk, tbs = (sys.modules[f"repro_torch.core.{m}"] for m in ("kmeans", "buckshot"))
    x = np.load(os.environ["X"], mmap_mode="r")
    st = CorpusStream.from_array(x, chunk=int(os.environ["CHUNK"]))
    ck = DiskCheckpointer(os.environ["CKPT_DIR"], every=2)
    job, k = os.environ["JOB"], int(os.environ["K"])
    if job == "buckshot":
        res = tbs.buckshot_stream(st, k, torch.Generator().manual_seed(3), kmeans_iters=3,
                                  device="cpu", checkpoint=ck).kmeans
    else:
        init = torch.from_numpy(np.load(os.environ["INIT"]))
        res = tk.kmeans_fit_stream(st, init, k, bounded=job == "kmeans_bounded",
                                   checkpoint=ck)
    np.savez(os.environ["OUT"], centers=res.centers.numpy(), assignment=res.assignment.numpy(),
             best_sim=res.best_sim.numpy(), rss=res.rss.numpy(), iterations=res.iterations,
             folds=len(folds))
"""


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Unit rows around 5 directions and 5 of them as initial centers, on
    disk for the child."""
    rng = np.random.default_rng(7)
    c = rng.standard_normal((K, D))
    x = c[rng.integers(0, K, N)] + 0.4 * rng.standard_normal((N, D))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    init = x[rng.choice(N, K, replace=False)]
    d = tmp_path_factory.mktemp("resume")
    np.save(d / "x.npy", x)
    np.save(d / "init.npy", init)
    return x, init, d


def _run(env):
    return subprocess.run([sys.executable, "-c", textwrap.dedent(_JOB)], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)


def _oracle(job, x, init):
    st = CorpusStream.from_array(x, chunk=CHUNK)
    if job == "buckshot":
        return tbs.buckshot_stream(st, K, torch.Generator().manual_seed(3), kmeans_iters=3,
                                   device="cpu").kmeans
    return tk.kmeans_fit_stream(st, torch.from_numpy(init), K, bounded=job == "kmeans_bounded")


def _kill_at(job, iterations):
    """The served chunk at which the child dies: the final pass's chunk 6,
    or for the bounded job iteration 1's chunk 5. The producer runs at most
    three chunks ahead of the fold, so the pass's snapshot at chunk 2 or 4
    is on disk by then."""
    if job == "kmeans_bounded":
        return NCH + 5
    reservoir = NCH if job == "buckshot" else 0
    return reservoir + iterations * NCH + 6


@pytest.mark.parametrize("job", ["kmeans", "kmeans_bounded", "buckshot"])
def test_sigkilled_stream_fit_resumes_bit_for_bit(job, data, tmp_path):
    x, init, d = data
    want = _oracle(job, x, init)
    env = {k: v for k, v in os.environ.items()
           if k not in ("REPRO_FAULTS", "REPRO_ASSIGN_BOUNDS", "REPRO_STREAM_PREFETCH")}
    env.update(
        PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS=str(torch.get_num_threads()),
        X=str(d / "x.npy"), INIT=str(d / "init.npy"), CHUNK=str(CHUNK), K=str(K), JOB=job,
        CKPT_DIR=str(tmp_path / "ckpt"), OUT=str(tmp_path / "out.npz"),
        REPRO_FAULTS=f"kill@g{_kill_at(job, want.iterations)}",
    )
    killed = _run(env)
    assert killed.returncode == -signal.SIGKILL, (
        f"expected a SIGKILL death, got rc={killed.returncode}\n{killed.stdout}\n{killed.stderr}")
    assert not os.path.exists(env["OUT"])
    assert [p for p in os.listdir(env["CKPT_DIR"]) if p.endswith(".ckpt")]

    del env["REPRO_FAULTS"]
    resumed = _run(env)
    assert resumed.returncode == 0, f"{resumed.stdout}\n{resumed.stderr}"
    got = np.load(env["OUT"])
    assert int(got["iterations"]) == want.iterations
    # it resumed from a snapshot at chunk 2 or 4 of the killed pass, and
    # replayed the finished passes from their results
    passes = want.iterations if job == "kmeans_bounded" else 1
    assert int(got["folds"]) in (passes * NCH - 2, passes * NCH - 4)
    for field in ("centers", "assignment", "best_sim", "rss"):
        assert got[field].tobytes() == getattr(want, field).numpy().tobytes(), field
    assert not [p for p in os.listdir(env["CKPT_DIR"]) if p.endswith(".ckpt")]


def test_kill_spec_parses_in_the_port():
    plan = faults.FaultPlan.from_spec(f"kill@g{NCH + 5}")
    assert plan.faults[0].kind == "kill" and plan.faults[0].where == ("g", NCH + 5)
