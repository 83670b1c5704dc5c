"""The port's serving engine against the JAX package's, on the CPU.

Both engines serve the same weights (JAX params carried across by
``params_from_jax``) at the REDUCED configs. Greedy tokens and completions
must be equal; ``embed`` agrees within rtol/atol 1e-4; Buckshot on the
port's embeddings gives the reference's labels through the seam that takes
the draws as inputs, ``buckshot_fit(x, sample_idx, k)``. Also the launcher
and the example run end to end with ``--cpu``.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.buckshot  # noqa: F401  (the module, not the re-exported function)
import repro_torch.core.buckshot  # noqa: F401
from repro import configs as jconfigs
from repro.models import registry as jregistry
from repro.serve import engine as jengine
from repro_torch import configs as tconfigs
from repro_torch.common import l2_normalize
from repro_torch.models import transformer as ttransformer
from repro_torch.models.interop import params_from_jax
from repro_torch.models.registry import get_model, make_batch
from repro_torch.serve import Completion, Request, ServeEngine
from repro_torch.serve.engine import embed_documents
from repro_torch.text import synth as tsynth

ROOT = Path(__file__).resolve().parents[1]
PORTED = jconfigs.list_archs()  # every family: dense, vlm, encdec, moe, hybrid, rwkv
TOL = dict(rtol=1e-4, atol=1e-4)


def _seeded(name: str) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(f"{__name__}::{name}".encode()))


@pytest.fixture
def rng(request):
    """Seeded from the test's own name (and its parameters)."""
    return _seeded(request.node.name)


def _engines(arch: str, seed: int = 0):
    jcfg = jconfigs.get_config(arch, reduced=True).replace(remat="none")
    tcfg = tconfigs.get_config(arch, reduced=True)
    params = jax.jit(jregistry.get_model(jcfg).init_params)(jax.random.PRNGKey(seed))
    lm = params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, params), "cpu")
    return (
        jengine.ServeEngine(cfg=jcfg, params=params),
        ServeEngine(cfg=tcfg, params=lm, device="cpu"),
    )


@pytest.fixture(scope="module")
def engines():
    """qwen2-1.5b REDUCED, PRNGKey(0) weights, as the reference's tests."""
    return _engines("qwen2-1.5b")


def _same(jouts: list, touts: list) -> None:
    assert [(o.prompt, o.tokens, o.steps) for o in touts] == [
        (o.prompt, o.tokens, o.steps) for o in jouts
    ]


def test_generate_respects_budgets_as_the_reference(engines):
    jeng, teng = engines
    reqs = [
        Request(prompt=[1, 2, 3], max_new_tokens=4),
        Request(prompt=[7, 8], max_new_tokens=2),
        Request(prompt=[5], max_new_tokens=6),
    ]
    outs = teng.generate(reqs)
    assert all(isinstance(o, Completion) for o in outs)
    for r, o in zip(reqs, outs):
        assert len(o.tokens) == r.max_new_tokens
        assert all(0 <= t < teng.cfg.vocab for t in o.tokens)
    _same(jeng.generate(reqs), outs)
    assert teng.stats["prefill_s"] > 0 and len(teng.stats["decode_s"]) == 5


def test_generate_is_deterministic(engines):
    _, teng = engines
    reqs = [Request(prompt=[3, 1, 4, 1, 5], max_new_tokens=5)]
    assert teng.generate(reqs)[0].tokens == teng.generate(reqs)[0].tokens


def test_generate_eos_stops_early_as_the_reference(engines):
    jeng, teng = engines
    first = teng.generate([Request(prompt=[9, 9, 9], max_new_tokens=1)])[0]
    eos = first.tokens[0]
    reqs = [
        Request(prompt=[9, 9, 9], max_new_tokens=8, eos_id=eos),
        Request(prompt=[4, 2], max_new_tokens=8, eos_id=eos),
    ]
    outs = teng.generate(reqs)
    assert outs[0].tokens == [eos]
    _same(jeng.generate(reqs), outs)


@pytest.mark.parametrize("arch", [a for a in PORTED if a != "qwen2-1.5b"])
def test_generate_matches_the_reference_on_every_family(rng, arch):
    """Mixed prompt lengths (left pads that are not masked, as in the
    reference) and budgets; the vlm and encdec frontends are zeros. The moe
    configs' REDUCED capacity factor (8.0) drops no token in either engine."""
    jeng, teng = _engines(arch, seed=1)
    vocab = teng.cfg.vocab
    reqs = [
        Request(prompt=[int(t) for t in rng.integers(1, vocab, n)], max_new_tokens=m)
        for n, m in ((7, 5), (3, 3), (5, 6))
    ]
    _same(jeng.generate(reqs), teng.generate(reqs))


def test_greedy_decode_equals_teacher_forced_argmax():
    """4 greedy steps on the port == its prefill over the emitted tokens."""
    cfg = tconfigs.get_config("qwen2-1.5b", reduced=True)
    model = get_model(cfg)
    lm = model.init_params(torch.Generator().manual_seed(5), "cpu")
    batch = make_batch(cfg, 1, 12, torch.Generator().manual_seed(6), "cpu")
    logits, caches, pos = ttransformer.prefill(lm, cfg, batch, torch.float32, cache_len=20)
    toks = [int(logits[0].argmax())]
    for i in range(3):
        step = torch.tensor([[toks[-1]]])
        logits, caches = ttransformer.decode_step(lm, cfg, step, caches, pos + i)
        toks.append(int(logits[0].argmax()))
    full = torch.cat([batch["tokens"], torch.tensor([toks[:-1]], dtype=torch.int32)], dim=1)
    logits_tf, _, _ = ttransformer.prefill(lm, cfg, {"tokens": full}, torch.float32)
    assert int(logits_tf[0].argmax()) == toks[-1]


def _batch(rng, cfg, b: int, s: int) -> dict:
    out = {"tokens": rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)}
    if cfg.family in ("vlm", "encdec"):
        out["frontend"] = rng.normal(size=(b, cfg.n_frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    return out


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "paligemma-3b"])  # text; prefix + text
def test_embed_matches_the_reference(rng, engines, arch):
    jeng, teng = engines if arch == "qwen2-1.5b" else _engines(arch)
    nb = _batch(rng, teng.cfg, 4, 16)
    want = jeng.embed({k: jnp.asarray(v) for k, v in nb.items()})
    got = teng.embed({k: torch.from_numpy(v) for k, v in nb.items()})
    assert got.shape == (4, teng.cfg.d_model) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "paligemma-3b"])  # text; zero prefix + text
def test_embed_documents_as_the_reference_example(rng, engines, arch):
    """The embed-and-cluster front-end: the JAX example's loop (batches of
    rows, a zero frontend for a vlm, then l2_normalize) on the same tokens,
    within rtol/atol 1e-4."""
    from repro.common import l2_normalize as jl2_normalize

    jeng, teng = engines if arch == "qwen2-1.5b" else _engines(arch)
    cfg = teng.cfg
    tokens = rng.integers(0, cfg.vocab, size=(40, 12)).astype(np.int32)
    parts = []
    for i in range(0, 40, 16):
        batch = {"tokens": jnp.asarray(tokens[i : i + 16])}
        if cfg.family in ("vlm", "encdec"):
            shape = (batch["tokens"].shape[0], cfg.n_frontend_tokens, cfg.frontend_dim)
            batch["frontend"] = jnp.zeros(shape, jnp.float32)
        parts.append(np.asarray(jeng.embed(batch)))
    want = jl2_normalize(jnp.asarray(np.concatenate(parts)))
    got = embed_documents(teng, tokens, batch=16)
    assert got.shape == (40, cfg.d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_tokens_from_counts_as_the_reference_example():
    """The tokenizer's stand-in renders the same token rows as the JAX
    example's from the same counts and seed."""
    spec = importlib.util.spec_from_file_location(
        "reference_embed_and_cluster", ROOT / "examples" / "embed_and_cluster.py"
    )
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    counts = tsynth.make_corpus(64, vocab=512, n_topics=4, seed=1).counts
    want = example.tokens_from_counts(counts, 300, 16, seed=2)
    got = tsynth.tokens_from_counts(counts, 300, 16, seed=2)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_embed_feeds_buckshot_as_the_reference(rng, engines):
    """The paper's pipeline with LM embeddings: the port's Buckshot and the
    reference's on the same embeddings and sample give the same labels."""
    jb = sys.modules["repro.core.buckshot"]
    tb = sys.modules["repro_torch.core.buckshot"]
    _, teng = engines
    nb = _batch(rng, teng.cfg, 96, 16)
    x = l2_normalize(teng.embed({"tokens": torch.from_numpy(nb["tokens"])}))
    k, s = 4, 24
    sample_idx = np.sort(rng.choice(96, size=s, replace=False))
    want = jb.buckshot_fit(jnp.asarray(x.numpy()), jnp.asarray(sample_idx, jnp.int32), k)
    got = tb.buckshot_fit(x, torch.from_numpy(sample_idx), k)
    np.testing.assert_array_equal(got.sample_labels.numpy(), np.asarray(want.sample_labels))
    np.testing.assert_array_equal(
        got.kmeans.assignment.numpy(), np.asarray(want.kmeans.assignment)
    )
    np.testing.assert_allclose(got.init_centers.numpy(), np.asarray(want.init_centers), rtol=1e-5, atol=1e-6)


def test_engine_defaults_to_the_card_and_raises_without_one(engines):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, teng = engines
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg=teng.cfg, params=teng.params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_batch(teng.cfg, 1, 4, torch.Generator())


def test_make_batch_shapes():
    g = torch.Generator().manual_seed(0)
    vlm = tconfigs.get_config("paligemma-3b", reduced=True)
    b = make_batch(vlm, 2, 20, g, "cpu")
    assert b["tokens"].shape == (2, 20 - vlm.n_frontend_tokens)
    assert b["tokens"].dtype == torch.int32
    assert b["frontend"].shape == (2, vlm.n_frontend_tokens, vlm.frontend_dim)
    dense = make_batch(tconfigs.get_config("qwen2-1.5b", reduced=True), 3, 9, g, "cpu")
    assert set(dense) == {"tokens"} and dense["tokens"].shape == (3, 9)


def _run(*args: str) -> str:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "2"}
    out = subprocess.run(
        [sys.executable, *args], capture_output=True, text=True, timeout=240, env=env, cwd=ROOT
    )
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_launcher_serves_on_the_cpu():
    out = _run("-m", "repro_torch.launch.serve", "--cpu", "--requests", "3", "--max-new", "4")
    assert "3 requests, 12 tokens" in out and "tok/s" in out


def test_example_embeds_and_clusters_on_the_cpu():
    out = _run("examples/torch_embed_and_cluster.py", "--cpu", "--n", "128", "--k", "4")
    lines = [ln for ln in out.splitlines() if "+ Buckshot: purity=" in ln]
    assert len(lines) == 2 and lines[0].startswith("tf-idf")


def test_launcher_serves_rwkv_on_the_cpu():
    out = _run("-m", "repro_torch.launch.serve", "--arch", "rwkv6-3b", "--cpu",
               "--requests", "2", "--max-new", "3")
    assert "arch rwkv6-3b" in out and "2 requests, 6 tokens" in out and "tok/s" in out


def test_example_embeds_rwkv_and_clusters_on_the_cpu():
    out = _run("examples/torch_embed_and_cluster.py", "--arch", "rwkv6-3b", "--cpu",
               "--n", "128", "--k", "4")
    lines = [ln for ln in out.splitlines() if "+ Buckshot: purity=" in ln]
    assert len(lines) == 2 and lines[1].startswith("rwkv6-3b")
