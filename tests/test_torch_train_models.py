"""The port's training loss (``transformer.loss_fn``, ``layers.chunked_ce``,
per-layer remat) against the JAX package's, on the CPU: the dense, vlm and
encdec archs here, the moe, hybrid and rwkv ones in
``test_torch_train_families.py`` (two files, so that ``--dist loadfile``
spreads the reference's jit compiles over two workers).

Each arch runs at its REDUCED config with the JAX params carried across by
``params_from_jax``, on one numpy batch: the loss (and its ``ce`` and
``aux``) within rtol 1e-5, and every gradient leaf, read from the stacked
buffers of ``transformer.grad_buffers``, within 1e-4 of that leaf's largest
|gradient| (the two packages add the same terms in another order; a leaf's
small entries are sums that cancel). The port runs its configs' own remat
("full"); "dots" and "none" must give the same loss and grads.
"""

from __future__ import annotations

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro_torch import configs as tconfigs
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttransformer
from repro_torch.models.common import leaves
from repro_torch.models.interop import params_from_jax
from repro_torch.models.registry import get_model, make_batch

DENSE = ["qwen2-1.5b", "minitron-8b", "llama3.2-3b", "gemma3-4b", "paligemma-3b", "whisper-base"]
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4  # of each leaf's max |g|
B, T = 2, 24


def _seeded(name: str) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(f"{__name__}::{name}".encode()))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def numpy_batch(rng: np.random.Generator, cfg, b: int = B, t: int = T) -> dict:
    text = t - cfg.n_frontend_tokens if cfg.family == "vlm" else t
    out = {"tokens": rng.integers(0, cfg.vocab, size=(b, text)).astype(np.int32)}
    if cfg.family in ("vlm", "encdec"):
        out["frontend"] = rng.normal(size=(b, cfg.n_frontend_tokens, cfg.frontend_dim)).astype(
            np.float32)
    return out


def loss_run(arch: str) -> dict:
    """One arch's loss and grads in both packages, from the same weights
    and batch."""
    jcfg = jconfigs.get_config(arch, reduced=True)
    tcfg = tconfigs.get_config(arch, reduced=True)
    params = jax.jit(jregistry.get_model(jcfg).init_params)(
        jax.random.PRNGKey(zlib.crc32(arch.encode()) % 2**31))
    nb = numpy_batch(_seeded(arch), jcfg)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jtransformer.loss_fn(p, jcfg, b), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in nb.items()})
    lm = params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, params), "cpu")
    bufs = ttransformer.grad_buffers(lm)
    tl, tm = ttransformer.loss_fn(lm, tcfg, {k: _t(v) for k, v in nb.items()})
    tl.backward()
    want = {tuple(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jg)[0]}
    return dict(cfg=tcfg, lm=lm, batch=nb, bufs=bufs, grads_want=want,
                loss=(float(tl.detach()), float(jl)),
                ce=(float(tm["ce"].detach()), float(jm["ce"])),
                aux=(float(tm["aux"].detach()), float(jm["aux"])))


def check_loss(run: dict) -> None:
    for key in ("loss", "ce"):
        got, want = run[key]
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    got, want = run["aux"]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=1e-7)


def check_grads(run: dict) -> float:
    """Every leaf of the reference's gradient tree (and no other) within
    GRAD_REL of its max |g|; returns the worst ratio."""
    got = {path: g.numpy() for path, g in leaves(run["bufs"])}
    assert got.keys() == run["grads_want"].keys()
    worst = 0.0
    for path, w in run["grads_want"].items():
        assert got[path].shape == w.shape
        scale = float(np.abs(w).max())
        err = float(np.abs(got[path] - w).max())
        assert err <= GRAD_REL * max(scale, 1e-30), (path, err, scale)
        worst = max(worst, err / max(scale, 1e-30))
    return worst


@pytest.fixture(scope="module", params=DENSE)
def run(request):
    return loss_run(request.param)


def test_loss_matches_the_reference(run):
    check_loss(run)


def test_grads_match_the_reference(run):
    check_grads(run)
    # every parameter took a gradient (none left out of the graph)
    assert all(float(np.abs(g.numpy()).max()) > 0 for _, g in leaves(run["bufs"])
               if g.numel() > 1)


def test_model_loss_is_loss_fn():
    cfg = tconfigs.get_config("qwen2-1.5b", reduced=True)
    model = get_model(cfg)
    lm = model.init_params(torch.Generator().manual_seed(0), "cpu")
    b = make_batch(cfg, 2, 10, torch.Generator().manual_seed(1), "cpu")
    with torch.no_grad():
        a, am = model.loss(lm, b)
        c, cm = ttransformer.loss_fn(lm, cfg, b)
    assert float(a) == float(c) and set(am) == {"ce", "aux"} and float(am["aux"]) == 0.0


@pytest.mark.parametrize("t,chunk", [(21, 8), (16, 8), (5, 512)])
def test_chunked_ce_matches_the_reference(t, chunk):
    """Value and grads (hidden states and table) against the reference's
    chunked_ce, whose last chunk is padded with weight-0 rows."""
    rng = _seeded(f"ce{t}{chunk}")
    for tied in (True, False):
        cfg = tconfigs.get_config("qwen2-1.5b", reduced=True).replace(tie_embeddings=tied)
        jcfg = jconfigs.get_config("qwen2-1.5b", reduced=True).replace(tie_embeddings=tied)
        d, v = cfg.d_model, cfg.vocab
        p = {"table": rng.normal(size=(v, d)).astype(np.float32) * 0.1}
        if not tied:
            p["head"] = rng.normal(size=(d, v)).astype(np.float32) * 0.1
        h = rng.normal(size=(3, t, d)).astype(np.float32)
        labels = rng.integers(0, v, size=(3, t)).astype(np.int32)
        jv, (jgp, jgh) = jax.value_and_grad(
            lambda p, h: jlayers.chunked_ce(p, h, jnp.asarray(labels), jcfg, chunk),
            argnums=(0, 1))({k: jnp.asarray(a) for k, a in p.items()}, jnp.asarray(h))
        tp = {k: _t(a).requires_grad_(True) for k, a in p.items()}
        th = _t(h).requires_grad_(True)
        tv = tlayers.chunked_ce(tp, th, _t(labels), cfg, chunk)
        tv.backward()
        np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=LOSS_RTOL)
        for got, want in [(th.grad, jgh)] + [(tp[k].grad, jgp[k]) for k in p]:
            w = np.asarray(want)
            if got is None:  # the untied table does not reach the logits
                assert not w.any()
                continue
            np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                       atol=GRAD_REL * float(np.abs(w).max()))


def test_chunked_ce_is_chunk_invariant():
    rng = _seeded("invariant")
    cfg = tconfigs.get_config("qwen2-1.5b", reduced=True)
    p = {"table": _t(rng.normal(size=(cfg.vocab, cfg.d_model)).astype(np.float32))}
    h = _t(rng.normal(size=(2, 37, cfg.d_model)).astype(np.float32))
    labels = _t(rng.integers(0, cfg.vocab, size=(2, 37)))
    with torch.no_grad():
        vals = [float(tlayers.chunked_ce(p, h, labels, cfg, c)) for c in (1, 7, 37, 512)]
    np.testing.assert_allclose(vals, vals[-1], rtol=1e-6)


def test_chunked_ce_recomputes_each_chunk_in_backward(monkeypatch):
    """A graph-building call checkpoints each chunk: backward runs the logits
    product again (2 chunks -> 4 calls), a no-grad call once per chunk."""
    cfg = tconfigs.get_config("qwen2-1.5b", reduced=True)
    calls = []
    inner = tlayers.lm_logits
    monkeypatch.setattr(tlayers, "lm_logits", lambda *a: calls.append(1) or inner(*a))
    table = torch.randn((cfg.vocab, cfg.d_model), requires_grad=True)
    h = torch.randn((2, 12, cfg.d_model))
    labels = torch.randint(0, cfg.vocab, (2, 12))
    tlayers.chunked_ce({"table": table}, h, labels, cfg, 8).backward()
    assert len(calls) == 4
    with torch.no_grad():
        tlayers.chunked_ce({"table": table}, h, labels, cfg, 8)
    assert len(calls) == 6


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "zamba2-2.7b", "rwkv6-3b", "whisper-base"])
def test_remat_policies_give_the_same_loss_and_grads(arch):
    """'full', 'dots' and 'none' recompute the same ops on the same inputs:
    the loss and grads equal bit for bit."""
    base = tconfigs.get_config(arch, reduced=True)
    nb = numpy_batch(_seeded(arch), base)
    out = {}
    for remat in ("none", "full", "dots"):
        cfg = base.replace(remat=remat)
        lm = get_model(cfg).init_params(torch.Generator().manual_seed(5), "cpu")
        bufs = ttransformer.grad_buffers(lm)
        loss, _ = ttransformer.loss_fn(lm, cfg, {k: _t(v) for k, v in nb.items()})
        loss.backward()
        out[remat] = (loss.detach(), [g.clone() for _, g in leaves(bufs)])
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        assert all(torch.equal(a, b) for a, b in zip(out[remat][1], out["none"][1], strict=True))


def test_remat_checkpoints_each_layer(monkeypatch):
    """With grad on, 'full' wraps every layer call in a checkpoint; without
    grad (serving) nothing is wrapped."""
    cfg = tconfigs.get_config("qwen2-1.5b", reduced=True)
    lm = get_model(cfg).init_params(torch.Generator().manual_seed(0), "cpu")
    b = make_batch(cfg, 1, 6, torch.Generator().manual_seed(1), "cpu")
    wrapped = []
    inner = ttransformer.ckpt.checkpoint
    monkeypatch.setattr(ttransformer.ckpt, "checkpoint",
                        lambda fn, *a, **k: wrapped.append(k.get("context_fn")) or inner(fn, *a, **k))
    ttransformer.forward(lm, cfg, b)
    assert wrapped == []  # no parameter takes gradients yet
    ttransformer.grad_buffers(lm)
    ttransformer.forward(lm, cfg, b)
    assert len(wrapped) == cfg.n_layers and wrapped[0] is None
    ttransformer.forward(lm, cfg.replace(remat="dots"), b)
    assert len(wrapped) == 2 * cfg.n_layers and wrapped[-1] is not None
    ttransformer.forward(lm, cfg.replace(remat="none"), b)
    with torch.no_grad():
        ttransformer.forward(lm, cfg, b)
    assert len(wrapped) == 2 * cfg.n_layers


def test_dots_policy_saves_plain_matmuls_only():
    pol = ttransformer._dots_policy
    save = ttransformer.ckpt.CheckpointPolicy.MUST_SAVE
    assert pol(None, torch.ops.aten.mm.default) == save
    assert pol(None, torch.ops.aten.addmm.default) == save
    assert pol(None, torch.ops.aten.bmm.default) != save  # batch dims: recomputed
    assert pol(None, torch.ops.aten.exp.default) != save
