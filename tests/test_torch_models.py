"""The port's model zoo (configs, layers, attention, the dense/vlm/encdec
models) against the JAX package's, on the CPU.

Configs are copies and must equal the originals field for field. Layers and
attention get the same numpy inputs in both packages and agree within
rtol 1e-5 (a few f32 ulps; atol 1e-6 where outputs cross zero). Each ported
arch runs at its REDUCED config with the JAX params carried across by
``params_from_jax``: forward hidden states, prefill logits and caches (ring
layout included) and one decode step agree within rtol/atol 1e-4, and the
port's prefill(T) + decode equals its prefill(T + 1) within the same.
"""

from __future__ import annotations

import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import flops as jflops
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro_torch import configs as tconfigs
from repro_torch.configs import flops as tflops
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import layers as tlayers
from repro_torch.models import registry as tregistry
from repro_torch.models import transformer as ttransformer
from repro_torch.models.interop import params_from_jax

PORTED = ["qwen2-1.5b", "llama3.2-3b", "minitron-8b", "gemma3-4b", "paligemma-3b", "whisper-base"]
UNPORTED = ["mixtral-8x22b", "zamba2-2.7b", "rwkv6-3b"]
LAYER_TOL = dict(rtol=1e-5, atol=1e-6)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def _seeded(name: str) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(f"{__name__}::{name}".encode()))


@pytest.fixture
def rng(request):
    """Seeded from the test's own name (and its parameters)."""
    return _seeded(request.node.name)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got: torch.Tensor, want, tol) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def _cfgs(arch: str, reduced: bool = True):
    return jconfigs.get_config(arch, reduced=reduced), tconfigs.get_config(arch, reduced=reduced)


# ------------------------------------------------------------------ configs


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_config_copies_equal_the_reference(arch):
    for reduced in (False, True):
        jcfg, tcfg = _cfgs(arch, reduced)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert tcfg.layer_windows() == jcfg.layer_windows()
        assert (tcfg.q_dim, tcfg.kv_dim) == (jcfg.q_dim, jcfg.kv_dim)
        assert tflops.param_counts(tcfg) == jflops.param_counts(jcfg)
        for name in jconfigs.SHAPES:
            cell = tconfigs.SHAPES[name]
            assert tflops.model_flops(tcfg, cell) == jflops.model_flops(jcfg, jconfigs.SHAPES[name])


def test_shapes_cells_and_registry_equal_the_reference():
    assert tconfigs.list_archs() == jconfigs.list_archs()
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()
    }
    assert tconfigs.LONG_CONTEXT_ARCHS == jconfigs.LONG_CONTEXT_ARCHS
    for arch in jconfigs.list_archs():
        assert tconfigs.cells_for(arch) == jconfigs.cells_for(arch)
    with pytest.raises(KeyError):
        tconfigs.get_config("gpt-5")


@pytest.mark.parametrize("arch", PORTED)
def test_recs_and_param_count_equal_the_reference(arch):
    """Every leaf's shape, spec, init rule and scale; the full config's count
    equals the reference registry's and is within 2 % of the analytic one."""
    jcfg, tcfg = _cfgs(arch, reduced=False)
    jrecs = jax.tree_util.tree_flatten_with_path(
        jtransformer.model_recs(jcfg), is_leaf=lambda r: hasattr(r, "init")
    )[0]
    want = [
        (tuple(p.key for p in path), (r.shape, tuple(r.sym), r.init, r.scale)) for path, r in jrecs
    ]
    got = [
        (path, (r.shape, tuple(r.sym), r.init, r.scale))
        for path, r in tcommon.leaves(ttransformer.model_recs(tcfg))
    ]
    assert got == want
    n = tregistry.get_model(tcfg).param_count()
    assert n == jregistry.get_model(jcfg).param_count()
    analytic = tflops.param_counts(tcfg)["total"]
    assert abs(n - analytic) / analytic < 0.02


@pytest.mark.parametrize("arch", UNPORTED)
def test_unported_families_raise(arch):
    _, tcfg = _cfgs(arch)
    with pytest.raises(NotImplementedError, match="item 12b"):
        tregistry.get_model(tcfg)


def test_init_params_defaults_to_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model = tregistry.get_model(tconfigs.get_config("qwen2-1.5b", reduced=True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(1, 8)


def test_init_params_follow_the_reference_rules():
    cfg = tconfigs.get_config("qwen2-1.5b", reduced=True)
    model = tregistry.get_model(cfg)
    a = model.init_params(torch.Generator().manual_seed(7), "cpu")
    b = model.init_params(torch.Generator().manual_seed(7), "cpu")
    for (name, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), name
    assert sum(p.numel() for p in a.parameters()) == model.param_count()
    blk = a.layers[1]
    assert torch.equal(blk.ln1["scale"], torch.ones(cfg.d_model))
    assert torch.equal(blk.attn["bq"], torch.zeros(cfg.q_dim))
    assert abs(a.embed["table"].std().item() - 0.02) < 0.002
    assert abs(blk.mlp["w_out"].std().item() * np.sqrt(cfg.d_ff) - 1.0) < 0.1
    assert not any(p.requires_grad for p in a.parameters())


@pytest.mark.parametrize("arch", PORTED)
def test_init_cache_matches_the_reference(arch):
    """Slots per layer (gemma3's rings), dtypes and encdec's enc_out."""
    jcfg, tcfg = _cfgs(arch)
    want = jtransformer.init_cache(jcfg, 2, 100, jnp.float32)
    got = tregistry.get_model(tcfg).init_cache(2, 100, torch.float32, "cpu")
    for g, w in zip(_cache_layers(got), _cache_layers(want), strict=True):
        for name in ("k", "v"):
            assert tuple(g[name].shape) == w[name].shape and not g[name].any()
            assert g[name].dtype == torch.float32
    if isinstance(want, dict):
        assert tuple(got["enc_out"].shape) == want["enc_out"].shape


# ------------------------------------------------------------------ layers


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0, 0.0])
def test_rope_matches_the_reference(rng, theta):
    x = rng.normal(size=(2, 10, 3, 2, 16)).astype(np.float32)
    pos = rng.integers(0, 300, size=(2, 10)).astype(np.int32)
    want = jattn.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    _close(tattn.rope(_t(x), _t(pos), theta), want, LAYER_TOL)


def test_norms_match_the_reference(rng):
    x = (rng.normal(size=(3, 5, 24)) * 2.0 + 0.7).astype(np.float32)
    scale = rng.normal(size=(24,)).astype(np.float32)
    bias = rng.normal(size=(24,)).astype(np.float32)
    _close(tlayers.rms_norm(_t(x), _t(scale)), jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale)), LAYER_TOL)
    want = jlayers.layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    _close(tlayers.layer_norm(_t(x), _t(scale), _t(bias)), want, LAYER_TOL)


def _random_tree(rng, recs) -> dict:
    return {
        k: _random_tree(rng, v) if isinstance(v, dict)
        else rng.normal(size=v.shape).astype(np.float32) * 0.3
        for k, v in recs.items()
    }


@pytest.mark.parametrize("act", ["silu", "gelu", "relu2"])
def test_mlp_matches_the_reference(rng, act):
    jcfg, tcfg = (c.replace(mlp_act=act) for c in _cfgs("qwen2-1.5b"))
    p = _random_tree(rng, jlayers.mlp_recs(jcfg))
    x = rng.normal(size=(2, 7, jcfg.d_model)).astype(np.float32)
    want = jlayers.mlp_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jcfg)
    got = tlayers.mlp_apply({k: _t(v) for k, v in p.items()}, _t(x), tcfg)
    _close(got, want, dict(rtol=1e-5, atol=1e-5))


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma3-4b"])  # qkv bias; qk-norm
def test_qkv_project_matches_the_reference(rng, arch):
    jcfg, tcfg = _cfgs(arch)
    p = _random_tree(rng, jlayers.attn_recs(jcfg))
    x = rng.normal(size=(2, 5, jcfg.d_model)).astype(np.float32)
    want = jlayers.qkv_project({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jcfg)
    got = tlayers.qkv_project({k: _t(v) for k, v in p.items()}, _t(x), tcfg)
    for g, w in zip(got, want):
        _close(g, w, dict(rtol=1e-5, atol=1e-5))
    o = rng.normal(size=want[0].shape).astype(np.float32)
    _close(
        tlayers.attn_out({"wo": _t(p["wo"])}, _t(o), tcfg),
        jlayers.attn_out({"wo": jnp.asarray(p["wo"])}, jnp.asarray(o), jcfg),
        dict(rtol=1e-5, atol=1e-5),
    )


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "minitron-8b"])  # tied; untied
def test_embed_and_logits_match_the_reference(rng, arch):
    jcfg, tcfg = _cfgs(arch)
    p = _random_tree(rng, jlayers.embed_recs(jcfg))
    tok = rng.integers(0, jcfg.vocab, size=(2, 6)).astype(np.int32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    h = tlayers.embed_lookup(tp, _t(tok).long(), tcfg)
    _close(h, jlayers.embed_lookup(jp, jnp.asarray(tok), jcfg), dict(rtol=0, atol=0))
    _close(tlayers.lm_logits(tp, h, tcfg), jlayers.lm_logits(jp, jnp.asarray(h.numpy()), jcfg),
           dict(rtol=1e-5, atol=1e-5))


# ------------------------------------------------------------------ attention


def _qkv(rng, b, sq, sk, hk, g, dh):
    q = rng.normal(size=(b, sq, hk, g, dh)).astype(np.float32)
    k = rng.normal(size=(b, sk, hk, dh)).astype(np.float32)
    v = rng.normal(size=(b, sk, hk, dh)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("window,causal,offset", [
    (0, True, 0), (0, False, 0), (7, True, 0), (16, True, 5), (0, True, 3),
])
def test_flash_attention_matches_the_reference(rng, window, causal, offset):
    q, k, v = _qkv(rng, 2, 33, 33 + offset, 2, 3, 16)
    kw = dict(window=window, causal=causal, q_offset=offset)
    want = jattn.flash_attention(*map(jnp.asarray, (q, k, v)), chunk=8, **kw)
    got = tattn.flash_attention(_t(q), _t(k), _t(v), chunk=8, **kw)
    _close(got, want, dict(rtol=1e-5, atol=1e-5))
    _close(tattn.reference_attention(_t(q), _t(k), _t(v), **kw), np.asarray(got), dict(rtol=2e-4, atol=2e-4))


def test_flash_attention_chunk_invariance(rng):
    q, k, v = map(_t, _qkv(rng, 1, 64, 64, 1, 2, 8))
    outs = [tattn.flash_attention(q, k, v, window=0, causal=True, chunk=c) for c in (8, 16, 64)]
    _close(outs[0], outs[1].numpy(), dict(rtol=2e-4, atol=2e-4))
    _close(outs[0], outs[2].numpy(), dict(rtol=2e-4, atol=2e-4))


@pytest.mark.parametrize("per_row", [False, True])
def test_cache_attention_matches_the_reference(rng, per_row):
    b, sc, hk, g, dh = 3, 20, 2, 3, 16
    q = rng.normal(size=(b, hk, g, dh)).astype(np.float32)
    kc = rng.normal(size=(b, sc, hk, dh)).astype(np.float32)
    vc = rng.normal(size=(b, sc, hk, dh)).astype(np.float32)
    n_valid = rng.integers(1, sc + 1, size=(b,)).astype(np.int32) if per_row else 13
    want = jattn.cache_attention(*map(jnp.asarray, (q, kc, vc)), n_valid=jnp.asarray(n_valid))
    nv = _t(n_valid) if per_row else n_valid
    _close(tattn.cache_attention(_t(q), _t(kc), _t(vc), n_valid=nv), want, dict(rtol=1e-5, atol=1e-5))


# ------------------------------------------------------------------ models


def _batches(rng, cfg, t: int, b: int = 2) -> dict:
    """A batch of t + 1 text tokens (+ the frontend for vlm/encdec), numpy."""
    out = {"tokens": rng.integers(0, cfg.vocab, size=(b, t + 1)).astype(np.int32)}
    if cfg.family in ("vlm", "encdec"):
        out["frontend"] = rng.normal(size=(b, cfg.n_frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    return out


def _prefix(batch: dict) -> dict:
    return {**batch, "tokens": batch["tokens"][:, :-1]}


def _both(arch: str):
    jcfg, tcfg = _cfgs(arch)
    jcfg = jcfg.replace(remat="none")
    key = jax.random.PRNGKey(zlib.crc32(arch.encode()) % 2**31)
    params = jax.jit(jregistry.get_model(jcfg).init_params)(key)
    lm = params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, params), "cpu")
    return jcfg, tcfg, params, lm


def _clone(caches):
    if isinstance(caches, dict):
        return {"self": _clone(caches["self"]), "enc_out": caches["enc_out"].clone()}
    return [{k: v.clone() for k, v in c.items()} for c in caches]


@pytest.fixture(scope="module", params=PORTED)
def run(request):
    """One arch through both packages: forward and prefill over T + 1
    tokens, prefill of T (capacity T + 8, past a vlm's prefix) and one
    decode step."""
    arch = request.param
    jcfg, tcfg, params, lm = _both(arch)
    t = 24
    cap = t + 8 + (jcfg.n_frontend_tokens if jcfg.family == "vlm" else 0)
    nb = _batches(_seeded(arch), jcfg, t)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: _t(v) for k, v in nb.items()}

    @jax.jit
    def reference(params, jb):
        full = jtransformer.prefill(params, jcfg, jb, jnp.float32)
        pre = jtransformer.prefill(params, jcfg, _prefix(jb), jnp.float32, cache_len=cap)
        dec = jtransformer.decode_step(params, jcfg, jb["tokens"][:, -1:], pre[1], pre[2])
        return jtransformer.forward(params, jcfg, jb)[0], full, pre, dec

    j = dict(zip(("h", "full", "pre", "dec"), reference(params, jb)))
    p = {"h": ttransformer.forward(lm, tcfg, tb)[0]}
    p["full"] = ttransformer.prefill(lm, tcfg, tb, torch.float32)
    p["pre"] = ttransformer.prefill(lm, tcfg, _prefix(tb), torch.float32, cache_len=cap)
    p["dec"] = ttransformer.decode_step(  # writes its caches in place
        lm, tcfg, tb["tokens"][:, -1:], _clone(p["pre"][1]), p["pre"][2]
    )
    return jcfg, j, p


def _cache_layers(caches):
    return caches["self"] if isinstance(caches, dict) else caches


def _check_caches(got, want) -> None:
    for g, w in zip(_cache_layers(got), _cache_layers(want), strict=True):
        for name in ("k", "v"):
            assert tuple(g[name].shape) == w[name].shape
            _close(g[name], w[name], MODEL_TOL)
    if isinstance(want, dict):
        _close(got["enc_out"], want["enc_out"], MODEL_TOL)


def test_forward_matches_the_reference(run):
    _, j, p = run
    _close(p["h"], j["h"], MODEL_TOL)


def test_prefill_matches_the_reference(run):
    _, j, p = run
    for key in ("full", "pre"):
        _close(p[key][0], j[key][0], MODEL_TOL)
        _check_caches(p[key][1], j[key][1])
        assert p[key][2] == int(j[key][2])


def test_decode_matches_the_reference_and_the_longer_prefill(run):
    """decode(prefill(T)) against JAX's, and against the port's prefill(T+1)."""
    _, j, p = run
    _close(p["dec"][0], j["dec"][0], MODEL_TOL)
    _check_caches(p["dec"][1], j["dec"][1])
    _close(p["dec"][0], p["full"][0].numpy(), MODEL_TOL)


def test_ring_cache_matches_the_reference():
    """gemma3's 5:1 layout with a prompt of two windows: the window layers
    keep a 64-slot ring, decode at position 128 writes slot 0, and its logits
    equal the forward over 129 tokens."""
    jcfg, tcfg, params, lm = _both("gemma3-4b")
    w = tcfg.window
    nb = _batches(_seeded("ring"), jcfg, 2 * w)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: _t(v) for k, v in nb.items()}
    jl, jc, jp = jax.jit(
        lambda p, b: jtransformer.prefill(p, jcfg, b, jnp.float32, cache_len=2 * w + 8)
    )(params, _prefix(jb))
    tl, tc, tp = ttransformer.prefill(lm, tcfg, _prefix(tb), torch.float32, cache_len=2 * w + 8)
    assert [c["k"].shape[1] for c in tc] == [w if x else 2 * w + 8 for x in tcfg.layer_windows()]
    _close(tl, jl, MODEL_TOL)
    _check_caches(tc, jc)
    jd, jc = jax.jit(lambda *a: jtransformer.decode_step(params, jcfg, *a))(jb["tokens"][:, -1:], jc, jp)
    td, tc = ttransformer.decode_step(lm, tcfg, tb["tokens"][:, -1:], tc, tp)
    _close(td, jd, MODEL_TOL)
    _check_caches(tc, jc)
    h, _, _ = ttransformer.forward(lm, tcfg, tb)
    _close(td, tlayers.lm_logits(lm.embed, h[:, -1], tcfg).numpy(), MODEL_TOL)
