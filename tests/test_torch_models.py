"""The port's model zoo (configs, layers, attention, MoE, Mamba2, RWKV-6 and
the models of all six families) against the JAX package's, on the CPU.

Configs are copies and must equal the originals field for field. Layers and
attention get the same numpy inputs in both packages and agree within
rtol 1e-5 (a few f32 ulps; atol 1e-6 where outputs cross zero); the MoE
dispatch's slots and tokens are equal as integers, drops included. Each of
the ten archs runs at its REDUCED config with the JAX params carried across
by ``params_from_jax``: forward hidden states, prefill logits and caches
(ring layout, SSM and RWKV states included) and one decode step agree within
rtol/atol 1e-4, and the port's prefill(T) + decode equals its prefill(T + 1)
within the same.
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

PORTED = jconfigs.list_archs()
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


def test_unknown_family_raises():
    jcfg, tcfg = (c.replace(family="mlp-mixer") for c in _cfgs("qwen2-1.5b"))
    with pytest.raises(ValueError, match="unknown family mlp-mixer"):
        jtransformer.model_recs(jcfg)
    with pytest.raises(ValueError, match="unknown family mlp-mixer"):
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
    """The same tree: slots per layer (gemma3's rings), encdec's enc_out,
    hybrid's SSM states and conv tails beside its shared-block caches,
    rwkv's shifts and states; every leaf zero, of the reference's dtype."""
    jcfg, tcfg = _cfgs(arch)
    want = jtransformer.init_cache(jcfg, 2, 100, jnp.bfloat16)
    got = tregistry.get_model(tcfg).init_cache(2, 100, torch.bfloat16, "cpu")
    assert _paths(got) == _paths(want)
    for (_, g), (_, w) in zip(_leaves(got), _leaves(want), strict=True):
        assert tuple(g.shape) == w.shape and not g.any()
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)


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


def _leaves(tree, path=()):
    """(path, leaf) of a cache tree (dicts, lists), dict keys sorted."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], path + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaves(sub, path + (i,))
    else:
        yield path, tree


def _paths(tree) -> list:
    return [path for path, _ in _leaves(tree)]


def _clone(tree):
    """A deep copy of a cache tree: decode writes attention caches in place."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


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


def _check_caches(got, want) -> None:
    """Every leaf of the tree (attention K/V, enc_out, SSM and RWKV states,
    conv tails and shifts) of the reference's shape, within MODEL_TOL."""
    assert _paths(got) == _paths(want)
    for (_, g), (_, w) in zip(_leaves(got), _leaves(want), strict=True):
        assert tuple(g.shape) == w.shape
        _close(g, w, MODEL_TOL)


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


# ------------------------------------------------------------------ MoE, Mamba2, RWKV-6


from repro.models import moe as jmoe  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import rwkv as trwkv  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

MOE_TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(tree: dict):
    """A numpy tree as JAX arrays and as torch tensors."""
    return (
        {k: _pair(v)[0] if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()},
        {k: _pair(v)[1] if isinstance(v, dict) else _t(v) for k, v in tree.items()},
    )


def _moe_case(rng, arch: str, cf: float, skew: bool):
    """REDUCED moe config at capacity factor ``cf``; 2 x 16 tokens. With
    ``skew`` every token's router logit for expert 0 is pushed up, so that
    expert 0 gets more choices than its slots."""
    jcfg, tcfg = (c.replace(moe=dataclasses.replace(c.moe, capacity_factor=cf)) for c in _cfgs(arch))
    p = _random_tree(rng, jmoe.moe_recs(jcfg))
    x = rng.normal(size=(2, 16, jcfg.d_model)).astype(np.float32)
    if skew:
        p["router"][:, 0] += 1.0
        x += 1.0
    return jcfg, tcfg, p, x


@pytest.mark.parametrize("arch,cf,skew", [
    ("mixtral-8x22b", 8.0, False),  # virtual experts (split 4), no drops
    ("mixtral-8x22b", 1.0, True),  # drops
    ("moonshot-v1-16b-a3b", 8.0, False),
    ("moonshot-v1-16b-a3b", 1.0, True),
])
def test_moe_apply_matches_the_reference(rng, arch, cf, skew):
    """Output within 1e-5, aux within 1e-6; the router's choices and the
    dispatch's slots (dest) and tokens (tok) equal as integers, drops too."""
    jcfg, tcfg, p, x = _moe_case(rng, arch, cf, skew)
    jp, tp = _pair(p)
    jout, jaux = jax.jit(lambda p, x: jmoe.moe_apply(p, x, jcfg))(jp, jnp.asarray(x))
    tout, taux = tmoe.moe_apply(tp, _t(x), tcfg)
    _close(tout, jout, MOE_TOL)
    _close(taux, jaux, dict(rtol=0, atol=1e-6))

    moe, t = tcfg.moe, 2 * 16
    e, k = moe.n_experts, moe.top_k
    xf = x.reshape(t, -1)
    jprobs = jax.nn.softmax(jnp.asarray(xf) @ jp["router"], axis=-1)
    jgate, jeids = jax.lax.top_k(jprobs, k)
    _, _, tgate, teids = tmoe.route(tp, _t(xf), tcfg)
    np.testing.assert_array_equal(teids.numpy(), np.asarray(jeids))
    _close(tgate, jgate / jnp.sum(jgate, axis=-1, keepdims=True), MOE_TOL)
    cap = tmoe.capacity(moe, t)
    jbuf, jdest, jtok = jmoe._dispatch_group(jnp.asarray(xf), jgate, jeids, e, k, cap)
    tbuf, tdest, ttok = tmoe._dispatch_group(_t(xf), tgate, teids, e, k, cap)
    np.testing.assert_array_equal(tdest.numpy(), np.asarray(jdest))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf)[: e * cap])
    dropped = int((tdest == e * cap).sum())
    assert (dropped > 0) == skew, dropped


def test_moe_router_ties_go_to_the_lowest_index():
    """A zero router gives every expert the same probability: the top k are
    experts 0..k-1, as ``jax.lax.top_k`` ranks them."""
    jcfg, tcfg = _cfgs("moonshot-v1-16b-a3b")
    p = {"router": np.zeros((jcfg.d_model, jcfg.moe.n_experts), np.float32)}
    x = np.ones((5, jcfg.d_model), np.float32)
    _, jeids = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(p["router"])), 2)
    _, _, gate, eids = tmoe.route({"router": _t(p["router"])}, _t(x), tcfg)
    np.testing.assert_array_equal(eids.numpy(), np.asarray(jeids))
    assert eids.tolist() == [[0, 1]] * 5 and bool((gate == 0.5).all())


def test_moe_virtual_experts_equal_the_unsplit_experts():
    """mixtral REDUCED (4 experts split 4 ways at TP = 16): the virtual-expert
    path equals each token through its top-k full-width experts (no drops)."""
    cfg = tconfigs.get_config("mixtral-8x22b", reduced=True)
    recs = tmoe.moe_recs(cfg)
    assert recs["w_gate"].shape[0] == 16
    p = tcommon.materialize(torch.Generator().manual_seed(0), recs, "cpu")
    x = torch.randn((2, 8, cfg.d_model), generator=torch.Generator().manual_seed(1))
    out, _ = tmoe.moe_apply(p, x, cfg)
    e, f, split = cfg.moe.n_experts, cfg.moe.d_ff_expert, 16 // cfg.moe.n_experts

    def unsplit(w):  # (e*split, d, f/split) -> (e, d, f)
        return w.reshape(e, split, w.shape[1], -1).permute(0, 2, 1, 3).reshape(e, w.shape[1], f)

    wg, wi = unsplit(p["w_gate"]), unsplit(p["w_in"])
    wo = p["w_out"].reshape(e, f, -1)
    xf = x.reshape(-1, cfg.d_model)
    _, _, gate, eids = tmoe.route(p, xf, cfg)
    want = torch.zeros_like(xf)
    for t in range(xf.shape[0]):
        for j in range(cfg.moe.top_k):
            ei = int(eids[t, j])
            hx = torch.nn.functional.silu(xf[t] @ wg[ei]) * (xf[t] @ wi[ei])
            want[t] += gate[t, j] * (hx @ wo[ei])
    _close(out.reshape(-1, cfg.d_model), want.numpy(), dict(rtol=2e-4, atol=2e-4))


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "moonshot-v1-16b-a3b"])
def test_moe_aux_is_at_least_one(arch):
    """The load-balance loss summed over the MoE layers through ``forward``:
    each layer's is >= 1 by Cauchy-Schwarz (Switch), so their sum is at
    least the MoE layer count."""
    cfg = tconfigs.get_config(arch, reduced=True)
    model = tregistry.get_model(cfg)
    lm = model.init_params(torch.Generator().manual_seed(7), "cpu")
    batch = tregistry.make_batch(cfg, 2, 32, torch.Generator().manual_seed(8), "cpu")
    _, aux = model.forward(lm, batch)
    assert float(aux) >= (cfg.n_layers - cfg.moe.first_k_dense) * (1.0 - 1e-3)


def _mamba(rng):
    jcfg, tcfg = _cfgs("zamba2-2.7b")
    p = _random_tree(rng, jssm.mamba_recs(jcfg))
    return jcfg, tcfg, p


@pytest.mark.parametrize("s", [16, 21, 40])  # one chunk; front-padded; 3 chunks, padded
def test_mamba_apply_matches_the_reference(rng, s):
    jcfg, tcfg, p = _mamba(rng)
    jp, tp = _pair(p)
    x = rng.normal(size=(2, s, jcfg.d_model)).astype(np.float32)
    jout, jcache = jax.jit(lambda p, x: jssm.mamba_apply(p, x, jcfg, return_cache=True))(
        jp, jnp.asarray(x)
    )
    tout, tcache = tssm.mamba_apply(tp, _t(x), tcfg, return_cache=True)
    _close(tout, jout, MOE_TOL)
    for name in ("state", "conv"):
        assert tuple(tcache[name].shape) == jcache[name].shape
        _close(tcache[name], jcache[name], MOE_TOL)


def test_mamba_decode_matches_the_reference(rng):
    jcfg, tcfg, p = _mamba(rng)
    jp, tp = _pair(p)
    x = rng.normal(size=(3, 1, jcfg.d_model)).astype(np.float32)
    shapes = jax.tree_util.tree_map(np.shape, jssm.mamba_cache_init(jcfg, 3))
    cache = {k: rng.normal(size=v).astype(np.float32) for k, v in shapes.items()}
    jcache = {k: jnp.asarray(v) for k, v in cache.items()}
    jout, jc = jax.jit(lambda *a: jssm.mamba_decode(*a, jcfg))(jp, jnp.asarray(x), jcache)
    tout, tc = tssm.mamba_decode(tp, _t(x), {k: _t(v) for k, v in cache.items()}, tcfg)
    _close(tout, jout, MOE_TOL)
    for name in ("state", "conv"):
        _close(tc[name], jc[name], MOE_TOL)


def test_ssm_prefill_state_matches_stepwise():
    """Mamba2's chunked prefill (21 tokens: front-padded to 2 chunks of 16)
    against 21 decode steps from a zero cache: outputs and the final state."""
    cfg = tconfigs.get_config("zamba2-2.7b", reduced=True)
    lm = tregistry.get_model(cfg).init_params(torch.Generator().manual_seed(9), "cpu")
    lp = lm.layers[0].mamba
    x = torch.randn((1, 21, cfg.d_model), generator=torch.Generator().manual_seed(10))
    with torch.no_grad():
        out_full, cache = tssm.mamba_apply(lp, x, cfg, return_cache=True)
        state = tssm.mamba_cache_init(cfg, 1)
        outs = []
        for t in range(21):
            o, state = tssm.mamba_decode(lp, x[:, t : t + 1], state, cfg)
            outs.append(o)
    tol = dict(rtol=5e-3, atol=5e-3)
    _close(out_full, torch.cat(outs, dim=1).numpy(), tol)
    _close(cache["state"], state["state"].numpy(), tol)
    # the conv tail holds the last projections: another matmul shape a step
    _close(cache["conv"], state["conv"].numpy(), MOE_TOL)


def _wkv_inputs(rng, b, s, h, hd):
    r, k, v = (rng.normal(size=(b, s, h, hd)).astype(np.float32) for _ in range(3))
    lw = -np.exp(rng.normal(size=(b, s, h, hd)) * 0.5 - 1.0).astype(np.float32)
    u = rng.normal(size=(h, hd)).astype(np.float32) * 0.3
    state0 = rng.normal(size=(b, h, hd, hd)).astype(np.float32)
    return r, k, v, lw, u, state0


@pytest.mark.parametrize("s,chunk", [(32, 8), (24, 24)])
def test_wkv_chunked_matches_the_scan_and_the_reference(rng, s, chunk):
    """The chunked WKV (a carried state0, up to 4 chunks) against the port's
    per-token scan and the reference's chunked form."""
    r, k, v, lw, u, state0 = _wkv_inputs(rng, 2, s, 3, 8)
    got, got_state = trwkv._wkv_chunked(*map(_t, (r, k, v, lw, u, state0)), chunk)
    scan, scan_state = trwkv._wkv_scan(_t(r), _t(k), _t(v), torch.exp(_t(lw)), _t(u), _t(state0))
    _close(got, scan.numpy(), dict(rtol=1e-4, atol=1e-4))
    _close(got_state, scan_state.numpy(), dict(rtol=1e-4, atol=1e-4))
    want, want_state = jax.jit(lambda *a: jrwkv._wkv_chunked(*a, chunk))(
        *map(jnp.asarray, (r, k, v, lw, u, state0))
    )
    _close(got, want, MOE_TOL)
    _close(got_state, want_state, MOE_TOL)


@pytest.mark.parametrize("s,cached", [(12, False), (40, False), (40, True), (1, True)])
def test_rwkv_mix_matches_the_reference(rng, s, cached):
    """timemix_apply and channelmix_apply: one chunk, 40 tokens front-padded
    to 2 chunks of 32, the same from a carried cache, and one decode token;
    outputs and new caches within MODEL_TOL (the WKV state is a sum over
    every token, in another order than XLA's)."""
    jcfg, tcfg = _cfgs("rwkv6-3b")
    tm = _random_tree(rng, jrwkv.timemix_recs(jcfg))
    # log-decays of order 1 (|dd| ~ 1, as trained RWKV-6 decays are): the
    # chunked form's cumsum of far larger ones rounds alike in neither package
    tm["decay_lora_b"] *= 0.1
    cm = _random_tree(rng, jrwkv.channelmix_recs(jcfg))
    x = rng.normal(size=(2, s, jcfg.d_model)).astype(np.float32)
    shapes = jax.tree_util.tree_map(np.shape, jrwkv.rwkv_cache_init(jcfg, 2))
    cache = {g: {k: rng.normal(size=v).astype(np.float32) for k, v in sub.items()}
             for g, sub in shapes.items()} if cached else None
    jc, tc = _pair(cache) if cached else ({"time": None, "chan": None},) * 2
    for jfn, p, name in ((jrwkv.timemix_apply, tm, "time"), (jrwkv.channelmix_apply, cm, "chan")):
        jp, tp = _pair(p)
        jout, jnew = jax.jit(lambda p, x, c, f=jfn: f(p, x, jcfg, c))(jp, jnp.asarray(x), jc[name])
        tfn = trwkv.timemix_apply if name == "time" else trwkv.channelmix_apply
        tout, tnew = tfn(tp, _t(x), tcfg, tc[name])
        _close(tout, jout, MODEL_TOL)
        for key in jnew:
            _close(tnew[key], jnew[key], MODEL_TOL)


def test_rwkv_forward_matches_stepwise():
    """The chunked time-mix over 40 tokens against 40 one-token steps (the
    scan route) carrying the shift and the state."""
    cfg = tconfigs.get_config("rwkv6-3b", reduced=True)
    lm = tregistry.get_model(cfg).init_params(torch.Generator().manual_seed(11), "cpu")
    lp = lm.layers[0].time
    x = torch.randn((1, 40, cfg.d_model), generator=torch.Generator().manual_seed(12))
    with torch.no_grad():
        out_full, cache_full = trwkv.timemix_apply(lp, x, cfg)
        cache = trwkv.rwkv_cache_init(cfg, 1)["time"]
        outs = []
        for t in range(40):
            o, cache = trwkv.timemix_apply(lp, x[:, t : t + 1], cfg, cache)
            outs.append(o)
    tol = dict(rtol=5e-3, atol=5e-3)
    _close(out_full, torch.cat(outs, dim=1).numpy(), tol)
    _close(cache_full["state"], cache["state"].numpy(), tol)
