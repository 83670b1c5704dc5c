"""The port's training substrate (optimizer, data, train step, checkpoints,
loop, int8 compression, launcher) against the JAX package's, on the CPU.

Mirrors every test of ``tests/test_train.py`` on the port except the
sharding-metadata ones (``zero_rec``, ``fsdp_recs``: held to the reference
in ``tests/test_torch_launch.py``, the sharded step in
``tests/test_torch_train_sharded.py``), and holds the port to the
reference on equal inputs:

  * ``update`` on identical numpy params, grads and moments: ``lr`` and
    ``grad_norm`` within rtol 2e-6, params, m and v within 8 f32 ulps of
    each leaf's largest magnitude (XLA and torch sum a leaf's squares in
    another order, so the norm and the clip scale may differ in the last
    bit, and ``cos``/``pow`` may round it apart; ``b1 m + (1 - b1) g``
    cancels, so the bound is on the leaf's scale, not each entry's);
  * ``quantize``/``fake_compress``/``compress_with_feedback``: ``q`` and the
    scales bit-equal; ``compressed_psum`` over 2 gloo ranks equal to the
    reference's own function under ``jax.vmap`` with a named axis;
  * the data seam: the reference's own draws through ``tokens_from_draws``
    give its tokens, but where ``(u^-0.5 - 1) * vocab / 40`` lies within
    4 f32 ulps of an integer (XLA may compute ``u ** -0.5`` as a ``rsqrt``
    that is not correctly rounded, so ``floor`` may fall either side);
  * 5 train steps of qwen2 at REDUCED with grad_accum 2 from the
    reference's weights on its batches: losses within rtol 1e-4, params
    within atol 1e-5 (the reference's own ``test_grad_accum_matches_full_batch``
    bound), moments within 1e-4 of each leaf's largest magnitude;
  * checkpoints written by either package restore in the other with equal
    arrays; the port's resume is bit for bit.
"""

from __future__ import annotations

import os
import runpy
import subprocess
import sys
import textwrap
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # offline container: skip property-based tests only
    from hypothesis_stub import given, settings, st

from repro import configs as jconfigs
from repro.distrib import compression as jcomp
from repro.models import registry as jregistry
from repro.train import checkpoint as jckpt
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch.distrib import compression
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as ttransformer
from repro_torch.models.common import leaves
from repro_torch.models.interop import params_from_jax, params_to_tree
from repro_torch.models.registry import get_model, make_batch
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import data as data_mod
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import step as step_mod
from repro_torch.train.loop import StragglerMonitor, train
from repro_torch.train.optimizer import AdamWConfig

ROOT = Path(__file__).resolve().parents[1]
CFG = tconfigs.get_config("qwen2-1.5b", reduced=True)
JCFG = jconfigs.get_config("qwen2-1.5b", reduced=True)
OPT_TOL = dict(rtol=2e-6, atol=1e-12)
LEAF_ULPS = 8


def _leaf_close(got: np.ndarray, want: np.ndarray, ulps: int = LEAF_ULPS) -> None:
    """Within ``ulps`` f32 ulps of the leaf's largest |value|."""
    tol = ulps * np.spacing(np.float32(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
STEP_LOSS_RTOL, STEP_PARAM_ATOL = 1e-4, 1e-5


def _seeded(name: str) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(f"{__name__}::{name}".encode()))


@pytest.fixture
def rng(request):
    """Seeded from the test's own name (and its parameters)."""
    return _seeded(request.node.name)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jleaves(tree) -> dict:
    return {tuple(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ------------------------------------------------------------------ optimizer


def test_adamw_decreases_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0, total_steps=100)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt_mod.init(params)
    for _ in range(60):
        grads = {"w": 2.0 * params["w"]}  # d/dw ||w||^2
        params, state, _ = opt_mod.update(cfg, params, grads, state)
    assert float(params["w"].abs().max()) < 0.5


def test_schedule_warmup_and_decay():
    cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    lrs = [float(opt_mod.schedule(cfg, torch.tensor(s))) for s in range(101)]
    assert lrs[0] == 0.0
    assert abs(lrs[10] - 1e-3) / 1e-3 < 0.02
    assert lrs[100] == pytest.approx(1e-4, rel=0.01)
    assert all(b <= a * 1.0001 for a, b in zip(lrs[10:], lrs[11:])), "monotone decay"


def test_schedule_matches_the_reference():
    cfg = AdamWConfig(lr=3e-4, warmup_steps=7, total_steps=50, min_lr_frac=0.1)
    jcfg = jopt.AdamWConfig(lr=3e-4, warmup_steps=7, total_steps=50, min_lr_frac=0.1)
    got = np.array([float(opt_mod.schedule(cfg, torch.tensor(s, dtype=torch.int32)))
                    for s in range(60)], np.float32)
    want = np.array([float(jopt.schedule(jcfg, jnp.asarray(s, jnp.int32))) for s in range(60)],
                    np.float32)
    np.testing.assert_allclose(got, want, **OPT_TOL)


def test_grad_clipping_bounds_update():
    cfg = AdamWConfig(lr=1.0, grad_clip=1.0, weight_decay=0.0, warmup_steps=0)
    params = {"w": torch.zeros((4,))}
    state = opt_mod.init(params)
    _, _, stats = opt_mod.update(cfg, params, {"w": torch.full((4,), 1e6)}, state)
    assert float(stats["grad_norm"]) > 1e5  # reported norm is pre-clip


def _opt_tree(rng):
    return {
        "a": {"w": rng.normal(size=(3, 5, 7)).astype(np.float32)},
        "b": rng.normal(size=(11,)).astype(np.float32),
        "c": {"x": rng.normal(size=(4, 6)).astype(np.float32),
              "y": rng.normal(size=(2,)).astype(np.float32)},
    }


@pytest.mark.parametrize("grad_scale", [0.01, 100.0])  # under and over the clip
def test_update_matches_the_reference(rng, grad_scale):
    """Four AdamW steps on identical numpy params and grads (a nested tree):
    params, m, v, lr and grad_norm within OPT_TOL."""
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6)
    jcfg = jopt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6)
    p0 = _opt_tree(rng)
    grads = [jax.tree_util.tree_map(lambda a: (a * grad_scale).astype(np.float32), _opt_tree(rng))
             for _ in range(4)]
    jp, js = jax.tree_util.tree_map(jnp.asarray, p0), jopt.init(p0)
    tp = jax.tree_util.tree_map(_t, p0)
    ts = opt_mod.init(tp)
    for g in grads:
        jp, js, jst = jopt.update(jcfg, jp, jax.tree_util.tree_map(jnp.asarray, g), js)
        tp, ts, tst = opt_mod.update(cfg, tp, jax.tree_util.tree_map(_t, g), ts)
        for key in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tst[key]), float(jst[key]), **OPT_TOL)
    assert int(ts["step"]) == int(js["step"]) == 4
    assert ts["step"].dtype == torch.int32 and ts["m"]["b"].dtype == torch.float32
    for got, want in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
        for path, w in _jleaves(want).items():
            g = got
            for k in path:
                g = g[k]
            _leaf_close(g.numpy(), w)


def test_global_norm_matches_the_reference(rng):
    tree = _opt_tree(rng)
    np.testing.assert_allclose(float(opt_mod.global_norm(jax.tree_util.tree_map(_t, tree))),
                               float(jopt.global_norm(tree)), **OPT_TOL)


def test_opt_state_round_trips_through_the_reference_layout(rng):
    tree = _opt_tree(rng)
    state = jopt.init(tree)
    state["step"] = jnp.asarray(5, jnp.int32)
    port = opt_mod.opt_state_from_jax(_np_tree(state), "cpu")
    assert port["step"].device.type == "cpu" and int(port["step"]) == 5
    back = opt_mod.opt_state_to_tree(port)
    assert _jleaves(back).keys() == _jleaves(state).keys()
    for path, w in _jleaves(state).items():
        np.testing.assert_array_equal(_jleaves(back)[path], w)


# ------------------------------------------------------------------ data


def test_data_skip_ahead_deterministic():
    dcfg = data_mod.DataConfig(vocab=512, batch=4, seq=16, seed=3)
    b1 = data_mod.lm_batch(dcfg, 7, "cpu")
    b2 = data_mod.lm_batch(dcfg, 7, "cpu")  # same step -> same batch, no stream state
    np.testing.assert_array_equal(b1["tokens"].numpy(), b2["tokens"].numpy())
    b3 = data_mod.lm_batch(dcfg, 8, "cpu")
    assert not np.array_equal(b1["tokens"].numpy(), b3["tokens"].numpy())
    other_seed = data_mod.lm_batch(data_mod.DataConfig(vocab=512, batch=4, seq=16, seed=4), 7, "cpu")
    assert not np.array_equal(b1["tokens"].numpy(), other_seed["tokens"].numpy())


def test_data_tokens_in_range():
    dcfg = data_mod.DataConfig(vocab=100, batch=8, seq=32, seed=0)
    t = data_mod.lm_batch(dcfg, 0, "cpu")["tokens"]
    assert t.dtype == torch.int32 and t.shape == (8, 32)
    assert int(t.min()) >= 0 and int(t.max()) < 100


def test_data_draws_follow_the_reference_law():
    u, mix = data_mod.draws(data_mod.DataConfig(vocab=512, batch=64, seq=256, seed=5), 2)
    assert u.dtype == torch.float32 and float(u.min()) >= 1e-6 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.01 and abs(float(mix.float().mean()) - 0.5) < 0.01


@pytest.mark.parametrize("vocab,seed", [(512, 0), (151936, 3), (100, 1)])
def test_data_seam_matches_the_reference(vocab, seed):
    """The reference's own uniforms and coin flips (its keys, its calls)
    through the port's transform give the reference's tokens, but at
    near-integer values of the transform (and the token after such a
    position, which copies it where ``mix`` is false)."""
    n_near = 0
    for step in range(12):
        cfg = jdata.DataConfig(vocab=vocab, batch=8, seq=128, seed=seed)
        k1, k2 = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), step))
        u = np.asarray(jax.random.uniform(k1, (8, 128), minval=1e-6))
        mix = np.asarray(jax.random.bernoulli(k2, 0.5, (8, 128)))
        want = np.asarray(jdata.lm_batch(cfg, step)["tokens"])
        got = data_mod.tokens_from_draws(_t(u), _t(mix), vocab).numpy()
        x = (u.astype(np.float64) ** -0.5 - 1.0) * vocab / 40.0
        near = np.abs(x - np.round(x)) <= 4 * np.spacing(np.float32(x))
        allowed = (near & mix) | (np.roll(near, 1, axis=1) & ~mix)
        assert not ((got != want) & ~allowed).any()
        n_near += int(near.sum())
    assert n_near <= 8 * 128 * 12 // 100  # the exception stays an exception


def test_frontend_batch_is_deterministic():
    dcfg = data_mod.DataConfig(vocab=64, batch=2, seq=8, seed=0)
    a = data_mod.frontend_batch(dcfg, 3, 5, 7, "cpu")
    assert a.shape == (2, 5, 7) and a.dtype == torch.float32
    assert torch.equal(a, data_mod.frontend_batch(dcfg, 3, 5, 7, "cpu"))
    assert not torch.equal(a, data_mod.frontend_batch(dcfg, 4, 5, 7, "cpu"))


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CUDA default without a card")
def test_entry_points_default_to_the_card():
    dcfg = data_mod.DataConfig(vocab=64, batch=2, seq=8, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        data_mod.lm_batch(dcfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(CFG, steps=1, batch=2, seq=8, log_every=0)


# ------------------------------------------------------------------ model trainable


def test_grad_buffers_alias_the_stacked_tree():
    """Every parameter is a view of ``LM.stacked``; its ``.grad`` is a view
    of the stacked buffer, so backward and in-place updates land in the
    reference's layout."""
    lm = get_model(CFG).init_params(torch.Generator().manual_seed(0), "cpu")
    assert not any(p.requires_grad for p in lm.parameters())  # serving builds no graph
    bufs = ttransformer.grad_buffers(lm)
    n = 0
    for path, views in lm.views().items():
        t, g = lm.stacked, bufs
        for key in path:
            t, g = t[key], g[key]
        for idx, p in views:
            want = t if idx is None else t[idx]
            assert p.requires_grad and p.data_ptr() == want.data_ptr() and p.shape == want.shape
            assert p.grad.data_ptr() == (g if idx is None else g[idx]).data_ptr()
            n += p.numel()
    assert n == get_model(CFG).param_count()
    b = make_batch(CFG, 2, 9, torch.Generator().manual_seed(1), "cpu")
    ttransformer.loss_fn(lm, CFG, b)[0].backward()
    assert float(bufs["layers"]["attn"]["wq"][1].abs().sum()) > 0
    with torch.no_grad():
        lm.stacked["layers"]["mlp"]["w_in"][1].add_(1.0)
    assert torch.equal(lm.layers[1].mlp["w_in"], lm.stacked["layers"]["mlp"]["w_in"][1])


def test_params_to_tree_inverts_params_from_jax():
    params = jax.jit(jregistry.get_model(JCFG).init_params)(jax.random.PRNGKey(4))
    tree = params_to_tree(params_from_jax(CFG, _np_tree(params), "cpu"))
    want = _jleaves(params)
    assert _jleaves(tree).keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_array_equal(_jleaves(tree)[path], w)


# ------------------------------------------------------------------ steps against the reference


@pytest.fixture(scope="module")
def five_steps():
    """5 AdamW steps of qwen2 at REDUCED in both packages, from the
    reference's weights, on the reference's batches, with qwen2's own
    grad_accum=2 (the published config's; REDUCED sets 1): the microbatches
    are the same rows in both."""
    jcfg, tcfg = JCFG.replace(grad_accum=2), CFG.replace(grad_accum=2)
    params = jax.jit(jregistry.get_model(jcfg).init_params)(jax.random.PRNGKey(7))
    lm = params_from_jax(tcfg, _np_tree(params), "cpu")
    jopt_cfg = jopt.AdamWConfig(total_steps=5, warmup_steps=5)
    opt_cfg = AdamWConfig(total_steps=5, warmup_steps=5)
    jfn = jax.jit(jstep.make_train_step(jcfg, jopt_cfg))
    tfn = step_mod.make_train_step(tcfg, opt_cfg)
    js, ts = jopt.init(params), opt_mod.init(lm.stacked)
    dcfg = jdata.DataConfig(vocab=JCFG.vocab, batch=4, seq=32, seed=2)
    jm, tm = [], []
    for step in range(5):
        b = jdata.lm_batch(dcfg, step)
        params, js, m1 = jfn(params, js, b)
        lm, ts, m2 = tfn(lm, ts, {"tokens": _t(b["tokens"])})
        jm.append({k: float(v) for k, v in m1.items()})
        tm.append({k: float(v) for k, v in m2.items()})
    return params, js, jm, lm, ts, tm


def test_train_steps_match_the_reference(five_steps):
    params, js, jm, lm, ts, tm = five_steps
    assert set(tm[0]) == set(jm[0]) == {"loss", "ce", "aux", "lr", "grad_norm"}
    for a, b in zip(tm, jm):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=STEP_LOSS_RTOL)
        np.testing.assert_allclose(a["ce"], b["ce"], rtol=STEP_LOSS_RTOL)
        np.testing.assert_allclose(a["lr"], b["lr"], **OPT_TOL)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-4)
    got = _jleaves(params_to_tree(lm))
    for path, w in _jleaves(params).items():
        np.testing.assert_allclose(got[path], w, atol=STEP_PARAM_ATOL, rtol=0)


def test_train_steps_moments_match_the_reference(five_steps):
    _, js, _, _, ts, _ = five_steps
    assert int(ts["step"]) == int(js["step"]) == 5
    for key in ("m", "v"):
        got = _jleaves(opt_mod.opt_state_to_tree(ts)[key])
        for path, w in _jleaves(js[key]).items():
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(got[path] - w).max()) <= 1e-4 * scale, (key, path)


def _one_step(cfg, lm, b, **kw):
    st = opt_mod.init(lm.stacked)
    return step_mod.make_train_step(cfg, AdamWConfig(), **kw)(lm, st, b)


def test_grad_accum_matches_full_batch():
    """grad_accum=4 gives the update of one big batch (equal microbatches,
    f32 accumulation), as the reference's own test asks of it."""
    g = torch.Generator().manual_seed(0)
    p = get_model(CFG).init_params(g, "cpu")
    b = make_batch(CFG, 4, 32, torch.Generator().manual_seed(1), "cpu")
    p1 = get_model(CFG).init_params(torch.Generator().manual_seed(0), "cpu")
    p4 = get_model(CFG).init_params(torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(a, c) for (_, a), (_, c) in zip(leaves(p1.stacked), leaves(p.stacked)))
    _, _, m1 = _one_step(CFG, p1, b)
    _, _, m4 = _one_step(CFG.replace(grad_accum=4), p4, b)
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-4
    for (_, a), (_, c) in zip(leaves(p1.stacked), leaves(p4.stacked)):
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=1e-5, rtol=0)


def test_train_step_refuses_params_that_are_not_f32():
    lm = get_model(CFG).init_params(torch.Generator().manual_seed(0), "cpu", torch.bfloat16)
    b = make_batch(CFG, 2, 8, torch.Generator().manual_seed(1), "cpu")
    with pytest.raises(TypeError, match="f32"):
        _one_step(CFG, lm, b)


def test_eval_step_is_the_loss_without_a_graph():
    lm = get_model(CFG).init_params(torch.Generator().manual_seed(2), "cpu")
    ttransformer.grad_buffers(lm)
    b = make_batch(CFG, 2, 12, torch.Generator().manual_seed(3), "cpu")
    out = step_mod.make_eval_step(CFG)(lm, b)
    assert set(out) == {"loss", "ce", "aux"} and not out["loss"].requires_grad
    with torch.no_grad():
        assert float(out["loss"]) == float(ttransformer.loss_fn(lm, CFG, b)[0])


def test_prefill_and_decode_steps_are_the_models():
    lm = get_model(CFG).init_params(torch.Generator().manual_seed(2), "cpu")
    b = make_batch(CFG, 2, 6, torch.Generator().manual_seed(3), "cpu")
    logits, caches, pos = step_mod.make_prefill_step(CFG)(lm, b)
    want = ttransformer.prefill(lm, CFG, b)[0]
    assert torch.equal(logits, want) and pos == 6
    out, _ = step_mod.make_decode_step(CFG)(lm, b["tokens"][:, -1:], caches, pos)
    assert out.shape == (2, CFG.vocab)


# ------------------------------------------------------------------ loop


def test_train_loss_decreases():
    res = train(CFG, steps=30, batch=4, seq=32, log_every=0, seed=0, device="cpu")
    first = np.mean(res.losses[:5])
    last = np.mean(res.losses[-5:])
    assert last < first, f"loss did not fall: {first} -> {last}"
    assert len(res.step_s) == 30 and res.step == 30


def test_checkpoint_resume_bitwise(tmp_path):
    d = str(tmp_path / "ck")
    full = train(CFG, steps=20, batch=2, seq=16, ckpt_dir=None, log_every=0, seed=1, device="cpu")

    # run 12 steps, checkpoint at 10, resume to 20
    with pytest.raises(KeyboardInterrupt):
        train(CFG, steps=20, batch=2, seq=16, ckpt_dir=d, ckpt_every=10,
              log_every=0, seed=1, preempt_at=12, device="cpu")
    resumed = train(CFG, steps=20, batch=2, seq=16, ckpt_dir=d, ckpt_every=10,
                    log_every=0, seed=1, device="cpu")
    assert resumed.resumed_from == 10
    assert resumed.losses == full.losses[10:]
    for (_, a), (_, b) in zip(leaves(full.params.stacked), leaves(resumed.params.stacked),
                              strict=True):
        assert torch.equal(a, b)
    for key in ("m", "v"):
        for (_, a), (_, b) in zip(leaves(full.opt_state[key]), leaves(resumed.opt_state[key])):
            assert torch.equal(a, b)


def test_checkpoint_atomicity(tmp_path):
    d = str(tmp_path / "ck")
    tree = {"a": torch.arange(5), "b": {"c": torch.ones((2, 2))}}
    ckpt_mod.save(d, 3, tree)
    # a later incomplete checkpoint must be ignored
    os.makedirs(os.path.join(d, "step_00000009"))
    assert ckpt_mod.latest_step(d) == 3
    restored, step = ckpt_mod.restore_latest(d, tree, "cpu")
    assert step == 3
    np.testing.assert_array_equal(restored["a"].numpy(), np.arange(5))
    assert not [n for n in os.listdir(d) if n.startswith(".tmp_")]


def test_checkpoint_overwrite_same_step(tmp_path):
    d = str(tmp_path / "ck")
    ckpt_mod.save(d, 1, {"x": torch.zeros(3)})
    ckpt_mod.save(d, 1, {"x": torch.ones(3)})
    restored, _ = ckpt_mod.restore_latest(d, {"x": torch.zeros(3)}, "cpu")
    np.testing.assert_array_equal(restored["x"].numpy(), np.ones(3))


def test_checkpoint_failed_write_leaves_no_directory(tmp_path, monkeypatch):
    d = str(tmp_path / "ck")

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod.np, "savez", boom)
    with pytest.raises(OSError):
        ckpt_mod.save(d, 2, {"x": torch.zeros(3)})
    assert os.listdir(d) == [] and ckpt_mod.latest_step(d) is None


def test_straggler_monitor_fires():
    mon = StragglerMonitor(threshold=2.0)
    fired = []
    mon.callback = lambda step, dt, ewma: fired.append(step)
    for i in range(10):
        mon.observe(i, 1.0)
    assert not mon.events
    mon.observe(10, 5.0)  # 5x the EWMA -> straggler
    assert mon.events and fired == [10]
    # EWMA must NOT absorb the straggler step
    assert abs(mon.ewma - 1.0) < 1e-6


def test_grad_compression_train_runs():
    res = train(CFG, steps=6, batch=2, seq=16, log_every=0, grad_compress=True, device="cpu")
    assert np.isfinite(res.losses).all()


# ------------------------------------------------------------------ checkpoints across packages


@pytest.fixture(scope="module")
def trained_pair(five_steps):
    """Both packages' {"params", "opt"} after the reference's 5 steps (the
    port's carried across)."""
    params, js = five_steps[0], five_steps[1]
    jstate = {"params": params, "opt": js}
    lm = params_from_jax(CFG, _np_tree(params), "cpu")
    tstate = {"params": lm.stacked, "opt": opt_mod.opt_state_from_jax(_np_tree(js), "cpu")}
    return jstate, tstate


def test_jax_checkpoint_restores_in_the_port(tmp_path, trained_pair):
    jstate, tstate = trained_pair
    d = str(tmp_path / "ck")
    jckpt.save(d, 5, jstate, meta={"arch": JCFG.name})
    like = {"params": get_model(CFG).init_params(torch.Generator().manual_seed(0), "cpu").stacked,
            "opt": opt_mod.init(tstate["params"])}
    restored, step = ckpt_mod.restore_latest(d, like, "cpu")
    assert step == 5
    got = _jleaves(jax.tree_util.tree_map(lambda t: t.numpy(), restored))
    want = _jleaves(_np_tree(jstate))
    assert got.keys() == want.keys()
    for path, w in want.items():
        assert got[path].dtype == w.dtype
        np.testing.assert_array_equal(got[path], w)


def test_port_checkpoint_restores_in_jax(tmp_path, trained_pair):
    jstate, tstate = trained_pair
    d = str(tmp_path / "ck")
    path = ckpt_mod.save(d, 5, tstate, meta={"arch": CFG.name})
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = f.read()
    assert str(jax.tree_util.tree_structure(jstate)) in manifest
    like = jax.tree_util.tree_map(jnp.zeros_like, jstate)
    restored, step = jckpt.restore_latest(d, like)
    assert step == 5
    for (_, g), (_, w) in zip(_jleaves(restored).items(), _jleaves(jstate).items(), strict=True):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_train_resumes_from_a_jax_checkpoint(tmp_path, trained_pair):
    """The port's loop picks up the reference's checkpoint: its first step
    starts from the reference's params, moments and step counter."""
    jstate, _ = trained_pair
    d = str(tmp_path / "ck")
    jckpt.save(d, 5, jstate)
    res = train(CFG, steps=6, batch=2, seq=16, ckpt_dir=d, log_every=0, seed=0, device="cpu")
    assert res.resumed_from == 5 and len(res.losses) == 1 and int(res.opt_state["step"]) == 6


# ------------------------------------------------------------------ compression


def test_quantize_roundtrip_error_bounded(rng):
    g = _t(rng.normal(size=(128,)).astype(np.float32))
    q, s = compression.quantize(g)
    deq = compression.dequantize(q, s)
    assert q.dtype == torch.int8
    assert float((deq - g).abs().max()) <= float(s) * 0.5 + 1e-9


def test_error_feedback_preserves_mean_update(rng):
    """With error feedback, the ACCUMULATED compressed updates converge to the
    accumulated true gradients (Seide et al. property)."""
    g = _t(rng.normal(size=(64,)).astype(np.float32)) * 1e-3
    grads = {"w": g}
    errors = compression.init_error_feedback(grads)
    total = torch.zeros_like(g)
    for _ in range(50):
        wire, errors = compression.compress_with_feedback(grads, errors)
        total = total + wire["w"]
    np.testing.assert_allclose(total.numpy(), (g * 50).numpy(), rtol=0.05, atol=1e-4)


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), scale=st.floats(1e-6, 1e6))
def test_quantize_property(seed, scale):
    r = np.random.default_rng(seed)
    g = _t((r.normal(size=(32,)) * scale).astype(np.float32))
    q, s = compression.quantize(g)
    assert int(q.to(torch.int32).abs().max()) <= 127
    deq = compression.dequantize(q, s)
    np.testing.assert_allclose(deq.numpy(), g.numpy(), atol=float(s) * 0.51 + 1e-12)


@pytest.mark.parametrize("scale", [1e-8, 1.0, 3e4])
def test_quantize_matches_the_reference(rng, scale):
    """q and the scale bit for bit, halves included (both round to even)."""
    g = (rng.normal(size=(257,)) * scale).astype(np.float32)
    g[:9] = np.float32(np.abs(g).max()) * np.array([0.5, -0.5, 1.5, 2.5, -2.5, 0, 1, -1, 3.5],
                                                   np.float32) / 127
    jq, js = jcomp.quantize(jnp.asarray(g))
    tq, ts = compression.quantize(_t(g))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert np.float32(ts) == np.float32(js)
    np.testing.assert_array_equal(compression.dequantize(tq, ts).numpy(),
                                  np.asarray(jcomp.dequantize(jq, js)))


def test_zero_gradient_quantizes_to_zero():
    q, s = compression.quantize(torch.zeros(5))
    assert int(q.abs().max()) == 0 and float(s) == np.float32(1e-12) / np.float32(127)


def test_fake_compress_matches_the_reference(rng):
    tree = _opt_tree(rng)
    want = jcomp.fake_compress(jax.tree_util.tree_map(jnp.asarray, tree))
    got = compression.fake_compress(jax.tree_util.tree_map(_t, tree))
    for path, w in _jleaves(want).items():
        g = got
        for k in path:
            g = g[k]
        np.testing.assert_array_equal(g.numpy(), w)


def test_compress_with_feedback_matches_the_reference(rng):
    """Five rounds of the same grads: wire grads and residuals bit for bit."""
    tree = jax.tree_util.tree_map(lambda a: a * np.float32(1e-3), _opt_tree(rng))
    jerr = jcomp.init_error_feedback(tree)
    terr = compression.init_error_feedback(jax.tree_util.tree_map(_t, tree))
    for _ in range(5):
        jw, jerr = jcomp.compress_with_feedback(jax.tree_util.tree_map(jnp.asarray, tree), jerr)
        tw, terr = compression.compress_with_feedback(jax.tree_util.tree_map(_t, tree), terr)
        for want, got in ((jw, tw), (jerr, terr)):
            for path, w in _jleaves(want).items():
                g = got
                for k in path:
                    g = g[k]
                np.testing.assert_array_equal(g.numpy(), w)


def _env() -> dict:
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}


_PSUM_RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.distrib.compression import compressed_psum
    from repro_torch.distrib.sharding import make_flat_mesh
    rank, init, data, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank, world_size=2)
    g = torch.from_numpy(np.load(data)[rank])
    got = compressed_psum(g, make_flat_mesh(), ("data",))
    np.save(out + f".{rank}.npy", got.numpy())
    dist.destroy_process_group()
""")


def test_compressed_psum_over_gloo_matches_the_reference(tmp_path, rng):
    """P = 2 gloo ranks (processes, a file rendezvous) against the
    reference's compressed_psum over a vmapped named axis of size 2 (the
    same pmax and psum): every rank gets it, bit for bit; and it is
    quantize-with-the-shared-scale -> int sum -> dequantize."""
    g = np.stack([rng.normal(size=(300,)), 3.0 * rng.normal(size=(300,))]).astype(np.float32)
    data = str(tmp_path / "g.npy")
    np.save(data, g)
    out = str(tmp_path / "out")
    procs = [subprocess.Popen([sys.executable, "-c", _PSUM_RANK, str(r), str(tmp_path / "init"),
                               data, out], env=_env(), cwd=ROOT) for r in range(2)]
    assert [p.wait(timeout=120) for p in procs] == [0, 0]
    want = np.asarray(jax.vmap(lambda x: jcomp.compressed_psum(x, ("i",)), axis_name="i")(
        jnp.asarray(g)))
    scale = np.float32(max(np.abs(g[0]).max(), np.abs(g[1]).max())) / np.float32(127)
    q = np.clip(np.round(g / scale), -127, 127).astype(np.int32)
    by_hand = q.sum(0).astype(np.float32) * scale
    for r in range(2):
        got = np.load(out + f".{r}.npy")
        np.testing.assert_array_equal(got, want[r])
        np.testing.assert_array_equal(got, by_hand)


# ------------------------------------------------------------------ launcher and example


def _run(*args: str):
    out = subprocess.run([sys.executable, *args], capture_output=True, text=True, timeout=240,
                         env=_env(), cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return out


def test_launcher_data_parallel_matches_one_rank(tmp_path, capsys):
    """--mesh 2x1 (two gloo ranks, each half of every batch, grads averaged
    by an all-reduce) against --mesh 1x1 (in this process) on the same
    global batches: the same losses to the printed digits and params within
    1e-6 (the mean of two half-batch grads adds in another order than one
    full-batch grad)."""
    runs = {}
    for mesh in ("1x1", "2x1"):
        d = str(tmp_path / mesh)
        argv = ["--cpu", "--steps", "3", "--mesh", mesh, "--log-every", "1", "--ckpt-dir", d]
        if mesh == "1x1":
            assert launch_train.main(argv) == 0
            out = capsys.readouterr().out
        else:
            out = _run("-m", "repro_torch.launch.train", *argv).stdout
        assert f"'data': {mesh[0]}" in out and "done: final loss" in out
        losses = [ln.split()[3] for ln in out.splitlines() if ln.startswith("step")]
        restored, step = ckpt_mod.restore_latest(d, {"params": get_model(CFG).init_params(
            torch.Generator().manual_seed(0), "cpu").stacked, "opt": opt_mod.init(
            get_model(CFG).init_params(torch.Generator().manual_seed(0), "cpu").stacked)}, "cpu")
        assert step == 3
        runs[mesh] = (losses, restored)
    assert runs["1x1"][0] == runs["2x1"][0] and len(runs["1x1"][0]) == 3
    for (_, a), (_, b) in zip(leaves(runs["1x1"][1]), leaves(runs["2x1"][1]), strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)


def test_launcher_grad_compress_runs(capsys):
    assert launch_train.main(["--cpu", "--steps", "2", "--grad-compress",
                              "--arch", "mixtral-8x22b"]) == 0
    assert "done: final loss" in capsys.readouterr().out


def test_example_trains_and_resumes_on_the_cpu(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", [
        "torch_train_lm.py", "--cpu", "--steps", "50", "--preempt", "--d-model", "48",
        "--layers", "2", "--seq", "16", "--batch", "4", "--ckpt-dir", str(tmp_path)])
    runpy.run_path(str(ROOT / "examples" / "torch_train_lm.py"), run_name="__main__")
    out = capsys.readouterr().out
    assert "simulated preemption at step 30" in out and "resumed from step 25" in out
    assert "final loss" in out
