"""The port's sharded training (a mesh policy over DTensors) against the JAX
package's ``make_train_step`` on a 2 x 2 mesh, on the CPU.

  * 3 AdamW steps of qwen2 (at its published grad_accum 2, as the
    single-device five-step test runs it) and of moonshot (FSDP on) at
    REDUCED: four gloo ranks on a ("data", "model") = (2, 2) mesh run
    the port's step under ``launch.mesh.policy_for``; one JAX subprocess
    with 4 host devices runs the reference's jitted step under its own
    2 x 2 policy. Both start from the same carried weights and take the
    same global batches through the seams (``params_from_jax(policy=)``,
    ``common.place``). The losses agree within 1e-5 relative; the params
    within a fixed limit for each arch (``PARAM_ATOL``): qwen2's is the
    single-device step test's 1e-5, moonshot's is set from two readings
    of this test, printed with ``-s``: the port's distance from the
    reference's 2 x 2 params, and the reference's own between one device
    and its 2 x 2 mesh;
  * the MoE layer at G = 2 (the policy's dp size): each data rank
    dispatches its own token group, and every group's ``dest``/``tok``
    equal the reference's ``_dispatch_group`` on that group as integers;
    the layer's output and aux within 8 f32 ulps of their largest
    magnitude (REDUCED's 4-d expert weights take their fan-in from the
    layer count, so the outputs reach ~500) of the reference's under its
    policy;
  * ``python -m repro_torch.launch.train --cpu --mesh 2x2`` runs over 4
    gloo ranks and writes the checkpoint whole: within 1e-5 of the 1x1
    run's (the same model trained without a mesh).
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import registry as jregistry
from repro.train import data as jdata
from repro_torch.launch import train as launch_train
from repro_torch.models.common import leaves
from repro_torch.models.registry import get_model
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import optimizer as opt_mod
from repro_torch import configs as tconfigs

ROOT = Path(__file__).resolve().parents[1]
CASES = (("qwen2-1.5b", False, 2), ("moonshot-v1-16b-a3b", True, 1))
STEPS, BATCH, SEQ = 3, 8, 32
LOSS_RTOL, MOE_ULPS = 1e-5, 8
# params after 3 steps, port against reference, a fixed limit per arch.
# qwen2: the single-device step test's 1e-5 (reads 8.2e-6; the reference
# alone moves 1.18e-6 between one device and its 2 x 2 mesh). moonshot: its
# near-zero grads make AdamW's m / sqrt(v) ill-conditioned; the port reads
# 2.11e-5 from the reference's 2 x 2 params, and the reference alone moves
# 4.65e-5 between one device and its 2 x 2 mesh. 1e-4 leaves room above
# both readings (this sandbox's CPU, torch 2.13; printed with -s).
PARAM_ATOL = {"qwen2-1.5b": 1e-5, "moonshot-v1-16b-a3b": 1e-4}


def _env(**extra) -> dict:
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1", **extra}


def _flat(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {"/".join(prefix): np.asarray(tree)}


def _cfgs(arch: str, fsdp: bool, grad_accum: int):
    kw = dict(fsdp=fsdp, grad_accum=grad_accum)
    return (jconfigs.get_config(arch, reduced=True).replace(**kw),
            tconfigs.get_config(arch, reduced=True).replace(**kw))


_TREE = """
def unflat(z):
    out = {}
    for key in z.files:
        node, parts = out, key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = z[key]
    return out
"""

_RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, init, data = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank, world_size=4)
    from repro_torch import configs
    from repro_torch.launch.mesh import make_debug_mesh, policy_for
    from repro_torch.launch.train import full_tree
    from repro_torch.models import moe
    from repro_torch.models.common import leaves, place, use_policy
    from repro_torch.models.interop import params_from_jax
    from repro_torch.models.registry import get_model
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.step import make_train_step
    from torch.distributed.tensor.experimental import implicit_replication
    """) + _TREE + textwrap.dedent("""
    policy = policy_for(make_debug_mesh((2, 2)))
    out = {}
    for arch, fsdp, accum in (("qwen2-1.5b", False, 2), ("moonshot-v1-16b-a3b", True, 1)):
        cfg = configs.get_config(arch, reduced=True).replace(fsdp=fsdp, grad_accum=accum)
        lm = params_from_jax(cfg, unflat(np.load(f"{data}/{arch}_params.npz")), "cpu", policy)
        if arch.startswith("moonshot"):  # the first MoE layer alone, at G = 2
            mz = np.load(f"{data}/moe.npz")
            seen = []
            orig = moe._dispatch_group
            def spy(*a, **kw):
                r = orig(*a, **kw)
                seen.append((r[1].numpy(), r[2].numpy()))
                return r
            moe._dispatch_group = spy
            with use_policy(policy), implicit_replication(), torch.no_grad():
                x = place(torch.from_numpy(mz["x"]), policy, ("dp", None, None))
                y, aux = moe.moe_apply(lm.layers[0].mlp, x, cfg)
                y, aux = y.full_tensor(), aux.full_tensor()
            moe._dispatch_group = orig
            out["moe/out"], out["moe/aux"] = y.numpy(), aux.numpy()
            out["moe/dest"], out["moe/tok"] = seen[0]
        batches = np.load(f"{data}/{arch}_batches.npz")["tokens"]
        opt = opt_mod.init_placed(get_model(cfg)._placed_recs(), policy)
        opt_cfg = opt_mod.AdamWConfig(total_steps=3, warmup_steps=1)
        fn = make_train_step(cfg, opt_cfg, policy)
        for step in range(len(batches)):
            tok = place(torch.from_numpy(batches[step]), policy, ("dp", None))
            lm, opt, m = fn(lm, opt, {"tokens": tok})
            out[f"{arch}/loss{step}"] = float(m["loss"])
        for path, t in leaves(full_tree(lm.stacked)):
            out[f"{arch}/p/" + "/".join(path)] = t.numpy()
    np.savez(f"{data}/rank{rank}.npz", **out)
    dist.destroy_process_group()
""")

_JAX = textwrap.dedent("""
    import sys
    import numpy as np
    import jax
    import jax.numpy as jnp
    from repro import configs
    from repro.launch.mesh import make_debug_mesh, policy_for
    from repro.models import moe as jmoe
    from repro.models.common import use_policy
    from repro.models.registry import get_model
    from repro.train import optimizer as jopt
    from repro.train import step as jstep
    data = sys.argv[1]
    """) + _TREE + textwrap.dedent("""
    mesh = make_debug_mesh((2, 2))
    policy = policy_for(mesh)
    out = {}
    for arch, fsdp, accum in (("qwen2-1.5b", False, 2), ("moonshot-v1-16b-a3b", True, 1)):
        cfg = configs.get_config(arch, reduced=True).replace(fsdp=fsdp, grad_accum=accum)
        model = get_model(cfg)
        params = jax.tree_util.tree_map(jnp.asarray,
                                        unflat(np.load(f"{data}/{arch}_params.npz")))
        params = jax.device_put(params, model.param_shardings(policy))
        st = jopt.init(params)
        fn = jax.jit(jstep.make_train_step(cfg, jopt.AdamWConfig(total_steps=3, warmup_steps=1),
                                           policy))
        batches = np.load(f"{data}/{arch}_batches.npz")["tokens"]
        with mesh:
            for step in range(len(batches)):
                b = {"tokens": jax.device_put(jnp.asarray(batches[step]),
                                              policy.sharding_for(batches[step].shape,
                                                                  ("dp", None)))}
                params, st, m = fn(params, st, b)
                out[f"{arch}/loss{step}"] = float(m["loss"])
        flat = jax.tree_util.tree_flatten_with_path(params)[0]
        for path, v in flat:
            out[f"{arch}/p/" + "/".join(k.key for k in path)] = np.asarray(v)
        # the reference's own spread: the same steps on one device
        params = jax.tree_util.tree_map(jnp.asarray,
                                        unflat(np.load(f"{data}/{arch}_params.npz")))
        st = jopt.init(params)
        fn1 = jax.jit(jstep.make_train_step(cfg, jopt.AdamWConfig(total_steps=3,
                                                                  warmup_steps=1)))
        for step in range(len(batches)):
            params, st, _ = fn1(params, st, {"tokens": jnp.asarray(batches[step])})
        for path, v in jax.tree_util.tree_flatten_with_path(params)[0]:
            out[f"{arch}/p1/" + "/".join(k.key for k in path)] = np.asarray(v)
        if arch.startswith("moonshot"):
            mz = np.load(f"{data}/moe.npz")
            p = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]),
                                       unflat(np.load(f"{data}/{arch}_params.npz"))["layers"]["mlp"])
            x = jnp.asarray(mz["x"])
            def run(p, x):
                with use_policy(policy):
                    return jmoe.moe_apply(p, x, cfg)
            with mesh:
                y, aux = jax.jit(run)(p, x)
            out["moe/out"], out["moe/aux"] = np.asarray(y), np.asarray(aux)
            # the reference's grouping at G = 2, group by group
            b, s, d = x.shape
            e, k, g = cfg.moe.n_experts, cfg.moe.top_k, 2
            t = b * s // g
            xg = x.reshape(g, t, d)
            probs = jax.nn.softmax(xg.astype(jnp.float32) @ p["router"].astype(jnp.float32), -1)
            gate, eids = jax.lax.top_k(probs, k)
            cap = min(max(int(t * k / e * cfg.moe.capacity_factor) + 1, 8), t)
            _, dest, tok = jax.vmap(lambda xf, gt, ei: jmoe._dispatch_group(
                xf, gt, ei, e, k, cap))(xg, gate, eids)
            out["moe/dest"], out["moe/tok"] = np.asarray(dest), np.asarray(tok)
    np.savez(f"{data}/jax.npz", **out)
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides' results from the same carried weights and batches: the
    four gloo ranks and the JAX subprocess run at once."""
    data = tmp_path_factory.mktemp("sharded")
    for arch, fsdp, accum in CASES:
        jcfg, _ = _cfgs(arch, fsdp, accum)
        params = jax.jit(jregistry.get_model(jcfg).init_params)(jax.random.PRNGKey(7))
        np.savez(data / f"{arch}_params.npz", **_flat(jax.tree_util.tree_map(np.asarray, params)))
        dcfg = jdata.DataConfig(vocab=jcfg.vocab, batch=BATCH, seq=SEQ, seed=3)
        toks = np.stack([np.asarray(jdata.lm_batch(dcfg, s)["tokens"]) for s in range(STEPS)])
        np.savez(data / f"{arch}_batches.npz", tokens=toks)
    x = np.random.default_rng(11).standard_normal((4, 8, 64)).astype(np.float32)
    np.savez(data / "moe.npz", x=x)
    init = data / "init"
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), str(init), str(data)],
                              env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(4)]
    jproc = subprocess.Popen(
        [sys.executable, "-c", _JAX, str(data)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu"))
    try:
        for p in [*procs, jproc]:
            _, err = p.communicate(timeout=400)
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in [*procs, jproc]:
            if p.poll() is None:
                p.kill()
    return [np.load(data / f"rank{r}.npz") for r in range(4)], np.load(data / "jax.npz")


@pytest.mark.parametrize("arch", [c[0] for c in CASES])
def test_sharded_steps_match_the_reference_2x2(runs, arch):
    ranks, want = runs
    for step in range(STEPS):
        key = f"{arch}/loss{step}"
        for r in ranks:
            np.testing.assert_allclose(r[key], want[key], rtol=LOSS_RTOL)
    keys = [k for k in want.files if k.startswith(f"{arch}/p/")]
    assert keys and set(keys) == {k for k in ranks[0].files if k.startswith(f"{arch}/p/")}
    port = max(float(np.abs(r[k] - want[k]).max()) for k in keys for r in ranks)
    spread = max(float(np.abs(want[k] - want[k.replace("/p/", "/p1/")]).max()) for k in keys)
    print(f"{arch}: params, port vs reference 2x2 max abs {port:.3g}; reference 1 device vs "
          f"2x2 {spread:.3g}; limit {PARAM_ATOL[arch]}")
    for key in keys:
        for r in ranks:  # every rank gathers the same whole tree
            np.testing.assert_allclose(r[key], want[key], atol=PARAM_ATOL[arch], rtol=0,
                                       err_msg=key)


def test_moe_groups_dispatch_as_the_reference_at_g2(runs):
    """Rank r of the (2, 2) mesh holds group r // 2 (its data coordinate)."""
    ranks, want = runs
    for r, got in enumerate(ranks):
        g = r // 2
        np.testing.assert_array_equal(got["moe/dest"], want["moe/dest"][g])
        np.testing.assert_array_equal(got["moe/tok"], want["moe/tok"][g])
        for key in ("moe/out", "moe/aux"):
            tol = MOE_ULPS * np.spacing(np.float32(np.abs(want[key]).max()))
            np.testing.assert_allclose(got[key], want[key], atol=tol, rtol=0, err_msg=key)


def test_launcher_2x2_matches_one_device(tmp_path):
    """--mesh 2x2 (4 gloo ranks, the policy path) against --mesh 1x1 (one
    process, no mesh) on the same weights and batches: the same losses to
    the printed digits, and the whole checkpoint within 1e-5."""
    cfg = tconfigs.get_config("qwen2-1.5b", reduced=True)
    runs = {}
    for mesh in ("1x1", "2x2"):
        d = str(tmp_path / mesh)
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--cpu", "--steps", "3",
             "--mesh", mesh, "--log-every", "1", "--ckpt-dir", d],
            capture_output=True, text=True, timeout=400, env=_env(), cwd=ROOT)
        assert out.returncode == 0, out.stderr[-4000:]
        assert "done: final loss" in out.stdout
        if mesh == "2x2":
            assert "{'data': 2, 'model': 2}" in out.stdout
        losses = [ln.split()[3] for ln in out.stdout.splitlines() if ln.startswith("step")]
        like = get_model(cfg).init_params(torch.Generator().manual_seed(0), "cpu").stacked
        restored, step = ckpt_mod.restore_latest(
            d, {"params": like, "opt": opt_mod.init(like)}, "cpu")
        assert step == 3
        runs[mesh] = (losses, restored)
    assert runs["1x1"][0] == runs["2x2"][0] and len(runs["1x1"][0]) == 3
    for (_, a), (_, b) in zip(leaves(runs["1x1"][1]), leaves(runs["2x2"][1]), strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=PARAM_ATOL["qwen2-1.5b"], rtol=0)


def test_launcher_takes_a_pod_axis_in_process(capsys):
    """A (pod, data, model) mesh in this process. ``--mesh 1x1x1`` shards
    nothing, so ``main`` trains whole replicas; ``run_rank`` with
    ``placed`` takes the policy path there on a group of one gloo rank,
    and the group is torn down after each."""
    assert launch_train.main(["--cpu", "--steps", "2", "--mesh", "1x1x1", "--log-every", "1"]) == 0
    out = capsys.readouterr().out
    assert "{'data': 1, 'model': 1}" in out and "done: final loss" in out
    args = launch_train.parse_args(["--cpu", "--steps", "2", "--mesh", "1x1x1", "--log-every", "1"])
    assert launch_train.run_rank(args, 0, (1, 1, 1), placed=True) == 0
    out = capsys.readouterr().out
    assert "{'pod': 1, 'data': 1, 'model': 1}" in out and "done: final loss" in out
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("arch,shape,placed", [
    ("qwen2-1.5b", (1, 1), False), ("qwen2-1.5b", (4, 1), False),
    ("qwen2-1.5b", (2, 2, 1), False), ("qwen2-1.5b", (2, 2), True),
    ("qwen2-1.5b", (1, 1, 2), True), ("moonshot-v1-16b-a3b", (1, 1), False),
    ("moonshot-v1-16b-a3b", (4, 1), True), ("moonshot-v1-16b-a3b", (2, 1, 1), True),
])
def test_launcher_takes_the_policy_only_where_the_mesh_shards(arch, shape, placed):
    """A model axis, or FSDP (moonshot's published config) over more than
    one data rank, takes the mesh policy; whole replicas take the
    data-parallel step."""
    assert launch_train.uses_policy(tconfigs.get_config(arch), shape) is placed
