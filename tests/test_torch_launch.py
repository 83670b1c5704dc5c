"""The port's placements and dry-run (``models/common.py``'s mesh policy,
``train/optimizer.py``'s ZeRO-1 recs, ``launch/{mesh,specs,op_costs,
dryrun}.py``) against the JAX package's, on the CPU, and the two
clustering examples.

  * ``zero_rec``, ``opt_state_recs`` and ``fsdp_recs`` equal the
    reference's as Rec trees for all ten configs, and pass the reference's
    own cases of them (``tests/test_train.py``);
  * at meshes (2, 2), (16, 16) and (2, 16, 16) every leaf of
    ``cell_inputs`` for every ``cells_for(arch)`` of the ten archs has the
    reference's local shard shape (``sharding.shard_shape``): the reference
    in one subprocess with 512 host devices (``eval_shape`` only, nothing
    compiles), the port on a ``"fake"`` process group of the mesh's size;
  * ``op_costs``: one product's flops and bytes, flops linear in the layer
    count, per-device (local) counts under a (16, 16) mesh, an all-gather's
    bytes by kind, no collectives at world size 1;
  * ``dryrun.run_cell`` (train, prefill, decode) and ``run_cluster_cell``
    (every cluster cell) at a (2, 2) fake mesh: the reference's report
    keys, with its deliberate differences (``trace_s`` for ``compile_s``,
    no raw XLA costs, ``fits_80gb`` for ``fits_16gb``), and
    ``useful_flops_ratio`` in (0, 1];
  * a CPU run of ``examples/torch_quickstart.py`` and
    ``examples/torch_cluster_20ng.py``, each over 2 gloo ranks.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro import configs as jconfigs
from repro.models import registry as jregistry
from repro.models.common import MeshPolicy as JMeshPolicy
from repro.models.common import fsdp_recs as jfsdp_recs
from repro.train import optimizer as jopt
from repro_torch import configs as tconfigs
from repro_torch.configs.base import SHAPES, ShapeCell
from repro_torch.launch import dryrun, op_costs
from repro_torch.launch.mesh import policy_for
from repro_torch.launch.specs import cell_inputs
from repro_torch.models import common as tcommon
from repro_torch.models import registry as tregistry
from repro_torch.train import optimizer as topt

ROOT = Path(__file__).resolve().parents[1]
ARCHS = tconfigs.list_archs()
MESHES = ((2, 2), (16, 16), (2, 16, 16))


def _env(**extra) -> dict:
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1", **extra}


def _recs(tree, prefix=()) -> dict:
    """path -> (shape, sym, init, scale) of a Rec tree of either package."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_recs(v, prefix + (k,)))
        return out
    return {prefix: (tuple(tree.shape), tuple(tree.sym), tree.init, tree.scale)}


class _Sizes:
    """Axis sizes of a mesh, as either package's policy reads them."""

    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))  # the reference reads mesh.shape[name]
        self.mesh_dim_names = tuple(names)
        self.ndim = len(shape)

    def size(self, i):  # the port reads mesh.size(dim)
        return self.shape[self.mesh_dim_names[i]]


# ------------------------------------------------------------------ (a) recs


@pytest.mark.parametrize("arch", ARCHS)
def test_zero_and_fsdp_recs_equal_the_reference(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jrecs = jregistry.get_model(jcfg).recs
    trecs = tregistry.get_model(tcfg).recs
    assert _recs(tcommon.fsdp_recs(trecs)) == _recs(jfsdp_recs(jrecs))
    for shape in ((16, 16), (2, 16, 16)):
        names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
        dp = names[:-1]
        jpol = JMeshPolicy(mesh=_Sizes(shape, names), dp=dp)
        tpol = tcommon.MeshPolicy(mesh=_Sizes(shape, names), dp=dp)
        for recs_j, recs_t in ((jrecs, trecs), (jfsdp_recs(jrecs), tcommon.fsdp_recs(trecs))):
            want = jopt.opt_state_recs(recs_j, jpol)
            got = topt.opt_state_recs(recs_t, tpol)
            assert _recs(got) == _recs(want)
        assert _recs(tregistry.get_model(tcfg)._placed_recs()) == _recs(
            jregistry.get_model(jcfg)._placed_recs())


def test_zero_opt_state_shards_first_divisible_dim():
    """``tests/test_train.py``'s case on the port, on a real (1, 1) mesh."""
    with dryrun.fake_pod((1, 1)) as mesh:
        policy = policy_for(mesh)
        zr = topt.zero_rec(tcommon.Rec((8, 16), (None, "tp")), policy)
        assert zr.sym[0] == "dp"  # first replicated dim got the dp shard
        zr2 = topt.zero_rec(tcommon.Rec((3, 16), ("tp", None)), policy)
        assert zr2.sym[0] == "tp" and zr2.sym[1] == "dp"  # dim0 taken; dim1 gets dp


def test_fsdp_recs_shard_choice():
    """``tests/test_train.py``'s case on the port."""
    Rec = tcommon.Rec
    out = tcommon.fsdp_recs({
        "stacked": Rec((56, 16, 6144, 512), (None, "tp", None, None)),
        "mat": Rec((1536, 8960), (None, "tp")),
        "embed": Rec((151936, 1536), ("tp", None), "embed"),
        "scale": Rec((1536,), ()),
    })
    assert out["stacked"].sym == (None, "tp", "dp", None)  # largest repl dim
    assert out["mat"].sym == ("dp", "tp")
    assert out["embed"].sym == ("tp", None)  # tables excluded
    assert out["scale"].sym == ()  # 1-D excluded


# ------------------------------------------------------------------ (b) shard shapes

_JAX_SHAPES = textwrap.dedent("""
    import json, sys
    import jax
    from repro.configs import SHAPES, cells_for, get_config, list_archs
    from repro.launch.mesh import make_debug_mesh, policy_for
    from repro.launch.specs import cell_inputs

    def key(path):
        return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)

    out = {}
    for shape in [(2, 2), (16, 16), (2, 16, 16)]:
        axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
        policy = policy_for(make_debug_mesh(shape, axes))
        for arch in list_archs():
            cfg = get_config(arch)
            for cell in cells_for(arch):
                tree = cell_inputs(cfg, SHAPES[cell], policy)
                for path, sds in jax.tree_util.tree_flatten_with_path(tree)[0]:
                    out["x".join(map(str, shape)) + "|" + arch + "|" + cell + "|" + key(path)] = \\
                        list(sds.sharding.shard_shape(sds.shape))
    json.dump(out, sys.stdout)
""")


def _flat_shapes(tree, prefix=()) -> dict:
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_shapes(tree[k], prefix + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat_shapes(v, prefix + (str(i),)))
        return out
    if isinstance(tree, DTensor):
        return {"/".join(prefix): list(tree.to_local().shape)}
    if isinstance(tree, torch.Tensor):
        return {"/".join(prefix): list(tree.shape)}
    return {"/".join(prefix): []}  # decode's pos: a Python int, the reference's () scalar


@pytest.fixture(scope="module")
def reference_shard_shapes():
    out = subprocess.run(
        [sys.executable, "-c", _JAX_SHAPES], capture_output=True, text=True, timeout=600,
        cwd=ROOT, env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=512",
                           JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_cell_inputs_shard_like_the_reference(reference_shard_shapes, shape):
    tag = "x".join(map(str, shape))
    want = {k: v for k, v in reference_shard_shapes.items() if k.startswith(tag + "|")}
    got = {}
    with dryrun.fake_pod(shape) as mesh:
        policy = policy_for(mesh)
        for arch in ARCHS:
            cfg = tconfigs.get_config(arch)
            for cell in tconfigs.cells_for(arch):
                leaves = _flat_shapes(cell_inputs(cfg, SHAPES[cell], policy))
                got.update({f"{tag}|{arch}|{cell}|{k}": v for k, v in leaves.items()})
    assert want and got.keys() == want.keys()
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, list(bad.items())[:10]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_resolve_and_sharding_for_match_the_reference(shape):
    """The policy's spec for every sym entry and its demotion rule, on
    either package's axis sizes."""
    names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    jpol = JMeshPolicy(mesh=_Sizes(shape, names), dp=names[:-1])
    tpol = tcommon.MeshPolicy(mesh=_Sizes(shape, names), dp=names[:-1])
    syms = [(None, "tp"), ("dp", None), ("tp", None), (("dp", "tp"), None), ("dp", None, "tp", None)]
    for entry in ("dp", "tp", ("dp", "tp")):
        assert tpol.axes_size(entry) == jpol.axes_size(entry)
    for sym in syms:
        assert tpol.resolve(sym) == tuple(jpol.resolve(sym))
        for n in (1, 2, 16, 32, 48, 512, 51865):
            shp = (n,) * len(sym)
            assert tpol.resolve(tpol.fixed_sym(shp, sym)) == tuple(_ref_fixed_spec(jpol, shp, sym))


def _ref_fixed_spec(jpol, shape, sym):
    """The reference's ``sharding_for`` rule on its own ``axes_size``,
    resolved (its NamedSharding needs devices; the rule does not)."""
    sym = tuple(sym[: len(shape)])
    fixed = [None if e is None or shape[d] % jpol.axes_size(e) else e for d, e in enumerate(sym)]
    return jpol.resolve(tuple(fixed) + (None,) * (len(shape) - len(fixed)))


# ------------------------------------------------------------------ (c) op costs


def test_op_costs_one_product():
    a, b = torch.randn(64, 32), torch.randn(32, 16)
    out, c = op_costs.op_costs(torch.mm, a, b)
    assert c["flops"] == 2 * 64 * 32 * 16
    assert c["bytes"] == (64 * 32 + 32 * 16 + 64 * 16) * 4
    assert c["collectives"]["total"] == 0 and c["collectives"]["n_ops"] == 0
    assert set(op_costs.COLLECTIVE_KINDS) <= set(c["collectives"])


def test_op_costs_flops_are_linear_in_the_layer_count():
    from repro_torch.models import transformer
    from repro_torch.models.registry import make_batch

    base = tconfigs.get_config("qwen2-1.5b", reduced=True)
    flops = []
    for n in (2, 3, 4):
        cfg = base.replace(n_layers=n)
        lm = tregistry.get_model(cfg).init_params(torch.Generator().manual_seed(0), "cpu")
        b = make_batch(cfg, 2, 16, torch.Generator().manual_seed(1), "cpu")
        with torch.no_grad():
            flops.append(op_costs.op_costs(transformer.loss_fn, lm, cfg, b)[1]["flops"])
    assert flops[1] - flops[0] == flops[2] - flops[1] > 0


def test_op_costs_are_per_device_under_a_16x16_mesh():
    from torch.distributed.tensor import DTensor, Replicate, Shard

    with dryrun.fake_pod((16, 16)) as mesh:
        x = DTensor.from_local(torch.empty(256, 1536), mesh, [Shard(0), Replicate()],
                               run_check=False, shape=torch.Size((4096, 1536)), stride=(1536, 1))
        w = DTensor.from_local(torch.empty(1536, 560), mesh, [Replicate(), Shard(1)],
                               run_check=False, shape=torch.Size((1536, 8960)), stride=(8960, 1))
        y, c = op_costs.op_costs(torch.mm, x, w)
        assert tuple(y.to_local().shape) == (256, 560)
        assert c["flops"] == 2 * 256 * 560 * 1536  # the local product, not 2*4096*8960*1536
        assert c["collectives"]["total"] == 0
        # an all-gather over the model axis: the gathered (1536, 8960) f32 result
        _, c = op_costs.op_costs(lambda t: t.redistribute(mesh, [Replicate(), Replicate()]), w)
        assert c["collectives"]["all-gather"] == 1536 * 8960 * 4
        assert c["collectives"]["total"] == 1536 * 8960 * 4 and c["collectives"]["n_ops"] == 1


def test_op_costs_count_no_global_tensor_of_a_vocab_sharded_ce_chunk():
    """The CE of one chunk on vocab-sharded logits at a (2, 2) fake mesh:
    no counted op writes a tensor of the logits' global (B, C, V) shape
    (DTensor builds those to learn each op's output shape; they are not
    the step's work), but the local (B/2, C, V/2) logits are counted."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import policy_for
    from repro_torch.models import layers
    from repro_torch.models.common import use_policy

    cfg = tconfigs.get_config("qwen2-1.5b", reduced=True)
    b, c, v, d = 4, 8, 1024, cfg.d_model
    with dryrun.fake_pod((2, 2)) as mesh:
        h = DTensor.from_local(torch.empty(b // 2, c, d), mesh, [Shard(0), Replicate()],
                               run_check=False, shape=torch.Size((b, c, d)), stride=(c * d, d, 1))
        table = DTensor.from_local(torch.empty(v // 2, d), mesh, [Replicate(), Shard(0)],
                                   run_check=False, shape=torch.Size((v, d)), stride=(d, 1))
        labels = DTensor.from_local(torch.empty(b // 2, c, dtype=torch.int64), mesh,
                                    [Shard(0), Replicate()], run_check=False,
                                    shape=torch.Size((b, c)), stride=(c, 1))
        with use_policy(policy_for(mesh)), op_costs.OpCounter() as counter, torch.no_grad():
            layers._ce_sum({"table": table}, h, labels, cfg.replace(tie_embeddings=True))
    assert counter.largest == (b // 2) * c * (v // 2) * 4, counter.largest
    assert counter.flops >= 2 * (b // 2) * c * (v // 2) * d


def test_no_collectives_at_world_size_1():
    cfg = tconfigs.get_config("qwen2-1.5b", reduced=True)
    r = dryrun.run_cell("qwen2-1.5b", "train_4k", mesh_shape=(1, 1), cfg=cfg,
                        cell=ShapeCell("train_4k", "train", 32, 4), dtype=torch.float32)
    assert r["collectives"]["total"] == 0 and r["collectives"]["n_ops"] == 0
    assert r["cost"]["flops_per_device"] > 0 and r["n_devices"] == 1


# ------------------------------------------------------------------ (d) reports

# the reference's report (src/repro/launch/dryrun.py, _finish_report), with
# its deliberate differences applied
_KEYS = {"arch", "shape", "kind", "mesh", "n_devices", "ok", "lower_s", "trace_s", "memory",
         "cost", "collectives", "model_flops", "roofline"}
_MEMORY = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes", "hbm_per_device",
           "fits_80gb"}
_COST = {"flops_per_device", "bytes_per_device"}
_ROOFLINE = {"compute_s", "memory_s", "collective_s", "dominant", "useful_flops_ratio"}


def _check_report(r: dict) -> None:
    assert set(r) == _KEYS and r["ok"] is True and r["n_devices"] == 4
    assert set(r["memory"]) == _MEMORY and set(r["cost"]) == _COST
    assert set(r["roofline"]) == _ROOFLINE
    assert {*op_costs.COLLECTIVE_KINDS, "total", "n_ops"} == set(r["collectives"])
    assert 0.0 < r["roofline"]["useful_flops_ratio"] <= 1.0, r["roofline"]
    assert r["memory"]["hbm_per_device"] > 0 and "model_flops" in r["model_flops"]


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_run_cell_reports_like_the_reference(shape, tmp_path):
    cfg = tconfigs.get_config("qwen2-1.5b", reduced=True)
    cell = ShapeCell(shape, SHAPES[shape].kind, 64, 8)
    r = dryrun.run_cell("qwen2-1.5b", shape, mesh_shape=(2, 2), cfg=cfg, cell=cell,
                        out_dir=str(tmp_path))
    _check_report(r)
    assert r["mesh"] == "mesh_2x2" and r["kind"] == SHAPES[shape].kind
    assert json.loads((tmp_path / f"qwen2-1.5b__{shape}__mesh_2x2.json").read_text()) == r
    if shape == "train_4k":  # the batch is dp-sharded and the weights tp-sharded
        assert r["collectives"]["total"] > 0


@pytest.mark.parametrize("shape", dryrun.CLUSTER_SHAPES)
def test_run_cluster_cell_reports_like_the_reference(shape):
    r = dryrun.run_cluster_cell(shape, mesh_shape=(2, 2), n=4096, s=1024)
    _check_report(r)
    assert r["arch"] == "cluster-tfidf" and r["kind"] == "cluster"


# ------------------------------------------------------------------ (g) examples


@pytest.mark.parametrize("script,args,want", [
    ("torch_quickstart.py", ["--n", "1000", "--chunk", "250"], "distributed streaming Buckshot"),
    ("torch_cluster_20ng.py", ["--n", "2000", "--k", "10", "--big-k", "40"], "Buckshot"),
])
def test_example_runs_on_the_cpu_over_two_ranks(script, args, want):
    out = subprocess.run([sys.executable, str(ROOT / "examples" / script), "--cpu",
                          "--ranks", "2", *args], capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env=_env())
    assert out.returncode == 0, out.stderr[-4000:]
    assert want in out.stdout and "purity=" in out.stdout and "nmi=" in out.stdout
    assert "K-Means" in out.stdout and "BKC" in out.stdout
