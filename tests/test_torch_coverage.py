"""The port does what the JAX package does: a record of it, checked.

Both packages are parsed with ``ast`` (neither is imported). Every top-level
``def`` or ``class`` of ``src/repro/**.py`` must have a counterpart of the
same name in the same module of ``src/repro_torch/`` (a ``def``, a
``class``, an assignment or an import there), or an entry in ``NOT_PORTED``
below, which gives the reason and, where there is one, what the port does in
its place. The allowlist must not go stale: each entry names a reference
function that still exists, that the port still lacks, and, where it names
a counterpart, a file (and name) of the port that exists.

The same holds one level down, for parameters: every parameter of a public
reference function or method that has a counterpart must be a parameter of
the counterpart, or have an entry in ``PARAMS_NOT_PORTED``, which gives the
reason and, where there is one, the counterpart's parameter that takes its
place. That allowlist must not go stale either.
"""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
REF, PORT = SRC / "repro", SRC / "repro_torch"

_XLA = "XLA API drift shim; the port calls torch.distributed and DeviceMesh directly"
_WARM = "the AOT pre-warm of the round shapes; PyTorch runs eagerly and compiles nothing"
_IMPL = "the Pallas/XLA impl switch and its degradation; the port dispatches by device only"
_SPEC = "a jax.sharding spec; the port shards rows by the rank's mesh coordinates"
_HLO = "parses XLA's HLO text; the port's dry-run counts operations instead"

# "module:name" -> (reason, the port's counterpart or None)
NOT_PORTED: dict[str, tuple[str, str | None]] = {
    "compat.py:cost_analysis": (_XLA, None),
    "compat.py:make_mesh": (_XLA, "distrib/sharding.py:make_flat_mesh"),
    "compat.py:shard_map": (_XLA, "distrib/engine.py:make_job"),
    "core/hac.py:_expand_round_edges_n": (
        "the jit-static body of _expand_round_edges", "core/hac.py:_expand_round_edges"),
    "core/kmeans.py:_split_empty_centers": (
        "a wrapper taking [0] of _split_empty_centers_info",
        "core/kmeans.py:_split_empty_centers_info"),
    "distrib/hac_parallel.py:_WarmSlot": (_WARM, None),
    "distrib/hac_parallel.py:_auto_prewarm": (_WARM, None),
    "distrib/hac_parallel.py:_cancel_pending": (_WARM, None),
    "distrib/hac_parallel.py:_compile_candidate_round": (_WARM, None),
    "distrib/hac_parallel.py:_compile_timeout": (_WARM, None),
    "distrib/hac_parallel.py:_drain_warm_workers": (_WARM, None),
    "distrib/hac_parallel.py:_evict_warm_locked": (_WARM, None),
    "distrib/hac_parallel.py:_place_round_args": (_WARM, None),
    "distrib/hac_parallel.py:_round_structs": (_WARM, None),
    "distrib/hac_parallel.py:prewarm_candidate_rounds": (_WARM, None),
    "distrib/hac_parallel.py:clear_job_caches": (
        "drops the cached jitted jobs and AOT executables; the port builds its jobs per call "
        "and caches none", None),
    "distrib/sharding.py:data_spec": (_SPEC, "distrib/sharding.py:shard_rows"),
    "distrib/sharding.py:replicated": (_SPEC, None),
    "distrib/sharding.py:make_mesh": (_XLA, "distrib/sharding.py:make_pod_mesh"),
    "kernels/assign_argmax.py:_kernel": ("the Pallas kernel body", "kernels/csrc/assign_argmax.cu"),
    "kernels/assign_argmax.py:_pad_to": ("pads to Pallas block multiples; the CUDA kernel takes "
                                         "any shape", None),
    "kernels/assign_argmax.py:assign_argmax_pallas": (
        "the Pallas entry point", "kernels/csrc/assign_argmax.cu"),
    "kernels/assign_stats.py:_kernel": ("the Pallas kernel body", "kernels/csrc/assign_stats.cu"),
    "kernels/assign_stats.py:_bounded_kernel": (
        "the Pallas kernel body", "kernels/csrc/assign_stats_bounded.cu"),
    "kernels/assign_stats.py:_label_stats_kernel": (
        "the Pallas kernel body", "kernels/csrc/label_stats.cu"),
    "kernels/assign_stats.py:assign_stats_pallas": (
        "the Pallas entry point", "kernels/csrc/assign_stats.cu"),
    "kernels/assign_stats.py:assign_stats_bounded_pallas": (
        "the Pallas entry point", "kernels/csrc/assign_stats_bounded.cu"),
    "kernels/assign_stats.py:label_stats_pallas": (
        "the Pallas entry point", "kernels/csrc/label_stats.cu"),
    "kernels/best_edge.py:_kernel": ("the Pallas kernel body", "kernels/csrc/best_edge.cu"),
    "kernels/best_edge.py:_pad_to": ("pads to Pallas block multiples; the CUDA kernel takes "
                                     "any shape", None),
    "kernels/best_edge.py:best_edge_pallas": ("the Pallas entry point",
                                              "kernels/csrc/best_edge.cu"),
    "kernels/component_reduce.py:_kernel": ("the Pallas kernel body",
                                            "kernels/csrc/component_reduce.cu"),
    "kernels/component_reduce.py:component_best_edge_pallas": (
        "the Pallas entry point", "kernels/csrc/component_reduce.cu"),
    "kernels/flash_decode.py:_kernel": ("the Pallas kernel body", "kernels/csrc/flash_decode.cu"),
    "kernels/flash_decode.py:_pad_to": ("pads to Pallas block multiples; the CUDA kernel takes "
                                        "any shape", None),
    "kernels/flash_decode.py:flash_decode_pallas": ("the Pallas entry point",
                                                    "kernels/csrc/flash_decode.cu"),
    "kernels/sim_best_edge.py:_kernel": ("the Pallas kernel body",
                                         "kernels/csrc/sim_best_edge.cu"),
    "kernels/sim_best_edge.py:sim_best_edge_pallas": ("the Pallas entry point",
                                                      "kernels/csrc/sim_best_edge.cu"),
    "kernels/ops.py:_auto_impl": (_IMPL, "kernels/ops.py:_on_card"),
    "kernels/ops.py:_pallas_guard": (_IMPL, None),
    "kernels/ops.py:_reset_pallas_degradation": (_IMPL, None),
    "kernels/ops.py:_resolve": (_IMPL, "kernels/ops.py:_on_card"),
    "kernels/ops.py:pallas_degraded": (_IMPL, None),
    "launch/hlo_costs.py:Cost": (_HLO, "launch/op_costs.py"),
    "launch/hlo_costs.py:_Op": (_HLO, "launch/op_costs.py"),
    "launch/hlo_costs.py:_comp_cost": (_HLO, "launch/op_costs.py"),
    "launch/hlo_costs.py:_dot_flops": (_HLO, "launch/op_costs.py"),
    "launch/hlo_costs.py:_fusion_io_bytes": (_HLO, "launch/op_costs.py"),
    "launch/hlo_costs.py:_parse_computations": (_HLO, "launch/op_costs.py"),
    "launch/hlo_costs.py:_shape_numel_bytes": (_HLO, "launch/op_costs.py"),
    "launch/hlo_costs.py:_split_type_rest": (_HLO, "launch/op_costs.py"),
    "launch/hlo_costs.py:parse_hlo_costs": (_HLO, "launch/op_costs.py"),
    "models/transformer.py:dense_block_apply": (
        "the block as a function of a param dict; the port's block is an nn.Module",
        "models/transformer.py:Block"),
    "models/transformer.py:_attn_decode": ("one decode step of a block",
                                           "models/transformer.py:Block"),
    "models/transformer.py:_layer_params": ("slices layer i of the stacked params",
                                            "models/transformer.py:_layer"),
    "models/transformer.py:_layer_windows_arr": (
        "the windows as a scanned array; the port's layer loop reads cfg.layer_windows()",
        "models/transformer.py:forward"),
    "models/transformer.py:_scan_layers": ("jax.lax.scan over the stacked layers; the port "
                                           "loops over its blocks", "models/transformer.py:forward"),
    "resilience/checkpoint.py:_is_jax_array": ("tells device leaves apart; the port tests for "
                                               "torch.Tensor", "resilience/checkpoint.py:carry_to_host"),
    "serve/cluster_service.py:_assign_graph": ("the jitted assign graph over a slab",
                                               "serve/cluster_service.py:_assign_slab"),
    "text/stream.py:_finite_reducer": ("a jitted all-isfinite per leaf shape",
                                       "text/stream.py:_carry_finite"),
    "text/stream.py:jnp_issubdtype_inexact": ("a dtype test; the port asks the tensor",
                                              "text/stream.py:_carry_finite"),
    "train/checkpoint.py:_flatten_with_paths": ("jax.tree_util.tree_flatten",
                                                "models/common.py:leaves"),
}

_KEY = "a jax.random key; torch cannot reproduce its streams, so the port takes draws or a seed"
_BLOCK = "a Pallas block size; no tile size is a user mode (the CUDA kernels pick their tiles)"
_PARAM_IMPL = "the Pallas/XLA impl switch; the port dispatches by device only"
_IDS = "the segment ids, named ids"
_UNREAD = "the reference accepts it and never reads it (src/repro/models/attention.py)"


def _each(reason: str, counterpart: str | None, *keys: str) -> dict:
    return {key: (reason, counterpart) for key in keys}


# "module:function:param" -> (reason, the counterpart's parameter or None)
PARAMS_NOT_PORTED: dict[str, tuple[str, str | None]] = {
    "common.py:l2_normalize:axis": ("torch names the reduced dimension dim", "dim"),
    **_each(_IDS, "ids", "common.py:segment_sum:segment_ids",
            "common.py:segment_min:segment_ids", "common.py:bincount:segment_ids"),
    **_each(_PARAM_IMPL, None, *(f"{f}:impl" for f in (
        "core/bkc.py:bkc_fit", "core/bkc.py:bkc", "core/bkc.py:bkc_fit_stream",
        "core/bkc.py:bkc_stream", "core/buckshot.py:phase1_from_sample",
        "core/buckshot.py:buckshot_phase1", "core/buckshot.py:buckshot_fit",
        "core/buckshot.py:buckshot", "core/buckshot.py:buckshot_stream",
        "core/hac.py:boruvka_mst", "core/hac.py:single_link_labels_boruvka",
        "core/kmeans.py:kmeans_step", "core/kmeans.py:kmeans_step_bounded",
        "core/kmeans.py:kmeans_fit", "core/kmeans.py:kmeans", "core/kmeans.py:assign_batch",
        "core/kmeans.py:kmeans_fit_stream", "core/kmeans.py:kmeans_stream",
        "core/microcluster.py:build_microclusters", "distrib/cluster.py:kmeans_distributed",
        "distrib/cluster.py:kmeans_distributed_stream", "distrib/cluster.py:bkc_distributed",
        "distrib/cluster.py:bkc_distributed_stream", "distrib/cluster.py:buckshot_distributed",
        "distrib/cluster.py:buckshot_distributed_stream",
        "distrib/hac_parallel.py:boruvka_mst_distributed",
        "distrib/hac_parallel.py:single_link_labels_distributed",
        "kernels/ops.py:assign_argmax", "kernels/ops.py:assign_stats",
        "kernels/ops.py:assign_stats_chunked", "kernels/ops.py:build_center_index",
        "kernels/ops.py:assign_stats_bounded", "kernels/ops.py:assign_stats_bounded_chunked",
        "kernels/ops.py:label_stats", "kernels/ops.py:best_edge", "kernels/ops.py:sim_best_edge",
        "kernels/ops.py:component_best_edge", "kernels/ops.py:flash_decode"))),
    **_each(_BLOCK, None, "core/hac.py:boruvka_mst:block", "kernels/ops.py:sim_best_edge:block"),
    **_each(_KEY, "generator", *(f"{f}:key" for f in (
        "core/bkc.py:bkc", "core/bkc.py:bkc_stream", "core/buckshot.py:buckshot",
        "core/buckshot.py:buckshot_stream", "core/kmeans.py:init_random_centers",
        "core/kmeans.py:kmeans", "core/kmeans.py:kmeans_stream",
        "core/sampling.py:sample_indices", "core/sampling.py:reservoir_sample_stream",
        "models/common.py:materialize", "models/common.py:materialize_stacked",
        "models/registry.py:Model.init_params", "models/registry.py:make_batch"))),
    **_each(_KEY, "seed", *(f"{f}:key" for f in (
        "distrib/cluster.py:sample_rows_distributed", "distrib/cluster.py:buckshot_distributed",
        "distrib/cluster.py:reservoir_sample_distributed_stream",
        "distrib/cluster.py:buckshot_distributed_stream",
        "serve/cluster_service.py:ClusterService.fit"))),
    **_each("the rank's uniforms are drawn by the caller and passed in; their count is "
            "the rank's row count", "u",
            "core/sampling.py:local_top_s:key", "core/sampling.py:local_top_s:n_local"),
    "distrib/engine.py:ring_sweep:axes_sizes": (
        "the ring's axes are given as process groups, whose sizes they carry", "groups"),
    "distrib/hac_parallel.py:boruvka_mst_distributed:prewarm": (_WARM, None),
    "distrib/sharding.py:make_flat_mesh:n_devices": (
        "the mesh spans the process group's world; its size is the world size", None),
    "resilience/checkpoint.py:carry_from_host:device_put": (
        "a device, where the reference takes a placement function", "device"),
    **_each(_UNREAD, None, "models/attention.py:cache_attention:kv_positions",
            "models/attention.py:cache_attention:q_position",
            "models/attention.py:cache_attention:window"),
}


def _defined(path: Path) -> set[str]:
    """Top-level def and class names of a module."""
    return {n.name for n in ast.parse(path.read_text()).body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))}


def _bound(path: Path) -> set[str]:
    """Every name a module binds at top level: defs, classes, assignments
    and imports (a re-export is a counterpart too)."""
    names = _defined(path)
    for n in ast.parse(path.read_text()).body:
        if isinstance(n, ast.Assign):
            names |= {t.id for t in n.targets if isinstance(t, ast.Name)}
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            names.add(n.target.id)
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in n.names}
    return names


def _modules() -> list[str]:
    return sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def _missing(module: str) -> set[str]:
    port = PORT / module
    return _defined(REF / module) - (_bound(port) if port.exists() else set())


@pytest.mark.parametrize("module", _modules())
def test_every_reference_name_has_a_counterpart_or_a_reason(module):
    unlisted = sorted(n for n in _missing(module) if f"{module}:{n}" not in NOT_PORTED)
    assert not unlisted, (
        f"src/repro/{module} defines {unlisted}, which src/repro_torch/{module} lacks: port "
        "them or add each to NOT_PORTED with its reason")


def test_the_allowlist_names_what_exists():
    for key, (reason, counterpart) in NOT_PORTED.items():
        module, name = key.split(":")
        assert (REF / module).exists() and name in _defined(REF / module), f"{key}: gone"
        assert name in _missing(module), f"{key}: the port has it now; drop the entry"
        assert reason, key
        if counterpart is not None:
            file, _, cname = counterpart.partition(":")
            assert (PORT / file).exists(), f"{key}: no src/repro_torch/{file}"
            if cname:
                assert cname in _bound(PORT / file), f"{key}: no {cname} in {file}"


# the port's modules with no reference module of that name: numpy <-> torch
# seams, the kernels' build, the launcher's ranks, the dry-run's op counter
PORT_ONLY = {"interop.py", "kernels/_build.py", "launch/op_costs.py", "launch/ranks.py",
             "models/interop.py"}


def test_every_port_module_mirrors_a_reference_module_or_is_listed():
    ported = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert sorted(ported - set(_modules())) == sorted(PORT_ONLY)


def _signatures(path: Path) -> dict[str, list[str]]:
    """Parameter names of a module's public top-level defs and of the public
    methods (and ``__init__``/``__call__``) of its public classes, keyed
    ``name`` or ``Class.method``; ``*args``/``**kw`` keep their stars."""

    def names(fn) -> list[str]:
        a = fn.args
        out = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
        out += [f"*{a.vararg.arg}"] if a.vararg else []
        return out + ([f"**{a.kwarg.arg}"] if a.kwarg else [])

    def public(name: str) -> bool:
        return not name.startswith("_") or name in ("__init__", "__call__")

    funcs = (ast.FunctionDef, ast.AsyncFunctionDef)
    out: dict[str, list[str]] = {}
    for n in ast.parse(path.read_text()).body:
        if isinstance(n, funcs) and public(n.name):
            out[n.name] = names(n)
        elif isinstance(n, ast.ClassDef) and not n.name.startswith("_"):
            out.update({f"{n.name}.{m.name}": names(m) for m in n.body
                        if isinstance(m, funcs) and public(m.name)})
    return out


def _missing_params(module: str) -> set[str]:
    """``module:function:param`` of each reference parameter whose function
    has a counterpart that lacks it (a counterpart's ``**kw`` takes any)."""
    port = PORT / module
    if not port.exists():
        return set()
    ours = _signatures(port)
    out = set()
    for func, params in _signatures(REF / module).items():
        if func not in ours:
            continue
        have = {p.lstrip("*") for p in ours[func]}
        if any(p.startswith("**") for p in ours[func]):
            params = [p for p in params if p.startswith("*")]
        out |= {f"{module}:{func}:{p.lstrip('*')}" for p in params if p.lstrip("*") not in have}
    return out


@pytest.mark.parametrize("module", _modules())
def test_every_reference_parameter_has_a_counterpart_or_a_reason(module):
    unlisted = sorted(k for k in _missing_params(module) if k not in PARAMS_NOT_PORTED)
    assert not unlisted, (
        f"the port's counterparts in src/repro_torch/{module} lack these parameters of the "
        f"reference's: {unlisted}; port each or add it to PARAMS_NOT_PORTED with its reason")


# the modes the port has; none of them may be excused
PORTED_MODES = {"margin", "groups", "iters", "check_every", "shardings"}


def test_the_parameter_allowlist_names_what_exists():
    for key, (reason, counterpart) in PARAMS_NOT_PORTED.items():
        module, func, param = key.split(":")
        assert param not in PORTED_MODES, f"{key}: the port has this mode"
        ref = _signatures(REF / module) if (REF / module).exists() else {}
        assert func in ref and param in {p.lstrip("*") for p in ref[func]}, f"{key}: gone"
        assert key in _missing_params(module), f"{key}: the port has it now; drop the entry"
        assert reason, key
        if counterpart is not None:
            assert counterpart in _signatures(PORT / module)[func], (
                f"{key}: the port's {func} has no parameter {counterpart}")
