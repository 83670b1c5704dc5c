"""The port's training loss against the JAX package's for the moe, hybrid
and rwkv archs, on the CPU (the dense, vlm and encdec ones, the helpers
and the tolerances are in ``test_torch_train_models.py``): loss within rtol
1e-5, each gradient leaf within 1e-4 of its max |g|, and a MoE loss's
routing (every layer's dispatch slots, drops included) equal to the
reference's as integers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe  # noqa: F401  (the module, patched below)
import repro_torch.models.moe  # noqa: F401
from repro import configs as jconfigs
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro_torch import configs as tconfigs
from repro_torch.models import transformer as ttransformer
from repro_torch.models.interop import params_from_jax
from test_torch_train_models import _seeded, _t, check_grads, check_loss, loss_run, numpy_batch

FAMILIES = ["moonshot-v1-16b-a3b", "mixtral-8x22b", "zamba2-2.7b", "rwkv6-3b"]
MOE = [a for a in FAMILIES if jconfigs.get_config(a).family == "moe"]


@pytest.fixture(scope="module", params=FAMILIES)
def run(request):
    return loss_run(request.param)


def test_loss_matches_the_reference(run):
    check_loss(run)
    if run["cfg"].family == "moe":
        assert run["aux"][0] >= 1.0  # the balance loss is at least 1 a layer


def test_grads_match_the_reference(run):
    check_grads(run)


@pytest.mark.parametrize("arch", MOE)
def test_moe_routing_in_the_loss_matches_the_reference(arch, monkeypatch):
    """Each MoE layer's ``dest`` (expert slot of every choice, the sink for
    a dropped one) in the loss's forward, equal to the reference's, at
    capacity factor 1.0, where choices drop."""
    import dataclasses

    cf = 1.0
    jcfg = jconfigs.get_config(arch, reduced=True)
    tcfg = tconfigs.get_config(arch, reduced=True)
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, capacity_factor=cf))
    tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe, capacity_factor=cf))
    params = jax.jit(jregistry.get_model(jcfg).init_params)(jax.random.PRNGKey(11))
    nb = numpy_batch(_seeded(f"route{arch}{cf}"), jcfg, b=4, t=32)

    jdest = []
    jinner = repro.models.moe._dispatch_group

    def jdispatch(*a):
        out = jinner(*a)
        jax.debug.callback(lambda d: jdest.append(np.asarray(d)), out[1])
        return out

    monkeypatch.setattr(repro.models.moe, "_dispatch_group", jdispatch)
    jax.block_until_ready(jax.jit(lambda p, b: jtransformer.loss_fn(p, jcfg, b)[0])(
        params, {k: jnp.asarray(v) for k, v in nb.items()}))

    tdest = []
    tinner = repro_torch.models.moe._dispatch_group

    def tdispatch(*a):
        out = tinner(*a)
        tdest.append(out[1].numpy().copy())
        return out

    monkeypatch.setattr(repro_torch.models.moe, "_dispatch_group", tdispatch)
    lm = params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, params), "cpu")
    ttransformer.grad_buffers(lm)
    ttransformer.loss_fn(lm, tcfg, {k: _t(v) for k, v in nb.items()})[0].backward()
    n_moe = tcfg.n_layers - tcfg.moe.first_k_dense
    # the port's checkpointed layers dispatch again in backward (last layer
    # first), to the same slots
    assert len(tdest) == 2 * n_moe and len(jdest) == n_moe
    for got, want in zip(tdest[:n_moe], jdest, strict=True):
        np.testing.assert_array_equal(got, want.reshape(-1))
    for a, b in zip(tdest[:n_moe], tdest[n_moe:][::-1], strict=True):
        np.testing.assert_array_equal(a, b)
    sink = tcfg.moe.n_experts * ttransformer.moe_mod.capacity(tcfg.moe, 4 * 32)
    assert sum(int((d == sink).sum()) for d in tdest[:n_moe]) > 0  # choices dropped
