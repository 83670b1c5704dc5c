"""The port's interop helpers: they put their tensor on the card unless the
caller names another device, and on the CPU they give what they always gave.

``data``, ``labels`` and ``index`` carry state from the JAX package (numpy or
JAX arrays) into the port. With no device they resolve to CUDA through
``repro_torch.common.resolve_device``, which raises without a card and never
falls back to the CPU.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import interop

FUNCS = {
    "data": (interop.data, np.float32, torch.float32),
    "labels": (interop.labels, np.int32, torch.int32),
    "index": (interop.index, np.int64, torch.int64),
}

INPUTS = {
    "float64": np.array([[1.5, -2.25, 0.0], [-0.0, 3.0, 7.125]]),
    "int64": np.array([-1, 0, 4, 2, 9]),
    "list": [3, -1, 0, 2],
    "jax": jnp.array([[2.0, -1.0], [0.5, 4.0]], dtype=jnp.float32),
    "empty": np.zeros((0, 3), dtype=np.float32),
}


@pytest.fixture
def no_card(monkeypatch):
    """Whatever machine runs the test, the port sees no CUDA device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("name", sorted(FUNCS))
def test_interop_without_device_needs_the_card(no_card, name):
    fn = FUNCS[name][0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(np.arange(4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(np.arange(4), None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(np.arange(4), "cuda")


@pytest.mark.parametrize("kind", sorted(INPUTS))
@pytest.mark.parametrize("name", sorted(FUNCS))
def test_interop_on_the_cpu_keeps_values_and_dtypes(name, kind):
    fn, np_dtype, dtype = FUNCS[name]
    a = INPUTS[kind]
    want = torch.from_numpy(np.array(a, dtype=np_dtype))  # what the helpers gave before
    for dev in ("cpu", torch.device("cpu")):
        got = fn(a, dev)
        assert got.device.type == "cpu" and got.dtype == dtype
        assert got.shape == want.shape and torch.equal(got, want)
        np.testing.assert_array_equal(interop.to_numpy(got), np.array(a, dtype=np_dtype))


def test_interop_cpu_tensor_owns_its_memory():
    """The numpy input is copied: writing to it later leaves the tensor as it was."""
    a = np.array([1.0, 2.0, 3.0], dtype=np.float32)
    got = interop.data(a, "cpu")
    a[0] = 99.0
    assert got.tolist() == [1.0, 2.0, 3.0]
