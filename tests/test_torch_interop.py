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


BF16_SOURCES = {
    # bf16 values: integers, halves, a subnormal-free spread, signed zero
    "jax": jnp.array([[1.5, -2.25, 0.0], [-0.0, 3.0, 7.125], [1e-3, -65504.0, 2.0**-20]],
                     dtype=jnp.bfloat16),
    "jax_row": jnp.array([0.333, -1.0, 250.0], dtype=jnp.bfloat16),
    "numpy": np.asarray(jnp.array([[0.1, 0.2], [0.3, -0.4]], dtype=jnp.bfloat16)),
    "empty": jnp.zeros((0, 4), dtype=jnp.bfloat16),
}


@pytest.mark.parametrize("kind", sorted(BF16_SOURCES))
def test_interop_data_carries_bf16_as_bf16(kind):
    """A bf16 source (its numpy dtype is named "bfloat16") becomes a bf16
    tensor with the same values, bits included, and ``to_numpy`` gives them
    back as f32."""
    a = BF16_SOURCES[kind]
    got = interop.data(a, "cpu")
    assert got.dtype == torch.bfloat16 and got.device.type == "cpu"
    want = np.array(a, dtype=np.float32)
    assert tuple(got.shape) == want.shape
    back = interop.to_numpy(got)
    assert back.dtype == np.float32
    np.testing.assert_array_equal(back.view(np.int32), want.view(np.int32))
    # the bits of the bf16 source itself: its high 16 bits of the f32
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(a).view(np.int16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.int64, torch.bool])
def test_interop_to_numpy_keeps_other_dtypes(dtype):
    """Only bf16 is widened: f32, int32, int64 and bool tensors come back in
    their own dtype."""
    t = torch.tensor([[0, 1, 2], [3, 0, 5]]).to(dtype)
    got = interop.to_numpy(t)
    assert got.dtype == torch.empty((), dtype=dtype).numpy().dtype
    np.testing.assert_array_equal(got, t.numpy())


def test_interop_to_numpy_of_bf16_tensor_is_f32():
    t = torch.tensor([0.1, -3.0, 1e30], dtype=torch.bfloat16)
    got = interop.to_numpy(t)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, t.float().numpy())
