"""``kernels/assign_stats.split_bf16x3``: f32 centers as three bf16 parts.

``assign_stats``' bf16 mode multiplies bf16 rows by f32 centers on the
tensor cores through these parts: every bf16 x bf16 product is exact in f32,
so the split must give back each center value exactly (in f64, where three
parts add without rounding). The wrapper builds the parts in plain tensor
code, so these checks run on the CPU; the kernel's use of them runs on the
card (``tests/test_torch_gpu.py``'s bf16 gates).
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:
    from hypothesis_stub import given, settings, st

from repro_torch.kernels.assign_stats import split_bf16x3, split_stride

F32_MAX = float(np.finfo(np.float32).max)
F32_TINY = float(np.finfo(np.float32).tiny)  # smallest normal, 2^-126
EXACT_FROM = 2.0**-100  # the split is exact from here up (in fact from 2^-110)
BELOW_ULP = 2.0**-123  # one f32 ulp at 2^-100: the bound below it


def _sum_of_parts(c: torch.Tensor) -> torch.Tensor:
    parts = split_bf16x3(c).double()
    return (parts[0] + parts[1] + parts[2])[:, : c.shape[1]]


def _row(values) -> torch.Tensor:
    return torch.tensor([values], dtype=torch.float32)


@pytest.mark.parametrize("value", [
    0.0, -0.0, F32_MAX, -F32_MAX, 1.0, -1.0, 1.0 + 2.0**-23, 3.0 - 2.0**-22,
    F32_TINY, -F32_TINY, EXACT_FROM, math.pi, 1.0 / 3.0, 0.022097087,
])
def test_split_is_exact_at_edge_values(value):
    c = _row([value])
    assert torch.equal(_sum_of_parts(c), c.double())


def test_split_keeps_the_sign_and_shrinks():
    """Each part carries c's sign and is at most 2^-7 of the one before (the
    parts are truncated, never rounded up)."""
    rng = np.random.default_rng(0)
    c = torch.from_numpy((rng.normal(size=(7, 301)) * 10.0 ** rng.integers(-30, 30, size=(7, 301)))
                         .astype(np.float32))
    p = split_bf16x3(c).float()[:, :, :301]
    for a, b in ((p[0], p[1]), (p[1], p[2])):
        assert ((b == 0) | (torch.sign(b) == torch.sign(c))).all()
        assert (b.abs() <= a.abs() * 2.0**-7).all()
    assert torch.isfinite(p).all()


@settings(max_examples=300, deadline=None)
@given(st.lists(st.floats(width=32, allow_nan=False, allow_infinity=False),
                min_size=1, max_size=40))
def test_split_is_exact_over_f32(values):
    c = _row([v for v in values if v == 0.0 or abs(v) >= EXACT_FROM] or [0.0])
    assert torch.equal(_sum_of_parts(c), c.double())


@settings(max_examples=300, deadline=None)
@given(st.lists(st.floats(min_value=-EXACT_FROM, max_value=EXACT_FROM, width=32,
                          exclude_min=True, exclude_max=True), min_size=1, max_size=40))
def test_split_below_the_range_within_one_ulp(values):
    """Below 2^-100 the low part can fall under bf16's smallest step (2^-133):
    what it drops stays within one f32 ulp of 2^-100."""
    c = _row(values)
    assert ((_sum_of_parts(c) - c.double()).abs() <= BELOW_ULP).all()


@pytest.mark.parametrize("d", [1, 7, 8, 31, 33, 63, 64, 65, 130, 257, 2048])
def test_split_rows_land_in_the_padded_stride(d):
    """(k, d) -> (3, k, split_stride(d)): a stride of 16-byte rows (a
    multiple of 8 elements), at least one ring stage's 64 columns, the
    parts in columns 0 .. d-1 of each row and zeros after them."""
    stride = split_stride(d)
    assert stride % 8 == 0 and stride >= max(d, 64) and stride - max(d, 64) < 8
    rng = np.random.default_rng(d)
    c = torch.from_numpy(rng.normal(size=(5, d)).astype(np.float32))
    parts = split_bf16x3(c)
    assert parts.dtype == torch.bfloat16 and parts.shape == (3, 5, stride)
    assert parts.is_contiguous()
    assert (parts[:, :, d:] == 0).all()
    assert torch.equal((parts[0].double() + parts[1].double() + parts[2].double())[:, :d],
                       c.double())


def test_split_products_with_bf16_rows_are_exact():
    """What the kernel relies on: a bf16 value times each part is exact in
    f32, so x . c is the sum of three exactly formed products."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32)).bfloat16()
    c = torch.from_numpy(rng.normal(size=(1, 64)).astype(np.float32))
    parts = split_bf16x3(c)[:, 0, :64]
    for p in parts:
        prod = x.float() * p.float()
        assert torch.equal(prod.double(), x.double() * p.double())
    total = sum((x.double() * p.double()) for p in parts)
    assert torch.equal(total, x.double() * c[0].double())
