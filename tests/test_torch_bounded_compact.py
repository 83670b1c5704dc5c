"""The bf16 bounded pass's list of active rows, on the CPU.

On the card ``assign_stats_bounded_cuda`` on bf16 rows runs a row pass over
the rows with a carried center (their norms and similarities), deflates the
carried bounds by those norms, and walks the active rows, which it lists with a
cumsum and a scatter (``kernels/assign_stats.active_rows``), leaving the
count on the device so that nothing waits on the host. That list is plain
tensor code: here it is held against ``np.flatnonzero(idx0 < 0)``, and the
settled set it is built from (``settled_rows``, the wrapper's deflation of
the carried bounds by the rows' norms) is held against the JAX reference's
``pruned`` mask on the same bf16 draws.
The walk itself runs only on the card (``tests/test_torch_gpu.py``).
"""

from __future__ import annotations

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.common import sq_row_norms
from repro_torch.kernels.assign_stats import active_rows, settled_rows

SIZES = [0, 1, 127, 128, 129, 1000]
PATTERNS = ["all_settled", "none_settled", "one_active_per_block", "runs_across_borders"]


@pytest.fixture
def rng(request):
    """Seeded from the test's own name and parameters."""
    name = f"{request.module.__name__}::{request.node.name}"
    return np.random.default_rng(zlib.crc32(name.encode()))


def _idx0(rng, n: int, pattern: str) -> np.ndarray:
    """(n,) int32: a carried center in [0, 50) for a settled row, -1 for an
    active one, laid out by ``pattern`` against the walk's 128-row blocks."""
    idx0 = rng.integers(0, 50, size=n).astype(np.int32)
    if pattern == "none_settled":
        idx0[:] = -1
    elif pattern == "one_active_per_block":
        idx0[rng.integers(0, 128) :: 128] = -1
    elif pattern == "runs_across_borders":
        for b in range(128, n + 128, 128):  # runs over each border, and one at the end
            idx0[max(0, b - 5) : b + 3] = -1
        idx0[n - n // 3 :] = -1
    return idx0


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("n", SIZES)
def test_active_rows_lists_active_rows_in_order(rng, n, pattern):
    """The first ``count`` entries are the active rows in ascending order,
    the rest the settled rows (each row once), and the count is a (1,)
    int64 tensor on idx0's device, never a Python int."""
    idx0 = _idx0(rng, n, pattern)
    rows, count = active_rows(torch.from_numpy(idx0))
    assert isinstance(count, torch.Tensor)
    assert count.shape == (1,) and count.dtype == torch.int64 and count.device.type == "cpu"
    assert rows.shape == (n,) and rows.dtype == torch.int32
    want = np.flatnonzero(idx0 < 0)
    c = int(count[0])
    assert c == want.size
    np.testing.assert_array_equal(rows[:c].numpy(), want)
    np.testing.assert_array_equal(rows[c:].numpy(), np.flatnonzero(idx0 >= 0))
    if pattern == "all_settled":
        assert c == 0
    if pattern == "none_settled":
        assert c == n


@pytest.mark.parametrize("stale_every", [0, 1, 5, 128])
def test_active_rows_of_the_reference_pruned_mask(rng, stale_every):
    """On bf16 integer rows near integer centers, carried bounds from the
    JAX reference's full pass, two centers moved and every ``stale_every``-th
    row invalidated: the wrapper's settled set equals the reference's
    pruned mask, and the walk's list is the reference's unpruned rows."""
    n, k, d = 1000, 70, 40
    c = rng.integers(-4, 5, size=(k, d)).astype(np.float32)
    x = (c[rng.integers(0, k, size=n)] + rng.integers(-1, 2, size=(n, d))).astype(np.float32)
    xj, cj = jnp.asarray(x, dtype=jnp.bfloat16), jnp.asarray(c)
    sentinel = (jnp.full((n,), -1, jnp.int32), jnp.full((n,), -jref.BIG, jnp.float32),
                jnp.full((n,), jref.BIG, jnp.float32))
    first = jref.assign_stats_bounded(xj, cj, *sentinel, jnp.zeros((k,), jnp.float32))
    moved = c.copy()
    moved[0, 0] += 1
    moved[k // 2, d - 1] -= 1
    drift = np.linalg.norm(moved - c, axis=1).astype(np.float32)
    prev, lo, hi = (np.array(a) for a in first[6:9])
    if stale_every:
        prev[::stale_every], lo[::stale_every], hi[::stale_every] = -1, -jref.BIG, jref.BIG
    want = np.array(jref.assign_stats_bounded(
        xj, jnp.asarray(moved), jnp.asarray(prev), jnp.asarray(lo), jnp.asarray(hi),
        jnp.asarray(drift))[9])
    if stale_every != 1:
        assert want.any()
    # the norms the card's row pass gives bf16 rows: f32 sums of squares
    rownorm = torch.sqrt(sq_row_norms(torch.from_numpy(x).bfloat16()))
    idx0, pruned, _ = settled_rows(torch.from_numpy(prev), torch.from_numpy(lo),
                                   torch.from_numpy(hi), rownorm, torch.from_numpy(drift))
    np.testing.assert_array_equal(pruned.numpy(), want)
    np.testing.assert_array_equal(idx0.numpy()[want], prev[want])
    rows, count = active_rows(idx0)
    np.testing.assert_array_equal(rows[: int(count[0])].numpy(), np.flatnonzero(~want))
