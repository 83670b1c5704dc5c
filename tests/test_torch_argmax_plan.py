"""The plan of bf16 ``assign_argmax``'s kernel, and the port's plain
``assign_argmax`` on bf16 rows at the plan's seams, on the CPU.

``kernels/assign_argmax.py``'s ``tile_plan`` is what the wrapper hands the
C entry (which checks it against its own): center tiles of 128, the last as
narrow as its centers allow, folded into the block before it for bf16
centers when 16 or 32 wide, and one block for each row tile (128 or 192
rows) and block of a row tile. The card's kernel is held to ``assign_stats``' bf16 pass bit for
bit by ``tests/test_torch_gpu.py``; here the plain version, which a CPU
tensor takes, is held to ``repro.kernels.ref.assign_argmax`` and the Pallas
kernel in interpret mode where the plan's tiles meet: around 128 columns
and at the last tile's first column, with ties there, and at odd row-tile
counts. Tolerances are ``test_torch_bf16_routes.py``'s: integer rows exact,
unit rows' similarities within 1e-5, labels equal.
"""

from __future__ import annotations

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.assign_argmax import assign_argmax_pallas
from repro_torch import interop
from repro_torch.kernels import ops
from repro_torch.kernels.assign_argmax import ROWS, TILE, WIDTHS, tile_plan, tile_width

SIM_TOL = 1e-5

PLAN_K = (1, 16, 17, 64, 65, 128, 129, 144, 400, 800, 1600)
PLAN_N = (0, 1, 127, 128, 129, 255, 256, 257)


@pytest.fixture
def rng(request):
    """Seeded from the test's own name and parameters."""
    name = f"{request.module.__name__}::{request.node.name}"
    return np.random.default_rng(zlib.crc32(name.encode()))


@pytest.mark.parametrize("n", PLAN_N)
@pytest.mark.parametrize("k", PLAN_K)
def test_tile_plan(k, n):
    """For both center types: the tiles cover [0, k) once and in order;
    every width is one the width probe covers and holds its tile's
    centers; the last is the narrowest that does; only a last tile of 16 or
    32 bf16 centers' columns after another tile is folded; the grid is a
    block for each row tile (128 rows for bf16 centers, 192 for f32 ones'
    three parts) and block of a row tile."""
    for parts in (1, 3):
        plan = tile_plan(n, k, parts)
        starts = [s for s, _ in plan.tiles]
        assert starts == list(range(0, k, TILE))
        real = [min(TILE, k - s) for s in starts]
        assert sum(real) == k
        for (s, w), r in zip(plan.tiles, real):
            assert w in WIDTHS and r <= w
        assert all(w == TILE for _, w in plan.tiles[:-1])
        last, r = plan.tiles[-1][1], real[-1]
        assert last == min(w for w in WIDTHS if w >= r)
        assert WIDTHS.index(last) == 0 or r > WIDTHS[WIDTHS.index(last) - 1]
        assert plan.folded == (parts == 1 and len(plan.tiles) > 1 and last <= 32)
        assert plan.row_tiles == -(-n // ROWS[parts])
        assert plan.blocks == plan.row_tiles * (len(plan.tiles) - plan.folded)


@pytest.mark.parametrize("cols", range(1, TILE + 1))
def test_tile_width_is_the_narrowest(cols):
    w = tile_width(cols)
    assert w in WIDTHS and cols <= w and all(v < cols for v in WIDTHS if v < w)


def test_tile_plan_refuses_what_the_kernel_does_not_take():
    for args in ((1, 0, 1), (-1, 4, 1), (1, 4, 2)):
        with pytest.raises(ValueError):
            tile_plan(*args)


def _port(j):
    """The port's tensor of a JAX array (bf16 -> f32 -> bf16 is exact)."""
    t = torch.from_numpy(np.array(j.astype(jnp.float32)))
    return t.bfloat16() if j.dtype == jnp.bfloat16 else t


def _draw(rng, shape, kind):
    if kind == "int":
        return rng.integers(-256, 257, size=shape).astype(np.float32)
    a = rng.normal(size=shape).astype(np.float32)
    return a / np.linalg.norm(a, axis=1, keepdims=True)


def _seam_centers(rng, k, d, kind, dtype):
    """k centers with a tie between 127 and 128 (at k = 129 and 144 the last
    tile's first column) and, past it, one at the last tile's first column
    (equal to center 1), each to the lowest index."""
    c = _draw(rng, (k, d), kind)
    if k > 128:
        c[128] = c[127]
    first = TILE * ((k - 1) // TILE)
    if first > 128:
        c[first] = c[1]
    j = jnp.asarray(c, dtype)
    return j, _port(j)


def _rows_near(rng, jc, n, kind):
    """bf16 rows, a third of them copies of the tied centers (so the ties
    decide their labels)."""
    x = _draw(rng, (n, jc.shape[1]), kind)
    c = np.asarray(jc.astype(jnp.float32))
    k = c.shape[0]
    tied = [t for t in (127, TILE * ((k - 1) // TILE), 1) if t < k]
    for i in range(0, n, 3):
        x[i] = c[tied[i % len(tied)]]
    j = jnp.asarray(x, jnp.bfloat16)
    return j, _port(j)


@pytest.mark.parametrize("cdt", [jnp.bfloat16, jnp.float32], ids=["bf16_centers", "f32_centers"])
@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("n,k,d", [(257, 129, 40), (129, 144, 70), (257, 400, 40), (1, 400, 24)])
def test_assign_argmax_bf16_at_the_plan_seams(rng, n, k, d, kind, cdt):
    """The port's plain assign_argmax on bf16 x against the reference and
    the Pallas kernel (interpret) at the plan's seams: labels equal (ties to
    the lowest index), similarities exact on integer rows, within 1e-5 on
    unit rows."""
    jc, c = _seam_centers(rng, k, d, kind, cdt)
    jx, x = _rows_near(rng, jc, n, kind)
    got = ops.assign_argmax(x, c)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.float32
    g_idx, g_sim = interop.to_numpy(got[0]), interop.to_numpy(got[1])
    for want in (jref.assign_argmax(jx, jc), assign_argmax_pallas(jx, jc, interpret=True)):
        w_idx, w_sim = np.asarray(want[0]), np.asarray(want[1])
        np.testing.assert_array_equal(g_idx, w_idx)
        if kind == "int":
            np.testing.assert_array_equal(g_sim, w_sim)
        else:
            np.testing.assert_allclose(g_sim, w_sim, rtol=0, atol=SIM_TOL)
    # the higher twin of a tie never wins
    for twin in {128, TILE * ((k - 1) // TILE)} - {0, 1}:
        if twin < k:
            assert not (g_idx == twin).any()
