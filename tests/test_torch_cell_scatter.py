"""K4's hand-written sort, step by step on the CPU, and the cell scatter's
index precondition.

The CUDA kernel (``csrc/cell_scatter.cu``) sorts the cell indices with an
LSD radix sort over the key range alone: ``sort_plan`` cuts ceil(log2(nrows))
bits into passes of at most 10 bits, and each pass ranks its keys stably
inside 2048-key tiles (8 warps of 256 keys, 32 at a time, equal digits
ranked by one ballot a bit + popc) and across tiles by a look-back.
``emulate_sort`` runs that algorithm in PyTorch; these tests hold its
permutation ``torch.equal`` to ``torch.sort(stable=True)``'s, on which the
chunk boundaries and so every bit of the sum depend:

  - random, all-equal and descending keys; the floor cells of points along
    rays from a few cameras (the main path's shape, as
    ``tools/profile_scatter.py`` draws them, here from a numpy seed);
  - ``nrows`` at 2^18 - 1, 2^18 + 1 and 2^19 + 1 (18, 19 and 20 bits);
  - ``n`` off the 2048-key tile and the 256-key warp, and n = 240,000
    (ScanNet's points a mapping iteration);

then ``sort_plan`` itself, and the precondition: every index in [0,
nrows). On the CPU the wrapper raises for one outside; on the card the
kernel traps. The scatter at ray-shaped points is held to the JAX
package's ``_cell_scatter`` at ``tests/test_torch_grid_sample.py``'s
tolerance.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attentive_dfprior_tpu.ops import grid_sample as J
from attentive_dfprior_tpu_torch.ops import grid_sample as T
from attentive_dfprior_tpu_torch.ops.cuda.cell_scatter_kernel import (
    RADIX_BITS,
    TILE_KEYS,
    WARP_KEYS,
    cell_scatter_plain,
    cell_scatter_sum,
    cell_sort,
    emulate_sort,
    sort_plan,
)
from test_torch_grid_sample import _assert_grad_close

torch.set_num_threads(1)


def _ray_points(rng, cams, rays):
    """(cams * rays * 48, 3) normalized points: 32 samples from near the
    camera to past the grid, 16 around a surface depth, a ray."""
    org = rng.uniform(-0.6, 0.6, (cams, 1, 1, 3))
    d = rng.standard_normal((cams, rays, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    surf = rng.uniform(0.3, 1.2, (cams, rays, 1))
    t = np.concatenate([np.broadcast_to(np.linspace(0.02, 1.5, 32), (cams, rays, 32)),
                        surf + np.linspace(-0.05, 0.05, 16)], axis=-1)
    return (org + d * t[..., None]).reshape(-1, 3).astype(np.float32)


def _ray_cells(shape, cams, rays, seed):
    p = torch.tensor(_ray_points(np.random.default_rng(seed), cams, rays))
    cell, _ = T._cell_updates(shape[:3] + (1,), p, torch.zeros((len(p), 1)))
    return shape[0] * shape[1] * shape[2], cell


def _keys(case):
    rng = np.random.default_rng(CASES.index(case))
    if case == "random":
        return 5000, torch.tensor(rng.integers(0, 5000, 20_000))
    if case == "all equal":
        return 700, torch.full((9000,), 411)
    if case == "descending":
        return 12_000, torch.arange(11_999, -1, -1)
    if case == "room0 rays, 8C":
        return _ray_cells((74, 56, 44, 32), 5, 200, 0)
    if case == "ScanNet rays, 240,000":
        return _ray_cells((81, 84, 46, 32), 10, 500, 1)
    if case.startswith("nrows "):
        nrows = {"2^18 - 1": 2**18 - 1, "2^18 + 1": 2**18 + 1, "2^19 + 1": 2**19 + 1}[case[6:]]
        idx = rng.integers(0, nrows, 30_000)
        idx[:3] = [0, nrows - 1, nrows - 1]  # both ends of the key range
        return nrows, torch.tensor(idx)
    n = int(case.split()[1])
    return 300, torch.tensor(rng.integers(0, 300, n))


CASES = ["random", "all equal", "descending", "room0 rays, 8C", "ScanNet rays, 240,000", "nrows 2^18 - 1",
         "nrows 2^18 + 1", "nrows 2^19 + 1", "n 1", "n 31", "n 255", "n 2047", "n 2049", "n 6001", "n 240000"]


@pytest.mark.parametrize("case", CASES)
def test_emulated_sort_is_torch_stable_sort(case):
    nrows, idx = _keys(case)
    assert 0 <= int(idx.min()) and int(idx.max()) < nrows
    keys, perm = emulate_sort(nrows, idx)
    ref = torch.sort(idx, stable=True)
    assert torch.equal(keys, ref.values)
    assert torch.equal(perm, ref.indices)


def test_sort_cases_cover_the_tiles():
    """The cases above reach a partial tile and a partial warp, many tiles,
    passes of 10 bits and passes narrower."""
    sizes = {len(_keys(c)[1]) for c in CASES}
    assert any(s % TILE_KEYS and s > TILE_KEYS for s in sizes)
    assert any(s % WARP_KEYS for s in sizes) and max(sizes) == 240_000
    widths = {b for c in CASES for _, b in sort_plan(_keys(c)[0])}
    assert RADIX_BITS in widths and min(widths) < RADIX_BITS


@pytest.mark.parametrize("nrows, plan", [
    (1, [(0, 0), (0, 0)]), (2, [(0, 1), (1, 0)]), (3, [(0, 1), (1, 1)]), (1024, [(0, 5), (5, 5)]),
    (1025, [(0, 6), (6, 5)]),
    (182_336, [(0, 9), (9, 9)]), (312_984, [(0, 10), (10, 9)]), (2**18 - 1, [(0, 9), (9, 9)]),
    (2**18, [(0, 9), (9, 9)]), (2**18 + 1, [(0, 10), (10, 9)]), (2**19 + 1, [(0, 10), (10, 10)]),
    (2**20 + 1, [(0, 7), (7, 7), (14, 7)]), (2**31 - 1, [(0, 8), (8, 8), (16, 8), (24, 7)]),
])
def test_sort_plan(nrows, plan):
    """room0's high grid (182,336 cells) and ScanNet's (312,984) sort in two
    passes, as does every grid of up to 2^20 cells; the bits are
    ceil(log2(nrows)), low bits first, none skipped."""
    assert sort_plan(nrows) == plan
    bits = sum(b for _, b in plan)
    assert bits == int(np.ceil(np.log2(nrows)))
    assert nrows - 1 < 2**bits and len(plan) >= 2 and all(0 <= b <= RADIX_BITS for _, b in plan)
    assert [s for s, _ in plan] == list(np.cumsum([0] + [b for _, b in plan[:-1]]))


@pytest.mark.parametrize("bad", ["nrows", "-1", "2^40"])
def test_index_out_of_range_raises_on_cpu(bad):
    nrows = 50
    idx = torch.tensor([3, 7, 0, 49, 12])
    idx[2] = {"nrows": nrows, "-1": -1, "2^40": 2**40}[bad]
    with pytest.raises(IndexError):
        cell_scatter_sum(nrows, idx, torch.ones((5, 8)))


def test_cell_sort_needs_the_card():
    with pytest.raises(ValueError):
        cell_sort(10, torch.zeros((4,), dtype=torch.int64))


@pytest.mark.parametrize("C", [32, 64])
def test_ray_shaped_scatter_matches_jax(C):
    """(16, 12, 10, C): 8C = 256, one grid's width, and 512, the high +
    colour pair's; 9,600 points from 4 cameras, many rays sharing cells."""
    shape = (16, 12, 10, C)
    rng = np.random.default_rng(C)
    p = _ray_points(rng, 4, 50)
    ct = rng.standard_normal((len(p), C)).astype(np.float32)
    ref = np.asarray(J._cell_scatter(shape, jnp.asarray(p), jnp.asarray(ct)))
    got = T._cell_scatter(shape, torch.tensor(p), torch.tensor(ct))
    _assert_grad_close(got.numpy(), ref)
    cell, upd = T._cell_updates(shape, torch.tensor(p), torch.tensor(ct))
    assert torch.equal(got, cell_scatter_plain(16 * 12 * 10, cell, upd))
