"""The port's runs repeat bit for bit: the cell scatter sums in a fixed order.

Every grid gradient of the main path starts with the cell scatter
(``ops/grid_sample.py:_cell_scatter``): each point's 8 weighted corner
updates added into one 8C-wide row of its floor cell. The JAX package adds
them with an XLA scatter-add, whose order is fixed; the port adds them
with K4 (``ops/cuda/cell_scatter_kernel.py``), never with atomic adds: the
indices sorted stably, each stretch of one index inside a chunk of 32
sorted positions summed in the points' order, then each index's stretches
in order. On the CPU, where the wrapper runs its plain version:

  - ``_cell_scatter`` against the JAX ``_cell_scatter`` on the points and
    at the tolerance of ``tests/test_torch_grid_sample.py`` (rtol 1e-4,
    atol 1e-6 x the largest entry: the two sum each cell in another order),
    at a single grid's width (8C) and the fused pair's (16C);
  - the plain version ``torch.equal`` to that order written out row by
    row, under heavy duplicates (600 rows into 3 of 40, runs over many
    chunks; every point of a grid in 3 cells), and to the sequential sum
    in index order where no index has more rows than a chunk; held to the
    sequential sum (an ``index_put_(..., accumulate=True)`` on the card)
    at the tolerance above where it has;
  - frame 0's map (``Mapper.optimize_map``, three stages) twice from one
    scene and generator state: losses and every leaf ``torch.equal``;
  - no module of the port calls ``torch.use_deterministic_algorithms``,
    which is process-wide and would change the caller's other operations.
"""

from __future__ import annotations

import ast
import os
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attentive_dfprior_tpu.ops import grid_sample as J
from attentive_dfprior_tpu_torch.ops import grid_sample as T
from attentive_dfprior_tpu_torch.ops.cuda.cell_scatter_kernel import (
    CHUNK,
    cell_scatter_plain,
    cell_scatter_sum,
    sequential_sum,
)
from attentive_dfprior_tpu_torch.slam.system import SLAMSystem
from attentive_dfprior_tpu_torch.utils.tree import tree_leaves
from test_torch_grid_sample import _assert_grad_close, _points
from test_torch_imports import PKG, REPO
from test_torch_slam import tiny_room_cfg

torch.set_num_threads(1)


def _port_modules():
    return [os.path.join(root, f) for root, _, files in os.walk(PKG) for f in sorted(files) if f.endswith(".py")]


def _kernel_order_sum(nrows, idx, rows):
    """K4's order written out one row at a time: positions sorted stably by
    index; a stretch of one index inside a chunk summed from zero in order;
    each index's stretches summed from zero in order."""
    idx = idx.tolist()
    order = sorted(range(len(idx)), key=lambda i: (idx[i], i))
    stretches = {}
    for p, i in enumerate(order):
        if p % CHUNK == 0 or idx[i] != idx[order[p - 1]]:
            stretches.setdefault(idx[i], []).append(torch.zeros(rows.shape[1]))
        stretches[idx[i]][-1] = stretches[idx[i]][-1] + rows[i]
    out = torch.zeros((nrows, rows.shape[1]))
    for cell, parts in stretches.items():
        total = torch.zeros(rows.shape[1])
        for part in parts:
            total = total + part
        out[cell] = total
    return out


@pytest.mark.parametrize("shape", [(11, 5, 7, 3), (17, 6, 5, 2), (9, 4, 4, 32), (10, 6, 4, 64)])
def test_cell_scatter_matches_jax(shape):
    """(10, 6, 4, 64): the fused high + colour pair's joint width, 2C = 64."""
    rng = np.random.default_rng(11 + shape[0])
    p = _points(rng)
    ct = rng.standard_normal((len(p), shape[-1])).astype(np.float32)
    ref = np.asarray(J._cell_scatter(shape, jnp.asarray(p), jnp.asarray(ct)))
    got = T._cell_scatter(shape, torch.tensor(p), torch.tensor(ct))
    assert got.shape == ref.shape == (shape[0] * shape[1] * shape[2], 8 * shape[3])
    _assert_grad_close(got.numpy(), ref)


@pytest.mark.parametrize("width", [8, 256])
def test_plain_sum_keeps_the_kernel_order(width):
    """Heavy duplicates: 600 rows into 3 of 40 rows, in a shuffled order."""
    rng = np.random.default_rng(width)
    idx = torch.tensor(rng.choice([3, 17, 38], size=600))
    rows = torch.tensor((rng.standard_normal((600, width)) * 10.0 ** rng.integers(-3, 4, (600, 1))).astype(np.float32))
    got = cell_scatter_sum(40, idx, rows)
    assert torch.equal(got, cell_scatter_plain(40, idx, rows))
    assert torch.equal(got, _kernel_order_sum(40, idx, rows))
    assert not torch.equal(got, sequential_sum(40, idx, rows))  # runs over many chunks: another association
    _assert_grad_close(got.numpy(), sequential_sum(40, idx, rows).numpy())


def test_plain_sum_is_sequential_within_a_chunk():
    """Every index's rows lie in one chunk of the sorted positions (the
    counts split each chunk of CHUNK): every index's sum is the sequential
    sum of its rows in index order."""
    rng = np.random.default_rng(1)
    counts = np.concatenate([np.diff(np.r_[0, np.sort(rng.choice(np.arange(1, CHUNK), 3, replace=False)), CHUNK])
                             for _ in range(10)])
    idx = torch.tensor(rng.permutation(np.repeat(np.arange(len(counts)), counts)))
    rows = torch.tensor(rng.standard_normal((len(idx), 24)).astype(np.float32))
    assert torch.equal(cell_scatter_sum(60, idx, rows), sequential_sum(60, idx, rows))


def test_cell_scatter_rejects_non_cpu_non_cuda():
    rows = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError):
        cell_scatter_sum(2, torch.zeros((4,), dtype=torch.int64, device="meta"), rows)


def test_cell_scatter_in_three_cells_keeps_the_kernel_order():
    """Every point in one of 3 cells of a (9, 4, 4, 32) grid."""
    shape = (9, 4, 4, 32)
    rng = np.random.default_rng(7)
    dims = np.array(shape[:3], np.float64)
    corners = np.array([[1, 1, 1], [4, 2, 0], [7, 0, 2]])
    which = rng.integers(0, 3, 500)
    idx = corners[which] + rng.uniform(0.05, 0.95, (500, 3))  # unnormalized, inside the floor cell
    p = torch.tensor((idx / (dims - 1) * 2.0 - 1.0).astype(np.float32))
    ct = torch.tensor(rng.standard_normal((500, shape[3])).astype(np.float32))
    cell, upd = T._cell_updates(shape, p, ct)
    assert len(set(cell.tolist())) == 3
    got = T._cell_scatter(shape, p, ct)
    assert torch.equal(got, _kernel_order_sum(9 * 4 * 4, cell, upd))
    _assert_grad_close(got.numpy(), sequential_sum(9 * 4 * 4, cell, upd).numpy())


def test_two_maps_from_one_seed_are_equal():
    """Frame 0's map twice from one scene and generator state, as
    chip_smoke.py's phase 6 runs it on the card."""
    cfg = tiny_room_cfg()
    cfg["seed"] = 0
    slam = SLAMSystem(cfg, output=tempfile.mkdtemp(prefix="determinism_"), device="cpu")
    _, color, depth, gt = slam.dataset[0]
    init = [t.detach().clone() for t in tree_leaves(slam.params)]
    gen_state = slam.generator.get_state()

    def map_frame0():
        with torch.no_grad():
            for t, t0 in zip(tree_leaves(slam.params), init):
                t.copy_(t0)
        slam.generator.set_state(gen_state)
        m = slam.mapper
        _, _, _, stage_losses = m.optimize_map(
            slam.params, m.iters_first, m.lr_first_factor, 0, slam._to_device(color)[None],
            slam._to_device(depth)[None], np.asarray(gt)[None], generator=slam.generator,
            cur_depth_np=np.asarray(depth), cur_c2w_np=gt,
        )
        return torch.cat(list(stage_losses.values())), [t.detach().clone() for t in tree_leaves(slam.params)]

    (la, pa), (lb, pb) = map_frame0(), map_frame0()
    assert len(la) == cfg["mapping"]["iters_first"] and torch.isfinite(la).all()
    assert torch.equal(la, lb)
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))
    assert any(not torch.equal(a, b) for a, b in zip(pa, init))  # the map moved


@pytest.mark.parametrize("path", _port_modules(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_deterministic_algorithms_switch(path):
    tree = ast.parse(open(path).read(), filename=path)
    names = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    names |= {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    names |= {a.name for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) for a in n.names}
    assert "use_deterministic_algorithms" not in names, os.path.relpath(path, REPO)
