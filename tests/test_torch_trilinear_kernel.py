"""K7, the trilinear lookup (``ops/cuda/trilinear_kernel.py``), held on the CPU.

The kernel (``csrc/trilinear_gather.cu``) runs only on the card, where
``chip_smoke.py`` phase 2 holds it bit for bit to ``trilinear_sample``. Here
the wrapper's CPU route is ``trilinear_sample`` itself (``torch.equal``) at
every width the kernel takes, single and pair, on points inside, on the
border, outside [-1, 1] and exactly on a node, at N = 1, an odd N and a
large one; every sampler's forward (each grid-gradient variant's and the
fused pair's) goes through the wrapper; the gradients, which the wrapper
leaves alone, equal the composition they are made of (the point gradient by
autodiff of ``trilinear_sample``, the grid gradient by the variant's own
function); the wrapper's checks refuse what the kernel does not take.
"""

from __future__ import annotations

import os
import re

import numpy as np
import pytest
import torch

from attentive_dfprior_tpu_torch.ops import grid_sample as gs
from attentive_dfprior_tpu_torch.ops.cuda import trilinear_kernel as K7
from test_torch_imports import REPO

# n - 1 a power of two on every axis, so nodes are exact floats in [-1, 1]
SHAPE = (5, 9, 3)


def _points(n: int, seed: int = 0) -> torch.Tensor:
    """(n, 3) points: a quarter inside, a quarter on the border (+-1 on one
    axis), a quarter outside [-1, 1] (up to 1.5), a quarter on nodes."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-0.999, 0.999, (n, 3))
    kind = np.arange(n) % 4
    border = kind == 1
    p[border, rng.integers(0, 3, border.sum())] = rng.choice([-1.0, 1.0], border.sum())
    outside = kind == 2
    p[outside] = rng.uniform(-1.5, 1.5, (outside.sum(), 3))
    node = kind == 3
    for a, size in enumerate(SHAPE):
        p[node, a] = -1.0 + 2.0 * rng.integers(0, size, node.sum()) / (size - 1)
    return torch.tensor(p, dtype=torch.float32)


def _grid(c: int, seed: int) -> torch.Tensor:
    return torch.randn((*SHAPE, c), generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("n", [1, 77, 50_001])
@pytest.mark.parametrize("c", K7.CHANNELS)
def test_plain_route_is_trilinear_sample(c, n):
    p = _points(n, seed=n)
    a, b = _grid(c, 1), _grid(c, 2)
    assert torch.equal(K7.trilinear_gather(a, p), gs.trilinear_sample(a, p))
    pa, pb = K7.trilinear_gather_pair(a, b, p)
    assert torch.equal(pa, gs.trilinear_sample(a, p)) and torch.equal(pb, gs.trilinear_sample(b, p))


def test_points_reach_every_case():
    """The points hit the border clamp, the outside clamp and exact nodes."""
    p = _points(400)
    idx = (p + 1.0) * 0.5 * (torch.tensor(SHAPE, dtype=torch.float32) - 1.0)
    assert bool((p.abs() == 1.0).any()) and bool((p.abs() > 1.0).any())
    on_node = (idx == torch.floor(idx)).all(dim=1)
    assert int(on_node.sum()) >= 100


SAMPLERS = {"halo": gs.trilinear_sample_halo, "bitfold": gs.trilinear_sample_bf,
            "cellstencil": gs.trilinear_sample_cs, "pallas": gs.trilinear_sample_psc,
            "sorted": gs.trilinear_sample_opt}
GRID_GRADS = {"halo": gs._halo_grid_grad, "bitfold": gs._bitfold_grid_grad,
              "cellstencil": gs._cell_stencil_grid_grad, "pallas": gs._pallas_grid_grad,
              "sorted": gs._sorted_grid_grad}


def test_every_gradient_variant_has_a_sampler_here():
    assert set(SAMPLERS) == set(gs.GRID_VJPS) - {"xla"}


@pytest.fixture
def counted(monkeypatch):
    """The wrapper's two entry points, as ``ops/grid_sample.py`` calls them,
    counting their calls."""
    calls = {"single": 0, "pair": 0}

    def single(grid, p):
        calls["single"] += 1
        return K7.trilinear_gather(grid, p)

    def pair(a, b, p):
        calls["pair"] += 1
        return K7.trilinear_gather_pair(a, b, p)

    monkeypatch.setattr(gs, "trilinear_gather", single)
    monkeypatch.setattr(gs, "trilinear_gather_pair", pair)
    return calls


@pytest.mark.parametrize("impl", list(SAMPLERS))
def test_sampler_forward_goes_through_the_wrapper(impl, counted):
    grid, p = _grid(32, 3), _points(64)
    assert torch.equal(SAMPLERS[impl](grid, p), gs.trilinear_sample(grid, p))
    assert counted == {"single": 1, "pair": 0}


@pytest.mark.parametrize("impl", gs.PAIR_VJPS)
def test_pair_forward_goes_through_the_wrapper(impl, counted):
    a, b, p = _grid(32, 4), _grid(32, 5), _points(64)
    fa, fb = gs.trilinear_sample_pair(a, b, p, impl)
    assert torch.equal(fa, gs.trilinear_sample(a, p)) and torch.equal(fb, gs.trilinear_sample(b, p))
    assert counted == {"single": 0, "pair": 1}


def test_plain_sampler_does_not_go_through_the_wrapper(counted):
    grid, p = _grid(32, 6), _points(64)
    gs.grid_sampler("xla")(grid, p)
    assert counted == {"single": 0, "pair": 0}


def _leaf(t: torch.Tensor) -> torch.Tensor:
    return t.clone().requires_grad_(True)


@pytest.mark.parametrize("impl", list(SAMPLERS))
def test_sampler_gradients_are_their_composition(impl):
    """Grid and point gradients through the sampler ``torch.equal`` to the
    functions its backward is made of, on the same inputs."""
    grid, p = _grid(32, 7), _points(301, seed=7)
    ct = torch.randn((301, 32), generator=torch.Generator().manual_seed(8))
    g, q = _leaf(grid), _leaf(p)
    (SAMPLERS[impl](g, q) * ct).sum().backward()
    assert torch.equal(q.grad, gs._point_grad([grid], p, [ct]))
    assert torch.equal(g.grad, GRID_GRADS[impl](tuple(grid.shape), p, ct))
    q2 = _leaf(p)
    (gs.trilinear_sample(grid, q2) * ct).sum().backward()
    assert torch.equal(q.grad, q2.grad)  # the point gradient is plain autodiff


@pytest.mark.parametrize("impl", gs.PAIR_VJPS)
def test_pair_gradients_are_their_composition(impl):
    a, b, p = _grid(32, 9), _grid(32, 10), _points(301, seed=9)
    gen = torch.Generator().manual_seed(11)
    ca, cb = torch.randn((301, 32), generator=gen), torch.randn((301, 32), generator=gen)
    la, lb, q = _leaf(a), _leaf(b), _leaf(p)
    fa, fb = gs.trilinear_sample_pair(la, lb, q, impl)
    ((fa * ca).sum() + (fb * cb).sum()).backward()
    assert torch.equal(q.grad, gs._point_grad([a, b], p, [ca, cb]))
    joint_shape = (*SHAPE, 64)
    cells = gs._cell_scatter(joint_shape, p, torch.cat([ca, cb], dim=1))
    fold = gs.cell_fold_halo(cells, joint_shape) if impl == "halo" else gs.cell_fold_plain(joint_shape, cells)
    assert torch.equal(la.grad, fold[..., :32]) and torch.equal(lb.grad, fold[..., 32:])


def _misaligned(shape) -> torch.Tensor:
    """A contiguous float32 grid 4 bytes off a 16-byte boundary."""
    n = int(np.prod(shape))
    base = torch.zeros(n + 4)
    off = next(i for i in range(1, 4) if (base.data_ptr() + 4 * i) % 16)
    return base[off: off + n].view(shape)


@pytest.mark.parametrize("case", ["points float64", "points (N, 2)", "points not contiguous", "grid float64",
                                  "grid 3-D", "C = 12", "C = 3", "grid not contiguous", "grid misaligned",
                                  "pair shapes differ", "grid on another device"])
def test_checks_refuse_what_the_kernel_does_not_take(case):
    p, grid, other = _points(10), _grid(32, 12), _grid(32, 13)
    grids = [grid]
    if case == "points float64":
        p = p.double()
    elif case == "points (N, 2)":
        p = p[:, :2].contiguous()
    elif case == "points not contiguous":
        p = torch.cat([p, p], dim=1)[:, ::2]
    elif case == "grid float64":
        grids = [grid.double()]
    elif case == "grid 3-D":
        grids = [grid[..., 0].contiguous()]
    elif case == "C = 12":
        grids = [_grid(12, 14)]
    elif case == "C = 3":
        grids = [_grid(3, 14)]
    elif case == "grid not contiguous":
        grids = [grid.transpose(0, 1)]
    elif case == "grid misaligned":
        grids = [_misaligned(grid.shape)]
    elif case == "pair shapes differ":
        grids = [grid, _grid(16, 15)]
    elif case == "grid on another device":
        grids = [grid.to("meta")]
    with pytest.raises(ValueError):
        K7._check(grids, p)


def test_checks_take_what_the_kernel_takes():
    p = _points(10)
    for c in K7.CHANNELS:
        K7._check([_grid(c, 16)], p)
        K7._check([_grid(c, 16), _grid(c, 17)], p)


def test_launch_refuses_a_cpu_tensor():
    with pytest.raises(ValueError, match="unsupported device"):
        K7._launch([_grid(32, 18)], _points(10))


def test_kernel_source_takes_the_wrappers_widths():
    """``trilinear_gather_takes`` and the launch's dispatch in the source
    name the wrapper's ``CHANNELS`` (``_bind`` checks the built library)."""
    src = open(os.path.join(REPO, "attentive_dfprior_tpu_torch", "csrc", "trilinear_gather.cu")).read()
    takes = re.search(r"trilinear_gather_takes\(int c\) \{ return ([^;]*);", src).group(1)
    assert tuple(sorted(int(c) for c in re.findall(r"c == (\d+)", takes))) == K7.CHANNELS
    cases = tuple(sorted(int(c) for c in re.findall(r"case (\d+): return launch<", src)))
    assert cases == K7.CHANNELS


def test_k7_is_a_step_kernel():
    from attentive_dfprior_tpu_torch.ops.cuda.build import port_kernels, step_kernels

    assert K7.KERNEL in port_kernels() and K7.KERNEL in step_kernels()
    assert os.path.exists(K7.KERNEL.source)
