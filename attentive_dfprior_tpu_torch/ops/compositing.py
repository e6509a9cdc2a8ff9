"""Volume-rendering compositing: raw network outputs -> depth/var/rgb.

The port of the JAX package's ``ops/compositing.py`` (ref:
src/common.py:206-251). In occupancy mode alpha = sigmoid(10 * occ);
weights are alpha-composited transmittance products.

The transmittance's cumulative product takes its gradient by
``cumprod_positive``: PyTorch's own formula for an input without zeros
(``1 - alpha + 1e-10`` has none), without the host check for zeros with
which ``torch.cumprod``'s backward picks that formula. That check reads a
device value on the host, which a CUDA graph cannot capture
(``utils/step_graph.py``); the values are the same bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch


class _CumprodPositive(torch.autograd.Function):
    """``torch.cumprod`` along the last axis; backward ``reversed cumsum(out *
    grad) / x``, the formula ``torch.cumprod``'s backward takes when ``x``
    holds no zero (torch/csrc/autograd/FunctionsManual.cpp,
    ``cumprod_backward``), without its host-side check."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        if x.shape[-1] <= 1:
            return grad
        w = out * grad
        return w.flip(-1).cumsum(-1).flip(-1).div(x)


def cumprod_positive(x: torch.Tensor) -> torch.Tensor:
    """Cumulative product along the last axis of an input with no zeros."""
    return _CumprodPositive.apply(x)


def raw2outputs(
    raw: torch.Tensor,
    z_vals: torch.Tensor,
    rays_d: torch.Tensor,
    occupancy: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Composite per-sample predictions along rays.

    Args:
        raw: (R, S, 4) — rgb in [..., :3], occupancy logit (or density) in
            [..., 3].
        z_vals: (R, S) sample depths.
        rays_d: (R, 3) directions (their norm scales density-mode dists).
        occupancy: occupancy mode vs density mode.

    Returns:
        depth (R,), depth_var (R,), rgb (R, 3), weights (R, S).
    """
    rgb = raw[..., :3]
    if occupancy:
        alpha = torch.sigmoid(10.0 * raw[..., 3])
    else:
        dists = z_vals[..., 1:] - z_vals[..., :-1]
        dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
        dists = dists * torch.linalg.norm(rays_d[..., None, :], dim=-1)
        alpha = 1.0 - torch.exp(-torch.relu(raw[..., 3]) * dists)

    # exclusive transmittance: cumprod of (1 - alpha + 1e-10)
    trans = cumprod_positive(
        torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], dim=-1),
    )[..., :-1]
    weights = alpha * trans

    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * z_vals, dim=-1)
    tmp = z_vals - depth_map[..., None]
    depth_var = torch.sum(weights * tmp * tmp, dim=-1)
    return depth_map, depth_var, rgb_map, weights
