"""Ray generation, pixel sampling and hierarchical (PDF) sampling.

The port of the JAX package's ``ops/rays.py`` (ref: src/common.py:21-136,
254-272). The camera convention is OpenGL-style (-z forward): the ray
direction in the camera frame is [(i-cx)/fx, -(j-cy)/fy, -1].

Functions take an optional leading batch of frames: a (F, 3, 4) pose stack
with (F, N) pixel coordinates gives (F, N, 3) rays, the batched form of the
JAX package's per-frame ``vmap``.

Pixel draws are injectable: ``sample_pixels`` takes either ``pixel_idx``
(flat indices into the sampled region, as ``jax.random.randint(key, (n,),
0, h*w)`` gives them, ref: ops/rays.py:85) or a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def get_rays_from_uv(
    i: torch.Tensor,
    j: torch.Tensor,
    c2w: torch.Tensor,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixel coordinates -> world-space rays (ref: src/common.py:76-91).

    Args:
        i / j: (..., N) pixel column / row coordinates (float).
        c2w: (..., 3, 4) or (..., 4, 4) camera-to-world (differentiable —
            the tracker and BA backprop through it).

    Returns:
        rays_o, rays_d: (..., N, 3); directions are not normalized.
    """
    dirs = torch.stack([(i - cx) / fx, -(j - cy) / fy, -torch.ones_like(i)], dim=-1)
    R = c2w[..., :3, :3]
    # elementwise multiply-add, as the JAX package does (no matmul)
    rays_d = torch.sum(dirs.unsqueeze(-2) * R.unsqueeze(-3), dim=-1)
    rays_o = c2w[..., None, :3, 3].expand(rays_d.shape)
    return rays_o, rays_d


def get_rays_full_image(
    H: int, W: int, fx: float, fy: float, cx: float, cy: float, c2w: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rays for every pixel of an HxW image (ref: src/common.py:254-272).

    Returns:
        rays_o, rays_d: (H, W, 3).
    """
    dev = c2w.device
    jj, ii = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev),
        torch.arange(W, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    o, d = get_rays_from_uv(ii.reshape(-1), jj.reshape(-1), c2w, fx, fy, cx, cy)
    return o.reshape(H, W, 3), d.reshape(H, W, 3)


def sample_pixels(
    H0: int,
    H1: int,
    W0: int,
    W1: int,
    n: int,
    depth: torch.Tensor,
    color: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    pixel_idx: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sample n pixels uniformly with replacement from [H0:H1, W0:W1]
    (ref: src/common.py:94-124).

    Args:
        depth: (..., H, W); color: (..., H, W, 3).
        generator: draws ``(..., n)`` indices when ``pixel_idx`` is None.
        pixel_idx: (..., n) int64 flat indices in [0, (H1-H0)*(W1-W0)).

    Returns:
        i (..., n) cols, j (..., n) rows (float), depth (..., n),
        color (..., n, 3).
    """
    h, w = H1 - H0, W1 - W0
    W = depth.shape[-1]
    if pixel_idx is None:
        pixel_idx = torch.randint(
            0, h * w, depth.shape[:-2] + (n,), generator=generator, device=depth.device
        )
    idx = pixel_idx.to(depth.device, torch.int64)
    jj = idx // w + H0
    ii = idx % w + W0
    lin = jj * W + ii
    d = torch.gather(depth.flatten(-2), -1, lin)
    c = torch.gather(
        color.flatten(-3, -2), -2, lin[..., None].expand(lin.shape + (3,))
    )
    return ii.to(depth.dtype), jj.to(depth.dtype), d, c


def get_samples(
    H0: int,
    H1: int,
    W0: int,
    W1: int,
    n: int,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    c2w: torch.Tensor,
    depth: torch.Tensor,
    color: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    pixel_idx: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sample n rays from an image region (ref: src/common.py:127-136).

    Returns:
        rays_o (..., n, 3), rays_d (..., n, 3), gt_depth (..., n),
        gt_color (..., n, 3).
    """
    i, j, d, c = sample_pixels(H0, H1, W0, W1, n, depth, color, generator, pixel_idx)
    rays_o, rays_d = get_rays_from_uv(i, j, c2w, fx, fy, cx, cy)
    return rays_o, rays_d, d, c


def sample_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    N_samples: int,
    det: bool = False,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Hierarchical sampling by the inverse CDF (ref: src/common.py:21-65).

    Args:
        bins: (B, M) bin edges; weights: (B, M - 1), floored at 1e-5 before
            they are normalized (the reference's call: bins are the z
            midpoints, weights the interior sample weights).
        det: ``u`` on ``linspace(0, 1, N_samples)``; else uniform draws
            from ``generator``, or the (B, N_samples) draws ``u`` given.

    Returns:
        (B, N_samples) resampled positions. ``u`` = 0 or 1 sits on the
        CDF's ends, where cumsum's rounding may move the bin index but not
        the sample.
    """
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1).contiguous()  # (B, M)
    shape = cdf.shape[:-1] + (N_samples,)
    if det:
        u = torch.linspace(0.0, 1.0, N_samples, dtype=cdf.dtype, device=cdf.device).expand(shape).contiguous()
    elif u is None:
        u = torch.rand(shape, generator=generator, dtype=cdf.dtype, device=cdf.device)

    inds = torch.searchsorted(cdf, u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    last_bin = bins.shape[-1] - 1
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, torch.clamp(below, max=last_bin))
    bins_above = torch.gather(bins, -1, torch.clamp(above, max=last_bin))
    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def ray_bound_intersection(
    rays_o: torch.Tensor, rays_d: torch.Tensor, bound: torch.Tensor
) -> torch.Tensor:
    """Distance along each ray to the exit of the axis-aligned bound
    (ref: src/utils/Renderer.py:148-155): min over axes of the max of the
    two slab distances. Degenerate rays give inf/negative values, as in
    the reference; callers clamp.

    Args:
        rays_o / rays_d: (..., 3); bound: (3, 2).

    Returns:
        (...,) exit distances.
    """
    t = (bound - rays_o[..., None]) / rays_d[..., None]  # (..., 3, 2)
    return torch.amin(torch.amax(t, dim=-1), dim=-1)
