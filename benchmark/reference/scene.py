"""The plain reference of the scene query and volume rendering.

Plain float32 PyTorch, written from the DF-Prior method (NICE-SLAM's
renderer with the attentive depth-fusion prior) and frozen here: it imports
nothing of the program, and the comparison that decides ``correct`` holds
the program to it. Inputs are the scene tree (grids (X, Y, Z, C) channels
last; decoders as {"B", "pts", "fc_c", "out"} with linears {"w": (in, out),
"b"}; the attention MLP {"layers", "out"}), world points and the TSDF prior.

Conventions of the system that the reference keeps, because they define
its outputs: OpenGL cameras (-z forward), pixel draws as flat indices into
the sampled region, 32 stratified samples from 0.01 d to min(bound exit +
0.01, 1.2 x the batch's largest depth) plus 16 in [0.95 d, 1.05 d], grids
sampled trilinearly with aligned corners and border clamping, occupancy
alpha = sigmoid(10 occ) with an opaque wall (occ 100) outside the bound.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch


def rays_from_pixels(i, j, c2w, cam) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixel columns ``i`` and rows ``j`` (..., N) -> world rays (..., N, 3)
    through ``c2w`` (..., 3 or 4, 4)."""
    dirs = torch.stack([(i - cam["cx"]) / cam["fx"], -(j - cam["cy"]) / cam["fy"], -torch.ones_like(i)], dim=-1)
    R = c2w[..., :3, :3]
    rays_d = (dirs.unsqueeze(-2) * R.unsqueeze(-3)).sum(-1)
    rays_o = c2w[..., None, :3, 3].expand(rays_d.shape)
    return rays_o, rays_d


def bound_exit(rays_o, rays_d, bound) -> torch.Tensor:
    """Distance to where each ray leaves the axis-aligned ``bound``."""
    t = (bound - rays_o[..., None]) / rays_d[..., None]
    return t.max(dim=-1).values.min(dim=-1).values


def sample_depths(rays_o, rays_d, depth, bound, n_samples: int, n_surface: int, depth_max=None):
    """Sorted sample depths (R, n_samples + n_surface) along each ray."""
    far_bb = bound_exit(rays_o.detach(), rays_d.detach(), bound) + 0.01  # no gradient to the pose
    dmax = depth.max() if depth_max is None else depth_max
    far = torch.minimum(far_bb.clamp(min=0.0), dmax * 1.2)[:, None]
    near = (depth * 0.01)[:, None]
    t = torch.linspace(0.0, 1.0, n_samples, device=depth.device)
    z = near * (1.0 - t) + far * t
    ts = torch.linspace(0.0, 1.0, n_surface, device=depth.device)
    d = depth[:, None]
    surf = torch.where(d > 0, 0.95 * d * (1.0 - ts) + 1.05 * d * ts, (0.001 * (1.0 - ts) + dmax * ts)[None, :])
    return torch.cat([z, surf], dim=-1).sort(dim=-1).values


def _cell(p_norm, dims):
    n = torch.tensor([float(d) for d in dims], device=p_norm.device)
    x = ((p_norm + 1.0) * 0.5 * (n - 1.0)).clamp(min=0.0)
    x = torch.minimum(x, n - 1.0)
    top = torch.tensor([d - 1 for d in dims], device=p_norm.device)
    i0 = torch.minimum(x.floor().long(), top)
    i1 = torch.minimum(i0 + 1, top)
    return i0, i1, x - i0.float()


def normalize(p, bound):
    return (p - bound[:, 0]) / (bound[:, 1] - bound[:, 0]) * 2.0 - 1.0


def grid_sample(grid: torch.Tensor, p: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of a channels-last grid (X, Y, Z, C) at world points
    (N, 3): (N, C); the gradient reaches the grid by autograd of the
    gathers."""
    X, Y, Z, C = grid.shape
    i0, i1, f = _cell(normalize(p, bound), (X, Y, Z))
    flat = grid.reshape(-1, C)
    out = 0.0
    for cx in (0, 1):
        ix, wx = (i0[:, 0], 1 - f[:, 0]) if cx == 0 else (i1[:, 0], f[:, 0])
        for cy in (0, 1):
            iy, wy = (i0[:, 1], 1 - f[:, 1]) if cy == 0 else (i1[:, 1], f[:, 1])
            for cz in (0, 1):
                iz, wz = (i0[:, 2], 1 - f[:, 2]) if cz == 0 else (i1[:, 2], f[:, 2])
                out = out + flat[(ix * Y + iy) * Z + iz] * (wx * wy * wz)[:, None]
    return out


def prior_sample(vol: torch.Tensor, p: torch.Tensor, bnds: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of the TSDF prior (X, Y, Z) at world points: (N,)."""
    return grid_sample(vol[..., None], p, bnds)[:, 0]


def decoder(dec: Dict[str, Any], p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """A grid-conditioned decoder: sin(p B) through 5 ReLU blocks of 32, each
    plus a linear of the feature, the embedding joined after the third;
    (N,) occupancy or (N, 4) colour and occupancy."""
    B = dec["B"]
    e = torch.sin(p[:, 0:1] * B[0] + p[:, 1:2] * B[1] + p[:, 2:3] * B[2])
    h = e
    for i, (lp, lc) in enumerate(zip(dec["pts"], dec["fc_c"])):
        h = torch.relu(h @ lp["w"] + lp["b"]) + (c @ lc["w"] + lc["b"])
        if i == 2:
            h = torch.cat([e, h], dim=-1)
    out = h @ dec["out"]["w"] + dec["out"]["b"]
    return out[:, 0] if out.shape[-1] == 1 else out


def prior_logit(tsdf: torch.Tensor) -> torch.Tensor:
    """The prior's TSDF as an occupancy logit, clamped to +-100."""
    t = (1.0 - (tsdf + 1.0) / 2.0).clamp(0.0, 1.0)
    return (-0.1 * torch.log(1.0 / (t + 1e-8) - 1.0 + 1e-7)).clamp(-100.0, 100.0)


def attention(mlp: Dict[str, Any], occ: torch.Tensor, prior: torch.Tensor):
    """The attention blend of the learned and the prior occupancy: (blend,
    the prior's weight)."""
    x = torch.stack([occ, prior], dim=-1)
    h = x
    for layer in mlp["layers"]:
        h = torch.relu(h @ layer["w"] + layer["b"])
    w = torch.softmax(h @ mlp["out"]["w"] + mlp["out"]["b"], dim=-1)
    return (w * x).sum(-1), w[:, 1]


def query(scene, p, tsdf, bnds, bound, stage: str):
    """The scene at world points p (N, 3) for a stage: raw (N, 4) [rgb,
    occ] and the attention weight (N,). Low: the low decoder alone. High:
    low + high occupancy (the high decoder reads its grid's feature and the
    low feature held constant), blended with the prior where the prior is
    not saturated. Colour: that occupancy and the colour decoder's rgb."""
    n = p.shape[0]
    c_low = grid_sample(scene["grid_low"], p, bound)
    low = decoder(scene["low"], p, c_low)
    if stage == "low":
        return torch.cat([torch.zeros((n, 3), device=p.device), low[:, None]], dim=-1), torch.ones_like(low)
    c_high = torch.cat([grid_sample(scene["grid_high"], p, bound), c_low.detach()], dim=-1)
    high = decoder(scene["high"], p, c_high)
    tsdf_val = prior_sample(tsdf, p, bnds)
    blend, att = attention(scene["mlp"], high + low, prior_logit(tsdf_val))
    live = (tsdf_val > -1.0 + 1e-4) & (tsdf_val < 1.0 - 1e-4)
    occ = torch.where(live, blend, low)
    w = torch.where(live, att, torch.ones_like(att))
    if stage == "high":
        return torch.cat([torch.zeros((n, 3), device=p.device), occ[:, None]], dim=-1), w
    rgb = decoder(scene["color"], p, grid_sample(scene["grid_color"], p, bound))[:, :3]
    return torch.cat([rgb, occ[:, None]], dim=-1), w


def composite(raw, z):
    """Occupancy compositing: depth, depth variance, colour (R,)."""
    alpha = torch.sigmoid(10.0 * raw[..., 3])
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-10], dim=-1), dim=-1)[:, :-1]
    w = alpha * trans
    depth = (w * z).sum(-1)
    var = (w * (z - depth[:, None]) ** 2).sum(-1)
    return depth, var, (w[..., None] * raw[..., :3]).sum(-2)


def render_rays(scene, rays_o, rays_d, depth, tsdf, bnds, bound, stage: str, rcfg: Dict[str, Any],
                depth_max: Optional[torch.Tensor] = None):
    """Render rays (R, 3) with sensor depth (R,): depth, variance, colour
    and the attention weights (R, S)."""
    z = sample_depths(rays_o, rays_d, depth, bound, int(rcfg["N_samples"]), int(rcfg["N_surface"]), depth_max)
    R, S = z.shape
    pts = (rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]).reshape(-1, 3)
    raw, att = query(scene, pts, tsdf, bnds, bound, stage)
    inside = ((pts > bound[:, 0]) & (pts < bound[:, 1])).all(-1)
    raw = torch.cat([raw[:, :3], torch.where(inside, raw[:, 3], torch.full_like(raw[:, 3], 100.0))[:, None]], -1)
    d, v, c = composite(raw.reshape(R, S, 4), z)
    return d, v, c, att.reshape(R, S)


@torch.no_grad()
def render_image(scene, c2w, depth_img, tsdf, bnds, bound, cam, rcfg, chunk: int):
    """A full frame rendered as the system's renderer defines it: every
    pixel's ray, in consecutive chunks of ``chunk`` rays, each chunk's far
    plane from its own largest depth. Returns depth (H, W), colour (H, W, 3)."""
    H, W = cam["H"], cam["W"]
    dev = depth_img.device
    jj, ii = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    ro, rd = rays_from_pixels(ii.reshape(-1), jj.reshape(-1), c2w, cam)
    gd = depth_img.reshape(-1)
    depth = torch.empty_like(gd)
    color = torch.empty((gd.shape[0], 3), device=dev)
    for a in range(0, gd.shape[0], chunk):
        b = min(a + chunk, gd.shape[0])
        d, _, c, _ = render_rays(scene, ro[a:b], rd[a:b], gd[a:b], tsdf, bnds, bound, "color", rcfg)
        depth[a:b], color[a:b] = d, c
    return depth.reshape(H, W), color.reshape(H, W, 3)
