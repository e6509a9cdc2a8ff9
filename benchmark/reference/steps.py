"""The plain reference of one mapping iteration, one tracking iteration and
the lazy Adam step, as DF-Prior (after NICE-SLAM) defines them.

Mapping: draw pixels in every window frame, render them at the window's
poses, take the depth L1 over rays with depth inside the bound (and the
colour L1 in the colour stage, weighted ``w_color_loss``), differentiate
every scene leaf, mask the grids' gradients to the current frame's frustum,
and step each leaf by Adam at its stage's rate. Tracking: draw pixels
inside the frame's margins, render at the camera tensor [qw, qx, qy, qz,
tx, ty, tz], take the depth error over the rendered deviation (rays whose
error is under ten times the median), plus the colour L1, differentiate the
camera tensor alone, step it by Adam. Adam is lazy per leaf: a leaf whose
gradient is zero everywhere, or that has none, does not step; a leaf with a
gradient steps its counter even at rate 0.

Nothing here imports the program. Pixel draws come from a
``torch.Generator`` in the state the benchmark hands both sides, drawn with
the same call as the system draws them (``torch.randint`` over the flat
region, one call an iteration).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from benchmark.reference.scene import bound_exit, render_rays, rays_from_pixels

B1, B2, EPS = 0.9, 0.999, 1e-8


@contextlib.contextmanager
def precision(tf32: bool):
    """Matrix products in plain float32 (TF32 off), or in TF32 for the
    control; restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def leaves(tree: Any, path: Tuple = ()) -> List[Tuple[str, torch.Tensor]]:
    """(name, leaf) of every leaf of a tree of dicts and lists, dict keys
    sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], path + (str(k),))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in leaves(v, path + (str(i),))]
    return [("/".join(path), tree)]


def rebuild(tree: Any, values: List[torch.Tensor]) -> Any:
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [build(v) for v in t]
        return next(it)

    return build(tree)


# ---------------------------------------------------------------- poses


def quat_to_rotation(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    s = 2.0 / (q * q).sum(-1)
    return torch.stack([
        torch.stack([1 - s * (y * y + z * z), s * (x * y - z * w), s * (x * z + y * w)], -1),
        torch.stack([s * (x * y + z * w), 1 - s * (x * x + z * z), s * (y * z - x * w)], -1),
        torch.stack([s * (x * z - y * w), s * (y * z + x * w), 1 - s * (x * x + y * y)], -1),
    ], -2)


def pose_matrix(t: torch.Tensor) -> torch.Tensor:
    """Camera tensor (7,) -> (3, 4) camera-to-world."""
    return torch.cat([quat_to_rotation(t[:4]), t[4:, None]], dim=1)


def pose_tensor(c2w: np.ndarray) -> np.ndarray:
    """(4, 4) camera-to-world -> camera tensor [qw, qx, qy, qz, tx, ty, tz]
    (float64 arithmetic, Shepperd's rule, w >= 0), float32."""
    R = np.asarray(c2w, dtype=np.float64)[:3, :3]
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s]
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        q = [(R[2, 1] - R[1, 2]) / s, 0.25 * s, (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s]
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        q = [(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s, 0.25 * s, (R[1, 2] + R[2, 1]) / s]
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        q = [(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s, (R[1, 2] + R[2, 1]) / s, 0.25 * s]
    q = np.array(q)
    q = (-q if q[0] < 0 else q) / np.linalg.norm(q)
    return np.concatenate([q, np.asarray(c2w, dtype=np.float64)[:3, 3]]).astype(np.float32)


def constant_speed(poses: np.ndarray, idx: int) -> np.ndarray:
    """The tracker's start at frame ``idx``: the last motion applied again."""
    pre, prepre = poses[idx - 1], poses[idx - 2]
    return ((pre @ np.linalg.inv(prepre)) @ pre).astype(np.float32)


# ---------------------------------------------------------------- frustum


def _bilinear_zero_border(img: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    H, W = img.shape
    u = np.clip(np.nan_to_num(u, nan=-1e9, posinf=1e9, neginf=-1e9), -2.0, W + 1.0)
    v = np.clip(np.nan_to_num(v, nan=-1e9, posinf=1e9, neginf=-1e9), -2.0, H + 1.0)
    u0, v0 = np.floor(u).astype(np.int64), np.floor(v).astype(np.int64)
    du, dv = (u - u0).astype(np.float64), (v - v0).astype(np.float64)
    out = np.zeros(u.shape, dtype=np.float64)
    for iu, iv, w in ((u0, v0, (1 - du) * (1 - dv)), (u0 + 1, v0, du * (1 - dv)),
                      (u0, v0 + 1, (1 - du) * dv), (u0 + 1, v0 + 1, du * dv)):
        ok = (iu >= 0) & (iu < W) & (iv >= 0) & (iv < H)
        out += w * np.where(ok, img[np.clip(iv, 0, H - 1), np.clip(iu, 0, W - 1)], 0.0)
    return out.astype(np.float32)


def frustum_mask(c2w: np.ndarray, dims: Tuple[int, int, int], bound: np.ndarray, depth: np.ndarray,
                 cam: Dict[str, Any]) -> np.ndarray:
    """Cells (lattice points spanning the bound) that the frame sees: in the
    image, in front of the camera and no deeper than the sampled depth +
    0.5 m (a depth of 0 reads as the frame's largest), or within 0.5 m of
    the camera. (X, Y, Z) bool."""
    axes = [np.linspace(bound[i][0], bound[i][1], dims[i]) for i in range(3)]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    w2c = np.linalg.inv(c2w.astype(np.float64))
    cc = (w2c @ np.concatenate([pts, np.ones((len(pts), 1))], 1).T).T[:, :3]
    cc[:, 0] *= -1
    K = np.array([[cam["fx"], 0.0, cam["cx"]], [0.0, cam["fy"], cam["cy"]], [0.0, 0.0, 1.0]])
    uv = (K @ cc.T).T
    z = uv[:, 2:3] + 1e-5
    uv = (uv[:, :2] / z).astype(np.float32)
    d = _bilinear_zero_border(np.asarray(depth, np.float32), uv[:, 0], uv[:, 1]).reshape(-1, 1)
    m = (uv[:, 0] < cam["W"]) & (uv[:, 0] > 0) & (uv[:, 1] < cam["H"]) & (uv[:, 1] > 0)
    if (d == 0).any():
        d[d == 0] = d.max()
    m = m & (0 <= -z[:, 0]) & (-z[:, 0] <= d[:, 0] + 0.5)
    m = m | (((pts - c2w[:3, 3]) ** 2).sum(1) < 0.25)
    return m.reshape(dims)


# ---------------------------------------------------------------- Adam


def adam(params: List[torch.Tensor], grads: List[Optional[torch.Tensor]], state: Dict[str, list],
         lrs: List[float]) -> None:
    """One lazy Adam step in place (``state``: per-leaf step, m, v)."""
    with torch.no_grad():
        for i, (p, g, lr) in enumerate(zip(params, grads, lrs)):
            if g is None or not bool((g != 0).any()):
                continue
            state["step"][i] += 1
            m = state["m"][i] = B1 * state["m"][i] + (1 - B1) * g
            v = state["v"][i] = B2 * state["v"][i] + (1 - B2) * g * g
            t = state["step"][i]
            p -= lr * (m / (1 - B1 ** t)) / (torch.sqrt(v / (1 - B2 ** t)) + EPS)


def adam_state(params: List[torch.Tensor]) -> Dict[str, list]:
    return {"step": [0] * len(params), "m": [torch.zeros_like(p) for p in params],
            "v": [torch.zeros_like(p) for p in params]}


# ---------------------------------------------------------------- mapping


def stage_rates(names: List[str], stage_cfg: Dict[str, float], fix_high: bool, fix_color: bool,
                factor: float) -> List[float]:
    """Each leaf's rate in a stage: the grids' own, the attention MLP's, the
    decoders' for the high (unless fixed) and colour (unless fixed)
    decoders, none for the low decoder."""
    top = {"grid_low": stage_cfg["low_lr"], "grid_high": stage_cfg["high_lr"], "grid_color": stage_cfg["color_lr"],
           "mlp": stage_cfg["mlp_lr"], "low": 0.0, "high": 0.0 if fix_high else stage_cfg["decoders_lr"],
           "color": 0.0 if fix_color else stage_cfg["decoders_lr"]}
    return [float(top[n.split("/")[0]]) * factor for n in names]


def mapping_loss(scene, colors, depths, c2ws, draws, tsdf, bnds, bound, stage, cam, rcfg, w_color,
                 batch: Optional[slice] = None):
    """The loss of one drawn batch: ``draws`` (F, n) flat pixel indices in
    each window frame. ``batch``: the rays kept (a fault that leaves rays
    out keeps a slice and scales to the mean)."""
    W = cam["W"]
    jj, ii = draws // W, draws % W
    gd = torch.gather(depths.flatten(-2), -1, draws)
    gc = torch.gather(colors.flatten(-3, -2), -2, draws[..., None].expand(draws.shape + (3,)))
    ro, rd = rays_from_pixels(ii.float(), jj.float(), c2ws, cam)
    ro, rd, gd, gc = ro.reshape(-1, 3), rd.reshape(-1, 3), gd.reshape(-1), gc.reshape(-1, 3)
    scale = 1.0
    if batch is not None:
        scale = ro.shape[0] / len(range(*batch.indices(ro.shape[0])))
        ro, rd, gd, gc = ro[batch], rd[batch], gd[batch], gc[batch]
    inside = bound_exit(ro, rd, bound) >= gd
    depth, _, color, _ = render_rays(scene, ro, rd, gd, tsdf, bnds, bound, stage, rcfg)
    loss = (torch.abs(gd - depth) * ((gd > 0) & inside)).sum()
    if stage == "color":
        loss = loss + w_color * (torch.abs(gc - color) * inside[:, None]).sum()
    return loss * scale


def stage_schedule(iters: int, low_ratio: float, high_ratio: float) -> List[Tuple[str, int]]:
    """A mapped frame's stages and their iterations: iteration ``i`` is in
    the low stage while ``i <= int(iters x low_ratio)``, then in the high
    stage while ``i <= int(iters x high_ratio)``, then in the colour stage."""
    lo, hi = int(iters * low_ratio), int(iters * high_ratio)
    spans = [("low", min(lo, iters - 1) + 1)]
    if hi > lo:
        spans.append(("high", min(hi, iters - 1) - lo))
    if iters - 1 > hi:
        spans.append(("color", iters - 1 - hi))
    return [(stage, n) for stage, n in spans if n > 0]


def mapping_call(scene0, window, masks, gen: torch.Generator, schedule: List[Tuple[str, int]],
                 rates: Dict[str, List[float]], tsdf, bnds, bound, cam, rcfg, w_color, pixels_per_frame: int,
                 batch=None) -> Dict[str, Any]:
    """A mapped frame's iterations from ``scene0`` (left as it is) on
    ``window`` (colors, depths, c2ws as (F, 4, 4)): ``schedule``'s stages
    one after another under one Adam state, each leaf at its stage's rate
    (``rates``), the grids' gradients masked by ``masks`` {grid name:
    (X, Y, Z) bool}. Returns each stage's per-step losses, each leaf's
    gradient at each stage's first step, and each leaf's change after the
    call."""
    colors, depths, c2ws = window
    names, values = zip(*leaves(scene0))
    params = [v.detach().clone().requires_grad_(True) for v in values]
    state = adam_state(params)
    F, H, W = depths.shape
    out: Dict[str, Any] = {"loss": {}, "grad": {}}
    for stage, n in schedule:
        out["loss"][stage] = []
        for it in range(n):
            draws = torch.randint(0, H * W, (F, pixels_per_frame), generator=gen, device=depths.device)
            scene = rebuild(scene0, params)
            loss = mapping_loss(scene, colors, depths, c2ws, draws, tsdf, bnds, bound, stage, cam, rcfg, w_color,
                                batch)
            grads = list(torch.autograd.grad(loss, params, allow_unused=True))
            for i, name in enumerate(names):
                key = name.split("/")[0]
                if key in masks and grads[i] is not None:
                    grads[i] = grads[i] * masks[key][..., None].to(grads[i].dtype)
            if it == 0:
                out["grad"][stage] = {nm: (0.0 if g is None else float(g.norm())) for nm, g in zip(names, grads)}
            adam(params, grads, state, rates[stage])
            out["loss"][stage].append(float(loss.detach()))
    out["change"] = {nm: float((p.detach() - v).norm()) for nm, p, v in zip(names, params, values)}
    return out


def mapping_steps(scene0, window, masks, gen: torch.Generator, n: int, stage: str, rates: List[float],
                  tsdf, bnds, bound, cam, rcfg, w_color, pixels_per_frame: int, batch=None) -> Dict[str, Any]:
    """``n`` mapping iterations of ``stage`` alone, from a fresh Adam state:
    the per-step losses, each leaf's first gradient as Adam takes it, and
    each leaf's change after the ``n`` steps."""
    out = mapping_call(scene0, window, masks, gen, [(stage, n)], {stage: rates}, tsdf, bnds, bound, cam, rcfg,
                       w_color, pixels_per_frame, batch)
    return {"loss": out["loss"][stage], "grad": out["grad"][stage], "change": out["change"]}


# ---------------------------------------------------------------- tracking


def tracking_loss(t, scene, color, depth, draws, tsdf, bnds, bound, cam, rcfg, edge_w: int, edge_h: int,
                  w_color: float, batch: Optional[slice] = None):
    H, W = depth.shape
    w = W - 2 * edge_w
    jj, ii = draws // w + edge_h, draws % w + edge_w
    lin = jj * W + ii
    gd, gc = depth.reshape(-1)[lin], color.reshape(-1, 3)[lin]
    ro, rd = rays_from_pixels(ii.float(), jj.float(), pose_matrix(t), cam)
    scale = 1.0
    if batch is not None:
        scale = ro.shape[0] / len(range(*batch.indices(ro.shape[0])))
        ro, rd, gd, gc = ro[batch], rd[batch], gd[batch], gc[batch]
    inside = bound_exit(ro.detach(), rd.detach(), bound) >= gd
    d, var, c, _ = render_rays(scene, ro, rd, gd, tsdf, bnds, bound, "color", rcfg)
    err = torch.abs(gd - d) / torch.sqrt(var.detach() + 1e-10)
    e = err.detach()[inside].sort().values
    med = e[(e.numel() - 1) // 2] if e.numel() else torch.tensor(float("inf"), device=e.device)
    mask = (gd > 0) & inside & (err < 10 * med)
    loss = (err * mask).sum() + w_color * (torch.abs(gc - c) * mask[:, None]).sum()
    return loss * scale


def tracking_steps(scene, t0: np.ndarray, color, depth, gen: torch.Generator, n: int, lr: float, tsdf, bnds,
                   bound, cam, rcfg, pixels: int, edge_w: int, edge_h: int, w_color: float,
                   batch=None) -> Dict[str, Any]:
    """``n`` tracking iterations from camera tensor ``t0``: the per-step
    losses, the first gradient's norm, and the tensor after each step."""
    H, W = depth.shape
    t = torch.as_tensor(t0, device=depth.device).clone().requires_grad_(True)
    state = adam_state([t])
    out: Dict[str, Any] = {"loss": [], "tensors": []}
    for it in range(n):
        draws = torch.randint(0, (H - 2 * edge_h) * (W - 2 * edge_w), (pixels,), generator=gen, device=depth.device)
        loss = tracking_loss(t, scene, color, depth, draws, tsdf, bnds, bound, cam, rcfg, edge_w, edge_h,
                             w_color, batch)
        (g,) = torch.autograd.grad(loss, [t])
        if it == 0:
            out["grad"] = float(g.norm())
        adam([t], [g], state, [lr])
        out["loss"].append(float(loss.detach()))
        out["tensors"].append(t.detach().cpu().numpy().copy())
    return out


def tracking_call(scene, t0: np.ndarray, color, depth, gen: torch.Generator, iters: int, lr: float, tsdf, bnds,
                  bound, cam, rcfg, pixels: int, edge_w: int, edge_h: int, w_color: float,
                  batch=None) -> np.ndarray:
    """A tracked frame: ``iters`` steps from ``t0``, and the kept candidate,
    the tensor after the step whose loss (at the tensor before it) was the
    lowest, the first of equals, as a (4, 4) camera-to-world."""
    out = tracking_steps(scene, t0, color, depth, gen, iters, lr, tsdf, bnds, bound, cam, rcfg, pixels, edge_w,
                         edge_h, w_color, batch)
    best = out["tensors"][int(np.argmin(out["loss"]))]
    c2w = np.eye(4)
    c2w[:3, :] = pose_matrix(torch.as_tensor(best, dtype=torch.float64)).numpy()
    return c2w
