"""Tracker: per-frame camera pose optimization by differentiable rendering.

The port of the JAX package's ``slam/tracker.py`` (ref:
src/Tracker.py:20-274). Per iteration: draw pixels, render at the current
pose, take the robust depth (+ color) loss, differentiate the 7-DoF camera
tensor only, take an Adam step, and keep the best candidate. The scene is
read detached, so no grid gradient (and no K1 launch) is ever computed
while tracking.

The JAX package compiles a tracked frame into one ``lax.scan`` (ref:
slam/tracker.py:120, 239). Here the iteration is one ``StepGraph``
(``utils/step_graph.py``): on the card it is captured once and replayed
for every iteration of every frame, with the camera tensor, its Adam
state, the best loss and candidate, the frame and the learning rates in
static buffers; eagerly it runs the same step.

Under ray-axis data parallelism (``parallel/sharding.py``) every rank
draws the whole batch and renders its block. Two quantities are global, or
the ranks would keep different poses: the dynamic-pixel cut's median over
every in-bound ray's error (gathered), and the loss that picks the best
candidate (summed over the group with the 7-DoF gradient). On an NCCL
group the graph holds both collectives, as the JAX package's compiled
frame does (ref: slam/tracker.py:119-135, 239).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from attentive_dfprior_tpu_torch.camera import Camera
from attentive_dfprior_tpu_torch.ops.adam import adam_init, adam_reset, adam_update
from attentive_dfprior_tpu_torch.ops.pose import (
    homogenize,
    pose_matrix_from_tensor,
    pose_tensor_from_matrix,
)
from attentive_dfprior_tpu_torch.ops.rays import get_samples, ray_bound_intersection
from attentive_dfprior_tpu_torch.render.renderer import RenderConfig, render_rays
from attentive_dfprior_tpu_torch.utils.profiling import span
from attentive_dfprior_tpu_torch.utils.step_graph import StaticScalars, StepGraphs, resolve_step_mode, tensor_key


def masked_lower_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of ``values[mask]`` with torch.median's convention (the lower
    middle element for an even count), +inf for an empty mask."""
    cnt = torch.sum(mask.to(torch.int64))
    sorted_vals = torch.sort(torch.where(mask, values, torch.full_like(values, float("inf")))).values
    k = torch.clamp(cnt - 1, min=0) // 2
    kth = sorted_vals.index_select(0, k.reshape(1))[0]  # no host sync
    return torch.where(cnt > 0, kth, torch.full_like(kth, float("inf")))


def tracking_loss_fn(
    camera_tensor: torch.Tensor,
    params: Any,
    color_im: torch.Tensor,
    depth_im: torch.Tensor,
    tsdf_volume: torch.Tensor,
    tsdf_bnds: torch.Tensor,
    bound: torch.Tensor,
    cam: Camera,
    rcfg: RenderConfig,
    batch_size: int,
    ignore_edge_W: int,
    ignore_edge_H: int,
    handle_dynamic: bool,
    use_color: bool,
    w_color_loss: float,
    generator: Optional[torch.Generator] = None,
    pixel_idx: Optional[torch.Tensor] = None,
    grid_vjp: str = "halo",
    shards=None,
) -> torch.Tensor:
    """One tracking iteration's loss (ref: src/Tracker.py:75-134): the
    variance-normalized depth L1 over valid in-bound rays with the dynamic
    pixel cut (err < 10 x median), plus color L1.

    With ``shards`` (``parallel.sharding.RayShards``) the loss of this
    process's blocks of the batch: the far plane takes the whole batch's
    max depth and the median every block's errors (gathered over the
    group); the caller sums the loss over the group."""
    c2w = pose_matrix_from_tensor(camera_tensor)
    H, W = cam.H, cam.W
    ro, rd, gd, gc = get_samples(
        ignore_edge_H, H - ignore_edge_H, ignore_edge_W, W - ignore_edge_W,
        batch_size, cam.fx, cam.fy, cam.cx, cam.cy, c2w, depth_im, color_im,
        generator, pixel_idx,
    )
    inside = ray_bound_intersection(ro.detach(), rd.detach(), bound) >= gd
    blocks, dmax = shards.local_blocks(gd) if shards is not None else ([slice(None)], None)
    errs, colors = [], []
    for sl in blocks:
        depth, var, color, _ = render_rays(
            params, ro[sl], rd[sl], gd[sl], tsdf_volume, tsdf_bnds, bound, "color", rcfg, grid_vjp=grid_vjp,
            depth_max=dmax,
        )
        errs.append(torch.abs(gd[sl] - depth) / torch.sqrt(var.detach() + 1e-10))
        colors.append(color)
    if handle_dynamic:
        if shards is None:
            med = masked_lower_median(errs[0].detach(), inside)
        else:
            # the median of every in-bound ray's error, all blocks gathered
            parts = [torch.stack([e.detach(), inside[sl].to(e.dtype)], dim=-1) for e, sl in zip(errs, blocks)]
            full = shards.gather_rays(parts, ro.shape[0])
            med = masked_lower_median(full[:, 0], full[:, 1] > 0)
    loss = 0.0
    for sl, err, color in zip(blocks, errs, colors):
        mask = (gd[sl] > 0) & inside[sl]
        if handle_dynamic:
            mask = mask & (err < 10 * med)
        loss = loss + torch.sum(err * mask)
        if use_color:
            loss = loss + w_color_loss * torch.sum(torch.abs(gc[sl] - color) * mask[:, None])
    return loss


def track_frame(
    params: Any,
    init_camera_tensor: torch.Tensor,
    color_im: torch.Tensor,
    depth_im: torch.Tensor,
    tsdf_volume: torch.Tensor,
    tsdf_bnds: torch.Tensor,
    bound: torch.Tensor,
    cam: Camera,
    rcfg: RenderConfig,
    batch_size: int,
    n_iters: int,
    ignore_edge_W: int,
    ignore_edge_H: int,
    handle_dynamic: bool,
    use_color: bool,
    w_color_loss: float,
    cam_lr: float,
    seperate_LR: bool = False,
    lr_final_factor: float = 1.0,
    generator: Optional[torch.Generator] = None,
    pixel_idx: Optional[torch.Tensor] = None,
    grid_vjp: str = "halo",
    adam_lazy: bool = True,
    shards=None,
    graphs: Optional[StepGraphs] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Optimize the camera tensor for one frame; return the best candidate.

    The kept candidate is the post-step tensor whose pre-step loss was the
    lowest (ref: Tracker.py:239-261). ``seperate_LR`` gives the quaternion
    0.2x the translation rate (ref: Tracker.py:213-224).
    ``lr_final_factor`` < 1 keeps the full rate for the first half of the
    iterations and decays it exponentially to ``cam_lr * lr_final_factor``
    over the second half.

    Args:
        pixel_idx: optional (n_iters, batch_size) replayed pixel draws,
            copied into a static buffer before each iteration.
        grid_vjp: the feature grids' gradient variant (the scene is read
            detached, so only its point gradient runs); adam_lazy: Adam's
            per-leaf lazy rule.
        shards: the dp group (``tracking_loss_fn``); loss and gradient are
            summed over it in one all-reduce, so every rank keeps the same
            best candidate.
        graphs: the agent's ``StepGraphs``: the frame's program (one
            iteration, replayed as a CUDA graph in ``graph`` mode) is cached
            there by the scene's buffers (``StepGraphs.scene``), the prior's
            and the options; None runs the step eagerly.

    Returns:
        best tensor (7,), losses (n_iters,), final tensor (7,), pre-step
        tensors (n_iters, 7).
    """
    with span("Tracker.inputs"):  # the frame into the program's static buffers
        init = init_camera_tensor.detach().to(torch.float32)
        dev = init.device
        if graphs is None:
            graphs = StepGraphs("eager", dev)
        scene = graphs.scene(params)
        names = ("quad", "T") if seperate_LR else ("cam",)
        replayed = pixel_idx is not None
        key = ("track", names, tuple(color_im.shape), cam.H, cam.W, cam.fx, cam.fy, cam.cx, cam.cy, rcfg, batch_size,
               ignore_edge_W, ignore_edge_H, handle_dynamic, use_color, float(w_color_loss), grid_vjp, adam_lazy,
               replayed, None if replayed else generator, id(shards),
               tensor_key(scene, tsdf_volume, tsdf_bnds, bound))

        def make():
            sizes = {"quad": 4, "T": 3, "cam": 7}
            cams = {n: torch.zeros((sizes[n],), dtype=torch.float32, device=dev).requires_grad_(True) for n in names}
            adam = adam_init(cams)
            scalars = StaticScalars(len(names), dev)
            lr_tree = {n: scalars.values[i] for i, n in enumerate(names)}
            color = torch.zeros(color_im.shape, dtype=torch.float32, device=dev)
            depth = torch.zeros(depth_im.shape, dtype=torch.float32, device=dev)
            pix = torch.zeros((batch_size,), dtype=torch.int64, device=dev) if replayed else None
            best_loss = torch.zeros((), dtype=torch.float32, device=dev)
            best = torch.zeros((7,), dtype=torch.float32, device=dev)
            out = torch.zeros((8,), dtype=torch.float32, device=dev)  # the loss, then the pre-step tensor

            def assemble():
                return torch.cat([cams["quad"], cams["T"]]) if seperate_LR else cams["cam"]

            def step() -> None:
                leaves = list(cams.values())
                loss = tracking_loss_fn(
                    assemble(), scene, color, depth, tsdf_volume, tsdf_bnds, bound, cam, rcfg, batch_size,
                    ignore_edge_W, ignore_edge_H, handle_dynamic, use_color, w_color_loss, generator, pix,
                    grid_vjp, shards,
                )
                grads = list(torch.autograd.grad(loss, leaves))
                if shards is not None:
                    reduced = shards.all_reduce([loss.detach().reshape(1)] + grads)
                    loss, grads = reduced[0][0], reduced[1:]
                with torch.no_grad():
                    out[1:].copy_(assemble())
                    adam_update(cams, dict(zip(cams, grads)), adam, lr_tree, lazy=adam_lazy)
                    value = loss.detach()
                    better = value < best_loss
                    best_loss.copy_(torch.where(better, value, best_loss))
                    best.copy_(torch.where(better, assemble(), best))
                    out[0].copy_(value)

            graph = graphs.step_graph(step, () if replayed else (generator,), list(cams.values()), shards)
            return cams, adam, scalars, color, depth, pix, best_loss, best, out, assemble, graph

        cams, adam, scalars, color, depth, pix, best_loss, best, out, assemble, graph = graphs.program(key, make)
        with torch.no_grad():
            if seperate_LR:
                cams["quad"].copy_(init[:4])
                cams["T"].copy_(init[4:])
            else:
                cams["cam"].copy_(init)
            adam_reset(adam)
            best_loss.fill_(float("inf"))
            best.copy_(init)
            color.copy_(color_im)
            depth.copy_(depth_im)
        base = [cam_lr * 0.2, cam_lr] if seperate_LR else [cam_lr]
        if lr_final_factor < 1.0 and n_iters > 1:
            i = torch.arange(n_iters, dtype=torch.float32)
            half = n_iters / 2.0
            t = torch.clamp((i - half) / max(n_iters - 1 - half, 1.0), 0.0, 1.0)
            lr_scales = torch.pow(torch.tensor(lr_final_factor, dtype=torch.float32), t).tolist()
        else:
            lr_scales = [1.0] * n_iters
        record = torch.zeros((n_iters, 8), dtype=torch.float32, device=dev)
    for it in range(n_iters):
        if replayed:
            pix.copy_(pixel_idx[it])
        scalars.set_all([lr * lr_scales[it] for lr in base])
        graph()
        record[it] = out
    with torch.no_grad():
        final = assemble().clone()
    return best.clone(), record[:, 0], final, record[:, 1:]


class Tracker:
    """Host-side tracking agent (ref: src/Tracker.py:150-274); ``grid_vjp``,
    ``adam_lazy`` and ``shards`` (the dp group) as in ``track_frame``.
    ``step_mode``: ``graph`` replays a frame's iteration as a CUDA graph,
    ``eager`` runs it (by default ``graph`` on a CUDA device unless
    ``shards``' group is on gloo; on NCCL the graph holds the all-reduce
    and the gathered median). ``concurrent``: the async modes, where the
    tracker reads published snapshots: its graphs read a static scene of
    its own that each new snapshot is copied into (``StepGraphs.scene``),
    and the final refine replays them too."""

    def __init__(
        self,
        cfg: Dict[str, Any],
        cam: Camera,
        rcfg: RenderConfig,
        bound: np.ndarray,
        tsdf_volume: torch.Tensor,
        tsdf_bnds: np.ndarray,
        device: torch.device,
        grid_vjp: str = "halo",
        adam_lazy: bool = True,
        shards=None,
        step_mode: Optional[str] = None,
        concurrent: bool = False,
    ):
        t = cfg["tracking"]
        self.shards = shards
        group = shards.group if shards is not None else None
        self.step_mode = resolve_step_mode(step_mode, device, group)
        self.graphs = StepGraphs(self.step_mode, device, concurrent=concurrent, copy_scene=concurrent, group=group)
        self.grid_vjp = grid_vjp
        self.adam_lazy = adam_lazy
        self.cam = cam
        self.rcfg = rcfg
        self.device = torch.device(device)
        self.bound = torch.as_tensor(np.asarray(bound), dtype=torch.float32, device=self.device)
        self.tsdf_volume = tsdf_volume
        self.tsdf_bnds = torch.as_tensor(np.asarray(tsdf_bnds), dtype=torch.float32, device=self.device)
        self.cam_lr = float(t["lr"])
        self.num_cam_iters = int(t["iters"])
        self.gt_camera = bool(t["gt_camera"])
        self.tracking_pixels = int(t["pixels"])
        self.w_color_loss = float(t["w_color_loss"])
        self.ignore_edge_W = int(t["ignore_edge_W"])
        self.ignore_edge_H = int(t["ignore_edge_H"])
        self.handle_dynamic = bool(t["handle_dynamic"])
        self.use_color = bool(t["use_color_in_tracking"])
        self.const_speed = bool(t["const_speed_assumption"])
        self.seperate_LR = bool(t.get("seperate_LR", False))
        self.lr_final_factor = float(t.get("lr_final_factor", 1.0))

    def initial_pose(self, idx: int, estimate_c2w_list: np.ndarray) -> np.ndarray:
        """Constant-speed motion model init (ref: Tracker.py:203-209)."""
        pre_c2w = estimate_c2w_list[idx - 1]
        if self.const_speed and idx - 2 >= 0:
            prepre = estimate_c2w_list[idx - 2]
            delta = pre_c2w @ np.linalg.inv(prepre)
            return (delta @ pre_c2w).astype(np.float32)
        return pre_c2w.astype(np.float32)

    def track(
        self,
        params: Any,
        idx: int,
        color_im: torch.Tensor,
        depth_im: torch.Tensor,
        gt_c2w: np.ndarray,
        estimate_c2w_list: np.ndarray,
        generator: Optional[torch.Generator] = None,
        pixel_idx: Optional[torch.Tensor] = None,
        visualizer=None,
    ) -> Tuple[np.ndarray, float]:
        """Track one frame; returns (estimated c2w 4x4, last-iteration loss).

        The returned loss is the LAST iteration's while the pose is the
        min-loss candidate, as in the reference (ref: src/Tracker.py:239,
        255-261). With ``visualizer``, on frames its ``freq`` selects, the
        reference's inside-iteration panels (ref: src/Tracker.py:241-243)
        are rendered afterwards at the pre-step poses of every
        ``inside_freq``-th iteration: the scene is frozen while tracking, so
        that is the render the reference makes inside the loop.
        """
        with span("Tracker.track", frame=idx):
            if idx == 0 or self.gt_camera:
                return gt_c2w.astype(np.float32), 0.0
            init_c2w = self.initial_pose(idx, estimate_c2w_list)
            cam_tensor = torch.as_tensor(pose_tensor_from_matrix(init_c2w), device=self.device)
            best, losses, _, iter_tensors = track_frame(
                params, cam_tensor, color_im, depth_im, self.tsdf_volume,
                self.tsdf_bnds, self.bound, self.cam, self.rcfg,
                self.tracking_pixels, self.num_cam_iters, self.ignore_edge_W,
                self.ignore_edge_H, self.handle_dynamic, self.use_color,
                self.w_color_loss, self.cam_lr, self.seperate_LR,
                self.lr_final_factor, generator, pixel_idx, self.grid_vjp, self.adam_lazy, self.shards,
                graphs=self.graphs,
            )
            if visualizer is not None and idx % visualizer.freq == 0:
                for it in range(0, self.num_cam_iters, visualizer.inside_freq):
                    visualizer.vis(idx, it, depth_im, color_im, iter_tensors[it], params, self.tsdf_volume)
            with span("Tracker.pose_to_host"), torch.no_grad():  # waits for the device
                c2w = homogenize(pose_matrix_from_tensor(best)).cpu().numpy()
                loss = float(losses[-1])
            return c2w.astype(np.float32), loss
