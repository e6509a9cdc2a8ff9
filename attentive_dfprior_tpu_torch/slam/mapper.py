"""Mapper: keyframe-window optimization of the scene representation.

The port of the JAX package's ``slam/mapper.py`` (ref: src/Mapper.py:15-605).
Each mapped frame gets a fresh per-leaf Adam state and runs the staged
low -> high -> color schedule. Per iteration: draw pixels in every window
frame, build rays, render, take the depth (+ color) L1 loss, differentiate
every scene leaf, mask the grid gradients to the current frustum, and take
one lazy Adam step in place.

The JAX package compiles each stage into one ``lax.scan`` (ref:
slam/mapper.py:109-123, 307). Here the iteration is one ``StepGraph``
(``utils/step_graph.py``): on the card it is captured once as a CUDA graph
and replayed for the stage's iterations, with the frames, the frustum
masks, BA's window poses, the Adam state, the learning rates and the
regularizer's weight in static buffers; eagerly it runs the same step.

Every scene leaf requires grad in every stage, as the JAX mapper
differentiates every leaf and routes the stage through the learning rates:
a leaf outside a stage's loss graph gets no gradient and Adam leaves it
untouched (ops/adam.py).

With ``mapping.BA`` (keyframe bundle adjustment) the window poses are
optimized with the scene, anchored at one frozen window keyframe.

Under ray-axis data parallelism (``parallel/sharding.py``) every rank draws
the same whole batch, renders its block, and the gradients (BA's pose
gradient with them) are summed over the group before the masks and Adam;
on an NCCL group the graph holds that all-reduce, as the JAX package's
compiled step holds its psum (ref: slam/mapper.py:236-241, 284-287).
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from attentive_dfprior_tpu_torch.camera import Camera
from attentive_dfprior_tpu_torch.models.scene import SceneConfig
from attentive_dfprior_tpu_torch.ops.adam import AdamState, adam_update
from attentive_dfprior_tpu_torch.ops.cuda import frustum_kernel
from attentive_dfprior_tpu_torch.ops.pose import pose_matrix_from_tensor, pose_tensor_from_matrix
from attentive_dfprior_tpu_torch.ops.rays import get_samples, ray_bound_intersection
from attentive_dfprior_tpu_torch.render.renderer import RenderConfig, render_rays
from attentive_dfprior_tpu_torch.utils.profiling import span
from attentive_dfprior_tpu_torch.utils.step_graph import StaticScalars, StepGraphs, resolve_step_mode, tensor_key
from attentive_dfprior_tpu_torch.utils.tree import tree_leaves, tree_map

GRID_KEYS = ("grid_low", "grid_high", "grid_color")
# a mapping step's device scalars: the learning rates of build_lr_tree's
# groups, BA's pose rate, then the regularizer's weight
LR_SLOT = {"high": 0, "color": 1, "mlp": 2, "grid_low": 3, "grid_high": 4, "grid_color": 5, "low": 6}
POSE_SLOT, W_REG_SLOT, N_SLOTS = 7, 8, 9


class StageLRs(NamedTuple):
    """Per-stage learning rates (ref: configs/df_prior.yaml:65-83)."""

    decoders: float
    mlp: float
    low: float
    high: float
    color: float


def build_lr_tree(params: Any, lrs: StageLRs, fix_high: bool, fix_color: bool) -> Any:
    """Per-leaf learning rates for the reference's 5 optimizer groups
    (ref: src/Mapper.py:364-401). The low decoder never trains; the high and
    color decoders follow the fix flags."""
    top = {
        "grid_low": lrs.low,
        "grid_high": lrs.high,
        "grid_color": lrs.color,
        "mlp": lrs.mlp,
        "low": 0.0,
        "high": 0.0 if fix_high else lrs.decoders,
        "color": 0.0 if fix_color else lrs.decoders,
    }
    return {k: tree_map(lambda _, lr=top[k]: lr, v) for k, v in params.items()}


def lr_slot_values(lrs: StageLRs, fix_high: bool, fix_color: bool, ba_cam_lr: float) -> List[float]:
    """``build_lr_tree``'s rates by ``LR_SLOT``, then BA's pose rate."""
    return [0.0 if fix_high else lrs.decoders, 0.0 if fix_color else lrs.decoders, lrs.mlp, lrs.low, lrs.high,
            lrs.color, 0.0, ba_cam_lr]


def lr_tree_of(params: Any, values: torch.Tensor, ba: bool) -> Any:
    """``build_lr_tree``'s per-leaf rates as 0-d views of the device vector
    ``values`` (``LR_SLOT``; with ``ba`` the pose's at ``POSE_SLOT``)."""
    scene = params["scene"] if ba else params
    tree = {k: tree_map(lambda _, i=LR_SLOT[k]: values[i], v) for k, v in scene.items()}
    return {"scene": tree, "pose": values[POSE_SLOT]} if ba else tree


def mapping_loss_fn(
    params: Any,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    gt_depth: torch.Tensor,
    gt_color: torch.Tensor,
    inside_mask: torch.Tensor,
    tsdf_volume: torch.Tensor,
    tsdf_bnds: torch.Tensor,
    bound: torch.Tensor,
    stage: str,
    rcfg: RenderConfig,
    w_color_loss: float,
    w_reg: float,
    grid_vjp: str = "halo",
    depth_max: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mapping loss (ref: src/Mapper.py:451-469): depth L1 over valid in-bound
    rays, the |attention weight - 1| warm-up regularizer (weight ``w_reg``),
    and color L1 in the color stage. ``depth_max``: the whole batch's max
    depth when these rays are one block of it (``render_rays``)."""
    depth, _, color, att_w = render_rays(
        params, rays_o, rays_d, gt_depth, tsdf_volume, tsdf_bnds, bound, stage, rcfg,
        grid_vjp=grid_vjp, depth_max=depth_max,
    )
    depth_mask = (gt_depth > 0) & inside_mask
    loss = torch.sum(torch.abs(gt_depth - depth) * depth_mask)
    loss = loss + w_reg * torch.sum(torch.abs(att_w - 1.0) * inside_mask[:, None])
    if stage == "color":
        loss = loss + w_color_loss * torch.sum(torch.abs(gt_color - color) * inside_mask[:, None])
    return loss


def mapping_grads(
    params: Any,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    gt_depth: torch.Tensor,
    gt_color: torch.Tensor,
    inside_mask: torch.Tensor,
    tsdf_volume: torch.Tensor,
    tsdf_bnds: torch.Tensor,
    bound: torch.Tensor,
    stage: str,
    rcfg: RenderConfig,
    w_color_loss: float,
    w_reg: float = 0.0,
    accum: int = 1,
    ba: bool = False,
    grid_vjp: str = "halo",
    shards=None,
) -> Tuple[torch.Tensor, List[Optional[torch.Tensor]]]:
    """The loss of one drawn ray batch (``inside_mask``: its in-bound rays)
    and its gradient for every leaf of ``params`` (None where a leaf is
    outside the stage's graph).

    With ``shards`` (``parallel.sharding.RayShards``) only the blocks it
    names are rendered (the far plane from the whole batch's max depth),
    and loss and gradients are summed over its group in one all-reduce; a
    ``RayShards`` with no group gives one rank's part as it is.

    Returns (loss, gradients in leaf order of ``params``); the loss is
    scaled 1/``accum``."""
    scene = params["scene"] if ba else params
    blocks, dmax = shards.local_blocks(gt_depth) if shards is not None else ([slice(None)], None)
    loss = 0.0
    for sl in blocks:
        loss = loss + mapping_loss_fn(
            scene, rays_o[sl], rays_d[sl], gt_depth[sl], gt_color[sl], inside_mask[sl], tsdf_volume, tsdf_bnds,
            bound, stage, rcfg, w_color_loss, w_reg, grid_vjp, depth_max=dmax,
        )
    if accum != 1:
        loss = loss / accum
    grads = list(torch.autograd.grad(loss, tree_leaves(params), allow_unused=True))
    if shards is None:
        return loss.detach(), grads
    # one all-reduce of loss and gradients; the lazy Adam picks the touched
    # leaves from the reduced gradient, so the replicas stay equal
    reduced = shards.all_reduce([loss.detach().reshape(1)] + grads)
    return reduced[0][0], reduced[1:]


def mapping_step(
    params: Any,
    adam_state: Any,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    gt_depth: torch.Tensor,
    gt_color: torch.Tensor,
    inside_mask: torch.Tensor,
    tsdf_volume: torch.Tensor,
    tsdf_bnds: torch.Tensor,
    bound: torch.Tensor,
    lr_tree: Any,
    stage: str,
    rcfg: RenderConfig,
    w_color_loss: float,
    w_reg: float = 0.0,
    frustum_masks: Optional[Dict[str, torch.Tensor]] = None,
    accum: int = 1,
    ba: bool = False,
    pose_mask: Optional[torch.Tensor] = None,
    grid_vjp: str = "halo",
    adam_lazy: bool = True,
    shards=None,
) -> torch.Tensor:
    """One mapping iteration on a drawn ray batch, in place on ``params``
    and ``adam_state``: ``mapping_grads`` (reduced over ``shards``' group),
    the frustum and BA-anchor masks, one lazy Adam step. Returns the loss."""
    loss, grads = mapping_grads(
        params, rays_o, rays_d, gt_depth, gt_color, inside_mask, tsdf_volume, tsdf_bnds, bound, stage, rcfg,
        w_color_loss, w_reg, accum, ba, grid_vjp, shards,
    )
    grads = _mask_grads(params, grads, ba, pose_mask, frustum_masks)
    adam_update(params, grads, adam_state, lr_tree, lazy=adam_lazy)
    return loss


def mapping_stage(
    params: Any,
    adam_state: Any,
    frames_color: torch.Tensor,  # (F, H, W, 3)
    frames_depth: torch.Tensor,  # (F, H, W)
    frames_c2w: torch.Tensor,  # (F, 4, 4)
    frustum_masks: Optional[Dict[str, torch.Tensor]],
    tsdf_volume: torch.Tensor,
    tsdf_bnds: torch.Tensor,
    bound: torch.Tensor,
    n_iters: int,
    w_reg_flags: List[float],
    lrs: StageLRs,
    stage: str,
    pixs_per_image: int,
    cam: Camera,
    rcfg: RenderConfig,
    fix_flags: Tuple[bool, bool],
    w_color_loss: float,
    generator: Optional[torch.Generator] = None,
    pixel_idx: Optional[torch.Tensor] = None,
    accum: int = 1,
    ba: bool = False,
    pose_mask: Optional[torch.Tensor] = None,
    ba_cam_lr: float = 0.0,
    grid_vjp: str = "halo",
    adam_lazy: bool = True,
    shards=None,
    graphs: Optional[StepGraphs] = None,
) -> torch.Tensor:
    """Run one optimization stage of ``n_iters`` iterations in place on
    ``params`` and ``adam_state`` (ref: slam/mapper.py:125-310).

    Args:
        params: scene tree, or with ``ba`` {"scene": scene tree, "pose":
            (F, 7) window pose tensors}; every leaf requires grad.
        frustum_masks: {grid key: (nx, ny, nz, 1) float} gradient masks.
        w_reg_flags: per-iteration weight of the attention regularizer.
        generator: draws the pixels when ``pixel_idx`` is None.
        pixel_idx: (n_iters, F, pixs_per_image * accum) flat pixel indices
            (replayed draws; the tests feed the JAX package's), copied into
            a static buffer before each iteration.
        accum: k-fold larger ray batch per Adam step, loss scaled 1/k.
        ba: optimize the window poses too; ``pose_mask`` (F,) zeroes the
            anchor's pose gradient; ``ba_cam_lr`` is the poses' rate.
        grid_vjp: the feature grids' gradient variant
            (``ops/grid_sample.py:GRID_VJPS``).
        adam_lazy: Adam's per-leaf lazy rule (``ops/adam.py``); False steps
            every leaf.
        shards: ``parallel.sharding.RayShards``: render the blocks it names
            of the whole drawn batch (the far plane from the whole batch's
            max depth) and sum loss and gradients over its group, one
            all-reduce per iteration, before the masks and Adam; None runs
            the whole batch here.
        graphs: the agent's ``StepGraphs``: the stage's program (one
            iteration, replayed as a CUDA graph in ``graph`` mode) is cached
            there by the data pointers of every tensor above, so a caller
            that keeps them at fixed addresses replays one capture; None
            runs the step eagerly.

    Returns:
        (n_iters,) per-iteration losses (the whole batch's under ``shards``).
    """
    dev = frames_depth.device
    if graphs is None:
        graphs = StepGraphs("eager", dev)
    fix_high, fix_color = fix_flags
    H, W = cam.H, cam.W
    n_draw = pixs_per_image * accum
    replayed = pixel_idx is not None
    key = ("map", stage, H, W, cam.fx, cam.fy, cam.cx, cam.cy, n_draw, accum, ba, rcfg, float(w_color_loss),
           grid_vjp, adam_lazy, replayed, None if replayed else generator, id(shards),
           tensor_key(params, adam_state, frames_color, frames_depth, frames_c2w, frustum_masks, tsdf_volume,
                      tsdf_bnds, bound, pose_mask))

    def make():
        scalars = StaticScalars(N_SLOTS, dev)
        lr_tree = lr_tree_of(params, scalars.values, ba)
        pix = torch.zeros(tuple(frames_depth.shape[:-2]) + (n_draw,), dtype=torch.int64, device=dev) if replayed else None
        loss_out = torch.zeros((), dtype=torch.float32, device=dev)

        def step() -> None:
            c2ws = pose_matrix_from_tensor(params["pose"]) if ba else frames_c2w  # (F, 3, 4) under BA
            ro, rd, gd, gc = get_samples(
                0, H, 0, W, n_draw, cam.fx, cam.fy, cam.cx, cam.cy, c2ws,
                frames_depth, frames_color, generator, pix,
            )
            ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
            gd, gc = gd.reshape(-1), gc.reshape(-1, 3)
            # in-bound ray mask (ref: Mapper.py:438-449), as loss weights
            inside = ray_bound_intersection(ro.detach(), rd.detach(), bound) >= gd
            loss_out.copy_(mapping_step(
                params, adam_state, ro, rd, gd, gc, inside, tsdf_volume, tsdf_bnds, bound, lr_tree, stage, rcfg,
                w_color_loss, scalars.values[W_REG_SLOT], frustum_masks, accum, ba, pose_mask, grid_vjp,
                adam_lazy, shards,
            ))

        graph = graphs.step_graph(step, () if replayed else (generator,), tree_leaves(params), shards)
        return scalars, pix, loss_out, graph

    scalars, pix, loss_out, graph = graphs.program(key, make)
    scalars.set_all(lr_slot_values(lrs, fix_high, fix_color, ba_cam_lr))
    losses = torch.zeros((n_iters,), dtype=torch.float32, device=dev)
    for it in range(n_iters):
        if replayed:
            pix.copy_(pixel_idx[it])
        scalars.set(W_REG_SLOT, w_reg_flags[it])
        graph()
        losses[it] = loss_out
    return losses


def _mask_grads(params, grads, ba, pose_mask, frustum_masks):
    """Frustum masks on the grid gradients, the BA anchor mask on the pose
    gradient (``grads`` in leaf order of ``params``)."""
    slot = {id(t): i for i, t in enumerate(tree_leaves(params))}
    scene = params["scene"] if ba else params
    masks = dict(frustum_masks or {})
    if ba:
        i = slot[id(params["pose"])]
        if grads[i] is not None:
            grads[i] = grads[i] * pose_mask[:, None]
    for k, mask in masks.items():
        i = slot[id(scene[k])]
        if grads[i] is not None:
            grads[i] = grads[i] * mask
    return grads


def _bilinear_sample_border0(img: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Bilinear sample ``img`` at float pixel coords (u, v), zero outside
    (cv2.remap INTER_LINEAR / BORDER_CONSTANT semantics, no row limit)."""
    H, W = img.shape
    u = np.nan_to_num(u, nan=-1e9, posinf=1e9, neginf=-1e9)
    v = np.nan_to_num(v, nan=-1e9, posinf=1e9, neginf=-1e9)
    u = np.clip(u, -2.0, W + 1.0)
    v = np.clip(v, -2.0, H + 1.0)
    u0 = np.floor(u).astype(np.int64)
    v0 = np.floor(v).astype(np.int64)
    du = (u - u0).astype(np.float64)
    dv = (v - v0).astype(np.float64)
    out = np.zeros(u.shape, dtype=np.float64)
    for iu, iv, w in (
        (u0, v0, (1 - du) * (1 - dv)),
        (u0 + 1, v0, du * (1 - dv)),
        (u0, v0 + 1, (1 - du) * dv),
        (u0 + 1, v0 + 1, du * dv),
    ):
        valid = (iu >= 0) & (iu < W) & (iv >= 0) & (iv < H)
        val = np.where(valid, img[np.clip(iv, 0, H - 1), np.clip(iu, 0, W - 1)], 0.0)
        out += w * val
    return out.astype(np.float32)


def get_frustum_mask(
    c2w: np.ndarray,
    grid_shape_xyz: Tuple[int, int, int],
    bound: np.ndarray,
    depth_np: np.ndarray,
    cam: Camera,
) -> np.ndarray:
    """Frustum + depth-test voxel mask for one grid, host-side
    (ref: src/Mapper.py:90-158): voxel centres on the bound lattice that
    project inside the image, in front of the camera and within (sampled
    depth + 0.5 m); voxels within 0.5 m of the camera centre are always
    kept. Zero depth readings count as the frame's max depth.

    Returns:
        (nx, ny, nz) bool mask.
    """
    nx, ny, nz = grid_shape_xyz
    X, Y, Z = np.meshgrid(
        np.linspace(bound[0][0], bound[0][1], nx),
        np.linspace(bound[1][0], bound[1][1], ny),
        np.linspace(bound[2][0], bound[2][1], nz),
        indexing="ij",
    )
    points = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    w2c = np.linalg.inv(c2w.astype(np.float64))
    homo = np.concatenate([points, np.ones((len(points), 1))], axis=1)
    cam_cord = (w2c @ homo.T).T[:, :3]
    cam_cord[:, 0] *= -1
    uv = (cam.K @ cam_cord.T).T
    z = uv[:, 2:3] + 1e-5
    uv = (uv[:, :2] / z).astype(np.float32)
    depths = _bilinear_sample_border0(
        np.asarray(depth_np, dtype=np.float32), uv[:, 0], uv[:, 1]
    ).reshape(-1, 1)
    mask = (uv[:, 0] < cam.W) & (uv[:, 0] > 0) & (uv[:, 1] < cam.H) & (uv[:, 1] > 0)
    zero = depths == 0
    if zero.any():
        depths[zero] = depths.max()
    mask = mask & (0 <= -z[:, 0]) & (-z[:, 0] <= depths[:, 0] + 0.5)
    dist2 = np.sum((points - c2w[:3, 3]) ** 2, axis=1)
    mask = mask | (dist2 < 0.25)
    return mask.reshape(nx, ny, nz)


class Mapper:
    """Host-side mapping agent driving the stage loops; ``grid_vjp``,
    ``adam_lazy`` and ``shards`` (the dp group) as in ``mapping_stage``.
    ``step_mode`` (``utils/step_graph.py:resolve_step_mode``): ``graph``
    replays each stage's iteration as a CUDA graph, ``eager`` runs it; by
    default ``graph`` on a CUDA device unless ``shards``' group is on gloo
    (an NCCL group's all-reduce is captured with the step). ``concurrent``:
    another agent runs on another thread (the async modes). ``graphs``
    holds this agent's programs, static buffers and memory pool; loop
    closure's relaxation, which runs on the mapper's thread, replays its
    tracking graphs there too."""

    def __init__(
        self,
        cfg: Dict[str, Any],
        cam: Camera,
        scene_cfg: SceneConfig,
        rcfg: RenderConfig,
        tsdf_volume: torch.Tensor,
        tsdf_bnds: np.ndarray,
        device: torch.device,
        grid_vjp: str = "halo",
        adam_lazy: bool = True,
        shards=None,
        step_mode: Optional[str] = None,
        concurrent: bool = False,
    ):
        m = cfg["mapping"]
        self.shards = shards
        group = shards.group if shards is not None else None
        self.step_mode = resolve_step_mode(step_mode, device, group)
        self.graphs = StepGraphs(self.step_mode, device, concurrent=concurrent, group=group)
        self.grid_vjp = grid_vjp
        self.adam_lazy = adam_lazy
        self.cfg = cfg
        self.cam = cam
        self.scene_cfg = scene_cfg
        self.rcfg = rcfg
        self.device = torch.device(device)
        self.tsdf_volume = tsdf_volume
        self.tsdf_bnds = torch.as_tensor(np.asarray(tsdf_bnds), dtype=torch.float32, device=self.device)
        self.bound = torch.as_tensor(scene_cfg.bound, dtype=torch.float32, device=self.device)

        self.mapping_pixels = int(m["pixels"])
        self.num_joint_iters = int(m["iters"])
        self.iters_first = int(m["iters_first"])
        self.lr_factor = float(m["lr_factor"])
        self.lr_first_factor = float(m["lr_first_factor"])
        self.low_iter_ratio = float(m["low_iter_ratio"])
        self.high_iter_ratio = float(m["high_iter_ratio"])
        self.mapping_window_size = int(m["mapping_window_size"])
        self.w_color_loss = float(m["w_color_loss"])
        self.frustum_feature_selection = bool(m["frustum_feature_selection"])
        self.accum = int(cfg.get("parallel", {}).get("accum", 1))
        if self.accum < 1:
            raise ValueError(f"parallel.accum must be >= 1, got {self.accum}")
        self.ba = bool(m.get("BA", False))
        if self.ba and bool(cfg.get("tracking", {}).get("gt_camera", False)):
            # BA write-backs would perturb the ground-truth poses
            print("[mapper] mapping.BA disabled: tracking.gt_camera is set")
            self.ba = False
        self.ba_cam_lr = float(m.get("ba_cam_lr", 1e-3))
        self.keyframe_selection_method = m.get("keyframe_selection_method", "overlap")
        self.stage_lrs = {
            s: StageLRs(
                decoders=float(m["stage"][s]["decoders_lr"]),
                mlp=float(m["stage"][s]["mlp_lr"]),
                low=float(m["stage"][s]["low_lr"]),
                high=float(m["stage"][s]["high_lr"]),
                color=float(m["stage"][s]["color_lr"]),
            )
            for s in ("low", "high", "color")
        }

    def _stage_schedule(
        self,
        num_joint_iters: int,
        low_iter_ratio: Optional[float] = None,
        high_iter_ratio: Optional[float] = None,
    ) -> List[Tuple[str, int, int]]:
        """[(stage, start_iter, end_iter)] (ref: Mapper.py:390-395)."""
        if low_iter_ratio is None:
            low_iter_ratio = self.low_iter_ratio
        if high_iter_ratio is None:
            high_iter_ratio = self.high_iter_ratio
        lo_end = int(num_joint_iters * low_iter_ratio)
        hi_end = int(num_joint_iters * high_iter_ratio)
        spans = []
        if lo_end >= 0:
            spans.append(("low", 0, min(lo_end, num_joint_iters - 1)))
        if hi_end > lo_end:
            spans.append(("high", lo_end + 1, min(hi_end, num_joint_iters - 1)))
        if num_joint_iters - 1 > hi_end:
            spans.append(("color", hi_end + 1, num_joint_iters - 1))
        return [(st, s, e) for st, s, e in spans if e >= s]

    def _frustum_masks(self, params: Any, depth_np: np.ndarray, c2w_np: np.ndarray) -> Dict[str, torch.Tensor]:
        """The grids' frustum masks of the frame at ``c2w_np`` with depth
        ``depth_np``, in this agent's static buffers ({grid key: (nx, ny,
        nz, 1) float32}), so the stage programs of every frame read the
        same addresses. The route follows the mapper's device: on the card
        K6 (``ops/cuda/frustum_kernel.py``) writes them straight into the
        buffers from the depth copied into a static buffer of its own;
        elsewhere ``get_frustum_mask`` computes them in numpy."""
        g = self.graphs
        shapes = [tuple(params[k].shape[:3]) for k in GRID_KEYS]
        bound = np.asarray(self.scene_cfg.bound)
        if self.device.type != "cuda":
            with span("Mapper.frustum_masks", route="numpy"):
                return {k: g.static(("frustum", k), torch.as_tensor(
                    get_frustum_mask(c2w_np, s, bound, depth_np, self.cam)[..., None], dtype=torch.float32))
                        for k, s in zip(GRID_KEYS, shapes)}
        with span("Mapper.frustum_masks", route="cuda"):
            depth = g.static("frustum_depth", torch.from_numpy(np.require(depth_np, np.float32, ["C", "W"])))
            outs = [g.buffer(("frustum", k), (*s, 1), torch.float32) for k, s in zip(GRID_KEYS, shapes)]
            frustum_kernel.frustum_masks(frustum_kernel.pack(c2w_np, shapes, bound, self.cam), depth, outs)
            return dict(zip(GRID_KEYS, outs))

    def optimize_map(
        self,
        params: Any,
        num_joint_iters: int,
        lr_factor: float,
        idx: int,
        frames_color: torch.Tensor,
        frames_depth: torch.Tensor,
        frames_c2w: np.ndarray,
        generator: Optional[torch.Generator] = None,
        cur_depth_np: Optional[np.ndarray] = None,
        cur_c2w_np: Optional[np.ndarray] = None,
        color_refine: bool = False,
        ba_anchor: int = 0,
        pixel_idx: Optional[Dict[str, torch.Tensor]] = None,
        visualizer=None,
        cur_color_np: Optional[np.ndarray] = None,
    ) -> Tuple[Any, Dict[str, float], Optional[np.ndarray], Dict[str, torch.Tensor]]:
        """One mapped frame: fresh Adam state and the staged loops
        (ref: src/Mapper.py:262-484), in place on ``params``. The window,
        the frustum masks, BA's poses and the Adam state are copied into
        (or zeroed in) this agent's static buffers first.

        Args:
            frames_color/depth/c2w: the optimization window (selected
                keyframes + current frame; F frames).
            color_refine: final-frame color-only refinement
                (ref: src/Mapper.py:532-539).
            pixel_idx: optional {stage: (n_iters, F, n) flat pixel indices}
                replacing the generator's draws.
            visualizer: on frames its ``freq`` selects (with
                ``cur_depth_np`` and ``cur_color_np`` given), a panel of the
                current frame at ``cur_c2w_np`` is rendered from the current
                scene at the top of every joint iteration that is a multiple
                of its ``inside_freq`` (ref: src/Mapper.py:403-405). The
                stage loops run in chunks between those iterations with one
                Adam state and one draw stream, and the render draws nothing
                and takes no gradient, so the optimization is the same
                bit for bit.

        Returns:
            (params, {stage: last-iteration loss}, refined window c2w
             (F, 4, 4) when BA ran else None, {stage: per-iteration losses}).
        """
        with span("Mapper.optimize_map", frame=idx):
            F = frames_color.shape[0]
            pixs_per_image = self.mapping_pixels // F
            low_ratio = 0.0 if color_refine else None
            high_ratio = 0.0 if color_refine else None
            fix_color = True if color_refine else self.scene_cfg.fix_color
            use_frustum = self.frustum_feature_selection and not color_refine

            frustum_masks = None
            if use_frustum and cur_depth_np is not None:
                frustum_masks = self._frustum_masks(params, cur_depth_np, cur_c2w_np)

            with span("Mapper.window"):
                for t in tree_leaves(params):
                    t.requires_grad_(True)
                # the window in static buffers (one set per window size F), so
                # the stage programs of every frame read the same addresses
                g = self.graphs
                frames_color = g.static(("color", F), frames_color)
                frames_depth = g.static(("depth", F), frames_depth)
                frames_c2w_t = g.static(("c2w", F), torch.as_tensor(np.asarray(frames_c2w), dtype=torch.float32,
                                                                    device=self.device))
                ba_on = self.ba and not color_refine and F >= 3
                scene_state = g.adam("scene", params)  # zeroed: a fresh state for this frame
                if ba_on:
                    pose_t0 = g.static(("pose", F), torch.as_tensor(
                        np.stack([pose_tensor_from_matrix(np.asarray(frames_c2w[i])) for i in range(F)]),
                        dtype=torch.float32, device=self.device,
                    ), requires_grad=True)
                    pose_mask = g.static(("pose_mask", F), torch.ones((F,), dtype=torch.float32, device=self.device))
                    pose_mask[int(ba_anchor)] = 0.0  # gauge anchor
                    opt = {"scene": params, "pose": pose_t0}
                    pose_state = g.adam(("pose", F), pose_t0)
                    adam_state = AdamState(*({"scene": a, "pose": b} for a, b in zip(scene_state, pose_state)))
                else:
                    pose_mask = None
                    opt = params
                    adam_state = scene_state

            vis_this_frame = (
                visualizer is not None
                and cur_depth_np is not None
                and cur_color_np is not None
                and idx % visualizer.freq == 0
            )
            losses: Dict[str, float] = {}
            stage_losses: Dict[str, torch.Tensor] = {}
            for stage, s, e in self._stage_schedule(num_joint_iters, low_ratio, high_ratio):
                n = e - s + 1
                with span("Mapper.stage", stage=stage, iterations=n):
                    eff_low = self.low_iter_ratio if low_ratio is None else low_ratio
                    lo_end = int(num_joint_iters * eff_low)
                    # warm-up attention regularizer iterations (ref: Mapper.py:459-461)
                    w_flags = [1.0 if (idx <= 1 and lo_end < (s + i) <= lo_end + 5) else 0.0 for i in range(n)]
                    lrs = StageLRs(*[v * lr_factor for v in self.stage_lrs[stage]])
                    # chunk starts: the panel iterations inside the stage
                    starts = [0]
                    if vis_this_frame:
                        starts += [a for a in range(1, n) if (s + a) % visualizer.inside_freq == 0]
                    chunks = []
                    for a, b in zip(starts, starts[1:] + [n]):
                        if vis_this_frame and (s + a) % visualizer.inside_freq == 0:
                            visualizer.vis(idx, s + a, cur_depth_np, cur_color_np, cur_c2w_np, params,
                                           self.tsdf_volume)
                        chunks.append(mapping_stage(
                            opt, adam_state, frames_color, frames_depth, frames_c2w_t,
                            frustum_masks, self.tsdf_volume, self.tsdf_bnds, self.bound,
                            b - a, w_flags[a:b], lrs, stage, pixs_per_image, self.cam, self.rcfg,
                            (self.scene_cfg.fix_high, fix_color), self.w_color_loss,
                            generator=generator,
                            pixel_idx=None if pixel_idx is None else pixel_idx[stage][a:b],
                            accum=self.accum, ba=ba_on, pose_mask=pose_mask,
                            ba_cam_lr=self.ba_cam_lr, grid_vjp=self.grid_vjp,
                            adam_lazy=self.adam_lazy, shards=self.shards, graphs=self.graphs,
                        ))
                    stage_losses[stage] = torch.cat(chunks)
            with span("Mapper.losses_to_host"):  # waits for the device
                for stage, ls in stage_losses.items():
                    losses[stage] = float(ls[-1])
                if ba_on:
                    with torch.no_grad():
                        mats34 = pose_matrix_from_tensor(opt["pose"]).cpu().numpy()
            if ba_on:
                refined = np.tile(np.eye(4, dtype=np.float32), (F, 1, 1))
                refined[:, :3, :] = mats34
                return params, losses, refined, stage_losses
            return params, losses, None, stage_losses
