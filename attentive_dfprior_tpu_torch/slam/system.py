"""SLAM system orchestrator: dataset, TSDF prior, scene state, tracker and
mapper in one of three schedules.

The port of the JAX package's ``slam/system.py`` (ref:
src/DF_Prior.py:23-311). ``sync_method: strict`` runs

    track(i) -> [map(i) if i % every_frame == 0 or i is last] -> track(i+1)

with the scene handed to the tracker as an argument. ``loose`` and ``free``
run the reference's Tracker || Mapper concurrency (ref:
src/DF_Prior.py:297-311) as the JAX package does: a mapper worker thread
takes mapping jobs from a queue and publishes a scene snapshot after each
mapped frame, and the main thread tracks on the latest snapshot. ``loose``
keeps the tracker within ``every_frame + every_frame // 2`` frames of the
last mapped frame; ``free`` never waits after frame 0's map. On the card
each agent has its own CUDA stream (``_run_async``). Side outputs are the
checkpoints, ``metrics.jsonl`` and the meshes (``mesh/<idx>_mesh.ply``
every ``mesh_freq`` frames, ``mesh/final_mesh.ply`` and, with
``meshing.eval_rec``, ``mesh/final_mesh_eval_rec.ply`` at the last frame).

Three prior volumes, as in the JAX package: tracking reads the
reference-faithful one (unobserved voxels at -1); mapping reads it too, or
a filled copy under ``tsdf.fill_unobserved_train``; meshing reads a copy
filled by ``tsdf.fill_unobserved`` (``tsdf/fusion.py:fill_unobserved_volume``).

Loop closure (``slam/loop_closure.py``) relaxes the keyframes after a
mapped frame that revisits an old one, and refines the whole trajectory at
the last frame before its checkpoint and meshes are written. The
Visualizers write rendered-vs-input panels (``mapping_vis/``,
``tracking_vis/``). ``resume`` restores a checkpoint and ``run(start_idx)``
continues from it.

``parallel.enable`` in a process group of 2 or more ranks
(``parallel/sharding.py``) runs strict mode as ray-axis data parallelism:
each rank drives one card (``cuda:{LOCAL_RANK}`` or the device named), the
scene and the priors are broadcast from rank 0 after set-up, every rank
runs the same loop and issues the same collectives in the same order
(mapping, BA, tracking and loop closure each sum over the group), and rank
0 alone writes the side outputs, the panels and ``metrics.jsonl``. Below 2
ranks the single-device path runs unchanged. Not in this port yet (raises
``NotImplementedError`` naming its ROADMAP.md item): ``parallel.split``,
and ``loose`` / ``free`` on a group of 2 or more ranks.
"""

from __future__ import annotations

import contextlib
import json
import os
import queue
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from attentive_dfprior_tpu_torch.camera import Camera
from attentive_dfprior_tpu_torch.models.scene import SceneConfig, init_scene
from attentive_dfprior_tpu_torch.ops.grid_sample import grid_sampler
from attentive_dfprior_tpu_torch.ops.pose import clamp_pose_update
from attentive_dfprior_tpu_torch.parallel.sharding import ASYNC_ITEM, mesh_from_config, replicate
from attentive_dfprior_tpu_torch.render.renderer import RenderConfig, Renderer
from attentive_dfprior_tpu_torch.slam.keyframes import KeyframeStore, keyframe_selection_overlap
from attentive_dfprior_tpu_torch.slam.loop_closure import LoopCloser
from attentive_dfprior_tpu_torch.slam.mapper import Mapper
from attentive_dfprior_tpu_torch.slam.tracker import Tracker
from attentive_dfprior_tpu_torch.tsdf.fusion import fill_unobserved_volume, legacy_observed_mask
from attentive_dfprior_tpu_torch.utils.datasets import get_dataset
from attentive_dfprior_tpu_torch.utils.device import resolve_device
from attentive_dfprior_tpu_torch.utils.logger import Logger, load_checkpoint
from attentive_dfprior_tpu_torch.utils.mesher import Mesher
from attentive_dfprior_tpu_torch.utils.profiling import PhaseTimer
from attentive_dfprior_tpu_torch.utils.tree import tree_leaves, tree_map
from attentive_dfprior_tpu_torch.utils.visualizer import Visualizer

SYNC_METHODS = ("strict", "loose", "free")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to attentive_dfprior_tpu_torch yet "
        f"(ROADMAP.md, 'Modules to port': {item})"
    )


def load_tsdf_volume(cfg: Dict[str, Any], args=None, device=None):
    """Load (or build) the TSDF prior volume and its bounds, on ``device``
    (the card by default; ``"cpu"`` on request, ``utils/device.py``).

    Sources, in order: the ``{dataset}_tsdf_volume/<id>_tsdf_volume.npz``
    cache written by the JAX package's get_tsdf CLI (used only when built at
    the configured voxel size), the reference's ``.pt`` layout, or fusion of
    the dataset on the fly (the synthetic configs).

    Returns:
        (tsdf (X, Y, Z) tensor on ``device``, bounds (3, 2) numpy, observed
        (X, Y, Z) bool mask: the cache's, else recovered from the values by
        ``legacy_observed_mask``, else the fusion weights; source: the path
        of the file read, or ``"fused"``).
    """
    device = resolve_device(device)
    dataset = cfg["data"]["dataset"]
    scene_id = cfg["data"]["id"]
    base = f"{dataset}_tsdf_volume"
    prefix = f"scene{scene_id}" if dataset == "scannet" else f"{scene_id}"
    npz_path = os.path.join(base, f"{prefix}_tsdf_volume.npz")
    pt_path = os.path.join(base, f"{prefix}_tsdf_volume.pt")
    cfg_voxel = float(cfg.get("tsdf", {}).get("voxel_size", 4.0 / 256))
    if os.path.exists(npz_path):
        data = np.load(npz_path)
        cached_voxel = float(data["voxel_size"]) if "voxel_size" in data else None
        if cached_voxel is None or abs(cached_voxel - cfg_voxel) < 1e-9:
            print(f"TSDF prior: loaded cache {npz_path} (shape {data['tsdf'].shape})")
            tsdf = np.asarray(data["tsdf"], dtype=np.float32)
            observed = np.asarray(data["observed"]) if "observed" in data else legacy_observed_mask(tsdf)
            return torch.as_tensor(tsdf, device=device), np.asarray(data["bounds"]), observed, npz_path
        print(f"TSDF cache {npz_path} voxel_size {cached_voxel} != configured {cfg_voxel}; rebuilding")
    if os.path.exists(pt_path):
        vol = torch.load(pt_path, map_location="cpu")
        # reference layout [1, 1, Z, Y, X] (ref: get_tsdf.py:95-97) -> (X, Y, Z)
        vol = vol[0, 0].permute(2, 1, 0).contiguous().float()
        bnds = torch.load(os.path.join(base, f"{prefix}_bounds.pt"), map_location="cpu")
        # the reference saves no weights: recover the mask from the values
        return vol.to(device), np.asarray(bnds), legacy_observed_mask(vol.numpy()), pt_path

    from attentive_dfprior_tpu_torch.tsdf.builder import build_tsdf_volume

    space = int(cfg.get("tsdf", {}).get("space", 10))
    print(f"TSDF prior: fusing on the fly (voxel {cfg_voxel}, every {space} frames)")
    tsdf, bounds, vol = build_tsdf_volume(cfg, args, space=space, voxel_size=cfg_voxel, device=device)
    return tsdf, bounds, vol.observed_mask(), "fused"


def resolve_pretrained(cfg: Dict[str, Any]) -> Optional[str]:
    """The decoder prior to load: the configured path, or its sibling
    ``.npz`` (the shipped ``pretrained/low_high.npz``) when the configured
    ``.pt`` is absent; None when neither exists."""
    pretrained = cfg.get("pretrained_decoders", {}).get("low_high")
    if pretrained and not os.path.exists(str(pretrained)):
        alt = str(pretrained).rsplit(".", 1)[0] + ".npz"
        if os.path.exists(alt):
            pretrained = alt
    return str(pretrained) if pretrained and os.path.exists(str(pretrained)) else None


class SLAMSystem:
    """Top-level system (ref DF_Prior class, src/DF_Prior.py:23-311).

    Args:
        cfg: merged config.
        args: optional CLI namespace (``output``, ``input_folder``).
        output: output directory (default: ``args.output`` or the config's).
        device: the card by default; ``"cpu"`` runs the plain path.
        grid_vjp: the feature grids' gradient variant in mapping and
            tracking (``ops/grid_sample.py:GRID_VJPS``; the JAX package's
            ``DFPRIOR_TRILINEAR_VJP``).
        adam_lazy: Adam's per-leaf lazy rule; False is the JAX package's
            ``DFPRIOR_ADAM_LAZY=0``.

    Pixel draws: the mapper (and loop closure's relaxation, which runs
    after a mapped frame) draws from ``self.generator``. In strict mode the
    tracker draws from it too, so one seed fixes the whole run. In the
    async modes the two agents run on two threads and must not share a
    generator: the tracker (and the final refine) draws from a generator of
    its own seeded with ``seed + 2``, and the mapper's stream is the strict
    run's. With ``tracking.gt_camera`` the tracker draws nothing, so the
    map of an async run equals the strict run's bit for bit.
    """

    def __init__(
        self,
        cfg: Dict[str, Any],
        args=None,
        output: Optional[str] = None,
        device=None,
        grid_vjp: str = "halo",
        adam_lazy: bool = True,
    ):
        grid_sampler(grid_vjp)  # an unknown name raises here, not mid-run
        self.device = resolve_device(device)
        self.cfg = cfg
        self.sync_method = str(cfg.get("sync_method", "strict"))
        if self.sync_method not in SYNC_METHODS:
            raise ValueError(f"sync_method {self.sync_method!r} is not one of {SYNC_METHODS}")
        par = cfg.get("parallel") or {}
        if bool(par.get("enable", False)) and par.get("split"):
            raise _not_ported("parallel.split (the device-split async agents)", ASYNC_ITEM)
        # the dp group, or None: the single-device path (fewer than 2 ranks)
        self.shards = mesh_from_config(cfg)
        if self.shards is not None and self.sync_method != "strict":
            raise _not_ported(f"sync_method {self.sync_method!r} on a dp group of {self.shards.size} ranks", ASYNC_ITEM)
        # side outputs, panels and metrics.jsonl: rank 0 of a process group
        self.is_rank0 = not dist.is_initialized() or dist.get_rank() == 0

        self.verbose = bool(cfg.get("verbose", False))
        self.output = output or (getattr(args, "output", None) or cfg["data"]["output"])
        os.makedirs(os.path.join(self.output, "mesh"), exist_ok=True)
        self.cam = Camera.from_config(cfg)
        self.scale = cfg.get("scale", 1)

        # --- data + prior ---
        self.dataset = get_dataset(cfg, args, self.scale)
        self.n_img = len(self.dataset)
        self.tsdf_volume, tsdf_bnds, observed, self.tsdf_source = load_tsdf_volume(cfg, args, self.device)
        self.tsdf_bnds = np.asarray(tsdf_bnds, dtype=np.float32)
        # the three priors (module docstring); the fills default as in
        # configs/df_prior.yaml
        tcfg = cfg.get("tsdf", {})
        self.tsdf_volume_track = self.tsdf_volume
        self.tsdf_volume_mesh = self._filled(observed, str(tcfg.get("fill_unobserved", "free")))
        self.tsdf_volume = self._filled(observed, str(tcfg.get("fill_unobserved_train", "reference")))

        # --- scene state ---
        pretrained = resolve_pretrained(cfg)
        self.scene_cfg = SceneConfig.from_config(cfg, pretrained_loaded=pretrained is not None)
        self.seed = int(cfg.get("seed", 0))
        self.params = init_scene(torch.Generator().manual_seed(self.seed), self.scene_cfg, pretrained, self.device)
        if self.shards is not None:
            # one scene and one prior, rank 0's, whatever each rank's set-up
            # computed (the fusion's atomic adds); the mesh prior is rank 0's
            replicate(tree_leaves(self.params), self.shards)
            for vol in {id(v): v for v in (self.tsdf_volume_track, self.tsdf_volume)}.values():
                replicate([vol], self.shards)
        # pixel draws (the class docstring): the mapper's, and in strict
        # mode the tracker's; an async run sets the tracker's own
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        self._track_generator: Optional[torch.Generator] = None

        r = cfg["rendering"]
        self.rcfg = RenderConfig(
            N_samples=int(r["N_samples"]),
            N_surface=int(r["N_surface"]),
            N_importance=int(r["N_importance"]),
            lindisp=bool(r["lindisp"]),
            perturb=float(r["perturb"]),
            occupancy=bool(cfg.get("occupancy", True)),
        )
        self.renderer = Renderer(self.rcfg, self.scene_cfg.bound, self.tsdf_bnds, self.cam, self.device)
        self.mapper = Mapper(
            cfg, self.cam, self.scene_cfg, self.rcfg, self.tsdf_volume, self.tsdf_bnds, self.device,
            grid_vjp=grid_vjp, adam_lazy=adam_lazy, shards=self.shards,
        )
        self.tracker = Tracker(
            cfg, self.cam, self.rcfg, self.scene_cfg.bound, self.tsdf_volume_track, self.tsdf_bnds, self.device,
            grid_vjp=grid_vjp, adam_lazy=adam_lazy, shards=self.shards,
        )
        self.mesher = Mesher(cfg, self.cam, self.scene_cfg.bound, self.tsdf_bnds, self.device)
        self.logger = Logger(os.path.join(self.output, "ckpts"), self.verbose)
        self.visualizer = Visualizer(
            freq=int(cfg["mapping"]["vis_freq"]),
            inside_freq=int(cfg["mapping"]["vis_inside_freq"]),
            vis_dir=os.path.join(self.output, "mapping_vis"),
            renderer=self.renderer,
            verbose=self.verbose,
        )
        self.tracking_visualizer = Visualizer(
            freq=int(cfg["tracking"]["vis_freq"]),
            inside_freq=int(cfg["tracking"]["vis_inside_freq"]),
            vis_dir=os.path.join(self.output, "tracking_vis"),
            renderer=self.renderer,
            verbose=self.verbose,
        )
        self.save_selected_keyframes_info = bool(cfg["mapping"].get("save_selected_keyframes_info", False))
        self.selected_keyframes: Dict[int, list] = {}

        m = cfg["mapping"]
        self.every_frame = int(m["every_frame"])
        self.keyframe_every = int(m["keyframe_every"])
        self.ckpt_freq = int(m["ckpt_freq"])
        self.mesh_freq = int(m["mesh_freq"])
        self.color_refine = bool(m.get("color_refine", True))
        self.no_log_on_first_frame = bool(m.get("no_log_on_first_frame", True))
        self.no_mesh_on_first_frame = bool(m.get("no_mesh_on_first_frame", True))
        self.eval_rec = bool(cfg["meshing"].get("eval_rec", False))
        cap = int(m.get("keyframe_capacity", max(8, self.n_img // self.keyframe_every + 4)))
        self.keyframes = KeyframeStore(cap, self.cam.H, self.cam.W, self.device)

        lc_cfg = cfg
        lc = cfg.get("loop_closure") or {}
        if bool(cfg["tracking"].get("gt_camera", False)) and (lc.get("enable") or lc.get("final_refine")):
            # re-localizing ground-truth poses can only perturb them
            print("[system] loop_closure disabled: tracking.gt_camera is set")
            lc_cfg = {**cfg, "loop_closure": {}}
        # re-localization renders against the reference-faithful prior, as
        # tracking does
        self.loop_closer = LoopCloser(
            lc_cfg, self.tracker, self.keyframes, self.cam, self.rcfg, self.scene_cfg.bound,
            self.tsdf_volume_track, self.tsdf_bnds, log_fn=self._log_metrics,
        )

        self.estimate_c2w_list = np.zeros((self.n_img, 4, 4), dtype=np.float32)
        self.gt_c2w_list = np.zeros((self.n_img, 4, 4), dtype=np.float32)
        self._np_rng = np.random.default_rng(self.seed)
        # seconds (and rays) of the parts: track, map, loop, mesh
        self.profiler = PhaseTimer()
        self.last_idx: Optional[int] = None  # the last frame run() processed
        self._metrics_path = os.path.join(self.output, "metrics.jsonl")
        self._log_lock = threading.Lock()
        # the keyframe store and selected_keyframes against the side
        # outputs' reads, when the mapper runs on the worker thread
        self._kf_lock = threading.Lock()

    def _log_metrics(self, record: Dict[str, Any]) -> None:
        if not self.is_rank0:
            return
        record.setdefault("t", round(time.time(), 4))
        with self._log_lock, open(self._metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    @property
    def timings(self) -> Dict[str, float]:
        """Seconds by part: tracking and mapping without their panels, loop
        closure (relaxations and the final refine), panels, meshes. In the
        async modes ``track`` and ``map`` (with the relaxations in
        ``loop``) run on two threads at once, so their wall times overlap
        and the parts may sum to more than the run's wall time."""
        s = self.profiler.seconds
        vt, vm = self.tracking_visualizer.seconds, self.visualizer.seconds
        return {
            "track": s.get("track", 0.0) - vt,
            "map": s.get("map", 0.0) - vm,
            "loop": s.get("loop", 0.0),
            "vis": vt + vm,
            "mesh": s.get("mesh", 0.0),
        }

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, dtype=np.float32), device=self.device)

    def _sync_stream(self) -> None:
        """Wait until the calling thread's stream has done its work: the
        hand-off points between the agents (a no-op on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _keyframes_view(self, depths: bool = False):
        """Copies of the keyframe store's host state, read under the
        keyframe lock: (frame indices, estimated poses, GT poses,
        selected_keyframes, and with ``depths`` the (K, H, W) depths)."""
        with self._kf_lock:
            K = len(self.keyframes)
            kf_depths = self.keyframes.depth[:K].cpu().numpy() if depths else None
            return (list(self.keyframes.frame_idx), self.keyframes.poses_np().copy(),
                    np.array(self.keyframes.gt_c2w[:K]), dict(self.selected_keyframes), kf_depths)

    def _filled(self, observed: np.ndarray, mode: str) -> torch.Tensor:
        """The reference-faithful prior, or a copy with its unobserved
        voxels filled by ``mode``."""
        if mode == "reference":
            return self.tsdf_volume_track
        filled = fill_unobserved_volume(self.tsdf_volume_track.cpu().numpy(), observed, mode)
        return torch.as_tensor(filled, device=self.device)

    # ------------------------------------------------------------------

    def get_mesh(
        self, mesh_out_file: str, idx: Optional[int] = None, get_mask_use_all_frames: bool = False, params=None
    ):
        """Mesh a scene into ``mesh_out_file`` (PLY), as the side outputs
        do: the mesh prior, the keyframes' depths and poses, and with
        ``get_mask_use_all_frames`` every estimated pose up to ``idx``
        (default: the last frame run). ``params``: the scene (default: the
        mapper's; the async modes pass the published snapshot). Returns
        ``Mesher.get_mesh``'s (verts, faces), or None when there is no
        surface."""
        idx = self.last_idx if idx is None else idx
        _, kf_poses, _, _, kf_depths = self._keyframes_view(depths=True)
        with self.profiler.phase("mesh"):
            return self.mesher.get_mesh(
                mesh_out_file, self.params if params is None else params, self.tsdf_volume_mesh, kf_depths,
                kf_poses, self.estimate_c2w_list, idx, get_mask_use_all_frames=get_mask_use_all_frames,
            )

    def resume(self, ckpt_path: str) -> int:
        """Restore a checkpoint of either package (scene, trajectories,
        keyframes re-read from the dataset, selected keyframes); returns the
        next frame to process. (The reference has no resume, SURVEY §5.)"""
        self.params, meta = load_checkpoint(ckpt_path, self.params)
        idx = meta["idx"]
        self.estimate_c2w_list[: len(meta["estimate_c2w_list"])] = meta["estimate_c2w_list"]
        self.gt_c2w_list[: len(meta["gt_c2w_list"])] = meta["gt_c2w_list"]
        kf_gt = meta.get("keyframe_gt_c2w")
        for slot, kf_idx in enumerate(meta["keyframe_idx_list"]):
            _, color, depth, _ = self.dataset[int(kf_idx)]
            gt = kf_gt[slot] if kf_gt is not None else self.gt_c2w_list[int(kf_idx)]
            self.keyframes.add(int(kf_idx), color, depth, meta["keyframe_est_c2w"][slot], gt)
        self.selected_keyframes = meta.get("selected_keyframes", {})
        self.last_idx = idx
        return idx + 1

    # ------------------------------------------------------------------

    def _select_window(self, cur_color, cur_depth, cur_c2w, window_size=None):
        """Optimization window: overlap-selected keyframes + the most recent
        keyframe + the current frame (ref: src/Mapper.py:288-304)."""
        if window_size is None:
            window_size = self.mapper.mapping_window_size
        K = len(self.keyframes)
        sel: list = []
        if K > 0:
            if self.mapper.keyframe_selection_method == "overlap" and K > 1:
                sel = keyframe_selection_overlap(
                    self._np_rng, cur_depth, cur_c2w.astype(np.float64),
                    self.keyframes.poses_np()[: K - 1], window_size - 2,
                    self.cam.H, self.cam.W, self.cam.fx, self.cam.fy, self.cam.cx, self.cam.cy,
                )
            elif self.mapper.keyframe_selection_method == "global" and K > 1:
                perm = self._np_rng.permutation(K - 1)
                sel = [int(i) for i in perm[: window_size - 2]]
            sel = sel + [K - 1]
        slots = np.asarray(sel, dtype=np.int64)
        cur_c = self._to_device(cur_color)[None]
        cur_d = self._to_device(cur_depth)[None]
        if len(slots) > 0:
            sl = torch.as_tensor(slots, device=self.device)
            f_color = torch.cat([self.keyframes.color.index_select(0, sl), cur_c], dim=0)
            f_depth = torch.cat([self.keyframes.depth.index_select(0, sl), cur_d], dim=0)
            f_c2w = np.concatenate([self.keyframes.est_c2w[slots], cur_c2w[None]], axis=0)
        else:
            f_color, f_depth, f_c2w = cur_c, cur_d, cur_c2w[None]
        return f_color, f_depth, f_c2w, slots

    def _map_frame(self, idx, color, depth, c2w, gt_c2w, first: bool):
        color_refine = not first and idx == self.n_img - 1 and self.color_refine
        window_size = None
        outer = 1
        if first:
            num_iters, lr_factor = self.mapper.iters_first, self.mapper.lr_first_factor
        elif color_refine:
            # final color refinement (ref: src/Mapper.py:532-539)
            outer = 5
            num_iters, lr_factor = self.mapper.num_joint_iters, self.mapper.lr_factor
            window_size = self.mapper.mapping_window_size * 2
        else:
            num_iters, lr_factor = self.mapper.num_joint_iters, self.mapper.lr_factor
        # no panels on the first frame (by default), in the color refinement,
        # or on a rank other than 0
        no_vis = (color_refine or (idx == 0 and self.cfg["mapping"].get("no_vis_on_first_frame", True))
                  or not self.is_rank0)

        losses: Dict[str, float] = {}
        with self.profiler.phase("map", rays=outer * num_iters * self.mapper.mapping_pixels):
            for _ in range(outer):
                f_color, f_depth, f_c2w, slots = self._select_window(color, depth, c2w, window_size)
                if self.save_selected_keyframes_info:
                    with self._kf_lock:
                        self.selected_keyframes[idx] = [{"est_c2w": f_c2w[i]} for i in range(len(f_c2w))]
                # BA gauge anchor: the window keyframe with the smallest frame index
                if len(slots) > 0:
                    ba_anchor = int(np.argmin([self.keyframes.frame_idx[int(s)] for s in slots]))
                else:
                    ba_anchor = 0
                self.params, losses, refined_c2w, _ = self.mapper.optimize_map(
                    self.params, num_iters, lr_factor, idx, f_color, f_depth, f_c2w,
                    generator=self.generator, cur_depth_np=np.asarray(depth),
                    cur_c2w_np=c2w, color_refine=color_refine, ba_anchor=ba_anchor,
                    visualizer=None if no_vis else self.visualizer, cur_color_np=np.asarray(color),
                )
                if refined_c2w is not None:
                    # BA write-back through the trust-region clamp: window
                    # keyframes into the store, the current frame into the trajectory
                    mcfg = self.cfg["mapping"]
                    max_dt = float(mcfg.get("ba_max_dt", 0.02))
                    max_rot = float(np.deg2rad(mcfg.get("ba_max_rot_deg", 1.0)))
                    clamped = np.stack(
                        [clamp_pose_update(f_c2w[w], refined_c2w[w], max_dt, max_rot)
                         for w in range(len(refined_c2w))]
                    )
                    with self._kf_lock:
                        for w, sl in enumerate(slots):
                            self.keyframes.update_pose(int(sl), clamped[w])
                    c2w = clamped[-1]
                    self.estimate_c2w_list[idx] = clamped[-1]

        # keyframe bookkeeping (ref: src/Mapper.py:560-565)
        if (idx % self.keyframe_every == 0 or idx == self.n_img - 2) and idx not in self.keyframes.frame_idx:
            with self._kf_lock:
                self.keyframes.add(idx, color, depth, c2w, gt_c2w)
                self._sync_stream()  # the store's device rows are written before a reader takes the lock
        # revisit-gated keyframe relaxation, on the keyframes including this one
        if self.loop_closer.enable:
            with self.profiler.phase("loop"):
                self.loop_closer.maybe_relax(
                    idx, np.asarray(depth), c2w, self.estimate_c2w_list, self.params, self.generator,
                    kf_lock=self._kf_lock,
                )
        if self.verbose:
            print(f"Mapping frame {idx}  losses={losses}")
        self._log_metrics(
            {"event": "map", "idx": int(idx), "losses": losses, "first": bool(first),
             "n_keyframes": len(self.keyframes)}
        )

    @property
    def track_generator(self) -> torch.Generator:
        """The tracker's pixel draws: the async run's own, else the shared one."""
        return self.generator if self._track_generator is None else self._track_generator

    def _track_frame(self, idx, color, depth, gt_c2w, params=None):
        t = self.tracker
        with self.profiler.phase("track", rays=0 if t.gt_camera else t.tracking_pixels * t.num_cam_iters):
            c2w, loss = t.track(
                self.params if params is None else params, idx, self._to_device(color), self._to_device(depth),
                gt_c2w, self.estimate_c2w_list, generator=self.track_generator,
                visualizer=self.tracking_visualizer if self.is_rank0 else None,
            )
        self.estimate_c2w_list[idx] = c2w
        if self.verbose:
            print(f"Tracking frame {idx}  loss={loss:.3f}")
        self._log_metrics({"event": "track", "idx": int(idx), "loss": float(loss)})

    # ------------------------------------------------------------------

    def run(self, start_idx: int = 0, end_idx: Optional[int] = None) -> np.ndarray:
        """The SLAM loop over frames [start_idx, end_idx) in the configured
        ``sync_method``; returns the estimated trajectory (n_img, 4, 4).
        ``start_idx`` > 0 continues a run restored by ``resume``.

        strict: mapping of frame i completes before tracking i+1, the
        reference's serialized schedule. loose / free: ``_run_async``.
        The profiler's ``run`` phase is the wall time of the call.
        """
        n = self.n_img if end_idx is None else min(end_idx, self.n_img)
        stop_at = self.cfg["mapping"].get("stop_at_frame")
        if stop_at is not None:
            n = min(n, int(stop_at) + 1)
        with self.profiler.phase("run"):
            self.dataset.prefetch(range(start_idx, n))
            if self.sync_method == "strict":
                self._run_strict(start_idx, n)
            else:
                self._run_async(start_idx, n, self.sync_method)
        return self.estimate_c2w_list

    def _run_strict(self, start_idx: int, n: int) -> None:
        for idx in range(start_idx, n):
            _, color, depth, gt_c2w = self.dataset[idx]
            self.gt_c2w_list[idx] = gt_c2w
            if idx == 0:
                self.estimate_c2w_list[0] = gt_c2w
                self._map_frame(0, color, depth, gt_c2w, gt_c2w, first=True)
            else:
                self._track_frame(idx, color, depth, gt_c2w)
                if not np.isfinite(gt_c2w).all():
                    continue  # skip mapping (ref: Mapper.py:521-524)
                if idx % self.every_frame == 0 or idx == n - 1:
                    self._map_frame(idx, color, depth, self.estimate_c2w_list[idx], gt_c2w, first=False)
            if idx == n - 1 and self.loop_closer.final_refine_on:
                # the whole trajectory against the final map, before the
                # last side outputs write the checkpoint and meshes
                with self.profiler.phase("loop"):
                    self.loop_closer.final_refine(
                        self.dataset, self.estimate_c2w_list, self.params, start_idx, n, self.generator
                    )
            self.last_idx = idx
            self._side_outputs(idx, n)

    def _snapshot_for_tracker(self):
        """An independent copy of the scene for the tracker: every leaf
        detached and cloned, so the mapper's
        in-place Adam steps never reach it and the tracker's reads never
        touch the mapper's leaves or their ``.grad``. The calling thread's
        stream is synchronized before it returns, so the copy is complete
        when another thread reads it (the JAX package's
        ``block_until_ready``)."""
        snap = tree_map(lambda t: t.detach().clone(), self.params)
        self._sync_stream()
        return snap

    def _run_async(self, start_idx: int, n: int, sync: str) -> None:
        """loose / free: a mapper worker thread and published scene
        snapshots (the JAX package's ``_run_async``, same protocol).

        The main thread reads each frame, tracks it on the latest published
        snapshot and queues a mapping job for every frame strict mode
        maps; the worker maps, then publishes a fresh snapshot, or skips
        the publish (``publish_skip``) while the tracker has not read the
        last one and it is less than ``2 * every_frame`` frames old. Both
        modes wait for frame 0's map; ``loose`` also waits until the last
        mapped frame is at most ``every_frame + every_frame // 2`` frames
        behind. At the last frame the main thread waits for its map,
        publishes a snapshot of the final map if the worker skipped it, and
        runs the final refine and the side outputs on it.

        On the card the worker runs on a CUDA stream of its own, so the two
        agents' kernels can overlap. The hand-offs are ordered: the worker
        synchronizes its stream before it publishes a snapshot and before it
        releases the keyframe lock after a write, and the main thread
        records its stream on every snapshot leaf it reads, so the caching
        allocator does not reuse a snapshot's memory while the tracker's
        kernels may still read it. A worker exception is raised again in
        the main thread.
        """
        cuda = self.device.type == "cuda"
        map_stream = torch.cuda.Stream(self.device) if cuda else None
        if cuda:
            # the worker's first job reads what this thread wrote (the
            # initial or resumed scene, the priors, the keyframe store)
            map_stream.wait_stream(torch.cuda.current_stream(self.device))
        jobs: "queue.Queue" = queue.Queue()
        # the seed snapshot is a copy too: on resume the tracker starts from
        # it while the first map job already updates self.params in place
        state = {
            "published": self._snapshot_for_tracker(),
            # resume: everything before start_idx counts as mapped, so the
            # loose staleness gate can make progress
            "last_mapped": start_idx - 1,
            "published_idx": start_idx - 1,
            "consumed": True,  # has the tracker read the current snapshot?
            "error": None,
        }
        pub_cv = threading.Condition()
        self._track_generator = torch.Generator(device=self.device).manual_seed(self.seed + 2)

        def mapper_worker():
            try:
                stream_ctx = torch.cuda.stream(map_stream) if cuda else contextlib.nullcontext()
                with stream_ctx:
                    while True:
                        job = jobs.get()
                        if job is None:
                            return
                        midx, mcolor, mdepth, mgt, first = job
                        self._map_frame(midx, mcolor, mdepth, self.estimate_c2w_list[midx], mgt, first=first)
                        self._sync_stream()  # the map job's work is done before anyone reads it
                        # publish on demand: if the tracker never read the
                        # last snapshot, keep it (one map staler) unless it
                        # would fall 2 * every_frame frames behind
                        with pub_cv:
                            skip = not state["consumed"] and midx - state["published_idx"] < 2 * self.every_frame
                            if skip:
                                state["last_mapped"] = midx
                                pub_cv.notify_all()
                        if skip:
                            self._log_metrics({"event": "publish_skip", "idx": int(midx)})
                            continue
                        t0 = time.time()
                        snap = self._snapshot_for_tracker()
                        publish_s = time.time() - t0
                        with pub_cv:
                            state["published"] = snap
                            state["published_idx"] = midx
                            state["consumed"] = False
                            state["last_mapped"] = midx
                            pub_cv.notify_all()
                        self._log_metrics({"event": "publish", "idx": int(midx), "publish_s": round(publish_s, 4)})
            except BaseException as e:  # surfaced in the main thread
                with pub_cv:
                    state["error"] = e
                    pub_cv.notify_all()

        worker = threading.Thread(target=mapper_worker, name="mapper", daemon=True)
        worker.start()
        # loose staleness bound (role of ref: src/Tracker.py:176-181)
        max_lag = self.every_frame + self.every_frame // 2

        def wait_until(cond):
            with pub_cv:
                while not cond() and state["error"] is None:
                    pub_cv.wait(timeout=0.05)
                if state["error"] is not None:
                    raise state["error"]

        def snapshot():
            """The latest snapshot, marked read, its leaves recorded on
            this thread's stream."""
            with pub_cv:
                if state["error"] is not None:
                    raise state["error"]
                state["consumed"] = True
                snap = state["published"]
            if cuda:
                here = torch.cuda.current_stream(self.device)
                for leaf in tree_leaves(snap):
                    leaf.record_stream(here)
            return snap

        try:
            for idx in range(start_idx, n):
                _, color, depth, gt_c2w = self.dataset[idx]
                self.gt_c2w_list[idx] = gt_c2w
                if idx == 0:
                    self.estimate_c2w_list[0] = gt_c2w
                    jobs.put((0, color, depth, gt_c2w, True))
                    # both modes wait for the first map before tracking
                    # (ref: src/Tracker.py:277-281)
                    wait_until(lambda: state["last_mapped"] >= 0)
                else:
                    if sync == "loose":
                        wait_until(lambda: state["last_mapped"] >= idx - max_lag)
                    self._track_frame(idx, color, depth, gt_c2w, params=snapshot())
                    if not np.isfinite(gt_c2w).all():
                        continue
                    if idx % self.every_frame == 0 or idx == n - 1:
                        jobs.put((idx, color, depth, gt_c2w, False))
                        if idx == n - 1:  # the last frame: complete the map
                            wait_until(lambda: state["last_mapped"] >= idx)
                            with pub_cv:
                                stale = state["published_idx"] < state["last_mapped"]
                            if stale:
                                # the worker skipped the last publish and is
                                # idle (no job pending): snapshot the final map
                                snap = self._snapshot_for_tracker()
                                with pub_cv:
                                    state["published"] = snap
                                    state["published_idx"] = idx
                                    state["consumed"] = False
                if idx == n - 1 and self.loop_closer.final_refine_on:
                    # the worker is idle here, so the published snapshot is final
                    with self.profiler.phase("loop"):
                        self.loop_closer.final_refine(
                            self.dataset, self.estimate_c2w_list, snapshot(), start_idx, n, self.track_generator
                        )
                self.last_idx = idx
                self._side_outputs(idx, n, params=snapshot())
        finally:
            jobs.put(None)
            worker.join(timeout=600)
            self._track_generator = None
        if worker.is_alive():
            raise RuntimeError("the mapper worker did not stop within 600 s")

    def _side_outputs(self, idx: int, n: int, params=None) -> None:
        """Checkpoints every ckpt_freq frames and meshes every mesh_freq
        frames, both again at the last frame (ref: src/Mapper.py:574-602;
        the JAX package's slam/system.py:827-893). ``params``: the scene to
        write (default: the mapper's; the async modes pass the published
        snapshot). The keyframes are read under the keyframe lock. Rank 0
        alone writes them (nothing here runs a collective)."""
        if not self.is_rank0:
            return
        last = idx == n - 1
        kf_idx, kf_poses, kf_gt, selected, _ = self._keyframes_view()
        params = self.params if params is None else params
        if (idx % self.ckpt_freq == 0 and not (idx == 0 and self.no_log_on_first_frame)) or last:
            self.logger.log(
                idx, params, self.estimate_c2w_list, self.gt_c2w_list, kf_idx, kf_poses,
                keyframe_gt_c2w=kf_gt,
                selected_keyframes=selected if self.save_selected_keyframes_info else None,
            )
        if not kf_idx:
            return
        mesh_dir = os.path.join(self.output, "mesh")
        if idx % self.mesh_freq == 0 and not (idx == 0 and self.no_mesh_on_first_frame):
            self.get_mesh(os.path.join(mesh_dir, f"{idx:05d}_mesh.ply"), idx, params=params)
        if last:
            self.get_mesh(os.path.join(mesh_dir, "final_mesh.ply"), idx, params=params)
            if self.eval_rec:
                self.get_mesh(os.path.join(mesh_dir, "final_mesh_eval_rec.ply"), idx, True, params=params)
