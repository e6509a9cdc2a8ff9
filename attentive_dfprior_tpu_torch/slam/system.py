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
(``parallel/sharding.py``) runs ray-axis data parallelism: each rank drives
one card (``cuda:{LOCAL_RANK}`` or the device named), the scene and the
priors are broadcast from rank 0 after set-up, and rank 0 alone writes the
side outputs, the panels and ``metrics.jsonl``. In strict mode every rank
runs the same loop and issues the same collectives in the same order
(mapping, BA, tracking and loop closure each sum over the group). In
``loose`` / ``free`` every rank runs both agents, each summing over a group
of its own, and rank 0 decides the schedule that the other ranks replay
(``slam/schedule.py``). ``parallel.split: {map: k, track: m}`` puts the
mapper on ranks [0, k) and the tracker on the next m (``_run_split``): the
first track rank leads, sends the map jobs and writes the side outputs, and
map rank 0 publishes the scene by broadcast. Below 2 ranks the
single-device path runs unchanged.
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
from attentive_dfprior_tpu_torch.parallel.sharding import (
    mesh_from_config,
    replicate,
    shared_groups,
    split_groups_from_config,
)
from attentive_dfprior_tpu_torch.render.renderer import RenderConfig, Renderer
from attentive_dfprior_tpu_torch.slam.keyframes import KeyframeStore, keyframe_selection_overlap
from attentive_dfprior_tpu_torch.slam.loop_closure import LoopCloser
from attentive_dfprior_tpu_torch.slam.mapper import Mapper
from attentive_dfprior_tpu_torch.slam.schedule import Channel, Peers, UnitSchedule, open_store
from attentive_dfprior_tpu_torch.slam.tracker import Tracker
from attentive_dfprior_tpu_torch.tsdf.fusion import fill_unobserved_volume, legacy_observed_mask
from attentive_dfprior_tpu_torch.utils.datasets import get_dataset
from attentive_dfprior_tpu_torch.utils.device import resolve_device
from attentive_dfprior_tpu_torch.utils.logger import Logger, load_checkpoint
from attentive_dfprior_tpu_torch.utils.mesher import Mesher
from attentive_dfprior_tpu_torch.utils.profiling import PhaseTimer, span
from attentive_dfprior_tpu_torch.utils.step_graph import ForwardGraphs
from attentive_dfprior_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten
from attentive_dfprior_tpu_torch.utils.visualizer import Visualizer

SYNC_METHODS = ("strict", "loose", "free")
SPLIT_NEEDS_ASYNC = (  # the JAX package's text (slam/system.py:229-233)
    "parallel.split requires sync_method 'loose' or 'free': strict mode serializes the agents, so split "
    "devices would only idle (and side outputs would mix meshes)"
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
        step_mode: ``graph`` replays each mapping stage's and each tracked
            frame's iteration as a CUDA graph (``utils/step_graph.py``, the
            JAX package's compiled ``lax.scan`` loops), ``eager`` runs it
            in Python; None: each agent's default by its own group
            (``resolve_step_mode``): ``graph`` on a CUDA device for an
            agent with no group (one process, or a ``parallel.split`` agent
            alone in its group) or on an NCCL group, ``eager`` on a gloo
            group, whose collectives cannot be captured. ``graph`` on the
            CPU or on a gloo group raises. ``self.step_mode`` says which
            ran: {"map": the mapper's mode, "track": the tracker's}. The
            renders and the Mesher's field queries (``forward_graphs``,
            ``utils/step_graph.py:ForwardGraphs``) replay one program a
            chunk in ``graph`` mode, the default on a CUDA device whatever
            the group, and run eager with ``eager``; ``forward_graphs.stats()``
            says what they captured and replayed.

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
        step_mode: Optional[str] = None,
    ):
        grid_sampler(grid_vjp)  # an unknown name raises here, not mid-run
        self.device = resolve_device(device)
        self.cfg = cfg
        self.sync_method = str(cfg.get("sync_method", "strict"))
        if self.sync_method not in SYNC_METHODS:
            raise ValueError(f"sync_method {self.sync_method!r} is not one of {SYNC_METHODS}")
        # the async agents' groups: parallel.split's disjoint ranks (raises as
        # the JAX split_meshes_from_config does), or two groups over a shared
        # dp group; every rank builds every group here, before any thread starts
        self.groups = split_groups_from_config(cfg)
        if self.groups is not None and self.sync_method == "strict":
            raise ValueError(SPLIT_NEEDS_ASYNC)
        # the dp group, or None: the single-device path (fewer than 2 ranks)
        self.shards = mesh_from_config(cfg) if self.groups is None else None
        if self.shards is not None and self.sync_method != "strict":
            self.groups = shared_groups(self.shards)
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        # mapping panels: rank 0 (map rank 0 under split); side outputs,
        # tracking panels and metrics.jsonl: the writer, rank 0 or the track lead
        self.is_rank0 = self.rank == 0
        self.is_writer = self.rank == (self.groups.lead if self.groups is not None else 0)
        self.role = self.groups.role if self.groups is not None else ("dp" if self.shards is not None else "single")
        # the schedule's store (slam/schedule.py), one prefix per run
        self._store = open_store() if self.groups is not None else None
        self._runs = 0
        # the last async run's decision log as this rank appended or replayed it
        self.schedule_records: list = []
        # a split map rank's records for the writer, sent with each map job's result
        self._outbox: Optional[list] = None

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
        # a split map rank never meshes
        self.tsdf_volume_mesh = (None if self.role == "map"
                                 else self._filled(observed, str(tcfg.get("fill_unobserved", "free"))))
        self.tsdf_volume = self._filled(observed, str(tcfg.get("fill_unobserved_train", "reference")))

        # --- scene state ---
        pretrained = resolve_pretrained(cfg)
        self.scene_cfg = SceneConfig.from_config(cfg, pretrained_loaded=pretrained is not None)
        self.seed = int(cfg.get("seed", 0))
        self.params = init_scene(torch.Generator().manual_seed(self.seed), self.scene_cfg, pretrained, self.device)
        world = self.shards if self.groups is None else self.groups.world
        if world is not None:
            # one scene and one prior, rank 0's, whatever each rank's set-up
            # computed (the fusion's atomic adds); the mesh prior is rank 0's
            replicate(tree_leaves(self.params), world)
            for vol in {id(v): v for v in (self.tsdf_volume_track, self.tsdf_volume)}.values():
                replicate([vol], world)
        if self.role == "track" and self.tsdf_volume is not self.tsdf_volume_track:
            self.tsdf_volume = None  # a split track rank never maps
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
        # graphed or eager steps (utils/step_graph.py), each agent's by its own group
        concurrent = self.sync_method != "strict"
        # the renders' and the Mesher's no-gradient programs, one set per calling thread, in the run's mode
        self.forward_graphs = ForwardGraphs(step_mode, self.device, concurrent=concurrent)
        self.renderer = Renderer(self.rcfg, self.scene_cfg.bound, self.tsdf_bnds, self.cam, self.device,
                                 graphs=self.forward_graphs)
        self.mapper = Mapper(
            cfg, self.cam, self.scene_cfg, self.rcfg, self.tsdf_volume, self.tsdf_bnds, self.device,
            grid_vjp=grid_vjp, adam_lazy=adam_lazy, shards=self.shards if self.groups is None else self.groups.map,
            step_mode=step_mode, concurrent=concurrent,
        )
        self.tracker = Tracker(
            cfg, self.cam, self.rcfg, self.scene_cfg.bound, self.tsdf_volume_track, self.tsdf_bnds, self.device,
            grid_vjp=grid_vjp, adam_lazy=adam_lazy, shards=self.shards if self.groups is None else self.groups.track,
            step_mode=step_mode, concurrent=concurrent,
        )
        self.step_mode = {"map": self.mapper.step_mode, "track": self.tracker.step_mode}
        self.mesher = Mesher(cfg, self.cam, self.scene_cfg.bound, self.tsdf_bnds, self.device,
                             graphs=self.forward_graphs)
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
        record.setdefault("t", round(time.time(), 4))
        if self._outbox is not None:
            self._outbox.append(record)
            return
        if not self.is_writer:
            return
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
        # the graphs read the old scene's buffers: capture again on the new ones
        self.mapper.graphs.clear()
        self.tracker.graphs.clear()
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
        with span("SLAMSystem._select_window"):
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
                    kf_lock=self._kf_lock, shards=self.mapper.shards, graphs=self.mapper.graphs,
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

    def _track_frame(self, idx, color, depth, gt_c2w, params=None, read=None):
        """Track frame ``idx`` on ``params`` (default: the scene); ``read``:
        the published map those are a snapshot of, logged with the frame."""
        t = self.tracker
        with self.profiler.phase("track", rays=0 if t.gt_camera else t.tracking_pixels * t.num_cam_iters):
            c2w, loss = t.track(
                self.params if params is None else params, idx, self._to_device(color), self._to_device(depth),
                gt_c2w, self.estimate_c2w_list, generator=self.track_generator,
                visualizer=self.tracking_visualizer if self.is_writer else None,
            )
        self.estimate_c2w_list[idx] = c2w
        if self.verbose:
            print(f"Tracking frame {idx}  loss={loss:.3f}")
        self._log_metrics({"event": "track", "idx": int(idx), "loss": float(loss),
                           **({} if read is None else {"read": int(read)})})

    # ------------------------------------------------------------------

    def run(self, start_idx: int = 0, end_idx: Optional[int] = None,
            schedule: Optional[UnitSchedule] = None) -> np.ndarray:
        """The SLAM loop over frames [start_idx, end_idx) in the configured
        ``sync_method``; returns the estimated trajectory (n_img, 4, 4).
        ``start_idx`` > 0 continues a run restored by ``resume``.

        strict: mapping of frame i completes before tracking i+1, the
        reference's serialized schedule. loose / free: ``_run_async``, or
        ``_run_split`` under ``parallel.split``. ``schedule``: the decision
        log a loose / free run follows (``slam/schedule.py``); on a shared
        dp group one is opened with rank 0 leading, and on one device none
        runs unless given. The profiler's ``run`` phase is the wall time of
        the call.
        """
        n = self.n_img if end_idx is None else min(end_idx, self.n_img)
        stop_at = self.cfg["mapping"].get("stop_at_frame")
        if stop_at is not None:
            n = min(n, int(stop_at) + 1)
        with self.profiler.phase("run"):
            self.dataset.prefetch(range(start_idx, n))
            if self.sync_method == "strict":
                self._run_strict(start_idx, n)
            elif self.role in ("map", "track"):
                self._run_split(start_idx, n, self.sync_method)
            else:
                self._run_async(start_idx, n, self.sync_method, schedule)
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

    def _run_store(self):
        """This run's part of the schedule's store."""
        self._runs += 1
        return dist.PrefixStore(f"run{self._runs}", self._store)

    def _run_async(self, start_idx: int, n: int, sync: str, sched: Optional[UnitSchedule] = None,
                   mapper: Optional["_MapperLink"] = None) -> None:
        """loose / free: the tracker on this thread, on the latest scene
        snapshot the mapper published (the JAX package's ``_run_async``,
        same protocol).

        This thread reads each frame, tracks it on the latest published
        snapshot and hands the mapper every frame strict mode maps. The
        mapper maps it, then publishes a fresh snapshot, or skips the
        publish (``publish_skip``) while the tracker has not read the last
        one and it is less than ``2 * every_frame`` frames old
        (``_MapperLink.publishes``). Both modes wait for frame 0's map;
        ``loose`` also waits until the last mapped frame is at most
        ``every_frame + every_frame // 2`` frames behind. At the last frame
        this thread waits for its map, has a snapshot of the final map
        published if the last publish was skipped (the stale fix-up), and
        runs the final refine and the side outputs on it.

        ``mapper``: where the maps run. By default a worker thread of this
        process (``_LocalMapper``); on the card it has a CUDA stream of its
        own, so the two agents' kernels can overlap. Under
        ``parallel.split`` the map ranks (``_RemoteMapper``). A mapper
        failure is raised again here.

        With ``sched`` (a shared dp group opens one, rank 0 leading; a split
        run's track ranks one, the track lead leading) the units run one at
        a time in the lead's order: the tracking of a frame with the
        snapshot it reads, the stale fix-up, and on a shared group each map
        job with its publish or skip, decided when it is granted. The lead
        waits on the gates above; a follower waits on the log alone, and
        checks that the snapshot it reads is the one the lead read. A
        failure on any rank fails every rank (``Peers``).
        """
        if mapper is None:
            if sched is None and self.groups is not None:
                store = self._run_store()
                sched = UnitSchedule(store, Peers(store, self.rank, self.groups.map_ranks),
                                     lead=self.rank == self.groups.lead, sync=self._sync_stream)
            mapper = _LocalMapper(self, start_idx, sched)
        lead = sched is None or sched.lead
        self.schedule_records = sched.records if sched is not None else []
        self._track_generator = torch.Generator(device=self.device).manual_seed(self.seed + 2)
        # loose staleness bound (role of ref: src/Tracker.py:176-181)
        max_lag = self.every_frame + self.every_frame // 2

        def gate(cond) -> None:
            """The lead's gates; a follower's order comes from the log."""
            mapper.wait(cond if lead else (lambda: True))

        @contextlib.contextmanager
        def grant(kind: str, idx: int, decide):
            if sched is None:
                yield decide()
                return
            with sched.unit(kind, idx, lambda: mapper.decision(decide)) as rec:
                mapper.enter(rec)
                yield rec

        ok = False
        try:
            for idx in range(start_idx, n):
                _, color, depth, gt_c2w = self.dataset[idx]
                self.gt_c2w_list[idx] = gt_c2w
                if idx == 0:
                    self.estimate_c2w_list[0] = gt_c2w
                    mapper.submit(0, color, depth, gt_c2w, True)
                    # both modes wait for the first map before tracking
                    # (ref: src/Tracker.py:277-281)
                    gate(lambda: mapper.last_mapped >= 0)
                else:
                    if sync == "loose":
                        gate(lambda: mapper.last_mapped >= idx - max_lag)
                    with grant("track", idx, lambda: {"read": mapper.published_idx}) as rec:
                        snap = mapper.snapshot(rec["read"])
                        self._track_frame(idx, color, depth, gt_c2w, params=snap, read=rec["read"])
                    if not np.isfinite(gt_c2w).all():
                        continue
                    if idx % self.every_frame == 0 or idx == n - 1:
                        mapper.submit(idx, color, depth, gt_c2w, False)
                        if idx == n - 1:  # the last frame: complete the map
                            gate(lambda: mapper.last_mapped >= idx)
                            with grant("final", idx,
                                       lambda: {"stale": mapper.published_idx < mapper.last_mapped}) as rec:
                                if rec["stale"]:
                                    # the last publish was skipped and the mapper is
                                    # idle (no job pending): publish the final map
                                    mapper.fix_stale(idx)
                if idx == n - 1 and self.loop_closer.final_refine_on:
                    # the mapper is idle here, so the newest snapshot is final
                    with self.profiler.phase("loop"):
                        self.loop_closer.final_refine(
                            self.dataset, self.estimate_c2w_list, mapper.snapshot(), start_idx, n,
                            self.track_generator,
                        )
                self.last_idx = idx
                if self.is_writer:
                    self._side_outputs(idx, n, params=mapper.snapshot())
            ok = True
        except BaseException as e:
            err = mapper.fail(e)
            if err is not e:
                raise err from e
            raise
        finally:
            mapper.close(ok)
            self._track_generator = None
        mapper.finish()
        if sched is not None:
            sched.peers.finish()

    def _run_split(self, start_idx: int, n: int, sync: str) -> None:
        """``parallel.split``: the mapper on ranks [0, k), the tracker on the
        next m (the JAX package's split meshes, one process per card).

        The track ranks run ``_run_async`` with the map ranks as their
        mapper (``_RemoteMapper``), the track lead (the first track rank)
        leading their schedule. The lead sends every frame strict mode maps
        to the map ranks as a job (``jobs``: the frame index and the poses
        tracked since the last job; the map ranks read the frame from their
        own dataset). The map ranks map it on their group, BA and loop
        closure's relaxation included: the JAX package relaxes on the
        tracker's mesh, on a snapshot, by the same arithmetic up to the dp
        sums. Map rank 0 then reports (``done``: the poses the job wrote,
        BA's keyframes and current frame and loop closure's corrections, the
        keyframe table as frame indices and poses, and its
        ``metrics.jsonl`` records), and the lead answers publish or skip by
        the JAX gate (``answers``). A publish is one broadcast of the scene
        on the publish group; every track rank receives it on a receiver
        thread. The final refine and the side outputs run on the track
        ranks on the final map; the lead writes them. Keyframe depths for
        the meshes come from the lead's own dataset.
        """
        g = self.groups
        store = self._run_store()
        peers = Peers(store, self.rank, g.map_ranks + g.track_ranks)
        if g.role == "track":
            sched = UnitSchedule(store, peers, lead=self.rank == g.lead, sync=self._sync_stream)
            self._run_async(start_idx, n, sync, sched, _RemoteMapper(self, start_idx, sched, store))
            return
        try:
            self._split_mapper(store, peers)
        except BaseException as e:
            err = peers.failure(e)
            if err is not e:
                raise err from e
            raise
        peers.finish()

    def _split_mapper(self, store, peers: Peers) -> None:
        """A map rank under ``parallel.split``: every job in order, until
        the lead's ``stop`` (``_run_split``)."""
        g = self.groups
        jobs, done, answers = (Channel(store, name, peers.check) for name in ("jobs", "done", "answers"))
        sender = self.rank == g.map_ranks[0]
        self.schedule_records = []
        n_jobs = n_answers = 0
        while True:
            job = jobs.read(n_jobs)
            n_jobs += 1
            publish = job["kind"] == "publish"
            if job["kind"] == "map":
                midx = int(job["idx"])
                for t, row in job["rows"]:
                    self.estimate_c2w_list[t] = np.asarray(row, dtype=np.float32)
                _, color, depth, gt_c2w = self.dataset[midx]
                self.gt_c2w_list[midx] = gt_c2w
                before = self.estimate_c2w_list[: midx + 1].copy()
                self._outbox = [] if sender else None
                try:
                    self._map_frame(midx, color, depth, self.estimate_c2w_list[midx], gt_c2w, first=job["first"])
                finally:
                    records, self._outbox = self._outbox, None
                self._sync_stream()
                self.last_idx = midx
                if sender:
                    after = self.estimate_c2w_list[: midx + 1]
                    moved = np.nonzero(np.any(after != before, axis=(1, 2)))[0]
                    kf_idx, kf_poses, _, selected, _ = self._keyframes_view()
                    report = {"kind": "map", "idx": midx, "rows": [[int(t), after[t].tolist()] for t in moved],
                              "kf": [[int(f), p.tolist()] for f, p in zip(kf_idx, kf_poses)], "records": records}
                    if self.save_selected_keyframes_info and midx in selected:
                        report["selected"] = [e["est_c2w"].tolist() for e in selected[midx]]
                    done.append(report)
                    publish = bool(answers.read(n_answers)["publish"])
                    n_answers += 1
            elif sender:
                done.append({"kind": job["kind"], "idx": job.get("idx")})
            self.schedule_records.append({"job": job["kind"], "idx": job.get("idx")})
            if job["kind"] == "stop":
                return
            if sender and publish:
                flat = torch.cat([t.detach().reshape(-1) for t in tree_leaves(self.params)])
                dist.broadcast(flat, src=g.map_ranks[0], group=g.publish)
                self._sync_stream()

    def _apply_report(self, msg: Dict[str, Any]) -> None:
        """A split track rank takes map rank 0's report of a job: the poses
        it wrote, its keyframe table (the keyframes' images from this
        rank's dataset) and the selected keyframes."""
        for t, row in msg.get("rows", []):
            self.estimate_c2w_list[t] = np.asarray(row, dtype=np.float32)
        with self._kf_lock:
            for slot, (frame, pose) in enumerate(msg.get("kf", [])):
                pose = np.asarray(pose, dtype=np.float32)
                if slot < len(self.keyframes):
                    self.keyframes.update_pose(slot, pose)
                else:
                    _, color, depth, gt_c2w = self.dataset[frame]
                    self.keyframes.add(frame, color, depth, pose, gt_c2w)
            if "selected" in msg:
                self.selected_keyframes[int(msg["idx"])] = [
                    {"est_c2w": np.asarray(p, dtype=np.float32)} for p in msg["selected"]]

    def _side_outputs(self, idx: int, n: int, params=None) -> None:
        """Checkpoints every ckpt_freq frames and meshes every mesh_freq
        frames, both again at the last frame (ref: src/Mapper.py:574-602;
        the JAX package's slam/system.py:827-893). ``params``: the scene to
        write (default: the mapper's; the async modes pass the published
        snapshot). The keyframes are read under the keyframe lock. The
        writer alone writes them (nothing here runs a collective)."""
        if not self.is_writer:
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


class _MapperLink:
    """What an async run's tracking thread shares with its mapper
    (``SLAMSystem._run_async``): the published scene snapshots by map index,
    the last mapped frame and whether the tracker read the newest snapshot,
    under one condition variable, and the first error of either side.

    ``submit`` hands the mapper a frame, ``fix_stale`` has the final map
    published, ``decision`` and ``enter`` add to and take a unit's record
    of the schedule, ``close`` and ``finish`` end the run.
    """

    def __init__(self, slam: SLAMSystem, start_idx: int, peers: Optional[Peers]):
        self.slam, self.peers = slam, peers
        self.cv = threading.Condition()
        # the seed snapshot is a copy too: on resume the tracker starts from
        # it while the first map job already updates the scene in place
        self.versions = {start_idx - 1: slam._snapshot_for_tracker()}
        self.published_idx = start_idx - 1
        # resume: everything before start_idx counts as mapped, so the loose
        # staleness gate can make progress
        self.last_mapped = start_idx - 1
        self.consumed = True  # has the tracker read the newest snapshot?
        self.error: Optional[BaseException] = None

    def publishes(self, midx: int) -> bool:
        """Publish on demand (the JAX gate): if the tracker never read the
        last snapshot, keep it (one map staler) unless it would fall
        ``2 * every_frame`` frames behind."""
        with self.cv:
            return self.consumed or midx - self.published_idx >= 2 * self.slam.every_frame

    def settle(self, midx: int, snap, mapped: bool = True) -> None:
        """Map ``midx`` is done (``mapped``) and published as ``snap``, or
        its publish skipped (``snap`` None). The caller holds ``cv`` or not."""
        with self.cv:
            if snap is not None:
                self.versions[midx] = snap
                self.published_idx = midx
                self.consumed = False
            if mapped:
                self.last_mapped = midx
            self.cv.notify_all()

    def fail(self, e: BaseException) -> BaseException:
        """Record ``e`` (this rank's, or the other rank's it echoes); what
        the run raises for it."""
        err = self.peers.failure(e) if self.peers is not None else e
        with self.cv:
            if self.error is None:
                self.error = err
            self.cv.notify_all()
        return err

    def wait(self, cond) -> None:
        """Block until ``cond()`` holds (read under ``cv``); raises the first
        error of either side, or another rank's."""
        with self.cv:
            while not cond() and self.error is None:
                self.cv.wait(timeout=0.05)
                if self.peers is not None:
                    self.peers.check()
            if self.error is not None:
                raise self.error

    def snapshot(self, read: Optional[int] = None):
        """Snapshot ``read`` (the index the lead read; default: the newest),
        marked read, its leaves recorded on this thread's stream; older
        snapshots are dropped."""
        with self.cv:
            if self.error is not None:
                raise self.error
            i = self.published_idx if read is None else read
            if i not in self.versions:
                raise RuntimeError(f"the schedule's replay diverged: the lead read snapshot {read}, this rank "
                                   f"holds {sorted(self.versions)}")
            self.consumed = True
            snap = self.versions[i]
            for k in [k for k in self.versions if k < i]:
                del self.versions[k]
        if self.slam.device.type == "cuda":
            here = torch.cuda.current_stream(self.slam.device)
            for leaf in tree_leaves(snap):
                leaf.record_stream(here)
        return snap

    def decision(self, decide) -> Dict[str, Any]:
        """The lead's record of a unit: ``decide()``, read under ``cv``."""
        with self.cv:
            return decide()

    def enter(self, rec: Dict[str, Any]) -> None:
        """Inside the unit of ``rec``, before its work."""

    def submit(self, idx: int, color, depth, gt_c2w, first: bool) -> None:
        raise NotImplementedError

    def fix_stale(self, idx: int) -> None:
        raise NotImplementedError

    def close(self, ok: bool) -> None:
        """Stop the mapper's side of this process (``ok``: the run ended
        without an error)."""

    def finish(self) -> None:
        """After ``close`` of a run that ended well: raise what failed late."""
        with self.cv:
            if self.error is not None:
                raise self.error


class _LocalMapper(_MapperLink):
    """The mapper on a worker thread of this process, taking jobs from a
    queue, on a CUDA stream of its own on the card. The hand-offs are
    ordered: the worker synchronizes its stream before it publishes a
    snapshot and before it releases the keyframe lock after a write, and
    the tracking thread records its stream on every snapshot leaf it reads
    (``snapshot``), so the caching allocator does not reuse a snapshot's
    memory while the tracker's kernels may still read it. With ``sched``
    (a shared dp group) each job is a unit of the schedule, its publish or
    skip decided at the grant."""

    def __init__(self, slam: SLAMSystem, start_idx: int, sched: Optional[UnitSchedule]):
        super().__init__(slam, start_idx, sched.peers if sched is not None else None)
        self.sched = sched
        cuda = slam.device.type == "cuda"
        self.stream = torch.cuda.Stream(slam.device) if cuda else None
        if cuda:
            # the worker's first job reads what this thread wrote (the
            # initial or resumed scene, the priors, the keyframe store)
            self.stream.wait_stream(torch.cuda.current_stream(slam.device))
        self.jobs: "queue.Queue" = queue.Queue()
        self.worker = threading.Thread(target=self._work, name="mapper", daemon=True)
        self.worker.start()

    def settle(self, midx: int, snap, mapped: bool = True) -> None:
        with self.cv:
            super().settle(midx, snap, mapped)
            if snap is not None:  # the tracker reads the newest alone
                for k in [k for k in self.versions if k < midx]:
                    del self.versions[k]

    def _publish(self, midx: int, publish: bool) -> None:
        slam = self.slam
        if not publish:
            self.settle(midx, None)
            slam._log_metrics({"event": "publish_skip", "idx": int(midx)})
            return
        t0 = time.time()
        snap = slam._snapshot_for_tracker()
        publish_s = time.time() - t0
        self.settle(midx, snap)
        slam._log_metrics({"event": "publish", "idx": int(midx), "publish_s": round(publish_s, 4)})

    def _work(self) -> None:
        slam, sched = self.slam, self.sched
        try:
            with torch.cuda.stream(self.stream) if self.stream is not None else contextlib.nullcontext():
                while True:
                    job = self.jobs.get()
                    if job is None:
                        return
                    midx, color, depth, gt_c2w, first = job
                    if sched is None:
                        slam._map_frame(midx, color, depth, slam.estimate_c2w_list[midx], gt_c2w, first=first)
                        slam._sync_stream()  # the map job's work is done before anyone reads it
                        self._publish(midx, self.publishes(midx))
                        continue
                    # one unit: the map and its publish or skip, decided at the grant
                    with sched.unit("map", midx, lambda: {"publish": self.publishes(midx)}) as rec:
                        slam._map_frame(midx, color, depth, slam.estimate_c2w_list[midx], gt_c2w, first=first)
                        self._publish(midx, rec["publish"])
        except BaseException as e:  # surfaced in the tracking thread
            self.fail(e)

    def submit(self, idx: int, color, depth, gt_c2w, first: bool) -> None:
        self.jobs.put((idx, color, depth, gt_c2w, first))

    def fix_stale(self, idx: int) -> None:
        self.settle(idx, self.slam._snapshot_for_tracker(), mapped=False)

    def close(self, ok: bool) -> None:
        self.jobs.put(None)
        self.worker.join(timeout=600)

    def finish(self) -> None:
        if self.worker.is_alive():
            raise RuntimeError("the mapper worker did not stop within 600 s")
        super().finish()


class _RemoteMapper(_MapperLink):
    """A split track rank's mapper: the map ranks (``SLAMSystem._run_split``).
    The track lead sends the jobs; a receiver thread takes map rank 0's
    reports in order and, for each publish, the scene's broadcast on the
    publish group (the lead answers each map's publish or skip by the JAX
    gate, the other track ranks read its answers). A unit's record also
    names the count of reports the lead had applied (``decision``), and a
    follower waits for those and for the snapshot the lead read before it
    applies them (``enter``). Snapshots stay until the tracker reads a
    newer one: a follower's receiver may run ahead of its tracker."""

    def __init__(self, slam: SLAMSystem, start_idx: int, sched: UnitSchedule, store):
        super().__init__(slam, start_idx, sched.peers)
        self.lead = sched.lead
        self.jobs, self.done, self.answers = (Channel(store, name, self.peers.check)
                                              for name in ("jobs", "done", "answers"))
        self.received: list = []  # map rank 0's reports, in order
        self.applied = 0
        self.sent = start_idx - 1  # the last frame whose tracked pose the map ranks have
        cuda = slam.device.type == "cuda"
        self.stream = torch.cuda.Stream(slam.device) if cuda else None
        if cuda:
            self.stream.wait_stream(torch.cuda.current_stream(slam.device))
        self.template = tree_leaves(slam.params)  # a broadcast scene's leaves take their shapes
        self.receiver = threading.Thread(target=self._receive, name="receiver", daemon=True)
        self.receiver.start()

    def _receive(self) -> None:
        """Map rank 0's reports in order, with each broadcast of the scene."""
        slam, g = self.slam, self.slam.groups
        sizes = [t.numel() for t in self.template]
        try:
            with torch.cuda.stream(self.stream) if self.stream is not None else contextlib.nullcontext():
                n_done = n_answers = 0
                while True:
                    msg = self.done.read(n_done)
                    n_done += 1
                    if msg["kind"] == "stop":
                        return
                    midx = int(msg["idx"])
                    publish = True  # the final fix-up
                    if msg["kind"] == "map":
                        for rec in msg["records"]:
                            slam._log_metrics(rec)
                        if self.lead:
                            publish = self.publishes(midx)
                            self.answers.append({"publish": publish})
                        else:
                            publish = bool(self.answers.read(n_answers)["publish"])
                        n_answers += 1
                    snap, t0 = None, time.time()
                    if publish:
                        flat = torch.empty(sum(sizes), device=slam.device)
                        dist.broadcast(flat, src=g.map_ranks[0], group=g.publish)
                        slam._sync_stream()
                        snap = tree_unflatten(slam.params, [p.view_as(t) for p, t in
                                                            zip(torch.split(flat, sizes), self.template)])
                    publish_s = time.time() - t0
                    with self.cv:
                        self.received.append(msg)
                        self.settle(midx, snap, mapped=msg["kind"] == "map")
                    if msg["kind"] == "map":
                        slam._log_metrics({"event": "publish", "idx": midx, "publish_s": round(publish_s, 4)}
                                          if publish else {"event": "publish_skip", "idx": midx})
        except BaseException as e:  # surfaced in the tracking thread
            self.fail(e)

    def decision(self, decide) -> Dict[str, Any]:
        with self.cv:
            return {**decide(), "applied": len(self.received)}

    def enter(self, rec: Dict[str, Any]) -> None:
        """Wait (a follower) until the receiver has the reports the lead had
        applied and the snapshot it read; apply them."""
        read = rec.get("read")
        self.wait(lambda: len(self.received) >= rec["applied"] and (read is None or read in self.versions))
        with self.cv:
            reports = self.received[self.applied: rec["applied"]]
        self.applied = rec["applied"]
        for msg in reports:
            self.slam._apply_report(msg)

    def submit(self, idx: int, color, depth, gt_c2w, first: bool) -> None:
        if not self.lead:
            return
        est = self.slam.estimate_c2w_list
        rows = [[t, est[t].tolist()] for t in range(self.sent + 1, idx + 1)]
        self.sent = idx
        self.jobs.append({"kind": "map", "idx": idx, "first": first, "rows": rows})

    def fix_stale(self, idx: int) -> None:
        if self.lead:
            self.jobs.append({"kind": "publish", "idx": idx})
        self.wait(lambda: self.published_idx >= idx)

    def close(self, ok: bool) -> None:
        if ok and self.lead:
            self.jobs.append({"kind": "stop"})
        self.receiver.join(timeout=600 if ok else 5)

    def finish(self) -> None:
        if self.receiver.is_alive():
            raise RuntimeError("the receiver did not stop within 600 s")
        super().finish()
        # the last published scene is this rank's map from here on
        self.slam.params = self.snapshot()
