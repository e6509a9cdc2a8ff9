"""Strict SLAM traffic: every frame tracked, every ``every_frame``-th frame
mapped over a window of the last ``mapping_window_size`` frames, mapping
done before the next frame is tracked (the system's ``sync_method:
strict``).

The program's agents are built as the system builds them, from the
configuration file: ``slam/tracker.py:Tracker`` and
``slam/mapper.py:Mapper`` (graphed on the card, as by default), one
``torch.Generator`` for both agents' pixel draws. A cycle is
``every_frame`` tracked frames and the map of the last. Frames come from a
generated pool on the device, cycled through in order; the sequence starts
at the first multiple of ``every_frame`` that fills a window, so every map
has a full window. The tracker's constant-speed start and the mapping
window read the generated poses, so random frames cannot drive the run out
of the bound.

Set-up builds the inputs and the agents and runs one cycle, which
captures the tracker's program and each mapping stage's. Where the
configuration gives the tracker the poses (``tracking.gt_camera``, as
ScanNet ships), ``Tracker.track`` hands each frame's given pose back and
runs nothing on the device.

After the window (and the traced cycle), ``collect`` drives the window's
own programs and entries from the seeded scene with seeded draws: three
iterations of each mapping stage on the warm-up map's window with a fresh
Adam state, reading Adam's state after the first, three tracking
iterations of the first tracked frame (and one, for its first gradient),
then one whole ``Mapper.optimize_map`` on that window, called as the window
calls it, and ``Tracker.track`` of that frame with the agent's iteration
count set to the check's three for that call. No step
is captured anew: a capture there would mean another program than the
window's.

"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np
import torch

from benchmark import generate
from benchmark.harness import sync
from benchmark.reference import compare
from benchmark.reference.steps import leaves
from benchmark.trace import own_kernels, span, summary, traced

GRIDS = ("grid_low", "grid_high", "grid_color")
ADAM_B1 = 0.9  # the program's Adam: its first moment after one step is (1 - b1) x the gradient


class Run:
    def __init__(self, cell):
        self.cell = cell
        self.dev = torch.device(cell.device)
        self.attempted = self.failed = 0
        self.marks = [("torch and the harness loaded", time.perf_counter())]  # the ends of set-up's phases

    # ------------------------------------------------------------ set-up

    def setup(self) -> None:
        from attentive_dfprior_tpu_torch.camera import Camera
        from attentive_dfprior_tpu_torch.models.scene import SceneConfig
        from attentive_dfprior_tpu_torch.render.renderer import RenderConfig
        from attentive_dfprior_tpu_torch.slam.mapper import Mapper
        from attentive_dfprior_tpu_torch.slam.tracker import Tracker

        self.marks.append(("program imported", time.perf_counter()))
        cfg, mix, seed, dev = self.cell.cfg, self.cell.mix, self.cell.seed, self.dev
        m = cfg["mapping"]
        self.every = int(m["every_frame"])
        self.F = int(m["mapping_window_size"])
        self.start = -(-self.F // self.every) * self.every
        self.pool = int(mix["frame_pool"])
        if self.pool < self.F:
            raise ValueError("the frame pool must hold a mapping window")
        self.cam = generate.camera(cfg)
        self.tsdf, self.bnds = generate.make_prior(cfg, seed, dev)
        self.scene = generate.make_scene(cfg, seed, dev)
        self.colors, self.depths = generate.make_frames(cfg, self.pool, tuple(mix["depth_m"]), seed, dev)
        self.depths_np = self.depths.cpu().numpy()
        self.poses = generate.trajectory(cfg, int(mix["max_frames"]), mix["trajectory"], seed)
        sync(dev)
        self.marks.append(("inputs made", time.perf_counter()))
        self.gen = generate.generator(seed, generate.DRAWS, dev)

        r = cfg["rendering"]
        rcfg = RenderConfig(N_samples=int(r["N_samples"]), N_surface=int(r["N_surface"]),
                            N_importance=int(r["N_importance"]), lindisp=bool(r["lindisp"]),
                            perturb=float(r["perturb"]), occupancy=bool(cfg.get("occupancy", True)))
        # the decoders stand in for the shipped prior: fix_high as shipped with it loaded
        scene_cfg = SceneConfig.from_config(cfg, pretrained_loaded=True)
        cam = Camera(**self.cam)
        self.mapper = Mapper(cfg, cam, scene_cfg, rcfg, self.tsdf, self.bnds, dev)
        self.tracker = Tracker(cfg, cam, rcfg, scene_cfg.bound, self.tsdf, self.bnds, dev)
        self.marks.append(("program built", time.perf_counter()))
        for t in [v for _, v in leaves(self.scene)]:
            t.requires_grad_(True)
        self.scene0 = [v.detach().clone() for _, v in leaves(self.scene)]

        self.idx = self.start
        self._cycle([], [])  # warm-up: every program captured
        self.check_map_idx = self.idx
        sync(dev)
        self.marks.append(("warm-up cycle", time.perf_counter()))

    def _load(self, values: List[torch.Tensor]) -> None:
        with torch.no_grad():
            for (_, t), v in zip(leaves(self.scene), values):
                t.copy_(v)

    def _window_frames(self, idx: int):
        ids = [(j % self.pool) for j in range(idx - self.F + 1, idx + 1)]
        sel = torch.as_tensor(ids, device=self.dev)
        return (self.colors.index_select(0, sel), self.depths.index_select(0, sel),
                self.poses[idx - self.F + 1: idx + 1])

    def _cycle(self, track_s: List[float], map_s: List[float]) -> bool:
        """One cycle from frame ``self.idx + 1``; False if an output was not
        finite."""
        ok = True
        for _ in range(self.every):
            self.idx += 1
            if self.idx >= len(self.poses):
                raise RuntimeError("the window ran past the mix's max_frames")
            k = self.idx % self.pool
            t0 = time.perf_counter()
            with span("Tracker.track"):
                c2w, loss = self.tracker.track(self.scene, self.idx, self.colors[k], self.depths[k],
                                               self.poses[self.idx], self.poses, generator=self.gen)
            track_s.append(time.perf_counter() - t0)
            ok = ok and bool(np.isfinite(c2w).all()) and bool(np.isfinite(loss))
        t0 = time.perf_counter()
        with span("Mapper.optimize_map"):
            _, losses, _, _ = self._map_call(self.idx)
        map_s.append(time.perf_counter() - t0)
        return ok and all(np.isfinite(v) for v in losses.values())

    def _map_call(self, idx: int):
        """``Mapper.optimize_map`` of frame ``idx``, as the window calls it."""
        fc, fd, fw = self._window_frames(idx)
        mp = self.mapper
        return mp.optimize_map(self.scene, mp.num_joint_iters, mp.lr_factor, idx, fc, fd, fw, generator=self.gen,
                               cur_depth_np=self.depths_np[idx % self.pool], cur_c2w_np=self.poses[idx])

    def collect(self) -> None:
        """The program's outputs for the check (the module's docstring)."""
        self.port = self._port_steps()

    def _port_steps(self) -> Dict[str, Any]:
        """The check's steps and calls through the window's own programs
        and entries."""
        from attentive_dfprior_tpu_torch.slam.mapper import StageLRs, mapping_stage

        mp, tr, g = self.mapper, self.tracker, self.mapper.graphs
        captures = (g.captures, tr.graphs.captures)
        n = int(self.cell.mix["check_steps"])
        base = generate.sub_seed(self.cell.seed, generate.CHECK)
        out: Dict[str, Any] = {"map": {}}
        # the whole call first: it copies the check's window and masks into the stages' static buffers
        self._load(self.scene0)
        self.gen.manual_seed(base + compare.MAP_CALL)
        _, _, _, stage_losses = self._map_call(self.check_map_idx)
        out["map_call"] = {"counts": {st: len(ls) for st, ls in stage_losses.items()},
                           "loss": [float(v) for v in torch.cat(list(stage_losses.values()))[:n].cpu()]}
        fc, fd, fw = g.buffers[("color", self.F)], g.buffers[("depth", self.F)], g.buffers[("c2w", self.F)]
        masks = {k: g.buffers[("frustum", k)] for k in GRIDS} if mp.frustum_feature_selection else None
        for i, stage in enumerate(mp.stage_lrs):
            self._load(self.scene0)
            state = g.adam("scene", self.scene)
            lrs = StageLRs(*[v * mp.lr_factor for v in mp.stage_lrs[stage]])
            self.gen.manual_seed(base + i)
            rec: Dict[str, Any] = {"loss": []}
            for steps in (1, n - 1):  # Adam's state read after the first
                ls = mapping_stage(self.scene, state, fc, fd, fw, masks, mp.tsdf_volume, mp.tsdf_bnds, mp.bound, steps,
                                   [0.0] * steps, lrs, stage, mp.mapping_pixels // self.F, mp.cam, mp.rcfg,
                                   (mp.scene_cfg.fix_high, mp.scene_cfg.fix_color), mp.w_color_loss,
                                   generator=self.gen, accum=mp.accum, grid_vjp=mp.grid_vjp, adam_lazy=mp.adam_lazy,
                                   shards=mp.shards, graphs=g)
                rec["loss"] += [float(v) for v in ls.cpu()]
                if steps == 1:
                    rec["grad"] = {nm: float(t.norm()) / (1 - ADAM_B1) for nm, t in leaves(state.m)}
            rec["change"] = {nm: float((t.detach() - v).norm()) for (nm, t), v in zip(leaves(self.scene), self.scene0)}
            out["map"][stage] = rec
        self._load(self.scene0)
        idx = self.start + 1
        k = idx % self.pool
        self.gen.manual_seed(base + compare.TRACK_CALL)
        iters, tr.num_cam_iters = tr.num_cam_iters, n  # the check's first steps, through the entry
        try:
            c2w, _ = tr.track(self.scene, idx, self.colors[k], self.depths[k], self.poses[idx], self.poses,
                              generator=self.gen)
        finally:
            tr.num_cam_iters = iters
        out["track_call"] = {"c2w": np.asarray(c2w, np.float64)}
        if not tr.gt_camera:
            out["track"] = self._track_steps(idx, base, n)
        self.gen.manual_seed(generate.sub_seed(self.cell.seed, generate.DRAWS))
        if (g.captures, tr.graphs.captures) != captures:
            raise RuntimeError("the check's steps captured a program anew: they must replay the window's")
        return out

    def _track_steps(self, idx: int, base: int, n: int) -> Dict[str, Any]:
        """The first tracked frame's first steps through the tracker's program."""
        from attentive_dfprior_tpu_torch.ops.pose import pose_tensor_from_matrix
        from attentive_dfprior_tpu_torch.slam.tracker import track_frame

        tr = self.tracker
        self._load(self.scene0)
        k = idx % self.pool
        t0 = torch.as_tensor(pose_tensor_from_matrix(tr.initial_pose(idx, self.poses)), device=self.dev)
        args = (self.tsdf, tr.tsdf_bnds, tr.bound, tr.cam, tr.rcfg, tr.tracking_pixels)
        rest = (tr.ignore_edge_W, tr.ignore_edge_H, tr.handle_dynamic, tr.use_color, tr.w_color_loss, tr.cam_lr,
                tr.seperate_LR, tr.lr_final_factor)
        self.gen.manual_seed(base + compare.TRACK)
        track_frame(self.scene, t0, self.colors[k], self.depths[k], *args, 1, *rest, generator=self.gen,
                    grid_vjp=tr.grid_vjp, adam_lazy=tr.adam_lazy, shards=tr.shards, graphs=tr.graphs)
        adam = next(reversed(tr.graphs.programs.values()))[1]  # the tracker program's Adam state
        grad = float(torch.cat([t.reshape(-1) for _, t in leaves(adam.m)]).norm()) / (1 - ADAM_B1)
        self.gen.manual_seed(base + compare.TRACK)
        _, losses, final, pre = track_frame(self.scene, t0, self.colors[k], self.depths[k], *args, n, *rest,
                                            generator=self.gen, grid_vjp=tr.grid_vjp, adam_lazy=tr.adam_lazy,
                                            shards=tr.shards, graphs=tr.graphs)
        # the tensor after each step: the next step's start, the last one's final
        tensors = [t.cpu().numpy() for t in pre[1:]] + [final.cpu().numpy()]
        return {"loss": [float(v) for v in losses.cpu()], "grad": grad, "tensors": tensors}

    # ------------------------------------------------------------ window

    def window(self, seconds: float) -> Dict[str, Any]:
        track_s: List[float] = []
        map_s: List[float] = []
        cycles = 0
        sync(self.dev)
        t0 = time.perf_counter()
        while True:
            if not self._cycle(track_s, map_s):
                self.failed += self.every
            cycles += 1
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        self.attempted = cycles * self.every
        return {"seconds": elapsed, "cycles": cycles, "frames": cycles * self.every, "track_s": track_s,
                "map_s": map_s}

    def trace(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        with traced(lambda: sync(self.dev), out):
            self._cycle([], [])
        res = summary(out)
        cfg = self.cell.cfg
        res.update({"device": out["device"], "cycles": 1, "own_kernels": own_kernels(out["device"]),
                    "map_iters": int(cfg["mapping"]["iters"]),
                    "track_iters": 0 if self.tracker.gt_camera else self.every * int(cfg["tracking"]["iters"])})
        return res

    def release(self) -> None:
        self.mapper = self.tracker = None
        self.scene = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ check

    def check(self) -> Dict[str, float]:
        return compare.strict_numbers(self, tf32=False)
