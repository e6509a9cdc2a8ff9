"""Render traffic: full frames of the seeded scene from the trajectory's
poses, each with its frame's depth, as the system's Visualizer asks for
them (``render/renderer.py:Renderer.render_img``, stage ``color``, the
depth on the host, the outputs taken to the host). On the card every chunk
of ``ray_batch_size`` rays replays one captured program
(``utils/step_graph.py:ForwardGraphs``) with K2 inside.

Set-up builds the inputs and the renderer and renders one frame, which
captures the chunk's program. The window renders whole frames; the check
renders a sample of them, drawn from the seed, with the plain reference.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from benchmark import generate
from benchmark.harness import sync
from benchmark.reference import compare
from benchmark.reference.steps import leaves
from benchmark.trace import own_kernels, span, summary, traced


class Run:
    def __init__(self, cell):
        self.cell = cell
        self.dev = torch.device(cell.device)
        self.attempted = self.failed = 0
        self.marks = [("torch and the harness loaded", time.perf_counter())]  # the ends of set-up's phases
        self.outputs: List[Tuple[int, np.ndarray, np.ndarray]] = []

    def setup(self) -> None:
        from attentive_dfprior_tpu_torch.camera import Camera
        from attentive_dfprior_tpu_torch.render.renderer import RenderConfig, Renderer
        from attentive_dfprior_tpu_torch.utils.step_graph import ForwardGraphs

        self.marks.append(("program imported", time.perf_counter()))
        cfg, mix, seed, dev = self.cell.cfg, self.cell.mix, self.cell.seed, self.dev
        self.pool = int(mix["frame_pool"])
        self.chunk = int(mix["ray_batch_size"])
        self.cam = generate.camera(cfg)
        self.tsdf, self.bnds = generate.make_prior(cfg, seed, dev)
        self.scene = generate.make_scene(cfg, seed, dev)
        self.scene0 = [v for _, v in leaves(self.scene)]
        self.colors, self.depths = generate.make_frames(cfg, self.pool, tuple(mix["depth_m"]), seed, dev)
        self.depths_np = self.depths.cpu().numpy()
        self.poses = generate.trajectory(cfg, int(mix["max_frames"]), mix["trajectory"], seed)
        sync(dev)
        self.marks.append(("inputs made", time.perf_counter()))
        r = cfg["rendering"]
        rcfg = RenderConfig(N_samples=int(r["N_samples"]), N_surface=int(r["N_surface"]),
                            N_importance=int(r["N_importance"]), lindisp=bool(r["lindisp"]),
                            perturb=float(r["perturb"]), occupancy=bool(cfg.get("occupancy", True)))
        self.renderer = Renderer(rcfg, generate.scene_bound(cfg), self.bnds, Camera(**self.cam), dev,
                                 ray_batch_size=self.chunk, graphs=ForwardGraphs(None, dev))
        self.marks.append(("program built", time.perf_counter()))
        self.idx = 0
        self._frame()  # warm-up: the chunk's program captured
        self.outputs.clear()
        sync(dev)
        self.marks.append(("warm-up frame", time.perf_counter()))

    def _frame(self) -> bool:
        idx, self.idx = self.idx, self.idx + 1
        if idx >= len(self.poses):
            raise RuntimeError("the window ran past the mix's max_frames")
        with span("Renderer.render_img"):
            depth, _, color = self.renderer.render_img(self.scene, self.poses[idx], self.tsdf, stage="color",
                                                       gt_depth=self.depths_np[idx % self.pool])
            d, c = depth.cpu().numpy(), color.cpu().numpy()
        self.outputs.append((idx, d, c))
        return bool(np.isfinite(d).all() and np.isfinite(c).all())

    def window(self, seconds: float) -> Dict[str, Any]:
        frames = 0
        sync(self.dev)
        t0 = time.perf_counter()
        while True:
            if not self._frame():
                self.failed += 1
            frames += 1
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        self.attempted = frames
        return {"seconds": elapsed, "frames": frames}

    def trace(self) -> Dict[str, Any]:
        n = int(self.cell.mix["traced_frames"])
        keep = len(self.outputs)
        out: Dict[str, Any] = {}
        with traced(lambda: sync(self.dev), out):
            for _ in range(n):
                self._frame()
        del self.outputs[keep:]
        res = summary(out)
        chunks = -(-self.cam["H"] * self.cam["W"] // self.chunk)
        res.update({"device": out["device"], "own_kernels": own_kernels(out["device"]), "frames": n,
                    "chunks": n * chunks, "chunk_rays": self.chunk})
        return res

    def collect(self) -> None:
        """The window recorded every frame's outputs: nothing more to run."""

    def release(self) -> None:
        self.renderer = None
        self.scene = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> Dict[str, float]:
        return compare.render_numbers(self)
