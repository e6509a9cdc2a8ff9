"""Final-refine traffic: the last call of a real-tracking run,
``LoopCloser.final_refine``, which re-localizes every recorded trajectory
entry against the finished map; here a block of consecutive entries a
unit.

The program's agents are built as ``SLAMSystem`` builds them from the
configuration file: a ``Tracker`` (graphed on the card, as by default), a
``KeyframeStore`` of the run's capacity and the ``LoopCloser`` over them,
with one ``torch.Generator`` for the pixel draws. The map is the seeded
scene: the refine reads it detached, and its cost does not depend on its
values. The trajectory is ``n_frames`` generated poses inside the bound;
the recorded estimates are each pose with a seeded perturbation (a
translation of ``perturb_cm`` centimetres in a random direction, a
rotation of up to ``perturb_deg`` degrees about a random axis), entry 0
exact. Frames come from a dataset stand-in whose ``dataset[t]`` hands back
fresh host copies of a seeded pool, as the synthetic dataset hands back
copies of its rendered frames, so each frame's read and its copy to the
card are in the timed path.

A unit is one ``final_refine(dataset, estimates, scene, b, b + block,
generator)``, the system's own call: the blocks 1 .. block, block + 1 ..
2 x block, ... cover entries 1 .. n_frames - 1 and are cycled in order,
each block's recorded estimates restored before its call, so every unit
asks the same work. Set-up builds the inputs and the agents and refines one
entry, which captures the tracker's program; ``trace`` runs the next
block's first ``traced_entries`` entries under the profiler.

The check, from the seeded scene with seeded draws through the window's
program (a capture there raises), with ``LoopCloser.refine_iters`` set to
the mix's ``check_iters`` (3) for the calls, against
``benchmark/reference/refine.py``, over the check's block: entries 0 .. 9
of the recorded estimates with entry 5 made non-finite, so entries 1-4 and
6-9 are re-localized. The seeded scene's field is rough: on a few entries
in ten a ray crossing the dynamic-pixel cut or a sample crossing the
bound's wall on round-off moves a step by a percent, on either side and
in the TF32 control alike. So the continuous numbers are each the median
over the block's eight entries, and an entry left out is caught exactly
by ``refine_skip``:

  - ``refine_pose``: ``final_refine`` over the block; each written-back
    pose against the reference's, by ``compare.py``'s pose gap (over the
    reference's motion from the recorded pose);
  - ``refine_clamp``: the same with the trust region set to the mix's
    ``check_trust`` (metres, degrees), which the check's motion passes, so
    the clamp binds;
  - ``refine_loss``: ``LoopCloser._relocalize`` of each entry in turn, the
    worse of its first two losses (each taken before its step),
    |program - reference| over |reference|: the third is taken after two
    Adam steps, by which round-off has grown some 40-fold a step;
  - ``refine_final``: the camera tensor each of those re-localizations ends
    at, read from the tracker program's camera buffer after the call: the
    median over its seven components of the gap to the reference's, over
    the median component's change from the start (``compare.py``'s
    ``track_change`` rule). Of three iterations the third runs at
    ``factor ** 0.5`` of the rate, which no loss sees and the kept
    candidate shows only where the last step's is kept: this number sees
    the decay and the iteration count on every entry. Later iterations are
    not compared, for the same growth;
  - ``refine_skip``: exact 0: entries 0 and 5 left bit for bit by the first
    call, every other entry of the block moved, and where the program keeps
    the counters, 8 re-localized and 1 skipped.

``tf32`` puts the reference in TF32 in the program's place (the control);
the faults (``FAULTS``) put a reference with the fault in its place:
half of the rays (the loss scaled to the whole), one iteration more, a
constant rate, the clamp skipped.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np
import torch

from benchmark import generate
from benchmark.harness import sync
from benchmark.reference import refine
from benchmark.reference.compare import _pose_gap, _rel
from benchmark.reference.steps import leaves, pose_tensor, precision, rebuild
from benchmark.trace import own_kernels, span, summary, traced

PERTURB = 6  # the estimates' sub-seed stream, after generate's
CHECK_BLOCK = (0, 10)  # final_refine(start_idx, n) of the check
BAD = 5  # the check's non-finite entry
MOVED = [t for t in range(max(CHECK_BLOCK[0], 1), CHECK_BLOCK[1]) if t != BAD]  # the entries re-localized
LOSSES = 2  # the losses of each entry compared (module docstring)
FAULTS = ("half", "extra_iter", "constant_rate", "no_clamp")


class Frames:
    """The dataset stand-in: ``dataset[t]`` is (t, colour (H, W, 3), depth
    (H, W), pose), the frames fresh numpy copies of pool frame t mod the
    pool's size."""

    def __init__(self, colors: np.ndarray, depths: np.ndarray, poses: np.ndarray):
        self.colors, self.depths, self.poses = colors, depths, poses

    def __len__(self) -> int:
        return len(self.poses)

    def __getitem__(self, t: int):
        k = t % len(self.colors)
        return t, self.colors[k].copy(), self.depths[k].copy(), self.poses[t]


def perturbed(poses: np.ndarray, cm, deg: float, seed: int) -> np.ndarray:
    """Each pose but the first moved by ``cm`` [lo, hi) centimetres in a
    random direction and turned by up to ``deg`` degrees about a random
    axis (float64 arithmetic), float32."""
    rng = np.random.default_rng(generate.sub_seed(seed, PERTURB))
    est = np.asarray(poses, dtype=np.float64).copy()
    for t in range(1, len(est)):
        d = rng.normal(size=3)
        est[t, :3, 3] += d / np.linalg.norm(d) * rng.uniform(cm[0], cm[1]) / 100.0
        a = rng.normal(size=3)
        a /= np.linalg.norm(a)
        K = np.array([[0.0, -a[2], a[1]], [a[2], 0.0, -a[0]], [-a[1], a[0], 0.0]])
        ang = np.deg2rad(rng.uniform(0.0, deg))
        est[t, :3, :3] = (np.eye(3) + np.sin(ang) * K + (1.0 - np.cos(ang)) * (K @ K)) @ est[t, :3, :3]
    return est.astype(np.float32)


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
        from attentive_dfprior_tpu_torch.slam.keyframes import KeyframeStore
        from attentive_dfprior_tpu_torch.slam.loop_closure import LoopCloser
        from attentive_dfprior_tpu_torch.slam.tracker import Tracker

        self.marks.append(("program imported", time.perf_counter()))
        cfg, mix, seed, dev = self.cell.cfg, self.cell.mix, self.cell.seed, self.dev
        n = int(cfg["data"]["n_frames"])
        self.block = int(mix["block"])
        self.blocks = list(range(1, n, self.block))
        self.cam = generate.camera(cfg)
        self.tsdf, self.bnds = generate.make_prior(cfg, seed, dev)
        self.scene = generate.make_scene(cfg, seed, dev)
        colors, depths = generate.make_frames(cfg, int(mix["frame_pool"]), tuple(mix["depth_m"]), seed, dev)
        self.poses = generate.trajectory(cfg, n, mix["trajectory"], seed)
        self.dataset = Frames(colors.cpu().numpy(), depths.cpu().numpy(), self.poses)
        self.recorded = perturbed(self.poses, mix["perturb_cm"], float(mix["perturb_deg"]), seed)
        self.est = self.recorded.copy()
        sync(dev)
        self.marks.append(("inputs made", time.perf_counter()))
        self.gen = generate.generator(seed, generate.DRAWS, dev)

        r = cfg["rendering"]
        rcfg = RenderConfig(N_samples=int(r["N_samples"]), N_surface=int(r["N_surface"]),
                            N_importance=int(r["N_importance"]), lindisp=bool(r["lindisp"]),
                            perturb=float(r["perturb"]), occupancy=bool(cfg.get("occupancy", True)))
        scene_cfg = SceneConfig.from_config(cfg, pretrained_loaded=True)
        cam = Camera(**self.cam)
        m = cfg["mapping"]
        cap = int(m.get("keyframe_capacity", max(8, n // int(m["keyframe_every"]) + 4)))
        self.keyframes = KeyframeStore(cap, cam.H, cam.W, dev)
        self.tracker = Tracker(cfg, cam, rcfg, scene_cfg.bound, self.tsdf, self.bnds, dev)
        self.closer = LoopCloser(cfg, self.tracker, self.keyframes, cam, rcfg, scene_cfg.bound, self.tsdf, self.bnds)
        if not self.closer.final_refine_on:
            raise ValueError("the configuration's loop_closure.final_refine is off")
        self.marks.append(("program built", time.perf_counter()))
        # the map as the mapper leaves it: leaves that take gradients (the refine reads them detached)
        for t in [v for _, v in leaves(self.scene)]:
            t.requires_grad_(True)
        self.scene0 = [v.detach() for _, v in leaves(self.scene)]

        self._refine(1, 2)  # warm-up: one entry, which captures the tracker's program
        self.est[:] = self.recorded
        self.unit = 0
        sync(dev)
        self.marks.append(("warm-up entry", time.perf_counter()))

    def _refine(self, start: int, n: int) -> bool:
        """``final_refine`` of entries start .. n - 1, their recorded
        estimates restored first; False if a written pose is not finite."""
        self.est[start:n] = self.recorded[start:n]
        with span("LoopCloser.final_refine"):
            self.closer.final_refine(self.dataset, self.est, self.scene, start, n, self.gen)
        return bool(np.isfinite(self.est[start:n]).all())

    def _next_block(self):
        b = self.blocks[self.unit % len(self.blocks)]
        self.unit += 1
        return b, min(b + self.block, len(self.poses))

    # ------------------------------------------------------------ window

    def window(self, seconds: float) -> Dict[str, Any]:
        unit_s: List[float] = []
        frames = 0
        sync(self.dev)
        t0 = time.perf_counter()
        while True:
            b, e = self._next_block()
            t1 = time.perf_counter()
            if not self._refine(b, e):
                self.failed += e - b
            unit_s.append(time.perf_counter() - t1)
            frames += e - b
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        self.attempted = frames
        return {"seconds": elapsed, "units": len(unit_s), "frames": frames, "unit_s": unit_s}

    def trace(self) -> Dict[str, Any]:
        b, e = self._next_block()
        e = min(e, b + int(self.cell.mix["traced_entries"]))
        out: Dict[str, Any] = {}
        with traced(lambda: sync(self.dev), out):
            self._refine(b, e)
        res = summary(out)
        iters = self.closer.refine_iters
        res.update({"device": out["device"], "own_kernels": own_kernels(out["device"]), "frames": e - b,
                    "iters": int(iters) if iters is not None else self.tracker.num_cam_iters})
        return res

    # ------------------------------------------------------------ check

    def collect(self) -> None:
        """The program's outputs for the check (the module's docstring)."""
        lc, g = self.closer, self.tracker.graphs
        captures = g.captures
        mix = self.cell.mix
        base = generate.sub_seed(self.cell.seed, generate.CHECK)
        start, n = CHECK_BLOCK
        est = self.recorded.copy()
        est[BAD] = np.nan
        kept = (lc.refine_iters, lc.refine_max_dt, lc.refine_max_rot_deg)
        counters = [getattr(lc, k, None) for k in ("refined", "skipped")]
        self.port: Dict[str, Any] = {"start": est.copy()}
        lc.refine_iters = int(mix["check_iters"])
        try:
            self.gen.manual_seed(base)
            out = est.copy()
            lc.final_refine(self.dataset, out, self.scene, start, n, self.gen)
            self.port["pose"] = out
            if None not in counters:
                self.port["counts"] = (lc.refined - counters[0], lc.skipped - counters[1])
            lc.refine_max_dt, lc.refine_max_rot_deg = (float(v) for v in mix["check_trust"])
            self.gen.manual_seed(base + 1)
            out = est.copy()
            lc.final_refine(self.dataset, out, self.scene, start, n, self.gen)
            self.port["clamp"] = out
            self.gen.manual_seed(base + 2)
            self.port["loss"], self.port["final"] = [], []
            for t in MOVED:
                _, color, depth, _ = self.dataset[t]
                _, losses = lc._relocalize(self.scene, color, depth, est[t], lc.refine_iters, self.gen)
                self.port["loss"].append([float(v) for v in losses.cpu()])
                cams = next(reversed(g.programs.values()))[0]  # the program's camera tensor: where the call ended
                self.port["final"].append(torch.cat(list(cams.values())).detach().cpu().numpy())
        finally:
            lc.refine_iters, lc.refine_max_dt, lc.refine_max_rot_deg = kept
        self.gen.manual_seed(generate.sub_seed(self.cell.seed, generate.DRAWS))
        if g.captures != captures:
            raise RuntimeError("the check's calls captured a program anew: they must replay the window's")

    def release(self) -> None:
        self.closer = self.tracker = self.keyframes = None
        self.scene = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> Dict[str, float]:
        return numbers(self)


# ---------------------------------------------------------------- the comparison


def reference_outputs(run, tf32: bool = False, fault: str = "") -> Dict[str, Any]:
    """The reference's outputs of the check's calls, in the format
    ``Run.collect`` records the program's; ``fault`` one of ``FAULTS``."""
    cfg, mix, dev = run.cell.cfg, run.cell.mix, run.dev
    opts = dict(refine.options(cfg), iters=int(mix["check_iters"]))
    if fault == "extra_iter":
        opts["iters"] += 1
    if fault == "constant_rate":
        opts["factor"] = 1.0
    batch = slice(0, None, 2) if fault == "half" else None
    scene = rebuild(generate.scene_specs(cfg), run.scene0)
    bound = torch.as_tensor(generate.scene_bound(cfg), dtype=torch.float32, device=dev)
    args = (run.tsdf, torch.as_tensor(run.bnds, device=dev), bound, run.cam, cfg["rendering"])

    def frame(t):
        _, c, d, _ = run.dataset[t]
        return torch.as_tensor(c, device=dev), torch.as_tensor(d, device=dev)

    base = generate.sub_seed(run.cell.seed, generate.CHECK)
    start, n = CHECK_BLOCK
    est = run.recorded.copy()
    est[BAD] = np.nan
    out: Dict[str, Any] = {"start": est, "t0": [pose_tensor(est[t]) for t in MOVED], "loss": [], "final": []}
    with precision(tf32):
        gen = torch.Generator(device=dev).manual_seed(base)
        out["pose"], refined, skipped = refine.refine_block(scene, est, frame, gen, start, n, opts, *args, batch)
        out["counts"] = (refined, skipped)
        dt, deg = (float(v) for v in mix["check_trust"])
        tight = dict(opts, max_dt=dt, max_rot=float(np.deg2rad(deg)))
        gen = torch.Generator(device=dev).manual_seed(base + 1)
        out["clamp"], _, _ = refine.refine_block(scene, est, frame, gen, start, n, tight, *args, batch,
                                                 trust=fault != "no_clamp")
        gen = torch.Generator(device=dev).manual_seed(base + 2)
        for t in MOVED:
            color, depth = frame(t)
            _, losses, final = refine.relocalize(scene, est[t], color, depth, gen, opts["iters"], opts["lr"],
                                                 opts["factor"], *args, opts["pixels"], opts["edge_w"], opts["edge_h"],
                                                 opts["w_color"], batch)
            out["loss"].append(losses)
            out["final"].append(final)
    return out


def _change_gap(side, ref, t0) -> float:
    """``compare.py``'s ``track_change`` rule: the median component's gap
    over the median component's change from ``t0``."""
    t0 = np.asarray(t0, np.float64)
    dp, dr = np.asarray(side, np.float64) - t0, np.asarray(ref, np.float64) - t0
    return float(np.median(np.abs(dp - dr)) / max(float(np.median(np.abs(dr))), 1e-30))


def gaps(side: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, float]:
    start = ref["start"]
    pose = [_pose_gap(side["pose"][t], ref["pose"][t], start[t]) for t in MOVED]
    clamp = [_pose_gap(side["clamp"][t], ref["clamp"][t], start[t]) for t in MOVED]
    loss = [max(_rel(a, b) for a, b in zip(s[:LOSSES], r[:LOSSES])) for s, r in zip(side["loss"], ref["loss"])]
    final = [_change_gap(s, r, t0) for s, r, t0 in zip(side["final"], ref["final"], ref["t0"])]
    kept = [t for t in range(CHECK_BLOCK[1]) if t not in MOVED]  # entry 0 and the non-finite entry
    skip = sum(side["pose"][t].tobytes() != start[t].tobytes() for t in kept)
    skip += sum(side["pose"][t].tobytes() == start[t].tobytes() for t in MOVED)
    if "counts" in side:
        skip += sum(abs(a - b) for a, b in zip(side["counts"], ref["counts"]))
    return {"refine_pose": float(np.median(pose)), "refine_clamp": float(np.median(clamp)),
            "refine_loss": float(np.median(loss)), "refine_final": float(np.median(final)),
            "refine_skip": float(skip)}


def numbers(run, tf32: bool = False, fault: str = "") -> Dict[str, float]:
    """The program's gaps to the reference; with ``tf32`` or ``fault`` those
    of the reference so computed, put in the program's place."""
    ref = reference_outputs(run)
    side = reference_outputs(run, tf32=tf32, fault=fault) if (tf32 or fault) else run.port
    return gaps(side, ref)
