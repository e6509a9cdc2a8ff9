"""Loop closure: revisit-gated keyframe relaxation and a final trajectory
refine against the converged map.

The port of the JAX package's ``slam/loop_closure.py``, a framework
extension: the reference has no loop closure or pose graph
(src/Mapper.py:262-484 optimizes the scene only; src/Tracker.py never
revises a past pose). Two mechanisms:

1. **Keyframe relaxation** (``loop_closure.enable``): when the current
   view overlaps an old keyframe above a gate (a revisit, scored with the
   mapping window's reprojection metric,
   ``keyframes.keyframe_overlap_scores``), every keyframe is re-localized
   against the frozen current map with the tracker's ``track_frame``.
   Write-backs go through the trust-region clamp, and each non-keyframe
   entry of the trajectory takes the correction of its nearest keyframe.
2. **Final refine** (``loop_closure.final_refine``): after the last mapped
   frame, every trajectory entry is re-localized against the final map,
   starting from its recorded pose.

Frame 0, whose pose is ground truth by construction (ref:
src/Tracker.py:186-188), is never moved. Re-localization reads the scene
detached, so it launches neither K1 nor K2.

Spans (``utils/profiling.py``): ``LoopCloser.final_refine`` (start, n,
frames re-localized) and ``LoopCloser.relax`` (idx, keyframes) hold one
``LoopCloser.relocalize`` (frame, iters) an entry or keyframe, which holds
``LoopCloser.frame_in`` (the frame read and copied to the device), the
tracker's ``Tracker.inputs`` and ``StepGraph.replay`` x iters, and
``LoopCloser.pose_to_host`` (the wait for the pose and its clamp to the
trust region; the write-back follows it). Counters: ``refined`` and ``skipped`` (the final refine's
entries re-localized, and those left as they were for a non-finite pose),
``relocalizations`` (both mechanisms) and ``relaxations``.

Under ray-axis data parallelism re-localization runs ``track_frame`` on a
dp group: the final refine on the tracker's, the relaxation on the group
its caller names (the mapper's in the async modes, which relax on the
mapper's thread or ranks). Its decisions (the overlap scores, the
``min_gap`` keyframes, the relaxation interval) come from replicated state,
so every rank takes the same branch and issues the same collectives.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from attentive_dfprior_tpu_torch.ops.pose import (
    clamp_pose_update,
    homogenize,
    pose_matrix_from_tensor,
    pose_tensor_from_matrix,
)
from attentive_dfprior_tpu_torch.slam.keyframes import keyframe_overlap_scores
from attentive_dfprior_tpu_torch.slam.tracker import track_frame
from attentive_dfprior_tpu_torch.utils.profiling import span


def propagate_corrections(
    estimate_c2w_list: np.ndarray,
    kf_frames: np.ndarray,
    old_poses: np.ndarray,
    new_poses: np.ndarray,
    idx: int,
) -> None:
    """Distribute keyframe pose corrections to the trajectory in place.

    Keyframe entries get their new pose; every other frame 1 <= t <= idx
    gets the left-composed delta (new @ old^-1, in float64) of its nearest
    keyframe, so frames follow the keyframe whose local map anchored them.
    Frame 0 is never touched.
    """
    kf_lookup = {int(f): s for s, f in enumerate(kf_frames)}
    deltas = np.einsum(
        "kij,kjl->kil", new_poses.astype(np.float64), np.linalg.inv(old_poses.astype(np.float64))
    )
    for t in range(1, idx + 1):
        slot = kf_lookup.get(t)
        if slot is not None:
            estimate_c2w_list[t] = new_poses[slot]
        else:
            nearest = int(np.argmin(np.abs(kf_frames - t)))
            estimate_c2w_list[t] = (deltas[nearest] @ estimate_c2w_list[t].astype(np.float64)).astype(np.float32)


class LoopCloser:
    """Host-side loop-closure agent driving the tracker's re-localization.

    Pixel draws come from the ``generator`` passed to each call; the
    ``pixel_idx`` arguments replay given draws instead (the tests feed the
    JAX package's), as in ``track_frame``.
    """

    def __init__(
        self,
        cfg: Dict[str, Any],
        tracker,
        keyframes,
        cam,
        rcfg,
        bound,
        tsdf_volume: Optional[torch.Tensor],
        tsdf_bnds,
        log_fn=None,
    ):
        lc = cfg.get("loop_closure", {}) or {}
        self.enable = bool(lc.get("enable", False))
        self.final_refine_on = bool(lc.get("final_refine", False))
        # dataset-frame distance between relaxations, and the minimum
        # dataset-frame age for a keyframe to count as a revisit target
        self.every = int(lc.get("every", 20))
        self.min_gap = int(lc.get("min_gap", 20))
        # the scorer keeps the reference's 20 px edge margin (ref:
        # src/Mapper.py:204-215), so the best score is the margin-interior
        # fraction, ~0.73 on a 320x240 camera: the gate must sit below it
        self.overlap_gate = float(lc.get("overlap_gate", 0.6))
        # re-localization budgets; None -> the tracker's
        self.kf_iters = lc.get("kf_iters")
        self.refine_iters = lc.get("refine_iters")
        self.lr = lc.get("lr")
        # trust regions: tight while relaxing mid-run (like BA), wide in the
        # final refine (it corrects 15-20 cm excursions)
        self.max_dt = float(lc.get("max_dt", 0.03))
        self.max_rot_deg = float(lc.get("max_rot_deg", 1.5))
        self.refine_max_dt = float(lc.get("refine_max_dt", 0.5))
        self.refine_max_rot_deg = float(lc.get("refine_max_rot_deg", 10.0))

        self.tracker = tracker
        self.keyframes = keyframes
        self.cam = cam
        self.rcfg = rcfg
        device = tracker.device if tracker is not None else torch.device("cpu")
        self.bound = torch.as_tensor(np.asarray(bound), dtype=torch.float32, device=device)
        self.tsdf_volume = tsdf_volume
        self.tsdf_bnds = torch.as_tensor(np.asarray(tsdf_bnds), dtype=torch.float32, device=device)
        self._log = log_fn or (lambda rec: None)
        self._last_relax = -(10**9)
        self._rng = np.random.default_rng(1234)
        self.refined = self.skipped = self.relocalizations = self.relaxations = 0

    # ------------------------------------------------------------------

    def _frame_in(self, color, depth):
        """A frame's colour and depth as float32 tensors on the tracker's
        device (copies from the host, or the tensors themselves)."""
        dev = self.tracker.device
        return (torch.as_tensor(color, dtype=torch.float32, device=dev),
                torch.as_tensor(depth, dtype=torch.float32, device=dev))

    def _relocalize(
        self,
        params: Any,
        color,
        depth,
        init_c2w: np.ndarray,
        n_iters: int,
        generator: Optional[torch.Generator] = None,
        pixel_idx: Optional[torch.Tensor] = None,
        shards=None,
        graphs=None,
        trust: Optional[Tuple[float, float]] = None,
    ):
        """One frozen-map re-localization from ``init_c2w`` on ``shards``
        (default: the tracker's dp group), its iteration replayed from
        ``graphs`` (the calling agent's ``StepGraphs``; default: the
        tracker's); returns (c2w (4, 4) float32, per-iteration losses).
        ``trust``: (metres, radians), the trust region the pose is clamped
        to about ``init_c2w`` (``clamp_pose_update``); None returns it as
        tracked."""
        t = self.tracker
        self.relocalizations += 1
        cam_tensor = torch.as_tensor(pose_tensor_from_matrix(init_c2w), device=t.device)
        color, depth = self._frame_in(color, depth)
        best, losses, _, _ = track_frame(
            params, cam_tensor, color, depth,
            self.tsdf_volume, self.tsdf_bnds, self.bound, self.cam, self.rcfg,
            t.tracking_pixels, int(n_iters), t.ignore_edge_W, t.ignore_edge_H,
            t.handle_dynamic, t.use_color, t.w_color_loss,
            float(self.lr) if self.lr is not None else t.cam_lr,
            t.seperate_LR, t.lr_final_factor, generator, pixel_idx, t.grid_vjp, t.adam_lazy,
            t.shards if shards is None else shards, graphs=t.graphs if graphs is None else graphs,
        )
        with span("LoopCloser.pose_to_host"), torch.no_grad():  # waits for the device
            c2w = homogenize(pose_matrix_from_tensor(best)).cpu().numpy().astype(np.float32)
            if trust is not None:
                c2w = clamp_pose_update(init_c2w, c2w, *trust)
        return c2w, losses

    # ------------------------------------------------------------------

    def detect_revisit(self, idx: int, depth_np: np.ndarray, c2w: np.ndarray):
        """Does the current view re-observe an old keyframe's region?

        Returns the (slot, score) of the best keyframe at least ``min_gap``
        frames old whose score reaches the gate, else None.
        """
        K = len(self.keyframes)
        if K == 0:
            return None
        scores = keyframe_overlap_scores(
            self._rng, depth_np, c2w, self.keyframes.poses_np(),
            self.cam.H, self.cam.W, self.cam.fx, self.cam.fy, self.cam.cx, self.cam.cy,
        )
        best = None
        for slot in range(K):
            if idx - self.keyframes.frame_idx[slot] < self.min_gap:
                continue
            if scores[slot] >= self.overlap_gate and (best is None or scores[slot] > best[1]):
                best = (slot, float(scores[slot]))
        return best

    def maybe_relax(
        self,
        idx: int,
        depth_np: np.ndarray,
        c2w: np.ndarray,
        estimate_c2w_list: np.ndarray,
        params: Any,
        generator: Optional[torch.Generator] = None,
        pixel_idx: Optional[Dict[int, torch.Tensor]] = None,
        kf_lock=None,
        shards=None,
        graphs=None,
    ) -> bool:
        """Revisit-gated keyframe relaxation (mechanism 1); returns whether
        it ran. ``pixel_idx``: optional {keyframe slot: (iters, pixels)}.
        ``kf_lock``: held around the keyframe poses' read and write (the
        async modes' main thread reads them for its side outputs).
        ``shards``: the dp group of the re-localizations (default: the
        tracker's); ``graphs``: the ``StepGraphs`` they replay from (the
        agent whose thread runs them; default: the tracker's)."""
        if not self.enable or idx - self._last_relax < self.every:
            return False
        hit = self.detect_revisit(idx, depth_np, c2w)
        if hit is None:
            return False
        self._last_relax = idx
        t0 = time.time()
        lock = kf_lock if kf_lock is not None else contextlib.nullcontext()
        with lock:
            K = len(self.keyframes)
            old_poses = self.keyframes.poses_np().copy()
        new_poses = old_poses.copy()
        n_it = int(self.kf_iters) if self.kf_iters is not None else self.tracker.num_cam_iters
        max_rot = float(np.deg2rad(self.max_rot_deg))
        moved = 0
        self.relaxations += 1
        with span("LoopCloser.relax", idx=int(idx), keyframes=K):
            for slot in range(K):
                frame = int(self.keyframes.frame_idx[slot])
                if frame == 0:
                    continue  # ground truth by construction
                with span("LoopCloser.relocalize", frame=frame, iters=n_it):
                    with span("LoopCloser.frame_in"):
                        color, depth = self._frame_in(self.keyframes.color[slot], self.keyframes.depth[slot])
                    new_poses[slot], _ = self._relocalize(
                        params, color, depth, old_poses[slot], n_it, generator,
                        None if pixel_idx is None else pixel_idx[slot], shards, graphs, (self.max_dt, max_rot),
                    )
                if not np.allclose(new_poses[slot], old_poses[slot]):
                    moved += 1
        with lock:
            for slot in range(K):
                self.keyframes.update_pose(slot, new_poses[slot])
        propagate_corrections(
            estimate_c2w_list, np.asarray(self.keyframes.frame_idx[:K]), old_poses, new_poses, idx
        )
        self._log(
            {
                "event": "loop_relax",
                "idx": int(idx),
                "revisit_slot": int(hit[0]),
                "revisit_score": hit[1],
                "keyframes_moved": int(moved),
                "wall_s": round(time.time() - t0, 3),
            }
        )
        return True

    # ------------------------------------------------------------------

    def final_refine(
        self,
        dataset,
        estimate_c2w_list: np.ndarray,
        params: Any,
        start_idx: int,
        n: int,
        generator: Optional[torch.Generator] = None,
        pixel_idx: Optional[Dict[int, torch.Tensor]] = None,
    ) -> bool:
        """Re-localize trajectory entries max(start_idx, 1) .. n - 1 against
        the final map (mechanism 2); returns whether it ran.
        ``pixel_idx``: optional {frame: (iters, pixels)}."""
        if not self.final_refine_on:
            return False
        t0 = time.time()
        n_it = int(self.refine_iters) if self.refine_iters is not None else self.tracker.num_cam_iters
        max_rot = float(np.deg2rad(self.refine_max_rot_deg))
        moved_cm = []
        with span("LoopCloser.final_refine", start=int(start_idx), n=int(n)) as rec:
            for t in range(max(start_idx, 1), n):
                old = estimate_c2w_list[t].copy()
                if not np.isfinite(old).all():
                    self.skipped += 1
                    continue
                with span("LoopCloser.relocalize", frame=t, iters=n_it):
                    with span("LoopCloser.frame_in"):
                        _, color, depth, _ = dataset[t]
                        color, depth = self._frame_in(color, depth)
                    new, _ = self._relocalize(
                        params, color, depth, old, n_it, generator, None if pixel_idx is None else pixel_idx[t],
                        trust=(self.refine_max_dt, max_rot),
                    )
                estimate_c2w_list[t] = new
                self.refined += 1
                moved_cm.append(float(np.linalg.norm(new[:3, 3] - old[:3, 3])) * 100)
            if rec is not None:
                rec.attrs["frames"] = len(moved_cm)
        self._log(
            {
                "event": "loop_final_refine",
                "frames": len(moved_cm),
                "moved_cm_mean": round(float(np.mean(moved_cm)), 3) if moved_cm else 0.0,
                "moved_cm_max": round(float(np.max(moved_cm)), 3) if moved_cm else 0.0,
                "wall_s": round(time.time() - t0, 3),
            }
        )
        return True
