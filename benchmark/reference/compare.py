"""The comparison that decides ``correct``: the program's outputs against
the plain reference's, each as one number that a limit holds.

Strict cells, from the seeded scene: each mapping stage's first steps on
the warm-up map's window and the first tracked frame's first steps, and
then one whole call of each agent, ``Mapper.optimize_map`` on that window
and ``Tracker.track`` on that frame, in the program (recorded after the
window, through the window's own programs and entries) and in the
reference. The numbers are the worst over the stages:

  - ``map_loss`` / ``track_loss``: each step's loss, |program - reference|
    over |reference|;
  - ``map_grad``: each leaf's first gradient as Adam takes it (the masked
    gradient, read from Adam's first moment after one step), the gap of
    the two norms over the larger of the reference leaf's norm and the
    median leaf's; ``track_grad``: the camera tensor's, over its own norm;
  - ``map_change``: each leaf's change after the steps, likewise;
    ``track_change``: the camera tensor's change, the median over its
    seven components of the gap over the median component's change;
  - ``map_iters``: the whole call's iterations in each stage, the
    program's against the schedule the configuration states (exact);
    ``map_call_loss``: the loss of each of the call's first three
    iterations, as above (later ones are not compared: over 60 Adam steps
    the float32 round-off of either side grows to whole losses on some
    seeds, the program's as the control's);
  - ``track_pose``: the pose ``Tracker.track`` hands back after three
    iterations (the agent's iteration count set to the check's for that
    call) against the reference's kept candidate of three, the worse of
    the rotation's and the translation's gap over the reference's motion
    from the tracker's start. Where the configuration gives the tracker
    the poses (``tracking.gt_camera``) it is the given pose, exactly, and
    the tracker's steps are not compared: the timed path runs none.

Leaves whose reference gradient is under a thousandth of the median
leaf's move under Adam by round-off alone: they are left out of the
gradient and change gaps (the rule reads the reference alone).

Render cells: ``render_gap``, a frame's mean absolute gap over its depth
(metres) and colour values alike, the worst of a sample of the window's
frames drawn from the seed. Depth alone does not separate the control:
on some seeds the random scene's occupancy saturates at the first samples
and the depth hardly depends on the decoders' last bits, where the colour
still does.

``tf32`` puts the reference in TF32 in the program's place (the control);
``half`` runs the reference on half of each batch, the loss scaled to the
whole (a fault the comparison must catch).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from benchmark import generate
from benchmark.reference import steps
from benchmark.reference.scene import render_image

SKIP = 1e-3  # leaves under this share of the median leaf's gradient
STAGES = ("low", "high", "color")
# the check's draws: the stages' first steps take sub-seeds 0-2 of the check's
TRACK, MAP_CALL, TRACK_CALL = 3, 4, 5


def reference_strict(run, tf32: bool = False, half: bool = False) -> Dict[str, Any]:
    """The reference's outputs of the check's steps and calls, in the
    format the strict driver records the program's."""
    cfg, mix, dev = run.cell.cfg, run.cell.mix, run.dev
    m, t = cfg["mapping"], cfg["tracking"]
    if t.get("seperate_LR") or float(t.get("lr_final_factor", 1.0)) != 1.0 or m.get("BA"):
        raise NotImplementedError("the reference tracks at one rate and maps without BA")
    cam, F, n = run.cam, run.F, int(mix["check_steps"])
    bound = torch.as_tensor(generate.scene_bound(cfg), dtype=torch.float32, device=dev)
    bnds = torch.as_tensor(run.bnds, device=dev)
    rcfg = cfg["rendering"]
    names = [nm for nm, _ in steps.leaves(generate.scene_specs(cfg))]
    scene0 = steps.rebuild(generate.scene_specs(cfg), run.scene0)
    base = generate.sub_seed(run.cell.seed, generate.CHECK)
    idx = run.check_map_idx
    ids = torch.as_tensor([j % run.pool for j in range(idx - F + 1, idx + 1)], device=dev)
    window = (run.colors.index_select(0, ids), run.depths.index_select(0, ids),
              torch.as_tensor(run.poses[idx - F + 1: idx + 1], device=dev))
    masks = {}
    if m["frustum_feature_selection"]:
        for key in ("low", "high", "color"):
            masks[f"grid_{key}"] = torch.as_tensor(steps.frustum_mask(
                run.poses[idx], generate.grid_dims(cfg, key), generate.scene_bound(cfg),
                run.depths_np[idx % run.pool], cam), device=dev)
    fix_high = bool(m.get("fix_high", True))
    fix_color = bool(m.get("fix_color", False))
    rates = {stage: steps.stage_rates(names, m["stage"][stage], fix_high, fix_color, float(m["lr_factor"]))
             for stage in STAGES}
    batch = slice(0, None, 2) if half else None
    common = (run.tsdf, bnds, bound, cam, rcfg)
    map_args = common + (float(m["w_color_loss"]), int(m["pixels"]) // F, batch)
    idx = run.start + 1
    k = idx % run.pool
    start = steps.constant_speed(run.poses, idx)
    track_args = (run.colors[k], run.depths[k])
    track_opts = common + (int(t["pixels"]), int(t["ignore_edge_W"]), int(t["ignore_edge_H"]),
                           float(t["w_color_loss"]), batch)
    out: Dict[str, Any] = {"map": {}}
    with steps.precision(tf32):
        for i, stage in enumerate(STAGES):
            gen = torch.Generator(device=dev).manual_seed(base + i)
            out["map"][stage] = steps.mapping_steps(scene0, window, masks, gen, n, stage, rates[stage], *map_args)
        gen = torch.Generator(device=dev).manual_seed(base + MAP_CALL)
        schedule = steps.stage_schedule(int(m["iters"]), float(m["low_iter_ratio"]), float(m["high_iter_ratio"]))
        first, left = [], n  # the call's first n iterations
        for stage, k in schedule:
            if left > 0:
                first.append((stage, min(k, left)))
                left -= first[-1][1]
        call = steps.mapping_call(scene0, window, masks, gen, first, rates, *map_args)
        out["map_call"] = {"counts": dict(schedule), "loss": [v for stage, _ in first for v in call["loss"][stage]]}
        if t["gt_camera"]:
            out["track_call"] = {"c2w": np.asarray(run.poses[idx], np.float64), "start": run.poses[idx]}
            return out
        t0 = steps.pose_tensor(start)
        gen = torch.Generator(device=dev).manual_seed(base + TRACK)
        out["track"] = steps.tracking_steps(scene0, t0, *track_args, gen, n, float(t["lr"]), *track_opts)
        out["track"]["t0"] = t0
        gen = torch.Generator(device=dev).manual_seed(base + TRACK_CALL)
        c2w = steps.tracking_call(scene0, t0, *track_args, gen, n, float(t["lr"]), *track_opts)
    out["track_call"] = {"c2w": c2w, "start": start}
    return out


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _leaf_gap(side: Dict[str, float], ref: Dict[str, float], keep: List[str]) -> float:
    vals = [ref[k] for k in keep if ref[k] > 0]
    med = float(np.median(vals)) if vals else 0.0
    return max((abs(side[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keep), default=0.0)


def _kept(grad: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's (of those with any)."""
    live = [k for k, v in grad.items() if v > 0]
    med = float(np.median([grad[k] for k in live])) if live else 0.0
    return [k for k in live if grad[k] >= SKIP * med]


def _pose_gap(side: np.ndarray, ref: np.ndarray, start: np.ndarray) -> float:
    """The worse of the rotation's and the translation's gap, each the
    norm of the program's difference from the reference over the norm of
    the reference's own motion from the start (0 where both are exact)."""
    p, r, s = (np.asarray(a, np.float64)[:3, :4] for a in (side, ref, start))
    rot = np.linalg.norm(p[:, :3] - r[:, :3]) / max(float(np.linalg.norm(r[:, :3] - s[:, :3])), 1e-30)
    trans = np.linalg.norm(p[:, 3] - r[:, 3]) / max(float(np.linalg.norm(r[:, 3] - s[:, 3])), 1e-30)
    return float(max(rot, trans))


def strict_gaps(side: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, float]:
    loss, grad, change = 0.0, 0.0, 0.0
    for stage, r in ref["map"].items():
        s = side["map"][stage]
        loss = max([loss] + [_rel(a, b) for a, b in zip(s["loss"], r["loss"])])
        keep = _kept(r["grad"])
        grad = max(grad, _leaf_gap(s["grad"], r["grad"], keep))
        change = max(change, _leaf_gap(s["change"], r["change"], keep))
    s, r = side["map_call"], ref["map_call"]
    iters = sum(abs(s["counts"].get(st, 0) - r["counts"].get(st, 0)) for st in set(s["counts"]) | set(r["counts"]))
    out = {"map_loss": loss, "map_grad": grad, "map_change": change, "map_iters": float(iters),
           "map_call_loss": max(_rel(a, b) for a, b in zip(s["loss"], r["loss"])),
           "track_pose": _pose_gap(side["track_call"]["c2w"], ref["track_call"]["c2w"], ref["track_call"]["start"])}
    if "track" not in ref:
        return out
    s, r = side["track"], ref["track"]
    t0 = np.asarray(ref["track"]["t0"], dtype=np.float64)
    dp = np.asarray(s["tensors"][-1], np.float64) - t0
    dr = np.asarray(r["tensors"][-1], np.float64) - t0
    # the median component's gap: one component whose gradient is near zero
    # can step the other way on round-off, which moves the median by nothing
    out["track_change"] = float(np.median(np.abs(dp - dr)) / max(float(np.median(np.abs(dr))), 1e-30))
    out["track_loss"] = max(_rel(a, b) for a, b in zip(s["loss"], r["loss"]))
    out["track_grad"] = _rel(s["grad"], r["grad"])
    return out


def strict_numbers(run, tf32: bool = False, half: bool = False) -> Dict[str, float]:
    """The program's gaps to the reference; with ``tf32`` or ``half`` those
    of the reference so computed, put in the program's place."""
    ref = reference_strict(run)
    side = reference_strict(run, tf32=tf32, half=half) if (tf32 or half) else run.port
    return strict_gaps(side, ref)


def render_sample(run) -> List[int]:
    """The window's frames the check compares: ``check_frames`` of them,
    drawn from the seed."""
    rng = np.random.default_rng(generate.sub_seed(run.cell.seed, generate.CHECK))
    n = len(run.outputs)
    k = min(int(run.cell.mix["check_frames"]), n)
    return sorted(int(i) for i in rng.choice(n, size=k, replace=False))


def reference_render(run, frames: List[int], tf32: bool = False) -> Dict[int, Any]:
    cfg, dev = run.cell.cfg, run.dev
    bound = torch.as_tensor(generate.scene_bound(cfg), dtype=torch.float32, device=dev)
    bnds = torch.as_tensor(run.bnds, device=dev)
    scene = steps.rebuild(generate.scene_specs(cfg), run.scene0)
    out = {}
    with steps.precision(tf32):
        for i in frames:
            idx = run.outputs[i][0]
            c2w = torch.as_tensor(run.poses[idx], device=dev)
            depth = run.depths[idx % run.pool]
            d, c = render_image(scene, c2w, depth, run.tsdf, bnds, bound, run.cam, cfg["rendering"], run.chunk)
            out[i] = (d.cpu().numpy(), c.cpu().numpy())
    return out


def render_gaps(side: Dict[int, Any], ref: Dict[int, Any]) -> Dict[str, float]:
    """``render_gap``: a frame's mean absolute gap over its values, the
    depth (m) and the three colour channels of every pixel alike; the
    worst frame."""
    def gap(i):
        return (float(np.abs(side[i][0] - ref[i][0]).sum()) + float(np.abs(side[i][1] - ref[i][1]).sum())) / (
            ref[i][0].size + ref[i][1].size)
    return {"render_gap": max(gap(i) for i in ref)}


def render_numbers(run, tf32: bool = False) -> Dict[str, float]:
    frames = render_sample(run)
    ref = reference_render(run, frames)
    side = reference_render(run, frames, tf32=True) if tf32 else {i: run.outputs[i][1:] for i in frames}
    return render_gaps(side, ref)
