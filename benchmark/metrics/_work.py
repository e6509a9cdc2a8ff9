"""The work a cycle or a render asks for, from the configuration alone:
iterations per mapping stage, points per iteration, the grid-gradient calls
(K4 then K1) each stage makes, and the model FLOPs of each stage and agent.

Model FLOPs count, for every point:

  - the forward of every decoder the stage evaluates (the low decoder in
    the low stage; low, high and the attention MLP in the high stage; all
    four in the colour stage, in tracking and in renders);
  - the backward through a decoder's activations wherever a gradient must
    pass it to reach a grid whose rate is not zero, a decoder whose rate is
    not zero (the attention MLP's layers), or the camera (tracking: all
    four), counted as one more forward;
  - weight gradients only for decoders whose rate is not zero, one more
    forward each;
  - nothing recomputed, and not the grid lookups, the prior lookup or the
    compositing, which are gathers and a few operations a sample.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

from benchmark.generate import grid_dims
from benchmark.metrics._kernels import decoder_flops

ATTENTION = (2, 64, 128, 128, 64, 2)
STAGES = ("low", "high", "color")
EVALUATED = {"low": ("low",), "high": ("low", "high", "mlp"), "color": ("low", "high", "mlp", "color")}


def attention_flops() -> int:
    return 2 * sum(a * b for a, b in zip(ATTENTION[:-1], ATTENTION[1:]))


def model_flops(cfg: Dict[str, Any], name: str) -> int:
    C = int(cfg["model"]["c_dim"])
    return {"low": decoder_flops(C, 1), "high": decoder_flops(2 * C, 1), "color": decoder_flops(C, 4),
            "mlp": attention_flops()}[name]


def stage_iters(cfg: Dict[str, Any]) -> Dict[str, int]:
    """Iterations of each stage in a mapped frame (``mapping.iters`` split at
    ``low_iter_ratio`` and ``high_iter_ratio``, the shipped rule)."""
    m = cfg["mapping"]
    n = int(m["iters"])
    lo, hi = int(n * float(m["low_iter_ratio"])), int(n * float(m["high_iter_ratio"]))
    spans = {"low": (0, min(lo, n - 1))}
    if hi > lo:
        spans["high"] = (lo + 1, min(hi, n - 1))
    if n - 1 > hi:
        spans["color"] = (hi + 1, n - 1)
    return {s: e - b + 1 for s, (b, e) in spans.items() if e >= b}


def samples_per_ray(cfg: Dict[str, Any]) -> int:
    r = cfg["rendering"]
    return int(r["N_samples"]) + int(r["N_surface"]) + int(r["N_importance"])


def mapping_points(cfg: Dict[str, Any]) -> int:
    m = cfg["mapping"]
    F = int(m["mapping_window_size"])
    return (int(m["pixels"]) // F) * F * samples_per_ray(cfg)


def tracking_points(cfg: Dict[str, Any]) -> int:
    return int(cfg["tracking"]["pixels"]) * samples_per_ray(cfg)


def rates(cfg: Dict[str, Any], stage: str) -> Dict[str, float]:
    s = cfg["mapping"]["stage"][stage]
    m = cfg["mapping"]
    return {"grid_low": s["low_lr"], "grid_high": s["high_lr"], "grid_color": s["color_lr"], "mlp": s["mlp_lr"],
            "low": 0.0, "high": 0.0 if m.get("fix_high", True) else s["decoders_lr"],
            "color": 0.0 if m.get("fix_color", False) else s["decoders_lr"]}


def mapping_flops_per_point(cfg: Dict[str, Any], stage: str) -> int:
    r = rates(cfg, stage)
    ev = EVALUATED[stage]
    back = set()
    if r["grid_low"] > 0:
        back.add("low")
    if "high" in ev and r["grid_high"] > 0:
        back |= {"high", "mlp"}
    if "high" in ev and r["grid_low"] > 0:
        back.add("mlp")  # the low occupancy reaches the loss through the blend
    if "mlp" in ev and r["mlp"] > 0:
        back.add("mlp")
    if "color" in ev and (r["grid_color"] > 0 or r["color"] > 0):
        back.add("color")
    back |= {d for d in ("high", "color") if d in ev and r[d] > 0}
    wgrad = [d for d in ev if r[d] > 0]
    return sum(model_flops(cfg, d) for d in ev) + sum(model_flops(cfg, d) for d in back) + \
        sum(model_flops(cfg, d) for d in wgrad)


def cycle_flops(cfg: Dict[str, Any]) -> Dict[str, float]:
    """Model FLOPs of one cycle: a mapped frame and ``every_frame`` tracked
    frames, by agent (none for tracking where the tracker hands back the
    given poses, ``tracking.gt_camera``)."""
    its = stage_iters(cfg)
    mp = sum(n * mapping_points(cfg) * mapping_flops_per_point(cfg, s) for s, n in its.items())
    per_track_point = 2 * sum(model_flops(cfg, d) for d in EVALUATED["color"])
    t = cfg["tracking"]
    tr = 0 if t.get("gt_camera") else \
        int(cfg["mapping"]["every_frame"]) * int(t["iters"]) * tracking_points(cfg) * per_track_point
    return {"map": float(mp), "track": float(tr)}


def render_flops(cfg: Dict[str, Any], H: int, W: int) -> float:
    """Model FLOPs of one full frame: every pixel's samples through all four."""
    return float(H * W * samples_per_ray(cfg) * sum(model_flops(cfg, d) for d in EVALUATED["color"]))


def grid_gradient_calls(cfg: Dict[str, Any]) -> List[Tuple[int, int, int]]:
    """(rows, width, cells) of each K4 call in a cycle, in the mapping's
    grid gradients (K1 folds the same cells at width / 8): the low grid in
    every stage, the high grid in the high stage, and the high and colour
    grids as one doubled-width pair in the colour stage (equal shapes)."""
    C = int(cfg["model"]["c_dim"])
    n = mapping_points(cfg)
    low = math.prod(grid_dims(cfg, "low"))
    high = math.prod(grid_dims(cfg, "high"))
    pair = grid_dims(cfg, "high") == grid_dims(cfg, "color")
    calls: List[Tuple[int, int, int]] = []
    for stage, k in stage_iters(cfg).items():
        per = [(n, 8 * C, low)]
        if stage == "high":
            per.append((n, 8 * C, high))
        if stage == "color":
            per += [(n, 16 * C, high)] if pair else [(n, 8 * C, high), (n, 8 * C, math.prod(grid_dims(cfg, "color")))]
        calls += per * k
    return calls
