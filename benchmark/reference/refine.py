"""The plain reference of the final trajectory refine: each entry of a
block re-localized against a frozen map from its recorded pose, the result
clamped into a trust region about that pose and written back.

Plain float32 PyTorch (TF32 off, or on for the control, by
``steps.precision``); nothing here imports the program. A re-localization
is ``iters`` tracking steps (``steps.tracking_loss`` and ``steps.adam``,
unchanged) from the recorded pose, under this rate schedule: the full rate
for the first half of the iterations, then an exponential decay towards
``lr x factor`` over the second half, the exponent growing by one over the
second half's length (at least one iteration) for each iteration past the
half and capped at one, so the last of many iterations runs at
``lr x factor`` and the third of three at ``lr x factor ** 0.5``. The
kept candidate is the tensor after the step whose loss (at the tensor
before it) was the lowest, the first of equals.

The trust region: the translation's change is at most ``max_dt`` metres
(scaled down along its own direction), the rotation's change (the new
rotation times the old one's transpose) at most ``max_rot`` radians, about
its own axis; a change whose axis cannot be read (a half turn, where the
change's antisymmetric part vanishes) keeps the old rotation.

The block: entries max(start, 1) .. n - 1 in order, one generator for every
draw; an entry whose recorded pose holds a non-finite number is left as it
is and draws nothing; entry 0 is never moved.

Departures from the program, none of which moves a compared output beyond
round-off: the program replays one captured iteration on the card, the
reference runs eagerly; the program's rate shares are float32 powers, the
reference's float64; the program builds the clamped rotation by Rodrigues'
formula, the reference from a quaternion; the program's camera tensor comes
from its own rotation-to-quaternion routine, the reference's from
``steps.pose_tensor`` (Shepperd's rule).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from benchmark.reference import steps


def lr_scales(iters: int, factor: float) -> List[float]:
    """Each iteration's share of the rate (the module's schedule)."""
    if factor >= 1.0 or iters <= 1:
        return [1.0] * iters
    half = iters / 2.0
    ramp = max(iters - 1 - half, 1.0)
    return [float(factor) ** min(max((i - half) / ramp, 0.0), 1.0) for i in range(iters)]


def clamp(orig: np.ndarray, new: np.ndarray, max_dt: float, max_rot: float) -> np.ndarray:
    """``new`` brought into the trust region about ``orig`` (the module's
    rule), a (4, 4) float32 pose."""
    o = np.asarray(orig, dtype=np.float64)
    w = np.asarray(new, dtype=np.float64)
    dt = w[:3, 3] - o[:3, 3]
    length = float(np.linalg.norm(dt))
    if length > max_dt:
        dt = dt * (max_dt / length)
    dR = w[:3, :3] @ o[:3, :3].T
    angle = float(np.arccos(np.clip((np.trace(dR) - 1.0) / 2.0, -1.0, 1.0)))
    if angle > max_rot and angle > 0.0:
        v = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]])  # 2 sin(angle) x axis
        if np.linalg.norm(v) > 1e-12:
            axis = v / np.linalg.norm(v)
            q = np.concatenate([[np.cos(max_rot / 2.0)], np.sin(max_rot / 2.0) * axis])
            dR = steps.quat_to_rotation(torch.as_tensor(q, dtype=torch.float64)).numpy()
        else:
            dR = np.eye(3)
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = (dR @ o[:3, :3]).astype(np.float32)
    out[:3, 3] = (o[:3, 3] + dt).astype(np.float32)
    return out


def options(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The refine's settings from the configuration: the tracker's rays,
    margins and colour weight, the loop closure's rate, iterations and
    trust region (the tracker's rate and iterations where it gives none)."""
    t, lc = cfg["tracking"], cfg.get("loop_closure") or {}
    if t.get("seperate_LR") or not t.get("handle_dynamic", True) or not t.get("use_color_in_tracking", True):
        raise NotImplementedError("the reference tracks one camera tensor at one rate, with the dynamic cut and colour")
    return {"pixels": int(t["pixels"]), "edge_w": int(t["ignore_edge_W"]), "edge_h": int(t["ignore_edge_H"]),
            "w_color": float(t["w_color_loss"]), "factor": float(t.get("lr_final_factor", 1.0)),
            "lr": float(lc["lr"]) if lc.get("lr") is not None else float(t["lr"]),
            "iters": int(lc["refine_iters"]) if lc.get("refine_iters") is not None else int(t["iters"]),
            "max_dt": float(lc.get("refine_max_dt", 0.5)),
            "max_rot": float(np.deg2rad(float(lc.get("refine_max_rot_deg", 10.0))))}


def relocalize(scene, c2w0: np.ndarray, color: torch.Tensor, depth: torch.Tensor, gen: torch.Generator,
               iters: int, lr: float, factor: float, tsdf, bnds, bound, cam, rcfg, pixels: int, edge_w: int,
               edge_h: int, w_color: float, batch: Optional[slice] = None
               ) -> Tuple[np.ndarray, List[float], np.ndarray]:
    """One re-localization from ``c2w0``: the kept candidate as a (4, 4)
    float64 pose, each step's loss, and the camera tensor after the last
    step."""
    H, W = depth.shape
    t = torch.as_tensor(steps.pose_tensor(c2w0), device=depth.device).clone().requires_grad_(True)
    state = steps.adam_state([t])
    losses: List[float] = []
    tensors: List[np.ndarray] = []
    for share in lr_scales(iters, factor):
        draws = torch.randint(0, (H - 2 * edge_h) * (W - 2 * edge_w), (pixels,), generator=gen, device=depth.device)
        loss = steps.tracking_loss(t, scene, color, depth, draws, tsdf, bnds, bound, cam, rcfg, edge_w, edge_h,
                                   w_color, batch)
        (g,) = torch.autograd.grad(loss, [t])
        steps.adam([t], [g], state, [lr * share])
        losses.append(float(loss.detach()))
        tensors.append(t.detach().cpu().numpy().copy())
    best = tensors[int(np.argmin(losses))]
    c2w = np.eye(4)
    c2w[:3, :] = steps.pose_matrix(torch.as_tensor(best, dtype=torch.float64)).numpy()
    return c2w, losses, tensors[-1]


def refine_block(scene, estimates: np.ndarray, frame: Callable[[int], Tuple[torch.Tensor, torch.Tensor]],
                 gen: torch.Generator, start: int, n: int, opts: Dict[str, Any], tsdf, bnds, bound, cam, rcfg,
                 batch: Optional[slice] = None, trust: bool = True) -> Tuple[np.ndarray, int, int]:
    """Entries max(start, 1) .. n - 1 of ``estimates`` re-localized (the
    module's block), ``frame(t)`` giving entry t's colour and depth; returns
    the written-back trajectory (a copy), the entries re-localized and
    those skipped. ``trust=False`` writes back the tracked pose unclamped
    (a fault the comparison must catch)."""
    out = np.array(estimates, copy=True)
    refined = skipped = 0
    for t in range(max(start, 1), n):
        old = estimates[t]
        if not np.isfinite(old).all():
            skipped += 1
            continue
        color, depth = frame(t)
        c2w, _, _ = relocalize(scene, old, color, depth, gen, opts["iters"], opts["lr"], opts["factor"], tsdf, bnds,
                               bound, cam, rcfg, opts["pixels"], opts["edge_w"], opts["edge_h"], opts["w_color"],
                               batch)
        out[t] = clamp(old, c2w, opts["max_dt"], opts["max_rot"]) if trust else c2w.astype(np.float32)
        refined += 1
    return out, refined, skipped
