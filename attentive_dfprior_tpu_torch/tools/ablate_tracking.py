"""Tracking-knob ablation on the synthetic tracking demo: the port of
``scripts/ablate_tracking.py``.

    python -m attentive_dfprior_tpu_torch.tools.ablate_tracking [--config CFG]
        [--end_idx N] [--variants a,b,...] [--seed 0] [--device cuda|cpu]
        [--out PATH] [--out-root DIR]

Runs the SLAM loop of ``configs/Synthetic/room_tracking.yaml`` (strict)
under each variant's overrides (``VARIANTS``, the JAX harness's table as it
is) and records aligned and unaligned ATE RMSE per variant. Aligned ATE
goes through ``tools/eval_ate.py:evaluate_ate``, the one evaluation path
(ref: src/tools/eval_ate.py:113-223). Side outputs (checkpoints, meshes)
are off: this measures the trajectory alone. The record of every variant
is written to ``--out`` after each one, so a crash keeps the earlier ones.
Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from attentive_dfprior_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIG = os.path.join(REPO, "configs", "Synthetic", "room_tracking.yaml")


def apply(cfg: Dict[str, Any], overrides: Dict[str, Any]) -> None:
    """Deep-dict overrides: {"tracking.lr": 0.001} -> cfg["tracking"]["lr"]."""
    for k, v in overrides.items():
        d = cfg
        parts = k.split(".")
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v


# the JAX harness's variants (scripts/ablate_tracking.py): tracking learning rate, decay and
# dynamic-pixel cut; sampling budget; mapping cadence; camera resolution; bundle adjustment;
# loop closure
VARIANTS = {
    "base": {},
    "decay01": {"tracking.lr_final_factor": 0.1},
    "decay002": {"tracking.lr_final_factor": 0.02},
    "nodyn": {"tracking.handle_dynamic": False},
    "nodyn_decay01": {
        "tracking.handle_dynamic": False,
        "tracking.lr_final_factor": 0.1,
    },
    "seplr_decay01": {
        "tracking.seperate_LR": True,
        "tracking.lr_final_factor": 0.1,
    },
    "iters100_decay01": {
        "tracking.iters": 100,
        "tracking.lr_final_factor": 0.1,
    },
    "lr3e3_decay002": {
        "tracking.lr": 0.003,
        "tracking.lr_final_factor": 0.02,
    },
    "px2000_decay01": {"tracking.pixels": 2000, "tracking.lr_final_factor": 0.1},
    "px500_decay01": {"tracking.pixels": 500, "tracking.lr_final_factor": 0.1},
    "iters20_decay01": {"tracking.iters": 20, "tracking.lr_final_factor": 0.1},
    "iters100_px2000_decay01": {
        "tracking.iters": 100,
        "tracking.pixels": 2000,
        "tracking.lr_final_factor": 0.1,
    },
    "lr1e3_decay01": {"tracking.lr": 0.001, "tracking.lr_final_factor": 0.1},
    "evf2_decay01": {
        "mapping.every_frame": 2,
        "tracking.lr_final_factor": 0.1,
    },
    "evf2_kf2_decay01": {
        "mapping.every_frame": 2,
        "mapping.keyframe_every": 2,
        "tracking.lr_final_factor": 0.1,
    },
    "evf1_decay01": {
        "mapping.every_frame": 1,
        "tracking.lr_final_factor": 0.1,
    },
    "nodyn_lr3e3": {"tracking.handle_dynamic": False, "tracking.lr": 0.003},
    "nodyn_iters100": {"tracking.handle_dynamic": False, "tracking.iters": 100},
    "nodyn_px2000": {"tracking.handle_dynamic": False, "tracking.pixels": 2000},
    "nodyn_evf2": {
        "tracking.handle_dynamic": False,
        "mapping.every_frame": 2,
    },
    "nodyn_evf2_kf2": {
        "tracking.handle_dynamic": False,
        "mapping.every_frame": 2,
        "mapping.keyframe_every": 2,
    },
    "nodyn_lr3e3_iters100": {
        "tracking.handle_dynamic": False,
        "tracking.lr": 0.003,
        "tracking.iters": 100,
    },
    "iters20": {"tracking.iters": 20},
    "nodyn_iters20": {"tracking.handle_dynamic": False, "tracking.iters": 20},
    "nodyn_iters20_lr3e3": {
        "tracking.handle_dynamic": False,
        "tracking.iters": 20,
        "tracking.lr": 0.003,
    },
    "nodyn_iters20_evf2": {
        "tracking.handle_dynamic": False,
        "tracking.iters": 20,
        "mapping.every_frame": 2,
    },
    "hires": {
        "cam.H": 240, "cam.W": 320, "cam.fx": 240.0, "cam.fy": 240.0,
        "cam.cx": 159.5, "cam.cy": 119.5,
    },
    "hires_lr1e3_decay01": {
        "cam.H": 240, "cam.W": 320, "cam.fx": 240.0, "cam.fy": 240.0,
        "cam.cx": 159.5, "cam.cy": 119.5,
        "tracking.lr": 0.001, "tracking.lr_final_factor": 0.1,
    },
    "ba": {"mapping.BA": True},
    "ba_lr1e3_decay01": {
        "mapping.BA": True,
        "tracking.lr": 0.001,
        "tracking.lr_final_factor": 0.1,
    },
    "ba_nodyn": {"mapping.BA": True, "tracking.handle_dynamic": False},
    "ba_iters20_decay01": {
        "mapping.BA": True,
        "tracking.iters": 20,
        "tracking.lr_final_factor": 0.1,
    },
    "ba_evf2_hires_iters20_decay01": {
        "mapping.BA": True,
        "mapping.every_frame": 2,
        "cam.H": 240, "cam.W": 320, "cam.fx": 240.0, "cam.fy": 240.0,
        "cam.cx": 159.5, "cam.cy": 119.5,
        "tracking.iters": 20, "tracking.lr_final_factor": 0.1,
    },
    "ba_hires_iters20_decay01": {
        "mapping.BA": True,
        "cam.H": 240, "cam.W": 320, "cam.fx": 240.0, "cam.fy": 240.0,
        "cam.cx": 159.5, "cam.cy": 119.5,
        "tracking.iters": 20, "tracking.lr_final_factor": 0.1,
    },
    "hires_iters20_decay01": {
        "cam.H": 240, "cam.W": 320, "cam.fx": 240.0, "cam.fy": 240.0,
        "cam.cx": 159.5, "cam.cy": 119.5,
        "tracking.iters": 20, "tracking.lr_final_factor": 0.1,
    },
    "lc_refine": {"loop_closure.final_refine": True},
    "lc_relax": {
        "loop_closure.enable": True,
        "loop_closure.every": 15,
        "loop_closure.min_gap": 15,
    },
    "lc_full": {
        "loop_closure.enable": True,
        "loop_closure.final_refine": True,
        "loop_closure.every": 15,
        "loop_closure.min_gap": 15,
    },
    "lc_refine60": {
        "loop_closure.final_refine": True,
        "loop_closure.refine_iters": 60,
    },
    "adopted": {},
    "lc_refine_strong": {
        "loop_closure.final_refine": True,
        "loop_closure.refine_iters": 100,
        "loop_closure.lr": 0.01,
    },
    "lc_full_strong": {
        "loop_closure.enable": True,
        "loop_closure.every": 15,
        "loop_closure.min_gap": 15,
        "loop_closure.final_refine": True,
        "loop_closure.refine_iters": 100,
        "loop_closure.lr": 0.01,
    },
}


def ate_rmse(est: np.ndarray, gt: np.ndarray, n: int) -> float:
    """Aligned ATE RMSE in cm over frames 0..n-1 (stamps = frame indices),
    through ``evaluate_ate``."""
    from attentive_dfprior_tpu_torch.tools.eval_ate import evaluate_ate

    first = {float(i): np.asarray(est[i]) for i in range(n)}
    second = {float(i): np.asarray(gt[i]) for i in range(n)}
    return float(evaluate_ate(first, second)["absolute_translational_error.rmse"] * 100)


def run_variant(name: str, config: str, end_idx: Optional[int], seed: int, device: torch.device, out_dir: str,
                overrides: Sequence[str] = ()) -> Dict[str, Any]:
    """One variant's run on a fresh ``SLAMSystem``; returns its record.
    ``overrides`` (``run.py``'s ``--set`` syntax) apply before the
    variant's own."""
    from attentive_dfprior_tpu_torch.config import default_config_path, load_config
    from attentive_dfprior_tpu_torch.run import apply_overrides
    from attentive_dfprior_tpu_torch.slam.system import SLAMSystem

    cfg = load_config(config, default_config_path())
    apply_overrides(cfg, list(overrides))
    cfg["seed"] = seed
    apply(cfg, VARIANTS[name])
    os.makedirs(out_dir, exist_ok=True)
    np.random.seed(seed)
    slam = SLAMSystem(cfg, output=out_dir, device=device)
    slam._side_outputs = lambda *a, **k: None  # trajectory only
    t0 = time.perf_counter()
    est = slam.run(end_idx=end_idx)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    # only the frames the run processed (run()'s clamp, mapping.stop_at_frame
    # included): the rows after them are all-zero poses
    n = slam.n_img if end_idx is None else min(end_idx, slam.n_img)
    stop = cfg.get("mapping", {}).get("stop_at_frame")
    if stop is not None:
        n = min(n, int(stop) + 1)
    gt = slam.gt_c2w_list
    per_frame_cm = np.linalg.norm(est[:n, :3, 3] - gt[:n, :3, 3], axis=1) * 100
    return {
        "seed": seed,
        "ate_cm_aligned": round(ate_rmse(est, gt, n), 3),
        "ate_cm_unaligned": round(float(np.sqrt((per_frame_cm**2).mean())), 3),
        "wall_s": round(dt, 1),
        "n_frames": n,
        "err_cm_q25_q50_q75_max": [
            round(float(v), 2)
            for v in (np.percentile(per_frame_cm, 25), np.percentile(per_frame_cm, 50),
                      np.percentile(per_frame_cm, 75), per_frame_cm.max())
        ],
        "err_cm_last10_mean": round(float(per_frame_cm[-10:].mean()), 2),
        "err_cm_series": [round(float(v), 2) for v in per_frame_cm],
        "overrides": VARIANTS[name],
    }


def main(argv: Optional[List[str]] = None, overrides: Sequence[str] = ()) -> Dict[str, Any]:
    """The harness on ``argv``; ``overrides`` (``--set`` syntax of
    ``run.py``) apply to every variant's config before its own."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default=CONFIG)
    ap.add_argument("--end_idx", type=int, default=None)
    ap.add_argument("--variants", default=None, help="comma list; default all")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed (reruns at other seeds measure the run-to-run spread of the coupled tracker-mapper)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default="ablate_tracking.json", help="the records, rewritten after every variant")
    ap.add_argument("--out-root", default=None, help="the runs' output directories (default: a temporary one)")
    args = ap.parse_args(argv)
    if args.end_idx is not None and args.end_idx <= 0:
        ap.error("--end_idx must be positive")
    device = resolve_device(args.device)
    root = args.out_root or tempfile.mkdtemp(prefix="ablate_tracking_")

    names = list(VARIANTS) if args.variants is None else args.variants.split(",")
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        ap.error(f"unknown variants {unknown}")
    results: Dict[str, Any] = {}
    for name in names:
        results[name] = run_variant(name, args.config, args.end_idx, args.seed, device,
                                    os.path.join(root, f"{name}_s{args.seed}"), overrides)
        print(json.dumps({name: results[name]}), flush=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
