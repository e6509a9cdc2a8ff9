"""Absolute Trajectory Error evaluation (TUM protocol).

A copy of the JAX package's ``tools/eval_ate.py`` (ref:
src/tools/eval_ate.py): associate timestamps, Horn's closed-form SE(3)
alignment, translational RMSE / mean / median / std / min / max, from the
last checkpoint of a run (ref: eval_ate.py:259-301). The trajectory plot is
written only when ``--plot PATH`` is given; it needs matplotlib.

Usage:
    python -m attentive_dfprior_tpu_torch.tools.eval_ate [config] [--output O]
        [--ckpt C] [--plot PATH]
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Tuple

import numpy as np


def associate(
    first_stamps: List[float],
    second_stamps: List[float],
    offset: float = 0.0,
    max_difference: float = 0.02,
) -> List[Tuple[float, float]]:
    """Greedy best-first timestamp association (ref: eval_ate.py:11-41)."""
    potential = [
        (abs(a - (b + offset)), a, b)
        for a in first_stamps
        for b in second_stamps
        if abs(a - (b + offset)) < max_difference
    ]
    potential.sort()
    first_used, second_used, matches = set(), set(), []
    for _, a, b in potential:
        if a not in first_used and b not in second_used:
            first_used.add(a)
            second_used.add(b)
            matches.append((a, b))
    matches.sort()
    return matches


def align(model: np.ndarray, data: np.ndarray):
    """Horn's closed-form alignment of two (3, N) trajectories
    (ref: eval_ate.py:44-78).

    Returns:
        rot (3,3), trans (3,1), trans_error (N,)
    """
    model_zero = model - model.mean(1, keepdims=True)
    data_zero = data - data.mean(1, keepdims=True)
    W = model_zero @ data_zero.T
    U, _, Vh = np.linalg.svd(W.T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vh) < 0:
        S[2, 2] = -1
    rot = U @ S @ Vh
    trans = data.mean(1, keepdims=True) - rot @ model.mean(1, keepdims=True)
    err = rot @ model + trans - data
    trans_error = np.sqrt((err * err).sum(0))
    return rot, trans, trans_error


def plot_trajectory(path: str, gt_xyz: np.ndarray, est_xyz: np.ndarray) -> None:
    """Top view (x, y) of the ground truth and the aligned estimate."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(f"writing the trajectory plot {path} needs matplotlib") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    ax.plot(gt_xyz[0], gt_xyz[1], "-", color="black", label="ground truth")
    ax.plot(est_xyz[0], est_xyz[1], "-", color="blue", label="estimated")
    ax.legend()
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    plt.savefig(path, dpi=90)
    plt.close(fig)


def evaluate_ate(
    first_poses: Dict[float, np.ndarray],
    second_poses: Dict[float, np.ndarray],
    offset: float = 0.0,
    max_difference: float = 0.02,
    scale: float = 1.0,
    plot_path: Optional[str] = None,
) -> Dict[str, float]:
    """ATE metrics between two {stamp: 4x4 c2w} trajectories
    (ref: eval_ate.py:113-223)."""
    matches = associate(list(first_poses.keys()), list(second_poses.keys()), offset, max_difference)
    if len(matches) < 2:
        raise ValueError("not enough matching trajectory pairs")
    first_xyz = np.array([first_poses[a][:3, 3] for a, _ in matches]).T
    second_xyz = np.array([second_poses[b][:3, 3] * scale for _, b in matches]).T
    rot, trans, trans_error = align(first_xyz, second_xyz)
    if plot_path:
        plot_trajectory(plot_path, second_xyz, rot @ first_xyz + trans)
    return {
        "compared_pose_pairs": len(matches),
        "absolute_translational_error.rmse": float(np.sqrt(np.dot(trans_error, trans_error) / len(trans_error))),
        "absolute_translational_error.mean": float(np.mean(trans_error)),
        "absolute_translational_error.median": float(np.median(trans_error)),
        "absolute_translational_error.std": float(np.std(trans_error)),
        "absolute_translational_error.min": float(np.min(trans_error)),
        "absolute_translational_error.max": float(np.max(trans_error)),
    }


def convert_poses(c2w_list: np.ndarray, scale: float = 1.0) -> Dict[float, np.ndarray]:
    """Pose array -> {stamp: pose}, leaving out non-finite and all-zero
    entries (ref: eval_ate.py:239-256)."""
    poses = {}
    for i in range(len(c2w_list)):
        c2w = np.array(c2w_list[i], dtype=np.float64)
        if not np.isfinite(c2w).all() or np.allclose(c2w, 0):
            continue
        c2w[:3, 3] *= scale
        poses[float(i)] = c2w
    return poses


def evaluate_checkpoint(ckpt_path: str, plot_path: Optional[str] = None) -> Dict[str, float]:
    """ATE of a checkpoint (``.npz`` of either package): the estimated
    trajectory aligned to the ground truth over the frames both hold."""
    data = np.load(ckpt_path)
    gt = convert_poses(data["gt_c2w_list"])
    est = convert_poses(data["estimate_c2w_list"])
    common = sorted(set(gt) & set(est))
    result = evaluate_ate({k: gt[k] for k in common}, {k: est[k] for k in common}, plot_path=plot_path)
    result["absolute_translational_error.rmse_cm"] = result["absolute_translational_error.rmse"] * 100.0
    return result


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    parser = argparse.ArgumentParser(description="ATE evaluation")
    parser.add_argument("config", nargs="?", help="scene config (to locate the output folder)")
    parser.add_argument("--output", help="run output folder")
    parser.add_argument("--ckpt", help="explicit checkpoint path")
    parser.add_argument("--plot", help="write the trajectory plot here (needs matplotlib)")
    args = parser.parse_args(argv)

    ckpt = args.ckpt
    if ckpt is None:
        from attentive_dfprior_tpu_torch.utils.logger import latest_checkpoint

        output = args.output
        if output is None:
            if args.config is None:
                parser.error("give a config, --output or --ckpt")
            from attentive_dfprior_tpu_torch.config import default_config_path, load_config

            output = load_config(args.config, default_config_path())["data"]["output"]
        ckpt = latest_checkpoint(os.path.join(output, "ckpts"))
        if ckpt is None:
            raise SystemExit(f"no checkpoint found under {output}/ckpts")
    result = evaluate_checkpoint(ckpt, plot_path=args.plot)
    for k, v in result.items():
        print(f"{k}: {v}")
    return result


if __name__ == "__main__":
    main()
