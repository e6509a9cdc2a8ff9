"""ScanNet mesh evaluation: re-fusion + Acc/Comp/Chamfer/Prec/Recall/F-score.

The port's counterpart of the JAX package's ``tools/evaluate_scannet.py``
(ref: src/tools/evaluate_scannet.py):
  - ``refuse``: render the predicted mesh's depth along a trajectory with
    the native rasterizer (instead of pyrender, ref: evaluate_scannet.py:120-152)
    and fuse those depths into the port's TSDF volume on the device
    (instead of open3d's ScalableTSDFVolume, ref: evaluate_scannet.py:155-186),
    meshed as the JAX package meshes it (ROADMAP F10: that rule keeps
    faces at the frusta's sides, where open3d keeps none);
  - metrics at 5 cm over 2 cm-downsampled point sets
    (ref: evaluate_scannet.py:34-62, 188-226).

Usage:
    python -m attentive_dfprior_tpu_torch.tools.evaluate_scannet --rec_mesh R.ply --gt_mesh G.ply \\
        [--ckpt C.npz --config CFG.yaml] [--no_refuse] [--device cuda|cpu]

Re-fusion runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy.spatial import cKDTree as KDTree

from attentive_dfprior_tpu_torch.camera import Camera
from attentive_dfprior_tpu_torch.utils.ply import read_ply


def voxel_downsample(points: np.ndarray, voxel: float) -> np.ndarray:
    """Open3d-style voxel grid downsampling (centroid per voxel)."""
    keys = np.floor(points / voxel).astype(np.int64)
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    sums = np.zeros((counts.size, 3))
    np.add.at(sums, inv.reshape(-1), points)
    return sums / counts[:, None]


def nn_correspondance(verts1: np.ndarray, verts2: np.ndarray) -> np.ndarray:
    """verts2 -> nearest distance in verts1 (ref: evaluate_scannet.py:65-87)."""
    if len(verts1) == 0 or len(verts2) == 0:
        return np.zeros(0)
    d, _ = KDTree(verts1).query(verts2)
    return d


def evaluate_mesh_metrics(
    pred_points: np.ndarray,
    gt_points: np.ndarray,
    threshold: float = 0.05,
    down_sample: float = 0.02,
) -> Dict[str, float]:
    """Acc/Comp/Chamfer/Prec/Recall/F-score (ref: evaluate_scannet.py:34-62)."""
    if down_sample:
        pred_points = voxel_downsample(pred_points, down_sample)
        gt_points = voxel_downsample(gt_points, down_sample)
    dist1 = nn_correspondance(pred_points, gt_points)  # gt -> pred
    dist2 = nn_correspondance(gt_points, pred_points)  # pred -> gt
    precision = float((dist2 < threshold).mean())
    recall = float((dist1 < threshold).mean())
    fscore = 2 * precision * recall / max(precision + recall, 1e-12)
    return {
        "Acc": float(dist2.mean()),
        "Comp": float(dist1.mean()),
        "Chamfer": float((dist1.mean() + dist2.mean()) / 2),
        "Prec": precision,
        "Recal": recall,
        "F-score": fscore,
    }


def refuse(
    verts: np.ndarray,
    faces: np.ndarray,
    poses: np.ndarray,
    cam: Camera,
    voxel_length: float = 0.01,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Re-fuse a mesh through depth renders along a trajectory
    (ref: evaluate_scannet.py:155-186) into the port's TSDF volume on
    ``device`` (the card by default; ``"cpu"`` on request), meshed by
    ``TSDFVolume.get_mesh`` as the JAX package meshes it. Poses are OpenGL
    c2w; rendering and fusion use OpenCV convention internally.
    """
    from attentive_dfprior_tpu_torch import native
    from attentive_dfprior_tpu_torch.tsdf.fusion import TSDFVolume
    from attentive_dfprior_tpu_torch.utils.device import resolve_device

    lo = verts.min(0) - 0.1
    hi = verts.max(0) + 0.1
    vol = TSDFVolume(np.stack([lo, hi], axis=1), voxel_size=voxel_length, device=resolve_device(device))
    K = cam.K.astype(np.float32)
    dummy_color = np.zeros((cam.H, cam.W, 3), dtype=np.float32)
    for i in range(len(poses)):
        c2w = poses[i].astype(np.float64).copy()
        if not np.isfinite(c2w).all():
            continue
        c2w[:3, 1] *= -1
        c2w[:3, 2] *= -1  # OpenGL -> OpenCV
        w2c = np.linalg.inv(c2w)
        depth = native.rasterize_depth(verts, faces, w2c, cam.fx, cam.fy, cam.cx, cam.cy, cam.H, cam.W)
        vol.integrate(dummy_color, depth, K, c2w)
    v, f, _, _ = vol.get_mesh()
    return v, f


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    parser = argparse.ArgumentParser(description="ScanNet mesh evaluation (PyTorch/CUDA port)")
    parser.add_argument("--rec_mesh", required=True)
    parser.add_argument("--gt_mesh", required=True)
    parser.add_argument("--ckpt", help="checkpoint (.npz) with the trajectory for re-fusion")
    parser.add_argument("--config", help="scene config for camera intrinsics")
    parser.add_argument("--no_refuse", action="store_true")
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)

    rec_v, rec_f, _ = read_ply(args.rec_mesh)
    gt_v, _, _ = read_ply(args.gt_mesh)
    if not args.no_refuse and args.ckpt and args.config:
        from attentive_dfprior_tpu_torch.config import default_config_path, load_config

        cfg = load_config(args.config, default_config_path())
        with np.load(args.ckpt) as data:
            poses = data["gt_c2w_list"]
        rec_v, rec_f = refuse(rec_v, rec_f, poses, Camera.from_config(cfg), device=args.device)
    metrics = evaluate_mesh_metrics(rec_v, gt_v)
    print(metrics)
    return metrics


if __name__ == "__main__":
    main()
