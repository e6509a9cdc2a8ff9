"""3D/2D reconstruction evaluation (Replica protocol).

The port's copy of the JAX package's ``tools/eval_recon.py`` (numpy +
scipy; the 2D metric on the port's native rasterizer). Equivalent of the reference's src/tools/eval_recon.py:
  - 3D: ICP-align the reconstructed mesh to GT, then accuracy (pred->GT
    nearest-neighbor distance), completion (GT->pred), completion ratio
    (< 5 cm), over 200k surface samples (ref: eval_recon.py:32-125).
  - 2D: depth-L1 over N random interior views; views rejected when they see
    unseen GT regions (ref: eval_recon.py:139-218). The offscreen renders use
    our native C++ rasterizer instead of open3d.
"""

from __future__ import annotations

import argparse
from typing import Optional, Tuple

import numpy as np
from scipy.spatial import cKDTree as KDTree

from attentive_dfprior_tpu_torch.utils.ply import read_ply


def sample_surface(
    verts: np.ndarray, faces: np.ndarray, n: int, rng: np.random.Generator
) -> np.ndarray:
    """Uniform area-weighted surface sampling (trimesh.sample equivalent)."""
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    probs = areas / areas.sum()
    idx = rng.choice(len(faces), size=n, p=probs)
    r1 = np.sqrt(rng.uniform(size=(n, 1)))
    r2 = rng.uniform(size=(n, 1))
    return (
        (1 - r1) * v0[idx] + r1 * (1 - r2) * v1[idx] + r1 * r2 * v2[idx]
    )


def icp_align(
    source: np.ndarray,
    target: np.ndarray,
    iters: int = 30,
    threshold: float = 0.1,
) -> np.ndarray:
    """Point-to-point ICP returning a 4x4 transform aligning source->target.

    Replaces o3d registration_icp (ref: eval_recon.py:53-67); same role —
    a small rigid correction before computing distances.
    """
    T = np.eye(4)
    src = source.copy()
    tree = KDTree(target)
    prev_err = np.inf
    for _ in range(iters):
        dist, idx = tree.query(src)
        mask = dist < threshold
        if mask.sum() < 10:
            break
        p = src[mask]
        q = target[idx[mask]]
        pc = p - p.mean(0)
        qc = q - q.mean(0)
        W = pc.T @ qc
        U, _, Vh = np.linalg.svd(W)
        S = np.eye(3)
        if np.linalg.det(U @ Vh) < 0:
            S[2, 2] = -1
        R = Vh.T @ S @ U.T
        t = q.mean(0) - R @ p.mean(0)
        src = src @ R.T + t
        Ti = np.eye(4)
        Ti[:3, :3] = R
        Ti[:3, 3] = t
        T = Ti @ T
        err = dist[mask].mean()
        if abs(prev_err - err) < 1e-7:
            break
        prev_err = err
    return T


def accuracy(gt_points: np.ndarray, rec_points: np.ndarray) -> float:
    """Mean rec->GT NN distance (ref: eval_recon.py:32-36)."""
    d, _ = KDTree(gt_points).query(rec_points)
    return float(d.mean())


def completion(gt_points: np.ndarray, rec_points: np.ndarray) -> float:
    """Mean GT->rec NN distance (ref: eval_recon.py:39-43)."""
    d, _ = KDTree(rec_points).query(gt_points)
    return float(d.mean())


def completion_ratio(
    gt_points: np.ndarray, rec_points: np.ndarray, dist_th: float = 0.05
) -> float:
    """% of GT points within dist_th of the reconstruction
    (ref: eval_recon.py:46-50)."""
    d, _ = KDTree(rec_points).query(gt_points)
    return float((d < dist_th).astype(np.float32).mean())


def calc_3d_metric(
    rec_verts: np.ndarray,
    rec_faces: np.ndarray,
    gt_verts: np.ndarray,
    gt_faces: np.ndarray,
    n_samples: int = 200_000,
    align: bool = True,
    seed: int = 0,
) -> dict:
    """3D metrics over surface samples (ref: eval_recon.py:99-125)."""
    rng = np.random.default_rng(seed)
    rec_pc = sample_surface(rec_verts, rec_faces, n_samples, rng)
    gt_pc = sample_surface(gt_verts, gt_faces, n_samples, rng)
    if align:
        T = icp_align(rec_pc[:: max(1, n_samples // 20000)], gt_pc[:: max(1, n_samples // 20000)])
        rec_pc = rec_pc @ T[:3, :3].T + T[:3, 3]
    acc = accuracy(gt_pc, rec_pc)
    comp = completion(gt_pc, rec_pc)
    ratio = completion_ratio(gt_pc, rec_pc)
    return {
        "accuracy_cm": acc * 100,
        "completion_cm": comp * 100,
        "completion_ratio_pct": ratio * 100,
    }


def _normalize(x: np.ndarray) -> np.ndarray:
    return x / np.linalg.norm(x)


def viewmatrix(z: np.ndarray, up: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """Look-at camera matrix (ref: eval_recon.py:23-29), columns
    [right, up, forward, pos]."""
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], axis=1)


def _pca_obb(verts: np.ndarray):
    """Oriented bounding box via PCA (stand-in for trimesh
    oriented_bounds, ref: eval_recon.py:129; PCA gives a near-minimal box
    for room-shaped scenes — the only use is sampling interior camera
    positions, so exact minimality is immaterial).

    Returns (extents (3,), transform 4x4 mapping box coords -> world).
    """
    mean = verts.mean(0)
    centered = verts - mean
    cov = centered.T @ centered / len(verts)
    _, vecs = np.linalg.eigh(cov)
    R = vecs[:, ::-1]  # principal axes, largest variance first
    if np.linalg.det(R) < 0:
        R[:, 2] *= -1
    proj = centered @ R
    lo, hi = proj.min(0), proj.max(0)
    extents = hi - lo
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = mean + R @ ((lo + hi) / 2)
    return extents, T


def get_cam_position(gt_verts: np.ndarray):
    """Interior camera-position box (ref: eval_recon.py:128-136): the GT
    mesh's oriented bounding box with extents scaled [0.3, 0.7, 0.7] and the
    box center lifted +0.4 along world z."""
    extents, transform = _pca_obb(gt_verts)
    extents = extents.copy()
    extents[2] *= 0.7
    extents[1] *= 0.7
    extents[0] *= 0.3
    transform = transform.copy()
    transform[2, 3] += 0.4
    return extents, transform


def check_proj(
    points: np.ndarray, W: int, H: int, fx, fy, cx, cy, c2w: np.ndarray
) -> bool:
    """True if ANY of ``points`` projects inside the view
    (ref: eval_recon.py:70-96: y/z axis flip then the -x camera-coordinate
    convention)."""
    if len(points) == 0:
        return False
    c2w = c2w.copy()
    c2w[:3, 1] *= -1.0
    c2w[:3, 2] *= -1.0
    w2c = np.linalg.inv(c2w)
    homo = np.concatenate([points, np.ones((len(points), 1))], axis=1)
    cam = (w2c @ homo.T).T[:, :3]
    cam[:, 0] *= -1
    z = cam[:, 2:3] + 1e-5
    u = fx * cam[:, 0:1] / z + cx
    v = fy * cam[:, 1:2] / z + cy
    mask = (
        (0 <= -z[:, 0]) & (u[:, 0] < W) & (u[:, 0] > 0)
        & (v[:, 0] < H) & (v[:, 0] > 0)
    )
    return bool(mask.any())


def calc_2d_metric(
    rec_verts: np.ndarray,
    rec_faces: np.ndarray,
    gt_verts: np.ndarray,
    gt_faces: np.ndarray,
    pc_unseen: Optional[np.ndarray] = None,
    n_imgs: int = 1000,
    seed: int = 0,
    H: int = 500,
    W: int = 500,
    focal: float = 300.0,
    align: bool = True,
) -> Optional[dict]:
    """Depth-L1 over random interior views — the REFERENCE protocol
    (ref: eval_recon.py:139-218), step for step:

      1. rec mesh ICP-aligned to GT (ref :152-154; ``align``).
      2. camera origin sampled uniformly inside the GT oriented-bounding-box
         interior (extents x [0.3, 0.7, 0.7], +0.4 z lift, ref :155-157).
      3. look target uniform in [-10000, 10000]^3, up = [0, 0, -1],
         c2w = viewmatrix(target - origin, up, origin) (ref :170-180).
      4. view REJECTED if any point of the unseen-region GT pointcloud
         (``pc_unseen``, the reference's ``*_pc_unseen.npy``; produced here
         by tools/cull_mesh.py --save_unseen_pc) projects into it
         (ref :181-183).
      5. depth rendered at 500x500, f=300 for GT and rec
         (o3d offscreen in the reference; our native C++ z-buffer
         rasterizer here), error = mean |gt - rec| over ALL pixels —
         no validity masking (ref :185-216).
    """
    import random as _random

    from attentive_dfprior_tpu_torch import native

    if pc_unseen is None:
        pc_unseen = np.zeros((0, 3))
    if align:
        T = icp_align(rec_verts[:: max(1, len(rec_verts) // 20000)],
                      gt_verts[:: max(1, len(gt_verts) // 20000)])
        rec_verts = rec_verts @ T[:3, :3].T + T[:3, 3]

    rng = np.random.default_rng(seed)
    _random.seed(seed)
    extents, transform = get_cam_position(gt_verts)
    fx = fy = focal
    cx, cy = H / 2.0 - 0.5, W / 2.0 - 0.5

    errors = []
    for _ in range(n_imgs):
        for _try in range(2000):
            # sample inside the OBB interior (trimesh volume_rectangular)
            local = (rng.uniform(size=3) - 0.5) * extents
            origin = transform[:3, :3] @ local + transform[:3, 3]
            target = np.array(
                [
                    round(_random.uniform(-10000, 10000), 2),
                    round(_random.uniform(-10000, 10000), 2),
                    round(_random.uniform(-10000, 10000), 2),
                ]
            ) - origin
            c2w = np.eye(4)
            c2w[:3, :] = viewmatrix(target, np.array([0.0, 0.0, -1.0]), origin)
            if not check_proj(pc_unseen, W, H, fx, fy, cx, cy, c2w):
                break
        else:
            # sampler exhausted (the reference retries forever): keep the
            # views measured so far instead of discarding the whole metric;
            # n_views in the result records the shortfall
            break

        w2c = np.linalg.inv(c2w)
        gt_depth = native.rasterize_depth(
            gt_verts, gt_faces, w2c, fx, fy, cx, cy, H, W
        )
        rec_depth = native.rasterize_depth(
            rec_verts, rec_faces, w2c, fx, fy, cx, cy, H, W
        )
        # full-image mean, no masking (ref :216)
        errors.append(np.abs(gt_depth - rec_depth).mean())

    if not errors:
        return None
    return {"depth_l1_cm": float(np.mean(errors) * 100), "n_views": len(errors)}


def main():
    parser = argparse.ArgumentParser(description="Reconstruction evaluation")
    parser.add_argument("--rec_mesh", required=True)
    parser.add_argument("--gt_mesh", required=True)
    parser.add_argument("-3d", "--metric_3d", action="store_true")
    parser.add_argument("-2d", "--metric_2d", action="store_true")
    parser.add_argument("--n_imgs", type=int, default=1000)
    parser.add_argument(
        "--pc_unseen",
        help=".npy unseen-region pointcloud (reference *_pc_unseen.npy "
        "layout, or tools/cull_mesh.py --save_unseen_pc output); defaults "
        "to <gt_mesh stem>_pc_unseen.npy when present",
    )
    args = parser.parse_args()

    rec_v, rec_f, _ = read_ply(args.rec_mesh)
    gt_v, gt_f, _ = read_ply(args.gt_mesh)
    if args.metric_3d or not args.metric_2d:
        print(calc_3d_metric(rec_v, rec_f, gt_v, gt_f))
    if args.metric_2d:
        import os

        pc_path = args.pc_unseen or args.gt_mesh.replace(".ply", "_pc_unseen.npy")
        pc_unseen = np.load(pc_path) if os.path.exists(pc_path) else None
        if pc_unseen is None:
            print(f"WARNING: no unseen pointcloud at {pc_path}; "
                  "views will not be rejected")
        print(
            calc_2d_metric(
                rec_v, rec_f, gt_v, gt_f, pc_unseen=pc_unseen,
                n_imgs=args.n_imgs,
            )
        )


if __name__ == "__main__":
    main()
