"""Mesh culling: drop faces never seen by any camera of a trajectory.

The port's copy of the JAX package's ``tools/cull_mesh.py`` (numpy only).
Equivalent of the reference's src/tools/cull_mesh.py:22-76 (used to produce
culled GT meshes for evaluation). Intrinsics default to the Replica camera,
as the reference hardcodes (ref: cull_mesh.py:32-39), but are configurable.
"""

from __future__ import annotations

import argparse

import numpy as np

from attentive_dfprior_tpu_torch.utils.mesh import reindex_mesh
from attentive_dfprior_tpu_torch.utils.ply import read_ply, write_ply


def cull_mesh(
    verts: np.ndarray,
    faces: np.ndarray,
    poses: np.ndarray,
    H: int = 680,
    W: int = 1200,
    fx: float = 600.0,
    fy: float = 600.0,
    cx: float = 599.5,
    cy: float = 339.5,
):
    """Keep faces with at least one vertex inside some frustum."""
    seen = np.zeros(len(verts), dtype=bool)
    homo = np.concatenate([verts, np.ones((len(verts), 1))], axis=1)
    for i in range(len(poses)):
        c2w = poses[i].astype(np.float64)
        if not np.isfinite(c2w).all() or np.allclose(c2w, 0):
            continue
        w2c = np.linalg.inv(c2w)
        cam = (w2c @ homo.T).T[:, :3]
        cam[:, 0] *= -1
        z = cam[:, 2] + 1e-8
        u = fx * cam[:, 0] / z + cx
        v = fy * cam[:, 1] / z + cy
        seen |= (u < W) & (u > 0) & (v < H) & (v > 0) & (z < 0)
    keep = seen[faces].any(axis=1)
    return reindex_mesh(verts, faces[keep])


def unseen_pointcloud(
    verts: np.ndarray,
    faces: np.ndarray,
    poses: np.ndarray,
    n_samples: int = 10_000,
    seed: int = 0,
    **cam_kwargs,
) -> np.ndarray:
    """Surface samples of the NEVER-SEEN mesh region.

    Counterpart of the reference ecosystem's ``*_pc_unseen.npy`` artifact
    (consumed by eval_recon's 2D depth-L1 view rejection,
    ref: src/tools/eval_recon.py:152-183): points on faces culled away by
    the trajectory's frustums.
    """
    seen = np.zeros(len(verts), dtype=bool)
    homo = np.concatenate([verts, np.ones((len(verts), 1))], axis=1)
    H = cam_kwargs.get("H", 680)
    W = cam_kwargs.get("W", 1200)
    fx = cam_kwargs.get("fx", 600.0)
    fy = cam_kwargs.get("fy", 600.0)
    cx = cam_kwargs.get("cx", 599.5)
    cy = cam_kwargs.get("cy", 339.5)
    for i in range(len(poses)):
        c2w = poses[i].astype(np.float64)
        if not np.isfinite(c2w).all() or np.allclose(c2w, 0):
            continue
        w2c = np.linalg.inv(c2w)
        cam = (w2c @ homo.T).T[:, :3]
        cam[:, 0] *= -1
        z = cam[:, 2] + 1e-8
        u = fx * cam[:, 0] / z + cx
        v = fy * cam[:, 1] / z + cy
        seen |= (u < W) & (u > 0) & (v < H) & (v > 0) & (z < 0)
    unseen_faces = faces[~seen[faces].any(axis=1)]
    if len(unseen_faces) == 0:
        return np.zeros((0, 3))
    rng = np.random.default_rng(seed)
    v0 = verts[unseen_faces[:, 0]]
    v1 = verts[unseen_faces[:, 1]]
    v2 = verts[unseen_faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    if areas.sum() <= 0:
        return np.zeros((0, 3))
    idx = rng.choice(len(unseen_faces), size=n_samples, p=areas / areas.sum())
    r1 = np.sqrt(rng.uniform(size=(n_samples, 1)))
    r2 = rng.uniform(size=(n_samples, 1))
    return (1 - r1) * v0[idx] + r1 * (1 - r2) * v1[idx] + r1 * r2 * v2[idx]


def main():
    parser = argparse.ArgumentParser(description="cull mesh by camera frustums")
    parser.add_argument("--input_mesh", required=True)
    parser.add_argument("--output_mesh", required=True)
    parser.add_argument("--traj", required=True, help="traj.txt (Replica format) or ckpt .npz")
    parser.add_argument("--H", type=int, default=680)
    parser.add_argument("--W", type=int, default=1200)
    parser.add_argument("--fx", type=float, default=600.0)
    parser.add_argument("--fy", type=float, default=600.0)
    parser.add_argument("--cx", type=float, default=599.5)
    parser.add_argument("--cy", type=float, default=339.5)
    parser.add_argument(
        "--save_unseen_pc",
        help="also write the unseen-region pointcloud (.npy) consumed by "
        "eval_recon's 2D depth-L1 view rejection",
    )
    args = parser.parse_args()

    verts, faces, colors = read_ply(args.input_mesh)
    if args.traj.endswith(".npz"):
        poses = np.load(args.traj)["gt_c2w_list"]
    else:
        rows = np.loadtxt(args.traj).reshape(-1, 4, 4)
        rows[:, :3, 1] *= -1
        rows[:, :3, 2] *= -1  # OpenCV -> OpenGL like the dataset loaders
        poses = rows
    verts2, faces2 = cull_mesh(
        verts, faces, poses, args.H, args.W, args.fx, args.fy, args.cx, args.cy
    )
    write_ply(args.output_mesh, verts2, faces2)
    print(f"culled {len(faces) - len(faces2)} / {len(faces)} faces -> {args.output_mesh}")
    if args.save_unseen_pc:
        pc = unseen_pointcloud(
            verts, faces, poses, H=args.H, W=args.W,
            fx=args.fx, fy=args.fy, cx=args.cx, cy=args.cy,
        )
        np.save(args.save_unseen_pc, pc)
        print(f"unseen pointcloud ({len(pc)} pts) -> {args.save_unseen_pc}")


if __name__ == "__main__":
    main()
