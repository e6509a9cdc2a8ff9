"""Score a synthetic-scene run against its analytic GT: the port of
``scripts/eval_synthetic_demo.py``.

    python -m attentive_dfprior_tpu_torch.tools.eval_synthetic_demo <config.yaml> <output_dir>
        [--mesh final_mesh_eval_rec.ply] [--gt_resolution 192] [--n_imgs 0]

The README's quality table, with the evaluation contract of the
reference (ref: src/tools/eval_recon.py:99-125) applied to the scene the
config describes:

  - 3D accuracy / completion / completion ratio of ``mesh/<--mesh>``
    against the GT mesh (marching cubes of the scene's SDF at
    ``--gt_resolution``) culled to the last checkpoint's GT trajectory;
  - ATE RMSE of the last checkpoint, aligned (``tools/eval_ate.py``) and
    unaligned;
  - with ``--n_imgs`` > 0, the 2D depth L1 over that many random interior
    views, rendered by the port's native rasterizer.

All of it runs on the host (numpy, scipy and the native library), so the
tool takes no device.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from attentive_dfprior_tpu_torch.camera import Camera


def culled_gt(cfg: Dict[str, Any], cam, gt_poses: np.ndarray, gt_resolution: int = 192):
    """The scene's GT mesh and that mesh culled to ``gt_poses``' frusta:
    (gt verts, gt faces, culled verts, culled faces)."""
    from attentive_dfprior_tpu_torch.tools.cull_mesh import cull_mesh
    from attentive_dfprior_tpu_torch.utils.synthetic import SyntheticScene

    gt_v, gt_f, _ = SyntheticScene.from_config(cfg).gt_mesh(resolution=gt_resolution)
    gt_cv, gt_cf = cull_mesh(gt_v, gt_f, gt_poses, **_cam_kw(cam))
    return gt_v, gt_f, gt_cv, gt_cf


def _cam_kw(cam) -> Dict[str, Any]:
    return dict(H=int(cam.H), W=int(cam.W), fx=float(cam.fx), fy=float(cam.fy), cx=float(cam.cx), cy=float(cam.cy))


def score_meshes(cfg: Dict[str, Any], cam, meshes: Sequence[Tuple[np.ndarray, np.ndarray]], gt_poses: np.ndarray,
                 gt_resolution: int = 192) -> List[Dict[str, float]]:
    """accuracy / completion (cm) and completion ratio (%) of each (verts,
    faces) against the GT culled to ``gt_poses`` (200k surface samples,
    ICP-aligned)."""
    from attentive_dfprior_tpu_torch.tools.eval_recon import calc_3d_metric

    _, _, gt_cv, gt_cf = culled_gt(cfg, cam, gt_poses, gt_resolution)
    return [calc_3d_metric(verts, faces, gt_cv, gt_cf, n_samples=200_000) for verts, faces in meshes]


def evaluate(config: str, output_dir: str, mesh: str = "final_mesh_eval_rec.ply", gt_resolution: int = 192,
             n_imgs: int = 0, log=print) -> Dict[str, Any]:
    """The tool on a run's output directory; returns its record."""
    from attentive_dfprior_tpu_torch.config import default_config_path, load_config
    from attentive_dfprior_tpu_torch.tools.cull_mesh import unseen_pointcloud
    from attentive_dfprior_tpu_torch.tools.eval_ate import evaluate_ate
    from attentive_dfprior_tpu_torch.tools.eval_recon import calc_2d_metric, calc_3d_metric
    from attentive_dfprior_tpu_torch.utils.logger import latest_checkpoint
    from attentive_dfprior_tpu_torch.utils.ply import read_ply

    cfg = load_config(config, default_config_path())
    rec_path = os.path.join(output_dir, "mesh", mesh)
    if not os.path.exists(rec_path):
        alt = os.path.join(output_dir, "mesh", "final_mesh.ply")
        log(f"{rec_path} missing; using {alt}")
        rec_path = alt
    rec_v, rec_f, _ = read_ply(rec_path)

    # the GT culled to the trajectory (the reference evaluates against culled GT meshes)
    with np.load(latest_checkpoint(os.path.join(output_dir, "ckpts"))) as ck:
        gt_poses, est, n = ck["gt_c2w_list"], ck["estimate_c2w_list"], int(ck["idx"]) + 1
    cam = Camera(**{k: cfg["cam"][k] for k in ("H", "W", "fx", "fy", "cx", "cy")})
    gt_v, gt_f, gt_cv, gt_cf = culled_gt(cfg, cam, gt_poses, gt_resolution)
    out: Dict[str, Any] = {"mesh": rec_path, "n_rec_verts": len(rec_v), "n_gt_culled_verts": len(gt_cv)}
    out["metrics_3d"] = calc_3d_metric(rec_v, rec_f, gt_cv, gt_cf, n_samples=200_000)

    # ATE (only meaningful when tracking was real)
    t_err = np.linalg.norm(est[:n, :3, 3] - gt_poses[:n, :3, 3], axis=1)
    out["ate_rmse_cm_unaligned"] = float(np.sqrt((t_err**2).mean()) * 100)
    gt_assoc = {float(i): gt_poses[i] for i in range(n) if np.isfinite(gt_poses[i]).all()}
    est_assoc = {float(i): est[i] for i in range(n)}
    try:
        out["ate_rmse_cm"] = float(evaluate_ate(gt_assoc, est_assoc)["absolute_translational_error.rmse"] * 100)
    except ValueError as e:  # fewer than two poses
        out["ate_error"] = str(e)

    if n_imgs > 0:
        pc_unseen = unseen_pointcloud(gt_v, gt_f, gt_poses, **_cam_kw(cam))
        out["metrics_2d"] = calc_2d_metric(rec_v, rec_f, gt_cv, gt_cf, pc_unseen=pc_unseen, n_imgs=n_imgs)
    return out


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("config")
    ap.add_argument("output_dir")
    ap.add_argument("--mesh", default="final_mesh_eval_rec.ply")
    ap.add_argument("--gt_resolution", type=int, default=192)
    ap.add_argument("--n_imgs", type=int, default=0, help="2D views (0: skip the 2D metric)")
    args = ap.parse_args(argv)
    out = evaluate(args.config, args.output_dir, args.mesh, args.gt_resolution, args.n_imgs)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
