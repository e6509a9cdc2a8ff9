"""TSDF-prior construction (the reference's get_tsdf.py pipeline).

The port of the JAX package's ``tsdf/builder.py``: walk the dataset every
``space`` frames, fuse its depth into a device TSDF volume, and save the
volume, its bounds, its observedness mask and a marching-cubes mesh
(ref: get_tsdf.py:44-138).

Usage (the port's counterpart of ``get_tsdf.py``):
    python -m attentive_dfprior_tpu_torch.tsdf.builder configs/Replica/room0.yaml \\
        [--input_folder F] [--space N] [--output DIR] [--device cuda|cpu]

writes ``DIR/<id>_tsdf_volume.npz`` and ``DIR/<id>_mesh.ply``; ``DIR``
defaults to ``<dataset>_tsdf_volume``, where ``SLAMSystem`` looks for a
cached prior. ``--input_folder`` overrides the config's
``data.input_folder`` (a dataset moved elsewhere). Runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from attentive_dfprior_tpu_torch.camera import Camera
from attentive_dfprior_tpu_torch.models.scene import load_bound
from attentive_dfprior_tpu_torch.tsdf.fusion import TSDFVolume
from attentive_dfprior_tpu_torch.utils.datasets import get_dataset
from attentive_dfprior_tpu_torch.utils.device import resolve_device
from attentive_dfprior_tpu_torch.utils.ply import write_ply


def build_tsdf_volume(
    cfg: Dict[str, Any],
    args=None,
    space: int = 10,
    voxel_size: float = 4.0 / 256,
    device=None,
    save_mesh_path: Optional[str] = None,
) -> Tuple[torch.Tensor, np.ndarray, TSDFVolume]:
    """Fuse the dataset's depth stream into a TSDF volume on ``device``
    (the card by default; ``"cpu"`` on request); with ``save_mesh_path``,
    also write the volume's mesh there.

    Returns:
        (tsdf (X, Y, Z) tensor, adjusted bounds (3, 2), volume object).
    """
    cam = Camera.from_config(cfg)
    vol = TSDFVolume(load_bound(cfg), voxel_size=voxel_size, device=resolve_device(device))
    frame_reader = get_dataset(cfg, args, cfg.get("scale", 1))
    K = cam.K.astype(np.float32)
    frame_reader.prefetch(range(0, len(frame_reader), space))
    for idx in range(0, len(frame_reader), space):
        _, gt_color, gt_depth, gt_c2w = frame_reader[idx]
        c2w = np.asarray(gt_c2w, dtype=np.float64).copy()
        if not np.isfinite(c2w).all():
            continue
        # OpenGL -> OpenCV for projection (ref: get_tsdf.py:79-83)
        c2w[:3, 1] *= -1.0
        c2w[:3, 2] *= -1.0
        color255 = (np.asarray(gt_color) * 255).astype(np.float32)
        vol.integrate(color255, np.asarray(gt_depth, np.float32), K, c2w)
    if save_mesh_path:
        verts, faces, normals, colors = vol.get_mesh()
        write_ply(save_mesh_path, verts, faces, colors=colors, normals=normals)
    return vol.device_volume(), vol.vol_bnds.astype(np.float32), vol


def save_tsdf_volume(
    cfg: Dict[str, Any],
    args=None,
    space: int = 10,
    out_dir: Optional[str] = None,
    device=None,
) -> str:
    """Build and save ``<out_dir>/<prefix>_tsdf_volume.npz`` (the JAX
    package's layout, ref: get_tsdf.py:101-138) and its mesh, fusing on
    ``device`` (the card by default; ``"cpu"`` on request); returns the
    ``.npz`` path."""
    dataset = cfg["data"]["dataset"]
    scene_id = cfg["data"]["id"]
    out_dir = out_dir or f"{dataset}_tsdf_volume"
    os.makedirs(out_dir, exist_ok=True)
    prefix = f"scene{scene_id}" if dataset == "scannet" else f"{scene_id}"
    voxel_size = float(cfg.get("tsdf", {}).get("voxel_size", 4.0 / 256))
    tsdf, bounds, vol = build_tsdf_volume(
        cfg, args, space=space, voxel_size=voxel_size, device=device,
        save_mesh_path=os.path.join(out_dir, f"{prefix}_mesh.ply"),
    )
    out = os.path.join(out_dir, f"{prefix}_tsdf_volume.npz")
    np.savez_compressed(
        out,
        tsdf=tsdf.cpu().numpy(),
        bounds=bounds,
        voxel_size=np.float32(voxel_size),
        space=np.int32(space),
        observed=vol.observed_mask(),
    )
    return out


def main(argv: Optional[List[str]] = None) -> str:
    from attentive_dfprior_tpu_torch.config import default_config_path, load_config

    parser = argparse.ArgumentParser(description="Build the TSDF prior volume of a scene (PyTorch/CUDA port).")
    parser.add_argument("config", type=str, help="path to the scene config")
    parser.add_argument("--input_folder", type=str, help="overrides the config's input path")
    parser.add_argument("--output", type=str, default=None,
                        help="directory for the volume and mesh (default: <dataset>_tsdf_volume)")
    parser.add_argument("--space", type=int, default=None,
                        help="fuse every space-th frame (default: the config's tsdf.space, else 10)")
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    cfg = load_config(args.config, default_config_path())
    space = args.space if args.space is not None else int(cfg.get("tsdf", {}).get("space", 10))
    out = save_tsdf_volume(cfg, args, space=space, out_dir=args.output, device=args.device)
    print(f"Saved TSDF volume to {out}")
    return out


if __name__ == "__main__":
    main()
