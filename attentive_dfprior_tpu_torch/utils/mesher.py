"""Mesher: marching-cubes extraction of the learned scene surface.

The port of the JAX package's ``utils/mesher.py`` (ref: src/utils/Mesher.py):

  - occupancy queried on a uniform lattice through ``eval_points_chunk``
    (stage 'high') in chunks of ``points_batch_size`` points, with the
    decoder MLPs through K2 on the card (``use_fused``) and through the
    plain MLP on the CPU; on the card every chunk replays one captured
    program, the last chunk padded with zeros as the JAX package pads it
    (``models/decoders.py:query_points``; an eager ``ForwardGraphs`` runs
    each chunk in Python); points outside the hull take occ = 100 and are not
    queried (the JAX package queries and then overwrites them);
  - the scene hull from keyframe depth back-projections and camera centres
    (ref: Mesher.py:219-284, without open3d);
  - hull-sheet artifacts dropped by a second field query at the vertices
    (``remove_hull_artifacts``, the JAX package's addition);
  - faces culled by keyframe-frustum visibility, small components dropped
    (ref: Mesher.py:488-510);
  - vertex colors by a point query at stage 'color' (ref: Mesher.py:514-529).

``last_timings`` holds the seconds of the last ``get_mesh``: the field
queries on the device (``field_s``, ending in the copy to the host) and the
host steps (``host_s``: lattice, hull, marching tetrahedra, culling, PLY).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from attentive_dfprior_tpu_torch.camera import Camera
from attentive_dfprior_tpu_torch.models.decoders import query_points
from attentive_dfprior_tpu_torch.utils.marching_cubes import marching_cubes
from attentive_dfprior_tpu_torch.utils.mesh import (
    convex_hull_mesh,
    cull_faces_by_vertex_mask,
    filter_small_components,
    points_in_hull,
    reindex_mesh,
)
from attentive_dfprior_tpu_torch.utils.ply import write_ply
from attentive_dfprior_tpu_torch.utils.step_graph import ForwardGraphs


class Mesher:
    """Args:
        cfg: merged config (``meshing``, ``mapping.marching_cubes_bound``).
        cam: the camera of the keyframes.
        bound: (3, 2) scene bound; tsdf_bnds: (3, 2) prior bound.
        device: where the field is queried.
        use_native: marching tetrahedra in C++ (built with g++ on first use)
            or the numpy golden.
        graphs: the field query's programs, as the Renderer's
            (``render/renderer.py:Renderer``).
    """

    def __init__(
        self,
        cfg: Dict[str, Any],
        cam: Camera,
        bound: np.ndarray,
        tsdf_bnds,
        device: torch.device,
        points_batch_size: int = 2**17,
        use_native: bool = True,
        graphs: Optional[ForwardGraphs] = None,
    ):
        mcfg = cfg["meshing"]
        self.cam = cam
        self.device = torch.device(device)
        self.bound = torch.as_tensor(np.asarray(bound), dtype=torch.float32, device=self.device)
        self.tsdf_bnds = torch.as_tensor(np.asarray(tsdf_bnds), dtype=torch.float32, device=self.device)
        self.resolution = int(mcfg["resolution"])
        self.level_set = float(mcfg["level_set"])
        self.clean_mesh_bound_scale = float(mcfg["clean_mesh_bound_scale"])
        self.remove_small_geometry_threshold = float(mcfg["remove_small_geometry_threshold"])
        self.get_largest_components = bool(mcfg["get_largest_components"])
        self.remove_hull_artifacts = bool(mcfg.get("remove_hull_artifacts", True))
        self.points_batch_size = points_batch_size
        # a pure forward query: K2 on the card, as Renderer.use_fused
        self.use_fused = self.device.type == "cuda"
        self.graphs = graphs if graphs is not None else ForwardGraphs(None, self.device)
        self.use_native = use_native
        self.scale = float(cfg.get("scale", 1))
        self.marching_cubes_bound = np.array(cfg["mapping"]["marching_cubes_bound"], dtype=np.float64) * self.scale
        self.verbose = bool(cfg.get("verbose", False))
        self.last_timings: Dict[str, float] = {}
        self._field_s = 0.0

    def get_grid_uniform(self, resolution: int):
        """Padded uniform query lattice (ref: Mesher.py:365-393)."""
        b = self.marching_cubes_bound
        padding = 0.05
        x = np.linspace(b[0][0] - padding, b[0][1] + padding, resolution)
        y = np.linspace(b[1][0] - padding, b[1][1] + padding, resolution)
        z = np.linspace(b[2][0] - padding, b[2][1] + padding, resolution)
        return x, y, z

    @torch.no_grad()
    def eval_points(self, params, points: np.ndarray, tsdf_volume: torch.Tensor, stage: str = "high") -> np.ndarray:
        """Chunked occupancy / color query (ref: Mesher.py:286-326); (N, 4)
        raw outputs on the host."""
        t0 = time.perf_counter()
        pts = torch.as_tensor(np.asarray(points, dtype=np.float32), device=self.device)
        out = query_points(self.graphs, params, pts, tsdf_volume, self.tsdf_bnds, self.bound, stage,
                           self.points_batch_size, self.use_fused).cpu().numpy()
        self._field_s += time.perf_counter() - t0
        return out

    def get_bound_from_frames(self, kf_depths: np.ndarray, kf_c2w: np.ndarray, depth_stride: int = 8):
        """Convex hull (Delaunay) of observed geometry + camera centres
        (role of ref: Mesher.py:219-284)."""
        cam = self.cam
        pts: List[np.ndarray] = [kf_c2w[:, :3, 3]]
        jj, ii = np.meshgrid(np.arange(0, cam.H, depth_stride), np.arange(0, cam.W, depth_stride), indexing="ij")
        dirs = np.stack(
            [(ii - cam.cx) / cam.fx, -(jj - cam.cy) / cam.fy, -np.ones_like(ii, dtype=np.float64)], axis=-1
        ).reshape(-1, 3)
        for k in range(len(kf_depths)):
            d = kf_depths[k][::depth_stride, ::depth_stride].reshape(-1)
            valid = d > 0
            if not valid.any():
                continue
            R = kf_c2w[k][:3, :3]
            o = kf_c2w[k][:3, 3]
            pts.append(o + (dirs[valid] @ R.T) * d[valid][:, None])
        _, _, dela = convex_hull_mesh(np.concatenate(pts, axis=0), scale=self.clean_mesh_bound_scale)
        return dela

    def point_masks(
        self,
        points: np.ndarray,
        kf_c2w: np.ndarray,
        kf_max_depths: np.ndarray,
        all_c2w: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Seen mask: in some keyframe frustum, in front, within 1.1 x its
        max depth (ref: Mesher.py:58-217, depth_test=False); with
        ``all_c2w``, every frame pose and no depth limit (eval_rec mode,
        ref: Mesher.py:93-130)."""
        cam = self.cam
        poses = all_c2w if all_c2w is not None else kf_c2w
        seen = np.zeros(len(points), dtype=bool)
        homo = np.concatenate([points, np.ones((len(points), 1))], axis=1)
        for k in range(len(poses)):
            c2w = poses[k].astype(np.float64)
            if not np.isfinite(c2w).all():
                continue
            camp = (np.linalg.inv(c2w) @ homo.T).T[:, :3]
            camp[:, 0] *= -1
            z = camp[:, 2] + 1e-8
            u = cam.fx * camp[:, 0] / z + cam.cx
            v = cam.fy * camp[:, 1] / z + cam.cy
            m = (u < cam.W) & (u > 0) & (v < cam.H) & (v > 0) & (z < 0)
            if all_c2w is None:
                m &= (-camp[:, 2]) < kf_max_depths[k] * 1.1
            seen |= m
        return seen

    def get_mesh(
        self,
        mesh_out_file: str,
        params: Any,
        tsdf_volume: torch.Tensor,
        kf_depths: np.ndarray,
        kf_c2w: np.ndarray,
        estimate_c2w_list: Optional[np.ndarray] = None,
        idx: Optional[int] = None,
        color: bool = True,
        clean_mesh: bool = True,
        get_mask_use_all_frames: bool = False,
    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Extract, clean, colour and write the scene mesh
        (ref: Mesher.py:395-542). Returns (verts, faces) as written, or None
        when the field has no surface."""
        t_start = time.perf_counter()
        self._field_s = 0.0
        out = self._extract(
            mesh_out_file, params, tsdf_volume, kf_depths, kf_c2w, estimate_c2w_list, idx, color,
            clean_mesh, get_mask_use_all_frames,
        )
        total = time.perf_counter() - t_start
        self.last_timings = {"field_s": self._field_s, "host_s": total - self._field_s, "total_s": total}
        return out

    def _extract(
        self, mesh_out_file, params, tsdf_volume, kf_depths, kf_c2w, estimate_c2w_list, idx, color,
        clean_mesh, get_mask_use_all_frames,
    ):
        xs, ys, zs = self.get_grid_uniform(self.resolution)
        X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
        points = np.stack([X, Y, Z], axis=-1).reshape(-1, 3).astype(np.float32)

        if len(kf_depths) > 0:
            in_hull = points_in_hull(points, self.get_bound_from_frames(kf_depths, kf_c2w))
        else:
            in_hull = np.ones(len(points), dtype=bool)

        # out-of-hull points take occ = 100 (ref: Mesher.py:450): query only
        # the others
        occ = np.full(len(points), 100.0, dtype=np.float32)
        occ[in_hull] = self.eval_points(params, points[in_hull], tsdf_volume, stage="high")[:, 3]
        vol = occ.reshape(len(xs), len(ys), len(zs))
        verts, faces, _ = marching_cubes(
            vol, level=self.level_set, spacing=(xs[1] - xs[0], ys[1] - ys[0], zs[1] - zs[0]),
            use_native=self.use_native,
        )
        if len(faces) == 0:
            print("marching_cubes: no surface extracted")
            return None
        verts = verts + np.array([xs[0], ys[0], zs[0]])

        if self.remove_hull_artifacts:
            # the out-of-hull occ = 100 override makes a zero-crossing sheet
            # at the hull, which survives frustum culling where the hull cuts
            # unobserved air; its vertices sit in clearly free space, real
            # surface vertices at the field's zero crossing: drop faces whose
            # vertices are all clearly free
            occ_v = self.eval_points(params, verts.astype(np.float32), tsdf_volume, stage="high")[:, 3]
            faces = faces[~(occ_v < -0.5)[faces].all(axis=1)]
            verts, faces = reindex_mesh(verts, faces)

        if clean_mesh and len(kf_c2w) > 0:
            kf_max_d = np.array([d.max() for d in kf_depths])
            all_c2w = None
            if get_mask_use_all_frames and estimate_c2w_list is not None:
                all_c2w = estimate_c2w_list[: (idx or 0) + 1]
            seen = self.point_masks(verts, kf_c2w, kf_max_d, all_c2w=all_c2w)
            faces = cull_faces_by_vertex_mask(verts, faces, ~seen)
            verts, faces = reindex_mesh(verts, faces)
            verts, faces = filter_small_components(
                verts, faces, min_area=self.remove_small_geometry_threshold * self.scale * self.scale,
                keep_largest_only=self.get_largest_components,
            )

        vertex_colors = None
        if color and len(verts) > 0:
            rgb = self.eval_points(params, verts.astype(np.float32), tsdf_volume, stage="color")[:, :3]
            vertex_colors = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)

        verts_out = verts / self.scale
        write_ply(mesh_out_file, verts_out, faces, colors=vertex_colors)
        if self.verbose:
            print("Saved mesh at", mesh_out_file)
        return verts_out, faces
