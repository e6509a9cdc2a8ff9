"""Procedural synthetic RGB-D scene (analytic SDF raycaster).

Unique to this framework: a fully self-contained room scene (walls + sphere +
box) rendered by sphere tracing, providing exact GT depth, color, poses, and
mesh. Used by integration tests, the benchmark harness, and the demo config —
the reference can only run on downloaded Replica/ScanNet data.

A copy of the JAX package's ``utils/synthetic.py`` (numpy only); its
``gt_mesh`` runs the port's marching tetrahedra.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np


def _sd_box(p: np.ndarray, center: np.ndarray, half: np.ndarray) -> np.ndarray:
    """Signed distance to an axis-aligned box (negative inside)."""
    q = np.abs(p - center) - half
    outside = np.linalg.norm(np.maximum(q, 0.0), axis=-1)
    inside = np.minimum(np.max(q, axis=-1), 0.0)
    return outside + inside


def _sd_sphere(p: np.ndarray, center: np.ndarray, r: float) -> np.ndarray:
    return np.linalg.norm(p - center, axis=-1) - r


@dataclasses.dataclass
class SyntheticScene:
    """Room interior with two objects; everything analytic."""

    H: int = 120
    W: int = 160
    fx: float = 120.0
    fy: float = 120.0
    cx: float = 79.5
    cy: float = 59.5
    room_half: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([2.0, 1.5, 2.0])
    )
    sphere_c: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.7, -0.7, -0.5])
    )
    sphere_r: float = 0.45
    box_c: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([-0.9, -1.0, 0.6])
    )
    box_half: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.45, 0.5, 0.35])
    )
    arc_degrees: float = 120.0  # total trajectory arc

    @staticmethod
    def from_config(cfg: Dict[str, Any]) -> "SyntheticScene":
        cam = cfg["cam"]
        return SyntheticScene(
            H=int(cam["H"]),
            W=int(cam["W"]),
            fx=float(cam["fx"]),
            fy=float(cam["fy"]),
            cx=float(cam["cx"]),
            cy=float(cam["cy"]),
            arc_degrees=float(cfg["data"].get("arc_degrees", 120.0)),
        )

    # ---------------- geometry ----------------

    def sdf(self, p: np.ndarray) -> np.ndarray:
        """Scene SDF (positive in free space inside the room)."""
        room = -_sd_box(p, np.zeros(3), self.room_half)  # distance to walls
        sph = _sd_sphere(p, self.sphere_c, self.sphere_r)
        box = _sd_box(p, self.box_c, self.box_half)
        return np.minimum(room, np.minimum(sph, box))

    def object_id(self, p: np.ndarray) -> np.ndarray:
        room = -_sd_box(p, np.zeros(3), self.room_half)
        sph = _sd_sphere(p, self.sphere_c, self.sphere_r)
        box = _sd_box(p, self.box_c, self.box_half)
        stack = np.stack([room, sph, box], axis=-1)
        return np.argmin(stack, axis=-1)

    def color_at(self, p: np.ndarray) -> np.ndarray:
        """Procedural albedo with spatial texture (so photometric losses are
        informative)."""
        oid = self.object_id(p)
        base = np.array(
            [[0.75, 0.72, 0.65], [0.85, 0.25, 0.2], [0.2, 0.4, 0.85]]
        )[oid]
        tex = 0.12 * np.sin(6.0 * p[..., 0:1]) * np.sin(5.0 * p[..., 1:2]) + 0.08 * np.sin(
            9.0 * p[..., 2:3]
        )
        return np.clip(base + tex, 0.0, 1.0).astype(np.float32)

    # ---------------- camera path ----------------

    def pose_at(self, s: float) -> np.ndarray:
        """OpenGL c2w on a circular-arc trajectory looking at the room center.

        The arc span is configurable (data.arc_degrees); real RGB-D captures
        move millimeters per frame, and render-based trackers assume small
        motion (the reference's const-speed model, ref: src/Tracker.py:203-209),
        so tracking validations should use a small arc / many frames.
        """
        ang = np.deg2rad(self.arc_degrees) * s
        eye = np.array(
            [1.1 * np.cos(ang), 0.25 * np.sin(2 * ang), 1.1 * np.sin(ang)]
        )
        target = np.array([0.0, -0.3, 0.0])
        up = np.array([0.0, 1.0, 0.0])
        fwd = target - eye
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, up)
        right = right / np.linalg.norm(right)
        up2 = np.cross(right, fwd)
        c2w = np.eye(4, dtype=np.float64)
        c2w[:3, 0] = right
        c2w[:3, 1] = up2
        c2w[:3, 2] = -fwd  # OpenGL: -z forward
        c2w[:3, 3] = eye
        return c2w.astype(np.float32)

    # ---------------- rendering ----------------

    def render(self, c2w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Sphere-trace a full frame.

        Returns:
            color (H, W, 3) float32 in [0,1], depth (H, W) float32 z-depth
            (same parameterization the volume renderer uses: t along the
            unnormalized ray [(i-cx)/fx, -(j-cy)/fy, -1]).
        """
        H, W = self.H, self.W
        jj, ii = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        dirs = np.stack(
            [
                (ii - self.cx) / self.fx,
                -(jj - self.cy) / self.fy,
                -np.ones_like(ii, dtype=np.float64),
            ],
            axis=-1,
        )
        R = c2w[:3, :3].astype(np.float64)
        d_world = dirs @ R.T  # (H, W, 3)
        o = c2w[:3, 3].astype(np.float64)

        norm = np.linalg.norm(d_world, axis=-1)
        t = np.full((H, W), 0.05, dtype=np.float64)
        hit = np.zeros((H, W), dtype=bool)
        for _ in range(96):
            p = o + d_world * t[..., None]
            d = self.sdf(p)
            hit |= d < 1e-4
            step = np.clip(d, 1e-5, None) / norm
            t = np.where(hit, t, t + step * 0.9)
            t = np.minimum(t, 20.0)
        p = o + d_world * t[..., None]
        color = self.color_at(p)
        depth = np.where(hit, t, 0.0).astype(np.float32)
        return color.astype(np.float32), depth

    def gt_mesh(self, resolution: int = 96, use_native: bool = True):
        """Marching-cubes GT mesh of the scene surface (for recon eval):
        (verts, faces, normals) in world coordinates."""
        from attentive_dfprior_tpu_torch.utils.marching_cubes import marching_cubes

        h = self.room_half * 1.02
        xs = np.linspace(-h[0], h[0], resolution)
        ys = np.linspace(-h[1], h[1], resolution)
        zs = np.linspace(-h[2], h[2], resolution)
        X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
        pts = np.stack([X, Y, Z], axis=-1)
        vol = self.sdf(pts.reshape(-1, 3)).reshape(resolution, resolution, resolution)
        # surface at sdf == 0; inside objects sdf < 0
        verts, faces, normals = marching_cubes(-vol, level=0.0, use_native=use_native)
        spacing = np.array([xs[1] - xs[0], ys[1] - ys[0], zs[1] - zs[0]], dtype=np.float64)
        verts = verts * spacing + np.array([xs[0], ys[0], zs[0]])
        return verts, faces, normals
