"""Camera model: intrinsics bookkeeping and preprocessing-aware updates.

A copy of the JAX package's ``camera.py`` (numpy only).

Mirrors the reference semantics of crop/resize intrinsic fixups
(ref: src/DF_Prior.py:133-155, get_tsdf.py:12-41) in one reusable dataclass.
Convention throughout the framework (same as the reference / NICE-SLAM):
OpenGL-style camera, -z forward, +x right, +y up; ray directions are
``[(i-cx)/fx, -(j-cy)/fy, -1]`` rotated by the camera-to-world rotation.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera intrinsics (after preprocessing)."""

    H: int
    W: int
    fx: float
    fy: float
    cx: float
    cy: float

    @property
    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float64,
        )

    @staticmethod
    def from_config(cfg: Dict[str, Any]) -> "Camera":
        """Build the effective camera from a config dict.

        Applies crop_size (resize) and crop_edge adjustments exactly as the
        reference does (ref: src/DF_Prior.py:133-155).
        """
        cam = cfg["cam"]
        H, W = int(cam["H"]), int(cam["W"])
        fx, fy, cx, cy = (
            float(cam["fx"]),
            float(cam["fy"]),
            float(cam["cx"]),
            float(cam["cy"]),
        )
        crop_size = cam.get("crop_size")
        if crop_size is not None:
            sx = crop_size[1] / W
            sy = crop_size[0] / H
            fx, fy = sx * fx, sy * fy
            cx, cy = sx * cx, sy * cy
            W, H = int(crop_size[1]), int(crop_size[0])
        edge = int(cam.get("crop_edge", 0))
        if edge > 0:
            H -= 2 * edge
            W -= 2 * edge
            cx -= edge
            cy -= edge
        return Camera(H=H, W=W, fx=fx, fy=fy, cx=cx, cy=cy)


def as_intrinsics_matrix(intrinsics) -> np.ndarray:
    """[fx, fy, cx, cy] -> 3x3 K (ref: src/common.py:8-18)."""
    K = np.eye(3)
    K[0, 0], K[1, 1] = intrinsics[0], intrinsics[1]
    K[0, 2], K[1, 2] = intrinsics[2], intrinsics[3]
    return K
