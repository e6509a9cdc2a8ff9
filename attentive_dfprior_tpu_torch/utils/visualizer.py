"""Visualization: rendered-vs-input depth and colour panels.

The port of the JAX package's ``utils/visualizer.py`` (ref:
src/utils/Visualizer.py:8-123). When its ``(idx, it)`` gate fires it renders
the full frame at the given pose (``Renderer.render_img``; on the card the
decoder MLPs run through K2, and each chunk replays a captured program
unless the run is eager, the Renderer's ``graphs``) and writes one PNG of
six panels,

    input depth      generated depth      depth residual
    input RGB        generated RGB        RGB residual

as ``<vis_dir>/<idx:05d>_<it:04d>.png``. Residuals are zero where the input
depth is 0; the three depth panels share the range [0, max input depth]
(1 for an empty frame), RGB is clipped to [0, 1]. The panel is composed in
numpy and written by a small PNG writer on ``zlib``: the port needs neither
matplotlib nor an image library, so the panels carry no titles, and the
depth colour map is a table of this module (a ramp through five colours of
matplotlib's ``plasma``), not matplotlib's.
"""

from __future__ import annotations

import os
import struct
import time
import zlib
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from attentive_dfprior_tpu_torch.ops.pose import homogenize, pose_matrix_from_tensor

# depth colour ramp, low to high (plasma's colours at 0, 1/4, 1/2, 3/4, 1)
DEPTH_COLORS = np.array(
    [[13, 8, 135], [126, 3, 168], [204, 71, 120], [248, 149, 64], [240, 249, 33]], dtype=np.float64
)
PANEL_GAP = 4  # white pixels between panels


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def panel_arrays(
    depth, color, gt_depth, gt_color
) -> Tuple[List[Tuple[str, np.ndarray]], float]:
    """The six panels' data from one render and its input frame.

    Returns:
        [(title, array)] in panel order (depth maps (H, W), RGB (H, W, 3)),
        and the depth panels' upper limit (max input depth, or 1.0).
    """
    depth, color = _numpy(depth), _numpy(color)
    gt_depth, gt_color = _numpy(gt_depth), _numpy(gt_color)
    depth_res = np.abs(gt_depth - depth)
    depth_res[gt_depth == 0.0] = 0.0
    color_res = np.abs(gt_color - color)
    color_res[gt_depth == 0.0] = 0.0
    max_depth = float(np.max(gt_depth)) or 1.0
    panels = [
        ("Input Depth", gt_depth),
        ("Generated Depth", depth),
        ("Depth Residual", depth_res),
        ("Input RGB", np.clip(gt_color, 0, 1)),
        ("Generated RGB", np.clip(color, 0, 1)),
        ("RGB Residual", np.clip(color_res, 0, 1)),
    ]
    return panels, max_depth


def colorize_depth(depth: np.ndarray, vmax: float) -> np.ndarray:
    """(H, W) depth -> (H, W, 3) uint8 through ``DEPTH_COLORS`` over [0, vmax]."""
    t = np.clip(np.nan_to_num(depth / vmax), 0.0, 1.0) * (len(DEPTH_COLORS) - 1)
    lo = np.minimum(np.floor(t).astype(np.int64), len(DEPTH_COLORS) - 2)
    w = (t - lo)[..., None]
    rgb = DEPTH_COLORS[lo] * (1.0 - w) + DEPTH_COLORS[lo + 1] * w
    return np.round(rgb).astype(np.uint8)


def compose_panels(panels: List[Tuple[str, np.ndarray]], max_depth: float) -> np.ndarray:
    """Six panels -> one (2H + gap, 3W + 2 gap, 3) uint8 image, 2 rows x 3."""
    tiles = [
        colorize_depth(a, max_depth) if a.ndim == 2 else np.round(np.nan_to_num(a) * 255).astype(np.uint8)
        for _, a in panels
    ]
    H, W = tiles[0].shape[:2]
    g = PANEL_GAP
    out = np.full((2 * H + g, 3 * W + 2 * g, 3), 255, dtype=np.uint8)
    for i, tile in enumerate(tiles):
        r, c = divmod(i, 3)
        out[r * (H + g) : r * (H + g) + H, c * (W + g) : c * (W + g) + W] = tile
    return out


def write_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image as an 8-bit RGB PNG (no filtering)."""
    H, W, _ = img.shape
    rows = np.concatenate([np.zeros((H, 1), np.uint8), np.ascontiguousarray(img).reshape(H, W * 3)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))


class Visualizer:
    """Writes a panel every ``freq`` frames, at every ``inside_freq``-th
    iteration of the frame's optimization; ``seconds`` accumulates the time
    spent."""

    def __init__(self, freq: int, inside_freq: int, vis_dir: str, renderer, verbose: bool = False):
        self.freq = freq
        self.inside_freq = inside_freq
        self.vis_dir = vis_dir
        self.renderer = renderer
        self.verbose = verbose
        self.seconds = 0.0
        os.makedirs(vis_dir, exist_ok=True)

    def vis(
        self,
        idx: int,
        it: int,
        gt_depth,
        gt_color,
        c2w_or_camera_tensor,
        params: Any,
        tsdf_volume: torch.Tensor,
    ) -> Optional[str]:
        """Write the panel of frame ``idx`` at iteration ``it`` if the gate
        fires; returns its path, else None. The pose is a (4, 4) / (3, 4)
        c2w or a (7,) camera tensor."""
        if idx % self.freq != 0 or it % self.inside_freq != 0:
            return None
        t0 = time.perf_counter()
        c2w = _numpy(c2w_or_camera_tensor)
        if c2w.ndim == 1:
            with torch.no_grad():
                c2w = homogenize(pose_matrix_from_tensor(torch.as_tensor(c2w, dtype=torch.float32))).numpy()
        depth, _, color = self.renderer.render_img(params, c2w, tsdf_volume, stage="color", gt_depth=_numpy(gt_depth))
        panels, max_depth = panel_arrays(depth, color, gt_depth, gt_color)
        out = os.path.join(self.vis_dir, f"{idx:05d}_{it:04d}.png")
        write_png(out, compose_panels(panels, max_depth))
        self.seconds += time.perf_counter() - t0
        if self.verbose:
            print(f"Saved rendering visualization at {out}")
        return out
