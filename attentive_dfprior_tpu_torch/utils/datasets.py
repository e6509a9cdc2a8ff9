"""RGB-D dataset loaders (host-side input pipeline, numpy only).

The port's counterpart of the JAX package's ``utils/datasets.py``. This
slice carries the procedural ``Synthetic`` scene; the file-backed loaders
(Replica, ScanNet, CoFusion, Azure, TUM-RGBD) read images with OpenCV and
are still to port (ROADMAP.md, "Modules to port": dataset loaders).
``get_dataset`` raises ``NotImplementedError`` for them.

Frames are numpy arrays ``(idx, color (H,W,3) f32 in [0,1], depth (H,W)
f32, c2w (4,4) f32 OpenGL)``; moving them to the device is the caller's job.

A synthetic frame is rendered once per process (``FRAME_CACHE``): the prior
builder, ``SLAMSystem`` and loop closure's final refine each read every
frame, and one numpy render of a 240x320 frame takes seconds on the host.
``prefetch`` renders the frames a reader is about to read in one thread per
CPU: numpy releases the interpreter lock in its array loops (16 frames of
240x320 took 38.5 s in turn and 5.0 s on 8 threads on an 8-core host).
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterable, List, Tuple

import numpy as np


class BaseDataset:
    """Sequence of (idx, color (H,W,3) f32, depth (H,W) f32, c2w (4,4) f32)."""

    def __init__(self, cfg: Dict[str, Any], args=None, scale: float = 1.0):
        self.name = cfg["dataset"]
        self.scale = scale
        self.png_depth_scale = cfg["cam"]["png_depth_scale"]
        self.distortion = (
            np.array(cfg["cam"]["distortion"]) if "distortion" in cfg["cam"] else None
        )
        self.crop_size = cfg["cam"].get("crop_size")
        self.crop_edge = cfg["cam"].get("crop_edge", 0)
        self.fx, self.fy = cfg["cam"]["fx"], cfg["cam"]["fy"]
        self.cx, self.cy = cfg["cam"]["cx"], cfg["cam"]["cy"]

        input_folder = getattr(args, "input_folder", None) if args else None
        self.input_folder = input_folder or cfg["data"]["input_folder"]

        self.color_paths: List[str] = []
        self.depth_paths: List[str] = []
        self.poses: List[np.ndarray] = []
        self.n_img = 0

    def __len__(self) -> int:
        return self.n_img

    def prefetch(self, indices: Iterable[int]) -> None:
        """Make frames ``indices`` ready ahead of their reads (nothing to do
        for a dataset that reads each frame on demand)."""


class Synthetic(BaseDataset):
    """Procedural scene rendered analytically — no files needed
    (see utils/synthetic.py for the scene definition)."""

    def __init__(self, cfg, args=None, scale=1.0):
        from attentive_dfprior_tpu_torch.utils.synthetic import SyntheticScene

        self.name = "synthetic"
        self.scale = scale
        self.crop_edge = cfg["cam"].get("crop_edge", 0)
        self.scene = SyntheticScene.from_config(cfg)
        self.n_img = int(cfg["data"].get("n_frames", 40))
        self.poses = [
            self.scene.pose_at(i / max(self.n_img - 1, 1)) for i in range(self.n_img)
        ]

    def prefetch(self, indices: Iterable[int]) -> None:
        FRAME_CACHE.render_many(self.scene, self.n_img, {i: self.poses[i] for i in indices})

    def __getitem__(self, index: int):
        c2w = self.poses[index]
        color, depth = FRAME_CACHE.render(self.scene, self.n_img, index, c2w)
        edge = self.crop_edge
        if edge > 0:
            color = color[edge:-edge, edge:-edge]
            depth = depth[edge:-edge, edge:-edge]
        # copies: a caller that writes into a frame must not change the cache
        return index, color.copy(), depth.copy(), c2w.astype(np.float32)


class FrameCache:
    """Rendered synthetic frames, keyed by the scene's fields, the sequence
    length (the poses depend on it) and the frame index; a frame is rendered
    once per process. Holds n_frames x H x W x 16 B (147 MB for
    room_tracking.yaml's 120 frames of 240x320); ``clear`` drops them."""

    def __init__(self) -> None:
        self._frames: Dict[tuple, Tuple[np.ndarray, np.ndarray]] = {}

    @staticmethod
    def _key(scene, n_img: int, index: int) -> tuple:
        fields = tuple(np.asarray(getattr(scene, f.name)).tobytes() for f in dataclasses.fields(scene))
        return fields, n_img, index

    def render(self, scene, n_img: int, index: int, c2w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(color, depth) of frame ``index`` at pose ``c2w``, rendered on
        the first request only."""
        key = self._key(scene, n_img, index)
        if key not in self._frames:
            self._frames[key] = scene.render(c2w)
        return self._frames[key]

    def render_many(self, scene, n_img: int, poses: Dict[int, np.ndarray]) -> None:
        """Render the frames of ``poses`` ({index: c2w}) not cached yet, in
        one thread per CPU."""
        todo = [i for i in poses if self._key(scene, n_img, i) not in self._frames]
        if not todo:
            return
        with ThreadPoolExecutor(max_workers=min(os.cpu_count() or 1, len(todo))) as pool:
            for i, frame in zip(todo, pool.map(scene.render, [poses[i] for i in todo])):
                self._frames[self._key(scene, n_img, i)] = frame

    def __len__(self) -> int:
        return len(self._frames)

    def clear(self) -> None:
        self._frames.clear()


FRAME_CACHE = FrameCache()

dataset_dict = {"synthetic": Synthetic}


def get_dataset(cfg: Dict[str, Any], args=None, scale: float = 1.0) -> BaseDataset:
    """(ref: datasets.py:47-48)"""
    name = cfg["dataset"]
    if name not in dataset_dict:
        raise NotImplementedError(
            f"dataset {name!r} is not ported yet (ROADMAP.md, 'Modules to "
            "port': file-backed dataset loaders); the port runs 'synthetic'"
        )
    return dataset_dict[name](cfg, args, scale)
