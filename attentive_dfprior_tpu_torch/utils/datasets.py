"""RGB-D dataset loaders (host-side input pipeline, numpy only).

The port's counterpart of the JAX package's ``utils/datasets.py``: the five
file-backed loaders of the reference (Replica, ScanNet, CoFusion, Azure,
TUM-RGBD, ref: src/utils/datasets.py:47-330) and the procedural
``Synthetic`` scene. The file-backed loaders read images with OpenCV,
imported when a frame is read (as the JAX package does), so importing this
module needs no ``cv2``; CoFusion's ``.exr`` depth needs OpenEXR.

Frames are numpy arrays ``(idx, color (H,W,3) f32 in [0,1], depth (H,W)
f32, c2w (4,4) f32 OpenGL)``; moving them to the device is the caller's job.
Conventions, as in the JAX package:
  - color: BGR file -> RGB float in [0, 1]
  - depth: uint16 png / png_depth_scale (or EXR), scaled by cfg scale
  - poses: stored OpenCV convention on disk; the y/z columns are negated to
    OpenGL (-z forward) on load (ref: datasets.py:134-135 etc.)

A synthetic frame is rendered once per process (``FRAME_CACHE``): the prior
builder, ``SLAMSystem`` and loop closure's final refine each read every
frame, and one numpy render of a 240x320 frame takes seconds on the host.
``prefetch`` renders the frames a reader is about to read in one thread per
CPU: numpy releases the interpreter lock in its array loops (16 frames of
240x320 took 38.5 s in turn and 5.0 s on 8 threads on an 8-core host).
A file-backed dataset reads each frame on demand; its ``prefetch`` does
nothing.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterable, List, Tuple

import numpy as np

from attentive_dfprior_tpu_torch.camera import as_intrinsics_matrix


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

    def __getitem__(self, index: int):
        import cv2

        color_path = self.color_paths[index]
        depth_path = self.depth_paths[index]
        color_data = cv2.imread(color_path)
        if depth_path.endswith(".png"):
            depth_data = cv2.imread(depth_path, cv2.IMREAD_UNCHANGED)
        elif depth_path.endswith(".exr"):
            depth_data = _read_exr_depth(depth_path)
        else:
            raise ValueError(f"unsupported depth format: {depth_path}")
        if self.distortion is not None:
            K = as_intrinsics_matrix([self.fx, self.fy, self.cx, self.cy])
            color_data = cv2.undistort(color_data, K, self.distortion)

        color_data = cv2.cvtColor(color_data, cv2.COLOR_BGR2RGB) / 255.0
        depth_data = depth_data.astype(np.float32) / self.png_depth_scale
        H, W = depth_data.shape
        color_data = cv2.resize(color_data, (W, H))
        depth_data = depth_data * self.scale
        if self.crop_size is not None:
            # the reference's torch resizes (ref: datasets.py:96-103): color
            # F.interpolate(align_corners=True), depth 'nearest'; cv2.resize
            # maps pixels otherwise (half-pixel centres)
            color_data = _resize_bilinear_align_corners(color_data, self.crop_size)
            depth_data = _resize_nearest_torch(depth_data, self.crop_size)
        edge = self.crop_edge
        if edge > 0:
            color_data = color_data[edge:-edge, edge:-edge]
            depth_data = depth_data[edge:-edge, edge:-edge]
        pose = self.poses[index].copy()
        pose[:3, 3] *= self.scale
        return (
            index,
            color_data.astype(np.float32),
            depth_data.astype(np.float32),
            pose.astype(np.float32),
        )


def _resize_bilinear_align_corners(img: np.ndarray, size) -> np.ndarray:
    """Bilinear resize with torch ``F.interpolate(..., align_corners=True)``
    pixel mapping: output pixel i samples input coordinate
    i * (n_in - 1) / (n_out - 1) (ref: src/utils/datasets.py:96-100).

    Args:
        img: (H, W) or (H, W, C) float array.
        size: (out_H, out_W).
    """
    oh, ow = int(size[0]), int(size[1])
    ih, iw = img.shape[:2]

    def axis_coords(n_in, n_out):
        if n_out == 1:
            return np.zeros(1)
        return np.arange(n_out) * (n_in - 1) / (n_out - 1)

    ys = axis_coords(ih, oh)
    xs = axis_coords(iw, ow)
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, ih - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, iw - 1)
    y1 = np.minimum(y0 + 1, ih - 1)
    x1 = np.minimum(x0 + 1, iw - 1)
    fy = (ys - y0).reshape(-1, 1)
    fx = (xs - x0).reshape(1, -1)
    if img.ndim == 3:
        fy = fy[..., None]
        fx = fx[..., None]
    a = img[np.ix_(y0, x0)]
    b = img[np.ix_(y0, x1)]
    c = img[np.ix_(y1, x0)]
    d = img[np.ix_(y1, x1)]
    top = a * (1 - fx) + b * fx
    bot = c * (1 - fx) + d * fx
    return (top * (1 - fy) + bot * fy).astype(img.dtype, copy=False)


def _resize_nearest_torch(img: np.ndarray, size) -> np.ndarray:
    """Nearest resize with torch ``F.interpolate(mode='nearest')`` pixel
    mapping: output pixel i reads input index floor(i * n_in / n_out)
    (ref: src/utils/datasets.py:101-102)."""
    oh, ow = int(size[0]), int(size[1])
    ih, iw = img.shape[:2]
    yi = np.minimum((np.arange(oh) * ih // oh), ih - 1)
    xi = np.minimum((np.arange(ow) * iw // ow), iw - 1)
    return img[np.ix_(yi, xi)]


def _read_exr_depth(filename: str) -> np.ndarray:
    """EXR depth reader (CoFusion); needs OpenEXR (ref: datasets.py:12-44)."""
    try:
        import Imath
        import OpenEXR as exr
    except ImportError as e:
        raise ImportError("OpenEXR is required for .exr depth (CoFusion dataset)") from e
    exrfile = exr.InputFile(filename)
    header = exrfile.header()
    dw = header["dataWindow"]
    isize = (dw.max.y - dw.min.y + 1, dw.max.x - dw.min.x + 1)
    C = exrfile.channel("Y", Imath.PixelType(Imath.PixelType.FLOAT))
    return np.frombuffer(C, dtype=np.float32).reshape(isize)


def _opengl_flip(c2w: np.ndarray) -> np.ndarray:
    c2w = c2w.copy()
    c2w[:3, 1] *= -1
    c2w[:3, 2] *= -1
    return c2w


class Replica(BaseDataset):
    """``results/frame*.jpg``, ``results/depth*.png`` and one c2w per line
    of ``traj.txt`` (ref: datasets.py:116-137)."""

    def __init__(self, cfg, args=None, scale=1.0):
        super().__init__(cfg, args, scale)
        self.color_paths = sorted(glob.glob(f"{self.input_folder}/results/frame*.jpg"))
        self.depth_paths = sorted(glob.glob(f"{self.input_folder}/results/depth*.png"))
        self.n_img = len(self.color_paths)
        self._load_poses(f"{self.input_folder}/traj.txt")

    def _load_poses(self, path):
        with open(path) as f:
            lines = f.readlines()
        for i in range(self.n_img):
            c2w = np.array(list(map(float, lines[i].split()))).reshape(4, 4)
            self.poses.append(_opengl_flip(c2w).astype(np.float32))


def _by_number(path: str) -> int:
    return int(os.path.basename(path)[:-4])


class ScanNet(BaseDataset):
    """``frames/{color/N.jpg, depth/N.png, pose/N.txt}`` in numeric order
    (ref: datasets.py:181-208)."""

    def __init__(self, cfg, args=None, scale=1.0):
        super().__init__(cfg, args, scale)
        self.input_folder = os.path.join(self.input_folder, "frames")
        self.color_paths = sorted(glob.glob(os.path.join(self.input_folder, "color", "*.jpg")), key=_by_number)
        self.depth_paths = sorted(glob.glob(os.path.join(self.input_folder, "depth", "*.png")), key=_by_number)
        self._load_poses(os.path.join(self.input_folder, "pose"))
        self.n_img = len(self.color_paths)

    def _load_poses(self, path):
        for pose_path in sorted(glob.glob(os.path.join(path, "*.txt")), key=_by_number):
            with open(pose_path) as f:
                c2w = np.array([list(map(float, line.split())) for line in f.readlines()]).reshape(4, 4)
            self.poses.append(_opengl_flip(c2w).astype(np.float32))


class Azure(BaseDataset):
    """``color/*.jpg``, ``depth/*.png`` and 5-line blocks of
    ``scene/trajectory.log``; identity poses without the log
    (ref: datasets.py:140-178)."""

    def __init__(self, cfg, args=None, scale=1.0):
        super().__init__(cfg, args, scale)
        self.color_paths = sorted(glob.glob(os.path.join(self.input_folder, "color", "*.jpg")))
        self.depth_paths = sorted(glob.glob(os.path.join(self.input_folder, "depth", "*.png")))
        self.n_img = len(self.color_paths)
        self._load_poses(os.path.join(self.input_folder, "scene", "trajectory.log"))

    def _load_poses(self, path):
        if not os.path.exists(path):
            self.poses = [np.eye(4, dtype=np.float32) for _ in range(self.n_img)]
            return
        with open(path) as f:
            content = f.readlines()
        for i in range(0, len(content), 5):
            c2w = np.array(list(map(float, "".join(content[i + 1 : i + 5]).strip().split()))).reshape(4, 4)
            self.poses.append(_opengl_flip(c2w).astype(np.float32))


class CoFusion(BaseDataset):
    """``colour/*.png`` and ``depth_noise/*.exr`` with identity poses: the
    dataset's frames cannot be aligned, so only ATE after alignment means
    anything (ref: datasets.py:211-231)."""

    def __init__(self, cfg, args=None, scale=1.0):
        super().__init__(cfg, args, scale)
        self.color_paths = sorted(glob.glob(os.path.join(self.input_folder, "colour", "*.png")))
        self.depth_paths = sorted(glob.glob(os.path.join(self.input_folder, "depth_noise", "*.exr")))
        self.n_img = len(self.color_paths)
        self.poses = [np.eye(4, dtype=np.float32) for _ in range(self.n_img)]


class TUM_RGBD(BaseDataset):
    """Timestamp-associated TUM sequences at 32 frames per second at most,
    poses relative to the first (ref: datasets.py:234-321)."""

    def __init__(self, cfg, args=None, scale=1.0):
        super().__init__(cfg, args, scale)
        self.color_paths, self.depth_paths, self.poses = self._loadtum(self.input_folder, frame_rate=32)
        self.n_img = len(self.color_paths)

    @staticmethod
    def _parse_list(filepath, skiprows=0):
        return np.loadtxt(filepath, delimiter=" ", dtype=np.str_, skiprows=skiprows)

    @staticmethod
    def _associate_frames(t_img, t_depth, t_pose, max_dt=0.08):
        associations = []
        for i, t in enumerate(t_img):
            j = np.argmin(np.abs(t_depth - t))
            k = np.argmin(np.abs(t_pose - t))
            if abs(t_depth[j] - t) < max_dt and abs(t_pose[k] - t) < max_dt:
                associations.append((i, j, k))
        return associations

    def _loadtum(self, datapath, frame_rate=-1):
        if os.path.isfile(os.path.join(datapath, "groundtruth.txt")):
            pose_list = os.path.join(datapath, "groundtruth.txt")
        else:
            pose_list = os.path.join(datapath, "pose.txt")
        image_data = self._parse_list(os.path.join(datapath, "rgb.txt"))
        depth_data = self._parse_list(os.path.join(datapath, "depth.txt"))
        pose_data = self._parse_list(pose_list, skiprows=1)
        pose_vecs = pose_data[:, 1:].astype(np.float64)

        t_img = image_data[:, 0].astype(np.float64)
        t_depth = depth_data[:, 0].astype(np.float64)
        t_pose = pose_data[:, 0].astype(np.float64)
        associations = self._associate_frames(t_img, t_depth, t_pose)

        indices = [0]
        for i in range(1, len(associations)):
            t0 = t_img[associations[indices[-1]][0]]
            t1 = t_img[associations[i][0]]
            if t1 - t0 > 1.0 / frame_rate:
                indices.append(i)

        images, depths, poses = [], [], []
        inv_pose = None
        for ix in indices:
            i, j, k = associations[ix]
            images.append(os.path.join(datapath, str(image_data[i, 1])))
            depths.append(os.path.join(datapath, str(depth_data[j, 1])))
            c2w = self._pose_from_quat(pose_vecs[k])
            if inv_pose is None:
                inv_pose = np.linalg.inv(c2w)
                c2w = np.eye(4)
            else:
                c2w = inv_pose @ c2w
            poses.append(_opengl_flip(c2w).astype(np.float32))
        return images, depths, poses

    @staticmethod
    def _pose_from_quat(pvec):
        from scipy.spatial.transform import Rotation

        pose = np.eye(4)
        pose[:3, :3] = Rotation.from_quat(pvec[3:]).as_matrix()
        pose[:3, 3] = pvec[:3]
        return pose


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

dataset_dict = {
    "replica": Replica,
    "scannet": ScanNet,
    "cofusion": CoFusion,
    "azure": Azure,
    "tumrgbd": TUM_RGBD,
    "synthetic": Synthetic,
}


def get_dataset(cfg: Dict[str, Any], args=None, scale: float = 1.0) -> BaseDataset:
    """The dataset named by ``cfg['dataset']`` (ref: datasets.py:47-48); an
    unknown name raises ``KeyError``."""
    return dataset_dict[cfg["dataset"]](cfg, args, scale)
