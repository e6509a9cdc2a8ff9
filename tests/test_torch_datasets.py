"""The port's file-backed dataset loaders against the JAX package's.

Fixture files are written in ``tmp_path`` in each dataset's on-disk layout
(as tests/test_datasets.py writes them), from numpy draws of a fixed seed:
random colour and depth images, random rigid poses. Both packages read the
same files with OpenCV, so colour, depth and pose must be equal
(``np.array_equal``) at every index:

  - Replica, with ``scale`` and ``crop_edge``;
  - ScanNet plain, with ``crop_edge``, ``crop_size`` and ``distortion``,
    and all three at once;
  - Azure with and without ``scene/trajectory.log``;
  - CoFusion, with ``_read_exr_depth`` replaced by a raw-float reader on
    both sides (OpenEXR is not installed);
  - TUM-RGBD: timestamp association, the 32 fps thinning, poses relative
    to the first;
  - the two resize helpers;
  - ``get_dataset``: the same six names, ``KeyError`` for another;
  - the TSDF builder's CLI (``--input_folder``) on a Replica fixture moved
    away from the config's ``data.input_folder``: the volume equals the JAX
    ``build_tsdf_volume``'s on the same folder at the fusion test's
    tolerance (tests/test_torch_ops.py: at most 0.5 % of voxels apart).
"""

from __future__ import annotations

import argparse
import os

import cv2
import numpy as np
import pytest
from scipy.spatial.transform import Rotation

import attentive_dfprior_tpu.utils.datasets as JD
import attentive_dfprior_tpu_torch.utils.datasets as TD

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 12, 16


def base_cfg(input_folder, dataset, depth_scale=1000.0, crop_edge=0):
    return {
        "dataset": dataset,
        "cam": {"H": H, "W": W, "fx": 14.0, "fy": 13.0, "cx": 7.5, "cy": 5.5,
                "png_depth_scale": depth_scale, "crop_edge": crop_edge},
        "data": {"input_folder": str(input_folder)},
    }


def random_pose(rng) -> np.ndarray:
    c2w = np.eye(4)
    c2w[:3, :3] = Rotation.from_rotvec(rng.normal(0, 0.8, 3)).as_matrix()
    c2w[:3, 3] = rng.uniform(-2, 2, 3)
    return c2w


def pose_text(c2w: np.ndarray, rows: bool = False) -> str:
    if rows:
        return "".join(" ".join(f"{v:.17g}" for v in r) + "\n" for r in c2w)
    return " ".join(f"{v:.17g}" for v in c2w.reshape(-1)) + "\n"


def write_images(color_path, depth_path, rng, depth_scale=1000.0):
    cv2.imwrite(str(color_path), rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
    if depth_path is not None:
        depth = np.round(rng.uniform(0.3, 4.0, (H, W)) * depth_scale).astype(np.uint16)
        depth[0, :3] = 0  # holes
        cv2.imwrite(str(depth_path), depth)


def assert_same_frames(port, ref):
    assert type(port).__name__ == type(ref).__name__
    assert len(port) == len(ref) > 0
    for i in range(len(ref)):
        got, want = port[i], ref[i]
        assert got[0] == want[0] == i
        for g, w in zip(got[1:], want[1:]):
            assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
            assert np.array_equal(g, w)


def both(cfg, args=None, scale=1.0):
    return TD.get_dataset(cfg, args, scale), JD.get_dataset(cfg, args, scale)


def write_replica(folder, n, rng, depth_scale=6553.5):
    res = folder / "results"
    res.mkdir(parents=True)
    with open(folder / "traj.txt", "w") as f:
        for i in range(n):
            write_images(res / f"frame{i:06d}.jpg", res / f"depth{i:06d}.png", rng, depth_scale)
            f.write(pose_text(random_pose(rng)))


@pytest.mark.parametrize("scale,crop_edge", [(1.0, 0), (2.5, 0), (1.0, 2)])
def test_replica_matches_jax(tmp_path, scale, crop_edge):
    write_replica(tmp_path, 3, np.random.default_rng(0))
    port, ref = both(base_cfg(tmp_path, "replica", 6553.5, crop_edge), scale=scale)
    assert_same_frames(port, ref)
    assert port[0][1].shape == (H - 2 * crop_edge, W - 2 * crop_edge, 3)


SCANNET_CAM = {
    "plain": {},
    "crop_edge": {"crop_edge": 2},
    "crop_size": {"crop_size": [9, 13]},
    "distortion": {"distortion": [0.05, -0.02, 0.001, 0.002, 0.0]},
    "all": {"crop_edge": 1, "crop_size": [10, 14], "distortion": [-0.03, 0.01, 0.0, 0.0, 0.0]},
}


@pytest.mark.parametrize("variant", sorted(SCANNET_CAM))
def test_scannet_matches_jax(tmp_path, variant):
    rng = np.random.default_rng(1)
    frames = tmp_path / "frames"
    for sub in ("color", "depth", "pose"):
        (frames / sub).mkdir(parents=True)
    for i in (0, 1, 2, 10):  # numeric, not lexical, order: 10 comes last
        write_images(frames / "color" / f"{i}.jpg", frames / "depth" / f"{i}.png", rng)
        (frames / "pose" / f"{i}.txt").write_text(pose_text(random_pose(rng), rows=True))
    cfg = base_cfg(tmp_path, "scannet")
    cfg["cam"].update(SCANNET_CAM[variant])
    port, ref = both(cfg)
    assert port.color_paths[-1].endswith("10.jpg")
    assert_same_frames(port, ref)


@pytest.mark.parametrize("with_log", [True, False])
def test_azure_matches_jax(tmp_path, with_log):
    rng = np.random.default_rng(2)
    (tmp_path / "color").mkdir()
    (tmp_path / "depth").mkdir()
    lines = []
    for i in range(3):
        write_images(tmp_path / "color" / f"{i:05d}.jpg", tmp_path / "depth" / f"{i:05d}.png", rng)
        lines.append(f"{i} {i} {i + 1}\n" + pose_text(random_pose(rng), rows=True))
    if with_log:
        (tmp_path / "scene").mkdir()
        (tmp_path / "scene" / "trajectory.log").write_text("".join(lines))
    port, ref = both(base_cfg(tmp_path, "azure"))
    assert_same_frames(port, ref)
    assert np.array_equal(port.poses[0], np.eye(4, dtype=np.float32)) != with_log


def test_cofusion_matches_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(3)
    (tmp_path / "colour").mkdir()
    (tmp_path / "depth_noise").mkdir()
    for i in range(2):
        write_images(tmp_path / "colour" / f"Color{i:04d}.png", None, rng)
        depth = rng.uniform(0.5, 3.0, (H, W)).astype(np.float32)
        (tmp_path / "depth_noise" / f"Depth{i:04d}.exr").write_bytes(depth.tobytes())

    def raw_exr(path):
        with open(path, "rb") as f:
            return np.frombuffer(f.read(), np.float32).reshape(H, W)

    monkeypatch.setattr(JD, "_read_exr_depth", raw_exr)
    monkeypatch.setattr(TD, "_read_exr_depth", raw_exr)
    port, ref = both(base_cfg(tmp_path, "cofusion", depth_scale=1.0))
    assert_same_frames(port, ref)


def test_exr_reader_names_openexr(tmp_path):
    with pytest.raises(ImportError, match="OpenEXR"):
        TD._read_exr_depth(str(tmp_path / "missing.exr"))


def test_tum_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    (tmp_path / "rgb").mkdir()
    (tmp_path / "depth").mkdir()
    # 0.01 s apart is under 1/32 s: the second stamp is thinned away; the
    # last has no depth within 0.08 s and is not associated
    stamps = [0.0, 0.01, 0.5, 1.0, 1.6, 2.0]
    with open(tmp_path / "rgb.txt", "w") as frgb, open(tmp_path / "depth.txt", "w") as fd:
        for t in stamps:
            write_images(tmp_path / "rgb" / f"{t:.2f}.png", tmp_path / "depth" / f"{t:.2f}.png", rng, 5000.0)
            frgb.write(f"{t} rgb/{t:.2f}.png\n")
            fd.write(f"{t + (0.3 if t == 2.0 else 0.01)} depth/{t:.2f}.png\n")
    with open(tmp_path / "groundtruth.txt", "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for t in stamps:
            q = Rotation.from_rotvec(rng.normal(0, 0.5, 3)).as_quat()
            tx = rng.uniform(-1, 1, 3)
            f.write(f"{t + 0.005} " + " ".join(f"{v:.17g}" for v in [*tx, *q]) + "\n")
    port, ref = both(base_cfg(tmp_path, "tumrgbd", depth_scale=5000.0))
    assert len(port) == 4
    assert port.color_paths == ref.color_paths and port.depth_paths == ref.depth_paths
    assert_same_frames(port, ref)
    np.testing.assert_allclose(port.poses[0], np.diag([1.0, -1.0, -1.0, 1.0]), atol=1e-6)


@pytest.mark.parametrize("shape,out", [((8, 10), (5, 7)), ((7, 9), (12, 14)), ((6, 6, 3), (9, 4))])
def test_resize_helpers_match_jax(shape, out):
    img = np.random.default_rng(5).uniform(0, 4, shape).astype(np.float32)
    assert np.array_equal(TD._resize_bilinear_align_corners(img, out), JD._resize_bilinear_align_corners(img, out))
    assert np.array_equal(TD._resize_nearest_torch(img, out), JD._resize_nearest_torch(img, out))


def test_get_dataset_names_and_unknown(tmp_path):
    assert sorted(TD.dataset_dict) == sorted(JD.dataset_dict)
    with pytest.raises(KeyError):
        TD.get_dataset(base_cfg(tmp_path, "kitti"))


def test_file_backed_prefetch_reads_nothing(tmp_path):
    write_replica(tmp_path, 2, np.random.default_rng(6))
    ds = TD.get_dataset(base_cfg(tmp_path, "replica", 6553.5))
    ds.prefetch(range(2))  # no error, no cache
    assert_same_frames(ds, JD.get_dataset(base_cfg(tmp_path, "replica", 6553.5)))


def _synthetic_replica_fixture(folder, cfg, n):
    """A Replica-layout fixture rendered from the synthetic scene at ``cfg``'s
    camera: JPEG colour, uint16 depth x png_depth_scale, OpenCV poses."""
    from attentive_dfprior_tpu_torch.utils.synthetic import SyntheticScene

    scene = SyntheticScene.from_config(cfg)
    res = folder / "results"
    res.mkdir(parents=True)
    scale = cfg["cam"]["png_depth_scale"]
    with open(folder / "traj.txt", "w") as f:
        for i in range(n):
            c2w = scene.pose_at(i / (n - 1)).astype(np.float64)
            color, depth = scene.render(c2w)
            cv2.imwrite(str(res / f"frame{i:06d}.jpg"), cv2.cvtColor(np.round(color * 255).astype(np.uint8),
                                                                    cv2.COLOR_RGB2BGR))
            cv2.imwrite(str(res / f"depth{i:06d}.png"), np.round(depth * scale).astype(np.uint16))
            f.write(pose_text(TD._opengl_flip(c2w)))


def test_builder_cli_input_folder_matches_jax(tmp_path):
    from attentive_dfprior_tpu.config import load_config as j_load_config
    from attentive_dfprior_tpu.tsdf.builder import build_tsdf_volume as j_build
    from attentive_dfprior_tpu_torch.config import default_config_path, load_config
    from attentive_dfprior_tpu_torch.tsdf import builder

    cfg_path = tmp_path / "tiny_room0.yaml"
    cfg_path.write_text(
        f"inherit_from: {REPO}/configs/Replica/room0.yaml\n"
        "cam: {H: 24, W: 40, fx: 20.0, fy: 20.0, cx: 19.5, cy: 11.5}\n"
        "mapping:\n  bound: [[-2.2, 2.2], [-1.7, 1.7], [-2.2, 2.2]]\n"
        "tsdf: {voxel_size: 0.125}\n"
        f"data: {{input_folder: {tmp_path / 'not_here'}}}\n"
    )
    cfg = load_config(str(cfg_path), default_config_path())
    assert cfg["dataset"] == "replica" and cfg["tsdf"]["space"] == 1
    fixture = tmp_path / "moved" / "room0"
    _synthetic_replica_fixture(fixture, cfg, 3)
    out_dir = tmp_path / "replica_tsdf_volume"
    out = builder.main([str(cfg_path), "--input_folder", str(fixture), "--output", str(out_dir), "--device", "cpu"])
    assert out == str(out_dir / "room0_tsdf_volume.npz")
    data = np.load(out)

    jcfg = j_load_config(str(cfg_path), default_config_path())
    jt, jb, jv = j_build(jcfg, argparse.Namespace(input_folder=str(fixture)), space=1, voxel_size=0.125)
    jt, jw = np.asarray(jt), np.asarray(jv._weight)
    assert data["tsdf"].shape == jt.shape
    np.testing.assert_array_equal(data["bounds"], jb)
    assert (data["observed"] != (jw > 0)).mean() <= 5e-3
    assert (np.abs(data["tsdf"] - jt) > 1e-6).mean() <= 5e-3
    assert (jw > 0).mean() > 0.05  # the frames did touch the volume
    with pytest.raises(FileNotFoundError):  # without the flag the config's folder is read
        builder.main([str(cfg_path), "--output", str(tmp_path / "x"), "--device", "cpu"])
