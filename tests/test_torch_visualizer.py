"""The port's Visualizer against the JAX package's, on the CPU.

  - the (idx, it) gate and the pose it renders at (a c2w or a camera
    tensor) equal the JAX Visualizer's;
  - ``panel_arrays`` equals the JAX panel expressions (visualizer.py:56-76);
  - the PNG decodes (zlib, by hand) to the composed image;
  - the mapper and the tracker call their visualizer at the same (idx, it)
    as the JAX mapper and tracker (whose step functions are stubbed here:
    the call pattern is host control flow);
  - a mapped and a tracked frame with panels on are bit-identical to ones
    without.
"""

from __future__ import annotations

import os
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attentive_dfprior_tpu.slam import mapper as j_mapper
from attentive_dfprior_tpu.slam import tracker as j_tracker
from attentive_dfprior_tpu.utils.visualizer import Visualizer as JVisualizer
from attentive_dfprior_tpu_torch.models.scene import params_from_numpy
from attentive_dfprior_tpu_torch.ops.pose import pose_tensor_from_matrix
from attentive_dfprior_tpu_torch.render.renderer import Renderer
from attentive_dfprior_tpu_torch.slam.mapper import Mapper
from attentive_dfprior_tpu_torch.slam.tracker import Tracker
from attentive_dfprior_tpu_torch.utils.tree import tree_leaves
from attentive_dfprior_tpu_torch.utils.visualizer import Visualizer, compose_panels, panel_arrays, write_png
from test_torch_slam import setup  # noqa: F401 (a fixture)


class StubRenderer:
    """Returns fixed images and records the pose of every render."""

    def __init__(self, H=6, W=8):
        rng = np.random.default_rng(3)
        self.depth = rng.uniform(0.5, 2.0, (H, W)).astype(np.float32)
        self.color = rng.uniform(-0.1, 1.1, (H, W, 3)).astype(np.float32)
        self.poses = []

    def render_img(self, params, c2w, tsdf_volume, stage="color", gt_depth=None):
        self.poses.append(np.asarray(c2w, dtype=np.float64))
        return self.depth, None, self.color


class Recorder:
    """A visualizer that records every call."""

    def __init__(self, freq, inside_freq):
        self.freq, self.inside_freq, self.calls = freq, inside_freq, []

    def vis(self, idx, it, *args):
        self.calls.append((idx, it))


def test_gate_and_pose_equal_jax(tmp_path):
    jr, pr = StubRenderer(), StubRenderer()
    jv = JVisualizer(3, 4, str(tmp_path / "jax"), jr)
    pv = Visualizer(3, 4, str(tmp_path / "port"), pr)
    gt_d, gt_c = jr.depth + 0.1, np.clip(jr.color, 0, 1)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.1, -0.2, 0.3]
    cam_t = pose_tensor_from_matrix(c2w)
    fired = {"jax": [], "port": []}
    for idx in range(7):
        for it in range(9):
            pose = cam_t if it % 2 else c2w  # a camera tensor or a matrix
            if jv.vis(idx, it, gt_d, gt_c, jnp.asarray(pose), None, None):
                fired["jax"].append((idx, it))
            if pv.vis(idx, it, gt_d, gt_c, torch.tensor(pose), None, None):
                fired["port"].append((idx, it))
    assert fired["port"] == fired["jax"] == [(i, t) for i in (0, 3, 6) for t in (0, 4, 8)]
    np.testing.assert_allclose(np.stack(pr.poses), np.stack(jr.poses), atol=1e-6)
    assert sorted(os.listdir(tmp_path / "port")) == [f"{i:05d}_{t:04d}.png" for i, t in fired["port"]]
    assert pv.seconds > 0


def test_panel_arrays_equal_jax_expressions():
    rng = np.random.default_rng(0)
    depth_np = rng.uniform(0, 3, (12, 16)).astype(np.float32)
    color_np = rng.uniform(-0.2, 1.2, (12, 16, 3)).astype(np.float32)
    gt_depth_np = rng.uniform(0, 3, (12, 16)).astype(np.float32)
    gt_depth_np[rng.uniform(size=(12, 16)) < 0.2] = 0.0
    gt_color_np = rng.uniform(-0.2, 1.2, (12, 16, 3)).astype(np.float32)
    # attentive_dfprior_tpu/utils/visualizer.py:61-76
    depth_res = np.abs(gt_depth_np - depth_np)
    depth_res[gt_depth_np == 0.0] = 0.0
    color_res = np.abs(gt_color_np - color_np)
    color_res[gt_depth_np == 0.0] = 0.0
    max_depth = float(np.max(gt_depth_np)) or 1.0
    expect = [gt_depth_np, depth_np, depth_res, np.clip(gt_color_np, 0, 1), np.clip(color_np, 0, 1),
              np.clip(color_res, 0, 1)]
    panels, vmax = panel_arrays(torch.tensor(depth_np), torch.tensor(color_np), gt_depth_np, gt_color_np)
    assert vmax == max_depth
    assert [t for t, _ in panels] == ["Input Depth", "Generated Depth", "Depth Residual", "Input RGB",
                                      "Generated RGB", "RGB Residual"]
    for (_, a), b in zip(panels, expect):
        np.testing.assert_array_equal(a, b)
    _, vmax0 = panel_arrays(depth_np, color_np, np.zeros_like(gt_depth_np), gt_color_np)
    assert vmax0 == 1.0


def test_png_decodes(tmp_path):
    rng = np.random.default_rng(1)
    d = rng.uniform(0, 2, (5, 7)).astype(np.float32)
    c = rng.uniform(0, 1, (5, 7, 3)).astype(np.float32)
    img = compose_panels(panel_arrays(d, c, d * 1.1, c * 0.9)[0], 2.2)
    assert img.shape == (2 * 5 + 4, 3 * 7 + 8, 3) and img.dtype == np.uint8
    path = str(tmp_path / "p.png")
    write_png(path, img)
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        tag, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n : pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        chunks[tag] = body
        pos += 12 + n
    W, H, depth, ctype = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (H, W, depth, ctype) == (14, 29, 8, 2) and chunks[b"IEND"] == b""
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(H, 1 + 3 * W)
    assert (rows[:, 0] == 0).all()
    np.testing.assert_array_equal(rows[:, 1:].reshape(H, W, 3), img)


@pytest.fixture()
def tiny(setup):  # noqa: F811
    s = setup
    cfg = {k: (dict(v) if isinstance(v, dict) else v) for k, v in s["cfg"].items()}
    _, color, depth, c2w = s["frames"][1]
    return s, cfg, color, depth, c2w


@pytest.mark.parametrize("idx", [3, 4])
def test_mapper_vis_calls_equal_jax(tiny, monkeypatch, idx):
    """10 joint iterations (stages 0-4, 5-6, 7-9), panels every 3rd on
    frames that are multiples of 2: the top of iterations 0, 3, 6, 9."""
    s, cfg, color, depth, c2w = tiny

    def stub_stage(params, adam_state, *args, **kw):
        return params, adam_state, jnp.zeros(len(args[7]))  # args[7]: the chunk's keys

    monkeypatch.setattr(j_mapper, "mapping_stage", stub_stage)
    jm = j_mapper.Mapper(cfg, s["jcam"], s["scfg"], s["jrcfg"], None, s["tsdf_bnds"])
    jrec, prec = Recorder(2, 3), Recorder(2, 3)
    jm.optimize_map(s["params0"], 10, 1.0, idx, jnp.asarray(color[None]), jnp.asarray(depth[None]),
                    c2w[None], jnp.zeros(2, jnp.uint32), cur_depth_np=depth, cur_c2w_np=c2w,
                    visualizer=jrec, cur_color_np=color)
    pm = Mapper(cfg, s["cam"], s["port_scfg"], s["rcfg"], torch.tensor(s["vol"]), s["tsdf_bnds"], torch.device("cpu"))
    pm.optimize_map(params_from_numpy(s["params0"]), 10, 1.0, idx, torch.tensor(color[None]),
                    torch.tensor(depth[None]), c2w[None], generator=torch.Generator().manual_seed(0),
                    cur_depth_np=depth, cur_c2w_np=c2w, visualizer=prec, cur_color_np=color)
    assert prec.calls == jrec.calls == ([(4, g) for g in (0, 3, 6, 9)] if idx == 4 else [])


@pytest.mark.parametrize("idx", [3, 4])
def test_tracker_vis_calls_equal_jax(tiny, monkeypatch, idx):
    s, cfg, color, depth, c2w = tiny
    n = cfg["tracking"]["iters"]

    def stub_track(params, cam_t, *args, **kw):
        return cam_t, jnp.zeros(n), cam_t, jnp.tile(cam_t, (n, 1))

    monkeypatch.setattr(j_tracker, "track_frame", stub_track)
    est = np.stack([c2w] * 5)
    jt = j_tracker.Tracker(cfg, s["jcam"], s["jrcfg"], s["scfg"].bound, None, s["tsdf_bnds"])
    pt = Tracker(cfg, s["cam"], s["rcfg"], s["scfg"].bound, torch.tensor(s["vol"]), s["tsdf_bnds"], torch.device("cpu"))
    jrec, prec = Recorder(2, 3), Recorder(2, 3)
    jt.track(s["params0"], idx, color, depth, c2w, est, jnp.zeros(2, jnp.uint32), visualizer=jrec)
    pt.track(params_from_numpy(s["params0"]), idx, torch.tensor(color), torch.tensor(depth), c2w, est,
             generator=torch.Generator().manual_seed(0), visualizer=prec)
    assert prec.calls == jrec.calls == ([(4, 0), (4, 3)] if idx == 4 else [])


def test_panels_leave_the_run_bit_identical(tiny, tmp_path):
    """A mapped frame (BA off, 10 iterations) and a tracked frame, each
    with a real Visualizer (panels rendered on the CPU) and without: the
    same losses, parameters and pose bit for bit."""
    s, cfg, color, depth, c2w = tiny
    renderer = Renderer(s["rcfg"], s["scfg"].bound, s["tsdf_bnds"], s["cam"], torch.device("cpu"))
    vol = torch.tensor(s["vol"])
    pm = Mapper(cfg, s["cam"], s["port_scfg"], s["rcfg"], vol, s["tsdf_bnds"], torch.device("cpu"))
    pt = Tracker(cfg, s["cam"], s["rcfg"], s["scfg"].bound, vol, s["tsdf_bnds"], torch.device("cpu"))
    est = np.stack([c2w] * 3)
    runs = []
    for vis in (None, Visualizer(2, 3, str(tmp_path / "map"), renderer)):
        params = params_from_numpy(s["params0"])
        gen = torch.Generator().manual_seed(4)
        _, _, _, losses = pm.optimize_map(
            params, 10, 1.0, 2, torch.tensor(color[None]), torch.tensor(depth[None]), c2w[None],
            generator=gen, cur_depth_np=depth, cur_c2w_np=c2w, visualizer=vis, cur_color_np=color,
        )
        tvis = None if vis is None else Visualizer(2, 1, str(tmp_path / "track"), renderer)
        pose, loss = pt.track(params, 2, torch.tensor(color), torch.tensor(depth), c2w, est,
                              generator=gen, visualizer=tvis)
        runs.append((losses, [t.detach().clone() for t in tree_leaves(params)], pose, loss))
    (la, pa, ca, ta), (lb, pb, cb, tb) = runs
    for k in la:
        assert torch.equal(la[k], lb[k]), k
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))
    np.testing.assert_array_equal(ca, cb)
    assert ta == tb
    assert len(os.listdir(tmp_path / "map")) == 4  # iterations 0, 3, 6, 9
    assert len(os.listdir(tmp_path / "track")) == cfg["tracking"]["iters"]
