"""The inputs of a run, made from ``--seed``: the scene's weights, the TSDF
prior, a pool of RGB-D frames and a camera trajectory.

Everything that fills memory is drawn on the run's device from
``torch.Generator``s seeded from the run's seed, in a few large calls: one
normal draw for the three feature grids and the Fourier projections, one
uniform draw for every decoder leaf, one for the prior, one each for the
pool's colours and depths. The trajectory is a few hundred numbers drawn on
the host. Each stream has its own sub-seed, so no input moves when another
is drawn differently.

The sizes come from the configuration file alone (its ``mapping.bound``,
``grid_len``, ``tsdf.voxel_size``, ``model.c_dim`` and ``cam``), worked out
here by the rules the shipped system states (``grid_len.bound_divisible``
round-up, ``int(extent / grid_len)`` cells, ``ceil(extent / voxel)`` prior
voxels, ``cam.crop_edge``); nothing is read from the program.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from benchmark.reference.steps import leaves, rebuild

# sub-seed streams
SCENE, PRIOR, FRAMES, TRAJECTORY, DRAWS, CHECK = range(6)

# decoder layout: the DF-Prior decoders (Fourier embedding of 93, 5 blocks
# of 32 with a skip after the third, attention MLP 2-64-128-128-64-2)
EMBED, HIDDEN, BLOCKS, SKIP = 93, 32, 5, 2
ATTENTION = (2, 64, 128, 128, 64, 2)
FOURIER_SCALE = 25.0
GRID_SIGMA = {"grid_low": 0.01, "grid_high": 1e-4, "grid_color": 0.01}


def sub_seed(seed: int, stream: int) -> int:
    """A seed of its own for each input stream (any whole ``seed``)."""
    return (int(seed) * 0x9E3779B97F4A7C15 + (stream + 1) * 0xBF58476D1CE4E5B9) % (2**63 - 1)


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(sub_seed(seed, stream))


def scene_bound(cfg: Dict[str, Any]) -> np.ndarray:
    """The mapping bound, its upper ends rounded up to ``bound_divisible``
    (the shipped rule), (3, 2) float64."""
    bound = np.array(cfg["mapping"]["bound"], dtype=np.float64) * float(cfg.get("scale", 1))
    bd = float(cfg["grid_len"]["bound_divisible"])
    bound[:, 1] = (((bound[:, 1] - bound[:, 0]) / bd).astype(int) + 1) * bd + bound[:, 0]
    return bound


def grid_dims(cfg: Dict[str, Any], key: str) -> Tuple[int, int, int]:
    """Cells per axis of the feature grid ``key`` ("low", "high", "color")."""
    ext = scene_bound(cfg)[:, 1] - scene_bound(cfg)[:, 0]
    return tuple(int(v) for v in ext / float(cfg["grid_len"][key]))


def prior_dims(cfg: Dict[str, Any]) -> Tuple[int, int, int]:
    """Voxels per axis of the prior over the rounded bound."""
    ext = scene_bound(cfg)[:, 1] - scene_bound(cfg)[:, 0]
    voxel = float(cfg["tsdf"]["voxel_size"])
    return tuple(int(math.ceil(v / voxel)) for v in ext)


def camera(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The effective pinhole camera: ``cam`` with ``crop_edge`` taken off
    every side (no ``crop_size`` in the configurations run here)."""
    c = cfg["cam"]
    if c.get("crop_size") is not None:
        raise ValueError("cam.crop_size is not supported by the benchmark's generator")
    e = int(c.get("crop_edge", 0))
    return dict(H=int(c["H"]) - 2 * e, W=int(c["W"]) - 2 * e, fx=float(c["fx"]), fy=float(c["fy"]),
                cx=float(c["cx"]) - e, cy=float(c["cy"]) - e)


def _decoder_specs(c_dim: int, out: int) -> Dict[str, Any]:
    """Leaf specs of one decoder: (shape, kind, scale); kinds: "normal"
    (N(0, scale^2)), "uniform" (U(-scale, scale)), "zeros"."""

    def dense(fan_in, fan_out, gain):
        return {"w": ((fan_in, fan_out), "uniform", gain * math.sqrt(6.0 / (fan_in + fan_out))),
                "b": ((fan_out,), "zeros", 0.0)}

    def linear(fan_in, fan_out):
        s = 1.0 / math.sqrt(fan_in)
        return {"w": ((fan_in, fan_out), "uniform", s), "b": ((fan_out,), "uniform", s)}

    pts = [dense(EMBED, HIDDEN, math.sqrt(2.0))]
    pts += [dense(HIDDEN + (EMBED if i == SKIP else 0), HIDDEN, math.sqrt(2.0)) for i in range(BLOCKS - 1)]
    return {"B": ((3, EMBED), "normal", FOURIER_SCALE), "pts": pts,
            "fc_c": [linear(c_dim, HIDDEN) for _ in range(BLOCKS)], "out": dense(HIDDEN, out, 1.0)}


def scene_specs(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The scene's tree of leaf specs: the three channels-last grids
    (X, Y, Z, C) and the low / high / colour decoders and the attention
    MLP, in the layout the program takes."""
    C = int(cfg["model"]["c_dim"])
    specs: Dict[str, Any] = {
        f"grid_{k}": (grid_dims(cfg, k) + (C,), "normal", GRID_SIGMA[f"grid_{k}"]) for k in ("low", "high", "color")
    }
    specs["low"] = _decoder_specs(C, 1)
    specs["high"] = _decoder_specs(2 * C, 1)
    specs["color"] = _decoder_specs(C, 4)
    layers = [{"w": ((a, b), "uniform", math.sqrt(2.0) * math.sqrt(6.0 / (a + b))), "b": ((b,), "zeros", 0.0)}
              for a, b in zip(ATTENTION[:-2], ATTENTION[1:-1])]
    a, b = ATTENTION[-2], ATTENTION[-1]
    specs["mlp"] = {"layers": layers, "out": {"w": ((a, b), "uniform", math.sqrt(6.0 / (a + b))),
                                              "b": ((b,), "zeros", 0.0)}}
    return specs


def make_scene(cfg: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """The scene's weights from ``seed``: every grid and Fourier projection
    from one normal draw, every other decoder leaf from one uniform draw,
    float32 on ``device``."""
    specs = scene_specs(cfg)
    flat = [spec for _, spec in leaves(specs)]
    g = generator(seed, SCENE, device)
    counts = {kind: sum(math.prod(s) for s, k, _ in flat if k == kind) for kind in ("normal", "uniform")}
    normal = torch.randn((counts["normal"],), generator=g, device=device)
    uniform = torch.rand((counts["uniform"],), generator=g, device=device) * 2.0 - 1.0
    offs = {"normal": 0, "uniform": 0}
    values = []
    for shape, kind, scale in flat:
        n = math.prod(shape)
        if kind == "zeros":
            values.append(torch.zeros(shape, device=device))
            continue
        src = normal if kind == "normal" else uniform
        values.append((src[offs[kind]: offs[kind] + n] * scale).reshape(shape).contiguous())
        offs[kind] += n
    return rebuild(specs, values)


def make_prior(cfg: Dict[str, Any], seed: int, device) -> Tuple[torch.Tensor, np.ndarray]:
    """The TSDF prior, uniform in [-1, 1) over the rounded bound, and its
    bounds (the rounded bound, float32)."""
    g = generator(seed, PRIOR, device)
    tsdf = torch.rand(prior_dims(cfg), generator=g, device=device)
    tsdf.mul_(2.0).sub_(1.0)
    return tsdf, scene_bound(cfg).astype(np.float32)


def make_frames(cfg: Dict[str, Any], n: int, depth_range: Tuple[float, float], seed: int, device):
    """A pool of ``n`` frames: colour (n, H, W, 3) uniform in [0, 1),
    depth (n, H, W) uniform in ``depth_range`` metres."""
    cam = camera(cfg)
    g = generator(seed, FRAMES, device)
    colors = torch.rand((n, cam["H"], cam["W"], 3), generator=g, device=device)
    depths = torch.rand((n, cam["H"], cam["W"]), generator=g, device=device)
    lo, hi = depth_range
    depths.mul_(hi - lo).add_(lo)
    return colors, depths


def look_at(centre: np.ndarray, direction: np.ndarray) -> np.ndarray:
    """A (4, 4) camera-to-world pose at ``centre`` looking along
    ``direction``, in the OpenGL convention the system uses (-z forward,
    +y up, the world's +z up)."""
    z = -direction / np.linalg.norm(direction)
    x = np.cross(np.array([0.0, 0.0, 1.0]), z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    pose = np.eye(4)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = x, y, z, centre
    return pose


def trajectory(cfg: Dict[str, Any], n: int, spec: Dict[str, Any], seed: int) -> np.ndarray:
    """``n`` camera-to-world poses (n, 4, 4) float32 along a smooth path
    inside the bound: the centre swings on each axis about the bound's
    middle (amplitude ``spec["amplitude"]`` of the extent, periods
    ``spec["periods"]`` frames), the view turns about the vertical at
    ``spec["yaw_period"]`` frames a turn and nods by ``spec["pitch"]``
    radians. The seed sets only the phases, so every seed asks the same
    work."""
    rng = np.random.default_rng(sub_seed(seed, TRAJECTORY))
    phase = rng.uniform(0.0, 2.0 * np.pi, size=5)
    bound = scene_bound(cfg)
    mid, ext = bound.mean(axis=1), bound[:, 1] - bound[:, 0]
    amp = float(spec["amplitude"]) * ext
    px, py, pz = (float(p) for p in spec["periods"])
    t = np.arange(n, dtype=np.float64)[:, None]
    centre = mid + amp * np.sin(2 * np.pi * t / np.array([px, py, pz]) + phase[:3])
    turn = 2 * np.pi * t[:, 0] / float(spec["yaw_period"])
    yaw, pitch = turn + phase[3], float(spec["pitch"]) * np.sin(turn + phase[4])
    d = np.stack([np.cos(yaw) * np.cos(pitch), np.sin(yaw) * np.cos(pitch), np.sin(pitch)], axis=1)
    return np.stack([look_at(centre[i], d[i]) for i in range(n)]).astype(np.float32)
