"""Pretrain the low/high occupancy decoders on procedural scenes.

The port's counterpart of the JAX package's ``tools/pretrain_decoders.py``.
The reference loads ConvONet-pretrained low/high decoders from
``pretrained/low_high.pt`` and freezes them during SLAM
(ref: src/DF_Prior.py:197-218, configs/df_prior.yaml:45 fix_high). That blob
is not shipped; this tool produces an equivalent prior from scratch: the
decoders are trained jointly with per-scene feature grids to regress
occupancy (+-1 inside/outside) of randomized procedural rooms, so they learn
a generic grid-feature -> occupancy mapping that transfers across scenes.

Every scene gets a random world scale and offset, so position alone carries
no information and occupancy must be read from the features; the features
are perturbed by N(0, 0.5^2) noise, the scale of one first-frame Adam step
on the grids in SLAM (see ``pretrain_loss``).

One step: draw a scene, ``batch`` points in it and the two noise tensors on
the device's generator (``draw_step``); the loss of ``pretrain_loss``; its
gradient through ``sample_feature_grid(..., impl="halo")``, so that K1 folds
each grid's gradient on the card (twice a step); the port's per-leaf lazy
``adam_update``. The per-scene grids are one stacked leaf each, of which a
step reads one scene: the leaf counts as touched, and its other scenes move
by their Adam moments, as in the JAX package.

The JAX package runs every step in one jitted ``lax.scan`` (ref:
tools/pretrain_decoders.py:152-155). Here the step is one ``StepGraph``
(``utils/step_graph.py``, ``init_train``): on the card it is
captured once as a CUDA graph and replayed ``steps`` times, its draws from
the registered device generator, the parameters and the Adam state updated
in place, each step's loss written into a preallocated ``(steps,)`` tensor
at a device-side counter; on the CPU (or ``step_mode="eager"``) the same
step runs eagerly.

Output: ``low000…`` / ``high000…`` arrays in jax flatten order, the layout
``models/decoders.py:load_pretrained_npz`` (and the JAX package's) reads.

Usage:
    python -m attentive_dfprior_tpu_torch.tools.pretrain_decoders --out OUT.npz \\
        [--steps 6000] [--scenes 32] [--device cuda|cpu]

``--out`` has no default: the tool never overwrites the shipped prior
unless asked to. Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from attentive_dfprior_tpu_torch.models.decoders import init_mlp_decoder, mlp_decoder_forward
from attentive_dfprior_tpu_torch.ops.adam import AdamState, adam_init, adam_update
from attentive_dfprior_tpu_torch.ops.grid_sample import sample_feature_grid
from attentive_dfprior_tpu_torch.utils.device import resolve_device
from attentive_dfprior_tpu_torch.utils.step_graph import StepGraphs
from attentive_dfprior_tpu_torch.utils.tree import tree_leaves, tree_map

N_OBJ = 8
FEATURE_NOISE = 0.5
TARGET_SHARPNESS = 20.0


def _uniform(g: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    return torch.rand(shape, generator=g, device=g.device) * (hi - lo) + lo


def sample_scene_geometry(generator: torch.Generator, scenes: int) -> Dict[str, torch.Tensor]:
    """Random boxes+spheres per scene, in unit-room coordinates, plus a
    random world transform (scale in [1, 4], offset in [-3, 3]) per scene,
    on the generator's device."""
    g = generator
    return {
        "centers": _uniform(g, (scenes, N_OBJ, 3), -0.6, 0.6),
        "radii": _uniform(g, (scenes, N_OBJ), 0.1, 0.3),
        "halves": _uniform(g, (scenes, N_OBJ, 3), 0.08, 0.3),
        "is_box": torch.rand((scenes, N_OBJ), generator=g, device=g.device) < 0.5,
        "scale": _uniform(g, (scenes,), 1.0, 4.0),
        "offset": _uniform(g, (scenes, 3), -3.0, 3.0),
    }


def scene_sdf_unit(geom_s: Dict[str, torch.Tensor], p_unit: torch.Tensor) -> torch.Tensor:
    """SDF of one scene at unit-room points. geom_s: per-scene slices."""
    room = 1.0 - p_unit.abs().amax(dim=-1)  # (N,)
    diff = p_unit[:, None, :] - geom_s["centers"][None]  # (N, O, 3)
    sph = torch.linalg.norm(diff, dim=-1) - geom_s["radii"][None]  # (N, O)
    q = diff.abs() - geom_s["halves"][None]
    box = torch.linalg.norm(q.clamp_min(0.0), dim=-1) + q.amax(dim=-1).clamp_max(0.0)
    obj = torch.where(geom_s["is_box"][None], box, sph)  # (N, O)
    return torch.minimum(room, obj.amin(dim=-1))


def _scene(stacked: torch.Tensor, sidx: torch.Tensor) -> torch.Tensor:
    """Scene ``sidx`` (a one-element index tensor) of a stacked leaf; an
    index_select, so that picking the scene waits for nothing on the host."""
    return stacked.index_select(0, sidx)[0]


def scene_batch(geom: Dict[str, torch.Tensor], sidx: torch.Tensor, p_unit: torch.Tensor):
    """(world points, bound (3, 2), occupancy targets) of scene ``sidx`` at
    unit-room points ``p_unit``: the scene's bound is offset +- scale, and
    the target is a smooth +-1 occupancy (inside positive) measured in
    unit-room coordinates, so its sharpness does not depend on the scene's
    size."""
    geom_s = {k: _scene(v, sidx) for k, v in geom.items()}
    scale, offset = geom_s["scale"], geom_s["offset"]
    bound = torch.stack([offset - scale, offset + scale], dim=-1)
    targets = torch.tanh(-scene_sdf_unit(geom_s, p_unit) * TARGET_SHARPNESS)
    return p_unit * scale + offset, bound, targets


def pretrain_loss(
    params: Dict[str, Any],
    pts: torch.Tensor,
    targets: torch.Tensor,
    bound: torch.Tensor,
    sidx: torch.Tensor,
    noise_low: torch.Tensor,
    noise_high: torch.Tensor,
) -> torch.Tensor:
    """One step's loss, every draw injected: ``noise_low`` (N, c_dim) and
    ``noise_high`` (N, 2 c_dim) are standard normal.

    The frozen decoders must answer smoothly to feature steps of the size
    SLAM's first mapped frame takes (Adam on the grids at lr up to 0.5:
    low_lr 0.1 x lr_first_factor 5, configs/df_prior.yaml), or the first
    step drives occupancy past sigmoid(10x) float32 saturation and every ray
    stops at its first sample; training under feature noise of that scale
    bounds the decoders' feature Jacobian. The low decoder models coarse
    occupancy and the high one the residual on top (the DF composition
    low_occ + high_occ, ref decoder.py:326)."""
    c_low = sample_feature_grid(_scene(params["grids_low"], sidx), pts, bound, "halo")
    c_high = torch.cat([sample_feature_grid(_scene(params["grids_high"], sidx), pts, bound, "halo"),
                        c_low.detach()], dim=-1)
    low_occ = mlp_decoder_forward(params["low"], pts, c_low + FEATURE_NOISE * noise_low)
    high_occ = mlp_decoder_forward(params["high"], pts, c_high + FEATURE_NOISE * noise_high)
    l_low = (low_occ - targets).abs().mean()
    l_sum = ((low_occ + high_occ) - targets).abs().mean()
    return l_low + l_sum


def pretrain_step(params, state: AdamState, lr_tree, pts, targets, bound, sidx, noise_low, noise_high) -> torch.Tensor:
    """``pretrain_loss``, its gradient, and one Adam step in place on
    ``params`` and ``state``; returns the loss (before the step)."""
    loss = pretrain_loss(params, pts, targets, bound, sidx, noise_low, noise_high)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    adam_update(params, list(grads), state, lr_tree)
    return loss.detach()


def draw_step(geom, generator: torch.Generator, batch: int, c_dim: int):
    """One step's draws, in ``pretrain_loss``'s order: (world points,
    targets, bound, sidx, noise_low, noise_high), all on the generator's
    device."""
    g = generator
    scenes = geom["scale"].shape[0]
    sidx = torch.randint(0, scenes, (1,), generator=g, device=g.device)
    p_unit = _uniform(g, (batch, 3), -1.0, 1.0)
    pts, bound, targets = scene_batch(geom, sidx, p_unit)
    noise_low = torch.randn((batch, c_dim), generator=g, device=g.device)
    noise_high = torch.randn((batch, 2 * c_dim), generator=g, device=g.device)
    return pts, targets, bound, sidx, noise_low, noise_high


def init_pretrain_params(generator: torch.Generator, scenes: int, grid_res: int, c_dim: int) -> Dict[str, Any]:
    """Decoders (low: c_dim, high: its own and the low feature) and the
    per-scene grids, low at half the resolution, all on the CPU."""
    gl = grid_res // 2
    return {
        "low": init_mlp_decoder(generator, c_dim=c_dim),
        "high": init_mlp_decoder(generator, c_dim=2 * c_dim),
        "grids_low": torch.randn((scenes, gl, gl, gl, c_dim), generator=generator) * 0.01,
        "grids_high": torch.randn((scenes, grid_res, grid_res, grid_res, c_dim), generator=generator) * 0.01,
    }


def init_train(steps: int, scenes: int = 32, grid_res: int = 24, c_dim: int = 32, batch: int = 8192,
               lr: float = 1e-3, seed: int = 0, device=None, step_mode: Optional[str] = None):
    """The seed's parameters and scenes and their step program for
    ``steps`` steps, none run yet: one ``StepGraph`` (``step_mode``, by
    default graphs on the card, ``utils/step_graph.py:resolve_step_mode``)
    whose step draws from the device generator (``draw_step``), takes
    ``pretrain_step`` in place on the parameters and the Adam state, and
    writes the loss into a preallocated ``(steps,)`` tensor at a
    device-side step counter, so that every call, eager or a replay, writes
    the next entry. Returns (params, the losses, the ``StepGraphs``, the
    ``StepGraph`` a call of which runs one step)."""
    dev = resolve_device(device)
    host = torch.Generator().manual_seed(seed)
    params = tree_map(lambda t: t.to(dev).requires_grad_(True),
                      init_pretrain_params(host, scenes, grid_res, c_dim))
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    geom = sample_scene_geometry(gen, scenes)
    state, lr_tree = adam_init(params), tree_map(lambda _: lr, params)
    graphs = StepGraphs(step_mode, dev)
    losses = torch.zeros((steps,), dtype=torch.float32, device=dev)
    it = torch.zeros((1,), dtype=torch.int64, device=dev)

    def step() -> None:
        loss = pretrain_step(params, state, lr_tree, *draw_step(geom, gen, batch, c_dim))
        losses.index_copy_(0, it, loss.reshape(1))
        it.add_(1)

    return params, losses, graphs, graphs.step_graph(step, (gen,), tree_leaves(params))


def train(steps: int, scenes: int = 32, grid_res: int = 24, c_dim: int = 32, batch: int = 8192, lr: float = 1e-3,
          seed: int = 0, device=None, step_mode: Optional[str] = None):
    """``steps`` pretrain steps of ``init_train``'s program. Returns
    (params, the (steps,) losses on the device, the ``StepGraphs``)."""
    params, losses, graphs, step = init_train(steps, scenes, grid_res, c_dim, batch, lr, seed, device, step_mode)
    for _ in range(steps):
        step()
    return params, losses, graphs


def save_decoders(params: Dict[str, Any], out_path: str) -> str:
    """Write the low/high decoders as ``low000…`` / ``high000…`` arrays."""
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    payload = {}
    for name in ("low", "high"):
        payload.update({f"{name}{i:03d}": t.detach().cpu().numpy() for i, t in enumerate(tree_leaves(params[name]))})
    np.savez_compressed(out_path, **payload)
    return out_path


def pretrain(
    out_path: str,
    steps: int = 6000,
    scenes: int = 32,
    grid_res: int = 24,
    c_dim: int = 32,
    batch: int = 8192,
    lr: float = 1e-3,
    seed: int = 0,
    verbose: bool = True,
    device=None,
    step_mode: Optional[str] = None,
) -> Tuple[str, np.ndarray]:
    """Train (``train``) and write the decoders to ``out_path``; returns
    (the path, the loss of every step)."""
    t0 = time.perf_counter()
    params, losses, graphs = train(steps, scenes, grid_res, c_dim, batch, lr, seed, device, step_mode)
    out = losses.cpu().numpy()  # the one wait for the device
    if verbose:
        for it in range(0, steps, max(1, steps // 10)):
            print(f"step {it}: loss {out[it]:.4f}")
        print(f"final loss {out[-1]:.4f} ({time.perf_counter() - t0:.1f} s for {steps} steps on {graphs.device}, "
              f"{graphs.mode} steps)")
    save_decoders(params, out_path)
    if verbose:
        print(f"saved pretrained decoders to {out_path}")
    return out_path, out


def main(argv: Optional[List[str]] = None) -> Tuple[str, np.ndarray]:
    ap = argparse.ArgumentParser(description="Pretrain the low/high decoders on procedural scenes (PyTorch/CUDA port).")
    ap.add_argument("--out", required=True, help="output .npz (pretrained/low_high.npz is the shipped prior)")
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--scenes", type=int, default=32)
    ap.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    return pretrain(args.out, steps=args.steps, scenes=args.scenes, device=args.device)


if __name__ == "__main__":
    main()
