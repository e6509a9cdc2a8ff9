"""Dry run of the port's ray-axis data parallelism on ``n`` ranks.

    python -m attentive_dfprior_tpu_torch.tools.dryrun_multichip [N]

The counterpart of the JAX package's ``__graft_entry__.py:dryrun_multichip``:
spawns N processes on the CPU, joins them into one gloo process group over
a local port, and on the tiny scene of ``__graft_entry__.py:_tiny_scene`` (bound
[-1, 1]^3, grids 0.32 / 0.16 / 0.16 m, c_dim 32, a two-slab 16^3 prior)
runs the production ``mapping_stage`` (3 colour-stage iterations over a
2-frame window, 8 x N pixels a frame) and ``track_frame`` (8 x N rays, 2
iterations), each rank rendering its block of the ray axis. Fails unless
every loss is finite and every rank ends with the same scene and pose, bit
for bit. Prints one line from rank 0.
"""

from __future__ import annotations

import argparse
import os
import socket

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from attentive_dfprior_tpu_torch.camera import Camera
from attentive_dfprior_tpu_torch.models.scene import SceneConfig, init_scene
from attentive_dfprior_tpu_torch.ops.adam import adam_init
from attentive_dfprior_tpu_torch.parallel.sharding import init_distributed, mesh_from_config, replicate
from attentive_dfprior_tpu_torch.render.renderer import RenderConfig
from attentive_dfprior_tpu_torch.slam.mapper import StageLRs, mapping_stage
from attentive_dfprior_tpu_torch.slam.tracker import track_frame
from attentive_dfprior_tpu_torch.utils.tree import tree_leaves

TINY_CAM = Camera(H=24, W=32, fx=24.0, fy=24.0, cx=15.5, cy=11.5)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def tiny_scene(device: torch.device, seed: int = 0):
    """The tiny scene of ``__graft_entry__.py:_tiny_scene`` in the port:
    (params, tsdf (16, 16, 16), tsdf bounds, bound), on ``device``."""
    bound = np.array([[-1.0, 1.0], [-1.0, 1.0], [-1.0, 1.0]])
    scfg = SceneConfig(bound=bound, c_dim=32, low_grid_len=0.32, high_grid_len=0.16, color_grid_len=0.16,
                       fix_high=False, fix_color=False)
    params = init_scene(torch.Generator().manual_seed(seed), scfg, None, device)
    tsdf = torch.full((16, 16, 16), -0.5, device=device)
    tsdf[:, 8:, :] = 0.5
    b = torch.as_tensor(bound, dtype=torch.float32, device=device)
    return params, tsdf, b, b.clone()


def tiny_frames(n_frames: int, device: torch.device, seed: int = 0):
    """Random colour (F, H, W, 3) and depth (F, H, W) at the tiny camera,
    identity poses (F, 4, 4)."""
    rng = np.random.default_rng(seed)
    color = torch.as_tensor(rng.uniform(0, 1, (n_frames, TINY_CAM.H, TINY_CAM.W, 3)), dtype=torch.float32, device=device)
    depth = torch.as_tensor(rng.uniform(0.5, 1.2, (n_frames, TINY_CAM.H, TINY_CAM.W)), dtype=torch.float32, device=device)
    c2w = torch.eye(4, device=device).repeat(n_frames, 1, 1)
    return color, depth, c2w


def _rank(rank: int, world: int, port: int) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    dev = torch.device("cpu")
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    init_distributed(device="cpu")
    try:
        shards = mesh_from_config({"parallel": {"enable": True}})
        params, tsdf, tsdf_bnds, bound = tiny_scene(dev)
        replicate(tree_leaves(params), shards)
        for t in tree_leaves(params):
            t.requires_grad_(True)
        color, depth, c2w = tiny_frames(2, dev)
        rcfg = RenderConfig(N_samples=8, N_surface=4)
        lrs = StageLRs(5e-3, 5e-3, 5e-3, 5e-3, 5e-3)
        gen = torch.Generator(device=dev).manual_seed(2)  # the same draws on every rank
        losses = mapping_stage(
            params, adam_init(params), color, depth, c2w, None, tsdf, tsdf_bnds, bound, 3, [0.0] * 3, lrs,
            "color", 8 * world, TINY_CAM, rcfg, (False, False), 0.2, generator=gen, shards=shards,
        )
        best, tlosses, _, _ = track_frame(
            params, torch.tensor([1.0, 0, 0, 0, 0, 0, 0], device=dev), color[0], depth[0], tsdf, tsdf_bnds, bound,
            TINY_CAM, rcfg, 8 * world, 2, 2, 2, True, True, 0.5, 1e-3,
            generator=torch.Generator(device=dev).manual_seed(3), shards=shards,
        )
        if not (torch.isfinite(losses).all() and torch.isfinite(tlosses).all()):
            raise RuntimeError(f"rank {rank}: non-finite loss (map {losses.tolist()}, track {tlosses.tolist()})")
        mine = torch.cat([t.detach().reshape(-1) for t in tree_leaves(params)] + [best.reshape(-1)])
        every = [torch.empty_like(mine) for _ in range(world)]
        dist.all_gather(every, mine)
        if not all(torch.equal(every[0], e) for e in every[1:]):
            raise RuntimeError("the ranks' scenes or poses differ")
        if rank == 0:
            print(f"dryrun_multichip: OK on {world} ranks ({dist.get_backend()}, cpu), "
                  f"map_loss={float(losses[-1]):.4f} track_loss={float(tlosses[-1]):.4f}, replicas bit-equal",
                  flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n: int) -> None:
    """Run the dry run on ``n`` spawned ranks; raises if a rank fails."""
    mp.start_processes(_rank, args=(n, free_port()), nprocs=n, join=True, start_method="spawn")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=2, help="ranks (default 2)")
    dryrun_multichip(ap.parse_args(argv).n)


if __name__ == "__main__":
    main()
