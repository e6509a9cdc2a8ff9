"""Ray-axis data parallelism on ``torch.distributed``, one process per device.

The port of the JAX package's ``parallel/sharding.py``. The JAX package
annotates a 1-D ``dp`` mesh and lets XLA insert the collectives; here every
rank is a process driving one card (PyTorch's own idiom: the port is launch
bound, so each card needs a host thread of its own), and the collectives are
explicit:

  - scene parameters (and the TSDF prior) are replicated: broadcast from
    rank 0 once after set-up (``replicate``);
  - every rank draws the same whole ray batch from the same generator state
    and renders its block of the ray axis (``ray_block``), the block that
    ``P('dp')`` gives a device when the batch divides evenly;
  - batch-wide quantities are computed from the whole batch before the
    split (the far plane's max depth) or gathered (the tracker's median);
  - the local gradients (and the loss) are summed over the group by one
    ``all_reduce(SUM)`` of one flat bucket per step (``RayShards.all_reduce``),
    before the frustum masks and the lazy Adam, which must see the reduced
    gradient.

``RayShards`` names the blocks a process computes: ``(rank,)`` in a
process group, or every block of ``size`` in one process with no group at
all, which is how the tests hold the shard arithmetic to the unsharded step
without sockets.

The async agents (``sync_method: loose | free``) issue collectives from two
threads, so they get groups of their own (``AgentGroups``):

  - on a shared dp group (``shared_groups``) the mapper and the tracker
    each sum over a group of its own over the same ranks: ``torch.distributed``
    matches a group's collectives by the order of the calls, so two threads on
    one group would sum each other's buffers. ``slam/schedule.py`` orders the
    two agents' units the same way on every rank;
  - ``parallel.split`` (``split_groups_from_config``, the JAX
    ``split_meshes_from_config``) gives the mapper the first ``map`` ranks and
    the tracker the next ``track``, each with its own dp group, and a publish
    group (map rank 0 and every track rank) over which the scene is
    broadcast.

``dist.new_group`` is collective over the whole world: every rank builds
every group, in the same order, from the main thread, before any worker
thread starts (``SLAMSystem.__init__``).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from attentive_dfprior_tpu_torch.render.renderer import RenderConfig
from attentive_dfprior_tpu_torch.slam.mapper import StageLRs, build_lr_tree, mapping_step
from attentive_dfprior_tpu_torch.utils.device import local_rank

GROUP_TIMEOUT_S = 600.0  # a collective that waits longer than this fails the process group


def ray_block(n: int, rank: int, size: int) -> slice:
    """The contiguous block of an ``n``-ray batch that ``rank`` of ``size``
    renders. With ``n`` divisible by ``size`` every block has ``n / size``
    rays, as ``P('dp')`` splits the axis; otherwise the first ``n % size``
    blocks take one ray more (``numpy.array_split``'s rule), so no block is
    empty. Raises when ``n < size``."""
    if n < size:
        raise ValueError(f"a batch of {n} rays cannot give each of {size} ranks a ray")
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} is not in [0, {size})")
    q, r = divmod(n, size)
    start = rank * q + min(rank, r)
    return slice(start, start + q + (rank < r))


@dataclasses.dataclass(frozen=True)
class RayShards:
    """The ray-axis blocks this process computes.

    Attributes:
        size: the number of blocks, the dp group's size.
        ranks: the blocks computed here: ``(rank,)`` in a process group;
            ``tuple(range(size))`` in one process with no group.
        group: the ``torch.distributed`` group the sums run over, or None
            (the blocks in ``ranks`` are all there is).
    """

    size: int
    ranks: Tuple[int, ...]
    group: Any = None

    def block(self, n: int, rank: int) -> slice:
        return ray_block(n, rank, self.size)

    def local_blocks(self, gt_depth: torch.Tensor) -> Tuple[List[slice], torch.Tensor]:
        """The blocks of a drawn batch (``gt_depth``: its (n,) depths) that
        this process renders, and the far plane's max depth, which is the
        whole batch's, taken before the split."""
        n = gt_depth.shape[0]
        return [self.block(n, r) for r in self.ranks], torch.max(gt_depth)

    def all_reduce(self, tensors: Sequence[Optional[torch.Tensor]]) -> List[Optional[torch.Tensor]]:
        """Sum ``tensors`` over the group: one ``all_reduce(SUM)`` of one
        flat bucket. ``None`` entries pass through (every rank holds the same
        ones). Without a group the tensors are returned as they are.

        Nothing waits on the host: the call is synchronous to the caller's
        stream only (``async_op=False``: the stream waits for the
        collective's event), so a CUDA graph capturing the caller's stream
        holds the all-reduce on an NCCL group (``utils/step_graph.py``),
        the bucket in the graph's pool, at the same address every replay."""
        if self.group is None:
            return list(tensors)
        present = [t for t in tensors if t is not None]
        flat = torch.cat([t.detach().reshape(-1) for t in present])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group, async_op=False)
        out, off = [], 0
        for t in tensors:
            if t is None:
                out.append(None)
                continue
            out.append(flat[off : off + t.numel()].view_as(t))
            off += t.numel()
        return out

    def gather_rays(self, parts: Sequence[torch.Tensor], n: int) -> torch.Tensor:
        """The whole ``n``-ray batch of a per-ray quantity from this
        process's blocks ``parts`` (in ``ranks`` order): each block written
        at its place in zeros and the result summed over the group, an
        all-gather that takes blocks of unequal length, on the device with
        no host read (a graph holds it, as ``all_reduce``)."""
        full = parts[0].new_zeros((n,) + tuple(parts[0].shape[1:]))
        for r, p in zip(self.ranks, parts):
            full[self.block(n, r)] = p
        return self.all_reduce([full])[0]


def init_distributed(backend: Optional[str] = None, device: Optional[str] = None):
    """Join the process group from the launcher's environment; returns
    (rank, world size, backend).

    Reads ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``
    (``torchrun``), else the JAX ``run.py``'s manual variables
    ``DFPRIOR_COORD`` (host:port), ``DFPRIOR_NPROCS`` and
    ``DFPRIOR_PROC_ID``; raises when neither is set. ``backend`` defaults to
    NCCL for a CUDA ``device`` (the default) and gloo for the CPU; gloo on
    CUDA tensors is asked for by name. A process group that is already
    initialized is kept as it is.
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), dist.get_backend()
    dev = torch.device("cuda" if device is None else device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    env = os.environ
    if env.get("WORLD_SIZE") and env.get("MASTER_ADDR"):
        init, world, rank = "env://", int(env["WORLD_SIZE"]), int(env.get("RANK", "0"))
    elif env.get("DFPRIOR_COORD"):
        init, world, rank = f"tcp://{env['DFPRIOR_COORD']}", int(env["DFPRIOR_NPROCS"]), int(env["DFPRIOR_PROC_ID"])
    else:
        raise RuntimeError(
            "no launcher environment: set RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT (torchrun does), "
            "or DFPRIOR_COORD=host:port / DFPRIOR_NPROCS / DFPRIOR_PROC_ID"
        )
    if backend == "nccl":
        torch.cuda.set_device(dev.index if dev.index is not None else local_rank())
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    return rank, world, backend


def mesh_from_config(cfg: Optional[Dict[str, Any]]) -> Optional[RayShards]:
    """The dp group from the ``parallel`` config section (the JAX
    ``mesh_from_config``):

        parallel:
          enable: False      # ray-axis data parallelism
          n_devices: -1      # -1: every rank of the process group
          multihost: False   # run.py joins the group (--multihost)

    Returns None when ``enable`` is off or fewer than 2 ranks take part, so
    the single-device path runs unchanged. One process drives one device,
    so ``n_devices`` must be -1 or the world's size: larger raises, as in
    the JAX package, and smaller raises too (a rank outside the group
    would have nothing to do; launch ``n_devices`` processes instead).
    """
    p = (cfg or {}).get("parallel") or {}
    if not bool(p.get("enable", False)):
        return None
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = int(p.get("n_devices", -1))
    if n > world:
        raise ValueError(f"parallel.n_devices={n} but only {world} processes take part")
    if 0 < n < world:
        raise ValueError(
            f"parallel.n_devices={n} but {world} processes take part: one process drives one device, "
            f"so launch {n} processes"
        )
    if world < 2:
        return None
    return RayShards(size=world, ranks=(dist.get_rank(),), group=dist.group.WORLD)


@dataclasses.dataclass(frozen=True)
class AgentGroups:
    """The async agents' groups on this rank.

    Attributes:
        role: ``"map"`` or ``"track"`` under ``parallel.split``; ``"shared"``
            on a shared dp group, where every rank runs both agents.
        map: the mapper's sums (mapping, BA, loop closure's relaxation), or
            None where this rank does not map or maps alone.
        track: the tracker's sums (tracking, the final refine), or None
            where this rank does not track or tracks alone.
        world: every rank, for the set-up's ``replicate``.
        map_ranks, track_ranks: global ranks of the two agents.
        publish: split only: the group of map rank 0 and every track rank.
    """

    role: str
    map: Optional[RayShards]
    track: Optional[RayShards]
    world: RayShards
    map_ranks: Tuple[int, ...]
    track_ranks: Tuple[int, ...]
    publish: Any = None

    @property
    def lead(self) -> int:
        """The rank that takes the schedule's decisions (``slam/schedule.py``):
        rank 0 on a shared group, the first track rank under split."""
        return self.track_ranks[0] if self.role != "shared" else 0


def _new_group(ranks: Sequence[int]) -> Optional[RayShards]:
    """A group over ``ranks`` (built on every rank, ``dist.new_group`` is
    collective); this rank's ``RayShards`` over it, or None where this rank
    is not in it or it has a single rank (no dp arithmetic at all)."""
    group = dist.new_group(list(ranks), timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    rank = dist.get_rank()
    if rank not in ranks or len(ranks) < 2:
        return None
    return RayShards(size=len(ranks), ranks=(list(ranks).index(rank),), group=group)


def split_counts(cfg: Optional[Dict[str, Any]], world: int) -> Optional[Tuple[int, int]]:
    """The (map, track) rank counts of ``parallel.split`` in a world of
    ``world`` processes, or None when not configured; raises where the JAX
    ``split_meshes_from_config`` raises (``map`` or ``track`` below 1, more
    ranks than devices) and also when ``map + track`` is smaller than the
    world, since one process drives one device."""
    p = (cfg or {}).get("parallel") or {}
    split = p.get("split")
    if not p or not bool(p.get("enable", False)) or not split:
        return None
    k, m = int(split.get("map", 0)), int(split.get("track", 0))
    if k < 1 or m < 1:
        raise ValueError(f"parallel.split needs map>=1 and track>=1, got {split}")
    if k + m > world:
        raise ValueError(f"parallel.split map={k}+track={m} exceeds {world} devices")
    if k + m < world:
        raise ValueError(
            f"parallel.split map={k}+track={m} but {world} processes take part: one process drives one "
            f"device, so launch {k + m} processes"
        )
    return k, m


def split_groups_from_config(cfg: Optional[Dict[str, Any]]) -> Optional[AgentGroups]:
    """Disjoint mapper and tracker groups from ``parallel.split`` (the JAX
    ``split_meshes_from_config``):

        parallel:
          enable: True
          split: {map: 1, track: 1}   # global ranks [0, map) map, the next track track

    Returns None when not configured. Builds the map group, the track group
    and the publish group (map rank 0 and every track rank), in that order,
    on every rank."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    counts = split_counts(cfg, world)
    if counts is None:
        return None
    k, m = counts
    map_ranks, track_ranks = tuple(range(k)), tuple(range(k, k + m))
    map_shards, track_shards = _new_group(map_ranks), _new_group(track_ranks)
    publish = dist.new_group([0, *track_ranks], timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    rank = dist.get_rank()
    world_shards = RayShards(size=world, ranks=(rank,), group=dist.group.WORLD)
    return AgentGroups("map" if rank < k else "track", map_shards, track_shards, world_shards, map_ranks,
                       track_ranks, publish)


def shared_groups(shards: RayShards) -> AgentGroups:
    """The async agents on the shared dp group ``shards``: the mapper and
    the tracker each get a group of their own over the same ranks (two
    threads never issue collectives on one group). Needs the process group
    the ranks joined."""
    if shards.group is None or not dist.is_initialized():
        raise ValueError(
            f"loose / free on a dp group of {shards.size} ranks needs the process group the ranks joined "
            "(parallel/sharding.py:init_distributed)"
        )
    ranks = tuple(range(dist.get_world_size()))
    return AgentGroups("shared", _new_group(ranks), _new_group(ranks), shards, ranks, ranks)


def replicate(tensors: Sequence[torch.Tensor], shards: Optional[RayShards], src: int = 0) -> None:
    """Broadcast ``tensors`` from rank ``src`` in place, as one flat bucket
    (a single contiguous tensor is broadcast as it is). A no-op without a
    group."""
    if shards is None or shards.group is None or not tensors:
        return
    with torch.no_grad():
        if len(tensors) == 1 and tensors[0].is_contiguous():
            dist.broadcast(tensors[0], src=src, group=shards.group)
            return
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        dist.broadcast(flat, src=src, group=shards.group)
        off = 0
        for t in tensors:
            t.copy_(flat[off : off + t.numel()].view_as(t))
            off += t.numel()


def sharded_mapping_step(
    params: Any,
    adam_state: Any,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    gt_depth: torch.Tensor,
    gt_color: torch.Tensor,
    inside_mask: torch.Tensor,
    tsdf_volume: torch.Tensor,
    tsdf_bnds: torch.Tensor,
    bound: torch.Tensor,
    lrs: StageLRs,
    stage: str,
    rcfg: RenderConfig,
    fix_flags: Tuple[bool, bool],
    w_color_loss: float,
    shards: RayShards,
    grid_vjp: str = "halo",
) -> torch.Tensor:
    """One data-parallel mapping step on a drawn ray batch (the JAX
    ``sharded_mapping_step``), in place on ``params`` and ``adam_state``:
    the mapper's own step (``slam/mapper.py:mapping_step``, which
    ``mapping_stage`` runs every iteration) with no frustum mask. Every
    leaf of ``params`` must require grad. Returns the whole batch's loss."""
    return mapping_step(
        params, adam_state, rays_o, rays_d, gt_depth, gt_color, inside_mask, tsdf_volume, tsdf_bnds, bound,
        build_lr_tree(params, lrs, *fix_flags), stage, rcfg, w_color_loss, grid_vjp=grid_vjp, shards=shards,
    )
