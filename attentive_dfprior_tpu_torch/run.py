"""Run SLAM on a scene config — the port's counterpart of run.py.

Usage:
    python -m attentive_dfprior_tpu_torch.run configs/Synthetic/room_tracking.yaml \\
        [--end_idx N] [--output O] [--input_folder F] [--resume] [--seed S]
        [--device cuda|cuda:N|cpu] [--grid-vjp halo|bitfold|cellstencil|xla|sorted|pallas]
        [--adam-nonlazy] [--eager] [--multihost] [--init_only] [--profile DIR] [--set key.sub=value ...]

    # ray-axis data parallelism over N cards of one host (strict, loose or free)
    torchrun --nproc_per_node N -m attentive_dfprior_tpu_torch.run <cfg> --set parallel.enable=true
    # the mapper on the first k cards, the tracker on the next m (loose or free)
    torchrun --nproc_per_node k+m -m attentive_dfprior_tpu_torch.run <cfg> --set sync_method=loose \
        --set parallel.enable=true --set parallel.split.map=k --set parallel.split.track=m

Runs on the card unless ``--device cpu`` is given; in a process group,
``cuda`` is this rank's card, ``cuda:{LOCAL_RANK}``. ``--resume`` continues
from the latest checkpoint under ``<output>/ckpts`` (either package's).
``--grid-vjp`` selects the feature grids' gradient variant and
``--adam-nonlazy`` steps every Adam leaf in every iteration: the JAX
package's ``DFPRIOR_TRILINEAR_VJP`` and ``DFPRIOR_ADAM_LAZY=0``. On the card
each mapping stage's and each tracked frame's iteration is captured once
as a CUDA graph and replayed (``utils/step_graph.py``), and so is each
chunk of the renders (panels) and of the Mesher's field queries;
``--eager`` runs them all in Python instead. The run ends with a line of
what the render programs captured and replayed. A dp agent on NCCL replays its graphs with the
all-reduce inside; an agent on a gloo group (``--device cpu``, or gloo
asked for by name) always runs eager. ``--set``
overrides config entries after loading (values parsed as YAML scalars),
e.g. ``--set mapping.vis_freq=5``; ``--set sync_method=loose`` (or
``free``) runs the mapper on a worker thread of its own
(``slam/system.py:_run_async``). ``--profile DIR`` traces the run with
``torch.profiler`` into ``DIR`` and writes the program's spans beside the
trace, on its clock (``utils/profiling.py:torch_trace``).

``--multihost`` (or ``parallel.multihost: True``) joins the process group
from the launcher's environment (``parallel/sharding.py:init_distributed``:
``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``, or the JAX
``run.py``'s ``DFPRIOR_COORD`` / ``DFPRIOR_NPROCS`` / ``DFPRIOR_PROC_ID``),
as does ``parallel.enable`` under a launcher that sets ``WORLD_SIZE`` > 1:
NCCL on the card, gloo on the CPU. ``--init_only`` all-reduces one value
over the group, prints ``multihost: process i/n, backend <b>, device <d>``
and exits.
"""

from __future__ import annotations

import argparse
import json
import os
import random
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from attentive_dfprior_tpu_torch.config import default_config_path, load_config, parse_yaml
from attentive_dfprior_tpu_torch.ops.grid_sample import GRID_VJPS
from attentive_dfprior_tpu_torch.parallel.sharding import init_distributed
from attentive_dfprior_tpu_torch.utils.device import resolve_device
from attentive_dfprior_tpu_torch.utils.profiling import torch_trace


def apply_overrides(cfg: Dict[str, Any], overrides: List[str]) -> None:
    """Apply ``key.sub=value`` overrides in place."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override {item!r} is not key=value")
        path, value = item.split("=", 1)
        keys = path.split(".")
        node = cfg
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = parse_yaml(f"v: {value}")["v"]


def main(argv: Optional[List[str]] = None):
    """Parse ``argv``, run SLAM, and return the SLAMSystem after the run
    (None with ``--init_only``). A process group it joins stays up for the
    caller; ``__main__`` tears it down."""
    parser = argparse.ArgumentParser(description="SLAM (PyTorch/CUDA port).")
    parser.add_argument("config", type=str, help="path to the scene config")
    parser.add_argument("--output", type=str, help="overrides the config's output path")
    parser.add_argument("--input_folder", type=str, help="overrides the config's input path")
    parser.add_argument("--resume", action="store_true", help="resume from the latest checkpoint")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--end_idx", type=int, default=None, help="stop before this frame")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default; this rank's card in a process group), cuda:N or cpu")
    parser.add_argument("--grid-vjp", default="halo", choices=GRID_VJPS,
                        help="grid-gradient variant of the feature-grid samplers")
    parser.add_argument("--adam-nonlazy", action="store_true",
                        help="step every Adam leaf each iteration (no per-leaf lazy rule)")
    parser.add_argument("--eager", action="store_true",
                        help="run each iteration, render chunk and field-query chunk in Python, "
                        "not as a replayed CUDA graph")
    parser.add_argument("--multihost", action="store_true",
                        help="join the process group from the launcher's environment "
                        "(equivalent to parallel.multihost: True)")
    parser.add_argument("--init_only", action="store_true",
                        help="set up the runtime (and with --multihost the process group), print it and exit")
    parser.add_argument("--set", dest="overrides", action="append", default=[],
                        help="config override key.sub=value (repeatable)")
    parser.add_argument("--profile", type=str, default=None, metavar="DIR",
                        help="trace the run with torch.profiler into DIR, the program's spans beside it")
    args = parser.parse_args(argv)

    np.random.seed(args.seed)
    random.seed(args.seed)
    torch.manual_seed(args.seed)

    from attentive_dfprior_tpu_torch.slam.system import SLAMSystem

    cfg = load_config(args.config, default_config_path())
    apply_overrides(cfg, args.overrides)
    cfg["seed"] = args.seed
    par = cfg.get("parallel") or {}
    launched = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if args.multihost or bool(par.get("multihost", False)) or (bool(par.get("enable", False)) and launched):
        init_distributed(device=args.device)
    if args.init_only:
        device = resolve_device(args.device)
        if dist.is_initialized():
            # one collective through the backend, so a group that cannot
            # reduce fails here and not at the first mapping step
            probe = torch.ones(1, device=device)
            dist.all_reduce(probe)
            if int(probe.item()) != dist.get_world_size():
                raise RuntimeError(f"all_reduce of ones gave {probe.item()}, not {dist.get_world_size()}")
            print(f"multihost: process {dist.get_rank()}/{dist.get_world_size()}, "
                  f"backend {dist.get_backend()}, device {device}", flush=True)
        else:
            print(f"multihost: process 0/1, backend none, device {device}", flush=True)
        return None
    slam = SLAMSystem(cfg, args, device=args.device, grid_vjp=args.grid_vjp, adam_lazy=not args.adam_nonlazy,
                      step_mode="eager" if args.eager else None)
    start = 0
    if args.resume:
        from attentive_dfprior_tpu_torch.utils.logger import latest_checkpoint

        ckpt = latest_checkpoint(os.path.join(slam.output, "ckpts"))
        if ckpt:
            start = slam.resume(ckpt)
            print(f"Resumed from {ckpt}; continuing at frame {start}")
    with torch_trace(args.profile):
        slam.run(start_idx=start, end_idx=args.end_idx)
    print(f"render and field-query programs: {json.dumps(slam.forward_graphs.stats())}", flush=True)
    return slam


if __name__ == "__main__":
    try:
        main()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
