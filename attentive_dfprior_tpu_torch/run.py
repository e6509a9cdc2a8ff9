"""Run SLAM on a scene config — the port's counterpart of run.py.

Usage:
    python -m attentive_dfprior_tpu_torch.run configs/Synthetic/room_tracking.yaml \\
        [--end_idx N] [--output O] [--input_folder F] [--resume] [--seed S]
        [--device cuda|cpu] [--grid-vjp halo|bitfold|cellstencil|xla|sorted|pallas]
        [--adam-nonlazy] [--set key.sub=value ...]

Runs on the card unless ``--device cpu`` is given. ``--resume`` continues
from the latest checkpoint under ``<output>/ckpts`` (either package's).
``--grid-vjp`` selects the feature grids' gradient variant and
``--adam-nonlazy`` steps every Adam leaf in every iteration: the JAX
package's ``DFPRIOR_TRILINEAR_VJP`` and ``DFPRIOR_ADAM_LAZY=0``. ``--set``
overrides config entries after loading (values parsed as YAML scalars),
e.g. ``--set mapping.vis_freq=5``; ``--set sync_method=loose`` (or
``free``) runs the mapper on a worker thread of its own
(``slam/system.py:_run_async``).
"""

from __future__ import annotations

import argparse
import os
import random
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from attentive_dfprior_tpu_torch.config import default_config_path, load_config, parse_yaml
from attentive_dfprior_tpu_torch.ops.grid_sample import GRID_VJPS


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
    """Parse ``argv``, run SLAM, and return the SLAMSystem after the run."""
    parser = argparse.ArgumentParser(description="SLAM (PyTorch/CUDA port).")
    parser.add_argument("config", type=str, help="path to the scene config")
    parser.add_argument("--output", type=str, help="overrides the config's output path")
    parser.add_argument("--input_folder", type=str, help="overrides the config's input path")
    parser.add_argument("--resume", action="store_true", help="resume from the latest checkpoint")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--end_idx", type=int, default=None, help="stop before this frame")
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--grid-vjp", default="halo", choices=GRID_VJPS,
                        help="grid-gradient variant of the feature-grid samplers")
    parser.add_argument("--adam-nonlazy", action="store_true",
                        help="step every Adam leaf each iteration (no per-leaf lazy rule)")
    parser.add_argument("--set", dest="overrides", action="append", default=[],
                        help="config override key.sub=value (repeatable)")
    args = parser.parse_args(argv)

    np.random.seed(args.seed)
    random.seed(args.seed)
    torch.manual_seed(args.seed)

    from attentive_dfprior_tpu_torch.slam.system import SLAMSystem

    cfg = load_config(args.config, default_config_path())
    apply_overrides(cfg, args.overrides)
    cfg["seed"] = args.seed
    slam = SLAMSystem(cfg, args, device=args.device, grid_vjp=args.grid_vjp, adam_lazy=not args.adam_nonlazy)
    start = 0
    if args.resume:
        from attentive_dfprior_tpu_torch.utils.logger import latest_checkpoint

        ckpt = latest_checkpoint(os.path.join(slam.output, "ckpts"))
        if ckpt:
            start = slam.resume(ckpt)
            print(f"Resumed from {ckpt}; continuing at frame {start}")
    slam.run(start_idx=start, end_idx=args.end_idx)
    return slam


if __name__ == "__main__":
    main()
