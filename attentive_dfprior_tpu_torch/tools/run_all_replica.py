"""All eight Replica scenes, one after another: the port of
``scripts/run_all_replica.py``.

    python -m attentive_dfprior_tpu_torch.tools.run_all_replica
        [--input_folder 'DATA/Replica/{scene}'] [--scenes room0 office0 ...]
        [--skip_tsdf] [--device cuda|cpu]

For each scene, in the working directory (where ``configs/`` and
``pretrained/`` resolve): the TSDF builder on every frame (``--space 1``)
unless ``--skip_tsdf``, then the SLAM entry point, then ``tools.eval_ate``
on the run's output, each as ``python -m attentive_dfprior_tpu_torch...``.
``--input_folder`` is a template (``{scene}`` is replaced by the scene's
name) passed to the builder and the entry point; without it the configs'
own ``data.input_folder`` is read. A step that fails stops the run.
Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from typing import Callable, List, Optional

from attentive_dfprior_tpu_torch.utils.device import resolve_device

SCENES = ["room0", "room1", "room2", "office0", "office1", "office2", "office3", "office4"]
PKG = "attentive_dfprior_tpu_torch"


def commands(scene: str, input_folder: Optional[str], skip_tsdf: bool, device: str) -> List[List[str]]:
    """The command lines run for ``scene``, in order."""
    cfg = f"configs/Replica/{scene}.yaml"
    data = [] if input_folder is None else ["--input_folder", input_folder.format(scene=scene)]
    out = []
    if not skip_tsdf:
        out.append([sys.executable, "-m", f"{PKG}.tsdf.builder", cfg, "--space", "1", *data, "--device", device])
    out.append([sys.executable, "-m", f"{PKG}.run", cfg, *data, "--device", device])
    out.append([sys.executable, "-m", f"{PKG}.tools.eval_ate", cfg])
    return out


def main(argv: Optional[List[str]] = None, runner: Callable[..., object] = subprocess.run) -> None:
    """Runs every scene's commands with ``runner(cmd, check=True)``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scenes", nargs="*", default=SCENES)
    ap.add_argument("--input_folder", default=None, help="the data folder, '{scene}' replaced by each scene's name")
    ap.add_argument("--skip_tsdf", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    resolve_device(args.device)  # without a card, fail before the first scene
    for scene in args.scenes:
        for cmd in commands(scene, args.input_folder, args.skip_tsdf, args.device):
            runner(cmd, check=True)


if __name__ == "__main__":
    main()
