"""Device selection: the card unless the caller asks for the CPU."""

from __future__ import annotations

import os
import subprocess
from typing import Optional, Union

import torch
import torch.distributed as dist


def local_rank() -> int:
    """This process's device index on its host: the launcher's
    ``LOCAL_RANK``, else 0."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """Return the device an entry point runs on.

    ``None`` means the card. The CPU is used only when asked for by name;
    asking for CUDA (explicitly or by default) on a machine without it
    raises instead of silently running on the CPU. In a process group
    (``parallel/sharding.py``), a CUDA device without an index is this
    rank's card, ``cuda:{LOCAL_RANK}``; a device named with its index is
    kept.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None and dist.is_initialized():
        dev = torch.device("cuda", local_rank())
    return dev


def card_name_and_power() -> str:
    """``nvidia-smi``'s name and power limit of the card, or a note why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({type(e).__name__})"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else "not read"
