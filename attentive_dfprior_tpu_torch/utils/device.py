"""Device selection: the card unless the caller asks for the CPU."""

from __future__ import annotations

import os
import subprocess
import threading
from typing import Dict, Optional, Tuple, Union

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


_CONSTANTS: Dict[Tuple, torch.Tensor] = {}
_CONSTANTS_LOCK = threading.Lock()


def device_constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """A constant tensor of ``values`` (a number or a tuple) on ``device``,
    made once per process and reused: a step that a CUDA graph captures
    may not copy from the host, so it reads constants made before."""
    dev = torch.device(device)
    key = (values, dtype, dev.type, dev.index if dev.index is not None else (0 if dev.type == "cuda" else None))
    t = _CONSTANTS.get(key)
    if t is None:
        with _CONSTANTS_LOCK:
            t = _CONSTANTS.get(key)
            if t is None:
                t = _CONSTANTS[key] = torch.tensor(values, dtype=dtype, device=dev)
    return t


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
