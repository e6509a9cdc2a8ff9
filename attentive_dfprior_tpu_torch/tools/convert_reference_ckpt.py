"""Convert a reference (torch) DF-Prior checkpoint into the port's checkpoint.

The port's counterpart of the JAX package's ``tools/convert_reference_ckpt.py``.
The reference Logger saves ``{'c': grids[1,C,Z,Y,X], 'decoder_state_dict':
..., 'estimate_c2w_list': ..., ...}`` as a torch .tar
(ref: src/utils/Logger.py:22-37). This tool remaps:
  - grids: [1, C, NZ, NY, NX] -> channels-last (NX, NY, NZ, C)
  - decoder weights: torch (out, in) Linear layout -> (in, out)
  - trajectories / keyframe metadata -> the ``.npz`` checkpoint schema

The result is the schema ``utils/logger.py`` writes and reads, which the
JAX package shares, so either package resumes or evaluates it.

Usage:
    python -m attentive_dfprior_tpu_torch.tools.convert_reference_ckpt ckpts/00005.tar out.npz
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from attentive_dfprior_tpu_torch.utils.logger import _flatten_params

N_BLOCKS = 5
N_TSDF_LAYERS = 4


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def convert_grid(t) -> np.ndarray:
    """[1, C, NZ, NY, NX] torch tensor -> (NX, NY, NZ, C) numpy."""
    return np.transpose(_np(t)[0], (3, 2, 1, 0)).copy()


def _linear(sd: Dict[str, Any], name: str) -> Dict[str, np.ndarray]:
    return {"w": _np(sd[f"{name}.weight"]).T, "b": _np(sd[f"{name}.bias"])}


def convert_mlp_decoder(sd: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    return {
        "B": _np(sd[f"{prefix}.embedder._B"]),
        "pts": [_linear(sd, f"{prefix}.pts_linears.{i}") for i in range(N_BLOCKS)],
        "fc_c": [_linear(sd, f"{prefix}.fc_c.{i}") for i in range(N_BLOCKS)],
        "out": _linear(sd, f"{prefix}.output_linear"),
    }


def convert_mlp_tsdf(sd: Dict[str, Any]) -> Dict[str, Any]:
    return {
        "layers": [_linear(sd, f"mlp.pts_linears.{i}") for i in range(N_TSDF_LAYERS)],
        "out": _linear(sd, "mlp.output_linear"),
    }


def convert(ckpt_path: str) -> Dict[str, Any]:
    """The reference checkpoint at ``ckpt_path`` as ``{"params": scene
    tree of numpy arrays, "meta": trajectory and keyframes}``."""
    ckpt = torch.load(ckpt_path, map_location="cpu")
    sd = ckpt["decoder_state_dict"]
    params = {
        "grid_low": convert_grid(ckpt["c"]["grid_low"]),
        "grid_high": convert_grid(ckpt["c"]["grid_high"]),
        "grid_color": convert_grid(ckpt["c"]["grid_color"]),
        "low": convert_mlp_decoder(sd, "low_decoder"),
        "high": convert_mlp_decoder(sd, "high_decoder"),
        "color": convert_mlp_decoder(sd, "color_decoder"),
        "mlp": convert_mlp_tsdf(sd),
    }
    meta = {
        "idx": int(ckpt["idx"]),
        "estimate_c2w_list": _np(ckpt["estimate_c2w_list"]),
        "gt_c2w_list": _np(ckpt["gt_c2w_list"]),
        "keyframe_idx_list": np.asarray(ckpt.get("keyframe_list", []), np.int64),
    }
    return {"params": params, "meta": meta}


def checkpoint_payload(data: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """``convert``'s output as the arrays of a ``Logger.log`` checkpoint."""
    meta = data["meta"]
    kf = meta["keyframe_idx_list"]
    payload = _flatten_params(data["params"])
    payload.update(
        idx=np.asarray(meta["idx"]),
        estimate_c2w_list=meta["estimate_c2w_list"],
        gt_c2w_list=meta["gt_c2w_list"],
        keyframe_idx_list=kf,
        keyframe_est_c2w=np.stack([meta["estimate_c2w_list"][i] for i in kf], axis=0)
        if len(kf) else np.zeros((0, 4, 4), np.float32),
    )
    return payload


def main(argv: Optional[List[str]] = None) -> str:
    ap = argparse.ArgumentParser(description="Convert a reference DF-Prior .tar checkpoint to the .npz schema.")
    ap.add_argument("torch_ckpt", help="reference ckpts/xxxxx.tar")
    ap.add_argument("out_npz", help="output .npz in the checkpoint schema")
    args = ap.parse_args(argv)
    np.savez_compressed(args.out_npz, **checkpoint_payload(convert(args.torch_ckpt)))
    print(f"converted {args.torch_ckpt} -> {args.out_npz}")
    return args.out_npz


if __name__ == "__main__":
    main()
