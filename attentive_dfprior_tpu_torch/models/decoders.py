"""Decoder MLPs and the attentive depth-fusion module.

The port of the JAX package's ``models/decoders.py`` (ref:
src/conv_onet/models/decoder.py:91-353). Parameters are the same nested
dict/list tree as the JAX pytree, with the same layouts:

  - Linear layers are ``{'w': (in, out), 'b': (out,)}`` applied as
    ``x @ w + b`` (the transpose of ``torch.nn.Linear``'s storage);
  - a decoder is ``{'B': (3, 93), 'pts': [5 linears], 'fc_c': [5 linears],
    'out': linear}``; the attention module is ``{'layers': [4], 'out'}``.

``df_forward`` is the stage-dispatched scene query ('low' | 'high' |
'color'). With ``fused=True`` (no-gradient paths only) each decoder MLP runs
through K2, the hand-written CUDA decoder kernel, on a CUDA tensor and
through its plain version on a CPU tensor. ``grid_vjp`` names the
feature grids' gradient variant (``ops/grid_sample.py:GRID_VJPS``).
``query_points`` runs ``eval_points_chunk`` in padded chunks, each a replay
of one captured program on the card (``utils/step_graph.py:ForwardGraphs``).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from attentive_dfprior_tpu_torch.models.embeddings import (
    fourier_embed,
    init_fourier_embedding,
)
from attentive_dfprior_tpu_torch.ops.grid_sample import (
    normalize_3d_coordinate,
    sample_feature_grid,
    sample_feature_grid_pair,
    trilinear_sample_tsdf,
)
from attentive_dfprior_tpu_torch.utils.step_graph import ForwardGraphs, pad_rows, tensor_key
from attentive_dfprior_tpu_torch.utils.tree import tree_leaves, tree_unflatten

EMBED_SIZE = 93
HIDDEN = 32
N_BLOCKS = 5
SKIPS = (2,)
MLP_TSDF_DIMS = (2, 64, 128, 128, 64)


def _uniform(g: Optional[torch.Generator], shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=g) * 2.0 - 1.0) * bound


def _dense_init(g, fan_in: int, fan_out: int, activation: str) -> Dict[str, torch.Tensor]:
    """xavier_uniform_ weight with the activation's gain, zero bias
    (DenseLayer init, ref: decoder.py:70-79)."""
    gain = float(np.sqrt(2.0)) if activation == "relu" else 1.0
    a = gain * float(np.sqrt(6.0 / (fan_in + fan_out)))
    return {"w": _uniform(g, (fan_in, fan_out), a), "b": torch.zeros(fan_out)}


def _torch_linear_init(g, fan_in: int, fan_out: int) -> Dict[str, torch.Tensor]:
    """torch.nn.Linear default init, U(+-1/sqrt(in)) for weight and bias —
    the reference's plain fc_c linears."""
    bnd = 1.0 / float(np.sqrt(fan_in))
    return {"w": _uniform(g, (fan_in, fan_out), bnd), "b": _uniform(g, (fan_out,), bnd)}


def _linear(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


# ---------------------------------------------------------------------------
# Grid-conditioned coordinate MLP (low / high / color decoders)
# ---------------------------------------------------------------------------


def init_mlp_decoder(
    generator: Optional[torch.Generator],
    c_dim: int = 32,
    color: bool = False,
    hidden: int = HIDDEN,
    n_blocks: int = N_BLOCKS,
) -> Dict[str, Any]:
    """One decoder MLP (ref: decoder.py:110-166): c_dim 32 for low/color,
    64 for high (its own feature + the low feature); 4 outputs (rgb + occ)
    for color, 1 otherwise."""
    pts = [_dense_init(generator, EMBED_SIZE, hidden, "relu")]
    for i in range(n_blocks - 1):
        fan_in = hidden + EMBED_SIZE if i in SKIPS else hidden
        pts.append(_dense_init(generator, fan_in, hidden, "relu"))
    fc_c = [_torch_linear_init(generator, c_dim, hidden) for _ in range(n_blocks)]
    return {
        "B": init_fourier_embedding(generator),
        "pts": pts,
        "fc_c": fc_c,
        "out": _dense_init(generator, hidden, 4 if color else 1, "linear"),
    }


def mlp_decoder_forward(params: Dict[str, Any], p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Decoder forward (ref: decoder.py:177-203).

    Args:
        p: (N, 3) world coordinates (embedded, not normalized).
        c: (N, c_dim) interpolated grid features.

    Returns:
        (N,) occupancy or (N, 4) rgb + occupancy.
    """
    e = fourier_embed(params["B"], p)
    h = e
    for i in range(len(params["pts"])):
        h = torch.relu(_linear(params["pts"][i], h))
        h = h + _linear(params["fc_c"][i], c)
        if i in SKIPS:
            h = torch.cat([e, h], dim=-1)
    out = _linear(params["out"], h)
    if out.shape[-1] == 1:
        out = out[..., 0]
    return out


# ---------------------------------------------------------------------------
# Attentive depth-fusion module (mlp_tsdf)
# ---------------------------------------------------------------------------


def init_mlp_tsdf(generator: Optional[torch.Generator]) -> Dict[str, Any]:
    """Attention MLP 2 -> 64 -> 128 -> 128 -> 64 -> 2 (ref: decoder.py:212-228)."""
    layers = [
        _dense_init(generator, MLP_TSDF_DIMS[i], MLP_TSDF_DIMS[i + 1], "relu")
        for i in range(len(MLP_TSDF_DIMS) - 1)
    ]
    return {"layers": layers, "out": _dense_init(generator, MLP_TSDF_DIMS[-1], 2, "linear")}


def tsdf_to_inv_occupancy(tsdf_val: torch.Tensor) -> torch.Tensor:
    """TSDF in [-1, 1] -> clamped logit of its occupancy reading
    (ref: decoder.py:244-248)."""
    t = torch.clamp(1.0 - (tsdf_val + 1.0) / 2.0, 0.0, 1.0)
    inv = -0.1 * torch.log(1.0 / (t + 1e-8) - 1.0 + 1e-7)
    return torch.clamp(inv, -100.0, 100.0)


def mlp_tsdf_forward(
    params: Dict[str, Any], occ: torch.Tensor, inv_tsdf: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention blend of learned and TSDF occupancy (ref: decoder.py:240-258).

    Returns:
        blended (N,), the TSDF-branch attention weight (N,).
    """
    x = torch.stack([occ, inv_tsdf], dim=-1)
    h = x
    for layer in params["layers"]:
        h = torch.relu(_linear(layer, h))
    w = torch.softmax(_linear(params["out"], h), dim=-1)
    return torch.sum(w * x, dim=-1), w[:, 1]


# ---------------------------------------------------------------------------
# Full DF decoder set + stage dispatch
# ---------------------------------------------------------------------------


def init_df_decoders(generator: Optional[torch.Generator], c_dim: int = 32) -> Dict[str, Any]:
    """All decoder parameters (ref: decoder.py:276-292)."""
    return {
        "low": init_mlp_decoder(generator, c_dim=c_dim, color=False),
        "high": init_mlp_decoder(generator, c_dim=2 * c_dim, color=False),
        "color": init_mlp_decoder(generator, c_dim=c_dim, color=True),
        "mlp": init_mlp_tsdf(generator),
    }


def sample_tsdf(tsdf_volume: torch.Tensor, p: torch.Tensor, tsdf_bnds: torch.Tensor) -> torch.Tensor:
    """Trilinear TSDF-prior lookup at world points (ref: decoder.py:295-303),
    in the arithmetic order of the JAX package's production rows sampler.

    Args:
        tsdf_volume: (X, Y, Z); p: (N, 3); tsdf_bnds: (3, 2).
    """
    return trilinear_sample_tsdf(tsdf_volume, normalize_3d_coordinate(p, tsdf_bnds))


def _decoder_eval(dec_params: Dict[str, Any], p: torch.Tensor, c: torch.Tensor, fused: bool) -> torch.Tensor:
    """One decoder MLP, plain or through K2 (forward only: use fused=True
    only on no-gradient paths). K2's weight image is built once per
    parameter version."""
    if not fused:
        return mlp_decoder_forward(dec_params, p, c)
    from attentive_dfprior_tpu_torch.ops.cuda.decoder_kernel import fused_decoder_forward

    out = fused_decoder_forward(dec_params, p, c)
    if out.shape[-1] == 1:
        out = out[..., 0]
    return out


def df_forward(
    params: Dict[str, Any],
    p: torch.Tensor,
    grids: Dict[str, torch.Tensor],
    tsdf_volume: torch.Tensor,
    tsdf_bnds: torch.Tensor,
    bound: torch.Tensor,
    stage: str = "color",
    fused: bool = False,
    grid_vjp: str = "halo",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage-dispatched scene query (ref: decoder.py:307-353).

    Args:
        params: decoder tree (init_df_decoders).
        p: (N, 3) world points.
        grids: {'grid_low', 'grid_high', 'grid_color'} channels-last grids.
        tsdf_volume: (X, Y, Z); tsdf_bnds, bound: (3, 2).
        stage: 'low' | 'high' | 'color'.
        fused: decoder MLPs through K2 (no-gradient paths only).
        grid_vjp: the feature grids' gradient variant; the TSDF prior's
            sampler does not depend on it.

    Returns:
        raw (N, 4) [rgb, occ], attention weight (N,).
    """
    n = p.shape[0]
    c_low = sample_feature_grid(grids["grid_low"], p, bound, grid_vjp)
    low_occ = _decoder_eval(params["low"], p, c_low, fused)
    if stage == "low":
        raw = torch.cat([torch.zeros((n, 3), dtype=low_occ.dtype, device=p.device), low_occ[:, None]], dim=-1)
        return raw, torch.ones((n,), dtype=low_occ.dtype, device=p.device)

    # the high decoder sees its own feature and a detached low feature
    # (ref: decoder.py:182-187); in the color stage the high and color grids
    # are sampled as one fused pair (one doubled-width scatter + fold) under
    # the fold variants, one by one under the others
    c_color = None
    if stage == "color":
        c_high, c_color = sample_feature_grid_pair(
            grids["grid_high"], grids["grid_color"], p, bound, grid_vjp
        )
    else:
        c_high = sample_feature_grid(grids["grid_high"], p, bound, grid_vjp)
    c_high = torch.cat([c_high, c_low.detach()], dim=-1)
    high_occ = _decoder_eval(params["high"], p, c_high, fused)
    f_add_m_occ = high_occ + low_occ

    tsdf_val = sample_tsdf(tsdf_volume, p, tsdf_bnds)
    # blend only where the TSDF is not saturated (ref: decoder.py:329-333)
    tsdf_mask = (tsdf_val > -1.0 + 1e-4) & (tsdf_val < 1.0 - 1e-4)
    inv_tsdf = tsdf_to_inv_occupancy(tsdf_val)
    blended, att_w = mlp_tsdf_forward(params["mlp"], f_add_m_occ, inv_tsdf)
    new_occ = torch.where(tsdf_mask, blended, low_occ)
    w = torch.where(tsdf_mask, att_w, torch.ones_like(att_w))

    if stage == "high":
        raw = torch.cat([torch.zeros((n, 3), dtype=new_occ.dtype, device=p.device), new_occ[:, None]], dim=-1)
        return raw, w

    rgb_occ = _decoder_eval(params["color"], p, c_color, fused)  # (N, 4)
    return torch.cat([rgb_occ[:, :3], new_occ[:, None]], dim=-1), w


def eval_points_chunk(params, pts, tsdf_volume, tsdf_bnds, bound, stage, fused=False):
    """One chunk of the point query: ``df_forward`` plus the reference's
    out-of-bound occ = 100 wall (ref: src/utils/Renderer.py:27-71). On the
    card it is the body of the point-query program that every chunk
    replays (``query_points``), as the JAX package jits it."""
    raw, _ = df_forward(params, pts, params, tsdf_volume, tsdf_bnds, bound, stage, fused=fused)
    inside = torch.all((pts > bound[:, 0]) & (pts < bound[:, 1]), dim=-1)
    occ = torch.where(inside, raw[:, 3], torch.full_like(raw[:, 3], 100.0))
    return torch.cat([raw[:, :3], occ[:, None]], dim=-1)


# the decoders each stage of ``df_forward`` reads
STAGE_DECODERS = {"low": ("low",), "high": ("low", "high"), "color": ("low", "high", "color")}


def stage_images(scene: Dict[str, Any], stage: str):
    """A program's static K2 weight images of the decoders of ``scene``
    that ``stage`` reads (``ops/cuda/decoder_kernel.py:StaticImages``)."""
    from attentive_dfprior_tpu_torch.ops.cuda.decoder_kernel import StaticImages

    return StaticImages([scene[name] for name in STAGE_DECODERS[stage]])


class _PointProgram:
    """One captured chunk of ``eval_points_chunk`` (no gradient): static
    points in, static raw (rgb, occ) out; with ``fused``, K2 reads the
    program's static weight images, refreshed before every run."""

    def __init__(self, graphs, scene, tsdf_volume, tsdf_bnds, bound, stage: str, batch: int, fused: bool):
        dev = tsdf_bnds.device
        self.pts = torch.zeros((batch, 3), dtype=torch.float32, device=dev)
        self.out = torch.empty((batch, 4), dtype=torch.float32, device=dev)
        self.images = stage_images(scene, stage) if fused else None

        def step():
            with torch.no_grad(), self.images.pinned() if fused else contextlib.nullcontext():
                self.out.copy_(eval_points_chunk(scene, self.pts, tsdf_volume, tsdf_bnds, bound, stage, fused=fused))

        self.graph = graphs.step_graph(step)

    def __call__(self, pts: torch.Tensor) -> torch.Tensor:
        m = pts.shape[0]
        self.pts[:m].copy_(pts)
        if m < self.pts.shape[0]:
            self.pts[m:].zero_()
        if self.images is not None:
            self.images.refresh()
        self.graph()
        return self.out


@torch.no_grad()
def query_points(graphs: ForwardGraphs, params, pts: torch.Tensor, tsdf_volume: torch.Tensor,
                 tsdf_bnds: torch.Tensor, bound: torch.Tensor, stage: str, batch: int, fused: bool) -> torch.Tensor:
    """The point query in chunks of ``batch`` points, the last chunk padded
    with zeros as the JAX package pads it: raw (N, 4) on the points'
    device, with the out-of-bound occ = 100 wall. Graphed (``graphs`` in
    ``graph`` mode), every chunk is a replay of one program of
    ``eval_points_chunk``; eager, each chunk runs in Python."""
    n = pts.shape[0]
    out = torch.empty((n, 4), dtype=torch.float32, device=pts.device)
    if n == 0:
        return out
    if graphs.graphed:
        scene = graphs.scene(params)
        key = ("points", stage, batch, fused, tensor_key(scene, tsdf_volume, tsdf_bnds, bound))
        run = graphs.program(key, lambda g: _PointProgram(g, scene, tsdf_volume, tsdf_bnds, bound, stage, batch,
                                                         fused))
    else:
        def run(chunk):
            return eval_points_chunk(params, pad_rows(chunk, batch, 0.0), tsdf_volume, tsdf_bnds, bound, stage,
                                     fused=fused)
    for i in range(0, n, batch):
        m = min(batch, n - i)
        out[i : i + m] = run(pts[i : i + m].contiguous())[:m]
    return out


def load_pretrained_npz(decoders: Dict[str, Any], path: str) -> Dict[str, Any]:
    """Load the shipped decoder prior (``pretrained/low_high.npz``, keys
    ``low000…`` / ``high000…`` in jax flatten order) into a decoder tree
    (tools/pretrain_decoders.py:load_pretrained_npz)."""
    data = np.load(path)
    out = dict(decoders)
    for name in ("low", "high"):
        n = len(tree_leaves(decoders[name]))
        leaves = [torch.as_tensor(np.array(data[f"{name}{i:03d}"], dtype=np.float32)) for i in range(n)]
        out[name] = tree_unflatten(decoders[name], leaves)
    return out


def load_pretrained_low_high(decoders: Dict[str, Any], ckpt_path: str) -> Optional[Dict[str, Any]]:
    """Load the reference's pretrained ConvONet low/high decoders
    (``pretrained/low_high.pt``, ref: src/DF_Prior.py:197-218); None when
    the file is absent. Torch stores Linear weights (out, in); the port's
    layout is (in, out)."""
    import os

    if not ckpt_path or not os.path.exists(ckpt_path):
        return None
    ckpt = torch.load(ckpt_path, map_location="cpu")
    low_sd: Dict[str, torch.Tensor] = {}
    high_sd: Dict[str, torch.Tensor] = {}
    for key, val in ckpt["model"].items():
        if "decoder" in key and "encoder" not in key:
            if "coarse" in key:
                low_sd[key[15:]] = val.detach().float()
            elif "fine" in key:
                high_sd[key[13:]] = val.detach().float()

    def apply_sd(dec: Dict[str, Any], sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        dec = {k: (list(v) if isinstance(v, list) else v) for k, v in dec.items()}
        if "embedder._B" in sd:
            dec["B"] = sd["embedder._B"].clone()
        for i in range(len(dec["pts"])):
            dec["pts"][i] = {"w": sd[f"pts_linears.{i}.weight"].T.contiguous(), "b": sd[f"pts_linears.{i}.bias"].clone()}
            dec["fc_c"][i] = {"w": sd[f"fc_c.{i}.weight"].T.contiguous(), "b": sd[f"fc_c.{i}.bias"].clone()}
        dec["out"] = {"w": sd["output_linear.weight"].T.contiguous(), "b": sd["output_linear.bias"].clone()}
        return dec

    out = dict(decoders)
    out["low"] = apply_sd(decoders["low"], low_sd)
    out["high"] = apply_sd(decoders["high"], high_sd)
    return out
