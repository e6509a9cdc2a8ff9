"""Differentiable ray-batch volume renderer.

The port of the JAX package's ``render/renderer.py`` (ref:
src/utils/Renderer.py:110-327): sample depths (stratified near->far plus a
surface band around the sensor depth), query the scene (``df_forward``),
and composite with sigmoid occupancy. With ``N_importance > 0`` a second
pass resamples each ray by the inverse CDF of the first pass's weights
(``ops/rays.py:sample_pdf``) and evaluates the resampled points, as the
JAX package does (the reference re-evaluates its old points there,
ref: Renderer.py:235-252); both shipped configs use ``N_importance: 0``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from attentive_dfprior_tpu_torch.models.decoders import df_forward, query_points, stage_images
from attentive_dfprior_tpu_torch.ops.compositing import raw2outputs
from attentive_dfprior_tpu_torch.ops.rays import get_rays_full_image, ray_bound_intersection, sample_pdf
from attentive_dfprior_tpu_torch.utils.profiling import span
from attentive_dfprior_tpu_torch.utils.step_graph import ForwardGraphs, pad_rows, tensor_key


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static rendering configuration (ref: configs/df_prior.yaml:93-98)."""

    N_samples: int = 32
    N_surface: int = 16
    N_importance: int = 0
    lindisp: bool = False
    perturb: float = 0.0
    occupancy: bool = True


def make_z_vals(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    gt_depth: torch.Tensor,
    bound: torch.Tensor,
    rcfg: RenderConfig,
    generator: Optional[torch.Generator] = None,
    no_gt_depth: bool = False,
    depth_max: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-ray sample depths, sorted (ref: Renderer.py:140-221).

      - near = 0.01 * gt_depth; far = clamp(bound exit + 0.01, 0,
        1.2 * max(gt_depth)); N_samples stratified in [near, far];
      - N_surface in [0.95 d, 1.05 d] for d > 0, uniform in
        [1e-3, max depth] for d == 0.
    With ``no_gt_depth``: near 0.01, far = bound exit, no surface band.
    Perturbation draws from ``generator`` (only when rcfg.perturb > 0).
    ``depth_max``: the batch's max depth, when these rays are one block of
    a larger batch (``parallel/sharding.py``); default the max of
    ``gt_depth``.

    Returns:
        (R, N_samples + N_surface) z values ((R, N_samples) without depth).
    """
    R = rays_o.shape[0]
    gt_depth = gt_depth.reshape(R)
    dt = rays_o.dtype
    far_bb = ray_bound_intersection(rays_o.detach(), rays_d.detach(), bound) + 0.01
    if no_gt_depth:
        far = far_bb[:, None]
        near = torch.full((R, 1), 0.01, dtype=dt, device=rays_o.device)
    else:
        max_depth = torch.max(gt_depth) if depth_max is None else depth_max
        far = torch.minimum(torch.clamp(far_bb, min=0.0), max_depth * 1.2)[:, None]
        near = (gt_depth * 0.01)[:, None]

    t = torch.linspace(0.0, 1.0, rcfg.N_samples, dtype=dt, device=rays_o.device)
    if not rcfg.lindisp:
        z_vals = near * (1.0 - t) + far * t
    else:
        z_vals = 1.0 / (1.0 / torch.clamp(near, min=1e-6) * (1.0 - t) + 1.0 / far * t)

    if rcfg.perturb > 0.0 and generator is not None:
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
        lower = torch.cat([z_vals[..., :1], mids], dim=-1)
        t_rand = torch.rand(z_vals.shape, generator=generator, dtype=dt, device=rays_o.device)
        z_vals = lower + (upper - lower) * t_rand

    if rcfg.N_surface > 0 and not no_gt_depth:
        ts = torch.linspace(0.0, 1.0, rcfg.N_surface, dtype=dt, device=rays_o.device)
        d = gt_depth[:, None]
        z_surf_pos = 0.95 * d * (1.0 - ts) + 1.05 * d * ts
        z_surf_zero = 0.001 * (1.0 - ts) + max_depth * ts
        z_surf = torch.where(d > 0, z_surf_pos, z_surf_zero[None, :])
        z_vals = torch.sort(torch.cat([z_vals, z_surf], dim=-1), dim=-1).values
    return z_vals


def render_rays(
    params: Dict[str, Any],
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    gt_depth: torch.Tensor,
    tsdf_volume: torch.Tensor,
    tsdf_bnds: torch.Tensor,
    bound: torch.Tensor,
    stage: str,
    rcfg: RenderConfig,
    generator: Optional[torch.Generator] = None,
    fused: bool = False,
    no_gt_depth: bool = False,
    grid_vjp: str = "halo",
    depth_max: Optional[torch.Tensor] = None,
    importance_u: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Render a batch of rays (ref: Renderer.py:110-255).

    Args:
        params: scene tree (grids + decoders).
        rays_o / rays_d: (R, 3); gt_depth: (R,) sensor depth (0 = none).
        stage: 'low' | 'high' | 'color'.
        generator: the perturbation's draws, and the importance samples'
            when ``perturb > 0`` (a generator seeded 0 when None).
        fused: decoder MLPs through K2 (no-gradient paths only).
        no_gt_depth: render without sensor depth (``gt_depth`` ignored).
        grid_vjp: the feature grids' gradient variant (``df_forward``).
        depth_max: as in ``make_z_vals``.
        importance_u: (R, N_importance) uniforms of the importance samples
            when ``perturb > 0`` (default: drawn from ``generator``).

    Returns:
        depth (R,), depth_var (R,), color (R, 3), att_weight (R, S) with
        S = N_samples + N_surface (+ N_importance).
    """
    z_vals = make_z_vals(rays_o, rays_d, gt_depth, bound, rcfg, generator, no_gt_depth, depth_max)
    raw, att_w = _query(params, rays_o, rays_d, z_vals, tsdf_volume, tsdf_bnds, bound, stage, fused, grid_vjp)
    depth, depth_var, color, weights = raw2outputs(raw, z_vals, rays_d, occupancy=rcfg.occupancy)
    if rcfg.N_importance > 0:
        # resample by the first pass's weights and evaluate the resampled
        # points (ref: Renderer.py:235-252; the JAX package's
        # render/renderer.py:159-184)
        z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        det = rcfg.perturb == 0.0
        if not det and generator is None and importance_u is None:
            generator = torch.Generator(device=rays_o.device).manual_seed(0)
        z_samples = sample_pdf(z_mid, weights[..., 1:-1], rcfg.N_importance, det, generator, importance_u).detach()
        z_all = torch.sort(torch.cat([z_vals, z_samples], dim=-1), dim=-1).values
        raw, att_w = _query(params, rays_o, rays_d, z_all, tsdf_volume, tsdf_bnds, bound, stage, fused, grid_vjp)
        depth, depth_var, color, _ = raw2outputs(raw, z_all, rays_d, occupancy=rcfg.occupancy)
    return depth, depth_var, color, att_w


def _query(params, rays_o, rays_d, z_vals, tsdf_volume, tsdf_bnds, bound, stage, fused, grid_vjp):
    """The scene at the (R, S) depths ``z_vals`` along the rays: raw (R, S,
    4) with the out-of-bound occupancy at 100, an opaque wall at the bound
    (ref: Renderer.py:49-64), and the attention weights (R, S)."""
    R, S = z_vals.shape
    flat = (rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]).reshape(-1, 3)
    raw, att_w = df_forward(
        params, flat, params, tsdf_volume, tsdf_bnds, bound, stage=stage, fused=fused,
        grid_vjp=grid_vjp,
    )
    inside = torch.all((flat > bound[:, 0]) & (flat < bound[:, 1]), dim=-1)
    occ = torch.where(inside, raw[:, 3], torch.full_like(raw[:, 3], 100.0))
    raw = torch.cat([raw[:, :3], occ[:, None]], dim=-1).reshape(R, S, 4)
    return raw, att_w.reshape(R, S)


class _RenderProgram:
    """One captured chunk of ``render_rays`` (no gradient): static rays,
    sensor depth and batch max depth in, static depth, variance, colour and
    attention weights out. With ``fused``, K2 reads the program's static
    weight images, refreshed before every run. With ``perturb > 0`` and
    ``N_importance > 0`` the importance samples' uniforms are drawn once,
    outside the capture, from a generator seeded 0: the draw that the eager
    render and the JAX package take on every call."""

    def __init__(self, graphs, scene, renderer: "Renderer", tsdf_volume, stage: str, no_gt: bool, fused: bool):
        rcfg, bs, dev = renderer.rcfg, renderer.ray_batch_size, renderer.device
        self.ro = torch.ones((bs, 3), dtype=torch.float32, device=dev)
        self.rd = torch.ones((bs, 3), dtype=torch.float32, device=dev)
        self.gd = torch.zeros((bs,), dtype=torch.float32, device=dev)
        self.dmax = torch.zeros((), dtype=torch.float32, device=dev)
        samples = rcfg.N_samples + (0 if no_gt else rcfg.N_surface) + rcfg.N_importance
        self.outs = (torch.empty((bs,), dtype=torch.float32, device=dev),
                     torch.empty((bs,), dtype=torch.float32, device=dev),
                     torch.empty((bs, 3), dtype=torch.float32, device=dev),
                     torch.empty((bs, samples), dtype=torch.float32, device=dev))
        self.images = stage_images(scene, stage) if fused else None
        u = None
        if rcfg.N_importance > 0 and rcfg.perturb > 0.0:
            u = torch.rand((bs, rcfg.N_importance), generator=torch.Generator(device=dev).manual_seed(0),
                           dtype=torch.float32, device=dev)
        tsdf_bnds, bound = renderer.tsdf_bnds, renderer.bound

        def step():
            with torch.no_grad(), self.images.pinned() if fused else contextlib.nullcontext():
                res = render_rays(scene, self.ro, self.rd, self.gd, tsdf_volume, tsdf_bnds, bound, stage, rcfg,
                                  fused=fused, no_gt_depth=no_gt, depth_max=None if no_gt else self.dmax,
                                  importance_u=u)
                for out, r in zip(self.outs, res):
                    out.copy_(r)

        self.graph = graphs.step_graph(step)

    def __call__(self, ro, rd, gd, depth_max):
        """One chunk of m <= ray_batch_size rays: the tail padded as the JAX
        package pads it (rays 1.0, depth 0); the outputs are the static
        buffers, valid until the next call."""
        m = ro.shape[0]
        self.ro[:m].copy_(ro)
        self.rd[:m].copy_(rd)
        self.gd[:m].copy_(gd)
        if m < self.gd.shape[0]:
            self.ro[m:].fill_(1.0)
            self.rd[m:].fill_(1.0)
            self.gd[m:].zero_()
        self.dmax.copy_(torch.amax(self.gd) if depth_max is None else depth_max)
        if self.images is not None:
            self.images.refresh()
        self.graph()
        return self.outs


class Renderer:
    """No-gradient renderer for full views and point queries (ref: the
    reference Renderer's render_batch_ray / render_img surface).

    On CUDA (``use_fused``) the decoder MLPs run through K2; on the CPU the
    plain MLP runs. Rays and points go in chunks of a static size, the last
    chunk padded as the JAX package pads it (the padding leaves each real
    ray's result as it was). ``graphs`` (``utils/step_graph.py:
    ForwardGraphs``, by default one in the device's default mode): in
    ``graph`` mode, the default on the card, every chunk of ``render_img``,
    ``render_batch_ray`` and ``eval_points`` replays one captured program;
    in ``eager`` mode (``--eager``) each chunk runs in Python.
    """

    def __init__(
        self,
        rcfg: RenderConfig,
        bound: np.ndarray,
        tsdf_bnds: np.ndarray,
        cam,
        device: torch.device,
        ray_batch_size: int = 10000,
        graphs: Optional[ForwardGraphs] = None,
    ):
        self.rcfg = rcfg
        self.device = torch.device(device)
        self.bound = torch.as_tensor(np.asarray(bound), dtype=torch.float32, device=self.device)
        self.tsdf_bnds = torch.as_tensor(np.asarray(tsdf_bnds), dtype=torch.float32, device=self.device)
        self.cam = cam
        self.ray_batch_size = ray_batch_size
        self.use_fused = self.device.type == "cuda"
        self.graphs = graphs if graphs is not None else ForwardGraphs(None, self.device)

    @torch.no_grad()
    def eval_points(self, params, p, tsdf_volume, stage: str = "color") -> np.ndarray:
        """Chunked point query, raw (N, 4) with the out-of-bound occ = 100
        wall (ref: Renderer.py:27-71)."""
        p = torch.as_tensor(np.asarray(p, dtype=np.float32), device=self.device)
        return query_points(self.graphs, params, p, tsdf_volume, self.tsdf_bnds, self.bound, stage, 2**17,
                            self.use_fused).cpu().numpy()

    def _chunk_fn(self, params, tsdf_volume, stage: str, no_gt: bool):
        """(ro, rd, gd, depth_max) -> (depth, var, colour, att_w) of one
        chunk of at most ``ray_batch_size`` rays, padded to that size (rows
        past the chunk's are padding): a program's replay when graphed, else
        ``render_rays``."""
        fused, bs = self.use_fused, self.ray_batch_size
        if self.graphs.graphed:
            scene = self.graphs.scene(params)
            key = ("render", stage, no_gt, self.rcfg, bs, fused,
                   tensor_key(scene, tsdf_volume, self.tsdf_bnds, self.bound))
            return self.graphs.program(key, lambda g: _RenderProgram(g, scene, self, tsdf_volume, stage, no_gt, fused))

        def run(ro, rd, gd, depth_max):
            return render_rays(params, pad_rows(ro, bs, 1.0), pad_rows(rd, bs, 1.0), pad_rows(gd, bs, 0.0),
                               tsdf_volume, self.tsdf_bnds, self.bound, stage, self.rcfg, fused=fused,
                               no_gt_depth=no_gt, depth_max=depth_max)

        return run

    def _render(self, params, rays_o, rays_d, gt, tsdf_volume, stage: str, no_gt: bool, depth_max, outputs: int):
        """Rays in chunks of ``ray_batch_size``: the first ``outputs`` of
        (depth, var, colour, att_w), each chunk's max depth ``depth_max``
        (None: the chunk's own)."""
        n = rays_o.shape[0]
        run = self._chunk_fn(params, tsdf_volume, stage, no_gt)
        outs = None
        for i in range(0, n, self.ray_batch_size):
            with span("Renderer.chunk", chunk=i // self.ray_batch_size):
                m = min(self.ray_batch_size, n - i)
                res = run(rays_o[i : i + m].contiguous(), rays_d[i : i + m].contiguous(), gt[i : i + m], depth_max)
                if outs is None:
                    outs = [torch.empty((n,) + tuple(r.shape[1:]), dtype=r.dtype, device=r.device)
                            for r in res[:outputs]]
                for out, r in zip(outs, res):
                    out[i : i + m] = r[:m]
        return outs

    @torch.no_grad()
    def render_batch_ray(self, params, rays_o, rays_d, gt_depth, tsdf_volume, stage: str):
        """(ref: Renderer.py:110-255); gt_depth None selects the depth-free
        sampling branch. In chunks of ``ray_batch_size`` rays that all take
        the batch's max depth, so each ray's result is that of one call on
        the whole batch."""
        ro = torch.as_tensor(rays_o, dtype=torch.float32, device=self.device)
        rd = torch.as_tensor(rays_d, dtype=torch.float32, device=self.device)
        no_gt = gt_depth is None
        gd = (
            torch.zeros((ro.shape[0],), dtype=torch.float32, device=self.device)
            if no_gt
            else torch.as_tensor(gt_depth, dtype=torch.float32, device=self.device)
        )
        return tuple(self._render(params, ro, rd, gd, tsdf_volume, stage, no_gt,
                                  None if no_gt else torch.max(gd), 4))

    @torch.no_grad()
    def render_img(self, params, c2w, tsdf_volume, stage: str = "color", gt_depth=None):
        """Full depth / variance / color images, rendered in chunks of
        ``ray_batch_size`` rays (ref: Renderer.py:258-327).

        With sensor depth, the far plane of every chunk is 1.2 x the
        largest depth of that chunk, as in the JAX package, whose last
        chunk is padded with zero depth.

        Returns:
            depth (H, W), depth_var (H, W), color (H, W, 3) tensors.
        """
        with span("Renderer.render_img"):
            cam = self.cam
            c2w_t = torch.as_tensor(np.array(c2w, dtype=np.float32), device=self.device)
            rays_o, rays_d = get_rays_full_image(cam.H, cam.W, cam.fx, cam.fy, cam.cx, cam.cy, c2w_t)
            rays_o = rays_o.reshape(-1, 3)
            rays_d = rays_d.reshape(-1, 3)
            n = rays_o.shape[0]
            no_gt = gt_depth is None
            gt = (
                torch.zeros((n,), dtype=torch.float32, device=self.device)
                if no_gt
                else torch.as_tensor(np.asarray(gt_depth), dtype=torch.float32, device=self.device).reshape(-1)
            )
            depth, unc, color = self._render(params, rays_o, rays_d, gt, tsdf_volume, stage, no_gt, None, 3)
            return depth.reshape(cam.H, cam.W), unc.reshape(cam.H, cam.W), color.reshape(cam.H, cam.W, 3)
