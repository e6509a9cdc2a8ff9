"""Importance resampling (``rendering.N_importance > 0``) in the port against
the JAX package, on the CPU.

``sample_pdf`` with ``det`` true and false (the random branch fed the same
``u`` in both packages), then ``render_rays`` and ``Renderer.render_img``
with ``N_importance = 8``, whose second pass evaluates the resampled
points.

Tolerances: ``sample_pdf`` rtol 1e-6 / atol 1e-6 (the same float32
formulas; ``u`` = 0 or 1 may land in either end bin after cumsum's
rounding, which moves the index but not the sample), widened per sample by
its sensitivity to the CDF: the two packages sum the pdf and its cumsum in
other orders (XLA's ``reduce_window`` against torch's vectorized cumsum,
a few ulps apart), and a sample in a bin of CDF width ``denom`` moves by
``bin width / denom`` times that difference; the bound allows 4 ulps of
1.0 and at least 95 % of the samples must meet the plain tolerance. Rendered depth and
colour rtol 1e-4 / atol 1e-5 and the scene and pose gradients rtol 1e-3,
as tests/test_torch_ops.py holds the one-pass render.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attentive_dfprior_tpu.camera import Camera as JCamera
from attentive_dfprior_tpu.models.decoders import init_df_decoders
from attentive_dfprior_tpu.ops import pose as JP
from attentive_dfprior_tpu.ops import rays as JR
from attentive_dfprior_tpu.ops.grid_sample import tsdf_to_rows
from attentive_dfprior_tpu.render import renderer as JRen
from attentive_dfprior_tpu_torch.camera import Camera
from attentive_dfprior_tpu_torch.models.scene import params_from_numpy
from attentive_dfprior_tpu_torch.ops import pose as TP
from attentive_dfprior_tpu_torch.ops import rays as TR
from attentive_dfprior_tpu_torch.render import renderer as TRen
from attentive_dfprior_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(1)
TOL = dict(rtol=1e-6, atol=1e-6)
N_IMP = 8


def _pdf_inputs(seed=0, B=64, M=23):
    """Sorted bin edges (B, M) and weights (B, M - 1): peaked rows, flat
    rows and all-zero rows (the 1e-5 floor alone)."""
    rng = np.random.default_rng(seed)
    bins = np.sort(rng.uniform(0.1, 4.0, (B, M)), axis=-1).astype(np.float32)
    w = rng.exponential(1.0, (B, M - 1)).astype(np.float32)
    w[::4] = 0.0
    w[1::4, 5] = 50.0
    w[2::4] = 1.0
    return bins, w


def assert_samples_close(got, ref, bins, w, u):
    """``got`` within TOL of ``ref``, plus 4 ulps of the CDF times each
    sample's sensitivity to it (float64 bin width over CDF width, the
    denominator floored at 1e-5 as sample_pdf floors it); at least 95 % of
    the samples within TOL alone."""
    w64 = w.astype(np.float64) + 1e-5
    cdf = np.concatenate([np.zeros_like(w64[:, :1]), np.cumsum(w64 / w64.sum(-1, keepdims=True), -1)], -1)
    inds = np.stack([np.searchsorted(c, uu, side="right") for c, uu in zip(cdf, u.astype(np.float64))])
    below = np.maximum(inds - 1, 0)
    above = np.minimum(inds, cdf.shape[-1] - 1)
    denom = np.take_along_axis(cdf, above, -1) - np.take_along_axis(cdf, below, -1)
    width = np.take_along_axis(bins.astype(np.float64), above, -1) - np.take_along_axis(bins.astype(np.float64), below, -1)
    sens = width / np.maximum(denom, 1e-5)
    err = np.abs(got - ref)
    plain = TOL["atol"] + TOL["rtol"] * np.abs(ref)
    assert np.all(err <= plain + 4 * np.finfo(np.float32).eps * sens), float((err - plain).max())
    assert np.mean(err <= plain) >= 0.95, float(np.mean(err <= plain))


def test_sample_pdf_det_matches_jax():
    bins, w = _pdf_inputs(1)
    ref = JR.sample_pdf(jax.random.PRNGKey(0), jnp.asarray(bins), jnp.asarray(w), 16, det=True)
    got = TR.sample_pdf(torch.tensor(bins), torch.tensor(w), 16, det=True)
    assert got.shape == (64, 16)
    u = np.broadcast_to(np.linspace(0.0, 1.0, 16, dtype=np.float32), (64, 16))
    assert_samples_close(got.numpy(), np.asarray(ref), bins, w, u)


def test_sample_pdf_random_matches_jax(monkeypatch):
    """det=False: the port draws ``u`` from its generator; the JAX side is
    fed the same ``u`` through ``jax.random.uniform``, patched in this test
    only. (``u`` on the CDF's ends, 0 and 1, is the det branch's.)"""
    bins, w = _pdf_inputs(2)
    u = torch.rand((64, 12), generator=torch.Generator().manual_seed(3))
    seen = []

    def fake_uniform(key, shape, dtype=jnp.float32, *a, **k):
        seen.append(tuple(shape))
        return jnp.asarray(u.numpy(), dtype=dtype)

    monkeypatch.setattr(JR.jax.random, "uniform", fake_uniform)
    ref = JR.sample_pdf(jax.random.PRNGKey(0), jnp.asarray(bins), jnp.asarray(w), 12, det=False)
    monkeypatch.undo()
    assert seen == [(64, 12)]
    got = TR.sample_pdf(torch.tensor(bins), torch.tensor(w), 12, det=False,
                        generator=torch.Generator().manual_seed(3))
    assert_samples_close(got.numpy(), np.asarray(ref), bins, w, u.numpy())
    assert torch.all(got >= torch.tensor(bins[:, :1])) and torch.all(got <= torch.tensor(bins[:, -1:]))


def _scene(seed=5):
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(np.asarray, init_df_decoders(jax.random.PRNGKey(seed)))
    params["grid_low"] = (rng.standard_normal((14, 11, 14, 32)) * 0.1).astype(np.float32)
    params["grid_high"] = (rng.standard_normal((28, 22, 28, 32)) * 0.1).astype(np.float32)
    params["grid_color"] = (rng.standard_normal((28, 22, 28, 32)) * 0.1).astype(np.float32)
    bound = np.array([[-2.2, 2.28], [-1.7, 1.82], [-2.2, 2.28]], np.float32)
    tsdf = np.clip(rng.normal(0.3, 0.6, (20, 16, 20)), -1, 1).astype(np.float32)
    return params, bound, tsdf


@pytest.mark.parametrize("stage", ["color", "high"])
def test_render_rays_importance_matches_jax(stage):
    """Rays from a differentiable pose, rendered with 8 + 4 samples and 8
    resampled ones (some rays without depth): depth, colour and variance,
    then the gradients of every scene leaf and of the 7-DoF pose."""
    params, bound, tsdf = _scene()
    cam_t = np.array([0.9, 0.1, 0.3, -0.2, 0.4, -0.3, 0.6], np.float32)
    rng = np.random.default_rng(7)
    i = rng.uniform(0, 32, 48).astype(np.float32)
    j = rng.uniform(0, 24, 48).astype(np.float32)
    gd = rng.uniform(0.5, 2.5, 48).astype(np.float32)
    gd[:6] = 0.0
    jcfg = JRen.RenderConfig(N_samples=8, N_surface=4, N_importance=N_IMP)
    tcfg = TRen.RenderConfig(N_samples=8, N_surface=4, N_importance=N_IMP)

    def jfn(ct, jp):
        o, d = JR.get_rays_from_uv(jnp.asarray(i), jnp.asarray(j), JP.pose_matrix_from_tensor(ct), 24.0, 24.0, 15.5, 11.5)
        dep, var, col, _ = JRen.render_rays(jp, o, d, jnp.asarray(gd), tsdf_to_rows(tsdf), jnp.asarray(bound),
                                              jnp.asarray(bound), stage, jcfg)
        return jnp.sum(dep) + jnp.sum(col) + 0.1 * jnp.sum(var), (dep, var, col)

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    (_, (jdep, jvar, jcol)), (jg_cam, jg_scene) = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(cam_t), jp)

    ct = torch.tensor(cam_t, requires_grad=True)
    tp = params_from_numpy(params)
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    o, d = TR.get_rays_from_uv(torch.tensor(i), torch.tensor(j), TP.pose_matrix_from_tensor(ct), 24.0, 24.0, 15.5, 11.5)
    dep, var, col, att = TRen.render_rays(tp, o, d, torch.tensor(gd), torch.tensor(tsdf), torch.tensor(bound),
                                          torch.tensor(bound), stage, tcfg)
    assert att.shape == (48, 8 + 4 + N_IMP)
    loss = dep.sum() + col.sum() + 0.1 * var.sum()
    grads = torch.autograd.grad(loss, [ct] + leaves, allow_unused=True)
    # the per-sample attention weights at resampled points inherit
    # sample_pdf's conditioning (a sample in a near-empty bin moves with
    # the CDF's last ulps); the composited depth, colour and variance do not
    for a, b in ((dep, jdep), (col, jcol), (var, jvar)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)
    jg = np.asarray(jg_cam)
    np.testing.assert_allclose(grads[0].numpy(), jg, rtol=1e-3, atol=1e-4 * float(np.abs(jg).max()))
    n_checked = 0
    for g, r in zip(grads[1:], jax.tree_util.tree_leaves(jg_scene)):
        r = np.asarray(r)
        if g is None:
            assert not r.any(), "a leaf the port leaves out of the graph has a JAX gradient"
            continue
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-3, atol=1e-4 * max(float(np.abs(r).max()), 1e-12))
        n_checked += int(np.abs(r).max() > 0)
    assert n_checked >= 10  # grids, decoders and the attention MLP


def test_render_img_importance_matches_jax():
    """``Renderer.render_img`` (chunks of 64 rays, sensor depth given) with
    8 resampled points a ray; the tracker and the Visualizers reach the
    importance block through the same ``render_rays``."""
    params, bound, tsdf = _scene(8)
    cam = dict(H=10, W=14, fx=12.0, fy=12.0, cx=6.5, cy=4.5)
    c2w = np.asarray(JP.homogenize(JP.pose_matrix_from_tensor(jnp.asarray(
        np.array([1.0, 0.0, 0.0, 0.0, 0.2, -0.1, 0.4], np.float32)))))
    depth = np.random.default_rng(9).uniform(0.5, 2.0, (10, 14)).astype(np.float32)
    jr = JRen.Renderer(JRen.RenderConfig(N_importance=N_IMP), bound, bound, JCamera(**cam), ray_batch_size=64,
                       use_fused=False)
    ref = jr.render_img(jax.tree_util.tree_map(jnp.asarray, params), c2w, tsdf_to_rows(tsdf), gt_depth=depth)
    tr = TRen.Renderer(TRen.RenderConfig(N_importance=N_IMP), bound, bound, Camera(**cam), torch.device("cpu"),
                       ray_batch_size=64)
    got = tr.render_img(params_from_numpy(params), c2w, torch.tensor(tsdf), gt_depth=depth)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)
    # the resampled pass changes the render
    one_pass = TRen.Renderer(TRen.RenderConfig(), bound, bound, Camera(**cam), torch.device("cpu"), ray_batch_size=64)
    d1 = one_pass.render_img(params_from_numpy(params), c2w, torch.tensor(tsdf), gt_depth=depth)[0]
    assert not torch.allclose(d1, got[0])
