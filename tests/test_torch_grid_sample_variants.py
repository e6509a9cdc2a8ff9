"""Every grid-gradient variant of the port against the JAX package, on the
CPU (K1 and K3 run their plain versions; the JAX Pallas kernels run in
interpret mode, as the JAX package's own tests run them).

(a) each variant (``impl``) against the JAX function of the same name:
    forward bit-exact; grid and point gradients at rtol 1e-5 and atol
    1e-6 x the largest entry (a point gradient sums 8C terms per grid, and
    where they cancel only the absolute roundoff is left), on interior,
    border-clamped (|p| > 1), exact-corner and duplicate-heavy points.
    ``sorted`` takes each voxel's sum as a difference of two running
    cumulative sums, which XLA and torch accumulate in other orders: its
    roundoff scales with the running total, so its grid gradient is held at
    atol 1e-5 x the largest entry.
(b) ``cell_stencil_plain`` (K3's plain version) bit-exact against
    ``cell_stencil_pallas(..., interpret=True)`` at nx above 8 and not a
    multiple of 8 and at nx, ny or nz = 1; K3 against K1 at rtol 1e-5 (the
    two sum the same terms in other orders).
(c) world-coordinate dispatch: ``sample_feature_grid`` and
    ``sample_feature_grid_pair`` with ``impl`` against the JAX functions
    under ``DFPRIOR_TRILINEAR_VJP``; the pair falls back to per-grid
    sampling for every variant but ``halo`` and ``bitfold``, so under
    ``pallas`` K3 runs at C = 32 on the low, high and color grids.
(d) one ``Mapper.optimize_map`` (stages low, high and color) under
    ``grid_vjp="pallas"`` and one with the non-lazy Adam, against the JAX
    mapper under ``DFPRIOR_TRILINEAR_VJP=pallas`` / ``DFPRIOR_ADAM_LAZY=0``,
    at the tolerances of tests/test_torch_slam.py (losses rtol 1e-4).
    The JAX mapper reads both switches when it traces, so the jit caches
    are cleared around each run.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attentive_dfprior_tpu.ops import grid_sample as J
from attentive_dfprior_tpu.ops.pallas.stencil_kernel import cell_stencil_pallas as j_cell_stencil_pallas
from attentive_dfprior_tpu_torch.ops import grid_sample as T
from attentive_dfprior_tpu_torch.ops.cuda.halo_fold_kernel import cell_fold_plain
from attentive_dfprior_tpu_torch.ops.cuda.stencil_kernel import cell_stencil, cell_stencil_plain
from test_torch_slam import assert_params_close, mapping_draws, setup  # noqa: F401 (setup is a fixture)

torch.set_num_threads(1)

JAX_SAMPLERS = {
    "halo": J.trilinear_sample_halo,
    "bitfold": J.trilinear_sample_bf,
    "cellstencil": J.trilinear_sample_cs,
    "xla": J.trilinear_sample,
    "sorted": J.trilinear_sample_opt,
    "pallas": J.trilinear_sample_psc,
}


def _points(rng, n=300):
    """Interior, out-of-bound (border-clamped), exact-corner and a tight
    duplicate-heavy cluster of points in normalized coordinates."""
    return np.concatenate([
        rng.uniform(-0.95, 0.95, (n, 3)),
        rng.uniform(-1.6, 1.6, (n // 2, 3)),
        np.array([[1.0, 1.0, 1.0], [-1.0, -1.0, -1.0], [1.0, -1.0, 1.0], [-1.0, 0.0, 1.0]]),
        0.1 + 0.01 * rng.uniform(-1, 1, (n // 2, 3)),
    ]).astype(np.float32)


def _assert_close(got, ref, atol_frac=1e-6):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=atol_frac * max(1.0, float(np.abs(ref).max())))


def test_variant_names_cover_the_jax_dispatch():
    assert set(T.GRID_VJPS) == set(JAX_SAMPLERS)
    with pytest.raises(ValueError):
        T.grid_sampler("no_such_variant")


@pytest.mark.parametrize("impl", T.GRID_VJPS)
@pytest.mark.parametrize("shape", [(11, 5, 7, 3), (13, 6, 5, 32)])
def test_variant_matches_jax(impl, shape):
    rng = np.random.default_rng(sum(shape))
    grid = rng.standard_normal(shape).astype(np.float32)
    p = _points(rng)
    cot = rng.standard_normal((len(p), shape[-1])).astype(np.float32)
    jf = JAX_SAMPLERS[impl]
    ref = np.asarray(jf(jnp.asarray(grid), jnp.asarray(p)))
    gj, pj = jax.grad(lambda g, q: jnp.sum(jf(g, q) * cot), argnums=(0, 1))(jnp.asarray(grid), jnp.asarray(p))
    g = torch.tensor(grid, requires_grad=True)
    q = torch.tensor(p, requires_grad=True)
    out = T.grid_sampler(impl)(g, q)
    np.testing.assert_array_equal(out.detach().numpy(), ref)
    (out * torch.tensor(cot)).sum().backward()
    _assert_close(g.grad.numpy(), gj, 1e-5 if impl == "sorted" else 1e-6)
    _assert_close(q.grad.numpy(), pj)


@pytest.mark.parametrize("impl", ["cellstencil", "pallas", "sorted", "bitfold"])
def test_variant_computes_only_the_needed_gradient(impl):
    """Grid detached (the tracker): no grid gradient is formed and the point
    gradient equals the one taken with the grid gradient."""
    rng = np.random.default_rng(4)
    grid = torch.tensor(rng.standard_normal((10, 6, 5, 4)).astype(np.float32))
    p = torch.tensor(_points(rng), requires_grad=True)
    T.grid_sampler(impl)(grid, p).sum().backward()
    g2 = grid.clone().requires_grad_(True)
    p2 = p.detach().clone().requires_grad_(True)
    T.grid_sampler(impl)(g2, p2).sum().backward()
    np.testing.assert_array_equal(p.grad.numpy(), p2.grad.numpy())
    g3 = grid.clone().requires_grad_(True)
    T.grid_sampler(impl)(g3, p.detach()).sum().backward()
    np.testing.assert_array_equal(g3.grad.numpy(), g2.grad.numpy())


def test_zpair_sampler_matches_jax():
    rng = np.random.default_rng(6)
    grid = rng.standard_normal((9, 7, 6, 32)).astype(np.float32)
    p = _points(rng)
    ref = np.asarray(J.trilinear_sample_zpair(jnp.asarray(grid), jnp.asarray(p)))
    np.testing.assert_array_equal(T.trilinear_sample_zpair(torch.tensor(grid), torch.tensor(p)).numpy(), ref)
    np.testing.assert_array_equal(
        T._build_zpair(torch.tensor(grid)).numpy(), np.asarray(J._build_zpair(jnp.asarray(grid)))
    )


def test_corner_indices_weights_match_jax():
    rng = np.random.default_rng(7)
    p = _points(rng)
    ids_j, w_j = J._corner_indices_weights((11, 5, 7, 3), jnp.asarray(p))
    ids, w = T._corner_indices_weights((11, 5, 7, 3), torch.tensor(p))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
    np.testing.assert_array_equal(w.numpy(), np.asarray(w_j))


@pytest.mark.parametrize("shape", [(11, 5, 7, 32), (17, 4, 3, 3), (1, 6, 5, 32), (9, 1, 4, 32), (10, 4, 1, 32)])
def test_cell_stencil_plain_matches_jax_pallas_bit_exact(shape):
    nx, ny, nz, C = shape
    rng = np.random.default_rng(nx * ny * C)
    cells = rng.standard_normal((nx * ny * nz, 8 * C)).astype(np.float32)
    ref = np.asarray(j_cell_stencil_pallas(jnp.asarray(cells), shape, interpret=True))
    np.testing.assert_array_equal(cell_stencil_plain(shape, torch.tensor(cells)).numpy(), ref)
    np.testing.assert_array_equal(cell_stencil(torch.tensor(cells), shape).numpy(), ref)


@pytest.mark.parametrize("shape", [(11, 5, 7, 32), (14, 11, 14, 32)])
def test_cell_stencil_agrees_with_the_halo_fold(shape):
    """K3 and K1 sum the same eight terms in other orders."""
    nx, ny, nz, C = shape
    cells = torch.tensor(np.random.default_rng(nz).standard_normal((nx * ny * nz, 8 * C)).astype(np.float32))
    np.testing.assert_allclose(
        cell_stencil_plain(shape, cells).numpy(), cell_fold_plain(shape, cells).numpy(), rtol=1e-5, atol=1e-6
    )


def test_cell_stencil_rejects_non_cpu_non_cuda():
    cells = torch.zeros((4 * 8,), device="meta").reshape(4, 8)
    with pytest.raises(ValueError):
        cell_stencil(cells, (2, 2, 1, 1))


def _world_inputs(rng, shape):
    ga = rng.standard_normal(shape).astype(np.float32)
    gb = rng.standard_normal(shape).astype(np.float32)
    bound = np.array([[-2.2, 2.28], [-1.7, 1.82], [-2.2, 2.28]], np.float32)
    p = rng.uniform(-2.6, 2.6, (500, 3)).astype(np.float32)
    ca = rng.standard_normal((len(p), shape[-1])).astype(np.float32)
    cb = rng.standard_normal((len(p), shape[-1])).astype(np.float32)
    return ga, gb, bound, p, ca, cb


@pytest.mark.parametrize("impl", T.GRID_VJPS)
def test_world_dispatch_matches_jax_env_switch(impl, monkeypatch):
    """sample_feature_grid / sample_feature_grid_pair with ``impl`` against
    the JAX package under DFPRIOR_TRILINEAR_VJP=impl (read when jax.grad
    traces the un-jitted samplers)."""
    monkeypatch.setenv("DFPRIOR_TRILINEAR_VJP", impl)
    rng = np.random.default_rng(11)
    ga, gb, bound, p, ca, cb = _world_inputs(rng, (12, 9, 10, 32))

    def jloss(a, b, q):
        fa, fb = J.sample_feature_grid_pair(a, b, q, jnp.asarray(bound))
        fs = J.sample_feature_grid(a, q, jnp.asarray(bound))
        return jnp.sum(fa * ca) + jnp.sum(fb * cb) + jnp.sum(fs * cb)

    ja, jb, jp = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(ga), jnp.asarray(gb), jnp.asarray(p))
    a = torch.tensor(ga, requires_grad=True)
    b = torch.tensor(gb, requires_grad=True)
    q = torch.tensor(p, requires_grad=True)
    tb = torch.tensor(bound)
    fa, fb = T.sample_feature_grid_pair(a, b, q, tb, impl)
    fs = T.sample_feature_grid(a, q, tb, impl)
    ((fa * torch.tensor(ca)).sum() + (fb * torch.tensor(cb)).sum() + (fs * torch.tensor(cb)).sum()).backward()
    atol_frac = 1e-5 if impl == "sorted" else 1e-6
    _assert_close(a.grad.numpy(), ja, atol_frac)
    _assert_close(b.grad.numpy(), jb, atol_frac)
    _assert_close(q.grad.numpy(), jp)


@pytest.mark.parametrize("impl", ["pallas", "cellstencil", "xla", "sorted"])
def test_pair_falls_back_to_per_grid_sampling(impl):
    """Outside the fold variants the pair is two single samplers: the same
    values and gradients as two sample_feature_grid calls, no fused node."""
    rng = np.random.default_rng(12)
    ga, gb, bound, p, ca, cb = _world_inputs(rng, (8, 7, 6, 32))
    tb = torch.tensor(bound)

    def run(pair: bool):
        a = torch.tensor(ga, requires_grad=True)
        b = torch.tensor(gb, requires_grad=True)
        q = torch.tensor(p, requires_grad=True)
        if pair:
            fa, fb = T.sample_feature_grid_pair(a, b, q, tb, impl)
        else:
            fa, fb = T.sample_feature_grid(a, q, tb, impl), T.sample_feature_grid(b, q, tb, impl)
        ((fa * torch.tensor(ca)).sum() + (fb * torch.tensor(cb)).sum()).backward()
        return fa, fb, a.grad, b.grad, q.grad

    paired, single = run(True), run(False)
    assert "Pair" not in type(paired[0].grad_fn).__name__
    for x, y in zip(paired, single):
        np.testing.assert_array_equal(x.detach().numpy(), y.detach().numpy())


@pytest.mark.parametrize("impl,stencil_widths,fold_widths", [
    ("pallas", [32, 32, 32], []),
    ("halo", [], [32, 64]),
    ("bitfold", [], []),
    ("cellstencil", [], []),
])
def test_color_stage_backward_runs_the_kernels_of_its_variant(impl, stencil_widths, fold_widths, monkeypatch):
    """A color-stage df_forward backward: under ``pallas`` K3 runs once per
    grid at C = 32 and K1 never; under ``halo`` K1 runs on the low grid
    (C = 32) and the fused high+color pair (C = 64) and K3 never."""
    from attentive_dfprior_tpu_torch.models.decoders import init_df_decoders, df_forward

    calls = {"stencil": [], "fold": []}
    real_stencil, real_fold = T.cell_stencil, T.cell_fold_halo
    monkeypatch.setattr(T, "cell_stencil", lambda c, s: calls["stencil"].append(s[3]) or real_stencil(c, s))
    monkeypatch.setattr(T, "cell_fold_halo", lambda c, s: calls["fold"].append(s[3]) or real_fold(c, s))
    gen = torch.Generator().manual_seed(0)
    params = init_df_decoders(gen)
    grids = {k: (0.1 * torch.randn((6, 5, 7, 32), generator=gen)).requires_grad_(True)
             for k in ("grid_low", "grid_high", "grid_color")}
    params.update(grids)
    bound = torch.tensor([[-1.0, 1.0], [-1.0, 1.0], [-1.0, 1.0]])
    p = torch.rand((200, 3), generator=gen) * 2.2 - 1.1
    vol = torch.rand((8, 8, 8), generator=gen) * 2 - 1
    raw, _ = df_forward(params, p, grids, vol, bound, bound, stage="color", grid_vjp=impl)
    raw.sum().backward()
    assert calls["stencil"] == stencil_widths
    assert sorted(calls["fold"]) == fold_widths
    assert all(g.grad is not None for g in grids.values())


@pytest.fixture
def jax_fresh_traces():
    """The JAX mapper reads DFPRIOR_TRILINEAR_VJP and _ADAM_LAZY when it
    traces: drop compiled traces before and after the run."""
    jax.clear_caches()
    yield
    jax.clear_caches()


def _run_mapping_variant(s, monkeypatch, grid_vjp: str, adam_lazy: bool):
    from attentive_dfprior_tpu.ops import adam as j_adam
    from attentive_dfprior_tpu.ops.grid_sample import tsdf_to_rows
    from attentive_dfprior_tpu.slam import mapper as j_mapper
    from attentive_dfprior_tpu_torch.models.scene import params_from_numpy, params_to_numpy
    from attentive_dfprior_tpu_torch.slam.mapper import Mapper

    jax.clear_caches()
    monkeypatch.setenv("DFPRIOR_TRILINEAR_VJP", grid_vjp)
    monkeypatch.setattr(j_adam, "_ADAM_LAZY", adam_lazy)
    cfg = {k: (dict(v) if isinstance(v, dict) else v) for k, v in s["cfg"].items()}
    cfg["mapping"] = dict(cfg["mapping"], BA=False)
    _, color, depth, c2w = s["frames"][0]
    color, depth, c2w = color[None], depth[None], c2w[None]
    H, W = s["cam"].H, s["cam"].W
    key = jax.random.PRNGKey(7)
    iters = cfg["mapping"]["iters_first"]

    jm = j_mapper.Mapper(cfg, s["jcam"], s["scfg"], s["jrcfg"], tsdf_to_rows(s["vol"]), s["tsdf_bnds"])
    captured = []
    orig = j_mapper.mapping_stage

    def capture(*a, **kw):
        out = orig(*a, **kw)
        captured.append(np.asarray(out[2]))
        return out

    monkeypatch.setattr(j_mapper, "mapping_stage", capture)
    jp, _, _, _ = jm.optimize_map(
        jax.tree_util.tree_map(jnp.asarray, s["params0"]), iters, 1.0, 0,
        jnp.asarray(color), jnp.asarray(depth), c2w, key, cur_depth_np=depth[-1], cur_c2w_np=c2w[-1],
    )

    pm = Mapper(cfg, s["cam"], s["port_scfg"], s["rcfg"], torch.tensor(s["vol"]), s["tsdf_bnds"],
                torch.device("cpu"), grid_vjp=grid_vjp, adam_lazy=adam_lazy)
    schedule = pm._stage_schedule(iters)
    assert [st for st, _, _ in schedule] == ["low", "high", "color"]
    draws = mapping_draws(key, schedule, 1, pm.mapping_pixels, H, W)
    pp, _, _, p_losses = pm.optimize_map(
        params_from_numpy(s["params0"]), iters, 1.0, 0, torch.tensor(color), torch.tensor(depth), c2w,
        cur_depth_np=depth[-1], cur_c2w_np=c2w[-1], pixel_idx=draws,
    )
    np.testing.assert_allclose(torch.cat(list(p_losses.values())).numpy(), np.concatenate(captured), rtol=1e-4)
    assert_params_close(params_to_numpy(pp), jax.tree_util.tree_map(np.asarray, jp), s["params0"])
    return params_to_numpy(pp)


def test_optimize_map_pallas_matches_jax(setup, monkeypatch, jax_fresh_traces):
    _run_mapping_variant(setup, monkeypatch, "pallas", adam_lazy=True)


def test_optimize_map_nonlazy_adam_matches_jax(setup, monkeypatch, jax_fresh_traces):
    """The non-lazy Adam steps the high / color leaves during the low stage
    too (zero gradient, advancing step counters), so the later stages' bias
    corrections differ from the lazy run's: the final scene differs from a
    lazy run's and matches the JAX package's."""
    nonlazy = _run_mapping_variant(setup, monkeypatch, "halo", adam_lazy=False)
    lazy = _run_mapping_variant(setup, monkeypatch, "halo", adam_lazy=True)
    assert not np.array_equal(nonlazy["grid_color"], lazy["grid_color"])
