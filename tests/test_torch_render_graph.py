"""The render and point-query programs (``utils/step_graph.py:ForwardGraphs``,
``render/renderer.py``, ``models/decoders.py:query_points``,
``utils/mesher.py``) on the CPU.

The padding of the last chunk against the unpadded chunk (``render_rays`` /
``eval_points_chunk`` called on it as it is; ``torch.equal``) and against
the JAX package's ``Renderer`` (the existing tests' tolerance,
``tests/test_torch_ops.py:174``); the programs' rules under
``tests/test_torch_step_graph.py``'s ``StubGraph``, whose capture runs the
step once and whose replays run nothing: one capture per key, replays that
never capture again, K2's static image refreshed from a stand-in cache when
a decoder leaf is written in place, a moved scene copied without a capture,
one program set and pool per thread, ``graph`` on the CPU refused. A render
of ``WARMUP_ITERS + 1`` chunks runs every chunk through the program's
static buffers (two warm-ups and the capture), so its output is held
``torch.equal`` to the eager render, perturbed importance samples included.
On the card ``chip_smoke.py`` phases 5 and 7 hold the replays to the eager
render and Mesher.
"""

from __future__ import annotations

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_step_graph import StubGraph

from attentive_dfprior_tpu.camera import Camera as JCamera
from attentive_dfprior_tpu.models.decoders import init_df_decoders
from attentive_dfprior_tpu.ops import pose as JP
from attentive_dfprior_tpu.ops.grid_sample import tsdf_to_rows
from attentive_dfprior_tpu.render import renderer as JRen
from attentive_dfprior_tpu_torch.camera import Camera
from attentive_dfprior_tpu_torch.models.decoders import eval_points_chunk, query_points
from attentive_dfprior_tpu_torch.models.scene import params_from_numpy
from attentive_dfprior_tpu_torch.ops.rays import get_rays_full_image
from attentive_dfprior_tpu_torch.ops.cuda import decoder_kernel
from attentive_dfprior_tpu_torch.render import renderer as TRen
from attentive_dfprior_tpu_torch.utils import step_graph as sg
from attentive_dfprior_tpu_torch.utils.step_graph import ForwardGraphs
from attentive_dfprior_tpu_torch.utils.tree import tree_leaves, tree_map

CAM = dict(H=10, W=14, fx=12.0, fy=12.0, cx=6.5, cy=4.5)  # 140 rays
TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_torch_ops.py's, against the JAX package


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread for each test, the worker's count restored after it:
    a padded chunk is held bit for bit to the unpadded one, and CPU BLAS
    splits a 2**17-row product between threads, which at two threads rounds
    some rows of the decoders' output layer otherwise than the 300-row one."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _scene(seed=5):
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(np.asarray, init_df_decoders(jax.random.PRNGKey(seed)))
    params["grid_low"] = (rng.standard_normal((14, 11, 14, 32)) * 0.1).astype(np.float32)
    params["grid_high"] = (rng.standard_normal((28, 22, 28, 32)) * 0.1).astype(np.float32)
    params["grid_color"] = (rng.standard_normal((28, 22, 28, 32)) * 0.1).astype(np.float32)
    bound = np.array([[-2.2, 2.28], [-1.7, 1.82], [-2.2, 2.28]], np.float32)
    tsdf = np.clip(rng.normal(0.3, 0.6, (20, 16, 20)), -1, 1).astype(np.float32)
    c2w = np.asarray(JP.homogenize(JP.pose_matrix_from_tensor(jnp.asarray(
        np.array([1.0, 0.0, 0.0, 0.0, 0.2, -0.1, 0.4], np.float32)))))
    depth = rng.uniform(0.5, 2.0, (CAM["H"], CAM["W"])).astype(np.float32)
    return params, bound, tsdf, c2w, depth


def _renderer(bound, batch, n_importance=0, perturb=0.0, **kw):
    return TRen.Renderer(TRen.RenderConfig(N_importance=n_importance, perturb=perturb), bound, bound,
                         Camera(**CAM), torch.device("cpu"), ray_batch_size=batch, **kw)


def _stub_graphs(**kw):
    return ForwardGraphs("graph", "cpu", graph_factory=StubGraph, **kw)


def _unpadded_render(r, params, c2w, tsdf, gt):
    """``render_img`` with every chunk, the last one too, rendered as it is
    (``render_rays`` on at most ``ray_batch_size`` rays, no padding)."""
    ro, rd = get_rays_full_image(r.cam.H, r.cam.W, r.cam.fx, r.cam.fy, r.cam.cx, r.cam.cy,
                                 torch.as_tensor(np.array(c2w, np.float32)))
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    gd = torch.zeros(ro.shape[0]) if gt is None else torch.as_tensor(gt).reshape(-1)
    bs, outs = r.ray_batch_size, []
    for i in range(0, ro.shape[0], bs):
        outs.append(TRen.render_rays(params, ro[i : i + bs], rd[i : i + bs], gd[i : i + bs], tsdf, r.tsdf_bnds,
                                     r.bound, "color", r.rcfg, no_gt_depth=gt is None)[:3])
    d, v, c = (torch.cat(x) for x in zip(*outs))
    return d.reshape(r.cam.H, r.cam.W), v.reshape(r.cam.H, r.cam.W), c.reshape(r.cam.H, r.cam.W, 3)


def _unpadded_points(params, pts, tsdf, bound, stage, batch):
    """The point query with every chunk queried as it is (no padding)."""
    b = torch.as_tensor(bound)
    return torch.cat([eval_points_chunk(params, pts[i : i + batch], tsdf, b, b, stage)
                      for i in range(0, pts.shape[0], batch)]).numpy()


@pytest.mark.parametrize("n_importance", [0, 16])
@pytest.mark.parametrize("with_depth", [True, False])
def test_padded_last_chunk_leaves_real_rays_equal(with_depth, n_importance):
    """The last chunk padded (rays 1.0, depth 0) as the JAX package pads it:
    every real ray's depth, variance and colour ``torch.equal`` to the
    unpadded render (the chunk's max depth ignores the padded zeros), and
    within the existing tests' tolerance of the JAX ``render_img``."""
    params, bound, tsdf, c2w, depth = _scene()
    gt = depth if with_depth else None
    tp, tt = params_from_numpy(params), torch.tensor(tsdf)
    r = _renderer(bound, 64, n_importance)  # 140 rays: 64, 64, 12 padded to 64
    padded = r.render_img(tp, c2w, tt, gt_depth=gt)
    for a, b in zip(padded, _unpadded_render(r, tp, c2w, tt, gt)):
        assert torch.equal(a, b)
    jr = JRen.Renderer(JRen.RenderConfig(N_importance=n_importance), bound, bound, JCamera(**CAM),
                       ray_batch_size=64, use_fused=False)
    ref = jr.render_img(jax.tree_util.tree_map(jnp.asarray, params), c2w, tsdf_to_rows(tsdf), gt_depth=gt)
    for a, b in zip(padded, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_eval_points_padded_tail_matches_jax():
    """The point query's last chunk padded with zeros, as the JAX
    ``eval_points`` pads it: equal to the unpadded query, and to the JAX
    package within the existing test's tolerance; the Mesher's query too."""
    from attentive_dfprior_tpu_torch.utils.mesher import Mesher

    params, bound, tsdf, _, _ = _scene(4)
    pts = np.random.default_rng(12).uniform(-2.6, 2.6, (300, 3)).astype(np.float32)
    jr = JRen.Renderer(JRen.RenderConfig(), bound, bound, JCamera(**CAM), use_fused=False)
    ref = np.asarray(jr.eval_points(jax.tree_util.tree_map(jnp.asarray, params), pts, tsdf_to_rows(tsdf)))
    tp, tt = params_from_numpy(params), torch.tensor(tsdf)
    got = _renderer(bound, 64).eval_points(tp, pts, tt)  # 300 points padded to 2**17
    assert np.array_equal(got, _unpadded_points(tp, torch.tensor(pts), tt, bound, "color", 300))
    assert (got[:, 3] == 100.0).any()
    np.testing.assert_allclose(got, ref, **TOL)
    cfg = {"meshing": dict(resolution=8, level_set=0.0, clean_mesh_bound_scale=1.02,
                           remove_small_geometry_threshold=0.2, get_largest_components=False),
           "mapping": {"marching_cubes_bound": bound.tolist()}}
    for stage in ("high", "color"):
        m = Mesher(cfg, Camera(**CAM), bound, bound, torch.device("cpu"), points_batch_size=128)
        a = m.eval_points(tp, pts, tt, stage)  # 128, 128, 44 padded to 128
        assert np.array_equal(a, _unpadded_points(tp, torch.tensor(pts), tt, bound, stage, 128))
        np.testing.assert_allclose(a, np.asarray(jr.eval_points(jax.tree_util.tree_map(jnp.asarray, params), pts,
                                                                tsdf_to_rows(tsdf), stage)), **TOL)


@pytest.mark.parametrize("n_importance", [0, 16])
def test_program_chunks_equal_the_eager_render(n_importance):
    """A render of WARMUP_ITERS + 1 chunks through the programs' static
    buffers (rays, depth, the batch max, the static scene, the padding)
    ``torch.equal`` to the eager render; render_batch_ray's chunks, which
    all take the batch's max depth, graphed and eager, to one call of
    ``render_rays`` on the whole batch; the point query's chunks to the
    eager query."""
    params, bound, tsdf, c2w, depth = _scene()
    tp, tt = params_from_numpy(params), torch.tensor(tsdf)
    batch = 60  # 140 rays: 60, 60, 20
    assert -(-140 // batch) == sg.WARMUP_ITERS + 1
    graphed = _renderer(bound, batch, n_importance, graphs=_stub_graphs())
    eager = _renderer(bound, batch, n_importance)
    for gt in (depth, None):
        for a, b in zip(graphed.render_img(tp, c2w, tt, gt_depth=gt), eager.render_img(tp, c2w, tt, gt_depth=gt)):
            assert torch.equal(a, b)
        graphed.graphs.thread().programs.clear()  # the next key's program starts from its warm-ups
    rng = np.random.default_rng(3)
    ro = np.tile(np.array([[0.3, -0.2, 0.5]], np.float32), (140, 1))
    rd = rng.standard_normal((140, 3)).astype(np.float32)
    gd = rng.uniform(0.0, 3.0, 140).astype(np.float32)
    got = graphed.render_batch_ray(tp, ro, rd, gd, tt, "color")
    want = TRen.render_rays(tp, torch.tensor(ro), torch.tensor(rd), torch.tensor(gd), tt, eager.tsdf_bnds,
                            eager.bound, "color", eager.rcfg)
    for a, b, c in zip(got, eager.render_batch_ray(tp, ro, rd, gd, tt, "color"), want):
        assert torch.equal(a, c) and torch.equal(b, c)
    pts = np.random.default_rng(12).uniform(-2.6, 2.6, (300, 3)).astype(np.float32)
    q = query_points(graphed.graphs, tp, torch.tensor(pts), tt, graphed.tsdf_bnds, graphed.bound, "high", 120, False)
    assert torch.equal(q, query_points(ForwardGraphs("eager", "cpu"), tp, torch.tensor(pts), tt,
                                       graphed.tsdf_bnds, graphed.bound, "high", 120, False))


def test_perturbed_importance_program_equals_eager():
    """``perturb > 0`` with ``N_importance`` 16: the program's importance
    uniforms, drawn once outside the capture from a generator seeded 0, are
    the draw that every eager chunk takes, so the graphed render is
    ``torch.equal`` to the eager one; the draw moves the samples off the
    deterministic render's."""
    params, bound, tsdf, c2w, depth = _scene()
    tp, tt = params_from_numpy(params), torch.tensor(tsdf)
    graphed = _renderer(bound, 60, 16, perturb=1.0, graphs=_stub_graphs())
    eager = _renderer(bound, 60, 16, perturb=1.0)
    got = graphed.render_img(tp, c2w, tt, gt_depth=depth)
    for a, b in zip(got, eager.render_img(tp, c2w, tt, gt_depth=depth)):
        assert torch.equal(a, b)
    assert graphed.graphs.stats()["captures"] == 1
    assert not torch.equal(got[0], _renderer(bound, 60, 16).render_img(tp, c2w, tt, gt_depth=depth)[0])


def test_one_capture_per_key_and_replays_never_recapture():
    params, bound, tsdf, c2w, depth = _scene()
    tp, tt = params_from_numpy(params), torch.tensor(tsdf)
    r = _renderer(bound, 32, graphs=_stub_graphs())  # 5 chunks a render
    for _ in range(3):
        r.render_img(tp, c2w, tt, gt_depth=depth)
    st = r.graphs.stats()
    assert (st["programs"], st["captures"]) == (1, 1)
    assert st["eager_iters"] == sg.WARMUP_ITERS and st["replays"] == 3 * 5 - sg.WARMUP_ITERS - 1 + 1
    r.render_img(tp, c2w, tt)  # no sensor depth: another program
    r.eval_points(tp, np.zeros((10, 3), np.float32), tt, stage="high")  # the point query: another
    st = r.graphs.stats()
    assert (st["programs"], st["captures"]) == (3, 2)  # the point query's one chunk is still a warm-up
    prog = next(iter(r.graphs.thread().programs.values()))
    assert prog.graph.graph.replays == 3 * 5 - sg.WARMUP_ITERS - 1 + 1
    assert st["mode"] == "graph" and st["threads"] == 1 and st["pool_gib"] == 0.0


class _StandInCache:
    """Stands in for K2's ``TC_CACHE`` on the CPU: a new 'image' (the
    decoder's leaves flattened) whenever a leaf or its ``_version`` moves."""

    def __init__(self):
        self.builds = 0
        self._held = {}

    def get(self, tree):
        leaves = tree_leaves(tree)
        key = tuple(id(t) for t in leaves)
        versions = [t._version for t in leaves]
        held = self._held.get(key)
        if held is None or held[0] != versions:
            self.builds += 1
            held = self._held[key] = (versions, torch.cat([t.detach().reshape(-1) for t in leaves]))
        return held[1]


def test_stale_weight_image_is_copied_before_the_replay(monkeypatch):
    """A decoder leaf written in place between two renders (as the mapper
    writes it): the static scene takes the new leaf, the cache builds a new
    image, and the program's static image, at its old address, is
    overwritten with it before the replay; an unchanged scene copies
    nothing."""
    params, bound, tsdf, c2w, depth = _scene()
    tp, tt = params_from_numpy(params), torch.tensor(tsdf)
    cache = _StandInCache()
    monkeypatch.setattr(decoder_kernel, "TC_CACHE", cache)
    r = _renderer(bound, 32, graphs=_stub_graphs())
    r.use_fused = True  # pins the images (on the CPU the decoders still run plain)
    r.render_img(tp, c2w, tt, gt_depth=depth)
    scene = r.graphs.thread()._scene
    images = next(iter(r.graphs.thread().programs.values())).images
    assert [d is scene[k] for d, k in zip(images.decoders, ("low", "high", "color"))] == [True] * 3
    assert cache.builds == 3 and images.copies == 3
    ptrs = [im.data_ptr() for im in images.images]
    r.render_img(tp, c2w, tt, gt_depth=depth)
    assert images.copies == 3 and cache.builds == 3  # nothing moved, nothing copied
    with torch.no_grad():
        tp["high"]["out"]["w"].add_(0.5)  # in place, as an optimizer step
    r.render_img(tp, c2w, tt, gt_depth=depth)
    assert images.copies == 4 and cache.builds == 4  # only the high decoder's image
    assert [im.data_ptr() for im in images.images] == ptrs
    assert torch.equal(images.images[1], cache.get(scene["high"]))
    assert torch.equal(scene["high"]["out"]["w"], tp["high"]["out"]["w"])
    assert r.graphs.stats()["captures"] == 1
    # within a program's step K2 takes the static image, not the cache
    with images.pinned():
        assert decoder_kernel._pinned(tree_leaves(scene["high"])) is images.images[1]
        assert decoder_kernel._pinned(tree_leaves(tp["high"])) is None
    assert decoder_kernel._pinned(tree_leaves(scene["high"])) is None


def test_moved_scene_is_copied_without_a_capture():
    """A fresh clone of every leaf (a published snapshot) is copied into the
    static scene; the programs keep their buffers and capture nothing."""
    params, bound, tsdf, c2w, depth = _scene()
    tp, tt = params_from_numpy(params), torch.tensor(tsdf)
    r = _renderer(bound, 32, graphs=_stub_graphs())
    r.render_img(tp, c2w, tt, gt_depth=depth)
    scene = r.graphs.thread()._scene
    ptrs = [t.data_ptr() for t in tree_leaves(scene)]
    for k in range(3):
        snap = tree_map(lambda t: t.detach().clone() + 0.01 * (k + 1), tp)
        r.render_img(snap, c2w, tt, gt_depth=depth)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(scene), tree_leaves(snap)))
    assert [t.data_ptr() for t in tree_leaves(r.graphs.thread()._scene)] == ptrs
    st = r.graphs.stats()
    assert (st["programs"], st["captures"]) == (1, 1) and st["scene_copies"] == 4


def test_two_threads_get_two_program_sets():
    """Each calling thread has its own StepGraphs (pool, side stream,
    programs) and static scene; the captures run in thread_local mode when
    another thread may launch work."""
    params, bound, tsdf, c2w, depth = _scene()
    tt = torch.tensor(tsdf)
    graphs = ForwardGraphs("graph", "cpu", concurrent=True, graph_factory=StubGraph)
    r = _renderer(bound, 32, graphs=graphs)
    states, errors = [], []

    def work():
        try:
            for _ in range(2):
                r.render_img(params_from_numpy(params), c2w, tt, gt_depth=depth)
            states.append(graphs.thread())
        except BaseException as e:  # reported by the main thread
            errors.append(e)

    threads = [threading.Thread(target=work) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    a, b = states
    assert a is not b and a._scene is not b._scene
    assert all(len(s.programs) == 1 and s.captures == 1 for s in states)
    assert all(s.capture_error_mode == "thread_local" for s in states)
    st = graphs.stats()
    assert (st["threads"], st["programs"], st["captures"]) == (2, 2, 2)


def test_graph_mode_on_the_cpu_raises():
    """``graph`` on the CPU raises (a system asked for it raises too:
    ``tests/test_torch_step_graph.py``); the CPU's default is eager."""
    from attentive_dfprior_tpu_torch.utils.mesher import Mesher

    _, bound, _, _, _ = _scene()
    with pytest.raises(ValueError, match="CUDA"):
        ForwardGraphs("graph", "cpu")
    eager = _renderer(bound, 32)  # the default on the CPU
    assert eager.graphs.mode == "eager"
    mesher = Mesher({"meshing": dict(resolution=8, level_set=0.0, clean_mesh_bound_scale=1.0,
                                     remove_small_geometry_threshold=0.0, get_largest_components=False),
                     "mapping": {"marching_cubes_bound": bound.tolist()}}, Camera(**CAM), bound, bound,
                    torch.device("cpu"))
    assert mesher.graphs.mode == "eager"
