"""The port's graph-ready steps (``utils/step_graph.py``), on the CPU.

Each mapping stage's and each tracked frame's iteration is one
``StepGraph`` that reads and writes static buffers only: the frames, the
frustum masks, BA's window poses, the Adam state (zeroed in place for a new
frame), device-scalar learning rates and regularizer weights, and the
tracker's camera tensor, best loss and candidate. On the card it is
captured once as a CUDA graph and replayed; the CPU has no graph, so here
the same step runs eagerly, and it is held:

  1. ``mapping_stage`` / ``optimize_map`` (with and without BA)
     ``torch.equal`` to the loop the port ran before it had static buffers
     (``_loop_mapping_stage``, float learning rates, a fresh Adam state a
     frame), and within ``tests/test_torch_slam.py``'s tolerances of the
     JAX ``mapping_stage`` on the same numpy-made pixel draws: losses rtol
     1e-4, ``assert_params_close``, BA poses atol 1e-5;
  2. ``track_frame`` the same way (``_loop_track_frame``), and against the
     JAX tracker: losses rtol 1e-4, the best pose atol 0.1 x lr;
  3. a short strict ``SLAMSystem.run`` ``torch.equal`` to the same run on
     the earlier loops;
  4. every static buffer at one address across iterations, stages and
     frames, and ``resume`` dropping the cached programs;
  5. graphs asked for on the CPU (or on a dp agent's gloo group) raise.

Also: the launch accounting of a replay on a stub graph (the launches a
capture records are added at every replay, none at the capture), the
async tracker's static scene (one copy a snapshot, at fixed addresses),
and K2's weight cache after a write that leaves ``_version`` as it was
(a graph replay's).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attentive_dfprior_tpu.ops.grid_sample import tsdf_to_rows
from attentive_dfprior_tpu.slam import mapper as j_mapper
from attentive_dfprior_tpu.slam.tracker import track_frame as j_track_frame
from attentive_dfprior_tpu_torch.models.scene import params_from_numpy, params_to_numpy
from attentive_dfprior_tpu_torch.ops.adam import adam_init, adam_update
from attentive_dfprior_tpu_torch.ops.cuda import build
from attentive_dfprior_tpu_torch.ops.pose import pose_matrix_from_tensor, pose_tensor_from_matrix
from attentive_dfprior_tpu_torch.ops.rays import get_samples, ray_bound_intersection
from attentive_dfprior_tpu_torch.slam import loop_closure as lc_mod
from attentive_dfprior_tpu_torch.slam import mapper as mapper_mod
from attentive_dfprior_tpu_torch.slam import tracker as tracker_mod
from attentive_dfprior_tpu_torch.slam.mapper import Mapper, StageLRs, build_lr_tree, mapping_stage, mapping_step
from attentive_dfprior_tpu_torch.slam.system import SLAMSystem
from attentive_dfprior_tpu_torch.slam.tracker import track_frame, tracking_loss_fn
from attentive_dfprior_tpu_torch.utils import step_graph as sg
from attentive_dfprior_tpu_torch.utils.step_graph import StepGraphs, resolve_step_mode
from attentive_dfprior_tpu_torch.utils.tree import tree_leaves, tree_map
from test_torch_slam import assert_params_close, mapping_draws, setup, tiny_room_cfg  # noqa: F401 (fixture)

LR_ATOL = 0.1  # the tracked pose, in units of the tracker's lr (tests/test_torch_slam.py)


# ------------------------------------------------ the loops before static buffers


def _loop_mapping_stage(params, adam_state, frames_color, frames_depth, frames_c2w, frustum_masks, tsdf_volume,
                        tsdf_bnds, bound, n_iters, w_reg_flags, lrs, stage, pixs_per_image, cam, rcfg, fix_flags,
                        w_color_loss, generator=None, pixel_idx=None, accum=1, ba=False, pose_mask=None,
                        ba_cam_lr=0.0, grid_vjp="halo", adam_lazy=True, shards=None, graphs=None):
    """The port's ``mapping_stage`` before its step was made graph-ready:
    a Python loop, float learning rates and loss weights, the caller's
    tensors as they are."""
    fix_high, fix_color = fix_flags
    if ba:
        lr_tree = {"scene": build_lr_tree(params["scene"], lrs, fix_high, fix_color), "pose": ba_cam_lr}
    else:
        lr_tree = build_lr_tree(params, lrs, fix_high, fix_color)
    H, W = cam.H, cam.W
    losses = []
    for it in range(n_iters):
        pix = None if pixel_idx is None else pixel_idx[it]
        c2ws = pose_matrix_from_tensor(params["pose"]) if ba else frames_c2w
        ro, rd, gd, gc = get_samples(0, H, 0, W, pixs_per_image * accum, cam.fx, cam.fy, cam.cx, cam.cy, c2ws,
                                     frames_depth, frames_color, generator, pix)
        ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
        gd, gc = gd.reshape(-1), gc.reshape(-1, 3)
        inside = ray_bound_intersection(ro.detach(), rd.detach(), bound) >= gd
        losses.append(mapping_step(
            params, adam_state, ro, rd, gd, gc, inside, tsdf_volume, tsdf_bnds, bound, lr_tree, stage, rcfg,
            w_color_loss, float(w_reg_flags[it]), frustum_masks, accum, ba, pose_mask, grid_vjp, adam_lazy, shards,
        ))
    return torch.stack(losses) if losses else torch.zeros(0)


def _loop_track_frame(params, init_camera_tensor, color_im, depth_im, tsdf_volume, tsdf_bnds, bound, cam, rcfg,
                      batch_size, n_iters, ignore_edge_W, ignore_edge_H, handle_dynamic, use_color, w_color_loss,
                      cam_lr, seperate_LR=False, lr_final_factor=1.0, generator=None, pixel_idx=None,
                      grid_vjp="halo", adam_lazy=True, shards=None, graphs=None):
    """The port's ``track_frame`` before its step was made graph-ready."""
    params = tree_map(lambda t: t.detach(), params)
    init = init_camera_tensor.detach().to(torch.float32)
    if seperate_LR:
        cam_params = {"quad": init[:4].clone(), "T": init[4:].clone()}
        lr_tree = {"quad": cam_lr * 0.2, "T": cam_lr}
    else:
        cam_params = {"cam": init.clone()}
        lr_tree = {"cam": cam_lr}

    def assemble(p):
        return torch.cat([p["quad"], p["T"]]) if seperate_LR else p["cam"]

    astate = adam_init(cam_params)
    if lr_final_factor < 1.0 and n_iters > 1:
        i = torch.arange(n_iters, dtype=torch.float32)
        half = n_iters / 2.0
        t = torch.clamp((i - half) / max(n_iters - 1 - half, 1.0), 0.0, 1.0)
        lr_scales = torch.pow(torch.tensor(lr_final_factor, dtype=torch.float32), t).tolist()
    else:
        lr_scales = [1.0] * n_iters
    best_loss = torch.tensor(float("inf"), device=init.device)
    best_tensor = init.clone()
    losses, iter_tensors = [], []
    for it in range(n_iters):
        leaves = list(cam_params.values())
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss = tracking_loss_fn(
            assemble(cam_params), params, color_im, depth_im, tsdf_volume, tsdf_bnds, bound, cam, rcfg,
            batch_size, ignore_edge_W, ignore_edge_H, handle_dynamic, use_color, w_color_loss, generator,
            None if pixel_idx is None else pixel_idx[it], grid_vjp, shards,
        )
        grads = dict(zip(cam_params, torch.autograd.grad(loss, leaves)))
        with torch.no_grad():
            pre = assemble(cam_params).clone()
            adam_update(cam_params, grads, astate, {k: lr * lr_scales[it] for k, lr in lr_tree.items()},
                        lazy=adam_lazy)
            better = loss.detach() < best_loss
            best_loss = torch.where(better, loss.detach(), best_loss)
            best_tensor = torch.where(better, assemble(cam_params), best_tensor)
        losses.append(loss.detach())
        iter_tensors.append(pre)
    return best_tensor, torch.stack(losses), assemble(cam_params).detach(), torch.stack(iter_tensors)


def _window(s, ba):
    idx, win = (5, [0, 1, 2]) if ba else (0, [0])
    color = np.stack([s["frames"][i][1] for i in win])
    depth = np.stack([s["frames"][i][2] for i in win])
    c2w = np.stack([s["frames"][i][3] for i in win])
    if ba:  # perturb the non-anchor poses so BA has something to correct
        c2w[1:, :3, 3] += np.array([0.01, -0.005, 0.008], np.float32)
    return idx, color, depth, c2w


def _mapper(s, ba):
    cfg = {k: (dict(v) if isinstance(v, dict) else v) for k, v in s["cfg"].items()}
    cfg["mapping"] = dict(cfg["mapping"], BA=ba)
    return Mapper(cfg, s["cam"], s["port_scfg"], s["rcfg"], torch.tensor(s["vol"]), s["tsdf_bnds"],
                  torch.device("cpu"))


def _optimize(s, monkeypatch, ba, loop: bool, draws=None, key=None):
    """``Mapper.optimize_map`` on frame 0 (or a 3-frame BA window), on the
    graph-ready step or (``loop``) on ``_loop_mapping_stage``; pixels from
    ``draws``, else a generator seeded 5."""
    idx, color, depth, c2w = _window(s, ba)
    pm = _mapper(s, ba)
    if loop:
        monkeypatch.setattr(mapper_mod, "mapping_stage", _loop_mapping_stage)
    gen = None if draws is not None else torch.Generator().manual_seed(5)
    out = pm.optimize_map(
        params_from_numpy(s["params0"]), pm.iters_first, 1.0, idx, torch.tensor(color), torch.tensor(depth), c2w,
        generator=gen, cur_depth_np=depth[-1], cur_c2w_np=c2w[-1], ba_anchor=0, pixel_idx=draws,
    )
    monkeypatch.setattr(mapper_mod, "mapping_stage", mapping_stage)
    return pm, out


# ------------------------------------------------------------------- 1. mapping


@pytest.mark.parametrize("ba", [False, True])
def test_mapping_step_equals_the_loop_and_matches_jax(setup, monkeypatch, ba):
    s = setup
    _, (p_loop, _, r_loop, l_loop) = _optimize(s, monkeypatch, ba, loop=True)
    pm, (p_new, _, r_new, l_new) = _optimize(s, monkeypatch, ba, loop=False)
    assert pm.step_mode == "eager" and not pm.graphs.graphed
    for a, b in zip(tree_leaves(p_new), tree_leaves(p_loop)):
        assert torch.equal(a.detach(), b.detach())
    assert list(l_new) == list(l_loop) and all(torch.equal(l_new[k], l_loop[k]) for k in l_loop)
    if ba:
        np.testing.assert_array_equal(r_new, r_loop)
    else:
        assert r_new is None and r_loop is None

    # against the JAX mapping_stage on the JAX package's draws
    idx, color, depth, c2w = _window(s, ba)
    cfg = {k: (dict(v) if isinstance(v, dict) else v) for k, v in s["cfg"].items()}
    cfg["mapping"] = dict(cfg["mapping"], BA=ba)
    key = jax.random.PRNGKey(7)
    jm = j_mapper.Mapper(cfg, s["jcam"], s["scfg"], s["jrcfg"], tsdf_to_rows(s["vol"]), s["tsdf_bnds"])
    captured = []
    orig = j_mapper.mapping_stage

    def capture(*a, **kw):
        out = orig(*a, **kw)
        captured.append(np.asarray(out[2]))
        return out

    monkeypatch.setattr(j_mapper, "mapping_stage", capture)
    jp, _, _, j_refined = jm.optimize_map(
        jax.tree_util.tree_map(jnp.asarray, s["params0"]), pm.iters_first, 1.0, idx, jnp.asarray(color),
        jnp.asarray(depth), c2w, key, cur_depth_np=depth[-1], cur_c2w_np=c2w[-1], ba_anchor=0,
    )
    F = len(c2w)
    draws = mapping_draws(key, pm._stage_schedule(pm.iters_first), F, pm.mapping_pixels // F, s["cam"].H, s["cam"].W)
    _, (pp, _, p_refined, p_losses) = _optimize(s, monkeypatch, ba, loop=False, draws=draws)
    np.testing.assert_allclose(torch.cat(list(p_losses.values())).numpy(), np.concatenate(captured), rtol=1e-4)
    assert_params_close(params_to_numpy(pp), jax.tree_util.tree_map(np.asarray, jp), s["params0"])
    if ba:
        np.testing.assert_allclose(p_refined, j_refined, atol=1e-5)


def test_mapping_stage_chunks_replay_one_program(setup):
    """``mapping_stage`` called in chunks (the Visualizer's panels) on the
    same buffers runs one cached program, and equals one call over all the
    iterations; a fresh Adam state (``adam_init``) is another program."""
    s = setup
    _, color, depth, c2w = _window(s, False)
    graphs = StepGraphs("eager", "cpu")
    vol, bnds = torch.tensor(s["vol"]), torch.tensor(s["tsdf_bnds"])
    bound = torch.tensor(s["scfg"].bound, dtype=torch.float32)
    frames = (torch.tensor(color), torch.tensor(depth), torch.tensor(c2w))
    lrs = StageLRs(5e-3, 5e-3, 5e-3, 5e-3, 5e-3)

    flags = [1.0, 0.0, 0.0, 0.0, 0.0]

    def run(chunks, graphs):
        params = params_from_numpy(s["params0"])
        for t in tree_leaves(params):
            t.requires_grad_(True)
        state = graphs.adam("scene", params)
        gen = torch.Generator().manual_seed(9)
        out, at = [], 0
        for n in chunks:
            out.append(mapping_stage(params, state, *frames, None, vol, bnds, bound, n, flags[at:at + n], lrs,
                                     "color", 30, s["cam"], s["rcfg"], (False, False), 0.2, generator=gen,
                                     graphs=graphs))
            at += n
        return params, torch.cat(out)

    pa, la = run([5], graphs)
    pb, lb = run([2, 3], StepGraphs("eager", "cpu"))
    assert torch.equal(la, lb) and all(torch.equal(a, b) for a, b in zip(tree_leaves(pa), tree_leaves(pb)))
    assert len(graphs.programs) == 1


# ------------------------------------------------------------------- 2. tracking


def _track(s, fn, init, color, depth, graphs=None, scene=None, **kw):
    """``fn`` (``track_frame`` or ``_loop_track_frame``) on ``scene``'s
    tensors (params, prior, its bounds, the bound; made from the setup
    when None)."""
    t = s["cfg"]["tracking"]
    e = t["ignore_edge_W"]
    params, vol, bnds, bound = scene or _scene(s)
    return fn(params, torch.tensor(init), torch.tensor(color), torch.tensor(depth), vol, bnds, bound,
              s["cam"], s["rcfg"], t["pixels"], t["iters"], e, e, True, True, 0.5, t["lr"],
              lr_final_factor=t["lr_final_factor"], graphs=graphs, **kw)


def _scene(s):
    return (params_from_numpy(s["params0"]), torch.tensor(s["vol"]), torch.tensor(s["tsdf_bnds"]),
            torch.tensor(s["scfg"].bound, dtype=torch.float32))


@pytest.mark.parametrize("seperate_LR", [False, True])
def test_track_step_equals_the_loop_and_matches_jax(setup, seperate_LR):
    s = setup
    t = s["cfg"]["tracking"]
    graphs = StepGraphs("eager", "cpu")
    frames = []
    gen_new, gen_old = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    scene = _scene(s)  # one live scene, as the tracker reads it frame after frame
    for f in (1, 2):  # two frames through one program: the static state is reset between them
        _, color, depth, gt = s["frames"][f]
        init = gt.copy()
        init[:3, 3] += np.array([0.02, -0.01, 0.015], np.float32)
        cam_t = pose_tensor_from_matrix(init).astype(np.float32)
        new = _track(s, track_frame, cam_t, color, depth, graphs, scene, seperate_LR=seperate_LR, generator=gen_new)
        old = _track(s, _loop_track_frame, cam_t, color, depth, None, scene, seperate_LR=seperate_LR,
                     generator=gen_old)
        for a, b in zip(new, old):
            assert torch.equal(a, b)
        frames.append((cam_t, color, depth))
    assert len(graphs.programs) == 1

    if seperate_LR:
        return  # the JAX tracker below runs one learning rate
    cam_t, color, depth = frames[0]
    key = jax.random.PRNGKey(11)
    H, W, e = s["cam"].H, s["cam"].W, t["ignore_edge_W"]
    n_iters, n = t["iters"], t["pixels"]
    jb, jl, _, _ = j_track_frame(
        jax.tree_util.tree_map(jnp.asarray, s["params0"]), jnp.asarray(cam_t), jnp.asarray(color),
        jnp.asarray(depth), tsdf_to_rows(s["vol"]), jnp.asarray(s["tsdf_bnds"]),
        jnp.asarray(s["scfg"].bound, jnp.float32), key, s["jcam"], s["jrcfg"],
        n, n_iters, e, e, True, True, 0.5, t["lr"], lr_final_factor=t["lr_final_factor"],
    )
    draws = torch.tensor(np.stack([
        np.asarray(jax.random.randint(k, (n,), 0, (H - 2 * e) * (W - 2 * e))) for k in jax.random.split(key, n_iters)
    ]), dtype=torch.int64)
    pb, pl, _, _ = _track(s, track_frame, cam_t, color, depth, graphs, scene, pixel_idx=draws)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-4)
    np.testing.assert_allclose(pb.numpy(), np.asarray(jb), atol=LR_ATOL * t["lr"])


# ------------------------------------------------------------- 3-4. the system


def _system_cfg():
    cfg = tiny_room_cfg()
    cfg["mapping"].update(iters_first=6, iters=5, BA=True, mapping_window_size=3, keyframe_every=1, every_frame=1,
                          keyframe_selection_method="global")
    cfg["loop_closure"].update(enable=True, final_refine=True, every=1, min_gap=1, overlap_gate=0.0, kf_iters=2,
                               refine_iters=2)
    cfg["meshing"]["resolution"] = 16  # the final mesh, at a CPU size
    return cfg


@pytest.fixture(scope="module")
def system_runs(tmp_path_factory):
    """A 4-frame strict run on the graph-ready steps (with a record of
    every buffer each step read) and the same run on the earlier loops."""
    torch.set_num_threads(1)
    reads = {"map": [], "frames": [], "track": []}
    orig_step, orig_samples, orig_loss = mapper_mod.mapping_step, mapper_mod.get_samples, tracker_mod.tracking_loss_fn

    window = {}  # the window size F of the iteration running: its draw precedes its step

    def map_step(params, adam_state, *a, **kw):
        # a: rays, prior, bound, then the lr tree (8), stage, ..., w_reg (12), masks (13), ..., pose_mask (16)
        F = window["F"]
        reads["map"].append((F, a[9], sg.tensor_key(params, adam_state, a[13], a[16]), sg.tensor_key(a[8], a[12])))
        return orig_step(params, adam_state, *a, **kw)

    def samples(*a, **kw):
        window["F"] = a[10].shape[0]
        reads["frames"].append((window["F"], sg.tensor_key(a[10], a[11])))  # the window's depth and color
        return orig_samples(*a, **kw)

    def track_loss(camera_tensor, params, color_im, depth_im, *a, **kw):
        reads["track"].append(sg.tensor_key(params, color_im, depth_im))
        return orig_loss(camera_tensor, params, color_im, depth_im, *a, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(mapper_mod, "mapping_step", map_step)
    mp.setattr(mapper_mod, "get_samples", samples)
    mp.setattr(tracker_mod, "tracking_loss_fn", track_loss)
    new = SLAMSystem(_system_cfg(), output=str(tmp_path_factory.mktemp("new")), device="cpu")
    new.run(end_idx=4)
    mp.undo()
    mp.setattr(mapper_mod, "mapping_stage", _loop_mapping_stage)
    mp.setattr(tracker_mod, "track_frame", _loop_track_frame)
    mp.setattr(lc_mod, "track_frame", _loop_track_frame)
    old = SLAMSystem(_system_cfg(), output=str(tmp_path_factory.mktemp("old")), device="cpu")
    old.run(end_idx=4)
    mp.undo()
    return new, old, reads


def test_strict_run_equals_the_loops(system_runs):
    new, old, _ = system_runs
    assert new.step_mode == {"map": "eager", "track": "eager"}
    for a, b in zip(tree_leaves(new.params), tree_leaves(old.params)):
        assert torch.equal(a.detach(), b.detach())
    np.testing.assert_array_equal(new.estimate_c2w_list[:4], old.estimate_c2w_list[:4])
    np.testing.assert_array_equal(new.keyframes.poses_np(), old.keyframes.poses_np())
    events = [e for e in open(os.path.join(new.output, "metrics.jsonl"))]
    assert any('"loop_relax"' in e for e in events) and any('"loop_final_refine"' in e for e in events)
    assert any('"map"' in e for e in events) and new.mapper.graphs.eager_iters > 0


def test_static_buffers_keep_their_addresses_and_resume_drops_programs(system_runs, tmp_path):
    new, _, reads = system_runs
    # mapping: every iteration of every stage of every frame reads one set
    # of buffers a window size F (F = 1, 2, 3 here; BA from 3), and one
    # set of device scalars a stage program
    shared, per_stage, frames = {}, {}, {}
    for F, stage, key, scalars in reads["map"]:
        shared.setdefault(F, set()).add(key)
        per_stage.setdefault((F, stage), set()).add(scalars)
    for F, key in reads["frames"]:
        frames.setdefault(F, set()).add(key)
    assert len(reads["map"]) > 20 and sorted(frames) == [1, 2, 3] and 3 in shared
    assert all(len(v) == 1 for v in (*shared.values(), *per_stage.values(), *frames.values()))
    # tracking: the live scene's leaves and the program's frame buffers, for
    # every iteration of every frame (the loop closer's programs read their own)
    track_keys = set(reads["track"])
    assert len(reads["track"]) > 10 and len(track_keys) <= 3
    g = new.mapper.graphs
    before = {k: v.data_ptr() for k, v in g.buffers.items()}
    adam_before = [t.data_ptr() for t in tree_leaves(g.adam_states["scene"])]
    assert g.programs and new.tracker.graphs.programs
    ckpt = os.path.join(new.output, "ckpts", "00003.npz")
    new.resume(ckpt)
    assert not g.programs and not new.tracker.graphs.programs
    assert {k: v.data_ptr() for k, v in g.buffers.items()} == before
    assert [t.data_ptr() for t in tree_leaves(g.adam_states["scene"])] == adam_before


# ---------------------------------------------------------------- 5. no graphs


def test_graphs_on_the_cpu_raise(tmp_path, monkeypatch):
    assert resolve_step_mode(None, "cpu") == "eager" and resolve_step_mode("eager", "cpu") == "eager"
    for call in (lambda: resolve_step_mode("graph", "cpu"), lambda: StepGraphs("graph", "cpu"),
                 lambda: SLAMSystem(tiny_room_cfg(), output=str(tmp_path), device="cpu", step_mode="graph")):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    gloo = object()  # a dp agent's group on gloo, whose collectives a graph cannot hold
    monkeypatch.setattr(torch.distributed, "get_backend", lambda group=None: "gloo")
    with pytest.raises(ValueError, match="gloo"):
        resolve_step_mode("graph", "cuda", gloo)
    assert resolve_step_mode(None, "cuda", gloo) == "eager"
    with pytest.raises(ValueError, match="not one of"):
        resolve_step_mode("jit", "cpu")


# ------------------------------------------------------- replay accounting


class StubGraph:
    """Stands in for ``torch.cuda.CUDAGraph`` on the CPU: records its
    capture and counts its replays (a replay runs nothing)."""

    capturing = False

    def __init__(self):
        self.replays = 0
        self.generators = []

    def register_generator_state(self, g):
        self.generators.append(g)

    def capture_begin(self, pool=None, capture_error_mode="global"):
        StubGraph.capturing = True
        self.mode = capture_error_mode

    def capture_end(self):
        StubGraph.capturing = False

    def replay(self):
        self.replays += 1


def test_replays_count_the_launches_their_capture_holds(monkeypatch):
    from attentive_dfprior_tpu_torch.ops.cuda import halo_fold_kernel, stencil_kernel

    monkeypatch.setattr(build, "capturing_stream", lambda: 0 if StubGraph.capturing else None)
    k1, k3 = halo_fold_kernel.KERNEL, stencil_kernel.KERNEL
    monkeypatch.setattr(k1, "launches", 0)
    monkeypatch.setattr(k3, "launches", 0)
    runs = []

    def step():  # two K1 launches and one K3 launch an iteration
        runs.append(StubGraph.capturing)
        build.check_launch(k1, 0)
        build.check_launch(k1, 0)
        build.check_launch(k3, 0)

    graphs = StepGraphs("graph", "cpu", concurrent=True, graph_factory=StubGraph)
    gen = torch.Generator()
    written = torch.zeros(3)
    graph = graphs.step_graph(step, (gen, None), [written])
    for n in range(1, 7):
        version = written._version
        graph()
        assert (k1.launches, k3.launches) == (2 * n, n)  # as the eager step counts
        assert written._version > version or n <= sg.WARMUP_ITERS  # a replay's write advances _version
    assert runs == [False] * sg.WARMUP_ITERS + [True]  # the warm-up ran, the capture recorded, replays ran nothing
    assert graph.graph.replays == 6 - sg.WARMUP_ITERS and graph.graph.generators == [gen]
    assert graph.graph.mode == "thread_local" and graphs.captures == 1 and graphs.replays == 4
    assert not k1.captured and not k3.captured

    def bad():
        raise RuntimeError("not capturable")

    failing = graphs.step_graph(bad)
    failing.warm = sg.WARMUP_ITERS
    with pytest.raises(RuntimeError, match="not capturable"):
        failing()  # a failed capture raises, it never falls back to the step
    assert failing.graph is None and not StubGraph.capturing


def test_async_tracker_copies_each_snapshot_into_its_static_scene():
    graphs = StepGraphs("graph", "cpu", concurrent=True, copy_scene=True, graph_factory=StubGraph)
    snap_a = {"grid": torch.ones(2, 3), "dec": [torch.zeros(4)]}
    snap_b = {"grid": torch.full((2, 3), 2.0), "dec": [torch.ones(4)]}
    a = graphs.scene(snap_a)
    ptrs = [t.data_ptr() for t in tree_leaves(a)]
    assert ptrs != [t.data_ptr() for t in tree_leaves(snap_a)]
    versions = [t._version for t in tree_leaves(a)]
    assert graphs.scene(snap_a) is a and [t._version for t in tree_leaves(a)] == versions  # the same snapshot: no copy
    b = graphs.scene(snap_b)
    assert [t.data_ptr() for t in tree_leaves(b)] == ptrs and torch.equal(b["grid"], snap_b["grid"])
    assert all(t._version > v for t, v in zip(tree_leaves(b), versions))  # the copy is seen by K2's cache
    eager = StepGraphs("eager", "cpu", copy_scene=True)
    assert eager.scene(snap_a)["grid"].data_ptr() == snap_a["grid"].data_ptr()  # eager reads the snapshot


def test_k2_weight_cache_follows_graph_writes():
    """A replay writes the decoders in place without PyTorch seeing it (a
    stub replay that writes through ``.data`` does the same here): the
    replay advances the ``_version`` of the leaves its step writes, so the
    image is rebuilt after it, and only then."""
    from attentive_dfprior_tpu_torch.models.decoders import init_mlp_decoder
    from attentive_dfprior_tpu_torch.ops.cuda.decoder_kernel import TC_CACHE, pack_mlp_params, pack_tc_weights

    dec = init_mlp_decoder(torch.Generator().manual_seed(0))
    w = dec["pts"][1]["w"]

    class WritingGraph(StubGraph):
        def replay(self):
            super().replay()
            w.data.add_(0.5)  # the captured optimizer step

    graphs = StepGraphs("graph", "cpu", graph_factory=WritingGraph)
    graph = graphs.step_graph(lambda: None, (), tree_leaves(dec))
    graph.warm = sg.WARMUP_ITERS
    img = TC_CACHE.get(dec)
    assert TC_CACHE.get(dec) is img
    version = w._version
    w.data.add_(0.5)
    assert w._version == version and TC_CACHE.get(dec) is img  # a write PyTorch does not see
    graph()
    fresh = TC_CACHE.get(dec)
    assert fresh is not img and torch.equal(fresh, pack_tc_weights(pack_mlp_params(dec)))
    assert TC_CACHE.get(dec) is fresh


@pytest.mark.parametrize("shape", [(7, 49), (3, 5, 64), (4, 2), (6, 1)])
def test_cumprod_positive_equals_torch_cumprod(shape):
    """The compositing's cumulative product (``ops/compositing.py``), whose
    backward skips ``torch.cumprod``'s host check for zeros: values and
    gradients bit-identical on inputs without zeros, as the transmittance's
    ``1 - alpha + 1e-10`` are."""
    from attentive_dfprior_tpu_torch.ops.compositing import cumprod_positive

    g = torch.Generator().manual_seed(sum(shape))
    a = torch.rand(shape, generator=g) * 0.999 + 1e-10
    a[..., :1] = 1.0
    ct = torch.randn(shape, generator=g)
    x, y = a.clone().requires_grad_(True), a.clone().requires_grad_(True)
    ref, out = torch.cumprod(x, dim=-1), cumprod_positive(y)
    (gx,), (gy,) = torch.autograd.grad(ref, x, ct), torch.autograd.grad(out, y, ct)
    assert torch.equal(ref, out) and torch.equal(gx, gy)
