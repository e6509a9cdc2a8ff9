"""The port's step programs beyond one process, on the CPU.

1. ``utils/step_graph.py:resolve_step_mode`` by the agent's own group: no
   group or an NCCL group gives ``graph`` on a CUDA device, a gloo group
   ``eager``; ``graph`` on the CPU or on a gloo group raises (the group's
   backend read through a monkeypatched ``dist.get_backend``).
2. A dp mapping program and a dp tracking program (``handle_dynamic`` on,
   so the gathered median runs) on a ``RayShards`` whose group reads as
   NCCL, under a stub graph (``tests/test_torch_step_graph.py:StubGraph``)
   with ``dist.all_reduce`` monkeypatched to count its calls and leave the
   bucket as it is (a one-rank sum): the warm-up and the capture call the
   all-reduce, a replay calls nothing, K1's launches a replay come from
   the capture, and the capture runs in ``thread_local`` error mode. No
   sockets, so nothing skips.
3. The pretrain as one step program (``tools/pretrain_decoders.py``)
   run eagerly on the CPU: bit for bit the loop of ``pretrain_step`` it
   replaced over 20 steps, and held to the JAX package's steps at
   ``tests/test_torch_tools.py:test_pretrain_steps_match_jax``'s
   tolerance on the same numpy-made draws.
4. The harnesses record the step mode that ran: ``bench_scaling``'s
   ``child_measure`` reads it from its agent's ``StepGraphs``, and
   ``bench_async``'s reps across ranks record every rank's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from attentive_dfprior_tpu_torch.models.scene import params_from_numpy
from attentive_dfprior_tpu_torch.ops import grid_sample
from attentive_dfprior_tpu_torch.ops.adam import adam_init
from attentive_dfprior_tpu_torch.ops.cuda import build
from attentive_dfprior_tpu_torch.ops.cuda.halo_fold_kernel import KERNEL as K1
from attentive_dfprior_tpu_torch.ops.cuda.halo_fold_kernel import cell_fold_plain
from attentive_dfprior_tpu_torch.ops.pose import pose_tensor_from_matrix
from attentive_dfprior_tpu_torch.parallel.sharding import RayShards
from attentive_dfprior_tpu_torch.slam.mapper import Mapper
from attentive_dfprior_tpu_torch.slam.tracker import track_frame
from attentive_dfprior_tpu_torch.tools import pretrain_decoders as P
from attentive_dfprior_tpu_torch.utils import step_graph as sg
from attentive_dfprior_tpu_torch.utils.step_graph import StepGraphs, resolve_step_mode
from attentive_dfprior_tpu_torch.utils.tree import tree_leaves, tree_map
from test_torch_slam import setup  # noqa: F401 (fixture)
from test_torch_step_graph import StubGraph
from test_torch_tools import F32_EPS, _jax_step


class Group:
    """Stands in for a process group; ``dist.get_backend`` reads
    ``backend`` (the ``backends`` fixture)."""

    def __init__(self, backend: str):
        self.backend = backend


NCCL, GLOO = Group("nccl"), Group("gloo")


@pytest.fixture
def backends(monkeypatch):
    monkeypatch.setattr(dist, "get_backend", lambda group=None: group.backend)


# ------------------------------------------------------------ 1. the rules


@pytest.mark.parametrize("mode,device,group,want", [
    (None, "cuda", None, "graph"),  # one process, or a split agent alone in its group
    (None, "cuda", NCCL, "graph"),
    (None, "cuda", GLOO, "eager"),
    (None, "cpu", None, "eager"),
    (None, "cpu", NCCL, "eager"),
    (None, "cpu", GLOO, "eager"),
    ("graph", "cuda", None, "graph"),
    ("graph", "cuda", NCCL, "graph"),
    ("eager", "cuda", NCCL, "eager"),
    ("eager", "cuda", GLOO, "eager"),
    ("eager", "cpu", GLOO, "eager"),
    ("graph", "cuda", GLOO, ValueError("gloo")),
    ("graph", "cpu", None, ValueError("CUDA")),
    ("graph", "cpu", NCCL, ValueError("CUDA")),
    ("jit", "cuda", NCCL, ValueError("not one of")),
])
def test_resolve_step_mode_by_the_agents_group(backends, mode, device, group, want):
    if isinstance(want, Exception):
        with pytest.raises(ValueError, match=str(want)):
            resolve_step_mode(mode, device, group)
    else:
        assert resolve_step_mode(mode, device, group) == want


def test_graphed_agents_refuse_only_a_gloo_group(backends):
    with pytest.raises(ValueError, match="gloo"):
        StepGraphs("graph", "cuda", group=GLOO)  # resolved before any CUDA call
    for group, mode in ((None, "global"), (NCCL, "thread_local")):
        graphs = StepGraphs("graph", "cpu", graph_factory=StubGraph, group=group)
        assert graphs.capture_error_mode == mode
        graphs.step_graph(lambda: None, shards=RayShards(size=1, ranks=(0,), group=group))
        with pytest.raises(ValueError, match="gloo"):
            graphs.step_graph(lambda: None, shards=RayShards(size=1, ranks=(0,), group=GLOO))
    assert StepGraphs("graph", "cpu", concurrent=True, graph_factory=StubGraph).capture_error_mode == "thread_local"
    StepGraphs("eager", "cpu", group=GLOO).step_graph(lambda: None, shards=RayShards(1, (0,), GLOO))


# ------------------------------------------- 2. dp programs on a stub graph


@pytest.fixture
def counted(monkeypatch, backends):
    """``dist.all_reduce`` counting its calls by whether a stub capture
    runs (the bucket left as it is: a one-rank sum), the CPU's K1 fold
    counted as the card's wrapper counts a launch, and launches made in a
    stub capture counted as captured."""
    calls = {"eager": 0, "captured": 0}

    def all_reduce(tensor, op=None, group=None, async_op=False):
        assert group is NCCL and not async_op
        calls["captured" if StubGraph.capturing else "eager"] += 1

    def fold(cells, grid_shape):
        build.check_launch(K1, 0)
        return cell_fold_plain(tuple(int(v) for v in grid_shape), cells)

    monkeypatch.setattr(dist, "all_reduce", all_reduce)
    monkeypatch.setattr(grid_sample, "cell_fold_halo", fold)
    monkeypatch.setattr(build, "capturing_stream", lambda: 0 if StubGraph.capturing else None)
    monkeypatch.setattr(K1, "launches", 0)
    monkeypatch.setattr(K1, "captured", {})
    return calls


def _dp_graphs():
    return StepGraphs("graph", "cpu", graph_factory=StubGraph, group=NCCL), RayShards(size=1, ranks=(0,), group=NCCL)


def test_dp_mapping_program_holds_its_all_reduce(setup, counted):
    s = setup
    cfg = {k: (dict(v) if isinstance(v, dict) else v) for k, v in s["cfg"].items()}
    cfg["mapping"] = dict(cfg["mapping"], BA=False, iters_first=30)  # every stage long enough to replay
    pm = Mapper(cfg, s["cam"], s["port_scfg"], s["rcfg"], torch.tensor(s["vol"]), s["tsdf_bnds"],
                torch.device("cpu"), shards=RayShards(size=1, ranks=(0,), group=NCCL))
    assert pm.step_mode == "eager" and pm.graphs.capture_error_mode == "thread_local"  # the CPU: eager
    pm.graphs, pm.shards = _dp_graphs()
    _, color, depth, c2w = s["frames"][0]
    _, _, _, losses = pm.optimize_map(
        params_from_numpy(s["params0"]), pm.iters_first, 1.0, 0, torch.tensor(color)[None],
        torch.tensor(depth)[None], c2w[None], generator=torch.Generator().manual_seed(5),
        cur_depth_np=depth, cur_c2w_np=c2w,
    )
    iters = {stage: len(v) for stage, v in losses.items()}
    programs = [prog[-1] for prog in pm.graphs.programs.values()]
    g = pm.graphs.stats()
    assert len(programs) == len(iters) == 3 and min(iters.values()) > sg.WARMUP_ITERS + 1
    # the iteration after the warm-ups is captured, then replayed as every later one
    assert g["captures"] == 3 and g["replays"] == sum(iters.values()) - 3 * sg.WARMUP_ITERS
    # one all-reduce an iteration: the warm-ups' run, the captures' are recorded; no replay calls one
    assert counted == {"eager": 3 * sg.WARMUP_ITERS, "captured": 3}
    per_replay = [p.launches[K1] for p in programs]
    assert min(per_replay) > 0 and all(p.graph.mode == "thread_local" for p in programs)
    # a replay counts its capture's K1 launches, as the eager iteration counts its own
    eager = K1.launches - sum(n * (iters[st] - sg.WARMUP_ITERS) for n, st in zip(per_replay, iters))
    assert eager == sg.WARMUP_ITERS * sum(per_replay) and not K1.captured


def test_dp_tracking_program_holds_its_gathered_median(setup, counted):
    s = setup
    graphs, shards = _dp_graphs()
    _, color, depth, c2w = s["frames"][1]
    t = s["cfg"]["tracking"]
    n_iters = 6
    e = t["ignore_edge_W"]
    track_frame(params_from_numpy(s["params0"]), torch.as_tensor(pose_tensor_from_matrix(s["frames"][0][3])),
                torch.tensor(color), torch.tensor(depth), torch.tensor(s["vol"]), torch.tensor(s["tsdf_bnds"]),
                torch.tensor(s["scfg"].bound, dtype=torch.float32), s["cam"], s["rcfg"], t["pixels"], n_iters, e, e,
                True, True, 0.5, t["lr"], generator=torch.Generator().manual_seed(2), shards=shards, graphs=graphs)
    # two all-reduces an iteration: the gathered median's and the loss and gradient's
    assert counted == {"eager": 2 * sg.WARMUP_ITERS, "captured": 2}
    assert graphs.stats()["captures"] == 1 and graphs.stats()["replays"] == n_iters - sg.WARMUP_ITERS
    assert K1.launches == 0  # the scene is read detached: no grid gradient


# ------------------------------------------------------------ 3. pretrain


PRETRAIN_TINY = dict(scenes=3, grid_res=8, c_dim=32, batch=256, lr=1e-3, seed=0)


def test_pretrain_program_equals_the_loop_it_replaced():
    params, losses, graphs = P.train(20, device="cpu", **PRETRAIN_TINY)
    assert graphs.stats() == {"mode": "eager", "programs": 0, "captures": 0, "replays": 0, "eager_iters": 20}
    k = PRETRAIN_TINY
    ref = tree_map(lambda t: t.requires_grad_(True),
                   P.init_pretrain_params(torch.Generator().manual_seed(k["seed"]), k["scenes"], k["grid_res"],
                                          k["c_dim"]))
    gen = torch.Generator().manual_seed(k["seed"] + 1)
    geom = P.sample_scene_geometry(gen, k["scenes"])
    state, lr_tree = adam_init(ref), tree_map(lambda _: k["lr"], ref)
    want = torch.stack([P.pretrain_step(ref, state, lr_tree, *P.draw_step(geom, gen, k["batch"], k["c_dim"]))
                        for _ in range(20)])
    assert torch.equal(losses, want)
    assert all(torch.equal(a.detach(), b.detach()) for a, b in zip(tree_leaves(params), tree_leaves(ref)))
    assert float(losses[-1]) < float(losses[0])


def test_pretrain_program_matches_jax(monkeypatch):
    """Two steps of the step program on ``test_pretrain_steps_match_jax``'s
    own inputs (its parameters and scenes, from one generator seeded 0,
    and its numpy-made draws, scene 1 then scene 2; the tool's makers and
    ``draw_step`` monkeypatched to give them), against the JAX package's
    steps at that test's bounds: each loss at rtol 1e-5; at most 1 % of
    all elements outside rtol 2^-23 / atol 1e-6, and none more than 2 lr a
    step apart (Adam's step of an element whose gradient is roundoff)."""
    from attentive_dfprior_tpu.ops.adam import adam_init as j_adam_init

    k = PRETRAIN_TINY
    g = torch.Generator().manual_seed(0)
    params0 = P.init_pretrain_params(g, k["scenes"], k["grid_res"], k["c_dim"])
    geom0 = P.sample_scene_geometry(g, k["scenes"])
    monkeypatch.setattr(P, "init_pretrain_params", lambda *a: tree_map(lambda t: t.clone(), params0))
    monkeypatch.setattr(P, "sample_scene_geometry", lambda *a: geom0)
    jparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), params0)
    jgeom = {name: jnp.asarray(v.numpy()) for name, v in geom0.items()}
    jstate = j_adam_init(jparams)
    rng = np.random.default_rng(1)
    draws, jlosses = [], []
    for sidx in (1, 2):
        p_unit = rng.uniform(-1, 1, (k["batch"], 3)).astype(np.float32)
        n_low = rng.normal(size=(k["batch"], k["c_dim"])).astype(np.float32)
        n_high = rng.normal(size=(k["batch"], 2 * k["c_dim"])).astype(np.float32)
        jparams, jstate, jloss, _, _ = _jax_step(jparams, jstate, jgeom, jnp.asarray(p_unit), sidx,
                                                 jnp.asarray(n_low), jnp.asarray(n_high), k["lr"])
        draws.append((sidx, p_unit, n_low, n_high))
        jlosses.append(float(jloss))

    def replayed(geom, generator, batch, c_dim):
        sidx, p_unit, n_low, n_high = draws.pop(0)
        idx = torch.tensor([sidx])
        pts, bound, targets = P.scene_batch(geom, idx, torch.from_numpy(p_unit))
        return pts, targets, bound, idx, torch.from_numpy(n_low), torch.from_numpy(n_high)

    monkeypatch.setattr(P, "draw_step", replayed)
    params, losses, _ = P.train(2, device="cpu", **k)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-5)
    apart = total = 0
    for i, (a, b) in enumerate(zip(tree_leaves(params), jax.tree_util.tree_leaves(jparams))):
        a, b = a.detach().numpy(), np.asarray(b)
        assert np.abs(a - b).max(initial=0.0) <= 2 * k["lr"] * 2, f"leaf {i}"
        apart += int((~np.isclose(a, b, rtol=F32_EPS, atol=1e-6)).sum())
        total += a.size
    assert apart <= 0.01 * total, (apart, total)


# ------------------------------------------------------------ 4. harnesses


def test_bench_scaling_records_the_mode_that_ran():
    from attentive_dfprior_tpu_torch.tools import bench_scaling

    rec = bench_scaling.child_measure(1, 20, 2, 1, "cpu")
    assert rec["step_mode"] == "eager" and list(rec["by_mode"]) == ["eager"]
    g = rec["by_mode"]["eager"]["graphs"]
    assert g["mode"] == "eager" and g["eager_iters"] == 2 * 2 and g["captures"] == 0  # warm-up + 1 rep, 2 iters
    assert rec["rays_per_s"] == rec["by_mode"]["eager"]["rays_per_s"] > 0 and rec["losses_finite"]
    with pytest.raises(ValueError, match="CUDA"):
        bench_scaling.child_measure(1, 20, 2, 1, "cpu", step_modes=["graph"])


def test_bench_async_records_every_ranks_modes(monkeypatch):
    from attentive_dfprior_tpu_torch.tools import bench_async
    from attentive_dfprior_tpu_torch.tools import multihost_smoke as mh

    split = {"map": "graph", "track": "graph"}
    results = [{"writer": True, "rank": 1, "step_mode": split, "wall_s": 1.0},
               {"writer": False, "rank": 0, "step_mode": split}]
    monkeypatch.setattr(mh, "start", lambda *a, **kw: None)
    monkeypatch.setattr(mh, "finish", lambda handle, timeout=None: results)
    rec = bench_async.run_ranks("loose", 4, "out", "cpu", {"enable": True}, 2, (), ".")
    assert rec["rank"] == 1 and rec["step_mode_by_rank"] == [split, split]
