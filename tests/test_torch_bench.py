"""The port's benchmark harness (``attentive_dfprior_tpu_torch/tools/bench.py``)
against the JAX package's ``bench.py``, on the CPU.

  - ``WORKLOADS`` is the JAX table;
  - for both workloads, the JAX ``measure_workload`` (its mapping and
    tracking steps replaced by stubs, its prior's draws by a recorder: the
    record's counts do not depend on them) gives the rays a cycle, the
    prior's dims and voxel count the port gives, and its FLOPs a point
    equal the port's count on the same parameters carried across by the
    weight bridge;
  - one tiny ``measure_workload`` and one tiny ``main`` run on the CPU
    (a workload of the same layout with a small bound, camera and batch,
    and a coarse prior): finite losses and every field of the record;
  - the cycle that ``chip_smoke.py`` phase 3 times is ``make_cycle``: two
    cycles built from one workload and the same seeds give the same losses.
"""

from __future__ import annotations

import importlib.util
import json
import os
import types

import numpy as np
import pytest
import torch

from attentive_dfprior_tpu_torch.models.scene import init_scene, params_from_numpy
from attentive_dfprior_tpu_torch.tools import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the layout of a WORKLOADS entry at a CPU size: the tracker's 100-pixel
# edges need an image above 200 pixels a side
TINY = dict(
    bound=[[0.0, 4.0], [-1.0, 3.0], [-2.0, 2.0]],
    cam=dict(H=220, W=240, fx=120.0, fy=120.0, cx=119.5, cy=109.5),
    F=2, map_iters={"low": 2, "high": 1, "color": 2}, pixels=40,
    track_iters=2, track_pixels=20,
)
RECORD_KEYS = {
    "workload", "grid_vjp", "rays_per_cycle", "cycle_s_median", "rep_times_s", "rays_per_s", "rays_per_s_min",
    "rays_per_s_max", "map_s_median", "track_s_median", "build_s", "warmup_s", "samples_per_ray", "tsdf_dims",
    "tsdf_voxels", "grids", "device_peak_mem_gb", "device_mem_held_on_entry_gb", "launches_per_cycle",
    "losses_finite", "last_losses", "step_mode", "graphed", "graph_pool_gb", "graphs",
    "_flops_fwd_per_point",
}


def _jax_bench():
    spec = importlib.util.spec_from_file_location("jax_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def tiny(monkeypatch):
    torch.set_num_threads(2)
    monkeypatch.setitem(bench.WORKLOADS, "tiny", TINY)
    monkeypatch.setattr(bench, "VOXEL", 0.0625)  # a 64^3 prior
    return "tiny"


def test_workloads_are_the_jax_table():
    assert bench.WORKLOADS == _jax_bench().WORKLOADS


class _Draws:
    """Stands in for ``np.random.default_rng(seed)`` in the JAX
    ``bench.py``: records the shapes it is asked for and returns small
    arrays."""

    def __init__(self, shapes):
        self.shapes = shapes

    def uniform(self, lo, hi, size):
        self.shapes.append(tuple(size))
        return np.zeros((1,) * len(size), np.float32)


class _Numpy:
    """numpy, with ``random.default_rng`` giving ``_Draws``."""

    def __init__(self, shapes):
        self.random = types.SimpleNamespace(default_rng=lambda seed: _Draws(shapes))

    def __getattr__(self, name):
        return getattr(np, name)


def _jax_record(name, monkeypatch):
    """The JAX ``measure_workload(name, reps=1)`` with its mapping stage,
    tracker and row layout stubbed and its draws recorded: (record, the
    prior's dims, the JAX scene's parameters)."""
    import jax
    import jax.numpy as jnp

    from attentive_dfprior_tpu.models import scene as jscene
    from attentive_dfprior_tpu.ops import grid_sample as jgs
    from attentive_dfprior_tpu.slam import mapper as jmapper
    from attentive_dfprior_tpu.slam import tracker as jtracker

    jb = _jax_bench()
    shapes, captured = [], {}

    def init_scene(key, scfg):
        captured["params"] = real_init(key, scfg)
        return captured["params"]

    real_init = jscene.init_scene
    monkeypatch.setattr(jscene, "init_scene", init_scene)
    monkeypatch.setattr(jmapper, "mapping_stage",
                        lambda params, astate, *a, **k: (params, astate, jnp.zeros((len(a[7]),))))
    monkeypatch.setattr(jtracker, "track_frame", lambda params, cam, *a, **k: (cam, jnp.zeros((1,)), cam, cam))
    monkeypatch.setattr(jgs, "tsdf_to_rows", lambda x: jnp.zeros((1,)))
    jb.np = _Numpy(shapes)
    rec = jb.measure_workload(name, reps=1)
    jax.clear_caches()
    return rec, shapes[0], captured["params"]


@pytest.mark.parametrize("name", ["replica", "scannet"])
def test_cycle_counts_and_flops_match_jax(name, monkeypatch):
    rec, dims, jparams = _jax_record(name, monkeypatch)
    assert bench.rays_per_cycle(name) == rec["rays_per_cycle"]
    assert bench.prior_dims(bench.WORKLOADS[name]["bound"]) == dims
    assert int(np.prod(bench.prior_dims(bench.WORKLOADS[name]["bound"]))) == rec["tsdf_voxels"]
    import jax

    bridged = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    assert bench.flops_fwd_per_point(bridged) == rec["_flops_fwd_per_point"]
    # the port's own scene has the same matrices and grids
    from attentive_dfprior_tpu_torch.models.scene import SceneConfig

    scfg = SceneConfig(bound=np.array(bench.WORKLOADS[name]["bound"]), c_dim=32, low_grid_len=0.32,
                       high_grid_len=0.16, color_grid_len=0.16, fix_high=False, fix_color=False)
    own = init_scene(torch.Generator().manual_seed(0), scfg)
    assert bench.flops_fwd_per_point(own) == rec["_flops_fwd_per_point"]
    assert {k: list(own[k].shape) for k in ("grid_low", "grid_high", "grid_color")} == {
        k: list(jparams[k].shape) for k in ("grid_low", "grid_high", "grid_color")}


def test_measure_workload_tiny_on_cpu(tiny):
    recs = bench.measure_workload(tiny, reps=2, device="cpu")
    assert list(recs) == ["eager"]  # no graphs on the CPU
    rec = recs["eager"]
    assert set(rec) == RECORD_KEYS
    assert rec["step_mode"] == "eager" and not rec["graphed"] and rec["graph_pool_gb"] is None
    assert rec["graphs"]["captures"] == 0 and rec["graphs"]["eager_iters"] > 0
    assert rec["losses_finite"] and all(np.isfinite(v) for v in rec["last_losses"].values())
    assert rec["last_losses"]["map"] > 0  # the rays reach the scene
    assert rec["rays_per_cycle"] == 40 * 5 + 5 * 20 * 2
    assert len(rec["rep_times_s"]) == 2 and rec["rays_per_s_min"] <= rec["rays_per_s"] <= rec["rays_per_s_max"]
    assert rec["map_s_median"] > 0 and rec["track_s_median"] > 0
    assert rec["tsdf_dims"] == [64, 64, 64] and rec["tsdf_voxels"] == 64**3
    assert rec["samples_per_ray"] == 48 and rec["device_peak_mem_gb"] is None
    assert rec["device_mem_held_on_entry_gb"] is None
    assert rec["launches_per_cycle"] == {"halo_fold": 0, "decoder_mlp": 0, "cell_stencil": 0, "cell_scatter": 0,
                                     "frustum_mask": 0, "trilinear_gather": 0}  # plain on the CPU


def test_main_prints_one_json_line_with_the_scannet_record(tiny, monkeypatch, capsys, tmp_path):
    monkeypatch.setitem(bench.WORKLOADS, "replica", TINY)
    monkeypatch.setitem(bench.WORKLOADS, "scannet", dict(TINY, F=3, pixels=60))
    out = tmp_path / "bench.json"
    payload = bench.main(["--workload", "both", "--reps", "1", "--device", "cpu", "--out", str(out)])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert len(lines) == 1 and json.loads(lines[0]) == json.loads(json.dumps(payload)) == json.load(open(out))
    for key in ("metric", "value", "unit", "median", "min", "max", "spread_frac", "device_kind", "point_evals_per_s",
                "est_model_flops_per_s", "device_peak_mem_gb", "device_mem_held_on_entry_gb", "launches_per_cycle"):
        assert key in payload
    for key in ("vs_baseline", "vs_baseline_note", "est_mfu_vs_chip_fp32_peak", "assumed_peak_flops"):
        assert key not in payload  # measured nothing; the benchmark's mfu.* is the share of the peak
    assert payload["value"] == payload["median"]
    assert payload["step_mode"] == "eager" and payload["graphed"] is False and "graph" not in payload
    assert payload["device_kind"] == "cpu"
    assert payload["point_evals_per_s"] == pytest.approx(payload["value"] * 48)
    assert payload["est_model_flops_per_s"] == pytest.approx(3 * payload["flops_fwd_per_point"] * payload["value"] * 48)
    s = payload["scannet"]
    assert s["workload"] == "scannet" and s["rays_per_cycle"] == 60 * 5 + 5 * 20 * 2 and s["losses_finite"]
    assert "_flops_fwd_per_point" not in s and "_flops_fwd_per_point" not in payload["record"]


def test_make_cycle_repeats_from_its_seeds(tiny):
    wl = bench.build_workload(tiny, torch.device("cpu"))
    (_, a), (_, b) = bench.make_cycle(wl, "halo"), bench.make_cycle(wl, "halo")
    la, lb = a()[0], b()[0]
    assert torch.equal(la, lb) and torch.isfinite(la).all()
    assert not torch.equal(a()[0], la)  # the second cycle starts from the mapped scene and fresh draws


@pytest.mark.skipif(torch.cuda.is_available(), reason="a machine with CUDA runs the card's path")
def test_the_card_is_the_default():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.measure_workload("replica", reps=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--workload", "replica", "--reps", "1"])
