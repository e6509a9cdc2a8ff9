"""The port's harnesses against the JAX package's scripts, on the CPU at tiny
sizes. The JAX scripts are loaded from their paths with ``importlib``:

  - ``tools/ablate_tracking.py``: ``VARIANTS`` and ``apply`` are the JAX
    script's; two variants run 3 frames of the tiny ``room_tracking.yaml``
    and their records carry the aligned ATE;
  - ``tools/collect_ablation.py``: the merged record equals the JAX
    script's on the same inputs, apart from ``when`` and ``protocol``;
  - ``tools/bench_scaling.py``: ``comm_model`` equals the JAX model row for
    row at the same bytes, step time and bandwidth; ``child_measure`` at 1
    and 2 gloo ranks counts the gradient bytes the JAX harness counts for
    the same scene (skipped where local sockets are refused);
  - ``tools/profile_mapping.py``: every row finite at a tiny shape, its row
    names the JAX script's less the four ``*_rows`` of the TPU's prior
    layout, plus the ``scatter_bwd_pallas_*`` rows (K3's path) and the
    two ``cell_scatter_*`` rows;
  - ``tools/eval_synthetic_demo.py``: accuracy / completion / ratio and ATE
    equal to the JAX script's, within 1e-6, on the same mesh, checkpoint
    and GT, meshed by the same marching route on both sides (numpy, then
    the native libraries);
  - ``tools/run_all_replica.py``: the command sequence, through a
    recording runner.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import os
import re
import socket
import sys

import numpy as np
import pytest
import torch

from attentive_dfprior_tpu_torch.tools import (
    ablate_tracking,
    bench,
    bench_scaling,
    collect_ablation,
    eval_synthetic_demo,
    profile_mapping,
    run_all_replica,
)
from attentive_dfprior_tpu_torch.tools.multihost_smoke import TINY_SLAM
from test_torch_jax_native import jax_native_build, jax_native_off, load_jax_native  # noqa: F401 (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(relpath: str, name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def two_threads():
    """Two torch threads for the test, the worker's count restored after it
    (a later test on the same worker compares runs bit for bit, and CPU
    BLAS may round a row differently at another thread count)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _sockets_allowed() -> bool:
    try:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        s.listen(1)
        s.close()
        return True
    except OSError:
        return False


# ------------------------------------------------------------ ablation


def test_variants_are_the_jax_table():
    jax_mod = _load("scripts/ablate_tracking.py", "jax_ablate_tracking")
    assert ablate_tracking.VARIANTS == jax_mod.VARIANTS


@pytest.mark.parametrize("variant", ["nodyn", "px500_decay01", "decay002", "evf2_kf2_decay01"])
def test_apply_matches_jax(variant):
    from attentive_dfprior_tpu_torch.config import default_config_path, load_config

    jax_mod = _load("scripts/ablate_tracking.py", "jax_ablate_tracking")
    cfg = load_config(os.path.join(REPO, "configs", "Synthetic", "room_tracking.yaml"), default_config_path())
    a, b = copy.deepcopy(cfg), copy.deepcopy(cfg)
    ablate_tracking.apply(a, ablate_tracking.VARIANTS[variant])
    jax_mod.apply(b, jax_mod.VARIANTS[variant])
    assert a == b and a != cfg


def test_ablate_tracking_runs_two_variants(tmp_path, two_threads):
    out = tmp_path / "ablate.json"
    results = ablate_tracking.main(
        ["--variants", "base,nodyn", "--end_idx", "3", "--device", "cpu", "--out", str(out),
         "--out-root", str(tmp_path / "runs"), "--config", os.path.join(REPO, "configs", "Synthetic",
                                                                        "room_tracking.yaml")],
        overrides=TINY_SLAM,
    )
    assert list(results) == ["base", "nodyn"] and json.load(open(out)) == json.loads(json.dumps(results))
    for name, rec in results.items():
        assert rec["n_frames"] == 3 and len(rec["err_cm_series"]) == 3
        assert np.isfinite(rec["ate_cm_aligned"]) and np.isfinite(rec["ate_cm_unaligned"])
        assert rec["overrides"] == ablate_tracking.VARIANTS[name] and rec["seed"] == 0
    # no checkpoint or mesh: the trajectory alone
    for sub in ("ckpts", "mesh"):
        d = tmp_path / "runs" / "base_s0" / sub
        assert not os.path.exists(d) or not os.listdir(d)


def test_collect_ablation_matches_jax(tmp_path, monkeypatch, capsys):
    def rec(ate, seed=0):
        return {"seed": seed, "ate_cm_aligned": ate, "ate_cm_unaligned": ate + 1.0, "overrides": {"x": ate}}

    a = tmp_path / "a.json"
    b = tmp_path / "b.json"
    a.write_text(json.dumps({"base": rec(3.5), "nodyn": rec(2.25), "hires": rec(4.0)}))
    b.write_text(json.dumps({"base": rec(3.0, seed=1), "ba": rec(1.5), "nodyn": rec(2.75, seed=2)}))
    jax_out, port_out = tmp_path / "jax.json", tmp_path / "port.json"
    monkeypatch.setattr(sys, "argv", ["collect_ablation.py", str(jax_out), str(a), str(b)])
    _load("scripts/collect_ablation.py", "jax_collect_ablation").main()
    payload = collect_ablation.main([str(port_out), str(a), str(b)])
    jax_payload, port_payload = json.load(open(jax_out)), json.load(open(port_out))
    assert port_payload == json.loads(json.dumps(payload))
    assert "TPU" not in port_payload["protocol"] and "CUDA card" in port_payload["protocol"]
    for p in (jax_payload, port_payload):
        p.pop("when")
        p.pop("protocol")
    assert port_payload == jax_payload
    assert [r["variant"] for r in port_payload["ranked"]] == ["ba", "nodyn", "base", "hires"]


# ---------------------------------------------------------- dp scaling


@pytest.mark.parametrize("kind", ["TPU v4", "TPU v5p"])
def test_comm_model_matches_jax(kind, monkeypatch):
    jax_mod = _load("bench_scaling.py", "jax_bench_scaling")
    bw = next(v for k, v in jax_mod.ICI_BW_BIDI.items() if k == kind)
    monkeypatch.setitem(bench_scaling.LINK_BW_BIDI, "H100", bw)  # the same bandwidth in both models
    args = (49_939_508, 0.0437, 1000)
    ref = jax_mod.comm_model(*args, kind, [1, 2, 4, 8], [1, 5, 15])
    got = bench_scaling.comm_model(*args, "NVIDIA H100 80GB HBM3", [1, 2, 4, 8], [1, 5, 15])
    assert got["strong"] == ref["strong"] and got["weak"] == ref["weak"]
    assert got["assumed_link_bw_bidi_bytes_per_s"] == ref["assumed_ici_bw_bidi_bytes_per_s"] == bw


def test_comm_model_bandwidth_table():
    assert bench_scaling.link_bandwidth("NVIDIA H100 80GB HBM3") == 9.0e11
    with pytest.raises(ValueError, match="no link bandwidth for 'cpu'"):
        bench_scaling.comm_model(1, 0.01, 1000, "cpu", [2], [1])


def _jax_grad_bytes() -> int:
    """``bench_scaling.py:child_measure``'s count on its scene: room0's
    bound, which is the JAX ``bench.py``'s replica bound."""
    import jax

    from attentive_dfprior_tpu.models.scene import SceneConfig, init_scene

    bound = np.array(_load("bench.py", "jax_bench").WORKLOADS["replica"]["bound"])
    scfg = SceneConfig(bound=bound, c_dim=32, low_grid_len=0.32, high_grid_len=0.16,
                       color_grid_len=0.16, fix_high=False, fix_color=False)
    params = init_scene(jax.random.PRNGKey(0), scfg)
    return int(sum(x.size * x.dtype.itemsize for x in jax.tree_util.tree_leaves(params)))


@pytest.mark.skipif(not _sockets_allowed(), reason="no local sockets")
def test_child_measure_counts_the_jax_gradient_bytes(tmp_path):
    out = tmp_path / "scaling.json"
    payload = bench_scaling.main(["--devices", "1,2", "--pixels", "20", "--iters", "2", "--reps", "1",
                                  "--device", "cpu", "--out", str(out)])
    want = _jax_grad_bytes()
    assert [r["n_devices"] for r in payload["raw"]] == [1, 2]
    for r in payload["raw"]:
        assert r["grad_bytes_per_step"] == want and r["losses_finite"] and r["backend"] == "gloo"
        assert len(r["launches_by_rank"]) == r["n_devices"]
    assert payload["comm_model"]["grad_bytes_per_step"] == want
    assert payload["comm_model"]["measured_step_s_1dev"] == payload["raw"][0]["step_s"]
    assert [row["n"] for row in payload["comm_model"]["strong"]][::3] == [1, 2, 4, 8]
    assert payload["workloads"]["20px"]["efficiency_vs_linear"][0] == 1.0
    assert json.load(open(out))["comm_model"] == payload["comm_model"]


@pytest.mark.skipif(torch.cuda.is_available(), reason="a machine with CUDA runs the card's path")
def test_scaling_on_the_card_by_default():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_scaling.main(["--devices", "1"])


# ------------------------------------------------------------- profile


def _jax_row_names():
    """The rows of ``scripts/profile_mapping.py``: its ``results[...]``
    keys, each f-string key once per grid."""
    src = open(os.path.join(REPO, "scripts", "profile_mapping.py")).read()
    names = set(re.findall(r'results\["(\w+)"\]', src))
    for stem in re.findall(r'results\[f"(\w+)\{gk\}"\]', src):
        names |= {stem + gk for gk in ("grid_low", "grid_high", "grid_color")}
    return names


def test_profile_rows_finite_and_named_as_jax(monkeypatch, two_threads):
    monkeypatch.setitem(bench.WORKLOADS, "tiny", dict(
        bound=[[0.0, 4.0], [-1.0, 3.0], [-2.0, 2.0]], cam=dict(H=24, W=32, fx=24.0, fy=24.0, cx=15.5, cy=11.5),
        F=2, map_iters={}, pixels=40, track_iters=0, track_pixels=0))
    monkeypatch.setattr(bench, "VOXEL", 0.0625)
    rows = profile_mapping.profile("cpu", iters=2, reps=1, workload="tiny", rays=40)
    jax_names = _jax_row_names()
    layout = {"tsdf_sample_rows", "full_iter_color_rows", "fwd_loss_color_rows", "fwd_bwd_color_rows"}
    assert layout <= jax_names and len(jax_names) == 27
    pallas = {f"scatter_bwd_pallas_{gk}" for gk in profile_mapping.GRIDS}
    scatter = {"cell_scatter_atomic", "cell_scatter_ordered"}
    assert set(rows) == (jax_names - layout) | pallas | scatter
    for name, r in rows.items():
        assert r["finite"], name
        assert r["ms_per_iter"] > 0 and len(r["rep_ms"]) == 1
        assert r["device_ms_per_iter"] is None  # no profiler pass on the CPU
        assert r["launches_per_iter"] == {"halo_fold": 0, "decoder_mlp": 0, "cell_stencil": 0, "cell_scatter": 0,
                                           "frustum_mask": 0, "trilinear_gather": 0}
    only = profile_mapping.profile("cpu", iters=1, reps=1, only="cellgrad", workload="tiny", rays=40)
    assert sorted(only) == sorted(n for n in rows if "cellgrad" in n)


# ------------------------------------------------- synthetic-demo scoring


@pytest.fixture(scope="module")
def demo_run(tmp_path_factory):
    """A run directory of ``room.yaml``'s scene: the GT mesh at lattice 48,
    its vertices moved by up to 1 cm, as the reconstruction, and a
    checkpoint of 6 GT poses with an estimate 2 cm off on average."""
    from attentive_dfprior_tpu_torch.config import default_config_path, load_config
    from attentive_dfprior_tpu_torch.utils.ply import write_ply
    from attentive_dfprior_tpu_torch.utils.synthetic import SyntheticScene

    cfg_path = os.path.join(REPO, "configs", "Synthetic", "room.yaml")
    cfg = load_config(cfg_path, default_config_path())
    scene = SyntheticScene.from_config(cfg)
    out = tmp_path_factory.mktemp("demo_run")
    rng = np.random.default_rng(0)
    v, f, _ = scene.gt_mesh(resolution=48)
    os.makedirs(out / "mesh")
    write_ply(str(out / "mesh" / "final_mesh_eval_rec.ply"), v + rng.uniform(-0.01, 0.01, v.shape), f)
    n_all = int(cfg["data"]["n_frames"])
    gt = np.stack([scene.pose_at(i / (n_all - 1)) for i in range(n_all)]).astype(np.float32)
    est = gt.copy()
    est[:6, :3, 3] += rng.normal(0, 0.02, (6, 3)).astype(np.float32)
    est[6:] = 0.0
    os.makedirs(out / "ckpts")
    np.savez(out / "ckpts" / "00005.npz", gt_c2w_list=gt, estimate_c2w_list=est, idx=np.asarray(5))
    return cfg_path, str(out)


@pytest.mark.parametrize("route", ["numpy", "native"])
def test_eval_synthetic_demo_matches_jax(demo_run, route, request, monkeypatch, capsys):
    """Both sides mesh the GT on one marching route, whose surfaces are
    equal only up to vertex order, which moves the surface samples:
    ``numpy`` (the JAX package's native library made unavailable, the
    port's GT mesh with ``use_native=False``) or ``native`` (both
    libraries)."""
    from attentive_dfprior_tpu_torch.utils.synthetic import SyntheticScene

    cfg_path, out = demo_run
    if route == "numpy":
        jax_native_off(monkeypatch)
        gt_mesh = SyntheticScene.gt_mesh
        monkeypatch.setattr(SyntheticScene, "gt_mesh",
                            lambda self, resolution=96, use_native=True: gt_mesh(self, resolution, use_native=False))
    else:
        load_jax_native(request, monkeypatch)
    monkeypatch.setattr(sys, "argv", ["eval_synthetic_demo.py", cfg_path, out, "--gt_resolution", "64"])
    _load("scripts/eval_synthetic_demo.py", "jax_eval_synthetic_demo").main()
    ref = json.loads(capsys.readouterr().out)
    got = eval_synthetic_demo.main([cfg_path, out, "--gt_resolution", "64"])
    assert json.loads(capsys.readouterr().out) == json.loads(json.dumps(got))
    assert got["n_rec_verts"] == ref["n_rec_verts"] and got["n_gt_culled_verts"] == ref["n_gt_culled_verts"]
    for k in ("accuracy_cm", "completion_cm", "completion_ratio_pct"):
        assert got["metrics_3d"][k] == pytest.approx(ref["metrics_3d"][k], rel=1e-6, abs=1e-6), k
    for k in ("ate_rmse_cm", "ate_rmse_cm_unaligned"):
        assert got[k] == pytest.approx(ref[k], rel=1e-6, abs=1e-6), k
    assert 0 < got["ate_rmse_cm"] <= got["ate_rmse_cm_unaligned"]


def test_score_meshes_is_the_tools_3d_metric(demo_run):
    """``score_meshes`` (what chip_smoke.py's phases 7, 9 and 12 call) on
    the run's mesh and poses reads what ``evaluate`` reads."""
    from attentive_dfprior_tpu_torch.camera import Camera
    from attentive_dfprior_tpu_torch.config import default_config_path, load_config
    from attentive_dfprior_tpu_torch.utils.ply import read_ply

    cfg_path, out = demo_run
    cfg = load_config(cfg_path, default_config_path())
    v, f, _ = read_ply(os.path.join(out, "mesh", "final_mesh_eval_rec.ply"))
    with np.load(os.path.join(out, "ckpts", "00005.npz")) as ck:
        gt = ck["gt_c2w_list"]
    cam = Camera(**{k: cfg["cam"][k] for k in ("H", "W", "fx", "fy", "cx", "cy")})
    (got,) = eval_synthetic_demo.score_meshes(cfg, cam, [(v, f)], gt, gt_resolution=64)
    assert got == eval_synthetic_demo.evaluate(cfg_path, out, gt_resolution=64)["metrics_3d"]


# -------------------------------------------------------------- Replica


@pytest.mark.parametrize("skip_tsdf", [False, True])
def test_run_all_replica_command_sequence(skip_tsdf):
    calls = []
    argv = ["--scenes", "room0", "office3", "--input_folder", "/data/Replica/{scene}", "--device", "cpu"]
    run_all_replica.main(argv + (["--skip_tsdf"] if skip_tsdf else []),
                         runner=lambda cmd, check: calls.append((cmd, check)))
    py, pkg = sys.executable, "attentive_dfprior_tpu_torch"
    want = []
    for scene in ("room0", "office3"):
        cfg, data = f"configs/Replica/{scene}.yaml", ["--input_folder", f"/data/Replica/{scene}"]
        if not skip_tsdf:
            want.append([py, "-m", f"{pkg}.tsdf.builder", cfg, "--space", "1", *data, "--device", "cpu"])
        want += [[py, "-m", f"{pkg}.run", cfg, *data, "--device", "cpu"], [py, "-m", f"{pkg}.tools.eval_ate", cfg]]
    assert calls == [(c, True) for c in want]


def test_run_all_replica_defaults():
    calls = []
    run_all_replica.main(["--device", "cpu"], runner=lambda cmd, check: calls.append(cmd))
    assert len(calls) == 3 * 8 and [c[3] for c in calls[::3]] == [
        f"configs/Replica/{s}.yaml" for s in _load("scripts/run_all_replica.py", "jax_run_all_replica").SCENES]
    assert not any("--input_folder" in c for c in calls)  # the configs' own data.input_folder
    for c in calls:  # every step runs one of the port's modules
        assert importlib.util.find_spec(c[2]) is not None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run_all_replica.main([], runner=lambda cmd, check: calls.append(cmd))
