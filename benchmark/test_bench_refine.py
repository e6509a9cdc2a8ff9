"""A rehearsal of the final-refine cell (``room_tracking.refine``) on the CPU
at a tiny size: the cell traced and not, the result line's keys, ``correct``
true, no module of JAX or the JAX package loaded, and ``correct`` false for
each fault planted in the program underneath: the pose left unchanged (Adam
a no-op), half of the rays (the loss scaled to the whole), one iteration
more, a constant rate in place of the decay, the clamp skipped, and the
last entry of a call left out.

The tiny root is the benchmark with the cell's configuration cut to a
2.5 x 2.2 x 1.8 m bound, a 24 x 32 camera, an 0.125 m prior, 30 rays and 4
refine iterations, in a directory of its own."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.harness import run_cell
from benchmark.testing import ROOT, TINY_SEED

CELL = "room_tracking.refine"
KEYS = ["correct", "attempted", "failed", "metrics", "device"]
LIMITS = ("refine_clamp", "refine_final", "refine_loss", "refine_pose", "refine_skip")


def tiny_refine_root(tmp: str) -> str:
    """``tmp`` made a checkout root holding the benchmark with the refine
    cell on the tiny configuration. Returns ``tmp``."""
    import shutil

    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(tmp, "benchmark"), dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "benchmark", "configs", "synthetic-room_tracking.json")) as f:
        cfg = json.load(f)
    cfg["mapping"]["bound"] = [[-1.0, 1.5], [-1.0, 1.2], [-0.8, 1.0]]
    cfg["cam"].update(H=24, W=32, fx=20.0, fy=20.0, cx=15.5, cy=11.5)
    cfg["tsdf"]["voxel_size"] = 0.125
    cfg["tracking"].update(pixels=30, ignore_edge_W=2, ignore_edge_H=2)
    cfg["loop_closure"]["refine_iters"] = 4
    with open(os.path.join(tmp, "benchmark", "configs", "tiny-refine.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = next(c for c in bench["configs"] if c["name"] == "synthetic-room_tracking")
    bench["configs"].append(dict(entry, name="tiny-refine", file="benchmark/configs/tiny-refine.json"))
    for w in bench["workloads"]:
        if w["name"] == CELL:
            w["config"] = "tiny-refine"
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return tmp


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_refine_root(str(tmp_path_factory.mktemp("tiny_refine")))


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(root, trace):
    out, lines = run_cell(CELL, TINY_SEED, 0.5, bool(trace), "cpu", root)
    assert list(out) == KEYS + (["breakdown"] if trace else []) + ["compared"]
    assert out["correct"] is True, lines
    assert out["failed"] == 0 and out["attempted"] > 0 and out["attempted"] % 7 == 0
    assert sorted(out["compared"]) == sorted(LIMITS)
    bench = _bench()
    if trace:
        want = {m["name"] for m in bench["per_layer"] if CELL in m.get("workloads", [])}
        assert want == {"device_idle_pct.refine", "idle_in_refine_host_pct", "kernels_per_refine_iter", "mfu.refine"}
        # the CPU trace has no device events: only the host-clock reader finds something
        assert set(out["metrics"]) <= want and "mfu.refine" in out["metrics"]
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert "hand-written kernels in the traced unit: none" in lines
    else:
        assert sorted(out["metrics"]) == ["frames_per_s", "setup_s"]
        assert all(v["value"] > 0 for v in out["metrics"].values())
    assert any(line.startswith("window unit ms: ") for line in lines)
    assert all(line.startswith("compared ") for line in lines[-len(LIMITS):])


def test_no_jax_in_the_measuring_process(root):
    code = (f"import sys; sys.path.insert(0, {ROOT!r})\n"
            "from benchmark.harness import run_cell, forbidden_modules\n"
            f"out, _ = run_cell({CELL!r}, {TINY_SEED}, 0.2, False, 'cpu', {root!r})\n"
            "print(out['correct'], forbidden_modules())\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "True []"


def _pose_unchanged(mp):
    import attentive_dfprior_tpu_torch.slam.tracker as tracker

    mp.setattr(tracker, "adam_update", lambda *a, **k: None)


def _half_rays(mp):
    import attentive_dfprior_tpu_torch.slam.tracker as tracker

    samples, loss = tracker.get_samples, tracker.tracking_loss_fn

    def half_samples(*a, **k):
        return tuple(x[::2] for x in samples(*a, **k))

    mp.setattr(tracker, "get_samples", half_samples)
    mp.setattr(tracker, "tracking_loss_fn", lambda *a, **k: 2.0 * loss(*a, **k))


def _with_track_frame(mp, change):
    """``loop_closure.track_frame`` called with its positional arguments
    changed by ``change``."""
    import attentive_dfprior_tpu_torch.slam.loop_closure as loop_closure

    real = loop_closure.track_frame

    def changed(*a, **k):
        a = list(a)
        change(a)
        return real(*a, **k)

    mp.setattr(loop_closure, "track_frame", changed)


def _one_iteration_more(mp):
    def more(a):
        a[10] += 1  # n_iters

    _with_track_frame(mp, more)


def _constant_rate(mp):
    def constant(a):
        a[18] = 1.0  # lr_final_factor

    _with_track_frame(mp, constant)


def _clamp_skipped(mp):
    import attentive_dfprior_tpu_torch.slam.loop_closure as loop_closure

    mp.setattr(loop_closure, "clamp_pose_update", lambda orig, new, *a: new.astype("float32"))


def _last_entry_left_out(mp):
    from attentive_dfprior_tpu_torch.slam.loop_closure import LoopCloser

    real = LoopCloser.final_refine

    def short(self, dataset, est, params, start_idx, n, *a, **k):
        return real(self, dataset, est, params, start_idx, n - 1, *a, **k)

    mp.setattr(LoopCloser, "final_refine", short)


@pytest.mark.parametrize("fault", [_pose_unchanged, _half_rays, _one_iteration_more, _constant_rate,
                                   _clamp_skipped, _last_entry_left_out])
def test_fault_reads_incorrect(root, monkeypatch, fault):
    fault(monkeypatch)
    out, lines = run_cell(CELL, TINY_SEED, 0.2, False, "cpu", root)
    assert out["correct"] is False, lines
    assert any(v["value"] > v["limit"] for v in out["compared"].values())
