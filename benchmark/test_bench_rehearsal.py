"""A rehearsal of the harness on the CPU at a tiny size (``testing.py``):
every cell through the port's plain paths, traced and not, the result
line's keys, the names and units of ``BENCHMARK.json``, no module of JAX or
the JAX package loaded, and a configuration, a mix and a metric added as
files alone and found by name."""

import json
import os
import re
import subprocess
import sys

import pytest

from benchmark.harness import run_cell
from benchmark.testing import ROOT, TINY_SEED, tiny_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(str(tmp_path_factory.mktemp("tiny")))


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("workload", ["room0.strict", "room0.render"])
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(root, workload, trace):
    out, lines = run_cell(workload, TINY_SEED, 0.5, bool(trace), "cpu", root)
    # the result's keys, and last the numbers compared, each beside its limit
    assert list(out) == KEYS + (["breakdown"] if trace else []) + ["compared"]
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    bench = _bench()
    want = [m["name"] for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    if trace:
        moved = set(want)
        want = [m["name"] for m in bench["per_layer"] if workload in m.get("workloads", []) or
                ("workloads" not in m and m["moves"] in moved)]
        assert set(out["metrics"]) <= set(want)  # the trace's readers find nothing on the CPU
        assert {"busy_s", "window_s"} <= set(out["device"])
    else:
        assert sorted(out["metrics"]) == sorted(want)
    assert all(v["value"] > 0 for v in out["metrics"].values()) or trace
    tail = lines[-len(out["compared"]):]
    timed = 2 if workload.endswith(".strict") else 0  # the tracker's and the mapper's calls
    assert len(lines) == len(out["compared"]) + 1 + timed + trace
    assert all(line.startswith("compared ") for line in tail)
    assert lines[0].startswith("set-up phases (s): ")


def test_names_and_units():
    bench = _bench()
    assert list(bench) == ["command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"]
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w[k] for w in bench["workloads"] for k in ("config", "traffic")]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in bench["end_to_end"] + bench["per_layer"])
    assert len({m["name"] for m in bench["end_to_end"] + bench["per_layer"]}) == \
        len(bench["end_to_end"]) + len(bench["per_layer"])
    for m in bench["end_to_end"]:
        assert m["better"] in ("lower", "higher") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", m["name"] + ".py"))
    for w in bench["workloads"]:
        assert os.path.exists(os.path.join(ROOT, "benchmark", "limits", w["name"] + ".json"))


def test_no_jax_in_the_measuring_process(root):
    code = (f"import sys; sys.path.insert(0, {ROOT!r})\n"
            "from benchmark.harness import run_cell, forbidden_modules\n"
            f"out, _ = run_cell('room0.render', {TINY_SEED}, 0.2, False, 'cpu', {root!r})\n"
            "print(out['correct'], forbidden_modules())\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "True []"


def test_files_alone_add_a_config_a_mix_and_a_metric(root, tmp_path):
    new = tiny_root(str(tmp_path))
    b = os.path.join(new, "benchmark")
    with open(os.path.join(b, "configs", "tiny.json")) as f:
        cfg = json.load(f)
    cfg["cam"].update(H=20, W=28, cx=13.5, cy=9.5)
    with open(os.path.join(b, "configs", "tiny-narrow.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(b, "mixes", "render.json")) as f:
        mix = json.load(f)
    mix.update(ray_batch_size=100, check_frames=1)
    with open(os.path.join(b, "mixes", "render-small-chunks.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(b, "limits", "narrow.render.json"), "w") as f:
        json.dump({"render_gap": 2e-5}, f)
    with open(os.path.join(b, "metrics", "pixels_per_s.py"), "w") as f:
        f.write("from benchmark.generate import camera\n\n\ndef read(record):\n"
                "    c = camera(record['cfg'])\n"
                "    return c['H'] * c['W'] * record['window']['frames'] / record['window']['seconds']\n")
    with open(os.path.join(new, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append(dict(bench["configs"][0], name="tiny-narrow", file="benchmark/configs/tiny-narrow.json"))
    bench["workloads"].append({"name": "narrow.render", "config": "tiny-narrow", "traffic": "render-small-chunks",
                               "chips": 1, "why": "a second render shape"})
    bench["end_to_end"].append({"name": "pixels_per_s", "unit": "pixels/s", "better": "higher", "bound": 0.05,
                                "source": "host_clock", "workloads": ["narrow.render"]})
    with open(os.path.join(new, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    out, _ = run_cell("narrow.render", TINY_SEED, 0.2, False, "cpu", new)
    assert out["correct"] is True
    assert sorted(out["metrics"]) == ["pixels_per_s", "setup_s"]
