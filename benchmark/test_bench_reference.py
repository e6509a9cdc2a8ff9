"""The plain reference held to the port's plain path at a tiny size on the
CPU: the strict cell's first steps (every mapping stage, the tracker) and
whole calls of both agents, and the render cell's frames, through the
harness's own comparison."""

import importlib

import pytest

from benchmark.harness import load_cell
from benchmark.reference import compare
from benchmark.testing import TINY_SEED, tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(str(tmp_path_factory.mktemp("tiny")))


def _run(root, workload, seed):
    _, cell = load_cell(root, workload, seed, "cpu")
    run = importlib.import_module(f"benchmark.entries.{cell.mix['entry']}").Run(cell)
    run.setup()
    return run


@pytest.mark.parametrize("seed", [TINY_SEED, 5])
def test_strict_first_steps_match(root, seed):
    run = _run(root, "room0.strict", seed)
    run.collect()
    run.release()
    gaps = compare.strict_numbers(run)
    # both sides in float32: the losses and norms agree to round-off, which
    # Adam's first steps (a rate of 0.1 on the low grid) lift to ~1e-5
    assert max(gaps.values()) < 2e-4, gaps
    assert gaps["map_grad"] < 1e-5 and gaps["track_grad"] < 1e-5, gaps
    assert gaps["map_iters"] == 0, gaps


def test_render_matches(root):
    run = _run(root, "room0.render", TINY_SEED)
    run.window(0.2)
    run.collect()
    run.release()
    gaps = compare.render_numbers(run)
    assert gaps["render_gap"] < 1e-6, gaps


def test_reference_imports_nothing_of_the_program():
    import ast
    import os

    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "reference")
    for name in sorted(os.listdir(here)):
        if name.endswith(".py"):
            with open(os.path.join(here, name)) as f:
                tree = ast.parse(f.read())
            mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
            mods |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
            tops = {m.split(".")[0] for m in mods}
            assert not tops & {"jax", "jaxlib", "flax", "attentive_dfprior_tpu", "attentive_dfprior_tpu_torch"}, name
