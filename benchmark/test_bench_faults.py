"""The comparison must fail a broken timed path: a whole run of each cell
at a tiny size on the CPU (the harness's look for a chip skipped), with a
fault planted in the program underneath, reads ``correct`` false.

Faults the cells can have: a step that returns its state unchanged (Adam
a no-op), half of the batch left out with the mean taken over the rest
(the mapping loss on every other ray, doubled), and an answer altered
where it is produced (the tracked pose, the rendered depth). The entries
the window drives are held too: the pose ``Tracker.track`` hands back
moved by a millimetre in translation alone, one iteration moved from the
colour stage to the high stage of ``Mapper.optimize_map``'s schedule, and
its rates doubled. The cells run
on one chip and exchange nothing between chips, so the fault of a missing
exchange has no place here.
"""

import pytest

from benchmark.harness import run_cell
from benchmark.testing import TINY_SEED, tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(str(tmp_path_factory.mktemp("tiny")))


def _state_unchanged(mp):
    import attentive_dfprior_tpu_torch.slam.mapper as mapper
    import attentive_dfprior_tpu_torch.slam.tracker as tracker

    mp.setattr(mapper, "adam_update", lambda *a, **k: None)
    mp.setattr(tracker, "adam_update", lambda *a, **k: None)


def _half_batch(mp):
    import attentive_dfprior_tpu_torch.slam.mapper as mapper

    real = mapper.mapping_loss_fn

    def half(params, rays_o, rays_d, gt_depth, gt_color, inside, *rest, **kw):
        kw.pop("depth_max", None)
        s = slice(0, None, 2)
        return 2.0 * real(params, rays_o[s], rays_d[s], gt_depth[s], gt_color[s], inside[s], *rest, **kw)

    mp.setattr(mapper, "mapping_loss_fn", half)


def _pose_altered(mp):
    import attentive_dfprior_tpu_torch.slam.tracker as tracker

    real = tracker.track_frame

    def altered(*a, **k):
        best, losses, final, pre = real(*a, **k)
        shift = 1e-3 * (torch_ones_like(final))
        return best + shift, losses, final + shift, pre

    mp.setattr(tracker, "track_frame", altered)


def _pose_handed_back_moved(mp):
    from attentive_dfprior_tpu_torch.slam.tracker import Tracker

    real = Tracker.track

    def moved(self, *a, **k):
        c2w, loss = real(self, *a, **k)
        c2w = c2w.copy()
        c2w[:3, 3] += 1e-3 / 3 ** 0.5
        return c2w, loss

    mp.setattr(Tracker, "track", moved)


def _schedule_shifted(mp):
    from attentive_dfprior_tpu_torch.slam.mapper import Mapper

    real = Mapper._stage_schedule

    def shifted(self, *a, **k):
        spans = real(self, *a, **k)
        return [(st, s, e + 1) if st == "high" else (st, s + 1, e) if st == "color" else (st, s, e)
                for st, s, e in spans]

    mp.setattr(Mapper, "_stage_schedule", shifted)


def _rates_doubled(mp):
    from attentive_dfprior_tpu_torch.slam.mapper import Mapper

    real = Mapper.optimize_map

    def doubled(self, params, num_joint_iters, lr_factor, *a, **k):
        return real(self, params, num_joint_iters, 2 * lr_factor, *a, **k)

    mp.setattr(Mapper, "optimize_map", doubled)


def _depth_altered(mp):
    from attentive_dfprior_tpu_torch.render.renderer import Renderer

    real = Renderer.render_img

    def altered(self, *a, **k):
        depth, var, color = real(self, *a, **k)
        return depth + 1e-3, var, color

    mp.setattr(Renderer, "render_img", altered)


def torch_ones_like(t):
    import torch

    return torch.ones_like(t)


@pytest.mark.parametrize("workload,fault", [
    ("room0.strict", _state_unchanged),
    ("room0.strict", _half_batch),
    ("room0.strict", _pose_altered),
    ("room0.strict", _pose_handed_back_moved),
    ("room0.strict", _schedule_shifted),
    ("room0.strict", _rates_doubled),
    ("room0.render", _depth_altered),
])
def test_fault_reads_incorrect(root, monkeypatch, workload, fault):
    fault(monkeypatch)
    out, lines = run_cell(workload, TINY_SEED, 0.2, False, "cpu", root)
    assert out["correct"] is False, lines
    assert any(v["value"] > v["limit"] for v in out["compared"].values())
