"""The port's three last tools against the JAX package's, on the CPU.

  - ``convert_reference_ckpt``: one reference-layout ``.tar`` (synthesized
    with ``torch.save`` from a seeded decoder set and random grids) through
    both converters' CLIs: the two ``.npz`` files hold the same keys and
    equal arrays; the result loads through the port's ``load_checkpoint``
    into the port's decoder tree, each leaf equal to the decoder it came
    from;
  - ``evaluate_scannet``: ``evaluate_mesh_metrics`` equal to JAX's on
    random point sets; ``refuse`` on the CPU against JAX's ``refuse``, of a
    sphere along 8 ring cameras and inside the synthetic room along 4
    frames of its arc, each scored against the mesh it re-fuses: accuracy
    and completion within 1 mm, F-score within 0.005; the CLI without
    re-fusion;
  - ``pretrain_decoders``: two steps from injected parameters, geometry,
    points, scenes and noise, against a JAX composition of the package's
    public ``sample_feature_grid``, ``mlp_decoder_forward``,
    ``scene_sdf_unit`` and ``adam_update``: targets and loss rtol 1e-5,
    gradients at the decoder tests' tolerance, updated leaves atol 1e-6
    (see the test for Adam's ill-conditioned elements); the second step
    reads another scene of the stacked grid leaf, so the first scene moves
    by its moments alone; a short pretrain's ``.npz`` loads through the JAX
    ``load_pretrained_npz`` bit for bit, and the port's decoder forward on it
    is JAX's at the decoder tests' tolerance; the CLI needs ``--out``.
"""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attentive_dfprior_tpu_torch.utils.tree import tree_leaves, tree_map
from test_torch_jax_native import jax_native, jax_native_build  # noqa: F401 (fixtures)

F32_EPS = float(np.finfo(np.float32).eps)


# ---------------------------------------------------------------------------
# convert_reference_ckpt
# ---------------------------------------------------------------------------


def _reference_state_dict(decoders):
    """The reference's nn.Module state dict of a port decoder tree (torch
    Linear weights are (out, in))."""
    sd = {}

    def linear(name, p):
        sd[f"{name}.weight"] = p["w"].T.contiguous()
        sd[f"{name}.bias"] = p["b"].clone()

    for prefix in ("low", "high", "color"):
        d = decoders[prefix]
        sd[f"{prefix}_decoder.embedder._B"] = d["B"].clone()
        for i in range(5):
            linear(f"{prefix}_decoder.pts_linears.{i}", d["pts"][i])
            linear(f"{prefix}_decoder.fc_c.{i}", d["fc_c"][i])
        linear(f"{prefix}_decoder.output_linear", d["out"])
    for i in range(4):
        linear(f"mlp.pts_linears.{i}", decoders["mlp"]["layers"][i])
    linear("mlp.output_linear", decoders["mlp"]["out"])
    return sd


def test_converter_matches_jax_and_loads_in_the_port(tmp_path, monkeypatch):
    from attentive_dfprior_tpu.tools import convert_reference_ckpt as JC
    from attentive_dfprior_tpu_torch.models.decoders import init_df_decoders
    from attentive_dfprior_tpu_torch.tools import convert_reference_ckpt as TC
    from attentive_dfprior_tpu_torch.utils.logger import load_checkpoint

    g = torch.Generator().manual_seed(0)
    decoders = init_df_decoders(g)
    shapes = {"grid_low": (32, 5, 6, 7), "grid_high": (32, 9, 11, 13), "grid_color": (32, 9, 11, 13)}
    grids = {k: torch.randn((1, *s), generator=g) for k, s in shapes.items()}  # [1, C, NZ, NY, NX]
    n_img = 7
    est = torch.randn((n_img, 4, 4), generator=g)
    ckpt = {
        "c": grids,
        "decoder_state_dict": _reference_state_dict(decoders),
        "gt_c2w_list": torch.randn((n_img, 4, 4), generator=g),
        "estimate_c2w_list": est,
        "keyframe_list": [0, 3, 5],
        "idx": torch.tensor(5),
    }
    tar = tmp_path / "00005.tar"
    torch.save(ckpt, str(tar))

    monkeypatch.setattr(sys, "argv", ["convert", str(tar), str(tmp_path / "jax.npz")])
    JC.main()
    TC.main([str(tar), str(tmp_path / "port.npz")])
    with np.load(tmp_path / "jax.npz") as j, np.load(tmp_path / "port.npz") as t:
        assert sorted(j.files) == sorted(t.files)
        for k in j.files:
            assert j[k].dtype == t[k].dtype and np.array_equal(j[k], t[k]), k
        np.testing.assert_array_equal(t["keyframe_est_c2w"], est.numpy()[[0, 3, 5]])

    template = dict(tree_map(torch.zeros_like, decoders))
    for k, (c, nz, ny, nx) in shapes.items():
        template[k] = torch.zeros((nx, ny, nz, c))
    params, meta = load_checkpoint(str(tmp_path / "port.npz"), template)
    for a, b in zip(tree_leaves({k: params[k] for k in decoders}), tree_leaves(decoders)):
        assert torch.equal(a, b)
    for k in shapes:
        assert torch.equal(params[k], grids[k][0].permute(3, 2, 1, 0))
    assert meta["idx"] == 5 and list(meta["keyframe_idx_list"]) == [0, 3, 5]


# ---------------------------------------------------------------------------
# evaluate_scannet
# ---------------------------------------------------------------------------


def test_mesh_metrics_match_jax():
    from attentive_dfprior_tpu.tools import evaluate_scannet as JE
    from attentive_dfprior_tpu_torch.tools import evaluate_scannet as TE

    rng = np.random.default_rng(0)
    gt = rng.uniform(-1, 1, (3000, 3))
    pred = gt[:2500] + rng.normal(0, 0.02, (2500, 3))
    for down in (0.02, 0.0):
        assert TE.evaluate_mesh_metrics(pred, gt, down_sample=down) == JE.evaluate_mesh_metrics(
            pred, gt, down_sample=down)
    np.testing.assert_array_equal(TE.voxel_downsample(pred, 0.1), JE.voxel_downsample(pred, 0.1))


def _sphere_and_ring():
    from attentive_dfprior_tpu_torch.utils.marching_cubes import marching_cubes

    n, r, center = 40, 0.5, np.array([0.0, 0.0, -1.5])
    g = np.mgrid[0:n, 0:n, 0:n].astype(float)
    scale = 2.5 * r / n
    verts, faces, _ = marching_cubes(r / scale - np.sqrt(((g - n / 2) ** 2).sum(0)), 0.0, use_native=False)
    verts = (verts - n / 2) * scale + center
    poses = []
    for ang in np.linspace(0, 2 * np.pi, 8, endpoint=False):
        eye = np.array([1.6 * np.sin(ang), 0.0, -1.5 + 1.6 * np.cos(ang)])
        fwd = (center - eye) / np.linalg.norm(center - eye)
        right = np.cross(fwd, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, np.cross(right, fwd), -fwd, eye
        poses.append(c2w)
    return verts, faces, np.stack(poses)


def _room_and_arc():
    from attentive_dfprior_tpu_torch.utils.synthetic import SyntheticScene

    scene = SyntheticScene(H=34, W=60, fx=30.0, fy=30.0, cx=29.5, cy=16.5, arc_degrees=40.0)
    verts, faces, _ = scene.gt_mesh(resolution=64, use_native=False)
    poses = np.stack([scene.pose_at(i / 3) for i in range(4)]).astype(np.float64)
    return verts, faces, poses


REFUSE_CASES = {
    # a sphere seen by 8 ring cameras, whose frusta hold the whole volume
    "sphere_ring": (_sphere_and_ring, dict(H=80, W=80, fx=60.0, fy=60.0, cx=39.5, cy=39.5), 0.02, 0.02),
    # inside the synthetic room along 4 frames of its arc: the frusta's sides
    # cross the volume, where both packages keep faces (ROADMAP F10)
    "room_arc": (_room_and_arc, dict(H=34, W=60, fx=30.0, fy=30.0, cx=29.5, cy=16.5), 0.05, 0.05),
}


@pytest.mark.parametrize("case", sorted(REFUSE_CASES))
def test_refuse_on_cpu_matches_jax(case, jax_native):
    """``refuse`` on the CPU against JAX's, both scored against the mesh
    they re-fuse: accuracy and completion within 1 mm, F-score within
    0.005."""
    from attentive_dfprior_tpu.camera import Camera as JCamera
    from attentive_dfprior_tpu.tools import evaluate_scannet as JE
    from attentive_dfprior_tpu_torch.camera import Camera
    from attentive_dfprior_tpu_torch.tools import evaluate_scannet as TE

    make, cam, voxel, down = REFUSE_CASES[case]
    verts, faces, poses = make()
    tv, tf = TE.refuse(verts, faces, poses, Camera(**cam), voxel_length=voxel, device="cpu")
    jv, jf = JE.refuse(verts, faces, poses, JCamera(**cam), voxel_length=voxel)
    assert len(tf) > 100 and np.isfinite(tv).all()
    got = TE.evaluate_mesh_metrics(tv, verts, down_sample=down)
    ref = JE.evaluate_mesh_metrics(jv, verts, down_sample=down)
    assert abs(got["Acc"] - ref["Acc"]) <= 1e-3 and abs(got["Comp"] - ref["Comp"]) <= 1e-3, (got, ref)
    assert abs(got["F-score"] - ref["F-score"]) <= 5e-3, (got, ref)


def test_evaluate_scannet_cli_without_refuse(tmp_path):
    from attentive_dfprior_tpu_torch.tools import evaluate_scannet as TE
    from attentive_dfprior_tpu_torch.utils.ply import read_ply, write_ply

    verts, faces, _ = _sphere_and_ring()
    write_ply(str(tmp_path / "gt.ply"), verts, faces)
    write_ply(str(tmp_path / "rec.ply"), verts + 0.01, faces)
    got = TE.main(["--rec_mesh", str(tmp_path / "rec.ply"), "--gt_mesh", str(tmp_path / "gt.ply"), "--no_refuse"])
    want = TE.evaluate_mesh_metrics(read_ply(str(tmp_path / "rec.ply"))[0], read_ply(str(tmp_path / "gt.ply"))[0])
    assert got == want and got["F-score"] > 0.99


# ---------------------------------------------------------------------------
# pretrain_decoders
# ---------------------------------------------------------------------------


def _jax_step(params, state, geom, p_unit, sidx, n_low, n_high, lr):
    """One pretrain step composed of the JAX package's public functions;
    returns (params, state, loss, targets, grads)."""
    from attentive_dfprior_tpu.models.decoders import mlp_decoder_forward
    from attentive_dfprior_tpu.ops.adam import adam_update
    from attentive_dfprior_tpu.ops.grid_sample import sample_feature_grid
    from attentive_dfprior_tpu.tools.pretrain_decoders import scene_sdf_unit

    geom_s = jax.tree_util.tree_map(lambda a: a[sidx], geom)
    scale, offset = geom_s["scale"], geom_s["offset"]
    bound = jnp.stack([offset - scale, offset + scale], axis=-1)
    pts = p_unit * scale + offset
    targets = jnp.tanh(-scene_sdf_unit(geom_s, p_unit) * 20.0)

    def loss_fn(params):
        c_low = sample_feature_grid(params["grids_low"][sidx], pts, bound)
        c_high = jnp.concatenate(
            [sample_feature_grid(params["grids_high"][sidx], pts, bound), jax.lax.stop_gradient(c_low)], axis=-1)
        low_occ = mlp_decoder_forward(params["low"], pts, c_low + 0.5 * n_low)
        high_occ = mlp_decoder_forward(params["high"], pts, c_high + 0.5 * n_high)
        return jnp.mean(jnp.abs(low_occ - targets)) + jnp.mean(jnp.abs((low_occ + high_occ) - targets))

    loss, grads = jax.value_and_grad(loss_fn)(params)
    new_params, state = adam_update(params, grads, state, jax.tree_util.tree_map(lambda _: lr, params))
    return new_params, state, loss, targets, grads


def test_pretrain_steps_match_jax():
    """Two steps, scene 1 then scene 2. Gradients at the decoder tests'
    tolerance (rtol 1e-4, atol 1e-5 x the leaf's largest entry). Updated
    leaves atol 1e-6 plus one float32 rounding of the value (rtol 2^-23: the
    Fourier leaf's entries reach 70, where one float32 step is 7.6e-6),
    except where Adam's step is a ratio of roundoff. Adam moves an element
    by lr m / (sqrt(v) + 1e-8), a function of the ratios of its gradients
    over the steps, so a relative gradient difference d moves it up to
    about lr d apart: where the two packages' gradients of an element part
    by more than 1e-3 relative in some step (a sum that cancels, whose last
    bits differ), the element must agree only within the steps' own bound,
    2 lr per step, and such elements must be at most 1 % of all."""
    from attentive_dfprior_tpu.ops.adam import adam_init as j_adam_init
    from attentive_dfprior_tpu_torch.ops.adam import adam_init
    from attentive_dfprior_tpu_torch.tools import pretrain_decoders as P

    scenes, grid_res, c_dim, batch, lr = 3, 8, 32, 256, 1e-3
    g = torch.Generator().manual_seed(0)
    params = tree_map(lambda t: t.requires_grad_(True), P.init_pretrain_params(g, scenes, grid_res, c_dim))
    geom = P.sample_scene_geometry(g, scenes)
    jparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.detach().numpy()), params)
    jgeom = {k: jnp.asarray(v.numpy()) for k, v in geom.items()}
    state, jstate = adam_init(params), j_adam_init(jparams)
    lr_tree = tree_map(lambda _: lr, params)
    ill = [np.zeros(t.shape, bool) for t in tree_leaves(params)]
    rng = np.random.default_rng(1)
    high0 = params["grids_high"].detach().clone()
    high = []
    for step, sidx in enumerate((1, 2)):
        p_unit = rng.uniform(-1, 1, (batch, 3)).astype(np.float32)
        n_low = rng.normal(size=(batch, c_dim)).astype(np.float32)
        n_high = rng.normal(size=(batch, 2 * c_dim)).astype(np.float32)
        jparams, jstate, jloss, jtargets, jgrads = _jax_step(
            jparams, jstate, jgeom, jnp.asarray(p_unit), sidx, jnp.asarray(n_low), jnp.asarray(n_high), lr)
        idx = torch.tensor([sidx])
        pts, bound, targets = P.scene_batch(geom, idx, torch.from_numpy(p_unit))
        np.testing.assert_allclose(targets.numpy(), np.asarray(jtargets), rtol=1e-5, atol=1e-6)
        draws = (pts, targets, bound, idx, torch.from_numpy(n_low), torch.from_numpy(n_high))
        grads = torch.autograd.grad(P.pretrain_loss(params, *draws), tree_leaves(params))
        for i, (gt, gj) in enumerate(zip(grads, jax.tree_util.tree_leaves(jgrads))):
            gj = np.asarray(gj)
            np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-4, atol=1e-5 * np.abs(gj).max(), err_msg=f"grad {i}")
            ill[i] |= np.abs(gt.numpy() - gj) > 1e-3 * np.abs(gj)
        loss = P.pretrain_step(params, state, lr_tree, *draws)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        for i, (a, b) in enumerate(zip(tree_leaves(params), jax.tree_util.tree_leaves(jparams))):
            a, b = a.detach().numpy(), np.asarray(b)
            np.testing.assert_allclose(a[~ill[i]], b[~ill[i]], rtol=F32_EPS, atol=1e-6, err_msg=f"step {step} leaf {i}")
            assert np.abs(a[ill[i]] - b[ill[i]]).max(initial=0.0) <= 2 * lr * (step + 1), f"step {step} leaf {i}"
        high.append(params["grids_high"].detach().clone())
    n_ill, n_all = sum(int(m.sum()) for m in ill), sum(m.size for m in ill)
    assert n_ill <= 0.01 * n_all, (n_ill, n_all)
    # scene 0 was read by neither step and has no moments: it stays; scene 1,
    # read by the first step, moves in the second by its moments alone
    assert torch.equal(high[1][0], high0[0])
    assert not torch.equal(high[0][1], high0[1]) and not torch.equal(high[1][1], high[0][1])


def test_pretrain_npz_loads_in_jax(tmp_path):
    """The written decoders load into JAX bit for bit (so JAX's forward on
    them equals its forward on the port's in-memory decoders within 1e-6);
    the port's forward on them is JAX's at the decoder tests' tolerance."""
    from attentive_dfprior_tpu.models.decoders import init_df_decoders as j_init_df_decoders
    from attentive_dfprior_tpu.models.decoders import mlp_decoder_forward as j_forward
    from attentive_dfprior_tpu.tools.pretrain_decoders import load_pretrained_npz as j_load
    from attentive_dfprior_tpu_torch.models.decoders import init_df_decoders, load_pretrained_npz, mlp_decoder_forward
    from attentive_dfprior_tpu_torch.tools import pretrain_decoders as P

    out = str(tmp_path / "prior" / "low_high.npz")
    orig = P.save_decoders
    trained = {}

    def keep(params, path):
        trained.update(params)
        return orig(params, path)

    P.save_decoders = keep
    try:
        path, losses = P.pretrain(out, steps=3, scenes=2, grid_res=8, batch=128, device="cpu", verbose=False)
    finally:
        P.save_decoders = orig
    assert path == out and losses.shape == (3,) and np.isfinite(losses).all()
    jdec = j_load(j_init_df_decoders(jax.random.PRNGKey(0)), out)
    tdec = load_pretrained_npz(init_df_decoders(torch.Generator().manual_seed(0)), out)
    rng = np.random.default_rng(2)
    p = rng.uniform(-3, 3, (500, 3)).astype(np.float32)
    for name, c_dim in (("low", 32), ("high", 64)):
        mem = [t.detach().numpy() for t in tree_leaves(trained[name])]
        for a, b, c in zip(mem, jax.tree_util.tree_leaves(jdec[name]), tree_leaves(tdec[name])):
            assert np.array_equal(a, np.asarray(b)) and np.array_equal(a, c.numpy())
        c = rng.normal(0, 0.5, (500, c_dim)).astype(np.float32)
        want = np.asarray(j_forward(jdec[name], jnp.asarray(p), jnp.asarray(c)))
        in_memory = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jdec[name]), [jnp.asarray(a) for a in mem])
        np.testing.assert_allclose(np.asarray(j_forward(in_memory, jnp.asarray(p), jnp.asarray(c))), want,
                                   rtol=0, atol=1e-6)
        got = mlp_decoder_forward(tdec[name], torch.from_numpy(p), torch.from_numpy(c)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_pretrain_cli_needs_an_output_path(capsys):
    from attentive_dfprior_tpu_torch.tools import pretrain_decoders as P

    with pytest.raises(SystemExit):
        P.main(["--steps", "1", "--device", "cpu"])
    assert "--out" in capsys.readouterr().err
