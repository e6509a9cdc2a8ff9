#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                # phases 1-7, 10, 12, 13, 15, 16, 17, 19 and 21, one card
    python3 chip_smoke.py --phases 1,2   # build + kernel checks only
    python3 chip_smoke.py --phases 1,8   # the room.yaml quality run
    python3 chip_smoke.py --phases 1,9   # the room_tracking.yaml quality run
    python3 chip_smoke.py --phases 1,10  # the async modes alone
    python3 chip_smoke.py --phases 1,11  # room_tracking.yaml whole under loose
    python3 chip_smoke.py --phases 1,12,13  # the file-backed loaders and the tools
    python3 chip_smoke.py --phases 1,14  # the full decoder pretrain and its prior's gates
    python3 chip_smoke.py --phases 1,15  # ray-axis data parallelism alone
    python3 chip_smoke.py --phases 1,16  # the async agents across processes alone
    python3 chip_smoke.py --phases 1,17  # the harnesses alone
    python3 chip_smoke.py --phases 1,18  # the tracking ablation (two variants, 16 frames)
    python3 chip_smoke.py --phases 1,19  # graphed against eager, torch.equal
    python3 chip_smoke.py --phases 1,20  # phase 6's runs under torch.use_deterministic_algorithms
    python3 chip_smoke.py --phases 1,21  # ray-axis dp graphed on NCCL, a world of one

Phases (each failure exits non-zero):
  1. environment and build: torch / CUDA versions, the card's name and
     power limit, the TF32 flags (must be off), the build of every kernel
     from ``attentive_dfprior_tpu_torch/csrc`` with nvcc (sm_90a) and of
     the native host library (marching tetrahedra, rasterizer) with g++;
  2. every kernel against its plain PyTorch version on the card, at odd
     shapes and at the main path's shapes, with CUDA-event timings; K3
     also against K1; ``ops/compositing.py:cumprod_positive`` (the
     capturable transmittance product) ``torch.equal`` to ``torch.cumprod``,
     values and gradients, at the main path's sample shapes; K4, the
     ordered cell scatter (the start of every grid gradient), ``torch.equal``
     to its plain version on the card and on the CPU and its radix sort's
     permutation to ``torch.sort(stable=True)``'s, at odd shapes (a width
     of 25, 2^19 + 1 rows) and at ray-shaped points of room0's colour stage
     (8C and the pair's 16C) and ScanNet's 5000 rays, where it is timed
     eagerly and as a graph replay beside zeros + ``index_add_`` and its
     device kernels a call are counted by the profiler (at most 5); K1's
     and K3's function as one ``F.conv_transpose3d`` (the library column,
     ``tools/profile_scatter.py``), timed and held to K1; K5, TSDF
     integration, ``torch.equal`` to its plain version in tsdf, weight and
     colour at an odd volume (25x17x13) with edge-case frames (zero depth,
     voxels behind the camera and on its plane, projections on pixel
     half-boundaries, obs_weight 0.5, frames in sequence), at odd volumes
     with the cull's edge cases (a camera inside looking along a diagonal
     and along -x, NaN / +inf / zero pixels, depths beyond the volume,
     frames that update nothing, three frames at obs_weight 0.5), at
     room0's 196 M voxels with a 680x1200 frame and at ScanNet's 345 M with
     a 480x640 frame; at every frame its runs (``tsdf_kernel.kept_runs``)
     equal to the plain rule's (``kept_runs_plain``) and holding every voxel
     the frame updated; at the two large ones timed beside its plain version
     and its bound (the updated voxels' bytes and operations and the frame
     read once), its CUDA launches a call and device ms counted by the
     profiler (3), and its allocation measured (none by the kernel after its
     first call at a shape; the frame's inputs through
     ``TSDFVolume.integrate``); K6, the mapper's frustum masks, at room0's
     and ScanNet's grids on seeded frames and the rule's edges (an all-zero
     frame, NaN / +inf pixels, a camera inside with every sample zero, one
     facing out of the bound, a NaN in the pose): ``torch.equal`` to its
     plain version and voxel for voxel ``get_frustum_mask`` (numpy), timed
     by CUDA events beside the numpy masks' host ms and its bound, the card
     route's host ms, its CUDA launches a call counted by the profiler (at
     most 2); K7, the trilinear lookup, ``torch.equal`` to
     ``trilinear_sample``, single and pair, at room0's three grids and
     ScanNet's high grid, at 9,600, 48,000, 240,000 and 480,000 seeded
     points in ray order with border, node and outside points among them;
     one render chunk (10,000 rays, K2 on) and one colour-stage mapping
     iteration through the production path ``torch.equal`` to the same with
     the samplers' forward patched back to ``trilinear_sample`` (this
     script's patch; the port has no switch), with K7's launches on each;
     timed beside its bound (points read, features written), the plain
     function and one ``F.grid_sample`` (5-D, border, align_corners);
  3. the room0-shape SLAM cycle (``tools/bench.py``'s replica workload,
     from its builder) under the ``halo`` grid gradient (K1) and the
     ``pallas`` one (K3), each with its iterations replayed as CUDA graphs
     and run eagerly (``utils/step_graph.py``), the four timed in turns,
     two reps each: one mapped frame of 25/12/23 stage iterations x 1000
     rays x 48 samples over a window of 5 random 680x1200 frames, a random
     4/256 m prior of ~196 M voxels, then 5 tracked frames of 10
     iterations x 200 rays; fails unless a replay counts the launches the
     eager cycle makes. The halo cycles (graphed and eager) are profiled
     at the very end of the run (kernel time summed over the cycle, host
     launches per iteration): the profiler slows what runs after it in the process;
  4. the entry point ``attentive_dfprior_tpu_torch.run`` on
     configs/Synthetic/room_tracking.yaml as configured (loop closure on,
     each iteration a graph replay, as in every single-process path below)
     with panels every 5th frame, frames 0..15 (tracks 1-15, maps 0, 5, 10
     and 15, relaxes the keyframes at 15, refines frames 1-15, writes the
     final meshes): losses, loop-closure records, aligned and unaligned
     ATE, seconds by part, panels per directory against the count the
     gates give; then ``--resume --end_idx 18``, which must start at frame
     16 and write checkpoint 00017; K5's launches equal the frames the two
     runs' priors fused, and the prior fused again through K5 and through
     its plain version on the card is ``torch.equal`` (and to the run's);
     the render programs' captures, replays and pool bytes per run;
  5. ``Renderer.render_img`` of the last mapped frame from the mapped scene
     (K2 on the path), then once more with the plain MLP: depth L1 against
     the sensor depth for both, and the gap between the two renders; the
     graphed render (each chunk a replay, K2 inside) ``torch.equal`` to the
     eager render with the same padding, before and after 10 mapping
     iterations that write the decoders, the gap to the unpadded eager
     render printed, seconds per render graphed and eager in turns (both
     profiled at the very end of the run: kernel time summed, kernels a
     chunk); (b)
     the same with ``rendering.N_importance=16`` (the resampled second
     pass through the same decoder path), same gates, and with
     ``perturb=1.0`` the graphed render ``torch.equal`` to the eager one;
  6. determinism: frame 0's map of room_tracking.yaml (its three stages at
     250 of the config's 1000 iterations, the prior fused from every 10th
     frame)
     twice graphed and twice eager from one scene and generator state, with
     PyTorch's default kernels: fails unless each pair's per-iteration
     losses and final scene leaves are ``torch.equal``; graphed against
     eager printed;
  7. the Mesher: ``SLAMSystem.get_mesh`` on phase 4's map (K2 on the path),
     graphed and eager with the same padding (equal occupancies over the
     whole lattice and equal meshes, or the phase fails), then with the
     plain MLP: field-query and host seconds, and
     accuracy / completion / ratio against the synthetic GT mesh culled to
     frames 0-15 (printed, no gate; ``tools/eval_synthetic_demo.py``'s
     scorer, as are phases 9 and 12's);
  8. (only on request) the whole configs/Synthetic/room.yaml run (80
     frames, GT poses) scored by ``tools/eval_synthetic_demo.py``;
     gate: accuracy <= 2.2 cm, completion <= 2.0 cm, ratio >= 94 %;
  9. (only on request) the whole configs/Synthetic/room_tracking.yaml run
     as shipped (120 frames, seed 0, loop closure, panels at the config's
     gates): aligned ATE with the per-frame error quartiles and maximum,
     loop-closure records, seconds by part, and ``final_mesh_eval_rec.ply``
     scored against the GT culled to all 120 poses (printed, no gate);
     gate: aligned ATE <= 4.5 cm;
 10. the async modes: (a) frames 0..10 of room_tracking.yaml with GT poses
     (``tracking.gt_camera=True``, so the tracker draws nothing and loop
     closure is off), ``mapping.iters_first=100``, the prior fused from every
     10th frame, under ``strict``, ``loose`` and ``free`` in a child process
     under ``torch.use_deterministic_algorithms``: the three final
     checkpoints' scene leaves must be ``torch.equal`` (a missing stream
     synchronization between the mapper's stream and the tracker's shows
     here); (b) ``sync_method=loose`` through the entry point on frames
     0..15 as phase 4 runs it, the final refine cut to 20 iterations a
     frame: events by kind, publishes, loop closure records, ATE, wall
     seconds, ``run()`` seconds without loop closure and the median interval
     between tracked frames beside phase 4's strict run; gates as phase 4's (the
     unaligned ATE, a ``loop_relax`` and a ``loop_final_refine``, the
     panels) plus every frame strict maps mapped, K1 and K2 launched, K5
     once per frame fused, and at most 3 render and field-query captures a
     thread whatever the publishes;
 11. (only on request) the whole room_tracking.yaml under ``loose``, as
     phase 9 runs it: aligned ATE and seconds by part (printed, no gate);
 12. configs/Replica/room0.yaml through the file-backed entry point at its
     full width: in a fresh working directory (links to the repo's
     ``configs/`` and ``pretrained/``, no prior cache), a Replica-layout
     fixture of frames 0..5 of room_tracking.yaml's trajectory rendered at
     room0's 680x1200 camera (``results/frame*.jpg`` written with OpenCV,
     ``results/depth*.png`` uint16 depth x 6553.5, ``traj.txt`` OpenCV
     c2w), read back through ``Replica`` (depth and poses exact, colour mean
     abs error at most 2/255); the TSDF builder's CLI with
     ``--input_folder`` (room0's prior, voxel 4/256 m, every frame; K5 once
     per frame; its peak device memory beside PR 13's eager fusion); then
     ``attentive_dfprior_tpu_torch.run`` with ``--input_folder``, panels
     every 5th frame, the first map cut to 250 of its 1500 iterations:
     tracks 1-5, maps 0 and 5. Fails on a
     non-finite loss, another mapping schedule, a prior not loaded from the
     builder's cache, no K1 or K2 launch, K6 launches other than the maps
     with frustum selection (the colour refinement has none), or unaligned
     ATE above 10 cm;
     prints aligned ATE, seconds by part, peak device memory and the mesh's
     accuracy / completion / ratio against the synthetic GT;
 13. the loaders and tools: (a) a ScanNet-layout fixture of 3 frames at
     configs/ScanNet/scene0000.yaml's 480x640 camera read back through
     ``ScanNet`` (460x620 after ``crop_edge`` 10, depth and poses exact);
     (b) ``tools/pretrain_decoders.py`` at its shipped widths for 100 steps
     (finite losses, the last below the first, two K1 launches a step, the
     ``.npz`` through ``load_pretrained_npz``; each step one graph replay), then
     20 steps graphed and eager from one seed, ``torch.equal`` in every loss
     and final leaf, and the 100 steps timed graphed and eager in turns, 4
     reps each; (c) ``tools/evaluate_scannet.py``
     ``refuse`` on the card: the synthetic GT mesh re-fused along phase 12's
     poses against the GT surface those poses see (recall at least 0.95,
     completion at most 1 cm; accuracy, precision and F-score printed, as
     the JAX package's face rule keeps faces at the frusta's sides, ROADMAP
     F10), and phase 12's mesh re-fused and scored (printed), K5 once per
     frame fused; (d)
     ``tools/convert_reference_ckpt.py`` on a reference-layout ``.tar`` of
     phase 12's scene, loaded back through ``load_checkpoint`` leaf for leaf;
 14. (only on request) ``tools/pretrain_decoders.py`` whole (6000 steps),
     then the contract of tests/test_pretrained_prior.py on the card: p99
     |occ| under 1.9 with every feature channel kicked by +-0.5, and the
     first-frame low-stage loss at lr 0.5 below half within 80 iterations
     and off the near-plane plateau;
 15. ray-axis data parallelism (``parallel/sharding.py``): (a) the entry
     point's ``--multihost --init_only`` in a child, a world of one on NCCL;
     (b) room_tracking.yaml with ``data.n_frames=6``, frames 0..5, strict,
     loop closure as shipped, mapping at 100 / 20 iterations, the final
     refine cut to 20 iterations a frame, ``parallel.enable=True``, as two
     ranks on ``cuda:0`` over gloo, as one process, and as a witness (the
     one process with every grid element moved by one ulp), at once: the
     ranks' final scenes and
     trajectories equal, finite losses, K1 in each rank, frame 0's first
     30 map losses within 1e-3 relative of the single run, and frame 0's
     map losses, the tracked and the refined trajectory each within
     max(1e-3 / 5 mm, 10 x the witness's gap) of it; seconds by part
     printed (no speed claim: the ranks share one card, gloo stages
     through host memory). One card shows neither NCCL across devices nor
     scaling;
 16. the async agents across processes, as two gloo ranks on ``cuda:0``
     each, all children at once: (a) phase 10(a)'s runs with
     ``parallel.enable=True`` as strict, loose and free on 2 ranks: every
     rank's final scene ``torch.equal`` to strict's on 2 ranks, rank 1's
     decision log a replay of rank 0's (``slam/schedule.py``), and in the
     logs of loose and free a frame after 5 granted before map 5 (rank 0's
     mapper asks for that grant late, so rank 1, whose own mapper asks
     first, replays an order its timing would not give); (b)
     ``parallel.split: {map: 1, track: 1}`` under loose on frames 0..15 as
     phase 4 runs them (loop closure and the final refine as shipped, no
     panels; the prior built once in the parent): publishes, K1 on the map
     rank, finite losses, the track rank's final scene (the last broadcast)
     equal to the map rank's, the trajectory within 20 cm of phase 4's
     strict run, both ranks' agents graphed; unaligned and aligned ATE
     printed;
 17. the harnesses: (a) ``tools/bench.py --workload scannet`` at 3 reps
     (the ScanNet shape: 5000 rays x 60 mapping iterations over a window
     of 10 random 480x640 frames, 5 x 50 x 1000 tracking rays, a random
     345 M-voxel prior; phase 3 runs the replica workload), graphed and
     eager in turns at 2 reps: its JSON line; fails on a non-finite loss,
     without K1, without peak memory, or without the graphed headline and
     the eager record; both modes' cycles profiled at the end of the run
     (kernel time summed over the cycle, beside 17(a)'s median cycle);
     (b) ``tools/profile_mapping.py``, every row, ``full_iter_color``
     graphed and eager in turns, 2 reps: fails on a non-finite row, unless
     K1 runs in the ``halo`` rows alone and K3 in the ``pallas`` rows
     alone, or if the graphed iteration counts other launches; then the
     two ``cell_scatter_*`` rows (the atomic ``index_add_`` and the ordered
     sum) again at the ScanNet shape's 5000 rays; (c)
     ``tools/bench_scaling.py --devices 1 --pixels 1000,5000 --step-modes
     graph,eager --reps 2`` (a child, a world of one on NCCL; the modes
     timed in turns) and its comm model's prediction for 2, 4 and 8 H100s
     from the graphed step; fails on a non-finite loss, without K1, or when
     the headline did not run graphed;
 18. (only on request) ``tools/ablate_tracking.py --variants base,nodyn
     --end_idx 16`` and ``tools/collect_ablation.py``: each variant's
     aligned ATE (printed, no gate);
 19. graphed against eager, in a child under deterministic algorithms:
     one ``SLAMSystem`` on room_tracking.yaml (frame 0's map cut to 100
     iterations, the prior fused from every 10th frame), its mapper and
     tracker given a fresh ``StepGraphs`` of each mode from the same scene
     and generator state: (a) frame 0's three stages and a BA window of
     frames 0-2 (F = 3), per-iteration losses, every final leaf and BA's
     poses; (b) frames 1-5 tracked from one map, poses and losses; all
     ``torch.equal``; (c) K1's launches, replays counted, equal to eager's;
 20. (only on request, not with phase 6) phase 6's four runs under
     ``torch.use_deterministic_algorithms``, the cuBLAS workspace fixed for
     the process (printed, no gate);
 21. ray-axis dp graphed on NCCL, in a child that joins a world of one
     under deterministic algorithms: phase 19's frame 0 map (100 of 1000
     iterations) and frames 1-5 tracked (``handle_dynamic`` on, so the
     gathered median runs), the mapper and tracker on
     ``RayShards(size=1, ranks=(0,), group=WORLD)``, eager then graphed on
     the group, then graphed with no group: fails unless graphed and eager
     on the group are ``torch.equal`` in map losses, final leaves, tracked
     poses and tracking losses, both agents ran ``graph`` steps with
     captures in ``thread_local`` capture mode, every mapping program
     launches K1 a replay and the all-reduce was captured; prints the gap
     to the run with no group (``torch.equal`` expected) and NCCL's
     version. Two NCCL ranks cannot share one card, so one card shows the
     captured collective on a world of one only.

Phases 15(b) and 16(a) run ray-axis dp over gloo, whose collectives a
graph cannot capture: their ranks run eager steps, and the phases fail
otherwise; phase 16(b)'s split agents, each alone in its group, run
graphed, and the phase fails otherwise.

Every path (each timed variant of phase 3, phases 4, 5, 5(b), 6, 7, 8, 9,
10, 11, 12, 13(b), 13(c), 14, 17(a), 17(b) and 18, phase 20, each of phase 10(a)'s three runs,
each of phase 19's two and phase 21's three, and each of phase 15(b)'s
four processes, phase 16's and phase 17(c)'s, counted in its child process)
runs with the launch
counts set to 0 just before it and read just after (a graph replay adds
the launches its capture holds); the
``kernels`` JSON line reports each kernel's launches over those paths with
its error, time, plain time and bound. The last line is the contract's
``{"ok": true, ...}``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores (NVIDIA data sheet)
PEAK_TF32_FLOPS = 495e12  # H100 SXM, TF32 on the tensor cores, dense
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
ROOM_TRACKING = os.path.join(REPO, "configs", "Synthetic", "room_tracking.yaml")
ROOM = os.path.join(REPO, "configs", "Synthetic", "room.yaml")
ROOM_GATE = {"accuracy_cm": 2.2, "completion_cm": 2.0, "completion_ratio_pct": 94.0}
RENDER_GAP_M = 1e-6  # K2 vs plain MLP render, mean depth gap: ~25x what an H100 reads (3.2e-8, 4.1e-8 m)
ENTRY_END = 16  # phase 4 runs frames 0..15: at 15, keyframe 0 is loop_closure.min_gap frames old
PANELS_EVERY_5 = ["--set", "mapping.vis_freq=5", "--set", "tracking.vis_freq=5"]
ATE_GATE_CM = 4.5  # phase 9, aligned: between the JAX package's 2.871 cm with loop closure and 5.82 without (TPU)
# phases 10(a) and 16(a) run frames 0..10: maps 0, 5 and 10, and map 5 runs while frames 6.. are tracked;
# the first map cut from 200 iterations to 100 (1000 as shipped) to pay for map 10
ASYNC_EQUAL_END = 11
ASYNC_EQUAL_SET = ["tracking.gt_camera=True", "mapping.iters_first=100", "tsdf.space=10"]
OVERLAP_MAP = 5  # 16(a): a frame after it is granted before its map (``late_map_grant``)
LOOSE_REFINE_ITERS = 20  # phase 10(b)'s final refine, cut from 100 to keep the default run near 800 s
CHILD_TAG = "ASYNC_EQUAL "  # the prefix of phase 10(a)'s result line in the child's output
REPLICA_ROOM0 = os.path.join("configs", "Replica", "room0.yaml")  # from a working directory linking configs/
SCANNET_SCENE = os.path.join("configs", "ScanNet", "scene0000.yaml")
REPLICA_END = 6  # phase 12: frames 0..5, mapped at 0 and 5 (every_frame 5, the last frame); cut from 16, then 11
REPLICA_ITERS_FIRST = 250  # phase 12's first map: 250 of the config's 1500 iterations (cut for time)
COLOR_MEAN_GATE = 2.0 / 255  # phase 12-13: JPEG at OpenCV's default quality 95
PRETRAIN_STEPS = 100  # phase 13(b): 100 of the tool's 6000 (cut from 500, then 250, for time)
REFUSE_RECALL_GATE, REFUSE_COMP_GATE = 0.95, 0.01  # phase 13(c): the GT re-fused covers what the poses see
IMPORTANCE_N = 16  # phase 5(b): rendering.N_importance
DP_END = 6  # phase 15(b): frames 0..5 (maps 0 and 5, the colour refine at 5, the last frame)
DP_REFINE_ITERS = 20  # phase 15(b)'s final refine, cut from 100 as phase 10(b)'s
# mapping cut from 1000 / 100 iterations to keep the phase near 90 s (1000: 246 s for three children);
# at 100 / 20 the dp and single runs part after some 30 iterations, which the one-ulp witness tests
DP_ITERS_FIRST, DP_ITERS = 100, 20
DP_SET = ["data.n_frames=6", f"loop_closure.refine_iters={DP_REFINE_ITERS}", f"mapping.iters_first={DP_ITERS_FIRST}",
          f"mapping.iters={DP_ITERS}", "parallel.enable=True"]
ASYNC_DP_SET = ASYNC_EQUAL_SET + ["parallel.enable=True"]  # phase 16(a): phase 10(a)'s runs on 2 ranks (the printout)
# phase 16(b) against phase 4's strict run: the JAX split test's 20 cm (tests/test_sharding.py:306)
SPLIT_TRAJ_GATE_M = 0.20
# phase 17(a): the ScanNet shape (phase 3 times the replica workload on the same builder)
# graphed and eager in turns; the default run's depth cuts (this, ROOM0_TURNS, PROFILE_REPS, PRETRAIN_TIMED_REPS,
# SCALING_REPS and DET_SET, from 4 reps and 500 iterations) keep it well inside 1200 s on a slow host
BENCH_WORKLOAD, BENCH_REPS = "scannet", 2
PROFILE_ITERS = 5  # phase 17(b): iterations a timing (10 in the tool's default; cut for time)
PROFILE_REPS = 2  # phase 17(b): timings a row, the graphed and eager iterations in turns
SCANNET_RAYS = 5000  # phase 17(b): the ScanNet shape's rays a mapping iteration, for the cell_scatter rows
# phase 17(b): the rows whose grid gradient runs K1 (K3: the scatter_bwd_pallas_* rows)
PROFILE_HALO_ROWS = ("full_iter_color", "full_iter_color_eager", "fwd_bwd_color", "scatter_bwd_grid_low", "scatter_bwd_grid_high",
                     "scatter_bwd_grid_color", "scatter_bwd_pair_highcolor")
SCALING_PIXELS = "1000,5000"  # phase 17(c): the Replica and ScanNet rays a mapping iteration
ABLATION_VARIANTS, ABLATION_END = "base,nodyn", 16  # phase 18
# phase 19: graphed against eager; frame 0's map cut from 1000 iterations to 100 (as phase 10(a)), then a BA window
GRAPH_EQUAL_SET = ["mapping.iters_first=100", "tsdf.space=10"]
GRAPH_EQUAL_BA_WINDOW = (0, 1, 2)  # frames of the BA window (F = 3; mapped as frame 5, anchored at frame 0)
GRAPH_EQUAL_TRACK = range(1, 6)  # phase 19(b): frames 1-5 tracked from one map
GRAPH_CHILD_TAG = "GRAPH_EQUAL "  # the prefix of phase 19's result line in the child's output
# phase 21 runs phase 19's frame 0 map (GRAPH_EQUAL_SET) and GRAPH_EQUAL_TRACK, as dp on a world of one on NCCL
DP_GRAPH_TAG = "DP_GRAPH "  # the prefix of phase 21's result line in the child's output
PRETRAIN_EQUAL_STEPS = 20  # phase 13(b): the pretrain graphed against eager, torch.equal
PRETRAIN_TIMED_REPS = 2  # phase 13(b): PRETRAIN_STEPS steps a rep, graphed and eager in turns
SCALING_REPS = 2  # phase 17(c): timed stages a mode, graphed and eager in turns
# phases 6 and 20: frame 0's map, twice in each step mode; the prior fused from every 10th frame, the map cut
# from 1000 iterations to 250 for time (at 1000: 110.6 s for the four runs; atomic sums parted at iteration 13)
DET_SET = ["tsdf.space=10", "mapping.iters_first=250"]
ROOM0_TURNS = 1  # phase 3: each variant, then back, this many times: 2 timed reps a variant
K4_TIMED = "room0 colour stage, 8C"  # phase 2: K4's case in the kernels line (K1's shape and width)
PR13_VIS_S = {"strict": 4.586, "loose": 5.294}  # phases 4 and 10(b)'s vis seconds with eager renders (PR 13 call C)
PR13_BUILDER_PEAK_GIB = 23.77  # phase 12's builder with the eager fusion (PR 13 call C)


def check_fusion_launches(paths, name: str, frames: int) -> None:
    """Fail unless the path launched K5 once per frame it fused."""
    got = paths[name]["tsdf_integrate"]
    print(f"{name}: K5 (TSDF integration) launched {got} times for {frames} frames fused")
    if got != frames:
        fail(f"{name}: K5 launched {got} times for {frames} frames fused")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(torch, fn, reps: int = 20, inner: int = 10, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: the median over ``reps`` of one
    CUDA-event pair around ``inner`` back-to-back calls, divided by
    ``inner``. The calls queue on the stream, so the wrapper's host work
    overlaps the device's and the pair reads device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def phase_env(torch, build, kernels):
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    print(f"card: {card}")
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    print(f"tf32 matmul={tf32[0]} cudnn={tf32[1]}")
    if any(tf32):
        fail("TF32 is on")
    t0 = time.perf_counter()
    build.build_all(kernels)
    print(f"build: {time.perf_counter() - t0:.2f} s for {len(kernels)} kernels (parallel nvcc)")
    for k in kernels:
        k.lib()
        ptxas = []  # per entry function: its (mangled) name, then ptxas's lines on it
        for ln in k.build_log.splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", ln)
            if entry:
                ptxas.append(entry.group(1))
            elif "registers" in ln or "spill" in ln or "wgmma" in ln or "arning" in ln:
                ptxas.append(ln.strip())
        print(f"build {k.name}: {k.build_s:.2f} s; " + " | ".join(ptxas))
    from attentive_dfprior_tpu_torch import native

    t0 = time.perf_counter()
    native.lib()
    print(f"build native host library (g++): {time.perf_counter() - t0:.2f} s -> {os.path.basename(native.lib_path())}")
    return card


def phase_kernels(torch, dev):
    from attentive_dfprior_tpu_torch.models.decoders import init_mlp_decoder
    from attentive_dfprior_tpu_torch.ops.cuda import decoder_kernel as K2
    from attentive_dfprior_tpu_torch.ops.cuda import halo_fold_kernel as K1
    from attentive_dfprior_tpu_torch.ops.cuda import stencil_kernel as K3
    from attentive_dfprior_tpu_torch.tools import profile_scatter as PS
    from attentive_dfprior_tpu_torch.utils.tree import tree_map

    g = torch.Generator(device=dev).manual_seed(0)
    rec = {}

    # ---- K1: bit-identical to the plain fold ----
    # odd shapes; room_tracking's low / high / high+color pair grids (the
    # entry point's path); room0's low, high and pair grids (the cycle's and
    # phase 12's); the pretrain's low and high grids (phase 13(b), 14)
    k1 = {"max_abs_err": 0.0}
    shapes = [(9, 5, 7, 3), (33, 6, 5, 4), (14, 11, 14, 32), (28, 22, 28, 32), (28, 22, 28, 64),
              (37, 28, 22, 32), (74, 56, 44, 32), (74, 56, 44, 64), (12, 12, 12, 32), (24, 24, 24, 32)]
    for shape in shapes:
        nx, ny, nz, C = shape
        cells = torch.randn((nx * ny * nz, 8 * C), generator=g, device=dev)
        out = K1.cell_fold_halo(cells, shape)
        ref = K1.cell_fold_plain(shape, cells)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        k1["max_abs_err"] = max(k1["max_abs_err"], err)
        if not torch.equal(out, ref):
            fail(f"K1 halo fold differs from the plain fold at {shape}: max abs err {err}")
        line = f"K1 {shape}: torch.equal ok"
        if nx == 74:
            ms = time_ms(torch, lambda: K1.cell_fold_halo(cells, shape))
            plain_ms = time_ms(torch, lambda: K1.cell_fold_plain(shape, cells))
            lib = PS.measure_fold(cells, shape, out)  # one conv_transpose3d, held to K1 at rtol 1e-4 / atol 1e-5
            nbytes = nx * ny * nz * 9 * C * 4
            bound_ms = nbytes / PEAK_BYTES * 1e3
            line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library (conv_transpose3d) "
                     f"{lib['library_ms']:.4f} ms (max abs err vs K1 {lib['max_abs_err_vs_K1']:.3e}), bound "
                     f"{bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB)")
            k1[f"C{C}"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, library_ms=lib["library_ms"])
        print(line, flush=True)
    rec["K1"] = k1

    # ---- K2: within rtol 1e-4 / atol 1e-5 of the plain MLP ----
    # N = 1, 63, 65 and 2^17 + 37 end in a partial 64-point tile; 2^17 is the
    # Mesher's chunk, 480,000 the render's batch (both timed). Bounds: the
    # MLP's fp32 FLOPs x 3 (three TF32 products each) at the TF32 tensor-core
    # peak, and the FLOPs at the fp32 FMA peak (the ceiling of any kernel
    # without tensor cores); bytes (inputs and output once) bound neither.
    k2 = {"max_abs_err": 0.0}
    # K2's own arithmetic, bit for bit, on every float it may meet: its
    # branch-free sinf against sinf (|a| < 105615; above, the kernel calls
    # sinf), its integer TF32 rounding against cvt.rna.tf32 (finite floats);
    # and a control that the check sees differences: above 105615 the
    # branch-free sinf is wrong
    t0 = time.perf_counter()
    sin_bad = sum(K2.self_check(dev, 0, sign, K2.SIN_FAST_BITS) for sign in (0, 0x80000000))
    tf32_bad = sum(K2.self_check(dev, 1, sign, K2.FINITE_BITS) for sign in (0, 0x80000000))
    control = K2.self_check(dev, 0, K2.SIN_FAST_BITS, 0x4B000000 - K2.SIN_FAST_BITS)
    print(f"K2 arithmetic vs CUDA's, bit for bit: branch-free sinf on all {2 * K2.SIN_FAST_BITS} floats "
          f"with |a| < 105615: {sin_bad} differ; integer TF32 rounding on all {2 * K2.FINITE_BITS} finite "
          f"floats: {tf32_bad} differ; control (branch-free sinf on 105615 <= a < 2^23): {control} differ "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)
    if sin_bad or tf32_bad or not control:
        fail("K2's own sinf or TF32 rounding differs from CUDA's, or the check saw nothing")
    smem = {c_dim: K2.smem_bytes(c_dim) for c_dim in (32, 64)}
    limit = getattr(torch.cuda.get_device_properties(dev), "shared_memory_per_block_optin", "not reported")
    print(f"K2 dynamic shared memory per CTA: c=32 {smem[32]} B, c=64 {smem[64]} B (opt-in limit {limit} B)")
    # through the main path's wrapper (fused_decoder_forward: the image from
    # TC_CACHE); at N = 65 also through fused_mlp_forward, which must match
    # it bit for bit; and once with half the points scaled by 1e3, where the
    # embedding's arguments pass 105615 and the kernel takes sinf
    for c_dim, color in [(32, False), (64, False), (32, True)]:
        params = init_mlp_decoder(torch.Generator().manual_seed(c_dim + color), c_dim=c_dim, color=color)
        params = tree_map(lambda t: t.to(dev), params)
        packed = K2.pack_mlp_params(params)
        out_dim = 4 if color else 1
        for n, far in [(1, False), (63, False), (65, False), (2**17, False), (2**17 + 37, False),
                       (480_000, False), (4097, True)]:
            p = torch.randn((n, 3), generator=g, device=dev)
            if far:
                p[: n // 2] *= 1e3
            c = torch.randn((n, c_dim), generator=g, device=dev)
            out = K2.fused_decoder_forward(params, p, c)
            ref = K2.fused_mlp_plain(packed, p, c)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            k2["max_abs_err"] = max(k2["max_abs_err"], err)
            where = f"N={n}{' (half of p x 1e3: sinf)' if far else ''} c={c_dim} out={out_dim}"
            if not torch.allclose(out, ref, rtol=1e-4, atol=1e-5):
                fail(f"K2 decoder MLP differs from the plain MLP at {where}: max abs err {err}")
            line = f"K2 {where}: allclose(rtol 1e-4, atol 1e-5) ok, max abs err {err:.3e}"
            if far:
                big = float(((p[: n // 2] @ params["B"]).abs() >= 105615).float().mean())
                line += f"; {100 * big:.2f} % of the scaled points' arguments >= 105615"
            if n == 65:
                if not torch.equal(K2.fused_mlp_forward(packed, p, c), out):
                    fail(f"K2 through fused_mlp_forward differs from fused_decoder_forward at {where}")
                line += "; fused_mlp_forward torch.equal ok"
            if n in (2**17, 480_000):
                w = K2.TC_CACHE.get(params)  # the main path's cached image, outside the timed calls
                ms = time_ms(torch, lambda: K2.fused_mlp_launch(w, p, c, out_dim))
                plain_ms = time_ms(torch, lambda: K2.fused_mlp_plain(packed, p, c))
                if K2.TC_CACHE.get(params) is not w:
                    fail(f"K2's weight image was rebuilt for unchanged weights at {where}")
                flops = n * 2 * (3 * 93 + 93 * 32 + 3 * 32 * 32 + 125 * 32 + 5 * c_dim * 32 + 32 * out_dim)
                nbytes = n * 4 * (3 + c_dim + out_dim) + 4 * w.numel()
                tc_ms = max(3 * flops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES) * 1e3
                fma_ms = flops / PEAK_FP32_FLOPS * 1e3
                line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, {flops / ms / 1e9:.2f} TFLOP/s; "
                         f"bound {tc_ms:.4f} ms (3xTF32 tensor cores, {100 * tc_ms / ms:.1f} % of it), "
                         f"fp32-FMA ceiling {fma_ms:.4f} ms ({100 * fma_ms / ms:.1f} %); "
                         f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB")
                k2[f"c{c_dim}o{out_dim}n{n}"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=tc_ms)
            print(line, flush=True)
    rec["K2"] = k2

    # ---- K3: bit-identical to its plain version (the TPU kernel's order),
    # within rtol 1e-5 of K1 (same terms, another order) ----
    # odd shapes (nx > 8 and not a multiple of 8; nx, ny or nz = 1);
    # room_tracking's low / high grids; room0's low / high grids. The
    # pallas variant samples every grid on its own, so C is always 32.
    k3 = {"max_abs_err": 0.0, "max_abs_err_vs_K1": 0.0}
    shapes = [(11, 5, 7, 32), (1, 6, 5, 32), (9, 1, 4, 32), (10, 4, 1, 32), (14, 11, 14, 32),
              (28, 22, 28, 32), (37, 28, 22, 32), (74, 56, 44, 32)]
    for shape in shapes:
        nx, ny, nz, C = shape
        cells = torch.randn((nx * ny * nz, 8 * C), generator=g, device=dev)
        out = K3.cell_stencil(cells, shape)
        ref = K3.cell_stencil_plain(shape, cells)
        fold = K1.cell_fold_halo(cells, shape)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        err_k1 = float((out - fold).abs().max())
        k3["max_abs_err"] = max(k3["max_abs_err"], err)
        k3["max_abs_err_vs_K1"] = max(k3["max_abs_err_vs_K1"], err_k1)
        if not torch.equal(out, ref):
            fail(f"K3 cell stencil differs from its plain version at {shape}: max abs err {err}")
        if not torch.allclose(out, fold, rtol=1e-5, atol=1e-6):
            fail(f"K3 cell stencil differs from K1 beyond rtol 1e-5 at {shape}: max abs err {err_k1}")
        line = f"K3 {shape}: torch.equal ok; vs K1 allclose(rtol 1e-5, atol 1e-6) ok, max abs err {err_k1:.3e}"
        if nx == 74:
            ms = time_ms(torch, lambda: K3.cell_stencil_launch(cells, shape))
            plain_ms = time_ms(torch, lambda: K3.cell_stencil_plain(shape, cells))
            lib = PS.measure_fold(cells, shape, fold)
            nbytes = nx * ny * nz * 9 * C * 4
            bound_ms = nbytes / PEAK_BYTES * 1e3
            line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library (conv_transpose3d) "
                     f"{lib['library_ms']:.4f} ms, bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB)")
            k3["C32"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, library_ms=lib["library_ms"])
        print(line, flush=True)
    rec["K3"] = k3

    # ---- the transmittance's cumulative product (ops/compositing.py) ----
    # cumprod_positive leaves out torch.cumprod's backward check for zeros,
    # a host read that no capture allows: its values and gradients must be
    # torch.equal to torch.cumprod's at the main path's sample shapes
    # (tracking 200 and 1000 rays, mapping 1000 and 5000, 1 + 32 + 16
    # samples), opaque samples (alpha = 1) included
    from attentive_dfprior_tpu_torch.ops.compositing import cumprod_positive

    for rays in (200, 1000, 5000):
        alpha = torch.rand((rays, 48), generator=g, device=dev)
        alpha[:, 5::11] = 1.0
        a = torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-10], dim=-1)
        ct = torch.randn(a.shape, generator=g, device=dev)
        x, y = a.clone().requires_grad_(True), a.clone().requires_grad_(True)
        ref, out = torch.cumprod(x, dim=-1), cumprod_positive(y)
        (gx,), (gy,) = torch.autograd.grad(ref, x, ct), torch.autograd.grad(out, y, ct)
        if not (torch.equal(ref, out) and torch.equal(gx, gy)):
            fail(f"cumprod_positive differs from torch.cumprod at {tuple(a.shape)}: values max abs err "
                 f"{float((ref - out).abs().max()):.3e}, gradients {float((gx - gy).abs().max()):.3e}")
    print("cumprod_positive: values and gradients torch.equal to torch.cumprod at (200 | 1000 | 5000, 49)",
          flush=True)

    # ---- K4, the ordered cell scatter: bit-identical to its plain version ----
    # on the card (whose sequential sums are index_put_'s) and on the CPU
    # (index_add_'s), its hand-written sort's permutation torch.equal to
    # torch.sort(stable=True)'s, at odd shapes (a partial chunk, widths off
    # the 256-column tile, a width off 4 floats: the per-lane loads, one
    # index taking every row: a run over many chunks, 2^19 + 1 rows: a 20-bit
    # key in two 10-bit passes) and at the main path's (tools/profile_scatter.py:
    # points along rays into room0's high grid at the colour stage, 8C and the
    # pair's 16C, and ScanNet's); at those, timed eagerly and as a graph
    # replay beside the library call (zeros + atomic index_add_), its device
    # kernels a call from the profiler (at most 3 + its radix passes)
    from attentive_dfprior_tpu_torch.ops.cuda import cell_scatter_kernel as K4

    k4 = {"max_abs_err": 0.0}
    cases = [("odd, partial chunk", 200, torch.randint(0, 200, (1000,), generator=g, device=dev), 24),
             ("one row", 7, torch.full((1,), 3, device=dev), 520),
             ("33 rows", 5, torch.randint(0, 5, (33,), generator=g, device=dev), 256),
             ("every row into one index", 3, torch.full((5000,), 1, device=dev), 520),
             ("width 25", 1000, torch.randint(0, 1000, (3000,), generator=g, device=dev), 25),
             ("2^19 + 1 rows", 2**19 + 1, torch.randint(0, 2**19 + 1, (240_000,), generator=g, device=dev), 32)]
    cases += [(label, shape, cell, 8 * shape[3]) for label, shape, cell in PS.ray_cases(g, dev)]
    for label, where, idx, width in cases:
        nrows = where if isinstance(where, int) else where[0] * where[1] * where[2]
        rows = torch.randn((len(idx), width), generator=g, device=dev)
        out = K4.cell_scatter_sum(nrows, idx, rows)
        plain = K4.cell_scatter_plain(nrows, idx, rows)
        cpu = K4.cell_scatter_plain(nrows, idx.cpu(), rows.cpu())
        atomic = torch.zeros_like(out).index_add_(0, idx, rows)
        scell, spos = K4.cell_sort(nrows, idx)
        ref = torch.sort(idx, stable=True)
        torch.cuda.synchronize()
        if not (torch.equal(scell.long(), ref.values) and torch.equal(spos.long(), ref.indices)):
            fail(f"K4's sort differs from torch.sort(stable=True) at {label}: "
                 f"{int((spos.long() != ref.indices).sum())} of {len(idx)} positions")
        err = float((out - plain).abs().max())
        k4["max_abs_err"] = max(k4["max_abs_err"], err)
        if not (torch.equal(out, plain) and torch.equal(out.cpu(), cpu)):
            fail(f"K4 cell scatter differs from its plain version at {label}: max abs err {err}, on the CPU "
                 f"{float((out.cpu() - cpu).abs().max())}")
        counts = torch.bincount(idx, minlength=nrows)
        line = (f"K4 {label}: {len(idx)} rows x {width} into {nrows} ({int((counts > 0).sum())} taken, the most "
                f"{int(counts.max())} into one; radix passes {K4.sort_plan(nrows)}): the sort torch.equal to "
                f"torch.sort(stable=True), the sum torch.equal to its plain version on the card and on the CPU ok; "
                f"the atomic index_add_ torch.equal to it {torch.equal(atomic, out)} (max abs diff "
                f"{float((atomic - out).abs().max()):.3e})")
        if not isinstance(where, int):
            m = PS.measure_scatter(nrows, idx, rows)
            # the plain version sorts and sums through index_put_ twice: 16-95 ms a call, so fewer reps
            m["plain_ms"] = time_ms(torch, lambda: K4.cell_scatter_plain(nrows, idx, rows), reps=5, inner=2, warmup=1)
            put_ms = time_ms(torch, lambda: K4.sequential_sum(nrows, idx, rows))  # index_put_, sorted, in order
            m["bound_ms"] = PS.scatter_bound_ms(len(idx), width, nrows, PEAK_BYTES)
            most = 3 + len(K4.sort_plan(nrows))
            line += (f"; kernel {m['ms']:.4f} ms eager, {m['graph_ms']:.4f} graphed ({PS.GRAPH_CALLS} calls a "
                     f"graph); library (zeros + index_add_) {m['library_ms']:.4f} eager, "
                     f"{m['library_graph_ms']:.4f} graphed; plain {m['plain_ms']:.4f}, sorted index_put_ "
                     f"{put_ms:.4f}; bound {m['bound_ms']:.4f} ms "
                     f"({(len(idx) * (width * 4 + 8) + nrows * width * 4) / 1e6:.1f} MB); "
                     f"{m['kernels_per_call']:.1f} device kernels a call (at most {most}), "
                     f"{m['device_ms_per_call']:.4f} device ms: "
                     + "; ".join(f"{c:.1f} x {ms:.4f} ms {name[:60]}" for name, (c, ms) in m["pieces"].items()))
            if m["kernels_per_call"] > most:
                fail(f"K4 launched {m['kernels_per_call']} device kernels a call at {label} (at most {most})")
            k4[label] = m
        print(line, flush=True)
    rec["K4"] = k4

    # ---- K5, TSDF integration: bit-identical to its plain version ----
    rec["K5"] = kernel_k5(torch, dev)

    # ---- K6, the frustum masks: bit-identical to its plain version ----
    rec["K6"] = kernel_k6(torch, dev)

    # ---- K7, the trilinear lookup: bit-identical to trilinear_sample ----
    rec["K7"] = kernel_k7(torch, dev)
    return rec


def k5_frame(rng, cam, c2w, depth_range=(0.5, 4.0), zero_rows: int = 0, obs_weight: float = 1.0):
    """One frame for K5's checks: (depth (H, W), colour (H, W, 3) in [0, 255],
    intrinsics (3, 3), w2c (4, 4), obs_weight), numpy float32, depth uniform
    in ``depth_range`` m with its first ``zero_rows`` rows 0, colour values
    up to 255 so that the clamp is reached."""
    H, W = cam["H"], cam["W"]
    depth = rng.uniform(*depth_range, (H, W)).astype(np.float32)
    depth[:zero_rows] = 0.0
    color = np.minimum(rng.uniform(0.0, 300.0, (H, W, 3)), 255.0).astype(np.float32)
    intr = np.array([[cam["fx"], 0.0, cam["cx"]], [0.0, cam["fy"], cam["cy"]], [0.0, 0.0, 1.0]], np.float32)
    w2c = np.linalg.inv(np.asarray(c2w, np.float64)).astype(np.float32)
    return depth, color, intr, w2c, obs_weight


def k5_look(eye, direction):
    """c2w (float64) of a camera at ``eye`` looking along ``direction``
    (OpenCV: +z forward, +y down)."""
    f = np.asarray(direction, np.float64)
    f = f / np.linalg.norm(f)
    up = np.array([0.0, 0.0, 1.0]) if abs(f[2]) < 0.99 else np.array([0.0, 1.0, 0.0])
    r = np.cross(f, up)
    r /= np.linalg.norm(r)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([r, np.cross(f, r), f], axis=1)
    c2w[:3, 3] = eye
    return c2w


K5_OPS_UPDATED = 54  # fp32 operations a voxel the frame updates: 6 to world, 18 to camera, 8 to the pixel, 22 the update


def kernel_k5(torch, dev):
    """K5 (TSDF integration) bit for bit against its plain version on the
    card, at odd volumes with edge-case frames and at room0's and ScanNet's
    volumes; its runs (the cull: ``tsdf_kernel.kept_runs``) equal to the
    plain rule's (``kept_runs_plain``) and holding every voxel each frame
    updated; timed, bounded, its CUDA launches a call counted and its
    allocation measured at the two large ones."""
    from attentive_dfprior_tpu_torch.ops.cuda import tsdf_kernel as K5
    from attentive_dfprior_tpu_torch.tools import bench
    from attentive_dfprior_tpu_torch.tools.profile_scatter import pieces
    from attentive_dfprior_tpu_torch.tsdf.fusion import TSDFVolume

    rec = {"max_abs_err": 0.0}

    def fresh(dims):
        X, Y, Z = dims
        return [torch.full((X, Y, Z), -1.0, device=dev), torch.zeros((X, Y, Z), device=dev),
                torch.zeros((X, Y, Z, 3), device=dev)]

    def on_card(frame, origin):
        depth, color, intr, w2c, ow = frame
        return [torch.as_tensor(a, device=dev) for a in (depth, color, intr, w2c, origin)], ow

    def runs_held(label, dims, voxel, t, updated):
        """The kernel's runs for frame ``t`` against the plain rule's (equal)
        and against ``updated``, the voxels the frame updated (inside);
        returns (columns kept, voxels in the runs)."""
        depth, _, intr, w2c, origin = t
        got = K5.kept_runs(depth, intr, w2c, origin, dims, voxel, 5.0 * voxel)
        want = K5.kept_runs_plain(dims, origin.cpu(), voxel, w2c.cpu(), intr.cpu(), depth.cpu(), 5.0 * voxel)
        got_cpu = got.cpu()
        if not torch.equal(got_cpu, want):
            diff = (got_cpu != want).any(-1)
            where = diff.nonzero()[:3].tolist()
            fail(f"K5 {label}: the kernel's runs differ from kept_runs_plain in {int(diff.sum())} of {diff.numel()} "
                 f"columns, first {where}: kernel {[got_cpu[i, j].tolist() for i, j in where]} plain "
                 f"{[want[i, j].tolist() for i, j in where]}")
        z = torch.arange(dims[2], device=dev, dtype=torch.int32)
        lost = int((updated & ~((z >= got[..., :1]) & (z <= got[..., 1:]))).sum())
        if lost:
            fail(f"K5 {label}: {lost} updated voxels lie outside the kernel's runs")
        length = (got[..., 1] - got[..., 0] + 1).clamp(min=0)
        return int((length > 0).sum()), int(length.sum())

    def case(label, dims, origin, voxel, frames):
        """Both versions from one fresh volume through ``frames``; fails
        unless tsdf, weight and colour are torch.equal, or unless each
        frame's runs are the plain rule's and hold what it updated. Returns
        the K5 volume and (updated, columns kept, voxels kept) of the first
        frame."""
        a, b = fresh(dims), fresh(dims)
        origin = np.asarray(origin, np.float32)
        stats = []
        for frame in frames:
            t, ow = on_card(frame, origin)
            before = a[1].clone()
            K5.integrate(*a, *t, voxel, 5.0 * voxel, ow)
            K5.integrate_frame_plain(*b, *t, voxel, 5.0 * voxel, ow)
            updated = a[1] != before
            del before
            stats.append((int(updated.sum()),) + runs_held(label, dims, voxel, t, updated))
            del updated
        torch.cuda.synchronize()
        bad = []
        for name, x, y in zip(("tsdf", "weight", "color"), a, b):
            err = float((x - y).abs().max())
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            if not torch.equal(x, y):
                diff = (x != y).reshape(-1)
                where = diff.nonzero()[:3].reshape(-1).tolist()
                bad.append(f"{name}: {int(diff.sum())} of {diff.numel()} differ (max abs {err:.3e}; first at flat "
                           f"{where}: K5 {x.reshape(-1)[where].tolist()} plain {y.reshape(-1)[where].tolist()})")
        nvox = int(np.prod(dims))
        print(f"K5 {label}: volume {tuple(dims)} = {nvox / 1e6:.2f} M voxels of {voxel} m, {len(frames)} frame(s) "
              f"of {frames[0][0].shape[0]}x{frames[0][0].shape[1]}, obs_weight {[f[4] for f in frames]}; per frame "
              f"(updated, columns kept, voxels kept): {stats}; runs equal to kept_runs_plain and holding every "
              f"updated voxel; tsdf, weight and colour torch.equal {not bad}", flush=True)
        if bad:
            fail(f"K5 differs from its plain version at {label}: " + "; ".join(bad))
        del b
        return a, stats[0]

    # odd: 25 x 17 x 13, voxel 1/8 m and the camera at the origin looking
    # along +z, so voxels lie behind the camera, on its plane (z = 0) and
    # project onto pixel half-boundaries (u = 4 x / z + 3.5 with x, z
    # multiples of 1/8); two rows of zero depth, an all-zero frame,
    # obs_weight 0.5, three frames in sequence
    rng = np.random.default_rng(5)
    cam = dict(H=8, W=8, fx=4.0, fy=4.0, cx=3.5, cy=3.5)
    eye = np.eye(4)
    moved = np.eye(4)
    moved[:3, 3] = [0.25, -0.125, -0.5]
    odd = (25, 17, 13)
    origin = (-1.5, -1.0, -0.75)
    frames = [k5_frame(rng, cam, eye, (0.1, 2.0), zero_rows=2), k5_frame(rng, cam, moved, (0.1, 2.0), obs_weight=0.5),
              k5_frame(rng, cam, eye, (0.0, 0.0))]
    case("odd volume, edge-case frames, 3 in sequence", odd, origin, 0.125, frames)
    x = origin[0] + np.arange(odd[0]) * 0.125
    z = origin[2] + np.arange(odd[2]) * 0.125
    u = 4.0 * x[:, None] / z[None, z > 0] + 3.5
    print(f"K5 odd volume: {int((u - np.floor(u) == 0.5).sum())} (x, z) voxel columns in front of the camera "
          f"project onto a pixel half-boundary in u, {int((z == 0).sum())} z-plane(s) lie on the camera plane",
          flush=True)
    case("odd volume, obs_weight 0.5, two frames", odd, (-1.4, -0.9, 0.1), 0.1,
         [k5_frame(rng, cam, eye, obs_weight=0.5), k5_frame(rng, cam, moved, obs_weight=0.5)])

    # the cull's edges: a camera inside an odd volume (the camera plane
    # through its columns) looking along a diagonal and along -x; NaN, +inf
    # and zero pixels; depths all beyond the volume; frames that update
    # nothing (looking away, all depth NaN); three frames in sequence at
    # obs_weight 0.5
    cam2 = dict(H=30, W=40, fx=23.7, fy=24.1, cx=19.63, cy=14.41)
    inner = (37, 29, 33)
    o2 = (-1.7, -1.3, -1.6)
    for d in ((1.0, 0.7, 0.4), (-1.0, 0.1, -0.05)):
        case(f"odd volume, camera inside looking along {d}", inner, o2, 0.1,
             [k5_frame(rng, cam2, k5_look((0.13, 0.07, 0.11), d), (0.2, 2.5))])
    depth, color, intr, w2c, ow = k5_frame(rng, cam2, k5_look((0.1, 0.0, -2.4), (0.1, 0.05, 1.0)), (0.3, 3.0))
    depth[::3, ::2] = np.nan
    depth[4:7] = 0.0
    depth[12, 17], depth[20, 5] = np.inf, np.inf
    case("odd volume, NaN / +inf / zero pixels", inner, o2, 0.1, [(depth, color, intr, w2c, ow)])
    case("odd volume, depths beyond the volume", inner, o2, 0.1,
         [k5_frame(rng, cam2, k5_look((0.1, 0.0, -2.4), (0.1, 0.05, 1.0)), (6.0, 9.0))])
    away = k5_look((0.0, 0.0, -2.4), (0.05, -0.02, -1.0))
    nothing = k5_frame(rng, cam2, away, (0.5, 6.0))
    _, (n_upd, n_cols, n_kept) = case("odd volume, looking away: updates nothing", inner, o2, 0.1, [nothing])
    all_nan = k5_frame(rng, cam2, k5_look((0.1, 0.0, -2.4), (0.1, 0.05, 1.0)))
    all_nan[0][:] = np.nan
    _, (n2_upd, n2_cols, n2_kept) = case("odd volume, all depth NaN: updates nothing", inner, o2, 0.1, [all_nan])
    if n_upd or n_kept or n2_upd or n2_kept:
        fail(f"K5: a frame that updates nothing kept {n_kept} / {n2_kept} voxels, updated {n_upd} / {n2_upd}")
    case("odd volume, 3 frames in sequence, obs_weight 0.5", inner, o2, 0.1,
         [k5_frame(rng, cam2, k5_look((0.1 * k, 0.05, -2.4), (0.1, 0.05 * k, 1.0)), (0.5, 3.5), zero_rows=k,
                   obs_weight=0.5) for k in range(3)])

    # the main path's volumes: room0 (phase 12) with a 680x1200 frame, and
    # ScanNet's 345.0 M voxels with a 480x640 frame (the bench's shape),
    # each camera at (2, 1, 0) looking along +z
    for name in ("replica", "scannet"):
        w = bench.WORKLOADS[name]
        bnds = np.asarray(w["bound"], np.float64)
        dims = bench.prior_dims(bnds)
        c2w = np.eye(4)
        c2w[:3, 3] = [2.0, 1.0, 0.0]
        frame = k5_frame(np.random.default_rng(6), w["cam"], c2w)
        label = "room0" if name == "replica" else "scannet"
        a, (updated, cols, kept) = case(f"{label} volume, one frame", dims, bnds[:, 0], bench.VOXEL, [frame])
        t, ow = on_card(frame, bnds[:, 0].astype(np.float32))
        args = (*t, bench.VOXEL, 5.0 * bench.VOXEL, ow)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        K5.integrate(*a, *args)
        torch.cuda.synchronize()
        kernel_alloc = torch.cuda.max_memory_allocated(dev) - base
        ms = time_ms(torch, lambda: K5.integrate(*a, *args))
        prof = pieces(lambda: K5.integrate(*a, *args))
        plain_ms = time_ms(torch, lambda: K5.integrate_frame_plain(*a, *args), reps=5, inner=2, warmup=1)
        # the bound counts what this frame needs: the voxels it updates
        # read and written (20 B each way) with their operations, and the
        # frame read once
        X, Y, Z = dims
        nvox = X * Y * Z
        nbytes = 40 * updated + sum(x.numel() * 4 for x in t)
        ops = K5_OPS_UPDATED * updated
        ops_ms, bytes_ms = ops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        # for continuity, a one-thread-a-voxel design's own work: every
        # voxel projected (32 operations in front of the camera, 12 behind)
        wc = t[3]
        ix = [torch.arange(n, device=dev, dtype=torch.float32) * bench.VOXEL + float(o)
              for n, o in zip(dims, bnds[:, 0].astype(np.float32))]
        cz = (wc[2, 0] * ix[0].view(X, 1, 1) + wc[2, 1] * ix[1].view(1, Y, 1)) + wc[2, 2] * ix[2].view(1, 1, Z)
        front = int(((cz + wc[2, 3]) > 0).sum())
        del cz
        old_ops = 32 * front + 12 * (nvox - front) + 22 * updated
        old_ms = max(old_ops / PEAK_FP32_FLOPS * 1e3, bytes_ms)
        del a
        torch.cuda.empty_cache()
        # through the builder's entry (TSDFVolume.integrate, frame from host
        # numpy): the peak above the volume, which must stay within the
        # frame's inputs plus 64 MiB
        vol = TSDFVolume(bnds, bench.VOXEL, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        depth, color, intr, _, _ = frame
        vol.integrate(color, depth, intr, c2w)
        torch.cuda.synchronize()
        entry_alloc = torch.cuda.max_memory_allocated(dev) - base
        frame_bytes = depth.nbytes + color.nbytes + intr.nbytes + 16 * 4 + 3 * 4
        del vol
        torch.cuda.empty_cache()
        bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
        print(f"K5 {label}: kernel {ms:.4f} ms (CUDA events), device {prof['device_ms_per_call']:.4f} ms in "
              f"{prof['kernels_per_call']:.1f} CUDA launches a call (" + "; ".join(
                  f"{c:.1f} x {d:.4f} ms {n[:40]}" for n, (c, d) in prof["pieces"].items()) + f"); plain "
              f"{plain_ms:.4f} ms ({plain_ms / ms:.1f}x); bound {bound_ms:.4f} ms by {bound_by} (bytes "
              f"{nbytes / 1e6:.1f} MB: {bytes_ms:.4f} ms; operations {ops / 1e9:.3f} G: {ops_ms:.4f} ms at 67 "
              f"TFLOP/s), {100 * bound_ms / ms:.1f} % of it; the one-thread-a-voxel design's operations (every voxel projected, "
              f"{front} of {nvox} in front of the camera) {old_ops / 1e9:.2f} G, {old_ms:.4f} ms; {updated} voxels "
              f"updated ({100 * updated / nvox:.2f} %), {cols} of {X * Y} columns kept, {kept} voxels in their runs "
              f"({100 * kept / nvox:.2f} %, {kept / max(updated, 1):.2f} a voxel updated); allocated by the kernel's "
              f"call {kernel_alloc} B, by TSDFVolume.integrate {entry_alloc} B (the frame's inputs {frame_bytes} B); "
              f"library: none, no single PyTorch call computes it", flush=True)
        if kernel_alloc != 0:
            fail(f"K5 allocated {kernel_alloc} B at {label} (expected none)")
        if entry_alloc > frame_bytes + 64 * 2**20:
            fail(f"TSDFVolume.integrate allocated {entry_alloc} B at {label}, above the frame's {frame_bytes} B "
                 f"+ 64 MiB")
        if prof["kernels_per_call"] != K5.LAUNCHES_PER_CALL:
            fail(f"K5 made {prof['kernels_per_call']} CUDA launches a call at {label} "
                 f"(expected {K5.LAUNCHES_PER_CALL})")
        rec[label] = dict(ms=ms, device_ms=prof["device_ms_per_call"], cuda_launches=prof["kernels_per_call"],
                          plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, every_voxel_design_ms=old_ms,
                          updated=updated, columns_kept=cols, voxels_kept=kept, voxels=nvox,
                          kernel_alloc=kernel_alloc, entry_alloc=entry_alloc)
    return rec


K6_FRAMES = 8  # phase 2: seeded frames a configuration, beside the rule's edges


def k6_look(eye, forward):
    """c2w (float32) of a camera at ``eye`` looking along ``forward`` in the
    mapper's convention (the camera looks along its -z)."""
    f = np.asarray(forward, np.float64)
    f = f / np.linalg.norm(f)
    up = np.array([0.0, 0.0, 1.0]) if abs(f[2]) < 0.95 else np.array([0.0, 1.0, 0.0])
    r = np.cross(f, up)
    r /= np.linalg.norm(r)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([r, np.cross(r, f), -f], axis=1)
    c2w[:3, 3] = eye
    return c2w.astype(np.float32)


def k6_frames(rng, cam, bound):
    """K6's frames at one configuration: (label, c2w, depth) for
    ``K6_FRAMES`` seeded poses inside the bound with zero-depth patches,
    then the rule's edges: an all-zero frame, NaN and +inf pixels, a camera
    inside the lattice with every sample zero (the distance rule), one
    facing out of the bound, a NaN in the pose."""
    H, W = cam.H, cam.W
    mid = bound.mean(axis=1)
    out = []
    for i in range(K6_FRAMES):
        eye = bound[:, 0] + rng.uniform(0.1, 0.9, 3) * (bound[:, 1] - bound[:, 0])
        d = rng.standard_normal(3) * np.array([1.0, 1.0, 0.3])
        depth = rng.uniform(0.3, 6.0, (H, W)).astype(np.float32)
        for _ in range(3):
            v, u = rng.integers(0, H), rng.integers(0, W)
            depth[v: v + rng.integers(5, H // 3), u: u + rng.integers(5, W // 3)] = 0.0
        out.append((f"seeded frame {i}", k6_look(eye, d), depth))
    depth = rng.uniform(0.3, 6.0, (H, W)).astype(np.float32)
    out.append(("all-zero depth", k6_look(mid, (0.2, 1.0, -0.1)), np.zeros_like(depth)))
    odd = depth.copy()
    odd[::7, ::5] = np.nan
    odd[3, 11] = odd[100, 50] = np.inf
    out.append(("NaN / +inf pixels", k6_look(mid, (-1.0, 0.2, 0.0)), odd))
    out.append(("camera inside, every sample zero", k6_look(mid + 0.013, (0.0, 0.0, 1.0)), np.zeros_like(depth)))
    eye = mid.copy()
    eye[0] = bound[0, 1] - 0.1
    out.append(("facing out of the bound", k6_look(eye, (1.0, 0.05, 0.02)), depth))
    nan_pose = k6_look(mid, (1.0, 0.0, 0.0))
    nan_pose[0, 1] = np.nan
    out.append(("NaN in the pose", nan_pose, depth))
    return out


def kernel_k6(torch, dev):
    """K6 (the mapper's frustum masks) at room0's and ScanNet's grids, on
    the same frames: bit for bit its plain version (``frustum_masks_plain``)
    and voxel for voxel ``get_frustum_mask`` (numpy, the CPU route), every
    voxel of every grid buffer written; timed by CUDA events (median of
    20) beside the numpy masks' host ms and its bound, the card route's
    host ms as the mapper runs it (the depth to the card, the packing, the
    launch), its CUDA launches a call counted by the profiler (2)."""
    from attentive_dfprior_tpu_torch.camera import Camera
    from attentive_dfprior_tpu_torch.config import default_config_path, load_config
    from attentive_dfprior_tpu_torch.models.scene import grid_shape, load_bound
    from attentive_dfprior_tpu_torch.ops.cuda import frustum_kernel as K6
    from attentive_dfprior_tpu_torch.slam.mapper import get_frustum_mask
    from attentive_dfprior_tpu_torch.tools.profile_scatter import pieces

    rec = {}
    for label, path in (("room0", REPLICA_ROOM0), ("scannet", SCANNET_SCENE)):
        cfg = load_config(os.path.join(REPO, path), default_config_path())
        cam, bound = Camera.from_config(cfg), load_bound(cfg)
        shapes = [grid_shape(bound, cfg["grid_len"][k]) for k in ("low", "high", "color")]
        kept = []
        for name, c2w, depth in k6_frames(np.random.default_rng(19), cam, bound):
            packed = K6.pack(c2w, shapes, bound, cam)
            outs = [torch.full(s, 7.0, device=dev) for s in shapes]  # not a mask value: every voxel must be written
            K6.frustum_masks(packed, torch.as_tensor(depth, device=dev), outs)
            plain = K6.frustum_masks_plain(packed, torch.from_numpy(depth))
            for s, got, want in zip(shapes, outs, plain):
                got = got.cpu()
                if not torch.equal(got, want):
                    diff = (got != want).reshape(-1)
                    where = diff.nonzero()[:3].reshape(-1).tolist()
                    fail(f"K6 {label}, {name}: {int(diff.sum())} of {diff.numel()} voxels of grid {s} differ from "
                         f"frustum_masks_plain, first at flat {where}: K6 {got.reshape(-1)[where].tolist()} plain "
                         f"{want.reshape(-1)[where].tolist()}")
                ref = get_frustum_mask(c2w, s, bound, depth, cam)
                n = int((got.numpy().astype(bool) != ref).sum())
                if n:
                    fail(f"K6 {label}, {name}: {n} of {ref.size} voxels of grid {s} differ from get_frustum_mask")
            kept.append(f"{name} {100 * float(outs[1].mean()):.2f} %")
        print(f"K6 {label}: grids {shapes} ({len(packed.groups)} lattices); {len(kept)} frames, each torch.equal to "
              f"frustum_masks_plain and voxel for voxel get_frustum_mask; high grid kept: " + ", ".join(kept),
              flush=True)

        # timed at a seeded frame
        _, c2w, depth = k6_frames(np.random.default_rng(20), cam, bound)[0]
        packed = K6.pack(c2w, shapes, bound, cam)
        d = torch.as_tensor(depth, device=dev)
        outs = [torch.empty(s, device=dev) for s in shapes]
        call = lambda: K6.frustum_masks(packed, d, outs)  # noqa: E731
        issued_ms = time_ms(torch, call)  # the wrapper's host work is longer than the kernel: this reads the host
        queued = []  # the calls queued behind a sleep, so the events read the device alone
        for _ in range(20):
            torch.cuda._sleep(2_000_000)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                call()
            end.record()
            end.synchronize()
            queued.append(start.elapsed_time(end) / 10)
        ms = float(np.median(queued))
        prof = pieces(call)
        host = []  # the mapper's card route on the host clock, as the Mapper.frustum_masks span reads it
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            d.copy_(torch.from_numpy(depth))
            K6.frustum_masks(K6.pack(c2w, shapes, bound, cam), d, outs)
            host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        numpy_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            for s in shapes:
                get_frustum_mask(c2w, s, bound, depth, cam)
            numpy_ms.append((time.perf_counter() - t0) * 1e3)
        points = sum(int(np.prod(s)) for s in shapes)
        computed = sum(int(np.prod(packed.dims[i])) for i in range(len(packed.groups)))
        nbytes = depth.nbytes + 4 * points  # the frame read once, every grid's mask written
        bound_ms = nbytes / PEAK_BYTES * 1e3
        print(f"K6 {label}: kernel {ms:.4f} ms (CUDA events around 10 calls queued behind a sleep, median of 20; "
              f"{issued_ms:.4f} ms a call as the host issues them), device {prof['device_ms_per_call']:.4f} ms "
              f"in {prof['kernels_per_call']:.1f} CUDA launches a call (" + "; ".join(
                  f"{c:.1f} x {t:.4f} ms {n[:40]}" for n, (c, t) in prof["pieces"].items()) + f"); {points} lattice "
              f"points written, {computed} computed; bound {bound_ms:.4f} ms by bytes ({nbytes / 1e6:.2f} MB at "
              f"3.35 TB/s), {100 * bound_ms / ms:.1f} % of it; the card route on the host (depth to the card, "
              f"packing, launch) {float(np.median(host)):.3f} ms (median of 20); numpy get_frustum_mask for the three "
              f"grids {float(np.median(numpy_ms)):.1f} ms host (median of 5, {np.median(numpy_ms) / ms:.0f}x)",
              flush=True)
        if prof["kernels_per_call"] > K6.LAUNCHES_PER_CALL:  # the profiler can drop a launch of a few us, never add one
            fail(f"K6 made {prof['kernels_per_call']} CUDA launches a call at {label} "
                 f"(at most {K6.LAUNCHES_PER_CALL})")
        rec[label] = dict(ms=ms, issued_ms=issued_ms, device_ms=prof["device_ms_per_call"],
                          cuda_launches=prof["kernels_per_call"],
                          plain_ms=float(np.median(numpy_ms)), route_host_ms=float(np.median(host)),
                          bound_ms=bound_ms, points=points, computed=computed)
    return rec


# K7's grids (nx, ny, nz, C): room0's low and high (= colour) grids, ScanNet's high grid
K7_GRIDS = {"room0 low": (37, 28, 22, 32), "room0 high": (74, 56, 44, 32), "scannet high": (82, 86, 48, 32)}
# points a lookup: a tracking iteration (200 rays), a room0 mapping iteration (1000 rays),
# a ScanNet one (5000 rays), a render chunk (10,000 rays); 48 samples a ray
K7_POINTS = (9_600, 48_000, 240_000, 480_000)


def k7_points(torch, g, dev, n: int):
    """``n`` normalized points in ray order (48 samples a ray, as the render
    and the mapper lay them out): seeded rays from inside the grid that
    leave [-1, 1]^3 (clamped to the border), with points set on a border
    plane (every 97th and 98th), on the grid's centre node (every 89th) and
    on a corner node (every 91st), and scaled far outside (every 83rd)."""
    rays = -(-n // 48)
    o = torch.rand((rays, 1, 3), generator=g, device=dev) * 1.6 - 0.8
    d = torch.randn((rays, 1, 3), generator=g, device=dev)
    d = d / d.norm(dim=-1, keepdim=True)
    t = torch.linspace(0.02, 1.9, 48, device=dev)[None, :, None]
    p = (o + t * d).reshape(-1, 3)[:n].contiguous()
    p[::97, 0] = 1.0
    p[1::98, 1] = -1.0
    p[2::89] = 0.0
    p[3::91] = torch.tensor([-1.0, 1.0, -1.0], device=dev)
    p[4::83] *= 3.0
    return p


class PlainLookup:
    """The samplers' forward patched back to ``trilinear_sample`` (the
    forward before K7) for this script's comparisons; the port has no
    switch."""

    def __enter__(self):
        from attentive_dfprior_tpu_torch.ops import grid_sample as gs

        self.gs, self.saved = gs, (gs.trilinear_gather, gs.trilinear_gather_pair)
        gs.trilinear_gather = gs.trilinear_sample
        gs.trilinear_gather_pair = lambda a, b, p: (gs.trilinear_sample(a, p), gs.trilinear_sample(b, p))
        return self

    def __exit__(self, *exc):
        self.gs.trilinear_gather, self.gs.trilinear_gather_pair = self.saved


def k7_paths(torch, dev):
    """One render chunk (10,000 rays, K2 on) and one colour-stage mapping
    iteration (1000 rays, eager) on room0's scene (``tools/bench.py``'s
    replica workload), each through the production path and with the plain
    forward patched in: their outputs ``torch.equal``; K7's launches on
    each. Returns {path: (launches with K7, launches plain)}."""
    from attentive_dfprior_tpu_torch.models.scene import init_scene
    from attentive_dfprior_tpu_torch.ops.adam import adam_init
    from attentive_dfprior_tpu_torch.ops.cuda import trilinear_kernel as K7
    from attentive_dfprior_tpu_torch.render.renderer import render_rays
    from attentive_dfprior_tpu_torch.slam.mapper import StageLRs, mapping_stage
    from attentive_dfprior_tpu_torch.tools import bench
    from attentive_dfprior_tpu_torch.utils.tree import tree_leaves

    wl = bench.build_workload("replica", dev)
    g = torch.Generator(device=dev).manual_seed(71)
    rays = 10_000
    ro = wl.c2ws[0, :3, 3].expand(rays, 3).contiguous()
    rd = torch.randn((rays, 3), generator=g, device=dev)
    gd = torch.rand((rays,), generator=g, device=dev) * 3.5 + 0.5
    lrs = StageLRs(decoders=5e-3, mlp=5e-3, low=5e-3, high=5e-3, color=5e-3)
    pixs = bench.WORKLOADS["replica"]["pixels"] // wl.colors.shape[0]

    def render():
        scene = init_scene(torch.Generator().manual_seed(0), wl.scene_cfg, device=dev)
        with torch.no_grad():
            return render_rays(scene, ro, rd, gd, wl.tsdf, wl.bound, wl.bound, "color", wl.rcfg, fused=True)

    def map_iter():
        scene = init_scene(torch.Generator().manual_seed(0), wl.scene_cfg, device=dev)
        for t in tree_leaves(scene):
            t.requires_grad_(True)
        loss = mapping_stage(scene, adam_init(scene), wl.colors, wl.depths, wl.c2ws, None, wl.tsdf, wl.bound,
                             wl.bound, 1, [0.0], lrs, "color", pixs, wl.cam, wl.rcfg, (False, False), 0.2,
                             generator=torch.Generator(device=dev).manual_seed(2))
        return [loss] + [t.detach() for t in tree_leaves(scene)]

    counts = {}
    for name, fn in (("render chunk", render), ("colour mapping iteration", map_iter)):
        before = K7.KERNEL.launches
        got = fn()
        torch.cuda.synchronize()
        with_k7 = K7.KERNEL.launches - before
        with PlainLookup():
            before = K7.KERNEL.launches
            want = fn()
            torch.cuda.synchronize()
            plain = K7.KERNEL.launches - before
        equal = [torch.equal(a, b) for a, b in zip(got, want)]
        print(f"K7 {name} through the production path: {sum(equal)} of {len(equal)} outputs torch.equal to the "
              f"plain forward's; K7 launches {with_k7} (plain forward: {plain})", flush=True)
        if not all(equal):
            fail(f"K7: the {name} differs from the same with the plain forward")
        if with_k7 <= 0 or plain != 0:
            fail(f"K7: the {name} launched K7 {with_k7} times (plain forward: {plain}); expected > 0 (0)")
        counts[name] = (with_k7, plain)
    return counts


def kernel_k7(torch, dev):
    """K7 bit for bit against ``trilinear_sample`` at the cells' grids and
    points, single and pair; the production paths (``k7_paths``); timings
    at the main path's shapes beside the bound, the plain function and one
    ``F.grid_sample``."""
    import torch.nn.functional as F

    from attentive_dfprior_tpu_torch.ops import grid_sample as gs
    from attentive_dfprior_tpu_torch.ops.cuda import trilinear_kernel as K7

    g = torch.Generator(device=dev).manual_seed(7)
    rec = {"paths": k7_paths(torch, dev)}
    for label, shape in K7_GRIDS.items():
        a = torch.randn(shape, generator=g, device=dev)
        b = torch.randn(shape, generator=g, device=dev)
        for n in K7_POINTS:
            p = k7_points(torch, g, dev, n)
            ref_a, ref_b = gs.trilinear_sample(a, p), gs.trilinear_sample(b, p)
            single = K7.trilinear_gather(a, p)
            pa, pb = K7.trilinear_gather_pair(a, b, p)
            torch.cuda.synchronize()
            for what, out, ref in (("single", single, ref_a), ("pair, first", pa, ref_a), ("pair, second", pb, ref_b)):
                if not torch.equal(out, ref):
                    fail(f"K7 {what} differs from trilinear_sample at {label} {shape}, N = {n}: "
                         f"{int((out != ref).sum())} of {out.numel()} values, max abs err "
                         f"{float((out - ref).abs().max()):.3e}")
        print(f"K7 {label} {shape}: single and pair torch.equal to trilinear_sample at N = "
              f"{', '.join(str(n) for n in K7_POINTS)}", flush=True)

    # timings: (label, grid, points, grids a launch)
    for label, grid, n, pair in (("render low", "room0 low", 480_000, False),
                                 ("render high+colour", "room0 high", 480_000, True),
                                 ("render high", "room0 high", 480_000, False),
                                 ("map high+colour", "room0 high", 48_000, True),
                                 ("track high+colour", "room0 high", 9_600, True),
                                 ("scannet high+colour", "scannet high", 240_000, True)):
        shape = K7_GRIDS[grid]
        a = torch.randn(shape, generator=g, device=dev)
        b = torch.randn(shape, generator=g, device=dev)
        p = k7_points(torch, g, dev, n)
        if pair:
            ms = time_ms(torch, lambda: K7.trilinear_gather_pair(a, b, p))
            plain_ms = time_ms(torch, lambda: (gs.trilinear_sample(a, p), gs.trilinear_sample(b, p)), reps=5)
        else:
            ms = time_ms(torch, lambda: K7.trilinear_gather(a, p))
            plain_ms = time_ms(torch, lambda: gs.trilinear_sample(a, p), reps=5)
        grids = 2 if pair else 1
        nbytes = n * 3 * 4 + n * shape[3] * 4 * grids  # benchmark/metrics/k7_roofline.py's least bytes
        bound_ms = nbytes / PEAK_BYTES * 1e3
        line = (f"K7 {label} {shape} at N = {n}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
                f"({plain_ms / ms:.1f}x); bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB at 3.35 TB/s), "
                f"{100 * bound_ms / ms:.1f} % of it; {nbytes / ms / 1e9:.2f} TB/s of least bytes")
        entry = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, points=n, grids=grids)
        if label == "render high":
            # the library yardstick: one 5-D F.grid_sample (channels first, x along W)
            vol = a.permute(3, 2, 1, 0).contiguous()[None]
            coords = p.view(1, 1, 1, n, 3)

            def library():
                return F.grid_sample(vol, coords, mode="bilinear", padding_mode="border", align_corners=True)

            lib_ms = time_ms(torch, library)
            out = library()[0, :, 0, 0, :].t()
            err = float((out - K7.trilinear_gather(a, p)).abs().max())
            line += f"; library (F.grid_sample, 5-D, border, align_corners) {lib_ms:.4f} ms, max abs err vs K7 {err:.3e}"
            entry.update(library_ms=lib_ms, library_err=err)
        print(line, flush=True)
        rec[label] = entry
    return rec


def check_mask_launches(paths, name: str, out_dir: str, slam) -> None:
    """Fail unless the path launched K6 once per map with frustum selection
    (the colour refinement maps without masks)."""
    records = [json.loads(ln) for ln in open(os.path.join(out_dir, "metrics.jsonl"))]
    maps = [r for r in records if r["event"] == "map"]
    refine = [r for r in maps if not r["first"] and r["idx"] == slam.n_img - 1 and slam.color_refine]
    masked = (len(maps) - len(refine)) if slam.mapper.frustum_feature_selection else 0
    got = paths[name]["frustum_mask"]
    print(f"{name}: K6 (frustum masks) launched {got} times for {masked} maps with frustum selection "
          f"({len(maps)} mapped frames, {len(refine)} colour refinement)")
    if got != masked:
        fail(f"{name}: K6 launched {got} times for {masked} maps with frustum selection")


ROOM0_VARIANTS = (("halo", "graph"), ("halo", "eager"), ("pallas", "graph"), ("pallas", "eager"))


def room0_label(variant) -> str:
    """``halo`` / ``pallas`` for the graphed cycles, ``halo_eager`` /
    ``pallas_eager`` for the eager ones."""
    vjp, mode = variant
    return vjp if mode == "graph" else f"{vjp}_eager"


def phase_room0(torch, dev, kernels):
    """The room0-shape cycle (``tools/bench.py``'s replica workload, built
    by its ``build_workload`` and ``make_cycle``) under the ``halo`` (K1)
    and ``pallas`` (K3) grid gradients, each with its iterations replayed
    as CUDA graphs and run eagerly (``utils/step_graph.py``), each from its
    own copy of one initial scene and its own copy of one pixel-draw
    stream, timed in turns, 2 x ROOM0_TURNS reps each. Returns ({label: result},
    {label: cycle}); each result's ``launches`` are the kernels' launches
    over its timed cycles (a replay counts its capture's). The profiles
    (``profile_cycles``) run last in the script: the profiler slows what
    runs after it."""
    from attentive_dfprior_tpu_torch.tools import bench

    wl = bench.build_workload("replica", dev)
    print(f"room0 prior: {tuple(wl.tsdf.shape)} = {wl.tsdf.numel() / 1e6:.1f} M voxels")
    rays = bench.rays_per_cycle("replica")
    own = {"halo": "halo_fold", "pallas": "cell_stencil"}
    labels = [room0_label(v) for v in ROOM0_VARIANTS]
    cycles = {}
    for v, label in zip(ROOM0_VARIANTS, labels):
        params, cycles[label] = bench.make_cycle(wl, v[0], step_mode=v[1])
    print(f"room0 grids: low {tuple(params['grid_low'].shape)}, high {tuple(params['grid_high'].shape)}")
    from attentive_dfprior_tpu_torch.utils.step_graph import graph_pool_bytes

    warm, pool = {}, {}
    for label in labels:  # warm-up: allocator, cuBLAS handles, kernel loads, the graphs' warm-up and capture
        before = graph_pool_bytes()
        t0 = time.perf_counter()
        cycles[label]()
        warm[label] = time.perf_counter() - t0
        pool[label] = (graph_pool_bytes() - before) / 2**30
    reps = {v: [] for v in labels}
    splits = {v: [] for v in labels}
    launches = {v: {k.name: 0 for k in kernels} for v in labels}
    peak = {v: 0.0 for v in labels}
    # in turns (each variant, then back): every variant meets the same host
    # drift; every count is read over its own cycle
    for label in (labels + labels[::-1]) * ROOM0_TURNS:
        for k in kernels:
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses, map_s, track_s = cycles[label]()
        reps[label].append(time.perf_counter() - t0)
        splits[label].append((map_s, track_s))
        peak[label] = max(peak[label], torch.cuda.max_memory_allocated() / 2**30)
        for k in kernels:
            launches[label][k.name] += k.launches
        if not torch.isfinite(losses).all():
            fail(f"room0 cycle ({label}): non-finite loss")
    results = {}
    for v, label in zip(ROOM0_VARIANTS, labels):
        cycle_s = float(np.median(reps[label]))
        out = dict(grid_vjp=v[0], step_mode=v[1], cycle_s=cycle_s, rep_s=reps[label], map_track_s=splits[label],
                   warmup_s=warm[label], rays_per_cycle=rays, rays_per_s=rays / cycle_s, peak_mem_gb=peak[label],
                   graph_pool_gb=pool[label], graphs=cycles[label].graphs.stats(),
                   launches_per_cycle={n: c // len(reps[label]) for n, c in launches[label].items()})
        print(f"room0 cycle ({label}): {json.dumps(out)}", flush=True)
        other = own["pallas" if v[0] == "halo" else "halo"]
        if launches[label][own[v[0]]] <= 0 or launches[label][other] != 0:
            fail(f"room0 cycle ({label}) launched {own[v[0]]} {launches[label][own[v[0]]]} times and "
                 f"{other} {launches[label][other]} times (expected > 0 and 0)")
        results[label] = dict(out, launches=launches[label])
    for vjp in ("halo", "pallas"):
        g, e = results[vjp], results[f"{vjp}_eager"]
        if g["launches_per_cycle"] != e["launches_per_cycle"]:
            fail(f"room0 cycle ({vjp}): replays count {g['launches_per_cycle']} launches, eager "
                 f"{e['launches_per_cycle']}")
        print(f"room0 cycle ({vjp}): graphed {g['cycle_s']:.4f} s ({g['rays_per_s']:.1f} rays/s), eager "
              f"{e['cycle_s']:.4f} s ({e['rays_per_s']:.1f} rays/s): {e['cycle_s'] / g['cycle_s']:.2f}x")
    return results, cycles


def profile_cycles(torch, cycles, results) -> None:
    """One profiled halo cycle, graphed and eager (the pallas cycle's
    device time has matched halo's within 1 % in every run that profiled
    both), then one graphed halo cycle timed again: how much the profiler
    slows what runs after it."""
    from attentive_dfprior_tpu_torch.tools import bench

    iters = sum(bench.WORKLOADS["replica"]["map_iters"].values()) + (
        bench.TRACKED_FRAMES * bench.WORKLOADS["replica"]["track_iters"])
    for label in ("halo", "halo_eager"):
        profile_cycle(torch, cycles[label], results[label]["cycle_s"], f"room0 {label}", iters)
    t0 = time.perf_counter()
    cycles["halo"]()
    print(f"room0 cycle (halo) again after the profile: {time.perf_counter() - t0:.4f} s "
          f"(before it: {results['halo']['cycle_s']:.4f} s)")


def profile_cycle(torch, cycle, cycle_s: float, label: str, iters: int) -> None:
    """One more cycle under torch.profiler, tracing the device alone (the
    host's operators, which the profile does not read, took it from about
    two minutes to one): the device kernels' durations summed over the
    cycle (kernels on two streams at once counted twice, so no busy share:
    the benchmark's union over its traced window is one) beside the
    unprofiled cycle time, the number of device kernels, the launches the host made per
    iteration (kernel and graph launches, copies and fills: the runtime
    calls in the trace) over the cycle's ``iters`` iterations, and the
    kernels that take the most device time. The device's events are
    summed straight from the trace: ``key_averages()`` builds a Python
    event per kernel first, which took many times longer than the sums at
    a cycle's 229,255 kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from attentive_dfprior_tpu_torch.tools.profile_mapping import HOST_LAUNCH_CALLS

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cycle()
    by_name = {}  # kernel name -> (launches, device ns)
    host = {}  # runtime call -> count
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            n, ns = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (n + 1, ns + e.duration_ns())
        elif e.name() in HOST_LAUNCH_CALLS:
            host[e.name()] = host.get(e.name(), 0) + 1
    print(f"profile ({label}): {time.perf_counter() - t0:.1f} s to trace and sum the cycle")
    kernel_s = sum(ns for _, ns in by_name.values()) / 1e9
    if kernel_s <= 0:
        print(f"profile ({label}): the profiler recorded no device time (not measured)")
        return
    n_kernels = sum(n for n, _ in by_name.values())
    n_host = sum(host.values())
    print(f"profile ({label}): kernel time summed over the cycle {kernel_s:.4f} s, beside the {cycle_s:.4f} s "
          f"cycle; {n_kernels} device kernels per cycle ({n_kernels / iters:.1f} per "
          f"iteration); host launches per iteration "
          + (f"{n_host / iters:.1f} ({json.dumps(host)} in the cycle)" if n_host else "not measured (no runtime "
             "calls in the trace)"))
    for name, (n, ns) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
        print(f"  {ns / 1e6:9.3f} ms  {n:6d} x  {name[:90]}")


def profile_renders(torch, slam, times) -> None:
    """Phase 5's render of the last mapped frame profiled at the end of the
    run, graphed and eager (``profile_cycle``): the kernel time summed
    beside phase 5's median seconds and the kernels that take the most device time,
    per chunk of ``ray_batch_size`` rays."""
    from attentive_dfprior_tpu_torch.render.renderer import Renderer
    from attentive_dfprior_tpu_torch.utils.step_graph import ForwardGraphs

    last = ENTRY_END - 1
    _, _, depth, _ = slam.dataset[last]
    eager = Renderer(slam.rcfg, slam.scene_cfg.bound, slam.tsdf_bnds, slam.cam, slam.device,
                     graphs=ForwardGraphs("eager", slam.device))
    chunks = -(-slam.cam.H * slam.cam.W // slam.renderer.ray_batch_size)
    for mode, renderer in (("graph", slam.renderer), ("eager", eager)):
        def render():
            renderer.render_img(slam.params, slam.estimate_c2w_list[last], slam.tsdf_volume, gt_depth=depth)
            torch.cuda.synchronize()

        render()
        profile_cycle(torch, render, times[f"{mode}_s"], f"render 240x320 {mode}, per chunk", chunks)


def profile_bench_cycles(torch, dev, cycle_s) -> None:
    """Phase 17(a)'s workload (BENCH_WORKLOAD) profiled at the end of the
    run, as phase 3's cycles are: for each step mode a fresh scene and
    cycle (``tools/bench.py``'s builder), graphed after one warm-up cycle
    (the capture), eager at once (17(a) loaded its kernels in this
    process), then one profiled (``profile_cycle``): the kernel time
    summed beside 17(a)'s median cycle seconds ``cycle_s`` (by mode) and
    the host's
    launches per iteration."""
    from attentive_dfprior_tpu_torch.tools import bench

    spec = bench.WORKLOADS[BENCH_WORKLOAD]
    iters = sum(spec["map_iters"].values()) + bench.TRACKED_FRAMES * spec["track_iters"]
    wl = bench.build_workload(BENCH_WORKLOAD, dev)
    for mode in ("graph", "eager"):
        _, cycle = bench.make_cycle(wl, "halo", step_mode=mode)
        if mode == "graph":
            cycle()
        profile_cycle(torch, cycle, cycle_s[mode], f"{BENCH_WORKLOAD} {mode}", iters)


def expected_panels(cfg, start: int, n: int, n_img: int):
    """Panels per directory that the Visualizers' gates give for frames
    [start, n) of a run whose config is ``cfg`` on a dataset of ``n_img``
    frames."""
    m, t = cfg["mapping"], cfg["tracking"]
    mapping = 0
    for i in range(start, n):
        if not (i == 0 or i % m["every_frame"] == 0 or i == n - 1):
            continue
        first = i == 0
        color_refine = not first and i == n_img - 1 and m.get("color_refine", True)
        if color_refine or (first and m.get("no_vis_on_first_frame", True)) or i % m["vis_freq"]:
            continue
        mapping += len(range(0, m["iters_first"] if first else m["iters"], m["vis_inside_freq"]))
    tracking = 0 if t["gt_camera"] else sum(
        len(range(0, t["iters"], t["vis_inside_freq"])) for i in range(max(start, 1), n) if i % t["vis_freq"] == 0
    )
    return {"mapping_vis": mapping, "tracking_vis": tracking}


def check_panels(slam, start: int, n: int, label: str) -> None:
    got = {d: len(os.listdir(os.path.join(slam.output, d))) for d in ("mapping_vis", "tracking_vis")}
    want = expected_panels(slam.cfg, start, n, slam.n_img)
    print(f"{label}: panels per directory {json.dumps(got)}, the gates give {json.dumps(want)}")
    if got != want:
        fail(f"{label}: panel counts {got} differ from the gates' {want}")


def report_run(slam, out_dir, wall: float, label: str, records):
    """Print a run's loop-closure records, aligned ATE (the port's eval_ate
    on its last checkpoint), unaligned ATE and seconds by part; fail when
    a loss is non-finite. Returns (aligned ATE m, per-frame aligned error m,
    unaligned per-frame error m)."""
    from attentive_dfprior_tpu_torch.tools import eval_ate
    from attentive_dfprior_tpu_torch.utils.logger import latest_checkpoint

    losses = [r["loss"] for r in records if r["event"] == "track"]
    losses += [v for r in records if r["event"] == "map" for v in r["losses"].values()]
    if not np.isfinite(losses).all():
        fail(f"{label}: non-finite loss")
    for r in records:
        if r["event"].startswith("loop_"):
            print(f"{label} {r['event']}: {json.dumps(r)}")
    n = slam.last_idx + 1
    est, gt = slam.estimate_c2w_list[:n], slam.gt_c2w_list[:n]
    err = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=1)
    ckpt = latest_checkpoint(os.path.join(out_dir, "ckpts"))
    ate = eval_ate.evaluate_checkpoint(ckpt)
    _, _, aligned_err = eval_ate.align(gt[:, :3, 3].T.astype(np.float64), est[:, :3, 3].T.astype(np.float64))
    parts = {k: round(v, 3) for k, v in slam.timings.items()}
    if slam.sync_method == "strict":
        parts["set-up"] = round(wall - sum(slam.timings.values()), 3)
        note = "set-up: the system's build, prior fusion, dataset frames rendered on the host"
    else:  # track and map overlap in wall time: set-up is what ran before run()
        parts["set-up"] = round(wall - slam.profiler.seconds["run"], 3)
        parts["run"] = round(slam.profiler.seconds["run"], 3)
        note = (f"{slam.sync_method}: track and map run on two threads and overlap; set-up: wall minus run(), "
                f"the system's build, prior fusion, dataset frames rendered on the host")
    print(f"{label} seconds by part: {json.dumps(parts)} ({note})")
    from attentive_dfprior_tpu_torch.utils.step_graph import graph_pool_bytes

    print(f"{label}: {slam.step_mode} steps; mapper {json.dumps(slam.mapper.graphs.stats())}, tracker "
          f"{json.dumps(slam.tracker.graphs.stats())}; render and field-query programs "
          f"{json.dumps(slam.forward_graphs.stats())}; graph pools held in the process {graph_pool_bytes() / 2**30:.3f} GiB")
    print(f"{label}: {wall:.1f} s for {n} frames; aligned ATE RMSE {ate['absolute_translational_error.rmse_cm']:.3f} "
          f"cm over {ate['compared_pose_pairs']} poses ({os.path.basename(ckpt)}); unaligned ATE RMSE "
          f"{100 * float(np.sqrt(np.mean(err ** 2))):.3f} cm")
    return ate["absolute_translational_error.rmse"], aligned_err, err


def track_interval_median(records) -> float:
    """Median seconds between consecutive ``track`` records."""
    t = [r["t"] for r in records if r["event"] == "track"]
    return float(np.median(np.diff(t)))


def phase_entry(torch, dev):
    """The entry point on frames 0..15 (strict), then the resume. Returns
    (the system, {wall_s, run_s, track_interval_median_s} of the first
    run; run_s: the wall time of ``SLAMSystem.run``, without the set-up)."""
    from attentive_dfprior_tpu_torch import run as run_mod

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_run_")
    argv = [ROOM_TRACKING, "--output", out_dir, "--device", "cuda", *PANELS_EVERY_5]
    t0 = time.perf_counter()
    os.chdir(REPO)  # the config's relative paths (pretrained prior, inherit_from)
    slam = run_mod.main(argv + ["--end_idx", str(ENTRY_END)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    metrics = os.path.join(out_dir, "metrics.jsonl")
    records = [json.loads(ln) for ln in open(metrics)]
    for r in records:
        if r["event"] == "track":
            print(f"entry track frame {r['idx']}: loss {r['loss']:.4f}")
        elif r["event"] == "map":
            print(f"entry map frame {r['idx']}: losses {json.dumps(r['losses'])}")
    _, _, err = report_run(slam, out_dir, wall, "entry point", records)
    print(f"entry point: vis {slam.timings['vis']:.3f} s with the renders graphed (PR 13, eager renders: "
          f"{PR13_VIS_S['strict']} s)")
    print("entry point: unaligned translation error per frame (cm): " + " ".join(f"{100 * e:.2f}" for e in err))
    if float(np.sqrt(np.mean(err**2))) > 0.10:
        fail("entry point: unaligned ATE above 10 cm")
    events = [r["event"] for r in records]
    if "loop_relax" not in events or "loop_final_refine" not in events:
        fail(f"entry point: loop closure did not run (relaxations {events.count('loop_relax')}, "
             f"refines {events.count('loop_final_refine')})")
    check_panels(slam, 0, ENTRY_END, "entry point")
    if not os.path.exists(os.path.join(out_dir, "ckpts", f"{ENTRY_END - 1:05d}.npz")):
        fail("entry point: no checkpoint written")

    # resume the same output for two more frames
    t0 = time.perf_counter()
    resumed = run_mod.main(argv + ["--resume", "--end_idx", str(ENTRY_END + 2)])
    torch.cuda.synchronize()
    new = [json.loads(ln) for ln in open(metrics)][len(records):]
    tracked = [r["idx"] for r in new if r["event"] == "track"]
    ckpt = os.path.join(out_dir, "ckpts", f"{ENTRY_END + 1:05d}.npz")
    print(f"resume: {time.perf_counter() - t0:.1f} s; tracked frames {tracked}; "
          f"{os.path.basename(ckpt)} written {os.path.exists(ckpt)}; "
          f"records {json.dumps([r for r in new if r['event'].startswith('loop_')])}; render and field-query "
          f"programs {json.dumps(resumed.forward_graphs.stats())}")
    if tracked != [ENTRY_END, ENTRY_END + 1] or not os.path.exists(ckpt) or resumed.last_idx != ENTRY_END + 1:
        fail(f"resume: expected frames {ENTRY_END}-{ENTRY_END + 1} and {os.path.basename(ckpt)}")
    return slam, {"wall_s": wall, "run_s": slam.profiler.seconds["run"], "loop_s": slam.timings["loop"],
                  "track_interval_median_s": track_interval_median(records),
                  "traj": slam.estimate_c2w_list[:ENTRY_END].copy()}


def fused_frames(slam) -> int:
    """Frames a ``SLAMSystem``'s on-the-fly prior fuses (``tsdf.space``)."""
    return len(range(0, slam.n_img, int(slam.cfg.get("tsdf", {}).get("space", 10))))


def phase_prior_equal(torch, dev, slam) -> None:
    """Phase 4's on-the-fly prior fused again from the same frames, once
    through K5 and once through its plain version on the card
    (``tsdf_kernel.plain_on_cuda``, which no path enters): tsdf, weight and
    colour ``torch.equal``, and K5's tsdf ``torch.equal`` to the prior the
    run used."""
    from attentive_dfprior_tpu_torch.ops.cuda import tsdf_kernel
    from attentive_dfprior_tpu_torch.tsdf.builder import build_tsdf_volume

    tcfg = slam.cfg.get("tsdf", {})
    space, voxel = int(tcfg.get("space", 10)), float(tcfg.get("voxel_size", 4.0 / 256))
    t0 = time.perf_counter()
    _, _, k5 = build_tsdf_volume(slam.cfg, space=space, voxel_size=voxel, device=dev)
    torch.cuda.synchronize()
    k5_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with tsdf_kernel.plain_on_cuda():
        _, _, plain = build_tsdf_volume(slam.cfg, space=space, voxel_size=voxel, device=dev)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    equal = {name: torch.equal(getattr(k5, name), getattr(plain, name)) for name in ("_tsdf", "_weight", "_color")}
    used = torch.equal(k5.device_volume(), slam.tsdf_volume_track)
    print(f"prior ({fused_frames(slam)} frames of {slam.cam.H}x{slam.cam.W} into {tuple(k5._tsdf.shape)} voxels of "
          f"{voxel} m): K5 {k5_s:.2f} s, plain version on the card {plain_s:.2f} s (frames from the process's cache); "
          f"torch.equal {json.dumps(equal)}; K5's tsdf torch.equal to the run's prior {used}")
    if not (all(equal.values()) and used):
        fail("prior: K5's fusion differs from the plain version's or from the run's prior")


def late_map_grant() -> None:
    """Phase 16(a): the lead's mapper asks for map OVERLAP_MAP's grant only
    once a later frame's track unit is granted (``slam/schedule.py``). On
    the card the mapper asked first in every run, so the log came out the
    same whatever the timing; now the lead's log grants frame
    OVERLAP_MAP + 1 before that map, which the JAX ``dispatch_lock``
    allows too, while a follower's own mapper still asks first and must
    wait for the log's order to replay it."""
    from attentive_dfprior_tpu_torch.parallel.sharding import GROUP_TIMEOUT_S
    from attentive_dfprior_tpu_torch.slam import system
    from attentive_dfprior_tpu_torch.slam.schedule import UnitSchedule

    class LateMapGrant(UnitSchedule):
        def unit(self, kind, idx, decide=dict):
            if self.lead and kind == "map" and idx == OVERLAP_MAP:
                deadline = time.monotonic() + GROUP_TIMEOUT_S
                while not granted_before_map(self.records + [{"unit": "map", "idx": idx}], idx):
                    self.peers.check()
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"no frame after {idx} was granted within {GROUP_TIMEOUT_S} s")
                    time.sleep(0.01)
            return super().unit(kind, idx, decide)

    system.UnitSchedule = LateMapGrant


def async_equal_child() -> None:
    """Phase 10(a)'s runs, in a child process whose environment sets
    ``CUBLAS_WORKSPACE_CONFIG``: strict, loose and free on frames
    0..ASYNC_EQUAL_END - 1 with ASYNC_EQUAL_SET, through the entry point,
    under ``torch.use_deterministic_algorithms``. Where the launcher's
    variables name a group (``WORLD_SIZE``, phase 16(a)) the child is one
    rank of it: it joins over gloo on ``cuda:0`` (NCCL refuses two ranks on
    one device) and every run sets ``parallel.enable=True``. Prints one line,
    CHILD_TAG and a JSON object: whether loose's and free's final scene
    leaves are ``torch.equal`` to strict's, in this process and (on the
    writer) in the final checkpoints; a digest of each run's leaves and its
    decision log, for the ranks to be held to each other; each run's
    seconds, events and kernel launches."""
    import hashlib
    import warnings

    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from attentive_dfprior_tpu_torch import run as run_mod
    from attentive_dfprior_tpu_torch.ops.cuda import build
    from attentive_dfprior_tpu_torch.parallel.sharding import init_distributed
    from attentive_dfprior_tpu_torch.utils.tree import tree_leaves

    kernels = build.port_kernels()
    os.chdir(REPO)
    torch.use_deterministic_algorithms(True, warn_only=True)
    ranks = bool(os.environ.get("WORLD_SIZE"))
    if ranks:
        init_distributed(backend="gloo", device="cuda:0")
        late_map_grant()
    leaves, ckpts, out = {}, {}, {"runs": {}, "rank": dist.get_rank() if ranks else 0}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for sync in ("strict", "loose", "free"):
            out_dir = tempfile.mkdtemp(prefix=f"chip_smoke_equal_{sync}_")
            argv = [ROOM_TRACKING, "--output", out_dir, "--device", "cuda:0" if ranks else "cuda",
                    "--end_idx", str(ASYNC_EQUAL_END)]
            for kv in ASYNC_EQUAL_SET + [f"sync_method={sync}"] + (["parallel.enable=True"] if ranks else []):
                argv += ["--set", kv]
            for k in kernels:
                k.launches = 0
            t0 = time.perf_counter()
            slam = run_mod.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            leaves[sync] = [t.detach().cpu() for t in tree_leaves(slam.params)]
            events = []
            if slam.is_writer:
                with np.load(os.path.join(out_dir, "ckpts", f"{ASYNC_EQUAL_END - 1:05d}.npz")) as ckpt:
                    ckpts[sync] = {k: torch.from_numpy(ckpt[k]) for k in ckpt.files if k.startswith("p")}
                with open(os.path.join(out_dir, "metrics.jsonl")) as f:
                    events = [json.loads(ln)["event"] for ln in f]
            digest = hashlib.sha256(b"".join(t.numpy().tobytes() for t in leaves[sync])).hexdigest()
            out["runs"][sync] = {"wall_s": wall, "events": {e: events.count(e) for e in sorted(set(events))},
                                 "launches": {k.name: k.launches for k in kernels}, "digest": digest,
                                 "log": slam.schedule_records, "role": slam.role, "step_mode": slam.step_mode}
    if ranks:
        dist.destroy_process_group()
    out["n_leaves"] = len(leaves["strict"])
    out["equal"] = {sync: all(torch.equal(a, b) for a, b in zip(leaves[sync], leaves["strict"]))
                    for sync in ("loose", "free")}
    out["max_abs_diff"] = {sync: max(float((a - b).abs().max()) for a, b in zip(leaves[sync], leaves["strict"]))
                           for sync in ("loose", "free")}
    if ckpts:
        out["ckpt_equal"] = {sync: sorted(ckpts[sync]) == sorted(ckpts["strict"])
                             and all(torch.equal(ckpts[sync][k], ckpts["strict"][k]) for k in ckpts["strict"])
                             for sync in ("loose", "free")}
    out["warnings"] = sorted({str(w.message).splitlines()[0][:160] for w in caught})
    print(CHILD_TAG + json.dumps(out), flush=True)


def phase_async_equal(paths) -> None:
    """Phase 10(a): ``async_equal_child`` in a child process; fails unless
    loose's and free's final scene leaves are ``torch.equal`` to strict's.
    The child's launches are recorded as three paths."""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")  # deterministic cuBLAS
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--async-equal-child"], env=env,
                          capture_output=True, text=True, timeout=900)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(CHILD_TAG)]
    if proc.returncode != 0 or not lines:
        fail(f"async equality child exited {proc.returncode}:\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    res = json.loads(lines[-1][len(CHILD_TAG):])
    for sync, run in res["runs"].items():
        paths[f"async_equal_{sync}"] = run["launches"]
        print(f"async equality {sync}: {run['wall_s']:.1f} s ({run['step_mode']} steps), events "
              f"{json.dumps(run['events'])}, launches {json.dumps(run['launches'])}")
    for msg in res["warnings"]:
        print(f"async equality: warning: {msg}")
    print(f"async equality (frames 0-{ASYNC_EQUAL_END - 1}, {' '.join(ASYNC_EQUAL_SET)}, deterministic algorithms): "
          f"{res['n_leaves']} scene leaves torch.equal to strict's, final checkpoint {json.dumps(res['ckpt_equal'])}, "
          f"scene {json.dumps(res['equal'])}; max abs diff {json.dumps(res['max_abs_diff'])}")
    if not (all(res["equal"].values()) and all(res["ckpt_equal"].values())):
        fail(f"async equality: the final scene differs from strict's: {json.dumps(res['max_abs_diff'])}")


def graph_equal_child() -> None:
    """Phase 19's runs, in a child process whose environment sets
    ``CUBLAS_WORKSPACE_CONFIG``, under ``torch.use_deterministic_algorithms``:
    one ``SLAMSystem`` on room_tracking.yaml with GRAPH_EQUAL_SET, its mapper
    and tracker given a fresh ``StepGraphs`` of each step mode in turn
    (eager, then graph), each run from the same initial scene and generator
    state. (a) frame 0's mapping (all three stages), then a BA window of
    frames GRAPH_EQUAL_BA_WINDOW (their GT poses, the later two moved 1 cm)
    mapped as frame 5 at the config's iterations; (b) from the eager run's
    map, frames GRAPH_EQUAL_TRACK tracked as ``Tracker.track`` does (the
    constant-speed initial pose from the poses tracked before); (c) K1's
    launches over (a), a graph replay counting the launches its capture
    holds. Prints one line, GRAPH_CHILD_TAG and a JSON object: whether the
    per-iteration losses, every final leaf, BA's refined poses, the tracked
    poses and losses are ``torch.equal`` across the modes, the largest
    differences, the launches, the graphs' counts and the seconds."""
    import warnings

    import torch

    sys.path.insert(0, REPO)
    from attentive_dfprior_tpu_torch.config import default_config_path, load_config
    from attentive_dfprior_tpu_torch.ops.cuda import build
    from attentive_dfprior_tpu_torch.ops.pose import homogenize, pose_matrix_from_tensor, pose_tensor_from_matrix
    from attentive_dfprior_tpu_torch.run import apply_overrides
    from attentive_dfprior_tpu_torch.slam.system import SLAMSystem
    from attentive_dfprior_tpu_torch.slam.tracker import track_frame
    from attentive_dfprior_tpu_torch.utils.step_graph import StepGraphs
    from attentive_dfprior_tpu_torch.utils.tree import tree_leaves

    kernels = build.port_kernels()
    os.chdir(REPO)
    torch.use_deterministic_algorithms(True, warn_only=True)
    cfg = load_config(ROOM_TRACKING, default_config_path())
    apply_overrides(cfg, GRAPH_EQUAL_SET)
    cfg["seed"] = 0
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    slam = SLAMSystem(cfg, output=tempfile.mkdtemp(prefix="chip_smoke_graph_equal_"), device=dev)
    frames = {i: slam.dataset[i] for i in sorted({0, *GRAPH_EQUAL_BA_WINDOW, *GRAPH_EQUAL_TRACK})}
    setup_s = time.perf_counter() - t0
    init = [t.detach().clone() for t in tree_leaves(slam.params)]
    gen_state = slam.generator.get_state()
    m, tr = slam.mapper, slam.tracker
    win_c2w = np.stack([frames[i][3] for i in GRAPH_EQUAL_BA_WINDOW]).astype(np.float32)
    win_c2w[1:, :3, 3] += 0.01  # BA has poses to move
    win_color = torch.stack([slam._to_device(frames[i][1]) for i in GRAPH_EQUAL_BA_WINDOW])
    win_depth = torch.stack([slam._to_device(frames[i][2]) for i in GRAPH_EQUAL_BA_WINDOW])

    def reset(leaves):
        with torch.no_grad():
            for t, v in zip(tree_leaves(slam.params), leaves):
                t.copy_(v)
        slam.generator.set_state(gen_state)

    def run(mode):
        m.graphs = StepGraphs(mode, dev)
        tr.graphs = StepGraphs(mode, dev)
        reset(init)
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, c, d, gt = frames[0]
        _, _, _, first = m.optimize_map(slam.params, m.iters_first, m.lr_first_factor, 0, slam._to_device(c)[None],
                                        slam._to_device(d)[None], np.asarray(gt)[None], generator=slam.generator,
                                        cur_depth_np=np.asarray(d), cur_c2w_np=gt)
        _, _, refined, ba = m.optimize_map(slam.params, m.num_joint_iters, m.lr_factor, 5, win_color, win_depth, win_c2w,
                                           generator=slam.generator, cur_depth_np=np.asarray(frames[2][2]),
                                           cur_c2w_np=win_c2w[-1], ba_anchor=0)
        torch.cuda.synchronize()
        map_s = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
        mapped = [t.detach().clone() for t in tree_leaves(slam.params)]
        losses = torch.cat([*first.values(), *ba.values()])
        return dict(losses=losses, leaves=mapped, refined=refined, launches=launches, map_s=map_s,
                    map_graphs=m.graphs.stats())

    def track(mode, leaves):
        tr.graphs = StepGraphs(mode, dev)
        reset(leaves)
        est = np.zeros((max(GRAPH_EQUAL_TRACK) + 1, 4, 4), np.float32)
        est[0] = frames[0][3]
        poses, losses = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for idx in GRAPH_EQUAL_TRACK:
            _, c, d, _ = frames[idx]
            cam_t = torch.as_tensor(pose_tensor_from_matrix(tr.initial_pose(idx, est)), device=dev)
            best, tl, _, _ = track_frame(
                slam.params, cam_t, slam._to_device(c), slam._to_device(d), tr.tsdf_volume, tr.tsdf_bnds, tr.bound,
                tr.cam, tr.rcfg, tr.tracking_pixels, tr.num_cam_iters, tr.ignore_edge_W, tr.ignore_edge_H,
                tr.handle_dynamic, tr.use_color, tr.w_color_loss, tr.cam_lr, tr.seperate_LR, tr.lr_final_factor,
                slam.generator, None, tr.grid_vjp, tr.adam_lazy, graphs=tr.graphs,
            )
            with torch.no_grad():
                est[idx] = homogenize(pose_matrix_from_tensor(best)).cpu().numpy()
            poses.append(best)
            losses.append(tl)
        torch.cuda.synchronize()
        return dict(poses=torch.stack(poses), track_losses=torch.cat(losses), track_s=time.perf_counter() - t0,
                    track_graphs=tr.graphs.stats())

    out = {"setup_s": setup_s, "runs": {}}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = {mode: run(mode) for mode in ("eager", "graph")}
        eager_map = res["eager"]["leaves"]
        for mode in ("eager", "graph"):
            res[mode].update(track(mode, eager_map))
    e, g = res["eager"], res["graph"]

    def maxdiff(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))

    out["equal"] = {
        "map_losses": torch.equal(e["losses"], g["losses"]),
        "map_leaves": all(torch.equal(a, b) for a, b in zip(e["leaves"], g["leaves"])),
        "ba_poses": bool(np.array_equal(e["refined"], g["refined"])),
        "track_poses": torch.equal(e["poses"], g["poses"]),
        "track_losses": torch.equal(e["track_losses"], g["track_losses"]),
        "k1_launches": e["launches"]["halo_fold"] == g["launches"]["halo_fold"] > 0,
    }
    out["max_abs_diff"] = {"map_leaves": maxdiff(e["leaves"], g["leaves"]),
                           "track_poses": float((e["poses"] - g["poses"]).abs().max())}
    out["n_map_iters"], out["n_leaves"] = len(e["losses"]), len(e["leaves"])
    for mode, r in res.items():
        out["runs"][mode] = {"launches": r["launches"], "map_s": r["map_s"], "track_s": r["track_s"],
                             "map_graphs": r["map_graphs"], "track_graphs": r["track_graphs"],
                             "last_map_loss": float(r["losses"][-1])}
    out["warnings"] = sorted({str(w.message).splitlines()[0][:160] for w in caught})
    print(GRAPH_CHILD_TAG + json.dumps(out), flush=True)


def phase_graph_equal(paths) -> None:
    """Phase 19: ``graph_equal_child`` in a child process; fails unless the
    graphed mapping (three stages and a BA window) and tracking (frames 1-5)
    are ``torch.equal`` to eager and K1's launches, replays counted, equal
    the eager run's. The child's launches are recorded as two paths."""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")  # deterministic cuBLAS
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--graph-equal-child"], env=env,
                          capture_output=True, text=True, timeout=900)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(GRAPH_CHILD_TAG)]
    if proc.returncode != 0 or not lines:
        fail(f"graph equality child exited {proc.returncode}:\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    res = json.loads(lines[-1][len(GRAPH_CHILD_TAG):])
    for mode, run in res["runs"].items():
        paths[f"graph_equal_{mode}"] = run["launches"]
        print(f"graph equality {mode}: mapping {run['map_s']:.2f} s ({json.dumps(run['map_graphs'])}), tracking "
              f"{run['track_s']:.2f} s ({json.dumps(run['track_graphs'])}), launches {json.dumps(run['launches'])}, "
              f"last map loss {run['last_map_loss']:.6f}")
    for msg in res["warnings"]:
        print(f"graph equality: warning: {msg}")
    print(f"graph equality ({' '.join(GRAPH_EQUAL_SET)}, frame 0's three stages and a BA window of frames "
          f"{list(GRAPH_EQUAL_BA_WINDOW)}: {res['n_map_iters']} iterations, {res['n_leaves']} leaves; frames "
          f"{list(GRAPH_EQUAL_TRACK)} tracked; deterministic algorithms; set-up {res['setup_s']:.1f} s): torch.equal "
          f"{json.dumps(res['equal'])}; max abs diff {json.dumps(res['max_abs_diff'])}")
    if not all(res["equal"].values()):
        fail(f"graph equality: graphed and eager differ: {json.dumps(res['equal'])} {json.dumps(res['max_abs_diff'])}")


def dp_graph_child() -> None:
    """Phase 21's runs, in a child process that joins a world of one on
    NCCL (the parent sets the launcher's variables), under
    ``torch.use_deterministic_algorithms`` with ``CUBLAS_WORKSPACE_CONFIG``
    set: one ``SLAMSystem`` on room_tracking.yaml with GRAPH_EQUAL_SET, its
    mapper and tracker given ``RayShards(size=1, ranks=(0,),
    group=WORLD)``, so the dp step and its ``all_reduce`` (and the
    tracker's gathered median, ``handle_dynamic``) run. Three runs from the
    same scene and generator state, each frame 0's map then frames
    GRAPH_EQUAL_TRACK tracked from the run's own map: ``eager`` on the group,
    ``graph`` on the group (the collectives captured), and ``graph`` with
    no group (the single-process step). Counts the ``all_reduce`` calls
    made eagerly and under a capture, and each mapping program's K1
    launches a replay. Prints NCCL's and PyTorch's versions, then one line,
    DP_GRAPH_TAG and a JSON object: the three runs' losses compared (equal,
    the first differing iteration), leaves and poses, the graphs' counts,
    the capture mode, launches and seconds."""
    import warnings

    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from attentive_dfprior_tpu_torch.config import default_config_path, load_config
    from attentive_dfprior_tpu_torch.ops.cuda import build
    from attentive_dfprior_tpu_torch.ops.pose import homogenize, pose_matrix_from_tensor, pose_tensor_from_matrix
    from attentive_dfprior_tpu_torch.parallel.sharding import RayShards, init_distributed
    from attentive_dfprior_tpu_torch.run import apply_overrides
    from attentive_dfprior_tpu_torch.slam.system import SLAMSystem
    from attentive_dfprior_tpu_torch.slam.tracker import track_frame
    from attentive_dfprior_tpu_torch.utils.step_graph import StepGraphs
    from attentive_dfprior_tpu_torch.utils.tree import tree_leaves

    kernels = build.port_kernels()
    os.chdir(REPO)
    torch.use_deterministic_algorithms(True, warn_only=True)
    init_distributed(device="cuda:0")
    print(f"dp graph child: torch {torch.__version__}, CUDA {torch.version.cuda}, NCCL "
          f"{'.'.join(map(str, torch.cuda.nccl.version()))}, backend {dist.get_backend()}, world "
          f"{dist.get_world_size()}", flush=True)
    calls = {"eager": 0, "captured": 0}
    all_reduce = dist.all_reduce

    def counted(*a, **kw):
        calls["captured" if torch.cuda.is_current_stream_capturing() else "eager"] += 1
        return all_reduce(*a, **kw)

    dist.all_reduce = counted
    try:
        cfg = load_config(ROOM_TRACKING, default_config_path())
        apply_overrides(cfg, GRAPH_EQUAL_SET)
        cfg["seed"] = 0
        dev = torch.device("cuda", 0)
        t0 = time.perf_counter()
        slam = SLAMSystem(cfg, output=tempfile.mkdtemp(prefix="chip_smoke_dp_graph_"), device=dev)
        frames = {i: slam.dataset[i] for i in sorted({0, *GRAPH_EQUAL_TRACK})}
        setup_s = time.perf_counter() - t0
        init = [t.detach().clone() for t in tree_leaves(slam.params)]
        gen_state = slam.generator.get_state()
        m, tr = slam.mapper, slam.tracker
        shards = RayShards(size=1, ranks=(0,), group=dist.group.WORLD)

        def run(mode, sh):
            group = sh.group if sh is not None else None
            m.shards = tr.shards = sh
            m.graphs = StepGraphs(mode, dev, group=group)
            tr.graphs = StepGraphs(mode, dev, group=group)
            with torch.no_grad():
                for t, v in zip(tree_leaves(slam.params), init):
                    t.copy_(v)
            slam.generator.set_state(gen_state)
            for k in kernels:
                k.launches = 0
            calls.update(eager=0, captured=0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, c, d, gt = frames[0]
            _, _, _, first = m.optimize_map(slam.params, m.iters_first, m.lr_first_factor, 0,
                                            slam._to_device(c)[None], slam._to_device(d)[None], np.asarray(gt)[None],
                                            generator=slam.generator, cur_depth_np=np.asarray(d), cur_c2w_np=gt)
            torch.cuda.synchronize()
            map_s = time.perf_counter() - t0
            leaves = [t.detach().clone() for t in tree_leaves(slam.params)]
            est = np.zeros((max(GRAPH_EQUAL_TRACK) + 1, 4, 4), np.float32)
            est[0] = frames[0][3]
            poses, track_losses = [], []
            t0 = time.perf_counter()
            for idx in GRAPH_EQUAL_TRACK:
                _, c, d, _ = frames[idx]
                cam_t = torch.as_tensor(pose_tensor_from_matrix(tr.initial_pose(idx, est)), device=dev)
                best, tl, _, _ = track_frame(
                    slam.params, cam_t, slam._to_device(c), slam._to_device(d), tr.tsdf_volume, tr.tsdf_bnds,
                    tr.bound, tr.cam, tr.rcfg, tr.tracking_pixels, tr.num_cam_iters, tr.ignore_edge_W,
                    tr.ignore_edge_H, tr.handle_dynamic, tr.use_color, tr.w_color_loss, tr.cam_lr, tr.seperate_LR,
                    tr.lr_final_factor, slam.generator, None, tr.grid_vjp, tr.adam_lazy, shards=sh, graphs=tr.graphs,
                )
                with torch.no_grad():
                    est[idx] = homogenize(pose_matrix_from_tensor(best)).cpu().numpy()
                poses.append(best)
                track_losses.append(tl)
            torch.cuda.synchronize()
            per_replay = [{k.name: n for k, n in prog[-1].launches.items()} for prog in m.graphs.programs.values()]
            return dict(map_losses=torch.cat(list(first.values())), leaves=leaves, poses=torch.stack(poses),
                        track_losses=torch.cat(track_losses), map_s=map_s, track_s=time.perf_counter() - t0,
                        launches={k.name: k.launches for k in kernels}, all_reduce=dict(calls),
                        map_graphs=m.graphs.stats(), track_graphs=tr.graphs.stats(),
                        capture_mode=[m.graphs.capture_error_mode, tr.graphs.capture_error_mode],
                        k1_per_replay=[r.get("halo_fold", 0) for r in per_replay])

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = {"eager_dp": run("eager", shards), "graph_dp": run("graph", shards),
                   "graph_single": run("graph", None)}
    finally:
        dist.all_reduce = all_reduce
        dist.destroy_process_group()

    def compare(a, b):
        def first_diff(x, y):
            bad = torch.nonzero(x != y)
            return int(bad[0, 0]) if len(bad) else None

        return {
            "map_losses": torch.equal(a["map_losses"], b["map_losses"]),
            "map_leaves": all(torch.equal(x, y) for x, y in zip(a["leaves"], b["leaves"])),
            "track_poses": torch.equal(a["poses"], b["poses"]),
            "track_losses": torch.equal(a["track_losses"], b["track_losses"]),
            "first_differing_map_iteration": first_diff(a["map_losses"], b["map_losses"]),
            "first_differing_track_iteration": first_diff(a["track_losses"], b["track_losses"]),
            "max_abs_diff_leaves": max(float((x - y).abs().max()) for x, y in zip(a["leaves"], b["leaves"])),
            "max_abs_diff_poses": float((a["poses"] - b["poses"]).abs().max()),
        }

    out = {"setup_s": setup_s, "n_map_iters": len(res["eager_dp"]["map_losses"]),
           "n_track_iters": len(res["eager_dp"]["track_losses"]), "n_leaves": len(init),
           "graph_vs_eager": compare(res["graph_dp"], res["eager_dp"]),
           "group_vs_single": compare(res["graph_dp"], res["graph_single"]), "runs": {}}
    for name, r in res.items():
        out["runs"][name] = {k: r[k] for k in ("map_s", "track_s", "launches", "all_reduce", "map_graphs",
                                              "track_graphs", "capture_mode", "k1_per_replay")}
        out["runs"][name]["last_map_loss"] = float(r["map_losses"][-1])
    out["warnings"] = sorted({str(w.message).splitlines()[0][:160] for w in caught})
    print(DP_GRAPH_TAG + json.dumps(out), flush=True)


def phase_dp_graph(paths) -> None:
    """Phase 21: ``dp_graph_child`` as a world of one on NCCL. Fails
    unless the graphed dp run is ``torch.equal`` to the eager dp run in
    map losses, final leaves, tracked poses and tracking losses; both of
    its agents ran ``graph`` steps with captures and in ``thread_local``
    capture mode; every mapping program launches K1 in a replay; and some
    ``all_reduce`` calls were captured. Prints the graphed dp run against
    the single-process graphed run (``torch.equal`` expected: a one-rank
    sum is the identity; else the first differing iteration). The child's
    launches are recorded as three paths."""
    from attentive_dfprior_tpu_torch.tools import multihost_smoke as mh

    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8", RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(mh.free_port()))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--dp-graph-child"], env=env,
                          capture_output=True, text=True, timeout=900)
    for ln in proc.stdout.splitlines():
        if ln.startswith("dp graph child:"):
            print(ln)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(DP_GRAPH_TAG)]
    if proc.returncode != 0 or not lines:
        fail(f"dp graph child exited {proc.returncode}:\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    res = json.loads(lines[-1][len(DP_GRAPH_TAG):])
    for name, run in res["runs"].items():
        paths[f"dp_graph_{name}"] = run["launches"]
        print(f"dp graph {name}: mapping {run['map_s']:.2f} s ({json.dumps(run['map_graphs'])}), tracking "
              f"{run['track_s']:.2f} s ({json.dumps(run['track_graphs'])}), capture mode {run['capture_mode']}, "
              f"all_reduce calls {json.dumps(run['all_reduce'])}, K1 a replay by mapping program "
              f"{run['k1_per_replay']}, launches {json.dumps(run['launches'])}, last map loss {run['last_map_loss']:.6f}")
    for msg in res["warnings"]:
        print(f"dp graph: warning: {msg}")
    print(f"dp graph ({' '.join(GRAPH_EQUAL_SET)}, frame 0's map {res['n_map_iters']} iterations, frames "
          f"{list(GRAPH_EQUAL_TRACK)} tracked ({res['n_track_iters']} iterations), RayShards(1, (0,), WORLD) on NCCL; "
          f"set-up {res['setup_s']:.1f} s): graphed against eager on the group {json.dumps(res['graph_vs_eager'])}")
    print(f"dp graph: graphed on the group against graphed with no group (torch.equal expected: a one-rank sum "
          f"is the identity) {json.dumps(res['group_vs_single'])}")
    eq = res["graph_vs_eager"]
    if not all(eq[k] for k in ("map_losses", "map_leaves", "track_poses", "track_losses")):
        fail(f"dp graph: the graphed dp run differs from the eager dp run: {json.dumps(eq)}")
    g = res["runs"]["graph_dp"]
    if g["map_graphs"]["mode"] != "graph" or g["track_graphs"]["mode"] != "graph":
        fail(f"dp graph: an agent on the NCCL group ran {g['map_graphs']['mode']} / {g['track_graphs']['mode']} steps")
    if g["map_graphs"]["captures"] <= 0 or g["track_graphs"]["captures"] <= 0:
        fail(f"dp graph: no capture: {json.dumps(g['map_graphs'])} {json.dumps(g['track_graphs'])}")
    if g["capture_mode"] != ["thread_local", "thread_local"]:
        fail(f"dp graph: capture modes {g['capture_mode']} on an NCCL group (thread_local expected)")
    if not g["k1_per_replay"] or min(g["k1_per_replay"]) <= 0:
        fail(f"dp graph: a mapping program launches no K1 a replay: {g['k1_per_replay']}")
    if g["all_reduce"]["captured"] <= 0:
        fail(f"dp graph: no all_reduce was captured: {json.dumps(g['all_reduce'])}")


def phase_entry_loose(torch, dev, strict):
    """Phase 10(b): ``sync_method=loose`` through the entry point on frames
    0..15 as phase 4 runs them (loop closure on, panels every 5th frame),
    but with the final refine cut to LOOSE_REFINE_ITERS iterations a frame;
    ``strict``: phase 4's {wall_s, run_s, loop_s, track_interval_median_s},
    or None. Phase 4 renders the dataset's frames first, so the two runs'
    set-ups differ, and the refines differ in depth: compare their
    ``run()`` seconds without loop closure. Fails if the render programs
    captured more than a bound that publishes do not move. Returns the
    frames its prior fused."""
    from attentive_dfprior_tpu_torch import run as run_mod

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_loose_")
    argv = [ROOM_TRACKING, "--output", out_dir, "--device", "cuda", *PANELS_EVERY_5,
            "--set", "sync_method=loose", "--set", f"loop_closure.refine_iters={LOOSE_REFINE_ITERS}",
            "--end_idx", str(ENTRY_END)]
    os.chdir(REPO)
    t0 = time.perf_counter()
    slam = run_mod.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    records = [json.loads(ln) for ln in open(os.path.join(out_dir, "metrics.jsonl"))]
    events = [r["event"] for r in records]
    pubs = [r for r in records if r["event"] == "publish"]
    print(f"loose events by kind: {json.dumps({e: events.count(e) for e in sorted(set(events))})}; "
          f"publishes {len(pubs)} ({sum(r['publish_s'] for r in pubs):.4f} s: "
          f"{json.dumps([r['publish_s'] for r in pubs])}), skipped {events.count('publish_skip')}")
    for r in records:
        if r["event"] in ("map", "publish", "publish_skip"):
            print(f"loose {r['event']} frame {r['idx']}" + (f": losses {json.dumps(r['losses'])}" if r["event"] == "map" else ""))
    _, _, err = report_run(slam, out_dir, wall, "loose", records)
    programs = slam.forward_graphs.stats()
    bound = programs["threads"] * (1 + len(("high", "color")))  # a thread's render program and point queries
    print(f"loose: vis {slam.timings['vis']:.3f} s with the renders graphed (PR 13, eager renders: "
          f"{PR13_VIS_S['loose']} s); render programs captured {programs['captures']} for {len(pubs)} publishes "
          f"(at most {bound}: {programs['threads']} threads x one render and two point-query programs)")
    if programs["mode"] != "graph" or not 0 < programs["captures"] <= bound:
        fail(f"loose: {programs['captures']} render and field-query captures in {programs['mode']} mode "
             f"(expected 1 to {bound}, whatever the publishes)")
    reads = {}
    for r in records:
        if r["event"] == "track":
            reads.setdefault(r["read"], []).append(r["idx"])
    print(f"loose schedule, the frames tracked on each published map: {json.dumps(reads)}")
    median = track_interval_median(records)
    run_s, loop_s = slam.profiler.seconds["run"], slam.timings["loop"]
    print(f"loose (refine {LOOSE_REFINE_ITERS} iterations a frame): {wall:.1f} s ({run_s:.1f} s in run(), "
          f"{run_s - loop_s:.1f} s without loop closure), median track interval {median:.4f} s; strict (phase 4, "
          "same frames, refine as configured): " + (
              f"{strict['wall_s']:.1f} s ({strict['run_s']:.1f} s in run(), {strict['run_s'] - strict['loop_s']:.1f} "
              f"s without loop closure), {strict['track_interval_median_s']:.4f} s" if strict else "not run"))
    if float(np.sqrt(np.mean(err**2))) > 0.10:
        fail("loose: unaligned ATE above 10 cm")
    if "loop_relax" not in events or "loop_final_refine" not in events:
        fail(f"loose: loop closure did not run (relaxations {events.count('loop_relax')}, "
             f"refines {events.count('loop_final_refine')})")
    mapped = [r["idx"] for r in records if r["event"] == "map"]
    want = [i for i in range(ENTRY_END) if i % slam.every_frame == 0 or i == ENTRY_END - 1]
    if mapped != want:
        fail(f"loose: mapped frames {mapped}, strict's schedule maps {want}")
    if events.count("publish") + events.count("publish_skip") != len(mapped):
        fail("loose: a mapped frame was neither published nor skipped")
    check_panels(slam, 0, ENTRY_END, "loose")
    return fused_frames(slam)


def render_unpadded(torch, r, params, c2w, tsdf_volume, depth):
    """``r.render_img`` with every chunk, the last one too, rendered as it
    is: ``render_rays`` on at most ``ray_batch_size`` rays, unpadded."""
    from attentive_dfprior_tpu_torch.ops.rays import get_rays_full_image
    from attentive_dfprior_tpu_torch.render.renderer import render_rays

    cam, bs = r.cam, r.ray_batch_size
    ro, rd = get_rays_full_image(cam.H, cam.W, cam.fx, cam.fy, cam.cx, cam.cy,
                                 torch.as_tensor(np.asarray(c2w, np.float32), device=r.device))
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    gd = torch.as_tensor(np.asarray(depth, np.float32), device=r.device).reshape(-1)
    outs = []
    with torch.no_grad():
        for i in range(0, ro.shape[0], bs):
            outs.append(render_rays(params, ro[i : i + bs].contiguous(), rd[i : i + bs].contiguous(), gd[i : i + bs],
                                    tsdf_volume, r.tsdf_bnds, r.bound, "color", r.rcfg, fused=r.use_fused)[:3])
    torch.cuda.synchronize()
    d, v, c = (torch.cat(x) for x in zip(*outs))
    return d.reshape(cam.H, cam.W), v.reshape(cam.H, cam.W), c.reshape(cam.H, cam.W, 3)


def phase_render(torch, dev, slam, n_importance: int = 0):
    """The last mapped frame rendered from phase 4's map. (a) Through K2,
    then once more with the plain MLP on the same map and pose: the map
    moves between runs (ROADMAP F2), so the depth L1 of one run says little
    about K2; the gap between the two renders is K2's own. Fails if it
    shifts the mean depth by more than RENDER_GAP_M. (b) The graphed render
    (every chunk a replay of one program, K2 inside) against the eager
    render with the same padding: ``torch.equal`` in depth, variance and
    colour, then again after mapping iterations that wrote the decoders
    (the programs' static weight images must follow); the gap to the
    unpadded eager render printed; seconds per render, graphed and eager in
    turns. With ``n_importance`` (phase 5(b)) every render resamples each
    ray with ``rendering.N_importance = n_importance`` points, both passes
    through the same decoder path, and once more with ``perturb = 1.0``:
    graphed ``torch.equal`` to eager."""
    import dataclasses

    from attentive_dfprior_tpu_torch.render.renderer import Renderer
    from attentive_dfprior_tpu_torch.utils.step_graph import ForwardGraphs
    from attentive_dfprior_tpu_torch.utils.tree import tree_leaves

    last = ENTRY_END - 1
    _, color, depth, gt_c2w = slam.dataset[last]
    gt_d = torch.as_tensor(depth, device=dev)
    valid = gt_d > 0
    rcfg, renderer, label = slam.rcfg, slam.renderer, "render"
    if n_importance:
        rcfg = dataclasses.replace(slam.rcfg, N_importance=n_importance)
        renderer = Renderer(rcfg, slam.scene_cfg.bound, slam.tsdf_bnds, slam.cam, slam.device,
                            graphs=slam.forward_graphs)
        label = f"render N_importance={n_importance}"
    eager = Renderer(rcfg, slam.scene_cfg.bound, slam.tsdf_bnds, slam.cam, slam.device,
                     graphs=ForwardGraphs("eager", slam.device))
    if not renderer.graphs.graphed:
        fail(f"{label}: the system's renderer is not graphed ({renderer.graphs.mode})")
    c2w = slam.estimate_c2w_list[last]

    def render(r):
        out = r.render_img(slam.params, c2w, slam.tsdf_volume, gt_depth=depth)
        torch.cuda.synchronize()
        return out

    runs = {}
    for fused in (True, False):
        renderer.use_fused = fused
        t0 = time.perf_counter()
        d, _, c = render(renderer)
        dt = time.perf_counter() - t0
        if not (torch.isfinite(d).all() and torch.isfinite(c).all()):
            fail(f"{label} (fused={fused}): non-finite output")
        l1 = float((d - gt_d).abs()[valid].mean())
        cl1 = float((c - torch.as_tensor(color, device=dev)).abs().mean())
        print(f"{label} frame {last} ({tuple(d.shape)}, {'K2' if fused else 'plain MLP'}, graphed): {dt:.3f} s "
              f"(the first call captures), depth L1 {100 * l1:.3f} cm, color L1 {cl1:.4f}")
        runs[fused] = d, c
    renderer.use_fused = True
    (d, c), (dp, cp) = runs[True], runs[False]
    gap = float((d - dp).abs()[valid].mean())
    print(f"{label} K2 vs plain MLP: depth mean abs {100 * gap:.2e} cm (max {100 * float((d - dp).abs().max()):.2e} "
          f"cm), color max abs {float((c - cp).abs().max()):.2e}")
    if gap > RENDER_GAP_M:
        fail(f"{label}: K2 moves the mean depth {gap:.3e} m from the plain MLP's (limit {RENDER_GAP_M} m)")

    def check(when):
        g, e = render(renderer), render(eager)
        u = render_unpadded(torch, eager, slam.params, c2w, slam.tsdf_volume, depth)
        equal = {k: torch.equal(a, b) for k, a, b in zip(("depth", "var", "color"), g, e)}
        unpad = {k: float((a - b).abs().max()) for k, a, b in zip(("depth", "var", "color"), e, u)}
        print(f"{label} {when}: graphed against eager with the same padding torch.equal {json.dumps(equal)}; the "
              f"padded against the unpadded eager render, max abs {json.dumps(unpad)}")
        if not all(equal.values()):
            fail(f"{label} {when}: the graphed render differs from the eager render with the same padding: "
                 + json.dumps({k: float((a - b).abs().max()) for k, a, b in zip(("depth", "var", "color"), g, e)}))
        return g

    before = check("before")
    # mapping iterations that write the decoders (frame 15 alone, 10 joint
    # iterations through the mapper's own step programs), then again
    decoders = [t for name in ("low", "high", "color") for t in tree_leaves(slam.params[name])]
    held = [t.detach().clone() for t in decoders]  # no autograd node on a leaf: it would pin its stream
    cur = torch.as_tensor(np.asarray(color, np.float32), device=dev)[None]
    cur_d = gt_d[None]
    slam.mapper.optimize_map(slam.params, 10, slam.mapper.lr_factor, last, cur, cur_d, c2w[None].copy(),
                             generator=slam.generator)
    torch.cuda.synchronize()
    written = sum(not torch.equal(a, b) for a, b in zip(decoders, held))
    if not written:
        fail(f"{label}: the mapping iterations wrote no decoder leaf")
    after = check(f"after 10 mapping iterations that wrote {written} decoder leaves")
    if all(torch.equal(a, b) for a, b in zip(before, after)):
        fail(f"{label}: the render did not change after the mapping iterations")

    if n_importance:
        # perturb > 0: the program's importance uniforms are drawn once,
        # outside its capture, from a generator seeded 0: the draw each
        # eager chunk takes (and the JAX package's jit, from PRNGKey(0))
        prcfg = dataclasses.replace(rcfg, perturb=1.0)
        pg = Renderer(prcfg, slam.scene_cfg.bound, slam.tsdf_bnds, slam.cam, slam.device, graphs=slam.forward_graphs)
        pe = Renderer(prcfg, slam.scene_cfg.bound, slam.tsdf_bnds, slam.cam, slam.device,
                      graphs=ForwardGraphs("eager", slam.device))
        g, e = render(pg), render(pe)
        equal = {k: torch.equal(a, b) for k, a, b in zip(("depth", "var", "color"), g, e)}
        moved = float((g[0] - after[0]).abs().max())
        print(f"{label} perturb=1.0: graphed against eager torch.equal {json.dumps(equal)}; the perturbed draw moves "
              f"the depth by at most {moved:.3e} m from the deterministic render's")
        if not all(equal.values()):
            fail(f"{label} perturb=1.0: the graphed render differs from the eager render: "
                 + json.dumps({k: float((a - b).abs().max()) for k, a, b in zip(("depth", "var", "color"), g, e)}))

    times = {"graph": [], "eager": []}
    for mode in ["graph", "eager", "eager", "graph"] * 2:
        t0 = time.perf_counter()
        render(renderer if mode == "graph" else eager)
        times[mode].append(time.perf_counter() - t0)
    stats = slam.forward_graphs.stats()
    print(f"{label}: seconds per render, graphed {json.dumps([round(t, 4) for t in times['graph']])} (median "
          f"{np.median(times['graph']):.4f}), eager {json.dumps([round(t, 4) for t in times['eager']])} (median "
          f"{np.median(times['eager']):.4f}), {np.median(times['eager']) / np.median(times['graph']):.2f}x; "
          f"render programs {json.dumps(stats)}")
    return {"graph_s": float(np.median(times["graph"])), "eager_s": float(np.median(times["eager"]))}


def phase_mesh(torch, dev, slam):
    """SLAMSystem.get_mesh on phase 4's map with every frame's pose in the
    visibility mask (the eval_rec mesh): graphed (every field-query chunk a
    replay, K2 inside), then eager with the same padding, which must give
    equal occupancies on the whole lattice and an equal mesh; then through
    the plain MLP; all scored against the GT culled to the frames run: the
    gap between K2 and the plain MLP is K2's own, the rest moves with the
    map between runs."""
    from attentive_dfprior_tpu_torch.tools.eval_synthetic_demo import score_meshes
    from attentive_dfprior_tpu_torch.utils.mesher import Mesher
    from attentive_dfprior_tpu_torch.utils.step_graph import ForwardGraphs

    last = ENTRY_END - 1
    m = slam.mesher
    eager = Mesher(slam.cfg, slam.cam, slam.scene_cfg.bound, slam.tsdf_bnds, slam.device,
                   graphs=ForwardGraphs("eager", slam.device))
    if not m.graphs.graphed:
        fail(f"mesh: the system's Mesher is not graphed ({m.graphs.mode})")
    xs, ys, zs = m.get_grid_uniform(m.resolution)
    lattice = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), axis=-1).reshape(-1, 3).astype(np.float32)
    occ = {}
    for name, mesher in (("graphed", m), ("eager", eager)):
        t0 = time.perf_counter()
        occ[name] = mesher.eval_points(slam.params, lattice, slam.tsdf_volume_mesh, stage="high")
        print(f"mesh field query ({name}) over the whole {m.resolution}^3 lattice: "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
    if not np.array_equal(occ["graphed"], occ["eager"]):
        fail(f"mesh: graphed and eager occupancies differ (max abs {np.abs(occ['graphed'] - occ['eager']).max()})")
    meshes, labels = [], []
    for name, mesher, fused in (("graphed, K2", m, True), ("eager, K2", eager, True), ("graphed, plain MLP", m, False)):
        mesher.use_fused = fused
        slam.mesher = mesher
        path = os.path.join(slam.output, "mesh", f"chip_smoke_mesh_{len(meshes)}.ply")
        t0 = time.perf_counter()
        out = slam.get_mesh(path, idx=last, get_mask_use_all_frames=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        slam.mesher = m
        m.use_fused = True
        if out is None or len(out[1]) == 0:
            fail(f"mesh ({name}): no surface extracted")
        verts, faces = out
        if not np.isfinite(verts).all():
            fail(f"mesh ({name}): non-finite vertices")
        t = mesher.last_timings
        print(f"mesh ({name}): lattice {m.resolution}^3, marching tetrahedra {'native' if m.use_native else 'numpy'}: "
              f"{len(verts)} vertices, {len(faces)} faces; field query {t['field_s']:.3f} s, host steps "
              f"{t['host_s']:.3f} s ({wall:.3f} s in all)")
        meshes.append(out)
        labels.append(name)
    (v0, f0), (v1, f1) = meshes[0], meshes[1]
    same = v0.shape == v1.shape and f0.shape == f1.shape and np.array_equal(v0, v1) and np.array_equal(f0, f1)
    print(f"mesh graphed against eager: occupancies equal on {len(lattice)} lattice points, meshes equal {same}; "
          f"field-query programs {json.dumps(m.graphs.stats())}")
    if not same:
        fail("mesh: the graphed and the eager mesh differ")
    for name, metrics in zip((labels[0], labels[2]), score_meshes(slam.cfg, slam.cam, [meshes[0], meshes[2]],
                                                                  slam.gt_c2w_list[: last + 1])):
        print(f"mesh ({name}) vs GT culled to frames 0-{last}: {json.dumps(metrics)} (printed, no gate at "
              f"{last + 1} frames)")


def phase_room_yaml(torch, dev):
    """configs/Synthetic/room.yaml end to end through the entry point, then
    scored by ``tools/eval_synthetic_demo.py`` on its output; fails outside
    ROOM_GATE."""
    from attentive_dfprior_tpu_torch import run as run_mod
    from attentive_dfprior_tpu_torch.tools import eval_synthetic_demo

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_room_")
    os.chdir(REPO)
    t0 = time.perf_counter()
    slam = run_mod.main([ROOM, "--output", out_dir, "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    timings = {k: round(v, 3) for k, v in slam.timings.items()}
    print(f"room.yaml: {wall:.1f} s for {slam.last_idx + 1} frames (seconds by part: {json.dumps(timings)})")
    scored = eval_synthetic_demo.evaluate(ROOM, out_dir)
    metrics = scored["metrics_3d"]
    print(f"room.yaml eval_synthetic_demo: {json.dumps(scored)}; gate {json.dumps(ROOM_GATE)}")
    bad = [k for k, lim in ROOM_GATE.items()
           if (metrics[k] < lim if k == "completion_ratio_pct" else metrics[k] > lim)]
    if bad:
        fail(f"room.yaml mesh misses the gate on {bad}: {metrics}")


def phase_room_tracking(torch, dev, sync: str = "strict"):
    """configs/Synthetic/room_tracking.yaml whole through the entry point,
    as shipped (phase 9; fails above ATE_GATE_CM aligned ATE), or under
    ``sync_method=loose`` (phase 11; printed beside phase 9's strict run,
    no gate)."""
    from attentive_dfprior_tpu_torch import run as run_mod
    from attentive_dfprior_tpu_torch.tools.eval_synthetic_demo import score_meshes
    from attentive_dfprior_tpu_torch.utils.ply import read_ply

    out_dir = tempfile.mkdtemp(prefix=f"chip_smoke_tracking_{sync}_")
    os.chdir(REPO)
    t0 = time.perf_counter()
    slam = run_mod.main([ROOM_TRACKING, "--output", out_dir, "--device", "cuda", "--seed", "0",
                         "--set", f"sync_method={sync}"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    records = [json.loads(ln) for ln in open(os.path.join(out_dir, "metrics.jsonl"))]
    label = "room_tracking.yaml" + ("" if sync == "strict" else f" ({sync})")
    ate, aligned_err, _ = report_run(slam, out_dir, wall, label, records)
    q = np.percentile(100 * aligned_err, [25, 50, 75])
    gate = f"gate: aligned ATE <= {ATE_GATE_CM} cm" if sync == "strict" else "no gate"
    print(f"{label} aligned per-frame error (cm): quartiles {q[0]:.3f} / {q[1]:.3f} / {q[2]:.3f}, "
          f"max {100 * aligned_err.max():.3f} at frame {int(np.argmax(aligned_err))}; {gate} (JAX package, TPU, "
          f"seed 0, strict: 2.871 cm with loop closure, 5.82 cm without)")
    check_panels(slam, 0, slam.last_idx + 1, label)
    rec_v, rec_f, _ = read_ply(os.path.join(out_dir, "mesh", "final_mesh_eval_rec.ply"))
    metrics = score_meshes(slam.cfg, slam.cam, [(rec_v, rec_f)], slam.gt_c2w_list[: slam.last_idx + 1])[0]
    print(f"{label} final_mesh_eval_rec.ply ({len(rec_v)} vertices, {len(rec_f)} faces) vs GT culled "
          f"to all {slam.last_idx + 1} poses: {json.dumps(metrics)} (printed, no gate)")
    if sync != "strict":
        print(f"{label}: aligned ATE {100 * ate:.3f} cm in {wall:.1f} s; strict (phase 9 on NVIDIA H100 80GB HBM3, "
              f"700.00 W, PERF.md): 3.453 cm in 1014.7 s (printed, no gate)")
    elif 100 * ate > ATE_GATE_CM:
        fail(f"room_tracking.yaml: aligned ATE {100 * ate:.3f} cm above {ATE_GATE_CM} cm")


def phase_determinism(torch, dev, deterministic: bool = False) -> None:
    """Phase 6: frame 0's map of room_tracking.yaml (three stages, DET_SET)
    from one initial scene and generator state, in each step mode twice,
    each run with a fresh ``StepGraphs`` (a graphed run captures anew):
    fails unless each pair's per-iteration losses and final scene leaves
    are ``torch.equal``; graphed against eager is printed. With
    ``deterministic`` (phase 20, on request) the same four runs under
    ``torch.use_deterministic_algorithms``, printed, not gated. The prior
    fuses every 10th frame, not every frame, to keep the set-up short: the
    question is the same for any prior."""
    import warnings

    from attentive_dfprior_tpu_torch.config import default_config_path, load_config
    from attentive_dfprior_tpu_torch.run import apply_overrides
    from attentive_dfprior_tpu_torch.slam.system import SLAMSystem
    from attentive_dfprior_tpu_torch.utils.step_graph import StepGraphs
    from attentive_dfprior_tpu_torch.utils.tree import tree_leaves

    label = "determinism (deterministic algorithms)" if deterministic else "determinism"
    cfg = load_config(ROOM_TRACKING, default_config_path())
    apply_overrides(cfg, DET_SET)
    cfg["seed"] = 0
    t0 = time.perf_counter()
    slam = SLAMSystem(cfg, output=tempfile.mkdtemp(prefix="chip_smoke_det_"), device=dev)
    _, color, depth, gt = slam.dataset[0]
    print(f"{label}: system and prior built in {time.perf_counter() - t0:.1f} s")
    init = [t.detach().clone() for t in tree_leaves(slam.params)]
    gen_state = slam.generator.get_state()
    m = slam.mapper

    def map_frame0(mode):
        """Frame 0's mapping as ``SLAMSystem.run`` does it, from the saved
        start: (per-iteration losses, final scene leaves, seconds, the
        mapper graphs' counts)."""
        m.graphs = StepGraphs(mode, dev)
        with torch.no_grad():
            for t, t_init in zip(tree_leaves(slam.params), init):
                t.copy_(t_init)
        slam.generator.set_state(gen_state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, _, stage_losses = m.optimize_map(
            slam.params, m.iters_first, m.lr_first_factor, 0, slam._to_device(color)[None],
            slam._to_device(depth)[None], np.asarray(gt)[None], generator=slam.generator,
            cur_depth_np=np.asarray(depth), cur_c2w_np=gt,
        )
        torch.cuda.synchronize()
        return (torch.cat(list(stage_losses.values())).cpu(), [t.detach().clone() for t in tree_leaves(slam.params)],
                time.perf_counter() - t0, m.graphs.stats())

    def compare(a, b):
        """(losses equal, first differing iteration or None, leaves equal, max abs leaf difference)."""
        diff = (a[0] != b[0]).nonzero()
        leaves = all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
        return (torch.equal(a[0], b[0]), int(diff[0]) if len(diff) else None, leaves,
                max(float((x - y).abs().max()) for x, y in zip(a[1], b[1])))

    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            runs = {mode: (map_frame0(mode), map_frame0(mode)) for mode in ("graph", "eager")}
    finally:
        torch.use_deterministic_algorithms(False)
    bad = []
    for mode, (ra, rb) in runs.items():
        if not (torch.isfinite(ra[0]).all() and torch.isfinite(rb[0]).all()):
            fail(f"{label}: non-finite loss")
        losses_eq, first, leaves_eq, leaf_diff = compare(ra, rb)
        print(f"{label} {mode}: {ra[2]:.1f} + {rb[2]:.1f} s for 2 runs of {len(ra[0])} iterations "
              f"({' '.join(DET_SET)}); losses torch.equal {losses_eq} (first differing iteration {first}); "
              f"{len(ra[1])} final leaves torch.equal {leaves_eq} (max abs diff {leaf_diff:.3e}); last loss A "
              f"{float(ra[0][-1]):.6f}, B {float(rb[0][-1]):.6f}; mapper graphs {json.dumps(ra[3])}")
        if not (losses_eq and leaves_eq):
            bad.append(mode)
    losses_eq, first, leaves_eq, leaf_diff = compare(runs["graph"][0], runs["eager"][0])
    print(f"{label} graph against eager: losses torch.equal {losses_eq} (first differing iteration {first}); "
          f"final leaves torch.equal {leaves_eq} (max abs diff {leaf_diff:.3e})")
    for msg in sorted({str(w.message).splitlines()[0][:200] for w in caught}):
        print(f"{label}: warning: {msg}")
    if bad and not deterministic:
        fail(f"determinism: two default runs of frame 0's map differ ({', '.join(bad)})")


def fresh_workdir(prefix: str, configs_dir: str) -> str:
    """A new working directory holding links to ``configs_dir`` (as
    ``configs/``) and the repo's ``pretrained/``: the configs' relative
    paths resolve as in the repo, and no ``<dataset>_tsdf_volume`` cache of
    another run is there."""
    work = tempfile.mkdtemp(prefix=prefix)
    os.symlink(configs_dir, os.path.join(work, "configs"))
    os.symlink(os.path.join(REPO, "pretrained"), os.path.join(work, "pretrained"))
    return work


def render_fixture_frames(cam_cfg, n: int):
    """Frames 0..n-1 of room_tracking.yaml's trajectory (the pose at i/119
    on its 40-degree arc) rendered by the synthetic scene at camera
    ``cam_cfg``: [(c2w OpenGL float32, color (H, W, 3), depth (H, W))]."""
    from attentive_dfprior_tpu_torch.config import default_config_path, load_config
    from attentive_dfprior_tpu_torch.utils.datasets import FRAME_CACHE
    from attentive_dfprior_tpu_torch.utils.synthetic import SyntheticScene

    track = load_config(ROOM_TRACKING, default_config_path())
    n_traj = int(track["data"]["n_frames"])
    scene = SyntheticScene.from_config({"cam": cam_cfg, "data": track["data"]})
    poses = {i: scene.pose_at(i / (n_traj - 1)) for i in range(n)}
    FRAME_CACHE.render_many(scene, n_traj, poses)
    return [(poses[i], *FRAME_CACHE.render(scene, n_traj, i, poses[i])) for i in range(n)]


def _encode_frame(color, depth, depth_scale):
    """(BGR uint8 colour, uint16 depth x depth_scale) of a rendered frame."""
    import cv2

    if float(depth.max()) * depth_scale > 65535:
        fail(f"fixture depth {float(depth.max()):.3f} m does not fit uint16 at scale {depth_scale}")
    bgr = cv2.cvtColor(np.round(color * 255).astype(np.uint8), cv2.COLOR_RGB2BGR)
    return bgr, np.round(depth * depth_scale).astype(np.uint16)


def _opencv_pose(c2w):
    cv = np.asarray(c2w, dtype=np.float64).copy()
    cv[:3, 1] *= -1
    cv[:3, 2] *= -1
    return cv


def write_replica_fixture(folder: str, frames, depth_scale: float):
    """``results/frame%06d.jpg``, ``results/depth%06d.png`` and ``traj.txt``
    (one OpenCV c2w per line, 16 numbers); returns the uint16 depths."""
    import cv2

    res = os.path.join(folder, "results")
    os.makedirs(res)
    depths, lines = [], []
    for i, (c2w, color, depth) in enumerate(frames):
        bgr, d16 = _encode_frame(color, depth, depth_scale)
        cv2.imwrite(os.path.join(res, f"frame{i:06d}.jpg"), bgr)
        cv2.imwrite(os.path.join(res, f"depth{i:06d}.png"), d16)
        depths.append(d16)
        lines.append(" ".join(f"{v:.17g}" for v in _opencv_pose(c2w).reshape(-1)))
    with open(os.path.join(folder, "traj.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return depths


def write_scannet_fixture(folder: str, frames, depth_scale: float):
    """``frames/color/N.jpg``, ``frames/depth/N.png`` (depth x depth_scale)
    and ``frames/pose/N.txt`` (4 rows, OpenCV c2w); returns the depths."""
    import cv2

    base = os.path.join(folder, "frames")
    for sub in ("color", "depth", "pose"):
        os.makedirs(os.path.join(base, sub))
    depths = []
    for i, (c2w, color, depth) in enumerate(frames):
        bgr, d16 = _encode_frame(color, depth, depth_scale)
        cv2.imwrite(os.path.join(base, "color", f"{i}.jpg"), bgr)
        cv2.imwrite(os.path.join(base, "depth", f"{i}.png"), d16)
        depths.append(d16)
        with open(os.path.join(base, "pose", f"{i}.txt"), "w") as f:
            f.write("".join(" ".join(f"{v:.17g}" for v in row) + "\n" for row in _opencv_pose(c2w)))
    return depths


def check_read_back(label: str, ds, frames, depths16, depth_scale: float, edge: int) -> None:
    """Every frame of ``ds`` against what was written: depth (uint16 /
    scale, cropped by ``edge``) and pose equal, colour within
    COLOR_MEAN_GATE mean abs error of the render."""
    crop = slice(edge, -edge) if edge else slice(None)
    if len(ds) != len(frames):
        fail(f"{label}: the loader found {len(ds)} frames, {len(frames)} were written")
    errs = []
    t0 = time.perf_counter()
    for i, (c2w, color, _) in enumerate(frames):
        _, c, d, pose = ds[i]
        if not np.array_equal(d, (depths16[i].astype(np.float32) / depth_scale)[crop, crop]):
            fail(f"{label}: frame {i}'s depth differs from what was written")
        if not np.array_equal(pose, np.asarray(c2w, np.float32)):
            fail(f"{label}: frame {i}'s pose differs from what was written")
        errs.append(np.abs(c - color[crop, crop]))
    read_s = (time.perf_counter() - t0) / len(frames)
    mean = float(np.mean([e.mean() for e in errs]))
    print(f"{label} read-back: {len(frames)} frames of {tuple(d.shape)}, depth and poses equal; colour mean abs "
          f"error {mean:.6f} ({255 * mean:.3f}/255, gate {255 * COLOR_MEAN_GATE:.0f}/255), max "
          f"{max(float(e.max()) for e in errs):.4f}; {read_s:.4f} s per frame read (JPEG + PNG + conversions)")
    if mean > COLOR_MEAN_GATE:
        fail(f"{label}: colour mean abs error {mean:.6f} above {COLOR_MEAN_GATE:.6f}")


def phase_replica(torch, dev, configs_dir: str):
    """Phase 12: room0.yaml on a Replica-layout fixture through the builder
    CLI and the entry point, both with ``--input_folder``. Returns
    {"slam", "out_dir"}."""
    import argparse

    import cv2

    from attentive_dfprior_tpu_torch import run as run_mod
    from attentive_dfprior_tpu_torch.config import default_config_path, load_config
    from attentive_dfprior_tpu_torch.tools.eval_synthetic_demo import score_meshes
    from attentive_dfprior_tpu_torch.tsdf import builder
    from attentive_dfprior_tpu_torch.utils.datasets import get_dataset
    from attentive_dfprior_tpu_torch.utils.ply import read_ply

    work = fresh_workdir("chip_smoke_replica_", configs_dir)
    os.chdir(work)
    cfg = load_config(REPLICA_ROOM0, default_config_path())
    cam, scale = cfg["cam"], float(cfg["cam"]["png_depth_scale"])
    print(f"image codec: OpenCV {cv2.__version__} (cv2.imwrite / cv2.imread)")
    fixture = os.path.join(work, "fixture_room0")  # not the config's data.input_folder
    t0 = time.perf_counter()
    frames = render_fixture_frames(cam, REPLICA_END)
    t1 = time.perf_counter()
    depths16 = write_replica_fixture(fixture, frames, scale)
    print(f"replica fixture: {REPLICA_END} frames of {cam['H']}x{cam['W']} rendered in {t1 - t0:.1f} s, written in "
          f"{time.perf_counter() - t1:.1f} s to {fixture}")
    ds = get_dataset(cfg, argparse.Namespace(input_folder=fixture), cfg.get("scale", 1))
    check_read_back("replica", ds, frames, depths16, scale, int(cam.get("crop_edge", 0)))

    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # the process's earlier phases
    t0 = time.perf_counter()
    npz = builder.main([REPLICA_ROOM0, "--input_folder", fixture, "--output", "replica_tsdf_volume",
                        "--device", dev.type])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    with np.load(npz) as data:
        shape, observed = data["tsdf"].shape, float(data["observed"].mean())
    from attentive_dfprior_tpu_torch.ops.cuda import tsdf_kernel

    fused = len(range(0, REPLICA_END, int(cfg["tsdf"]["space"])))
    print(f"builder: {npz}: {shape} = {int(np.prod(shape)) / 1e6:.1f} M voxels of {cfg['tsdf']['voxel_size']} m, "
          f"{100 * observed:.2f} % observed, every {cfg['tsdf']['space']} frame(s); {build_s:.1f} s, peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (PR 13, the eager fusion: "
          f"{PR13_BUILDER_PEAK_GIB} GiB), {(torch.cuda.max_memory_allocated() - held) / 2**30:.2f} GiB above the "
          f"{held / 2**30:.2f} GiB the process held before; K5 launched {tsdf_kernel.KERNEL.launches} times for "
          f"{fused} frames fused")
    if tsdf_kernel.KERNEL.launches != fused:
        fail(f"builder: K5 launched {tsdf_kernel.KERNEL.launches} times for {fused} frames")

    out_dir = os.path.join(work, "out")
    argv = [REPLICA_ROOM0, "--input_folder", fixture, "--output", out_dir, "--device", dev.type,
            "--end_idx", str(REPLICA_END), "--set", f"mapping.iters_first={REPLICA_ITERS_FIRST}", *PANELS_EVERY_5]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    slam = run_mod.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"replica: prior source {slam.tsdf_source}")
    if os.path.abspath(slam.tsdf_source) != os.path.abspath(npz):
        fail(f"replica: the prior came from {slam.tsdf_source}, not from the builder's cache {npz}")
    records = [json.loads(ln) for ln in open(os.path.join(out_dir, "metrics.jsonl"))]
    for r in records:
        if r["event"] == "track":
            print(f"replica track frame {r['idx']}: loss {r['loss']:.4f}")
        elif r["event"] == "map":
            print(f"replica map frame {r['idx']}: losses {json.dumps(r['losses'])}")
    _, _, err = report_run(slam, out_dir, wall, "replica", records)
    print(f"replica: peak device memory {peak:.2f} GiB")
    mapped = [r["idx"] for r in records if r["event"] == "map"]
    want = [i for i in range(REPLICA_END) if i % slam.every_frame == 0 or i == REPLICA_END - 1]
    if mapped != want:
        fail(f"replica: mapped frames {mapped}, the schedule maps {want}")
    if float(np.sqrt(np.mean(err**2))) > 0.10:
        fail("replica: unaligned ATE above 10 cm")
    check_panels(slam, 0, REPLICA_END, "replica")
    rec_v, rec_f, _ = read_ply(os.path.join(out_dir, "mesh", "final_mesh_eval_rec.ply"))
    metrics = score_meshes(slam.cfg, slam.cam, [(rec_v, rec_f)], slam.gt_c2w_list[:REPLICA_END])[0]
    print(f"replica final_mesh_eval_rec.ply ({len(rec_v)} vertices, {len(rec_f)} faces) vs GT culled to frames "
          f"0-{REPLICA_END - 1}: {json.dumps(metrics)} (printed, no gate)")
    os.chdir(REPO)
    return {"slam": slam, "out_dir": out_dir}


def phase_scannet_read(configs_dir: str) -> None:
    """Phase 13(a): a ScanNet-layout fixture read back through ``ScanNet``."""
    import argparse

    from attentive_dfprior_tpu_torch.config import default_config_path, load_config
    from attentive_dfprior_tpu_torch.utils.datasets import ScanNet, get_dataset

    work = fresh_workdir("chip_smoke_scannet_", configs_dir)
    os.chdir(work)
    cfg = load_config(SCANNET_SCENE, default_config_path())
    cam, scale, edge = cfg["cam"], float(cfg["cam"]["png_depth_scale"]), int(cfg["cam"]["crop_edge"])
    fixture = os.path.join(work, "scene0000_00")
    frames = render_fixture_frames(cam, 3)
    depths16 = write_scannet_fixture(fixture, frames, scale)
    ds = get_dataset(cfg, argparse.Namespace(input_folder=fixture), cfg.get("scale", 1))
    want = (cam["H"] - 2 * edge, cam["W"] - 2 * edge)
    if not isinstance(ds, ScanNet) or ds[0][2].shape != want:
        fail(f"scannet: {type(ds).__name__} gives depth of {ds[0][2].shape}, expected {want}")
    check_read_back("scannet", ds, frames, depths16, scale, edge)
    os.chdir(REPO)


def phase_pretrain(torch, dev, steps: int):
    """Phases 13(b) and 14: ``pretrain_decoders`` at its shipped widths for
    ``steps`` steps to a temporary path, one graph replayed a step; fails
    on a non-finite loss, a last loss not below the first, K1 launches
    other than two a step (a replay counts its capture's), or an ``.npz``
    that does not load. Returns (the ``.npz`` path, losses)."""
    from attentive_dfprior_tpu_torch.models.decoders import init_df_decoders, load_pretrained_npz
    from attentive_dfprior_tpu_torch.ops.cuda.halo_fold_kernel import KERNEL as K1
    from attentive_dfprior_tpu_torch.tools import pretrain_decoders

    out = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_pretrain_"), "low_high.npz")
    before = K1.launches
    t0 = time.perf_counter()
    path, losses = pretrain_decoders.main(["--out", out, "--steps", str(steps), "--device", dev.type])
    wall = time.perf_counter() - t0
    k1 = K1.launches - before
    print(f"pretrain: {steps} steps in {wall:.2f} s ({1e3 * wall / steps:.3f} ms per step, the write included); "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; K1 launches {k1} ({k1 / steps:g} a step)")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        fail(f"pretrain: losses {losses[0]} -> {losses[-1]} (finite and falling expected)")
    if k1 != 2 * steps:
        fail(f"pretrain: K1 launched {k1} times, expected {2 * steps}")
    dec = load_pretrained_npz(init_df_decoders(torch.Generator().manual_seed(0)), path)
    if dec["high"]["fc_c"][0]["w"].shape[0] != 64:
        fail("pretrain: the written high decoder does not take 64 features")
    return path, losses


def phase_pretrain_modes(torch, dev) -> None:
    """Phase 13(b), the pretrain's step program: PRETRAIN_EQUAL_STEPS
    steps graphed and eager from the same seed (``pretrain_decoders.train``)
    must be ``torch.equal`` in every loss and every final leaf, the graphed
    run one capture replayed; then PRETRAIN_STEPS steps a rep, graphed and
    eager in turns, PRETRAIN_TIMED_REPS reps each: ms a step over the
    steps after the warm-up and the capture (``init_train``'s program, the
    set-up outside the clock)."""
    from attentive_dfprior_tpu_torch.tools import pretrain_decoders
    from attentive_dfprior_tpu_torch.utils.step_graph import WARMUP_ITERS
    from attentive_dfprior_tpu_torch.utils.tree import tree_leaves

    runs = {mode: pretrain_decoders.train(PRETRAIN_EQUAL_STEPS, device=dev, step_mode=mode)
            for mode in ("graph", "eager")}
    (pg, lg, gg), (pe, le, _) = runs["graph"], runs["eager"]
    equal = {"losses": torch.equal(lg, le),
             "leaves": all(torch.equal(a, b) for a, b in zip(tree_leaves(pg), tree_leaves(pe)))}
    gap = max(float((a - b).detach().abs().max()) for a, b in zip(tree_leaves(pg), tree_leaves(pe)))
    print(f"pretrain graphed against eager, {PRETRAIN_EQUAL_STEPS} steps: torch.equal {json.dumps(equal)}, "
          f"max abs leaf diff {gap:.3e}, graphs {json.dumps(gg.stats())}")
    if not all(equal.values()):
        fail(f"pretrain: the graphed steps differ from the eager steps: {json.dumps(equal)}")
    if gg.stats()["captures"] != 1 or gg.stats()["mode"] != "graph":
        fail(f"pretrain: the graphed run is not one capture replayed: {json.dumps(gg.stats())}")
    del runs, pg, pe, lg, le, gg
    warm = WARMUP_ITERS + 1  # the graph's eager warm-ups and its capture, run before the clock
    ms = {"graph": [], "eager": []}
    for _ in range(PRETRAIN_TIMED_REPS):
        for mode in ms:
            _, losses, _, step = pretrain_decoders.init_train(PRETRAIN_STEPS, device=dev, step_mode=mode)
            for _ in range(warm):
                step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(PRETRAIN_STEPS - warm):
                step()
            torch.cuda.synchronize()
            ms[mode].append(round(1e3 * (time.perf_counter() - t0) / (PRETRAIN_STEPS - warm), 4))
            if not bool(torch.isfinite(losses).all()):
                fail(f"pretrain {mode}: a non-finite loss")
    med = {m: float(np.median(v)) for m, v in ms.items()}
    print(f"pretrain in turns, steps {warm + 1}-{PRETRAIN_STEPS} of each rep timed: ms a step graphed {ms['graph']}, "
          f"eager {ms['eager']}; medians {med['graph']:.4f} / {med['eager']:.4f} ({med['eager'] / med['graph']:.2f}x)")


def visible_vertices(verts, faces, poses, cam, tol: float = 0.02):
    """Vertices of a mesh that some pose sees: in the image, within ``tol``
    of the mesh's own rasterized depth there."""
    from attentive_dfprior_tpu_torch import native

    seen = np.zeros(len(verts), dtype=bool)
    homo = np.concatenate([verts, np.ones((len(verts), 1))], axis=1)
    for c2w in poses:
        w2c = np.linalg.inv(_opencv_pose(c2w))
        depth = native.rasterize_depth(verts, faces, w2c, cam.fx, cam.fy, cam.cx, cam.cy, cam.H, cam.W)
        p = (w2c @ homo.T).T[:, :3]
        z = np.maximum(p[:, 2], 1e-9)
        u = np.round(cam.fx * p[:, 0] / z + cam.cx).astype(np.int64)
        v = np.round(cam.fy * p[:, 1] / z + cam.cy).astype(np.int64)
        inside = (p[:, 2] > 0) & (u >= 0) & (u < cam.W) & (v >= 0) & (v < cam.H)
        d = np.zeros(len(verts))
        d[inside] = depth[v[inside], u[inside]]
        seen |= inside & (np.abs(d - p[:, 2]) < tol)
    return seen


def phase_refuse(torch, dev, replica) -> None:
    """Phase 13(c): ``evaluate_scannet.refuse`` on the card along phase
    12's poses, of the synthetic GT mesh (gates: recall and completion
    against the GT vertices those poses see) and of phase 12's mesh
    (printed). Accuracy, precision and F-score are printed, not gated: the
    JAX package's face rule, which ``refuse`` keeps, meshes the frusta's
    sides (ROADMAP F10)."""
    from attentive_dfprior_tpu_torch.tools.evaluate_scannet import evaluate_mesh_metrics, refuse
    from attentive_dfprior_tpu_torch.utils.ply import read_ply
    from attentive_dfprior_tpu_torch.utils.synthetic import SyntheticScene

    slam = replica["slam"]
    poses, cam = slam.gt_c2w_list[:REPLICA_END], slam.cam
    gt_v, gt_f, _ = SyntheticScene.from_config(slam.cfg).gt_mesh(resolution=192)
    seen = gt_v[visible_vertices(gt_v, gt_f, poses, cam)]
    rec_v, rec_f, _ = read_ply(os.path.join(replica["out_dir"], "mesh", "final_mesh_eval_rec.ply"))
    for label, (v, f) in (("GT mesh", (gt_v, gt_f)), ("replica mesh", (rec_v, rec_f))):
        t0 = time.perf_counter()
        rv, rf = refuse(v, f, poses, cam, device=dev)
        dt = time.perf_counter() - t0
        if not (len(rf) and np.isfinite(rv).all()):
            fail(f"refuse ({label}): {len(rf)} faces, finite vertices {bool(np.isfinite(rv).all())}")
        metrics = evaluate_mesh_metrics(rv, seen)
        print(f"refuse ({label}, {len(f)} faces, voxel 0.01 m, {len(poses)} poses of {cam.H}x{cam.W}): {dt:.2f} s, "
              f"{len(rf)} faces; vs the GT's {len(seen)} vertices these poses see: {json.dumps(metrics)}")
        if label == "GT mesh" and (metrics["Recal"] < REFUSE_RECALL_GATE or metrics["Comp"] > REFUSE_COMP_GATE):
            fail(f"refuse: the GT re-fused reads recall {metrics['Recal']:.4f} and completion "
                 f"{metrics['Comp']:.4f} m against the GT surface the poses see (gates {REFUSE_RECALL_GATE}, "
                 f"{REFUSE_COMP_GATE} m)")


def reference_checkpoint(torch, slam) -> dict:
    """Phase 12's scene in the reference's ``.tar`` layout (ref:
    src/utils/Logger.py:24-34): grids [1, C, NZ, NY, NX], decoders as an
    nn.Module state dict (Linear weights (out, in))."""
    params = {k: (v.detach().cpu() if torch.is_tensor(v) else v) for k, v in slam.params.items()}
    sd = {}

    def linear(name, p):
        sd[f"{name}.weight"] = p["w"].detach().cpu().T.contiguous()
        sd[f"{name}.bias"] = p["b"].detach().cpu().clone()

    for prefix in ("low", "high", "color"):
        d = slam.params[prefix]
        sd[f"{prefix}_decoder.embedder._B"] = d["B"].detach().cpu().clone()
        for i in range(len(d["pts"])):
            linear(f"{prefix}_decoder.pts_linears.{i}", d["pts"][i])
            linear(f"{prefix}_decoder.fc_c.{i}", d["fc_c"][i])
        linear(f"{prefix}_decoder.output_linear", d["out"])
    for i, layer in enumerate(slam.params["mlp"]["layers"]):
        linear(f"mlp.pts_linears.{i}", layer)
    linear("mlp.output_linear", slam.params["mlp"]["out"])
    n = slam.last_idx + 1
    return {
        "c": {k: params[k].permute(3, 2, 1, 0).contiguous()[None] for k in ("grid_low", "grid_high", "grid_color")},
        "decoder_state_dict": sd,
        "gt_c2w_list": torch.from_numpy(slam.gt_c2w_list[:n].copy()),
        "estimate_c2w_list": torch.from_numpy(slam.estimate_c2w_list[:n].copy()),
        "keyframe_list": [int(i) for i in slam.keyframes.frame_idx],
        "idx": torch.tensor(slam.last_idx),
    }


def phase_convert(torch, replica) -> None:
    """Phase 13(d): phase 12's scene as a reference ``.tar``, converted by
    ``convert_reference_ckpt`` and loaded back through ``load_checkpoint``
    onto the card: every leaf equal to the scene's."""
    from attentive_dfprior_tpu_torch.tools import convert_reference_ckpt
    from attentive_dfprior_tpu_torch.utils.logger import load_checkpoint
    from attentive_dfprior_tpu_torch.utils.tree import tree_leaves

    slam = replica["slam"]
    work = tempfile.mkdtemp(prefix="chip_smoke_convert_")
    tar, out = os.path.join(work, f"{slam.last_idx:05d}.tar"), os.path.join(work, f"{slam.last_idx:05d}.npz")
    ckpt = reference_checkpoint(torch, slam)
    torch.save(ckpt, tar)
    t0 = time.perf_counter()
    convert_reference_ckpt.main([tar, out])
    params, meta = load_checkpoint(out, slam.params)
    leaves, want = tree_leaves(params), tree_leaves(slam.params)
    same = sum(bool(torch.equal(a, b.detach())) for a, b in zip(leaves, want))
    print(f"convert: {os.path.getsize(tar) / 2**20:.1f} MiB .tar -> {os.path.getsize(out) / 2**20:.1f} MiB .npz and "
          f"back in {time.perf_counter() - t0:.2f} s; {same} of {len(want)} leaves equal on {leaves[0].device}; "
          f"idx {meta['idx']}, keyframes {[int(i) for i in meta['keyframe_idx_list']]}")
    if same != len(want) or meta["idx"] != slam.last_idx or list(meta["keyframe_idx_list"]) != ckpt["keyframe_list"]:
        fail("convert: the converted checkpoint does not load back as the scene it came from")


def phase_prior_gates(torch, dev, path: str) -> None:
    """Phase 14's gates on the prior at ``path`` (the contract of
    tests/test_pretrained_prior.py, run by the port on the card)."""
    from attentive_dfprior_tpu_torch.config import default_config_path, load_config
    from attentive_dfprior_tpu_torch.models.decoders import init_df_decoders, load_pretrained_npz, mlp_decoder_forward
    from attentive_dfprior_tpu_torch.ops.adam import adam_init
    from attentive_dfprior_tpu_torch.slam.mapper import StageLRs, mapping_stage
    from attentive_dfprior_tpu_torch.slam.system import SLAMSystem
    from attentive_dfprior_tpu_torch.utils.tree import tree_map

    dec = tree_map(lambda t: t.to(dev), load_pretrained_npz(init_df_decoders(torch.Generator().manual_seed(0)), path))
    rng = np.random.default_rng(0)
    p = torch.as_tensor(rng.uniform(-3, 3, (2000, 3)).astype(np.float32), device=dev)
    c0 = torch.as_tensor(rng.normal(0, 0.01, (2000, 32)).astype(np.float32), device=dev)
    kick = torch.as_tensor(rng.choice([-0.5, 0.5], size=(2000, 32)).astype(np.float32), device=dev)
    with torch.no_grad():
        occ0 = mlp_decoder_forward(dec["low"], p, c0).abs().cpu().numpy()
        occ1 = mlp_decoder_forward(dec["low"], p, c0 + kick).abs().cpu().numpy()
    p99 = float(np.percentile(occ1, 99))
    print(f"prior: max |occ| at rest {occ0.max():.4f}, p99 |occ| under +-0.5 kicks {p99:.4f} (gates 1.9)")
    if occ0.max() >= 1.9 or p99 >= 1.9:
        fail("prior: the decoders saturate under Adam-scale feature steps")

    os.chdir(REPO)
    cfg = load_config(ROOM, default_config_path())
    cfg["data"]["n_frames"] = 3
    cfg["cam"].update(H=48, W=64, fx=48.0, fy=48.0, cx=31.5, cy=23.5)
    cfg["tsdf"]["voxel_size"] = 0.05
    cfg["rendering"]["N_samples"] = 24
    cfg["rendering"]["N_surface"] = 8
    cfg["pretrained_decoders"]["low_high"] = path
    slam = SLAMSystem(cfg, output=tempfile.mkdtemp(prefix="chip_smoke_prior_"), device=dev)
    if not slam.scene_cfg.fix_high:
        fail("prior: the high decoder is not frozen with a prior loaded")
    _, color, depth, c2w = slam.dataset[0]
    m, n = slam.mapper, 80
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True), slam.params)
    losses = mapping_stage(
        params, adam_init(params), torch.as_tensor(color, device=dev)[None], torch.as_tensor(depth, device=dev)[None],
        torch.as_tensor(np.asarray(c2w, np.float32), device=dev)[None], None, m.tsdf_volume, m.tsdf_bnds, m.bound,
        n, [0.0] * n, StageLRs(0.0, 0.0, 0.5, 0.0, 0.0), "low", 500, m.cam, m.rcfg, (True, True), 0.2,
        generator=torch.Generator(device=dev).manual_seed(3),
    ).cpu().numpy()
    plateau = 0.8 * float(np.asarray(depth).mean()) * 500
    print(f"prior: first-frame low stage at lr 0.5, loss {losses[0]:.2f} -> {losses[-1]:.2f} in {n} iterations "
          f"(gates: below {0.5 * losses[0]:.2f}, and below {plateau:.2f}, the near-plane plateau)")
    if not (losses[-1] < 0.5 * losses[0] and losses[-1] < plateau):
        fail("prior: the first-frame low stage did not converge with the pretrained decoders")


def phase_dp(torch, paths) -> None:
    """Phase 15, ray-axis data parallelism. (a) the entry point's
    ``--multihost --init_only`` in a child, a world of one on NCCL (the
    launcher's variables set here), must print its line and exit 0. (b)
    ``room_tracking.yaml`` with DP_SET to frame DP_END - 1 (strict, loop
    closure as shipped) through ``SLAMSystem.run``, as two ranks on
    ``cuda:0`` joined over gloo (NCCL refuses two ranks on one device), as
    one process, and as the witness (the one process with every grid
    element moved one ulp), all four children at once
    (``tools/multihost_smoke.py:slam_worker``). Fails unless the
    ranks' final scene leaves and trajectories are equal, every loss is
    finite, K1 ran in each rank, and ``multihost_smoke.compare_slam``'s
    gates hold: frame 0's first MAP_AGREE_ITERS map losses within
    MAP_LOSS_RTOL of the single run, and frame 0's map losses, the tracked
    and the refined trajectory each within max(MAP_LOSS_RTOL or
    TRAJ_GATE_M, WITNESS_FACTOR x the witness's gap). The seconds are no
    speed claim: four processes share one card and gloo stages through
    host memory."""
    from attentive_dfprior_tpu_torch.tools import multihost_smoke as mh

    t0 = time.perf_counter()
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(mh.free_port()))
    proc = subprocess.run([sys.executable, "-m", "attentive_dfprior_tpu_torch.run", ROOM_TRACKING, "--multihost",
                           "--init_only"], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("multihost:")]
    print(f"dp (a) run --multihost --init_only, world of one: exit {proc.returncode}, {lines}, "
          f"{time.perf_counter() - t0:.1f} s")
    if proc.returncode != 0 or lines != ["multihost: process 0/1, backend nccl, device cuda:0"]:
        fail(f"dp (a): --init_only on NCCL:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")

    work = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    rec = os.path.join(work, "slam")
    spec = dict(config=os.path.relpath(ROOM_TRACKING, REPO), overrides=DP_SET, end_idx=DP_END, device="cuda:0",
                backend="gloo", threads=1)  # one torch CPU thread a child, as phase 16's
    env = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}  # deterministic cuBLAS
    t0 = time.perf_counter()
    started = {
        name: mh.start("slam", dict(spec, output=os.path.join(work, name), record=f"{rec}.{name}",
                                    perturb_ulp=name == "witness"), world, env)
        for name, world in (("dp", 2), ("single", 0), ("witness", 0))
    }
    results, errors = {}, []
    for name, handle in started.items():  # finish stops its children, whatever happens
        try:
            results[name] = mh.finish(handle, timeout=900)
        except RuntimeError as e:
            errors.append(f"{name}: {e}")
    wall = time.perf_counter() - t0
    if errors:
        fail("dp (b): " + "\n".join(errors))
    ranks, single, witness = results["dp"], results["single"][0], results["witness"][0]
    for r in ranks:
        paths[f"dp_rank{r['rank']}"] = r["launches"]
    paths["dp_single"] = single["launches"]
    paths["dp_witness"] = witness["launches"]
    for tag, r in [(f"rank {r['rank']}/{r['world']}", r) for r in ranks] + [("single", single), ("witness", witness)]:
        print(f"dp (b) {tag} on {r['device']} ({r['step_mode']} steps): seconds by part "
              f"{json.dumps({k: round(v, 3) for k, v in r['seconds'].items()})}, launches {json.dumps(r['launches'])}, "
              f"events {r['events']}")
    cmp = mh.compare_slam(ranks, single, rec, witness)
    a, b, w = (np.asarray(r["map_losses_frame0"]) for r in (ranks[0], single, witness))
    picks = sorted({0, 1, 10, len(b) // 2, len(b) - 1} & set(range(len(b))))
    print("dp (b) frame 0 map losses (iteration: 2 ranks / single / witness): "
          + ", ".join(f"{i}: {a[i]:.6f} / {b[i]:.6f} / {w[i]:.6f}" for i in picks))
    for name in ("dp_vs_single", "witness_vs_single"):
        g = cmp[name]
        print(f"dp (b) {name}: frame 0 max relative gap per 10 iterations "
              + " ".join(f"{x:.1e}" for x in g["frame0_rel_per_10_iters"])
              + f"; mm by frame, tracked {g['before_refine_diff_mm_by_frame']}, refined {g['traj_diff_mm_by_frame']}")
    for name, r in (("dp", ranks[0]), ("witness", witness)):
        gaps = []
        for x, y in zip(r["track_iter_losses"], single["track_iter_losses"]):
            q = np.abs(np.asarray(x) - np.asarray(y)) / np.maximum(np.abs(np.asarray(y)), 1e-12)
            gaps.append(f"{float(q[0]):.1e}/{float(q.max()):.1e}")
        print(f"dp (b) {name} tracking losses, relative gap to the single run per tracked frame "
              f"(first iteration / max): " + " ".join(gaps))
    print(f"dp (b) {' '.join(DP_SET)}, frames 0-{DP_END - 1}, gloo: replicas equal "
          f"{cmp['replicas_equal']} over {cmp['n_leaves']} leaves, finite {cmp['finite']}, unaligned ATE (mm) "
          f"{json.dumps(cmp['ate_vs_gt_mm'])}; {wall:.1f} s for the four children")
    print(f"dp (b) gates (dp's gap to the single run, the witness's, the limit): {json.dumps(cmp['gates'])}")
    if not cmp["replicas_equal"]:
        fail("dp (b): the two ranks' final scenes or trajectories differ")
    if not cmp["finite"]:
        fail("dp (b): a non-finite loss")
    for key, g in cmp["gates"].items():
        if not g["ok"]:
            fail(f"dp (b): {key}: the dp run parts from the single run by {g['dp']:.4g} (witness {g['witness']}, "
                 f"limit {g['limit']:.4g})")
    if any(set(r["step_mode"].values()) != {"eager"} for r in ranks):
        fail(f"dp (b): a dp rank ran {[r['step_mode'] for r in ranks]} steps: gloo collectives run eager")
    if not all(r["dp"] for r in ranks) or any(r["launches"]["halo_fold"] <= 0 for r in ranks):
        fail(f"dp (b): not both ranks ran dp mapping through K1: {[(r['dp'], r['launches']) for r in ranks]}")


def granted_before_map(log, midx: int):
    """The frames after ``midx`` whose track unit a decision log
    (``slam/schedule.py:UnitSchedule.records``) granted before map
    ``midx``'s unit: the tracker ran them while that map was pending."""
    units = [(r["unit"], r["idx"]) for r in log]
    if ("map", midx) not in units:
        return []
    return [i for u, i in units[: units.index(("map", midx))] if u == "track" and i > midx]


def phase_async_ranks(torch, paths, strict_entry) -> None:
    """Phase 16, the async agents across processes, every child on
    ``cuda:0`` over gloo, (a) and (b) at once. (a) phase 10(a)'s child as
    the two ranks of a group (``async_equal_child``: strict, loose and free
    in turn through the entry point with ``parallel.enable=True``, GT poses,
    deterministic): fails unless in each rank loose's and free's final scene
    leaves are ``torch.equal`` to strict's (and the writer's checkpoints),
    both ranks hold the same scene, rank 1's decision logs are replays of
    rank 0's, and loose's and free's logs grant a frame after OVERLAP_MAP
    before that map (``late_map_grant``: rank 1's own mapper asks first,
    so it replays an order its own timing would not give). (b)
    ``parallel.split: {map: 1, track: 1}`` under ``loose`` on frames
    0..ENTRY_END - 1 as phase 4 runs them (loop closure and the
    final refine as shipped; no panels), through
    ``tools/multihost_smoke.py:slam_worker``: fails without a publish,
    without K1 on the map rank, on a non-finite loss, when the track rank's
    final scene is not the map rank's (``compare_async``), or with the trajectory
    more than SPLIT_TRAJ_GATE_M from phase 4's strict run (without phase 4,
    a strict single child at phase 4's settings runs beside); prints
    unaligned and aligned ATE. (b)'s children run in a fresh working
    directory that holds the prior built here once (the builder's cache,
    every frame fused as the config asks) instead of fusing the 120 frames
    each. ``strict_entry``: phase 4's record, or None. The seconds are no
    speed claim: the ranks time-slice one card."""
    from attentive_dfprior_tpu_torch.config import default_config_path, load_config
    from attentive_dfprior_tpu_torch.tools import eval_ate
    from attentive_dfprior_tpu_torch.tools import multihost_smoke as mh
    from attentive_dfprior_tpu_torch.tsdf.builder import save_tsdf_volume

    work = fresh_workdir("chip_smoke_async_ranks_", os.path.join(REPO, "configs"))
    os.chdir(REPO)  # the config's relative paths
    cfg = load_config(ROOM_TRACKING, default_config_path())
    t0 = time.perf_counter()
    cache = save_tsdf_volume(cfg, space=int(cfg["tsdf"]["space"]), device="cuda",
                             out_dir=os.path.join(work, f"{cfg['data']['dataset']}_tsdf_volume"))
    print(f"async ranks (b): the prior for the split children built in {time.perf_counter() - t0:.1f} s -> "
          f"{os.path.relpath(cache, work)}")
    # one torch CPU thread a child: four children's thread pools would oversubscribe the host's cores
    base = dict(config=os.path.relpath(ROOM_TRACKING, REPO), device="cuda:0", backend="gloo", threads=1)
    # (b) as phase 4 runs it, the refine at 100 iterations a frame as shipped (at phase 10(b)'s 20, one
    # call of three parted 21.71 cm from phase 4, whose refine runs 100)
    runs = {"split": (dict(base, overrides=[], end_idx=ENTRY_END, sync="loose",
                           split={"map": 1, "track": 1}), 2)}
    if strict_entry is None:
        runs["strict_single"] = (dict(base, overrides=[], end_idx=ENTRY_END, sync="strict"), 0)
    t0 = time.perf_counter()
    port = mh.free_port()
    equal = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--async-equal-child"],
                              env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8", RANK=str(r), WORLD_SIZE="2",
                                       LOCAL_RANK="0", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                                       OMP_NUM_THREADS="1"),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    started = {name: mh.start("slam", dict(spec, output=os.path.join(work, name), record=os.path.join(work, name)),
                              world, {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}, cwd=work)
               for name, (spec, world) in runs.items()}
    results, errors, outs = {}, [], []
    try:
        outs = [p.communicate(timeout=900)[0] for p in equal]
    finally:
        for p in equal:
            if p.poll() is None:
                p.kill()
                p.wait()
    for name, handle in started.items():  # finish stops its children, whatever happens
        try:
            results[name] = mh.finish(handle, timeout=900)
        except RuntimeError as e:
            errors.append(f"{name}: {e}")
    wall = time.perf_counter() - t0
    lines = [[ln for ln in out.splitlines() if ln.startswith(CHILD_TAG)] for out in outs]
    if any(p.returncode != 0 for p in equal) or not all(lines):
        errors.append("(a): " + "\n---\n".join(out[-3000:] for out in outs))
    if errors:
        fail("async ranks: " + "\n".join(errors))
    ranks = [json.loads(ln[-1][len(CHILD_TAG):]) for ln in lines]
    for name, procs in results.items():
        for r in procs:
            paths[f"async_ranks_{name}_rank{r['rank']}"] = r["launches"]
            print(f"async ranks {name} rank {r['rank']}/{r['world']} ({r['role']}{', writer' if r['writer'] else ''}, "
                  f"{r['step_mode']} steps): seconds by part {json.dumps({k: round(v, 3) for k, v in r['seconds'].items()})}, "
                  f"launches {json.dumps(r['launches'])}, {len(r['schedule'])} log records")
    print(f"async ranks: {wall:.1f} s for {2 + sum(max(w, 1) for _, w in runs.values())} children")

    # (a) shared dp, GT poses: each rank equal to strict on 2 ranks, rank 1 replaying rank 0
    for res in ranks:
        for sync, run in res["runs"].items():
            paths[f"async_ranks_{sync}_dp_rank{res['rank']}"] = run["launches"]
            print(f"async ranks (a) {sync} rank {res['rank']}/2 ({run['role']}, {run['step_mode']} steps): "
                  f"{run['wall_s']:.1f} s, events "
                  f"{json.dumps(run['events'])}, launches {json.dumps(run['launches'])}, log {json.dumps(run['log'])}")
        ckpt = f", final checkpoint {json.dumps(res['ckpt_equal'])}" if "ckpt_equal" in res else ""
        print(f"async ranks (a) rank {res['rank']}/2 ({' '.join(ASYNC_DP_SET)}, frames 0-{ASYNC_EQUAL_END - 1}, "
              f"deterministic): {res['n_leaves']} scene leaves torch.equal to strict's on 2 ranks "
              f"{json.dumps(res['equal'])}{ckpt}; max abs diff {json.dumps(res['max_abs_diff'])}")
        for msg in res["warnings"]:
            print(f"async ranks (a): warning: {msg}")
        if not all(res["equal"].values()) or not all(res.get("ckpt_equal", {}).values()):
            fail(f"async ranks (a) rank {res['rank']}: the final scene differs from strict's on 2 ranks")
        if any(run["launches"]["halo_fold"] <= 0 for run in res["runs"].values()):
            fail(f"async ranks (a) rank {res['rank']}: a run mapped without K1")
        if any(set(run["step_mode"].values()) != {"eager"} for run in res["runs"].values()):
            fail(f"async ranks (a) rank {res['rank']}: a dp run on gloo did not run eager steps")
    lead, follower = sorted(ranks, key=lambda r: r["rank"])
    for sync in ("strict", "loose", "free"):
        if lead["runs"][sync]["digest"] != follower["runs"][sync]["digest"]:
            fail(f"async ranks (a) {sync}: the two ranks' final scenes differ")
        if lead["runs"][sync]["log"] != follower["runs"][sync]["log"]:
            fail(f"async ranks (a) {sync}: rank 1's decision log is not rank 0's")
    print("async ranks (a): both ranks' scenes equal and rank 1's logs replays of rank 0's for strict, loose, free")
    early = {sync: granted_before_map(lead["runs"][sync]["log"], OVERLAP_MAP) for sync in ("loose", "free")}
    print(f"async ranks (a): frames granted before map {OVERLAP_MAP} (tracked while it was pending; rank 0's "
          f"mapper asks late, late_map_grant) {json.dumps(early)}")
    if not all(early.values()):
        fail(f"async ranks (a): no frame after {OVERLAP_MAP} was granted before map {OVERLAP_MAP}: {json.dumps(early)}")

    # (b) split 1+1, tracking on
    ranks = results["split"]
    mapper, tracker = ranks
    ev = tracker["schedule_events"]
    arrays = np.load(os.path.join(work, f"split.rank{tracker['rank']}.npz"))
    est, gt = arrays["traj"], arrays["gt"]
    if strict_entry is not None:
        ref = strict_entry["traj"]
    else:
        ref = np.load(os.path.join(work, "strict_single.rank0.npz"))["traj"]
    gap = np.linalg.norm(est[:, :3, 3] - ref[:, :3, 3], axis=1)
    err = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=1)
    _, _, aligned = eval_ate.align(gt[:, :3, 3].T.astype(np.float64), est[:, :3, 3].T.astype(np.float64))
    pubs = [i for e, i in ev if e == "publish"]
    print(f"async ranks (b) split 1+1 loose, frames 0-{ENTRY_END - 1} (as phase 4): events "
          f"{json.dumps(ev)}; the map rank's jobs {json.dumps(mapper['schedule'])}; the track lead's log "
          f"{json.dumps(tracker['schedule'])}; kinds {tracker['events']}")
    replicas_equal = mh.compare_async(ranks, os.path.join(work, "split"))["replicas_equal"]
    print(f"async ranks (b) split: unaligned ATE RMSE {100 * float(np.sqrt(np.mean(err ** 2))):.3f} cm, aligned "
          f"{100 * float(np.sqrt(np.mean(aligned ** 2))):.3f} cm; gap to phase 4's strict run per frame (cm) "
          + " ".join(f"{100 * g:.2f}" for g in gap) + f"; replicas equal {replicas_equal}")
    if not replicas_equal:
        fail("async ranks (b) split: the track rank's final scene is not the map rank's (the last broadcast)")
    if not pubs:
        fail("async ranks (b) split: no publish")
    if mapper["launches"]["halo_fold"] <= 0:
        fail(f"async ranks (b) split: the map rank launched no K1: {mapper['launches']}")
    if not (mapper["all_map_losses_finite"] and np.isfinite(tracker["track_losses"]).all()):
        fail("async ranks (b) split: a non-finite loss")
    if float(gap.max()) > SPLIT_TRAJ_GATE_M:
        fail(f"async ranks (b) split: the trajectory parts from phase 4's strict run by {100 * gap.max():.2f} cm")
    if any(set(r["step_mode"].values()) != {"graph"} for r in ranks):
        fail(f"async ranks (b) split: a rank ran eager steps ({[r['step_mode'] for r in ranks]}): each agent is "
             "alone in its group, so both graph")


def phase_harnesses(torch, drive, paths) -> dict:
    """Phase 17, the port's harnesses on the card, each through its own
    ``main``: (a) ``tools/bench.py --workload BENCH_WORKLOAD`` at BENCH_REPS
    reps (the ScanNet shape: 345 M prior voxels, 5000 rays over a window
    of 10); fails on a non-finite loss, without K1 in the cycle, or
    without peak memory; (b)
    ``tools/profile_mapping.py`` over every row (``full_iter_color``
    graphed and ``full_iter_color_eager``, in turns); fails on a non-finite
    row, unless K1 runs in the ``halo`` rows alone and K3 in the ``pallas``
    rows alone, or if the graphed iteration counts other launches than the
    eager one; (c) ``tools/bench_scaling.py --devices 1 --pixels
    SCALING_PIXELS``, a world of one on NCCL, with the comm model's
    prediction for 2, 4 and 8 H100s; fails on a non-finite loss or without
    K1 in the child. Returns (a)'s median cycle seconds by step mode."""
    from attentive_dfprior_tpu_torch.tools import bench, bench_scaling, profile_mapping

    work = tempfile.mkdtemp(prefix="chip_smoke_harnesses_")
    os.chdir(REPO)

    # (a) the benchmark's JSON line
    t0 = time.perf_counter()
    out = drive("bench", bench.main, ["--workload", BENCH_WORKLOAD, "--reps", str(BENCH_REPS),
                                      "--out", os.path.join(work, "bench.json")])
    recs = {out["workload"]: out["record"]}
    if "eager" in out:
        recs[f"{out['workload']} eager"] = out["eager"]
    for name, rec in recs.items():
        mem = rec["device_peak_mem_gb"]
        print(f"bench {name} ({rec['step_mode']}): {rec['rays_per_s']:.1f} rays/s (min {rec['rays_per_s_min']:.1f}, "
              f"max {rec['rays_per_s_max']:.1f}), cycle {rec['cycle_s_median']:.4f} s = mapping "
              f"{rec['map_s_median']:.4f} s + tracking {rec['track_s_median']:.4f} s over {rec['rays_per_cycle']} "
              f"rays (reps {json.dumps(rec['rep_times_s'])}); prior {rec['tsdf_dims']} = {rec['tsdf_voxels'] / 1e6:.1f} "
              f"M voxels; this mode's own peak device memory {mem} GiB (the {rec['device_mem_held_on_entry_gb']} GiB "
              f"held on entry and the other mode's scene not counted), graph pools {rec['graph_pool_gb']} GiB; "
              f"launches per cycle "
              f"{json.dumps(rec['launches_per_cycle'])}; graphs {json.dumps(rec['graphs'])}; build "
              f"{rec['build_s']:.1f} s, warm-up {rec['warmup_s']:.1f} s")
        if not rec["losses_finite"]:
            fail(f"bench {name}: a non-finite loss")
        if rec["launches_per_cycle"]["halo_fold"] <= 0:
            fail(f"bench {name}: the cycle launched no K1")
        if mem is None:
            fail(f"bench {name}: no peak device memory")
    if not out["graphed"] or "eager" not in out:
        fail(f"bench: the JSON line's headline is not graphed with an eager record beside it ({out['step_mode']})")
    print(f"bench: est_model_flops_per_s {out['est_model_flops_per_s'] / 1e12:.4f} TFLOP/s; "
          f"{time.perf_counter() - t0:.1f} s")

    # (b) where a mapping iteration's milliseconds go
    t0 = time.perf_counter()
    rows = drive("profile_mapping", profile_mapping.main,
                 ["--json", os.path.join(work, "profile.json"), "--iters", str(PROFILE_ITERS), "--reps",
                  str(PROFILE_REPS)])["rows"]
    print(f"profile_mapping: {len(rows)} rows in {time.perf_counter() - t0:.1f} s")
    for name, r in rows.items():
        k1, k3 = r["launches_per_iter"]["halo_fold"], r["launches_per_iter"]["cell_stencil"]
        print(f"profile {name}: {r['ms_per_iter']:.4f} ms/iter (reps {r['rep_ms']}), device "
              f"{r['device_ms_per_iter']} ms/iter over {r['device_kernels_per_iter']} kernels/iter, host launches "
              f"{r['host_launches_per_iter']} /iter; K1 {k1}, K3 {k3} a iteration")
        if not r["finite"]:
            fail(f"profile {name}: non-finite output")
        halo = name in PROFILE_HALO_ROWS
        pallas = name.startswith("scatter_bwd_pallas_")
        if (k1 > 0) != halo or (k3 > 0) != pallas:
            fail(f"profile {name}: K1 {k1} and K3 {k3} a iteration (expected K1 {'> 0' if halo else '0'}, "
                 f"K3 {'> 0' if pallas else '0'})")
    if rows["full_iter_color"]["launches_per_iter"] != rows["full_iter_color_eager"]["launches_per_iter"]:
        fail("profile full_iter_color: the replays count other launches than the eager iteration")
    # the cell scatter's two rows again at the ScanNet shape's mapping rays, into its high grid
    t0 = time.perf_counter()
    rows = drive("profile_scatter_scannet", profile_mapping.profile, "cuda", PROFILE_ITERS, PROFILE_REPS,
                 "cell_scatter", "scannet", SCANNET_RAYS)
    for name, r in rows.items():
        print(f"profile {name} (scannet, {SCANNET_RAYS} rays): {r['ms_per_iter']:.4f} ms/iter (reps {r['rep_ms']}), "
              f"device {r['device_ms_per_iter']} ms/iter over {r['device_kernels_per_iter']} kernels/iter")
        if not r["finite"]:
            fail(f"profile {name} (scannet): non-finite output")
    print(f"profile_mapping cell_scatter rows at the ScanNet shape: {time.perf_counter() - t0:.1f} s")

    # (c) dp scaling, a world of one, graphed and eager in turns
    t0 = time.perf_counter()
    scal = bench_scaling.main(["--devices", "1", "--pixels", SCALING_PIXELS, "--reps", str(SCALING_REPS),
                               "--step-modes", "graph,eager", "--out", os.path.join(work, "scaling.json")])
    for rec in scal["raw"]:
        paths[f"scaling_{rec['base_pixels']}px"] = rec["launches"]
        by = rec["by_mode"]
        print(f"scaling n=1 {rec['base_pixels']} rays ({rec['backend']}, {rec['device']}, headline "
              f"{rec['step_mode']} steps, {SCALING_REPS} reps a mode in turns): graphed "
              f"{by['graph']['rays_per_s']:.1f} rays/s ({1e3 * by['graph']['step_s']:.3f} ms a step, "
              f"{json.dumps(by['graph']['graphs'])}), eager {by['eager']['rays_per_s']:.1f} rays/s "
              f"({1e3 * by['eager']['step_s']:.3f} ms a step): "
              f"{by['graph']['rays_per_s'] / by['eager']['rays_per_s']:.2f}x; {rec['grad_bytes_per_step']} gradient "
              f"bytes a step, launches {json.dumps(rec['launches'])}")
        if not rec["losses_finite"] or rec["launches"]["halo_fold"] <= 0:
            fail(f"scaling {rec['base_pixels']} rays: finite {rec['losses_finite']}, launches {rec['launches']}")
        if rec["step_mode"] != "graph" or by["graph"]["graphs"]["captures"] <= 0:
            fail(f"scaling {rec['base_pixels']} rays: the one-rank baseline ran {rec['step_mode']} steps "
                 f"({json.dumps(by['graph']['graphs'])}): graphed expected")
    model = scal["comm_model"]
    print(f"scaling comm model (a prediction, not a measurement; {model['device_kind']}, "
          f"{model['assumed_link_bw_bidi_bytes_per_s'] / 1e9:.0f} GB/s bidirectional a GPU, from the measured "
          f"{1e3 * model['measured_step_s_1dev']:.3f} ms one-card step): strong "
          f"{json.dumps(model['strong'])}; weak {json.dumps(model['weak'])}; {time.perf_counter() - t0:.1f} s")
    return {"graph": out["record"]["cycle_s_median"], "eager": out["eager"]["cycle_s_median"]}


def phase_ablation(work: str) -> None:
    """Phase 18 (on request): ``tools/ablate_tracking.py --variants
    ABLATION_VARIANTS --end_idx ABLATION_END``, then ``tools/collect_ablation.py``
    on its record; prints each variant's aligned ATE (no gate)."""
    from attentive_dfprior_tpu_torch.tools import ablate_tracking, collect_ablation

    os.chdir(REPO)
    raw, merged = os.path.join(work, "ablate_tracking.json"), os.path.join(work, "ablation.json")
    t0 = time.perf_counter()
    ablate_tracking.main(["--variants", ABLATION_VARIANTS, "--end_idx", str(ABLATION_END), "--out", raw,
                          "--out-root", work])
    payload = collect_ablation.main([merged, raw])
    for r in payload["ranked"]:
        run = payload["runs"][r["variant"]]
        print(f"ablation {r['variant']} ({json.dumps(r['overrides'])}): aligned ATE {run['ate_cm_aligned']} cm, "
              f"unaligned {run['ate_cm_unaligned']} cm over {run['n_frames']} frames, {run['wall_s']} s (no gate)")
    print(f"ablation: {time.perf_counter() - t0:.1f} s")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6,7,10,12,13,15,16,17,19,21",
                    help="comma-separated phases to run (8, 9, 11, 14, 18 and 20 only on request)")
    ap.add_argument("--async-equal-child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--graph-equal-child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--dp-graph-child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.async_equal_child:
        async_equal_child()
        return
    if args.graph_equal_child:
        graph_equal_child()
        return
    if args.dp_graph_child:
        dp_graph_child()
        return
    phases = {int(x) for x in args.phases.split(",")}
    if 7 in phases and 4 not in phases:
        fail("phase 7 meshes phase 4's map: run it with phase 4")
    if 13 in phases and 12 not in phases:
        fail("phase 13 re-fuses and converts phase 12's map: run it with phase 12")
    if 20 in phases:
        if 6 in phases:
            fail("phase 20 fixes cuBLAS's workspace for the whole process: run it apart from phase 6")
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # deterministic cuBLAS

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA card")
    sys.path.insert(0, REPO)
    from attentive_dfprior_tpu_torch.ops.cuda import build

    dev = torch.device("cuda", 0)
    kernels = build.port_kernels()
    paths = {}  # path -> {kernel: launches}, each counted from 0
    images = {}  # path -> K2 weight images built (one per decoder and parameter version)
    from attentive_dfprior_tpu_torch.ops.cuda.decoder_kernel import TC_CACHE

    def drive(name, fn, *args):
        for k in kernels:
            k.launches = 0
        builds = TC_CACHE.builds
        out = fn(*args)
        paths[name] = {k.name: k.launches for k in kernels}
        images[name] = TC_CACHE.builds - builds
        return out

    t_start = time.perf_counter()
    t_phase = [t_start]

    def done(phase: int) -> None:
        now = time.perf_counter()
        print(f"phase {phase}: {now - t_phase[0]:.1f} s", flush=True)
        t_phase[0] = now

    card = phase_env(torch, build, kernels)
    done(1)
    kern = None
    if 2 in phases:
        kern = phase_kernels(torch, dev)
        done(2)
    if 3 in phases:
        room0, room0_cycles = phase_room0(torch, dev, kernels)
        for label, res in room0.items():
            paths[f"room0_cycle_{label}"] = res["launches"]
        done(3)
    strict_entry = None
    if 4 in phases:
        slam, strict_entry = drive("entry", phase_entry, torch, dev)
        if min(paths["entry"][k] for k in ("halo_fold", "decoder_mlp", "cell_scatter", "trilinear_gather")) <= 0:
            fail(f"the entry point launched K1 (halo fold) {paths['entry']['halo_fold']} times, K2 (decoder "
                 f"MLP) {paths['entry']['decoder_mlp']} times, K4 (cell scatter) {paths['entry']['cell_scatter']} "
                 f"times and K7 (trilinear lookup) {paths['entry']['trilinear_gather']} times (expected each > 0)")
        # the run and its resume each fuse the prior on the fly
        check_fusion_launches(paths, "entry", 2 * fused_frames(slam))
        phase_prior_equal(torch, dev, slam)
        done(4)
        if 5 in phases:
            render_times = drive("render", phase_render, torch, dev, slam)
            if paths["render"]["decoder_mlp"] <= 0 or paths["render"]["trilinear_gather"] <= 0:
                fail("the render launched no K2 (decoder MLP) or no K7 (trilinear lookup)")
            drive("render_importance", phase_render, torch, dev, slam, IMPORTANCE_N)
            if paths["render_importance"]["decoder_mlp"] <= 0:
                fail("the resampled render launched no K2 (decoder MLP)")
            done(5)
        if 7 in phases:
            drive("mesh", phase_mesh, torch, dev, slam)
            if paths["mesh"]["decoder_mlp"] <= 0:
                fail("the Mesher launched no K2 (decoder MLP)")
            done(7)
    if 19 in phases:
        phase_graph_equal(paths)
        done(19)
    if 21 in phases:
        phase_dp_graph(paths)
        done(21)
    if 6 in phases:
        drive("determinism", phase_determinism, torch, dev)
        done(6)
    if 20 in phases:
        drive("determinism_algorithms", phase_determinism, torch, dev, True)
        done(20)
    if 8 in phases:
        drive("room_yaml", phase_room_yaml, torch, dev)
        done(8)
    if 9 in phases:
        drive("room_tracking", phase_room_tracking, torch, dev)
        done(9)
    if 10 in phases:
        phase_async_equal(paths)
        loose = drive("entry_loose", phase_entry_loose, torch, dev, strict_entry)
        if paths["entry_loose"]["halo_fold"] <= 0 or paths["entry_loose"]["decoder_mlp"] <= 0:
            fail(f"the loose entry point launched K1 (halo fold) {paths['entry_loose']['halo_fold']} times and K2 "
                 f"(decoder MLP) {paths['entry_loose']['decoder_mlp']} times (expected both > 0)")
        check_fusion_launches(paths, "entry_loose", loose)
        done(10)
    if 11 in phases:
        drive("room_tracking_loose", phase_room_tracking, torch, dev, "loose")
        done(11)
    configs_dir = os.path.join(REPO, "configs")
    if 12 in phases:
        replica = drive("replica", phase_replica, torch, dev, configs_dir)
        if paths["replica"]["halo_fold"] <= 0 or paths["replica"]["decoder_mlp"] <= 0:
            fail(f"the Replica entry point launched K1 (halo fold) {paths['replica']['halo_fold']} times and K2 "
                 f"(decoder MLP) {paths['replica']['decoder_mlp']} times (expected both > 0)")
        check_mask_launches(paths, "replica", replica["out_dir"], replica["slam"])
        done(12)
    if 13 in phases:
        phase_scannet_read(configs_dir)
        drive("pretrain", phase_pretrain, torch, dev, PRETRAIN_STEPS)
        drive("pretrain_modes", phase_pretrain_modes, torch, dev)
        drive("refuse", phase_refuse, torch, dev, replica)
        check_fusion_launches(paths, "refuse", 2 * REPLICA_END)  # two meshes re-fused along phase 12's poses
        phase_convert(torch, replica)
        done(13)
    if 15 in phases:
        phase_dp(torch, paths)
        done(15)
    if 16 in phases:
        phase_async_ranks(torch, paths, strict_entry)
        done(16)
    if 17 in phases:
        bench_cycle_s = phase_harnesses(torch, drive, paths)
        done(17)
    if 18 in phases:
        drive("ablation", phase_ablation, tempfile.mkdtemp(prefix="chip_smoke_ablation_"))
        done(18)
    if 14 in phases:
        t0 = time.perf_counter()
        path, losses = drive("pretrain_full", phase_pretrain, torch, dev, 6000)
        print(f"pretrain (6000 steps): {time.perf_counter() - t0:.1f} s, final loss {losses[-1]:.4f}")
        phase_prior_gates(torch, dev, path)
        done(14)
    if 3 in phases:
        profile_cycles(torch, room0_cycles, room0)
        print(f"phase 3 profile: {time.perf_counter() - t_phase[0]:.1f} s")
        t_phase[0] = time.perf_counter()
    if 17 in phases:
        profile_bench_cycles(torch, dev, bench_cycle_s)
        print(f"phase 17(a) profile: {time.perf_counter() - t_phase[0]:.1f} s")
        t_phase[0] = time.perf_counter()
    if 4 in phases and 5 in phases:
        profile_renders(torch, slam, render_times)
        print(f"phase 5 profile: {time.perf_counter() - t_phase[0]:.1f} s")
    print(f"launches by path: {json.dumps(paths)}")
    print(f"K2 weight images built by path: {json.dumps(images)}")
    if kern is not None:
        def launches(name):
            return sum(p[name] for p in paths.values())

        k1, k2, k3, k4, k5, k6, k7 = (kern[k] for k in ("K1", "K2", "K3", "K4", "K5", "K6", "K7"))
        line = {"kernels": [
            {"name": "halo_fold", "route": "cuda", "source": "attentive_dfprior_tpu_torch/csrc/halo_fold.cu",
             "replaces": "attentive_dfprior_tpu/ops/pallas/halo_fold_kernel.py:87",
             "launches": launches("halo_fold"), "max_abs_err": k1["max_abs_err"],
             "ms": k1["C32"]["ms"], "plain_ms": k1["C32"]["plain_ms"], "bound_ms": k1["C32"]["bound_ms"],
             "bound_by": "bytes", "library_ms": k1["C32"]["library_ms"]},
            {"name": "decoder_mlp", "route": "cuda", "source": "attentive_dfprior_tpu_torch/csrc/decoder_mlp.cu",
             "replaces": "attentive_dfprior_tpu/ops/pallas/decoder_kernel.py:115",
             "launches": launches("decoder_mlp"), "max_abs_err": k2["max_abs_err"],
             "ms": k2["c32o1n480000"]["ms"], "plain_ms": k2["c32o1n480000"]["plain_ms"],
             "bound_ms": k2["c32o1n480000"]["bound_ms"], "bound_by": "operations", "library_ms": None},
            {"name": "cell_stencil", "route": "cuda", "source": "attentive_dfprior_tpu_torch/csrc/cell_stencil.cu",
             "replaces": "attentive_dfprior_tpu/ops/pallas/stencil_kernel.py:87",
             "launches": launches("cell_stencil"), "max_abs_err": k3["max_abs_err"],
             "ms": k3["C32"]["ms"], "plain_ms": k3["C32"]["plain_ms"], "bound_ms": k3["C32"]["bound_ms"],
             "bound_by": "bytes", "library_ms": k3["C32"]["library_ms"]},
            {"name": "cell_scatter", "route": "cuda", "source": "attentive_dfprior_tpu_torch/csrc/cell_scatter.cu",
             "replaces": "attentive_dfprior_tpu/ops/grid_sample.py:322",
             "launches": launches("cell_scatter"), "max_abs_err": k4["max_abs_err"],
             "ms": k4[K4_TIMED]["ms"], "plain_ms": k4[K4_TIMED]["plain_ms"], "bound_ms": k4[K4_TIMED]["bound_ms"],
             "bound_by": "bytes", "library_ms": k4[K4_TIMED]["library_ms"],
             "graph_ms": k4[K4_TIMED]["graph_ms"], "library_graph_ms": k4[K4_TIMED]["library_graph_ms"],
             "kernels_per_call": k4[K4_TIMED]["kernels_per_call"]},
            {"name": "tsdf_integrate", "route": "cuda", "source": "attentive_dfprior_tpu_torch/csrc/tsdf_integrate.cu",
             "replaces": "attentive_dfprior_tpu/tsdf/fusion.py:32",
             "launches": launches("tsdf_integrate"), "max_abs_err": k5["max_abs_err"],
             "ms": k5["room0"]["ms"], "plain_ms": k5["room0"]["plain_ms"], "bound_ms": k5["room0"]["bound_ms"],
             "bound_by": k5["room0"]["bound_by"], "library_ms": None,
             "device_ms": k5["room0"]["device_ms"], "cuda_launches_per_call": k5["room0"]["cuda_launches"],
             "voxels_updated": k5["room0"]["updated"], "voxels_kept": k5["room0"]["voxels_kept"],
             "scannet_ms": k5["scannet"]["ms"], "scannet_plain_ms": k5["scannet"]["plain_ms"],
             "scannet_bound_ms": k5["scannet"]["bound_ms"], "scannet_device_ms": k5["scannet"]["device_ms"]},
            {"name": "frustum_mask", "route": "cuda", "source": "attentive_dfprior_tpu_torch/csrc/frustum_mask.cu",
             "replaces": "attentive_dfprior_tpu_torch/slam/mapper.py:get_frustum_mask (numpy, host)",
             "launches": launches("frustum_mask"), "max_abs_err": 0.0,
             "ms": k6["room0"]["ms"], "plain_ms": k6["room0"]["plain_ms"], "bound_ms": k6["room0"]["bound_ms"],
             "bound_by": "bytes", "library_ms": None, "device_ms": k6["room0"]["device_ms"],
             "cuda_launches_per_call": k6["room0"]["cuda_launches"], "route_host_ms": k6["room0"]["route_host_ms"],
             "scannet_ms": k6["scannet"]["ms"], "scannet_plain_ms": k6["scannet"]["plain_ms"],
             "scannet_bound_ms": k6["scannet"]["bound_ms"], "scannet_device_ms": k6["scannet"]["device_ms"],
             "scannet_route_host_ms": k6["scannet"]["route_host_ms"]},
            {"name": "trilinear_gather", "route": "cuda",
             "source": "attentive_dfprior_tpu_torch/csrc/trilinear_gather.cu",
             "replaces": "attentive_dfprior_tpu_torch/ops/grid_sample.py:trilinear_sample (XLA gathers in the JAX "
                         "package)",
             "launches": launches("trilinear_gather"), "max_abs_err": 0.0,
             "ms": k7["render high"]["ms"], "plain_ms": k7["render high"]["plain_ms"],
             "bound_ms": k7["render high"]["bound_ms"], "bound_by": "bytes",
             "library_ms": k7["render high"]["library_ms"],
             "pair_ms": k7["render high+colour"]["ms"], "pair_plain_ms": k7["render high+colour"]["plain_ms"],
             "pair_bound_ms": k7["render high+colour"]["bound_ms"], "path_launches": k7["paths"]},
        ]}
        print(json.dumps(line))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
