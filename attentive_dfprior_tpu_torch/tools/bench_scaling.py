"""Mapping rays/s against the number of ranks: the port of ``bench_scaling.py``.

    python -m attentive_dfprior_tpu_torch.tools.bench_scaling [--devices 1,2,4,8]
        [--pixels 1000,5000] [--mode strong|weak] [--accum 1,5] [--iters 6]
        [--reps 3] [--device cuda|cpu] [--step-modes graph,eager]
        [--step-s-1dev S] [--out SCALING.json]

Measures the production data-parallel mapping stage (``slam/mapper.py``
``mapping_stage`` in the colour stage, the ray batch split over the ranks
by ``parallel/sharding.py:RayShards``, one all-reduce of loss and
gradients a step, ``accum``) in one process per rank on
``torch.distributed``: NCCL with one card a rank (``--device cuda``, rank
i on ``cuda:i``), gloo on the CPU (``--device cpu``). Asking for more CUDA
ranks than there are cards raises: ranks that time-slice one card measure
nothing about scaling. The scene is ``tools/bench.py``'s replica workload
(room0's bound and 680x1200 camera, grids 0.32 / 0.16 / 0.16 m, C = 32,
five random frames) with the JAX harness's coarse 0.0625 m prior, the same
for every rank count.

Each rank's stage runs in its agent's step mode (``utils/step_graph.py``),
resolved from the rank's group: on the card one CUDA graph an iteration,
the all-reduce inside on NCCL (one rank has no group and no collective),
eager on gloo; ``--step-modes graph,eager`` times the modes named in
turns, rep by rep, the first the headline. The record names the mode that
ran, read from the agent's ``StepGraphs``.

Modes, as in the JAX harness: ``strong`` (``--pixels`` is the whole batch,
each rank's share shrinks with n), ``weak`` (``--pixels`` is each rank's
share) and ``--accum k`` (k-fold rays per Adam step and all-reduce, 1/k
as many steps). Efficiency(n) = rays_per_s(n) / (n x rays_per_s(1)).

``comm_model`` is the JAX harness's analytic model: a ring all-reduce of
every gradient leaf a step, ``2 x grad_bytes x (n - 1) / n`` bytes on the
wire a device, not overlapped with compute; compute scales with rays a
device from the measured one-device step time (this run's one-rank
measurement at the first ``--pixels``, or ``--step-s-1dev``). Its
bandwidth is the card's from ``LINK_BW_BIDI`` (an H100's on the CPU):
NVLink 4, 900 GB/s bidirectional a GPU (NVIDIA's data sheet); a card the
table does not hold raises. Its rows for 1, 2, 4 and 8 ranks and every
``--devices`` count are a prediction, not a measurement.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from attentive_dfprior_tpu_torch.utils.device import card_name_and_power, resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TAG = "CHILD_RESULT "
PRIOR_VOXEL = 0.0625  # the JAX harness's coarse prior, the same for every rank count
# bidirectional link bandwidth a device (bytes/s); NVLink 4, NVIDIA H100 data sheet
LINK_BW_BIDI = {"H100": 9.0e11}
DEFAULT_KIND = "NVIDIA H100"
PREDICT_RANKS = (1, 2, 4, 8)  # the comm model's rank counts, with every --devices count


def child_measure(n_devices: int, pixels: int, n_iters: int, reps: int, device: str,
                  accum_k: int = 1, step_modes: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """One rank's measurement of the colour-stage ``mapping_stage``: joins
    the group the launcher's variables name (``run_ranks`` names one, a
    world of one for one rank), runs one warm-up stage of ``n_iters``
    iterations in each of ``step_modes`` (default: the mode the rank's
    group resolves to), then ``reps`` timed stages in each, the modes in
    turns, each from a zeroed Adam state at the agent's static addresses.
    ``pixels`` is the whole base ray batch an iteration; ``accum_k`` goes to
    ``mapping_stage(accum=)``. Returns the record, the first mode's the
    headline and every mode's under ``by_mode`` (rank 0's is the one the
    parent reads)."""
    from attentive_dfprior_tpu_torch.models.scene import init_scene
    from attentive_dfprior_tpu_torch.ops.cuda.build import port_kernels
    from attentive_dfprior_tpu_torch.parallel.sharding import init_distributed, mesh_from_config, replicate
    from attentive_dfprior_tpu_torch.slam.mapper import StageLRs, mapping_stage
    from attentive_dfprior_tpu_torch.tools.bench import build_workload
    from attentive_dfprior_tpu_torch.utils.step_graph import StepGraphs
    from attentive_dfprior_tpu_torch.utils.tree import tree_leaves

    import torch.distributed as dist

    group = bool(os.environ.get("WORLD_SIZE"))
    if group:
        init_distributed(device=device)
    dev = resolve_device(device)
    try:
        world = dist.get_world_size() if group else 1
        if world != n_devices:
            raise RuntimeError(f"asked for {n_devices} ranks, the group has {world}")
        shards = mesh_from_config({"parallel": {"enable": True}})
        wl = build_workload("replica", dev, voxel=PRIOR_VOXEL)
        params = init_scene(torch.Generator().manual_seed(0), wl.scene_cfg, device=dev)
        # bytes the gradient all-reduce moves a step: every leaf has a gradient, the grids dominate
        grad_bytes = int(sum(t.numel() * t.element_size() for t in tree_leaves(params)))
        replicate(tree_leaves(params), shards)
        for t in tree_leaves(params):
            t.requires_grad_(True)
        lrs = StageLRs(decoders=5e-3, mlp=5e-3, low=5e-3, high=5e-3, color=5e-3)
        F = wl.colors.shape[0]
        pixs_per_image = max(1, pixels // F)
        draws = torch.Generator(device=dev).manual_seed(2)  # the same draws on every rank
        agent_group = shards.group if shards is not None else None
        agents = {g.mode: g for g in (StepGraphs(m, dev, group=agent_group) for m in step_modes or [None])}
        modes = list(agents)

        def one_stage(graphs):
            return mapping_stage(params, graphs.adam("scene", params), wl.colors, wl.depths, wl.c2ws, None, wl.tsdf,
                                 wl.bound, wl.bound, n_iters, [0.0] * n_iters, lrs, "color", pixs_per_image, wl.cam,
                                 wl.rcfg, (False, False), 0.2, generator=draws, accum=accum_k, shards=shards,
                                 graphs=graphs)

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            if group:
                dist.barrier()

        def timed(graphs):
            sync()
            t0 = time.perf_counter()
            out = one_stage(graphs)
            sync()
            return out, time.perf_counter() - t0

        kernels = port_kernels()
        before = {k.name: k.launches for k in kernels}  # the warm-up's launches count too
        warmup_s, elapsed = {}, {m: 0.0 for m in modes}
        finite = True
        for m in modes:  # the warm-up stage: a graph's eager iterations and its capture
            losses, warmup_s[m] = timed(agents[m])
            finite &= bool(torch.isfinite(losses).all())
        for _ in range(reps):
            for m in modes:
                losses, dt = timed(agents[m])
                elapsed[m] += dt
                finite &= bool(torch.isfinite(losses).all())
        rays = pixs_per_image * F * accum_k * n_iters * reps
        by_mode = {m: {"step_mode": m, "rays_per_s": rays / elapsed[m],
                       "step_s": elapsed[m] / (n_iters * reps), "warmup_s": warmup_s[m], "elapsed_s": elapsed[m],
                       "graphs": agents[m].stats()} for m in modes}
        head = by_mode[modes[0]]
        return {
            "n_devices": n_devices,
            "rank": dist.get_rank() if group else 0,
            "pixels": pixs_per_image * F * accum_k,
            "rays_per_s": head["rays_per_s"],
            "step_s": head["step_s"],
            "warmup_s": head["warmup_s"],
            "elapsed_s": head["elapsed_s"],
            "grad_bytes_per_step": grad_bytes,
            "losses_finite": finite,
            "launches": {k.name: k.launches - before[k.name] for k in kernels},
            "backend": dist.get_backend() if group else "none",
            "device": str(dev),
            "step_mode": head["step_mode"],
            "by_mode": by_mode,
        }
    finally:
        if group:
            dist.destroy_process_group()


def link_bandwidth(device_kind: str) -> float:
    """The table's bandwidth for ``device_kind``; raises for a kind it
    does not hold."""
    for k, v in LINK_BW_BIDI.items():
        if k.lower() in device_kind.lower():
            return v
    raise ValueError(f"no link bandwidth for {device_kind!r} in LINK_BW_BIDI")


def comm_model(grad_bytes: int, step_s_1dev: float, rays_per_step: int, device_kind: str, n_list: Sequence[int],
               accum_list: Sequence[int]) -> Dict[str, Any]:
    """Analytic dp-efficiency prediction (``bench_scaling.py:comm_model``).

    A step ring-all-reduces every gradient leaf: 2 x grad_bytes x (n - 1)
    / n bytes on the wire a device. From the measured one-device step time
    T1, with compute linear in rays a device and the all-reduce not
    overlapped (the worst case):

      strong:  T_comp(n) = T1 / n ;  eff = T_comp / (T_comp + T_comm)
      weak:    T_comp(n) = T1     ;  same formula
      accum k: k forward/backward passes a reduction: T_comp x k

    The bandwidth (bytes/s, bidirectional a device) is the table's for
    ``device_kind``."""
    bw = link_bandwidth(device_kind)
    out = {
        "grad_bytes_per_step": grad_bytes,
        "assumed_link_bw_bidi_bytes_per_s": bw,
        "device_kind": device_kind,
        "measured_step_s_1dev": step_s_1dev,
        "rays_per_step": rays_per_step,
        "note": ("a prediction, not a measurement: the all-reduce modelled not overlapped (worst case); halve "
                 "T_comm for a fully overlapped bound. eff = T_comp/(T_comp+T_comm)."),
    }
    for regime in ("strong", "weak"):
        rows = []
        for n in n_list:
            t_comm = 2.0 * grad_bytes * (n - 1) / n / bw
            for k in accum_list:
                t_comp = step_s_1dev * k * (1.0 if regime == "weak" else 1.0 / n)
                eff = t_comp / (t_comp + t_comm) if n > 1 else 1.0
                rows.append({"n": n, "accum": k, "t_comp_ms": round(t_comp * 1e3, 3),
                             "t_allreduce_ms": round(t_comm * 1e3, 3), "efficiency": round(eff, 3)})
        out[regime] = rows
    return out


def run_ranks(n: int, px: int, iters: int, reps: int, device: str, accum_k: int,
              step_modes: Optional[Sequence[str]] = None, timeout: float = 1800.0) -> Dict[str, Any]:
    """``child_measure`` in ``n`` processes joined over a local port (a
    world of one for ``n`` = 1, so the backend runs there too); returns
    rank 0's record with every rank's launches. Every child is stopped
    before it returns."""
    from attentive_dfprior_tpu_torch.tools.dryrun_multichip import free_port

    port = free_port()
    cmd = [sys.executable, "-m", "attentive_dfprior_tpu_torch.tools.bench_scaling", "--child", "--n", str(n),
           "--px", str(px), "--iters", str(iters), "--accum-k", str(accum_k), "--reps", str(reps),
           "--device", device]
    if step_modes:
        cmd += ["--step-modes", ",".join(step_modes)]
    procs = []
    for rank in range(n):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
        env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
        if device == "cpu":
            env["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 1) // n))
        procs.append(subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    records = []
    for p, out in zip(procs, outs):
        lines = [ln for ln in out.splitlines() if ln.startswith(TAG)]
        if p.returncode != 0 or not lines:
            raise RuntimeError(f"bench_scaling: n={n} px={px} failed:\n" + "\n---\n".join(o[-3000:] for o in outs))
        records.append(json.loads(lines[-1][len(TAG):]))
    rec = records[0]
    rec["launches_by_rank"] = [r["launches"] for r in records]
    rec["step_mode_by_rank"] = [r["step_mode"] for r in records]
    rec["losses_finite"] = all(r["losses_finite"] for r in records)
    return rec


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", default="1,2,4,8")
    ap.add_argument("--pixels", default="1000,5000")
    ap.add_argument("--mode", default="strong", choices=["strong", "weak"],
                    help="strong: --pixels is the whole batch; weak: --pixels is rays a rank")
    ap.add_argument("--accum", default="1", help="comma list of accumulation factors k (mapping_stage(accum=k))")
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--step-modes", default=None,
                    help="comma list of step modes timed in turns, the first the headline (default: each rank's "
                         "own, graph on the card unless its group is on gloo)")
    ap.add_argument("--step-s-1dev", type=float, default=None,
                    help="the one-device step seconds for the comm model (default: this run's one-rank measurement)")
    ap.add_argument("--out", default=None, help="also write the JSON record here")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--n", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--px", type=int, default=1000, help=argparse.SUPPRESS)
    ap.add_argument("--accum-k", type=int, default=1, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    step_modes = args.step_modes.split(",") if args.step_modes else None
    if args.child:
        rec = child_measure(args.n, args.px, args.iters, args.reps, args.device, args.accum_k, step_modes)
        print(TAG + json.dumps(rec), flush=True)
        return rec

    device_list = [int(x) for x in args.devices.split(",")]
    pixel_list = [int(x) for x in args.pixels.split(",")]
    accum_list = [int(x) for x in args.accum.split(",")]
    dev = resolve_device(args.device)
    if dev.type == "cuda" and max(device_list) > torch.cuda.device_count():
        raise ValueError(f"--devices asks for {max(device_list)} ranks but there are {torch.cuda.device_count()} "
                         "cards: ranks that time-slice one card measure nothing about scaling")

    results = []
    for px in pixel_list:
        for n in device_list:
            for k in accum_list:
                global_px = px * (n if args.mode == "weak" else 1)
                iters = max(2, args.iters // k)
                print(f"[bench_scaling] mode={args.mode} n={n} px/dev={global_px // n} accum={k} ...", flush=True)
                rec = run_ranks(n, global_px, iters, args.reps, args.device, k, step_modes)
                rec.update(mode=args.mode, accum=k, base_pixels=px)
                print(f"    -> {rec['rays_per_s']:.0f} rays/s, {rec['step_mode']} steps (warm-up {rec['warmup_s']:.1f} s)",
                      flush=True)
                results.append(rec)

    workloads = {}
    for px in pixel_list:
        for k in accum_list:
            series = sorted([r for r in results if r["base_pixels"] == px and r["accum"] == k],
                            key=lambda r: r["n_devices"])
            base = series[0]
            tag = f"{px}px" + (f"_accum{k}" if k != 1 else "")
            workloads[tag] = {
                "mode": args.mode,
                "n_devices": [r["n_devices"] for r in series],
                "rays_per_s": [r["rays_per_s"] for r in series],
                "efficiency_vs_linear": [
                    r["rays_per_s"] / (base["rays_per_s"] * r["n_devices"] / base["n_devices"]) for r in series
                ],
            }

    step_s = args.step_s_1dev
    if step_s is None:
        one = [r for r in results if r["n_devices"] == 1 and r["base_pixels"] == pixel_list[0] and r["accum"] == 1]
        if not one:
            raise ValueError("the comm model needs a one-rank measurement at the first --pixels, or --step-s-1dev")
        step_s = one[0]["step_s"]
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else DEFAULT_KIND
    model = comm_model(results[0]["grad_bytes_per_step"], step_s, pixel_list[0], kind,
                       sorted(set(PREDICT_RANKS) | set(device_list)), accum_list if accum_list != [1] else [1, 5, 15])

    payload = {
        "harness": "attentive_dfprior_tpu_torch/tools/bench_scaling.py",
        "metric": f"mapping rays/s vs rank count (production mapping_stage, ray-axis dp, {args.mode} scaling)",
        "device": args.device,
        "card": card_name_and_power() if dev.type == "cuda" else "cpu",
        "backend": results[0]["backend"],
        "caveat": ("one process a card over NCCL" if dev.type == "cuda" else
                   "CPU ranks over gloo share the host's cores: this validates the plumbing and measures the "
                   "collectives' overhead, not hardware scaling"),
        "workloads": workloads,
        "comm_model": model,
        "raw": results,
        "when": time.strftime("%Y-%m-%d %H:%M:%S"),
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1)
    print(json.dumps({"scaling": {k: v["efficiency_vs_linear"] for k, v in workloads.items()}, "out": args.out}))
    return payload


if __name__ == "__main__":
    main()
