"""Where the milliseconds of one mapping iteration go, on the card: the port
of ``scripts/profile_mapping.py``.

    python -m attentive_dfprior_tpu_torch.tools.profile_mapping [--json OUT]
        [--reps 3] [--only SUBSTR] [--device cuda|cpu] [--iters 10]

The pieces of room0's colour stage, each timed alone, at its shapes
(``tools/bench.py``'s replica workload: room0's grids, a random 4/256 m
prior of 196 M voxels, five 680x1200 frames; 1000 rays x 48 samples =
48,000 points):

  - ``full_iter_color``: the production iteration (``mapping_stage``:
    draw, render, loss, backward, frustum-free masks, lazy Adam) under the
    ``halo`` gradient, on the card replayed as a CUDA graph
    (``utils/step_graph.py``), and on the card ``full_iter_color_eager``,
    the same iteration run eagerly, the two timed in turns;
    ``fwd_loss_color`` (the loss, no autograd graph);
    ``fwd_bwd_color`` (loss and every leaf's gradient, no Adam);
    ``adam_update`` alone;
  - per grid: ``gather_fwd_<grid>`` (the trilinear gather), and the grid
    gradient of each variant, forward included: ``scatter_bwd_<grid>``
    (``halo``: cell scatter + K1), ``scatter_bwd_cs_<grid>``
    (``cellstencil``), ``scatter_bwd_xla_<grid>`` (autodiff of the
    gathers) and ``scatter_bwd_pallas_<grid>`` (cell scatter + K3);
  - ``scatter_bwd_pair_highcolor``: the fused high + colour gradient (one
    64-wide scatter and K1);
  - the cell-stencil gradient's parts on the high grid:
    ``cellgrad_total_high``, ``cellgrad_scatter_high``,
    ``cellgrad_stencil_high`` (transpose + 8 slab adds) and
    ``cellgrad_bitfold_high`` (the plain fold);
  - the cell scatter's sum alone on the high grid's (nvox, 8C) buffer:
    ``cell_scatter_atomic`` (``index_add_``, on the card atomic adds in
    the order the threads arrive) and ``cell_scatter_ordered`` (K4,
    ``ops/cuda/cell_scatter_kernel.py``, what the grid gradients run);
  - ``tsdf_sample`` (the prior at 48,000 points) and ``mlp_low_fwd`` (the
    low decoder's plain MLP at 48,000 points).

The JAX profile slopes two ``lax.scan`` lengths to cancel a relay's
round trip; here the question is host against device. Each row reports
``ms_per_iter``, the median over ``--reps`` of ``--iters`` iterations with a
synchronize at each end, and the K1 / K3 / K2 launches per iteration (a
graph replay counts the launches its capture holds); on the card, one
``torch.profiler`` pass over the same iterations gives the device kernels
and device milliseconds per iteration and the launches the host made
(kernel launches, graph launches, copies and fills: the CUDA runtime calls
in the trace). The profiler passes run after every timed row: the
profiler slows what runs after it.

Left out: the JAX rows ``tsdf_sample_rows``, ``full_iter_color_rows``,
``fwd_loss_color_rows`` and ``fwd_bwd_color_rows``. They compare the TPU's
wide-Z-row layout of the prior (``attentive_dfprior_tpu/ops/grid_sample.py``
``tsdf_to_rows``) with the plain volume; the port samples the plain
``(X, Y, Z)`` volume in the rows sampler's arithmetic order
(``ops/grid_sample.py:trilinear_sample_tsdf``) and has no second layout.
The JAX ``full_iter_color`` runs the ``bitfold`` gradient; this one runs
the production ``halo``. Added: the ``scatter_bwd_pallas_*`` rows, K3's
path, and the two ``cell_scatter_*`` rows. ``profile(workload=, rays=)``
takes another of ``tools/bench.py``'s workloads and ray count. Runs on the
card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from attentive_dfprior_tpu_torch.utils.device import resolve_device

GRIDS = ("grid_low", "grid_high", "grid_color")
# grid-gradient variant of each scatter_bwd row family: (row prefix, sampler name)
SCATTER_ROWS = (("scatter_bwd_", "halo"), ("scatter_bwd_cs_", "cellstencil"), ("scatter_bwd_xla_", "xla"),
                ("scatter_bwd_pallas_", "pallas"))
RAYS = 1000  # the colour stage's rays a mapping iteration


def make_rows(device: torch.device, workload: str = "replica", rays: int = RAYS) -> Dict[str, Callable[[int], Any]]:
    """{row name: run}, in the JAX profile's order; ``run(n)`` does the
    row's work ``n`` times and returns the last output."""
    from attentive_dfprior_tpu_torch.models.decoders import mlp_decoder_forward, sample_tsdf
    from attentive_dfprior_tpu_torch.ops import grid_sample as gs
    from attentive_dfprior_tpu_torch.ops.adam import adam_init, adam_update
    from attentive_dfprior_tpu_torch.ops.cuda.cell_scatter_kernel import cell_scatter_sum
    from attentive_dfprior_tpu_torch.ops.cuda.halo_fold_kernel import cell_fold_plain
    from attentive_dfprior_tpu_torch.slam.mapper import StageLRs, build_lr_tree, mapping_loss_fn, mapping_stage
    from attentive_dfprior_tpu_torch.tools import bench
    from attentive_dfprior_tpu_torch.utils.step_graph import StepGraphs
    from attentive_dfprior_tpu_torch.utils.tree import tree_leaves, tree_map

    wl = bench.build_workload(workload, device)
    params, _ = bench.make_cycle(wl, "halo")
    leaves = tree_leaves(params)
    rcfg, bound, tsdf = wl.rcfg, wl.bound, wl.tsdf
    F = wl.colors.shape[0]
    lrs = StageLRs(5e-3, 5e-3, 5e-3, 5e-3, 5e-3)
    g = torch.Generator(device=device).manual_seed(3)
    S = rcfg.N_samples + rcfg.N_surface
    N = rays * S
    ro = torch.rand((rays, 3), generator=g, device=device) * 2.0 - 1.0
    rd = torch.rand((rays, 3), generator=g, device=device) * 2.0 - 1.0
    rd = rd / rd.norm(dim=1, keepdim=True)
    gd = torch.rand((rays,), generator=g, device=device) * 3.5 + 0.5
    gc = torch.rand((rays, 3), generator=g, device=device)
    inside = torch.ones((rays,), dtype=torch.bool, device=device)
    pts = (ro[:, None, :] + rd[:, None, :] * torch.linspace(0.5, 4.0, S, device=device)[None, :, None]).reshape(-1, 3)
    pn = gs.normalize_3d_coordinate(pts, bound)
    c_feat = torch.rand((N, 32), generator=g, device=device) * 2.0 - 1.0
    draws = torch.Generator(device=device).manual_seed(1)

    def repeat(step: Callable[[], Any]) -> Callable[[int], Any]:
        def run(n: int):
            out = None
            for _ in range(n):
                out = step()
            return out

        return run

    def full_iter_in(mode: Optional[str]):
        graphs = StepGraphs(mode, device)

        def run(n: int):
            return mapping_stage(params, graphs.adam("scene", params), wl.colors, wl.depths, wl.c2ws, None, tsdf,
                                 bound, bound, n, [0.0] * n, lrs, "color", rays // F, wl.cam, rcfg, (False, False),
                                 0.2, generator=draws, grid_vjp="halo", graphs=graphs)

        return run

    def loss():
        return mapping_loss_fn(params, ro, rd, gd, gc, inside, tsdf, bound, bound, "color", rcfg, 0.2, 0.0)

    def fwd_loss():
        with torch.no_grad():
            return loss()

    def fwd_bwd():
        value = loss()
        torch.autograd.grad(value, leaves, allow_unused=True)
        return value.detach()

    adam_params = tree_map(lambda t: t.detach().clone(), params)
    adam_state = adam_init(adam_params)
    lr_tree = build_lr_tree(adam_params, lrs, False, False)

    def adam():
        adam_update(adam_params, tree_map(lambda x: x * 1e-8, adam_params), adam_state, lr_tree)
        return adam_params["grid_high"]

    rows: Dict[str, Callable[[int], Any]] = {
        "full_iter_color": full_iter_in(None),
        "fwd_loss_color": repeat(fwd_loss),
        "fwd_bwd_color": repeat(fwd_bwd),
        "adam_update": repeat(adam),
    }
    if device.type == "cuda":
        rows["full_iter_color_eager"] = full_iter_in("eager")

    def gather(grid):
        def step():
            with torch.no_grad():
                return gs.trilinear_sample(grid, pn)

        return step

    def grid_grad(sampler, grid, ct):
        def step():
            with torch.enable_grad():
                leaf = grid.detach().requires_grad_(True)  # a new leaf on the same storage
                (gg,) = torch.autograd.grad(sampler(leaf, pn), leaf, ct)
            return gg

        return step

    for gk in GRIDS:
        grid = params[gk].detach()
        ct = torch.ones((N, grid.shape[-1]), device=device)
        rows[f"gather_fwd_{gk}"] = repeat(gather(grid))
        for prefix, impl in SCATTER_ROWS:
            rows[f"{prefix}{gk}"] = repeat(grid_grad(gs.grid_sampler(impl), grid, ct))

    gh, gcol = params["grid_high"].detach(), params["grid_color"].detach()
    if gh.shape == gcol.shape:
        ct = torch.ones((N, gh.shape[-1]), device=device)

        def pair():
            with torch.enable_grad():
                a, b = gh.detach().requires_grad_(True), gcol.detach().requires_grad_(True)
                ga, gb = torch.autograd.grad(gs.trilinear_sample_pair(a, b, pn, "halo"), (a, b), (ct, ct))
            return ga + gb

        rows["scatter_bwd_pair_highcolor"] = repeat(pair)

    gshape = tuple(gh.shape)
    nvox = gshape[0] * gshape[1] * gshape[2]
    ctg = torch.ones((N, gshape[3]), device=device)
    cells = torch.zeros((nvox, 8 * gshape[3]), device=device)
    rows["cellgrad_total_high"] = repeat(lambda: gs._cell_stencil_grid_grad(gshape, pn, ctg))
    rows["cellgrad_scatter_high"] = repeat(lambda: gs._cell_scatter(gshape, pn, ctg))
    rows["cellgrad_stencil_high"] = repeat(lambda: gs._corner_slab_sum(gshape, cells))
    rows["cellgrad_bitfold_high"] = repeat(lambda: cell_fold_plain(gshape, cells))
    # the cell scatter's sum alone, on the high grid's cell buffer: the atomic
    # ``index_add_`` (on the card) against K4, the ordered sum every grid gradient runs
    cell, upd = gs._cell_updates(gshape, pn, ctg)
    rows["cell_scatter_atomic"] = repeat(
        lambda: torch.zeros((nvox, upd.shape[1]), device=device).index_add_(0, cell, upd))
    rows["cell_scatter_ordered"] = repeat(lambda: cell_scatter_sum(nvox, cell, upd))

    def tsdf_sample():
        with torch.no_grad():
            return sample_tsdf(tsdf, pts, bound)

    def mlp_low():
        with torch.no_grad():
            return mlp_decoder_forward(params["low"], pts, c_feat)

    rows["tsdf_sample"] = repeat(tsdf_sample)
    rows["mlp_low_fwd"] = repeat(mlp_low)
    return rows


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _finite(out: Any) -> bool:
    return bool(torch.isfinite(out).all())


def time_row(run: Callable[[int], Any], n: int, reps: int, device: torch.device) -> Dict[str, Any]:
    """``WARMUP_ITERS + 1`` warm-up iterations (a graphed row's eager
    warm-up and its capture, ``utils/step_graph.py``, so that every timed
    iteration of it is a replay), then ``reps`` timings of ``n`` iterations
    with a synchronize at each end; the kernels' launches over the first."""
    return time_rows_in_turns([run], n, reps, device)[0]


def time_rows_in_turns(runs: List[Callable[[int], Any]], n: int, reps: int,
                       device: torch.device) -> List[Dict[str, Any]]:
    """``time_row`` for several rows, their timings in turns (a, b, b, a,
    ...), so that they meet the same drift of the host."""
    from attentive_dfprior_tpu_torch.ops.cuda.build import step_kernels
    from attentive_dfprior_tpu_torch.utils.step_graph import WARMUP_ITERS

    kernels = step_kernels()
    finite, times, launches = [], [[] for _ in runs], [None] * len(runs)
    for run in runs:
        out = run(WARMUP_ITERS + 1)
        _sync(device)
        finite.append(_finite(out))
    turn = list(range(len(runs))) + list(range(len(runs)))[::-1]
    for i in (turn * reps)[: reps * len(runs)]:
        before = {k.name: k.launches for k in kernels}
        t0 = time.perf_counter()
        out = runs[i](n)
        _sync(device)
        times[i].append((time.perf_counter() - t0) / n)
        finite[i] = finite[i] and _finite(out)
        if launches[i] is None:
            launches[i] = {k.name: (k.launches - before[k.name]) / n for k in kernels}
    return [{"ms_per_iter": 1e3 * float(np.median(t)), "rep_ms": [1e3 * x for x in t], "finite": f,
             "launches_per_iter": ln} for t, f, ln in zip(times, finite, launches)]


# the CUDA API calls by which the host launches device work
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                     "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")


def trace_device(fn: Callable[[], Any], device: torch.device) -> Dict[str, float]:
    """``fn()`` once under ``torch.profiler``, the device traced alone, its
    events summed straight from the trace: device seconds and device
    kernels (copies and fills included), and the host's launch calls
    (``HOST_LAUNCH_CALLS``; 0 when the trace holds no runtime calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _sync(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        _sync(device)
    busy_ns = kernels = launches = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            busy_ns += e.duration_ns()
            kernels += 1
        elif e.name() in HOST_LAUNCH_CALLS:
            launches += 1
    return {"device_s": busy_ns / 1e9, "device_kernels": kernels, "host_launches": launches}


def profile_row(run: Callable[[int], Any], n: int, device: torch.device) -> Dict[str, Any]:
    """One ``torch.profiler`` pass over ``n`` iterations (``trace_device``):
    device milliseconds, device kernels and host launches per iteration
    (None on the CPU, or where the profiler records none)."""
    none = {"device_ms_per_iter": None, "device_kernels_per_iter": None, "host_launches_per_iter": None}
    if device.type != "cuda":
        return none
    t = trace_device(lambda: run(n), device)
    if t["device_s"] <= 0:
        return none
    return {"device_ms_per_iter": 1e3 * t["device_s"] / n, "device_kernels_per_iter": t["device_kernels"] / n,
            "host_launches_per_iter": t["host_launches"] / n if t["host_launches"] else None}


def profile(device=None, iters: int = 10, reps: int = 3, only: Optional[str] = None,
            workload: str = "replica", rays: int = RAYS) -> Dict[str, Dict[str, Any]]:
    """Every row (or those whose name contains ``only``): timed rows first,
    then the profiler passes. Returns {row: record}."""
    dev = resolve_device(device)
    rows = {k: v for k, v in make_rows(dev, workload, rays).items() if not only or only in k}
    results = {}
    for name, run in rows.items():
        if name in results:
            continue
        pair = [name] + ([f"{name}_eager"] if f"{name}_eager" in rows else [])
        for key, rec in zip(pair, time_rows_in_turns([rows[k] for k in pair], iters, reps, dev)):
            results[key] = rec
        r = results[name]
        print(f"[{name}] {r['ms_per_iter']:10.3f} ms/iter  (reps {', '.join(f'{t:.3f}' for t in r['rep_ms'])}; "
              f"launches/iter {json.dumps(r['launches_per_iter'])})", flush=True)
    for name, run in rows.items():
        results[name].update(profile_row(run, iters, dev))
    return results


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", default=None, help="also write the rows here")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--iters", type=int, default=10, help="iterations per timing")
    ap.add_argument("--only", default=None, help="only rows whose name contains this (e.g. full_iter)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    results = profile(args.device, args.iters, args.reps, args.only)
    print()
    print(f"{'piece':<30} {'ms/iter':>10} {'device ms/iter':>15} {'kernels/iter':>13} {'host launches/iter':>19}")
    for k, r in results.items():
        dms, nk, hl = r["device_ms_per_iter"], r["device_kernels_per_iter"], r["host_launches_per_iter"]
        print(f"{k:<30} {r['ms_per_iter']:>10.3f} {'not measured' if dms is None else f'{dms:.3f}':>15} "
              f"{'not measured' if nk is None else f'{nk:.1f}':>13} "
              f"{'not measured' if hl is None else f'{hl:.1f}':>19}")
    total = sum(r["ms_per_iter"] for k, r in results.items() if k.startswith("scatter_bwd_grid"))
    print(f"{'sum(scatter_bwd_grid_*)':<30} {total:>10.3f}")
    payload = {"rows": results, "iters": args.iters, "reps": args.reps, "device": args.device,
               "when": time.strftime("%Y-%m-%d %H:%M:%S")}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=1)
    return payload


if __name__ == "__main__":
    main()
