"""K4 (the ordered cell scatter) and the fold's library call, timed on the card.

    python -m attentive_dfprior_tpu_torch.tools.profile_scatter [--json OUT]

K4 (``ops/cuda/cell_scatter_kernel.py:cell_scatter_sum``) at the main
path's shapes: points along rays from a few cameras, as the renderer places
them (every ray's first samples share the camera's cells), into room0's
high grid at the colour stage (5 frames x 200 rays x 48 samples = 48,000
rows; 8C = 256 and the high + colour pair's 16C = 512) and ScanNet's
(10 x 500 x 48 = 240,000 rows, 8C). Each shape is timed two ways, beside
the library call that computes the same sum (zeros + ``index_add_``, with
atomic adds, whose order changes from run to run; the port never calls
it):

  - eagerly: ``inner`` calls queued between one CUDA-event pair, the
    median over ``reps`` pairs (``time_ms``);
  - as a graph replay: ``GRAPH_CALLS`` calls captured into one CUDA graph
    (the main path replays each mapping iteration so), the replay timed
    the same way, per call (``time_graph_ms``);

and once under ``torch.profiler`` (``pieces``): the device kernels of one
call by name, with their count and device milliseconds a call.

The fold's library call (``fold_library``): ``F.conv_transpose3d`` with a
one-hot 2 x 2 x 2 weight computes K1's and K3's function, each grid node
the sum of the 8 cell corners that touch it; timed at room0's high grid,
C = 32 and 64, and held to K1 at rtol 1e-4 / atol 1e-5 (cuDNN picks its
own algorithm and sums in its own order).

Needs a CUDA card; nothing here runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

# (label, grid shape (nx, ny, nz, C), cameras, rays a camera): the main path's shapes, 48 samples a ray
RAY_CASES = (("room0 colour stage, 8C", (74, 56, 44, 32), 5, 200),
             ("room0 colour stage, pair 16C", (74, 56, 44, 64), 5, 200),
             ("ScanNet, 8C", (81, 84, 46, 32), 10, 500))
GRAPH_CALLS = 10  # calls captured into one graph
FOLD_SHAPES = ((74, 56, 44, 32), (74, 56, 44, 64))  # room0's high grid; its high + colour pair


def ray_points(cams: int, rays: int, g: torch.Generator, dev: torch.device) -> torch.Tensor:
    """(cams * rays * 48, 3) normalized points: 32 samples from near the
    camera to past the grid, 16 around a surface depth, a ray."""
    org = torch.rand((cams, 1, 1, 3), generator=g, device=dev) * 1.2 - 0.6
    d = torch.randn((cams, rays, 1, 3), generator=g, device=dev)
    d = d / d.norm(dim=-1, keepdim=True)
    surf = torch.rand((cams, rays, 1), generator=g, device=dev) * 0.9 + 0.3
    t = torch.cat([torch.linspace(0.02, 1.5, 32, device=dev).expand(cams, rays, 32),
                   surf + torch.linspace(-0.05, 0.05, 16, device=dev)], dim=-1)
    return (org + d * t[..., None]).reshape(-1, 3)


def ray_cases(g: torch.Generator, dev: torch.device) -> List[Tuple[str, Tuple[int, int, int, int], torch.Tensor]]:
    """[(label, grid shape, floor cells of the ray-shaped points)] for
    ``RAY_CASES``, the cells as ``ops/grid_sample.py:_cell_updates`` gives
    them."""
    from attentive_dfprior_tpu_torch.ops import grid_sample as gs

    out = []
    for label, shape, cams, rays in RAY_CASES:
        p = ray_points(cams, rays, g, dev)
        cell, _ = gs._cell_updates(shape[:3] + (1,), p, torch.zeros((len(p), 1), device=dev))
        out.append((label, shape, cell))
    return out


def time_ms(fn: Callable[[], Any], reps: int = 20, inner: int = 10, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: the median over ``reps`` of one
    CUDA-event pair around ``inner`` back-to-back calls, over ``inner``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def time_graph_ms(fn: Callable[[], Any], calls: int = GRAPH_CALLS, reps: int = 20) -> float:
    """Device time of one call of ``fn`` replayed from a CUDA graph that
    holds ``calls`` calls: the median over ``reps`` replays, over ``calls``.
    ``fn`` is warmed up on a side stream first, as a capture needs."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return time_ms(graph.replay, reps=reps, inner=1) / calls


def pieces(fn: Callable[[], Any], calls: int = GRAPH_CALLS) -> Dict[str, Any]:
    """``calls`` calls of ``fn`` under ``torch.profiler``, the device traced
    alone: {kernel name: [launches a call, device ms a call]}, the device
    kernels a call and their device ms a call (fills and copies count as
    kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name: Dict[str, List[float]] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            rec = by_name.setdefault(e.name(), [0, 0.0])
            rec[0] += 1
            rec[1] += e.duration_ns() / 1e6
    named = {k: [v[0] / calls, v[1] / calls] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1][1])}
    return {"pieces": named, "kernels_per_call": sum(v[0] for v in named.values()),
            "device_ms_per_call": sum(v[1] for v in named.values())}


def scatter_bound_ms(n: int, width: int, nrows: int, peak_bytes: float) -> float:
    """The least time for the sum: the rows and their int64 indices read
    once, the whole (nrows, width) output written once."""
    return (n * (width * 4 + 8) + nrows * width * 4) / peak_bytes * 1e3


def measure_scatter(nrows: int, idx: torch.Tensor, rows: torch.Tensor) -> Dict[str, Any]:
    """K4 and the library call on the same inputs: eager and graphed ms,
    K4's device pieces a call."""
    from attentive_dfprior_tpu_torch.ops.cuda.cell_scatter_kernel import cell_scatter_sum

    def k4():
        return cell_scatter_sum(nrows, idx, rows)

    def library():
        return torch.zeros((nrows, rows.shape[1]), device=rows.device).index_add_(0, idx, rows)

    rec = {"ms": time_ms(k4), "library_ms": time_ms(library), "graph_ms": time_graph_ms(k4),
           "library_graph_ms": time_graph_ms(library)}
    rec.update(pieces(k4))
    return rec


def fold_weight(C: int, dev: torch.device) -> torch.Tensor:
    """(8C, C, 2, 2, 2) one-hot weight: w[k C + c, c, dx, dy, dz] = 1 for the
    corner k = 4 dx + 2 dy + dz."""
    w = torch.zeros((8 * C, C, 2, 2, 2), device=dev)
    for k in range(8):
        dx, dy, dz = k >> 2, (k >> 1) & 1, k & 1
        w[k * C + torch.arange(C, device=dev), torch.arange(C, device=dev), dx, dy, dz] = 1.0
    return w


def fold_library(cells: torch.Tensor, shape: Tuple[int, int, int, int], weight: torch.Tensor) -> torch.Tensor:
    """The fold as one ``F.conv_transpose3d``: the (nvox, 8C) buffer viewed
    as (1, 8C, nx, ny, nz) (channels last), stride 1, giving (nx + 1, ny +
    1, nz + 1) nodes; the caller crops to (nx, ny, nz)."""
    nx, ny, nz, C = shape
    x = cells.view(1, nx, ny, nz, 8 * C).permute(0, 4, 1, 2, 3)
    return torch.nn.functional.conv_transpose3d(x, weight)


def fold_view(out: torch.Tensor, shape: Tuple[int, int, int, int]) -> torch.Tensor:
    """``fold_library``'s output cropped and laid out as K1's (nx, ny, nz, C)."""
    nx, ny, nz, _ = shape
    return out[0, :, :nx, :ny, :nz].permute(1, 2, 3, 0)


def measure_fold(cells: torch.Tensor, shape: Tuple[int, int, int, int], ref: torch.Tensor) -> Dict[str, Any]:
    """The library fold against ``ref`` (K1's output on ``cells``): its
    ms and its largest difference; raises beyond rtol 1e-4 / atol 1e-5."""
    weight = fold_weight(shape[3], cells.device)
    got = fold_view(fold_library(cells, shape, weight), shape)
    err = float((got - ref).abs().max())
    if not torch.allclose(got, ref, rtol=1e-4, atol=1e-5):
        raise AssertionError(f"conv_transpose3d's fold differs from K1 at {shape}: max abs err {err}")
    return {"library_ms": time_ms(lambda: fold_library(cells, shape, weight)), "max_abs_err_vs_K1": err}


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", default=None, help="also write the records here")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_scatter: needs a CUDA card")
    from attentive_dfprior_tpu_torch.ops.cuda.halo_fold_kernel import cell_fold_halo

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    out: Dict[str, Any] = {"device": torch.cuda.get_device_name(0), "scatter": {}, "fold": {}}
    for label, shape, idx in ray_cases(g, dev):
        nrows, width = shape[0] * shape[1] * shape[2], 8 * shape[3]
        rows = torch.randn((len(idx), width), generator=g, device=dev)
        rec = measure_scatter(nrows, idx, rows)
        rec["bound_ms"] = scatter_bound_ms(len(idx), width, nrows, 3.35e12)
        out["scatter"][label] = rec
        print(f"K4 {label}: {len(idx)} rows x {width} into {nrows}: eager {rec['ms']:.4f} ms, graphed "
              f"{rec['graph_ms']:.4f} ms; library (zeros + index_add_) eager {rec['library_ms']:.4f}, graphed "
              f"{rec['library_graph_ms']:.4f}; bound {rec['bound_ms']:.4f}; {rec['kernels_per_call']:.1f} device "
              f"kernels a call, {rec['device_ms_per_call']:.4f} device ms a call", flush=True)
        for name, (count, ms) in rec["pieces"].items():
            print(f"    {count:5.1f} x {ms:8.4f} ms  {name[:150]}")
    for shape in FOLD_SHAPES:
        nx, ny, nz, C = shape
        cells = torch.randn((nx * ny * nz, 8 * C), generator=g, device=dev)
        rec = measure_fold(cells, shape, cell_fold_halo(cells, shape))
        out["fold"][str(shape)] = rec
        print(f"fold {shape}: conv_transpose3d {rec['library_ms']:.4f} ms, max abs err vs K1 "
              f"{rec['max_abs_err_vs_K1']:.3e}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
