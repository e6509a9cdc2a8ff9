"""Variants of K5's kernel (``csrc/tsdf_integrate.cu``), timed in turns on the card.

    python experiments/k5_tsdf/bench.py NAME [NAME ...] [--json OUT]
    python experiments/k5_tsdf/bench.py --clock

Each variant is a whole copy of the kernel's source: ``base.cu`` (one voxel
a lane, the frame read as it is) or a chain of line edits on it stored in
``variants.json`` ({name: {"parent": name, "ops": [[first, last, text]]}},
line ranges of the parent replaced by the text), written out to
``build/<name>.cu`` and built with the package's ``build_all``:

  v2    four voxels a lane (items of 128), their loads issued together
  v3    v2 with at most 85 registers (3 blocks of 256 a SM)
  v4    v2 with eight voxels a lane (items of 256)
  v5    v2 with the volume loaded beside the pixels, before the depth test
  v6    v5 with at most 85 registers
  v7    v2 reading one float4 pixel (depth, r, g, b), packed by the first launch
  v8    v7 with at most 85 registers
  v9    v8 skipping the slots past a run's end
  v10   v8 with each warp's 96 colour floats read and written coalesced
        through shared memory
  v13   v10 with each warp given a contiguous range of the list
  v15   v8 with the volume read and written through __ldcs / __stcs
  v16   v15 with the pixels read with an L2 evict-last policy
  v17   v2 with at most 85 registers and __ldcs / __stcs
  v20   v8 with the pixels read with an L2 evict-last policy
  main  v20 with a faster packing and classify (512 packing blocks,
        classify sized by its own occupancy)
  main2 main with the four pixel loads issued before any is used (the
        package's source when it was measured)
  dA    diagnostic: v8 without the pixel gathers (a depth of 2 m)
  dB    diagnostic: v8 without the volume's loads and stores
  d18   diagnostic: v8 with the list built by one block, in column order
  d19   diagnostic: v8 with clock64 counters per warp (``--clock``)

The diagnostics are not bit-exact. At room0's 196.2 M voxels with a
680x1200 frame and ScanNet's 345.0 M with a 480x640 frame (``chip_smoke.py``
phase 2's frames: depth uniform in [0.5, 4] m, the camera at (2, 1, 0)
looking along +z), and at room0 with every pixel at 3 m (a wall), each
variant is held ``torch.equal`` to the plain version, timed by CUDA events
(``time_ms``, in turns: the names, then again in reverse) and once under the
profiler (device ms and launches a call, by kernel). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from attentive_dfprior_tpu_torch.ops.cuda import tsdf_kernel as K5  # noqa: E402
from attentive_dfprior_tpu_torch.ops.cuda.build import CudaKernel, build_all  # noqa: E402
from attentive_dfprior_tpu_torch.tools import bench  # noqa: E402
from attentive_dfprior_tpu_torch.tools.profile_scatter import pieces, time_ms  # noqa: E402


def source(name: str) -> str:
    """The variant's whole source: ``base.cu`` with its chain of edits."""
    if name == "base":
        with open(os.path.join(HERE, "base.cu")) as f:
            return f.read()
    with open(os.path.join(HERE, "variants.json")) as f:
        rec = json.load(f)[name]
    lines = source(rec["parent"]).splitlines(keepends=True)
    for first, last, text in reversed(rec["ops"]):
        lines[first:last] = text.splitlines(keepends=True)
    return "".join(lines)


def kernels(names):
    out = {}
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    for n in names:
        path = os.path.join(HERE, "build", f"{n}.cu")
        with open(path, "w") as f:
            f.write(source(n))
        out[n] = CudaKernel(f"tsdf_{n}", path, K5._bind)
    t0 = time.perf_counter()
    build_all(out.values())
    print(f"build {time.perf_counter() - t0:.1f} s")
    for n, k in out.items():
        for line in k.build_log.splitlines():
            if "registers" in line:
                print(n, line.strip()[:200])
    return out


def cases(dev):
    """(label, dims, frame tensors + origin, updated voxels of a fresh
    volume, the plain version's volume)."""
    for name in ("replica", "scannet", "replica_wall"):
        w = bench.WORKLOADS[name.split("_")[0]]
        bnds = np.asarray(w["bound"], np.float64)
        dims = bench.prior_dims(bnds)
        c2w = np.eye(4)
        c2w[:3, 3] = [2.0, 1.0, 0.0]
        frame = CS.k5_frame(np.random.default_rng(6), w["cam"], c2w)
        if name.endswith("wall"):
            frame[0][:] = np.float32(3.0)
        t = [torch.as_tensor(a, device=dev) for a in frame[:4]]
        t.append(torch.as_tensor(bnds[:, 0].astype(np.float32), device=dev))
        yield name, dims, t


def fresh(dims, dev):
    return [torch.full(dims, -1.0, device=dev), torch.zeros(dims, device=dev), torch.zeros(dims + (3,), device=dev)]


def compare(names, dev):
    kerns = kernels(names)
    out = {}
    for label, dims, t in cases(dev):
        args = (*t, bench.VOXEL, 5.0 * bench.VOXEL, 1.0)
        ref = fresh(dims, dev)
        K5.integrate_frame_plain(*ref, *args)
        runs = K5.kept_runs(t[0], t[2], t[3], t[4], dims, bench.VOXEL, 5.0 * bench.VOXEL)
        length = (runs[..., 1] - runs[..., 0] + 1).clamp(min=0)
        stats = dict(updated=int((ref[1] > 0).sum()), columns=int((length > 0).sum()), kept=int(length.sum()),
                     items=int(((length + K5.CHUNK - 1) // K5.CHUNK).sum()))
        res = {n: [] for n in names}
        for n in names + names[::-1]:
            K5.KERNEL = kerns[n]
            K5._SCRATCH.clear()
            a = fresh(dims, dev)
            K5.integrate(*a, *args)
            torch.cuda.synchronize()
            equal = all(torch.equal(x, y) for x, y in zip(a, ref))
            res[n].append(dict(ms=time_ms(lambda: K5.integrate(*a, *args)), equal=equal))
            del a
        for n in names:
            K5.KERNEL = kerns[n]
            K5._SCRATCH.clear()
            a = fresh(dims, dev)
            res[n].append(pieces(lambda: K5.integrate(*a, *args)))
            del a
        print(f"{label}: dims {dims} {json.dumps(stats)}")
        for n in names:
            print(f"  {n}: {json.dumps(res[n])}")
        out[label] = dict(stats=stats, variants=res)
        del ref
        torch.cuda.empty_cache()
    return out


def clock(dev):
    """d19's counters: cycles a item in the pixel stage, the volume's loads
    and the update, items a warp, the longest warp."""
    K5.KERNEL = kernels(["d19"])["d19"]
    base = 2 + 128 + 2 + 4 * 1200 * 680  # d19's counters: the 16 words before its items
    out = {}
    for label, dims, t in cases(dev):
        a = fresh(dims, dev)
        K5._SCRATCH.clear()
        for rep in range(3):
            K5.integrate(*a, *t, bench.VOXEL, 5.0 * bench.VOXEL, 1.0)
            torch.cuda.synchronize()
            buf = next(iter(K5._SCRATCH.values()))
            ta, tb, tc, nit, span, warps = buf[base:base + 16].clone().view(torch.int64).cpu().tolist()[:6]
            buf[base:base + 16] = 0
            out.setdefault(label, []).append(dict(warps=warps, items=nit, pixel_cycles=ta / nit,
                                                  volume_cycles=tb / nit, update_cycles=tc / nit, longest=span))
            print(f"{label} rep {rep}: {json.dumps(out[label][-1])}")
        del a
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="*")
    ap.add_argument("--clock", action="store_true", help="run d19's per-warp cycle counters")
    ap.add_argument("--json", default=None, help="also write the records here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("experiments/k5_tsdf/bench.py: needs a CUDA card")
    dev = torch.device("cuda", 0)
    rec = clock(dev) if args.clock else compare(args.names, dev)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
