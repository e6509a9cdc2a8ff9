"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface. On
first use it is compiled with nvcc for Hopper (``sm_90a``) into a shared
library under ``attentive_dfprior_tpu_torch/build/`` (listed in
``.gitignore``) and loaded with ``ctypes``. The library name carries a hash
of the source, so an edited source is rebuilt and a stale library is never
loaded. ``build_all`` starts one nvcc per source, all at once.

Launch counts: a wrapper counts a launch where it launches its kernel
(``check_launch``). A launch made while the current stream captures a CUDA
graph does not run: it is counted in ``CudaKernel.captured`` under the
capturing stream, and ``utils/step_graph.py`` adds a graph's captured
launches to ``launches`` at every replay, so a count reads the same
whether an iteration ran eagerly or as a replay.

Nothing here runs at import time: the CPU tests import every module on a
machine without nvcc or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]


def nvcc_path() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def capturing_stream() -> Optional[int]:
    """The raw handle of the current CUDA stream while it captures a graph,
    else None (always None without CUDA)."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        return torch.cuda.current_stream().cuda_stream
    return None


class CudaKernel:
    """One hand-written kernel: its source, its loaded library and its
    launch count (``launches`` grows by one per launch, in the wrapper,
    under a lock: the async modes launch from two threads; ``captured``
    holds the launches recorded into graphs, by capturing stream)."""

    def __init__(self, name: str, source: str, bind: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = os.path.join(SRC_DIR, source)
        self._bind = bind
        self._lib: Optional[ctypes.CDLL] = None
        self.launches = 0
        self.captured: Dict[int, int] = {}
        self.count_lock = threading.Lock()
        self._lib_lock = threading.Lock()  # one build and load when two threads launch first
        self.build_log = ""
        self.build_s = 0.0

    def count(self, n: int = 1, stream: Optional[int] = None) -> None:
        """Add ``n`` launches: run ones, or with ``stream`` ones captured
        into a graph on that stream."""
        with self.count_lock:
            if stream is None:
                self.launches += n
            else:
                self.captured[stream] = self.captured.get(stream, 0) + n

    def take_captured(self, stream: int) -> int:
        """The launches captured on ``stream`` since the last take."""
        with self.count_lock:
            return self.captured.pop(stream, 0)

    def lib_path(self) -> str:
        with open(self.source, "rb") as f:
            digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return os.path.join(BUILD_DIR, f"lib{self.name}-{digest[:12]}.so")

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            with self._lib_lock:
                if self._lib is None:
                    build_all([self])
                    lib = ctypes.CDLL(self.lib_path())
                    self._bind(lib)
                    self._lib = lib
        return self._lib


def port_kernels() -> List[CudaKernel]:
    """Every hand-written kernel of the port: K1 (halo fold), K2 (decoder
    MLP), K3 (cell stencil), K4 (the ordered cell scatter), K5 (TSDF
    integration), K6 (the mapper's frustum masks), K7 (the trilinear
    lookup)."""
    from attentive_dfprior_tpu_torch.ops.cuda import (
        cell_scatter_kernel,
        decoder_kernel,
        frustum_kernel,
        halo_fold_kernel,
        stencil_kernel,
        trilinear_kernel,
        tsdf_kernel,
    )

    return [halo_fold_kernel.KERNEL, decoder_kernel.KERNEL, stencil_kernel.KERNEL, cell_scatter_kernel.KERNEL,
            tsdf_kernel.KERNEL, frustum_kernel.KERNEL, trilinear_kernel.KERNEL]


def step_kernels() -> List[CudaKernel]:
    """The kernels a mapping or tracking step, a map and a render can launch
    (K1-K4, K6, K7): the launches the harnesses (``tools/bench.py``,
    ``tools/profile_mapping.py``) report a cycle or an iteration. K5 runs
    in the prior's fusion alone, before any step. This is the one place
    that filters ``port_kernels()``:
    a new kernel goes into ``port_kernels()`` only, and here only if no
    step can launch it."""
    return [k for k in port_kernels() if k.name != "tsdf_integrate"]


def build_all(kernels: Iterable[CudaKernel]) -> Dict[str, float]:
    """Compile every kernel whose library is missing, one nvcc process per
    source, all started together. Returns {name: seconds} for the builds
    made; raises with nvcc's output if one fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs: List = []
    for k in kernels:
        out = k.lib_path()
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, k.source]
        procs.append(
            (k, out, tmp, time.perf_counter(),
             subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        )
    times: Dict[str, float] = {}
    errors = []
    for k, out, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        k.build_s = time.perf_counter() - t0
        k.build_log = log
        times[k.name] = k.build_s
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {k.source}:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def check_launch(kernel: CudaKernel, rc: int) -> None:
    """Raise if a launch returned a CUDA error; count it otherwise (as
    captured while the stream captures a graph)."""
    if rc != 0:
        raise RuntimeError(f"{kernel.name}: CUDA launch failed with cudaError {rc}")
    kernel.count(1, capturing_stream())
