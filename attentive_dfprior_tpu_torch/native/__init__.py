"""The port's native host library: marching tetrahedra and a z-buffer depth
rasterizer (``marching_tets.cpp``, ``rasterizer.cpp``, copies of the JAX
package's ``native/``).

On first use the two sources are compiled with g++ into one shared library
under ``attentive_dfprior_tpu_torch/build/`` (listed in ``.gitignore``),
named by a hash of the sources and flags, and loaded with ``ctypes``.
Nothing is built at import. Unlike the JAX package, which falls back to
numpy when its build fails, asking for the native route here raises when
g++ or the build fails; callers choose the numpy route explicitly.

The flags leave out ``-march=native``: without FMA contraction the edge
interpolation rounds as numpy's does, so the native surface equals the
numpy golden's (``utils/marching_cubes.py``) up to vertex order.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "build")
SOURCES = ("marching_tets.cpp", "rasterizer.cpp")
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

_lib: Optional[ctypes.CDLL] = None


def lib_path() -> str:
    h = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    for src in SOURCES:
        with open(os.path.join(_DIR, src), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libdfprior_native-{h.hexdigest()[:12]}.so")


def build() -> str:
    """Compile the library if it is missing; returns its path. Raises with
    the compiler's output if g++ is missing or fails."""
    out = lib_path()
    if os.path.exists(out):
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native marching tetrahedra and rasterizer need it")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    res = subprocess.run(
        [cxx, *CXX_FLAGS, "-o", tmp, *(os.path.join(_DIR, s) for s in SOURCES)],
        capture_output=True, text=True, timeout=300,
    )
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCES}:\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded library (built on first use)."""
    global _lib
    if _lib is None:
        lib_ = ctypes.CDLL(build())
        lib_.rasterize_depth.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib_.mt_run.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
        ]
        lib_.mt_num_verts.restype = ctypes.c_int64
        lib_.mt_num_faces.restype = ctypes.c_int64
        lib_.mt_get.argtypes = [ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64)]
        _lib = lib_
    return _lib


def rasterize_depth(
    verts: np.ndarray, faces: np.ndarray, w2c: np.ndarray,
    fx: float, fy: float, cx: float, cy: float, H: int, W: int,
) -> np.ndarray:
    """Render the mesh's depth map from a camera (OpenCV convention, +z
    forward). Returns (H, W) float32 depth; 0 where no geometry."""
    v = np.ascontiguousarray(verts, dtype=np.float32)
    f = np.ascontiguousarray(faces, dtype=np.int32)
    m = np.ascontiguousarray(w2c, dtype=np.float32).reshape(-1)
    if v.ndim != 2 or v.shape[1] != 3 or f.ndim != 2 or f.shape[1] != 3 or m.size != 16:
        raise ValueError(f"rasterize_depth: verts {v.shape}, faces {f.shape}, w2c of {m.size} values")
    if len(f) and (f.min() < 0 or f.max() >= len(v)):
        raise ValueError("rasterize_depth: a face index is outside the vertex array")
    out = np.zeros((H, W), dtype=np.float32)
    lib().rasterize_depth(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(v),
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(f),
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        fx, fy, cx, cy, H, W,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out


def marching_tets(volume: np.ndarray, level: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    """Iso-surface extraction; returns (verts in index space, faces)."""
    lib_ = lib()
    vol = np.ascontiguousarray(volume, dtype=np.float64)
    X, Y, Z = vol.shape
    lib_.mt_run(vol.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), X, Y, Z, level)
    nv = lib_.mt_num_verts()
    nf = lib_.mt_num_faces()
    verts = np.empty((nv, 3), dtype=np.float64)
    faces = np.empty((nf, 3), dtype=np.int64)
    lib_.mt_get(
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return verts, faces
