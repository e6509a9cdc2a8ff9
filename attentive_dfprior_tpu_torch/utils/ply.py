"""Minimal PLY mesh / point-cloud I/O (binary + ascii).

The port's copy of the JAX package's ``utils/ply.py`` (numpy only): the
same bytes on write. Replaces the reference's trimesh/skimage export paths
(ref: src/fusion.py:367-427, src/utils/Mesher.py:536-538).
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np


def write_ply(
    path: str,
    verts: np.ndarray,
    faces: Optional[np.ndarray] = None,
    colors: Optional[np.ndarray] = None,
    normals: Optional[np.ndarray] = None,
    binary: bool = True,
) -> None:
    """Write a mesh (or point cloud if faces is None) to .ply.

    Args:
        verts: (V, 3) float; faces: (F, 3) int; colors: (V, 3) uint8;
        normals: (V, 3) float.
    """
    verts = np.asarray(verts, dtype=np.float32)
    V = len(verts)
    has_c = colors is not None
    has_n = normals is not None
    has_f = faces is not None and len(faces) > 0

    header = ["ply"]
    header.append("format binary_little_endian 1.0" if binary else "format ascii 1.0")
    header.append(f"element vertex {V}")
    header += ["property float x", "property float y", "property float z"]
    if has_n:
        header += ["property float nx", "property float ny", "property float nz"]
    if has_c:
        header += [
            "property uchar red",
            "property uchar green",
            "property uchar blue",
        ]
    if faces is not None:
        header.append(f"element face {0 if not has_f else len(faces)}")
        header.append("property list uchar int vertex_indices")
    header.append("end_header")

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if binary:
            cols = [verts]
            if has_n:
                cols.append(np.asarray(normals, dtype=np.float32))
            rec = np.concatenate(cols, axis=1).astype("<f4")
            if has_c:
                c = np.asarray(colors, dtype=np.uint8)
                # interleave: write row-wise (vectorized via structured array)
                dt = np.dtype(
                    [("v", "<f4", rec.shape[1]), ("c", "u1", 3)]
                )
                buf = np.empty(V, dtype=dt)
                buf["v"] = rec
                buf["c"] = c
                f.write(buf.tobytes())
            else:
                f.write(rec.tobytes())
            if has_f:
                faces = np.asarray(faces, dtype=np.int32)
                dt = np.dtype([("n", "u1"), ("idx", "<i4", 3)])
                buf = np.empty(len(faces), dtype=dt)
                buf["n"] = 3
                buf["idx"] = faces
                f.write(buf.tobytes())
        else:
            for i in range(V):
                row = list(verts[i])
                if has_n:
                    row += list(normals[i])
                line = " ".join(f"{x:.6f}" for x in row)
                if has_c:
                    line += " " + " ".join(str(int(x)) for x in colors[i])
                f.write((line + "\n").encode())
            if has_f:
                for fc in faces:
                    f.write(f"3 {fc[0]} {fc[1]} {fc[2]}\n".encode())


def read_ply(path: str) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Read a .ply mesh (ascii or binary_little_endian).

    Returns:
        verts (V, 3) float64, faces (F, 3) int64 (empty if point cloud),
        colors (V, 3) uint8 or None.
    """
    with open(path, "rb") as f:
        # --- header ---
        line = f.readline().strip()
        assert line == b"ply", "not a ply file"
        fmt = None
        n_verts = n_faces = 0
        vert_props = []  # (name, dtype)
        in_vertex = in_face = False
        while True:
            line = f.readline().strip().decode()
            if line.startswith("comment"):
                continue
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element vertex"):
                n_verts = int(line.split()[2])
                in_vertex, in_face = True, False
            elif line.startswith("element face"):
                n_faces = int(line.split()[2])
                in_vertex, in_face = False, True
            elif line.startswith("element"):
                in_vertex = in_face = False
            elif line.startswith("property") and in_vertex:
                parts = line.split()
                vert_props.append((parts[-1], parts[1]))
            elif line == "end_header":
                break

        type_map = {
            "float": "<f4",
            "float32": "<f4",
            "double": "<f8",
            "float64": "<f8",
            "uchar": "u1",
            "uint8": "u1",
            "char": "i1",
            "short": "<i2",
            "ushort": "<u2",
            "int": "<i4",
            "int32": "<i4",
            "uint": "<u4",
        }

        if fmt == "ascii":
            verts_rows = []
            for _ in range(n_verts):
                verts_rows.append(f.readline().split())
            arr = np.array(verts_rows, dtype=np.float64)
            names = [p[0] for p in vert_props]
            xyz = arr[:, [names.index("x"), names.index("y"), names.index("z")]]
            colors = None
            if "red" in names:
                colors = arr[
                    :, [names.index("red"), names.index("green"), names.index("blue")]
                ].astype(np.uint8)
            faces = []
            for _ in range(n_faces):
                parts = f.readline().split()
                cnt = int(parts[0])
                idx = list(map(int, parts[1 : 1 + cnt]))
                for k in range(1, cnt - 1):  # fan-triangulate
                    faces.append([idx[0], idx[k], idx[k + 1]])
            return xyz, np.array(faces, dtype=np.int64).reshape(-1, 3), colors
        else:
            dt = np.dtype([(name, type_map[t]) for name, t in vert_props])
            data = np.frombuffer(f.read(dt.itemsize * n_verts), dtype=dt)
            xyz = np.stack(
                [data["x"], data["y"], data["z"]], axis=1
            ).astype(np.float64)
            colors = None
            if "red" in dt.names:
                colors = np.stack(
                    [data["red"], data["green"], data["blue"]], axis=1
                ).astype(np.uint8)
            faces = np.zeros((0, 3), dtype=np.int64)
            if n_faces > 0:
                raw = f.read()
                # assume uchar count + int32 indices (the common layout)
                fdt = np.dtype([("n", "u1"), ("idx", "<i4", 3)])
                faces = (
                    np.frombuffer(raw, dtype=fdt, count=n_faces)["idx"]
                    .astype(np.int64)
                    .copy()
                )
            return xyz, faces, colors
