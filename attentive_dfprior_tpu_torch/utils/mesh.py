"""Mesh post-processing: connected components, areas, containment, culling.

The port's copy of the JAX package's ``utils/mesh.py`` (numpy + scipy).
Replaces the trimesh/open3d operations the reference uses for mesh cleaning
(ref: src/utils/Mesher.py:488-510 components/area filter;
Mesher.py:219-284 convex-hull bound; tools/cull_mesh.py frustum culling)
with scipy + numpy implementations.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import sparse
from scipy.sparse.csgraph import connected_components
from scipy.spatial import ConvexHull, Delaunay


def face_areas(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    return 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)


def split_components(
    verts: np.ndarray, faces: np.ndarray
) -> Tuple[np.ndarray, int]:
    """Label faces by connected component (shared-vertex connectivity).

    Returns:
        face_labels (F,), n_components.
    """
    if len(faces) == 0:
        return np.zeros((0,), dtype=np.int64), 0
    V = len(verts)
    # vertices connected if they share a face edge
    rows = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2]])
    cols = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0]])
    adj = sparse.coo_matrix(
        (np.ones(len(rows), dtype=np.int8), (rows, cols)), shape=(V, V)
    )
    n, vert_labels = connected_components(adj, directed=False)
    return vert_labels[faces[:, 0]], n


def filter_small_components(
    verts: np.ndarray,
    faces: np.ndarray,
    min_area: float = 0.2,
    keep_largest_only: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Drop small disconnected pieces (ref: Mesher.py:500-510).

    Args:
        min_area: minimum component surface area to keep.
        keep_largest_only: keep just the largest-area component.

    Returns:
        (verts, faces) re-indexed.
    """
    labels, n = split_components(verts, faces)
    if n <= 1:
        return verts, faces
    areas = face_areas(verts, faces)
    comp_area = np.zeros(n)
    np.add.at(comp_area, labels, areas)
    if keep_largest_only:
        keep = labels == int(np.argmax(comp_area))
    else:
        keep = comp_area[labels] > min_area
    return reindex_mesh(verts, faces[keep])


def reindex_mesh(verts: np.ndarray, faces: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Drop unreferenced vertices, remapping face indices."""
    used = np.unique(faces.ravel()) if len(faces) else np.zeros(0, dtype=np.int64)
    remap = -np.ones(len(verts), dtype=np.int64)
    remap[used] = np.arange(len(used))
    return verts[used], remap[faces] if len(faces) else faces


def convex_hull_mesh(
    points: np.ndarray, scale: float = 1.0
) -> Tuple[np.ndarray, np.ndarray, Delaunay]:
    """Convex hull of a point set, optionally scaled about its centroid.

    Mirrors the o3d compute_convex_hull + scale(1.02, center) step
    (ref: Mesher.py:274-284). Returns (verts, faces, delaunay) where the
    Delaunay triangulation supports fast containment queries.
    """
    hull = ConvexHull(points)
    hv = points[hull.vertices]
    center = hv.mean(axis=0)
    hv = (hv - center) * scale + center
    dela = Delaunay(hv)
    # re-run hull on scaled points for faces
    hull2 = ConvexHull(hv)
    return hv, hull2.simplices.astype(np.int64), dela


def points_in_hull(points: np.ndarray, dela: Delaunay) -> np.ndarray:
    """Boolean containment of points in a convex hull (trimesh .contains
    equivalent, ref: Mesher.py:437-439)."""
    return dela.find_simplex(points) >= 0


def cull_faces_by_vertex_mask(
    verts: np.ndarray, faces: np.ndarray, drop_vertex_mask: np.ndarray
) -> np.ndarray:
    """Remove faces whose vertices are ALL flagged (ref: Mesher.py:496-498)."""
    face_drop = drop_vertex_mask[faces].all(axis=1)
    return faces[~face_drop]
