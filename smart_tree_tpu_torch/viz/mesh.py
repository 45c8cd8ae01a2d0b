"""Host-side tube meshing (counterpart of `smart_tree_tpu/viz/mesh.py`): one
circular cross-section per skeleton vertex in the frames of
`utils.maths.polyline_frames`, stitched ring to ring with quad strips. The
output feeds the PLY writers in `data/file.py`."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..data.tree import DisjointTreeSkeleton, TreeSkeleton
from ..utils.maths import polyline_frames


def tube_rings(points: np.ndarray, radii: np.ndarray, n: int = 10) -> np.ndarray:
    """[R, n, 3] circles of the given radii perpendicular to the polyline."""
    _, nrm, bnm = polyline_frames(points)
    ang = np.arange(n) * (2.0 * np.pi / n)
    ring = (
        nrm[:, None, :] * np.cos(ang)[None, :, None]
        + bnm[:, None, :] * np.sin(ang)[None, :, None]
    )
    r = np.asarray(radii, np.float32).reshape(-1, 1, 1)
    return np.asarray(points, np.float32)[:, None, :] + r * ring.astype(np.float32)


def ring_strip_triangles(n_rings: int, m: int) -> np.ndarray:
    """Index buffer stitching consecutive m-vertex rings: each quad between
    spoke i of ring k and spoke i+1 of ring k+1 splits along its diagonal."""
    i = np.arange(m)
    j = (i + 1) % m
    base = (np.arange(n_rings - 1) * m)[:, None]
    a, b = base + i, base + j
    c, d = base + j + m, base + i + m
    quads = np.stack([np.stack([a, b, c], -1), np.stack([a, c, d], -1)], axis=2)
    return quads.reshape(-1, 3)


def branch_tube_mesh(
    xyz: np.ndarray, radii: np.ndarray, n: int = 10
) -> Tuple[np.ndarray, np.ndarray]:
    rings = tube_rings(xyz, np.asarray(radii).reshape(-1), n)
    return rings.reshape(-1, 3), ring_strip_triangles(len(rings), n)


def skeleton_tube_mesh(
    skeleton: DisjointTreeSkeleton | TreeSkeleton, n: int = 10, colour_per_tree=True
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Merged tube mesh: (vertices, triangles, vertex_colors)."""
    skels = (
        skeleton.skeletons
        if isinstance(skeleton, DisjointTreeSkeleton)
        else [skeleton]
    )
    rng = np.random.default_rng(0)
    verts, tris, cols = [], [], []
    offset = 0
    for sk in skels:
        colour = rng.uniform(0.2, 0.9, 3)
        for b in sk.branches.values():
            if len(b) < 2:
                continue
            v, t = branch_tube_mesh(b.xyz, b.radii, n)
            verts.append(v)
            tris.append(t + offset)
            cols.append(np.broadcast_to(colour, v.shape).copy())
            offset += len(v)
    if not verts:
        return np.zeros((0, 3)), np.zeros((0, 3), int), np.zeros((0, 3))
    return np.concatenate(verts), np.concatenate(tris), np.concatenate(cols)


def skeleton_lineset(
    skeleton: DisjointTreeSkeleton | TreeSkeleton,
) -> Tuple[np.ndarray, np.ndarray]:
    """Merged polyline edges: (vertices, edges)."""
    skels = (
        skeleton.skeletons
        if isinstance(skeleton, DisjointTreeSkeleton)
        else [skeleton]
    )
    verts, edges = [], []
    offset = 0
    for sk in skels:
        for b in sk.branches.values():
            n = len(b)
            if n < 2:
                continue
            verts.append(b.xyz)
            idx = np.arange(n - 1) + offset
            edges.append(np.stack([idx, idx + 1], axis=1))
            offset += n
    if not verts:
        return np.zeros((0, 3)), np.zeros((0, 2), int)
    return np.concatenate(verts), np.concatenate(edges)
