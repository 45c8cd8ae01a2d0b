"""Geometry helpers (counterpart of `smart_tree_tpu/utils/maths.py`)."""

from __future__ import annotations

import numpy as np


def euler_angles_to_rotation(xyz) -> np.ndarray:
    x, y, z = (float(v) for v in xyz)
    rx = np.array(
        [[1, 0, 0], [0, np.cos(x), -np.sin(x)], [0, np.sin(x), np.cos(x)]]
    )
    ry = np.array(
        [[np.cos(y), 0, np.sin(y)], [0, 1, 0], [-np.sin(y), 0, np.cos(y)]]
    )
    rz = np.array(
        [[np.cos(z), -np.sin(z), 0], [np.sin(z), np.cos(z), 0], [0, 0, 1]]
    )
    return rz @ ry @ rx


def rotation_matrix_from_vectors(vec1, vec2) -> np.ndarray:
    """The rotation taking the direction of vec1 to that of vec2 (Rodrigues).
    For antiparallel vectors it returns -I, a reflection, as the JAX package
    does."""
    a = np.asarray(vec1, np.float64).reshape(3)
    b = np.asarray(vec2, np.float64).reshape(3)
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    s = float(np.linalg.norm(v))
    if s < 1e-12:
        return np.eye(3) if c > 0 else -np.eye(3)
    kmat = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + kmat + kmat @ kmat * ((1 - c) / (s**2))


def cube_filter(points, center, cube_size) -> np.ndarray:
    """AABB mask: center +- cube_size/2, half-open [min, max)."""
    points = np.asarray(points)
    center = np.asarray(center)
    mn = center - cube_size / 2
    mx = center + cube_size / 2
    return np.logical_and(points >= mn, points < mx).all(axis=1)


def polyline_frames(points) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Orthonormal (tangent, normal, binormal) frames along a polyline, for
    tube meshing.

    Tangents are central differences. All normals come from ONE shared
    reference axis: the right-singular vector of the tangent matrix with the
    smallest singular value (the direction least aligned with the whole
    tangent bundle), projected onto each tangent's normal plane. The frames
    vary continuously wherever the polyline does.
    """
    p = np.asarray(points, np.float64)
    seg = np.diff(p, axis=0)
    seg = seg / np.maximum(np.linalg.norm(seg, axis=1, keepdims=True), 1e-12)
    t = np.empty_like(p)
    t[0], t[-1] = seg[0], seg[-1]
    if len(seg) > 1:
        t[1:-1] = seg[:-1] + seg[1:]
    t = t / np.maximum(np.linalg.norm(t, axis=1, keepdims=True), 1e-12)

    _, _, vt = np.linalg.svd(t, full_matrices=False)
    ref = vt[-1]
    n = ref[None, :] - t * (t @ ref)[:, None]
    bad = np.linalg.norm(n, axis=1) < 1e-6
    if np.any(bad):
        # a tangent (anti)parallel to ref: fall back to the next-least
        # aligned axis for those vertices only
        alt = vt[-2] if vt.shape[0] > 1 else np.roll(ref, 1)
        n[bad] = alt[None, :] - t[bad] * (t[bad] @ alt)[:, None]
    n = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
    b = np.cross(t, n)
    return (t.astype(np.float32), n.astype(np.float32), b.astype(np.float32))
