"""Geometry helpers (counterpart of `smart_tree_tpu/utils/maths.py`)."""

from __future__ import annotations

import numpy as np


def cube_filter(points, center, cube_size) -> np.ndarray:
    """AABB mask: center +- cube_size/2, half-open [min, max)."""
    points = np.asarray(points)
    center = np.asarray(center)
    mn = center - cube_size / 2
    mx = center + cube_size / 2
    return np.logical_and(points >= mn, points < mx).all(axis=1)
