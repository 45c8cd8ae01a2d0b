"""Capsule (tube) primitives as numpy host types (counterpart of
`smart_tree_tpu/data/tube.py`). The collated layout is what the point->tube
queries of `utils/queries.py` take."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class Tube:
    a: np.ndarray  # [3] start point
    b: np.ndarray  # [3] end point
    r1: float
    r2: float


@dataclass
class CollatedTube:
    """SoA batch of M tubes: a,b [M,3]; r1,r2 [M]."""

    a: np.ndarray
    b: np.ndarray
    r1: np.ndarray
    r2: np.ndarray

    def __len__(self):
        return self.a.shape[0]


def collate_tubes(tubes: List[Tube]) -> CollatedTube:
    a = np.stack([np.asarray(t.a, np.float32).reshape(3) for t in tubes])
    b = np.stack([np.asarray(t.b, np.float32).reshape(3) for t in tubes])
    r1 = np.asarray([float(t.r1) for t in tubes], np.float32)
    r2 = np.asarray([float(t.r2) for t in tubes], np.float32)
    return CollatedTube(a, b, r1, r2)


def sample_tubes(tubes: List[Tube], spacing: float):
    """Resample tube axes at fixed spacing with lerped radii."""
    pts, radius = [], []
    for tube in tubes:
        a = np.asarray(tube.a, np.float32).reshape(3)
        b = np.asarray(tube.b, np.float32).reshape(3)
        v = b - a
        length = float(np.linalg.norm(v))
        if length == 0:
            continue
        direction = v / length
        num_points = int(np.ceil(length / spacing))
        if num_points > 0:
            spaced = np.arange(0, length, step=length / num_points).reshape(-1, 1)
            lin_r = np.linspace(float(tube.r1), float(tube.r2), spaced.shape[0])
            pts.append(a + direction * spaced)
            radius.append(lin_r)
    return np.concatenate(pts, axis=0), np.concatenate(radius, axis=0)
