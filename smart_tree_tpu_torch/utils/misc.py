"""Small host helpers (counterpart of `smart_tree_tpu/utils/misc.py`)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def flatten_list(lst: List[list]) -> list:
    return [item for sub in lst for item in sub]


def at_least_2d(arr, expand_axis: int = 1):
    """[N] -> [N, 1]; anything else unchanged. `expand_axis` is accepted and
    ignored, as in the JAX package."""
    arr = np.asarray(arr)
    return arr[:, None] if arr.ndim == 1 else arr


def unique_n_colours(n: int, cmap: str = "hsv") -> np.ndarray:
    """n distinct colours [n, 3] in [0, 1] from a matplotlib colormap."""
    import matplotlib

    m = matplotlib.colormaps[cmap]
    return np.asarray([m(i / max(n, 1))[:3] for i in range(n)])


def points_to_edges(points: np.ndarray) -> np.ndarray:
    """Consecutive polyline edge list [N-1, 2]."""
    n = np.asarray(points).reshape(-1, 3).shape[0]
    idx = np.arange(n - 1)
    return np.stack([idx, idx + 1], axis=1)


def voxel_downsample(xyz: np.ndarray, voxel_size: float) -> np.ndarray:
    """Sorted indices of the first point in each occupied voxel."""
    g = np.floor(np.asarray(xyz) / voxel_size).astype(np.int64)
    _, first = np.unique(g, axis=0, return_index=True)
    return np.sort(first)


def merge_dictionaries(d1: Dict, d2: Dict) -> Dict:
    """d1 updated with d2; a key of d2 already taken is renumbered to the
    next free integer of a counter from 1."""
    merged = dict(d1)
    i = 1
    for key, value in d2.items():
        new_key = key
        while new_key in merged:
            new_key = i
            i += 1
        merged[new_key] = value
    return merged
