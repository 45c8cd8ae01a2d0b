"""Plain reference, part 1: a cloud to the voxels the UNet sees.

numpy only. Written from the model's published description and the
configuration: cubes of `block` metres on a grid anchored at the origin, a
cube kept when it holds more than `min_points` points, each cropped with a
`buffer` halo, quantised to `voxel` metres against the crop's lowest corner
(the lowest-numbered point of a voxel stands for it), and a voxel reported
when its point lies inside the un-buffered cube. The input position of a
voxel is its centre plus the point's offset from the centre, sent in steps
of voxel / 254 (int8) and widened to float16, as the configuration states.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Voxels:
    """Every voxel of every block of one cloud, blocks as batch items."""

    coords: np.ndarray     # [M,4] int32 (block, x, y, z)
    point: np.ndarray      # [M] int64 index of the voxel's point in the cloud
    interior: np.ndarray   # [M] bool
    feats: np.ndarray      # [M,3] float32 input positions
    side: int              # voxels along a block's buffered edge (+1)


def _in_cube(xyz, centre, size):
    lo, hi = centre - size / 2, centre + size / 2
    return ((xyz >= lo) & (xyz < hi)).all(axis=1)


def block_centres(xyz, block, min_points):
    q = np.floor(xyz / np.float32(block)).astype(np.int64)
    cells, counts = np.unique(q, axis=0, return_counts=True)
    # the program orders cubes by a packed key; the order does not change
    # any voxel's result
    return cells[counts > min_points] * block + block / 2


def _first_per_voxel(g):
    """(voxel coords lexsorted, the lowest row of each)."""
    order = np.lexsort((np.arange(len(g)), g[:, 2], g[:, 1], g[:, 0]))
    gs = g[order]
    head = np.ones(len(g), bool)
    head[1:] = (gs[1:] != gs[:-1]).any(axis=1)
    return gs[head], order[head]


def encode_inputs(xyz_pts, coords, origin, voxel):
    """Voxel centre + the point's offset in int8 steps of voxel / 254,
    widened to float16 then float32, added in float32."""
    centre64 = origin.astype(np.float32) + (coords + 0.5) * voxel
    steps = np.clip(np.round((xyz_pts - centre64) / (voxel / 254.0)), -127, 127)
    res16 = (steps.astype(np.float32) * np.float32(voxel / 254.0)).astype(np.float16)
    centre32 = origin.astype(np.float32) + (coords.astype(np.float32) + np.float32(0.5)) \
        * np.float32(voxel)
    return (centre32 + res16.astype(np.float32)).astype(np.float32)


def voxelize_cloud(xyz, voxel, block, buffer, min_points=20):
    """All blocks of `xyz` [N,3] float32 as one `Voxels`."""
    xyz = np.asarray(xyz, np.float32)
    side = int(np.ceil((block + 2 * buffer) / voxel)) + 1
    parts = []
    for b, c in enumerate(block_centres(xyz, block, min_points)):
        rows = np.flatnonzero(_in_cube(xyz, c, block + 2 * buffer))
        pts = xyz[rows]
        origin = pts.min(axis=0)
        g = np.floor((pts - origin) / np.float32(voxel)).astype(np.int32)
        vc, first = _first_per_voxel(g)
        p = pts[first]
        parts.append((np.concatenate([np.full((len(vc), 1), b, np.int32), vc], axis=1),
                      rows[first], _in_cube(p, c, block), encode_inputs(p, vc, origin, voxel)))
    if not parts:
        z = np.zeros((0, 3), np.float32)
        return Voxels(np.zeros((0, 4), np.int32), np.zeros(0, np.int64), np.zeros(0, bool), z,
                      side)
    coords, point, interior, feats = (np.concatenate(x) for x in zip(*parts))
    return Voxels(coords, point, interior, feats, side)
