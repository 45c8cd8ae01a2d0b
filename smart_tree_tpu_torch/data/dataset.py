"""Inference block tiling (host, numpy).

Counterpart of the inference half of `smart_tree_tpu/data/dataset.py`:
`BlockTiler` floor-divides a cloud into block_size cubes, drops blocks with
too few points, crops each with a +-buffer halo, voxelises it (one point per
voxel) and marks the interior; `batches` packs blocks into padded pow2
capacity batches (`VoxelBatch`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, NamedTuple, Tuple

import numpy as np

from ..utils.maths import cube_filter
from .cloud import Cloud


def _ceil_pow2(n: int, floor: int = 1024) -> int:
    cap = floor
    while cap < n:
        cap *= 2
    return cap


class VoxelBatch(NamedTuple):
    """Host-side padded batch."""

    feats: np.ndarray        # [cap, C_in] input features (xyz + rgb)
    targets: np.ndarray | None
    coords: np.ndarray       # [cap, 4] int32 (b, x, y, z); -1 padding
    mask: np.ndarray         # [cap] bool: interior rows
    valid: np.ndarray        # [cap] bool: real voxel rows (a prefix)
    spatial_shape: Tuple[int, int, int]
    batch_size: int
    filenames: tuple
    origins: np.ndarray | None = None  # [batch_size, 3] f32 per-item grid origin
    voxel_size: float = 0.0

    def compressed_xyz_upload(self):
        """(int16 coords, fp16 residuals from voxel centres, fp32 origins):
        the encoding the JAX package uploads. The port uploads the same so
        that both sides reconstruct bit-identical xyz features."""
        assert self.origins is not None and self.voxel_size > 0
        b = np.clip(self.coords[:, 0], 0, len(self.origins) - 1)
        centre = self.origins[b] + (self.coords[:, 1:] + 0.5) * self.voxel_size
        res = (self.feats[:, :3] - centre).astype(np.float16)
        return self.coords.astype(np.int16), res, self.origins.astype(np.float32)


def voxelize_host(
    xyz: np.ndarray, data: np.ndarray, voxel_size: float
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Floor-quantise against the min corner and keep the first point per
    voxel (np.unique semantics). Returns (coords lex-sorted, data of the
    survivors, grid origin)."""
    origin = xyz.min(axis=0).astype(np.float32)
    g = np.floor((xyz - origin) / voxel_size).astype(np.int32)
    _, first = np.unique(g, axis=0, return_index=True)
    return g[first], data[first], origin


@dataclass
class Block:
    coords: np.ndarray     # [M,3] voxel coords (block-local grid)
    feats: np.ndarray      # [M,6] xyz+rgb of the surviving point
    interior: np.ndarray   # [M] bool: point inside the un-buffered cube
    spatial_shape: Tuple[int, int, int]
    origin: np.ndarray     # [3] f32 block grid origin


class BlockTiler:
    """Spatial tiling with halos into bucketed padded batches."""

    def __init__(
        self,
        cloud: Cloud,
        voxel_size: float,
        block_size: float = 4.0,
        buffer_size: float = 0.4,
        min_points: int = 20,
    ):
        self.voxel_size = voxel_size
        self.block_size = block_size
        self.buffer_size = buffer_size
        # one worst-case grid for every block: the spatial shape only sets
        # the key bit widths
        side = int(np.ceil((block_size + 2 * buffer_size) / voxel_size)) + 1
        self.grid_shape = (side, side, side)
        xyz = np.asarray(cloud.xyz, np.float32)
        rgb = (
            np.asarray(cloud.rgb, np.float32)
            if cloud.rgb is not None
            else np.zeros_like(xyz)
        )
        q = np.floor(xyz / block_size).astype(np.int64)
        qmin = q.min(axis=0)
        qo = q - qmin
        packed = (qo[:, 0] << 42) | (qo[:, 1] << 21) | qo[:, 2]
        upacked, counts = np.unique(packed, return_counts=True)
        upacked = upacked[counts > min_points]
        ids = (
            np.stack(
                [upacked >> 42, (upacked >> 21) & 0x1FFFFF, upacked & 0x1FFFFF],
                axis=1,
            )
            + qmin
        )
        self.block_centres = ids * block_size + block_size / 2

        self.blocks: List[Block] = []
        for centre in self.block_centres:
            m = cube_filter(xyz, centre, block_size + 2 * buffer_size)
            bxyz, brgb = xyz[m], rgb[m]
            coords, data, origin = voxelize_host(
                bxyz, np.concatenate([bxyz, brgb], axis=1), voxel_size
            )
            interior = cube_filter(data[:, :3], centre, block_size)
            shape = tuple(int(v) + 1 for v in coords.max(axis=0))
            self.blocks.append(Block(coords, data, interior, shape, origin))

    def __len__(self):
        return len(self.blocks)

    def batches(
        self, batch_size: int = 4, max_capacity: int | None = None
    ) -> Iterator[VoxelBatch]:
        """Greedy size-bucketed batches of blocks sorted by voxel count; a
        batch closes early when the next block would push its pow2
        capacity past max_capacity (a single larger block ships alone)."""
        order = np.argsort([len(b.coords) for b in self.blocks])
        chunk: List[Block] = []
        total = 0
        for i in order:
            blk = self.blocks[i]
            n = len(blk.coords)
            over = max_capacity is not None and chunk and (
                _ceil_pow2(total + n) > max_capacity
            )
            if len(chunk) == batch_size or over:
                yield collate_blocks(chunk, batch_size, self.grid_shape, self.voxel_size)
                chunk, total = [], 0
            chunk.append(blk)
            total += n
        if chunk:
            yield collate_blocks(chunk, batch_size, self.grid_shape, self.voxel_size)


def collate_blocks(
    blocks: List[Block],
    batch_size: int,
    grid_shape: Tuple[int, int, int],
    voxel_size: float = 0.0,
) -> VoxelBatch:
    total = sum(len(b.coords) for b in blocks)
    cap = _ceil_pow2(total)
    coords = np.full((cap, 4), -1, np.int32)
    feats = np.zeros((cap, blocks[0].feats.shape[1]), np.float32)
    mask = np.zeros(cap, bool)
    valid = np.zeros(cap, bool)
    origins = np.zeros((batch_size, 3), np.float32)
    row = 0
    for b, blk in enumerate(blocks):
        n = len(blk.coords)
        coords[row : row + n, 0] = b
        coords[row : row + n, 1:] = blk.coords
        feats[row : row + n] = blk.feats
        mask[row : row + n] = blk.interior
        valid[row : row + n] = True
        origins[b] = blk.origin
        row += n
    return VoxelBatch(
        feats=feats,
        targets=None,
        coords=coords,
        mask=mask,
        valid=valid,
        spatial_shape=grid_shape,
        batch_size=batch_size,  # fixed even for a short last batch
        filenames=(),
        origins=origins,
        voxel_size=voxel_size,
    )
