"""Block tiling of a cloud on the device, for `ModelInference.forward`.

Replaces no Pallas kernel: the JAX package tiles on the host. In the forward
it takes the place of the host's `data/dataset.py::BlockTiler` (block ids,
`native.tile_blocks`, a native dedup a block, `collate_blocks`) and, a
batch, `VoxelBatch.key_order` and `_stage_sorted`; those stay for
`predict()`, training and the tests, and every array here is bit-equal to
theirs.

`tile_cloud` uploads the cloud's xyz once (12 B a point), finds the kept
blocks on the host (`data/dataset.py::kept_blocks`, the cells with more than
`min_points` points, lexicographic) and on the device:

  1. bins every point into each kept block whose buffered cube holds it
     (`native.tile_blocks`' per-axis slab test on float64 faces, the same
     point-box tests), each block's origin the float32 minimum of its halo
     points; one host read of the tests and halo rows, which size the rest;
  2. voxelises each halo row, floor((p - origin) / voxel) in float32, keeps
     the lowest point index of each voxel (`voxelize_host`), and sorts each
     block's voxels lexicographically; one host read of each block's voxel
     and interior counts.

`Tiling.batches` groups the blocks as `BlockTiler.batches` does
(`dataset.group_blocks`). For each batch `gather` writes the inputs of
`ModelInference._sorted_input`: the int64 keys (the batch slot in the top
bits, so a batch's sorted keys are its blocks' runs in slot order), the
residuals from the voxel centres as `VoxelBatch._residuals` computes them
(the centre in float64, then int8 steps of voxel / 254 or fp16), the
interior flags, the int32 point index of each row and the batch's origins.

On CUDA tensors the work is `csrc/tiler.cu`: `st_tile_bin` (one launch),
`st_tile_sort` (six) and `st_tile_gather` (one a batch), raising if a launch
fails; `tile_cloud.launches` and `gather.launches` count them. On CPU tensors
the plain versions below (vectorised torch: sorts and segment reductions)
compute the same arrays; there is no other fallback.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..data.cloud import Cloud
from ..data.dataset import _ceil_pow2, cloud_arrays, grid_side, group_blocks, kept_blocks
from ..utils.trace import count
from . import kernels
from .coords import key_bits

# the tiling's header (int64): point-box tests and halo rows (the first
# read), then halo rows whose voxel falls outside the grid, each block's
# voxels and each block's interior voxels (the second read); csrc/tiler.cu
# numbers them alike
BAD = 2
HEADER = 3


class Faces(NamedTuple):
    """The faces `native.tile_blocks` tests a point against, as float64:
    block k's buffered slab on an axis is [k * block + block / 2 - half_halo,
    ... + half_halo), its interior one the same with half_in."""
    block: float
    half_block: float
    half_halo: float
    half_in: float
    reach: int      # the cells either side of a point's own one its slabs may be

    @classmethod
    def of(cls, block_size: float, buffer_size: float) -> "Faces":
        block, buffer = float(block_size), float(buffer_size)
        if not block > 0:
            raise ValueError(f"block_size must be positive, got {block}")
        return cls(block, block / 2.0, (block + 2.0 * buffer) / 2.0, block / 2.0,
                   int(math.floor(abs(buffer) / block)) + 1)


class Tiling(NamedTuple):
    """One cloud's blocks on the device: its voxels, block after block,
    lexicographic within each."""
    xyz: np.ndarray               # host [N, 3] fp32 (the collect half takes rows of it)
    rgb: np.ndarray               # host [N, 3] fp32
    points: torch.Tensor          # [N, 3] fp32 on the device
    origins: torch.Tensor         # [B, 3] fp32 each block's grid origin
    key: torch.Tensor             # [M] int32 packed (x, y, z) in the block's grid
    first: torch.Tensor           # [M] int32 the lowest point index of each voxel
    interior: torch.Tensor        # [M] uint8 that point inside the block's un-buffered cube
    vstart: torch.Tensor          # [B * side + 1] int32 first voxel of each (block, x) slab
    counts: np.ndarray            # [B] int64 voxels of each block
    interior_counts: np.ndarray   # [B] int64 interior voxels of each block
    box_tests: int
    side: int
    voxel_size: float
    upload_bytes: int             # xyz and the block ids, host to device

    @property
    def device(self) -> torch.device:
        return self.points.device

    @property
    def grid_shape(self) -> Tuple[int, int, int]:
        return (self.side,) * 3

    def batches(self, batch_size: int, max_capacity: int | None = None) -> List["TileBatch"]:
        """The batches of `BlockTiler.batches`, as the blocks of each; blocks
        without a voxel are left out."""
        key_bits(self.grid_shape, batch_size)   # raises where a key passes 32 bits
        live = np.flatnonzero(self.counts > 0)
        return [TileBatch(self, live[chunk], batch_size)
                for chunk in group_blocks(self.counts[live], batch_size, max_capacity)]


class TileBatch:
    """One batch of a tiling: the blocks of its slots [lo, hi) (a half keeps
    the slots, rows and origins of the batch it came from), and, once
    gathered, the batch's inputs."""

    def __init__(self, tiling: Tiling, blocks: np.ndarray, batch_size: int, lo: int = 0,
                 hi: int | None = None, inputs: tuple | None = None):
        self.tiling = tiling
        self.blocks = np.asarray(blocks, np.int64)
        self.batch_size = batch_size
        self.offsets = np.concatenate([[0], np.cumsum(tiling.counts[self.blocks])])
        self.lo, self.hi = lo, len(self.blocks) if hi is None else hi
        self.inputs = inputs

    @property
    def spatial_shape(self) -> Tuple[int, int, int]:
        return self.tiling.grid_shape

    @property
    def rows(self) -> int:
        return int(self.offsets[self.hi] - self.offsets[self.lo])

    @property
    def capacity(self) -> int:
        """The pow2 capacity `collate_blocks` (or `halve_batch`) gives it."""
        return _ceil_pow2(self.rows)

    @property
    def n_interior(self) -> int:
        return int(self.tiling.interior_counts[self.blocks[self.lo:self.hi]].sum())

    def table(self) -> np.ndarray:
        """int64 [2 k + 1]: the block of each of the batch's k slots, then the
        slots' row offsets (`gather`'s table)."""
        return np.concatenate([self.blocks, self.offsets]).astype(np.int64)

    def halves(self) -> Tuple["TileBatch", "TileBatch"] | None:
        """`halve_batch`: the first and the last half of its blocks, or None
        for one block. Gathered inputs are shared, not gathered again."""
        if self.hi - self.lo < 2:
            return None
        mid = self.lo + (self.hi - self.lo) // 2
        return tuple(TileBatch(self.tiling, self.blocks, self.batch_size, a, b, self.inputs)
                     for a, b in ((self.lo, mid), (mid, self.hi)))

    def part(self):
        """The gathered inputs of its own rows: (keys, res, interior, index,
        origins)."""
        keys, res, interior, index, origins = self.inputs
        a, b = int(self.offsets[self.lo]), int(self.offsets[self.hi])
        return keys[a:b], res[a:b], interior[a:b], index[a:b], origins


# ---------------------------------------------------------------- the tiling

def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def tile_cloud(cloud: Cloud, voxel_size: float, block_size: float, buffer_size: float,
               device: torch.device, min_points: int = 20, stats: dict | None = None) -> Tiling:
    """A cloud's tiling on `device`. `stats` gets the point-box tests
    (`tile_box_tests`) and the host reads (`tile_fetches`, two; none for a
    cloud too sparse for any block)."""
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"the tiler runs on cuda or cpu, not {device}")
    xyz, rgb = cloud_arrays(cloud)
    xyz = np.ascontiguousarray(xyz)
    side = grid_side(voxel_size, block_size, buffer_size)
    bits = key_bits((side,) * 3, 1)[1]   # raises where a key passes 32 bits
    faces = Faces.of(block_size, buffer_size)
    ids = kept_blocks(xyz, block_size, min_points)
    nb = len(ids)
    zeros = np.zeros(nb, np.int64)
    if nb == 0:
        e32 = torch.zeros(0, dtype=torch.int32, device=device)
        return Tiling(xyz, rgb, torch.zeros((0, 3), device=device),
                      torch.zeros((0, 3), device=device), e32, e32, e32.to(torch.uint8),
                      torch.zeros(1, dtype=torch.int32, device=device), zeros, zeros, 0, side,
                      float(voxel_size), 0)
    points = _upload(xyz, device)
    steps = _CudaSteps if device.type == "cuda" else _PlainSteps
    work = steps(points, _upload(ids, device), faces, float(voxel_size), side, bits)
    tests, halo = work.bin().tolist()
    count(stats, "tile_fetches")
    head = work.sort(halo).tolist()
    count(stats, "tile_fetches")
    count(stats, "tile_box_tests", tests)
    if head[0]:
        raise RuntimeError(f"the tiler placed {head[0]} halo rows outside the {side}^3 grid")
    counts = np.asarray(head[1:1 + nb], np.int64)
    m = int(counts.sum())
    return Tiling(xyz, rgb, points, work.origins, work.key[:m], work.first[:m],
                  work.interior[:m], work.vstart, counts, np.asarray(head[1 + nb:], np.int64),
                  int(tests), side, float(voxel_size), xyz.nbytes + ids.nbytes)


tile_cloud.launches = 0


class _CudaSteps:
    """The tiling's two steps as csrc/tiler.cu's launches."""

    def __init__(self, points, ids, faces: Faces, voxel: float, side: int, bits: int):
        self.points, self.ids, self.faces = points, ids, faces
        self.voxel, self.side, self.bits = voxel, side, bits
        dev = points.device
        self.nb = ids.shape[0]
        self.origins = torch.full((self.nb, 3), float("inf"), dtype=torch.float32, device=dev)
        self.hdr = torch.zeros(HEADER + 2 * self.nb, dtype=torch.int64, device=dev)
        self.stream = torch.cuda.current_stream(dev).cuda_stream

    def bin(self) -> torch.Tensor:
        """Queue the binning: the header's tests and halo rows."""
        f = self.faces
        rc = kernels.load().st_tile_bin(
            self.points.data_ptr(), self.points.shape[0], self.ids.data_ptr(), self.nb, f.block,
            f.half_block, f.half_halo, f.half_in, f.reach, self.origins.data_ptr(),
            self.hdr.data_ptr(), self.stream)
        kernels.check(rc, "st_tile_bin")
        tile_cloud.launches += 1
        return self.hdr[:BAD]

    def sort(self, halo: int) -> torch.Tensor:
        """Queue the dedup and key order of `halo` rows: the header's rows
        outside the grid, voxel counts and interior counts."""
        if halo >= 1 << 31:
            raise ValueError(f"the tiler takes fewer than 2^31 halo rows, got {halo}")
        dev, f = self.points.device, self.faces
        slabs = self.nb * self.side

        def i32(*shape):
            return torch.empty(shape, dtype=torch.int32, device=dev)

        count_, ucount = (torch.zeros(slabs, dtype=torch.int32, device=dev) for _ in range(2))
        start, self.vstart = i32(slabs + 1), i32(slabs + 1)
        rec, tmp, rank = i32(halo, 2), i32(halo, 2), i32(halo)
        self.key, self.first = i32(halo), i32(halo)
        self.interior = torch.empty(halo, dtype=torch.uint8, device=dev)
        rc = kernels.load().st_tile_sort(
            self.points.data_ptr(), self.points.shape[0], self.ids.data_ptr(), self.nb, f.block,
            f.half_block, f.half_halo, f.half_in, f.reach, self.origins.data_ptr(), self.voxel,
            self.side, self.bits, halo, count_.data_ptr(), start.data_ptr(), rec.data_ptr(),
            tmp.data_ptr(), rank.data_ptr(), ucount.data_ptr(), self.vstart.data_ptr(),
            self.key.data_ptr(), self.first.data_ptr(), self.interior.data_ptr(),
            self.hdr.data_ptr(), self.stream)
        kernels.check(rc, "st_tile_sort")
        tile_cloud.launches += 6
        return self.hdr[BAD:]


class _PlainSteps:
    """The plain version of the two steps (CPU tensors): the same arrays."""

    def __init__(self, points, ids, faces: Faces, voxel: float, side: int, bits: int):
        self.points, self.ids, self.faces = points, ids, faces
        self.voxel, self.side, self.bits = voxel, side, bits
        self.nb = ids.shape[0]

    def bin(self) -> torch.Tensor:
        f, p32 = self.faces, self.points
        p = p32.double()
        finite = torch.isfinite(p).all(dim=1)
        p = torch.where(finite[:, None], p, 0.0)
        cell = torch.floor(p / f.block)                               # [N, 3]
        win = torch.arange(-f.reach, f.reach + 1, dtype=torch.float64)
        k = cell[:, :, None] + win                                    # [N, 3, W]
        centre = k * f.block + f.half_block
        q = p[:, :, None]
        hit = (centre - f.half_halo <= q) & (q < centre + f.half_halo) & finite[:, None, None]
        inside = (centre - f.half_in <= q) & (q < centre + f.half_in)
        tests = int((hit.sum(dim=2).prod(dim=1)).sum())
        combo = (hit[:, 0, :, None, None] & hit[:, 1, None, :, None]
                 & hit[:, 2, None, None, :])                          # [N, W, W, W]
        i, dx, dy, dz = torch.nonzero(combo, as_tuple=True)
        kb = torch.stack([k[i, 0, dx], k[i, 1, dy], k[i, 2, dz]], dim=1).to(torch.int64)
        j = _find_blocks(self.ids, kb)
        found = j >= 0
        i, j = i[found], j[found]
        within = inside[i, 0, dx[found]] & inside[i, 1, dy[found]] & inside[i, 2, dz[found]]
        self.rows = (i, j, within)
        # each block's origin: the float32 minimum of its halo points
        self.origins = torch.full((self.nb, 3), float("inf"), dtype=torch.float32).scatter_reduce(
            0, j[:, None].expand(-1, 3), p32[i], "amin")
        return torch.tensor([tests, i.shape[0]], dtype=torch.int64)

    def sort(self, halo: int) -> torch.Tensor:
        i, j, within = self.rows
        side, bits = self.side, self.bits
        g = torch.floor((self.points[i] - self.origins[j])
                        / torch.tensor(self.voxel, dtype=torch.float32))
        ok = ((g >= 0) & (g < side)).all(dim=1)
        bad = int((~ok).sum())
        i, j, within, g = i[ok], j[ok], within[ok], g[ok].to(torch.int64)
        key = (g[:, 0] << (2 * bits)) | (g[:, 1] << bits) | g[:, 2]
        # (block, key) ascending, the lowest point index first in each voxel
        order = torch.sort(i, stable=True).indices
        order = order[torch.sort((j << (3 * bits))[order] | key[order], stable=True).indices]
        comp = (j << (3 * bits))[order] | key[order]
        lead = torch.ones_like(comp, dtype=torch.bool)
        lead[1:] = comp[1:] != comp[:-1]
        sel = order[lead]
        jv = j[sel]
        self.key = key[sel].to(torch.int32)
        self.first = i[sel].to(torch.int32)
        self.interior = within[sel].to(torch.uint8)
        slab = jv * side + g[sel, 0]
        self.vstart = torch.cat([torch.zeros(1, dtype=torch.int64),
                                 torch.bincount(slab, minlength=self.nb * side).cumsum(0)]
                                ).to(torch.int32)
        counts = torch.bincount(jv, minlength=self.nb)
        inner = torch.bincount(jv[self.interior.bool()], minlength=self.nb)
        return torch.cat([torch.tensor([bad]), counts, inner])


def _find_blocks(ids: torch.Tensor, kb: torch.Tensor) -> torch.Tensor:
    """The row of each block coordinate triple of `kb` among the sorted `ids`,
    -1 where it is not kept: each axis' coordinate ranked among the kept
    ones, the ranks combined in lexicographic order and searched."""
    ranks, found, dims = [], torch.ones(kb.shape[0], dtype=torch.bool), []
    for a in range(3):
        axis = torch.unique(ids[:, a])
        r = torch.searchsorted(axis, kb[:, a].contiguous()).clamp(max=axis.shape[0] - 1)
        found &= axis[r] == kb[:, a]
        ranks.append((r, torch.searchsorted(axis, ids[:, a].contiguous())))
        dims.append(axis.shape[0])
    code = (ranks[0][0] * dims[1] + ranks[1][0]) * dims[2] + ranks[2][0]
    table = (ranks[0][1] * dims[1] + ranks[1][1]) * dims[2] + ranks[2][1]   # ascending
    at = torch.searchsorted(table, code).clamp(max=table.shape[0] - 1)
    found &= table[at] == code
    return torch.where(found, at, -1)


# ---------------------------------------------------------------- a batch

def gather(batch: TileBatch, table: torch.Tensor, int8_res: bool):
    """A batch's inputs on the tiling's device, from its `table()` there:
    (keys int64 [rows], residuals int8 or fp16 [rows, 3], interior bool
    [rows], point index int32 [rows], origins fp32 [batch_size, 3])."""
    t = batch.tiling
    dev = t.device
    slots, rows, bs = len(batch.blocks), int(batch.offsets[-1]), batch.batch_size
    bits = key_bits(t.grid_shape, 1)[1]
    step = t.voxel_size / 254.0
    if dev.type == "cpu":
        return _gather_plain(t, table, slots, rows, bs, bits, step, int8_res)
    keys = torch.empty(rows, dtype=torch.int64, device=dev)
    res = torch.empty((rows, 3), dtype=torch.int8 if int8_res else torch.float16, device=dev)
    interior = torch.empty(rows, dtype=torch.bool, device=dev)
    index = torch.empty(rows, dtype=torch.int32, device=dev)
    origins = torch.empty((bs, 3), dtype=torch.float32, device=dev)
    rc = kernels.load().st_tile_gather(
        table.data_ptr(), slots, bs, rows, t.key.data_ptr(), t.first.data_ptr(),
        t.interior.data_ptr(), t.vstart.data_ptr(), t.side, t.origins.data_ptr(),
        t.points.data_ptr(), t.voxel_size, step, bits, int(int8_res), keys.data_ptr(),
        res.data_ptr(), interior.data_ptr(), index.data_ptr(), origins.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(rc, "st_tile_gather")
    gather.launches += 1
    return keys, res, interior, index, origins


gather.launches = 0


def _gather_plain(t: Tiling, table, slots: int, rows: int, bs: int, bits: int, step: float,
                  int8_res: bool):
    """The plain version of `gather` (CPU tensors)."""
    blocks, offsets = table[:slots], table[slots:]
    sizes = offsets[1:] - offsets[:-1]
    slot = torch.repeat_interleave(torch.arange(slots), sizes)
    start = t.vstart.to(torch.int64)[blocks * t.side]
    v = start[slot] + torch.arange(rows) - offsets[:-1][slot]
    k = t.key[v].to(torch.int64)
    keys = (slot << (3 * bits)) | k
    mask = (1 << bits) - 1
    g = torch.stack([k >> (2 * bits), (k >> bits) & mask, k & mask], dim=1)
    index = t.first[v]
    # numpy's origins[b] + (coords + 0.5) * voxel_size, then feats - centre
    centre = t.origins[blocks][slot].double() + (g.double() + 0.5) * t.voxel_size
    res = t.points[index.long()].double() - centre
    if int8_res:
        res = torch.round(res / step).clamp(-127, 127).to(torch.int8)
    else:   # numpy's float64 -> float16 rounds once (torch's goes through float32)
        res = torch.from_numpy(res.numpy().astype(np.float16))
    origins = torch.zeros((bs, 3), dtype=torch.float32)
    origins[:slots] = t.origins[blocks]
    return keys, res, t.interior[v].bool(), index, origins
