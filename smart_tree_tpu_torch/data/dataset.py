"""Datasets (host, numpy): training voxel batches and inference block tiling.

Counterpart of `smart_tree_tpu/data/dataset.py`:

  TreeDataset  load an npz -> augment -> gather input and target features by
               name -> voxelise (one point per voxel) -> `collate` into a
               PADDED fixed-capacity batch. A plain host iterator, no
               DataLoader.
  BlockTiler   floor-divide a cloud into block_size cubes, drop blocks with
               too few points, bin the points into each block's +-buffer
               halo in one native pass, voxelise each block and mark the
               interior; `batches` packs blocks into padded pow2 capacity
               batches.

Both produce a `VoxelBatch`. `ModelInference.forward` no longer calls
`BlockTiler`, `collate_blocks`, `halve_batch` or a batch's `key_order` and
`_stage_sorted`: it tiles on the device (core/tiler.py) and shares only
`kept_blocks`, `grid_side` and `group_blocks` with this module, whose host
path stays for `predict()`, training and the tests, and as the device
tiler's reference, bit for bit.
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, List, NamedTuple, Tuple

import numpy as np

from .. import native
from ..core.coords import INVALID_KEY, pack_coords_np
from .cloud import Cloud
from .file import load_cloud

log = logging.getLogger(__name__)


def _ceil_pow2(n: int, floor: int = 1024) -> int:
    cap = floor
    while cap < n:
        cap *= 2
    return cap


def stage_rows(n: int, capacity: int, granularity: int) -> int:
    """Rows of a batch that cross the link: n rounded up to `granularity`
    (at least one step), at most the capacity."""
    return min(capacity, -(-max(n, 1) // granularity) * granularity)


class VoxelBatch(NamedTuple):
    """Host-side padded batch."""

    feats: np.ndarray        # [cap, C_in] input features (xyz + rgb)
    targets: np.ndarray | None  # [cap, C_t] target features (training only)
    coords: np.ndarray       # [cap, 4] int32 (b, x, y, z); -1 padding
    mask: np.ndarray         # [cap] bool: loss / interior mask
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

    @property
    def capacity(self) -> int:
        """Rows of the padded batch."""
        return len(self.coords)

    @property
    def n_valid(self) -> int:
        """Number of real voxel rows. Valid rows are a PREFIX of the buffer
        (collate / collate_blocks fill from row 0); the compact uploads rely
        on it, so anything else raises."""
        n = int(self.valid.sum())
        if not bool(self.valid[:n].all()):
            raise ValueError("valid rows are not a prefix of the batch")
        return n

    def key_order(self):
        """(packed keys, their stable sort order, number of active rows): the
        row order of the device's sorted tensor, rebuilt on the host from the
        bit-equal key packing; active rows are the sorted prefix."""
        keys = pack_coords_np(self.coords, self.spatial_shape, self.batch_size, valid=self.valid)
        order = np.argsort(keys, kind="stable")
        return keys, order, int((keys != np.uint32(INVALID_KEY)).sum())

    def _residuals(self, rows, res_dtype) -> np.ndarray:
        """Residuals of `rows` from their voxel centres, as fp16, or as int8
        steps of voxel_size / 254 clipped to +-127."""
        b = np.clip(self.coords[rows, 0], 0, len(self.origins) - 1)
        centre = self.origins[b] + (self.coords[rows, 1:] + 0.5) * self.voxel_size
        res = self.feats[rows, :3] - centre
        if res_dtype == np.int8:
            return np.clip(np.round(res / (self.voxel_size / 254.0)), -127, 127).astype(np.int8)
        return res.astype(res_dtype)

    def compact_upload(self, granularity: int = 4096, res_dtype=np.float16):
        """Valid-rows-only staging of the compressed upload: (coords16
        [stage,4], res [stage,3], origins, n_valid), stage = n_valid rounded
        up to `granularity`; the padded tail of the batch never crosses the
        link. res_dtype=np.int8 quantises residuals to voxel_size / 254 steps
        (for absolute-xyz models; 'local' models divide residuals by
        voxel_size and keep fp16)."""
        assert self.origins is not None and self.voxel_size > 0
        n = self.n_valid
        rows = np.arange(stage_rows(n, len(self.coords), granularity))
        res = self._residuals(rows, res_dtype)
        return self.coords[rows].astype(np.int16), res, self.origins.astype(np.float32), n

    def compact_upload_sorted(self, granularity: int = 4096, res_dtype=np.float16,
                              with_mask: bool = False):
        """compact_upload PRE-SORTED by packed voxel key on the host: (skeys
        [stage] uint32 ascending, res [stage,3], origins, n_active[, bits]).

        The keys replace the int16 coords (4 B a voxel instead of 8) and are
        the order the device would sort by, so the device skips its sort and
        gather: active rows arrive as the [:n_active] prefix and coords are
        unpacked from the keys. with_mask=True adds the interior mask of the
        staged sorted rows packed to bits (np.packbits), which the download
        cull needs on the device."""
        out = self._stage_sorted(*self.key_order(), granularity, res_dtype)
        return out if with_mask else out[:4]

    def _stage_sorted(self, keys, order, n_act: int, granularity: int, res_dtype):
        """compact_upload_sorted(with_mask=True) from the batch's
        `key_order()`, for a caller that keeps the order."""
        assert self.origins is not None and self.voxel_size > 0
        sel = order[: stage_rows(n_act, len(self.coords), granularity)]
        return (keys[sel], self._residuals(sel, res_dtype), self.origins.astype(np.float32),
                n_act, np.packbits(self.mask[sel]))


def voxelize_host(
    xyz: np.ndarray, data: np.ndarray, voxel_size: float
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Floor-quantise against the min corner and keep the first point per
    voxel, through the native hash dedup (`native/st_native.cpp`; its build
    raises on failure, there is no quiet numpy fallback). Returns (coords
    lex-sorted, data of the survivors, grid origin), equal to
    `voxelize_host_plain`."""
    origin = xyz.min(axis=0).astype(np.float32)
    coords, first = native.voxelize(xyz, voxel_size, origin)
    return coords, data[first], origin


def voxelize_host_plain(
    xyz: np.ndarray, data: np.ndarray, voxel_size: float
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """numpy version of `voxelize_host` (np.unique semantics)."""
    origin = xyz.min(axis=0).astype(np.float32)
    coords, first = native.voxelize_plain(xyz, voxel_size, origin)
    return coords, data[first], origin


def _feature(cloud: Cloud, name: str) -> np.ndarray:
    v = np.asarray(getattr(cloud, name))
    return v.reshape(len(cloud), -1).astype(np.float32)


class TreeDataset:
    """Training dataset over a split json ({"train": [...], "validation":
    [...], "test": [...]} of paths relative to `directory`)."""

    def __init__(
        self,
        voxel_size,
        json_path,
        directory,
        mode,
        input_features,
        target_features,
        augmentation=None,
        cache: bool = False,
        seed: int = 0,
    ):
        self.voxel_size = voxel_size
        self.mode = mode
        self.augmentation = augmentation
        self.directory = Path(directory)
        self.input_features = list(input_features)
        self.target_features = list(target_features)
        json_path = Path(json_path)
        assert json_path.is_file(), f"json metadata does not exist at '{json_path}'"
        with open(json_path) as f:
            data = json.load(f)
        key = {"train": "train", "validation": "validation", "test": "test"}[mode]
        self.tree_paths = data[key]
        missing = [p for p in self.tree_paths if not (self.directory / p).is_file()]
        assert len(missing) == 0, f"Missing {len(missing)} files: {missing[:4]}"
        self._cache = {} if cache else None
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.tree_paths)

    def load(self, idx: int) -> Cloud:
        fname = self.directory / self.tree_paths[idx]
        if self._cache is None:
            return load_cloud(fname)
        if fname not in self._cache:
            self._cache[fname] = load_cloud(fname)
        return self._cache[fname]

    def item(self, idx: int):
        """One voxelised item: (coords [M,3] int32, input [M,Ci],
        target [M,Ct], filename, grid_origin [3])."""
        cld = self.load(idx)
        if self.augmentation is not None:
            # validation and test crops are DETERMINISTIC per item: a fresh
            # per-index rng makes the validation loss comparable across
            # epochs, or best-checkpoint selection and the early stop key on
            # crop luck
            rng = (
                self.rng
                if self.mode == "train"
                else np.random.default_rng(100_003 * (idx + 1))
            )
            cld = self.augmentation(cld, rng)
        assert len(cld) > 0, f"Empty cloud after augmentation: {self.tree_paths[idx]}"
        inputs = np.concatenate([_feature(cld, n) for n in self.input_features], axis=1)
        targets = np.concatenate([_feature(cld, n) for n in self.target_features], axis=1)
        data = np.concatenate([inputs, targets], axis=1)
        coords, data, origin = voxelize_host(
            np.asarray(cld.xyz, np.float32), data, self.voxel_size
        )
        ci = inputs.shape[1]
        return coords, data[:, :ci], data[:, ci:], self.tree_paths[idx], origin

    def batches(
        self, batch_size: int, shuffle: bool = True, capacity: int | None = None
    ) -> Iterator[VoxelBatch]:
        order = np.arange(len(self))
        if shuffle:
            self.rng.shuffle(order)
        for start in range(0, len(order), batch_size):
            idxs = order[start : start + batch_size]
            items = [self.item(i) for i in idxs]
            yield collate(items, batch_size, capacity)


def collate(
    items,
    batch_size: int,
    capacity: int | None = None,
    on_overflow: str = "raise",
    voxel_size: float = 0.0,
) -> VoxelBatch:
    """Stack per-item voxels into one padded batch with a batch-index
    column. Items: (coords, inputs, targets, name[, origin]).

    A fixed `capacity` smaller than the voxel count is an ERROR by default:
    silent truncation would corrupt training targets invisibly. Pass
    on_overflow="warn" (log and truncate; for long unattended runs) or
    "truncate" (silent) to accept dropping the tail instead."""
    total = sum(len(it[0]) for it in items)
    cap = capacity or _ceil_pow2(total)
    if total > cap:
        if on_overflow == "raise":
            raise RuntimeError(
                f"collate overflow: {total} voxels > capacity {cap} "
                f"(items: {[len(it[0]) for it in items]}); raise batch_capacity "
                "or pass on_overflow='truncate'"
            )
        if on_overflow == "warn":
            log.warning(
                "collate overflow: %d voxels > capacity %d, truncating (items %s)",
                total, cap, [len(it[0]) for it in items],
            )
    ci = items[0][1].shape[1]
    ct = items[0][2].shape[1] if items[0][2] is not None else 0
    coords = np.full((cap, 4), -1, np.int32)
    feats = np.zeros((cap, ci), np.float32)
    targets = np.zeros((cap, ct), np.float32) if ct else None
    mask = np.zeros(cap, bool)
    valid = np.zeros(cap, bool)
    row = 0
    max_c = np.zeros(3, np.int64)
    names = []
    origins = np.zeros((batch_size, 3), np.float32)
    have_origins = len(items[0]) > 4
    for b, it in enumerate(items):
        c, f, t, name = it[:4]
        if have_origins:
            origins[b] = it[4]
        names.append(name)
        n = len(c)
        if row + n > cap:
            n = cap - row  # truncate on overflow (callers size the capacity)
        coords[row : row + n, 0] = b
        coords[row : row + n, 1:] = c[:n]
        feats[row : row + n] = f[:n]
        if targets is not None:
            targets[row : row + n] = t[:n]
        mask[row : row + n] = True
        valid[row : row + n] = True
        if n:
            max_c = np.maximum(max_c, c[:n].max(axis=0))
        row += n
    shape = tuple(int(v) + 1 for v in max_c)
    return VoxelBatch(
        origins=origins if have_origins else None,
        voxel_size=voxel_size,
        feats=feats,
        targets=targets,
        coords=coords,
        mask=mask,
        valid=valid,
        spatial_shape=shape,
        batch_size=len(items),
        filenames=tuple(names),
    )


def grid_side(voxel_size: float, block_size: float, buffer_size: float) -> int:
    """The side of the one worst-case grid every block shares (the spatial
    shape only sets the key bit widths)."""
    return int(np.ceil((block_size + 2 * buffer_size) / voxel_size)) + 1


def cloud_arrays(cloud: Cloud) -> Tuple[np.ndarray, np.ndarray]:
    """(xyz, rgb) of a cloud as float32 [N, 3]; rgb zeros where it has none."""
    xyz = np.asarray(cloud.xyz, np.float32)
    rgb = np.asarray(cloud.rgb, np.float32) if cloud.rgb is not None else np.zeros_like(xyz)
    return xyz, rgb


def kept_blocks(xyz: np.ndarray, block_size: float, min_points: int = 20) -> np.ndarray:
    """The cells floor(xyz / block_size) holding more than min_points points,
    int64 [B, 3] in lexicographic order (`native.block_ids`)."""
    cell, cells = native.block_ids(xyz, block_size)
    ids = cells[np.bincount(cell, minlength=len(cells)) > min_points].astype(np.int64)
    return ids[np.lexsort(ids.T[::-1])]


def group_blocks(sizes: np.ndarray, batch_size: int, max_capacity: int | None = None
                 ) -> List[np.ndarray]:
    """The blocks of each batch, in slot order: greedy over the blocks sorted
    by voxel count (`sizes`), a batch closing at `batch_size` blocks or
    early when the next block would push its pow2 capacity past
    max_capacity (a single larger block ships alone)."""
    out: List[np.ndarray] = []
    chunk: List[int] = []
    total = 0
    for i in np.argsort(sizes):
        n = int(sizes[i])
        over = max_capacity is not None and chunk and _ceil_pow2(total + n) > max_capacity
        if len(chunk) == batch_size or over:
            out.append(np.asarray(chunk, np.int64))
            chunk, total = [], 0
        chunk.append(int(i))
        total += n
    if chunk:
        out.append(np.asarray(chunk, np.int64))
    return out


@dataclass
class Block:
    coords: np.ndarray     # [M,3] voxel coords (block-local grid)
    feats: np.ndarray      # [M,6] xyz+rgb of the surviving point
    interior: np.ndarray   # [M] bool: point inside the un-buffered cube
    spatial_shape: Tuple[int, int, int]
    origin: np.ndarray     # [3] f32 block grid origin


class BlockTiler:
    """Spatial tiling with halos into bucketed padded batches. The halos come
    from one pass over the points (`native.tile_blocks`; `box_tests` is the
    number of point-box tests it made). Each block is voxelised by `dedup`
    (`voxelize_host`; a subclass may name `voxelize_host_plain` to time the
    numpy version)."""

    dedup = staticmethod(voxelize_host)

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
        side = grid_side(voxel_size, block_size, buffer_size)
        self.grid_shape = (side, side, side)
        xyz, rgb = cloud_arrays(cloud)
        ids = kept_blocks(xyz, block_size, min_points)
        self.block_centres = ids * block_size + block_size / 2

        # every block's halo rows in one pass over the points
        offsets, rows, inside, self.box_tests = native.tile_blocks(
            xyz, ids, block_size, buffer_size)
        xyzrgb = np.concatenate([xyz, rgb], axis=1)
        self.blocks: List[Block] = []
        for lo, hi in zip(offsets[:-1], offsets[1:]):
            halo = rows[lo:hi]
            # the dedup gathers its `data` argument by the surviving rows:
            # given halo positions it returns them, so only the survivors'
            # features are gathered (np.take: a row gather at a fraction of
            # fancy indexing's cost)
            coords, first, origin = self.dedup(
                np.take(xyz, halo, axis=0), np.arange(hi - lo), voxel_size)
            shape = tuple(int(v) + 1 for v in coords.max(axis=0))
            self.blocks.append(Block(coords, np.take(xyzrgb, halo[first], axis=0),
                                     inside[lo:hi][first], shape, origin))

    def __len__(self):
        return len(self.blocks)

    def batches(
        self, batch_size: int = 4, max_capacity: int | None = None
    ) -> Iterator[VoxelBatch]:
        """Greedy size-bucketed batches of blocks (`group_blocks`), each
        collated when the generator reaches it."""
        sizes = np.asarray([len(b.coords) for b in self.blocks], np.int64)
        for chunk in group_blocks(sizes, batch_size, max_capacity):
            yield collate_blocks([self.blocks[i] for i in chunk], batch_size, self.grid_shape,
                                 self.voxel_size)


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


def halve_batch(vb: VoxelBatch) -> Tuple[VoxelBatch, VoxelBatch] | None:
    """A block batch split into two padded pow2 batches of the first and the
    last half of its blocks (rows, batch indices and origins unchanged);
    None for a batch of one block."""
    n = vb.n_valid
    items = vb.coords[:n, 0]
    blocks = np.unique(items)
    if len(blocks) < 2:
        return None
    first = items < blocks[len(blocks) // 2]
    halves = []
    for rows in (np.flatnonzero(first), np.flatnonzero(~first)):
        cap = _ceil_pow2(len(rows))
        coords = np.full((cap, 4), -1, np.int32)
        feats = np.zeros((cap, vb.feats.shape[1]), np.float32)
        mask = np.zeros(cap, bool)
        valid = np.zeros(cap, bool)
        coords[: len(rows)] = vb.coords[rows]
        feats[: len(rows)] = vb.feats[rows]
        mask[: len(rows)] = vb.mask[rows]
        valid[: len(rows)] = True
        halves.append(vb._replace(feats=feats, coords=coords, mask=mask, valid=valid))
    return tuple(halves)
