"""Model inference: block-tiled, bucketed sparse-UNet forward.

Counterpart of `smart_tree_tpu/infer/inference.py::ModelInference` on one
device. `forward` tiles each cloud on the device (core/tiler.py, the
kernels of csrc/tiler.cu on a card): the cloud's xyz goes up once, the
halo binning, voxel dedup and each block's key order run there, and the
host reads two headers of counts, groups the blocks into batches as the
JAX package does and uploads each batch's slot table. One gather a batch
writes its sorted input: the int64 keys of its voxels (no device sort), the
residuals the JAX package's compact upload carries (int8 for absolute-xyz
models, fp16 for 'local' ones), the interior flags and each row's point
index. The device unpacks coords from the keys, runs the plan and the
network, quantises the heads (`compress_preds`) and partitions the rows, so
that only the interior rows' int8 class and int32 point index and the
medial-class rows' fp16 radius and int8 direction come back, the JAX
package's download cull. The host takes the interior rows' xyz and rgb from
the cloud by those indices. With `medial_classes` rows of any other class
get medial_vector = 0; without it every class is medial. The rows, their
order and every value are those of the host tiling's compact transfers
(`BlockTiler`, `VoxelBatch.key_order` and `_stage_sorted`), which
`predict()`, training and the tests keep.

`predict()` is the full-precision path, for inspection: the host tiler's
batches, int16 coords and fp16 residuals of the valid rows up, device sort,
fp32 heads and the sort order back.

With more than one device (`devices=`, by default every visible card, as
the JAX package takes `jax.devices()`) and more than one batch, `forward`
and `predict` deal the batches to the devices as the JAX package's
multichip path does (`_submit_multi_device`, parallel/block_infer.py):
grouped by shape in sorted order, `len(devices)` at a time, every batch of a
group launched on its own device's replica before the group is collected,
so the rows come back in the JAX package's multichip order.

Plans are exact (core/plan.py): level 0 holds the batch's active rows and
each level below exactly its voxels, one host read of each count, so no
level is padded and none can overflow; every batch takes one UNet pass.
The plan is held to the budget before the UNet is queued: where the
footprint model at the plan's level sizes passes `hbm_budget_bytes`, the
batch is split into two halves of its blocks (`TileBatch.halves`, as
`data/dataset.py::halve_batch` splits `predict()`'s; a half takes its rows
of the gathered input), each planned afresh; a single block past the budget runs,
with a warning. (The JAX package pads each level to a fixed share of the
one above and reruns an overflowed batch at larger capacities, so that
`jit` compiles one program per shape; the port runs eagerly.)

`max_in_flight` batches are queued before the host collects the oldest: the
run half of either path only queues work (pinned uploads, the gather, a
device-side partition, downloads into pinned buffers on a copy stream that
waits for an event of its own batch), and the host waits for that batch's event only, so
collecting batch i overlaps batch i+1 on the card. On a card each in-flight
slot queues on a stream of its own, so that the count reads of a batch's
plan wait for that slot's last batch, already collected, and not for the
batches still in flight.

Batches are sized against `hbm_budget_bytes` (core/memory.py): the largest
pow2 batch capacity whose estimated forward peak at level capacity factor
1.0 fits it, as in the JAX package, and every exact plan is held to it
(above). By default (`None`) the budget is 0.75 of the card's total memory,
split between the replicas that share a card, and the model counts the
port's own footprint terms; on the CPU both are the JAX package's (12 GiB),
so that the CPU splits a cloud into the reference's batches.

The network is the one its checkpoint names (nn/convert.py::load_model):
SmartTree, or Point Transformer V3 (nn/ptv3.py). Either gives its own plan
(`build_plan`), footprint (`forward_peak`, `max_batch_capacity`) and heads,
so the transfers, the windowing and the budget serve both alike.

The forward runs eagerly; `precision` ("float32" or "bfloat16") reaches
every conv as an argument (core/sparse_ops.py). With `fused=True` the convs
take the fused gather-GEMM kernel, like the JAX package under
SMART_TREE_TPU_PALLAS=1.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import logging
from pathlib import Path
from typing import Dict, Sequence

import numpy as np
import torch

from ..core import tiler
from ..core.coords import INVALID_KEY, pack_coords, pack_coords_np, sort_keys, unpack_keys
from ..core.memory import device_budget_bytes, footprint_terms
from ..core.sparse_ops import ConvConfig
from ..core.sparse_tensor import SparseVoxelTensor
from ..data.cloud import Cloud
from ..data.dataset import BlockTiler, halve_batch, stage_rows
from ..device import resolve_device
from ..nn.convert import load_model, load_weights
from ..utils.trace import count, span

log = logging.getLogger(__name__)


def compress_preds(preds: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The download payload: fp16 radius, the unit direction in int8 steps
    of 1/127 (round, clipped to +-127) and the argmax class as int8."""
    q = torch.clamp(torch.round(preds["direction"].float() * 127.0), -127, 127)
    return {
        "radius": preds["radius"].to(torch.float16),
        "direction": q.to(torch.int8),
        "class_l": torch.argmax(preds["class_l"], dim=1).to(torch.int8),
    }


def decode_direction(q: np.ndarray) -> np.ndarray:
    """Host inverse of compress_preds' int8 direction: dequantise and
    renormalise onto the unit sphere."""
    d = np.asarray(q, np.float32) / 127.0
    n = np.linalg.norm(d, axis=-1, keepdims=True)
    return d / np.maximum(n, 1e-8)


def _features(coords, res16, origins, voxel_size: float, mode: str):
    """Input features from int32 coords [N,4] (b,x,y,z), fp16 residuals from
    the voxel centres and per-item fp32 grid origins: "xyz" (absolute
    coordinates, 3 channels) or "local" (residual / voxel_size and absolute
    y, 4 channels)."""
    bi = coords[:, 0].clamp(0, origins.shape[0] - 1).long()
    centre = origins[bi] + (coords[:, 1:].to(torch.float32) + 0.5) * voxel_size
    xyz = centre + res16.to(torch.float32)
    if mode == "local":
        return torch.cat([res16.to(torch.float32) / voxel_size, xyz[:, 1:2]], dim=1)
    return xyz


def make_features(coords16, res16, origins, voxel_size: float, mode: str):
    """(int32 coords, features) from the full-download upload
    (VoxelBatch.compressed_xyz_upload)."""
    coords = coords16.to(torch.int32)
    return coords, _features(coords, res16, origins, voxel_size, mode)


class _Download:
    """Device -> host copies queued now and read later. On a card they go
    into pinned buffers on `stream` after the event `ready`, so that reading
    them waits for this batch's work and copies only, never for batches
    queued behind it; on the CPU the tensors are the result."""

    def __init__(self, tensors, stream=None, ready=None):
        self.done = None
        self.ready = ready
        if stream is None:
            self.arrays = [t.numpy() for t in tensors]
            return
        self.arrays = []
        with torch.cuda.stream(stream):
            stream.wait_event(ready)
            for t in tensors:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                buf.copy_(t, non_blocking=True)
                t.record_stream(stream)
                self.arrays.append(buf)
            self.done = torch.cuda.Event()
            self.done.record(stream)

    def get(self) -> list:
        if self.done is None:
            return self.arrays
        self.done.synchronize()
        return [b.numpy() for b in self.arrays]


class _Split:
    """What a run half returns for a batch whose plan passed the budget: the
    queued halves, each (half batch, its own run half's result)."""

    def __init__(self, parts):
        self.parts = parts


def _collect_half(read):
    """A collect half from `read(self, vb, out, sinks)`: a `_Split`'s halves
    in turn, any other batch read inside the `infer.collect` span."""

    @functools.wraps(read)
    def collect(self, vb, out, sinks):
        if isinstance(out, _Split):
            for half, part in out.parts:
                collect(self, half, part, sinks)
            return
        with span(self._stats, "infer.collect", "infer.collect_s"):
            read(self, vb, out, sinks)

    return collect


def _collated(batches, stats):
    """The tiler's batches, each step of its generator (`collate_blocks`)
    inside the `infer.collate` span."""
    while True:
        with span(stats, "infer.collate", "infer.collate_s"):
            vb = next(batches, None)
        if vb is None:
            return
        yield vb


class ModelInference:
    def __init__(
        self,
        weights_path: str | Path,
        voxel_size: float = 0.01,
        block_size: float = 4.0,
        buffer_size: float = 0.4,
        batch_size: int = 4,
        precision: str = "float32",
        model_path: str | Path | None = None,  # reference-config compatibility (unused)
        num_workers: int = 0,  # reference-config compatibility (unused)
        max_in_flight: int = 2,
        hbm_budget_bytes: int | None = None,
        upload_granularity: int = 4096,
        medial_classes: Sequence[int] | None = None,
        fused: bool = False,
        device: str | torch.device | None = None,
        devices: Sequence[str | torch.device] | None = None,
    ):
        if device is not None and devices is not None:
            raise ValueError("give `device` or `devices`, not both")
        if devices is None:
            from ..parallel.mesh import make_devices

            devices = make_devices() if device is None and torch.cuda.is_available() \
                else [device]
        if not devices:
            raise ValueError("`devices` is empty")
        self.devices = [resolve_device(d) for d in devices]  # TF32 off on a card
        self.device = self.devices[0]
        # classes whose medial vector later stages consume; None (or an empty
        # sequence) keeps every row's
        self.medial_classes = (
            tuple(int(c) for c in medial_classes) if medial_classes else None
        )
        self.voxel_size = voxel_size
        self.block_size = block_size
        self.buffer_size = buffer_size
        self.batch_size = batch_size
        ConvConfig(precision)  # validates the name
        self.precision = precision
        self.fused = fused
        self.max_in_flight = max_in_flight
        self.hbm_budget_bytes = (device_budget_bytes(self.devices) if hbm_budget_bytes is None
                                 else hbm_budget_bytes)
        self.upload_granularity = upload_granularity
        self.model = load_model(load_weights(weights_path), self.device)
        self.feature_mode = "local" if self.model.input_channels == 4 else "xyz"
        # absolute-xyz models take int8 residuals on the compact upload;
        # 'local' models divide residuals by the voxel size and keep fp16
        self.res_dtype = np.float16 if self.feature_mode == "local" else np.int8
        # the largest pow2 batch capacity whose estimated forward peak fits
        # the budget at factor 1.0 (every level as large as the batch) with
        # max_in_flight batches queued, as in the JAX package; on a card the
        # model counts the port's own footprint terms. An exact plan's levels
        # can be larger still: `_halves` holds them to the same budget
        self.footprint_terms = footprint_terms(self.devices)
        self.max_batch_capacity = self.model.max_batch_capacity(
            self.hbm_budget_bytes, in_flight=max(1, max_in_flight), **self.footprint_terms)
        # running totals of the bytes each forward moved over the link; the
        # caller reads and resets them
        self.link_bytes = {"upload": 0, "download": 0}
        # the level rows of every plan the last forward ran, one tuple per
        # UNet pass (`_unet`)
        self.plan_rows: list = []
        self._copy_stream = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        )
        self._streams: list = []  # the in-flight slots' streams (`_slot`)
        self._sharded = None  # parallel.ShardedForward, made at first use
        # the `stats` of the forward in progress, which the run and collect
        # halves (and the replicas, shallow copies) add their spans to
        self._stats = None

    # -- transfers ---------------------------------------------------------

    def _upload(self, *arrays, device=None):
        """Host arrays to `device` (this replica's by default). On a card
        from pinned memory without waiting: the copy is ordered on the
        current stream."""
        device = self.device if device is None else device
        out = []
        with span(self._stats, "infer.upload", "infer.upload_s"):
            for a in arrays:
                t = torch.from_numpy(np.ascontiguousarray(a))
                self.link_bytes["upload"] += t.nbytes
                if device.type == "cuda":
                    t = t.pin_memory().to(device, non_blocking=True)
                out.append(t)
        return out

    def _download(self, tensors, ready=None) -> _Download:
        """Queue the download of `tensors` after `ready`, by default an event
        recorded now on the current stream, after the kernels that wrote them
        (the download keeps it as `.ready` for later downloads of the same
        batch)."""
        self.link_bytes["download"] += sum(t.nbytes for t in tensors)
        if self._copy_stream is not None and ready is None:
            ready = torch.cuda.Event()
            ready.record()
        return _Download(tensors, self._copy_stream, ready)

    def _slot(self, i: int):
        """The stream context batch i of a window is queued in: on a card, one
        stream for each of the `max_in_flight` slots, so that the host reads
        of a plan's level counts wait for the work queued before them on
        that slot, the batch collected last, and not for the batches still
        in flight; nothing on the CPU."""
        if self._copy_stream is None:
            return contextlib.nullcontext()
        k = max(1, self.max_in_flight)
        while len(self._streams) < k:
            self._streams.append(torch.cuda.Stream(self.device))
        return torch.cuda.stream(self._streams[i % k])

    # -- planning --------------------------------------------------------------

    def _plan(self, x):
        """The model's exact plan of `x` (level 0 is x's rows)."""
        return self.model.build_plan(x, level_capacity_factor=None, stats=self._stats)

    def _halves(self, plan, split):
        """None where the plan's modelled peak (core/memory.py at its level
        rows, max_in_flight batches in flight) fits the budget; else
        `split()`, the two halves of the batch's blocks, planned afresh by
        the caller. A single block past the budget runs (None), with a
        warning."""
        rows = tuple(lv.keys.shape[0] for lv in plan.levels)
        peak = self.model.forward_peak(rows, in_flight=max(1, self.max_in_flight),
                                       **self.footprint_terms)
        if peak <= self.hbm_budget_bytes:
            return None
        halves = split()
        if halves is None:
            log.warning("a one-block batch with levels of %s rows passes the budget of %d "
                        "bytes in the footprint model", rows, self.hbm_budget_bytes)
        return halves

    def _unet(self, x, plan):
        """The model on one planned batch (one UNet pass): the fp32-or-bf16
        heads; the plan's `counters` (a PTv3's), if any, go to `stats`."""
        self.plan_rows.append(tuple(lv.keys.shape[0] for lv in plan.levels))
        for key, n in getattr(plan, "counters", {}).items():
            count(self._stats, key, n)
        cfg = ConvConfig(self.precision, fused=self.fused)
        return self.model(plan, x.feats, cfg)

    # -- the full-download path (predict) ------------------------------------

    def _plan_batch(self, vb):
        """Upload one batch's valid rows (int16 coords, fp16 residuals,
        origins) and build its sorted input tensor of the active rows alone
        and its exact plan on the device: (x, plan, order)."""
        n_valid = vb.n_valid
        with span(self._stats, "infer.pack", "infer.pack_s"):
            c16, res, orig = vb.compressed_xyz_upload()
        c16, res, orig = self._upload(c16[:n_valid], res[:n_valid], orig)
        with span(self._stats, "infer.plan", "infer.plan_s"):
            coords, fv = make_features(c16, res, orig, self.voxel_size, self.feature_mode)
            keys = pack_coords(coords, vb.spatial_shape, vb.batch_size)
            n_act = int(np.count_nonzero(pack_coords_np(
                vb.coords[:n_valid], vb.spatial_shape, vb.batch_size) != INVALID_KEY))
            skeys, order = sort_keys(keys)
            skeys, order = skeys[:n_act], order[:n_act]   # the active rows sort first
            x = SparseVoxelTensor(skeys, fv[order], skeys != INVALID_KEY,
                                  tuple(vb.spatial_shape), vb.batch_size)
            return x, self._plan(x), order

    @torch.no_grad()
    def _run_batch(self, vb):
        """Queue one full-download batch: the download of the sort order and
        the fp32 heads (or a `_Split`)."""
        x, plan, order = self._plan_batch(vb)
        with span(self._stats, "infer.plan", "infer.plan_s"):
            halves = self._halves(plan, lambda: halve_batch(vb))
        if halves is not None:
            del x, plan, order
            return _Split([(half, self._run_batch(half)) for half in halves])
        with span(self._stats, "infer.unet", "infer.unet_s"):
            preds = self._unet(x, plan)
            heads = [preds[k].float() for k in ("radius", "direction", "class_l")]
            return self._download([order, *heads])

    @_collect_half
    def _collect(self, vb, out, sinks):
        """Read one full-download batch into the sinks (xyzrgb, radius,
        direction, class logits)."""
        order, radius, direction, logits = out.get()
        keep = vb.mask[order]
        out_xyzrgb, out_radius, out_dir, out_class = sinks
        out_xyzrgb.append(vb.feats[order[keep]][:, :6])
        out_radius.append(radius[keep])
        out_dir.append(direction[keep])
        out_class.append(logits[keep])

    # -- the forward's path ------------------------------------------------

    def _pad_sorted(self, skeys, res, rows: int):
        """Sorted keys and residuals on the device at `rows` rows: the keys
        (int64, or the int32 bit patterns of the JAX package's staged upload)
        as the int64-held uint32 keys, int8 residuals dequantised to fp16 as
        the JAX package does; rows past the given ones hold INVALID_KEY
        (sorts last, reads inactive) and zero residuals. The forward takes
        the active rows (rows = the gathered rows); the JAX package pads to
        the batch capacity."""
        k = min(skeys.shape[0], rows)
        keys = torch.full((rows,), INVALID_KEY, dtype=torch.int64, device=skeys.device)
        keys[:k] = skeys[:k].to(torch.int64) & 0xFFFFFFFF
        if res.dtype == torch.int8:
            res = (res.to(torch.float32) * (self.voxel_size / 254.0)).to(torch.float16)
        r = torch.zeros((rows, 3), dtype=torch.float16, device=skeys.device)
        r[:k] = res[:k]
        return keys, r

    def _sorted_input(self, vb, n_act: int, skeys, res, origins):
        """The input tensor of sorted keys and residuals (a batch's gather,
        core/tiler.py): its n_act active rows; the keys are in sort order,
        so coords come from `unpack_keys` and there is no device sort."""
        keys, r = self._pad_sorted(skeys, res, n_act)
        active = keys != INVALID_KEY
        coords = unpack_keys(keys, vb.spatial_shape, vb.batch_size)
        fv = _features(coords, r, origins, self.voxel_size, self.feature_mode)
        feats = torch.where(active[:, None], fv, 0.0)
        return SparseVoxelTensor(keys, feats, active, tuple(vb.spatial_shape), vb.batch_size)

    def _partition(self, preds, active, interior, index):
        """The download cull on the device: class rows and the rows' point
        indices permuted interior-first, radius / direction rows (interior
        and medial class)-first, each by a stable sort on the complement so
        kept rows keep their key order, and the medial count. Without
        `medial_classes` every interior row is medial: one permutation."""
        keep_i = active & interior
        cls = preds["class_l"]
        perm_i = torch.sort((~keep_i).to(torch.uint8), stable=True).indices
        keep_m, perm_m = keep_i, perm_i
        if self.medial_classes is not None:
            keep_m = keep_i & functools.reduce(torch.logical_or,
                                               [cls == c for c in self.medial_classes])
            perm_m = torch.sort((~keep_m).to(torch.uint8), stable=True).indices
        return (cls[perm_i], index[perm_i], preds["radius"][perm_m], preds["direction"][perm_m],
                keep_m.sum(dtype=torch.int64))

    def _gathered(self, vb):
        """A batch's inputs (core/tiler.py `gather`) on this replica's
        device: its slot table up, then one gather on the tiling's device,
        copied over where the replica's card is another; a half takes its
        rows of the inputs its batch gathered."""
        if vb.inputs is None:
            dev = vb.tiling.device
            (table,) = self._upload(vb.table(), device=dev)
            with span(self._stats, "infer.pack", "infer.pack_s"):
                inputs = tiler.gather(vb, table, self.res_dtype == np.int8)
                if dev != self.device:
                    inputs = tuple(t.to(self.device, non_blocking=True) for t in inputs)
                vb.inputs = inputs
        return vb.part()

    @torch.no_grad()
    def _run_batch_culled(self, vb):
        """Queue one batch of the device tiling (a core/tiler.py
        `TileBatch`): (download of the medial count; the partitioned class,
        point index, radius and direction on the device), or a `_Split`."""
        keys, res, interior, index, origins = self._gathered(vb)
        with span(self._stats, "infer.plan", "infer.plan_s"):
            x = self._sorted_input(vb, vb.rows, keys, res, origins)
            plan = self._plan(x)
            halves = self._halves(plan, vb.halves)
        if halves is not None:
            del x, plan
            return _Split([(half, self._run_batch_culled(half)) for half in halves])
        with span(self._stats, "infer.unet", "infer.unet_s"):
            preds = compress_preds(self._unet(x, plan))
            *culled, n_med = self._partition(preds, x.active, interior, index)
            # the medial count comes back alone; the downloads are sliced to
            # it in _collect_culled
            return self._download([n_med[None]]), culled

    @_collect_half
    def _collect_culled(self, vb, out, sinks):
        """Read one batch into the sinks. The interior rows come back in the
        device's key order with their point indices, whose xyz and rgb the
        host takes from the cloud it holds; the radius / direction download
        covers exactly the medial interior rows (the host finds them among
        the downloaded classes); the other interior rows get medial_vector
        = 0."""
        small, (cls_p, idx_p, rad_p, dir_p) = out
        m = int(small.get()[0][0])
        n_i = vb.n_interior      # the device's keep_i
        if n_i == 0:
            return
        cap = vb.capacity
        g = self.upload_granularity
        ni_stage, m_stage = stage_rows(n_i, cap, g), stage_rows(m, cap, g)
        cls_s, idx_s, r_s, d_s = self._download(
            [cls_p[:ni_stage], idx_p[:ni_stage], rad_p[:m_stage], dir_p[:m_stage]],
            small.ready).get()
        cls = cls_s[:n_i]
        med = (np.ones(n_i, bool) if self.medial_classes is None
               else np.isin(cls, np.asarray(self.medial_classes, cls.dtype)))
        if m != int(med.sum()):
            raise RuntimeError(
                f"download cull: the device counted {m} medial rows, the host "
                f"{int(med.sum())} among the downloaded classes")
        radius = np.zeros((n_i, 1), np.float32)
        direction = np.zeros((n_i, 3), np.float32)
        pos = np.flatnonzero(med)
        radius[pos] = r_s[:m].astype(np.float32)
        direction[pos] = decode_direction(d_s[:m])
        rows = idx_s[:n_i]
        t = vb.tiling
        out_xyzrgb, out_radius, out_dir, out_class = sinks
        out_xyzrgb.append(np.concatenate([np.take(t.xyz, rows, axis=0),
                                          np.take(t.rgb, rows, axis=0)], axis=1))
        out_radius.append(radius)
        out_dir.append(direction)
        out_class.append(cls)

    # -- entry points --------------------------------------------------------

    def _tile_batches(self, cloud: Cloud, stats=None) -> list:
        """The forward's batches: the cloud tiled on the device
        (core/tiler.py, inside `infer.tile`), then its blocks grouped on the
        host (inside `infer.collate`)."""
        with span(stats, "infer.tile", "infer.tile_s"):
            tiling = tiler.tile_cloud(cloud, self.voxel_size, self.block_size, self.buffer_size,
                                      self.device, stats=stats)
            self.link_bytes["upload"] += tiling.upload_bytes
        with span(stats, "infer.collate", "infer.collate_s"):
            return tiling.batches(self.batch_size, self.max_batch_capacity)

    def _windowed(self, batches, run: str, collect: str, stats):
        """Run every batch through the halves named `run` and `collect`: the
        sinks. On one device at most max_in_flight batches are queued ahead
        of the one being collected; on several, with more than one batch,
        `_submit_multi_device` deals them out."""
        sinks = ([], [], [], [])
        self.plan_rows = []
        self._stats = stats
        try:
            if len(self.devices) > 1:
                batches = list(batches)
                if len(batches) > 1:
                    self._submit_multi_device(batches, run, collect, sinks)
                    return sinks
            run, collect = getattr(self, run), getattr(self, collect)
            window: list = []
            for i, vb in enumerate(batches):
                with self._slot(i):
                    window.append((vb, run(vb)))
                if len(window) >= max(1, self.max_in_flight):
                    collect(*window.pop(0), sinks)
            for vb, out in window:
                collect(vb, out, sinks)
            return sinks
        finally:
            self._stats = None

    def _submit_multi_device(self, batches, run: str, collect: str, sinks) -> None:
        """The JAX package's `_submit_multichip`: batches grouped by (capacity,
        spatial shape, batch size) in sorted order, each group dealt
        len(devices) at a time, one batch to each device's replica; a group
        is launched whole, then collected in device order. Repeat slots of a
        short group are not run."""
        from ..parallel.block_infer import ShardedForward, device_groups

        if self._sharded is None:
            self._sharded = ShardedForward(self, self.devices)
        replicas = self._sharded.replicas(self)
        keyf = lambda vb: (vb.capacity, vb.spatial_shape, vb.batch_size)  # noqa: E731
        for _, group in itertools.groupby(sorted(batches, key=keyf), key=keyf):
            for chunk, keep in device_groups(list(group), len(replicas)):
                launched = ShardedForward.launch(replicas, chunk, keep, run)
                ShardedForward.collect(launched, collect, sinks)

    def predict(self, cloud: Cloud, stats: dict | None = None) -> Dict[str, np.ndarray]:
        """Per-voxel predictions at full precision for the interior voxels of
        every block, through the full-download path: xyz, rgb, radius [n,1]
        (log radius), direction [n,3], class_logits. `stats` as for
        `forward`."""
        with span(stats, "infer.tile", "infer.tile_s"):
            tiling = BlockTiler(cloud, self.voxel_size, self.block_size, self.buffer_size)
            count(stats, "tile_box_tests", tiling.box_tests)
        batches = _collated(tiling.batches(self.batch_size, max_capacity=self.max_batch_capacity),
                            stats)
        out_xyzrgb, out_radius, out_dir, out_class = self._windowed(
            batches, "_run_batch", "_collect", stats)
        with span(stats, "infer.collect", "infer.collect_s"):
            if not out_xyzrgb:
                z = np.zeros((0, 3), np.float32)
                return {"xyz": z, "rgb": z, "radius": np.zeros((0, 1), np.float32),
                        "direction": z, "class_logits": np.zeros((0, 2), np.float32)}
            xyzrgb = np.concatenate(out_xyzrgb)
            return {
                "xyz": xyzrgb[:, :3],
                "rgb": xyzrgb[:, 3:6],
                "radius": np.concatenate(out_radius),
                "direction": np.concatenate(out_dir),
                "class_logits": np.concatenate(out_class),
            }

    def forward(self, cloud: Cloud, return_masked: bool = True,
                stats: dict | None = None) -> Cloud:
        """Cloud of interior voxels with the argmax class and medial_vector
        = exp(radius) * direction from the quantised heads (module
        docstring); with `medial_classes`, rows of any other class have
        medial_vector = 0. `return_masked` is accepted
        for the JAX signature and, as there, unused.

        `stats`, when given, receives the host seconds of the forward's
        stages, which follow one another and do not nest (utils/trace.py):
        `infer.tile_s` (core/tiler.py: the cloud's upload, the kept blocks
        on the host, the tiler's kernels and its two reads; the counters
        `tile_box_tests`, the binning's point-box tests, and
        `tile_fetches`, those reads), `infer.collate_s` (the host's
        grouping of blocks into batches), `infer.upload_s` (each batch's
        slot table), `infer.pack_s` (queueing each batch's gather),
        `infer.plan_s` (input tensors, exact plans with their count reads,
        the budget check), `infer.unet_s` (queueing the UNet, the download
        cull and the downloads) and `infer.collect_s` (the waits for each
        batch and the host decode). `predict` fills the same keys from the
        host tiler's stages, without `tile_fetches`. A PTv3 adds
        `infer.serialize_s` (its plans' offsets reads, codes, orders and
        patch indices, inside `infer.plan_s`), the counters `attn_patches`
        and `attn_pad_rows` (patches attended, rows its padding repeated,
        summed over the blocks) and, while the profiler records, a range
        `infer.attention` around each block's attention."""
        with span(stats, "infer.forward"):
            out_xyzrgb, out_radius, out_dir, out_class = self._windowed(
                self._tile_batches(cloud, stats), "_run_batch_culled", "_collect_culled", stats)
            with span(stats, "infer.collect", "infer.collect_s"):
                if not out_xyzrgb:  # too sparse to form any block
                    z = np.zeros((0, 3), np.float32)
                    return Cloud(xyz=z, rgb=z, medial_vector=z,
                                 class_l=np.zeros((0, 1), np.float32), filename=cloud.filename)
                xyzrgb = np.concatenate(out_xyzrgb)
                medial_vector = np.exp(np.concatenate(out_radius)) * np.concatenate(out_dir)
                cls = np.concatenate(out_class)
                return Cloud(
                    xyz=xyzrgb[:, :3],
                    rgb=xyzrgb[:, 3:6],
                    medial_vector=medial_vector,
                    class_l=cls.reshape(-1, 1).astype(np.float32),
                    filename=cloud.filename,
                )
