"""Model inference: block-tiled, bucketed sparse-UNet forward.

Counterpart of `smart_tree_tpu/infer/inference.py::ModelInference` on one
device, with its three transfer modes:

  compact + culled  (`compact_transfers=True` and `medial_classes`, the
      default configuration): each batch uploads host-sorted packed keys
      (int32 bit patterns of the uint32 keys, 4 B a voxel), int8 residuals
      for absolute-xyz models (fp16 for 'local' ones) and the interior mask
      as bits, only the rows that hold a voxel (staged to
      `upload_granularity`); the device keeps their active prefix, unpacks
      coords from the keys (no device sort), runs the plan and SmartTree,
      quantises the heads (`compress_preds`) and partitions the rows, so
      that only the interior rows' int8 class and the medial-class rows'
      fp16 radius and int8 direction come back. Rows of any other class get
      medial_vector = 0.
  compact  (`compact_transfers=True`, `medial_classes=None`): the same
      upload; every active row's quantised heads come back.
  full download  (`compact_transfers=False`): int16 coords and fp16
      residuals of the valid rows up, device sort, fp32 heads and the sort
      order back; the class filter of `medial_classes` is applied on the
      host.
      `predict()` always takes this path: full-precision heads for
      inspection (the JAX package quantises this path too).

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
batch is split into two halves of its blocks (`data/dataset.py::
halve_batch`), each planned afresh; a single block past the budget runs,
with a warning. (The JAX package pads each level to a fixed share of the
one above and reruns an overflowed batch at larger capacities, so that
`jit` compiles one program per shape; the port runs eagerly.)

`max_in_flight` batches are queued before the host collects the oldest: the
run half of every mode only queues work (pinned uploads, a device-side
partition, downloads into pinned buffers on a copy stream that waits for an
event of its own batch), and the host waits for that batch's event only, so
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

from ..core.coords import INVALID_KEY, pack_coords, pack_coords_np, sort_keys, unpack_keys
from ..core.memory import (
    device_budget_bytes,
    estimate_forward_hbm,
    footprint_terms,
    max_capacity_for_budget,
)
from ..core.plan import build_plan
from ..core.sparse_ops import ConvConfig
from ..core.sparse_tensor import SparseVoxelTensor
from ..data.cloud import Cloud
from ..data.dataset import BlockTiler, halve_batch, stage_rows
from ..device import resolve_device
from ..nn.convert import load_model, load_weights

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


def _unpack_bits(bits: torch.Tensor, count: int) -> torch.Tensor:
    """np.unpackbits(bits, count=count) as a bool tensor (big-endian bits)."""
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=bits.device)
    return ((bits.to(torch.int32)[:, None] >> shifts) & 1).reshape(-1)[:count].bool()


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

    def collect(self, collect, sinks) -> None:
        for half, out in self.parts:
            collect(half, out, sinks)


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
        level_capacity_factor: float = 0.5,  # the JAX keyword (unused: plans are exact)
        max_in_flight: int = 2,
        hbm_budget_bytes: int | None = None,
        compact_transfers: bool = True,
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
        self.compact_transfers = compact_transfers
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
        self.max_batch_capacity = max_capacity_for_budget(
            self.hbm_budget_bytes,
            self.model.unet_planes,
            factor=1.0,
            in_flight=max(1, max_in_flight),
            **self.footprint_terms,
        )
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

    # -- transfers ---------------------------------------------------------

    def _upload(self, *arrays):
        """Host arrays to the device. On a card from pinned memory without
        waiting: the copy is ordered on the current stream."""
        out = []
        for a in arrays:
            t = torch.from_numpy(np.ascontiguousarray(a))
            self.link_bytes["upload"] += t.nbytes
            if self._copy_stream is not None:
                t = t.pin_memory().to(self.device, non_blocking=True)
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
        """The exact plan of `x` (level 0 is x's rows)."""
        return build_plan(x, len(self.model.unet_planes), level_capacity_factor=None)

    def _halves(self, vb, plan):
        """None where the plan's modelled peak (core/memory.py at its level
        rows, max_in_flight batches in flight) fits the budget; else the two
        halves of vb's blocks, planned afresh by the caller. A single block
        past the budget runs (None), with a warning."""
        rows = tuple(lv.keys.shape[0] for lv in plan.levels)
        est = estimate_forward_hbm(rows[0], self.model.unet_planes,
                                   in_flight=max(1, self.max_in_flight), level_caps=rows,
                                   **self.footprint_terms)
        if est["peak"] <= self.hbm_budget_bytes:
            return None
        halves = halve_batch(vb)
        if halves is None:
            log.warning("a one-block batch with levels of %s rows passes the budget of %d "
                        "bytes in the footprint model", rows, self.hbm_budget_bytes)
        return halves

    def _unet(self, x, plan):
        """SmartTree on one planned batch (one UNet pass): the fp32-or-bf16
        heads."""
        self.plan_rows.append(tuple(lv.keys.shape[0] for lv in plan.levels))
        cfg = ConvConfig(self.precision, fused=self.fused)
        return self.model(plan, x.feats, cfg)

    # -- the full-download path ----------------------------------------------

    def _plan_batch(self, vb):
        """Upload one batch's valid rows (int16 coords, fp16 residuals,
        origins) and build its sorted input tensor of the active rows alone
        and its exact plan on the device: (x, plan, order)."""
        n_valid = vb.n_valid
        c16, res, orig = vb.compressed_xyz_upload()
        c16, res, orig = self._upload(c16[:n_valid], res[:n_valid], orig)
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
        halves = self._halves(vb, plan)
        if halves is not None:
            del x, plan, order
            return _Split([(half, self._run_batch(half)) for half in halves])
        preds = self._unet(x, plan)
        heads = [preds[k].float() for k in ("radius", "direction", "class_l")]
        return self._download([order, *heads])

    def _collect(self, vb, out, sinks):
        """Read one full-download batch into the sinks (xyzrgb, radius,
        direction, class logits)."""
        if isinstance(out, _Split):
            return out.collect(self._collect, sinks)
        order, radius, direction, logits = out.get()
        keep = vb.mask[order]
        out_xyzrgb, out_radius, out_dir, out_class = sinks
        out_xyzrgb.append(vb.feats[order[keep]][:, :6])
        out_radius.append(radius[keep])
        out_dir.append(direction[keep])
        out_class.append(logits[keep])

    # -- the compact and culled paths ----------------------------------------

    def _pad_sorted(self, skeys, res, rows: int):
        """A staged sorted upload on the device at `rows` rows: int32 key bit
        patterns widened to the int64-held uint32 keys, int8 residuals
        dequantised to fp16 as the JAX package does; rows past the stage
        hold INVALID_KEY (sorts last, reads inactive) and zero residuals.
        The forward takes the active prefix (rows = the active count); the
        JAX package pads to the batch capacity."""
        k = min(skeys.shape[0], rows)
        keys = torch.full((rows,), INVALID_KEY, dtype=torch.int64, device=skeys.device)
        keys[:k] = skeys[:k].to(torch.int64) & 0xFFFFFFFF
        if res.dtype == torch.int8:
            res = (res.to(torch.float32) * (self.voxel_size / 254.0)).to(torch.float16)
        r = torch.zeros((rows, 3), dtype=torch.float16, device=skeys.device)
        r[:k] = res[:k]
        return keys, r

    def _sorted_input(self, vb, n_act: int, skeys, res, origins):
        """The input tensor of a host-sorted staged upload: its n_act active
        rows; the keys are the sort order, so coords come from `unpack_keys`
        and there is no device sort or gather."""
        keys, r = self._pad_sorted(skeys, res, n_act)
        active = keys != INVALID_KEY
        coords = unpack_keys(keys, vb.spatial_shape, vb.batch_size)
        fv = _features(coords, r, origins, self.voxel_size, self.feature_mode)
        feats = torch.where(active[:, None], fv, 0.0)
        return SparseVoxelTensor(keys, feats, active, tuple(vb.spatial_shape), vb.batch_size)

    @torch.no_grad()
    def _run_batch_compact(self, vb):
        """Queue one compact batch: the download of the active rows'
        quantised heads (or a `_Split`)."""
        skeys, res, orig, n_act = vb.compact_upload_sorted(self.upload_granularity,
                                                           self.res_dtype)
        x = self._sorted_input(vb, n_act, *self._upload(skeys.view(np.int32), res, orig))
        plan = self._plan(x)
        halves = self._halves(vb, plan)
        if halves is not None:
            del x, plan
            return _Split([(half, self._run_batch_compact(half)) for half in halves])
        preds = compress_preds(self._unet(x, plan))
        return self._download([preds[k] for k in ("radius", "direction", "class_l")])

    def _collect_compact(self, vb, out, sinks):
        """Read one compact batch into the sinks (xyzrgb, radius, direction,
        class)."""
        if isinstance(out, _Split):
            return out.collect(self._collect_compact, sinks)
        radius, direction, class_l = out.get()
        _, order, n_act = vb.key_order()
        order = order[:n_act]              # active rows are the sorted prefix
        keep = vb.mask[order]
        out_xyzrgb, out_radius, out_dir, out_class = sinks
        out_xyzrgb.append(vb.feats[order[keep]][:, :6])
        out_radius.append(radius[keep].astype(np.float32))
        out_dir.append(decode_direction(direction[keep]))
        out_class.append(class_l[keep])

    def _partition(self, preds, active, interior):
        """The download cull on the device: class rows permuted interior-
        first, radius / direction rows (interior and medial class)-first, both
        by a stable sort on the complement so kept rows keep their order (the
        order the host rebuilds), and the medial count."""
        keep_i = active & interior
        cls = preds["class_l"]
        is_med = functools.reduce(torch.logical_or, [cls == c for c in self.medial_classes])
        keep_m = keep_i & is_med
        perm_i = torch.sort((~keep_i).to(torch.uint8), stable=True).indices
        perm_m = torch.sort((~keep_m).to(torch.uint8), stable=True).indices
        return (cls[perm_i], preds["radius"][perm_m], preds["direction"][perm_m],
                keep_m.sum(dtype=torch.int64))

    @torch.no_grad()
    def _run_batch_culled(self, vb):
        """Queue one culled batch: (download of the medial count; the
        partitioned class, radius and direction on the device), or a
        `_Split`."""
        skeys, res, orig, n_act, bits = vb.compact_upload_sorted(
            self.upload_granularity, self.res_dtype, with_mask=True)
        keys_d, res_d, orig_d, bits_d = self._upload(skeys.view(np.int32), res, orig, bits)
        x = self._sorted_input(vb, n_act, keys_d, res_d, orig_d)
        plan = self._plan(x)
        halves = self._halves(vb, plan)
        if halves is not None:
            del x, plan
            return _Split([(half, self._run_batch_culled(half)) for half in halves])
        preds = compress_preds(self._unet(x, plan))
        interior = _unpack_bits(bits_d, n_act)
        cls_p, rad_p, dir_p, n_med = self._partition(preds, x.active, interior)
        # the medial count comes back alone; the three downloads are sliced
        # to it in _collect_culled
        return self._download([n_med[None]]), (cls_p, rad_p, dir_p)

    def _collect_culled(self, vb, out, sinks):
        """Read one culled batch into the sinks. The host rebuilds both
        device permutations from what it has (its mask and key sort for the
        interior rows, the downloaded classes for the medial rows), so the
        radius / direction download covers exactly the medial interior rows;
        the other interior rows get medial_vector = 0."""
        if isinstance(out, _Split):
            return out.collect(self._collect_culled, sinks)
        small, (cls_p, rad_p, dir_p) = out
        m = int(small.get()[0][0])
        _, order, n_act = vb.key_order()
        keep = vb.mask[order[:n_act]]       # the device's keep_i over active rows
        rows = order[:n_act][keep]          # original rows, sorted order
        n_i = int(keep.sum())
        if n_i == 0:
            return
        cap = len(vb.coords)
        g = self.upload_granularity
        ni_stage, m_stage = stage_rows(n_i, cap, g), stage_rows(m, cap, g)
        cls_s, r_s, d_s = self._download(
            [cls_p[:ni_stage], rad_p[:m_stage], dir_p[:m_stage]], small.ready).get()
        cls = cls_s[:n_i]
        med = np.isin(cls, np.asarray(self.medial_classes, cls.dtype))
        if m != int(med.sum()):
            raise RuntimeError(
                f"download cull: the device counted {m} medial rows, the host "
                f"{int(med.sum())} among the downloaded classes")
        radius = np.zeros((n_i, 1), np.float32)
        direction = np.zeros((n_i, 3), np.float32)
        pos = np.flatnonzero(med)
        radius[pos] = r_s[:m].astype(np.float32)
        direction[pos] = decode_direction(d_s[:m])
        out_xyzrgb, out_radius, out_dir, out_class = sinks
        out_xyzrgb.append(vb.feats[rows][:, :6])
        out_radius.append(radius)
        out_dir.append(direction)
        out_class.append(cls)

    # -- entry points --------------------------------------------------------

    def _windowed(self, cloud: Cloud, run: str, collect: str):
        """Tile the cloud and run every batch through the halves named `run`
        and `collect`: the sinks. On one device at most max_in_flight batches
        are queued ahead of the one being collected; on several, with more
        than one batch, `_submit_multi_device` deals them out."""
        tiler = BlockTiler(cloud, self.voxel_size, self.block_size, self.buffer_size)
        batches = tiler.batches(self.batch_size, max_capacity=self.max_batch_capacity)
        sinks = ([], [], [], [])
        self.plan_rows = []
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
        keyf = lambda vb: (len(vb.coords), vb.spatial_shape, vb.batch_size)  # noqa: E731
        for _, group in itertools.groupby(sorted(batches, key=keyf), key=keyf):
            for chunk, keep in device_groups(list(group), len(replicas)):
                launched = ShardedForward.launch(replicas, chunk, keep, run)
                ShardedForward.collect(launched, collect, sinks)

    def predict(self, cloud: Cloud) -> Dict[str, np.ndarray]:
        """Per-voxel predictions at full precision for the interior voxels of
        every block, through the full-download path: xyz, rgb, radius [n,1]
        (log radius), direction [n,3], class_logits."""
        out_xyzrgb, out_radius, out_dir, out_class = self._windowed(
            cloud, "_run_batch", "_collect")
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

    def forward(self, cloud: Cloud, return_masked: bool = True) -> Cloud:
        """Cloud of interior voxels with medial_vector = exp(radius) *
        direction and the argmax class; with `medial_classes`, rows of any
        other class have medial_vector = 0. `return_masked` is accepted for
        the JAX signature and, as there, unused."""
        if not self.compact_transfers:
            p = self.predict(cloud)
            cls = np.argmax(p["class_logits"], axis=1)
            medial_vector = np.exp(p["radius"]) * p["direction"]
            if self.medial_classes is not None:
                medial_vector[~np.isin(cls, self.medial_classes)] = 0.0
            xyz, rgb = p["xyz"], p["rgb"]
        else:
            if self.medial_classes is not None:
                run, collect = "_run_batch_culled", "_collect_culled"
            else:
                run, collect = "_run_batch_compact", "_collect_compact"
            out_xyzrgb, out_radius, out_dir, out_class = self._windowed(cloud, run, collect)
            if not out_xyzrgb:  # too sparse to form any block
                z = np.zeros((0, 3), np.float32)
                return Cloud(xyz=z, rgb=z, medial_vector=z,
                             class_l=np.zeros((0, 1), np.float32), filename=cloud.filename)
            xyzrgb = np.concatenate(out_xyzrgb)
            xyz, rgb = xyzrgb[:, :3], xyzrgb[:, 3:6]
            medial_vector = np.exp(np.concatenate(out_radius)) * np.concatenate(out_dir)
            cls = np.concatenate(out_class)
        return Cloud(
            xyz=xyz,
            rgb=rgb,
            medial_vector=medial_vector,
            class_l=cls.reshape(-1, 1).astype(np.float32),
            filename=cloud.filename,
        )
