"""Model inference: block-tiled, bucketed sparse-UNet forward.

Counterpart of `smart_tree_tpu/infer/inference.py::ModelInference` on its
full-download, single-device path (`compact_transfers=False`): each batch
uploads int16 voxel coords plus fp16 residuals (xyz is rebuilt on the
device, as in the JAX package), builds the plan, runs SmartTree, and retries a batch with counts-driven level
capacities when a level overflowed. Unlike the JAX path, predictions come
back at full precision (fp32 radius, direction and class logits) instead of
fp16 / int8. `medial_classes` has the JAX package's meaning (rows of any
other class come back with medial_vector = 0) but is applied on the host
after the download; the culled transfer itself is not ported.

The forward runs eagerly; `precision` ("float32" or "bfloat16") and the
batch capacity reach every conv as arguments (core/sparse_ops.py). With
`fused=True` the convs whose table fits 8 MiB take the fused gather-GEMM
kernel, like the JAX package under SMART_TREE_TPU_PALLAS=1.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..core.coords import INVALID_KEY, pack_coords, sort_keys
from ..core.memory import max_capacity_for_budget
from ..core.plan import build_plan
from ..core.sparse_ops import ConvConfig
from ..core.sparse_tensor import SparseVoxelTensor
from ..data.cloud import Cloud
from ..data.dataset import BlockTiler
from ..device import resolve_device
from ..nn.convert import load_model, load_npz

# The JAX package's default device budget and in-flight batch count, kept so
# that batches are cut exactly as the reference cuts them (this port runs one
# batch at a time; re-budgeting for a larger card is later work).
BATCH_BUDGET_BYTES = 12 << 30
BATCH_BUDGET_IN_FLIGHT = 2


def _decode_xyz(coords16, res16, origins, voxel_size: float):
    """fp32 xyz from int16 coords, fp16 residuals from the voxel centre and
    per-item fp32 grid origins (VoxelBatch.compressed_xyz_upload)."""
    coords = coords16.to(torch.int32)
    bi = coords[:, 0].clamp(0, origins.shape[0] - 1).long()
    xyz = origins[bi] + (coords[:, 1:].to(torch.float32) + 0.5) * voxel_size
    return coords, xyz + res16.to(torch.float32)


def make_features(coords16, res16, origins, voxel_size: float, mode: str):
    """Input features: "xyz" (absolute coordinates, 3 channels) or "local"
    (residual / voxel_size and absolute y, 4 channels)."""
    coords, xyz = _decode_xyz(coords16, res16, origins, voxel_size)
    if mode == "local":
        feats = torch.cat([res16.to(torch.float32) / voxel_size, xyz[:, 1:2]], dim=1)
    else:
        feats = xyz
    return coords, feats


class ModelInference:
    def __init__(
        self,
        weights_path: str | Path,
        voxel_size: float = 0.01,
        block_size: float = 4.0,
        buffer_size: float = 0.4,
        batch_size: int = 4,
        precision: str = "float32",
        level_capacity_factor: float = 0.5,
        fused: bool = False,
        medial_classes: Sequence[int] | None = None,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)  # TF32 off on a card
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
        self.level_capacity_factor = level_capacity_factor
        self.model = load_model(load_npz(weights_path), self.device)
        self.feature_mode = "local" if self.model.input_channels == 4 else "xyz"
        # same batch sizing as the JAX package: the largest pow2 capacity
        # whose estimated forward peak fits the budget at factor 1.0 (the
        # overflow-retry worst case)
        self.max_batch_capacity = max_capacity_for_budget(
            BATCH_BUDGET_BYTES,
            self.model.unet_planes,
            factor=1.0,
            in_flight=BATCH_BUDGET_IN_FLIGHT,
        )

    def _plan_batch(self, vb, level_caps: Tuple[int, ...] | None = None):
        """Upload one batch (int16 coords, fp16 residuals, origins) and build
        its sorted input tensor and UNet plan on the device: (x, plan, order)."""

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        c16, res, orig = vb.compressed_xyz_upload()
        coords, fv = make_features(
            dev(c16), dev(res), dev(orig), self.voxel_size, self.feature_mode
        )
        keys = pack_coords(coords, vb.spatial_shape, vb.batch_size, valid=dev(vb.valid))
        skeys, order = sort_keys(keys)
        active = skeys != INVALID_KEY
        feats = torch.where(active[:, None], fv[order], 0.0)
        x = SparseVoxelTensor(skeys, feats, active, tuple(vb.spatial_shape), vb.batch_size)
        plan = build_plan(
            x,
            len(self.model.unet_planes),
            level_capacity_factor=self.level_capacity_factor,
            level_capacities=level_caps,
        )
        return x, plan, order

    @torch.no_grad()
    def _run_batch(self, vb, level_caps: Tuple[int, ...] | None = None):
        """One batch on the device: (preds, order, active, counts, caps)."""
        x, plan, order = self._plan_batch(vb, level_caps)
        cfg = ConvConfig(self.precision, cap_hint=x.capacity, fused=self.fused)
        preds = self.model(plan, x.feats, cfg)
        counts = torch.stack([lv.count for lv in plan.levels])
        caps = tuple(lv.keys.shape[0] for lv in plan.levels)
        return preds, order, x.active, counts, caps

    @staticmethod
    def _retry_caps(counts, caps) -> Tuple[int, ...]:
        """Per-level buffer sizes for an overflow retry: 2x headroom on
        overflowed levels (levels below one were built from a truncated
        table and may still grow), pow2, at least 256."""
        out = []
        for cnt, cap in zip(np.asarray(counts), np.asarray(caps)):
            need = int(cnt) * 2 if int(cnt) > int(cap) else int(cnt)
            cap2 = 256
            while cap2 < max(need, int(cap)):
                cap2 *= 2
            out.append(cap2)
        return tuple(out)

    def _collect(self, vb, out, sinks, attempt: int = 0):
        """Download one batch's results into the sinks, rerunning the batch
        with counts-driven level capacities when a level overflowed."""
        preds, order, active, counts, caps = out
        counts = counts.cpu().numpy()
        if bool(np.any(counts > np.asarray(caps))):
            if attempt >= len(self.model.unet_planes):
                raise RuntimeError(
                    f"UNet level buffer overflow persists after {attempt} "
                    f"counts-driven retries (counts {counts} vs capacities {caps})"
                )
            out = self._run_batch(vb, level_caps=self._retry_caps(counts, caps))
            return self._collect(vb, out, sinks, attempt + 1)
        order = order.cpu().numpy()
        keep = active.cpu().numpy() & vb.mask[order]
        out_xyzrgb, out_radius, out_dir, out_class = sinks
        out_xyzrgb.append(vb.feats[order[keep]][:, :6])
        out_radius.append(preds["radius"].float().cpu().numpy()[keep])
        out_dir.append(preds["direction"].float().cpu().numpy()[keep])
        out_class.append(preds["class_l"].float().cpu().numpy()[keep])

    def predict(self, cloud: Cloud) -> Dict[str, np.ndarray]:
        """Per-voxel predictions for the interior voxels of every block:
        xyz, rgb, radius [n,1] (log radius), direction [n,3], class_logits."""
        tiler = BlockTiler(cloud, self.voxel_size, self.block_size, self.buffer_size)
        sinks = ([], [], [], [])
        for vb in tiler.batches(self.batch_size, max_capacity=self.max_batch_capacity):
            self._collect(vb, self._run_batch(vb), sinks)
        out_xyzrgb, out_radius, out_dir, out_class = sinks
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

    def forward(self, cloud: Cloud) -> Cloud:
        """Cloud of interior voxels with medial_vector = exp(radius) *
        direction and the argmax class; with `medial_classes`, rows of any
        other class have medial_vector = 0."""
        p = self.predict(cloud)
        cls = np.argmax(p["class_logits"], axis=1)
        medial_vector = np.exp(p["radius"]) * p["direction"]
        if self.medial_classes is not None:
            medial_vector[~np.isin(cls, self.medial_classes)] = 0.0
        return Cloud(
            xyz=p["xyz"],
            rgb=p["rgb"],
            medial_vector=medial_vector,
            class_l=cls.reshape(-1, 1).astype(np.float32),
            filename=cloud.filename,
        )
