"""The train and eval steps on one device.

Answers to `smart_tree_tpu/parallel/dp.py`: that file builds a data-parallel
step over a device mesh (one replica per device, gradients, losses and
batch-norm statistics reduced across them). This one is its single-device
form, what the reference computes on a one-device mesh: no collective, the
batch's leading device axis has length 1. Training across cards is later
work.

A batch arrives in the compressed encoding the reference ships to its device
(`train/train.py::_device_batches`): coords16 [1, cap, 4] int16, res16
[1, cap, 3] fp16 residuals from the voxel centre, radius16 [1, cap, 1] fp16,
dir_cls8 [1, cap, 4] int8 (direction * 127 and the 0/1 class), valid [1, cap]
bool (doubles as the all-ones loss mask), origins [1, items, 3] fp32. Its
rounding is part of what both packages compute.

Every conv of a train step needs a gradient, so `core.sparse_ops.gather_conv`
sends it down gather + matmul (the hand kernels are forward-only, as the
reference's are); the eval step runs in fp32 under `no_grad`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from ..core.plan import build_plan
from ..core.sparse_ops import ConvConfig
from ..core.sparse_tensor import SparseVoxelTensor
from ..infer.inference import make_features
from ..nn.model import SmartTree
from .losses import compute_loss


@dataclass(frozen=True)
class StepConfig:
    """What the reference's `make_dp_train_step` closes over."""

    spatial_shape: Tuple[int, int, int]
    device_batch: int
    vector_class: int | None = 0
    compute_dtype: torch.dtype = torch.float32   # bf16 features when fp16: True
    matmul_precision: str = "float32"
    voxel_size: float = 0.01
    direction_loss: str = "cosine"
    feature_mode: str = "xyz"
    direction_weight: float = 1.0
    direction_min_radius: float | None = None


class TrainState:
    """Model, its Adam optimizer and the step count. `torch.optim.Adam` is
    the reference's `optax.adam` update: m / (1 - b1^t) over
    sqrt(v / (1 - b2^t)) + 1e-8, no weight decay."""

    def __init__(self, model: SmartTree, lr: float, step: int = 0):
        self.model = model
        self.optimizer = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                                          eps=1e-8)
        self.step = int(step)

    def set_lr(self, lr: float) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = float(lr)

    def optimizer_state(self) -> dict:
        """Adam's moments as numpy arrays keyed by parameter name:
        {"count": steps taken, "mu": {...}, "nu": {...}} (nothing of torch in
        it, so the pickle reads anywhere)."""
        mu, nu, count = {}, {}, 0
        for name, p in self.model.named_parameters():
            st = self.optimizer.state.get(p)
            if st:
                mu[name] = st["exp_avg"].detach().cpu().numpy().copy()
                nu[name] = st["exp_avg_sq"].detach().cpu().numpy().copy()
                count = int(st["step"])
            else:
                mu[name] = np.zeros(tuple(p.shape), np.float32)
                nu[name] = np.zeros(tuple(p.shape), np.float32)
        return {"count": count, "mu": mu, "nu": nu}

    def load_optimizer_state(self, state: dict) -> None:
        for name, p in self.model.named_parameters():
            self.optimizer.state[p] = {
                "step": torch.tensor(float(state["count"])),
                "exp_avg": torch.from_numpy(np.array(state["mu"][name])).to(p.device),
                "exp_avg_sq": torch.from_numpy(np.array(state["nu"][name])).to(p.device),
            }


def _decode_targets(radius16, dir_cls8):
    """[cap, 5] fp32 targets from fp16 radius and int8 (direction * 127,
    class). 1/127 direction quantisation is about 0.45 degrees."""
    radius = radius16.to(torch.float32)
    dc = dir_cls8.to(torch.float32)
    return torch.cat([radius, dc[:, :3] / 127.0, dc[:, 3:4]], dim=1)


@torch.no_grad()
def _prepare(batch, sc: StepConfig, levels: int, dtype: torch.dtype):
    """Decode one batch into (input tensor, plan, sorted targets, sorted
    loss mask). Nothing here needs a gradient."""
    coords16, res16, radius16, dir_cls8, valid, origins = batch
    if coords16.shape[0] != 1:
        raise ValueError(f"one device: the batch's leading axis must be 1, got {coords16.shape[0]}")
    coords, feats = make_features(coords16[0], res16[0], origins[0], sc.voxel_size,
                                  sc.feature_mode)
    targets = _decode_targets(radius16[0], dir_cls8[0])
    valid = valid[0]
    x = SparseVoxelTensor.from_coords(coords, feats.to(dtype), sc.spatial_shape,
                                      sc.device_batch, valid=valid)
    plan = build_plan(x, levels)
    # targets and mask must ride the same sort as the features: they go
    # through from_coords as extra feature columns
    xt = SparseVoxelTensor.from_coords(
        coords, torch.cat([targets, valid[:, None].to(torch.float32)], dim=1),
        sc.spatial_shape, sc.device_batch, valid=valid,
    )
    return x, plan, xt.feats[:, :-1], (xt.feats[:, -1] > 0.5) & xt.active


def batch_to_device(batch, device) -> tuple:
    """The numpy arrays of one batch as tensors on `device`."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device, non_blocking=True)
                 for a in batch)


def compute_losses(model: SmartTree, batch, sc: StepConfig, train: bool) -> Dict[str, torch.Tensor]:
    """The three losses of one batch (0-dim tensors, with autograd history
    when `train`). Train mode uses batch statistics and updates the running
    ones; eval mode is fp32 on the running statistics, whatever `sc` says of
    dtype and precision."""
    model.train(train)
    dtype = sc.compute_dtype if train else torch.float32
    x, plan, targets, mask = _prepare(batch, sc, len(model.unet_planes), dtype)
    cfg = ConvConfig(sc.matmul_precision if train else "float32", cap_hint=x.capacity)
    preds = model(plan, x.feats, cfg)
    return compute_loss(
        preds, targets, mask,
        vector_class=sc.vector_class,
        direction_loss=sc.direction_loss,
        direction_weight=sc.direction_weight if train else 1.0,
        direction_min_radius=sc.direction_min_radius,
    )


def train_step(state: TrainState, batch, sc: StepConfig) -> Dict[str, torch.Tensor]:
    """Forward, backward and one Adam update; returns the losses as detached
    0-dim tensors on the device (fetch them when convenient)."""
    losses = compute_losses(state.model, batch, sc, train=True)
    state.optimizer.zero_grad(set_to_none=True)
    sum(losses.values()).backward()
    state.optimizer.step()
    state.step += 1
    return {k: v.detach() for k, v in losses.items()}


@torch.no_grad()
def eval_step(state: TrainState, batch, sc: StepConfig) -> Dict[str, torch.Tensor]:
    return compute_losses(state.model, batch, sc, train=False)
