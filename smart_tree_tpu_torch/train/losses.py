"""Training losses (counterpart of `smart_tree_tpu/train/losses.py`).

Mask-based instead of boolean indexing, so shapes stay fixed:
  radius:    L1 on log-radius, branch points only (vector_class mask)
  direction: mean(1 - cosine similarity), branch points only
  class:     focal loss (gamma=2) over all masked points

Own code rather than `torch.nn.CosineSimilarity` / `F.cross_entropy`: the
epsilons and the handling of masked rows are the reference's, so values and
gradients agree with it.
"""

from __future__ import annotations

from typing import Dict

import torch


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(torch.float32)
    return (x * m).sum() / m.sum().clamp_min(1.0)


def l1_loss(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return _masked_mean((pred - target).abs().reshape(-1), mask.reshape(-1))


def cosine_similarity_loss(
    pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    # eps = 1e-8 on the norm product, as torch's CosineSimilarity. Masked rows
    # are substituted with a unit vector BEFORE any norm, so zero rows never
    # produce NaN values or NaN gradients (0 * NaN is still NaN).
    # mask may be bool or float per-point weights (see direction_min_radius).
    e1 = torch.zeros_like(pred)
    e1[:, 0] = 1.0
    m = (mask > 0)[:, None]
    p = torch.where(m, pred, e1)
    t = torch.where(m, target, e1)
    num = (p * t).sum(dim=1)
    pn = torch.sqrt((p * p).sum(dim=1) + 1e-16)
    tn = torch.sqrt((t * t).sum(dim=1) + 1e-16)
    den = (pn * tn).clamp_min(1e-8)
    return _masked_mean(1.0 - num / den, mask)


def focal_loss(
    logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor, gamma: float = 2.0
) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=1)
    lab = labels.reshape(-1).to(torch.int64)
    logpt = torch.gather(logp, 1, lab[:, None]).reshape(-1)
    pt = torch.exp(logpt)
    loss = -((1 - pt) ** gamma) * logpt
    return _masked_mean(loss, mask)


def l2_direction_loss(
    pred_raw: torch.Tensor, target: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Mean squared error between the RAW (pre-normalisation) direction
    output and the unit target. Unlike the normalised-cosine loss, whose
    gradient goes as 1/|v|, this is bounded everywhere and has the same
    minimiser direction; inference still normalises."""
    diff = (pred_raw - target) ** 2
    return _masked_mean(diff.sum(dim=1), mask)


def compute_loss(
    preds: Dict[str, torch.Tensor],
    targets: torch.Tensor,
    mask: torch.Tensor,
    vector_class: int | None = 0,
    target_radius_log: bool = True,
    direction_loss: str = "cosine",
    direction_weight: float = 1.0,
    direction_min_radius: float | None = None,
    direction_subvoxel_weight: float = 0.0,
) -> Dict[str, torch.Tensor]:
    """targets: [N, 5] = [radius, direction(3), class]; mask: [N] bool
    (loss mask AND active-voxel mask).

    direction_loss: "cosine" (on the normalised head output) or "l2raw"
    (bounded-gradient variant on preds["direction_raw"]).

    direction_min_radius: when set, direction supervision on points whose
    ground-truth radius is below it is down-weighted to
    direction_subvoxel_weight (default: dropped). Sub-voxel twigs have a
    sign-ambiguous medial direction by construction (opposite surface points
    share one voxel after dedup). Radius and class losses are unaffected."""
    target_radius = targets[:, 0:1]
    target_direction = targets[:, 1:4]
    target_class = targets[:, 4]

    vmask = mask
    if vector_class is not None:
        vmask = mask & (target_class == vector_class)

    dmask = vmask
    if direction_min_radius is not None:
        # linear-radius threshold applied BEFORE the log transform; float
        # weights ride the same masked-mean machinery as the bool mask
        big = targets[:, 0] >= direction_min_radius
        weight = torch.where(big, 1.0, float(direction_subvoxel_weight))
        dmask = vmask.to(torch.float32) * weight

    if target_radius_log:
        target_radius = torch.log(target_radius.clamp_min(1e-12))

    if direction_loss == "l2raw":
        dloss = l2_direction_loss(preds["direction_raw"], target_direction, dmask)
    else:
        dloss = cosine_similarity_loss(preds["direction"], target_direction, dmask)

    return {
        "radius": l1_loss(preds["radius"], target_radius, vmask),
        "direction": direction_weight * dloss,
        "class_l": focal_loss(preds["class_l"], target_class, mask),
    }
