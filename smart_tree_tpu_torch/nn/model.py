"""SmartTree sparse UNet.

Counterpart of `smart_tree_tpu/nn/model.py`: a 1x1x1 input conv, a
recursive UBlock (planes 8/16/32/64 in the shipped checkpoints) and three
SparseFC heads (radius 1, direction 3 unit-normalised, class 2).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.distributed as dist
from torch import nn

from ..core.plan import UNetPlan
from ..core.sparse_ops import ConvConfig
from .blocks import ConvNormAct, SparseConv, SparseFC, UBlock
from .norm import MaskedBatchNorm


class SmartTree(nn.Module):
    def __init__(
        self,
        input_channels: int = 3,
        unet_planes: Sequence[int] = (8, 16, 32, 64),
        radius_fc_planes: Sequence[int] = (8, 8, 4, 1),
        direction_fc_planes: Sequence[int] = (8, 8, 4, 3),
        class_fc_planes: Sequence[int] = (8, 8, 4, 2),
        generator: torch.Generator | None = None,
        bn_group: dist.ProcessGroup | None = None,
    ):
        super().__init__()
        self.input_channels = int(input_channels)
        self.unet_planes = tuple(int(p) for p in unet_planes)
        self.input_conv = nn.ModuleDict(
            {"sequence": ConvNormAct(input_channels, self.unet_planes[0], 1)}
        )
        self.UNet = UBlock(self.unet_planes, 0)
        self.radius_head = SparseFC(radius_fc_planes)
        self.direction_head = SparseFC(direction_fc_planes)
        self.class_head = SparseFC(class_fc_planes)
        for m in self.modules():
            if isinstance(m, SparseConv):
                m.reset_parameters(generator)
            elif isinstance(m, MaskedBatchNorm):
                m.group = bn_group

    def forward(
        self, plan: UNetPlan, feats: torch.Tensor, cfg: ConvConfig = ConvConfig()
    ) -> Dict[str, torch.Tensor]:
        mask = plan.levels[0].active
        x = self.input_conv["sequence"](feats, None, mask, cfg)
        x = self.UNet(plan, x, cfg)
        radius = self.radius_head(x, mask, cfg)
        direction_raw = self.direction_head(x, mask, cfg)
        # F.normalize semantics; rsqrt(max(|v|^2, 1e-24)) keeps the all-zero
        # padding rows finite
        n2 = (direction_raw * direction_raw).sum(dim=1, keepdim=True)
        direction = direction_raw * torch.rsqrt(torch.clamp(n2, min=1e-24))
        class_l = self.class_head(x, mask, cfg)
        return {
            "radius": radius,
            "direction": direction,
            "direction_raw": direction_raw,
            "class_l": class_l,
        }
