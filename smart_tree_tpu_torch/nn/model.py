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

from ..core.memory import estimate_forward_hbm, max_capacity_for_budget
from ..core.plan import UNetPlan, build_plan
from ..core.sparse_ops import ConvConfig
from ..core.sparse_tensor import SparseVoxelTensor
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

    def build_plan(self, x: SparseVoxelTensor, stats: dict | None = None, **kw) -> UNetPlan:
        """The plan of `x` for this model's levels (keywords of
        core/plan.py::build_plan, subm_mode among them; `stats`, the
        inference's, gets nothing from SmartTree's plan)."""
        return build_plan(x, num_levels=len(self.unet_planes), **kw)

    def forward_peak(self, level_rows, in_flight: int = 1, **terms) -> int:
        """The footprint model's peak bytes of a plan of `level_rows`
        (core/memory.py::estimate_forward_hbm; `terms` its index_bytes and
        whole_gather_bytes)."""
        return estimate_forward_hbm(level_rows[0], self.unet_planes, in_flight=in_flight,
                                    level_caps=level_rows, **terms)["peak"]

    def max_batch_capacity(self, budget_bytes: int, in_flight: int = 1, **terms) -> int:
        """The largest pow2 batch whose modelled peak fits the budget with
        every level as large as the batch (factor 1.0), as in the JAX
        package."""
        return max_capacity_for_budget(budget_bytes, self.unet_planes, factor=1.0,
                                       in_flight=in_flight, **terms)
