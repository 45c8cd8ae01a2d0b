"""Sparse UNet building blocks.

Counterpart of `smart_tree_tpu/nn/blocks.py`: the same block algebra
(SparseConv, ConvNormAct, ResBlock, recursive UBlock, SparseFC heads) over a
precomputed UNetPlan. Child names reproduce the flax module paths (for
example `UNet.U.Encode.sequence.0.weight`), so a state_dict key is the flax
variable path joined with dots (nn/convert.py). Conv weights keep the JAX
layout [K3, Cin, Cout]. `module.training` plays the JAX `train` flag: it
switches every MaskedBatchNorm between batch and running statistics.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..core.plan import UNetPlan
from ..core.sparse_ops import ConvConfig, gather_conv, linear
from .norm import MaskedBatchNorm


def _masked(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask[:, None], x, torch.zeros((), dtype=x.dtype, device=x.device))


class SparseConv(nn.Module):
    """One sparse conv; the rulebook decides the geometry. kernel_volume 1
    is a per-voxel linear layer."""

    def __init__(self, in_channels: int, out_channels: int, kernel_volume: int = 27):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(kernel_volume, in_channels, out_channels))

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        # uniform kaiming bound over fan_in = K3 * Cin, as the JAX package
        bound = (6.0 / (self.weight.shape[0] * self.weight.shape[1])) ** 0.5
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)

    def forward(self, feats, rulebook=None, cfg: ConvConfig = ConvConfig()):
        w = self.weight.to(feats.dtype)
        if w.shape[0] == 1:
            return linear(feats, w[0], precision=cfg.precision)
        return gather_conv(feats, rulebook, w, cfg)


class ConvNormAct(nn.Module):
    """conv -> BN -> ReLU, masked; children "0" (conv) and "1" (BN)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_volume: int = 27):
        super().__init__()
        self.add_module("0", SparseConv(in_channels, out_channels, kernel_volume))
        self.add_module("1", MaskedBatchNorm(out_channels))

    def forward(self, feats, rulebook, mask, cfg: ConvConfig):
        x = getattr(self, "0")(feats, rulebook, cfg)
        x = torch.relu(getattr(self, "1")(x, mask))
        return _masked(x, mask)


class ResBlock(nn.Module):
    """Two 3^3 subm convs plus an identity (1^3 projection when the width
    changes), post-add ReLU."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        if in_channels != out_channels:
            self.identity = nn.ModuleDict(
                {"0": SparseConv(in_channels, out_channels, 1)}
            )
        else:
            self.identity = None
        self.sequence = nn.ModuleDict(
            {
                "0": SparseConv(in_channels, out_channels, 27),
                "1": MaskedBatchNorm(out_channels),
                "3": SparseConv(out_channels, out_channels, 27),
                "4": MaskedBatchNorm(out_channels),
            }
        )

    def forward(self, feats, subm_rb, mask, cfg: ConvConfig):
        seq = self.sequence
        ident = feats if self.identity is None else self.identity["0"](feats, None, cfg)
        x = _masked(torch.relu(seq["1"](seq["0"](feats, subm_rb, cfg), mask)), mask)
        x = seq["4"](seq["3"](x, subm_rb, cfg), mask)
        return _masked(torch.relu(x + ident), mask)


class UBlock(nn.Module):
    """Recursive U: Head ResBlock -> Encode -> U -> Decode -> concat skip ->
    Tail ResBlock."""

    def __init__(self, planes: Sequence[int], level: int = 0):
        super().__init__()
        planes = tuple(planes)
        self.level = level
        self.Head = ResBlock(planes[0], planes[0])
        self.deep = len(planes) > 1
        if self.deep:
            self.Encode = nn.ModuleDict({"sequence": ConvNormAct(planes[0], planes[1], 27)})
            self.U = UBlock(planes[1:], level + 1)
            self.Decode = nn.ModuleDict({"sequence": ConvNormAct(planes[1], planes[0], 27)})
            self.Tail = ResBlock(planes[0] * 2, planes[0])

    def forward(self, plan: UNetPlan, feats, cfg: ConvConfig):
        lv = plan.levels[self.level]
        out = self.Head(feats, lv.subm_rb, lv.active, cfg)
        if self.deep:
            nxt = plan.levels[self.level + 1]
            down = self.Encode["sequence"](out, lv.down_rb, nxt.active, cfg)
            deep = self.U(plan, down, cfg)
            up = self.Decode["sequence"](deep, lv.up_rb, lv.active, cfg)
            out = self.Tail(torch.cat([out, up], dim=1), lv.subm_rb, lv.active, cfg)
        return out


class SparseFC(nn.Module):
    """1x1x1 conv stack head, (linear -> BN -> ReLU)* -> linear, bias-free;
    children "sequence.<3i>" (weights) and "sequence.<3i+1>" (BN)."""

    def __init__(self, planes: Sequence[int]):
        super().__init__()
        planes = tuple(planes)
        layers = {}
        n = len(planes)
        for i in range(n - 2):
            layers[str(3 * i)] = SparseConv(planes[i], planes[i + 1], 1)
            layers[str(3 * i + 1)] = MaskedBatchNorm(planes[i + 1])
        layers[str(3 * (n - 2))] = SparseConv(planes[-2], planes[-1], 1)
        self.sequence = nn.ModuleDict(layers)
        self.depth = n

    def forward(self, feats, mask, cfg: ConvConfig):
        x = feats
        for i in range(self.depth - 2):
            x = self.sequence[str(3 * i)](x, None, cfg)
            x = _masked(torch.relu(self.sequence[str(3 * i + 1)](x, mask)), mask)
        x = self.sequence[str(3 * (self.depth - 2))](x, None, cfg)
        return _masked(x, mask)
