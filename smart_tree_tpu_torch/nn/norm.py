"""Masked batch normalisation over sparse voxel rows (inference form).

Counterpart of `smart_tree_tpu/nn/norm.py::MaskedBatchNorm` in eval mode:
running statistics, torch BatchNorm semantics (eps=1e-5),
y = (x - mean) * (rsqrt(var + eps) * scale) + bias. The parameter and
buffer names (`scale`, `bias`, `mean`, `var`) are the flax names, so the
state_dict keys equal the flax variable paths. Batch statistics over the
masked rows belong to training, which the port does not have yet.
"""

from __future__ import annotations

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "MaskedBatchNorm runs on running statistics only; call .eval()"
            )
        inv = torch.rsqrt(self.var + self.eps)
        return ((x - self.mean) * (inv * self.scale) + self.bias).to(x.dtype)
