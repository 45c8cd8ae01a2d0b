"""Masked batch normalisation over sparse voxel rows.

Counterpart of `smart_tree_tpu/nn/norm.py::MaskedBatchNorm`, torch
BatchNorm semantics (eps=1e-5, momentum 0.1):
y = (x - mean) * (rsqrt(var + eps) * scale) + bias.

Eval mode uses the running statistics. Train mode (`self.training`) takes the
statistics of the batch over the masked rows, in fp32 and by the reference's
formula (sums, not `torch.var`): mean = s1 / cnt, var = max(s2 / cnt - mean^2,
0) with cnt = max(sum(mask), 1). The gradient flows through them. The running
statistics move by `momentum` towards the batch's, the variance with the
unbiased factor cnt / max(cnt - 1, 1), outside autograd.

The parameter and buffer names (`scale`, `bias`, `mean`, `var`) are the flax
names, so the state_dict keys equal the flax variable paths.
"""

from __future__ import annotations

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x [N,C]; mask [N] bool. Padding rows pass through scaled; callers
        keep them zeroed via the mask."""
        if self.training:
            m = mask.to(torch.float32)[:, None]
            cnt = m.sum().clamp_min(1.0)
            xf = x.to(torch.float32)
            mean = (xf * m).sum(dim=0) / cnt
            var = ((xf * xf * m).sum(dim=0) / cnt - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                unbiased = var * cnt / (cnt - 1.0).clamp_min(1.0)
                self.mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                self.var.mul_(1 - self.momentum).add_(self.momentum * unbiased)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.eps)
        return ((x - mean) * (inv * self.scale) + self.bias).to(x.dtype)
