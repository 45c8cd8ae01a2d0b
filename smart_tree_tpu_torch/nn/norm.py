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

With a process group (`group`, the counterpart of the JAX package's
`axis_name`) train mode sums cnt, s1 and s2 over the group's ranks before
the mean, the variance and the running-statistics update, so data-parallel
training normalises by the statistics of the whole global batch. The sum is
`torch.distributed.nn.functional.all_reduce`, whose backward all-reduces the
incoming gradient: the transpose of JAX's `psum`, so the gradient keeps the
terms that cross ranks, as JAX's does.

The parameter and buffer names (`scale`, `bias`, `mean`, `var`) are the flax
names, so the state_dict keys equal the flax variable paths.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn


class MaskedBatchNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.1,
                 group: dist.ProcessGroup | None = None):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.group = group
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x [N,C]; mask [N] bool. Padding rows pass through scaled; callers
        keep them zeroed via the mask."""
        if self.training:
            m = mask.to(torch.float32)[:, None]
            xf = x.to(torch.float32)
            cnt, s1, s2 = m.sum(), (xf * m).sum(dim=0), (xf * xf * m).sum(dim=0)
            if self.group is not None:
                from torch.distributed.nn.functional import all_reduce

                c = x.shape[1]
                sums = all_reduce(torch.cat([cnt[None], s1, s2]), group=self.group)
                cnt, s1, s2 = sums[0], sums[1 : 1 + c], sums[1 + c :]
            cnt = cnt.clamp_min(1.0)
            mean = s1 / cnt
            var = (s2 / cnt - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                unbiased = var * cnt / (cnt - 1.0).clamp_min(1.0)
                self.mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                self.var.mul_(1 - self.momentum).add_(self.momentum * unbiased)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.eps)
        return ((x - mean) * (inv * self.scale) + self.bias).to(x.dtype)
