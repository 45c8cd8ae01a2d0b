"""Plain reference, the forward: a cloud to per-voxel heads."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .tiling import voxelize_cloud
from .unet import UNet, build_levels, load_checkpoint


@dataclass
class Heads:
    """The reference's heads at the interior voxels of one cloud."""

    point: np.ndarray       # [n] int64 the voxel's point in the cloud
    log_radius: np.ndarray  # [n] float32
    direction: np.ndarray   # [n,3] float32, unit (zero where the head gives 0)
    direction_norm: np.ndarray  # [n] float32 the head's norm before normalising
    logits: np.ndarray      # [n,2] float32


def forward(xyz, model, device="cpu", mode=None) -> Heads:
    """The heads of every interior voxel of `xyz` [N,3] float32 under the
    configuration's `model` section; `mode` as `unet._round`."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    vox = voxelize_cloud(xyz, model["voxel_size"], model["block_size"], model["buffer_size"])
    net = UNet(load_checkpoint(model["weights"]), device, mode)
    levels = build_levels(vox.coords, vox.side, device=device)
    order = levels[0].order.cpu().numpy()
    feats = torch.from_numpy(vox.feats[order]).to(device)
    r, d, dn, logits = (t.float().cpu().numpy() for t in net(levels, feats))
    keep = vox.interior[order]
    return Heads(vox.point[order][keep], r[keep], d[keep], dn[keep], logits[keep])
