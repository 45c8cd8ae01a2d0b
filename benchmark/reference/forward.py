"""Plain reference, the forward: a cloud to per-voxel heads, by the
architecture the configuration's `model` section names (`model.arch`,
SmartTree where it names none; benchmark/arch/<arch>.py)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Heads:
    """The reference's heads at the interior voxels of one cloud."""

    point: np.ndarray       # [n] int64 the voxel's point in the cloud
    log_radius: np.ndarray  # [n] float32
    direction: np.ndarray   # [n,3] float32, unit (zero where the head gives 0)
    direction_norm: np.ndarray  # [n] float32 the head's norm before normalising
    logits: np.ndarray      # [n,2] float32


def forward(xyz, model, device="cpu", mode=None, root=None) -> Heads:
    """The heads of every interior voxel of `xyz` [N,3] float32 under the
    configuration's `model` section; `mode` as `unet._round`; the
    architecture's file read from the checkout `root` (this one if None)."""
    from stbench import spec

    arch = spec.arch_module(spec.arch_name(model), spec.ROOT if root is None else root)
    return arch.forward(xyz, model, device, mode)
